"""The port stands alone: importing every module of mirror_maze_tpu_torch
pulls in neither jax nor the JAX package, and its entry points default to
the CUDA card, raising where there is none instead of running on the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import mirror_maze_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        mirror_maze_tpu_torch.__path__, "mirror_maze_tpu_torch."))


def test_importing_every_module_pulls_in_no_jax():
    mods = _modules()
    assert "mirror_maze_tpu_torch.render.fused_tracer" in mods
    assert "mirror_maze_tpu_torch.scene.mesh" in mods
    assert "mirror_maze_tpu_torch.parallel.shard" in mods
    assert "mirror_maze_tpu_torch.utils.profiling" in mods
    for m in ("render.intersect", "render.tracer", "render.campath", "scene.io",
              "utils.imageio", "utils.minimap", "runtime.watchdog", "runtime.loop",
              "runtime.server", "parallel.multiplayer", "__main__", "bench",
              "tools.soak_kernel", "examples.cornell_box", "examples.mesh_gallery",
              "examples.multiplayer_demo"):
        assert f"mirror_maze_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'mirror_maze_tpu' or k.startswith('mirror_maze_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_nothing_in_the_package_enables_tf32():
    """The brute backend's products run in full float32: no module of the
    port turns TF32 matmuls on (chip_smoke.py asserts it on the card)."""
    root = os.path.join(REPO, "mirror_maze_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "allow_tf32" not in src and "set_float32_matmul_precision" not in src, name
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    from mirror_maze_tpu_torch.config import EngineConfig
    from mirror_maze_tpu_torch.device import resolve_device
    from mirror_maze_tpu_torch.render.scenebuf import upload_scene
    from mirror_maze_tpu_torch.runtime.state import from_reference_state, init_state
    from mirror_maze_tpu_torch.scene import build_scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        upload_scene(build_scene(cfg.maze))
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference_state({})
    # The band engine and the sharded renderer: no device list is the card.
    from mirror_maze_tpu_torch.parallel.shard import (
        check_devices,
        make_sharded_engine,
        make_sharded_renderer,
        make_sharded_scan_engine,
    )
    from mirror_maze_tpu_torch.runtime.state import from_reference_sharded_state

    for entry in (make_sharded_engine, make_sharded_scan_engine, make_sharded_renderer):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        check_devices(["cpu", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference_sharded_state({})
    # Checkpoints load onto the card unless the caller names the CPU.
    from mirror_maze_tpu_torch.parallel.shard import load_sharded_state
    from mirror_maze_tpu_torch.runtime.state import load_state

    with pytest.raises(RuntimeError, match="CUDA"):
        load_state("no-such-checkpoint.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_sharded_state("no-such-checkpoint.npz", cfg)
    # The multiplayer engine uploads its scene to the card unless told.
    from mirror_maze_tpu_torch.parallel.multiplayer import make_multiplayer_engine

    with pytest.raises(RuntimeError, match="CUDA"):
        make_multiplayer_engine(cfg)
    # The bench, the soak and the examples run on the card unless told.
    from mirror_maze_tpu_torch.bench import validate, validate_frames
    from mirror_maze_tpu_torch.examples import cornell_box, multiplayer_demo
    from mirror_maze_tpu_torch.tools import soak_kernel

    for entry in (validate, validate_frames, lambda: soak_kernel.run_soak(1),
                  lambda: cornell_box.render_scene(cornell_box.build_cornell_box(),
                                                   cornell_box.render_config(8, 1, "brute"),
                                                   None),
                  lambda: multiplayer_demo.main(["--frames", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert check_devices(["cpu"] * 2) == [torch.device("cpu")] * 2
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_never_take_the_plain_version_on_a_cuda_tensor():
    """On a tensor that is not on the CPU a wrapper goes to its kernel (or
    raises): the plain version is reached only through the CPU branch. Held
    on the source, since this machine has no card: each wrapper has exactly
    one call of its plain version, under ``device.type == "cpu"``."""
    import inspect

    from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused
    from mirror_maze_tpu_torch.render.present import present

    for fn, plain in ((present, "present_plain("),
                      (trace_paths_fused, "trace_paths_plain(")):
        src = inspect.getsource(fn)
        assert src.count(plain) == 1
        head = src[:src.index(plain)]
        assert head.rstrip().endswith("return") and 'type == "cpu":' in head.splitlines()[-2]
        assert "kernels.launch(" in src[src.index(plain):]


def test_installed_script_runs_the_ports_cli():
    """pyproject.toml installs ``mirror-maze-tpu-torch`` for the port's CLI."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    module, func = scripts["mirror-maze-tpu-torch"].split(":")
    from mirror_maze_tpu_torch import __main__ as cli

    assert getattr(importlib.import_module(module), func) is cli.main
    assert scripts["mirror-maze-tpu"] == "mirror_maze_tpu.__main__:main"
