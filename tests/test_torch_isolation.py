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
    assert resolve_device("cpu") == torch.device("cpu")
