"""The port's bench (``python -m mirror_maze_tpu_torch.bench``,
mirror_maze_tpu_torch/bench.py) against the repository's ``bench.py`` on the
CPU (``--device cpu``):

- the parser: bench.py's option strings, defaults and choices, plus
  ``--device``;
- the configuration, the block size (which decides the image: ray i's
  random stream is seeded by (seed, i // B, i % B)) and the plane counts of
  ``build_bench_setup`` equal bench.py's at its default, ``--maze 4``,
  ``--maze 16`` and ``--maze 64``;
- a small timed run's final frame against the JAX package's frame of the
  same setup and idle frames by the golden rule (>= 99.9% of pixels within
  1 LSB, none off by more than 4);
- ``--validate`` passes, and its brute, bvh and exact frames are bitwise the
  JAX package's ``render_full_frame`` at the fixed configuration."""

import argparse
import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_tools import assert_frames_match
from mirror_maze_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--maze", "4", "--width", "64", "--height", "48", "--spp", "1", "--frames", "2",
         "--launches", "1"]


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("_jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _options(parser):
    return {a.option_strings[0]: (tuple(a.option_strings), a.dest, a.default, a.choices, a.type,
                                  type(a).__name__)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_parser_has_the_bench_flags_and_device(jbench, monkeypatch):
    """bench.py builds its parser inside main(): capture it there."""
    got = {}

    def grab(self, args=None, namespace=None):
        got["parser"] = self
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Stop):
            jbench.main()
    want, have = _options(got["parser"]), _options(bench.build_parser())
    assert have.pop("--device")[2] is None
    assert have == want


@pytest.mark.parametrize("argv", [[], ["--maze", "4"], ["--maze", "16"], ["--maze", "64"]],
                         ids=["default", "maze4", "maze16", "maze64"])
def test_setup_and_block_size_are_the_benchs(jbench, argv):
    args = bench.build_parser().parse_args(argv + ["--device", "cpu"])
    jcfg, jscene, jdev = jbench.build_bench_setup(args)
    cfg, scene, dev = bench.build_bench_setup(args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.tracer.block_rows == {"default": 96, "4": 96, "16": 32, "64": 24}[
        argv[1] if argv else "default"]
    assert scene.num_planes == jscene.num_planes
    assert dev.plane_table.shape[0] == jdev.plane_table.shape[0]
    assert dev.plane_table.device.type == "cpu"


def test_small_run_matches_the_jax_bench(jbench, capsys):
    from mirror_maze_tpu.runtime.state import FrameInputs, init_state
    from mirror_maze_tpu.runtime.step import make_scan_step, repeat_input

    args = bench.build_parser().parse_args(SMALL + ["--device", "cpu"])
    result, frame, launches = bench.run_bench(args)
    assert launches == {}                          # the CPU launches no kernel
    assert result["backend"] == "cpu" and result["device"] == "cpu"
    assert result["frame_checksum"] == float(frame.astype(np.int64).sum())
    assert len(result["launch_ms"]) == 1 and result["setup_s"] > 0
    assert result["rays_per_frame"] == 32 and result["kernel_planes"] == 14

    cfg, _, dev = jbench.build_bench_setup(args)
    step = make_scan_step(dev, cfg, args.frames)
    st = init_state(cfg, seed=0)
    for _ in range(1 + args.launches):
        st, jframe = step(st, repeat_input(FrameInputs.idle(), args.frames))
    jframe = np.asarray(jframe)
    print(f"bench frame: {(frame == jframe).mean():.4f} of values bitwise")
    assert_frames_match(frame, jframe)
    assert frame.max() > 0

    assert bench.main(SMALL + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["frame_checksum"] == result["frame_checksum"]
    assert "kernel launches {}" in err and set(result) <= set(line)


def test_validate_passes_and_matches_the_jax_frames(capsys):
    from mirror_maze_tpu.config import (
        CameraConfig,
        EngineConfig,
        MazeConfig,
        ScreenConfig,
        TracerConfig,
    )
    from mirror_maze_tpu.render import make_camera, render_full_frame, upload_scene
    from mirror_maze_tpu.scene import build_scene

    assert bench.main(["--validate", "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["ok"] and result["backend"] == "cpu" and result["pixels"] == 128 * 96
    assert result["bvh"]["max"] == result["exact"]["max"] == 0.0

    frames = bench.validate_frames("cpu")
    base = EngineConfig(
        maze=MazeConfig(width=16, height=16),
        tracer=TracerConfig(bounce_limit=1, mirror_limit=6, jitter=0.0, block_rows=16),
        camera=CameraConfig(spawn=(-5.0, 0.0, -75.0)),
        screen=ScreenConfig(width=128, height=96, samples_per_pixel=1),
    )
    dev = upload_scene(build_scene(base.maze))
    cam = make_camera(base.camera, base.screen.width / base.screen.height)
    for backend in ("brute", "bvh", "exact"):
        want = np.asarray(render_full_frame(dev, cam, jax.random.PRNGKey(0),
                                            base.replace(intersector=backend)))
        np.testing.assert_array_equal(frames[backend], want, err_msg=backend)
    assert frames["brute"].max() > 0.0


def test_validate_refuses_other_flags(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--validate", "--preset", "scale", "--device", "cpu"])
    assert e.value.code == 2
    assert "--validate runs a fixed configuration; remove ['preset']" in capsys.readouterr().err


def test_no_card_is_an_error_not_a_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (SMALL, ["--validate"]):
        with pytest.raises(SystemExit, match="CUDA is not available.*--device cpu"):
            bench.main(argv)


def test_sharded_bands_and_profile(tmp_path):
    """--sharded-bands 2 runs the row-band engine (both bands on the CPU):
    its checksum is the band engine's over the same idle frames; --profile
    writes the torch.profiler trace of the timed calls."""
    from mirror_maze_tpu_torch.parallel.shard import make_sharded_scan_engine
    from mirror_maze_tpu_torch.runtime.state import FrameInputs
    from mirror_maze_tpu_torch.runtime.step import repeat_input

    argv = SMALL + ["--sharded-bands", "2", "--profile", str(tmp_path), "--device", "cpu"]
    args = bench.build_parser().parse_args(argv)
    result, frame, _ = bench.run_bench(args)
    assert result["sharded_bands"] == 2 and result["rays_per_frame"] == 32
    assert (tmp_path / "bench_trace.json").stat().st_size > 0

    cfg, _, dev = bench.build_bench_setup(args)
    init_fn, scan_fn = make_sharded_scan_engine(cfg, devices=["cpu"] * 2)
    st = init_fn(seed=0)
    for _ in range(1 + args.launches):
        st, want = scan_fn(dev, st, repeat_input(FrameInputs.idle(), args.frames))
    np.testing.assert_array_equal(frame, want.numpy())
    assert result["frame_checksum"] == float(want.sum())
