"""Shared helpers of the PyTorch/CUDA port's tests (tests/test_torch_*.py).

The port's tests run the same inputs, made with NumPy from a fixed seed,
through the JAX package and through the port on the CPU, and compare.
Tests of the CUDA kernels themselves are in tests/test_torch_cuda.py, which
imports no JAX so that it also runs on the GPU machine (with
``--noconftest``); they skip on a machine without a card.

This module imports no JAX either: ``chip_smoke.py`` takes the golden
configuration and script from here, so the card's golden run and the CPU
tests cannot drift apart.
"""

import dataclasses

import numpy as np
import mirror_maze_tpu_torch as P


def golden_config() -> "P.EngineConfig":
    """The port's counterpart of tests/_golden_tools.py golden_cfg("pallas")
    (test_torch_engine.py holds the two equal)."""
    return P.EngineConfig(
        maze=P.MazeConfig(width=4, height=4, seed=0),
        tracer=P.TracerConfig(bounce_limit=3, mirror_limit=3),
        camera=P.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=P.ScreenConfig(width=64, height=48, samples_per_pixel=8),
        intersector="pallas",
    )


def golden_script(fi) -> list:
    """The 28-frame golden script of tests/_golden_tools.py run_golden_script
    (idle, walk, turn, idle), built from the FrameInputs class ``fi`` of
    either package."""
    return ([fi.idle()] * 8 + [fi.make(w=True)] * 8
            + [fi.make(mouse_dx=16.0)] * 4 + [fi.idle()] * 8)


def multi_tile_config(pkg, width=64, height=48):
    """A small configuration on the multi-tile path: a 16x16 maze (its
    walls fill two tiles of 128), ``noise_rng`` on and the chunk window
    Morton-sorted, 2 spp. ``pkg`` holds the config classes: the port's
    package or the JAX package's ``config`` module."""
    return pkg.EngineConfig(
        maze=pkg.MazeConfig(width=16, height=16),
        tracer=pkg.TracerConfig(bounce_limit=3, mirror_limit=4, noise_rng=True, block_rows=1),
        screen=pkg.ScreenConfig(width=width, height=height, samples_per_pixel=2,
                                sort_chunk_window=True),
        intersector="pallas",
    )


def multi_tile_script(fi) -> list:
    """12 frames for ``multi_tile_config``: idle, walk, turn, idle."""
    return ([fi.idle()] * 4 + [fi.make(w=True)] * 4
            + [fi.make(mouse_dx=16.0)] * 2 + [fi.idle()] * 2)


def soup_arrays() -> dict:
    """The 150-quad random soup of tests/test_pallas_tracer.py
    test_random_multitile_scene_matches_exactly, as the fields of either
    package's ``Scene``: skewed diffuse quads, an open scene, two tiles."""
    r = np.random.default_rng(11)
    n = 150
    origin = r.uniform(-20, 20, (n, 3))
    v = r.normal(size=(n, 3)) * 2.0
    u = r.normal(size=(n, 3)) * 2.0
    em = np.concatenate(
        [r.uniform(0, 1, (n, 3)), (r.random((n, 1)) < 0.3) * r.uniform(0, 2, (n, 1))], axis=1)
    return dict(
        origin=origin.astype(np.float32), v=v.astype(np.float32), u=u.astype(np.float32),
        color=r.uniform(0, 1, (n, 3)).astype(np.float32), is_mirror=np.zeros(n, bool),
        emission=em.astype(np.float32), grid=np.zeros((1, 1), np.uint8))


def port_config(cfg) -> "P.EngineConfig":
    """The port's EngineConfig equal field for field to a JAX package one."""
    return P.EngineConfig(
        maze=P.MazeConfig(**dataclasses.asdict(cfg.maze)),
        tracer=P.TracerConfig(**dataclasses.asdict(cfg.tracer)),
        camera=P.CameraConfig(**dataclasses.asdict(cfg.camera)),
        screen=P.ScreenConfig(**dataclasses.asdict(cfg.screen)),
        intersector=cfg.intersector,
    )


def assert_frames_match(got: np.ndarray, ref: np.ndarray) -> None:
    """The golden rule of tests/test_golden.py: uint8 frames with >= 99.9%
    of pixels within 1 LSB and no pixel off by more than 4."""
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert (diff <= 1).mean() > 0.999, f"{(diff <= 1).mean():.5f} within 1 LSB"
    assert diff.max() <= 4, f"max diff {diff.max()}"


def compare_states(jst, st) -> None:
    """A JAX package EngineState against the port's: the queue, cursor, key
    and frame counter bitwise, the camera within atol=1e-6."""
    for f in ("perm", "cursor", "key", "frame"):
        np.testing.assert_array_equal(
            getattr(st, f).cpu().numpy().astype(np.int64),
            np.asarray(getattr(jst, f)).astype(np.int64), err_msg=f)
    for f in ("cam_center", "quat", "half_theta"):
        np.testing.assert_allclose(getattr(st, f).cpu().numpy(), np.asarray(getattr(jst, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
