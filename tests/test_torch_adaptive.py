"""``adaptive_refresh``: the detail-first epoch reorder of the chunk queue
and the engine step that uses it, against the JAX package.

``adaptive_reorder`` sorts chunks by the population variance of their
luminance, descending, with a stable sort. The port's sums may round in
another order than jitted XLA's, so two chunks whose variances differ by an
ulp could swap: the comparison is exact on screens whose variances are well
separated (each chunk's noise has its own amplitude, 2% apart) and on flat
screens, where every variance is exactly 0 and the stable sort keeps the id
order (the engine's state at start-up). The engine run compares the queue
after a wrap exactly, too: its screens are 8-bit quantized and equal on both
sides, and chunks that tie do so exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tools import assert_frames_match, compare_states, port_config
from mirror_maze_tpu import config as j_config
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.render.scheduler import adaptive_reorder as j_reorder
from mirror_maze_tpu.runtime.loop import run_scripted as j_run
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.render.scheduler import adaptive_reorder
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs
from mirror_maze_tpu_torch.runtime.step import make_scan_step
from mirror_maze_tpu_torch.runtime.state import init_state
from mirror_maze_tpu_torch.scene import build_scene

C = 192


def _screens():
    r = np.random.default_rng(0)
    amp = 1.02 ** r.permutation(C)                       # variances 4% apart
    noisy = 0.5 + 0.01 * amp[:, None] * r.standard_normal((C, 48))
    return {"separated": noisy.astype(np.float32), "zeros": np.zeros((C, 48), np.float32),
            "flat_half": np.full((C, 48), 0.5, np.float32)}


@pytest.mark.parametrize("cursor,cursor_next", [(180, 4), (176, 0), (100, 116), (0, 16)])
@pytest.mark.parametrize("screen", ["separated", "zeros", "flat_half"])
def test_adaptive_reorder_matches_jax(screen, cursor, cursor_next):
    rows = _screens()[screen]
    perm = np.random.default_rng(1).permutation(C).astype(np.int32)
    want = np.asarray(jax.jit(j_reorder)(jnp.asarray(perm), jnp.int32(cursor),
                                         jnp.int32(cursor_next), jnp.asarray(rows)))
    got = adaptive_reorder(torch.from_numpy(perm), torch.tensor(cursor, dtype=torch.int32),
                           torch.tensor(cursor_next, dtype=torch.int32), torch.from_numpy(rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    wrapped = cursor_next <= cursor
    assert np.array_equal(got.numpy(), perm) == (not wrapped)
    assert sorted(got.tolist()) == list(range(C))
    if wrapped and screen != "separated":
        # Equal variances: chunk ids in order, rolled to start at the cursor.
        assert got.tolist() == np.roll(np.arange(C), cursor_next).tolist()


def _adaptive_cfg(pkg, **screen):
    return pkg.EngineConfig(
        maze=pkg.MazeConfig(width=4, height=4),
        tracer=pkg.TracerConfig(bounce_limit=3, mirror_limit=3),
        camera=pkg.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=pkg.ScreenConfig(width=64, height=48, samples_per_pixel=2, chunks_per_frame=40,
                                adaptive_refresh=True, **screen),
        intersector="pallas",
    )


@pytest.mark.parametrize("sort_window", [False, True])
def test_adaptive_engine_run_matches_jax(sort_window):
    """192 chunks, 40 a frame, 12 frames: a turn on frame 2 shuffles the
    queue afresh, it wraps on frames 7 and 11 (straddling the end, so the
    order is rolled), with a walk in between. The queue after the run, the
    camera and the frame agree."""
    jcfg = _adaptive_cfg(j_config, sort_chunk_window=sort_window)
    cfg = port_config(jcfg)
    script = lambda fi: ([fi.idle(), fi.make(mouse_dx=16.0)] + [fi.idle()] * 5
                         + [fi.make(w=True)] * 2 + [fi.idle()] * 3)
    st, frame = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                             inputs=script(FrameInputs))
    jst, jframe = j_run(j_upload(j_build(jcfg.maze)), jcfg, inputs=script(JInputs))
    compare_states(jst, st)
    assert_frames_match(frame, np.asarray(jframe))
    plain_cfg = dataclasses.replace(cfg, screen=dataclasses.replace(cfg.screen,
                                                                   adaptive_refresh=False))
    other, _ = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), plain_cfg,
                            inputs=script(FrameInputs))
    assert not torch.equal(other.perm, st.perm)


def test_every_epoch_still_refreshes_every_chunk():
    """The reorder is a permutation: over any epoch each chunk is popped
    once (the reference's test_scheduler_accum property), through
    make_scan_step as well."""
    cfg = port_config(_adaptive_cfg(j_config))
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    st = init_state(cfg, seed=0, device="cpu")
    run = make_scan_step(scene, cfg)
    for _ in range(3):
        st, _ = run(st, [FrameInputs.idle()] * 5)
        assert sorted(st.perm.tolist()) == list(range(192))
    assert int(st.frame) == 15
