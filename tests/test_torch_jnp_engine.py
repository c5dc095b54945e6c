"""The engine with the jnp tracer's backends against the JAX package's.

- ``config_v0`` (4x4 maze, 256x256, 1 spp, 1 + 1 bounces, brute) scripted
  for 6 frames (idle, walk, turn, idle) through ``run_scripted`` on both
  sides;
- the golden configuration with ``intersector`` ``exact`` and ``bvh``
  through the 28-frame golden script;
- the row-band engine with ``brute`` on two CPU devices against the
  reference's sharded engine on two virtual CPU devices, as
  test_torch_bands.py holds it for the fused tracer;
- offline ``render_full_frame`` with ``bvh`` and no ``nearest_fn`` walks
  the BVH (the reference's test_bvh_backend_honored_without_explicit_nearest_fn).

Frames by the golden rule of tests/test_golden.py (>= 99.9% of pixels
within 1 LSB, none off by more than 4); the queue, cursor, key and frame
counter bitwise, the camera within atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _golden_tools import golden_cfg
from _torch_tools import (
    assert_frames_match,
    compare_states,
    golden_script,
    port_config,
)
from mirror_maze_tpu import config as j_config
from mirror_maze_tpu.parallel import shard as j_shard
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.render.camera import make_camera as j_make_camera
from mirror_maze_tpu.runtime.loop import run_scripted as j_run
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.scene import build_scene as j_build
import mirror_maze_tpu_torch as P
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.parallel import shard
from mirror_maze_tpu_torch.render import intersect, make_camera, render_full_frame, upload_scene
from mirror_maze_tpu_torch.render import pipeline
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs
from mirror_maze_tpu_torch.runtime.step import derive_traversal_bounds, make_scan_step, make_step
from mirror_maze_tpu_torch.runtime.state import init_state
from mirror_maze_tpu_torch.scene import build_scene


def _v0_script(fi):
    return [fi.idle()] * 2 + [fi.make(w=True)] * 2 + [fi.make(mouse_dx=-27.0)] + [fi.idle()]


def test_config_v0_scripted_matches_jax():
    jcfg = j_config.config_v0()
    cfg = port_config(jcfg)
    assert cfg == P.NAMED_CONFIGS["v0"]() and cfg.intersector == "brute"
    st, frame = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                             inputs=_v0_script(FrameInputs))
    jst, jframe = j_run(j_upload(j_build(jcfg.maze)), jcfg, inputs=_v0_script(JInputs))
    assert frame.shape == (256, 256, 3)
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst, st)
    assert frame.mean() > 0.1       # one bounce: a dim frame, but lit


@pytest.mark.parametrize("backend", ["exact", "bvh"])
def test_golden_script_matches_jax(backend):
    jcfg = golden_cfg(backend)
    cfg = port_config(jcfg)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    intersect.walk_counts.clear()
    st, frame = run_scripted(scene, cfg, inputs=golden_script(FrameInputs))
    jst, jframe = j_run(j_upload(j_build(jcfg.maze)), jcfg, inputs=golden_script(JInputs))
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst, st)
    walks = intersect.walk_counts["walks"]
    assert walks == (28 * cfg.tracer.max_segments if backend == "bvh" else 0)


def test_bvh_bounds_come_from_the_scene_and_the_scan_step_equals_stepping():
    cfg = port_config(golden_cfg("bvh"))
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    depth, leaf = derive_traversal_bounds(scene, cfg, None, None)
    assert (depth, leaf) != (32, 4) and leaf >= 1
    assert derive_traversal_bounds(scene, cfg.replace(intersector="brute"), None, None) == (32, 4)
    inputs = [FrameInputs.idle(), FrameInputs.make(w=True), FrameInputs.make(mouse_dx=3.0)]
    step = make_step(scene, cfg)
    st = init_state(cfg, device="cpu")
    for inp in inputs:
        st, frame = step(st, inp)
    st_scan, frame_scan = make_scan_step(scene, cfg)(init_state(cfg, device="cpu"), inputs)
    assert torch.equal(frame, frame_scan)
    assert all(torch.equal(a, b) for a, b in zip(st, st_scan))


def test_band_engine_with_brute_matches_jax():
    n_tile = 2
    jcfg = j_config.EngineConfig(
        maze=j_config.MazeConfig(width=4, height=4),
        camera=j_config.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=j_config.ScreenConfig(width=32, height=16 * n_tile, samples_per_pixel=2,
                                     chunks_per_frame=4 * n_tile),
        intersector="brute")
    cfg = port_config(jcfg)
    j_init, j_step = j_shard.make_sharded_engine(jcfg, j_shard.make_mesh(1, n_tile))
    jscene = j_upload(j_build(jcfg.maze))
    init_fn, step_fn = shard.make_sharded_engine(cfg, ["cpu"] * n_tile)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    jst, st = j_init(seed=0), init_fn(seed=0)
    script = [FrameInputs.idle()] * 2 + [FrameInputs.make(w=True)] * 2 + [
        FrameInputs.make(mouse_dx=9.0)] * 2 + [FrameInputs.idle()] * 2
    jscript = [JInputs.idle()] * 2 + [JInputs.make(w=True)] * 2 + [
        JInputs.make(mouse_dx=9.0)] * 2 + [JInputs.idle()] * 2
    for inp, jinp in zip(script, jscript):
        st, frame = step_fn(scene, st, inp)
        jst, jframe = j_step(jscene, jst, jinp)
    assert_frames_match(frame.numpy(), np.asarray(jframe))
    a = {f: np.asarray(getattr(jst, f)) for f in jst._fields}
    c_band = a["perm"].shape[0] // n_tile
    for t in range(n_tile):
        b = st.band(t)
        np.testing.assert_array_equal(b.perm.numpy(), a["perm"][t * c_band:(t + 1) * c_band])
        np.testing.assert_array_equal(b.key.numpy(), a["key"][t].astype(np.int64))
        np.testing.assert_allclose(b.cam_center.numpy(), a["cam_center"], rtol=0, atol=1e-6)
    assert frame.float().mean() > 1.0


def test_full_frame_with_bvh_walks_the_bvh_without_a_nearest_fn(monkeypatch):
    cfg = P.EngineConfig(
        maze=P.MazeConfig(width=4, height=4),
        tracer=P.TracerConfig(bounce_limit=2, mirror_limit=2),
        camera=P.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=P.ScreenConfig(width=16, height=8, samples_per_pixel=2),
        intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    cam = make_camera(cfg.camera, 2.0, "cpu")
    calls = {"bvh": 0}
    real = pipeline.nearest_hit_bvh

    def spy(*a, **k):
        calls["bvh"] += 1
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "nearest_hit_bvh", spy)
    out = render_full_frame(scene, cam, prng.PRNGKey(0, device="cpu"), cfg)
    assert calls["bvh"] == cfg.tracer.max_segments
    brute = render_full_frame(scene, cam, prng.PRNGKey(0, device="cpu"),
                              cfg.replace(intersector="brute"))
    assert torch.equal(out, brute)


def test_sharded_renderer_with_bvh_matches_jax():
    """Two cameras x two row tiles with the bvh backend, whose bounds the
    renderer derives from the scene at its first call."""
    jcfg = j_config.EngineConfig(
        maze=j_config.MazeConfig(width=4, height=4),
        tracer=j_config.TracerConfig(bounce_limit=2, mirror_limit=2),
        camera=j_config.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=j_config.ScreenConfig(width=16, height=8, samples_per_pixel=2),
        intersector="bvh")
    cfg = port_config(jcfg)
    jbase = j_make_camera(jcfg.camera, 2.0)
    jcams = j_shard.batch_cameras(
        [jbase._replace(center=jbase.center + jnp.float32(i)) for i in range(2)])
    jframes, jlum = j_shard.make_sharded_renderer(jcfg, j_shard.make_mesh(2, 2))(
        j_upload(j_build(jcfg.maze)), jcams, jax.random.PRNGKey(0))
    base = make_camera(cfg.camera, 2.0, "cpu")
    cams = shard.batch_cameras([base._replace(center=base.center + float(i)) for i in range(2)])
    intersect.walk_counts.clear()
    render = shard.make_sharded_renderer(cfg, ["cpu"] * 4, n_cam=2)
    frames, lum = render(upload_scene(build_scene(cfg.maze), device="cpu"), cams,
                         prng.PRNGKey(0, device="cpu"))
    got, want = shard.gather_frames(frames), np.asarray(j_shard.gather_frames(jframes))
    assert got.shape == want.shape == (2, 8, 16, 3)
    assert np.isclose(got, want, rtol=0, atol=1e-5).mean() >= 0.995
    assert abs(float(lum) - float(jlum)) <= 1e-3 * float(jlum)
    assert intersect.walk_counts["walks"] == 4 * cfg.tracer.max_segments
