"""The row-band engine and the sharded renderer of
``mirror_maze_tpu_torch/parallel/shard.py`` against the JAX package's
``parallel/shard.py`` on its virtual CPU devices.

The band engine runs the reference's own test shape (tests/test_parallel.py:
a 32 x 16n screen cut into n = 2 and 4 bands, 2 spp) with the fused tracer on
both sides (the Pallas kernels interpreted). The reference runs 6 frames,
its state is carried into the port with ``from_reference_sharded_state``, and
both run 8 more (walk, turn, idle). Queues, cursors, keys and the frame
counter must be equal bitwise, the camera within atol 1e-6, the frame by the
golden rule (>= 99.9% of pixels within 1 LSB, none off by more than 4), the
bands' screens within one 8-bit step on >= 99.9% of floats.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mirror_maze_tpu_torch as P
from _torch_tools import assert_frames_match, port_config
from mirror_maze_tpu import config as j_config
from mirror_maze_tpu.parallel import shard as j_shard
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.render.camera import make_camera as j_make_camera
from mirror_maze_tpu.runtime.state import EngineState as JEngineState
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.parallel import shard
from mirror_maze_tpu_torch.render import make_camera, upload_scene
from mirror_maze_tpu_torch.render.accumulate import cm_to_spatial, to_display
from mirror_maze_tpu_torch.runtime.state import (
    FrameInputs,
    from_reference_sharded_state,
    init_state,
)
from mirror_maze_tpu_torch.runtime.step import make_step
from mirror_maze_tpu_torch.scene import build_scene


def _cfg(pkg, n_tile, **screen):
    return pkg.EngineConfig(
        maze=pkg.MazeConfig(width=4, height=4),
        camera=pkg.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=pkg.ScreenConfig(width=32, height=16 * n_tile, samples_per_pixel=2,
                                chunks_per_frame=4 * n_tile, **screen),
        intersector="pallas",
    )


def _script(fi):
    return [fi.make(w=True)] * 3 + [fi.make(mouse_dx=9.0)] * 2 + [fi.idle()] * 3


def _arrays(jst):
    return {f: np.asarray(getattr(jst, f)) for f in jst._fields}


def _compare(jst, st, n_tile):
    a = _arrays(jst)
    for t in range(n_tile):
        b = st.band(t)
        c_band = a["perm"].shape[0] // n_tile
        rows = slice(t * c_band, (t + 1) * c_band)
        np.testing.assert_array_equal(b.perm.numpy(), a["perm"][rows])
        assert int(b.cursor) == int(a["cursor"][t]) and int(b.frame) == int(a["frame"])
        np.testing.assert_array_equal(b.key.numpy(), a["key"][t].astype(np.int64))
        for f in ("cam_center", "quat", "half_theta"):
            np.testing.assert_allclose(getattr(b, f).numpy(), a[f], rtol=0, atol=1e-6,
                                       err_msg=f)
        close = np.abs(b.screen.numpy() - a["screen"][rows]) <= 1.0 / 255.0 + 1e-6
        assert close.mean() >= 0.999


@pytest.mark.parametrize("n_tile,screen", [
    (2, {}), (4, {}), (2, dict(sort_chunk_window=True, adaptive_refresh=True)),
    (2, dict(pallas_present=False))])
def test_band_engine_matches_jax(n_tile, screen):
    jcfg = _cfg(j_config, n_tile, **screen)
    cfg = port_config(jcfg)
    jscene = j_upload(j_build(jcfg.maze))
    j_init, j_step = j_shard.make_sharded_engine(jcfg, j_shard.make_mesh(1, n_tile))
    jst = j_init(seed=0)
    devices = ["cpu"] * n_tile
    init_fn, step_fn = shard.make_sharded_engine(cfg, devices)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    # The two start equal ...
    _compare(jst, init_fn(seed=0), n_tile)
    for _ in range(6):
        jst, jframe = j_step(jscene, jst, JInputs.idle())
    # ... and the reference's state is carried over mid-run.
    st = from_reference_sharded_state(_arrays(jst), devices)
    for inp, jinp in zip(_script(FrameInputs), _script(JInputs)):
        st, frame = step_fn(scene, st, inp)
        jst, jframe = j_step(jscene, jst, jinp)
    _compare(jst, st, n_tile)
    assert_frames_match(frame.numpy(), np.asarray(jframe))
    assert frame.float().mean() > 1.0


def test_band_camera_is_the_single_engines_and_seams_blur():
    """Replicated camera math: the bands' camera after a walk and a turn is,
    bit for bit, the single engine's; and after the run no band's edge row
    is black while the rows around it are lit."""
    n_tile = 4
    cfg = _cfg(P, n_tile)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, ["cpu"] * n_tile)
    _, step_fn = shard.make_sharded_engine(cfg, ["cpu"] * n_tile)
    script = [FrameInputs.make(w=True)] * 5 + [FrameInputs.make(mouse_dx=9.0)] * 2 \
        + [FrameInputs.idle()] * 10
    st, frame = scan_fn(scene, init_fn(0), script)
    ref, one = init_state(cfg, seed=0, device="cpu"), make_step(scene, cfg)
    step_st = init_fn(0)
    for inp in script:
        ref, _ = one(ref, inp)
        step_st, step_frame = step_fn(scene, step_st, inp)
    for t in range(n_tile):
        assert torch.equal(st.cam_center[t], ref.cam_center)
        assert torch.equal(st.quat[t], ref.quat)
        assert int(st.frame[t]) == int(ref.frame)
        assert torch.equal(st.screen[t], step_st.screen[t])     # scan == frame by frame
    assert torch.equal(frame, step_frame)
    fs = frame.float()
    assert tuple(frame.shape) == (16 * n_tile, 32, 3) and frame.dtype == torch.uint8
    for b in range(1, n_tile):
        if fs[16 * b - 3:16 * b + 3].mean() > 0:
            assert fs[16 * b - 1:16 * b + 1].mean() > 0


@pytest.mark.parametrize("n_tile", [2, 4])
def test_state_conversions_match_jax(n_tile):
    """sharded_to_single and single_to_sharded against the reference's, on
    a band state 5 frames into a run (cursors off 0), and the round trip."""
    jcfg = _cfg(j_config, n_tile)
    cfg = port_config(jcfg)
    jscene = j_upload(j_build(jcfg.maze))
    j_init, j_step = j_shard.make_sharded_engine(jcfg, j_shard.make_mesh(1, n_tile))
    jst = j_init(seed=3)
    for _ in range(5):
        jst, _ = j_step(jscene, jst, JInputs.idle())
    devices = ["cpu"] * n_tile
    st = from_reference_sharded_state(_arrays(jst), devices)
    jsingle = j_shard.sharded_to_single(jst, jcfg)
    single = shard.sharded_to_single(st, cfg)
    for f in JEngineState._fields:
        np.testing.assert_array_equal(
            getattr(single, f).numpy().astype(np.float64),
            np.asarray(getattr(jsingle, f)).astype(np.float64), err_msg=f)
    jback = j_shard.single_to_sharded(jsingle, jcfg, n_tile)
    back = shard.single_to_sharded(single, cfg, devices)
    _compare(jback, back, n_tile)
    assert torch.equal(torch.cat(back.screen), torch.cat(st.screen))
    with pytest.raises(ValueError, match="bands"):
        shard.single_to_sharded(single, cfg, ["cpu"] * 5)
    with pytest.raises(ValueError, match="bands"):
        from_reference_sharded_state(_arrays(jst), ["cpu"] * (n_tile + 1))


def test_band_layout_and_devices_are_checked(monkeypatch):
    cfg = _cfg(P, 2)
    assert shard._band_screen_cfg(cfg, 2).height == 16
    assert shard._band_screen_cfg(cfg, 2).effective_chunks_per_frame == 4
    with pytest.raises(ValueError, match="do not split"):
        shard._band_screen_cfg(cfg, 3)
    with pytest.raises(ValueError, match="whole chunks"):
        shard._band_screen_cfg(cfg, 16)
    with pytest.raises(ValueError, match="empty"):
        shard.check_devices([])
    # Every intersector builds; bvh's traversal bounds come from the scene
    # at the first step (test_torch_jnp_engine.py runs it).
    init_fn, step_fn = shard.make_sharded_engine(dataclasses.replace(cfg, intersector="bvh"),
                                                 ["cpu"] * 2)
    assert callable(step_fn) and init_fn(seed=0).n_bands == 2
    # No device list means the card, and never the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        shard.make_sharded_engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        shard.make_sharded_renderer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_reference_sharded_state({})


def test_halo_rows_are_the_neighbours_rows():
    cfg = _cfg(P, 4)
    band = shard._band_screen_cfg(cfg, 4)
    whole = torch.rand((cfg.screen.total_chunks, 48))
    spatial = cm_to_spatial(whole, cfg.screen)
    top, bot = shard._exchange_halo_rows(list(whole.chunk(4)), band)
    for t in range(4):
        assert torch.equal(top[t].reshape(32, 3), spatial[max(16 * t - 1, 0)])
        assert torch.equal(bot[t].reshape(32, 3), spatial[min(16 * t + 16, 63)])


def test_sharded_renderer_matches_jax():
    """Two cameras x two row tiles of a 32x16 frame: float frames, >= 99.5%
    of values within atol 1e-5 and the mean luminance within 1e-3 (the
    camera glue differs from jitted XLA by an ulp, which can flip a hit on
    an edge)."""
    jcfg = j_config.EngineConfig(
        maze=j_config.MazeConfig(width=4, height=4),
        camera=j_config.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=j_config.ScreenConfig(width=32, height=16, samples_per_pixel=2),
        intersector="pallas")
    cfg = port_config(jcfg)
    jbase = j_make_camera(jcfg.camera, 2.0)
    jcams = j_shard.batch_cameras(
        [jbase._replace(center=jbase.center + jnp.float32(i)) for i in range(2)])
    jframes, jlum = j_shard.make_sharded_renderer(jcfg, j_shard.make_mesh(2, 2))(
        j_upload(j_build(jcfg.maze)), jcams, jax.random.PRNGKey(0))
    base = make_camera(cfg.camera, 2.0, "cpu")
    cams = shard.batch_cameras([base._replace(center=base.center + float(i)) for i in range(2)])
    assert tuple(cams.center.shape) == (2, 3)
    render = shard.make_sharded_renderer(cfg, ["cpu"] * 4, n_cam=2)
    frames, lum = render(upload_scene(build_scene(cfg.maze), device="cpu"), cams,
                         prng.PRNGKey(0, device="cpu"))
    got, want = shard.gather_frames(frames), np.asarray(j_shard.gather_frames(jframes))
    assert got.shape == want.shape == (2, 16, 32, 3)
    assert np.isclose(got, want, rtol=0, atol=1e-5).mean() >= 0.995
    assert abs(float(lum) - float(jlum)) <= 1e-3 * float(jlum)
    assert float(lum) == pytest.approx(got.mean(), rel=1e-5)
