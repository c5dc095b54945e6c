"""Checkpoints that resume in either package, and the watchdog.

- The port's ``save_state`` after 4 frames, the JAX package's
  ``load_state``, then 4 more frames on both sides from their own copies:
  frames by the golden rule, queue, cursor, key and frame counter bitwise,
  camera within atol 1e-6; and the other way round, where the port's loaded
  state must equal the JAX state field for field, bitwise.
- A band engine's checkpoint (either package's) through
  ``load_sharded_state`` (same band count: bitwise; another band count or a
  single engine's: converted) and ``load_state(cfg=...)``.
- The shape checks, and ``state_is_finite`` / ``Watchdog`` on a state with
  a NaN."""

import numpy as np
import pytest
import torch

from _golden_tools import golden_cfg
from _torch_tools import assert_frames_match, compare_states, port_config
from mirror_maze_tpu import config as j_config
from mirror_maze_tpu.parallel import shard as j_shard
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.runtime.loop import run_scripted as j_run
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.runtime.state import load_state as j_load
from mirror_maze_tpu.runtime.state import save_state as j_save
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.parallel import shard
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import (
    EngineState,
    FrameInputs,
    from_reference_sharded_state,
    init_state,
    load_state,
    save_state,
)
from mirror_maze_tpu_torch.runtime.watchdog import Watchdog, state_is_finite
from mirror_maze_tpu_torch.scene import build_scene

THEN = [dict(), dict(d=True), dict(mouse_dx=4.0), dict()]


def _inputs(fi, script):
    return [fi.make(**kw) for kw in script]


def _setup(intersector="brute"):
    jcfg = golden_cfg(intersector)
    cfg = port_config(jcfg)
    return jcfg, cfg, j_upload(j_build(jcfg.maze)), upload_scene(build_scene(cfg.maze),
                                                                 device="cpu")


def test_port_checkpoint_resumes_in_jax(tmp_path):
    jcfg, cfg, jscene, scene = _setup()
    st, _ = run_scripted(scene, cfg, inputs=_inputs(FrameInputs, [dict(w=True)] * 2
                                                    + [dict(mouse_dx=-9.0)] * 2))
    path = str(tmp_path / "port.npz")
    save_state(path, st)
    with np.load(path) as z:
        assert z["key"].dtype == np.uint32 and z["perm"].dtype == np.int32
    jst = j_load(path, jcfg)
    compare_states(jst, st)
    assert np.array_equal(np.asarray(jst.screen), st.screen.numpy())
    jst2, jframe = j_run(jscene, jcfg, inputs=_inputs(JInputs, THEN), state=jst)
    st2, frame = run_scripted(scene, cfg, inputs=_inputs(FrameInputs, THEN), state=st)
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst2, st2)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jcfg, cfg, jscene, scene = _setup("exact")
    jst, _ = j_run(jscene, jcfg, inputs=_inputs(JInputs, [dict(w=True)] * 3))
    path = str(tmp_path / "jax.npz")
    j_save(path, jst)
    st = load_state(path, cfg, device="cpu")
    for f in EngineState._fields:
        assert np.array_equal(getattr(st, f).numpy(),
                              np.asarray(getattr(jst, f)).astype(getattr(st, f).numpy().dtype)), f
    # Saved again by the port: the same arrays, dtypes included.
    again = str(tmp_path / "again.npz")
    save_state(again, st)
    with np.load(path) as a, np.load(again) as b:
        for f in EngineState._fields:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f
    jst2, jframe = j_run(jscene, jcfg, inputs=_inputs(JInputs, THEN), state=jst)
    st2, frame = run_scripted(scene, cfg, inputs=_inputs(FrameInputs, THEN), state=st)
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst2, st2)


def _band_cfg(pkg, n_tile):
    return pkg.EngineConfig(
        maze=pkg.MazeConfig(width=4, height=4),
        camera=pkg.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
        screen=pkg.ScreenConfig(width=32, height=32, samples_per_pixel=2,
                                chunks_per_frame=8),
        intersector="brute")


def test_band_checkpoints_restore_and_convert(tmp_path):
    jcfg = _band_cfg(j_config, 2)
    cfg = port_config(jcfg)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    init_fn, step_fn = shard.make_sharded_engine(cfg, ["cpu"] * 2)
    st = init_fn(0)
    for inp in [FrameInputs.make(w=True)] * 3 + [FrameInputs.make(mouse_dx=5.0)]:
        st, _ = step_fn(scene, st, inp)
    path = str(tmp_path / "bands.npz")
    save_state(path, st)
    # Same band count: bitwise.
    back = shard.load_sharded_state(path, cfg, ["cpu"] * 2)
    for a, b in zip(st, back):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # The JAX package reads the port's band checkpoint as its own.
    jst = j_shard.load_sharded_state(path, jcfg, 2)
    assert np.array_equal(np.asarray(jst.key), np.stack([k.numpy() for k in st.key]))
    # As a single engine: the JAX package's conversion, field for field.
    single = load_state(path, cfg, device="cpu")
    jsingle = j_load(path, jcfg)
    for f in EngineState._fields:
        assert np.array_equal(getattr(single, f).numpy(), np.asarray(getattr(jsingle, f))), f
    # Four bands from the two-band file, and from a single engine's file.
    four = shard.load_sharded_state(path, cfg, ["cpu"] * 4)
    jfour = j_shard.load_sharded_state(path, jcfg, 4)
    assert four.n_bands == 4
    ref = from_reference_sharded_state({f: np.asarray(getattr(jfour, f)) for f in jfour._fields},
                                       ["cpu"] * 4)
    for a, b in zip(four, ref):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    spath = str(tmp_path / "single.npz")
    save_state(spath, single)
    two = shard.load_sharded_state(spath, cfg, ["cpu"] * 2)
    assert torch.equal(torch.cat(list(two.screen)), single.screen)
    with pytest.raises(ValueError, match="tile-sharded"):
        load_state(path, device="cpu")


def test_checkpoint_shape_checks(tmp_path):
    jcfg, cfg, _, _ = _setup()
    path = str(tmp_path / "s.npz")
    save_state(path, init_state(cfg, device="cpu"))
    other = cfg.replace(screen=cfg.screen.__class__(width=32, height=32, samples_per_pixel=1))
    with pytest.raises(ValueError, match="screen shape"):
        load_state(path, other, device="cpu")
    with pytest.raises(ValueError, match="screen shape"):
        shard.load_sharded_state(path, other, ["cpu"] * 2)
    bands = _band_cfg(j_config, 2)
    bcfg = port_config(bands)
    init_fn, _ = shard.make_sharded_engine(bcfg, ["cpu"] * 2)
    bpath = str(tmp_path / "b.npz")
    save_state(bpath, init_fn(0))
    wrong = bcfg.replace(screen=bcfg.screen.__class__(width=64, height=32, samples_per_pixel=2,
                                                      chunks_per_frame=8))
    with pytest.raises(ValueError, match="screen shape"):
        shard.load_sharded_state(bpath, wrong, ["cpu"] * 2)
    with np.load(bpath) as z:
        arrays = dict(z)
    np.savez(bpath, **dict(arrays, key=arrays["key"][:, :1]))
    with pytest.raises(ValueError, match="key shape"):
        shard.load_sharded_state(bpath, bcfg, ["cpu"] * 2)
    np.savez(path, cam_center=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="lacks"):
        load_state(path, device="cpu")


def test_watchdog_rolls_back_a_nan_state():
    cfg = port_config(golden_cfg("brute"))
    good = init_state(cfg, device="cpu")
    assert state_is_finite(good)
    bad = good._replace(quat=torch.tensor([float("nan"), 0.0, 0.0, 1.0]))
    assert not state_is_finite(bad)
    assert not state_is_finite(good._replace(half_theta=torch.tensor(float("inf"))))
    wd = Watchdog(interval=2)
    assert wd.check(good) is good                 # first check snapshots
    assert wd.check(bad) is bad                   # not due yet
    back = wd.check(bad)                          # due: rolled back
    assert wd.rollbacks == 1 and torch.equal(back.quat, good.quat) and back.quat is not good.quat
    again = wd.check(bad, n=2)                    # the snapshot survives a second rollback
    assert wd.rollbacks == 2 and torch.equal(again.cam_center, good.cam_center)
    with pytest.raises(FloatingPointError):
        Watchdog(interval=1).check(bad)


def test_watchdog_rolls_back_a_band_engine_state():
    """The band engine's state (every field a tuple over the bands), as the
    reference's watchdog takes any state: a non-finite camera on one band
    rolls every band back to the snapshot."""
    from mirror_maze_tpu_torch.parallel.shard import make_sharded_engine

    cfg = port_config(golden_cfg("brute"))
    init_fn, _ = make_sharded_engine(cfg, ["cpu"] * 2)
    good = init_fn(seed=0)
    assert state_is_finite(good)
    bad = good._replace(cam_center=(good.cam_center[0],
                                    torch.tensor([0.0, float("nan"), 0.0])))
    assert not state_is_finite(bad)
    wd = Watchdog(interval=1)
    assert wd.check(good) is good
    back = wd.check(bad)
    assert wd.rollbacks == 1 and type(back) is type(good)
    for a, b in zip(back, good):
        assert all(torch.equal(x, y) and x is not y for x, y in zip(a, b))
