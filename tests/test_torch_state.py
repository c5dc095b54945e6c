"""Engine state carried across from the JAX package: its save_state .npz
after 4 frames, loaded with from_reference_state, then 4 more frames on
both sides; on the golden configuration and on a multi-tile, noise-seeded
one."""

import numpy as np
import pytest
import torch

from _golden_tools import golden_cfg
from _torch_tools import assert_frames_match, compare_states, multi_tile_config, port_config
from mirror_maze_tpu import config as j_config
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.runtime.loop import run_scripted as j_run
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.runtime.state import save_state
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import (
    EngineState,
    FrameInputs,
    from_reference_state,
    init_state,
)
from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_step
from mirror_maze_tpu_torch.scene import build_scene


def test_state_carried_across(tmp_path):
    _carry_across(tmp_path, golden_cfg("pallas"))


def test_state_carried_across_multi_tile(tmp_path):
    _carry_across(tmp_path, multi_tile_config(j_config))


def _carry_across(tmp_path, jcfg):
    cfg = port_config(jcfg)
    jdev = j_upload(j_build(jcfg.maze))
    first = [JInputs.make(w=True)] * 2 + [JInputs.make(mouse_dx=-9.0)] * 2
    jst, _ = j_run(jdev, jcfg, inputs=first)
    path = tmp_path / "state.npz"
    save_state(str(path), jst)
    with np.load(path) as z:
        st = from_reference_state(dict(z), device="cpu")
    assert all(isinstance(getattr(st, f), torch.Tensor) for f in EngineState._fields)
    compare_states(jst, st)
    torch.testing.assert_close(st.screen, torch.from_numpy(np.array(jst.screen)),
                               rtol=0, atol=0)

    then_j = [JInputs.idle(), JInputs.make(d=True), JInputs.make(mouse_dx=4.0),
              JInputs.idle()]
    then_p = [FrameInputs.idle(), FrameInputs.make(d=True), FrameInputs.make(mouse_dx=4.0),
              FrameInputs.idle()]
    jst2, jframe = j_run(jdev, jcfg, inputs=then_j, state=jst)
    st2, frame = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                              inputs=then_p, state=st)
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst2, st2)


def test_scan_step_equals_stepping():
    cfg = port_config(golden_cfg("pallas"))
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    inputs = [FrameInputs.idle(), FrameInputs.make(w=True), FrameInputs.make(mouse_dx=3.0)]
    step = make_step(scene, cfg)
    st = init_state(cfg, device="cpu")
    for inp in inputs:
        st, frame = step(st, inp)
    st_scan, frame_scan = make_scan_step(scene, cfg)(init_state(cfg, device="cpu"), inputs)
    assert torch.equal(frame, frame_scan)
    for a, b in zip(st, st_scan):
        assert torch.equal(a, b)


def test_from_reference_state_rejects_partial_state():
    with pytest.raises(ValueError):
        from_reference_state({"cam_center": np.zeros(3, np.float32)}, device="cpu")
