"""The port's scripted engine run against the JAX package's, live and
against the committed golden frame.

Both sides run the golden configuration (tests/_golden_tools.py
golden_cfg("pallas")) through the same 28-frame script (idle, walk, turn,
idle). Frames follow the golden rule of tests/test_golden.py; the queue,
cursor, key and frame counter must be bitwise equal, the camera within
atol=1e-6.
"""

import dataclasses
import os

import numpy as np
import pytest

import _golden_tools
from _golden_tools import golden_cfg
from _torch_tools import (
    assert_frames_match,
    compare_states,
    golden_config,
    golden_script,
    port_config,
)
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.runtime.loop import run_scripted as j_run
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs
from mirror_maze_tpu_torch.scene import build_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "script_pallas.npz")


def _frame_tuple(f):
    return (tuple(bool(k) for k in np.asarray(f.keys)), float(f.mouse_dx),
            bool(f.rot_updated))


def test_shared_golden_config_and_script_are_the_reference_ones(monkeypatch):
    """chip_smoke.py and the CUDA tests use golden_config and golden_script,
    which must stay the JAX package's golden configuration and the script
    its run_golden_script feeds the engine."""
    assert golden_config() == port_config(golden_cfg("pallas"))
    seen = {}

    def record(dev, cfg, inputs):
        seen["inputs"] = list(inputs)
        return None, None

    monkeypatch.setattr(_golden_tools, "run_scripted", record)
    _golden_tools.run_golden_script("pallas")
    assert ([_frame_tuple(f) for f in golden_script(FrameInputs)]
            == [_frame_tuple(f) for f in seen["inputs"]])


def _variant(name):
    cfg = golden_cfg("pallas")
    if name == "sorted_b2":
        cfg = cfg.replace(
            screen=dataclasses.replace(cfg.screen, sort_chunk_window=True),
            tracer=dataclasses.replace(cfg.tracer, block_rows=2),
        )
    return cfg


@pytest.mark.parametrize("variant", ["golden", "sorted_b2"])
def test_scripted_run_matches_jax(variant):
    jcfg = _variant(variant)
    cfg = port_config(jcfg)
    st, frame = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                             inputs=golden_script(FrameInputs))
    jst, jframe = j_run(j_upload(j_build(jcfg.maze)), jcfg, inputs=golden_script(JInputs))
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst, st)
    assert st.screen.shape == tuple(np.asarray(jst.screen).shape)


def test_scripted_run_matches_committed_golden():
    cfg = golden_config()
    _, frame = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                            inputs=golden_script(FrameInputs))
    with np.load(GOLDEN) as z:
        ref = z["img"]
    assert_frames_match(frame, ref)
