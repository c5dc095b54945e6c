"""The port's scripted engine run against the JAX package's, live and
against the committed golden frame.

Both sides run the golden configuration (tests/_golden_tools.py
golden_cfg("pallas")) through the same 28-frame script (idle, walk, turn,
idle). Frames follow the golden rule of tests/test_golden.py; the queue,
cursor, key and frame counter must be bitwise equal, the camera within
atol=1e-6.

A third run covers the multi-tile path end to end: a 16x16 maze (its walls
fill two tiles), ``noise_rng`` on, the chunk window Morton-sorted, 12 frames.
A fourth runs a 6x6 maze with glass panes (``glass_prob`` 0.5, ``fresnel``
on) for the same 12 frames. The offline ``render_full_frame`` is held
against the JAX one at 32x24, and on the Cornell box with the glass sphere
through the thin lens at 32x32: float frames, >= 99.5% of values within
atol 1e-5 and the mean within 1e-3 (the camera glue differs from jitted XLA
by an ulp, which can flip a hit on an edge or a reflect/refract decision).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

import _golden_tools
import mirror_maze_tpu_torch as P
from _golden_tools import golden_cfg
from _torch_tools import (
    CORNELL_GLASS_CENTRE,
    GALLERY_SPAWN,
    assert_frames_match,
    compare_states,
    cornell_scene,
    gallery_config,
    glass_maze_config,
    golden_config,
    golden_script,
    multi_tile_config,
    multi_tile_script,
    port_config,
)
from mirror_maze_tpu import config as j_config
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.render.pipeline import render_full_frame as j_full_frame
from mirror_maze_tpu.runtime.state import init_state as j_init
from mirror_maze_tpu.runtime.loop import run_scripted as j_run
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.render.camera import make_camera as j_make_camera
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu.scene.builder import Scene as JScene
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.render import make_camera, render_full_frame, upload_scene
from mirror_maze_tpu_torch.runtime.state import init_state
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


def test_multi_tile_noise_seeded_run_matches_jax():
    jcfg = multi_tile_config(j_config)
    cfg = port_config(jcfg)
    assert cfg == multi_tile_config(P)
    script = multi_tile_script
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    assert max(g[2] for g in scene.group_meta) > 1
    st, frame = run_scripted(scene, cfg, inputs=script(FrameInputs))
    jst, jframe = j_run(j_upload(j_build(jcfg.maze)), jcfg, inputs=script(JInputs))
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst, st)
    assert frame.mean() > 1.0


def test_render_full_frame_matches_jax():
    jcfg = multi_tile_config(j_config, width=32, height=24)
    cfg = port_config(jcfg)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    got = render_full_frame(scene, init_state(cfg, device="cpu").camera(cfg),
                            prng.PRNGKey(5, device="cpu"), cfg, rows_per_batch=16).numpy()
    jscene = j_upload(j_build(jcfg.maze))
    want = np.asarray(j_full_frame(jscene, j_init(jcfg).camera(jcfg), jax.random.PRNGKey(5),
                                   jcfg, rows_per_batch=16))
    assert got.shape == want.shape == (24, 32, 3) and got.dtype == np.float32
    assert np.isclose(got, want, rtol=0, atol=1e-5).mean() >= 0.995
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    assert want.mean() > 0


def test_glass_maze_run_matches_jax():
    jcfg = glass_maze_config(j_config)
    cfg = port_config(jcfg)
    assert cfg == glass_maze_config(P)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    assert scene.has_glass and scene.mode_counts[6] == 2
    st, frame = run_scripted(scene, cfg, inputs=multi_tile_script(FrameInputs))
    jst, jframe = j_run(j_upload(j_build(jcfg.maze)), jcfg, inputs=multi_tile_script(JInputs))
    assert_frames_match(frame, np.asarray(jframe))
    compare_states(jst, st)
    assert frame.mean() > 1.0
    # The panes are in the picture: the same run without them differs.
    bare = dataclasses.replace(cfg, maze=dataclasses.replace(cfg.maze, glass_prob=0.0))
    _, other = run_scripted(upload_scene(build_scene(bare.maze), device="cpu"), bare,
                            inputs=multi_tile_script(FrameInputs))
    assert (frame != other).any()


def test_cornell_glass_full_frame_matches_jax():
    focus = float(np.linalg.norm(np.subtract(CORNELL_GLASS_CENTRE, GALLERY_SPAWN)))
    cfg = gallery_config(32, 4, aperture=0.15, focus_dist=focus)
    jcfg = j_config.EngineConfig(
        camera=j_config.CameraConfig(**dataclasses.asdict(cfg.camera)),
        screen=j_config.ScreenConfig(**dataclasses.asdict(cfg.screen)),
        intersector="pallas")
    assert port_config(jcfg) == cfg
    scene = cornell_scene("glass")
    got = render_full_frame(upload_scene(scene, device="cpu"),
                            make_camera(cfg.camera, 1.0, "cpu"), prng.PRNGKey(0, device="cpu"),
                            cfg, rows_per_batch=16).numpy()
    jscene = JScene(**{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})
    want = np.asarray(j_full_frame(j_upload(jscene), j_make_camera(jcfg.camera, 1.0),
                                   jax.random.PRNGKey(0), jcfg, rows_per_batch=16))
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.float32
    close = np.isclose(got, want, rtol=0, atol=1e-5).mean()
    print(f"cornell glass, thin lens: {close:.4f} of values within 1e-5")
    assert close >= 0.995
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()
    assert want.mean() > 0.05


def test_scripted_run_matches_committed_golden():
    cfg = golden_config()
    _, frame = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                            inputs=golden_script(FrameInputs))
    with np.load(GOLDEN) as z:
        ref = z["img"]
    assert_frames_match(frame, ref)
