"""The port's step body, written for CUDA graph capture, on the CPU.

- The step reads its keys and mouse delta from a device tensor: fed the
  golden script, the multi-tile script and a script of every key, it gives
  state and frame bitwise equal to the step as it stood with host floats
  (``_host_input_step`` below), through ``make_step``, ``make_step_fn``,
  ``make_scan_step`` and ``make_scan_step_fn``.
- ``make_scan_step_fn`` over a stacked script against the JAX package's
  ``jax.jit(make_scan_step_fn(...))`` (its Pallas tracer interpreted on the
  CPU): the queue, cursor, key and frame counter bitwise, the camera within
  atol=1e-6 (``compare_states``), the frame by the golden rule.
- After one warm-up frame, the step body (intersector brute, exact, bvh
  with the plain walk stubbed, and pallas with the fused tracer stubbed)
  and the band engine's body run under
  a TorchFunctionMode that raises on every host read and host copy: what a
  CUDA graph capture forbids.
- The graph runner's host bookkeeping: the input rows and the graph kind
  per frame, the per-call plan, launches counted apart while capturing and
  added per replay.

The graphs themselves need the card: tests/test_torch_cuda.py.
"""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mirror_maze_tpu_torch as P
from _golden_tools import golden_cfg
from _torch_tools import (
    NoHostReads,
    assert_frames_match,
    compare_states,
    golden_config,
    golden_script,
    multi_tile_config,
    multi_tile_script,
)
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.runtime.state import init_state as j_init
from mirror_maze_tpu.runtime.step import make_scan_step_fn as j_scan_step_fn
from mirror_maze_tpu.runtime.step import stack_inputs as j_stack
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.ops import quat as quat_ops
from mirror_maze_tpu_torch.parallel import shard
from mirror_maze_tpu_torch.render import fused_tracer, intersect, pipeline, upload_scene
from mirror_maze_tpu_torch.render.accumulate import (
    feedback_blur_cm,
    present_stage,
    scatter_chunk_rows,
)
from mirror_maze_tpu_torch.render.present import present
from mirror_maze_tpu_torch.render.scheduler import (
    adaptive_reorder,
    chunk_origin_xy,
    chunk_pixels,
    sort_window_morton,
    take_chunks,
)
from mirror_maze_tpu_torch.runtime import graph
from mirror_maze_tpu_torch.runtime.state import EngineState, FrameInputs, init_state
from mirror_maze_tpu_torch.runtime.step import (
    GRAPH_INTERSECTORS,
    PI_F32,
    _advance,
    _mod,
    display,
    graph_kinds,
    input_stack,
    make_scan_step,
    make_scan_step_fn,
    make_step,
    make_step_fn,
    resolve_collision,
    stack_inputs,
    upload_inputs,
)
from mirror_maze_tpu_torch.scene import build_scene


def _every_key_script(fi) -> list:
    """Each key alone, pairs, all four (they cancel), turns both ways,
    a turn while walking, and idle frames between."""
    return ([fi.make(a=True)] * 2 + [fi.make(s=True)] * 2 + [fi.make(d=True)] * 2
            + [fi.make(a=True, w=True), fi.make(s=True, d=True)]
            + [fi.make(a=True, s=True, d=True, w=True)] + [fi.idle()]
            + [fi.make(mouse_dx=-27.0)] * 2 + [fi.make(w=True, mouse_dx=9.5)] * 2
            + [fi.make(d=True, mouse_dx=1e9)] + [fi.idle()] * 2)


CASES = {
    "golden": (golden_config, golden_script),
    "multi_tile": (lambda: multi_tile_config(P), multi_tile_script),
    "every_key": (golden_config, _every_key_script),
}


def _host_input_step(scene, cfg, state: EngineState, inp: FrameInputs) -> EngineState:
    """One frame as the step computed it with its input on the host: the keys
    as Python floats and the yaw delta rounded to float32 on the host
    (`main.rs:786-842`), the rest as the step body does."""
    sc = cfg.screen
    frame = state.frame + 1
    ids, cursor_next = take_chunks(state.perm, state.cursor, sc.effective_chunks_per_frame)
    if sc.sort_chunk_window:
        ids = sort_window_morton(ids, sc)
    perm = state.perm
    if sc.adaptive_refresh:
        perm = adaptive_reorder(state.perm, state.cursor, cursor_next, state.screen)
    step = cfg.camera.move_speed / sc.fps
    f32 = dict(dtype=torch.float32, device=state.cam_center.device)
    right = quat_ops.rotate(torch.tensor([step, 0.0, 0.0], **f32), state.quat)
    fwd = quat_ops.rotate(torch.tensor([0.0, 0.0, step], **f32), state.quat)
    a, s, d, w = (float(k) for k in inp.keys)
    moved = state.cam_center + (-right * a - fwd * s + right * d + fwd * w)
    center = resolve_collision(cfg, scene, moved, state.cam_center)
    rkey, key = prng.split(state.key)
    quat, half, cursor = state.quat, state.half_theta, cursor_next
    if inp.rot_updated:
        dx = float(np.float32(inp.mouse_dx) * np.float32(cfg.camera.mouse_sensitivity))
        half = _mod(state.half_theta - dx, PI_F32)
        candidate = quat_ops.update_angle(state.quat, half)
        ok = torch.isfinite(candidate).all()
        quat = torch.where(ok, candidate, state.quat)
        perm = torch.where(ok, prng.permutation(rkey, perm.shape[0]).to(torch.int32), perm)
        cursor = torch.where(ok, torch.zeros_like(cursor_next), cursor_next)
    pixels = chunk_pixels(chunk_origin_xy(ids, sc), sc.chunk_width)
    cam = state._replace(cam_center=center, quat=quat).camera(cfg)
    colors = pipeline.render_pixels(scene, cam, pixels, prng.fold_in(key, frame), cfg)
    screen = present_stage(scatter_chunk_rows(state.screen, ids, colors), sc,
                           lambda scr, quantize: present(scr, sc, quantize=quantize),
                           lambda scr: feedback_blur_cm(scr, sc))
    return EngineState(cam_center=center, quat=quat, half_theta=half, screen=screen, perm=perm,
                       cursor=cursor, key=key, frame=frame)


def _assert_states_equal(a: EngineState, b: EngineState) -> None:
    for f in EngineState._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_body_is_bitwise_the_host_input_step(case):
    make_cfg, make_script = CASES[case]
    cfg = make_cfg()
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    script = make_script(FrameInputs)
    ref = init_state(cfg, device="cpu")
    for inp in script:
        ref = _host_input_step(scene, cfg, ref, inp)
    ref_frame = display(ref, cfg)

    step, step_fn = make_step(scene, cfg), make_step_fn(cfg)
    st = st_fn = init_state(cfg, device="cpu")
    for inp in script:
        st, frame = step(st, inp)
        st_fn, frame_fn = step_fn(scene, st_fn, inp)
    st_scan, frame_scan = make_scan_step(scene, cfg)(init_state(cfg, device="cpu"), script)
    st_fn_scan, frame_fn_scan = make_scan_step_fn(cfg, len(script))(
        scene, init_state(cfg, device="cpu"), stack_inputs(script))
    for got, got_frame in ((st, frame), (st_fn, frame_fn), (st_scan, frame_scan),
                           (st_fn_scan, frame_fn_scan)):
        _assert_states_equal(got, ref)
        assert torch.equal(got_frame, ref_frame)
    assert float(ref_frame.float().mean()) > 1.0


def test_scan_step_fn_matches_jax_jit_scan():
    """The port's unjitted scan against the JAX package's jitted one, over
    the stacked golden script."""
    jcfg = golden_cfg("pallas")
    cfg = golden_config()
    n = len(golden_script(FrameInputs))
    jst, jframe = jax.jit(j_scan_step_fn(jcfg, n))(
        j_upload(j_build(jcfg.maze)), j_init(jcfg, seed=0), j_stack(golden_script(JInputs)))
    st, frame = make_scan_step_fn(cfg, n)(upload_scene(build_scene(cfg.maze), device="cpu"),
                                          init_state(cfg, seed=0, device="cpu"),
                                          stack_inputs(golden_script(FrameInputs)))
    compare_states(jst, st)
    assert_frames_match(frame.numpy(), np.asarray(jframe))


def test_scan_step_fn_takes_its_frame_count():
    cfg = golden_config()
    run = make_scan_step_fn(cfg, 3)
    with pytest.raises(ValueError, match="3 frames"):
        run(upload_scene(build_scene(cfg.maze), device="cpu"), init_state(cfg, device="cpu"),
            [FrameInputs.idle()] * 2)


def _stub_fused_tracer(monkeypatch):
    """The fused tracer replaced by a tensor of its output's shape (its CUDA
    wrapper is glue the card runs; its plain version is not)."""
    monkeypatch.setattr(pipeline, "trace_paths_fused",
                        lambda scene, ori, dirs, seed, *a, **k: torch.full_like(ori, 0.25))


def _stub_plain_walk(monkeypatch):
    """The plain BVH walk (its host check of any(live) is what the card's
    kernel does not do) replaced by a result of its shape: every ray
    misses the planes; the sphere fold after it still runs."""
    def walk(prims, o, d, t_min, *a, **k):
        t = torch.full(o.shape[:1], 1e30)
        idx = torch.zeros(o.shape[:1], dtype=torch.int32)
        return intersect._merge_spheres(prims, o, d, t_min, t, idx) if prims.num_spheres \
            else (t, idx)

    monkeypatch.setattr(pipeline, "nearest_hit_bvh", walk)


def _stub_backends(monkeypatch, cfg):
    if cfg.intersector == "pallas":
        _stub_fused_tracer(monkeypatch)
    if cfg.intersector == "bvh":
        _stub_plain_walk(monkeypatch)


BODY_CONFIGS = {
    "brute": lambda: golden_config().replace(intersector="brute"),
    "exact": lambda: golden_config().replace(intersector="exact"),
    "bvh": lambda: golden_config().replace(intersector="bvh"),
    "pallas": golden_config,
    "pallas_multi_tile": lambda: multi_tile_config(P),
    "pallas_adaptive_lens": lambda: dataclasses.replace(
        golden_config(), screen=dataclasses.replace(golden_config().screen,
                                                    adaptive_refresh=True),
        camera=dataclasses.replace(golden_config().camera, aperture=0.1)),
}


@pytest.mark.parametrize("name", sorted(BODY_CONFIGS))
def test_step_body_has_no_host_read(monkeypatch, name):
    cfg = BODY_CONFIGS[name]()
    _stub_backends(monkeypatch, cfg)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    nearest = pipeline.scene_nearest_fn(scene, cfg)
    n = cfg.screen.effective_chunks_per_frame
    frames = [FrameInputs.make(w=True), FrameInputs.make(d=True, mouse_dx=-27.0)]
    rows = upload_inputs(frames, "cpu")
    st = init_state(cfg, device="cpu")
    for i, rotate in enumerate(graph_kinds(frames)):        # the warm-up frames
        st = _advance(scene, cfg, n, st, rows[i], rotate, nearest)
    with NoHostReads():
        for i, rotate in enumerate(graph_kinds(frames)):
            st = _advance(scene, cfg, n, st, rows[i], rotate, nearest)
    assert int(st.frame) == 4


@pytest.mark.parametrize("intersector", ["pallas", "brute", "bvh"])
def test_band_body_has_no_host_read(monkeypatch, intersector):
    """The band engine's frame on one device: every band's step, the halo
    rows and the halo presents (with bvh, its bounds derived at the first,
    eager frame)."""
    cfg = golden_config().replace(intersector=intersector)
    _stub_backends(monkeypatch, cfg)
    init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, ["cpu"] * 2)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    runner = scan_fn.runner_of(scene)
    frames = [FrameInputs.idle(), FrameInputs.make(mouse_dx=16.0)]
    rows = upload_inputs(frames, "cpu")
    st = runner(init_fn(0), rows, graph_kinds(frames))      # the warm-up frames
    with NoHostReads():
        st = runner(st, rows, graph_kinds(frames))
    assert [int(f) for f in st.frame] == [4, 4]


def test_input_rows_and_kinds():
    script = golden_script(FrameInputs) + [FrameInputs.make(a=True, s=True, mouse_dx=2.5)]
    rows = input_stack(script)
    assert rows.dtype == np.float32 and rows.shape == (29, 5)
    np.testing.assert_array_equal(rows[8], [0, 0, 0, 1, 0])
    np.testing.assert_array_equal(rows[16], [0, 0, 0, 0, 16.0])
    np.testing.assert_array_equal(rows[-1], [1, 1, 0, 0, 2.5])
    assert graph_kinds(script) == [False] * 16 + [True] * 4 + [False] * 8 + [True]
    up = upload_inputs(script, "cpu")
    assert up.dtype == torch.float32 and np.array_equal(up.numpy(), rows)
    # A FrameInputs that says it rotates with no delta still takes the
    # rotating body, as the reference's rot_updated flag.
    odd = FrameInputs(keys=(False,) * 4, mouse_dx=0.0, rot_updated=True)
    assert graph_kinds([odd]) == [True]


def test_call_plan_runs_the_first_frame_of_a_kind_eagerly():
    plan = graph.call_plan([False, False, True, True, False], captured=())
    assert plan == [("eager", False), ("replay", False), ("eager", True), ("replay", True),
                    ("replay", False)]
    assert graph.call_plan([True, False], captured=(False,)) == [("eager", True),
                                                                 ("replay", False)]
    assert graph.call_plan([], captured=()) == []


def test_launches_counted_apart_while_capturing_and_added_per_replay(monkeypatch):
    calls = []
    monkeypatch.setitem(kernels._libs, "fake", lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(kernels.torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(kernels, "launches", collections.Counter())
    kernels.launch("fake", 1)
    assert kernels.launches == {"fake": 1}
    with kernels.counting_capture() as captured:
        kernels.launch("fake", 2)
        kernels.launch("fake", 3, count_as="fake_halo")
    assert captured == {"fake": 1, "fake_halo": 1}
    assert kernels.launches == {"fake": 1}            # the capture ran nothing
    for _ in range(3):                                 # three replays
        kernels.add_launches(captured)
    assert kernels.launches == {"fake": 4, "fake_halo": 3}
    assert len(calls) == 3


def test_work_counters_nest_and_check_their_pair():
    a, b = torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with fused_tracer.work_counters(a):
        with fused_tracer.work_counters(b):
            assert fused_tracer._graph_work[-1] is b
        assert fused_tracer._graph_work[-1] is a
    assert not fused_tracer._graph_work
    with pytest.raises(ValueError, match="two int32"):
        with fused_tracer.work_counters(torch.zeros(2, dtype=torch.int64)):
            pass


def test_runner_is_eager_off_the_card_and_for_the_bvh_walk():
    """Every intersector's runner captures graphs (the bvh walk is a kernel
    on the card, so ``bvh`` is one of GRAPH_INTERSECTORS), and every one
    runs eagerly on a CPU state."""
    cfg = golden_config()
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    st = init_state(cfg, device="cpu")
    assert "bvh" in GRAPH_INTERSECTORS
    assert set(GRAPH_INTERSECTORS) == {"pallas", "brute", "exact", "bvh"}
    for intersector in GRAPH_INTERSECTORS:
        c = cfg.replace(intersector=intersector)
        for make in (make_scan_step, make_step):
            runner = make(scene, c).runner
            assert runner._use_graphs, intersector
            assert not runner.graphed(st), intersector
    runner = make_scan_step(scene, cfg.replace(intersector="bvh")).runner
    runner(st, upload_inputs([FrameInputs.idle()], "cpu"), [False])
    assert runner.graphs == {}


def test_state_flattens_and_rebuilds():
    cfg = golden_config()
    single = init_state(cfg, device="cpu")
    leaves = graph._flatten(single)
    assert len(leaves) == 8 and leaves[3] is single.screen
    back = graph._unflatten(single, leaves)
    assert type(back) is EngineState and all(a is b for a, b in zip(back, single))
    init_fn, _ = shard.make_sharded_engine(cfg, ["cpu"] * 2)
    bands = init_fn(0)
    leaves = graph._flatten(bands)
    assert len(leaves) == 16 and leaves[6] is bands.screen[0]
    back = graph._unflatten(bands, leaves)
    assert type(back) is shard.ShardedEngineState
    assert all(x is y for a, b in zip(back, bands) for x, y in zip(a, b))
