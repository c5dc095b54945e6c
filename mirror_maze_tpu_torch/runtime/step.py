"""The per-frame engine step (counterpart of the JAX package's
``runtime/step.py``).

One frame, in the reference's order (`main.rs:767-894`):

1. pop the next chunk window from the queue;
2. integrate WASD movement in the camera frame, revert it on collision;
3. apply the mouse yaw with the finite guard, regenerating the chunk queue
   on a successful rotation (it takes effect NEXT frame, as the reference);
4. trace the popped chunks (the fused tracer kernel, or the jnp tracer with
   the brute, exact or bvh backend, built once per scene) and write them
   into the screen; with ``adaptive_refresh`` the queue is first reordered
   by the screen's detail whenever the pop wrapped it;
5. feedback blur + 8-bit quantization (the present kernel).

On the card the glue around the tracer is three hand-written kernels:
``frame_setup`` (steps 1-2 and the frame's keys, csrc/frame_setup.cu),
``camera_rays`` and ``resolve`` (render/frame_glue.py). The rest of step 3
(the yaw, the queue's draw) runs as torch ops on the frames that rotate.

The step body reads a frame's input from a device tensor, one row of
``upload_inputs`` (keys A, S, D, W as 0/1 and the mouse delta), and holds
no host value, so it can be captured into a CUDA graph. Whether the frame
rotates is the one thing the host decides: it picks between two bodies
(the JAX package's ``lax.cond``), and with them between two graphs.

``make_step`` / ``make_scan_step`` are the counterparts of the JAX
package's jitted, donated steps: on a CUDA state every frame is one replay
of a captured CUDA graph (runtime/graph.py), whatever the intersector (the
``bvh`` walk is the ``bvh_walk`` kernel there, render/intersect.py); on the
CPU they run the body eagerly. ``make_step_fn`` / ``make_scan_step_fn`` are
the unjitted forms, eager everywhere, with the scene an argument.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import kernels
from ..config import EngineConfig, ScreenConfig
from ..device import constant, on_card
from ..ops import prng
from ..ops import quat as quat_ops
from ..render.accumulate import (
    cm_to_spatial,
    feedback_blur_cm,
    present_stage,
    to_display,
)
from ..render.frame_glue import Window, need_card, operand, params_type, resolve
# derive_traversal_bounds is re-exported, where the JAX package has it.
from ..render.pipeline import (  # noqa: F401
    INT32_MAX,
    derive_traversal_bounds,
    scene_nearest_fn,
    trace_samples,
    tracer_seed,
)
from ..render.present import present
from ..render.scenebuf import DeviceScene
from ..render.scheduler import adaptive_reorder, sort_window_morton, take_chunks
from ..scene.collision import collides
from ..utils.profiling import span
from .graph import StepRunner, state_owned
from .state import EngineState, FrameInputs

PI_F32 = float(np.float32(np.pi))
# A frame's input row: keys A, S, D, W as 0.0 / 1.0, then mouse_dx (float32).
INPUT_WIDTH = 5
# The intersectors whose step is captured into a CUDA graph on the card.
GRAPH_INTERSECTORS = ("pallas", "brute", "exact", "bvh")


def input_stack(frames: Sequence[FrameInputs]) -> np.ndarray:
    """The frames' input rows, float32 [n, INPUT_WIDTH]."""
    rows = np.zeros((len(frames), INPUT_WIDTH), dtype=np.float32)
    for i, f in enumerate(frames):
        rows[i, :4] = [bool(k) for k in f.keys]
        rows[i, 4] = np.float32(f.mouse_dx)
    return rows


def graph_kinds(frames: Sequence[FrameInputs]) -> list:
    """Per frame whether it rotates (``rot_updated``): the body, and on the
    card the graph, that steps it."""
    return [bool(f.rot_updated) for f in frames]


def upload_rows(rows: np.ndarray, device) -> torch.Tensor:
    """Input rows (float32 [n, k]) on ``device``: to a CUDA device one
    pinned, non-blocking copy."""
    rows = torch.from_numpy(rows)
    dev = torch.device(device)
    if dev.type == "cuda":
        return rows.pin_memory().to(dev, non_blocking=True)
    return rows.to(dev)


def upload_inputs(frames: Sequence[FrameInputs], device) -> torch.Tensor:
    """``input_stack`` on ``device``: to a CUDA device one pinned,
    non-blocking copy for the whole call (the span ``step.upload``)."""
    with span("step.upload"):
        return upload_rows(input_stack(frames), device)


def integrate_movement(
    cfg: EngineConfig, center: torch.Tensor, quat: torch.Tensor, keys: torch.Tensor
) -> torch.Tensor:
    """WASD integration (`main.rs:786-815`): per-key displacement of
    speed/fps rotated into the camera frame; A/S subtract, D/W add. ``keys``
    is [4] float32 (A, S, D, W as 0/1) on the state's device."""
    step = cfg.camera.move_speed / cfg.screen.fps
    dev = center.device
    right = quat_ops.rotate(constant((step, 0.0, 0.0), torch.float32, dev), quat)
    fwd = quat_ops.rotate(constant((0.0, 0.0, step), torch.float32, dev), quat)
    a, s, d, w = keys.unbind()
    delta = -right * a - fwd * s + right * d + fwd * w
    return center + delta


def resolve_collision(
    cfg: EngineConfig,
    scene: DeviceScene,
    new_center: torch.Tensor,
    old_center: torch.Tensor,
) -> torch.Tensor:
    """Revert the whole move on any hit (`main.rs:817-826`)."""
    half = constant(cfg.camera.player_half_extent, torch.float32, new_center.device)
    hit = collides(scene.leaf_min, scene.leaf_max, new_center - half, new_center + half)
    return torch.where(hit, old_center, new_center)


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp.mod for float32: fmod, shifted by y where the signs differ."""
    r = torch.fmod(x, y)
    shift = ((r < 0) != (y < 0)) & (r != 0)
    return torch.where(shift, r + y, r)


def turn(quat: torch.Tensor, half_theta: torch.Tensor, perm: torch.Tensor,
         cursor: torch.Tensor, rkey: torch.Tensor, mouse_dx: torch.Tensor,
         cfg: EngineConfig):
    """The mouse yaw of a frame that rotates (`main.rs:828-842`,
    `main.rs:922-925`): half_theta -= dx * sensitivity, wrapped into [0, pi);
    the quaternion is re-aimed, keeping the old one if the update is not
    finite; on a successful rotation the chunk queue is drawn afresh from
    ``rkey`` and the cursor reset. ``mouse_dx`` is a float32 scalar on the
    state's device. Torch ops on every device.

    Returns (quat, half_theta, perm, cursor)."""
    dx = mouse_dx * float(np.float32(cfg.camera.mouse_sensitivity))
    new_half = _mod(half_theta - dx, PI_F32)
    candidate = quat_ops.update_angle(quat, new_half)
    ok = torch.isfinite(candidate).all()
    quat_out = torch.where(ok, candidate, quat)
    fresh = prng.permutation(rkey, perm.shape[0]).to(torch.int32)
    perm_out = torch.where(ok, fresh, perm)
    cursor_out = torch.where(ok, torch.zeros_like(cursor), cursor)
    return quat_out, new_half, perm_out, cursor_out


def rotation_update(
    quat: torch.Tensor,
    half_theta: torch.Tensor,
    perm: torch.Tensor,
    cursor: torch.Tensor,
    key: torch.Tensor,
    mouse_dx: torch.Tensor,
    rotate: bool,
    cfg: EngineConfig,
):
    """Mouse yaw update (`main.rs:828-842`, `main.rs:922-925`): the key is
    split every frame, rotation or not, and a frame that rotates
    (``rotate``, its ``rot_updated``; the reference's ``lax.cond``) takes
    ``turn`` with the first half. The step draws the split in
    ``frame_setup``.

    Returns (quat, half_theta, perm, cursor, key)."""
    rkey, key = prng.split(key)
    if not rotate:
        return quat, half_theta, perm, cursor, key
    return (*turn(quat, half_theta, perm, cursor, rkey, mouse_dx, cfg), key)


class FrameSetup(NamedTuple):
    """A frame's scalar work (``frame_setup``), device tensors: the window
    ``ids`` [n] int32 (Morton-sorted with ``sort_chunk_window``), the
    ``cursor`` after the pop and the ``frame`` number (int32 []), the camera
    ``center`` [3] after the move and its collision test, the state's next
    ``key`` [2], and the frame's keys [2]: ``rkey`` (the rotation's),
    ``jkey`` (the jitter's) and ``tkey`` (the jnp tracer's), with ``seed``
    int32 [1] the fused tracer's."""
    ids: torch.Tensor
    cursor: torch.Tensor
    frame: torch.Tensor
    center: torch.Tensor
    key: torch.Tensor
    rkey: torch.Tensor
    jkey: torch.Tensor
    tkey: torch.Tensor
    seed: torch.Tensor


def frame_setup_plain(scene: DeviceScene, cfg: EngineConfig, state: EngineState,
                      inp: torch.Tensor, n_chunks: int, grid: ScreenConfig) -> FrameSetup:
    """The plain version of ``frame_setup``: the torch ops of take_chunks,
    sort_window_morton, integrate_movement, resolve_collision and the key
    chain."""
    ids, cursor = take_chunks(state.perm, state.cursor, n_chunks)
    if cfg.screen.sort_chunk_window:
        ids = sort_window_morton(ids, grid)
    moved = integrate_movement(cfg, state.cam_center, state.quat, inp[:4])
    center = resolve_collision(cfg, scene, moved, state.cam_center)
    rkey, key = prng.split(state.key)
    frame = state.frame + 1
    jkey, tkey = prng.split(prng.fold_in(key, frame))
    return FrameSetup(ids=ids, cursor=cursor, frame=frame, center=center, key=key, rkey=rkey,
                      jkey=jkey, tkey=tkey, seed=tracer_seed(tkey))


_SetupParams = params_type(
    ("perm", "cursor", "key", "frame", "center", "quat", "input", "leaf_min", "leaf_max", "ids",
     "cursor_out", "frame_out", "center_out", "key_out", "keys_out", "seed_out", "codes"),
    ("total", "n", "sort", "chunks_x", "leaves", "seed_min", "seed_span", "seed_mult"),
    ("step", "half_x", "half_y", "half_z"))
# Windows the kernel sorts in one block (csrc/frame_setup.cu: 1,024 threads of
# 16 codes in registers at the most); a larger one takes its tiled route,
# tiles of TILE ids merged in passes, through a scratch of 2n codes.
MAX_SORT = 16384
TILE = 2048


def merge_passes(n_chunks: int, sort: bool) -> int:
    """The merge passes the frame_setup kernel's C entry launches after its
    first kernel for a window of ``n_chunks`` ids: ceil(log2(tiles)) on the
    tiled route, none on the one-block route."""
    return (-(-n_chunks // TILE) - 1).bit_length() if sort and n_chunks > MAX_SORT else 0
# The chunk grid's side the Morton codes hold (ops/morton.py spreads 16 bits).
MAX_GRID_SIDE = 1 << 16


def frame_setup_kernel(scene: DeviceScene, cfg: EngineConfig, state: EngineState,
                       inp: torch.Tensor, n_chunks: int, grid: ScreenConfig) -> FrameSetup:
    """``frame_setup`` in one call of the ``frame_setup`` kernel's C entry
    (csrc/frame_setup.cu: one launch, or past MAX_SORT sorted ids the tiled
    route's launches), bitwise its plain version on every tensor it writes.
    Raises on tensors that are not on a CUDA device, on malformed operands
    and, before the launch, on a window larger than the queue or a sorted
    window of a grid whose side exceeds MAX_GRID_SIDE chunks (where the
    reference's 16-bit Morton codes collide); there is no fallback."""
    total = state.perm.shape[0]
    sort = cfg.screen.sort_chunk_window
    if not 1 <= n_chunks <= total:
        raise ValueError(f"a window of {n_chunks} chunks from a queue of {total}")
    if sort and (grid.chunks_x > MAX_GRID_SIDE or grid.chunks_y > MAX_GRID_SIDE):
        raise ValueError(f"the frame_setup kernel sorts windows of a grid of at most 2^16 x "
                         f"2^16 chunks, got {grid.chunks_x} x {grid.chunks_y}")
    dev = state.cam_center.device
    need_card(dev, "frame_setup")
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    leaf_min, leaf_max = scene.leaf_min, scene.leaf_max
    leaves = leaf_min.shape[0]
    p = _SetupParams()
    p.perm = operand("frame_setup", "perm", state.perm, i32, (total,), dev)
    p.cursor = operand("frame_setup", "cursor", state.cursor, i32, (), dev)
    p.key = operand("frame_setup", "key", state.key, i64, (2,), dev)
    p.frame = operand("frame_setup", "frame", state.frame, i32, (), dev)
    p.center = operand("frame_setup", "cam_center", state.cam_center, f32, (3,), dev)
    p.quat = operand("frame_setup", "quat", state.quat, f32, (4,), dev)
    if inp.dtype != f32 or inp.device != dev or inp.ndim != 1 or inp.shape[0] < 4:
        raise ValueError(f"the frame_setup kernel reads an input row of float32 [>= 4] on {dev}, "
                         f"got {inp.dtype} {tuple(inp.shape)} on {inp.device}")
    inp = inp.contiguous()                  # held until the launch
    p.input = inp.data_ptr()
    p.leaf_min = operand("frame_setup", "leaf_min", leaf_min, f32, (leaves, 3), dev)
    p.leaf_max = operand("frame_setup", "leaf_max", leaf_max, f32, (leaves, 3), dev)
    out = FrameSetup(
        ids=torch.empty(n_chunks, dtype=i32, device=dev),
        cursor=torch.empty((), dtype=i32, device=dev),
        frame=torch.empty((), dtype=i32, device=dev),
        center=torch.empty(3, dtype=f32, device=dev),
        key=torch.empty(2, dtype=i64, device=dev),
        rkey=None, jkey=None, tkey=None,
        seed=torch.empty(1, dtype=i32, device=dev))
    keys = torch.empty((3, 2), dtype=i64, device=dev)   # rkey, jkey, tkey
    if sort and n_chunks > MAX_SORT:
        codes = torch.empty(2 * n_chunks, dtype=i32, device=dev)   # held until the launch
        p.codes = codes.data_ptr()
    p.ids, p.cursor_out, p.frame_out, p.center_out, p.key_out, p.seed_out = (
        t.data_ptr() for t in (out.ids, out.cursor, out.frame, out.center, out.key, out.seed))
    p.keys_out = keys.data_ptr()
    p.total, p.n, p.sort, p.leaves = total, n_chunks, int(sort), leaves
    p.chunks_x = grid.chunks_x
    p.seed_min, p.seed_span, p.seed_mult = SEED_RANGE
    p.step = float(np.float32(cfg.camera.move_speed / cfg.screen.fps))
    p.half_x, p.half_y, p.half_z = (float(np.float32(h)) for h in cfg.camera.player_half_extent)
    with torch.cuda.device(dev):            # the launch goes to this device's stream
        kernels.launch("frame_setup", ctypes.addressof(p))
    merges = merge_passes(n_chunks, sort)
    if merges:                              # launched by the same C entry
        kernels.count("frame_setup_merge", merges)
    return out._replace(rkey=keys[0], jkey=keys[1], tkey=keys[2])


# tracer_seed's randint bounds and fold, as the kernel takes them (the span
# and multiplier are uint32 values in int32 fields; both are < 2^31 here).
SEED_RANGE = (0, *prng.randint_fold(0, INT32_MAX))


def frame_setup(scene: DeviceScene, cfg: EngineConfig, state: EngineState, inp: torch.Tensor,
                n_chunks: int, grid: ScreenConfig) -> FrameSetup:
    """Steps 1 and 2 of a frame and its keys: pop the window of ``n_chunks``
    ids of ``grid`` (Morton-sorted with ``sort_chunk_window``), move the
    camera by the input row's WASD keys and revert the move where the
    player's box hits one of ``scene``'s leaf boxes, and draw the frame's
    keys (rotation_update's split, fold_in of the frame number, the camera's
    split, the fused tracer's seed). On a CUDA state one launch of the
    ``frame_setup`` kernel; on the CPU the plain version; any other device
    raises."""
    if not on_card(state.cam_center, "frame_setup"):
        return frame_setup_plain(scene, cfg, state, inp, n_chunks, grid)
    return frame_setup_kernel(scene, cfg, state, inp, n_chunks, grid)


def display(state: EngineState, cfg: EngineConfig) -> torch.Tensor:
    """The uint8 display frame [H, W, 3] of a state's screen (the span
    ``step.display``)."""
    with span("step.display"):
        return to_display(cm_to_spatial(state.screen, cfg.screen))


def _body(scene, cfg, nearest_fn):
    """The step body bound to a scene: (state, input row, rotate) -> state."""
    n_chunks = cfg.screen.effective_chunks_per_frame
    return lambda state, inp, rotate: _advance(scene, cfg, n_chunks, state, inp, rotate,
                                               nearest_fn)


def _runner(scene, cfg, max_depth, max_leaf) -> StepRunner:
    return StepRunner(_body(scene, cfg, scene_nearest_fn(scene, cfg, max_depth, max_leaf)),
                      graphs=cfg.intersector in GRAPH_INTERSECTORS)


def run_frames(runner: StepRunner, state, frames: Sequence[FrameInputs]):
    """The state after ``frames`` stepped by ``runner`` (one upload of the
    inputs to the device of the state's first tensor)."""
    first = state.screen if isinstance(state.screen, torch.Tensor) else state.screen[0]
    return runner(state, upload_inputs(frames, first.device), graph_kinds(frames))


def make_step(
    scene: DeviceScene, cfg: EngineConfig, max_depth: int | None = None,
    max_leaf: int | None = None,
) -> Callable[[EngineState, FrameInputs], tuple[EngineState, torch.Tensor]]:
    """The frame step bound to a scene: (state, inputs) -> (state, uint8
    display frame [H, W, 3] on the state's device); the JAX package's jitted
    step with the state donated. On a CUDA state the frame is one replay of
    a captured graph; the state and frame handed back are the caller's,
    never written again. The
    bvh traversal bounds default to those of the scene's BVH
    (derive_traversal_bounds). ``step.runner`` is the StepRunner. A call
    is the span ``step.call``."""
    runner = _runner(scene, cfg, max_depth, max_leaf)

    def step(state: EngineState, inputs: FrameInputs):
        with span("step.call"):
            state = run_frames(runner, state, [inputs])
            return state, display(state, cfg)

    step.runner = runner
    return step


def make_step_fn(cfg: EngineConfig, max_depth: int | None = None,
                 max_leaf: int | None = None):
    """The frame step with the scene an argument: ``step(scene, state,
    inputs) -> (state, frame)``, eager on every device, for scenes that
    change between frames (moved spheres: parallel/multiplayer.py). The jnp
    backend, if any, is made for the scene of each call; pass the bvh
    traversal bounds (``derive_traversal_bounds``) to keep that free of host
    fetches."""
    n_chunks = cfg.screen.effective_chunks_per_frame

    def step(scene: DeviceScene, state: EngineState, inputs: FrameInputs):
        nearest_fn = scene_nearest_fn(scene, cfg, max_depth, max_leaf)
        rows = upload_inputs([inputs], state.screen.device)
        state = _advance(scene, cfg, n_chunks, state, rows[0], inputs.rot_updated, nearest_fn)
        return state, display(state, cfg)

    return step


def make_scan_step_fn(cfg: EngineConfig, n_frames: int, max_depth: int | None = None,
                      max_leaf: int | None = None):
    """``n_frames`` frames per call with the scene an argument: ``run(scene,
    state, inputs) -> (final state, last display frame)``, the JAX package's
    unjitted ``make_scan_step_fn``: an eager loop of the step body on every
    device (its scan), only the final frame's display built. ``inputs`` as
    for ``make_scan_step``; it must hold ``n_frames`` frames."""
    n_chunks = cfg.screen.effective_chunks_per_frame

    def run(scene: DeviceScene, state: EngineState, inputs):
        frames = frame_inputs(inputs)
        if len(frames) != n_frames:
            raise ValueError(f"a scan of {n_frames} frames was given {len(frames)}")
        nearest_fn = scene_nearest_fn(scene, cfg, max_depth, max_leaf)
        rows = upload_inputs(frames, state.screen.device)
        for i, rotate in enumerate(graph_kinds(frames)):
            state = _advance(scene, cfg, n_chunks, state, rows[i], rotate, nearest_fn)
        return state, display(state, cfg)

    return run


def advance_to_scatter(scene, cfg, n_chunks, state: EngineState, inp: torch.Tensor,
                       rotate: bool, grid=None, row0: int = 0,
                       nearest_fn=None) -> EngineState:
    """Steps 1-4 of a frame: the new state with the refreshed chunks written
    into the screen and the present still to come. ``inp`` is the frame's
    input row [INPUT_WIDTH] on the state's device, ``rotate`` its
    ``rot_updated``.

    ``grid`` is the ScreenConfig of the chunk grid the queue addresses
    (None = ``cfg.screen``) and ``row0`` the pixel row of the whole screen at
    which that grid starts: the row-band engine (parallel/shard.py) steps
    each band with its own grid and offset, while the rays are made against
    the whole screen, ``cfg.screen``. ``nearest_fn`` is the jnp backend
    (``scene_nearest_fn``), None for the fused kernel.

    On the card the glue is three kernel launches: ``frame_setup`` (steps 1
    and 2 and the keys), ``camera_rays`` (the rays) and ``resolve`` (tone
    map, mean, the screen's rows). A frame that rotates adds the yaw and the
    queue's permutation draw (``turn``), ``adaptive_refresh`` its reorder,
    the thin lens its torch ops. The rows land in the state's own screen
    only where the state is a graph runner's static buffers
    (``graph.state_owned``), else in a copy."""
    grid = cfg.screen if grid is None else grid

    # 1-2. This frame's chunk window (the pre-rotation queue), movement +
    # collision, the frame's keys.
    setup = frame_setup(scene, cfg, state, inp, n_chunks, grid)
    perm = state.perm
    if cfg.screen.adaptive_refresh:
        # Detail-first epoch order: reorders only when this pop wrapped.
        perm = adaptive_reorder(state.perm, state.cursor, setup.cursor, state.screen)

    # 3. Rotation (+ queue regeneration for the NEXT frame).
    quat, half_theta, cursor = state.quat, state.half_theta, setup.cursor
    if rotate:
        quat, half_theta, perm, cursor = turn(quat, half_theta, perm, cursor, setup.rkey,
                                              inp[4], cfg)

    # 4. Trace the popped chunks and write them as chunk-major rows.
    cam = state._replace(cam_center=setup.center, quat=quat).camera(cfg)
    light = trace_samples(scene, cam, Window(setup.ids, grid, row0), setup.jkey, setup.tkey,
                          setup.seed, cfg, nearest_fn)
    screen = resolve(light, cfg.screen.samples_per_pixel, state.screen, setup.ids,
                     in_place=state_owned())
    return EngineState(
        cam_center=setup.center, quat=quat, half_theta=half_theta, screen=screen,
        perm=perm, cursor=cursor, key=setup.key, frame=setup.frame,
    )


def advance(scene: DeviceScene, cfg: EngineConfig, state: EngineState, inp: torch.Tensor,
            rotate: bool, nearest_fn=None) -> EngineState:
    """One whole frame of the step body on ``scene``, for a body built
    around it (parallel/multiplayer.py): ``inp`` is the frame's input row
    (its first INPUT_WIDTH values are read) on the state's device, ``rotate``
    its ``rot_updated``, ``nearest_fn`` the jnp backend or None."""
    return _advance(scene, cfg, cfg.screen.effective_chunks_per_frame, state, inp, rotate,
                    nearest_fn)


def _advance(scene, cfg, n_chunks, state: EngineState, inp: torch.Tensor, rotate: bool,
             nearest_fn=None) -> EngineState:
    state = advance_to_scatter(scene, cfg, n_chunks, state, inp, rotate,
                               nearest_fn=nearest_fn)

    # 5. Present: feedback blur + quantization.
    screen = present_stage(
        state.screen, cfg.screen,
        lambda scr, quantize: present(scr, cfg.screen, quantize=quantize),
        lambda scr: feedback_blur_cm(scr, cfg.screen),
    )
    return state._replace(screen=screen)


def make_scan_step(
    scene: DeviceScene, cfg: EngineConfig, max_depth: int | None = None,
    max_leaf: int | None = None,
) -> Callable[[EngineState, Sequence[FrameInputs] | FrameInputs],
              tuple[EngineState, torch.Tensor]]:
    """Many frames per call: (state, inputs) -> (final state, last display
    frame), where ``inputs`` is a list of FrameInputs or one stacked
    FrameInputs with an [n]-leading axis (``stack_inputs``,
    ``repeat_input``); the JAX package's jitted scan with the state donated.
    On a CUDA state a call of n frames is one upload of the inputs and n
    graph replays; on the CPU an eager loop. Only the final frame's display
    is built; the state and frame handed back are the caller's.
    ``run.runner`` is the StepRunner. A call is the span ``step.call``."""
    runner = _runner(scene, cfg, max_depth, max_leaf)

    def run(state: EngineState, inputs):
        with span("step.call"):
            state = run_frames(runner, state, frame_inputs(inputs))
            return state, display(state, cfg)

    run.runner = runner
    return run


def stack_inputs(frames: Sequence[FrameInputs]) -> FrameInputs:
    """Per-frame inputs stacked into one FrameInputs with an [n]-leading
    axis, on the host: keys bool [n, 4], mouse_dx float32 [n], rot_updated
    bool [n]."""
    return FrameInputs(
        keys=np.array([tuple(f.keys) for f in frames], dtype=bool).reshape(-1, 4),
        mouse_dx=np.array([f.mouse_dx for f in frames], dtype=np.float32),
        rot_updated=np.array([f.rot_updated for f in frames], dtype=bool),
    )


def repeat_input(inp: FrameInputs, n: int) -> FrameInputs:
    """One FrameInputs repeated into an [n]-leading stack."""
    return stack_inputs([inp] * n)


def frame_inputs(inputs) -> list:
    """The per-frame FrameInputs of a list of them or of a stacked one."""
    if not isinstance(inputs, FrameInputs):
        return list(inputs)
    if np.ndim(inputs.mouse_dx) != 1:
        raise TypeError("a multi-frame step takes a list of FrameInputs or one stacked "
                        "with an [n]-leading axis (stack_inputs, repeat_input)")
    keys = np.asarray(inputs.keys, dtype=bool)
    return [FrameInputs(keys=tuple(bool(k) for k in keys[i]), mouse_dx=float(dx),
                        rot_updated=bool(r))
            for i, (dx, r) in enumerate(zip(np.asarray(inputs.mouse_dx, np.float32),
                                            np.asarray(inputs.rot_updated, bool)))]
