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

from typing import Callable, Sequence

import numpy as np
import torch

from ..config import EngineConfig
from ..device import constant
from ..ops import prng
from ..ops import quat as quat_ops
from ..render.accumulate import (
    cm_to_spatial,
    feedback_blur_cm,
    present_stage,
    scatter_chunk_rows,
    to_display,
)
# derive_traversal_bounds is re-exported, where the JAX package has it.
from ..render.pipeline import (  # noqa: F401
    derive_traversal_bounds,
    render_pixels,
    scene_nearest_fn,
)
from ..render.present import present
from ..render.scenebuf import DeviceScene
from ..render.scheduler import (
    adaptive_reorder,
    chunk_origin_xy,
    chunk_pixels,
    sort_window_morton,
    take_chunks,
)
from ..scene.collision import collides
from .graph import StepRunner
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
    non-blocking copy for the whole call."""
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
    """Mouse yaw update (`main.rs:828-842`, `main.rs:922-925`):
    half_theta -= dx * sensitivity, wrapped into [0, pi); the quaternion is
    re-aimed, keeping the old one if the update is not finite. On a
    successful rotation the chunk queue is regenerated and the cursor reset.
    The key is split every frame, rotation or not. ``mouse_dx`` is a
    float32 scalar on the state's device; ``rotate`` (the frame's
    ``rot_updated``) picks the body, as the reference's ``lax.cond``.

    Returns (quat, half_theta, perm, cursor, key)."""
    rkey, key = prng.split(key)
    if not rotate:
        return quat, half_theta, perm, cursor, key
    dx = mouse_dx * float(np.float32(cfg.camera.mouse_sensitivity))
    new_half = _mod(half_theta - dx, PI_F32)
    candidate = quat_ops.update_angle(quat, new_half)
    ok = torch.isfinite(candidate).all()
    quat_out = torch.where(ok, candidate, quat)
    fresh = prng.permutation(rkey, perm.shape[0]).to(torch.int32)
    perm_out = torch.where(ok, fresh, perm)
    cursor_out = torch.where(ok, torch.zeros_like(cursor), cursor)
    return quat_out, new_half, perm_out, cursor_out, key


def display(state: EngineState, cfg: EngineConfig) -> torch.Tensor:
    """The uint8 display frame [H, W, 3] of a state's screen."""
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
    (derive_traversal_bounds). ``step.runner`` is the StepRunner."""
    runner = _runner(scene, cfg, max_depth, max_leaf)

    def step(state: EngineState, inputs: FrameInputs):
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
    (``scene_nearest_fn``), None for the fused kernel."""
    grid = cfg.screen if grid is None else grid
    frame = state.frame + 1

    # 1. This frame's chunk window (the pre-rotation queue).
    ids, cursor_next = take_chunks(state.perm, state.cursor, n_chunks)
    if cfg.screen.sort_chunk_window:
        ids = sort_window_morton(ids, grid)
    perm_in = state.perm
    if cfg.screen.adaptive_refresh:
        # Detail-first epoch order: reorders only when this pop wrapped.
        perm_in = adaptive_reorder(state.perm, state.cursor, cursor_next, state.screen)

    # 2. Movement + collision.
    moved = integrate_movement(cfg, state.cam_center, state.quat, inp[:4])
    center = resolve_collision(cfg, scene, moved, state.cam_center)

    # 3. Rotation (+ queue regeneration for the NEXT frame).
    quat, half_theta, perm, cursor, key = rotation_update(
        state.quat, state.half_theta, perm_in, cursor_next, state.key,
        inp[4], rotate, cfg,
    )

    # 4. Trace the popped chunks and write them as chunk-major rows.
    fkey = prng.fold_in(key, frame)
    origins = chunk_origin_xy(ids, grid)
    if row0:
        origins = origins + constant((0, row0), torch.int32, origins.device)
    pixels = chunk_pixels(origins, grid.chunk_width)
    cam = state._replace(cam_center=center, quat=quat).camera(cfg)
    colors = render_pixels(scene, cam, pixels, fkey, cfg, nearest_fn)
    screen = scatter_chunk_rows(state.screen, ids, colors)
    return EngineState(
        cam_center=center, quat=quat, half_theta=half_theta, screen=screen,
        perm=perm, cursor=cursor, key=key, frame=frame,
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
    ``run.runner`` is the StepRunner."""
    runner = _runner(scene, cfg, max_depth, max_leaf)

    def run(state: EngineState, inputs):
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
