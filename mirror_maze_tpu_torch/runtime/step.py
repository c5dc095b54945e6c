"""The per-frame engine step (counterpart of the JAX package's
``runtime/step.py``).

One frame, in the reference's order (`main.rs:767-894`):

1. pop the next chunk window from the queue;
2. integrate WASD movement in the camera frame, revert it on collision;
3. apply the mouse yaw with the finite guard, regenerating the chunk queue
   on a successful rotation (it takes effect NEXT frame, as the reference);
4. trace the popped chunks (the fused tracer kernel) and write them into
   the screen;
5. feedback blur + 8-bit quantization (the present kernel).

Every value the frame depends on stays a device tensor, and the inputs are
host values, so a loop of steps never waits on the host until it reads a
frame.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..config import EngineConfig
from ..ops import prng
from ..ops import quat as quat_ops
from ..render.accumulate import (
    cm_to_spatial,
    feedback_blur_cm,
    present_stage,
    scatter_chunk_rows,
    to_display,
)
from ..render.pipeline import render_pixels
from ..render.present import present
from ..render.scenebuf import DeviceScene
from ..render.scheduler import (
    chunk_origin_xy,
    chunk_pixels,
    sort_window_morton,
    take_chunks,
)
from ..scene.collision import collides
from .state import EngineState, FrameInputs

PI_F32 = float(np.float32(np.pi))


def integrate_movement(
    cfg: EngineConfig, center: torch.Tensor, quat: torch.Tensor, keys
) -> torch.Tensor:
    """WASD integration (`main.rs:786-815`): per-key displacement of
    speed/fps rotated into the camera frame; A/S subtract, D/W add."""
    step = cfg.camera.move_speed / cfg.screen.fps
    f32 = dict(dtype=torch.float32, device=center.device)
    right = quat_ops.rotate(torch.tensor([step, 0.0, 0.0], **f32), quat)
    fwd = quat_ops.rotate(torch.tensor([0.0, 0.0, step], **f32), quat)
    a, s, d, w = (float(k) for k in keys)
    delta = -right * a - fwd * s + right * d + fwd * w
    return center + delta


def resolve_collision(
    cfg: EngineConfig,
    scene: DeviceScene,
    new_center: torch.Tensor,
    old_center: torch.Tensor,
) -> torch.Tensor:
    """Revert the whole move on any hit (`main.rs:817-826`)."""
    half = torch.tensor(cfg.camera.player_half_extent, dtype=torch.float32,
                        device=new_center.device)
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
    inputs: FrameInputs,
    cfg: EngineConfig,
):
    """Mouse yaw update (`main.rs:828-842`, `main.rs:922-925`):
    half_theta -= dx * sensitivity, wrapped into [0, pi); the quaternion is
    re-aimed, keeping the old one if the update is not finite. On a
    successful rotation the chunk queue is regenerated and the cursor reset.
    The key is split every frame, rotation or not.

    Returns (quat, half_theta, perm, cursor, key)."""
    rkey, key = prng.split(key)
    if not inputs.rot_updated:
        return quat, half_theta, perm, cursor, key
    dx = float(np.float32(inputs.mouse_dx) * np.float32(cfg.camera.mouse_sensitivity))
    new_half = _mod(half_theta - dx, PI_F32)
    candidate = quat_ops.update_angle(quat, new_half)
    ok = torch.isfinite(candidate).all()
    quat_out = torch.where(ok, candidate, quat)
    fresh = prng.permutation(rkey, perm.shape[0]).to(torch.int32)
    perm_out = torch.where(ok, fresh, perm)
    cursor_out = torch.where(ok, torch.zeros_like(cursor), cursor)
    return quat_out, new_half, perm_out, cursor_out, key


def make_step(
    scene: DeviceScene, cfg: EngineConfig
) -> Callable[[EngineState, FrameInputs], tuple[EngineState, torch.Tensor]]:
    """The frame step bound to a scene: (state, inputs) -> (state, uint8
    display frame [H, W, 3] on the state's device)."""
    if cfg.screen.adaptive_refresh:
        raise NotImplementedError("adaptive_refresh is not ported yet")
    n_chunks = cfg.screen.effective_chunks_per_frame

    def step(state: EngineState, inputs: FrameInputs):
        new_state = _advance(scene, cfg, n_chunks, state, inputs)
        return new_state, to_display(cm_to_spatial(new_state.screen, cfg.screen))

    return step


def _advance(scene, cfg, n_chunks, state: EngineState, inputs: FrameInputs) -> EngineState:
    frame = state.frame + 1

    # 1. This frame's chunk window (the pre-rotation queue).
    ids, cursor_next = take_chunks(state.perm, state.cursor, n_chunks)
    if cfg.screen.sort_chunk_window:
        ids = sort_window_morton(ids, cfg.screen)

    # 2. Movement + collision.
    moved = integrate_movement(cfg, state.cam_center, state.quat, inputs.keys)
    center = resolve_collision(cfg, scene, moved, state.cam_center)

    # 3. Rotation (+ queue regeneration for the NEXT frame).
    quat, half_theta, perm, cursor, key = rotation_update(
        state.quat, state.half_theta, state.perm, cursor_next, state.key,
        inputs, cfg,
    )

    # 4. Trace the popped chunks and write them as chunk-major rows.
    fkey = prng.fold_in(key, frame)
    pixels = chunk_pixels(chunk_origin_xy(ids, cfg.screen), cfg.screen.chunk_width)
    cam = state._replace(cam_center=center, quat=quat).camera(cfg)
    colors = render_pixels(scene, cam, pixels, fkey, cfg)
    screen = scatter_chunk_rows(state.screen, ids, colors)

    # 5. Present: feedback blur + quantization.
    screen = present_stage(
        screen, cfg.screen,
        lambda scr, quantize: present(scr, cfg.screen, quantize=quantize),
        lambda scr: feedback_blur_cm(scr, cfg.screen),
    )
    return EngineState(
        cam_center=center, quat=quat, half_theta=half_theta, screen=screen,
        perm=perm, cursor=cursor, key=key, frame=frame,
    )


def make_scan_step(
    scene: DeviceScene, cfg: EngineConfig
) -> Callable[[EngineState, Sequence[FrameInputs]], tuple[EngineState, torch.Tensor]]:
    """Many frames per call: (state, [inputs...]) -> (final state, last
    display frame). A plain loop of steps with no host sync inside; only
    the final frame's display is built."""
    if cfg.screen.adaptive_refresh:
        raise NotImplementedError("adaptive_refresh is not ported yet")
    n_chunks = cfg.screen.effective_chunks_per_frame

    def run(state: EngineState, inputs: Sequence[FrameInputs]):
        for inp in inputs:
            state = _advance(scene, cfg, n_chunks, state, inp)
        return state, to_display(cm_to_spatial(state.screen, cfg.screen))

    return run
