"""Screen accumulation, feedback blur and 8-bit quantization (counterpart of
the JAX package's ``render/accumulate.py``).

The persistent screen is CHUNK-MAJOR, [C, cw*cw*3]: row c is the chunk with
scheduler id c in chunk_pixels order (x offset slow, y offset fast, then
rgb). Each frame writes its refreshed chunks as whole rows; the feedback
blur (`shaders.metal:214-225`) and the RGBA8 quantization run on that
layout directly; the spatial [H, W, 3] view is built only for display.
Screen edges clamp (the reference reads out of bounds there).
"""

from __future__ import annotations

import numpy as np
import torch


def scatter_chunk_rows(
    screen_cm: torch.Tensor,    # [C, cw*cw*3] float32 chunk-major screen
    chunk_ids: torch.Tensor,    # [K] scheduler chunk ids (distinct)
    colors: torch.Tensor,       # [K*cw*cw, 3] float32 in chunk_pixels order
) -> torch.Tensor:
    """Write one frame's refreshed chunks as whole rows (a new tensor)."""
    k = chunk_ids.shape[0]
    return screen_cm.index_copy(0, chunk_ids.to(torch.int64), colors.reshape(k, -1))


def scatter_chunks(
    screen: torch.Tensor,       # [H, W, 3] float32 spatial screen
    pixel_xy: torch.Tensor,     # [K, 2] int (x, y), distinct
    colors: torch.Tensor,       # [K, 3] float32
) -> torch.Tensor:
    """Write traced pixels into a SPATIAL screen (the kernel's texout.write,
    `shaders.metal:366`). Indices are those of jnp's ``.at[y, x]``: a
    negative one counts from the end, and a pixel still outside the screen
    is dropped (``mode="drop"``). A new tensor. The engine writes
    chunk-major rows instead (``scatter_chunk_rows``); this is for offline
    use."""
    h, w, _ = screen.shape
    x, y = pixel_xy[:, 0].to(torch.int64), pixel_xy[:, 1].to(torch.int64)
    x, y = torch.where(x < 0, x + w, x), torch.where(y < 0, y + h, y)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    # Dropped pixels go to one spare row past the end.
    flat = torch.where(inside, y * w + x, h * w)
    out = torch.cat([screen.reshape(h * w, 3), screen.new_zeros((1, 3))])
    out = out.index_copy(0, flat, colors.to(screen.dtype))
    return out[:h * w].reshape(h, w, 3)


def spatial_to_cm(sp: torch.Tensor, screen_cfg) -> torch.Tensor:
    """Spatial [H, W, 3] -> chunk-major [C, cw*cw*3]."""
    cw = screen_cfg.chunk_width
    t = sp.reshape(screen_cfg.chunks_y, cw, screen_cfg.chunks_x, cw, 3)
    # axes: (cy, y_off, cx, x_off, c) -> (cy, cx, x_off, y_off, c)
    return t.permute(0, 2, 3, 1, 4).reshape(screen_cfg.total_chunks, cw * cw * 3)


def cm_to_spatial(cm: torch.Tensor, screen_cfg) -> torch.Tensor:
    """Chunk-major [C, cw*cw*3] -> spatial [H, W, 3]."""
    cw = screen_cfg.chunk_width
    t = cm.reshape(screen_cfg.chunks_y, screen_cfg.chunks_x, cw, cw, 3)
    # axes: (cy, cx, x_off, y_off, c) -> (cy, y_off, cx, x_off, c)
    return t.permute(0, 3, 1, 2, 4).reshape(screen_cfg.height, screen_cfg.width, 3)


# The reference engine runs these under jit, where XLA turns a division by
# a constant into a multiply by its float32 reciprocal (on the CPU as on the
# TPU): x / 3 is computed as x * float32(1/3), which is not IEEE x / 3.
# Halving is exact either way.
RCP3 = float(np.float32(1.0 / 3.0))
RCP255 = float(np.float32(1.0 / 255.0))


def feedback_blur_cm(cm: torch.Tensor, screen_cfg, halo_top: torch.Tensor | None = None,
                     halo_bot: torch.Tensor | None = None) -> torch.Tensor:
    """The cross blur (c + (l+r)/2 + (u+d)/2) / 3 on the chunk-major layout
    (the divisions as the reference engine computes them, see RCP3):
    inside a chunk the neighbours are yo/xo shifts, across a chunk edge the
    adjacent chunk's edge row or column, clamped at the screen edge.

    With ``halo_top`` and ``halo_bot`` (pixel rows [width * 3], both or
    neither) the screen is a row band of a taller one (the JAX package's
    parallel/shard.py _blur_with_halo_cm): its top pixel row reads the row
    above from ``halo_top`` and its bottom row the row below from
    ``halo_bot``, where the single screen clamps."""
    cw = screen_cfg.chunk_width
    cy, cx = screen_cfg.chunks_y, screen_cfg.chunks_x
    t = cm.reshape(cy, cx, cw, cw, 3)   # (cy, cx, x_off, y_off, c)
    last = cw - 1
    top, bot = t[0:1, :, :, 0:1], t[-1:, :, :, last:]
    if halo_top is not None:
        top, bot = halo_top.reshape(1, cx, cw, 1, 3), halo_bot.reshape(1, cx, cw, 1, 3)
    prev_y = torch.cat([top, t[:-1, :, :, last:]], dim=0)
    u = torch.cat([prev_y, t[:, :, :, :last]], dim=3)
    next_y = torch.cat([t[1:, :, :, 0:1], bot], dim=0)
    d = torch.cat([t[:, :, :, 1:], next_y], dim=3)
    prev_x = torch.cat([t[:, 0:1, 0:1], t[:, :-1, last:]], dim=1)
    left = torch.cat([prev_x, t[:, :, :last]], dim=2)
    next_x = torch.cat([t[:, 1:, 0:1], t[:, -1:, last:]], dim=1)
    right = torch.cat([t[:, :, 1:], next_x], dim=2)
    out = (t + (left + right) * 0.5 + (u + d) * 0.5) * RCP3
    return out.reshape(cy * cx, cw * cw * 3)


def feedback_blur(screen: torch.Tensor) -> torch.Tensor:
    """The cross blur (c + (l+r)/2 + (u+d)/2) / 3 on a spatial [H, W, 3]
    screen, edges clamped (`shaders.metal:219-222`); the divisions as
    ``feedback_blur_cm``'s, which it equals on the same screen."""
    p = torch.nn.functional.pad(screen.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                mode="replicate")[0].permute(1, 2, 0)
    c, left, right = p[1:-1, 1:-1], p[1:-1, :-2], p[1:-1, 2:]
    u, d = p[:-2, 1:-1], p[2:, 1:-1]
    return (c + (left + right) * 0.5 + (u + d) * 0.5) * RCP3


def quantize_8bit(screen: torch.Tensor) -> torch.Tensor:
    """RGBA8Unorm write semantics: clamp to [0,1], round half to even to
    256 levels."""
    return torch.round(torch.clamp(screen, 0.0, 1.0) * 255.0) * RCP255


def to_display(screen: torch.Tensor) -> torch.Tensor:
    """uint8 frame for presentation/IO."""
    return torch.round(torch.clamp(screen, 0.0, 1.0) * 255.0).to(torch.uint8)


def present_stage(screen, screen_cfg, present_fn, blur_fn):
    """The present policy (`shaders.metal:214-225` + RGBA8 write semantics):
    blur through the fused present kernel if configured, else the plain
    blur + quantize; without the blur, quantize alone.
    ``present_fn(screen, quantize=bool)`` and ``blur_fn(screen)``."""
    if screen_cfg.feedback_blur:
        if screen_cfg.pallas_present:
            return present_fn(screen, quantize=screen_cfg.quantize_8bit)
        screen = blur_fn(screen)
        if screen_cfg.quantize_8bit:
            screen = quantize_8bit(screen)
        return screen
    if screen_cfg.quantize_8bit:
        return quantize_8bit(screen)
    return screen
