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


def feedback_blur_cm(cm: torch.Tensor, screen_cfg) -> torch.Tensor:
    """The cross blur (c + (l+r)/2 + (u+d)/2) / 3 on the chunk-major layout
    (the divisions as the reference engine computes them, see RCP3):
    inside a chunk the neighbours are yo/xo shifts, across a chunk edge the
    adjacent chunk's edge row or column, clamped at the screen edge."""
    cw = screen_cfg.chunk_width
    cy, cx = screen_cfg.chunks_y, screen_cfg.chunks_x
    t = cm.reshape(cy, cx, cw, cw, 3)   # (cy, cx, x_off, y_off, c)
    last = cw - 1
    prev_y = torch.cat([t[0:1, :, :, 0:1], t[:-1, :, :, last:]], dim=0)
    u = torch.cat([prev_y, t[:, :, :, :last]], dim=3)
    next_y = torch.cat([t[1:, :, :, 0:1], t[-1:, :, :, last:]], dim=0)
    d = torch.cat([t[:, :, :, 1:], next_y], dim=3)
    prev_x = torch.cat([t[:, 0:1, 0:1], t[:, :-1, last:]], dim=1)
    left = torch.cat([prev_x, t[:, :, :last]], dim=2)
    next_x = torch.cat([t[:, 1:, 0:1], t[:, -1:, last:]], dim=1)
    right = torch.cat([t[:, :, 1:], next_x], dim=2)
    out = (t + (left + right) * 0.5 + (u + d) * 0.5) * RCP3
    return out.reshape(cy * cx, cw * cw * 3)


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
