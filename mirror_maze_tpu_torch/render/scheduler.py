"""Progressive pixel-chunk scheduler, device-resident (counterpart of the
JAX package's ``render/scheduler.py``; the reference's `main.rs:293-326`).

The queue is a permutation of chunk ids plus a cursor; each frame pops the
next window, wrapping over the end exactly like the reference's mid-frame
refill. The cursor stays a device tensor and the window is a gather, so a
frame never waits on the host.
"""

from __future__ import annotations

import torch

from ..config import ScreenConfig
from ..ops import prng
from ..ops.morton import morton2


def init_permutation(key: torch.Tensor, cfg: ScreenConfig) -> torch.Tensor:
    """Fresh shuffled chunk-id permutation [C] int32 (gen_pixels)."""
    return prng.permutation(key, cfg.total_chunks).to(torch.int32)


def take_chunks(
    perm: torch.Tensor, cursor: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pop the next n chunk ids; returns (ids [n], new_cursor). Same ids as
    the reference's dynamic slice of the doubled permutation."""
    total = perm.shape[0]
    pos = (cursor + torch.arange(n, dtype=torch.int64, device=perm.device)) % total
    return perm[pos], (cursor + n) % total


def sort_window_morton(ids: torch.Tensor, cfg: ScreenConfig) -> torch.Tensor:
    """Reorder one popped window along a Morton curve of its chunk
    coordinates (ScreenConfig.sort_chunk_window): the same chunk set, laid
    out in compact screen regions."""
    ids64 = ids.to(torch.int64)
    code = morton2(ids64 % cfg.chunks_x, ids64 // cfg.chunks_x)
    return ids[torch.argsort(code, stable=True)]


def chunk_origin_xy(ids: torch.Tensor, cfg: ScreenConfig) -> torch.Tensor:
    """Decode chunk ids to pixel-space origins [n, 2] (x, y) int32."""
    cx = (ids % cfg.chunks_x) * cfg.chunk_width
    cy = torch.div(ids, cfg.chunks_x, rounding_mode="floor") * cfg.chunk_width
    return torch.stack([cx, cy], dim=-1).to(torch.int32)


def chunk_pixels(origins_xy: torch.Tensor, chunk_width: int) -> torch.Tensor:
    """Expand chunk origins [G, 2] to pixel coords [G*cw*cw, 2]; inside a
    chunk the x offset is slow and the y offset fast, as the reference's
    thread->pixel map (`shaders.metal:271-275`)."""
    g = origins_xy.shape[0]
    pn = torch.arange(chunk_width * chunk_width, dtype=torch.int32,
                      device=origins_xy.device)
    off = torch.stack([pn // chunk_width, pn % chunk_width], dim=-1)
    pix = origins_xy[:, None, :] + off[None, :, :]
    return pix.reshape(g * chunk_width * chunk_width, 2)
