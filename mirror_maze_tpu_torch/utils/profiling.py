"""Tracer diagnostics (counterpart of the JAX package's
``utils/profiling.py``, of which only ``tracer_segment_histogram`` is here;
its frame timer, profiler trace and memory statistics are not ported yet).
"""

from __future__ import annotations

import numpy as np
import torch

from ..render.fused_tracer import LANES, trace_paths_fused


def tracer_segment_histogram(scene, cfg, ori, dirs, seed: int = 7, rows_per_block: int = 8,
                             anchor=None) -> dict:
    """Per-block statistics of the fused tracer's bounce loop, from its
    diagnostics (``trace_paths_fused(..., return_block_segments=True)``): a
    block is ``rows_per_block * 128`` consecutive rays, the reference's
    program.

    Returns ``mean`` segments a block ran and ``histogram[k]``, the blocks
    that ran exactly k; ``mean_tiles`` evaluated per block and
    ``tiles_per_segment``, split into the primary segment (``tiles_seg0``),
    segments 1-2 and 3 on; and ``live_lane_frac``, the live rays entering the
    segments over block rays x segments."""
    seed_t = torch.tensor([seed], dtype=torch.int32, device=ori.device)
    _, diag = trace_paths_fused(scene, ori, dirs, seed_t, cfg.tracer, rows_per_block,
                                anchor=anchor, return_block_segments=True)
    segs, tiles, tiles0, tiles3, live = diag.cpu().numpy().astype(int)
    lanes = rows_per_block * LANES
    return {
        "mean": float(segs.mean()),
        "max_segments": cfg.tracer.max_segments,
        "histogram": np.bincount(segs, minlength=cfg.tracer.max_segments + 1).tolist(),
        "mean_tiles": float(tiles.mean()),
        "tiles_per_segment": float(tiles.sum() / max(segs.sum(), 1)),
        "tiles_seg0": float(tiles0.mean()),
        "tiles_per_segment_seg1_2": float(
            (tiles3 - tiles0).sum() / max(np.minimum(segs - 1, 2).sum(), 1)),
        "tiles_per_segment_seg3plus": float(
            (tiles - tiles3).sum() / max((segs - 3).clip(0).sum(), 1)),
        "live_lane_frac": float(live.sum() / max(segs.sum() * lanes, 1)),
    }
