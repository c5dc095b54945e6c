"""The fused tracer's work, whatever implements it: the float32 operations
that the rays of a launch need and the bytes it must move.

Operations, counted on the plain tracer's statistics of the rays: 16 a
plane test (two 3-term dots, the IEEE reciprocal and multiply, compare,
select), 16 a tested edge (two 3-term dots, the affine s, two compares), 20
a sphere test (two 3-term dots, the quadratic, the root, compares), 30 a
slab test of each walked tile on every live ray-segment, 60 a glass hit
(the dielectric stage), 40 a textured hit (the hit point 6, two edge
coordinates 12, the UV count 5, the world count with its three divisions
8, the parity 5, the selects 4). Bytes: each ray's origin and direction
read once and its light written once, float32.

``work`` counts them on a sample of a traced run's rays with the reference
route ``tracer`` (portbench/reference/tracer.py), whose scene's walked tiles
it reads.
"""

from __future__ import annotations

import numpy as np

from . import FP32_OPS_PER_S, HBM_BYTES_PER_S

TEXTURE_OPS = 40


def operations(stats: dict, walked_tiles: int) -> float:
    """The operations of the rays whose statistics are ``stats``, in a scene
    of ``walked_tiles`` tiles in multi-tile groups."""
    return (16 * (stats["plane_tests"] + stats["edge_tests"]) + 20 * stats["sphere_tests"]
            + 30 * stats["ray_segments"] * walked_tiles + 60 * stats["glass_hits"]
            + TEXTURE_OPS * stats["textured_hits"])


def bytes_moved(n_rays: int, seed_row: bool = False) -> int:
    """Origins and directions in, light out (and a seed row in), float32."""
    return n_rays * (9 + int(seed_row)) * 4


def bound_ms(ops: float, n_bytes: float) -> tuple:
    """(the least time of a launch in ms, what bounds it)."""
    by_ops, by_bytes = ops / FP32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def work(rec: dict, reference, frames: int = 4, chunks: int = 64) -> dict:
    """The tracer's bound a launch, counted on ``chunks`` chunks of each of
    ``frames`` traced frames of the run ``rec`` drawn from its seed, by
    ``reference`` (portbench/reference/check.py ``Reference`` of the run),
    and scaled to the frames' rays."""
    traced = rec["trace"]["frames"]
    script, first = rec["stepped"], len(rec["stepped"]) - traced
    rng = np.random.default_rng([rec["seed"], 0x700F])
    numbers = sorted(int(n) for n in rng.choice(np.arange(first + 1, len(script) + 1),
                                                min(frames, traced), replace=False))
    stats, sampled, total = reference.work(numbers, chunks)
    walked_tiles = sum(n for _, _, n in reference.scene.group_meta if n > 1)
    ops = operations(stats, walked_tiles) * total / sampled / len(numbers)
    n_bytes = bytes_moved(total // len(numbers))
    bound, by = bound_ms(ops, n_bytes)
    return dict(ops=ops, bytes=n_bytes, bound_ms=bound, bound_by=by, frames=numbers,
                sampled_rays=sampled, stats=stats)
