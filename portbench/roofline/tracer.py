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
"""

from __future__ import annotations

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
