"""The BVH walk kernel's work a launch, whatever implements it: 30 float32
operations a slab test (two an interior node visited) and 16 a primitive
test (two 3-term dots, the division, the hit point, the two edge
coordinates, the compares), or its bytes: the node and leaf tables
(``render/intersect.py bvh_tables``: 14 floats a node, 15 a leaf slot of the
tree's widest leaf) once, each walked ray's origin and direction read and
its t and index written, and after the first segment its id read from the
live list.

``work`` counts them a segment on a sample of a traced run's rays with the
reference route ``segments`` (``segment_sample.py``): the first segment
walks every ray of the frame, each later one the rays alive there.
"""

from __future__ import annotations

from . import FP32_OPS_PER_S, HBM_BYTES_PER_S
from .segment_sample import per_launch, sample

SLAB_OPS, PRIM_OPS = 30, 16
RAY_BYTES = 24 + 8          # origin and direction in, t and index out
LISTED_BYTES = 4            # a listed ray's id


def table_bytes(scene) -> int:
    """The walk's tables: 14 floats a node, 15 a slot of the widest leaf for
    every primitive slot."""
    widest = int(scene.count.max())
    return (scene.count.shape[0] * 14 + scene.prim.shape[0] * 15 * widest) * 4


def work(rec: dict, reference) -> dict:
    """The walk's bound a launch (a frame's mean over its segments)."""
    s = sample(rec, reference)
    st, scale = s["stats"], s["scale"]
    tables = table_bytes(reference.scene)
    bounds, ops, n_bytes = [], [], []
    for i, alive in enumerate(st["alive"]):
        o = (SLAB_OPS * st["slab_tests"][i] + PRIM_OPS * st["prim_tests"][i]) * scale
        b = tables + alive * scale * (RAY_BYTES + (LISTED_BYTES if i else 0))
        ops.append(o)
        n_bytes.append(b)
        bounds.append((o / FP32_OPS_PER_S * 1e3, b / HBM_BYTES_PER_S * 1e3))
    bound, by = per_launch(bounds)
    return dict(ops=sum(ops) / len(ops), bytes=sum(n_bytes) / len(n_bytes), bound_ms=bound,
                bound_by=by, segments=len(bounds), frames=s["frames"],
                sampled_rays=s["sampled_rays"], stats=st)
