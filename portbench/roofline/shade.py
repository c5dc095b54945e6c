"""The shade kernel's work a launch, whatever implements it: bytes. Every
ray's alive flag is read; an alive ray reads and writes its path state
(origin, direction, throughput, light, mirror hits, diffuse bounces, alive:
57 bytes) and reads its t; a hit reads its primitive's index, a diffuse
scatter its normal triple (12 bytes), and a ray that stays alive is
appended to the live list (4 bytes), but at the last segment, which keeps
no list; the scene's shading rows (normal, albedo, emission, mirror flag)
are read once. Its float32 operations (83 a ray) stay far under them.

``work`` counts them a segment on a sample of a traced run's rays with the
reference route ``segments`` (``segment_sample.py``).
"""

from __future__ import annotations

from . import HBM_BYTES_PER_S
from .segment_sample import per_launch, sample

STATE_BYTES = 4 * 3 * 4 + 2 * 4 + 1


def work(rec: dict, reference) -> dict:
    """The shade's bound a launch (a frame's mean over its segments)."""
    s = sample(rec, reference)
    st, scale, rays = s["stats"], s["scale"], s["rays"]
    n = reference.scene.normal.shape[0]
    rows = n * (3 + 3 + 4) * 4 + n
    bounds, n_bytes = [], []
    last = len(st["alive"]) - 1
    for i, alive in enumerate(st["alive"]):
        kept = st["kept"][i] if i < last else 0
        b = rows + (rays - alive * scale) + scale * (
            alive * (2 * STATE_BYTES + 4) + st["hits"][i] * 4 + st["diffuse"][i] * 12
            + kept * 4)
        n_bytes.append(b)
        bounds.append((0.0, b / HBM_BYTES_PER_S * 1e3))
    bound, by = per_launch(bounds)
    return dict(bytes=sum(n_bytes) / len(n_bytes), bound_ms=bound, bound_by=by,
                segments=len(bounds), frames=s["frames"], sampled_rays=s["sampled_rays"],
                stats=st)
