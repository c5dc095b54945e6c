"""The segment path's work on a sample of a traced run's rays, shared by the
rooflines of its three kernels (``bvh_walk``, ``shade``, ``normal_draw``):
the reference route ``segments`` (portbench/reference/segments.py) traces
``chunks`` chunks of each of ``frames`` traced frames drawn from the run's
seed, and its statistics, per segment, are scaled to a frame's wavefront.
"""

from __future__ import annotations

import numpy as np


def sample(rec: dict, reference, frames: int = 4, chunks: int = 64) -> dict:
    """{"stats": the route's statistics, summed over the sampled frames,
    "scale": what turns such a sum into a frame's count (a frame's rays over
    the rays sampled), "rays": a frame's rays, "frames", "sampled_rays"}
    of the run ``rec``, counted once a ``reference`` (portbench/reference/
    check.py ``Reference`` of the run) and kept on it."""
    cache = reference.__dict__.setdefault("segment_samples", {})
    if (frames, chunks) not in cache:
        traced = rec["trace"]["frames"]
        script, first = rec["stepped"], len(rec["stepped"]) - traced
        rng = np.random.default_rng([rec["seed"], 0x700F])
        numbers = sorted(int(n) for n in rng.choice(np.arange(first + 1, len(script) + 1),
                                                    min(frames, traced), replace=False))
        stats, sampled, total = reference.work(numbers, chunks)
        rays = total // len(numbers)
        cache[(frames, chunks)] = dict(stats=stats, scale=rays / sampled, rays=rays,
                                       frames=numbers, sampled_rays=sampled)
    return cache[(frames, chunks)]


def per_launch(bounds: list) -> tuple:
    """(the mean bound ms a launch, operations or bytes: whichever weighs
    more over the frame) of a kernel launched once a segment, from each
    segment's (ms by operations, ms by bytes) in ``bounds``."""
    mean = sum(max(o, b) for o, b in bounds) / len(bounds)
    by_ops = sum(o for o, _ in bounds) >= sum(b for _, b in bounds)
    return mean, "operations" if by_ops else "bytes"
