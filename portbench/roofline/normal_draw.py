"""The normal draw's work a launch (the threefry kernel's NORMAL output, one
a segment over the frame's whole wavefront): 79 int32 operations a threefry
hash (20 rounds of an add, a rotate and a xor; 17 adds of the key schedule;
2 xors of its third word), three hashes a ray, or its bytes, three float32
written a ray (12 bytes). The int32 peak: the ALU and FMA pipes' 128 lane
operations an SM and clock, x 132 SMs x 1.98 GHz (the clock of the float32
peak).

``work`` takes a frame's rays from a sample of a traced run traced by the
reference route ``segments`` (``segment_sample.py``).
"""

from __future__ import annotations

from . import HBM_BYTES_PER_S
from .segment_sample import sample

INT32_OPS_PER_S = 4 * 32 * 132 * 1.98e9
HASH_OPS = 79
RAY_BYTES = 12


def work(rec: dict, reference) -> dict:
    """The draw's bound a launch."""
    s = sample(rec, reference)
    rays = s["rays"]
    ops, n_bytes = HASH_OPS * 3 * rays, RAY_BYTES * rays
    by_ops, by_bytes = ops / INT32_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return dict(ops=ops, bytes=n_bytes, bound_ms=max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes", rays=rays,
                frames=s["frames"])
