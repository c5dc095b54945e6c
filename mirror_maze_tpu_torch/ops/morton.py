"""Morton (Z-order) codes — the one bit-interleave used by the chunk-window
sort and the plane-table order (counterpart of the JAX package's
``ops/morton.py``)."""

from __future__ import annotations


def morton2(x, y):
    """Interleave two <=16-bit unsigned coordinate arrays into Morton codes.

    Works on NumPy unsigned arrays of >= 32 bits and on torch int64
    tensors (the codes are < 2^32, so no mask touches a sign bit)."""

    def spread(v):  # 16 -> 32-bit bit-interleave
        v = v & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(x) | (spread(y) << 1)
