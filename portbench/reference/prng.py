"""jax.random's threefry2x32 (partitionable counts), as the engine draws
from it: on Python ints for the key chain of a frame, and on int64 torch
tensors for the draws over many elements (the jitter, the chunk queue's
permutation). Written from the Threefry-2x32 specification and JAX's
``random_bits`` / ``uniform`` / ``randint`` / ``permutation``; no code of
the program.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
INT32_MAX = 2 ** 31 - 1


def threefry(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds, of counts (x0, x1) under key (k1, k2): on
    Python ints or on int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


# --- keys as pairs of Python ints -----------------------------------------

def key_of(seed: int) -> tuple:
    return (seed >> 32, seed & MASK)


def split(key: tuple, num: int = 2) -> list:
    return [threefry(key[0], key[1], 0, i) for i in range(num)]


def fold_in(key: tuple, data: int) -> tuple:
    return threefry(key[0], key[1], 0, data & MASK)


def bits_at(key: tuple, i: int) -> int:
    """Element i of a draw of 32-bit words (``random_bits``)."""
    b1, b2 = threefry(key[0], key[1], 0, i)
    return b1 ^ b2


def randint_scalar(key: tuple, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` for int32 bounds."""
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    k1, k2 = split(key)
    higher, lower = bits_at(k1, 0), bits_at(k2, 0)
    offset = ((((higher % span) * mult) & MASK) + (lower % span)) & MASK
    return minval + offset % span


def tracer_seed(tkey: tuple) -> int:
    """The fused tracer's seed of a frame: randint(tkey, (), 0, 2^31 - 1)."""
    return randint_scalar(tkey, 0, INT32_MAX)


# --- draws over many elements, on tensors ----------------------------------

def random_bits(key: tuple, index: torch.Tensor) -> torch.Tensor:
    """The 32-bit words at positions ``index`` (int64) of a draw (of fewer
    than 2^32 words) under ``key``."""
    b1, b2 = threefry(key[0], key[1], torch.zeros_like(index), index)
    return b1 ^ b2


def uniform(key: tuple, index: torch.Tensor, lo: float, hi: float, dtype) -> torch.Tensor:
    """``jax.random.uniform`` in [lo, hi) at positions ``index`` of a draw:
    the top 23 bits as a float in [1, 2), less 1, scaled and shifted, in
    float32, then rounded to ``dtype``."""
    fbits = (random_bits(key, index) >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    span = float(np.float32(hi32 - lo32))
    return torch.clamp_min(floats * span + lo32, lo32).to(dtype)


def permutation_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: tuple, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: rounds of a stable sort by fresh
    32-bit words, int64 [n]."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    index = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(permutation_rounds(n)):
        key, sub = split(key)
        x = x[torch.argsort(random_bits(sub, index), stable=True)]
    return x

