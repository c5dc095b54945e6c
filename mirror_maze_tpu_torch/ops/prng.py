"""Counter-based threefry2x32 keys, bit-exact with ``jax.random``.

The engine state carries a PRNG key and the main path draws from it in
three places (ray jitter, the chunk permutation, the tracer kernel's
seed). A frame-level comparison with the JAX reference needs the same
numbers, so this is JAX's threefry2x32 PRNG as JAX runs it with
``jax_threefry_partitionable=True`` (split and random bits count with a
64-bit iota over the output shape; 32-bit draws are ``bits1 ^ bits2``).

A key is an int64 tensor whose last axis holds two uint32 words. All
arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks, so it works on any
device and needs no unsigned tensor ops. Counts are limited to < 2^32
words per draw (the high count word is then zero).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of count words (x0, x1) under key
    words (k1, k2); int64 tensors (broadcastable) holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^32: words (0, seed)."""
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64, device=device)


def _counts(n: int, device) -> torch.Tensor:
    if n > MASK:
        raise ValueError(f"at most 2^32 - 1 words per draw, got {n}")
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2]."""
    b1, b2 = threefry2x32(key[0], key[1], 0, _counts(num, key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a scalar (int or 0-d tensor)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    b1, b2 = threefry2x32(key[0], key[1], 0, data & MASK)
    return torch.stack([b1, b2]).reshape(2)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element, shape ``shape`` (int64 holding uint32)."""
    n = math.prod(shape)
    b1, b2 = threefry2x32(key[0], key[1], 0, _counts(n, key.device))
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0, minus one, scaled into [minval, maxval)."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32 for static bounds inside the int32
    range: two 32-bit draws folded modulo the span, with every uint32
    product wrapping as JAX's does."""
    if not -(2 ** 31) <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError("randint bounds must lie within int32")
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = (((higher % span) * multiplier) & MASK) + (lower % span)
    offset = (offset & MASK) % span
    return (minval + offset).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ceil(3 ln n / ln(2^32 - 1))
    rounds of a STABLE sort by fresh 32-bit keys (int64 result)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, subkey = split(key)
        order = torch.argsort(random_bits(subkey, (n,)), stable=True)
        x = x[order]
    return x
