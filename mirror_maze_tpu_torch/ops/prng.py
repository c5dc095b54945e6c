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

from ..device import constant
from .vecmath import sqrt

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
    """``jax.random.fold_in(key, data)``. ``key`` is one key [2] or a batch
    [..., 2]; ``data`` an int or a tensor that broadcasts against the keys'
    batch shape (the reference's ``vmap`` of fold_in over keys and data)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data & MASK)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): shape ``shape``
    for one key [2], ``batch + shape`` for keys [*batch, 2] (each key's
    draw, the reference's ``vmap`` over keys)."""
    n = math.prod(shape)
    batch = tuple(key.shape[:-1])
    k1, k2 = key[..., 0, None], key[..., 1, None]
    b1, b2 = threefry2x32(k1, k2, 0, _counts(n, key.device))
    return (b1 ^ b2).reshape(batch + tuple(shape))


def uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0, minus one, scaled into [minval, maxval). Keys as in
    ``random_bits``."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = constant(float(minval), torch.float32, key.device)
    hi = constant(float(maxval), torch.float32, key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# jax.random.normal draws u uniform on [nextafter(-1, 0), 1) and returns
# sqrt(2) * erf_inv(u). XLA lowers erf_inv (f32) to Giles' two-branch
# polynomial in w = -log1p(-u^2), and XLA-CPU emits log1p as a rational
# function for |x| < sqrt(2) - 1 and as Cephes' log(1 + x) otherwise, every
# multiply feeding one add fused into an FMA. The port evaluates the same
# terms in the same order, each FMA in float64 and rounded once, so the draw
# is the same on every device.


def _f32(*values) -> tuple:
    """The float32 values of the constants, as Python floats."""
    return tuple(float(np.float32(v)) for v in values)


_ERFINV_W_LT_5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                      0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                      0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_DEN = _f32(15.062909, 83.04757, 221.7624, 309.09872, 216.42789, 60.11866)
_LOG1P_NUM = _f32(4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967, 57.112965,
                  20.039553)
_LOG_POLY = _f32(0.070376836, -0.1151461, 0.116769984, -0.12420141, 0.14249323,
                 -0.16668057, 0.20000714, -0.24999994, 0.3333333)
(_LOG1P_SMALL, _LOG_Q1, _LOG_Q2, _SQRT_HALF, _F32_MIN, _SQRT2) = _f32(
    0.41421357, -0.00021219444, 0.693359375, 0.70710677, 1.1754944e-38, np.sqrt(2.0))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product of two float32 is exact
    in float64); ``b`` and ``c`` tensors or float32 values."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 log, for x > 0: the exponent and a mantissa in
    [sqrt(1/2), sqrt(2)), Cephes' polynomial, split ln 2."""
    x = torch.clamp_min(x, _F32_MIN)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z = m * m
    x3 = z * m
    c = _LOG_POLY
    y1 = fma(fma(m, c[0], c[1]), m, c[2])
    y2 = fma(fma(m, c[3], c[4]), m, c[5])
    y3 = fma(fma(m, c[6], c[7]), m, c[8])
    y = fma(fma(y1, x3, y2), x3, y3)
    y = fma(y, x3, e * _LOG_Q1)
    return fma(e, _LOG_Q2, (m - z * 0.5) + y)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 log1p for x > -1 (denormal inputs excepted, which
    XLA flushes to zero)."""
    x2 = x * x
    den = x + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = fma(den, x, c)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, x, c)
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log_f32(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` in float32 as XLA lowers it (Giles), for |x| <= 1."""
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    coef = [torch.where(lt, constant(a, torch.float64, x.device),
                        constant(b, torch.float64, x.device))
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0].float()
    for c in coef[1:]:
        p = fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erf_inv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return erf_inv(uniform(key, shape, lo, 1.0)) * _SQRT2


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
