"""Counter-based threefry2x32 keys, bit-exact with ``jax.random``.

The engine state carries a PRNG key and the main path draws from it in
three places (ray jitter, the chunk permutation, the tracer kernel's
seed); the jnp tracer draws per bounce (``normal`` for the diffuse
scatter, ``uniform`` for glass). A frame-level comparison with the JAX
reference needs the same numbers, so this is JAX's threefry2x32 PRNG as JAX
runs it with ``jax_threefry_partitionable=True`` (split and random bits
count with a 64-bit iota over the output shape; 32-bit draws are ``bits1 ^
bits2``).

A key is an int64 tensor whose last axis holds two uint32 words. Counts are
limited to < 2^32 words per draw (the high count word is then zero).

``split``, ``fold_in``, ``random_bits``, ``uniform``, ``normal`` and
``erf_inv`` launch the hand-written CUDA kernel (csrc/threefry.cu: one
launch a draw, one thread an output element) on a CUDA tensor, run their
plain version (``*_plain``) on a CPU tensor and raise on any other device.
The plain versions are int64 elementwise torch ops with ``& 0xFFFFFFFF``
masks, which the kernel matches bit for bit. A launch counts in
``kernels.launches`` as ``threefry`` (split, fold_in, random_bits),
``threefry_uniform``, ``threefry_normal``, ``threefry_normal_listed`` or
``threefry_erf_inv``. ``normal(key, shape, rows=(ids, count))`` draws only
the rows of a live-id list (the rays alive in a segment of render/tracer.py):
on the card the other rows are left unwritten, on the CPU every row is drawn.
``randint`` and ``permutation`` draw through ``split`` and ``random_bits``
and keep their own arithmetic (the modulo fold, the stable sort) in torch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..device import check_live_list, constant, on_card
from .vecmath import sqrt

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of count words (x0, x1) under key
    words (k1, k2); int64 tensors (broadcastable) holding uint32 values. The
    plain versions' hash, on any device."""
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


def _counts_ok(n: int) -> None:
    if n > MASK:
        raise ValueError(f"at most 2^32 - 1 words per draw, got {n}")


def _counts(n: int, device) -> torch.Tensor:
    _counts_ok(n)
    return torch.arange(n, dtype=torch.int64, device=device)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """The plain version of ``split``."""
    b1, b2 = threefry2x32(key[0], key[1], 0, _counts(num, key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """The plain version of ``fold_in``."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data & MASK)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits_plain(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The plain version of ``random_bits``."""
    n = math.prod(shape)
    batch = tuple(key.shape[:-1])
    k1, k2 = key[..., 0, None], key[..., 1, None]
    b1, b2 = threefry2x32(k1, k2, 0, _counts(n, key.device))
    return (b1 ^ b2).reshape(batch + tuple(shape))


def uniform_plain(key: torch.Tensor, shape: tuple, minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    """The plain version of ``uniform``."""
    bits = random_bits_plain(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = constant(float(minval), torch.float32, key.device)
    hi = constant(float(maxval), torch.float32, key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# The kernel's counter sources and outputs (csrc/threefry.cu), and the
# launch counter of each output: the key and bit draws count as "threefry".
_IOTA, _DATA32, _DATA64, _VALUES = range(4)
_PAIR, _XOR, _UNIFORM, _NORMAL, _ERFINV = range(5)
_COUNT_AS = {_UNIFORM: "threefry_uniform", _NORMAL: "threefry_normal",
             _ERFINV: "threefry_erf_inv"}
LISTED_AS = "threefry_normal_listed"   # a normal draw at the rows of a live-id list
# Elements a row of a listed draw (csrc/threefry.cu ROW): normal triples.
ROW = 3


class Draw(NamedTuple):
    """One launch of the threefry kernel as the wrapper hands it to the C
    entry: element e of ``total`` hashes key ``keys[m * key_stride]`` with
    count word c, where (source IOTA) m = e // per_key, c = e % per_key, or
    (DATA) m = e, c = ``data[e * data_stride]`` (``data_imm`` where ``data``
    is None); source VALUES feeds ``data`` to erf_inv. The output is a new
    ``dtype`` tensor of ``shape``. With a live-id list (``ids`` int32 [R],
    ``count`` int32 [1], both on the device) a normal draw of R rows of
    ``ROW`` elements computes element e' < ROW * count as the full draw's
    element ROW * ids[e' // ROW] + e' % ROW, and no other."""
    keys: torch.Tensor | None        # int64 [M, 2]
    key_stride: int
    source: int
    output: int
    data: torch.Tensor | None        # flat int32 / int64 words, or float32 values
    data_stride: int
    data_imm: int
    per_key: int
    total: int
    lo: float
    hi: float
    shape: tuple
    dtype: torch.dtype
    ids: torch.Tensor | None = None      # int32 [R]: the rows drawn, or None: every row
    count: torch.Tensor | None = None    # int32 [1]: how many of ``ids``


def _check_key(key: torch.Tensor) -> None:
    if key.dtype != torch.int64 or key.ndim < 1 or key.shape[-1] != 2:
        raise ValueError(f"prng draws take int64 keys [..., 2], got {key.dtype} "
                         f"{tuple(key.shape)}")


def _flat(t: torch.Tensor, shape: tuple, width: tuple = ()) -> tuple:
    """(t as a flat contiguous operand, stride): stride 0 for one element,
    else t broadcast to ``shape`` (+ ``width``)."""
    n = math.prod(t.shape[:t.ndim - len(width)])
    if n == 1:
        return t.reshape((1,) + width), 0
    return t.expand(tuple(shape) + width).reshape((-1,) + width), 1


def split_draw(key: torch.Tensor, num: int) -> Draw:
    """The launch ``split(key, num)`` makes."""
    _check_key(key)
    if key.shape != (2,):
        raise ValueError(f"prng.split takes one key [2], got {tuple(key.shape)}")
    _counts_ok(num)
    return Draw(key.reshape(1, 2), 0, _IOTA, _PAIR, None, 0, 0, num, num, 0.0, 0.0,
                (num, 2), torch.int64)


def fold_in_draw(key: torch.Tensor, data) -> Draw:
    """The launch ``fold_in(key, data)`` makes: keys and data broadcast, one
    of them by stride 0 where it is a single key or word; an int is one word
    for every key."""
    _check_key(key)
    shape = tuple(key.shape[:-1])
    words, data_stride, word, source = None, 0, 0, _DATA32
    if isinstance(data, torch.Tensor):
        data = data.to(key.device)
        if data.dtype not in (torch.int32, torch.int64):
            data = data.to(torch.int64)
        shape = tuple(torch.broadcast_shapes(shape, tuple(data.shape)))
        words, data_stride = _flat(data, shape)
        source = _DATA32 if data.dtype == torch.int32 else _DATA64
    else:
        word = int(data) & MASK
    keys, key_stride = _flat(key, shape, (2,))
    return Draw(keys, key_stride, source, _PAIR, words, data_stride, word, 1, math.prod(shape),
                0.0, 0.0, shape + (2,), torch.int64)


def bits_draw(key: torch.Tensor, shape: tuple, output: int = _XOR, lo: float = 0.0,
              hi: float = 1.0) -> Draw:
    """The launch ``random_bits`` (``output`` XOR), ``uniform`` (UNIFORM on
    [lo, hi)) or ``normal`` (NORMAL) makes: ``per_key`` counts for each key of
    the batch."""
    _check_key(key)
    n = math.prod(shape)
    _counts_ok(n)
    batch = tuple(key.shape[:-1])
    return Draw(key.reshape(-1, 2), 1, _IOTA, output, None, 0, 0, n, math.prod(batch) * n,
                float(lo), float(hi), batch + tuple(shape),
                torch.int64 if output == _XOR else torch.float32)


def erf_inv_draw(x: torch.Tensor) -> Draw:
    """The launch ``erf_inv(x)`` makes (no hash: the values go in)."""
    if x.dtype != torch.float32:
        raise ValueError(f"prng.erf_inv takes float32 on the card, got {x.dtype}")
    return Draw(None, 0, _VALUES, _ERFINV, x.reshape(-1), 1, 0, 1, x.numel(), 0.0, 0.0,
                tuple(x.shape), torch.float32)


def listed(d: Draw, rows: tuple) -> Draw:
    """The launch ``d`` makes, drawn only at the rows of the live-id list
    ``rows = (ids, count)``: ``d`` is a normal draw whose output's leading
    dimension R holds rows of ``ROW`` elements (one key and shape (R, 3), or
    keys [R, 2] and shape (3,)), ``ids`` int32 [R] and ``count`` int32 [1] on
    the keys' device. Raises on any other draw or list."""
    n_rows = d.shape[0] if d.shape else 0
    if d.source != _IOTA or d.output != _NORMAL or d.total != ROW * n_rows:
        raise ValueError(f"a listed draw takes normal rows of {ROW}, got a draw of shape "
                         f"{d.shape}, source {d.source}, output {d.output}")
    check_live_list(*rows, n_rows, d.keys.device)
    return d._replace(ids=rows[0], count=rows[1])


def launch_draw(d: Draw) -> torch.Tensor:
    """Run one draw on the card: a new output tensor, one counted launch of
    the threefry kernel (none for an empty draw)."""
    operand = d.keys if d.keys is not None else d.data
    out = torch.empty(d.shape, dtype=d.dtype, device=operand.device)
    if d.total:
        keys = d.keys.contiguous() if d.keys is not None else None
        data = d.data.contiguous() if d.data is not None else None
        args = (keys.data_ptr() if keys is not None else None, d.key_stride, d.source, d.output,
                data.data_ptr() if data is not None else None, d.data_stride, d.data_imm,
                d.per_key, d.total, d.lo, d.hi, out.data_ptr())
        with torch.cuda.device(operand.device):   # the launch goes to this device's stream
            if d.ids is None:
                kernels.launch("threefry", *args, count_as=_COUNT_AS.get(d.output))
            else:
                kernels.launch("threefry", *args, d.ids.data_ptr(), d.count.data_ptr(),
                               symbol="mm_threefry_rows", count_as=LISTED_AS)
    return out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2]."""
    if not on_card(key, "prng.split"):
        return split_plain(key, num)
    return launch_draw(split_draw(key, num))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``. ``key`` is one key [2] or a batch
    [..., 2]; ``data`` an int or a tensor that broadcasts against the keys'
    batch shape (the reference's ``vmap`` of fold_in over keys and data)."""
    if not on_card(key, "prng.fold_in"):
        return fold_in_plain(key, data)
    return launch_draw(fold_in_draw(key, data))


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32): shape ``shape``
    for one key [2], ``batch + shape`` for keys [*batch, 2] (each key's
    draw, the reference's ``vmap`` over keys)."""
    if not on_card(key, "prng.random_bits"):
        return random_bits_plain(key, shape)
    return launch_draw(bits_draw(key, shape))


def uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0, minus one, scaled into [minval, maxval). Keys as in
    ``random_bits``."""
    if not on_card(key, "prng.uniform"):
        return uniform_plain(key, shape, minval, maxval)
    return launch_draw(bits_draw(key, shape, _UNIFORM, minval, maxval))


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


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of ``erf_inv``."""
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


def normal_plain(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The plain version of ``normal``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return erf_inv_plain(uniform_plain(key, shape, lo, 1.0)) * _SQRT2


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` in float32 as XLA lowers it (Giles), for |x| <= 1."""
    if not on_card(x, "prng.erf_inv"):
        return erf_inv_plain(x)
    return launch_draw(erf_inv_draw(x))


# erf_inv's FMA steps (csrc/threefry.cu STEPS): _log_f32's 10, log1p's
# rational 11, Giles' two polynomials' 8 each.
ERF_INV_STEPS = 37
# The float32 patterns of [-1, 1], both zeros included: [+0, 1] and [-0, -1].
ERF_INV_RANGES = ((0x00000000, 0x3F800001), (0x80000000, 0xBF800001))


def erf_inv_steps(first: int, count: int, stride: int = 1, device=None) -> torch.Tensor:
    """The threefry kernel's check of its erf_inv routes on the card (one
    launch of csrc/threefry.cu ``mm_erf_inv_steps``): for the float32 bit
    patterns ``first + e * stride``, e < ``count``, erf_inv on the float64
    route with each step's native fmaf compared on the same operands. Returns
    int64 [ERF_INV_STEPS + 1]: the patterns at which step s's native fmaf
    differs from ``fma``, then those at which the outputs' all-native route
    differs from the float64 route. It names the step to look at where the
    whole-output check (``erf_inv`` against ``erf_inv_plain``) fails. A
    check of the kernel's own arithmetic, so it has no plain version: it
    raises off the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"prng.erf_inv_steps checks the kernel on a CUDA device, got {dev}")
    if count < 0 or not 0 <= first <= MASK or (count and first + (count - 1) * stride > MASK):
        raise ValueError(f"patterns {first:#x} + e * {stride}, e < {count}, leave 32 bits")
    counts = torch.zeros(ERF_INV_STEPS + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("threefry", first, stride, count, counts.data_ptr(),
                       symbol="mm_erf_inv_steps", count_as="threefry_steps")
    return counts


def normal(key: torch.Tensor, shape: tuple, rows: tuple | None = None) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erf_inv(u), u uniform on
    [nextafter(-1, 0), 1). Keys as in ``random_bits``. With ``rows = (ids,
    count)``, a live-id list over the output's leading dimension R (rows of
    ``ROW``; see ``listed``), the card draws only the rows ``ids[:count]``,
    each bitwise the full draw's row, and leaves the others unwritten; the
    CPU draws every row."""
    if not on_card(key, "prng.normal"):
        if rows is not None:
            listed(bits_draw(key, shape, _NORMAL), rows)     # the same checks as the card's
        return normal_plain(key, shape)
    d = bits_draw(key, shape, _NORMAL)
    return launch_draw(d if rows is None else listed(d, rows))


def randint_fold(minval: int, maxval: int) -> tuple:
    """``randint``'s (span, multiplier) for static bounds inside the int32
    range: the draw is (minval + ((higher % span) * multiplier mod 2^32 +
    lower % span) mod 2^32 % span)."""
    if not -(2 ** 31) <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError("randint bounds must lie within int32")
    span = (maxval - minval) & MASK if maxval > minval else 1
    multiplier = (2 ** 16) % span
    return span, ((multiplier * multiplier) & MASK) % span


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32 for static bounds inside the int32
    range: two 32-bit draws folded modulo the span, with every uint32
    product wrapping as JAX's does."""
    span, multiplier = randint_fold(minval, maxval)
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    offset = (((higher % span) * multiplier) & MASK) + (lower % span)
    offset = (offset & MASK) % span
    return (minval + offset).to(torch.int32)


def permutation_rounds(n: int) -> int:
    """The sort rounds of ``permutation(key, n)``: ceil(3 ln n / ln(2^32 - 1)),
    each a ``split`` and a ``random_bits``."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``permutation_rounds(n)`` rounds
    of a STABLE sort by fresh 32-bit keys (int64 result)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(permutation_rounds(n)):
        key, subkey = split(key)
        order = torch.argsort(random_bits(subkey, (n,)), stable=True)
        x = x[order]
    return x
