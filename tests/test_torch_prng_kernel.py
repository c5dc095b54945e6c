"""The threefry kernel's wrappers (ops/prng.py, csrc/threefry.cu) on the CPU.

On a CPU tensor every draw takes its plain version and launches nothing; on
a device that is neither CPU nor CUDA it raises. Each launch a wrapper would
make (``prng.Draw``), read here element by element as the kernel reads it,
gives the plain version's result; and the plain versions are jax.random's,
bit for bit, on key batches, broadcast fold_in data and counts around the
kernel's block edges. The kernel's two FMA routes (the float64 sum rounded;
a native fmaf, which the normal draw takes) are modelled in NumPy and held
against ``prng.fma``: the native one bitwise on every step of erf_inv for
all 2^23 uniforms a normal draw gives, both on random triples, triples
built onto float32 midpoints and the subnormal edge, where the native one
parts only where the rule for it says. The kernel itself is held against the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py ``[threefry]``).
"""

import collections
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_tools import one_torch_thread  # noqa: F401 (autouse)
from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.ops import prng

# Counts around the kernel's block of 256 threads and a large odd draw.
COUNTS = [1, 3, 1023, 1024, 1025, 2 ** 20 + 7]
# Raw keys: PRNGKey(0), PRNGKey(2^31 - 1) and one with both words above 2^31.
KEYS = [(0, 0), (0, 2 ** 31 - 1), (0x9E3779B9, 0xDEADBEEF)]
LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

# name -> (call on a key made on ``device``, its plain version)
DRAWS = {
    "split": (lambda k: prng.split(k, 5), lambda k: prng.split_plain(k, 5)),
    "fold_in": (lambda k: prng.fold_in(k, torch.arange(4, dtype=torch.int32, device=k.device)),
                lambda k: prng.fold_in_plain(k, torch.arange(4, dtype=torch.int32,
                                                             device=k.device))),
    "random_bits": (lambda k: prng.random_bits(k, (7, 3)),
                    lambda k: prng.random_bits_plain(k, (7, 3))),
    "uniform": (lambda k: prng.uniform(k, (9,), -1.0, 1.0),
                lambda k: prng.uniform_plain(k, (9,), -1.0, 1.0)),
    "normal": (lambda k: prng.normal(k, (6, 3)), lambda k: prng.normal_plain(k, (6, 3))),
    "erf_inv": (lambda k: prng.erf_inv(prng.uniform_plain(k, (33,), LO, 1.0)),
                lambda k: prng.erf_inv_plain(prng.uniform_plain(k, (33,), LO, 1.0))),
}


def _raw(words, device="cpu"):
    return torch.tensor(words, dtype=torch.int64, device=device)


def _jkey(words):
    return jnp.asarray(np.array(words, np.uint32))


def _eq(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape
    if want.dtype == np.float32:
        assert got.dtype == np.float32
        want, got = want.view(np.uint32), got.view(np.uint32)
    np.testing.assert_array_equal(want.astype(np.int64), got.astype(np.int64))


def read_as_the_kernel(d: prng.Draw) -> torch.Tensor:
    """The output of one launch, element by element as csrc/threefry.cu
    reads its operands (key m * key_stride, the count or data word), with
    the plain versions' hash and float arithmetic."""
    e = torch.arange(d.total, dtype=torch.int64)
    if d.source == prng._VALUES:
        return prng.erf_inv_plain(d.data.reshape(-1)[e * d.data_stride]).reshape(d.shape)
    if d.source == prng._IOTA:
        m, c = e // d.per_key, e % d.per_key
    else:
        m = e
        c = (torch.full_like(e, d.data_imm) if d.data is None
             else d.data.reshape(-1)[e * d.data_stride].to(torch.int64) & prng.MASK)
    keys = d.keys.reshape(-1, 2)[m * d.key_stride]
    b1, b2 = prng.threefry2x32(keys[:, 0], keys[:, 1], 0, c)
    if d.output == prng._PAIR:
        return torch.stack([b1, b2], dim=-1).reshape(d.shape)
    bits = b1 ^ b2
    if d.output == prng._XOR:
        return bits.reshape(d.shape)
    lo, hi = (d.lo, d.hi) if d.output == prng._UNIFORM else (LO, 1.0)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t, hi_t = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    u = torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)
    if d.output == prng._UNIFORM:
        return u.reshape(d.shape)
    return (prng.erf_inv_plain(u) * prng._SQRT2).reshape(d.shape)


# --- Dispatch ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_a_cpu_tensor_takes_the_plain_version(name, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor launched the kernel")

    monkeypatch.setattr(kernels, "launch", refuse)
    before = dict(kernels.launches)
    draw, plain = DRAWS[name]
    key = _raw(KEYS[2])
    _eq(plain(key), draw(key))
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_a_tensor_neither_on_the_cpu_nor_on_the_card_raises(name):
    draw, _ = DRAWS[name]
    key = _raw(KEYS[2], device="meta")
    if name == "erf_inv":
        call = lambda: prng.erf_inv(torch.zeros(8, device="meta"))
    else:
        call = lambda: draw(key)
    with pytest.raises(ValueError, match="runs on cuda or cpu tensors"):
        call()


def test_the_threefry_library_is_built_like_the_others():
    source, macros, (symbol, argtypes) = kernels.LIBRARIES["threefry"]
    assert (source, macros, symbol) == ("threefry.cu", (), "mm_threefry")
    assert len(argtypes) == 13
    assert "-fmad=false" in kernels.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in \
        kernels.NVCC_FLAGS
    text = (kernels.CSRC / source).read_text()
    assert 'extern "C" int mm_threefry(' in text and 'extern "C" int mm_erf_inv_steps(' in text
    assert kernels.ENTRIES[("threefry", "mm_erf_inv_steps")][-1] is ctypes.c_void_p
    # The native fmaf is fma_step's: the route's own, and the step check's
    # comparison. Every FMA of erf_inv is a numbered fma_step; NORMAL and
    # ERFINV take the all-native route, the check compares it with the
    # float64 one.
    assert text.count("__fmaf_rn(") == 2 and text.count("fmaf(") == 0
    step = text[text.index("float fma_step("):]
    step = step[:step.index("\n}\n")]
    assert "return __fmaf_rn(a, b, c);" in step and \
        "__double2float_rn(__fma_rn((double)a, (double)b, (double)c))" in step
    assert "enum Route { NATIVE = 0, FLOAT64 = 1 };" in text
    assert text.count("erf_inv<NATIVE>(") == 3 and "__fmul_rn(erf_inv<NATIVE>(u)" in text
    assert "= erf_inv<NATIVE>(((const float*)a.data)" in text
    assert text.count("erf_inv<FLOAT64>(") == 1
    assert kernels._lib_path("threefry").name.startswith("libthreefry-")


def test_the_wrappers_check_counts_keys_and_types():
    key = _raw(KEYS[1])
    with pytest.raises(ValueError, match="2\\^32"):
        prng.bits_draw(key, (2 ** 16, 2 ** 16))
    with pytest.raises(ValueError, match="one key"):
        prng.split_draw(key.expand(3, 2), 2)
    with pytest.raises(ValueError, match="int64 keys"):
        prng.fold_in_draw(key.to(torch.int32), 1)
    with pytest.raises(ValueError, match="float32"):
        prng.erf_inv_draw(torch.zeros(4, dtype=torch.float64))


# --- Each launch, read as the kernel reads it ---------------------------------


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.int64))


# name -> the launch a wrapper makes and the plain version's output, on
# inputs made from a seed: (one key, a batch of 12 keys, int32 data, a [3, 1]
# key grid, uniforms) -> (Draw, tensor).
CASES = {
    "split": lambda one, keys, data, grid, u: (prng.split_draw(one, 1025),
                                               prng.split_plain(one, 1025)),
    "fold_in one key, int": lambda one, keys, data, grid, u: (
        prng.fold_in_draw(one, -7), prng.fold_in_plain(one, -7)),
    "fold_in one key, int32 rows": lambda one, keys, data, grid, u: (
        prng.fold_in_draw(one, data), prng.fold_in_plain(one, data)),
    "fold_in keys, int32 rows": lambda one, keys, data, grid, u: (
        prng.fold_in_draw(keys, data), prng.fold_in_plain(keys, data)),
    "fold_in keys, int64 word": lambda one, keys, data, grid, u: (
        prng.fold_in_draw(keys, torch.tensor(2 ** 40 + 5)),
        prng.fold_in_plain(keys, torch.tensor(2 ** 40 + 5))),
    "fold_in keys, int": lambda one, keys, data, grid, u: (
        prng.fold_in_draw(keys, 3), prng.fold_in_plain(keys, 3)),
    "fold_in broadcast [3,1] x [4]": lambda one, keys, data, grid, u: (
        prng.fold_in_draw(grid, torch.arange(4, dtype=torch.int64)),
        prng.fold_in_plain(grid, torch.arange(4, dtype=torch.int64))),
    "random_bits one key": lambda one, keys, data, grid, u: (
        prng.bits_draw(one, (1023,)), prng.random_bits_plain(one, (1023,))),
    "random_bits keys": lambda one, keys, data, grid, u: (
        prng.bits_draw(keys, (3,)), prng.random_bits_plain(keys, (3,))),
    "uniform keys, one each": lambda one, keys, data, grid, u: (
        prng.bits_draw(keys, (), prng._UNIFORM, 0.25, 3.0),
        prng.uniform_plain(keys, (), 0.25, 3.0)),
    "normal keys": lambda one, keys, data, grid, u: (
        prng.bits_draw(keys, (3,), prng._NORMAL),
        prng.normal_plain(keys, (3,))),
    "erf_inv": lambda one, keys, data, grid, u: (prng.erf_inv_draw(u), prng.erf_inv_plain(u)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_launch_read_as_the_kernel_reads_it_is_the_plain_version(case):
    one = _raw(KEYS[2])
    data = torch.from_numpy(np.random.default_rng(1).integers(-2 ** 31, 2 ** 31, 12,
                                                              dtype=np.int64)).to(torch.int32)
    u = prng.uniform_plain(one, (5, 7), LO, 1.0)
    d, want = CASES[case](one, _batch(12), data, _batch(3, seed=2).reshape(3, 1, 2), u)
    assert d.shape == tuple(want.shape) and d.dtype == want.dtype
    assert d.key_stride in (0, 1) and d.data_stride in (0, 1)
    assert d.source != prng._IOTA or d.total % max(d.per_key, 1) == 0
    _eq(want, read_as_the_kernel(d))


# --- The plain versions against jax.random -----------------------------------


@pytest.mark.parametrize("n", COUNTS)
def test_plain_draws_match_jax_random_at_every_count(n):
    for words in KEYS:
        jk, pk = _jkey(words), _raw(words)
        _eq(jax.random.split(jk, n), prng.split_plain(pk, n))
        _eq(jax.random.bits(jk, (n,), jnp.uint32), prng.random_bits_plain(pk, (n,)))
        _eq(jax.random.uniform(jk, (n,), minval=-1.0, maxval=1.0),
            prng.uniform_plain(pk, (n,), -1.0, 1.0))
    if n <= 1025:
        words = KEYS[2]
        _eq(jax.random.normal(_jkey(words), (n,), jnp.float32),
            prng.normal_plain(_raw(words), (n,)))


def test_plain_normal_matches_jax_random_on_a_large_draw():
    got = prng.normal_plain(_raw(KEYS[2]), (2 ** 20 + 7,))
    _eq(jax.jit(lambda k: jax.random.normal(k, (2 ** 20 + 7,), jnp.float32))(_jkey(KEYS[2])),
        got)


def test_plain_key_batches_match_vmapped_jax_random():
    """Per-ray keys as render/tracer.py makes them: two chained fold_in over
    the rays, then fold_in of the bounce, normal triples and one uniform."""
    rng = np.random.default_rng(5)
    n = 1025
    idx = np.arange(n, dtype=np.int32)
    seeds = rng.integers(0, 2 ** 24, n, dtype=np.int64).astype(np.int32)
    jk, pk = _jkey(KEYS[2]), _raw(KEYS[2])
    jkeys = jax.vmap(lambda i, s: jax.random.fold_in(jax.random.fold_in(jk, i), s))(
        jnp.asarray(idx), jnp.asarray(seeds))
    pkeys = prng.fold_in_plain(prng.fold_in_plain(pk, torch.from_numpy(idx)),
                               torch.from_numpy(seeds))
    _eq(jkeys, pkeys)
    jit_keys = jax.vmap(lambda k: jax.random.fold_in(k, 3))(jkeys)
    pit_keys = prng.fold_in_plain(pkeys, 3)
    _eq(jit_keys, pit_keys)
    _eq(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float32)))(jit_keys),
        prng.normal_plain(pit_keys, (3,)))
    _eq(jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), ()))(jit_keys),
        prng.uniform_plain(prng.fold_in_plain(pit_keys, 1), ()))
    _eq(jax.vmap(lambda k: jax.random.bits(k, (5,), jnp.uint32))(jkeys[:7]),
        prng.random_bits_plain(pkeys[:7], (5,)))


def test_plain_fold_in_broadcasts_as_the_reference_vmaps():
    grid = _batch(3, seed=3)
    data = np.arange(4, dtype=np.int32) * 1000003
    want = jax.vmap(lambda k: jax.vmap(lambda d: jax.random.fold_in(k, d))(jnp.asarray(data)))(
        jnp.asarray(grid.numpy().astype(np.uint32)))
    _eq(want, prng.fold_in_plain(grid.reshape(3, 1, 2), torch.from_numpy(data)))


def test_plain_erf_inv_is_jax_on_every_uniform_the_draw_can_make():
    """Every float32 that ``uniform`` can give on [nextafter(-1, 0), 1) (its
    2^23 mantissas), the same array to both: sqrt(2) * erf_inv bitwise."""
    floats = (np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo = np.float32(LO)
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    assert u.dtype == np.float32 and u.min() == lo and u.max() < 1.0
    want = jax.jit(lambda x: jax.lax.erf_inv(x) * jnp.float32(np.sqrt(2.0)))(jnp.asarray(u))
    got = prng.erf_inv_plain(torch.from_numpy(u)) * prng._SQRT2
    _eq(want, got)


# --- The kernel's FMA routes (csrc/threefry.cu fma64), modelled in NumPy ----
#
# prng.fma is RN32(RN64(a * b + c)): the product of two float32 is exact in
# float64, the float64 sum is rounded, then the float32. The kernel's exact
# route (the ERFINV output, any input) rounds the float64 sum of one float64
# FMA, which is that by construction. Its native route (the NORMAL output)
# is a single-rounded fmaf, RN32(a * b + c): rounding is monotone and every
# float32 midpoint is a float64 value, so the two part only where the
# float64 sum is a float32 midpoint the exact sum missed (the fmaf then odd)
# or in float32's subnormal range. The model below computes the fmaf exactly
# (the float64 sum and its error by TwoSum); the native route is held
# bitwise against prng.fma on every step of erf_inv for every value a normal
# draw gives it (all 2^23 uniforms: the whole of its domain), and on random,
# midpoint and subnormal triples it parts only where that rule says.

F32_TINY = np.float32(2.0 ** -126)


def _round_once(s, e):
    """RN32(s + e) for float64 s and its exact error e: RN32(s) except where
    s is a float32 midpoint, which e's sign breaks (e == 0 is a tie, to even,
    as RN32(s) already is)."""
    with np.errstate(over="ignore", invalid="ignore"):
        r = s.astype(np.float32)
        r64 = np.where(np.isinf(r), np.copysign(2.0 ** 128, s), r.astype(np.float64))
        lo = np.where(r64 > s, np.nextafter(r, np.float32(-np.inf)), r)   # float32 <= s
        hi = np.nextafter(lo, np.float32(np.inf))
        lo64 = np.where(np.isinf(lo), np.copysign(2.0 ** 128, lo), lo.astype(np.float64))
        hi64 = np.where(np.isinf(hi), np.copysign(2.0 ** 128, hi), hi.astype(np.float64))
        mid = s == (lo64 + hi64) / 2
    return np.where(mid & (e > 0), hi, np.where(mid & (e < 0), lo, r)).astype(np.float32)


def exact_fmaf(a, b, c):
    """RN32(a * b + c), rounded once (finite float32 arrays): s + e is the
    exact sum (TwoSum on the exact product) and ``_round_once`` rounds it.
    Only where s may be a float32 midpoint (its low 29 bits 0x10000000, or
    outside float32's normal range) does e matter, so only there is the
    general rule run."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        s = p + c64
        r = s.astype(np.float32)
    mag = np.abs(s)
    maybe = (((s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000))
             | (mag < 2.0 ** -125) | (mag >= 2.0 ** 127))
    if maybe.any():
        ps, cs, ss = p[maybe], c64[maybe], s[maybe]
        bb = ss - ps
        e = (ps - (ss - bb)) + (cs - bb)
        r[maybe] = _round_once(ss, e)
    return r


def kernel_fma(a, b, c, exact: bool):
    """csrc/threefry.cu fma64 in NumPy: the exact route rounds the float64
    sum; the native one is the fmaf. Returns (value, where the native fmaf
    may part from prng.fma: the float64 sum a float32 midpoint with the
    fmaf odd, or a nonzero subnormal fmaf)."""
    r = exact_fmaf(a, b, c)
    with np.errstate(over="ignore"):
        y = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
        marked = ((((y.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000))
                   & (_bits(r) & 1 == 1))
                  | ((np.abs(r) <= F32_TINY) & (r != 0)))
        return (y.astype(np.float32) if exact else r), marked


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _plain_fma(a, b, c):
    return prng.fma(torch.from_numpy(a), torch.from_numpy(b).double(),
                    torch.from_numpy(c).double()).numpy()


def _check_route(a, b, c):
    """The exact route bitwise prng.fma on float32 arrays, and the native one
    wherever it is not marked; returns (where the native one parts, where it
    is marked)."""
    want = _plain_fma(a, b, c)
    got, _ = kernel_fma(a, b, c, exact=True)
    assert np.array_equal(_bits(got), _bits(want))
    native, marked = kernel_fma(a, b, c, exact=False)
    differs = _bits(native) != _bits(want)
    assert marked[differs].all()
    return int(differs.sum()), int(marked.sum())


def _random_floats(rng, n, lo_exp, hi_exp):
    m = rng.uniform(1.0, 2.0, n)
    e = rng.integers(lo_exp, hi_exp, n)
    return (np.where(rng.random(n) < 0.5, -1.0, 1.0) * np.ldexp(m, e)).astype(np.float32)


def _midpoint_triples(rng, n, lo_exp=-100, hi_exp=100):
    """(a, b, c) whose float64 sum is a float32 midpoint that the exact sum
    misses by a hair: c a float32, m the midpoint between c and a
    neighbour, h = m - c, and a * b = h (1 - u^2) = h (1 + u)(1 - u) for u
    a small multiple of 2^-23, so a * b + c = m - h u^2 rounds to m in
    float64. Half of them end an odd c, where the two roundings part."""
    c = _random_floats(rng, n, lo_exp, hi_exp)
    up = rng.random(n) < 0.5
    nb = np.nextafter(c, np.where(up, np.float32(np.inf), np.float32(-np.inf)))
    h = (nb.astype(np.float64) - c.astype(np.float64)) / 2            # a power of two
    k = rng.integers(1, 300, n)
    u = k * 2.0 ** -23
    e = np.log2(np.abs(h)).astype(np.int64)
    e1 = e // 2
    a = (np.sign(h) * np.ldexp(1.0 + u, e1)).astype(np.float32)
    b = np.ldexp(1.0 - u, e - e1).astype(np.float32)
    return a, b, c


def test_the_exact_fmaf_model_is_rounded_once():
    """``exact_fmaf`` against exact rational arithmetic on random,
    midpoint and subnormal triples."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    sets = [tuple(_random_floats(rng, 400, -40, 40) for _ in range(3)),
            _midpoint_triples(rng, 400),
            _midpoint_triples(rng, 400, -149, -120),
            tuple(_random_floats(rng, 400, -80, -60) for _ in range(2))
            + (_random_floats(rng, 400, -150, -124),)]
    for a, b, c in sets:
        got = exact_fmaf(a, b, c)
        for i in range(a.shape[0]):
            x = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
            # RN32 of the rational: the nearest float32, ties to the even one.
            r = np.float32(float(x))
            cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
            dist = [abs(Fraction(float(v)) - x) for v in cands]
            best = min(dist)
            near = [v for v, dv in zip(cands, dist) if dv == best]
            want = near[0] if len(near) == 1 else next(v for v in near
                                                       if _bits(v) % 2 == 0)
            assert _bits(got[i]) == _bits(want), (a[i], b[i], c[i])


def test_kernel_fma_route_on_every_step_of_erf_inv():
    """Every prng.fma that erf_inv_plain makes on all 2^23 uniforms the
    normal draw can give (both log1p branches, both of Giles' branches): the
    native route bitwise prng.fma at every step, none of them marked. That
    is the whole domain of the NORMAL output, which takes the native route."""
    floats = (np.arange(2 ** 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo = np.float32(LO)
    u = np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)
    calls, marked_total = [], 0
    real = prng.fma

    def recording(a, b, c):
        nonlocal marked_total
        out = real(a, b, c)
        n = a.numel()
        arr = lambda x: (x.float().numpy() if isinstance(x, torch.Tensor)    # noqa: E731
                         else np.full(n, x, np.float32))
        got, marked = kernel_fma(arr(a), np.broadcast_to(arr(b), (n,)),
                                 np.broadcast_to(arr(c), (n,)), exact=False)
        assert np.array_equal(_bits(got), _bits(out.numpy()))
        calls.append(n)
        marked_total += int(marked.sum())
        return out

    prng.fma = recording
    try:
        prng.erf_inv_plain(torch.from_numpy(u))
    finally:
        prng.fma = real
    assert len(calls) == 29 and all(n == 2 ** 23 for n in calls)   # log1p 11, log 10, Giles 8
    assert marked_total == 0


def test_kernel_fma_route_on_random_triples():
    rng = np.random.default_rng(1)
    n = 1 << 20
    narrow = tuple(_random_floats(rng, n, -30, 30) for _ in range(3))
    bits = rng.integers(0, 2 ** 32, (3, n), dtype=np.uint64).astype(np.uint32).view(np.float32)
    bits = np.where(np.isfinite(bits), bits, np.float32(1.5))
    for a, b, c in (narrow, tuple(bits)):
        _check_route(a, b, c)


def test_kernel_fma_route_where_the_float64_sum_is_a_midpoint():
    """Triples built so that RN64(a * b + c) is a float32 midpoint the exact
    sum misses: the exact route is prng.fma, the native fmaf parts from it
    on about half of them (where the fmaf is odd), exactly those marked. So
    the native route serves only a domain shown free of them."""
    rng = np.random.default_rng(2)
    a, b, c = _midpoint_triples(rng, 1 << 16)
    differs, marked = _check_route(a, b, c)
    assert marked == differs and differs > a.shape[0] // 4


def test_kernel_fma_route_at_the_subnormal_edge():
    """Results in and around float32's subnormal range (|x| <= 2^-126 and a
    few binades above), midpoints among them."""
    rng = np.random.default_rng(3)
    n = 1 << 16
    a = _random_floats(rng, n, -70, -55)
    b = _random_floats(rng, n, -70, -55)
    c = _random_floats(rng, n, -152, -122)
    c[: n // 4] = 0.0
    differs, slow = _check_route(a, b, c)
    ma, mb, mc = _midpoint_triples(rng, n, -149, -124)
    differs_mid, _ = _check_route(ma, mb, mc)
    assert slow > n // 4 and differs_mid > 0


# --- ERFINV's steps (csrc/threefry.cu fma_step), modelled in NumPy ---
#
# The ERFINV output, as the NORMAL one, takes a native fmaf at every step of
# erf_inv. The card checks that on every float32 pattern in [-1, 1]
# (tools/erf_inv_check.py); here the model reads the step numbering from
# the source and holds the route on a seeded sample of patterns and on the
# edges: at every step the fmaf of the plain version's operands is
# prng.fma's result, and erf_inv computed with native fmafs is
# erf_inv_plain bitwise.

STEP_TEXT = (kernels.CSRC / "threefry.cu").read_text()
# The plain version's prng.fma calls in order, as the kernel numbers them:
# log1p's den (10-14) and num (15-20), _log_f32 (0-9), then Giles' 8, step
# 21 + j below w = 5 and 29 + j from it on.
PLAIN_CALL_STEPS = list(range(10, 21)) + list(range(10)) + [(21 + j, 29 + j) for j in range(8)]


def test_the_step_numbering_is_the_sources():
    """The MM_FMA steps are numbered 0-36 in the order the source evaluates
    them (_log_f32, log1p's den and num, Giles' two polynomials), each with
    the plain version's constant."""
    steps = re.findall(r"MM_FMA\((\d+), ", STEP_TEXT)
    assert [int(x) for x in steps] == list(range(prng.ERF_INV_STEPS))
    assert f"constexpr int STEPS = {prng.ERF_INV_STEPS};" in STEP_TEXT
    hexf = lambda m: float.fromhex(m.rstrip("f"))                       # noqa: E731
    consts = [hexf(m) for m in re.findall(r"MM_FMA\(\d+, [^;]*?, (-?0x[0-9a-f.]+p[-+]\d+f)\)",
                                          STEP_TEXT)]
    # The steps whose last operand is a constant: _log_f32's polynomial (0-5)
    # and its e * Q1 (8), then log1p's den and num, Giles' coefficients 1-8.
    assert consts[:7] == [prng._LOG_POLY[i] for i in (1, 2, 4, 5, 7, 8)] + [prng._LOG_Q1]
    assert consts[7:18] == list(prng._LOG1P_DEN[1:]) + list(prng._LOG1P_NUM[1:])
    assert consts[18:] == list(prng._ERFINV_W_LT_5[1:]) + list(prng._ERFINV_W_GE_5[1:])


def _native_erf_inv(x: np.ndarray):
    """erf_inv_plain with each prng.fma replaced by the exact fmaf model: the
    kernel's NATIVE route. Returns (the route's result, {step: elements where
    the native fmaf of the plain chain's operands differs from prng.fma,
    counting only the elements whose branch reaches the step})."""
    real = prng.fma
    calls, differ = [0], collections.Counter()
    state = {}

    def routed(a, b, c):
        i = calls[0]
        calls[0] += 1
        want = real(a, b, c)
        n = a.numel()
        arr = lambda t: (t.float().numpy() if isinstance(t, torch.Tensor)     # noqa: E731
                         else np.full(n, t, np.float32))
        av, bv, cv = arr(a), np.broadcast_to(arr(b), (n,)), np.broadcast_to(arr(c), (n,))
        native = exact_fmaf(av, bv, cv)
        if i == 0:                                   # log1p's input: its rational branch
            state["small"] = np.abs(bv) < prng._LOG1P_SMALL
        step = PLAIN_CALL_STEPS[i]
        if isinstance(step, tuple):                  # Giles: the branch by the constant
            lt = cv == np.float32(prng._ERFINV_W_LT_5[i - 20])
            steps = np.where(lt, step[0], step[1])
            reach = np.ones(n, bool)
        else:
            steps = np.full(n, step)
            reach = state["small"] if step >= 10 else ~state["small"]
        bad = (_bits(native) != _bits(want.numpy())) & reach
        for s_ in np.unique(steps[bad]):
            differ[int(s_)] += int((bad & (steps == s_)).sum())
        return torch.from_numpy(native)

    prng.fma = routed
    try:
        got = prng.erf_inv_plain(torch.from_numpy(x)).numpy()
    finally:
        prng.fma = real
    assert calls[0] == 29
    return got, differ


def _erf_inv_edges() -> np.ndarray:
    """+-0, +-1, the floats next to them, subnormals, and 64 floats each side
    of w = 5 (Giles' branch) and of log1p's branch, both signs."""
    edges = [0.0, 1.0, float(np.nextafter(np.float32(1), np.float32(0))),
             float(np.nextafter(np.float32(0), np.float32(1))), 2.0 ** -126, 2.0 ** -127,
             float(np.float32(2.0 ** -126) - np.float32(2.0 ** -149)), 2.0 ** -24, 2.0 ** -12]
    for centre in (np.sqrt(1.0 - np.exp(-5.0)), np.sqrt(float(prng._LOG1P_SMALL))):
        c = int(np.float32(centre).view(np.int32))
        edges += [float(v) for v in np.arange(c - 64, c + 65, dtype=np.int32).view(np.float32)]
    e = np.array(edges, np.float32)
    return np.concatenate([e, -e])


def _erf_inv_sample(seed: int, n: int) -> np.ndarray:
    """n float32 patterns of [-1, 1], uniform over the patterns."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 0x3F800001, n, dtype=np.uint32)
    bits |= (rng.random(n) < 0.5).astype(np.uint32) << np.uint32(31)
    return bits.view(np.float32)


@pytest.mark.parametrize("values", ["edges", "sample"])
def test_the_native_route_is_erf_inv_plain(values):
    """On the edges and on 2^20 seeded patterns of [-1, 1]: no step's native
    fmaf differs from prng.fma on the plain chain's operands, and the native
    route is erf_inv_plain bitwise (its w = 5 and log1p branches both
    reached)."""
    x = _erf_inv_edges() if values == "edges" else _erf_inv_sample(16, 1 << 20)
    got, differ = _native_erf_inv(x)
    assert not differ, differ
    want = prng.erf_inv_plain(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    w = -prng.log1p(torch.from_numpy(x * -x)).numpy()
    assert (w >= 5.0).any() and (w < 5.0).any()
    assert (np.abs(x * -x) < prng._LOG1P_SMALL).any() and (np.abs(x * -x) >= prng._LOG1P_SMALL).any()


def test_the_step_model_finds_a_step_the_native_route_breaks():
    """The model sees a difference where one is made: erf_inv_plain with one
    step's prng.fma cut to two roundings (the product, then the sum) differs
    from the native fmaf at that step, and only there."""
    real = prng.fma
    x = np.random.default_rng(17).uniform(-1, 1, 1 << 14).astype(np.float32)
    broken = []

    def two_roundings(a, b, c):
        broken.append(len(broken))
        if len(broken) == 2:                         # log1p's den, step 11
            b = b.float() if isinstance(b, torch.Tensor) else b
            return (a * b + c).float() if not isinstance(c, torch.Tensor) else \
                (a * b + c.float()).float()
        return real(a, b, c)

    prng.fma = two_roundings
    try:
        _, differ = _native_erf_inv(x)
    finally:
        prng.fma = real
    assert set(differ) == {11} and differ[11] > 0


def test_the_step_check_runs_only_on_the_card(monkeypatch, capsys):
    """prng.erf_inv_steps and tools/erf_inv_check.py check the kernel, so off
    the card they raise or exit 2 (no plain version stands in); the ranges
    cover every float32 of [-1, 1] and no pattern past 32 bits is asked for;
    the tool names the steps with a count."""
    from mirror_maze_tpu_torch.tools import erf_inv_check

    assert sum(end - first for first, end in prng.ERF_INV_RANGES) == 2130706434
    with pytest.raises(ValueError, match="CUDA device"):
        prng.erf_inv_steps(0, 4, device="cpu")
    with pytest.raises(ValueError, match="32 bits"):
        prng.erf_inv_steps(0xFFFFFFF0, 32, device="cuda")
    assert erf_inv_check.differing_steps({"steps": [0, 3, 0, 1] + [0] * 33}) == [1, 3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert erf_inv_check.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
