"""The threefry kernel's wrappers (ops/prng.py, csrc/threefry.cu) on the CPU.

On a CPU tensor every draw takes its plain version and launches nothing; on
a device that is neither CPU nor CUDA it raises. Each launch a wrapper would
make (``prng.Draw``), read here element by element as the kernel reads it,
gives the plain version's result; and the plain versions are jax.random's,
bit for bit, on key batches, broadcast fold_in data and counts around the
kernel's block edges. The kernel itself is held against the plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py ``[threefry]``).
"""

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
    assert 'extern "C" int mm_threefry(' in text
    assert "fmaf" not in text.replace("never a native fmaf", "")
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
