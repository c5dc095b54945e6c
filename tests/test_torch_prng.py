"""The port's threefry2x32 against jax.random, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_maze_tpu_torch.ops import prng

SEEDS = [0, 1, 7, 123456, 2 ** 31 - 1]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _eq(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape
    if a.dtype == np.float32:
        assert b.dtype == np.float32
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, pk = _key(seed)
    _eq(jk, pk)
    for n in (2, 3, 8):
        _eq(jax.random.split(jk, n), prng.split(pk, n))
    for data in (0, 1, 37, 2 ** 31 - 1):
        _eq(jax.random.fold_in(jk, jnp.int32(data)),
            prng.fold_in(pk, torch.tensor(data, dtype=torch.int32)))
    # A chain, as the engine step uses them.
    _, jk2 = jax.random.split(jk)
    _, pk2 = prng.split(pk)
    _eq(jax.random.fold_in(jk2, 5), prng.fold_in(pk2, 5))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint(seed):
    jk, pk = _key(seed)
    _eq(jax.random.uniform(jk, (37, 8, 2), minval=-1.0, maxval=1.0),
        prng.uniform(pk, (37, 8, 2), -1.0, 1.0))
    _eq(jax.random.uniform(jk, (5,)), prng.uniform(pk, (5,)))
    _eq(jax.random.randint(jk, (), 0, jnp.iinfo(jnp.int32).max),
        prng.randint(pk, (), 0, 2 ** 31 - 1))
    _eq(jax.random.randint(jk, (64,), -3, 1000), prng.randint(pk, (64,), -3, 1000))


@pytest.mark.parametrize("n", [192, 129600])
@pytest.mark.parametrize("seed", [0, 3])
def test_permutation(n, seed):
    jk, pk = _key(seed)
    _eq(jax.random.permutation(jk, n), prng.permutation(pk, n))
