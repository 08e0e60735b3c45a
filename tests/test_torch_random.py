"""The port's threefry PRNG against ``jax.random``, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch import random as R


def _raw(key):
    return np.asarray(jax.random.key_data(key) if jax.dtypes.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key)


@pytest.mark.parametrize("seed", [0, 7, 0x51EED, 2 ** 40 + 3])
def test_prngkey_and_split(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(R.PRNGKey(seed), _raw(k))
    for num in (2, 5):
        np.testing.assert_array_equal(R.split(R.PRNGKey(seed), num),
                                      _raw(jax.random.split(k, num)))


@pytest.mark.parametrize("shape", [(1,), (7, 3), (1000,)])
def test_random_bits(shape):
    k = jax.random.PRNGKey(42)
    np.testing.assert_array_equal(
        R.random_bits(R.PRNGKey(42), shape),
        np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32)))


@pytest.mark.parametrize("n", [1, 10, 1000, 300_000])
def test_permutation(n):
    seed = 0x51EED                   # the quantile sketch's key
    np.testing.assert_array_equal(
        R.permutation(R.PRNGKey(seed), n),
        np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)))


@pytest.mark.parametrize("data", [0, 1, 11, 2 ** 31 + 7])
def test_fold_in(data):
    k = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(R.fold_in(R.PRNGKey(7), data),
                                  _raw(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1,), (7, 3), (1000,), (128, 498)])
def test_uniform(dtype, shape):
    """32-bit draws for float32, 64-bit for float64 (the width the JAX
    package draws at under x64)."""
    k = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    want = np.asarray(jax.random.uniform(k, shape, dtype))
    got = R.uniform(R.fold_in(R.PRNGKey(3), 5), shape, dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_prefix_rows(dtype):
    """A draw of shape (A, F) is the first A rows of a draw of shape
    (cap, F): one draw serves every slot count of a level."""
    k = jax.random.PRNGKey(9)
    full = np.asarray(jax.random.uniform(k, (128, 20), dtype))
    for A in (1, 2, 8, 64):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(k, (A, 20), dtype)), full[:A])
        np.testing.assert_array_equal(
            R.uniform(R.PRNGKey(9), (A, 20), dtype), full[:A])


def test_threefry_torch_matches_numpy():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, size=(6, 2), dtype=np.uint64)
    x1 = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64)
    x2 = rng.integers(0, 2 ** 32, size=500, dtype=np.uint64)
    for k1, k2 in keys:
        want = R.threefry2x32(np.uint32(k1), np.uint32(k2),
                              x1.astype(np.uint32), x2.astype(np.uint32))
        got = R.threefry2x32_torch(
            torch.tensor(int(k1)), torch.tensor(int(k2)),
            torch.tensor(x1.astype(np.int64)),
            torch.tensor(x2.astype(np.int64)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniform_batch_matches_jax(dtype):
    """Many keys at once on a torch device: row k is the draw under key
    k."""
    base = jax.random.PRNGKey(17)
    keys = np.stack([R.fold_in(R.PRNGKey(17), d) for d in range(5)])
    got = R.uniform_batch(keys, (33, 7), dtype, "cpu")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    for d in range(5):
        np.testing.assert_array_equal(
            got[d].numpy(),
            np.asarray(jax.random.uniform(jax.random.fold_in(base, d),
                                          (33, 7), jdt)))
