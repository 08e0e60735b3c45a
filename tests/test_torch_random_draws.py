"""``random.normal`` and ``random.categorical`` against ``jax.random``
(partitionable threefry), and the XLA math under them (``xla_log_f32``,
``xla_log1p``, ``xla_erfinv``) against XLA's own on the CPU.

Tolerances: bitwise (0 ulp) for every draw at the MLP's initial-weight
shapes and the tests' sizes, for categorical draws whole and in chunks,
and for log / log1p over 100,000 arguments. One known case differs: at
``normal(PRNGKey(3), (4000, 17))`` one draw of 68,000 differs, by one ulp
in f32 and by two in f64, both in ErfInv's outer branches just above
their thresholds (ROADMAP C); that draw is asserted to be the only one
and within those ulps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch import random as R

DT = {"f32": np.float32, "f64": np.float64}


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("seed,shape", [
    (0, (5, 10)), (1, (10, 3)), (2, (8, 10)), (3, (26, 10)), (4, (40, 10)),
    (11, (257,)), (0, (100, 10, 3)), (7, (300, 10))])
def test_normal_bitwise(dt, seed, shape):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                       DT[dt]))
    got = R.normal(R.PRNGKey(seed), shape, DT[dt])
    assert got.dtype == ref.dtype
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_normal_split_keys_bitwise(dt):
    """The MLP's layer keys: split, then a draw under each subkey."""
    key_j, key_t = jax.random.PRNGKey(3), R.PRNGKey(3)
    for shape in ((12, 10), (10, 2)):
        key_j, kj = jax.random.split(key_j)
        key_t, kt = R.split(key_t)
        assert np.array_equal(np.asarray(kj), kt)
        ref = np.asarray(jax.random.normal(kj, shape, DT[dt]))
        assert np.array_equal(R.normal(kt, shape, DT[dt]), ref)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_normal_known_difference(dt):
    """The documented case: one draw of 68,000, one ulp (f32) or two
    (f64)."""
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4000, 17),
                                       DT[dt]))
    got = R.normal(R.PRNGKey(3), (4000, 17), DT[dt])
    bits = np.int32 if dt == "f32" else np.int64
    ulps = np.abs(got.view(bits).astype(np.int64)
                  - ref.view(bits).astype(np.int64))
    assert (ulps != 0).sum() <= 1
    assert ulps.max() <= (1 if dt == "f32" else 2)


def _logits(V, seed):
    uni = np.random.default_rng(seed).integers(1, 60, V).astype(
        np.float64) ** 0.75
    return np.log(uni / uni.sum()).astype(np.float32)


@pytest.mark.parametrize("V,shape,data", [
    (37, (3000, 5), 7), (76, (1500, 5), 0), (5, (400, 3), 99)])
def test_categorical_bitwise_whole_and_chunked(V, shape, data):
    logits = _logits(V, data)
    kj = jax.random.fold_in(jax.random.PRNGKey(42), data)
    kt = R.fold_in(R.PRNGKey(42), data)
    ref = np.asarray(jax.random.categorical(kj, jnp.asarray(logits),
                                            shape=shape)).reshape(-1)
    lt = torch.from_numpy(logits)
    got = R.categorical(kt, lt, shape).numpy()
    assert np.array_equal(got, ref)
    n = ref.size
    parts = [R.categorical(kt, lt, shape, a, min(n, a + 777)).numpy()
             for a in range(0, n, 777)]
    assert np.array_equal(np.concatenate(parts), ref)


def test_gumbel_noise_bitwise():
    """−log(−log(u)) as ``jax.random.gumbel`` draws it (f32)."""
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax.random.gumbel(key, (20000,), jnp.float32))
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.from_numpy(R.uniform(R.PRNGKey(5), (20000,), np.float32))
    u = torch.clamp(u + tiny, min=tiny)
    got = (-R.xla_log_f32(-R.xla_log_f32(u))).numpy()
    assert np.array_equal(got, ref)


def test_xla_log_f32_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(50000) * 3.0,
                        np.exp(rng.normal(0, 20, 50000)),
                        [0.0, -1.0, np.inf, np.nan, 1e-40, 1.0, 2.0]]
                       ).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.log)(x))
    got = R.xla_log_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref, equal_nan=True)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_xla_log1p_bitwise(dt):
    u = np.random.default_rng(1).uniform(-1.0, 1.0, 100000).astype(DT[dt])
    x = u * -u
    ref = np.asarray(jax.jit(jnp.log1p)(x))
    got = R.xla_log1p(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref)


def test_categorical_fast_noise_within_margin():
    """``torch.log``'s Gumbel noise stays far inside the margin of XLA's
    (a few ulp), extreme uniforms included, so a row outside the margin
    has the same argmax under either."""
    u = torch.from_numpy(R.uniform(R.PRNGKey(9), (2_000_000,), np.float32))
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.cat([torch.clamp(u + tiny, min=tiny),
                   torch.tensor([tiny, 1e-30, 0.5, 1.0 - 2 ** -24])])
    fast = -torch.log(-torch.log(u))
    exact = -R.xla_log_f32(-R.xla_log_f32(u))
    assert (fast - exact).abs().max().item() < R.CATEGORICAL_MARGIN / 50


@pytest.mark.parametrize("margin", [float("inf"), 0.0])
def test_categorical_exact_and_fast_paths_alone(margin, monkeypatch):
    """Every row through XLA's noise (infinite margin), and no row (zero
    margin), both bitwise here."""
    monkeypatch.setattr(R, "CATEGORICAL_MARGIN", margin)
    logits = _logits(37, 7)
    kj = jax.random.fold_in(jax.random.PRNGKey(42), 7)
    ref = np.asarray(jax.random.categorical(kj, jnp.asarray(logits),
                                            shape=(2000, 5))).reshape(-1)
    got = R.categorical(R.fold_in(R.PRNGKey(42), 7),
                        torch.from_numpy(logits), (2000, 5)).numpy()
    assert np.array_equal(got, ref)
