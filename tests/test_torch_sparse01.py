"""The port's 2-bin indicator-block histogram (``cumhist_sparse01``) on
the CPU, through its plain version, against the JAX package: the Pallas
``cumhist(..., sparse01=True)`` in interpret mode and the XLA path
``_treefit._level_cumhist`` at two bins. f64 within 1e-12; f32 with counts
exact and weighted channels within 1e-5 of the channel's max |value| (the
bf16-rounded products are summed in another order). The kernel itself
runs only on the card (``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _pallas_hist as JP
from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu_torch.models import _hist as H

REL32 = 1e-5


def _inputs(rng, n, Fb, A, C, dtype=np.float64, density=0.1):
    stats = rng.normal(size=(n, C)).astype(dtype)
    stats[:, -1] = rng.random(n) > 0.2                  # count channel
    node = rng.integers(0, A + 1, size=n).astype(np.int32)   # A = idle
    X01 = (rng.random((Fb, n)) < density).astype(np.int32)
    return stats, node, X01


def _jax_both(stats, node, X01, A):
    pal = JP.cumhist(jnp.asarray(stats), jnp.asarray(node),
                     jnp.asarray(X01), A, 2, sparse01=True, interpret=True)
    xla = JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                            jnp.asarray(X01.T), A, 2)
    return np.asarray(pal), np.asarray(xla)


@pytest.mark.parametrize("A", [1, 8])
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("Fb", [1, 7, 130])
def test_sparse01_f64_matches_pallas_and_xla(rng, A, C, Fb):
    n = 1500                                            # not a 1024 multiple
    stats, node, X01 = _inputs(rng, n, Fb, A, C)
    pal, xla = _jax_both(stats, node, X01, A)
    out = H.cumhist_sparse01(torch.tensor(stats), torch.tensor(node),
                             torch.tensor(X01).to(torch.uint8), A)
    assert out.shape == (A, C, 2, Fb) and out.dtype == torch.float64
    for ref in (pal, xla):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("A,C", [(1, 3), (8, 4)])
def test_sparse01_f32_counts_exact_weighted_close(rng, A, C):
    n, Fb = 3001, 130
    stats, node, X01 = _inputs(rng, n, Fb, A, C, np.float32)
    pal, xla = _jax_both(stats, node, X01, A)
    out = H.cumhist_sparse01(torch.tensor(stats), torch.tensor(node),
                             torch.tensor(X01).to(torch.uint8), A).numpy()
    dense = H.cumhist(torch.tensor(stats), torch.tensor(node),
                      torch.tensor(X01), A, 2).numpy()
    assert out.dtype == np.float32
    for ref in (pal, xla, dense):
        np.testing.assert_array_equal(out[:, -1], ref[:, -1])
        for c in range(C - 1):
            scale = np.abs(ref[:, c]).max()
            assert np.abs(out[:, c] - ref[:, c]).max() <= REL32 * scale


def test_sparse01_idle_rows_add_nothing(rng):
    n, Fb, A, C = 300, 5, 4, 3
    stats, node, X01 = _inputs(rng, n, Fb, A, C)
    node[:] = A
    out = H.cumhist_sparse01(torch.tensor(stats), torch.tensor(node),
                             torch.tensor(X01).to(torch.uint8), A)
    assert not out.any()


@pytest.mark.cuda
def test_sparse01_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernel runs only on the card")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    for n, Fb, A, C in ((5000, 130, 16, 4), (1003, 7, 1, 3)):
        stats, node, X01 = _inputs(rng, n, Fb, A, C, np.float32)
        st, nd = (torch.tensor(a, device=dev) for a in (stats, node))
        xb = torch.tensor(X01, device=dev).to(torch.uint8)
        out = H.cumhist_sparse01(st, nd, xb, A)
        ref = H.cumhist_sparse01_reference(st, nd, xb, A)
        dense = H.cumhist(st, nd, xb.to(torch.int32), A, 2)
        assert torch.equal(out[:, -1], ref[:, -1])
        assert torch.equal(out[:, -1], dense[:, -1])
        for c in range(C - 1):
            assert (out[:, c] - ref[:, c]).abs().max() \
                <= REL32 * ref[:, c].abs().max()
