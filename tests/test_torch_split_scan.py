"""``split_scan`` at the main paths' shapes: the port's plain version on
the CPU against the JAX package's Pallas kernel in interpret mode, and
the CUDA kernel against the plain version on the card (``cuda`` marker).

Shapes: the text path's 2-bin block (Fb=419, B=2) and its 32-bin block
(F=32, B=32), at A ∈ {1, 32} slots. The histograms are built with numpy
from seeded rows in which feature 0 carries the label and features 1 and
F−1 are copies of it, so the best split of most slots ties at three flat
indices of one threshold and the lowest (f = 0) must win. Tolerances:
indices and valid flags exact; scores within 1e-12 relative in f64 (the
same operations, summed in one order) and bitwise equal in f32 (both
sides evaluate the criterion in the same IEEE operation order; a
contraction into multiply-add on either side would show here). On the
card the kernel's scores are bitwise equal to the plain version's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _pallas_hist as JP
from transmogrifai_tpu_torch.models import _hist as H

SHAPES = [(419, 2), (32, 32)]
KINDS = {"variance": 4, "gini": 3, "xgb": 3}


def _cum(rng, kind, A, F, B, dtype, n=3000):
    """[A, C, B, F] cumulative histograms of n seeded rows; feature 0
    follows the label, features 1 and F − 1 duplicate it."""
    C = KINDS[kind]
    y = (rng.random(n) > 0.6).astype(np.float64)
    if kind == "variance":
        w = rng.random(n) + 0.5
        stats = np.stack([w, w * y, w * y * y, np.ones(n)], 1)
    elif kind == "gini":
        stats = np.stack([1 - y, y, np.ones(n)], 1)
    else:
        p = rng.random(n)
        stats = np.stack([p - y, p * (1 - p) + 1e-6, np.ones(n)], 1)
    stats = stats.astype(dtype)
    Xb = rng.integers(0, B, size=(n, F))
    noisy = rng.random(n) < 0.1
    Xb[:, 0] = np.where(noisy, rng.integers(0, B, size=n),
                        (y * (B - 1)).astype(np.int64) if B == 2
                        else (y * (B // 2) + rng.integers(0, B // 2, n)))
    Xb[:, 1] = Xb[:, F - 1] = Xb[:, 0]
    node = rng.integers(0, A + 1, size=n)                 # A = idle
    h = np.zeros((A + 1, C, B, F), dtype)
    fi = np.broadcast_to(np.arange(F), (n, F))
    for c in range(C):
        np.add.at(h[:, c], (node[:, None], Xb, fi),
                  np.broadcast_to(stats[:, c:c + 1], (n, F)))
    return np.cumsum(h[:A], axis=2)


@pytest.mark.parametrize("F,B", SHAPES)
@pytest.mark.parametrize("A", [1, 32])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_scan_main_shapes_match_pallas(rng, F, B, A, kind, dtype):
    cum = _cum(rng, kind, A, F, B, dtype)
    kw = dict(lam=1.0, min_child_weight=0.5)
    js, ji, jv = JP.split_scan(jnp.asarray(cum), kind, 5.0, interpret=True,
                               **kw)
    ps, pi, pv = H.split_scan(torch.tensor(cum), kind, 5.0, **kw)
    assert pi.dtype == torch.int32 and pv.dtype == torch.bool
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    if dtype == np.float64:
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-12,
                                   atol=0)
    else:
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    f = pi.numpy() % F
    assert not np.isin(f, (1, F - 1)).any()      # copies never beat f = 0
    assert (f[pv.numpy()] == 0).mean() >= 0.5    # and the ties are taken


@pytest.mark.cuda
@pytest.mark.parametrize("F,B", [(20, 32), (32, 32), (419, 2), (600, 32)])
def test_split_scan_kernel_matches_plain_version_on_the_card(F, B):
    """The twin of ``chip_smoke.py``'s split-scan check: every criterion,
    A ∈ {1, 2, 32, 64, 128}, masked and not, ties; scores bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernels run only on the card")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    for kind in KINDS:
        for A in (1, 2, 32, 64, 128):
            cum = torch.tensor(_cum(rng, kind, A, F, B, np.float32),
                               device=dev)
            mask = torch.tensor((rng.random((A, F)) > 0.2)
                                .astype(np.float32), device=dev)
            for m in (None, mask):
                kw = dict(lam=1.0, min_child_weight=0.5, mask=m)
                got = H.split_scan(cum, kind, 5.0, **kw)
                want = H.split_scan_reference(cum, kind, 5.0, **kw)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and torch.equal(a, b)
