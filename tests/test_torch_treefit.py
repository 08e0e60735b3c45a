"""The port's tree engine (``transmogrifai_tpu_torch/models/_treefit.py``)
against the JAX package's XLA path on the CPU, in f64: bin edges and bins
exact, trees' features and thresholds exact, leaves within 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu_torch.models import _treefit as PT


def _data(rng, n, F):
    X = rng.normal(size=(n, F)) * rng.choice([1e-3, 1.0, 1e3], size=F)
    y = ((X[:, 0] > 0.0) ^ (X[:, 1 % F] < 0.0)).astype(np.float64)
    w = np.ones(n)
    w[rng.random(n) < 0.2] = 0.0
    return X, y, w


@pytest.mark.parametrize("n,F", [(600, 5), (5000, 3), (300_000, 2)])
def test_quantile_edges_and_bins_exact(rng, n, F):
    X = _data(rng, n, F)[0]
    je = np.asarray(JT.quantile_bin_edges(jnp.asarray(X), 32))
    pe = PT.quantile_bin_edges(torch.tensor(X), 32)
    np.testing.assert_array_equal(pe.numpy(), je)
    if n <= 5000:
        np.testing.assert_array_equal(
            PT.binarize(torch.tensor(X), pe).numpy(),
            np.asarray(JT.binarize(jnp.asarray(X), jnp.asarray(je))))


def _leaf_index(X, feat, thr, depth):
    """[T, n] leaf each training row reaches in each tree."""
    out = []
    for f, t in zip(feat, thr):
        node = np.zeros(len(X), np.int64)
        for d in range(depth):
            pos = (1 << d) - 1 + node
            node = 2 * node + (X[np.arange(len(X)), f[pos]] > t[pos])
        out.append(node)
    return np.stack(out)


def _trees_equal(pj, pp, keys=("feat", "thr", "leaf", "gain"), X=None,
                 depth=None):
    """feat exact; thr exact — or, when ``X`` is given, a differing
    threshold must be a tie between two edges with none of the node's
    training rows between them (the f64 histograms' summation order picks
    either), so every training row reaches the same leaf; the rest within
    1e-9."""
    for k in keys:
        a, b = np.asarray(pj[k]), pp[k].numpy()
        assert a.shape == b.shape, k
        if k == "thr" and X is not None:
            np.testing.assert_array_equal(
                _leaf_index(X, pp["feat"].numpy(), b, depth),
                _leaf_index(X, np.asarray(pj["feat"]), a, depth))
            assert (a != b).mean() <= 0.05, "thr: more than rare ties differ"
        elif k in ("feat", "thr"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("max_nodes", [128, 2])
def test_grow_tree_both_drivers(rng, unroll, max_nodes):
    n, F, B, D = 800, 4, 16, 4
    X, y, w = _data(rng, n, F)
    r = y - 0.3
    stats = np.stack([w, w * r, w * r * r, (w > 0).astype(float)], 1)
    Xb, edges = JT.compute_bins(jnp.asarray(X), B)
    kw = dict(max_active_nodes=max_nodes, unroll=unroll,
              depth_limit=None if unroll else 3)
    jf, jt, jl, jn, jg = jax.jit(lambda xb, e, st: JT.grow_tree(
        xb, e, st, JT.VarianceCriterion(), JT.variance_leaf, D, B,
        jnp.asarray(5.0), jnp.asarray(1e-4), **kw))(
            Xb, edges, jnp.asarray(stats))
    XbT, pedges = PT.compute_bins(torch.tensor(X), B)
    pf, pt, pl, pn, pg = PT.grow_tree(
        XbT, pedges, torch.tensor(stats), PT.VarianceCriterion(),
        PT.variance_leaf, D, B, 5.0, 1e-4, **kw)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("unroll", [False, True])
def test_fit_gbt_matches(rng, unroll):
    X, y, w = _data(rng, 700, 5)
    kw = dict(task="classification", n_rounds=4, max_depth=4, n_bins=32,
              unroll=unroll, depth_limit=None if unroll else 3)
    pj = JT.fit_gbt(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                    min_instances=jnp.asarray(5.0),
                    min_info_gain=jnp.asarray(0.001),
                    step_size=jnp.asarray(0.1),
                    num_rounds_used=jnp.asarray(3.0), **kw)
    pp = PT.fit_gbt(torch.tensor(X), torch.tensor(y), torch.tensor(w),
                    min_instances=5.0, min_info_gain=0.001, step_size=0.1,
                    num_rounds_used=3.0, **kw)
    _trees_equal(pj, pp, ("feat", "thr", "leaf", "gain", "train_margin"))


@pytest.mark.parametrize("unroll", [False, True])
def test_fit_xgb_matches(rng, unroll):
    X, y, w = _data(rng, 700, 5)
    kw = dict(task="classification", n_rounds=4, max_depth=4, n_bins=32,
              lam=1.0, unroll=unroll)
    pj = JT.fit_xgb(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                    eta=jnp.asarray(0.3), min_child_weight=jnp.asarray(1.0),
                    num_rounds_used=jnp.asarray(4.0), **kw)
    pp = PT.fit_xgb(torch.tensor(X), torch.tensor(y), torch.tensor(w),
                    eta=0.3, min_child_weight=1.0, num_rounds_used=4.0, **kw)
    # a depth-2 node of the third tree has two edges with no row between
    # them: the exact tie that the summation order may break either way
    _trees_equal(pj, pp, ("feat", "thr", "leaf", "gain", "train_margin"),
                 X=X, depth=4)


def test_regression_heads_and_routed_predict(rng):
    X, y, w = _data(rng, 500, 4)
    y = X[:, 0] * 2.0 + 0.1 * rng.normal(size=len(y))
    kw = dict(task="regression", n_rounds=3, max_depth=3, n_bins=32)
    pj = JT.fit_gbt(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                    min_instances=jnp.asarray(5.0),
                    min_info_gain=jnp.asarray(0.0),
                    step_size=jnp.asarray(0.5),
                    num_rounds_used=jnp.asarray(3.0), **kw)
    pp = PT.fit_gbt(torch.tensor(X), torch.tensor(y), torch.tensor(w),
                    min_instances=5.0, min_info_gain=0.0, step_size=0.5,
                    num_rounds_used=3.0, **kw)
    _trees_equal(pj, pp)
    Xn = rng.normal(size=(200, 4))
    jm = JT.predict_margin_regression(
        {k: pj[k] for k in ("feat", "thr", "leaf", "tree_w")},
        jnp.asarray(Xn), 3)[0]
    pm = PT.predict_margin_regression(pp, torch.tensor(Xn), 3)[0]
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-9,
                               atol=1e-9)
    # the train-margin cache equals routing the training rows
    routed = PT.predict_margin_regression(pp, torch.tensor(X), 3)[0]
    np.testing.assert_allclose(routed.numpy(), pp["train_margin"].numpy(),
                               rtol=1e-12, atol=1e-12)


def test_binary_columns_are_refused(rng):
    """Indicator columns are refused a quantile-bin slot: they are rebinned
    to ``x > 0.5`` and go to the 2-bin block, after the continuous one."""
    X = np.stack([rng.normal(size=50), (rng.random(50) > 0.5) * 1.0,
                  rng.normal(size=50)], 1)
    mask = np.array([False, True, False])
    XbT, edges = PT.compute_bins(torch.tensor(X), 32, binary_mask=mask)
    jb, je = JT.compute_bins(jnp.asarray(X), 32, mask)
    np.testing.assert_array_equal(XbT.numpy(), np.asarray(jb).T)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(je))
    blocks = PT.prepare_blocks(XbT, 32, mask)
    assert [(b.cols.tolist(), b.n_bins, b.sparse01) for b in blocks] == \
        [([0, 2], 32, False), ([1], 2, True)]
    assert blocks[1].mat.dtype == torch.uint8
    np.testing.assert_array_equal(blocks[1].mat.numpy()[0], X[:, 1] > 0.5)
    assert [(list(c), nb) for c, nb, _thr in
            JT.make_col_blocks(je, 32, mask)] \
        == [(b.cols.tolist(), b.n_bins) for b in blocks]


def _mixed_data(rng, n, F_cont, F_bin):
    """Continuous columns beside independent 0/1 columns of varying
    density (no column is another's complement, so no two candidates tie
    in exact arithmetic); the label reads both kinds."""
    Xc = rng.normal(size=(n, F_cont))
    dens = rng.uniform(0.05, 0.5, size=F_bin)
    Xbin = (rng.random((n, F_bin)) < dens).astype(np.float64)
    X = np.concatenate([Xbin[:, :2], Xc, Xbin[:, 2:]], axis=1)
    mask = np.array([True, True] + [False] * F_cont + [True] * (F_bin - 2))
    y = ((Xc[:, 0] > 0.2) ^ (Xbin[:, 0] > 0.5)
         | (Xbin[:, 3] > 0.5)).astype(np.float64)
    w = np.ones(n)
    w[rng.random(n) < 0.2] = 0.0
    return X, y, w, mask


@pytest.mark.parametrize("unroll", [False, True])
def test_fit_gbt_mixed_blocks_matches(rng, unroll):
    X, y, w, mask = _mixed_data(rng, 900, 3, 9)
    kw = dict(task="classification", n_rounds=4, max_depth=4, n_bins=32,
              unroll=unroll, depth_limit=None if unroll else 3)
    pj = JT.fit_gbt(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                    min_instances=jnp.asarray(5.0),
                    min_info_gain=jnp.asarray(0.001),
                    step_size=jnp.asarray(0.1),
                    num_rounds_used=jnp.asarray(4.0), binary_mask=mask, **kw)
    pp = PT.fit_gbt(torch.tensor(X), torch.tensor(y), torch.tensor(w),
                    min_instances=5.0, min_info_gain=0.001, step_size=0.1,
                    num_rounds_used=4.0, binary_mask=mask, **kw)
    assert (np.asarray(pj["thr"]) == 0.5).any(), "no indicator split"
    _trees_equal(pj, pp, ("feat", "thr", "leaf", "gain", "train_margin"),
                 X=X, depth=4)


@pytest.mark.parametrize("unroll", [False, True])
def test_fit_xgb_mixed_blocks_matches(rng, unroll):
    X, y, w, mask = _mixed_data(rng, 900, 3, 9)
    kw = dict(task="classification", n_rounds=4, max_depth=4, n_bins=32,
              lam=1.0, unroll=unroll)
    pj = JT.fit_xgb(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                    eta=jnp.asarray(0.3), min_child_weight=jnp.asarray(1.0),
                    num_rounds_used=jnp.asarray(4.0), binary_mask=mask, **kw)
    pp = PT.fit_xgb(torch.tensor(X), torch.tensor(y), torch.tensor(w),
                    eta=0.3, min_child_weight=1.0, num_rounds_used=4.0,
                    binary_mask=mask, **kw)
    assert (np.asarray(pj["thr"]) == 0.5).any(), "no indicator split"
    _trees_equal(pj, pp, ("feat", "thr", "leaf", "gain", "train_margin"),
                 X=X, depth=4)
