"""The port's tree-engine kernels, plain versions on the CPU, against the
JAX package: the Pallas kernels in interpret mode and the XLA paths of
``_treefit`` (f64 within 1e-9; f32 with counts exact and weighted
channels within 2e-5 of the channel's max |value|). The kernels
themselves run only on the card (``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _pallas_hist as JP
from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu_torch.models import _hist as H

REL32 = 2e-5


def _hist_inputs(rng, n, F, A, B, C, dtype=np.float64):
    stats = rng.normal(size=(n, C)).astype(dtype)
    stats[:, -1] = rng.random(n) > 0.2                  # count channel
    node = rng.integers(0, A + 1, size=n).astype(np.int32)   # A = idle
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    return stats, node, Xb


@pytest.mark.parametrize("n,F,A,B,C", [(37, 5, 4, 8, 3), (64, 3, 2, 2, 4),
                                       (101, 9, 1, 4, 4)])
def test_cumhist_f64_matches_pallas_and_xla(rng, n, F, A, B, C):
    stats, node, Xb = _hist_inputs(rng, n, F, A, B, C)
    pal = JP.cumhist(jnp.asarray(stats), jnp.asarray(node),
                     jnp.asarray(Xb.T), A, B, interpret=True)
    xla = JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                            jnp.asarray(Xb), A, B)
    XbT = torch.tensor(Xb.T.copy())
    out = H.cumhist(torch.tensor(stats), torch.tensor(node), XbT, A, B)
    out_bc = H.cumhist(torch.tensor(stats), torch.tensor(node), XbT, A, B,
                       bc=H.make_bc(XbT, B))
    for o in (out, out_bc):
        assert o.shape == (A, C, B, F) and o.dtype == torch.float64
        np.testing.assert_allclose(o.numpy(), np.asarray(pal),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(o.numpy(), np.asarray(xla),
                                   rtol=1e-9, atol=1e-9)


def test_cumhist_bc_matches_pallas_bc_variant(rng):
    n, F, A, B, C = 50, 4, 3, 8, 4
    stats, node, Xb = _hist_inputs(rng, n, F, A, B, C)
    bcj = JP.make_bc(jnp.asarray(Xb.T), B, jnp.float64)
    pal = JP.cumhist(jnp.asarray(stats), jnp.asarray(node),
                     jnp.asarray(Xb.T), A, B, bc=bcj, interpret=True)
    xla = JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                            jnp.asarray(Xb), A, B)
    XbT = torch.tensor(Xb.T.copy())
    bc = H.make_bc(XbT, B)
    np.testing.assert_array_equal(bc.numpy(), np.asarray(bcj))
    out = H.cumhist_reference(torch.tensor(stats), torch.tensor(node),
                              XbT, A, B, bc=bc)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), rtol=1e-9,
                               atol=1e-9)
    # the call a fit would make: rows grouped, the per-fit bc_rows copy
    st, nd = torch.tensor(stats), torch.tensor(node)
    got = H.cumhist(st, nd, XbT, A, B, bc=bc, groups=H.group_rows(nd, A),
                    rows=H.bc_rows(bc))
    for want in (pal, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("A,B,F", [(1, 8, 4), (5, 32, 20), (3, 2, 419)])
def test_cumhist_bc_rows_f64_exact_against_pallas_and_xla(rng, A, B, F):
    """Integer-valued f64 stats: every partial sum is exact, so the plain
    ``bc=`` call equals the Pallas ``_kernel_prebc`` (interpret mode) and
    the XLA path bit for bit."""
    n, C = 300, 4
    stats = rng.integers(-8, 9, size=(n, C)).astype(np.float64)
    stats[:, -1] = 1.0
    node = rng.integers(0, A + 1, size=n).astype(np.int32)
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    bcj = JP.make_bc(jnp.asarray(Xb.T), B, jnp.float64)
    pal = JP.cumhist(jnp.asarray(stats), jnp.asarray(node),
                     jnp.asarray(Xb.T), A, B, bc=bcj, interpret=True)
    xla = JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                            jnp.asarray(Xb), A, B)
    bc = H.make_bc(torch.tensor(Xb.T.copy()), B)
    got = H.cumhist(torch.tensor(stats), torch.tensor(node),
                    torch.tensor(Xb.T.copy()), A, B, bc=bc,
                    rows=H.bc_rows(bc))
    assert got.shape == (A, C, B, F)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


def test_cumhist_f32_counts_exact_weighted_close(rng):
    n, F, A, B, C = 3001, 6, 8, 16, 4
    stats, node, Xb = _hist_inputs(rng, n, F, A, B, C, np.float32)
    xla = np.asarray(JT._level_cumhist(jnp.asarray(stats), jnp.asarray(node),
                                       jnp.asarray(Xb), A, B))
    out = H.cumhist(torch.tensor(stats), torch.tensor(node),
                    torch.tensor(Xb.T.copy()), A, B).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out[:, -1], xla[:, -1])
    for c in range(C - 1):
        scale = np.abs(xla[:, c]).max()
        assert np.abs(out[:, c] - xla[:, c]).max() <= REL32 * scale


def _route_inputs(rng, n, F, B, A):
    A_child = 2 * A
    order = rng.permutation(A)
    split = rng.random(A) > 0.3
    ok = split & (order < A_child // 2)
    return dict(
        slot=rng.integers(0, A + 1, size=n).astype(np.int32),
        g=rng.integers(0, 64, size=n).astype(np.int32),
        f_idx=rng.integers(0, F, size=A).astype(np.int32),
        t_idx=rng.integers(0, B - 1, size=A).astype(np.int32),
        lchild=np.where(ok, 2 * order, A_child).astype(np.int32),
        rchild=np.where(ok, 2 * order + 1, A_child).astype(np.int32),
        do_split=split), A_child


@pytest.mark.parametrize("n,F,A", [(37, 5, 1), (200, 3, 4), (1500, 7, 16)])
def test_route_level_matches_pallas(rng, n, F, A):
    B = 8
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    kw, A_child = _route_inputs(rng, n, F, B, A)
    js, jg = JP.route_level(jnp.asarray(Xb.T), *(jnp.asarray(v) for v in
                                                 kw.values()),
                            A, A_child, interpret=True)
    ps, pg = H.route_level(torch.tensor(Xb.T.copy()),
                           *(torch.tensor(v) for v in kw.values()),
                           A, A_child)
    assert ps.dtype == pg.dtype == torch.int32
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


def _scan_cum(rng, kind, A, B, F, dtype):
    C = {"variance": 4, "gini": 3, "xgb": 3}[kind]
    n = 400
    y = (rng.random(n) > 0.6).astype(dtype)
    if kind == "variance":
        w = rng.random(n).astype(dtype) + 0.5
        stats = np.stack([w, w * y, w * y * y, np.ones(n, dtype)], 1)
    elif kind == "gini":
        stats = np.stack([1 - y, y, np.ones(n, dtype)], 1)
    else:
        p = rng.random(n).astype(dtype)
        stats = np.stack([p - y, p * (1 - p) + 1e-6, np.ones(n, dtype)], 1)
    node = rng.integers(0, A + 1, size=n).astype(np.int32)
    Xb = rng.integers(0, B, size=(n, F)).astype(np.int32)
    Xb[:, 1] = Xb[:, 0]              # a duplicated feature: exact score ties
    cum = JT._level_cumhist(jnp.asarray(stats.astype(dtype)),
                            jnp.asarray(node), jnp.asarray(Xb), A, B)
    return np.asarray(cum)


@pytest.mark.parametrize("kind", ["variance", "gini", "xgb"])
@pytest.mark.parametrize("masked", [False, True])
def test_split_scan_f64_matches_pallas(rng, kind, masked):
    A, B, F = 6, 8, 5
    cum = _scan_cum(rng, kind, A, B, F, np.float64)
    mask = (rng.random((A, F)) > 0.3).astype(np.float64) if masked else None
    kw = dict(lam=1.0, min_child_weight=0.5)
    js, ji, jv = JP.split_scan(
        jnp.asarray(cum), kind, 3.0, interpret=True,
        mask=None if mask is None else jnp.asarray(mask), **kw)
    ps, pi, pv = H.split_scan(
        torch.tensor(cum), kind, 3.0,
        mask=None if mask is None else torch.tensor(mask), **kw)
    assert pi.dtype == torch.int32 and pv.dtype == torch.bool
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-9,
                               atol=1e-9)


def test_split_scan_ties_take_first_flat_index(rng):
    # every candidate of slot 0 scores the same: the first (t=0, f=0) wins;
    # slot 1 has no admissible candidate: idx 0, invalid, masked score
    A, C, B, F = 2, 4, 4, 3
    cum = np.zeros((A, C, B, F))
    cum[0, 0] = cum[0, 3] = np.arange(1, B + 1)[:, None] * 10.0
    cum[0, 1] = 5.0
    s, i, v = H.split_scan(torch.tensor(cum), "variance", 1.0)
    js, ji, jv = JP.split_scan(jnp.asarray(cum), "variance", 1.0,
                               interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert i.tolist() == [0, 0] and v.tolist() == [True, False]
    assert s[1].item() == H.SPLIT_NEG


def test_split_scan_f32_selection_matches_xla_argmax(rng):
    A, B, F = 8, 16, 6
    cum = _scan_cum(rng, "xgb", A, B, F, np.float32)
    crit = JT.XGBCriterion(1.0, jnp.asarray(0.5, jnp.float32))
    sb = crit.score(jnp.asarray(cum))
    lc, tc = cum[:, -1, :-1, :], cum[:, -1, -1:, :]
    ok = (lc >= 3.0) & (tc - lc >= 3.0) & np.asarray(crit.extra_ok(
        jnp.asarray(cum)))
    flat = np.where(ok, np.asarray(sb), -1e30).reshape(A, -1)
    _s, i, v = H.split_scan(torch.tensor(cum), "xgb", 3.0, lam=1.0,
                            min_child_weight=0.5)
    np.testing.assert_array_equal(i.numpy(), np.argmax(flat, axis=1))
    np.testing.assert_array_equal(
        v.numpy(), ok.reshape(A, -1)[np.arange(A), i.numpy()])


@pytest.mark.parametrize("n,T,D,K", [(50, 3, 3, 1), (300, 5, 4, 2)])
def test_predict_trees_matches_pallas_and_xla(rng, n, T, D, K):
    F = 6
    X = rng.normal(size=(n, F))
    feat = rng.integers(0, F, size=(T, (1 << D) - 1)).astype(np.int32)
    thr = rng.normal(size=(T, (1 << D) - 1))
    thr[rng.random(thr.shape) < 0.2] = np.inf               # dead splits
    leaf = rng.normal(size=(T, 1 << D, K))
    tree_w = rng.random(T)
    xla = JT.predict_ensemble(jnp.asarray(feat), jnp.asarray(thr),
                              jnp.asarray(leaf), jnp.asarray(tree_w),
                              jnp.asarray(X), D)
    lw = leaf * tree_w[:, None, None]
    out = H.predict_trees(torch.tensor(X), torch.tensor(feat),
                          torch.tensor(thr), torch.tensor(lw), D)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=1e-9,
                               atol=1e-9)
    # the Pallas kernel works in f32
    X32, thr32, lw32 = (a.astype(np.float32) for a in (X, thr, lw))
    pal = JP.predict_trees(jnp.asarray(X32), jnp.asarray(feat),
                           jnp.asarray(thr32), jnp.asarray(lw32), D,
                           interpret=True)
    out32 = H.predict_trees(torch.tensor(X32), torch.tensor(feat),
                            torch.tensor(thr32), torch.tensor(lw32), D)
    np.testing.assert_allclose(out32.numpy(), np.asarray(pal),
                               rtol=REL32, atol=REL32)


def test_wrappers_raise_on_a_device_without_kernels():
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        H.cumhist(meta, torch.empty((4,), dtype=torch.int32, device="meta"),
                  torch.empty((2, 4), dtype=torch.int32, device="meta"), 2, 4)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernels run only on the card")
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    n, F, A, B, C = 5000, 7, 16, 32, 4
    stats, node, Xb = _hist_inputs(rng, n, F, A, B, C, np.float32)
    st, nd = torch.tensor(stats, device=dev), torch.tensor(node, device=dev)
    XbT = torch.tensor(Xb.T.copy(), device=dev)
    ref = H.cumhist_reference(st, nd, XbT, A, B)
    for bc in (None, H.make_bc(XbT, B)):
        out = H.cumhist(st, nd, XbT, A, B, bc=bc)
        assert torch.equal(out[:, -1], ref[:, -1])
        for c in range(C - 1):
            assert (out[:, c] - ref[:, c]).abs().max() \
                <= REL32 * ref[:, c].abs().max()
    for kind in ("variance", "xgb"):
        got = H.split_scan(ref, kind, 5.0, lam=1.0, min_child_weight=0.1)
        want = H.split_scan_reference(ref, kind, 5.0, lam=1.0,
                                      min_child_weight=0.1)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    kw, A_child = _route_inputs(rng, n, F, B, A)
    args = [torch.tensor(v, device=dev) for v in kw.values()]
    for a, b in zip(H.route_level(XbT, *args, A, A_child),
                    H.route_level_reference(XbT, *args, A, A_child)):
        assert torch.equal(a, b)
    T, D = 4, 5
    X = torch.tensor(rng.normal(size=(n, F)).astype(np.float32), device=dev)
    feat = torch.tensor(rng.integers(0, F, size=(T, (1 << D) - 1)),
                        dtype=torch.int32, device=dev)
    thr = torch.randn((T, (1 << D) - 1), device=dev)
    leaf = torch.randn((T, 1 << D, 1), device=dev)
    out = H.predict_trees(X, feat, thr, leaf, D)
    ref = H.predict_trees_reference(X, feat, thr, leaf, D)
    assert (out - ref).abs().max() <= REL32 * ref.abs().max()
