"""The level epilogue of the port's tree engine (``models/_hist.py
level_epilogue``): everything a tree level does after its split scans.

Its plain version is held against a per-slot numpy loop written from the
JAX package's level body (``transmogrifai_tpu/models/_treefit.py``
``grow_tree.level``: the winner merge and decode, the exact gain,
``do_split``, the gain ranking and child allocation, the route, the node
records, the leaf stats and the next level's slot state), in f64 and
exactly, at gain ties, a slot budget smaller than the splitting slots, a
level past the depth limit, the last level, two blocks with winners in
the 2-bin block, a level where nothing splits, and both drivers' levels.
``grow_tree`` on the CPU is held against the JAX ``grow_tree`` at two
blocks. The kernel runs only on the card (``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu_torch.models import _hist as H
from transmogrifai_tpu_torch.models import _treefit as PT

EPS = 1e-12


def _gain(kind, l, t, lam):
    """The JAX criteria's ``gain`` at one slot's [C] left / total stats."""
    if kind == "variance":
        def imp(w, s1, s2):
            w = max(w, EPS)
            return s2 / w - (s1 / w) ** 2
        W = max(t[0], EPS)
        wL, wR = l[0], t[0] - l[0]
        return imp(t[0], t[1], t[2]) - (wL / W) * imp(wL, l[1], l[2]) \
            - (wR / W) * imp(wR, t[1] - l[1], t[2] - l[2])

    def s(g, h):
        return g * g / (h + lam + EPS)
    return 0.5 * (s(l[0], l[1]) + s(t[0] - l[0], t[1] - l[1])
                  - s(t[0], t[1]))


def _epilogue_numpy(score, idx, valid, cums, cols, sparse01, edges, alive,
                    gpos, XbT, slot, g, feat, thr, gain, leaf, *, kind, lam,
                    mig, d, D, A_next, split_ok, node_even):
    """One level after its split scans, slot by slot and row by row."""
    A, C = len(alive), cums[0].shape[1]
    sizes = [(c.shape[2] - 1) * c.shape[3] for c in cums]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    f_idx = np.zeros(A, np.int64)
    t_idx = np.zeros(A, np.int64)
    thr_v = np.zeros(A)
    lst = np.zeros((A, C))
    tst = np.zeros((A, C))
    gains = np.zeros(A)
    do = np.zeros(A, bool)
    for a in range(A):
        # argmax over the concatenated candidates: the highest score, the
        # lowest flat index among equals
        cands = [(-score[b][a], offs[b] + idx[b][a], b)
                 for b in range(len(cums))]
        _s, best, b = min(cands)
        ok = valid[b][a]
        local = best - offs[b]
        fb_n = cums[b].shape[3]
        fb, tb = local % fb_n, local // fb_n
        f_idx[a], t_idx[a] = cols[b][fb], tb
        thr_v[a] = 0.5 if sparse01[b] else edges[cols[b][fb], tb]
        lst[a] = cums[b][a, :, tb, fb]
        tst[a] = cums[0][a, :, -1, 0]
        gains[a] = _gain(kind, lst[a], tst[a], lam)
        do[a] = (split_ok and alive[a] and ok
                 and gains[a] >= max(mig, 1e-10))
    order = sorted(range(A), key=lambda a: (0, -gains[a], a) if do[a]
                   else (1, 0.0, a))
    inv = np.empty(A, np.int64)
    inv[order] = np.arange(A)
    pok = do & (inv < A_next // 2)
    lchild = np.where(pok, 2 * inv, A_next)
    rchild = np.where(pok, 2 * inv + 1, A_next)
    n = len(slot)
    slot2, g2 = np.empty(n, np.int64), np.empty(n, np.int64)
    for i in range(n):
        s = slot[i]
        right = 0
        if s < A:
            right = int(do[s] and XbT[f_idx[s], i] > t_idx[s])
            slot2[i] = rchild[s] if right else lchild[s]
        else:
            slot2[i] = A_next
        g2[i] = 2 * g[i] + right
    gpos2 = np.zeros(A_next, np.int64)
    alive2 = np.zeros(A_next, bool)
    for a in np.nonzero(pok)[0]:
        gpos2[lchild[a]], gpos2[rchild[a]] = 2 * gpos[a], 2 * gpos[a] + 1
        alive2[lchild[a]] = alive2[rchild[a]] = True
    for a in range(A):
        if alive[a]:
            node = (1 << d) - 1 + gpos[a]
            feat[node] = f_idx[a] if do[a] else 0
            thr[node] = thr_v[a] if do[a] else np.inf
            gain[node] = gains[a] if do[a] else 0.0
            if not do[a]:
                leaf[gpos[a] << (D - d)] = tst[a]
        if do[a] and (not pok[a] or d == D - 1):
            sh = D - d - 1
            leaf[(2 * gpos[a]) << sh] = lst[a]
            leaf[(2 * gpos[a] + 1) << sh] = tst[a] - lst[a]
    even2 = None
    if node_even:
        even2 = np.where((slot2 < A_next) & (slot2 % 2 == 0), slot2 // 2,
                         A_next // 2)
    return (slot2, g2, even2, gpos2, alive2,
            np.asarray(order[:A_next // 2])), do, pok


def _level_inputs(rng, kind, A, nblk, d, n=400, F=5, B=8, Fb=6, ties=False):
    """Integer-valued f64 stats (every histogram sum exact), a 32-bin-like
    block of F columns and, with two blocks, a 0/1 block of Fb columns
    after it; the label reads both blocks. ``ties``: slot 1's rows are
    slot 0's rows again (identical histograms, identical gains)."""
    Xb = rng.integers(0, B, size=(F, n)).astype(np.int32)
    X01 = (rng.random((Fb, n)) < rng.uniform(0.1, 0.6, Fb)[:, None]
           ).astype(np.int32)
    y = ((X01[2] > 0) | (Xb[0] > B - 3)).astype(np.float64)
    if kind == "variance":
        w = rng.integers(1, 3, n).astype(np.float64)
        stats = np.stack([w, w * y, w * y * y, np.ones(n)], 1)
    else:
        h = rng.integers(1, 4, n).astype(np.float64)
        stats = np.stack([2 * y - 1, h, np.ones(n)], 1)
    slot = rng.integers(0, A + 1, n).astype(np.int32)
    if ties:
        slot[:n // 2] = np.where(slot[:n // 2] < 2, 2, slot[:n // 2])
        slot[n // 2:n // 2 + n // 4] = 0
        slot[n // 2 + n // 4:] = 1
        Xb[:, n // 2 + n // 4:] = Xb[:, n // 2:n // 2 + n // 4]
        X01[:, n // 2 + n // 4:] = X01[:, n // 2:n // 2 + n // 4]
        stats[n // 2 + n // 4:] = stats[n // 2:n // 2 + n // 4]
    st, nd = torch.tensor(stats), torch.tensor(slot)
    cums = [H.cumhist(st, nd, torch.tensor(Xb), A, B)]
    cols = [torch.arange(F)]
    XbT = Xb
    if nblk == 2:
        cums.append(H.cumhist_sparse01(st, nd, torch.tensor(X01), A))
        cols.append(torch.arange(F, F + Fb))
        XbT = np.concatenate([Xb, X01])
    score = torch.empty((nblk, A), dtype=torch.float64)
    idx = torch.empty((nblk, A), dtype=torch.int32)
    valid = torch.empty((nblk, A), dtype=torch.bool)
    for b, cumb in enumerate(cums):
        H.split_scan(cumb, kind, 3.0, lam=1.0, min_child_weight=1.0,
                     out=(score[b], idx[b], valid[b]))
    edges = np.sort(rng.normal(size=(XbT.shape[0], B - 1)), axis=1)
    alive = rng.random(A) > 0.25
    alive[:2] = True
    gpos = rng.permutation(1 << d)[:A].astype(np.int32)
    g = rng.integers(0, 1 << d, n).astype(np.int32)
    return (score, idx, valid, cums, cols, [False, True][:nblk],
            torch.tensor(edges), torch.tensor(alive), torch.tensor(gpos),
            torch.tensor(XbT.copy()), nd, torch.tensor(g))


def _each_tensor(args, fn):
    """``args`` with ``fn`` applied to every tensor, also inside lists."""
    return [[fn(t) if torch.is_tensor(t) else t for t in a]
            if isinstance(a, list) else fn(a) for a in args]


def _records(D, C):
    return (torch.zeros(1 << D, dtype=torch.int32),
            torch.full((1 << D,), np.inf, dtype=torch.float64),
            torch.zeros(1 << D, dtype=torch.float64),
            torch.zeros(((1 << D) + 1, C), dtype=torch.float64))


#: (kind, blocks, A, A_next, d, D, next level's sibling mask, split_ok,
#: min_info_gain, ties)
CASES = {
    # the unrolled driver's level: A_next = 2A, the sibling mask
    "unrolled": ("variance", 1, 8, 16, 3, 6, True, True, 0.0, False),
    "unrolled_xgb": ("xgb", 1, 8, 16, 3, 6, True, True, 0.0, False),
    # the constant-slot driver's level: A_next = A, no mask; more slots
    # split than the next level's A_next // 2 parents, so some splits
    # emit two leaves
    "constant_budget": ("variance", 1, 8, 8, 3, 6, False, True, 0.0, False),
    # two slots of identical histograms: equal gains, ranked by slot
    "gain_ties": ("variance", 1, 8, 16, 3, 6, True, True, 0.0, True),
    "depth_limit": ("variance", 2, 8, 16, 3, 6, True, False, 0.0, False),
    "last_level": ("variance", 2, 8, 16, 3, 4, False, True, 0.0, False),
    # the 2-bin block's winners store threshold 0.5
    "two_blocks": ("variance", 2, 16, 32, 4, 7, True, True, 0.0, False),
    "two_blocks_xgb": ("xgb", 2, 16, 16, 4, 7, False, True, 0.0, False),
    "nothing_splits": ("variance", 2, 8, 16, 3, 6, True, True, 1e30,
                       False),
    "one_slot": ("xgb", 2, 1, 2, 0, 4, True, True, 0.0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_epilogue_plain_matches_per_slot_loop(rng, case):
    kind, nblk, A, A_next, d, D, even, split_ok, mig, ties = CASES[case]
    args = _level_inputs(rng, kind, A, nblk, d, ties=ties)
    C = args[3][0].shape[1]
    lam = 1.0 if kind == "xgb" else 0.0
    mig_t = torch.clamp(torch.as_tensor(mig, dtype=torch.float64), min=1e-10)
    got_rec = _records(D, C)
    got = H.level_epilogue(*args, *got_rec, kind=kind, lam=lam, mig=mig_t,
                           d=d, max_depth=D, A_next=A_next,
                           split_ok=split_ok, node_even=even)
    want_rec = [r.numpy().copy() for r in _records(D, C)]
    want, do, pok = _epilogue_numpy(
        *_each_tensor(args, lambda t: t.numpy()), *want_rec, kind=kind,
        lam=lam, mig=mig, d=d, D=D,
        A_next=A_next, split_ok=split_ok, node_even=even)
    for name, a, b in zip(("slot", "g", "node_even", "gpos", "alive",
                           "rank"), got, want):
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    # the last entry of each record is a sink the plain version may write
    for name, a, b in zip(("feat", "thr", "gain", "leaf"), got_rec,
                          want_rec):
        np.testing.assert_array_equal(a.numpy()[:-1], b[:-1], err_msg=name)
    # each case reaches what it is named for
    score = args[0]
    if case.startswith("two_blocks"):
        assert (score[1] > score[0]).any() and (score[1] < score[0]).any()
        assert (got_rec[1].numpy() == 0.5).any(), "no 2-bin split recorded"
    if case in ("depth_limit", "nothing_splits"):
        assert not do.any() and got_rec[3].abs().sum() > 0
    else:
        assert do.any()
    if case == "constant_budget":
        assert (do & ~pok).any(), "every split kept its children"
    if case == "gain_ties":
        gains = got_rec[2].numpy()[(1 << d) - 1 + args[8].numpy()[:2]]
        assert do[0] and do[1] and gains[0] == gains[1]
        assert list(want[5]).index(0) < list(want[5]).index(1)
    if case == "last_level":
        assert d == D - 1


def _mixed(rng, n, F_cont, F_bin):
    Xc = rng.normal(size=(n, F_cont))
    Xbin = (rng.random((n, F_bin)) < rng.uniform(0.05, 0.5, F_bin)
            ).astype(np.float64)
    X = np.concatenate([Xbin[:, :2], Xc, Xbin[:, 2:]], axis=1)
    mask = np.array([True, True] + [False] * F_cont + [True] * (F_bin - 2))
    y = ((Xc[:, 0] > 0.2) ^ (Xbin[:, 0] > 0.5)
         | (Xbin[:, 3] > 0.5)).astype(np.float64)
    return X, y, mask


@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("kind", ["variance", "xgb"])
def test_grow_tree_two_blocks_matches_jax_exactly(rng, unroll, kind):
    """Integer-valued f64 stats: every histogram sum is exact, so the
    port's tree equals the JAX tree bit for bit."""
    n, B, D = 900, 32, 5
    X, y, mask = _mixed(rng, n, 3, 9)
    if kind == "variance":
        w = rng.integers(0, 3, n).astype(np.float64)
        r = 2 * y - 1 + rng.integers(-1, 2, n)
        stats = np.stack([w, w * r, w * r * r, (w > 0) * 1.0], 1)
        jcrit, pcrit = JT.VarianceCriterion(), PT.VarianceCriterion()
        jleaf, pleaf, mi, mig = JT.variance_leaf, PT.variance_leaf, 5.0, 1e-3
    else:
        stats = np.stack([2 * y - 1 + rng.integers(-1, 2, n),
                          rng.integers(1, 4, n) * 1.0, np.ones(n)], 1)
        jcrit = JT.XGBCriterion(1.0, jnp.asarray(1.0))
        pcrit = PT.XGBCriterion(1.0, 1.0)
        jleaf, pleaf, mi, mig = (JT.make_xgb_leaf(1.0), PT.make_xgb_leaf(1.0),
                                 0.0, -1e29)
    kw = dict(max_active_nodes=8, unroll=unroll,
              depth_limit=None if unroll else 4)
    Xb, edges = JT.compute_bins(jnp.asarray(X), B, mask)
    want = JT.grow_tree(Xb, edges, jnp.asarray(stats), jcrit, jleaf, D, B,
                        jnp.asarray(mi), jnp.asarray(mig),
                        col_blocks=JT.make_col_blocks(edges, B, mask), **kw)
    XbT, pedges = PT.compute_bins(torch.tensor(X), B, binary_mask=mask)
    got = PT.grow_tree(XbT, pedges, torch.tensor(stats), pcrit, pleaf, D, B,
                       mi, mig, blocks=PT.prepare_blocks(XbT, B, mask), **kw)
    for name, a, b in zip(("feat", "thr", "leaf", "node"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    if unroll:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    else:
        # the constant-slot driver's JAX level body is one compiled scan
        # body, in which XLA fuses the gain's operations and may round
        # them differently by an ulp; the splits above stay exact
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   rtol=1e-14, atol=0)
    thr = got[1].numpy()
    assert (thr == 0.5).any() and (np.isfinite(thr) & (thr != 0.5)).any()


@pytest.mark.cuda
def test_epilogue_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernels run only on the card")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    for case in sorted(CASES):
        kind, nblk, A, A_next, d, D, even, split_ok, mig, ties = CASES[case]
        args = _each_tensor(  # the kernel's float inputs are f32
            _level_inputs(rng, kind, A, nblk, d, n=3000, ties=ties),
            lambda t: t.to(dev, torch.float32) if t.is_floating_point()
            else t.to(dev))
        C = args[3][0].shape[1]
        kw = dict(kind=kind, lam=1.0 if kind == "xgb" else 0.0,
                  mig=torch.clamp(torch.tensor(mig), min=1e-10), d=d,
                  max_depth=D, A_next=A_next, split_ok=split_ok,
                  node_even=even)
        recs = [[r.to(dev, torch.float32) if r.is_floating_point()
                 else r.to(dev) for r in _records(D, C)] for _ in range(2)]
        got = H.level_epilogue(*args, *recs[0], **kw)
        want = H.level_epilogue_reference(*args, *recs[1], **kw)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b), case
        for a, b in zip(*recs):       # all but the sink entries
            assert torch.equal(a[:-1], b[:-1]), case
