"""Histogram-based decision-tree learning in PyTorch — the port of
``transmogrifai_tpu/models/_treefit.py`` (GBT and XGBoost fits and the
routed predict).

Features are quantile-binned once per fit (``n_bins=32``); a tree grows
level-wise: per level one ``cumhist`` builds the [slots, channels, bins,
features] cumulative histograms, ``split_scan`` picks each slot's best
(feature, threshold), and ``route_level`` moves every row to its child
slot (``models/_hist.py``; CUDA kernels on the card, plain versions on the
CPU). Nodes that stop splitting route their rows left through +inf
thresholds, so the fixed-depth layout stays exact.

Indicator columns (all values 0 or 1, ``binary_mask``) get a 2-bin block
of their own, as in the JAX package: per level each block gets its own
histogram (``cumhist`` for the quantile-binned block, ``cumhist_sparse01``
for the 0/1 block) and split scan, and the per-block winners merge on the
concatenated candidate axis (continuous block first). On the card, per
level one ``group_rows`` sorts the live rows by slot for every block's
histogram.

Two drivers share one level body, as in the JAX package: a constant
``cap`` slot count per level with a depth gate (``depth_limit``), and the
unrolled driver with per-level slot growth and sibling subtraction (each
right child's histogram is its parent's minus the left's), taken at
``UNROLL_MIN_ROWS`` rows and above (``models/trees.py``). Hyperparameters
are plain scalars and grid points a Python loop.

Tree layout: level-order ``feat``/``thr`` of length 2^D − 1 and ``leaf``
[2^D, K]; routing is ``node = 2·node + (x[feat] > thr)``.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import random as R
from ._hist import (cumhist, cumhist_sparse01, group_rows, hist_rows,
                    predict_trees, route_level, sparse01_rows, split_scan)

__all__ = ["quantile_bin_edges", "binarize", "compute_bins", "Block",
           "make_col_blocks", "prepare_blocks",
           "VarianceCriterion", "XGBCriterion", "variance_leaf",
           "make_xgb_leaf", "grow_tree", "fit_gbt", "fit_xgb",
           "predict_ensemble", "margin_head",
           "predict_margin_classification", "predict_margin_regression",
           "QUANTILE_SAMPLE_ROWS"]

_EPS = 1e-12

#: rows used for the quantile sketch at large n
QUANTILE_SAMPLE_ROWS = 262_144
#: fixed key of the quantile-sketch row permutation
_QUANTILE_SEED = 0x51EED


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once. f32 goes through f64, where a·b is exact;
    f64 takes Dekker's exact product p + e = a·b and a two-sum of p + c."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    split = 134217729.0                                    # 2^27 + 1
    p = a * b
    ah = a * split - (a * split - a)
    bh = b * split - (b * split - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    v = s - p
    return s + (((p - (s - v)) + (c - v)) + e)


def quantile_bin_edges(X: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-feature interior quantile edges → [F, n_bins − 1].

    ``jnp.quantile``'s linear method, step by step (sort, ``q·(m−1)``,
    floor/ceil, ``lo·(1−w) + hi·w``) in X's dtype, so the edges — and the
    bins — equal the JAX package's. XLA contracts the interpolation into
    one fused multiply-add, ``fma(lo, 1−w, hi·w)``; so does this. Beyond
    ``QUANTILE_SAMPLE_ROWS`` rows the sketch reads a strided prefix of the
    fixed-key threefry permutation, bit-exact with
    ``jax.random.permutation``."""
    n = X.shape[0]
    stride = max(1, -(-n // QUANTILE_SAMPLE_ROWS))
    if stride > 1:
        perm = R.permutation(R.PRNGKey(_QUANTILE_SEED), n)[:-(-n // stride)]
        X = X[torch.from_numpy(perm).to(X.device)]
    m = X.shape[0]
    q = torch.from_numpy(np.linspace(0.0, 1.0, n_bins + 1)[1:-1]).to(
        device=X.device, dtype=X.dtype) * float(m - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    w_lo = 1.0 - w_hi
    Xs = torch.sort(X, dim=0).values
    v_lo = Xs[lo.clamp(0, m - 1).long()]                   # [Q, F]
    v_hi = Xs[hi.clamp(0, m - 1).long()]
    w_lo, w_hi = w_lo[:, None].expand_as(v_lo), w_hi[:, None]
    return _fma(v_lo, w_lo, v_hi * w_hi).t().contiguous()


def binarize(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """bin[i, f] = #{edges[f] < x[i, f]} ∈ [0, n_bins−1] (int32); bin ≤ t
    ⟺ x ≤ edges[f, t], the stored split threshold."""
    return (X[:, :, None] > edges[None, :, :]).sum(2, dtype=torch.int32)


def _mask_or_none(binary_mask) -> Optional[np.ndarray]:
    if binary_mask is None or not np.asarray(binary_mask).any():
        return None
    return np.asarray(binary_mask, bool)


def compute_bins(X: torch.Tensor, n_bins: int, binary_mask=None):
    """[n, F] reals → (XbT [F, n] int32, edges [F, n_bins − 1]): the bins
    in the feature-major layout the kernels stream. Indicator columns
    (host-side [F] bool ``binary_mask``) are rebinned to ``x > 0.5``, so
    routing's ``bin > t`` works with their block-local threshold index 0
    (``_treefit.compute_bins`` of the JAX package)."""
    edges = quantile_bin_edges(X, n_bins)
    Xb = binarize(X, edges)
    bm = _mask_or_none(binary_mask)
    if bm is not None:
        Xb = torch.where(torch.from_numpy(bm).to(X.device)[None, :],
                         (X > 0.5).to(torch.int32), Xb)
    return Xb.t().contiguous(), edges


class Block(NamedTuple):
    """One histogram block of the feature axis: ``cols`` [Fb] global
    column indices (int64, on the fit's device), ``n_bins``, the block's
    [Fb, n] bin matrix ``mat`` (int32 bins, or the uint8 0/1 matrix of a
    2-bin indicator block), ``sparse01`` (the indicator block, whose
    stored threshold is 0.5) and, on the card, ``rows``: the row-major
    uint8 copy the histogram kernel gathers rows from (``hist_rows`` /
    ``sparse01_rows``; None on the CPU, whose plain versions read
    ``mat``)."""

    cols: torch.Tensor
    n_bins: int
    mat: torch.Tensor
    sparse01: bool
    rows: Optional[torch.Tensor] = None


def make_col_blocks(n_features: int, n_bins: int, binary_mask=None
                    ) -> List[tuple]:
    """(column indices, bins, indicator block?) per block: the continuous
    block first (if any), then the 2-bin block of the indicator columns —
    the JAX package's ``make_col_blocks`` order, which fixes the candidate
    axis."""
    bm = _mask_or_none(binary_mask)
    if bm is None:
        return [(np.arange(n_features), n_bins, False)]
    cont = np.nonzero(~bm)[0]
    return ([(cont, n_bins, False)] if len(cont) else []) \
        + [(np.nonzero(bm)[0], 2, True)]


def prepare_blocks(XbT: torch.Tensor, n_bins: int, binary_mask=None
                   ) -> List[Block]:
    """The blocks of one fit, extracted once from the full [F, n] bins:
    the indicator block is stored as uint8 (its bins are 0 or 1); a
    single continuous block is ``XbT`` itself. On the card each block
    also gets its row-major uint8 copy, once per fit."""
    F = XbT.shape[0]
    on_card = XbT.device.type != "cpu"
    out = []
    for cols, nb, indicator in make_col_blocks(F, n_bins, binary_mask):
        idx = torch.from_numpy(cols).to(XbT.device)
        mat = XbT if len(cols) == F else XbT.index_select(0, idx)
        if indicator:
            mat = mat.to(torch.uint8)
        rows = None
        if on_card:
            rows = sparse01_rows(mat) if indicator else hist_rows(mat)
        out.append(Block(idx, nb, mat, indicator, rows))
    return out


# ---------------------------------------------------------------------------
# Split criteria: ``kernel_kind`` names split_scan's inlined score; ``gain``
# is the exact gain at the winner's [A, C] left / total stats.
# ---------------------------------------------------------------------------

class VarianceCriterion:
    """Spark Variance impurity. Channels: (w, w·y, w·y², count)."""

    kernel_kind = "variance"

    def kernel_params(self):
        return 0.0, None            # (lam, min_child_weight)

    def gain(self, l, t):
        def imp(w, s1, s2):
            w = torch.clamp(w, min=_EPS)
            return s2 / w - (s1 / w) ** 2
        W = torch.clamp(t[:, 0], min=_EPS)
        wL, wR = l[:, 0], t[:, 0] - l[:, 0]
        return imp(t[:, 0], t[:, 1], t[:, 2]) \
            - (wL / W) * imp(wL, l[:, 1], l[:, 2]) \
            - (wR / W) * imp(wR, t[:, 1] - l[:, 1], t[:, 2] - l[:, 2])


def variance_leaf(s):
    """Weighted mean target → [1]."""
    return (s[..., 1] / torch.clamp(s[..., 0], min=_EPS))[..., None]


class XGBCriterion:
    """XGBoost gain ½(G_L²/(H_L+λ) + G_R²/(H_R+λ) − G²/(H+λ)).
    Channels: (g, h, count); min_child_weight bounds the hessian mass."""

    kernel_kind = "xgb"

    def __init__(self, lam: float, min_child_weight):
        self.lam = lam
        self.min_child_weight = min_child_weight

    def kernel_params(self):
        return float(self.lam), self.min_child_weight

    def gain(self, l, t):
        def s(g, h):
            return g * g / (h + self.lam + _EPS)
        return 0.5 * (s(l[:, 0], l[:, 1])
                      + s(t[:, 0] - l[:, 0], t[:, 1] - l[:, 1])
                      - s(t[:, 0], t[:, 1]))


def make_xgb_leaf(lam: float):
    def leaf(s):
        return (-s[..., 0] / (s[..., 1] + lam + _EPS))[..., None]
    return leaf


# ---------------------------------------------------------------------------
# Level-wise tree growing
# ---------------------------------------------------------------------------

def grow_tree(XbT: torch.Tensor, edges: torch.Tensor, stats: torch.Tensor,
              crit, leaf_fn: Callable, max_depth: int, n_bins: int,
              min_instances, min_info_gain, depth_limit: Optional[int] = None,
              max_active_nodes: int = 128, unroll: bool = False,
              blocks: Optional[List[Block]] = None):
    """Grow one tree level-wise over [F, n] bins; returns (feat [2^D−1]
    int32, thr [2^D−1], leaf [2^D, K], node [n] final sample→leaf index,
    gain [2^D−1]).

    ``blocks`` (:func:`prepare_blocks`; default one block of every
    column) partition the features into histogram blocks. Each block's
    winner is a flat index ``t·Fb + f`` inside it; the blocks' candidates
    concatenate in order (offsets ``(nb−1)·Fb``), and the level takes the
    highest score, ties to the lower concatenated index — what one argmax
    over the concatenation picks. Routing reads the full ``XbT``.

    At most ``cap = min(max_active_nodes, 2^(D−1))`` live nodes per level
    (ranked by split gain); ``depth_limit`` stops splitting past that
    level while the loop runs to ``max_depth``. ``unroll`` takes per-level
    slot counts ``min(2^d, cap)`` and sibling subtraction.

    The histograms read the bins themselves: the JAX package precomputes
    the ``bin ≤ t`` indicator when it fits (``prepare_blocks``), but on
    the H100 the kernel builds it from the bins faster than it reads the
    precomputed one (``PERF.md``), so no fit passes ``bc``."""
    n = XbT.shape[1]
    dev, dt = stats.device, stats.dtype
    C, D = stats.shape[1], max_depth
    if blocks is None:
        blocks = prepare_blocks(XbT, n_bins)
    cap = max(2, min(max_active_nodes, 1 << max(D - 1, 1)))
    if unroll:
        cap -= cap % 2      # sibling interleave pairs child slots
    total_nodes = (1 << D) - 1
    n_leaves = 1 << D
    lam, mcw = crit.kernel_params()
    mig = torch.clamp(torch.as_tensor(min_info_gain, dtype=dt, device=dev),
                      min=1e-10)
    i32 = dict(dtype=torch.int32, device=dev)

    def hist(blk, node, a, groups):
        if blk.sparse01:
            return cumhist_sparse01(stats, node, blk.mat, a, groups=groups,
                                    rows=blk.rows)
        return cumhist(stats, node, blk.mat, a, blk.n_bins, groups=groups,
                       rows=blk.rows)

    def level(d, A, A_next, slot, g, gpos, alive, feat, thr, gain, leafS,
              prev):
        # the card's kernels read the live rows grouped by slot, once a
        # level for every block; the CPU's plain versions need no grouping
        grouped = dev.type != "cpu"
        groups = None
        if prev is not None:
            # left children live in the even slots; each right sibling is
            # its parent's histogram minus the left one, per block
            half = A // 2
            node_even = torch.where((slot < A) & (slot % 2 == 0), slot // 2,
                                    torch.full_like(slot, half))
            if grouped:
                groups = group_rows(node_even, half)
        elif grouped:
            groups = group_rows(slot, A)
        cums = []
        off = 0
        for bi, blk in enumerate(blocks):
            if prev is not None:
                ev = hist(blk, node_even, half, groups)
                parent = prev[0][bi][prev[1]]
                cumb = torch.stack([ev, parent - ev], dim=1).reshape(
                    (A,) + ev.shape[1:])
            else:
                cumb = hist(blk, slot, A, groups)
            s_b, i_b, v_b = split_scan(cumb, crit.kernel_kind,
                                       min_instances, lam=lam,
                                       min_child_weight=mcw)
            gi = off + i_b.long()
            if not cums:
                score, best, valid = s_b, gi, v_b
            else:
                take = (s_b > score) | ((s_b == score) & (gi < best))
                best = torch.where(take, gi, best)
                valid = torch.where(take, v_b, valid)
                score = torch.where(take, s_b, score)
            cums.append(cumb)
            off += (blk.n_bins - 1) * len(blk.cols)
        # decode the winner in its block (later blocks override where the
        # winner lies in them); the exact gain is taken at the winner's
        # [A, C] left / total stats
        off = 0
        for bi, (blk, cumb) in enumerate(zip(blocks, cums)):
            fb_n = len(blk.cols)
            size = (blk.n_bins - 1) * fb_n
            local = best - off
            if len(blocks) > 1:
                local = torch.clamp(local, 0, size - 1)
            fg = blk.cols[local % fb_n]
            tb = local // fb_n
            thr_b = (torch.full((A,), 0.5, dtype=edges.dtype, device=dev)
                     if blk.sparse01 else edges[fg, tb])
            lb = cumb[:, :, :-1, :].reshape(A, C, size).gather(
                2, local[:, None, None].expand(A, C, 1))[:, :, 0]
            if bi == 0:
                f_idx, t_idx, thr_v, lstats = fg, tb, thr_b, lb
            else:
                inb = best >= off
                f_idx = torch.where(inb, fg, f_idx)
                t_idx = torch.where(inb, tb, t_idx)
                thr_v = torch.where(inb, thr_b, thr_v)
                lstats = torch.where(inb[:, None], lb, lstats)
            off += size
        f_idx, t_idx = f_idx.to(torch.int32), t_idx.to(torch.int32)
        tstats = cums[0][:, :, -1, 0]
        best_gain = crit.gain(lstats, tstats)
        do_split = alive & valid & (best_gain >= mig)
        if depth_limit is not None and d >= depth_limit:
            do_split = torch.zeros_like(do_split)
        f_idx = torch.where(do_split, f_idx, torch.zeros_like(f_idx))
        thr_rec = torch.where(do_split, thr_v,
                              torch.full_like(thr_v, float("inf")))

        # next level: rank splitting slots by gain, allocate child slots
        rank = torch.argsort(torch.where(
            do_split, -best_gain, torch.full_like(best_gain, float("inf"))),
            stable=True)
        inv = torch.empty((A,), **i32)
        inv[rank] = torch.arange(A, **i32)
        parent_ok = do_split & (inv < A_next // 2)
        sink = torch.full_like(inv, A_next)
        lchild = torch.where(parent_ok, 2 * inv, sink)
        rchild = torch.where(parent_ok, 2 * inv + 1, sink)
        slot2, g2 = route_level(XbT, slot, g, f_idx, t_idx, lchild, rchild,
                                do_split, A, A_next)
        # index A_next / total_nodes / n_leaves is a dropped sink entry
        gpos2 = torch.zeros((A_next + 1,), **i32)
        gpos2[lchild.long()] = 2 * gpos
        gpos2[rchild.long()] = 2 * gpos + 1
        alive2 = torch.zeros((A_next + 1,), dtype=torch.bool, device=dev)
        alive2[lchild.long()] = parent_ok
        alive2[rchild.long()] = parent_ok

        # record splits: node (d, j) lives at flat index (2^d − 1) + j
        idx = torch.where(alive, (1 << d) - 1 + gpos,
                          torch.full_like(gpos, total_nodes)).long()
        feat[idx] = f_idx
        thr[idx] = thr_rec
        gain[idx] = torch.where(do_split, best_gain,
                                torch.zeros_like(best_gain))
        # leaf stats: a node that stops splitting is a leaf over the
        # g-range [gpos << (D−d), …); a split whose children leave the
        # slot budget or that happens at the last level emits two leaves
        dying = alive & ~do_split
        no_leaf = torch.full_like(gpos, n_leaves)
        leafS[torch.where(dying, gpos << (D - d), no_leaf).long()] = tstats
        emit = do_split & (~parent_ok | (d == D - 1))
        sh = D - d - 1
        li = torch.where(emit, (2 * gpos) << sh, no_leaf).long()
        ri = torch.where(emit, (2 * gpos + 1) << sh, no_leaf).long()
        leafS[li] = lstats
        leafS[ri] = tstats - lstats
        return (slot2, g2, gpos2[:A_next], alive2[:A_next],
                (cums, rank[:A_next // 2]))

    feat = torch.zeros((total_nodes + 1,), **i32)
    thr = torch.full((total_nodes + 1,), float("inf"), dtype=edges.dtype,
                     device=dev)
    gain = torch.zeros((total_nodes + 1,), dtype=dt, device=dev)
    leafS = torch.zeros((n_leaves + 1, C), dtype=dt, device=dev)
    slot = torch.zeros((n,), **i32)
    g = torch.zeros((n,), **i32)
    prev = None
    if unroll:
        gpos = torch.zeros((1,), **i32)
        alive = torch.ones((1,), dtype=torch.bool, device=dev)
        for d in range(D):
            A, A_next = min(1 << d, cap), min(1 << (d + 1), cap)
            slot, g, gpos, alive, prev = level(
                d, A, A_next, slot, g, gpos, alive, feat, thr, gain, leafS,
                prev)
    else:
        gpos = torch.zeros((cap,), **i32)
        alive = torch.arange(cap, device=dev) == 0
        for d in range(D):
            slot, g, gpos, alive, _ = level(
                d, cap, cap, slot, g, gpos, alive, feat, thr, gain, leafS,
                None)
    return (feat[:total_nodes], thr[:total_nodes],
            leaf_fn(leafS[:n_leaves]), g, gain[:total_nodes])


# ---------------------------------------------------------------------------
# Boosting
# ---------------------------------------------------------------------------

def _boost(X, y, w, n_rounds, max_depth, n_bins, num_rounds_used, shrink,
           stats_of, crit, leaf_fn, min_instances, min_info_gain,
           depth_limit, max_active_nodes, binary_mask, prebinned, unroll):
    if prebinned is None:
        XbT, edges = compute_bins(X, n_bins, binary_mask)
        blocks = prepare_blocks(XbT, n_bins, binary_mask)
    else:
        XbT, edges, blocks = prebinned
    dt = w.dtype
    shrink = torch.as_tensor(shrink, dtype=dt, device=w.device)
    Fm = torch.zeros_like(w)
    feats, thrs, leaves, gains = [], [], [], []
    for t in range(n_rounds):
        feat, thr, leaf, node, gain = grow_tree(
            XbT, edges, stats_of(Fm), crit, leaf_fn, max_depth, n_bins,
            min_instances, min_info_gain, depth_limit=depth_limit,
            max_active_nodes=max_active_nodes, unroll=unroll, blocks=blocks)
        use = 1.0 if t < float(num_rounds_used) else 0.0
        scale = use * shrink
        Fm = Fm + scale * leaf[node.long()][:, 0]
        feats.append(feat)
        thrs.append(thr)
        leaves.append(leaf * scale)
        gains.append(gain * use)
    return {"feat": torch.stack(feats), "thr": torch.stack(thrs),
            "leaf": torch.stack(leaves),
            "tree_w": torch.ones((n_rounds,), dtype=dt, device=w.device),
            "train_margin": Fm, "gain": torch.stack(gains)}


def fit_gbt(X, y, w, *, task: str, n_rounds: int, max_depth: int,
            n_bins: int, min_instances, min_info_gain, step_size,
            num_rounds_used, depth_limit: Optional[int] = None,
            max_active_nodes: int = 128, binary_mask=None, prebinned=None,
            unroll: bool = False):
    """Spark-style GBT: each round fits a weighted regression tree to the
    pseudo-residuals; classification uses logloss on y' ∈ {−1, +1} with
    margin F, prob = σ(2F). ``binary_mask`` marks indicator columns
    (2-bin block); ``prebinned`` is (XbT, edges, blocks) from
    :func:`compute_bins` and :func:`prepare_blocks`."""
    dt = w.dtype
    ypm = 2.0 * y - 1.0
    cnt = (w > 0).to(dt)

    def stats_of(Fm):
        r = (2.0 * ypm / (1.0 + torch.exp(2.0 * ypm * Fm))
             if task == "classification" else y - Fm)
        return torch.stack([w, w * r, w * r * r, cnt], dim=1)
    return _boost(X, y, w, n_rounds, max_depth, n_bins, num_rounds_used,
                  step_size, stats_of, VarianceCriterion(), variance_leaf,
                  min_instances, min_info_gain, depth_limit,
                  max_active_nodes, binary_mask, prebinned, unroll)


def fit_xgb(X, y, w, *, task: str, n_rounds: int, max_depth: int,
            n_bins: int, eta, lam: float, min_child_weight, num_rounds_used,
            depth_limit: Optional[int] = None, max_active_nodes: int = 128,
            binary_mask=None, prebinned=None, unroll: bool = False):
    """Second-order boosting: g/h of the logistic (classification) or
    squared loss; leaf = −G/(H+λ)."""
    dt = w.dtype
    cnt = (w > 0).to(dt)

    def stats_of(Fm):
        if task == "classification":
            p = torch.sigmoid(Fm)
            g, h = w * (p - y), w * torch.clamp(p * (1.0 - p), min=1e-6)
        else:
            g, h = w * (Fm - y), w
        return torch.stack([g, h, cnt], dim=1)
    return _boost(X, y, w, n_rounds, max_depth, n_bins, num_rounds_used,
                  eta, stats_of, XGBCriterion(lam, min_child_weight),
                  make_xgb_leaf(lam), 0.0, -1e29, depth_limit,
                  max_active_nodes, binary_mask, prebinned, unroll)


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def predict_ensemble(feat, thr, leaf, tree_w, X, max_depth: int):
    """Weighted sum over [T, …] stacked trees → [n, K]
    (``predict_trees``: the kernel on the card, the plain version on the
    CPU)."""
    return predict_trees(X.contiguous(), feat, thr,
                         leaf * tree_w[:, None, None], max_depth)


def margin_head(m, margin_scale: float, dtype, task: str):
    """[n] boosted margin → (prediction, raw, probability). GBT uses
    prob = σ(2F), XGB σ(F)."""
    if task == "classification":
        p1 = torch.sigmoid(margin_scale * m)
        prob = torch.stack([1.0 - p1, p1], dim=1)
        raw = torch.stack([-m, m], dim=1)
        return (p1 > 0.5).to(dtype), raw, prob
    empty = torch.zeros((m.shape[0], 0), dtype=dtype, device=m.device)
    return m, empty, empty


def predict_margin_classification(params, X, max_depth: int,
                                  margin_scale: float = 1.0):
    """GBT (margin_scale=2) and XGB (=1) binary heads."""
    m = predict_ensemble(params["feat"], params["thr"], params["leaf"],
                         params["tree_w"], X, max_depth)[:, 0]
    return margin_head(m, margin_scale, X.dtype, "classification")


def predict_margin_regression(params, X, max_depth: int):
    m = predict_ensemble(params["feat"], params["thr"], params["leaf"],
                         params["tree_w"], X, max_depth)[:, 0]
    return margin_head(m, 1.0, X.dtype, "regression")
