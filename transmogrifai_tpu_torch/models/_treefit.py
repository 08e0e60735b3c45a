"""Histogram-based decision-tree learning in PyTorch — the port of
``transmogrifai_tpu/models/_treefit.py`` (random forests and decision
trees, GBT and XGBoost fits, and the routed predict).

Features are quantile-binned once per fit (``n_bins=32``); a tree grows
level-wise: per level one ``cumhist`` builds the [slots, channels, bins,
features] cumulative histograms, ``split_scan`` picks each slot's best
(feature, threshold), and ``level_epilogue`` does the rest of the level in
one launch: the exact gains, the split decisions, the gain ranking and
child slots, the node and leaf records, and every row moved to its child
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

Random forests draw their randomness as the JAX package does, bit for bit
(``random.py``): a Poisson(rate) bootstrap weight per row and tree from
``fold_in(k_boot, tree)``, and per node exactly k candidate features from
``fold_in(tree key, level)``. Those keys depend on the family's seed and
the tree alone, never on the fold or the grid point, so a sweep draws each
tree's uniforms once (:func:`forest_draws`) and every fit of the sweep
reads them; the per-node masks are made per block up front, so a level
takes its mask as a view and adds no launch.

Tree layout: level-order ``feat``/``thr`` of length 2^D − 1 and ``leaf``
[2^D, K]; routing is ``node = 2·node + (x[feat] > thr)``.

Over a mesh of ranks (:func:`tree_mesh_scope`, ``parallel/mesh.py``) a fit
takes the whole input on every rank and works on its own rows: the bin
edges come from all rows, the forests' bootstrap uniforms are drawn for
all rows and sliced; each rank builds a level's histograms over its rows
and sums them over the ``data`` group before the split scan and the
sibling subtraction (the xgboost/Rabit histogram all-reduce), and routes
its own rows. Under ``featureShards`` (:func:`set_feature_shards`, when
the mesh's ``grid`` axis equals it) each grid rank also takes one
contiguous chunk of every block's columns, zero-padded to equal width
with the pads masked, and the chunks' winners merge across the ``grid``
group (score desc, global index asc); the level epilogue then reads the
winner's stats from that merge (``win_stats``), since a rank holds only
its chunk's histograms. Every rank ends a level with the same records.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import random as R
from ..parallel import mesh as _mesh
from .base import score_sigmoid
from ._hist import (MAX_CARD_CHANNELS, cumhist,
                    cumhist_sparse01, group_rows, hist_rows, level_epilogue,
                    predict_trees, sparse01_rows, split_scan)

__all__ = ["tree_mesh_scope", "active_tree_mesh", "set_feature_shards",
           "feature_shards_scope", "active_feature_shards", "RowShard",
           "row_shard", "quantile_bin_edges", "binarize", "compute_bins",
           "Block",
           "make_col_blocks", "prepare_blocks",
           "VarianceCriterion", "GiniCriterion", "XGBCriterion",
           "variance_leaf", "gini_leaf", "make_xgb_leaf", "grow_tree",
           "poisson_bootstrap_weights", "feature_masks",
           "node_feature_uniforms", "ForestDraws", "forest_draws",
           "forest_k", "fit_forest", "fit_gbt", "fit_xgb",
           "check_card_classes",
           "predict_ensemble", "rf_head", "rf_train_aggregate",
           "margin_head", "slot_cap",
           "predict_rf_classification", "predict_rf_regression",
           "predict_margin_classification", "predict_margin_regression",
           "QUANTILE_SAMPLE_ROWS"]

_EPS = 1e-12

#: rows used for the quantile sketch at large n
QUANTILE_SAMPLE_ROWS = 262_144
#: fixed key of the quantile-sketch row permutation
_QUANTILE_SEED = 0x51EED


# ---------------------------------------------------------------------------
# The mesh: row shards and column chunks
# ---------------------------------------------------------------------------

#: requested column shard count (1 = off); engages only when the active
#: tree mesh's ``grid`` axis equals it (:func:`_feature_shard_count`)
_FEATURE_SHARDS = [1]


def set_feature_shards(n: int) -> int:
    """Install the requested column shard count (1 = off); returns the
    previous value (the runner's ``featureShards`` restores it)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"feature shards must be >= 1, got {n}")
    prev = _FEATURE_SHARDS[0]
    _FEATURE_SHARDS[0] = n
    return prev


@contextlib.contextmanager
def feature_shards_scope(n: int):
    """Scoped :func:`set_feature_shards`."""
    prev = set_feature_shards(n)
    try:
        yield
    finally:
        _FEATURE_SHARDS[0] = prev


def active_feature_shards() -> int:
    """The requested column shard count (1 = off)."""
    return _FEATURE_SHARDS[0]


def tree_mesh_scope(mesh):
    """The block's tree fits shard over ``mesh`` (``mesh.sharded_scope``;
    None, ``False`` and the degenerate mesh keep the single-process
    path). Re-entrant; the previous scope is restored on exit."""
    return _mesh.sharded_scope(mesh)


def active_tree_mesh():
    """The mesh of :func:`tree_mesh_scope` (never a one-rank mesh), or
    None."""
    return _mesh.active_sharded_mesh()


def _feature_shard_count() -> int:
    """The column shard count G of a fit now, or 1: ``featureShards`` > 1
    and an active tree mesh whose ``grid`` axis is exactly G. Anything
    else keeps whole blocks, so a stale request over another mesh cannot
    mis-shard."""
    req = int(_FEATURE_SHARDS[0])
    mesh = active_tree_mesh()
    if req <= 1 or mesh is None or mesh.shape["grid"] != req:
        return 1
    return req


class RowShard(NamedTuple):
    """A fit's rows over a mesh: ``n`` rows in all, this rank's
    ``data_sharding`` of them (zero-weight padding past ``n``)."""

    mesh: object
    n: int

    def take(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of a whole-input tensor (rows on ``axis``)."""
        return _mesh.local_rows(self.mesh, t, axis)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole [n, ...] from every rank's rows of it."""
        return _mesh.gather_rows(self.mesh, t, self.n)


def row_shard(n: int) -> Optional[RowShard]:
    """The row shard of an ``n``-row fit under the active tree mesh, or
    None (one process, or a mesh of one rank on its ``data`` axis)."""
    mesh = active_tree_mesh()
    if mesh is None or mesh.shape["data"] <= 1:
        return None
    return RowShard(mesh, int(n))


def _hist_sums(hs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A level's histograms (one a block) of this rank's rows summed over
    the ``data`` group in one all-reduce (every rank gets the same
    bits)."""
    mesh = active_tree_mesh()
    if mesh is None or mesh.group("data") is None:
        return hs
    flat = _mesh.all_reduce(torch.cat([h.reshape(-1) for h in hs]), mesh,
                            "data")
    return [p.reshape(h.shape) for p, h in zip(
        flat.split([h.numel() for h in hs]), hs)]


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
    Xs = torch.sort(X, dim=0).values  # lint: sort — values only: equal keys are equal values, so order cannot show
    v_lo = Xs[lo.clamp(0, m - 1).long()]                   # [Q, F]
    v_hi = Xs[hi.clamp(0, m - 1).long()]
    w_lo, w_hi = w_lo[:, None].expand_as(v_lo), w_hi[:, None]
    return _fma(v_lo, w_lo, v_hi * w_hi).t().contiguous()


#: bytes of the [rows, F, bins] comparison :func:`binarize` holds at once
#: (a million rows of a 451-wide vector would take ~50 GB in one piece)
BINARIZE_CHUNK_BYTES = 1 << 30


def binarize(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """bin[i, f] = #{edges[f] < x[i, f]} ∈ [0, n_bins−1] (int32); bin ≤ t
    ⟺ x ≤ edges[f, t], the stored split threshold. Rows go in chunks of
    at most ``BINARIZE_CHUNK_BYTES`` of comparisons (the counts are
    exact, so the chunking changes no bin)."""
    n, f = X.shape
    step = max(1, BINARIZE_CHUNK_BYTES // max(1, 4 * f * edges.shape[1]))
    if n <= step:
        return (X[:, :, None] > edges[None, :, :]).sum(2, dtype=torch.int32)
    out = torch.empty((n, f), dtype=torch.int32, device=X.device)
    for lo in range(0, n, step):
        out[lo:lo + step] = (X[lo:lo + step, :, None]
                             > edges[None, :, :]).sum(2, dtype=torch.int32)
    return out


def _mask_or_none(binary_mask) -> Optional[np.ndarray]:
    if binary_mask is None or not np.asarray(binary_mask).any():
        return None
    return np.asarray(binary_mask, bool)


def compute_bins(X: torch.Tensor, n_bins: int, binary_mask=None,
                 shard: Optional[RowShard] = None):
    """[n, F] reals → (XbT [F, n] int32, edges [F, n_bins − 1]): the bins
    in the feature-major layout the kernels stream. Indicator columns
    (host-side [F] bool ``binary_mask``) are rebinned to ``x > 0.5``, so
    routing's ``bin > t`` works with their block-local threshold index 0
    (``_treefit.compute_bins`` of the JAX package). With ``shard`` the
    edges come from all of X and the bins are this rank's rows'."""
    edges = quantile_bin_edges(X, n_bins)
    if shard is not None:
        X = shard.take(X)
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
    ``mat``).

    Under ``featureShards`` G > 1 (``shards``) ``mat`` holds this grid
    rank's chunk: columns ``cols[lo:lo + real]`` of the block, zero rows
    up to the chunk width ``ceil(Fb / G)``; ``cols`` stays the block's."""

    cols: torch.Tensor
    n_bins: int
    mat: torch.Tensor
    sparse01: bool
    rows: Optional[torch.Tensor] = None
    shards: int = 1
    lo: int = 0
    real: int = 0


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
    also gets its row-major uint8 copy, once per fit. Under
    ``featureShards`` (:func:`_feature_shard_count`) each block is this
    grid rank's column chunk."""
    F = XbT.shape[0]
    on_card = XbT.device.type != "cpu"
    G = _feature_shard_count()
    s = active_tree_mesh().axis_index("grid") if G > 1 else 0
    out = []
    for cols, nb, indicator in make_col_blocks(F, n_bins, binary_mask):
        idx = torch.from_numpy(cols).to(XbT.device)
        lo = real = 0
        if G > 1:
            Flg = -(-len(cols) // G)
            lo = min(s * Flg, len(cols))
            real = min(len(cols) - lo, Flg)
            mat = torch.zeros((Flg, XbT.shape[1]), dtype=XbT.dtype,
                              device=XbT.device)
            mat[:real] = XbT.index_select(0, idx[lo:lo + real])
        else:
            mat = XbT if len(cols) == F else XbT.index_select(0, idx)
        if indicator:
            mat = mat.to(torch.uint8)
        rows = None
        if on_card:
            rows = sparse01_rows(mat) if indicator else hist_rows(mat)
        out.append(Block(idx, nb, mat, indicator, rows, G, lo, real))
    return out


# ---------------------------------------------------------------------------
# Split criteria: ``kernel_kind`` names split_scan's inlined score and the
# level epilogue's exact gain (``_hist.split_gain``).
# ---------------------------------------------------------------------------

class VarianceCriterion:
    """Spark Variance impurity. Channels: (w, w·y, w·y², count)."""

    kernel_kind = "variance"

    def kernel_params(self):
        return 0.0, None            # (lam, min_child_weight)


def variance_leaf(s):
    """Weighted mean target → [1]."""
    return (s[..., 1] / torch.clamp(s[..., 0], min=_EPS))[..., None]


class GiniCriterion:
    """Spark Gini impurity. Channels: (per-class weight …, count)."""

    kernel_kind = "gini"

    def kernel_params(self):
        return 0.0, None


def gini_leaf(s):
    """Per-class probabilities → [K]."""
    cls = s[..., :-1]
    return cls / torch.clamp(cls.sum(-1, keepdim=True), min=_EPS)


class XGBCriterion:
    """XGBoost gain ½(G_L²/(H_L+λ) + G_R²/(H_R+λ) − G²/(H+λ)).
    Channels: (g, h, count); min_child_weight bounds the hessian mass."""

    kernel_kind = "xgb"

    def __init__(self, lam: float, min_child_weight):
        self.lam = lam
        self.min_child_weight = min_child_weight

    def kernel_params(self):
        return float(self.lam), self.min_child_weight


def make_xgb_leaf(lam: float):
    def leaf(s):
        return (-s[..., 0] / (s[..., 1] + lam + _EPS))[..., None]
    return leaf


# ---------------------------------------------------------------------------
# Level-wise tree growing
# ---------------------------------------------------------------------------

def slot_cap(max_depth: int, max_active_nodes: int, unroll: bool) -> int:
    """Live slots a level holds at most: ``min(max_active_nodes,
    2^(D−1))``, even in the unrolled driver (sibling pairs)."""
    cap = max(2, min(max_active_nodes, 1 << max(max_depth - 1, 1)))
    return cap - cap % 2 if unroll else cap


def _merge_chunks(score, idx, valid, cums, G: int, s: int, C: int):
    """The column chunks' split-scan winners of one level merged across
    the ``grid`` group. ``score`` / ``idx`` / ``valid`` [blocks, A] hold
    this rank's chunk winners (``idx`` local, t·Flg + f). Returns the
    per-block winners over the whole block — index in the block's padded
    candidate axis t·(G·Flg) + s·Flg + f, score desc then index asc, as
    one scan over the unsharded block picks — and ``win_stats`` [2, A,
    C]: the overall winner's left stats (blocks merged as the epilogue
    merges them) and the slot totals (grid rank 0's first column, the
    lane the unsharded level reads)."""
    nblk, A = score.shape
    dt = cums[0].dtype
    packs = []
    for bi, cumb in enumerate(cums):
        nb, Flg = cumb.shape[2], cumb.shape[3]
        size = (nb - 1) * Flg
        ix = idx[bi].long()
        lb = cumb[:, :, :-1, :].reshape(A, C, size).gather(
            2, ix.clamp(0, size - 1)[:, None, None].expand(A, C, 1))[:, :, 0]
        gi = (ix // Flg) * (G * Flg) + s * Flg + ix % Flg
        packs.append(torch.cat([score[bi][:, None].to(dt),
                                gi[:, None].to(dt),
                                valid[bi][:, None].to(dt), lb], dim=1))
    tot = cums[0][:, :, -1, 0] if s == 0 else torch.zeros_like(
        cums[0][:, :, -1, 0])
    allp = _mesh.gather_axis(active_tree_mesh(), torch.cat(
        [torch.stack(packs).reshape(-1), tot.reshape(-1)]), "grid")
    body = allp[:, :nblk * A * (3 + C)].reshape(G, nblk, A, 3 + C)
    tstats = allp[0, nblk * A * (3 + C):].reshape(A, C)
    out_s, out_i, out_v = [], [], []
    off = 0
    for bi, cumb in enumerate(cums):
        for k in range(G):
            sk, gk = body[k, bi, :, 0], body[k, bi, :, 1]
            vk, lk = body[k, bi, :, 2] > 0.5, body[k, bi, :, 3:]
            if k == 0:
                bs, best, ok, lb = sk, gk, vk, lk
                continue
            take = (sk > bs) | ((sk == bs) & (gk < best))
            best = torch.where(take, gk, best)
            ok = torch.where(take, vk, ok)
            lb = torch.where(take[:, None], lk, lb)
            bs = torch.where(take, sk, bs)
        out_s.append(bs)
        out_i.append(best)
        out_v.append(ok)
        gi = off + best
        if bi == 0:
            s_all, i_all, l_all = bs, gi, lb
        else:
            take = (bs > s_all) | ((bs == s_all) & (gi < i_all))
            i_all = torch.where(take, gi, i_all)
            l_all = torch.where(take[:, None], lb, l_all)
            s_all = torch.where(take, bs, s_all)
        off += (cumb.shape[2] - 1) * G * cumb.shape[3]
    return (torch.stack(out_s).to(score.dtype),
            torch.stack(out_i).to(torch.int32), torch.stack(out_v),
            torch.stack([l_all, tstats]).contiguous())


def grow_tree(XbT: torch.Tensor, edges: torch.Tensor, stats: torch.Tensor,
              crit, leaf_fn: Callable, max_depth: int, n_bins: int,
              min_instances, min_info_gain, depth_limit: Optional[int] = None,
              max_active_nodes: int = 128, unroll: bool = False,
              blocks: Optional[List[Block]] = None,
              masks: Optional[List[torch.Tensor]] = None):
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

    ``masks`` (random forests): per block a float32 [D, cap, Fb] 0/1
    candidate mask; level d's split scans read ``mask[d, :A]`` (a
    contiguous view). A per-tree mask repeats one row; a per-node draw
    (:func:`node_feature_uniforms`) gives every (level, slot) its own.

    The histograms read the bins themselves: the JAX package precomputes
    the ``bin ≤ t`` indicator when it fits (``prepare_blocks``), but on
    the H100 the kernel builds it from the bins faster than it reads the
    precomputed one (``PERF.md``), so no fit passes ``bc``."""
    n = XbT.shape[1]
    dev, dt = stats.device, stats.dtype
    C, D = stats.shape[1], max_depth
    if blocks is None:
        blocks = prepare_blocks(XbT, n_bins)
    cap = slot_cap(D, max_active_nodes, unroll)
    total_nodes = (1 << D) - 1
    n_leaves = 1 << D
    lam, mcw = crit.kernel_params()
    # the gain floor, a host scalar in the stats' dtype
    mig = torch.clamp(torch.as_tensor(min_info_gain, dtype=dt), min=1e-10)
    i32 = dict(dtype=torch.int32, device=dev)
    cols = [blk.cols for blk in blocks]
    sparse01 = [blk.sparse01 for blk in blocks]

    def hist(blk, node, a, groups):
        if blk.sparse01:
            return cumhist_sparse01(stats, node, blk.mat, a, groups=groups,
                                    rows=blk.rows)
        return cumhist(stats, node, blk.mat, a, blk.n_bins, groups=groups,
                       rows=blk.rows)

    fs = blocks[0].shards > 1
    if fs:
        G = blocks[0].shards
        gi_s = active_tree_mesh().axis_index("grid")
        # the epilogue decodes a block's padded candidate axis t·(G·Flg)
        # + s·Flg + f: pad columns map to the block's last real column
        # (reachable only when no candidate is valid)
        pcols, fs_masks = [], []
        for bi, blk in enumerate(blocks):
            Flg = blk.mat.shape[0]
            pos = torch.clamp(torch.arange(G * Flg, device=dev),
                              max=len(blk.cols) - 1)
            pcols.append(blk.cols[pos])
            pad = Flg - blk.real
            if masks is not None:
                m = masks[bi][..., blk.lo:blk.lo + blk.real]
                fs_masks.append(torch.nn.functional.pad(m, (0, pad))
                                .contiguous())
            elif pad:
                m = torch.ones((cap, Flg), dtype=torch.float32, device=dev)
                m[:, blk.real:] = 0.0
                fs_masks.append(m.expand(D, cap, Flg))
            else:
                fs_masks.append(None)

    def scan_mask(bi, d, A):
        if fs:
            return None if fs_masks[bi] is None else fs_masks[bi][d, :A]
        return None if masks is None else masks[bi][d, :A]

    def level(d, A, A_next, slot, g, node_even, gpos, alive, feat, thr,
              gain, leafS, prev):
        # the card's kernels read the live rows grouped by slot, once a
        # level for every block; the CPU's plain versions need no grouping
        grouped = dev.type != "cpu"
        groups = None
        if prev is not None:
            # left children live in the even slots (``node_even``, from
            # the last level's epilogue); each right sibling is its
            # parent's histogram minus the left one, per block
            half = A // 2
            if grouped:
                groups = group_rows(node_even, half)
        elif grouped:
            groups = group_rows(slot, A)
        # every block's winner, written into one [blocks, A] table
        score = torch.empty((len(blocks), A), dtype=dt, device=dev)
        idx = torch.empty((len(blocks), A), **i32)
        valid = torch.empty((len(blocks), A), dtype=torch.bool, device=dev)
        cums = []
        # every block's histogram of this rank's rows, summed over the
        # ranks in one all-reduce
        hs = _hist_sums([hist(blk, node_even, half, groups)
                         if prev is not None else hist(blk, slot, A, groups)
                         for blk in blocks])
        for bi, (blk, h) in enumerate(zip(blocks, hs)):
            if prev is not None:
                parent = prev[0][bi][prev[1]]
                cumb = torch.stack([h, parent - h], dim=1).reshape(
                    (A,) + h.shape[1:])
            else:
                cumb = h
            split_scan(cumb, crit.kernel_kind, min_instances, lam=lam,
                       min_child_weight=mcw, mask=scan_mask(bi, d, A),
                       out=(score[bi], idx[bi], valid[bi]))
            cums.append(cumb)
        win = None
        shapes, ecols = cums, cols
        if fs:
            score, idx, valid, win = _merge_chunks(
                score, idx, valid, cums, G, gi_s, C)
            shapes = [(c.shape[2], G * c.shape[3]) for c in cums]
            ecols = pcols
        slot2, g2, node_even2, gpos2, alive2, rank = level_epilogue(
            score, idx, valid, shapes, ecols, sparse01, edges, alive, gpos,
            XbT, slot, g, feat, thr, gain, leafS, kind=crit.kernel_kind,
            lam=lam, mig=mig, d=d, max_depth=D, A_next=A_next,
            split_ok=depth_limit is None or d < depth_limit,
            node_even=unroll and d + 1 < D, win_stats=win)
        return slot2, g2, node_even2, gpos2, alive2, (cums, rank)

    # the trailing entry of each record is a sink for non-live slots
    feat = torch.zeros((total_nodes + 1,), **i32)
    thr = torch.full((total_nodes + 1,), float("inf"), dtype=edges.dtype,
                     device=dev)
    gain = torch.zeros((total_nodes + 1,), dtype=dt, device=dev)
    leafS = torch.zeros((n_leaves + 1, C), dtype=dt, device=dev)
    slot = torch.zeros((n,), **i32)
    g = torch.zeros((n,), **i32)
    node_even = None
    prev = None
    if unroll:
        gpos = torch.zeros((1,), **i32)
        alive = torch.ones((1,), dtype=torch.bool, device=dev)
        for d in range(D):
            A, A_next = min(1 << d, cap), min(1 << (d + 1), cap)
            slot, g, node_even, gpos, alive, prev = level(
                d, A, A_next, slot, g, node_even, gpos, alive, feat, thr,
                gain, leafS, prev)
    else:
        gpos = torch.zeros((cap,), **i32)
        alive = torch.arange(cap, device=dev) == 0
        for d in range(D):
            slot, g, _, gpos, alive, _ = level(
                d, cap, cap, slot, g, None, gpos, alive, feat, thr, gain,
                leafS, None)
    return (feat[:total_nodes], thr[:total_nodes],
            leaf_fn(leafS[:n_leaves]), g, gain[:total_nodes])


# ---------------------------------------------------------------------------
# Random forest
# ---------------------------------------------------------------------------

#: the Poisson inverse CDF's truncation (rate ≤ 1 loses < 1e-8 of mass)
_POISSON_K_MAX = 8
#: elements of one batched threefry draw (bounds its int64 temporaries)
_DRAW_CHUNK = 1 << 22


def _poisson_cdf(rate) -> torch.Tensor:
    """The JAX package's f32 Poisson(rate) CDF at 0..k_max, on the host:
    r^k · e^−r / k! summed left to right."""
    f32 = torch.float32
    ks = torch.arange(_POISSON_K_MAX + 1, dtype=f32)
    fact = torch.tensor(np.cumprod(np.concatenate(
        [[1.0], np.arange(1.0, _POISSON_K_MAX + 1)])), dtype=f32)
    r = torch.clamp(torch.tensor(float(rate), dtype=f32), min=1e-9)
    terms = torch.pow(r, ks) * torch.exp(-r) / fact
    cdf = torch.empty_like(terms)
    acc = torch.zeros((), dtype=f32)
    for i in range(len(terms)):
        acc = acc + terms[i]
        cdf[i] = acc
    return cdf


def poisson_bootstrap_weights(u: torch.Tensor, rate, dtype) -> torch.Tensor:
    """Poisson(rate) bootstrap counts from f32 uniforms ``u`` by the
    inverse CDF truncated at k_max (the tail lands on k_max), in
    ``dtype`` — ``poisson_bootstrap_weights`` of the JAX package, whose
    uniforms are ``uniform(fold_in(k_boot, tree), (n,), float32)``."""
    cdf = _poisson_cdf(rate).to(u.device)
    w = torch.zeros_like(u)
    for i in range(_POISSON_K_MAX):
        w = w + (u > cdf[i]).to(torch.float32)
    return w.to(dtype)


def _kth_mask(u: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly the k smallest uniforms of each row (``u ≤ sort(u)[k−1]``)."""
    return u <= torch.kthvalue(u, k, dim=-1, keepdim=True).values


def feature_masks(key: np.ndarray, n_trees: int, n_feat: int, k: int,
                  dtype: torch.dtype, device) -> torch.Tensor:
    """[T, F] bool, exactly k random features per tree
    (``_feature_masks`` of the JAX package; the draw's width is
    ``dtype``'s)."""
    if k >= n_feat:
        return torch.ones((n_trees, n_feat), dtype=torch.bool, device=device)
    u = R.uniform_batch(key[None], (n_trees, n_feat), dtype, device)[0]
    return _kth_mask(u, k)


def node_feature_uniforms(tree_keys: np.ndarray, max_depth: int, cap: int,
                          n_feat: int, dtype: torch.dtype, device
                          ) -> torch.Tensor:
    """[T, D, cap, F] uniforms: entry (t, d) is the draw of tree t's level
    d, ``uniform(fold_in(tree_keys[t], d), (cap, F))``. A level of A ≤ cap
    slots draws (A, F), which is its first A rows."""
    keys = np.stack([R.fold_in(tk, d) for tk in tree_keys
                     for d in range(max_depth)])
    per = max(1, _DRAW_CHUNK // max(cap * n_feat, 1))
    u = torch.cat([R.uniform_batch(keys[i:i + per], (cap, n_feat), dtype,
                                   device)
                   for i in range(0, len(keys), per)])
    return u.reshape(len(tree_keys), max_depth, cap, n_feat)


def forest_k(task: str, n_feat: int) -> int:
    """Candidate features a node (or tree) draws: round(√F) for
    classification, F // 3 for regression (featureSubsetStrategy auto)."""
    if task == "classification":
        return max(1, int(round(np.sqrt(n_feat))))
    return max(1, n_feat // 3)


class ForestDraws:
    """One forest's random draws, shared by every fold and grid point of a
    sweep (their keys depend on the seed and the tree only): ``boot_u``
    [T, n] f32 bootstrap uniforms (None for one tree) and ``masks``, per
    block a float32 [T, D, cap, Fb] 0/1 candidate mask (None when every
    feature is a candidate). :meth:`bootstrap` keeps the weights of each
    rate it was asked for."""

    def __init__(self, boot_u: Optional[torch.Tensor],
                 masks: Optional[List[torch.Tensor]]):
        self.boot_u = boot_u
        self.masks = masks
        self._weights = {}

    def bootstrap(self, rate, dtype) -> Optional[torch.Tensor]:
        """[T, n] bootstrap weights at ``rate`` in ``dtype`` (None for a
        single tree, which takes no bootstrap)."""
        if self.boot_u is None:
            return None
        key = (float(rate), dtype)
        if key not in self._weights:
            self._weights[key] = poisson_bootstrap_weights(self.boot_u,
                                                           rate, dtype)
        return self._weights[key]


def forest_draws(seed: int, n_trees: int, n: int, task: str, max_depth: int,
                 cap: int, blocks: List[Block], dtype: torch.dtype, device,
                 per_node_features: bool = True) -> ForestDraws:
    """The draws of :func:`fit_forest` for ``n`` rows at depth
    ``max_depth`` with ``cap`` slots, as the JAX ``fit_forest`` makes them:
    ``k_boot, k_feat = split(PRNGKey(seed))``; tree t's bootstrap from
    ``fold_in(k_boot, t)``; per-node masks from ``split(k_feat, T)[t]``
    folded with the level, or per-tree masks from ``k_feat``."""
    F = sum(len(b.cols) for b in blocks)
    if n_trees == 1:
        return ForestDraws(None, None)
    k_boot, k_feat = R.split(R.PRNGKey(seed))
    boot_u = R.uniform_batch(
        np.stack([R.fold_in(k_boot, t) for t in range(n_trees)]), (n,),
        torch.float32, device)
    k = forest_k(task, F)
    if k >= F:
        return ForestDraws(boot_u, None)
    if per_node_features:
        u = node_feature_uniforms(R.split(k_feat, n_trees), max_depth, cap,
                                  F, dtype, device)
        full = _kth_mask(u, k)                        # [T, D, cap, F]
    else:
        fm = feature_masks(k_feat, n_trees, F, k, dtype, device)
        full = fm[:, None, None, :].expand(n_trees, max_depth, cap, F)
    masks = [full.index_select(3, b.cols).to(torch.float32).contiguous()
             for b in blocks]
    return ForestDraws(boot_u, masks)


def check_card_classes(task: str, n_classes: int, device) -> None:
    """A classification forest of K classes needs K + 1 stat channels and
    K leaf values; past what the card's kernels take
    (``_hist.MAX_CARD_CHANNELS``, 63 classes) it raises on the card before
    anything launches. The CPU's plain versions take any count. A family
    checks in ``device_prep``, before it bins (on the card binning
    launches ``group_rows``); :func:`fit_forest` checks when it bins
    itself."""
    if (task == "classification" and torch.device(device).type == "cuda"
            and int(n_classes) + 1 > MAX_CARD_CHANNELS):
        raise ValueError(
            f"a tree fit of {int(n_classes)} classes needs "
            f"{int(n_classes) + 1} stat channels and the card's kernels take "
            f"at most {MAX_CARD_CHANNELS} ({MAX_CARD_CHANNELS - 1} classes)")


def _binned(X, n_bins, binary_mask, prebinned, task=None, n_classes=0,
            device=None):
    """(XbT, edges, blocks, row shard | None) of a fit: ``prebinned``
    (XbT, edges, blocks[, shard]) or X binned here, under the active
    tree mesh's row shard."""
    if prebinned is not None:
        XbT, edges, blocks = prebinned[:3]
        return XbT, edges, blocks, (prebinned[3] if len(prebinned) > 3
                                    else None)
    if task is not None:
        check_card_classes(task, n_classes, device)
    shard = row_shard(X.shape[0])
    XbT, edges = compute_bins(X, n_bins, binary_mask, shard)
    return XbT, edges, prepare_blocks(XbT, n_bins, binary_mask), shard


def fit_forest(X, y, w, *, task: str, n_classes: int, n_trees: int,
               max_depth: int, n_bins: int, min_instances, min_info_gain,
               num_trees_used, subsample_rate,
               depth_limit: Optional[int] = None,
               max_active_nodes: int = 128, binary_mask=None, seed: int = 7,
               per_node_features: bool = True, prebinned=None,
               unroll: bool = False, draws: Optional[ForestDraws] = None):
    """Random forest (one tree a loop step; the JAX package vmaps chunks
    of trees): tree t grows on weights ``w`` × its Poisson bootstrap, over
    per-node draws of k candidate features (Spark's featureSubsetStrategy;
    ``per_node_features=False`` draws one mask per tree), with gini
    (classification, channels one-hot × weight and the count) or variance
    splits. One tree (a decision tree) takes neither draw. ``draws``
    (:func:`forest_draws`) reuses a sweep's draws; ``prebinned`` is (XbT,
    edges, blocks). Returns the params dict, with ``train_node`` [T, n],
    each training row's leaf (the CV sweep predicts from it).

    Over a mesh (``prebinned``'s fourth entry, or :func:`row_shard` when
    this call bins) ``X``, ``y`` and ``w`` are the whole input on every
    rank; the fit takes this rank's rows and ``train_node`` holds them."""
    XbT, edges, blocks, shard = _binned(X, n_bins, binary_mask, prebinned,
                                        task, n_classes, w.device)
    n = XbT.shape[1] if shard is None else shard.n
    dt, dev = w.dtype, w.device
    if draws is None:
        draws = forest_draws(seed, n_trees, n, task, max_depth,
                             slot_cap(max_depth, max_active_nodes, unroll),
                             blocks, dt, dev, per_node_features)
    bw = draws.bootstrap(subsample_rate, dt)
    if shard is not None:
        y, w = shard.take(y), shard.take(w)
        if bw is not None:
            bw = shard.take(bw, axis=1)
    if task == "classification":
        onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(dt)

        def make_stats(wt):
            return torch.cat([onehot * wt[:, None], (wt > 0).to(dt)[:, None]],
                             dim=1)
        crit, leaf_fn = GiniCriterion(), gini_leaf
    else:
        def make_stats(wt):
            return torch.stack([wt, wt * y, wt * y * y, (wt > 0).to(dt)],
                               dim=1)
        crit, leaf_fn = VarianceCriterion(), variance_leaf
    out = {k: [] for k in ("feat", "thr", "leaf", "train_node", "gain")}
    for t in range(n_trees):
        wt = w if bw is None else w * bw[t]
        masks = (None if draws.masks is None
                 else [m[t] for m in draws.masks])
        res = grow_tree(XbT, edges, make_stats(wt), crit, leaf_fn, max_depth,
                        n_bins, min_instances, min_info_gain,
                        depth_limit=depth_limit,
                        max_active_nodes=max_active_nodes, unroll=unroll,
                        blocks=blocks, masks=masks)
        for k, v in zip(("feat", "thr", "leaf", "train_node", "gain"), res):
            out[k].append(v)
    out = {k: torch.stack(v) for k, v in out.items()}
    tree_w = (torch.arange(n_trees, device=dev)
              < float(num_trees_used)).to(dt)
    tree_w = tree_w / torch.clamp(tree_w.sum(), min=1.0)
    out["tree_w"] = tree_w
    out["gain"] = out["gain"] * tree_w[:, None]
    return out


# ---------------------------------------------------------------------------
# Boosting
# ---------------------------------------------------------------------------

def _shard_inputs(X, y, w, n_bins, binary_mask, prebinned):
    """A boosted fit's inputs as this rank's rows: binned here when not
    ``prebinned``, ``y`` and ``w`` sliced to the row shard."""
    XbT, edges, blocks, shard = _binned(X, n_bins, binary_mask, prebinned)
    if shard is not None:
        y, w = shard.take(y), shard.take(w)
    return X, y, w, (XbT, edges, blocks, shard)


def _boost(X, y, w, n_rounds, max_depth, n_bins, num_rounds_used, shrink,
           stats_of, crit, leaf_fn, min_instances, min_info_gain,
           depth_limit, max_active_nodes, binary_mask, prebinned, unroll):
    XbT, edges, blocks, _shard = _binned(X, n_bins, binary_mask, prebinned)
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
    (2-bin block); ``prebinned`` is (XbT, edges, blocks[, row shard])
    from :func:`compute_bins` and :func:`prepare_blocks`. Over a mesh the
    inputs are whole and ``train_margin`` holds this rank's rows."""
    X, y, w, prebinned = _shard_inputs(X, y, w, n_bins, binary_mask,
                                       prebinned)
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
    squared loss; leaf = −G/(H+λ). Over a mesh as :func:`fit_gbt`."""
    X, y, w, prebinned = _shard_inputs(X, y, w, n_bins, binary_mask,
                                       prebinned)
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


def rf_head(out, dtype, task: str):
    """[n, K] weighted leaf aggregate → (prediction, raw, probability):
    the class shares and their argmax, or the mean regression leaf."""
    if task == "classification":
        probs = out / torch.clamp(out.sum(-1, keepdim=True), min=_EPS)
        return torch.argmax(probs, dim=-1).to(dtype), probs, probs
    empty = torch.zeros((out.shape[0], 0), dtype=dtype, device=out.device)
    return out[:, 0], empty, empty


def rf_train_aggregate(leaf, node, tree_w, task: str):
    """[n, K] weighted leaf sum over the fit-time routing ``node`` [T, n]
    (the training matrix): leaf gathers, no routing. For classification
    the last class is Σ tree_w minus the others, as the JAX package
    computes it (every training row's leaf shares sum to 1)."""
    T, _L, K = leaf.shape
    vals = leaf.gather(1, node.long()[:, :, None].expand(T, -1, K))
    out = torch.einsum("t,tnk->nk", tree_w, vals)
    if task == "classification" and K > 1:
        out[:, K - 1] = tree_w.sum() - out[:, :K - 1].sum(1)
    return out


def predict_rf_classification(params, X, max_depth: int, n_classes: int):
    probs = predict_ensemble(params["feat"], params["thr"], params["leaf"],
                             params["tree_w"], X, max_depth)
    return rf_head(probs, X.dtype, "classification")


def predict_rf_regression(params, X, max_depth: int):
    out = predict_ensemble(params["feat"], params["thr"], params["leaf"],
                           params["tree_w"], X, max_depth)
    return rf_head(out, X.dtype, "regression")


def margin_head(m, margin_scale: float, dtype, task: str):
    """[n] boosted margin → (prediction, raw, probability). GBT uses
    prob = σ(2F), XGB σ(F)."""
    if task == "classification":
        p1 = score_sigmoid(margin_scale * m)
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
