"""DecisionTreeNumericBucketizer — label-aware numeric bucketization; the
port of ``transmogrifai_tpu/ops/dt_bucketizer.py``.

Parity: ``core/.../impl/feature/DecisionTreeNumericBucketizer.scala`` (:300
defaults — Gini, MaxDepth 5, MaxBins 32, MinInstancesPerNode 1,
MinInfoGain 0.01) and ``DecisionTreeNumericMapBucketizer.scala:170``.

The reference trains a single-feature Spark decision tree and uses its
split thresholds as bucket edges, gated on MinInfoGain. Here the 1-D tree
is fitted exactly with vectorized prefix-sum Gini gains over quantile
candidate thresholds — no tree library needed, one sort + cumsum per node.
The fitted model reuses :class:`NumericBucketizerModel` one-hot semantics,
so the bucketing runs in torch on the workflow's device; the fit is host
numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..columns import ColumnStore, MapColumn, NumericColumn
from ..stages.base import (AllowLabelAsInput, Estimator, FixedArity,
                           InputSpec, register_stage)
from ..types.feature_types import OPNumeric, OPVector, RealMap, RealNN
from ..vector_metadata import VectorMetadata
from .numeric import NumericBucketizerModel
from .vectorizer_base import TransmogrifierDefaults


def map_child_numeric(mcol: MapColumn, key: str):
    """(values, mask) of one map key's numeric child (absent key → all-null)."""
    child = mcol.children.get(key)
    if child is None:
        n = len(mcol)
        return np.zeros(n), np.zeros(n, dtype=bool)
    return child.values.astype(np.float64), child.mask.copy()

__all__ = ["DecisionTreeNumericBucketizer", "DecisionTreeNumericMapBucketizer",
           "find_dt_splits"]

# defaults (DecisionTreeNumericBucketizer.scala:293-300)
MAX_DEPTH = 5
MAX_BINS = 32
MIN_INSTANCES_PER_NODE = 1
MIN_INFO_GAIN = 0.01


def _gini(counts: np.ndarray) -> np.ndarray:
    """Gini impurity of class-count vectors (… , K) → (…)."""
    tot = counts.sum(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(tot > 0, counts / tot, 0.0)
    return 1.0 - (p * p).sum(axis=-1)


def find_dt_splits(x: np.ndarray, y: np.ndarray,
                   max_depth: int = MAX_DEPTH, max_bins: int = MAX_BINS,
                   min_instances: int = MIN_INSTANCES_PER_NODE,
                   min_info_gain: float = MIN_INFO_GAIN) -> List[float]:
    """Split thresholds of an exact 1-D Gini decision tree on (x, y)."""
    classes, y_idx = np.unique(y, return_inverse=True)
    K = len(classes)
    if K < 2 or x.size == 0:
        return []
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y_idx[order]
    onehot = np.eye(K)[ys]                      # [n, K]

    # candidate thresholds: quantile-binned midpoints (MaxBins cap)
    uniq = np.unique(xs)
    if uniq.size < 2:
        return []
    mids = (uniq[:-1] + uniq[1:]) / 2.0
    if mids.size > max_bins - 1:
        mids = np.quantile(mids, np.linspace(0, 1, max_bins - 1))
        mids = np.unique(mids)

    thresholds: List[float] = []

    def grow(lo: int, hi: int, depth: int) -> None:
        if depth >= max_depth or hi - lo < 2 * min_instances:
            return
        seg_x = xs[lo:hi]
        cum = np.cumsum(onehot[lo:hi], axis=0)     # [m, K]
        total = cum[-1]
        n_tot = hi - lo
        parent = _gini(total[None, :])[0]
        # left counts at each candidate: rows with x <= t
        left_n = np.searchsorted(seg_x, mids, side="right")
        valid = (left_n >= min_instances) & (n_tot - left_n >= min_instances)
        if not valid.any():
            return
        left_counts = np.where(
            (left_n > 0)[:, None], cum[np.maximum(left_n - 1, 0)], 0.0)
        right_counts = total[None, :] - left_counts
        gain = parent - (left_n / n_tot) * _gini(left_counts) \
            - ((n_tot - left_n) / n_tot) * _gini(right_counts)
        gain = np.where(valid, gain, -np.inf)
        best = int(np.argmax(gain))
        if gain[best] < min_info_gain:
            return
        t = float(mids[best])
        thresholds.append(t)
        mid = lo + int(left_n[best])
        grow(lo, mid, depth + 1)
        grow(mid, hi, depth + 1)

    grow(0, len(xs), 0)
    return sorted(thresholds)


@register_stage
class DecisionTreeNumericBucketizer(Estimator, AllowLabelAsInput):
    """Estimator(label RealNN, numeric) → one-hot buckets at DT splits."""

    operation_name = "dtBucketize"
    output_type = OPVector

    def __init__(self, max_depth: int = MAX_DEPTH, max_bins: int = MAX_BINS,
                 min_instances_per_node: int = MIN_INSTANCES_PER_NODE,
                 min_info_gain: float = MIN_INFO_GAIN,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 track_invalid: bool = TransmogrifierDefaults.TRACK_INVALID,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, OPNumeric)

    def _splits_for(self, x: np.ndarray, mask: np.ndarray,
                    y: np.ndarray) -> List[float]:
        present = mask & np.isfinite(x)
        thr = find_dt_splits(
            x[present], y[present], max_depth=self.max_depth,
            max_bins=self.max_bins,
            min_instances=self.min_instances_per_node,
            min_info_gain=self.min_info_gain)
        return [-np.inf] + thr + [np.inf]

    def fit_columns(self, store: ColumnStore) -> NumericBucketizerModel:
        ycol = store[self.input_features[0].name]
        xcol = store[self.input_features[1].name]
        assert isinstance(xcol, NumericColumn)
        y = ycol.values.astype(np.float64)
        splits = self._splits_for(xcol.values.astype(np.float64),
                                  xcol.mask, y)
        model = NumericBucketizerModel(
            splits=[splits], track_nulls=self.track_nulls,
            track_invalid=self.track_invalid,
            input_names=[self.input_features[1].name],
            ftype_name=xcol.ftype.__name__)
        return model

    def fitted_inputs(self):
        """The fitted model reads the numeric input only: scoring needs no
        label."""
        return (self.input_features[1],)


@register_stage
class DecisionTreeNumericMapBucketizer(DecisionTreeNumericBucketizer):
    """Same per map key (DecisionTreeNumericMapBucketizer.scala:170)."""

    operation_name = "dtMapBucketize"

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, RealMap)

    def fit_columns(self, store: ColumnStore) -> NumericBucketizerModel:
        ycol = store[self.input_features[0].name]
        mcol = store[self.input_features[1].name]
        assert isinstance(mcol, MapColumn)
        y = ycol.values.astype(np.float64)
        names, splits = [], []
        for key in sorted(mcol.children):
            vals, mask = map_child_numeric(mcol, key)
            names.append(key)
            splits.append(self._splits_for(vals, mask, y))
        model = _MapBucketizerModel(
            splits=splits, keys=names, track_nulls=self.track_nulls,
            track_invalid=self.track_invalid,
            input_names=[self.input_features[1].name],
            ftype_name=mcol.ftype.__name__)
        return model


@register_stage
class _MapBucketizerModel(NumericBucketizerModel):
    """Bucketizer over map keys: one split set per key."""

    def __init__(self, splits: Sequence[Sequence[float]] = (),
                 keys: Sequence[str] = (), track_nulls: bool = True,
                 track_invalid: bool = False,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "RealMap", uid: Optional[str] = None):
        super().__init__(splits=splits, track_nulls=track_nulls,
                         track_invalid=track_invalid,
                         input_names=input_names, ftype_name=ftype_name,
                         uid=uid)
        self.keys = list(keys)

    def _value_columns(self, store: ColumnStore):
        mcol = store[self._names()[0]]
        assert isinstance(mcol, MapColumn)
        pairs = [map_child_numeric(mcol, key) for key in self.keys]
        return [v for v, _ in pairs], [m for _, m in pairs]

    def vector_metadata(self) -> VectorMetadata:
        name = self._names()[0]
        cols = []
        for key, splits in zip(self.keys, self.splits):
            cols += self._slot_meta(name, key, splits)
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        state = super().get_model_state()
        state["keys"] = self.keys
        return state
