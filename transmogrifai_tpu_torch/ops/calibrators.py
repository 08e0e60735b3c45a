"""Score calibrators — the port of ``transmogrifai_tpu/ops/calibrators.py``.

Parity: ``core/.../impl/feature/PercentileCalibrator.scala:48-120`` (quantile
buckets scaled to 0–99) and
``core/.../impl/regression/IsotonicRegressionCalibrator.scala`` (Spark
``IsotonicRegression`` on a single feature).

Host numpy, as in the JAX package: percentile fitting is one
``np.quantile`` over the column; isotonic fitting is pool-adjacent-violators
on the sorted scores (O(n) after the sort) with the fitted (boundary, value)
staircase evaluated by ``searchsorted`` + linear interpolation at transform
time — both transforms are vectorized array ops.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..columns import Column, ColumnStore, NumericColumn
from ..stages.base import (AllowLabelAsInput, Estimator, FittedModel,
                           FixedArity, InputSpec, register_stage)
from ..types.feature_types import Real, RealNN

__all__ = ["PercentileCalibrator", "PercentileCalibratorModel",
           "IsotonicRegressionCalibrator", "IsotonicRegressionModel",
           "pava"]


@register_stage
class PercentileCalibratorModel(FittedModel):
    """Maps a score into its training-distribution percentile (0–99)."""

    operation_name = "percentileCalibrator"
    output_type = RealNN

    def __init__(self, splits: Sequence[float] = (),
                 output_max: int = 99, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.splits = [float(s) for s in splits]
        self.output_max = int(output_max)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Real)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        v = col.values.astype(np.float64)
        edges = np.asarray(self.splits)
        # bucket index scaled onto [0, output_max]
        idx = np.clip(np.searchsorted(edges, v, side="right") - 1,
                      0, max(len(edges) - 2, 0))
        n_buckets = max(len(edges) - 1, 1)
        scaled = np.floor(idx * (self.output_max + 1) / n_buckets)
        out = np.minimum(scaled, self.output_max)
        return NumericColumn(RealNN, out, np.ones_like(out, dtype=bool))

    def get_model_state(self):
        return {"splits": self.splits, "output_max": self.output_max}


@register_stage
class PercentileCalibrator(Estimator):
    """Estimator(Real) → RealNN percentile score (PercentileCalibrator.scala)."""

    operation_name = "percentileCalibrator"
    output_type = RealNN

    def __init__(self, num_buckets: int = 100, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.num_buckets = num_buckets

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Real)

    def fit_columns(self, store: ColumnStore) -> PercentileCalibratorModel:
        col = store[self.input_features[0].name]
        present = col.values[col.mask].astype(np.float64)
        if present.size == 0:
            edges = np.array([0.0, 1.0])
        else:
            qs = np.quantile(present,
                             np.linspace(0.0, 1.0, self.num_buckets + 1))
            edges = np.unique(qs)
            if edges.size < 2:
                edges = np.array([edges[0], edges[0] + 1.0])
        edges = edges.copy()
        edges[0], edges[-1] = -np.inf, np.inf
        return PercentileCalibratorModel(splits=edges.tolist(),
                                         output_max=99)


def pava(scores: np.ndarray, labels: np.ndarray, weights: np.ndarray):
    """Pool-adjacent-violators → (boundaries, values), both ascending.

    Returns the isotonic staircase fitted to (score, label, weight) triples
    (Spark IsotonicRegression semantics: ties averaged, boundaries at the
    pooled block edges).
    """
    order = np.argsort(scores, kind="stable")
    s, y, w = scores[order], labels[order], weights[order]
    # blocks as (sum_wy, sum_w, left_idx, right_idx) stacks
    vals: List[float] = []
    wsum: List[float] = []
    lefts: List[int] = []
    rights: List[int] = []
    for i in range(len(s)):
        vals.append(float(y[i] * w[i]))
        wsum.append(float(w[i]))
        lefts.append(i)
        rights.append(i)
        while len(vals) > 1 and \
                vals[-2] / max(wsum[-2], 1e-300) >= \
                vals[-1] / max(wsum[-1], 1e-300):
            v, ww = vals.pop(), wsum.pop()
            r = rights.pop()
            lefts.pop()
            vals[-1] += v
            wsum[-1] += ww
            rights[-1] = r
    boundaries: List[float] = []
    values: List[float] = []
    for v, ww, l, r in zip(vals, wsum, lefts, rights):
        mean = v / max(ww, 1e-300)
        boundaries.append(float(s[l]))
        values.append(mean)
        if r != l:
            boundaries.append(float(s[r]))
            values.append(mean)
    return np.asarray(boundaries), np.asarray(values)


@register_stage
class IsotonicRegressionModel(FittedModel, AllowLabelAsInput):
    """Monotone staircase: interpolated lookup of the PAVA fit."""

    operation_name = "isotonicCalibrator"
    output_type = RealNN

    def __init__(self, boundaries: Sequence[float] = (),
                 values: Sequence[float] = (),
                 isotonic: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.boundaries = np.asarray(list(boundaries), dtype=np.float64)
        self.values = np.asarray(list(values), dtype=np.float64)
        self.isotonic = isotonic

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, Real)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[1].name]
        v = col.values.astype(np.float64)
        x = -v if not self.isotonic else v
        if self.boundaries.size == 0:
            out = np.zeros_like(v)
        else:
            out = np.interp(x, self.boundaries, self.values)
        return NumericColumn(RealNN, out, np.ones_like(out, dtype=bool))

    def get_model_state(self):
        return {"boundaries": self.boundaries, "values": self.values,
                "isotonic": self.isotonic}


@register_stage
class IsotonicRegressionCalibrator(Estimator, AllowLabelAsInput):
    """Estimator(label RealNN, score Real) → calibrated RealNN
    (IsotonicRegressionCalibrator.scala)."""

    operation_name = "isotonicCalibrator"
    output_type = RealNN

    def __init__(self, isotonic: bool = True, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.isotonic = isotonic

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, Real)

    def fit_columns(self, store: ColumnStore) -> IsotonicRegressionModel:
        ycol = store[self.input_features[0].name]
        scol = store[self.input_features[1].name]
        y = ycol.values.astype(np.float64)
        s = scol.values.astype(np.float64)
        w = scol.mask.astype(np.float64)
        x = -s if not self.isotonic else s
        keep = w > 0
        boundaries, values = pava(x[keep], y[keep], w[keep])
        return IsotonicRegressionModel(boundaries.tolist(), values.tolist(),
                                       self.isotonic)
