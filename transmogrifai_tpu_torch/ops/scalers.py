"""Scalar scaling stages; the port of ``transmogrifai_tpu/ops/scalers.py``.
Host numpy over one scalar column, as in the JAX package.

Parity: ``core/.../impl/feature/OpScalarStandardScaler.scala`` (z-normalize
one scalar with fitted mean/std), ``ScalerTransformer.scala`` /
``DescalerTransformer.scala`` (apply an invertible scaling and later undo it
by reading the scaling metadata off the scaled feature's origin stage —
used to train on a scaled label and descale predictions).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..columns import Column, ColumnStore, NumericColumn
from ..stages.base import (Estimator, FittedModel, FixedArity, InputSpec,
                           Transformer, register_stage)
from ..types.feature_types import Real, RealNN

__all__ = ["OpScalarStandardScaler", "ScalarStandardScalerModel",
           "ScalerTransformer", "DescalerTransformer", "ScalingType"]


class ScalingType:
    LINEAR = "linear"
    LOGARITHMIC = "logarithmic"


@register_stage
class ScalarStandardScalerModel(FittedModel):
    operation_name = "stdScaled"
    output_type = RealNN

    def __init__(self, mean: float = 0.0, std: float = 1.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.mean = float(mean)
        self.std = float(std)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Real)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        v = col.values.astype(np.float64)
        out = (v - self.mean) / (self.std if self.std > 0 else 1.0)
        out = np.where(col.mask, out, 0.0)
        return NumericColumn(RealNN, out, np.ones_like(out, dtype=bool))

    def get_model_state(self):
        return {"mean": self.mean, "std": self.std}


@register_stage
class OpScalarStandardScaler(Estimator):
    """Estimator(Real) → z-normalized RealNN (OpScalarStandardScaler)."""

    operation_name = "stdScaled"
    output_type = RealNN

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Real)

    def fit_columns(self, store: ColumnStore) -> ScalarStandardScalerModel:
        col = store[self.input_features[0].name]
        present = col.values[col.mask].astype(np.float64)
        mean = float(present.mean()) if present.size else 0.0
        std = float(present.std(ddof=1)) if present.size > 1 else 1.0
        return ScalarStandardScalerModel(mean=mean, std=std or 1.0)

    # -- the fused fit-statistics pass (fitstats.py) -----------------------
    def stat_requests(self, store):
        from ..fitstats import StatRequest
        name = self.input_features[0].name
        return [StatRequest("mean", name),
                StatRequest("std", name, params=(1,))]

    def fit_columns_from_stats(self, store, stats):
        name = self.input_features[0].name
        mean = stats.value("mean", name)
        std = stats.value("std", name, params=(1,))
        mean = 0.0 if mean is None else mean
        std = 1.0 if std is None else std
        return ScalarStandardScalerModel(mean=mean, std=std or 1.0)


@register_stage
class ScalerTransformer(Transformer):
    """Invertible scaling of one scalar feature (ScalerTransformer.scala).

    ``scaling_type``: 'linear' (slope·x + intercept) or 'logarithmic'
    (ln x). The scaling args live on the stage so DescalerTransformer can
    find and invert them through the feature graph.
    """

    operation_name = "scaled"
    output_type = Real

    def __init__(self, scaling_type: str = ScalingType.LINEAR,
                 slope: float = 1.0, intercept: float = 0.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if scaling_type not in (ScalingType.LINEAR, ScalingType.LOGARITHMIC):
            raise ValueError(f"Unknown scaling type {scaling_type!r}")
        self.scaling_type = scaling_type
        self.slope = float(slope)
        self.intercept = float(intercept)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Real)

    def scale(self, v: np.ndarray) -> np.ndarray:
        if self.scaling_type == ScalingType.LINEAR:
            return self.slope * v + self.intercept
        return np.log(np.maximum(v, 1e-300))

    def descale(self, v: np.ndarray) -> np.ndarray:
        if self.scaling_type == ScalingType.LINEAR:
            if self.slope == 0:
                raise ValueError("Cannot descale a slope-0 linear scaling")
            return (v - self.intercept) / self.slope
        return np.exp(v)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        v = col.values.astype(np.float64)
        out = np.where(col.mask, self.scale(v), 0.0)
        return NumericColumn(Real, out, col.mask.copy())


@register_stage
class DescalerTransformer(Transformer):
    """Binary(value: Real, scaled source: Real) → Real with the source's
    scaling inverted (DescalerTransformer.scala).

    The second input must descend from a :class:`ScalerTransformer`; its
    scaling metadata is read off the feature graph and inverted on the
    first input (e.g. descale predictions trained on a scaled label).
    """

    operation_name = "descaled"
    output_type = Real

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Real, Real)

    def _find_scaler(self) -> ScalerTransformer:
        f = self.input_features[1]
        while f is not None:
            st = f.origin_stage
            if isinstance(st, ScalerTransformer):
                return st
            f = st.input_features[0] if st is not None and \
                st.input_features else None
        raise ValueError(
            f"Feature {self.input_features[1].name!r} has no "
            "ScalerTransformer ancestor to invert")

    def transform_columns(self, store: ColumnStore) -> Column:
        scaler = self._find_scaler()
        col = store[self.input_features[0].name]
        v = col.values.astype(np.float64)
        out = np.where(col.mask, scaler.descale(v), 0.0)
        return NumericColumn(Real, out, col.mask.copy())
