"""Numeric vectorizers: mean/mode impute + null tracking; the port of
``transmogrifai_tpu/ops/numeric.py`` (``RealVectorizer.scala:121``,
``IntegralVectorizer``, ``BinaryVectorizer``).

Layout per input feature: ``[imputed value, (null indicator)]``,
concatenated over the N inputs. The impute runs in torch on the
workflow's device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columns import ColumnStore
from ..models.base import device_table
from ..stages.base import register_stage
from ..types.feature_types import Binary, Integral, OPNumeric, Real
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizer_base import (TransmogrifierDefaults, VEC_DTYPE,
                              VectorizerEstimator, VectorizerModel,
                              null_indicator_meta)

__all__ = ["RealVectorizer", "IntegralVectorizer", "BinaryVectorizer",
           "NumericVectorizerModel"]


@register_stage
class NumericVectorizerModel(VectorizerModel):
    """Shared fitted model: per-feature fill value + null tracking."""

    operation_name = "vecNumeric"
    seq_type = OPNumeric

    def __init__(self, fill_values: Sequence[float] = (),
                 track_nulls: bool = True,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "Real",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fill_values = list(fill_values)
        self.track_nulls = track_nulls
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        names = self._names()
        return {"values": np.stack([store[n].values.astype(np.float64)
                                    for n in names], axis=1),
                "mask": np.stack([store[n].mask for n in names], axis=1)}

    def device_compute(self, prepared):
        values, mask = prepared["values"], prepared["mask"]
        # the fill in the pipeline dtype, as the values were canonicalized
        fill = device_table(
            self, "fill",
            lambda: np.asarray(self.fill_values, dtype=VEC_DTYPE),
            values.device)
        imputed = torch.where(mask, values, fill[None, :])
        if not self.track_nulls:
            return imputed
        # interleave [value_i, null_i] (the reference's column order)
        n, k = imputed.shape
        return torch.stack([imputed, (~mask).to(imputed.dtype)],
                           dim=2).reshape(n, 2 * k)

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for name in self._names():
            cols.append(VectorColumnMetadata(
                parent_feature_name=name, parent_feature_type=self.ftype_name))
            if self.track_nulls:
                cols.append(null_indicator_meta(name, self.ftype_name))
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"fill_values": self.fill_values,
                "input_names_saved": self._names()}


class _NumericVectorizerBase(VectorizerEstimator):
    def __init__(self, track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 fill_value: float = TransmogrifierDefaults.FILL_VALUE,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.track_nulls = track_nulls
        self.fill_value = fill_value

    def _fill_for(self, col) -> float:
        return float(self.fill_value)

    def fit_columns(self, store: ColumnStore) -> NumericVectorizerModel:
        return NumericVectorizerModel(
            fill_values=[self._fill_for(store[n]) for n in self.input_names],
            track_nulls=self.track_nulls, input_names=self.input_names,
            ftype_name=self.seq_type.__name__)


@register_stage
class RealVectorizer(_NumericVectorizerBase):
    """Real → [mean-imputed value, null indicator]."""

    operation_name = "vecReal"
    seq_type = Real

    def __init__(self,
                 fill_with_mean: bool = TransmogrifierDefaults.FILL_WITH_MEAN,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 fill_value: float = TransmogrifierDefaults.FILL_VALUE,
                 uid: Optional[str] = None):
        super().__init__(track_nulls=track_nulls, fill_value=fill_value,
                         uid=uid)
        self.fill_with_mean = fill_with_mean

    def _fill_for(self, col) -> float:
        if self.fill_with_mean and col.mask.any():
            return float(col.values[col.mask].astype(np.float64).mean())
        return float(self.fill_value)


@register_stage
class IntegralVectorizer(_NumericVectorizerBase):
    """Integral → [mode-imputed value, null indicator]; the mode is the
    most frequent value, ties to the smallest."""

    operation_name = "vecIntegral"
    seq_type = Integral

    def __init__(self,
                 fill_with_mode: bool = TransmogrifierDefaults.FILL_WITH_MODE,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 fill_value: float = TransmogrifierDefaults.FILL_VALUE,
                 uid: Optional[str] = None):
        super().__init__(track_nulls=track_nulls, fill_value=fill_value,
                         uid=uid)
        self.fill_with_mode = fill_with_mode

    def _fill_for(self, col) -> float:
        if self.fill_with_mode and col.mask.any():
            vals, counts = np.unique(col.values[col.mask],
                                     return_counts=True)
            return float(vals[np.argmax(counts)])
        return float(self.fill_value)


@register_stage
class BinaryVectorizer(_NumericVectorizerBase):
    """Binary → [0/1 with fill, null indicator]."""

    operation_name = "vecBinary"
    seq_type = Binary

    def __init__(self, track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 fill_value: float = TransmogrifierDefaults.BINARY_FILL_VALUE,
                 uid: Optional[str] = None):
        super().__init__(track_nulls=track_nulls, fill_value=fill_value,
                         uid=uid)
