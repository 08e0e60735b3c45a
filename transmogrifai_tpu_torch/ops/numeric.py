"""Numeric vectorizers: mean/mode impute + null tracking, and the
bucketizer; the port of ``transmogrifai_tpu/ops/numeric.py``
(``RealVectorizer.scala:121``, ``IntegralVectorizer``,
``BinaryVectorizer``, ``NumericBucketizer``).

Layout per input feature: ``[imputed value, (null indicator)]``,
concatenated over the N inputs; a bucketizer's is ``[one-hot buckets,
(out of bounds), (null indicator)]``. The impute and the bucketing run in
torch on the workflow's device.
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
                              null_indicator_meta, vec_dtype_round)

__all__ = ["RealVectorizer", "IntegralVectorizer", "BinaryVectorizer",
           "NumericVectorizerModel", "NumericBucketizer",
           "NumericBucketizerModel"]


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

    def _model_of(self, fills) -> NumericVectorizerModel:
        return NumericVectorizerModel(
            fill_values=fills, track_nulls=self.track_nulls,
            input_names=self.input_names, ftype_name=self.seq_type.__name__)

    def fit_columns(self, store: ColumnStore) -> NumericVectorizerModel:
        return self._model_of([self._fill_for(store[n])
                               for n in self.input_names])

    # -- the fused fit-statistics pass (fitstats.py) -----------------------
    def _stat_request_for(self, name: str):
        """The column's request, or None where the fill is a constant."""
        return None

    def stat_requests(self, store):
        return [r for r in (self._stat_request_for(n)
                            for n in self.input_names) if r is not None]

    def _fill_from_stats(self, name: str, stats) -> float:
        return float(self.fill_value)

    def fit_columns_from_stats(self, store, stats):
        return self._model_of([self._fill_from_stats(n, stats)
                               for n in self.input_names])


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

    def _stat_request_for(self, name: str):
        if not self.fill_with_mean:
            return None
        from ..fitstats import StatRequest
        return StatRequest("mean", name)

    def _fill_from_stats(self, name: str, stats) -> float:
        if self.fill_with_mean:
            mean = stats.value("mean", name)
            if mean is not None:
                return mean
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

    def _stat_request_for(self, name: str):
        if not self.fill_with_mode:
            return None
        from ..fitstats import StatRequest
        return StatRequest("mode", name)

    def _fill_from_stats(self, name: str, stats) -> float:
        if self.fill_with_mode:
            mode = stats.value("mode", name)
            if mode is not None:
                return mode
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


@register_stage
class NumericBucketizerModel(VectorizerModel):
    """One-hot of value buckets + optional out-of-bounds and null slots per
    feature."""

    operation_name = "bucketize"
    seq_type = OPNumeric

    def __init__(self, splits: Sequence[Sequence[float]] = (),
                 track_nulls: bool = True,
                 track_invalid: bool = False,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "Real",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        # the edges are rounded through the pipeline dtype here, so the
        # stored edges are the ones transform compares against. No dedup:
        # two f64 edges within one f32 ulp become an equal pair whose
        # bucket never fires, and the vector keeps its width
        self.splits = [vec_dtype_round(list(s)).tolist() for s in splits]
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name

    def _value_columns(self, store: ColumnStore):
        """(values, masks) of the bucketed inputs, one pair a split set."""
        return ([store[n].values.astype(np.float64) for n in self._names()],
                [store[n].mask for n in self._names()])

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        vals, masks = self._value_columns(store)
        return {"values": np.stack(vals, axis=1),
                "mask": np.stack(masks, axis=1)}

    def device_compute(self, prepared):
        values, mask = prepared["values"], prepared["mask"]
        outs = []
        for j, splits in enumerate(self.splits):
            # f32 edges against the f32-canonicalized values, so the card
            # and the CPU bucket alike
            edges = device_table(
                self, f"edges{j}",
                lambda s=splits: np.asarray(s, dtype=VEC_DTYPE),
                values.device)
            v = values[:, j].contiguous()
            m = mask[:, j]
            # bucket b: edges[b] <= v < edges[b+1]; the last bucket is
            # right-closed through in_range
            idx = (torch.searchsorted(edges, v, right=True) - 1).clamp(
                0, len(splits) - 2)
            in_range = (v >= edges[0]) & (v <= edges[-1])
            valid = m & in_range
            onehot = idx[:, None] == torch.arange(
                len(splits) - 1, device=v.device)[None, :]
            outs.append((onehot & valid[:, None]).to(values.dtype))
            if self.track_invalid:
                outs.append((m & ~in_range).to(values.dtype)[:, None])
            if self.track_nulls:
                outs.append((~m).to(values.dtype)[:, None])
        return torch.cat(outs, dim=1)

    def _slot_meta(self, name: str, grouping: Optional[str],
                   splits: Sequence[float]) -> List[VectorColumnMetadata]:
        labels = [f"{splits[b]}-{splits[b + 1]}"
                  for b in range(len(splits) - 1)]
        if self.track_invalid:
            labels.append("OutOfBounds")
        cols = [VectorColumnMetadata(
            parent_feature_name=name, parent_feature_type=self.ftype_name,
            grouping=grouping, indicator_value=v) for v in labels]
        if self.track_nulls:
            cols.append(null_indicator_meta(name, self.ftype_name,
                                            grouping))
        return cols

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for name, splits in zip(self._names(), self.splits):
            cols += self._slot_meta(name, None, splits)
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"splits": self.splits, "input_names_saved": self._names()}


@register_stage
class NumericBucketizer(VectorizerEstimator):
    """Fixed or quantile splits → one-hot buckets (NumericBucketizer)."""

    operation_name = "bucketize"
    seq_type = OPNumeric

    def __init__(self, splits: Optional[Sequence[float]] = None,
                 num_buckets: int = 4,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 track_invalid: bool = TransmogrifierDefaults.TRACK_INVALID,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.splits = list(splits) if splits is not None else None
        self.num_buckets = num_buckets
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    @staticmethod
    def _splits_of(qs) -> List[float]:
        """Quantiles → split edges, deduplicated; a constant column gets
        one bucket of width 1."""
        if qs is None:
            return [0.0, 1.0]
        qs = np.unique(qs)
        if qs.size < 2:
            qs = np.array([qs[0], qs[0] + 1.0])
        return qs.tolist()

    def fit_columns(self, store: ColumnStore) -> NumericBucketizerModel:
        per_feature = []
        for name in self.input_names:
            if self.splits is not None:
                per_feature.append(self.splits)
                continue
            col = store[name]
            present = col.values[col.mask].astype(np.float64)
            qs = (np.quantile(present,
                              np.linspace(0, 1, self.num_buckets + 1))
                  if present.size else None)
            per_feature.append(self._splits_of(qs))
        return self._model_of(per_feature)

    def _model_of(self, per_feature) -> NumericBucketizerModel:
        return NumericBucketizerModel(
            splits=per_feature, track_nulls=self.track_nulls,
            track_invalid=self.track_invalid, input_names=self.input_names,
            ftype_name=self.seq_type.__name__)

    # -- the fused fit-statistics pass (fitstats.py) -----------------------
    def stat_requests(self, store):
        if self.splits is not None:
            return []           # fixed splits: nothing to scan
        from ..fitstats import StatRequest
        return [StatRequest("quantile", n, params=(self.num_buckets,))
                for n in self.input_names]

    def fit_columns_from_stats(self, store, stats):
        if self.splits is not None:
            return self._model_of([self.splits] * len(self.input_names))
        return self._model_of([
            self._splits_of(stats.value("quantile", n,
                                        params=(self.num_buckets,)))
            for n in self.input_names])
