"""DateList vectorization, event-list time pivots; the port of
``transmogrifai_tpu/ops/date_list.py`` (``DateListVectorizer.scala``).

Per feature: the days since the last (``SinceLast``, the default) or
first (``SinceFirst``) event, relative to a reference date, and a null
slot for an empty list. The epoch-scale subtraction stays in f64 on the
host (both terms are ~1.7e12 ms, a cancellation f32 cannot hold); only
the day deltas go to the device, which masks them and lays out the
block. With ``reference_date_ms=None`` the reference is the newest event
of the store being transformed, so a store scored in chunks gets a
reference per chunk, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columns import ColumnStore, RaggedColumn
from ..stages.base import register_stage
from ..types.feature_types import DateList
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizer_base import (TransmogrifierDefaults, VectorizerModel,
                              null_indicator_meta)

__all__ = ["DateListVectorizer", "DateListPivot"]

_MS_PER_DAY = 24 * 3600 * 1000


class DateListPivot:
    SINCE_LAST = "SinceLast"
    SINCE_FIRST = "SinceFirst"


@register_stage
class DateListVectorizer(VectorizerModel):
    """[days since last/first event, (null)] per feature. A transformer:
    the reference date is a parameter, there is no fitted state."""

    operation_name = "vecDateList"
    seq_type = DateList

    def __init__(self, pivot: str = DateListPivot.SINCE_LAST,
                 reference_date_ms: Optional[int] = None,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 input_names: Sequence[str] = (),
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.pivot = pivot
        self.reference_date_ms = reference_date_ms
        self.track_nulls = track_nulls
        self.input_names_saved = list(input_names)

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        names = self._names()
        n = store.n_rows
        anchor = np.zeros((n, len(names)), dtype=np.float64)
        mask = np.zeros((n, len(names)), dtype=bool)
        reduce = (np.maximum if self.pivot == DateListPivot.SINCE_LAST
                  else np.minimum)
        for j, name in enumerate(names):
            col = store[name]
            assert isinstance(col, RaggedColumn)
            flat = col.flat.astype(np.float64, copy=False)
            m = np.diff(col.offsets) > 0
            mask[:, j] = m
            if flat.size:
                # a segment reduce from the non-empty rows' starts only:
                # they increase strictly, so each segment is one row's
                # events
                nonempty = np.flatnonzero(m)
                anchor[nonempty, j] = reduce.reduceat(
                    flat, col.offsets[:-1][nonempty])
        ref = self.reference_date_ms
        if ref is None:
            present = anchor[mask]
            ref = float(present.max()) if present.size else 0.0
        return {"days": (float(ref) - anchor) / _MS_PER_DAY, "mask": mask}

    def device_compute(self, prepared):
        days, mask = prepared["days"], prepared["mask"]
        days = torch.where(mask, days, torch.zeros((), dtype=days.dtype,
                                                    device=days.device))
        if not self.track_nulls:
            return days
        n, k = days.shape
        return torch.stack([days, (~mask).to(days.dtype)],
                           dim=2).reshape(n, 2 * k)

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for name in self._names():
            cols.append(VectorColumnMetadata(
                parent_feature_name=name, parent_feature_type="DateList",
                descriptor_value=self.pivot))
            if self.track_nulls:
                cols.append(null_indicator_meta(name, "DateList"))
        return VectorMetadata(self.meta_name, cols)
