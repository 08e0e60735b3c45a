"""Date vectorization — unit-circle embedding; the port of
``transmogrifai_tpu/ops/dates.py`` (``DateToUnitCircleTransformer.scala``).

A timestamp's periodic component (HourOfDay / DayOfWeek / DayOfMonth /
DayOfYear) maps to (sin θ, cos θ). Timestamps are epoch milliseconds.
The angles are reduced on the host in f64 (epoch millis defeat f32, and
libm's sin/cos are the reference's); the device does the null masking.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columns import ColumnStore
from ..stages.base import register_stage
from ..types.feature_types import Date
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizer_base import (TransmogrifierDefaults, VectorizerModel,
                              null_indicator_meta)

__all__ = ["DateToUnitCircleVectorizer", "TimePeriod", "period_radians"]

_MS_PER_HOUR = 3600 * 1000
_MS_PER_DAY = 24 * _MS_PER_HOUR


class TimePeriod:
    HOUR_OF_DAY = "HourOfDay"
    DAY_OF_WEEK = "DayOfWeek"
    DAY_OF_MONTH = "DayOfMonth"
    DAY_OF_YEAR = "DayOfYear"

    ALL = [HOUR_OF_DAY, DAY_OF_WEEK, DAY_OF_MONTH, DAY_OF_YEAR]


def period_radians(millis: np.ndarray, period: str) -> np.ndarray:
    """θ in [0, 2π) for the given period of f64 epoch-ms timestamps: the
    epoch anchor (1970-01-01 = Thursday) for day-of-week, the mean month
    and year lengths for the calendar periods."""
    if period == TimePeriod.HOUR_OF_DAY:
        frac = (millis % _MS_PER_DAY) / _MS_PER_DAY
    elif period == TimePeriod.DAY_OF_WEEK:
        frac = ((millis // _MS_PER_DAY + 4) % 7) / 7.0
    elif period == TimePeriod.DAY_OF_MONTH:
        frac = ((millis / _MS_PER_DAY) % 30.4375) / 30.4375
    elif period == TimePeriod.DAY_OF_YEAR:
        frac = ((millis / _MS_PER_DAY) % 365.2425) / 365.2425
    else:
        raise ValueError(f"Unknown time period {period!r}")
    return frac * (2.0 * np.pi)


@register_stage
class DateToUnitCircleVectorizer(VectorizerModel):
    """Date(s) → [sin θ, cos θ] per period per feature (+ null tracking).
    A transformer with no fit state, in the vectorizer protocol."""

    operation_name = "dateToUnitCircle"
    seq_type = Date

    def __init__(self, periods: Sequence[str] = (TimePeriod.HOUR_OF_DAY,),
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "Date",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.periods = list(periods)
        self.track_nulls = track_nulls
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        sincos, masks = [], []
        for name in self._names():
            col = store[name]
            millis = col.values.astype(np.float64)
            sc = np.empty((len(millis), len(self.periods), 2), np.float64)
            for p_i, p in enumerate(self.periods):
                theta = period_radians(millis, p)
                sc[:, p_i, 0] = np.sin(theta)
                sc[:, p_i, 1] = np.cos(theta)
            sincos.append(sc)
            masks.append(col.mask)
        return {"sincos": np.stack(sincos, axis=1),  # [n, k, P, 2]
                "mask": np.stack(masks, axis=1)}     # [n, k]

    def device_compute(self, prepared):
        sincos, mask = prepared["sincos"], prepared["mask"]
        n, k, P, _ = sincos.shape
        outs = []
        for j in range(k):
            m = mask[:, j]
            if P:
                outs.append(torch.where(m[:, None],
                                        sincos[:, j].reshape(n, 2 * P),
                                        torch.zeros((), dtype=sincos.dtype,
                                                    device=sincos.device)))
            if self.track_nulls:
                outs.append((~m).to(sincos.dtype)[:, None])
        return torch.cat(outs, dim=1)

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for name in self._names():
            for period in self.periods:
                for d in ("x", "y"):
                    cols.append(VectorColumnMetadata(
                        parent_feature_name=name,
                        parent_feature_type=self.ftype_name,
                        descriptor_value=f"{period}_{d}"))
            if self.track_nulls:
                cols.append(null_indicator_meta(name, self.ftype_name))
        return VectorMetadata(self.meta_name, cols)
