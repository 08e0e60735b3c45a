"""Geolocation vectorization; the port of ``transmogrifai_tpu/ops/geo.py``
(``GeolocationVectorizer.scala:156``).

Missing coordinates fill with the geographic mean (an f64 mean on the
unit sphere, fitted on the host); the output per feature is
``[lat, lon, accuracy, (null)]``, filled and laid out in torch on the
workflow's device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columns import ColumnStore, GeoColumn
from ..models.base import device_table
from ..stages.base import register_stage
from ..types.feature_types import Geolocation
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizer_base import (TransmogrifierDefaults, VEC_DTYPE,
                              VectorizerEstimator, VectorizerModel,
                              null_indicator_meta)

__all__ = ["GeolocationVectorizer", "GeolocationVectorizerModel", "geo_mean"]


def geo_mean(values: np.ndarray, mask: np.ndarray) -> List[float]:
    """[lat, lon, accuracy] midpoint of the present rows: lat/lon by
    averaging unit-sphere vectors in f64, accuracy by its mean."""
    if not mask.any():
        return [0.0, 0.0, 0.0]
    lat = np.radians(values[mask, 0])
    lon = np.radians(values[mask, 1])
    x = np.cos(lat) * np.cos(lon)
    y = np.cos(lat) * np.sin(lon)
    z = np.sin(lat)
    mx, my, mz = x.mean(), y.mean(), z.mean()
    mean_lat = np.degrees(np.arctan2(mz, np.hypot(mx, my)))
    mean_lon = np.degrees(np.arctan2(my, mx))
    return [float(mean_lat), float(mean_lon),
            float(values[mask, 2].mean())]


@register_stage
class GeolocationVectorizerModel(VectorizerModel):
    operation_name = "vecGeo"
    seq_type = Geolocation

    def __init__(self, fill_values: Sequence[Sequence[float]] = (),
                 track_nulls: bool = True,
                 input_names: Sequence[str] = (),
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fill_values = [list(map(float, f)) for f in fill_values]
        self.track_nulls = track_nulls
        self.input_names_saved = list(input_names)

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        cols = [store[n] for n in self._names()]
        assert all(isinstance(c, GeoColumn) for c in cols)
        return {"values": np.stack([c.values for c in cols], axis=1),
                "mask": np.stack([c.mask for c in cols], axis=1)}

    def device_compute(self, prepared):
        values, mask = prepared["values"], prepared["mask"]  # [n,k,3] [n,k]
        n, k, _ = values.shape
        fills = device_table(
            self, "fill",
            lambda: np.asarray(self.fill_values, dtype=VEC_DTYPE),
            values.device)
        filled = torch.where(mask[:, :, None], values, fills[None, :, :])
        if not self.track_nulls:
            return filled.reshape(n, k * 3)
        nulls = (~mask).to(values.dtype)[:, :, None]
        return torch.cat([filled, nulls], dim=2).reshape(n, k * 4)

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for name in self._names():
            cols += [VectorColumnMetadata(
                parent_feature_name=name, parent_feature_type="Geolocation",
                descriptor_value=d) for d in ("lat", "lon", "accuracy")]
            if self.track_nulls:
                cols.append(null_indicator_meta(name, "Geolocation"))
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"fill_values": self.fill_values,
                "input_names_saved": self._names()}


@register_stage
class GeolocationVectorizer(VectorizerEstimator):
    operation_name = "vecGeo"
    seq_type = Geolocation

    def __init__(self, fill_with_geo_mean: bool = True,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fill_with_geo_mean = fill_with_geo_mean
        self.track_nulls = track_nulls

    def fit_columns(self, store: ColumnStore) -> GeolocationVectorizerModel:
        fills = [geo_mean(store[n].values, store[n].mask)
                 if self.fill_with_geo_mean else [0.0, 0.0, 0.0]
                 for n in self.input_names]
        return GeolocationVectorizerModel(
            fill_values=fills, track_nulls=self.track_nulls,
            input_names=self.input_names)
