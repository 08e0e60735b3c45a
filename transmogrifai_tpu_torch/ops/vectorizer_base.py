"""Vectorizer protocol — the host/device split of every vectorizer model;
the port of ``transmogrifai_tpu/ops/vectorizer_base.py``.

* ``host_prepare(store) -> {name: np.ndarray}`` — string lookups, vocab
  indexing, hashing: anything that touches host objects. Produces dense
  numeric arrays (+ masks) only.
* ``device_compute(prepared) -> torch.Tensor [n, d]`` — the array math, in
  torch on the workflow's device (the JAX package's ``device_compute(xp,
  …)``).

Prepared blocks are canonicalized to f32/int32 (``canonicalize_prepared``)
before they cross, as in the JAX package, so the card and the CPU compute
on the same inputs; the output is the pipeline dtype (f32) on the host,
where the port's columns live. A model whose output is its host block as
it stands (one-hot, hashing) sets ``device_math = False`` and moves
nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Type

import numpy as np
import torch

from ..columns import Column, ColumnStore, VectorColumn
from ..models.base import resolve_device
from ..stages.base import Estimator, FittedModel, InputSpec, VarArity
from ..types.feature_types import FeatureType, OPVector
from ..vector_metadata import (NULL_INDICATOR, VectorColumnMetadata,
                               VectorMetadata)

__all__ = ["VectorizerModel", "VectorizerEstimator", "TransmogrifierDefaults",
           "canonicalize_prepared", "null_indicator_meta", "VEC_DTYPE",
           "vec_dtype_round"]

#: dtype of the vector pipeline: f32 end to end
VEC_DTYPE = np.float32


def canonicalize_prepared(prepared: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """f64→f32, i64→i32, u64→u32; bools and narrower types pass through.
    Integers outside the 32-bit range are refused: ``host_prepare`` must
    reduce such quantities (epoch millis) on the host first."""
    out = {}
    for k, v in prepared.items():
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(VEC_DTYPE)
        elif a.dtype in (np.int64, np.uint64):
            info = np.iinfo(np.int32 if a.dtype == np.int64 else np.uint32)
            if a.size and (a.max(initial=0) > info.max
                           or a.min(initial=0) < info.min):
                raise ValueError(
                    f"prepared block {k!r} holds values outside the "
                    f"{info.dtype} range; host_prepare must pre-scale them "
                    "before canonical casting")
            a = a.astype(info.dtype)
        out[k] = a
    return out


def vec_dtype_round(values) -> np.ndarray:
    """Fitted f64 constants (bucket edges) rounded through the pipeline
    dtype once, at fit time, so that fit-time decisions and transform-time
    comparisons see the same numbers."""
    return np.asarray(values, dtype=VEC_DTYPE).astype(np.float64)


class TransmogrifierDefaults:
    """Default knobs (core/.../impl/feature/Transmogrifier.scala:52-88)."""

    TOP_K = 20
    MIN_SUPPORT = 10
    FILL_VALUE = 0.0
    BINARY_FILL_VALUE = 0.0
    HASH_SIZE = 512  # DefaultNumOfFeatures
    FILL_WITH_MEAN = True
    FILL_WITH_MODE = True
    TRACK_NULLS = True
    TRACK_INVALID = False
    CIRCULAR_DATE_REPRESENTATIONS = ["HourOfDay", "DayOfWeek", "DayOfMonth",
                                     "DayOfYear"]


class VectorizerModel(FittedModel):
    """Fitted vectorizer: N typed inputs → OPVector via host/device split."""

    output_type = OPVector
    seq_type: Type[FeatureType] = FeatureType
    #: the workflow passes ``device=`` to this stage's transform
    uses_device = True
    #: False: ``device_compute`` only returns a host block (no device work)
    device_math = True

    @property
    def input_spec(self) -> InputSpec:
        return VarArity(self.seq_type)

    # -- protocol ----------------------------------------------------------
    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def device_compute(self, prepared: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
        return prepared["mat"]

    def vector_metadata(self) -> VectorMetadata:
        raise NotImplementedError

    def _names(self) -> List[str]:
        if self.input_features:
            return [f.name for f in self.input_features]
        return self.input_names_saved

    # -- Transformer impl --------------------------------------------------
    def transform_columns(self, store: ColumnStore, device=None) -> Column:
        """``device``: where ``device_compute`` runs (default: the card)."""
        prepared = canonicalize_prepared(self.host_prepare(store))
        dev = (resolve_device(device) if self.device_math
               else torch.device("cpu"))
        mat = self.device_compute(
            {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in prepared.items()})
        mat = mat.to("cpu", torch.float32).numpy()
        meta = self.vector_metadata()
        assert mat.ndim == 2 and mat.shape[1] == meta.size, \
            (type(self).__name__, mat.shape, meta.size)
        return VectorColumn(OPVector, mat, meta)

    @property
    def meta_name(self) -> str:
        """Vector metadata name; the operation when the model is unwired."""
        try:
            return self.output_name
        except ValueError:
            return self.operation_name

    def get_model_state(self) -> Dict:
        return {}


class VectorizerEstimator(Estimator):
    """Base sequence estimator for vectorizers."""

    output_type = OPVector
    seq_type: Type[FeatureType] = FeatureType

    @property
    def input_spec(self) -> InputSpec:
        return VarArity(self.seq_type)

    @property
    def input_names(self) -> List[str]:
        return [f.name for f in self.input_features]


def null_indicator_meta(feature_name: str, ftype_name: str,
                        grouping: Optional[str] = None
                        ) -> VectorColumnMetadata:
    return VectorColumnMetadata(
        parent_feature_name=feature_name, parent_feature_type=ftype_name,
        grouping=grouping, indicator_value=NULL_INDICATOR)
