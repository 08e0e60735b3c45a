"""VectorsCombiner — concatenate OPVector features, merging their
metadata; the port of ``transmogrifai_tpu/ops/vectors.py``
(``VectorsCombiner.scala``). Host numpy, as in the JAX package."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..columns import Column, ColumnStore, VectorColumn
from ..stages.base import InputSpec, Transformer, VarArity, register_stage
from ..types.feature_types import OPVector
from ..vector_metadata import VectorMetadata

__all__ = ["VectorsCombiner"]


@register_stage
class VectorsCombiner(Transformer):
    """Concatenate N OPVector features into one, merging metadata."""

    operation_name = "combineVec"
    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)

    @property
    def input_spec(self) -> InputSpec:
        return VarArity(OPVector)

    def transform_columns(self, store: ColumnStore) -> Column:
        mats, metas = [], []
        for f in self.input_features:
            c = store[f.name]
            assert isinstance(c, VectorColumn), f"{f.name} is not a vector"
            mats.append(c.values)
            metas.append(c.metadata if c.metadata is not None
                         else VectorMetadata(f.name, []))
        mat = (np.concatenate(mats, axis=1) if mats
               else np.zeros((store.n_rows, 0)))
        meta = VectorMetadata.flatten(self.output_name, metas)
        if meta.size != mat.shape[1]:
            meta = None  # provenance lost for some inputs; data stays right
        return VectorColumn(OPVector, mat, meta)
