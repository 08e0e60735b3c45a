"""Vector combination and scaling; the port of
``transmogrifai_tpu/ops/vectors.py`` (``VectorsCombiner.scala``,
``OpScalarStandardScaler.scala`` over a vector).

The combiner concatenates on the host (numpy), as in the JAX package, and
keeps the widest input dtype. The standard scaler fits its per-slot mean
and std on the host (numpy over the stored vector, as the JAX package
does) and scales in torch on the workflow's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..columns import Column, ColumnStore, VectorColumn
from ..models.base import device_table, resolve_device
from ..stages.base import (Estimator, FittedModel, FixedArity, InputSpec,
                           Transformer, VarArity, register_stage)
from ..types.feature_types import OPVector
from ..vector_metadata import VectorMetadata

__all__ = ["VectorsCombiner", "StandardScalerEstimator",
           "StandardScalerModel"]


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


@register_stage
class StandardScalerModel(FittedModel):
    """(x − mean) / std per vector slot. The constants keep the dtype the
    fit gave them, and the arithmetic promotes as numpy's does (an f32
    vector and f32 constants give f32), so the card, the CPU and the JAX
    package agree bit for bit."""

    operation_name = "zNormalize"
    output_type = OPVector
    #: the workflow passes ``device=`` to this stage's transform
    uses_device = True

    def __init__(self, mean=None, std=None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.mean = np.asarray(mean) if mean is not None else None
        self.std = np.asarray(std) if std is not None else None

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(OPVector)

    def scale_device(self, x: torch.Tensor) -> torch.Tensor:
        """The scaling of a vector batch already on the device (the
        scoring engine's ``scale`` kind)."""
        mean = device_table(self, "mean", lambda: self.mean, x.device)
        std = device_table(self, "std", lambda: self.std, x.device)
        return (x - mean[None, :]) / std[None, :]

    def transform_columns(self, store: ColumnStore, device=None) -> Column:
        col = store[self.input_features[0].name]
        assert isinstance(col, VectorColumn)
        x = torch.from_numpy(np.ascontiguousarray(col.values)).to(
            resolve_device(device))
        vals = self.scale_device(x).cpu().numpy()
        return VectorColumn(OPVector, vals, col.metadata)

    def get_model_state(self):
        return {"mean": self.mean, "std": self.std}

    def apply_model_state(self, state) -> None:
        self.mean = np.asarray(state["mean"])
        self.std = np.asarray(state["std"])
        self.__dict__.pop("_device_tables", None)


@register_stage
class StandardScalerEstimator(Estimator):
    operation_name = "zNormalize"
    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(OPVector)

    def fit_columns(self, store: ColumnStore) -> StandardScalerModel:
        vals = store[self.input_features[0].name].values
        mean = vals.mean(axis=0)
        std = vals.std(axis=0)
        return StandardScalerModel(mean=mean,
                                   std=np.where(std < 1e-12, 1.0, std))
