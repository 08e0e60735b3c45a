"""RecordInsightsLOCO — per-row leave-one-column-out feature attributions;
the port of ``transmogrifai_tpu/insights/loco.py``.

Parity: ``core/.../impl/insights/RecordInsightsLOCO.scala:99-170``: for each
row, zero each vector slot, re-score, record the score diff, and keep the
top-K contributors by |diff|.

The whole computation is batched on the model's device: for a chunk of C
columns the zeroed [C, n, d] tensor is built there from the uploaded rows,
flattened to [C·n, d] and scored by one ``predict_device`` call (a tree
model's is one ``predict_trees`` launch), so the batch never crosses the
host link. The per-row ranking is a stable descending sort of |diff| on the
device, and only each row's top K (indices and diffs) comes back to the
host, for the JSON cells. ``column_chunk`` bounds the batch at
``column_chunk · n · d`` values of the model's dtype.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..columns import Column, ColumnStore, TextColumn, VectorColumn
from ..models.base import resolve_device
from ..stages.base import FixedArity, InputSpec, Transformer, register_stage
from ..types.feature_types import OPVector, TextMap

__all__ = ["RecordInsightsLOCO", "parse_insights"]


@register_stage
class RecordInsightsLOCO(Transformer):
    """Transformer(OPVector) → TextMap (JSON per row of the top-K LOCO
    diffs).

    ``model`` is the fitted predictor whose score is explained (the
    reference takes it as a constructor argument, RecordInsightsLOCO.scala
    :60); a save records its uid and a load re-attaches it
    (:meth:`rebind_stages`).
    """

    operation_name = "recordInsightsLOCO"
    output_type = TextMap
    #: the workflow passes ``device=`` to this stage's transform
    uses_device = True

    def __init__(self, model: Optional[Any] = None, top_k: int = 20,
                 column_chunk: int = 128, model_uid: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.model = model
        self.model_uid = model_uid or getattr(model, "uid", None)
        self.top_k = top_k
        self.column_chunk = column_chunk

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(OPVector)

    # -- scoring helpers ---------------------------------------------------
    @staticmethod
    def _strength(pred: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
        """Scalar score to diff: P(class 1) for binary, the max
        probability for multiclass, the prediction for regression."""
        if prob.dim() == 2 and prob.shape[1] == 2:
            return prob[:, 1]
        if prob.dim() == 2 and prob.shape[1] > 2:
            return prob.max(dim=1).values
        return pred

    def _diffs_device(self, X: np.ndarray, dev: torch.device
                      ) -> torch.Tensor:
        """[d, n] score diffs (base − score with the column zeroed) on
        ``dev``, in the dtype the model scores in."""
        n, d = X.shape
        Xd = torch.as_tensor(np.asarray(X), device=dev)
        pred0, _raw0, prob0 = self.model.predict_device(Xd)
        base = self._strength(pred0, prob0)                      # [n]
        Xd = Xd.to(base.dtype)
        diffs = torch.empty((d, n), dtype=base.dtype, device=dev)
        for start in range(0, d, self.column_chunk):
            cols = torch.arange(start, min(start + self.column_chunk, d),
                                device=dev)
            C = cols.shape[0]
            Xz = Xd.unsqueeze(0).expand(C, n, d).clone()         # [C, n, d]
            Xz[torch.arange(C, device=dev), :, cols] = 0.0
            pred, _raw, prob = self.model.predict_device(
                Xz.reshape(C * n, d))
            del Xz
            s = self._strength(pred, prob).reshape(C, n)
            diffs[start:start + C] = base.unsqueeze(0) - s
        return diffs

    def loco_diffs(self, X: np.ndarray, device=None) -> np.ndarray:
        """[d, n] score diffs as host float64: base − score with the column
        zeroed, computed on ``device`` (default: the card)."""
        return self._diffs_device(X, resolve_device(device)).to(
            "cpu", torch.float64).numpy()

    def top_diffs(self, X: np.ndarray, device=None):
        """Each row's top K columns by |diff| (a stable descending sort on
        the device, so tied |diffs| keep the columns' order) and their
        diffs: ([K, n] int64, [K, n] float64) on the host."""
        diffs = self._diffs_device(X, resolve_device(device))
        k = min(self.top_k, diffs.shape[0])
        order = torch.sort(-diffs.abs(), dim=0, stable=True).indices[:k]
        top = torch.gather(diffs, 0, order)
        return (order.cpu().numpy(),
                top.to("cpu", torch.float64).numpy())

    # -- stage API ---------------------------------------------------------
    def transform_columns(self, store: ColumnStore, device=None) -> Column:
        if self.model is None:
            raise RuntimeError(
                f"{self.stage_name()}: model is unbound. The model reference "
                "is serialized by uid (model_uid="
                f"{self.model_uid!r}); load via WorkflowModel (which rebinds "
                "it) or pass model= explicitly.")
        col = store[self.input_features[0].name]
        assert isinstance(col, VectorColumn)
        X = np.asarray(col.values, dtype=np.float64)
        n, d = X.shape
        meta = col.metadata
        names = (meta.column_names() if meta is not None and meta.size == d
                 else [f"f_{i}" for i in range(d)])
        order, top = self.top_diffs(X, device=device)
        out = np.empty((n,), dtype=object)
        for i in range(n):
            out[i] = json.dumps({names[j]: round(float(v), 10)
                                 for j, v in zip(order[:, i], top[:, i])
                                 if v != 0.0})
        return TextColumn(TextMap, out)

    def get_params(self) -> Dict[str, Any]:
        p = super().get_params()
        p.pop("model", None)  # re-bound by uid: see rebind_stages
        p["model_uid"] = self.model_uid
        return p

    def copy(self):
        new = super().copy()
        new.model = self.model  # carry the live reference through copy_dag
        return new

    def rebind_stages(self, stage_by_uid: Dict[str, Any]) -> None:
        """Re-attach the scored model after a load (model_io)."""
        if self.model is None and self.model_uid:
            self.model = stage_by_uid.get(self.model_uid)


def parse_insights(value: str) -> Dict[str, float]:
    """Parse one LOCO output cell (RecordInsightsParser analog)."""
    return {} if value is None else json.loads(value)
