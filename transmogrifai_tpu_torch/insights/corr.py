"""RecordInsightsCorr — correlation-based per-record feature attributions;
the port of ``transmogrifai_tpu/insights/corr.py``.

Parity: ``core/.../impl/insights/RecordInsightsCorr.scala:55-165``: the fit
computes the correlation of every feature column with every prediction
score column and a MinMax normalizer of the features; the transform scores
each row as ``importance[k, j] = corr[k, j] * normalized_x[j]`` and keeps
the top-K absolute contributors per prediction column.

Both run on the device in float64: the correlations are one gram product
over the centred [features | scores] matrix, the importances one [n, p, d]
broadcast product ranked by a stable descending sort of |importance|, and
only each (row, score column)'s top K come back to the host, for the JSON
cells.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..columns import (Column, ColumnStore, PredictionColumn, TextColumn,
                       VectorColumn)
from ..models.base import resolve_device
from ..stages.base import (AllowLabelAsInput, Estimator, FittedModel,
                           FixedArity, InputSpec, register_stage)
from ..types.feature_types import OPVector, Prediction, TextMap

__all__ = ["RecordInsightsCorr", "RecordInsightsCorrModel"]


def _scores_of(col: PredictionColumn) -> np.ndarray:
    """[n, p] score matrix: probabilities when present, else prediction."""
    if col.probability.shape[1] > 0:
        return np.asarray(col.probability, dtype=np.float64)
    return np.asarray(col.prediction, dtype=np.float64)[:, None]


def _put(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)


@register_stage
class RecordInsightsCorrModel(FittedModel, AllowLabelAsInput):
    """Fitted: corr [p, d] + MinMax normalizer stats."""

    operation_name = "recordInsightsCorr"
    output_type = TextMap
    uses_device = True

    def __init__(self, corr: Optional[np.ndarray] = None,
                 x_min: Optional[np.ndarray] = None,
                 x_max: Optional[np.ndarray] = None,
                 top_k: int = 20,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.corr = np.asarray(corr) if corr is not None else None
        self.x_min = np.asarray(x_min) if x_min is not None else None
        self.x_max = np.asarray(x_max) if x_max is not None else None
        self.top_k = top_k

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Prediction, OPVector)

    def importances(self, X: np.ndarray, device=None):
        """Each (row, score column)'s top K columns by |importance| (a
        stable sort, so ties keep the columns' order) and their
        importances: ([n, p, K] int64, [n, p, K] float64) on the host."""
        dev = resolve_device(device)
        Xd = _put(X, dev)
        lo, hi = _put(self.x_min, dev), _put(self.x_max, dev)
        Xn = (Xd - lo) / torch.clamp(hi - lo, min=1e-12)      # MinMax norm
        corr = torch.nan_to_num(_put(self.corr, dev), nan=0.0)  # [p, d]
        imp = corr.unsqueeze(0) * Xn.unsqueeze(1)              # [n, p, d]
        k = min(self.top_k, X.shape[1])
        order = torch.sort(-imp.abs(), dim=2, stable=True).indices[..., :k]
        return (order.cpu().numpy(),
                torch.gather(imp, 2, order).cpu().numpy())

    def transform_columns(self, store: ColumnStore, device=None) -> Column:
        xcol = store[self.input_features[1].name]
        assert isinstance(xcol, VectorColumn)
        X = np.asarray(xcol.values, dtype=np.float64)
        n, d = X.shape
        meta = xcol.metadata
        names = (meta.column_names() if meta is not None and meta.size == d
                 else [f"f_{i}" for i in range(d)])
        order, top = self.importances(X, device=device)
        out = np.empty((n,), dtype=object)
        for i in range(n):
            row: Dict[str, List[List[float]]] = {}
            for kk in range(order.shape[1]):
                for j, v in zip(order[i, kk], top[i, kk]):
                    if v != 0.0:
                        row.setdefault(names[j], []).append(
                            [int(kk), round(float(v), 10)])
            out[i] = json.dumps(row)
        return TextColumn(TextMap, out)

    def get_model_state(self) -> Dict[str, Any]:
        return {"corr": self.corr, "x_min": self.x_min, "x_max": self.x_max}


@register_stage
class RecordInsightsCorr(Estimator, AllowLabelAsInput):
    """Estimator(Prediction, OPVector) → TextMap of per-record insights."""

    operation_name = "recordInsightsCorr"
    output_type = TextMap
    uses_device = True

    def __init__(self, top_k: int = 20, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.top_k = top_k

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Prediction, OPVector)

    def fit_columns(self, store: ColumnStore, device=None,
                    dtype: torch.dtype = torch.float64
                    ) -> RecordInsightsCorrModel:
        """The correlations on ``device`` (default: the card), always in
        float64 (``dtype`` is the workflow's and is not read)."""
        pcol = store[self.input_features[0].name]
        xcol = store[self.input_features[1].name]
        assert isinstance(pcol, PredictionColumn)
        assert isinstance(xcol, VectorColumn)
        dev = resolve_device(device)
        X = _put(xcol.values, dev)
        Z = torch.cat([X, _put(_scores_of(pcol), dev)], dim=1)
        Zc = Z - Z.mean(dim=0)
        cov = Zc.T @ Zc / max(Z.shape[0] - 1, 1)
        std = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
        corr_full = cov / torch.clamp(torch.outer(std, std), min=1e-30)
        d = X.shape[1]
        return RecordInsightsCorrModel(
            corr=corr_full[d:, :d].cpu().numpy(),
            x_min=X.min(dim=0).values.cpu().numpy(),
            x_max=X.max(dim=0).values.cpu().numpy(), top_k=self.top_k)
