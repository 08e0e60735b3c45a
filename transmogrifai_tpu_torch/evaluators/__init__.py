"""Evaluators — metrics over scored stores: binary and multiclass
classification, regression, and calibration bins with the Brier score.

Port of ``transmogrifai_tpu/evaluators/__init__.py``: an evaluator reads
the label column and the Prediction struct column; ``evaluate_all``
returns the metric bundle, ``evaluate`` the selection metric, and
``Evaluators.BinaryClassification.auPR()`` picks it (``Evaluators.scala:40``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..columns import ColumnStore, PredictionColumn
from ..features import Feature
from .metrics import (binary_metrics, multiclass_metrics,
                      multiclass_threshold_metrics, regression_metrics)

__all__ = ["OpEvaluatorBase", "BinaryClassificationEvaluator",
           "MultiClassificationEvaluator", "RegressionEvaluator",
           "BinScoreEvaluator", "Evaluators", "binary_metrics", "multiclass_metrics",
           "regression_metrics", "multiclass_threshold_metrics"]


class OpEvaluatorBase:
    """Reads (label, prediction) columns; computes metrics."""

    large_better_metrics = frozenset({
        "AuROC", "AuPR", "Precision", "Recall", "F1", "R2"})
    default_metric = "AuROC"
    name = "evaluator"

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None,
                 metric_name: Optional[str] = None):
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.metric_name = metric_name or self.default_metric
        self.is_larger_better = self.metric_name in self.large_better_metrics

    def set_columns(self, label: Any, prediction: Any) -> "OpEvaluatorBase":
        self.label_col = label.name if isinstance(label, Feature) else label
        self.prediction_col = (prediction.name
                               if isinstance(prediction, Feature)
                               else prediction)
        return self

    def _extract(self, store: ColumnStore):
        y = np.asarray(store[self.label_col].values, dtype=np.float64)
        pred_col = store[self.prediction_col]
        if not isinstance(pred_col, PredictionColumn):
            raise TypeError(
                f"Prediction column {self.prediction_col!r} is "
                f"{type(pred_col).__name__}, expected PredictionColumn")
        return y, pred_col

    def evaluate_all(self, store: ColumnStore) -> Dict[str, Any]:
        raise NotImplementedError

    def evaluate(self, store: ColumnStore) -> float:
        return self.evaluate_all(store)[self.metric_name]


class BinaryClassificationEvaluator(OpEvaluatorBase):
    name = "binEval"
    default_metric = "AuROC"

    def evaluate_all(self, store: ColumnStore) -> Dict[str, Any]:
        y, pred = self._extract(store)
        scores = (pred.probability[:, 1] if pred.probability.shape[1] >= 2
                  else pred.prediction)
        return binary_metrics(y, pred.prediction, scores)


class MultiClassificationEvaluator(OpEvaluatorBase):
    """Weighted P/R/F1/Error and the topN × confidence-threshold metrics
    (``OpMultiClassificationEvaluator.scala:120-229``)."""

    name = "multiEval"
    default_metric = "F1"

    def __init__(self, top_ns=(1, 3), thresholds=None, **kw):
        super().__init__(**kw)
        self.top_ns = tuple(top_ns)
        self.thresholds = thresholds

    def evaluate_all(self, store: ColumnStore) -> Dict[str, Any]:
        y, pred = self._extract(store)
        out: Dict[str, Any] = multiclass_metrics(y, pred.prediction)
        if pred.probability.ndim == 2 and pred.probability.shape[1] >= 2:
            out["ThresholdMetrics"] = multiclass_threshold_metrics(
                y, pred.probability, top_ns=self.top_ns,
                thresholds=self.thresholds)
        return out


class RegressionEvaluator(OpEvaluatorBase):
    name = "regEval"
    default_metric = "RootMeanSquaredError"

    def evaluate_all(self, store: ColumnStore) -> Dict[str, float]:
        y, pred = self._extract(store)
        return regression_metrics(y, pred.prediction)


class BinScoreEvaluator(OpEvaluatorBase):
    """Calibration bins + Brier score (OpBinScoreEvaluator.scala)."""

    name = "binScoreEval"
    default_metric = "BrierScore"

    def __init__(self, num_bins: int = 100, **kw):
        super().__init__(**kw)
        self.num_bins = num_bins

    def evaluate_all(self, store: ColumnStore) -> Dict[str, Any]:
        y, pred = self._extract(store)
        scores = (pred.probability[:, 1] if pred.probability.shape[1] >= 2
                  else pred.prediction)
        brier = float(np.mean((scores - y) ** 2)) if len(y) else 0.0
        edges = np.linspace(0.0, 1.0, self.num_bins + 1)
        idx = np.clip(np.digitize(scores, edges) - 1, 0, self.num_bins - 1)
        counts = np.bincount(idx, minlength=self.num_bins)
        sum_scores = np.bincount(idx, weights=scores,
                                 minlength=self.num_bins)
        sum_labels = np.bincount(idx, weights=y, minlength=self.num_bins)
        nonzero = counts > 0
        return {
            "BrierScore": brier,
            "BinCenters": ((edges[:-1] + edges[1:]) / 2)[nonzero].tolist(),
            "NumberOfDataPoints": counts[nonzero].tolist(),
            "AverageScore": (sum_scores[nonzero]
                             / counts[nonzero]).tolist(),
            "AverageConversionRate": (sum_labels[nonzero]
                                      / counts[nonzero]).tolist(),
        }


class _EvalFactory:
    def __init__(self, cls):
        self._cls = cls

    def __call__(self, **kw):
        return self._cls(**kw)

    def __getattr__(self, metric: str):
        canonical = {"aupr": "AuPR", "auroc": "AuROC",
                     "precision": "Precision", "recall": "Recall",
                     "f1": "F1", "error": "Error",
                     "rmse": "RootMeanSquaredError",
                     "mse": "MeanSquaredError", "mae": "MeanAbsoluteError",
                     "r2": "R2"}
        m = canonical.get(metric.lower())
        if m is None:
            raise AttributeError(metric)
        cls = self._cls
        return lambda **kw: cls(metric_name=m, **kw)


class Evaluators:
    """Factory (Evaluators.scala:40)."""

    BinaryClassification = _EvalFactory(BinaryClassificationEvaluator)
    MultiClassification = _EvalFactory(MultiClassificationEvaluator)
    Regression = _EvalFactory(RegressionEvaluator)
    BinScore = _EvalFactory(BinScoreEvaluator)
