"""Host metrics in numpy: a copy of
``transmogrifai_tpu/evaluators/metrics.py`` (binary, multiclass with its
top-N threshold metrics, regression).

AuROC/AuPR follow MLlib's threshold-curve construction: thresholds at every
distinct score, ROC prepended with (0,0) and appended with (1,1), PR
prepended with (0, p@first-threshold); areas by trapezoid.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["binary_metrics", "multiclass_metrics", "regression_metrics",
           "binary_threshold_curves", "multiclass_threshold_metrics",
           "auroc", "aupr", "confusion_binary"]


def _curve_points(labels: np.ndarray, scores: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Cumulative TP/FP at each distinct score threshold (descending)."""
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    y = labels[order]
    # group equal scores: take cumulative counts at last index of each group
    boundaries = np.nonzero(np.diff(s))[0]
    idx = np.concatenate([boundaries, [len(s) - 1]])
    tp_cum = np.cumsum(y)[idx].astype(np.float64)
    fp_cum = np.cumsum(1 - y)[idx].astype(np.float64)
    p = float(labels.sum())
    n = float(len(labels) - p)
    return tp_cum, fp_cum, p, n


def auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    tp, fp, p, n = _curve_points(labels, scores)
    if p == 0 or n == 0:
        return 0.0
    tpr = np.concatenate([[0.0], tp / p, [1.0]])
    fpr = np.concatenate([[0.0], fp / n, [1.0]])
    return float(np.trapezoid(tpr, fpr))


def aupr(labels: np.ndarray, scores: np.ndarray) -> float:
    tp, fp, p, _ = _curve_points(labels, scores)
    if p == 0:
        return 0.0
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / p
    # MLlib prepends (0, precision@first)
    precision = np.concatenate([[precision[0]], precision])
    recall = np.concatenate([[0.0], recall])
    return float(np.trapezoid(precision, recall))


def confusion_binary(labels: np.ndarray, predictions: np.ndarray
                     ) -> Tuple[float, float, float, float]:
    tp = float(np.sum((predictions == 1) & (labels == 1)))
    tn = float(np.sum((predictions == 0) & (labels == 0)))
    fp = float(np.sum((predictions == 1) & (labels == 0)))
    fn = float(np.sum((predictions == 0) & (labels == 1)))
    return tp, tn, fp, fn


def binary_metrics(labels: np.ndarray, predictions: np.ndarray,
                   scores: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Precision/Recall/F1/Error/AuROC/AuPR/TP/TN/FP/FN
    (OpBinaryClassificationEvaluator.scala:180-203)."""
    labels = np.asarray(labels, dtype=np.float64)
    predictions = np.asarray(predictions, dtype=np.float64)
    tp, tn, fp, fn = confusion_binary(labels, predictions)
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    err = (fp + fn) / max(len(labels), 1)
    out = {"Precision": precision, "Recall": recall, "F1": f1, "Error": err,
           "TP": tp, "TN": tn, "FP": fp, "FN": fn}
    if scores is not None:
        scores = np.asarray(scores, dtype=np.float64)
        out["AuROC"] = auroc(labels, scores)
        out["AuPR"] = aupr(labels, scores)
    return out


def multiclass_metrics(labels: np.ndarray, predictions: np.ndarray
                       ) -> Dict[str, float]:
    """Weighted Precision/Recall/F1 + Error (MulticlassMetrics parity)."""
    labels = np.asarray(labels).astype(np.int64)
    predictions = np.asarray(predictions).astype(np.int64)
    classes = np.unique(np.concatenate([labels, predictions]))
    n = max(len(labels), 1)
    w_prec = w_rec = w_f1 = 0.0
    for c in classes:
        tp = float(np.sum((predictions == c) & (labels == c)))
        fp = float(np.sum((predictions == c) & (labels != c)))
        fn = float(np.sum((predictions != c) & (labels == c)))
        weight = float(np.sum(labels == c)) / n
        prec = tp / (tp + fp) if tp + fp > 0 else 0.0
        rec = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
        w_prec += weight * prec
        w_rec += weight * rec
        w_f1 += weight * f1
    error = float(np.mean(labels != predictions)) if len(labels) else 0.0
    return {"Precision": w_prec, "Recall": w_rec, "F1": w_f1, "Error": error}


def regression_metrics(labels: np.ndarray, predictions: np.ndarray
                       ) -> Dict[str, float]:
    labels = np.asarray(labels, dtype=np.float64)
    predictions = np.asarray(predictions, dtype=np.float64)
    resid = labels - predictions
    mse = float(np.mean(resid ** 2)) if len(labels) else 0.0
    mae = float(np.mean(np.abs(resid))) if len(labels) else 0.0
    var = float(np.mean((labels - labels.mean()) ** 2)) if len(labels) else 0.0
    r2 = 1.0 - mse / var if var > 0 else 0.0
    return {"RootMeanSquaredError": float(np.sqrt(mse)),
            "MeanSquaredError": mse, "MeanAbsoluteError": mae, "R2": r2}


def binary_threshold_curves(labels: np.ndarray, scores: np.ndarray,
                            max_points: int = 200) -> Dict[str, list]:
    """Threshold curves (BinaryClassificationMetrics parity): thresholds +
    precision/recall/TPR/FPR by threshold, downsampled to ≤ max_points."""
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if len(labels) == 0:
        return {"thresholds": [], "precisionByThreshold": [],
                "recallByThreshold": [], "falsePositiveRateByThreshold": []}
    tp, fp, p, n = _curve_points(labels, scores)
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    idx = np.concatenate([np.nonzero(np.diff(s))[0], [len(s) - 1]])
    thresholds = s[idx]
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / max(p, 1e-12)
    fpr = fp / max(n, 1e-12)
    if thresholds.size > max_points:
        pick = np.linspace(0, thresholds.size - 1, max_points).astype(int)
        thresholds, precision, recall, fpr = (
            thresholds[pick], precision[pick], recall[pick], fpr[pick])
    return {"thresholds": thresholds.tolist(),
            "precisionByThreshold": precision.tolist(),
            "recallByThreshold": recall.tolist(),
            "falsePositiveRateByThreshold": fpr.tolist()}


def multiclass_threshold_metrics(labels: np.ndarray, probabilities: np.ndarray,
                                 top_ns: Tuple[int, ...] = (1, 3),
                                 thresholds: Optional[np.ndarray] = None
                                 ) -> Dict[str, object]:
    """Top-N threshold metrics — exact port of
    ``OpMultiClassificationEvaluator.calculateThresholdMetrics``
    (``core/.../evaluators/OpMultiClassificationEvaluator.scala:154-229``).

    Per row with true-class score ``s_true = probs[label]`` and top score
    ``s_max = max(probs)``, at each threshold t:

    * label within the top-N indices and ``t ≤ s_true`` → **correct**;
    * otherwise ``t ≤ s_max`` → **incorrect** (note: a topN hit whose
      true-class score falls below t while the top score stays above is
      *incorrect*, not merely unpredicted — the serving-threshold
      semantics the round-3 draft got wrong);
    * ``t > s_max`` → **no prediction**.

    correct + incorrect + noPrediction = n at every (topN, threshold).
    Defaults match the reference: topNs (1, 3), thresholds 0.00..1.00
    step 0.01 (``setDefault(thresholds, (0 to 100).map(_ / 100.0))``).
    Vectorized: one argsort + cumulative histograms per topN.
    """
    labels = np.asarray(labels).astype(np.int64)
    probs = np.asarray(probabilities, dtype=np.float64)
    if thresholds is None:
        thresholds = np.linspace(0.0, 1.0, 101)
    # per-threshold counts are order-independent; sort so the cutoff
    # searches are well-defined for any user-supplied order (the output
    # reports the sorted thresholds)
    thresholds = np.sort(np.asarray(thresholds, dtype=np.float64))
    n_t = len(thresholds)
    out: Dict[str, object] = {"topNs": list(top_ns),
                              "thresholds": thresholds.tolist(),
                              "correctCounts": {}, "incorrectCounts": {},
                              "noPredictionCounts": {}}
    if probs.size == 0:
        for k in top_ns:
            out["correctCounts"][k] = [0] * n_t
            out["incorrectCounts"][k] = [0] * n_t
            out["noPredictionCounts"][k] = [0] * n_t
        return out
    n_rows, n_cls = probs.shape
    safe_lab = np.clip(labels, 0, n_cls - 1)
    true_score = probs[np.arange(n_rows), safe_lab]
    top_score = probs.max(axis=1)
    rank_order = np.argsort(-probs, axis=1, kind="stable")   # [n, K]
    # cutoff index: first threshold STRICTLY above the score — the row
    # counts (as correct/predicted) at indices < cutoff
    true_cut = np.searchsorted(thresholds, true_score, side="right")
    max_cut = np.searchsorted(thresholds, top_score, side="right")

    def below_counts(cuts):
        """[n_t] array: c[i] = #rows with cutoff > i (i.e. counted at i)."""
        h = np.bincount(cuts, minlength=n_t + 1)[:n_t + 1]
        ge = np.cumsum(h[::-1])[::-1]                 # ge[j] = #cuts ≥ j
        return ge[1:]                                 # #cuts > i = ge[i+1]

    for k in top_ns:
        in_topk = (rank_order[:, :min(k, n_cls)]
                   == labels[:, None]).any(axis=1)
        cor_at = below_counts(true_cut[in_topk])
        # topN hits turn incorrect between the true-score and top-score
        # cutoffs; misses are incorrect up to the top-score cutoff
        inc_at = (below_counts(max_cut[in_topk])
                  - below_counts(true_cut[in_topk])
                  + below_counts(max_cut[~in_topk]))
        out["correctCounts"][k] = cor_at.tolist()
        out["incorrectCounts"][k] = inc_at.tolist()
        out["noPredictionCounts"][k] = (n_rows - cor_at - inc_at).tolist()
    return out
