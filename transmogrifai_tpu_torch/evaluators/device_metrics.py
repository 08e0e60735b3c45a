"""On-device metrics for the CV sweep, in PyTorch — the port of
``transmogrifai_tpu/evaluators/device_metrics.py``: binary, multiclass
(weighted precision / recall / F1 and the error) and regression (RMSE,
MSE, MAE, R2).

Semantics match ``evaluators/metrics.py`` (MLlib threshold curves): ties
are grouped per distinct score, ROC gets (0,0)/(1,1) endpoints, PR is
prepended with (0, p@first). Validation rows are selected by a 0/1 weight
vector: zero-weight rows add only duplicate curve points, which have zero
trapezoid width.
"""
from __future__ import annotations

import torch

__all__ = ["device_metric_fn", "DEVICE_METRICS", "auroc", "aupr",
           "multiclass_weighted", "multiclass_error", "rmse", "mse", "mae",
           "r2"]

_EPS = 1e-12


def _curve(y, s, w):
    """Weighted cumulative (tp, fp) at each sorted position's tie-group
    end, plus the totals (P, N)."""
    order = torch.argsort(-s, stable=True)
    ws = w[order]
    ys = y[order] * ws
    ss = s[order]
    tp = torch.cumsum(ys, 0)
    fp = torch.cumsum(ws - ys, 0)
    end = torch.searchsorted(-ss, -ss, right=True) - 1
    P = torch.sum(y * w)
    return tp[end], fp[end], P, torch.sum(w) - P


def _trapz(yv, xv):
    return 0.5 * torch.sum((xv[1:] - xv[:-1]) * (yv[1:] + yv[:-1]))


def auroc(y, s, w):
    tp, fp, P, N = _curve(y, s, w)
    one = torch.ones((1,), dtype=tp.dtype, device=tp.device)
    tpr = torch.cat([0 * one, tp / torch.clamp(P, min=_EPS), one])
    fpr = torch.cat([0 * one, fp / torch.clamp(N, min=_EPS), one])
    return torch.where((P > 0) & (N > 0), _trapz(tpr, fpr),
                       torch.zeros_like(P))


def aupr(y, s, w):
    tp, fp, P, _ = _curve(y, s, w)
    precision = tp / torch.clamp(tp + fp, min=_EPS)
    recall = tp / torch.clamp(P, min=_EPS)
    precision = torch.cat([precision[:1], precision])
    recall = torch.cat([torch.zeros_like(recall[:1]), recall])
    return torch.where(P > 0, _trapz(precision, recall), torch.zeros_like(P))


def _binary_confusion(y, pred, w):
    def tally(p, t):
        return torch.sum(w * ((pred == p) & (y == t)))
    return tally(1, 1), tally(0, 0), tally(1, 0), tally(0, 1)


def binary_precision(y, pred, w):
    tp, _, fp, _ = _binary_confusion(y, pred, w)
    return tp / torch.clamp(tp + fp, min=_EPS)


def binary_recall(y, pred, w):
    tp, _, _, fn = _binary_confusion(y, pred, w)
    return tp / torch.clamp(tp + fn, min=_EPS)


def binary_f1(y, pred, w):
    p = binary_precision(y, pred, w)
    r = binary_recall(y, pred, w)
    return 2.0 * p * r / torch.clamp(p + r, min=_EPS)


def binary_error(y, pred, w):
    return torch.sum(w * (pred != y)) / torch.clamp(torch.sum(w), min=_EPS)


def multiclass_weighted(y, pred, w, n_classes: int, which: str):
    """Weighted Precision / Recall / F1 over ``n_classes`` classes
    (MulticlassMetrics): each class's value weighted by its share of the
    validation weight."""
    classes = torch.arange(n_classes, device=y.device)
    oh_y = (classes[None, :] == y.long()[:, None]).to(w.dtype)
    oh_p = (classes[None, :] == pred.long()[:, None]).to(w.dtype)
    conf = (oh_y * w[:, None]).T @ oh_p              # [true, pred]
    tp = torch.diagonal(conf)
    per_true = (oh_y * w[:, None]).sum(0)
    per_pred = (oh_p * w[:, None]).sum(0)
    prec = tp / torch.clamp(per_pred, min=_EPS)
    rec = tp / torch.clamp(per_true, min=_EPS)
    f1 = 2.0 * prec * rec / torch.clamp(prec + rec, min=_EPS)
    cw = per_true / torch.clamp(torch.sum(w), min=_EPS)
    vals = {"Precision": prec, "Recall": rec, "F1": f1}[which]
    return torch.sum(cw * vals)


def multiclass_error(y, pred, w):
    return torch.sum(w * (pred != y)) / torch.clamp(torch.sum(w), min=_EPS)


def rmse(y, pred, w):
    return torch.sqrt(mse(y, pred, w))


def mse(y, pred, w):
    return torch.sum(w * (y - pred) ** 2) / torch.clamp(torch.sum(w),
                                                       min=_EPS)


def mae(y, pred, w):
    return torch.sum(w * torch.abs(y - pred)) / torch.clamp(torch.sum(w),
                                                           min=_EPS)


def r2(y, pred, w):
    W = torch.clamp(torch.sum(w), min=_EPS)
    mean = torch.sum(w * y) / W
    var = torch.sum(w * (y - mean) ** 2) / W
    m = torch.sum(w * (y - pred) ** 2) / W
    return torch.where(var > 0, 1.0 - m / var, torch.zeros_like(var))


#: (task, metric name) → (input kind, fn)
DEVICE_METRICS = {
    ("binary", "AuROC"): ("score", auroc),
    ("binary", "AuPR"): ("score", aupr),
    ("binary", "Precision"): ("pred", binary_precision),
    ("binary", "Recall"): ("pred", binary_recall),
    ("binary", "F1"): ("pred", binary_f1),
    ("binary", "Error"): ("pred", binary_error),
    ("multiclass", "Error"): ("pred", multiclass_error),
    ("regression", "RootMeanSquaredError"): ("pred", rmse),
    ("regression", "MeanSquaredError"): ("pred", mse),
    ("regression", "MeanAbsoluteError"): ("pred", mae),
    ("regression", "R2"): ("pred", r2),
}


def device_metric_fn(task: str, metric_name: str, n_classes: int = 2):
    """→ fn(y, pred, prob, w) → 0-dim tensor, or None when the metric has
    no device form (the validator then takes the host metrics). Score
    metrics read prob[:, 1] when the model has class probabilities, else
    the prediction; the multiclass weighted metrics count ``n_classes``
    classes."""
    if task == "multiclass" and metric_name in ("Precision", "Recall",
                                                 "F1"):
        def mc(y, pred, prob, w):
            return multiclass_weighted(y, pred, w, n_classes, metric_name)
        return mc
    entry = DEVICE_METRICS.get((task, metric_name))
    if entry is None:
        return None
    kind, fn = entry
    if kind == "score":
        def scored(y, pred, prob, w):
            s = prob[:, 1] if (prob.dim() == 2 and prob.shape[1] >= 2) \
                else pred
            return fn(y, s, w)
        return scored

    def predded(y, pred, prob, w):
        return fn(y, pred, w)
    return predded
