"""Linear SVC stages — the port of ``transmogrifai_tpu/models/svm.py``
(``OpLinearSVC.scala``); the multilayer perceptron is not ported yet
(ROADMAP queue A, item 6).

The squared hinge (smooth; Spark's OWLQN hinge differs only in the loss
corner) with L2 regularization, solved by accelerated gradient descent on
standardized features (``models/_linfit.py``). Like Spark's LinearSVC the
model has no probability column; ``prob`` is a monotone sigmoid of the
margin, so threshold metrics (AuROC, AuPR) are defined. A grid of G
points is one batched fit.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..stages.base import register_stage
from ._linfit import fista, power_iter_sq_norm, standardize_stats
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   device_table, extract_xy, resolve_device, score_sigmoid)

__all__ = ["fit_linear_svc", "predict_linear_svc", "LinearSVCModel",
           "OpLinearSVC", "LinearSVCFamily"]


def fit_linear_svc(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   reg_param, max_iter: int = 64):
    """Squared-hinge L2 SVM at G grid points (``reg_param`` of G values),
    y ∈ {0, 1} → (coef [G, d], intercept [G])."""
    mean, std = standardize_stats(X, w)
    Xs = (X - mean) / std
    ypm = 2.0 * y - 1.0
    wsum = torch.clamp(w.sum(), min=1e-12)
    d = X.shape[1]
    reg = torch.as_tensor(reg_param, dtype=X.dtype,
                          device=X.device).reshape(-1, 1)

    def grad(params):                       # [G, d + 1]
        beta, b = params[:, :d], params[:, d:]
        m = beta @ Xs.T + b                 # [G, n]
        slack = torch.clamp(1.0 - ypm * m, min=0.0)
        g_m = w * (-2.0 * ypm * slack) / wsum
        return torch.cat([g_m @ Xs + reg * beta, g_m.sum(1, keepdim=True)],
                         dim=1)

    lip = 2.0 * power_iter_sq_norm(Xs, w) + reg + 1.0
    params0 = torch.zeros((len(reg), d + 1), dtype=X.dtype, device=X.device)
    params = fista(grad, lambda p, s: p, params0, 1.0 / lip, max_iter)
    coef = params[:, :d] / std
    return coef, params[:, d] - (coef * mean).sum(1)


def predict_linear_svc(coef: torch.Tensor, intercept, X: torch.Tensor):
    """One grid point → (prediction, raw [n, 2], prob [n, 2])."""
    m = X @ coef + intercept
    p1 = score_sigmoid(m)
    return ((m > 0.0).to(X.dtype), torch.stack([-m, m], dim=1),
            torch.stack([1.0 - p1, p1], dim=1))


@register_stage
class LinearSVCModel(PredictorModel):
    operation_name = "linearSVC"

    def __init__(self, coefficients=None, intercept=0.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.coefficients = (np.array(coefficients)
                             if coefficients is not None else None)
        self.intercept = np.array(0.0 if intercept is None else intercept)

    def predict_device(self, Xd: torch.Tensor):
        coef = device_table(self, "coefficients",
                            lambda: self.coefficients, Xd.device)
        b = device_table(self, "intercept", lambda: np.asarray(
            self.intercept, dtype=np.asarray(self.coefficients).dtype),
            Xd.device)
        return predict_linear_svc(coef, b, Xd.to(coef.dtype))

    def get_model_state(self):
        return {"coefficients": self.coefficients,
                "intercept": self.intercept}

    def apply_model_state(self, state) -> None:
        for k, v in state.items():
            setattr(self, k, v)
        self.__dict__.pop("_device_tables", None)

    def summary(self):
        return {"model": "LinearSVC",
                "numFeatures": int(self.coefficients.shape[0])}


@register_stage
class OpLinearSVC(PredictorEstimator):
    operation_name = "linearSVC"

    def __init__(self, reg_param: float = 0.0, max_iter: int = 64,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.reg_param = reg_param
        self.max_iter = max_iter

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32) -> LinearSVCModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        dev = resolve_device(device)
        coef, b = fit_linear_svc(
            torch.as_tensor(X, dtype=dtype, device=dev),
            torch.as_tensor(y, dtype=dtype, device=dev),
            torch.ones((X.shape[0],), dtype=dtype, device=dev),
            [self.reg_param], self.max_iter)
        return LinearSVCModel(coef[0].cpu().numpy(), b[0].cpu().numpy())


class LinearSVCFamily(ModelFamily):
    """Grid = Regularization (DefaultSelectorParams.Regularization)."""

    name = "OpLinearSVC"
    default_grid = [{"regParam": r} for r in (0.001, 0.01, 0.1, 0.2)]

    def __init__(self, grid=None, max_iter: int = 64, n_classes: int = 2):
        super().__init__(grid)
        self.max_iter = max_iter
        self.n_classes = n_classes   # binary only; the selector sets it

    def param_defaults(self):
        return {"regParam": 0.0}

    def fit_batch(self, X, y, w, grid=None):
        grid = self.grid if grid is None else grid
        coef, b = fit_linear_svc(
            X, y, w, [float(g.get("regParam", 0.0)) for g in grid],
            self.max_iter)
        return [(coef[i], b[i]) for i in range(len(grid))]

    def predict_batch(self, params, X, on_train: bool = False) -> List:
        return [predict_linear_svc(c, b, X) for c, b in params]

    def realize(self, params, hparams) -> LinearSVCModel:
        coef, b = params
        return LinearSVCModel(coef.detach().cpu().numpy(),
                              b.detach().cpu().numpy())
