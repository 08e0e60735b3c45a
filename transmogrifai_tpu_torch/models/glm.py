"""Generalized linear models by IRLS — the port of
``transmogrifai_tpu/models/glm.py`` (``OpGeneralizedLinearRegression.scala``,
Spark ``GeneralizedLinearRegression``); the selector grid follows
``DefaultSelectorParams.DistFamily = gaussian, poisson``
(``DefaultSelectorParams.scala:56``).

One IRLS loop whose family-specific link and variance terms are picked by
branchless ``where`` chains on a per-point family id, so a whole (family ×
regParam) grid of G points iterates together: each iteration builds the
[G, d+1, d+1] weighted normal equations and takes one batched
``torch.linalg.solve``. Families: gaussian (identity link), poisson (log),
gamma (log), binomial (logit). The intercept is not penalized.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..stages.base import register_stage
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   device_table, extract_xy, resolve_device)

__all__ = ["OpGeneralizedLinearRegression", "GLMRegressionModel",
           "GLMRegressionFamily", "FAMILY_IDS", "fit_glm", "predict_glm"]

FAMILY_IDS = {"gaussian": 0, "poisson": 1, "gamma": 2, "binomial": 3}
_EPS = 1e-9


def _inv_link(eta: torch.Tensor, fam: torch.Tensor) -> torch.Tensor:
    """μ = g⁻¹(η), branchless on the family id (broadcast against η)."""
    eta_c = torch.clamp(eta, -30.0, 30.0)
    mu_log = torch.exp(eta_c)
    mu_logit = torch.sigmoid(eta_c)
    return torch.where(fam == 0, eta, torch.where(fam == 3, mu_logit, mu_log))


def _irls_terms(mu: torch.Tensor, fam: torch.Tensor):
    """(dμ/dη, Var(μ)) per family, branchless."""
    one = torch.ones_like(mu)
    dmu = torch.where(fam == 0, one,
                      torch.where(fam == 3, mu * (1.0 - mu), mu))
    var = torch.where(fam == 0, one,
                      torch.where(fam == 1, mu,
                                  torch.where(fam == 2, mu * mu,
                                              mu * (1.0 - mu))))
    return dmu, torch.clamp(var, min=_EPS)


def fit_glm(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fam,
            reg_param, max_iter: int = 25):
    """IRLS with ridge regularization at G grid points (``fam`` and
    ``reg_param`` of G values) → (coef [G, d], intercept [G])."""
    n, d = X.shape
    dev, dt = X.device, X.dtype
    fam = torch.as_tensor(fam, device=dev).reshape(-1, 1)         # [G, 1]
    reg = torch.as_tensor(reg_param, dtype=dt, device=dev).reshape(-1)
    G = fam.shape[0]
    Xa = torch.cat([X, torch.ones((n, 1), dtype=dt, device=dev)], dim=1)
    # poisson / gamma need a positive working response to start
    y_safe = torch.where(fam == 0, y, torch.clamp(y, min=0.1))     # [G, n]
    eta0 = torch.where(
        fam == 0, y,
        torch.where(fam == 3,
                    torch.log((y_safe + 0.5)
                              / torch.clamp(1.5 - y_safe, min=0.5)),
                    torch.log(y_safe)))
    beta = torch.zeros((G, d + 1), dtype=dt, device=dev)
    beta[:, d] = (w * eta0).sum(1) / torch.clamp(w.sum(), min=1.0)
    ridge = torch.cat([torch.ones(d, dtype=dt, device=dev),
                       torch.zeros(1, dtype=dt, device=dev)])
    penalty = (reg * n)[:, None, None] * torch.diag(ridge)          # [G, p, p]
    for _ in range(max_iter):
        eta = beta @ Xa.T                                           # [G, n]
        mu = _inv_link(eta, fam)
        dmu, var = _irls_terms(mu, fam)
        W = w * dmu * dmu / var
        z = eta + (y - mu) / torch.where(dmu.abs() > _EPS, dmu,
                                         torch.full_like(dmu, _EPS))
        XtW = Xa.T[None] * W[:, None, :]                            # [G, p, n]
        A = XtW @ Xa + penalty
        b = (XtW @ z[:, :, None])[:, :, 0]
        beta = torch.linalg.solve(A, b)
    return beta[:, :d], beta[:, d]


def predict_glm(coef: torch.Tensor, intercept, X: torch.Tensor, fam):
    """One grid point → (μ, empty raw [n, 0], empty prob [n, 0])."""
    fam = torch.as_tensor(fam, device=X.device)
    mu = _inv_link(X @ coef + intercept, fam)
    empty = torch.zeros((X.shape[0], 0), dtype=X.dtype, device=X.device)
    return mu, empty, empty


@register_stage
class GLMRegressionModel(PredictorModel):
    """Fitted GLM: prediction = g⁻¹(Xβ + β₀)."""

    operation_name = "glm"

    def __init__(self, coefficients=None, intercept: float = 0.0,
                 family: str = "gaussian", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.coefficients = (np.asarray(coefficients, dtype=np.float64)
                             if coefficients is not None else None)
        self.intercept = float(intercept) if intercept is not None else 0.0
        self.family = family

    def predict_device(self, Xd: torch.Tensor):
        coef = device_table(self, "coefficients", lambda: self.coefficients,
                            Xd.device)
        b = device_table(self, "intercept",
                         lambda: np.float64(self.intercept), Xd.device)
        fam = device_table(self, "family",
                           lambda: np.int64(FAMILY_IDS[self.family]),
                           Xd.device)
        return predict_glm(coef, b, Xd.to(coef.dtype), fam)

    def get_model_state(self):
        return {"coefficients": self.coefficients,
                "intercept": self.intercept, "family": self.family}

    def apply_model_state(self, state) -> None:
        for k, v in state.items():
            setattr(self, k, v)
        self.__dict__.pop("_device_tables", None)

    def summary(self):
        return {"model": "GeneralizedLinearRegression",
                "family": self.family,
                "numFeatures": int(self.coefficients.shape[0])}


@register_stage
class OpGeneralizedLinearRegression(PredictorEstimator):
    """Estimator(label, features) → GLM prediction."""

    operation_name = "glm"

    def __init__(self, family: str = "gaussian", reg_param: float = 0.0,
                 max_iter: int = 25, uid: Optional[str] = None):
        super().__init__(uid=uid)
        if family not in FAMILY_IDS:
            raise ValueError(f"Unknown GLM family {family!r}; "
                             f"one of {sorted(FAMILY_IDS)}")
        self.family = family
        self.reg_param = reg_param
        self.max_iter = max_iter

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32) -> GLMRegressionModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        dev = resolve_device(device)
        coef, b = fit_glm(torch.as_tensor(X, dtype=dtype, device=dev),
                          torch.as_tensor(y, dtype=dtype, device=dev),
                          torch.ones((X.shape[0],), dtype=dtype, device=dev),
                          [FAMILY_IDS[self.family]], [self.reg_param],
                          max_iter=self.max_iter)
        return GLMRegressionModel(coef[0].cpu().numpy(), float(b[0]),
                                  self.family)


class GLMRegressionFamily(ModelFamily):
    """(family × regParam) grid, one batched IRLS fit."""

    name = "OpGeneralizedLinearRegression"
    default_grid = [
        {"family": f, "regParam": r}
        for f in ("gaussian", "poisson")            # DefaultSelectorParams:56
        for r in (0.001, 0.01, 0.1, 0.2)            # .Regularization
    ]

    def __init__(self, grid=None, max_iter: int = 25):
        super().__init__(grid)
        self.max_iter = max_iter

    def param_defaults(self) -> Dict[str, Any]:
        return {"family": "gaussian", "regParam": 0.0}

    def fit_batch(self, X, y, w, grid=None) -> List:
        grid = self.grid if grid is None else grid
        fams = [FAMILY_IDS[g.get("family", "gaussian")] for g in grid]
        coef, b = fit_glm(X, y, w, fams,
                          [float(g.get("regParam", 0.0)) for g in grid],
                          max_iter=self.max_iter)
        return [(coef[i], b[i], fams[i]) for i in range(len(grid))]

    def predict_batch(self, params, X, on_train: bool = False) -> List:
        return [predict_glm(c, b, X, f) for c, b, f in params]

    def realize(self, params, hparams) -> GLMRegressionModel:
        coef, b, _fam = params
        return GLMRegressionModel(coef.detach().cpu().numpy(), float(b),
                                  hparams.get("family", "gaussian"))
