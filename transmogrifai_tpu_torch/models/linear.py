"""Logistic regression stages — the port of
``transmogrifai_tpu/models/linear.py`` for the binary case
(``OpLogisticRegression.scala``), fit by ``models/_linfit.py``.

The family fits its whole grid as one batched FISTA run ([G, d]
coefficients). Multinomial logistic regression, linear regression's
stages and naive Bayes are not ported yet (ROADMAP queue A, item 4).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..stages.base import register_stage
from . import _linfit as LF
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   extract_xy, resolve_device, to_f64)

__all__ = ["LogisticRegressionModel", "OpLogisticRegression",
           "LogisticRegressionFamily"]

_MULTINOMIAL = ("multinomial logistic regression is not ported yet "
                "(ROADMAP queue A, item 4)")


@register_stage
class LogisticRegressionModel(PredictorModel):
    """Binary logistic model: ``coefficients`` [d] and ``intercept``,
    kept in the dtype they were fit in; prediction runs in that dtype on
    ``device``."""

    operation_name = "logreg"

    def __init__(self, coefficients=None, intercept=None, n_classes: int = 2,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.coefficients = (np.array(coefficients)
                             if coefficients is not None else None)
        self.intercept = (np.array(intercept)
                          if intercept is not None else None)
        self.n_classes = int(n_classes)

    def predict_tensors(self, Xd: torch.Tensor):
        if self.n_classes != 2 or self.coefficients.ndim != 1:
            raise NotImplementedError(_MULTINOMIAL)
        coef = torch.as_tensor(self.coefficients, device=Xd.device)
        b = torch.as_tensor(self.intercept, dtype=coef.dtype,
                            device=Xd.device)
        return LF.predict_binary_logistic(coef, b, Xd.to(coef.dtype))

    def predict_arrays(self, X: np.ndarray, device=None):
        Xd = torch.as_tensor(X, device=resolve_device(device))
        return to_f64(self.predict_tensors(Xd))

    def get_model_state(self):
        return {"coefficients": self.coefficients, "intercept": self.intercept,
                "n_classes": self.n_classes}


@register_stage
class OpLogisticRegression(PredictorEstimator):
    """LogisticRegression estimator (binary labels)."""

    operation_name = "logreg"

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 128, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32
                    ) -> LogisticRegressionModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        if len(y) and int(y.max()) > 1:
            raise NotImplementedError(_MULTINOMIAL)
        dev = resolve_device(device)
        Xd = torch.as_tensor(X, dtype=dtype, device=dev)
        coef, b = LF.fit_binary_logistic(
            Xd, torch.as_tensor(y, dtype=dtype, device=dev),
            torch.ones((X.shape[0],), dtype=dtype, device=dev),
            [self.reg_param], [self.elastic_net_param],
            max_iter=self.max_iter)
        return LogisticRegressionModel(coef[0].cpu().numpy(),
                                       b[0].cpu().numpy(), 2)


class LogisticRegressionFamily(ModelFamily):
    """Batched LR grid (DefaultSelectorParams.scala:35-60: reg ×
    elasticNet)."""

    name = "OpLogisticRegression"
    default_grid = [
        {"regParam": r, "elasticNetParam": e}
        for r in (0.001, 0.01, 0.1, 0.2) for e in (0.1, 0.5)
    ]

    def __init__(self, grid=None, n_classes: int = 2, max_iter: int = 128):
        super().__init__(grid)
        self.n_classes = n_classes
        self.max_iter = max_iter

    def param_defaults(self):
        return {"regParam": 0.0, "elasticNetParam": 0.0}

    def _column(self, grid, key) -> List[float]:
        dflt = self.param_defaults()[key]
        return [float(g.get(key, dflt)) for g in grid]

    def fit_batch(self, X, y, w, grid=None):
        """One (coef [d], intercept) per grid point, from one batched
        fit."""
        if self.n_classes != 2:
            raise NotImplementedError(_MULTINOMIAL)
        grid = self.grid if grid is None else grid
        coef, b = LF.fit_binary_logistic(
            X, y, w, self._column(grid, "regParam"),
            self._column(grid, "elasticNetParam"), max_iter=self.max_iter)
        return [(coef[i], b[i]) for i in range(len(grid))]

    def predict_batch(self, params, X, on_train: bool = False):
        return [LF.predict_binary_logistic(c, b, X) for c, b in params]

    def realize(self, params, hparams) -> LogisticRegressionModel:
        coef, b = params
        return LogisticRegressionModel(coef.detach().cpu().numpy(),
                                       b.detach().cpu().numpy(),
                                       self.n_classes)
