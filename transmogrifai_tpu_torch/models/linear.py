"""Linear model stages: logistic regression (binomial and multinomial),
linear regression and naive Bayes — the port of
``transmogrifai_tpu/models/linear.py`` (``OpLogisticRegression.scala``,
``OpLinearRegression``, ``OpNaiveBayes``), fit by ``models/_linfit.py``.

Each family fits its whole grid as one batched run ([G, d] coefficients,
[G, K, d] for K classes). A fitted model keeps its tables in the dtype
they were fit in and predicts in that dtype on ``device``; the tables
reach the device once (``device_table``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..stages.base import register_stage
from . import _linfit as LF
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   device_table, extract_xy, resolve_device)

__all__ = ["LogisticRegressionModel", "OpLogisticRegression",
           "LogisticRegressionFamily", "LinearRegressionModel",
           "OpLinearRegression", "LinearRegressionFamily", "NaiveBayesModel",
           "OpNaiveBayes", "NaiveBayesFamily"]


def _n_classes(y: np.ndarray) -> int:
    return max(int(y.max()) + 1 if len(y) else 2, 2)


def _xyw(X: np.ndarray, y: np.ndarray, device, dtype: torch.dtype):
    dev = resolve_device(device)
    return (torch.as_tensor(X, dtype=dtype, device=dev),
            torch.as_tensor(y, dtype=dtype, device=dev),
            torch.ones((X.shape[0],), dtype=dtype, device=dev))


def _column(family: ModelFamily, grid, key: str) -> List[float]:
    dflt = family.param_defaults()[key]
    return [float(g.get(key, dflt)) for g in grid]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _TableModel(PredictorModel):
    """A predictor whose fitted state is a few arrays (``_tables``),
    uploaded once a device and predicted in their own dtype."""

    _tables: tuple = ()

    def _on(self, key: str, device: torch.device) -> torch.Tensor:
        dt = np.asarray(getattr(self, self._tables[0])).dtype
        return device_table(self, key, lambda: np.asarray(
            getattr(self, key), dtype=dt), device)

    def get_model_state(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._tables}

    def apply_model_state(self, state) -> None:
        for k, v in state.items():
            setattr(self, k, v)
        self.__dict__.pop("_device_tables", None)


# ---------------------------------------------------------------------------
# Logistic regression
# ---------------------------------------------------------------------------

@register_stage
class LogisticRegressionModel(_TableModel):
    """Logistic model: binary (``coefficients`` [d], scalar ``intercept``)
    or multinomial (``coefficients`` [K, d], ``intercept`` [K])."""

    operation_name = "logreg"
    _tables = ("coefficients", "intercept")

    def __init__(self, coefficients=None, intercept=None, n_classes: int = 2,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.coefficients = (np.array(coefficients)
                             if coefficients is not None else None)
        self.intercept = (np.array(intercept)
                          if intercept is not None else None)
        self.n_classes = int(n_classes)

    def predict_device(self, Xd: torch.Tensor):
        coef = self._on("coefficients", Xd.device)
        b = self._on("intercept", Xd.device)
        Xd = Xd.to(coef.dtype)
        if self.n_classes == 2 and coef.dim() == 1:
            return LF.predict_binary_logistic(coef, b, Xd)
        return LF.predict_multinomial_logistic(coef, b, Xd)

    def get_model_state(self):
        return {"coefficients": self.coefficients, "intercept": self.intercept,
                "n_classes": self.n_classes}

    def apply_model_state(self, state) -> None:
        super().apply_model_state(state)
        self.n_classes = int(self.n_classes)

    def summary(self):
        return {"model": "LogisticRegression", "numClasses": self.n_classes,
                "numFeatures": int(np.atleast_2d(self.coefficients).shape[-1])}


@register_stage
class OpLogisticRegression(PredictorEstimator):
    """LogisticRegression estimator: binomial for two classes (unless
    ``family="multinomial"``), multinomial by the label's arity."""

    operation_name = "logreg"

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 128, family: str = "auto",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter
        self.family = family

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32
                    ) -> LogisticRegressionModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        k = _n_classes(y)
        Xd, yd, wd = _xyw(X, y, device, dtype)
        if k == 2 and self.family != "multinomial":
            coef, b = LF.fit_binary_logistic(
                Xd, yd, wd, [self.reg_param], [self.elastic_net_param],
                max_iter=self.max_iter)
        else:
            coef, b = LF.fit_multinomial_logistic(
                Xd, yd, wd, [self.reg_param], [self.elastic_net_param],
                n_classes=k, max_iter=self.max_iter)
        return LogisticRegressionModel(_host(coef[0]), _host(b[0]), k)


class LogisticRegressionFamily(ModelFamily):
    """Batched LR grid (DefaultSelectorParams.scala:35-60: reg ×
    elasticNet); multinomial when the selector sets ``n_classes`` > 2."""

    name = "OpLogisticRegression"
    row_sharded = True
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

    def fit_batch(self, X, y, w, grid=None):
        """One (coef, intercept) per grid point, from one batched fit."""
        grid = self.grid if grid is None else grid
        reg = _column(self, grid, "regParam")
        enet = _column(self, grid, "elasticNetParam")
        if self.n_classes == 2:
            coef, b = LF.fit_binary_logistic(X, y, w, reg, enet,
                                             max_iter=self.max_iter)
        else:
            coef, b = LF.fit_multinomial_logistic(
                X, y, w, reg, enet, n_classes=self.n_classes,
                max_iter=self.max_iter)
        return [(coef[i], b[i]) for i in range(len(grid))]

    def predict_batch(self, params, X, on_train: bool = False):
        predict = (LF.predict_binary_logistic if self.n_classes == 2
                   else LF.predict_multinomial_logistic)
        return [predict(c, b, X, fixed_order=False) for c, b in params]

    def realize(self, params, hparams) -> LogisticRegressionModel:
        coef, b = params
        return LogisticRegressionModel(_host(coef), _host(b), self.n_classes)


# ---------------------------------------------------------------------------
# Linear regression
# ---------------------------------------------------------------------------

@register_stage
class LinearRegressionModel(_TableModel):
    """``coefficients`` [d] and ``intercept``; prediction X·β + b with
    empty raw and probability columns."""

    operation_name = "linreg"
    _tables = ("coefficients", "intercept")

    def __init__(self, coefficients=None, intercept=0.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.coefficients = (np.array(coefficients)
                             if coefficients is not None else None)
        self.intercept = np.array(0.0 if intercept is None else intercept)

    def predict_device(self, Xd: torch.Tensor):
        coef = self._on("coefficients", Xd.device)
        return LF.predict_linear(coef, self._on("intercept", Xd.device),
                                 Xd.to(coef.dtype))

    def get_model_state(self):
        return {"coefficients": self.coefficients,
                "intercept": float(self.intercept)}

    def summary(self):
        return {"model": "LinearRegression",
                "numFeatures": int(self.coefficients.shape[0])}


@register_stage
class OpLinearRegression(PredictorEstimator):
    operation_name = "linreg"

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 128, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32
                    ) -> LinearRegressionModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        coef, b = LF.fit_linear(*_xyw(X, y, device, dtype), self.reg_param,
                                self.elastic_net_param, self.max_iter)
        return LinearRegressionModel(_host(coef), float(b))


class LinearRegressionFamily(ModelFamily):
    """Batched linear-regression grid (reg × elasticNet)."""

    name = "OpLinearRegression"
    row_sharded = True
    default_grid = [
        {"regParam": r, "elasticNetParam": e}
        for r in (0.001, 0.01, 0.1, 0.2) for e in (0.1, 0.5)
    ]

    def __init__(self, grid=None, max_iter: int = 128):
        super().__init__(grid)
        self.max_iter = max_iter

    def param_defaults(self):
        return {"regParam": 0.0, "elasticNetParam": 0.0}

    def fit_batch(self, X, y, w, grid=None):
        grid = self.grid if grid is None else grid
        coef, b = LF.fit_linear_grid(
            X, y, w, _column(self, grid, "regParam"),
            _column(self, grid, "elasticNetParam"), max_iter=self.max_iter)
        return [(coef[i], b[i]) for i in range(len(grid))]

    def predict_batch(self, params, X, on_train: bool = False):
        return [LF.predict_linear(c, b, X, fixed_order=False)
                for c, b in params]

    def realize(self, params, hparams) -> LinearRegressionModel:
        coef, b = params
        return LinearRegressionModel(_host(coef), float(b))


# ---------------------------------------------------------------------------
# Naive Bayes
# ---------------------------------------------------------------------------

@register_stage
class NaiveBayesModel(_TableModel):
    """``log_prior`` [K] and ``log_likelihood`` [K, d]."""

    operation_name = "naiveBayes"
    _tables = ("log_prior", "log_likelihood")

    def __init__(self, log_prior=None, log_likelihood=None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.log_prior = np.array(log_prior) if log_prior is not None \
            else None
        self.log_likelihood = (np.array(log_likelihood)
                               if log_likelihood is not None else None)

    def predict_device(self, Xd: torch.Tensor):
        lp = self._on("log_prior", Xd.device)
        return LF.predict_naive_bayes(lp, self._on("log_likelihood",
                                                   Xd.device),
                                      Xd.to(lp.dtype))

    def summary(self):
        return {"model": "NaiveBayes",
                "numClasses": int(self.log_prior.shape[0])}


@register_stage
class OpNaiveBayes(PredictorEstimator):
    """Multinomial naive Bayes with Laplace smoothing (OpNaiveBayes.scala)."""

    operation_name = "naiveBayes"

    def __init__(self, smoothing: float = 1.0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.smoothing = smoothing

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32) -> NaiveBayesModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        lp, ll = LF.fit_naive_bayes(*_xyw(X, y, device, dtype),
                                    [self.smoothing], n_classes=_n_classes(y))
        return NaiveBayesModel(_host(lp[0]), _host(ll[0]))


class NaiveBayesFamily(ModelFamily):
    name = "OpNaiveBayes"
    row_sharded = True
    default_grid = [{"smoothing": s} for s in (1.0,)]

    def __init__(self, grid=None, n_classes: int = 2):
        super().__init__(grid)
        self.n_classes = n_classes

    def param_defaults(self):
        return {"smoothing": 1.0}

    def fit_batch(self, X, y, w, grid=None):
        grid = self.grid if grid is None else grid
        lp, ll = LF.fit_naive_bayes(X, y, w, _column(self, grid, "smoothing"),
                                    n_classes=self.n_classes)
        return [(lp[i], ll[i]) for i in range(len(grid))]

    def predict_batch(self, params, X, on_train: bool = False):
        return [LF.predict_naive_bayes(lp, ll, X) for lp, ll in params]

    def realize(self, params, hparams) -> NaiveBayesModel:
        lp, ll = params
        return NaiveBayesModel(_host(lp), _host(ll))
