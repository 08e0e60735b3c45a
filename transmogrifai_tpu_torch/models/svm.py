"""Linear SVC and multilayer perceptron stages — the port of
``transmogrifai_tpu/models/svm.py`` (``OpLinearSVC.scala``,
``OpMultilayerPerceptronClassifier.scala``).

The squared hinge (smooth; Spark's OWLQN hinge differs only in the loss
corner) with L2 regularization, solved by accelerated gradient descent on
standardized features (``models/_linfit.py``). Like Spark's LinearSVC the
model has no probability column; ``prob`` is a monotone sigmoid of the
margin, so threshold metrics (AuROC, AuPR) are defined. A grid of G
points is one batched fit.

The MLP trains full-batch Adam on weighted cross-entropy: tanh hidden
layers and a softmax head over a list of (W, b), the gradient by
``torch.autograd``, the Adam step written out as the JAX package's loop
writes it. The initial weights are ``jax.random.normal`` draws, bit for
bit (``random.normal``), so the card, the CPU and the JAX package start
from the same point. Hidden ``layers`` are structural: a family batches
the grid points of one layer spec, which share the seed and so the
initial weights; the G points' weights iterate together as [G, ...]
tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as R
from ..stages.base import register_stage
from ._linfit import fista, power_iter_sq_norm, standardize_stats
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   device_table, extract_xy, resolve_device, score_sigmoid)

__all__ = ["fit_linear_svc", "predict_linear_svc", "LinearSVCModel",
           "OpLinearSVC", "LinearSVCFamily", "mlp_init", "fit_mlp",
           "predict_mlp", "MLPModel", "OpMultilayerPerceptronClassifier",
           "MLPFamily"]


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


# ---------------------------------------------------------------------------
# Multilayer perceptron
# ---------------------------------------------------------------------------

def mlp_init(seed: int, sizes: Sequence[int], dtype: torch.dtype
             ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The JAX package's ``_mlp_init``: per layer a split of the key and
    He-scaled ``jax.random.normal`` weights, zero biases (host arrays)."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    key = R.PRNGKey(seed)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        key, k = R.split(key)
        scale = np.sqrt(np.float64(2.0 / fan_in)).astype(npdt)
        params.append((R.normal(k, (fan_in, fan_out), npdt) * scale,
                       np.zeros((fan_out,), npdt)))
    return params


def _mlp_logits(params, X: torch.Tensor) -> torch.Tensor:
    """Logits of [G, ...] stacked weights → [G, n, K] (or [n, K] for one
    point's unstacked weights)."""
    h = X
    for i, (W, b) in enumerate(params):
        h = h @ W + b.unsqueeze(-2)
        if i < len(params) - 1:
            h = torch.tanh(h)
    return h


def fit_mlp(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
            sizes: Sequence[int], step_sizes, max_iter: int, seed: int = 3
            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Full-batch Adam on weighted cross-entropy at G step sizes from the
    same initial weights → per layer (W [G, fan_in, fan_out], b [G,
    fan_out])."""
    dev, dt = X.device, X.dtype
    step = torch.as_tensor(step_sizes, dtype=dt, device=dev)
    G = step.shape[0]
    params = [(torch.as_tensor(W, device=dev).expand(G, *W.shape).clone(),
               torch.as_tensor(b, device=dev).expand(G, *b.shape).clone())
              for W, b in mlp_init(seed, sizes, dt)]
    flat = [t for wb in params for t in wb]
    onehot = torch.nn.functional.one_hot(
        y.to(torch.int64), sizes[-1]).to(dt)
    wsum = torch.clamp(w.sum(), min=1e-12)

    def grads(ps):
        ps = [p.detach().requires_grad_(True) for p in ps]
        logp = torch.log_softmax(
            _mlp_logits(list(zip(ps[0::2], ps[1::2])), X), dim=-1)
        loss = -((w * (onehot * logp).sum(-1)).sum(-1) / wsum).sum()
        return torch.autograd.grad(loss, ps)

    b1, b2, eps = 0.9, 0.999, 1e-8
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    for i in range(max_iter):
        g = grads(flat)
        m = [b1 * a + (1 - b1) * gg for a, gg in zip(m, g)]
        v = [b2 * a + (1 - b2) * gg ** 2 for a, gg in zip(v, g)]
        t = float(i + 1)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        out = []
        for p, mm, vv in zip(flat, m, v):
            s = step.reshape((G,) + (1,) * (p.dim() - 1))
            out.append(p - s * (mm / c1) / (torch.sqrt(vv / c2) + eps))
        flat = out
    return list(zip(flat[0::2], flat[1::2]))


def predict_mlp(params, X: torch.Tensor):
    """One grid point's [(W, b)] → (prediction, logits, prob)."""
    logits = _mlp_logits(params, X)
    return (torch.argmax(logits, dim=-1).to(X.dtype), logits,
            torch.softmax(logits, dim=-1))


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


@register_stage
class MLPModel(PredictorModel):
    operation_name = "mlp"

    def __init__(self, layers: Optional[List[int]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.layers = list(layers or [])
        self.weights: List[Tuple[np.ndarray, np.ndarray]] = []

    def predict_device(self, Xd: torch.Tensor):
        params = [(device_table(self, f"W_{i}", lambda W=W: W, Xd.device),
                   device_table(self, f"b_{i}", lambda b=b: b, Xd.device))
                  for i, (W, b) in enumerate(self.weights)]
        return predict_mlp(params, Xd.to(params[0][0].dtype))

    def get_model_state(self):
        state: Dict[str, Any] = {"layers": np.asarray(self.layers)}
        for i, (W, b) in enumerate(self.weights):
            state[f"W_{i}"] = _f(W)
            state[f"b_{i}"] = _f(b)
        return state

    def apply_model_state(self, state) -> None:
        self.layers = [int(v) for v in np.asarray(state["layers"])]
        self.weights = []
        i = 0
        while f"W_{i}" in state:
            self.weights.append((np.asarray(state[f"W_{i}"]),
                                 np.asarray(state[f"b_{i}"])))
            i += 1
        self.__dict__.pop("_device_tables", None)

    def summary(self):
        return {"model": "MultilayerPerceptron", "layers": self.layers}


@register_stage
class OpMultilayerPerceptronClassifier(PredictorEstimator):
    operation_name = "mlp"

    def __init__(self, hidden_layers: Optional[List[int]] = None,
                 step_size: float = 0.03, max_iter: int = 100,
                 seed: int = 3, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.hidden_layers = list(hidden_layers or [10])
        self.step_size = step_size
        self.max_iter = max_iter
        self.seed = seed

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32) -> MLPModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        dev = resolve_device(device)
        n_classes = max(int(y.max()) + 1 if len(y) else 2, 2)
        sizes = (X.shape[1], *self.hidden_layers, n_classes)
        params = fit_mlp(torch.as_tensor(X, dtype=dtype, device=dev),
                         torch.as_tensor(y, dtype=dtype, device=dev),
                         torch.ones((X.shape[0],), dtype=dtype, device=dev),
                         sizes, [self.step_size], self.max_iter, self.seed)
        model = MLPModel(layers=list(sizes))
        model.weights = [(_f(W[0]), _f(b[0])) for W, b in params]
        return model


class MLPFamily(ModelFamily):
    """Grid over stepSize; hidden ``layers`` structural — one layer spec
    per family, its points fit as one batch."""

    name = "OpMultilayerPerceptronClassifier"
    default_grid = [{"stepSize": s, "layers": (10,)} for s in (0.01, 0.03)]

    def __init__(self, grid=None, n_classes: int = 2, max_iter: int = 100,
                 seed: int = 3):
        super().__init__(grid)
        self.n_classes = n_classes
        self.max_iter = max_iter
        self.seed = seed

    def param_defaults(self):
        return {"stepSize": 0.03, "layers": (10,)}

    def fit_batch(self, X, y, w, grid=None) -> List:
        grid = self.grid if grid is None else grid
        specs = {tuple(g.get("layers", (10,))) for g in grid}
        if len(specs) != 1:
            raise ValueError(
                "MLPFamily grid must use a single hidden-layer spec per "
                "family; split specs into separate families")
        sizes = (X.shape[1], *specs.pop(), self.n_classes)
        params = fit_mlp(X, y, w, sizes,
                         [float(g.get("stepSize", 0.03)) for g in grid],
                         self.max_iter, self.seed)
        return [[(W[i], b[i]) for W, b in params] for i in range(len(grid))]

    def predict_batch(self, params, X, on_train: bool = False) -> List:
        return [predict_mlp(p, X) for p in params]

    def realize(self, params, hparams) -> MLPModel:
        spec = tuple(hparams.get("layers", (10,)))
        weights = [(_f(W), _f(b)) for W, b in params]
        model = MLPModel(layers=[weights[0][0].shape[0], *spec,
                                 self.n_classes])
        model.weights = weights
        return model
