"""Linear model fitting in plain PyTorch — the port of
``transmogrifai_tpu/models/_jaxfit.py`` (binary logistic regression and
linear regression; the linear SVC's fit is in ``models/svm.py``).

Every fit is a fixed-iteration FISTA loop (accelerated proximal
gradient), as in the JAX package: ``1/n Σ w_i ℓ_i + reg · (α ||β||₁ +
(1−α)/2 ||β||²)`` over internally standardized features with an
unpenalized intercept (Spark ``LogisticRegression`` semantics). Sample
weights double as fold masks.

The JAX package vmaps a fit over the grid points; here a grid of G points
is one batched fit: the standardization and the power iteration, which do
not depend on the regularization, run once, and the coefficients of all
points iterate together as a [G, d] matrix. The products are
``torch.matmul``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .base import score_sigmoid

__all__ = ["standardize_stats", "power_iter_sq_norm", "soft_threshold",
           "cg_solve", "fista", "fit_binary_logistic",
           "predict_binary_logistic", "fit_linear", "predict_linear"]


def standardize_stats(X: torch.Tensor, w: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-feature mean and std (std ≥ 1e-6, so a constant column
    is harmless)."""
    wsum = torch.clamp(w.sum(), min=1e-12)
    mean = (X * w[:, None]).sum(0) / wsum
    var = ((X - mean) ** 2 * w[:, None]).sum(0) / wsum
    return mean, torch.sqrt(torch.clamp(var, min=1e-12))


def power_iter_sq_norm(Xs: torch.Tensor, w: torch.Tensor,
                       iters: int = 16) -> torch.Tensor:
    """Largest eigenvalue of (1/n) Xᵀ W X by a fixed number of power
    iterations."""
    d = Xs.shape[1]
    v = torch.full((d,), 1.0, dtype=Xs.dtype, device=Xs.device) \
        / torch.sqrt(torch.tensor(float(d), dtype=Xs.dtype))
    wsum = torch.clamp(w.sum(), min=1e-12)
    for _ in range(iters):
        u = (Xs.T @ (w * (Xs @ v))) / wsum
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-12)
    return torch.clamp(v @ (Xs.T @ (w * (Xs @ v))) / wsum, min=1e-12)


def soft_threshold(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def cg_solve(matvec: Callable[[torch.Tensor], torch.Tensor],
             b: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Conjugate gradient for an SPD system, a fixed number of steps."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = r @ r
    for _ in range(n_iter):
        Ap = matvec(p)
        alpha = rs / torch.clamp(p @ Ap, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
    return x


def fista(grad_fn, prox_fn, beta0: torch.Tensor, step: torch.Tensor,
          n_iter: int) -> torch.Tensor:
    """Accelerated proximal gradient, a fixed number of steps. ``beta0``
    [G, p] and ``step`` [G, 1]: G problems at once (they share the
    momentum sequence t, which depends on no data)."""
    beta, z = beta0, beta0
    t = torch.ones((), dtype=beta0.dtype, device=beta0.device)
    for _ in range(n_iter):
        g = grad_fn(z)
        beta_next = prox_fn(z - step * g, step)
        t_next = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
        z = beta_next + ((t - 1.0) / t_next) * (beta_next - beta)
        beta, t = beta_next, t_next
    return beta


def _grid(v, X: torch.Tensor) -> torch.Tensor:
    """A grid hyperparameter as a [G, 1] column in X's dtype."""
    return torch.as_tensor(v, dtype=X.dtype, device=X.device).reshape(-1, 1)


def fit_binary_logistic(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                        reg_param, elastic_net, max_iter: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary elastic-net logistic regression at G grid points
    (``reg_param`` / ``elastic_net`` of G values) → (coef [G, d],
    intercept [G])."""
    mean, std = standardize_stats(X, w)
    Xs = (X - mean) / std
    wsum = torch.clamp(w.sum(), min=1e-12)
    reg, enet = _grid(reg_param, X), _grid(elastic_net, X)
    l1, l2 = reg * enet, reg * (1.0 - enet)
    d = X.shape[1]

    def grad(params):                       # [G, d + 1]
        beta, b = params[:, :d], params[:, d:]
        p = torch.sigmoid(beta @ Xs.T + b)  # [G, n]
        r = w * (p - y)
        return torch.cat([r @ Xs / wsum + l2 * beta,
                          r.sum(1, keepdim=True) / wsum], dim=1)

    def prox(params, step):
        return torch.cat([soft_threshold(params[:, :d], step * l1),
                          params[:, d:]], dim=1)

    lip = 0.25 * power_iter_sq_norm(Xs, w) + l2 + 0.25   # + intercept row
    params0 = torch.zeros((len(reg), d + 1), dtype=X.dtype, device=X.device)
    params = fista(grad, prox, params0, 1.0 / lip, max_iter)
    coef = params[:, :d] / std
    return coef, params[:, d] - (coef * mean).sum(1)


def predict_binary_logistic(coef: torch.Tensor, intercept, X: torch.Tensor):
    """One grid point's (coef [d], intercept) → (prediction, raw [n, 2],
    prob [n, 2])."""
    margin = X @ coef + intercept
    p1 = score_sigmoid(margin)
    prob = torch.stack([1.0 - p1, p1], dim=1)
    raw = torch.stack([-margin, margin], dim=1)
    return (p1 > 0.5).to(X.dtype), raw, prob


def fit_linear(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               reg_param: float, elastic_net: float, max_iter: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elastic-net linear regression → (coef [d], intercept): ridge/OLS by
    conjugate gradients on the normal equations, FISTA when there is an
    L1 part."""
    mean, std = standardize_stats(X, w)
    Xs = (X - mean) / std
    wsum = torch.clamp(w.sum(), min=1e-12)
    ybar = (y * w).sum() / wsum
    yc = y - ybar
    d = X.shape[1]
    l1 = float(reg_param) * float(elastic_net)
    l2 = float(reg_param) * (1.0 - float(elastic_net))
    if l1 > 0.0:
        def grad(beta):                     # [1, d]
            r = w * (beta @ Xs.T - yc)
            return r @ Xs / wsum + l2 * beta

        def prox(beta, step):
            return soft_threshold(beta, step * l1)

        lip = power_iter_sq_norm(Xs, w) + l2
        coef_s = fista(grad, prox, torch.zeros((1, d), dtype=X.dtype,
                                               device=X.device),
                       1.0 / lip, max_iter)[0]
    else:
        def matvec(v):
            return Xs.T @ (w * (Xs @ v)) / wsum + (l2 + 1e-10) * v
        coef_s = cg_solve(matvec, (Xs.T @ (w * yc)) / wsum,
                          n_iter=min(max(d, 16), 128))
    coef = coef_s / std
    return coef, ybar - (coef * mean).sum()


def predict_linear(coef: torch.Tensor, intercept, X: torch.Tensor):
    empty = torch.zeros((X.shape[0], 0), dtype=X.dtype, device=X.device)
    return X @ coef + intercept, empty, empty
