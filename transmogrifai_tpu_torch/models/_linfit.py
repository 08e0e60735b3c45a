"""Linear model fitting in plain PyTorch — the port of
``transmogrifai_tpu/models/_jaxfit.py``: binary and multinomial logistic
regression, linear regression and multinomial naive Bayes (the linear
SVC's fit is in ``models/svm.py``).

Every fit is a fixed-iteration FISTA loop (accelerated proximal
gradient), as in the JAX package: ``1/n Σ w_i ℓ_i + reg · (α ||β||₁ +
(1−α)/2 ||β||²)`` over internally standardized features with an
unpenalized intercept (Spark ``LogisticRegression`` semantics). Sample
weights double as fold masks.

The JAX package vmaps a fit over the grid points; here a grid of G points
is one batched fit: the standardization and the power iteration, which do
not depend on the regularization, run once, and the coefficients of all
points iterate together as a [G, d] matrix ([G, K, d] for K classes).
Naive Bayes' class sums do not depend on the smoothing either: they are
taken once for the grid. The fits' products, and the margins of their
cross-validation folds, are ``torch.matmul``; a fitted model's margins
are :func:`row_dot`, whose per-row sums do not depend on how many rows a
call takes (the scoring engine scores in buckets, the layer path all
rows at once, and the two agree bitwise).

Over a mesh (``parallel.mesh.sharded_scope``) a fit takes the whole input
on every rank and works on its own rows (:func:`shard_rows`): every sum
over rows — the standardization's moments, the power iteration's and the
gradients' products, the conjugate-gradient matvec, naive Bayes' class
sums — is summed over the ``data`` group (:func:`psum`), so every rank
iterates the same coefficients.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..parallel import mesh as _mesh
from .base import score_sigmoid

__all__ = ["psum", "psum_pair", "shard_rows", "standardize_stats",
           "power_iter_sq_norm", "soft_threshold",
           "cg_solve", "fista", "fit_binary_logistic",
           "predict_binary_logistic", "fit_multinomial_logistic",
           "predict_multinomial_logistic", "fit_linear", "fit_linear_grid",
           "predict_linear", "fit_naive_bayes", "predict_naive_bayes",
           "row_dot", "margins"]


def row_dot(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Each row's dot product with ``W`` ([d] → [n]; [K, d] → [n, K]),
    summed in one fixed order for every row count: the products, zero-
    padded to a power of two, then halves added elementwise until one
    column is left. A matrix product picks its kernel, and so its
    summation order, by the row count, on the card and on the CPU alike:
    a row scored in a bucket of 8,192 and among 10,000 rows could differ
    in its last bits. It costs a [n, (K,) 2^ceil(log2 d)] buffer and
    log2(d) passes over it, several times a matrix product's time, so
    only a fitted model's predictions (``margins(..., fixed_order=True)``)
    take it."""
    d = X.shape[-1]
    w = 1 << max(d - 1, 0).bit_length()
    lead = tuple(W.shape[:-1])
    p = torch.zeros((X.shape[0],) + lead + (w,),
                    dtype=torch.result_type(X, W), device=X.device)
    torch.mul(X[:, None, :] if lead else X, W, out=p[..., :d])
    while w > 1:
        w //= 2
        p[..., :w] += p[..., w:2 * w]
    return p[..., 0]


def margins(X: torch.Tensor, W: torch.Tensor,
            fixed_order: bool = True) -> torch.Tensor:
    """``X @ W`` ([d] → [n]; [K, d] → [n, K]): by :func:`row_dot` when
    ``fixed_order`` (a fitted model's predictions, which the scoring
    engine's buckets and the layer path must give bitwise alike), else
    by a matrix product (a family's cross-validation folds)."""
    if fixed_order:
        return row_dot(X, W)
    return X @ (W.T if W.dim() == 2 else W)


def psum(t: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's rows summed over the active mesh's ``data``
    group (``t`` itself in one process)."""
    return _mesh.all_reduce(t, _mesh.active_sharded_mesh(), "data")


def psum_pair(a: torch.Tensor, b: torch.Tensor):
    """(psum(a), psum(b)) of a [G, p] and b [G, q] in one all-reduce over
    the active mesh; ``a`` and ``b`` themselves in one process."""
    mesh = _mesh.active_sharded_mesh()
    if mesh is None or mesh.group("data") is None:
        return a, b
    sums = psum(torch.cat([a, b], dim=1))
    return sums[:, :a.shape[1]], sums[:, a.shape[1]:]


def shard_rows(*ts: torch.Tensor):
    """This rank's rows of whole-input tensors under the active mesh
    (zero-weight padding past the end), else the tensors themselves."""
    mesh = _mesh.active_sharded_mesh()
    if mesh is None or mesh.shape["data"] <= 1:
        return ts
    return tuple(_mesh.local_rows(mesh, t) for t in ts)


def _wsum(w: torch.Tensor) -> torch.Tensor:
    return torch.clamp(psum(w.sum()), min=1e-12)


def standardize_stats(X: torch.Tensor, w: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-feature mean and std (std ≥ 1e-6, so a constant column
    is harmless)."""
    wsum = _wsum(w)
    mean = psum((X * w[:, None]).sum(0)) / wsum
    var = psum(((X - mean) ** 2 * w[:, None]).sum(0)) / wsum
    return mean, torch.sqrt(torch.clamp(var, min=1e-12))


def power_iter_sq_norm(Xs: torch.Tensor, w: torch.Tensor,
                       iters: int = 16) -> torch.Tensor:
    """Largest eigenvalue of (1/n) Xᵀ W X by a fixed number of power
    iterations."""
    d = Xs.shape[1]
    v = torch.full((d,), 1.0, dtype=Xs.dtype, device=Xs.device) \
        / torch.sqrt(torch.tensor(float(d), dtype=Xs.dtype))
    wsum = _wsum(w)
    for _ in range(iters):
        u = psum(Xs.T @ (w * (Xs @ v))) / wsum
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-12)
    return torch.clamp(v @ psum(Xs.T @ (w * (Xs @ v))) / wsum, min=1e-12)


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
    X, y, w = shard_rows(X, y, w)
    mean, std = standardize_stats(X, w)
    Xs = (X - mean) / std
    wsum = _wsum(w)
    reg, enet = _grid(reg_param, X), _grid(elastic_net, X)
    l1, l2 = reg * enet, reg * (1.0 - enet)
    d = X.shape[1]

    def grad(params):                       # [G, d + 1]
        beta, b = params[:, :d], params[:, d:]
        p = torch.sigmoid(beta @ Xs.T + b)  # [G, n]
        r = w * (p - y)
        g_x, g_b = psum_pair(r @ Xs, r.sum(1, keepdim=True))
        return torch.cat([g_x / wsum + l2 * beta, g_b / wsum], dim=1)

    def prox(params, step):
        return torch.cat([soft_threshold(params[:, :d], step * l1),
                          params[:, d:]], dim=1)

    lip = 0.25 * power_iter_sq_norm(Xs, w) + l2 + 0.25   # + intercept row
    params0 = torch.zeros((len(reg), d + 1), dtype=X.dtype, device=X.device)
    params = fista(grad, prox, params0, 1.0 / lip, max_iter)
    coef = params[:, :d] / std
    return coef, params[:, d] - (coef * mean).sum(1)


def predict_binary_logistic(coef: torch.Tensor, intercept, X: torch.Tensor,
                            fixed_order: bool = True):
    """One grid point's (coef [d], intercept) → (prediction, raw [n, 2],
    prob [n, 2]); ``fixed_order`` as in :func:`margins`."""
    margin = margins(X, coef, fixed_order) + intercept
    p1 = score_sigmoid(margin)
    prob = torch.stack([1.0 - p1, p1], dim=1)
    raw = torch.stack([-margin, margin], dim=1)
    return (p1 > 0.5).to(X.dtype), raw, prob


def fit_multinomial_logistic(X: torch.Tensor, y: torch.Tensor,
                             w: torch.Tensor, reg_param, elastic_net,
                             n_classes: int, max_iter: int = 128
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax elastic-net logistic regression over ``n_classes`` classes
    at G grid points → (coef [G, K, d], intercept [G, K])."""
    X, y, w = shard_rows(X, y, w)
    mean, std = standardize_stats(X, w)
    Xs = (X - mean) / std
    wsum = _wsum(w)
    reg, enet = _grid(reg_param, X), _grid(elastic_net, X)
    l1, l2 = (reg * enet)[:, :, None], (reg * (1.0 - enet))[:, :, None]
    n, d, K = X.shape[0], X.shape[1], int(n_classes)
    G = len(reg)
    onehot = torch.nn.functional.one_hot(y.long(), K).to(X.dtype)   # [n, K]

    def grad(params):                       # [G, K, d + 1]
        # the grid's G·K coefficient rows in one [n, d] × [d, G·K] product
        # each way (a product batched over G reads X G times, with an
        # inner dimension of d)
        W, b = params[:, :, :d], params[:, :, d]
        logits = (Xs @ W.reshape(G * K, d).T).reshape(n, G, K) + b
        r = (torch.softmax(logits, dim=2) - onehot[:, None, :]) \
            * w[:, None, None]                                # [n, G, K]
        gW = psum(r.reshape(n, G * K).T @ Xs).reshape(G, K, d) / wsum \
            + l2 * W
        return torch.cat([gW, (psum(r.sum(0)) / wsum)[:, :, None]], dim=2)

    def prox(params, step):
        return torch.cat([soft_threshold(params[:, :, :d], step * l1),
                          params[:, :, d:]], dim=2)

    lip = (0.5 * power_iter_sq_norm(Xs, w) + l2 + 0.5)       # [G, 1, 1]
    params0 = torch.zeros((G, K, d + 1), dtype=X.dtype, device=X.device)
    params = fista(grad, prox, params0, 1.0 / lip, max_iter)
    W = params[:, :, :d] / std
    return W, params[:, :, d] - torch.matmul(W, mean)


def predict_multinomial_logistic(coef: torch.Tensor, intercept,
                                 X: torch.Tensor, fixed_order: bool = True):
    """One grid point's (coef [K, d], intercept [K]) → (prediction,
    logits [n, K], prob [n, K]); ``fixed_order`` as in :func:`margins`."""
    logits = margins(X, coef, fixed_order) + intercept
    prob = torch.softmax(logits, dim=-1)
    return torch.argmax(prob, dim=-1).to(X.dtype), logits, prob


def fit_linear(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               reg_param: float, elastic_net: float, max_iter: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elastic-net linear regression at one point → (coef [d], intercept):
    :func:`fit_linear_grid` on a grid of one."""
    coef, icpt = fit_linear_grid(X, y, w, [reg_param], [elastic_net],
                                 max_iter)
    return coef[0], icpt[0]


def fit_linear_grid(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    reg_param, elastic_net, max_iter: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elastic-net linear regression at G grid points → (coef [G, d],
    intercept [G]): the points with an L1 part take one batched FISTA
    run, each of the others ridge/OLS by conjugate gradients on the
    normal equations."""
    regs, enets = list(map(float, reg_param)), list(map(float, elastic_net))
    X, y, w = shard_rows(X, y, w)
    d = X.shape[1]
    coef = torch.empty((len(regs), d), dtype=X.dtype, device=X.device)
    mean, std = standardize_stats(X, w)
    Xs = (X - mean) / std
    wsum = _wsum(w)
    ybar = psum((y * w).sum()) / wsum
    yc = y - ybar
    l1_pts = [i for i, (r, e) in enumerate(zip(regs, enets)) if r * e > 0.0]
    if l1_pts:
        reg = _grid([regs[i] for i in l1_pts], X)
        enet = _grid([enets[i] for i in l1_pts], X)
        l1, l2 = reg * enet, reg * (1.0 - enet)

        def grad(beta):                     # [G', d]
            r = w * (beta @ Xs.T - yc)
            return psum(r @ Xs) / wsum + l2 * beta

        def prox(beta, step):
            return soft_threshold(beta, step * l1)

        lip = power_iter_sq_norm(Xs, w) + l2
        coef[l1_pts] = fista(grad, prox, torch.zeros(
            (len(l1_pts), d), dtype=X.dtype, device=X.device),
            1.0 / lip, max_iter)
    for i, (r, e) in enumerate(zip(regs, enets)):
        if i in l1_pts:
            continue
        l2 = r * (1.0 - e)

        def matvec(v):
            return psum(Xs.T @ (w * (Xs @ v))) / wsum + (l2 + 1e-10) * v
        coef[i] = cg_solve(matvec, psum(Xs.T @ (w * yc)) / wsum,
                           n_iter=min(max(d, 16), 128))
    coef = coef / std
    return coef, ybar - (coef * mean).sum(1)


def predict_linear(coef: torch.Tensor, intercept, X: torch.Tensor,
                   fixed_order: bool = True):
    empty = torch.zeros((X.shape[0], 0), dtype=X.dtype, device=X.device)
    return margins(X, coef, fixed_order) + intercept, empty, empty


def fit_naive_bayes(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    smoothing, n_classes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multinomial naive Bayes with Laplace smoothing (Spark NaiveBayes) at
    G grid points (``smoothing`` of G values) → (log prior [G, K], log
    likelihood [G, K, d]). Features are clipped at 0."""
    K = int(n_classes)
    X, y, w = shard_rows(X, y, w)
    yw = torch.nn.functional.one_hot(y.long(), K).to(X.dtype) * w[:, None]
    class_count = psum(yw.sum(0))                            # [K]
    feat_sum = psum(yw.T @ torch.clamp(X, min=0.0))          # [K, d]
    sm = torch.as_tensor(smoothing, dtype=X.dtype, device=X.device)
    sm = sm.reshape(-1, 1)                                   # [G, 1]
    log_prior = torch.log(class_count + sm) - torch.log(
        class_count.sum() + sm * K)
    log_like = torch.log(feat_sum + sm[:, :, None]) - torch.log(
        feat_sum.sum(1, keepdim=True) + sm[:, :, None] * X.shape[1])
    return log_prior, log_like


def predict_naive_bayes(log_prior: torch.Tensor, log_like: torch.Tensor,
                        X: torch.Tensor):
    """One grid point's (log prior [K], log likelihood [K, d]) →
    (prediction, logits [n, K], prob [n, K])."""
    logits = torch.clamp(X, min=0.0) @ log_like.T + log_prior
    prob = torch.softmax(logits, dim=-1)
    return torch.argmax(logits, dim=-1).to(X.dtype), logits, prob
