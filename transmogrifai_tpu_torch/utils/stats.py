"""Statistics utilities — the OpStatistics analog; the port of
``transmogrifai_tpu/utils/stats.py`` (``OpStatistics.scala:71-346``).

``moments`` and ``contingency`` run in torch on their inputs' device (the
JAX package jits them for XLA; a plain matmul is the right tool for the
gram). The contingency-table post-processing is host numpy: the tables
are [n_classes, n_categories].
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["moments", "contingency", "cramers_v_stats", "pmi_mutual_info",
           "average_ranks", "spearman_with_label"]


def moments(X: torch.Tensor, y: torch.Tensor, label_corr_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """One pass over [n, d] features + [n] label: means, variances, label
    correlation per column, the full correlation matrix (unless
    ``label_corr_only``) and column min/max (SanityChecker.scala:575)."""
    n = X.shape[0]
    Z = torch.cat([X, y[:, None].to(X.dtype)], dim=1)
    mean = Z.mean(dim=0)
    Zc = Z - mean
    cov = Zc.t() @ Zc / max(n - 1, 1)
    var = torch.diagonal(cov)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    denom = torch.clamp(torch.outer(std, std), min=1e-30)
    if label_corr_only:
        corr_label, corr = cov[:-1, -1] / denom[:-1, -1], None
    else:
        corr = cov / denom
        corr_label = corr[:-1, -1]
    return mean, var, corr_label, corr, Z.min(dim=0).values, \
        Z.max(dim=0).values


def contingency(Y_onehot: torch.Tensor, Xg: torch.Tensor) -> torch.Tensor:
    """Contingency counts [n_classes, n_categories] as one matmul."""
    return Y_onehot.t() @ Xg


def cramers_v_stats(cont: np.ndarray
                    ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Cramér's V (bias-uncorrected, MLlib chi2 semantics) + per-category
    support and max association-rule confidence."""
    total = cont.sum()
    if total <= 0:
        return 0.0, np.zeros(cont.shape[1]), np.zeros(cont.shape[1])
    row = cont.sum(axis=1, keepdims=True)
    col = cont.sum(axis=0, keepdims=True)
    expected = row @ col / total
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.where(expected > 0,
                        (cont - expected) ** 2 / expected, 0.0).sum()
    r, c = cont.shape
    dof_dim = min(r - 1, c - 1)
    v = float(np.sqrt(chi2 / (total * dof_dim))) if dof_dim > 0 else 0.0
    support = (col / total).ravel()
    with np.errstate(divide="ignore", invalid="ignore"):
        confidence = np.where(col > 0,
                              cont.max(axis=0) / col.ravel(), 0.0).ravel()
    return v, support, confidence


def pmi_mutual_info(cont: np.ndarray) -> Tuple[np.ndarray, float]:
    """Pointwise mutual information per (class, category) cell and total
    mutual information, log base 2."""
    total = cont.sum()
    if total <= 0:
        return np.zeros_like(cont), 0.0
    p = cont / total
    pr = p.sum(axis=1, keepdims=True)
    pc = p.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.where(p > 0, np.log2(p / np.maximum(pr @ pc, 1e-300)), 0.0)
    return pmi, float((p * pmi).sum())


def average_ranks(v: np.ndarray) -> np.ndarray:
    """Average 1-based ranks with ties (scipy ``rankdata`` 'average')."""
    _uniq, inv, counts = np.unique(v, return_inverse=True,
                                   return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (starts + (counts - 1) / 2.0 + 1.0)[inv]


def spearman_with_label(X: np.ndarray, y: np.ndarray,
                        label_corr_only: bool = True,
                        device="cpu", dtype: torch.dtype = torch.float64
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Spearman correlation of each column with the label: average ranks
    per column on the host, their Pearson moments on ``device``."""
    Xr = np.empty(X.shape, dtype=np.float64)
    for j in range(X.shape[1]):
        Xr[:, j] = average_ranks(X[:, j])
    yr = average_ranks(np.asarray(y))
    _m, _v, corr_label, corr, _lo, _hi = moments(
        torch.as_tensor(Xr, dtype=dtype, device=device),
        torch.as_tensor(yr, dtype=dtype, device=device),
        label_corr_only=label_corr_only)
    return corr_label, corr
