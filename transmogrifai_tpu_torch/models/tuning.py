"""Tuning: splitters, balancing, and the cross-validation engine — the
port of ``transmogrifai_tpu/models/tuning.py``.

Parity: ``core/.../impl/tuning/*`` — ``Splitter`` / ``DataSplitter`` /
``DataBalancer`` / ``DataCutter`` and ``OpCrossValidation`` /
``OpTrainValidationSplit``. Folds are 0/1 weight vectors
over one device-resident (X, y); all randomness is numpy's
``default_rng``, seeded as in the JAX package, so the holdout, the
balancer's sample and the folds are the same rows.

The engine bins the data once per family, then for every fold fits each
grid point, predicts the training matrix from the fit-time margin cache,
and takes the selection metric on the device; only the [grid, folds]
metric matrix comes back to the host. Under workflow-level CV
(``validate_per_fold``) every fold brings its own matrix, binned once per
family and fold. From ``UNROLL_MIN_ROWS`` rows the
grid is grouped by ``maxDepth`` and each group grows unrolled trees at its
own depth.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columns import ColumnStore
from ..evaluators import metrics as M
from .base import ModelFamily, resolve_device, to_f64

__all__ = ["Splitter", "DataSplitter", "DataBalancer", "DataCutter",
           "CrossValidation", "TrainValidationSplit", "ValidationResult",
           "ValidatorSummary"]


# ---------------------------------------------------------------------------
# Splitters (impl/tuning/Splitter.scala, DataBalancer.scala)
# ---------------------------------------------------------------------------

class Splitter:
    """Base: holdout reservation + per-task train preparation."""

    def __init__(self, seed: int = 42, reserve_test_fraction: float = 0.0):
        self.seed = seed
        self.reserve_test_fraction = reserve_test_fraction
        self.summary: Dict[str, Any] = {}

    def reserve_split(self, store: ColumnStore
                      ) -> Tuple[ColumnStore, Optional[ColumnStore]]:
        if self.reserve_test_fraction <= 0.0:
            return store, None
        rng = np.random.default_rng(self.seed)
        n = store.n_rows
        perm = rng.permutation(n)
        n_test = int(round(n * self.reserve_test_fraction))
        test_idx, train_idx = perm[:n_test], perm[n_test:]
        return store.take(np.sort(train_idx)), store.take(np.sort(test_idx))

    def pre_validation_prepare(self, y: np.ndarray) -> None:
        """Estimate preparation parameters (DataBalancer.estimate)."""

    def sample_weights(self, y: np.ndarray) -> np.ndarray:
        """Per-row training weights implementing the preparation."""
        return np.ones_like(y, dtype=np.float64)

    def keep_mask(self, y: np.ndarray) -> np.ndarray:
        """Rows admitted to training at all."""
        return np.ones_like(y, dtype=bool)

    def physical_sample(self, y: np.ndarray, w: np.ndarray
                        ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """(keep mask | None, kept weights); default: no sampling."""
        return None, w

    def relabel(self, y: np.ndarray) -> np.ndarray:
        """Kept labels → contiguous model classes (DataCutter only)."""
        return y

    def original_labels(self) -> Optional[List[float]]:
        """Model class → original label value, or None (identity)."""
        return None


class DataSplitter(Splitter):
    """Plain splitter — regression (DataSplitter.scala:30-100)."""


class DataBalancer(Splitter):
    """Binary-label balancer with the reference's sampling fractions
    (``DataBalancer.scala:84-131`` getProportions, ``:208-253``
    estimate): majority-class fractions below 1 are sampled physically
    (exact per-class counts, :meth:`physical_sample`); minority
    up-sampling stays a per-row weight."""

    def __init__(self, sample_fraction: float = 0.1, seed: int = 42,
                 reserve_test_fraction: float = 0.0,
                 max_training_sample: int = 1_000_000):
        super().__init__(seed=seed,
                         reserve_test_fraction=reserve_test_fraction)
        self.sample_fraction = sample_fraction
        self.max_training_sample = max_training_sample
        self._pos_weight = 1.0
        self._neg_weight = 1.0

    @staticmethod
    def get_proportions(small: float, big: float, sample_f: float,
                        max_training_sample: int) -> Tuple[float, float]:
        """(downSample for majority, upSample for minority) —
        ``DataBalancer.getProportions`` (:84-115)."""
        def check_up(mult: float) -> bool:
            return (mult * small * (1 - sample_f) < sample_f * big
                    and max_training_sample * sample_f > small * mult)

        if small < max_training_sample * sample_f:
            up = next((float(m) for m in (100, 50, 10, 5, 4, 3, 2)
                       if check_up(m)), 1.0)
            down = (small * up / sample_f - small * up) / big
            return down, up
        up = (max_training_sample * sample_f) / small
        return (1 - sample_f) * max_training_sample / big, up

    def pre_validation_prepare(self, y: np.ndarray) -> None:
        n = len(y)
        n_pos = float((y == 1).sum())
        n_neg = float(n - n_pos)
        f = self.sample_fraction
        mts = self.max_training_sample
        is_pos_small = n_pos < n_neg
        small, big = (n_pos, n_neg) if is_pos_small else (n_neg, n_pos)
        if small == 0 or small / max(n, 1) >= f:
            # already balanced; uniformly downsample only when too big
            frac = mts / n if mts < n else 1.0
            self._pos_weight = self._neg_weight = frac
            self.summary = {
                "positiveLabels": n_pos, "negativeLabels": n_neg,
                "desiredFraction": f, "upSamplingFraction": 0.0,
                "downSamplingFraction": frac}
            return
        down, up = self.get_proportions(small, big, f, mts)
        if is_pos_small:
            self._pos_weight, self._neg_weight = up, down
        else:
            self._pos_weight, self._neg_weight = down, up
        self.summary = {
            "positiveLabels": n_pos, "negativeLabels": n_neg,
            "desiredFraction": f, "upSamplingFraction": up,
            "downSamplingFraction": down}

    def sample_weights(self, y: np.ndarray) -> np.ndarray:
        return np.where(y == 1, self._pos_weight,
                        self._neg_weight).astype(np.float64)

    def physical_sample(self, y: np.ndarray, w: np.ndarray
                        ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """Exact-count per-class row sampling for fractions < 1;
        up-weights (> 1) stay as weights."""
        frac = np.minimum(w, 1.0)
        if bool((frac >= 1.0 - 1e-12).all()):
            return None, w
        rng = np.random.default_rng(self.seed + 0x5EED)
        keep = np.zeros(len(w), dtype=bool)
        target = int(round(float(frac.sum())))
        classes = [c for c in (0.0, 1.0) if (y == c).any()] or [None]
        remaining = target
        for ci, cls in enumerate(classes):
            idx = (np.nonzero(y == cls)[0] if cls is not None
                   else np.arange(len(y)))
            f = float(frac[idx[0]])
            if f >= 1.0 - 1e-12:
                keep[idx] = True
                remaining -= len(idx)
                continue
            k = (int(round(f * len(idx))) if ci < len(classes) - 1
                 else remaining)            # last class absorbs rounding
            k = int(np.clip(k, 0, len(idx)))
            sel = rng.choice(len(idx), size=k, replace=False)
            keep[idx[sel]] = True
            remaining -= k
        return keep, np.maximum(w, 1.0)[keep]


class DataCutter(Splitter):
    """Multiclass label cutter (DataCutter.scala:30-120): keeps the
    ``max_label_categories`` most frequent labels whose share of the rows
    is at least ``min_label_fraction``, drops the rows of the others, and
    re-indexes the kept labels to contiguous classes 0..k−1; the selected
    model carries the inverse mapping (:meth:`original_labels`)."""

    def __init__(self, max_label_categories: int = 100,
                 min_label_fraction: float = 0.0, seed: int = 42,
                 reserve_test_fraction: float = 0.0):
        super().__init__(seed=seed,
                         reserve_test_fraction=reserve_test_fraction)
        self.max_label_categories = max_label_categories
        self.min_label_fraction = min_label_fraction
        self._kept_labels: Optional[np.ndarray] = None

    def pre_validation_prepare(self, y: np.ndarray) -> None:
        labels, counts = np.unique(y, return_counts=True)
        frac = counts / max(len(y), 1)
        order = np.argsort(-counts, kind="stable")
        kept = [labels[i] for i in order[:self.max_label_categories]
                if frac[i] >= self.min_label_fraction]
        self._kept_labels = np.asarray(sorted(kept))
        self.summary = {"labelsKept": self._kept_labels.tolist(),
                        "labelsDropped": sorted(
                            set(labels.tolist()) - set(kept))}

    def keep_mask(self, y: np.ndarray) -> np.ndarray:
        if self._kept_labels is None:
            return np.ones_like(y, dtype=bool)
        return np.isin(y, self._kept_labels)

    def relabel(self, y: np.ndarray) -> np.ndarray:
        if self._kept_labels is None:
            return y
        return np.searchsorted(self._kept_labels, y,
                               side="left").astype(np.float64)

    def original_labels(self) -> Optional[List[float]]:
        if self._kept_labels is None or np.array_equal(
                self._kept_labels, np.arange(len(self._kept_labels))):
            return None                   # the identity needs no mapping
        return [float(v) for v in self._kept_labels]


# ---------------------------------------------------------------------------
# Validators (OpCrossValidation, OpTrainValidationSplit)
# ---------------------------------------------------------------------------

@dataclass
class ValidationResult:
    family_name: str
    hparams: Dict[str, Any]
    grid_index: int
    metric_values: List[float]          # per fold
    mean_metric: float


@dataclass
class ValidatorSummary:
    validation_type: str
    evaluation_metric: str
    results: List[ValidationResult] = field(default_factory=list)
    best: Optional[ValidationResult] = None
    #: family name → wall-clock seconds of its sweep (every fold and grid
    #: point, the metrics read back)
    family_seconds: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "validationType": self.validation_type,
            "evaluationMetric": self.evaluation_metric,
            "bestModelName": self.best.family_name if self.best else None,
            "bestModelParams": self.best.hparams if self.best else None,
            "results": [
                {"model": r.family_name, "params": r.hparams,
                 "metricPerFold": r.metric_values, "mean": r.mean_metric}
                for r in self.results],
        }


def _metric_value(metric_name: str, task: str, y: np.ndarray,
                  pred: np.ndarray, prob: np.ndarray) -> float:
    """One fold's metric on the host, for a metric with no device form."""
    if task == "binary":
        scores = prob[:, 1] if prob.ndim == 2 and prob.shape[1] >= 2 \
            else pred
        m = M.binary_metrics(y, pred, scores)
    elif task == "multiclass":
        m = M.multiclass_metrics(y, pred)
    else:
        m = M.regression_metrics(y, pred)
    return m[metric_name]


_LARGER_BETTER = frozenset({"AuROC", "AuPR", "Precision", "Recall", "F1",
                            "R2"})


class _ValidatorBase:
    """The fold-mask validation engine shared by the validators."""

    validation_type = "validator"

    def __init__(self, metric_name: str, task: str, seed: int = 42,
                 stratify: bool = False):
        self.metric_name = metric_name
        self.task = task
        self.seed = seed
        self.stratify = stratify
        self.is_larger_better = metric_name in _LARGER_BETTER

    def _splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(train_mask, val_mask) pairs as 0/1 float arrays."""
        raise NotImplementedError

    def validate(self, families: Sequence[ModelFamily], X: np.ndarray,
                 y: np.ndarray, base_weights: Optional[np.ndarray] = None,
                 device=None, dtype: torch.dtype = torch.float32
                 ) -> Tuple[ModelFamily, Dict[str, Any], ValidatorSummary]:
        """Run the (family × grid × fold) sweep on ``device``; return the
        winner (family, hparams) and the summary. The selection metric is
        taken on the device where it has a device form; otherwise each
        fold's predictions come back and the host metric reads them."""
        dev = resolve_device(device)
        splits = self._splits(y)
        base_w = (np.ones_like(y, dtype=np.float64)
                  if base_weights is None else base_weights)

        def put(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        Xd, yd = put(X), put(y)
        folds = [(put(m * base_w), put(v)) for m, v in splits]

        summary = ValidatorSummary(self.validation_type, self.metric_name)
        ranked: List[Tuple[ValidationResult, ModelFamily]] = []
        for family in families:
            t0 = time.perf_counter()
            metric_fn = self._metric_fn(family)
            Xarg = family.device_prep(Xd)
            groups = self._depth_groups(family, len(y))
            metrics: List[List[Any]] = [[None] * len(folds)
                                        for _ in range(family.grid_size())]
            for k, (w, v) in enumerate(folds):
                self._sweep_fold(family, groups, metric_fn, Xarg, yd, w, v,
                                 y, splits[k][1].astype(bool), metrics, k)
            ranked += self._record(summary, family, metric_fn, metrics, t0)
        return self._winner(summary, ranked)

    def validate_per_fold(self, families: Sequence[ModelFamily],
                          fold_data: Sequence[Tuple[np.ndarray, ...]],
                          device=None, dtype: torch.dtype = torch.float32
                          ) -> Tuple[ModelFamily, Dict[str, Any],
                                     ValidatorSummary]:
        """Workflow-level CV engine: each fold carries its own feature
        matrix (``cut_dag``'s *during* stages were re-fit on the fold's
        training rows upstream of this call), so every fold uploads and
        bins its own matrix. ``fold_data``: per fold ``(X, y, w_train,
        w_val, binary_mask)``, full-length arrays and the fold matrix's
        indicator columns, which a family with a ``binary_mask`` takes
        before ``device_prep`` bins the fold. Within a
        fold the sweep is :meth:`validate`'s: the by-depth groups and the
        device metrics. The summary's type is ``"WorkflowCV:"`` + the
        validation type (OpCrossValidation.scala:89-116, dagCopy)."""
        dev = resolve_device(device)

        def put(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        summary = ValidatorSummary("WorkflowCV:" + self.validation_type,
                                   self.metric_name)
        ranked: List[Tuple[ValidationResult, ModelFamily]] = []
        for family in families:
            t0 = time.perf_counter()
            metric_fn = self._metric_fn(family)
            metrics: List[List[Any]] = [[None] * len(fold_data)
                                        for _ in range(family.grid_size())]
            for k, fold in enumerate(fold_data):
                X, y, w_tr, w_val, bmask = fold
                if hasattr(family, "binary_mask"):
                    family.binary_mask = bmask
                self._sweep_fold(family, self._depth_groups(family, len(y)),
                                 metric_fn, family.device_prep(put(X)),
                                 put(y), put(w_tr), put(w_val), y, w_val > 0,
                                 metrics, k)
            ranked += self._record(summary, family, metric_fn, metrics, t0)
        return self._winner(summary, ranked)

    def _metric_fn(self, family: ModelFamily):
        from ..evaluators.device_metrics import device_metric_fn
        return device_metric_fn(self.task, self.metric_name,
                                n_classes=getattr(family, "n_classes", 2))

    @staticmethod
    def _depth_groups(family: ModelFamily, n: int
                      ) -> List[Tuple[List[int], Optional[int]]]:
        """(grid indices, static depth | None) groups: from
        ``UNROLL_MIN_ROWS`` rows the tree families' grid by ``maxDepth``,
        each grown unrolled at its depth; otherwise the whole grid."""
        from .trees import UNROLL_MIN_ROWS
        if n >= UNROLL_MIN_ROWS and "maxDepth" in family.param_defaults():
            dflt = family.param_defaults().get("maxDepth", 0)
            by_depth: Dict[int, List[int]] = {}
            for i, g in enumerate(family.grid):
                by_depth.setdefault(int(g.get("maxDepth", dflt)),
                                    []).append(i)
            return [(ix, d) for d, ix in sorted(by_depth.items())]
        return [(list(range(family.grid_size())), None)]

    def _sweep_fold(self, family: ModelFamily, groups, metric_fn, Xarg, yd,
                    w, v, y: np.ndarray, vm: np.ndarray,
                    metrics: List[List[Any]], k: int) -> None:
        """Fit every grid point on fold ``k``'s weights ``w``, predict the
        training matrix from the fit-time caches and put each point's
        metric over the validation rows (``v`` on the device, ``vm`` on
        the host) in ``metrics[i][k]``."""
        for ix, sd in groups:
            grid = [family.grid[i] for i in ix]
            params = (family.fit_batch(Xarg, yd, w, grid) if sd is None
                      else family.fit_batch(Xarg, yd, w, grid,
                                            static_depth=sd))
            preds = family.predict_batch(params, Xarg, on_train=True)
            for i, out in zip(ix, preds):
                if metric_fn is not None:
                    metrics[i][k] = metric_fn(yd, out[0], out[2], v)
                    continue
                pred, _raw, prob = to_f64(out)
                metrics[i][k] = _metric_value(
                    self.metric_name, self.task, y[vm], pred[vm],
                    prob[vm] if prob.ndim == 2 else prob)

    def _record(self, summary: ValidatorSummary, family: ModelFamily,
                metric_fn, metrics: List[List[Any]], t0: float
                ) -> List[Tuple[ValidationResult, ModelFamily]]:
        """The family's [grid, folds] metrics read back (one copy when
        they were taken on the device) into the summary's results; returns
        them with the family."""
        if metric_fn is not None:
            per_grid = torch.stack([torch.stack(m) for m in metrics]).to(
                "cpu", torch.float64).numpy()                   # [G, K]
        else:
            per_grid = np.asarray(metrics, dtype=np.float64)
        summary.family_seconds[family.name] = time.perf_counter() - t0
        out = [(ValidationResult(
            family_name=family.name, hparams=family.grid[gi], grid_index=gi,
            metric_values=per_grid[gi].tolist(),
            mean_metric=float(per_grid[gi].mean())), family)
            for gi in range(family.grid_size())]
        summary.results += [r for r, _ in out]
        return out

    def _winner(self, summary: ValidatorSummary,
                ranked: List[Tuple[ValidationResult, ModelFamily]]
                ) -> Tuple[ModelFamily, Dict[str, Any], ValidatorSummary]:
        """The first result with the best mean metric, in sweep order."""
        sign = 1.0 if self.is_larger_better else -1.0
        best: Optional[Tuple[ValidationResult, ModelFamily]] = None
        for r, family in ranked:
            if best is None or \
                    sign * r.mean_metric > sign * best[0].mean_metric:
                best = (r, family)
        assert best is not None
        summary.best = best[0]
        return best[1], best[0].hparams, summary


class CrossValidation(_ValidatorBase):
    """k-fold CV over fold masks (OpCrossValidation.scala)."""

    validation_type = "CrossValidation"

    def __init__(self, num_folds: int = 3, metric_name: str = "AuROC",
                 task: str = "binary", seed: int = 42,
                 stratify: bool = False):
        super().__init__(metric_name, task, seed, stratify)
        self.num_folds = num_folds

    def _splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        n = len(y)
        rng = np.random.default_rng(self.seed)
        fold_of = np.zeros(n, dtype=np.int64)
        if self.stratify and self.task in ("binary", "multiclass"):
            for c in np.unique(y):
                idx = np.nonzero(y == c)[0]
                idx = rng.permutation(idx)
                fold_of[idx] = np.arange(len(idx)) % self.num_folds
        else:
            fold_of = rng.permutation(n) % self.num_folds
        out = []
        for kf in range(self.num_folds):
            val = (fold_of == kf)
            out.append(((~val).astype(np.float64), val.astype(np.float64)))
        return out


class TrainValidationSplit(_ValidatorBase):
    """One train / validation split (OpTrainValidationSplit.scala)."""

    validation_type = "TrainValidationSplit"

    def __init__(self, train_ratio: float = 0.75, metric_name: str = "AuROC",
                 task: str = "binary", seed: int = 42,
                 stratify: bool = False):
        super().__init__(metric_name, task, seed, stratify)
        self.train_ratio = train_ratio

    def _splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        n = len(y)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_train = int(round(n * self.train_ratio))
        train = np.zeros(n, dtype=np.float64)
        train[perm[:n_train]] = 1.0
        return [(train, 1.0 - train)]
