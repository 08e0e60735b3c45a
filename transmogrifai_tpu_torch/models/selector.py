"""ModelSelector — AutoML model selection over a CV grid; the port of
``transmogrifai_tpu/models/selector.py`` for binary classification (the
default families: logistic regression, random forest, GBT, linear SVC).

``fit``: the splitter prepares (balancing, physical sampling) → the
validator sweeps every (family × grid × fold) → the best grid point is
refit on the full prepared train → train evaluation → ``SelectedModel``
with a ``ModelSelectorSummary`` (``ModelSelector.scala:135-196``).
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columns import ColumnStore
from ..evaluators import metrics as M
from ..stages.base import register_stage, stage_from_state
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   extract_xy, resolve_device, to_f64)
from .tuning import (CrossValidation, DataBalancer, Splitter,
                     ValidatorSummary)

__all__ = ["ModelSelector", "SelectedModel", "ModelSelectorSummary",
           "BinaryClassificationModelSelector"]

logger = logging.getLogger(__name__)


class ModelSelectorSummary:
    """Validation results + data prep + evals (ModelSelectorSummary.scala)."""

    def __init__(self, validator_summary: ValidatorSummary,
                 splitter_summary: Dict[str, Any],
                 train_evaluation: Dict[str, float],
                 holdout_evaluation: Optional[Dict[str, float]] = None,
                 best_model_name: str = "",
                 best_model_params: Optional[Dict] = None):
        self.validator_summary = validator_summary
        self.splitter_summary = splitter_summary
        self.train_evaluation = train_evaluation
        self.holdout_evaluation = holdout_evaluation
        self.best_model_name = best_model_name
        self.best_model_params = best_model_params or {}

    def to_json(self) -> Dict[str, Any]:
        return {
            "bestModelName": self.best_model_name,
            "bestModelParams": self.best_model_params,
            "validationResults": self.validator_summary.to_json(),
            "dataPrepSummary": self.splitter_summary,
            "trainEvaluation": self.train_evaluation,
            "holdoutEvaluation": self.holdout_evaluation,
        }


def _task_metrics(task: str, y, pred, prob) -> Dict[str, float]:
    if task != "binary":
        raise NotImplementedError(
            f"{task} selection is not ported (ROADMAP queue A, item 4)")
    scores = prob[:, 1] if prob.ndim == 2 and prob.shape[1] >= 2 else pred
    return M.binary_metrics(y, pred, scores)


@register_stage
class SelectedModel(PredictorModel):
    """The winning fitted model wrapped with selection metadata
    (ModelSelector.scala:216-255). Binary selection maps no labels;
    ``label_mapping`` (multiclass, ROADMAP queue A, item 4) must be None."""

    operation_name = "modelSelector"

    def __init__(self, inner: Optional[PredictorModel] = None,
                 task: str = "binary", label_mapping=None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if label_mapping is not None:
            raise NotImplementedError(
                "label mapping (DataCutter) is not ported (ROADMAP queue "
                "A, item 4)")
        self.inner = inner
        self.task = task
        self.label_mapping = label_mapping
        self.selector_summary: Optional[ModelSelectorSummary] = None

    def predict_device(self, Xd: torch.Tensor):
        return self.inner.predict_device(Xd)

    def predict_arrays(self, X, device=None):
        return self.inner.predict_arrays(X, device=device)

    def get_params(self) -> Dict[str, Any]:
        p = super().get_params()
        p.pop("inner", None)  # rebuilt from the model state
        return p

    def get_model_state(self) -> Dict[str, Any]:
        inner_params = self.inner.get_params()
        inner_params.pop("uid", None)
        return {"inner_class": type(self.inner).__name__,
                "inner_params": inner_params,
                "inner_state": self.inner.get_model_state()}

    def apply_model_state(self, state: Dict[str, Any]) -> None:
        self.inner = stage_from_state(state["inner_class"],
                                      state["inner_params"],
                                      state["inner_state"])

    def summary(self) -> Dict[str, Any]:
        out = {"model": "SelectedModel", "task": self.task}
        if self.selector_summary is not None:
            out.update(self.selector_summary.to_json())
        return out

    def has_test_eval(self) -> bool:
        return True

    def evaluate_model(self, test: ColumnStore, device=None) -> None:
        """Holdout evaluation during the workflow fit (HasTestEval)."""
        X, y = extract_xy(test, self.input_features[0].name,
                          self.input_features[1].name)
        pred, _raw, prob = self.predict_arrays(X, device=device)
        if self.selector_summary is not None:
            self.selector_summary.holdout_evaluation = _task_metrics(
                self.task, y, pred, prob)


@register_stage
class ModelSelector(PredictorEstimator):
    """Estimator(label, features) → Prediction via validated selection."""

    operation_name = "modelSelector"

    def __init__(self, validator: Optional[CrossValidation] = None,
                 splitter: Optional[Splitter] = None,
                 families: Optional[Sequence[ModelFamily]] = None,
                 task: str = "binary", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.validator = validator
        self.splitter = splitter
        self.families = list(families or [])
        self.task = task

    def _prepared(self, X: np.ndarray, y: np.ndarray):
        """(X, y, weights) after the splitter's preparation: estimate on
        the full labels, drop, relabel, weight, physically sample."""
        if self.splitter is None:
            return X, y, np.ones_like(y)
        self.splitter.pre_validation_prepare(y)
        keep = self.splitter.keep_mask(y)
        if not keep.all():
            X, y = X[keep], y[keep]
        y = self.splitter.relabel(y)
        w = self.splitter.sample_weights(y)
        sub, w = self.splitter.physical_sample(y, w)
        if sub is not None:
            X, y = X[sub], y[sub]
        return X, y, w

    def fit_columns(self, store: ColumnStore, device=None,
                    dtype: torch.dtype = torch.float32) -> SelectedModel:
        from .trees import detect_binary_columns
        dev = resolve_device(device)
        X, y = extract_xy(store, self.label_name, self.features_name)
        X, y, w = self._prepared(X, y)
        n_classes = max(int(y.max()) + 1 if len(y) else 2, 2)
        bmask = detect_binary_columns(X)
        for fam in self.families:
            fam.n_classes = n_classes
            fam.binary_mask = bmask
        best_family, best_hparams, vsummary = self.validator.validate(
            self.families, X, y, base_weights=w, device=dev, dtype=dtype)

        # final refit on the full prepared train (ModelSelector.scala:158)
        t0 = time.perf_counter()
        single = best_family.clone_single(best_hparams)
        params, Xarg = single.fit_prepared(
            torch.as_tensor(X, dtype=dtype, device=dev),
            torch.as_tensor(y, dtype=dtype, device=dev),
            torch.as_tensor(w, dtype=dtype, device=dev))
        pred, _raw, prob = to_f64(
            single.predict_batch(params, Xarg, on_train=True)[0])
        logger.info("final refit (fit + train predict): %.2fs",
                    time.perf_counter() - t0)
        model = SelectedModel(inner=single.realize(params[0], best_hparams),
                              task=self.task)
        model.selector_summary = ModelSelectorSummary(
            validator_summary=vsummary,
            splitter_summary=self.splitter.summary if self.splitter else {},
            train_evaluation=_task_metrics(self.task, y, pred, prob),
            best_model_name=best_family.name,
            best_model_params=best_hparams)
        return model


# ---------------------------------------------------------------------------
# Factory (BinaryClassificationModelSelector.scala)
# ---------------------------------------------------------------------------

class BinaryClassificationModelSelector:
    """Binary selection; metric auPR, splitter DataBalancer."""

    task = "binary"
    default_metric = "AuPR"

    @classmethod
    def default_families(cls) -> List[ModelFamily]:
        """LR, RF, GBT and LinearSVC on their default grids, in the JAX
        package's order."""
        from .linear import LogisticRegressionFamily
        from .svm import LinearSVCFamily
        from .trees import GBTFamily, RandomForestFamily
        return [LogisticRegressionFamily(), RandomForestFamily(),
                GBTFamily(), LinearSVCFamily()]

    @classmethod
    def with_cross_validation(cls, num_folds: int = 3,
                              validation_metric: Optional[str] = None,
                              families: Optional[Sequence[ModelFamily]] = None,
                              splitter: Optional[Splitter] = None,
                              seed: int = 42,
                              stratify: bool = False) -> ModelSelector:
        return ModelSelector(
            validator=CrossValidation(
                num_folds=num_folds,
                metric_name=validation_metric or cls.default_metric,
                task=cls.task, seed=seed, stratify=stratify),
            splitter=splitter if splitter is not None else DataBalancer(),
            families=(families if families is not None
                      else cls.default_families()),
            task=cls.task)
