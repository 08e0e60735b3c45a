"""ModelSelector — AutoML model selection over a CV grid; the port of
``transmogrifai_tpu/models/selector.py``: binary classification (default
families logistic regression, random forest, GBT, linear SVC; AuPR;
``DataBalancer``), multiclass (logistic regression, naive Bayes, random
forest, decision tree; F1; ``DataCutter``) and regression (linear
regression, random forest, GBT; RMSE; ``DataSplitter``).

``fit``: the splitter prepares (balancing, label cutting, physical
sampling) → the validator sweeps every (family × grid × fold) → the best
grid point is refit on the full prepared train → train evaluation →
``SelectedModel`` with a ``ModelSelectorSummary``
(``ModelSelector.scala:135-196``). Under workflow-level CV
:meth:`ModelSelector.select_per_fold` has already swept the folds, each
on its own feature matrix, and the fit goes straight to the refit. A
``DataCutter`` that re-indexed the labels leaves the model its
``label_mapping`` (model class → original label), which the model
applies to every prediction.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..columns import ColumnStore
from ..evaluators import metrics as M
from ..parallel import mesh as _mesh
from ..stages.base import register_stage, stage_from_state
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   device_table, extract_xy, resolve_device, to_f64)
from .tuning import (CrossValidation, DataBalancer, DataCutter,
                     DataSplitter, Splitter, TrainValidationSplit,
                     ValidatorSummary)

__all__ = ["ModelSelector", "SelectedModel", "ModelSelectorSummary",
           "BinaryClassificationModelSelector",
           "MultiClassificationModelSelector", "RegressionModelSelector"]

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


def _task_metrics(task: str, y, pred, prob) -> Dict[str, Any]:
    if task == "binary":
        scores = prob[:, 1] if prob.ndim == 2 and prob.shape[1] >= 2 \
            else pred
        return M.binary_metrics(y, pred, scores)
    if task == "multiclass":
        out: Dict[str, Any] = M.multiclass_metrics(y, pred)
        if prob is not None and np.ndim(prob) == 2 and prob.shape[1] >= 2:
            # topN × confidence-band counts, as the reference's
            # MultiClassificationMetrics carry them
            # (OpMultiClassificationEvaluator.scala:120-132)
            out["ThresholdMetrics"] = M.multiclass_threshold_metrics(y, prob)
        return out
    return M.regression_metrics(y, pred)


@register_stage
class SelectedModel(PredictorModel):
    """The winning fitted model wrapped with selection metadata
    (ModelSelector.scala:216-255). ``label_mapping``: model class →
    original label value, when a DataCutter dropped labels and re-indexed
    the rest (the reference fixes the NominalAttribute metadata instead)."""

    operation_name = "modelSelector"

    def __init__(self, inner: Optional[PredictorModel] = None,
                 task: str = "binary",
                 label_mapping: Optional[Sequence[float]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.inner = inner
        self.task = task
        self.label_mapping = (list(label_mapping) if label_mapping
                              else None)
        self.selector_summary: Optional[ModelSelectorSummary] = None

    def predict_device(self, Xd: torch.Tensor):
        """The inner model's triple with the predicted class read through
        the label mapping: a table on the device (uploaded once, so the
        scoring engine's graphs capture no copy) indexed with the class,
        in the prediction's dtype."""
        pred, raw, prob = self.inner.predict_device(Xd)
        if self.label_mapping is not None:
            dt = str(pred.dtype).rpartition(".")[2]
            lm = device_table(self, f"label_mapping_{dt}", lambda: np.asarray(
                self.label_mapping, dtype=dt), pred.device)
            pred = lm[torch.clamp(pred.long(), 0, len(self.label_mapping)
                                  - 1)]
        return pred, raw, prob

    def predict_arrays(self, X, device=None):
        """On the host the mapping is applied in exact float64, so any
        original label value survives."""
        pred, raw, prob = self.inner.predict_arrays(X, device=device)
        if self.label_mapping is not None:
            lm = np.asarray(self.label_mapping, dtype=np.float64)
            pred = lm[np.clip(np.asarray(pred).astype(np.int64), 0,
                              len(lm) - 1)]
        return pred, raw, prob

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
        self.__dict__.pop("_device_tables", None)

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
    #: the ranks the sweep and the refit shard over: None resolves to the
    #: process-default mesh (a workflow assigns its resolved one), False
    #: forces the single-process path
    mesh = None

    def __init__(self, validator=None,
                 splitter: Optional[Splitter] = None,
                 families: Optional[Sequence[ModelFamily]] = None,
                 task: str = "binary", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.validator = validator
        self.splitter = splitter
        self.families = list(families or [])
        self.task = task
        #: (family, hparams, summary) of the workflow-level CV sweep
        #: (:meth:`select_per_fold`); taken by the next fit, which then
        #: does not sweep again (ModelSelector.scala:135-156,
        #: bestEstimator.getOrElse)
        self.precomputed_ = None

    def _set_classes(self, y: np.ndarray) -> None:
        """Every family with a class count learns it from the prepared
        labels (for regression too, where no family reads it)."""
        n_classes = max(int(y.max()) + 1 if len(y) else 2, 2)
        for fam in self.families:
            if hasattr(fam, "n_classes"):
                fam.n_classes = n_classes

    def _kept_labels(self, y: np.ndarray):
        """(kept rows mask, their relabelled labels, their weights): the
        splitter estimates on the full labels, drops, relabels and
        weights."""
        if self.splitter is None:
            return np.ones(len(y), dtype=bool), y, np.ones_like(y)
        self.splitter.pre_validation_prepare(y)
        keep = self.splitter.keep_mask(y)
        y = self.splitter.relabel(y[keep])
        return keep, y, self.splitter.sample_weights(y)

    def _prepared(self, X: np.ndarray, y: np.ndarray):
        """(X, y, weights) after the splitter's preparation: estimate on
        the full labels, drop, relabel, weight, physically sample."""
        keep, y, w = self._kept_labels(y)
        if not keep.all():
            X = X[keep]
        if self.splitter is not None:
            sub, w = self.splitter.physical_sample(y, w)
            if sub is not None:
                X, y = X[sub], y[sub]
        return X, y, w

    def select_per_fold(self, store: ColumnStore,
                        fold_matrix: Callable[[ColumnStore, np.ndarray],
                                              np.ndarray],
                        device=None, dtype: torch.dtype = torch.float32
                        ) -> None:
        """Workflow-level CV's sweep (OpCrossValidation.scala:89-116,
        dagCopy): the labels of ``store`` prepared as the fit prepares
        them (no physical sampling), then per fold of the validator
        ``fold_matrix(kept_store, train_rows)``, the feature matrix of
        every kept row with the label-aware stages fitted on
        ``train_rows`` only, swept by ``validate_per_fold``. The winner
        and the summary wait for the next fit."""
        from .trees import detect_binary_columns
        y = np.asarray(store[self.label_name].values, dtype=np.float64)
        keep, y, w = self._kept_labels(y)
        kept = store if keep.all() else store.take(np.nonzero(keep)[0])
        self._set_classes(y)
        folds = []
        for train_mask, val_mask in self.validator._splits(y):
            X = fold_matrix(kept, np.nonzero(train_mask > 0)[0])
            folds.append((X, y, train_mask * w, val_mask,
                          detect_binary_columns(X)))
        self.precomputed_ = self.validator.validate_per_fold(
            self.families, folds, device=device, dtype=dtype,
            mesh=_mesh.stage_mesh(self))

    def fit_columns(self, store: ColumnStore, device=None,
                    dtype: torch.dtype = torch.float32) -> SelectedModel:
        from .trees import detect_binary_columns
        dev = resolve_device(device)
        X_all, y = extract_xy(store, self.label_name, self.features_name)
        precomputed, self.precomputed_ = self.precomputed_, None
        X, y, w = self._prepared(X_all, y)
        self._set_classes(y)
        # after workflow CV the prepare side effects are replayed (the
        # splitter's state, the class count, and, as the JAX package
        # replays it, the indicator mask of the whole matrix) and the
        # sweep is not
        bmask = detect_binary_columns(X_all if precomputed else X)
        for fam in self.families:
            if hasattr(fam, "binary_mask"):
                fam.binary_mask = bmask
        mesh = _mesh.stage_mesh(self)
        if precomputed:
            best_family, best_hparams, vsummary = precomputed
        else:
            best_family, best_hparams, vsummary = self.validator.validate(
                self.families, X, y, base_weights=w, device=dev,
                dtype=dtype, mesh=mesh)

        # final refit on the full prepared train (ModelSelector.scala:158),
        # over the sweep's mesh
        t0 = time.perf_counter()
        single = best_family.clone_single(best_hparams)
        with _mesh.sharded_scope(mesh if single.row_sharded else None):
            params, Xarg = single.fit_prepared(
                torch.as_tensor(X, dtype=dtype, device=dev),
                torch.as_tensor(y, dtype=dtype, device=dev),
                torch.as_tensor(w, dtype=dtype, device=dev))
            pred, _raw, prob = to_f64(
                single.predict_batch(params, Xarg, on_train=True)[0])
        logger.info("final refit (fit + train predict): %.2fs",
                    time.perf_counter() - t0)
        model = SelectedModel(
            inner=single.realize(params[0], best_hparams), task=self.task,
            label_mapping=(self.splitter.original_labels() if self.splitter
                           else None))
        model.selector_summary = ModelSelectorSummary(
            validator_summary=vsummary,
            splitter_summary=self.splitter.summary if self.splitter else {},
            train_evaluation=_task_metrics(self.task, y, pred, prob),
            best_model_name=best_family.name,
            best_model_params=best_hparams)
        return model


# ---------------------------------------------------------------------------
# Factories (BinaryClassificationModelSelector.scala etc.)
# ---------------------------------------------------------------------------

class _SelectorFactory:
    task = "binary"
    default_metric = "AuPR"

    @classmethod
    def default_families(cls) -> List[ModelFamily]:
        raise NotImplementedError

    @classmethod
    def default_splitter(cls) -> Splitter:
        raise NotImplementedError

    @classmethod
    def _selector(cls, validator, families, splitter) -> ModelSelector:
        return ModelSelector(
            validator=validator,
            splitter=(splitter if splitter is not None
                      else cls.default_splitter()),
            families=(families if families is not None
                      else cls.default_families()),
            task=cls.task)

    @classmethod
    def with_cross_validation(cls, num_folds: int = 3,
                              validation_metric: Optional[str] = None,
                              families: Optional[Sequence[ModelFamily]] = None,
                              splitter: Optional[Splitter] = None,
                              seed: int = 42,
                              stratify: bool = False) -> ModelSelector:
        return cls._selector(CrossValidation(
            num_folds=num_folds,
            metric_name=validation_metric or cls.default_metric,
            task=cls.task, seed=seed, stratify=stratify), families, splitter)

    @classmethod
    def with_train_validation_split(
            cls, train_ratio: float = 0.75,
            validation_metric: Optional[str] = None,
            families: Optional[Sequence[ModelFamily]] = None,
            splitter: Optional[Splitter] = None,
            seed: int = 42) -> ModelSelector:
        return cls._selector(TrainValidationSplit(
            train_ratio=train_ratio,
            metric_name=validation_metric or cls.default_metric,
            task=cls.task, seed=seed), families, splitter)


class BinaryClassificationModelSelector(_SelectorFactory):
    """Binary selection; metric AuPR, splitter DataBalancer."""

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
    def default_splitter(cls) -> Splitter:
        return DataBalancer()


class MultiClassificationModelSelector(_SelectorFactory):
    """Multiclass selection; metric F1, splitter DataCutter."""

    task = "multiclass"
    default_metric = "F1"

    @classmethod
    def default_families(cls) -> List[ModelFamily]:
        """LR, naive Bayes, RF and DT, in the JAX package's order."""
        from .linear import LogisticRegressionFamily, NaiveBayesFamily
        from .trees import DecisionTreeFamily, RandomForestFamily
        return [LogisticRegressionFamily(), NaiveBayesFamily(),
                RandomForestFamily(), DecisionTreeFamily()]

    @classmethod
    def default_splitter(cls) -> Splitter:
        return DataCutter()


class RegressionModelSelector(_SelectorFactory):
    """Regression selection; metric RMSE, splitter DataSplitter."""

    task = "regression"
    default_metric = "RootMeanSquaredError"

    @classmethod
    def default_families(cls) -> List[ModelFamily]:
        """Linear regression, RF and GBT regressors, in the JAX package's
        order."""
        from .linear import LinearRegressionFamily
        from .trees import GBTFamily, RandomForestFamily
        return [LinearRegressionFamily(),
                RandomForestFamily(task="regression"),
                GBTFamily(task="regression")]

    @classmethod
    def default_splitter(cls) -> Splitter:
        return DataSplitter()
