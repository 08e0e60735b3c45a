"""Workflow runtime — DAG fitting and scoring; the port of
``transmogrifai_tpu/workflow.py`` (train, score, evaluate).

* ``Workflow.set_result_features(...)`` reconstructs the stage DAG from the
  requested outputs; ``train()`` folds over its layers deepest-first: fit
  each layer's estimators on the train split, evaluate ``has_test_eval``
  models on the holdout, then transform both splits with the fitted layer
  (``FitStagesUtil.fitAndTransformLayer``).
* ``WorkflowModel`` holds the fitted stages keyed by estimator uid and
  scores by replaying the transform layers.

Device stages (``uses_device``) run on ``device``: the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .columns import ColumnStore
from .features import Feature
from .graph import StagesDAG, compute_dag
from .models.base import resolve_device
from .stages.base import Estimator, FittedModel, Transformer
from .stages.generator import FeatureGeneratorStage
from .utils import uid as uid_mod

__all__ = ["Workflow", "WorkflowModel", "WorkflowError"]

logger = logging.getLogger(__name__)


class WorkflowError(Exception):
    pass


def _raw_features_of(result_features: Sequence[Feature]) -> List[Feature]:
    seen: Dict[str, Feature] = {}
    for f in result_features:
        for raw in f.raw_features():
            seen.setdefault(raw.uid, raw)
    return sorted(seen.values(), key=lambda f: f.name)


def _raw_store(data, raw_features: Sequence[Feature]) -> ColumnStore:
    """The raw feature columns of ``data``: a ColumnStore keyed by raw
    feature names, or a sequence of record dicts run through each
    feature's generator (``DataReader.generateDataFrame``)."""
    if not isinstance(data, ColumnStore):
        records = list(data)
        cols = {}
        for f in raw_features:
            gen = f.origin_stage
            if not isinstance(gen, FeatureGeneratorStage):
                raise WorkflowError(
                    f"Raw feature {f.name!r} has no generator stage")
            cols[f.name] = gen.extract_column(records)
        return ColumnStore(cols, len(records))
    missing = [f.name for f in raw_features if f.name not in data]
    if missing:
        raise WorkflowError(f"Input store is missing raw features {missing}")
    return data.select([f.name for f in raw_features])


def _device_kw(stage, device) -> Dict[str, Any]:
    return {"device": device} if getattr(stage, "uses_device", False) else {}


def _apply_layer(models: Sequence[Transformer], store: ColumnStore,
                 device, seconds: Optional[Dict[str, float]] = None
                 ) -> ColumnStore:
    """Transform ``store`` by each model; ``seconds`` accumulates each
    stage's wall-clock by uid."""
    for m in models:
        t0 = time.perf_counter()
        store = m.transform(store, **_device_kw(m, device))
        if seconds is not None:
            seconds[m.uid] = seconds.get(m.uid, 0.0) \
                + time.perf_counter() - t0
    return store


class Workflow:
    """Untrained pipeline: raw data + result features → fitted model."""

    def __init__(self):
        self.uid = uid_mod.make_uid("Workflow")
        self.result_features: Tuple[Feature, ...] = ()
        #: a ColumnStore or a list of record dicts
        self._input_data = None
        #: a readers.DataReader, read when no input data is set
        self._reader = None
        self.splitter = None          # tuning.Splitter for the holdout

    def set_result_features(self, *features: Feature) -> "Workflow":
        if not features:
            raise WorkflowError("Must provide at least one result feature")
        self.result_features = tuple(features)
        try:
            compute_dag(self.result_features, True)
        except ValueError as e:
            raise WorkflowError(str(e)) from e
        return self

    def set_input_store(self, store: ColumnStore) -> "Workflow":
        self._input_data = store
        return self

    def set_input_records(self, records: Sequence[Mapping[str, Any]]
                          ) -> "Workflow":
        """Record dicts; each raw feature's generator extracts its column
        when ``train`` runs."""
        self._input_data = list(records)
        return self

    def set_reader(self, reader) -> "Workflow":
        """A ``readers.DataReader``; ``train`` reads its records when no
        input store or records are set."""
        self._reader = reader
        return self

    def set_splitter(self, splitter) -> "Workflow":
        self.splitter = splitter
        return self

    def train(self, device=None,
              dtype: torch.dtype = torch.float32) -> "WorkflowModel":
        """Fit the DAG on ``device`` (default: the card) in ``dtype``."""
        dev = resolve_device(device)
        data = self._input_data
        if data is None and self._reader is not None:
            data = self._reader.read_records()
        if data is None:
            raise WorkflowError("No input data: call set_input_store, "
                                "set_input_records or set_reader")
        store = _raw_store(data, _raw_features_of(self.result_features))
        train, test = store, None
        if self.splitter is not None:
            train, test = self.splitter.reserve_split(store)
        dag = compute_dag(self.result_features)
        t0 = time.perf_counter()
        fitted: Dict[str, FittedModel] = {}
        seconds: Dict[str, float] = {}
        for li, layer in enumerate(dag):
            models: List[Transformer] = []
            for stage in layer:
                if isinstance(stage, Estimator):
                    kw = _device_kw(stage, dev)
                    if kw:
                        kw["dtype"] = dtype
                    ts = time.perf_counter()
                    model = stage.fit(train, **kw)
                    seconds[stage.uid] = time.perf_counter() - ts
                    fitted[stage.uid] = model
                    if model.has_test_eval() and test is not None:
                        model.evaluate_model(test, **_device_kw(model, dev))
                    models.append(model)
                elif isinstance(stage, Transformer):
                    models.append(stage)
                else:
                    raise WorkflowError(f"Unfittable stage {stage!r}")
            if li < len(dag) - 1:       # the last layer's outputs are unused
                train = _apply_layer(models, train, dev, seconds)
                if test is not None:
                    test = _apply_layer(models, test, dev, seconds)
        train_time = time.perf_counter() - t0
        logger.info("train: %d rows, %d layers in %.2fs", train.n_rows,
                    len(dag), train_time)
        return WorkflowModel(self.result_features, fitted, dag,
                             train_time_s=train_time,
                             stage_seconds=seconds)


class WorkflowModel:
    """Fitted pipeline (OpWorkflowModel): score / evaluate."""

    def __init__(self, result_features: Sequence[Feature],
                 fitted_stages: Dict[str, FittedModel],
                 dag: Optional[StagesDAG] = None, train_time_s: float = 0.0,
                 stage_seconds: Optional[Dict[str, float]] = None):
        self.uid = uid_mod.make_uid("WorkflowModel")
        self.result_features = tuple(result_features)
        self.fitted_stages = dict(fitted_stages)
        self.dag = dag if dag is not None else compute_dag(result_features)
        self.train_time_s = train_time_s
        #: stage uid → train wall-clock seconds (its fit + its transforms)
        self.stage_seconds = dict(stage_seconds or {})

    def _resolved_dag(self) -> List[List[Transformer]]:
        out: List[List[Transformer]] = []
        for layer in self.dag:
            row: List[Transformer] = []
            for stage in layer:
                model = self.fitted_stages.get(stage.uid)
                if model is not None:
                    row.append(model)
                elif isinstance(stage, Transformer):
                    row.append(stage)
                else:
                    raise WorkflowError(
                        f"Estimator {stage.uid} has no fitted model")
            out.append(row)
        return out

    def transform(self, data, device=None) -> ColumnStore:
        """Apply every fitted layer to ``data`` (a ColumnStore or record
        dicts) on ``device`` (default: the card)."""
        dev = resolve_device(device)
        store = _raw_store(data, _raw_features_of(self.result_features))
        for layer in self._resolved_dag():
            store = _apply_layer(layer, store, dev)
        return store

    def score(self, data: ColumnStore, keep_intermediate: bool = False,
              device=None) -> ColumnStore:
        """Result feature columns (OpWorkflowModel.score)."""
        store = self.transform(data, device=device)
        if keep_intermediate:
            return store
        return store.select([f.name for f in self.result_features
                             if f.name in store])

    def score_and_evaluate(self, data: ColumnStore, evaluator, device=None
                           ) -> Tuple[ColumnStore, Dict[str, Any]]:
        store = self.transform(data, device=device)
        metrics = evaluator.evaluate_all(store)
        return store.select([f.name for f in self.result_features
                             if f.name in store]), metrics

    def evaluate(self, data: ColumnStore, evaluator,
                 device=None) -> Dict[str, Any]:
        return self.score_and_evaluate(data, evaluator, device=device)[1]
