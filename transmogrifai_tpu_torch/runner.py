"""Workflow runner, app entry and file-driven parameters; the port of
``transmogrifai_tpu/runner.py``.

* ``OpParams`` (``OpParams.scala:30-150``): per-stage parameter overrides
  (by stage class name or uid, applied reflectively), reader paths,
  model / write / metrics locations and custom parameters, from JSON.
* ``OpWorkflowRunner`` (``OpWorkflowRunner.scala:296,358-366``): the run
  types Train (fit, save), Score (load, score, write CSV), Evaluate (load,
  evaluate) and Features (load, materialize), each writing a metrics
  document. Runs go to the card unless the runner is given
  ``device="cpu"``. The temporal tier's ``customParams``
  (``aggregateColumnar``, ``joinPartitions``, ``joinTableMaxRows``) are
  validated before anything is installed and hold for the run; the
  ``temporal`` block of every metrics document holds its tallies. A
  write location ending in ``.avro`` gets an Avro container, any other
  a CSV.
* ``OpApp`` (``OpApp.scala``): ``main(argv)`` parses ``--run-type``,
  ``--params`` and the locations, then runs.

What the JAX package's runner adds and this one does not have yet raises
``NotImplementedError`` naming its ROADMAP queue A item when a run asks
for it: the StreamingScore run type, the lint pre-flight, the planner
step, telemetry sinks, the quarantine sink and mesh knobs (all item 6).
Their blocks of the metrics document are left out, and ``preflight`` /
``plan`` read None, as a run with them disabled does there.
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import torch

from .models import _hist

__all__ = ["OpParams", "RunType", "RunnerResult", "OpWorkflowRunner",
           "OpApp"]

#: customParams keys of the JAX package's runner whose module is not
#: ported yet (all ROADMAP queue A, item 6), and what they ask for
_UNPORTED_CUSTOM = {
    "validate": "the lint pre-flight (lint.py)",
    "validateDevice": "the lint pre-flight (lint.py)",
    "failOn": "the lint pre-flight (lint.py)",
    "lintSuppress": "the lint pre-flight (lint.py)",
    "plan": "the planner step (planner.py)",
    "costDb": "the planner step (planner.py)",
    "telemetry": "telemetry sinks (telemetry.py)",
    "traceDir": "telemetry sinks (telemetry.py)",
    "quarantineLocation": "the quarantine sink (resilience.py)",
    "meshDevices": "multi-device runs (parallel/mesh.py)",
    "meshGridSize": "multi-device runs (parallel/mesh.py)",
    "featureShards": "multi-device runs (parallel/mesh.py)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A, item 6)")


def _count_custom_param(params: "OpParams", key: str) -> Optional[int]:
    """``customParams[key]`` as an int of at least 1; None when absent or
    null. A malformed value raises a ``ValueError`` naming the key (a
    float that is not whole, a bool, NaN, a string, zero)."""
    raw = params.custom_params.get(key)
    if raw is None:
        return None
    try:
        if isinstance(raw, bool):
            raise TypeError
        v = int(raw)
        if float(raw) != v or not math.isfinite(float(raw)):
            raise TypeError
    except (TypeError, ValueError, OverflowError):
        raise ValueError(
            f"customParams.{key} must be an integer, got {raw!r}") from None
    if v < 1:
        raise ValueError(f"customParams.{key} must be >= 1, got {raw!r}")
    return v


def _tristate_custom_param(params: "OpParams", key: str) -> Any:
    """``customParams[key]`` as True, False or ``"auto"`` (JSON booleans,
    or the strings "true", "false" and "auto"); None when absent or null.
    Anything else raises a ``ValueError`` naming the key."""
    raw = params.custom_params.get(key)
    if raw is None or isinstance(raw, bool):
        return raw
    if isinstance(raw, str):
        v = raw.strip().lower()
        if v in ("true", "false"):
            return v == "true"
        if v == "auto":
            return "auto"
    raise ValueError(f'customParams.{key} must be a boolean (true/false) '
                     f'or "auto", got {raw!r}')


@dataclass
class OpParams:
    """File-driven workflow configuration (OpParams.scala:30-150)."""

    #: {stage class name or uid: {param: value}} applied via set_params
    stage_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    #: {reader name: {"path": ..., ...}}
    reader_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    model_location: Optional[str] = None
    write_location: Optional[str] = None
    metrics_location: Optional[str] = None
    #: a trace sink (not ported: a run that sets it raises)
    trace_location: Optional[str] = None
    #: "json" (the run document); "prometheus" is not ported
    metrics_format: str = "json"
    #: the dead-letter sink (not ported: a run that sets it raises)
    quarantine_location: Optional[str] = None
    custom_params: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_file(path: str) -> "OpParams":
        """Parameters from a JSON file (the JAX package's keys)."""
        if path.endswith((".yaml", ".yml")):
            raise _not_ported("YAML parameter files (no YAML reader in "
                              "this package)")
        with open(path) as fh:
            doc = json.load(fh)
        return OpParams(
            stage_params=doc.get("stageParams", {}),
            reader_params=doc.get("readerParams", {}),
            model_location=doc.get("modelLocation"),
            write_location=doc.get("writeLocation"),
            metrics_location=doc.get("metricsLocation"),
            trace_location=doc.get("traceLocation"),
            metrics_format=doc.get("metricsFormat", "json"),
            quarantine_location=doc.get("quarantineLocation"),
            custom_params=doc.get("customParams", {}))

    def to_json(self) -> Dict[str, Any]:
        return {"stageParams": self.stage_params,
                "readerParams": self.reader_params,
                "modelLocation": self.model_location,
                "writeLocation": self.write_location,
                "metricsLocation": self.metrics_location,
                "traceLocation": self.trace_location,
                "metricsFormat": self.metrics_format,
                "quarantineLocation": self.quarantine_location,
                "customParams": self.custom_params}

    def apply_to_workflow(self, workflow) -> None:
        """Push stage params into the workflow's DAG stages by uid or class
        name (OpWorkflow.setStageParameters :166-188)."""
        from .graph import all_stages
        if not self.stage_params:
            return
        for stage in all_stages(workflow.result_features):
            for key in (stage.uid, type(stage).__name__):
                if key in self.stage_params:
                    stage.set_params(**self.stage_params[key])

    def check_ported(self) -> None:
        """Raise for anything this run asks of a module not ported yet."""
        if self.trace_location:
            raise _not_ported("trace sinks (telemetry.py)")
        if self.metrics_format != "json":
            raise _not_ported(f"the {self.metrics_format!r} metrics format "
                              "(telemetry.py)")
        if self.quarantine_location:
            raise _not_ported("the quarantine sink (resilience.py)")
        for key, what in _UNPORTED_CUSTOM.items():
            v = self.custom_params.get(key)
            if v is not None and v is not False and v != "false":
                raise _not_ported(f"customParams.{key}: {what}")


class RunType:
    TRAIN = "Train"
    SCORE = "Score"
    STREAMING_SCORE = "StreamingScore"
    EVALUATE = "Evaluate"
    FEATURES = "Features"

    ALL = (TRAIN, SCORE, STREAMING_SCORE, EVALUATE, FEATURES)


@dataclass
class RunnerResult:
    run_type: str
    metrics: Dict[str, Any] = field(default_factory=dict)
    model_location: Optional[str] = None
    scores: Any = None
    #: the WorkflowModel the run trained or loaded
    model: Any = None


def _peak_rss_mb() -> Optional[float]:
    """Peak resident set of this process and its reaped children, MB."""
    try:
        import resource
    except ImportError:
        return None
    kb = max(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
             resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)
    return round(kb / 1024.0, 1)


class OpWorkflowRunner:
    """Run-type entry around a Workflow (OpWorkflowRunner.scala:296).

    The readers follow the readers API (``read_records``); ``evaluator``
    is an evaluator wired to (label, prediction). Fits and scores run on
    ``device`` (default: the card) in ``dtype``."""

    def __init__(self, workflow, training_reader=None, scoring_reader=None,
                 evaluation_reader=None, evaluator=None,
                 features_to_compute=None, device=None,
                 dtype: torch.dtype = torch.float32):
        from .models.base import resolve_device
        self.workflow = workflow
        self.training_reader = training_reader
        self.scoring_reader = scoring_reader
        self.evaluation_reader = evaluation_reader or scoring_reader
        self.evaluator = evaluator
        self.features_to_compute = features_to_compute
        self.device = resolve_device(device)
        self.dtype = dtype

    @staticmethod
    def _write_metrics(location: Optional[str], doc: Dict[str, Any]) -> None:
        if not location:
            return
        os.makedirs(os.path.dirname(location) or ".", exist_ok=True)
        tmp = location + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, default=str)
        os.replace(tmp, location)

    def run(self, run_type: str, params: Optional[OpParams] = None
            ) -> RunnerResult:
        params = params or OpParams()
        if run_type not in RunType.ALL:
            raise ValueError(f"Unknown run type {run_type!r}; expected one "
                             f"of {RunType.ALL}")
        params.check_ported()
        # the temporal tier's run-scoped knobs (docs/readers.md), all
        # validated before any is installed: a malformed value names its
        # key, and no half-installed configuration outlives the run
        from . import temporal
        knobs = dict(
            columnar=_tristate_custom_param(params, "aggregateColumnar"),
            join_partitions=_count_custom_param(params, "joinPartitions"),
            join_table_max_rows=_count_custom_param(params,
                                                    "joinTableMaxRows"))
        launches = dict(_hist.KERNEL_LAUNCHES)
        prev = temporal.set_run_defaults(**knobs)
        try:
            t0 = time.perf_counter()
            result = self._execute(run_type, params, t0)
        finally:
            temporal.set_run_defaults(**prev)
        # the temporal tier's tallies (columnar and row-wise aggregates,
        # joins, spilled rows): zeros on runs that never touch it
        result.metrics["temporal"] = temporal.temporal_stats()
        result.metrics["compileCacheDir"] = None
        result.metrics["preflight"] = None
        result.metrics["plan"] = None
        # the tree engine's kernel launches of this run, per kernel
        result.metrics["trees"] = {"launches": {
            k: v - launches[k] for k, v in _hist.KERNEL_LAUNCHES.items()}}
        result.metrics["peak_rss_mb"] = _peak_rss_mb()
        self._write_metrics(params.metrics_location, result.metrics)
        return result

    def _read(self, reader, what: str):
        """The reader's records. As in the JAX package's runner, Score,
        Evaluate and Features read ``read_records()`` even from an
        aggregating reader: they see its events, not its keys (ROADMAP
        C)."""
        if reader is None:
            raise ValueError(f"{what} needs a reader")
        return reader.read_records()

    def _execute(self, run_type: str, params: OpParams,
                 t0: float) -> RunnerResult:
        if run_type == RunType.TRAIN:
            params.apply_to_workflow(self.workflow)
            if self.training_reader is not None:
                self.workflow.set_reader(self.training_reader)
            model = self.workflow.train(device=self.device,
                                        dtype=self.dtype)
            if params.model_location:
                model.save(params.model_location, overwrite=True)
            metrics = model.summary()
            metrics["appSeconds"] = round(time.perf_counter() - t0, 3)
            # the RawFeatureFilter's verdict (None: no filter configured)
            metrics["rawFeatureFilter"] = (
                model.rff_results.summary()
                if model.rff_results is not None else None)
            return RunnerResult(run_type, metrics=metrics,
                                model_location=params.model_location,
                                model=model)
        if run_type == RunType.STREAMING_SCORE:
            raise _not_ported("the StreamingScore run type (readers/"
                              "streaming.py, the stream readers)")

        from .workflow import WorkflowModel
        if params.model_location is None:
            raise ValueError(f"{run_type} requires modelLocation")
        model = WorkflowModel.load(params.model_location)

        if run_type == RunType.SCORE:
            data = self._read(self.scoring_reader, "Score")
            scores = model.score(data, device=self.device)
            if params.write_location:
                _write_store(scores, params.write_location)
            metrics = {"rowsScored": scores.n_rows,
                       "appSeconds": round(time.perf_counter() - t0, 3)}
            return RunnerResult(run_type, metrics=metrics, scores=scores,
                                model=model)

        if run_type == RunType.EVALUATE:
            data = self._read(self.evaluation_reader, "Evaluate")
            metrics = dict(model.evaluate(data, self.evaluator,
                                          device=self.device))
            metrics["appSeconds"] = round(time.perf_counter() - t0, 3)
            return RunnerResult(run_type, metrics=metrics, model=model)

        # FEATURES: the engineered features only; one target prunes the
        # DAG to its ancestors, several compute the whole DAG
        data = self._read(self.training_reader or self.scoring_reader,
                          "Features")
        ftc = self.features_to_compute
        if isinstance(ftc, (list, tuple)):
            ftc = ftc[0] if len(ftc) == 1 else None
        store = model.transform(data, device=self.device, up_to=ftc)
        if params.write_location:
            _write_store(store, params.write_location)
        metrics = {"rows": store.n_rows,
                   "appSeconds": round(time.perf_counter() - t0, 3)}
        return RunnerResult(run_type, metrics=metrics, scores=store,
                            model=model)


class _CsvSink:
    """Incremental CSV sink (saveScores analog): the header from the first
    store, its rows after."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._names = None
        self._fh = open(path, "w", newline="")
        self._writer = csv.writer(self._fh)

    def write_header(self, names) -> None:
        if self._names is None:
            self._names = list(names)
            self._writer.writerow(self._names)

    def write(self, store) -> None:
        self.write_header(store.names())
        cols = [store[n] for n in self._names]
        for i in range(store.n_rows):
            self._writer.writerow([c.get_raw(i) for c in cols])

    def close(self) -> None:
        self._fh.close()


class _AvroSink:
    """Avro container sink (``saveScores`` / ``saveAvro``,
    ``OpWorkflowModel.scala:376-421``): the schema inferred from the first
    store's rows, each store appended as one sync-delimited block."""

    def __init__(self, path: str):
        self._path = path
        self._names = None
        self._writer = None

    def write_header(self, names) -> None:
        if self._names is None:
            self._names = list(names)

    @staticmethod
    def _pyify(v):
        import numpy as np
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, dict):
            return {k: _AvroSink._pyify(x) for k, x in v.items()}
        if isinstance(v, (set, frozenset)):
            return sorted(_AvroSink._pyify(x) for x in v)
        if isinstance(v, (list, tuple)):
            return [_AvroSink._pyify(x) for x in v]
        return v

    def write(self, store) -> None:
        self.write_header(store.names())
        records = [{n: self._pyify(store[n].get_raw(i))
                    for n in self._names}
                   for i in range(store.n_rows)]
        if not records:
            return      # empty store: close() writes the header-only file
        if self._writer is None:
            from .readers.avro import AvroWriter, infer_avro_schema
            self._writer = AvroWriter(
                self._path, infer_avro_schema(records))
        self._writer.append(records)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        elif self._names is not None:
            # header-only output on empty input (schema from names alone)
            from .readers.avro import AvroWriter
            AvroWriter(self._path, {
                "type": "record", "name": "ScoreRecord",
                "fields": [{"name": n, "type": ["null", "string"]}
                           for n in self._names]}).close()


def _write_store(store, path: str) -> None:
    """One store to ``path``: an Avro container where the path ends in
    ``.avro`` (the reference's saveScores), else CSV."""
    sink = _AvroSink(path) if path.endswith(".avro") else _CsvSink(path)
    try:
        sink.write(store)
    finally:
        sink.close()


class OpApp:
    """Application entry (OpApp.scala): a subclass provides the runner;
    ``main(argv)`` parses the run type and parameters and runs it."""

    def runner(self, params: OpParams) -> OpWorkflowRunner:
        raise NotImplementedError

    def main(self, argv: Optional[Sequence[str]] = None) -> RunnerResult:
        ap = argparse.ArgumentParser(description=type(self).__name__)
        ap.add_argument("--run-type", required=True, choices=RunType.ALL)
        ap.add_argument("--params", help="OpParams JSON file")
        ap.add_argument("--model-location")
        ap.add_argument("--write-location")
        ap.add_argument("--metrics-location")
        ap.add_argument("--quiet", action="store_true",
                        help="suppress INFO progress logging")
        args = ap.parse_args(argv)
        if not args.quiet:
            import logging
            logging.basicConfig(level=logging.INFO)
        params = (OpParams.from_file(args.params) if args.params
                  else OpParams())
        for key in ("model_location", "write_location", "metrics_location"):
            if getattr(args, key):
                setattr(params, key, getattr(args, key))
        return self.runner(params).run(args.run_type, params)
