"""Workflow runner, app entry and file-driven parameters; the port of
``transmogrifai_tpu/runner.py``.

* ``OpParams`` (``OpParams.scala:30-150``): per-stage parameter overrides
  (by stage class name or uid, applied reflectively), reader paths,
  model / write / metrics locations and custom parameters, from JSON.
* ``OpWorkflowRunner`` (``OpWorkflowRunner.scala:296,358-366``): the run
  types Train (fit, save), Score (load, score, write CSV), StreamingScore
  (load, score batch by batch, each batch written and dropped), Evaluate
  (load, evaluate) and Features (load, materialize), each writing a
  metrics document. Runs go to the card unless the runner is given
  ``device="cpu"``. The temporal tier's ``customParams``
  (``aggregateColumnar``, ``joinPartitions``, ``joinTableMaxRows``) are
  validated before anything is installed and hold for the run; the
  ``temporal`` block of every metrics document holds its tallies. A
  write location ending in ``.avro`` gets an Avro container, any other
  a CSV.
* The pre-flight (``lint.py``), on by default: before any reader I/O,
  the graph rules over the workflow (Train, with the temporal rules over
  its training reader) or the graph rules and the device shape pass over
  the loaded model (Score, Evaluate, Features). ``customParams.validate:
  false`` skips it, ``validateDevice: false`` skips the device pass,
  ``failOn`` ("error", or "warning"; ``--fail-on``) is the severity that
  stops the run, ``lintSuppress`` mutes rule ids. Its summary is the
  metrics document's ``preflight`` block.
* The plan step (``planner.py``), on by default (``customParams.plan:
  false`` skips it): before any reader I/O, the workflow's plan (its
  measured phase tiers steer the fit) or the loaded model's (attached to
  the scoring engine: CSE, dead-column pruning, the engine tier), from
  the cost database at ``costDb`` (else beside ``compileCacheDir``, else
  in memory). The TMG4xx findings, and TMG405 where a pinned
  ``aggregateColumnar`` contradicts the measured aggregation tier, take
  the pre-flight's ``failOn`` / ``lintSuppress`` path. After a Train the
  stages' fit costs and the phases' observations go into the database,
  which is saved, and the model's full plan is the metrics document's
  ``plan`` block; after a Score the observations go in. A plan or a cost
  recording that fails raises.
* Telemetry (``telemetry.py``), for the run only: a ``traceLocation``,
  ``metricsFormat: "prometheus"``, ``customParams.telemetry`` or a trace
  directory (``customParams.traceDir``, else the ``TMOG_TRACE_DIR``
  environment variable) turns it on, and the run turns it off and drops
  its events and metrics at its end (a ``telemetry.enable()`` made before
  the run stays in force). The run is a ``run:<type>`` span around
  ``run:preflight`` and ``run:plan``; one ``CollectingRunListener``
  collects its events, and its summary and the metrics registry are the
  document's ``telemetry`` and ``telemetryMetrics`` blocks. The trace is
  written to ``traceLocation`` (Chrome trace-event JSON) and as a shard
  into the trace directory, also when the run fails (the run's own
  exception is raised after the flush). ``metricsFormat:
  "prometheus"`` writes the registry as Prometheus text with the run
  document's numbers as ``run_*`` gauges. Every document has the ``mfu``
  block (``telemetry.device_cost_stats``: device seconds by phase while
  telemetry is on) and ``peak_rss_mb``.
* The out-of-core knobs (``streamFit``: true, false, or null / "auto" for
  the auto mode; ``streamFitPasses``; ``rssCapMb``) are validated on
  every run and installed for it (``workflow.set_stream_fit``, restored in
  ``finally``); they engage with a directory stream reader
  (``readers.DirectoryStreamReader``) as the training reader. The plan
  step installs the cost database's measured ingest tier for the auto
  mode, and a pinned ``streamFit`` that contradicts it is a TMG405.
* StreamingScore (``OpWorkflowRunner`` StreamingScore, the
  ``StreamingReaders`` analog): a reader with ``stream()`` (the directory
  reader: one batch a new file, decoded on ``pipelineWorkers`` threads)
  or fixed ``batchSize`` slices of ``read_records()``, through
  ``readers.stream_score``. Its keys, validated before anything is read:
  ``batchSize``, ``maxBatches``, ``timeoutS``, ``overlap`` (tri-state),
  ``pipeline`` (false: one worker, no overlap, the per-record Avro
  decode), ``pipelineWorkers``, ``pipelineDepth`` and ``onBatchError``.
* The dead-letter sink: ``quarantineLocation`` (or
  ``customParams.quarantineLocation``) installs a
  ``resilience.Quarantine`` for the run (the previous sink restored at
  its end); unreadable stream files and poison batches land there. Every
  metrics document has the ``resilience`` block (this run's quarantine,
  retry and fault tallies) and the ``pipeline`` block
  (``pipeline.pipeline_stats()``).
* ``OpParams.from_file`` reads JSON, or YAML (``.yaml`` / ``.yml``,
  PyYAML imported only then).
* ``customParams`` are read through the knob registry (``config.py``):
  a malformed value raises a ``ValueError`` naming its key, and every
  metrics document stamps ``effectiveConfig``, each registry knob at its
  supplied or default value, and ``compileCacheDir``.
* ``OpApp`` (``OpApp.scala``): ``main(argv)`` parses ``--run-type``,
  ``--params``, the locations, ``--trace-out``, ``--metrics-format``,
  ``--compile-cache-dir`` (here the cost database's directory when
  ``costDb`` is unset), ``--quarantine-out``, ``--fail-on`` and
  ``--no-validate`` and ``--mesh-devices``, then runs.
* The mesh (``parallel/mesh.py``): ``customParams.meshDevices`` /
  ``meshGridSize`` (``--mesh-devices``) join the world's ranks
  (``multihost.initialize``, from ``torchrun``'s environment) and install
  a run-scoped (data, grid) mesh, the previous one restored at the run's
  end; a request past the world's rank count raises a ``ValueError``.
  ``featureShards`` shards the tree fits' columns over the grid axis
  (engaged when the axis equals it). Every metrics document has the
  ``mesh`` block (``mesh_topology``), Train's the ``process`` block. Only
  the coordinator (rank 0) saves the model and writes the metrics, the
  traces and the scores; every rank waits at a barrier before the run
  returns.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time
from dataclasses import dataclass, field
import logging
from typing import Any, Dict, Optional, Sequence

import torch

from . import config, telemetry
from .models import _hist, _treefit
from .parallel import mesh as _mesh
from .parallel import multihost

logger = logging.getLogger(__name__)

__all__ = ["OpParams", "RunType", "RunnerResult", "OpWorkflowRunner",
           "OpApp"]

def _numeric_custom_param(params: "OpParams", key: str,
                          default: Any = None) -> Any:
    """``customParams[key]`` through the knob registry
    (``config.numeric_param``): the declared cast (an int refuses a float
    that is not whole) and minimum; ``default`` when absent or null. A
    malformed value raises a ``ValueError`` naming the key."""
    return config.numeric_param(params.custom_params, key, default)


def _bool_custom_param(params: "OpParams", key: str,
                       default: Any = None) -> Any:
    """``customParams[key]`` through the knob registry
    (``config.bool_param``): JSON booleans or the strings "true" and
    "false", and "auto" where the knob is declared a tri-state;
    ``default`` when absent or null. Anything else raises a
    ``ValueError`` naming the key."""
    return config.bool_param(params.custom_params, key, default)


def _off(params: "OpParams", key: str) -> bool:
    """A registered gate (``validate``, ``validateDevice``, ``plan``)
    switched off: false, 0 or "false", as the JAX runner reads them;
    absent means on."""
    v = config.raw_param(params.custom_params, key, True)
    return v in (False, 0) or str(v).lower() == "false"


def _streaming_knobs(params: "OpParams") -> Dict[str, Any]:
    """StreamingScore's ``customParams``, each validated through the knob
    registry (a malformed value raises a ``ValueError`` naming its key):
    ``batchSize`` (default 1,024), ``maxBatches``, ``timeoutS``,
    ``overlap`` (true, false or "auto", the default), ``pipeline``
    (default true), ``pipelineWorkers``, ``pipelineDepth`` and
    ``onBatchError`` ("quarantine" or "raise"; null follows the sink)."""
    from . import resilience
    on_error = config.raw_param(params.custom_params, "onBatchError")
    try:
        resilience.resolve_on_error(on_error)
    except ValueError:
        raise ValueError("customParams.onBatchError must be 'quarantine' "
                         f"or 'raise', got {on_error!r}") from None
    return {"batchSize": _numeric_custom_param(params, "batchSize", 1024),
            "maxBatches": _numeric_custom_param(params, "maxBatches"),
            "timeoutS": _numeric_custom_param(params, "timeoutS"),
            "overlap": _bool_custom_param(params, "overlap", "auto"),
            "pipeline": _bool_custom_param(params, "pipeline", True),
            "pipelineWorkers": _numeric_custom_param(params,
                                                     "pipelineWorkers"),
            "pipelineDepth": _numeric_custom_param(params, "pipelineDepth"),
            "onBatchError": on_error}


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
    #: Chrome trace-event JSON sink; setting it turns telemetry on
    trace_location: Optional[str] = None
    #: metrics sink format: "json" (the run document) or "prometheus"
    #: (the telemetry registry in text exposition, with the run
    #: document's numbers as ``run_*`` gauges); "prometheus" turns
    #: telemetry on
    metrics_format: str = "json"
    #: the dead-letter sink (JSONL, ``resilience.Quarantine``): unreadable
    #: stream files and poison batches land here with a reason; installed
    #: for the run
    quarantine_location: Optional[str] = None
    custom_params: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_file(path: str) -> "OpParams":
        """Parameters from a JSON file, or a YAML one (``.yaml`` /
        ``.yml``, read by PyYAML, imported only then), with the JAX
        package's keys."""
        with open(path) as fh:
            if path.endswith((".yaml", ".yml")):
                import yaml
                doc = yaml.safe_load(fh)
            else:
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

    def telemetry_requested(self) -> bool:
        """True when this config asks for run telemetry (a trace sink,
        Prometheus metrics, or ``customParams.telemetry``)."""
        return bool(self.trace_location
                    or self.metrics_format == "prometheus"
                    or config.raw_param(self.custom_params, "telemetry"))

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
        """Raise for a metrics format that is neither "json" nor
        "prometheus"."""
        if self.metrics_format not in ("json", "prometheus"):
            raise ValueError(f"metricsFormat must be 'json' or "
                             f"'prometheus', got {self.metrics_format!r}")


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
        #: the last run's pre-flight summary and plan (metrics blocks)
        self._last_preflight: Optional[Dict[str, Any]] = None
        self._last_plan: Optional[Dict[str, Any]] = None
        #: the cost database of the run's plan step
        self._plan_db = None

    @staticmethod
    def _write_metrics(location: Optional[str], doc: Dict[str, Any],
                       fmt: str = "json") -> None:
        """The metrics sink, written to a sibling temp file and moved in
        by ``os.replace`` (a kill mid-write never leaves a truncated
        file). ``fmt="prometheus"`` writes the telemetry registry in text
        exposition with the document's numeric scalars as ``run_*``
        gauges; the default writes the document as JSON."""
        if not location or not multihost.is_coordinator():
            return
        os.makedirs(os.path.dirname(location) or ".", exist_ok=True)
        tmp = location + ".tmp"
        with open(tmp, "w") as fh:
            if fmt == "prometheus":
                extra = {f"run_{k}": float(v) for k, v in doc.items()
                         if isinstance(v, (int, float))
                         and not isinstance(v, bool)}
                fh.write(telemetry.render_prometheus(extra))
            else:
                json.dump(doc, fh, indent=1, default=str)
        os.replace(tmp, location)

    @staticmethod
    def _shard_role(run_type: str) -> str:
        """This run's row name in merged traces: an explicit
        ``TMOG_TRACE_ROLE`` wins, else the run type."""
        role = telemetry.trace_role()
        return role if role != "proc" else f"run-{run_type.lower()}"

    @classmethod
    def _write_traces(cls, params: OpParams, trace_dir: Optional[str],
                      run_type: str) -> None:
        if not multihost.is_coordinator():
            return
        if params.trace_location:
            telemetry.write_trace(params.trace_location)
        if trace_dir:
            telemetry.write_trace_shard(trace_dir,
                                        role=cls._shard_role(run_type))

    def run(self, run_type: str, params: Optional[OpParams] = None
            ) -> RunnerResult:
        params = params or OpParams()
        if run_type not in RunType.ALL:
            raise ValueError(f"Unknown run type {run_type!r}; expected one "
                             f"of {RunType.ALL}")
        params.check_ported()
        # a trace directory (customParams.traceDir, else TMOG_TRACE_DIR)
        # asks the run to record spans and drop one shard there
        trace_dir = (config.raw_param(params.custom_params, "traceDir")
                     or os.environ.get(telemetry.TMOG_TRACE_DIR))
        if trace_dir is not None and not isinstance(trace_dir, str):
            raise ValueError("customParams.traceDir must be a path "
                             f"string, got {trace_dir!r}")
        # the temporal tier's run-scoped knobs (docs/readers.md), all
        # validated before any is installed: a malformed value names its
        # key, and no half-installed configuration outlives the run
        from . import temporal
        knobs = dict(
            columnar=_bool_custom_param(params, "aggregateColumnar"),
            join_partitions=_numeric_custom_param(params, "joinPartitions"),
            join_table_max_rows=_numeric_custom_param(params,
                                                      "joinTableMaxRows"))
        # the out-of-core knobs: streamFit (true, false, or null / "auto"
        # for the auto mode), the directory passes and the memory cap;
        # they engage with a directory stream reader
        stream = _bool_custom_param(params, "streamFit")
        stream_knobs = dict(
            stream=None if stream == "auto" else stream,
            passes=_numeric_custom_param(params, "streamFitPasses"),
            rss_cap_mb=_numeric_custom_param(params, "rssCapMb"))
        qloc = (params.quarantine_location
                or params.custom_params.get("quarantineLocation"))  # lint: knob — a sink path, not a knob
        if qloc is not None and not isinstance(qloc, str):
            raise ValueError("quarantineLocation must be a path string, "
                             f"got {qloc!r}")
        # the run-scoped mesh (meshDevices / meshGridSize) and column
        # shards: validated, and the ranks joined, before anything runs
        mesh_devices = _numeric_custom_param(params, "meshDevices")
        mesh_grid = _numeric_custom_param(params, "meshGridSize")
        feature_shards = _numeric_custom_param(params, "featureShards")
        run_mesh = None
        if mesh_devices is not None or mesh_grid is not None:
            multihost.initialize()
            run_mesh = _mesh.make_mesh(  # lint: explicit-mesh — the run-scoped meshDevices/meshGridSize override is the sanctioned explicit construction
                n_devices=mesh_devices, grid_axis=mesh_grid)
        # run-scoped telemetry: on for this run only, unless it was on
        # before the run
        run_scoped = False
        if (params.telemetry_requested() or trace_dir) \
                and not telemetry.enabled():
            telemetry.enable()
            run_scoped = True
        prev_shards = (_treefit.set_feature_shards(feature_shards)
                       if feature_shards is not None else None)
        prev_mesh = (_mesh.set_process_mesh(run_mesh)
                     if run_mesh is not None else None)
        try:
            result = self._run(run_type, params, knobs, stream_knobs, qloc,
                               trace_dir)
        finally:
            if run_mesh is not None:
                _mesh.set_process_mesh(prev_mesh)
            if prev_shards is not None:
                _treefit.set_feature_shards(prev_shards)
            if run_scoped:
                telemetry.disable()
                telemetry.reset(keep_listeners=True)
        # every rank leaves together: the coordinator's writes are done
        multihost.barrier()
        return result

    def _run(self, run_type: str, params: OpParams, knobs: Dict[str, Any],
             stream_knobs: Dict[str, Any], qloc: Optional[str],
             trace_dir: Optional[str]) -> RunnerResult:
        """One run with the temporal ``knobs``, the out-of-core
        ``stream_knobs`` and the dead-letter sink ``qloc`` installed for
        it (each restored at its end)."""
        from . import pipeline, resilience, temporal, workflow
        # one collecting listener a run (OpSparkListener's AppMetrics)
        collector = None
        if telemetry.enabled():
            collector = telemetry.add_listener(
                telemetry.CollectingRunListener())
        launches = dict(_hist.KERNEL_LAUNCHES)
        self._last_preflight = None
        self._last_plan = None
        self._plan_db = None
        # the tallies are process-wide; the document reports this run's
        res_before = resilience.resilience_stats()
        prev_sink = resilience.set_quarantine(qloc) if qloc else None
        prev = temporal.set_run_defaults(**knobs)
        prev_stream = workflow.set_stream_fit(**stream_knobs)
        t0 = time.perf_counter()
        telemetry.emit("run_start", run_type=run_type)
        try:
            with telemetry.span(f"run:{run_type}"):
                result = self._execute(run_type, params, t0)
        except BaseException as e:  # lint: broad-except — flushed and re-raised, nothing swallowed
            # a failed run is the one whose trace is wanted most: flush the
            # spans recorded so far, then raise the run's own exception
            # (a flush that fails is noted on it)
            if params.trace_location or trace_dir:
                try:
                    self._write_traces(params, trace_dir, run_type)
                except Exception as flush_err:  # lint: broad-except — best-effort crash trace, noted on the run's own error
                    logger.exception("trace write after a failed run")
                    e.add_note(f"the trace flush failed too: "
                               f"{flush_err!r}")
            raise
        finally:
            telemetry.emit("run_end", run_type=run_type,
                           seconds=time.perf_counter() - t0)
            if collector is not None:
                telemetry.remove_listener(collector)
            temporal.set_run_defaults(**prev)
            workflow.set_stream_fit(**prev_stream)
            if qloc:
                resilience.set_quarantine(prev_sink)
        # the temporal tier's tallies (columnar and row-wise aggregates,
        # joins, spilled rows): zeros on runs that never touch it
        result.metrics["temporal"] = temporal.temporal_stats()
        # this run's quarantines, retries and injected faults, and the
        # input pipeline's tallies (converged prefetch depth, workers,
        # buffer reuse; process-wide, as in the JAX package)
        result.metrics["resilience"] = {
            k: v - res_before.get(k, 0)
            for k, v in resilience.resilience_stats().items()}
        result.metrics["pipeline"] = pipeline.pipeline_stats()
        # the cost database's directory (--compile-cache-dir), and every
        # registry knob at its supplied or default value: what config
        # produced this result
        cache_dir = config.raw_param(params.custom_params, "compileCacheDir")
        result.metrics["compileCacheDir"] = (str(cache_dir) if cache_dir
                                             else None)
        result.metrics["effectiveConfig"] = config.effective_config(
            params.custom_params)
        # the pre-flight's verdict and the plan the run followed (None:
        # switched off for the run)
        result.metrics["preflight"] = self._last_preflight
        result.metrics["plan"] = self._last_plan
        # the mesh every heavy phase ran on
        result.metrics["mesh"] = _mesh.mesh_topology()
        # the tree engine's kernel launches of this run, per kernel
        result.metrics["trees"] = {"launches": {
            k: v - launches[k] for k, v in _hist.KERNEL_LAUNCHES.items()}}
        # the program bank's tallies (aot.py): zeros on runs that never
        # touch the serving tier
        from . import aot, lifecycle, server
        result.metrics["aot"] = aot.aot_stats()
        # the model server's and the model lifecycle's tallies (requests,
        # merged dispatches, bank hits; registry traffic, rollouts, drift
        # windows): zeros on runs that never serve
        result.metrics["server"] = server.server_stats()
        result.metrics["lifecycle"] = lifecycle.lifecycle_stats()
        # the operations tier's tallies (retrain triggers and jobs; worker
        # spawns, routed requests and failovers; workload records, replay
        # and parity): zeros on runs that never touch it
        from . import continual, fleet, workload
        result.metrics["continual"] = continual.continual_stats()
        result.metrics["fleet"] = fleet.fleet_stats()
        result.metrics["workload"] = workload.workload_stats()
        # device seconds and FLOPs by phase (process-wide, as in the JAX
        # package; recorded while telemetry is on)
        result.metrics["mfu"] = telemetry.device_cost_stats()
        result.metrics["peak_rss_mb"] = telemetry.peak_rss_mb()
        if collector is not None:
            result.metrics["telemetry"] = collector.summary()
            result.metrics["telemetryMetrics"] = telemetry.metrics_json()
        self._write_metrics(params.metrics_location, result.metrics,
                            fmt=params.metrics_format)
        self._write_traces(params, trace_dir, run_type)
        return result

    # -- the pre-flight (lint.py), on by default ---------------------------
    def _preflight(self, params: OpParams, workflow=None, model=None,
                   reader=None) -> Optional[Dict[str, Any]]:
        """The static pre-flight before any reader I/O: the graph rules
        over an untrained workflow (with the temporal rules over
        ``reader``), or the graph rules and the device pass over a loaded
        model. Returns the summary ({"findings", "failOn", and a count
        per severity}); raises ``lint.LintError`` at ``failOn``."""
        from . import lint
        if _off(params, "validate"):
            return None
        fail_on = str(config.raw_param(params.custom_params, "failOn",
                                       "error")).lower()
        suppress = config.raw_param(params.custom_params, "lintSuppress", ())
        with telemetry.span("run:preflight"):
            if workflow is not None:
                findings = lint.check_workflow(workflow, suppress=suppress,
                                               reader=reader)
            else:
                findings = lint.check_model(
                    model, device=not _off(params, "validateDevice"),
                    suppress=suppress, target=self.device)
        lint.emit_findings(findings, "pre-flight")
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.severity] = counts.get(f.severity, 0) + 1
        summary = {"findings": len(findings), "failOn": fail_on, **counts}
        lint.enforce(findings, fail_on=fail_on)
        self._last_preflight = summary
        return summary

    # -- the plan (planner.py), on by default ------------------------------
    @staticmethod
    def _cost_db_path(params: OpParams) -> Optional[str]:
        """``customParams.costDb``, else the database beside
        ``compileCacheDir``, else None (an in-memory database: the static
        estimates still make a plan)."""
        from . import planner
        db = config.raw_param(params.custom_params, "costDb")
        if db:
            return str(db)
        return planner.default_cost_db_path(
            config.raw_param(params.custom_params, "compileCacheDir"))

    def _plan_step(self, params: OpParams, workflow=None, model=None):
        """The plan before any reader I/O, installed for the run: the
        workflow's (``Workflow.set_plan``) or the loaded model's
        (``attach_plan``). Its findings take the pre-flight's ``failOn``
        and ``lintSuppress``; a plan that fails to build raises."""
        from . import lint, planner, temporal
        if _off(params, "plan"):
            # a reused workflow must not follow a previous run's plan
            # while this run stamps plan: null
            if workflow is not None:
                workflow.set_plan(None)
            return None
        fail_on = str(config.raw_param(params.custom_params, "failOn",
                                       "error")).lower()
        suppress = config.raw_param(params.custom_params, "lintSuppress", ())
        db = planner.CostDatabase.load(self._cost_db_path(params))
        with telemetry.span("run:plan"):
            if model is not None:
                plan = planner.plan_model(model, cost_db=db)
                model.attach_plan(plan)
            else:
                plan = planner.plan_workflow(workflow, cost_db=db)
                workflow.set_plan(plan)
        findings = list(plan.findings())
        # the measured ingest route steers the streamed fit's auto mode
        # (streamFit null) for this run (the run restores the knobs); a
        # pinned streamFit wins, and a contradiction is a TMG405
        ingest_tier = planner.ingest_route_tier(db)
        if ingest_tier is not None:
            from . import workflow as _workflow
            _workflow.set_stream_fit(ingest_hint=ingest_tier)
            forced_sf = _bool_custom_param(params, "streamFit")
            if (forced_sf is True and ingest_tier == "materialize") \
                    or (forced_sf is False and ingest_tier == "stream"):
                findings.append(lint.Finding(
                    "TMG405",
                    f"streamFit={str(forced_sf).lower()} is pinned but "
                    f"the cost database measured the {ingest_tier} ingest "
                    "tier faster (phase:workflow.ingest) — the knob wins; "
                    "drop it to let the auto-route follow the "
                    "measurement"))
        # the measured aggregation route steers the "auto" route for this
        # run; a pinned aggregateColumnar wins, and a contradiction is a
        # TMG405 advisory
        agg_tier = planner.aggregate_route_tier(db)
        if agg_tier is not None:
            temporal.set_aggregate_tier_hint(agg_tier)
            forced = _bool_custom_param(params, "aggregateColumnar")
            if (forced is True and agg_tier == "rowwise") \
                    or (forced is False and agg_tier == "columnar"):
                findings.append(lint.Finding(
                    "TMG405",
                    f"aggregateColumnar={str(forced).lower()} is pinned "
                    f"but the cost database measured the {agg_tier} tier "
                    "faster (phase:temporal.route_aggregate) — the knob "
                    "wins; drop it to let the auto-route follow the "
                    "measurement"))
        findings = lint._apply_suppress(findings, suppress)
        lint.emit_findings(findings, "plan")
        lint.enforce(findings, fail_on=fail_on)
        self._plan_db = db
        self._last_plan = plan.to_json()
        return plan

    def _record_plan_costs(self, model) -> None:
        """After a fresh fit: the stages' fit costs and the phases'
        observations into the cost database, saved atomically, and the
        fitted model's full plan (pruning, CSE, tiers) as the run's
        ``plan`` block."""
        from . import planner
        db = self._plan_db
        planner.record_fit_costs(model, db)
        planner.drain_phase_observations(db)
        db.save()
        self._last_plan = planner.plan_model(model, cost_db=db).to_json()

    def _record_score_costs(self) -> None:
        """After a Score: the phases' observations into the cost database,
        saved. A corrupt database is left for a Train to regenerate, so
        its TMG404 finding stays until then."""
        from . import planner
        db = self._plan_db
        if db is None or db.corrupt:
            return
        planner.drain_phase_observations(db)
        db.save()

    def _read(self, reader, what: str):
        """The reader's records. As in the JAX package's runner, Score,
        Evaluate and Features read ``read_records()`` even from an
        aggregating reader: they see its events, not its keys (ROADMAP
        C)."""
        if reader is None:
            raise ValueError(f"{what} needs a reader")
        return reader.read_records()

    def _stream_score(self, model, params: OpParams,
                      knobs: Dict[str, Any]) -> Dict[str, Any]:
        """StreamingScore: the scoring reader's batches through
        ``readers.stream_score``, each batch written to the sink and
        dropped (peak memory is a batch, not the data). A reader with
        ``stream()`` gives one batch a file; any other is sliced into
        ``batchSize`` records. Returns the run's metrics."""
        from . import pipeline, resilience
        from .readers import stream_score
        reader = self.scoring_reader
        if reader is None:
            raise ValueError("StreamingScore needs a scoring reader")
        workers, depth = knobs["pipelineWorkers"], knobs["pipelineDepth"]
        overlap = knobs["overlap"]
        restore_columnar = None
        if not knobs["pipeline"]:
            # the run's kill switch, as TMOG_PIPELINE=0: one worker, no
            # overlap, the per-record decode (the reader's flag restored
            # at the end)
            workers, depth, overlap = 1, 1, False
            if hasattr(reader, "columnar"):
                restore_columnar = bool(reader.columnar)
                reader.columnar = False
        rows = n_batches = 0
        q_before = resilience.resilience_stats()
        pipe_before = pipeline.pipeline_stats()
        try:
            if hasattr(reader, "stream"):
                batch: Any = "per-file"
                batches = reader.stream(
                    max_batches=knobs["maxBatches"],
                    timeout_s=knobs["timeoutS"],
                    workers=pipeline.resolve_workers(workers))
            else:
                data = reader.read_records()
                batch = knobs["batchSize"]
                batches = (data[i:i + batch]
                           for i in range(0, len(data), batch))
            sink = (_make_sink(params.write_location)
                    if params.write_location else None)
            try:
                for scored in stream_score(
                        model, batches, overlap=overlap,
                        on_error=knobs["onBatchError"], device=self.device,
                        workers=workers, prefetch=depth):
                    rows += scored.n_rows
                    n_batches += 1
                    if sink is not None:
                        sink.write(scored)
                if sink is not None and n_batches == 0:
                    # header-only output, as Score writes on empty input
                    sink.write_header(
                        [f.name for f in model.result_features])
            finally:
                if sink is not None:
                    sink.close()
        finally:
            if restore_columnar is not None:
                reader.columnar = restore_columnar
        self._record_score_costs()
        q_after = resilience.resilience_stats()
        pipe_after = pipeline.pipeline_stats()
        # the last_* tallies are this run's only when it streamed through
        # the pipeline
        piped = pipe_after["streams"] > pipe_before["streams"]
        return {
            "rowsScored": rows, "batches": n_batches, "batchSize": batch,
            "overlap": overlap,
            "pipelineWorkers": pipe_after["last_workers"] if piped else None,
            "prefetchDepth": (pipe_after["last_prefetch_depth"]
                              if piped else None),
            "pipelineStarvations": (pipe_after["starvations"]
                                    - pipe_before["starvations"]),
            "bufferReuses": (pipe_after["buffer_reuses"]
                             - pipe_before["buffer_reuses"]),
            "quarantinedBatches": (q_after["quarantined_batches"]
                                   - q_before["quarantined_batches"]),
            "quarantinedFiles": (q_after["quarantined_files"]
                                 - q_before["quarantined_files"])}

    def _execute(self, run_type: str, params: OpParams,
                 t0: float) -> RunnerResult:
        if run_type == RunType.TRAIN:
            params.apply_to_workflow(self.workflow)
            # a mis-wired DAG or a leaky cutoff stops here, before the
            # reader reads a byte
            self._preflight(params, workflow=self.workflow,
                            reader=self.training_reader)
            wf_plan = self._plan_step(params, workflow=self.workflow)
            if self.training_reader is not None:
                self.workflow.set_reader(self.training_reader)
            model = self.workflow.train(device=self.device,
                                        dtype=self.dtype)
            if wf_plan is not None:
                self._record_plan_costs(model)
            # every rank trained the same model; one writes it
            if params.model_location and multihost.is_coordinator():
                model.save(params.model_location, overwrite=True)
            metrics = model.summary()
            metrics["appSeconds"] = round(time.perf_counter() - t0, 3)
            metrics["process"] = multihost.process_summary()
            # the RawFeatureFilter's verdict (None: no filter configured)
            metrics["rawFeatureFilter"] = (
                model.rff_results.summary()
                if model.rff_results is not None else None)
            return RunnerResult(run_type, metrics=metrics,
                                model_location=params.model_location,
                                model=model)
        if run_type == RunType.STREAMING_SCORE:
            # the keys are validated before the model is loaded or
            # anything is read: a malformed value names its key
            knobs = _streaming_knobs(params)

        from .workflow import WorkflowModel
        if params.model_location is None:
            raise ValueError(f"{run_type} requires modelLocation")
        model = WorkflowModel.load(params.model_location)
        # the graph and device pre-flight and the plan, before the
        # reader does any I/O
        self._preflight(params, model=model)
        self._plan_step(params, model=model)

        if run_type == RunType.SCORE:
            data = self._read(self.scoring_reader, "Score")
            scores = model.score(data, device=self.device)
            if params.write_location:
                _write_store(scores, params.write_location)
            self._record_score_costs()
            metrics = {"rowsScored": scores.n_rows,
                       "appSeconds": round(time.perf_counter() - t0, 3)}
            return RunnerResult(run_type, metrics=metrics, scores=scores,
                                model=model)

        if run_type == RunType.STREAMING_SCORE:
            metrics = self._stream_score(model, params, knobs)
            metrics["appSeconds"] = round(time.perf_counter() - t0, 3)
            return RunnerResult(run_type, metrics=metrics, model=model)

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


class _NullSink:
    """The sink of a rank other than the coordinator: every rank scores
    the same rows, one writes them."""

    def write_header(self, names) -> None:
        pass

    def write(self, store) -> None:
        pass

    def close(self) -> None:
        pass


def _make_sink(path: str):
    """The incremental sink for ``path``: an Avro container where the path
    ends in ``.avro`` (the reference's saveScores), else CSV; nothing on a
    rank other than the coordinator."""
    if not multihost.is_coordinator():
        return _NullSink()
    return _AvroSink(path) if path.endswith(".avro") else _CsvSink(path)


def _write_store(store, path: str) -> None:
    """One store to ``path`` (:func:`_make_sink`)."""
    sink = _make_sink(path)
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
        ap.add_argument("--trace-out", metavar="PATH",
                        help="turn telemetry on and write a Chrome "
                             "trace-event JSON here (Perfetto-loadable)")
        ap.add_argument("--metrics-format", choices=("json", "prometheus"),
                        help="metrics sink format; prometheus turns "
                             "telemetry on and writes the registry in "
                             "text exposition format")
        ap.add_argument("--compile-cache-dir", metavar="DIR",
                        help="customParams.compileCacheDir: the cost "
                             "database's directory when costDb is unset "
                             "(nothing is compiled ahead in this package)")
        ap.add_argument("--mesh-devices", type=int, metavar="N",
                        help="ranks in the run's (data, grid) mesh "
                             "(customParams.meshDevices); start N ranks "
                             "with torchrun --nproc-per-node N")
        ap.add_argument("--quarantine-out", metavar="PATH",
                        help="dead-letter sink (JSONL): unreadable stream "
                             "files and failed scoring batches land here "
                             "with a reason")
        ap.add_argument("--fail-on", choices=("error", "warning"),
                        help="pre-flight gating severity (lint.py): "
                             "'error' (default) stops only on errors, "
                             "'warning' on warnings too")
        ap.add_argument("--no-validate", action="store_true",
                        help="skip the on-by-default pre-flight "
                             "(customParams.validate: false)")
        ap.add_argument("--quiet", action="store_true",
                        help="suppress INFO progress logging")
        args = ap.parse_args(argv)
        if not args.quiet:
            import logging
            logging.basicConfig(level=logging.INFO)
        params = (OpParams.from_file(args.params) if args.params
                  else OpParams())
        if args.mesh_devices is not None:
            params.custom_params["meshDevices"] = args.mesh_devices
        for key in ("model_location", "write_location", "metrics_location"):
            if getattr(args, key):
                setattr(params, key, getattr(args, key))
        if args.trace_out:
            params.trace_location = args.trace_out
        if args.metrics_format:
            params.metrics_format = args.metrics_format
        if args.compile_cache_dir:
            params.custom_params["compileCacheDir"] = args.compile_cache_dir
        if args.quarantine_out:
            params.quarantine_location = args.quarantine_out
        if args.fail_on:
            params.custom_params["failOn"] = args.fail_on
        if args.no_validate:
            params.custom_params["validate"] = False
        return self.runner(params).run(args.run_type, params)
