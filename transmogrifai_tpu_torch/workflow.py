"""Workflow runtime — DAG fitting, scoring and persistence; the port of
``transmogrifai_tpu/workflow.py``.

* ``Workflow.set_result_features(...)`` reconstructs the stage DAG from the
  requested outputs; ``train()`` folds over its layers deepest-first: fit
  each layer's estimators on the train split, evaluate ``has_test_eval``
  models on the holdout, then transform both splits with the fitted layer
  (``FitStagesUtil.fitAndTransformLayer``).
* ``WorkflowModel`` holds the fitted stages keyed by estimator uid. It
  scores by replaying the transform layers, or, from
  ``scoring.SCORING_MIN_ROWS`` rows, through the batched scoring engine
  (``scoring.ScoringEngine``); it saves and loads in the JAX package's
  format (``model_io``).
* Each layer's opted-in estimators fit from one statistics pass over the
  train split (``_layer_stats_pass``, ``fitstats.py``), and its
  vectorizers transform with one upload and one pull on the card from
  ``FUSE_MIN_ROWS`` rows (``apply_layer``); the train's sufficient
  statistics are saved with the model (``WorkflowModel.fit_stats``) and
  warm-start a later train (``with_warm_fit_stats``).
* Warm starts (``Workflow.with_model_stages``) substitute fitted stages by
  uid; ``with_checkpointing`` saves the partial model after every layer
  that fitted something, and ``fit(resume_from=)`` resumes from it.
* ``with_raw_feature_filter`` runs the RawFeatureFilter on the raw store
  before any fit and prunes the blacklisted raw features from a copy of
  the DAG; ``with_workflow_cv`` re-fits the label-aware feature stages
  inside every CV fold (``graph.cut_dag``), so the selector's validation
  metrics see no label leakage from feature engineering.
* The out-of-core fit (``set_stream_fit``; the runner's ``streamFit``,
  ``streamFitPasses`` and ``rssCapMb``): from a
  ``readers.DirectoryStreamReader`` the raw store is never materialized.
  The stream folds every numeric raw column's moments on the device
  (``fitstats.StreamingMomentFold``, bitwise a materialized device pass)
  and keeps a seeded bounded subsample (``pipeline.SeededRowSample``,
  ``STREAM_SAMPLE_ROWS`` rows) that the rest of the fit runs on; every
  statistics pass takes the streamed moments for those columns. The
  result does not depend on the pass count or the reader's workers.
* The pre-flight (``Workflow.validate``, ``WorkflowModel.validate``:
  ``lint.py``) finds mis-wired graphs before any data is read. A
  ``planner.ExecutionPlan`` steers a fit (``Workflow.set_plan``: the
  statistics pass's and the layer transform's measured tiers) and the
  scoring engine (``WorkflowModel.attach_plan``: CSE, dead-column
  pruning, the engine tier); a tier changes cost, never a result.

Device stages (``uses_device``) run on ``device``: the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import copy as _copy
import logging
import os
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from . import telemetry
from .columns import ColumnStore
from .features import Feature, copy_dag
from .graph import StagesDAG, compute_dag, cut_dag
from .models.base import resolve_device
from .stages.base import Estimator, FittedModel, Transformer
from .stages.generator import FeatureGeneratorStage
from .utils import uid as uid_mod

__all__ = ["Workflow", "WorkflowModel", "WorkflowError"]

logger = logging.getLogger(__name__)


def _is_coordinator() -> bool:
    """Shared-filesystem writes (checkpoints) happen on one rank only:
    every rank of a mesh computes identical state."""
    from .parallel.multihost import is_coordinator
    return is_coordinator()


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


#: rows from which a layer's vectorizers transform with one upload and
#: one pull on the card (``apply_layer``), and the fused statistics pass
#: folds its moments on the card (``fitstats.LayerStatsPlan``)
FUSE_MIN_ROWS = 20_000

#: byte alignment of each block in the fused transform's staging buffer
_STAGE_ALIGN = 64

#: the out-of-core fit's run-scoped knobs (the runner installs them with
#: :func:`set_stream_fit` and restores them in ``finally``). ``STREAM_FIT``
#: is tri-state: None streams when the input is a directory stream reader
#: (unless the planner's measured ingest tier says materializing is
#: cheaper and no memory cap is declared), True forces streaming, False
#: the materialized path.
STREAM_FIT: Optional[bool] = None

#: directory passes of the streamed ingest: 1 folds the statistics and
#: gathers the subsample in one pass; 2 folds in pass 1 and gathers in
#: pass 2 (a reader ``rescan``). The results are the same.
STREAM_FIT_PASSES = 2

#: decode workers of the streamed ingest: one, since each worker holds a
#: decoded file in flight (host memory the stream exists to bound) and
#: the per-record decode holds the GIL. The batches arrive in file order
#: at any count, so the model does not depend on it.
STREAM_FIT_WORKERS = 1

#: the streamed fit's bounded working set: the subsample's rows (trees,
#: quantiles and top-K statistics see at most this many)
STREAM_SAMPLE_ROWS = int(os.environ.get("TMOG_STREAM_SAMPLE_ROWS",
                                        262_144))

#: the planner's measured ingest tier ("stream" / "materialize" / None),
#: read only by the ``STREAM_FIT is None`` auto mode
_INGEST_TIER_HINT: Optional[str] = None

#: the declared host-memory budget in MB (``customParams.rssCapMb``): with
#: one, the auto mode streams a directory reader whatever the tier hint
#: (the hint optimizes time, the cap protects the heap)
STREAM_RSS_CAP_MB: Optional[float] = None

_KEEP = object()


def set_stream_fit(stream=_KEEP, passes=_KEEP, sample_rows=_KEEP,
                   ingest_hint=_KEEP, rss_cap_mb=_KEEP) -> Dict[str, Any]:
    """Install run-scoped out-of-core knobs; returns the previous values
    (same keyword names) for the caller to restore in ``finally``."""
    global STREAM_FIT, STREAM_FIT_PASSES, STREAM_SAMPLE_ROWS, \
        _INGEST_TIER_HINT, STREAM_RSS_CAP_MB
    prev: Dict[str, Any] = {
        "stream": STREAM_FIT, "passes": STREAM_FIT_PASSES,
        "sample_rows": STREAM_SAMPLE_ROWS,
        "ingest_hint": _INGEST_TIER_HINT,
        "rss_cap_mb": STREAM_RSS_CAP_MB}
    if stream is not _KEEP:
        STREAM_FIT = None if stream is None else bool(stream)
    if passes is not _KEEP and passes is not None:
        STREAM_FIT_PASSES = max(1, int(passes))
    if sample_rows is not _KEEP and sample_rows is not None:
        STREAM_SAMPLE_ROWS = max(1, int(sample_rows))
    if ingest_hint is not _KEEP:
        _INGEST_TIER_HINT = ingest_hint
    if rss_cap_mb is not _KEEP:
        STREAM_RSS_CAP_MB = (None if rss_cap_mb is None
                             else float(rss_cap_mb))
    return prev


def _stream_fold_columns(store: ColumnStore) -> List[str]:
    """The raw columns the streamed fold tracks: one-dimensional numeric
    or boolean values with a mask."""
    out = []
    for nm in store.names():
        col = store[nm]
        vals = getattr(col, "values", None)
        if isinstance(vals, np.ndarray) and vals.ndim == 1 \
                and isinstance(getattr(col, "mask", None), np.ndarray) \
                and (np.issubdtype(vals.dtype, np.number)
                     or vals.dtype == bool):
            out.append(nm)
    return out


def _fused_vectors(vecs: Sequence[Transformer], store: ColumnStore, dev,
                   seconds: Dict[str, float]
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The vectors of ``vecs`` (VectorizerModels with ``device_math``) by
    one device program: each model's ``host_prepare`` (canonicalized),
    every block staged in one host buffer (pinned on the card) and
    uploaded by one copy, each ``device_compute`` on ``dev``, and every
    output pulled by one copy into one host buffer and split. The same
    torch operations on the same inputs as ``VectorizerModel.
    transform_columns``, so the vectors are bitwise equal to the
    per-model path's. ``seconds`` gets each model's ``host_prepare``
    seconds plus an equal share of the upload, compute and pull. Returns
    {output name: VectorColumn} and the layer's ``info``."""
    from .columns import VectorColumn
    from .ops.vectorizer_base import canonicalize_prepared
    from .types.feature_types import OPVector
    preps = []
    for m in vecs:
        t0 = time.perf_counter()
        preps.append(canonicalize_prepared(m.host_prepare(store)))
        seconds[m.uid] = seconds.get(m.uid, 0.0) + time.perf_counter() - t0
    t0 = time.perf_counter()
    with telemetry.span("layer:fused_dispatch", rows=store.n_rows,
                        vectorizers=len(vecs)):
        host, outs, size = _fused_dispatch(vecs, preps, dev)
    cols, off = {}, 0
    for m, o in zip(vecs, outs):
        mat = host[off:off + o.numel()].reshape(tuple(o.shape))
        off += o.numel()
        meta = m.vector_metadata()
        assert mat.ndim == 2 and mat.shape[1] == meta.size, \
            (type(m).__name__, mat.shape, meta.size)
        cols[m.output_name] = VectorColumn(OPVector, mat, meta)
    fused_s = time.perf_counter() - t0
    for m in vecs:
        seconds[m.uid] += fused_s / len(vecs)
    return cols, {"vectorizers": len(vecs), "rows": store.n_rows,
                  "seconds": round(fused_s, 4), "uploads": 1, "pulls": 1,
                  "bytesUp": size, "bytesDown": 4 * off}


def _fused_dispatch(vecs, preps, dev):
    """``_fused_vectors``' device half: the blocks staged in one host
    buffer (pinned on the card), one upload, each ``device_compute``, one
    pull. Returns (the pulled host f32 array, the device outputs, the
    staged bytes)."""
    pinned = dev.type == "cuda"
    layout, size = [], 0
    for prep in preps:
        for k, a in prep.items():
            a = np.ascontiguousarray(a)
            layout.append((k, a, size))
            size += -(-a.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
    staged = torch.empty(size, dtype=torch.uint8, pin_memory=pinned)
    view = staged.numpy()
    for _k, a, off in layout:
        view[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    up = staged.to(dev, non_blocking=pinned)
    outs, i = [], 0
    for m, prep in zip(vecs, preps):
        blocks = {}
        for k, a, off in layout[i:i + len(prep)]:
            dt = torch.from_numpy(a[:0]).dtype
            blocks[k] = up[off:off + a.nbytes].view(dt).reshape(a.shape)
        i += len(prep)
        outs.append(m.device_compute(blocks).to(torch.float32))
    flat = torch.cat([o.reshape(-1) for o in outs])
    pulled = torch.empty(flat.numel(), dtype=torch.float32,
                         pin_memory=pinned)
    pulled.copy_(flat, non_blocking=pinned)
    if pinned:
        torch.cuda.current_stream(dev).synchronize()
    return pulled.numpy(), outs, size


def apply_layer(models: Sequence[Transformer], store: ColumnStore, device,
                seconds: Optional[Dict[str, float]] = None,
                fuse: Optional[bool] = None,
                info: Optional[Dict[str, Any]] = None,
                tier: Optional[str] = None) -> ColumnStore:
    """Transform ``store`` by a DAG layer's models on ``device``.

    The layer's VectorizerModels with ``device_math`` transform as one
    device program with one upload and one pull (``_fused_vectors``; the
    port of the JAX package's ``apply_layer_vectorized``) when ``fuse``
    is True, or, when it is None, from ``FUSE_MIN_ROWS`` rows on the
    card; ``tier`` (the planner's measured transform tier, "device" or
    "host") replaces the card condition, never the row floor. The other
    models (and every model otherwise) transform one by one. Both paths
    give bitwise-equal vectors. ``seconds`` accumulates each stage's
    seconds by uid; ``info`` receives the fused program's
    (``_fused_vectors``). From the row floor the layer's seconds feed
    the planner's ``phase:transform`` cost."""
    from .ops.vectorizer_base import VectorizerModel
    dev = torch.device(device)
    vecs = [m for m in models
            if isinstance(m, VectorizerModel) and m.device_math]
    contested = bool(vecs) and store.n_rows >= FUSE_MIN_ROWS
    if fuse is None:
        fuse = contested and (dev.type == "cuda" if tier is None
                              else tier == "device")
    seconds = {} if seconds is None else seconds
    t_layer = time.perf_counter()
    cols: Dict[str, Any] = {}
    if fuse and vecs:
        cols, fused_info = _fused_vectors(vecs, store, dev, seconds)
        if info is not None:
            info.update(fused_info)
    for m in models:
        if m.output_name in cols:
            store = store.with_column(m.output_name, cols[m.output_name])
            continue
        t0 = time.perf_counter()
        store = m.transform(store, **_device_kw(m, device))
        seconds[m.uid] = seconds.get(m.uid, 0.0) \
            + time.perf_counter() - t0
    if contested:
        from . import planner
        planner.observe_phase("transform",
                              "device" if fuse and vecs else "host",
                              time.perf_counter() - t_layer, store.n_rows)
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
        #: a filters.RawFeatureFilter run on the raw store before any fit
        self.raw_feature_filter = None
        #: raw features the last train's filter removed
        self.blacklisted_features: List[Feature] = []
        self._workflow_cv = False
        self._checkpoint_dir: Optional[str] = None
        self._warm_stages: Dict[str, FittedModel] = {}
        #: ``"<layer>:<column>"`` → persisted SufficientStats
        #: (``with_warm_fit_stats``)
        self._warm_fit_stats: Optional[Dict[str, Any]] = None
        #: stage uid → fit/transform timings of the last train
        #: (OpSparkListener StageMetrics analog)
        self._stage_metrics: Dict[str, Dict[str, Any]] = {}
        #: the planner.ExecutionPlan this fit follows (``set_plan``)
        self._exec_plan = None
        #: free-form parameters carried into the model and its saves
        #: (``set_parameters``)
        self.parameters: Dict[str, Any] = {}
        #: the (data, grid) mesh of the heavy phases (``set_mesh``): None
        #: resolves to the process default at train, False forces the
        #: single-process path
        self.mesh = None
        #: the mesh the last train resolved (None: single-process)
        self._active_mesh = None

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

    def with_model_stages(self, model: "WorkflowModel") -> "Workflow":
        """Warm start (OpWorkflow.withModelStages :457-460): the fitted
        stages of ``model`` stand in, by uid, for this workflow's
        estimators, which are then not refit. Estimators the model does not
        hold still fit."""
        self._warm_stages = dict(model.fitted_stages)
        return self

    def with_warm_fit_stats(self, stats) -> "Workflow":
        """Warm-start the fused statistics pass from a previous model's
        sufficient statistics (``"<layer>:<column>"`` →
        ``fitstats.SufficientStats``, as ``fitstats.load_sufficient_stats``
        or ``WorkflowModel.fit_stats`` give them): each layer's moment
        statistics are Chan-merged with the matching entries, so opted-in
        estimators fit over [old window + fresh data] while the scan
        covers the fresh data alone. None or an empty mapping is a cold
        fit; columns without an entry stay fresh-only."""
        self._warm_fit_stats = dict(stats) if stats else None
        return self

    def with_checkpointing(self, directory: str) -> "Workflow":
        """Layer-granular recovery: after every DAG layer that fitted a
        stage, the partial model is saved to ``directory``
        crash-consistently; ``fit(resume_from=directory)`` resumes a
        crashed train from it (FitStagesUtil.scala:134-165)."""
        self._checkpoint_dir = directory
        return self

    def with_workflow_cv(self, enabled: bool = True) -> "Workflow":
        """Leak-free workflow-level cross-validation
        (OpWorkflowCore.withWorkflowCV :104): the DAG's label-aware feature
        stages (``cut_dag``'s *during* set) are re-fit inside every CV fold
        so validation metrics never see label leakage from feature
        engineering."""
        self._workflow_cv = enabled
        return self

    def set_mesh(self, mesh) -> "Workflow":
        """Pin the (data, grid) mesh of this workflow's heavy phases (the
        CV sweep and the refit, tree estimators, the fused statistics
        pass; ``parallel/mesh.py``). None — the default — resolves to
        ``parallel.mesh.process_default_mesh`` at train, so a world of
        several ranks shards by default and one process takes the
        degenerate 1×1 path; ``mesh=False`` forces the single-process
        path on every rank."""
        self.mesh = mesh
        return self

    def set_plan(self, plan) -> "Workflow":
        """Attach a ``planner.ExecutionPlan`` whose measured phase tiers
        this fit follows: the fused statistics pass reads
        ``fitstats_tier`` and the layer transform ``transform_tier`` (a
        tier of None leaves the row-floor and card gate in charge). A
        tier changes cost, never a result. None detaches."""
        self._exec_plan = plan
        return self

    def set_parameters(self, params: Dict[str, Any]) -> "Workflow":
        """Parameters the trained model carries
        (``WorkflowModel.parameters``, saved with it)."""
        self.parameters = dict(params)
        return self

    def validate(self, suppress=()) -> list:
        """The pre-flight graph rules (``lint.check_workflow``: TMG1xx,
        and TMG7xx when a reader is set) before any data is read: a list
        of ``lint.Finding``; gate on it with ``lint.enforce``."""
        from . import lint
        return lint.check_workflow(self, suppress=suppress)

    def _tier(self, which: str) -> Optional[str]:
        plan = self._exec_plan
        return getattr(plan, which) if plan is not None else None

    def with_raw_feature_filter(self, rff) -> "Workflow":
        """Attach a ``filters.RawFeatureFilter`` data-quality gate
        (OpWorkflow.withRawFeatureFilter, OpWorkflow.scala:521-563)."""
        self.raw_feature_filter = rff
        return self

    def fit(self, resume_from: Optional[str] = None, device=None,
            dtype: torch.dtype = torch.float32) -> "WorkflowModel":
        """:meth:`train` with crash recovery: the checkpoint at
        ``resume_from`` (one a previous ``with_checkpointing`` run wrote,
        a swap a crash left half done included) warm-starts this fit, so
        its completed layers are not refit. A missing or unreadable
        checkpoint gives a fresh fit. Checkpointing continues into the
        same directory unless another one is set."""
        if resume_from:
            from .model_io import MODEL_JSON
            if self._checkpoint_dir is None:
                self.with_checkpointing(resume_from)
            partial = None
            if any(os.path.exists(os.path.join(p, MODEL_JSON))
                   for p in (resume_from, f"{resume_from}.tmp",
                             f"{resume_from}.old")):
                try:
                    partial = WorkflowModel.load(resume_from)
                except (OSError, ValueError, KeyError, TypeError):
                    logger.exception("checkpoint at %s is unusable; "
                                     "fitting from scratch", resume_from)
            if partial is not None and partial.fitted_stages:
                from . import resilience
                self.with_model_stages(partial)
                resilience.record_resumed_fit()
                logger.info("resuming fit from %s: %d fitted stage(s) "
                            "warm-start", resume_from,
                            len(partial.fitted_stages))
        return self.train(device=device, dtype=dtype)

    def train(self, device=None,
              dtype: torch.dtype = torch.float32) -> "WorkflowModel":
        """Fit the DAG on ``device`` (default: the card) in ``dtype``."""
        dev = resolve_device(device)
        raw_features = _raw_features_of(self.result_features)
        self._stage_metrics = {}
        self._phase_seconds: Dict[str, float] = {}
        #: the full-stream states of the streamed ingest (injected into
        #: every statistics pass); None on the materialized path
        self._stream_state = None
        data = self._input_data
        if data is None and self._reader is not None:
            if getattr(self._reader, "is_aggregating", False):
                # event-grouped readers own raw-store generation (the
                # group-by-key and the cutoff and window folds):
                # read_records would hand over the events, one row per
                # event instead of one per key
                t0 = time.perf_counter()
                data = self._reader.generate_store(raw_features)
                self._phase_seconds["aggregate"] = time.perf_counter() - t0
            elif self._use_stream_fit():
                data = self._stream_raw_store(raw_features, dev, dtype)
            else:
                t0 = time.perf_counter()
                data = self._reader.read_records()
                self._observe_ingest("materialize",
                                     time.perf_counter() - t0, len(data))
        if data is None:
            raise WorkflowError("No input data: call set_input_store, "
                                "set_input_records or set_reader")
        store = _raw_store(data, raw_features)
        self.blacklisted_features = []
        result_features, rff_results = self.result_features, None
        if self.raw_feature_filter is not None:
            t0 = time.perf_counter()
            store, result_features, rff_results = self._filter(
                store, raw_features)
            self._phase_seconds["rawFeatureFilter"] = \
                time.perf_counter() - t0
        train, test = store, None
        if self.splitter is not None:
            train, test = self.splitter.reserve_split(store)
        dag = compute_dag(result_features)
        self._resolve_mesh(dag)
        #: the graph being fitted (the filter may have copied it); layer
        #: checkpoints record this one
        self._active_result_features = result_features
        t0 = time.perf_counter()
        fitted: Dict[str, FittedModel] = {}
        seconds: Dict[str, float] = {}
        fit_state: Dict[str, Any] = {}
        self._warm_matched = 0
        with telemetry.span("workflow:train", layers=len(dag),
                            rows=train.n_rows,
                            workflow_cv=self._workflow_cv):
            if self._workflow_cv:
                self._fit_dag_workflow_cv(result_features, dag, train,
                                          test, fitted, dev, dtype,
                                          seconds, fit_state)
            else:
                self._fit_dag(dag, train, test, fitted, dev, dtype,
                              seconds, fit_state=fit_state)
        train_time = time.perf_counter() - t0
        if self._warm_fit_stats and not self._warm_matched:
            logger.warning("train: the warm-start sufficient statistics "
                           "matched no layer of this DAG; the refit ran "
                           "over the fresh data alone")
        logger.info("train: %d rows, %d layers in %.2fs%s", train.n_rows,
                    len(dag), train_time,
                    " [workflow-level CV]" if self._workflow_cv else "")
        model = WorkflowModel(result_features, fitted, dag,
                              parameters=self.parameters,
                              train_time_s=train_time,
                              stage_seconds=seconds,
                              stage_metrics=self._stage_metrics,
                              train_rows=train.n_rows,
                              blacklisted_features=self.blacklisted_features,
                              rff_results=rff_results, fit_stats=fit_state)
        model.phase_seconds = dict(self._phase_seconds)
        return model

    def _resolve_mesh(self, dag: StagesDAG) -> None:
        """Resolve the mesh this fit's heavy phases run on: ``self.mesh``
        when set (False: none), else the process default; the degenerate
        1×1 resolves to None (the single-process path). Every model
        selector and tree estimator of the DAG not handed a mesh of its
        own gets it and stays workflow-managed (``_mesh_auto``: a
        retrain re-resolves it)."""
        from .models.selector import ModelSelector
        from .models.trees import _TreeEstimatorBase
        from .parallel.mesh import (mesh_if_multi, mesh_topology,
                                    process_default_mesh)
        if self.mesh is False:
            active = None
        else:
            active = mesh_if_multi(self.mesh if self.mesh is not None
                                   else process_default_mesh())
        self._active_mesh = active
        if active is not None:
            topo = mesh_topology(active)
            telemetry.gauge("mesh.data_axis").set(topo["data"])
            telemetry.gauge("mesh.grid_axis").set(topo["grid"])
            telemetry.emit("mesh", devices=topo["devices"],
                           data=topo["data"], grid=topo["grid"],
                           platform=topo["platform"])
            logger.info("train: mesh of %d rank(s) (data=%d, grid=%d, %s)",
                        topo["devices"], topo["data"], topo["grid"],
                        topo["backend"])
        for layer in dag:
            for stage in layer:
                if not isinstance(stage, (ModelSelector,
                                          _TreeEstimatorBase)):
                    continue
                if getattr(stage, "_mesh_auto", False) \
                        or stage.mesh is None:
                    stage.mesh = active if active is not None else False
                    stage._mesh_auto = True

    # -- the out-of-core ingest (streamFit) ---------------------------------
    def _use_stream_fit(self) -> bool:
        """Stream the ingest? Only a directory stream reader can; an
        explicit ``STREAM_FIT`` wins, a declared ``STREAM_RSS_CAP_MB``
        streams, else the planner's measured tier decides (streaming
        unless it measured materializing cheaper)."""
        from .readers.streaming import DirectoryStreamReader
        if not isinstance(self._reader, DirectoryStreamReader):
            return False
        if STREAM_FIT is not None:
            return bool(STREAM_FIT)
        if STREAM_RSS_CAP_MB is not None:
            return True
        return _INGEST_TIER_HINT != "materialize"

    def _observe_ingest(self, tier: str, seconds: float, rows: int) -> None:
        """A directory reader's ingest seconds (``phase_seconds["ingest"]``)
        and the planner's stream-against-materialize cost observation
        (``phase:workflow.ingest``) at row counts where the decision
        matters."""
        from .readers.streaming import DirectoryStreamReader
        if not isinstance(self._reader, DirectoryStreamReader):
            return
        self._phase_seconds["ingest"] = seconds
        if rows >= FUSE_MIN_ROWS:
            from . import planner
            planner.observe_phase("workflow.ingest", tier, seconds, rows)

    def _stream_raw_store(self, raw_features, dev, dtype) -> ColumnStore:
        """The out-of-core ingest: the directory reader's batches fold the
        full-stream statistics on ``dev`` (``fitstats.StreamingMomentFold``)
        and feed the seeded bounded subsample
        (``pipeline.SeededRowSample``, ``STREAM_SAMPLE_ROWS`` rows); the
        whole store is never materialized. Returns the subsample's raw
        store (for a stream within the budget, the whole stream in
        order). ``self._stream_state`` gets each tracked column's
        full-stream state from ``workflow.FUSE_MIN_ROWS`` streamed rows
        (below it the subsample is the data and the statistics pass covers
        it). ``STREAM_FIT_PASSES`` >= 2 folds in pass 1 and gathers in
        pass 2; the results are the same."""
        from . import fitstats, pipeline
        reader = self._reader
        passes = max(1, int(STREAM_FIT_PASSES))
        two_pass = passes >= 2
        sample = pipeline.SeededRowSample(STREAM_SAMPLE_ROWS)
        fold: Optional[fitstats.StreamingMomentFold] = None
        t0 = time.perf_counter()
        n_batches = 0

        def fold_batch(batch) -> None:
            nonlocal fold
            bstore = _raw_store(batch, raw_features)
            if fold is None:
                fold = fitstats.StreamingMomentFold(
                    _stream_fold_columns(bstore), device=dev, dtype=dtype)
            fold.update(bstore)

        def sample_batch(batch) -> None:
            loc = sample.offer(len(batch))
            sample.keep([batch[int(i)] for i in loc])

        with telemetry.span("workflow:stream_ingest", passes=passes):
            for batch in reader.stream(passes=1,
                                       workers=STREAM_FIT_WORKERS):
                n_batches += 1
                fold_batch(batch)
                if not two_pass:
                    sample_batch(batch)
            if two_pass:
                reader.rescan()
                for batch in reader.stream(passes=1,
                                           workers=STREAM_FIT_WORKERS):
                    sample_batch(batch)
        records = sample.result()
        n_total = sample.total_rows
        store = _raw_store(records, raw_features)
        #: (rows streamed, rows in the subsample) of the last streamed fit
        self._stream_rows = (n_total, store.n_rows)
        self._observe_ingest("stream", time.perf_counter() - t0, n_total)
        self._stream_state = (fold.finalize()
                              if fold is not None
                              and n_total >= FUSE_MIN_ROWS else None)
        logger.info("train: streamed ingest %d row(s) in %d batch(es) "
                    "(%d pass(es)); subsample %d row(s), %d streamed stat "
                    "column(s)", n_total, n_batches, passes, store.n_rows,
                    len(self._stream_state or ()))
        telemetry.emit("stream_ingest", rows=n_total, batches=n_batches,
                       passes=passes, sample_rows=store.n_rows,
                       stream_stat_columns=len(self._stream_state or ()))
        return store

    def _filter(self, store: ColumnStore, raw_features: List[Feature]):
        """The RawFeatureFilter's (clean store, result features, results):
        blacklisted raw features leave the store, and the DAG is copied
        without them (copyWithNewStages, OpWorkflow.scala:112-154), so the
        user's graph stays as it is."""
        filtered = self.raw_feature_filter.filter_raw(store, raw_features)
        self.blacklisted_features = filtered.blacklisted_features
        blacklisted = {f.uid for f in self.blacklisted_features}
        result_features = self.result_features
        if blacklisted:
            for f in result_features:
                if f.uid in blacklisted:
                    raise WorkflowError(
                        f"Result feature {f.name!r} was blacklisted by the "
                        "RawFeatureFilter")
            try:
                result_features = tuple(copy_dag(result_features,
                                                 frozenset(blacklisted)))
            except TypeError as e:
                raise WorkflowError(
                    "A fixed-arity stage depends on blacklisted "
                    f"feature(s): {e}") from e
        return filtered.clean_store, result_features, filtered.results

    def _fit_dag(self, dag: StagesDAG, train: ColumnStore,
                 test: Optional[ColumnStore],
                 fitted: Dict[str, FittedModel], dev, dtype,
                 seconds: Dict[str, float], checkpoint: bool = True,
                 transform_last: bool = False,
                 fit_state: Optional[Dict[str, Any]] = None
                 ) -> Tuple[ColumnStore, Optional[ColumnStore]]:
        """Fold ``dag``'s layers: fit each layer's estimators on ``train``
        into ``fitted`` (the opted-in ones from one statistics pass a
        layer, ``_layer_stats_pass``), evaluate ``has_test_eval`` models
        on ``test``, then transform both splits with the layer
        (``apply_layer``; FitStagesUtil.fitAndTransformLayer); the last
        layer's outputs are transformed only when ``transform_last``.
        ``fit_state`` receives the layers' sufficient statistics. Returns
        the transformed splits."""
        for li, layer in enumerate(dag):
            n_before = len(fitted)
            telemetry.emit("layer_start", index=li, n_stages=len(layer))
            with telemetry.span("fit:layer", layer=li, stages=len(layer),
                                rows=train.n_rows):
                train, test = self._fit_layer(
                    li, layer, len(dag), train, test, fitted, dev, dtype,
                    seconds, transform_last, fit_state)
            if checkpoint and self._checkpoint_dir \
                    and len(fitted) > n_before and _is_coordinator():
                from .model_io import _atomic_checkpoint
                _atomic_checkpoint(WorkflowModel(
                    self._active_result_features, fitted),
                    self._checkpoint_dir)
                logger.info("layer %d: checkpointed %d fitted stage(s) to "
                            "%s", li, len(fitted), self._checkpoint_dir)
        return train, test

    def _fit_layer(self, li: int, layer, n_layers: int, train: ColumnStore,
                   test: Optional[ColumnStore],
                   fitted: Dict[str, FittedModel], dev, dtype,
                   seconds: Dict[str, float], transform_last: bool,
                   fit_state: Optional[Dict[str, Any]]
                   ) -> Tuple[ColumnStore, Optional[ColumnStore]]:
        """One layer of :meth:`_fit_dag`: its statistics pass, its
        estimators' fits into ``fitted``, then both splits transformed
        (the last layer only with ``transform_last``)."""
        stats, fused, pass_info = self._layer_stats_pass(
            li, layer, train, dev, dtype, fit_state)
        models: List[Transformer] = []
        for stage in layer:
            metrics = self._stage_metrics.setdefault(
                stage.uid, {"stageName": stage.stage_name()})
            if isinstance(stage, Estimator):
                model = self._fit_stage(
                    stage, train, dev, dtype, metrics, seconds, li,
                    stats if stage.uid in fused else None)
                if stage.uid in fused:
                    # the pass's seconds, shared by the stages it fed
                    seconds[stage.uid] += pass_info["seconds"] / len(fused)
                    metrics["statsPass"] = pass_info
                fitted[stage.uid] = model
                if model.has_test_eval() and test is not None:
                    model.evaluate_model(test, **_device_kw(model, dev))
                models.append(model)
            elif isinstance(stage, Transformer):
                models.append(stage)
            else:
                raise WorkflowError(f"Unfittable stage {stage!r}")
        if transform_last or li < n_layers - 1:
            tt = time.perf_counter()
            info: Dict[str, Any] = {}
            tier = self._tier("transform_tier")
            with telemetry.span("fit:transform_layer", layer=li,
                                stages=len(models)):
                train = apply_layer(models, train, dev, seconds, info=info,
                                    tier=tier)
                if test is not None:
                    test = apply_layer(models, test, dev, seconds,
                                       tier=tier)
            for m in models:
                metrics = self._stage_metrics.setdefault(
                    m.uid, {"stageName": m.stage_name()})
                metrics["layerTransformSeconds"] = round(
                    time.perf_counter() - tt, 4)
                if info:
                    metrics["fusedTransform"] = info
        return train, test

    def _fit_dag_workflow_cv(self, result_features, dag: StagesDAG,
                             train: ColumnStore, test: Optional[ColumnStore],
                             fitted: Dict[str, FittedModel], dev, dtype,
                             seconds: Dict[str, float],
                             fit_state: Dict[str, Any]) -> None:
        """Leak-free workflow CV (OpWorkflow.scala:388-443 + cutDAG):

        1. fit the *before* DAG once on the training split;
        2. the ModelSelector sweeps the (family × grid) grid on each CV
           fold's own matrix (``ModelSelector.select_per_fold``;
           OpCrossValidation.scala:89-116), which ``fold_matrix`` makes:
           the *during* (label-aware) stages re-fit on the fold's training
           rows only, the whole split transformed with them;
        3. fit the *during* stages, the selector (which takes the winner
           without sweeping again) and the *after* layers on the whole
           training split.

        ``self._phase_seconds`` gets each step's seconds (``before``,
        ``foldFeatures``, ``cvSweep``, ``final``). Each fold's *during*
        layers take the same statistics pass and layer transform as the
        whole split's; ``fit_state`` gets the whole split's states."""
        ms, before, during, _after = cut_dag(result_features)
        if ms is None or not during:
            self._fit_dag(dag, train, test, fitted, dev, dtype, seconds,
                          fit_state=fit_state)
            return
        phase = self._phase_seconds
        t0 = time.perf_counter()
        train_b, test_b = self._fit_dag(before, train, test, fitted, dev,
                                        dtype, seconds, transform_last=True,
                                        fit_state=fit_state)
        phase["before"] = time.perf_counter() - t0
        feats_name = ms.input_features[1].name
        phase["foldFeatures"] = 0.0

        def fold_matrix(kept: ColumnStore, rows: np.ndarray) -> np.ndarray:
            """Every kept row's vector through the *during* stages fitted
            on ``rows``."""
            tf = time.perf_counter()
            fold_fit: Dict[str, FittedModel] = {}
            self._fit_dag(during, kept.take(rows), None, fold_fit, dev,
                          dtype, {}, checkpoint=False)
            for layer in during:
                kept = apply_layer([fold_fit.get(s.uid, s) for s in layer],
                                   kept, dev,
                                   tier=self._tier("transform_tier"))
            phase["foldFeatures"] += time.perf_counter() - tf
            return np.asarray(kept[feats_name].values, dtype=np.float64)

        t0 = time.perf_counter()
        ms.select_per_fold(train_b, fold_matrix, device=dev, dtype=dtype)
        phase["cvSweep"] = time.perf_counter() - t0 - phase["foldFeatures"]

        # the during stages, the selector and the after layers on the
        # whole training split
        t0 = time.perf_counter()
        done = {s.uid for layer in before for s in layer}
        remaining = [rest for rest in ([s for s in layer
                                        if s.uid not in done]
                                       for layer in dag) if rest]
        self._fit_dag(remaining, train_b, test_b, fitted, dev, dtype,
                      seconds, fit_state=fit_state)
        phase["final"] = time.perf_counter() - t0

    def _layer_stats_pass(self, li: int, layer, train: ColumnStore, dev,
                          dtype, fit_state: Optional[Dict[str, Any]]):
        """The fused fit-statistics pass (``fitstats.py``): every
        opted-in estimator's StatRequests for this layer (warm-started
        stages excluded) computed in one pass over ``train`` when at least
        ``FITSTATS_MIN_STAGES`` of them scan data, or a warm state matches
        this layer. Returns (StatResults or None, the uids it feeds, the
        pass's {"tier", "stages", "requests", "seconds", "bytesScanned"}).
        A layer below the threshold still records its moment columns'
        state. The layer's states go to ``fit_state`` as
        ``"<layer>:<column>"``. A failing opt-in raises."""
        from . import fitstats
        if not fitstats.FITSTATS_ENABLED:
            return None, set(), None
        requests: Dict[str, list] = {}
        for stage in layer:
            if isinstance(stage, Estimator) \
                    and stage.uid not in self._warm_stages:
                reqs = stage.stat_requests(train)
                if reqs is not None:
                    requests[stage.uid] = list(reqs)
        n_scanning = sum(1 for reqs in requests.values() if reqs)
        warm = None
        if self._warm_fit_stats and n_scanning:
            prefix = f"{li}:"
            warm = {k[len(prefix):]: v
                    for k, v in self._warm_fit_stats.items()
                    if k.startswith(prefix)} or None
            self._warm_matched += len(warm or ())
        if n_scanning < fitstats.FITSTATS_MIN_STAGES and warm is None:
            if fit_state is not None:
                cols = {r.column for reqs in requests.values()
                        for r in reqs if r.kind in fitstats._MOMENT_KINDS}
                for col in sorted(cols):
                    fit_state[f"{li}:{col}"] = \
                        fitstats.collect_column_state(train[col])
            return None, set(), None
        plan = fitstats.LayerStatsPlan(
            [r for reqs in requests.values() for r in reqs],
            n_stages=n_scanning)
        state_out: Dict[str, Any] = {}
        t0 = time.perf_counter()
        with telemetry.span("fit:stats_pass", layer=li, stages=n_scanning,
                            requests=plan.n_requests, rows=train.n_rows):
            stats = plan.run(train, state_out=state_out, warm_state=warm,
                             workflow_device=dev, dtype=dtype,
                             tier_hint=self._tier("fitstats_tier"),
                             stream_state=getattr(self, "_stream_state",
                                                  None),
                             mesh=self._active_mesh)
        telemetry.emit("stats_pass", layer=li, n_stages=n_scanning,
                       n_requests=plan.n_requests,
                       passes_saved=n_scanning - 1,
                       seconds=time.perf_counter() - t0)
        info = {"tier": plan.tier, "stages": n_scanning,
                "requests": plan.n_requests,
                "seconds": time.perf_counter() - t0,
                "bytesScanned": plan.bytes_scanned}
        if fit_state is not None:
            for col, st in state_out.items():
                fit_state[f"{li}:{col}"] = st
        logger.info("layer %d: one %s statistics pass fed %d estimator(s) "
                    "(%d request(s)) in %.2fs", li, plan.tier,
                    len(requests), plan.n_requests, info["seconds"])
        return stats, set(requests), info

    def _fit_stage(self, stage: Estimator, train: ColumnStore, dev, dtype,
                   metrics: Dict[str, Any], seconds: Dict[str, float],
                   li: int, stats=None) -> FittedModel:
        """The estimator's fitted model: the warm-start stage of its uid
        (a shallow copy rewired to this DAG, so the donor model's stages
        stay as they are), else a fit on ``train``, from the layer's
        ``stats`` where the statistics pass fed it. A fit's seconds are
        all execute seconds: the port compiles nothing
        (``telemetry.compile_clock_s``)."""
        warm = self._warm_stages.get(stage.uid)
        if warm is not None:
            model = _copy.copy(warm)
            model.input_features = stage.fitted_inputs()
            model._output_feature = stage.get_output()
            metrics["warmStarted"] = True
            metrics["fitSeconds"] = 0.0
            seconds[stage.uid] = 0.0
            telemetry.emit("stage_fit", uid=stage.uid,
                           stage_name=stage.stage_name(), fit_s=0.0,
                           warm_started=True)
            logger.info("%s [%s] warm-started", stage.stage_name(),
                        stage.uid)
            return model
        kw = _device_kw(stage, dev)
        if kw:
            kw["dtype"] = dtype
        ts = time.perf_counter()
        with telemetry.span("fit:stage", uid=stage.uid,
                            stage=stage.stage_name(), layer=li,
                            fused=stats is not None):
            if stats is not None:
                model = stage.fit(train, stats=stats)
                metrics["fusedStats"] = True
            else:
                model = stage.fit(train, **kw)
        fit_s = time.perf_counter() - ts
        seconds[stage.uid] = fit_s
        metrics["fitSeconds"] = round(fit_s, 4)
        telemetry.emit("stage_fit", uid=stage.uid,
                       stage_name=stage.stage_name(), fit_s=fit_s,
                       compile_s=0.0, execute_s=fit_s)
        return model


class WorkflowModel:
    """Fitted pipeline (OpWorkflowModel): score / evaluate / save."""

    def __init__(self, result_features: Sequence[Feature],
                 fitted_stages: Dict[str, FittedModel],
                 dag: Optional[StagesDAG] = None,
                 parameters: Optional[Dict[str, Any]] = None,
                 train_time_s: float = 0.0,
                 stage_seconds: Optional[Dict[str, float]] = None,
                 stage_metrics: Optional[Dict[str, Dict[str, Any]]] = None,
                 train_rows: int = 0,
                 blacklisted_features: Sequence[Feature] = (),
                 rff_results=None,
                 fit_stats: Optional[Dict[str, Any]] = None):
        self.uid = uid_mod.make_uid("WorkflowModel")
        self.result_features = tuple(result_features)
        self.fitted_stages = dict(fitted_stages)
        self.dag = dag if dag is not None else compute_dag(result_features)
        self.parameters = parameters or {}
        #: raw features the RawFeatureFilter dropped
        self.blacklisted_features = list(blacklisted_features)
        #: the filter's ``RawFeatureFilterResults`` (None without one)
        self.rff_results = rff_results
        self.train_time_s = train_time_s
        #: stage uid → train wall-clock seconds (its fit + its transforms)
        self.stage_seconds = dict(stage_seconds or {})
        #: stage uid → {"stageName", "fitSeconds", "warmStarted",
        #: "layerTransformSeconds", "fusedStats", "statsPass",
        #: "fusedTransform"} (OpSparkListener analog)
        self.stage_metrics = dict(stage_metrics or {})
        #: rows of the training split (0 on a loaded model)
        self.train_rows = int(train_rows)
        #: the train's sufficient statistics: ``"<layer>:<column>"`` →
        #: ``fitstats.SufficientStats`` (saved as ``fitSufficientStats``)
        self.fit_stats = dict(fit_stats or {})
        #: train seconds by phase: ``aggregate`` (an aggregating reader's
        #: store), ``rawFeatureFilter``, and with workflow CV ``before``,
        #: ``foldFeatures``, ``cvSweep`` and ``final``
        self.phase_seconds: Dict[str, float] = {}
        #: scoring engines by device (``scoring_engine``)
        self._engines: Dict[str, Any] = {}
        #: the planner.ExecutionPlan the scoring engine follows
        #: (``attach_plan``)
        self._execution_plan: Any = None

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

    def stage_of(self, feature: Feature) -> Transformer:
        """The fitted stage (or transformer) that computes ``feature``."""
        st = feature.origin_stage
        if st is None:
            raise WorkflowError(f"{feature.name!r} is a raw feature")
        return self.fitted_stages.get(st.uid, st)

    def model_insights(self, pred_feature: Optional[Feature] = None,
                       store: Optional[ColumnStore] = None, device=None):
        """The interpretability report (OpWorkflowModel.modelInsights
        :163-176): ``insights.ModelInsights`` of ``pred_feature`` (default:
        the Prediction result), the vector's metadata from ``store``'s
        layers on ``device`` (default: the card) when a store is given."""
        from .insights import ModelInsights
        return ModelInsights.extract(self, pred_feature, store, device)

    def validate(self, device: bool = True, suppress=()) -> list:
        """The pre-flight over the fitted model (``lint.check_model``):
        the graph rules, with the unfitted-estimator and dead-stage rules,
        and with ``device`` the TMG2xx shape propagation on the meta
        device (nothing is read, uploaded or launched)."""
        from . import lint
        return lint.check_model(self, device=device, suppress=suppress)

    # -- planning (planner.py) ---------------------------------------------
    def plan(self, cost_db=None, attach: bool = True):
        """This model's ``planner.ExecutionPlan`` (dead columns, CSE
        merges, tiers from ``cost_db``'s measurements) and, with
        ``attach``, installed for the scoring engine. Static: no data is
        read and nothing runs on a device."""
        from . import planner
        p = planner.plan_model(self, cost_db=cost_db)
        if attach:
            self.attach_plan(p)
        return p

    def attach_plan(self, plan) -> "WorkflowModel":
        """Install an ExecutionPlan for the scoring engine: the engines
        built so far are dropped, so the next one applies its rewrites.
        ``attach_plan(None)`` reverts to unplanned scoring."""
        self._execution_plan = plan
        self._engines = {}
        return self

    def execution_plan(self):
        return self._execution_plan

    # -- scoring -----------------------------------------------------------
    def scoring_engine(self, device=None, **engine_kw):
        """The batched scoring engine (``scoring.ScoringEngine``) of this
        model on ``device`` (default: the card), built once a device
        under the attached plan; an engine with other settings
        (``engine_kw``; ``plan=None`` for an unplanned one) is built
        afresh and not kept."""
        from .scoring import ScoringEngine
        dev = resolve_device(device)
        if engine_kw:
            kw = dict(engine_kw)
            kw.setdefault("plan", self._execution_plan)
            return ScoringEngine(self, device=dev, **kw)
        eng = self._engines.get(str(dev))
        if eng is None:
            eng = self._engines[str(dev)] = ScoringEngine(
                self, device=dev, plan=self._execution_plan)
        return eng

    def _use_engine(self, data, engine, dev) -> bool:
        """``engine=True`` forces the engine, ``False`` forbids it, and
        ``"auto"`` takes it from ``SCORING_MIN_ROWS`` rows. A model with
        no stage the engine fuses scores by layers either way."""
        if engine is False:
            return False
        from .scoring import SCORING_MIN_ROWS
        n = (data.n_rows if isinstance(data, ColumnStore)
             else len(data) if hasattr(data, "__len__") else 0)
        if engine is not True and n < SCORING_MIN_ROWS:
            return False
        return self.scoring_engine(dev).enabled()

    def _transform_layers(self, data, dev,
                          up_to: Optional[Feature] = None) -> ColumnStore:
        """The per-layer path: every fitted layer applied in turn (only
        the ancestors of ``up_to``, when given)."""
        targets = (up_to,) if up_to is not None else self.result_features
        store = _raw_store(data, _raw_features_of(targets))
        needed = (None if up_to is None
                  else {s.uid for s in up_to.parent_stages()})
        for layer in self._resolved_dag():
            store = apply_layer([m for m in layer
                                  if needed is None or m.uid in needed],
                                 store, dev)
        return store

    def transform(self, data, device=None, engine: Any = "auto",
                  up_to: Optional[Feature] = None) -> ColumnStore:
        """Apply the fitted layers to ``data`` (a ColumnStore or record
        dicts) on ``device`` (default: the card): through the scoring
        engine (``engine``: see :meth:`_use_engine`), or layer by layer.
        ``up_to`` computes only that feature's ancestors
        (computeDataUpTo, OpWorkflowModel.scala:106), layer by layer."""
        dev = resolve_device(device)
        if up_to is None and self._use_engine(data, engine, dev):
            return self.scoring_engine(dev).transform_store(data)
        return self._transform_layers(data, dev, up_to)

    def score(self, data, keep_intermediate: bool = False, device=None,
              engine: Any = "auto") -> ColumnStore:
        """Result feature columns (OpWorkflowModel.score); the engine path
        pulls only the result columns off the device."""
        dev = resolve_device(device)
        if not keep_intermediate and self._use_engine(data, engine, dev):
            return self.scoring_engine(dev).score_store(data)
        store = self.transform(data, device=dev, engine=engine)
        if keep_intermediate:
            return store
        return store.select([f.name for f in self.result_features
                             if f.name in store])

    def score_and_evaluate(self, data, evaluator, device=None,
                           engine: Any = "auto"
                           ) -> Tuple[ColumnStore, Dict[str, Any]]:
        """Scores and the evaluator's metrics. Through the engine only the
        result columns and the evaluator's label leave the device path
        (the JAX package materializes every column here)."""
        dev = resolve_device(device)
        if self._use_engine(data, engine, dev):
            store = self.scoring_engine(dev).score_store(
                data, keep=[evaluator.label_col])
        else:
            store = self._transform_layers(data, dev)
        metrics = evaluator.evaluate_all(store)
        return store.select([f.name for f in self.result_features
                             if f.name in store]), metrics

    def evaluate(self, data, evaluator, device=None,
                 engine: Any = "auto") -> Dict[str, Any]:
        return self.score_and_evaluate(data, evaluator, device=device,
                                       engine=engine)[1]

    def score_fn(self, device=None
                 ) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
        """Row-level scoring closure (scoreFn): {raw feature name: raw
        value} → {result name: raw value}, each stage through its one-row
        columnar transform on ``device`` (default: the card)."""
        dev = resolve_device(device)
        layers = self._resolved_dag()
        result_names = [f.name for f in self.result_features]

        def score_row(row: Dict[str, Any]) -> Dict[str, Any]:
            acc = dict(row)
            for layer in layers:
                for m in layer:
                    acc[m.output_name] = m.transform_row(
                        acc, **_device_kw(m, dev))
            return {n: acc[n] for n in result_names if n in acc}

        return score_row

    # -- persistence (OpWorkflowModelWriter/Reader) ------------------------
    def save(self, path: str, overwrite: bool = False) -> None:
        """Save in the JAX package's format (``model_io``); an existing
        model at ``path`` raises FileExistsError unless ``overwrite``."""
        from .model_io import save_workflow_model
        save_workflow_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "WorkflowModel":
        """A model saved by either package."""
        from .model_io import load_workflow_model
        return load_workflow_model(path)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"uid": self.uid,
                               "trainTimeSeconds": self.train_time_s,
                               "stageMetrics": self.stage_metrics,
                               "stages": {}}
        for uid, model in self.fitted_stages.items():
            s = getattr(model, "summary", None)
            if s is not None:
                out["stages"][uid] = s() if callable(s) else s
        return out

    def summary_pretty(self) -> str:
        """The summary for people: the per-stage timing table
        (OpSparkListener / Table.scala rendering), then the stage JSON.
        The columns are the JAX package's; this package measures no
        compile seconds, so that column is empty."""
        import json

        from .utils.table import Table
        parts = []
        if self.stage_metrics:
            rows = [[m.get("stageName", uid), uid,
                     m.get("fitSeconds"), m.get("compileSeconds"),
                     m.get("executeSeconds"),
                     m.get("layerTransformSeconds"),
                     "yes" if m.get("warmStarted") else ""]
                    for uid, m in sorted(self.stage_metrics.items())]
            parts.append(Table(
                ["stage", "uid", "fit s", "compile s", "execute s",
                 "layer transform s", "warm"],
                rows, name="Stage metrics").render())
        doc = self.summary()
        doc.pop("stageMetrics", None)
        parts.append(json.dumps(doc, indent=2, default=str))
        return "\n\n".join(parts)
