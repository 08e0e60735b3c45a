"""The multi-tenant model server; the port of ``transmogrifai_tpu/server.py``.

N loaded models behind a capacity-bounded LRU, each with its own bounded
request queue and a worker that merges concurrent requests (up to a
deadline) into one scoring-engine dispatch padded to the engine's
power-of-two ladder bucket, then scatters the rows back. A tenant's
program bank (``aot.py``) answers its first request without building a
program. Per-model latency, throughput and queue instruments, the
latency decomposition and an optional SLO.

Contract
--------

* **Merged batches are bitwise.** Every fused stage is row-independent
  (the scoring engine's contract), so a request's rows compute the same
  values whether padded with zeros or with other requests' rows. The
  oracle is ``ScoringEngine.score_store(records, bucket_min=bucket)``: the
  same program at the dispatch's bucket.
* **No host tier.** The JAX server wraps each dispatch in a circuit
  breaker and retries a failed batch request by request on the host path.
  The port keeps the device's rule instead (``resilience``): a device
  failure (:func:`resilience.is_device_failure`: an injected fault at a
  device site, or the card's own error) fails that batch's futures with
  the error, and nothing is scored on the host; any other failure is
  retried one request at a time through the same engine on the same
  device, and a request that fails alone is quarantined (the dead-letter
  sink) with the error on its future. ``server.dispatch`` is the fault
  site. A tenant whose engine fuses nothing scores by layers on the
  server's device (``model.score(engine=False, device=...)``): routing,
  not a fallback; ``engineTier`` is False in its responses.
* **Explicit backpressure.** Queues are bounded; a full queue rejects
  with :class:`ServerBusy` (HTTP 429). A draining shutdown scores every
  queued request before the workers exit.
* **Threads on one card.** Each tenant has one worker thread; the HTTP
  front end answers each request on its own thread. A dispatch scores
  through the (model, engine, bank buckets) captured under the entry lock
  (:meth:`ModelServer._ensure_loaded`), so an LRU eviction in the middle
  of a dispatch cannot drop the engine (its CUDA graphs and memory pool)
  the dispatch is using; the engine itself serializes the device half of
  its calls.

HTTP (stdlib ``http.server``)::

    POST /v1/models/<name>:score     {"records": [...]} → scored rows
                                     (504 once request_timeout_s passes)
    POST /v1/models/<name>:deploy    {"version", "mode", "fraction", ...}
    POST /v1/models/<name>:rollback
    GET  /v1/models/<name>/versions  registry versions and live rollout
    GET  /v1/models                  model table and stats
    GET  /healthz                    liveness (503 once shutdown began)
    GET  /readyz                     readiness: loadable tenants and
                                     queue headroom
    GET  /stats                      server_stats() and per-model stats
    GET  /metrics                    Prometheus text

Run it with ``python -m transmogrifai_tpu_torch serve params.json``
(knobs ``customParams.serve*``, ``registryDir``, ``drift*``). With the
workload flight recorder installed (``customParams.workloadDir``,
``workload.py``), every ``:score`` request the front end accepts, answers
or refuses leaves one record: its arrival, payload, trace id, outcome and
phase decomposition.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from . import aot, lifecycle, resilience, telemetry, workload
from .lifecycle import RegistryError
from .utils import locks

logger = logging.getLogger(__name__)

__all__ = ["ModelServer", "RequestResult", "ServerError", "ModelNotFound",
           "ServerBusy", "ServerClosed", "RolloutError", "serve_http",
           "server_stats", "reset_server_stats", "READY_MIN_HEADROOM",
           "DEFAULT_BATCH_DEADLINE_MS", "DEFAULT_MAX_QUEUE",
           "DEFAULT_MAX_MODELS", "DEFAULT_CANARY_FRACTION",
           "DEFAULT_ROLLOUT_WINDOW_REQUESTS", "DEFAULT_PROMOTE_WINDOWS"]

#: how long the micro-batcher holds the first queued request open for
#: co-riders before dispatching (ms); 0 dispatches at once
DEFAULT_BATCH_DEADLINE_MS = 2.0

#: bounded per-model queue; beyond it, submit() raises ServerBusy
DEFAULT_MAX_QUEUE = 256

#: loaded models held before the LRU evicts
DEFAULT_MAX_MODELS = 4

#: online deadline adaptation: completed requests a tenant accumulates
#: between controller decisions (one noisy request never flaps it)
ADAPT_WINDOW_REQUESTS = 64

#: the AIMD shape: additive step (s) toward more merging, multiplicative
#: decrease when queue wait dominates, and the dead band between the two
#: phase medians inside which the controller holds still
ADAPT_STEP_S = 0.0005
ADAPT_MD_FACTOR = 0.5
ADAPT_DEADBAND = 1.25

#: converged / configured deadline ratio past which the controller raises
#: the TMG406 advisory (live telemetry contradicts the params file)
ADAPT_ADVISORY_RATIO = 2.0

#: per-model latency reservoir for exact p50/p95/p99 in stats
_LATENCY_WINDOW = 4096

#: a request's latency decomposition: time in the bounded queue before
#: the worker took it, time held open for co-riders, the device dispatch
#: and the scatter of results
_LATENCY_PHASES = ("queueWait", "coalesceHold", "deviceDispatch",
                   "scatter")

#: telemetry histogram suffix per phase (server.<suffix>.<model>)
_PHASE_METRIC = {"queueWait": "queue_wait_seconds",
                 "coalesceHold": "coalesce_hold_seconds",
                 "deviceDispatch": "device_dispatch_seconds",
                 "scatter": "scatter_seconds"}

#: request fraction a canary rollout routes to the candidate by default
DEFAULT_CANARY_FRACTION = 0.1

#: completed requests that make one rollout evaluation window
DEFAULT_ROLLOUT_WINDOW_REQUESTS = 64

#: consecutive clean windows before a rollout promotes itself
DEFAULT_PROMOTE_WINDOWS = 3

#: readiness: not ready once the summed queue depth leaves less than this
#: fraction of the total queue capacity free
READY_MIN_HEADROOM = 0.1

#: record batches the drift queue holds before it drops (tallied; a
#: worker never blocks on it)
DRIFT_QUEUE_DEPTH = 64

#: rows the sentinel thread merges into one sketch pass under a backlog
DRIFT_COALESCE_ROWS = 2048

#: ceiling on the host CPU share of the sentinel thread: after a pass of
#: ``dt`` seconds it sleeps ``dt * (1/duty - 1)``, at most 2 s; under
#: saturation the queue drops observations instead of slowing scoring
DRIFT_DUTY_CYCLE = 0.002


# ---------------------------------------------------------------------------
# always-on tallies (run documents stamp these; telemetry mirrors)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"requests": 0, "requests_failed": 0, "rows": 0, "batches": 0,
          "coalesced_requests": 0, "bank_hit_batches": 0, "rejected": 0,
          "quarantined_requests": 0, "model_loads": 0, "model_evictions": 0,
          "bank_loads": 0, "slo_met": 0, "slo_missed": 0,
          "requests_timed_out": 0, "timed_out_completions": 0,
          "deadline_adapt_windows": 0, "deadline_increases": 0,
          "deadline_decreases": 0, "deadline_holds": 0,
          "deadline_clamped": 0, "deadline_advisories": 0}


def server_stats() -> Dict[str, Any]:
    """Process-wide serving tallies and the derived numbers:
    ``batch_coalescing_factor`` (requests a dispatch), ``bank_hit_rate``
    (dispatches at a banked bucket) and ``slo_attainment`` (share of
    SLO-tracked requests under the limit; None without an SLO)."""
    with _TALLY_LOCK:
        out: Dict[str, Any] = dict(_TALLY)
    out["batch_coalescing_factor"] = (
        round(out["requests"] / out["batches"], 3) if out["batches"]
        else None)
    out["bank_hit_rate"] = (
        round(out["bank_hit_batches"] / out["batches"], 3)
        if out["batches"] else None)
    tracked = out["slo_met"] + out["slo_missed"]
    out["slo_attainment"] = (round(out["slo_met"] / tracked, 4)
                             if tracked else None)
    return out


def reset_server_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


# ---------------------------------------------------------------------------
# request plumbing
# ---------------------------------------------------------------------------


class ServerError(Exception):
    """Base class of the serving tier's rejections."""


class ModelNotFound(ServerError):
    pass


class ServerBusy(ServerError):
    """The model's bounded queue is full (HTTP 429)."""


class ServerClosed(ServerError):
    pass


class RolloutError(ServerError):
    """Rollout misuse: no registry attached, a rollout already in flight,
    an invalid deploy mode or fraction."""


@dataclass
class RequestResult:
    """One request's scored rows and how they were dispatched."""

    store: Any                  # ColumnStore of the result columns
    rows: int
    bucket: int                 # padded ladder bucket of the dispatch
    coalesced: int              # requests sharing that dispatch
    seconds: float              # queue-to-completion latency
    engine_tier: bool           # True: the scoring engine; False: layers
    canary: bool = False        # True: scored by a canary candidate
    #: this request's latency decomposition (queueWait / coalesceHold /
    #: deviceDispatch / scatter seconds; partial when a phase was skipped)
    decomp: Optional[Dict[str, float]] = None


class _Rollout:
    """One shadow or canary rollout in flight on a served model.

    Its window counters are changed only by the model's worker thread;
    installing and clearing happen under the entry lock.
    ``promote_windows`` consecutive clean windows (no candidate failure,
    no SLO miss on candidate traffic, no new drift advisory, no shadow
    parity mismatch) promote it; a candidate failure or SLO breach rolls
    it back."""

    def __init__(self, mode: str, version: Optional[str], fraction: float,
                 model: Any, engine: Any, bank_buckets: List[int],
                 bank_report: Optional[Dict[str, Any]],
                 model_dir: Optional[str], bank_dir: Optional[str],
                 window_requests: int, promote_windows: int,
                 drift_gate: bool = True):
        self.mode = mode
        self.version = version
        self.fraction = float(fraction)
        #: False: new drift advisories do not block promotion (a
        #: candidate trained on the drifted window)
        self.drift_gate = bool(drift_gate)
        self.model = model
        self.engine = engine
        self.bank_buckets = list(bank_buckets)
        self.bank_report = bank_report
        self.model_dir = model_dir
        self.bank_dir = bank_dir
        self.window_requests = max(int(window_requests), 1)
        self.promote_windows = max(int(promote_windows), 1)
        # window-scoped evidence (reset each evaluation window)
        self.win_requests = 0
        self.win_failures = 0
        self.win_slo_missed = 0
        self.win_parity_mismatch = 0
        #: candidate-touching requests this window (canary scored or
        #: shadow compared); a window with none proves nothing
        self.win_evidence = 0
        # evidence over the whole rollout
        self.windows = 0
        self.clean_windows = 0
        self.canary_requests = 0
        self.shadow_requests = 0
        self.shadow_batches = 0
        self.parity_ok = 0
        self.parity_mismatch = 0
        self.shadow_seconds = 0.0
        self.primary_seconds = 0.0
        self.drift_seen = 0          # sentinel advisories at window start

    def status(self) -> Dict[str, Any]:
        compared = self.parity_ok + self.parity_mismatch
        return {"mode": self.mode, "version": self.version,
                "fraction": self.fraction,
                "windowRequests": self.window_requests,
                "promoteWindows": self.promote_windows,
                "windows": self.windows,
                "cleanWindows": self.clean_windows,
                "canaryRequests": self.canary_requests,
                "shadowRequests": self.shadow_requests,
                "parityOk": self.parity_ok,
                "parityMismatch": self.parity_mismatch,
                "parityRate": (round(self.parity_ok / compared, 4)
                               if compared else None),
                "shadowLatencyDeltaMs": (
                    round((self.shadow_seconds - self.primary_seconds)
                          / max(self.shadow_batches, 1) * 1e3, 3)
                    if self.shadow_batches else None)}


class _Request:
    __slots__ = ("records", "future", "t_enqueued", "rows", "trace",
                 "t_dequeued", "t_dispatch0", "t_dispatch1",
                 "dispatch_s")

    def __init__(self, records: List[Dict[str, Any]],
                 trace: Optional[tuple] = None):
        self.records = list(records)
        self.rows = len(self.records)
        self.future: "Future[RequestResult]" = Future()
        self.t_enqueued = time.perf_counter()
        #: (trace_id, span_id) of the request span that enqueued this;
        #: the batch span links it
        self.trace = trace
        #: latency-decomposition marks: first worker pickup, dispatch
        #: start and end, and this request's dispatch seconds
        self.t_dequeued: Optional[float] = None
        self.t_dispatch0: Optional[float] = None
        self.t_dispatch1: Optional[float] = None
        self.dispatch_s: Optional[float] = None


_SENTINEL = object()


class _ModelEntry:
    """One registered model: its queue, worker, loaded state and stats."""

    def __init__(self, name: str, model_dir: Optional[str],
                 bank_dir: Optional[str], model: Any,
                 max_queue: int):
        self.name = name
        self.model_dir = model_dir
        self.bank_dir = bank_dir
        #: a model registered as a live object (no directory) cannot be
        #: reloaded after eviction, so the LRU pins it
        self.pinned = model is not None and model_dir is None
        self.model = model
        self.engine = None
        self.bank_buckets: List[int] = []
        self.bank_report: Optional[Dict[str, Any]] = None
        #: True: the directories re-resolve through the registry's
        #: ``current`` pointer on every (re)load
        self.via_registry = False
        #: lifecycle.DriftSentinel over live traffic (None: drift off)
        self.sentinel: Any = None
        #: the shadow or canary rollout in flight, None otherwise
        self.rollout: Optional["_Rollout"] = None
        self.weight_bytes = 0
        self.queue: "queue.Queue[Any]" = queue.Queue(maxsize=max_queue)
        # guards load and unload; order-witnessed under the chaos tests
        self.lock = locks.witness_lock("server._ModelEntry.lock")
        self.worker: Optional[threading.Thread] = None
        self.latencies: "deque[float]" = deque(maxlen=_LATENCY_WINDOW)
        #: per-phase latency reservoirs
        self.decomp: Dict[str, "deque[float]"] = {
            ph: deque(maxlen=_LATENCY_WINDOW) for ph in _LATENCY_PHASES}
        #: per-tenant telemetry metric names, formatted once
        self.metric_names = {
            "request": f"server.request_seconds.{name}",
            "queue": f"server.queue_depth.{name}",
            **{ph: f"server.{_PHASE_METRIC[ph]}.{name}"
               for ph in _LATENCY_PHASES}}
        self.requests = 0
        self.failures = 0
        self.rows = 0
        self.batches = 0
        self.bank_hit_batches = 0
        self.loads = 0
        #: the tenant's adapted micro-batching hold; None: the worker
        #: reads the server's ``batch_deadline_s``. Only the tenant's own
        #: worker writes it, between dispatches.
        self.deadline_s: Optional[float] = None
        self.adapt_seen = 0          # requests consumed by past windows
        self.adapt_increases = 0
        self.adapt_decreases = 0
        self.adapt_clamped = 0
        self.deadline_advised = False

    @staticmethod
    def _pct(values) -> Dict[str, float]:
        lat = np.asarray(values, dtype=np.float64)
        if not lat.size:
            return {}
        return {"p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
                "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3)}

    def stats(self) -> Dict[str, Any]:
        pct = self._pct(self.latencies)
        rollout = self.rollout
        sentinel = self.sentinel
        return {"loaded": self.model is not None, "pinned": self.pinned,
                "requests": self.requests, "failures": self.failures,
                "rows": self.rows, "batches": self.batches,
                "bankBuckets": list(self.bank_buckets),
                "bankHitBatches": self.bank_hit_batches,
                "weightBytes": self.weight_bytes,
                "queueDepth": self.queue.qsize(), "loads": self.loads,
                "viaRegistry": self.via_registry,
                "rollout": rollout.status() if rollout else None,
                "drift": sentinel.stats() if sentinel else None,
                "adaptiveDeadlineMs": (
                    None if self.deadline_s is None
                    else round(self.deadline_s * 1e3, 4)),
                "deadlineAdaptations": {
                    "increases": self.adapt_increases,
                    "decreases": self.adapt_decreases,
                    "clamped": self.adapt_clamped},
                "latency": {"e2e": pct,
                            **{ph: self._pct(self.decomp[ph])
                               for ph in _LATENCY_PHASES}},
                **pct}


def _fail_future(fut: "Future[Any]", exc: BaseException) -> None:
    """Fail ``fut`` with ``exc`` unless it is already resolved or was
    cancelled (a timed-out HTTP request cancels its future)."""
    if fut.done():
        return
    try:
        if not fut.set_running_or_notify_cancel():
            return
    except RuntimeError:  # already running: resolved concurrently
        pass
    try:
        fut.set_exception(exc)
    except Exception:  # lint: broad-except — already resolved: nothing to fail
        pass


class ModelServer:
    """N models behind a weighted LRU, one micro-batching worker each.

    ``device`` is where every tenant scores (None: the card; the tests
    pass "cpu"). ``capacity_bytes`` bounds the summed program-bank bytes
    of loaded models (``max_models`` their count); the least recently
    used reloadable model is unloaded past either bound and reloaded on
    its next request. ``batch_deadline_s`` is the micro-batching hold;
    ``slo_ms`` scores each request against a latency SLO."""

    def __init__(self, max_models: int = DEFAULT_MAX_MODELS,
                 capacity_bytes: Optional[int] = None,
                 batch_deadline_s: float = DEFAULT_BATCH_DEADLINE_MS / 1e3,
                 max_queue: int = DEFAULT_MAX_QUEUE,
                 slo_ms: Optional[float] = None,
                 bucket_cap: Optional[int] = None,
                 registry: Optional["lifecycle.ModelRegistry"] = None,
                 drift_window: Optional[int] = None,
                 drift_js_threshold: float = lifecycle.DEFAULT_JS_THRESHOLD,
                 drift_fill_delta: float =
                 lifecycle.DEFAULT_FILL_DELTA_THRESHOLD,
                 canary_fraction: float = DEFAULT_CANARY_FRACTION,
                 adapt_deadline: bool = False, device=None):
        if max_models < 1:
            raise ValueError(f"max_models must be >= 1, got {max_models}")
        from .models.base import resolve_device
        self.device = resolve_device(device)
        self.max_models = int(max_models)
        self.capacity_bytes = (None if capacity_bytes is None
                               else int(capacity_bytes))
        self.batch_deadline_s = max(float(batch_deadline_s), 0.0)
        #: online deadline adaptation: a bounded AIMD controller moves
        #: each tenant's hold against its measured queue-wait and
        #: coalesce-hold split, between dispatches, within the registry's
        #: serveBatchDeadlineMs tuning bounds. TMOG_ADAPT=0 switches it
        #: off process-wide; off, the worker reads ``batch_deadline_s``.
        if os.environ.get("TMOG_ADAPT", "").strip() == "0":
            adapt_deadline = False
        self.adapt_deadline = bool(adapt_deadline)
        from . import config
        lo, hi = config.knob_bounds("serveBatchDeadlineMs")
        self._adapt_bounds_s = (max(lo, 0.0) / 1e3, hi / 1e3)
        self.max_queue = int(max_queue)
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.bucket_cap = bucket_cap
        #: the registry resolves versioned tenants and takes promotes and
        #: rollbacks; drift_window (rows) turns the sentinel on
        self._registry = registry
        self.drift_window = (None if drift_window is None
                             else int(drift_window))
        self.drift_js_threshold = float(drift_js_threshold)
        self.drift_fill_delta = float(drift_fill_delta)
        self.canary_fraction = float(canary_fraction)
        #: LRU order: oldest first; touched on every submit
        self._entries: "OrderedDict[str, _ModelEntry]" = OrderedDict()
        self._lock = locks.witness_lock("server.ModelServer._lock")
        self._closed = False
        #: per-tenant drift-window subscribers, attached again to every
        #: rebuilt sentinel (reload, eviction, promote)
        self._drift_subscribers: Dict[str, List[Any]] = {}
        #: the drift queue: workers enqueue scored record batches and one
        #: shared sentinel thread folds them into the tenants' sketches;
        #: a full queue drops batches (tallied) instead of slowing scoring
        self._drift_queue: Optional["queue.Queue[Any]"] = None
        self._drift_thread: Optional[threading.Thread] = None
        if self.drift_window:
            self._drift_queue = queue.Queue(maxsize=DRIFT_QUEUE_DEPTH)
            self._drift_thread = threading.Thread(
                target=self._drift_loop, name="serve-drift", daemon=True)
            self._drift_thread.start()

    @property
    def registry(self) -> Optional["lifecycle.ModelRegistry"]:
        return self._registry

    # -- registration / LRU ------------------------------------------------
    def register(self, name: str, model_dir: Optional[str] = None,
                 bank_dir: Optional[str] = None,
                 model: Any = None, preload: bool = False,
                 via_registry: bool = False) -> None:
        """Register a tenant: a saved-model directory (evictable, reloaded
        on demand) or a live ``WorkflowModel`` (pinned). ``bank_dir`` is
        the export directory with the program bank; ``preload`` loads now
        instead of on the first request. ``via_registry`` resolves the
        directories through the registry's ``current`` pointer on every
        (re)load, so a reload after an eviction picks up a promote."""
        if via_registry:
            if self._registry is None:
                raise RolloutError(
                    "register(via_registry=True) needs a registry "
                    "attached to the server")
            rec = self._registry.resolve(name)
            model_dir, bank_dir = rec["modelDir"], rec.get("bankDir")
        if model is None and model_dir is None:
            raise ValueError("register() needs model_dir or model")
        with self._lock:
            if self._closed:
                raise ServerClosed("server is shut down")
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            entry = _ModelEntry(name, model_dir, bank_dir, model,
                                self.max_queue)
            entry.via_registry = via_registry
            entry.worker = threading.Thread(
                target=self._worker_loop, args=(entry,),
                name=f"serve-{name}", daemon=True)
            self._entries[name] = entry
        entry.worker.start()
        if preload or model is not None:
            self._ensure_loaded(entry)

    def register_from_registry(self, name: str,
                               preload: bool = False) -> None:
        """Register a tenant that serves whatever the registry's
        ``current`` pointer names (and keeps resolving it)."""
        self.register(name, via_registry=True, preload=preload)

    def models(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def _ensure_loaded(self, entry: _ModelEntry):
        """Load (or reload) the entry's model, engine and bank, then evict
        LRU models over capacity. Returns ``(model, engine, bank_buckets)``
        captured under the entry lock: a dispatch scores through these,
        never through ``entry.model`` / ``entry.engine``, which a
        concurrent eviction may clear; the references keep the engine,
        its CUDA graphs and their memory alive until the batch is done."""
        with entry.lock:
            if entry.model is None:
                if entry.via_registry and self._registry is not None:
                    # a reloaded registry tenant resolves the pointer
                    # again: a promote made while it was out takes effect
                    try:
                        rec = self._registry.resolve(entry.name)
                        entry.model_dir = rec["modelDir"]
                        entry.bank_dir = rec.get("bankDir")
                    except RegistryError:
                        pass        # pointer gone: last-known dirs serve
                from .workflow import WorkflowModel
                with telemetry.span("server:load_model",
                                    model=entry.name):
                    entry.model = WorkflowModel.load(entry.model_dir)
                entry.loads += 1
                entry.sentinel = None       # rebuilt for the new model
                _tally("model_loads")
                telemetry.counter("server.model_loads").inc()
            if entry.engine is None:
                (entry.engine, entry.bank_buckets,
                 entry.bank_report) = self._build_engine(entry.model,
                                                         entry.bank_dir)
                entry.weight_bytes = self._entry_weight(entry)
            if entry.sentinel is None and self.drift_window:
                entry.sentinel = self._build_sentinel(entry.model,
                                                      entry.name)
            captured = (entry.model, entry.engine,
                        list(entry.bank_buckets))
        self._evict_over_capacity(keep=entry.name)
        return captured

    def _build_engine(self, model, bank_dir: Optional[str]):
        """(engine, bank_buckets, bank_report) of one loaded model on the
        server's device, shared by tenant and rollout-candidate loading.
        The engine is None when it fuses nothing (the tenant scores by
        layers on the same device)."""
        from .scoring import DEFAULT_BUCKET_CAP
        engine = model.scoring_engine(
            device=self.device,
            bucket_cap=int(self.bucket_cap or DEFAULT_BUCKET_CAP))
        if not engine.enabled():
            return None, [], None
        bank_buckets: List[int] = []
        bank_report: Optional[Dict[str, Any]] = None
        if bank_dir:
            bank_report = aot.load_program_bank(engine, bank_dir)
            bank_buckets = list(bank_report["loaded"])
            if bank_report["loaded"]:
                _tally("bank_loads")
        return engine, bank_buckets, bank_report

    def _build_sentinel(self, model, name: str):
        """The tenant's drift sentinel (None when the server runs without
        drift or the model has no saved baseline), with the registered
        drift subscribers attached."""
        if not self.drift_window:
            return None
        sentinel = lifecycle.DriftSentinel.for_model(
            model, model_name=name, window_rows=self.drift_window,
            js_threshold=self.drift_js_threshold,
            fill_delta_threshold=self.drift_fill_delta)
        if sentinel is not None:
            for fn in self._drift_subscribers.get(name, ()):
                sentinel.subscribe(fn)
        return sentinel

    def subscribe_drift(self, name: str, fn) -> None:
        """Subscribe ``fn(findings, report)`` to tenant ``name``'s
        completed drift windows (clean ones included); the subscription
        survives sentinel rebuilds."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise ModelNotFound(f"no model {name!r} registered "
                                f"(have: {self.models()})")
        # under the entry lock, as sentinel rebuilds are: a racing
        # rebuild sees the new subscriber or we attach to its sentinel
        with entry.lock:
            self._drift_subscribers.setdefault(name, []).append(fn)
            sentinel = entry.sentinel
            if sentinel is not None:
                sentinel.subscribe(fn)

    def _entry_weight(self, entry: _ModelEntry) -> int:
        """LRU weight: the bank's program bytes (``aot.bank_bytes``), at
        least 1 MiB so bankless models count against capacity too."""
        manifest, _ = (aot.read_manifest(entry.bank_dir)
                       if entry.bank_dir else (None, []))
        return max(aot.bank_bytes(manifest), 1 << 20)

    def _evict_over_capacity(self, keep: str) -> None:
        while True:
            victim = None
            with self._lock:
                loaded = [e for e in self._entries.values()
                          if e.model is not None and not e.pinned]
                n_loaded = sum(1 for e in self._entries.values()
                               if e.model is not None)
                total = sum(e.weight_bytes for e in self._entries.values()
                            if e.model is not None)
                over = (n_loaded > self.max_models
                        or (self.capacity_bytes is not None
                            and total > self.capacity_bytes))
                if over:
                    for e in loaded:         # LRU order: oldest first
                        if e.name != keep and e.queue.qsize() == 0:
                            victim = e
                            break
            if victim is None:
                return
            with victim.lock:
                if victim.model is None:
                    continue
                logger.info("server: evicting %s (LRU, %d bytes)",
                            victim.name, victim.weight_bytes)
                victim.model = None
                victim.engine = None
                victim.bank_buckets = []
                # a reload may resolve another version: the sentinel's
                # baseline belongs to the old model
                victim.sentinel = None
                _tally("model_evictions")
                telemetry.counter("server.model_evictions").inc()

    # -- request entry -----------------------------------------------------
    def submit(self, name: str, records: List[Dict[str, Any]],
               trace: Optional[tuple] = None):
        """Enqueue a scoring request; returns a
        ``concurrent.futures.Future[RequestResult]``. Raises
        :class:`ModelNotFound`, :class:`ServerBusy` or
        :class:`ServerClosed` at once. ``trace`` is the submitting request
        span's (trace_id, span_id), which the batch span links."""
        with self._lock:
            if self._closed:
                raise ServerClosed("server is shut down")
            entry = self._entries.get(name)
            if entry is not None:
                self._entries.move_to_end(name)    # LRU touch
        if entry is None:
            raise ModelNotFound(f"no model {name!r} registered "
                                f"(have: {self.models()})")
        req = _Request(records, trace=trace)
        try:
            entry.queue.put_nowait(req)
        except queue.Full:
            _tally("rejected")
            telemetry.counter("server.rejected").inc()
            raise ServerBusy(
                f"model {name!r} queue is full ({self.max_queue} "
                "pending) — back off and retry") from None
        if telemetry.enabled():
            telemetry.gauge(entry.metric_names["queue"]).set(  # lint: metric-name — per-tenant gauge, bounded by the registered roster
                entry.queue.qsize())
        return req.future

    def score(self, name: str, records: List[Dict[str, Any]],
              timeout_s: Optional[float] = 30.0) -> RequestResult:
        """Synchronous wrapper over :meth:`submit`."""
        return self.submit(name, records).result(timeout=timeout_s)

    # -- micro-batching worker ---------------------------------------------
    def _worker_loop(self, entry: _ModelEntry) -> None:
        from .scoring import DEFAULT_BUCKET_CAP
        cap = int(self.bucket_cap or DEFAULT_BUCKET_CAP)
        stop = False
        while not stop:
            item = entry.queue.get()
            if item is _SENTINEL:
                break
            item.t_dequeued = time.perf_counter()
            batch: List[_Request] = [item]
            rows = item.rows
            # the hold: the tenant's adapted deadline once the controller
            # moved it, else the configured one; read once a batch
            deadline = item.t_dequeued + (
                entry.deadline_s if entry.deadline_s is not None
                else self.batch_deadline_s)
            # hold the dispatch open until the deadline (or the bucket
            # cap) for co-riding requests
            while rows < cap:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = entry.queue.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True        # drain this batch, then exit
                    break
                nxt.t_dequeued = time.perf_counter()
                batch.append(nxt)
                rows += nxt.rows
            self._dispatch(entry, batch)
            if self.adapt_deadline:
                # between dispatches: the next batch reads the decision
                self._adapt_deadline(entry)
        # drain what is still queued after the sentinel (a draining
        # shutdown drops no request)
        leftovers: List[_Request] = []
        while True:
            try:
                item = entry.queue.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL:
                item.t_dequeued = time.perf_counter()
                leftovers.append(item)
        if leftovers:
            self._dispatch(entry, leftovers)

    def _dispatch(self, entry: _ModelEntry, batch: List[_Request]) -> None:
        """Route one merged batch: the worker's boundary that never
        raises. An exception a routing branch leaks fails this batch's
        futures and leaves the worker alive."""
        try:
            self._dispatch_routed(entry, batch)
        except Exception as e:  # lint: broad-except — the worker thread must survive any dispatch path
            logger.exception("server: dispatch for %s failed past the "
                             "dispatch rule", entry.name)
            for req in batch:
                _fail_future(req.future, e)

    def _dispatch_routed(self, entry: _ModelEntry,
                         batch: List[_Request]) -> None:
        """Score one merged batch on the tenant's model; a rollout in
        flight splits it (canary) or mirrors it (shadow)."""
        try:
            # captured under the entry lock: an eviction that clears
            # entry.model now cannot touch this batch
            model, eng, bank_buckets = self._ensure_loaded(entry)
        except Exception as e:  # lint: broad-except — a model that cannot load must fail ITS requests, not the server
            logger.exception("server: loading %s failed", entry.name)
            for req in batch:
                _fail_future(req.future, e)
            return
        rollout = entry.rollout
        if rollout is None:
            self._dispatch_group(entry, batch, model, eng, bank_buckets)
        elif rollout.mode == "canary":
            flags = [self._canaried(req, rollout.fraction)
                     for req in batch]
            stable = [r for r, c in zip(batch, flags) if not c]
            canary = [r for r, c in zip(batch, flags) if c]
            if stable:
                # the stable part runs the solo path: requests not sent
                # to the candidate stay bitwise those of a server without
                # a rollout
                self._dispatch_group(entry, stable, model, eng,
                                     bank_buckets)
            if canary:
                rollout.canary_requests += len(canary)
                lifecycle.tally("canary_requests", len(canary))
                if not self._dispatch_candidate(entry, canary, rollout):
                    # the candidate failed: its requests go to the stable
                    # model on the same device, and the rollout rolls back
                    self._rollback_rollout(
                        entry, rollout, "candidate dispatch failure")
                    self._dispatch_group(entry, canary, model, eng,
                                         bank_buckets)
        else:                                   # shadow
            primary = self._dispatch_group(entry, batch, model, eng,
                                           bank_buckets)
            self._shadow_observe(entry, batch, rollout, primary)
        # drift over all live records: hand the batch to the sentinel
        # thread (the worker never pays the sketch)
        if entry.sentinel is not None and self._drift_queue is not None:
            try:
                self._drift_queue.put_nowait(
                    (entry, [r for req in batch for r in req.records]))
            except queue.Full:
                # saturated: drop the observation, never the request
                lifecycle.tally("drift_dropped_batches")
        if entry.rollout is not None:
            self._rollout_tick(entry, entry.rollout, len(batch))

    def _score_records(self, model, eng, records, bucket: int):
        """Result columns of ``records``: through the engine pinned to
        ``bucket``, or by layers on the server's device when the tenant's
        engine fuses nothing."""
        if eng is not None:
            return eng.score_store(records, use_cache=False,
                                   bucket_min=bucket)
        return model.score(records, device=self.device, engine=False)

    def _fail_batch(self, entry: _ModelEntry, batch: List[_Request],
                    exc: BaseException, bucket: int) -> None:
        """A device failure: every unresolved future of ``batch`` fails
        with ``exc`` (counted, not quarantined: it is not data poison)."""
        for req in batch:
            if req.future.done():
                continue
            _tally("requests_failed")
            entry.failures += 1
            telemetry.counter("server.requests_failed").inc()
            seconds = time.perf_counter() - req.t_enqueued
            telemetry.emit("request", model=entry.name, rows=req.rows,
                           seconds=seconds, ok=False,
                           coalesced=len(batch), bucket=bucket,
                           slo_met=self._slo(seconds))
            _fail_future(req.future, exc)

    def _dispatch_group(self, entry: _ModelEntry, batch: List[_Request],
                        model, eng, bank_buckets: List[int]):
        """Score one group of requests and scatter the results back. A
        device failure fails the group's futures; another failure retries
        request by request through the same engine, and a request that
        fails alone is quarantined. Never raises. Returns ``(store,
        bucket, seconds)`` of the merged dispatch (store None when it did
        not serve) for the shadow comparer."""
        from .scoring import DEFAULT_BUCKET_CAP, bucket_for
        records = [r for req in batch for r in req.records]
        n = len(records)
        cap = eng.bucket_cap if eng is not None \
            else (self.bucket_cap or DEFAULT_BUCKET_CAP)
        bucket = bucket_for(n, int(cap)) if n else 0
        engine_tier = eng is not None
        # the batch span adopts the first traced member's trace id and
        # links every member request's span id
        member_traces = [req.trace for req in batch if req.trace]
        t0 = time.perf_counter()
        for req in batch:
            req.t_dispatch0 = t0
        store = None
        error: Optional[BaseException] = None
        if n:
            try:
                resilience.inject("server.dispatch", model=entry.name,
                                  rows=n, requests=len(batch))
                # the span's duration is the dispatch; queue wait and
                # coalesce hold (worst member) ride as args, computed only
                # while recording
                span_kw: Dict[str, Any] = {}
                if telemetry.enabled():
                    span_kw["queue_wait_s"] = round(max(
                        (req.t_dequeued - req.t_enqueued
                         for req in batch
                         if req.t_dequeued is not None),
                        default=0.0), 6)
                    span_kw["coalesce_hold_s"] = round(max(
                        (t0 - req.t_dequeued for req in batch
                         if req.t_dequeued is not None),
                        default=0.0), 6)
                with telemetry.trace_scope(
                        member_traces[0] if member_traces else None):
                    with telemetry.span(
                            "server:dispatch", model=entry.name,
                            rows=n, requests=len(batch), bucket=bucket,
                            links=[t[1] for t in member_traces],
                            **span_kw):
                        store = self._score_records(model, eng, records,
                                                    bucket)
            except Exception as e:  # lint: broad-except — the dispatch rule: a device failure fails the batch, any other is retried request by request on the same engine
                error = e
        disp_s = time.perf_counter() - t0
        self._account_batch(entry, n, len(batch),
                            engine_tier and bucket in bank_buckets)
        if error is not None and resilience.is_device_failure(error):
            logger.error("server: device failure in %s's dispatch (%d "
                         "requests fail): %r", entry.name, len(batch),
                         error)
            self._fail_batch(entry, batch, error, bucket)
            return None, bucket, disp_s
        if store is not None:
            t1 = time.perf_counter()
            for req in batch:
                req.t_dispatch1 = t1
                req.dispatch_s = disp_s
            self._scatter_store(entry, batch, store, bucket, engine_tier)
            return store, bucket, disp_s
        if error is not None:
            logger.warning("server: dispatch for %s failed (%r); its "
                           "requests are scored one at a time", entry.name,
                           error)
        for i, req in enumerate(batch):
            if not req.future.set_running_or_notify_cancel():
                continue
            # one request alone: the dispatch site fires again, so a chaos
            # plan can poison a single request
            try:
                req.t_dispatch0 = time.perf_counter()
                resilience.inject("server.dispatch", model=entry.name,
                                  rows=req.rows, requests=1)
                sub = self._score_records(model, eng, req.records, bucket)
                req.t_dispatch1 = time.perf_counter()
                req.dispatch_s = req.t_dispatch1 - req.t_dispatch0
            except Exception as e:  # lint: broad-except — a request that fails alone is poison: quarantined, unless the device failed
                if resilience.is_device_failure(e):
                    self._fail_batch(entry, batch[i:], e, bucket)
                    return None, bucket, disp_s
                resilience.quarantine(
                    "server.dispatch", repr(e), kind="batches",
                    model=entry.name, rows=req.rows,
                    records=req.records)
                _tally("quarantined_requests")
                _tally("requests_failed")
                entry.failures += 1
                telemetry.counter("server.requests_failed").inc()
                seconds = time.perf_counter() - req.t_enqueued
                telemetry.emit("request", model=entry.name,
                               rows=req.rows, seconds=seconds, ok=False,
                               coalesced=len(batch), bucket=bucket,
                               slo_met=self._slo(seconds))
                req.future.set_exception(e)
                continue
            self._complete(entry, req, sub, bucket, len(batch), engine_tier)
        return None, bucket, disp_s

    def _account_batch(self, entry: _ModelEntry, n: int, n_requests: int,
                       bank_hit: bool) -> None:
        """One dispatched batch's tallies (stable and candidate paths)."""
        entry.batches += 1
        _tally("batches")
        _tally("rows", n)
        if bank_hit:
            entry.bank_hit_batches += 1
            _tally("bank_hit_batches")
        if n_requests > 1:
            _tally("coalesced_requests", n_requests)
        telemetry.counter("server.batches").inc()

    def _scatter_store(self, entry: _ModelEntry, batch: List[_Request],
                       store, bucket: int, engine_tier: bool,
                       canary: bool = False,
                       rollout: Optional[_Rollout] = None) -> None:
        """Slice one scored store back onto its requests' futures (stable
        and candidate paths)."""
        lo = 0
        for req in batch:
            if not req.future.set_running_or_notify_cancel():
                lo += req.rows
                continue
            sub = store.take(np.arange(lo, lo + req.rows))
            lo += req.rows
            self._complete(entry, req, sub, bucket, len(batch),
                           engine_tier, canary=canary, rollout=rollout)

    # -- shadow / canary rollout -------------------------------------------
    @staticmethod
    def _canaried(req: _Request, fraction: float) -> bool:
        """Deterministic routing: a stable hash of the request's first
        record lands in the canary fraction or not, the same way in every
        worker and process. Empty or unserializable payloads take the
        stable path: routing never fails a request."""
        if not req.records:
            return False
        try:
            blob = json.dumps(req.records[0], sort_keys=True,
                              default=str).encode()
        except (TypeError, ValueError):
            return False
        h = int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(),
                           "big")
        return (h % 10_000) < int(round(fraction * 10_000))

    def _dispatch_candidate(self, entry: _ModelEntry,
                            batch: List[_Request],
                            rollout: _Rollout) -> bool:
        """Score one canary group on the rollout candidate. On any failure
        returns False without touching the futures: the caller sends the
        group to the stable model, so a broken candidate drops nothing."""
        from .scoring import bucket_for
        records = [r for req in batch for r in req.records]
        n = len(records)
        model, eng = rollout.model, rollout.engine
        if not n or eng is None:
            rollout.win_failures += bool(n)
            return not n
        bucket = bucket_for(n, int(eng.bucket_cap))
        member_traces = [req.trace for req in batch if req.trace]
        t0 = time.perf_counter()
        for req in batch:
            req.t_dispatch0 = t0
        try:
            resilience.inject("server.dispatch", model=entry.name,
                              rows=n, requests=len(batch), canary=True)
            with telemetry.trace_scope(
                    member_traces[0] if member_traces else None):
                with telemetry.span(
                        "server:canary_dispatch", model=entry.name,
                        rows=n, version=rollout.version, bucket=bucket,
                        links=[t[1] for t in member_traces]):
                    store = self._score_records(model, eng, records,
                                                bucket)
        except Exception:  # lint: broad-except — a failing candidate is rollout evidence; its requests go to the stable model
            rollout.win_failures += 1
            logger.exception(
                "server: canary dispatch for %s@%s failed; the group "
                "goes to the stable model", entry.name, rollout.version)
            return False
        disp_s = time.perf_counter() - t0
        for req in batch:
            req.t_dispatch1 = t0 + disp_s
            req.dispatch_s = disp_s
        self._account_batch(entry, n, len(batch),
                            bucket in rollout.bank_buckets)
        self._scatter_store(entry, batch, store, bucket, True,
                            canary=True, rollout=rollout)
        rollout.win_evidence += len(batch)
        return True

    def _shadow_observe(self, entry: _ModelEntry, batch: List[_Request],
                        rollout: _Rollout, primary) -> None:
        """Mirror one answered batch to the shadow candidate: its
        responses are discarded; prediction parity and the latency delta
        are recorded. It runs after the primary futures resolved, so no
        request waits on its shadow, but the tenant's worker does."""
        store, bucket, primary_s = primary
        if store is None:
            return                  # a batch retried alone: no mirror
        records = [r for req in batch for r in req.records]
        rollout.shadow_requests += len(batch)
        rollout.shadow_batches += 1
        rollout.primary_seconds += primary_s
        lifecycle.tally("shadow_requests", len(batch))
        t0 = time.perf_counter()
        try:
            cand = self._score_records(rollout.model, rollout.engine,
                                       records, bucket)
        except Exception:  # lint: broad-except — shadow failure is rollout evidence, never a served error
            rollout.win_failures += 1
            logger.exception("server: shadow dispatch for %s@%s failed",
                             entry.name, rollout.version)
            return
        rollout.shadow_seconds += time.perf_counter() - t0
        lo = 0
        for req in batch:
            idx = np.arange(lo, lo + req.rows)
            lo += req.rows
            if _stores_equal(store.take(idx), cand.take(idx)):
                rollout.parity_ok += 1
                lifecycle.tally("shadow_parity_ok")
            else:
                rollout.parity_mismatch += 1
                rollout.win_parity_mismatch += 1
                lifecycle.tally("shadow_parity_mismatch")
            rollout.win_evidence += 1

    def _rollout_tick(self, entry: _ModelEntry, rollout: _Rollout,
                      n_requests: int) -> None:
        """Advance the rollout's evaluation window after one dispatch:
        roll back on a failure signal, promote after ``promote_windows``
        consecutive clean windows."""
        rollout.win_requests += n_requests
        if rollout.win_failures:
            self._rollback_rollout(entry, rollout,
                                   "candidate failure")
            return
        if rollout.win_slo_missed:
            self._rollback_rollout(entry, rollout,
                                   "SLO breach on candidate traffic")
            return
        if rollout.win_requests < rollout.window_requests:
            return
        sentinel = entry.sentinel
        drift_now = sentinel.advisories if sentinel is not None else 0
        new_drift = drift_now - rollout.drift_seen
        rollout.drift_seen = drift_now  # lint: thread-escape — rollout counters are confined to the entry's single dispatch worker; deploy() initializes a NOT-yet-published rollout under entry.lock
        clean = ((new_drift == 0 or not rollout.drift_gate)
                 and rollout.win_parity_mismatch == 0)
        rollout.windows += 1
        if not clean:
            rollout.clean_windows = 0
        elif rollout.win_evidence > 0:
            rollout.clean_windows += 1
        # else: a window that never touched the candidate proves nothing;
        # it neither advances nor resets the promotion count
        rollout.win_requests = 0
        rollout.win_parity_mismatch = 0
        evidence = rollout.win_evidence
        rollout.win_evidence = 0
        logger.info("server: rollout window %d for %s@%s %s "
                    "(%d/%d clean, %d candidate-touching)",
                    rollout.windows, entry.name,
                    rollout.version, "clean" if clean else "NOT clean",
                    rollout.clean_windows, rollout.promote_windows,
                    evidence)
        if rollout.clean_windows >= rollout.promote_windows:
            self._promote_rollout(entry, rollout)

    def _promote_rollout(self, entry: _ModelEntry,
                         rollout: _Rollout) -> None:
        """Make the candidate the tenant's model and move the registry's
        ``current`` pointer (through the ``lifecycle.promote`` fault
        site). It runs on the tenant's worker between dispatches, so no
        request is in flight across it. A failed pointer swap rolls the
        rollout back; the stable model keeps serving. The pointer move and
        the swap happen under one hold of the entry lock after checking
        the rollout is still the entry's: a manual rollback that raced in
        wins."""
        promote_err: Optional[BaseException] = None
        with entry.lock:
            if entry.rollout is not rollout:
                return                      # aborted while we decided
            try:
                if self._registry is not None and rollout.version:
                    self._registry.promote(entry.name, rollout.version)
            except Exception as e:  # lint: broad-except — a failed pointer swap must leave the stable fleet serving (chaos-tested)
                logger.exception("server: promote of %s@%s failed; "
                                 "rolling back", entry.name,
                                 rollout.version)
                promote_err = e
            else:
                entry.model = rollout.model
                entry.engine = rollout.engine
                entry.bank_buckets = list(rollout.bank_buckets)
                entry.bank_report = rollout.bank_report
                if rollout.model_dir:
                    entry.model_dir = rollout.model_dir
                    entry.bank_dir = rollout.bank_dir
                entry.weight_bytes = self._entry_weight(entry)
                entry.sentinel = self._build_sentinel(entry.model,
                                                      entry.name)
                entry.rollout = None
        if promote_err is not None:
            self._rollback_rollout(entry, rollout,
                                   f"promote failed: {promote_err!r}")
            return
        lifecycle.tally("auto_promotions")
        telemetry.emit("rollout", model=entry.name, action="promote",
                       version=rollout.version, mode=rollout.mode,
                       windows=rollout.windows)
        logger.info("server: %s promoted to %s after %d clean window(s)",
                    entry.name, rollout.version, rollout.clean_windows)

    def _rollback_rollout(self, entry: _ModelEntry, rollout: _Rollout,
                          reason: str) -> None:
        """Abort the rollout: the candidate is dropped, the stable model
        keeps serving, the registry pointer is untouched."""
        with entry.lock:
            if entry.rollout is rollout:
                entry.rollout = None
        lifecycle.tally("auto_rollbacks")
        telemetry.counter("server.rollbacks").inc()
        telemetry.emit("rollout", model=entry.name, action="rollback",
                       version=rollout.version, mode=rollout.mode,
                       reason=reason)
        logger.warning("server: rollout of %s@%s rolled back: %s",
                       entry.name, rollout.version, reason)

    def deploy(self, name: str, version: str, mode: str = "shadow",
               fraction: Optional[float] = None,
               window_requests: int = DEFAULT_ROLLOUT_WINDOW_REQUESTS,
               promote_windows: int = DEFAULT_PROMOTE_WINDOWS,
               drift_gate: bool = True) -> Dict[str, Any]:
        """Start a shadow or canary rollout of registry ``version`` on
        tenant ``name``.

        ``mode="shadow"`` mirrors every request to the candidate
        (responses discarded; parity and latency delta recorded);
        ``mode="canary"`` routes a deterministic hash ``fraction`` of
        requests to it. After ``promote_windows`` consecutive clean
        windows of ``window_requests`` requests the candidate is promoted
        (registry pointer and model swap); a candidate failure or SLO
        breach rolls back. ``drift_gate=False`` leaves new drift
        advisories out of the clean-window test. Returns the rollout's
        status."""
        if mode not in ("shadow", "canary"):
            raise RolloutError(
                f"deploy mode must be 'shadow' or 'canary', got {mode!r}")
        if self._registry is None:
            raise RolloutError("deploy() needs a registry attached to "
                               "the server (ModelServer(registry=...))")
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise ModelNotFound(f"no model {name!r} registered "
                                f"(have: {self.models()})")
        rec = self._registry.record(name, version)
        frac = float(self.canary_fraction if fraction is None
                     else fraction)
        if mode == "canary" and not 0.0 < frac <= 1.0:
            raise RolloutError(
                f"canary fraction must be in (0, 1], got {frac!r}")
        # the candidate loads outside the entry lock; the stable model
        # serves meanwhile
        from .workflow import WorkflowModel
        with telemetry.span("server:load_candidate", model=name,
                            version=str(version)):
            cand = WorkflowModel.load(rec["modelDir"])
            engine, bank_buckets, bank_report = self._build_engine(
                cand, rec.get("bankDir"))
        if mode == "canary" and engine is None:
            raise RolloutError(
                f"version {version!r} of {name!r} has no fused scoring "
                "program; canary needs one — use mode='shadow' to "
                "evaluate a layer-path candidate")
        rollout = _Rollout(mode=mode, version=str(version), fraction=frac,
                           model=cand, engine=engine,
                           bank_buckets=bank_buckets,
                           bank_report=bank_report,
                           model_dir=rec["modelDir"],
                           bank_dir=rec.get("bankDir"),
                           window_requests=window_requests,
                           promote_windows=promote_windows,
                           drift_gate=drift_gate)
        with entry.lock:
            if entry.rollout is not None:
                raise RolloutError(
                    f"model {name!r} already has an active "
                    f"{entry.rollout.mode} rollout of version "
                    f"{entry.rollout.version}")
            sentinel = entry.sentinel
            if sentinel is not None:
                rollout.drift_seen = sentinel.advisories
            entry.rollout = rollout
        lifecycle.tally("deploys")
        telemetry.emit("rollout", model=name, action="deploy",
                       version=str(version), mode=mode, fraction=frac)
        logger.info("server: %s rollout of %s@%s started (fraction=%g)",
                    mode, name, version, frac)
        return rollout.status()

    def rollback(self, name: str) -> Dict[str, Any]:
        """Manual rollback: abort the rollout in flight (the stable model
        served all along); without one, swing the registry pointer back to
        ``previous`` and make the tenant reload through it."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise ModelNotFound(f"no model {name!r} registered "
                                f"(have: {self.models()})")
        with entry.lock:
            rollout, entry.rollout = entry.rollout, None
        if rollout is not None:
            telemetry.counter("server.rollbacks").inc()
            telemetry.emit("rollout", model=name, action="rollback",
                           version=rollout.version, mode=rollout.mode,
                           reason="manual")
            logger.info("server: rollout of %s@%s aborted manually",
                        name, rollout.version)
            return {"model": name, "aborted": rollout.version,
                    "mode": rollout.mode}
        if self._registry is None:
            raise RolloutError("rollback() without a rollout needs a "
                               "registry attached to the server")
        prev = self._registry.rollback(name)
        rec = self._registry.record(name, prev)
        with entry.lock:
            entry.model = None
            entry.engine = None
            entry.bank_buckets = []
            entry.sentinel = None
            entry.model_dir = rec["modelDir"]
            entry.bank_dir = rec.get("bankDir")
        return {"model": name, "rolledBackTo": prev}

    def _drift_loop(self) -> None:
        """The shared sentinel thread: fold queued record batches into
        their tenant's sliding sketches, merging a backlog into passes of
        up to ``DRIFT_COALESCE_ROWS`` rows and throttled to
        ``DRIFT_DUTY_CYCLE`` of the host CPU. Any failure of an item is
        tallied (``lifecycle.sentinel_errors``), its queue items are still
        accounted, and the thread lives."""
        held = None
        while True:
            item = held if held is not None else self._drift_queue.get()
            held = None
            if item is None:                # shutdown sentinel
                self._drift_queue.task_done()
                return
            taken = 1
            stop = False
            t0 = time.perf_counter()
            try:
                entry, records = item
                while len(records) < DRIFT_COALESCE_ROWS:
                    try:
                        nxt = self._drift_queue.get_nowait()
                    except queue.Empty:
                        break
                    # count the take first: a poison item that raises
                    # below is still accounted in the finally
                    taken += 1
                    if nxt is None:         # shutdown sentinel mid-burst
                        stop = True
                        break
                    if nxt[0] is not entry:
                        held = nxt          # another tenant: next round
                        taken -= 1          # its task_done rides with it
                        break
                    records = records + nxt[1]
                sentinel = entry.sentinel
                if sentinel is not None:
                    with telemetry.span("server:drift_observe",
                                        model=entry.name,
                                        rows=len(records)):
                        sentinel.observe(records)
            except Exception:  # lint: broad-except — drift observation must never take down its thread (catch-and-tally, keep serving)
                lifecycle.tally("sentinel_errors")
                logger.exception("server: drift observation failed "
                                 "(tallied sentinel_errors; the "
                                 "sentinel thread lives)")
            finally:
                for _ in range(taken):
                    self._drift_queue.task_done()
            if stop:
                return
            dt = time.perf_counter() - t0
            if dt > 0 and held is None:
                time.sleep(min(dt * (1.0 / DRIFT_DUTY_CYCLE - 1.0), 2.0))

    def drain_drift(self) -> None:
        """Block until every queued drift observation is folded."""
        if self._drift_queue is not None:
            self._drift_queue.join()

    def lifecycle_status(self, name: str) -> Dict[str, Any]:
        """Registry versions, pointer, and the live rollout and drift
        state of one tenant: the ``/v1/models/<name>/versions`` document."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise ModelNotFound(f"no model {name!r} registered "
                                f"(have: {self.models()})")
        rollout = entry.rollout
        sentinel = entry.sentinel
        doc: Dict[str, Any] = {
            "model": name,
            "rollout": rollout.status() if rollout else None,
            "drift": sentinel.stats() if sentinel else None}
        if self._registry is not None:
            try:
                doc.update(self._registry.status(name))
            except RegistryError as e:
                doc["registryError"] = str(e)
        return doc

    def _slo(self, seconds: float) -> Optional[bool]:
        if self.slo_ms is None:
            return None
        met = seconds * 1e3 <= self.slo_ms
        _tally("slo_met" if met else "slo_missed")
        return met

    # -- online deadline adaptation ----------------------------------------
    def _adapt_deadline(self, entry: _ModelEntry) -> None:
        """Bounded AIMD controller of one tenant's micro-batching hold,
        from the medians of its queue-wait and coalesce-hold reservoirs;
        it runs on the tenant's worker between dispatches. It holds until
        ``ADAPT_WINDOW_REQUESTS`` new requests completed and while the two
        medians are within ``ADAPT_DEADBAND`` of each other; it halves the
        hold when queue wait dominates and adds ``ADAPT_STEP_S`` when the
        hold dominates, clamped to the registry's serveBatchDeadlineMs
        tuning bounds. A converged hold more than ``ADAPT_ADVISORY_RATIO``
        from the configured one raises TMG406 once."""
        if entry.requests - entry.adapt_seen < ADAPT_WINDOW_REQUESTS:
            return
        entry.adapt_seen = entry.requests
        _tally("deadline_adapt_windows")
        window = ADAPT_WINDOW_REQUESTS
        qw = list(entry.decomp["queueWait"])[-window:]
        ch = list(entry.decomp["coalesceHold"])[-window:]
        if not qw or not ch:
            _tally("deadline_holds")
            return
        qw_med = float(np.median(np.asarray(qw, dtype=np.float64)))
        ch_med = float(np.median(np.asarray(ch, dtype=np.float64)))
        cur = (entry.deadline_s if entry.deadline_s is not None
               else self.batch_deadline_s)
        eps = 1e-9
        if qw_med > ch_med * ADAPT_DEADBAND and qw_med > eps:
            nxt = cur * ADAPT_MD_FACTOR
            direction = "decrease"
        elif ch_med > qw_med * ADAPT_DEADBAND:
            nxt = cur + ADAPT_STEP_S
            direction = "increase"
        else:
            _tally("deadline_holds")
            return
        lo, hi = self._adapt_bounds_s
        clamped = min(max(nxt, lo), hi)
        if clamped != nxt:
            entry.adapt_clamped += 1
            _tally("deadline_clamped")
        if clamped == cur:
            _tally("deadline_holds")
            return
        entry.deadline_s = clamped
        if direction == "increase":
            entry.adapt_increases += 1
            _tally("deadline_increases")
        else:
            entry.adapt_decreases += 1
            _tally("deadline_decreases")
        telemetry.emit("deadline_adapt", model=entry.name,
                       direction=direction,
                       deadline_ms=clamped * 1e3,
                       queue_wait_med_s=qw_med,
                       coalesce_hold_med_s=ch_med)
        base = self.batch_deadline_s
        if not entry.deadline_advised and base > 0 and (
                clamped >= base * ADAPT_ADVISORY_RATIO
                or clamped <= base / ADAPT_ADVISORY_RATIO):
            entry.deadline_advised = True
            _tally("deadline_advisories")
            from . import lint
            finding = lint.Finding(
                "TMG406",
                f"model {entry.name!r}: the online controller "
                f"converged batch_deadline_s to {clamped * 1e3:.3f} ms "
                f"but the params file configured "
                f"{base * 1e3:.3f} ms — live telemetry contradicts the "
                f"tuned config; re-tune serveBatchDeadlineMs against a "
                f"fresh recording")
            lint.emit_findings([finding])
            logger.warning("serve: %s", finding.format())

    def _observe_decomp(self, entry: _ModelEntry, req: _Request,
                        now: float) -> Dict[str, float]:
        """Fold one completed request's latency decomposition into the
        per-model reservoirs (``/stats``) and histograms (``/metrics``);
        a phase that was skipped is not recorded. Returns the phases
        measured."""
        phases: Dict[str, float] = {}
        if req.t_dequeued is not None:
            phases["queueWait"] = max(req.t_dequeued - req.t_enqueued,
                                      0.0)
            if req.t_dispatch0 is not None:
                phases["coalesceHold"] = max(
                    req.t_dispatch0 - req.t_dequeued, 0.0)
        if req.dispatch_s is not None:
            phases["deviceDispatch"] = req.dispatch_s
        if req.t_dispatch1 is not None:
            phases["scatter"] = max(now - req.t_dispatch1, 0.0)
        on = telemetry.enabled()
        for ph, v in phases.items():
            entry.decomp[ph].append(v)
            if on:
                telemetry.histogram(  # lint: metric-name — per-tenant decomposition, bounded by the registered roster
                    entry.metric_names[ph]).observe(v)
        return phases

    def _complete(self, entry: _ModelEntry, req: _Request, store,
                  bucket: int, coalesced: int, engine_tier: bool,
                  canary: bool = False,
                  rollout: Optional[_Rollout] = None) -> None:
        now = time.perf_counter()
        seconds = now - req.t_enqueued
        entry.requests += 1
        entry.rows += req.rows
        entry.latencies.append(seconds)
        decomp = self._observe_decomp(entry, req, now)
        _tally("requests")
        telemetry.counter("server.requests").inc()
        telemetry.counter("server.rows_scored").inc(req.rows)
        if telemetry.enabled():
            telemetry.histogram(  # lint: metric-name — per-tenant latency, bounded by the registered roster
                entry.metric_names["request"]).observe(seconds)
            telemetry.gauge(  # lint: metric-name — per-tenant gauge, bounded by the registered roster
                entry.metric_names["queue"]).set(entry.queue.qsize())
        slo_met = self._slo(seconds)
        if rollout is not None and slo_met is False:
            # candidate traffic missing the SLO rolls the rollout back
            rollout.win_slo_missed += 1
        telemetry.emit("request", model=entry.name, rows=req.rows,
                       seconds=seconds, ok=True, coalesced=coalesced,
                       bucket=bucket, slo_met=slo_met)
        req.future.set_result(RequestResult(
            store=store, rows=req.rows, bucket=bucket,
            coalesced=coalesced, seconds=seconds,
            engine_tier=engine_tier, canary=canary, decomp=decomp))

    # -- stats / shutdown --------------------------------------------------
    @property
    def closing(self) -> bool:
        """True once :meth:`shutdown` began: ``/healthz`` answers 503."""
        return self._closed

    def readiness(self) -> Dict[str, Any]:
        """Ready iff not closing, at least one tenant, every tenant
        loadable (loaded, or saved on disk), and the summed queue depth
        leaves at least ``READY_MIN_HEADROOM`` of the capacity free. The
        ``/readyz`` document; ``reasons`` names what failed."""
        with self._lock:
            closed = self._closed
            entries = list(self._entries.items())
        depth = sum(e.queue.qsize() for _, e in entries)
        capacity = self.max_queue * len(entries)
        headroom = (1.0 - depth / capacity) if capacity else 0.0
        loaded = [n for n, e in entries if e.model is not None]
        unloadable = [n for n, e in entries
                      if e.model is None and not e.model_dir]
        reasons: List[str] = []
        if closed:
            reasons.append("closing")
        if not entries:
            reasons.append("no models registered")
        if unloadable:
            reasons.append(f"tenants not loadable: {unloadable}")
        if entries and headroom < READY_MIN_HEADROOM:
            reasons.append(
                f"queue headroom {headroom:.3f} < {READY_MIN_HEADROOM}")
        return {"ready": not reasons, "reasons": reasons,
                "models": len(entries), "loadedModels": loaded,
                "queueDepth": depth,
                "queueHeadroom": round(headroom, 4)}

    def stats(self) -> Dict[str, Any]:
        """The server's tallies and per-model stats (exact p50/p95/p99
        over the latency window)."""
        with self._lock:
            entries = list(self._entries.items())
        return {"server": server_stats(),
                "lifecycle": lifecycle.lifecycle_stats(),
                "sloMs": self.slo_ms,
                "driftWindow": self.drift_window,
                "batchDeadlineMs": self.batch_deadline_s * 1e3,
                "adaptDeadline": self.adapt_deadline,
                "adaptBoundsMs": [
                    round(self._adapt_bounds_s[0] * 1e3, 4),
                    (None if self._adapt_bounds_s[1] == float("inf")
                     else round(self._adapt_bounds_s[1] * 1e3, 4))],
                "models": {name: e.stats() for name, e in entries}}

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = 30.0) -> None:
        """Stop taking requests and stop the workers. With ``drain`` (the
        default) every queued request is scored first; without it,
        queued futures fail with :class:`ServerClosed`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._entries.values())
        for e in entries:
            if not drain:
                while True:
                    try:
                        item = e.queue.get_nowait()
                    except queue.Empty:
                        break
                    if item is not _SENTINEL and \
                            item.future.set_running_or_notify_cancel():
                        item.future.set_exception(
                            ServerClosed("server shut down (no drain)"))
            e.queue.put(_SENTINEL)
        for e in entries:
            if e.worker is not None:
                e.worker.join(timeout=timeout_s)
        if self._drift_thread is not None:
            if drain:
                self._drift_queue.join()
            # a no-drain shutdown never blocks on a full queue: drop
            # observations until the sentinel fits
            while True:
                try:
                    self._drift_queue.put_nowait(None)
                    break
                except queue.Full:
                    try:
                        self._drift_queue.get_nowait()
                        self._drift_queue.task_done()
                    except queue.Empty:
                        pass
            self._drift_thread.join(timeout=timeout_s)


def _stores_equal(a, b) -> bool:
    """Bitwise prediction parity of two result stores over their shared
    columns (the shadow comparer's oracle)."""
    names = [n for n in a.names() if n in b]
    if not names:
        return False
    for n in names:
        ca, cb = a[n], b[n]
        if type(ca) is not type(cb):
            return False
        if hasattr(ca, "prediction"):
            for fld in ("prediction", "raw_prediction", "probability"):
                if not np.array_equal(getattr(ca, fld),
                                      getattr(cb, fld)):
                    return False
        elif hasattr(ca, "mask") and hasattr(ca, "values"):
            if not np.array_equal(ca.mask, cb.mask):
                return False
            va, vb = np.asarray(ca.values), np.asarray(cb.values)
            equal = (np.array_equal(va, vb, equal_nan=True)
                     if va.dtype.kind == "f" and vb.dtype.kind == "f"
                     else np.array_equal(va, vb))
            if not equal:
                return False
        elif hasattr(ca, "values"):
            if list(ca.values) != list(cb.values):
                return False
    return True


# ---------------------------------------------------------------------------
# stdlib HTTP front end
# ---------------------------------------------------------------------------


class HTTPListener(ThreadingHTTPServer):
    """The stdlib threading HTTP server of ``serve_http`` and the fleet's
    router, with a listen backlog a burst of clients fits in (a replay,
    a router's fan-in): socketserver's default of 5 drops the rest,
    which then wait a second for the SYN retry or fail."""

    daemon_threads = True
    request_queue_size = 128


def _store_rows(store) -> List[Dict[str, Any]]:
    return [{nm: store[nm].get_raw(i) for nm in store.names()}
            for i in range(store.n_rows)]


#: the HTTP handler's future timed out (the 504 path)
_TIMED_OUT = object()


def serve_http(server: ModelServer, host: str = "127.0.0.1",
               port: int = 8000, request_timeout_s: float = 30.0):
    """Start the stdlib HTTP front end on a daemon thread; returns the
    ``ThreadingHTTPServer`` (``.server_address`` has the bound port,
    ``.shutdown()`` stops it)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # route through logging
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, doc: Optional[Dict[str, Any]],
                  headers: Optional[Dict[str, str]] = None,
                  raw: Optional[bytes] = None) -> None:
            body = (raw if raw is not None
                    else json.dumps(doc, default=str).encode())
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, body: bytes,
                       content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                # the telemetry registry in Prometheus text, plus the
                # always-on tallies as server_tally_* gauges (a prefix
                # distinct from the telemetry counters' server_* family,
                # which a second type would make invalid exposition)
                extra = {f"server_tally_{k}": float(v)
                         for k, v in server_stats().items()
                         if isinstance(v, int)
                         and not isinstance(v, bool)}
                body = telemetry.render_prometheus(extra=extra).encode()
                return self._send_text(
                    200, body, "text/plain; version=0.0.4")
            if self.path == "/healthz":
                if server.closing:
                    return self._send(503, {"status": "draining",
                                            "models": server.models()})
                return self._send(200, {"status": "ok",
                                        "models": server.models()})
            if self.path == "/readyz":
                doc = server.readiness()
                return self._send(200 if doc["ready"] else 503, doc)
            if self.path == "/stats":
                return self._send(200, server.stats())
            if self.path == "/v1/models":
                return self._send(200, {"models": server.stats()["models"]})
            if (self.path.startswith("/v1/models/")
                    and self.path.endswith("/versions")):
                name = self.path[len("/v1/models/"):-len("/versions")]
                try:
                    return self._send(200, server.lifecycle_status(name))
                except ModelNotFound as e:
                    return self._send(404, {"error": str(e)})
                except (RolloutError, RegistryError) as e:
                    return self._send(400, {"error": str(e)})
            return self._send(404, {"error": f"no route {self.path!r}"})

        def _body(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_POST(self):
            path = self.path
            if not path.startswith("/v1/models/"):
                return self._send(404, {"error": f"no route {path!r}"})
            # the workload flight recorder: every :score request leaves
            # one record through the recorder's bounded queue, failures
            # too (a replay sees the 4xx/5xx mix); a no-op when no
            # recorder is installed
            wl_t0 = time.perf_counter()
            wl_rows = [0]
            wl_trace: List[Optional[str]] = [None]

            def _wl_fail(code: int, exc: BaseException) -> None:
                if (path.endswith(":score")
                        and workload.recording_enabled()):
                    workload.record_request(
                        model=path[len("/v1/models/"):-len(":score")],
                        rows=wl_rows[0], trace_id=wl_trace[0],
                        t_arrival=wl_t0,
                        outcome={"status": code, "ok": False,
                                 "error": type(exc).__name__},
                        phases={"e2e": time.perf_counter() - wl_t0})
            try:
                if path.endswith(":deploy"):
                    name = path[len("/v1/models/"):-len(":deploy")]
                    doc = self._body()
                    kw = {}
                    if doc.get("fraction") is not None:
                        kw["fraction"] = float(doc["fraction"])
                    if doc.get("windowRequests") is not None:
                        kw["window_requests"] = int(doc["windowRequests"])
                    if doc.get("promoteWindows") is not None:
                        kw["promote_windows"] = int(doc["promoteWindows"])
                    return self._send(200, {
                        "model": name,
                        "rollout": server.deploy(
                            name, doc.get("version"),
                            mode=doc.get("mode", "shadow"), **kw)})
                if path.endswith(":rollback"):
                    name = path[len("/v1/models/"):-len(":rollback")]
                    return self._send(200, server.rollback(name))
                if not path.endswith(":score"):
                    return self._send(404, {"error": f"no route {path!r}"})
                name = path[len("/v1/models/"):-len(":score")]
                # the raw body outlives the parse: the recorder splices
                # its bytes into the record without serializing again
                length = int(self.headers.get("Content-Length", 0))
                raw_body = self.rfile.read(length) or b"{}"
                doc = json.loads(raw_body)
                records = doc.get("records")
                if not isinstance(records, list) or not records:
                    return self._send(400, {
                        "error": "body must be {\"records\": [..]} with "
                                 "at least one record"})
                # a minted X-Tmog-Trace header joins this request's spans
                # to the caller's trace; with telemetry on and no header,
                # the request mints its own. The request span's identity
                # rides into the batcher (submit(trace=)) and back in the
                # response header.
                wl_rows[0] = len(records)
                ctx = telemetry.parse_traceparent(
                    self.headers.get(telemetry.TRACE_HEADER))
                if ctx is None and telemetry.enabled():
                    ctx = telemetry.mint_trace()
                trace_hdr = (telemetry.format_traceparent(*ctx)
                             if ctx else None)
                wl_trace[0] = ctx[0] if ctx else None
                with telemetry.trace_scope(ctx):
                    with telemetry.span("server:request", model=name,
                                        rows=len(records)) as rsp:
                        fut = server.submit(
                            name, records,
                            trace=((rsp.trace_id, rsp.span_id)
                                   if rsp.span_id else ctx))
                        try:
                            res = fut.result(
                                timeout=request_timeout_s)
                        except FuturesTimeout:
                            res = _TIMED_OUT
                if res is _TIMED_OUT:
                    # answer 504 and account for the future: a cancel
                    # that wins means the worker skips it; otherwise the
                    # dispatch owns it and its late completion is tallied
                    _tally("requests_timed_out")
                    telemetry.counter("server.requests_timed_out").inc()
                    if not fut.cancel():
                        def _late(f: "Future[RequestResult]") -> None:
                            _tally("timed_out_completions")
                            if not f.cancelled():
                                f.exception()
                        fut.add_done_callback(_late)
                    if workload.recording_enabled():
                        workload.record_request(
                            model=name, rows=len(records),
                            payload_json=raw_body, trace_id=wl_trace[0],
                            t_arrival=wl_t0,
                            outcome={"status": 504, "ok": False,
                                     "error": "timeout"},
                            phases={"e2e": time.perf_counter() - wl_t0})
                    return self._send(504, {
                        "error": f"timed out after "
                                 f"{request_timeout_s:g}s",
                        "model": name, "rows": len(records)})
            except ModelNotFound as e:
                _wl_fail(404, e)
                return self._send(404, {"error": str(e)})
            except (RolloutError, RegistryError, TypeError,
                    ValueError) as e:
                _wl_fail(400, e)
                if isinstance(e, json.JSONDecodeError):
                    return self._send(400,
                                      {"error": f"bad JSON body: {e}"})
                return self._send(400, {"error": str(e)})
            except ServerBusy as e:
                _wl_fail(429, e)
                return self._send(429, {"error": str(e)})
            except ServerClosed as e:
                _wl_fail(503, e)
                return self._send(503, {"error": str(e)})
            except Exception as e:  # lint: broad-except — HTTP boundary: a poison request answers 500, the server lives
                _wl_fail(500, e)
                return self._send(500, {"error": repr(e)})
            phases = {k: round(v, 6)
                      for k, v in (res.decomp or {}).items()}
            phases["e2e"] = round(res.seconds, 6)
            resp_body = json.dumps({
                "model": name, "rows": res.rows, "bucket": res.bucket,
                "coalesced": res.coalesced,
                "latencyMs": round(res.seconds * 1e3, 3),
                "engineTier": res.engine_tier,
                "canary": res.canary,
                "phases": phases,
                "outputs": _store_rows(res.store)},
                default=str).encode()
            if workload.recording_enabled():
                # both bodies were serialized for this request anyway:
                # the recorder splices the bytes, so the request pays
                # one bounded-queue put
                workload.record_request(
                    model=name, rows=res.rows,
                    payload_json=raw_body, response_json=resp_body,
                    trace_id=wl_trace[0], t_arrival=wl_t0,
                    outcome={"status": 200, "ok": True},
                    phases=phases)
            return self._send(200, None, raw=resp_body,
                              headers=({telemetry.TRACE_HEADER:
                                        trace_hdr}
                                       if trace_hdr else None))

    httpd = HTTPListener((host, port), Handler)
    t = threading.Thread(target=httpd.serve_forever,
                         name="serve-http", daemon=True)
    t.start()
    logger.info("model server HTTP front end on %s:%d",
                *httpd.server_address)
    return httpd
