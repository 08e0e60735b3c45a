"""Run telemetry — span tracer, metrics registry, RunListener; the port
of ``transmogrifai_tpu/telemetry.py``.

The reference ships a dedicated observability layer: ``OpSparkListener``
(``utils/.../spark/OpSparkListener.scala:56``) subscribes to Spark's event
bus and folds per-stage timings into an ``AppMetrics`` document the runner
writes next to its results. This module is that layer for the port, where
the events are the workflow's layers and stage fits, the fused statistics
pass, the scoring engine's bucketed dispatches and the temporal tier:

* **Span tracer** — ``with span("fit:stage", uid=...)``: thread-safe,
  nested, per-thread track ids, exported as Chrome trace-event JSON
  (``write_trace``) loadable in Perfetto / ``chrome://tracing``, and as
  per-process shards (``write_trace_shard``) that ``merge_trace_shards``
  stitches on one clock.
* **Metrics registry** — counters / gauges / histograms
  (``counter("scoring.cache_hits").inc()``) with JSON (``metrics_json``)
  and Prometheus text-exposition (``render_prometheus``) export.
* **RunListener protocol** — ``on_run_start / on_layer_start /
  on_stage_fit / on_stats_pass / on_score_batch / on_lint / on_plan /
  on_run_end`` mirroring OpSparkListener's callbacks;
  :class:`CollectingRunListener` folds them into an AppMetrics-style
  summary the runner embeds in its metrics doc.
* **Device seconds** — :func:`device_timer` times a dispatch by a pair of
  CUDA events on the stream the work runs on, read only after a
  synchronisation the caller makes anyway; :func:`device_cost_stats` is
  the runner's ``mfu`` block.

Telemetry is **off by default and near-zero-cost when off**: every entry
point checks the module-level ``_ENABLED`` flag before allocating
anything — ``span()`` returns a shared no-op singleton, ``counter()`` /
``gauge()`` / ``histogram()`` return shared null instruments,
``device_timer()`` the shared null timer (no CUDA event is made), and
``emit()`` returns immediately. Enable with :func:`enable`, or through
``OpParams`` (``customParams.telemetry`` / ``traceDir``,
``traceLocation``, ``metricsFormat: "prometheus"``, or the
``TMOG_TRACE_DIR`` environment variable), which turns it on for that run
only. Telemetry never catches a device or kernel error: the only
exception it swallows is a listener's (logged, in :func:`emit`).

Not carried over from the JAX package: the ``jax.monitoring`` compile
listener (the port compiles nothing while it runs, :func:`compile_clock_s`)
and the host-to-device link probe.
"""
from __future__ import annotations

import bisect
import json
import logging
import os
import re
import threading
import time

from collections import OrderedDict

from .utils import locks
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "enable", "disable", "enabled", "reset",
    "span", "trace_events", "write_trace",
    "counter", "gauge", "histogram", "metrics_json", "render_prometheus",
    "write_metrics",
    "RunListener", "CollectingRunListener",
    "add_listener", "remove_listener", "listeners", "emit",
    "compile_clock_s", "peak_rss_mb", "current_span_stack",
    # cross-process tracing
    "TRACE_HEADER", "TRACE_ENV", "TRACE_ROLE_ENV", "TMOG_TRACE_DIR",
    "mint_trace", "parse_traceparent",
    "format_traceparent", "current_trace", "trace_scope",
    "set_trace_role", "trace_role",
    "write_trace_shard", "merge_trace_shards", "write_merged_trace",
    # Prometheus exposition helpers (the /metrics plane)
    "parse_prometheus", "render_prometheus_sum",
    "merge_parsed_prometheus",
    # executed-FLOP attribution (the MFU block)
    "record_device_work", "device_timer", "settle_device_timers",
    "device_cost_stats", "reset_device_cost", "telemetry_stats",
    "PEAK_FLOPS",
]

# ---------------------------------------------------------------------------
# enabled flag — checked before ANY allocation on every hot path
# ---------------------------------------------------------------------------

_ENABLED = False

#: relative-time epoch for trace timestamps (monotonic; NTP steps cannot
#: corrupt recorded durations — the reason every timer here is
#: ``perf_counter``, never ``time.time``)
_EPOCH = time.perf_counter()

_PID = os.getpid()

_LOCK = locks.witness_lock("telemetry._LOCK", reentrant=True)

#: dedicated event-buffer lock: span exits (every traced hot path, on
#: every thread) append here, so the buffer does not share the registry
#: RLock that every counter and histogram creation takes
_EVENTS_LOCK = locks.witness_lock("telemetry._EVENTS_LOCK")

#: recorded Chrome trace events (dicts, ph "X" for spans + "M" metadata)
_EVENTS: List[Dict[str, Any]] = []

#: hard cap so a forgotten enable() in a long-lived server cannot eat the
#: heap; overflow is counted, never silent
_MAX_EVENTS = 1_000_000
_DROPPED_EVENTS = [0]

#: thread ident -> small stable track id for the trace
_TRACKS: Dict[int, int] = {}

_TLS = threading.local()


def enabled() -> bool:
    """True when telemetry is recording."""
    return _ENABLED


def enable() -> None:
    """Turn telemetry on (spans recorded, metrics counted, listeners
    dispatched, device work timed by CUDA events). Idempotent."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Stop recording. Already-recorded events/metrics stay exportable."""
    global _ENABLED
    _ENABLED = False


def reset(keep_listeners: bool = False) -> None:
    """Drop all recorded events and metrics — and, unless
    ``keep_listeners``, the listener registry too (tests, a long-lived
    server rotating its trace files, or the runner's run-scoped teardown,
    which keeps user-registered listeners alive)."""
    with _LOCK:
        with _EVENTS_LOCK:
            _EVENTS.clear()
            _DROPPED_EVENTS[0] = 0
            # forget track assignments so live threads re-announce
            # their thread_name metadata in the NEXT trace file too
            _TRACKS.clear()
        _REGISTRY.clear()
        if not keep_listeners:
            del _LISTENERS[:]


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------


def _track_id() -> int:
    ident = threading.get_ident()
    tid = _TRACKS.get(ident)
    if tid is None:
        with _EVENTS_LOCK:
            tid = _TRACKS.setdefault(ident, len(_TRACKS))
            _EVENTS.append({
                "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                "args": {"name": threading.current_thread().name}})
    return tid


def _span_stack() -> List[str]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _NullSpan:
    """Shared no-op context manager returned while telemetry is off."""

    __slots__ = ()
    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_t0", "trace_id", "span_id",
                 "parent_id")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        #: W3C-style identity, populated on __enter__ when a trace
        #: context is active on this thread; None otherwise — zero cost
        #: for in-process-only tracing
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.parent_id: Optional[str] = None

    def __enter__(self) -> "_Span":
        ctx = current_trace()
        if ctx is not None:
            self.trace_id, self.parent_id = ctx
            self.span_id = _new_span_id()
            _trace_stack().append((self.trace_id, self.span_id))
        _span_stack().append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        stack = _span_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if self.span_id is not None:
            tstack = _trace_stack()
            if tstack and tstack[-1][1] == self.span_id:
                tstack.pop()
            # attrs is span-owned (built fresh from **attrs) — mutate
            # in place, no defensive copy on the hot path
            self.attrs["trace_id"] = self.trace_id
            self.attrs["span_id"] = self.span_id
            if self.parent_id:
                self.attrs["parent_span_id"] = self.parent_id
        tid = _track_id()
        with _EVENTS_LOCK:
            if len(_EVENTS) >= _MAX_EVENTS:
                _DROPPED_EVENTS[0] += 1
                return False
            _EVENTS.append({
                "name": self.name, "ph": "X", "pid": _PID, "tid": tid,
                "ts": round((self._t0 - _EPOCH) * 1e6, 3),
                "dur": round((t1 - self._t0) * 1e6, 3),
                "args": self.attrs})
        return False


def span(name: str, **attrs: Any):
    """Context manager timing a named span; no-op singleton when off.

    Spans nest (the per-thread stack tracks the current path) and land on
    the calling thread's own track in the exported trace, so concurrent
    work — the streaming scorer's prep worker, CV threads — renders as
    parallel lanes in Perfetto. Under an active :func:`trace_scope` the
    span additionally carries ``trace_id`` / ``span_id`` /
    ``parent_span_id`` args, so cross-process traces stitch in the
    merged file; pass ``links=[span_id, ...]`` as a plain attr to
    reference other spans (the micro-batcher links its member request
    spans this way)."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name, attrs)


def current_span_stack() -> Tuple[str, ...]:
    """Names of the calling thread's open spans, outermost first."""
    return tuple(_span_stack())


def trace_events() -> List[Dict[str, Any]]:
    """Copy of the recorded Chrome trace events."""
    with _EVENTS_LOCK:
        return list(_EVENTS)


def write_trace(path: str) -> bool:
    """Write the Chrome trace-event JSON (open in Perfetto or
    ``chrome://tracing``). Multi-host one-writer rule: only the
    coordinator writes (every process records identical structure);
    returns False when skipped."""
    if not _is_coordinator():
        return False
    doc = {"traceEvents": trace_events(), "displayTimeUnit": "ms"}
    if _DROPPED_EVENTS[0]:
        doc["droppedEvents"] = _DROPPED_EVENTS[0]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return True


def _is_coordinator() -> bool:
    """The one writer of a world of ranks (``multihost.is_coordinator``:
    rank 0; always True in one process)."""
    from .parallel.multihost import is_coordinator
    return is_coordinator()


# ---------------------------------------------------------------------------
# distributed tracing — W3C-traceparent-style context + trace shards
# ---------------------------------------------------------------------------

#: HTTP header carrying the trace context between fleet processes
#: (router → worker), W3C-traceparent-shaped:
#: ``00-<32 hex trace id>-<16 hex span id>-01``
TRACE_HEADER = "X-Tmog-Trace"

#: env var carrying the trace context into subprocesses (the continual
#: tier's retrain jobs inherit the triggering window's trace this way)
TRACE_ENV = "TMOG_TRACE_PARENT"

#: env var naming this process's role in merged traces (router / worker
#: / retrain / ...) — one Perfetto process row per (role, pid)
TRACE_ROLE_ENV = "TMOG_TRACE_ROLE"

#: env var naming the directory a run drops its trace shard into when
#: its parameters name none (``customParams.traceDir`` wins)
TMOG_TRACE_DIR = "TMOG_TRACE_DIR"

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")

_TRACE_ROLE = [os.environ.get(TRACE_ROLE_ENV, "proc")]

#: always-on tracing tallies (never cleared by reset() — the
#: engine_cache_stats discipline; see telemetry_stats())
_TRACE_TALLY_LOCK = locks.witness_lock("telemetry._TRACE_TALLY_LOCK")
_TRACE_TALLY = {"traces_minted": 0, "traces_adopted": 0,
                "shards_written": 0, "shards_merged": 0}


def _trace_tally(key: str, n: int = 1) -> None:
    with _TRACE_TALLY_LOCK:
        _TRACE_TALLY[key] += n


def _id_rng():
    """Per-thread PRNG for trace/span ids, seeded ONCE from the OS
    entropy pool (+ pid + thread id, so forked workers and sibling
    threads can never share a stream). Ids need uniqueness, not
    cryptographic strength, and ``os.urandom`` is a syscall per call."""
    r = getattr(_TLS, "id_rng", None)
    if r is None:
        import random
        seed = (int.from_bytes(os.urandom(16), "big")
                ^ (os.getpid() << 64) ^ threading.get_ident())
        r = _TLS.id_rng = random.Random(seed)
    return r


def _new_trace_id() -> str:
    return f"{_id_rng().getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_id_rng().getrandbits(64):016x}"


def _trace_stack() -> List[Tuple[str, str]]:
    """Per-thread stack of (trace_id, span_id) for the OPEN traced
    spans — the innermost entry is the parent of the next child."""
    st = getattr(_TLS, "trace_stack", None)
    if st is None:
        st = _TLS.trace_stack = []
    return st


def mint_trace() -> Tuple[str, str]:
    """A fresh (trace_id, span_id) root context — the fleet router (or
    any other entry point) mints one per request and propagates it via
    :data:`TRACE_HEADER` / :data:`TRACE_ENV`."""
    _trace_tally("traces_minted")
    return _new_trace_id(), _new_span_id()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """``00-<trace_id>-<span_id>-01`` (W3C traceparent shape)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) from a traceparent string; None when the
    value is missing or malformed — a corrupt header must never fail a
    request, it just starts an unlinked trace."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    return m.group(1), m.group(2)


def _env_trace() -> Optional[Tuple[str, str]]:
    """The process-level parent context inherited via TMOG_TRACE_PARENT
    (retrain subprocesses join the triggering window's trace this
    way). Parsed lazily and cached — the env cannot change under us."""
    cached = getattr(_env_trace, "_cached", False)
    if cached is False:
        ctx = parse_traceparent(os.environ.get(TRACE_ENV))
        if ctx is not None:
            _trace_tally("traces_adopted")
        _env_trace._cached = ctx          # type: ignore[attr-defined]
        return ctx
    return cached


def current_trace() -> Optional[Tuple[str, str]]:
    """The calling thread's active (trace_id, parent_span_id): the
    innermost open traced span, else the thread's trace_scope context,
    else the process-level TMOG_TRACE_PARENT. None = untraced."""
    st = _trace_stack()
    if st:
        return st[-1]
    ctx = getattr(_TLS, "trace_ctx", None)
    if ctx is not None:
        return ctx
    return _env_trace()


class _TraceScope:
    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[Tuple[str, str]]):
        self.ctx = ctx
        self._prev: Any = None

    def __enter__(self) -> Optional[Tuple[str, str]]:
        self._prev = getattr(_TLS, "trace_ctx", None)
        if self.ctx is not None:
            _TLS.trace_ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc) -> bool:
        if self.ctx is not None:
            _TLS.trace_ctx = self._prev
        return False


def trace_scope(ctx):
    """Install a (trace_id, span_id) parent context — or a traceparent
    string, parsed tolerantly — for the calling thread's spans. A None
    context is a no-op scope, so call sites never need to branch::

        with telemetry.trace_scope(request_header):
            with telemetry.span("server:request") as sp:
                ...   # sp.trace_id / sp.span_id carry the identity
    """
    if isinstance(ctx, str):
        ctx = parse_traceparent(ctx)
    return _TraceScope(ctx)


def set_trace_role(role: str) -> None:
    """Name this process's row in merged traces (router / worker /
    retrain / runner...)."""
    _TRACE_ROLE[0] = str(role)


def trace_role() -> str:
    return _TRACE_ROLE[0]


def write_trace_shard(dir_path: str,
                      role: Optional[str] = None) -> Optional[str]:
    """Write THIS process's recorded events as one atomic trace shard
    under ``dir_path`` (``shard-<role>-<pid>.trace.json``), for
    :func:`merge_trace_shards` to stitch into one Perfetto file. Every fleet process writes its own shard — pid+role
    naming means no cross-process write races, so the multi-host
    one-writer rule deliberately does NOT apply here. The shard records
    ``epochUnixS`` — the wall-clock instant of this process's monotonic
    trace epoch — so the merger can align clocks across processes.
    Returns the shard path (None when nothing was recorded)."""
    events = trace_events()
    if not events:
        return None
    role = role or trace_role()
    os.makedirs(dir_path, exist_ok=True)
    # wall-clock anchor of the monotonic epoch: merge-time alignment
    # needs ONE cross-process time base, and the wall clock is the only
    # one the processes share (a small NTP skew shifts a whole process
    # row, never a duration — durations stay perf_counter-true)
    epoch_unix = time.time() - (time.perf_counter() - _EPOCH)  # lint: wall-clock — cross-process clock-offset anchor, not a duration
    doc = {"role": role, "pid": _PID,
           "epochUnixS": round(epoch_unix, 6),
           "traceEvents": events}
    if _DROPPED_EVENTS[0]:
        doc["droppedEvents"] = _DROPPED_EVENTS[0]
    safe_role = re.sub(r"[^A-Za-z0-9_.-]", "_", role)
    path = os.path.join(dir_path, f"shard-{safe_role}-{_PID}.trace.json")
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    _trace_tally("shards_written")
    return path


def merge_trace_shards(dir_path: str) -> Dict[str, Any]:
    """Stitch every ``shard-*.trace.json`` shard under ``dir_path``
    into one Chrome trace-event document with clock-offset alignment
    and a per-process row layout: each shard's events keep their own
    pid, get a ``process_name`` metadata row (``<role>-<pid>``), and
    their timestamps shift onto a common axis anchored at the earliest
    shard's epoch. Only the ``shard-`` prefix ``write_trace_shard``
    produces is ingested — a previous merge's own output
    (``merged.trace.json``) in the same directory must never be
    re-ingested as a shard (it has no epoch anchor and would shift the
    whole axis). Unreadable shards are skipped with a note in
    ``mergeErrors`` — a torn shard must never lose the rest of the
    fleet's trace."""
    shards: List[Dict[str, Any]] = []
    errors: List[str] = []
    try:
        names = sorted(os.listdir(dir_path))
    except OSError as e:
        raise ValueError(f"trace merge: cannot list {dir_path!r}: {e}")
    for fn in names:
        if not (fn.startswith("shard-") and fn.endswith(".trace.json")):
            continue
        p = os.path.join(dir_path, fn)
        try:
            with open(p) as fh:
                doc = json.load(fh)
            doc["traceEvents"]  # shape check
        except (OSError, ValueError, KeyError) as e:
            errors.append(f"{fn}: {e!r}")
            continue
        shards.append(doc)
    if not shards:
        raise ValueError(
            f"trace merge: no readable shard-*.trace.json shards in "
            f"{dir_path!r}" + (f" ({errors})" if errors else ""))
    t0 = min(float(s.get("epochUnixS", 0.0)) for s in shards)
    out_events: List[Dict[str, Any]] = []
    dropped = 0
    for sort_idx, s in enumerate(shards):
        pid = int(s.get("pid", sort_idx))
        role = str(s.get("role", "proc"))
        off_us = (float(s.get("epochUnixS", 0.0)) - t0) * 1e6
        out_events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": f"{role}-{pid}"}})
        out_events.append({"name": "process_sort_index", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"sort_index": sort_idx}})
        dropped += int(s.get("droppedEvents", 0))
        for ev in s["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) + off_us, 3)
            out_events.append(ev)
    doc = {"traceEvents": out_events, "displayTimeUnit": "ms",
           "mergedShards": len(shards)}
    if dropped:
        doc["droppedEvents"] = dropped
    if errors:
        doc["mergeErrors"] = errors
    _trace_tally("shards_merged", len(shards))
    return doc


def write_merged_trace(dir_path: str, out_path: str) -> Dict[str, Any]:
    """:func:`merge_trace_shards` + atomic write of the merged Perfetto
    file; returns the merged document."""
    doc = merge_trace_shards(dir_path)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{out_path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, out_path)
    return doc


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

#: Prometheus-style default histogram ladder (seconds-ish scale)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_REGISTRY: "OrderedDict[str, Any]" = OrderedDict()


class Counter:
    """Monotonic counter. Each instrument carries its OWN lock, so
    increments on many threads do not funnel through the registry
    lock."""

    __slots__ = ("name", "_v", "_lock")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def to_json(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_v", "_lock")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._v

    def to_json(self) -> float:
        return self._v


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations ``<= le``; ``+Inf`` equals ``count``).

    Internally the counts are per-BIN (non-cumulative, with one
    overflow bin past the last bound) so ``observe()`` is one bisect
    plus one increment under the instrument's own lock, not an O(#
    buckets) cumulative walk under the registry lock; the cumulative
    view is materialized at scrape time (:meth:`snapshot`)."""

    __slots__ = ("name", "buckets", "_bins", "_sum", "_count", "_lock")
    kind = "histogram"

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._bins = [0] * (len(self.buckets) + 1)   # +1 = overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        # first bound >= v (Prometheus: a bucket counts v <= le);
        # index len(buckets) is the overflow bin (only +Inf holds it)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._sum += v
            self._count += 1
            self._bins[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> Dict[float, int]:
        """Cumulative count per upper bound (``le``)."""
        counts, _total, _count = self.snapshot()
        return dict(zip(self.buckets, counts))

    def snapshot(self) -> Tuple[Tuple[int, ...], float, int]:
        """(cumulative bucket counts, sum, count) captured atomically
        under the instrument lock — the ONE read path scrapes may use.
        Reading the fields unlocked while ``observe()`` mutates them
        can tear: a scrape could emit a ``_count`` inconsistent with
        its cumulative buckets (``+Inf`` must equal ``_count`` in
        valid Prometheus exposition)."""
        with self._lock:
            bins = list(self._bins)
            total, count = self._sum, self._count
        cum: List[int] = []
        running = 0
        for c in bins[:-1]:
            running += c
            cum.append(running)
        return tuple(cum), total, count

    def to_json(self) -> Dict[str, Any]:
        counts, total, count = self.snapshot()
        return {"count": count, "sum": total,
                "buckets": {str(le): c for le, c
                            in zip(self.buckets, counts)}}


class _NullInstrument:
    """Shared no-op instrument returned while telemetry is off."""

    __slots__ = ()
    name = ""
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


def _instrument(name: str, cls, **kw):
    if not _ENABLED:
        return _NULL_INSTRUMENT
    inst = _REGISTRY.get(name)
    if inst is None:
        with _LOCK:
            inst = _REGISTRY.get(name)
            if inst is None:
                inst = _REGISTRY[name] = cls(name, **kw)
    if not isinstance(inst, cls):
        raise TypeError(f"metric {name!r} already registered as "
                        f"{type(inst).__name__}, not {cls.__name__}")
    return inst


def counter(name: str) -> Counter:
    """Get-or-create the named counter (null instrument when off)."""
    return _instrument(name, Counter)


def gauge(name: str) -> Gauge:
    """Get-or-create the named gauge (null instrument when off)."""
    return _instrument(name, Gauge)


def histogram(name: str,
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    """Get-or-create the named histogram (null instrument when off)."""
    return _instrument(name, Histogram, buckets=buckets)


def metrics_json() -> Dict[str, Any]:
    """Registry snapshot: ``{name: value}`` for counters/gauges,
    ``{name: {count, sum, buckets}}`` for histograms."""
    with _LOCK:
        return {name: inst.to_json() for name, inst in _REGISTRY.items()}


_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(extra: Optional[Dict[str, float]] = None) -> str:
    """Registry in Prometheus text exposition format (0.0.4). ``extra``
    appends scalar gauges (the runner folds its run doc numerics in).

    Histograms are snapshotted atomically (:meth:`Histogram.snapshot`)
    so a scrape racing ``observe()`` can never emit a ``_count``
    inconsistent with its cumulative buckets — the torn-scrape fix."""
    lines: List[str] = []
    with _LOCK:
        items = list(_REGISTRY.items())
    for name, inst in items:
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} {inst.kind}")
        if isinstance(inst, Histogram):
            counts, total, count = inst.snapshot()
            for le, c in zip(inst.buckets, counts):
                lines.append(f'{pn}_bucket{{le="{_prom_value(le)}"}} {c}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{pn}_sum {_prom_value(total)}")
            lines.append(f"{pn}_count {count}")
        else:
            lines.append(f"{pn} {_prom_value(inst.value)}")
    for name, v in (extra or {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_prom_value(float(v))}")
    return "\n".join(lines) + "\n"


def write_metrics(path: str, fmt: str = "json",
                  extra: Optional[Dict[str, float]] = None) -> bool:
    """Write the registry to ``path`` as JSON or Prometheus text.
    Coordinator-only (one-writer rule); atomic (temp + replace)."""
    if fmt not in ("json", "prometheus"):
        raise ValueError(f"unknown metrics format {fmt!r}")
    if not _is_coordinator():
        return False
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        if fmt == "json":
            doc = metrics_json()
            if extra:
                doc.update(extra)
            json.dump(doc, fh, indent=1, default=str)
        else:
            fh.write(render_prometheus(extra))
    os.replace(tmp, path)
    return True


# ---------------------------------------------------------------------------
# Prometheus exposition aggregation (the fleet router's /metrics plane)
# ---------------------------------------------------------------------------

_PROM_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")


def parse_prometheus(text: str) -> "OrderedDict[str, Dict[str, Any]]":
    """Minimal Prometheus 0.0.4 text parser:
    ``{family: {"type": kind, "samples": OrderedDict[(name, labels)
    -> float]}}``. Sample keys keep their full name (``_bucket`` /
    ``_sum`` / ``_count`` suffixes included) and raw label string, so a
    re-render round-trips. Raises ValueError on a malformed line — the
    router must not silently sum garbage."""
    fams: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE: "
                                 f"{line!r}")
            fams.setdefault(parts[2], {"type": parts[3],
                                       "samples": OrderedDict()})
            continue
        if line.startswith("#"):
            continue                     # HELP / comments
        m = _PROM_SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: "
                             f"{line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and fams.get(base, {}).get("type") == "histogram":
                fam = base
                break
        fams.setdefault(fam, {"type": "untyped",
                              "samples": OrderedDict()})
        try:
            v = float(value)
        except ValueError:
            raise ValueError(f"line {lineno}: non-numeric value "
                             f"{value!r} for {name!r}")
        fams[fam]["samples"][(name, labels)] = v
    return fams


def merge_parsed_prometheus(
        docs: Sequence["OrderedDict[str, Dict[str, Any]]"]) -> str:
    """Merge already-parsed expositions (:func:`parse_prometheus`
    output) by SUMMING samples with the same (name, labels) and
    re-rendering — the fleet router's ``/metrics`` aggregation, split
    from the parse so the router's per-worker validation pass is also
    the only parse. Correct for counters and histograms (the workers
    share one bucket ladder by construction, so per-``le`` sums stay
    cumulative); gauges sum too, which is the right fleet semantic
    for the gauges this registry exposes (queue depths, in-flight
    depths)."""
    merged: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    for parsed in docs:
        for fam, doc in parsed.items():
            tgt = merged.setdefault(
                fam, {"type": doc["type"], "samples": OrderedDict()})
            if tgt["type"] == "untyped":
                tgt["type"] = doc["type"]
            for key, v in doc["samples"].items():
                tgt["samples"][key] = tgt["samples"].get(key, 0.0) + v
    lines: List[str] = []
    for fam, doc in merged.items():
        lines.append(f"# TYPE {fam} {doc['type']}")
        for (name, labels), v in doc["samples"].items():
            lines.append(f"{name}{labels} {_prom_value(v)}")
    return "\n".join(lines) + "\n"


def render_prometheus_sum(texts: Sequence[str]) -> str:
    """:func:`merge_parsed_prometheus` over raw exposition texts."""
    return merge_parsed_prometheus([parse_prometheus(t)
                                    for t in texts])


# ---------------------------------------------------------------------------
# executed-FLOP device cost attribution (the MFU block)
# ---------------------------------------------------------------------------

#: peak FLOP/s by device-name substring, from the NVIDIA H100 SXM data
#: sheet (dense, no sparsity). Other devices (the CPU, another card)
#: report achieved FLOP/s with the mfu percentages None rather than an
#: invented peak; ``TMOG_PEAK_FLOPS`` overrides both.
PEAK_FLOPS = {"h100": {"bf16": 989.4e12, "f32": 66.9e12}}

_DEVICE_COST_LOCK = locks.witness_lock("telemetry._DEVICE_COST_LOCK")
#: phase -> {"flops", "seconds", "dispatches"} — fed by the scoring
#: engine and the fused statistics pass while telemetry is on
_DEVICE_COST: Dict[str, Dict[str, float]] = {}
#: device timers whose closing event has been recorded but not read yet
#: (:func:`settle_device_timers`, :func:`device_cost_stats`)
_PENDING_TIMERS: List["_DeviceTimer"] = []


def record_device_work(phase: str, flops: float = 0.0,
                       seconds: float = 0.0,
                       dispatches: int = 1) -> None:
    """Account one device dispatch's executed FLOPs (the analytic counts
    of the scoring program and the statistics fold) and its device-side
    seconds under ``phase`` (scoring / fitstats)."""
    with _DEVICE_COST_LOCK:
        d = _DEVICE_COST.setdefault(
            phase, {"flops": 0.0, "seconds": 0.0, "dispatches": 0.0})
        d["flops"] += float(flops)
        d["seconds"] += float(seconds)
        d["dispatches"] += int(dispatches)


class _NullTimer:
    """Shared no-op device timer returned while telemetry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class _DeviceTimer:
    """One dispatch's device seconds. On the card: a pair of
    ``torch.cuda.Event(enable_timing=True)`` recorded on the current
    stream of ``device``, the stream the kernels' wrappers and the
    scoring graphs launch on (an event on another stream would time
    nothing). The pair is read only once the closing event has completed:
    after a synchronisation the caller makes anyway (the pull of the
    results, :func:`settle_device_timers`), else when the ``mfu`` block is
    built (:func:`device_cost_stats`). The timer itself never
    synchronises. On the CPU the seconds are ``perf_counter``'s. Work that
    raises records nothing."""

    __slots__ = ("phase", "flops", "_dev", "_stream", "_ev0", "_ev1",
                 "_t0")

    def __init__(self, phase: str, flops: float, device):
        self.phase = phase
        self.flops = float(flops)
        self._dev = device
        self._stream = None
        self._ev0 = self._ev1 = None
        self._t0 = 0.0

    def __enter__(self) -> "_DeviceTimer":
        if self._dev.type == "cuda":
            import torch
            self._stream = torch.cuda.current_stream(self._dev)
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record(self._stream)
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is not None:
            return False
        if self._ev0 is None:
            record_device_work(self.phase, self.flops,
                               time.perf_counter() - self._t0)
            return False
        import torch
        self._ev1 = torch.cuda.Event(enable_timing=True)
        self._ev1.record(self._stream)
        with _DEVICE_COST_LOCK:
            _PENDING_TIMERS.append(self)
        return False

    def _record(self) -> None:
        record_device_work(self.phase, self.flops,
                           self._ev0.elapsed_time(self._ev1) / 1e3)


def device_timer(phase: str, device, flops: float = 0.0):
    """Context manager timing the device work issued inside it under
    ``phase`` (see :class:`_DeviceTimer`); the shared null timer while
    telemetry is off, so nothing is allocated and no event is made."""
    if not _ENABLED:
        return _NULL_TIMER
    import torch
    return _DeviceTimer(phase, flops, torch.device(device))


def settle_device_timers() -> None:
    """Record every pending timer whose closing event has completed
    (``Event.query``: no synchronisation). Called after a pull that has
    already waited for the stream."""
    if not _PENDING_TIMERS:
        return
    with _DEVICE_COST_LOCK:
        done = [t for t in _PENDING_TIMERS if t._ev1.query()]
        if not done:
            return
        _PENDING_TIMERS[:] = [t for t in _PENDING_TIMERS
                              if t not in done]
    for t in done:
        t._record()


def _drain_device_timers() -> None:
    """Wait for and record every pending timer (building the ``mfu``
    block; never on a dispatch path)."""
    with _DEVICE_COST_LOCK:
        pending = list(_PENDING_TIMERS)
        del _PENDING_TIMERS[:]
    for t in pending:
        t._ev1.synchronize()
        t._record()


def reset_device_cost() -> None:
    with _DEVICE_COST_LOCK:
        _DEVICE_COST.clear()
        del _PENDING_TIMERS[:]


def _peak_flops_for(device_kind: str) -> Optional[Dict[str, float]]:
    env = os.environ.get("TMOG_PEAK_FLOPS")
    if env:
        try:
            return {"bf16": float(env), "f32": float(env)}
        except ValueError:
            logger.warning("TMOG_PEAK_FLOPS=%r is not a number; "
                           "ignoring", env)
    kind = device_kind.lower()
    for sub, peaks in PEAK_FLOPS.items():
        if sub in kind:
            return peaks
    return None


def _device_kind() -> str:
    """``torch.cuda.get_device_name()``, or ``"cpu"`` with no CUDA
    device."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def device_cost_stats() -> Dict[str, Any]:
    """The ``mfu`` block of every runner metrics document: per-phase
    executed FLOPs, device seconds and dispatch counts, plus the achieved
    TFLOP/s and MFU percentages against the card's peak (None where the
    peak is unknown, the CPU among them: an unknown peak must not
    fabricate a utilization). On the card ``seconds`` are CUDA-event
    device seconds of the timed dispatches; on the CPU, host seconds
    around them. Device work is recorded only while telemetry is on, so
    with it off the phases are empty. Pending timers are drained first
    (the one place this module waits for the device)."""
    _drain_device_timers()
    with _DEVICE_COST_LOCK:
        phases = {k: dict(v) for k, v in _DEVICE_COST.items()}
    total_flops = sum(d["flops"] for d in phases.values())
    total_s = sum(d["seconds"] for d in phases.values())
    device_kind = _device_kind()
    n_dev = 1
    peaks = _peak_flops_for(device_kind)
    out: Dict[str, Any] = {
        "device_kind": device_kind,
        "devices": n_dev,
        "device_flops": total_flops,
        "device_seconds": round(total_s, 6),
        "phases": {
            k: {"flops": d["flops"],
                "seconds": round(d["seconds"], 6),
                "dispatches": int(d["dispatches"]),
                "achieved_tflops": (round(d["flops"] / d["seconds"]
                                          / 1e12, 6)
                                    if d["seconds"] > 0 else None)}
            for k, d in sorted(phases.items())},
    }
    timed_flops = sum(d["flops"] for d in phases.values()
                      if d["seconds"] > 0)
    rate = timed_flops / total_s if total_s > 0 else None
    out["achieved_tflops"] = (round(rate / 1e12, 6)
                              if rate is not None else None)
    if peaks and rate is not None:
        peak_total = {k: v * n_dev for k, v in peaks.items()}
        out["mfu_bf16_pct"] = round(100.0 * rate
                                    / peak_total["bf16"], 6)
        out["mfu_f32_pct"] = round(100.0 * rate / peak_total["f32"], 6)
    else:
        out["mfu_bf16_pct"] = None
        out["mfu_f32_pct"] = None
    return out


def telemetry_stats() -> Dict[str, Any]:
    """Always-on telemetry-plane tallies (the ``engine_cache_stats``
    discipline): whether recording is on,
    how many events/metrics are held, event overflow drops, and the
    cross-process tracing traffic (traces minted/adopted, shards
    written/merged)."""
    with _EVENTS_LOCK:
        n_events = len(_EVENTS)
    with _LOCK:
        n_metrics = len(_REGISTRY)
    with _TRACE_TALLY_LOCK:
        trace = dict(_TRACE_TALLY)
    return {"enabled": _ENABLED, "events": n_events,
            "dropped_events": _DROPPED_EVENTS[0],
            "metrics": n_metrics, "role": trace_role(), **trace}


# ---------------------------------------------------------------------------
# RunListener protocol (OpSparkListener analog)
# ---------------------------------------------------------------------------


class RunListener:
    """Callback protocol over run lifecycle events. Subclass and override
    what you need; every hook is emitted with keyword arguments and must
    tolerate future additions (``**_``)."""

    def on_run_start(self, run_type: str, **_: Any) -> None:
        pass

    def on_run_end(self, run_type: str, seconds: float = 0.0,
                   **_: Any) -> None:
        pass

    def on_layer_start(self, index: int, n_stages: int, **_: Any) -> None:
        pass

    def on_mesh(self, devices: int, data: int, grid: int,
                platform: str = "", **_: Any) -> None:
        """The run resolved its (data, grid) device mesh — the multichip
        substrate every heavy phase shards over (parallel/mesh.py;
        emitted once per train, only for a real multi-device mesh)."""
        pass

    def on_stage_fit(self, uid: str, stage_name: str, fit_s: float,
                     compile_s: float = 0.0, execute_s: float = 0.0,
                     warm_started: bool = False, **_: Any) -> None:
        pass

    def on_stats_pass(self, layer: int, n_stages: int, n_requests: int,
                      passes_saved: int, seconds: float = 0.0,
                      **_: Any) -> None:
        """One fused fit-statistics pass fed a whole DAG layer's
        estimators (fitstats.py, the SequenceAggregators analog)."""
        pass

    def on_score_batch(self, n_rows: int, bucket: int, seconds: float,
                       compiled: bool = False, **_: Any) -> None:
        pass

    def on_pipeline_stats(self, batches: int, workers: int,
                          prefetch_depth: int, starvations: int = 0,
                          buffer_reuses: int = 0, buffer_allocs: int = 0,
                          **_: Any) -> None:
        """One pipelined ingest stream finished (pipeline.py): how many
        batches it moved, the worker count it decoded/prepared on, the
        prefetch depth the autotuner converged to and the
        starvation/buffer-churn evidence behind that depth."""
        pass

    def on_compile(self, event: str, seconds: float, **_: Any) -> None:
        pass

    def on_retry(self, site: str, attempt: int, error: str = "",
                 delay_s: float = 0.0, **_: Any) -> None:
        """A RetryPolicy-governed operation failed transiently and is
        about to back off (resilience.py)."""
        pass

    def on_quarantine(self, site: str, kind: str, count: int,
                      reason: str = "", **_: Any) -> None:
        """Poison item(s) routed to the dead-letter sink
        (resilience.quarantine)."""
        pass

    def on_breaker_trip(self, name: str, failures: int, **_: Any) -> None:
        """A circuit breaker opened (``resilience.CircuitBreaker``; the
        fleet router's per-worker breakers): callers route around it until
        the reset timeout. No breaker of the port guards a device."""
        pass

    def on_lint(self, rule: str, severity: str, message: str = "",
                **_: Any) -> None:
        """One pre-flight lint finding (lint.py):
        ``rule`` is the stable TMGnnn id, ``severity`` is
        error/warning/info; stage uid / feature name / file location ride
        in the extra kwargs when the rule has them."""
        pass

    def on_plan(self, stages: int, engine_tier: Optional[str] = None,
                pruned_columns: int = 0, cse_merges: int = 0,
                **_: Any) -> None:
        """The whole-DAG planner built an ExecutionPlan (planner.py):
        per-stage tier assignment, dead-column pruning and CSE counts —
        the cost-based middle-end's decision record."""
        pass

    def on_request(self, model: str, rows: int, seconds: float,
                   ok: bool = True, coalesced: int = 1,
                   bucket: int = 0, slo_met: Optional[bool] = None,
                   **_: Any) -> None:
        """The model server completed one scoring request (server.py):
        per-request latency, the dispatch bucket it rode in and how many
        requests shared that dispatch (``coalesced``). ``ok`` is False
        for quarantined/errored requests; ``slo_met`` is None when no
        SLO is configured."""
        pass

    def on_drift(self, model: str, feature: str, rule: str,
                 value: float = 0.0, threshold: float = 0.0,
                 window_rows: int = 0, **_: Any) -> None:
        """The serving-time drift sentinel flagged one feature
        (lifecycle.DriftSentinel): ``rule`` is the TMG6xx advisory id,
        ``value`` the measured JS divergence / fill delta that crossed
        ``threshold`` over the last ``window_rows`` live rows."""
        pass

    def on_rollout(self, model: str, action: str,
                   version: Optional[str] = None, mode: str = "",
                   **_: Any) -> None:
        """A shadow/canary rollout changed state on the model server
        ``action`` is ``deploy`` / ``promote`` /
        ``rollback``, ``mode`` the rollout kind; rollbacks carry a
        ``reason`` kwarg."""
        pass

    def on_retrain(self, model: str, action: str,
                   job: Optional[str] = None,
                   version: Optional[str] = None, **_: Any) -> None:
        """The continuous-training controller changed state
        (continual.RetrainController): ``action`` is ``trigger`` / ``start`` /
        ``registered`` / ``deployed`` / ``rejected`` / ``failed`` /
        ``killed`` / ``recovered`` / ``gave_up``; ``job`` names the
        on-disk job record, ``version`` the registered candidate.
        Failures carry an ``error`` kwarg."""
        pass


_LISTENERS: List[RunListener] = []


def add_listener(listener: RunListener) -> RunListener:
    """Register a listener (dispatched only while telemetry is on)."""
    with _LOCK:
        if listener not in _LISTENERS:
            _LISTENERS.append(listener)
    return listener


def remove_listener(listener: RunListener) -> None:
    with _LOCK:
        try:
            _LISTENERS.remove(listener)
        except ValueError:
            pass


def listeners() -> List[RunListener]:
    return list(_LISTENERS)


def emit(event: str, /, **info: Any) -> None:
    """Dispatch ``on_<event>(**info)`` to every listener. A listener that
    raises is logged and skipped — observability must never take down the
    run it observes. (``event`` is positional-only: the compile hook's
    payload reuses the name as a keyword.)"""
    if not _ENABLED or not _LISTENERS:
        return
    for l in list(_LISTENERS):
        fn = getattr(l, "on_" + event, None)
        if fn is None:
            continue
        try:
            fn(**info)
        except Exception:  # lint: broad-except — observability must never take down the run
            logger.exception("telemetry listener %r failed on %s",
                             l, event)


class CollectingRunListener(RunListener):
    """Default listener folding events into an AppMetrics-style summary
    (OpSparkListener.AppMetrics analog). The runner registers one per run
    when telemetry is on and embeds ``summary()`` in its metrics doc."""

    def __init__(self):
        self.events: List[str] = []      # ordered event names (tests/debug)
        self.run_type: Optional[str] = None
        self.app_seconds = 0.0
        self.mesh: Optional[Dict[str, Any]] = None
        self.layers = 0
        self.stages: Dict[str, Dict[str, Any]] = {}
        self.score_batches = 0
        self.rows_scored = 0
        self.compiled_batches = 0
        self.compile_events = 0
        self.compile_seconds = 0.0
        self.stats_passes = 0
        self.fit_passes_saved = 0
        self.pipeline: Optional[Dict[str, Any]] = None
        self.retries = 0
        self.quarantined: Dict[str, int] = {}
        self.breaker_trips = 0
        self.lint_findings: Dict[str, int] = {}
        self.plan: Optional[Dict[str, Any]] = None
        self.requests = 0
        self.request_rows = 0
        self.requests_failed = 0
        self.drift_advisories: Dict[str, int] = {}
        self.rollouts: Dict[str, int] = {}
        self.retrains: Dict[str, int] = {}
        self._lock = threading.Lock()

    def on_run_start(self, run_type: str, **_: Any) -> None:
        with self._lock:
            self.events.append("run_start")
            self.run_type = run_type

    def on_run_end(self, run_type: str, seconds: float = 0.0,
                   **_: Any) -> None:
        with self._lock:
            self.events.append("run_end")
            self.app_seconds = seconds

    def on_layer_start(self, index: int, n_stages: int, **_: Any) -> None:
        with self._lock:
            self.events.append("layer_start")
            self.layers = max(self.layers, index + 1)

    def on_mesh(self, devices: int, data: int, grid: int,
                platform: str = "", **_: Any) -> None:
        with self._lock:
            self.events.append("mesh")
            self.mesh = {"devices": devices, "data": data, "grid": grid,
                         "platform": platform}

    def on_stage_fit(self, uid: str, stage_name: str, fit_s: float,
                     compile_s: float = 0.0, execute_s: float = 0.0,
                     warm_started: bool = False, **_: Any) -> None:
        with self._lock:
            self.events.append("stage_fit")
            self.stages[uid] = {
                "stageName": stage_name, "fitSeconds": round(fit_s, 4),
                "compileSeconds": round(compile_s, 4),
                "executeSeconds": round(execute_s, 4),
                "warmStarted": warm_started}

    def on_stats_pass(self, layer: int, n_stages: int, n_requests: int,
                      passes_saved: int, seconds: float = 0.0,
                      **_: Any) -> None:
        with self._lock:
            self.events.append("stats_pass")
            self.stats_passes += 1
            self.fit_passes_saved += int(passes_saved)

    def on_score_batch(self, n_rows: int, bucket: int, seconds: float,
                       compiled: bool = False, **_: Any) -> None:
        with self._lock:
            self.events.append("score_batch")
            self.score_batches += 1
            self.rows_scored += int(n_rows)
            if compiled:
                self.compiled_batches += 1

    def on_pipeline_stats(self, batches: int, workers: int,
                          prefetch_depth: int, starvations: int = 0,
                          buffer_reuses: int = 0, buffer_allocs: int = 0,
                          **_: Any) -> None:
        with self._lock:
            self.events.append("pipeline_stats")
            prev = self.pipeline or {"streams": 0, "batches": 0,
                                     "starvations": 0, "bufferReuses": 0,
                                     "bufferAllocs": 0}
            # counts accumulate across streams (each stream has its own
            # pool, so the churn evidence is the SUM); workers and the
            # converged prefetch depth are per-stream facts — last wins,
            # same as the module tallies' last_* keys
            self.pipeline = {
                "streams": prev["streams"] + 1,
                "batches": prev["batches"] + int(batches),
                "workers": int(workers),
                "prefetchDepth": int(prefetch_depth),
                "starvations": prev["starvations"] + int(starvations),
                "bufferReuses": prev["bufferReuses"] + int(buffer_reuses),
                "bufferAllocs": prev["bufferAllocs"] + int(buffer_allocs)}

    def on_compile(self, event: str, seconds: float, **_: Any) -> None:
        with self._lock:
            self.events.append("compile")
            self.compile_events += 1
            self.compile_seconds += seconds

    def on_retry(self, site: str, attempt: int, error: str = "",
                 delay_s: float = 0.0, **_: Any) -> None:
        with self._lock:
            self.events.append("retry")
            self.retries += 1

    def on_quarantine(self, site: str, kind: str, count: int,
                      reason: str = "", **_: Any) -> None:
        with self._lock:
            self.events.append("quarantine")
            self.quarantined[kind] = self.quarantined.get(kind, 0) + count

    def on_breaker_trip(self, name: str, failures: int, **_: Any) -> None:
        with self._lock:
            self.events.append("breaker_trip")
            self.breaker_trips += 1

    def on_lint(self, rule: str, severity: str, message: str = "",
                **_: Any) -> None:
        with self._lock:
            self.events.append("lint")
            self.lint_findings[severity] = \
                self.lint_findings.get(severity, 0) + 1

    def on_plan(self, stages: int, engine_tier: Optional[str] = None,
                pruned_columns: int = 0, cse_merges: int = 0,
                **_: Any) -> None:
        with self._lock:
            self.events.append("plan")
            self.plan = {"stages": int(stages),
                         "engineTier": engine_tier,
                         "prunedColumns": int(pruned_columns),
                         "cseMerges": int(cse_merges)}

    def on_request(self, model: str, rows: int, seconds: float,
                   ok: bool = True, coalesced: int = 1,
                   bucket: int = 0, slo_met: Optional[bool] = None,
                   **_: Any) -> None:
        with self._lock:
            self.events.append("request")
            self.requests += 1
            self.request_rows += int(rows)
            if not ok:
                self.requests_failed += 1

    def on_drift(self, model: str, feature: str, rule: str,
                 value: float = 0.0, threshold: float = 0.0,
                 window_rows: int = 0, **_: Any) -> None:
        with self._lock:
            self.events.append("drift")
            self.drift_advisories[rule] = \
                self.drift_advisories.get(rule, 0) + 1

    def on_rollout(self, model: str, action: str,
                   version: Optional[str] = None, mode: str = "",
                   **_: Any) -> None:
        with self._lock:
            self.events.append("rollout")
            self.rollouts[action] = self.rollouts.get(action, 0) + 1

    def on_retrain(self, model: str, action: str,
                   job: Optional[str] = None,
                   version: Optional[str] = None, **_: Any) -> None:
        with self._lock:
            self.events.append("retrain")
            self.retrains[action] = self.retrains.get(action, 0) + 1

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "runType": self.run_type,
                "appSeconds": round(self.app_seconds, 3),
                "mesh": self.mesh,
                "layers": self.layers,
                "fittedStages": len(self.stages),
                "stages": dict(self.stages),
                "scoreBatches": self.score_batches,
                "rowsScored": self.rows_scored,
                "compiledBatches": self.compiled_batches,
                "compileEvents": self.compile_events,
                "compileSeconds": round(self.compile_seconds, 4),
                "statsPasses": self.stats_passes,
                "fitPassesSaved": self.fit_passes_saved,
                "pipeline": dict(self.pipeline) if self.pipeline
                else None,
                "retries": self.retries,
                "quarantined": dict(self.quarantined),
                "breakerTrips": self.breaker_trips,
                "lintFindings": dict(self.lint_findings),
                "plan": dict(self.plan) if self.plan else None,
                "requests": self.requests,
                "requestRows": self.request_rows,
                "requestsFailed": self.requests_failed,
                "driftAdvisories": dict(self.drift_advisories),
                "rollouts": dict(self.rollouts),
                "retrains": dict(self.retrains),
            }


# ---------------------------------------------------------------------------
# compile clock, peak RSS
# ---------------------------------------------------------------------------


def compile_clock_s() -> float:
    """Cumulative compile seconds in this process: always 0.0. The port
    compiles nothing while it runs: its CUDA kernels are built by
    ``nvcc`` before any fit (``models/_hist.build_kernels``), and the
    scoring engine's programs are captured as CUDA graphs, not compiled.
    So a stage's fit seconds are all execute seconds, and no ``compile``
    event or ``xla.*`` counter is emitted."""
    return 0.0


def peak_rss_mb():
    """Peak resident-set size of this process AND its reaped children, in
    MB (None where the ``resource`` module is unavailable — Windows).
    ``ru_maxrss`` is the high-water mark; ``RUSAGE_CHILDREN`` folds in
    subprocess workers, and the max of the two is reported, since RSS
    peaks of different processes at different times do not add."""
    try:
        import resource
    except ImportError:
        return None
    kb = max(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
             resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)
    return round(kb / 1024.0, 1)
