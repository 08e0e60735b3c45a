"""The staged input pipeline (the tf.data analog); the port of
``transmogrifai_tpu/pipeline.py``.

The building blocks every ingest path of the port shares:

* **Ordered parallel stage** (:func:`map_ordered`): a named worker pool
  runs a decode or prepare function over a stream of items while the
  consumer sees the results in exact submission order (a bounded deque
  of futures is the reorder buffer: item k is yielded only after items
  0..k-1). Per-item exceptions ride beside the results, so the
  quarantine and retry policies of ``resilience.py`` hold on the worker
  threads. In-flight depth is bounded.
* **Buffer reuse** (:class:`BufferPool`): staging buffers keyed by
  (shape, dtype) and recycled across batches, pinned host memory when the
  pool serves the card, so the pad-to-bucket step of a streaming batch
  stops allocating; the reuse / allocation split is tallied.
* **Autotuned prefetch** (:class:`PrefetchAutotuner`): the in-flight
  depth grows while the consumer starves and shrinks after calm windows,
  observable as the ``pipeline.prefetch_depth`` gauge and the tallies.
* **Deterministic subsample** (:class:`SeededRowSample`): the bounded row
  sample of the out-of-core fit, a pure function of each row's global
  index and the seed (splitmix64), the JAX package's indices bit for
  bit.

:func:`probe_sustained_mbps` measures the host-to-card rate through two
reused pinned buffers, one copy in flight behind the other. It is a
measurement only: nothing in the port gates on it.

Consumers: ``readers.DirectoryStreamReader.stream(workers=)`` (parallel
file decode), ``scoring.stream_score_overlapped`` (parallel host prep),
``temporal.aggregate_directory``. The runner's knobs are
``customParams.pipeline`` / ``pipelineWorkers`` / ``pipelineDepth``;
``TMOG_PIPELINE=0`` forces one worker everywhere.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, TypeVar)

import numpy as np

from . import telemetry

logger = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_WORKERS", "MIN_PREFETCH", "DEFAULT_MAX_PREFETCH",
    "resolve_workers", "concrete_batch", "map_ordered",
    "BufferPool", "PrefetchAutotuner", "SeededRowSample",
    "probe_sustained_mbps",
    "pipeline_stats", "reset_pipeline_stats",
]

#: default decode/prep worker count: enough to hide host decode behind
#: device compute without oversubscribing small hosts
DEFAULT_WORKERS = max(1, min(4, (os.cpu_count() or 2) - 1))

#: prefetch depth floor — one batch computing + one in flight is the
#: minimum that overlaps at all
MIN_PREFETCH = 2

#: prefetch depth ceiling: beyond it the autotuner never grows (each
#: unit of depth pins one decoded+padded batch in host memory)
DEFAULT_MAX_PREFETCH = 8

#: ``TMOG_PIPELINE=0`` forces every consumer back to the single-thread
#: ingest path (kill switch, the TMOG_FITSTATS discipline)
PIPELINE_ENABLED = os.environ.get("TMOG_PIPELINE", "1") != "0"


def concrete_batch(batch):
    """A re-iterable batch: columnar batches (avro.ColumnarRecords —
    already concrete, and listifying one would undo the vectorized
    decode by materializing every dict) and lists/tuples pass through;
    one-shot iterables materialize."""
    if hasattr(batch, "columns") or isinstance(batch, (list, tuple)):
        return batch
    return list(batch)


def resolve_workers(workers: Optional[int]) -> int:
    """The effective worker count for a pipeline stage: the
    ``TMOG_PIPELINE=0`` kill switch forces 1 for EVERY consumer (even
    an explicit ``pipelineWorkers`` — the incident lever must not be
    overridable from a params file), else an explicit value wins
    (floored at 1) and None means the module default."""
    if not PIPELINE_ENABLED:
        return 1
    if workers is not None:
        return max(1, int(workers))
    return DEFAULT_WORKERS


# ---------------------------------------------------------------------------
# always-on tallies (the runner stamps them on every doc; telemetry
# mirrors the interesting ones as counters/gauges when enabled)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY: Dict[str, Any] = {
    "streams": 0, "batches": 0, "starvations": 0,
    "prefetch_grows": 0, "prefetch_shrinks": 0,
    "buffer_allocs": 0, "buffer_reuses": 0,
    "staged_uploads": 0,
    "decode_vectorized": 0, "decode_fallback": 0,
    "last_workers": 0, "last_prefetch_depth": 0,
    "sustained_mbps": None,
}


def pipeline_stats() -> Dict[str, Any]:
    """Snapshot of the process-wide input-pipeline tallies (always on —
    the ``fitstats_stats`` discipline, cheap enough to never turn off).
    ``last_prefetch_depth`` is the depth the autotuner converged to on
    the most recent stream; ``sustained_mbps`` the last pinned-buffer
    double-buffered bandwidth measurement (None before any probe)."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_pipeline_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = None if k == "sustained_mbps" else 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


def _tally_set(key: str, v: Any) -> None:
    with _TALLY_LOCK:
        _TALLY[key] = v


# ---------------------------------------------------------------------------
# pinned-buffer pool
# ---------------------------------------------------------------------------


def _torch_dtype(dtype):
    """The torch dtype of a numpy dtype (for the pinned buffers); None
    for one torch has not (strings, objects)."""
    import torch
    try:
        return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
    except TypeError:
        return None


class BufferPool:
    """Reusable preallocated numpy staging buffers keyed by
    (shape, dtype).

    ``take`` returns a buffer with UNSPECIFIED contents (callers
    overwrite every element — the pad helpers fill ``[:n]`` with data
    and zero ``[n:]``); ``give`` recycles it. Per-key free lists are
    bounded so a shape that appears once (the odd tail bucket) cannot
    pin memory forever. Thread-safe: prep workers take concurrently
    while the consumer gives back.

    The point is allocation churn, not correctness: padding every
    streaming batch to its bucket used to ``np.zeros`` + concatenate
    fresh arrays per block per batch. With the pool, the steady state
    allocates ~(prefetch depth × blocks) buffers once and then recycles
    — the ``buffer_reuses`` / ``buffer_allocs`` tallies make a churn
    regression visible in every runner metrics document."""

    def __init__(self, max_per_key: int = 16, pin: bool = False):
        self.max_per_key = int(max_per_key)
        #: hand out numpy views of pinned host tensors (the card's
        #: staging path); the values written are the same either way
        self.pin = bool(pin)
        self.reuses = 0
        self.allocs = 0
        self._free: Dict[Tuple, List[np.ndarray]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(shape: Tuple[int, ...], dtype) -> Tuple:
        return (tuple(int(s) for s in shape), np.dtype(dtype).str)

    def take(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """A writable buffer of exactly ``shape``/``dtype`` — recycled
        when one is free, freshly allocated otherwise."""
        key = self._key(shape, dtype)
        with self._lock:
            free = self._free.get(key)
            if free:
                buf = free.pop()
                self.reuses += 1
                _tally("buffer_reuses")
                return buf
            self.allocs += 1
        _tally("buffer_allocs")
        telemetry.counter("pipeline.buffer_allocs").inc()
        tdt = _torch_dtype(dtype) if self.pin else None
        if tdt is not None:
            import torch
            # the array keeps its pinned tensor alive (its base)
            return torch.empty(tuple(int(s) for s in shape), dtype=tdt,
                               pin_memory=True).numpy()
        return np.empty(shape, dtype)

    def give(self, buf: np.ndarray) -> None:
        """Recycle ``buf``. The caller must no longer read or write it
        — the next ``take`` hands it to another batch."""
        key = self._key(buf.shape, buf.dtype)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.max_per_key:
                free.append(buf)

    def pad_rows(self, a: np.ndarray, n: int, bucket: int,
                 taken: List[np.ndarray]) -> np.ndarray:
        """Zero-pad the leading (row) axis of ``a`` from ``n`` to
        ``bucket`` into a pooled buffer, appending it to ``taken`` so
        the caller can recycle after the batch is consumed. Blocks
        whose leading dim is not the row count (fitted constants) and
        already-full buckets pass through untouched — exactly the
        ``ScoringEngine._pad_rows`` contract, same values bit-for-bit."""
        a = np.asarray(a)
        if a.ndim == 0 or a.shape[0] != n or n == bucket:
            return a
        out = self.take((bucket,) + a.shape[1:], a.dtype)
        out[:n] = a
        out[n:] = 0
        taken.append(out)
        return out

    def free_buffers(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())


# ---------------------------------------------------------------------------
# autotuned prefetch depth
# ---------------------------------------------------------------------------


class PrefetchAutotuner:
    """tf.data-AUTOTUNE analog for the in-flight batch depth.

    The depth bounds how many items :func:`map_ordered` keeps submitted
    ahead of the consumer. Tuning runs on a fixed window of consumed
    batches:

    * any **starvation** in the window (the consumer asked for a result
      that was not ready — the pipeline, not the device, was the
      bottleneck) grows the depth by one, up to ``max_depth``;
    * two consecutive starvation-free windows shrink it by one, down to
      ``min_depth`` — depth beyond what hides the latency is pure
      buffer memory (each unit pins one decoded+padded batch), so the
      tuner backs off under the implicit memory pressure instead of
      camping at the ceiling.

    The chosen depth is observable: the ``pipeline.prefetch_depth``
    gauge tracks every change and the always-on tallies record the
    final depth plus the grow/shrink/starvation counts that explain it.
    """

    def __init__(self, min_depth: int = MIN_PREFETCH,
                 max_depth: int = DEFAULT_MAX_PREFETCH,
                 window: int = 4):
        if max_depth < min_depth:
            # an explicit cap below the floor wins (pipelineDepth: 1 is
            # the sanctioned way to force serial prefetch)
            min_depth = max_depth
        self.min_depth = int(min_depth)
        self.max_depth = int(max_depth)
        self.window = max(1, int(window))
        self._depth = self.min_depth
        self._batches = 0
        self._starved = 0
        self._calm_windows = 0
        self.starvations = 0
        self.grows = 0
        self.shrinks = 0
        self._lock = threading.Lock()
        telemetry.gauge("pipeline.prefetch_depth").set(self._depth)

    def depth(self) -> int:
        return self._depth

    def record_starvation(self) -> None:
        with self._lock:
            self._starved += 1
            self.starvations += 1
        _tally("starvations")
        telemetry.counter("pipeline.starvations").inc()

    def on_batch(self) -> None:
        """One batch consumed; closes a tuning window every
        ``window`` batches."""
        with self._lock:
            self._batches += 1
            if self._batches % self.window:
                return
            if self._starved:
                self._calm_windows = 0
                if self._depth < self.max_depth:
                    self._depth += 1
                    self.grows += 1
                    _tally("prefetch_grows")
            else:
                self._calm_windows += 1
                if self._calm_windows >= 2 and self._depth > self.min_depth:
                    self._depth -= 1
                    self.shrinks += 1
                    self._calm_windows = 0
                    _tally("prefetch_shrinks")
            self._starved = 0
        telemetry.gauge("pipeline.prefetch_depth").set(self._depth)


# ---------------------------------------------------------------------------
# ordered parallel map — the decode/prep stage
# ---------------------------------------------------------------------------

_T = TypeVar("_T")


def map_ordered(fn: Callable[[_T], Any], items: Iterable[_T],
                workers: Optional[int] = None,
                tuner: Optional[PrefetchAutotuner] = None,
                name: str = "pipeline",
                executor: Optional[Any] = None
                ) -> Iterator[Tuple[_T, Any, Optional[BaseException]]]:
    """Run ``fn`` over ``items`` on a named worker pool, yielding
    ``(item, result, exception)`` in EXACT submission order.

    The deque of in-flight futures is the reorder buffer: results
    complete in any order on the workers, but the consumer always pops
    the oldest submission first, so N-worker output is bit-identical
    (in content AND order) to the serial loop. A failing item yields
    its exception instead of raising — the caller owns the poison
    policy (quarantine / re-raise), same as the serial paths.

    In-flight depth is ``tuner.depth()`` when a tuner is attached
    (autotuned prefetch with explicit backpressure: the upstream
    iterator is only advanced when a slot frees), else ``workers + 1``.
    A consumer that stops iterating mid-stream cancels everything still
    queued — items never submitted are simply not consumed, which is
    what lets ``max_batches`` leave unread files re-offered.

    Live sources (anything but an in-memory sequence) are advanced on a
    dedicated feeder thread: ``next(it)`` on a directory stream between
    file arrivals can block a full poll interval, and a batch that
    finished DURING that block must not sit in the reorder buffer
    behind it — the consumer only ever waits on the oldest future, so
    results flow the moment they are ready however sparse the source.
    An exception out of the source itself (not an item) is re-raised to
    the consumer after every batch submitted before it has been
    yielded.

    ``executor`` lets a long-lived caller (the directory stream's poll
    loop) reuse one pool across many ``map_ordered`` calls instead of
    paying thread spin-up/teardown per call; a caller-owned executor is
    never shut down here."""
    from concurrent.futures import ThreadPoolExecutor

    n_workers = resolve_workers(workers)
    tel = telemetry.enabled()
    own_ex = executor is None
    ex = executor if executor is not None else ThreadPoolExecutor(
        max_workers=n_workers, thread_name_prefix=name)
    dq: deque = deque()
    cv = threading.Condition()
    state: Dict[str, Any] = {"exhausted": False, "stop": False,
                             "error": None}
    it = iter(items)
    live = not isinstance(items, (list, tuple))

    def _depth() -> int:
        return tuner.depth() if tuner is not None else n_workers + 1

    def _gauge() -> None:
        if tel:
            telemetry.gauge("pipeline.queue_depth").set(len(dq))

    def _feed_live() -> None:
        # runs on the feeder thread; dq/state mutations only under cv
        try:
            while True:
                with cv:
                    while not state["stop"] and len(dq) >= _depth():  # lint: thread-loop — bare cv-wait inside the function-wide try/finally (exhausted flag always set)
                        cv.wait()
                    if state["stop"]:
                        return
                    # while the feeder is inside next(it) the SOURCE is
                    # the limiter — a consumer starving then must not
                    # grow the prefetch depth (extra depth cannot make
                    # files arrive faster); cleared on submit, and left
                    # set on source exhaustion for the same reason
                    state["source_wait"] = True
                try:
                    item = next(it)
                except StopIteration:
                    return
                except BaseException as e:  # lint: broad-except — a source failure rides to the consumer, after in-flight items
                    state["error"] = e
                    return
                with cv:
                    state["source_wait"] = False
                    if state["stop"]:
                        return
                    dq.append((item, ex.submit(fn, item)))
                    _gauge()
                    cv.notify_all()
        finally:
            with cv:
                state["exhausted"] = True
                cv.notify_all()

    def _top_up_inline() -> None:
        # sequence source: next() cannot block, so feed from the
        # consumer and skip the feeder thread entirely
        while not state["exhausted"] and len(dq) < _depth():
            try:
                item = next(it)
            except StopIteration:
                state["exhausted"] = True
                break
            dq.append((item, ex.submit(fn, item)))
        _gauge()

    if live:
        threading.Thread(target=_feed_live, name=f"{name}-feeder",
                         daemon=True).start()
    first_pop = True
    try:
        while True:
            src_bound = False
            if live:
                with cv:
                    while not dq and not state["exhausted"]:
                        cv.wait()
                    if not dq:
                        break
                    item, fut = dq.popleft()
                    src_bound = state.get("source_wait", False)
                    _gauge()
                    cv.notify_all()        # a slot freed for the feeder
            else:
                _top_up_inline()
                if not dq:
                    break
                item, fut = dq.popleft()
                _gauge()
            # the first pop lands microseconds after the first submit
            # and is ~always unfinished — that's cold start, not "the
            # pipeline is the bottleneck", so it must not count as a
            # starvation (it would grow the depth and pollute the
            # tallies on EVERY stream, balanced or not)
            if tuner is not None and not fut.done() and not first_pop \
                    and not src_bound:
                tuner.record_starvation()
            first_pop = False
            try:
                res, exc = fut.result(), None
            except BaseException as e:  # lint: broad-except — per-item failures ride to the caller's poison policy
                res, exc = None, e
            yield item, res, exc
            if tuner is not None:
                tuner.on_batch()
                if live:
                    with cv:
                        cv.notify_all()    # depth may have grown
        if state["error"] is not None:
            raise state["error"]
    finally:
        with cv:
            state["stop"] = True
            cv.notify_all()
        for _item, fut in dq:
            fut.cancel()
        if own_ex:
            ex.shutdown(wait=False)


# ---------------------------------------------------------------------------
# sustained-bandwidth probe (the double-buffered path's number)
# ---------------------------------------------------------------------------


def probe_sustained_mbps(n_transfers: int = 8, buf_mb: int = 4,
                         device=None) -> float:
    """Host-to-card rate (MB/s) through the pipeline's own discipline: two
    reused pinned staging buffers, each copy issued while the previous one
    is still in flight (``non_blocking``), then one synchronization. The
    sustained rate streaming ingest gets, not a cold single copy. Records
    ``sustained_mbps`` in the tallies and the ``device.sustained_mbps``
    gauge. A measurement only: the port gates nothing on it."""
    import torch

    from .models.base import resolve_device
    dev = resolve_device(device)
    n_elems = (buf_mb << 20) // 4
    bufs = [torch.zeros((n_elems,), dtype=torch.float32,
                        pin_memory=dev.type == "cuda") for _ in range(2)]
    outs = [torch.empty((n_elems,), dtype=torch.float32, device=dev)
            for _ in range(2)]
    outs[0].copy_(bufs[0])           # warm-up: context and allocator
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    nbytes = n_elems * 4
    with telemetry.span("pipeline:sustained_probe",
                        bytes=n_transfers * nbytes):
        t0 = time.perf_counter()
        for i in range(n_transfers):
            # buffer i % 2's previous copy (i - 2) is ordered before this
            # one on the same stream
            outs[i % 2].copy_(bufs[i % 2], non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = max(time.perf_counter() - t0, 1e-9)
    mbps = (n_transfers * nbytes / 1e6) / dt
    _tally_set("sustained_mbps", round(mbps, 1))
    telemetry.gauge("device.sustained_mbps").set(mbps)
    logger.info("sustained host->device rate (pinned, double-buffered): "
                "%.0f MB/s", mbps)
    return mbps


# ---------------------------------------------------------------------------
# stream bookkeeping shared by the pipelined consumers
# ---------------------------------------------------------------------------


def record_stream(n_batches: int, workers: int,
                  tuner: Optional[PrefetchAutotuner] = None,
                  pool: Optional[BufferPool] = None) -> None:
    """Fold one finished pipelined stream into the always-on tallies
    and emit the ``on_pipeline_stats`` RunListener event — the
    OpSparkListener-style summary row of the runner's metrics
    document."""
    _tally("streams")
    _tally("batches", n_batches)
    _tally_set("last_workers", int(workers))
    depth = tuner.depth() if tuner is not None else 0
    if tuner is not None:
        _tally_set("last_prefetch_depth", depth)
    telemetry.counter("pipeline.batches").inc(n_batches)
    telemetry.emit(
        "pipeline_stats", batches=n_batches, workers=int(workers),
        prefetch_depth=depth,
        starvations=tuner.starvations if tuner is not None else 0,
        buffer_reuses=pool.reuses if pool is not None else 0,
        buffer_allocs=pool.allocs if pool is not None else 0)


# ---------------------------------------------------------------------------
# deterministic bounded row subsample (out-of-core training)
# ---------------------------------------------------------------------------


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 — a bijection, so
    distinct row indices always get distinct priorities."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class SeededRowSample:
    """Deterministic bounded row subsample over a stream of batches —
    the out-of-core stand-in for the quantile sketch's seeded
    permutation (models/_treefit.quantile_bin_edges): keep the ``k``
    rows whose seeded hash priority is smallest.

    Each row's priority is a pure function of its GLOBAL index in the
    concatenated stream and the seed — independent of batch boundaries,
    worker counts and whether the data was streamed or materialized
    (``map_ordered`` delivers batches in submission order, so the
    global index is stable). The working set is bounded at ~2k buffered
    rows; ``result()`` returns the selected rows in global-row order,
    so for n <= k the sample IS the stream, in order.

    Protocol per batch: ``loc = offer(len(batch))`` gives the LOCAL
    indices of candidate rows (priority under the current running
    cutoff); the caller gathers those rows and hands them to
    ``keep(rows)`` in the same order.
    """

    def __init__(self, k: int, seed: int = 0x51EED):
        if k < 1:
            raise ValueError("sample size k must be >= 1")
        self.k = int(k)
        self.seed = int(seed)
        self._n = 0
        self._cut: Optional[int] = None
        self._buf: List[Tuple[int, int, Any]] = []
        self._pending: Tuple[np.ndarray, np.ndarray] = (
            np.empty(0, np.uint64), np.empty(0, np.uint64))

    @property
    def total_rows(self) -> int:
        return self._n

    def offer(self, n_rows: int) -> np.ndarray:
        """Local candidate indices for the next ``n_rows`` rows."""
        n_rows = int(n_rows)
        g0 = self._n
        self._n += n_rows
        gidx = np.arange(g0, self._n, dtype=np.uint64)
        pri = _splitmix64(
            gidx + np.uint64((self.seed * 0x9E3779B97F4A7C15)
                             & 0xFFFFFFFFFFFFFFFF))
        if self._cut is not None:
            loc = np.nonzero(pri <= np.uint64(self._cut))[0]
        else:
            loc = np.arange(n_rows)
        self._pending = (pri[loc], gidx[loc])
        return loc

    def keep(self, rows: Sequence[Any]) -> None:
        """Buffer the rows matching the last ``offer``'s candidates."""
        pri, gidx = self._pending
        self._pending = (np.empty(0, np.uint64), np.empty(0, np.uint64))
        self._buf.extend(zip(pri.tolist(), gidx.tolist(), rows))
        if len(self._buf) > 2 * self.k:
            self._compact()

    def _compact(self) -> None:
        # keep the k smallest (priority, index) pairs; the kth becomes
        # the pruning cutoff for future offers
        self._buf.sort(key=lambda t: (t[0], t[1]))
        del self._buf[self.k:]
        if len(self._buf) >= self.k:
            self._cut = self._buf[-1][0]

    def result(self) -> List[Any]:
        """The selected rows, in global-row (stream) order."""
        self._compact()
        return [row for _, _, row in
                sorted(self._buf, key=lambda t: t[1])]
