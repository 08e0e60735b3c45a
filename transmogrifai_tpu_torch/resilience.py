"""Resilience: fault injection, retries, the dead-letter quarantine and
the circuit breaker; the port of ``transmogrifai_tpu/resilience.py``.

TransmogrifAI inherits its fault tolerance from Spark (task retries,
lineage re-execution, micro-batch recovery). This module gives the port
the same recoverable, observable failure states, following tf.data's
contract that input pipelines degrade gracefully on malformed records:

* **Fault injection**: :class:`FaultPlan` and :func:`inject`. Product code
  marks named fault sites (``stream.read_file``, ``avro.decode``,
  ``fitstats.device_pass``, ``checkpoint.rename``; :data:`FAULT_SITES`
  is the catalog); a seeded plan installed with :func:`fault_plan`
  decides which calls raise, so chaos tests replay exactly. Without a
  plan ``inject`` is one attribute read.
* **RetryPolicy**: seeded, capped exponential backoff with jitter and a
  retryable-exception filter, for reader IO (:data:`READER_RETRY`) and
  checkpoint writes (:data:`CHECKPOINT_RETRY`).
* **Quarantine**: a JSONL dead-letter sink (:func:`set_quarantine` /
  :func:`quarantine`). Unreadable stream files, poison scoring batches
  and the join rows a bounded build table drops go there with a reason;
  the always-on :func:`resilience_stats` tallies count them (and mirror
  into ``resilience.*`` telemetry counters when telemetry is on).
* **CircuitBreaker**: the closed / open / half-open breaker, kept as a
  class for the serving tier. The port routes no device failure through
  it: a fault at ``fitstats.device_pass``, ``scoring.device_dispatch``,
  ``pipeline.upload`` or ``temporal.aggregate`` raises to the caller,
  never to a host tier or the quarantine (no fallback hides the card).

``Workflow.fit(resume_from=...)`` counts its warm starts here
(:func:`record_resumed_fit`).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple,
                    Type, Union)

from . import telemetry

logger = logging.getLogger(__name__)

__all__ = [
    "FAULT_SITES", "UNPORTED_SITES", "DEVICE_SITES", "mark_device_failure",
    "is_device_failure",
    "FaultPlan", "inject", "install_plan", "clear_plan", "fault_plan",
    "active_plan",
    "RetryPolicy", "READER_RETRY", "CHECKPOINT_RETRY",
    "CircuitBreaker",
    "Quarantine", "set_quarantine", "get_quarantine", "quarantine",
    "quarantine_batch_or_raise", "resolve_on_error", "record_resumed_fit",
    "resilience_stats", "reset_resilience_stats",
]


# ---------------------------------------------------------------------------
# always-on tallies (run docs stamp these; telemetry mirrors when enabled)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"faults_injected": 0, "retries": 0, "retry_exhausted": 0,
          "breaker_trips": 0, "breaker_open_skips": 0,
          "quarantined_files": 0, "quarantined_batches": 0,
          "quarantined_records": 0, "resumed_fits": 0}


def resilience_stats() -> Dict[str, int]:
    """Snapshot of the process-wide resilience tallies. Always on (the
    ``fitstats_stats`` discipline) so the runner can stamp quarantine /
    retry / breaker evidence on every metrics doc without full
    telemetry."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_resilience_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


# ---------------------------------------------------------------------------
# fault-injection harness
# ---------------------------------------------------------------------------

#: the catalog of registered fault sites, the JAX package's whole: every
#: ``inject(site)`` marker of the port must name one of these (held by
#: ``tests/test_torch_resilience.py``, the counterpart of the JAX tree's
#: TMG303: a misspelled site is a chaos test that never fires). In the
#: port a fault at a device site (``fitstats.device_pass``,
#: ``scoring.device_dispatch``, ``pipeline.upload``,
#: ``temporal.aggregate``) raises to the caller; no breaker or host tier
#: takes it.
FAULT_SITES = frozenset({
    "stream.poll",               # directory-stream listing (streaming.py)
    "stream.read_file",          # per-file stream read (streaming.py)
    "stream.score_batch",        # per-batch scoring (data_readers/scoring)
    "avro.decode",               # avro container decode (readers/avro.py)
    "csv.decode",                # csv decode (readers/data_readers.py)
    "fitstats.device_pass",      # fused fit-stats device tier (fitstats.py)
    "scoring.device_dispatch",   # compiled engine dispatch (scoring.py)
    "pipeline.upload",           # a scoring chunk's upload to the
                                 # device (scoring.ScoringEngine)
    "server.dispatch",           # model-server micro-batch dispatch
                                 # (server.py — the merged batch and
                                 # each one-request retry on the same
                                 # engine pass through it)
    "fleet.forward",             # router→worker forward attempt
                                 # (fleet.serve_fleet_http — fires per
                                 # attempt, so a fault models a dead or
                                 # unreachable worker and the sibling
                                 # retry is the recovery under test)
    "fleet.spawn",               # worker process spawn/respawn
                                 # (fleet.FleetSupervisor._spawn —
                                 # fires before Popen, so a fault
                                 # models a spawn failure and re-enters
                                 # the jittered respawn backoff)
    "lifecycle.promote",         # registry current-pointer swap
                                 # (lifecycle.ModelRegistry.promote —
                                 # fires BEFORE the atomic os.replace,
                                 # so an injected fault models a crash
                                 # mid-promote: pointer untouched)
    "continual.retrain",         # drift-triggered retrain job launch
                                 # (continual.RetrainController — fires
                                 # after the active-job flock, before
                                 # the trainer subprocess spawns, so a
                                 # fault models a job that dies at t=0
                                 # and exercises the failure budget)
    "continual.register",        # post-retrain registry registration
                                 # (continual.RetrainController — fires
                                 # before registry.register, so a fault
                                 # models a crash mid-register: the job
                                 # record stays replayable, the CURRENT
                                 # pointer untouched)
    "continual.merge_stats",     # warm-start sufficient-stats merge
                                 # (fitstats.LayerStatsPlan._warm_merge
                                 # — fires before the host Chan merge of
                                 # persisted train-time moments with the
                                 # fresh slice, so a fault degrades that
                                 # column to fresh-only stats)
    "temporal.aggregate",        # columnar temporal aggregation pass
                                 # (temporal.route_aggregate /
                                 # aggregate_tables — fires before the
                                 # vectorized group/fold; raises)
    "temporal.join",             # streaming hash-join build/probe
                                 # (TemporalJoinReader /
                                 # join_aggregate_directory — fires
                                 # inside the retried build step, so a
                                 # transient fault rides READER_RETRY
                                 # instead of killing the read)
    "checkpoint.write",          # layer-checkpoint save (model_io.py)
    "checkpoint.rename",         # layer-checkpoint swap (model_io.py)
})

#: the registered sites whose modules are not ported yet, with the ROADMAP
#: queue A item that brings each; the fault-site coverage rule (TMG805,
#: ``repo_lint``) does not ask for them. Every site's module is ported, so
#: it is empty: TMG805 asks a chaos test of every site
UNPORTED_SITES: Dict[str, str] = {}


#: the device sites: a fault at one raises to the caller, whatever the
#: poison policy (``quarantine_batch_or_raise`` re-raises it)
DEVICE_SITES = frozenset({"fitstats.device_pass", "scoring.device_dispatch",
                          "pipeline.upload", "temporal.aggregate"})


def mark_device_failure(exc: BaseException) -> BaseException:
    """Tag ``exc`` as a failure of the device tier (an injected fault at a
    device site, or a failing launch or copy in the scoring engine), so no
    poison policy quarantines it: it raises to the caller."""
    try:
        exc._tmog_device_failure = True
    except AttributeError:       # an exception type without a __dict__
        pass
    return exc


#: the texts of the card's own failures raised as plain ``RuntimeError``:
#: PyTorch's CUDA, cuBLAS and cuDNN errors and the port's kernel wrappers'
#: failed launches (``models/_hist.py``)
_DEVICE_ERROR_TEXTS = ("CUDA error", "CUDA driver error",
                       "CUDA out of memory", "CUBLAS_STATUS", "cuDNN error")


def is_device_failure(exc: BaseException) -> bool:
    """Is ``exc`` a failure of the device tier? Tagged by
    :func:`mark_device_failure`, or the card's own error wherever it was
    raised: ``torch.OutOfMemoryError``, ``torch.AcceleratorError`` and a
    ``RuntimeError`` that names a CUDA, cuBLAS or cuDNN failure. The
    layer-by-layer scoring path reaches the card without the engine's
    tagging, so the type decides there."""
    if getattr(exc, "_tmog_device_failure", False):
        return True
    import torch
    kinds = tuple(k for k in (getattr(torch, "OutOfMemoryError", None),
                              getattr(torch, "AcceleratorError", None))
                  if k is not None)
    if kinds and isinstance(exc, kinds):
        return True
    return isinstance(exc, RuntimeError) and any(
        t in str(exc) for t in _DEVICE_ERROR_TEXTS)


class _SiteFault:
    """One site's injection rule inside a :class:`FaultPlan`."""

    __slots__ = ("error", "at", "probability", "times", "calls", "fired",
                 "rng")

    def __init__(self, error, at, probability, times, rng):
        self.error = error
        self.at = at                  # frozenset of 0-based call indices
        self.probability = probability
        self.times = times            # max fires (None = unlimited)
        self.calls = 0
        self.fired = 0
        self.rng = rng


class FaultPlan:
    """Seeded, deterministic chaos plan: which :func:`inject` calls raise.

    Selection per site is (in precedence order) an explicit set of call
    indices (``at=[2]`` → only the third call fires), a probability drawn
    from a per-site ``random.Random(f"{seed}:{site}")`` stream (the same
    seed replays the same faults regardless of other sites' traffic), or
    every call. ``times`` caps total fires either way — ``times=1`` makes
    a transient fault, the retry-policy happy path.

    >>> plan = FaultPlan(seed=7).on("stream.read_file", error=OSError,
    ...                             at=[0])
    >>> with fault_plan(plan):
    ...     run_the_stream()
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._sites: Dict[str, _SiteFault] = {}
        self._lock = threading.Lock()

    def on(self, site: str,
           error: Union[Type[BaseException], BaseException] = OSError,
           at: Optional[Iterable[int]] = None,
           probability: Optional[float] = None,
           times: Optional[int] = None) -> "FaultPlan":
        """Arm ``site``; returns self for chaining."""
        self._sites[site] = _SiteFault(
            error=error,
            at=frozenset(int(i) for i in at) if at is not None else None,
            probability=probability,
            times=times,
            rng=random.Random(f"{self.seed}:{site}"))
        return self

    def sites(self) -> List[str]:
        return sorted(self._sites)

    def calls(self, site: str) -> int:
        """How many times ``inject(site)`` ran under this plan."""
        f = self._sites.get(site)
        return f.calls if f else 0

    def fired(self, site: str) -> int:
        """How many of those calls raised."""
        f = self._sites.get(site)
        return f.fired if f else 0

    def check(self, site: str) -> Optional[BaseException]:
        """Advance the site's call counter; return the exception to raise
        for this call, or None. Thread-safe (streaming prep workers hit
        sites concurrently with the consumer)."""
        f = self._sites.get(site)
        if f is None:
            return None
        with self._lock:
            idx = f.calls
            f.calls += 1
            if f.times is not None and f.fired >= f.times:
                return None
            if f.at is not None:
                fire = idx in f.at
            elif f.probability is not None:
                fire = f.rng.random() < f.probability
            else:
                fire = True
            if not fire:
                return None
            f.fired += 1
        err = f.error
        if isinstance(err, BaseException):
            return err
        return err(f"injected fault at {site!r} (call {idx})")


#: the installed plan; None (the default) short-circuits inject() to a
#: single attribute read — production paths pay nothing for the sites
_PLAN: Optional[FaultPlan] = None


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide; returns the previous plan."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    return prev


def clear_plan() -> None:
    install_plan(None)


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


@contextlib.contextmanager
def fault_plan(plan: FaultPlan):
    """Scoped install — the chaos-test entry point."""
    prev = install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(prev)


def inject(site: str, **ctx: Any) -> None:
    """Fault site marker. No-op without an installed plan; under a plan,
    deterministically raises the configured exception. ``ctx`` is logged
    with the injection so chaos-test failures are debuggable."""
    plan = _PLAN
    if plan is None:
        return
    exc = plan.check(site)
    if exc is None:
        return
    _tally("faults_injected")
    telemetry.counter("resilience.faults_injected").inc()
    logger.warning("fault injected at %s %s: %r", site, ctx or "", exc)
    if site in DEVICE_SITES:
        mark_device_failure(exc)
    raise exc


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


class RetryPolicy:
    """Jittered exponential backoff with a retryable-exception filter.

    ``call(site, fn, *args, **kw)`` runs ``fn`` up to ``max_attempts``
    times, sleeping ``base_delay_s * multiplier**attempt`` (capped at
    ``max_delay_s``) scaled by a jitter factor in ``[1-jitter, 1+jitter]``
    between attempts. Only exceptions matching ``retryable`` are retried
    — a decode error (corrupt data) is not transient and re-raises
    immediately, an ``OSError`` (flaky filesystem, vanished file) gets
    the backoff. Seeded policies produce deterministic delay sequences
    for tests; the default draws from the module RNG.
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5,
                 retryable: Tuple[Type[BaseException], ...] = (OSError,),
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retryable = tuple(retryable)
        self._rng = random.Random(seed) if seed is not None else random
        self._sleep = sleep

    def delay_s(self, attempt: int) -> float:
        """Backoff before retrying after failed attempt ``attempt``
        (0-based)."""
        raw = min(self.base_delay_s * (self.multiplier ** attempt),
                  self.max_delay_s)
        if self.jitter <= 0:
            return raw
        lo = max(1.0 - self.jitter, 0.0)
        hi = 1.0 + self.jitter
        return raw * (lo + (hi - lo) * self._rng.random())

    def call(self, site: str, fn: Callable[..., Any], *args: Any,
             **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)`` under this policy. The last
        failure re-raises unchanged (callers see the real exception, not
        a wrapper)."""
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                if attempt + 1 >= self.max_attempts:
                    _tally("retry_exhausted")
                    telemetry.counter("resilience.retry_exhausted").inc()
                    logger.warning(
                        "%s: giving up after %d attempt(s): %r",
                        site, self.max_attempts, e)
                    raise
                d = self.delay_s(attempt)
                _tally("retries")
                telemetry.counter("resilience.retries").inc()
                telemetry.emit("retry", site=site, attempt=attempt,
                               error=repr(e), delay_s=d)
                logger.warning(
                    "%s: attempt %d/%d failed (%r); retrying in %.3fs",
                    site, attempt + 1, self.max_attempts, e, d)
                self._sleep(d)
        raise AssertionError("unreachable")   # pragma: no cover

    def wrap(self, site: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        """Decorator form of :meth:`call`."""
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            return self.call(site, fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


#: reader IO — file reads and stream polling (a vanished/locked file on
#: network storage is the transient case this exists for). Short base
#: delay: the directory stream already sleeps its own poll interval.
READER_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05,
                           max_delay_s=0.5, retryable=(OSError,))

#: checkpoint writes — a failed layer checkpoint must not kill a
#: multi-hour fit over a transient shared-filesystem hiccup.
CHECKPOINT_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.1,
                               max_delay_s=2.0, retryable=(OSError,))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Consecutive-failure breaker (the serving tier's, for a failing
    route or worker; the port routes no device failure through one).

    closed → (N consecutive failures) → open → (reset timeout) →
    half-open → one probe: success closes, failure re-opens. Each failure
    is still logged and counted; the breaker only stops paying a known
    failing call every time.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str, failure_threshold: int = 3,
                 reset_timeout_s: float = 60.0):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        return self._state

    @property
    def consecutive_failures(self) -> int:
        return self._failures

    def allow(self) -> bool:
        """May the protected path run? Open + elapsed reset timeout lets
        ONE half-open probe through; its outcome decides the state."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = time.monotonic()
            if self._state == self.OPEN:
                if now - self._opened_at >= self.reset_timeout_s:
                    self._state = self.HALF_OPEN
                    self._opened_at = now
                    logger.info("breaker %s: half-open probe", self.name)
                    return True
                _tally("breaker_open_skips")
                telemetry.counter("resilience.breaker_open_skips").inc()
                return False
            # HALF_OPEN: the probe is in flight; hold further traffic on
            # the skip path until it reports. A probe that was handed out
            # but never reported back (its caller bailed on another
            # gate) must not wedge the tier forever — after another
            # reset period the next caller becomes the probe.
            if now - self._opened_at >= self.reset_timeout_s:
                self._opened_at = now
                logger.info("breaker %s: half-open probe (previous probe "
                            "never reported)", self.name)
                return True
            _tally("breaker_open_skips")
            telemetry.counter("resilience.breaker_open_skips").inc()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                logger.info("breaker %s: closed (probe succeeded)",
                            self.name)
            self._state = self.CLOSED

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or (self._state == self.CLOSED
                        and self._failures >= self.failure_threshold)):
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                tripped = True
        if tripped:
            _tally("breaker_trips")
            telemetry.counter("resilience.breaker_trips").inc()
            telemetry.emit("breaker_trip", name=self.name,
                           failures=self._failures)
            logger.warning(
                "breaker %s: OPEN after %d consecutive failure(s) — "
                "callers skip the route for the next %.0fs",
                self.name, self._failures, self.reset_timeout_s)

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED


# ---------------------------------------------------------------------------
# poison-record quarantine (dead-letter sink)
# ---------------------------------------------------------------------------


class Quarantine:
    """Append-only JSONL dead-letter sink.

    One line per quarantined item::

        {"ts": 1725000000.0, "site": "stream.read_file",
         "kind": "files", "reason": "AvroDecodeError('...')",
         "path": "/data/in/batch-07.avro"}

    Writes are best-effort: a failing sink logs and drops (the pipeline
    being observed must never die because its dead-letter disk did), but
    the counters still count — the run doc's quarantine totals are
    authoritative even when the sink is absent."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, entry: Dict[str, Any]) -> None:
        try:
            line = json.dumps(entry, default=str)
        except (TypeError, ValueError):
            line = json.dumps({k: repr(v) for k, v in entry.items()})
        try:
            with self._lock:
                with open(self.path, "a") as fh:
                    fh.write(line + "\n")
        except OSError:
            logger.exception("quarantine sink write failed (%s)", self.path)

    def entries(self) -> List[Dict[str, Any]]:
        """Read the sink back (tests / inspection)."""
        out: List[Dict[str, Any]] = []
        try:
            with open(self.path) as fh:
                for line in fh:
                    if line.strip():
                        out.append(json.loads(line))
        except FileNotFoundError:
            pass
        return out


_SINK: Optional[Quarantine] = None


def set_quarantine(sink: Union[Quarantine, str, None]
                   ) -> Optional[Quarantine]:
    """Install the process-wide dead-letter sink (a path builds a
    :class:`Quarantine`; None uninstalls). Returns the previous sink so
    run-scoped installs (the runner's ``quarantineLocation``) can
    restore it."""
    global _SINK
    prev = _SINK
    _SINK = Quarantine(sink) if isinstance(sink, str) else sink
    return prev


def get_quarantine() -> Optional[Quarantine]:
    return _SINK


def quarantine(site: str, reason: str, kind: str = "records",
               count: int = 1, **payload: Any) -> None:
    """Route a poison item to the dead-letter sink and count it.

    ``kind`` is one of ``files`` / ``batches`` / ``records`` (it picks
    the tally and the ``resilience.quarantined_<kind>`` counter);
    ``payload`` carries item identity (path, batch index, row count) and
    — for in-memory batches that exist nowhere else — the ``records``
    themselves, so the dead letter is replayable, not just a tombstone.
    Counting always happens; the JSONL line lands only when a sink is
    installed."""
    key = f"quarantined_{kind}"
    if key not in _TALLY:           # unknown kind still counts somewhere
        key = "quarantined_records"
    _tally(key, count)
    telemetry.counter(f"resilience.{key}").inc(count)  # lint: metric-name — keys are the fixed resilience_stats tally catalog
    telemetry.emit("quarantine", site=site, kind=kind, count=count,
                   reason=reason)
    logger.warning("quarantined %d %s at %s: %s %s",
                   count, kind, site, reason,
                   {k: v for k, v in payload.items() if k != "records"}
                   or "")
    sink = _SINK
    if sink is not None:
        # dead-letter timestamps are epoch wall-clock BY CONTRACT (the
        # JSONL is read by humans/replayers, not compared to perf_counter)
        sink.write({"ts": time.time(), "site": site, "kind": kind,  # lint: wall-clock
                    "count": count, "reason": reason, **payload})


def record_resumed_fit() -> None:
    """Count one ``Workflow.fit(resume_from=...)`` that actually
    warm-started from a checkpoint (tally + telemetry mirror stay
    paired here, like every other resilience count)."""
    _tally("resumed_fits")
    telemetry.counter("resilience.resumed_fits").inc()


def resolve_on_error(on_error: Optional[str]) -> str:
    """The ONE sink-aware default shared by every streaming entry point
    (``stream_score``, ``stream_score_overlapped``, the runner):
    ``None`` resolves to ``"quarantine"`` when a dead-letter sink is
    installed and ``"raise"`` when none is — a quarantined batch whose
    records land nowhere would be silent data loss, so without a sink
    the failure stays loud. Explicit values are validated."""
    if on_error is None:
        return "quarantine" if _SINK is not None else "raise"
    if on_error not in ("quarantine", "raise"):
        raise ValueError(
            f"on_error must be 'quarantine' or 'raise', got {on_error!r}")
    return on_error


def quarantine_batch_or_raise(on_error: str, index: int,
                              error: BaseException, records,
                              rows: Optional[int] = None,
                              site: str = "stream.score_batch") -> None:
    """The ONE poison-batch policy every streaming scorer path shares
    (the plain per-batch path and the overlapped host prep):
    re-raise when quarantine is off or at the head of the stream — a
    first-batch failure is a configuration error (wrong features,
    missing model state), not data poison, and quarantining every batch
    of a misconfigured stream would be silence at scale — otherwise
    route the batch, records included, to the dead-letter sink. A device
    failure (:func:`is_device_failure`) is not data poison: it raises."""
    if on_error == "raise" or index == 0 or is_device_failure(error):
        raise error
    records = list(records)
    quarantine(site, repr(error), kind="batches", index=index,
               rows=len(records) if rows is None else rows,
               records=records)
