"""The horizontal serving fleet: supervised workers behind a failover
router; the port of ``transmogrifai_tpu/fleet.py``.

One :class:`~transmogrifai_tpu_torch.server.ModelServer` is one process.
This module is the layer between processes, where workers die, requests
fail over and the registry pointer must survive any crash:

* :class:`FleetSupervisor` spawns N worker processes, each a whole
  ``python -m transmogrifai_tpu_torch serve --device <device> --preload``
  loading from the shared program banks and resolving its models through
  the shared registry. A worker loads its tenants before it listens, so
  a ready worker is a loaded one (a tenant's program bank takes seconds
  to load on the card, longer than a routed request should wait). Every worker runs on the same device: the card unless
  the caller asks for the CPU (``device="cpu"``, the tests' workers); the
  supervisor never picks one for a worker. It watches liveness through
  each worker's ``/healthz`` → ``/readyz`` probes and its exit code, and
  respawns a crashed worker with jittered exponential backoff
  (:class:`~transmogrifai_tpu_torch.resilience.RetryPolicy` gives the
  delays) up to a respawn budget. The registry's kernel ``flock``
  releases a dead holder's lock, so a crashed worker never wedges a
  sibling's promote.
* :func:`serve_fleet_http` is the stdlib front door. It routes
  ``POST /v1/models/<name>:score`` across ready workers by rendezvous
  hashing of a blake2b key of the request's first record (the
  deterministic discipline of canary routing), retries an idempotent
  score on a sibling when a worker is down or answers 429/503, sheds
  429/503 when the whole fleet is saturated or empty, and aggregates the
  fleet's ``/stats``. Each worker has its own
  :class:`~transmogrifai_tpu_torch.resilience.CircuitBreaker`; an open
  breaker routes around that worker. That is routing between processes,
  not a device fallback: a worker's 500 (a device failure fails its batch
  in the server) passes through to the client and is never retried.
  Canary routing needs no router support: the server's deterministic
  hash-fraction routing sends a given request the same way on every
  worker.
* **Rolling operations.** :meth:`FleetSupervisor.rolling_restart` drains
  and restarts one worker at a time: the router stops sending first (the
  worker leaves the ready set), SIGTERM lets the worker finish every
  accepted request (``shutdown(drain=True)``), and the next worker is
  touched only once the respawn is ready, so a fleet-wide deploy loses no
  request.

Fault sites: ``fleet.forward`` (one routed forward attempt) and
``fleet.spawn`` (one worker spawn), in ``resilience.FAULT_SITES``.

The always-on :func:`fleet_stats` tallies are stamped on every runner
metrics document, telemetry on or off.

Run it with ``python -m transmogrifai_tpu_torch fleet params.json``
(knobs ``customParams.fleetWorkers``, ``fleetBasePort``,
``workerRespawnMax``, ``routerRetryBudget``; ``--device cpu`` for CPU
workers).
"""
from __future__ import annotations

import hashlib
import http.client
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import resilience, telemetry, workload
from .utils import locks

logger = logging.getLogger(__name__)

__all__ = ["FleetSupervisor", "WorkerHandle", "FleetError",
           "serve_fleet_http", "fleet_stats", "reset_fleet_stats",
           "DEFAULT_WORKERS", "DEFAULT_RESPAWN_MAX",
           "DEFAULT_RETRY_BUDGET", "DEFAULT_PROBE_INTERVAL_S",
           "DEFAULT_FORWARD_TIMEOUT_S", "WORKER_DEVICES"]

#: worker processes a fleet runs when the knob is unset
DEFAULT_WORKERS = 2

#: consecutive respawns of ONE worker before the supervisor gives up on
#: it (a worker that dies this many times in a row is broken, not
#: unlucky — respawning it forever would hide the defect)
DEFAULT_RESPAWN_MAX = 5

#: sibling retries the router may spend on one request beyond the first
#: attempt (idempotent scores only — the request either failed over or
#: the fleet sheds it loudly)
DEFAULT_RETRY_BUDGET = 2

#: supervisor probe cadence (process exit codes + /healthz → /readyz)
DEFAULT_PROBE_INTERVAL_S = 0.25

#: per-forward socket timeout; past it the router fails over to a
#: sibling (the worker may still complete — scoring is idempotent, so a
#: duplicate dispatch is waste, never corruption)
DEFAULT_FORWARD_TIMEOUT_S = 30.0

#: the devices a worker serves on (``serve --device``, ``fleet --device``):
#: the card, or the CPU when the caller asks for it
WORKER_DEVICES = ("cuda", "cpu")

#: respawn backoff schedule: jittered exponential via RetryPolicy
#: (resilience.py) — delay_s(attempt) gives 0.1s, 0.2s, 0.4s ... ×
#: jitter, capped at 5s, so a crash-looping worker never spins the
#: supervisor hot and two supervisors never thundering-herd a port
_RESPAWN_BACKOFF = resilience.RetryPolicy(
    max_attempts=DEFAULT_RESPAWN_MAX + 1, base_delay_s=0.1,
    max_delay_s=5.0, multiplier=2.0, jitter=0.5)

#: per-worker breaker thresholds: 3 consecutive forward failures open
#: the breaker; the supervisor's ready-probe flips the worker back long
#: before the reset timeout in the common respawn case
_BREAKER_THRESHOLD = 3
_BREAKER_RESET_S = 5.0


# ---------------------------------------------------------------------------
# always-on tallies (runner metrics documents stamp these; telemetry
# mirrors them)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"workers_spawned": 0, "workers_respawned": 0,
          "worker_crashes": 0, "workers_gave_up": 0,
          "routed_requests": 0, "routed_failed": 0,
          "forwards": 0, "failovers": 0, "breaker_routed_around": 0,
          "shed_429": 0, "shed_503": 0,
          "probe_failures": 0, "rolling_restarts": 0,
          "drained_restarts": 0,
          "worker_deadline_increases": 0, "worker_deadline_decreases": 0,
          "worker_deadline_clamped": 0, "worker_deadline_advisories": 0}


def fleet_stats() -> Dict[str, Any]:
    """Process-wide fleet tallies (always on, telemetry on or off) plus
    the derived ``failover_rate`` (failovers per routed request; None
    before any traffic)."""
    with _TALLY_LOCK:
        out: Dict[str, Any] = dict(_TALLY)
    out["failover_rate"] = (
        round(out["failovers"] / out["routed_requests"], 4)
        if out["routed_requests"] else None)
    return out


def reset_fleet_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n
    telemetry.counter(f"fleet.{key}").inc(n)  # lint: metric-name — keys are the fixed fleet_stats tally catalog


def _note_worker_deadline_counters(agg: Dict[str, Any]) -> None:
    """Mirror the latest fleet-wide online-adaptation totals the
    router's ``/stats`` aggregation summed out of its workers into the
    always-on tallies: each key holds the HIGHEST total seen,
    so ``fleet_stats()`` reports the controllers' fleet-wide activity
    even after a worker respawn resets its own counters."""
    with _TALLY_LOCK:
        for src, dst in (("deadline_increases", "worker_deadline_increases"),
                         ("deadline_decreases", "worker_deadline_decreases"),
                         ("deadline_clamped", "worker_deadline_clamped"),
                         ("deadline_advisories",
                          "worker_deadline_advisories")):
            v = agg.get(src)
            if isinstance(v, int) and v > _TALLY[dst]:
                _TALLY[dst] = v


class FleetError(Exception):
    """Fleet misuse or a fleet that cannot start (no params, no port,
    every worker failed its spawn budget)."""


# ---------------------------------------------------------------------------
# worker handle
# ---------------------------------------------------------------------------

#: worker lifecycle states
STARTING, READY, DRAINING, DEAD, FAILED = (
    "starting", "ready", "draining", "dead", "failed")


class WorkerHandle:
    """One supervised worker process: its Popen, bound port, probe
    state, respawn count and failover breaker. Mutated only by the
    supervisor's monitor thread (spawn/probe/respawn) and read by the
    router; ``state`` transitions are plain attribute writes of interned
    strings (atomic under the GIL)."""

    def __init__(self, wid: int, log_path: str):
        self.wid = wid
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.port_file: Optional[str] = None
        self.state = STARTING
        self.restarts = 0            # consecutive respawns (sustained-
                                     # healthy interval resets — _probe)
        self.spawns = 0              # lifetime spawns
        self.next_spawn_at = 0.0     # monotonic deadline for the respawn
        self.ready_since: Optional[float] = None   # monotonic READY entry
        self.awaiting_ready = False  # a respawn not yet probed READY
        self.last_exit: Optional[int] = None
        #: per-worker failover breaker: open ⇒ the router routes around
        #: this worker without attempting it
        self.breaker = resilience.CircuitBreaker(
            f"fleet.worker[{wid}]", failure_threshold=_BREAKER_THRESHOLD,
            reset_timeout_s=_BREAKER_RESET_S)

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return ("127.0.0.1", self.port) if self.port else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def status(self) -> Dict[str, Any]:
        return {"worker": self.wid, "state": self.state,
                "port": self.port, "pid":
                (self.proc.pid if self.proc else None),
                "alive": self.alive(), "spawns": self.spawns,
                "restarts": self.restarts, "lastExit": self.last_exit,
                "breaker": self.breaker.state, "log": self.log_path}


# ---------------------------------------------------------------------------
# FleetSupervisor
# ---------------------------------------------------------------------------


class FleetSupervisor:
    """Spawn, probe and respawn N serve-worker processes.

    Each worker is a full ``python -m transmogrifai_tpu_torch serve
    <params> --port <p> --port-file <f> --device <device>`` — the SAME
    entry point a single-process deployment uses, so a fleet worker and a
    solo server can never diverge in behavior. ``device`` is every
    worker's device: "cuda" (the default, the card) or "cpu" when the
    caller asks for it. Workers share the params file's
    registry + program banks on disk (both were built process-shareable:
    atomic version records, flocked CURRENT pointer, read-only bank).

    ``base_port`` pins worker ports to ``base_port + wid``; None lets
    each worker bind an ephemeral port and report it through its port
    file (the test-safe default). ``respawn_max`` bounds CONSECUTIVE
    respawns per worker; a worker that comes back ready resets its
    count. ``spawn_env`` overlays the inherited environment."""

    def __init__(self, params_path: str, workers: int = DEFAULT_WORKERS,
                 base_port: Optional[int] = None,
                 respawn_max: int = DEFAULT_RESPAWN_MAX,
                 probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
                 backoff: Optional[resilience.RetryPolicy] = None,
                 log_dir: Optional[str] = None,
                 python: str = sys.executable,
                 spawn_env: Optional[Dict[str, str]] = None,
                 device: str = "cuda"):
        if workers < 1:
            raise FleetError(f"workers must be >= 1, got {workers}")
        if device not in WORKER_DEVICES:
            raise FleetError(f"device must be one of {WORKER_DEVICES}, "
                             f"got {device!r}")
        self.device = device
        self.params_path = str(params_path)
        self.n_workers = int(workers)
        self.base_port = None if base_port is None else int(base_port)
        self.respawn_max = max(int(respawn_max), 0)
        self.probe_interval_s = max(float(probe_interval_s), 0.01)
        self.backoff = backoff or _RESPAWN_BACKOFF
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="tmog_fleet_")
        self.python = python
        self.spawn_env = dict(spawn_env) if spawn_env else None
        os.makedirs(self.log_dir, exist_ok=True)
        self.workers: List[WorkerHandle] = [
            WorkerHandle(i, os.path.join(self.log_dir,
                                         f"worker-{i}.log"))
            for i in range(self.n_workers)]
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # guards spawn/quiesce; order-witnessed under chaos tests
        self._lock = locks.witness_lock("fleet.FleetSupervisor._lock")
        #: workers the router must not send to (rolling restart quiesce)
        self._quiesced: set = set()

    # -- spawn -------------------------------------------------------------
    def _worker_env(self) -> Dict[str, str]:
        """The worker's environment: inherited, overlaid with
        ``spawn_env``, and with THIS package's parent directory on
        PYTHONPATH — a fleet started from a checkout must work from any
        cwd, not only the repo root (`-m transmogrifai_tpu_torch`
        resolves in the child the same way it resolved in the parent)."""
        env = dict(os.environ)
        if self.spawn_env:
            env.update(self.spawn_env)
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        pp = env.get("PYTHONPATH", "")
        if pkg_parent not in pp.split(os.pathsep):
            env["PYTHONPATH"] = (pkg_parent + os.pathsep + pp
                                 if pp else pkg_parent)
        return env

    def _spawn(self, h: WorkerHandle) -> None:
        """(Re)spawn one worker. ``fleet.spawn`` fires first so chaos
        plans can fail a spawn deterministically; a failed spawn counts
        as a crash and re-enters the backoff schedule."""
        resilience.inject("fleet.spawn", worker=h.wid,
                          restarts=h.restarts)
        h.port_file = os.path.join(self.log_dir,
                                   f"worker-{h.wid}.port")
        try:
            os.unlink(h.port_file)
        except FileNotFoundError:
            pass
        port = (self.base_port + h.wid if self.base_port else 0)
        # --preload: the worker loads its tenants before it writes its
        # port file, so READY means loaded and the router never sends a
        # request to a worker that is still loading (a restart's sibling
        # is quiesced meanwhile)
        cmd = [self.python, "-m", "transmogrifai_tpu_torch", "serve",
               self.params_path, "--port", str(port),
               "--port-file", h.port_file, "--device", self.device,
               "--preload"]
        # the worker's output is the SUPERVISOR's to own: an inherited
        # stdout ties worker logs to whatever terminal started the
        # fleet, and a PIPE nobody drains deadlocks the child (TMG309)
        with open(h.log_path, "ab") as log_fh:
            h.proc = subprocess.Popen(cmd, stdout=log_fh,
                                      stderr=subprocess.STDOUT,
                                      env=self._worker_env())
        h.spawns += 1
        h.state = STARTING
        h.port = port or None
        h.last_exit = None
        # a respawn (restarts>0) tallies workers_respawned exactly once,
        # at its FIRST ready probe — readiness flicker after that must
        # not re-count it now that the restarts counter resets lazily
        h.awaiting_ready = h.restarts > 0
        _tally("workers_spawned")
        logger.info("fleet: worker %d spawned (pid %d, port %s)",
                    h.wid, h.proc.pid, port or "ephemeral")

    def start(self) -> None:
        """Spawn every worker and start the monitor thread. Returns
        immediately; use :meth:`wait_ready` to block until the fleet
        serves."""
        for h in self.workers:
            try:
                self._spawn(h)
            except Exception as e:  # lint: broad-except — a failed first spawn enters the respawn/backoff path instead of killing the fleet
                logger.exception("fleet: spawn of worker %d failed",
                                 h.wid)
                self._note_crash(h, error=repr(e))
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="fleet-monitor",
                                         daemon=True)
        self._monitor.start()

    def wait_ready(self, min_workers: Optional[int] = None,
                   timeout_s: float = 120.0) -> List[WorkerHandle]:
        """Block until at least ``min_workers`` (default: all) workers
        are READY; raises :class:`FleetError` on timeout with each
        worker's status (and log path) in the message."""
        need = self.n_workers if min_workers is None else int(min_workers)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ready = self.ready_workers()
            if len(ready) >= need:
                return ready
            if all(h.state == FAILED for h in self.workers):
                break
            time.sleep(0.05)
        raise FleetError(
            f"fleet not ready after {timeout_s:g}s (need {need}): "
            + json.dumps([h.status() for h in self.workers]))

    # -- monitor -----------------------------------------------------------
    def _note_crash(self, h: WorkerHandle, error: str = "") -> None:
        h.state = DEAD
        h.ready_since = None
        _tally("worker_crashes")
        h.restarts += 1  # lint: thread-escape — every caller holds FleetSupervisor._lock across _note_crash
        if h.restarts > self.respawn_max:
            h.state = FAILED
            _tally("workers_gave_up")
            telemetry.emit("fleet_worker", worker=h.wid, action="gave_up",
                           restarts=h.restarts)
            logger.error("fleet: worker %d exceeded respawn budget "
                         "(%d) — giving up%s", h.wid, self.respawn_max,
                         f": {error}" if error else "")
            return
        delay = self.backoff.delay_s(h.restarts - 1)
        h.next_spawn_at = time.monotonic() + delay
        telemetry.emit("fleet_worker", worker=h.wid, action="crashed",
                       exit=h.last_exit, respawn_in_s=round(delay, 3))
        logger.warning("fleet: worker %d died (exit %s)%s — respawn "
                       "%d/%d in %.2fs", h.wid, h.last_exit,
                       f" [{error}]" if error else "", h.restarts,
                       self.respawn_max, delay)

    def _probe(self, h: WorkerHandle) -> None:
        """liveness (/healthz) → readiness (/readyz) for one live
        worker. A draining worker (healthz 503) leaves the ready set
        immediately so the router stops sending BEFORE the process
        exits; a ready probe resets the consecutive-respawn count and
        closes the failover breaker."""
        if h.port is None and h.port_file:
            # ephemeral port: the worker writes it once bound
            try:
                with open(h.port_file) as fh:
                    h.port = int(fh.read().strip() or 0) or None
            except (OSError, ValueError):
                h.port = None
        if h.port is None:
            return                       # still booting
        def get(path: str) -> int:
            # one connection per probe: the stdlib front end is
            # HTTP/1.0 (no keep-alive), a reused connection would
            # CannotSendRequest on the second round-trip
            conn = http.client.HTTPConnection("127.0.0.1", h.port,
                                              timeout=2.0)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                resp.read()
                return resp.status
            finally:
                conn.close()

        try:
            live = get("/healthz")
            if live != 200:
                if h.state == READY:
                    logger.info("fleet: worker %d draining "
                                "(healthz %d)", h.wid, live)
                h.state = DRAINING
                return
            rdy = get("/readyz")
        except OSError:
            _tally("probe_failures")
            if h.state == READY:
                h.state = STARTING       # unreachable: not routable
            return
        if rdy == 200:
            self._note_ready(h)
        elif h.state == READY:
            h.state = STARTING           # lost readiness (queues full)
            h.ready_since = None

    def _note_ready(self, h: WorkerHandle) -> None:
        """One successful readiness probe. The consecutive-crash budget
        resets only after a SUSTAINED-healthy interval — READY for at
        least the backoff schedule's max delay (was: reset on the FIRST
        ready probe, which let a flicker-ready crash loop evade the
        budget forever, while the budget's original never-resetting
        draft meant a worker crashing once a day eventually exhausted
        ``workerRespawnMax``). After the interval, the next crash is a
        NEW incident, not the same crash loop."""
        now = time.monotonic()
        if h.state != READY:
            logger.info("fleet: worker %d ready on port %s (spawn %d)",
                        h.wid, h.port, h.spawns)
            h.ready_since = now
            if h.awaiting_ready:
                _tally("workers_respawned")
                h.awaiting_ready = False
        h.state = READY
        h.breaker.reset()
        if h.restarts and h.ready_since is not None \
                and now - h.ready_since >= self.backoff.max_delay_s:
            logger.info("fleet: worker %d healthy for %.1fs — "
                        "consecutive-crash budget reset", h.wid,
                        now - h.ready_since)
            with self._lock:   # restart_worker writes restarts under it
                h.restarts = 0

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            for h in self.workers:
                if self._stop.is_set():
                    return
                if h.state == FAILED:
                    continue
                with self._lock:
                    # a quiesced worker is under a DELIBERATE
                    # drain-then-restart: its exit is not a crash and
                    # restart_worker owns the respawn — the monitor
                    # only keeps probing it (the probe flips READY)
                    quiesced = h.wid in self._quiesced
                    if not quiesced and h.proc is not None \
                            and h.proc.poll() is not None \
                            and h.state != DEAD:
                        h.last_exit = h.proc.returncode
                        self._note_crash(h)
                    if not quiesced and h.state == DEAD \
                            and time.monotonic() >= h.next_spawn_at:
                        try:
                            self._spawn(h)  # lint: lock-blocking — the DEAD check and handle flip must be atomic with the spawn; probes never take _lock, so the stall is bounded by fork/exec
                        except Exception as e:  # lint: broad-except — a failed respawn re-enters the backoff schedule, the monitor survives
                            logger.exception(
                                "fleet: respawn of worker %d failed",
                                h.wid)
                            self._note_crash(h, error=repr(e))
                if h.alive() and h.state not in (DEAD, FAILED):
                    self._probe(h)
            self._stop.wait(self.probe_interval_s)

    # -- routing view ------------------------------------------------------
    def ready_workers(self) -> List[WorkerHandle]:
        return [h for h in self.workers
                if h.state == READY and h.wid not in self._quiesced
                and h.alive()]

    def status(self) -> Dict[str, Any]:
        return {"workers": [h.status() for h in self.workers],
                "ready": len(self.ready_workers()),
                "quiesced": sorted(self._quiesced),
                "fleet": fleet_stats()}

    # -- rolling operations ------------------------------------------------
    def restart_worker(self, h: WorkerHandle,
                       ready_timeout_s: float = 120.0) -> None:
        """Drain-then-restart ONE worker with zero dropped requests:
        quiesce it (the router stops sending first), SIGTERM it (the
        serve entry point drains every accepted request before exit),
        wait for the exit, respawn, wait READY, unquiesce."""
        with self._lock:
            self._quiesced.add(h.wid)
        try:
            if h.alive():
                h.state = DRAINING
                h.proc.send_signal(signal.SIGTERM)
                h.proc.wait(timeout=ready_timeout_s)
                h.last_exit = h.proc.returncode
            with self._lock:
                h.restarts = 0          # deliberate restart, not a crash
                self._spawn(h)  # lint: lock-blocking — quiesce/spawn must flip atomically or the monitor would respawn the same worker concurrently
            deadline = time.monotonic() + ready_timeout_s
            while time.monotonic() < deadline:
                if h.state == READY:
                    _tally("drained_restarts")
                    return
                time.sleep(0.05)
            raise FleetError(
                f"worker {h.wid} not ready after drained restart "
                f"({ready_timeout_s:g}s): {h.status()}")
        finally:
            with self._lock:
                self._quiesced.discard(h.wid)

    def rolling_restart(self, ready_timeout_s: float = 120.0) -> None:
        """Drain-then-restart every worker, ONE at a time — the
        fleet-wide deploy/promote primitive (a promoted CURRENT pointer
        is picked up by each worker as it reloads)."""
        _tally("rolling_restarts")
        telemetry.emit("fleet", action="rolling_restart",
                       workers=self.n_workers)
        for h in self.workers:
            if h.state == FAILED:
                continue
            self.restart_worker(h, ready_timeout_s=ready_timeout_s)

    # -- shutdown ----------------------------------------------------------
    def stop(self, drain: bool = True, timeout_s: float = 60.0) -> None:
        """Stop the fleet. ``drain`` SIGTERMs every worker (each drains
        its accepted requests); otherwise SIGKILL. Idempotent."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout_s)
        for h in self.workers:
            if not h.alive():
                continue
            try:
                h.proc.send_signal(
                    signal.SIGTERM if drain else signal.SIGKILL)
            except OSError:
                continue
        deadline = time.monotonic() + timeout_s
        for h in self.workers:
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=max(deadline - time.monotonic(),
                                        0.1))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=10)
            h.state = DEAD


# ---------------------------------------------------------------------------
# front-door router
# ---------------------------------------------------------------------------


def _route_key(name: str, records: Sequence[Any]) -> bytes:
    """Stable routing key: model name + the request's FIRST record,
    blake2b-hashed — the same O(1), deterministic discipline as canary
    routing (server._canaried), so the SAME request routes the same way
    across router restarts. Unserializable payloads key on the model
    name alone (routing must never fail a request)."""
    try:
        blob = json.dumps(records[0] if records else None,
                          sort_keys=True, default=str).encode()
    except (TypeError, ValueError):
        blob = b"?"
    return hashlib.blake2b(name.encode() + b"\0" + blob,
                           digest_size=8).digest()


def _rendezvous(key: bytes, workers: List[WorkerHandle]
                ) -> List[WorkerHandle]:
    """Highest-random-weight order of ``workers`` for ``key``: the
    first entry owns the request; the rest are the failover sequence.
    Adding/removing one worker remaps only that worker's share of the
    keyspace (consistent hashing without a ring)."""
    def score(h: WorkerHandle) -> int:
        return int.from_bytes(
            hashlib.blake2b(key + str(h.wid).encode(),
                            digest_size=8).digest(), "big")
    return sorted(workers, key=score, reverse=True)


def _forward(h: WorkerHandle, method: str, path: str,
             body: Optional[bytes], timeout_s: float,
             headers: Optional[Dict[str, str]] = None
             ) -> Tuple[int, bytes]:
    """One forward attempt to one worker; raises OSError on transport
    failure (the failover trigger). ``fleet.forward`` fires first so
    chaos plans can fail forwards deterministically. ``headers``
    overlay the defaults — the router's minted ``X-Tmog-Trace`` rides
    here."""
    resilience.inject("fleet.forward", worker=h.wid, path=path)
    if h.port is None:
        # mid-respawn: the new process has not reported its port yet
        raise OSError(f"worker {h.wid} has no bound port")
    conn = http.client.HTTPConnection("127.0.0.1", h.port,
                                      timeout=timeout_s)
    try:
        hdrs = ({"Content-Type": "application/json"}
                if body is not None else {})
        if headers:
            hdrs.update(headers)
        conn.request(method, path, body, hdrs)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def serve_fleet_http(supervisor: FleetSupervisor,
                     host: str = "127.0.0.1", port: int = 8000,
                     retry_budget: int = DEFAULT_RETRY_BUDGET,
                     forward_timeout_s: float = DEFAULT_FORWARD_TIMEOUT_S):
    """Start the fleet front door on a daemon thread; returns the
    ``ThreadingHTTPServer`` (``.server_address`` carries the bound
    port, ``.shutdown()`` stops it). Stdlib only, like ``serve_http``.

    Routing table::

        POST /v1/models/<name>:score  consistent-hash + sibling failover
        POST /v1/models/<name>:*      any ready worker (shared registry;
                                      transport failures NOT retried —
                                      deploy/rollback are not idempotent)
        GET  /stats                   fleet aggregate + per-worker stats
        GET  /healthz                 router liveness + worker states
        GET  /readyz                  200 iff >= 1 worker is ready
        GET  <anything else>          proxied to any ready worker
    """
    from http.server import BaseHTTPRequestHandler

    from .server import HTTPListener

    #: statuses that mean "this worker cannot serve the request right
    #: now" — retry the idempotent score on a sibling. 429 retries too
    #: (ONE saturated queue is not fleet saturation); every sibling
    #: saturated sheds 429 to the client.
    _RETRY_STATUSES = frozenset({429, 503})

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # route through logging
            logger.debug("fleet-http: " + fmt, *args)

        def _send(self, code: int, doc: Any,
                  raw: Optional[bytes] = None) -> None:
            body = raw if raw is not None else json.dumps(
                doc, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- routed forward with failover ----------------------------------
        def _route(self, method: str, key: bytes,
                   body: Optional[bytes],
                   idempotent: bool = True,
                   wl_model: Optional[str] = None,
                   wl_records: Optional[list] = None) -> None:
            """``idempotent=False`` (deploy/rollback — they MUTATE the
            shared registry) never retries a transport failure: an
            OSError after the request was sent cannot prove the worker
            did not apply it, and a blind sibling retry would
            double-apply the pointer mutation. A worker-ANSWERED
            429/503 means the request was refused before it was
            applied, so the sibling retry stays safe either way.

            The router is the fleet's trace entry point: every routed
            request carries an ``X-Tmog-Trace`` traceparent — the
            client's if it sent one, MINTED here otherwise — so the
            router span, the worker's request span and the
            micro-batcher's batch span all share one trace id. A failover
            retry reuses the same traceparent: one request, one trace,
            however many workers it visited.

            With the workload flight recorder installed
            (``customParams.workloadDir``), every routed :score
            request (``wl_model`` set by ``do_POST``) leaves one
            record carrying the ROUTING DECISION — owning worker,
            attempt count, failover count — and the client-visible
            outcome; the worker's own record (same trace id)
            contributes the payload and phase decomposition, and
            ``workload merge`` combines the two."""
            _tally("routed_requests")
            wl_t0 = time.perf_counter()
            trace_hdr = self.headers.get(telemetry.TRACE_HEADER)
            ctx = telemetry.parse_traceparent(trace_hdr)
            if ctx is None:
                ctx = telemetry.mint_trace()
                trace_hdr = telemetry.format_traceparent(*ctx)
            fwd_headers = {telemetry.TRACE_HEADER: trace_hdr}

            def _wl_record(status: int, worker: Optional[int],
                           attempts: int) -> None:
                if wl_model is None or not workload.recording_enabled():
                    return
                # no payload here: the worker's record (same trace id)
                # carries it via zero-copy splice, and merge folds the
                # two — the router's writer never serializes bodies
                workload.record_request(
                    model=wl_model,
                    rows=len(wl_records or ()),
                    trace_id=ctx[0],
                    t_arrival=wl_t0,
                    outcome={"status": status, "ok": status == 200},
                    phases={"e2e": time.perf_counter() - wl_t0},
                    route={"worker": worker, "attempts": attempts,
                           "failovers": max(attempts - 1, 0)})
            if not supervisor.ready_workers():
                _tally("shed_503")
                _tally("routed_failed")
                _wl_record(503, None, 0)
                return self._send(503, {
                    "error": "no ready worker (fleet empty or all "
                             "draining)"})
            attempts = 0
            last: Optional[Tuple[int, bytes]] = None
            tried: set = set()
            while attempts <= retry_budget:
                # the next untried worker in rendezvous order among those
                # ready NOW: in a rolling restart the worker that just came
                # back is a sibling for a request whose first worker began
                # its drain, though it was quiesced when the request came
                h = next((c for c in _rendezvous(
                    key, supervisor.ready_workers()) if c.wid not in tried),
                    None)
                if h is None:
                    break
                tried.add(h.wid)
                if not h.breaker.allow():
                    # open breaker: route AROUND without attempting —
                    # a known-bad worker must not eat the retry budget
                    _tally("breaker_routed_around")
                    continue
                attempts += 1
                if attempts > 1:
                    _tally("failovers")
                try:
                    _tally("forwards")
                    with telemetry.trace_scope(ctx):
                        with telemetry.span(
                                "fleet:route", worker=h.wid,
                                path=self.path, attempt=attempts):
                            status, payload = _forward(
                                h, method, self.path, body,
                                forward_timeout_s,
                                headers=fwd_headers)
                except OSError as e:
                    h.breaker.record_failure()
                    logger.warning("fleet: forward to worker %d "
                                   "failed (%r); %s", h.wid, e,
                                   "failing over" if idempotent
                                   else "NOT retried (non-idempotent)")
                    last = (503 if idempotent else 502, json.dumps(
                        {"error": f"worker {h.wid} unreachable: "
                                  f"{e!r}"
                                  + ("" if idempotent else
                                     " — not retried: the request "
                                     "mutates shared state and may "
                                     "already have applied")}).encode())
                    if not idempotent:
                        break
                    continue
                if status in _RETRY_STATUSES:
                    # the worker answered but cannot serve (draining /
                    # saturated) — transport is fine, don't trip the
                    # breaker, do try a sibling
                    last = (status, payload)
                    continue
                h.breaker.record_success()
                _wl_record(status, h.wid, attempts)
                return self._send(status, None, raw=payload)
            status = last[0] if last else 503
            _tally("routed_failed")
            _tally("shed_429" if status == 429 else "shed_503")
            _wl_record(status, None, attempts)
            self._send(status, None,
                       raw=last[1] if last else json.dumps(
                           {"error": "fleet saturated"}).encode())

        # -- aggregation ---------------------------------------------------
        def _stats(self) -> Dict[str, Any]:
            doc: Dict[str, Any] = {"fleet": supervisor.status(),
                                   "workers": {}, "aggregate": {}}
            agg: Dict[str, float] = {}
            for h in supervisor.workers:
                if h.state != READY or h.port is None:
                    doc["workers"][h.wid] = {"state": h.state}
                    continue
                try:
                    status, payload = _forward(h, "GET", "/stats", None,
                                               forward_timeout_s)
                    wdoc = json.loads(payload)
                except (OSError, ValueError) as e:
                    doc["workers"][h.wid] = {"state": h.state,
                                             "error": repr(e)}
                    continue
                doc["workers"][h.wid] = wdoc
                for k, v in (wdoc.get("server") or {}).items():
                    # counters only: the per-worker DERIVED ratios
                    # (coalescing factor, bank hit rate, slo
                    # attainment) are floats and must not be summed
                    if isinstance(v, int) and not isinstance(v, bool):
                        agg[k] = agg.get(k, 0) + v
            # fleet-wide ratios recomputed from the summed counters
            if agg.get("batches"):
                agg["batch_coalescing_factor"] = round(
                    agg.get("requests", 0) / agg["batches"], 3)
                agg["bank_hit_rate"] = round(
                    agg.get("bank_hit_batches", 0) / agg["batches"], 3)
            tracked = agg.get("slo_met", 0) + agg.get("slo_missed", 0)
            if tracked:
                agg["slo_attainment"] = round(
                    agg.get("slo_met", 0) / tracked, 4)
            _note_worker_deadline_counters(agg)
            doc["aggregate"] = agg
            return doc

        def _metrics(self) -> None:
            """The router's live Prometheus plane: its OWN registry
            (fleet.* counters) plus every READY worker's ``/metrics``
            scrape, merged by SUMMING samples with the same name+labels
            and re-rendering (`telemetry.render_prometheus_sum`) — the
            fleet-wide scrape surface ``/stats`` never was. Unreachable
            workers are skipped (scrape-time liveness is the probe
            loop's job, not the scraper's); the worker count that
            actually answered rides in ``fleet_metrics_workers``."""
            docs = [telemetry.parse_prometheus(
                telemetry.render_prometheus())]
            answered = 0
            for h in supervisor.ready_workers():
                try:
                    status, payload = _forward(h, "GET", "/metrics",
                                               None, forward_timeout_s)
                    if status != 200:
                        continue
                    # one parse per worker: it both validates (a bad
                    # scrape is skipped, not summed) and feeds the
                    # merge directly
                    docs.append(telemetry.parse_prometheus(
                        payload.decode("utf-8", "replace")))
                    answered += 1
                except (OSError, ValueError) as e:
                    logger.warning("fleet: /metrics scrape of worker "
                                   "%d failed: %r", h.wid, e)
            body = telemetry.merge_parsed_prometheus(docs)
            body += (f"# TYPE fleet_metrics_workers gauge\n"
                     f"fleet_metrics_workers {answered}\n")
            raw = body.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):
            if self.path == "/metrics":
                return self._metrics()
            if self.path == "/healthz":
                return self._send(200, {
                    "status": "ok",
                    "workers": [h.status()
                                for h in supervisor.workers]})
            if self.path == "/readyz":
                n = len(supervisor.ready_workers())
                return self._send(200 if n else 503,
                                  {"ready": bool(n), "readyWorkers": n})
            if self.path == "/stats":
                return self._send(200, self._stats())
            ready = supervisor.ready_workers()
            if not ready:
                _tally("shed_503")
                return self._send(503, {"error": "no ready worker"})
            key = _route_key(self.path, [])
            return self._route("GET", key, None)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b"{}"
            if self.path.startswith("/v1/models/") \
                    and self.path.endswith(":score"):
                name = self.path[len("/v1/models/"):-len(":score")]
                try:
                    records = (json.loads(body) or {}).get("records")
                except ValueError:
                    records = None
                key = _route_key(name, records
                                 if isinstance(records, list) else [])
                return self._route(
                    "POST", key, body, wl_model=name,
                    wl_records=(records if isinstance(records, list)
                                else None))
            # non-score POSTs (deploy/rollback) MUTATE the shared
            # registry: any ready worker serves them, but a transport
            # failure is NOT retried (idempotent=False above)
            key = _route_key(self.path, [])
            return self._route("POST", key, body, idempotent=False)

    httpd = HTTPListener((host, port), Handler)
    t = threading.Thread(target=httpd.serve_forever,
                         name="fleet-http", daemon=True)
    t.start()
    logger.info("fleet front door on %s:%d (%d workers)",
                *httpd.server_address, supervisor.n_workers)
    return httpd
