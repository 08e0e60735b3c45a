"""Continuous training: drift-triggered, crash-safe, storm-controlled;
the port of ``transmogrifai_tpu/continual.py``.

The :class:`~transmogrifai_tpu_torch.lifecycle.DriftSentinel` detects
drift and the server's shadow and canary rollouts deploy models; this
module closes the loop between them. An unattended retrain loop has two
failure modes that matter, doing nothing (a dead thread while the model
rots) and doing too much (a retrain-crash-retrain loop), and every
mechanism here pins one of them down:

* :class:`RetrainController` subscribes to a tenant's drift windows
  (``ModelServer.subscribe_drift``) and, after ``arm_windows``
  consecutive drifted windows (hysteresis: one noisy window never
  trains), launches a **supervised retrain job**: a subprocess with its
  output in a per-job log, its exit code watched, a heartbeat staleness
  check (the log's or the heartbeat file's mtime), a kill on timeout and
  :class:`~transmogrifai_tpu_torch.resilience.RetryPolicy` backoff
  between failures. The trainer is any command; on the card it trains
  with the port's tree kernels and exports a program bank, and where it
  trains is its own business: the controller only supervises it.
* The **job record** is crash-safe: one JSON file a job under the job
  directory, each write atomic (tmp + ``os.replace``), and the ACTIVE
  slot guarded by a kernel ``flock``, so two controllers (one per fleet
  worker, or a controller racing a manual ``registry promote``) never
  retrain twice or fight over the pointer. A controller that died in the
  middle of a job leaves a ``running`` record that a fresh process's
  :meth:`RetrainController.recover` marks ``interrupted``, replayable
  through :meth:`RetrainController.replay` when the trainer finished its
  save, with the CURRENT pointer untouched either way.
* **Warm start.** The trainer is handed the stable model's directory; its
  persisted train-time sufficient statistics merge with the fresh
  slice's (``Workflow.with_warm_fit_stats``), so the refit is a Chan
  merge plus one pass over the fresh data. Missing or corrupt statistics
  give a full refit with a TMG604 advisory (:func:`load_warm_stats`),
  never a failed job.
* **Evidence-gated promotion.** A successful job registers the new
  version (the ``continual.register`` fault site: a crash there leaves
  the record replayable and the pointer untouched) and hands it to the
  server's shadow or canary rollout, whose clean windows promote it; a
  failing candidate rolls back while the stable version keeps serving. A
  candidate whose holdout metric is worse than the stable version's is
  rejected before any traffic reaches it.
* **Storm control.** A cooldown after every job, jittered backoff added
  on failures, and a consecutive-failure budget after which the
  controller goes loudly ``FAILED`` (TMG605) and disarms.

In a fleet every serve worker may run a controller
(``customParams.retrainOnDrift``); the shared ACTIVE flock in the
registry's job directory lets exactly one retrain, and the others see
the promote through the registry pointer. The always-on
:func:`continual_stats` tallies ride on every runner metrics document;
state changes go to the ``on_retrain`` listener hook and the
``continual.*`` counters.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from . import resilience, telemetry
from .utils import locks

logger = logging.getLogger(__name__)

__all__ = ["RetrainController", "ContinualError", "load_warm_stats",
           "validate_retrain_cmd",
           "continual_stats", "reset_continual_stats",
           "DEFAULT_ARM_WINDOWS", "DEFAULT_COOLDOWN_S",
           "DEFAULT_MAX_FAILURES", "DEFAULT_TIMEOUT_S",
           "DEFAULT_HEARTBEAT_TIMEOUT_S"]

#: consecutive drifted comparison windows before the controller arms a
#: retrain — hysteresis: one noisy window must never cost a train job
DEFAULT_ARM_WINDOWS = 2

#: seconds after ANY finished job (success or failure) during which new
#: triggers are suppressed — the floor of the storm-control schedule
DEFAULT_COOLDOWN_S = 300.0

#: consecutive failed/killed/rejected jobs before the controller goes
#: LOUDLY FAILED (TMG605) and disarms
DEFAULT_MAX_FAILURES = 3

#: hard wall-clock bound on one retrain job; past it the trainer is
#: SIGKILLed and the job counts as a failure
DEFAULT_TIMEOUT_S = 3600.0

#: staleness bound on the job's heartbeat (its log file's — or the
#: TMOG_RETRAIN_HEARTBEAT file's — mtime): a trainer silent for this
#: long is stuck, not slow, and is killed rather than waited on
DEFAULT_HEARTBEAT_TIMEOUT_S = 600.0

#: backoff stacked ON TOP of the cooldown after failed jobs (jittered
#: exponential, the fleet respawn discipline): failures 1, 2, 3 wait
#: cooldown + ~30s, ~60s, ~120s ... capped at 10 min
_FAILURE_BACKOFF = resilience.RetryPolicy(
    max_attempts=DEFAULT_MAX_FAILURES + 1, base_delay_s=30.0,
    max_delay_s=600.0, multiplier=2.0, jitter=0.25)

#: drift advisory rules that count as a drifted window
_DRIFT_RULES = frozenset({"TMG601", "TMG602"})

JOBS_DIR = "jobs"
ACTIVE_LOCK = "ACTIVE.lock"

#: job record states
PENDING, RUNNING, REGISTERED, DEPLOYED, SUCCEEDED = (
    "pending", "running", "registered", "deployed", "succeeded")
FAILED, KILLED, REJECTED, INTERRUPTED = (
    "failed", "killed", "rejected", "interrupted")

_TERMINAL_BAD = frozenset({FAILED, KILLED, REJECTED, INTERRUPTED})


# ---------------------------------------------------------------------------
# always-on tallies (runner metrics documents stamp these; telemetry
# mirrors them)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"windows_seen": 0, "drifted_windows": 0, "triggers": 0,
          "suppressed_cooldown": 0, "suppressed_active": 0,
          "suppressed_disarmed": 0, "jobs_started": 0,
          "jobs_succeeded": 0, "jobs_failed": 0, "jobs_killed": 0,
          "jobs_recovered": 0, "jobs_replayed": 0,
          "candidates_rejected": 0, "orphans_killed": 0, "gave_up": 0,
          "warm_starts": 0, "full_refit_fallbacks": 0}


def continual_stats() -> Dict[str, int]:
    """Snapshot of the process-wide continuous-training tallies (always
    on, telemetry on or off): drift windows seen,
    triggers armed vs storm-suppressed, job outcomes, holdout
    rejections, recovery/replay traffic and the warm-start vs
    full-refit split."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_continual_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n
    telemetry.counter(f"continual.{key}").inc(n)  # lint: metric-name — keys are the fixed continual_stats tally catalog


class ContinualError(Exception):
    """Controller misuse: no registry, malformed trainer command,
    replay of a non-replayable job."""


def validate_retrain_cmd(cmd) -> List[str]:
    """The ONE trainer-command shape check (`cli check`'s TMG001, the
    serve wiring and the controller constructor all call it — one
    predicate, no drift): a non-empty list of argv strings."""
    if (not isinstance(cmd, (list, tuple)) or not cmd
            or not all(isinstance(c, str) for c in cmd)):
        raise ContinualError(
            f"retrain command must be a non-empty list of argv "
            f"strings, got {cmd!r}")
    return [str(c) for c in cmd]


# ---------------------------------------------------------------------------
# warm-start loading (the graceful-degradation seam)
# ---------------------------------------------------------------------------


def load_warm_stats(model_dir: Optional[str]):
    """The stable model's persisted sufficient statistics for
    ``Workflow.with_warm_fit_stats`` — or ``None`` with a TMG604
    advisory when the dir is missing, predates the persistence, or the
    block is corrupt. The retrain then runs a FULL refit over the fresh
    window: warm start is an optimization, never a dependency."""
    from . import fitstats, lint
    stats = None
    if model_dir:
        stats = fitstats.load_sufficient_stats(model_dir)
    if stats:
        _tally("warm_starts")
        return stats
    _tally("full_refit_fallbacks")
    f = lint.Finding(
        "TMG604", "warm-start sufficient statistics unavailable at "
        f"{model_dir!r} — the retrain runs a full refit over the "
        "fresh window")
    lint.emit_findings([f])
    logger.warning("continual: %s", f.format())
    return None


def _pid_alive(pid: Optional[int]) -> bool:
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    return True


def _metric_of(doc: Any, key: str) -> Optional[float]:
    """Depth-first search for a numeric metric named ``key`` in a
    nested metrics document (train summaries nest the evaluation under
    stages/trainEvaluation/holdoutEvaluation)."""
    if isinstance(doc, dict):
        v = doc.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        for sub in doc.values():
            found = _metric_of(sub, key)
            if found is not None:
                return found
    elif isinstance(doc, (list, tuple)):
        for sub in doc:
            found = _metric_of(sub, key)
            if found is not None:
                return found
    return None


# ---------------------------------------------------------------------------
# RetrainController
# ---------------------------------------------------------------------------


class RetrainController:
    """Drift → supervised retrain job → register → evidence-gated
    rollout, safe to run unattended.

    ``retrain_cmd`` is the trainer: any command (typically a project
    training script) that reads its contract from the environment —

    ========================  =============================================
    ``TMOG_RETRAIN_MODEL``    the model name being retrained
    ``TMOG_RETRAIN_OUT``      output dir: the trainer MUST save the new
                              model under ``<out>/model`` and MAY ship
                              its program bank under ``<out>/export``
                              and a metrics doc at ``<out>/metrics.json``
    ``TMOG_RETRAIN_STABLE``   the stable version's model dir (warm-start
                              source: :func:`load_warm_stats`)
    ``TMOG_RETRAIN_TRIGGER``  JSON file with the drift window that armed
                              this job (the sentinel's last report)
    ``TMOG_RETRAIN_HEARTBEAT``  a file the trainer may touch to prove
                              liveness; the job log's mtime counts too
    ========================  =============================================

    The controller monitors exit code + heartbeat, kills on timeout or
    staleness, and on success registers the export
    (``continual.register`` fault site) then hands it to the attached
    server's shadow/canary rollout — promotion stays evidence-gated and
    a failed candidate auto-rolls back with the stable version serving
    throughout. See the module docstring for the crash-safety and
    storm-control contracts."""

    def __init__(self, name: str, registry, retrain_cmd: Sequence[str],
                 job_dir: Optional[str] = None, server=None,
                 arm_windows: int = DEFAULT_ARM_WINDOWS,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 max_failures: int = DEFAULT_MAX_FAILURES,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
                 backoff: Optional[resilience.RetryPolicy] = None,
                 deploy_mode: str = "canary",
                 canary_fraction: Optional[float] = None,
                 window_requests: Optional[int] = None,
                 promote_windows: Optional[int] = None,
                 holdout_metric: str = "AuPR",
                 holdout_tolerance: float = 0.0,
                 spawn_env: Optional[Dict[str, str]] = None,
                 trace_dir: Optional[str] = None):
        if registry is None:
            raise ContinualError("RetrainController needs a registry")
        cmd = validate_retrain_cmd(retrain_cmd)
        if deploy_mode not in ("canary", "shadow"):
            raise ContinualError(
                f"deploy_mode must be 'canary' or 'shadow', "
                f"got {deploy_mode!r}")
        self.name = str(name)
        self.registry = registry
        self.retrain_cmd = cmd
        self.server = server
        self.job_dir = str(job_dir) if job_dir else os.path.join(
            registry.root, self.name, "retrain")
        self.arm_windows = max(int(arm_windows), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.max_failures = max(int(max_failures), 1)
        self.timeout_s = float(timeout_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.backoff = backoff or _FAILURE_BACKOFF
        self.deploy_mode = deploy_mode
        self.canary_fraction = canary_fraction
        self.window_requests = window_requests
        self.promote_windows = promote_windows
        self.holdout_metric = str(holdout_metric)
        self.holdout_tolerance = float(holdout_tolerance)
        self.spawn_env = dict(spawn_env) if spawn_env else None
        #: shared trace-shard directory (customParams.traceDir): the
        #: retrain subprocess inherits it (TMOG_TRACE_DIR) so its
        #: runner writes a shard into the SAME merge set as the fleet
        self.trace_dir = str(trace_dir) if trace_dir else None
        os.makedirs(os.path.join(self.job_dir, JOBS_DIR), exist_ok=True)
        self._lock = locks.witness_lock("continual.RetrainController._lock")
        self._streak = 0
        self._failures = 0
        self._disarmed = False
        self._cooldown_until = 0.0           # monotonic deadline
        self._thread: Optional[threading.Thread] = None
        self.last_job: Optional[Dict[str, Any]] = None

    # -- job record IO (atomic, one file per job) --------------------------
    def _job_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir, JOBS_DIR, f"{job_id}.json")

    def _write_job(self, job: Dict[str, Any]) -> None:
        path = self._job_path(job["jobId"])
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(job, fh, indent=1, default=str)
        os.replace(tmp, path)

    def jobs(self) -> List[Dict[str, Any]]:
        """Every job record, oldest first (createdAt order)."""
        d = os.path.join(self.job_dir, JOBS_DIR)
        out: List[Dict[str, Any]] = []
        try:
            files = [f for f in os.listdir(d) if f.endswith(".json")]
        except FileNotFoundError:
            return out
        for fn in files:
            try:
                with open(os.path.join(d, fn)) as fh:
                    doc = json.load(fh)
            except (OSError, ValueError):
                logger.warning("continual: unreadable job record %s", fn)
                continue
            # the per-job trigger-evidence sidecar is JSON too — only
            # documents with a jobId are job records
            if isinstance(doc, dict) and doc.get("jobId"):
                out.append(doc)
        out.sort(key=lambda j: (j.get("createdAt", 0.0),
                                j.get("jobId", "")))
        return out

    def job(self, job_id: str) -> Dict[str, Any]:
        with open(self._job_path(job_id)) as fh:
            return json.load(fh)

    # -- the drift trigger (sentinel window callback) ----------------------
    def attach(self) -> "RetrainController":
        """Subscribe to the attached server's drift windows for this
        tenant (``ModelServer.subscribe_drift`` — the subscription
        survives sentinel rebuilds across promotes/reloads)."""
        if self.server is None:
            raise ContinualError("attach() needs a server "
                                 "(RetrainController(server=...))")
        self.server.subscribe_drift(self.name, self.on_window)
        return self

    def on_window(self, findings: List[Any],
                  report: Optional[Dict[str, Any]]) -> None:
        """One completed drift-comparison window: advance the hysteresis
        streak (drifted) or reset it (clean); arm a retrain once
        ``arm_windows`` consecutive drifted windows accumulate and the
        storm controls (cooldown, active job, failure budget) allow.
        Cheap and non-blocking — it runs on the sentinel thread."""
        drifted = any(getattr(f, "rule", None) in _DRIFT_RULES
                      for f in findings)
        _tally("windows_seen")
        if drifted:
            _tally("drifted_windows")
        with self._lock:
            self._streak = self._streak + 1 if drifted else 0
            if self._streak < self.arm_windows:
                return
            if self._disarmed:
                _tally("suppressed_disarmed")
                return
            if time.monotonic() < self._cooldown_until:
                _tally("suppressed_cooldown")
                return
            if self._thread is not None and self._thread.is_alive():
                _tally("suppressed_active")
                return
            self._streak = 0
            job = self._new_job(report)
            self._thread = threading.Thread(
                target=self._run_job, args=(job,),
                name=f"continual-{self.name}", daemon=True)
            self._thread.start()
        _tally("triggers")
        telemetry.emit("retrain", model=self.name, action="trigger",
                       job=job["jobId"])
        logger.warning("continual: %s armed a retrain after %d drifted "
                       "window(s) (job %s)", self.name, self.arm_windows,
                       job["jobId"])

    def trigger(self, reason: str = "manual") -> Optional[str]:
        """Operator entry point: arm a retrain NOW (storm controls still
        apply). Returns the job id, or None when suppressed."""
        with self._lock:
            if self._disarmed:
                _tally("suppressed_disarmed")
                return None
            if time.monotonic() < self._cooldown_until:
                _tally("suppressed_cooldown")
                return None
            if self._thread is not None and self._thread.is_alive():
                _tally("suppressed_active")
                return None
            job = self._new_job({"reason": reason})
            self._thread = threading.Thread(
                target=self._run_job, args=(job,),
                name=f"continual-{self.name}", daemon=True)
            self._thread.start()
        _tally("triggers")
        telemetry.emit("retrain", model=self.name, action="trigger",
                       job=job["jobId"])
        return job["jobId"]

    def wait_idle(self, timeout_s: float = 300.0) -> bool:
        """Block until no job thread is running."""
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
            return not t.is_alive()
        return True

    # -- the supervised job ------------------------------------------------
    def _new_job(self, trigger: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        # wall-clock by design: job timestamps are compared across
        # processes and displayed, never used as durations
        now = time.time()   # lint: wall-clock
        job_id = f"job-{int(now * 1000):013d}-{os.getpid()}"
        out_dir = os.path.join(self.job_dir, JOBS_DIR, job_id + ".out")
        # the triggering window's trace context (or a fresh root when
        # the trigger ran untraced): persisted in the record so the
        # retrain SUBPROCESS joins the same trace via TMOG_TRACE_PARENT
        # — and so replay()/recover() keep the original identity
        ctx = telemetry.current_trace() or telemetry.mint_trace()
        return {"jobId": job_id, "model": self.name, "state": PENDING,
                "trigger": trigger, "cmd": list(self.retrain_cmd),
                "outDir": out_dir,
                "log": self._job_path(job_id)[:-5] + ".log",
                "traceparent": telemetry.format_traceparent(*ctx),
                "createdAt": now, "controllerPid": os.getpid(),
                "pid": None, "exitCode": None, "version": None,
                "error": None, "replayable": False}

    def _acquire_slot(self) -> Optional[int]:
        """Non-blocking kernel flock on the ACTIVE job slot — at most
        ONE retrain across every controller sharing this job dir (one
        per fleet worker). A SIGKILLed holder's lock releases
        automatically; a busy slot suppresses the trigger, it never
        queues a second job."""
        import fcntl
        path = os.path.join(self.job_dir, ACTIVE_LOCK)
        fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return None
        locks.witness_acquire("continual.active_slot.flock")
        return fd

    def _spawn_env(self, job: Dict[str, Any],
                   stable_dir: Optional[str]) -> Dict[str, str]:
        env = dict(os.environ)
        if self.spawn_env:
            env.update(self.spawn_env)
        # a controller started from a checkout must spawn trainers that
        # can import the package from any cwd (the fleet discipline)
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        pp = env.get("PYTHONPATH", "")
        if pkg_parent not in pp.split(os.pathsep):
            env["PYTHONPATH"] = (pkg_parent + os.pathsep + pp
                                 if pp else pkg_parent)
        env["TMOG_RETRAIN_MODEL"] = self.name
        env["TMOG_RETRAIN_OUT"] = job["outDir"]
        env["TMOG_RETRAIN_STABLE"] = stable_dir or ""
        env["TMOG_RETRAIN_TRIGGER"] = job["outDir"] + ".trigger.json"
        env["TMOG_RETRAIN_HEARTBEAT"] = job["outDir"] + ".heartbeat"
        # trace inheritance: the trainer's spans join the triggering
        # window's trace, its merged-trace row is named "retrain", and
        # (when the fleet shares a shard directory) its shard lands in
        # the same trace merge set
        if job.get("traceparent"):
            env[telemetry.TRACE_ENV] = job["traceparent"]
            env[telemetry.TRACE_ROLE_ENV] = "retrain"
        if self.trace_dir:
            env["TMOG_TRACE_DIR"] = self.trace_dir
        return env

    def _run_job(self, job: Dict[str, Any]) -> None:
        """The job thread: slot flock → record → spawn → supervise →
        register → deploy. Never raises (its own never-raises boundary —
        an exception anywhere marks the job failed and feeds the storm
        controls)."""
        slot = self._acquire_slot()
        if slot is None:
            # a sibling controller (another fleet worker) is already
            # retraining: this trigger is redundant, not queued
            _tally("suppressed_active")
            logger.info("continual: %s retrain slot held elsewhere; "
                        "trigger dropped (job %s never started)",
                        self.name, job["jobId"])
            return
        import fcntl
        try:
            try:
                # the controller's own spans ride the job's trace: one
                # trace covers drift window → controller → trainer
                # subprocess → register/deploy
                with telemetry.trace_scope(job.get("traceparent")):
                    with telemetry.span("continual:job",
                                        model=self.name,
                                        job=job["jobId"]):
                        self._execute_job(job)
            except Exception as e:  # lint: broad-except — the job thread is a never-raises boundary; any failure feeds the storm controls
                logger.exception("continual: job %s failed",
                                 job["jobId"])
                self._fail(job, repr(e))
        finally:
            self.last_job = job
            with self._lock:
                self._cooldown_until = max(
                    self._cooldown_until,
                    time.monotonic() + self.cooldown_s)
            locks.witness_release("continual.active_slot.flock")
            try:
                fcntl.flock(slot, fcntl.LOCK_UN)
            except OSError:
                pass
            os.close(slot)

    def _execute_job(self, job: Dict[str, Any]) -> None:
        resilience.inject("continual.retrain", model=self.name,
                          job=job["jobId"])
        stable_dir = None
        try:
            stable_dir = self.registry.resolve(self.name)["modelDir"]
        except Exception:  # lint: broad-except — no promoted stable version: the trainer cold-fits
            logger.info("continual: %s has no stable version to "
                        "warm-start from", self.name)
        os.makedirs(job["outDir"], exist_ok=True)
        env = self._spawn_env(job, stable_dir)
        # the drift evidence that armed this job rides beside it
        trig_tmp = env["TMOG_RETRAIN_TRIGGER"] + ".tmp"
        with open(trig_tmp, "w") as fh:
            json.dump(job.get("trigger") or {}, fh, default=str)
        os.replace(trig_tmp, env["TMOG_RETRAIN_TRIGGER"])
        with open(job["log"], "ab") as log_fh:
            proc = subprocess.Popen(self.retrain_cmd, stdout=log_fh,
                                    stderr=subprocess.STDOUT, env=env)
        job.update(state=RUNNING, pid=proc.pid,
                   startedAt=time.time())   # lint: wall-clock
        self._write_job(job)
        _tally("jobs_started")
        telemetry.emit("retrain", model=self.name, action="start",
                       job=job["jobId"])
        logger.info("continual: job %s running (pid %d): %s",
                    job["jobId"], proc.pid, " ".join(self.retrain_cmd))
        self._supervise(job, proc, env["TMOG_RETRAIN_HEARTBEAT"])

    def _supervise(self, job: Dict[str, Any], proc: subprocess.Popen,
                   hb_path: str) -> None:
        """Exit-code + heartbeat monitoring with kill-on-timeout: the
        trainer proves liveness by writing (log mtime) or touching its
        heartbeat file; a silent or overlong job is SIGKILLed and
        counted as a failure — a stuck trainer must never hold the
        retrain slot forever."""
        deadline = time.monotonic() + self.timeout_s
        spawn_wall = time.time()   # lint: wall-clock — compared to file mtimes
        while proc.poll() is None:
            try:
                now = time.monotonic()
                if now > deadline:
                    self._kill(job, proc,
                               f"timeout after {self.timeout_s:g}s")
                    return
                hb = spawn_wall
                for p in (job["log"], hb_path):
                    try:
                        hb = max(hb, os.path.getmtime(p))
                    except OSError:
                        pass
                stale = time.time() - hb   # lint: wall-clock — mtime delta
                if stale > self.heartbeat_timeout_s:
                    self._kill(job, proc,
                               f"stalled: no heartbeat for "
                               f"{stale:.0f}s (> "
                               f"{self.heartbeat_timeout_s:g}s)")
                    return
            except Exception:  # lint: broad-except — a probe hiccup must not kill supervision (TMG310: the monitor loop catches and lives)
                logger.exception("continual: heartbeat probe failed "
                                 "for job %s", job["jobId"])
            time.sleep(0.1)
        rc = proc.returncode
        job["exitCode"] = rc
        if rc != 0:
            self._fail(job, f"trainer exited {rc} (log: {job['log']})")
            return
        self._register_and_deploy(job)

    def _kill(self, job: Dict[str, Any], proc: subprocess.Popen,
              reason: str) -> None:
        logger.error("continual: killing job %s: %s", job["jobId"],
                     reason)
        try:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            pass
        job["exitCode"] = proc.returncode
        _tally("jobs_killed")
        self._fail(job, reason, state=KILLED)

    # -- completion: register → holdout gate → deploy ----------------------
    def _register_and_deploy(self, job: Dict[str, Any]) -> None:
        model_dir = os.path.join(job["outDir"], "model")
        from .model_io import MODEL_JSON
        if not os.path.exists(os.path.join(model_dir, MODEL_JSON)):
            self._fail(job, f"trainer exited 0 but produced no model at "
                            f"{model_dir!r}")
            return
        bank_dir = os.path.join(job["outDir"], "export")
        if not os.path.isdir(bank_dir):
            bank_dir = None
        metrics: Optional[Dict[str, Any]] = None
        mpath = os.path.join(job["outDir"], "metrics.json")
        try:
            with open(mpath) as fh:
                metrics = json.load(fh)
        except (OSError, ValueError):
            pass
        if not self._holdout_ok(job, metrics):
            return
        resilience.inject("continual.register", model=self.name,
                          job=job["jobId"])
        vid = self.registry.register(self.name, model_dir,
                                     bank_dir=bank_dir,
                                     train_metrics=metrics)
        job.update(state=REGISTERED, version=vid, replayable=True)
        self._write_job(job)
        telemetry.emit("retrain", model=self.name, action="registered",
                       job=job["jobId"], version=vid)
        logger.info("continual: job %s registered %s@%s", job["jobId"],
                    self.name, vid)
        self._deploy(job, vid)

    def _holdout_ok(self, job: Dict[str, Any],
                    metrics: Optional[Dict[str, Any]]) -> bool:
        """Reject a candidate measurably WORSE than the stable version
        on the holdout metric — before any live traffic touches it.
        Missing metrics on either side skip the gate (the rollout's
        clean-window evidence still gates promotion)."""
        cand = _metric_of(metrics, self.holdout_metric)
        stable = None
        try:
            cur = self.registry.current(self.name)
            if cur:
                stable = _metric_of(
                    self.registry.record(self.name, cur)
                    .get("trainMetrics"), self.holdout_metric)
        except Exception:  # lint: broad-except — an unreadable stable record skips the gate, never fails the job
            logger.exception("continual: stable metrics unreadable")
        if cand is None or stable is None:
            logger.info("continual: holdout gate skipped for job %s "
                        "(%s: candidate=%s stable=%s)", job["jobId"],
                        self.holdout_metric, cand, stable)
            return True
        if cand + self.holdout_tolerance < stable:
            _tally("candidates_rejected")
            job.update(state=REJECTED,
                       error=f"holdout {self.holdout_metric} "
                             f"{cand:.4f} < stable {stable:.4f}",
                       finishedAt=time.time())   # lint: wall-clock
            self._write_job(job)
            telemetry.emit("retrain", model=self.name, action="rejected",
                           job=job["jobId"], error=job["error"])
            logger.warning("continual: job %s REJECTED before deploy: "
                           "%s", job["jobId"], job["error"])
            # a rejection spends failure budget: a trainer that keeps
            # producing worse models must eventually go LOUD, not loop
            self._count_failure()
            return False
        logger.info("continual: holdout gate passed for job %s "
                    "(%s: %.4f >= stable %.4f)", job["jobId"],
                    self.holdout_metric, cand, stable)
        return True

    def _deploy(self, job: Dict[str, Any], vid: str) -> None:
        if self.server is None:
            # no serving tier attached: registered, awaiting a manual
            # (or registry-CLI) promote — still a successful job
            job.update(state=SUCCEEDED,
                       finishedAt=time.time())   # lint: wall-clock
            self._write_job(job)
            self._succeed(job)
            return
        kw: Dict[str, Any] = {}
        if self.canary_fraction is not None:
            kw["fraction"] = float(self.canary_fraction)
        if self.window_requests is not None:
            kw["window_requests"] = int(self.window_requests)
        if self.promote_windows is not None:
            kw["promote_windows"] = int(self.promote_windows)
        # drift_gate=False: the stable baseline keeps flagging the very
        # window this candidate was trained on — that advisory is the
        # rollout's CAUSE, not evidence against the candidate (the
        # failure/SLO/parity evidence still gates, and the sentinel
        # rebuilds on the candidate's own baseline at promote)
        self.server.deploy(self.name, vid, mode=self.deploy_mode,
                           drift_gate=False, **kw)
        job.update(state=DEPLOYED,
                   finishedAt=time.time())   # lint: wall-clock
        self._write_job(job)
        telemetry.emit("retrain", model=self.name, action="deployed",
                       job=job["jobId"], version=vid)
        logger.info("continual: job %s deployed %s@%s as a %s rollout "
                    "(evidence-gated promotion from here)",
                    job["jobId"], self.name, vid, self.deploy_mode)
        self._succeed(job)

    # -- storm-control bookkeeping -----------------------------------------
    def _succeed(self, job: Dict[str, Any]) -> None:
        _tally("jobs_succeeded")
        with self._lock:
            self._failures = 0

    def _count_failure(self) -> None:
        with self._lock:
            self._failures += 1
            failures = self._failures
            self._cooldown_until = max(
                self._cooldown_until,
                time.monotonic() + self.cooldown_s
                + self.backoff.delay_s(min(failures - 1,
                                           self.backoff.max_attempts - 1)))
            if failures >= self.max_failures and not self._disarmed:
                self._disarmed = True
                disarm = True
            else:
                disarm = False
        if disarm:
            _tally("gave_up")
            from . import lint
            f = lint.Finding(
                "TMG605", f"retrain controller for {self.name!r} FAILED: "
                f"{failures} consecutive job failure(s) >= budget "
                f"{self.max_failures} — retraining DISARMED; inspect "
                f"the job records under {self.job_dir!r} and re-arm "
                "(RetrainController.rearm)")
            lint.emit_findings([f])
            telemetry.emit("retrain", model=self.name, action="gave_up",
                           error=f.message)
            logger.error("continual: %s", f.format())

    def _fail(self, job: Dict[str, Any], error: str,
              state: str = FAILED) -> None:
        job.update(state=state, error=error,
                   finishedAt=time.time())   # lint: wall-clock
        try:
            self._write_job(job)
        except OSError:
            logger.exception("continual: job record write failed")
        _tally("jobs_failed")
        telemetry.emit("retrain", model=self.name, action="failed",
                       job=job["jobId"], error=error)
        logger.error("continual: job %s %s: %s", job["jobId"], state,
                     error)
        self._count_failure()

    def rearm(self) -> None:
        """Operator reset after a FAILED (disarmed) controller: clears
        the failure budget and the disarm flag. The job records stay —
        they are the audit trail."""
        with self._lock:
            self._failures = 0
            self._disarmed = False
            self._streak = 0
        logger.warning("continual: %s re-armed by operator", self.name)

    # -- crash recovery ----------------------------------------------------
    def recover(self) -> List[Dict[str, Any]]:
        """Replay the on-disk job history after a controller restart:

        * ``running``/``pending`` records whose controller pid is dead
          are marked ``interrupted`` (``replayable`` when the trainer
          finished its export — :meth:`replay` completes the
          register+deploy half without retraining); a still-alive
          orphan trainer is killed (nothing supervises it anymore).
        * The consecutive-failure budget and the cooldown clock are
          restored from the trailing records, so a crash-looping
          controller cannot reset its own storm controls by dying.

        Returns the records it repaired."""
        repaired: List[Dict[str, Any]] = []
        records = self.jobs()
        for job in records:
            if job.get("state") not in (RUNNING, PENDING):
                continue
            # pid liveness is only meaningful while the job could still
            # legitimately be running: past its own kill bound (timeout
            # + heartbeat + slack) a matching pid is almost certainly
            # REUSED by an unrelated process (reboot, long downtime) —
            # treat the record as dead and never SIGKILL a stranger
            age = time.time() - job.get("createdAt", 0.0)   # lint: wall-clock
            stale = age > (self.timeout_s + self.heartbeat_timeout_s
                           + 600.0)
            if not stale and _pid_alive(job.get("controllerPid")):
                continue                    # a live sibling owns it
            if not stale and _pid_alive(job.get("pid")):
                try:
                    os.kill(int(job["pid"]), signal.SIGKILL)
                    _tally("orphans_killed")
                    logger.warning(
                        "continual: killed orphan trainer pid %s of "
                        "job %s (its controller died)", job["pid"],
                        job["jobId"])
                except OSError:
                    pass
            from .model_io import MODEL_JSON
            job["replayable"] = os.path.exists(os.path.join(
                job.get("outDir") or "", "model", MODEL_JSON))
            job.update(state=INTERRUPTED,
                       error="controller died mid-job",
                       finishedAt=time.time())   # lint: wall-clock
            self._write_job(job)
            repaired.append(job)
            _tally("jobs_recovered")
            telemetry.emit("retrain", model=self.name,
                           action="recovered", job=job["jobId"])
            logger.warning("continual: job %s interrupted by a dead "
                           "controller (replayable=%s)", job["jobId"],
                           job["replayable"])
        # storm controls survive the crash: trailing bad outcomes
        # restore the failure budget, the last job restarts the cooldown
        trailing = 0
        records = self.jobs()
        for job in reversed(records):
            if job.get("state") in _TERMINAL_BAD:
                trailing += 1
            else:
                break
        with self._lock:
            self._failures = max(self._failures, trailing)
            if self._failures >= self.max_failures:
                self._disarmed = True
            if records:
                # wall-clock by design: createdAt crosses processes
                since = time.time() - records[-1].get("createdAt", 0.0)   # lint: wall-clock
                remaining = self.cooldown_s - since
                if remaining > 0:
                    self._cooldown_until = max(
                        self._cooldown_until,
                        time.monotonic() + remaining)
        return repaired

    def replay(self, job_id: str) -> Dict[str, Any]:
        """Complete an ``interrupted`` job's register+deploy half from
        its record — the trainer's finished export is on disk, so no
        retrain is needed. Raises :class:`ContinualError` for a job
        that is not replayable."""
        job = self.job(job_id)
        if job.get("state") != INTERRUPTED or not job.get("replayable"):
            raise ContinualError(
                f"job {job_id!r} is not replayable "
                f"(state={job.get('state')!r}, "
                f"replayable={job.get('replayable')})")
        _tally("jobs_replayed")
        logger.info("continual: replaying job %s (register+deploy from "
                    "the persisted record)", job_id)
        self._register_and_deploy(job)
        self.last_job = job
        return job

    # -- status ------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            cooldown = max(self._cooldown_until - time.monotonic(), 0.0)
            running = (self._thread is not None
                       and self._thread.is_alive())
            out = {"model": self.name, "armWindows": self.arm_windows,
                   "streak": self._streak, "failures": self._failures,
                   "maxFailures": self.max_failures,
                   "disarmed": self._disarmed,
                   "cooldownRemainingS": round(cooldown, 3),
                   "jobRunning": running,
                   "jobDir": self.job_dir}
        out["lastJob"] = ({k: self.last_job.get(k) for k in
                           ("jobId", "state", "version", "error",
                            "exitCode")}
                          if self.last_job else None)
        return out
