"""The workload flight recorder, replay and critical-path analysis; the
port of ``transmogrifai_tpu/workload.py``.

Every request gets a trace and a latency decomposition from the server
(``server.py``); this module records the *workload itself* so it can be
driven again. Three surfaces, as in the JAX package:

1. **Flight recorder.** Every request accepted by ``server.serve_http``
   or the fleet router appends one compact JSONL record (arrival offset
   on the process's monotonic trace epoch, model, trace id, payload or
   shape digest, routing decision, outcome, per-phase latency
   decomposition) to a per-process ``shard-<role>-<pid>.workload.jsonl``
   under ``customParams.workloadDir``. Records are written off the
   request path: a bounded queue feeds one named writer thread, a full
   queue drops the record and tallies it (observation never blocks a
   worker), files rotate by size at ``workloadMaxMb``, and a SIGKILL in
   the middle of a write tears at most the last line, which ``merge``
   skips and tallies.

2. **Replay.** :func:`merge_workload_shards` stitches the per-process
   shards into one arrival-ordered workload (clock offsets aligned on
   each shard's ``epochUnixS`` anchor, the router's and the worker's
   records of one trace id combined); :func:`replay_workload` drives it
   open-loop against a live server or fleet at the recorded (or
   ``speed``-scaled) arrival offsets, checks score parity where payloads
   were recorded, and returns the same decomposed-latency summary, so two
   configurations replayed against one recording give paired per-phase
   deltas.

3. **Critical-path analysis.** :func:`analyze_trace` walks a merged
   trace, follows router → worker → dispatch span parentage and links to
   rebuild each request's critical path across processes, and reports
   per-phase self-time (p50/p99), the top-K slowest requests with their
   paths, and (:func:`diff_analyses`) a thresholded diff against a
   baseline for regression watchdogs.

Nothing here touches the card: the recorder, the merge and the analysis
are host code, and replay drives a server over HTTP. The always-on
tallies ride every runner metrics document as ``workload_stats()``.
"""
from __future__ import annotations

import glob
import hashlib
import http.client
import json
import logging
import os
import queue
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import telemetry
from .utils import locks

logger = logging.getLogger(__name__)

__all__ = [
    "WorkloadRecorder", "start_recorder", "stop_recorder", "recorder",
    "recording_enabled", "record_request", "merge_workload_shards",
    "write_merged_workload", "load_workload", "summarize_workload",
    "replay_workload", "analyze_trace", "diff_analyses",
    "workload_stats", "reset_workload_stats",
    "DEFAULT_MAX_MB", "DEFAULT_QUEUE_DEPTH", "PAYLOAD_CAP_BYTES",
]

#: active shard file name: shard-<role>-<pid>.workload.jsonl; rotated
#: segments insert a 3-digit sequence before the extension
SHARD_SUFFIX = ".workload.jsonl"

#: size-rotation threshold per shard segment (customParams.workloadMaxMb)
DEFAULT_MAX_MB = 64.0

#: bounded record queue between request threads and the writer thread —
#: beyond it, records are DROPPED and tallied, never block the request
DEFAULT_QUEUE_DEPTH = 512

#: per-request payload/outputs JSON byte cap: a payload serializing
#: larger than this is recorded as a shape DIGEST (rows, bytes, sha256
#: prefix) instead — the recorder bounds its own disk cost
PAYLOAD_CAP_BYTES = 65536

#: request records below this schema version are rejected by replay
WORKLOAD_VERSION = 1


# ---------------------------------------------------------------------------
# always-on tallies (every runner metrics document stamps them)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"records_enqueued": 0, "records_written": 0,
          "records_dropped": 0, "payloads_recorded": 0,
          "payloads_digested": 0, "rotations": 0, "shards_merged": 0,
          "merge_errors": 0, "torn_records_skipped": 0,
          "replayed_requests": 0, "replay_skipped_no_payload": 0,
          "replay_failures": 0, "parity_checked": 0,
          "parity_failures": 0, "replay_truncated": 0,
          "replay_late_sends": 0}


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


def workload_stats() -> Dict[str, Any]:
    """Process-wide flight-recorder/replay tallies (always on) plus the
    derived ``drop_rate`` (records dropped per enqueue attempt) and the
    live ``recording`` flag."""
    with _TALLY_LOCK:
        out: Dict[str, Any] = dict(_TALLY)
    attempted = out["records_enqueued"] + out["records_dropped"]
    out["drop_rate"] = (round(out["records_dropped"] / attempted, 4)
                        if attempted else None)
    out["recording"] = _RECORDER is not None
    return out


def reset_workload_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _payload_digest(body: bytes, rows: int) -> Dict[str, Any]:
    return {"rows": int(rows), "bytes": len(body),
            "sha256": hashlib.sha256(body).hexdigest()[:16]}


class WorkloadRecorder:
    """One per-process JSONL shard writer, fed through a bounded queue
    by :func:`record_request` and drained by a single named daemon
    thread. Serialization, the payload-cap decision and the disk write
    all happen on the writer thread — the request path pays one
    ``put_nowait``."""

    def __init__(self, dir_path: str, role: Optional[str] = None,
                 max_mb: float = DEFAULT_MAX_MB, payloads: bool = True,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH):
        self.dir = str(dir_path)
        self.role = str(role) if role else telemetry.trace_role()
        self.pid = os.getpid()
        self.max_bytes = max(int(float(max_mb) * 1e6), 4096)
        self.payloads = bool(payloads)
        os.makedirs(self.dir, exist_ok=True)
        # the shard's wall-clock anchor of the process's monotonic trace
        # epoch — the SAME anchor trace shards record, so workload and
        # trace merges align on identical clock offsets
        now_unix = time.time()  # lint: wall-clock — cross-process clock-offset anchor, not a duration
        self.epoch_unix = now_unix - (time.perf_counter()
                                      - telemetry._EPOCH)
        self._segment = 0
        self._fh = None
        self._bytes = 0
        self._queue: "queue.Queue" = queue.Queue(maxsize=int(queue_depth))
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="tmog-workload-writer",
                                        daemon=True)
        self._thread.start()

    # -- paths -------------------------------------------------------------
    @property
    def shard_path(self) -> str:
        return os.path.join(self.dir,
                            f"shard-{self.role}-{self.pid}{SHARD_SUFFIX}")

    def _rotated_path(self, segment: int) -> str:
        return os.path.join(
            self.dir,
            f"shard-{self.role}-{self.pid}.workload.{segment:03d}.jsonl")

    # -- request path ------------------------------------------------------
    def record(self, rec: Dict[str, Any], records: Any = None,
               outputs: Any = None, payload_json: Any = None,
               response_json: Any = None) -> bool:
        """Enqueue one request record; ``records``/``outputs`` are
        attached lazily (serialized on the writer thread, capped or
        digested there). ``payload_json``/``response_json`` are
        PRE-SERIALIZED request/response bodies (str or bytes of valid
        JSON) spliced into the line verbatim — the zero-copy path for
        a serving handler that already paid the serialization. Returns
        False when the bounded queue was full and the record was
        dropped (tallied)."""
        if self._closed:
            return False
        try:
            self._queue.put_nowait((rec, records, outputs,
                                    payload_json, response_json))
        except queue.Full:
            _tally("records_dropped")
            return False
        _tally("records_enqueued")
        return True

    # -- writer thread -----------------------------------------------------
    def _open_segment(self) -> None:
        self._fh = open(self.shard_path, "ab")
        self._bytes = self._fh.tell()
        if self._bytes == 0:
            header = {"kind": "header", "version": WORKLOAD_VERSION,
                      "role": self.role, "pid": self.pid,
                      "segment": self._segment,
                      "epochUnixS": round(self.epoch_unix, 6)}
            line = json.dumps(header,
                              separators=(",", ":")).encode() + b"\n"
            self._fh.write(line)
            self._fh.flush()
            self._bytes += len(line)

    def _rotate(self) -> None:
        self._fh.close()
        self._fh = None
        os.replace(self.shard_path, self._rotated_path(self._segment))
        self._segment += 1
        _tally("rotations")
        self._open_segment()

    def _capture(self, rec: Dict[str, Any], raw_key: str,
                 obj_key: str, raw: Any, obj: Any,
                 extras: List[Tuple[str, bytes]]) -> None:
        """Attach one captured body. A pre-serialized ``raw`` body is
        spliced verbatim under ``raw_key`` (zero re-serialization —
        the caller guarantees it is valid JSON; a corrupt splice costs
        ONE line at merge, which is torn-tolerant). A plain ``obj`` is
        dumped once here, on the writer thread, under ``obj_key``.
        Either form over the cap (or with payload capture off)
        degrades to a shape digest."""
        if raw is not None:
            blob = raw if isinstance(raw, bytes) else str(raw).encode()
            key = raw_key
        elif obj is not None:
            blob = json.dumps(obj, separators=(",", ":"),
                              default=str).encode()
            key = obj_key
        else:
            return
        if self.payloads and len(blob) <= PAYLOAD_CAP_BYTES:
            extras.append((key, blob))
            if obj_key == "payload":
                _tally("payloads_recorded")
        else:
            rec[obj_key + "Digest"] = _payload_digest(
                blob, int(rec.get("rows") or 0))
            if obj_key == "payload":
                _tally("payloads_digested")

    def _write_one(self, item: Tuple[Dict[str, Any], Any, Any,
                                     Any, Any]) -> None:
        rec, records, outputs, payload_json, response_json = item
        extras: List[Tuple[str, bytes]] = []
        self._capture(rec, "request", "payload", payload_json,
                      records, extras)
        self._capture(rec, "response", "outputs", response_json,
                      outputs, extras)
        base = json.dumps(rec, separators=(",", ":"),
                          default=str).encode()
        if extras:
            base = (base[:-1]
                    + b"".join(b',"%s":%s' % (k.encode(), v)
                               for k, v in extras) + b"}")
        line = base + b"\n"
        if self._fh is None:
            self._open_segment()
        self._fh.write(line)
        self._fh.flush()
        self._bytes += len(line)
        _tally("records_written")
        if self._bytes >= self.max_bytes:
            self._rotate()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:          # shutdown sentinel
                break
            try:
                self._write_one(item)
            except (OSError, ValueError, TypeError) as e:
                logger.warning("workload: record write failed: %r", e)
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def close(self, timeout_s: float = 10.0) -> None:
        """Drain the queue, stop the writer thread, close the shard.
        Idempotent; records arriving after close are dropped silently
        (the caller is shutting down)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._queue.put(None, timeout=timeout_s)
        except queue.Full:
            # writer wedged — don't hang shutdown; the tail tears, and
            # merge is torn-tolerant by design
            pass
        self._thread.join(timeout=timeout_s)


_RECORDER: Optional[WorkloadRecorder] = None
_RECORDER_LOCK = locks.witness_lock("workload._RECORDER_LOCK")


def start_recorder(dir_path: str, role: Optional[str] = None,
                   max_mb: float = DEFAULT_MAX_MB,
                   payloads: bool = True,
                   queue_depth: int = DEFAULT_QUEUE_DEPTH
                   ) -> WorkloadRecorder:
    """Install the process-wide flight recorder (replacing any active
    one). ``cli serve`` / ``cli fleet`` call this when
    ``customParams.workloadDir`` is set and uninstall on exit."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            _RECORDER.close()
        _RECORDER = WorkloadRecorder(dir_path, role=role, max_mb=max_mb,
                                     payloads=payloads,
                                     queue_depth=queue_depth)
        return _RECORDER


def stop_recorder() -> None:
    """Drain and uninstall the process-wide recorder (no-op when off)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            _RECORDER.close()
            _RECORDER = None


def recorder() -> Optional[WorkloadRecorder]:
    return _RECORDER


def recording_enabled() -> bool:
    return _RECORDER is not None


def record_request(model: str, rows: int,
                   records: Any = None, outputs: Any = None,
                   payload_json: Any = None, response_json: Any = None,
                   trace_id: Optional[str] = None,
                   t_arrival: Optional[float] = None,
                   outcome: Optional[Dict[str, Any]] = None,
                   phases: Optional[Dict[str, float]] = None,
                   route: Optional[Dict[str, Any]] = None) -> bool:
    """Record one accepted request (no-op returning False when the
    recorder is off). ``t_arrival`` is the request's arrival
    ``perf_counter()`` instant — the record stores it as an offset on
    the process's monotonic trace epoch so merge can align shards from
    different processes on their ``epochUnixS`` anchors.
    ``payload_json``/``response_json`` are pre-serialized JSON bodies
    the serving path already produced — preferred over
    ``records``/``outputs`` because the writer splices them without
    re-serializing (merge unwraps them back to ``payload``/
    ``outputs``)."""
    rec = _RECORDER
    if rec is None:
        return False
    t = t_arrival if t_arrival is not None else time.perf_counter()
    doc: Dict[str, Any] = {
        "kind": "request",
        "tOffsetS": round(t - telemetry._EPOCH, 6),
        "model": model, "rows": int(rows)}
    if trace_id:
        doc["traceId"] = trace_id
    if outcome:
        doc["outcome"] = outcome
    if phases:
        doc["phases"] = {k: round(float(v), 6)
                         for k, v in phases.items()}
    if route:
        doc["route"] = route
    return rec.record(doc, records=records, outputs=outputs,
                      payload_json=payload_json,
                      response_json=response_json)


# ---------------------------------------------------------------------------
# merge — shards -> one arrival-ordered workload
# ---------------------------------------------------------------------------

def _normalize_record(r: Dict[str, Any]) -> Dict[str, Any]:
    """Unwrap the zero-copy capture keys: a spliced ``request`` body
    becomes ``payload`` (its ``records`` list), a spliced ``response``
    body contributes ``outputs`` (and ``phases`` when the record
    itself carries none) — so merged workloads expose ONE schema
    regardless of which capture path wrote the shard."""
    req = r.pop("request", None)
    if isinstance(req, dict):
        recs = req.get("records")
        if "payload" not in r and isinstance(recs, list):
            r["payload"] = recs
    resp = r.pop("response", None)
    if isinstance(resp, dict):
        outs = resp.get("outputs")
        if "outputs" not in r and isinstance(outs, list):
            r["outputs"] = outs
        if "phases" not in r and isinstance(resp.get("phases"), dict):
            r["phases"] = resp["phases"]
    return r


def _read_shard(path: str) -> Tuple[Dict[str, Any],
                                    List[Dict[str, Any]], int]:
    """Parse one shard file: returns (header, records, torn_count).
    A final line without its newline terminator is a torn tail (the
    writer was SIGKILLed mid-write) — skipped and tallied, like any
    line that fails to parse. A missing/unparseable header makes the
    whole shard unreadable (raises ValueError)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    torn = 0
    lines = raw.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()                     # clean trailing newline
    elif lines:
        lines.pop()                     # torn tail: no terminator
        torn += 1
    header: Optional[Dict[str, Any]] = None
    out: List[Dict[str, Any]] = []
    for ln in lines:
        try:
            doc = json.loads(ln)
        except ValueError:
            torn += 1
            continue
        if not isinstance(doc, dict):
            torn += 1
            continue
        if doc.get("kind") == "header":
            if header is None:
                header = doc
            continue
        if doc.get("kind") == "request":
            out.append(_normalize_record(doc))
    if header is None:
        raise ValueError("no readable header record")
    return header, out, torn


def _combine(group: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold the router + worker records of ONE request (same trace id)
    into a single merged record: the earliest arrival keeps the
    timeline honest, the router contributes the routing decision and
    the client-visible outcome/e2e, the worker contributes the payload,
    outputs and per-phase decomposition."""
    group = sorted(group, key=lambda r: r["tS"])
    base = dict(group[0])
    routed = next((r for r in group if r.get("route")), None)
    phased = next(
        (r for r in group
         if any(k != "e2e" for k in (r.get("phases") or ()))), None)
    if routed is not None:
        base["route"] = routed["route"]
        if routed.get("outcome"):
            base["outcome"] = routed["outcome"]
    phases = dict((phased or {}).get("phases") or {})
    if routed is not None and (routed.get("phases") or {}).get("e2e"):
        # the router's e2e is the client-visible one (adds the forward
        # hop); the worker's sub-phases decompose what's inside it
        phases["e2e"] = routed["phases"]["e2e"]
    elif not phases:
        phases = dict((group[0].get("phases") or {}))
    if phases:
        base["phases"] = phases
    for key in ("payload", "payloadDigest", "outputs", "outputsDigest"):
        if key not in base:
            for r in group:
                if key in r:
                    base[key] = r[key]
                    break
    base["sources"] = sorted({r["role"] for r in group})
    return base


def merge_workload_shards(dir_path: str) -> Dict[str, Any]:
    """Stitch every ``shard-*.workload*.jsonl`` under ``dir_path`` into
    one arrival-ordered workload doc. Clock-offset aligned like
    ``trace merge``: each record's absolute arrival is its shard's
    ``epochUnixS`` anchor plus its monotonic offset, rebased onto the
    earliest arrival. Router and worker records sharing a trace id are
    combined into one record. Unreadable shards are skipped into
    ``mergeErrors``; torn tail records are skipped and counted in
    ``tornRecordsSkipped`` — never fatal. Raises ValueError when no
    shard is readable."""
    paths = sorted(glob.glob(os.path.join(dir_path,
                                          "shard-*.workload*.jsonl")))
    if not paths:
        raise ValueError(f"no workload shards under {dir_path!r}")
    merged: List[Dict[str, Any]] = []
    errors: List[str] = []
    torn_total = 0
    shards_read = 0
    for p in paths:
        fn = os.path.basename(p)
        try:
            header, recs, torn = _read_shard(p)
        except (OSError, ValueError) as e:
            errors.append(f"{fn}: {e!r}")
            _tally("merge_errors")
            continue
        shards_read += 1
        torn_total += torn
        epoch = float(header.get("epochUnixS", 0.0))
        for r in recs:
            r["tS"] = epoch + float(r.get("tOffsetS", 0.0))
            r["role"] = header.get("role", "proc")
            r["pid"] = header.get("pid")
            merged.append(r)
    if not shards_read:
        raise ValueError(
            f"no readable workload shards under {dir_path!r}: {errors}")
    _tally("shards_merged", shards_read)
    _tally("torn_records_skipped", torn_total)
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    singles: List[Dict[str, Any]] = []
    for r in merged:
        tid = r.get("traceId")
        if tid:
            by_trace.setdefault(tid, []).append(r)
        else:
            singles.append(r)
    combined = [_combine(g) for g in by_trace.values()]
    for r in singles:
        r["sources"] = [r["role"]]
    combined.extend(singles)
    combined.sort(key=lambda r: r["tS"])
    t0 = combined[0]["tS"] if combined else 0.0
    for r in combined:
        r["tS"] = round(r["tS"] - t0, 6)
        r.pop("tOffsetS", None)
    doc: Dict[str, Any] = {"version": WORKLOAD_VERSION,
                           "mergedShards": shards_read,
                           "baseEpochUnixS": round(t0, 6),
                           "requests": len(combined),
                           "tornRecordsSkipped": torn_total,
                           "records": combined}
    if errors:
        doc["mergeErrors"] = errors
    return doc


def write_merged_workload(doc: Dict[str, Any], out_path: str) -> None:
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, out_path)


def load_workload(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "records" not in doc:
        raise ValueError(f"{path!r} is not a merged workload file "
                         "(expected a dict with 'records')")
    return doc


# ---------------------------------------------------------------------------
# summaries — the shared decomposed-latency shape recording and replay
# both emit, so two runs yield PAIRED per-phase deltas
# ---------------------------------------------------------------------------

def _pct(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5),
              len(sorted_vals) - 1)
    return float(sorted_vals[idx])


def _phase_pcts(samples: Dict[str, List[float]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, vals in sorted(samples.items()):
        vals = sorted(vals)
        out[name] = {"n": len(vals),
                     "p50Ms": round(_pct(vals, 0.50) * 1e3, 3),
                     "p95Ms": round(_pct(vals, 0.95) * 1e3, 3),
                     "p99Ms": round(_pct(vals, 0.99) * 1e3, 3)}
    return out


def summarize_workload(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Per-model request/row counts plus p50/p95/p99 of every recorded
    latency phase — the decomposed-latency summary replay re-emits."""
    models: Dict[str, Dict[str, Any]] = {}
    phase_samples: Dict[str, Dict[str, List[float]]] = {}
    for r in doc.get("records", ()):
        m = r.get("model", "?")
        ent = models.setdefault(m, {"requests": 0, "rows": 0,
                                    "failed": 0})
        ent["requests"] += 1
        ent["rows"] += int(r.get("rows") or 0)
        if not (r.get("outcome") or {}).get("ok", True):
            ent["failed"] += 1
        for ph, v in (r.get("phases") or {}).items():
            phase_samples.setdefault(m, {}).setdefault(ph, []).append(
                float(v))
    for m, ent in models.items():
        ent["phases"] = _phase_pcts(phase_samples.get(m, {}))
    dur = max((r["tS"] for r in doc.get("records", ())), default=0.0)
    return {"requests": sum(e["requests"] for e in models.values()),
            "durationS": round(dur, 3), "models": models}


# ---------------------------------------------------------------------------
# replay — open-loop re-drive against a live server/fleet
# ---------------------------------------------------------------------------

def _max_numeric_delta(a: Any, b: Any) -> float:
    """Largest absolute numeric difference between two JSON-shaped
    values of identical structure; +inf on any structural mismatch."""
    if isinstance(a, bool) or isinstance(b, bool):
        return 0.0 if a == b else float("inf")
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return abs(float(a) - float(b))
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return float("inf")
        return max((_max_numeric_delta(a[k], b[k]) for k in a),
                   default=0.0)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return float("inf")
        return max((_max_numeric_delta(x, y) for x, y in zip(a, b)),
                   default=0.0)
    return 0.0 if a == b else float("inf")


def _post_score(host: str, port: int, model: str, payload: Any,
                timeout_s: float) -> Tuple[int, Dict[str, Any]]:
    body = json.dumps({"records": payload}).encode()
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("POST", f"/v1/models/{model}:score", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = {}
        return resp.status, doc
    finally:
        conn.close()


def replay_workload(doc: Dict[str, Any], url: str, speed: float = 1.0,
                    timeout_s: float = 30.0, parity_tol: float = 1e-4,
                    max_in_flight: int = 32,
                    duration_s: Optional[float] = None,
                    max_requests: Optional[int] = None) -> Dict[str, Any]:
    """Re-drive a merged workload open-loop against ``url`` (a serve
    worker or fleet router base URL). Each recorded request fires at
    ``t0 + tS / speed`` regardless of earlier completions — the
    recorded arrival process, not a closed loop. Records without a
    recorded payload (digested over the size cap, or captured with
    ``workloadPayloads=false``) cannot be re-driven and are tallied as
    skipped. Where recorded ``outputs`` exist, the replayed response is
    compared numerically within ``parity_tol`` (score parity).
    ``duration_s``/``max_requests`` truncate the replay — only records
    whose scaled send time falls inside the window (and the first N of
    those) fire — so a tuner candidate leg can bound its cost without
    editing the recording (truncated records tally ``truncated``, not
    skipped). Returns the same decomposed-latency summary shape as
    :func:`summarize_workload`, computed from the replayed responses'
    ``phases`` blocks, so recording and replay diff phase-for-phase."""
    parsed = urllib.parse.urlsplit(url if "//" in url
                                   else "http://" + url)
    host, port = parsed.hostname or "127.0.0.1", parsed.port or 80
    speed = float(speed)
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    todo = [r for r in doc.get("records", ())
            if (r.get("outcome") or {}).get("ok", True)]
    runnable = [r for r in todo if isinstance(r.get("payload"), list)]
    skipped = len(todo) - len(runnable)
    _tally("replay_skipped_no_payload", skipped)
    n_before_cut = len(runnable)
    if duration_s is not None:
        if float(duration_s) <= 0:
            raise ValueError(
                f"duration_s must be > 0, got {duration_s}")
        runnable = [r for r in runnable
                    if float(r.get("tS", 0.0)) / speed
                    <= float(duration_s)]
    if max_requests is not None:
        if int(max_requests) < 1:
            raise ValueError(
                f"max_requests must be >= 1, got {max_requests}")
        runnable = runnable[:int(max_requests)]
    truncated = n_before_cut - len(runnable)
    _tally("replay_truncated", truncated)

    lock = locks.witness_lock("workload.replay.lock")
    phase_samples: Dict[str, Dict[str, List[float]]] = {}
    client_e2e: List[float] = []
    models: Dict[str, Dict[str, Any]] = {}
    stats = {"sent": 0, "failed": 0, "lateSends": 0,
             "parityChecked": 0, "parityFailures": 0,
             "parityMaxAbsDelta": 0.0}
    sem = threading.BoundedSemaphore(int(max_in_flight))
    threads: List[threading.Thread] = []

    def fire(rec: Dict[str, Any]) -> None:
        try:
            t_send = time.perf_counter()
            try:
                status, resp = _post_score(host, port, rec["model"],
                                           rec["payload"], timeout_s)
            except OSError as e:
                status, resp = -1, {"error": repr(e)}
            dt = time.perf_counter() - t_send
            with lock:
                stats["sent"] += 1
                m = rec.get("model", "?")
                ent = models.setdefault(m, {"requests": 0, "rows": 0,
                                            "failed": 0})
                ent["requests"] += 1
                ent["rows"] += int(rec.get("rows") or 0)
                client_e2e.append(dt)
                if status != 200:
                    stats["failed"] += 1
                    ent["failed"] += 1
                    _tally("replay_failures")
                    return
                _tally("replayed_requests")
                for ph, v in (resp.get("phases") or {}).items():
                    phase_samples.setdefault(m, {}).setdefault(
                        ph, []).append(float(v))
                if "outputs" in rec and "outputs" in resp:
                    delta = _max_numeric_delta(rec["outputs"],
                                               resp["outputs"])
                    stats["parityChecked"] += 1
                    _tally("parity_checked")
                    if delta > parity_tol:
                        stats["parityFailures"] += 1
                        _tally("parity_failures")
                    if delta != float("inf"):
                        stats["parityMaxAbsDelta"] = max(
                            stats["parityMaxAbsDelta"], delta)
                    else:
                        stats["parityMaxAbsDelta"] = float("nan")
        finally:
            sem.release()

    t_start = time.perf_counter()
    for rec in runnable:
        due = t_start + float(rec.get("tS", 0.0)) / speed
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        elif delay < -0.05:
            with lock:
                stats["lateSends"] += 1
        sem.acquire()   # bounded in-flight: the open loop degrades
        t = threading.Thread(target=fire, args=(rec,),
                             name="tmog-workload-replay", daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=timeout_s + 5.0)
    wall = time.perf_counter() - t_start

    for m, ent in models.items():
        ent["phases"] = _phase_pcts(phase_samples.get(m, {}))
    if stats["lateSends"]:
        _tally("replay_late_sends", stats["lateSends"])
    return {"requests": len(todo), "skippedNoPayload": skipped,
            "truncated": truncated,
            "speed": speed, "durationS": round(wall, 3),
            "client": _phase_pcts({"e2e": client_e2e}),
            "models": models, **stats}


# ---------------------------------------------------------------------------
# critical-path analyzer — merged traces -> per-phase attribution
# ---------------------------------------------------------------------------

#: span names that root one request's trace (the fleet router's route
#: span when fleet traffic, the worker's request span when direct)
REQUEST_ROOTS = ("fleet:route", "server:request")


def _load_trace(source: Any) -> Dict[str, Any]:
    if isinstance(source, dict):
        return source
    if os.path.isdir(source):
        return telemetry.merge_trace_shards(source)
    with open(source) as fh:
        return json.load(fh)


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def analyze_trace(source: Any, top_k: int = 5) -> Dict[str, Any]:
    """Reconstruct each request's critical path from a merged trace
    (a doc, a merged ``.json`` file, or a shard directory — merged
    in-memory). For every trace rooted at a request span
    (:data:`REQUEST_ROOTS`): the root's duration is the request's
    end-to-end time; every span in the trace is attributed its
    SELF-time (duration minus child overlap, clipped to the root
    window); a span LINKED from another span (the micro-batcher's
    ``server:dispatch`` linking its member request spans) donates the
    linking span's overlap to that name — device time lands under
    ``server:dispatch`` even for members whose trace the batch span
    did not adopt. Reports per-span-name p50/p99 self-time and share
    of total e2e, per-request coverage (fraction of e2e attributed to
    named spans), and the top-K slowest requests with their paths."""
    doc = _load_trace(source)
    spans: List[Dict[str, Any]] = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        if not isinstance(args, dict):
            args = {}
        spans.append({"name": ev.get("name", "?"),
                      "t0": float(ev.get("ts", 0.0)),
                      "dur": float(ev.get("dur", 0.0)),
                      "trace": args.get("trace_id"),
                      "sid": args.get("span_id"),
                      "parent": args.get("parent_span_id"),
                      "links": args.get("links") or []})
    by_sid = {s["sid"]: s for s in spans if s["sid"]}
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        if s["trace"]:
            by_trace.setdefault(s["trace"], []).append(s)
    # linked contributions: span L lists member span ids; each member's
    # TRACE receives overlap(L, member) attributed to L's name
    linked_into: Dict[str, List[Tuple[Dict[str, Any],
                                      Dict[str, Any]]]] = {}
    donor_sids = set()
    for s in spans:
        for target_sid in s["links"]:
            tgt = by_sid.get(target_sid)
            if tgt is None or not tgt["trace"]:
                continue
            if (s["parent"] == target_sid
                    and s["trace"] == tgt["trace"]):
                # the batch span is ALSO a plain child of this member
                # (the trace it adopted): ordinary parent-child
                # accounting covers it — a link donation here would
                # deduct the overlap from the member's self-time TWICE
                continue
            linked_into.setdefault(tgt["trace"], []).append((s, tgt))
            donor_sids.add(s["sid"])

    requests: List[Dict[str, Any]] = []
    agg: Dict[str, List[float]] = {}
    e2e_all: List[float] = []
    skipped = 0
    for tid, tspans in by_trace.items():
        sids = {s["sid"] for s in tspans if s["sid"]}
        roots = [s for s in tspans
                 if not s["parent"] or s["parent"] not in sids]
        roots = [s for s in roots if s["name"] in REQUEST_ROOTS] or None
        if not roots:
            skipped += 1
            continue
        root = min(roots, key=lambda s: s["t0"])
        r0, r1 = root["t0"], root["t0"] + root["dur"]
        e2e = root["dur"]
        if e2e <= 0:
            skipped += 1
            continue
        children: Dict[str, List[Dict[str, Any]]] = {}
        for s in tspans:
            if s["parent"] and s["parent"] in sids and s is not root:
                children.setdefault(s["parent"], []).append(s)
        # linked overlap stolen from each member span's self-time
        link_steal: Dict[str, float] = {}
        link_attr: Dict[str, float] = {}
        for linker, tgt in linked_into.get(tid, ()):
            ov = _overlap(linker["t0"], linker["t0"] + linker["dur"],
                          max(tgt["t0"], r0),
                          min(tgt["t0"] + tgt["dur"], r1))
            if ov > 0 and tgt["sid"]:
                link_steal[tgt["sid"]] = link_steal.get(
                    tgt["sid"], 0.0) + ov
                link_attr[linker["name"]] = link_attr.get(
                    linker["name"], 0.0) + ov
        attribution: Dict[str, float] = dict(link_attr)
        for s in tspans:
            if s["sid"] in donor_sids and s["parent"] not in sids:
                # a batch-level span donates its time to member traces
                # through its links; when it is NOT also parented into
                # this trace, attributing its self-time here too would
                # double-count it in its home trace
                continue
            s0 = max(s["t0"], r0)
            s1 = min(s["t0"] + s["dur"], r1)
            if s1 <= s0:
                continue
            covered = sum(
                _overlap(s0, s1, c["t0"], c["t0"] + c["dur"])
                for c in children.get(s["sid"], ()))
            self_t = max((s1 - s0) - covered
                         - link_steal.get(s["sid"], 0.0), 0.0)
            attribution[s["name"]] = attribution.get(s["name"],
                                                     0.0) + self_t
        covered_frac = min(sum(attribution.values()) / e2e, 1.0)
        # greedy critical path: at each level descend into the child
        # with the largest overlap of the current span
        path = [{"name": root["name"],
                 "ms": round(root["dur"] / 1e3, 3)}]
        path_sids = {root["sid"]}
        cur = root
        while True:
            kids = children.get(cur["sid"], [])
            if not kids:
                break
            cur = max(kids, key=lambda c: _overlap(
                cur["t0"], cur["t0"] + cur["dur"],
                c["t0"], c["t0"] + c["dur"]))
            path.append({"name": cur["name"],
                         "ms": round(cur["dur"] / 1e3, 3)})
            path_sids.add(cur["sid"])
        # a batch span linking ANY member on the path extends it
        # across the coalescing boundary (the micro-batcher's dispatch
        # usually links the request span, not the descent's leaf)
        for linker, tgt in linked_into.get(tid, ()):
            if tgt["sid"] in path_sids:
                path.append({"name": linker["name"],
                             "ms": round(linker["dur"] / 1e3, 3)})
                break
        requests.append({"traceId": tid,
                         "e2eMs": round(e2e / 1e3, 3),
                         "coveredFraction": round(covered_frac, 4),
                         "path": path,
                         "attributionMs": {
                             k: round(v / 1e3, 3)
                             for k, v in sorted(attribution.items())}})
        e2e_all.append(e2e)
        for name, v in attribution.items():
            agg.setdefault(name, []).append(v)

    total_e2e = sum(e2e_all) or 1.0
    phases = {}
    for name, vals in sorted(agg.items()):
        vals_s = sorted(vals)
        phases[name] = {
            "n": len(vals),
            "p50Ms": round(_pct(vals_s, 0.50) / 1e3, 3),
            "p99Ms": round(_pct(vals_s, 0.99) / 1e3, 3),
            "share": round(sum(vals) / total_e2e, 4)}
    e2e_sorted = sorted(e2e_all)
    coverage = [r["coveredFraction"] for r in requests]
    requests.sort(key=lambda r: -r["e2eMs"])
    return {"requests": len(requests), "skippedTraces": skipped,
            "e2e": {"p50Ms": round(_pct(e2e_sorted, 0.50) / 1e3, 3),
                    "p99Ms": round(_pct(e2e_sorted, 0.99) / 1e3, 3)},
            "phases": phases,
            "coverage": {
                "min": round(min(coverage), 4) if coverage else None,
                "mean": round(sum(coverage) / len(coverage), 4)
                if coverage else None},
            "slowest": requests[:max(int(top_k), 0)]}


def diff_analyses(current: Dict[str, Any], baseline: Dict[str, Any],
                  threshold: float = 0.25,
                  abs_floor_ms: float = 0.5) -> Dict[str, Any]:
    """Regression watchdog: compare two :func:`analyze_trace` outputs.
    A phase (or e2e) REGRESSES when its p99 grew by more than
    ``threshold`` (relative) AND ``abs_floor_ms`` (absolute — sub-floor
    jitter on a fast phase is not a regression). Phases present in only
    one analysis are reported as added/removed, never as regressions."""
    verdicts: List[Dict[str, Any]] = []

    def check(name: str, cur: Optional[float],
              base: Optional[float]) -> None:
        if cur is None or base is None:
            verdicts.append({"phase": name,
                             "verdict": ("added" if base is None
                                         else "removed"),
                             "currentP99Ms": cur, "baselineP99Ms": base})
            return
        regressed = (cur > base * (1.0 + threshold)
                     and cur - base > abs_floor_ms)
        verdicts.append({
            "phase": name, "currentP99Ms": cur, "baselineP99Ms": base,
            "deltaMs": round(cur - base, 3),
            "deltaPct": (round((cur - base) / base * 100, 1)
                         if base else None),
            "verdict": "regressed" if regressed else "ok"})

    check("e2e", (current.get("e2e") or {}).get("p99Ms"),
          (baseline.get("e2e") or {}).get("p99Ms"))
    names = set(current.get("phases", {})) | set(
        baseline.get("phases", {}))
    for name in sorted(names):
        check(name,
              (current.get("phases", {}).get(name) or {}).get("p99Ms"),
              (baseline.get("phases", {}).get(name) or {}).get("p99Ms"))
    regressions = sum(1 for v in verdicts
                      if v["verdict"] == "regressed")
    return {"threshold": threshold, "absFloorMs": abs_floor_ms,
            "regressions": regressions, "ok": regressions == 0,
            "verdicts": verdicts}
