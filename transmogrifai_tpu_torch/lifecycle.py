"""The model lifecycle: a versioned registry and a serving-time drift
sentinel; the port of ``transmogrifai_tpu/lifecycle.py``.

The model server (``server.py``) holds tenants; this module gives it the
two stateful halves of a train → validate → deploy loop. The shadow and
canary rollout controller that uses them lives in ``server.py``.

* :class:`ModelRegistry`: an on-disk store of exported models by version.
  A version id is the program bank manifest's ``stateDigest``
  (``ScoringEngine.state_digest()``, which the bank loader also checks),
  so a version names the weights that are served; a save without a bank
  is named by a digest of its bytes. Each version records its model
  directory, bank directory, parameters digest, train metrics and plan
  report. ``promote`` and ``rollback`` move an atomic ``CURRENT``
  pointer (a temporary file, then ``os.replace``): a promote that dies
  leaves the old pointer intact. ``promote`` passes through the
  ``lifecycle.promote`` fault site. The port's digests are not the JAX
  package's for the same weights (its engine hashes its own state), so
  the two packages agree on registry behaviour, not on id strings.
* :class:`DriftSentinel`: per-feature
  :class:`~transmogrifai_tpu_torch.filters.distribution.FeatureDistribution`
  sketches of live traffic (host numpy; nothing runs on the card),
  compared each window with the training distributions saved with the
  model (``RawFeatureFilterResults.training_distributions``). A ring of
  sub-window sketches makes the window slide. Crossings raise TMG601 /
  TMG602 through ``lint.Finding``, the ``lintSuppress`` machinery and
  ``lint.emit_findings``, the ``on_drift`` listener hook and the
  ``drift.*`` gauges; a model without a baseline gets TMG603.

:func:`lifecycle_stats` are always-on tallies, stamped on every runner
metrics document whether telemetry is on or off.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import resilience, telemetry
from .utils import locks

logger = logging.getLogger(__name__)

__all__ = ["ModelRegistry", "RegistryError", "DriftSentinel",
           "version_of_export", "lifecycle_stats", "reset_lifecycle_stats",
           "DEFAULT_DRIFT_WINDOW_ROWS", "DEFAULT_DRIFT_SUBWINDOWS",
           "DEFAULT_JS_THRESHOLD", "DEFAULT_FILL_DELTA_THRESHOLD",
           "DEFAULT_FILL_RATIO_THRESHOLD"]

#: rows in one sliding comparison window (the sentinel compares the
#: merged ring with the training distributions once this many live rows
#: are in the ring)
DEFAULT_DRIFT_WINDOW_ROWS = 2048

#: sub-window sketches in the ring: the window slides by 1/N of its span
DEFAULT_DRIFT_SUBWINDOWS = 4

#: train/live JS divergence (log2, in [0, 1]) above which a feature is
#: drifting (TMG601); tighter than the RawFeatureFilter's 0.90 exclusion
DEFAULT_JS_THRESHOLD = 0.25

#: |train fill − live fill| above which a feature's fill rate shifted
#: (TMG602)
DEFAULT_FILL_DELTA_THRESHOLD = 0.25

#: max(fill) / min(fill) above which TMG602 also fires (a 1% → 20% shift
#: the absolute delta misses)
DEFAULT_FILL_RATIO_THRESHOLD = 20.0


# ---------------------------------------------------------------------------
# always-on tallies (runner documents stamp these; telemetry mirrors)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"registered": 0, "promotions": 0, "rollbacks": 0,
          "deploys": 0, "auto_promotions": 0, "auto_rollbacks": 0,
          "drift_windows": 0, "drift_advisories": 0,
          "drift_dropped_batches": 0, "sentinel_errors": 0,
          "shadow_requests": 0, "shadow_parity_ok": 0,
          "shadow_parity_mismatch": 0, "canary_requests": 0}


def lifecycle_stats() -> Dict[str, int]:
    """Snapshot of the process-wide lifecycle tallies: registry traffic,
    rollout deploys, promotions and rollbacks, drift windows compared and
    advisories raised, shadow parity and canary routing counts."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_lifecycle_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def tally(key: str, n: int = 1) -> None:
    """Bump one lifecycle tally (the server's rollout controller shares
    this table, so every lifecycle fact lands in one stamped block)."""
    with _TALLY_LOCK:
        _TALLY[key] += n
    telemetry.counter(f"lifecycle.{key}").inc(n)  # lint: metric-name — keys are the fixed lifecycle_stats tally catalog


# ---------------------------------------------------------------------------
# version identity
# ---------------------------------------------------------------------------


def _file_digest(h, path: str) -> None:
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)


def _artifact_digest(model_dir: str) -> str:
    """blake2b-128 over a saved model's ``model.json`` and the weights
    archive it names: the identity of a save without a bank."""
    from .model_io import MODEL_JSON, WEIGHTS_NPZ
    h = hashlib.blake2b(digest_size=16)
    mj = os.path.join(model_dir, MODEL_JSON)
    _file_digest(h, mj)
    with open(mj) as fh:
        doc = json.load(fh)
    weights = os.path.join(model_dir, doc.get("weightsFile", WEIGHTS_NPZ))
    if os.path.exists(weights):
        _file_digest(h, weights)
    return h.hexdigest()


def version_of_export(model_dir: str, bank_dir: Optional[str] = None) -> str:
    """The version id of a saved model: the program bank manifest's
    ``stateDigest`` when the export directory has a bank (the scoring
    artifact's metadata records it too), else a digest of the saved
    bytes. The bank loader refuses a model whose state differs from its
    manifest, so a version and the weights it serves cannot part."""
    if bank_dir:
        from . import aot, serving
        manifest, _ = aot.read_manifest(bank_dir)
        if manifest and manifest.get("stateDigest"):
            return str(manifest["stateDigest"])
        meta_path = os.path.join(bank_dir, serving._SCORE_META)
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)
            if meta.get("stateDigest"):
                return str(meta["stateDigest"])
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            pass
    return _artifact_digest(model_dir)


def _params_digest(model_dir: str) -> Optional[str]:
    """blake2b-128 over the saved model's run parameters block (the
    OpParams it trained under): a cheap "same config?" probe."""
    from .model_io import MODEL_JSON
    try:
        with open(os.path.join(model_dir, MODEL_JSON)) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    blob = json.dumps(doc.get("parameters") or {}, sort_keys=True,
                      default=str).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


# ---------------------------------------------------------------------------
# ModelRegistry
# ---------------------------------------------------------------------------


class RegistryError(Exception):
    """Registry misuse: unknown model or version, no rollback target."""


_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")
_VID_RE = re.compile(r"^[A-Za-z0-9._-]{1,200}$")

VERSIONS_DIR = "versions"
POINTER_FILE = "CURRENT.json"
REGISTRY_FORMAT_VERSION = 1


class ModelRegistry:
    """On-disk versioned model store with an atomic ``current`` pointer.

    Layout (one directory per model name), the JAX package's::

        <root>/<name>/versions/<vid>.json   # one file per version record
        <root>/<name>/CURRENT.json          # {"current": vid, "previous": vid}

    Every file is written to a temporary name and moved with
    ``os.replace``, so a reader sees a whole document and a promote that
    dies at any instant leaves the old pointer or the new one. One file a
    version means registrations from several processes never lose each
    other's records. The registry holds metadata and paths; the
    artifacts stay where the exporter wrote them."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = locks.witness_lock("lifecycle.ModelRegistry._lock")

    # -- paths / io --------------------------------------------------------
    def _mdir(self, name: str, create: bool = False) -> str:
        if not _NAME_RE.match(name or ""):
            raise RegistryError(
                f"invalid model name {name!r} (alnum . _ - only)")
        d = os.path.join(self.root, name)
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    @staticmethod
    def _read_json(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise RegistryError(f"registry file unreadable at {path!r}: "
                                f"{e}") from e

    @staticmethod
    def _write_json_atomic(path: str, doc: Dict[str, Any]) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, default=str)
        os.replace(tmp, path)

    def _vdir(self, name: str, create: bool = False) -> str:
        d = os.path.join(self._mdir(name, create=create), VERSIONS_DIR)
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def _vpath(self, name: str, version: str) -> str:
        if not _VID_RE.match(str(version) or ""):
            raise RegistryError(
                f"invalid version id {version!r} (alnum . _ - only)")
        return os.path.join(self._vdir(name), f"{version}.json")

    def _pointer_doc(self, name: str) -> Dict[str, Any]:
        doc = self._read_json(os.path.join(self._mdir(name), POINTER_FILE))
        return doc or {"current": None, "previous": None}

    def pointer_lock_path(self, name: str) -> str:
        """The persistent ``flock`` file that serializes pointer writers
        across processes (a killed holder's lock is released by the OS)."""
        return os.path.join(self._mdir(name, create=True),
                            POINTER_FILE + ".lock")

    @contextlib.contextmanager
    def _pointer_mutation(self, name: str, timeout_s: float = 10.0):
        """Cross-process exclusion for the pointer's read-modify-write
        (promote and rollback compute ``previous`` from the pointer they
        read). An ``flock`` on a persistent lock file serializes writers;
        a contender that cannot take it within ``timeout_s`` raises
        instead of going on unlocked. Readers never take it."""
        import fcntl
        path = self.pointer_lock_path(name)
        fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
        t0 = time.monotonic()
        try:
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError:
                    if time.monotonic() - t0 > timeout_s:
                        raise RegistryError(
                            f"pointer lock for {name!r} held elsewhere "
                            f"for > {timeout_s:g}s ({path})")
                    time.sleep(0.01)  # lint: lock-blocking — backoff after a FAILED flock attempt; nothing is held here (the analyzer scopes flocks to the whole function)
            locks.witness_acquire("lifecycle.pointer.flock")
            yield
        finally:
            locks.witness_release("lifecycle.pointer.flock")
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            except OSError:
                pass
            os.close(fd)

    # -- queries -----------------------------------------------------------
    def models(self) -> List[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d,
                                                    VERSIONS_DIR)))

    def versions(self, name: str) -> List[Dict[str, Any]]:
        """All version records of ``name``, oldest first."""
        vdir = self._vdir(name)
        try:
            files = [f for f in os.listdir(vdir) if f.endswith(".json")]
        except FileNotFoundError:
            return []
        recs = [r for r in (self._read_json(os.path.join(vdir, f))
                            for f in files) if r is not None]
        recs.sort(key=lambda r: (r.get("registeredAt", 0.0), r["version"]))
        return recs

    def record(self, name: str, version: str) -> Dict[str, Any]:
        rec = self._read_json(self._vpath(name, str(version)))
        if rec is None:
            raise RegistryError(
                f"model {name!r} has no version {version!r} (have: "
                f"{[r['version'] for r in self.versions(name)]})")
        return rec

    def current(self, name: str) -> Optional[str]:
        return self._pointer_doc(name).get("current")

    def previous(self, name: str) -> Optional[str]:
        return self._pointer_doc(name).get("previous")

    def resolve(self, name: str) -> Dict[str, Any]:
        """The record the ``current`` pointer names: what a serving tenant
        loads. Raises when nothing was ever promoted."""
        cur = self.current(name)
        if cur is None:
            raise RegistryError(
                f"model {name!r} has no current version (promote one)")
        return self.record(name, cur)

    def status(self, name: str) -> Dict[str, Any]:
        ptr = self._pointer_doc(name)
        return {"name": name, "current": ptr.get("current"),
                "previous": ptr.get("previous"),
                "versions": self.versions(name)}

    # -- mutations ---------------------------------------------------------
    def register(self, name: str, model_dir: str,
                 bank_dir: Optional[str] = None,
                 train_metrics: Optional[Dict[str, Any]] = None,
                 plan_report: Optional[Any] = None,
                 version: Optional[str] = None,
                 promote: bool = False) -> str:
        """Record one exported model as a version of ``name``; returns the
        version id (from the artifacts unless given). Registering an
        existing version again updates its record in place.
        ``promote=True`` also moves the ``current`` pointer."""
        vid = str(version or version_of_export(model_dir, bank_dir))
        rec = {"version": vid,
               "formatVersion": REGISTRY_FORMAT_VERSION,
               "modelDir": os.path.abspath(model_dir),
               "bankDir": (os.path.abspath(bank_dir) if bank_dir
                           else None),
               "paramsDigest": _params_digest(model_dir),
               "trainMetrics": train_metrics,
               "planReport": plan_report,
               # wall-clock by design: registration times are compared
               # across processes and displayed, never used as durations
               "registeredAt": time.time()}   # lint: wall-clock
        with self._lock:
            self._vdir(name, create=True)
            self._write_json_atomic(self._vpath(name, vid), rec)
        tally("registered")
        logger.info("registry: %s version %s registered (%s)", name, vid,
                    model_dir)
        if promote:
            self.promote(name, vid)
        return vid

    def promote(self, name: str, version: str) -> Dict[str, Any]:
        """Point ``current`` at ``version`` (which must be registered). The
        swap is one ``os.replace``: a crash before it leaves the old
        pointer, after it the new one. The ``lifecycle.promote`` fault
        site fires before the swap, so an injected fault is the worst
        crash (pointer untouched). Writers serialize across processes on
        the pointer lock file."""
        with self._pointer_mutation(name), self._lock:
            self.record(name, version)          # must exist
            ptr = self._pointer_doc(name)
            if ptr.get("current") == str(version):
                return ptr                      # idempotent
            resilience.inject("lifecycle.promote", model=name,
                              version=version)
            new_ptr = {"current": str(version),
                       "previous": ptr.get("current"),
                       "updatedAt": time.time()}   # lint: wall-clock
            self._write_json_atomic(
                os.path.join(self._mdir(name), POINTER_FILE), new_ptr)
        tally("promotions")
        logger.info("registry: %s current -> %s (was %s)", name,
                    new_ptr["current"], new_ptr["previous"])
        return new_ptr

    def rollback(self, name: str) -> str:
        """Swing ``current`` back to ``previous``. The version rolled back
        from stays registered and becomes ``previous``, so a rollback is
        its own undo."""
        with self._pointer_mutation(name), self._lock:
            ptr = self._pointer_doc(name)
            prev = ptr.get("previous")
            if prev is None:
                raise RegistryError(
                    f"model {name!r} has no previous version to roll "
                    "back to")
            self.record(name, prev)             # still registered?
            new_ptr = {"current": str(prev),
                       "previous": ptr.get("current"),
                       "updatedAt": time.time()}   # lint: wall-clock
            self._write_json_atomic(
                os.path.join(self._mdir(name), POINTER_FILE), new_ptr)
        tally("rollbacks")
        logger.info("registry: %s rolled back to %s", name, prev)
        return str(prev)


# ---------------------------------------------------------------------------
# DriftSentinel
# ---------------------------------------------------------------------------


class DriftSentinel:
    """Streaming comparison of live traffic with the training data.

    :meth:`observe` folds each scored batch into the current sub-window
    sketch (host numpy: masks and one histogram or hash pass a feature).
    Each completed sub-window joins a ring of ``subwindows`` sketches
    whose sum (``FeatureDistribution.__add__``) is the sliding window.
    Once the ring holds a full window, every flush compares the merged
    live distributions with the baseline:

    * JS divergence above ``js_threshold``            → TMG601
    * |fill delta| above ``fill_delta_threshold`` or
      fill ratio above ``fill_ratio_threshold``       → TMG602

    Findings go through ``lintSuppress`` muting,
    :func:`~transmogrifai_tpu_torch.lint.emit_findings`, the ``on_drift``
    listener hook and the ``drift.*`` gauges. The sentinel never raises
    into the score path: it reports."""

    def __init__(self, baseline: Sequence[Any], raw_features: Sequence[Any],
                 window_rows: int = DEFAULT_DRIFT_WINDOW_ROWS,
                 subwindows: int = DEFAULT_DRIFT_SUBWINDOWS,
                 js_threshold: float = DEFAULT_JS_THRESHOLD,
                 fill_delta_threshold: float = DEFAULT_FILL_DELTA_THRESHOLD,
                 fill_ratio_threshold: float = DEFAULT_FILL_RATIO_THRESHOLD,
                 bins: Optional[int] = None,
                 suppress: Sequence[str] = (),
                 model_name: str = ""):
        from .filters.distribution import Summary
        self.window_rows = max(int(window_rows), 1)
        self.subwindows = max(int(subwindows), 1)
        self.subwindow_rows = max(self.window_rows // self.subwindows, 1)
        self.js_threshold = float(js_threshold)
        self.fill_delta_threshold = float(fill_delta_threshold)
        self.fill_ratio_threshold = float(fill_ratio_threshold)
        self.suppress = tuple(suppress)
        self.model_name = model_name
        #: (name, key) -> training FeatureDistribution
        self._baseline = {(d.name, d.key): d for d in baseline}
        names = {d.name for d in baseline}
        #: only features with a baseline are sketched
        self._features = [f for f in raw_features if f.name in names]
        #: one bin count for all: the baseline was binned under one filter
        #: configuration, so it reproduces the training edges
        self.bins = int(bins) if bins else self._infer_bins(baseline)
        #: (name, key) -> Summary of the training bin range, so live
        #: numeric histograms share the baseline's edges
        self._summaries: Dict[Tuple[str, Optional[str]], Summary] = {}
        for d in baseline:
            if len(d.summary_info) >= 3:        # numeric: [lo, hi, bins]
                self._summaries[(d.name, d.key)] = Summary(
                    min=float(d.summary_info[0]),
                    max=float(d.summary_info[1]))
        self._lock = locks.witness_lock("lifecycle.DriftSentinel._lock")
        self._pending: Dict[Tuple[str, Optional[str]], Any] = {}
        self._pending_rows = 0
        #: window subscribers: fn(findings, report) after every completed
        #: comparison window, clean ones included
        self._subscribers: List[Any] = []
        #: ring of (rows, {key: FeatureDistribution}) sub-window sketches
        self._ring: "deque[Tuple[int, Dict[Tuple[str, Optional[str]], Any]]]" \
            = deque(maxlen=self.subwindows)
        self.rows_seen = 0
        self.windows_compared = 0
        self.advisories = 0
        self.last_findings: List[Any] = []
        self.last_report: Optional[Dict[str, Any]] = None

    @staticmethod
    def _infer_bins(baseline: Sequence[Any]) -> int:
        for d in baseline:
            if d.distribution.size:
                return int(d.distribution.size)
        return 100

    # -- construction from a model -----------------------------------------
    @classmethod
    def for_model(cls, model, model_name: str = "",
                  **kw) -> Optional["DriftSentinel"]:
        """A sentinel over a model's saved training distributions; None,
        with a TMG603 advisory, when the model has no
        ``RawFeatureFilterResults`` baseline (it trained without a
        RawFeatureFilter)."""
        from . import lint
        from .workflow import _raw_features_of
        rff = getattr(model, "rff_results", None)
        baseline = list(getattr(rff, "training_distributions", ()) or ())
        if not baseline:
            f = lint.Finding(
                "TMG603", "drift sentinel inactive: the model carries no "
                "train-time feature distributions (train with a "
                "RawFeatureFilter to persist them)",
                feature=model_name or None)
            lint.emit_findings([f])
            logger.info("lifecycle: %s", f.format())
            return None
        raw = [f for f in _raw_features_of(model.result_features)
               if not f.is_response]
        bins = None
        cfg = getattr(rff, "config", None) or {}
        if cfg.get("bins"):
            bins = int(cfg["bins"])
        return cls(baseline, raw, bins=bins, model_name=model_name, **kw)

    # -- accumulation ------------------------------------------------------
    def _sketch(self, store) -> Dict[Tuple[str, Optional[str]], Any]:
        from .filters.distribution import distributions_of_column
        out: Dict[Tuple[str, Optional[str]], Any] = {}
        for f in self._features:
            col = store.get(f.name)
            if col is None:
                continue
            for d in distributions_of_column(f.name, col, self.bins,
                                             self._summaries):
                if (d.name, d.key) in self._baseline:
                    out[(d.name, d.key)] = d
        return out

    def _raw_store(self, data):
        from .columns import ColumnStore, column_of_empty
        from .workflow import _raw_store
        if isinstance(data, ColumnStore):
            missing = {f.name: column_of_empty(f.ftype, data.n_rows)
                       for f in self._features if f.name not in data}
            store = data.with_columns(missing) if missing else data
            return store.select([f.name for f in self._features])
        return _raw_store(data, self._features)

    def subscribe(self, fn) -> None:
        """Register ``fn(findings, report)``, called after every completed
        comparison window, clean ones included (a hysteresis consumer
        needs the resets). Callbacks run on the observing thread; one that
        raises is logged and skipped."""
        self._subscribers.append(fn)

    def observe(self, data) -> List[Any]:
        """Fold one scored batch (records or a raw ColumnStore) into the
        current sub-window sketch; returns the findings of any window
        comparison it completed (empty most of the time)."""
        if not self._features:
            return []
        n = (data.n_rows if hasattr(data, "n_rows") else len(data))
        if not n:
            return []
        store = self._raw_store(data)
        sketch = self._sketch(store)
        findings: List[Any] = []
        compared = False
        with self._lock:
            self.rows_seen += n
            for k, d in sketch.items():
                prev = self._pending.get(k)
                self._pending[k] = d if prev is None else prev + d
            self._pending_rows += n
            if self._pending_rows >= self.subwindow_rows:
                self._ring.append((self._pending_rows, dict(self._pending)))
                self._pending = {}
                self._pending_rows = 0
                ring_rows = sum(r for r, _ in self._ring)
                if ring_rows >= min(self.window_rows,
                                    self.subwindow_rows * self.subwindows):
                    findings = self._compare_locked(ring_rows)
                    compared = True
        if findings:
            self._emit(findings)
        if compared:
            report = self.last_report
            for fn in list(self._subscribers):
                try:
                    fn(list(findings), report)
                except Exception:  # lint: broad-except — a subscriber must never take down drift observation
                    logger.exception(
                        "drift window subscriber %r failed", fn)
        return findings

    # -- comparison --------------------------------------------------------
    def _merged_locked(self) -> Dict[Tuple[str, Optional[str]], Any]:
        merged: Dict[Tuple[str, Optional[str]], Any] = {}
        for _, sketch in self._ring:
            for k, d in sketch.items():
                prev = merged.get(k)
                merged[k] = d if prev is None else prev + d
        return merged

    def _compare_locked(self, ring_rows: int) -> List[Any]:
        from . import lint
        findings: List[Any] = []
        report: Dict[str, Any] = {"rows": ring_rows, "features": {}}
        for k, live in self._merged_locked().items():
            base = self._baseline.get(k)
            if base is None:
                continue
            js = base.js_divergence(live)
            # the histogram covers the training range only: live mass
            # outside it is invisible to the in-range JS term, so the
            # out-of-range fraction is a lower bound of the divergence
            present = live.count - live.nulls
            if present > 0 and base.distribution.size:
                out_frac = 1.0 - min(float(live.distribution.sum())
                                     / present, 1.0)
                js = max(js, out_frac)
            fill_delta = base.relative_fill_rate(live)
            fill_ratio = base.relative_fill_ratio(live)
            fname = live.full_name
            report["features"][fname] = {
                "js": round(js, 4), "fillDelta": round(fill_delta, 4),
                "liveFill": round(live.fill_rate(), 4),
                "trainFill": round(base.fill_rate(), 4)}
            if js > self.js_threshold:
                findings.append(lint.Finding(
                    "TMG601",
                    f"serving-time drift: train↔live JS divergence "
                    f"{js:.3f} > {self.js_threshold:g} over the last "
                    f"{ring_rows} rows", feature=fname))
            if (fill_delta > self.fill_delta_threshold
                    or fill_ratio > self.fill_ratio_threshold):
                findings.append(lint.Finding(
                    "TMG602",
                    f"serving-time drift: fill rate "
                    f"{base.fill_rate():.3f} (train) vs "
                    f"{live.fill_rate():.3f} (live) — delta "
                    f"{fill_delta:.3f}, ratio {fill_ratio:.2f} over the "
                    f"last {ring_rows} rows", feature=fname))
        findings = lint._apply_suppress(findings, self.suppress)
        self.windows_compared += 1
        tally("drift_windows")
        report["advisories"] = len(findings)
        self.last_report = report
        self.last_findings = findings
        if findings:
            self.advisories += len(findings)
            tally("drift_advisories", len(findings))
        return findings

    def _emit(self, findings: List[Any]) -> None:
        from . import lint
        lint.emit_findings(findings)
        rows = (self.last_report or {}).get("rows", 0)
        feats = (self.last_report or {}).get("features", {})
        for f in findings:
            logger.warning("drift[%s]: %s", self.model_name, f.format())
            info = feats.get(f.feature, {})
            value = info.get("js" if f.rule == "TMG601" else "fillDelta",
                             0.0)
            threshold = (self.js_threshold if f.rule == "TMG601"
                         else self.fill_delta_threshold)
            telemetry.emit("drift", model=self.model_name,
                           feature=f.feature, rule=f.rule,
                           value=float(value), threshold=float(threshold),
                           window_rows=int(rows))
        if telemetry.enabled():
            for fname, info in feats.items():
                telemetry.gauge(f"drift.js_divergence.{fname}").set(  # lint: metric-name — bounded by the model's persisted feature set
                    info["js"])
                telemetry.gauge(f"drift.fill_rate_delta.{fname}").set(  # lint: metric-name — bounded by the model's persisted feature set
                    info["fillDelta"])

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"rowsSeen": self.rows_seen,
                    "windowRows": self.window_rows,
                    "subwindows": self.subwindows,
                    "windowsCompared": self.windows_compared,
                    "advisories": self.advisories,
                    "trackedFeatures": len(self._baseline),
                    "lastWindow": (dict(self.last_report)
                                   if self.last_report else None)}
