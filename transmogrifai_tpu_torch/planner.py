"""Cost-based whole-DAG plan analyzer; the port of
``transmogrifai_tpu/planner.py``.

It interprets a fitted model's feature DAG on ``lint.py``'s synthetic
typed store (no dataset is read, nothing runs on a device) and emits an
explainable :class:`ExecutionPlan` that ``Workflow`` fitting and the
scoring engine follow:

* **Dead-column pruning.** Column liveness propagated from the sinks
  (result features, predictors) backward through the fused select /
  scale / combine chain: vectorizer output columns the SanityChecker
  drops before the predictor are dead in the device program, and the
  scoring engine gathers them away right after ``device_compute``. A
  gather of a concatenation equals the concatenation of the gathers, so
  scores are bitwise equal to the unplanned program's.
* **Cross-stage CSE.** Structurally identical vectorizers (same class,
  params without the uid, input features and bit-identical fitted state)
  merge into one computation whose output fans out in the program. Near
  misses that differ only in uid-like params are TMG403 advisories.
* **Tiers.** Host or device per stage and per phase (the scoring engine,
  the fused statistics pass, the fused layer transform, the temporal
  aggregation route), from a :class:`CostDatabase` of measured costs
  (JSON, written atomically). A tier is decided only where both sides
  were measured; otherwise it is None and the engine and the fit do what
  they do unplanned. A tier changes cost, never a result.
* **Explanation.** A stable report (``ExecutionPlan.report``) and JSON
  form (the runner's ``plan`` block), and the TMG4xx findings, which
  take the pre-flight's ``failOn`` / ``lintSuppress`` path.

Static cost model (per 1,000 rows, where the database has no
measurement): ``host`` = bytes a row ÷ :data:`STATIC_HOST_GBPS`;
``device`` = bytes a row ÷ the link (the database's measured rate, else
:data:`LINK_PRIOR_MBPS`) + bytes a row ÷ :data:`STATIC_DEVICE_GBPS`.
Each plan entry says which source (``measured`` / ``static``) decided.

Every plan is a ``plan`` event for the run listeners
(``telemetry.emit``). :func:`ingest_route_tier` steers the streamed fit's
auto mode (``streamFit: null``; the runner installs it with
``workflow.set_stream_fit(ingest_hint=)``), from the
``phase:workflow.ingest`` observations ``Workflow.train`` makes over a
directory reader.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import telemetry

logger = logging.getLogger(__name__)

__all__ = [
    "CostDatabase", "ExecutionPlan", "PlanEntry",
    "plan_model", "plan_workflow", "record_fit_costs",
    "observe_phase", "drain_phase_observations",
    "aggregate_route_tier", "ingest_route_tier",
    "default_cost_db_path", "planner_stats", "reset_planner_stats",
    "COST_DB_FILENAME", "STATIC_HOST_GBPS", "STATIC_DEVICE_GBPS",
    "LINK_PRIOR_MBPS",
]

#: the cost database's file name (the JAX package's, so either package
#: reads the other's)
COST_DB_FILENAME = "tmog_cost_db.json"

#: static prior: host numpy streams a transform at about this rate
STATIC_HOST_GBPS = 1.0

#: static prior: a device transform is bound by the card's memory at
#: about this rate — the device-to-device copy (bytes read + written)
#: ``chip_smoke.py`` phase 14 measured on one NVIDIA H100 80GB HBM3 at
#: 700.00 W: 2,780.9 GB/s
STATIC_DEVICE_GBPS = 2780.0

#: static prior: the host-to-device link, MB/s, where the cost database
#: has no measured rate — the pageable copy ``chip_smoke.py`` phase 14
#: measured on one NVIDIA H100 80GB HBM3 at 700.00 W: 5.18 GB/s (pinned:
#: 53.55 GB/s); the engine's uploads are pageable copies of prepared
#: blocks
LINK_PRIOR_MBPS = 5180.0

# ---------------------------------------------------------------------------
# always-on tallies
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"plans_built": 0, "cse_merges": 0, "pruned_columns": 0,
          "stages_fused": 0, "stages_host": 0}


def planner_stats() -> Dict[str, int]:
    """Process-wide planner tallies: plans built, CSE merges found, dead
    columns found, stages by tier."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_planner_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


# ---------------------------------------------------------------------------
# phase-cost observations: how the measured phase tiers are fed
# ---------------------------------------------------------------------------

#: pending (phase, tier, seconds, rows) observations reported by the fused
#: statistics pass, the fused layer transform and the temporal route as
#: they run; the runner drains them into the cost database after a run.
#: Bounded, so a process that never drains cannot grow it without limit.
_OBS_LOCK = threading.Lock()
_PHASE_OBS: List[Tuple[str, str, float, int]] = []
_PHASE_OBS_CAP = 4096


def observe_phase(phase: str, tier: str, seconds: float,
                  rows: int) -> None:
    """Record one measured phase run (``phase`` in ``fitstats`` /
    ``transform`` / ``temporal.route_aggregate``, ``tier`` in ``host`` /
    ``device`` / ``columnar`` / ``rowwise``). Callers report only where
    the tier decision is contested (at or above the row floor), so the
    tiers' seconds per 1,000 rows stay comparable."""
    if rows <= 0 or seconds < 0:
        return
    with _OBS_LOCK:
        if len(_PHASE_OBS) < _PHASE_OBS_CAP:
            _PHASE_OBS.append((str(phase), str(tier), float(seconds),
                               int(rows)))


def drain_phase_observations(db: "CostDatabase") -> int:
    """Fold every pending observation into ``db`` (as ``phase:<name>``
    stage entries, which :func:`_phase_tier` reads) and clear the buffer;
    returns the count drained."""
    with _OBS_LOCK:
        obs = list(_PHASE_OBS)
        del _PHASE_OBS[:]
    for phase, tier, s, rows in obs:
        db.record_stage(f"phase:{phase}", tier, s, rows)
    return len(obs)


# ---------------------------------------------------------------------------
# the cost database
# ---------------------------------------------------------------------------


def default_cost_db_path(cache_dir: Optional[str]) -> Optional[str]:
    """Where the cost database lives for a cache directory (None when no
    directory is configured: the database is then in memory only)."""
    if not cache_dir:
        return None
    return os.path.join(str(cache_dir), COST_DB_FILENAME)


class CostDatabase:
    """Measured per-stage-class and whole-chain costs, as JSON; the JAX
    package's schema (``version`` 1), so each package reads the other's::

        {"version": 1,
         "bandwidth_mbps": 1234.5 | null,   # sustained host→device link
         "probe_mbps": 23.4 | null,         # a cold single-shot copy
         "chain": {"engine_s_per_krow": ..., "host_s_per_krow": ...},
         "stages": {"<StageClass>": {
             "fit":    {"s_per_krow": ..., "n": k},
             "host":   {"s_per_krow": ..., "n": k},
             "device": {"s_per_krow": ..., "n": k}}}}

    Writes go to a temporary file and ``os.replace``; a corrupt or
    truncated file loads as a fresh database flagged ``corrupt`` with a
    TMG404 finding, and the static estimates hold until new measurements
    land."""

    VERSION = 1

    def __init__(self, path: Optional[str] = None,
                 doc: Optional[Dict[str, Any]] = None,
                 corrupt: bool = False):
        self.path = path
        self.corrupt = corrupt
        self.doc: Dict[str, Any] = doc if doc is not None else {
            "version": self.VERSION, "bandwidth_mbps": None,
            "chain": {}, "stages": {}}

    @classmethod
    def load(cls, path: Optional[str]) -> "CostDatabase":
        """Load from ``path``: a missing file is a fresh database, a
        corrupt or truncated one a fresh database flagged ``corrupt``."""
        if not path or not os.path.exists(path):
            return cls(path=path)
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if (not isinstance(doc, dict)
                    or not isinstance(doc.get("stages"), dict)
                    or doc.get("version") != cls.VERSION):
                raise ValueError(f"unexpected cost-db structure in {path}")
        except (OSError, ValueError) as e:
            # json.JSONDecodeError is a ValueError
            logger.warning("cost database %s unreadable (%s); static "
                           "estimates in force", path, e)
            return cls(path=path, corrupt=True)
        doc.setdefault("bandwidth_mbps", None)
        doc.setdefault("probe_mbps", None)
        doc.setdefault("chain", {})
        return cls(path=path, doc=doc)

    def save(self, path: Optional[str] = None) -> bool:
        """Write atomically (temporary file + ``os.replace``): a kill
        mid-write never leaves a truncated database behind. In a world of
        ranks only the coordinator writes (every rank measures the same
        phases); the others return False."""
        path = path or self.path
        if not path:
            return False
        from .parallel.multihost import is_coordinator
        if not is_coordinator():
            return False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.path = path
        return True

    def finding(self):
        """The TMG404 warning when this database loaded corrupt, else
        None."""
        if not self.corrupt:
            return None
        from .lint import Finding
        return Finding(
            "TMG404", "cost database is corrupt/truncated — falling back "
            "to static estimates (delete or regenerate it to clear this)",
            location=self.path)

    #: running-mean window: a new observation keeps at least 1/WINDOW
    #: weight, so a changed card or link re-converges
    MERGE_WINDOW = 32

    @classmethod
    def _merge(cls, slot: Dict[str, Any], s_per_krow: float) -> None:
        n = min(int(slot.get("n", 0)), cls.MERGE_WINDOW - 1)
        old = float(slot.get("s_per_krow", 0.0))
        slot["s_per_krow"] = round((old * n + s_per_krow) / (n + 1), 6)
        slot["n"] = int(slot.get("n", 0)) + 1

    def record_stage(self, class_name: str, tier: str, seconds: float,
                     rows: int) -> None:
        """Fold one measured (class, tier) observation in; ``tier`` is
        ``fit`` / ``host`` / ``device`` (or a phase's tier)."""
        if rows <= 0 or seconds < 0:
            return
        slot = self.doc["stages"].setdefault(str(class_name), {}) \
            .setdefault(tier, {})
        self._merge(slot, seconds / (rows / 1000.0))

    def record_bandwidth(self, mbps: float,
                         probe_mbps: Optional[float] = None) -> None:
        """``mbps``: the sustained host→device rate tier decisions use;
        ``probe_mbps``: a cold single-shot copy, kept beside it."""
        self.doc["bandwidth_mbps"] = round(float(mbps), 1)
        if probe_mbps is not None:
            self.doc["probe_mbps"] = round(float(probe_mbps), 1)

    def record_chain(self, host_rows_per_s: Optional[float] = None,
                     engine_rows_per_s: Optional[float] = None) -> None:
        """Whole-chain scoring rates (the layer path against the engine):
        the strongest tier evidence there is."""
        ch = self.doc["chain"]
        if host_rows_per_s and host_rows_per_s > 0:
            ch["host_s_per_krow"] = round(1000.0 / host_rows_per_s, 6)
        if engine_rows_per_s and engine_rows_per_s > 0:
            ch["engine_s_per_krow"] = round(1000.0 / engine_rows_per_s, 6)

    def stage_cost(self, class_name: str, tier: str) -> Optional[float]:
        slot = self.doc["stages"].get(class_name, {}).get(tier)
        return float(slot["s_per_krow"]) if slot else None

    def chain_cost(self, which: str) -> Optional[float]:
        v = self.doc["chain"].get(f"{which}_s_per_krow")
        return float(v) if v is not None else None

    def bandwidth_mbps(self) -> Optional[float]:
        v = self.doc.get("bandwidth_mbps")
        return float(v) if v else None


def record_fit_costs(model, db: CostDatabase) -> int:
    """A freshly trained model's per-stage fit seconds (its
    ``stage_metrics``) into ``db``; returns the observations recorded.
    Warm-started stages carry no measurement and are skipped, and a
    loaded model (``train_rows`` 0) records nothing."""
    rows = int(getattr(model, "train_rows", 0) or 0)
    if rows <= 0:
        return 0
    n = 0
    for _uid, m in sorted(model.stage_metrics.items()):
        if m.get("warmStarted") or "fitSeconds" not in m:
            continue
        execute = m.get("executeSeconds", m["fitSeconds"])
        db.record_stage(m.get("stageName", "?"), "fit", float(execute),
                        rows)
        n += 1
    return n


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclass
class PlanEntry:
    """One stage's row in the execution plan."""

    uid: str
    stage: str                      # stage class / display name
    kind: str                       # vec|combine|select|scale|predict|
    #                                 deindex|host|estimator
    tier: str                       # host|fused
    reason: str
    est_host_s_per_krow: Optional[float] = None
    est_device_s_per_krow: Optional[float] = None
    measured_s_per_krow: Optional[float] = None
    source: str = "static"          # static|measured

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "uid": self.uid, "stage": self.stage, "kind": self.kind,
            "tier": self.tier, "reason": self.reason,
            "source": self.source}
        for k, v in (("estHostSPerKrow", self.est_host_s_per_krow),
                     ("estDeviceSPerKrow", self.est_device_s_per_krow),
                     ("measuredSPerKrow", self.measured_s_per_krow)):
            if v is not None:
                out[k] = v
        return out


class ExecutionPlan:
    """The planner's output: explainable, stable and executable.

    ``Workflow`` fitting reads ``fitstats_tier`` / ``transform_tier``;
    the scoring engine reads ``engine_tier``, ``prune`` (each vectorizer's
    live column indices) and ``cse`` (verified merge groups); the runner
    installs ``aggregate_tier`` for the temporal route. ``report()`` and
    ``to_json()`` are byte-stable for a given (DAG, cost database)."""

    def __init__(self, entries: List[PlanEntry],
                 prune: Optional[Dict[str, np.ndarray]] = None,
                 widths: Optional[Dict[str, int]] = None,
                 cse: Optional[List[Dict[str, Any]]] = None,
                 cse_suppressed: Optional[List[Dict[str, Any]]] = None,
                 engine_tier: Optional[str] = None,
                 fitstats_tier: Optional[str] = None,
                 transform_tier: Optional[str] = None,
                 aggregate_tier: Optional[str] = None,
                 link_mbps: float = 0.0, link_source: str = "prior",
                 tier_findings: Optional[List[Any]] = None,
                 db_finding: Optional[Any] = None):
        self.entries = entries
        #: {vec stage uid: sorted live column indices}, only stages with
        #: at least one dead column
        self.prune = prune or {}
        #: {vec stage uid: declared output width} of the pruned stages
        self.widths = widths or {}
        #: verified merges: [{"kept": uid, "dropped": [uid...],
        #: "stage": class}]
        self.cse = cse or []
        self.cse_suppressed = cse_suppressed or []
        self.engine_tier = engine_tier
        self.fitstats_tier = fitstats_tier
        self.transform_tier = transform_tier
        self.aggregate_tier = aggregate_tier
        self.link_mbps = link_mbps
        self.link_source = link_source
        self._tier_findings = tier_findings or []
        self._db_finding = db_finding

    def counts(self) -> Dict[str, Any]:
        tiers: Dict[str, int] = {}
        for e in self.entries:
            tiers[e.tier] = tiers.get(e.tier, 0) + 1
        return {
            "stages": len(self.entries),
            "tiers": {k: tiers[k] for k in sorted(tiers)},
            "prunedColumns": int(sum(
                self.widths[uid] - len(idx)
                for uid, idx in self.prune.items())),
            "cseMerges": len(self.cse),
            "engineTier": self.engine_tier,
        }

    def to_json(self) -> Dict[str, Any]:
        """Stable JSON form (the ``plan`` block of metrics documents)."""
        pruned = {}
        for uid, idx in sorted(self.prune.items()):
            live = {int(i) for i in idx}
            pruned[uid] = {"width": int(self.widths[uid]),
                           "dead": [j for j in range(self.widths[uid])
                                    if j not in live]}
        return {
            "version": 1,
            "link": {"mbps": round(self.link_mbps, 1),
                     "source": self.link_source},
            "tiers": {"engine": self.engine_tier,
                      "fitstats": self.fitstats_tier,
                      "transform": self.transform_tier,
                      "aggregate": self.aggregate_tier},
            "stages": [e.to_json() for e in self.entries],
            "prunedColumns": pruned,
            "cse": self.cse,
            "cseSuppressed": self.cse_suppressed,
            "counts": self.counts(),
        }

    def report(self) -> str:
        """The plan explained: one deterministic text document (the tier
        table, then the pruned columns and the CSE merges), for diffing
        across planner or cost-database changes."""
        from .utils.table import Table
        c = self.counts()
        head = (f"ExecutionPlan: {c['stages']} stage(s) "
                + " ".join(f"{k}={v}" for k, v in c["tiers"].items())
                + f" | engine tier: {self.engine_tier or 'unplanned'}"
                + f" | link {self.link_mbps:.1f} MB/s ({self.link_source})")
        rows = []
        for e in self.entries:
            rows.append([
                e.stage, e.uid, e.kind, e.tier,
                "" if e.est_host_s_per_krow is None
                else f"{e.est_host_s_per_krow:.6f}",
                "" if e.est_device_s_per_krow is None
                else f"{e.est_device_s_per_krow:.6f}",
                "" if e.measured_s_per_krow is None
                else f"{e.measured_s_per_krow:.6f}",
                e.source, e.reason])
        parts = [head, Table(
            ["stage", "uid", "kind", "tier", "est host s/krow",
             "est device s/krow", "measured s/krow", "source", "reason"],
            rows, name="Stage tiers").render()]
        if self.prune:
            lines = ["Pruned dead columns "
                     f"({c['prunedColumns']} total):"]
            for uid, idx in sorted(self.prune.items()):
                dead = self.widths[uid] - len(idx)
                lines.append(f"  {uid}: {dead} of {self.widths[uid]} "
                             "column(s) never reach a sink")
            parts.append("\n".join(lines))
        if self.cse:
            lines = [f"CSE merges ({len(self.cse)}):"]
            for m in self.cse:
                lines.append(f"  {m['stage']}: keep {m['kept']}, alias "
                             + ", ".join(m["dropped"]))
            parts.append("\n".join(lines))
        if self.cse_suppressed:
            lines = [f"CSE suppressed ({len(self.cse_suppressed)}):"]
            for m in self.cse_suppressed:
                lines.append(f"  {m['stage']}: {m['reason']}")
            parts.append("\n".join(lines))
        return "\n\n".join(parts) + "\n"

    def findings(self) -> List[Any]:
        """The TMG4xx findings: tier contradictions (TMG401), dead
        columns (TMG402), suppressed CSE (TMG403), a corrupt database
        (TMG404)."""
        from .lint import Finding
        out: List[Finding] = list(self._tier_findings)
        for uid, idx in sorted(self.prune.items()):
            dead = self.widths[uid] - len(idx)
            out.append(Finding(
                "TMG402", f"{dead} of {self.widths[uid]} output "
                "column(s) are dead: dropped by a downstream selector "
                "before any sink — the planner prunes them from the "
                "device program", stage=uid))
        for m in self.cse_suppressed:
            out.append(Finding(
                "TMG403", f"{m['stage']}: structurally identical stages "
                f"({', '.join(m['uids'])}) cannot merge — {m['reason']}",
                stage=m["uids"][0]))
        if self._db_finding is not None:
            out.append(self._db_finding)
        return out


# ---------------------------------------------------------------------------
# liveness (dead-column pruning) over the fused plan
# ---------------------------------------------------------------------------

#: liveness sentinel: every column live (distinct from a missing entry,
#: which means no fused consumer needs the output at all)
_ALL = object()


def _union(a, b):
    if a is _ALL or b is _ALL:
        return _ALL
    return a | b


def _device_liveness(plan_items, result_names: Sequence[str]
                     ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Column liveness per fused output name, propagated from the sinks
    backward over the engine's ``_FusedStage`` records (producers
    first): ``(live, widths)``, ``live[name]`` a set of live column
    indices or ``_ALL``, ``widths[name]`` the known column count."""
    widths: Dict[str, int] = {}
    for it in plan_items:
        if it.kind == "vec":
            widths[it.out] = it.model.vector_metadata().size
        elif it.kind == "combine":
            ins = [widths.get(nm) for nm in it.ins]
            widths[it.out] = (sum(ins)            # type: ignore[arg-type]
                              if all(w is not None for w in ins) else None)
        elif it.kind == "select":
            widths[it.out] = len(it.model.keep_indices)
        elif it.kind == "scale":
            widths[it.out] = widths.get(it.ins[0])

    live: Dict[str, Any] = {nm: _ALL for nm in result_names}
    for it in reversed(plan_items):
        ol = live.get(it.out, _ALL if it.out in result_names else None)
        if ol is None:
            # no fused consumer and not a result
            continue
        if it.kind == "select":
            keep = list(it.model.keep_indices)
            contrib = (set(int(k) for k in keep) if ol is _ALL
                       else {int(keep[i]) for i in ol})
            live[it.ins[0]] = _union(live.get(it.ins[0], set()), contrib)
        elif it.kind == "scale":
            live[it.ins[0]] = _union(live.get(it.ins[0], set()), ol)
        elif it.kind == "combine":
            if any(widths.get(nm) is None for nm in it.ins):
                # an input of unknown width poisons every offset after
                # it: every input stays fully live
                for nm in it.ins:
                    live[nm] = _ALL
                continue
            off = 0
            for nm in it.ins:
                w = widths[nm]
                if ol is _ALL:
                    contrib: Any = _ALL
                else:
                    contrib = {j - off for j in ol if off <= j < off + w}
                live[nm] = _union(live.get(nm, set()), contrib)
                off += w
        elif it.kind in ("predict", "deindex"):
            for nm in it.ins:
                live[nm] = _ALL
        # vec: no fused inputs to propagate into
    return live, {k: v for k, v in widths.items() if v is not None}


# ---------------------------------------------------------------------------
# CSE over stages
# ---------------------------------------------------------------------------


def _get_params(stage) -> Optional[Dict[str, Any]]:
    """The stage's constructor params, or None for a stage that has none
    to give (such a stage never merges)."""
    try:
        return dict(stage.get_params())
    except (AttributeError, NotImplementedError, RuntimeError, TypeError):
        return None


def _params_signature(stage) -> Tuple:
    """Stable, uid-free signature of a stage's constructor params."""
    params = _get_params(stage)
    if params is None:
        return ("<unparamable>", id(stage))
    params.pop("uid", None)
    return tuple(sorted((k, repr(v)) for k, v in params.items()))


def _uid_sensitive_keys(a_params: Dict[str, Any],
                        b_params: Dict[str, Any]) -> List[str]:
    """Keys whose values differ between two otherwise identical stages
    and look uid-like (the TMG403 evidence)."""
    from .utils import uid as uid_mod
    keys = []
    for k in sorted(set(a_params) | set(b_params)):
        if k == "uid":
            continue
        va, vb = a_params.get(k), b_params.get(k)
        if va == vb:
            continue
        for v in (va, vb):
            try:
                uid_mod.parse_uid(str(v))
            except ValueError:
                continue
            keys.append(k)
            break
    return keys


def _state_equal(a, b) -> bool:
    """Bit-identical fitted state (numpy- and tensor-aware deep
    compare)."""
    import torch
    try:
        sa, sb = a.get_model_state(), b.get_model_state()
    except (AttributeError, NotImplementedError):
        return False

    def eq(x, y) -> bool:
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu").numpy()
        if isinstance(y, torch.Tensor):
            y = y.detach().to("cpu").numpy()
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            return (x.shape == y.shape and x.dtype == y.dtype
                    and bool(np.array_equal(x, y)))
        if isinstance(x, dict) and isinstance(y, dict):
            return (sorted(x) == sorted(y)
                    and all(eq(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            return (len(x) == len(y)
                    and all(eq(p, q) for p, q in zip(x, y)))
        return bool(x == y)

    return eq(sa, sb)


def _cse_pass(vec_items) -> Tuple[List[Dict[str, Any]],
                                  List[Dict[str, Any]]]:
    """Group structurally identical fused vectorizers: ``(merges,
    suppressed)``. Merges are verified (class, input features, params and
    fitted state identical, so aliasing is bitwise by construction);
    ``suppressed`` lists structural twins whose merge a uid-like param or
    a state mismatch blocks."""
    groups: Dict[Tuple, List[Any]] = {}
    for it in vec_items:
        m = it.model
        key = (type(m).__name__,
               tuple(f.name for f in m.input_features),
               _params_signature(m))
        groups.setdefault(key, []).append(it)

    merges: List[Dict[str, Any]] = []
    suppressed: List[Dict[str, Any]] = []
    for key, items in sorted(groups.items(),
                             key=lambda kv: kv[1][0].model.uid):
        if len(items) < 2:
            continue
        kept = items[0]
        ok, bad = [kept], []
        for it in items[1:]:
            (ok if _state_equal(kept.model, it.model) else bad).append(it)
        if len(ok) > 1:
            merges.append({"stage": key[0], "kept": kept.model.uid,
                           "dropped": [it.model.uid for it in ok[1:]]})
        if bad:
            suppressed.append({
                "stage": key[0],
                "uids": [kept.model.uid] + [it.model.uid for it in bad],
                "reason": "fitted state differs despite identical "
                          "params/inputs (uid-seeded or data-order-"
                          "sensitive fit)"})

    # near misses: same class and inputs, params differing only in
    # uid-like values
    by_shape: Dict[Tuple, List[Any]] = {}
    for it in vec_items:
        m = it.model
        by_shape.setdefault(
            (type(m).__name__, tuple(f.name for f in m.input_features)),
            []).append(it)
    for (cls, _ins), items in sorted(by_shape.items()):
        if len(items) < 2:
            continue
        # one representative per distinct signature, so the comparison
        # crosses the signature boundary
        by_sig: Dict[Tuple, Any] = {}
        for it in items:
            by_sig.setdefault(_params_signature(it.model), it)
        if len(by_sig) < 2:
            continue            # identical params: handled above
        reps = list(by_sig.values())
        a_params = _get_params(reps[0].model)
        b_params = _get_params(reps[1].model)
        if a_params is None or b_params is None:
            continue
        keys = _uid_sensitive_keys(a_params, b_params)
        if keys:
            suppressed.append({
                "stage": cls, "uids": sorted(m.model.uid for m in items),
                "reason": f"params {keys} carry uid-like values — make "
                "them uid-independent to unlock the merge"})
    return merges, suppressed


# ---------------------------------------------------------------------------
# tier assignment
# ---------------------------------------------------------------------------


def _resolve_link(db: Optional[CostDatabase]) -> Tuple[float, str]:
    """The link rate the plan reasons with; never probes a device: the
    database's measurement, else :data:`LINK_PRIOR_MBPS`."""
    if db is not None:
        mbps = db.bandwidth_mbps()
        if mbps:
            return mbps, "measured"
    return LINK_PRIOR_MBPS, "prior"


def _stage_bytes_per_row(model, kind: str, store, widths: Dict[str, int]
                         ) -> float:
    """A stage's bytes a row, the static cost model's input: a
    vectorizer's canonical prepared blocks on the synthetic store plus
    its f32 output; the structural kinds their f32 width."""
    if kind == "vec":
        from .ops.vectorizer_base import canonicalize_prepared
        n = store.n_rows
        try:
            prep = canonicalize_prepared(model.host_prepare(store))
        except Exception:  # lint: broad-except — unpreparable stage: width-based fallback estimate
            return 4.0 * model.vector_metadata().size
        total = 0.0
        for v in prep.values():
            a = np.asarray(v)
            if a.ndim and a.shape[0] == n:
                total += a.nbytes / n
        return total + 4.0 * model.vector_metadata().size
    w = widths.get(getattr(model, "output_name", ""), 0) or 0
    return 4.0 * float(w)


def _entry_for(model, kind: Optional[str], fused: bool, store,
               widths: Dict[str, int], db: Optional[CostDatabase],
               link_mbps: float):
    """One stage's PlanEntry, its (host, device) cost pair and its
    TMG401 finding (or None)."""
    from .lint import Finding, _stage_label
    name = type(model).__name__
    label = _stage_label(model)
    if kind is None:
        measured = db.stage_cost(name, "host") if db else None
        return PlanEntry(
            uid=model.uid, stage=name, kind="host", tier="host",
            reason="no device form (host-only stage)",
            measured_s_per_krow=measured,
            source="measured" if measured is not None else "static",
        ), None, None
    bpr = _stage_bytes_per_row(model, kind, store, widths)
    est_host = round(1000.0 * bpr / (STATIC_HOST_GBPS * 1e9), 6)
    est_dev = round(1000.0 * bpr * (1.0 / (link_mbps * 1e6)
                                    + 1.0 / (STATIC_DEVICE_GBPS * 1e9)), 6)
    # per-class host and device transform costs come from outside (a
    # bench or an operator): a fused program's per-stage device time is
    # not separable, so nothing records them automatically
    m_host = db.stage_cost(name, "host") if db else None
    m_dev = db.stage_cost(name, "device") if db else None
    if not fused:
        return PlanEntry(
            uid=model.uid, stage=name, kind=kind, tier="host",
            reason="demoted: a host-only stage consumes its output",
            est_host_s_per_krow=est_host, est_device_s_per_krow=est_dev,
            measured_s_per_krow=m_host,
            source="measured" if m_host is not None else "static",
        ), None, None
    src = "measured" if (m_host is not None and m_dev is not None) \
        else "static"
    finding = None
    if m_host is not None and m_dev is not None and m_dev > m_host:
        finding = Finding(
            "TMG401", f"{label} measured slower on device "
            f"({m_dev:.6f} s/krow) than host ({m_host:.6f} s/krow) but "
            "is pinned to the fused device program by its consumers — "
            "consider demoting the chain", stage=model.uid)
    return PlanEntry(
        uid=model.uid, stage=name, kind=kind, tier="fused",
        reason=("measured costs favor the fused device program"
                if src == "measured" and (m_dev or 0) <= (m_host or 0)
                else "consumer-closed device-capable chain"),
        est_host_s_per_krow=est_host, est_device_s_per_krow=est_dev,
        measured_s_per_krow=m_dev, source=src,
    ), (m_host if m_host is not None else est_host,
        m_dev if m_dev is not None else est_dev), finding


def _engine_tier(host_total: float, dev_total: float,
                 db: Optional[CostDatabase], link_source: str
                 ) -> Tuple[Optional[str], str]:
    """The whole chain's tier: measured chain costs decide where present,
    else the per-stage totals over a measured link; with priors alone it
    is None and the engine runs as it does unplanned."""
    if db is not None:
        ch_h, ch_e = db.chain_cost("host"), db.chain_cost("engine")
        if ch_h is not None and ch_e is not None:
            return (("device" if ch_e <= ch_h else "host"),
                    "measured whole-chain scoring costs")
    if link_source == "measured":
        return (("device" if dev_total <= host_total else "host"),
                "static per-stage estimates over the measured link")
    return None, "priors only (the engine runs unplanned)"


def _host_transforms(store, host_layers):
    """The synthetic store advanced through the host stages (on the CPU),
    so ``host_prepare`` sees typed, empty-default inputs. A host stage
    with no static form only degrades its own byte estimate."""
    import torch

    from .workflow import _device_kw
    cpu = torch.device("cpu")
    for layer in host_layers:
        for m in layer:
            try:
                store = m.transform(store, **_device_kw(m, cpu))
            except Exception:  # lint: broad-except — a host stage without a static form only degrades its own byte estimate
                logger.debug("planner: host stage %s has no static form",
                             m.uid)
    return store


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def plan_model(model, cost_db: Optional[CostDatabase] = None,
               n_rows: int = 8) -> ExecutionPlan:
    """The execution plan of a fitted ``WorkflowModel``: static (host
    stages and ``host_prepare`` run on ``lint.py``'s synthetic store of
    ``n_rows`` rows on the CPU, nothing runs on a device), the link rate
    from the cost database or the prior."""
    from .lint import _synthetic_store
    from .scoring import _classify, build_fused_plan

    layers = model._resolved_dag()
    plan_items, host_layers = build_fused_plan(layers)
    result_names = [f.name for f in model.result_features]
    store = _host_transforms(
        _synthetic_store(model.result_features, n_rows), host_layers)

    live, widths_by_name = _device_liveness(plan_items, result_names)
    prune: Dict[str, np.ndarray] = {}
    prune_widths: Dict[str, int] = {}
    for it in plan_items:
        if it.kind != "vec":
            continue
        lv = live.get(it.out)
        w = widths_by_name.get(it.out)
        if lv is _ALL or lv is None or w is None:
            continue
        if len(lv) < w:
            prune[it.model.uid] = np.asarray(sorted(int(j) for j in lv),
                                             dtype=np.int64)
            prune_widths[it.model.uid] = int(w)

    merges, suppressed = _cse_pass(
        [it for it in plan_items if it.kind == "vec"])

    link_mbps, link_source = _resolve_link(cost_db)
    fused_uids = {it.model.uid for it in plan_items}
    entries: List[PlanEntry] = []
    tier_findings: List[Any] = []
    host_total = dev_total = 0.0
    for layer in layers:
        for m in layer:
            entry, costs, finding = _entry_for(
                m, _classify(m), m.uid in fused_uids, store,
                widths_by_name, cost_db, link_mbps)
            entries.append(entry)
            if costs is not None:
                host_total += costs[0]
                dev_total += costs[1]
            if finding is not None:
                tier_findings.append(finding)
    engine_tier, tier_reason = _engine_tier(host_total, dev_total,
                                            cost_db, link_source)

    plan = ExecutionPlan(
        entries, prune=prune, widths=prune_widths, cse=merges,
        cse_suppressed=suppressed, engine_tier=engine_tier,
        fitstats_tier=_phase_tier(cost_db, "fitstats"),
        transform_tier=_phase_tier(cost_db, "transform"),
        aggregate_tier=aggregate_route_tier(cost_db),
        link_mbps=link_mbps, link_source=link_source,
        tier_findings=tier_findings,
        db_finding=cost_db.finding() if cost_db is not None else None)
    logger.info("planner: %d stage(s), engine tier %s (%s), %d pruned "
                "column(s), %d CSE merge(s)", len(entries),
                engine_tier or "unplanned", tier_reason,
                plan.counts()["prunedColumns"], len(merges))
    _record_tallies(plan)
    telemetry.emit("plan", stages=len(entries), engine_tier=engine_tier,
                   pruned_columns=plan.counts()["prunedColumns"],
                   cse_merges=len(merges))
    return plan


def plan_workflow(workflow, cost_db: Optional[CostDatabase] = None
                  ) -> ExecutionPlan:
    """The plan of an untrained ``Workflow``: the graph only. Fitted state
    (the SanityChecker's keep indices, model weights) does not exist yet,
    so pruning and verified CSE wait for the model's plan; the stages'
    measured fit costs and the fit-phase tiers, which ``Workflow.train``
    follows, are available now."""
    from .graph import compute_dag
    link_mbps, link_source = _resolve_link(cost_db)
    entries: List[PlanEntry] = []
    for layer in compute_dag(workflow.result_features):
        for st in layer:
            # fit costs are recorded under stage_name() (the
            # stage_metrics key): look them up the same way
            name = st.stage_name()
            measured = (cost_db.stage_cost(name, "fit")
                        if cost_db is not None else None)
            entries.append(PlanEntry(
                uid=st.uid, stage=name, kind="estimator"
                if hasattr(st, "fit_columns") else "host", tier="host",
                reason="fit-path stage (tier decided per phase)",
                measured_s_per_krow=measured,
                source="measured" if measured is not None else "static"))
    plan = ExecutionPlan(
        entries, engine_tier=None,
        fitstats_tier=_phase_tier(cost_db, "fitstats"),
        transform_tier=_phase_tier(cost_db, "transform"),
        aggregate_tier=aggregate_route_tier(cost_db),
        link_mbps=link_mbps, link_source=link_source,
        db_finding=cost_db.finding() if cost_db is not None else None)
    _record_tallies(plan)
    telemetry.emit("plan", stages=len(entries), engine_tier=None,
                   pruned_columns=0, cse_merges=0)
    return plan


def _measured_tier(db: Optional[CostDatabase], phase: str,
                   a: str, b: str) -> Optional[str]:
    """``a`` or ``b``, whichever was measured cheaper for ``phase``; None
    unless both were measured."""
    if db is None:
        return None
    ca = db.stage_cost(f"phase:{phase}", a)
    cb = db.stage_cost(f"phase:{phase}", b)
    if ca is None or cb is None:
        return None
    return a if ca <= cb else b


def _phase_tier(db: Optional[CostDatabase], phase: str) -> Optional[str]:
    """The measured tier of a fit phase (``fitstats``: the statistics
    pass; ``transform``: the layer transform): "device" or "host" when
    both were measured, else None (the row-floor and card gate
    decides)."""
    return _measured_tier(db, phase, "device", "host")


def aggregate_route_tier(db: Optional[CostDatabase]) -> Optional[str]:
    """The measured columnar-against-row-wise tier of the temporal
    aggregation route (``phase:temporal.route_aggregate``, fed by
    ``temporal.route_aggregate`` and ``tally_rowwise``). The runner
    installs it with ``temporal.set_aggregate_tier_hint``, so the
    ``"auto"`` route defers to it; None leaves the structural route
    (columnar when the source is columnar) in charge."""
    return _measured_tier(db, "temporal.route_aggregate", "columnar",
                          "rowwise")


def ingest_route_tier(db: Optional[CostDatabase]) -> Optional[str]:
    """The measured stream-against-materialize tier of the workflow's
    raw-store ingest (``phase:workflow.ingest``): "stream" or
    "materialize" when both were measured, else None; the streamed fit's
    auto mode follows it (``workflow.set_stream_fit(ingest_hint=)``)."""
    return _measured_tier(db, "workflow.ingest", "stream", "materialize")


def _record_tallies(plan: ExecutionPlan) -> None:
    c = plan.counts()
    _tally("plans_built")
    _tally("cse_merges", c["cseMerges"])
    _tally("pruned_columns", c["prunedColumns"])
    _tally("stages_fused", c["tiers"].get("fused", 0))
    _tally("stages_host", c["tiers"].get("host", 0))
