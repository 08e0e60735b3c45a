"""Offline autotuner — whole-program measurement over the declared knob
space, on the card.

Counterpart of ``transmogrifai_tpu/tuner.py``.
``python -m transmogrifai_tpu_torch tune params.json --workload <dir>``
searches the registry-declared tunable knobs (:func:`config.tunable_knobs`)
by coordinate descent: for each candidate config it boots a server (or a
fleet, when the params ask for workers) from that config on the device
the caller names (the card unless ``device="cpu"``), re-drives the merged
recorded workload through the replay harness
(:func:`workload.replay_workload`) at its recorded arrival offsets, and
scores the leg on client e2e p99 or replayed rows/s. A leg pays queueing,
coalescing, dispatch and scatter as serving does.

Correctness is a gate, not a score: a candidate whose replayed outputs
drift from the recording past ``parity_tol``, or that fails requests, is
rejected and never ranked. The search is seeded from the persisted
:class:`planner.CostDatabase`'s measured phase costs where it has them,
bounded by each knob's declared ``tune_lo`` / ``tune_hi``, and stops when
the wall-clock budget expires; the incumbent so far wins, so the emitted
config never loses to the baseline on the measured objective.

Outputs: a validated ``params.tuned.json`` (the baseline params with the
winning knob values overlaid) and a byte-stable tuning report (winner,
per-knob sensitivity, every leg measured; sorted keys, fixed rounding,
a blake2b content digest). For the same measurements the report and the
tuned params are byte-equal to the JAX package's.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from . import config

logger = logging.getLogger(__name__)

__all__ = ["run_tune", "tune", "tuner_stats", "reset_tuner_stats",
           "TunerError"]

#: probe multipliers one coordinate-descent pass tries around the
#: incumbent value of a knob (ints are rounded)
_PROBE_FACTORS = (0.25, 0.5, 2.0, 4.0)

#: coordinate-descent passes over the knob list before the search stops
#: (a pass with no improvement stops it earlier)
_MAX_PASSES = 3

#: relative objective improvement a candidate must show to replace the
#: incumbent, so measurement noise does not pass for a win
_MIN_IMPROVEMENT = 0.02


# ---------------------------------------------------------------------------
# always-on tallies
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"searches": 0, "legs_replayed": 0, "legs_failed_boot": 0,
          "candidates_evaluated": 0, "candidates_rejected_parity": 0,
          "candidates_improved": 0, "knobs_searched": 0,
          "budget_expirations": 0, "prior_seeds": 0}


def tuner_stats() -> Dict[str, Any]:
    """Process-wide tuner tallies (always on): searches run, legs
    replayed, parity rejections, incumbent improvements."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_tuner_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


class TunerError(Exception):
    """Tuner misuse: no tunable knobs, an unusable workload, bad params."""


# ---------------------------------------------------------------------------
# candidate legs: boot, replay, score
# ---------------------------------------------------------------------------

def _objective_score(replay: Dict[str, Any],
                     objective: str) -> Optional[float]:
    """One leg's scalar score, lower is better for both objectives
    (throughput is negated), so the search minimizes. None when the leg
    measured nothing."""
    if objective == "throughput":
        rows = sum(int(m.get("rows", 0))
                   for m in (replay.get("models") or {}).values())
        dur = float(replay.get("durationS") or 0.0)
        return -(rows / dur) if rows and dur > 0 else None
    e2e = (replay.get("client") or {}).get("e2e") or {}
    p99 = e2e.get("p99Ms")
    return float(p99) if p99 is not None else None


def _apply_candidate(base_doc: Dict[str, Any],
                     values: Dict[str, Any]) -> Dict[str, Any]:
    doc = json.loads(json.dumps(base_doc))    # a deep, JSON-safe copy
    cp = dict(doc.get("customParams") or {})
    cp.update(values)
    doc["customParams"] = cp
    return doc


def _boot_and_replay(params_doc: Dict[str, Any],
                     workload_doc: Dict[str, Any], *, speed: float,
                     parity_tol: float, timeout_s: float,
                     duration_s: Optional[float],
                     max_requests: Optional[int], use_fleet: bool,
                     device: Optional[str] = None) -> Dict[str, Any]:
    """One measured leg: boot a server (or a fleet whose workers run
    ``serve --device <device>``) from the candidate params on ``device``
    (None: the card), replay the recorded workload against it, shut it
    down. Raises on a boot failure; replay errors are in the result."""
    from . import workload as workload_mod
    from .runner import OpParams, _numeric_custom_param

    with tempfile.TemporaryDirectory(prefix="tmog_tune_") as tmp:
        cand_path = os.path.join(tmp, "candidate.params.json")
        with open(cand_path, "w") as fh:
            json.dump(params_doc, fh, indent=1, sort_keys=True)
        params = OpParams.from_file(cand_path)
        if use_fleet:
            from . import fleet as fleet_mod
            n = _numeric_custom_param(params, "fleetWorkers",
                                      fleet_mod.DEFAULT_WORKERS)
            sup = fleet_mod.FleetSupervisor(cand_path, workers=n,
                                            probe_interval_s=0.1,
                                            device=device or "cuda")
            sup.start()
            httpd = fleet_mod.serve_fleet_http(sup, port=0)
            try:
                host, port = httpd.server_address[:2]
                return workload_mod.replay_workload(
                    workload_doc, f"http://{host}:{port}", speed=speed,
                    timeout_s=timeout_s, parity_tol=parity_tol,
                    duration_s=duration_s, max_requests=max_requests)
            finally:
                httpd.shutdown()
                sup.stop(drain=True)
        from . import server as server_mod
        from .cli import build_server_from_params
        srv = build_server_from_params(params, device=device)
        httpd = server_mod.serve_http(srv, port=0)
        try:
            host, port = httpd.server_address[:2]
            return workload_mod.replay_workload(
                workload_doc, f"http://{host}:{port}", speed=speed,
                timeout_s=timeout_s, parity_tol=parity_tol,
                duration_s=duration_s, max_requests=max_requests)
        finally:
            srv.shutdown(drain=True)
            httpd.shutdown()


# ---------------------------------------------------------------------------
# priors: seed the search from the persisted CostDatabase
# ---------------------------------------------------------------------------

def _prior_seeds(params, knob_names: List[str]) -> Dict[str, Any]:
    """Measured-cost seeds for the first incumbent: where the persisted
    CostDatabase has scored-transform phase costs, start
    ``serveBatchDeadlineMs`` near the measured cost of a ~32-row
    micro-batch (a hold much longer than the work it amortizes only adds
    latency; much shorter coalesces nothing). Knobs without a usable prior
    keep their baseline or default value."""
    from . import planner
    from .runner import OpWorkflowRunner
    seeds: Dict[str, Any] = {}
    try:
        db_path = OpWorkflowRunner._cost_db_path(params)
        if not db_path:
            return seeds
        db = planner.CostDatabase.load(db_path)
    except Exception:  # lint: broad-except — priors are an optimization, never a dependency
        return seeds
    if "serveBatchDeadlineMs" in knob_names:
        per_krow = (db.stage_cost("phase:transform", "device")
                    or db.stage_cost("phase:transform", "host"))
        if per_krow:
            lo, hi = config.knob_bounds("serveBatchDeadlineMs")
            # s / 1,000 rows -> ms for a ~32-row micro-batch's work
            seed = per_krow * 1e3 * 32 / 1000.0
            seeds["serveBatchDeadlineMs"] = round(
                min(max(seed, lo), hi if hi != float("inf") else seed), 4)
            _tally("prior_seeds")
    return seeds


# ---------------------------------------------------------------------------
# coordinate descent
# ---------------------------------------------------------------------------

def _probe_values(k: config.Knob, cur: Any) -> List[Any]:
    """The values one pass tries for knob ``k`` around ``cur``: the
    probe factors and the declared edges, inside the bounds, rounded to
    the knob's type, without ``cur`` itself or repeats."""
    lo, hi = config.knob_bounds(k.name)
    if cur is None:
        cur = k.default
    if cur is None:
        cur = lo if lo != float("-inf") else 1.0
    cur = float(cur)
    vals: List[float] = []
    for f in _PROBE_FACTORS:
        v = cur * f if cur > 0 else (f - 1.0)
        v = min(max(v, lo), hi if hi != float("inf") else v)
        vals.append(v)
    # the declared edges of the space too
    if lo != float("-inf"):
        vals.append(lo)
    if hi != float("inf"):
        vals.append(hi)
    out: List[Any] = []
    for v in vals:
        v = int(round(v)) if k.type == "int" else round(float(v), 4)
        if v != (int(cur) if k.type == "int" else round(cur, 4)) \
                and v not in out:
            out.append(v)
    return out


def tune(params_path: str, workload_doc: Dict[str, Any], *,
         objective: str = "p99", budget_s: float = 120.0,
         knobs: Optional[List[str]] = None, speed: float = 1.0,
         parity_tol: float = 1e-4, timeout_s: float = 30.0,
         duration_s: Optional[float] = None,
         max_requests: Optional[int] = None,
         use_fleet: Optional[bool] = None,
         device: Optional[str] = None) -> Dict[str, Any]:
    """Run the search; returns ``{"tunedParams", "report"}``. Every leg
    boots on ``device`` (None: the card).

    The baseline config is always the first leg measured and the first
    incumbent: a candidate replaces it only by beating it on the replayed
    objective by the noise floor, with score parity held, so the emitted
    config beats or matches the baseline by construction."""
    from .runner import OpParams

    if objective not in ("p99", "throughput"):
        raise TunerError(f"objective must be 'p99' or 'throughput', "
                         f"got {objective!r}")
    with open(params_path) as fh:
        base_doc = json.load(fh)
    params = OpParams.from_file(params_path)
    errors = config.check_custom_params(params.custom_params)
    if errors:
        raise TunerError(
            "baseline params invalid: "
            + "; ".join(msg for _k, msg in errors))

    tunable = {k.name: k for k in config.tunable_knobs()}
    if knobs:
        unknown = [n for n in knobs if n not in tunable]
        if unknown:
            raise TunerError(
                f"not tunable (declared tunable knobs: "
                f"{sorted(tunable)}): {unknown}")
        search = [tunable[n] for n in knobs]
    else:
        search = list(tunable.values())
    if not search:
        raise TunerError("no tunable knobs declared in the registry")
    if use_fleet is None:
        use_fleet = bool(
            (params.custom_params.get("fleetWorkers") or 0))  # lint: knob — presence probe decides boot topology
    _tally("searches")
    _tally("knobs_searched", len(search))

    t0 = time.monotonic()
    deadline = t0 + float(budget_s)
    legs: List[Dict[str, Any]] = []
    sensitivity: Dict[str, Dict[str, Any]] = {}

    def _leg(values: Dict[str, Any], label: str) -> Optional[float]:
        """Measure one candidate; its score, or None when the leg was
        rejected (parity, failures) or could not boot."""
        doc = _apply_candidate(base_doc, values)
        cp = doc["customParams"]
        bad = config.check_custom_params(cp)
        if bad:   # a candidate off the declared surface is a bug
            raise TunerError(f"candidate invalid: {bad}")
        _tally("candidates_evaluated")
        try:
            replay = _boot_and_replay(
                doc, workload_doc, speed=speed, parity_tol=parity_tol,
                timeout_s=timeout_s, duration_s=duration_s,
                max_requests=max_requests, use_fleet=use_fleet,
                device=device)
        except Exception as e:  # lint: broad-except — a candidate that cannot boot is rejected, not fatal
            logger.warning("tune: leg %s failed to boot/replay: %r",
                           label, e)
            _tally("legs_failed_boot")
            legs.append({"label": label, "values": values,
                         "rejected": "boot/replay error",
                         "error": repr(e)[:200]})
            return None
        _tally("legs_replayed")
        score = _objective_score(replay, objective)
        rejected = None
        if replay.get("parityFailures"):
            rejected = "score parity"
            _tally("candidates_rejected_parity")
        elif replay.get("failed"):
            rejected = "failed requests"
        elif score is None:
            rejected = "nothing measured"
        legs.append({
            "label": label, "values": values,
            "score": None if score is None else round(score, 4),
            "rejected": rejected,
            "sent": replay.get("sent"),
            "failed": replay.get("failed"),
            "lateSends": replay.get("lateSends"),
            "parityChecked": replay.get("parityChecked"),
            "parityFailures": replay.get("parityFailures"),
            "p99Ms": ((replay.get("client") or {}).get("e2e") or {})
            .get("p99Ms")})
        return None if rejected else score

    # -- leg 0: the baseline is the first incumbent ------------------------
    incumbent: Dict[str, Any] = {}
    base_score = _leg({}, "baseline")
    if base_score is None:
        raise TunerError(
            "baseline config failed its replay leg (parity/failures) "
            "— fix the recording or the params before tuning")
    best_score = base_score

    # -- priors seed one candidate before the descent ----------------------
    seeds = _prior_seeds(params, [k.name for k in search])
    seeds = {n: v for n, v in seeds.items()
             if v != (base_doc.get("customParams") or {}).get(n)}
    if seeds and time.monotonic() < deadline:
        s = _leg(dict(seeds), "prior-seed")
        if s is not None and s < best_score * (1 - _MIN_IMPROVEMENT):
            incumbent, best_score = dict(seeds), s
            _tally("candidates_improved")

    # -- coordinate descent over the declared bounds -----------------------
    expired = False
    for pass_i in range(_MAX_PASSES):
        improved = False
        for k in search:
            cur = incumbent.get(
                k.name,
                (base_doc.get("customParams") or {}).get(k.name,
                                                         k.default))
            scores_this_knob: List[float] = []
            for v in _probe_values(k, cur):
                if time.monotonic() >= deadline:
                    expired = True
                    break
                cand = dict(incumbent)
                cand[k.name] = v
                s = _leg(cand, f"pass{pass_i}:{k.name}={v}")
                if s is None:
                    continue
                scores_this_knob.append(s)
                if s < best_score * (1 - _MIN_IMPROVEMENT):
                    incumbent, best_score = cand, s
                    improved = True
                    _tally("candidates_improved")
            sens = sensitivity.setdefault(
                k.name, {"legs": 0, "bestScore": None,
                         "worstScore": None})
            sens["legs"] += len(scores_this_knob)
            if scores_this_knob:
                lo_s = min(scores_this_knob + (
                    [sens["bestScore"]] if sens["bestScore"] is not None
                    else []))
                hi_s = max(scores_this_knob + (
                    [sens["worstScore"]]
                    if sens["worstScore"] is not None else []))
                sens["bestScore"] = round(lo_s, 4)
                sens["worstScore"] = round(hi_s, 4)
                sens["spread"] = round(hi_s - lo_s, 4)
            if expired:
                break
        if expired or not improved:
            break
    if expired:
        _tally("budget_expirations")

    tuned_doc = _apply_candidate(base_doc, incumbent)
    bad = config.check_custom_params(tuned_doc["customParams"])
    if bad:
        raise TunerError(f"tuned params failed validation: {bad}")

    report = {
        "objective": objective,
        "baselineScore": round(base_score, 4),
        "winnerScore": round(best_score, 4),
        "improvement": round(
            (base_score - best_score) / base_score, 4) if base_score
        else 0.0,
        "winner": {n: incumbent[n] for n in sorted(incumbent)},
        "searchedKnobs": sorted(k.name for k in search),
        "bounds": {k.name: [
            None if b in (float("inf"), float("-inf")) else b
            for b in config.knob_bounds(k.name)] for k in search},
        "sensitivity": {n: sensitivity[n]
                        for n in sorted(sensitivity)},
        "legs": legs,
        "legsMeasured": len(legs),
        "parityTol": parity_tol,
        "budgetExpired": expired,
        "fleet": bool(use_fleet),
    }
    # canonical serialization and a content digest: identical
    # measurements give identical bytes
    canonical = json.dumps(report, sort_keys=True,
                           separators=(",", ":"), default=str)
    report["digest"] = "blake2b:" + hashlib.blake2b(
        canonical.encode(), digest_size=16).hexdigest()
    return {"tunedParams": tuned_doc, "report": report}


# ---------------------------------------------------------------------------
# the command (``python -m transmogrifai_tpu_torch tune``)
# ---------------------------------------------------------------------------

def run_tune(params_path: str, workload: str,
             out: Optional[str] = None, budget_s: float = 120.0,
             objective: str = "p99", knobs: Optional[str] = None,
             report: Optional[str] = None, speed: float = 1.0,
             parity_tol: float = 1e-4,
             duration_s: Optional[float] = None,
             max_requests: Optional[int] = None,
             device: Optional[str] = None) -> int:
    """The ``tune`` subcommand: load (or merge) the recorded workload, run
    the search with every leg on ``device`` (None: the card), write
    ``params.tuned.json`` and the tuning report. Exit 0 when the winner
    beats or matches the baseline; 1 for a missing workload, bad params
    or a failed baseline."""
    import sys

    from . import workload as workload_mod

    try:
        if os.path.isdir(workload):
            doc = workload_mod.merge_workload_shards(workload)
        else:
            doc = workload_mod.load_workload(workload)
    except (OSError, ValueError) as e:
        print(f"tune: cannot load workload {workload!r}: {e}")
        return 1
    knob_list = ([n.strip() for n in knobs.split(",") if n.strip()]
                 if knobs else None)
    try:
        result = tune(params_path, doc, objective=objective,
                      budget_s=budget_s, knobs=knob_list, speed=speed,
                      parity_tol=parity_tol, duration_s=duration_s,
                      max_requests=max_requests, device=device)
    except (TunerError, OSError, ValueError) as e:
        print(f"tune: {e}", file=sys.stderr)
        return 1
    rep = result["report"]
    out = out or (os.path.splitext(params_path)[0] + ".tuned.json")
    report_path = report or (os.path.splitext(out)[0]
                             + ".tuning-report.json")
    for path, doc_out in ((out, result["tunedParams"]),
                          (report_path, rep)):
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc_out, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
    better = rep["winnerScore"] <= rep["baselineScore"]
    print(f"tune: {rep['legsMeasured']} leg(s) measured over "
          f"{len(rep['searchedKnobs'])} knob(s), objective "
          f"{objective}: baseline {rep['baselineScore']} -> winner "
          f"{rep['winnerScore']} "
          f"({rep['improvement'] * 100:.1f}% better)"
          + (" [budget expired]" if rep["budgetExpired"] else ""))
    if rep["winner"]:
        for n, v in rep["winner"].items():
            print(f"  {n} = {v}")
    else:
        print("  baseline config already optimal over the searched "
              "space — tuned file keeps it")
    print(f"tune: tuned params -> {out}")
    print(f"tune: report -> {report_path}")
    return 0 if better else 1
