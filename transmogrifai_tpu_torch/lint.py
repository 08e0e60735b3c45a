"""Pre-flight workflow checker: static type flow and device shape
analysis; the port of ``transmogrifai_tpu/lint.py``.

TransmogrifAI rejects a mis-wired workflow at compile time, before Spark
reads a byte. This module does the same before any data is read and
without launching anything on a device. The passes share one
:class:`Finding` vocabulary (rule id, severity, subject) and one rule
catalog, :data:`RULES`, whose ids mean the same in both packages:

* **The graph checker** (``check_workflow`` / ``check_model``, TMG1xx)
  walks the feature DAG by object identity and re-checks every stage's
  declared input contract against its wired features, plus duplicate
  stage and feature uids, cycles, dead stages, response leakage carried
  through intermediate stages, and estimators after a model. With a
  reader known, ``check_workflow`` adds the temporal cutoff-leakage
  rules (TMG7xx, ``temporal.check_temporal``), which inspect the reader
  object and never poll it.
* **The device pre-flight** (``preflight_device``, TMG2xx) runs the host
  stages for real on a synthetic store of a few rows (defaults only, no
  dataset) and propagates shapes through every ``VectorizerModel.
  device_compute`` and predictor ``predict_device`` on the ``meta``
  device: tensors with a shape and a dtype and no data, so nothing is
  uploaded and no kernel launches (``_hist.KERNEL_LAUNCHES`` is
  unchanged). It flags widths that disagree with the declared vector
  metadata, f64 outputs under the f32 vector pipeline, prepared blocks
  whose signature varies with the batch (a new program and CUDA graph per
  batch shape in the scoring engine), row dimensions that do not track
  the batch, and working sets past the device's memory.
* **The serving advisories** (TMG5xx) are raised by ``aot.py`` and
  ``serving.py``; the planner's (TMG4xx) by ``planner.py``.

:func:`enforce` raises :class:`LintError` for findings at or above a
severity (the runner's ``customParams.failOn``), and suppression lists
(``lintSuppress``) mute rule ids. :func:`emit_findings` logs the findings;
their mirror into telemetry (the ``lint.*`` counters and the ``on_lint``
hook) waits for ``telemetry.py`` (ROADMAP queue A, A6.8), and the repo
rules' linters (TMG3xx, TMG8xx) lint the JAX package's source tree; their
counterpart for this package's tree is an A6.8 item.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, List, Optional, Sequence, Set,
                    Tuple)

logger = logging.getLogger(__name__)

__all__ = [
    "Severity", "Finding", "LintError", "RULES",
    "check_workflow", "check_model", "preflight_device",
    "enforce", "emit_findings", "max_severity",
]


class Severity:
    """Finding severities, ordered by :data:`_SEVERITY_RANK`."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    ALL = (ERROR, WARNING, INFO)


_SEVERITY_RANK = {Severity.ERROR: 2, Severity.WARNING: 1, Severity.INFO: 0}


#: rule id → (default severity, what it flags). Ids never change meaning
#: and mean what they mean in the JAX package; a new rule gets a new id.
RULES: Dict[str, Tuple[str, str]] = {
    # -- TMG0xx: configuration rules (params files, CLI inputs) ------------
    "TMG001": (Severity.ERROR,
               "malformed configuration value (params file / customParams)"),
    # -- TMG1xx: graph rules (static type flow over the feature DAG) -------
    "TMG101": (Severity.ERROR,
               "input/output FeatureType incompatibility on a DAG edge"),
    "TMG102": (Severity.ERROR,
               "duplicate stage/feature uid (distinct objects collide)"),
    "TMG103": (Severity.ERROR, "cycle in the feature graph"),
    "TMG104": (Severity.WARNING,
               "orphan/dead stage unreachable from the result features"),
    "TMG105": (Severity.ERROR,
               "response leakage: label-derived feature reaches a "
               "predictor-side stage"),
    "TMG106": (Severity.ERROR,
               "estimator-after-model misuse (unfitted estimator in a "
               "scored DAG / estimator consuming a Prediction)"),
    # -- TMG2xx: device pre-flight (meta-device shapes, no data, no
    #    launch) -------------------------------------------------------------
    "TMG201": (Severity.ERROR,
               "device compute shape mismatch vs declared vector metadata"),
    "TMG202": (Severity.WARNING,
               "unintended dtype promotion: f64 output under the f32 "
               "vector pipeline (the engine casts it back to f32)"),
    "TMG203": (Severity.WARNING,
               "program rebuild risk: a prepared signature that varies "
               "with the batch (a new program and CUDA graph per batch "
               "shape: ScoringEngine.compile_count and graphs_captured "
               "grow per call, not per bucket) or a bare Python scalar "
               "block"),
    "TMG204": (Severity.INFO,
               "pre-flight stopped: stage has no static (shape-only) form"),
    "TMG205": (Severity.ERROR,
               "row-unsafe stage: device_compute row dimension does not "
               "track the input batch, so zero padding to a bucket (or a "
               "mesh's data axis) cannot pad it"),
    "TMG206": (Severity.WARNING,
               "device-resident working set exceeds the device-memory "
               "envelope (the card's total memory as "
               "torch.cuda.get_device_properties reports it, or "
               "TMOG_VMEM_BYTES) and feature-axis sharding is not engaged"),
    # -- TMG3xx: repo rules (the JAX package's tools/tmoglint.py) ----------
    "TMG301": (Severity.ERROR,
               "time.time() used for a duration — monotonic timing must "
               "use time.perf_counter() (allow: '# lint: wall-clock')"),
    "TMG302": (Severity.ERROR,
               "broad 'except Exception' outside an allowlisted "
               "breaker/fallback site (allow: '# lint: broad-except')"),
    "TMG303": (Severity.ERROR,
               "resilience.inject() names a site missing from the "
               "resilience.FAULT_SITES catalog"),
    "TMG304": (Severity.ERROR,
               "telemetry span not opened via a context manager "
               "(unpaired begin/end)"),
    "TMG305": (Severity.ERROR,
               "source file does not parse — the self-lint could not "
               "analyze it"),
    "TMG306": (Severity.ERROR,
               "direct make_mesh() call outside parallel/ — runtime code "
               "must go through process_default_mesh()/set_process_mesh "
               "(allow: '# lint: explicit-mesh — reason')"),
    "TMG307": (Severity.ERROR,
               "threading.Thread() without explicit name= and daemon= — "
               "unnamed threads make per-thread telemetry trace tracks "
               "unreadable and implicit daemonness hides shutdown "
               "semantics (allow: '# lint: thread — reason')"),
    "TMG308": (Severity.ERROR,
               "queue.Queue() without an explicit positive maxsize= — "
               "an unbounded queue between pipeline stages hides "
               "backpressure (allow: '# lint: unbounded-queue — "
               "reason')"),
    "TMG309": (Severity.ERROR,
               "subprocess.Popen() without explicit stdout= and "
               "stderr= — an inherited stream ties the child to the "
               "parent's terminal and an undrained PIPE deadlocks it; "
               "a supervisor owns its workers' streams (allow: "
               "'# lint: popen — reason')"),
    "TMG310": (Severity.ERROR,
               "long-lived thread loop body without a catch — an "
               "uncaught exception silently kills the thread and the "
               "subsystem it drives keeps 'running' with nobody home; "
               "loop bodies of Thread targets must catch-and-tally "
               "(allow: '# lint: thread-loop — reason')"),
    "TMG311": (Severity.ERROR,
               "np.argsort() without kind= / np.searchsorted() without "
               "side= in product code — order-dependent monoid folds "
               "silently change under unstable sort ties, and an "
               "implicit side= hides which boundary a temporal window "
               "includes (allow: '# lint: sort — reason')"),
    "TMG312": (Severity.ERROR,
               "pl.pallas_call() outside models/_pallas_hist.py — every "
               "kernel must live behind that module's probe/fallback "
               "gate (allow: '# lint: pallas — reason')"),
    "TMG313": (Severity.ERROR,
               "telemetry.counter/gauge/histogram() with a non-literal "
               "metric name outside telemetry.py — a dynamic name is "
               "unbounded registry and /metrics exposition cardinality; "
               "use a literal name, or mark a deliberately "
               "dynamic-but-bounded name '# lint: metric-name — reason')"),
    "TMG314": (Severity.ERROR,
               "raw customParams read (subscript or .get()) outside "
               "config.py's registry accessors — a knob consumed off "
               "the declared surface is invisible to `cli check` "
               "validation, the effectiveConfig stamp and the tuner's "
               "search space (allow: '# lint: knob — reason')"),
    "TMG399": (Severity.WARNING,
               "stale suppression: a '# lint: <marker>' escape sits on "
               "a line that no longer triggers the rule it silences — "
               "delete it (or fix the marker if it silences the wrong "
               "rule)"),
    # -- TMG4xx: whole-DAG planner advisories (planner.py) -----------------
    "TMG401": (Severity.WARNING,
               "stage measured slower on device than host but is pinned "
               "to the device tier"),
    "TMG402": (Severity.INFO,
               "prunable dead columns: vectorizer output columns never "
               "reach a sink (dropped before the predictor)"),
    "TMG403": (Severity.INFO,
               "CSE opportunity suppressed: structurally identical stages "
               "differ only in uid-sensitive params/state"),
    "TMG404": (Severity.WARNING,
               "cost database unreadable (corrupt/truncated JSON) — "
               "static fallback estimates are in force"),
    "TMG405": (Severity.WARNING,
               "explicit aggregateColumnar route contradicts the cost "
               "database's measured columnar-vs-rowwise aggregation "
               "tier — the knob wins, the measurement says otherwise"),
    "TMG406": (Severity.WARNING,
               "live serving telemetry contradicts the tuned config: "
               "the online deadline controller converged a tenant's "
               "batch_deadline_s far from the params file's "
               "serveBatchDeadlineMs — re-run the offline tuner"),
    # -- TMG5xx: serving / program-bank advisories (aot.py, serving.py) —
    #    degradation notices, never crash paths ----------------------------
    "TMG501": (Severity.WARNING,
               "program bank incompatible (torch or CUDA version skew, "
               "wrong device, plan/state digest mismatch) — the engine "
               "builds those buckets from its plan, the loader serves "
               "them through the batch-polymorphic program"),
    "TMG502": (Severity.WARNING,
               "program bank artifact corrupt/tampered/truncated — the "
               "affected program(s) are skipped and their buckets built "
               "or served by the batch-polymorphic program"),
    "TMG503": (Severity.WARNING,
               "serving export version skew: artifact exported under a "
               "different torch or CUDA runtime than this process runs"),
    # -- TMG6xx: serving-time drift advisories (lifecycle.py) --------------
    "TMG601": (Severity.WARNING,
               "serving-time drift: train↔live JS divergence above "
               "threshold over the sliding comparison window"),
    "TMG602": (Severity.WARNING,
               "serving-time drift: live fill rate shifted from the "
               "train-time fill rate beyond the delta/ratio thresholds"),
    "TMG603": (Severity.INFO,
               "drift sentinel inactive: model carries no train-time "
               "feature distributions (RawFeatureFilterResults)"),
    "TMG604": (Severity.WARNING,
               "continuous-training warm start unavailable: persisted "
               "train-time sufficient statistics missing or corrupt — "
               "the retrain degrades to a full refit over the fresh "
               "window"),
    "TMG605": (Severity.ERROR,
               "continuous-training controller FAILED: consecutive "
               "retrain-job failure budget exhausted — retraining is "
               "disarmed until an operator clears the job records"),
    # -- TMG7xx: temporal / cutoff leakage rules (temporal.check_temporal:
    #    static and reader-aware; TMG105's taint extended to event time) --
    "TMG701": (Severity.ERROR,
               "temporal leakage: predictor aggregated with NO cutoff "
               "while a response folds from the same events — every "
               "predictor fold sees post-outcome rows"),
    "TMG702": (Severity.ERROR,
               "temporal leakage: response-side generator declares an "
               "event-time window — responses fold strictly AFTER the "
               "cutoff, a window reaches back across it into the "
               "predictor window"),
    "TMG703": (Severity.WARNING,
               "temporal leakage: join key derived from a response-side "
               "(post-cutoff) field routes outcome information into the "
               "joined predictors"),
    # -- TMG8xx: concurrency and crash-safety rules (the JAX package's
    #    tools/concurrency_lint.py) ------------------------------------------
    "TMG801": (Severity.ERROR,
               "lock-order cycle: two lock acquisition paths take the "
               "same locks in opposite orders (allow: "
               "'# lint: lock-order — reason')"),
    "TMG802": (Severity.ERROR,
               "thread-escape: shared state is mutated lock-free from a "
               "function reachable as a threading.Thread target while "
               "its other mutation sites hold a guarding lock (allow: "
               "'# lint: thread-escape — reason')"),
    "TMG803": (Severity.ERROR,
               "blocking call while holding a lock (allow: "
               "'# lint: lock-blocking — reason')"),
    "TMG804": (Severity.ERROR,
               "non-atomic write to a shared artifact without the tmp + "
               "os.replace pattern (allow: '# lint: atomic-write — "
               "reason')"),
    "TMG805": (Severity.ERROR,
               "fault-site coverage gap: a site registered in "
               "resilience.FAULT_SITES is exercised by no test"),
}


@dataclass
class Finding:
    """One structured lint finding (stable rule id + severity + subject)."""

    rule: str
    message: str
    severity: str = ""
    #: stage uid (graph/device rules)
    stage: Optional[str] = None
    #: feature name (graph rules)
    feature: Optional[str] = None
    #: a path, or ``file:line`` (repo rules)
    location: Optional[str] = None

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES.get(self.rule, (Severity.WARNING, ""))[0]

    def format(self) -> str:
        subject = self.location or ""
        if self.stage:
            subject = f"stage={self.stage}"
            if self.feature:
                subject += f" feature={self.feature}"
        elif self.feature:
            subject = f"feature={self.feature}"
        head = f"{self.rule} {self.severity}"
        return f"{head} [{subject}] {self.message}" if subject \
            else f"{head} {self.message}"

    def to_json(self) -> Dict[str, Any]:
        out = {"rule": self.rule, "severity": self.severity,
               "message": self.message}
        for k in ("stage", "feature", "location"):
            v = getattr(self, k)
            if v:
                out[k] = v
        return out


class LintError(Exception):
    """Pre-flight rejection: carries the findings that crossed the
    ``fail_on`` threshold (every finding rides in ``self.findings``)."""

    def __init__(self, findings: Sequence[Finding], fail_on: str):
        self.findings = list(findings)
        self.fail_on = fail_on
        over = [f for f in self.findings
                if _SEVERITY_RANK[f.severity] >= _SEVERITY_RANK[fail_on]]
        lines = "\n  ".join(f.format() for f in over)
        super().__init__(
            f"pre-flight check failed ({len(over)} finding(s) at or above "
            f"'{fail_on}'):\n  {lines}")


def max_severity(findings: Iterable[Finding]) -> Optional[str]:
    """Highest severity present, or None for an empty list."""
    best: Optional[str] = None
    for f in findings:
        if best is None or _SEVERITY_RANK[f.severity] > _SEVERITY_RANK[best]:
            best = f.severity
    return best


def enforce(findings: Sequence[Finding], fail_on: str = Severity.ERROR
            ) -> None:
    """Raise :class:`LintError` when any finding reaches ``fail_on``
    (``"error"``, the default, or ``"warning"``)."""
    if fail_on not in (Severity.ERROR, Severity.WARNING):
        raise ValueError(
            f"fail_on must be 'error' or 'warning', got {fail_on!r}")
    threshold = _SEVERITY_RANK[fail_on]
    if any(_SEVERITY_RANK[f.severity] >= threshold for f in findings):
        raise LintError(findings, fail_on)


def emit_findings(findings: Sequence[Finding], where: str = "lint"
                  ) -> None:
    """Log each finding at its severity's level (error, warning, info),
    prefixed by ``where``."""
    for f in findings:
        log = (logger.error if f.severity == Severity.ERROR else
               logger.warning if f.severity == Severity.WARNING else
               logger.info)
        log("%s: %s", where, f.format())


def _apply_suppress(findings: List[Finding],
                    suppress: Iterable[str]) -> List[Finding]:
    if isinstance(suppress, str):
        # a lone "TMG104" (easy JSON mistake for ["TMG104"]) must not be
        # iterated character by character
        suppress = (suppress,)
    sup = {str(s).upper() for s in (suppress or ())}
    if not sup:
        return findings
    unknown = sup - set(RULES)
    if unknown:
        raise ValueError(f"unknown lint rule id(s) in suppress: "
                         f"{sorted(unknown)}")
    return [f for f in findings if f.rule not in sup]


# ---------------------------------------------------------------------------
# graph traversal (by identity: the uid-keyed dicts in graph.py would hide
# exactly the duplicate-uid collisions TMG102 exists to catch)
# ---------------------------------------------------------------------------


def _walk_features(result_features) -> Tuple[List[Any], List[Any],
                                             List[Finding]]:
    """Depth-first over the feature DAG by object identity: (features in
    topological order, ancestors first; their distinct origin stages in
    the same order; TMG103 cycle findings). The walk stops descending
    into a cycle but reports everything reachable."""
    findings: List[Finding] = []
    feats: List[Any] = []
    stage_ids: Set[int] = set()
    stages: List[Any] = []
    done: Set[int] = set()
    on_path: Set[int] = set()
    cycles_seen: Set[int] = set()

    def visit(f) -> None:
        fid = id(f)
        if fid in done:
            return
        if fid in on_path:
            if fid not in cycles_seen:
                cycles_seen.add(fid)
                findings.append(Finding(
                    "TMG103", f"cycle in the feature graph at "
                    f"{f.name!r}: the feature is its own ancestor",
                    feature=f.name))
            return
        on_path.add(fid)
        for p in f.parents:
            visit(p)
        on_path.discard(fid)
        done.add(fid)
        feats.append(f)
        st = f.origin_stage
        if st is not None and id(st) not in stage_ids:
            stage_ids.add(id(st))
            stages.append(st)

    for f in result_features:
        visit(f)
    return feats, stages, findings


def _stage_label(stage) -> str:
    try:
        return f"{stage.stage_name()} [{stage.uid}]"
    except (AttributeError, TypeError, ValueError):
        return repr(stage)


def _check_graph(result_features, fitted_stages: Optional[Dict[str, Any]]
                 = None, known_stages: Optional[Sequence[Any]] = None
                 ) -> List[Finding]:
    """Every TMG1xx rule over a feature DAG. ``fitted_stages`` (a
    WorkflowModel's uid → fitted model map) arms the dead-stage (TMG104)
    and unfitted-estimator (TMG106) rules; ``known_stages`` is an extra
    stage universe checked for reachability (TMG104)."""
    from .stages.base import AllowLabelAsInput, Estimator, Transformer
    from .stages.generator import FeatureGeneratorStage
    from .types.feature_types import Prediction

    feats, stages, findings = _walk_features(result_features)
    feat_ids = {id(f) for f in feats}

    # TMG102: distinct objects sharing one uid collapse into one node in
    # every uid-keyed map (compute_dag, fitted_stages, checkpoints)
    by_uid: Dict[str, List[Any]] = {}
    for st in stages:
        by_uid.setdefault(st.uid, []).append(st)
    for uid, group in by_uid.items():
        if len(group) > 1:
            names = ", ".join(s.stage_name() for s in group)
            findings.append(Finding(
                "TMG102", f"duplicate stage uid shared by {len(group)} "
                f"distinct stages: {names}", stage=uid))
    feat_by_uid: Dict[str, List[Any]] = {}
    for f in feats:
        feat_by_uid.setdefault(f.uid, []).append(f)
    for uid, group in feat_by_uid.items():
        if len(group) > 1:
            names = ", ".join(f.name for f in group)
            findings.append(Finding(
                "TMG102", f"duplicate feature uid shared by {len(group)} "
                f"distinct features: {names}", feature=names))

    # per-stage contract checks, ancestors first
    for st in stages:
        if isinstance(st, FeatureGeneratorStage):
            continue
        label = _stage_label(st)
        ins = tuple(getattr(st, "input_features", ()) or ())
        if not ins:
            findings.append(Finding(
                "TMG104", f"orphan stage {label}: inputs never set "
                "(set_input was not called)", stage=st.uid))
            continue

        # TMG101: the declared input contract again. set_input enforces
        # it at wiring time, but graphs built by hand, loaded or rewired
        # can bypass it; here it fails before data loading
        try:
            spec = st.input_spec
        except NotImplementedError:
            spec = None
        if spec is not None:
            try:
                spec.check(ins)
            except TypeError as e:
                feat_names = ", ".join(
                    f"{f.name}: {f.ftype.__name__}" for f in ins)
                declared = getattr(spec, "describe", lambda: "?")()
                findings.append(Finding(
                    "TMG101", f"{label} declares inputs {declared} but "
                    f"is wired to ({feat_names}): {e}", stage=st.uid,
                    feature=ins[0].name))

        # TMG101: a feature claiming a type its stage does not output
        try:
            out = st.get_output()
        except ValueError:
            out = None
        if out is not None and id(out) in feat_ids \
                and not issubclass(st.output_type, out.ftype) \
                and not issubclass(out.ftype, st.output_type):
            findings.append(Finding(
                "TMG101", f"feature {out.name!r} claims type "
                f"{out.ftype.__name__} but its origin {label} outputs "
                f"{st.output_type.__name__}", stage=st.uid,
                feature=out.name))

        # TMG106: an estimator fitting on a model's Prediction output
        if isinstance(st, Estimator) and any(
                issubclass(f.ftype, Prediction) for f in ins):
            pf = next(f for f in ins if issubclass(f.ftype, Prediction))
            findings.append(Finding(
                "TMG106", f"estimator {label} consumes model output "
                f"{pf.name!r} (Prediction) — estimators must fit on "
                "features, not on a downstream model's predictions",
                severity=Severity.WARNING, stage=st.uid, feature=pf.name))

    # TMG105: label taint carried transitively, so a label-derived
    # feature laundered through an intermediate stage is still caught.
    # AllowLabelAsInput stages (SanityChecker, selectors) are the
    # sanctioned consumers: their outputs are clean
    bearing: Dict[int, bool] = {id(f): bool(f.is_response) for f in feats}
    for f in feats:
        st = f.origin_stage
        if st is None or isinstance(st, FeatureGeneratorStage):
            continue
        ins = tuple(getattr(st, "input_features", ()) or ())
        if not ins:
            continue
        flags = [bearing.get(id(p), bool(p.is_response)) for p in ins]
        if isinstance(st, AllowLabelAsInput):
            out_bearing = all(flags)
        elif any(flags) and not all(flags):
            leaked = [p.name for p, b in zip(ins, flags) if b]
            findings.append(Finding(
                "TMG105", f"response leakage: {_stage_label(st)} mixes "
                f"label-derived feature(s) {leaked} with predictors but "
                "is not AllowLabelAsInput — its output would leak the "
                "label into the feature matrix", stage=st.uid,
                feature=leaked[0]))
            out_bearing = True
        else:
            out_bearing = all(flags)
        bearing[id(f)] = bearing.get(id(f), False) or out_bearing

    if fitted_stages is not None:
        dag_uids = {st.uid for st in stages}
        for st in stages:
            if isinstance(st, Estimator) and not isinstance(st, Transformer) \
                    and st.uid not in fitted_stages:
                findings.append(Finding(
                    "TMG106", f"unfitted estimator {_stage_label(st)} in a "
                    "scored DAG: scoring would raise 'Estimator has no "
                    "fitted model' at transform time", stage=st.uid))
        for uid in fitted_stages:
            if uid not in dag_uids:
                findings.append(Finding(
                    "TMG104", f"dead fitted stage [{uid}]: not reachable "
                    "from the result features (stale checkpoint or pruned "
                    "graph)", stage=uid))

    if known_stages:
        dag_ids = {id(st) for st in stages}
        dag_uids = {st.uid for st in stages}
        for st in known_stages:
            if id(st) not in dag_ids and st.uid not in dag_uids:
                findings.append(Finding(
                    "TMG104", f"dead stage {_stage_label(st)}: not "
                    "reachable from the result features", stage=st.uid))

    return findings


def check_workflow(workflow, known_stages: Optional[Sequence[Any]] = None,
                   suppress: Iterable[str] = (),
                   reader: Any = None) -> List[Finding]:
    """The graph rules (TMG1xx) over an untrained ``Workflow`` or a
    sequence of result features: no data read, nothing on a device.
    With a ``reader`` (passed, or set on the workflow by ``set_reader``)
    the temporal cutoff-leakage rules (TMG7xx) run too; they inspect the
    reader object and never poll it."""
    feats = getattr(workflow, "result_features", workflow)
    findings = _check_graph(tuple(feats), known_stages=known_stages)
    if reader is None:
        reader = getattr(workflow, "_reader", None)
    if reader is not None:
        from . import temporal
        findings.extend(temporal.check_temporal(reader, tuple(feats)))
    return _apply_suppress(findings, suppress)


def check_model(model, device: bool = True, n_rows: int = 8,
                suppress: Iterable[str] = (), target=None
                ) -> List[Finding]:
    """The graph rules (with the unfitted-estimator and dead-stage rules)
    over a fitted ``WorkflowModel`` and, with ``device``, the device
    pre-flight (TMG2xx; ``target`` as in :func:`preflight_device`)."""
    # suppression applies before the device pass's gate: a suppressed
    # (accepted) graph error must not switch the shape analysis off
    findings = _apply_suppress(
        _check_graph(model.result_features,
                     fitted_stages=model.fitted_stages), suppress)
    if device:
        if any(f.severity == Severity.ERROR for f in findings):
            # a structurally broken DAG cannot be shape-propagated
            findings.extend(_apply_suppress([Finding(
                "TMG204", "device pre-flight skipped: the graph rules "
                "above found errors (fix or suppress them to get shape "
                "analysis)")], suppress))
        else:
            findings.extend(_apply_suppress(
                preflight_device(model, n_rows=n_rows, target=target),
                suppress))
    return findings


# ---------------------------------------------------------------------------
# device pre-flight (TMG2xx): shapes on the meta device
# ---------------------------------------------------------------------------


def _placeholder_column(ftype, n: int):
    """A synthetic n-row column of the feature's type: defaults only, no
    dataset read. Non-nullable numerics get zeros, raw vectors a width-1
    zero matrix, predictions a zero prediction, the rest their empty
    value."""
    import numpy as np

    from .columns import VectorColumn, column_from_values, column_of_empty
    from .types.feature_types import (NonNullable, OPNumeric, OPVector,
                                      Prediction)
    if issubclass(ftype, OPVector):
        return VectorColumn(OPVector, np.zeros((n, 1), dtype=np.float32),
                            None)
    if issubclass(ftype, Prediction):
        return column_from_values(ftype, [{"prediction": 0.0}] * n)
    if issubclass(ftype, OPNumeric) and issubclass(ftype, NonNullable):
        return column_from_values(ftype, [0.0] * n)
    return column_of_empty(ftype, n)


def _synthetic_store(result_features, n: int):
    from .columns import ColumnStore
    seen: Dict[str, Any] = {}
    for f in result_features:
        for raw in f.raw_features():
            seen.setdefault(raw.name, raw.ftype)
    return ColumnStore({name: _placeholder_column(ft, n)
                        for name, ft in seen.items()}, n)


def _prepared_signature(prepared: Dict[str, Any], n: int):
    """Shape signature of a prepared-block dict with the row dimension
    normalized out: two batch sizes give equal signatures iff the
    scoring engine would build one program (and graph) per bucket."""
    import numpy as np
    sig = []
    for k in sorted(prepared):
        a = np.asarray(prepared[k])
        shape = tuple("N" if d == n else d for d in a.shape)
        sig.append((k, str(a.dtype), shape))
    return tuple(sig)


#: TMG206: the bytes a stage's device-resident inputs are held against.
#: ``TMOG_VMEM_BYTES`` sets it; unset, it is the card's total memory as
#: ``torch.cuda.get_device_properties`` reports it at run time (on a host
#: with no card the rule runs only under the variable). The working set is
#: extrapolated from the probe to ``TMOG_VMEM_PROBE_ROWS`` rows, so it
#: reflects a production batch, not the 8-row probe.
VMEM_ENVELOPE_BYTES: Optional[int] = (
    int(os.environ["TMOG_VMEM_BYTES"]) if os.environ.get("TMOG_VMEM_BYTES")
    else None)
VMEM_PROBE_ROWS = int(os.environ.get("TMOG_VMEM_PROBE_ROWS", 8192))


def _envelope(target) -> Tuple[Optional[int], str]:
    """(bytes, what they are) for TMG206, or (None, "") when the rule
    does not run."""
    import torch
    if VMEM_ENVELOPE_BYTES is not None:
        return int(VMEM_ENVELOPE_BYTES), "TMOG_VMEM_BYTES"
    dev = (torch.device(target) if target is not None
           else torch.device("cuda") if torch.cuda.is_available() else None)
    if dev is None or dev.type != "cuda":
        return None, ""
    props = torch.cuda.get_device_properties(dev)
    return int(props.total_memory), f"{props.name}'s memory"


def _meta_blocks(prepared: Dict[str, Any]) -> Dict[str, Any]:
    """Each prepared block as a meta tensor of its shape and dtype."""
    import numpy as np
    import torch
    return {k: torch.empty(np.shape(v), device="meta",
                           dtype=torch.from_numpy(
                               np.zeros(0, np.asarray(v).dtype)).dtype)
            for k, v in prepared.items()}


def preflight_device(model, n_rows: int = 8, target=None) -> List[Finding]:
    """TMG2xx: shapes and dtypes through every layer's device program,
    with no dataset and no launch.

    Host stages run for real on a synthetic store of ``n_rows`` rows (and
    a second of ``n_rows + 3``) on the CPU; each ``VectorizerModel``'s
    ``device_compute`` and each predictor's ``predict_device`` run on the
    ``meta`` device, whose tensors carry a shape and a dtype and no data,
    so no table is uploaded and no kernel launches. ``target`` is the
    device whose memory TMG206 holds the working set against (default:
    the card when one is visible)."""
    import numpy as np
    import torch

    from .columns import PredictionColumn, VectorColumn
    from .models.base import PredictorModel
    from .ops.vectorizer_base import (VEC_DTYPE, VectorizerModel,
                                      canonicalize_prepared)
    from .types.feature_types import OPVector
    from .workflow import WorkflowError, _device_kw

    findings: List[Finding] = []
    n2 = n_rows + 3          # second probe size for the batch checks
    store = _synthetic_store(model.result_features, n_rows)
    store2 = _synthetic_store(model.result_features, n2)
    envelope, envelope_of = _envelope(target)
    cpu = torch.device("cpu")

    def halt(stage, exc) -> None:
        findings.append(Finding(
            "TMG204", f"pre-flight stopped at {_stage_label(stage)}: no "
            f"static form ({type(exc).__name__}: {exc})", stage=stage.uid))

    try:
        layers = model._resolved_dag()
    except WorkflowError as e:
        # the graph rules own this error; here it is a coverage note
        findings.append(Finding(
            "TMG204", f"device pre-flight skipped: the model's DAG does "
            f"not resolve ({e})"))
        return findings
    for layer in layers:
        for m in layer:
            if isinstance(m, VectorizerModel):
                try:
                    raw_prep = m.host_prepare(store)
                    scalars = sorted(k for k, v in raw_prep.items()
                                     if isinstance(v, (int, float))
                                     and not isinstance(v, bool))
                    prep = canonicalize_prepared(raw_prep)
                    prep2 = canonicalize_prepared(m.host_prepare(store2))
                except Exception as e:  # the failure is the finding
                    halt(m, e)
                    return findings
                if scalars:
                    findings.append(Finding(
                        "TMG203", f"{_stage_label(m)} host_prepare returns "
                        f"bare Python scalar(s) {scalars}: each rides as a "
                        "0-d block outside the program key, so a value "
                        "that shapes the program cannot, and every call "
                        "copies it to the device (keep it in the fitted "
                        "state, or make it a row block)", stage=m.uid))
                sig1 = _prepared_signature(prep, n_rows)
                sig2 = _prepared_signature(prep2, n2)
                if sig1 != sig2:
                    moved = sorted(
                        {k for k, _, _ in set(sig1) ^ set(sig2)})
                    findings.append(Finding(
                        "TMG203", f"{_stage_label(m)} prepared signature "
                        f"varies with batch size (blocks {moved}): every "
                        "distinct batch shape builds and captures its own "
                        "program (ScoringEngine.compile_count and "
                        "graphs_captured grow per call, not per bucket)",
                        stage=m.uid))
                try:
                    out = m.device_compute(_meta_blocks(prep))
                except Exception as e:  # a propagation failure is the finding
                    findings.append(Finding(
                        "TMG201", f"{_stage_label(m)} device_compute fails "
                        f"shape propagation: {type(e).__name__}: {e}",
                        stage=m.uid))
                    return findings
                meta = m.vector_metadata()
                shape = tuple(out.shape)
                if len(shape) != 2 or shape[0] != n_rows \
                        or shape[1] != meta.size:
                    findings.append(Finding(
                        "TMG201", f"{_stage_label(m)} device_compute "
                        f"produces shape {shape}, expected "
                        f"({n_rows}, {meta.size}) per its vector metadata",
                        stage=m.uid))
                    width = shape[1] if len(shape) == 2 else meta.size
                else:
                    width = meta.size
                    # TMG205: a second probe size must move the output's
                    # row dimension with it; a stage that bakes the row
                    # count into its program cannot be zero-padded to a
                    # bucket (or a mesh's data axis)
                    try:
                        shape2 = tuple(m.device_compute(
                            _meta_blocks(prep2)).shape)
                    except Exception as e:  # the failure is the finding
                        shape2 = None
                        findings.append(Finding(
                            "TMG205", f"{_stage_label(m)} device_compute "
                            f"fails at a second batch size ({n2} rows: "
                            f"{type(e).__name__}: {e}) — rows cannot be "
                            "padded to a bucket or a mesh's data axis",
                            stage=m.uid))
                    if shape2 is not None and (len(shape2) != 2
                                               or shape2[0] != n2):
                        findings.append(Finding(
                            "TMG205", f"{_stage_label(m)} device_compute "
                            f"row dimension does not track the batch "
                            f"({n_rows}→{shape[0]} rows but "
                            f"{n2}→{shape2[0] if shape2 else '?'}): zero "
                            "padding cannot pad it to a bucket or a "
                            "mesh's data axis", stage=m.uid))
                if out.dtype == torch.float64:
                    findings.append(Finding(
                        "TMG202", f"{_stage_label(m)} device_compute "
                        "promotes to float64: the vector pipeline is f32, "
                        "so the engine and the layer path cast it back "
                        "and the f64 work is wasted", stage=m.uid))
                # TMG206: the stage's prepared blocks (its device-resident
                # inputs) extrapolated from the probe to VMEM_PROBE_ROWS
                # rows; constant dims (vocab tables, bin edges) as-is.
                # Advisory: it ignores intermediates, so it flags
                # order-of-magnitude overruns, not near-misses
                if envelope is not None:
                    resident = 0
                    for v in prep.values():
                        a = np.asarray(v)
                        nb = int(a.dtype.itemsize)
                        for d in a.shape:
                            nb *= (VMEM_PROBE_ROWS if d == n_rows
                                   else int(d))
                        resident += nb
                    if resident > envelope:
                        findings.append(Finding(
                            "TMG206", f"{_stage_label(m)} device-resident "
                            f"working set ~{resident / 2**20:.1f} MiB at "
                            f"{VMEM_PROBE_ROWS} rows exceeds the "
                            f"{envelope / 2**20:.0f} MiB device-memory "
                            f"envelope ({envelope_of}; VMEM_ENVELOPE_BYTES)"
                            " with feature sharding off: "
                            "customParams.featureShards (columns 1/G per "
                            "device, ROADMAP A6.6) and "
                            "customParams.streamFit (A6.5) are the "
                            "remedies", stage=m.uid))
                store = store.with_column(
                    m.output_name,
                    VectorColumn(OPVector,
                                 np.zeros((n_rows, width), dtype=VEC_DTYPE),
                                 meta))
                store2 = store2.with_column(
                    m.output_name,
                    VectorColumn(OPVector,
                                 np.zeros((n2, width), dtype=VEC_DTYPE),
                                 meta))
            elif isinstance(m, PredictorModel):
                fcol = store.get(m.input_features[1].name)
                if not isinstance(fcol, VectorColumn):
                    halt(m, TypeError("feature input is not a vector"))
                    return findings
                width = fcol.values.shape[1]
                try:
                    pred, raw, _prob = m.predict_device(torch.empty(
                        (n_rows, width), dtype=torch.float32,
                        device="meta"))
                except Exception as e:  # the failure is the finding
                    halt(m, e)
                    return findings
                if tuple(pred.shape) != (n_rows,):
                    findings.append(Finding(
                        "TMG201", f"{_stage_label(m)} predict_device "
                        f"prediction shape {tuple(pred.shape)}, expected "
                        f"({n_rows},)", stage=m.uid))
                k = raw.shape[1] if len(raw.shape) == 2 else 0
                for n, name in ((n_rows, "store"), (n2, "store2")):
                    col = PredictionColumn(
                        np.zeros((n,)), np.zeros((n, k)), np.zeros((n, k)))
                    if name == "store":
                        store = store.with_column(m.output_name, col)
                    else:
                        store2 = store2.with_column(m.output_name, col)
            else:
                # a host stage: run it for real on the tiny stores
                try:
                    store = m.transform(store, **_device_kw(m, cpu))
                    store2 = m.transform(store2, **_device_kw(m, cpu))
                except Exception as e:  # the failure is the finding
                    halt(m, e)
                    return findings
    return findings
