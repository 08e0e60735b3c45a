"""The declared ``customParams`` knob registry; the port of
``transmogrifai_tpu/config.py``.

Every knob the system has (scoring, server, pipeline, fleet, temporal,
fitstats, workflow, observability) is declared here as a :class:`Knob`
record: name, type, default, bounds or choices, the module that owns it,
whether a tuner may search it, and an optional extra validator. The
names, types, defaults, owners and validators are the JAX package's, so
one params file means the same in both packages. The registry keeps the
knobs of the modules this package has not ported yet (the mesh, the
tuner): it is the declared surface that ``python -m
transmogrifai_tpu_torch check`` validates, and the runner raises where a
run asks for one of them.

The runner's knob readers are lookups over this table, ``gen`` emits its
``customParams`` block from :func:`default_custom_params`, ``check``
validates with :func:`check_custom_params`, and every metrics document
stamps :func:`effective_config`: each knob's resolved value after
defaults.

Error-message contract: the ``ValueError`` texts raised here are the
strings ``check`` reports as TMG001 findings (``customParams.<key> must
be an integer, got ...``), word for word the JAX package's.

This module is the home of raw ``customParams[...]`` reads: code
elsewhere routes through these accessors (the repo rule TMG314,
``repo_lint/tmoglint.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Knob", "REGISTRY", "knob", "iter_knobs", "tunable_knobs",
           "knob_bounds", "numeric_param", "bool_param", "string_param",
           "check_custom_params", "default_custom_params",
           "effective_config", "coerce_numeric", "coerce_bool"]


@dataclass(frozen=True)
class Knob:
    """One declared ``customParams`` entry.

    ``type`` is one of ``int float bool str enum dict list``; ``bool``
    knobs with ``allow_auto`` accept the tri-state ``"auto"``.
    ``default`` is what ``gen`` emits and what resolution falls back
    to (``None`` = unset: the owning module applies its own internal
    default, recorded in ``doc``).  ``minimum``/``maximum`` bound
    numeric values at validation time; ``tune_lo``/``tune_hi`` are the
    (possibly narrower) bounds the offline tuner and the online
    controller may move the knob within — only meaningful when
    ``tunable``.  ``validator`` is an extra hook for constraints the
    scalar bounds cannot express (e.g. canaryFraction in (0, 1])."""

    name: str
    type: str
    default: Any
    owner: str
    doc: str
    minimum: Optional[float] = None
    maximum: Optional[float] = None
    choices: Tuple[str, ...] = ()
    allow_auto: bool = False
    tunable: bool = False
    tune_lo: Optional[float] = None
    tune_hi: Optional[float] = None
    validator: Optional[Callable[[Any], Optional[str]]] = field(
        default=None, compare=False)


REGISTRY: Dict[str, Knob] = {}


def _declare(name: str, type: str, default: Any, owner: str, doc: str,
             **kw: Any) -> None:
    if name in REGISTRY:  # declaration bug, fail at import
        raise ValueError(f"duplicate knob declaration: {name}")
    REGISTRY[name] = Knob(name=name, type=type, default=default,
                          owner=owner, doc=doc, **kw)


def _canary_fraction_ok(v: Any) -> Optional[str]:
    if isinstance(v, (int, float)) and not isinstance(v, bool) \
            and not 0 < v <= 1:
        return f"customParams.canaryFraction must be in (0, 1], got {v!r}"
    return None


def _retrain_cmd_ok(v: Any) -> Optional[str]:
    """The trainer-command shape check: ``continual.validate_retrain_cmd``,
    the one predicate ``check``, ``serve`` and the controller share."""
    from .continual import ContinualError, validate_retrain_cmd
    try:
        validate_retrain_cmd(v)
    except ContinualError as e:
        return f"customParams.retrainCmd: {e}"
    return None


# --- workflow / preflight ------------------------------------------------
_declare("validate", "bool", True, "runner",
         "run the static pre-flight (TMG1xx/TMG2xx) before Train/Score")
_declare("validateDevice", "bool", None, "runner",
         "include the eval_shape device pass in pre-flight (default on)")
_declare("failOn", "enum", "error", "runner",
         "findings severity that halts the run", choices=("error", "warning"))
_declare("lintSuppress", "list", None, "lint",
         "lint rule ids to suppress, e.g. [\"TMG301\"]")
_declare("plan", "bool", True, "planner",
         "build the cost-based whole-DAG ExecutionPlan before execution")
_declare("costDb", "str", None, "planner",
         "persisted CostDatabase path (priors for planning and tuning)")
_declare("compileCacheDir", "str", None, "runner",
         "the cost database's directory when costDb is unset (nothing "
         "is compiled ahead in this package)")
# --- batch scoring / streaming -------------------------------------------
_declare("maxBatches", "int", None, "runner",
         "StreamingScore: stop after N batches", minimum=1)
_declare("timeoutS", "float", None, "runner",
         "StreamingScore: idle-source exit timeout (seconds)", minimum=0)
_declare("batchSize", "int", None, "runner",
         "StreamingScore: rows per scored batch", minimum=1,
         tunable=True, tune_lo=256, tune_hi=16384)
_declare("onBatchError", "enum", None, "runner",
         "StreamingScore poison-batch policy (default quarantine)",
         choices=("halt", "quarantine"))
_declare("overlap", "bool", "auto", "pipeline",
         "overlap host ingest with device compute (tri-state)",
         allow_auto=True)
_declare("pipeline", "bool", True, "pipeline",
         "use the staged prefetch input pipeline")
_declare("pipelineWorkers", "int", None, "pipeline",
         "parallel ingest workers (default: cores-capped auto)",
         minimum=1, tunable=True, tune_lo=1, tune_hi=8)
_declare("pipelineDepth", "int", None, "pipeline",
         "prefetch ring depth (staging buffers in flight)",
         minimum=1, tunable=True, tune_lo=1, tune_hi=8)
# --- mesh / parallel ------------------------------------------------------
_declare("meshDevices", "int", None, "parallel",
         "data-parallel mesh axis size", minimum=1)
_declare("meshGridSize", "int", None, "parallel",
         "grid (model) mesh axis size", minimum=1)
# --- out-of-core training -------------------------------------------------
_declare("streamFit", "bool", None, "runner",
         "multi-pass streaming fit over directory sources (tri-state: "
         "null = auto)", allow_auto=True)
_declare("streamFitPasses", "int", None, "runner",
         "directory re-scan budget for streaming fits", minimum=1)
_declare("featureShards", "int", None, "models",
         "shard tree-fit feature columns over the mesh grid axis",
         minimum=1)
_declare("rssCapMb", "float", None, "pipeline",
         "advisory host-memory budget the ingest planner routes against",
         minimum=1)
# --- temporal -------------------------------------------------------------
_declare("aggregateColumnar", "bool", None, "temporal",
         "columnar aggregation engine (tri-state: null = auto, "
         "true/false force/forbid)", allow_auto=True)
_declare("joinPartitions", "int", None, "temporal",
         "streaming hash-join build-side partitions", minimum=1)
_declare("joinTableMaxRows", "int", None, "temporal",
         "per-partition hash-table row bound (overflow quarantines)",
         minimum=1)
# --- model server (docs/serving.md) ---------------------------------------
_declare("servePort", "int", None, "server",
         "HTTP port (0 = ephemeral)", minimum=0)
_declare("serveBatchDeadlineMs", "float", None, "server",
         "micro-batching hold: higher = more coalescing + that much p50",
         minimum=0, tunable=True, tune_lo=0.0, tune_hi=50.0)
_declare("serveMaxQueue", "int", None, "server",
         "bounded per-model queue (beyond = 429)", minimum=1)
_declare("serveMaxModels", "int", None, "server",
         "loaded models before LRU eviction", minimum=1)
_declare("serveCapacityMB", "float", None, "server",
         "summed bank-weight bound for loaded models", minimum=1)
_declare("serveSloMs", "float", None, "server",
         "per-request latency SLO; attainment in server_stats()",
         minimum=0)
_declare("serveBucketCap", "int", None, "server",
         "engine bucket cap for served models (match the export's)",
         minimum=8)
_declare("serveModels", "dict", None, "server",
         "multi-tenant roster: {name: dir} or {name: {model, bank}}")
_declare("serveBank", "str", None, "server",
         "AOT export dir for the default tenant")
_declare("serveMetrics", "bool", None, "server",
         "expose /metrics Prometheus plane on the serve worker")
_declare("adaptDeadline", "bool", None, "server",
         "online batch-deadline adaptation (AIMD within registry "
         "bounds; kill switch TMOG_ADAPT=0; default off)")
# --- lifecycle / drift ----------------------------------------------------
_declare("registryDir", "str", None, "lifecycle",
         "model registry root (versions, promotions)")
_declare("driftWindow", "int", None, "lifecycle",
         "drift-sentinel window size (requests)", minimum=1)
_declare("driftJsThreshold", "float", None, "lifecycle",
         "Jensen-Shannon drift advisory threshold", minimum=0)
_declare("canaryFraction", "float", None, "lifecycle",
         "canary traffic fraction in (0, 1]", minimum=0,
         validator=_canary_fraction_ok)
# --- continual training ---------------------------------------------------
_declare("retrainOnDrift", "bool", None, "continual",
         "arm the drift-triggered retrain controller")
_declare("retrainCmd", "list", None, "continual",
         "trainer argv template (validated shape)",
         validator=_retrain_cmd_ok)
_declare("retrainArmWindows", "int", None, "continual",
         "consecutive drifted windows before trigger", minimum=1)
_declare("retrainCooldownS", "float", None, "continual",
         "seconds between retrain triggers", minimum=0)
_declare("retrainMaxFailures", "int", None, "continual",
         "failed jobs before the controller gives up", minimum=1)
_declare("retrainTimeoutS", "float", None, "continual",
         "retrain job kill timeout (seconds)", minimum=1)
# --- fleet ----------------------------------------------------------------
_declare("fleetWorkers", "int", None, "fleet",
         "serve worker process count", minimum=1)
_declare("fleetBasePort", "int", None, "fleet",
         "first worker port (0 = ephemeral)", minimum=0)
_declare("workerRespawnMax", "int", None, "fleet",
         "crash respawns before a worker is given up", minimum=0)
_declare("routerRetryBudget", "int", None, "fleet",
         "router failover retries per request", minimum=0)
# --- observability --------------------------------------------------------
_declare("telemetry", "bool", None, "telemetry",
         "force run telemetry on without a trace sink")
_declare("traceDir", "str", None, "telemetry",
         "shared trace-shard directory (distributed tracing)")
_declare("workloadDir", "str", None, "workload",
         "workload flight-recorder shard directory")
_declare("workloadMaxMb", "float", None, "workload",
         "per-shard rotation bound (MB)", minimum=0.001)
_declare("workloadPayloads", "bool", None, "workload",
         "record full request payloads (else digests only)")


def iter_knobs() -> List[Knob]:
    """All declared knobs, in declaration order."""
    return list(REGISTRY.values())


def knob(name: str) -> Knob:
    """Registry lookup; an undeclared name is a programming error."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"undeclared customParams knob: {name!r}") from None


def tunable_knobs() -> List[Knob]:
    """The searchable space: knobs the offline tuner may move."""
    return [k for k in REGISTRY.values() if k.tunable]


def knob_bounds(name: str) -> Tuple[float, float]:
    """The (lo, hi) interval a tuner/controller may move ``name``
    within.  Falls back to validity bounds when no tuning bounds are
    declared; an unbounded side is ``-inf``/``inf``."""
    k = knob(name)
    lo = k.tune_lo if k.tune_lo is not None else k.minimum
    hi = k.tune_hi if k.tune_hi is not None else k.maximum
    return (float(lo) if lo is not None else float("-inf"),
            float(hi) if hi is not None else float("inf"))


# --- coercion (the one implementation of the error contract) --------------

def coerce_numeric(raw: Any, key: str, cast=float,
                   minimum: Optional[float] = None) -> Any:
    """Validate+cast one numeric value, raising the contract
    ``ValueError`` naming the key.  ``cast=int`` rejects silent float
    truncation; NaN/inf are rejected (NaN slips past any ``v < minimum``
    comparison)."""
    kind = "an integer" if cast is int else "a number"
    try:
        if isinstance(raw, bool):
            raise TypeError
        v = cast(raw)
        if cast is int and float(raw) != v:
            raise TypeError
        if not math.isfinite(v):
            raise TypeError
    except (TypeError, ValueError, OverflowError):
        # OverflowError: int(1e400) — JSON happily parses huge floats
        raise ValueError(
            f"customParams.{key} must be {kind}, got {raw!r}") from None
    if minimum is not None and v < minimum:
        raise ValueError(
            f"customParams.{key} must be >= {minimum:g}, got {raw!r}")
    return v


def coerce_bool(raw: Any, key: str, allow_auto: bool = False) -> Any:
    """Validate one boolean value: JSON true/false, the strings
    "true"/"false" (shell-templated config files), and — with
    ``allow_auto`` — the tri-state ``"auto"``."""
    if isinstance(raw, bool):
        return raw
    if isinstance(raw, str):
        s = raw.strip().lower()
        if s in ("true", "false"):
            return s == "true"
        if allow_auto and s == "auto":
            return "auto"
    kinds = "a boolean (true/false)"
    if allow_auto:
        kinds += ' or "auto"'
    raise ValueError(f"customParams.{key} must be {kinds}, got {raw!r}")


# --- registry-driven accessors -------------------------------------------

def numeric_param(custom_params: Dict[str, Any], name: str,
                  default: Any = None) -> Any:
    """Registry-backed numeric lookup: cast and minimum come from the
    declaration; ``None``/absent returns ``default`` (the caller's
    module-internal fallback, NOT the registry default — an explicit
    JSON null means "use the module default", same as omitting)."""
    k = knob(name)
    if k.type not in ("int", "float"):
        raise KeyError(f"knob {name!r} is {k.type}, not numeric")
    raw = custom_params.get(name)  # lint: knob — the registry accessor
    if raw is None:
        return default
    return coerce_numeric(raw, name, int if k.type == "int" else float,
                          minimum=k.minimum)


def bool_param(custom_params: Dict[str, Any], name: str,
               default: Any = None) -> Any:
    """Registry-backed boolean lookup (tri-state when declared)."""
    k = knob(name)
    if k.type != "bool":
        raise KeyError(f"knob {name!r} is {k.type}, not bool")
    raw = custom_params.get(name)  # lint: knob — the registry accessor
    if raw is None:
        return default
    return coerce_bool(raw, name, allow_auto=k.allow_auto)


def string_param(custom_params: Dict[str, Any], name: str,
                 default: Any = None) -> Any:
    """Registry-backed path/string lookup (validated type)."""
    k = knob(name)
    if k.type != "str":
        raise KeyError(f"knob {name!r} is {k.type}, not str")
    raw = custom_params.get(name)  # lint: knob — the registry accessor
    if raw is None:
        return default
    if not isinstance(raw, str):
        raise ValueError(f"customParams.{name} must be a path string, "
                         f"got {raw!r}")
    return raw


def raw_param(custom_params: Dict[str, Any], name: str,
              default: Any = None) -> Any:
    """Registry-gated passthrough for dict/list/enum knobs whose shape
    checks live with their owner (serveModels roster, retrainCmd)."""
    knob(name)  # existence check: undeclared names fail loudly
    raw = custom_params.get(name)  # lint: knob — the registry accessor
    return default if raw is None else raw


# --- whole-file validation (`check` derives from this)  ------------------

def check_custom_params(custom_params: Dict[str, Any]) -> List[Tuple[str, str]]:
    """Sweep every declared knob over one ``customParams`` dict and
    return ``(knob_name, error_message)`` pairs — the registry-derived
    validation ``check`` surfaces as TMG001 findings.  Unknown keys
    are NOT errors (apps may carry private keys), but every declared
    knob present must parse."""
    errors: List[Tuple[str, str]] = []
    for k in REGISTRY.values():
        raw = custom_params.get(k.name)  # lint: knob — registry sweep
        if raw is None:
            continue
        try:
            if k.type in ("int", "float"):
                coerce_numeric(raw, k.name,
                               int if k.type == "int" else float,
                               minimum=k.minimum)
            elif k.type == "bool":
                coerce_bool(raw, k.name, allow_auto=k.allow_auto)
            elif k.type == "str":
                if not isinstance(raw, str):
                    raise ValueError(
                        f"customParams.{k.name} must be a path string, "
                        f"got {raw!r}")
            elif k.type == "enum":
                if raw not in k.choices:
                    raise ValueError(
                        f"customParams.{k.name} must be one of "
                        f"{list(k.choices)}, got {raw!r}")
            elif k.type == "dict":
                if not isinstance(raw, dict):
                    raise ValueError(
                        f"customParams.{k.name} must be an object, "
                        f"got {raw!r}")
            elif k.type == "list":
                # str allowed: lintSuppress takes a bare rule id, and
                # a string retrainCmd must reach its validator (which
                # owns the shell-string finding) rather than
                # double-report here
                if not isinstance(raw, (list, tuple, str)):
                    raise ValueError(
                        f"customParams.{k.name} must be a list, "
                        f"got {raw!r}")
        except ValueError as e:
            errors.append((k.name, str(e)))
            continue
        if k.validator is not None:
            msg = k.validator(raw)
            if msg:
                errors.append((k.name, msg))
    return errors


# --- emission / stamping --------------------------------------------------

#: knobs `gen` leaves out of the scaffolded params.json (serving /
#: fleet / continual surfaces a generated batch app does not start with;
#: same set the pre-registry scaffold emitted)
_GEN_OMIT = frozenset((
    "validateDevice", "lintSuppress", "compileCacheDir", "maxBatches",
    "timeoutS", "batchSize", "onBatchError", "servePort",
    "serveBatchDeadlineMs", "serveMaxQueue", "serveMaxModels",
    "serveCapacityMB", "serveSloMs", "serveBucketCap", "serveModels",
    "serveBank", "adaptDeadline", "telemetry"))


def default_custom_params() -> Dict[str, Any]:
    """The ``customParams`` block ``gen`` scaffolds: every
    non-omitted registry knob at its declared default, in declaration
    order — so a generated project names the whole surface it can
    tune."""
    return {k.name: k.default for k in REGISTRY.values()
            if k.name not in _GEN_OMIT}


def effective_config(custom_params: Dict[str, Any]) -> Dict[str, Any]:
    """The resolved config stamped on every metrics doc: for each
    declared knob, the validated supplied value or the declared default.
    Values that fail validation are stamped as ``{"invalid": raw}`` so
    the doc still records what was asked for."""
    out: Dict[str, Any] = {}
    for k in REGISTRY.values():
        raw = custom_params.get(k.name)  # lint: knob — registry stamp
        if raw is None:
            out[k.name] = k.default
            continue
        try:
            if k.type in ("int", "float"):
                out[k.name] = coerce_numeric(
                    raw, k.name, int if k.type == "int" else float,
                    minimum=k.minimum)
            elif k.type == "bool":
                out[k.name] = coerce_bool(raw, k.name,
                                          allow_auto=k.allow_auto)
            else:
                out[k.name] = raw
        except ValueError:
            out[k.name] = {"invalid": repr(raw)}
    return out
