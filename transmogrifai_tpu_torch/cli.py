"""The command line; the port of ``transmogrifai_tpu/cli.py``.

``python -m transmogrifai_tpu_torch <command>``:

* ``gen`` (the reference's ``op gen``, ``cli/.../CLI.scala``): from a CSV
  with a header and a response column, infer the problem kind (binary,
  multiclass, regression) and a feature type a column, and scaffold a
  runnable project on this package::

      <output>/
        features.py     feature declarations (FeatureBuilder per column)
        app.py          OpApp subclass wiring reader + selector + runner
        params.json     OpParams skeleton (customParams from config.py)
        README.md       how to run

  The files are the JAX package's with this package's name.
* ``check``: validate a params file against the knob registry (TMG001)
  and pre-flight a saved model (the graph rules, and the device shape
  pass on the ``meta`` device) without reading data.
* ``plan``: a saved model's execution plan from the cost database, with
  its TMG4xx advisories; no data read, nothing launched.
* ``lint``: the repo rules over this package's tree (``repo_lint/``: the
  per-line TMG3xx rules and the whole-program TMG8xx pass).
* ``trace merge``: the trace shards a run wrote into ``traceDir`` merged
  into one Perfetto-loadable file; ``trace analyze``: each request's
  critical path across processes from those shards (``workload.py``),
  with a regression diff against a ``--baseline`` analysis.
* ``serve``: the params file's roster in a multi-tenant
  :class:`~transmogrifai_tpu_torch.server.ModelServer` on the card
  (``--device cpu`` asks for the CPU), behind the stdlib HTTP front end,
  drained on SIGINT and SIGTERM; ``workloadDir`` records its traffic and
  ``retrainOnDrift`` arms continuous training (``continual.py``).
* ``fleet``: N supervised ``serve`` workers behind the failover router
  (``fleet.py``), each on the device ``--device`` names.
* ``workload merge | replay``: the recorded shards merged into one
  workload, and that workload driven again against a server or fleet
  with score parity.
* ``registry``: list, register, promote, roll back or read the current
  version of the versioned model registry (``lifecycle.py``).

* ``tune``: the offline autotuner (``tuner.py``): a coordinate descent
  over the registry's tunable knobs, each candidate a server (or fleet)
  booted on the device ``--device`` names and the recorded workload
  replayed against it with score parity; writes ``params.tuned.json`` and
  a byte-stable report.

Usage::

    python -m transmogrifai_tpu_torch gen --input data.csv --response label \\
        --id id --name MyApp --output ./myapp
    python -m transmogrifai_tpu_torch check params.json --model ./model
    python -m transmogrifai_tpu_torch plan params.json --model ./model
    python -m transmogrifai_tpu_torch lint
    python -m transmogrifai_tpu_torch trace merge ./traces
    python -m transmogrifai_tpu_torch serve params.json --port 0 --port-file port.txt
    python -m transmogrifai_tpu_torch fleet params.json --workers 2 --port 8000
    python -m transmogrifai_tpu_torch workload merge ./workload
    python -m transmogrifai_tpu_torch workload replay ./workload/merged.workload.json --url http://127.0.0.1:8000
    python -m transmogrifai_tpu_torch trace analyze ./traces --baseline prev.json
    python -m transmogrifai_tpu_torch registry list --registry ./registry
"""
from __future__ import annotations

import argparse
import csv as _csv
import json
import os
import re
import signal
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import config

__all__ = ["infer_feature_types", "infer_problem_kind", "generate_project",
           "build_server_from_params", "build_retrain_controllers",
           "run_registry", "run_serve", "run_fleet", "run_trace",
           "run_workload", "main"]

_SAMPLE_ROWS = 1000

#: how long ``serve`` and ``fleet`` block between looks at their stop
#: event: the kernel may deliver SIGTERM or SIGHUP to any thread, and
#: CPython runs the handler in the main thread only when it next runs
#: bytecode, so a long wait would hold the signal that long
_SIGNAL_POLL_S = 0.25


def _is_int(v: str) -> bool:
    try:
        int(v)
        return True
    except ValueError:
        return False


def _is_float(v: str) -> bool:
    try:
        float(v)
        return True
    except ValueError:
        return False


def infer_feature_types(path: str) -> Tuple[List[str], Dict[str, str]]:
    """(header, {column: feature type name}) from a sampled read
    (``AvroField`` → feature template mapping analog, cli/.../gen)."""
    with open(path, newline="") as fh:
        reader = _csv.reader(fh)
        header = next(reader)
        samples: Dict[str, List[str]] = {h: [] for h in header}
        for i, row in enumerate(reader):
            if i >= _SAMPLE_ROWS:
                break
            for h, v in zip(header, row):
                if v != "":
                    samples[h].append(v)

    types: Dict[str, str] = {}
    for h in header:
        vals = samples[h]
        if not vals:
            types[h] = "Text"
            continue
        uniq = set(vals)
        if uniq <= {"0", "1"} or {v.lower() for v in uniq} <= \
                {"true", "false"}:
            types[h] = "Binary"
        elif all(_is_int(v) for v in vals):
            types[h] = "Integral"
        elif all(_is_float(v) for v in vals):
            types[h] = "Real"
        elif len(uniq) <= max(20, len(vals) // 10):
            types[h] = "PickList"
        else:
            types[h] = "Text"
    return header, types


def infer_problem_kind(path: str, response: str,
                       types: Optional[Dict[str, str]] = None) -> str:
    """binary / multiclass / regression from the response column's values
    (``ProblemKind`` inference, cli/.../ProblemSchema)."""
    if types is None:
        _header, types = infer_feature_types(path)
    if response not in types:
        raise ValueError(f"Response column {response!r} not in {path}")
    with open(path, newline="") as fh:
        reader = _csv.DictReader(fh)
        vals = {row[response] for i, row in enumerate(reader)
                if i < _SAMPLE_ROWS and row.get(response)}
    if {v.lower() for v in vals} <= {"0", "1", "0.0", "1.0", "true",
                                     "false"}:
        return "binary"
    if types[response] in ("Integral", "PickList", "Text", "Binary") \
            and len(vals) <= 30:
        return "multiclass"
    return "regression"


_SELECTOR = {
    "binary": ("BinaryClassificationModelSelector", "auPR",
               "BinaryClassification"),
    "multiclass": ("MultiClassificationModelSelector", "f1",
                   "MultiClassification"),
    "regression": ("RegressionModelSelector", "rmse", "Regression"),
}


def _safe(name: str) -> str:
    return re.sub(r"\W+", "_", name)


def generate_project(input_csv: str, response: str, output: str,
                     name: str = "OpApp", id_column: Optional[str] = None
                     ) -> Dict[str, str]:
    """Scaffold the project; returns {filename: path}."""
    header, types = infer_feature_types(input_csv)
    kind = infer_problem_kind(input_csv, response, types=types)
    selector_cls, metric_fn, eval_factory = _SELECTOR[kind]
    os.makedirs(output, exist_ok=True)

    predictors = [h for h in header if h != response and h != id_column]
    response_type = "RealNN" if kind != "multiclass" else "Text"

    lines = [
        '"""Feature declarations — generated by transmogrifai_tpu_torch gen."""',
        "from transmogrifai_tpu_torch import FeatureBuilder",
        "",
        f"response = (FeatureBuilder.{response_type}({response!r})",
        "            .from_column().as_response())",
        "",
    ]
    for h in predictors:
        lines.append(
            f"{_safe(h)} = (FeatureBuilder.{types[h]}({h!r})"
            f".from_column().as_predictor())")
    lines += ["", "predictors = [" +
              ", ".join(_safe(h) for h in predictors) + "]", ""]
    features_py = "\n".join(lines)

    indexed = (kind == "multiclass")
    app_py = f'''"""{name} — generated by transmogrifai_tpu_torch gen ({kind})."""
import sys

from transmogrifai_tpu_torch import Workflow
from transmogrifai_tpu_torch.dsl import transmogrify
from transmogrifai_tpu_torch.evaluators import Evaluators
from transmogrifai_tpu_torch.models import {selector_cls}
from transmogrifai_tpu_torch.readers import DataReaders
from transmogrifai_tpu_torch.runner import OpApp, OpWorkflowRunner

from features import predictors, response

INPUT_CSV = {input_csv!r}

{"label = response.indexed()" if indexed else "label = response"}
features = transmogrify(predictors)
checked = label.sanity_check(features)
prediction = label.transform_with(
    {selector_cls}.with_cross_validation(), checked)
{"deindexed = label.deindexed(prediction)" if indexed else ""}

workflow = Workflow().set_result_features(
    prediction{", deindexed" if indexed else ""})
evaluator = Evaluators.{eval_factory}.{metric_fn}().set_columns(
    label, prediction)


class {_safe(name)}(OpApp):
    def runner(self, params):
        reader = DataReaders.simple.csv_auto(INPUT_CSV)
        return OpWorkflowRunner(
            workflow, training_reader=reader, scoring_reader=reader,
            evaluator=evaluator)


if __name__ == "__main__":
    result = {_safe(name)}().main(sys.argv[1:])
    print(result.metrics)
'''

    params = {"stageParams": {}, "readerParams": {},
              "modelLocation": "./model",
              "metricsLocation": "./metrics.json",
              "quarantineLocation": "./quarantine.jsonl",
              # the block is emitted from the knob registry (config.py):
              # every non-serving knob at its declared default, in
              # declaration order, so the scaffold names the whole
              # surface `check` validates
              "customParams": config.default_custom_params()}

    readme = (f"# {name}\n\nGenerated by `transmogrifai_tpu_torch gen` from "
              f"`{os.path.basename(input_csv)}` ({kind}).\n\n"
              "```bash\npython app.py --run-type Train --params params.json\n"
              "python app.py --run-type Score --params params.json "
              "--write-location scores.csv\n```\n\n"
              "Malformed input files and failed scoring batches are "
              "quarantined to `quarantine.jsonl` (one JSON line per "
              "item, with the reason) and counted in the run's metrics "
              "doc under `resilience` — see docs/robustness.md.\n")

    out: Dict[str, str] = {}
    for fname, content in [("features.py", features_py), ("app.py", app_py),
                           ("params.json", json.dumps(params, indent=1)),
                           ("README.md", readme)]:
        p = os.path.join(output, fname)
        with open(p, "w") as fh:
            fh.write(content)
        out[fname] = p
    return out


def _populate_stage_registry() -> None:
    """Standalone CLI: populate the stage registry the way an app's own
    imports would, so any saved model loads (shared by ``check`` and
    ``plan``)."""
    from . import models as _models  # noqa: F401
    from . import ops as _ops  # noqa: F401
    from .ops import (calibrators, dt_bucketizer,  # noqa: F401
                      sanity_checker, scalers)


def _suppressed(params, suppress: Sequence[str]) -> Tuple[str, ...]:
    """``suppress`` and the params file's ``lintSuppress`` (a list of rule
    ids, or one bare id)."""
    extra = config.raw_param(params.custom_params, "lintSuppress", ())
    if isinstance(extra, str):
        extra = (extra,)
    return tuple(suppress) + tuple(extra)


def _load_params(params_path: str, what: str):
    """The OpParams file, or None after printing why it cannot be read."""
    from .runner import OpParams
    try:
        return OpParams.from_file(params_path)
    except (OSError, ValueError, KeyError, AttributeError) as e:
        print(f"{what}: cannot load {params_path!r}: {e}")
        return None


def run_check(params_path: Optional[str] = None,
              model_location: Optional[str] = None,
              fail_on: str = "error", device: bool = True,
              suppress: Sequence[str] = ()) -> int:
    """The ``check`` subcommand: validate an OpParams file (structure and
    every registry knob present, ``config.check_custom_params``) and, when
    a saved model is named, run the static pre-flight over it (the graph
    rules TMG1xx and the device shape pass TMG2xx on the ``meta``
    device), without reading any data or launching a kernel. Returns a
    process exit code; findings print one a line with their rule ids."""
    from . import lint
    from .runner import OpParams

    findings = []
    params = OpParams()
    if params_path:
        params = _load_params(params_path, "check")
        if params is None:
            return 1
        for key, msg in config.check_custom_params(params.custom_params):
            findings.append(lint.Finding(
                "TMG001", f"params file: {msg}",
                location=f"{params_path}:customParams.{key}"))
        suppress = _suppressed(params, suppress)
    model_dir = model_location or params.model_location
    if model_dir and os.path.isdir(model_dir):
        _populate_stage_registry()
        from .workflow import WorkflowModel
        model = WorkflowModel.load(model_dir)
        findings.extend(model.validate(device=device, suppress=suppress))
    elif model_dir:
        print(f"check: no saved model at {model_dir!r} — graph/device "
              "pre-flight skipped (params-only check)")
    for f in findings:
        print(f.format())
    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = sum(1 for f in findings if f.severity == "warning")
    print(f"check: {n_err} error(s), {n_warn} warning(s), "
          f"{len(findings) - n_err - n_warn} info(s)")
    try:
        lint.enforce(findings, fail_on=fail_on)
    except lint.LintError:
        return 1
    return 0


def run_plan(params_path: Optional[str] = None,
             model_location: Optional[str] = None,
             cost_db: Optional[str] = None, as_json: bool = False,
             suppress: Sequence[str] = ()) -> int:
    """The ``plan`` subcommand: build and render a saved model's
    :class:`~transmogrifai_tpu_torch.planner.ExecutionPlan` standalone —
    no data is read and nothing is launched. Prints the plan report (or
    its JSON with ``--json``) and the TMG4xx advisories, muting the
    params file's ``lintSuppress`` rules (and ``--suppress``) as ``check``
    and the runner do; returns a process exit code."""
    from . import lint, planner
    from .runner import OpParams

    params = OpParams()
    if params_path:
        params = _load_params(params_path, "plan")
        if params is None:
            return 1
        suppress = _suppressed(params, suppress)
    db_path = (cost_db or config.raw_param(params.custom_params, "costDb")
               or planner.default_cost_db_path(config.raw_param(
                   params.custom_params, "compileCacheDir")))
    db = planner.CostDatabase.load(db_path)
    model_dir = model_location or params.model_location
    if not model_dir or not os.path.isdir(model_dir):
        print(f"plan: no saved model at {model_dir!r} — pass --model or "
              "set modelLocation in the params file")
        return 1
    _populate_stage_registry()
    from .workflow import WorkflowModel
    model = WorkflowModel.load(model_dir)
    plan = planner.plan_model(model, cost_db=db)
    if as_json:
        print(json.dumps(plan.to_json(), indent=1, sort_keys=True))
    else:
        print(plan.report())
    for f in lint._apply_suppress(list(plan.findings()), suppress):
        print(f.format())
    return 0


def _on_sighup_roll(sup) -> None:
    """SIGHUP starts ``sup.rolling_restart()`` on a thread (one at a time)
    and reports its end on stdout."""
    import time

    from . import fleet as fleet_mod
    rolling: List[threading.Thread] = []

    def roll() -> None:
        t0 = time.perf_counter()
        try:
            sup.rolling_restart()
        except fleet_mod.FleetError as e:
            print(f"fleet: rolling restart failed: {e}", flush=True)
            return
        print(f"fleet: rolling restart done in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    def on_hup(*_: Any) -> None:
        if rolling and rolling[-1].is_alive():
            return                   # one rolling restart at a time
        t = threading.Thread(target=roll, name="fleet-rolling-restart",
                             daemon=True)
        rolling.append(t)
        t.start()

    try:
        signal.signal(signal.SIGHUP, on_hup)
    except ValueError:
        pass                         # not the main thread


def run_trace(action: str, trace_dir: str, out: Optional[str] = None,
              strict: bool = False, baseline: Optional[str] = None,
              top_k: int = 5, threshold: float = 0.25) -> int:
    """The ``trace`` subcommand.

    ``merge`` stitches the per-process shards a run or a fleet wrote into
    ``traceDir`` into ONE Perfetto-loadable file, clock offsets aligned,
    one process row per (role, pid). Unreadable shards are reported on
    stderr, and ``--strict`` makes any skipped shard a non-zero exit.

    ``analyze`` rebuilds each request's critical path across processes
    from a shard directory or a merged ``.json`` file
    (``workload.analyze_trace``): per-phase self-time with p50/p99,
    per-request coverage, the top-K slowest requests with their paths,
    and with ``--baseline`` (an earlier analysis JSON) a thresholded
    regression diff that exits non-zero on a regression::

        python -m transmogrifai_tpu_torch trace merge <dir> [-o merged.json] [--strict]
        python -m transmogrifai_tpu_torch trace analyze <dir-or-merged.json> \\
            [-o analysis.json] [--top-k N] [--baseline prev.json] [--threshold F]
    """
    from . import telemetry
    from . import workload as workload_mod

    if action == "analyze":
        try:
            doc = workload_mod.analyze_trace(trace_dir, top_k=top_k)
        except (OSError, ValueError) as e:
            print(f"trace analyze: {e}")
            return 1
        cov = doc["coverage"]
        print(f"trace analyze: {doc['requests']} request trace(s) "
              f"({doc['skippedTraces']} non-request skipped), e2e "
              f"p50 {doc['e2e']['p50Ms']} ms / p99 "
              f"{doc['e2e']['p99Ms']} ms, coverage min "
              f"{cov['min']} mean {cov['mean']}")
        for name, ph in doc["phases"].items():
            print(f"  {name:<24} p50 {ph['p50Ms']:>9} ms  "
                  f"p99 {ph['p99Ms']:>9} ms  share {ph['share']}")
        for r in doc["slowest"]:
            path_s = " -> ".join(p["name"] for p in r["path"])
            print(f"  slow {r['e2eMs']:>9} ms  {r['traceId'][:8]}  "
                  f"{path_s}")
        if out:
            workload_mod.write_merged_workload(doc, out)
            print(f"trace analyze: analysis -> {out}")
        if baseline:
            try:
                with open(baseline) as fh:
                    base = json.load(fh)
            except (OSError, ValueError) as e:
                print(f"trace analyze: cannot load baseline "
                      f"{baseline!r}: {e}")
                return 1
            diff = workload_mod.diff_analyses(doc, base,
                                              threshold=threshold)
            for v in diff["verdicts"]:
                print(f"  baseline {v['phase']:<24} "
                      f"{v['verdict']:<10} p99 "
                      f"{v.get('currentP99Ms')} ms vs "
                      f"{v.get('baselineP99Ms')} ms")
            if not diff["ok"]:
                print(f"trace analyze: {diff['regressions']} phase "
                      f"regression(s) beyond +{threshold:.0%}",
                      file=sys.stderr)
                return 1
            print("trace analyze: no regressions vs baseline")
        return 0
    if action != "merge":
        print(f"trace: unknown action {action!r} "
              "(expected 'merge' or 'analyze')")
        return 1
    out = out or os.path.join(trace_dir, "merged.trace.json")
    try:
        doc = telemetry.write_merged_trace(trace_dir, out)
    except (OSError, ValueError) as e:
        print(f"trace merge: {e}")
        return 1
    spans = sum(1 for ev in doc["traceEvents"] if ev.get("ph") == "X")
    traces = {ev["args"]["trace_id"] for ev in doc["traceEvents"]
              if isinstance(ev.get("args"), dict)
              and ev["args"].get("trace_id")}
    print(f"trace merge: {doc['mergedShards']} shard(s), {spans} "
          f"span(s), {len(traces)} distinct trace id(s) -> {out}")
    errors = doc.get("mergeErrors", ())
    if errors:
        print(f"trace merge: {len(errors)} shard(s) skipped as "
              "unreadable:", file=sys.stderr)
        for err in errors:
            print(f"trace merge: skipped shard: {err}", file=sys.stderr)
        if strict:
            print("trace merge: failing (--strict)", file=sys.stderr)
            return 1
    return 0


def run_workload(action: str, path: str, out: Optional[str] = None,
                 url: Optional[str] = None, speed: float = 1.0,
                 strict: bool = False, parity_tol: float = 1e-4,
                 timeout_s: float = 30.0,
                 duration_s: Optional[float] = None,
                 max_requests: Optional[int] = None) -> int:
    """The ``workload`` subcommand.

    ``merge`` stitches the per-process ``shard-*.workload.jsonl`` files a
    recorded run wrote into ``workloadDir`` into one arrival-ordered
    workload file (clock offsets aligned; a request's router and worker
    records combined); torn records are skipped and counted, unreadable
    shards are reported on stderr (non-zero under ``--strict``).

    ``replay`` drives a merged workload open-loop against a live server
    or fleet router at the recorded (or ``--speed``-scaled) arrival
    offsets, checks score parity where payloads and outputs were
    recorded (non-zero exit on a parity failure), and prints the same
    decomposed-latency summary as the recording::

        python -m transmogrifai_tpu_torch workload merge <dir> [-o merged.workload.json] [--strict]
        python -m transmogrifai_tpu_torch workload replay <merged.workload.json> \\
            --url http://127.0.0.1:8000 [--speed X] [--parity-tol F]
    """
    from . import workload as workload_mod

    if action == "merge":
        try:
            doc = workload_mod.merge_workload_shards(path)
        except (OSError, ValueError) as e:
            print(f"workload merge: {e}")
            return 1
        out = out or os.path.join(path, "merged.workload.json")
        workload_mod.write_merged_workload(doc, out)
        summary = workload_mod.summarize_workload(doc)
        print(f"workload merge: {doc['mergedShards']} shard(s), "
              f"{doc['requests']} request(s) over "
              f"{summary['durationS']}s, "
              f"{doc['tornRecordsSkipped']} torn record(s) skipped "
              f"-> {out}")
        for m, ent in summary["models"].items():
            print(f"  {m}: {ent['requests']} request(s), "
                  f"{ent['rows']} row(s), {ent['failed']} failed")
        errors = doc.get("mergeErrors", ())
        if errors:
            print(f"workload merge: {len(errors)} shard(s) skipped "
                  "as unreadable:", file=sys.stderr)
            for err in errors:
                print(f"workload merge: skipped shard: {err}",
                      file=sys.stderr)
            if strict:
                print("workload merge: failing (--strict)",
                      file=sys.stderr)
                return 1
        return 0
    if action != "replay":
        print(f"workload: unknown action {action!r} "
              "(expected 'merge' or 'replay')")
        return 1
    if not url:
        print("workload replay: --url is required (a serve worker or "
              "fleet router base URL)")
        return 1
    try:
        if os.path.isdir(path):
            doc = workload_mod.merge_workload_shards(path)
        else:
            doc = workload_mod.load_workload(path)
    except (OSError, ValueError) as e:
        print(f"workload replay: {e}")
        return 1
    recorded = workload_mod.summarize_workload(doc)
    try:
        result = workload_mod.replay_workload(
            doc, url, speed=speed, timeout_s=timeout_s,
            parity_tol=parity_tol, duration_s=duration_s,
            max_requests=max_requests)
    except (OSError, ValueError) as e:
        print(f"workload replay: {e}")
        return 1
    # late sends mean the replayer could not hold the recorded arrival
    # process, and the leg's latency split is suspect
    print(f"workload replay: {result['sent']}/{result['requests']} "
          f"request(s) re-driven at {speed:g}x in "
          f"{result['durationS']}s ({result['skippedNoPayload']} "
          f"skipped without payload, {result['truncated']} truncated, "
          f"{result['failed']} failed, "
          f"{result['lateSends']} late send(s))")
    print(f"  parity: {result['parityChecked']} checked, "
          f"{result['parityFailures']} failure(s), max |delta| "
          f"{result['parityMaxAbsDelta']:.3g}")
    for m, ent in result["models"].items():
        rec_ph = (recorded["models"].get(m) or {}).get("phases", {})
        print(f"  {m}:")
        for ph, cur in ent.get("phases", {}).items():
            rec = rec_ph.get(ph)
            rec_s = (f"recorded p50 {rec['p50Ms']} ms"
                     if rec else "not recorded")
            print(f"    {ph:<16} p50 {cur['p50Ms']:>9} ms  p95 "
                  f"{cur['p95Ms']:>9} ms  ({rec_s})")
    if out:
        workload_mod.write_merged_workload(
            {"recorded": recorded, "replayed": result}, out)
        print(f"workload replay: summary -> {out}")
    if result["parityFailures"]:
        print(f"workload replay: score parity FAILED on "
              f"{result['parityFailures']} request(s) "
              f"(tolerance {parity_tol:g})", file=sys.stderr)
        return 1
    return 0


def run_lint(paths: Sequence[str] = (), fail_on: str = "warning",
             stale_markers: bool = True, tests_check: bool = True) -> int:
    """The ``lint`` subcommand: the repo rules over this package's tree
    (or the given paths) — the per-line TMG3xx pass
    (``repo_lint/tmoglint.py``) and the whole-program TMG8xx pass
    (``repo_lint/concurrency_lint.py``, whose TMG805 reads the
    repository's ``tests/test_torch_*.py``). Same exit-code contract as
    ``check``: findings print one a line, non-zero when any reaches
    ``fail_on``."""
    from . import lint as lint_mod
    from .repo_lint import concurrency_lint, tmoglint
    paths = [os.path.abspath(p) for p in paths] or [tmoglint.PACKAGE_DIR]
    tests_dir = concurrency_lint.TESTS_DIR
    findings = list(tmoglint.lint_paths(paths, stale_markers=stale_markers))
    findings.extend(concurrency_lint.lint_paths(
        paths,
        tests_dir=tests_dir if tests_check and os.path.isdir(tests_dir)
        else None,
        stale_markers=stale_markers))
    findings.sort(key=lambda f: f.location or "")
    for f in findings:
        print(f.format())
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in ("error", "warning", "info")}
    print(f"lint: {counts['error']} error(s), "
          f"{counts['warning']} warning(s), {counts['info']} info(s)")
    try:
        lint_mod.enforce(findings, fail_on=fail_on)
    except lint_mod.LintError:
        return 1
    return 0


def build_server_from_params(params, device=None,
                             preload: bool = False) -> Any:
    """Build (but do not serve HTTP on) a
    :class:`~transmogrifai_tpu_torch.server.ModelServer` on ``device``
    (None: the card) from an OpParams. ``preload`` loads every tenant now
    instead of on its first request.

    The roster: ``customParams.serveModels`` (``{name: dir}`` or ``{name:
    {"model": dir, "bank": export_dir}}``), plus a ``default`` tenant when
    ``modelLocation`` is set (its program bank at ``customParams.serveBank``
    when given), plus every model of ``customParams.registryDir`` with a
    promoted version. Every knob goes through the registry
    (``config.py``), so a malformed value names its key before any model
    loads. The flight recorder (``workloadDir``) and continuous training
    (``retrainOnDrift``) are wired by ``run_serve``
    (:func:`build_retrain_controllers`)."""
    from . import server as server_mod
    from .runner import _bool_custom_param, _numeric_custom_param

    deadline_ms = _numeric_custom_param(
        params, "serveBatchDeadlineMs", server_mod.DEFAULT_BATCH_DEADLINE_MS)
    max_queue = _numeric_custom_param(params, "serveMaxQueue",
                                      server_mod.DEFAULT_MAX_QUEUE)
    max_models = _numeric_custom_param(params, "serveMaxModels",
                                       server_mod.DEFAULT_MAX_MODELS)
    capacity_mb = _numeric_custom_param(params, "serveCapacityMB")
    slo_ms = _numeric_custom_param(params, "serveSloMs")
    bucket_cap = _numeric_custom_param(params, "serveBucketCap")
    # the lifecycle: registryDir attaches the versioned registry (its
    # promoted models serve and resolve the pointer again on reload),
    # driftWindow turns the drift sentinel on, canaryFraction is deploy's
    # default routing fraction
    drift_window = _numeric_custom_param(params, "driftWindow")
    adapt = _bool_custom_param(params, "adaptDeadline", default=False)
    drift_js = _numeric_custom_param(params, "driftJsThreshold")
    canary_frac = _numeric_custom_param(params, "canaryFraction")
    if canary_frac is not None and not 0 < canary_frac <= 1:
        raise ValueError("customParams.canaryFraction must be in (0, 1], "
                         f"got {canary_frac!r}")
    registry = None
    reg_dir = config.string_param(params.custom_params, "registryDir")
    if reg_dir:
        from .lifecycle import ModelRegistry
        registry = ModelRegistry(str(reg_dir))
    kw: Dict[str, Any] = {}
    if drift_js is not None:
        kw["drift_js_threshold"] = drift_js
    if canary_frac is not None:
        kw["canary_fraction"] = canary_frac
    srv = server_mod.ModelServer(
        max_models=max_models,
        capacity_bytes=(None if capacity_mb is None
                        else int(capacity_mb * (1 << 20))),
        batch_deadline_s=deadline_ms / 1e3,
        max_queue=max_queue, slo_ms=slo_ms, bucket_cap=bucket_cap,
        registry=registry, drift_window=drift_window,
        adapt_deadline=bool(adapt), device=device, **kw)

    roster = config.raw_param(params.custom_params, "serveModels", {})
    if not isinstance(roster, dict):
        srv.shutdown(drain=False)
        raise ValueError(
            "customParams.serveModels must be {name: modelDir} or "
            f"{{name: {{'model': dir, 'bank': dir}}}}, got {roster!r}")
    _populate_stage_registry()
    try:
        for name, spec in roster.items():
            if isinstance(spec, str):
                srv.register(str(name), model_dir=spec, preload=preload)
            elif isinstance(spec, dict) and spec.get("model"):
                srv.register(str(name), model_dir=str(spec["model"]),
                             bank_dir=(str(spec["bank"])
                                       if spec.get("bank") else None),
                             preload=preload)
            else:
                raise ValueError(
                    f"customParams.serveModels[{name!r}] must be a model "
                    f"dir or {{'model': dir, 'bank': dir}}, got {spec!r}")
        if params.model_location:
            bank = config.string_param(params.custom_params, "serveBank")
            srv.register("default", model_dir=params.model_location,
                         bank_dir=str(bank) if bank else None,
                         preload=preload)
        if registry is not None:
            # every model with a promoted version serves, resolving the
            # pointer again on each reload
            for name in registry.models():
                if registry.current(name) and name not in srv.models():
                    srv.register_from_registry(name, preload=preload)
        if not srv.models():
            raise ValueError(
                "serve: no models — set modelLocation, "
                "customParams.serveModels or a promoted registry model "
                "(customParams.registryDir) in the params file")
    except BaseException:  # lint: broad-except — stops the half-built server and re-raises
        srv.shutdown(drain=False)
        raise
    return srv


def build_retrain_controllers(params, srv) -> List[Any]:
    """Wire continuous training onto a built server when
    ``customParams.retrainOnDrift`` asks for it: one
    :class:`~transmogrifai_tpu_torch.continual.RetrainController` per
    tenant with a promoted registry version, recovered (crashed jobs
    repaired, storm controls restored) and attached to the tenant's drift
    windows. In a fleet every worker runs this; the shared ACTIVE flock in
    the registry's job directory lets exactly one of them retrain, and the
    others see the promote through the pointer. A malformed knob raises a
    ``ValueError`` naming it."""
    from . import continual
    from .runner import _bool_custom_param, _numeric_custom_param

    if not _bool_custom_param(params, "retrainOnDrift", default=False):
        return []
    registry = srv.registry
    if registry is None:
        raise ValueError(
            "customParams.retrainOnDrift needs customParams.registryDir "
            "(the retrain loop registers into the versioned registry)")
    if not srv.drift_window:
        raise ValueError(
            "customParams.retrainOnDrift needs customParams.driftWindow "
            "(the drift sentinel is the loop's trigger)")
    cmd = config.raw_param(params.custom_params, "retrainCmd")
    try:
        cmd = continual.validate_retrain_cmd(cmd)
    except continual.ContinualError as e:
        raise ValueError(
            f"customParams.retrainOnDrift needs customParams.retrainCmd "
            f"(the TMOG_RETRAIN_* environment contract): {e}") from None
    kw: Dict[str, Any] = {}
    for key, arg in (("retrainArmWindows", "arm_windows"),
                     ("retrainCooldownS", "cooldown_s"),
                     ("retrainMaxFailures", "max_failures"),
                     ("retrainTimeoutS", "timeout_s"),
                     ("canaryFraction", "canary_fraction")):
        v = _numeric_custom_param(params, key)
        if v is not None:
            kw[arg] = v
    # the retrain subprocess writes its trace shard into the same traceDir
    trace_dir = config.string_param(params.custom_params, "traceDir")
    if trace_dir:
        kw["trace_dir"] = trace_dir
    controllers = []
    for name in srv.models():
        if not registry.current(name):
            continue            # no promoted stable version to retrain
        c = continual.RetrainController(name, registry, cmd, server=srv,
                                        **kw)
        c.recover()
        c.attach()
        controllers.append(c)
    if not controllers:
        raise ValueError(
            "retrainOnDrift: no registry-promoted tenant to attach the "
            "retrain loop to")
    return controllers


def _start_workload_recorder(params, default_role: str) -> Optional[str]:
    """Install the workload flight recorder when
    ``customParams.workloadDir`` is set (``workloadMaxMb``,
    ``workloadPayloads``); the caller stops it on exit. Returns the shard
    directory, or None when recording is off. A malformed knob raises a
    ``ValueError`` naming it."""
    from . import telemetry
    from . import workload as workload_mod
    from .runner import _bool_custom_param, _numeric_custom_param
    wl_dir = config.string_param(params.custom_params, "workloadDir")
    if wl_dir is None:
        return None
    max_mb = _numeric_custom_param(params, "workloadMaxMb",
                                   workload_mod.DEFAULT_MAX_MB)
    payloads = _bool_custom_param(params, "workloadPayloads", default=True)
    role = os.environ.get(telemetry.TRACE_ROLE_ENV, default_role)
    workload_mod.start_recorder(str(wl_dir), role=role, max_mb=max_mb,
                                payloads=payloads)
    return str(wl_dir)


def run_registry(action: str, registry_dir: str,
                 model: Optional[str] = None,
                 model_dir: Optional[str] = None,
                 bank: Optional[str] = None,
                 version: Optional[str] = None,
                 promote: bool = False, as_json: bool = False) -> int:
    """The ``registry`` subcommand over ``lifecycle.ModelRegistry``:
    ``list`` the versions and the current pointer, ``register`` an
    exported model (version id: the program bank's state digest),
    ``promote`` / ``rollback`` the atomic pointer, print ``current``."""
    from .lifecycle import ModelRegistry, RegistryError

    reg = ModelRegistry(registry_dir)
    try:
        if action == "list":
            names = [model] if model else reg.models()
            doc = {n: reg.status(n) for n in names}
            if as_json:
                print(json.dumps(doc, indent=1, default=str))
            else:
                for n, st in doc.items():
                    print(f"{n}: current={st['current']} "
                          f"previous={st['previous']}")
                    for rec in st["versions"]:
                        mark = "*" if rec["version"] == st["current"] \
                            else " "
                        print(f"  {mark} {rec['version']}  "
                              f"model={rec['modelDir']}  "
                              f"bank={rec['bankDir']}")
                if not doc:
                    print("registry: empty")
            return 0
        if not model:
            print(f"registry {action}: --model is required")
            return 1
        if action == "register":
            if not model_dir:
                print("registry register: --model-dir is required")
                return 1
            vid = reg.register(model, model_dir, bank_dir=bank,
                               version=version, promote=promote)
            print(f"registered {model} version {vid}"
                  + (" (promoted)" if promote else ""))
            return 0
        if action == "promote":
            if not version:
                print("registry promote: --version is required")
                return 1
            ptr = reg.promote(model, version)
            print(f"{model}: current={ptr['current']} "
                  f"(was {ptr['previous']})")
            return 0
        if action == "rollback":
            prev = reg.rollback(model)
            print(f"{model}: rolled back to {prev}")
            return 0
        if action == "current":
            print(reg.current(model))
            return 0
    except RegistryError as e:
        print(f"registry {action}: {e}")
        return 1
    print(f"registry: unknown action {action!r}")
    return 1


def run_serve(params_path: Optional[str] = None,
              model_location: Optional[str] = None,
              port: Optional[int] = None, host: str = "127.0.0.1",
              block: bool = True, port_file: Optional[str] = None,
              device=None, preload: bool = False) -> int:
    """The ``serve`` subcommand: the params file's roster in a
    multi-tenant :class:`~transmogrifai_tpu_torch.server.ModelServer` on
    ``device`` (None or "cuda": the card; "cpu" when the caller asks for
    it), served by the stdlib HTTP front end until SIGINT or SIGTERM (the
    fleet supervisor's rolling-restart signal), then drained: every
    accepted request is scored before exit. ``port_file`` receives the
    bound port atomically once listening (``--port 0``). ``serveMetrics``
    turns telemetry on for ``/metrics``; ``traceDir`` makes this process
    write a trace shard there on drain; ``workloadDir`` records every
    ``:score`` request into a workload shard there; ``retrainOnDrift``
    arms continuous training on the registry's tenants. ``preload`` loads
    every tenant before the port is bound and the port file written, so
    the first ``/readyz`` 200 means a loaded worker (the fleet's
    workers)."""
    from . import server as server_mod
    from . import telemetry
    from . import workload as workload_mod
    from .runner import OpParams, _bool_custom_param, _numeric_custom_param

    params = OpParams()
    if params_path:
        params = _load_params(params_path, "serve")
        if params is None:
            return 1
    if model_location:
        params.model_location = model_location
    workload_dir = None
    try:
        serve_metrics = _bool_custom_param(params, "serveMetrics",
                                           default=False)
        trace_dir = config.string_param(params.custom_params, "traceDir")
        if serve_metrics or trace_dir:
            telemetry.enable()
        if trace_dir and telemetry.TRACE_ROLE_ENV not in os.environ:
            telemetry.set_trace_role("worker")
        workload_dir = _start_workload_recorder(params, "worker")
        srv = build_server_from_params(params, device=device,
                                       preload=preload)
        try:
            controllers = build_retrain_controllers(params, srv)
            if port is None:
                port = _numeric_custom_param(params, "servePort", 8000)
        except BaseException:  # lint: broad-except — stops the built server and re-raises
            srv.shutdown(drain=False)
            raise
    except (ValueError, KeyError) as e:
        if workload_dir:
            workload_mod.stop_recorder()
        print(f"serve: {e}")
        return 1
    if controllers:
        print(f"serve: continuous training armed for "
              f"{[c.name for c in controllers]} "
              f"(job records under {controllers[0].job_dir})", flush=True)
    stop = threading.Event()
    if block:
        # the handler is in place before the port file tells a supervisor
        # where to find this worker
        try:
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
        except ValueError:
            pass         # not the main thread: Ctrl-C still works
    httpd = server_mod.serve_http(srv, host=host, port=int(port))
    bound = httpd.server_address
    if port_file:
        _write_port_file(port_file, bound[1])
    print(f"serve: {len(srv.models())} model(s) "
          f"({', '.join(srv.models())}) on http://{bound[0]}:{bound[1]} "
          "— POST /v1/models/<name>:score, GET /stats; Ctrl-C/SIGTERM "
          "drains and exits", flush=True)
    if not block:        # the caller drives the server directly
        return 0
    try:
        while not stop.is_set():
            stop.wait(_SIGNAL_POLL_S)
        print("serve: SIGTERM — draining in-flight requests ...",
              flush=True)
    except KeyboardInterrupt:
        print("serve: draining in-flight requests ...", flush=True)
    finally:
        # drain the server first (/healthz answers 503 at once, so a fleet
        # router stops sending; queued futures resolve while the HTTP loop
        # can still answer them), then stop the listener
        srv.shutdown(drain=True)
        httpd.shutdown()
        if workload_dir:
            # drain the recorder's queue and close this process's shard
            workload_mod.stop_recorder()
        if trace_dir:
            try:
                telemetry.write_trace_shard(str(trace_dir))
            except OSError:
                print(f"serve: trace shard write to {trace_dir!r} "
                      "failed", flush=True)
    return 0


def _write_port_file(path: str, port: int) -> None:
    """The bound port, written atomically: never a half-written port."""
    tmp = str(path) + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(str(port))
    os.replace(tmp, path)


def run_fleet(params_path: Optional[str] = None,
              workers: Optional[int] = None,
              base_port: Optional[int] = None,
              port: Optional[int] = None, host: str = "127.0.0.1",
              block: bool = True, port_file: Optional[str] = None,
              device: str = "cuda") -> int:
    """The ``fleet`` subcommand: N ``serve`` worker processes over the
    params file's shared registry and program banks, each on ``device``
    ("cuda", the card, unless the caller asks for "cpu"), respawned with
    jittered backoff when they crash, behind the consistent-hash failover
    router (``fleet.py``). Knobs: ``customParams.fleetWorkers``,
    ``fleetBasePort``, ``workerRespawnMax``, ``routerRetryBudget`` (the
    flags win). ``port_file`` receives the router's bound port once it
    listens. SIGHUP drains and restarts every worker, one at a time
    (``FleetSupervisor.rolling_restart``: the fleet-wide deploy of a
    promoted pointer, losing no request); SIGTERM stops the router and
    drains every worker; ``block=False`` starts the fleet, waits for a
    ready worker and stops it again."""
    from . import fleet as fleet_mod
    from . import telemetry
    from . import workload as workload_mod
    from .runner import _bool_custom_param, _numeric_custom_param

    if not params_path:
        print("fleet: a params file is required (the workers load "
              "their roster from it)")
        return 1
    params = _load_params(params_path, "fleet")
    if params is None:
        return 1
    try:
        if workers is not None and int(workers) < 1:
            # an explicit 0 is a configuration error, not "use the knob"
            raise ValueError(f"--workers must be >= 1, got {workers}")
        if device not in fleet_mod.WORKER_DEVICES:
            raise ValueError(f"--device must be one of "
                             f"{fleet_mod.WORKER_DEVICES}, got "
                             f"{device!r}")
        n = int(workers) if workers is not None else _numeric_custom_param(
            params, "fleetWorkers", fleet_mod.DEFAULT_WORKERS)
        bp = base_port if base_port is not None else \
            _numeric_custom_param(params, "fleetBasePort")
        respawn_max = _numeric_custom_param(
            params, "workerRespawnMax", fleet_mod.DEFAULT_RESPAWN_MAX)
        retry_budget = _numeric_custom_param(
            params, "routerRetryBudget", fleet_mod.DEFAULT_RETRY_BUDGET)
        if port is None:
            port = _numeric_custom_param(params, "servePort", 8000)
        # the router is the fleet's trace entry point: with a traceDir it
        # records its routing spans and writes the "router" shard beside
        # the workers'; serveMetrics alone turns its fleet.* counters on
        trace_dir = config.string_param(params.custom_params, "traceDir")
        serve_metrics = _bool_custom_param(params, "serveMetrics",
                                           default=False)
        # the router records the fleet side of every routed request
        # (routing decision, failovers, the client's outcome) beside the
        # workers' shards; `workload merge` combines the two
        workload_dir = _start_workload_recorder(params, "router")
    except ValueError as e:
        print(f"fleet: {e}")
        return 1
    if trace_dir or serve_metrics:
        telemetry.enable()
    if trace_dir and telemetry.TRACE_ROLE_ENV not in os.environ:
        telemetry.set_trace_role("router")
    stop = threading.Event()
    if block:
        try:
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
        except ValueError:
            pass
    sup = fleet_mod.FleetSupervisor(params_path, workers=n, base_port=bp,
                                    respawn_max=respawn_max, device=device)
    if block:
        _on_sighup_roll(sup)
    httpd = None
    try:
        sup.start()
        try:
            sup.wait_ready(min_workers=1)
        except fleet_mod.FleetError as e:
            print(f"fleet: {e}")
            return 1
        httpd = fleet_mod.serve_fleet_http(sup, host=host, port=int(port),
                                           retry_budget=retry_budget)
        bound = httpd.server_address
        if port_file:
            _write_port_file(port_file, bound[1])
        print(f"fleet: {n} worker(s) on {device} behind "
              f"http://{bound[0]}:{bound[1]} — POST "
              "/v1/models/<name>:score, GET /stats; Ctrl-C/SIGTERM drains "
              f"the fleet and exits (worker logs: {sup.log_dir})",
              flush=True)
        if block:
            try:
                while not stop.is_set():
                    stop.wait(_SIGNAL_POLL_S)
            except KeyboardInterrupt:
                pass
            print("fleet: draining workers ...", flush=True)
    finally:
        if httpd is not None:
            httpd.shutdown()
        sup.stop(drain=httpd is not None)
        if workload_dir:
            # the workers closed their shards on their drain; the
            # router's records complete the merge set
            workload_mod.stop_recorder()
        if trace_dir:
            try:
                telemetry.write_trace_shard(str(trace_dir))
            except OSError:
                print(f"fleet: trace shard write to {trace_dir!r} "
                      "failed", flush=True)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .fleet import WORKER_DEVICES
    ap = argparse.ArgumentParser(prog="transmogrifai_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    gen = sub.add_parser("gen", help="scaffold a project from a CSV")
    gen.add_argument("--input", required=True, help="CSV with header")
    gen.add_argument("--response", required=True)
    gen.add_argument("--id", dest="id_column")
    gen.add_argument("--name", default="OpApp")
    gen.add_argument("--output", required=True)
    chk = sub.add_parser(
        "check", help="static pre-flight: validate a params file and/or "
                      "a saved model without reading data")
    chk.add_argument("params", nargs="?", help="OpParams json/yaml file")
    chk.add_argument("--model", dest="model_location",
                     help="saved WorkflowModel directory (default: the "
                          "params file's modelLocation)")
    chk.add_argument("--fail-on", choices=("error", "warning"),
                     default="error",
                     help="exit non-zero when findings reach this "
                          "severity (default: error)")
    chk.add_argument("--no-device", action="store_true",
                     help="skip the device shape pre-flight on the meta "
                          "device (TMG2xx rules)")
    chk.add_argument("--suppress", action="append", default=[],
                     metavar="RULE", help="mute a rule id (repeatable)")
    lnt = sub.add_parser(
        "lint", help="repo self-lint of this package's tree: per-line "
                     "TMG3xx rules plus the whole-program TMG8xx "
                     "concurrency & crash-safety pass")
    lnt.add_argument("paths", nargs="*",
                     help="files/directories to lint (default: the "
                          "installed transmogrifai_tpu_torch package)")
    lnt.add_argument("--fail-on", choices=("error", "warning"),
                     default="warning", dest="lint_fail_on",
                     help="exit non-zero when findings reach this "
                          "severity (default: warning — the repo "
                          "self-lint is zero-tolerance)")
    lnt.add_argument("--no-stale-markers", action="store_true",
                     help="skip TMG399 stale-suppression detection")
    lnt.add_argument("--no-tests-check", action="store_true",
                     help="skip the TMG805 fault-site test-coverage "
                          "cross-check")
    pln = sub.add_parser(
        "plan", help="cost-based whole-DAG execution plan for a saved "
                     "model: tiers, dead columns, CSE — no data read, "
                     "nothing launched")
    pln.add_argument("params", nargs="?", help="OpParams json/yaml file")
    pln.add_argument("--model", dest="model_location",
                     help="saved WorkflowModel directory (default: the "
                          "params file's modelLocation)")
    pln.add_argument("--cost-db", dest="cost_db", metavar="PATH",
                     help="measured cost database (default: "
                          "customParams.costDb, else alongside "
                          "compileCacheDir)")
    pln.add_argument("--json", action="store_true",
                     help="print the plan's JSON form instead of the "
                          "text report")
    pln.add_argument("--suppress", action="append", default=[],
                     metavar="RULE", help="mute a TMG4xx advisory rule "
                                          "id (repeatable)")
    srv = sub.add_parser("serve", help="multi-tenant model server over "
                                       "the params file's roster (stdlib "
                                       "HTTP; SIGTERM drains)")
    srv.add_argument("params", nargs="?", help="OpParams json/yaml file")
    srv.add_argument("--model", dest="model_location")
    srv.add_argument("--port", type=int, default=None)
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port-file", dest="port_file", metavar="PATH")
    srv.add_argument("--device", choices=WORKER_DEVICES, default="cuda",
                     help="the device the server scores on (default: "
                          "cuda, the card)")
    srv.add_argument("--preload", action="store_true",
                     help="load every tenant before listening (a fleet "
                          "worker answers /readyz only once loaded)")
    flt = sub.add_parser("fleet", help="supervised serve workers behind "
                                       "the consistent-hash failover "
                                       "router")
    flt.add_argument("params", nargs="?", help="OpParams json/yaml file")
    flt.add_argument("--workers", type=int, default=None)
    flt.add_argument("--base-port", dest="base_port", type=int,
                     default=None)
    flt.add_argument("--port", type=int, default=None)
    flt.add_argument("--host", default="127.0.0.1")
    flt.add_argument("--port-file", dest="port_file", metavar="PATH",
                     help="write the router's bound port here")
    flt.add_argument("--device", choices=WORKER_DEVICES, default="cuda",
                     help="every worker's device (default: cuda, the "
                          "card)")
    trc = sub.add_parser(
        "trace", help="merge the per-process trace shards a run wrote "
                      "into one Perfetto file, or analyze each request's "
                      "critical path")
    trc.add_argument("action", choices=("merge", "analyze"))
    trc.add_argument("trace_dir", metavar="DIR",
                     help="the traceDir the run wrote shards into")
    trc.add_argument("-o", "--out", default=None,
                     help="output path (merge default: "
                          "DIR/merged.trace.json; analyze: the analysis "
                          "JSON)")
    trc.add_argument("--strict", action="store_true",
                     help="merge: exit non-zero when any shard was "
                          "skipped as unreadable")
    trc.add_argument("--top-k", dest="top_k", type=int, default=5)
    trc.add_argument("--baseline", default=None, metavar="JSON")
    trc.add_argument("--threshold", type=float, default=0.25)
    wlp = sub.add_parser("workload", help="workload flight-recorder "
                                          "tooling: merge the shards, "
                                          "replay with score parity")
    wlp.add_argument("action", choices=("merge", "replay"))
    wlp.add_argument("path", metavar="DIR_OR_FILE")
    wlp.add_argument("-o", "--out", default=None)
    wlp.add_argument("--strict", action="store_true")
    wlp.add_argument("--url", default=None)
    wlp.add_argument("--speed", type=float, default=1.0)
    wlp.add_argument("--parity-tol", dest="parity_tol", type=float,
                     default=1e-4)
    wlp.add_argument("--timeout", dest="timeout_s", type=float,
                     default=30.0)
    wlp.add_argument("--duration-s", dest="duration_s", type=float,
                     default=None)
    wlp.add_argument("--max-requests", dest="max_requests", type=int,
                     default=None)
    tun = sub.add_parser(
        "tune", help="offline autotuner: search the registry-declared "
                     "tunable knobs by re-driving a recorded workload "
                     "against a server (or fleet) booted per candidate, "
                     "score parity asserted on every leg; writes "
                     "params.tuned.json and a byte-stable report")
    tun.add_argument("params", help="baseline OpParams json/yaml file")
    tun.add_argument("--workload", required=True, metavar="DIR_OR_FILE")
    tun.add_argument("-o", "--out", default=None)
    tun.add_argument("--report", default=None)
    tun.add_argument("--budget-s", dest="budget_s", type=float,
                     default=120.0)
    tun.add_argument("--objective", choices=("p99", "throughput"),
                     default="p99")
    tun.add_argument("--knobs", default=None)
    tun.add_argument("--speed", type=float, default=1.0)
    tun.add_argument("--parity-tol", dest="parity_tol", type=float,
                     default=1e-4)
    tun.add_argument("--duration-s", dest="duration_s", type=float,
                     default=None)
    tun.add_argument("--max-requests", dest="max_requests", type=int,
                     default=None)
    tun.add_argument("--device", choices=WORKER_DEVICES, default="cuda",
                     help="the device every leg's server (or fleet "
                          "worker) scores on (default: cuda, the card)")
    reg = sub.add_parser("registry", help="versioned model registry: "
                                          "list / register / promote / "
                                          "rollback / current")
    reg.add_argument("action",
                     choices=("list", "register", "promote", "rollback",
                              "current"))
    reg.add_argument("--registry", required=True, metavar="DIR")
    reg.add_argument("--model")
    reg.add_argument("--model-dir", dest="reg_model_dir")
    reg.add_argument("--bank")
    reg.add_argument("--version")
    reg.add_argument("--promote", action="store_true")
    reg.add_argument("--json", action="store_true", dest="reg_json")
    args = ap.parse_args(argv)
    if args.cmd == "check":
        return run_check(args.params, model_location=args.model_location,
                         fail_on=args.fail_on, device=not args.no_device,
                         suppress=args.suppress)
    if args.cmd == "lint":
        return run_lint(args.paths, fail_on=args.lint_fail_on,
                        stale_markers=not args.no_stale_markers,
                        tests_check=not args.no_tests_check)
    if args.cmd == "plan":
        return run_plan(args.params, model_location=args.model_location,
                        cost_db=args.cost_db, as_json=args.json,
                        suppress=args.suppress)
    if args.cmd == "trace":
        return run_trace(args.action, args.trace_dir, out=args.out,
                         strict=args.strict, baseline=args.baseline,
                         top_k=args.top_k, threshold=args.threshold)
    if args.cmd == "serve":
        return run_serve(args.params, model_location=args.model_location,
                         port=args.port, host=args.host,
                         port_file=args.port_file, device=args.device,
                         preload=args.preload)
    if args.cmd == "fleet":
        return run_fleet(args.params, workers=args.workers,
                         base_port=args.base_port, port=args.port,
                         host=args.host, port_file=args.port_file,
                         device=args.device)
    if args.cmd == "workload":
        return run_workload(args.action, args.path, out=args.out,
                            url=args.url, speed=args.speed,
                            strict=args.strict, parity_tol=args.parity_tol,
                            timeout_s=args.timeout_s,
                            duration_s=args.duration_s,
                            max_requests=args.max_requests)
    if args.cmd == "registry":
        return run_registry(args.action, args.registry, model=args.model,
                            model_dir=args.reg_model_dir, bank=args.bank,
                            version=args.version, promote=args.promote,
                            as_json=args.reg_json)
    if args.cmd == "tune":
        from .tuner import run_tune
        return run_tune(args.params, workload=args.workload,
                        out=args.out, budget_s=args.budget_s,
                        objective=args.objective, knobs=args.knobs,
                        report=args.report, speed=args.speed,
                        parity_tol=args.parity_tol,
                        duration_s=args.duration_s,
                        max_requests=args.max_requests, device=args.device)
    files = generate_project(args.input, args.response, args.output,
                             name=args.name, id_column=args.id_column)
    for f, p in files.items():
        print(f"generated {p}")
    return 0


if __name__ == "__main__":   # pragma: no cover
    raise SystemExit(main())
