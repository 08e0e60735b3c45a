"""The port's runner (``transmogrifai_tpu_torch/runner.py``) beside the JAX
package's: Train → Score → Evaluate → Features on the CPU with the same
records, the metrics documents' keys, stage-parameter overrides, the
``OpApp`` entry, the written CSV, a workflow with the RawFeatureFilter
and workflow-level CV (the filter's verdict in Train's metrics), and what
StreamingScore, the quarantine sink and YAML parameter files running and
writing what they write, and the mesh knobs in a world of one process."""
import csv
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.evaluators import Evaluators as JEv
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JS
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.runner import OpParams as JOpParams
from transmogrifai_tpu.runner import OpWorkflowRunner as JRunner
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.evaluators import Evaluators as PEv
from transmogrifai_tpu_torch.models.linear import \
    LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PS
from transmogrifai_tpu_torch.ops.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.runner import (OpApp, OpParams,
                                            OpWorkflowRunner, RunType)
from transmogrifai_tpu_torch.utils import uid as puid

#: metrics-document blocks of the JAX package's runner whose modules are
#: not ported: none (the mesh and multi-host blocks came with parallel/)
NOT_PORTED = set()
RUNS = (RunType.TRAIN, RunType.SCORE, RunType.EVALUATE, RunType.FEATURES)


class _ListReader:
    def __init__(self, records):
        self._records = records

    def read_records(self):
        return list(self._records)


def _records(n=200, seed=42):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(float)
    x = rng.normal(size=n) + y
    return [{"label": float(y[i]), "x": float(x[i])} for i in range(n)]


def _flow(FB, transmogrify, S, LR, W):
    label = FB.RealNN("label").from_column().as_response()
    fx = FB.Real("x").from_column().as_predictor()
    vec = transmogrify([fx])
    sel = S.with_cross_validation(num_folds=2, families=[LR()],
                                  splitter=None, seed=5)
    pred = label.transform_with(sel, vec)
    return W().set_result_features(pred), label, pred


def _port_runner(records, tmp_path, **kw):
    puid.reset()
    wf, label, pred = _flow(PFB, ptransmogrify, PS, PLR, PWorkflow)
    reader = _ListReader(records)
    runner = OpWorkflowRunner(
        wf, training_reader=reader, scoring_reader=reader,
        evaluator=PEv.BinaryClassification.auPR().set_columns(label, pred),
        device="cpu", dtype=torch.float64, **kw)
    params = OpParams(model_location=str(tmp_path / "model"),
                      metrics_location=str(tmp_path / "metrics.json"),
                      write_location=str(tmp_path / "scores.csv"))
    return runner, params, pred


def test_train_score_evaluate_features_and_the_metrics_keys(tmp_path):
    """Each run type on the CPU; every metrics document has the JAX
    package's keys for the same run, but for the unported blocks."""
    records = _records()
    runner, params, pred = _port_runner(records, tmp_path)
    juid.reset()
    jwf, jlabel, jpred = _flow(JFB, jtransmogrify, JS, JLR, JWorkflow)
    jreader = _ListReader(records)
    jrunner = JRunner(jwf, training_reader=jreader, scoring_reader=jreader,
                      evaluator=JEv.BinaryClassification.auPR()
                      .set_columns(jlabel, jpred))
    jtmp = tmp_path / "jax"
    jparams = JOpParams(model_location=str(jtmp / "model"),
                        metrics_location=str(jtmp / "metrics.json"),
                        write_location=str(jtmp / "scores.csv"))
    outs = {}
    for run_type in RUNS:
        out = runner.run(run_type, params)
        want = set(jrunner.run(run_type, jparams).metrics) - NOT_PORTED
        assert set(out.metrics) == want, run_type
        assert json.load(open(params.metrics_location)).keys() == want
        outs[run_type] = out
    assert os.path.exists(os.path.join(params.model_location, "model.json"))
    train = outs[RunType.TRAIN].metrics
    assert "fitSeconds" in train["stageMetrics"][pred.origin_stage.uid]
    # the pre-flight and the plan ran by default, as in the JAX package
    jtrain = jrunner.run(RunType.TRAIN, jparams).metrics
    assert train["preflight"] == jtrain["preflight"] \
        == {"findings": 0, "failOn": "error"}
    assert set(train["plan"]) == set(jtrain["plan"])
    assert train["plan"]["counts"]["stages"] \
        == jtrain["plan"]["counts"]["stages"]
    # the model server's, the lifecycle's and the operations tier's
    # tallies, with the JAX keys
    for block in ("server", "lifecycle", "continual", "fleet", "workload"):
        assert set(train[block]) == set(jtrain[block]), block
    assert outs[RunType.SCORE].metrics["rowsScored"] == len(records)
    assert outs[RunType.FEATURES].metrics["rows"] == len(records)
    # the same model as the JAX package's: AuPR within 1e-9 (f64)
    want_aupr = jrunner.run(RunType.EVALUATE, jparams).metrics["AuPR"]
    assert abs(outs[RunType.EVALUATE].metrics["AuPR"] - want_aupr) < 1e-9
    assert outs[RunType.EVALUATE].metrics["AuPR"] > 0.6


def test_written_csv_equals_the_scores(tmp_path):
    records = _records(n=90)
    runner, params, pred = _port_runner(records, tmp_path)
    runner.run(RunType.TRAIN, params)
    scores = runner.run(RunType.SCORE, params).scores
    with open(params.write_location, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == scores.names() == [pred.name]
    col = scores[pred.name]
    assert len(rows) == len(records) + 1
    for i, (cell,) in enumerate(rows[1:]):
        assert cell == str(col.get_raw(i))


def test_stage_param_overrides(tmp_path):
    """``stageParams`` from a JSON file reach the stages by class name."""
    p = tmp_path / "params.json"
    p.write_text(json.dumps({
        "stageParams": {"SanityChecker": {"min_variance": 0.123}},
        "customParams": {"tag": "run1"}}))
    params = OpParams.from_file(str(p))
    assert params.custom_params["tag"] == "run1"
    assert params.to_json()["stageParams"] == {
        "SanityChecker": {"min_variance": 0.123}}
    label = PFB.RealNN("label").from_column().as_response()
    fx = PFB.Real("x").from_column().as_predictor()
    checked = label.transform_with(SanityChecker(), ptransmogrify([fx]))
    sel = PS.with_cross_validation(num_folds=2, families=[PLR()],
                                   splitter=None)
    wf = PWorkflow().set_result_features(label.transform_with(sel, checked))
    params.apply_to_workflow(wf)
    assert checked.origin_stage.min_variance == 0.123


class _App(OpApp):
    def __init__(self, runner_obj):
        self._runner = runner_obj

    def runner(self, params):
        return self._runner


def test_op_app_main(tmp_path):
    records = _records()
    runner, _params, _pred = _port_runner(records, tmp_path)
    app = _App(runner)
    out = app.main(["--run-type", "Train", "--quiet",
                    "--model-location", str(tmp_path / "m"),
                    "--metrics-location", str(tmp_path / "met.json")])
    assert out.run_type == "Train"
    assert os.path.exists(str(tmp_path / "met.json"))
    (tmp_path / "p.json").write_text(json.dumps(
        {"modelLocation": str(tmp_path / "m")}))
    out = app.main(["--run-type", "Score", "--quiet", "--params",
                    str(tmp_path / "p.json"), "--write-location",
                    str(tmp_path / "s.csv")])
    assert out.metrics["rowsScored"] == len(records)
    assert os.path.exists(str(tmp_path / "s.csv"))
    with pytest.raises(SystemExit):
        app.main(["--run-type", "Train", "--no-such-flag", "x"])


def test_the_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wf, _label, _pred = _flow(PFB, ptransmogrify, PS, PLR, PWorkflow)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OpWorkflowRunner(wf)


UNPORTED = {
    "mesh": (lambda r, p: r.run(RunType.TRAIN, OpParams(
        custom_params={"meshDevices": 4})), "n_devices=4"),
    "mesh-devices flag": (lambda r, p: _App(r).main(
        ["--run-type", "Train", "--quiet", "--mesh-devices", "2"]),
        "n_devices=2"),
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_parts_raise_naming_their_item(what, tmp_path):
    """The mesh knobs, once unported, reach ``make_mesh``: in a world of
    one process a mesh of more ranks raises the ValueError naming the
    world's rank count and ``torchrun`` (the flag runs for real under the
    spawned world of ``tests/test_torch_multihost.py``), and nothing
    initializes ``torch.distributed``."""
    import torch.distributed as dist
    runner, params, _pred = _port_runner(_records(n=60), tmp_path)
    call, n = UNPORTED[what]
    with pytest.raises(ValueError, match=rf"{n} exceeds the world's 1 "
                       r"rank\(s\).*torchrun"):
        call(runner, params)
    assert not dist.is_initialized()


#: the telemetry requests that raised before telemetry was ported: each
#: now runs, with the sink it asks for written
TELEMETRY_SINKS = {
    "trace": lambda t: dict(trace_location=str(t / "run.trace.json")),
    "prometheus": lambda t: dict(metrics_format="prometheus"),
    "telemetry": lambda t: dict(custom_params={"telemetry": True}),
    "traceDir": lambda t: dict(custom_params={"traceDir": str(t / "tr")}),
}


@pytest.mark.parametrize("what", sorted(TELEMETRY_SINKS))
def test_telemetry_requests_run_and_write_their_sinks(what, tmp_path):
    """``traceLocation``, ``metricsFormat: "prometheus"``,
    ``customParams.telemetry`` and ``customParams.traceDir`` run a Train
    with telemetry on for the run: the trace file, the Prometheus text,
    the document's telemetry blocks or the shard is written, and the
    run leaves telemetry off."""
    from transmogrifai_tpu_torch import telemetry
    runner, params, _pred = _port_runner(_records(n=60), tmp_path)
    for k, v in TELEMETRY_SINKS[what](tmp_path).items():
        setattr(params, k, v)
    out = runner.run(RunType.TRAIN, params)
    assert out.metrics["telemetry"]["fittedStages"] == 2
    assert out.metrics["telemetryMetrics"] == {}   # no fused pass here
    if what == "trace":
        doc = json.load(open(tmp_path / "run.trace.json"))
        assert "run:Train" in {e["name"] for e in doc["traceEvents"]}
    elif what == "prometheus":
        text = open(params.metrics_location).read()
        assert "# TYPE run_appSeconds gauge" in text.splitlines()
        assert telemetry.parse_prometheus(text)
    elif what == "traceDir":
        (shard,) = os.listdir(tmp_path / "tr")
        assert shard.startswith("shard-run-train-")
    else:
        assert json.load(open(params.metrics_location))["telemetry"][
            "runType"] == RunType.TRAIN
    assert not telemetry.enabled()


#: a malformed value of each out-of-core knob (ROADMAP C2)
STREAM_KNOBS = ("streamFit", "streamFitPasses", "rssCapMb")


@pytest.mark.parametrize("value", ["yes", 0, -1])
@pytest.mark.parametrize("key", STREAM_KNOBS)
def test_malformed_out_of_core_knobs_raise_naming_the_key(key, value,
                                                          tmp_path):
    """``streamFit`` (a tri-state), ``streamFitPasses`` (an integer >= 1)
    and ``rssCapMb`` (a number >= 1) are validated on every run, in both
    packages, before anything is read."""
    runner, params, _pred = _port_runner(_records(n=60), tmp_path)
    params.custom_params[key] = value
    with pytest.raises(ValueError, match=f"customParams.{key}"):
        runner.run(RunType.TRAIN, params)
    juid.reset()
    jwf, _jl, _jp = _flow(JFB, jtransmogrify, JS, JLR, JWorkflow)
    jrunner = JRunner(jwf, training_reader=_ListReader(_records(n=60)))
    with pytest.raises(ValueError, match=f"customParams.{key}"):
        jrunner.run(RunType.TRAIN, JOpParams(custom_params={key: value}))


def test_valid_out_of_core_knobs_change_nothing(tmp_path):
    """With no directory reader a valid ``streamFit: true`` and its
    budget train the same model as without them, as in the JAX
    package."""
    records = _records(n=60)
    runner, params, pred = _port_runner(records, tmp_path)
    base = runner.run(RunType.TRAIN, params).model
    params.custom_params.update(streamFit=True, streamFitPasses=2,
                                rssCapMb=512.5)
    again = runner.run(RunType.TRAIN, params).model
    for name in ("prediction", "probability"):
        assert np.array_equal(
            getattr(base.score(records, device="cpu")[pred.name], name),
            getattr(again.score(records, device="cpu")[pred.name], name))


def test_parameters_reach_the_saved_model_in_both_packages(tmp_path):
    """``Workflow.set_parameters`` (ROADMAP C3) is carried into
    ``WorkflowModel.parameters`` and its save; each package loads the
    other's save with the same parameters. The pre-flight is
    ``validate``, as in the JAX package, and ``check`` is gone."""
    from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    want = {"owner": "team-a", "version": 3, "tags": ["x", "y"]}
    records = _records(n=60)
    puid.reset()
    wf, _label, _pred = _flow(PFB, ptransmogrify, PS, PLR, PWorkflow)
    assert wf.set_parameters(want) is wf
    assert not hasattr(wf, "check") and wf.validate() == []
    pm = wf.set_input_records(records).train(device="cpu",
                                             dtype=torch.float64)
    assert pm.parameters == want
    assert not hasattr(pm, "check") and pm.validate(device=True) == []
    pm.save(str(tmp_path / "port"))
    juid.reset()
    jwf, _jl, _jp = _flow(JFB, jtransmogrify, JS, JLR, JWorkflow)
    jm = jwf.set_parameters(want).set_input_records(records).train()
    jm.save(str(tmp_path / "jax"))
    assert jm.parameters == want
    assert JWorkflowModel.load(str(tmp_path / "port")).parameters == want
    assert WorkflowModel.load(str(tmp_path / "jax")).parameters == want
    assert WorkflowModel.load(str(tmp_path / "port")).parameters == want


def _guarded_flow(FB, transmogrify, S, LR, W, RFF):
    """``_flow`` with a second predictor that is never filled and the
    SanityChecker, behind the RawFeatureFilter (which blacklists
    ``dead``) and workflow-level CV (which refits the SanityChecker in
    each fold)."""
    label = FB.RealNN("label").from_column().as_response()
    fx = FB.Real("x").from_column().as_predictor()
    dead = FB.Real("dead").from_column().as_predictor()
    sel = S.with_cross_validation(num_folds=2, families=[LR()],
                                  splitter=None, seed=5)
    pred = label.transform_with(sel, label.sanity_check(
        transmogrify([fx, dead])))
    wf = (W().set_result_features(pred)
          .with_raw_feature_filter(RFF(min_fill=0.10)).with_workflow_cv())
    return wf, label, pred


def _guarded_runners(tmp_path):
    from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
    from transmogrifai_tpu_torch.filters import RawFeatureFilter as PRFF
    records = [dict(r, dead=None) for r in _records()]
    out = []
    for pkg, (FB, tm, S, LR, W, RFF, Runner, Params, Ev, uid, kw) in (
            ("jax", (JFB, jtransmogrify, JS, JLR, JWorkflow, JRFF, JRunner,
                     JOpParams, JEv, juid, {})),
            ("port", (PFB, ptransmogrify, PS, PLR, PWorkflow, PRFF,
                      OpWorkflowRunner, OpParams, PEv, puid,
                      {"device": "cpu", "dtype": torch.float64}))):
        uid.reset()
        wf, label, pred = _guarded_flow(FB, tm, S, LR, W, RFF)
        reader = _ListReader(records)
        runner = Runner(wf, training_reader=reader, scoring_reader=reader,
                        evaluator=Ev.BinaryClassification.auPR()
                        .set_columns(label, pred), **kw)
        params = Params(model_location=str(tmp_path / pkg / "model"))
        out.append((runner, params, pred))
    return out


def test_runner_reports_raw_feature_filter(tmp_path):
    """Train's ``rawFeatureFilter`` block is the filter's summary, equal to
    the JAX runner's (``dead`` excluded); without a filter it is None."""
    (jr, jp, _), (pr, pp, _) = _guarded_runners(tmp_path)
    want = jr.run(RunType.TRAIN, jp).metrics["rawFeatureFilter"]
    got = pr.run(RunType.TRAIN, pp).metrics["rawFeatureFilter"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["excluded"] == ["dead"] and got["featuresChecked"] == 2
    runner, params, _pred = _port_runner(_records(n=60), tmp_path / "plain")
    assert runner.run(RunType.TRAIN, params).metrics[
        "rawFeatureFilter"] is None


def test_runner_trains_with_workflow_cv(tmp_path):
    """Train under workflow-level CV through the runner: the saved model's
    selector summary is a ``WorkflowCV:`` one with the JAX runner's fold
    metrics (within 1e-9), the model loads with the filter's results, and
    Evaluate gives the JAX runner's AuPR."""
    from transmogrifai_tpu_torch import WorkflowModel
    (jr, jp, jpred), (pr, pp, ppred) = _guarded_runners(tmp_path)
    jm = jr.run(RunType.TRAIN, jp).metrics
    pm = pr.run(RunType.TRAIN, pp).metrics
    uid = ppred.origin_stage.uid
    jv = jm["stages"][uid]["validationResults"]
    pv = pm["stages"][uid]["validationResults"]
    assert pv["validationType"] == jv["validationType"] == \
        "WorkflowCV:CrossValidation"
    np.testing.assert_allclose(pv["results"][0]["metricPerFold"],
                               jv["results"][0]["metricPerFold"], rtol=0,
                               atol=1e-9)
    loaded = WorkflowModel.load(pp.model_location)
    assert [r.name for r in loaded.rff_results.exclusion_reasons
            if r.excluded] == ["dead"]
    want = jr.run(RunType.EVALUATE, jp).metrics["AuPR"]
    assert abs(pr.run(RunType.EVALUATE, pp).metrics["AuPR"] - want) < 1e-9


def _scores_of(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _run_streaming(runner, params, tmp_path, records):
    """StreamingScore over the records in batches of 25 with a sink: every
    row written as Score writes it."""
    runner.run(RunType.TRAIN, params)
    params.write_location = str(tmp_path / "stream.csv")
    params.quarantine_location = str(tmp_path / "dead.jsonl")
    params.custom_params.update(batchSize=25, pipelineWorkers=2)
    out = runner.run(RunType.STREAMING_SCORE, params)
    assert out.metrics["rowsScored"] == len(records)
    assert out.metrics["batches"] == -(-len(records) // 25)
    assert out.metrics["quarantinedBatches"] == 0
    params.write_location = str(tmp_path / "score.csv")
    runner.run(RunType.SCORE, params)
    assert _scores_of(tmp_path / "stream.csv") \
        == _scores_of(tmp_path / "score.csv")


def _run_quarantine(runner, params, tmp_path, records):
    """A poison batch (an injected ``stream.score_batch`` fault on the
    second) lands in ``quarantineLocation`` with its records; the run
    scores the rest and counts it in both blocks."""
    from transmogrifai_tpu_torch import resilience
    runner.run(RunType.TRAIN, params)
    params.quarantine_location = str(tmp_path / "dead.jsonl")
    params.write_location = str(tmp_path / "stream.csv")
    params.custom_params.update(batchSize=20)
    plan = resilience.FaultPlan().on("stream.score_batch", at=[1])
    with resilience.fault_plan(plan):
        out = runner.run(RunType.STREAMING_SCORE, params)
    assert out.metrics["quarantinedBatches"] == 1
    assert out.metrics["resilience"]["quarantined_batches"] == 1
    assert out.metrics["rowsScored"] == len(records) - 20
    (entry,) = resilience.Quarantine(params.quarantine_location).entries()
    assert entry["index"] == 1 and entry["records"] == records[20:40]
    assert resilience.get_quarantine() is None      # the run's sink is gone


def _run_yaml(runner, params, tmp_path, records):
    """A YAML parameter file reads as the same JSON file does, in both
    packages, and drives a Train."""
    yaml = pytest.importorskip("yaml")
    doc = {"modelLocation": params.model_location,
           "metricsLocation": params.metrics_location,
           "customParams": {"streamFitPasses": 1, "plan": False},
           "stageParams": {}}
    (tmp_path / "p.yaml").write_text(yaml.safe_dump(doc))
    (tmp_path / "p.json").write_text(json.dumps(doc))
    got = OpParams.from_file(str(tmp_path / "p.yaml"))
    assert got == OpParams.from_file(str(tmp_path / "p.json"))
    assert got.to_json() == JOpParams.from_file(
        str(tmp_path / "p.yaml")).to_json()
    out = runner.run(RunType.TRAIN, got)
    assert out.metrics["plan"] is None
    assert json.load(open(params.metrics_location))["rawFeatureFilter"] \
        is None


FORMERLY_UNPORTED = {"streaming": _run_streaming,
                     "quarantine": _run_quarantine, "yaml": _run_yaml}


@pytest.mark.parametrize("what", sorted(FORMERLY_UNPORTED))
def test_formerly_unported_parts_run_and_write(what, tmp_path):
    """StreamingScore, the quarantine sink and YAML parameter files (they
    raised "not ported" until their modules came) each run and write what
    they write."""
    records = _records(n=60)
    runner, params, _pred = _port_runner(records, tmp_path)
    FORMERLY_UNPORTED[what](runner, params, tmp_path, records)


def test_streaming_score_metrics_keys_equal_the_jax_runners(tmp_path):
    """StreamingScore's metrics document has the JAX runner's keys (but
    the unported blocks) and the same counts; a malformed key is named
    before anything is read, in both packages."""
    records = _records(n=90)
    runner, params, _pred = _port_runner(records, tmp_path)
    juid.reset()
    jwf, jlabel, jpred = _flow(JFB, jtransmogrify, JS, JLR, JWorkflow)
    jrunner = JRunner(jwf, training_reader=_ListReader(records),
                      scoring_reader=_ListReader(records))
    jparams = JOpParams(model_location=str(tmp_path / "jax" / "model"),
                        custom_params={"batchSize": 40})
    jrunner.run(RunType.TRAIN, jparams)
    runner.run(RunType.TRAIN, params)
    params.custom_params["batchSize"] = 40
    want = jrunner.run(RunType.STREAMING_SCORE, jparams).metrics
    got = runner.run(RunType.STREAMING_SCORE, params).metrics
    assert set(got) == set(want) - NOT_PORTED
    for key in ("rowsScored", "batches", "batchSize", "overlap",
                "quarantinedBatches", "quarantinedFiles"):
        assert got[key] == want[key], key
    for key, bad in (("maxBatches", 0), ("timeoutS", -1.0),
                     ("overlap", "yes"), ("pipelineWorkers", "two"),
                     ("onBatchError", "drop")):
        p = OpParams(model_location=params.model_location,
                     custom_params={key: bad})
        with pytest.raises(ValueError, match=key):
            runner.run(RunType.STREAMING_SCORE, p)


def test_random_param_builder_grids_equal_the_jax_packages():
    """The same seed gives the same grid points as the JAX package's
    builder, and a family takes them as its grid."""
    from transmogrifai_tpu.models.tuning import RandomParamBuilder as JB
    from transmogrifai_tpu_torch.models import RandomParamBuilder as PB

    def build(B, seed):
        return (B(seed=seed).exponential("regParam", 1e-4, 1e-1)
                .uniform("elasticNetParam", 0.0, 1.0)
                .choice("fitIntercept", [True, False]).build(25))

    for seed in (1, 42):
        assert build(PB, seed) == build(JB, seed)
    grid = build(PB, 1)
    assert {g["fitIntercept"] for g in grid} == {True, False}
    with pytest.raises(ValueError, match="positive"):
        PB().exponential("regParam", 0.0, 1.0)
    with pytest.raises(ValueError, match="at least one"):
        PB().choice("x", [])
    fam = PLR(grid=[{k: g[k] for k in ("regParam", "elasticNetParam")}
                    for g in grid[:3]])
    assert len(list(fam.grid)) == 3
