"""The port's runner (``transmogrifai_tpu_torch/runner.py``) beside the JAX
package's: Train → Score → Evaluate → Features on the CPU with the same
records, the metrics documents' keys, stage-parameter overrides, the
``OpApp`` entry, the written CSV, a workflow with the RawFeatureFilter
and workflow-level CV (the filter's verdict in Train's metrics), and what
is not ported raising with its ROADMAP queue A item."""
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
#: not ported (all ROADMAP queue A, item 6: continual, fleet, lifecycle,
#: parallel/mesh and multi-host, pipeline, resilience, server, telemetry's
#: MFU, workload, config's effective knobs)
NOT_PORTED = {"continual", "effectiveConfig", "fleet", "lifecycle",
              "mesh", "mfu", "pipeline", "process", "resilience", "server",
              "workload"}
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
        app.main(["--run-type", "Train", "--trace-out", "x"])


def test_the_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wf, _label, _pred = _flow(PFB, ptransmogrify, PS, PLR, PWorkflow)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OpWorkflowRunner(wf)


UNPORTED = {
    "streaming": (lambda r, p: r.run(RunType.STREAMING_SCORE, p), "item 6"),
    "trace": (lambda r, p: r.run(RunType.TRAIN, OpParams(
        trace_location="t.json")), "item 6"),
    "prometheus": (lambda r, p: r.run(RunType.TRAIN, OpParams(
        metrics_format="prometheus")), "item 6"),
    "quarantine": (lambda r, p: r.run(RunType.TRAIN, OpParams(
        quarantine_location="q.jsonl")), "item 6"),
    "mesh": (lambda r, p: r.run(RunType.TRAIN, OpParams(
        custom_params={"meshDevices": 4})), "item 6"),
    "yaml": (lambda r, p: OpParams.from_file("p.yaml"), "item 6"),
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_parts_raise_naming_their_item(what, tmp_path):
    """Nothing of the JAX runner is silently ignored: each part not
    ported raises NotImplementedError naming its ROADMAP queue A item."""
    runner, params, _pred = _port_runner(_records(n=60), tmp_path)
    call, item = UNPORTED[what]
    with pytest.raises(NotImplementedError, match=f"queue A,? {item}"):
        call(runner, params)


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
