"""The port's planner (``transmogrifai_tpu_torch/planner.py``, the scoring
engine's rewrites, the workflow's measured tiers, the temporal route's
hint and the runner's plan step) beside the JAX package's on the same
seeded fixtures: the same pruned indices and CSE merges; plan JSON
byte-identical across runs; planned scores bitwise equal to unplanned in
the port and within 1e-12 of the JAX package's (f64); Titanic's pruning at
a small grid; each package reading the other's cost database, a corrupt
one giving TMG404; measured tiers deciding and changing no fitted value;
the runner stamping ``plan`` and persisting the database."""
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu import planner as jplanner
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JS
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import aot, lint, planner, temporal
from transmogrifai_tpu_torch import workflow as pworkflow
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.models import _hist
from transmogrifai_tpu_torch.models.linear import \
    LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PS
from transmogrifai_tpu_torch.planner import CostDatabase, ExecutionPlan
from transmogrifai_tpu_torch.runner import (OpParams, OpWorkflowRunner,
                                            RunType)
from transmogrifai_tpu_torch.utils import uid as puid

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SIDE = (JFB, jtransmogrify, JS, JLR, JWorkflow, juid, False)
PORT_SIDE = (PFB, ptransmogrify, PS, PLR, PWorkflow, puid, True)


def _records(n=300, seed=42):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(float)
    cats = ["a", "b", "c"]
    return [{"label": float(y[i]),
             "x": float(rng.normal() + 2 * y[i]),
             "junk": 0.0,
             "c": cats[int(rng.integers(0, 3))]} for i in range(n)]


def _pruning_cse_model(side, dup_pivot=True, scaler=False, recs=None):
    """A fitted workflow with a constant ``junk`` feature (the
    SanityChecker drops its columns: dead columns) and, with
    ``dup_pivot``, two identical pivots of one feature (a CSE merge);
    ``scaler`` puts the vector standard scaler between the combiner and
    the SanityChecker."""
    FB, transmogrify, S, LR, W, uid, port = side
    uid.reset()
    label = FB.RealNN("label").from_column().as_response()
    fx = FB.Real("x").from_column().as_predictor()
    fj = FB.Real("junk").from_column().as_predictor()
    fc = FB.PickList("c").from_column().as_predictor()
    feats = [fx, fj] + ([fc.pivot(), fc.pivot()] if dup_pivot else [fc])
    vec = transmogrify(feats)
    if scaler:
        mod = ("transmogrifai_tpu_torch.ops.vectors" if port
               else "transmogrifai_tpu.ops.vectors")
        est = __import__(mod, fromlist=["x"]).StandardScalerEstimator
        vec = est().set_input(vec).get_output()
    checked = label.sanity_check(vec, remove_bad_features=True)
    sel = S.with_cross_validation(num_folds=2, families=[LR()],
                                  splitter=None, seed=5)
    pred = label.transform_with(sel, checked)
    recs = recs if recs is not None else _records()
    wf = W().set_input_records(recs).set_result_features(pred)
    model = (wf.train(device="cpu", dtype=torch.float64) if port
             else wf.train())
    return model, recs, pred


@pytest.fixture(scope="module")
def models():
    """The duplicated-pivot model in both packages (built once)."""
    jm, recs, jpred = _pruning_cse_model(JAX_SIDE)
    pm, _, ppred = _pruning_cse_model(PORT_SIDE)
    return jm, pm, recs, jpred, ppred


def _same(pred_a, pred_b):
    for c in ("prediction", "raw_prediction", "probability"):
        assert np.array_equal(getattr(pred_a, c), getattr(pred_b, c)), c


# ---------------------------------------------------------------------------
# the analyses against the JAX package's
# ---------------------------------------------------------------------------


def test_pruned_indices_and_cse_merges_equal_the_jax_packages(models):
    jm, pm, *_ = models
    jp, pp = jplanner.plan_model(jm), planner.plan_model(pm)
    assert {k: v.tolist() for k, v in pp.prune.items()} \
        == {k: v.tolist() for k, v in jp.prune.items()}
    assert pp.widths == jp.widths
    assert pp.cse == jp.cse and len(pp.cse) == 1
    assert pp.cse[0]["stage"] == "OneHotModel"
    assert pp.counts() == jp.counts()
    assert pp.counts()["prunedColumns"] > 0
    assert [(f.rule, f.severity, f.stage) for f in pp.findings()] \
        == [(f.rule, f.severity, f.stage) for f in jp.findings()]
    assert [(e.uid, e.stage, e.kind, e.tier) for e in pp.entries] \
        == [(e.uid, e.stage, e.kind, e.tier) for e in jp.entries]


def test_plan_json_and_report_byte_identical_across_runs(models, tmp_path):
    _jm, pm, *_ = models
    db = CostDatabase.load(str(tmp_path / "db.json"))
    planner.record_fit_costs(pm, db)
    db.save()
    p1 = planner.plan_model(pm, cost_db=db)
    p2 = planner.plan_model(pm, cost_db=CostDatabase.load(
        str(tmp_path / "db.json")))
    assert p1.report() == p2.report()
    assert json.dumps(p1.to_json(), sort_keys=True) \
        == json.dumps(p2.to_json(), sort_keys=True)
    rep = p1.report()
    assert "ExecutionPlan" in rep and "Stage tiers" in rep
    assert "Pruned dead columns" in rep and "CSE merges (1)" in rep


def test_plan_json_schema_is_the_jax_packages(models):
    jm, pm, *_ = models
    jd, pd = jplanner.plan_model(jm).to_json(), planner.plan_model(
        pm).to_json()
    assert set(pd) == set(jd) and set(pd["tiers"]) == set(jd["tiers"])
    assert pd["prunedColumns"] == jd["prunedColumns"]
    for a, b in zip(pd["stages"], jd["stages"]):
        assert set(a) == set(b)
    # with no measurement the engine tier is None, as in the JAX package
    assert pd["tiers"]["engine"] is None and pd["link"]["source"] == "prior"


def test_tmg403_state_mismatch_suppresses_the_merge_in_both():
    out = []
    for side in (JAX_SIDE, PORT_SIDE):
        model, *_ = _pruning_cse_model(side)
        pivots = [m for m in model.fitted_stages.values()
                  if type(m).__name__ == "OneHotModel"]
        assert len(pivots) == 2
        pivots[1].vocabs = [list(reversed(v)) for v in pivots[1].vocabs]
        mod = planner if side[-1] else jplanner
        plan = mod.plan_model(model)
        assert plan.cse == []
        f = next(f for f in plan.findings() if f.rule == "TMG403")
        assert "fitted state differs" in f.message and f.severity == "info"
        out.append(plan.cse_suppressed)
    assert out[0] == out[1]


def test_no_duplicate_no_merge_in_both():
    for side, mod in ((JAX_SIDE, jplanner), (PORT_SIDE, planner)):
        model, *_ = _pruning_cse_model(side, dup_pivot=False)
        assert mod.plan_model(model).cse == []


def test_liveness_with_an_unknown_width_keeps_the_combine_live():
    from types import SimpleNamespace

    from transmogrifai_tpu_torch.planner import _ALL, _device_liveness
    from transmogrifai_tpu_torch.scoring import _FusedStage

    def vec(uid):
        return SimpleNamespace(
            uid=uid, vector_metadata=lambda: SimpleNamespace(size=3))
    sel = SimpleNamespace(uid="s1", keep_indices=[3])
    items = [_FusedStage(vec("v1"), "vec", "v1o", []),
             _FusedStage(SimpleNamespace(uid="c1"), "combine", "co",
                         ["upload", "v1o"]),
             _FusedStage(sel, "select", "so", ["co"]),
             _FusedStage(SimpleNamespace(uid="p1"), "predict", "po",
                         ["so"])]
    live, _ = _device_liveness(items, ["po"])
    assert live["v1o"] is _ALL
    items[1] = _FusedStage(SimpleNamespace(uid="c1"), "combine", "co",
                           ["v0o", "v1o"])
    live, _ = _device_liveness([_FusedStage(vec("v0"), "vec", "v0o", [])]
                               + items, ["po"])
    assert live["v1o"] == {0} and live["v0o"] == set()


def test_cse_pass_tolerates_unparamable_stages():
    from types import SimpleNamespace

    from transmogrifai_tpu_torch.planner import _cse_pass
    from transmogrifai_tpu_torch.scoring import _FusedStage

    class NoParams:
        def __init__(self, uid):
            self.uid = uid
            self.input_features = (SimpleNamespace(name="x"),)

        def get_params(self):
            raise RuntimeError("no ctor capture")

    merges, _ = _cse_pass([_FusedStage(NoParams("a"), "vec", "ao", []),
                           _FusedStage(NoParams("b"), "vec", "bo", [])])
    assert merges == []


# ---------------------------------------------------------------------------
# the engine's rewrites
# ---------------------------------------------------------------------------


def test_planned_scores_bitwise_unplanned_and_the_jax_packages(models):
    jm, pm, recs, jpred, ppred = models
    base = pm.score(recs, device="cpu", engine=False)[ppred.name]
    plan = pm.plan()
    try:
        planned = pm.scoring_engine("cpu")
        unplanned = pm.scoring_engine("cpu", plan=None)
        assert planned._cse_alias and planned._prune
        assert planned.pruned_columns == plan.counts()["prunedColumns"]
        assert not unplanned._cse_alias and not unplanned._prune
        got = planned.score_store(recs)[ppred.name]
        _same(got, unplanned.score_store(recs)[ppred.name])
        _same(got, base)
        # the aliased twin contributes no prepared blocks
        _, prepared, _ = planned.host_blocks(
            pworkflow._raw_store(recs, planned._raw_features))
        assert len(prepared) == len(unplanned.host_blocks(
            pworkflow._raw_store(recs, unplanned._raw_features))[1]) - 1
        # the transform path materializes every column: pruning stands
        # down there and the columns stay bitwise
        tb = pm.transform(recs, device="cpu", engine=False)
        tp = planned.transform_store(recs)
        for cn in tb.names():
            vb = getattr(tb[cn], "values", None)
            if isinstance(vb, np.ndarray) and vb.dtype != object:
                assert np.array_equal(vb, np.asarray(tp[cn].values)), cn
        # the JAX package's planned engine, f64: within 1e-12
        jm.attach_plan(jplanner.plan_model(jm))
        want = jm.scoring_engine(gate_bandwidth=False).score_store(
            recs)[jpred.name]
        np.testing.assert_array_equal(got.prediction, want.prediction)
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=0, atol=1e-12)
    finally:
        pm.attach_plan(None)
        jm.attach_plan(None)


def test_pruning_parity_with_a_scaler_between_combine_and_select():
    pm, recs, pred = _pruning_cse_model(PORT_SIDE, scaler=True)
    unplanned = pm.scoring_engine("cpu", plan=None).score_store(recs)
    plan = pm.plan()
    assert plan.counts()["prunedColumns"] > 0
    eng = pm.scoring_engine("cpu")
    assert eng._prune and eng._scale_slice
    _same(eng.score_store(recs)[pred.name], unplanned[pred.name])


def test_disable_switches_pruning_off_where_it_cannot_remap(caplog):
    """A plan pruning a vectorizer whose value reaches the predictor with
    no select between: the engine logs why and runs unpruned, bitwise."""
    FB, transmogrify, S, LR, W, uid, _ = PORT_SIDE
    uid.reset()
    label = FB.RealNN("label").from_column().as_response()
    fx = FB.Real("x").from_column().as_predictor()
    pred = label.transform_with(S.with_cross_validation(
        num_folds=2, families=[LR()], splitter=None, seed=5),
        transmogrify([fx]))
    recs = _records(100)
    model = (W().set_input_records(recs).set_result_features(pred)
             .train(device="cpu", dtype=torch.float64))
    vec = next(m for m in model.fitted_stages.values()
               if type(m).__name__ == "NumericVectorizerModel")
    width = vec.vector_metadata().size
    plan = ExecutionPlan([], prune={vec.uid: np.arange(width - 1)},
                         widths={vec.uid: width})
    base = model.scoring_engine("cpu").score_store(recs)[pred.name]
    model.attach_plan(plan)
    with caplog.at_level(logging.WARNING,
                         logger="transmogrifai_tpu_torch.scoring"):
        eng = model.scoring_engine("cpu")
    assert not eng._prune and eng.pruned_columns == 0
    assert any("pruning disabled" in r.message for r in caplog.records)
    _same(eng.score_store(recs)[pred.name], base)


def test_engine_tier_decides_enabled_and_routing(models):
    _jm, pm, recs, _jpred, ppred = models
    plan = planner.plan_model(pm)
    try:
        plan.engine_tier = "host"
        assert not pm.attach_plan(plan).scoring_engine("cpu").enabled()
        assert not pm._use_engine(recs, True, torch.device("cpu"))
        plan.engine_tier = "device"
        assert pm.attach_plan(plan).scoring_engine("cpu").enabled()
        plan.engine_tier = None
        assert pm.attach_plan(plan).scoring_engine("cpu").enabled()
        base = pm.score(recs, device="cpu", engine=False)[ppred.name]
        plan.engine_tier = "host"
        pm.attach_plan(plan)
        _same(pm.score(recs, device="cpu", engine=True)[ppred.name], base)
    finally:
        pm.attach_plan(None)


def test_rewrite_digest_tells_plans_apart_and_a_bank_refuses(models):
    """A bank exported without a plan does not serve an engine under one
    (TMG501, the plan digest), and the planned program key differs."""
    _jm, pm, *_ = models
    unplanned = pm.scoring_engine("cpu", plan=None)
    planned = pm.scoring_engine("cpu", plan=planner.plan_model(pm))
    assert planned.rewrite_digest() != unplanned.rewrite_digest()
    assert planned.rewrite_digest() == pm.scoring_engine(
        "cpu", plan=planner.plan_model(pm)).rewrite_digest()
    manifest = {"formatVersion": aot.FORMAT_VERSION,
                "environment": aot.environment_fingerprint("cpu"),
                "planDigest": unplanned.rewrite_digest(),
                "stateDigest": unplanned.state_digest(),
                "outNames": unplanned._out_names(results_only=True),
                "bucketCap": unplanned.bucket_cap}
    assert aot._compat_findings(manifest, "b", engine=unplanned) == []
    found = aot._compat_findings(manifest, "b", engine=planned)
    assert [f.rule for f in found] == ["TMG501"]
    assert "plan digest" in found[0].message


def test_titanic_pruning_parity_at_a_small_grid():
    """The card's phase 14 (b) on the CPU: Titanic at one logistic
    regression point, the SanityChecker's drops pruned, planned scores
    bitwise equal to unplanned, the same pruned columns as the JAX
    package's example."""
    from transmogrifai_tpu_torch import titanic as TT
    from transmogrifai_tpu_torch.readers import DataReaders
    puid.reset()
    out = TT.run(num_folds=2, families=[PLR(grid=[
        {"regParam": 0.01, "elasticNetParam": 0.0}])], seed=42,
        device="cpu", dtype=torch.float64)
    model = out["model"]
    plan = planner.plan_model(model)
    assert plan.counts()["prunedColumns"] > 0
    store = DataReaders.simple.csv(
        TT.BUNDLED_CSV, TT.TITANIC_SCHEMA,
        key_fn=lambda r: r["id"]).generate_store(
        out["prediction"].raw_features())
    nm = out["prediction"].name
    base = model.score(store, device="cpu", engine=False)[nm]
    model.attach_plan(plan)
    _same(model.score(store, device="cpu", engine=True)[nm], base)

    sys.path.insert(0, os.path.join(_REPO, "examples"))
    try:
        from titanic import run as run_titanic
    finally:
        sys.path.pop(0)
    juid.reset()
    jout = run_titanic(num_folds=2, families=[JLR(grid=[
        {"regParam": 0.01, "elasticNetParam": 0.0}])], seed=42)
    jplan = jplanner.plan_model(jout["model"])
    assert plan.counts()["prunedColumns"] \
        == jplan.counts()["prunedColumns"]
    assert sorted(plan.widths.values()) == sorted(jplan.widths.values())


# ---------------------------------------------------------------------------
# measured tiers
# ---------------------------------------------------------------------------


def test_measured_chain_costs_decide_the_engine_tier(models):
    _jm, pm, *_ = models
    db = CostDatabase()
    db.record_chain(host_rows_per_s=1000.0, engine_rows_per_s=10000.0)
    assert planner.plan_model(pm, cost_db=db).engine_tier == "device"
    db.record_chain(host_rows_per_s=10000.0, engine_rows_per_s=1000.0)
    assert planner.plan_model(pm, cost_db=db).engine_tier == "host"
    # a measured link: the static estimates decide
    db2 = CostDatabase()
    db2.record_bandwidth(5000.0)
    p = planner.plan_model(pm, cost_db=db2)
    assert p.link_source == "measured" and p.engine_tier in ("host",
                                                             "device")


def test_tmg401_measured_slower_on_device_in_both(models):
    jm, pm, *_ = models
    out = []
    for mod, model in ((jplanner, jm), (planner, pm)):
        db = mod.CostDatabase()
        db.record_stage("NumericVectorizerModel", "host", 0.001, 1000)
        db.record_stage("NumericVectorizerModel", "device", 0.01, 1000)
        plan = mod.plan_model(model, cost_db=db)
        f = next(f for f in plan.findings() if f.rule == "TMG401")
        assert f.severity == "warning" and "slower on device" in f.message
        entry = next(e for e in plan.entries
                     if e.stage == "NumericVectorizerModel")
        assert entry.source == "measured"
        out.append((f.stage, entry.measured_s_per_krow))
    assert out[0] == out[1]


def test_fitstats_gate_follows_the_tier_hint_above_the_row_floor(
        monkeypatch):
    from transmogrifai_tpu_torch.columns import (ColumnStore,
                                                 column_from_values)
    from transmogrifai_tpu_torch.fitstats import LayerStatsPlan, StatRequest
    from transmogrifai_tpu_torch.types import feature_types as ft
    n = 64
    store = ColumnStore({"x": column_from_values(
        ft.Real, np.random.default_rng(7).normal(size=n))}, n)
    plan = LayerStatsPlan([StatRequest("mean", "x")], n_stages=2)
    monkeypatch.setattr(pworkflow, "FUSE_MIN_ROWS", n)
    assert plan._gate_device(store, "cpu") is False
    assert plan._gate_device(store, "cpu", "device") is True
    assert plan._gate_device(store, "cuda", "host") is False
    monkeypatch.setattr(pworkflow, "FUSE_MIN_ROWS", n + 1)
    assert plan._gate_device(store, "cpu", "device") is False
    monkeypatch.setattr(pworkflow, "FUSE_MIN_ROWS", n)
    host = plan.run(store, device=False, workflow_device="cpu",
                    dtype=torch.float64)
    hinted = plan.run(store, tier_hint="device", workflow_device="cpu",
                      dtype=torch.float64)
    assert plan.tier == "device"
    assert abs(hinted.value("mean", "x") - host.value("mean", "x")) < 1e-12


@pytest.mark.parametrize("tier", ["host", "device"])
def test_a_measured_tier_changes_no_fitted_value(tier, monkeypatch):
    """A workflow fitted under a plan whose fit tiers say ``tier`` (the
    row floor lowered so the tiers are contested): the same scores as
    the unplanned fit, bitwise for the layer transform's tier, within
    1e-12 for the statistics pass's."""
    monkeypatch.setattr(pworkflow, "FUSE_MIN_ROWS", 50)
    recs = _records(200)
    planner.drain_phase_observations(CostDatabase())
    scores = []
    for t in (None, tier):
        FB, transmogrify, S, LR, W, uid, _ = PORT_SIDE
        uid.reset()
        label = FB.RealNN("label").from_column().as_response()
        feats = [FB.Real("x").from_column().as_predictor(),
                 FB.Real("junk").from_column().as_predictor(),
                 FB.PickList("c").from_column().as_predictor()]
        checked = label.sanity_check(transmogrify(feats),
                                     remove_bad_features=True)
        pred = label.transform_with(S.with_cross_validation(
            num_folds=2, families=[LR()], splitter=None, seed=5), checked)
        wf = W().set_input_records(recs).set_result_features(pred)
        if t is not None:
            wf.set_plan(ExecutionPlan([], fitstats_tier=t,
                                      transform_tier=t))
        model = wf.train(device="cpu", dtype=torch.float64)
        scores.append(model.score(recs, device="cpu",
                                  engine=False)[pred.name])
    np.testing.assert_array_equal(scores[0].prediction,
                                  scores[1].prediction)
    np.testing.assert_allclose(scores[0].probability, scores[1].probability,
                               rtol=0, atol=1e-12)
    db = CostDatabase()
    assert planner.drain_phase_observations(db) >= 2
    assert db.stage_cost("phase:transform", tier) is not None
    assert db.stage_cost("phase:fitstats", tier) is not None


def test_phase_observations_make_the_phase_tiers(models):
    _jm, pm, *_ = models
    planner.drain_phase_observations(CostDatabase())
    planner.observe_phase("fitstats", "host", 0.5, 100_000)
    planner.observe_phase("fitstats", "device", 0.1, 100_000)
    planner.observe_phase("transform", "host", 0.2, 100_000)
    planner.observe_phase("transform", "bogus", -1.0, 100_000)  # dropped
    db = CostDatabase()
    assert planner.drain_phase_observations(db) == 3
    p = planner.plan_model(pm, cost_db=db)
    assert p.fitstats_tier == "device" and p.transform_tier is None
    db.record_stage("phase:transform", "device", 9.0, 1000)
    assert planner.plan_workflow(PWorkflow().set_result_features(
        *pm.result_features), cost_db=db).transform_tier == "host"
    db.record_stage("phase:workflow.ingest", "stream", 1.0, 1000)
    assert planner.ingest_route_tier(db) is None
    db.record_stage("phase:workflow.ingest", "materialize", 2.0, 1000)
    assert planner.ingest_route_tier(db) == "stream"
    assert planner.ingest_route_tier(db) \
        == jplanner.ingest_route_tier(jplanner.CostDatabase(doc=db.doc))


def test_temporal_route_feeds_the_aggregate_tier_and_its_hint():
    """The columnar route and the contested row-wise fold feed
    ``phase:temporal.route_aggregate``; a "rowwise" hint stands the
    auto route down but for every HINT_PROBE_EVERY-th pass."""
    from transmogrifai_tpu_torch import readers as R
    from transmogrifai_tpu_torch.utils import aggregators as A
    rng = np.random.default_rng(3)
    recs = [{"user": float(rng.integers(0, 9)), "ts": float(rng.uniform(
        0, 1000)), "amount": float(rng.gamma(2.0, 10.0))}
        for _ in range(300)]
    key, ts = temporal.field("user"), temporal.field("ts")

    class Src(R.DataReader):
        def __init__(self, data):
            super().__init__(key)
            self.data = data

        def read_records(self):
            return self.data
    feat = [PFB.Real("s").extract(temporal.field("amount"), "amount")
            .aggregate(A.SumAggregator()).as_predictor()]
    planner.drain_phase_observations(CostDatabase())
    table = temporal.table_from_records(recs)
    col = R.AggregateReader(Src(table), ts, R.CutOffTime.at(700),
                            key_fn=key).generate_store(feat)
    # forced off, or a row list: no columnar option, no row-wise cost
    prev = temporal.set_run_defaults(columnar=False)
    try:
        R.AggregateReader(Src(table), ts, R.CutOffTime.at(700),
                          key_fn=key).generate_store(feat)
    finally:
        temporal.set_run_defaults(**prev)
    R.AggregateReader(Src(recs), ts, R.CutOffTime.at(700),
                      key_fn=key).generate_store(feat)
    db = CostDatabase()
    planner.drain_phase_observations(db)
    slots = db.doc["stages"]["phase:temporal.route_aggregate"]
    assert set(slots) == {"columnar"} and slots["columnar"]["n"] == 1
    assert planner.aggregate_route_tier(db) is None
    before = temporal.temporal_stats()
    prev_hint = temporal.set_aggregate_tier_hint("rowwise")
    try:
        for _ in range(temporal.HINT_PROBE_EVERY):
            got = R.AggregateReader(Src(table), ts, R.CutOffTime.at(700),
                                    key_fn=key).generate_store(feat)
            assert np.array_equal(got["s"].values, col["s"].values)
    finally:
        temporal.set_aggregate_tier_hint(prev_hint)
    after = temporal.temporal_stats()
    stood_down = temporal.HINT_PROBE_EVERY - 1
    assert after["hint_fallbacks"] - before["hint_fallbacks"] == stood_down
    assert after["columnar_aggregates"] \
        - before["columnar_aggregates"] == 1
    # the passes the hint stood down were contested: their row-wise
    # seconds feed the database, and both tiers now decide
    planner.drain_phase_observations(db)
    assert slots["rowwise"]["n"] == stood_down and slots["columnar"]["n"] == 2
    assert planner.aggregate_route_tier(db) in ("columnar", "rowwise")


# ---------------------------------------------------------------------------
# the cost database
# ---------------------------------------------------------------------------


def test_cost_db_atomic_write_and_roundtrip(tmp_path):
    path = str(tmp_path / "cache" / planner.COST_DB_FILENAME)
    db = CostDatabase.load(path)
    db.record_stage("Foo", "fit", 0.5, 1000)
    db.record_stage("Foo", "fit", 1.5, 1000)
    db.record_bandwidth(1234.56, probe_mbps=20.04)
    assert db.save() and not os.path.exists(path + ".tmp")
    back = CostDatabase.load(path)
    assert back.stage_cost("Foo", "fit") == pytest.approx(1.0)
    assert back.bandwidth_mbps() == pytest.approx(1234.6)
    assert back.corrupt is False and back.finding() is None
    assert planner.default_cost_db_path(None) is None
    assert planner.default_cost_db_path(str(tmp_path)).endswith(
        planner.COST_DB_FILENAME) and planner.COST_DB_FILENAME \
        == jplanner.COST_DB_FILENAME


@pytest.mark.parametrize("payload", [
    '{"version": 1, "stages": {', "not json at all",
    '{"version": 99, "stages": {}}', '[1, 2, 3]'],
    ids=["truncated", "not-json", "version", "shape"])
def test_cost_db_corruption_gives_tmg404_in_both(tmp_path, payload):
    path = str(tmp_path / "db.json")
    with open(path, "w") as fh:
        fh.write(payload)
    for mod in (jplanner, planner):
        db = mod.CostDatabase.load(path)
        f = db.finding()
        assert db.corrupt and f.rule == "TMG404" and f.severity == "warning"
        assert f.location == path
    db = CostDatabase.load(path)
    db.record_stage("Foo", "fit", 1.0, 1000)
    assert db.save() and not CostDatabase.load(path).corrupt


def test_each_package_reads_the_others_cost_db(models, tmp_path):
    jm, pm, *_ = models
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jdb = jplanner.CostDatabase.load(jpath)
    jplanner.record_fit_costs(jm, jdb)
    jdb.record_stage("phase:fitstats", "host", 0.4, 100_000)
    jdb.record_stage("phase:fitstats", "device", 0.2, 100_000)
    jdb.record_bandwidth(2500.0)
    jdb.save()
    pdb = CostDatabase.load(ppath)
    planner.record_fit_costs(pm, pdb)
    pdb.record_stage("phase:temporal.route_aggregate", "columnar", 0.1,
                     1000)
    pdb.record_stage("phase:temporal.route_aggregate", "rowwise", 0.3,
                     1000)
    pdb.record_chain(host_rows_per_s=100.0, engine_rows_per_s=1000.0)
    pdb.save()
    p_reads = CostDatabase.load(jpath)
    j_reads = jplanner.CostDatabase.load(ppath)
    assert not p_reads.corrupt and not j_reads.corrupt
    for got, path in ((p_reads, jpath), (j_reads, ppath)):
        want = json.load(open(path))
        for k in ("version", "stages", "chain", "bandwidth_mbps"):
            assert got.doc[k] == want[k], k
    # the same stage names are recorded by both packages' trains
    assert set(p_reads.doc["stages"]) - {"phase:fitstats"} \
        == set(pdb.doc["stages"]) - {"phase:temporal.route_aggregate"}
    assert planner.plan_model(pm, cost_db=p_reads).fitstats_tier \
        == jplanner.plan_model(jm, cost_db=jdb).fitstats_tier == "device"
    assert jplanner.aggregate_route_tier(j_reads) \
        == planner.aggregate_route_tier(pdb) == "columnar"
    assert jplanner.plan_model(jm, cost_db=j_reads).engine_tier \
        == planner.plan_model(pm, cost_db=pdb).engine_tier == "device"


def test_cost_db_merge_window_keeps_means_refreshable():
    db = CostDatabase()
    for _ in range(100):
        db.record_stage("Foo", "device", 0.001, 1000)
    assert db.doc["stages"]["Foo"]["device"]["n"] == 100
    db.record_stage("Foo", "device", 0.033, 1000)
    moved = db.stage_cost("Foo", "device") - 0.001
    assert moved >= 0.032 / CostDatabase.MERGE_WINDOW - 1e-9


def test_record_fit_costs_and_tallies(models):
    jm, pm, *_ = models
    jdb, pdb = jplanner.CostDatabase(), CostDatabase()
    assert planner.record_fit_costs(pm, pdb) \
        == jplanner.record_fit_costs(jm, jdb) > 0
    assert set(pdb.doc["stages"]) == set(jdb.doc["stages"])
    assert pdb.stage_cost("ModelSelector_modelSelector", "fit") is not None
    train_rows = pm.train_rows
    try:
        pm.train_rows = 0
        assert planner.record_fit_costs(pm, CostDatabase()) == 0
    finally:
        pm.train_rows = train_rows
    before = planner.planner_stats()
    planner.plan_model(pm)
    after = planner.planner_stats()
    assert after["plans_built"] == before["plans_built"] + 1
    assert after["cse_merges"] == before["cse_merges"] + 1
    assert after["pruned_columns"] > before["pruned_columns"]


# ---------------------------------------------------------------------------
# the runner's plan step
# ---------------------------------------------------------------------------


class _CountingReader:
    def __init__(self, records):
        self._records = records
        self.calls = 0

    def read_records(self):
        self.calls += 1
        return list(self._records)


def _flow(side=PORT_SIDE):
    FB, transmogrify, S, LR, W, uid, _ = side
    uid.reset()
    label = FB.RealNN("label").from_column().as_response()
    fx = FB.Real("x").from_column().as_predictor()
    pred = label.transform_with(S.with_cross_validation(
        num_folds=2, families=[LR()], splitter=None, seed=5),
        transmogrify([fx]))
    return W().set_result_features(pred), pred


def _runner(wf, **kw):
    return OpWorkflowRunner(wf, device="cpu", dtype=torch.float64, **kw)


def test_runner_train_stamps_the_plan_and_persists_the_cost_db(tmp_path):
    wf, pred = _flow()
    reader = _CountingReader(_records())
    db_path = str(tmp_path / "cost.json")
    params = OpParams(model_location=str(tmp_path / "model"),
                      metrics_location=str(tmp_path / "metrics.json"),
                      custom_params={"costDb": db_path})
    out = _runner(wf, training_reader=reader).run(RunType.TRAIN, params)
    plan = out.metrics["plan"]
    assert plan["version"] == 1 and plan["counts"]["stages"] >= 2
    assert any(e["kind"] == "predict" for e in plan["stages"])
    assert json.load(open(db_path))["stages"]
    assert json.load(open(params.metrics_location))["plan"]["counts"] \
        == plan["counts"]
    # the same block keys as the JAX package's Train
    from transmogrifai_tpu.runner import OpParams as JOpParams
    from transmogrifai_tpu.runner import OpWorkflowRunner as JRunner
    jwf, _ = _flow(JAX_SIDE)
    jout = JRunner(jwf, training_reader=_CountingReader(_records())).run(
        RunType.TRAIN, JOpParams(model_location=str(tmp_path / "jm"),
                                 custom_params={"costDb": str(
                                     tmp_path / "jcost.json")}))
    assert set(plan) == set(jout.metrics["plan"])
    # the JAX package probes its link during a Train and records it,
    # which decides its engine tier; the port measures no link, so its
    # engine tier stays None (the engine runs unplanned)
    jcounts = dict(jout.metrics["plan"]["counts"], engineTier=None)
    assert plan["counts"] == jcounts
    # a second Train plans with the first's measured fit costs
    _runner(wf, training_reader=reader).run(RunType.TRAIN, params)
    assert any(e.source == "measured" for e in wf._exec_plan.entries)
    # Score attaches the model's plan to the engine; plan: false stamps
    # None
    runner2 = _runner(wf, scoring_reader=_CountingReader(_records()))
    out2 = runner2.run(RunType.SCORE, OpParams(
        model_location=str(tmp_path / "model"),
        custom_params={"costDb": db_path}))
    assert out2.metrics["plan"]["counts"]["stages"] >= 2
    assert out2.model.execution_plan() is not None
    out3 = runner2.run(RunType.SCORE, OpParams(
        model_location=str(tmp_path / "model"),
        custom_params={"plan": False}))
    assert out3.metrics["plan"] is None
    _same(out2.scores[pred.name], out3.scores[pred.name])


def test_runner_disabled_plan_clears_a_stale_workflow_plan(tmp_path):
    wf, _ = _flow()
    runner = _runner(wf, training_reader=_CountingReader(_records()))
    runner.run(RunType.TRAIN, OpParams(model_location=str(tmp_path / "a")))
    assert wf._exec_plan is not None
    out = runner.run(RunType.TRAIN, OpParams(
        model_location=str(tmp_path / "b"), custom_params={"plan": False}))
    assert wf._exec_plan is None and out.metrics["plan"] is None


def test_runner_plan_findings_ride_fail_on_and_suppress(tmp_path):
    wf, _ = _flow()
    db_path = str(tmp_path / "cost.json")
    with open(db_path, "w") as fh:
        fh.write('{"version": 1, "stages": {')       # corrupt: TMG404
    model_dir = str(tmp_path / "model")
    reader = _CountingReader(_records())
    _runner(wf, training_reader=reader).run(RunType.TRAIN, OpParams(
        model_location=model_dir, custom_params={"plan": False}))
    runner = _runner(wf, scoring_reader=reader)
    out = runner.run(RunType.SCORE, OpParams(
        model_location=model_dir, custom_params={"costDb": db_path}))
    assert out.metrics["rowsScored"] > 0
    # a Score leaves a corrupt database for a Train to regenerate
    assert CostDatabase.load(db_path).corrupt
    reader.calls = 0
    with pytest.raises(lint.LintError) as ei:
        runner.run(RunType.SCORE, OpParams(
            model_location=model_dir,
            custom_params={"costDb": db_path, "failOn": "warning"}))
    assert "TMG404" in str(ei.value) and reader.calls == 0
    out = runner.run(RunType.SCORE, OpParams(
        model_location=model_dir,
        custom_params={"costDb": db_path, "failOn": "warning",
                       "lintSuppress": ["TMG404", "TMG402"]}))
    assert out.metrics["rowsScored"] > 0


def test_runner_installs_the_aggregate_hint_and_raises_tmg405(tmp_path):
    """A database that measured the row-wise route faster: the hint holds
    during the run and is gone after it; a pinned aggregateColumnar=true
    contradicting it is a TMG405 warning (failOn warning stops the
    run)."""
    db_path = str(tmp_path / "cost.json")
    db = CostDatabase(path=db_path)
    db.record_stage("phase:temporal.route_aggregate", "columnar", 0.9, 1000)
    db.record_stage("phase:temporal.route_aggregate", "rowwise", 0.1, 1000)
    db.save()
    wf, _ = _flow()
    seen = {}

    class Reader(_CountingReader):
        def read_records(self):
            seen["hint"] = temporal.aggregate_tier_hint()
            return super().read_records()
    runner = _runner(wf, training_reader=Reader(_records()))
    runner.run(RunType.TRAIN, OpParams(
        model_location=str(tmp_path / "m"),
        custom_params={"costDb": db_path}))
    assert seen["hint"] == "rowwise"
    assert temporal.aggregate_tier_hint() is None
    with pytest.raises(lint.LintError, match="TMG405"):
        runner.run(RunType.TRAIN, OpParams(
            model_location=str(tmp_path / "m"),
            custom_params={"costDb": db_path, "aggregateColumnar": True,
                           "failOn": "warning"}))
    assert temporal.aggregate_tier_hint() is None


def test_plan_workflow_before_the_fit():
    wf, _ = _flow()
    plan = planner.plan_workflow(wf)
    assert plan.counts()["stages"] >= 2
    assert plan.engine_tier is None and plan.prune == {}
    assert wf.set_plan(plan)._exec_plan is plan
    jwf, _ = _flow(JAX_SIDE)
    jplan = jplanner.plan_workflow(jwf)
    assert [(e.uid, e.stage, e.kind) for e in plan.entries] \
        == [(e.uid, e.stage, e.kind) for e in jplan.entries]


def test_plan_and_preflight_launch_no_kernel(models):
    _jm, pm, *_ = models
    before = dict(_hist.KERNEL_LAUNCHES)
    planner.plan_model(pm)
    lint.check_model(pm, device=True)
    assert dict(_hist.KERNEL_LAUNCHES) == before
