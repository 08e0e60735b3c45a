"""The event-log workflow of ``transmogrifai_tpu_torch/dataprep.py`` beside
the JAX package's, and the workflow and runner around aggregating
readers: ``Workflow.train`` fits one row per key through an aggregating
reader; a small event log (2,000 users, LR and GBT, f64) gives the JAX
package's aggregated store bitwise, its winner and its fold metrics;
the runner's temporal keys are validated, installed for the run and
restored; its Score of an aggregating reader scores events, as the JAX
package's does; its Avro score output reads in the JAX package. The
``cuda`` case trains 20,000 users on the card against the CPU."""
import json

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu import temporal as JT
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JBS
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.readers import data_readers as JR
from transmogrifai_tpu.readers.avro import read_avro_records as jread_avro
from transmogrifai_tpu.runner import OpParams as JOpParams
from transmogrifai_tpu.runner import OpWorkflowRunner as JRunner
from transmogrifai_tpu.utils import aggregators as JA
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import ColumnStore, FeatureBuilder
from transmogrifai_tpu_torch import dataprep as DP
from transmogrifai_tpu_torch import temporal as PT
from transmogrifai_tpu_torch.models import linear as PL
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.readers import DataReader
from transmogrifai_tpu_torch.runner import OpParams, OpWorkflowRunner, RunType
from transmogrifai_tpu_torch.utils import uid as puid

N_USERS = 2_000
TREE = {"maxDepth": 3, "minInstancesPerNode": 10, "minInfoGain": 0.001}


def _families(L, TR):
    return [L.LogisticRegressionFamily(grid=[{"regParam": 0.01,
                                              "elasticNetParam": 0.1}]),
            TR.GBTFamily(grid=[dict(TREE)])]


class _Source:
    def __init__(self, data, key_fn):
        self._data = data
        self.key_fn = key_fn

    def read_records(self):
        return self._data


def _jax_workflow(events, users, families, seed=7):
    """``dataprep.build_workflow``'s DAG in the JAX package over the same
    columns."""
    FB, key = J.FeatureBuilder, JT.field("user")
    reader = JR.JoinedAggregateDataReader(
        _Source(JT.Table(dict(events.columns)), key),
        _Source(JT.Table(dict(users.columns)), key),
        timestamp_fn=JT.field("ts"), cutoff=JR.CutOffTime.at(DP.CUTOFF))
    amount = JT.field("amount")
    preds = [FB.Real("spend").extract(amount, "amount")
             .aggregate(JA.SumAggregator()).as_predictor(),
             FB.Real("spend_recent").extract(amount, "amount")
             .aggregate(JA.MeanAggregator()).window(DP.RECENT_WINDOW)
             .as_predictor(),
             FB.Real("peak").extract(amount, "amount")
             .aggregate(JA.MaxAggregator()).as_predictor(),
             FB.Real("segment").extract(JT.field("seg"), "seg")
             .aggregate(JA.MaxAggregator()).as_predictor()]
    churned = (FB.RealNN("churned").extract(JT.field("flag"), "flag")
               .aggregate(JA.LogicalOrAggregator()).as_response())
    checked = churned.sanity_check(jtransmogrify(preds),
                                   remove_bad_features=True)
    selector = JBS.with_cross_validation(
        num_folds=3, validation_metric="AuPR", families=families, seed=seed)
    pred = churned.transform_with(selector, checked)
    wf = J.Workflow().set_reader(reader).set_result_features(pred)
    return {"workflow": wf, "reader": reader, "selector": selector,
            "prediction": pred, "raw": [churned] + preds}


def _same_store(a, b, names):
    assert a.n_rows == b.n_rows
    for n in names:
        assert a[n].values.dtype == b[n].values.dtype, n
        assert a[n].values.tobytes() == b[n].values.tobytes(), n
        assert np.array_equal(a[n].mask, b[n].mask), n


@pytest.fixture(scope="module")
def event_runs():
    events, users = DP.make_event_log(N_USERS, 20, seed=47)
    juid.reset()
    jo = _jax_workflow(events, users, _families(JL, JTR))
    jo["store"] = jo["reader"].generate_store(jo["raw"])
    jo["model"] = jo["workflow"].train()
    puid.reset()
    po = DP.build_workflow(events, users, families=_families(PL, PTR))
    po["store"] = po["reader"].generate_store(po["raw"])
    po["model"] = po["workflow"].train(device="cpu", dtype=torch.float64)
    return jo, po


def test_event_log_is_made_from_the_seed():
    a, ua = DP.make_event_log(50, 4, seed=3)
    b, _ub = DP.make_event_log(50, 4, seed=3)
    assert len(a) == 200 and len(ua) == 50
    for nm in ("user", "ts", "amount", "flag"):
        assert a.columns[nm].tobytes() == b.columns[nm].tobytes()
    assert np.all(np.diff(a.columns["ts"]) >= 0)          # time order
    assert np.bincount(a.columns["user"].astype(int)).tolist() == [4] * 50
    assert ua.columns["seg"].tolist() == [u % 7 for u in range(50)]


def test_the_aggregated_store_is_the_jax_packages(event_runs):
    jo, po = event_runs
    assert po["store"].n_rows == N_USERS
    _same_store(po["store"], jo["store"], [f.name for f in po["raw"]])
    # and the port's row-wise composition gives it too
    prev = PT.set_run_defaults(columnar=False)
    try:
        row = po["reader"].generate_store(po["raw"])
    finally:
        PT.set_run_defaults(**prev)
    _same_store(row, po["store"], [f.name for f in po["raw"]])


def test_the_same_winner_and_fold_metrics(event_runs):
    """LR and GBT on the aggregated store: the JAX package's winner and
    every family's fold AuPR within 1e-9 (f64)."""
    jo, po = event_runs
    js = jo["model"].fitted_stages[jo["selector"].uid].selector_summary
    ps = po["model"].fitted_stages[po["selector"].uid].selector_summary
    assert po["model"].train_rows == jo["model"].train_rows
    assert (ps.best_model_name, ps.best_model_params) == \
        (js.best_model_name, js.best_model_params)
    jr, pr = js.validator_summary.results, ps.validator_summary.results
    assert [(r.family_name, r.hparams) for r in pr] == \
        [(r.family_name, r.hparams) for r in jr]
    for a, b in zip(pr, jr):
        assert np.allclose(a.metric_values, b.metric_values, rtol=0,
                           atol=1e-9), a.family_name
    assert "aggregate" in po["model"].phase_seconds


class _EventsReader(DataReader):
    """An aggregating reader made by hand: ``read_records`` gives the
    events, ``generate_store`` one row per key."""

    is_aggregating = True

    def __init__(self, events):
        super().__init__(lambda r: r["user"])
        self.events = events

    def read_records(self):
        return self.events

    def generate_store(self, raw_features):
        keys = sorted({r["user"] for r in self.events})
        sums = {k: 0.0 for k in keys}
        labels = {k: 0.0 for k in keys}
        for r in self.events:
            sums[r["user"]] += r["x"]
            labels[r["user"]] = max(labels[r["user"]], r["y"])
        from transmogrifai_tpu_torch.types import feature_types as ft
        return ColumnStore.from_dict({
            "x": (ft.Real, [sums[k] for k in keys]),
            "y": (ft.RealNN, [labels[k] for k in keys])})


def test_train_through_an_aggregating_reader_fits_one_row_per_key():
    """``Workflow.train`` hands the raw store to a reader with
    ``is_aggregating``: one training row per key, not one per event."""
    from transmogrifai_tpu_torch import Workflow
    from transmogrifai_tpu_torch.dsl import transmogrify
    from transmogrifai_tpu_torch.models import \
        BinaryClassificationModelSelector
    rng = np.random.default_rng(4)
    events = [{"user": int(u), "x": float(rng.normal()),
               "y": float(u % 2)} for u in rng.integers(0, 60, 600)]
    y = FeatureBuilder.RealNN("y").from_column().as_response()
    x = FeatureBuilder.Real("x").from_column().as_predictor()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[PL.LogisticRegressionFamily()],
        splitter=None, seed=3)
    pred = y.transform_with(sel, transmogrify([x]))
    wf = Workflow().set_reader(_EventsReader(events)) \
        .set_result_features(pred)
    model = wf.train(device="cpu")
    assert model.train_rows == 60


def _runner_flow(n=600, seed=5):
    rng = np.random.default_rng(seed)
    recs = [{"user": float(u), "ts": float(t), "amount": float(a),
             "flag": bool(f)}
            for u, t, a, f in zip(rng.integers(0, 80, n),
                                  rng.uniform(0, 1000, n),
                                  rng.gamma(2.0, 10.0, n),
                                  rng.random(n) < 0.3)]
    return recs


def _port_runner(recs, tmp_path):
    puid.reset()
    wf = DP.build_workflow(PT.table_from_records(recs),
                           PT.Table({"user": np.arange(80.0),
                                     "seg": np.arange(80.0) % 7}),
                           families=[PL.LogisticRegressionFamily()])
    runner = OpWorkflowRunner(wf["workflow"], training_reader=wf["reader"],
                              scoring_reader=wf["reader"], device="cpu",
                              dtype=torch.float64)
    params = OpParams(model_location=str(tmp_path / "model"),
                      metrics_location=str(tmp_path / "m.json"))
    return runner, params, wf


@pytest.mark.parametrize("key,value", [
    ("joinPartitions", 0), ("joinPartitions", True),
    ("joinTableMaxRows", 2.5), ("joinTableMaxRows", "many"),
    ("aggregateColumnar", "yes"), ("aggregateColumnar", 1)])
def test_malformed_temporal_keys_name_their_key(key, value, tmp_path):
    runner, _params, _wf = _port_runner(_runner_flow(), tmp_path)
    calls = []
    runner.workflow.train = lambda **kw: calls.append(kw)
    with pytest.raises(ValueError, match=f"customParams.{key}"):
        runner.run(RunType.TRAIN, OpParams(custom_params={key: value}))
    assert calls == [] and PT.join_partitions() == \
        PT.DEFAULT_JOIN_PARTITIONS


def test_temporal_keys_hold_for_the_run_and_are_restored(tmp_path):
    recs = _runner_flow()
    runner, params, wf = _port_runner(recs, tmp_path)
    seen = {}
    train = runner.workflow.train

    def spy(**kw):
        seen.update(partitions=PT.join_partitions(),
                    cap=PT.join_table_max_rows(), mode=PT.columnar_mode())
        return train(**kw)
    runner.workflow.train = spy
    params.custom_params = {"joinPartitions": 3, "joinTableMaxRows": "123",
                            "aggregateColumnar": "false"}
    before = PT.temporal_stats()
    res = runner.run(RunType.TRAIN, params)
    assert seen == {"partitions": 3, "cap": 123, "mode": False}
    assert PT.join_partitions() == PT.DEFAULT_JOIN_PARTITIONS
    assert PT.join_table_max_rows() == PT.DEFAULT_JOIN_TABLE_MAX_ROWS
    assert PT.columnar_mode() == "auto"
    block = res.metrics["temporal"]
    assert block["rowwise_aggregates"] == before["rowwise_aggregates"] + 1
    assert block["joins"] == before["joins"] + 1
    assert res.model.train_rows == 80
    assert json.load(open(params.metrics_location))["temporal"] == block
    # auto: the same run columnar
    params.custom_params = {}
    res = runner.run(RunType.TRAIN, params)
    assert res.metrics["temporal"]["columnar_aggregates"] == \
        block["columnar_aggregates"] + 1


def test_score_of_an_aggregating_reader_scores_events_in_both(tmp_path):
    """The runner's Score reads ``read_records()`` of the scoring reader,
    aggregating or not: both packages score the joined events, one row
    per event (a JAX package behaviour the port mirrors; ROADMAP C)."""
    recs = _runner_flow()
    runner, params, wf = _port_runner(recs, tmp_path)
    runner.run(RunType.TRAIN, params)
    got = runner.run(RunType.SCORE, params)
    assert got.metrics["rowsScored"] == len(recs)
    juid.reset()
    users = JT.Table({"user": np.arange(80.0), "seg": np.arange(80.0) % 7})
    jo = _jax_workflow(JT.table_from_records(recs), users,
                       [JL.LogisticRegressionFamily()])
    jrunner = JRunner(jo["workflow"], training_reader=jo["reader"],
                      scoring_reader=jo["reader"])
    jparams = JOpParams(model_location=str(tmp_path / "jax"))
    jrunner.run("Train", jparams)
    assert jrunner.run("Score", jparams).metrics["rowsScored"] == len(recs)


def test_avro_score_output_reads_in_the_jax_package(tmp_path):
    recs = _runner_flow()
    runner, params, wf = _port_runner(recs, tmp_path)
    runner.run(RunType.TRAIN, params)
    params.write_location = str(tmp_path / "scores.avro")
    scores = runner.run(RunType.SCORE, params).scores
    rows = jread_avro(params.write_location)
    name = wf["prediction"].name
    assert len(rows) == scores.n_rows == len(recs)
    assert [r[name] for r in rows] == \
        [scores[name].get_raw(i) for i in range(scores.n_rows)]


@pytest.mark.cuda
def test_event_log_on_the_card_equals_the_cpu():
    """20,000 users (400,000 events) through the columnar join and
    aggregation, trained on the card (the tree kernels) and on the CPU;
    each model scores its aggregated store, and a GBT at the selector's
    grid point is refit on the trained vector and scored over it (its
    ``predict_trees``, whichever family wins): the same store and winner,
    fold metrics and the refit's AuPR within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the tree families' kernels run "
                    "only on the card")
    from transmogrifai_tpu_torch.evaluators.metrics import aupr
    from transmogrifai_tpu_torch.models import _hist
    events, users = DP.make_event_log(20_000, 20, seed=47)
    out = {}
    for dev in ("cuda", "cpu"):
        puid.reset()
        wf = DP.build_workflow(events, users)
        _hist.reset_launch_counts()
        model = wf["workflow"].train(device=dev)
        store = wf["reader"].generate_store(wf["raw"])
        trained = model.transform(store, device=dev, engine=False)
        sel = model.fitted_stages[wf["selector"].uid]
        est = PTR.OpGBTClassifier(max_iter=20, max_depth=3,
                                  min_instances_per_node=10,
                                  min_info_gain=0.001)
        est.set_input(wf["label"], sel.input_features[1])
        prob = est.fit(trained, device=dev).transform_columns(
            trained, device=dev).probability
        y = trained[wf["label"].name].values
        out[dev] = (sel.selector_summary, dict(_hist.KERNEL_LAUNCHES),
                    store, aupr(y, prob[:, 1]))
    (cs, launches, cstore, caupr), (ps, _l, pstore, paupr) = \
        out["cuda"], out["cpu"]
    _same_store(cstore, pstore, list(cstore.names()))
    for k in ("group_rows", "cumhist", "split_scan", "level_epilogue",
              "predict_trees"):
        assert launches[k] > 0, k
    assert (cs.best_model_name, cs.best_model_params) == \
        (ps.best_model_name, ps.best_model_params)
    for a, b in zip(cs.validator_summary.results,
                    ps.validator_summary.results):
        assert np.allclose(a.metric_values, b.metric_values, rtol=0,
                           atol=1e-4), a.family_name
    assert abs(caupr - paupr) <= 1e-4
