"""The port's batched scoring engine (``transmogrifai_tpu_torch/scoring.py``)
held against the JAX package's engine and against the port's own layer
path, on the CPU in f64 from numpy-seeded records: the bucket ladder, the
fused plan on the BigPassenger and Titanic DAGs, engine/eager equality at
batch sizes around the buckets, the ladder's program budget, routing,
overlapped streaming, and the CUDA-graph cases on the card."""
import numpy as np
import pytest
import torch

from transmogrifai_tpu import scoring as JSC
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import big_passenger as PB
from transmogrifai_tpu_torch import scoring as PSC
from transmogrifai_tpu_torch import titanic as PT
from transmogrifai_tpu_torch.carry_over import workflow_model_from_states
from transmogrifai_tpu_torch.models import linear as PL
from transmogrifai_tpu_torch.models import selector as PS
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import uid as puid

F64 = dict(device="cpu", dtype=torch.float64)
#: batch sizes around the buckets of a 64-row cap (8, 16, 32, 64; 150
#: rows run as chunks of 64, 64 and 22 in the 32 bucket)
SIZES = (1, 7, 8, 9, 63, 64, 65, 150)


def _lr_point(L):
    return L.LogisticRegressionFamily(
        grid=[{"regParam": 0.01, "elasticNetParam": 0.1}])


def _carried(jm, prediction):
    states = {uid: (type(s).__name__, s.get_model_state(), s.get_params())
              for uid, s in jm.fitted_stages.items()}
    return workflow_model_from_states([prediction], states)


@pytest.fixture(scope="module")
def big_passenger():
    """BigPassenger (text, pick list, date, numerics → SanityChecker → LR)
    trained by the JAX package at 600 records, and carried into the
    port's own DAG of the same workflow."""
    import examples.big_passenger as JB
    records = JB.synthesize_records(600, seed=42)
    juid.reset()
    jo = JB.run(600, num_folds=2, families=[_lr_point(JL)], mesh=False)
    puid.reset()
    *_, prediction = PB.build_selection([_lr_point(PL)], num_folds=2)
    return records, jo["model"], _carried(jo["model"], prediction), \
        prediction


@pytest.fixture(scope="module")
def port_gbt():
    """A port-trained BigPassenger model with a GBT winner (f64, CPU)."""
    records = PB.synthesize_records(500, seed=3)
    puid.reset()
    out = PB.run(500, num_folds=2, records=records, families=[
        PTR.GBTFamily(grid=[{"maxDepth": 3, "minInstancesPerNode": 5,
                             "minInfoGain": 0.0}], max_iter=4)], **F64)
    return records, out["model"], out["prediction"]


def _plan_signature(plan, host_layers):
    return ({it.model.uid: it.kind for it in plan},
            {it.model.uid: tuple(it.ins) for it in plan},
            [[m.uid for m in layer] for layer in host_layers])


def test_bucket_ladder_equals_the_references():
    for n, cap in ((1, 64), (8, 64), (9, 64), (64, 64), (1000, 64),
                   (3392, 8192), (8192, 8192), (5, 8192), (100, 100)):
        assert PSC.bucket_for(n, cap) == JSC.bucket_for(n, cap)
    for cap in (64, 100, 8192):
        assert PSC.bucket_ladder(cap) == JSC.bucket_ladder(cap)
    assert PSC.bucket_ladder(64) == [8, 16, 32, 64]
    assert (PSC.BUCKET_MIN, PSC.DEFAULT_BUCKET_CAP, PSC.SCORING_MIN_ROWS) \
        == (JSC.BUCKET_MIN, JSC.DEFAULT_BUCKET_CAP, JSC.SCORING_MIN_ROWS)


def test_fused_plan_equals_the_references_on_big_passenger(big_passenger):
    _records, jm, pm, _pred = big_passenger
    want = _plan_signature(*JSC.build_fused_plan(jm._resolved_dag()))
    got = _plan_signature(*PSC.build_fused_plan(pm._resolved_dag()))
    assert got == want
    assert set(want[0].values()) == {"vec", "combine", "select", "predict"}


def test_fused_plan_equals_the_references_on_titanic():
    """Titanic's DSL stages stay on the host in both packages; the
    vectorizers, combiner, SanityChecker and predictor fuse."""
    import examples.titanic as JT
    juid.reset()
    jo = JT.run(csv_path=JT._BUNDLED_CSV, families=[_lr_point(JL)],
                mesh=False)
    puid.reset()
    py, px = PT.build_features()
    sel = PS.BinaryClassificationModelSelector.with_cross_validation(
        families=[_lr_point(PL)])
    pm = _carried(jo["model"], py.transform_with(sel, px))
    want = _plan_signature(*JSC.build_fused_plan(jo["model"]._resolved_dag()))
    got = _plan_signature(*PSC.build_fused_plan(pm._resolved_dag()))
    assert got == want
    assert any(want[2])                 # host stages exist


@pytest.mark.parametrize("which", ["lr", "gbt"])
def test_engine_equals_layer_path_at_every_batch_size(which, big_passenger,
                                                      port_gbt):
    """Engine scores bitwise equal to the layer path's (f64 on the CPU)
    at each batch size, every program within the ladder's budget, and a
    size inside an already-built bucket builds nothing."""
    if which == "lr":
        records, _jm, model, pred = big_passenger
    else:
        records, model, pred = port_gbt
    eng = model.scoring_engine("cpu", bucket_cap=64)
    assert eng.covers_prediction and not eng.graphs
    for k in SIZES:
        got = eng.score_store(records[:k])[pred.name]
        want = model.score(records[:k], device="cpu",
                           engine=False)[pred.name]
        assert len(got) == k
        for col in ("prediction", "raw_prediction", "probability"):
            np.testing.assert_array_equal(getattr(got, col),
                                          getattr(want, col))
    assert eng.compile_count <= len(PSC.bucket_ladder(64))
    assert eng.compile_count == eng.program_budget()
    before = eng.compile_count
    eng.score_store(records[:5])
    eng.score_store(records[:30])
    assert eng.compile_count == before
    # every column of the DAG, vectors included, as the layer path has it
    full = eng.transform_store(records[:70])
    ref = model.transform(records[:70], device="cpu", engine=False)
    for it in eng._plan:
        a, b = full[it.out], ref[it.out]
        if it.kind == "predict":
            np.testing.assert_array_equal(a.probability, b.probability)
        else:
            np.testing.assert_array_equal(a.values, b.values)
            assert (a.metadata is None) == (b.metadata is None)
            if a.metadata is not None:
                assert a.metadata.to_json() == b.metadata.to_json()


def test_routing_follows_scoring_min_rows(port_gbt):
    """``engine="auto"`` takes the engine from SCORING_MIN_ROWS rows;
    True forces it, False forbids it."""
    records, model, pred = port_gbt
    eng = model.scoring_engine("cpu")
    before = eng.compile_count
    model.score(records[:50], device="cpu")
    assert eng.compile_count == before
    model.score(records[:50], device="cpu", engine=True)
    assert eng.compile_count == before + 1
    many = records * (PSC.SCORING_MIN_ROWS // len(records) + 1)
    assert len(many) >= PSC.SCORING_MIN_ROWS
    model.score(many[:PSC.SCORING_MIN_ROWS], device="cpu")
    assert eng.compile_count == before + 2
    model.score(many, device="cpu", engine=False)
    assert eng.compile_count == before + 2


def test_stream_score_overlapped_equals_serial_scores(port_gbt):
    records, model, pred = port_gbt
    batches = [records[i:i + 120] for i in range(0, len(records), 120)]
    eng = model.scoring_engine("cpu", bucket_cap=64)
    streamed = list(PSC.stream_score_overlapped(model, batches, engine=eng))
    assert len(streamed) == len(batches)
    for got, batch in zip(streamed, batches):
        want = model.score(batch, device="cpu", engine=False)[pred.name]
        np.testing.assert_array_equal(got[pred.name].probability,
                                      want.probability)
        assert got.names() == [pred.name]


def test_port_engine_equals_the_jax_engine(big_passenger):
    """The same carried-over model through both packages' engines: the
    predictions equal, the probabilities within 1e-12 (f64)."""
    records, jm, pm, pred = big_passenger
    want = jm.scoring_engine(gate_bandwidth=False, bucket_cap=64) \
        .score_store(records[:150])[pred.name]
    got = pm.scoring_engine("cpu", bucket_cap=64) \
        .score_store(records[:150])[pred.name]
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_allclose(got.probability, want.probability, rtol=0,
                               atol=1e-12)


def test_graphs_need_the_card(port_gbt):
    """``graphs=True`` on the CPU raises; the CPU engine runs eagerly."""
    _records, model, _pred = port_gbt
    with pytest.raises(ValueError, match="CUDA graphs"):
        PSC.ScoringEngine(model, device="cpu", graphs=True)
    assert not PSC.ScoringEngine(model, device="cpu").graphs


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_warm_up_on_the_card():
    """On the card: the first call at a bucket runs eagerly, the second
    captures a graph, later ones replay it. Replays are bitwise equal to
    an eager engine's outputs, ``predict_trees`` launches once a chunk
    (replays counted), and the card's scores equal the CPU's (an f32
    model; see the tolerances below)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: CUDA graphs run only on the card")
    from transmogrifai_tpu_torch.models import _hist as H
    records = PB.synthesize_records(500, seed=3)
    puid.reset()
    out = PB.run(500, num_folds=2, records=records, device="cpu",
                 families=[PTR.GBTFamily(grid=[{"maxDepth": 3}],
                                         max_iter=4)])
    model, pred = out["model"], out["prediction"]
    eng = model.scoring_engine("cuda", bucket_cap=64)
    eager = model.scoring_engine("cuda", bucket_cap=64, graphs=False)
    for _ in range(3):
        H.reset_launch_counts()
        got = eng.score_store(records[:150], use_cache=False)[pred.name]
        assert H.KERNEL_LAUNCHES["predict_trees"] == 3      # 64, 64, 32
        want = eager.score_store(records[:150])[pred.name]
        for col in ("prediction", "raw_prediction", "probability"):
            np.testing.assert_array_equal(getattr(got, col),
                                          getattr(want, col))
    assert eng.graphs_captured == 2            # the 64 and 32 buckets
    # predictions and margins bitwise (the kernel is bitwise to its plain
    # version); probabilities within 2^-22, two f32 ulps: the sigmoid's exp
    # rounds apart on the card and the CPU, and 1 - p doubles it
    cpu = model.score(records[:150], device="cpu", engine=False)[pred.name]
    for col in ("prediction", "raw_prediction"):
        np.testing.assert_array_equal(getattr(got, col), getattr(cpu, col))
    np.testing.assert_allclose(got.probability, cpu.probability, rtol=0,
                               atol=2.0 ** -22)
