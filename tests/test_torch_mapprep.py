"""The map-feature example (``examples/mapprep.py``) in the port against
the JAX package on the CPU (f64), at 800 records, seed 3: the same
records, the same combined vector (no column of the blocked key), the
same selected model and grid point, logistic-regression coefficients
within 1e-8 of the largest |coefficient|, fold metrics within 1e-9.
Models move both ways: a JAX-saved mapprep model loads and scores alike
in the port, a port-saved one in the JAX package, and the JAX model's
fitted state carried over scores alike. The feature DAG round-trips
through ``feature_json`` to the JAX module's document, and the scoring
engine, in chunks, gives the layer path's columns."""
import numpy as np
import pytest
import torch

from transmogrifai_tpu import feature_json as JFJ
from transmogrifai_tpu.columns import ColumnStore as JStore
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import feature_json as PFJ
from transmogrifai_tpu_torch import mapprep as PM
from transmogrifai_tpu_torch.carry_over import workflow_model_from_states
from transmogrifai_tpu_torch.utils import uid as puid
from transmogrifai_tpu_torch.workflow import WorkflowModel as PWorkflowModel

N, SEED = 800, 3


def _jax_example():
    import examples.mapprep as JM
    return JM


def _jax_store(recs):
    return JStore.from_dict({
        "usage": (JFT.RealMap, [r["usage"] for r in recs]),
        "attrs": (JFT.TextMap, [r["attrs"] for r in recs]),
        "churned": (JFT.RealNN, [r["churned"] for r in recs]),
        "note": (JFT.TextList, [r["note"] for r in recs]),
        "wants": (JFT.MultiPickList, [r["wants"] for r in recs]),
        "has": (JFT.MultiPickList, [r["has"] for r in recs]),
    })


@pytest.fixture(scope="module")
def runs():
    juid.reset()
    jo = _jax_example().run(n=N, seed=SEED)
    puid.reset()
    po = PM.run(N, seed=SEED, device="cpu", dtype=torch.float64)
    jo["store"] = _jax_store(PM.make_records(N, SEED))
    return jo, po


def _pred(model):
    return next(iter(model.result_features))


def test_records_are_the_examples():
    assert PM.make_records(N, SEED) == _jax_example().make_records(N, SEED)


def test_same_combined_vector(runs):
    jo, po = runs
    name = po["features"].name
    jc = jo["model"].transform(jo["store"], engine=False)[name]
    pc = po["model"].transform(po["store"], device="cpu",
                               engine=False)[name]
    assert pc.values.dtype == jc.values.dtype
    np.testing.assert_array_equal(pc.values, jc.values)
    assert [c.to_json() for c in pc.metadata.columns] == \
        [c.to_json() for c in jc.metadata.columns]
    assert [c.to_json() for c in po["vector_meta"].columns] == \
        [c.to_json() for c in jc.metadata.columns]
    assert po["width"] == 118
    assert not po["blocked_cols"] and not jo["blocked_cols"]
    assert PM.BLOCKED_KEY not in {c.grouping for c in pc.metadata.columns}


def test_same_selection_and_coefficients(runs):
    jo, po = runs
    js, ps = jo["summary"], po["summary"]
    assert ps.best_model_name == js.best_model_name == "OpLogisticRegression"
    assert ps.best_model_params == js.best_model_params
    jr, pr = js.validator_summary.results, ps.validator_summary.results
    assert [(r.family_name, r.hparams) for r in pr] == \
        [(r.family_name, r.hparams) for r in jr]
    for a, b in zip(jr, pr):
        np.testing.assert_allclose(b.metric_values, a.metric_values,
                                   rtol=0, atol=1e-9, err_msg=str(a.hparams))
    jc = np.asarray(jo["model"].fitted_stages[
        _pred(jo["model"]).origin_stage.uid].inner.coefficients)
    pc = np.asarray(po["model"].fitted_stages[
        po["prediction"].origin_stage.uid].inner.coefficients)
    assert pc.shape == jc.shape
    assert np.abs(pc - jc).max() <= 1e-8 * np.abs(jc).max()
    assert abs(po["metrics"]["AuPR"] - jo["metrics"]["AuPR"]) < 1e-9


def _scores(model, store, **kw):
    return model.score(store, **kw)[_pred(model).name]


def test_jax_saved_model_scores_alike_in_port(runs, tmp_path):
    jo, po = runs
    jo["model"].save(str(tmp_path / "m"))
    loaded = PWorkflowModel.load(str(tmp_path / "m"))
    got = _scores(loaded, po["store"], device="cpu", engine=False)
    want = _scores(jo["model"], jo["store"], engine=False)
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_allclose(got.probability, want.probability,
                               rtol=0, atol=1e-12)


def test_port_saved_model_scores_alike_in_jax(runs, tmp_path):
    jo, po = runs
    po["model"].save(str(tmp_path / "m"))
    loaded = JWorkflowModel.load(str(tmp_path / "m"))
    got = _scores(loaded, jo["store"], engine=False)
    want = _scores(po["model"], po["store"], device="cpu", engine=False)
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_allclose(got.probability, want.probability,
                               rtol=0, atol=1e-12)


def test_jax_state_carried_over_scores_alike(runs):
    """Map keys and delegates, bucket splits, IDF weights and the LR
    coefficients of the JAX run, rebuilt in the port's own DAG."""
    jo, po = runs
    states = {uid: (type(st).__name__, st.get_model_state(),
                    st.get_params())
              for uid, st in jo["model"].fitted_stages.items()}
    puid.reset()
    wf = PM.build_workflow(po["store"], seed=SEED)
    model = workflow_model_from_states([wf["prediction"]], states)
    got = _scores(model, po["store"], device="cpu", engine=False)
    want = _scores(jo["model"], jo["store"], engine=False)
    np.testing.assert_array_equal(got.prediction, want.prediction)
    np.testing.assert_allclose(got.probability, want.probability,
                               rtol=0, atol=1e-12)


def _without_mesh(doc):
    """``doc`` without the JAX selector's ``mesh`` parameter (its device
    mesh; None here), which the port's selector, on one card, lacks."""
    out = dict(doc, stages=[dict(r) for r in doc["stages"]])
    for rec in out["stages"]:
        if rec["className"] == "ModelSelector":
            assert rec["params"].get("mesh", None) is None
            rec["params"] = {k: v for k, v in rec["params"].items()
                             if k != "mesh"}
    return out


def test_feature_dag_json_matches_the_jax_module():
    juid.reset()
    jdoc = JFJ.features_to_json([_jax_mapprep_dag()])
    puid.reset()
    pdoc = PFJ.features_to_json(
        [PM.build_workflow(PM.records_store([]))["prediction"]])
    assert pdoc == _without_mesh(jdoc)
    # either document rebuilds alike in both packages (a rebuilt stage
    # carries its uid among its params, in each)
    for doc in (jdoc, pdoc):
        assert PFJ.features_to_json(PFJ.features_from_json(doc)) == \
            _without_mesh(JFJ.features_to_json(JFJ.features_from_json(doc)))


def _jax_mapprep_dag():
    """The example's result feature, built as ``examples/mapprep.run``
    builds it (the example does not expose its DAG alone)."""
    from transmogrifai_tpu import FeatureBuilder
    from transmogrifai_tpu.dsl import transmogrify
    from transmogrifai_tpu.models import (BinaryClassificationModelSelector,
                                          LogisticRegressionFamily)
    churned = FeatureBuilder.RealNN("churned").from_column().as_response()
    usage = FeatureBuilder.RealMap("usage").from_column().as_predictor()
    attrs = FeatureBuilder.TextMap("attrs").from_column().as_predictor()
    note = FeatureBuilder.TextList("note").from_column().as_predictor()
    wants = FeatureBuilder.MultiPickList("wants").from_column().as_predictor()
    has = FeatureBuilder.MultiPickList("has").from_column().as_predictor()
    features = transmogrify([
        usage.vectorize(block_keys=["internal_audit"]),
        attrs.smart_vectorize(max_cardinality=10, num_features=64),
        usage.extract_key("phone").auto_bucketize(churned),
        note.remove_stop_words().tfidf(num_terms=32),
        wants.jaccard_similarity(has)])
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, families=[LogisticRegressionFamily()], seed=7)
    return churned.transform_with(selector, features)


@pytest.mark.parametrize("cap", [64, 8192])
def test_engine_matches_the_layer_path(runs, cap):
    """Through the engine in chunks of ``cap`` rows (maps, token lists and
    sets stitched across chunks): the layer path's columns exactly."""
    _, po = runs
    model, store = po["model"], po["store"]
    eng = model.scoring_engine("cpu", bucket_cap=cap)
    kinds = {it.kind for it in eng._plan}
    assert {"vec", "combine", "predict"} <= kinds
    layer = model.transform(store, device="cpu", engine=False)
    full = eng.transform_store(store)
    name = po["features"].name
    np.testing.assert_array_equal(full[name].values, layer[name].values)
    pred = po["prediction"].name
    got = eng.score_store(store)[pred]
    np.testing.assert_array_equal(got.prediction, layer[pred].prediction)
    np.testing.assert_array_equal(got.probability, layer[pred].probability)
