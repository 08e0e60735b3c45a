"""The guarded map-feature workflow in both packages, for the port's tests of
the RawFeatureFilter, workflow-level CV and the insights: the records of
``examples/mapprep.py`` (n=800, seed 3) with the filter's scoring records
(n=400, seed 4, every record's ``attrs`` without its ``region`` key), the
example's DAG built in each package around a selector over the given
families, the filter at its defaults and workflow CV on. Both packages
train on the CPU; the port in float64."""
import numpy as np
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.columns import ColumnStore as JStore
from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import svm as JSV
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JBS
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import mapprep as PM
from transmogrifai_tpu_torch.filters import RawFeatureFilter as PRFF
from transmogrifai_tpu_torch.models import linear as PL
from transmogrifai_tpu_torch.models import svm as PSV
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.utils import uid as puid

N, SEED, N_SCORE, SCORE_SEED = 800, 3, 400, 4
TREE = {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}


def records(n=N, seed=SEED):
    return PM.make_records(n, seed)


def scoring_records(n=N_SCORE, seed=SCORE_SEED):
    """Records whose ``attrs`` lost the ``region`` key upstream."""
    recs = PM.make_records(n, seed)
    for r in recs:
        r["attrs"].pop("region", None)
    return recs


def jax_store(recs):
    return JStore.from_dict({
        "usage": (JFT.RealMap, [r["usage"] for r in recs]),
        "attrs": (JFT.TextMap, [r["attrs"] for r in recs]),
        "churned": (JFT.RealNN, [r["churned"] for r in recs]),
        "note": (JFT.TextList, [r["note"] for r in recs]),
        "wants": (JFT.MultiPickList, [r["wants"] for r in recs]),
        "has": (JFT.MultiPickList, [r["has"] for r in recs]),
    })


def one_point(L, RF, G, SV):
    """One grid point of each default family (the forest at 5 trees)."""
    return [L(grid=[{"regParam": 0.01, "elasticNetParam": 0.1}]),
            RF(grid=[dict(TREE)], num_trees=5),
            G(grid=[dict(TREE, maxDepth=3)]),
            SV(grid=[{"regParam": 0.01}])]


def jax_one_point():
    return one_point(JL.LogisticRegressionFamily, JTR.RandomForestFamily,
                     JTR.GBTFamily, JSV.LinearSVCFamily)


def port_one_point():
    return one_point(PL.LogisticRegressionFamily, PTR.RandomForestFamily,
                     PTR.GBTFamily, PSV.LinearSVCFamily)


def jax_workflow(store, families, seed=7):
    """``examples/mapprep.py``'s DAG in the JAX package, over
    ``families``."""
    churned = JFB.RealNN("churned").from_column().as_response()
    usage = JFB.RealMap("usage").from_column().as_predictor()
    attrs = JFB.TextMap("attrs").from_column().as_predictor()
    note = JFB.TextList("note").from_column().as_predictor()
    wants = JFB.MultiPickList("wants").from_column().as_predictor()
    has = JFB.MultiPickList("has").from_column().as_predictor()
    features = jtransmogrify([
        usage.vectorize(block_keys=[PM.BLOCKED_KEY]),
        attrs.smart_vectorize(max_cardinality=10, num_features=64),
        usage.extract_key("phone").auto_bucketize(churned),
        note.remove_stop_words().tfidf(num_terms=32),
        wants.jaccard_similarity(has)])
    selector = JBS.with_cross_validation(num_folds=3, families=families,
                                         seed=seed)
    pred = churned.transform_with(selector, features)
    wf = JWorkflow().set_input_store(store).set_result_features(pred)
    return {"workflow": wf, "selector": selector, "label": churned,
            "prediction": pred, "features": features}


def guarded(jax_families, port_families, guard=True, n=N):
    """Both packages' guarded workflows trained: ({"model", "store",
    "score_store", ...} of the JAX package, the same of the port)."""
    recs, srecs = records(n), scoring_records()
    juid.reset()
    jstore, jscore = jax_store(recs), jax_store(srecs)
    jo = jax_workflow(jstore, jax_families)
    puid.reset()
    pstore, pscore = PM.records_store(recs), PM.records_store(srecs)
    po = PM.build_workflow(pstore, families=port_families)
    if guard:
        jo["workflow"].with_raw_feature_filter(
            JRFF(scoring_data=jscore)).with_workflow_cv()
        po["workflow"].with_raw_feature_filter(
            PRFF(scoring_data=pscore)).with_workflow_cv()
    jo["model"] = jo["workflow"].train()
    po["model"] = po["workflow"].train(device="cpu", dtype=torch.float64)
    jo.update(store=jstore, score_store=jscore)
    po.update(store=pstore, score_store=pscore)
    return jo, po


def selected(out):
    return out["model"].fitted_stages[out["selector"].uid]


def same_results(jsum, psum, atol=None):
    """The same validation type, grid, winner and fold metrics (within
    1e-9, or ``atol[family name]``)."""
    atol = atol or {}
    jv, pv = jsum.validator_summary, psum.validator_summary
    assert pv.validation_type == jv.validation_type
    assert psum.best_model_name == jsum.best_model_name
    assert psum.best_model_params == jsum.best_model_params
    assert [(r.family_name, r.hparams) for r in pv.results] == \
        [(r.family_name, r.hparams) for r in jv.results]
    for jr, pr in zip(jv.results, pv.results):
        np.testing.assert_allclose(
            pr.metric_values, jr.metric_values, rtol=0,
            atol=atol.get(jr.family_name, 1e-9), err_msg=jr.family_name)
