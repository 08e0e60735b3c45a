"""The port's workflow-level CV against the JAX package on the CPU (f64):
the JAX test's leaky flow (a label-aware bucketizer over noise), whose
selector-level CV leaks and whose workflow CV does not. Its fold matrices
are the JAX package's bit for bit; each fold's logistic regression scores
the rows within 1e-12 of the JAX package's fitted on the same fold; and
the port's fold metric is the JAX package's metric function on the
port's fold probabilities within 1e-12; with the scores rounded to 1e-10,
each package's metric function on its own fold probabilities gives the
same metric within 1e-12; both packages' fold metrics lie in the range
that the orders of scores tied within 1e-12 allow; and the fold metrics
are within ``TIE_TOL`` of the JAX package's. Not within
1e-9: the flow's vector is
one bucket indicator a row, buckets of equal label counts get
coefficients equal up to the last few bits, and AuROC counts a tied pair
as a half, so a tie that one package's summation order keeps and the
other's splits by an ulp moves the metric by ~8e-4 a pair.
``cut_dag`` on the map-feature DAG; and
the guarded map-feature workflow at 800 records under one grid point of
each default family: the same winner, ``WorkflowCV:`` summary and fold
metrics (LR, RF and SVC within 1e-9; GBT within 1e-3, the f64
summation-order tie of ROADMAP queue C), and the selector's refit on the
winner's whole training split."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu import ColumnStore as JStore
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu import column_from_values as jcol
from transmogrifai_tpu.evaluators.device_metrics import \
    device_metric_fn as jax_metric_fn
from transmogrifai_tpu.graph import cut_dag as jax_cut
from transmogrifai_tpu.models import tuning as JTuning
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JBS
from transmogrifai_tpu.ops.dt_bucketizer import \
    DecisionTreeNumericBucketizer as JBucketizer
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import ColumnStore as PStore
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import column_from_values as pcol
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.evaluators.device_metrics import \
    device_metric_fn as port_metric_fn
from transmogrifai_tpu_torch.graph import cut_dag as port_cut
from transmogrifai_tpu_torch.models import tuning as PTuning
from transmogrifai_tpu_torch.models.linear import \
    LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PBS
from transmogrifai_tpu_torch.ops.dt_bucketizer import \
    DecisionTreeNumericBucketizer as PBucketizer
from transmogrifai_tpu_torch.types import feature_types as PFT
from transmogrifai_tpu_torch.utils import uid as puid

sys.path.insert(0, os.path.dirname(__file__))
import _torch_guard_data as GD  # noqa: E402

JAX = (JStore, jcol, JFT, JFB, JBucketizer, jtransmogrify, JBS, JLR,
       JWorkflow, {})
PORT = (PStore, pcol, PFT, PFB, PBucketizer, ptransmogrify, PBS, PLR,
        PWorkflow, {"device": "cpu", "dtype": torch.float64})


def _leaky_flow(pkg, workflow_cv, n=150):
    """The JAX test's flow: fitting the label-aware bucketizer on all rows
    leaks the validation labels into its bucket edges."""
    Store, col, FT, FB, Bucketizer, transmogrify, BS, LR, Wf, kw = pkg
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, size=n).astype(float)
    noise = rng.normal(size=n)
    store = Store({"label": col(FT.RealNN, list(y)),
                   "noise": col(FT.Real, list(noise))})
    label = FB.RealNN("label").from_column().as_response()
    fx = FB.Real("noise").from_column().as_predictor()
    bucketized = label.transform_with(
        Bucketizer(max_depth=12, max_bins=256, min_info_gain=1e-9), fx)
    selector = BS.with_cross_validation(
        num_folds=3, validation_metric="AuROC",
        families=[LR(grid=[{"regParam": 0.001, "elasticNetParam": 0.0}])],
        splitter=None, seed=7)
    pred = label.transform_with(selector, transmogrify([bucketized]))
    wf = Wf().set_result_features(pred).set_input_store(store)
    if workflow_cv:
        wf = wf.with_workflow_cv()
    model = wf.train(**kw)
    return model.fitted_stages[selector.uid].selector_summary


#: AuROC over the leaky flow's 50 validation rows moves by 1 / (2·P·N) ≈
#: 8e-4 for each tied pair split apart; a few such pairs
TIE_TOL = 1e-2
LEAKY_GRID = [{"regParam": 0.001, "elasticNetParam": 0.0}]


def _folds_seen(monkeypatch, tuning, workflow_cv):
    """The (X, y, w_train, w_val) of every fold the validator sweeps: the
    fold data of ``validate_per_fold``, or ``validate``'s one matrix under
    each of its fold masks."""
    seen = []
    cls = tuning._ValidatorBase
    if workflow_cv:
        orig = cls.validate_per_fold

        def spy(self, families, fold_data, *a, **kw):
            seen.extend(tuple(np.asarray(x) for x in f[:4])
                        for f in fold_data)
            return orig(self, families, fold_data, *a, **kw)
        monkeypatch.setattr(cls, "validate_per_fold", spy)
    else:
        orig = cls.validate

        def spy(self, families, X, y, *a, **kw):
            seen.extend((np.asarray(X, dtype=np.float64), np.asarray(y), m, v)
                        for m, v in self._splits(np.asarray(y)))
            return orig(self, families, X, y, *a, **kw)
        monkeypatch.setattr(cls, "validate", spy)
    return seen


def _fold_probs(folds, family, put):
    """P(class 1) over each fold's rows of ``family`` (either package's
    logistic regression) fitted on the fold's training weights."""
    out = []
    for X, y, w, _v in folds:
        fam = family(grid=LEAKY_GRID)
        if put is jnp.asarray:
            st = {k: put(a) for k, a in fam.stack_grid().items()}
            params = fam.fit_batch(put(X), put(y), put(w), st)
            prob = fam.predict_batch(params, put(X))[2][0]
        else:
            params = fam.fit_batch(put(X), put(y), put(w))
            prob = fam.predict_batch(params, put(X))[0][2]
        out.append(np.asarray(prob)[:, 1])
    return out


def _metric(metric_fn, put, y, p1, v):
    """AuROC (either package's device metric function) of the scores
    ``p1`` over the rows of validation weight ``v``."""
    prob = np.stack([1.0 - p1, p1], axis=1)
    fn = metric_fn("binary", "AuROC")
    return float(fn(put(y), put((p1 > 0.5).astype(np.float64)), put(prob),
                    put(v)))


def _tied_auroc_range(y, p1, v, tol):
    """(least, greatest) AuROC of the scores ``p1`` over the rows of
    validation weight ``v`` (0/1) when scores that chain within ``tol`` of
    each other may be ordered either way: a positive-negative pair of one
    such run counts 0 or 1, any other pair as its order says."""
    vm = v > 0
    s, yv = p1[vm], y[vm]
    order = np.argsort(s, kind="stable")
    s, yv = s[order], yv[order]
    run = np.concatenate([[0], np.cumsum(np.diff(s) > tol)])
    pos, neg = yv == 1, yv == 0
    # pairs whose positive lies in a later run than its negative
    neg_before = np.array([np.sum(neg & (run < r)) for r in run])
    same = np.array([np.sum(neg & (run == r)) for r in run])
    pairs = pos.sum() * neg.sum()
    above = float(np.sum(neg_before[pos]))
    return above / pairs, (above + float(np.sum(same[pos]))) / pairs


@pytest.mark.parametrize("workflow_cv", [False, True],
                         ids=["selector_cv", "workflow_cv"])
def test_leaky_flow_metrics_equal_the_jax_packages(workflow_cv,
                                                   monkeypatch):
    j_folds = _folds_seen(monkeypatch, JTuning, workflow_cv)
    p_folds = _folds_seen(monkeypatch, PTuning, workflow_cv)
    juid.reset()
    js = _leaky_flow(JAX, workflow_cv)
    puid.reset()
    ps = _leaky_flow(PORT, workflow_cv)
    assert len(p_folds) == len(j_folds) == 3
    for jf, pf in zip(j_folds, p_folds):
        for a, b in zip(jf, pf):
            np.testing.assert_array_equal(b, a)
    j_probs = _fold_probs(j_folds, JLR, jnp.asarray)
    p_probs = _fold_probs(p_folds, PLR, torch.as_tensor)
    for jp, pp in zip(j_probs, p_probs):
        np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-12)
    # the port's fold metric is the JAX package's metric function on the
    # port's fold probabilities; with the scores' last bits rounded away,
    # each package's metric function on its own fold probabilities gives
    # the same metric; and both packages' metrics lie in the range that
    # the orders of scores tied within 1e-12 allow. So the ties are all
    # that the comparison below excuses.
    jm = js.validator_summary.results[0].metric_values
    pm = ps.validator_summary.results[0].metric_values
    for k, ((_X, y, _w, v), jp, pp) in enumerate(zip(p_folds, j_probs,
                                                     p_probs)):
        np.testing.assert_allclose(
            _metric(jax_metric_fn, jnp.asarray, y, pp, v), pm[k], rtol=0,
            atol=1e-12, err_msg=f"the JAX metric on the port's fold {k}")
        np.testing.assert_allclose(
            _metric(port_metric_fn, torch.as_tensor, y, np.round(pp, 10),
                    v),
            _metric(jax_metric_fn, jnp.asarray, y, np.round(jp, 10), v),
            rtol=0, atol=1e-12, err_msg=f"rounded scores, fold {k}")
        lo, hi = _tied_auroc_range(y, pp, v, 1e-12)
        for who, m in (("port", pm[k]), ("JAX package", jm[k])):
            assert lo - 1e-12 <= m <= hi + 1e-12, (who, k, lo, m, hi)
    np.testing.assert_allclose(
        ps.validator_summary.results[0].metric_values,
        js.validator_summary.results[0].metric_values, rtol=0,
        atol=TIE_TOL)
    expected = "WorkflowCV:CrossValidation" if workflow_cv \
        else "CrossValidation"
    assert ps.validator_summary.validation_type == expected
    assert js.validator_summary.validation_type == expected


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_workflow_cv_is_more_honest_than_selector_cv(pkg):
    flow = {"jax": JAX, "port": PORT}[pkg]
    (juid if pkg == "jax" else puid).reset()
    leaky = _leaky_flow(flow, False).validator_summary.best.mean_metric
    (juid if pkg == "jax" else puid).reset()
    honest = _leaky_flow(flow, True).validator_summary.best.mean_metric
    assert leaky > 0.7, leaky
    assert honest < leaky - 0.1, (leaky, honest)
    assert honest < 0.65, honest


def test_cut_dag_of_the_map_feature_workflow():
    """The same before / during / after split in both packages: the
    label-aware bucketizer's layer and everything that depends on it
    refit inside each fold."""
    recs = GD.records()
    juid.reset()
    jo = GD.jax_workflow(GD.jax_store(recs), GD.jax_one_point())
    puid.reset()
    po = GD.PM.build_workflow(GD.PM.records_store(recs),
                              families=GD.port_one_point())

    def named(layers):
        return [sorted((type(s).__name__, s.uid) for s in layer)
                for layer in layers]
    jms, jb, jd, ja = jax_cut([jo["prediction"]])
    pms, pb, pd, pa = port_cut([po["prediction"]])
    assert pms.uid == jms.uid
    assert named(pb) == named(jb)
    assert named(pd) == named(jd)
    assert named(pa) == named(ja) == []
    assert [[n for n, _ in layer] for layer in named(pd)] == [
        ["DecisionTreeNumericBucketizer", "MapVectorizer", "OpIDF",
         "RealVectorizer", "SmartTextMapVectorizer"], ["VectorsCombiner"]]


@pytest.fixture(scope="module")
def guarded_runs():
    return GD.guarded(GD.jax_one_point(), GD.port_one_point())


def test_guarded_mapprep_selects_like_the_jax_package(guarded_runs):
    jo, po = guarded_runs
    js, ps = GD.selected(jo).selector_summary, \
        GD.selected(po).selector_summary
    assert ps.validator_summary.validation_type == \
        "WorkflowCV:CrossValidation"
    GD.same_results(js, ps, atol={"OpGBTClassifier": 1e-3})
    assert set(ps.validator_summary.family_seconds) == {
        "OpLogisticRegression", "OpRandomForestClassifier",
        "OpGBTClassifier", "OpLinearSVC"}
    assert set(po["model"].phase_seconds) == {
        "rawFeatureFilter", "before", "foldFeatures", "cvSweep", "final"}


def test_guarded_mapprep_refit_equals_the_jax_packages(guarded_runs):
    """The winner refit on the whole training split: the train
    evaluation, and the probabilities over the training records, as the
    JAX package's (within 1e-9)."""
    jo, po = guarded_runs
    js, ps = GD.selected(jo).selector_summary, \
        GD.selected(po).selector_summary
    for k, v in js.train_evaluation.items():
        if isinstance(v, float):
            np.testing.assert_allclose(ps.train_evaluation[k], v, rtol=0,
                                       atol=1e-9, err_msg=k)
    name = jo["prediction"].name
    jp = jo["model"].score(jo["store"])[name]
    pp = po["model"].score(po["store"], device="cpu")[name]
    np.testing.assert_array_equal(pp.prediction, jp.prediction)
    np.testing.assert_allclose(pp.probability, jp.probability, rtol=0,
                               atol=1e-9)


def test_selector_skips_its_own_sweep_under_workflow_cv(guarded_runs):
    """The selector's per-fold sweep runs before its layer fits: the fit
    takes the winner and summary it left (and clears them), so its own CV
    on the whole split's features never runs."""
    _jo, po = guarded_runs
    sel = po["selector"]
    assert sel.precomputed_ is None
    summary = GD.selected(po).selector_summary
    assert summary.validator_summary.validation_type == \
        "WorkflowCV:CrossValidation"
    assert summary.validator_summary.best.family_name == \
        summary.best_model_name
    calls = []
    validate = sel.validator.validate

    def spy(*a, **kw):
        calls.append(1)
        return validate(*a, **kw)
    sel.validator.validate = spy
    try:
        po["workflow"].train(device="cpu", dtype=torch.float64)
    finally:
        sel.validator.validate = validate
    assert calls == []


@pytest.mark.cuda
def test_guarded_workflow_on_the_card_equals_the_cpu():
    """The guarded map-feature workflow trained on the card (each fold's
    matrix uploaded and binned there, the tree kernels) and on the CPU in
    f32: the same filter results, winner and grid, fold metrics within
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the per-fold sweep's kernels run "
                    "only on the card")
    recs, srecs = GD.records(), GD.scoring_records()
    out = {}
    for dev in ("cuda", "cpu"):
        puid.reset()
        po = GD.PM.build_workflow(GD.PM.records_store(recs),
                                  families=GD.port_one_point())
        po["workflow"].with_raw_feature_filter(GD.PRFF(
            scoring_data=GD.PM.records_store(srecs))).with_workflow_cv()
        out[dev] = po["workflow"].train(device=dev)
        out[dev + "_sel"] = GD.selected(dict(po, model=out[dev]))
    assert json.dumps(out["cuda"].rff_results.to_json(), sort_keys=True) \
        == json.dumps(out["cpu"].rff_results.to_json(), sort_keys=True)
    GD.same_results(out["cpu_sel"].selector_summary,
                    out["cuda_sel"].selector_summary,
                    atol={name: 1e-4 for name in (
                        "OpLogisticRegression", "OpRandomForestClassifier",
                        "OpGBTClassifier", "OpLinearSVC")})
