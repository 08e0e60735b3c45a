"""The port's insights against the JAX package on the CPU (f64):
``ModelInsights`` of the guarded map-feature workflow (800 records, the
filter and workflow CV on) with a logistic-regression, a GBT and a
random-forest winner, and of the JAX test's SanityChecker flow (its
correlations and drop reasons): names, groupings, drop reasons, the label
summary and the filter's verdicts exact, every number within 1e-9
relative (the GBT's CV fold metrics within 1e-3), ``pretty()`` line for
line. The GBT refit meets the f64 tie of ROADMAP queue C: its trees split
some nodes on another column at a gain equal to the JAX package's within
1e-12 relative (and every node above such a tie alike), so they score
alike (probabilities within 1e-12) but credit other columns; the GBT
case explains the JAX package's trees, carried into the port's model. ``RecordInsightsLOCO`` over the
scoring records: ``loco_diffs`` within 1e-12 and the JSON cells with the
same keys, values within 1e-9; ``RecordInsightsCorr`` within 1e-10 (and
the JAX package's fitted corr stage rebuilt in the port from its state); a
model with a LOCO stage saved by either package loads in the other with
its scored model re-attached. A ``cuda`` case holds the LOCO and corr
device paths (the zeroed batch, ``predict_trees``, the gram product) on
the card against the CPU."""
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu import ColumnStore as JStore
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu import column_from_values as jcol
from transmogrifai_tpu import insights as JI
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JBS
from transmogrifai_tpu.ops.sanity_checker import SanityChecker as JSanity
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import ColumnStore as PStore
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import column_from_values as pcol
from transmogrifai_tpu_torch import insights as PI
from transmogrifai_tpu_torch.carry_over import fitted_stage_from_state
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.models.linear import \
    LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PBS
from transmogrifai_tpu_torch.ops.sanity_checker import \
    SanityChecker as PSanity
from transmogrifai_tpu_torch.types import feature_types as PFT
from transmogrifai_tpu_torch.utils import uid as puid
from transmogrifai_tpu_torch.workflow import WorkflowModel as PWorkflowModel

sys.path.insert(0, os.path.dirname(__file__))
import _torch_guard_data as GD  # noqa: E402

REL = 1e-9
#: one family each: the winner's kind decides the contributions
WINNERS = {"lr": 0, "rf": 1, "gbt": 2}


def _close(a, b, path, rel, loose):
    """``a`` (the port's) equals ``b`` (the JAX package's): strings,
    booleans and None exact, numbers within ``rel`` of the larger (within
    ``loose[k]`` under a key ``k`` of ``loose``)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}", loose.get(k, rel), loose)
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", rel, loose)
    elif isinstance(b, bool) or b is None or isinstance(b, str):
        assert a == b, (path, a, b)
    else:
        assert not isinstance(a, (bool, str)) and a is not None, path
        if math.isnan(b):
            assert math.isnan(a), path
        elif math.isinf(b):
            assert a == b, path
        else:
            assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-300) \
                or abs(a - b) <= loose.get("_abs", 0.0), (path, a, b)


_RUNS = {}


def _winner_runs(kind):
    """(kind, JAX run, port run) of the guarded workflow with the one
    family of ``kind``, trained once per module."""
    if kind in _RUNS:
        return _RUNS[kind]
    i = WINNERS[kind]
    jo, po = GD.guarded(GD.jax_one_point()[i:i + 1],
                        GD.port_one_point()[i:i + 1])
    if kind == "gbt":
        # the port's own trees: equivalent to the JAX package's, but for
        # the columns tied splits credit (see the module's docstring)
        sel, jinner = GD.selected(po), GD.selected(jo).inner
        po["own_inner"] = sel.inner
        sel.inner = fitted_stage_from_state(
            type(jinner).__name__, jinner.get_model_state(),
            jinner.get_params())
        sel.__dict__.pop("_device_tables", None)
    _RUNS[kind] = (kind, jo, po)
    return _RUNS[kind]


@pytest.fixture(scope="module", params=sorted(WINNERS))
def winner_runs(request):
    return _winner_runs(request.param)


def test_gbt_refit_trees_score_like_the_jax_packages():
    _kind, jo, po = _winner_runs("gbt")
    name = po["features"].name
    X = po["model"].transform(po["store"], device="cpu",
                              up_to=po["features"])[name].values
    own = po["own_inner"].predict_arrays(X, device="cpu")
    want = GD.selected(jo).inner.predict_arrays(X)
    np.testing.assert_array_equal(own[0], np.asarray(want[0]))
    np.testing.assert_allclose(own[2], np.asarray(want[2]), rtol=0,
                               atol=1e-12)


def test_gbt_refit_trees_differ_from_the_jax_packages_only_at_ties():
    """The port's own GBT refit against the JAX package's, node by node
    from the root: where every ancestor split alike (so the node holds
    the same rows in both), both split or both do not, at gains within
    1e-12 relative; on the same column and threshold, or on another
    column at that same gain, a tie that the packages' f64 sums break
    apart. The fixture holds such ties: the reason the GBT case of
    ``test_model_insights_equal_the_jax_packages`` explains the JAX
    package's trees."""
    _kind, jo, po = _winner_runs("gbt")
    jt = GD.selected(jo).inner.get_model_state()
    jf, jthr, jg = (np.asarray(jt["tree_" + k]) for k in
                    ("feat", "thr", "gain"))
    pf, pthr, pg = (np.asarray(po["own_inner"].trees[k]) for k in
                    ("feat", "thr", "gain"))
    assert pf.shape == jf.shape
    T, NN = jf.shape
    ties = []
    for t in range(T):
        alike = np.zeros(NN, dtype=bool)
        alike[0] = True
        for i in range(NN):
            if not alike[i]:
                continue
            assert np.isfinite(pthr[t, i]) == np.isfinite(jthr[t, i]), \
                (t, i)
            assert abs(pg[t, i] - jg[t, i]) <= 1e-12 * max(
                abs(pg[t, i]), abs(jg[t, i])), (t, i, pg[t, i], jg[t, i])
            split = np.isfinite(jthr[t, i])
            if split and (pf[t, i], pthr[t, i]) != (jf[t, i], jthr[t, i]):
                ties.append((t, i, int(jf[t, i]), int(pf[t, i])))
                continue
            alike[[c for c in (2 * i + 1, 2 * i + 2) if c < NN]] = True
    assert ties, "no tie: the port's trees should equal the JAX package's"


def test_model_insights_equal_the_jax_packages(winner_runs):
    kind, jo, po = winner_runs
    ji = jo["model"].model_insights(jo["prediction"], store=jo["store"])
    pi = po["model"].model_insights(po["prediction"], store=po["store"],
                                    device="cpu")
    jj, pj = ji.to_json(), pi.to_json()
    # the CV fold metrics of GBT: the f64 tie of ROADMAP queue C
    loose = {"results": 1e-3, "_abs": 0.0} if kind == "gbt" else {}
    _close(pj, jj, "insights", REL, loose)
    assert pi.pretty().splitlines() == ji.pretty().splitlines()
    assert pj["selectedModelInfo"]["validationResults"][
        "validationType"] == "WorkflowCV:CrossValidation"
    contrib = [d["contribution"] for f in pj["features"]
               for d in f["derivedFeatures"]]
    assert len(contrib) == 113 and max(c or 0.0 for c in contrib) > 0.0


def _fresh_uids():
    """Both uid counters past the fixtures' uids (the conftest resets the
    JAX package's before every test), at one start, so new stages on a
    fixture's graph get fresh uids and the same names in both packages."""
    juid.reset(1 << 20)
    puid.reset(1 << 20)


def _same_top(prow, jrow, tol):
    """Two LOCO cells alike: the |diff| of each rank within ``tol``, shared
    columns' diffs within ``tol``; columns may trade places only where
    their |diffs| tie within ``tol`` (a near tie the two packages' sums
    order either way), and entries within ``tol`` of 0 may be missing."""
    p = {k: v for k, v in prow.items() if abs(v) > tol}
    j = {k: v for k, v in jrow.items() if abs(v) > tol}
    pv, jv = list(p.values()), list(j.values())
    assert len(pv) == len(jv), (prow, jrow)
    np.testing.assert_allclose(np.abs(pv), np.abs(jv), rtol=0, atol=tol)
    for name in set(p) & set(j):
        assert abs(p[name] - j[name]) <= tol, name
    for name in set(p) ^ set(j):
        assert abs(abs(p.get(name, j.get(name))) - abs(jv[-1])) <= tol, \
            (name, prow, jrow)


def _loco_both(jo, po, top_k=5):
    """Each package's LOCO of its selected model over its scoring rows."""
    _fresh_uids()
    out = []
    for o, LOCO, kw in ((jo, JI.RecordInsightsLOCO, {}),
                        (po, PI.RecordInsightsLOCO, {"device": "cpu"})):
        sel = GD.selected(o)
        vec = sel.input_features[1]
        scored = o["model"].transform(o["score_store"], engine=False, **kw)
        loco = LOCO(model=sel, top_k=top_k, column_chunk=40)
        loco.set_input(vec)
        X = np.asarray(scored[vec.name].values, dtype=np.float64)
        out.append((loco, scored, X))
    return out


def test_loco_equals_the_jax_packages(winner_runs):
    _kind, jo, po = winner_runs
    (jl, js, jX), (pl, ps, pX) = _loco_both(jo, po)
    np.testing.assert_array_equal(pX, jX)
    jd, pd = jl.loco_diffs(jX), pl.loco_diffs(pX, device="cpu")
    assert pd.shape == jd.shape == (113, GD.N_SCORE)
    np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-12)
    jc = jl.transform_columns(js)
    pc = pl.transform_columns(ps, device="cpu")
    for i in range(GD.N_SCORE):
        _same_top(PI.parse_insights(pc.get_raw(i)),
                  PI.parse_insights(jc.get_raw(i)), 1e-9)


def test_corr_insights_equal_the_jax_packages(winner_runs):
    _kind, jo, po = winner_runs
    _fresh_uids()
    out = []
    for o, Corr, kw in ((jo, JI.RecordInsightsCorr, {}),
                        (po, PI.RecordInsightsCorr, {"device": "cpu"})):
        sel = GD.selected(o)
        est = Corr(top_k=4)
        est.set_input(o["prediction"], sel.input_features[1])
        trained = o["model"].transform(o["store"], engine=False, **kw)
        model = est.fit(trained, **kw)
        scored = o["model"].transform(o["score_store"], engine=False, **kw)
        out.append((model, model.transform_columns(scored, **kw)))
    (jm, jc), (pm, pc) = out
    carried = fitted_stage_from_state(type(jm).__name__,
                                      jm.get_model_state(), jm.get_params())
    for k in ("corr", "x_min", "x_max"):
        np.testing.assert_allclose(getattr(pm, k), getattr(jm, k), rtol=0,
                                   atol=1e-10, err_msg=k)
        np.testing.assert_array_equal(getattr(carried, k), getattr(jm, k))
    for i in range(GD.N_SCORE):
        jrow, prow = json.loads(jc.get_raw(i)), json.loads(pc.get_raw(i))
        assert list(prow) == list(jrow), i
        for name in jrow:
            assert [k for k, _ in prow[name]] == [k for k, _ in jrow[name]]
            np.testing.assert_allclose([v for _, v in prow[name]],
                                       [v for _, v in jrow[name]], rtol=0,
                                       atol=1e-10)


def _sanity_flow(pkg, rng):
    """The JAX test's flow: a strong and a weak predictor and a constant,
    SanityChecker (dropping the constant) → LR, behind the
    RawFeatureFilter (whose metrics the report attaches to each raw
    feature)."""
    Store, col, FT, FB, transmogrify, Sanity, BS, LR, Wf, RFF, kw = pkg
    n = 300
    y = rng.integers(0, 2, size=n).astype(float)
    store = Store({
        "label": col(FT.RealNN, list(y)),
        "strong": col(FT.Real, list(rng.normal(size=n) + 2.0 * y)),
        "weak": col(FT.Real, list(rng.normal(size=n))),
        "const": col(FT.Real, [3.0] * n)})
    label = FB.RealNN("label").from_column().as_response()
    feats = [FB.Real(c).from_column().as_predictor()
             for c in ("strong", "weak", "const")]
    checked = label.transform_with(
        Sanity(remove_bad_features=True, remove_feature_group=False),
        transmogrify(feats))
    pred = BS.with_cross_validation(num_folds=2, families=[LR()]) \
        .set_input(label, checked).get_output()
    model = Wf().set_result_features(pred).set_input_store(store) \
        .with_raw_feature_filter(RFF()).train(**kw)
    return model, store, pred


def test_sanity_checker_insights_equal_the_jax_packages():
    """Correlations, Cramér's V groups and drop reasons harvested from the
    SanityChecker, with a store and without."""
    juid.reset()
    jm, jstore, jpred = _sanity_flow(
        (JStore, jcol, JFT, JFB, jtransmogrify, JSanity, JBS, JLR,
         JWorkflow, GD.JRFF, {}), np.random.default_rng(42))
    puid.reset()
    pm, pstore, ppred = _sanity_flow(
        (PStore, pcol, PFT, PFB, ptransmogrify, PSanity, PBS, PLR,
         PWorkflow, GD.PRFF, {"device": "cpu", "dtype": torch.float64}),
        np.random.default_rng(42))
    reports = []
    for jkw, pkw in (({"store": jstore}, {"store": pstore, "device": "cpu"}),
                     ({}, {})):
        ji, pi = jm.model_insights(jpred, **jkw), \
            pm.model_insights(ppred, **pkw)
        _close(pi.to_json(), ji.to_json(), "insights", REL, {})
        assert pi.pretty().splitlines() == ji.pretty().splitlines()
        reports.append(pi)
    pi = reports[0]
    strong = next(f for f in pi.features if f.feature_name == "strong")
    assert strong.rff_metrics["trainingFillRate"] == 1.0
    assert not strong.rff_exclusion["excluded"]
    dropped = [d for f in pi.features for d in f.derived if d.dropped]
    assert dropped and any("variance" in r for d in dropped
                           for r in d.drop_reasons)


def _with_loco(o, LOCO, WorkflowModel):
    _fresh_uids()
    sel = GD.selected(o)
    loco = LOCO(model=sel, top_k=3)
    loco.set_input(sel.input_features[1])
    feat = loco.get_output()
    model = WorkflowModel(
        result_features=[o["prediction"], feat],
        fitted_stages={**o["model"].fitted_stages, loco.uid: loco})
    return model, feat, sel


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_loco_rebinds_after_a_save_in_the_other_package(direction, tmp_path):
    """A model with a LOCO stage saved by one package loads in the other:
    the LOCO stage holds the loaded selected model (by its uid), and its
    cells equal the saving package's."""
    _kind, jo, po = _winner_runs("gbt")
    path = str(tmp_path / "m")
    if direction == "jax_to_port":
        saved, feat, sel = _with_loco(jo, JI.RecordInsightsLOCO,
                                      JWorkflowModel)
        saved.save(path)
        loaded = PWorkflowModel.load(path)
        got = loaded.score(po["score_store"], device="cpu", engine=False)
        want = saved.score(jo["score_store"])
    else:
        saved, feat, sel = _with_loco(po, PI.RecordInsightsLOCO,
                                      PWorkflowModel)
        saved.save(path)
        loaded = JWorkflowModel.load(path)
        got = loaded.score(jo["score_store"])
        want = saved.score(po["score_store"], device="cpu", engine=False)
    stage = next(f for f in loaded.result_features
                 if f.name == feat.name).origin_stage
    assert type(stage).__name__ == "RecordInsightsLOCO"
    assert stage.model is not None and stage.model.uid == sel.uid
    assert stage.model is loaded.fitted_stages[sel.uid]
    for i in range(GD.N_SCORE):
        _same_top(PI.parse_insights(got[feat.name].get_raw(i)),
                  PI.parse_insights(want[feat.name].get_raw(i)), 1e-9)


def test_loco_needs_its_model_and_copies_carry_it():
    from transmogrifai_tpu_torch.models.linear import \
        LogisticRegressionModel
    model = LogisticRegressionModel(np.ones(3), 0.0, 2)
    loco = PI.RecordInsightsLOCO(model=model, top_k=2)
    assert loco.copy().model is model
    unbound = PI.RecordInsightsLOCO(model=None, model_uid="X_0")
    unbound.set_input(PFB.OPVector("features").from_column()
                      .as_predictor())
    from transmogrifai_tpu_torch.columns import VectorColumn
    store = PStore({"features": VectorColumn(PFT.OPVector, np.zeros((2, 3)),
                                             None)})
    with pytest.raises(RuntimeError, match="unbound"):
        unbound.transform_columns(store, device="cpu")
    assert np.array_equal(loco.loco_diffs(np.zeros((4, 3)), device="cpu"),
                          np.zeros((3, 4)))


@pytest.mark.cuda
def test_loco_and_corr_on_the_card_equal_the_cpu():
    """One fitted model's LOCO on the card (the zeroed batch built there;
    an LR winner's GEMMs, a GBT's ``predict_trees``) against the CPU: the
    diffs within 1e-6 (an f32 model: each probability within 2^-22); and
    the corr fit and importances, in f64, within 1e-10."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the device paths run only on the "
                    "card")
    recs, srecs = GD.records(), GD.scoring_records()
    for kind in ("lr", "gbt"):
        i = WINNERS[kind]
        puid.reset()
        po = GD.PM.build_workflow(GD.PM.records_store(recs),
                                  families=GD.port_one_point()[i:i + 1])
        po["workflow"].with_raw_feature_filter(GD.PRFF(
            scoring_data=GD.PM.records_store(srecs))).with_workflow_cv()
        model = po["workflow"].train(device="cuda")
        sel = model.fitted_stages[po["selector"].uid]
        vec = sel.input_features[1]
        scored = model.transform(GD.PM.records_store(srecs), device="cpu",
                                 engine=False)
        X = np.asarray(scored[vec.name].values, dtype=np.float64)
        loco = PI.RecordInsightsLOCO(model=sel, top_k=5)
        loco.set_input(vec)
        np.testing.assert_allclose(loco.loco_diffs(X, device="cuda"),
                                   loco.loco_diffs(X, device="cpu"), rtol=0,
                                   atol=1e-6, err_msg=kind)
        est = PI.RecordInsightsCorr(top_k=4)
        est.set_input(po["prediction"], vec)
        trained = model.transform(GD.PM.records_store(recs), device="cpu",
                                  engine=False)
        card, cpu = est.fit(trained, device="cuda"), \
            est.fit(trained, device="cpu")
        np.testing.assert_allclose(card.corr, cpu.corr, rtol=0, atol=1e-10)
        np.testing.assert_allclose(card.importances(X, device="cuda")[1],
                                   card.importances(X, device="cpu")[1],
                                   rtol=0, atol=1e-10)
