"""Regression selection in the port against the JAX package on the CPU
(f64): linear regression's batched grid within 1e-8 of the largest
|coefficient|, the GBT and XGBoost regressors (families, estimator stages
and routed predictions; exact splits, leaves within 1e-9 as
``test_torch_treefit.py`` holds them), the regression selector's defaults,
and the boston path (``boston.run`` against ``examples/boston.py``'s
``run``) at one grid point a family: the same winner, fold metrics within
1e-9 (GBT's within 1e-3, as ``test_torch_titanic.py`` allows), then the
JAX-trained model carried over, models saved by either package loaded by
the other and the scoring engine against the layer path. A ``slow`` case
runs the default grids."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _jaxfit as JF
from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu.models.selector import RegressionModelSelector as JRS
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch import boston as PB
from transmogrifai_tpu_torch.carry_over import workflow_model_from_states
from transmogrifai_tpu_torch.models import _linfit as LF
from transmogrifai_tpu_torch.models import _treefit as PT
from transmogrifai_tpu_torch.models import linear as PL
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.models.selector import \
    RegressionModelSelector as PRS
from transmogrifai_tpu_torch.utils import uid as puid

REGS = [0.001, 0.01, 0.1, 0.0, 0.2]
ENETS = [0.1, 0.5, 0.0, 0.0, 0.5]
TREE = {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}


def _jax_boston():
    import examples.boston as JB
    return JB


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.fixture(scope="module")
def reg_data():
    rng = np.random.default_rng(12)
    n = 600
    X = rng.normal(size=(n, 5))
    X[:, 3] = rng.random(n) < 0.3
    y = 2.0 * X[:, 0] - X[:, 1] ** 2 + 1.5 * X[:, 3] \
        + 0.2 * rng.normal(size=n)
    w = (rng.random(n) > 0.3) * 1.0
    return X, y, w


def _leaf_index(X, feat, thr, depth):
    """[T, n] leaf each row reaches in each tree."""
    out = []
    for f, t in zip(feat, thr):
        node = np.zeros(len(X), np.int64)
        for d in range(depth):
            pos = (1 << d) - 1 + node
            node = 2 * node + (X[np.arange(len(X)), f[pos]] > t[pos])
        out.append(node)
    return np.stack(out)


def _trees_equal(jp, pp, X, w, depth):
    """Features exact, leaves, gains and the weighted rows' training
    margins within 1e-9. Thresholds exact, but for the f64 tie that
    ``test_torch_treefit.py`` allows: two edges with no weighted row of
    the node between them, which the histograms' summation order picks
    either way, so every weighted row reaches the same leaf."""
    live = w > 0
    np.testing.assert_array_equal(pp["feat"].numpy(), np.asarray(jp["feat"]))
    a, b = np.asarray(jp["thr"]), pp["thr"].numpy()
    np.testing.assert_array_equal(
        _leaf_index(X[live], pp["feat"].numpy(), b, depth),
        _leaf_index(X[live], np.asarray(jp["feat"]), a, depth))
    assert (a != b).mean() <= 0.05, "thr: more than rare ties differ"
    for k in ("leaf", "gain"):
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-9, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(pp["train_margin"].numpy()[live],
                               np.asarray(jp["train_margin"])[live],
                               rtol=1e-9, atol=1e-9)


def test_linear_regression_grid_matches_jax(reg_data):
    """One batched FISTA run for the grid points with an L1 part, the CG
    solve for the others, against the JAX per-point fits."""
    X, y, w = reg_data
    coef, b = LF.fit_linear_grid(*_t(X, y, w), REGS, ENETS)
    for i, (r, e) in enumerate(zip(REGS, ENETS)):
        jc, jb = JF.fit_linear(jnp.asarray(X), jnp.asarray(y),
                               jnp.asarray(w), r, e)
        scale = np.abs(np.asarray(jc)).max()
        np.testing.assert_allclose(coef[i].numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-8 * scale)
        np.testing.assert_allclose(b[i].item(), float(jb), rtol=0,
                                   atol=1e-8 * scale)
        pc, pb = LF.fit_linear(*_t(X, y, w), r, e)
        np.testing.assert_allclose(coef[i].numpy(), pc.numpy(), rtol=1e-12,
                                   atol=1e-14)


def test_linear_regression_family_and_stage_match_jax(reg_data):
    X, y, w = reg_data
    pf, jf = PL.LinearRegressionFamily(), JL.LinearRegressionFamily()
    assert pf.grid == jf.grid and pf.name == jf.name
    got = pf.fit_batch(*_t(X, y, w))
    jc, jb = jf.fit_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                          jf.stack_grid())
    for i, (c, b) in enumerate(got):
        scale = np.abs(np.asarray(jc[i])).max()
        np.testing.assert_allclose(c.numpy(), np.asarray(jc[i]), rtol=0,
                                   atol=1e-8 * scale)
        pm = pf.realize((c, b), pf.grid[i])
        jm = jf.realize((np.asarray(jc[i]), np.asarray(jb[i])), jf.grid[i])
        carried = PL.LinearRegressionModel(**jm.get_params())
        carried.apply_model_state(jm.get_model_state())
        for model, tol in ((pm, 1e-7), (carried, 1e-12)):
            got_p = model.predict_arrays(X, device="cpu")
            want_p = jm.predict_arrays(X)
            np.testing.assert_allclose(got_p[0], want_p[0], rtol=tol,
                                       atol=tol)
            assert got_p[2].shape == want_p[2].shape == (len(y), 0)


@pytest.mark.parametrize("kind", ["gbt", "xgb"])
@pytest.mark.parametrize("unroll", [False, True],
                         ids=["constant_slot", "unrolled"])
def test_boosted_regressors_match_jax(reg_data, kind, unroll):
    X, y, w = reg_data
    kw = dict(task="regression", n_rounds=4, max_depth=4, n_bins=32,
              max_active_nodes=8, unroll=unroll)
    if kind == "gbt":
        jp = JT.fit_gbt(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                        min_instances=jnp.asarray(5.0),
                        min_info_gain=jnp.asarray(0.0),
                        step_size=jnp.asarray(0.3),
                        num_rounds_used=jnp.asarray(4.0),
                        depth_limit=None if unroll else jnp.asarray(3), **kw)
        pp = PT.fit_gbt(*_t(X, y, w), min_instances=5.0, min_info_gain=0.0,
                        step_size=0.3, num_rounds_used=4.0,
                        depth_limit=None if unroll else 3, **kw)
    else:
        jp = JT.fit_xgb(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                        eta=jnp.asarray(0.3), lam=1.0,
                        min_child_weight=jnp.asarray(1.0),
                        num_rounds_used=jnp.asarray(4.0),
                        depth_limit=None if unroll else jnp.asarray(3), **kw)
        pp = PT.fit_xgb(*_t(X, y, w), eta=0.3, lam=1.0,
                        min_child_weight=1.0, num_rounds_used=4.0,
                        depth_limit=None if unroll else 3, **kw)
    _trees_equal(jp, pp, X, w, 4)
    Xn = np.random.default_rng(1).normal(size=(300, 5))
    params = {k: jp[k] for k in ("feat", "thr", "leaf", "tree_w")}
    # fresh rows may fall between the edges of a tie: both packages route
    # them through the JAX package's trees
    want = JT.predict_margin_regression(params, jnp.asarray(Xn), 4)
    got = PT.predict_margin_regression(
        {k: torch.tensor(np.asarray(v)) for k, v in params.items()},
        torch.tensor(Xn), 4)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-9, atol=1e-9)
    assert got[2].shape == (300, 0)


@pytest.mark.parametrize("kind", ["gbt", "xgb"])
def test_regressor_families_and_stages_match_jax(reg_data, kind):
    """The families (``task="regression"``): name, fit on the binned
    matrix, training predictions and routed predictions; the estimator
    stages ``OpGBTRegressor`` / ``OpXGBoostRegressor`` against the JAX
    stages on the same store."""
    X, y, w = reg_data
    if kind == "gbt":
        grid = [dict(TREE, maxDepth=3, maxIter=5)]
        pf = PTR.GBTFamily(grid=grid, task="regression")
        jf = JTR.GBTFamily(grid=grid, task="regression")
    else:
        grid = [{"maxDepth": 3, "eta": 0.3, "minChildWeight": 1.0,
                 "numRound": 5}]
        pf = PTR.XGBoostFamily(grid=grid, task="regression")
        jf = JTR.XGBoostFamily(grid=grid, task="regression")
    assert (pf.name, pf.task) == (jf.name, jf.task)
    (params,), Xarg = pf.fit_prepared(*_t(X, y, w))
    train = pf.predict_batch([params], Xarg, on_train=True)[0]
    routed = pf.predict_batch([params], torch.tensor(X))[0]
    np.testing.assert_allclose(train[0].numpy(), routed[0].numpy(),
                               rtol=1e-12, atol=1e-12)
    jparams, _ = jf.fit_prepared(jnp.asarray(X, jnp.float64),
                                 jnp.asarray(y), jnp.asarray(w))
    jmodel = jf.realize({k: np.asarray(v)[0] for k, v in jparams.items()},
                        grid[0])
    pmodel = pf.realize(params, grid[0])
    assert pmodel.kind == jmodel.kind == f"{kind}_regression"
    np.testing.assert_allclose(
        pmodel.predict_arrays(X, device="cpu")[0], jmodel.predict_arrays(X)[0],
        rtol=1e-9, atol=1e-9)

    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu_torch import FeatureBuilder as PFB
    from transmogrifai_tpu.columns import ColumnStore as JStore
    from transmogrifai_tpu.columns import NumericColumn as JNum
    from transmogrifai_tpu.columns import VectorColumn as JVec
    from transmogrifai_tpu_torch.columns import (ColumnStore, NumericColumn,
                                                 VectorColumn)
    from transmogrifai_tpu.types import feature_types as jft
    from transmogrifai_tpu_torch.types import feature_types as pft
    stage = {"gbt": ("OpGBTRegressor", dict(max_iter=3, max_depth=3)),
             "xgb": ("OpXGBoostRegressor", dict(num_round=3, max_depth=3))}
    name, kw = stage[kind]
    models = {}
    for pkg, FB, Store, Num, Vec, ft, mod in (
            ("j", JFB, JStore, JNum, JVec, jft, JTR),
            ("p", PFB, ColumnStore, NumericColumn, VectorColumn, pft, PTR)):
        lab = FB.RealNN("y").from_column().as_response()
        vec = FB.of(ft.OPVector, "x").from_column().as_predictor()
        est = getattr(mod, name)(**kw)
        est.set_input(lab, vec)
        store = Store({"y": Num(ft.RealNN, y, np.ones(len(y), bool)),
                       "x": Vec(ft.OPVector, X.astype(np.float32))}, len(y))
        if pkg == "p":
            models[pkg] = est.fit(store, device="cpu", dtype=torch.float32)
        else:
            # an f32 deployment of the JAX package runs with x64 off
            with jax.enable_x64(False):
                models[pkg] = est.fit(store)
    assert models["p"].kind == models["j"].kind == f"{kind}_regression"
    for k in ("feat", "thr"):
        np.testing.assert_array_equal(models["p"].trees[k],
                                      np.asarray(models["j"].trees[k]))
    np.testing.assert_allclose(models["p"].predict_arrays(X, device="cpu")[0],
                               models["j"].predict_arrays(X)[0], rtol=1e-5,
                               atol=1e-5)


def test_default_families_are_the_references():
    want = [(type(f).__name__, f.grid, f.name, getattr(f, "task", None))
            for f in JRS.default_families()]
    got = [(type(f).__name__, f.grid, f.name, getattr(f, "task", None))
           for f in PRS.default_families()]
    assert got == want
    assert type(PRS.default_splitter()).__name__ == "DataSplitter"
    sel = PRS.with_cross_validation()
    assert (sel.task, sel.validator.metric_name,
            sel.validator.is_larger_better) == \
        ("regression", "RootMeanSquaredError", False)


# -- the boston path ---------------------------------------------------------

def _families(RF, G):
    return [RF(grid=[dict(TREE)], task="regression", num_trees=5),
            G(grid=[dict(TREE, maxDepth=3)], task="regression")]


def _run_both(path, jax_families, port_families):
    JB = _jax_boston()
    juid.reset()
    jo = JB.run(path, families=jax_families, mesh=False)
    puid.reset()
    po = PB.run(path, families=port_families, device="cpu",
                dtype=torch.float64)
    return jo, po


def _same_selection(jo, po):
    js, ps = jo["summary"], po["summary"]
    assert (ps.best_model_name, ps.best_model_params) == \
        (js.best_model_name, js.best_model_params)
    jr, pr = js.validator_summary.results, ps.validator_summary.results
    assert [(r.family_name, r.hparams) for r in pr] == \
        [(r.family_name, r.hparams) for r in jr]
    for a, b in zip(jr, pr):
        tol = 1e-3 if a.family_name == "OpGBTRegressor" else 1e-9
        np.testing.assert_allclose(b.metric_values, a.metric_values,
                                   rtol=0, atol=tol,
                                   err_msg=f"{a.family_name} {a.hparams}")
    for which in ("train_evaluation", "holdout_evaluation"):
        a, b = getattr(js, which), getattr(ps, which)
        for m in ("RootMeanSquaredError", "R2", "MeanAbsoluteError"):
            assert abs(a[m] - b[m]) < 1e-6 * max(1.0, abs(a[m]))
    for m in ("RootMeanSquaredError", "R2"):
        assert abs(po["metrics"][m] - jo["metrics"][m]) \
            < 1e-6 * max(1.0, abs(jo["metrics"][m]))


@pytest.fixture(scope="module")
def boston_path(tmp_path_factory):
    return PB.generate_data(str(tmp_path_factory.mktemp("boston")
                                / "housing.data"), 2_100, seed=42)


@pytest.fixture(scope="module")
def one_point_runs(boston_path):
    return _run_both(boston_path,
                     _families(JTR.RandomForestFamily, JTR.GBTFamily),
                     _families(PTR.RandomForestFamily, PTR.GBTFamily))


def test_generated_boston_file_has_the_published_format(boston_path):
    JB = _jax_boston()
    records = JB.load_records(boston_path)
    assert records == PB.load_records(boston_path)
    assert len(records) == 2_100
    cols = {k: np.array([r[k] for r in records]) for k in PB.BOSTON_SCHEMA}
    assert set(np.unique(cols["chas"])) == {0.0, 1.0}
    assert 0.04 < cols["chas"].mean() < 0.10
    assert set(np.unique(cols["rad"])) <= set(PB.RAD_COUNTS)
    for k, (lo, hi) in PB.RANGES.items():
        assert cols[k].min() >= lo - 1e-9 and cols[k].max() <= hi + 1e-9, k
    assert cols["medv"].min() >= 5.0 and cols["medv"].max() <= 50.0
    # medv follows rm and lstat as the published target does
    assert np.corrcoef(cols["rm"], cols["medv"])[0, 1] > 0.5
    assert np.corrcoef(cols["lstat"], cols["medv"])[0, 1] < -0.5


def test_one_point_per_family_picks_the_same_model(one_point_runs):
    jo, po = one_point_runs
    _same_selection(jo, po)
    assert set(po["family_seconds"]) == {"OpRandomForestRegressor",
                                         "OpGBTRegressor"}


def test_engine_scores_like_the_layer_path(one_point_runs):
    _jo, po = one_point_runs
    model, records = po["model"], po["data"]
    eng = model.scoring_engine("cpu")
    assert eng.covers_prediction
    a = model.score(records, device="cpu", engine=True)
    b = model.score(records, device="cpu", engine=False)
    name = po["prediction"].name
    np.testing.assert_array_equal(a[name].prediction, b[name].prediction)
    assert a[name].probability.shape == (len(records), 0)


def test_jax_trained_workflow_carried_over_and_saved_scores_alike(
        one_point_runs, boston_path, tmp_path):
    """The JAX run's fitted stages rebuilt in the port's DAG of the same
    workflow, and each package's saved model loaded by the other: the
    same predictions within 1e-12 (the JAX package sums the trees in
    chunks of 16 under XLA, the port in tree order)."""
    jo, po = one_point_runs
    records = po["data"]
    states = {uid: (type(st).__name__, st.get_model_state(),
                    st.get_params())
              for uid, st in jo["model"].fitted_stages.items()}
    puid.reset()
    wf = PB.build_workflow(records, families=_families(
        PTR.RandomForestFamily, PTR.GBTFamily))
    carried = workflow_model_from_states([wf["prediction"]], states)
    name = jo["model"].result_features[0].name
    want = jo["model"].score(records)[name].prediction
    got = carried.score(records, device="cpu")[wf["prediction"].name]
    np.testing.assert_allclose(got.prediction, want, rtol=0, atol=1e-12)
    for src, path in ((jo["model"], tmp_path / "j"),
                      (po["model"], tmp_path / "p")):
        src.save(str(path))
        pm = PWorkflowModel.load(str(path))
        jm = JWorkflowModel.load(str(path))
        nm = jm.result_features[0].name
        np.testing.assert_allclose(
            pm.score(records, device="cpu")[nm].prediction,
            jm.score(records)[nm].prediction, rtol=0, atol=1e-12)


@pytest.mark.slow
def test_default_families_pick_the_same_model(boston_path):
    """The RF and GBT regressors' default grids."""
    jo, po = _run_both(boston_path, None, None)
    _same_selection(jo, po)
