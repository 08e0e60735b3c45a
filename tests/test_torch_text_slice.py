"""The port's second slice against the JAX package on the CPU (f64): the
BigPassenger workflow — typed raw records → transmogrify → SanityChecker →
GBT + XGBoost k-fold CV → refit → evaluate — through
``transmogrifai_tpu_torch.big_passenger.run`` and
``examples/big_passenger.run(..., mesh=False)`` on the same 3,000 records.

Tolerances: the selection, grid point, SanityChecker keep-indices and
tree thresholds are exact; tree features too, except that a split on one
of two complementary indicator columns (gender Female / Male) may take the
other, a mirror image (their scores tie in exact arithmetic, and the f64
histogram sums' order breaks the tie); every training row then gets the
same leaf value in every tree, within 1e-9. Fold metrics within 1e-9 (f64
sums in another order); scores within
1e-12; evaluations within 1e-3 after merging ulp-level score ties (a tie
that is exact in one package can sit one ulp apart in the other). A
JAX-trained workflow carried over stage by stage scores within 1e-12."""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models.trees import GBTFamily as JG
from transmogrifai_tpu.models.trees import XGBoostFamily as JX
from transmogrifai_tpu.ops.sanity_checker import SanityCheckerModel as JSCM
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import big_passenger as PB
from transmogrifai_tpu_torch.carry_over import workflow_model_from_states
from transmogrifai_tpu_torch.evaluators.metrics import aupr
from transmogrifai_tpu_torch.models import GBTFamily as PG
from transmogrifai_tpu_torch.models import XGBoostFamily as PX
from transmogrifai_tpu_torch.utils import uid as puid

N_ROWS = 3000


def _grid(G, X):
    gbt = [{"maxDepth": d, "minInstancesPerNode": 10, "minInfoGain": 0.001,
            "maxIter": 5} for d in (2, 3)]
    xgb = [{"maxDepth": 2, "numRound": 5, "eta": 0.3,
            "minChildWeight": 1.0}]
    return [G(grid=gbt, max_iter=5), X(grid=xgb)]


@pytest.fixture(scope="module")
def runs():
    import examples.big_passenger as JB
    records = JB.synthesize_records(N_ROWS, seed=42)
    juid.reset()
    jo = JB.run(N_ROWS, num_folds=2, families=_grid(JG, JX), mesh=False)
    puid.reset()
    po = PB.run(N_ROWS, num_folds=2, families=_grid(PG, PX), device="cpu",
                dtype=torch.float64, records=records)
    return records, jo, po


def _leaf_values(X, trees, depth):
    """[T, n] leaf value (first channel) each row reaches in each tree."""
    out = []
    for f, t, leaf in zip(trees["feat"], trees["thr"], trees["leaf"]):
        node = np.zeros(len(X), np.int64)
        for d in range(depth):
            pos = (1 << d) - 1 + node
            node = 2 * node + (X[np.arange(len(X)), f[pos]] > t[pos])
        out.append(leaf[node, 0])
    return np.stack(out)


def _jax_selected(jo):
    return next(s for s in jo["model"].fitted_stages.values()
                if hasattr(s, "selector_summary"))


def test_same_stages_and_sanity_keep_indices(runs):
    _r, jo, po = runs
    jm, pm = jo["model"], po["model"]
    assert sorted(pm.fitted_stages) == sorted(jm.fitted_stages)
    jsan = next(s for s in jm.fitted_stages.values()
                if isinstance(s, JSCM))
    assert po["sanity"].keep_indices == jsan.keep_indices
    blocks = po["blocks"]
    assert blocks["binary"] > 10 * blocks["continuous"] > 0


def test_slice_picks_the_same_model_with_the_same_fold_metrics(runs):
    _r, jo, po = runs
    js, ps = jo["summary"], po["summary"]
    assert ps.best_model_name == js.best_model_name
    assert ps.best_model_params == js.best_model_params
    jr, pr = js.validator_summary.results, ps.validator_summary.results
    assert [(r.family_name, r.hparams) for r in pr] == \
        [(r.family_name, r.hparams) for r in jr]
    for a, b in zip(jr, pr):
        np.testing.assert_allclose(b.metric_values, a.metric_values,
                                   rtol=0, atol=1e-9)
    assert ps.splitter_summary == js.splitter_summary


def test_refit_trees_scores_and_evaluations_match(runs):
    records, jo, po = runs
    inner_j = _jax_selected(jo).inner
    inner_p = po["model"].fitted_stages[
        next(u for u in po["model"].fitted_stages
             if u.startswith("ModelSelector"))].inner
    jt, pt = inner_j.trees, inner_p.trees
    np.testing.assert_array_equal(pt["thr"], jt["thr"])
    assert (pt["thr"] == 0.5).any(), "no indicator-column split"
    checked = po["sanity"].output_name
    X = po["model"].score(records, keep_intermediate=True,
                          device="cpu")[checked].values
    fj, fp = jt["feat"], pt["feat"]
    for a, b in zip(fj[fj != fp], fp[fj != fp]):
        assert (X[:, a] + X[:, b] == 1.0).all(), ("not a mirror", a, b)
    np.testing.assert_allclose(_leaf_values(X, pt, inner_p.max_depth),
                               _leaf_values(X, jt, inner_j.max_depth),
                               rtol=1e-9, atol=1e-9)
    jpred = jo["model"].result_features[0].name
    want = jo["model"].score(records)[jpred].probability[:, 1]
    got = po["scored"][po["prediction"].name].probability[:, 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    y = np.array([r["survived"] for r in records])
    assert aupr(y, np.round(got, 12)) == aupr(y, np.round(want, 12))
    js, ps = jo["summary"], po["summary"]
    for which in ("train_evaluation", "holdout_evaluation"):
        for m in ("AuPR", "AuROC", "Error"):
            assert abs(getattr(ps, which)[m] - getattr(js, which)[m]) < 1e-3
    assert abs(po["metrics"]["AuPR"] - jo["metrics"]["AuPR"]) < 1e-3


def test_jax_trained_workflow_carried_over_scores_the_same(runs):
    records, jo, _po = runs
    jm = jo["model"]
    states = {uid: (type(s).__name__, s.get_model_state(), s.get_params())
              for uid, s in jm.fitted_stages.items()}
    puid.reset()
    _label, _checked, _sel, prediction = PB.build_selection(
        _grid(PG, PX), num_folds=2)
    assert prediction.name == jm.result_features[0].name
    carried = workflow_model_from_states([prediction], states)
    got = carried.score(records[:700], device="cpu")[prediction.name]
    want = jm.score(records[:700])[prediction.name]
    for k in ("prediction", "raw_prediction", "probability"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-12, atol=1e-12)
