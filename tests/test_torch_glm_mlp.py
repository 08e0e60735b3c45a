"""GLM (IRLS over four families) and the MLP in the port against the JAX
package on the CPU, f64.

Tolerances: GLM coefficients and intercepts within 1e-9 of the largest
|coefficient| (each family alone and the default grid batched); the MLP's
initial weights bitwise (f32 and f64); its fitted weights within 1e-9 of
the largest |weight| and its probabilities within 1e-9 after 100 Adam
steps (observed: ~1e-15, the autograd and the XLA gradient summing in
another order); selectors over these families pick the same grid point
with fold metrics within 1e-9; saved models score alike both ways
(predictions equal, margins and probabilities within 1e-12); the
bin-score evaluator's numbers exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.evaluators import Evaluators as JEv
from transmogrifai_tpu.models import glm as JG
from transmogrifai_tpu.models import selector as JS
from transmogrifai_tpu.models import svm as JM
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtm
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch.carry_over import workflow_model_from_states
from transmogrifai_tpu_torch.dsl import transmogrify as ptm
from transmogrifai_tpu_torch.evaluators import Evaluators as PEv
from transmogrifai_tpu_torch.models import glm as PG
from transmogrifai_tpu_torch.models import selector as PS
from transmogrifai_tpu_torch.models import svm as PM
from transmogrifai_tpu_torch.scoring import _classify
from transmogrifai_tpu_torch.utils import uid as puid

F64 = dict(device="cpu", dtype=torch.float64)


def _xy(n=300, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = np.ones(n)
    w[: n // 6] = 0.0                      # a fold mask
    return rng, X, w


def _close(got, want, tol=1e-9):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(np.asarray(got) - want).max() <= tol * scale


@pytest.mark.parametrize("family", sorted(JG.FAMILY_IDS))
def test_glm_each_family(family):
    rng, X, w = _xy()
    eta = X @ rng.normal(size=5) * 0.3
    y = {"gaussian": eta + rng.normal(size=300),
         "poisson": rng.poisson(np.exp(eta)).astype(float),
         "gamma": rng.gamma(2.0, np.exp(eta) / 2.0),
         "binomial": (rng.random(300) < 1 / (1 + np.exp(-eta))).astype(
             float)}[family]
    fid = JG.FAMILY_IDS[family]
    jc, jb = JG.fit_glm(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                        jnp.asarray(fid), jnp.asarray(0.01))
    pc, pb = PG.fit_glm(torch.tensor(X), torch.tensor(y), torch.tensor(w),
                        [fid], [0.01])
    _close(pc[0].numpy(), jc)
    _close([float(pb[0])], [float(jb)], 1e-9 * max(np.abs(jc).max(), 1))
    jmu = np.asarray(JG.predict_glm(jc, jb, jnp.asarray(X),
                                    jnp.asarray(fid))[0])
    pmu = PG.predict_glm(pc[0], pb[0], torch.tensor(X), fid)[0].numpy()
    np.testing.assert_allclose(pmu, jmu, rtol=1e-9, atol=1e-12)


def test_glm_default_grid_batched():
    rng, X, w = _xy(seed=1)
    y = np.abs(X @ rng.normal(size=5) + rng.normal(size=300))
    jf, pf = JG.GLMRegressionFamily(), PG.GLMRegressionFamily()
    jc, jb = jf.fit_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                          jf.stack_grid())
    params = pf.fit_batch(torch.tensor(X), torch.tensor(y), torch.tensor(w))
    assert len(params) == len(pf.grid) == 8
    _close(np.stack([p[0].numpy() for p in params]), jc)
    jpred = jf.predict_batch((jc, jb), jnp.asarray(X))
    for i, (mu, raw, prob) in enumerate(pf.predict_batch(params,
                                                         torch.tensor(X))):
        np.testing.assert_allclose(mu.numpy(), np.asarray(jpred[0][i]),
                                   rtol=1e-9, atol=1e-12)
        assert raw.shape == prob.shape == (300, 0)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_mlp_initial_weights_bitwise(dt):
    jdt = jnp.float32 if dt == torch.float32 else jnp.float64
    for sizes in ((5, 10, 3), (8, 10, 2), (26, 16, 10, 2)):
        ref = JM._mlp_init(jax.random.PRNGKey(3), sizes, jdt)
        got = PM.mlp_init(3, sizes, dt)
        for (jw, jb), (pw, pb) in zip(ref, got):
            assert np.array_equal(np.asarray(jw), pw)
            assert np.array_equal(np.asarray(jb), pb)


def test_mlp_fit_and_predict_match_jax():
    rng, X, w = _xy(seed=2)
    y = ((X[:, 0] + X[:, 1] > 0).astype(float) + (X[:, 2] > 1))
    jf, pf = JM.MLPFamily(n_classes=3), PM.MLPFamily(n_classes=3)
    jp = jf.fit_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), {})
    pp = pf.fit_batch(torch.tensor(X), torch.tensor(y), torch.tensor(w))
    for gi in range(2):
        for li in range(2):
            _close(pp[gi][li][0].numpy(), np.asarray(jp[li][0][gi]))
            _close(pp[gi][li][1].numpy(), np.asarray(jp[li][1][gi]))
    jout = jf.predict_batch(jp, jnp.asarray(X))
    for gi, (pred, logits, prob) in enumerate(
            pf.predict_batch(pp, torch.tensor(X))):
        np.testing.assert_allclose(prob.numpy(), np.asarray(jout[2][gi]),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(pred.numpy(), np.asarray(jout[0][gi]))


def test_mlp_family_refuses_mixed_layer_specs():
    fam = PM.MLPFamily(grid=[{"stepSize": 0.01, "layers": (10,)},
                             {"stepSize": 0.01, "layers": (4,)}])
    X = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="single hidden-layer spec"):
        fam.fit_batch(X, torch.zeros(4, dtype=torch.float64),
                      torch.ones(4, dtype=torch.float64))


def test_new_predictors_fuse_as_predict():
    m = PM.MLPModel(layers=[2, 3, 2])
    m.weights = [(np.ones((2, 3)), np.zeros(3)), (np.ones((3, 2)),
                                                   np.zeros(2))]
    pred, logits, prob = m.predict_device(torch.ones((4, 2)))
    assert pred.shape == (4,) and logits.shape == prob.shape == (4, 2)
    assert _classify(m) == "predict"
    g = PG.GLMRegressionModel(np.ones(2), 0.5, "poisson")
    assert _classify(g) == "predict"
    mu = g.predict_device(torch.zeros((3, 2), dtype=torch.float64))[0]
    np.testing.assert_allclose(mu.numpy(), np.exp(0.5))


def _records(n=240, seed=3):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=n), rng.normal(size=n)
    cat = rng.choice(["x", "y", "z"], size=n)
    y_cls = ((a + (cat == "x") + 0.3 * rng.normal(size=n)) > 0.5).astype(
        float)
    y_reg = np.exp(0.4 * a - 0.2 * b + 0.1 * rng.normal(size=n))
    return [{"a": float(a[i]), "b": None if i % 11 == 0 else float(b[i]),
             "cat": str(cat[i]), "yc": float(y_cls[i]),
             "yr": float(y_reg[i])} for i in range(n)]


def _dag(FB, tm, S, family, label):
    y = FB.RealNN(label).from_column().as_response()
    vec = tm([FB.Real("a").from_column().as_predictor(),
              FB.Real("b").from_column().as_predictor(),
              FB.PickList("cat").from_column().as_predictor()])
    cls = (S.BinaryClassificationModelSelector if label == "yc"
           else S.RegressionModelSelector)
    sel = cls.with_cross_validation(num_folds=2, families=[family], seed=5)
    return y, y.transform_with(sel, vec), sel


CASES = {"mlp": (lambda M: M.MLPFamily(grid=[{"stepSize": 0.03,
                                               "layers": (6,)}]), "yc"),
         "glm": (lambda G: G.GLMRegressionFamily(), "yr")}
MODS = {"mlp": (JM, PM), "glm": (JG, PG)}


def _train_both(kind, records):
    make, label = CASES[kind]
    jmod, pmod = MODS[kind]
    juid.reset()
    jy, jpred, jsel = _dag(JFB, jtm, JS, make(jmod), label)
    jm = JWorkflow().set_input_records(records).set_result_features(
        jpred).train()
    puid.reset()
    py, ppred, psel = _dag(PFB, ptm, PS, make(pmod), label)
    pm = PWorkflow().set_input_records(records).set_result_features(
        ppred).train(**F64)
    return (jm, jpred, jsel), (pm, ppred, psel)


def _same_scores(got, want, kind):
    """MLP: predictions equal. GLM: predictions (μ) within 1e-12 relative
    (an exp that rounds apart by an ulp). Margins and probabilities
    within 1e-12."""
    if kind == "mlp":
        np.testing.assert_array_equal(got.prediction, want.prediction)
    else:
        np.testing.assert_allclose(got.prediction, want.prediction,
                                   rtol=1e-12, atol=0)
    for k in ("raw_prediction", "probability"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_selector_picks_alike_and_saves_load_both_ways(kind, tmp_path):
    records = _records()
    (jm, jpred, jsel), (pm, ppred, psel) = _train_both(kind, records)
    js = jm.fitted_stages[jsel.uid].selector_summary
    ps = pm.fitted_stages[psel.uid].selector_summary
    assert ps.best_model_name == js.best_model_name
    assert ps.best_model_params == js.best_model_params
    for a, b in zip(ps.validator_summary.results,
                    js.validator_summary.results):
        np.testing.assert_allclose(a.metric_values, b.metric_values,
                                   rtol=0, atol=1e-9)
    want = jm.score(records)[jpred.name]
    _same_scores(pm.score(records, device="cpu")[ppred.name], want, kind)
    # JAX-saved → port, port-saved → JAX
    jm.save(str(tmp_path / "j"))
    loaded = PWorkflowModel.load(str(tmp_path / "j"))
    _same_scores(loaded.score(records, device="cpu")[jpred.name], want,
                 kind)
    pm.save(str(tmp_path / "p"))
    back = JWorkflowModel.load(str(tmp_path / "p"))
    _same_scores(back.score(records)[ppred.name],
                 pm.score(records, device="cpu")[ppred.name], kind)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_carried_over_model_scores_alike(kind):
    """The JAX package's fitted states (the selected GLM / MLP weights
    and the vectorizers) carried into the port's DAG score alike."""
    records = _records(seed=9)
    (jm, jpred, _), _ = _train_both(kind, records)
    states = {uid: (type(st).__name__, st.get_model_state(),
                    st.get_params())
              for uid, st in jm.fitted_stages.items()}
    make, label = CASES[kind]
    puid.reset()
    _, ppred, _ = _dag(PFB, ptm, PS, make(MODS[kind][1]), label)
    model = workflow_model_from_states([ppred], states)
    _same_scores(model.score(records, device="cpu")[ppred.name],
                 jm.score(records)[jpred.name], kind)


def test_bin_score_evaluator_matches_jax():
    records = _records()
    (jm, jpred, jsel), (pm, ppred, psel) = _train_both("mlp", records)
    jy = [f for f in jpred.parents if f.is_response][0]
    py = [f for f in ppred.parents if f.is_response][0]
    jout = jm.evaluate(records, JEv.BinScore(num_bins=10).set_columns(
        jy, jpred))
    pout = pm.evaluate(records, PEv.BinScore(num_bins=10).set_columns(
        py, ppred), device="cpu")
    assert pout["NumberOfDataPoints"] == jout["NumberOfDataPoints"]
    assert pout["BinCenters"] == jout["BinCenters"]
    np.testing.assert_allclose(pout["BrierScore"], jout["BrierScore"],
                               rtol=1e-9)
    assert PEv.BinScore().metric_name == "BrierScore"
