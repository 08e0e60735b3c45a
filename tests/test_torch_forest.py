"""Random forests and decision trees of the port against the JAX package
on the CPU (f64): the bootstrap weights and the per-tree and per-node
feature masks bit for bit, ``fit_forest`` (gini and variance, both level
drivers, one block and two) with exact features, thresholds, leaves and
training-row leaves, a decision tree, the training-row prediction against
routed prediction, and a JAX-fitted forest carried over and scored."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu_torch import random as R
from transmogrifai_tpu_torch.models import _treefit as PT
from transmogrifai_tpu_torch.models import trees as PTR

N, B, D, T = 2000, 32, 4, 5


def _data(task, two_blocks, seed=0):
    """6 Gaussian columns and, for two blocks, 10 indicator columns; the
    label reads both. Regression targets are integers, so every
    histogram sum and every leaf is exact."""
    rng = np.random.default_rng(seed)
    Xc = rng.normal(size=(N, 6))
    Xbin = (rng.random((N, 10)) < rng.uniform(0.1, 0.5, 10)).astype(float)
    y = ((Xc[:, 0] > 0.2) ^ (Xbin[:, 0] > 0.5)
         | (Xbin[:, 3] > 0.5)).astype(np.float64)
    if task == "regression":
        y = y * 3 + np.round(2 * Xc[:, 1])
    if not two_blocks:
        return Xc, y, None
    return (np.concatenate([Xc, Xbin], 1), y,
            np.array([False] * 6 + [True] * 10))


def _fit_both(task, unroll, two_blocks, per_node=True, n_trees=T,
              w=None):
    X, y, mask = _data(task, two_blocks)
    w = np.ones(N) if w is None else w
    kw = dict(task=task, n_classes=2, n_trees=n_trees, max_depth=D,
              n_bins=B, max_active_nodes=8, seed=7,
              per_node_features=per_node, unroll=unroll)
    want = JT.fit_forest(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), binary_mask=mask,
        min_instances=jnp.asarray(5.0), min_info_gain=jnp.asarray(1e-3),
        num_trees_used=jnp.asarray(float(n_trees)),
        subsample_rate=jnp.asarray(1.0),
        depth_limit=None if unroll else jnp.asarray(D - 1), **kw)
    got = PT.fit_forest(
        torch.tensor(X), torch.tensor(y), torch.tensor(w), binary_mask=mask,
        min_instances=5.0, min_info_gain=1e-3,
        num_trees_used=float(n_trees), subsample_rate=1.0,
        depth_limit=None if unroll else D - 1, **kw)
    return X, y, got, {k: np.asarray(v) for k, v in want.items()}


def _assert_same_forest(got, want):
    for k in ("feat", "thr", "leaf", "train_node", "tree_w"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the JAX level body is compiled with the gain's operations fused; a
    # gain is a difference of impurities of order 0.25, so it agrees to a
    # few ulps of the impurities, not of itself
    np.testing.assert_allclose(got["gain"].numpy(), want["gain"],
                               rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.8])
def test_bootstrap_weights_bitwise(rate):
    blocks = PT.prepare_blocks(torch.zeros((4, 300), dtype=torch.int32), B)
    draws = PT.forest_draws(7, T, 300, "classification", 3, 4, blocks,
                            torch.float64, "cpu")
    got = draws.bootstrap(rate, torch.float64).numpy()
    k_boot, _ = jax.random.split(jax.random.PRNGKey(7))
    for t in range(T):
        want = JT.poisson_bootstrap_weights(
            jax.random.fold_in(k_boot, t), jnp.asarray(rate), 300,
            jnp.float64)
        np.testing.assert_array_equal(got[t], np.asarray(want))
    assert (got > 1).any() and (got == 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_feature_masks_bitwise(dtype):
    """Per-tree masks, and the per-node masks of every level and slot,
    drawn at the fit dtype's width."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    F, k, cap = 23, 5, 8
    key = jax.random.PRNGKey(11)
    with jax.enable_x64(dtype == torch.float64):
        want = np.asarray(JT._feature_masks(key, T, F, k))
    got = PT.feature_masks(R.PRNGKey(11), T, F, k, dtype, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(1) == k).all()
    tkeys = jax.random.split(key, T)
    u = PT.node_feature_uniforms(R.split(R.PRNGKey(11), T), 3, cap, F,
                                 dtype, "cpu")
    for t in range(T):
        for d in range(3):
            ju = jax.random.uniform(jax.random.fold_in(tkeys[t], d),
                                    (cap, F), jdt)
            kth = jnp.sort(ju, axis=1)[:, k - 1][:, None]
            np.testing.assert_array_equal(u[t, d].numpy(), np.asarray(ju))
            np.testing.assert_array_equal(
                PT._kth_mask(u[t, d], k).numpy(), np.asarray(ju <= kth))


@pytest.mark.parametrize("unroll", [False, True],
                         ids=["constant_slot", "unrolled"])
@pytest.mark.parametrize("two_blocks", [False, True],
                         ids=["one_block", "two_blocks"])
def test_fit_forest_gini_matches_jax(unroll, two_blocks):
    _X, _y, got, want = _fit_both("classification", unroll, two_blocks)
    _assert_same_forest(got, want)
    assert (got["thr"].numpy() == 0.5).any() == two_blocks


@pytest.mark.parametrize("unroll", [False, True],
                         ids=["constant_slot", "unrolled"])
def test_fit_forest_variance_matches_jax(unroll):
    _X, _y, got, want = _fit_both("regression", unroll, True)
    _assert_same_forest(got, want)


def test_fit_forest_per_tree_masks_and_fold_weights_match_jax():
    w = (np.random.default_rng(3).random(N) > 0.3).astype(np.float64)
    _X, _y, got, want = _fit_both("classification", False, True,
                                  per_node=False, w=w)
    _assert_same_forest(got, want)


def test_decision_tree_matches_jax():
    """One tree: no bootstrap, every feature a candidate."""
    _X, _y, got, want = _fit_both("classification", True, True, n_trees=1)
    _assert_same_forest(got, want)


def test_train_node_prediction_equals_routed_prediction():
    X, y, got, _want = _fit_both("classification", False, True)
    fam = PTR.RandomForestFamily(num_trees=T)
    binned = {"edges": torch.zeros((1, 1), dtype=torch.float64)}
    on_train = fam.predict_batch([got], binned, on_train=True)[0]
    fam.grid = [{"maxDepth": D}]
    routed = fam.predict_batch([got], torch.tensor(X))[0]
    np.testing.assert_array_equal(on_train[0].numpy(), routed[0].numpy())
    np.testing.assert_allclose(on_train[2].numpy(), routed[2].numpy(),
                               rtol=0, atol=1e-12)


def test_jax_forest_carried_over_scores_identically():
    X, y, mask = _data("classification", True)
    jfam = JTR.RandomForestFamily(
        grid=[{"maxDepth": D, "minInstancesPerNode": 5,
               "minInfoGain": 1e-3}], num_trees=T)
    jfam.binary_mask = mask
    params, _ = jfam.fit_prepared(jnp.asarray(X), jnp.asarray(y),
                                  jnp.ones(N))
    single = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], params)
    jmodel = jfam.realize(single, jfam.grid[0])
    model = PTR.tree_model_from_numpy(jmodel.kind, jmodel.n_classes,
                                      jmodel.max_depth, jmodel.trees)
    Xs = np.random.default_rng(1).normal(size=(500, X.shape[1]))
    Xs[:, 6:] = Xs[:, 6:] > 0.3
    for a, b in zip(jmodel.predict_arrays(Xs),
                    model.predict_arrays(Xs, device="cpu")):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_forest_on_the_card_matches_the_cpu():
    """f32 on the card (gini epilogue, masked split scans, draws made on
    the card) and on the CPU grow the same forest: the stats are integer
    class weights, which both histograms sum exactly."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the kernels run only on the card")
    X, y, mask = _data("classification", True)
    out = {}
    for dev in ("cuda", "cpu"):
        t = [torch.tensor(a, dtype=torch.float32, device=dev)
             for a in (X, y, np.ones(N))]
        for unroll in (False, True):
            out[dev, unroll] = PT.fit_forest(
                *t, task="classification", n_classes=2, n_trees=T,
                max_depth=D, n_bins=B, min_instances=5.0,
                min_info_gain=1e-3, num_trees_used=float(T),
                subsample_rate=1.0, max_active_nodes=8,
                depth_limit=None if unroll else D - 1, binary_mask=mask,
                unroll=unroll)
    for unroll in (False, True):
        for k in ("feat", "thr", "leaf", "train_node"):
            assert torch.equal(out["cuda", unroll][k].cpu(),
                               out["cpu", unroll][k]), (k, unroll)


@pytest.mark.parametrize("name,kw", [
    ("OpRandomForestClassifier", dict(num_trees=3, max_depth=3)),
    ("OpDecisionTreeRegressor", dict(max_depth=3)),
    ("OpLogisticRegression", dict(reg_param=0.01)),
    ("OpLinearSVC", dict(reg_param=0.01))])
def test_estimator_stages_match_jax_at_f32(name, kw):
    """The standalone estimators as a deployment runs them, in f32: the
    JAX package with x64 off draws its forest's uniforms at 32 bits, and
    the port takes the draw's width from the fit's dtype. Predictions
    exact; scores within f32 rounding."""
    import transmogrifai_tpu as J
    import transmogrifai_tpu_torch as P
    from transmogrifai_tpu.columns import VectorColumn as JV
    from transmogrifai_tpu.models import linear as JL
    from transmogrifai_tpu.models import svm as JS
    from transmogrifai_tpu.types import feature_types as jft
    from transmogrifai_tpu_torch.columns import VectorColumn as PV
    from transmogrifai_tpu_torch.models import linear as PL
    from transmogrifai_tpu_torch.models import svm as PS
    from transmogrifai_tpu_torch.types import feature_types as pft
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    X[:, 5] = X[:, 5] > 0
    y = ((X[:, 0] > 0) ^ (X[:, 5] > 0)).astype(np.float64)
    fitted = []
    for pkg, ft, V, mods in ((J, jft, JV, (JTR, JL, JS)),
                             (P, pft, PV, (PTR, PL, PS))):
        label = pkg.FeatureBuilder.RealNN("label").from_column().as_response()
        feats = (pkg.FeatureBuilder.OPVector("features").from_column()
                 .as_predictor())
        est = next(getattr(m, name) for m in mods if hasattr(m, name))(**kw)
        label.transform_with(est, feats)
        store = pkg.ColumnStore({
            "label": pkg.column_from_values(ft.RealNN, y),
            "features": V(ft.OPVector, X)})
        if pkg is J:
            with jax.enable_x64(False):
                fitted.append(est.fit(store).predict_arrays(X))
        else:
            fitted.append(est.fit(store, device="cpu").predict_arrays(
                X, device="cpu"))
    (jp, jr, jq), (pp, pr, pq) = fitted
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_allclose(pr, jr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pq, jq, rtol=0, atol=1e-6)
