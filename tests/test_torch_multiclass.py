"""Multiclass selection in the port against the JAX package on the CPU
(f64): the host metrics and threshold metrics bit for bit, the device
metrics within 1e-12, the evaluators, the ``DataCutter`` and the
validators' splits exactly, multinomial logistic regression within 1e-8 of
the largest |coefficient| and naive Bayes within 1e-12 on the same grid,
the random forest and decision tree at three classes (exact splits and
leaves), and the iris path (``iris.run`` against ``examples/iris.py``'s
``run``) at one grid point a family: the same winner, fold metrics within
1e-9, the same species names; then the JAX-trained model carried over,
models saved by either package loaded by the other, a ``label_mapping``
both ways, and the scoring engine against the layer path. A ``slow`` case
runs the default grids. Trees of 10 and 26 classes (11 and 27 stat
channels, past one launch of the card's histograms) are held exactly
against the JAX package's too; the card's class limit is shown without a
card (the check reads the device only), and, ``cuda`` marked, a 9-class
fit on the card and the wide kernels against their plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import device_metrics as JDM
from transmogrifai_tpu.evaluators import metrics as JM
from transmogrifai_tpu.models import _jaxfit as JF
from transmogrifai_tpu.models import _treefit as JT
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu.models import tuning as JTU
from transmogrifai_tpu.models.selector import \
    MultiClassificationModelSelector as JMS
from transmogrifai_tpu.models.selector import SelectedModel as JSelected
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch import iris as PI
from transmogrifai_tpu_torch.carry_over import workflow_model_from_states
from transmogrifai_tpu_torch.columns import (ColumnStore, NumericColumn,
                                             PredictionColumn)
from transmogrifai_tpu_torch.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.evaluators import device_metrics as PDM
from transmogrifai_tpu_torch.evaluators import metrics as PM
from transmogrifai_tpu_torch.models import _linfit as LF
from transmogrifai_tpu_torch.models import _treefit as PT
from transmogrifai_tpu_torch.models import linear as PL
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.models import tuning as PTU
from transmogrifai_tpu_torch.models.selector import \
    MultiClassificationModelSelector as PMS
from transmogrifai_tpu_torch.models.selector import SelectedModel
from transmogrifai_tpu_torch.types.feature_types import RealNN
from transmogrifai_tpu_torch.utils import uid as puid

K = 3
REGS = [0.001, 0.01, 0.1, 0.2]
ENETS = [0.1, 0.5, 0.0, 0.5]
TREE = {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}


def _jax_iris():
    import examples.iris as JI
    return JI


@pytest.fixture(scope="module")
def cls_data():
    """[n, 6] features and three classes, with a fold mask."""
    rng = np.random.default_rng(8)
    n = 700
    y = rng.integers(0, K, n).astype(np.float64)
    X = rng.normal(size=(n, 6))
    X[:, 0] += 1.5 * y
    X[:, 1] -= (y == 1)
    X[:, 2] = rng.random(n) < 0.3
    w = (rng.random(n) > 0.3) * 1.0
    return X, y, w


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


# -- metrics and evaluators ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_metrics_bit_identical(seed):
    rng = np.random.default_rng(seed)
    n = 300
    y = rng.integers(0, 4, n).astype(float)
    pred = np.where(rng.random(n) < 0.7, y, rng.integers(0, 4, n))
    prob = rng.dirichlet(np.ones(4), n)
    assert PM.multiclass_metrics(y, pred) == JM.multiclass_metrics(y, pred)
    assert PM.multiclass_threshold_metrics(y, prob) == \
        JM.multiclass_threshold_metrics(y, prob)
    thr = rng.random(17)
    assert PM.multiclass_threshold_metrics(y, prob, (1, 2), thr) == \
        JM.multiclass_threshold_metrics(y, prob, (1, 2), thr)
    yr, pr = rng.normal(size=n), rng.normal(size=n)
    assert PM.regression_metrics(yr, pr) == JM.regression_metrics(yr, pr)
    s = rng.random(n)
    assert PM.binary_threshold_curves(y > 1, s) == \
        JM.binary_threshold_curves(y > 1, s)


@pytest.mark.parametrize("task,metric", [
    ("multiclass", "F1"), ("multiclass", "Precision"),
    ("multiclass", "Recall"), ("multiclass", "Error"),
    ("regression", "RootMeanSquaredError"),
    ("regression", "MeanSquaredError"), ("regression", "MeanAbsoluteError"),
    ("regression", "R2")])
def test_device_metrics_match_jax(task, metric):
    rng = np.random.default_rng(5)
    n = 400
    if task == "multiclass":
        y = rng.integers(0, 4, n).astype(float)
        pred = np.where(rng.random(n) < 0.6, y, rng.integers(0, 4, n))
    else:
        y = rng.normal(size=n)
        pred = y + 0.3 * rng.normal(size=n)
    prob = rng.random((n, 4))
    w = (rng.random(n) > 0.4) * 1.0
    got = PDM.device_metric_fn(task, metric, n_classes=4)(
        *_t(y, pred, prob, w))
    want = JDM.device_metric_fn(task, metric, n_classes=4)(
        *map(jnp.asarray, (y, pred, prob, w)))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-12)
    # the device metric over a 0/1 mask is the host metric over its rows
    host = (PM.multiclass_metrics if task == "multiclass"
            else PM.regression_metrics)(y[w > 0], pred[w > 0])[metric]
    np.testing.assert_allclose(got.item(), host, rtol=0, atol=1e-12)


def test_evaluators_match_jax():
    from transmogrifai_tpu.columns import ColumnStore as JStore
    from transmogrifai_tpu.columns import NumericColumn as JNum
    from transmogrifai_tpu.columns import PredictionColumn as JPred
    from transmogrifai_tpu.evaluators import Evaluators as JE
    from transmogrifai_tpu.types.feature_types import RealNN as JRealNN
    rng = np.random.default_rng(6)
    n = 200
    y = rng.integers(0, 3, n).astype(float)
    prob = rng.dirichlet(np.ones(3), n)
    pred = prob.argmax(1).astype(float)
    yr = rng.normal(size=n)
    for factory, label, p in (("MultiClassification", y, (pred, prob)),
                              ("Regression", yr, (yr + 0.1, None))):
        cols = {}
        for pkg, Store, Num, Pred, RNN, E in (
                ("j", JStore, JNum, JPred, JRealNN, JE),
                ("p", ColumnStore, NumericColumn, PredictionColumn, RealNN,
                 PE)):
            pr = p[1] if p[1] is not None else np.zeros((n, 0))
            store = Store({"y": Num(RNN, label, np.ones(n, bool)),
                           "p": Pred(p[0], pr, pr)}, n)
            ev = getattr(E, factory)().set_columns("y", "p")
            cols[pkg] = (ev.evaluate_all(store), ev.evaluate(store),
                         ev.metric_name, ev.is_larger_better)
        assert cols["p"] == cols["j"]
    assert PE.Regression.rmse().metric_name == "RootMeanSquaredError"
    assert PE.MultiClassification.error().metric_name == "Error"


# -- DataCutter and the validators ------------------------------------------

@pytest.mark.parametrize("max_cat,min_frac", [(100, 0.0), (2, 0.0),
                                              (100, 0.2), (3, 0.1)])
def test_data_cutter_matches_jax(max_cat, min_frac):
    rng = np.random.default_rng(1)
    y = rng.choice([0.0, 2.0, 3.0, 7.0, 9.0], 500,
                   p=[0.4, 0.25, 0.2, 0.1, 0.05])
    j = JTU.DataCutter(max_label_categories=max_cat,
                       min_label_fraction=min_frac)
    p = PTU.DataCutter(max_label_categories=max_cat,
                       min_label_fraction=min_frac)
    j.pre_validation_prepare(y)
    p.pre_validation_prepare(y)
    assert p.summary == j.summary
    np.testing.assert_array_equal(p.keep_mask(y), j.keep_mask(y))
    kept = y[p.keep_mask(y)]
    np.testing.assert_array_equal(p.relabel(kept), j.relabel(kept))
    assert p.original_labels() == j.original_labels()
    assert p.original_labels() is not None


def test_data_cutter_identity_and_splitters():
    y = np.array([0.0, 1.0, 2.0, 1.0])
    for cutter in (PTU.DataCutter(), JTU.DataCutter()):
        cutter.pre_validation_prepare(y)
        assert cutter.original_labels() is None
    assert PTU.DataSplitter().original_labels() is None
    rng = np.random.default_rng(2)
    y = rng.integers(0, 3, 101).astype(float)
    for kw in (dict(train_ratio=0.7, seed=3), dict(seed=9)):
        got = PTU.TrainValidationSplit(**kw)._splits(y)
        want = JTU.TrainValidationSplit(**kw)._splits(y)
        assert len(got) == len(want) == 1
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
    got = PTU.CrossValidation(3, task="multiclass", stratify=True)._splits(y)
    want = JTU.CrossValidation(3, task="multiclass",
                               stratify=True)._splits(y)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("task,metric", [("binary", "FN"),
                                         ("binary", "TP")])
def test_host_metric_branch_matches_jax(task, metric):
    """A selection metric with no device form (binary TP / FN): the
    validator brings each fold's predictions back and ``_metric_value``
    reads them on the host; the fold metrics and the winner equal the JAX
    validator's."""
    assert PDM.device_metric_fn(task, metric) is None
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(size=600) > 0).astype(float)
    grid = [{"regParam": 0.01, "elasticNetParam": 0.0},
            {"regParam": 0.2, "elasticNetParam": 0.5}]
    jfam, jhp, jsum = JTU.CrossValidation(
        3, metric_name=metric, task=task).validate(
        [JL.LogisticRegressionFamily(grid=grid)], X, y)
    pfam, php, psum = PTU.CrossValidation(
        3, metric_name=metric, task=task).validate(
        [PL.LogisticRegressionFamily(grid=grid)], X, y, device="cpu",
        dtype=torch.float64)
    assert (pfam.name, php) == (jfam.name, jhp)
    for a, b in zip(psum.results, jsum.results):
        assert a.metric_values == b.metric_values


# -- linear models -----------------------------------------------------------

def test_multinomial_logistic_grid_matches_jax(cls_data):
    X, y, w = cls_data
    coef, b = LF.fit_multinomial_logistic(*_t(X, y, w), REGS, ENETS, K)
    assert coef.shape == (len(REGS), K, X.shape[1])
    for i, (r, e) in enumerate(zip(REGS, ENETS)):
        jc, jb = JF.fit_multinomial_logistic(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), r, e,
            n_classes=K)
        scale = np.abs(np.asarray(jc)).max()
        np.testing.assert_allclose(coef[i].numpy(), np.asarray(jc),
                                   rtol=0, atol=1e-8 * scale)
        np.testing.assert_allclose(b[i].numpy(), np.asarray(jb), rtol=0,
                                   atol=1e-8 * scale)
        for got, want in zip(
                LF.predict_multinomial_logistic(coef[i], b[i],
                                                torch.tensor(X)),
                JF.predict_multinomial_logistic(jc, jb, jnp.asarray(X))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-9, atol=1e-9)
    assert (coef[1].abs() < 1e-12).any(), "no coefficient shrunk to 0"


def test_naive_bayes_grid_matches_jax(cls_data):
    X, y, w = cls_data
    Xp = np.abs(X)
    lp, ll = LF.fit_naive_bayes(*_t(Xp, y, w), [1.0, 0.5, 2.0], K)
    for i, s in enumerate((1.0, 0.5, 2.0)):
        jlp, jll = JF.fit_naive_bayes(jnp.asarray(Xp), jnp.asarray(y),
                                      jnp.asarray(w), s, n_classes=K)
        np.testing.assert_allclose(lp[i].numpy(), np.asarray(jlp), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(ll[i].numpy(), np.asarray(jll), rtol=0,
                                   atol=1e-12)
        for got, want in zip(
                LF.predict_naive_bayes(lp[i], ll[i], torch.tensor(X)),
                JF.predict_naive_bayes(jlp, jll, jnp.asarray(X))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("family", ["lr", "nb"])
def test_multiclass_families_and_stages_match_jax(cls_data, family):
    """The families' batched fit of their default grids against the JAX
    families' fit_batch; the estimator stages and the fitted models'
    predictions against the JAX package's."""
    X, y, w = cls_data
    X = np.abs(X) if family == "nb" else X
    if family == "lr":
        pf, jf = (PL.LogisticRegressionFamily(n_classes=K),
                  JL.LogisticRegressionFamily(n_classes=K))
    else:
        pf, jf = (PL.NaiveBayesFamily(grid=[{"smoothing": 1.0},
                                            {"smoothing": 0.3}],
                                      n_classes=K),
                  JL.NaiveBayesFamily(grid=[{"smoothing": 1.0},
                                            {"smoothing": 0.3}],
                                      n_classes=K))
    got = pf.fit_batch(*_t(X, y, w))
    want = jf.fit_batch(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                        jf.stack_grid())
    for i, (a, b) in enumerate(got):
        scale = np.abs(np.asarray(want[0][i])).max()
        np.testing.assert_allclose(a.numpy(), np.asarray(want[0][i]),
                                   rtol=0, atol=1e-8 * scale)
        np.testing.assert_allclose(b.numpy(), np.asarray(want[1][i]),
                                   rtol=0, atol=1e-8 * scale)
        pm = pf.realize((a, b), pf.grid[i])
        jm = jf.realize((np.asarray(want[0][i]), np.asarray(want[1][i])),
                        jf.grid[i])
        for c, d in zip(pm.predict_arrays(X, device="cpu"),
                        jm.predict_arrays(X)):
            np.testing.assert_allclose(c, d, rtol=1e-7, atol=1e-7)
        carried = type(pm)(**jm.get_params())
        carried.apply_model_state(jm.get_model_state())
        for c, d in zip(carried.predict_arrays(X, device="cpu"),
                        jm.predict_arrays(X)):
            np.testing.assert_allclose(c, d, rtol=1e-12, atol=1e-12)


# -- trees at three classes --------------------------------------------------

@pytest.mark.parametrize("n_trees", [5, 1], ids=["forest", "decision_tree"])
@pytest.mark.parametrize("unroll", [False, True],
                         ids=["constant_slot", "unrolled"])
def test_three_class_forest_matches_jax(cls_data, n_trees, unroll):
    """Gini at four channels (three classes and the count): the same
    features, thresholds, leaf class shares and training-row leaves."""
    X, y, w = cls_data
    kw = dict(task="classification", n_classes=K, n_trees=n_trees,
              max_depth=4, n_bins=32, max_active_nodes=8, seed=7,
              unroll=unroll)
    want = JT.fit_forest(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        min_instances=jnp.asarray(5.0), min_info_gain=jnp.asarray(1e-3),
        num_trees_used=jnp.asarray(float(n_trees)),
        subsample_rate=jnp.asarray(1.0),
        depth_limit=None if unroll else jnp.asarray(3), **kw)
    got = PT.fit_forest(*_t(X, y, w), min_instances=5.0,
                        min_info_gain=1e-3, num_trees_used=float(n_trees),
                        subsample_rate=1.0,
                        depth_limit=None if unroll else 3, **kw)
    for k in ("feat", "thr", "leaf", "train_node", "tree_w"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["gain"].numpy(), np.asarray(want["gain"]),
                               rtol=1e-14, atol=1e-15)
    assert got["leaf"].shape[-1] == K
    params = {k: want[k] for k in ("feat", "thr", "leaf", "tree_w")}
    jp = JT.predict_rf_classification(params, jnp.asarray(X), 4, K)
    pp = PT.predict_rf_classification(got, torch.tensor(X), 4, K)
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def _classes_data(k, n=1000, seed=10):
    """[n, 6] features and ``k`` classes, each feature leaning on the
    class, with a fold mask."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.float64)
    X = rng.normal(size=(n, 6))
    X[:, 0] += 0.7 * y
    X[:, 1] -= 0.4 * (y % 5)
    X[:, 2] = rng.random(n) < 0.3
    X[:, 3] += (y % 3)
    w = (rng.random(n) > 0.3) * 1.0
    return X, y, w


@pytest.mark.parametrize("n_trees", [5, 1], ids=["forest", "decision_tree"])
@pytest.mark.parametrize("k", [10, 26])
def test_many_class_forest_matches_jax(k, n_trees):
    """Gini at k + 1 channels (10 and 26 classes: more than one launch of
    the card's histograms takes): the same features, thresholds, leaf
    class shares and training-row leaves as the JAX package's forest and
    decision tree, and predictions within 1e-12."""
    X, y, w = _classes_data(k)
    kw = dict(task="classification", n_classes=k, n_trees=n_trees,
              max_depth=5, n_bins=32, max_active_nodes=16, seed=7)
    want = JT.fit_forest(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        min_instances=jnp.asarray(3.0), min_info_gain=jnp.asarray(1e-3),
        num_trees_used=jnp.asarray(float(n_trees)),
        subsample_rate=jnp.asarray(1.0), depth_limit=jnp.asarray(4), **kw)
    got = PT.fit_forest(*_t(X, y, w), min_instances=3.0,
                        min_info_gain=1e-3, num_trees_used=float(n_trees),
                        subsample_rate=1.0, depth_limit=4, **kw)
    for key in ("feat", "thr", "leaf", "train_node", "tree_w"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert got["leaf"].shape[-1] == k
    assert len(np.unique(got["feat"].numpy())) > 1
    params = {key: want[key] for key in ("feat", "thr", "leaf", "tree_w")}
    jp = JT.predict_rf_classification(params, jnp.asarray(X), 5, k)
    pp = PT.predict_rf_classification(got, torch.tensor(X), 5, k)
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_more_than_seven_classes_refused_on_the_card_only():
    """The card's tree kernels take up to 64 stat channels (63 classes;
    the histograms and ``predict_trees`` in launches of 8): the check
    passes 32 and 63 classes for a CUDA device, raises past the limit
    naming it, and passes the CPU, whose plain versions take any count
    (an 8-class forest fits there)."""
    from transmogrifai_tpu_torch.models import _hist as H
    assert H.MAX_CARD_CHANNELS == 64
    for k in (7, 8, 26, 32, 63):
        PT.check_card_classes("classification", k, torch.device("cuda"))
    with pytest.raises(ValueError, match="take at most 64 .63 classes"):
        PT.check_card_classes("classification", 64, torch.device("cuda"))
    PT.check_card_classes("regression", 500, torch.device("cuda"))
    PT.check_card_classes("classification", 200, torch.device("cpu"))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 3))
    y = rng.integers(0, 8, 300).astype(float)
    X[:, 0] += y
    fam = PTR.RandomForestFamily(grid=[dict(TREE)], n_classes=8,
                                 num_trees=2)
    (p,), Xarg = fam.fit_prepared(*_t(X, y, np.ones(300)))
    assert p["leaf"].shape[-1] == 8


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wide-channel tree kernels")
    from transmogrifai_tpu_torch.models import _hist as H
    return H


@pytest.mark.cuda
def test_nine_classes_fit_through_the_kernels_on_card():
    """A 9-class forest and decision tree (10 stat channels) fit on the
    card through the kernels (each launched), with the same trees as on
    the CPU; the summed leaves bitwise the CPU's, the predictions equal
    and the class shares within 2^-22 (each device sums a row's shares
    in its own order)."""
    H = _cuda()
    X, y, w = _classes_data(9, n=2000)
    kw = dict(task="classification", n_classes=9, max_depth=6, n_bins=32,
              min_instances=5.0, min_info_gain=1e-3, subsample_rate=1.0,
              seed=7)
    for n_trees in (5, 1):
        H.reset_launch_counts()
        got = PT.fit_forest(*[t.to("cuda", torch.float32)
                              for t in _t(X, y, w)], n_trees=n_trees,
                            num_trees_used=float(n_trees), **kw)
        torch.cuda.synchronize()
        for name in ("cumhist", "group_rows", "split_scan",
                     "level_epilogue"):
            assert H.KERNEL_LAUNCHES[name] > 0, name
        want = PT.fit_forest(*[t.to(torch.float32) for t in _t(X, y, w)],
                             n_trees=n_trees, num_trees_used=float(n_trees),
                             **kw)
        for key in ("feat", "thr", "train_node"):
            assert torch.equal(got[key].cpu(), want[key]), key
        X32 = torch.tensor(X, dtype=torch.float32)
        H.reset_launch_counts()
        card = PT.predict_ensemble(got["feat"], got["thr"], got["leaf"],
                                   got["tree_w"], X32.cuda(), 6)
        assert H.KERNEL_LAUNCHES["predict_trees"] == 2     # K = 9: 8 + 1
        cpu = PT.predict_ensemble(want["feat"], want["thr"], want["leaf"],
                                  want["tree_w"], X32, 6)
        assert torch.equal(card.cpu(), cpu)
        a = PT.rf_head(card, torch.float32, "classification")
        b = PT.rf_head(cpu, torch.float32, "classification")
        assert torch.equal(a[0].cpu(), b[0])
        assert (a[2].cpu() - b[2]).abs().max().item() <= 2.0 ** -22


@pytest.mark.cuda
@pytest.mark.parametrize("C", [9, 16, 27])
def test_wide_kernels_against_their_plain_versions_on_card(C):
    """At C stat channels the histograms (counts exact, class channels
    bitwise: integer weights), the gini split scan (bitwise) and
    ``predict_trees`` at K = C - 1 leaf values (bitwise) against their
    plain versions on the card."""
    H = _cuda()
    rng = np.random.default_rng(C)
    n, F, B, A = 20_000, 16, 32, 64
    cls = rng.integers(0, C - 1, n)
    st = np.zeros((n, C), np.float32)
    st[np.arange(n), cls] = rng.integers(0, 3, n)
    st[:, -1] = st.sum(1) > 0
    stats = torch.tensor(st, device="cuda")
    node = torch.tensor(rng.integers(0, A + 1, n, dtype=np.int32),
                        device="cuda")
    XbT = torch.tensor(rng.integers(0, B, (F, n), dtype=np.int32),
                       device="cuda")
    X01 = torch.tensor((rng.random((F, n)) < 0.3).astype(np.uint8),
                       device="cuda")
    cum = H.cumhist(stats, node, XbT, A, B)
    assert torch.equal(cum, H.cumhist_reference(stats, node, XbT, A, B))
    s01 = H.cumhist_sparse01(stats, node, X01, A)
    assert torch.equal(s01, H.cumhist_sparse01_reference(stats, node, X01,
                                                         A))
    for a, b in zip(H.split_scan(cum, "gini", 5.0),
                    H.split_scan_reference(cum, "gini", 5.0)):
        assert torch.equal(a, b)
    D, T, K = 8, 10, C - 1
    X = torch.tensor(rng.normal(size=(n, F)).astype(np.float32),
                     device="cuda")
    feat = torch.tensor(rng.integers(0, F, (T, (1 << D) - 1),
                                     dtype=np.int32), device="cuda")
    thr = torch.tensor(rng.normal(size=(T, (1 << D) - 1)).astype(
        np.float32), device="cuda")
    leaf = torch.tensor(rng.normal(size=(T, 1 << D, K)).astype(np.float32),
                        device="cuda")
    assert torch.equal(H.predict_trees(X, feat, thr, leaf, D),
                       H.predict_trees_reference(X, feat, thr, leaf, D))


# -- the iris path -----------------------------------------------------------

def _families(L, N, RF, DT):
    return [L(grid=[{"regParam": 0.01, "elasticNetParam": 0.1}]), N(),
            RF(grid=[dict(TREE)], num_trees=5), DT(grid=[dict(TREE)])]


def _port_families():
    return _families(PL.LogisticRegressionFamily, PL.NaiveBayesFamily,
                     PTR.RandomForestFamily, PTR.DecisionTreeFamily)


def _run_both(path, jax_families, port_families):
    JI = _jax_iris()
    juid.reset()
    jo = JI.run(path, families=jax_families, mesh=False)
    puid.reset()
    po = PI.run(path, families=port_families, device="cpu",
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
        np.testing.assert_allclose(b.metric_values, a.metric_values,
                                   rtol=0, atol=1e-9,
                                   err_msg=f"{a.family_name} {a.hparams}")
    assert ps.splitter_summary == js.splitter_summary
    for which in ("train_evaluation", "holdout_evaluation"):
        a, b = getattr(js, which), getattr(ps, which)
        for m in ("F1", "Error", "Precision", "Recall"):
            assert abs(a[m] - b[m]) < 1e-12
        assert a["ThresholdMetrics"] == b["ThresholdMetrics"]
    for m in ("F1", "Error"):
        assert abs(po["metrics"][m] - jo["metrics"][m]) < 1e-12
    np.testing.assert_array_equal(po["predicted_labels"].values,
                                  jo["predicted_labels"].values)


@pytest.fixture(scope="module")
def iris_path(tmp_path_factory):
    return PI.generate_csv(str(tmp_path_factory.mktemp("iris")
                               / "iris.data"), 2_100, seed=42)


@pytest.fixture(scope="module")
def one_point_runs(iris_path):
    return _run_both(iris_path,
                     _families(JL.LogisticRegressionFamily,
                               JL.NaiveBayesFamily, JTR.RandomForestFamily,
                               JTR.DecisionTreeFamily),
                     _port_families())


def test_generated_iris_file_has_the_published_format(iris_path):
    lines = open(iris_path).read().splitlines()
    assert len(lines) == 2_100
    fields = [ln.split(",") for ln in lines]
    assert {len(f) for f in fields} == {5}
    names = [f[4] for f in fields]
    assert sorted(set(names)) == PI.IRIS_CLASSES
    assert all(names.count(c) == 700 for c in PI.IRIS_CLASSES)
    nums = [v for f in fields for v in f[:4]]
    blanks = sum(v == "" for v in nums)
    assert 0.005 < blanks / len(nums) < 0.02
    assert all(v == "" or (v.count(".") == 1 and len(v.split(".")[1]) == 1)
               for v in nums)


def test_one_point_per_family_picks_the_same_model(one_point_runs):
    jo, po = one_point_runs
    _same_selection(jo, po)
    assert set(po["family_seconds"]) == {
        "OpLogisticRegression", "OpNaiveBayes", "OpRandomForestClassifier",
        "OpDecisionTreeClassifier"}
    assert set(po["predicted_labels"].values) <= set(PI.IRIS_CLASSES)
    assert po["n_rows"] == 2_100


def test_default_families_are_the_references():
    want = [(type(f).__name__, f.grid, f.name)
            for f in JMS.default_families()]
    got = [(type(f).__name__, f.grid, f.name)
           for f in PMS.default_families()]
    assert got == want
    assert type(PMS.default_splitter()).__name__ == "DataCutter"
    sel = PMS.with_train_validation_split(train_ratio=0.8)
    assert (sel.task, sel.validator.metric_name,
            type(sel.validator).__name__) == \
        ("multiclass", "F1", "TrainValidationSplit")


def _port_dag(path):
    puid.reset()
    return PI.build_workflow(path, families=_port_families())


def test_engine_scores_like_the_layer_path(one_point_runs, iris_path):
    """2,100 rows through the scoring engine — the selected model and the
    de-indexer's codes inside the program — against the layer path."""
    _jo, po = one_point_runs
    model, store = po["model"], po["data"]
    eng = model.scoring_engine("cpu")
    assert [it.kind for it in eng._plan][-2:] == ["predict", "deindex"]
    a = model.score(store, device="cpu", engine=True)
    b = model.score(store, device="cpu", engine=False)
    pred, de = po["prediction"].name, po["deindexed"].name
    for col in ("prediction", "raw_prediction", "probability"):
        np.testing.assert_array_equal(getattr(a[pred], col),
                                      getattr(b[pred], col))
    np.testing.assert_array_equal(a[de].values, b[de].values)


def test_jax_trained_workflow_carried_over_scores_alike(one_point_runs,
                                                        iris_path):
    jo, _po = one_point_runs
    states = {uid: (type(st).__name__, st.get_model_state(),
                    st.get_params())
              for uid, st in jo["model"].fitted_stages.items()}
    wf = _port_dag(iris_path)
    model = workflow_model_from_states([wf["prediction"], wf["deindexed"]],
                                       states)
    store = wf["reader"].generate_store(wf["prediction"].raw_features())
    got = model.score(store, device="cpu")
    jstore = _jax_iris().DataReaders.simple.csv(
        iris_path, PI.IRIS_SCHEMA).generate_store(
            jo["model"].result_features[0].raw_features())
    want = jo["model"].score(jstore)
    for f in jo["model"].result_features:
        if hasattr(want[f.name], "probability"):
            np.testing.assert_array_equal(got[f.name].prediction,
                                          want[f.name].prediction)
            np.testing.assert_allclose(got[f.name].probability,
                                       want[f.name].probability, rtol=0,
                                       atol=1e-12)
        else:
            np.testing.assert_array_equal(got[f.name].values,
                                          want[f.name].values)


def test_saved_models_load_in_the_other_package(one_point_runs, iris_path,
                                                tmp_path):
    jo, po = one_point_runs
    jstore = _jax_iris().DataReaders.simple.csv(
        iris_path, PI.IRIS_SCHEMA).generate_store(
            jo["model"].result_features[0].raw_features())
    for src, path in ((jo["model"], tmp_path / "j"),
                      (po["model"], tmp_path / "p")):
        src.save(str(path))
        pm = PWorkflowModel.load(str(path))
        jm = JWorkflowModel.load(str(path))
        got = pm.score(po["data"], device="cpu")
        want = jm.score(jstore)
        for f in jm.result_features:
            if hasattr(want[f.name], "probability"):
                np.testing.assert_array_equal(got[f.name].prediction,
                                              want[f.name].prediction)
                np.testing.assert_allclose(got[f.name].probability,
                                           want[f.name].probability,
                                           rtol=0, atol=1e-12)
            else:
                np.testing.assert_array_equal(got[f.name].values,
                                              want[f.name].values)


def _cutter_dag(pkg, families):
    """Numeric labels {1, 4, 6} and one rare 9 that the DataCutter drops:
    the kept labels re-index to 0..2 and the model maps them back."""
    if pkg == "jax":
        from transmogrifai_tpu import FeatureBuilder as FB
        from transmogrifai_tpu.ops.transmogrifier import \
            transmogrify as tm
        S, Cut = JMS, JTU.DataCutter
    else:
        from transmogrifai_tpu_torch import FeatureBuilder as FB
        from transmogrifai_tpu_torch.dsl import transmogrify as tm
        S, Cut = PMS, PTU.DataCutter
    y = FB.RealNN("y").from_column().as_response()
    xs = [FB.Real(f"x{i}").from_column().as_predictor() for i in range(3)]
    sel = S.with_cross_validation(
        num_folds=2, families=families,
        splitter=Cut(min_label_fraction=0.05, seed=3), seed=3)
    return y.transform_with(sel, tm(xs)), sel


def _cutter_records(n=400, seed=4):
    rng = np.random.default_rng(seed)
    lab = rng.choice([1.0, 4.0, 6.0, 9.0], n, p=[0.4, 0.3, 0.28, 0.02])
    return [{"y": float(v), "x0": float(v + rng.normal()),
             "x1": float(rng.normal()), "x2": float(-v + rng.normal())}
            for v in lab]


def test_label_mapping_round_trips_both_ways(tmp_path):
    """A DataCutter that drops a label leaves a ``label_mapping``: the
    port's selection equals the JAX package's, predictions come back as
    the original labels on the layer path and through the engine, and the
    mapping survives a save in either package and a load in the other."""
    from transmogrifai_tpu import Workflow as JWorkflow
    from transmogrifai_tpu_torch import Workflow as PWorkflow
    records = _cutter_records()
    juid.reset()
    jpred, jsel = _cutter_dag("jax", [JL.LogisticRegressionFamily(
        grid=[{"regParam": 0.01, "elasticNetParam": 0.1}])])
    jm = JWorkflow().set_input_records(records).set_result_features(
        jpred).train()
    puid.reset()
    ppred, psel = _cutter_dag("port", [PL.LogisticRegressionFamily(
        grid=[{"regParam": 0.01, "elasticNetParam": 0.1}])])
    pm = PWorkflow().set_input_records(records).set_result_features(
        ppred).train(device="cpu", dtype=torch.float64)
    jsm, psm = jm.fitted_stages[jsel.uid], pm.fitted_stages[psel.uid]
    assert psm.label_mapping == jsm.label_mapping == [1.0, 4.0, 6.0]
    want = jm.score(records)[jpred.name]
    for engine in (False, True):
        got = pm.score(records, device="cpu", engine=engine)[ppred.name]
        np.testing.assert_array_equal(got.prediction, want.prediction)
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=0, atol=1e-12)
    assert set(want.prediction) <= {1.0, 4.0, 6.0}
    for src, path in ((jm, tmp_path / "j"), (pm, tmp_path / "p")):
        src.save(str(path))
        p2, j2 = PWorkflowModel.load(str(path)), JWorkflowModel.load(
            str(path))
        assert p2.fitted_stages[psel.uid].label_mapping == [1.0, 4.0, 6.0]
        assert j2.fitted_stages[jsel.uid].label_mapping == [1.0, 4.0, 6.0]
        np.testing.assert_array_equal(
            p2.score(records, device="cpu")[ppred.name].prediction,
            j2.score(records)[jpred.name].prediction)
    # the state of a JAX SelectedModel with a mapping, carried over
    jsel_model = JSelected(inner=jsm.inner, task="multiclass",
                           label_mapping=[2.0, 5.0, 7.0])
    carried = SelectedModel(**{k: v for k, v in
                               jsel_model.get_params().items()})
    carried.apply_model_state(jsel_model.get_model_state())
    X = np.random.default_rng(0).normal(size=(50, 6))
    np.testing.assert_array_equal(
        carried.predict_arrays(X, device="cpu")[0],
        jsel_model.predict_arrays(X)[0])
    np.testing.assert_array_equal(
        carried.predict_device(torch.tensor(X))[0].numpy(),
        jsel_model.predict_arrays(X)[0])


@pytest.mark.slow
def test_default_families_pick_the_same_model(iris_path):
    """The default grids of the four families."""
    jo, po = _run_both(iris_path, None, None)
    _same_selection(jo, po)
