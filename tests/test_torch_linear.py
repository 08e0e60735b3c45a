"""The port's linear solvers and linear families against the JAX package
on the CPU (f64): logistic regression and the linear SVC (one batched fit
over a grid against the JAX per-point fits), linear regression (both its
CG and its FISTA branch), the CG solve itself, the batched grid against a
loop over its points, and carried-over coefficients scored alike."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _jaxfit as JF
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import svm as JS
from transmogrifai_tpu_torch.models import _linfit as LF
from transmogrifai_tpu_torch.models import linear as PL
from transmogrifai_tpu_torch.models import svm as PS

RTOL = 1e-8
REGS = [0.001, 0.01, 0.1, 0.2]
ENETS = [0.1, 0.5, 0.0, 0.5]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d = 600, 12
    X = rng.normal(size=(n, d))
    X[:, 3] = rng.random(n) < 0.3
    X[:, 5] = 2.0                                   # a constant column
    y = (X[:, 0] + X[:, 3] + 0.5 * rng.normal(size=n) > 0.5) * 1.0
    w = (rng.random(n) > 0.3) * 1.0                 # a fold mask
    return X, y, w


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-14)


def test_logistic_grid_matches_jax(data):
    X, y, w = data
    coef, b = LF.fit_binary_logistic(*_t(X, y, w), REGS, ENETS)
    assert coef.shape == (len(REGS), X.shape[1])
    for i, (r, e) in enumerate(zip(REGS, ENETS)):
        jc, jb = JF.fit_binary_logistic(jnp.asarray(X), jnp.asarray(y),
                                        jnp.asarray(w), r, e)
        _close(coef[i], jc)
        _close(b[i], jb)
    assert (coef[1].abs() < 1e-12).any(), "no coefficient shrunk to 0"


def test_linear_svc_grid_matches_jax(data):
    X, y, w = data
    coef, b = PS.fit_linear_svc(*_t(X, y, w), REGS)
    for i, r in enumerate(REGS):
        jc, jb = JS.fit_linear_svc(jnp.asarray(X), jnp.asarray(y),
                                   jnp.asarray(w), r)
        _close(coef[i], jc)
        _close(b[i], jb)


@pytest.mark.parametrize("reg,enet", [(0.0, 0.0), (0.1, 0.0), (0.1, 0.5)],
                         ids=["ols", "ridge_cg", "elastic_net_fista"])
def test_fit_linear_matches_jax(data, reg, enet):
    X, _y, w = data
    yl = X @ np.linspace(-1, 1, X.shape[1]) + 0.1 * np.sin(np.arange(len(w)))
    pc, pb = LF.fit_linear(*_t(X, yl, w), reg, enet)
    jc, jb = JF.fit_linear(jnp.asarray(X), jnp.asarray(yl), jnp.asarray(w),
                           reg, enet)
    _close(pc, jc)
    _close(pb, jb)


def test_cg_solve_matches_jax():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(9, 9))
    A = M @ M.T + 9 * np.eye(9)
    b = rng.normal(size=9)
    got = LF.cg_solve(lambda v: torch.tensor(A) @ v, torch.tensor(b), 12)
    want = JF._cg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), 12)
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, b),
                               rtol=1e-10)


@pytest.mark.parametrize("family", ["lr", "svc"])
def test_batched_grid_equals_per_point_loop(data, family):
    """The [G, d] fit of a grid equals G fits of one point each."""
    X, y, w = data
    if family == "lr":
        fam = PL.LogisticRegressionFamily()
    else:
        fam = PS.LinearSVCFamily()
    Xt, yt, wt = _t(X, y, w)
    batched = fam.fit_batch(Xt, yt, wt)
    for g, (c, b) in zip(fam.grid, batched):
        (c1, b1), = fam.fit_batch(Xt, yt, wt, [g])
        np.testing.assert_allclose(c.numpy(), c1.numpy(), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(b.numpy(), b1.numpy(), rtol=1e-12)
    preds = fam.predict_batch(batched, Xt)
    assert len(preds) == len(fam.grid)
    assert all(p[2].shape == (len(y), 2) for p in preds)


def test_carried_over_coefficients_score_alike(data):
    X, y, w = data
    jc, jb = JF.fit_binary_logistic(jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(w), 0.01, 0.1)
    jm = JL.LogisticRegressionModel(np.asarray(jc), np.asarray(jb), 2)
    pm = PL.LogisticRegressionModel(np.asarray(jc), np.asarray(jb), 2)
    for a, b in zip(jm.predict_arrays(X), pm.predict_arrays(X, device="cpu")):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
    jc, jb = JS.fit_linear_svc(jnp.asarray(X), jnp.asarray(y),
                               jnp.asarray(w), 0.01)
    js = JS.LinearSVCModel(np.asarray(jc), float(jb))
    ps = PS.LinearSVCModel(np.asarray(jc), float(jb))
    for a, b in zip(js.predict_arrays(X), ps.predict_arrays(X, device="cpu")):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


def test_multinomial_names_the_roadmap_item(data):
    """Multinomial logistic regression, which raised naming ROADMAP queue
    A item 4 until it was ported, now fits: the family at three classes
    gives [K, d] coefficients equal to the JAX package's fit."""
    X, y, w = data
    y3 = y + (X[:, 1] > 0.8)
    (c, b), = PL.LogisticRegressionFamily(
        grid=[{"regParam": 0.01, "elasticNetParam": 0.1}],
        n_classes=3).fit_batch(*_t(X, y3, w))
    assert c.shape == (3, X.shape[1]) and b.shape == (3,)
    jc, jb = JF.fit_multinomial_logistic(jnp.asarray(X), jnp.asarray(y3),
                                         jnp.asarray(w), 0.01, 0.1,
                                         n_classes=3)
    _close(c, jc)
    _close(b, jb)


@pytest.mark.parametrize("n", [8, 802, 891, 4003])
def test_heads_give_equal_margins_equal_scores(n):
    """A tie of equal margins stays a tie in every head's probabilities
    wherever the rows sit (on the CPU, ``torch.sigmoid``'s vectorized loop
    and its scalar tail round apart by an ulp, which moved Titanic's AuPR
    on a GBT grid point with few leaves by 0.0016)."""
    from transmogrifai_tpu_torch.models import _treefit as PT
    m = torch.full((n,), -0.44139631, dtype=torch.float64)
    X = torch.ones((n, 1), dtype=torch.float64)
    coef = torch.tensor([-0.44139631], dtype=torch.float64)
    for _pred, _raw, prob in (
            PT.margin_head(m, 2.0, torch.float64, "classification"),
            LF.predict_binary_logistic(coef, 0.0, X),
            PS.predict_linear_svc(coef, 0.0, X)):
        assert len(torch.unique(prob[:, 1])) == 1
