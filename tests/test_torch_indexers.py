"""The port's string indexers (``ops/indexers.py``) and the DSL's
``indexed`` against the JAX package: labels in frequency
order, null and unseen values, the index-to-string transformer and the
prediction de-indexer, exactly; the fitted stages carried over from the
JAX package; and the de-indexer inside the scoring engine's program
(label codes on the device, strings on the host) equal to the layer
path, with an unseen value and an out-of-range prediction."""
import numpy as np
import pytest
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu.columns import ColumnStore as JStore
from transmogrifai_tpu.columns import NumericColumn as JNum
from transmogrifai_tpu.columns import PredictionColumn as JPred
from transmogrifai_tpu.columns import TextColumn as JText
from transmogrifai_tpu.ops import indexers as JI
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch.columns import ColumnStore as PStore
from transmogrifai_tpu_torch.columns import NumericColumn as PNum
from transmogrifai_tpu_torch.columns import PredictionColumn as PPred
from transmogrifai_tpu_torch.columns import TextColumn as PText
from transmogrifai_tpu_torch.ops import indexers as PI
from transmogrifai_tpu_torch.types import feature_types as pft
from transmogrifai_tpu_torch.utils import uid as puid

TRAIN = ["b", "a", None, "c", "b", "a", "b", "d", "a", None, "c", "c"]
SCORE = ["a", "zz", None, "d", "b", "c", "new", "b"]

PKGS = {"jax": (JFB, JStore, JNum, JPred, JText, JI, jft, juid),
        "port": (PFB, PStore, PNum, PPred, PText, PI, pft, puid)}


def _text_store(pkg, values):
    FB, Store, _Num, _Pred, Text, _I, ft, _uid = PKGS[pkg]
    return Store({"s": Text(ft.Text, np.asarray(values, dtype=object))},
                 len(values))


def _fit_indexer(pkg, values, **kw):
    FB, _S, _N, _P, _T, I, _ft, uid = PKGS[pkg]
    uid.reset()
    s = FB.Text("s").from_column().as_predictor()
    est = I.OpStringIndexerNoFilter(**kw)
    out = s.transform_with(est)
    return est.fit(_text_store(pkg, values)), out


@pytest.mark.parametrize("unseen", [None, "Other"])
def test_string_indexer_matches_jax(unseen):
    kw = {} if unseen is None else {"unseen_name": unseen}
    models = {pkg: _fit_indexer(pkg, TRAIN, **kw)[0] for pkg in PKGS}
    assert models["port"].labels == models["jax"].labels == \
        ["a", "b", "c", "null", "d"]
    assert models["port"].get_model_state() == \
        models["jax"].get_model_state()
    cols = {pkg: m.transform(_text_store(pkg, SCORE))[m.output_name]
            for pkg, m in models.items()}
    np.testing.assert_array_equal(cols["port"].values, cols["jax"].values)
    np.testing.assert_array_equal(cols["port"].mask, cols["jax"].mask)
    assert cols["port"].labels == cols["jax"].labels
    assert cols["port"].values[1] == 5.0        # unseen → len(labels)
    assert cols["port"].labels[-1] == (unseen or "UnseenLabel")
    # the JAX package's fitted indexer carried over
    from transmogrifai_tpu_torch.carry_over import fitted_stage_from_state
    jm = models["jax"]
    carried = fitted_stage_from_state(type(jm).__name__,
                                      jm.get_model_state(), jm.get_params())
    carried.input_features = models["port"].input_features
    col = carried.transform(_text_store("port", SCORE))[carried.output_name]
    np.testing.assert_array_equal(col.values, cols["jax"].values)
    assert col.labels == cols["jax"].labels


def test_index_to_string_and_deindexer_match_jax():
    idx = np.array([0.0, 2.0, 4.0, 7.0, -1.0, 1.0])
    labels = ["x", "y", "z", "w", "v"]
    got = {}
    for pkg, (FB, Store, Num, Pred, Text, I, ft, uid) in PKGS.items():
        uid.reset()
        r = FB.RealNN("r").from_column().as_response()
        store = Store({"r": Num(ft.RealNN, idx, np.ones(len(idx), bool),
                                labels=labels + ["UnseenLabel"]),
                       "p": Pred(idx, np.zeros((6, 0)), np.zeros((6, 0)))},
                      6)
        i2s = I.OpIndexToStringNoFilter(labels=labels, unseen_name="?")
        r.transform_with(i2s)
        p = FB.of(ft.Prediction, "p").from_column().as_predictor()
        de = I.PredictionDeIndexer()
        de.set_input(r, p)
        dm = de.fit(store)
        got[pkg] = (list(i2s.transform(store)[i2s.output_name].values),
                    list(dm.transform(store)[dm.output_name].values),
                    dm.get_model_state())
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["x", "z", "v", "?", "?", "y"]


def test_deindexer_without_labels_raises():
    PFB_ = PKGS["port"][0]
    r = PFB_.RealNN("r").from_column().as_response()
    p = PFB_.of(pft.Prediction, "p").from_column().as_predictor()
    de = PI.PredictionDeIndexer()
    de.set_input(r, p)
    store = PStore({"r": PNum(pft.RealNN, np.zeros(2), np.ones(2, bool)),
                    "p": PPred(np.zeros(2), np.zeros((2, 0)),
                               np.zeros((2, 0)))}, 2)
    with pytest.raises(ValueError, match="label/index"):
        de.fit(store)


def test_dsl_indexed_builds_the_reference_stage():
    from transmogrifai_tpu import dsl as _jdsl  # noqa: F401
    from transmogrifai_tpu_torch import dsl as _pdsl  # noqa: F401
    got = {}
    for pkg, (FB, *_rest) in PKGS.items():
        PKGS[pkg][-1].reset()
        idx = FB.Text("lab").from_column().as_response().indexed()
        got[pkg] = (type(idx.origin_stage).__name__, idx.name,
                    idx.ftype.__name__)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "OpStringIndexerNoFilter"


def test_codes_device_equal_the_host_lookup():
    m = PI.PredictionDeIndexerModel(labels=["a", "b", "c"], unseen_name="u")
    pred = torch.tensor([0.0, 2.0, 1.0, 3.0, -1.0, 2.9])
    codes = m.codes_device(pred)
    assert codes.dtype == torch.int64
    assert codes.tolist() == [0, 2, 1, 3, 3, 2]
    assert list(m.label_column(codes.numpy()).values) == \
        ["a", "c", "b", "u", "u", "c"]


def test_engine_deindexes_like_the_layer_path():
    """A workflow indexing a text label, selecting a model and
    de-indexing its prediction, scored through the engine (the
    de-indexer's codes computed in the program) and layer by layer, on
    records with an unseen label and a missing one."""
    from transmogrifai_tpu_torch import Workflow
    from transmogrifai_tpu_torch.dsl import transmogrify
    from transmogrifai_tpu_torch.models import (
        LogisticRegressionFamily, MultiClassificationModelSelector)
    rng = np.random.default_rng(3)
    n = 300
    cls = rng.choice(["red", "green", "blue"], n)
    recs = [{"c": str(c), "x": float((c == "red") * 3 + rng.normal()),
             "z": float((c == "blue") * 3 + rng.normal())} for c in cls]
    puid.reset()
    c = PFB.Text("c").from_column().as_response()
    lab = c.indexed()
    vec = transmogrify([PFB.Real("x").from_column().as_predictor(),
                        PFB.Real("z").from_column().as_predictor()])
    sel = MultiClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[LogisticRegressionFamily(
            grid=[{"regParam": 0.01, "elasticNetParam": 0.1}])])
    pred = lab.transform_with(sel, vec)
    de = lab.transform_with(PI.PredictionDeIndexer(), pred)
    model = Workflow().set_input_records(recs).set_result_features(
        pred, de).train(device="cpu", dtype=torch.float64)
    score = recs[:40] + [{"c": "purple", "x": 0.1, "z": 3.0},
                         {"c": None, "x": 2.0, "z": 0.0}]
    eng = model.scoring_engine("cpu")
    assert [it.kind for it in eng._plan][-1] == "deindex"
    a = model.score(score, device="cpu", engine=True)
    b = model.score(score, device="cpu", engine=False)
    np.testing.assert_array_equal(a[de.name].values, b[de.name].values)
    np.testing.assert_array_equal(a[pred.name].prediction,
                                  b[pred.name].prediction)
    assert set(a[de.name].values) <= {"red", "green", "blue"}
    agree = np.mean(a[de.name].values[:40] == cls[:40])
    assert agree > 0.8
