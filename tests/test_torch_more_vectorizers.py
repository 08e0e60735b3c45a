"""The port's vectorizers of sets, geolocations, date lists, buckets,
scalers and token lists against the JAX package on the CPU, on seeded
stores: fitted host state and vectors exact (both build them from the
same host arrays in the same dtype), vector metadata equal, and
``transmogrify`` over one feature of every type the JAX package's
dispatch accepts, one at a time and all at once."""
import os
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu.types import feature_types as JFT
import transmogrifai_tpu_torch as P

sys.path.insert(0, os.path.dirname(__file__))
import _torch_typed_data as TD  # noqa: E402

N = 300

#: every type ``transmogrify`` dispatches on its own (OPVector passes
#: through; Prediction is a model output)
TYPES = sorted(n for n in JFT.FEATURE_TYPE_REGISTRY
               if n not in ("Prediction", "OPVector"))


def _state_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _state_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _state_equal(x, y)
    else:
        assert b == a and type(b) is type(a), (a, b)


def _fitted(model, f):
    return model.fitted_stages[f.origin_stage.uid]


def _check_both(build, columns, state=True):
    js, ps = TD.stores(columns)
    (jm, jf, jc), (pm, pf, pc) = TD.run_both(build, js, ps)
    assert pf.name == jf.name
    if hasattr(jc, "metadata"):
        TD.assert_same_vector(jc, pc)
    else:
        np.testing.assert_array_equal(pc.values, jc.values)
        np.testing.assert_array_equal(pc.mask, jc.mask)
    if state and jf.origin_stage.uid in jm.fitted_stages:
        _state_equal(_fitted(jm, jf).get_model_state(),
                     _fitted(pm, pf).get_model_state())
        _state_equal(_fitted(jm, jf).get_params(), _fitted(pm, pf).get_params())
    return jm, pm, jf, pf


@pytest.mark.parametrize("type_name", TYPES)
def test_transmogrify_each_type(type_name):
    """One feature of the type through ``transmogrify``: the JAX
    package's vector and metadata exactly."""
    rng = np.random.default_rng(sum(map(ord, type_name)))
    _check_both(lambda pkg: pkg.dsl.transmogrify(
        [TD.raw_feature(pkg, type_name, "x")]),
        {"x": (type_name, TD.typed_values(type_name, N, rng))})


@pytest.mark.parametrize("raw_vector", [False, True])
def test_transmogrify_every_type_at_once(raw_vector):
    """Every type in one ``transmogrify``; a raw OPVector (no metadata)
    joins as it is and leaves the combination without metadata in both."""
    rng = np.random.default_rng(7)
    names = TYPES + (["OPVector"] if raw_vector else [])
    cols = {f"f_{t}": (t, TD.typed_values(t, N, rng)) for t in names}
    jm, pm, jf, pf = _check_both(lambda pkg: pkg.dsl.transmogrify(
        [TD.raw_feature(pkg, t, f"f_{t}") for t in names]), cols)
    for uid, stage in jm.fitted_stages.items():
        _state_equal(stage.get_model_state(),
                     pm.fitted_stages[uid].get_model_state())


@pytest.mark.parametrize("top_k,min_support", [(20, 10), (2, 1), (5, 200)])
def test_set_vectorizer(top_k, min_support):
    rng = np.random.default_rng(1)

    def build(pkg):
        from importlib import import_module
        onehot = import_module(f"{pkg.__name__}.ops.onehot")
        return TD.raw_feature(pkg, "MultiPickList", "s").transform_with(
            onehot.SetVectorizer(top_k=top_k, min_support=min_support),
            TD.raw_feature(pkg, "MultiPickList", "t"))
    jm, pm, _, pf = _check_both(build, {
        "s": ("MultiPickList", TD.typed_values("MultiPickList", N, rng)),
        "t": ("MultiPickList", TD.typed_values("MultiPickList", N, rng))})
    assert _fitted(pm, pf).is_set


def _ops(pkg, mod):
    from importlib import import_module
    return import_module(f"{pkg.__name__}.ops.{mod}")


@pytest.mark.parametrize("geo_mean", [True, False])
def test_geolocation_vectorizer(geo_mean):
    rng = np.random.default_rng(2)
    _check_both(lambda pkg: TD.raw_feature(pkg, "Geolocation", "g")
                .transform_with(_ops(pkg, "geo").GeolocationVectorizer(
                    fill_with_geo_mean=geo_mean),
                    TD.raw_feature(pkg, "Geolocation", "h")),
                {"g": ("Geolocation", TD.typed_values("Geolocation", N, rng)),
                 "h": ("Geolocation", TD.typed_values("Geolocation", N, rng,
                                                      null_share=0.6))})


@pytest.mark.parametrize("pivot,ref", [
    ("SinceLast", None), ("SinceFirst", None),
    ("SinceLast", TD.EPOCH_2020_MS + 500 * 86_400_000)])
def test_date_list_vectorizer(pivot, ref):
    rng = np.random.default_rng(3)
    _check_both(lambda pkg: TD.raw_feature(pkg, "DateList", "d")
                .transform_with(_ops(pkg, "date_list").DateListVectorizer(
                    pivot=pivot, reference_date_ms=ref),
                    TD.raw_feature(pkg, "DateTimeList", "e")),
                {"d": ("DateList", TD.typed_values("DateList", N, rng)),
                 "e": ("DateTimeList",
                       TD.typed_values("DateTimeList", N, rng))})


def _reals(rng, n=N):
    """Reals with values on bucket edges and far outside them."""
    v = TD.typed_values("Real", n, rng)
    v[:6] = [0.0, 5.0, 10.0, -50.0, 50.0, 1e-9]
    return v


@pytest.mark.parametrize("splits,kw", [
    (None, {}), (None, {"num_buckets": 7, "track_nulls": False}),
    ([-np.inf, 0.0, 5.0, np.inf], {}),
    ([0.0, 5.0, 10.0], {"track_invalid": True}),
    ([0.1, 0.1000000001, 3.0], {"track_invalid": True})])
def test_numeric_bucketizer(splits, kw):
    rng = np.random.default_rng(4)
    _check_both(lambda pkg: TD.raw_feature(pkg, "Real", "r")
                .bucketize(splits=splits, **kw),
                {"r": ("Real", _reals(rng))})


@pytest.mark.parametrize("kw", [{}, {"max_depth": 2, "track_invalid": True},
                                {"min_info_gain": 0.2}])
def test_decision_tree_bucketizer(kw):
    rng = np.random.default_rng(5)
    x = _reals(rng)
    y = [float((v or 0.0) > 3.0) if rng.random() < 0.9 else
         float(rng.random() < 0.5) for v in x]
    jm, pm, jf, pf = _check_both(
        lambda pkg: TD.raw_feature(pkg, "Real", "x").auto_bucketize(
            TD.raw_feature(pkg, "RealNN", "y", response=True), **kw),
        {"x": ("Real", x), "y": ("RealNN", y)})
    # the fitted model reads the numeric input only
    assert [f.name for f in _fitted(pm, pf).input_features] == ["x"]
    assert len(_fitted(pm, pf).splits[0]) > 2


def test_scalar_standard_scaler():
    rng = np.random.default_rng(6)
    _check_both(lambda pkg: TD.raw_feature(pkg, "Real", "r").transform_with(
        _ops(pkg, "scalers").OpScalarStandardScaler()),
        {"r": ("Real", _reals(rng))})


@pytest.mark.parametrize("kind,kw", [("linear", {"slope": 2.5,
                                                 "intercept": -1.0}),
                                     ("logarithmic", {})])
def test_scaler_and_descaler(kind, kw):
    rng = np.random.default_rng(8)
    vals = [None if v is None else abs(v) + 0.5 for v in _reals(rng)]

    def scaled(pkg):
        return TD.raw_feature(pkg, "Real", "r").scaled(kind, **kw)

    def descaled(pkg):
        s = scaled(pkg)
        return s.descaled(s)
    _check_both(scaled, {"r": ("Real", vals)})
    _, _, _, pf = _check_both(descaled, {"r": ("Real", vals)})
    assert pf.origin_stage.operation_name == "descaled"


@pytest.mark.parametrize("block", ["reals", "tfidf"])
def test_vector_standard_scaler(block):
    """Over the f32 vector of three reals and over an f64 TF-IDF vector:
    the JAX package's mean, std and scaled values, dtype included."""
    rng = np.random.default_rng(9)

    def build(pkg):
        if block == "reals":
            vec = pkg.dsl.transmogrify([TD.raw_feature(pkg, "Real", n)
                                    for n in ("a", "b", "c")])
        else:
            vec = TD.raw_feature(pkg, "TextList", "t").tfidf(num_terms=16)
        return vec.transform_with(_ops(pkg, "vectors")
                                  .StandardScalerEstimator())
    cols = {n: ("Real", _reals(rng)) for n in ("a", "b", "c")}
    cols["t"] = ("TextList", TD.typed_values("TextList", N, rng))
    jm, pm, jf, pf = _check_both(build, cols)
    want = np.float32 if block == "reals" else np.float64
    assert _fitted(pm, pf).mean.dtype == want


@pytest.mark.parametrize("build", [
    lambda pkg, f: f.tf(num_terms=16),
    lambda pkg, f: f.tf(num_terms=8, binary=True),
    lambda pkg, f: f.tfidf(num_terms=16),
    lambda pkg, f: f.tfidf(num_terms=16, min_doc_freq=40),
    lambda pkg, f: f.ngram(2).tf(num_terms=32),
    lambda pkg, f: f.ngram(3).tfidf(num_terms=32),
    lambda pkg, f: f.remove_stop_words().tf(num_terms=16),
    lambda pkg, f: f.remove_stop_words(stop_words=["Red", "teal"],
                                       case_sensitive=True).tf(num_terms=16),
], ids=["tf", "tf-binary", "tfidf", "tfidf-min-df", "bigram-tf",
        "trigram-tfidf", "stop-words", "stop-words-case"])
def test_list_ops(build):
    rng = np.random.default_rng(10)
    words = ["the", "Red", "a", "red", "teal", "of", "plum", "Green"]
    vals = [[str(rng.choice(words)) for _ in range(int(rng.integers(0, 7)))]
            for _ in range(N)]
    _check_both(lambda pkg: build(pkg, TD.raw_feature(pkg, "TextList", "t")),
                {"t": ("TextList", vals)})


def test_stop_words_and_ngram_lists():
    rng = np.random.default_rng(11)
    vals = TD.typed_values("TextList", N, rng)
    for build in (lambda f: f.remove_stop_words(stop_words=["red"]),
                  lambda f: f.ngram(2)):
        js, ps = TD.stores({"t": ("TextList", vals)})
        (_, _, jc), (_, _, pc) = TD.run_both(
            lambda pkg: build(TD.raw_feature(pkg, "TextList", "t")), js, ps)
        assert pc.values == jc.values


def test_jaccard_similarity():
    rng = np.random.default_rng(12)
    cols = {n: ("MultiPickList", TD.typed_values("MultiPickList", N, rng))
            for n in ("a", "b")}
    _check_both(lambda pkg: TD.raw_feature(pkg, "MultiPickList", "a")
                .jaccard_similarity(TD.raw_feature(pkg, "MultiPickList",
                                                   "b")), cols)


@pytest.mark.cuda
def test_new_blocks_come_back_from_the_card():
    """Each new vectorizer's ``device_compute`` runs on the card: its
    block is a CUDA tensor, equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the card's path runs only there")
    from transmogrifai_tpu_torch.ops.vectorizer_base import (
        canonicalize_prepared)
    rng = np.random.default_rng(13)
    types = ["MultiPickList", "Geolocation", "DateList", "RealMap",
             "IntegralMap", "TextMap", "MultiPickListMap", "GeolocationMap",
             "DateMap"]
    cols = {f"f_{t}": (t, TD.typed_values(t, N, rng)) for t in types}
    cols["r"] = ("Real", _reals(rng))
    _, ps = TD.stores(cols)
    TD.puid.reset()
    feats = [TD.raw_feature(P, t, f"f_{t}") for t in types]
    vec = P.transmogrify(feats + [TD.raw_feature(P, "Real", "r")
                                  .bucketize(splits=[0.0, 5.0, 10.0])])
    model = P.Workflow().set_input_store(ps).set_result_features(
        vec).train(device="cpu")
    for m in model.fitted_stages.values():
        if not getattr(m, "device_math", False):
            continue
        prepared = canonicalize_prepared(m.host_prepare(ps))
        outs = {dev: m.device_compute({k: torch.from_numpy(v).to(dev)
                                       for k, v in prepared.items()})
                for dev in ("cuda", "cpu")}
        assert outs["cuda"].is_cuda
        assert torch.equal(outs["cuda"].cpu(), outs["cpu"])


def test_engine_scales_on_the_device():
    """The vector standard scaler is the engine's ``scale`` kind: fused
    after the vectorizers, in chunks, it gives the layer path's vector."""
    rng = np.random.default_rng(14)
    cols = {n: ("Real", _reals(rng)) for n in ("a", "b")}
    cols["g"] = ("Geolocation", TD.typed_values("Geolocation", N, rng))
    _, ps = TD.stores(cols)
    TD.puid.reset()
    vec = P.transmogrify([TD.raw_feature(P, "Real", "a"),
                          TD.raw_feature(P, "Real", "b"),
                          TD.raw_feature(P, "Geolocation", "g")])
    scaled = vec.transform_with(_ops(P, "vectors").StandardScalerEstimator())
    model = P.Workflow().set_input_store(ps).set_result_features(
        scaled).train(device="cpu")
    eng = model.scoring_engine("cpu", bucket_cap=64)
    assert [it.kind for it in eng._plan] == ["vec", "vec", "combine",
                                             "scale"]
    layer = model.transform(ps, device="cpu", engine=False)[scaled.name]
    got = eng.transform_store(ps)[scaled.name]
    np.testing.assert_array_equal(got.values, layer.values)
    assert got.metadata.to_json() == layer.metadata.to_json()
