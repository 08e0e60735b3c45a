"""The port's map stages against the JAX package on the CPU, on seeded
stores: ``MapVectorizer`` for every element kind (numeric with mean,
mode or fixed fills, binary, pivoted text, multi-hot sets, geolocations,
dates), ``SmartTextMapVectorizer``, the key filters and extractor, and
the map decision-tree bucketizer. Fitted host state, vectors and vector
metadata are exact."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import _torch_typed_data as TD  # noqa: E402

N = 300


def _state_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _state_equal(x, y)
    else:
        assert b == a and type(b) is type(a), (a, b)


def _check(build, columns):
    js, ps = TD.stores(columns)
    (jm, jf, jc), (pm, pf, pc) = TD.run_both(build, js, ps)
    TD.assert_same_vector(jc, pc)
    for uid, stage in jm.fitted_stages.items():
        _state_equal(stage.get_model_state(),
                     pm.fitted_stages[uid].get_model_state())
        _state_equal(stage.get_params(), pm.fitted_stages[uid].get_params())
    return pm, pf, pc


@pytest.mark.parametrize("type_name,kw", [
    ("RealMap", {}),
    ("RealMap", {"fill_with_mean": False, "default_value": -1.5}),
    ("CurrencyMap", {"track_nulls": False}),
    ("PercentMap", {"block_keys": ["k1"]}),
    ("IntegralMap", {}),
    ("IntegralMap", {"fill_with_mode": False}),
    ("BinaryMap", {}),
    ("TextMap", {}),
    ("PickListMap", {"top_k": 2, "min_support": 1}),
    ("EmailMap", {"allow_keys": ["k0", "k2"]}),
    ("MultiPickListMap", {}),
    ("MultiPickListMap", {"top_k": 3, "min_support": 5}),
    ("GeolocationMap", {}),
    ("DateMap", {}),
    ("DateTimeMap", {"allow_keys": ["k3"], "block_keys": ["k0"]}),
])
def test_map_vectorizer(type_name, kw):
    rng = np.random.default_rng(sum(map(ord, type_name)) + len(kw))
    pm, pf, pc = _check(
        lambda pkg: TD.raw_feature(pkg, type_name, "m").vectorize(
            TD.raw_feature(pkg, type_name, "n"), **kw),
        {"m": (type_name, TD.typed_values(type_name, N, rng)),
         "n": (type_name, TD.typed_values(type_name, N, rng))})
    groups = {c.grouping for c in pc.metadata.columns}
    for key in kw.get("block_keys", ()):
        assert key not in groups
    if "allow_keys" in kw:
        assert groups <= set(kw["allow_keys"])


def test_map_vectorizers_by_type():
    """Several map types in one ``transmogrify``: one MapVectorizer each,
    in type-name order."""
    types = ["TextMap", "RealMap", "GeolocationMap", "IntegralMap"]
    rng = np.random.default_rng(3)
    _check(lambda pkg: pkg.dsl.transmogrify(
        [TD.raw_feature(pkg, t, f"m_{t}") for t in types]),
        {f"m_{t}": (t, TD.typed_values(t, N, rng)) for t in types})


def _text_map_values(rng, n=N):
    """Low-cardinality ``plan`` / ``region`` keys and a unique-per-row
    ``note`` key."""
    out = []
    for i in range(n):
        d = {"plan": str(rng.choice(["free", "pro", "ent"])),
             "note": f"case {i} opened {rng.integers(0, 99)}"}
        if rng.random() < 0.5:
            d["region"] = str(rng.choice(["emea", "amer", "apac"]))
        out.append(d)
    return out


@pytest.mark.parametrize("kw", [
    {"max_cardinality": 10, "num_features": 64},
    {"max_cardinality": 10, "num_features": 16, "track_text_len": True,
     "top_k": 2},
    {"max_cardinality": 1000, "min_support": 1},
    {"max_cardinality": 10, "num_features": 8, "block_keys": ["plan"]},
])
def test_smart_text_map_vectorizer(kw):
    rng = np.random.default_rng(4)
    pm, pf, _ = _check(
        lambda pkg: TD.raw_feature(pkg, "TextMap", "a")
        .smart_vectorize(**kw),
        {"a": ("TextMap", _text_map_values(rng))})
    model = pm.fitted_stages[pf.origin_stage.uid]
    assert model.delegate_class == "SmartTextVectorizerModel"


@pytest.mark.parametrize("allow,block", [(None, ["k1"]), (["k0", "k3"], ()),
                                         (["k0", "k1"], ["k1"]),
                                         (["nope"], ())])
def test_filter_map_keys(allow, block):
    rng = np.random.default_rng(5)
    js, ps = TD.stores({"m": ("RealMap",
                              TD.typed_values("RealMap", N, rng))})
    (_, _, jc), (_, pf, pc) = TD.run_both(
        lambda pkg: TD.raw_feature(pkg, "RealMap", "m").filter_keys(
            allow=allow, block=block), js, ps)
    assert pf.ftype.__name__ == "RealMap"
    assert sorted(pc.children) == sorted(jc.children)
    for k in jc.children:
        np.testing.assert_array_equal(pc.children[k].values,
                                      jc.children[k].values)
        np.testing.assert_array_equal(pc.children[k].mask,
                                      jc.children[k].mask)


@pytest.mark.parametrize("type_name,key", [
    ("RealMap", "k2"), ("IntegralMap", "k0"), ("TextMap", "k1"),
    ("RealMap", "absent"), ("TextMap", "absent")])
def test_extract_map_key(type_name, key):
    rng = np.random.default_rng(6)
    js, ps = TD.stores({"m": (type_name,
                              TD.typed_values(type_name, N, rng))})
    (_, jf, jc), (_, pf, pc) = TD.run_both(
        lambda pkg: TD.raw_feature(pkg, type_name, "m").extract_key(key),
        js, ps)
    assert pf.ftype.__name__ == jf.ftype.__name__
    assert list(pc.values) == list(jc.values)
    np.testing.assert_array_equal(pc.mask, jc.mask)


@pytest.mark.parametrize("kw", [{}, {"max_depth": 1},
                                {"track_invalid": True, "track_nulls": False}])
def test_map_decision_tree_bucketizer(kw):
    rng = np.random.default_rng(7)
    vals = TD.typed_values("RealMap", N, rng)
    y = [float(d.get("k1", 0.0) > 2.0 or d.get("k3", 0.0) < -8.0)
         for d in vals]
    pm, pf, pc = _check(
        lambda pkg: TD.raw_feature(pkg, "RealMap", "m").auto_bucketize(
            TD.raw_feature(pkg, "RealNN", "y", response=True), **kw),
        {"m": ("RealMap", vals), "y": ("RealNN", y)})
    model = pm.fitted_stages[pf.origin_stage.uid]
    assert [f.name for f in model.input_features] == ["m"]
    assert model.keys == sorted(TD.KEYS)
    assert {c.grouping for c in pc.metadata.columns} == set(TD.KEYS)


def test_key_filters_need_a_map():
    for pkg in (TD.J, TD.P):
        with pytest.raises(ValueError, match="map-typed"):
            TD.raw_feature(pkg, "Real", "r").vectorize(block_keys=["k"])
