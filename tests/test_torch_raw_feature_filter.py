"""The port's RawFeatureFilter against the JAX package on the CPU: every
case of ``tests/test_raw_feature_filter.py`` through both packages on the
same numpy-seeded stores, with the results JSON exactly equal (the filter
is host numpy in both); results JSON written by either package read by the
other; the filter in ``Workflow.train`` (the blacklist and the copied DAG);
and the guarded map-feature workflow at 800 records, whose scoring records
lost the ``region`` key: the same exclusions, the same fitted DAG."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu import ColumnStore as JStore
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu import column_from_values as jcol
from transmogrifai_tpu import filters as JF
from transmogrifai_tpu.filters import distribution as JD
from transmogrifai_tpu.graph import compute_dag as jax_dag
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JBS
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowError as JWorkflowError
from transmogrifai_tpu_torch import ColumnStore as PStore
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import column_from_values as pcol
from transmogrifai_tpu_torch import filters as PF
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.filters import distribution as PD
from transmogrifai_tpu_torch.graph import compute_dag as port_dag
from transmogrifai_tpu_torch.models.linear import \
    LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PBS
from transmogrifai_tpu_torch.types import feature_types as PFT
from transmogrifai_tpu_torch.utils import uid as puid
from transmogrifai_tpu_torch.workflow import WorkflowError as PWorkflowError

sys.path.insert(0, os.path.dirname(__file__))
import _torch_guard_data as GD  # noqa: E402

JAX = {"store": JStore, "col": jcol, "FT": JFT, "FB": JFB, "F": JF}
PORT = {"store": PStore, "col": pcol, "FT": PFT, "FB": PFB, "F": PF}


def _dump(obj) -> str:
    """JSON text: exact, and NaN / infinity compare as written."""
    return json.dumps(obj, sort_keys=True)


def _stores(columns, pkg):
    """{name: (type name, values)} → one package's ColumnStore."""
    return pkg["store"]({name: pkg["col"](getattr(pkg["FT"], t), vals)
                         for name, (t, vals) in columns.items()})


def _raw(kinds, pkg, response="label"):
    fb = pkg["FB"]
    label = fb.RealNN(response).from_column().as_response()
    return [label] + [getattr(fb, kind)(name).from_column().as_predictor()
                      for name, kind in kinds.items()]


def _nullable(v):
    return [None if np.isnan(x) else float(x) for x in v]


def _basic(rng, n=400):
    y = rng.integers(0, 2, size=n).astype(float)
    age = rng.normal(40, 10, size=n)
    mostly_null = np.where(rng.random(n) < 0.999, np.nan, 1.0)
    leaky_null = np.where(y > 0, 1.0, np.nan)
    text = [str(rng.choice(["a", "b", "c"])) for _ in range(n)]
    return {"label": ("RealNN", list(y)), "age": ("Real", _nullable(age)),
            "mostly_null": ("Real", _nullable(mostly_null)),
            "leaky_null": ("Real", _nullable(leaky_null)),
            "word": ("Text", text)}


def _shift(rng, n=500):
    y = rng.integers(0, 2, size=n).astype(float)
    train = {"label": ("RealNN", list(y)),
             "x": ("Real", list(rng.normal(0, 1, n))),
             "shifted": ("Real", list(rng.normal(0, 1, n)))}
    score = {"x": ("Real", list(rng.normal(0, 1, n))),
             "shifted": ("Real", list(rng.normal(50, 0.1, n)))}
    return train, score


def _map_rare(rng, n=300):
    y = rng.integers(0, 2, size=n).astype(float)
    maps = []
    for _ in range(n):
        d = {"good": float(rng.normal())}
        if rng.random() < 0.02:
            d["rare"] = 1.0
        maps.append(d)
    return {"label": ("RealNN", list(y)), "m": ("RealMap", maps)}


def _gone(rng, n=200):
    y = rng.integers(0, 2, size=n).astype(float)
    train = {"label": ("RealNN", list(y)),
             "x": ("Real", list(rng.normal(size=n))),
             "gone": ("Real", list(rng.normal(size=n)))}
    score = {"x": ("Real", list(rng.normal(size=n)))}
    return train, score


def _vanishing_key(rng, n=200):
    y = rng.integers(0, 2, size=n).astype(float)
    train_maps = [{"stays": float(rng.normal()),
                   "vanishes": float(rng.normal())} for _ in range(n)]
    score_maps = [{"stays": float(rng.normal())} for _ in range(n)]
    return ({"label": ("RealNN", list(y)), "m": ("RealMap", train_maps)},
            {"m": ("RealMap", score_maps)})


BASIC4 = {"age": "Real", "mostly_null": "Real", "leaky_null": "Real",
          "word": "Text"}

#: each case of the JAX package's tests: (data maker → (train columns,
#: scoring columns | None), predictor kinds, filter kwargs)
CASES = {
    "unfilled_and_leaky_nulls": (
        lambda rng: (_basic(rng), None), BASIC4,
        {"min_fill": 0.10, "max_correlation": 0.9}),
    "js_divergence_shift": (
        _shift, {"x": "Real", "shifted": "Real"},
        {"max_js_divergence": 0.5}),
    "protected_features": (
        lambda rng: (_basic(rng), None), BASIC4,
        {"min_fill": 0.10, "max_correlation": 0.9,
         "protected_features": ["mostly_null", "leaky_null"]}),
    "map_keys_individually": (
        lambda rng: (_map_rare(rng), None), {"m": "RealMap"},
        {"min_fill": 0.10}),
    "results_json_roundtrip": (
        lambda rng: (_basic(rng), None),
        {"age": "Real", "mostly_null": "Real", "word": "Text"},
        {"min_fill": 0.10}),
    "missing_from_scoring_store": (
        _gone, {"x": "Real", "gone": "Real"}, {"min_fill": 0.10}),
    "map_key_missing_from_scoring_store": (
        _vanishing_key, {"m": "RealMap"}, {"min_fill": 0.10}),
    "js_protected": (
        _shift, {"x": "Real", "shifted": "Real"},
        {"max_js_divergence": 0.5,
         "js_divergence_protected_features": ["shifted"]}),
}


def _filter_both(case):
    make, kinds, kw = CASES[case]
    train, score = make(np.random.default_rng(42))
    out = []
    for pkg in (JAX, PORT):
        raw = _raw(kinds, pkg)
        scoring = _stores(score, pkg) if score is not None else None
        out.append(pkg["F"].RawFeatureFilter(**kw).filter_raw(
            _stores(train, pkg), raw, scoring_data=scoring))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_results_equal_the_jax_packages(case):
    """Results JSON (config, metrics, exclusion reasons, both splits'
    distributions) exactly equal; the same blacklist, map keys and clean
    store."""
    j, p = _filter_both(case)
    assert _dump(p.results.to_json()) == _dump(j.results.to_json())
    assert _dump(p.results.summary()) == _dump(j.results.summary())
    assert [f.name for f in p.blacklisted_features] == \
        [f.name for f in j.blacklisted_features]
    assert p.blacklisted_map_keys == j.blacklisted_map_keys
    assert p.clean_store.names() == j.clean_store.names()
    for name in j.clean_store.names():
        jc, pc = j.clean_store[name], p.clean_store[name]
        if hasattr(jc, "children"):
            assert sorted(pc.children) == sorted(jc.children)


@pytest.mark.parametrize("case", sorted(CASES))
def test_results_json_read_by_the_other_package(case):
    """The JAX package's results JSON read by the port, and the port's by
    the JAX package, give the same JSON back."""
    j, p = _filter_both(case)
    jd, pd = j.results.to_json(), p.results.to_json()
    back_p = PF.RawFeatureFilterResults.from_json(json.loads(_dump(jd)))
    back_j = JF.RawFeatureFilterResults.from_json(json.loads(_dump(pd)))
    assert _dump(back_p.to_json()) == _dump(jd)
    assert _dump(back_j.to_json()) == _dump(pd)


def test_expected_verdicts():
    """The JAX tests' verdicts hold in the port."""
    p = _filter_both("unfilled_and_leaky_nulls")[1]
    bad = {f.name for f in p.blacklisted_features}
    assert bad == {"mostly_null", "leaky_null"}
    reasons = {r.name: r for r in p.results.exclusion_reasons}
    assert reasons["mostly_null"].training_unfilled_state
    assert reasons["leaky_null"].training_null_label_leaker
    assert _filter_both("protected_features")[1].blacklisted_features == []
    p = _filter_both("js_divergence_shift")[1]
    assert [f.name for f in p.blacklisted_features] == ["shifted"]
    p = _filter_both("map_keys_individually")[1]
    assert p.blacklisted_map_keys == {"m": ["rare"]}
    assert set(p.clean_store["m"].children) == {"good"}
    p = _filter_both("map_key_missing_from_scoring_store")[1]
    r = {(x.name, x.key): x for x in p.results.exclusion_reasons}
    assert r[("m", "vanishes")].scoring_unfilled_state
    assert not r[("m", "stays")].excluded
    assert _filter_both("js_protected")[1].blacklisted_features == []


def _column_distributions(pkg, mod, vals, bins=20):
    col = pkg["col"](pkg["FT"].Real, list(vals))
    summ = mod.summaries_of_column("x", col)
    return mod.distributions_of_column("x", col, bins=bins, summaries=summ)


def test_distributions_and_monoids_equal_the_jax_packages(rng):
    """One column's distribution, the monoid sums, the fill metrics and
    the JS divergence, as the JAX package computes them."""
    vals = rng.normal(size=200)
    (jd,) = _column_distributions(JAX, JD, vals)
    (pd,) = _column_distributions(PORT, PD, vals)
    assert _dump(pd.to_json()) == _dump(jd.to_json())
    assert _dump((pd + pd).to_json()) == _dump((jd + jd).to_json())
    assert pd.js_divergence(pd) == jd.js_divergence(jd) == 0.0
    other = rng.normal(1.0, 2.0, size=150)
    (jo,) = _column_distributions(JAX, JD, other)
    (po,) = _column_distributions(PORT, PD, other)
    assert pd.js_divergence(po) == jd.js_divergence(jo)
    assert pd.relative_fill_ratio(po) == jd.relative_fill_ratio(jo)
    for mod in (JD, PD):
        empty_a = mod.FeatureDistribution("x", count=10, nulls=10)
        empty_b = mod.FeatureDistribution("x", count=4, nulls=4)
        full = mod.FeatureDistribution("x", count=10, nulls=0)
        assert empty_a.relative_fill_ratio(empty_b) == 1.0
        assert empty_a.relative_fill_ratio(full) == float("inf")
        s = (mod.Summary.of_values(np.array([1.0, 5.0]))
             + mod.Summary.of_values(np.array([-2.0])))
        assert (s.min, s.max, s.count) == (-2.0, 5.0, 3)
        populated = mod.FeatureDistribution(
            "f", None, 10, 2, np.array([1.0, 2.0, 3.0]), [0.0, 1.0, 2.0])
        for a, b in ((populated, mod.FeatureDistribution("f")),
                     (mod.FeatureDistribution("f"), populated)):
            assert (a + b).count == 10 and (a + b).nulls == 2


def test_text_distributions_hash_alike(rng):
    """Text bins are hashed token counts: the port's hasher puts every
    token in the JAX package's bin."""
    words = [str(rng.choice(["alpha", "beta", "gamma", "delta"]))
             if rng.random() > 0.1 else None for _ in range(300)]
    out = []
    for pkg, mod in ((JAX, JD), (PORT, PD)):
        col = pkg["col"](pkg["FT"].Text, words)
        out.append(mod.distributions_of_column(
            "w", col, 50, mod.summaries_of_column("w", col))[0].to_json())
    assert _dump(out[1]) == _dump(out[0])


def _integration(pkg, dag_fn, transmogrify, lr, selector, workflow, fb):
    rng = np.random.default_rng(42)
    n = 300
    y = rng.integers(0, 2, size=n).astype(float)
    x = rng.normal(size=n) + y
    store = pkg["store"]({
        "label": pkg["col"](pkg["FT"].RealNN, list(y)),
        "x": pkg["col"](pkg["FT"].Real, list(x)),
        "dead": pkg["col"](pkg["FT"].Real, [None] * n)})
    label = fb.RealNN("label").from_column().as_response()
    fx = fb.Real("x").from_column().as_predictor()
    fdead = fb.Real("dead").from_column().as_predictor()
    vec = transmogrify([fx, fdead])
    pred = selector.with_cross_validation(
        num_folds=2, families=[lr()]).set_input(label, vec).get_output()
    wf = (workflow().set_result_features(pred).set_input_store(store)
          .with_raw_feature_filter(pkg["F"].RawFeatureFilter(
              min_fill=0.10)))
    return wf, store, pred, vec


def test_workflow_drops_blacklisted_features_like_the_jax_package():
    """``with_raw_feature_filter`` in ``Workflow.train``: ``dead`` is
    blacklisted, the combiner of a copied DAG takes ``x`` alone, the
    user's graph keeps both, and the model scores; the fitted DAG's
    layers, stage uids and inputs are the JAX package's."""
    juid.reset()
    jwf, jstore, jpred, jvec = _integration(
        JAX, jax_dag, jtransmogrify, JLR, JBS, JWorkflow, JFB)
    jm = jwf.train()
    puid.reset()
    pwf, pstore, ppred, pvec = _integration(
        PORT, port_dag, ptransmogrify, PLR, PBS, PWorkflow, PFB)
    pm = pwf.train(device="cpu", dtype=torch.float64)
    assert [f.name for f in pm.blacklisted_features] == ["dead"] == \
        [f.name for f in jm.blacklisted_features]
    assert [f.name for f in pvec.parents] == ["x", "dead"]   # untouched

    def layers(dag):
        return [[(type(s).__name__, s.uid,
                  [f.name for f in s.input_features]) for s in layer]
                for layer in dag]
    assert layers(pm.dag) == layers(jm.dag)
    combiner = [s for layer in pm.dag for s in layer
                if type(s).__name__ == "RealVectorizer"]
    assert [[f.name for f in s.input_features] for s in combiner] == [["x"]]
    assert ppred.name in pm.score(pstore, device="cpu").names()
    assert _dump(pm.rff_results.to_json()) == _dump(jm.rff_results.to_json())


def test_blacklisted_input_of_a_fixed_arity_stage_raises():
    """A fixed-arity stage that loses an input raises WorkflowError in
    both packages, as does a blacklisted result feature's ancestor."""
    recs, srecs = GD.records(), GD.scoring_records()
    for r in srecs:
        del r["note"]
        r["note"] = []
    juid.reset()
    jo = GD.jax_workflow(GD.jax_store(recs), GD.jax_one_point()[:1])
    jo["workflow"].with_raw_feature_filter(
        JF.RawFeatureFilter(scoring_data=GD.jax_store(srecs)))
    with pytest.raises(JWorkflowError, match="fixed-arity"):
        jo["workflow"].train()
    puid.reset()
    po = GD.PM.build_workflow(GD.PM.records_store(recs),
                              families=GD.port_one_point()[:1])
    po["workflow"].with_raw_feature_filter(
        PF.RawFeatureFilter(scoring_data=GD.PM.records_store(srecs)))
    with pytest.raises(PWorkflowError, match="fixed-arity"):
        po["workflow"].train(device="cpu", dtype=torch.float64)


def test_mapprep_filter_excludes_the_vanished_key():
    """The map-feature workflow at 800 records with scoring records that
    lost ``attrs``' ``region`` key: the filter excludes ``(attrs,
    region)`` alone in both packages, blacklists no raw feature, its
    results JSON is equal, and the fitted DAG (layers, uids, inputs) is
    the JAX package's, with a 113-wide vector and no ``region`` column."""
    recs, srecs = GD.records(), GD.scoring_records()
    out = []
    for build, store, F, kw in (
            (lambda s: GD.jax_workflow(s, GD.jax_one_point()[:1]),
             GD.jax_store, JF, {}),
            (lambda s: GD.PM.build_workflow(
                s, families=GD.port_one_point()[:1]),
             GD.PM.records_store, PF,
             {"device": "cpu", "dtype": torch.float64})):
        (juid if F is JF else puid).reset()
        o = build(store(recs))
        o["workflow"].with_raw_feature_filter(
            F.RawFeatureFilter(scoring_data=store(srecs)))
        o["model"] = o["workflow"].train(**kw)
        o["store"] = store(recs)
        out.append(o)
    jo, po = out
    jm, pm = jo["model"], po["model"]
    excluded = [(r.name, r.key) for r in pm.rff_results.exclusion_reasons
                if r.excluded]
    assert excluded == [("attrs", "region")] == [
        (r.name, r.key) for r in jm.rff_results.exclusion_reasons
        if r.excluded]
    assert pm.blacklisted_features == [] == jm.blacklisted_features
    assert _dump(pm.rff_results.to_json()) == _dump(jm.rff_results.to_json())

    def layers(dag):
        return [[(type(s).__name__, s.uid,
                  [f.name for f in s.input_features]) for s in layer]
                for layer in dag]
    assert layers(pm.dag) == layers(jm.dag)
    name = po["features"].name
    pc = pm.transform(po["store"], device="cpu", engine=False)[name]
    jc = jm.transform(jo["store"], engine=False)[name]
    assert pc.values.shape[1] == 113 == jc.values.shape[1]
    np.testing.assert_array_equal(pc.values, jc.values)
    assert "region" not in {c.grouping for c in pc.metadata.columns}


@pytest.mark.cuda
def test_filter_in_a_card_train_equals_the_cpus():
    """The filter is host code: a train on the card gives the CPU's
    results JSON and blacklist, and the pruned model scores on the
    card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the card's train runs only there")
    out = {}
    for dev in ("cuda", "cpu"):
        puid.reset()
        wf, store, pred, _vec = _integration(
            PORT, port_dag, ptransmogrify, PLR, PBS, PWorkflow, PFB)
        model = wf.train(device=dev)
        out[dev] = (model, model.score(store, device=dev)[pred.name])
    assert _dump(out["cuda"][0].rff_results.to_json()) == \
        _dump(out["cpu"][0].rff_results.to_json())
    assert [f.name for f in out["cuda"][0].blacklisted_features] == ["dead"]
    np.testing.assert_array_equal(out["cuda"][1].prediction,
                                  out["cpu"][1].prediction)
