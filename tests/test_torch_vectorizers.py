"""The port's feature-engineering stages against the JAX package on the
CPU, on ~2,000 BigPassenger records: fitted state, transformed arrays and
vector metadata of every ported vectorizer (exact: both build f32 blocks
from the same host arrays), murmur3 bit-identity between the native and
the Python hasher, the SanityChecker's keep-indices and summary (f64;
statistics within 1e-9), and stages carried over from JAX-fitted state."""
import re

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.ops import (dates as JD, hashing as JH,
                                   numeric as JN, onehot as JO,
                                   sanity_checker as JSC, smart_text as JST,
                                   text as JT)
from transmogrifai_tpu.ops.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.stages.base import Estimator as JEstimator
from transmogrifai_tpu.utils import stats as JS
from transmogrifai_tpu.workflow import _generate_raw_store
import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch import big_passenger as PB
from transmogrifai_tpu_torch.carry_over import fitted_stage_from_state
from transmogrifai_tpu_torch.stages.base import Estimator as PEstimator
from transmogrifai_tpu_torch.ops import (_hostvec as PHV, dates as PD,
                                         hashing as PH, numeric as PN,
                                         onehot as PO, sanity_checker as PSC,
                                         smart_text as PST, text as PT)
from transmogrifai_tpu_torch.utils import stats as PS
from transmogrifai_tpu_torch.utils import uid as puid
from transmogrifai_tpu_torch.workflow import _raw_store

N_ROWS = 2000
CPU = dict(device="cpu")
RAW = (("Real", "age"), ("PickList", "gender"), ("Real", "height"),
       ("Real", "weight"), ("Text", "description"), ("Date", "boarded"),
       ("Real", "anotherFloat"))


@pytest.fixture(scope="module")
def records():
    from examples.big_passenger import synthesize_records
    return synthesize_records(N_ROWS, seed=42)


def _raw(pkg, records):
    fb = pkg.FeatureBuilder
    feats = {n: getattr(fb, t)(n).from_column().as_predictor()
             for t, n in RAW}
    feats["survived"] = fb.RealNN("survived").from_column().as_response()
    gen = _generate_raw_store if pkg is J else _raw_store
    return feats, gen(records, list(feats.values()))


@pytest.fixture
def raw(records):
    """Raw features and stores of both packages, built after the uid
    counters restart, so stage uids (and the names made from them) agree
    between the packages for the rest of the test."""
    puid.reset()
    return _raw(J, records), _raw(P, records)


def _fit_both(raw, jst, pst, names):
    (jf, js), (pf, ps) = raw
    jst.set_input(*[jf[n] for n in names])
    pst.set_input(*[pf[n] for n in names])
    jm = jst.fit(js) if isinstance(jst, JEstimator) else jst
    pm = pst.fit(ps) if isinstance(pst, PEstimator) else pst
    jc = jm.transform_columns(js)
    pc = pm.transform_columns(ps, **CPU)
    return jm, pm, jc, pc


def _same_vector(jc, pc):
    assert pc.values.dtype == np.float32
    np.testing.assert_array_equal(pc.values, jc.values)
    assert [c.to_json() for c in pc.metadata.columns] == \
        [c.to_json() for c in jc.metadata.columns]


def test_records_are_the_example_stream(records):
    assert PB.synthesize_records(N_ROWS, seed=42) == records


@pytest.mark.parametrize("names", [("age", "height", "weight",
                                    "anotherFloat"), ("age",)])
def test_real_vectorizer(raw, names):
    jm, pm, jc, pc = _fit_both(raw, JN.RealVectorizer(),
                               PN.RealVectorizer(), names)
    assert pm.get_model_state() == jm.get_model_state()
    _same_vector(jc, pc)


def test_integral_and_binary_vectorizers(rng):
    n = 500
    ints = [None if rng.random() < 0.1 else int(v)
            for v in rng.integers(0, 5, n)]
    bins = [None if rng.random() < 0.1 else bool(v)
            for v in rng.random(n) > 0.5]
    recs = [{"i": a, "b": b} for a, b in zip(ints, bins)]
    for pkg, mod in ((J, JN), (P, PN)):
        fi = pkg.FeatureBuilder.Integral("i").from_column().as_predictor()
        fb = pkg.FeatureBuilder.Binary("b").from_column().as_predictor()
        gen = _generate_raw_store if pkg is J else _raw_store
        store = gen(recs, [fi, fb])
        out = []
        for cls, f in ((mod.IntegralVectorizer, fi),
                       (mod.BinaryVectorizer, fb)):
            est = cls()
            est.set_input(f)
            m = est.fit(store)
            kw = CPU if pkg is P else {}
            out.append((m.get_model_state()["fill_values"],
                        m.transform_columns(store, **kw).values))
        if pkg is J:
            want = out
    for (fv_w, v_w), (fv_g, v_g) in zip(want, out):
        assert fv_g == fv_w
        np.testing.assert_array_equal(v_g, v_w)


def test_onehot_vectorizer(raw):
    jm, pm, jc, pc = _fit_both(raw, JO.OneHotVectorizer(),
                               PO.OneHotVectorizer(), ("gender",))
    assert pm.vocabs == jm.vocabs == [["Female", "Male"]]
    _same_vector(jc, pc)


@pytest.mark.parametrize("names", [("description",), ("gender",),
                                   ("gender", "description")])
def test_smart_text_vectorizer_pivots_and_hashes(raw, names):
    jm, pm, jc, pc = _fit_both(raw, JST.SmartTextVectorizer(),
                               PST.SmartTextVectorizer(), names)
    assert pm.get_model_state() == jm.get_model_state()
    assert pm.is_categorical == [n == "gender" for n in names]
    _same_vector(jc, pc)


def test_date_unit_circle(raw):
    periods = ["HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear"]
    jm, pm, jc, pc = _fit_both(
        raw, JD.DateToUnitCircleVectorizer(periods=periods),
        PD.DateToUnitCircleVectorizer(periods=periods), ("boarded",))
    _same_vector(jc, pc)
    millis = np.linspace(0, 4e12, 257)
    for p in periods:
        np.testing.assert_array_equal(PD.period_radians(millis, p),
                                      JD.period_radians(np, millis, p))


def test_tokenizer_and_hashing_vectorizer(raw):
    (jf, js), (pf, ps) = raw
    jt, pt = JT.TextTokenizer(), PT.TextTokenizer()
    jt.set_input(jf["description"])
    pt.set_input(pf["description"])
    jtok, ptok = jt.transform(js), pt.transform(ps)
    assert ptok[pt.output_name].values == jtok[jt.output_name].values
    for shared in (False, True):
        jh = JH.HashingVectorizerModel(shared_hash_space=shared,
                                       input_names=[jt.output_name])
        ph = PH.HashingVectorizerModel(shared_hash_space=shared,
                                       input_names=[pt.output_name])
        jh.set_input(jt.get_output(), jf["description"])
        ph.set_input(pt.get_output(), pf["description"])
        _same_vector(jh.transform_columns(jtok),
                     ph.transform_columns(ptok, **CPU))


def test_murmur3_native_matches_python_and_jax():
    toks = ["", "a", "ab", "abc", "abcd", "abcde", "voyage996", "rescue",
            "naïve", "日本語", "o'brien", "x" * 37]
    for seed in (42, 7):
        want = [JH.murmur3_32(t.encode("utf-8"), seed) for t in toks]
        assert [PH.murmur3_32(t.encode("utf-8"), seed) for t in toks] \
            == want
        assert PH.load_native(), "the native hasher did not build"
        np.testing.assert_array_equal(PH.hash_tokens(toks, seed),
                                      np.array(want, dtype=np.uint32))


@pytest.mark.parametrize("native", [True, False])
def test_hashed_text_block_native_and_python_paths(monkeypatch, native):
    vals = ["Rescue at SEA", None, "naïve café crew", "", "o'brien's deck",
            "voyage12 voyage12 sea"] * 7
    want = np.zeros((len(vals), 40), np.float32)
    from transmogrifai_tpu.ops._hostvec import hashed_text_block as j_htb
    j_null = j_htb(vals, 32, 42, False, out=want, col_offset=8)
    if not native:
        monkeypatch.setattr(PH, "_native", False)
    got = np.zeros_like(want)
    null = PHV.hashed_text_block(vals, 32, 42, False, out=got, col_offset=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(null, j_null)


def test_transmogrify_whole_vector_and_unported_types(raw):
    (jf, js), (pf, ps) = raw
    names = [n for _t, n in RAW]
    j_vec = j_tm([jf[n] for n in names])
    p_vec = P.transmogrify([pf[n] for n in names])
    jm = J.Workflow().set_input_store(js).set_result_features(j_vec) \
        .set_mesh(False).train()
    pm = P.Workflow().set_input_store(ps).set_result_features(p_vec) \
        .train(**CPU)
    jc = jm.score(js)[j_vec.name]
    pc = pm.score(ps, **CPU)[p_vec.name]
    _same_vector(jc, pc)
    assert pc.values.shape[1] == 8 + 4 + 513 + 9   # real, pivot, hash, date
    # the types once unported dispatch as in the JAX package
    tags = P.FeatureBuilder.MultiPickList("tags").from_column() \
        .as_predictor()
    assert type(P.transmogrify([tags]).origin_stage).__name__ == \
        "SetVectorizer"


@pytest.fixture
def vector(raw):
    """The transmogrified BigPassenger vector, as a store beside the
    label (JAX and port; identical arrays, see the test above)."""
    (jf, js), (pf, ps) = raw
    names = [n for _t, n in RAW]
    j_vec = j_tm([jf[n] for n in names])
    p_vec = P.transmogrify([pf[n] for n in names])
    jst = J.Workflow().set_input_store(js).set_result_features(j_vec) \
        .set_mesh(False).train().score(js, keep_intermediate=True) \
        .with_column("survived", js["survived"])
    pst = P.Workflow().set_input_store(ps).set_result_features(p_vec) \
        .train(**CPU).score(ps, keep_intermediate=True, **CPU) \
        .with_column("survived", ps["survived"])
    return (jf["survived"], j_vec, jst), (pf["survived"], p_vec, pst)


@pytest.mark.parametrize("corr", ["pearson", "spearman"])
def test_sanity_checker_keep_indices_and_summary(vector, corr):
    (jl, jv, jst), (pl, pv, pst) = vector
    jc = JSC.SanityChecker(remove_bad_features=True, correlation_type=corr)
    pc = PSC.SanityChecker(remove_bad_features=True, correlation_type=corr)
    jc.set_input(jl, jv)
    pc.set_input(pl, pv)
    jm = jc.fit(jst)
    pm = pc.fit(pst, device="cpu", dtype=torch.float64)
    assert pm.keep_indices == jm.keep_indices
    assert 30 < len(pm.keep_indices) < 534
    js, ps = jm.summary(), pm.summary()
    # the reasons quote the statistic (.3g): a constant column's variance
    # is 0 here and a few 1e-34 in XLA's summation order
    num = re.compile(r"-?\d+(?:\.\d+)?(?:e-?\d+)?")
    assert len(ps["droppedColumns"]) == len(js["droppedColumns"])
    for a, b in zip(js["droppedColumns"], ps["droppedColumns"]):
        assert (b["name"], b["removed"]) == (a["name"], a["removed"])
        assert [num.sub("#", r) for r in b["reasons"]] == \
            [num.sub("#", r) for r in a["reasons"]]
        np.testing.assert_allclose(
            [float(x) for r in b["reasons"] for x in num.findall(r)],
            [float(x) for r in a["reasons"] for x in num.findall(r)],
            rtol=1e-9, atol=1e-9)
    for a, b in zip(js["columnStats"], ps["columnStats"]):
        assert a["name"] == b["name"]
        for k in ("mean", "variance", "min", "max", "corrWithLabel",
                  "spearmanCorrWithLabel"):
            if a[k] is None or np.isnan(a[k]):
                assert b[k] is None or np.isnan(b[k]), (a["name"], k)
            else:
                assert abs(a[k] - b[k]) <= 1e-9, (a["name"], k)
    for a, b in zip(js["categoricalStats"], ps["categoricalStats"]):
        assert a["group"] == b["group"]
        for k in ("cramersV", "mutualInfo"):
            assert abs(a[k] - b[k]) <= 1e-12
        np.testing.assert_allclose(b["support"], a["support"], atol=1e-12)
    jout = jm.transform_columns(jst)
    pout = pm.transform_columns(pst)
    _same_vector(jout, pout)


def test_stats_utils_match(rng):
    X = rng.normal(size=(300, 6))
    X[:, 2] = 1.0
    X[:, 4] = np.round(X[:, 4])                  # ties for the ranks
    y = (rng.random(300) > 0.6).astype(np.float64)
    import jax.numpy as jnp
    want = JS.moments(jnp.asarray(X), jnp.asarray(y))
    got = PS.moments(torch.tensor(X), torch.tensor(y))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_array_equal(PS.average_ranks(X[:, 4]),
                                  JS.average_ranks(X[:, 4]))
    cont = np.array([[30.0, 5.0, 0.0], [2.0, 40.0, 7.0]])
    for pf, jf in ((PS.cramers_v_stats, JS.cramers_v_stats),
                   (PS.pmi_mutual_info, JS.pmi_mutual_info)):
        for a, b in zip(jf(cont), pf(cont)):
            np.testing.assert_array_equal(b, a)
    yd = torch.tensor(np.eye(2)[y.astype(int)])
    np.testing.assert_array_equal(
        PS.contingency(yd, torch.tensor(X[:, :3])).numpy(),
        np.eye(2)[y.astype(int)].T @ X[:, :3])
    jsp, _ = JS.spearman_with_label(X, y)
    psp, _ = PS.spearman_with_label(X, y)
    np.testing.assert_allclose(psp.numpy(), np.asarray(jsp), rtol=1e-12,
                               atol=1e-12)


def test_stages_carried_over_from_jax_state(vector, raw):
    (jl, jv, jst), (pl, pv, pst) = vector
    (jf, js), (pf, ps) = raw
    checker = JSC.SanityChecker(remove_bad_features=True)
    checker.set_input(jl, jv)
    # (JAX fitted stage, the port's inputs, the stores each reads)
    cases = [(checker.fit(jst), (pl, pv), jst, pst)]
    for est, names in ((JN.RealVectorizer(), ("age", "height")),
                       (JO.OneHotVectorizer(), ("gender",)),
                       (JST.SmartTextVectorizer(), ("gender",
                                                    "description"))):
        est.set_input(*[jf[n] for n in names])
        cases.append((est.fit(js), tuple(pf[n] for n in names), js, ps))
    date = JD.DateToUnitCircleVectorizer(periods=["HourOfDay", "DayOfYear"])
    date.set_input(jf["boarded"])
    cases.append((date, (pf["boarded"],), js, ps))
    for jm, inputs, src_j, src_p in cases:
        pm = fitted_stage_from_state(type(jm).__name__, jm.get_model_state(),
                                     jm.get_params())
        assert type(pm).__name__ == type(jm).__name__
        pm.input_features = inputs
        kw = CPU if getattr(pm, "uses_device", False) else {}
        jc = jm.transform_columns(src_j)
        pc = pm.transform_columns(src_p, **kw)
        np.testing.assert_array_equal(pc.values, jc.values)
        assert pc.metadata.column_names() == jc.metadata.column_names()


def test_uids_line_up_for_carry_over():
    """Both packages number stages alike, so a DAG built in the same order
    from fresh counters has the same estimator uids."""
    from examples.big_passenger import build_features
    puid.reset()
    _js, jchecked = build_features()
    _ps, pchecked = PB.build_features()
    assert pchecked.origin_stage.uid == jchecked.origin_stage.uid
    assert sorted(s.uid for s in pchecked.parent_stages()) == \
        sorted(s.uid for s in jchecked.parent_stages())
