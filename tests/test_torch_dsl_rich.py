"""Every ``Feature`` method of the JAX package's DSL in the port: each
builds the JAX package's stage (class, operation, output type and ctor
parameters, the JAX package's defaults), and the every-surface workflow
(every new surface in one DAG) gives the JAX package's vector and
selection.

Tolerances: stage classes, operations and parameters equal (three
methods build an unnamed ``LambdaTransformer`` in the JAX package, which
no save can hold; the port builds a registered stage with the same
operation and output: ``LAMBDA_STAGES``); each host stage's column exact
(NGramSimilarity 1e-12); the every-surface vector at 2,000 records in
f64 within 1e-12 (LDA and Word2Vec columns; every other column exact),
the same selected family and grid point; LR's and GBT's fold metrics
within 1e-12 (the JAX package trained on one device, ``set_mesh(False)``:
under this suite's 8-device mesh it sums GBT's histograms device by
device, which moves a near-tied split; seen: 3.3e-16 and 2.2e-16), the
MLP's within 0.02 (seen: 8.1e-3), held only beside the winner asserted
exactly: full-batch Adam divides each gradient
coordinate by its own running magnitude, so a coordinate summed from
cancelling terms carries its rounding (~1e-11 after 5 steps on this
wide vector, the autograd and XLA's gradient summing in another
order) into a step of full size, and the gap grows about tenfold every
ten steps (~1e-4 in the weights after 100); on narrow data (the GLM /
MLP tests) it stays ~1e-15. The port's saved model scores alike after a
load (exact); value operations and ``map_to`` with a user's lambda save
in either package and load in the other (exact)."""
import os
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu_torch as P
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import every_surface as ES
from transmogrifai_tpu_torch.utils import uid as puid

sys.path.insert(0, os.path.dirname(__file__))
import _every_surface_common as ESC  # noqa: E402

#: JAX methods whose stage is a LambdaTransformer → the port's stage
LAMBDA_STAGES = {"is_substring": "IsSubstringTransformer",
                 "drop_indices_by": "DropIndicesByTransformer",
                 "tupled": "PredictionPartTransformer"}


def _pred_fn(v):
    return v is not None and v > 1.0


def _meta_fn(cm):
    return False


def _calls(pkg):
    """(method name, feature types, call) for each of the 45 methods."""
    t = pkg.types.feature_types
    return [
        ("abs", t.Real, lambda f: f.abs()),
        ("ceil", t.Real, lambda f: f.ceil()),
        ("floor", t.Real, lambda f: f.floor()),
        ("round_to", t.Real, lambda f: f.round_to(2)),
        ("exp", t.Real, lambda f: f.exp()),
        ("log", t.Real, lambda f: f.log(10.0)),
        ("sqrt", t.Real, lambda f: f.sqrt()),
        ("power", t.Real, lambda f: f.power(3.0)),
        ("to_email_prefix", t.Email, lambda f: f.to_email_prefix()),
        ("to_email_domain", t.Email, lambda f: f.to_email_domain()),
        ("to_url_protocol", t.URL, lambda f: f.to_url_protocol()),
        ("to_url_domain", t.URL, lambda f: f.to_url_domain()),
        ("is_valid_email", t.Email, lambda f: f.is_valid_email()),
        ("is_valid_url", t.URL, lambda f: f.is_valid_url()),
        ("is_valid_phone", t.Phone, lambda f: f.is_valid_phone()),
        ("parse_phone", t.Phone, lambda f: f.parse_phone("GB")),
        ("detect_mime_types", t.Base64, lambda f: f.detect_mime_types()),
        ("to_email_domain_map", t.EmailMap,
         lambda f: f.to_email_domain_map()),
        ("to_url_domain_map", t.URLMap, lambda f: f.to_url_domain_map()),
        ("is_valid_phone_map", t.PhoneMap,
         lambda f: f.is_valid_phone_map()),
        ("tokenize", t.Text, lambda f: f.tokenize(min_token_length=2)),
        ("ngram_similarity", t.Text,
         lambda f: f.ngram_similarity(f, n=4)),
        ("count_vectorize", t.TextList,
         lambda f: f.count_vectorize(vocab_size=9)),
        ("lda", t.TextList, lambda f: f.lda()),
        ("word2vec", t.TextList, lambda f: f.word2vec()),
        ("detect_languages", t.Text, lambda f: f.detect_languages()),
        ("recognize_entities", t.Text, lambda f: f.recognize_entities()),
        ("is_substring", t.Text, lambda f: f.is_substring(f)),
        ("to_percentile", t.Real, lambda f: f.to_percentile()),
        ("to_isotonic_calibrated", t.Real,
         lambda f: f.to_isotonic_calibrated(
             pkg.FeatureBuilder.RealNN("y").from_column().as_response())),
        ("deindexed", t.RealNN, lambda f: f.deindexed(
            pkg.FeatureBuilder.Prediction("p").from_column()
            .as_predictor())),
        ("tupled", t.Prediction, lambda f: f.tupled()[2]),
        ("replace_with", t.Real, lambda f: f.replace_with(1.0, 2.0)),
        ("filter_values", t.Real, lambda f: f.filter_values(_pred_fn, 0.0)),
        ("filter_not", t.Real, lambda f: f.filter_not(_pred_fn, 0.0)),
        ("collect", t.Real, lambda f: f.collect(_pred_fn, False, t.Binary)),
        ("exists", t.Real, lambda f: f.exists(_pred_fn)),
        ("occurs", t.Real, lambda f: f.occurs()),
        ("drop_indices_by", t.OPVector, lambda f: f.drop_indices_by(
            _meta_fn)),
        ("to_multi_pick_list", t.TextList,
         lambda f: f.to_multi_pick_list()),
        ("to_date_list", t.Date, lambda f: f.to_date_list()),
        ("to_date_time_list", t.DateTime, lambda f: f.to_date_time_list()),
        ("to_unit_circle", t.Date, lambda f: f.to_unit_circle()),
        ("combine", t.OPVector, lambda f: f.combine(f)),
        ("vectorize_location", t.City, lambda f: f.vectorize_location()),
    ]


def _build(pkg, uid):
    uid.reset()
    out = []
    for name, ftype, call in _calls(pkg):
        f = getattr(pkg.FeatureBuilder, ftype.__name__)("x").from_column() \
            .as_predictor()
        out.append((name, call(f)))
    return out


def _params(stage):
    p = {k: v for k, v in stage.get_params().items()
         if k not in ("uid", "fn", "match_fn")}
    return {k: (v.__name__ if isinstance(v, type) else v)
            for k, v in p.items()}


def test_forty_five_methods_build_the_jax_stages():
    jb, pb = _build(J, juid), _build(P, puid)
    assert len(jb) == len(pb) == 45
    for (name, jf), (_, pf) in zip(jb, pb):
        js, ps = jf.origin_stage, pf.origin_stage
        assert pf.ftype.__name__ == jf.ftype.__name__, name
        assert ps.operation_name == js.operation_name, name
        if name in LAMBDA_STAGES:
            assert type(js).__name__ == "LambdaTransformer"
            assert type(ps).__name__ == LAMBDA_STAGES[name]
            continue
        assert type(ps).__name__ == type(js).__name__, name
        if type(js).__name__ in ("MapTransformer",):
            continue           # the row function: a named one here
        assert _params(ps) == _params(js), name


def test_dsl_defaults_match_estimator_defaults():
    import inspect
    from transmogrifai_tpu_torch.ops.topics import OpLDA, OpWord2Vec
    t = P.FeatureBuilder.TextList("t").from_column().as_predictor()
    stage = t.word2vec().origin_stage
    sig = inspect.signature(OpWord2Vec.__init__)
    assert stage.dim == sig.parameters["dim"].default == 100
    assert stage.window == sig.parameters["window"].default == 5
    assert t.lda().origin_stage.n_topics == inspect.signature(
        OpLDA.__init__).parameters["n_topics"].default


def _store(pkg, cols):
    return pkg.columns.ColumnStore.from_dict(
        {k: (getattr(pkg.types.feature_types, t), v)
         for k, (t, v) in cols.items()})


def test_host_methods_transform_like_jax():
    cols = {"r": ("Real", [None, -2.5, 0.0, 1.5, 7.25, 100.0]),
            "d": ("Date", [None, 0, 86_400_000, 1_600_000_000_000, 5, 6]),
            "l": ("TextList", [[], ["a", "b"], ["a"], ["c", "a"], ["b"],
                               ["x"]]),
            "em": ("EmailMap", [{}, {"w": "a@b.com", "h": "bad"},
                                {"w": "c@d.org"}, {}, {"x": "y@z.io"}, {}]),
            "um": ("URLMap", [{}, {"a": "http://x.com/p"}, {"b": "nope"},
                              {}, {}, {"c": "https://q.org"}]),
            "pm": ("PhoneMap", [{}, {"m": "2025550123"}, {"m": "12"}, {},
                                {"n": "+44 20 7946 0958"}, {}])}

    def make(pkg):
        FB = pkg.FeatureBuilder
        r = FB.Real("r").from_column().as_predictor()
        d = FB.Date("d").from_column().as_predictor()
        lst = FB.TextList("l").from_column().as_predictor()
        em = FB.EmailMap("em").from_column().as_predictor()
        um = FB.URLMap("um").from_column().as_predictor()
        pm = FB.PhoneMap("pm").from_column().as_predictor()
        return [r.abs(), r.ceil(), r.floor(), r.round_to(1), r.exp(),
                r.log(), r.log(2.0), r.sqrt(), r.power(2.0),
                r.replace_with(1.5, 9.0), r.filter_values(_pred_fn, None),
                r.filter_not(_pred_fn, -1.0), r.exists(_pred_fn),
                r.occurs(), r.occurs(_pred_fn), d.to_date_list(),
                lst.to_multi_pick_list(), em.to_email_domain_map(),
                um.to_url_domain_map(), pm.is_valid_phone_map()]
    outs = []
    for pkg, uid, kw in ((J, juid, {}), (P, puid, {"device": "cpu"})):
        uid.reset()
        store = _store(pkg, cols)
        feats = make(pkg)
        model = pkg.Workflow().set_input_store(store).set_result_features(
            *feats).train(**kw)
        out = model.transform(store, **({"engine": False} if kw else {}),
                              **kw)
        outs.append([[out[f.name].get_raw(i) for i in range(6)]
                     for f in feats])
    for a, b in zip(*outs):
        assert a == b


N_SURFACE = 2000
MLP_POINT = [{"stepSize": 0.03, "layers": (10,)}]


@pytest.fixture(scope="module")
def surface():
    """The every-surface workflow trained on N_SURFACE records by both
    packages: the JAX package on one device (``set_mesh(False)``), the
    port on the CPU in f64."""
    raw = ES.make_raw(N_SURFACE, seed=13)
    juid.reset()
    jns = ESC.namespace(J)
    jstore = ESC.raw_store(jns, raw)
    jwf = ESC.build_workflow(jns, jstore, ESC.one_point_families(
        jns, mlp_grid=MLP_POINT))
    jm = jwf["workflow"].set_mesh(False).train()
    puid.reset()
    pstore = ES.raw_store(raw)
    pwf = ES.build_workflow(pstore, ES.one_point_families(
        mlp_grid=MLP_POINT))
    pm = pwf["workflow"].train(device="cpu", dtype=torch.float64)
    return raw, (jstore, jwf, jm), (pstore, pwf, pm)


def test_every_surface_vector_and_selection_match_jax(surface):
    raw, (jstore, jwf, jm), (pstore, pwf, pm) = surface
    jx = jm.transform(jstore)[jwf["features"].name]
    px = pm.transform(pstore, device="cpu", engine=False)[
        pwf["features"].name]
    assert [c.to_json() for c in px.metadata.columns] == \
        [c.to_json() for c in jx.metadata.columns]
    a, b = np.asarray(px.values, np.float64), np.asarray(jx.values,
                                                         np.float64)
    fuzzy = [i for i, c in enumerate(px.metadata.columns)
             if c.parent_feature_name.startswith(("lda", "w2v", "OpLDA",
                                                  "OpWord2Vec"))
             or "topic_" in str(c.descriptor_value)
             or "w2v_" in str(c.descriptor_value)]
    exact = [i for i in range(a.shape[1]) if i not in fuzzy]
    assert len(fuzzy) == 110
    np.testing.assert_array_equal(a[:, exact], b[:, exact])
    np.testing.assert_allclose(a[:, fuzzy], b[:, fuzzy], rtol=0, atol=1e-12)
    js = jm.fitted_stages[jwf["selector"].uid].selector_summary
    ps = pm.fitted_stages[pwf["selector"].uid].selector_summary
    assert ps.best_model_name == js.best_model_name
    assert ps.best_model_params == js.best_model_params
    for r, q in zip(ps.validator_summary.results,
                    js.validator_summary.results):
        assert r.family_name == q.family_name
        tol = {"OpLogisticRegression": 1e-12, "OpGBTClassifier": 1e-12,
               "OpMultilayerPerceptronClassifier": 0.02}[r.family_name]
        np.testing.assert_allclose(r.metric_values, q.metric_values,
                                   rtol=0, atol=tol)


def test_every_surface_saved_model_scores_alike(surface, tmp_path):
    raw, _j, (pstore, pwf, pm) = surface
    pm.save(str(tmp_path / "m"))
    loaded = P.WorkflowModel.load(str(tmp_path / "m"))
    want = pm.score(pstore, device="cpu", engine=False)
    got = loaded.score(pstore, device="cpu", engine=False)
    pred = pwf["prediction"].name
    np.testing.assert_array_equal(got[pred].probability,
                                  want[pred].probability)
    p, raw_col, prob = pwf["tupled"]
    np.testing.assert_array_equal(got[p.name].values,
                                  want[pred].prediction)
    np.testing.assert_array_equal(got[prob.name].values,
                                  want[pred].probability)
    np.testing.assert_array_equal(got[raw_col.name].values,
                                  want[pred].raw_prediction)


def test_value_ops_and_map_functions_save_both_ways(tmp_path):
    """The row functions round-trip through ``fn_io`` in both packages:
    a user's lambda as marshaled code, the same bytes both ways (exact)."""
    cols = {"r": ("Real", [None, -2.5, 0.0, 1.5, 7.25]),
            "t": ("Text", [None, "a", "bb", "", "ccc"])}
    outs, models = [], []
    for pkg, uid, kw in ((J, juid, {}), (P, puid, {"device": "cpu"})):
        uid.reset()
        store = _store(pkg, cols)
        r = pkg.FeatureBuilder.Real("r").from_column().as_predictor()
        t = pkg.FeatureBuilder.Text("t").from_column().as_predictor()
        feats = [r.filter_values(lambda v: v is not None and v > 1.0, None),
                 r.exists(lambda v: v < 0.0), r.replace_with(0.0, 9.0),
                 t.map_to(lambda v: None if v is None else len(v),
                          pkg.types.feature_types.Integral, "len")]
        m = pkg.Workflow().set_input_store(store).set_result_features(
            *feats).train(**kw)
        m.save(str(tmp_path / pkg.__name__))
        models.append((m, store, feats))
    (jm, jstore, jf), (pm, pstore, pf) = models
    got = P.WorkflowModel.load(str(tmp_path / J.__name__)).transform(
        pstore, device="cpu", engine=False)
    back = J.WorkflowModel.load(str(tmp_path / P.__name__)).transform(
        jstore)
    want = jm.transform(jstore)
    for a, b in zip(pf, jf):
        assert [got[b.name].get_raw(i) for i in range(5)] == \
            [want[b.name].get_raw(i) for i in range(5)] == \
            [back[a.name].get_raw(i) for i in range(5)]
