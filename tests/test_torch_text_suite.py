"""The text suite and the taggers in the port against the JAX package on
the CPU: the email / phone / URL / MIME parsers and their stages, the
count vectorizer (vocabularies and counts), the language detector, the
sentence splitter, the POS tagger and the entity recognizer, the tagger
weights themselves.

Tolerances: exact (equal values, equal masks, bitwise count blocks) for
everything but ``NGramSimilarity``, within 1e-12 (f64 cosines); the same
after a save in either package and a load in the other."""
import base64

import numpy as np
import pytest

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.columns import ColumnStore as JStore
from transmogrifai_tpu.ops import text_suite as JT
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import taggers as JTG
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import every_surface as ES
from transmogrifai_tpu_torch.columns import ColumnStore as PStore
from transmogrifai_tpu_torch.ops import text_suite as PT
from transmogrifai_tpu_torch.scoring import _classify
from transmogrifai_tpu_torch.types import feature_types as PFT
from transmogrifai_tpu_torch.utils import taggers as PTG
from transmogrifai_tpu_torch.utils import uid as puid

RAW = ES.make_raw(300, seed=5)
NOTES = ES.make_tagger_raw(60, seed=3)["note"][1] + [
    "Dr. J. Smith paid $3.5 million to Acme Corp. in Paris on Monday.",
    "", "no capitals here at all", "U.S. officials met in Tokyo!"]


@pytest.mark.parametrize("col,fn", [("email", "parse_email"),
                                    ("url", "parse_url"),
                                    ("phone", "parse_phone"),
                                    ("attach", "detect_mime")])
def test_parsers_exact(col, fn):
    values = RAW[col][1] + [None, "", "  x@y.io ", "+44 20 7946 0958",
                            "ftp://files.example.org:21/x", "+1234",
                            base64.b64encode(b"%PDF-1.4").decode()]
    for v in values:
        assert getattr(PT, fn)(v) == getattr(JT, fn)(v), v


def _stores(cols):
    j = JStore.from_dict({k: (getattr(JFT, t), v) for k, (t, v) in
                          cols.items()})
    p = PStore.from_dict({k: (getattr(PFT, t), v) for k, (t, v) in
                          cols.items()})
    return j, p


def _run(FB, W, store, make, **kw):
    feats = make(FB)
    model = W().set_input_store(store).set_result_features(*feats).train(
        **kw)
    out = model.transform(store, **({"engine": False, "device": "cpu"}
                                    if kw else {}))
    return [out[f.name] for f in feats]


def _same_column(a, b, tol=0.0):
    if isinstance(getattr(a, "values", None), np.ndarray) and \
            a.values.ndim == 2:                     # a vector block
        np.testing.assert_array_equal(np.asarray(a.values, np.float32),
                                      np.asarray(b.values, np.float32))
    elif hasattr(a, "mask"):
        np.testing.assert_array_equal(a.mask, b.mask)
        if tol:
            np.testing.assert_allclose(np.asarray(a.values, float),
                                       np.asarray(b.values, float),
                                       rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(a.values, b.values)
    else:
        assert [a.get_raw(i) for i in range(len(a))] == \
            [b.get_raw(i) for i in range(len(b))]


def test_parser_stages_and_similarity_match_jax():
    cols = {k: RAW[k] for k in ("email", "url", "phone", "attach",
                                "subject", "body")}

    def make(FB):
        e = FB.Email("email").from_column().as_predictor()
        u = FB.URL("url").from_column().as_predictor()
        ph = FB.Phone("phone").from_column().as_predictor()
        a = FB.Base64("attach").from_column().as_predictor()
        s = FB.Text("subject").from_column().as_predictor()
        b = FB.Text("body").from_column().as_predictor()
        return [e.to_email_prefix(), e.to_email_domain(),
                u.to_url_protocol(), u.to_url_domain(), ph.is_valid_phone(),
                ph.parse_phone(), a.detect_mime_types(),
                s.ngram_similarity(b), s.ngram_similarity(b, n=2)]
    js, ps = _stores(cols)
    juid.reset()
    jcols = _run(JFB, JWorkflow, js, make)
    puid.reset()
    pcols = _run(PFB, PWorkflow, ps, make, device="cpu")
    for k, (a, b) in enumerate(zip(pcols, jcols)):
        _same_column(a, b, 1e-12 if k >= 7 else 0.0)


def test_count_vectorizer_exact_and_fuses_as_vec():
    docs = [t.lower().split() for t in RAW["body"][1]]
    docs[3] = []
    cols = {"t": ("TextList", docs), "u": ("TextList", docs[::-1])}
    js, ps = _stores(cols)
    for kw in ({"vocab_size": 512}, {"vocab_size": 7, "min_df": 3,
                                      "binary": True}):
        def make(FB):
            t = FB.TextList("t").from_column().as_predictor()
            u = FB.TextList("u").from_column().as_predictor()
            return [t.count_vectorize(u, **kw)]
        juid.reset()
        (jc,) = _run(JFB, JWorkflow, js, make)
        puid.reset()
        (pc,) = _run(PFB, PWorkflow, ps, make, device="cpu")
        assert np.array_equal(np.asarray(pc.values, np.float32),
                              np.asarray(jc.values, np.float32))
        assert [c.indicator_value for c in pc.metadata.columns] == \
            [c.indicator_value for c in jc.metadata.columns]
    assert _classify(PT.CountVectorizerModel(vocabs=[["a"]])) == "vec"


def test_taggers_weights_and_outputs_identical():
    for kind in ("pos", "ner", "sent"):
        jt, pt = JTG.load_tagger(kind), PTG.load_tagger(kind)
        assert jt is not None and pt is not None
        assert pt.model.weights == jt.model.weights
        assert pt.model.classes == jt.model.classes
    for text in NOTES:
        assert PT.split_sentences(text) == JT.split_sentences(text)
        toks = PT._ner_tokenize(text)
        assert toks == JT._ner_tokenize(text)
        pos = PTG.load_tagger("pos").tag(toks)
        assert pos == JTG.load_tagger("pos").tag(toks)
        assert PTG.load_tagger("ner").tag(toks, pos) == \
            JTG.load_tagger("ner").tag(toks, pos)


def test_tagger_stages_match_jax():
    cols = {"note": ("Text", NOTES + [None])}

    def make(FB):
        n = FB.Text("note").from_column().as_predictor()
        mod = JT if FB is JFB else PT
        return [n.recognize_entities(), n.detect_languages(),
                n.transform_with(mod.OpSentenceSplitter()),
                n.transform_with(mod.OpPOSTagger()),
                n.transform_with(mod.NameEntityRecognizer(
                    entity_types=["PER"], min_span_tokens=2))]
    js, ps = _stores(cols)
    juid.reset()
    jcols = _run(JFB, JWorkflow, js, make)
    puid.reset()
    pcols = _run(PFB, PWorkflow, ps, make, device="cpu")
    for a, b in zip(pcols, jcols):
        _same_column(a, b)


def test_ner_heuristic_spans_match_jax():
    """The documented fallback over capitalized runs (no weights)."""
    for text in NOTES:
        toks = text.split()
        assert PT.NameEntityRecognizer()._heuristic_spans(toks) == \
            JT.NameEntityRecognizer()._heuristic_spans(toks)


def _text_pipeline(FB, W, Store, FT, mod, **kw):
    cols = {"email": ("Email", RAW["email"][1]),
            "body": ("Text", RAW["body"][1]),
            "subject": ("Text", RAW["subject"][1]),
            "toks": ("TextList", [t.lower().split()
                                  for t in RAW["body"][1]])}
    store = Store.from_dict({k: (getattr(FT, t), v)
                             for k, (t, v) in cols.items()})
    e = FB.Email("email").from_column().as_predictor()
    b = FB.Text("body").from_column().as_predictor()
    s = FB.Text("subject").from_column().as_predictor()
    t = FB.TextList("toks").from_column().as_predictor()
    feats = [e.to_email_domain(), s.ngram_similarity(b),
             t.count_vectorize(vocab_size=20), s.recognize_entities(),
             s.detect_languages(), s.transform_with(mod.OpPOSTagger()),
             b.transform_with(mod.OpSentenceSplitter())]
    model = W().set_input_store(store).set_result_features(*feats).train(
        **kw)
    return model, store, feats


def test_text_stage_saves_load_both_ways(tmp_path):
    """A JAX-saved text pipeline (count vocabularies, parsers, taggers)
    transforms alike in the port, and a port-saved one in the JAX
    package (exact; NGramSimilarity 1e-12)."""
    from transmogrifai_tpu.workflow import WorkflowModel as JWM
    from transmogrifai_tpu_torch.workflow import WorkflowModel as PWM
    juid.reset()
    jm, jstore, jf = _text_pipeline(JFB, JWorkflow, JStore, JFT, JT)
    puid.reset()
    pm, pstore, pf = _text_pipeline(PFB, PWorkflow, PStore, PFT, PT,
                                    device="cpu")
    jm.save(str(tmp_path / "j"))
    got = PWM.load(str(tmp_path / "j")).transform(pstore, device="cpu",
                                                    engine=False)
    want = jm.transform(jstore)
    for k, f in enumerate(jf):
        _same_column(got[f.name], want[f.name], 1e-12 if k == 1 else 0.0)
    pm.save(str(tmp_path / "p"))
    back = JWM.load(str(tmp_path / "p")).transform(jstore)
    mine = pm.transform(pstore, device="cpu", engine=False)
    for k, f in enumerate(pf):
        _same_column(back[f.name], mine[f.name], 1e-12 if k == 1 else 0.0)
