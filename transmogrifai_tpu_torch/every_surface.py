"""Every surface of the rich DSL in one workflow, on the card — the path
``every-surface`` (the email / URL / phone / MIME parsers, n-gram
similarity, substring tests, tokenization into counts, LDA topics and
Word2Vec embeddings, unary math, percentile and isotonic calibration, a
map lift and a list lift, the value operations), transmogrified into one
vector, checked by the SanityChecker and fed to a binary selector over
logistic regression, GBT and the MLP.

Records are message-like rows made from ``numpy.random.default_rng(seed)``:
a sender Email, a link URL, a Phone, a Base64 attachment whose magic bytes
cover the MIME table, a subject (a few words) and a body (a few dozen)
over word lists with topic clusters, a Real amount, a RealMap of counts
and a TextList of cc addresses. The label leans on the sender's domain,
the body's topic cluster and the amount.

Usage::

    from transmogrifai_tpu_torch import every_surface as ES
    raw = ES.make_raw(200_000, seed=13)
    out = ES.run(raw)                                      # on the card
    out = ES.run(ES.make_raw(2_000), device="cpu", dtype=torch.float64)
"""
from __future__ import annotations

import base64
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .columns import ColumnStore
from .dsl import transmogrify
from .evaluators import Evaluators
from .features import FeatureBuilder as FB
from .models.linear import LogisticRegressionFamily
from .models.selector import BinaryClassificationModelSelector
from .models.svm import MLPFamily
from .models.trees import GBTFamily
from .ops.collections import OPListTransformer, OPMapTransformer
from .ops.scalers import ScalerTransformer
from .ops.text_suite import EmailParser, OpPOSTagger, OpSentenceSplitter
from .types import feature_types as ft
from .workflow import Workflow

__all__ = ["make_raw", "raw_store", "build_workflow", "one_point_families",
           "train", "run", "make_tagger_raw", "build_tagger_workflow",
           "run_taggers", "TOPICS", "DOMAINS"]

#: sender domains (the label leans on the first three)
DOMAINS = ("acme.com", "globex.org", "initech.net", "umbrella.io",
           "hooli.com", "vandelay.biz", "mail.example.com", "piedpiper.co")
#: body / subject word clusters, one per topic (the label leans on the
#: first)
TOPICS = (
    ("invoice", "payment", "overdue", "refund", "billing", "charge",
     "account", "balance", "receipt", "credit", "due", "statement"),
    ("meeting", "schedule", "calendar", "agenda", "tomorrow", "room",
     "notes", "minutes", "call", "invite", "monday", "friday"),
    ("server", "outage", "deploy", "latency", "incident", "patch",
     "rollback", "alert", "disk", "cluster", "restart", "logs"),
    ("offer", "discount", "sale", "coupon", "free", "limited", "deal",
     "exclusive", "price", "save", "bonus", "gift"),
    ("team", "lunch", "party", "birthday", "welcome", "office", "trip",
     "photos", "weekend", "cake", "games", "music"),
)
#: words every topic shares
COMMON = ("the", "a", "to", "and", "of", "for", "on", "your", "please",
          "with", "this", "we", "is", "in", "at", "by")
#: attachment heads: one per MIME table row, plain text, and binary noise
_MAGICS = (b"%PDF", b"\x89PNG", b"GIF8", b"\xff\xd8\xff", b"PK\x03\x04",
           b"\x1f\x8b", b"BM", b"ID3", b"OggS", b"fLaC", b"RIFF", b"MZ",
           b"%!PS", b"<?xml", b"<html", b"{\\rtf", b"hello world ",
           b"\x00\x9f\x92\x96")
_PHONES = ("{a}{b}{c}", "({a}) {b}-{c}", "{a}-{b}-{c}", "+1 {a} {b} {c}",
           "+44 20 {b} {c}", "+49 30 {b}{c}", "{a}-{b}", "+99 {a}")
_TLDS_BAD = ("acme", "bad@@mail", "no-at-sign.com")


def make_raw(n: int = 2000, seed: int = 13) -> Dict[str, tuple]:
    """``n`` records as ``{column: (feature type name, values)}``."""
    rng = np.random.default_rng(seed)
    dom = rng.integers(0, len(DOMAINS), n)
    topic = rng.integers(0, len(TOPICS), n)
    prefixes = rng.integers(0, 5000, n)
    email_kind = rng.random(n)
    email = [None if k < 0.05 else
             (f"user{p}@{DOMAINS[d]}" if k > 0.1 else
              f"user{p}@{_TLDS_BAD[p % 3]}")
             for k, p, d in zip(email_kind, prefixes, dom)]
    proto = rng.integers(0, 4, n)
    url_dom = rng.integers(0, len(DOMAINS), n)
    url = [None if pr == 3 and p % 2 else
           (f"{('http', 'https', 'ftp', 'gopher')[pr]}://"
            f"{'www.' if p % 3 else ''}{DOMAINS[u]}/page{p % 97}")
           for pr, u, p in zip(proto, url_dom, prefixes)]
    pk = rng.integers(0, len(_PHONES) + 1, n)
    digits = rng.integers(0, 10, (n, 10))
    phone = []
    for k, dg in zip(pk, digits):
        if k == len(_PHONES):
            phone.append(None)
            continue
        s = "".join(map(str, dg))
        phone.append(_PHONES[k].format(a=s[:3], b=s[3:6], c=s[6:]))
    mk = rng.integers(0, len(_MAGICS), n)
    tail = rng.integers(0, 256, (n, 12), dtype=np.uint8)
    attach = [base64.b64encode(_MAGICS[k] + t.tobytes()).decode("ascii")
              for k, t in zip(mk, tail)]
    n_subj = rng.integers(2, 6, n)
    n_body = rng.integers(12, 30, n)
    own = rng.random((n, 30))
    pick = rng.integers(0, 12, (n, 30))
    other = rng.integers(0, len(TOPICS), (n, 30))
    common = rng.integers(0, len(COMMON), (n, 30))
    kind = rng.random((n, 30))

    def words(i, k):
        out = []
        for j in range(k):
            if kind[i, j] < 0.3:
                out.append(COMMON[common[i, j]])
            else:
                t = topic[i] if own[i, j] < 0.8 else other[i, j]
                out.append(TOPICS[t][pick[i, j]])
        return out
    subject = [" ".join(words(i, n_subj[i])).capitalize() for i in range(n)]
    body = [" ".join(words(i, n_body[i])[::-1]) + "." for i in range(n)]
    amount = np.round(rng.lognormal(4.0, 1.2, n)
                      * np.where(rng.random(n) < 0.05, -1.0, 1.0), 2)
    amount_v = [None if m else float(a)
                for a, m in zip(amount, rng.random(n) < 0.04)]
    keys = ("opens", "clicks", "replies", "forwards")
    present = rng.random((n, len(keys))) < 0.7
    cnt = rng.poisson(3.0, (n, len(keys))).astype(float)
    counts = [{k: cnt[i, j] for j, k in enumerate(keys) if present[i, j]}
              for i in range(n)]
    n_cc = rng.integers(0, 4, n)
    cc_dom = rng.integers(0, len(DOMAINS), (n, 3))
    cc = [[f"cc{(prefixes[i] + j) % 50}@{DOMAINS[cc_dom[i, j]]}"
           for j in range(n_cc[i])] for i in range(n)]
    z = (1.2 * (dom < 3) + 1.4 * (topic == 0) - 0.8 * (topic == 3)
         + 0.45 * (np.log1p(np.abs(amount)) - 4.0)
         + rng.normal(0.0, 1.0, n) - 0.6)
    label = (z > 0).astype(float)
    return {"email": ("Email", email), "url": ("URL", url),
            "phone": ("Phone", phone), "attach": ("Base64", attach),
            "subject": ("Text", subject), "body": ("Text", body),
            "amount": ("Real", amount_v), "counts": ("RealMap", counts),
            "cc": ("TextList", cc), "label": ("RealNN", label.tolist())}


def raw_store(raw: Dict[str, tuple]) -> ColumnStore:
    """``raw`` as a ColumnStore."""
    return ColumnStore.from_dict(
        {k: (getattr(ft, t), v) for k, (t, v) in raw.items()})


def _small_amount(v):
    return v is not None and v < 5000.0


def _org_domain(v):
    return v.endswith(".org")


def one_point_families(mlp_grid=None) -> List[Any]:
    """LR and GBT at one grid point each, the MLP at its default grid (or
    ``mlp_grid``)."""
    return [LogisticRegressionFamily(
                grid=[{"regParam": 0.01, "elasticNetParam": 0.1}]),
            GBTFamily(grid=[{"maxDepth": 3, "minInstancesPerNode": 10,
                             "minInfoGain": 0.001}]),
            MLPFamily(grid=mlp_grid)]


def build_workflow(store: ColumnStore, families=None, num_folds: int = 3,
                   seed: int = 13) -> Dict[str, Any]:
    """The untrained workflow over ``store``: ``{"workflow", "selector",
    "label", "prediction", "features", "checked", "tupled", "stages"}``
    (``stages``: the derived features by name)."""
    label = FB.RealNN("label").from_column().as_response()
    email = FB.Email("email").from_column().as_predictor()
    url = FB.URL("url").from_column().as_predictor()
    phone = FB.Phone("phone").from_column().as_predictor()
    attach = FB.Base64("attach").from_column().as_predictor()
    subject = FB.Text("subject").from_column().as_predictor()
    body = FB.Text("body").from_column().as_predictor()
    amount = FB.Real("amount").from_column().as_predictor()
    counts = FB.RealMap("counts").from_column().as_predictor()
    cc = FB.TextList("cc").from_column().as_predictor()

    email_domain = email.to_email_domain()
    url_domain = url.to_url_domain()
    d = {
        "email_domain": email_domain,
        "email_ok": email.is_valid_email(),
        "url_domain": url_domain,
        "url_protocol": url.to_url_protocol(),
        "phone_ok": phone.is_valid_phone(),
        "mime": attach.detect_mime_types(),
        "similarity": subject.ngram_similarity(body),
        "domain_in_url": email_domain.is_substring(url_domain),
    }
    body_tokens = body.tokenize()
    subject_tokens = subject.tokenize()
    d["counts_vec"] = body_tokens.count_vectorize(vocab_size=512)
    d["topics"] = body_tokens.lda(n_topics=10)
    # Word2Vec over the subjects: at 200,000 records the bodies give 35
    # times the subjects' skip-gram pairs, whose 100 full-batch epochs
    # alone would pass the card run's time limit (PERF.md §4)
    d["embedding"] = subject_tokens.word2vec()
    d["log_amount"] = amount.abs().log()
    d["sqrt_amount"] = amount.sqrt()
    d["amount_pct"] = amount.to_percentile()
    d["amount_cal"] = amount.to_isotonic_calibrated(label)
    d["counts_scaled"] = counts.transform_with(OPMapTransformer(
        ScalerTransformer(slope=0.5, intercept=1.0)))
    d["cc_domains"] = cc.transform_with(
        OPListTransformer(EmailParser(part="domain")))
    d["small_amount"] = amount.filter_values(_small_amount, None)
    d["org_url"] = url_domain.exists(_org_domain)
    d["cc_set"] = d["cc_domains"].to_multi_pick_list()

    pivots = [d[k].pivot() for k in ("email_domain", "url_domain",
                                     "url_protocol", "mime")]
    rest = [d[k] for k in d if k not in ("email_domain", "url_domain",
                                         "url_protocol", "mime",
                                         "cc_domains")]
    features = transmogrify(pivots + rest)
    checked = label.sanity_check(features, remove_bad_features=True)
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, seed=seed,
        families=families if families is not None
        else one_point_families())
    pred = label.transform_with(selector, checked)
    tupled = pred.tupled()
    wf = Workflow().set_input_store(store).set_result_features(
        pred, *tupled)
    return {"workflow": wf, "selector": selector, "label": label,
            "prediction": pred, "features": features, "checked": checked,
            "tupled": tupled, "stages": d}


def train(store: ColumnStore, wf: Dict[str, Any], device=None,
          dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Train :func:`build_workflow`'s ``wf`` on ``device`` (default: the
    card), evaluate AuPR and the Brier score over ``store``. Returns
    ``model``, ``store``, ``workflow`` (``wf``), ``summary``,
    ``metrics``, ``bin_score``, ``width`` (the columns the SanityChecker
    keeps) and the seconds ``train_s``, ``eval_s`` (one scoring pass
    serves both evaluators)."""
    t1 = time.perf_counter()
    model = wf["workflow"].train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t1
    ev = Evaluators.BinaryClassification.auPR().set_columns(
        wf["label"], wf["prediction"])
    t2 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(store, ev, device=device)
    eval_s = time.perf_counter() - t2
    label, pred = wf["label"].name, wf["prediction"].name
    bins = Evaluators.BinScore().set_columns(label, pred).evaluate_all(
        ColumnStore({label: store[label], pred: scored[pred]},
                    store.n_rows))
    checker = model.fitted_stages[wf["checked"].origin_stage.uid]
    return {"model": model, "store": store, "workflow": wf,
            "summary": model.fitted_stages[
                wf["selector"].uid].selector_summary,
            "metrics": metrics, "bin_score": bins,
            "width": len(checker.keep_indices),
            "train_s": train_s, "eval_s": eval_s}


def run(raw: Dict[str, tuple], device=None, families=None,
        dtype: torch.dtype = torch.float32, num_folds: int = 3
        ) -> Dict[str, Any]:
    """:func:`train` of the workflow over ``raw``; ``store_s`` beside its
    results is the seconds the store took to build."""
    t0 = time.perf_counter()
    store = raw_store(raw)
    store_s = time.perf_counter() - t0
    out = train(store, build_workflow(store, families, num_folds),
                device=device, dtype=dtype)
    out["store_s"] = store_s
    return out


# ---------------------------------------------------------------------------
# The taggers path: entities, languages, sentences and parts of speech
# ---------------------------------------------------------------------------

_FIRST = ("james", "mary", "john", "patricia", "robert", "jennifer",
          "michael", "linda", "david", "susan")
_LAST = ("smith", "johnson", "williams", "brown", "jones", "garcia",
         "miller", "davis")
_ORG = ("acme corp", "globex inc", "initech ltd", "hooli labs",
        "umbrella group", "vandelay industries")
_LOC = ("london", "paris", "tokyo", "berlin", "madrid", "rome")
_VERBS = ("met", "called", "visited", "emailed", "thanked")
_TAIL = ("about the contract", "on monday", "for the new project",
         "to review the budget", "after the launch")
_SPANISH = "el equipo de la empresa y los clientes en la ciudad"


def _title(s: str) -> str:
    return " ".join(w.capitalize() for w in s.split())


def make_tagger_raw(n: int = 2000, seed: int = 17) -> Dict[str, tuple]:
    """``n`` notes of about 20 tokens in two sentences: a person meets a
    person or an organization in a city; some notes end in Spanish. The
    label leans on an organization being named and on the city."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, len(_FIRST), (n, 2))
    la = rng.integers(0, len(_LAST), (n, 2))
    org = rng.integers(0, len(_ORG), n)
    loc = rng.integers(0, len(_LOC), n)
    verb = rng.integers(0, len(_VERBS), n)
    tail = rng.integers(0, len(_TAIL), n)
    with_org = rng.random(n) < 0.5
    spanish = rng.random(n) < 0.15
    notes = []
    for i in range(n):
        who = f"{_title(_FIRST[f[i, 0]])} {_title(_LAST[la[i, 0]])}"
        whom = (_title(_ORG[org[i]]) if with_org[i] else
                f"{_title(_FIRST[f[i, 1]])} {_title(_LAST[la[i, 1]])}")
        text = (f"{who} {_VERBS[verb[i]]} {whom} in {_title(_LOC[loc[i]])} "
                f"{_TAIL[tail[i]]}. The team will follow up next week.")
        if spanish[i]:
            text += f" {_SPANISH.capitalize()}."
        notes.append(text)
    z = 1.5 * with_org + 0.8 * (loc < 2) + rng.normal(0.0, 1.0, n) - 1.1
    return {"note": ("Text", notes),
            "label": ("RealNN", (z > 0).astype(float).tolist())}


def build_tagger_workflow(store: ColumnStore, families=None,
                          num_folds: int = 3, seed: int = 17
                          ) -> Dict[str, Any]:
    """Entities, languages, sentences and POS tags of the note,
    transmogrified, into a selector (one LR point unless ``families``)."""
    label = FB.RealNN("label").from_column().as_response()
    note = FB.Text("note").from_column().as_predictor()
    d = {"entities": note.recognize_entities(),
         "languages": note.detect_languages(),
         "sentences": note.transform_with(OpSentenceSplitter()),
         "pos": note.transform_with(OpPOSTagger())}
    features = transmogrify(list(d.values()))
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, seed=seed,
        families=families if families is not None
        else one_point_families()[:1])
    pred = label.transform_with(selector, features)
    wf = Workflow().set_input_store(store).set_result_features(pred)
    return {"workflow": wf, "selector": selector, "label": label,
            "prediction": pred, "features": features, "stages": d}


def run_taggers(raw: Dict[str, tuple], device=None, families=None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Train the taggers workflow on ``device``; ``metrics`` is the
    selector's evaluation of the refit model over the training rows (the
    taggers run once)."""
    store = raw_store(raw)
    wf = build_tagger_workflow(store, families)
    t1 = time.perf_counter()
    model = wf["workflow"].train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t1
    summary = model.fitted_stages[wf["selector"].uid].selector_summary
    return {"model": model, "store": store, "workflow": wf,
            "summary": summary, "metrics": summary.train_evaluation,
            "train_s": train_s}
