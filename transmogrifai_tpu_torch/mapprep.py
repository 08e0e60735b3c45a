"""Map-feature data prep — the port of ``examples/mapprep.py``, the
RichMapFeature DSL surface end to end, on the card.

A support-ticket churn dataset whose signal lives mostly in map-typed
columns: per-channel usage counts (a RealMap with a leaky
``internal_audit`` key), free-text attributes (a TextMap), the agent's
note (a TextList) and requested / owned feature sets (MultiPickLists).
The workflow blocks the leaky key and vectorizes the usage map
(``vectorize(block_keys=)``), smart-vectorizes the attribute map (its
low-cardinality keys pivot, its unique-per-row key hashes), buckets the
``phone`` key by a decision tree against the label (``extract_key`` +
``auto_bucketize``), takes the TF-IDF of the note without stop words and
the Jaccard overlap of the two sets, transmogrifies the five blocks into
one vector and selects a model by 3-fold CV on AuPR (logistic regression,
the example's family, unless ``families`` says otherwise).

Usage::

    from transmogrifai_tpu_torch import mapprep
    out = mapprep.run(200_000, seed=7)                      # on the card
    out = mapprep.run(800, seed=3, device="cpu", dtype=torch.float64)
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .columns import ColumnStore
from .dsl import transmogrify
from .evaluators import Evaluators
from .features import FeatureBuilder
from .models import BinaryClassificationModelSelector, LogisticRegressionFamily
from .types import feature_types as ft
from .workflow import Workflow

__all__ = ["make_records", "records_store", "build_workflow", "run",
           "BLOCKED_KEY"]

#: the usage map's leaky key, blocked from the vector
BLOCKED_KEY = "internal_audit"

#: rows of the store whose layer transform gives the combined vector's
#: metadata in :func:`run`
_META_ROWS = 256


def make_records(n: int = 4000, seed: int = 7) -> List[Dict[str, Any]]:
    """``n`` support-ticket records from ``numpy.random.default_rng(seed)``:
    the same records as ``examples/mapprep.make_records``."""
    rng = np.random.default_rng(seed)
    channels = ["email", "phone", "chat"]
    plans = ["free", "pro", "enterprise"]
    recs = []
    for i in range(n):
        usage = {c: float(rng.poisson(3)) for c in channels
                 if rng.random() > 0.2}
        usage[BLOCKED_KEY] = float(i)
        attrs = {"plan": plans[int(rng.integers(0, 3))],
                 "agent_note": f"case {rng.integers(0, 10_000)} opened"}
        if rng.random() > 0.5:
            attrs["region"] = ["emea", "amer", "apac"][
                int(rng.integers(0, 3))]
        churn = float((usage.get("phone", 0) > 4)
                      or (attrs["plan"] == "free" and rng.random() < 0.4))
        # churners complain: their notes carry cancel-flavoured terms
        terms = (["cancel", "refund", "slow"] if churn and rng.random() < .8
                 else ["thanks", "great", "question"])
        note = ["the", "customer", "said"] + [
            str(rng.choice(terms)) for _ in range(3)]
        wants = {str(rng.choice(["api", "sso", "export", "audit"]))
                 for _ in range(int(rng.integers(1, 3)))}
        has = {str(rng.choice(["api", "sso", "export"]))
               for _ in range(int(rng.integers(1, 3)))}
        recs.append({"usage": usage, "attrs": attrs, "churned": churn,
                     "note": note, "wants": wants, "has": has})
    return recs


def records_store(recs: List[Dict[str, Any]]) -> ColumnStore:
    """The raw columns of ``recs``, as the example builds them."""
    return ColumnStore.from_dict({
        "usage": (ft.RealMap, [r["usage"] for r in recs]),
        "attrs": (ft.TextMap, [r["attrs"] for r in recs]),
        "churned": (ft.RealNN, [r["churned"] for r in recs]),
        "note": (ft.TextList, [r["note"] for r in recs]),
        "wants": (ft.MultiPickList, [r["wants"] for r in recs]),
        "has": (ft.MultiPickList, [r["has"] for r in recs]),
    })


def build_workflow(store: ColumnStore, families=None,
                   seed: int = 7) -> Dict[str, Any]:
    """The untrained workflow over ``store``: ``{"workflow", "selector",
    "label", "prediction", "features", "usage_vec"}``."""
    churned = FeatureBuilder.RealNN("churned").from_column().as_response()
    usage = FeatureBuilder.RealMap("usage").from_column().as_predictor()
    attrs = FeatureBuilder.TextMap("attrs").from_column().as_predictor()
    note = FeatureBuilder.TextList("note").from_column().as_predictor()
    wants = FeatureBuilder.MultiPickList("wants").from_column().as_predictor()
    has = FeatureBuilder.MultiPickList("has").from_column().as_predictor()

    usage_vec = usage.vectorize(block_keys=[BLOCKED_KEY])
    attrs_vec = attrs.smart_vectorize(max_cardinality=10, num_features=64)
    phone_buckets = usage.extract_key("phone").auto_bucketize(churned)
    note_vec = note.remove_stop_words().tfidf(num_terms=32)
    fit_score = wants.jaccard_similarity(has)

    features = transmogrify([usage_vec, attrs_vec, phone_buckets,
                             note_vec, fit_score])
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3,
        families=families if families is not None
        else [LogisticRegressionFamily()], seed=seed)
    pred = churned.transform_with(selector, features)
    wf = Workflow().set_input_store(store).set_result_features(pred)
    return {"workflow": wf, "selector": selector, "label": churned,
            "prediction": pred, "features": features,
            "usage_vec": usage_vec}


def run(n: int = 4000, seed: int = 7, device=None, families=None,
        records: Optional[List[Dict[str, Any]]] = None,
        dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Train on ``device`` (default: the card) over ``records`` (default:
    ``make_records(n, seed)``), then evaluate AuPR over all of them.

    Returns what ``examples/mapprep.run`` returns — ``model``,
    ``metrics``, ``blocked_cols`` (vector columns of the blocked key:
    none) and ``summary`` — and ``store``, ``evaluator``, ``prediction``,
    ``features``, ``vector_meta`` (the combined vector's metadata),
    ``width`` and the seconds: ``records_s`` (generation), ``vectorize_s``
    and ``selector_s`` (parts of ``train_s``), ``eval_s``."""
    t0 = time.perf_counter()
    if records is None:
        records = make_records(n, seed)
    store = records_store(records)
    records_s = time.perf_counter() - t0
    wf = build_workflow(store, families, seed)
    selector = wf["selector"]

    t1 = time.perf_counter()
    model = wf["workflow"].train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t1
    selector_s = model.stage_seconds.get(selector.uid, 0.0)
    vectorize_s = sum(model.stage_seconds.values()) - selector_s

    evaluator = Evaluators.BinaryClassification.auPR().set_columns(
        wf["label"], wf["prediction"])
    t2 = time.perf_counter()
    metrics = model.evaluate(store, evaluator, device=device)
    eval_s = time.perf_counter() - t2

    head = store.take(np.arange(min(_META_ROWS, store.n_rows)))
    vector_meta = model.transform(head, device=device, engine=False)[
        wf["features"].name].metadata
    usage_meta = model.fitted_stages[
        wf["usage_vec"].origin_stage.uid].vector_metadata()
    blocked = [c for c in usage_meta.columns if c.grouping == BLOCKED_KEY]
    return {"model": model, "metrics": metrics, "blocked_cols": blocked,
            "summary": model.fitted_stages[selector.uid].selector_summary,
            "store": store, "evaluator": evaluator,
            "prediction": wf["prediction"], "features": wf["features"],
            "vector_meta": vector_meta, "width": vector_meta.size,
            "records_s": records_s, "train_s": train_s,
            "vectorize_s": vectorize_s, "selector_s": selector_s,
            "eval_s": eval_s}
