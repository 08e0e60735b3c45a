"""The BigPassenger workflow of ``examples/big_passenger.py``, for the port:
typed raw features (numeric, categorical, free text, date) →
``transmogrify`` → ``sanity_check(remove_bad_features=True)`` → binary
model selection with k-fold CV on AuPR → refit → evaluate, on the same
numpy-seeded records (``synthesize_records``).

The free-text ``description`` column exceeds the SmartTextVectorizer's
cardinality cap, so it is hashed into 512 buckets; with the one-hot and
null-indicator slots most of the vector is 0/1 columns, which the tree
engine histograms in its 2-bin ``cumhist_sparse01`` block.

Usage::

    from transmogrifai_tpu_torch.big_passenger import run
    out = run(200_000)                                   # on the card
    out = run(3_000, device="cpu", dtype=torch.float64)  # on the CPU
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .dsl import transmogrify
from .evaluators import Evaluators
from .features import FeatureBuilder
from .models import BinaryClassificationModelSelector, DataBalancer
from .ops.sanity_checker import SanityChecker
from .ops.vectorizer_base import VectorizerEstimator, VectorizerModel
from .ops.vectors import VectorsCombiner
from .synthetic_trees import default_families
from .workflow import Workflow

__all__ = ["synthesize_records", "build_features", "build_selection", "run"]

_WORDS = ("travel cabin sea ocean deck luxury family crew storm rescue "
          "ticket meal night morning harbor voyage captain steward porter "
          "engine coal first second third class suite promenade").split()


def synthesize_records(n: int, seed: int = 7) -> List[Dict[str, Any]]:
    """The example's record stream: the same numpy draws in the same order
    (``examples/big_passenger.synthesize_records``); the label is a
    deterministic rule over the "rescue" token, gender and height."""
    rng = np.random.default_rng(seed)
    genders = ("Male", "Female")
    g_idx = rng.integers(0, 2, n)
    heights = rng.normal(170, 12, n)
    weights = rng.normal(70, 15, n)
    ages = rng.integers(1, 90, n)
    n_words = rng.integers(3, 12, n)
    word_idx = rng.integers(0, len(_WORDS), (n, 12))
    recs = []
    for i in range(n):
        words = [_WORDS[j] for j in word_idx[i, :n_words[i]]]
        score = (2.0 * ("rescue" in words) + 1.0 * (g_idx[i] == 1)
                 + 0.02 * (heights[i] - 170.0))
        recs.append({
            "age": float(ages[i]) if rng.random() > 0.05 else None,
            "gender": genders[g_idx[i]],
            "height": float(heights[i]),
            "weight": float(weights[i]),
            "description": " ".join(words) + f" voyage{i % 997}",
            "boarded": 1471046600 + int(rng.integers(0, 3_000_000)),
            "anotherFloat": float(rng.random()),
            "survived": 1.0 if score > 1.2 else 0.0,
        })
    return recs


def build_features():
    """(label, sanity-checked feature vector) of the example's DAG."""
    survived = FeatureBuilder.RealNN("survived").from_column().as_response()
    age = FeatureBuilder.Real("age").from_column().as_predictor()
    gender = FeatureBuilder.PickList("gender").from_column().as_predictor()
    height = FeatureBuilder.Real("height").from_column().as_predictor()
    weight = FeatureBuilder.Real("weight").from_column().as_predictor()
    description = FeatureBuilder.Text("description").from_column() \
        .as_predictor()
    boarded = FeatureBuilder.Date("boarded").from_column().as_predictor()
    another = FeatureBuilder.Real("anotherFloat").from_column() \
        .as_predictor()
    features = transmogrify([age, gender, height, weight, description,
                             boarded, another])
    checked = survived.sanity_check(features, remove_bad_features=True)
    return survived, checked


def build_selection(families=None, num_folds: int = 3, seed: int = 42):
    """(label, checked vector, selector, prediction) of the example's
    workflow: the selector sweeps ``families`` (default: GBT and XGBoost
    maxDepth {3, 6}, 20 rounds) with k-fold CV on AuPR behind a
    DataBalancer."""
    if families is None:
        families = default_families((3, 6), (3, 6))
    survived, checked = build_features()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, validation_metric="AuPR", families=families,
        splitter=DataBalancer(sample_fraction=0.1,
                              reserve_test_fraction=0.1, seed=seed),
        seed=seed)
    return (survived, checked, selector,
            survived.transform_with(selector, checked))


def run(n_rows: int = 30_000, num_folds: int = 3, families=None,
        seed: int = 42, device=None, dtype: torch.dtype = torch.float32,
        records: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Train the :func:`build_selection` workflow on ``device`` over
    ``records`` (default: ``n_rows`` synthesized ones), then evaluate AuPR
    over all of them. Returns the model, metrics, summary, the records and
    evaluator, the width of
    each histogram block and phase seconds: ``records_s`` (synthesis),
    ``vectorize_s``, ``sanity_s`` and ``selector_s`` (parts of
    ``train_s``), ``eval_s``."""
    survived, checked, selector, prediction = build_selection(
        families, num_folds, seed)

    t0 = time.perf_counter()
    if records is None:
        records = synthesize_records(n_rows, seed=seed)
    records_s = time.perf_counter() - t0
    wf = (Workflow().set_input_records(records)
          .set_result_features(prediction).set_splitter(selector.splitter))
    t1 = time.perf_counter()
    model = wf.train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t1

    t2 = time.perf_counter()
    evaluator = Evaluators.BinaryClassification.auPR().set_columns(
        survived, prediction)
    scored, metrics = model.score_and_evaluate(records, evaluator,
                                               device=device)
    eval_s = time.perf_counter() - t2

    stages = {s.uid: s for layer in model.dag for s in layer}
    phase = {"vectorize_s": 0.0, "sanity_s": 0.0, "selector_s": 0.0}
    for uid, sec in model.stage_seconds.items():
        st = stages.get(uid)
        if isinstance(st, (VectorizerEstimator, VectorizerModel,
                           VectorsCombiner)):
            phase["vectorize_s"] += sec
        elif isinstance(st, SanityChecker):
            phase["sanity_s"] += sec
        elif uid == selector.uid:
            phase["selector_s"] += sec
    sanity = model.fitted_stages[checked.origin_stage.uid]
    bmask = selector.families[0].binary_mask
    n_bin = 0 if bmask is None else int(np.sum(bmask))
    return {"model": model, "metrics": metrics, "scored": scored,
            "prediction": prediction, "label": survived,
            "data": records, "evaluator": evaluator,
            "summary": model.fitted_stages[selector.uid].selector_summary,
            "sanity": sanity,
            "blocks": {"continuous": len(sanity.keep_indices) - n_bin,
                       "binary": n_bin},
            "records_s": records_s, "train_s": train_s, "eval_s": eval_s,
            "extract_s": train_s - model.train_time_s, **phase}
