"""The synthetic tree-grid sweep of ``examples/synthetic_trees.py``, for
the port: the same numpy-seeded data (``synthesize_store``) and the same
GBT + XGBoost k-fold CV selection through ``Workflow.train``; or, with
``forest_families()``, a random forest and a decision tree.

Usage::

    from transmogrifai_tpu_torch.synthetic_trees import run
    out = run(200_000)                      # on the card
    out = run(20_000, device="cpu")         # on the CPU
"""
from __future__ import annotations

import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from .columns import ColumnStore, VectorColumn, column_from_values
from .evaluators import Evaluators
from .features import FeatureBuilder
from .models import (BinaryClassificationModelSelector, DataBalancer,
                     DecisionTreeFamily, GBTFamily, RandomForestFamily,
                     XGBoostFamily)
from .types import feature_types as ft
from .workflow import Workflow

__all__ = ["synthesize_store", "default_families", "forest_families",
           "run"]


def synthesize_store(n_rows: int, n_features: int = 20,
                     seed: int = 11) -> ColumnStore:
    """Gaussian features and an axis-aligned-interaction binary label —
    the same numpy stream as ``examples/synthetic_trees.synthesize_store``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    logits = (1.5 * (X[:, 0] > 0.3) * (X[:, 1] < 0.0)
              + 1.0 * (X[:, 2] > 1.0)
              - 1.2 * (X[:, 3] < -0.5)
              + 0.3 * rng.normal(size=n_rows))
    y = (logits > 0.4).astype(np.float64)
    return ColumnStore({
        "label": column_from_values(ft.RealNN, y),
        "features": VectorColumn(ft.OPVector, X),
    })


def default_families(gbt_depths: Sequence[int] = (3, 6, 9),
                     xgb_depths: Sequence[int] = (3, 6), rounds: int = 20):
    """The example's GBT and XGBoost grids (eta 0.3 for XGBoost)."""
    return [
        GBTFamily(grid=[{"maxDepth": d, "minInstancesPerNode": 10,
                         "minInfoGain": 0.001, "maxIter": rounds}
                        for d in gbt_depths], max_iter=rounds),
        XGBoostFamily(grid=[{"maxDepth": d, "numRound": rounds, "eta": 0.3,
                             "minChildWeight": 1.0} for d in xgb_depths]),
    ]


def forest_families(depths: Sequence[int] = (3, 6, 12), num_trees: int = 50,
                    min_instances: int = 10, min_info_gain: float = 0.001):
    """A random forest (``num_trees`` trees, per-node draws of round(√F)
    candidate features, no subsampling) and a decision tree over the
    same maxDepth grid: the rf-200k configuration at the defaults."""
    grid = [{"maxDepth": d, "minInstancesPerNode": min_instances,
             "minInfoGain": min_info_gain, "subsamplingRate": 1.0}
            for d in depths]
    return [RandomForestFamily(grid=grid, num_trees=num_trees),
            DecisionTreeFamily(grid=[dict(g) for g in grid])]


def run(n_rows: int, num_folds: int = 5, families=None, seed: int = 42,
        device=None, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Train the CV selection on ``device``, then evaluate AuPR over the
    whole store. Returns the model, metrics, summary and phase seconds."""
    families = default_families() if families is None else families
    label = FeatureBuilder.RealNN("label").from_column().as_response()
    feats = FeatureBuilder.OPVector("features").from_column().as_predictor()
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, validation_metric="AuPR", families=families,
        splitter=DataBalancer(sample_fraction=0.1,
                              reserve_test_fraction=0.1, seed=seed),
        seed=seed)
    prediction = label.transform_with(selector, feats)
    store = synthesize_store(n_rows)
    wf = (Workflow().set_input_store(store)
          .set_result_features(prediction).set_splitter(selector.splitter))
    t0 = time.perf_counter()
    model = wf.train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    evaluator = Evaluators.BinaryClassification.auPR().set_columns(
        label, prediction)
    scored, metrics = model.score_and_evaluate(store, evaluator,
                                               device=device)
    eval_s = time.perf_counter() - t1
    return {"model": model, "metrics": metrics, "scored": scored,
            "prediction": prediction,
            "summary": model.fitted_stages[selector.uid].selector_summary,
            "train_s": train_s, "eval_s": eval_s}
