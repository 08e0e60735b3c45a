"""Boston housing regression — the port of ``examples/boston.py``, the
reference's ``OpBoston`` (``helloworld/.../boston/OpBoston.scala``), on
the card.

Thirteen numeric predictors through ``transmogrify``,
``RegressionModelSelector`` with a ``DataSplitter`` (10% holdout) and
3-fold CV on RMSE over the random-forest and GBT regressors (the
reference's ``modelTypesToUse``), refit, then the regression metrics over
the whole file. ``housing.data`` is whitespace-delimited; the loader turns
its lines into records on the host (the reference's CustomReader).

:func:`generate_data` writes data in that format, the 14 columns of
:data:`BOSTON_SCHEMA` within the published ranges: ``chas`` 0/1 with
about 7% ones, ``rad`` an integer in {1, …, 8, 24} at the published
file's frequencies, ``zn`` 0 in 73.5% of rows, the other columns
continuous (``crim`` log-normal, ``nox``, ``rm`` and ``lstat`` normal,
``dis`` log-normal, ``age`` and ``b`` skewed to their tops), each clipped
to its published range. The target is a fixed nonlinear function of
``rm``, ``lstat``, ``crim``, ``nox`` and ``dis`` plus noise, clipped to
[5, 50] as the published target is::

    medv = 12 + 30·exp(−lstat / 10) + 5·(rm − 6.3) + 4·max(rm − 7, 0)²
           − 10·(nox − 0.55) − 1.2·log(1 + crim) + 0.6·min(dis, 6) + ε,
    ε ~ N(0, 2.5²)

Usage::

    from transmogrifai_tpu_torch import boston
    path = boston.generate_data("build/data/housing.data", 2_000, seed=42)
    out = boston.run(path)                                 # on the card
    out = boston.run(path, device="cpu", dtype=torch.float64)
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .dsl import transmogrify
from .evaluators import Evaluators
from .features import FeatureBuilder
from .models import DataSplitter, RegressionModelSelector
from .workflow import Workflow

__all__ = ["BOSTON_SCHEMA", "generate_data", "load_records",
           "build_features", "build_workflow", "run"]

BOSTON_SCHEMA = ["crim", "zn", "indus", "chas", "nox", "rm", "age", "dis",
                 "rad", "tax", "ptratio", "b", "lstat", "medv"]
#: published (min, max) of each column of housing.data
RANGES = {"crim": (0.00632, 88.9762), "zn": (0.0, 100.0),
          "indus": (0.46, 27.74), "nox": (0.385, 0.871),
          "rm": (3.561, 8.78), "age": (2.9, 100.0), "dis": (1.1296, 12.1265),
          "tax": (187.0, 711.0), "ptratio": (12.6, 22.0), "b": (0.32, 396.9),
          "lstat": (1.73, 37.97), "medv": (5.0, 50.0)}
#: rad's values and their counts in the published 506 rows
RAD_COUNTS = {1: 20, 2: 24, 3: 38, 4: 110, 5: 115, 6: 26, 7: 17, 8: 24,
              24: 132}
_ZN_NONZERO = (12.5, 17.5, 20.0, 22.0, 25.0, 28.0, 30.0, 33.0, 34.0, 35.0,
               40.0, 45.0, 52.5, 55.0, 60.0, 70.0, 75.0, 80.0, 82.5, 85.0,
               90.0, 95.0, 100.0)
#: column formats of housing.data
_FORMATS = ("%8.5f", "%6.2f", "%6.2f", "%2d", "%7.4f", "%7.4f", "%6.2f",
            "%8.4f", "%3d", "%6.1f", "%6.2f", "%7.2f", "%6.2f", "%6.2f")


def _clip(name: str, v: np.ndarray) -> np.ndarray:
    lo, hi = RANGES[name]
    return np.clip(v, lo, hi)


def generate_data(path: str, n_rows: int, seed: int = 42) -> str:
    """Write ``n_rows`` generated rows in ``housing.data``'s format to
    ``path`` (``numpy.random.default_rng(seed)``); returns ``path``."""
    rng = np.random.default_rng(seed)
    n = n_rows
    c = {}
    c["crim"] = _clip("crim", np.exp(rng.normal(-1.2, 2.0, n)))
    c["zn"] = np.where(rng.random(n) < 0.735, 0.0,
                       rng.choice(_ZN_NONZERO, n))
    c["indus"] = rng.uniform(*RANGES["indus"], n)
    c["chas"] = (rng.random(n) < 0.07).astype(np.float64)
    c["nox"] = _clip("nox", rng.normal(0.555, 0.116, n))
    c["rm"] = _clip("rm", rng.normal(6.285, 0.703, n))
    c["age"] = _clip("age", 100.0 - rng.exponential(30.0, n))
    c["dis"] = _clip("dis", np.exp(rng.normal(1.2, 0.5, n)))
    rad_v = np.asarray(list(RAD_COUNTS), dtype=np.float64)
    rad_p = np.asarray(list(RAD_COUNTS.values()), dtype=np.float64)
    c["rad"] = rng.choice(rad_v, n, p=rad_p / rad_p.sum())
    c["tax"] = np.round(rng.uniform(*RANGES["tax"], n))
    c["ptratio"] = rng.uniform(*RANGES["ptratio"], n)
    c["b"] = _clip("b", 396.9 - rng.exponential(20.0, n))
    c["lstat"] = _clip("lstat", 12.6 - 5.0 * (c["rm"] - 6.285)
                       + rng.normal(0.0, 5.5, n))
    medv = (12.0 + 30.0 * np.exp(-c["lstat"] / 10.0)
            + 5.0 * (c["rm"] - 6.3)
            + 4.0 * np.maximum(c["rm"] - 7.0, 0.0) ** 2
            - 10.0 * (c["nox"] - 0.55) - 1.2 * np.log1p(c["crim"])
            + 0.6 * np.minimum(c["dis"], 6.0) + rng.normal(0.0, 2.5, n))
    c["medv"] = _clip("medv", medv)
    cols = [np.char.mod(fmt, c[name]) for name, fmt in
            zip(BOSTON_SCHEMA, _FORMATS)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.writelines(" ".join(row) + "\n" for row in zip(*cols))
    return path


def load_records(path: str) -> List[Dict[str, float]]:
    """housing.data's lines → record dicts (lines of another width are
    skipped), as ``examples/boston.load_records``."""
    records = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) != len(BOSTON_SCHEMA):
                continue
            records.append({k: float(v) for k, v in zip(BOSTON_SCHEMA,
                                                         parts)})
    return records


def build_features():
    """(medv, the transmogrified vector), as
    ``examples/boston.build_features``."""
    medv = FeatureBuilder.RealNN("medv").from_column().as_response()
    nums = [FeatureBuilder.Real(n).from_column().as_predictor()
            for n in BOSTON_SCHEMA[:13]]
    return medv, transmogrify(nums)


def build_workflow(records, num_folds: int = 3, families=None,
                   seed: int = 42) -> Dict[str, Any]:
    """The untrained workflow of :func:`run` over ``records``:
    ``{"workflow", "selector", "medv", "prediction"}``."""
    from .models.trees import GBTFamily, RandomForestFamily
    medv, features = build_features()
    if families is None:
        families = [RandomForestFamily(task="regression"),
                    GBTFamily(task="regression")]
    selector = RegressionModelSelector.with_cross_validation(
        num_folds=num_folds, families=families,
        splitter=DataSplitter(reserve_test_fraction=0.1, seed=seed),
        seed=seed)
    prediction = medv.transform_with(selector, features)
    wf = (Workflow().set_input_records(records)
          .set_result_features(prediction)
          .set_splitter(selector.splitter))
    return {"workflow": wf, "selector": selector, "medv": medv,
            "prediction": prediction}


def run(data_path: str, num_folds: int = 3, families=None, seed: int = 42,
        device=None, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Load ``data_path``, train the selection on ``device`` (default: the
    card; None ``families``: the RF and GBT regressors), then evaluate over
    the whole file. Returns the model, metrics, summary and seconds."""
    records = load_records(data_path)
    wf = build_workflow(records, num_folds, families, seed)
    prediction = wf["prediction"]
    t0 = time.perf_counter()
    model = wf["workflow"].train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t0
    evaluator = Evaluators.Regression().set_columns(wf["medv"], prediction)
    t1 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(records, evaluator,
                                               device=device)
    eval_s = time.perf_counter() - t1
    summary = model.fitted_stages[wf["selector"].uid].selector_summary
    return {"model": model, "metrics": metrics, "scored": scored,
            "data": records, "evaluator": evaluator,
            "prediction": prediction, "summary": summary,
            "train_s": train_s, "eval_s": eval_s, "n_rows": len(records),
            "family_seconds": summary.validator_summary.family_seconds}
