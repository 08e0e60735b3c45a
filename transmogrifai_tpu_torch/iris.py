"""Iris multiclass — the port of ``examples/iris.py``, the reference's
``OpIris`` (``helloworld/.../iris/OpIris.scala``), on the card.

Four numeric predictors through ``transmogrify`` (each value and its null
indicator, F = 8), the species label indexed (``irisClass.indexed()``,
``OpStringIndexerNoFilter``), ``MultiClassificationModelSelector`` with a
``DataCutter`` (20% holdout) and 3-fold CV on F1 over the default
families (logistic regression, naive Bayes, random forest, decision
tree), refit, then F1 over the whole file and the predicted indices
de-indexed back to species names (``PredictionDeIndexer``).

:func:`generate_csv` writes data in the published file's format
(``bezdekIris.data``: no header;
``sepalLength,sepalWidth,petalLength,petalWidth,irisClass``, one decimal),
the classes ``Iris-setosa``, ``Iris-versicolor`` and ``Iris-virginica``
in equal thirds, each feature of each class Gaussian with Fisher's
published per-class mean and standard deviation (cm):

============  =============  =============  =============  =============
class         sepalLength    sepalWidth     petalLength    petalWidth
============  =============  =============  =============  =============
setosa        5.006 ± 0.352  3.428 ± 0.379  1.462 ± 0.174  0.246 ± 0.105
versicolor    5.936 ± 0.516  2.770 ± 0.314  4.260 ± 0.470  1.326 ± 0.198
virginica     6.588 ± 0.636  2.974 ± 0.322  5.552 ± 0.552  2.026 ± 0.275
============  =============  =============  =============  =============

Values are clipped at 0.1 and rounded to one decimal; 1% of the numeric
fields are left blank, so the null-indicator columns carry nonzeros into
the trees' 2-bin block.

Usage::

    from transmogrifai_tpu_torch import iris
    path = iris.generate_csv("build/data/iris.data", 2_000, seed=42)
    out = iris.run(path)                                   # on the card
    out = iris.run(path, device="cpu", dtype=torch.float64)
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .dsl import transmogrify
from .evaluators import Evaluators
from .features import FeatureBuilder
from .models import DataCutter, MultiClassificationModelSelector
from .ops.indexers import OpStringIndexerNoFilter, PredictionDeIndexer
from .readers import DataReaders
from .workflow import Workflow

__all__ = ["IRIS_SCHEMA", "IRIS_CLASSES", "FISHER_MEANS", "FISHER_STDS",
           "generate_csv", "build_features", "build_workflow", "run"]

IRIS_SCHEMA = ["sepalLength", "sepalWidth", "petalLength", "petalWidth",
               "irisClass"]
IRIS_CLASSES = ["Iris-setosa", "Iris-versicolor", "Iris-virginica"]
#: Fisher's per-class means and standard deviations, [class, feature]
FISHER_MEANS = np.array([[5.006, 3.428, 1.462, 0.246],
                         [5.936, 2.770, 4.260, 1.326],
                         [6.588, 2.974, 5.552, 2.026]])
FISHER_STDS = np.array([[0.352, 0.379, 0.174, 0.105],
                        [0.516, 0.314, 0.470, 0.198],
                        [0.636, 0.322, 0.552, 0.275]])
#: share of the numeric fields left blank
BLANK_SHARE = 0.01


def generate_csv(path: str, n_rows: int, seed: int = 42) -> str:
    """Write ``n_rows`` generated rows in ``bezdekIris.data``'s format to
    ``path`` (``numpy.random.default_rng(seed)``); returns ``path``."""
    rng = np.random.default_rng(seed)
    cls = rng.permutation(np.arange(n_rows) % 3)
    vals = FISHER_MEANS[cls] + FISHER_STDS[cls] * rng.normal(
        size=(n_rows, 4))
    vals = np.round(np.maximum(vals, 0.1), 1)
    blank = rng.random((n_rows, 4)) < BLANK_SHARE
    text = np.char.mod("%.1f", vals).astype(object)
    text[blank] = ""
    names = np.asarray(IRIS_CLASSES, dtype=object)[cls]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.writelines(f"{a},{b},{c},{d},{e}\n" for a, b, c, d, e in
                      zip(text[:, 0], text[:, 1], text[:, 2], text[:, 3],
                          names))
    return path


def _num(field):
    return lambda r: float(r[field]) if r.get(field) not in (None, "") \
        else None


def build_features():
    """(irisClass, its indices, the transmogrified vector), as
    ``examples/iris.build_features``."""
    iris_class = (FeatureBuilder.Text("irisClass")
                  .from_column().as_response())
    labels = iris_class.transform_with(OpStringIndexerNoFilter())
    nums = [FeatureBuilder.Real(n).extract(_num(n), n).as_predictor()
            for n in IRIS_SCHEMA[:4]]
    return iris_class, labels, transmogrify(nums)


def build_workflow(csv_path: str, num_folds: int = 3, families=None,
                   seed: int = 42) -> Dict[str, Any]:
    """The untrained workflow of :func:`run`: ``{"workflow", "selector",
    "labels", "prediction", "deindexed", "reader"}``."""
    _iris_class, labels, features = build_features()
    selector = MultiClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, families=families,
        splitter=DataCutter(reserve_test_fraction=0.2, seed=seed),
        seed=seed)
    prediction = labels.transform_with(selector, features)
    deindexed = labels.transform_with(PredictionDeIndexer(), prediction)
    reader = DataReaders.simple.csv(csv_path, IRIS_SCHEMA)
    wf = (Workflow().set_reader(reader)
          .set_result_features(prediction, deindexed)
          .set_splitter(selector.splitter))
    return {"workflow": wf, "selector": selector, "labels": labels,
            "prediction": prediction, "deindexed": deindexed,
            "reader": reader}


def run(csv_path: str, num_folds: int = 3, families=None, seed: int = 42,
        device=None, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Read ``csv_path``, train the selection on ``device`` (default: the
    card; None ``families``: the default four), then evaluate F1 over the
    whole file and de-index the predictions. Returns the model, metrics,
    summary, scored store, the predicted species names and seconds."""
    wf = build_workflow(csv_path, num_folds, families, seed)
    prediction, deindexed = wf["prediction"], wf["deindexed"]
    t0 = time.perf_counter()
    model = wf["workflow"].train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t0
    evaluator = Evaluators.MultiClassification.f1().set_columns(
        wf["labels"], prediction)
    store = wf["reader"].generate_store(prediction.raw_features())
    t1 = time.perf_counter()
    scored, metrics = model.score_and_evaluate(store, evaluator,
                                               device=device)
    eval_s = time.perf_counter() - t1
    summary = model.fitted_stages[wf["selector"].uid].selector_summary
    return {"model": model, "metrics": metrics, "scored": scored,
            "data": store, "evaluator": evaluator,
            "prediction": prediction, "deindexed": deindexed,
            "predicted_labels": scored[deindexed.name],
            "summary": summary, "train_s": train_s, "eval_s": eval_s,
            "n_rows": store.n_rows,
            "family_seconds": summary.validator_summary.family_seconds}
