"""Titanic survival — the port of ``examples/titanic.py``, the
reference's hello-world (``OpTitanicSimple.scala:77-130``), on the card.

The same raw and derived features (familySize, estimatedCostOfTickets,
pivotedSex, ageGroup, normedAge), ``transmogrify`` → ``sanity_check`` →
``BinaryClassificationModelSelector`` 3-fold CV on AuPR over the default
families (logistic regression, random forest, GBT, linear SVC), refit,
then AuPR over the whole file. The data is the bundled
``tests/resources/PassengerDataAll.csv`` (891 rows, no header line).

Usage::

    from transmogrifai_tpu_torch.titanic import run
    out = run()                                   # on the card
    out = run(device="cpu", dtype=torch.float64)  # on the CPU
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict

import torch

from .dsl import transmogrify
from .evaluators import Evaluators
from .features import FeatureBuilder
from .models import BinaryClassificationModelSelector, DataBalancer
from .readers import DataReaders
from .types import feature_types as ft
from .workflow import Workflow

__all__ = ["TITANIC_SCHEMA", "BUNDLED_CSV", "build_features", "run"]

TITANIC_SCHEMA = ["id", "survived", "pClass", "name", "sex", "age", "sibSp",
                  "parCh", "ticket", "fare", "cabin", "embarked"]
BUNDLED_CSV = str(Path(__file__).resolve().parents[1] / "tests"
                  / "resources" / "PassengerDataAll.csv")


def _num(field):
    return lambda r: float(r[field]) if r.get(field) not in (None, "") \
        else None


def _age_group(v):
    return ("adult" if v > 18 else "child") if v is not None else None


def build_features(with_sanity_check: bool = True):
    """Raw + derived features, as ``examples/titanic.build_features``."""
    survived = (FeatureBuilder.RealNN("survived")
                .extract(_num("survived"), "survived").as_response())
    p_class = FeatureBuilder.PickList("pClass").from_column().as_predictor()
    name = FeatureBuilder.Text("name").from_column().as_predictor()
    sex = FeatureBuilder.PickList("sex").from_column().as_predictor()
    age = FeatureBuilder.Real("age").extract(_num("age"), "age").as_predictor()
    sib_sp = (FeatureBuilder.Integral("sibSp")
              .extract(_num("sibSp"), "sibSp").as_predictor())
    par_ch = (FeatureBuilder.Integral("parCh")
              .extract(_num("parCh"), "parCh").as_predictor())
    ticket = FeatureBuilder.PickList("ticket").from_column().as_predictor()
    fare = (FeatureBuilder.Real("fare")
            .extract(_num("fare"), "fare").as_predictor())
    cabin = FeatureBuilder.PickList("cabin").from_column().as_predictor()
    embarked = FeatureBuilder.PickList("embarked").from_column().as_predictor()

    # derived features (OpTitanicSimple.scala:118-124)
    family_size = sib_sp + par_ch + 1
    estimated_cost = family_size * fare
    pivoted_sex = sex.pivot()
    normed_age = age.fill_missing_with_mean().z_normalize()
    age_group = age.map_to(_age_group, ft.PickList, "ageGroup")

    passenger_features = transmogrify([
        p_class, name, age, sib_sp, par_ch, ticket, cabin, embarked,
        family_size, estimated_cost, pivoted_sex, age_group, normed_age,
    ])
    if with_sanity_check:
        checked = survived.sanity_check(passenger_features,
                                        remove_bad_features=True)
    else:
        checked = passenger_features
    return survived, checked


def run(csv_path: str = BUNDLED_CSV, num_folds: int = 3, families=None,
        seed: int = 42, device=None, dtype: torch.dtype = torch.float32,
        with_sanity_check: bool = True) -> Dict[str, Any]:
    """Read, train the selection on ``device`` (default: the card; None
    ``families``: the default four), then evaluate AuPR over the whole
    file. Returns the model, metrics, summary, scored store and seconds
    (``train_s``; ``family_seconds``: each family's CV sweep)."""
    survived, checked = build_features(with_sanity_check)
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, validation_metric="AuPR", families=families,
        splitter=DataBalancer(sample_fraction=0.1,
                              reserve_test_fraction=0.1, seed=seed),
        seed=seed)
    prediction = survived.transform_with(selector, checked)
    reader = DataReaders.simple.csv(csv_path, TITANIC_SCHEMA,
                                    key_fn=lambda r: r["id"])
    wf = (Workflow().set_reader(reader).set_result_features(prediction)
          .set_splitter(selector.splitter))
    t0 = time.perf_counter()
    model = wf.train(device=device, dtype=dtype)
    train_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    evaluator = Evaluators.BinaryClassification.auPR().set_columns(
        survived, prediction)
    store = reader.generate_store(prediction.raw_features())
    scored, metrics = model.score_and_evaluate(store, evaluator,
                                               device=device)
    eval_s = time.perf_counter() - t1
    summary = model.fitted_stages[selector.uid].selector_summary
    return {"model": model, "metrics": metrics, "scored": scored,
            "prediction": prediction, "summary": summary,
            "train_s": train_s, "eval_s": eval_s, "n_rows": store.n_rows,
            "family_seconds": summary.validator_summary.family_seconds}
