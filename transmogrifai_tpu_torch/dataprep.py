"""Event-time data prep — the port of ``examples/dataprep.py``, the
reference's dataprep and conditional-aggregation walkthrough
(``docs/examples/Conditional-Aggregation.md``,
``helloworld/.../dataprep``), and the same composition at the size of a
real event log, trained on the card.

The walkthrough: visit-log records aggregate per user with a per-key
cutoff fixed by an event predicate ("first purchase"). Predictor features
fold the events before each user's cutoff through their type's monoid
aggregators, the response folds the events after it: the reader enforces
the leak barrier, not the modeler.

The event log (``make_event_log``, ``build_workflow``): the JAX package's
event-log workload (``bench.py``'s ``_event_log``) — transactions keyed by
user, joined to a users dimension table and aggregated against a fixed
cutoff through ``JoinedAggregateDataReader`` with ``temporal.field``
extractors, so the join and the aggregation stay columnar
(``temporal.py``) — then ``transmogrify`` → ``sanity_check`` → the binary
selector over the default families (logistic regression, random forest,
GBT, linear SVC) at one grid point each, 3-fold CV on AuPR.

Usage::

    from transmogrifai_tpu_torch import dataprep
    store, rows = dataprep.run()                     # the seven visits
    events, users = dataprep.make_event_log(200_000, 20, seed=47)
    wf = dataprep.build_workflow(events, users)
    model = wf["workflow"].train()                   # on the card
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import temporal
from .dsl import transmogrify
from .features import FeatureBuilder
from .models import (BinaryClassificationModelSelector, GBTFamily,
                     LinearSVCFamily, LogisticRegressionFamily,
                     RandomForestFamily)
from .readers import CutOffTime, DataReader, DataReaders
from .readers import JoinedAggregateDataReader
from .utils.aggregators import (LogicalOrAggregator, MaxAggregator,
                                MeanAggregator, SumAggregator)
from .workflow import Workflow

__all__ = ["VISITS", "build_reader", "build_features", "run",
           "CUTOFF", "RECENT_WINDOW", "make_event_log", "event_features",
           "one_point_families", "build_workflow"]

VISITS = [
    # user a: browses, buys at t=300, returns after
    {"user": "a", "ts": 100, "page": "home", "minutes": 3.0, "purchase": 0},
    {"user": "a", "ts": 200, "page": "item", "minutes": 7.0, "purchase": 0},
    {"user": "a", "ts": 300, "page": "cart", "minutes": 2.0, "purchase": 1},
    {"user": "a", "ts": 400, "page": "item", "minutes": 9.0, "purchase": 0},
    # user b: browses, never buys → dropped (no condition event)
    {"user": "b", "ts": 150, "page": "home", "minutes": 1.0, "purchase": 0},
    # user c: buys immediately at t=50, heavy use after
    {"user": "c", "ts": 50, "page": "cart", "minutes": 1.0, "purchase": 1},
    {"user": "c", "ts": 90, "page": "item", "minutes": 20.0, "purchase": 1},
]


def build_reader():
    return DataReaders.conditional.records(
        VISITS,
        timestamp_fn=lambda r: r["ts"],
        condition_fn=lambda r: r["purchase"] == 1,
        key_fn=lambda r: r["user"])


def build_features():
    # predictors: behavior BEFORE the first purchase
    minutes_before = (FeatureBuilder.Real("minutes")
                      .from_column().aggregate(SumAggregator())
                      .as_predictor())
    # response: any repeat purchase AFTER the first one
    repeat_buyer = (FeatureBuilder.Binary("purchase")
                    .extract(lambda r: bool(r["purchase"]), "purchase")
                    .aggregate(LogicalOrAggregator())
                    .as_response())
    return minutes_before, repeat_buyer


def run():
    """The walkthrough: ``(store, {row: {feature: value}})``, the rows
    ``examples/dataprep.py`` prints."""
    reader = build_reader()
    minutes_before, repeat_buyer = build_features()
    store = reader.generate_store([minutes_before, repeat_buyer])
    rows = {}
    for i in range(store.n_rows):
        rows[i] = {n: store[n].get_raw(i) for n in store.names()}
    return store, rows


# ---------------------------------------------------------------------------
# the event log at full width
# ---------------------------------------------------------------------------

#: the event log's cutoff: predictors fold ts < 800, the response ts > 800
CUTOFF = 800.0
#: ``spend_recent``'s window before the cutoff
RECENT_WINDOW = 200


def make_event_log(n_users: int, events_per_user: int = 20,
                   seed: int = 47) -> Tuple[temporal.Table, temporal.Table]:
    """``(events, users)`` as ``temporal.Table``\\ s built from numpy
    columns (no per-record Python), from ``numpy.random.default_rng(seed)``.

    ``events``: ``n_users · events_per_user`` transactions in time order,
    ``events_per_user`` per user — ``user`` (float id), ``ts`` uniform in
    [0, 1000), ``amount`` (gamma(2, 10)) and ``flag`` (bool). ``users``:
    the dimension table, ``user`` and ``seg = user % 7``. The schema is
    ``bench.py``'s event log. One departure from it, where the bench draws
    every value independently: each user draws a latent rate
    (exponential, mean 1) that scales both the user's amounts and the
    chance of ``flag`` (5% times the rate). So spend predicts the
    response, and the selected model's AuPR measures something."""
    rng = np.random.default_rng(seed)
    n = n_users * events_per_user
    ids = np.arange(n_users)
    rate = rng.exponential(1.0, n_users)
    user = np.repeat(ids, events_per_user)
    ts = rng.uniform(0.0, 1000.0, n)
    amount = rng.gamma(2.0, 10.0, n) * rate[user]
    flag = rng.random(n) < 0.05 * rate[user]
    order = np.argsort(ts, kind="stable")
    events = temporal.Table({"user": user[order].astype(np.float64),
                             "ts": ts[order], "amount": amount[order],
                             "flag": flag[order]})
    users = temporal.Table({"user": ids.astype(np.float64),
                            "seg": (ids % 7).astype(np.float64)})
    return events, users


class _TableReader(DataReader):
    """Hands a columnar batch to the join, keyed by ``user``."""

    def __init__(self, table):
        super().__init__(temporal.field("user"))
        self._table = table

    def read_records(self):
        return self._table


def event_features():
    """``(label, predictors)`` of the event log: ``spend`` (Sum of
    ``amount``), ``spend_recent`` (Mean, the ``RECENT_WINDOW`` before the
    cutoff), ``peak`` (Max), ``segment`` (Max of the joined ``seg``) and
    the response ``churned`` (LogicalOr of ``flag`` after the cutoff, a
    RealNN label)."""
    amount = temporal.field("amount")
    spend = (FeatureBuilder.Real("spend").extract(amount, "amount")
             .aggregate(SumAggregator()).as_predictor())
    recent = (FeatureBuilder.Real("spend_recent").extract(amount, "amount")
              .aggregate(MeanAggregator()).window(RECENT_WINDOW)
              .as_predictor())
    peak = (FeatureBuilder.Real("peak").extract(amount, "amount")
            .aggregate(MaxAggregator()).as_predictor())
    segment = (FeatureBuilder.Real("segment")
               .extract(temporal.field("seg"), "seg")
               .aggregate(MaxAggregator()).as_predictor())
    churned = (FeatureBuilder.RealNN("churned")
               .extract(temporal.field("flag"), "flag")
               .aggregate(LogicalOrAggregator()).as_response())
    return churned, [spend, recent, peak, segment]


def one_point_families(num_trees: int = 20) -> List[Any]:
    """The binary selector's default families at one grid point each:
    logistic regression, a random forest of ``num_trees`` trees, GBT and
    the linear SVC."""
    tree = {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}
    return [LogisticRegressionFamily(grid=[{"regParam": 0.01,
                                            "elasticNetParam": 0.1}]),
            RandomForestFamily(grid=[dict(tree)], num_trees=num_trees),
            GBTFamily(grid=[dict(tree, maxDepth=3)]),
            LinearSVCFamily(grid=[{"regParam": 0.01}])]


def build_workflow(events, users, families: Optional[List[Any]] = None,
                   num_folds: int = 3, seed: int = 7,
                   cutoff: float = CUTOFF) -> Dict[str, Any]:
    """The untrained event-log workflow: ``{"workflow", "reader",
    "selector", "label", "prediction", "raw"}``. The reader joins
    ``events`` (left) to ``users`` (right) and aggregates per user
    against ``cutoff``; ``families`` defaults to
    :func:`one_point_families`."""
    reader = JoinedAggregateDataReader(
        _TableReader(events), _TableReader(users),
        timestamp_fn=temporal.field("ts"), cutoff=CutOffTime.at(cutoff))
    churned, predictors = event_features()
    checked = churned.sanity_check(transmogrify(predictors),
                                   remove_bad_features=True)
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, validation_metric="AuPR",
        families=(families if families is not None
                  else one_point_families()), seed=seed)
    pred = churned.transform_with(selector, checked)
    wf = Workflow().set_reader(reader).set_result_features(pred)
    return {"workflow": wf, "reader": reader, "selector": selector,
            "label": churned, "prediction": pred,
            "raw": [churned] + predictors}
