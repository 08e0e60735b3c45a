"""String indexing — text labels ⇄ numeric indices; the port of
``transmogrifai_tpu/ops/indexers.py``.

* ``OpStringIndexerNoFilter`` (``OpStringIndexerNoFilter.scala:48-74``):
  fit orders the labels by descending frequency, ties by label (Spark
  StringIndexer's frequencyDesc); null is the literal label ``"null"``;
  a value unseen at fit time takes index ``len(labels)`` under
  ``unseen_name``.
* ``OpIndexToStringNoFilter`` (``OpIndexToString.scala``): index → label,
  out of range → ``unseen_name``.
* ``PredictionDeIndexer`` (``PredictionDeIndexer.scala:52-88``): over
  (indexed response, prediction), reads the label list from the response
  column's ``labels`` (the NominalAttribute analog) and turns predicted
  indices back into label strings.

Indexing is host work: strings live on the host. The de-indexer's
numeric half — each prediction's index into its label table — also runs
on the device (:meth:`PredictionDeIndexerModel.codes_device`), so the
scoring engine keeps it inside its program and only the table lookup of
the strings runs on the host after the pull.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..columns import (Column, ColumnStore, NumericColumn, PredictionColumn,
                       TextColumn)
from ..stages.base import (AllowLabelAsInput, Estimator, FittedModel,
                           FixedArity, InputSpec, Transformer, register_stage)
from ..types.feature_types import Prediction, RealNN, Text

__all__ = ["OpStringIndexerNoFilter", "OpStringIndexerModel",
           "OpIndexToStringNoFilter", "PredictionDeIndexer",
           "PredictionDeIndexerModel"]

UNSEEN_DEFAULT = "UnseenLabel"
NULL_LABEL = "null"   # the reference maps None to the literal "null"


def _label_column(labels: Sequence[str], unseen_name: str,
                  idx: np.ndarray) -> TextColumn:
    """Indices → a Text column: labels[i] in range, else ``unseen_name``."""
    k = len(labels)
    codes = np.where((idx >= 0) & (idx < k), idx, k)
    table = np.empty(k + 1, dtype=object)
    table[:k] = list(labels)
    table[k] = unseen_name
    return TextColumn(Text, table[codes])


@register_stage
class OpStringIndexerModel(FittedModel):
    """Fitted indexer: the label list in training-frequency order."""

    operation_name = "strIdx"
    output_type = RealNN

    def __init__(self, labels: Sequence[str] = (),
                 unseen_name: str = UNSEEN_DEFAULT,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.labels = list(labels)
        self.unseen_name = unseen_name

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text)

    def transform_columns(self, store: ColumnStore) -> Column:
        from ._hostvec import string_codes
        col = store[self.input_features[0].name]
        values = [NULL_LABEL if v is None else v for v in col.values]
        codes, _ = string_codes(values, self.labels)   # unseen → len(labels)
        vals = codes.astype(np.float64)
        return NumericColumn(RealNN, vals, np.ones(len(vals), bool),
                             labels=self.labels + [self.unseen_name])

    def get_model_state(self) -> Dict[str, Any]:
        return {"labels": self.labels}


@register_stage
class OpStringIndexerNoFilter(Estimator):
    """Estimator(Text) → RealNN indices, keeping unseen values (NoFilter)."""

    operation_name = "strIdx"
    output_type = RealNN

    def __init__(self, unseen_name: str = UNSEEN_DEFAULT,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.unseen_name = unseen_name

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text)

    def fit_columns(self, store: ColumnStore) -> OpStringIndexerModel:
        from ._hostvec import value_counts
        col = store[self.input_features[0].name]
        counts = value_counts(
            [NULL_LABEL if v is None else v for v in col.values])
        labels = [lbl for lbl, _ in
                  sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))]
        return OpStringIndexerModel(labels=labels,
                                    unseen_name=self.unseen_name)


@register_stage
class OpIndexToStringNoFilter(Transformer):
    """Transformer(RealNN) → Text through a fixed label list."""

    operation_name = "idx2str"
    output_type = Text

    def __init__(self, labels: Sequence[str] = (),
                 unseen_name: str = UNSEEN_DEFAULT,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.labels = list(labels)
        self.unseen_name = unseen_name

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        return _label_column(self.labels, self.unseen_name,
                             np.asarray(col.values).astype(np.int64))


@register_stage
class PredictionDeIndexerModel(FittedModel, AllowLabelAsInput):
    """Fitted de-indexer: predicted index → response label string."""

    operation_name = "idx2str"
    output_type = Text

    def __init__(self, labels: Sequence[str] = (),
                 unseen_name: str = UNSEEN_DEFAULT,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.labels = list(labels)
        self.unseen_name = unseen_name

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, Prediction)

    def codes_device(self, pred: torch.Tensor) -> torch.Tensor:
        """The prediction column [n] → int64 codes on its device: the
        index into the labels, or ``len(labels)`` (the unseen name) out
        of range. No read-back, so the scoring engine captures it."""
        idx = pred.long()
        k = len(self.labels)
        return torch.where((idx >= 0) & (idx < k), idx, k)

    def label_column(self, codes: np.ndarray) -> TextColumn:
        """Codes (from :meth:`codes_device`) → the label strings."""
        return _label_column(self.labels, self.unseen_name,
                             np.asarray(codes).astype(np.int64))

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[1].name]
        assert isinstance(col, PredictionColumn)
        return self.label_column(col.prediction.astype(np.int64))

    def get_model_state(self) -> Dict[str, Any]:
        return {"labels": self.labels}


@register_stage
class PredictionDeIndexer(Estimator, AllowLabelAsInput):
    """Estimator(indexed response, Prediction) → Text. The label list is
    the response column's ``labels`` (set by :class:`OpStringIndexerModel`),
    as the reference reads the NominalAttribute from the response schema
    (``PredictionDeIndexer.scala:61-68``)."""

    operation_name = "idx2str"
    output_type = Text

    def __init__(self, unseen_name: str = UNSEEN_DEFAULT,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.unseen_name = unseen_name

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, Prediction)

    def fit_columns(self, store: ColumnStore) -> PredictionDeIndexerModel:
        resp = self.input_features[0]
        labels = getattr(store[resp.name], "labels", None)
        if not labels:
            raise ValueError(
                f"The feature {resp.name!r} does not contain any label/index "
                "mapping in its metadata — index it with "
                "OpStringIndexerNoFilter first")
        return PredictionDeIndexerModel(labels=labels,
                                        unseen_name=self.unseen_name)
