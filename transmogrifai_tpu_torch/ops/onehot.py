"""One-hot pivot vectorizers for categorical text and sets; the port of
``transmogrifai_tpu/ops/onehot.py`` (``OpOneHotVectorizer.scala``,
``OpSetVectorizer``).

Per feature: count values, keep the top K with count ≥ min_support, emit
``[cat_1 .. cat_K, OTHER, NullIndicator]`` (a multi-hot row for a set,
whose empty set is the null). Fit is a host value count; transform is a
host vocab lookup and scatter (``device_math = False``).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..columns import ColumnStore, TextSetColumn
from ..stages.base import VarArity, register_stage
from ..types.feature_types import OPSet, Text
from ..vector_metadata import (NULL_INDICATOR, OTHER_INDICATOR,
                               VectorColumnMetadata, VectorMetadata)
from .vectorizer_base import (TransmogrifierDefaults, VEC_DTYPE,
                              VectorizerEstimator, VectorizerModel)

__all__ = ["OneHotVectorizer", "SetVectorizer", "OneHotModel",
           "pivot_metadata"]


def _sorted_topk(counts: Counter, top_k: int, min_support: int) -> List[str]:
    """Top-K by count desc, ties by value asc (deterministic)."""
    items = [(v, c) for v, c in counts.items() if c >= min_support]
    items.sort(key=lambda vc: (-vc[1], vc[0]))
    return [v for v, _ in items[:top_k]]


def pivot_metadata(name: str, ftype_name: str, vocab: Sequence[str],
                   track_nulls: bool) -> List[VectorColumnMetadata]:
    """One pivot block's slots: categories, OTHER, and the null slot."""
    cols = [VectorColumnMetadata(
        parent_feature_name=name, parent_feature_type=ftype_name,
        grouping=name, indicator_value=v)
        for v in list(vocab) + [OTHER_INDICATOR]
        + ([NULL_INDICATOR] if track_nulls else [])]
    return cols


@register_stage
class OneHotModel(VectorizerModel):
    """Fitted pivot: per-feature vocab → [cats..., OTHER, null]; a set
    column (``is_set``) gets the multi-hot block."""

    operation_name = "pivot"
    seq_type = Text
    device_math = False

    def __init__(self, vocabs: Sequence[Sequence[str]] = (),
                 track_nulls: bool = True,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "Text",
                 is_set: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocabs = [list(v) for v in vocabs]
        self.track_nulls = track_nulls
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name
        self.is_set = is_set

    @property
    def input_spec(self):
        return VarArity(OPSet if self.is_set else Text)

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        """One full-width matrix; each feature's block is a view into it."""
        from ._hostvec import multihot_block, onehot_block
        nul = 1 if self.track_nulls else 0
        widths = [len(v) + 1 + nul for v in self.vocabs]
        mat = np.zeros((store.n_rows, sum(widths)), dtype=VEC_DTYPE)
        off = 0
        for name, vocab, w in zip(self._names(), self.vocabs, widths):
            col = store[name]
            block = (multihot_block if isinstance(col, TextSetColumn)
                     else onehot_block)
            block(col.values, vocab, self.track_nulls,
                  out=mat[:, off:off + w])
            off += w
        return {"mat": mat}

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for name, vocab in zip(self._names(), self.vocabs):
            cols += pivot_metadata(name, self.ftype_name, vocab,
                                   self.track_nulls)
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"vocabs": self.vocabs, "input_names_saved": self._names()}


@register_stage
class OneHotVectorizer(VectorizerEstimator):
    """Categorical text pivot estimator (OpOneHotVectorizer.scala)."""

    operation_name = "pivot"
    seq_type = Text

    def __init__(self, top_k: int = TransmogrifierDefaults.TOP_K,
                 min_support: int = TransmogrifierDefaults.MIN_SUPPORT,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls

    #: the count's request kind and the model's flavor; the set pivot
    #: overrides both and ``_count``
    _count_kind = "value_counts"
    _is_set = False

    def _count(self, col) -> Counter:
        from ._hostvec import value_counts
        return value_counts(col.values)

    def _model_of(self, vocabs) -> OneHotModel:
        return OneHotModel(
            vocabs=vocabs, track_nulls=self.track_nulls,
            input_names=self.input_names,
            ftype_name=self.seq_type.__name__, is_set=self._is_set)

    def fit_columns(self, store: ColumnStore) -> OneHotModel:
        return self._model_of(
            [_sorted_topk(self._count(store[n]), self.top_k,
                          self.min_support)
             for n in self.input_names])

    # -- the fused fit-statistics pass (fitstats.py) -----------------------
    # Two pivots over one column (other top_k) share one count: the
    # request is the whole Counter, each stage cuts its own top K.
    def stat_requests(self, store):
        from ..fitstats import StatRequest
        return [StatRequest(self._count_kind, n) for n in self.input_names]

    def fit_columns_from_stats(self, store, stats):
        return self._model_of(
            [_sorted_topk(stats.value(self._count_kind, n), self.top_k,
                          self.min_support)
             for n in self.input_names])


@register_stage
class SetVectorizer(OneHotVectorizer):
    """MultiPickList pivot (OpSetVectorizer): multi-hot over the top-K
    values."""

    operation_name = "pivotSet"
    seq_type = OPSet
    _count_kind = "set_value_counts"
    _is_set = True

    def _count(self, col) -> Counter:
        from ._hostvec import flatten_ragged, value_counts
        return value_counts(flatten_ragged(col.values)[0])
