"""One-hot pivot vectorizer for categorical text; the port of
``transmogrifai_tpu/ops/onehot.py`` (``OpOneHotVectorizer.scala``).

Per feature: count values, keep the top K with count ≥ min_support, emit
``[cat_1 .. cat_K, OTHER, NullIndicator]``. Fit is a host value count;
transform is a host vocab lookup and scatter (``device_math = False``).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..columns import ColumnStore
from ..stages.base import register_stage
from ..types.feature_types import Text
from ..vector_metadata import (NULL_INDICATOR, OTHER_INDICATOR,
                               VectorColumnMetadata, VectorMetadata)
from .vectorizer_base import (TransmogrifierDefaults, VEC_DTYPE,
                              VectorizerEstimator, VectorizerModel)

__all__ = ["OneHotVectorizer", "OneHotModel", "pivot_metadata"]


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
    """Fitted pivot: per-feature vocab → [cats..., OTHER, null]."""

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
        if is_set:
            raise NotImplementedError(
                "the set pivot (SetVectorizer) is not ported yet (ROADMAP "
                "queue A, item 2)")
        self.vocabs = [list(v) for v in vocabs]
        self.track_nulls = track_nulls
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        """One full-width matrix; each feature's block is a view into it."""
        from ._hostvec import onehot_block
        nul = 1 if self.track_nulls else 0
        widths = [len(v) + 1 + nul for v in self.vocabs]
        mat = np.zeros((store.n_rows, sum(widths)), dtype=VEC_DTYPE)
        off = 0
        for name, vocab, w in zip(self._names(), self.vocabs, widths):
            onehot_block(store[name].values, vocab, self.track_nulls,
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

    def fit_columns(self, store: ColumnStore) -> OneHotModel:
        from ._hostvec import value_counts
        return OneHotModel(
            vocabs=[_sorted_topk(value_counts(store[n].values), self.top_k,
                                 self.min_support)
                    for n in self.input_names],
            track_nulls=self.track_nulls, input_names=self.input_names,
            ftype_name=self.seq_type.__name__)
