"""SmartTextVectorizer — cardinality-adaptive text vectorization; the port
of ``transmogrifai_tpu/ops/smart_text.py`` (``SmartTextVectorizer.scala``).

Fit counts each feature's values up to ``max_cardinality`` (=100).
Features at or below it are pivoted (top-K + OTHER + null); the rest get
the hashing trick (+ optional text length) + a null indicator. Both blocks
are built on the host (``device_math = False``).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..columns import ColumnStore
from ..stages.base import register_stage
from ..types.feature_types import Text
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from .onehot import _sorted_topk, pivot_metadata
from .vectorizer_base import (TransmogrifierDefaults, VEC_DTYPE,
                              VectorizerEstimator, VectorizerModel,
                              null_indicator_meta)

__all__ = ["TextStats", "SmartTextVectorizer", "SmartTextVectorizerModel"]


class TextStats:
    """Value-count semigroup with a cardinality cap
    (SmartTextVectorizer.scala:170)."""

    def __init__(self, max_cardinality: int):
        self.max_cardinality = max_cardinality
        self.counts: Counter = Counter()
        self.capped = False

    def add(self, value: Optional[str]) -> None:
        if value is None or self.capped:
            return
        self.counts[value] += 1
        if len(self.counts) > self.max_cardinality:
            self.capped = True

    @property
    def cardinality(self) -> int:
        return len(self.counts)


@register_stage
class SmartTextVectorizerModel(VectorizerModel):
    """Per-feature routing: categorical → pivot block, text → hash block."""

    operation_name = "smartTextVec"
    seq_type = Text
    device_math = False

    def __init__(self, is_categorical: Sequence[bool] = (),
                 vocabs: Sequence[Sequence[str]] = (),
                 num_features: int = TransmogrifierDefaults.HASH_SIZE,
                 track_nulls: bool = True,
                 track_text_len: bool = False,
                 seed: int = 42,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "Text",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.is_categorical = list(is_categorical)
        self.vocabs = [list(v) for v in vocabs]
        self.num_features = num_features
        self.track_nulls = track_nulls
        self.track_text_len = track_text_len
        self.seed = seed
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name

    def _widths(self) -> List[int]:
        vocab_iter = iter(self.vocabs)
        nul = 1 if self.track_nulls else 0
        return [len(next(vocab_iter)) + 1 + nul if cat
                else self.num_features + (1 if self.track_text_len else 0)
                + nul for cat in self.is_categorical]

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        """One full-width matrix written in place; per-feature sections
        are views, so no concat copy happens."""
        from ._hostvec import hashed_text_block, onehot_block
        n = store.n_rows
        widths = self._widths()
        mat = np.zeros((n, sum(widths)), dtype=VEC_DTYPE)
        vocab_iter = iter(self.vocabs)
        off = 0
        for j, name in enumerate(self._names()):
            values = store[name].values
            sect = mat[:, off:off + widths[j]]
            if self.is_categorical[j]:
                onehot_block(values, next(vocab_iter), self.track_nulls,
                             out=sect)
            else:
                null_mask = hashed_text_block(
                    values, self.num_features, self.seed, False, out=mat,
                    col_offset=off) > 0
                if self.track_text_len:
                    sect[:, self.num_features] = np.fromiter(
                        (0.0 if v is None else len(v) for v in values),
                        np.float64, count=n)
                if self.track_nulls:
                    sect[null_mask, -1] = 1.0
            off += widths[j]
        return {"mat": mat}

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        vocab_iter = iter(self.vocabs)
        for j, name in enumerate(self._names()):
            if self.is_categorical[j]:
                cols += pivot_metadata(name, self.ftype_name,
                                       next(vocab_iter), self.track_nulls)
                continue
            cols += [VectorColumnMetadata(
                parent_feature_name=name, parent_feature_type=self.ftype_name,
                descriptor_value=f"hash_{i}")
                for i in range(self.num_features)]
            if self.track_text_len:
                cols.append(VectorColumnMetadata(
                    parent_feature_name=name,
                    parent_feature_type=self.ftype_name,
                    descriptor_value="TextLen"))
            if self.track_nulls:
                cols.append(null_indicator_meta(name, self.ftype_name))
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"is_categorical": self.is_categorical, "vocabs": self.vocabs,
                "input_names_saved": self._names()}


@register_stage
class SmartTextVectorizer(VectorizerEstimator):
    """Estimator: probe cardinality, route each feature."""

    operation_name = "smartTextVec"
    seq_type = Text

    def __init__(self, max_cardinality: int = 100,
                 top_k: int = TransmogrifierDefaults.TOP_K,
                 min_support: int = TransmogrifierDefaults.MIN_SUPPORT,
                 num_features: int = TransmogrifierDefaults.HASH_SIZE,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 track_text_len: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_features = num_features
        self.track_nulls = track_nulls
        self.track_text_len = track_text_len

    def fit_columns(self, store: ColumnStore) -> SmartTextVectorizerModel:
        is_cat: List[bool] = []
        vocabs: List[List[str]] = []
        for name in self.input_names:
            stats = TextStats(self.max_cardinality)
            for v in store[name].values:
                stats.add(v)
            is_cat.append(not stats.capped)
            if not stats.capped:
                vocabs.append(_sorted_topk(stats.counts, self.top_k,
                                           self.min_support))
        return SmartTextVectorizerModel(
            is_categorical=is_cat, vocabs=vocabs,
            num_features=self.num_features, track_nulls=self.track_nulls,
            track_text_len=self.track_text_len,
            input_names=self.input_names, ftype_name=self.seq_type.__name__)
