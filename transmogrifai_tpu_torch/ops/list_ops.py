"""TextList / MultiPickList transformers behind the Rich* DSL long tail;
the port of ``transmogrifai_tpu/ops/list_ops.py``. Host numpy, as in the
JAX package: their outputs (f64 vectors, token lists, a RealNN) feed the
device vectorizers and the combiner.

Parity targets: ``RichListFeature.scala:59-312`` (tf / tfidf / ngram /
removeStopWords / countVec / vectorize) and ``RichSetFeature.scala:65-142``
(pivot / vectorize / jaccardSimilarity / toNGramSimilarity). The reference
wraps Spark ML's HashingTF / IDF / NGram / StopWordsRemover; these are
native columnar implementations with the same semantics: hashing term
frequencies (murmur3 bucket per token), Spark's IDF formula
``log((m + 1) / (df + 1))``, space-joined n-grams, and an English
stop-word table.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..columns import Column, ColumnStore, NumericColumn, VectorColumn
from ..stages.base import (Estimator, FittedModel, FixedArity, InputSpec,
                           Transformer, register_stage)
from ..types.feature_types import MultiPickList, OPVector, RealNN, TextList
from ..vector_metadata import VectorColumnMetadata, VectorMetadata

__all__ = ["OpHashingTF", "OpIDF", "OpIDFModel", "OpNGram",
           "OpStopWordsRemover", "JaccardSimilarity", "ENGLISH_STOP_WORDS"]

#: Spark ML's English stop-word list is Lucene's; this is the standard
#: English table (same spirit, vendored inline — no Lucene dependency)
ENGLISH_STOP_WORDS = frozenset("""a about above after again against all am
an and any are aren't as at be because been before being below between
both but by can't cannot could couldn't did didn't do does doesn't doing
don't down during each few for from further had hadn't has hasn't have
haven't having he he'd he'll he's her here here's hers herself him himself
his how how's i i'd i'll i'm i've if in into is isn't it it's its itself
let's me more most mustn't my myself no nor not of off on once only or
other ought our ours ourselves out over own same shan't she she'd she'll
she's should shouldn't so some such than that that's the their theirs them
themselves then there there's these they they'd they'll they're they've
this those through to too under until up very was wasn't we we'd we'll
we're we've were weren't what what's when when's where where's which while
who who's whom why why's with won't would wouldn't you you'd you'll you're
you've your yours yourself yourselves""".split())


def _rows_of(col, n_rows: int) -> List[List[str]]:
    return [[str(t) for t in (col.get_raw(i) or [])] for i in range(n_rows)]


def _flat_rows(rows: List[List[str]]):
    """(flat tokens, row of each token)."""
    lengths = np.fromiter((len(r) for r in rows), np.int64, count=len(rows))
    return ([t for r in rows for t in r],
            np.repeat(np.arange(len(rows)), lengths))


@register_stage
class OpHashingTF(Transformer):
    """TextList → OPVector of hashed term frequencies (HashingTF wrap in
    ``RichListFeature.tf`` :59; murmur3 bucket per token, optional binary
    counts)."""

    operation_name = "hashingTF"
    output_type = OPVector

    def __init__(self, num_terms: int = 512, binary: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.num_terms = int(num_terms)
        self.binary = bool(binary)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(TextList)

    def transform_columns(self, store: ColumnStore) -> Column:
        from .hashing import hash_tokens
        col = store[self.input_features[0].name]
        out = np.zeros((store.n_rows, self.num_terms), np.float64)
        flat, rows = _flat_rows(_rows_of(col, store.n_rows))
        if flat:
            # hashed once per distinct token, counted by one scatter-add
            uniq, inv = np.unique(np.asarray(flat, dtype=object),
                                  return_inverse=True)
            buckets = (hash_tokens(uniq.tolist())
                       % np.uint32(self.num_terms)).astype(np.int64)[inv]
            np.add.at(out, (rows, buckets), 1.0)
        if self.binary:
            out = (out > 0).astype(np.float64)
        name = self.input_features[0].name
        meta = VectorMetadata(self.output_name, [
            VectorColumnMetadata(parent_feature_name=name,
                                 parent_feature_type="TextList",
                                 grouping=name, indicator_value=None,
                                 descriptor_value=f"tf_{j}", index=j)
            for j in range(self.num_terms)])
        return VectorColumn(OPVector, out, metadata=meta)


@register_stage
class OpIDFModel(FittedModel):
    """Fitted IDF scaling: v → v · log((m + 1) / (df + 1))."""

    operation_name = "idf"
    output_type = OPVector

    def __init__(self, idf: Optional[np.ndarray] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.idf = np.asarray(idf, np.float64) if idf is not None else None

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(OPVector)

    def get_model_state(self):
        return {"idf": self.idf}

    def apply_model_state(self, state) -> None:
        self.idf = np.asarray(state["idf"], np.float64)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        vals = np.asarray(col.values, np.float64) * self.idf[None, :]
        return VectorColumn(OPVector, vals, metadata=col.metadata)


@register_stage
class OpIDF(Estimator):
    """Inverse document frequency estimator (Spark ``IDF`` wrap in
    ``RichListFeature.tfidf`` :76): fit collects per-column document
    frequencies; ``min_doc_freq`` zeroes terms below the floor."""

    operation_name = "idfFit"
    output_type = OPVector

    def __init__(self, min_doc_freq: int = 0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.min_doc_freq = int(min_doc_freq)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(OPVector)

    def fit_columns(self, store: ColumnStore) -> OpIDFModel:
        col = store[self.input_features[0].name]
        vals = np.asarray(col.values, np.float64)
        m = vals.shape[0]
        df = (vals > 0).sum(axis=0).astype(np.float64)
        idf = np.log((m + 1.0) / (df + 1.0))
        if self.min_doc_freq > 0:
            idf = np.where(df >= self.min_doc_freq, idf, 0.0)
        return OpIDFModel(idf=idf)


@register_stage
class OpNGram(Transformer):
    """TextList → TextList of space-joined n-grams (Spark ``NGram`` wrap
    in ``RichListFeature.ngram`` :153; fewer than n tokens → empty)."""

    operation_name = "ngramList"
    output_type = TextList

    def __init__(self, n: int = 2, uid: Optional[str] = None):
        super().__init__(uid=uid)
        if n < 1:
            raise ValueError("ngram size must be >= 1")
        self.n = int(n)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(TextList)

    def transform_columns(self, store: ColumnStore) -> Column:
        from ..columns import TextListColumn
        col = store[self.input_features[0].name]
        out = []
        for r in _rows_of(col, store.n_rows):
            toks = [t for t in r if t is not None]
            out.append([" ".join(toks[j:j + self.n])
                        for j in range(len(toks) - self.n + 1)])
        return TextListColumn(TextList, out)


@register_stage
class OpStopWordsRemover(Transformer):
    """TextList → TextList without stop words (Spark ``StopWordsRemover``
    wrap in ``RichListFeature.removeStopWords`` :168)."""

    operation_name = "stopWords"
    output_type = TextList

    def __init__(self, stop_words: Optional[List[str]] = None,
                 case_sensitive: bool = False, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.stop_words = (list(stop_words) if stop_words is not None
                           else sorted(ENGLISH_STOP_WORDS))
        self.case_sensitive = bool(case_sensitive)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(TextList)

    def transform_columns(self, store: ColumnStore) -> Column:
        from ..columns import TextListColumn
        col = store[self.input_features[0].name]
        table = (set(self.stop_words) if self.case_sensitive
                 else {w.lower() for w in self.stop_words})
        out = []
        for r in _rows_of(col, store.n_rows):
            out.append([t for t in r
                        if (t if self.case_sensitive else t.lower())
                        not in table])
        return TextListColumn(TextList, out)


@register_stage
class JaccardSimilarity(Transformer):
    """(MultiPickList, MultiPickList) → RealNN Jaccard overlap
    (``JaccardSimilarity`` via ``RichSetFeature.jaccardSimilarity`` :124;
    two empty sets score 1.0 like the reference)."""

    operation_name = "jaccardSim"
    output_type = RealNN

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(MultiPickList, MultiPickList)

    def transform_columns(self, store: ColumnStore) -> Column:
        a = store[self.input_features[0].name]
        b = store[self.input_features[1].name]
        out = np.empty(store.n_rows, np.float64)
        for i, (ra, rb) in enumerate(zip(a.values, b.values)):
            sa, sb = set(ra or ()), set(rb or ())
            union = sa | sb
            out[i] = (len(sa & sb) / len(union)) if union else 1.0
        return NumericColumn(RealNN, out, np.ones(store.n_rows, bool))
