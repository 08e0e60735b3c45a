"""Feature DSL — the port of ``transmogrifai_tpu/dsl.py`` for what the
Titanic and map-feature examples use: the numeric math transformers
(``+ - * /`` of two features or of a feature and a scalar),
``fill_missing_with_mean``, ``z_normalize``, ``pivot``, ``map_to``,
``alias``, ``transmogrify`` (RichFeaturesCollection.transmogrify),
``Feature.sanity_check``, the multiclass path's label indexing,
``indexed``, and the Rich* surfaces of maps, lists and sets:
``vectorize`` (with ``allow_keys`` / ``block_keys``), ``smart_vectorize``,
``filter_keys``, ``extract_key``, ``bucketize``, ``auto_bucketize``,
``tf``, ``idf``, ``tfidf``, ``ngram``, ``remove_stop_words``,
``jaccard_similarity``, ``scaled`` and ``descaled``.
Importing the package attaches the methods and operators::

    family_size = sib_sp + par_ch + 1
    cost = family_size * fare
    pivoted = sex.pivot()
    normed = age.fill_missing_with_mean().z_normalize()
    usage_vec = usage.vectorize(block_keys=["internal_audit"])
    note_vec = note.remove_stop_words().tfidf(num_terms=32)

Null semantics follow the reference truth tables
(``MathTransformers.scala``): plus/minus treat empty as identity;
multiply/divide need both sides and drop non-finite results. These stages
run on the host (numpy), as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Type

import numpy as np

from .columns import Column, ColumnStore, NumericColumn, column_from_values
from .features import Feature
from .stages.base import (Estimator, FittedModel, FixedArity, InputSpec,
                          Transformer, register_stage)
from .types import feature_types as ft

__all__ = ["MathBinaryTransformer", "MathScalarTransformer",
           "FillMissingWithMean", "FillMissingWithMeanModel",
           "ScalarNormalizer", "ScalarNormalizerModel", "AliasTransformer",
           "MapTransformer", "transmogrify"]


def _num_col(store: ColumnStore, f: Feature) -> NumericColumn:
    col = store[f.name]
    if not isinstance(col, NumericColumn):
        raise TypeError(f"{f.name} is not numeric")
    return col


@register_stage
class MathBinaryTransformer(Transformer):
    """+, -, *, / of two numeric features (MathTransformers.scala)."""

    output_type = ft.Real

    def __init__(self, op: str = "add", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.op = op
        self.operation_name = {"add": "plus", "subtract": "minus",
                               "multiply": "multiply", "divide": "divide"}[op]

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPNumeric, ft.OPNumeric)

    def transform_columns(self, store: ColumnStore) -> Column:
        a = _num_col(store, self.input_features[0])
        b = _num_col(store, self.input_features[1])
        av = a.values.astype(np.float64)
        bv = b.values.astype(np.float64)
        am, bm = a.mask, b.mask
        if self.op in ("add", "subtract"):
            sign = 1.0 if self.op == "add" else -1.0
            vals = np.where(am, av, 0.0) + sign * np.where(bm, bv, 0.0)
            mask = am | bm
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                vals = av * bv if self.op == "multiply" else av / bv
            mask = am & bm & np.isfinite(vals)
            vals = np.where(mask, vals, 0.0)
        return NumericColumn(ft.Real, vals, mask)


@register_stage
class MathScalarTransformer(Transformer):
    """Numeric feature op scalar (plusS/minusS/multiplyS/divideS)."""

    output_type = ft.Real

    def __init__(self, op: str = "add", scalar: float = 0.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.op = op
        self.scalar = float(scalar)
        self.operation_name = {"add": "plusS", "subtract": "minusS",
                               "rsubtract": "rminusS", "multiply": "multiplyS",
                               "divide": "divideS", "rdivide": "rdivideS"}[op]

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPNumeric)

    def transform_columns(self, store: ColumnStore) -> Column:
        a = _num_col(store, self.input_features[0])
        av = a.values.astype(np.float64)
        s = self.scalar
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = {"add": av + s, "subtract": av - s, "rsubtract": s - av,
                    "multiply": av * s, "divide": av / s,
                    "rdivide": s / av}[self.op]
        mask = a.mask & np.isfinite(vals)
        return NumericColumn(ft.Real, np.where(mask, vals, 0.0), mask)


@register_stage
class FillMissingWithMean(Estimator):
    """Real → RealNN imputing the train mean
    (RichNumericFeature.fillMissingWithMean)."""

    operation_name = "fillWithMean"
    output_type = ft.RealNN

    def __init__(self, default: float = 0.0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.default = default

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPNumeric)

    def fit_columns(self, store: ColumnStore) -> "FillMissingWithMeanModel":
        col = _num_col(store, self.input_features[0])
        mean = (float(col.values[col.mask].astype(np.float64).mean())
                if col.mask.any() else self.default)
        return FillMissingWithMeanModel(mean=mean)

    # -- the fused fit-statistics pass (fitstats.py) -----------------------
    def stat_requests(self, store):
        from .fitstats import StatRequest
        return [StatRequest("mean", self.input_features[0].name)]

    def fit_columns_from_stats(self, store, stats):
        mean = stats.value("mean", self.input_features[0].name)
        return FillMissingWithMeanModel(
            mean=self.default if mean is None else mean)


@register_stage
class FillMissingWithMeanModel(FittedModel):
    operation_name = "fillWithMean"
    output_type = ft.RealNN

    def __init__(self, mean: float = 0.0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.mean = mean

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPNumeric)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = _num_col(store, self.input_features[0])
        vals = np.where(col.mask, col.values.astype(np.float64), self.mean)
        return NumericColumn(ft.RealNN, vals, np.ones(len(col), dtype=bool))

    def get_model_state(self):
        return {"mean": self.mean}


@register_stage
class ScalarNormalizer(Estimator):
    """RealNN → RealNN z-normalization (OpScalarStandardScaler.scala),
    with f64 moments."""

    operation_name = "zNormalize"
    output_type = ft.RealNN

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPNumeric)

    def fit_columns(self, store: ColumnStore) -> "ScalarNormalizerModel":
        col = _num_col(store, self.input_features[0])
        vals = col.values[col.mask].astype(np.float64)
        mean = float(vals.mean()) if vals.size else 0.0
        std = float(vals.std()) if vals.size else 1.0
        return ScalarNormalizerModel(mean=mean,
                                     std=std if std > 1e-12 else 1.0)

    # -- the fused fit-statistics pass (fitstats.py) -----------------------
    def stat_requests(self, store):
        from .fitstats import StatRequest
        name = self.input_features[0].name
        return [StatRequest("mean", name), StatRequest("std", name)]

    def fit_columns_from_stats(self, store, stats):
        name = self.input_features[0].name
        mean = stats.value("mean", name)
        std = stats.value("std", name)
        mean = 0.0 if mean is None else mean
        std = 1.0 if std is None else std
        return ScalarNormalizerModel(mean=mean,
                                     std=std if std > 1e-12 else 1.0)


@register_stage
class ScalarNormalizerModel(FittedModel):
    operation_name = "zNormalize"
    output_type = ft.RealNN

    def __init__(self, mean: float = 0.0, std: float = 1.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.mean = mean
        self.std = std

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPNumeric)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = _num_col(store, self.input_features[0])
        vals = (col.values.astype(np.float64) - self.mean) / self.std
        vals = np.where(col.mask, vals, 0.0)
        return NumericColumn(ft.RealNN, vals, np.ones(len(col), dtype=bool))

    def get_model_state(self):
        return {"mean": self.mean, "std": self.std}


class _OneInput(InputSpec):
    def check(self, features):
        if len(features) != 1:
            raise TypeError("alias takes exactly one input")


@register_stage
class AliasTransformer(Transformer):
    """Identity rename (AliasTransformer)."""

    operation_name = "alias"

    def __init__(self, name: str = "alias", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.name = name
        self.output_type = ft.FeatureType

    @property
    def input_spec(self) -> InputSpec:
        return _OneInput()

    def get_output(self) -> Feature:
        if self._output_feature is None:
            f = self.input_features[0]
            self._output_feature = Feature(
                name=self.name, ftype=f.ftype, is_response=f.is_response,
                origin_stage=self, parents=self.input_features)
        return self._output_feature

    def transform_columns(self, store: ColumnStore) -> Column:
        return store[self.input_features[0].name]


@register_stage
class MapTransformer(Transformer):
    """Row-wise value map (RichFeature.map): ``fn`` of each raw value."""

    def __init__(self, fn: Callable[[Any], Any] = None,
                 input_type: Type[ft.FeatureType] = ft.FeatureType,
                 output_type: Type[ft.FeatureType] = ft.FeatureType,
                 operation_name: str = "map",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.fn = fn
        self._input_type = input_type
        self.output_type = output_type
        self.operation_name = operation_name

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(self._input_type)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        return column_from_values(
            self.output_type, [self.fn(col.get_raw(i))
                               for i in range(len(col))])


def transmogrify(features: Sequence[Feature]) -> Feature:
    """One-call automated feature engineering: features → one OPVector."""
    from .ops.transmogrifier import transmogrify as _tm
    return _tm(features)


# ---------------------------------------------------------------------------
# Feature method attachment (RichFeature et al.)
# ---------------------------------------------------------------------------

def _binary_math(op):
    def method(self: Feature, other):
        if isinstance(other, Feature):
            return self.transform_with(MathBinaryTransformer(op=op), other)
        return self.transform_with(
            MathScalarTransformer(op=op, scalar=float(other)))
    return method


def _rbinary_math(rop):
    def method(self: Feature, other):
        return self.transform_with(
            MathScalarTransformer(op=rop, scalar=float(other)))
    return method


def _pivot(self: Feature, top_k: int = 20, min_support: int = 1):
    from .ops.onehot import OneHotVectorizer
    return self.transform_with(
        OneHotVectorizer(top_k=top_k, min_support=min_support))


def _fill_missing_with_mean(self: Feature, default: float = 0.0):
    return self.transform_with(FillMissingWithMean(default=default))


def _z_normalize(self: Feature):
    return self.transform_with(ScalarNormalizer())


def _map_to(self: Feature, fn, output_type, operation_name: str = "map"):
    return self.transform_with(
        MapTransformer(fn, self.ftype, output_type, operation_name))


def _alias(self: Feature, name: str):
    return self.transform_with(AliasTransformer(name=name))


def _sanity_check(self: Feature, features: Feature,
                  remove_bad_features: bool = True, **kw) -> Feature:
    """``label.sanity_check(vector)``: the SanityChecker's cleaned vector."""
    from .ops.sanity_checker import SanityChecker
    checker = SanityChecker(remove_bad_features=remove_bad_features, **kw)
    checker.set_input(self, features)
    return checker.get_output()


def _indexed(self: Feature, **kw):
    """Text → RealNN label indices (OpStringIndexerNoFilter)."""
    from .ops.indexers import OpStringIndexerNoFilter
    return self.transform_with(OpStringIndexerNoFilter(**kw))


def _bucketize(self: Feature, splits=None, **kw):
    from .ops.numeric import NumericBucketizer
    return self.transform_with(NumericBucketizer(
        splits=list(splits) if splits is not None else None, **kw))


def _tf(self: Feature, num_terms: int = 512, binary: bool = False):
    """TextList → hashed term-frequency OPVector
    (RichListFeature.tf :59)."""
    from .ops.list_ops import OpHashingTF
    return self.transform_with(OpHashingTF(num_terms=num_terms,
                                           binary=binary))


def _idf(self: Feature, min_doc_freq: int = 0):
    """OPVector → IDF-scaled OPVector (Spark IDF wrap)."""
    from .ops.list_ops import OpIDF
    return self.transform_with(OpIDF(min_doc_freq=min_doc_freq))


def _tfidf(self: Feature, num_terms: int = 512, binary: bool = False,
           min_doc_freq: int = 0):
    """TextList → TF-IDF OPVector (RichListFeature.tfidf :76)."""
    return _idf(_tf(self, num_terms=num_terms, binary=binary),
                min_doc_freq=min_doc_freq)


def _ngram(self: Feature, n: int = 2):
    """TextList → TextList of space-joined n-grams
    (RichListFeature.ngram :153)."""
    from .ops.list_ops import OpNGram
    return self.transform_with(OpNGram(n=n))


def _remove_stop_words(self: Feature, stop_words=None,
                       case_sensitive: bool = False):
    """TextList → TextList without stop words
    (RichListFeature.removeStopWords :168)."""
    from .ops.list_ops import OpStopWordsRemover
    return self.transform_with(OpStopWordsRemover(
        stop_words=stop_words, case_sensitive=case_sensitive))


def _jaccard_similarity(self: Feature, other: Feature):
    """(MultiPickList, MultiPickList) → RealNN Jaccard overlap
    (RichSetFeature.jaccardSimilarity :124)."""
    from .ops.list_ops import JaccardSimilarity
    return self.transform_with(JaccardSimilarity(), other)


def _scaled(self: Feature, scaling_type: str = "linear", **kw):
    """Real → Real via ScalerTransformer (ScalerTransformer.scala);
    ``descaled`` inverts it from the scaler's recorded parameters."""
    from .ops.scalers import ScalerTransformer
    return self.transform_with(ScalerTransformer(
        scaling_type=scaling_type, **kw))


def _descaled(self: Feature, scaled: Feature, **kw):
    from .ops.scalers import DescalerTransformer
    return self.transform_with(DescalerTransformer(**kw), scaled)


def _filter_keys(self: Feature, allow=None, block=(), **kw):
    from .ops.maps import FilterMapKeys
    return self.transform_with(FilterMapKeys(allow=allow, block=block, **kw))


def _extract_key(self: Feature, key: str, **kw):
    from .ops.maps import ExtractMapKey
    return self.transform_with(ExtractMapKey(key=key, **kw))


def _apply_key_filters(feats, allow_keys, block_keys):
    """Key allow/block lists apply to every map feature of the group;
    given with no map feature present they raise (a dropped block list
    would leak a key)."""
    if allow_keys is None and not block_keys:
        return feats
    is_map = [f.ftype.column_kind is ft.ColumnKind.MAP for f in feats]
    if not any(is_map):
        raise ValueError(
            "allow_keys/block_keys were given but none of the features "
            "is map-typed — the key filter would be silently dropped")
    return [f.filter_keys(allow=allow_keys, block=block_keys) if m else f
            for f, m in zip(feats, is_map)]


def _vectorize(self: Feature, *others: Feature,
               top_k: Optional[int] = None,
               min_support: Optional[int] = None,
               track_nulls: Optional[bool] = None,
               track_invalid: Optional[bool] = None,
               num_features: Optional[int] = None,
               fill_with_mean: Optional[bool] = None,
               fill_with_mode: Optional[bool] = None,
               default_value: Optional[float] = None,
               allow_keys: Optional[Sequence[str]] = None,
               block_keys: Sequence[str] = ()):
    """This feature (+ same-typed ``others``) through the transmogrify
    dispatch with per-call overrides of its defaults; map features also
    take ``allow_keys`` / ``block_keys`` (RichMapFeature's
    whiteListKeys / blackListKeys)."""
    from .ops.transmogrifier import Transmogrifier
    from .ops.vectorizer_base import TransmogrifierDefaults

    feats = _apply_key_filters([self, *others], allow_keys, block_keys)

    class _Defaults(TransmogrifierDefaults):
        pass
    for attr, v in (("TOP_K", top_k), ("MIN_SUPPORT", min_support),
                    ("TRACK_NULLS", track_nulls),
                    ("TRACK_INVALID", track_invalid),
                    ("HASH_SIZE", num_features),
                    ("FILL_WITH_MEAN", fill_with_mean),
                    ("FILL_WITH_MODE", fill_with_mode),
                    ("FILL_VALUE", default_value)):
        if v is not None:
            setattr(_Defaults, attr, v)
    return Transmogrifier.vectorize(feats, _Defaults)


def _smart_vectorize(self: Feature, *others: Feature,
                     max_cardinality: int = 100,
                     top_k: Optional[int] = None,
                     min_support: Optional[int] = None,
                     num_features: Optional[int] = None,
                     track_nulls: bool = True,
                     track_text_len: bool = False,
                     allow_keys: Optional[Sequence[str]] = None,
                     block_keys: Sequence[str] = ()):
    """Cardinality-probing text vectorization (RichTextFeature
    ``smartVectorize`` :223-281 / RichMapFeature ``smartVectorize``
    :280-350): low-cardinality values pivot, high-cardinality values
    hash; text features and text-valued maps."""
    from .ops.maps import SmartTextMapVectorizer
    from .ops.smart_text import SmartTextVectorizer
    from .ops.vectorizer_base import TransmogrifierDefaults as TD

    kw = dict(max_cardinality=max_cardinality,
              top_k=TD.TOP_K if top_k is None else top_k,
              min_support=TD.MIN_SUPPORT if min_support is None
              else min_support,
              num_features=TD.HASH_SIZE if num_features is None
              else num_features,
              track_nulls=track_nulls, track_text_len=track_text_len)
    feats = _apply_key_filters([self, *others], allow_keys, block_keys)
    if self.ftype.column_kind is ft.ColumnKind.MAP:
        stage = SmartTextMapVectorizer(**kw)
    else:
        stage = SmartTextVectorizer(**kw)
    return feats[0].transform_with(stage, *feats[1:])


def _auto_bucketize(self: Feature, label: Feature, **kw):
    """Label-aware decision-tree bucketing (RichNumericFeature /
    RichMapFeature ``autoBucketize`` :542-664): the splits of a
    one-feature decision tree against the label."""
    from .ops.dt_bucketizer import (DecisionTreeNumericBucketizer,
                                    DecisionTreeNumericMapBucketizer)
    cls = (DecisionTreeNumericMapBucketizer
           if self.ftype.column_kind is ft.ColumnKind.MAP
           else DecisionTreeNumericBucketizer)
    return label.transform_with(cls(**kw), self)


Feature.__add__ = _binary_math("add")
Feature.__sub__ = _binary_math("subtract")
Feature.__mul__ = _binary_math("multiply")
Feature.__truediv__ = _binary_math("divide")
Feature.__radd__ = _binary_math("add")
Feature.__rmul__ = _binary_math("multiply")
Feature.__rsub__ = _rbinary_math("rsubtract")
Feature.__rtruediv__ = _rbinary_math("rdivide")
Feature.pivot = _pivot
Feature.fill_missing_with_mean = _fill_missing_with_mean
Feature.z_normalize = _z_normalize
Feature.map_to = _map_to
Feature.alias = _alias
Feature.sanity_check = _sanity_check
Feature.indexed = _indexed
Feature.bucketize = _bucketize
Feature.tf = _tf
Feature.idf = _idf
Feature.tfidf = _tfidf
Feature.ngram = _ngram
Feature.remove_stop_words = _remove_stop_words
Feature.jaccard_similarity = _jaccard_similarity
Feature.scaled = _scaled
Feature.descaled = _descaled
Feature.filter_keys = _filter_keys
Feature.extract_key = _extract_key
Feature.vectorize = _vectorize
Feature.smart_vectorize = _smart_vectorize
Feature.auto_bucketize = _auto_bucketize
