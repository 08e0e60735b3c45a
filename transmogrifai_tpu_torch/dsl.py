"""Feature DSL — the port of ``transmogrifai_tpu/dsl.py``: every method
and operator the JAX package attaches to ``Feature``. The numeric math
transformers (``+ - * /`` of two features or of a feature and a scalar,
and the unary ``abs ceil floor round_to exp log sqrt power``),
``fill_missing_with_mean``, ``z_normalize``, ``pivot``, ``map_to``,
``alias``, ``transmogrify`` (RichFeaturesCollection.transmogrify),
``Feature.sanity_check``, label ``indexed`` / ``deindexed``, the Rich*
surfaces of maps, lists and sets (``vectorize`` with ``allow_keys`` /
``block_keys``, ``smart_vectorize``, ``filter_keys``, ``extract_key``,
``bucketize``, ``auto_bucketize``, ``tf``, ``idf``, ``tfidf``, ``ngram``,
``remove_stop_words``, ``jaccard_similarity``, ``scaled``, ``descaled``),
the text suite (``tokenize``, the email / URL / phone / MIME parsers,
``ngram_similarity``, ``count_vectorize``, ``lda``, ``word2vec``,
``detect_languages``, ``recognize_entities``, ``is_substring``),
calibration (``to_percentile``, ``to_isotonic_calibrated``), the value
operations (``replace_with``, ``filter_values``, ``filter_not``,
``collect``, ``exists``, ``occurs``), the conversions
(``to_multi_pick_list``, ``to_date_list``, ``to_date_time_list``,
``to_unit_circle``, ``combine``, ``vectorize_location``),
``drop_indices_by`` and ``tupled``. Importing the package attaches
them::

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

Each method builds the JAX package's stage with its defaults. Three of
them (``is_substring``, ``drop_indices_by``, ``tupled``) are an unnamed
``LambdaTransformer`` there, which no save can hold; here they are the
registered stages :class:`IsSubstringTransformer`,
:class:`DropIndicesByTransformer` and :class:`PredictionPartTransformer`
(same operation names and outputs), so a model that uses them saves and
loads. The DSL's own row functions are module functions, which
``utils.fn_io`` saves by name; a user's lambda is saved as code, as in
the JAX package.
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
           "MathUnaryTransformer", "FillMissingWithMean",
           "FillMissingWithMeanModel", "ScalarNormalizer",
           "ScalarNormalizerModel", "AliasTransformer", "MapTransformer",
           "ValueOpTransformer", "IsSubstringTransformer",
           "DropIndicesByTransformer", "PredictionPartTransformer",
           "transmogrify"]


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
    """Row-wise value map (RichFeature.map): ``fn`` of each raw value.
    The function round-trips through ``utils.fn_io`` (named functions by
    qualified name, lambdas by marshaled code)."""

    def __init__(self, fn: Callable[[Any], Any] = None,
                 input_type: Type[ft.FeatureType] = ft.FeatureType,
                 output_type: Type[ft.FeatureType] = ft.FeatureType,
                 operation_name: str = "map",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if isinstance(fn, dict):  # decoded from model.json
            from .utils.fn_io import decode_fn
            fn = decode_fn(fn)
        self.fn = fn
        self._input_type = input_type
        self.output_type = output_type
        self.operation_name = operation_name

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(self._input_type)

    def get_params(self):
        from .utils.fn_io import encode_fn
        p = super().get_params()
        p["fn"] = encode_fn(self.fn)
        p["input_type"] = self._input_type
        return p

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        return column_from_values(
            self.output_type, [self.fn(col.get_raw(i))
                               for i in range(len(col))])


@register_stage
class MathUnaryTransformer(Transformer):
    """Unary numeric math (abs/ceil/floor/round/exp/log/sqrt/power —
    ``RichNumericFeature.scala`` unary surface + ``MathTransformers``).
    Domain violations (log of ≤0, sqrt of <0, non-finite results) null
    the row, matching the reference's Option-returning transformers."""

    output_type = ft.Real

    def __init__(self, op: str = "abs", arg: float = 0.0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.op = op
        self.arg = float(arg)
        self.operation_name = {
            "abs": "abs", "ceil": "ceil", "floor": "floor",
            "round": "round", "exp": "exp", "log": "logN",
            "sqrt": "sqrt", "power": "power"}[op]

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPNumeric)

    def transform_columns(self, store: ColumnStore) -> Column:
        a = _num_col(store, self.input_features[0])
        av = a.values.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            vals = {
                "abs": lambda: np.abs(av),
                "ceil": lambda: np.ceil(av),
                "floor": lambda: np.floor(av),
                "round": lambda: np.round(av, int(self.arg)),
                "exp": lambda: np.exp(av),
                # log base arg (reference log(base); default natural)
                "log": lambda: (np.log(av) if self.arg in (0.0, np.e)
                                else np.log(av) / np.log(self.arg)),
                "sqrt": lambda: np.sqrt(av),
                "power": lambda: np.power(av, self.arg),
            }[self.op]()
        mask = a.mask & np.isfinite(vals)
        return NumericColumn(ft.Real, np.where(mask, vals, 0.0), mask)


@register_stage
class ValueOpTransformer(Transformer):
    """RichFeature value-surface ops (replaceWith / filter / filterNot /
    collect / exists / occurs, ``RichFeature.scala:61-205``) as one
    registered stage: the op's semantics live here, and only the user's
    predicate is serialized (``utils.fn_io``, as ``MapTransformer``)."""

    def __init__(self, op: str = "exists", fn: Callable[[Any], Any] = None,
                 default: Any = None, old_val: Any = None,
                 new_val: Any = None,
                 input_type: Type[ft.FeatureType] = ft.FeatureType,
                 output_type: Type[ft.FeatureType] = ft.FeatureType,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if isinstance(fn, dict):        # decoded from model.json
            from .utils.fn_io import decode_fn
            fn = decode_fn(fn)
        self.op = op
        self.fn = fn
        self.default = default
        self.old_val = old_val
        self.new_val = new_val
        self._input_type = input_type
        self.output_type = output_type
        self.operation_name = op

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(self._input_type)

    def get_params(self):
        from .utils.fn_io import encode_fn
        p = super().get_params()
        p["fn"] = encode_fn(self.fn) if self.fn is not None else None
        p["input_type"] = self._input_type
        return p

    @staticmethod
    def _present(v) -> bool:
        if v is None:
            return False
        if isinstance(v, (list, set, dict, str)):
            return len(v) > 0
        return True

    def _apply(self, v):
        op, fn = self.op, self.fn
        if op == "replaceWith":
            return self.new_val if v == self.old_val else v
        if op == "filter":
            return v if fn(v) else self.default
        if op == "filterNot":
            return self.default if fn(v) else v
        if op == "collect":
            out = fn(v)
            return self.default if out is None else out
        if op == "exists":
            return bool(v is not None and fn(v))
        if op == "occurs":
            if fn is None:
                return 1.0 if self._present(v) else 0.0
            return 1.0 if (v is not None and fn(v)) else 0.0
        raise ValueError(f"unknown value op {op!r}")

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        return column_from_values(
            self.output_type,
            [self._apply(col.get_raw(i)) for i in range(len(col))])


@register_stage
class IsSubstringTransformer(Transformer):
    """(Text, Text) → Binary: is the first a case-insensitive substring of
    the second (RichTextFeature.isSubstring :445)."""

    operation_name = "isSubstring"
    output_type = ft.Binary

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.Text, ft.Text)

    def transform_columns(self, store: ColumnStore) -> Column:
        a_col = store[self.input_features[0].name]
        b_col = store[self.input_features[1].name]
        n = len(a_col)
        vals = np.zeros((n,), np.float64)
        mask = np.zeros((n,), bool)
        for i in range(n):
            a, b = a_col.get_raw(i), b_col.get_raw(i)
            if a is not None and b is not None:
                mask[i] = True
                vals[i] = float(str(a).lower() in str(b).lower())
        return NumericColumn(ft.Binary, vals, mask)


@register_stage
class DropIndicesByTransformer(Transformer):
    """OPVector → OPVector without the columns whose metadata
    ``match_fn`` selects (RichVectorFeature.dropIndicesBy :139 →
    DropIndicesByTransformer); needs vector metadata."""

    operation_name = "dropIndicesBy"
    output_type = ft.OPVector

    def __init__(self, match_fn: Callable[[Any], bool] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if isinstance(match_fn, dict):   # decoded from model.json
            from .utils.fn_io import decode_fn
            match_fn = decode_fn(match_fn)
        self.match_fn = match_fn

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPVector)

    def get_params(self):
        from .utils.fn_io import encode_fn
        p = super().get_params()
        p["match_fn"] = encode_fn(self.match_fn)
        return p

    def transform_columns(self, store: ColumnStore) -> Column:
        from .columns import VectorColumn
        col = store[self.input_features[0].name]
        # explicit ValueErrors: input validation survives ``python -O``
        if not isinstance(col, VectorColumn):
            raise ValueError(
                f"dropIndicesBy needs an OPVector column, got "
                f"{type(col).__name__}")
        if col.metadata is None:
            raise ValueError(
                "dropIndicesBy needs a metadata-carrying OPVector "
                "(vectorizer outputs always carry metadata)")
        keep = [i for i, cm in enumerate(col.metadata.columns)
                if not self.match_fn(cm)]
        return VectorColumn(ft.OPVector, col.values[:, keep],
                            col.metadata.select(keep))


#: PredictionPartTransformer parts: (operation name, output type)
_PREDICTION_PARTS = {"prediction": ("predictionValue", ft.RealNN),
                     "raw": ("rawPrediction", ft.OPVector),
                     "probability": ("probability", ft.OPVector)}


@register_stage
class PredictionPartTransformer(Transformer):
    """Prediction → one of its parts: the prediction (RealNN), the raw
    prediction or the probability (OPVector) — the three stages of
    RichPredictionFeature.tupled (:1098-1111)."""

    def __init__(self, part: str = "prediction", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.part = part
        self.operation_name, self.output_type = _PREDICTION_PARTS[part]

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.Prediction)

    def transform_columns(self, store: ColumnStore) -> Column:
        from .columns import VectorColumn
        c = store[self.input_features[0].name]
        if self.part == "prediction":
            return NumericColumn(ft.RealNN, np.asarray(c.prediction),
                                 np.ones(len(c), bool))
        return VectorColumn(ft.OPVector, np.asarray(
            c.raw_prediction if self.part == "raw" else c.probability))


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


def _unary_math(op):
    def method(self: Feature, arg: float = 0.0):
        return self.transform_with(MathUnaryTransformer(op=op, arg=arg))
    method.__name__ = f"_{op}"
    method.__doc__ = (f"Numeric → Real {op} "
                      "(RichNumericFeature unary math surface).")
    return method


def _tokenize(self: Feature, **kw):
    from .ops.text import TextTokenizer
    return self.transform_with(TextTokenizer(**kw))


def _to_email_prefix(self: Feature):
    from .ops.text_suite import EmailParser
    return self.transform_with(EmailParser(part="prefix"))


def _to_email_domain(self: Feature):
    from .ops.text_suite import EmailParser
    return self.transform_with(EmailParser(part="domain"))


def _to_url_protocol(self: Feature):
    from .ops.text_suite import UrlParser
    return self.transform_with(UrlParser(part="protocol"))


def _to_url_domain(self: Feature):
    from .ops.text_suite import UrlParser
    return self.transform_with(UrlParser(part="domain"))


def _is_valid_phone(self: Feature, default_region: str = "US"):
    from .ops.text_suite import PhoneNumberParser
    return self.transform_with(
        PhoneNumberParser(default_region=default_region, output="valid"))


def _parse_phone(self: Feature, default_region: str = "US"):
    """Phone → Text national number (RichTextFeature.parsePhone :464)."""
    from .ops.text_suite import PhoneNumberParser
    return self.transform_with(PhoneNumberParser(
        default_region=default_region, output="national"))


def _detect_mime_types(self: Feature):
    from .ops.text_suite import MimeTypeDetector
    return self.transform_with(MimeTypeDetector())


def _ngram_similarity(self: Feature, other: Feature, n: int = 3):
    from .ops.text_suite import NGramSimilarity
    return self.transform_with(NGramSimilarity(n=n), other)


def _count_vectorize(self: Feature, *others: Feature, **kw):
    from .ops.text_suite import OpCountVectorizer
    return self.transform_with(OpCountVectorizer(**kw), *others)


def _detect_languages(self: Feature):
    """Text → RealMap of language-confidence scores
    (RichTextFeature.detectLanguages :403)."""
    from .ops.text_suite import LanguageDetector
    return self.transform_with(LanguageDetector())


def _recognize_entities(self: Feature):
    """Text → MultiPickList of entity spans
    (RichTextFeature.recognizeEntities :420)."""
    from .ops.text_suite import NameEntityRecognizer
    return self.transform_with(NameEntityRecognizer())


def _is_substring(self: Feature, other: Feature):
    """Binary: is this text a (case-insensitive) substring of ``other``
    (RichTextFeature.isSubstring :445)."""
    return self.transform_with(IsSubstringTransformer(), other)


def _lda(self: Feature, n_topics: int = 10, **kw):
    from .ops.topics import OpLDA
    return self.transform_with(OpLDA(n_topics=n_topics, **kw))


def _word2vec(self: Feature, **kw):
    """Estimator defaults (dim=100, window=5 — Spark ml Word2Vec parity,
    ``ops/topics.py``); keyword arguments pass through untouched."""
    from .ops.topics import OpWord2Vec
    return self.transform_with(OpWord2Vec(**kw))


def _to_unit_circle(self: Feature, **kw):
    from .ops.dates import DateToUnitCircleVectorizer
    return self.transform_with(DateToUnitCircleVectorizer(**kw))


def _combine(self: Feature, *others: Feature):
    from .ops.vectors import VectorsCombiner
    return self.transform_with(VectorsCombiner(), *others)


def _to_percentile(self: Feature, **kw):
    from .ops.calibrators import PercentileCalibrator
    return self.transform_with(PercentileCalibrator(**kw))


def _to_isotonic_calibrated(self: Feature, label: Feature,
                            isotonic: bool = True):
    """RealNN score → isotonic-calibrated score
    (RichNumericFeature.toIsotonicCalibrated →
    IsotonicRegressionCalibrator.scala)."""
    from .ops.calibrators import IsotonicRegressionCalibrator
    return label.transform_with(
        IsotonicRegressionCalibrator(isotonic=isotonic), self)


def _deindexed(self: Feature, prediction: Feature, **kw):
    """``label.deindexed(prediction)``: predicted indices → label strings
    (PredictionDeIndexer)."""
    from .ops.indexers import PredictionDeIndexer
    return self.transform_with(PredictionDeIndexer(**kw), prediction)


# -- the DSL's row functions: module functions, saved by name ---------------

def _valid_email_value(v):
    from .ops.text_suite import parse_email
    return None if v is None else parse_email(v)[0] is not None


def _valid_url_value(v):
    from .ops.text_suite import parse_url
    return None if v is None else parse_url(v)[0] is not None


def _as_set(v):
    return set(v or ())


def _as_time_list(v):
    return [] if v is None else [int(v)]


def _email_domain_map(m):
    from .ops.text_suite import parse_email
    out = {}
    for k, v in (m or {}).items():
        d = parse_email(v)[1]
        if d is not None:
            out[k] = d
    return out


def _url_domain_map(m):
    from .ops.text_suite import parse_url
    out = {}
    for k, v in (m or {}).items():
        proto, domain = parse_url(v)[:2]
        if proto is not None and domain is not None:
            out[k] = domain
    return out


def _valid_phone_map_us(m):
    from .ops.text_suite import parse_phone
    return {k: parse_phone(v, "US")[0] for k, v in (m or {}).items()}


def _is_valid_email(self: Feature):
    """Email → Binary validity (RichTextFeature.isValidEmail :591); the
    grammar of to_email_prefix / to_email_domain (``parse_email``)."""
    return _map_to(self, _valid_email_value, ft.Binary, "isValidEmail")


def _is_valid_url(self: Feature):
    """URL → Binary validity (RichTextFeature.isValidUrl :642); the
    grammar of to_url_protocol / to_url_domain (``parse_url``)."""
    return _map_to(self, _valid_url_value, ft.Binary, "isValidUrl")


def _to_multi_pick_list(self: Feature):
    """TextList → MultiPickList (RichTextFeature.toMultiPickList :58)."""
    return _map_to(self, _as_set, ft.MultiPickList, "toMultiPickList")


def _to_date_list(self: Feature):
    """Date → DateList of the single timestamp (RichDateFeature.toDateList
    :54-60); empty date → empty list."""
    return _map_to(self, _as_time_list, ft.DateList, "toDateList")


def _to_date_time_list(self: Feature):
    """DateTime → DateTimeList (RichDateFeature.toDateTimeList :124-130)."""
    return _map_to(self, _as_time_list, ft.DateTimeList, "toDateTimeList")


def _to_email_domain_map(self: Feature):
    """EmailMap → PickListMap of email domains — the extraction half of
    RichEmailMapFeature.vectorize (:968-1004)."""
    return _map_to(self, _email_domain_map, ft.PickListMap,
                   "emailMapToPickListMap")


def _to_url_domain_map(self: Feature):
    """URLMap → PickListMap of domains of valid URLs — the extraction
    half of RichURLMapFeature.vectorize (:1040-1096)."""
    return _map_to(self, _url_domain_map, ft.PickListMap,
                   "urlMapToPickListMap")


def _is_valid_phone_map(self: Feature, default_region: str = "US"):
    """PhoneMap → BinaryMap of per-key phone validity
    (RichPhoneMapFeature.isValidPhoneDefaultCountryMap :945-958)."""
    if default_region == "US":
        fn = _valid_phone_map_us
    else:
        from .ops.text_suite import parse_phone

        def fn(m):
            return {k: parse_phone(v, default_region)[0]
                    for k, v in (m or {}).items()}
    return _map_to(self, fn, ft.BinaryMap, "isValidPhoneMapDefaultCountry")


def _vectorize_location(self: Feature, *others: Feature,
                        top_k: Optional[int] = None,
                        min_support: Optional[int] = None,
                        track_nulls: bool = True):
    """Location-text pivot (RichLocationFeature.vectorize :50-76): top-K
    one-hot + OTHER (+ null) columns."""
    from .ops.onehot import OneHotVectorizer
    from .ops.vectorizer_base import TransmogrifierDefaults as TD
    stage = OneHotVectorizer(
        top_k=TD.TOP_K if top_k is None else top_k,
        min_support=TD.MIN_SUPPORT if min_support is None else min_support,
        track_nulls=track_nulls)
    return self.transform_with(stage, *others)


def _value_op(self: Feature, output_type, **kw):
    stage = ValueOpTransformer(input_type=self.ftype,
                               output_type=output_type, **kw)
    stage.set_input(self)
    return stage.get_output()


def _replace_with(self: Feature, old_val, new_val):
    """Swap one value for another, same type (RichFeature.replaceWith
    :75-77)."""
    return _value_op(self, self.ftype, op="replaceWith",
                     old_val=old_val, new_val=new_val)


def _filter_values(self: Feature, predicate, default):
    """Keep values passing ``predicate``; others become ``default``
    (RichFeature.filter :134-140)."""
    return _value_op(self, self.ftype, op="filter", fn=predicate,
                     default=default)


def _filter_not(self: Feature, predicate, default):
    """RichFeature.filterNot (:148-150)."""
    return _value_op(self, self.ftype, op="filterNot", fn=predicate,
                     default=default)


def _collect(self: Feature, fn, default, output_type=None):
    """Partial transform: ``fn(value)`` where it returns non-None, else
    ``default`` (RichFeature.collect :160-168)."""
    return _value_op(self, output_type or self.ftype, op="collect",
                     fn=fn, default=default)


def _exists(self: Feature, predicate):
    """Binary: does the (non-null) value satisfy ``predicate``
    (RichFeature.exists :176-182)."""
    return _value_op(self, ft.Binary, op="exists", fn=predicate)


def _occurs(self: Feature, match_fn=None):
    """RealNN 1.0/0.0 occurrence indicator (RichFeature.occurs
    :190-205): default = value is present/non-empty."""
    return _value_op(self, ft.RealNN, op="occurs", fn=match_fn)


def _drop_indices_by(self: Feature, match_fn):
    """OPVector → OPVector with the metadata-matched columns dropped
    (RichVectorFeature.dropIndicesBy :139): ``match_fn(
    VectorColumnMetadata) -> bool`` selects the columns to drop."""
    return self.transform_with(DropIndicesByTransformer(match_fn=match_fn))


def _tupled(self: Feature):
    """Prediction → (prediction RealNN, rawPrediction OPVector,
    probability OPVector) (RichPredictionFeature.tupled :1098-1111)."""
    return tuple(self.transform_with(PredictionPartTransformer(part=p))
                 for p in ("prediction", "raw", "probability"))


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
Feature.abs = _unary_math("abs")
Feature.ceil = _unary_math("ceil")
Feature.floor = _unary_math("floor")
Feature.round_to = _unary_math("round")
Feature.exp = _unary_math("exp")
Feature.log = _unary_math("log")
Feature.sqrt = _unary_math("sqrt")
Feature.power = _unary_math("power")
Feature.tokenize = _tokenize
Feature.to_email_prefix = _to_email_prefix
Feature.to_email_domain = _to_email_domain
Feature.to_url_protocol = _to_url_protocol
Feature.to_url_domain = _to_url_domain
Feature.is_valid_email = _is_valid_email
Feature.is_valid_url = _is_valid_url
Feature.is_valid_phone = _is_valid_phone
Feature.parse_phone = _parse_phone
Feature.detect_mime_types = _detect_mime_types
Feature.to_email_domain_map = _to_email_domain_map
Feature.to_url_domain_map = _to_url_domain_map
Feature.is_valid_phone_map = _is_valid_phone_map
Feature.ngram_similarity = _ngram_similarity
Feature.count_vectorize = _count_vectorize
Feature.lda = _lda
Feature.word2vec = _word2vec
Feature.detect_languages = _detect_languages
Feature.recognize_entities = _recognize_entities
Feature.is_substring = _is_substring
Feature.to_percentile = _to_percentile
Feature.to_isotonic_calibrated = _to_isotonic_calibrated
Feature.deindexed = _deindexed
Feature.tupled = _tupled
Feature.replace_with = _replace_with
Feature.filter_values = _filter_values
Feature.filter_not = _filter_not
Feature.collect = _collect
Feature.exists = _exists
Feature.occurs = _occurs
Feature.drop_indices_by = _drop_indices_by
Feature.to_multi_pick_list = _to_multi_pick_list
Feature.to_date_list = _to_date_list
Feature.to_date_time_list = _to_date_time_list
Feature.to_unit_circle = _to_unit_circle
Feature.combine = _combine
Feature.vectorize_location = _vectorize_location
