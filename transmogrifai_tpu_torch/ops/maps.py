"""Map vectorizers: each map key becomes a column of the map's element
kind, vectorized by that kind's scalar vectorizer; the port of
``transmogrifai_tpu/ops/maps.py`` (the ``OPMapVectorizer`` family:
``OPMapVectorizer.scala``, ``TextMapPivotVectorizer``,
``MultiPickListMapVectorizer``, ``SmartTextMapVectorizer``,
``GeolocationMapVectorizer``, ``DateMapToUnitCircleVectorizer``).

A fitted map vectorizer records the keys seen at fit time, explodes each
map feature into per-key child columns named ``{feature}::{key}`` and
hands them to a delegate: the scalar vectorizer model of the element
kind, built from the stage registry by class name. So every element kind
reuses its scalar counterpart's impute, pivot, hashing or unit-circle
math, on the device where that counterpart computes, and its metadata
layout, with ``grouping`` set to the map key.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

import numpy as np

from ..columns import (Column, ColumnStore, GeoColumn, MapColumn,
                       TextSetColumn, column_of_empty)
from ..features import Feature
from ..stages.base import (STAGE_REGISTRY, FixedArity, Transformer,
                           register_stage)
from ..types import feature_types as ft
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from . import dates, numeric, onehot, smart_text  # noqa: F401 (delegates)
from ._hostvec import flatten_ragged, value_counts
from .geo import GeolocationVectorizerModel, geo_mean  # noqa: F401
from .onehot import _sorted_topk
from .vectorizer_base import (TransmogrifierDefaults, VectorizerEstimator,
                              VectorizerModel)

__all__ = ["MapVectorizer", "MapVectorizerModel", "SmartTextMapVectorizer",
           "vectorize_maps", "FilterMapKeys", "ExtractMapKey"]


def _exploded_name(feature: str, key: str) -> str:
    return f"{feature}::{key}"


def _child_or_empty(col: MapColumn, key: str, elem_ftype) -> Column:
    child = col.children.get(key)
    if child is not None:
        return child
    return column_of_empty(elem_ftype, len(col))


def _explode(store: ColumnStore, names: Sequence[str],
             keys_per_feature: Sequence[Sequence[str]]) -> ColumnStore:
    cols = {}
    for name, keys in zip(names, keys_per_feature):
        col = store[name]
        assert isinstance(col, MapColumn), f"{name} is not a map column"
        for k in keys:
            cols[_exploded_name(name, k)] = _child_or_empty(
                col, k, col.ftype.element_type)
    return ColumnStore(cols, store.n_rows)


@register_stage
class MapVectorizerModel(VectorizerModel):
    """Fitted map vectorizer: keys + a delegate scalar vectorizer model."""

    operation_name = "vecMap"
    seq_type = ft.OPMap

    def __init__(self, keys_per_feature: Sequence[Sequence[str]] = (),
                 delegate_class: str = "NumericVectorizerModel",
                 delegate_params: Optional[dict] = None,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "RealMap",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keys_per_feature = [list(k) for k in keys_per_feature]
        self.delegate_class = delegate_class
        self.delegate_params = dict(delegate_params or {})
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name
        self._delegate = None

    @property
    def delegate(self) -> VectorizerModel:
        """The scalar model over the exploded columns, built once; it
        keeps its own device tables."""
        if self._delegate is None:
            exploded = [_exploded_name(n, k)
                        for n, keys in zip(self._names(),
                                           self.keys_per_feature)
                        for k in keys]
            self._delegate = STAGE_REGISTRY[self.delegate_class](
                input_names=exploded, **self.delegate_params)
        return self._delegate

    @property
    def device_math(self) -> bool:
        return self.delegate.device_math

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        return self.delegate.host_prepare(
            _explode(store, self._names(), self.keys_per_feature))

    def device_compute(self, prepared):
        return self.delegate.device_compute(prepared)

    def vector_metadata(self) -> VectorMetadata:
        cols = []
        for cm in self.delegate.vector_metadata().columns:
            feat, _, key = cm.parent_feature_name.partition("::")
            cols.append(VectorColumnMetadata(
                parent_feature_name=feat,
                parent_feature_type=self.ftype_name,
                grouping=key or cm.grouping,
                indicator_value=cm.indicator_value,
                descriptor_value=cm.descriptor_value))
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"keys_per_feature": self.keys_per_feature,
                "delegate_params": self.delegate_params,
                "input_names_saved": self._names()}


def _numeric_fill(col, elem: ft.ColumnKind, fill_with_mean: bool,
                  fill_with_mode: bool, base_fill: float) -> float:
    """A map key's fill: the train mean (real maps) or mode (integral
    maps, ties to the smallest) when asked for, else ``base_fill``."""
    if elem == ft.ColumnKind.REAL and fill_with_mean and col.mask.any():
        return float(col.values[col.mask].astype(np.float64).mean())
    if elem == ft.ColumnKind.INTEGRAL and fill_with_mode and col.mask.any():
        vals, counts = np.unique(col.values[col.mask], return_counts=True)
        return float(vals[np.argmax(counts)])
    return base_fill


@register_stage
class MapVectorizer(VectorizerEstimator):
    """Estimator: discover keys, fit the per-kind delegate
    (OPMapVectorizer.scala)."""

    operation_name = "vecMap"
    seq_type = ft.OPMap

    def __init__(self, top_k: int = TransmogrifierDefaults.TOP_K,
                 min_support: int = TransmogrifierDefaults.MIN_SUPPORT,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 default_value: Optional[float] = None,
                 fill_with_mean: bool = True,
                 fill_with_mode: bool = True,
                 uid: Optional[str] = None):
        """``default_value`` / ``fill_with_mean`` / ``fill_with_mode``:
        RichMapFeature.vectorize's fill surface
        (``core/.../dsl/RichMapFeature.scala:497-540,665-696``)."""
        super().__init__(uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.default_value = default_value
        self.fill_with_mean = fill_with_mean
        self.fill_with_mode = fill_with_mode

    def _discover_keys(self, store: ColumnStore) -> List[List[str]]:
        out = []
        for name in self.input_names:
            col = store[name]
            assert isinstance(col, MapColumn)
            out.append(sorted(col.children.keys()))
        return out

    def fit_columns(self, store: ColumnStore) -> MapVectorizerModel:
        ftype = self.input_features[0].ftype
        elem = ftype.map_element_kind
        keys = self._discover_keys(store)
        exploded = _explode(store, self.input_names, keys)
        cols = [exploded[n] for n in exploded.names()]
        if elem in (ft.ColumnKind.REAL, ft.ColumnKind.INTEGRAL,
                    ft.ColumnKind.BINARY):
            if issubclass(ftype.element_type, ft.Date):
                delegate_cls, params = "DateToUnitCircleVectorizer", {
                    "periods":
                        TransmogrifierDefaults.CIRCULAR_DATE_REPRESENTATIONS,
                    "track_nulls": self.track_nulls}
            else:
                base = (0.0 if self.default_value is None
                        else float(self.default_value))
                delegate_cls, params = "NumericVectorizerModel", {
                    "fill_values": [_numeric_fill(
                        c, elem, self.fill_with_mean, self.fill_with_mode,
                        base) for c in cols],
                    "track_nulls": self.track_nulls,
                    "ftype_name": ftype.__name__}
        elif elem in (ft.ColumnKind.TEXT, ft.ColumnKind.TEXT_SET):
            vocabs = [_sorted_topk(
                value_counts(flatten_ragged(c.values)[0]
                             if isinstance(c, TextSetColumn) else c.values),
                self.top_k, self.min_support) for c in cols]
            delegate_cls, params = "OneHotModel", {
                "vocabs": vocabs, "track_nulls": self.track_nulls,
                "ftype_name": ftype.__name__,
                "is_set": elem == ft.ColumnKind.TEXT_SET}
        elif elem == ft.ColumnKind.GEO:
            assert all(isinstance(c, GeoColumn) for c in cols)
            delegate_cls, params = "GeolocationVectorizerModel", {
                "fill_values": [geo_mean(c.values, c.mask) for c in cols],
                "track_nulls": self.track_nulls}
        else:
            raise TypeError(
                f"No map vectorizer for element kind {elem} "
                f"({ftype.__name__})")
        return MapVectorizerModel(
            keys_per_feature=keys, delegate_class=delegate_cls,
            delegate_params=params, input_names=self.input_names,
            ftype_name=ftype.__name__)


@register_stage
class SmartTextMapVectorizer(MapVectorizer):
    """TextMap smart vectorization (``RichMapFeature.smartVectorize``,
    ``core/.../dsl/RichMapFeature.scala:280-350``): each key gets the
    SmartText cardinality probe, so low-cardinality keys pivot and
    high-cardinality keys hash. The delegate is a
    ``SmartTextVectorizerModel`` over the exploded per-key columns."""

    operation_name = "smartVecTextMap"
    seq_type = ft.OPMap

    def __init__(self, max_cardinality: int = 100,
                 top_k: int = TransmogrifierDefaults.TOP_K,
                 min_support: int = TransmogrifierDefaults.MIN_SUPPORT,
                 num_features: int = TransmogrifierDefaults.HASH_SIZE,
                 track_nulls: bool = TransmogrifierDefaults.TRACK_NULLS,
                 track_text_len: bool = False,
                 uid: Optional[str] = None):
        super().__init__(top_k=top_k, min_support=min_support,
                         track_nulls=track_nulls, uid=uid)
        self.max_cardinality = max_cardinality
        self.num_features = num_features
        self.track_text_len = track_text_len

    def fit_columns(self, store: ColumnStore) -> MapVectorizerModel:
        ftype = self.input_features[0].ftype
        if ftype.map_element_kind is not ft.ColumnKind.TEXT:
            raise TypeError(
                f"smartVectorize needs a text-valued map, got "
                f"{ftype.__name__}")
        keys = self._discover_keys(store)
        exploded = _explode(store, self.input_names, keys)
        is_cat: List[bool] = []
        vocabs: List[List[str]] = []
        for name in exploded.names():
            stats = smart_text.TextStats(self.max_cardinality)
            for v in exploded[name].values:
                stats.add(v)
            is_cat.append(not stats.capped)
            if not stats.capped:
                vocabs.append(_sorted_topk(stats.counts, self.top_k,
                                           self.min_support))
        return MapVectorizerModel(
            keys_per_feature=keys, delegate_class="SmartTextVectorizerModel",
            delegate_params={
                "is_categorical": is_cat, "vocabs": vocabs,
                "num_features": self.num_features,
                "track_nulls": self.track_nulls,
                "track_text_len": self.track_text_len,
                "ftype_name": ftype.__name__},
            input_names=self.input_names, ftype_name=ftype.__name__)


def vectorize_maps(features: Sequence[Feature],
                   defaults: Type[TransmogrifierDefaults]) -> List[Feature]:
    """One MapVectorizer per concrete map type, in type-name order."""
    by_type: Dict[Type, List[Feature]] = {}
    for f in features:
        by_type.setdefault(f.ftype, []).append(f)
    out = []
    for _ftype, feats in sorted(by_type.items(),
                                key=lambda kv: kv[0].__name__):
        stage = MapVectorizer(top_k=defaults.TOP_K,
                              min_support=defaults.MIN_SUPPORT,
                              track_nulls=defaults.TRACK_NULLS,
                              default_value=defaults.FILL_VALUE,
                              fill_with_mean=defaults.FILL_WITH_MEAN,
                              fill_with_mode=defaults.FILL_WITH_MODE)
        out.append(feats[0].transform_with(stage, *feats[1:]))
    return out


# ---------------------------------------------------------------------------
# Map-feature DSL transformers (RichMapFeature), host
# ---------------------------------------------------------------------------

class _MapTransformer(Transformer):
    """One map input; the output feature's type follows the input's
    (``_output_ftype``)."""

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.output_type = ft.FeatureType    # refined in get_output

    @property
    def input_spec(self):
        return FixedArity(ft.OPMap)

    def _output_ftype(self, in_ftype):
        raise NotImplementedError

    def get_output(self) -> Feature:
        if self._output_feature is None:
            f = self.input_features[0]
            self._output_feature = Feature(
                name=self.make_output_name(),
                ftype=self._output_ftype(f.ftype),
                is_response=f.is_response, origin_stage=self,
                parents=self.input_features)
        return self._output_feature


@register_stage
class FilterMapKeys(_MapTransformer):
    """Map → the same map with keys kept by allow/block lists
    (RichMapFeature ``filter`` with whiteList/blackList keys)."""

    operation_name = "filterMapKeys"

    def __init__(self, allow: Optional[Sequence[str]] = None,
                 block: Sequence[str] = (), uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.allow = list(allow) if allow is not None else None
        self.block = list(block)

    def _output_ftype(self, in_ftype):
        return in_ftype

    def _keep(self, key: str) -> bool:
        if self.allow is not None and key not in self.allow:
            return False
        return key not in self.block

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        assert isinstance(col, MapColumn)
        return MapColumn(col.ftype, {k: c for k, c in col.children.items()
                                     if self._keep(k)}, len(col))


@register_stage
class ExtractMapKey(_MapTransformer):
    """Map → the element-typed column of one key (a missing key gives an
    all-null column), so one map entry can enter any scalar pipeline."""

    operation_name = "extractMapKey"

    def __init__(self, key: str = "", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.key = key

    def _output_ftype(self, in_ftype):
        return in_ftype.element_type

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        assert isinstance(col, MapColumn)
        return _child_or_empty(col, self.key, col.ftype.element_type)
