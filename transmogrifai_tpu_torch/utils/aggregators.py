"""Monoid aggregators and per-feature-type defaults; the port of
``transmogrifai_tpu/utils/aggregators.py``.

Parity: ``features/.../aggregators/MonoidAggregatorDefaults.scala:41-120``
and the concrete monoids in ``aggregators/{Numerics,Text,Maps,Geolocation,
Lists,Sets}.scala``. An aggregator folds a key's event values into one
value for event-grouped readers (``AggregateReader``); ``aggregator_of``
returns the reference's default per feature type:

    numerics → sum (Binary → logical or, Date → max, Percent → mean)
    text     → concat (PickList → mode)
    lists    → concat, sets → union, vectors → elementwise sum
    geo      → weighted midpoint, maps → per-key union with the value
               type's monoid

The fold expressions are those of the JAX package, term for term (numpy's
``sum`` and ``mean``, Python's ``max`` and ``min``): the columnar temporal
engine and the row-wise readers hand each key's values to the same
``fold``, and the stores equal the JAX package's bit for bit.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Type

import numpy as np

from ..types import feature_types as ft

__all__ = [
    "MonoidAggregator", "SumAggregator", "MeanAggregator", "MaxAggregator",
    "MinAggregator", "LogicalOrAggregator", "ModeAggregator",
    "ConcatTextAggregator", "ConcatListAggregator", "UnionSetAggregator",
    "CombineVectorAggregator", "GeolocationMidpointAggregator",
    "UnionMapAggregator", "FirstAggregator", "LastAggregator",
    "aggregator_of",
]


class MonoidAggregator:
    """fold(values) → one value; None/empty folds to None (the type's
    empty)."""

    def fold(self, values: Sequence[Any]):
        raise NotImplementedError


class _FnAggregator(MonoidAggregator):
    def __init__(self, fn: Callable[[List[Any]], Any], name: str):
        self._fn = fn
        self.name = name

    def fold(self, values: Sequence[Any]):
        vals = [v for v in values if v is not None]
        if not vals:
            return None
        return self._fn(vals)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class SumAggregator(_FnAggregator):
    def __init__(self):
        super().__init__(lambda v: float(np.sum(v)), "sum")


class MeanAggregator(_FnAggregator):
    def __init__(self):
        super().__init__(lambda v: float(np.mean(v)), "mean")


class MaxAggregator(_FnAggregator):
    def __init__(self):
        super().__init__(max, "max")


class MinAggregator(_FnAggregator):
    def __init__(self):
        super().__init__(min, "min")


class LogicalOrAggregator(_FnAggregator):
    def __init__(self):
        super().__init__(lambda v: bool(any(v)), "or")


class ModeAggregator(_FnAggregator):
    """Most frequent value, ties by value order (ModePickList)."""

    def __init__(self):
        def mode(vals):
            c = Counter(vals)
            return sorted(c.items(), key=lambda kv: (-kv[1], str(kv[0])))[0][0]
        super().__init__(mode, "mode")


class ConcatTextAggregator(_FnAggregator):
    def __init__(self, sep: str = " "):
        super().__init__(lambda v: sep.join(str(x) for x in v), "concat")


class ConcatListAggregator(_FnAggregator):
    def __init__(self):
        super().__init__(lambda v: [x for lst in v for x in lst], "concat")


class UnionSetAggregator(_FnAggregator):
    def __init__(self):
        super().__init__(lambda v: set().union(*[set(s) for s in v]),
                         "union")


class CombineVectorAggregator(_FnAggregator):
    """Elementwise sum of dense vectors (CombineVector)."""

    def __init__(self):
        super().__init__(
            lambda v: np.sum([np.asarray(x, np.float64) for x in v], axis=0),
            "combine")


class GeolocationMidpointAggregator(MonoidAggregator):
    """Spherical midpoint of (lat, lon, accuracy) triples
    (Geolocation.scala:134 midpoint via 3-D unit vectors)."""

    def fold(self, values: Sequence[Any]):
        pts = [v for v in values if v is not None]
        if not pts:
            return None
        lat = np.radians([p[0] for p in pts])
        lon = np.radians([p[1] for p in pts])
        x = np.cos(lat) * np.cos(lon)
        y = np.cos(lat) * np.sin(lon)
        z = np.sin(lat)
        mx, my, mz = x.mean(), y.mean(), z.mean()
        out_lat = np.degrees(np.arctan2(mz, np.hypot(mx, my)))
        out_lon = np.degrees(np.arctan2(my, mx))
        acc = max(p[2] for p in pts if len(p) > 2) if any(
            len(p) > 2 for p in pts) else 0.0
        return (float(out_lat), float(out_lon), float(acc))


class UnionMapAggregator(MonoidAggregator):
    """Per-key union: values under the same key fold with ``value_agg``
    (UnionRealMap / UnionConcatTextMap family)."""

    def __init__(self, value_agg: Optional[MonoidAggregator] = None):
        self.value_agg = value_agg or SumAggregator()

    def fold(self, values: Sequence[Any]):
        maps = [m for m in values if m]
        if not maps:
            return None
        keys: Dict[str, List[Any]] = {}
        for m in maps:
            for k, v in m.items():
                keys.setdefault(k, []).append(v)
        return {k: self.value_agg.fold(vs) for k, vs in keys.items()}


class FirstAggregator(_FnAggregator):
    """First non-empty event value (TimeBasedAggregator first)."""

    def __init__(self):
        super().__init__(lambda v: v[0], "first")


class LastAggregator(_FnAggregator):
    """Last non-empty event value (TimeBasedAggregator last)."""

    def __init__(self):
        super().__init__(lambda v: v[-1], "last")


def aggregator_of(ftype: Type[ft.FeatureType]) -> MonoidAggregator:
    """Default monoid per feature type
    (MonoidAggregatorDefaults.aggregatorOf)."""
    text_concat = (ft.Text, ft.TextArea, ft.Email, ft.Base64, ft.Phone,
                   ft.ID, ft.URL, ft.ComboBox, ft.Country, ft.State,
                   ft.City, ft.PostalCode, ft.Street)
    if ftype is ft.Binary:
        return LogicalOrAggregator()
    if ftype in (ft.Date, ft.DateTime):
        return MaxAggregator()
    if ftype is ft.Percent:
        return MeanAggregator()
    if issubclass(ftype, ft.OPNumeric):
        return SumAggregator()
    if ftype is ft.PickList:
        return ModeAggregator()
    if ftype in text_concat or (issubclass(ftype, ft.Text)
                                and not issubclass(ftype, ft.PickList)):
        return ConcatTextAggregator()
    if ftype is ft.Geolocation:
        return GeolocationMidpointAggregator()
    if ftype is ft.OPVector:
        return CombineVectorAggregator()
    if ftype is ft.MultiPickList or ftype.__name__.endswith("Set"):
        return UnionSetAggregator()
    if ftype.__name__.endswith("List"):
        return ConcatListAggregator()
    if ftype.__name__.endswith("Map") or ftype is ft.Prediction:
        if ftype in (ft.TextMap, ft.EmailMap, ft.PhoneMap, ft.IDMap,
                     ft.URLMap, ft.ComboBoxMap, ft.PickListMap,
                     ft.TextAreaMap, ft.Base64Map, ft.CountryMap,
                     ft.StateMap, ft.CityMap, ft.PostalCodeMap,
                     ft.StreetMap):
            return UnionMapAggregator(ConcatTextAggregator())
        if ftype in (ft.DateMap, ft.DateTimeMap):
            return UnionMapAggregator(MaxAggregator())
        if ftype is ft.PercentMap or ftype is ft.Prediction:
            return UnionMapAggregator(MeanAggregator())
        if ftype is ft.BinaryMap:
            return UnionMapAggregator(LogicalOrAggregator())
        if ftype is ft.GeolocationMap:
            return UnionMapAggregator(GeolocationMidpointAggregator())
        if ftype is ft.MultiPickListMap:
            return UnionMapAggregator(UnionSetAggregator())
        return UnionMapAggregator(SumAggregator())
    raise ValueError(
        f"No default aggregator mapping for feature type {ftype.__name__}")
