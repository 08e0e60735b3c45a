"""Transmogrifier — automatic feature engineering dispatch; the port of
``transmogrifai_tpu/ops/transmogrifier.py`` (``Transmogrifier.scala:92``).

Groups raw features by type, applies each type's default vectorizer and
combines the blocks into one OPVector:

=================================  =======================================
Real/RealNN/Percent/Currency       RealVectorizer (mean impute + null)
Integral                           IntegralVectorizer (mode impute + null)
Binary                             BinaryVectorizer
Date/DateTime                      DateToUnitCircleVectorizer
PickList/ComboBox/Country/State/
City/PostalCode/Street/ID          OneHotVectorizer (topK + OTHER + null)
Text/TextArea/Email/URL/Phone/
Base64                             SmartTextVectorizer (pivot|hash by card.)
MultiPickList                      SetVectorizer (multi-hot topK)
Geolocation                        GeolocationVectorizer (geo-mean fill)
TextList                           HashingVectorizerModel
DateList/DateTimeList              DateListVectorizer (days since last)
OPVector                           passthrough
the map types                      MapVectorizer, one per map type
                                   (``ops.maps.vectorize_maps``)
=================================  =======================================
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Type

from ..features import Feature
from ..types import feature_types as ft
from .date_list import DateListVectorizer
from .dates import DateToUnitCircleVectorizer
from .geo import GeolocationVectorizer
from .hashing import HashingVectorizerModel
from .maps import vectorize_maps
from .numeric import BinaryVectorizer, IntegralVectorizer, RealVectorizer
from .onehot import OneHotVectorizer, SetVectorizer
from .smart_text import SmartTextVectorizer
from .vectorizer_base import TransmogrifierDefaults
from .vectors import VectorsCombiner

__all__ = ["transmogrify", "Transmogrifier"]

# pivot (one-hot) text subtypes: closed-ish vocabularies
_PIVOT_TEXT = (ft.PickList, ft.ComboBox, ft.Country, ft.State, ft.City,
               ft.PostalCode, ft.Street, ft.ID)


def _group_features(features: Sequence[Feature]) -> Dict[str, List[Feature]]:
    groups: Dict[str, List[Feature]] = {}
    for f in features:
        t = f.ftype
        if issubclass(t, ft.Binary):
            key = "binary"
        elif issubclass(t, ft.Date):          # Date/DateTime before Integral
            key = "date"
        elif issubclass(t, ft.Integral):
            key = "integral"
        elif issubclass(t, ft.Real):
            key = "real"
        elif issubclass(t, ft.MultiPickList):
            key = "set"
        elif issubclass(t, _PIVOT_TEXT):
            key = "pivot_text"
        elif issubclass(t, ft.Text):
            key = "smart_text"
        elif issubclass(t, ft.Geolocation):
            key = "geo"
        elif issubclass(t, ft.TextList):
            key = "text_list"
        elif issubclass(t, ft.OPVector):
            key = "vector"
        elif issubclass(t, ft.DateList):
            key = "date_list"
        elif issubclass(t, ft.OPMap):
            key = "map"
        else:
            raise TypeError(
                f"Transmogrifier has no default vectorizer for {t.__name__}")
        groups.setdefault(key, []).append(f)
    return groups


class Transmogrifier:
    """Type-dispatch table (Transmogrifier.scala:92)."""

    @staticmethod
    def vectorize(features: Sequence[Feature],
                  defaults: Type[TransmogrifierDefaults] = TransmogrifierDefaults
                  ) -> Feature:
        if not features:
            raise ValueError("transmogrify needs at least one feature")
        groups = _group_features(features)
        blocks: List[Feature] = []

        def wire(stage, key) -> None:
            feats = groups[key]
            blocks.append(feats[0].transform_with(stage, *feats[1:]))

        d = defaults
        if "real" in groups:
            wire(RealVectorizer(track_nulls=d.TRACK_NULLS,
                                fill_with_mean=d.FILL_WITH_MEAN,
                                fill_value=d.FILL_VALUE), "real")
        if "integral" in groups:
            wire(IntegralVectorizer(track_nulls=d.TRACK_NULLS,
                                    fill_with_mode=d.FILL_WITH_MODE,
                                    fill_value=d.FILL_VALUE), "integral")
        if "binary" in groups:
            wire(BinaryVectorizer(track_nulls=d.TRACK_NULLS,
                                  fill_value=d.BINARY_FILL_VALUE), "binary")
        if "date" in groups:
            wire(DateToUnitCircleVectorizer(
                periods=d.CIRCULAR_DATE_REPRESENTATIONS,
                track_nulls=d.TRACK_NULLS,
                input_names=[f.name for f in groups["date"]]), "date")
        if "pivot_text" in groups:
            wire(OneHotVectorizer(top_k=d.TOP_K, min_support=d.MIN_SUPPORT,
                                  track_nulls=d.TRACK_NULLS), "pivot_text")
        if "smart_text" in groups:
            wire(SmartTextVectorizer(top_k=d.TOP_K, min_support=d.MIN_SUPPORT,
                                     num_features=d.HASH_SIZE,
                                     track_nulls=d.TRACK_NULLS),
                 "smart_text")
        if "set" in groups:
            wire(SetVectorizer(top_k=d.TOP_K, min_support=d.MIN_SUPPORT,
                               track_nulls=d.TRACK_NULLS), "set")
        if "geo" in groups:
            wire(GeolocationVectorizer(track_nulls=d.TRACK_NULLS), "geo")
        if "text_list" in groups:
            wire(HashingVectorizerModel(
                num_features=d.HASH_SIZE, track_nulls=d.TRACK_NULLS,
                input_names=[f.name for f in groups["text_list"]]),
                "text_list")
        if "map" in groups:
            blocks.extend(vectorize_maps(groups["map"], d))
        if "date_list" in groups:
            wire(DateListVectorizer(track_nulls=d.TRACK_NULLS), "date_list")
        blocks.extend(groups.get("vector", []))

        if len(blocks) == 1:
            return blocks[0]
        return blocks[0].transform_with(VectorsCombiner(), *blocks[1:])


def transmogrify(features: Sequence[Feature]) -> Feature:
    """One-call automated feature engineering: features → single OPVector."""
    return Transmogrifier.vectorize(features)
