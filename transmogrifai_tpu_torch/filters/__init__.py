"""Raw feature filtering — the pre-DAG data-quality gate; the port of
``transmogrifai_tpu/filters``.

Parity target: ``core/src/main/scala/com/salesforce/op/filters/``
(``RawFeatureFilter.scala``, ``FeatureDistribution.scala``,
``PreparedFeatures.scala``, ``RawFeatureFilterResults.scala``).
"""
from .distribution import FeatureDistribution, Summary  # noqa: F401
from .raw_feature_filter import (  # noqa: F401
    ExclusionReasons, FilteredRawData, RawFeatureFilter,
    RawFeatureFilterMetrics, RawFeatureFilterResults)
