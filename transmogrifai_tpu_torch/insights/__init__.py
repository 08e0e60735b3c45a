"""Model interpretability — workflow-level and per-record insights; the port
of ``transmogrifai_tpu/insights``.

Parity targets: ``core/.../ModelInsights.scala``,
``core/.../impl/insights/RecordInsightsLOCO.scala`` and
``RecordInsightsCorr.scala``.
"""
from .corr import RecordInsightsCorr, RecordInsightsCorrModel  # noqa: F401
from .loco import RecordInsightsLOCO, parse_insights  # noqa: F401
from .model_insights import (DerivedFeatureInsight, FeatureInsights,  # noqa: F401
                             LabelSummary, ModelInsights)
