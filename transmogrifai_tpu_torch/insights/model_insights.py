"""ModelInsights — a fitted workflow's interpretability report; the port of
``transmogrifai_tpu/insights/model_insights.py``, host numpy as there.

Parity: ``core/.../ModelInsights.scala:72-110`` (``LabelSummary`` :291,
``FeatureInsights`` :336, ``Insights`` :372): merges the label summary,
per-derived-column insights (correlation, Cramér's V, model contribution,
SanityChecker drop reasons, RawFeatureFilter metrics), the selected model's
validation results, and stage lineage into one JSON-able report.

The heavy statistics are not recomputed here: they are harvested from the
fitted stages (the SanityCheckerModel summary, the ModelSelectorSummary,
the RawFeatureFilter results), as the reference reads stage metadata
rather than data. Only the final vector's metadata needs the data: the
workflow's layers up to the vector run on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..columns import ColumnStore, NumericColumn, VectorColumn
from ..features import Feature
from ..types.feature_types import Prediction
from ..vector_metadata import VectorMetadata

__all__ = ["LabelSummary", "DerivedFeatureInsight", "FeatureInsights",
           "ModelInsights"]


@dataclass
class LabelSummary:
    """Label name + distribution (ModelInsights.LabelSummary :291)."""

    name: str
    is_categorical: bool = False
    distribution: Dict[str, float] = field(default_factory=dict)
    sample_size: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"labelName": self.name, "categorical": self.is_categorical,
                "distribution": self.distribution,
                "sampleSize": self.sample_size}


@dataclass
class DerivedFeatureInsight:
    """One derived vector slot's insight row (FeatureInsights derived)."""

    column_name: str
    parent_feature: Optional[str] = None
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    corr_with_label: Optional[float] = None
    mean: Optional[float] = None
    variance: Optional[float] = None
    cramers_v: Optional[float] = None
    contribution: Optional[float] = None
    dropped: bool = False
    drop_reasons: List[str] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"derivedFeatureName": self.column_name,
                "parentFeatureOrigins": self.parent_feature,
                "grouping": self.grouping,
                "indicatorValue": self.indicator_value,
                "corr": self.corr_with_label, "mean": self.mean,
                "variance": self.variance, "cramersV": self.cramers_v,
                "contribution": self.contribution,
                "dropped": self.dropped, "dropReasons": self.drop_reasons}


@dataclass
class FeatureInsights:
    """Per raw feature: its derived columns + RFF metrics."""

    feature_name: str
    feature_type: str = ""
    derived: List[DerivedFeatureInsight] = field(default_factory=list)
    rff_metrics: Optional[Dict[str, Any]] = None
    rff_exclusion: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"featureName": self.feature_name,
                "featureType": self.feature_type,
                "derivedFeatures": [d.to_json() for d in self.derived],
                "rawFeatureFilterMetrics": self.rff_metrics,
                "rawFeatureFilterExclusion": self.rff_exclusion}


class ModelInsights:
    """The merged report (ModelInsights.scala:72-110)."""

    def __init__(self, label: LabelSummary,
                 features: List[FeatureInsights],
                 selected_model_info: Dict[str, Any],
                 problem_type: str = "",
                 stage_info: Optional[Dict[str, Any]] = None):
        self.label = label
        self.features = features
        self.selected_model_info = selected_model_info
        self.problem_type = problem_type
        self.stage_info = stage_info or {}

    # -- extraction --------------------------------------------------------
    @staticmethod
    def extract(workflow_model, pred_feature: Optional[Feature] = None,
                store: Optional[ColumnStore] = None,
                device=None) -> "ModelInsights":
        """Harvest insights from a fitted WorkflowModel.

        ``store``: optional training/scoring data — supplies the label
        distribution and the final vector metadata when given (the layers
        up to the vector run on ``device``, default the card).
        """
        pred_feature = pred_feature or next(
            (f for f in workflow_model.result_features
             if issubclass(f.ftype, Prediction)), None)
        if pred_feature is None:
            raise ValueError("No Prediction result feature in this workflow")

        selected = workflow_model.stage_of(pred_feature)
        label_f = selected.input_features[0]
        vector_f = selected.input_features[1]

        # sanity checker (walk up from the model's vector input)
        sanity = None
        st = vector_f.origin_stage
        if st is not None:
            cand = workflow_model.fitted_stages.get(st.uid)
            if cand is not None and hasattr(cand, "summary_") \
                    and cand.summary_ is not None:
                sanity = cand

        meta = ModelInsights._vector_metadata(workflow_model, vector_f, store,
                                              device)
        contributions = ModelInsights._contributions(selected)

        label = ModelInsights._label_summary(label_f, store)
        features = ModelInsights._feature_insights(
            vector_f, sanity, meta, contributions, workflow_model)

        sel_info: Dict[str, Any] = {}
        summ = getattr(selected, "selector_summary", None)
        if summ is not None:
            sel_info = summ.to_json()
        else:
            s = getattr(selected, "summary", None)
            if callable(s):
                sel_info = s()

        task = getattr(selected, "task", "")
        stage_info = {
            uid: type(m).__name__
            for uid, m in workflow_model.fitted_stages.items()}
        return ModelInsights(label, features, sel_info, task, stage_info)

    @staticmethod
    def _vector_metadata(workflow_model, vector_f: Feature,
                         store: Optional[ColumnStore], device=None
                         ) -> Optional[VectorMetadata]:
        if store is None:
            return None
        out = workflow_model.transform(store, device=device, up_to=vector_f)
        col = out.get(vector_f.name)
        if isinstance(col, VectorColumn):
            return col.metadata
        return None

    @staticmethod
    def _label_summary(label_f: Feature,
                       store: Optional[ColumnStore]) -> LabelSummary:
        summary = LabelSummary(name=label_f.name)
        if store is not None and label_f.name in store:
            col = store[label_f.name]
            if isinstance(col, NumericColumn):
                y = col.values.astype(np.float64)
                summary.sample_size = int(y.size)
                uniq, counts = np.unique(y, return_counts=True)
                if uniq.size <= 30:
                    summary.is_categorical = True
                    summary.distribution = {
                        str(u): int(c) for u, c in zip(uniq, counts)}
                else:
                    summary.distribution = {
                        "min": float(y.min()), "max": float(y.max()),
                        "mean": float(y.mean()), "variance": float(y.var())}
        return summary

    @staticmethod
    def _contributions(selected) -> Optional[np.ndarray]:
        """Per-slot importance from the winning model: |coef| for linear
        heads, split-frequency importance for tree ensembles."""
        inner = getattr(selected, "inner", selected)
        coef = getattr(inner, "coefficients", None)
        if coef is not None:
            c = np.abs(np.asarray(coef, dtype=np.float64))
            return c.mean(axis=0) if c.ndim == 2 else c
        trees = getattr(inner, "trees", None)
        if trees and "feat" in trees and "thr" in trees:
            feat = np.asarray(trees["feat"])      # [n_trees, n_nodes]
            thr = np.asarray(trees["thr"])
            mask = np.isfinite(thr)               # real splits only
            used = feat[mask].astype(np.int64)
            if used.size:
                gain = trees.get("gain")
                if gain is not None:
                    # gain-weighted impurity reduction — the reference's
                    # featureImportances semantics (treeinterpreter style);
                    # XGB gains can be negative under its -inf split floor
                    w = np.maximum(
                        np.asarray(gain, dtype=np.float64)[mask], 0.0)
                else:  # older saved models: split-frequency fallback
                    w = np.ones(used.shape, dtype=np.float64)
                d = int(used.max()) + 1
                imp = np.bincount(used, weights=w, minlength=d)
                tot = imp.sum()
                if tot <= 0:   # e.g. XGB where every gain clipped to 0
                    imp = np.bincount(used, minlength=d).astype(np.float64)
                    tot = imp.sum()
                return imp / tot if tot > 0 else imp
        return None

    @staticmethod
    def _feature_insights(vector_f: Feature, sanity, meta, contributions,
                          workflow_model) -> List[FeatureInsights]:
        derived: List[DerivedFeatureInsight] = []
        stats_by_name: Dict[str, Dict[str, Any]] = {}
        dropped_by_name: Dict[str, List[str]] = {}
        cramers_by_group: Dict[str, float] = {}
        if sanity is not None:
            s = sanity.summary_
            for cs in s.column_stats:
                stats_by_name[cs["name"]] = cs
            for dr in s.dropped:
                dropped_by_name[dr["name"]] = dr["reasons"]
            for cs in s.categorical_stats:
                cramers_by_group[cs["group"]] = cs["cramersV"]

        if meta is not None and meta.size:
            kept_names = meta.column_names()
            for i, cm in enumerate(meta.columns):
                st = stats_by_name.get(cm.column_name(), {})
                group = (f"{cm.parent_feature_name}_{cm.grouping}"
                         if cm.grouping else None)
                derived.append(DerivedFeatureInsight(
                    column_name=kept_names[i],
                    parent_feature=cm.parent_feature_name,
                    grouping=cm.grouping,
                    indicator_value=cm.indicator_value,
                    corr_with_label=st.get("corrWithLabel"),
                    mean=st.get("mean"), variance=st.get("variance"),
                    cramers_v=cramers_by_group.get(group) if group else None,
                    contribution=(float(contributions[i])
                                  if contributions is not None
                                  and i < len(contributions) else None)))
            # dropped columns are absent from the kept metadata — surface
            # them from the sanity summary so drop reasons aren't lost
            present = set(kept_names)
            for name, rs in dropped_by_name.items():
                if name not in present:
                    st = stats_by_name.get(name, {})
                    derived.append(DerivedFeatureInsight(
                        column_name=name,
                        corr_with_label=st.get("corrWithLabel"),
                        mean=st.get("mean"), variance=st.get("variance"),
                        dropped=True, drop_reasons=rs))
        elif stats_by_name:
            kept = set()
            if sanity is not None and getattr(sanity, "keep_indices", None):
                kept = {sanity.summary_.names[i] for i in sanity.keep_indices}
            j = 0
            for name, st in stats_by_name.items():
                contrib = None
                if name in kept and contributions is not None \
                        and j < len(contributions):
                    contrib = float(contributions[j])
                if name in kept:
                    j += 1
                derived.append(DerivedFeatureInsight(
                    column_name=name,
                    corr_with_label=st.get("corrWithLabel"),
                    mean=st.get("mean"), variance=st.get("variance"),
                    contribution=contrib,
                    dropped=name in dropped_by_name,
                    drop_reasons=dropped_by_name.get(name, [])))

        for d in derived:
            if d.column_name in dropped_by_name:
                d.dropped = True
                d.drop_reasons = dropped_by_name[d.column_name]

        # group by parent raw feature; RFF metrics attach per raw feature
        rff = workflow_model.rff_results
        rff_metrics: Dict[str, Dict[str, Any]] = {}
        rff_excl: Dict[str, Dict[str, Any]] = {}
        if rff is not None:
            for m in rff.metrics:
                if m.key is None:
                    rff_metrics[m.name] = m.to_json()
            for r in rff.exclusion_reasons:
                if r.key is None:
                    rff_excl[r.name] = r.to_json()

        by_parent: Dict[str, FeatureInsights] = {}
        raws = vector_f.raw_features()
        raw_types = {f.name: f.ftype.__name__ for f in raws}
        for d in derived:
            parent = d.parent_feature or vector_f.name
            fi = by_parent.setdefault(parent, FeatureInsights(
                feature_name=parent,
                feature_type=raw_types.get(parent, ""),
                rff_metrics=rff_metrics.get(parent),
                rff_exclusion=rff_excl.get(parent)))
            fi.derived.append(d)
        for f in workflow_model.blacklisted_features:
            by_parent.setdefault(f.name, FeatureInsights(
                feature_name=f.name, feature_type=f.ftype.__name__,
                rff_metrics=rff_metrics.get(f.name),
                rff_exclusion=rff_excl.get(f.name)))
        return [by_parent[k] for k in sorted(by_parent)]

    # -- output ------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"label": self.label.to_json(),
                "features": [f.to_json() for f in self.features],
                "selectedModelInfo": self.selected_model_info,
                "problemType": self.problem_type,
                "stageInfo": self.stage_info}

    def pretty(self) -> str:
        """Human-readable summary (summaryPretty analog)."""
        lines = [f"Model insights — problem type: {self.problem_type}",
                 f"Label: {self.label.name} "
                 f"(n={self.label.sample_size})", ""]
        best = self.selected_model_info.get("bestModelName")
        if best:
            lines.append(f"Best model: {best} "
                         f"{self.selected_model_info.get('bestModelParams')}")
        ev = self.selected_model_info.get("holdoutEvaluation")
        if ev:
            lines.append("Holdout: " + ", ".join(
                f"{k}={v:.4f}" for k, v in ev.items()
                if isinstance(v, (int, float))))
        lines.append("")
        rows = []
        for fi in self.features:
            for d in fi.derived:
                rows.append((d.column_name,
                             d.corr_with_label, d.contribution, d.dropped))
        rows.sort(key=lambda r: (r[2] is None,
                                 -(abs(r[2]) if r[2] is not None else 0.0)))
        lines.append(f"{'derived feature':<40} {'corr':>8} "
                     f"{'contrib':>10} dropped")
        for name, corr, contrib, dropped in rows[:40]:
            c = f"{corr:+.3f}" if corr is not None else "-"
            t = f"{contrib:.4f}" if contrib is not None else "-"
            lines.append(f"{name:<40} {c:>8} {t:>10} "
                         f"{'yes' if dropped else ''}")
        return "\n".join(lines)
