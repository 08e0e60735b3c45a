"""RawFeatureFilter — the pre-DAG data-quality gate; the port of
``transmogrifai_tpu/filters/raw_feature_filter.py``, host numpy as there,
so its results JSON is the JAX package's byte for byte.

Parity: ``core/.../filters/RawFeatureFilter.scala`` (:90 ctor params,
``computeFeatureStats`` :135-196, ``getRawFeatureFilterMetrics`` :207-291,
exclusion reasons :302+) and ``RawFeatureFilterResults.scala``.

Given the training data (and optionally a scoring dataset), computes per
raw feature — and per map key — fill rates, binned distributions, the
train↔score Jensen-Shannon divergence, and the null-indicator↔label
correlation, then blacklists features that look unusable or leaky:

* training / scoring fill rate below ``min_fill``
* |train fill − score fill| above ``max_fill_difference``
* fill-rate ratio above ``max_fill_ratio_diff``
* JS divergence above ``max_js_divergence``
* null-label absolute correlation above ``max_correlation``

All statistics are vectorized column passes (``distribution.py``); the
null-leakage correlations of every feature are one product of the stacked
null-indicator matrix with the label vector, where the reference reduces
per-row PreparedFeatures.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..columns import Column, ColumnStore, MapColumn, NumericColumn
from ..features import Feature
from .distribution import (FeatureDistribution, Summary,
                           distributions_of_column, summaries_of_column,
                           _null_mask)

__all__ = ["RawFeatureFilter", "FilteredRawData", "RawFeatureFilterMetrics",
           "ExclusionReasons", "RawFeatureFilterResults"]


@dataclass
class RawFeatureFilterMetrics:
    """Per-(feature, key) metrics (RawFeatureFilterResults.scala)."""

    name: str
    key: Optional[str]
    training_fill_rate: float
    training_null_label_abs_corr: Optional[float]
    scoring_fill_rate: Optional[float]
    js_divergence: Optional[float]
    fill_rate_diff: Optional[float]
    fill_ratio_diff: Optional[float]

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "key": self.key,
                "trainingFillRate": self.training_fill_rate,
                "trainingNullLabelAbsoluteCorr": self.training_null_label_abs_corr,
                "scoringFillRate": self.scoring_fill_rate,
                "jsDivergence": self.js_divergence,
                "fillRateDiff": self.fill_rate_diff,
                "fillRatioDiff": self.fill_ratio_diff}


@dataclass
class ExclusionReasons:
    """Why a (feature, key) was excluded (RawFeatureFilterResults.scala)."""

    name: str
    key: Optional[str]
    training_unfilled_state: bool = False
    training_null_label_leaker: bool = False
    scoring_unfilled_state: bool = False
    js_divergence_mismatch: bool = False
    fill_rate_diff_mismatch: bool = False
    fill_ratio_diff_mismatch: bool = False
    excluded: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "key": self.key,
                "trainingUnfilledState": self.training_unfilled_state,
                "trainingNullLabelLeaker": self.training_null_label_leaker,
                "scoringUnfilledState": self.scoring_unfilled_state,
                "jsDivergenceMismatch": self.js_divergence_mismatch,
                "fillRateDiffMismatch": self.fill_rate_diff_mismatch,
                "fillRatioDiffMismatch": self.fill_ratio_diff_mismatch,
                "excluded": self.excluded}


@dataclass
class RawFeatureFilterResults:
    """Config + metrics + reasons, serialized with the model."""

    config: Dict[str, Any] = field(default_factory=dict)
    metrics: List[RawFeatureFilterMetrics] = field(default_factory=list)
    exclusion_reasons: List[ExclusionReasons] = field(default_factory=list)
    training_distributions: List[FeatureDistribution] = field(default_factory=list)
    scoring_distributions: List[FeatureDistribution] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"config": self.config,
                "metrics": [m.to_json() for m in self.metrics],
                "exclusionReasons": [r.to_json() for r in self.exclusion_reasons],
                "trainingDistributions": [d.to_json() for d in self.training_distributions],
                "scoringDistributions": [d.to_json() for d in self.scoring_distributions]}

    def summary(self) -> Dict[str, Any]:
        """The compact block the runner stamps in its train metrics doc:
        how many (feature, key) pairs were checked, which were excluded
        and why-counts, and whether train-time distributions were
        persisted (the serving-time drift sentinel's baseline)."""
        excluded = [(f"{r.name}({r.key})" if r.key is not None else r.name)
                    for r in self.exclusion_reasons if r.excluded]
        return {"featuresChecked": len(self.metrics),
                "excluded": excluded,
                "excludedCount": len(excluded),
                "trainingDistributions": len(self.training_distributions),
                "config": dict(self.config)}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "RawFeatureFilterResults":
        return RawFeatureFilterResults(
            config=d.get("config", {}),
            metrics=[RawFeatureFilterMetrics(
                m["name"], m.get("key"), m["trainingFillRate"],
                m.get("trainingNullLabelAbsoluteCorr"),
                m.get("scoringFillRate"), m.get("jsDivergence"),
                m.get("fillRateDiff"), m.get("fillRatioDiff"))
                for m in d.get("metrics", [])],
            exclusion_reasons=[ExclusionReasons(
                r["name"], r.get("key"),
                r.get("trainingUnfilledState", False),
                r.get("trainingNullLabelLeaker", False),
                r.get("scoringUnfilledState", False),
                r.get("jsDivergenceMismatch", False),
                r.get("fillRateDiffMismatch", False),
                r.get("fillRatioDiffMismatch", False),
                r.get("excluded", False))
                for r in d.get("exclusionReasons", [])],
            training_distributions=[FeatureDistribution.from_json(x)
                                    for x in d.get("trainingDistributions", [])],
            scoring_distributions=[FeatureDistribution.from_json(x)
                                   for x in d.get("scoringDistributions", [])])


@dataclass
class FilteredRawData:
    """Output of the filter (FilteredRawData, RawFeatureFilter.scala:467-478)."""

    clean_store: ColumnStore
    blacklisted_features: List[Feature]
    blacklisted_map_keys: Dict[str, List[str]]
    results: RawFeatureFilterResults


class RawFeatureFilter:
    """Data-quality gate over raw features, run before DAG fitting."""

    def __init__(self,
                 bins: int = 100,
                 min_fill: float = 0.001,
                 max_fill_difference: float = 0.90,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.90,
                 max_correlation: float = 0.95,
                 protected_features: Sequence[str] = (),
                 js_divergence_protected_features: Sequence[str] = (),
                 scoring_data=None):
        self.bins = bins
        self.min_fill = min_fill
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.protected_features = set(protected_features)
        self.js_protected = set(js_divergence_protected_features)
        self.scoring_data = scoring_data

    def config_json(self) -> Dict[str, Any]:
        return {"bins": self.bins, "minFill": self.min_fill,
                "maxFillDifference": self.max_fill_difference,
                "maxFillRatioDiff": self.max_fill_ratio_diff,
                "maxJSDivergence": self.max_js_divergence,
                "maxCorrelation": self.max_correlation,
                "protectedFeatures": sorted(self.protected_features),
                "jsDivergenceProtectedFeatures": sorted(self.js_protected)}

    # -- statistics --------------------------------------------------------
    def _distributions(self, store: ColumnStore, predictors: List[Feature],
                       summaries) -> Dict[Tuple[str, Optional[str]],
                                          FeatureDistribution]:
        out: Dict[Tuple[str, Optional[str]], FeatureDistribution] = {}
        for f in predictors:
            for d in distributions_of_column(f.name, store[f.name],
                                             self.bins, summaries):
                out[(d.name, d.key)] = d
        return out

    @staticmethod
    def _with_missing_as_null(store: ColumnStore,
                              predictors: List[Feature]) -> ColumnStore:
        """A predictor absent from a store counts as 100% null — missing at
        scoring time must trip the unfilled/fill-diff gates, not bypass
        them."""
        from ..columns import column_of_empty
        missing = {f.name: column_of_empty(f.ftype, store.n_rows)
                   for f in predictors if f.name not in store}
        return store.with_columns(missing) if missing else store

    @staticmethod
    def _label_vector(store: ColumnStore, responses: List[Feature]
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(label values, present mask) — rows with null labels must be
        excluded from the leakage correlation, not treated as label 0."""
        for f in responses:
            col = store.get(f.name)
            if isinstance(col, NumericColumn):
                return col.values.astype(np.float64), col.mask.copy()
        return None

    def _null_label_corrs(self, store: ColumnStore, predictors: List[Feature],
                          label: Optional[Tuple[np.ndarray, np.ndarray]]
                          ) -> Dict[Tuple[str, Optional[str]], float]:
        """|corr(is-null, label)| for every (feature, key) — one matmul.

        Replaces the reference's per-row PreparedFeatures summaries +
        correlation matrix job (RawFeatureFilter.scala:175-187).
        """
        if label is None:
            return {}
        label, label_mask = label
        keys: List[Tuple[str, Optional[str]]] = []
        indicators: List[np.ndarray] = []
        for f in predictors:
            col = store[f.name]
            if isinstance(col, MapColumn):
                for k, child in sorted(col.children.items()):
                    keys.append((f.name, k))
                    indicators.append(_null_mask(child).astype(np.float64))
            else:
                keys.append((f.name, None))
                indicators.append(_null_mask(col).astype(np.float64))
        if not indicators:
            return {}
        M = np.stack(indicators)[:, label_mask]       # [d, n_labeled]
        labeled = label[label_mask]
        if labeled.size == 0:
            return {}
        y = labeled - labeled.mean()
        Mc = M - M.mean(axis=1, keepdims=True)
        num = Mc @ y
        denom = np.sqrt((Mc * Mc).sum(axis=1) * (y * y).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(denom > 0, num / denom, 0.0)
        return {k: float(abs(c)) for k, c in zip(keys, corr)}

    # -- main entry --------------------------------------------------------
    def filter_raw(self, store: ColumnStore, raw_features: Sequence[Feature],
                   scoring_data=None) -> FilteredRawData:
        predictors = [f for f in raw_features if not f.is_response]
        responses = [f for f in raw_features if f.is_response]

        store = self._with_missing_as_null(store, predictors)
        score_store = self._scoring_store(scoring_data, raw_features, predictors)
        if score_store is not None:
            score_store = self._with_missing_as_null(score_store, predictors)

        # combined numeric summaries → shared bin edges for both splits
        summaries: Dict[Tuple[str, Optional[str]], Summary] = {}
        for f in predictors:
            for k, s in summaries_of_column(f.name, store[f.name]).items():
                summaries[k] = summaries.get(k, Summary()) + s
        if score_store is not None:
            for f in predictors:
                for k, s in summaries_of_column(
                        f.name, score_store[f.name]).items():
                    summaries[k] = summaries.get(k, Summary()) + s

        train_dists = self._distributions(store, predictors, summaries)
        score_dists = (self._distributions(score_store, predictors, summaries)
                       if score_store is not None else {})
        if score_store is not None:
            # a map key seen in training but entirely absent from the scoring
            # store must still face the scoring-side gates: synthesize an
            # all-null distribution (fill rate 0), as the reference's empty
            # scoring distribution does (FeatureDistribution.scala)
            n_score = score_store.n_rows
            for (name, key), td in train_dists.items():
                if (name, key) not in score_dists:
                    score_dists[(name, key)] = FeatureDistribution(
                        name=name, key=key, count=n_score, nulls=n_score,
                        distribution=np.zeros_like(td.distribution),
                        summary_info=list(td.summary_info))
        corrs = self._null_label_corrs(
            store, predictors, self._label_vector(store, responses))

        metrics: List[RawFeatureFilterMetrics] = []
        reasons: List[ExclusionReasons] = []
        excluded: Dict[str, List[Optional[str]]] = {}

        for (name, key), td in sorted(train_dists.items(),
                                      key=lambda kv: (kv[0][0], kv[0][1] or "")):
            sd = score_dists.get((name, key))
            corr = corrs.get((name, key))
            m = RawFeatureFilterMetrics(
                name=name, key=key,
                training_fill_rate=td.fill_rate(),
                training_null_label_abs_corr=corr,
                scoring_fill_rate=sd.fill_rate() if sd else None,
                js_divergence=td.js_divergence(sd) if sd else None,
                fill_rate_diff=td.relative_fill_rate(sd) if sd else None,
                fill_ratio_diff=td.relative_fill_ratio(sd) if sd else None)
            metrics.append(m)

            r = ExclusionReasons(name=name, key=key)
            if name not in self.protected_features:
                r.training_unfilled_state = m.training_fill_rate < self.min_fill
                r.training_null_label_leaker = (
                    corr is not None and corr > self.max_correlation)
                if sd is not None:
                    r.scoring_unfilled_state = (
                        m.scoring_fill_rate < self.min_fill)
                    if name not in self.js_protected:
                        r.js_divergence_mismatch = (
                            m.js_divergence > self.max_js_divergence)
                    r.fill_rate_diff_mismatch = (
                        m.fill_rate_diff > self.max_fill_difference)
                    r.fill_ratio_diff_mismatch = (
                        m.fill_ratio_diff > self.max_fill_ratio_diff)
            r.excluded = any([r.training_unfilled_state,
                              r.training_null_label_leaker,
                              r.scoring_unfilled_state,
                              r.js_divergence_mismatch,
                              r.fill_rate_diff_mismatch,
                              r.fill_ratio_diff_mismatch])
            reasons.append(r)
            if r.excluded:
                excluded.setdefault(name, []).append(key)

        blacklisted_features, blacklisted_keys, clean = self._apply_exclusions(
            store, predictors, excluded)

        results = RawFeatureFilterResults(
            config=self.config_json(), metrics=metrics,
            exclusion_reasons=reasons,
            training_distributions=list(train_dists.values()),
            scoring_distributions=list(score_dists.values()))
        return FilteredRawData(clean, blacklisted_features, blacklisted_keys,
                               results)

    def _scoring_store(self, scoring_data, raw_features,
                       predictors) -> Optional[ColumnStore]:
        data = scoring_data if scoring_data is not None else self.scoring_data
        if data is None:
            return None
        if isinstance(data, ColumnStore):
            return data
        from ..workflow import _raw_store
        return _raw_store(data, predictors)

    @staticmethod
    def _apply_exclusions(store: ColumnStore, predictors: List[Feature],
                          excluded: Dict[str, List[Optional[str]]]
                          ) -> Tuple[List[Feature], Dict[str, List[str]],
                                     ColumnStore]:
        blacklisted_features: List[Feature] = []
        blacklisted_keys: Dict[str, List[str]] = {}
        drop_cols: List[str] = []
        replace: Dict[str, Column] = {}
        by_name = {f.name: f for f in predictors}
        for name, keys in excluded.items():
            col = store[name]
            if isinstance(col, MapColumn):
                bad = sorted(k for k in keys if k is not None)
                blacklisted_keys[name] = bad
                remaining = {k: c for k, c in col.children.items()
                             if k not in set(bad)}
                if remaining:
                    replace[name] = MapColumn(col.ftype, remaining, len(col))
                else:
                    blacklisted_features.append(by_name[name])
                    drop_cols.append(name)
            else:
                blacklisted_features.append(by_name[name])
                drop_cols.append(name)
        clean = store.drop(drop_cols).with_columns(replace)
        return blacklisted_features, blacklisted_keys, clean
