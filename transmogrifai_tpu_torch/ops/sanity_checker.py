"""SanityChecker — automated feature validation and bad-feature removal;
the port of ``transmogrifai_tpu/ops/sanity_checker.py``
(``SanityChecker.scala``: fitFn :535-693, ``reasonsToRemove`` :783-832,
defaults :720-739).

The fit's statistics run in torch on the workflow's device, in the
workflow's dtype: one ``Zᵀ Z`` gram over the features with the label
appended (means, variances, Pearson correlations), optional Spearman
over host ranks, and one ``Yᵀ X`` contingency matmul per categorical
indicator group (χ², Cramér's V, PMI, rule support and confidence). The
row sample is numpy with the JAX package's seed. The fitted model drops
the flagged vector slots and re-indexes the metadata (host numpy).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columns import Column, ColumnStore, VectorColumn
from ..models.base import resolve_device
from ..stages.base import (AllowLabelAsInput, Estimator, FittedModel,
                           FixedArity, InputSpec, register_stage)
from ..types.feature_types import OPVector, RealNN
from ..utils.stats import (contingency as _contingency_kernel,
                           cramers_v_stats as _cramers_v,
                           moments as _moments_kernel,
                           pmi_mutual_info as _pmi_mi,
                           spearman_with_label as _spearman_with_label)
from ..vector_metadata import VectorMetadata

__all__ = ["SanityChecker", "SanityCheckerModel", "SanityCheckerSummary",
           "compute_sanity_stats"]

# defaults (SanityChecker.scala:720-739)
CHECK_SAMPLE = 1.0
SAMPLE_LOWER_LIMIT = 1_000
SAMPLE_UPPER_LIMIT = 1_000_000
MAX_CORRELATION = 0.95
MIN_CORRELATION = 0.0
MIN_VARIANCE = 1e-5
MAX_CRAMERS_V = 0.95
MAX_RULE_CONFIDENCE = 1.0
MIN_REQUIRED_RULE_SUPPORT = 1.0


class SanityCheckerSummary:
    """Per-column stats + dropped columns with reasons
    (SanityCheckerMetadata.scala)."""

    def __init__(self):
        self.column_stats: List[Dict[str, Any]] = []
        self.categorical_stats: List[Dict[str, Any]] = []
        self.dropped: List[Dict[str, Any]] = []
        self.names: List[str] = []
        self.correlations_with_label: List[float] = []

    def to_json(self) -> Dict[str, Any]:
        return {"columnStats": self.column_stats,
                "categoricalStats": self.categorical_stats,
                "droppedColumns": self.dropped,
                "correlationsWithLabel": dict(
                    zip(self.names, self.correlations_with_label))}


@register_stage
class SanityCheckerModel(FittedModel, AllowLabelAsInput):
    """Drops flagged slots; output vector = kept columns."""

    operation_name = "sanityCheck"
    output_type = OPVector

    def __init__(self, keep_indices: Sequence[int] = (),
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.keep_indices = list(map(int, keep_indices))
        self.summary_: Optional[SanityCheckerSummary] = None

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, OPVector)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[1].name]
        assert isinstance(col, VectorColumn)
        meta = col.metadata.select(self.keep_indices) if col.metadata else None
        if meta is not None:
            meta.name = self.output_name
        if self.keep_indices == list(range(col.values.shape[1])):
            # nothing dropped: reuse the input matrix (the fancy-index
            # below always copies — 1.3 GB at the 300k big_text config)
            return VectorColumn(OPVector, col.values, meta)
        # np.take keeps the row-major layout (a fancy index on axis 1
        # returns a column-major array)
        idx = np.asarray(self.keep_indices, dtype=np.int64)
        return VectorColumn(OPVector, np.take(col.values, idx, axis=1),
                            meta)

    def get_model_state(self):
        return {"keep_indices": self.keep_indices}

    def summary(self):
        return self.summary_.to_json() if self.summary_ else {}


@register_stage
class SanityChecker(Estimator, AllowLabelAsInput):
    """Estimator(label, features) → cleaned OPVector."""

    operation_name = "sanityCheck"
    output_type = OPVector
    #: the workflow passes ``device=`` and ``dtype=`` to this stage's fit
    uses_device = True

    def __init__(self, max_correlation: float = MAX_CORRELATION,
                 min_correlation: float = MIN_CORRELATION,
                 min_variance: float = MIN_VARIANCE,
                 max_cramers_v: float = MAX_CRAMERS_V,
                 remove_bad_features: bool = False,
                 remove_feature_group: bool = True,
                 protect_text_shared_hash: bool = True,
                 max_rule_confidence: float = MAX_RULE_CONFIDENCE,
                 min_required_rule_support: float = MIN_REQUIRED_RULE_SUPPORT,
                 feature_label_corr_only: bool = False,
                 correlation_type: str = "pearson",
                 check_sample: float = CHECK_SAMPLE,
                 sample_seed: int = 42,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.max_correlation = max_correlation
        self.min_correlation = min_correlation
        self.min_variance = min_variance
        self.max_cramers_v = max_cramers_v
        self.remove_bad_features = remove_bad_features
        self.remove_feature_group = remove_feature_group
        # reference default protects hashed text columns from the corr gate
        # (SanityChecker.scala:596-627)
        self.protect_text_shared_hash = protect_text_shared_hash
        self.max_rule_confidence = max_rule_confidence
        self.min_required_rule_support = min_required_rule_support
        self.feature_label_corr_only = feature_label_corr_only
        if correlation_type not in ("pearson", "spearman"):
            raise ValueError(
                f"correlation_type must be pearson|spearman, got "
                f"{correlation_type!r}")
        #: which correlation drives the corr gate (SanityChecker.scala:634-638
        #: CorrelationType); both are always reported in the summary
        self.correlation_type = correlation_type
        self.check_sample = check_sample
        self.sample_seed = sample_seed

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, OPVector)

    def fit_columns(self, store: ColumnStore, device=None,
                    dtype: torch.dtype = torch.float32) -> SanityCheckerModel:
        """Statistics on ``device`` (default: the card) in ``dtype``."""
        stats = compute_sanity_stats(
            store, self.input_features[0].name,
            self.input_features[1].name, device=device, dtype=dtype,
            feature_label_corr_only=self.feature_label_corr_only,
            correlation_type=self.correlation_type,
            check_sample=self.check_sample,
            sample_seed=self.sample_seed)
        return self._finalize_from_stats(stats)

    # -- the fused fit-statistics pass (fitstats.py) -----------------------
    def _stats_params(self) -> Tuple:
        return (("feature_label_corr_only", self.feature_label_corr_only),
                ("correlation_type", self.correlation_type),
                ("check_sample", self.check_sample),
                ("sample_seed", self.sample_seed))

    def stat_requests(self, store):
        """The "sanity" request: ``LayerStatsPlan.run`` computes it by
        :func:`compute_sanity_stats` on the workflow's device and dtype."""
        from ..fitstats import StatRequest
        return [StatRequest("sanity", self.input_features[1].name,
                            label=self.input_features[0].name,
                            params=self._stats_params())]

    def fit_columns_from_stats(self, store, stats):
        return self._finalize_from_stats(stats.value(
            "sanity", self.input_features[1].name,
            label=self.input_features[0].name,
            params=self._stats_params()))

    def _finalize_from_stats(self, stats: Dict[str, Any]
                             ) -> SanityCheckerModel:
        """Host-side finalize: thresholds, reasons, summary and the
        keep-index model from the computed statistics (the JAX package's
        finalize, line for line)."""
        d = stats["d"]
        meta = stats["meta"]
        names = stats["names"]
        is_hash = stats["is_hash"]
        mean, var = stats["mean"], stats["var"]
        corr_label = stats["corr_label"]
        zmin, zmax = stats["zmin"], stats["zmax"]
        spearman_label = stats["spearman_label"]
        ordered, conts = stats["ordered"], stats["conts"]

        gate_corr = (spearman_label if self.correlation_type == "spearman"
                     else corr_label)

        summary = SanityCheckerSummary()
        summary.names = names
        summary.correlations_with_label = [float(c) for c in corr_label]

        reasons: Dict[int, List[str]] = {i: [] for i in range(d)}
        for i in range(d):
            summary.column_stats.append({
                "name": names[i], "mean": float(mean[i]),
                "variance": float(var[i]), "min": float(zmin[i]),
                "max": float(zmax[i]),
                "corrWithLabel": float(corr_label[i]),
                "spearmanCorrWithLabel": (
                    float(spearman_label[i]) if spearman_label is not None
                    else None)})
            if var[i] < self.min_variance:
                reasons[i].append(
                    f"variance {var[i]:.3g} below min {self.min_variance}")
            c = abs(float(gate_corr[i]))
            if not (self.protect_text_shared_hash and is_hash[i]):
                if np.isnan(gate_corr[i]):
                    pass  # zero-variance already flagged
                elif c > self.max_correlation:
                    reasons[i].append(
                        f"|corr with label| {c:.3f} above max "
                        f"{self.max_correlation}")
                elif c < self.min_correlation:
                    reasons[i].append(
                        f"|corr with label| {c:.3f} below min "
                        f"{self.min_correlation}")

        # categorical stats per indicator group (grouping + indicator cols)
        if meta.size == d:
            if ordered:
                for ((parent, grouping), idxs), cont in zip(ordered, conts):
                    cont = np.asarray(cont)
                    v, support, confidence = _cramers_v(cont)
                    pmi, mi = _pmi_mi(cont)
                    summary.categorical_stats.append({
                        "group": f"{parent}_{grouping}",
                        "cramersV": v,
                        "support": support.tolist(),
                        "maxRuleConfidence": confidence.tolist(),
                        "pointwiseMutualInfo": pmi.tolist(),
                        "mutualInfo": mi})
                    for j, i in enumerate(idxs):
                        if v > self.max_cramers_v:
                            reasons[i].append(
                                f"group Cramér's V {v:.3f} above max "
                                f"{self.max_cramers_v}")
                        if (confidence[j] >= self.max_rule_confidence and
                                support[j] >= self.min_required_rule_support):
                            reasons[i].append(
                                f"association rule confidence "
                                f"{confidence[j]:.3f} with support "
                                f"{support[j]:.3f}")

                # feature-group removal (reasonsToRemove :812-822): if any
                # slot of a parent is label-leaky, drop the parent's group
                if self.remove_feature_group:
                    leaky_parents = {
                        meta.columns[i].parent_feature_name
                        for i in range(d)
                        if any("corr with label" in r and "above" in r
                               for r in reasons[i])
                        or any("association rule" in r for r in reasons[i])}
                    for i, cm in enumerate(meta.columns):
                        if (cm.parent_feature_name in leaky_parents
                                and not reasons[i]
                                and not cm.is_null_indicator()):
                            reasons[i].append(
                                f"feature group {cm.parent_feature_name} "
                                "flagged for label leakage")

        keep = [i for i in range(d) if not reasons[i]]
        if not self.remove_bad_features:
            keep = list(range(d))
        for i in range(d):
            if reasons[i]:
                summary.dropped.append({"name": names[i],
                                        "reasons": reasons[i],
                                        "removed": self.remove_bad_features})

        if not keep:  # never output an empty vector
            keep = list(range(d))

        model = SanityCheckerModel(keep_indices=keep)
        model.summary_ = summary
        return model


def compute_sanity_stats(store: ColumnStore, label_name: str,
                         feat_name: str, *, device=None,
                         dtype: torch.dtype = torch.float32,
                         feature_label_corr_only: bool = False,
                         correlation_type: str = "pearson",
                         check_sample: float = CHECK_SAMPLE,
                         sample_seed: int = 42) -> Dict[str, Any]:
    """The SanityChecker's statistics sweep: bounded row sample, the
    moments/correlation gram, optional Spearman ranks and the per-group
    contingency tables — everything the finalize consumes. Every device
    computation is issued first and the results fetched together."""
    dev = resolve_device(device)
    ycol = store[label_name]
    xcol = store[feat_name]
    assert isinstance(xcol, VectorColumn)
    X = np.asarray(xcol.values, dtype=np.float64
                   if dtype == torch.float64 else np.float32)
    y = np.asarray(ycol.values, dtype=np.float64)
    n, d = X.shape
    meta = xcol.metadata or VectorMetadata(feat_name, [])

    # sampling (SanityChecker.scala:552-560): bounded row sample
    if n > SAMPLE_UPPER_LIMIT or check_sample < 1.0:
        rng = np.random.default_rng(sample_seed)
        target = int(min(max(n * check_sample, SAMPLE_LOWER_LIMIT),
                         SAMPLE_UPPER_LIMIT))
        if target < n:
            idx = rng.choice(n, size=target, replace=False)
            X, y = X[idx], y[idx]
            n = target

    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y, dtype=dtype, device=dev)
    moments_dev = _moments_kernel(Xd, yd, feature_label_corr_only)
    spearman_dev = None
    if correlation_type == "spearman":
        spearman_dev, _full = _spearman_with_label(X, y, device=dev,
                                                   dtype=dtype)

    groups: Dict[Tuple[str, str], List[int]] = {}
    if meta.size == d:
        for i, cm in enumerate(meta.columns):
            if cm.indicator_value is not None and cm.grouping is not None:
                groups.setdefault((cm.parent_feature_name, cm.grouping),
                                  []).append(i)
    ordered = sorted(groups.items())
    conts_dev = []
    if ordered:
        classes = np.unique(y)
        Y1 = torch.as_tensor(
            (y[:, None] == classes[None, :]).astype(np.float64),
            dtype=dtype, device=dev)
        conts_dev = [_contingency_kernel(
            Y1, Xd[:, torch.as_tensor(idxs, device=dev)])
            for _g, idxs in ordered]

    def host(t):
        return None if t is None else t.cpu().numpy()

    mean, var, corr_label, _corr, zmin, zmax = (
        host(t) for t in moments_dev)
    spearman_label = host(spearman_dev)
    conts = [host(c) for c in conts_dev]

    names = meta.column_names() if meta.size == d else \
        [f"{feat_name}_{i}" for i in range(d)]
    is_hash = [meta.size == d and
               (meta.columns[i].descriptor_value or "").startswith("hash_")
               for i in range(d)]

    return {"d": d, "meta": meta, "names": names, "is_hash": is_hash,
            "mean": mean, "var": var, "corr_label": corr_label,
            "zmin": zmin, "zmax": zmax,
            "spearman_label": spearman_label,
            "ordered": ordered, "conts": conts}
