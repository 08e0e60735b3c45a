"""Per-feature summaries and binned distributions — the port of
``transmogrifai_tpu/filters/distribution.py``, host numpy as there, so
every number is the JAX package's bit for bit.

Parity: ``core/.../filters/FeatureDistribution.scala`` (monoid of nulls /
count / histogram bins, JS divergence, fill metrics) and the ``Summary``
min/max/sum/count monoid (``core/.../filters/Summary.scala``).

Each statistic is one vectorized pass over a column's dense arrays: masks
give the null counts, numeric histograms are one ``np.histogram`` over the
present values, and text histograms hash the whole column into a fixed bin
space (the reference's hashed text distribution, which compares train and
score text without a vocabulary).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..columns import (Column, GeoColumn, MapColumn, NumericColumn,
                       RaggedColumn, TextColumn, TextListColumn,
                       TextSetColumn, VectorColumn)
from ..ops.hashing import hash_tokens

__all__ = ["Summary", "FeatureDistribution",
           "summaries_of_column", "distributions_of_column"]


@dataclass
class Summary:
    """Min/max/sum/count monoid per feature (Summary.scala)."""

    min: float = float("inf")
    max: float = float("-inf")
    sum: float = 0.0
    count: float = 0.0

    def __add__(self, other: "Summary") -> "Summary":
        return Summary(min(self.min, other.min), max(self.max, other.max),
                       self.sum + other.sum, self.count + other.count)

    @staticmethod
    def of_values(values: np.ndarray) -> "Summary":
        if values.size == 0:
            return Summary()
        v = values.astype(np.float64)
        return Summary(float(v.min()), float(v.max()),
                       float(v.sum()), float(v.size))

    def to_json(self) -> Dict[str, Any]:
        return {"min": self.min, "max": self.max,
                "sum": self.sum, "count": self.count}


@dataclass
class FeatureDistribution:
    """Distribution of one raw feature (or one map key) on one data split.

    ``distribution`` is the binned histogram: equi-width over the combined
    train/score ``Summary`` range for numerics, hash bins for text. The
    monoid ``+`` and the divergence/fill metrics mirror
    ``FeatureDistribution.scala:...`` (jsDivergence, fillRate, relativeFillRate,
    relativeFillRatio).
    """

    name: str
    key: Optional[str] = None        # map key, if this is a map sub-feature
    count: int = 0                   # total rows
    nulls: int = 0                   # empty rows
    distribution: np.ndarray = field(
        default_factory=lambda: np.zeros(0))
    summary_info: List[float] = field(default_factory=list)  # bin edges / [bins]

    @property
    def full_name(self) -> str:
        return self.name if self.key is None else f"{self.name}({self.key})"

    def __add__(self, other: "FeatureDistribution") -> "FeatureDistribution":
        assert self.name == other.name and self.key == other.key
        # total monoid: either side may carry an empty histogram (e.g. a
        # default-constructed accumulator)
        if not self.distribution.size:
            dist = other.distribution.copy()
        elif not other.distribution.size:
            dist = self.distribution.copy()
        else:
            dist = self.distribution + other.distribution
        return FeatureDistribution(self.name, self.key,
                                   self.count + other.count,
                                   self.nulls + other.nulls, dist,
                                   self.summary_info or other.summary_info)

    # -- metrics (FeatureDistribution.scala) -------------------------------
    def fill_rate(self) -> float:
        return 0.0 if self.count == 0 else (self.count - self.nulls) / self.count

    def relative_fill_rate(self, other: "FeatureDistribution") -> float:
        return abs(self.fill_rate() - other.fill_rate())

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        a, b = self.fill_rate(), other.fill_rate()
        lo, hi = min(a, b), max(a, b)
        # two identically-empty features are maximally SIMILAR, not
        # maximally drifted: 0/0 is ratio 1, not inf
        if hi == 0.0:
            return 1.0
        return float("inf") if lo == 0.0 else hi / lo

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence of the two normalized histograms,
        log base 2 → bounded in [0, 1]."""
        p, q = self.distribution, other.distribution
        if p.size == 0 or q.size == 0 or p.sum() == 0 or q.sum() == 0:
            return 0.0
        if p.shape != q.shape:
            return 1.0
        p = p / p.sum()
        q = q / q.sum()
        m = 0.5 * (p + q)
        with np.errstate(divide="ignore", invalid="ignore"):
            kl_pm = np.where(p > 0, p * (np.log2(p) - np.log2(m)), 0.0)
            kl_qm = np.where(q > 0, q * (np.log2(q) - np.log2(m)), 0.0)
        return float(0.5 * kl_pm.sum() + 0.5 * kl_qm.sum())

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "key": self.key, "count": self.count,
                "nulls": self.nulls,
                "distribution": self.distribution.tolist(),
                "summaryInfo": list(self.summary_info)}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "FeatureDistribution":
        return FeatureDistribution(
            d["name"], d.get("key"), int(d["count"]), int(d["nulls"]),
            np.asarray(d.get("distribution", []), dtype=np.float64),
            list(d.get("summaryInfo", [])))


# ---------------------------------------------------------------------------
# Column → null mask / numeric payload extraction
# ---------------------------------------------------------------------------

def _null_mask(col: Column) -> np.ndarray:
    """bool[n]: True where the row is EMPTY."""
    if isinstance(col, NumericColumn):
        return ~col.mask
    if isinstance(col, TextColumn):
        return np.array([v is None for v in col.values], dtype=bool)
    if isinstance(col, (TextListColumn, TextSetColumn)):
        return np.array([len(v) == 0 for v in col.values], dtype=bool)
    if isinstance(col, RaggedColumn):
        return (np.diff(col.offsets) == 0)
    if isinstance(col, GeoColumn):
        return ~col.mask
    if isinstance(col, VectorColumn):
        return np.zeros(len(col), dtype=bool)
    if isinstance(col, MapColumn):
        empty = np.ones(len(col), dtype=bool)
        for child in col.children.values():
            empty &= _null_mask(child)
        return empty
    raise TypeError(f"Unsupported column for distribution: {type(col)}")


def _numeric_values(col: Column) -> Optional[np.ndarray]:
    """Present numeric payload values (flattened), or None if text-like."""
    if isinstance(col, NumericColumn):
        return col.values[col.mask].astype(np.float64)
    if isinstance(col, RaggedColumn):
        return col.flat.astype(np.float64)
    if isinstance(col, GeoColumn):
        return col.values[col.mask][:, :2].ravel()
    if isinstance(col, VectorColumn):
        return col.values.ravel().astype(np.float64)
    return None


def _text_tokens(col: Column) -> Optional[List[str]]:
    if isinstance(col, TextColumn):
        return [v for v in col.values if v is not None]
    if isinstance(col, (TextListColumn, TextSetColumn)):
        return [t for row in col.values for t in row]
    return None


def summaries_of_column(name: str, col: Column) -> Dict[Tuple[str, Optional[str]], Summary]:
    """Per-(feature, map key) numeric Summary; text features get a
    count-only summary (their bins are the hash space)."""
    if isinstance(col, MapColumn):
        out: Dict[Tuple[str, Optional[str]], Summary] = {}
        for k, child in col.children.items():
            for (_, _), s in summaries_of_column(name, child).items():
                out[(name, k)] = s
        return out
    vals = _numeric_values(col)
    if vals is not None:
        return {(name, None): Summary.of_values(vals)}
    toks = _text_tokens(col)
    return {(name, None): Summary(0.0, 0.0, 0.0, float(len(toks or [])))}


def distributions_of_column(
        name: str, col: Column, bins: int,
        summaries: Dict[Tuple[str, Optional[str]], Summary],
        key: Optional[str] = None) -> List[FeatureDistribution]:
    """Binned FeatureDistribution(s) for a column.

    ``summaries`` supplies the (train ∪ score) numeric range so both splits
    share bin edges (the reference reduces Summary over both readers before
    binning, RawFeatureFilter.scala:135-196).
    """
    if isinstance(col, MapColumn):
        out: List[FeatureDistribution] = []
        for k, child in sorted(col.children.items()):
            out.extend(distributions_of_column(name, child, bins, summaries, k))
        return out

    nulls = _null_mask(col)
    n = len(col)
    summ = summaries.get((name, key)) or Summary()

    vals = _numeric_values(col)
    if vals is not None:
        lo, hi = summ.min, summ.max
        if not np.isfinite(lo) or not np.isfinite(hi):
            lo, hi = 0.0, 1.0
        if hi <= lo:
            hi = lo + 1.0
        hist, edges = np.histogram(vals, bins=bins, range=(lo, hi))
        return [FeatureDistribution(name, key, n, int(nulls.sum()),
                                    hist.astype(np.float64),
                                    [float(lo), float(hi), float(bins)])]

    toks = _text_tokens(col)
    if toks is not None:
        hist = np.zeros(bins, dtype=np.float64)
        if toks:
            idx = hash_tokens(toks).astype(np.int64) % bins
            np.add.at(hist, idx, 1.0)
        return [FeatureDistribution(name, key, n, int(nulls.sum()), hist,
                                    [float(bins)])]

    raise TypeError(f"Unsupported column for distribution: {type(col)}")
