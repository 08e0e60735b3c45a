"""Vector column provenance — the contract between vectorizers, SanityChecker
and ModelInsights.

Mirrors ``utils``' ``OpVectorColumnMetadata`` / ``OpVectorMetadata``
(``features/.../utils/spark/OpVectorColumnMetadata.scala:67-75``,
``OpVectorMetadata.scala``): every column of every feature vector records
which raw feature produced it, its feature type, an optional grouping (e.g.
the pivot value group or map key), an optional indicator value (one-hot
category), and an optional descriptor (e.g. "x" / "y" for unit-circle dates).

Host copy of ``transmogrifai_tpu/vector_metadata.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["VectorColumnMetadata", "VectorMetadata"]

NULL_INDICATOR = "NullIndicatorValue"
OTHER_INDICATOR = "OTHER"


@dataclass(frozen=True)
class VectorColumnMetadata:
    """Provenance of one slot in a feature vector."""

    parent_feature_name: str
    parent_feature_type: str
    grouping: Optional[str] = None        # pivot group / map key
    indicator_value: Optional[str] = None  # one-hot category value
    descriptor_value: Optional[str] = None  # e.g. unit-circle "x"/"y"
    index: int = 0                         # slot in the combined vector

    def is_null_indicator(self) -> bool:
        return self.indicator_value == NULL_INDICATOR

    def is_other_indicator(self) -> bool:
        return self.indicator_value == OTHER_INDICATOR

    def column_name(self) -> str:
        parts = [self.parent_feature_name]
        if self.grouping is not None:
            parts.append(self.grouping)
        if self.indicator_value is not None:
            parts.append(self.indicator_value)
        if self.descriptor_value is not None:
            parts.append(self.descriptor_value)
        return "_".join(parts) + f"_{self.index}"

    def with_index(self, index: int) -> "VectorColumnMetadata":
        return VectorColumnMetadata(
            self.parent_feature_name, self.parent_feature_type, self.grouping,
            self.indicator_value, self.descriptor_value, index)

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "VectorColumnMetadata":
        return VectorColumnMetadata(**d)


@dataclass
class VectorMetadata:
    """Metadata for a whole OPVector column: ordered per-slot provenance."""

    name: str
    columns: List[VectorColumnMetadata] = field(default_factory=list)

    def __post_init__(self):
        self.columns = [c.with_index(i) for i, c in enumerate(self.columns)]

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.column_name() for c in self.columns]

    def parent_features(self) -> List[str]:
        seen, out = set(), []
        for c in self.columns:
            if c.parent_feature_name not in seen:
                seen.add(c.parent_feature_name)
                out.append(c.parent_feature_name)
        return out

    def indices_of_parent(self, parent: str) -> List[int]:
        return [c.index for c in self.columns if c.parent_feature_name == parent]

    @staticmethod
    def flatten(name: str, metas: Sequence["VectorMetadata"]) -> "VectorMetadata":
        """Concatenate vector metadatas in order (VectorsCombiner semantics)."""
        cols: List[VectorColumnMetadata] = []
        for m in metas:
            cols.extend(m.columns)
        return VectorMetadata(name, cols)

    def select(self, indices: Sequence[int]) -> "VectorMetadata":
        """Keep only the given slots (SanityChecker column dropping)."""
        return VectorMetadata(self.name, [self.columns[i] for i in indices])

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "columns": [c.to_json() for c in self.columns]}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "VectorMetadata":
        return VectorMetadata(
            d["name"], [VectorColumnMetadata.from_json(c) for c in d["columns"]])
