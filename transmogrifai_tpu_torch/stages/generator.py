"""FeatureGeneratorStage — origin of raw features.

Mirrors ``features/.../stages/FeatureGeneratorStage.scala:45-108``: holds the
record → value ``extract_fn``, an optional monoid aggregator and event-time
window used by aggregating readers, and produces the raw Feature node.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Type

import numpy as np

from ..columns import Column, ColumnStore, column_from_values
from ..features import Feature
from ..types.feature_types import FeatureType
from .base import InputSpec, Transformer, register_stage


class _NoInputs(InputSpec):
    def check(self, features):
        if features:
            raise TypeError("FeatureGeneratorStage takes no input features")


@register_stage
class FeatureGeneratorStage(Transformer):
    """Origin stage: extracts one raw feature from source records."""

    operation_name = "gen"
    is_raw_generator = True

    def __init__(self, name: str, ftype: Type[FeatureType],
                 extract_fn: Optional[Callable[[Any], Any]] = None,
                 is_response: bool = False,
                 aggregator=None, window_ms: Optional[int] = None,
                 extract_source: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.name = name
        self.ftype = ftype
        if extract_fn is None:
            # by record key, as ``from_column`` extracts (what a loaded
            # model's generators do): marked for the bulk-ingest path
            extract_fn = lambda rec: rec.get(name)  # noqa: E731
            extract_fn._column_key = name
        self.extract_fn = extract_fn
        self.is_response = is_response
        self.aggregator = aggregator
        self.window_ms = window_ms
        self.extract_source = extract_source
        self.output_type = ftype

    @property
    def input_spec(self) -> InputSpec:
        return _NoInputs()

    def get_output(self) -> Feature:
        if self._output_feature is None:
            self._output_feature = Feature(
                name=self.name, ftype=self.ftype,
                is_response=self.is_response, origin_stage=self, parents=())
        return self._output_feature

    def make_output_name(self) -> str:
        return self.name

    # raw features are materialized by readers; transform just passes through
    # an existing column (used when scoring a store that already has the data)
    def transform_columns(self, store: ColumnStore) -> Column:
        if self.name in store:
            return store[self.name]
        raise KeyError(f"Raw feature {self.name!r} missing from input data")

    def extract_column(self, records) -> Column:
        """Run extract_fn over host records → typed column (reader path,
        DataReader.generateDataFrame analog)."""
        key = getattr(self.extract_fn, "_column_key", None)
        cols = getattr(records, "columns", None)
        if key is not None and cols is not None and key in cols:
            # columnar batch (avro.ColumnarRecords, the pipeline's
            # vectorized decode): the field is already a numpy column —
            # build the typed column in one bulk pass, no dicts at all
            from ..columns import column_from_array
            col = column_from_array(self.ftype, cols[key])
            if col is not None:
                return col
        if key is not None and not isinstance(records, np.ndarray):
            # from_column extractors are plain rec.get(name): run the map
            # in C (methodcaller) — at 300k rows × ~8 features the Python
            # lambda frames alone were seconds of ingest time
            from operator import methodcaller
            values = list(map(methodcaller("get", key), records))
        else:
            values = [self.extract_fn(r) for r in records]
        return column_from_values(self.ftype, values)

    def get_params(self):
        p = super().get_params()
        # extract fns/aggregators are code, not data — like the reference,
        # only their source hint survives serialization
        p.pop("extract_fn", None)
        p.pop("aggregator", None)
        p["ftype"] = self.ftype  # class; model_io encodes as {"__ftype__"}
        return p
