"""Collection-lifted unary transforms — the OPCollectionTransformer family;
the port of ``transmogrifai_tpu/ops/collections.py``.

Parity: ``core/.../impl/feature/OPCollectionTransformer.scala:1-209``:
a unary transformer between scalar feature types lifts onto the matching
collection types — map VALUES, set elements, list elements — with the
same early type validation (an ``OPMapTransformer`` built from a
``Real → Text`` transformer only accepts RealMap inputs and yields a
TextMap) and the same empty-in → empty-out contract.

Columnar design: the reference boxes every element through the scalar
transformer's ``transformFn`` per row. Here the lift stays columnar —
a map's per-key child columns ARE scalar columns, so each key transforms
as one whole column; list/set elements transform once over the FLAT
element array (CSR offsets re-nest the result) — one vectorized pass per
collection, never a per-element Python call into the stage.
"""
from __future__ import annotations

from typing import List, Optional, Type

import numpy as np

from ..columns import (Column, ColumnStore, MapColumn, RaggedColumn,
                       TextListColumn, TextSetColumn, column_from_values)
from ..stages.base import (FixedArity, InputSpec, Transformer,
                           register_stage)
from ..types import feature_types as ft
from ..types.feature_types import ColumnKind, FeatureType

__all__ = ["OPMapTransformer", "OPListTransformer", "OPSetTransformer",
           "lift_to_collection", "map_type_for"]


def map_type_for(elem_ftype: Type[FeatureType]) -> Type[FeatureType]:
    """Scalar feature type → its OPMap type (Real → RealMap, …), the
    ``O → OMap`` association the reference fixes with type parameters."""
    from ..types.feature_types import FEATURE_TYPE_REGISTRY
    named = FEATURE_TYPE_REGISTRY.get(f"{elem_ftype.__name__}Map")
    if named is not None:
        return named
    for cand in FEATURE_TYPE_REGISTRY.values():
        if (getattr(cand, "column_kind", None) is ColumnKind.MAP
                and getattr(cand, "element_type", None) is elem_ftype):
            return cand
    raise TypeError(f"No OPMap type holds {elem_ftype.__name__} values")


_LIST_OUT = {
    # scalar output kind → list type that can hold it
    ColumnKind.TEXT: ft.TextList,
    ColumnKind.INTEGRAL: ft.DateList,
}


#: element kind carried by each collection column kind
_ELEM_KIND = {ColumnKind.TEXT_LIST: ColumnKind.TEXT,
              ColumnKind.TEXT_SET: ColumnKind.TEXT,
              ColumnKind.INTEGRAL_LIST: ColumnKind.INTEGRAL}


def _check_elem(collection_ftype: Type[FeatureType],
                scalar_in: Type[FeatureType], what: str) -> None:
    """requireValidateTypes analog: fail at wiring, not mid-transform."""
    kind = collection_ftype.column_kind
    if kind is ColumnKind.MAP:
        ok = (getattr(collection_ftype, "element_type", None) is scalar_in
              or collection_ftype.map_element_kind
              is scalar_in.column_kind)
    else:
        ok = _ELEM_KIND.get(kind) is scalar_in.column_kind
    if not ok:
        raise TypeError(
            f"{collection_ftype.__name__} is not convertible with the "
            f"given {what} transformer over {scalar_in.__name__}")


def _private_copy(stage: Transformer) -> Transformer:
    """Fresh instance from ctor params (+ fitted state) — same mechanism
    stage persistence uses, so anything serializable copies faithfully."""
    from ..stages.base import FittedModel
    params = dict(stage.get_params())
    params.pop("uid", None)
    copy = type(stage)(**params)
    if isinstance(stage, FittedModel):
        state = stage.get_model_state()
        if hasattr(copy, "apply_model_state"):
            copy.apply_model_state(state)
        else:
            for k, v in state.items():
                setattr(copy, k, v)
    return copy


class _LiftedTransformer(Transformer):
    """Shared wrapper: holds the scalar transformer, wires it to a
    synthetic element feature once, and exposes columnar element
    application."""

    collection_base: Type[FeatureType] = FeatureType

    def __init__(self, transformer: Transformer,
                 operation_name: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        # PRIVATE copy (ctor-params + fitted state, the persistence
        # mechanism): the lift wires the scalar transformer to its own
        # synthetic element feature, which would silently clobber wiring
        # on a caller-owned instance shared with the DAG or another lift
        self.transformer = _private_copy(transformer)
        self.operation_name = (operation_name
                               or f"{self.lift_name}_"
                                  f"{transformer.operation_name}")
        scalar_in = self._scalar_in()
        from ..features import FeatureBuilder
        builder = getattr(FeatureBuilder, scalar_in.__name__)
        self._elem_feature = (builder(f"__elem_{self.uid}__")
                              .from_column().as_predictor())
        self.transformer.set_input(self._elem_feature)

    # -- scalar plumbing ---------------------------------------------------
    def _scalar_in(self) -> Type[FeatureType]:
        spec = self.transformer.input_spec
        types = getattr(spec, "types", None)
        if not types or len(types) != 1:
            raise TypeError(
                "Only UNARY transformers lift onto collections "
                f"({type(self.transformer).__name__} is not)")
        return types[0]

    def _apply_elems(self, col: Column) -> Column:
        """Run the scalar transform over one column of elements."""
        name = self._elem_feature.name
        return self.transformer.transform_columns(
            ColumnStore({name: col}, len(col)))

    def set_input(self, *features):
        _check_elem(features[0].ftype, self._scalar_in(), self.lift_name)
        return super().set_input(*features)

    def get_params(self):
        p = super().get_params()
        p.pop("operation_name", None)
        return p


@register_stage
class OPMapTransformer(_LiftedTransformer):
    """Lift a scalar unary transformer over an OPMap's VALUES
    (``OPMapTransformer.doTransform``: keys pass through untouched)."""

    lift_name = "mapValues"
    operation_name = "mapValues"

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPMap)

    @property
    def output_type(self) -> Type[FeatureType]:
        return map_type_for(self.transformer.output_type)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        assert isinstance(col, MapColumn)
        children = {k: self._apply_elems(child)
                    for k, child in col.children.items()}
        return MapColumn(self.output_type, children, col.n_rows)


class _FlatLift(_LiftedTransformer):
    """List/set lift: flatten elements, transform ONCE, re-nest."""

    def _flat_rows(self, col: Column) -> List[list]:
        if isinstance(col, RaggedColumn):
            return [col.get_raw(i) for i in range(len(col))]
        return [list(col.get_raw(i) or ()) for i in range(len(col))]

    def _lifted(self, store: ColumnStore):
        col = store[self.input_features[0].name]
        rows = self._flat_rows(col)
        lengths = [len(r) for r in rows]
        flat = [x for r in rows for x in r]
        flat_in = column_from_values(self._scalar_in(), flat)
        out_col = self._apply_elems(flat_in)
        out_vals = [out_col.get_raw(i) for i in range(len(flat))]
        nested, pos = [], 0
        for ln in lengths:
            nested.append(out_vals[pos:pos + ln])
            pos += ln
        return nested

    @property
    def output_type(self) -> Type[FeatureType]:
        out_kind = self.transformer.output_type.column_kind
        lifted = _LIST_OUT.get(out_kind)
        if lifted is None:
            raise TypeError(
                f"No OPList type holds {out_kind} elements "
                f"(from {self.transformer.output_type.__name__})")
        return lifted


@register_stage
class OPListTransformer(_FlatLift):
    """Lift over OPList elements.

    Text-output lifts preserve order with one entry per input element —
    nulls from the scalar transform stay in place (the reference's 'no
    checks on the output' note). Integral-output lifts DROP null
    elements: the CSR ragged encoding has no element mask, so an
    unparseable element shortens that row's list rather than poisoning
    the numeric flat array — alignment with the source list is not
    preserved in that case."""

    lift_name = "listElems"
    operation_name = "listElems"

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPList)

    def transform_columns(self, store: ColumnStore) -> Column:
        nested = self._lifted(store)
        out_t = self.output_type
        if out_t.column_kind is ColumnKind.TEXT_LIST:
            return TextListColumn(out_t, nested)
        flat = np.asarray([x for r in nested for x in r
                           if x is not None], dtype=np.int64)
        lengths = np.asarray(
            [sum(1 for x in r if x is not None) for r in nested],
            dtype=np.int64)
        # per-row dropped-null accounting (ADVICE r3): integral lifts
        # shorten rows, so consumers needing element alignment with the
        # source list can detect (and quantify) the divergence here
        dropped = np.asarray([len(r) for r in nested],
                             dtype=np.int64) - lengths
        self.last_dropped_counts = dropped
        total = int(dropped.sum())
        if total and not getattr(self, "_warned_dropped", False):
            # once per stage instance — a streaming scoring loop would
            # otherwise emit one identical warning per micro-batch
            self._warned_dropped = True
            import logging
            logging.getLogger(__name__).warning(
                "OPListTransformer %s dropped %d null element(s) across "
                "%d row(s); integral output rows are shorter than their "
                "source lists (see last_dropped_counts; further drops "
                "by this stage are not logged)",
                self.uid, total, int((dropped > 0).sum()))
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        return RaggedColumn(out_t, flat, offsets)


@register_stage
class OPSetTransformer(_FlatLift):
    """Lift over OPSet elements; output rows are de-duplicated sets
    (``OPSetTransformer.doTransform`` maps over set values)."""

    lift_name = "setElems"
    operation_name = "setElems"

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(ft.OPSet)

    @property
    def output_type(self) -> Type[FeatureType]:
        if self.transformer.output_type.column_kind is not ColumnKind.TEXT:
            raise TypeError("OPSet lifts only onto string-element sets "
                            "(MultiPickList)")
        return ft.MultiPickList

    def transform_columns(self, store: ColumnStore) -> Column:
        nested = self._lifted(store)
        return TextSetColumn(
            self.output_type,
            [{x for x in r if x is not None} for r in nested])


def lift_to_collection(transformer: Transformer,
                       collection_ftype: Type[FeatureType]) -> Transformer:
    """Pick the right lift for a collection type (the factory the
    reference spells as three class constructors)."""
    kind = collection_ftype.column_kind
    if kind is ColumnKind.MAP:
        lifted = OPMapTransformer(transformer)
    elif kind is ColumnKind.TEXT_SET:
        lifted = OPSetTransformer(transformer)
    elif kind in (ColumnKind.TEXT_LIST, ColumnKind.INTEGRAL_LIST):
        lifted = OPListTransformer(transformer)
    else:
        raise TypeError(
            f"{collection_ftype.__name__} is not a liftable collection")
    _check_elem(collection_ftype, lifted._scalar_in(), lifted.lift_name)
    return lifted
