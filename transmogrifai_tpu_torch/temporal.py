"""The temporal tier: columnar point-in-time aggregation and the hash
join; the port of ``transmogrifai_tpu/temporal.py``'s columnar engine and
joins.

TransmogrifAI's reader layer computes leakage-safe point-in-time feature
aggregates against an event-time cutoff (``AggregatedReader``,
``DataReader.scala:206-230``) and joins keyed sources
(``JoinedDataReader.scala:54-418``). The row-wise readers of
``readers/data_readers.py`` fold per record; this module is their
columnar tier:

* **The columnar aggregation engine** — group-by-key, the per-key
  cutoff and the time-windowed monoid folds over columnar batches
  (``avro.ColumnarRecords``, :class:`Table`, a joined table): one
  ``np.unique`` and one stable ``np.argsort`` group every key,
  ``np.searchsorted`` finds each key's segment, boolean masks apply the
  cutoff and window discipline, and each key's surviving values fold
  through the same ``utils/aggregators`` monoid object the row-wise
  reader uses — so the store is bit-identical to the row-wise fold's.
  ``AggregateReader`` and ``ConditionalReader`` route here when their
  source yields a columnar batch (:func:`route_aggregate`). A failing
  columnar pass raises.
* **The hash join** — ``readers.data_readers.TemporalJoinReader``
  partitions the build side by a consistent hash into bounded
  per-partition tables (a new key at a full partition drops its row,
  counted in ``join_spilled_rows`` with a warning), probes the left
  side in order, and takes a vectorized path (one stable argsort and one
  searchsorted probe) when both sides are columnar, so a
  ``JoinedAggregateDataReader`` stays columnar end to end.

Cutoff semantics (pinned; ``docs/readers.md`` has the table): with a
cutoff ``c``, predictors fold events with ``ts < c`` (within
``[c - window, c)`` when a window is declared) and responses fold events
with ``ts > c`` — strictly after, so the cutoff event itself (a
conditional reader's triggering event) lands in neither fold.

The runner installs ``customParams.aggregateColumnar`` (tri-state, with
``"auto"``), ``joinPartitions`` and ``joinTableMaxRows`` for a run
(:func:`set_run_defaults`), and the planner's measured aggregation tier
(:func:`set_aggregate_tier_hint`, from the cost database's
``phase:temporal.route_aggregate`` observations, which
:func:`route_aggregate` and :func:`tally_rowwise` feed); the
:func:`temporal_stats` tallies ride on every runner metrics document.
:func:`check_temporal` holds the cutoff-leakage rules (TMG7xx) that the
pre-flight (``lint.check_workflow``) runs over a workflow's reader.
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "TemporalError", "field", "column_key_of",
    "Table", "table_from_records", "concat_tables",
    "route_aggregate", "last_route_contested", "tally_rowwise",
    "set_aggregate_tier_hint", "aggregate_tier_hint", "check_temporal",
    "partition_of", "build_join_table",
    "set_run_defaults", "columnar_mode", "join_partitions",
    "join_table_max_rows", "temporal_stats", "reset_temporal_stats",
    "DEFAULT_JOIN_PARTITIONS", "DEFAULT_JOIN_TABLE_MAX_ROWS",
]

#: default consistent-hash partition count for the join's build-side
#: tables (``customParams.joinPartitions``)
DEFAULT_JOIN_PARTITIONS = 8

#: default per-partition build-table bound (unique keys); a new key past
#: it drops its row (``customParams.joinTableMaxRows``)
DEFAULT_JOIN_TABLE_MAX_ROWS = 1_000_000


class TemporalError(ValueError):
    """Configuration error in the temporal tier (bad knob, unroutable
    columnar request)."""


# ---------------------------------------------------------------------------
# run-scoped configuration (the runner installs customParams here)
# ---------------------------------------------------------------------------

_RUN_LOCK = threading.Lock()
_RUN: Dict[str, Any] = {"columnar": None, "join_partitions": None,
                        "join_table_max_rows": None,
                        "aggregate_hint": None}


def set_run_defaults(columnar: Any = None,
                     join_partitions: Optional[int] = None,
                     join_table_max_rows: Optional[int] = None,
                     aggregate_hint: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Install run-scoped temporal defaults (the runner's
    ``aggregateColumnar`` / ``joinPartitions`` / ``joinTableMaxRows``,
    and the planner's measured aggregation tier); returns the previous
    ones, so the runner can restore them when the run ends. ``None``
    means the module default."""
    with _RUN_LOCK:
        prev = dict(_RUN)
        _RUN.update(columnar=columnar, join_partitions=join_partitions,
                    join_table_max_rows=join_table_max_rows,
                    aggregate_hint=aggregate_hint)
    return prev


def columnar_mode() -> Any:
    """The effective columnar-aggregation mode: ``False`` (forced off),
    ``True`` (forced on: a non-columnar source still folds row-wise,
    tallied as a fallback) or ``"auto"`` (columnar when the source yields
    a columnar batch)."""
    v = _RUN["columnar"]
    if v is None or v == "auto":
        return "auto"
    return bool(v)


def set_aggregate_tier_hint(hint: Optional[str]) -> Optional[str]:
    """Install the planner's measured columnar-against-row-wise
    aggregation tier (``"columnar"``, ``"rowwise"``, or None: no
    evidence); the runner computes it from the cost database and installs
    it for the run. Returns the previous hint. The hint steers the
    ``"auto"`` route only: an explicit ``aggregateColumnar`` always wins
    (a contradiction is a TMG405 advisory)."""
    with _RUN_LOCK:
        prev = _RUN["aggregate_hint"]
        _RUN["aggregate_hint"] = hint
    return prev


def aggregate_tier_hint() -> Optional[str]:
    return _RUN["aggregate_hint"]


#: every Nth auto-routed aggregate under a "rowwise" hint still runs the
#: columnar engine, so the columnar tier keeps being measured and the
#: hint can flip back (without it the hint would be a one-way ratchet)
HINT_PROBE_EVERY = 16
_HINT_COUNT = [0]


def _hint_stand_down() -> bool:
    """True when a "rowwise" hint suppresses the columnar route for this
    pass (every HINT_PROBE_EVERY-th pass probes)."""
    with _RUN_LOCK:
        _HINT_COUNT[0] += 1
        return _HINT_COUNT[0] % HINT_PROBE_EVERY != 0


def join_partitions(explicit: Optional[int] = None) -> int:
    v = explicit if explicit is not None else _RUN["join_partitions"]
    return int(v) if v is not None else DEFAULT_JOIN_PARTITIONS


def join_table_max_rows(explicit: Optional[int] = None) -> Optional[int]:
    v = explicit if explicit is not None else _RUN["join_table_max_rows"]
    return int(v) if v is not None else DEFAULT_JOIN_TABLE_MAX_ROWS


# ---------------------------------------------------------------------------
# always-on tallies (the runner stamps them on every metrics document)
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY: Dict[str, int] = {
    "columnar_aggregates": 0, "rowwise_aggregates": 0,
    "columnar_fallbacks": 0, "hint_fallbacks": 0,
    "aggregate_rows": 0, "aggregate_keys": 0,
    "joins": 0, "columnar_joins": 0, "join_rows": 0,
    "join_matched": 0, "join_unmatched": 0, "join_spilled_rows": 0,
}


def temporal_stats() -> Dict[str, int]:
    """Snapshot of the process-wide temporal-tier tallies.
    ``columnar_fallbacks`` counts aggregates that asked for the columnar
    tier (``aggregateColumnar`` true) but folded row-wise (the source is
    not columnar, or an extractor is opaque); ``join_spilled_rows``
    counts build-side rows the bounded hash tables dropped."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_temporal_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


# ---------------------------------------------------------------------------
# field helpers
# ---------------------------------------------------------------------------


def field(name: str) -> Callable[[Mapping], Any]:
    """A record → value extractor by field name, carrying the
    ``_column_key`` marker the columnar fast paths key on (the same
    marker ``FeatureBuilder.from_column`` sets). Use it for the
    ``key_fn`` / ``timestamp_fn`` / ``condition_fn`` of temporal readers
    so they can route columnar::

        AggregateReader(base, timestamp_fn=temporal.field("ts"),
                        key_fn=temporal.field("user"), ...)
    """
    def fn(rec):
        return rec.get(name)
    fn._column_key = name
    return fn


def column_key_of(fn: Any) -> Optional[str]:
    """The column name a callable extracts, when statically known
    (``_column_key`` marker), else None — the columnar router's
    resolvability test."""
    return getattr(fn, "_column_key", None)


# ---------------------------------------------------------------------------
# Table — columnar batch with per-column validity (the joined shape)
# ---------------------------------------------------------------------------


class Table:
    """Columnar record batch with optional per-column validity masks.

    The temporal tier's working shape: ``columns`` holds fully-valid
    numpy columns (safe for the bulk extract lane), ``masked_columns``
    holds ``(values, valid_mask)`` pairs for columns with per-row
    missingness (a left-outer join's unmatched right side), and
    ``null_fields`` names all-None columns. Iterating yields the same
    dicts a row-wise reader would build (None where masked/null), so
    every non-columnar consumer keeps working; columnar consumers read
    the arrays and never materialize a dict."""

    __slots__ = ("columns", "masked_columns", "null_fields", "_names",
                 "n_rows", "_dicts")

    def __init__(self, columns: Dict[str, np.ndarray],
                 masked_columns: Optional[
                     Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
                 null_fields: Sequence[str] = (),
                 names: Optional[Sequence[str]] = None,
                 n_rows: Optional[int] = None):
        self.columns = dict(columns)
        self.masked_columns = dict(masked_columns or {})
        self.null_fields = frozenset(null_fields)
        self._names = list(names) if names is not None else (
            list(self.columns) + list(self.masked_columns)
            + [f for f in self.null_fields
               if f not in self.columns and f not in self.masked_columns])
        if n_rows is not None:
            self.n_rows = int(n_rows)
        elif self.columns:
            self.n_rows = int(next(iter(self.columns.values())).shape[0])
        elif self.masked_columns:
            self.n_rows = int(
                next(iter(self.masked_columns.values()))[0].shape[0])
        else:
            self.n_rows = 0
        self._dicts: Optional[List[Dict[str, Any]]] = None

    def __len__(self) -> int:
        return self.n_rows

    def __bool__(self) -> bool:
        return self.n_rows > 0

    @staticmethod
    def _pyval(arr: np.ndarray, i: int) -> Any:
        v = arr[i]
        return v.item() if isinstance(v, np.generic) else v

    def _row(self, i: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for nm in self._names:
            if nm in self.null_fields:
                out[nm] = None
            elif nm in self.columns:
                out[nm] = self._pyval(self.columns[nm], i)
            else:
                vals, mask = self.masked_columns[nm]
                out[nm] = self._pyval(vals, i) if mask[i] else None
        return out

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._row(j) for j in range(*i.indices(self.n_rows))]
        n = self.n_rows
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._row(i)

    def _materialize(self) -> List[Dict[str, Any]]:
        if self._dicts is None:
            lists = []
            for nm in self._names:
                if nm in self.null_fields:
                    lists.append([None] * self.n_rows)
                elif nm in self.columns:
                    lists.append(self.columns[nm].tolist())
                else:
                    vals, mask = self.masked_columns[nm]
                    lists.append([v if m else None for v, m
                                  in zip(vals.tolist(), mask.tolist())])
            names = self._names
            self._dicts = [dict(zip(names, row)) for row in zip(*lists)]
            if not lists:
                self._dicts = [{} for _ in range(self.n_rows)]
        return self._dicts

    def __iter__(self):
        return iter(self._materialize())

    def __repr__(self) -> str:
        return f"Table({self.n_rows} rows × {len(self._names)} cols)"


def table_from_records(records: Sequence[Mapping[str, Any]],
                       fields: Optional[Sequence[str]] = None) -> Table:
    """Build a :class:`Table` from dict records (first-seen field order):
    all-bool columns become bool, all-int int64, all-numeric float64,
    anything else an object column; ``None`` values become validity
    masks (all-None fields become ``null_fields``). The row-wise view of
    the result iterates as the same dicts that went in."""
    if fields is None:
        fields = []
        for r in records:
            for k in r:
                if k not in fields:
                    fields.append(k)
    n = len(records)
    cols: Dict[str, np.ndarray] = {}
    masked: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    nulls: List[str] = []
    for f in fields:
        vals = [r.get(f) for r in records]
        present = [v for v in vals if v is not None]
        if not present:
            nulls.append(f)
            continue
        if all(isinstance(v, bool) for v in present):
            arr = np.array([bool(v) if v is not None else False
                            for v in vals], dtype=bool)
        elif all(isinstance(v, int) and not isinstance(v, bool)
                 for v in present):
            arr = np.array([int(v) if v is not None else 0 for v in vals],
                           dtype=np.int64)
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in present):
            arr = np.array([float(v) if v is not None else np.nan
                            for v in vals], dtype=np.float64)
        else:
            arr = np.empty(n, dtype=object)
            arr[:] = vals
        if len(present) == n:
            cols[f] = arr
        else:
            masked[f] = (arr, np.array([v is not None for v in vals],
                                       dtype=bool))
    return Table(cols, masked, nulls, names=fields, n_rows=n)


def _is_table(records: Any) -> bool:
    """Anything exposing numpy ``columns`` (avro.ColumnarRecords, Table)
    takes the columnar lanes."""
    return getattr(records, "columns", None) is not None


def concat_tables(tables: Sequence[Any]) -> Table:
    """Row-concatenate columnar batches (same column names required).
    Columns that are masked/null in ANY part become masked in the result
    — validity is per part, never forgotten."""
    tables = list(tables)
    if not tables:
        return Table({})
    names = _names_of(tables[0])
    for t in tables[1:]:
        if _names_of(t) != names:
            raise TemporalError(
                "concat_tables: column names differ between parts")
    cols: Dict[str, np.ndarray] = {}
    masked: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    nulls: List[str] = []
    n = sum(len(t) for t in tables)
    for nm in names:
        parts = [_column_of(t, nm, len(t)) for t in tables]
        if all(p[0] is None for p in parts):
            nulls.append(nm)
            continue
        vals = np.concatenate([
            p[0] if p[0] is not None
            else np.zeros(len(t), dtype=next(
                q[0].dtype for q in parts if q[0] is not None))
            for p, t in zip(parts, tables)])
        if all(p[0] is not None and p[1] is None for p in parts):
            cols[nm] = vals
        else:
            mask = np.concatenate([
                (p[1] if p[1] is not None
                 else np.ones(len(t), bool) if p[0] is not None
                 else np.zeros(len(t), bool))
                for p, t in zip(parts, tables)])
            masked[nm] = (vals, mask)
    return Table(cols, masked, nulls, names=names, n_rows=n)


def _names_of(table: Any) -> List[str]:
    names = getattr(table, "_names", None)
    if names is not None:
        return list(names)
    return list(table.columns)


def _column_of(table: Any, name: str, n: int
               ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(values, validity) of one column — ``(None, None)`` means
    all-None (null field or absent from the batch; a row-wise
    ``rec.get`` would see None everywhere too)."""
    nulls = getattr(table, "null_fields", frozenset())
    if name in nulls:
        return None, None
    masked = getattr(table, "masked_columns", None) or {}
    if name in masked:
        vals, mask = masked[name]
        return vals, mask
    cols = table.columns
    if name in cols:
        return cols[name], None
    return None, None


# ---------------------------------------------------------------------------
# the columnar aggregation engine
# ---------------------------------------------------------------------------


class _FeatureSpec:
    """One raw feature's columnar fold plan (resolved identically to the
    row-wise reader: explicit aggregator, else the feature type's
    default monoid, else last-value)."""

    __slots__ = ("name", "ftype", "column", "aggregator", "window_ms",
                 "is_response")

    def __init__(self, name, ftype, column, aggregator, window_ms,
                 is_response):
        self.name = name
        self.ftype = ftype
        self.column = column
        self.aggregator = aggregator
        self.window_ms = window_ms
        self.is_response = is_response


def _resolve_specs(raw_features) -> List[_FeatureSpec]:
    """Per-feature fold plan, or raise :class:`TemporalError` when any
    feature's extractor is not statically column-keyed (a custom lambda
    the columnar tier cannot vectorize → the caller falls back
    row-wise)."""
    from .stages.generator import FeatureGeneratorStage
    from .utils.aggregators import aggregator_of
    specs = []
    for f in raw_features:
        gen = f.origin_stage
        if not isinstance(gen, FeatureGeneratorStage):
            raise TemporalError(f"{f.name!r} has no generator stage")
        col = column_key_of(gen.extract_fn)
        if col is None:
            raise TemporalError(
                f"{f.name!r} extracts via an opaque callable — the "
                "columnar engine needs a column-keyed extractor "
                "(from_column / temporal.field)")
        agg = gen.aggregator
        if agg is None:
            try:
                agg = aggregator_of(f.ftype)
            except ValueError:
                agg = None       # last-value, the row-wise default
        specs.append(_FeatureSpec(f.name, f.ftype, col, agg,
                                  gen.window_ms, f.is_response))
    return specs


def _group_keys(keys: np.ndarray):
    """Stable group-by: unique keys in ascending order (the row-wise
    reader's ``sorted(groups)``) plus, per key, the segment bounds into
    a stably key-sorted row order — original record order WITHIN each
    key is preserved, which is what keeps float fold order (and
    therefore bits) identical to the row-wise loop."""
    uniques, codes = np.unique(keys, return_inverse=True)
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    idx = np.arange(len(uniques))
    starts = np.searchsorted(sorted_codes, idx, side="left")
    ends = np.searchsorted(sorted_codes, idx, side="right")
    return uniques, codes, order, starts, ends


def _time_masks(ts_sorted: np.ndarray, cutoff_sorted: np.ndarray):
    """(predictor base mask, response mask, keep-always mask) over the
    key-sorted rows. ``cutoff_sorted`` is float with NaN meaning "no
    cutoff for this key" (everything folds on both sides — the row-wise
    contract). The pinned boundary: predictors ``ts < c``, responses
    ``ts > c`` — strictly after, the cutoff row lands in neither fold.
    A NaN EVENT TIME folds into BOTH sides: the row-wise loop's
    ``ts <= c`` / ``ts >= c`` guards are all False for NaN so no
    ``continue`` ever fires — parity is the contract, so the columnar
    masks keep those rows too (the returned keep-always mask also
    bypasses per-feature window filters, as row-wise NaN comparisons
    do)."""
    no_cut = np.isnan(cutoff_sorted) | np.isnan(ts_sorted)
    with np.errstate(invalid="ignore"):
        pred = no_cut | (ts_sorted < cutoff_sorted)
        resp = no_cut | (ts_sorted > cutoff_sorted)
    return pred, resp, no_cut


def _fold_segments(vals_sorted: Optional[np.ndarray],
                   valid_sorted: Optional[np.ndarray],
                   time_mask: np.ndarray,
                   key_index: Sequence[int],
                   starts: np.ndarray, ends: np.ndarray,
                   agg) -> List[Any]:
    """Fold one feature for every (kept) key: slice the key's segment,
    apply the time/validity mask, hand the surviving values — as the
    same Python list the row-wise loop builds — to the SAME monoid
    ``fold`` (or take the last value when the feature has no
    aggregator). Bit parity is by construction: same values, same
    order, same fold expression."""
    out: List[Any] = []
    for ki in key_index:
        s, e = int(starts[ki]), int(ends[ki])
        if vals_sorted is None:
            out.append(None)
            continue
        m = time_mask[s:e]
        if valid_sorted is not None:
            m = m & valid_sorted[s:e]
        vals = vals_sorted[s:e][m].tolist()
        if agg is None:
            out.append(vals[-1] if vals else None)
        else:
            out.append(agg.fold(vals))
    return out


def _per_key_cutoffs_conditional(reader, records, codes: np.ndarray,
                                 ts: np.ndarray, n_keys: int
                                 ) -> np.ndarray:
    """Per-key cutoff = min event time where the condition holds (NaN =
    no conditioning event). The predicate is an arbitrary callable, so
    it runs once over the (memoized) dict view; the min-merge is exact,
    so the vectorized reduction matches ``min(times)`` bit-for-bit."""
    cond = np.fromiter((bool(reader.condition_fn(r)) for r in records),
                       dtype=bool, count=len(records))
    cut = np.full(n_keys, np.inf)
    if cond.any():
        np.minimum.at(cut, codes[cond], ts[cond].astype(np.float64))
    cut[np.isinf(cut)] = np.nan
    return cut


def _columnar_aggregate(reader, records, raw_features) -> Any:
    """The engine: one grouping pass, shared masks, per-feature folds.
    Returns a ColumnStore bit-identical to the row-wise
    ``generate_store`` on the same records."""
    from .columns import ColumnStore, column_from_values
    from .readers.data_readers import ConditionalReader

    key_key = column_key_of(reader.key_fn)
    ts_key = column_key_of(reader.timestamp_fn)
    if key_key is None or ts_key is None:
        raise TemporalError(
            "key_fn/timestamp_fn are opaque callables — use "
            "temporal.field()/from_column-style extractors for the "
            "columnar path")
    specs = _resolve_specs(raw_features)
    n = len(records)
    keys, kmask = _column_of(records, key_key, n)
    ts, tmask = _column_of(records, ts_key, n)
    if keys is None or ts is None or kmask is not None or tmask is not None:
        raise TemporalError(
            f"key column {key_key!r} / timestamp column {ts_key!r} must "
            "be present and fully valid in the columnar batch")

    uniques, codes, order, starts, ends = _group_keys(keys)
    ts_sorted = np.asarray(ts, dtype=np.float64)[order]

    conditional = isinstance(reader, ConditionalReader)
    if conditional:
        cut = _per_key_cutoffs_conditional(reader, records, codes, ts,
                                           len(uniques))
        if reader.drop_if_no_condition:
            key_index = [int(i) for i in
                         np.flatnonzero(~np.isnan(cut))]
        else:
            key_index = list(range(len(uniques)))
    else:
        c = reader.cutoff.timestamp_ms
        cut = np.full(len(uniques), np.nan if c is None else float(c))
        key_index = list(range(len(uniques)))

    cutoff_sorted = cut[codes[order]]
    pred_base, resp_mask, no_cut = _time_masks(ts_sorted, cutoff_sorted)

    cols: Dict[str, Any] = {}
    window_masks: Dict[Any, np.ndarray] = {}
    for spec in specs:
        if spec.is_response:
            mask = resp_mask
        elif spec.window_ms is not None:
            wm = window_masks.get(spec.window_ms)
            if wm is None:
                with np.errstate(invalid="ignore"):
                    wm = pred_base & (
                        no_cut
                        | (ts_sorted >= cutoff_sorted - spec.window_ms))
                window_masks[spec.window_ms] = wm
            mask = wm
        else:
            mask = pred_base
        vals, valid = _column_of(records, spec.column, n)
        vals_sorted = vals[order] if vals is not None else None
        valid_sorted = valid[order] if valid is not None else None
        values = _fold_segments(vals_sorted, valid_sorted, mask,
                                key_index, starts, ends, spec.aggregator)
        cols[spec.name] = column_from_values(spec.ftype, values)
    _tally("aggregate_rows", n)
    _tally("aggregate_keys", len(key_index))
    return ColumnStore(cols, len(key_index))


def route_aggregate(reader, records, raw_features):
    """The routing seam ``AggregateReader.generate_store`` calls: returns
    the columnar store, or None for the row-wise fold. Routing: the
    ``aggregateColumnar`` tri-state (off → None; auto → only columnar
    batches; forced on → a non-columnar source still returns None,
    tallied as a fallback). Opaque extractors (a :class:`TemporalError`
    from the engine's plan) decline to the row-wise fold; any other
    failure of the columnar pass raises."""
    _ROUTE_STATE.contested = False
    mode = columnar_mode()
    if mode is False:
        return None
    if not _is_table(records):
        if mode is True:
            _tally("columnar_fallbacks")
            logger.warning(
                "aggregateColumnar=true but the source yields %s — "
                "row-wise fold serves", type(records).__name__)
        return None
    # a columnar batch: from here on the tier decision is real, whichever
    # path serves
    _ROUTE_STATE.contested = True
    if mode == "auto" and aggregate_tier_hint() == "rowwise" \
            and _hint_stand_down():
        # the cost database measured the row-wise fold faster for this
        # workload (planner.aggregate_route_tier): the auto route defers
        # to it, and every HINT_PROBE_EVERY-th pass still runs columnar
        _tally("hint_fallbacks")
        return None
    t0 = time.perf_counter()
    try:
        store = _columnar_aggregate(reader, records, raw_features)
    except TemporalError:
        # structurally unroutable (opaque extractors): this reader never
        # had a columnar option, whatever its record type
        _ROUTE_STATE.contested = False
        if mode is True:
            _tally("columnar_fallbacks")
        return None
    _tally("columnar_aggregates")
    # the planner's cost database learns the columnar tier's cost
    # (phase:temporal.route_aggregate, planner.aggregate_route_tier)
    from . import planner
    planner.observe_phase("temporal.route_aggregate", "columnar",
                          time.perf_counter() - t0, len(records))
    return store


#: per-thread disposition of the last route_aggregate call: ``contested``
#: is True only when the columnar tier was a real option for that pass
#: (not for row-list sources, forced-off mode or opaque extractors)
_ROUTE_STATE = threading.local()


def last_route_contested() -> bool:
    """Whether this thread's last :func:`route_aggregate` call was a
    genuine columnar-against-row-wise tier decision."""
    return bool(getattr(_ROUTE_STATE, "contested", False))


def tally_rowwise(n_rows: int, seconds: Optional[float] = None) -> None:
    """Count one row-wise aggregation pass, so the columnar and row-wise
    split shows in every metrics document. ``seconds`` (given when the
    pass declined a real columnar option, :func:`last_route_contested`)
    feeds the planner's cost database as the row-wise half of the
    ``phase:temporal.route_aggregate`` tier decision."""
    _tally("rowwise_aggregates")
    _tally("aggregate_rows", n_rows)
    if seconds is not None:
        from . import planner
        planner.observe_phase("temporal.route_aggregate", "rowwise",
                              seconds, n_rows)


# ---------------------------------------------------------------------------
# the hash join
# ---------------------------------------------------------------------------


def _canonical_key(key: Any) -> str:
    """Canonical hash text of a join key, matching PYTHON DICT equality:
    ``1``, ``1.0``, ``True`` and ``np.float64(1.0)`` are the same dict
    key, so they must land in the same partition — hashing ``repr``
    directly would split a float-keyed probe side (avro doubles) from an
    int-keyed build side (JSON records) and silently unmatch every
    row."""
    if isinstance(key, (bool, np.bool_)):
        key = int(key)
    if isinstance(key, np.generic):
        key = key.item()
    if isinstance(key, float) and key.is_integer():
        key = int(key)
    return repr(key)


def partition_of(key: Any, n_partitions: int) -> int:
    """Consistent-hash partition of a join key (the fleet/canary blake2b
    routing discipline — stable across processes and runs, unlike
    ``hash()`` under PYTHONHASHSEED). Keys are canonicalized first so
    dict-equal keys of different numeric types share a partition."""
    h = hashlib.blake2b(_canonical_key(key).encode("utf-8", "replace"),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") % max(1, int(n_partitions))


class _ColumnarBuildTable:
    """Vectorized build side: sorted unique keys + the ORIGINAL row
    index of each key's last occurrence (the dict path's
    last-update-wins), probed via ``np.searchsorted``."""

    def __init__(self, table: Any, key_field: str):
        n = len(table)
        keys, kmask = _column_of(table, key_field, n)
        if keys is None or kmask is not None:
            raise TemporalError(
                f"join key column {key_field!r} must be present and "
                "fully valid on the build side")
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        uniq, counts = np.unique(sorted_keys, return_counts=True)
        last_sorted = np.cumsum(counts) - 1
        self.table = table
        self.key_field = key_field
        self.uniq = uniq
        self.last_row = order[last_sorted]
        self.n_keys = len(uniq)

    def probe(self, left: Any, key_field: str, join_type: str) -> Table:
        n = len(left)
        lk, lmask = _column_of(left, key_field, n)
        if lk is None or lmask is not None:
            raise TemporalError(
                f"join key column {key_field!r} must be present and "
                "fully valid on the probe side")
        if self.n_keys:
            pos = np.searchsorted(self.uniq, lk, side="left")
            posc = np.clip(pos, 0, self.n_keys - 1)
            matched = self.uniq[posc] == lk
            ridx = self.last_row[posc]
        else:
            matched = np.zeros(n, dtype=bool)
            ridx = np.zeros(n, dtype=np.int64)
        _tally("join_rows", n)
        _tally("join_matched", int(matched.sum()))
        _tally("join_unmatched", int(n - matched.sum()))

        left_names = _names_of(left)
        right_names = [nm for nm in _names_of(self.table)
                       if nm not in left_names]
        sel = np.flatnonzero(matched) if join_type == "inner" else None
        out_n = len(sel) if sel is not None else n

        cols: Dict[str, np.ndarray] = {}
        masked: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        nulls: List[str] = []
        for nm in left_names:                       # left wins shared names
            vals, valid = _column_of(left, nm, n)
            if vals is None:
                nulls.append(nm)
                continue
            v = vals[sel] if sel is not None else vals
            if valid is None:
                cols[nm] = v
            else:
                masked[nm] = (v, valid[sel] if sel is not None else valid)
        rn = len(self.table)
        for nm in right_names:
            vals, valid = _column_of(self.table, nm, rn)
            if vals is None or self.n_keys == 0:
                nulls.append(nm)
                continue
            take = ridx[sel] if sel is not None else ridx
            v = vals[take]
            ok = np.ones(out_n, dtype=bool) if sel is not None \
                else matched.copy()
            if valid is not None:
                ok &= valid[take]
            if ok.all():
                cols[nm] = v
            else:
                masked[nm] = (v, ok)
        return Table(cols, masked, nulls, names=left_names + right_names,
                     n_rows=out_n)


class _DictBuildTable:
    """Row-wise build side: consistent-hash partitioned, bounded
    per-partition hash tables. A new key arriving at a full partition
    drops its row instead of growing the heap; the drops are counted in
    ``join_spilled_rows`` and logged once per build."""

    def __init__(self, records: Iterable[Mapping[str, Any]], key_fn,
                 partitions: int, max_rows: Optional[int]):
        self.partitions = max(1, int(partitions))
        self.tables: List[Dict[Any, Dict[str, Any]]] = [
            {} for _ in range(self.partitions)]
        spilled = 0
        for r in records:
            k = key_fn(r)
            t = self.tables[partition_of(k, self.partitions)]
            if k not in t and max_rows is not None \
                    and len(t) >= max_rows:
                spilled += 1
                continue
            t.setdefault(k, {}).update(r)
        if spilled:
            _tally("join_spilled_rows", spilled)
            logger.warning(
                "join build table overflow: %d row(s) of new keys dropped "
                "(%d partition(s) bounded at %s keys each)", spilled,
                self.partitions, max_rows)

    def get(self, key: Any) -> Optional[Dict[str, Any]]:
        return self.tables[partition_of(key, self.partitions)].get(key)

    def probe(self, left_records, left_key_fn,
              join_type: str) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        matched = unmatched = 0
        for rec in left_records:
            k = left_key_fn(rec)
            r = self.get(k)
            if r is None:
                unmatched += 1
                if join_type == "inner":
                    continue
                out.append(dict(rec))
            else:
                matched += 1
                merged = dict(r)
                merged.update(rec)
                out.append(merged)
        _tally("join_rows", matched + unmatched)
        _tally("join_matched", matched)
        _tally("join_unmatched", unmatched)
        return out


def build_join_table(right_records, key_field_or_fn,
                     partitions: Optional[int] = None,
                     table_max_rows: Optional[int] = None):
    """Build the join's build-side table: vectorized when the right
    source is a columnar batch with a statically known key column (and
    within the partition bound), else the partitioned bounded dict
    tables. Both probe to the same output values."""
    kf = key_field_or_fn
    key_field = kf if isinstance(kf, str) else column_key_of(kf)
    p = join_partitions(partitions)
    cap = join_table_max_rows(table_max_rows)
    if _is_table(right_records) and key_field is not None \
            and columnar_mode() is not False:
        try:
            built = _ColumnarBuildTable(right_records, key_field)
        except TemporalError:
            built = None
        if built is not None:
            if cap is None or built.n_keys <= p * cap:
                _tally("columnar_joins")
                return built
            # over the bound: the dict path's per-partition spill is the
            # sanctioned memory-bounded behavior
    key_fn = kf if callable(kf) else field(key_field)
    return _DictBuildTable(right_records, key_fn, p, cap)


# ---------------------------------------------------------------------------
# cutoff leakage rules (TMG7xx)
# ---------------------------------------------------------------------------


def _reader_chain(reader) -> List[Any]:
    """Every reader reachable through base/left/right wrappers (the
    aggregate-over-filtered-join compositions), root first."""
    out: List[Any] = []
    seen = set()
    stack = [reader]
    while stack:
        r = stack.pop()
        if r is None or id(r) in seen:
            continue
        seen.add(id(r))
        out.append(r)
        for attr in ("base", "left", "right"):
            stack.append(getattr(r, attr, None))
    return out


def _response_sources(responses) -> Dict[str, str]:
    """{source column: feature name} for response raw features whose
    extraction is statically column-keyed."""
    from .stages.generator import FeatureGeneratorStage
    out: Dict[str, str] = {}
    for r in responses:
        gen = r.origin_stage
        if not isinstance(gen, FeatureGeneratorStage):
            continue
        src = column_key_of(gen.extract_fn) or gen.extract_source
        if src:
            out.setdefault(str(src), r.name)
    return out


def check_temporal(reader, result_features) -> List[Any]:
    """The cutoff-leakage rules (TMG7xx) over a workflow's reader and raw
    features: the reader object is inspected and never polled, so no data
    is read. Returns ``lint.Finding`` records, which the graph checker
    folds into the ``failOn`` / ``lintSuppress`` flow. The cutoff
    semantics are the module docstring's."""
    from .lint import Finding
    from .readers.data_readers import (AggregateReader, ConditionalReader,
                                       JoinedDataReader, TemporalJoinReader)
    from .stages.generator import FeatureGeneratorStage

    findings: List[Any] = []
    raws: List[Any] = []
    seen = set()
    for f in result_features:
        for raw in f.raw_features():
            if id(raw) not in seen:
                seen.add(id(raw))
                raws.append(raw)
    responses = [f for f in raws if f.is_response]
    predictors = [f for f in raws if not f.is_response]
    chain = _reader_chain(reader)
    agg = next((r for r in chain if isinstance(r, AggregateReader)), None)
    joins = [r for r in chain
             if isinstance(r, (JoinedDataReader, TemporalJoinReader))]

    if agg is not None:
        conditional = isinstance(agg, ConditionalReader)
        if not conditional and agg.cutoff.timestamp_ms is None \
                and responses and predictors:
            # TMG701: every predictor fold would see post-outcome rows
            pnames = ", ".join(p.name for p in predictors)
            rnames = ", ".join(r.name for r in responses)
            findings.append(Finding(
                "TMG701",
                f"point-in-time aggregation with NO cutoff while "
                f"response(s) [{rnames}] fold from the same events: "
                f"predictor fold(s) [{pnames}] would see post-outcome "
                "rows — set CutOffTime.at(...) or use a conditional "
                "reader", feature=responses[0].name))
        for r in responses:
            gen = r.origin_stage
            if isinstance(gen, FeatureGeneratorStage) \
                    and gen.window_ms is not None:
                findings.append(Finding(
                    "TMG702",
                    f"response {r.name!r} declares an event-time window "
                    f"({gen.window_ms} ms): responses fold strictly "
                    "AFTER the cutoff, so a window reaches back across "
                    "it into the predictor window [cutoff - w, cutoff) "
                    "— drop the window or make the feature a predictor",
                    feature=r.name))

    if joins and responses:
        resp_srcs = _response_sources(responses)
        for j in joins:
            jkeys = set()
            kfield = getattr(j, "key_field", None)
            if kfield:
                jkeys.add(str(kfield))
            for side in ("left", "right"):
                side_reader = getattr(j, side, None)
                if side_reader is not None:
                    k = column_key_of(getattr(side_reader, "key_fn", None))
                    if k:
                        jkeys.add(str(k))
            for hit in sorted(jkeys & set(resp_srcs)):
                findings.append(Finding(
                    "TMG703",
                    f"join key {hit!r} is also the source field of "
                    f"response {resp_srcs[hit]!r}: a key derived from a "
                    "post-cutoff field routes outcome information into "
                    "the joined predictors", feature=resp_srcs[hit]))
    return findings
