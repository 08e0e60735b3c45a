"""Data readers: host-side ingestion into record dicts and raw feature
stores; the port of ``transmogrifai_tpu/readers/data_readers.py``
(``DataReader.scala:57-230``, ``DataReaders.scala:43-278``,
``JoinedDataReader.scala:54-418``). Readers run on the host; only the
dense arrays of the fitted stages reach the card.

* ``DataReader.read_records()`` → a list of record dicts (or a columnar
  batch that iterates as them); ``generate_store`` runs each raw
  feature's extract function over them (generateDataFrame).
* :class:`CSVReader`, :class:`CSVAutoReader` (header-inferred),
  :class:`ParquetReader` (pandas, imported when a file is read) and
  :class:`AvroReader` (``readers/avro.py``).
* :class:`AggregateReader` — group records by key and fold each
  feature's values through its monoid aggregator under the event-time
  cutoff (``FeatureAggregator.extract``: responses strictly after the
  cutoff, predictors strictly before — leak prevention,
  ``FeatureAggregator.scala:99-119``; the cutoff event itself lands in
  neither fold — ``docs/readers.md`` has the boundary table).
  ``Workflow.train`` hands raw-store generation to it
  (``is_aggregating``): one row per key, not one per event.
* :class:`ConditionalReader` — a per-key cutoff fixed by an event
  predicate (``ConditionalParams``).
* :class:`JoinedDataReader` — left-outer or inner joins on keys;
  :class:`TemporalJoinReader` — the bounded, partitioned hash join that
  stays columnar when both sides are (``temporal.py``);
  :class:`JoinedAggregateDataReader` — join, then aggregate.
* :class:`TimeBasedFilter`, :class:`FilteredReader`, :func:`stream_score`
  and the ``DataReaders.simple`` / ``.aggregate`` / ``.conditional``
  factories.

Aggregating readers route to the columnar temporal engine
(``temporal.route_aggregate``) when their source yields a columnar batch
(``avro.ColumnarRecords``, ``temporal.Table``, a columnar join) and every
extractor is column-keyed; the store is bit-identical to the row-wise
fold's. A failing columnar pass raises.
"""
from __future__ import annotations

import csv as _csv
import time
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence)

from ..columns import ColumnStore, column_from_values
from ..features import Feature
from ..stages.generator import FeatureGeneratorStage

__all__ = ["DataReader", "CSVReader", "CSVAutoReader", "ParquetReader",
           "AvroReader", "AggregateReader", "ConditionalReader",
           "JoinedDataReader", "JoinedAggregateDataReader",
           "TemporalJoinReader", "TimeBasedFilter",
           "FilteredReader", "DataReaders", "CutOffTime", "stream_score"]


@dataclass
class CutOffTime:
    """Event-time cutoff for aggregation (readers ``CutOffTime``)."""

    timestamp_ms: Optional[int] = None

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime(None)

    @staticmethod
    def at(timestamp_ms: int) -> "CutOffTime":
        """Fixed cutoff (CutOffTime.asOf analog)."""
        return CutOffTime(int(timestamp_ms))


class DataReader:
    """Base reader: produces record dicts; generates raw feature columns."""

    def __init__(self, key_fn: Optional[Callable[[Dict], str]] = None):
        self.key_fn = key_fn or (lambda r: str(r.get("id", "")))

    def read_records(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def generate_store(self, raw_features: Sequence[Feature]) -> ColumnStore:
        """Every raw feature's extract function over every record
        (DataReader.generateDataFrame, DataReader.scala:173-197)."""
        records = self.read_records()
        cols = {}
        for f in raw_features:
            gen = f.origin_stage
            if not isinstance(gen, FeatureGeneratorStage):
                raise TypeError(f"raw feature {f.name!r} has no generator")
            cols[f.name] = gen.extract_column(records)
        return ColumnStore(cols, len(records))


class _InMemoryReader(DataReader):
    def __init__(self, records: Sequence[Mapping[str, Any]],
                 key_fn: Optional[Callable[[Dict], str]] = None):
        super().__init__(key_fn)
        self._records = [dict(r) for r in records]

    def read_records(self) -> List[Dict[str, Any]]:
        return self._records


class CSVReader(DataReader):
    """CSV with an explicit schema: column names in order (the
    avro-schema ``CSVReader`` analog)."""

    def __init__(self, path: str, schema: Sequence[str],
                 key_fn: Optional[Callable[[Dict], str]] = None,
                 delimiter: str = ","):
        super().__init__(key_fn)
        self.path = path
        self.schema = list(schema)
        self.delimiter = delimiter

    def read_records(self) -> List[Dict[str, Any]]:
        from .. import resilience
        resilience.inject("csv.decode", path=self.path)
        with open(self.path, newline="") as fh:
            return [{name: (v if v != "" else None)
                     for name, v in zip(self.schema, row)}
                    for row in _csv.reader(fh, delimiter=self.delimiter)]


class CSVAutoReader(CSVReader):
    """Header-inferring CSV reader (CSVAutoReaders.scala:142)."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Dict], str]] = None,
                 delimiter: str = ","):
        with open(path, newline="") as fh:
            header = next(_csv.reader(fh, delimiter=delimiter))
        super().__init__(path, header, key_fn, delimiter)

    def read_records(self) -> List[Dict[str, Any]]:
        return super().read_records()[1:]


class AggregateReader(DataReader):
    """Group-by-key and monoid aggregation with cutoff-time leak
    prevention (AggregatedReader, DataReader.scala:206-230).

    Cutoff boundary (pinned — docs/readers.md): predictors fold events
    with ``ts < cutoff`` (within ``[cutoff - window, cutoff)`` under a
    declared window), responses fold events with ``ts > cutoff`` —
    strictly after, so an event exactly at the cutoff (a conditional
    reader's triggering event) lands in neither fold.

    When the source yields a columnar batch (``avro.ColumnarRecords``,
    ``temporal.Table``, a columnar join) and every extractor is
    column-keyed, ``generate_store`` routes to the columnar temporal
    engine (``temporal.route_aggregate``): the same store, no per-record
    Python dispatch.
    """

    #: Workflow.train hands raw-store generation to the reader (the
    #: cutoff discipline lives here, not in the workflow)
    is_aggregating = True

    def __init__(self, base: DataReader,
                 timestamp_fn: Callable[[Dict], int],
                 cutoff: CutOffTime = CutOffTime.no_cutoff(),
                 key_fn: Optional[Callable[[Dict], str]] = None):
        super().__init__(key_fn or base.key_fn)
        self.base = base
        self.timestamp_fn = timestamp_fn
        self.cutoff = cutoff

    def read_records(self) -> List[Dict[str, Any]]:
        return self.base.read_records()

    def _cutoff_for_key(self, records: List[Dict[str, Any]]) -> Optional[int]:
        return self.cutoff.timestamp_ms

    def generate_store(self, raw_features: Sequence[Feature]) -> ColumnStore:
        from .. import temporal
        records = self.read_records()
        store = temporal.route_aggregate(self, records, raw_features)
        if store is not None:
            return store
        # timed for the planner's cost database only when the route just
        # declined a real columnar option (row-list sources, forced-off
        # mode and opaque extractors never had one)
        contested = temporal.last_route_contested()
        t0 = time.perf_counter()
        store = self._rowwise_store(records, raw_features)
        temporal.tally_rowwise(
            len(records),
            seconds=(time.perf_counter() - t0) if contested else None)
        return store

    def _rowwise_store(self, records, raw_features: Sequence[Feature]
                       ) -> ColumnStore:
        """The reference row-wise fold — also the parity oracle the
        columnar engine is asserted bit-identical against."""
        from collections import defaultdict
        groups: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
        for rec in records:
            groups[self.key_fn(rec)].append(rec)
        keys = sorted(groups)
        cols: Dict[str, Any] = {}
        for f in raw_features:
            gen = f.origin_stage
            if not isinstance(gen, FeatureGeneratorStage):
                raise TypeError(f"raw feature {f.name!r} has no generator")
            # no explicit aggregator → the feature type's default monoid
            # (MonoidAggregatorDefaults.aggregatorOf, applied by the
            # reference's FeatureAggregator the same way)
            agg = gen.aggregator
            if agg is None:
                from ..utils.aggregators import aggregator_of
                try:
                    agg = aggregator_of(f.ftype)
                except ValueError:
                    agg = None
            values = []
            for k in keys:
                recs = groups[k]
                cutoff = self._cutoff_for_key(recs)
                window = gen.window_ms
                vals = []
                for r in recs:
                    ts = self.timestamp_fn(r)
                    if cutoff is not None:
                        if f.is_response:
                            # responses STRICTLY after cutoff: the
                            # cutoff event itself (ts == cutoff, e.g. a
                            # conditional reader's triggering purchase)
                            # must not fold into the outcome
                            if ts <= cutoff:
                                continue
                        else:
                            # predictors BEFORE cutoff, within window
                            if ts >= cutoff:
                                continue
                            if window is not None and ts < cutoff - window:
                                continue
                    v = gen.extract_fn(r)
                    if v is not None:
                        vals.append(v)
                if agg is None:
                    values.append(vals[-1] if vals else None)
                else:
                    values.append(agg.fold(vals))
            cols[f.name] = column_from_values(f.ftype, values)
        return ColumnStore(cols, len(keys))


class ConditionalReader(AggregateReader):
    """Cutoff per key = timestamp of first record matching the predicate
    (conditional readers, DataReaders.scala:196-278)."""

    def __init__(self, base: DataReader,
                 timestamp_fn: Callable[[Dict], int],
                 condition_fn: Callable[[Dict], bool],
                 drop_if_no_condition: bool = True,
                 key_fn: Optional[Callable[[Dict], str]] = None):
        super().__init__(base, timestamp_fn, CutOffTime.no_cutoff(), key_fn)
        self.condition_fn = condition_fn
        self.drop_if_no_condition = drop_if_no_condition

    def _cutoff_for_key(self, records: List[Dict[str, Any]]) -> Optional[int]:
        times = [self.timestamp_fn(r) for r in records if self.condition_fn(r)]
        return min(times) if times else None

    def _rowwise_store(self, records, raw_features: Sequence[Feature]
                       ) -> ColumnStore:
        if self.drop_if_no_condition:
            from collections import defaultdict
            groups: Dict[str, List[Dict[str, Any]]] = defaultdict(list)
            for rec in records:
                groups[self.key_fn(rec)].append(rec)
            keep = {k for k, recs in groups.items()
                    if any(self.condition_fn(r) for r in recs)}
            filtered = [r for k, recs in groups.items() if k in keep
                        for r in recs]
            tmp = ConditionalReader(_InMemoryReader(filtered, self.key_fn),
                                    self.timestamp_fn,
                                    self.condition_fn,
                                    drop_if_no_condition=False,
                                    key_fn=self.key_fn)
            return tmp._rowwise_store(filtered, raw_features)
        return super()._rowwise_store(records, raw_features)


class ParquetReader(DataReader):
    """Parquet ingestion via the host Arrow/pandas stack
    (ParquetProductReader analog). NaN floats from nullable columns map to
    None."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Dict], str]] = None):
        super().__init__(key_fn)
        self.path = path

    def read_records(self) -> List[Dict[str, Any]]:
        import pandas as pd
        df = pd.read_parquet(self.path)
        records = df.to_dict(orient="records")
        for rec in records:
            for k, v in rec.items():
                if v is None or (isinstance(v, float) and v != v):
                    rec[k] = None
        return records


class AvroReader(DataReader):
    """Avro container-file ingestion (AvroReader; pure-Python decoder in
    readers/avro.py)."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Dict], str]] = None):
        super().__init__(key_fn)
        self.path = path

    def read_records(self) -> List[Dict[str, Any]]:
        from .avro import read_avro_records
        return read_avro_records(self.path)


@dataclass
class TimeBasedFilter:
    """Keep records whose event time falls inside [cutoff - duration,
    cutoff) (JoinedDataReader.scala TimeBasedFilter)."""

    timestamp_fn: Callable[[Dict], int]
    cutoff_ms: int
    duration_ms: Optional[int] = None

    def keep(self, record: Dict[str, Any]) -> bool:
        ts = self.timestamp_fn(record)
        if ts >= self.cutoff_ms:
            return False
        if self.duration_ms is not None and \
                ts < self.cutoff_ms - self.duration_ms:
            return False
        return True


class FilteredReader(DataReader):
    """Reader wrapper applying a TimeBasedFilter / predicate pre-read."""

    def __init__(self, base: DataReader, keep_fn: Callable[[Dict], bool]):
        super().__init__(base.key_fn)
        self.base = base
        self.keep_fn = keep_fn

    def read_records(self) -> List[Dict[str, Any]]:
        return [r for r in self.base.read_records() if self.keep_fn(r)]


class JoinedDataReader(DataReader):
    """Left-outer/inner join of two readers on their keys
    (JoinedDataReader.scala:54-418)."""

    def __init__(self, left: DataReader, right: DataReader,
                 join_type: str = "left_outer"):
        super().__init__(left.key_fn)
        self.left = left
        self.right = right
        self.join_type = join_type

    def read_records(self) -> List[Dict[str, Any]]:
        right_by_key: Dict[str, Dict[str, Any]] = {}
        for r in self.right.read_records():
            right_by_key.setdefault(self.right.key_fn(r), {}).update(r)
        out = []
        for l in self.left.read_records():
            k = self.left.key_fn(l)
            r = right_by_key.get(k)
            if r is None:
                if self.join_type == "inner":
                    continue
                out.append(dict(l))
            else:
                merged = dict(r)
                merged.update(l)
                out.append(merged)
        return out


class TemporalJoinReader(DataReader):
    """The bounded hash join — the memory-bounded, columnar-capable
    ``JoinedDataReader`` (``temporal.py``):

    * the build (right) side is partitioned by a consistent hash into
      bounded per-partition hash tables (``partitions`` ×
      ``table_max_rows`` unique keys; run defaults from
      ``customParams.joinPartitions`` / ``joinTableMaxRows``) — a new key
      arriving at a full partition drops its row (counted in
      ``temporal_stats()["join_spilled_rows"]``, with a warning) instead
      of growing the heap;
    * the probe (left) side streams through in order, so the output
      order and merge semantics (right fields, left overwrites on shared
      names; the last right record per key wins) are those of
      :class:`JoinedDataReader`;
    * when both sides yield columnar batches and the key column is
      statically known, the whole join vectorizes (one stable argsort
      and one searchsorted probe) and the result stays columnar
      (``temporal.Table``) — which is what lets a downstream
      ``AggregateReader`` keep the joined-then-aggregated composition
      columnar end to end.
    """

    def __init__(self, left: DataReader, right: DataReader,
                 join_type: str = "left_outer",
                 key_field: Optional[str] = None,
                 partitions: Optional[int] = None,
                 table_max_rows: Optional[int] = None):
        if join_type not in ("left_outer", "inner"):
            raise ValueError(
                f"join_type must be 'left_outer' or 'inner', got "
                f"{join_type!r}")
        from .. import temporal
        key_fn = temporal.field(key_field) if key_field else left.key_fn
        super().__init__(key_fn)
        self.left = left
        self.right = right
        self.join_type = join_type
        self.key_field = key_field
        self.partitions = partitions
        self.table_max_rows = table_max_rows

    def _left_key(self):
        from .. import temporal
        if self.key_field:
            return temporal.field(self.key_field)
        return self.left.key_fn

    def _right_key(self):
        from .. import temporal
        if self.key_field:
            return temporal.field(self.key_field)
        return self.right.key_fn

    def read_records(self):
        from .. import resilience, telemetry, temporal
        left = self.left.read_records()
        right = self.right.read_records()
        lkey = self.key_field or temporal.column_key_of(self._left_key())
        rkey = self.key_field or temporal.column_key_of(self._right_key())
        # decide the build shape before building anything: the vectorized
        # probe needs both sides columnar and both key columns statically
        # known — otherwise the partitioned bounded dict tables are the
        # only shape that will be probed
        columnar = (temporal._is_table(left) and temporal._is_table(right)
                    and lkey is not None and rkey is not None
                    and temporal.columnar_mode() is not False)

        def build():
            resilience.inject("temporal.join", join_type=self.join_type,
                              rows=len(right))
            if columnar:
                return temporal.build_join_table(
                    right, rkey, partitions=self.partitions,
                    table_max_rows=self.table_max_rows)
            return temporal._DictBuildTable(
                right, self._right_key(),
                temporal.join_partitions(self.partitions),
                temporal.join_table_max_rows(self.table_max_rows))

        # the build is pure compute over records already read, so a
        # transient failure retries it
        table = resilience.READER_RETRY.call("temporal.join", build)
        temporal._tally("joins")
        telemetry.counter("temporal.joins").inc()
        with telemetry.span("temporal:join", rows=len(left)):
            if isinstance(table, temporal._ColumnarBuildTable):
                return table.probe(left, lkey, self.join_type)
            return table.probe(left, self._left_key(), self.join_type)


class JoinedAggregateDataReader(AggregateReader):
    """Join first, then time-window aggregate the joined records —
    ``JoinedAggregateDataReader`` (JoinedDataReader.scala:119-418): the
    events are windowed against the cutoff after the join, as in the
    reference's dataprep examples
    (docs/examples/Conditional-Aggregation.md). The join rides
    :class:`TemporalJoinReader` (bounded partitioned build tables,
    vectorized when both sides are columnar), so the joined-then-
    aggregated composition is columnar end to end and bit-identical to
    the row-wise composition."""

    def __init__(self, left: DataReader, right: DataReader,
                 timestamp_fn: Callable[[Dict], int],
                 cutoff: CutOffTime = CutOffTime.no_cutoff(),
                 join_type: str = "left_outer",
                 time_filter: Optional[TimeBasedFilter] = None,
                 key_field: Optional[str] = None,
                 partitions: Optional[int] = None,
                 table_max_rows: Optional[int] = None):
        joined: DataReader = TemporalJoinReader(
            left, right, join_type, key_field=key_field,
            partitions=partitions, table_max_rows=table_max_rows)
        if time_filter is not None:
            joined = FilteredReader(joined, time_filter.keep)
        super().__init__(joined, timestamp_fn, cutoff,
                         joined.key_fn if key_field else left.key_fn)


def stream_score(model, batches: Iterable[Sequence[Mapping[str, Any]]],
                 keep_intermediate: bool = False, overlap: Any = "auto",
                 on_error: Optional[str] = None, device=None,
                 workers: Optional[int] = None,
                 prefetch: Optional[int] = None):
    """Incremental scoring over record batches (the StreamingScore run
    type, StreamingReaders.scala analog): yields one scored ColumnStore
    per batch, reusing the fitted DAG.

    ``overlap`` engages the input pipeline of the scoring engine
    (``scoring.stream_score_overlapped``: host preparation on ``workers``
    threads with an autotuned prefetch depth capped at ``prefetch``,
    while the device runs the batches in order). ``"auto"`` (the default)
    takes it when the model's engine serves and the first batch has
    ``scoring.SCORING_MIN_ROWS`` rows; ``True`` / ``False`` force or
    forbid it; ``TMOG_PIPELINE=0`` forbids it. Otherwise each batch is
    scored on its own (``model.score``). Both give the same stores.

    ``on_error`` governs poison batches (tf.data's graceful degradation):
    ``"quarantine"`` sends a batch whose scoring raises to the dead-letter
    sink (``resilience.quarantine``: the reason and the records
    themselves) and the stream goes on; ``"raise"`` propagates. The
    default (None) quarantines when a sink is installed
    (``resilience.set_quarantine``, the runner's ``quarantineLocation``)
    and raises without one: a dropped batch whose records land nowhere
    would be silent loss. The first batch always raises (a head-of-stream
    failure is a configuration error, not poison), and so does a device
    failure (``resilience.is_device_failure``)."""
    import itertools

    from .. import pipeline as _pipeline
    from .. import resilience, telemetry
    from ..models.base import resolve_device
    on_error = resilience.resolve_on_error(on_error)
    dev = resolve_device(device)
    it = iter(batches)
    first = next(it, None)
    if first is None:
        return
    chained = itertools.chain([first], it)
    use_overlap = False
    if overlap is not False and _pipeline.PIPELINE_ENABLED \
            and hasattr(model, "scoring_engine"):
        from ..scoring import SCORING_MIN_ROWS
        eng = model.scoring_engine(dev)
        use_overlap = eng.enabled() and (
            overlap is True or len(first) >= SCORING_MIN_ROWS)
    # which streaming mode served the batches
    if use_overlap:
        telemetry.counter("stream.overlapped_streams").inc()
    else:
        telemetry.counter("stream.plain_streams").inc()
    if use_overlap:
        from ..scoring import stream_score_overlapped
        yield from stream_score_overlapped(
            model, chained, keep_intermediate=keep_intermediate,
            engine=eng, device=dev, on_error=on_error, workers=workers,
            prefetch=prefetch)
        return
    for i, batch in enumerate(chained):
        try:
            resilience.inject("stream.score_batch", index=i,
                              rows=len(batch))
            with telemetry.span("stream:score_batch", rows=len(batch)):
                out = model.score(_pipeline.concrete_batch(batch),
                                  keep_intermediate=keep_intermediate,
                                  device=dev)
        except Exception as e:  # lint: broad-except — the poison-batch policy decides (device failures re-raise)
            # the records ride in the dead letter: a consumed stream
            # batch exists nowhere else
            resilience.quarantine_batch_or_raise(on_error, i, e, batch)
            continue
        yield out


class DataReaders:
    """Factory (DataReaders.scala:43)."""

    class simple:
        @staticmethod
        def csv(path: str, schema: Sequence[str], key_fn=None) -> CSVReader:
            return CSVReader(path, schema, key_fn)

        @staticmethod
        def csv_auto(path: str, key_fn=None) -> CSVAutoReader:
            return CSVAutoReader(path, key_fn)

        @staticmethod
        def records(records: Sequence[Mapping[str, Any]], key_fn=None
                    ) -> DataReader:
            return _InMemoryReader(records, key_fn)

        @staticmethod
        def parquet(path: str, key_fn=None) -> "ParquetReader":
            return ParquetReader(path, key_fn)

        @staticmethod
        def avro(path: str, key_fn=None) -> "AvroReader":
            return AvroReader(path, key_fn)

    class aggregate:
        @staticmethod
        def records(records, timestamp_fn, cutoff=CutOffTime.no_cutoff(),
                    key_fn=None) -> AggregateReader:
            return AggregateReader(_InMemoryReader(records, key_fn),
                                   timestamp_fn, cutoff, key_fn)

        @staticmethod
        def csv(path, schema, timestamp_fn, cutoff=CutOffTime.no_cutoff(),
                key_fn=None) -> AggregateReader:
            return AggregateReader(CSVReader(path, schema, key_fn),
                                   timestamp_fn, cutoff, key_fn)

    class conditional:
        @staticmethod
        def records(records, timestamp_fn, condition_fn, key_fn=None,
                    drop_if_no_condition: bool = True) -> ConditionalReader:
            return ConditionalReader(_InMemoryReader(records, key_fn),
                                     timestamp_fn, condition_fn,
                                     drop_if_no_condition, key_fn)
