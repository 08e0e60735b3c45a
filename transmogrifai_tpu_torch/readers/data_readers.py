"""Data readers — the port of ``transmogrifai_tpu/readers/data_readers.py``
for the simple readers (``DataReader.scala``, ``DataReaders.scala:43``).
Readers run on the host and produce record dicts; ``generate_store`` runs
each raw feature's extract function over them (generateDataFrame).

* :class:`CSVReader` — a CSV file with an explicit schema (column names in
  order, no header line); empty fields read as None.
* ``DataReaders.simple.csv`` / ``.records`` — the factories.
"""
from __future__ import annotations

import csv as _csv
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from ..columns import ColumnStore
from ..features import Feature
from ..stages.generator import FeatureGeneratorStage

__all__ = ["DataReader", "CSVReader", "DataReaders"]


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
        with open(self.path, newline="") as fh:
            return [{name: (v if v != "" else None)
                     for name, v in zip(self.schema, row)}
                    for row in _csv.reader(fh, delimiter=self.delimiter)]


class DataReaders:
    """Factory (DataReaders.scala:43)."""

    class simple:
        @staticmethod
        def csv(path: str, schema: Sequence[str], key_fn=None) -> CSVReader:
            return CSVReader(path, schema, key_fn)

        @staticmethod
        def records(records: Sequence[Mapping[str, Any]], key_fn=None
                    ) -> DataReader:
            return _InMemoryReader(records, key_fn)
