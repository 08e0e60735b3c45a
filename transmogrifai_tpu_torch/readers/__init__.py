"""Data readers: host-side ingestion into record dicts and raw feature
stores, the event-time aggregating and joining readers, the Avro codec
and the directory-watching stream reader (``DirectoryStreamReader``,
``readers/streaming.py``)."""
from .avro import (ColumnarRecords, read_avro_records,  # noqa: F401
                   read_avro_table)
from .data_readers import (AggregateReader, AvroReader,  # noqa: F401
                           ConditionalReader, CSVAutoReader, CSVReader,
                           CutOffTime, DataReader, DataReaders,
                           FilteredReader, JoinedAggregateDataReader,
                           JoinedDataReader, ParquetReader,
                           TemporalJoinReader, TimeBasedFilter,
                           stream_score)
from .streaming import DirectoryStreamReader  # noqa: F401

__all__ = ["DataReader", "CSVReader", "CSVAutoReader", "ParquetReader",
           "AvroReader", "AggregateReader", "ConditionalReader",
           "DataReaders", "JoinedDataReader", "JoinedAggregateDataReader",
           "TemporalJoinReader", "TimeBasedFilter", "FilteredReader",
           "CutOffTime", "stream_score", "ColumnarRecords",
           "read_avro_records", "read_avro_table", "DirectoryStreamReader"]
