"""Data readers: host-side ingestion into record dicts and raw feature
stores."""
from .data_readers import CSVReader, DataReader, DataReaders  # noqa: F401

__all__ = ["DataReader", "CSVReader", "DataReaders"]
