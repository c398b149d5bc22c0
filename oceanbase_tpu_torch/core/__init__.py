from .dtypes import (
    BOOL,
    DATE,
    FLOAT32,
    FLOAT64,
    INT8,
    INT16,
    INT32,
    INT64,
    TIMESTAMP,
    VARCHAR,
    DataType,
    Field,
    Schema,
    TypeKind,
    common_numeric_type,
)
from .dictionary import Dictionary
from .column import ColumnBatch, batch_to_host, make_batch
from .table import Table, table_from_arrays

__all__ = [
    "BOOL",
    "DATE",
    "FLOAT32",
    "FLOAT64",
    "INT8",
    "INT16",
    "INT32",
    "INT64",
    "TIMESTAMP",
    "VARCHAR",
    "DataType",
    "Field",
    "Schema",
    "TypeKind",
    "common_numeric_type",
    "Dictionary",
    "ColumnBatch",
    "batch_to_host",
    "make_batch",
    "Table",
    "table_from_arrays",
]
