from . import datagen, schema
from .sql_suite import QUERIES, UNIQUE_KEYS

__all__ = ["datagen", "schema", "QUERIES", "UNIQUE_KEYS"]
