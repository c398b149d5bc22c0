from . import datagen, queries, schema

__all__ = ["datagen", "queries", "schema"]
