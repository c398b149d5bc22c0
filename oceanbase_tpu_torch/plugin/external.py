"""External-table loaders: Arrow/Parquet/CSV into catalog Tables.

Reference: src/plugin/.../ob_external_arrow_data_loader.h (the external
Arrow loader behind OceanBase's external tables) and the external-table
scan layer under src/sql/engine — there the loader feeds scan batches;
here it feeds a columnar Table whose arrays upload once to HBM, after
which external data is indistinguishable from native tables (all the
engine's fast paths — affine joins, sorted projections over it, stats —
apply).

Type mapping (Arrow -> engine storage):
  int8/16/32/64, uint*  -> matching signed ints (uint64 -> int64)
  float32/float64       -> float32/float64
  date32                -> DATE (int32 days)
  decimal128(p, s)      -> DECIMAL(p, s) scaled int
  string/large_string   -> dict-encoded VARCHAR
  bool                  -> BOOL
Nullable arrow columns carry their validity into the Table's masks.
"""

from __future__ import annotations

import numpy as np

from ..core.dictionary import Dictionary
from ..core.dtypes import DataType, Field, Schema, TypeKind
from ..core.table import Table


class ExternalFormatError(Exception):
    pass


_LOADERS = {}


def register_loader(fmt: str, fn) -> None:
    """fn(path) -> pyarrow.Table-like or (data, dicts, schema) triple."""
    _LOADERS[fmt.lower()] = fn


def registered_formats() -> tuple[str, ...]:
    return tuple(sorted(_LOADERS))


# ---------------------------------------------------------------- arrow

def _arrow_to_table(name: str, at) -> Table:
    import pyarrow as pa

    data: dict[str, np.ndarray] = {}
    dicts: dict[str, Dictionary] = {}
    valid: dict[str, np.ndarray] = {}
    fields = []
    for col in at.schema.names:
        arr = at.column(col).combine_chunks()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        t = arr.type
        nullable = arr.null_count > 0
        if pa.types.is_boolean(t):
            dt = DataType.bool_(nullable)
            np_arr = arr.to_numpy(zero_copy_only=False)
            data[col] = np.asarray(np_arr, dtype=np.bool_)
        elif pa.types.is_integer(t):
            dt = (
                DataType.int64(nullable)
                if t.bit_width > 32 or pa.types.is_unsigned_integer(t)
                else DataType(TypeKind.INT32, nullable=nullable)
                if t.bit_width > 16
                else DataType(TypeKind.INT16, nullable=nullable)
                if t.bit_width > 8
                else DataType(TypeKind.INT8, nullable=nullable)
            )
            raw = arr.fill_null(0).to_numpy(zero_copy_only=False)
            if raw.dtype == np.uint64 and len(raw) and (
                raw.max() > np.iinfo(np.int64).max
            ):
                # silent wraparound to negatives would corrupt results
                raise ExternalFormatError(
                    f"uint64 column {col} holds values beyond int64 "
                    "(the engine has no unsigned 64-bit storage)"
                )
            data[col] = np.asarray(raw, dtype=dt.storage_np)
        elif pa.types.is_floating(t):
            dt = (
                DataType.float32(nullable) if t.bit_width == 32
                else DataType.float64(nullable)
            )
            data[col] = np.asarray(
                arr.fill_null(0.0).to_numpy(zero_copy_only=False),
                dtype=dt.storage_np,
            )
        elif pa.types.is_date32(t):
            dt = DataType(TypeKind.DATE, nullable=nullable)
            data[col] = np.asarray(
                arr.fill_null(0).cast(pa.int32()).to_numpy(
                    zero_copy_only=False),
                dtype=np.int32,
            )
        elif pa.types.is_decimal(t):
            dt = DataType.decimal(t.precision, t.scale, nullable)
            # decimal.Decimal scaleb keeps exactness: value * 10^scale
            data[col] = np.asarray(
                [int(v.scaleb(t.scale)) if v is not None else 0
                 for v in arr.fill_null(0).to_pylist()],
                dtype=dt.storage_np,
            )
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            dt = DataType.varchar(nullable)
            py = arr.fill_null("").to_pylist()
            d = Dictionary(sorted(set(py)), sorted_=True)
            data[col] = d.encode(py, add=False)
            dicts[col] = d
        else:
            raise ExternalFormatError(
                f"unsupported arrow type {t} for column {col}"
            )
        if nullable:
            valid[col] = np.asarray(
                arr.is_valid().to_numpy(zero_copy_only=False),
                dtype=np.bool_,
            )
        fields.append(Field(col, dt))
    return Table(name, Schema(tuple(fields)), data, dicts, valid)


def _load_parquet(path: str):
    import pyarrow.parquet as pq

    return pq.read_table(path)


def _load_arrow(path: str):
    import pyarrow as pa

    with pa.memory_map(path) as src:
        return pa.ipc.open_file(src).read_all()


def _load_csv(path: str):
    import pyarrow.csv as pacsv

    return pacsv.read_csv(path)


register_loader("parquet", _load_parquet)
register_loader("arrow", _load_arrow)
register_loader("csv", _load_csv)


def load_external(name: str, fmt: str, path: str) -> Table:
    """Materialize an external file as a catalog Table."""
    fn = _LOADERS.get(fmt.lower())
    if fn is None:
        raise ExternalFormatError(
            f"no loader for format {fmt!r} (have {registered_formats()})"
        )
    out = fn(path)
    if isinstance(out, Table):
        return out
    if isinstance(out, tuple):
        data, dicts, schema = out
        return Table(name, schema, data, dicts or {})
    return _arrow_to_table(name, out)
