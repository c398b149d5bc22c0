"""Column batches: the device-resident unit of execution, as torch tensors.

Counterpart of `oceanbase_tpu/core/column.py`. A batch is a dict of SoA
tensors, one per column, on one explicit device, plus a live-row `sel`
mask and its count `nrows`. Capacities stay static and dead tail rows
are masked out, exactly as in the JAX package, so the executor's
static-capacity and overflow-retry contract carries over unchanged.

Uploads go at full storage width from pinned host memory. The JAX
package's frame-of-reference narrowed upload is a transport encoding for
a slow host link and changes no result, so it has no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .dictionary import Dictionary
from .dtypes import Field, Schema, TypeKind

_TORCH_OF = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy storage dtype (DataType.storage_np)."""
    return _TORCH_OF[np.dtype(np_dtype)]


@dataclass
class ColumnBatch:
    """A batch of rows as SoA tensors, with a live-row mask.

    cols:  name -> values tensor, shape [capacity], dtype = storage dtype
    valid: name -> bool tensor (True = non-null); absent for non-nullable
    sel:   bool [capacity] live-row mask
    nrows: 0-d int64 tensor, the count of live rows
    schema: static metadata (field names, logical types)
    dicts: host-side dictionaries for VARCHAR columns
    """

    cols: dict[str, torch.Tensor]
    valid: dict[str, torch.Tensor]
    sel: torch.Tensor
    nrows: torch.Tensor
    schema: Schema = field(default=Schema())
    dicts: dict[str, Dictionary] = field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def with_sel(self, sel: torch.Tensor) -> "ColumnBatch":
        return replace(self, sel=sel, nrows=torch.sum(sel, dtype=torch.int64))


def upload(a: np.ndarray, cap: int, dev: torch.device, fill=0) -> torch.Tensor:
    """One host column -> a [cap] device tensor at full storage width,
    padded with `fill`. CUDA targets copy from a pinned staging buffer."""
    a = np.asarray(a)
    n = len(a)
    pinned = dev.type == "cuda"
    host = torch.empty((cap,) + a.shape[1:], dtype=torch_dtype(a.dtype),
                       pin_memory=pinned)
    hv = host.numpy()
    hv[:n] = a
    if cap > n:
        hv[n:] = fill
    if pinned:
        return host.to(dev, non_blocking=True)
    return host if dev.type == "cpu" else host.to(dev)


def make_batch(
    data: dict[str, np.ndarray],
    schema: Schema,
    dicts: dict[str, Dictionary] | None = None,
    capacity: int | None = None,
    valid: dict[str, np.ndarray] | None = None,
    device=None,
) -> ColumnBatch:
    """Build a ColumnBatch from host arrays, padding to `capacity`.

    Capacity defaults to nrows rounded up to a multiple of 1024, as in
    the JAX package, so both packages give batches of one shape."""
    from .. import device as _device

    dev = _device(device)
    names = schema.names()
    n = len(next(iter(data.values()))) if data else 0
    for name in names:
        if len(data[name]) != n:
            raise ValueError(f"column {name} length mismatch")
    cap = capacity if capacity is not None else max(1024, -(-n // 1024) * 1024)
    if cap < n:
        raise ValueError(f"capacity {cap} < nrows {n}")

    cols: dict[str, torch.Tensor] = {}
    vmap_: dict[str, torch.Tensor] = {}
    for f in schema.fields:
        a = np.asarray(data[f.name], dtype=f.dtype.storage_np)
        cols[f.name] = upload(a, cap, dev)
        if f.dtype.nullable:
            v = (
                np.asarray(valid[f.name], dtype=np.bool_)
                if valid and f.name in valid
                else np.ones(n, dtype=np.bool_)
            )
            vmap_[f.name] = upload(v, cap, dev, fill=False)
    sel = np.ones(n, dtype=np.bool_)
    return ColumnBatch(
        cols=cols,
        valid=vmap_,
        sel=upload(sel, cap, dev, fill=False),
        nrows=torch.tensor(n, dtype=torch.int64, device=dev),
        schema=schema,
        dicts=dict(dicts or {}),
    )


def to_numpy(t) -> np.ndarray:
    """A tensor (any device) as a host numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def batch_rows_storage(batch, names) -> dict:
    """Live rows of a device batch in STORAGE domain (no decimal/date
    decoding — exact round-trips and int64 result checks)."""
    sel = to_numpy(batch.sel)
    return {n: np.ascontiguousarray(to_numpy(batch.cols[n])[sel])
            for n in names}


def batch_valid_storage(batch, names) -> dict:
    """Live-row validity masks (only for columns that have one): the NULL
    half of an exact materialization; without it NULLs would come back
    as their storage sentinel values."""
    sel = to_numpy(batch.sel)
    return {
        n: np.ascontiguousarray(to_numpy(batch.valid[n])[sel])
        for n in names if n in batch.valid
    }


def renamed_storage_schema(schema_src, names) -> Schema:
    """Schema of a materialized result: output names zipped positionally
    onto the planned output schema's field types."""
    return Schema(tuple(
        Field(n, schema_src[sn])
        for n, sn in zip(names, schema_src.names())
    ))


def batch_to_host(batch: ColumnBatch, decode_strings: bool = True) -> dict:
    """Pull live rows back to host (compacting out dead rows).

    NULL rows of nullable columns surface as None (lists) / NaN (floats) /
    masked ints via an object-dtype fallback."""
    sel = to_numpy(batch.sel)
    cols = {f.name: to_numpy(batch.cols[f.name]) for f in batch.schema.fields}
    valid = {n: to_numpy(v) for n, v in batch.valid.items()}
    return host_rows(
        batch.schema, batch.dicts, cols, valid, sel,
        decode_strings=decode_strings,
    )


def host_rows(schema, dicts, hcols, hvalid, hsel,
              decode_strings: bool = True) -> dict:
    """batch_to_host over already-fetched numpy arrays."""
    out: dict[str, np.ndarray | list] = {}
    for f in schema.fields:
        a = np.asarray(hcols[f.name])[hsel]
        v = hvalid.get(f.name)
        vm = np.asarray(v)[hsel] if v is not None else None
        if f.dtype.kind is TypeKind.VARCHAR and decode_strings and f.name in dicts:
            codes = a.copy()
            if vm is not None:
                codes[~vm] = -1  # Dictionary.decode maps negatives to None
            out[f.name] = dicts[f.name].decode(codes)
        elif f.dtype.is_decimal:
            d = a.astype(np.float64) / f.dtype.decimal_factor
            if vm is not None:
                d[~vm] = np.nan
            out[f.name] = d
        elif vm is not None and not vm.all():
            o = a.astype(object)
            o[~vm] = None
            out[f.name] = o
        else:
            out[f.name] = a
    return out
