"""Multi-source snapshot scan merge.

Reference surface: storage/access ObMultipleScanMerge / ObMultipleGetMerge
(ob_multiple_scan_merge.h) — fuse memtable + minor + major sstables under
MVCC into one row stream, resolving each rowkey to its newest committed
version <= the read snapshot and dropping delete tombstones.

The rebuild does the fuse as vectorized numpy (host control path): gather
candidate rows from every source, lexsort by (rowkey asc, version desc,
source recency desc), keep the first row per key, drop tombstones. Output
columns are sorted by rowkey — the order sstables want and a free property
for downstream merge algorithms.
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import Schema, TypeKind
from .memtable import Memtable
from .sstable import OP_COL, OP_PUT, VERSION_COL, SSTable


def _memtable_arrays(
    mt: Memtable, schema: Schema, snapshot: int, tx_id: int
) -> dict[str, np.ndarray]:
    rows = mt.snapshot_rows(snapshot, tx_id)
    names = schema.names()

    def _empty(n):
        f = schema[n]
        if f.kind is TypeKind.VECTOR:
            return np.zeros((0, int(f.precision)), dtype=f.storage_np)
        return np.zeros(0, dtype=f.storage_np)

    if not rows:
        out = {n: _empty(n) for n in names}
        out[VERSION_COL] = np.zeros(0, np.int64)
        out[OP_COL] = np.zeros(0, np.int8)
        return out
    vals = list(rows.values())
    ops = np.array([op for op, _ in vals], dtype=np.int8)
    out = {}
    for ci, n in enumerate(names):
        dt = schema[n].storage_np
        key_pos = mt.key_cols.index(n) if n in mt.key_cols else -1
        if key_pos >= 0:
            out[n] = np.array([k[key_pos] for k in rows.keys()], dtype=dt)
        else:
            # a tombstone's filler must keep the cell's SHAPE: vector
            # cells are (d,) tuples, and a scalar 0 among them makes the
            # row list inhomogeneous
            fill = ((0.0,) * int(schema[n].precision)
                    if schema[n].kind is TypeKind.VECTOR else 0)
            out[n] = np.array(
                [v[ci] if op == OP_PUT else fill for op, v in vals],
                dtype=dt,
            )
    # staged rows of the reading tx are visible "infinitely new"
    out[VERSION_COL] = np.full(len(vals), np.iinfo(np.int64).max, np.int64)
    out[OP_COL] = ops
    return out


def scan_merge(
    schema: Schema,
    key_cols: list[str],
    sstables: list[SSTable],
    memtables: list[Memtable],
    snapshot: int,
    columns: list[str] | None = None,
    ranges: dict[str, tuple[float, float]] | None = None,
    tx_id: int = 0,
) -> dict[str, np.ndarray]:
    """Fused snapshot read.

    sstables/memtables ordered oldest -> newest. Zone-map pruning: ranges on
    KEY columns are always safe (a key either qualifies in every source or in
    none, so pruning cannot resurrect a stale version); ranges on value
    columns are applied only when exactly one non-empty source exists — with
    deltas present, pruning a base block on a value predicate could hide the
    base version of a key whose delta row fails the predicate.
    """
    names = columns if columns is not None else schema.names()
    need = list(dict.fromkeys(list(key_cols) + list(names)))
    live_memtables = [m for m in memtables if m.nkeys > 0]
    single_source = (len(sstables) + len(live_memtables)) == 1
    key_ranges = (
        {c: r for c, r in ranges.items() if c in key_cols} if ranges else None
    )
    parts: list[dict[str, np.ndarray]] = []
    ranks: list[np.ndarray] = []
    rank = 0
    for st in sstables:
        got = st.scan(need, ranges=ranges if single_source else key_ranges)
        mask = got[VERSION_COL] <= snapshot
        if not mask.all():
            got = {c: a[mask] for c, a in got.items()}
        parts.append(got)
        ranks.append(np.full(len(got[VERSION_COL]), rank, np.int32))
        rank += 1
    for mt in memtables:
        got = _memtable_arrays(mt, schema, snapshot, tx_id)
        if need != schema.names():
            got = {c: got[c] for c in need + [VERSION_COL, OP_COL]}
        parts.append(got)
        ranks.append(np.full(len(got[VERSION_COL]), rank, np.int32))
        rank += 1

    if not parts:
        return {n: np.zeros(0, dtype=schema[n].storage_np) for n in names}

    cat = {c: np.concatenate([p[c] for p in parts]) for c in need + [VERSION_COL, OP_COL]}
    rank_arr = np.concatenate(ranks) if ranks else np.zeros(0, np.int32)
    n = len(rank_arr)
    if n == 0:
        return {c: cat[c] for c in names}

    keys2d = np.stack([cat[k].astype(np.int64) for k in key_cols], axis=1)
    # lexsort: last key is primary -> (key0, key1, ..., -version, -rank)
    sort_keys = (-rank_arr, -cat[VERSION_COL]) + tuple(
        keys2d[:, j] for j in range(keys2d.shape[1] - 1, -1, -1)
    )
    order = np.lexsort(sort_keys)
    sorted_keys = keys2d[order]
    first = np.ones(n, dtype=bool)
    if n > 1:
        first[1:] = (sorted_keys[1:] != sorted_keys[:-1]).any(axis=1)
    keep = order[first & (cat[OP_COL][order] == OP_PUT)]
    return {c: cat[c][keep] for c in names}
