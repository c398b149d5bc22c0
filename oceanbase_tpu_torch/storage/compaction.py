"""Freeze and compaction: LSM maintenance.

Reference surface: storage/compaction — ObTenantTabletScheduler triggers
mini (memtable dump), minor (delta merge) and major (full flatten) merges
as DAG tasks (ob_tablet_merge_task.h:197). The rebuild implements the three
merge kinds as pure functions over sstable blobs; tablet.py owns the
scheduling policy and the dag_scheduler runs them on worker threads.

Version semantics:
  * mini: flatten a frozen memtable's committed chains (all versions kept);
  * minor: merge several delta sstables into one, keeping all versions
    (bounded by recycle_version: versions <= it are collapsed per key);
  * major: flatten everything at a snapshot into exactly one committed
    version per key, dropping tombstones.
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import Schema
from .memtable import Memtable
from .sstable import OP_COL, OP_PUT, VERSION_COL, SSTable, write_sstable


def freeze_to_mini(mt: Memtable, block_rows: int = 16384,
                   enc_hints: dict | None = None) -> bytes:
    """Dump a frozen memtable into a mini sstable blob."""
    if not mt.frozen:
        raise RuntimeError("memtable must be frozen before dump")
    data, versions, ops = mt.dump()
    lo, hi = mt.version_range
    return write_sstable(
        mt.schema, mt.key_cols, data, versions, ops,
        base_version=lo, end_version=hi, block_rows=block_rows,
        enc_hints=enc_hints,
    )


def _merge_rows(
    schema: Schema, key_cols: list[str], sstables: list[SSTable]
) -> tuple[dict[str, np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate all rows of all sstables, sorted (key asc, version desc,
    recency desc). Returns (data, versions, ops, first_per_key mask)."""
    names = schema.names()
    parts = [st.scan(names) for st in sstables]
    ranks = np.concatenate(
        [np.full(len(p[VERSION_COL]), i, np.int32) for i, p in enumerate(parts)]
    )
    cat = {c: np.concatenate([p[c] for p in parts]) for c in names + [VERSION_COL, OP_COL]}
    keys2d = np.stack([cat[k].astype(np.int64) for k in key_cols], axis=1)
    n = len(ranks)
    order = np.lexsort(
        (-ranks, -cat[VERSION_COL])
        + tuple(keys2d[:, j] for j in range(keys2d.shape[1] - 1, -1, -1))
    )
    data = {c: cat[c][order] for c in names}
    versions = cat[VERSION_COL][order]
    ops = cat[OP_COL][order]
    sk = keys2d[order]
    first = np.ones(n, dtype=bool)
    if n > 1:
        first[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    return data, versions, ops, first


def _first_match_per_key(first: np.ndarray, match: np.ndarray) -> np.ndarray:
    """Rows sorted (key asc, version desc): mark, per key segment, the FIRST
    row where `match` holds (i.e. the newest matching version)."""
    n = len(first)
    out = np.zeros(n, dtype=bool)
    if n == 0 or not match.any():
        return out
    seg = np.cumsum(first) - 1
    nseg = int(seg[-1]) + 1
    first_idx = np.full(nseg, n, dtype=np.int64)
    midx = np.flatnonzero(match)
    np.minimum.at(first_idx, seg[midx], midx)
    out[first_idx[first_idx < n]] = True
    return out


def minor_compact(
    schema: Schema,
    key_cols: list[str],
    sstables: list[SSTable],
    recycle_version: int = 0,
    block_rows: int = 16384,
    enc_hints: dict | None = None,
) -> bytes:
    """Merge delta sstables (oldest -> newest) into one multi-version delta.

    Versions <= recycle_version are collapsed to at most one (the newest
    visible at recycle_version) per key — no reader holds an older snapshot.
    """
    data, versions, ops, first = _merge_rows(schema, key_cols, sstables)
    n = len(versions)
    if recycle_version > 0 and n:
        old = versions <= recycle_version
        keep = (~old) | _first_match_per_key(first, old)
        data = {c: a[keep] for c, a in data.items()}
        versions, ops = versions[keep], ops[keep]
    lo = min((s.base_version for s in sstables), default=0)
    hi = max((s.end_version for s in sstables), default=0)
    return write_sstable(
        schema, key_cols, data, versions, ops,
        base_version=lo, end_version=hi, block_rows=block_rows,
        enc_hints=enc_hints,
    )


def major_compact(
    schema: Schema,
    key_cols: list[str],
    sstables: list[SSTable],
    snapshot: int,
    block_rows: int = 16384,
    enc_hints: dict | None = None,
) -> bytes:
    """Flatten all sources at `snapshot`: newest committed version per key,
    tombstones dropped. Produces the new base (one version per key)."""
    data, versions, ops, first = _merge_rows(schema, key_cols, sstables)
    # rows are (key asc, version desc): the winner per key is its newest
    # version visible at the snapshot; tombstone winners drop the key.
    winner = _first_match_per_key(first, versions <= snapshot)
    keep = winner & (ops == OP_PUT)
    data = {c: a[keep] for c, a in data.items()}
    return write_sstable(
        schema, key_cols, data, versions[keep], ops[keep],
        base_version=0, end_version=snapshot, block_rows=block_rows,
        enc_hints=enc_hints,
    )
