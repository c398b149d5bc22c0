"""Sorted projections: a covering secondary index materialized columnar.

Counterpart of `oceanbase_tpu/storage/sorted_projection.py`. A projection
is the base table re-ordered by one key column (a stable argsort), kept
in the catalog as a second table with the columns it covers, so that a
range predicate on the key becomes a contiguous slice of rows
(`Executor._projection_choice` routes the Scan, kernel K17 slices it).
DML on the base table drops its projections (`drop_projections`); they
are rebuilt on demand.
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import Schema
from ..core.table import Table


def projection_name(table: str, key_col: str) -> str:
    return f"{table}#sp:{key_col}"


def make_sorted_projection(
    catalog, table: str, key_col: str, cols: list[str] | None = None
) -> str:
    """Materialize `table` re-ordered by `key_col` (stable) into the
    catalog under projection_name(); registers it on the base Table's
    `sorted_projections` map, which the executor's scan router consults.
    `cols` limits the covered columns (default: all)."""
    t = catalog[table]
    names = [f.name for f in t.schema.fields]
    keep = list(cols) if cols is not None else list(names)
    if key_col not in keep:
        keep.append(key_col)
    keep = [n for n in names if n in keep]  # schema order
    order = np.argsort(t.data[key_col], kind="stable")
    data = {c: np.ascontiguousarray(t.data[c][order]) for c in keep}
    valid = {c: np.ascontiguousarray(t.valid[c][order])
             for c in t.valid if c in keep}
    sub_schema = Schema(tuple(f for f in t.schema.fields if f.name in keep))
    pname = projection_name(table, key_col)
    catalog[pname] = Table(
        pname, sub_schema, data,
        {c: d for c, d in t.dicts.items() if c in keep}, valid,
    )
    t.sorted_projections = {
        **getattr(t, "sorted_projections", {}), key_col: pname
    }
    return pname


def drop_projections(catalog, table: str) -> None:
    """Remove every sorted projection of `table` (base data changed)."""
    t = catalog[table]
    projs = getattr(t, "sorted_projections", None)
    if not projs:
        return
    for pname in projs.values():
        try:
            del catalog[pname]
        except (KeyError, TypeError):
            pass
    t.sorted_projections = {}
