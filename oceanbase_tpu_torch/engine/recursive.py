"""WITH RECURSIVE: a host-driven fixpoint over ordinary plans.

Counterpart of `oceanbase_tpu/engine/recursive.py` (reference surface:
src/sql/engine/recursive_cte, ObRecursiveUnionAllOp's fake-CTE-table
pump: run the base branch, feed each produced batch back through the
recursive branch until it is empty).

The data-dependent loop stays on the host, and every iteration is a
whole plan through the session's executor: the working table lives in
the catalog as a temporary table between rounds, so the step statement
plans like any other. UNION dedups each delta against every row seen
(breadth-first, as the reference); UNION ALL stops on an empty delta. A
bounded iteration count guards non-terminating recursion, as the
reference's cte_max_recursion_depth does.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..core.column import batch_rows_storage as _batch_rows_storage
from ..core.column import renamed_storage_schema
from ..core.table import Table
from ..sql import ast as A

MAX_ITERS = 200

_tmp_ids = itertools.count()


def recursive_cte_of(ast) -> str | None:
    """The single self-referencing CTE name, or None. Requires the
    RECURSIVE keyword: per standard scoping, a plain WITH whose body
    mentions its own name refers to the CATALOG table of that name, not
    itself. Multiple recursive CTEs raise (one per statement, like the
    reference)."""
    ctes = getattr(ast, "ctes", ())
    declared = set(getattr(ast, "recursive_ctes", ()) or ())
    if not ctes or not declared:
        return None
    rec = [
        name for name, body in ctes
        if name in declared and name in _table_refs(body)
    ]
    if len(rec) > 1:
        raise ValueError("only one recursive CTE per statement is supported")
    return rec[0] if rec else None


def _table_refs(node, out=None) -> set:
    if out is None:
        out = set()
    if isinstance(node, A.TableRef):
        out.add(node.name)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _table_refs(getattr(node, f.name), out)
    elif isinstance(node, (tuple, list)):
        for x in node:
            _table_refs(x, out)
    return out


def _rename_table(node, old: str, new: str):
    """Rewrite TableRef(old) -> TableRef(new, alias=old-or-explicit)."""
    if isinstance(node, A.TableRef) and node.name == old:
        return A.TableRef(new, node.alias or old)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _rename_table(v, old, new)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node
    if isinstance(node, tuple):
        items = tuple(_rename_table(x, old, new) for x in node)
        return items if any(a is not b for a, b in zip(items, node)) else node
    return node


def run_recursive(session, ast):
    """Execute a statement whose WITH contains one recursive CTE.

    Returns (out_batch, output_names); the caller (Session.run_ast)
    converts them to a ResultSet."""
    from ..sql.logical import output_schema

    name = recursive_cte_of(ast)
    assert name is not None
    body = dict(ast.ctes)[name]
    if not (isinstance(body, A.SetSelect) and body.kind == "union"):
        raise ValueError(
            "recursive CTE body must be <base> UNION [ALL] <step>"
        )
    base_ast, step_ast = body.left, body.right
    if name in _table_refs(base_ast):
        raise ValueError("recursive CTE base branch must not self-reference")
    dedup = not body.all
    other_ctes = tuple((n, b) for n, b in ast.ctes if n != name)
    tmp = f"#rcte{next(_tmp_ids)}:{name}"

    def with_ctes(sel):
        return dataclasses.replace(
            sel, ctes=other_ctes, recursive_ctes=()
        ) if isinstance(sel, (A.Select, A.SetSelect)) else sel

    # ---- base branch -------------------------------------------------
    planned = session.planner.plan(with_ctes(base_ast))
    schema_src = output_schema(planned.plan)
    out_batch = session.executor.execute(planned.plan)
    names = list(planned.output_names)
    acc = _batch_rows_storage(out_batch, names)
    dicts = {n: out_batch.dicts[n] for n in names if n in out_batch.dicts}
    tmp_schema = renamed_storage_schema(schema_src, names)

    seen = None
    if dedup:
        seen = set(map(tuple, zip(*(acc[n] for n in names)))) \
            if names else set()
        # base dedups against itself too (UNION semantics)
        if acc and len(next(iter(acc.values()))) != len(seen):
            keep, s2 = [], set()
            for i, row in enumerate(zip(*(acc[n] for n in names))):
                if row not in s2:
                    s2.add(row)
                    keep.append(i)
            acc = {n: acc[n][keep] for n in names}

    frontier = acc

    def install(rows):
        session.catalog[tmp] = Table(tmp, tmp_schema, dict(rows), dict(dicts))
        session.executor.invalidate_table(tmp)
        session.stats.invalidate(tmp)

    step_renamed = _rename_table(with_ctes(step_ast), name, tmp)
    try:
        for it in range(MAX_ITERS):
            if len(next(iter(frontier.values()), ())) == 0:
                break
            install(frontier)
            sp = session.planner.plan(step_renamed)
            delta_b = session.executor.execute(sp.plan)
            delta = _batch_rows_storage(delta_b, list(sp.output_names))
            # align step output column names to the cte's
            delta = {n: delta[sn] for n, sn in zip(names, sp.output_names)}
            for n in names:
                if n in delta_b.dicts and n not in dicts:
                    dicts[n] = delta_b.dicts[n]
            if dedup:
                keep = []
                for i, row in enumerate(zip(*(delta[n] for n in names))):
                    if row not in seen:
                        seen.add(row)
                        keep.append(i)
                delta = {n: delta[n][keep] for n in names}
            if len(next(iter(delta.values()), ())) == 0:
                break
            acc = {n: np.concatenate([acc[n], delta[n]]) for n in names}
            frontier = delta
        else:
            raise RuntimeError(
                f"recursive CTE {name!r} exceeded {MAX_ITERS} iterations"
            )
        # ---- outer query over the materialized cte -------------------
        install(acc)
        outer = _rename_table(with_ctes(ast), name, tmp)
        planned = session.planner.plan(outer)
        out = session.executor.execute(planned.plan)
        return out, planned.output_names
    finally:
        session.catalog.pop(tmp, None)
        session.executor.invalidate_table(tmp)
        session.stats.invalidate(tmp)
