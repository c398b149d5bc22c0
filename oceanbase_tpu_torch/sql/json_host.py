"""JSON_OBJECT / JSON_ARRAY constructors: host-side output formatting.

Counterpart of `oceanbase_tpu/sql/json_host.py` (reference surface:
ob_expr_json_object.cpp / ob_expr_json_array.cpp). The device never sees
strings, only dictionary codes, so per-row JSON text cannot be built
there: constructors in the select list split before planning into hidden
argument columns that the device computes, and the host builds the JSON
text as the result is assembled (where dictionary codes decode to
strings anyway). Constructors elsewhere are rejected at resolve time.

`split_host_json` returns the rewritten AST plus a spec, which joins the
plan-cache key; `apply_host_json` turns the executed columns into the
final result columns.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from . import ast as A

_CTORS = ("json_object", "json_array")


@dataclass(frozen=True)
class HostJsonSpec:
    """One constructor output column: its name, select-list position, and
    formatting tree. Tree nodes: ("lit", v) | ("col", hidden_name) |
    ("obj", ((key, node), ...)) | ("arr", (node, ...))."""

    name: str
    position: int
    tree: tuple


def _is_ctor(e) -> bool:
    return isinstance(e, A.FuncCall) and e.name in _CTORS


def _lit_value(e):
    if isinstance(e, A.StringLit):
        return e.value
    if isinstance(e, A.NumberLit):
        try:
            return int(e.value)
        except ValueError:
            return float(e.value)
    if isinstance(e, A.Name) and e.parts == ("null",):
        return None
    return _NOT_LIT


_NOT_LIT = object()


def _build_tree(e, hidden: list) -> tuple:
    if _is_ctor(e):
        if e.name == "json_object":
            if len(e.args) % 2:
                raise ValueError("json_object needs key/value pairs")
            pairs = []
            for k, v in zip(e.args[::2], e.args[1::2]):
                if not isinstance(k, A.StringLit):
                    raise ValueError("json_object keys must be string literals")
                pairs.append((k.value, _build_tree(v, hidden)))
            return ("obj", tuple(pairs))
        return ("arr", tuple(_build_tree(a, hidden) for a in e.args))
    lv = _lit_value(e)
    if lv is not _NOT_LIT:
        return ("lit", lv)
    name = f"$jh{len(hidden)}"
    hidden.append(A.SelectItem(e, name))
    return ("col", name)


def split_host_json(sel):
    """(ast', specs, hidden_names): replace top-level constructor select
    items with position-preserving placeholders + hidden argument columns
    appended at the end. Returns (sel, (), ()) when nothing applies."""
    if not isinstance(sel, A.Select):
        return sel, (), ()
    if not any(_is_ctor(it.expr) for it in sel.items):
        return sel, (), ()
    if sel.distinct:
        raise ValueError("DISTINCT over JSON constructors is not supported")
    specs: list[HostJsonSpec] = []
    hidden: list[A.SelectItem] = []
    items = []
    ctor_names = set()
    for pos, it in enumerate(sel.items):
        if _is_ctor(it.expr):
            name = it.alias or it.expr.name
            specs.append(HostJsonSpec(name, pos, _build_tree(it.expr, hidden)))
            ctor_names.add(name)
            # placeholder keeps select-list POSITIONS stable (ordinal
            # ORDER BY / GROUP BY references to other items still hold)
            items.append(A.SelectItem(A.NumberLit("0"), name))
        else:
            items.append(it)
    ctor_positions = {s.position for s in specs}
    for clause, refs in (("ORDER BY", [o.expr for o in sel.order_by]),
                         ("GROUP BY", list(sel.group_by))):
        for e in refs:
            if isinstance(e, A.Name) and len(e.parts) == 1 and \
                    e.parts[0] in ctor_names:
                raise ValueError(
                    f"{clause} a JSON constructor is not supported")
            if isinstance(e, A.NumberLit) and \
                    int(e.value) - 1 in ctor_positions:
                raise ValueError(
                    f"{clause} a JSON constructor is not supported")
    from dataclasses import replace

    sel2 = replace(sel, items=tuple(items) + tuple(hidden))
    return sel2, tuple(specs), tuple(it.alias for it in hidden)


def _cell(col, i):
    v = col[i]
    if v is None:
        return None
    if isinstance(v, (np.floating, float)):
        f = float(v)
        if f != f:  # NaN carries SQL NULL through float channels
            return None
        return int(f) if f.is_integer() else f
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    if isinstance(v, np.datetime64):
        return str(v)
    return str(v)


def _format(tree, cols, i):
    kind = tree[0]
    if kind == "lit":
        return tree[1]
    if kind == "col":
        return _cell(cols[tree[1]], i)
    if kind == "obj":
        return {k: _format(t, cols, i) for k, t in tree[1]}
    return [_format(t, cols, i) for t in tree[1]]


def apply_host_json(specs, hidden_names, names, cols):
    """Post-execution: build constructor columns from the hidden argument
    columns, drop the hidden columns, restore the select-list order."""
    if not specs:
        return names, cols
    n = len(next(iter(cols.values()))) if cols else 0
    out_cols = {k: v for k, v in cols.items() if k not in set(hidden_names)}
    for spec in specs:
        out_cols[spec.name] = [
            json.dumps(_format(spec.tree, cols, i),
                       separators=(", ", ": "), ensure_ascii=False)
            for i in range(n)
        ]
    out_names = tuple(nm for nm in names if nm not in set(hidden_names))
    return out_names, out_cols
