"""Resolver: AST -> logical plan over typed expression IR.

Reference surface: the resolver layer producing ObDMLStmt/ObSelectStmt with
ObRawExpr trees (src/sql/resolver, ob_raw_expr.h). Scoping model: every
table reference gets an alias; resolved columns are named "<alias>.<col>"
internally, unqualified names resolve by unique suffix match across visible
scopes. Aggregates are extracted from SELECT/HAVING/ORDER BY into an
Aggregate node (avg decomposes into sum/count at planning).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from ..core.dtypes import DataType, Field, Schema
from ..expr import ir as E
from . import ast as A

_counter = itertools.count()


# ---- logical operators ----------------------------------------------------


class LogicalOp:
    __slots__ = ()


@dataclass
class Scan(LogicalOp):
    table: str
    alias: str
    schema: Schema  # qualified names alias.col
    pushed_filter: E.Expr | None = None
    needed: tuple[str, ...] | None = None  # projection pruning


@dataclass
class Filter(LogicalOp):
    child: LogicalOp
    pred: E.Expr


@dataclass
class Project(LogicalOp):
    child: LogicalOp
    exprs: tuple[tuple[str, E.Expr], ...]  # (output name, expr)


@dataclass
class JoinOp(LogicalOp):
    kind: str  # inner | left | semi | anti | cross
    left: LogicalOp
    right: LogicalOp
    left_keys: tuple[E.Expr, ...] = ()
    right_keys: tuple[E.Expr, ...] = ()
    residual: E.Expr | None = None


@dataclass
class Aggregate(LogicalOp):
    child: LogicalOp
    group_keys: tuple[tuple[str, E.Expr], ...]  # (name, expr)
    aggs: tuple[tuple[str, str, E.Expr | None, bool], ...]
    # (output name, op in sum/count/min/max, input expr, distinct)
    # ROLLUP/CUBE/GROUPING SETS: index tuples into group_keys; the
    # executor aggregates once per set and NULL-fills absent keys
    # (the reference's EXPAND operator, ob_phy_operator_type.h)
    grouping_sets: tuple[tuple[int, ...], ...] | None = None


@dataclass
class Sort(LogicalOp):
    child: LogicalOp
    keys: tuple[tuple[E.Expr, bool], ...]  # (expr, descending)


@dataclass
class Limit(LogicalOp):
    child: LogicalOp
    n: int
    offset: int = 0


@dataclass
class Distinct(LogicalOp):
    child: LogicalOp


@dataclass
class TopN(LogicalOp):
    """Fused ORDER BY + LIMIT (the reference's top-n sort with pushdown,
    sql/engine/sort/ob_pd_topn_sort_filter.h). On TPU this collapses the
    full-capacity payload permutation of a Sort into a k-row gather."""

    child: LogicalOp
    keys: tuple[tuple["E.Expr", bool], ...]  # (expr, descending)
    n: int
    offset: int = 0


@dataclass
class SetOp(LogicalOp):
    """UNION / INTERSECT / EXCEPT. Columns align by position; output field
    names come from the left side. Reference: src/sql/engine/set (hash
    union/intersect/except operators)."""

    kind: str  # union | intersect | except
    all: bool
    left: LogicalOp
    right: LogicalOp


@dataclass
class Window(LogicalOp):
    """Window functions over the child relation. Output = child columns +
    one column per window function; row set and order are unchanged.
    funcs: (name, fn, arg expr | None, partition key exprs,
    ((order expr, descending), ...), extra) where `extra` is the frame
    tuple (unit, lo, hi) for aggregates/first_value/last_value, (offset,
    default expr | None) for lag/lead, the bucket count for ntile, None
    otherwise. Reference: src/sql/engine/window_function
    (ObWindowFunctionVecOp)."""

    child: LogicalOp
    funcs: tuple[
        tuple[
            str, str, "E.Expr | None",
            tuple["E.Expr", ...],
            tuple[tuple["E.Expr", bool], ...],
            object,
        ],
        ...,
    ]


def output_schema(op: LogicalOp) -> Schema:
    """Schema of an operator's output (qualified names)."""
    if isinstance(op, Scan):
        if op.needed is None:
            return op.schema
        return Schema(tuple(f for f in op.schema.fields if f.name in op.needed))
    if isinstance(op, Filter):
        return output_schema(op.child)
    if isinstance(op, Project):
        from ..expr.compile import infer_type

        child_s = output_schema(op.child)
        return Schema(
            tuple(Field(n, infer_type(e, child_s)) for n, e in op.exprs)
        )
    if isinstance(op, JoinOp):
        ls, rs = output_schema(op.left), output_schema(op.right)
        if op.kind in ("semi", "anti"):
            return ls
        nullable_left = op.kind == "full"
        nullable_right = op.kind in ("left", "full")
        fields = [
            Field(f.name, f.dtype.with_nullable(f.dtype.nullable or nullable_left))
            for f in ls.fields
        ]
        for f in rs.fields:
            fields.append(
                Field(f.name, f.dtype.with_nullable(f.dtype.nullable or nullable_right))
            )
        return Schema(tuple(fields))
    if isinstance(op, Aggregate):
        from ..expr.compile import infer_type

        child_s = output_schema(op.child)
        fields = [Field(n, infer_type(e, child_s)) for n, e in op.group_keys]
        for name, fn, arg, _ in op.aggs:
            if fn == "count":
                fields.append(Field(name, DataType.int64()))
            else:
                t = infer_type(arg, child_s)
                if fn == "sum" and t.is_decimal:
                    t = DataType.decimal(18, t.scale)
                elif fn == "sum" and t.is_integer:
                    t = DataType.int64()
                fields.append(Field(name, t))
        return Schema(tuple(fields))
    if isinstance(op, (Sort, Limit, Distinct, TopN)):
        return output_schema(op.child)
    if isinstance(op, SetOp):
        return setop_schema(output_schema(op.left), output_schema(op.right))
    if isinstance(op, Window):
        child_s = output_schema(op.child)
        fields = list(child_s.fields)
        for name, fn, arg, _pk, _ok, _x in op.funcs:
            fields.append(Field(name, window_out_type(fn, arg, child_s)))
        return Schema(tuple(fields))
    raise AssertionError(type(op))


def window_out_type(fn: str, arg, child_s: Schema) -> DataType:
    """Result type of one window function (mirrors aggregate typing)."""
    from ..expr.compile import infer_type

    if fn in ("row_number", "rank", "dense_rank", "count", "ntile"):
        return DataType.int64()
    if fn == "avg":
        return DataType.float64()
    t = infer_type(arg, child_s)
    if fn == "sum" and t.is_decimal:
        t = DataType.decimal(18, t.scale)
    elif fn == "sum" and t.is_integer:
        t = DataType.int64()
    if fn in ("lag", "lead", "first_value", "last_value"):
        # outside-partition reads / empty frames produce NULL
        return t.with_nullable(True)
    # frames can be empty only for sum/min/max of all-NULL inputs; keep
    # nullability from the argument
    return t


def setop_schema(ls: Schema, rs: Schema) -> Schema:
    """Positionally-aligned common schema of a set operation (names from the
    left side, types promoted per column)."""
    if len(ls.fields) != len(rs.fields):
        raise ResolveError(
            f"set operation arity mismatch: {len(ls.fields)} vs {len(rs.fields)}"
        )
    fields = []
    for lf, rf in zip(ls.fields, rs.fields):
        fields.append(Field(lf.name, promote_types(lf.dtype, rf.dtype)))
    return Schema(tuple(fields))


def promote_types(l: DataType, r: DataType) -> DataType:
    """Common type of two set-operation branch columns."""
    from ..core.dtypes import common_numeric_type

    nullable = l.nullable or r.nullable
    if l.kind == r.kind:
        if l.is_decimal and (l.scale, l.precision) != (r.scale, r.precision):
            return DataType.decimal(18, max(l.scale, r.scale), nullable=nullable)
        return l.with_nullable(nullable)
    if l.is_numeric and r.is_numeric:
        return common_numeric_type(l, r).with_nullable(nullable)
    raise ResolveError(f"set operation type mismatch: {l} vs {r}")


# ---- resolver -------------------------------------------------------------

_AGG_FUNCS = {"sum", "count", "min", "max", "avg", "approx_count_distinct"}


class ResolveError(Exception):
    pass


@dataclass
class ResolvedQuery:
    plan: LogicalOp
    output_names: tuple[str, ...]


class Resolver:
    """One instance per (sub)query block."""

    def __init__(self, catalog, outer: "Resolver | None" = None):
        self.catalog = catalog  # dict name -> Table (core.table.Table)
        self.outer = outer
        self.scopes: list[tuple[str, Schema]] = []  # (alias, schema)
        # merged-view aliases (ob_transform_view_merge): view alias ->
        # {output column -> qualified inner column}; consulted by
        # resolve_name so outer references to the view splice straight
        # onto the inlined base tables
        self.redirects: dict[str, dict[str, str]] = {}
        self.agg_exprs: list[tuple[str, str, E.Expr | None, bool]] = []
        self.correlated: list[E.Expr] = []
        # window-function sink: (name, fn, arg, partition keys, order keys);
        # filled when WindowCall nodes resolve (planner builds the Window op)
        self.win_exprs: list[tuple] = []

    # -- name resolution -------------------------------------------------
    def add_table(self, name: str, alias: str) -> Scan:
        if name not in self.catalog:
            raise ResolveError(f"unknown table {name}")
        t = self.catalog[name]
        qual = Schema(
            tuple(Field(f"{alias}.{f.name}", f.dtype) for f in t.schema.fields)
        )
        self.scopes.append((alias, qual))
        return Scan(name, alias, qual)

    def resolve_name(self, parts: tuple[str, ...]) -> str:
        if len(parts) == 2:
            alias, col = parts
            rd = self.redirects.get(alias)
            if rd is not None:
                if col in rd:
                    return rd[col]
                raise ResolveError(f"unknown column {'.'.join(parts)}")
            for a, s in self.scopes:
                if a == alias:
                    q = f"{a}.{col}"
                    if q in s:
                        return q
            if self.outer is not None:
                return self.outer.resolve_name(parts)
            raise ResolveError(f"unknown column {'.'.join(parts)}")
        col = parts[0]
        matches = []
        for a, s in self.scopes:
            if "#" in a:
                # merged-view internals: reachable only through the view's
                # redirect map, never by bare-name search (columns outside
                # the view's select list stay hidden)
                continue
            q = f"{a}.{col}"
            if q in s:
                matches.append(q)
        for rd in self.redirects.values():
            if col in rd and rd[col] not in matches:
                matches.append(rd[col])
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise ResolveError(f"ambiguous column {col}")
        if self.outer is not None:
            return self.outer.resolve_name(parts)
        raise ResolveError(f"unknown column {col}")

    def visible_schema(self) -> Schema:
        fields = []
        for _, s in self.scopes:
            fields.extend(s.fields)
        return Schema(tuple(fields))

    # -- expression resolution -------------------------------------------
    def expr(self, node: A.Node, allow_agg=False) -> E.Expr:
        if isinstance(node, A.Name):
            return E.ColRef(self.resolve_name(node.parts))
        if isinstance(node, A.NumberLit):
            if "." in node.value:
                return E.lit(float(node.value))
            return E.lit(int(node.value))
        if isinstance(node, A.StringLit):
            return E.lit(node.value)
        if isinstance(node, A.DateLit):
            days = int(np.datetime64(node.value, "D").astype(np.int64))
            return E.Literal(days, DataType.date())
        if isinstance(node, A.UnaryOp):
            if node.op == "-":
                inner = self.expr(node.operand, allow_agg)
                if isinstance(inner, E.Literal):
                    return E.Literal(-inner.value, inner.dtype)
                return E.Func("neg", (inner,))
            if self._contains_null_comparison(node.operand):
                # 3-valued logic: push the negation down (De Morgan) so
                # every NULL-comparison leaf folds in place — NOT(U OR p)
                # = (U AND NOT p) = false-in-WHERE, etc.
                return self._resolve_bool(node.operand, True, allow_agg)
            return E.Not(self.expr(node.operand, allow_agg))
        if isinstance(node, A.BinOp):
            return self._binop(node, allow_agg)
        if isinstance(node, A.BetweenOp):
            return E.Between(
                self.expr(node.expr, allow_agg),
                self.expr(node.low, allow_agg),
                self.expr(node.high, allow_agg),
                node.negated,
            )
        if isinstance(node, A.InOp):
            if node.subquery is not None:
                raise ResolveError("IN subquery handled by planner")
            vals = []
            for it in node.items:
                lit_e = self.expr(it, allow_agg)
                if not isinstance(lit_e, E.Literal):
                    raise ResolveError("IN list items must be literals")
                vals.append(lit_e.value)
            return E.InList(
                self.expr(node.expr, allow_agg), tuple(vals), node.negated
            )
        if isinstance(node, A.LikeOp):
            pat = self.expr(node.pattern)
            e = E.Func("like", (self.expr(node.expr, allow_agg), pat))
            return E.Not(e) if node.negated else e
        if isinstance(node, A.IsNullOp):
            return E.IsNull(self.expr(node.expr, allow_agg), node.negated)
        if isinstance(node, A.ExtractOp):
            return E.Func(
                f"extract_{node.field_}", (self.expr(node.expr, allow_agg),)
            )
        if isinstance(node, A.CaseOp):
            whens = tuple(
                (self.expr(c, allow_agg), self.expr(v, allow_agg))
                for c, v in node.whens
            )
            default = (
                self.expr(node.default, allow_agg)
                if node.default is not None
                else None
            )
            return E.Case(whens, default)
        if isinstance(node, A.CastOp):
            return E.Cast(self.expr(node.expr, allow_agg), _parse_type(node.type_name))
        if isinstance(node, A.SubstringOp):
            # substring(col from 1 for k) = 'lit'  -> handled as prefix in
            # comparisons; standalone substring resolves to a dict transform
            # at compile time (expr/compile handles Func('substr', ...)).
            start = self.expr(node.start)
            length = self.expr(node.length) if node.length else None
            if not (isinstance(start, E.Literal) and (length is None or isinstance(length, E.Literal))):
                raise ResolveError("substring bounds must be literals")
            return E.Func(
                "substr",
                (
                    self.expr(node.expr, allow_agg),
                    start,
                    length if length is not None else E.lit(-1),
                ),
            )
        if isinstance(node, A.WindowCall):
            return self._window_call(node, allow_agg)
        if isinstance(node, A.FuncCall):
            if node.name in _AGG_FUNCS:
                if not allow_agg:
                    raise ResolveError(f"aggregate {node.name} not allowed here")
                return self._agg_call(node)
            if node.name in ("vec_l2", "vec_ip", "vec_cosine"):
                return self._vec_l2_call(node, allow_agg)
            if node.name == "fts_match":
                # fts_match(varchar_col, 'tok tok ...') — word-level
                # full-text match; evaluation sweeps the column's
                # DICTIONARY (the engine's FTS 'index' is the dictionary
                # itself: one LUT per distinct value, not per row)
                from ..core.dtypes import TypeKind as _TK

                if len(node.args) != 2:
                    raise ResolveError("fts_match(column, 'tokens')")
                col = self.expr(node.args[0], allow_agg)
                ct = None
                if isinstance(col, E.ColRef):
                    for _alias, sc in self.scopes:
                        try:
                            ct = sc[col.name]
                            break
                        except Exception:
                            continue
                if ct is None or ct.kind is not _TK.VARCHAR:
                    raise ResolveError(
                        "fts_match first argument must be a VARCHAR column"
                    )
                q = self.expr(node.args[1], allow_agg)
                if not isinstance(q, E.Literal):
                    raise ResolveError("fts_match query must be a literal")
                return E.Func("fts_match", (col, q))
            if node.name in ("json_extract", "json_unquote", "json_valid",
                             "json_type", "json_array_length"):
                return self._json_call(node, allow_agg)
            if node.name in ("lower", "upper", "trim", "lcase", "ucase"):
                if len(node.args) != 1:
                    raise ResolveError(f"{node.name}(string)")
                canon = {"lcase": "lower", "ucase": "upper"}.get(
                    node.name, node.name)
                from ..expr.compile import CASE_FUNC_IMPL

                arg = self.expr(node.args[0], allow_agg)
                if isinstance(arg, E.Literal):
                    # constant fold (also the only executable form for a
                    # non-dictionary argument)
                    return E.lit(CASE_FUNC_IMPL[canon](str(arg.value)))
                return E.Func(canon, (arg,))
            if node.name in ("json_object", "json_array"):
                raise ResolveError(
                    f"{node.name} is supported in the select list only "
                    "(host-side construction, sql/json_host.py)")
            raise ResolveError(f"unknown function {node.name}")
        if isinstance(node, (A.ScalarSubquery, A.ExistsOp)):
            raise ResolveError("subquery handled by planner")
        if isinstance(node, A.IntervalLit):
            raise ResolveError("interval outside date arithmetic")
        raise ResolveError(f"cannot resolve {node!r}")

    def _json_call(self, node: A.FuncCall, allow_agg: bool) -> E.Expr:
        """JSON function family (ob_expr_json_extract.cpp and siblings):
        documents are dict-encoded varchar, so every function evaluates
        once per DISTINCT document through the expression compiler's
        string-view LUTs (expr/compile.py, expr/jsonpath.py)."""
        name = node.name
        if not node.args:
            raise ResolveError(f"{name} needs arguments")
        doc = self.expr(node.args[0], allow_agg)
        if name == "json_extract":
            if len(node.args) != 2:
                raise ResolveError("json_extract(doc, 'path')")
            p = self.expr(node.args[1], allow_agg)
            if not isinstance(p, E.Literal):
                raise ResolveError("json path must be a literal")
            self._check_json_path(str(p.value))
            return E.Func("json_extract", (doc, p))
        if name == "json_unquote":
            if len(node.args) != 1:
                raise ResolveError("json_unquote(value)")
            return E.Func("json_unquote", (doc,))
        if name == "json_valid":
            if len(node.args) != 1:
                raise ResolveError("json_valid(doc)")
            return E.Func("json_valid", (doc,))
        if name == "json_type":
            if len(node.args) == 2:
                p = self.expr(node.args[1], allow_agg)
                if not isinstance(p, E.Literal):
                    raise ResolveError("json path must be a literal")
                self._check_json_path(str(p.value))
                doc = E.Func("json_extract", (doc, p))
            return E.Func("json_type", (doc,))
        if name == "json_array_length":
            args = [doc]
            if len(node.args) == 2:
                p = self.expr(node.args[1], allow_agg)
                if not isinstance(p, E.Literal):
                    raise ResolveError("json path must be a literal")
                self._check_json_path(str(p.value))
                args.append(p)
            return E.Func("json_array_length", tuple(args))
        raise ResolveError(f"unknown function {name}")

    @staticmethod
    def _check_json_path(path: str) -> None:
        from ..expr.jsonpath import JsonPathError, parse_path

        try:
            parse_path(path)
        except JsonPathError as e:
            raise ResolveError(str(e)) from None

    @staticmethod
    def _is_null_comparison(node) -> bool:
        """A comparison with a bare NULL literal on either side."""
        def is_null_lit(n):
            return isinstance(n, A.Name) and n.parts == ("null",)

        return (
            isinstance(node, A.BinOp)
            and node.op in ("=", "!=", "<>", "<", "<=", ">", ">=")
            and (is_null_lit(node.left) or is_null_lit(node.right))
        )

    @classmethod
    def _contains_null_comparison(cls, node) -> bool:
        if cls._is_null_comparison(node):
            return True
        if isinstance(node, A.BinOp) and node.op in ("and", "or"):
            return (cls._contains_null_comparison(node.left)
                    or cls._contains_null_comparison(node.right))
        if isinstance(node, A.UnaryOp) and node.op != "-":
            return cls._contains_null_comparison(node.operand)
        return False

    _FALSE = None  # class-level constant-false built lazily

    def _resolve_bool(self, node, neg: bool, allow_agg) -> E.Expr:
        """Resolve a boolean skeleton with the negation pushed to the
        leaves, so NULL-comparison leaves fold to WHERE-false in any
        composition (a NULL result and FALSE are indistinguishable to a
        filter; the fold is only ever applied in predicate position)."""
        false_ = E.Compare("=", E.lit(0), E.lit(1))
        if self._is_null_comparison(node):
            return false_  # U and NOT U are both never-satisfied
        if isinstance(node, A.BinOp) and node.op in ("and", "or"):
            op = node.op if not neg else ("or" if node.op == "and" else "and")
            l = self._resolve_bool(node.left, neg, allow_agg)
            r = self._resolve_bool(node.right, neg, allow_agg)
            return E.and_(l, r) if op == "and" else E.or_(l, r)
        if isinstance(node, A.UnaryOp) and node.op != "-":
            return self._resolve_bool(node.operand, not neg, allow_agg)
        inner = self.expr(node, allow_agg)
        return E.Not(inner) if neg else inner

    def _binop(self, node: A.BinOp, allow_agg) -> E.Expr:
        op = node.op
        if op in ("and", "or"):
            l = self.expr(node.left, allow_agg)
            r = self.expr(node.right, allow_agg)
            return E.and_(l, r) if op == "and" else E.or_(l, r)
        if op in ("=", "!=", "<>", "<", "<=", ">", ">="):
            if self._is_null_comparison(node):
                # any comparison against NULL is SQL NULL: a typed NULL
                # literal keeps BOTH contexts honest — compile_predicate
                # rejects NULL rows in WHERE position, and a select-list
                # `(k = null) as b` projects NULL, not false
                return E.Literal(None, DataType.bool_(nullable=True))
            return E.Compare(
                op,
                self.expr(node.left, allow_agg),
                self.expr(node.right, allow_agg),
            )
        # date +- interval folding
        if op in ("+", "-") and isinstance(node.right, A.IntervalLit):
            base = self.expr(node.left, allow_agg)
            if isinstance(base, E.Literal) and base.dtype.kind.value == "date":
                days = _interval_shift(base.value, node.right, op)
                return E.Literal(days, DataType.date())
            raise ResolveError("interval arithmetic on non-literal date")
        return E.BinaryOp(
            op, self.expr(node.left, allow_agg), self.expr(node.right, allow_agg)
        )

    def _vec_l2_call(self, node: A.FuncCall, allow_agg) -> E.Expr:
        """vec_l2(vector_col, query): squared L2 distance. The query
        vector (a '[f, f, ...]' string literal) types as VECTOR(d) from
        the column so it can parameterize — one compiled plan serves
        every query vector (reference: obvec distance exprs over the
        vector index, src/storage/vector_index)."""
        if len(node.args) != 2:
            raise ResolveError(f"{node.name}(column, query_vector) takes 2 args")
        from ..core.dtypes import TypeKind

        col = self.expr(node.args[0], allow_agg)
        ct = None
        if isinstance(col, E.ColRef):
            for _alias, sc in self.scopes:
                try:
                    ct = sc[col.name]
                    break
                except Exception:
                    continue
        if ct is None or ct.kind is not TypeKind.VECTOR:
            raise ResolveError(
                f"{node.name} first argument must be a VECTOR column")
        q = self.expr(node.args[1], allow_agg)
        if not isinstance(q, E.Literal):
            raise ResolveError(
                f"{node.name} second argument must be a literal")
        return E.Func(node.name, (col, E.Literal(
            q.value, DataType(TypeKind.VECTOR, precision=ct.precision)
        )))

    def _agg_call(self, node: A.FuncCall) -> E.Expr:
        fn = node.name
        if fn == "approx_count_distinct":
            # the reference's NDV sketch (ob_expr_approx_count_distinct):
            # the executor runs a true fixed-memory HLL (ops/hll.py) on the
            # scalar path, and falls back to the exact first-occurrence
            # distinct count under GROUP BY (group cardinalities are
            # bounded by the group's row count there)
            if len(node.args) != 1:
                raise ResolveError(
                    "approx_count_distinct takes exactly one argument "
                    "(multi-column NDV is not supported)"
                )
            arg = self.expr(node.args[0])
            return E.ColRef(self._add_agg("approx_ndv", arg, False))
        if fn == "count" and (not node.args or isinstance(node.args[0], A.Star)):
            arg = None
        else:
            arg = self.expr(node.args[0])
        if fn == "avg":
            # avg(x) = sum(x) / count(x): count of NON-NULL x, per SQL;
            # AVG(DISTINCT x) needs BOTH halves deduplicated
            s = self._add_agg("sum", arg, node.distinct)
            c = self._add_agg("count", arg, node.distinct)
            return E.BinaryOp("/", E.ColRef(s), E.ColRef(c))
        name = self._add_agg(fn, arg, node.distinct)
        return E.ColRef(name)

    _WINDOW_FUNCS = {
        "row_number", "rank", "dense_rank", "sum", "count", "min", "max",
        "avg", "lag", "lead", "ntile", "first_value", "last_value",
    }
    # functions whose frame is fixed by the standard (frame clause invalid)
    _NO_FRAME = {"row_number", "rank", "dense_rank", "lag", "lead", "ntile"}

    def _window_call(self, node: "A.WindowCall", allow_agg: bool) -> E.Expr:
        """Resolve fn(args) OVER (...) to a ColRef on a window output column;
        the spec is recorded in win_exprs for the planner's Window node.
        avg decomposes into sum/count window functions (like _agg_call).

        The per-func `extra` slot carries the fn-specific spec: the frame
        tuple for aggregates/first_value/last_value; (offset, default expr)
        for lag/lead; the bucket count for ntile; None for ranking funcs.
        Reference: frame resolution in
        src/sql/engine/window_function/ob_window_function_vec_op.cpp."""
        fn = node.name
        if fn not in self._WINDOW_FUNCS:
            raise ResolveError(f"unknown window function {fn}")
        if node.frame is not None and fn in self._NO_FRAME:
            raise ResolveError(f"{fn}() does not accept a frame clause")
        frame = node.frame
        if frame is not None:
            if not node.order_by:
                raise ResolveError("a frame clause requires ORDER BY")
            unit, lo, hi = frame
            if lo is not None and hi is not None and lo > hi:
                raise ResolveError("frame start is after frame end")
            if unit == "range" and (lo not in (None, 0) or hi not in (None, 0)):
                if len(node.order_by) != 1:
                    raise ResolveError(
                        "RANGE frame with a value offset requires exactly "
                        "one ORDER BY key"
                    )
        extra = frame
        arg = None
        if fn in ("row_number", "rank", "dense_rank"):
            if node.args:
                raise ResolveError(f"{fn}() takes no arguments")
            extra = None
        elif fn == "ntile":
            if len(node.args) != 1 or not isinstance(node.args[0], A.NumberLit):
                raise ResolveError("ntile() takes one integer literal")
            try:
                k = int(node.args[0].value)
            except ValueError:
                raise ResolveError("ntile() bucket count must be an integer") \
                    from None
            if k <= 0:
                raise ResolveError("ntile() bucket count must be positive")
            extra = k
        elif fn in ("lag", "lead"):
            if not 1 <= len(node.args) <= 3:
                raise ResolveError(f"{fn}(expr [, offset [, default]])")
            arg = self.expr(node.args[0], allow_agg)
            off = 1
            if len(node.args) >= 2:
                if not isinstance(node.args[1], A.NumberLit):
                    raise ResolveError(f"{fn}() offset must be a literal")
                try:
                    off = int(node.args[1].value)
                except ValueError:
                    raise ResolveError(
                        f"{fn}() offset must be an integer") from None
                if off < 0:
                    raise ResolveError(f"{fn}() offset must be >= 0")
            dflt = (
                self.expr(node.args[2], allow_agg)
                if len(node.args) == 3 else None
            )
            extra = (off, dflt)
        elif fn == "count" and (
            not node.args or isinstance(node.args[0], A.Star)
        ):
            arg = None
        else:
            if len(node.args) != 1:
                raise ResolveError(f"window {fn} takes one argument")
            arg = self.expr(node.args[0], allow_agg)
        if fn in ("min", "max") and frame is not None:
            _u, lo, hi = frame
            if lo is not None and hi is not None:
                raise ResolveError(
                    "min/max windows support frames bounded on one end only"
                )
        if fn in ("rank", "dense_rank", "ntile", "lag", "lead") \
                and not node.order_by:
            raise ResolveError(f"{fn}() requires ORDER BY in its window")
        pk = tuple(self.expr(p, allow_agg) for p in node.partition_by)
        ok = tuple(
            (self.expr(oi.expr, allow_agg), oi.descending)
            for oi in node.order_by
        )
        if fn == "avg":
            s = self._add_window("sum", arg, pk, ok, extra)
            c = self._add_window("count", arg, pk, ok, extra)
            return E.BinaryOp("/", E.ColRef(s), E.ColRef(c))
        return E.ColRef(self._add_window(fn, arg, pk, ok, extra))

    def _add_window(self, fn, arg, pk, ok, extra=None) -> str:
        for name, f2, a2, p2, o2, x2 in self.win_exprs:
            if (f2, a2, p2, o2, x2) == (fn, arg, pk, ok, extra):
                return name
        name = f"$win{next(_counter)}"
        self.win_exprs.append((name, fn, arg, pk, ok, extra))
        return name

    def _add_agg(self, fn: str, arg: E.Expr | None, distinct: bool) -> str:
        # dedupe identical aggregates
        for name, f2, a2, d2 in self.agg_exprs:
            if f2 == fn and a2 == arg and d2 == distinct:
                return name
        name = f"$agg{next(_counter)}"
        self.agg_exprs.append((name, fn, arg, distinct))
        return name


def _interval_shift(days: int, iv: A.IntervalLit, op: str) -> int:
    n = int(iv.value)
    if op == "-":
        n = -n
    d = np.datetime64(int(days), "D")
    if iv.unit.startswith("day"):
        return int((d + np.timedelta64(n, "D")).astype(np.int64))
    if iv.unit.startswith("month") or iv.unit.startswith("year"):
        months = n if iv.unit.startswith("month") else 12 * n
        m = d.astype("datetime64[M]") + np.timedelta64(months, "M")
        dom = (d - d.astype("datetime64[M]")).astype(np.int64)
        # clamp to the target month's last day (SQL/MySQL semantics:
        # '1995-01-31' + 1 month = '1995-02-28', no overflow into March)
        next_m = (m + np.timedelta64(1, "M")).astype("datetime64[D]")
        last_dom = (next_m - m.astype("datetime64[D]")).astype(np.int64) - 1
        dom = min(int(dom), int(last_dom))
        return int((m.astype("datetime64[D]") + np.timedelta64(dom, "D")).astype(np.int64))
    raise ResolveError(f"interval unit {iv.unit}")


def _parse_type(tn: str) -> DataType:
    tn = tn.lower()
    if tn.endswith("?"):  # DataType.__str__ nullable marker round-trip
        return _parse_type(tn[:-1]).with_nullable(True)
    if tn in ("text", "mediumtext", "longtext", "blob", "clob", "json"):
        # LOB surface: dict-encoded varchar holds unbounded values (the
        # dictionary stores the full string ONCE; rows are int32 codes),
        # so TEXT/BLOB map onto the same storage. The reference's
        # out-of-row LOB store (src/storage/lob) exists because its rows
        # are materialized; columnar dict codes make that machinery moot
        # at this engine's scale.
        return DataType.varchar()
    if tn.startswith("vector"):
        if "(" not in tn:
            raise ResolveError("VECTOR needs a dimension: vector(d)")
        d = int(tn[tn.index("(") + 1:tn.index(")")])
        return DataType.vector(d)
    if tn.startswith("decimal") or tn.startswith("numeric"):
        if "(" in tn:
            inner = tn[tn.index("(") + 1 : tn.index(")")]
            p, *rest = inner.split(",")
            return DataType.decimal(int(p), int(rest[0]) if rest else 0)
        return DataType.decimal(18, 0)
    if "(" in tn:
        tn = tn[: tn.index("(")]  # varchar(25), char(1), int(11): length
        # modifiers don't change the physical type
    # accepts both SQL spellings and DataType.__str__ round-trip forms
    if tn in ("int", "integer", "smallint", "tinyint", "mediumint", "int32"):
        return DataType.int32()
    if tn in ("bigint", "int64"):
        return DataType.int64()
    if tn == "int8":
        return DataType.int8()
    if tn == "int16":
        return DataType.int16()
    if tn in ("float", "double", "real", "float64"):
        return DataType.float64()
    if tn == "float32":
        return DataType.float32()
    if tn == "bool":
        return DataType.bool_()
    if tn == "date":
        return DataType.date()
    if tn == "timestamp":
        return DataType.timestamp()
    if tn in ("varchar", "char", "text"):
        return DataType.varchar()
    raise ResolveError(f"unknown type {tn}")
