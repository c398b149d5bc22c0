"""Expression IR.

The analog of OceanBase's ObRawExpr trees (sql/resolver/expr/ob_raw_expr.h)
and their compiled ObExpr form (sql/engine/expr/ob_expr.h:447). The reference
maintains three eval modes per expr (scalar, batch, rich-vector,
ob_expr.h:888-898) plus a 552-file library of eval functions; the TPU rebuild
needs exactly one mode — whole-batch evaluation compiled through XLA — so the
IR stays small and the "eval function table" is the compiler in
expr/compile.py.

Nodes are frozen/hashable: expression identity participates in plan-cache
keys (reference: sql/plan_cache parameterized keys).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.dtypes import DataType


class Expr:
    """Base class for expression nodes."""

    __slots__ = ()


@dataclass(frozen=True)
class ColRef(Expr):
    name: str

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class Literal(Expr):
    """A constant. When `slot` is set, the literal is a plan-cache parameter:
    its value arrives at run time as a traced scalar (expr/compile.py
    bind_params), so one XLA executable serves every literal value of the
    same type — the TPU analog of ObPlanCache's parameterized plans
    (sql/plan_cache/ob_plan_cache.h:227), where recompilation is seconds,
    not microseconds. `value` keeps the first-seen constant for host-side
    decisions and unparameterized evaluation."""

    value: object  # python int/float/str/bool/None
    dtype: DataType
    slot: int | None = None

    def __str__(self):
        if self.slot is not None:
            return f"?{self.slot}"
        return repr(self.value)

    def __repr__(self):
        # slotted literals must repr independent of their first-seen value:
        # plan fingerprints (sql/plan_cache.plan_fingerprint) feed on repr,
        # and a value leak would defeat parameterized plan sharing
        if self.slot is not None:
            return f"Literal(?{self.slot}, {self.dtype})"
        return f"Literal({self.value!r}, {self.dtype})"


@dataclass(frozen=True)
class BinaryOp(Expr):
    """Arithmetic: + - * / %  (decimal-aware, see compile.py)."""

    op: str
    left: Expr
    right: Expr

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class Compare(Expr):
    """Comparison: = != < <= > >= producing BOOL with 3-valued nulls."""

    op: str
    left: Expr
    right: Expr

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class BoolOp(Expr):
    """AND / OR over 2+ args with Kleene semantics."""

    op: str  # 'and' | 'or'
    args: tuple[Expr, ...]

    def __str__(self):
        return "(" + f" {self.op} ".join(map(str, self.args)) + ")"


@dataclass(frozen=True)
class Not(Expr):
    arg: Expr

    def __str__(self):
        return f"(not {self.arg})"


@dataclass(frozen=True)
class IsNull(Expr):
    arg: Expr
    negated: bool = False


@dataclass(frozen=True)
class Cast(Expr):
    arg: Expr
    dtype: DataType

    def __str__(self):
        return f"cast({self.arg} as {self.dtype})"


@dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE d END."""

    whens: tuple[tuple[Expr, Expr], ...]
    default: Expr | None = None


@dataclass(frozen=True)
class InList(Expr):
    arg: Expr
    values: tuple[object, ...]
    negated: bool = False


@dataclass(frozen=True)
class Between(Expr):
    arg: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass(frozen=True)
class Func(Expr):
    """Scalar function call.

    Supported names (grown as the SQL surface grows):
      extract_year, extract_month, extract_day  — on DATE
      like                                      — args (col, pattern-literal);
                                                  evaluated against the host
                                                  dictionary, device gather
      substr_eq / prefix / contains             — dict-string helpers
      abs, neg, least, greatest
    """

    name: str
    args: tuple[Expr, ...]

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


# ---- convenience builders -------------------------------------------------


def col(name: str) -> ColRef:
    return ColRef(name)


def lit(value, dtype: DataType | None = None) -> Literal:
    from ..core.dtypes import BOOL, FLOAT64, INT64, VARCHAR, DataType as DT

    if dtype is None:
        if isinstance(value, bool):
            dtype = BOOL
        elif isinstance(value, int):
            dtype = INT64
        elif isinstance(value, float):
            # SQL semantics: a literal with a decimal point is DECIMAL, not
            # float (exact). Critical on TPU where float division is an
            # approximate reciprocal: 0.05 as f32 would misclassify
            # decimal-column comparisons. Fall back to FLOAT64 only when the
            # value doesn't fit an exact short decimal.
            from decimal import Decimal

            d = Decimal(repr(value))
            exp = -d.as_tuple().exponent
            digits = len(d.as_tuple().digits)
            if 0 <= exp <= 6 and digits <= 18:
                dtype = DT.decimal(max(digits, exp + 1), exp)
            else:
                dtype = FLOAT64
        elif isinstance(value, str):
            dtype = VARCHAR
        elif value is None:
            dtype = DT.int64(nullable=True)
        else:
            raise TypeError(f"cannot infer literal type for {value!r}")
    return Literal(value, dtype)


def and_(*args: Expr) -> Expr:
    flat: list[Expr] = []
    for a in args:
        if isinstance(a, BoolOp) and a.op == "and":
            flat.extend(a.args)
        else:
            flat.append(a)
    return flat[0] if len(flat) == 1 else BoolOp("and", tuple(flat))


def or_(*args: Expr) -> Expr:
    flat: list[Expr] = []
    for a in args:
        if isinstance(a, BoolOp) and a.op == "or":
            flat.extend(a.args)
        else:
            flat.append(a)
    return flat[0] if len(flat) == 1 else BoolOp("or", tuple(flat))


def walk(e: Expr):
    """Yield all nodes in the expression tree (pre-order)."""
    yield e
    children: tuple[Expr, ...] = ()
    if isinstance(e, (BinaryOp, Compare)):
        children = (e.left, e.right)
    elif isinstance(e, BoolOp):
        children = e.args
    elif isinstance(e, (Not, IsNull, Cast)):
        children = (e.arg,)
    elif isinstance(e, Case):
        children = tuple(x for w in e.whens for x in w) + (
            (e.default,) if e.default is not None else ()
        )
    elif isinstance(e, InList):
        children = (e.arg,)
    elif isinstance(e, Between):
        children = (e.arg, e.low, e.high)
    elif isinstance(e, Func):
        children = e.args
    for c in children:
        yield from walk(c)


def referenced_columns(e: Expr) -> set[str]:
    return {n.name for n in walk(e) if isinstance(n, ColRef)}
