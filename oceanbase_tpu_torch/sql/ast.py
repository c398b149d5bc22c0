"""SQL AST nodes.

Reference surface: the parse-node layer (src/sql/parser/parse_node.h) that
the flex/bison grammar produces. The rebuild uses a hand-written recursive
descent parser (sql/parser.py) over these dataclasses; the grammar subset
covers the analytic SQL the TPC-H/TPC-DS suites need and grows toward full
MySQL-compatible DML.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Node:
    __slots__ = ()


# ---- scalar expressions ---------------------------------------------------


@dataclass(frozen=True)
class Name(Node):
    """Possibly-qualified column reference: l_orderkey or l.l_orderkey."""

    parts: tuple[str, ...]

    def __str__(self):
        return ".".join(self.parts)


@dataclass(frozen=True)
class NumberLit(Node):
    value: str  # textual, typed later (int vs decimal)


@dataclass(frozen=True)
class StringLit(Node):
    value: str


@dataclass(frozen=True)
class DateLit(Node):
    value: str  # 'YYYY-MM-DD'


@dataclass(frozen=True)
class IntervalLit(Node):
    value: str
    unit: str  # day | month | year


@dataclass(frozen=True)
class Star(Node):
    pass


@dataclass(frozen=True)
class UnaryOp(Node):
    op: str  # '-' | 'not'
    operand: Node


@dataclass(frozen=True)
class BinOp(Node):
    op: str  # + - * / % = != <> < <= > >= and or
    left: Node
    right: Node


@dataclass(frozen=True)
class BetweenOp(Node):
    expr: Node
    low: Node
    high: Node
    negated: bool = False


@dataclass(frozen=True)
class InOp(Node):
    expr: Node
    items: tuple[Node, ...] | None  # literal list
    subquery: "Select | None" = None
    negated: bool = False


@dataclass(frozen=True)
class LikeOp(Node):
    expr: Node
    pattern: Node
    negated: bool = False


@dataclass(frozen=True)
class IsNullOp(Node):
    expr: Node
    negated: bool = False


@dataclass(frozen=True)
class ExistsOp(Node):
    subquery: "Select"
    negated: bool = False


@dataclass(frozen=True)
class ScalarSubquery(Node):
    subquery: "Select"


@dataclass(frozen=True)
class FuncCall(Node):
    name: str
    args: tuple[Node, ...]
    distinct: bool = False  # count(distinct x)


@dataclass(frozen=True)
class WindowCall(Node):
    """func(args) OVER (PARTITION BY ... ORDER BY ...).

    Reference surface: the window-function resolver/operator
    (src/sql/resolver/expr win_func items, src/sql/engine/window_function).
    Frames: the SQL-default frame only (RANGE UNBOUNDED PRECEDING..CURRENT
    ROW with ORDER BY; the whole partition without)."""

    name: str  # ranking | aggregate | lag/lead | ntile | first/last_value
    args: tuple[Node, ...]
    partition_by: tuple[Node, ...] = ()
    order_by: tuple["OrderItem", ...] = ()
    # (unit, lo, hi): unit in {rows, range}; bounds are signed offsets
    # (negative = PRECEDING, 0 = CURRENT ROW, None = UNBOUNDED that way)
    frame: tuple | None = None


@dataclass(frozen=True)
class ExtractOp(Node):
    field_: str  # year | month | day
    expr: Node


@dataclass(frozen=True)
class SubstringOp(Node):
    expr: Node
    start: Node
    length: Node | None


@dataclass(frozen=True)
class CaseOp(Node):
    whens: tuple[tuple[Node, Node], ...]
    default: Node | None


@dataclass(frozen=True)
class CastOp(Node):
    expr: Node
    type_name: str  # 'decimal(12,2)' | 'date' | 'integer' ...


# ---- relational -----------------------------------------------------------


@dataclass(frozen=True)
class TableRef(Node):
    name: str
    alias: str | None = None
    # FLASHBACK read: AS OF SNAPSHOT <ts> (None = current snapshot)
    snapshot: int | None = None


@dataclass(frozen=True)
class SubqueryRef(Node):
    subquery: "Select"
    alias: str


@dataclass(frozen=True)
class Join(Node):
    kind: str  # inner | left | right | full | cross
    left: Node
    right: Node
    on: Node | None


@dataclass(frozen=True)
class SelectItem(Node):
    expr: Node
    alias: str | None = None


@dataclass(frozen=True)
class OrderItem(Node):
    expr: Node
    descending: bool = False


@dataclass(frozen=True)
class Select(Node):
    items: tuple[SelectItem, ...]
    from_: tuple[Node, ...] = ()  # TableRef | SubqueryRef | Join
    where: Node | None = None
    group_by: tuple[Node, ...] = ()
    having: Node | None = None
    order_by: tuple[OrderItem, ...] = ()
    limit: int | None = None
    offset: int | None = None
    distinct: bool = False
    ctes: tuple[tuple[str, "Select"], ...] = ()  # WITH name AS (...)
    # grouping sets: index tuples into group_by (ROLLUP/CUBE/GROUPING
    # SETS expansion); None = plain GROUP BY
    group_sets: tuple[tuple[int, ...], ...] | None = None
    # names of ctes that are WITH RECURSIVE (subset of ctes keys)
    recursive_ctes: tuple[str, ...] = ()


@dataclass(frozen=True)
class SetSelect(Node):
    """Set operation between two query expressions.

    Reference surface: the set-operator resolvers/operators
    (src/sql/resolver/set, src/sql/engine/set — hash union/intersect/
    except). ORDER BY / LIMIT apply to the combined result; output column
    names come from the left side."""

    kind: str  # union | intersect | except
    all: bool
    left: "Select | SetSelect"
    right: "Select | SetSelect"
    order_by: tuple[OrderItem, ...] = ()
    limit: int | None = None
    offset: int | None = None
    ctes: tuple[tuple[str, "Select"], ...] = ()
    recursive_ctes: tuple[str, ...] = ()


# ---- statements (DDL / DML / tx control) ----------------------------------
# Reference surface: the DDL/DML resolvers under src/sql/resolver/{ddl,dml}
# (ObCreateTableStmt, ObInsertStmt, ObUpdateStmt, ObDeleteStmt) and the tx
# control statements handled by ObSqlTransControl (sql/ob_sql_trans_control).


@dataclass(frozen=True)
class ColumnDef(Node):
    name: str
    type_name: str  # as written: 'bigint' | 'decimal(12,2)' | 'varchar' ...
    not_null: bool = False


@dataclass(frozen=True)
class CreateTable(Node):
    name: str
    columns: tuple[ColumnDef, ...]
    primary_key: tuple[str, ...]  # empty -> first column
    if_not_exists: bool = False
    # PARTITION BY HASH(col) PARTITIONS n (reference: hash-partitioned
    # tables; each partition is a tablet placed on a log stream)
    partition_by: str | None = None
    n_partitions: int = 1


@dataclass(frozen=True)
class DropTable(Node):
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class CreateIndex(Node):
    """CREATE [UNIQUE] INDEX name ON table (cols...). Reference surface:
    the DDL resolver + direct-insert index build (src/storage/ddl)."""

    name: str
    table: str
    columns: tuple[str, ...]
    unique: bool = False
    if_not_exists: bool = False


@dataclass(frozen=True)
class DropIndex(Node):
    name: str
    table: str
    if_exists: bool = False


@dataclass(frozen=True)
class Insert(Node):
    table: str
    columns: tuple[str, ...]  # empty -> full schema order
    rows: tuple[tuple[Node, ...], ...] = ()  # literal/expr tuples
    select: "Select | None" = None  # INSERT ... SELECT


@dataclass(frozen=True)
class Update(Node):
    table: str
    assignments: tuple[tuple[str, Node], ...]  # (column, expr)
    where: Node | None = None


@dataclass(frozen=True)
class Delete(Node):
    table: str
    where: Node | None = None


@dataclass(frozen=True)
class AlterSystemSet(Node):
    """ALTER SYSTEM SET name = value (config hot reload)."""

    name: str
    value: str


@dataclass(frozen=True)
class RunLayoutAdvisor(Node):
    """ALTER SYSTEM RUN LAYOUT ADVISOR (one advisor pass now; applies
    only when ob_layout_advisor_mode=auto, else dry-run)."""


@dataclass(frozen=True)
class Show(Node):
    """SHOW PARAMETERS [LIKE 'pat'] | SHOW TABLES."""

    what: str
    like: str | None = None


@dataclass(frozen=True)
class LockTable(Node):
    """LOCK TABLE name IN SHARE|EXCLUSIVE MODE (tx-scoped, tablelock)."""

    name: str
    exclusive: bool


@dataclass(frozen=True)
class CreateTrigger(Node):
    """CREATE TRIGGER name {BEFORE|AFTER} {INSERT|UPDATE|DELETE} ON table
    FOR EACH ROW <body> (ob_trigger_resolver.cpp analog; body grammar in
    sql/trigger.py)."""

    name: str
    timing: str  # before | after
    event: str  # insert | update | delete
    table: str
    body_sql: str


@dataclass(frozen=True)
class DropTrigger(Node):
    name: str


@dataclass(frozen=True)
class CreateView(Node):
    """CREATE [OR REPLACE] VIEW name AS <select text> — a PLAIN view:
    only the definition text persists; every query referencing it expands
    the text at plan time (merged into the outer block when the body is
    simple select-project-join — ob_transform_view_merge analog)."""

    name: str
    query_sql: str
    or_replace: bool = False


@dataclass(frozen=True)
class DropView(Node):
    name: str


@dataclass(frozen=True)
class CreateMaterializedView(Node):
    """CREATE MATERIALIZED VIEW name AS <select text> — materialized at
    creation; REFRESH re-runs the defining query (full refresh, the
    mview core; reference: src/storage/mview)."""

    name: str
    query_sql: str


@dataclass(frozen=True)
class DropMaterializedView(Node):
    name: str


@dataclass(frozen=True)
class RefreshMaterializedView(Node):
    name: str


@dataclass(frozen=True)
class CreateExternalTable(Node):
    """CREATE EXTERNAL TABLE name USING format LOCATION 'path' — schema
    inferred from the file via the plugin loader registry."""

    name: str
    format: str
    location: str


@dataclass(frozen=True)
class CreateVectorIndex(Node):
    """CREATE VECTOR INDEX name ON table (column) [WITH (lists=N,
    nprobe=M)] — IVF-flat ANN index (storage/vector_index.py)."""

    name: str
    table: str
    column: str
    lists: int = 0
    nprobe: int = 8


@dataclass(frozen=True)
class DropVectorIndex(Node):
    name: str
    table: str
    column: str


@dataclass(frozen=True)
class CreateUser(Node):
    """CREATE USER name [IDENTIFIED BY 'password']."""

    name: str
    password: str = ""


@dataclass(frozen=True)
class DropUser(Node):
    name: str


@dataclass(frozen=True)
class Grant(Node):
    """GRANT priv[, priv] ON table|* TO user. Privileges lowercase;
    'all' expands server-side."""

    privs: tuple[str, ...]
    obj: str
    user: str


@dataclass(frozen=True)
class Revoke(Node):
    privs: tuple[str, ...]
    obj: str
    user: str


@dataclass(frozen=True)
class KillQuery(Node):
    """KILL [QUERY] <session_id>: interrupt the session's running
    statement cluster-wide (share/interrupt analog)."""

    session_id: int


@dataclass(frozen=True)
class Begin(Node):
    pass


@dataclass(frozen=True)
class Commit(Node):
    pass


@dataclass(frozen=True)
class Rollback(Node):
    pass


Statement = Node  # any of the above or Select


def rewrite(node, fn):
    """Generic top-down AST rewrite: `fn(node)` returns a replacement node
    (stopping descent there) or None to keep walking. Non-Node values and
    tuples (including one level of nested tuples, e.g. CTE pairs) pass
    through structurally. Shared by trigger NEW/OLD substitution and the
    planner's view-merge requalification — one walker to maintain."""
    if isinstance(node, Node):
        r = fn(node)
        if r is not None:
            return r
    if not isinstance(node, Node):
        return node
    from dataclasses import replace as _rep

    def val(v):
        if isinstance(v, Node):
            return rewrite(v, fn)
        if isinstance(v, tuple):
            return tuple(val(x) for x in v)
        return v

    kw = {}
    for fld in node.__dataclass_fields__:
        v = getattr(node, fld)
        v2 = val(v)
        if v2 is not v:
            kw[fld] = v2
    return _rep(node, **kw) if kw else node
