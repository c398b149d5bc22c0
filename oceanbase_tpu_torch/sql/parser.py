"""SQL lexer + recursive-descent parser.

Reference surface: the flex/bison MySQL grammar + parse nodes
(src/sql/parser/sql_parser_mysql_mode.y, parse_node.h) and the fast parser
used for plan-cache keys (ob_fast_parser.h). The rebuild is a compact
hand-written recursive-descent parser producing sql/ast.py nodes; parameter
extraction for the plan cache is done on the token stream (see
normalize_for_cache) — the fast-parser analog.
"""

from __future__ import annotations

import re
from collections import OrderedDict

from . import ast as A

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op>->>|->|<>|!=|>=|<=|\|\||[-+*/%(),.;=<>])
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "between", "like", "is",
    "null", "exists", "case", "when", "then", "else", "end", "cast",
    "extract", "substring", "for", "distinct", "join", "inner", "left",
    "right", "full", "cross", "outer", "on", "date", "interval", "year",
    "month", "day", "asc", "desc", "union", "all", "any", "some", "with",
    "intersect", "except", "over", "partition",
    # window frames
    "rows", "range", "unbounded", "preceding", "following", "current", "row",
    # statements
    "create", "drop", "table", "primary", "key", "if", "insert", "into",
    "values", "update", "set", "delete", "begin", "start", "transaction",
    "commit", "rollback", "alter", "system", "show", "parameters", "tables",
    "lock", "mode", "share", "exclusive", "unique", "index", "kill", "query", "partitions",
    # DCL
    "grant", "revoke", "to", "user", "identified", "privileges",
    # grouping sets
    "rollup", "cube", "grouping", "sets",
    "recursive",
    # materialized views
    "refresh", "materialized", "view",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind  # num | str | name | kw | op | eof
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> list[Token]:
    out = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SyntaxError(f"bad character {sql[i]!r} at {i}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        v = m.group()
        if m.lastgroup == "name":
            lv = v.lower()
            out.append(Token("kw" if lv in KEYWORDS else "name", lv, m.start()))
        elif m.lastgroup == "str":
            out.append(Token("str", v[1:-1].replace("''", "'"), m.start()))
        elif m.lastgroup == "num":
            out.append(Token("num", v, m.start()))
        else:
            out.append(Token("op", v, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


def normalize_for_cache(sql: str) -> tuple[str, tuple]:
    """Fast-parser analog: replace literals with ? and collect parameters.
    The normalized text is the plan-cache key (reference: ObPlanCache
    parameterized keys, src/sql/plan_cache)."""
    toks = tokenize(sql)
    parts, params = [], []
    for t in toks:
        if t.kind in ("num", "str"):
            parts.append("?")
            params.append(t.value)
        elif t.kind == "eof":
            break
        else:
            parts.append(t.value)
    return " ".join(parts), tuple(params)


# raw-text memo in front of the tokenizer: serving workloads repeat EXACT
# statement texts (the reference's plan cache is keyed on raw text first),
# and the result is a pure function of the text. Bounded LRU.
_FAST_NORM_MEMO: "OrderedDict[str, tuple]" = OrderedDict()
_FAST_NORM_CAP = 4096


def fast_normalize(sql: str) -> tuple[str, tuple, tuple]:
    """One tokenize pass producing everything the text-keyed fast tier
    needs: a KIND-marked normalized text (?n for numbers, ?s for strings
    — `a = 5` and `a = '5'` plan differently and must not share a text
    entry), the raw literal token texts in order, and their kinds.

    The plain plan-cache key is recoverable without re-tokenizing:
    normalize_for_cache's text is this text with ?n/?s collapsed to ?
    (the tokenizer never emits a bare '?', so the rewrite is unambiguous).
    """
    hit = _FAST_NORM_MEMO.get(sql)
    if hit is not None:
        _FAST_NORM_MEMO.move_to_end(sql)
        return hit
    toks = tokenize(sql)
    parts, params, kinds = [], [], []
    for t in toks:
        if t.kind == "num":
            parts.append("?n")
            params.append(t.value)
            kinds.append("num")
        elif t.kind == "str":
            parts.append("?s")
            params.append(t.value)
            kinds.append("str")
        elif t.kind == "eof":
            break
        else:
            parts.append(t.value)
    out = (" ".join(parts), tuple(params), tuple(kinds))
    _FAST_NORM_MEMO[sql] = out
    if len(_FAST_NORM_MEMO) > _FAST_NORM_CAP:
        _FAST_NORM_MEMO.popitem(last=False)
    return out


def digest_text(sql: str) -> str:
    """Statement digest for the workload repository: the kind-marked
    normalized text (identical to the fast tier's key, so fast-path
    statements and their full-path compiles share one digest). Statements
    the tokenizer rejects still need SOME stable digest — whitespace
    collapse keeps repeats folding together without claiming kinds."""
    try:
        return fast_normalize(sql)[0]
    except Exception:  # noqa: BLE001 - any tokenizer error
        return " ".join(sql.split())


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers --------------------------------------------------
    def peek(self, k=0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, value: str) -> bool:
        t = self.peek()
        if t.kind in ("kw", "op") and t.value == value:
            self.i += 1
            return True
        return False

    def expect(self, value: str) -> Token:
        t = self.next()
        if t.value != value:
            raise SyntaxError(f"expected {value!r}, got {t.value!r} @{t.pos}")
        return t

    # -- entry ----------------------------------------------------------
    def parse_statement(self) -> A.Node:
        """Any statement: SELECT (incl. WITH), DDL, DML, tx control."""
        t = self.peek()
        handlers = {
            "create": self._create,
            "drop": self._drop,
            "insert": self._insert,
            "update": self._update,
            "delete": self._delete,
            "begin": self._tx_begin,
            "start": self._tx_begin,
            "commit": lambda: (self.next(), A.Commit())[1],
            "rollback": lambda: (self.next(), A.Rollback())[1],
            "alter": self._alter,
            "show": self._show,
            "lock": self._lock,
            "kill": self._kill,
            "grant": self._grant,
            "revoke": self._revoke,
            "refresh": self._refresh,
        }
        h = handlers.get(t.value) if t.kind == "kw" else None
        if h is None:
            return self.parse()
        stmt = h()
        self.accept(";")
        if self.peek().kind != "eof":
            tk = self.peek()
            raise SyntaxError(f"trailing tokens at {tk.pos}: {tk.value!r}")
        return stmt

    def _alter(self) -> "A.AlterSystemSet | A.RunLayoutAdvisor":
        self.expect("alter")
        self.expect("system")
        if self.peek().value == "run":
            self.next()
            self.expect("layout")
            self.expect("advisor")
            return A.RunLayoutAdvisor()
        self.expect("set")
        name = self.next().value
        self.expect("=")
        t = self.peek()
        if t.kind == "str":
            self.next()
            return A.AlterSystemSet(name, t.value)
        # unquoted value: take the RAW statement text (case preserved, so
        # WARN stays WARN; suffixed values like 32M / 10s lex as several
        # tokens but are one value)
        start = t.pos
        end = start
        while self.peek().kind != "eof" and self.peek().value != ";":
            tk = self.next()
            end = tk.pos + len(str(tk.value))
        if end == start:
            raise SyntaxError(f"missing parameter value at {t.pos}")
        return A.AlterSystemSet(name, self.sql[start:end].strip())

    def _kill(self) -> "A.KillQuery":
        self.expect("kill")
        self.accept("query")
        return A.KillQuery(int(self.next().value))

    def _lock(self) -> A.LockTable:
        self.expect("lock")
        self.expect("table")
        name = self.next().value
        self.expect("in")
        t = self.next().value
        if t not in ("share", "exclusive"):
            raise SyntaxError(f"bad lock mode {t!r}")
        self.expect("mode")
        return A.LockTable(name, exclusive=(t == "exclusive"))

    def _show(self) -> A.Show:
        self.expect("show")
        what = self.next().value
        like = None
        if self.accept("like"):
            like = self.next().value
        return A.Show(what, like)

    def _tx_begin(self) -> A.Begin:
        if self.next().value == "start":
            self.expect("transaction")
        return A.Begin()

    def _privlist(self) -> tuple[str, ...]:
        privs = [self.next().value.lower()]
        if privs[0] == "all":
            self.accept("privileges")
        while self.accept(","):
            privs.append(self.next().value.lower())
        return tuple(privs)

    def _grant(self) -> "A.Grant":
        self.expect("grant")
        privs = self._privlist()
        self.expect("on")
        obj = "*" if self.accept("*") else self.next().value
        self.expect("to")
        return A.Grant(privs, obj, self.next().value)

    def _revoke(self) -> "A.Revoke":
        self.expect("revoke")
        privs = self._privlist()
        self.expect("on")
        obj = "*" if self.accept("*") else self.next().value
        self.expect("from")
        return A.Revoke(privs, obj, self.next().value)

    def _create(self) -> "A.CreateTable | A.CreateIndex":
        self.expect("create")
        if self.peek().value == "materialized":
            self.next()
            if self.next().value != "view":
                raise SyntaxError("expected MATERIALIZED VIEW")
            name = self.next().value
            t = self.expect("as")
            # the defining query is kept as TEXT (re-planned per refresh
            # against the current schema, like the reference's mview
            # definitions in the schema service); consume to EOF
            self.i = len(self.toks) - 1
            return A.CreateMaterializedView(
                name, self.sql[t.pos + 2:].strip().rstrip(";")
            )
        if self.peek().value == "view" or (
            self.peek().value == "or" and self.peek(1).value == "replace"
        ):
            replace = False
            if self.peek().value == "or":
                self.next()
                self.next()
                replace = True
            if self.next().value != "view":
                raise SyntaxError("expected VIEW")
            name = self.next().value
            t = self.expect("as")
            self.i = len(self.toks) - 1  # definition kept as text
            return A.CreateView(
                name, self.sql[t.pos + 2:].strip().rstrip(";"), replace
            )
        if self.peek().value == "trigger":
            self.next()
            name = self.next().value
            timing = self.next().value
            if timing not in ("before", "after"):
                raise SyntaxError("expected BEFORE or AFTER")
            event = self.next().value
            if event not in ("insert", "update", "delete"):
                raise SyntaxError("expected INSERT, UPDATE or DELETE")
            self.expect("on")
            table = self.next().value
            if self.next().value != "for":
                raise SyntaxError("expected FOR EACH ROW")
            if self.next().value != "each":
                raise SyntaxError("expected FOR EACH ROW")
            t = self.next()
            if t.value != "row":
                raise SyntaxError("expected FOR EACH ROW")
            self.i = len(self.toks) - 1  # body kept as text
            body = self.sql[t.pos + 3:].strip().rstrip(";")
            return A.CreateTrigger(name, timing, event, table, body)
        if self.peek().value == "external":
            self.next()
            self.expect("table")
            name = self.next().value
            if self.next().value != "using":
                raise SyntaxError("expected USING <format>")
            fmt = self.next().value
            if self.next().value != "location":
                raise SyntaxError("expected LOCATION '<path>'")
            t = self.next()
            if t.kind != "str":
                raise SyntaxError("LOCATION needs a quoted path")
            return A.CreateExternalTable(name, fmt, t.value)
        if self.peek().value == "vector" and self.peek(1).value == "index":
            self.next()
            self.next()
            name = self.next().value
            self.expect("on")
            table = self.next().value
            self.expect("(")
            column = self.next().value
            self.expect(")")
            lists, nprobe = 0, 8
            if self.peek().value == "with":
                self.next()
                self.expect("(")
                while True:
                    k = self.next().value
                    self.expect("=")
                    v = int(self.next().value)
                    if k == "lists":
                        lists = v
                    elif k == "nprobe":
                        nprobe = v
                    else:
                        raise SyntaxError(f"unknown vector index option {k}")
                    if not self.accept(","):
                        break
                self.expect(")")
            return A.CreateVectorIndex(name, table, column, lists, nprobe)
        if self.accept("user"):
            name = self.next().value
            pw = ""
            if self.accept("identified"):
                self.expect("by")
                t = self.next()
                pw = t.value
            return A.CreateUser(name, pw)
        unique = self.accept("unique")
        if self.accept("index"):
            if_not_exists = False
            if self.accept("if"):
                self.expect("not")
                self.expect("exists")
                if_not_exists = True
            name = self.next().value
            self.expect("on")
            table = self.next().value
            self.expect("(")
            cols = [self.next().value]
            while self.accept(","):
                cols.append(self.next().value)
            self.expect(")")
            return A.CreateIndex(name, table, tuple(cols), unique, if_not_exists)
        if unique:
            raise SyntaxError("UNIQUE outside CREATE UNIQUE INDEX")
        self.expect("table")
        if_not_exists = False
        if self.accept("if"):
            self.expect("not")
            self.expect("exists")
            if_not_exists = True
        name = self.next().value
        self.expect("(")
        cols: list[A.ColumnDef] = []
        pk: tuple[str, ...] = ()
        while True:
            if self.peek().value == "primary":
                self.next()
                self.expect("key")
                self.expect("(")
                pkl = [self.next().value]
                while self.accept(","):
                    pkl.append(self.next().value)
                self.expect(")")
                pk = tuple(pkl)
            else:
                cname = self.next().value
                tname = self.type_name()
                not_null = False
                if self.accept("not"):
                    self.expect("null")
                    not_null = True
                elif self.accept("null"):
                    pass
                if self.accept("primary"):
                    self.expect("key")
                    pk = (cname,)
                cols.append(A.ColumnDef(cname, tname, not_null))
            if not self.accept(","):
                break
        self.expect(")")
        part_col, n_parts = None, 1
        if self.accept("partition"):
            self.expect("by")
            kind = self.next().value
            if kind != "hash":
                raise SyntaxError(f"unsupported partitioning {kind!r}")
            self.expect("(")
            part_col = self.next().value
            self.expect(")")
            self.expect("partitions")
            n_parts = int(self.next().value)
            if n_parts < 1:
                raise SyntaxError("PARTITIONS must be >= 1")
        return A.CreateTable(
            name, tuple(cols), pk, if_not_exists, part_col, n_parts
        )

    def _refresh(self) -> "A.RefreshMaterializedView":
        self.expect("refresh")
        if self.next().value != "materialized":
            raise SyntaxError("expected REFRESH MATERIALIZED VIEW")
        if self.next().value != "view":
            raise SyntaxError("expected REFRESH MATERIALIZED VIEW")
        return A.RefreshMaterializedView(self.next().value)

    def _drop(self) -> "A.DropTable | A.DropIndex":
        self.expect("drop")
        if self.peek().value == "materialized":
            self.next()
            if self.next().value != "view":
                raise SyntaxError("expected MATERIALIZED VIEW")
            return A.DropMaterializedView(self.next().value)
        if self.peek().value == "view":
            self.next()
            return A.DropView(self.next().value)
        if self.peek().value == "trigger":
            self.next()
            return A.DropTrigger(self.next().value)
        if self.peek().value == "vector" and self.peek(1).value == "index":
            self.next()
            self.next()
            name = self.next().value
            self.expect("on")
            table = self.next().value
            self.expect("(")
            column = self.next().value
            self.expect(")")
            return A.DropVectorIndex(name, table, column)
        if self.accept("user"):
            return A.DropUser(self.next().value)
        if self.accept("index"):
            if_exists = False
            if self.accept("if"):
                self.expect("exists")
                if_exists = True
            name = self.next().value
            self.expect("on")
            return A.DropIndex(name, self.next().value, if_exists)
        self.expect("table")
        if_exists = False
        if self.accept("if"):
            self.expect("exists")
            if_exists = True
        return A.DropTable(self.next().value, if_exists)

    def _insert(self) -> A.Insert:
        self.expect("insert")
        self.expect("into")
        name = self.next().value
        columns: tuple[str, ...] = ()
        if self.peek().value == "(":
            self.next()
            cl = [self.next().value]
            while self.accept(","):
                cl.append(self.next().value)
            self.expect(")")
            columns = tuple(cl)
        if self.accept("values"):
            rows = []
            while True:
                self.expect("(")
                row = [self.expr()]
                while self.accept(","):
                    row.append(self.expr())
                self.expect(")")
                rows.append(tuple(row))
                if not self.accept(","):
                    break
            return A.Insert(name, columns, tuple(rows))
        # INSERT ... SELECT
        return A.Insert(name, columns, (), self.select())

    def _update(self) -> A.Update:
        self.expect("update")
        name = self.next().value
        self.expect("set")
        assigns = []
        while True:
            col = self.next().value
            self.expect("=")
            assigns.append((col, self.expr()))
            if not self.accept(","):
                break
        where = self.expr() if self.accept("where") else None
        return A.Update(name, tuple(assigns), where)

    def _delete(self) -> A.Delete:
        self.expect("delete")
        self.expect("from")
        name = self.next().value
        where = self.expr() if self.accept("where") else None
        return A.Delete(name, where)

    def parse(self) -> "A.Select | A.SetSelect":
        ctes = []
        recursive = False
        if self.accept("with"):
            recursive = self.accept("recursive")
            while True:
                name = self.next().value
                self.expect("as")
                self.expect("(")
                # recursive bodies are base UNION [ALL] step: full
                # query expressions, not bare SELECTs
                ctes.append((name, self.query_expr()))
                self.expect(")")
                if not self.accept(","):
                    break
        s = self.query_expr()
        if ctes:
            rec_names = tuple(n for n, _ in ctes) if recursive else ()
            if isinstance(s, A.SetSelect):
                s = A.SetSelect(
                    kind=s.kind, all=s.all, left=s.left, right=s.right,
                    order_by=s.order_by, limit=s.limit, offset=s.offset,
                    ctes=tuple(ctes), recursive_ctes=rec_names,
                )
            else:
                s = A.Select(
                    items=s.items, from_=s.from_, where=s.where,
                    group_by=s.group_by, having=s.having, order_by=s.order_by,
                    limit=s.limit, offset=s.offset, distinct=s.distinct,
                    ctes=tuple(ctes), recursive_ctes=rec_names,
                    group_sets=s.group_sets,
                )
        self.accept(";")
        if self.peek().kind != "eof":
            t = self.peek()
            raise SyntaxError(f"trailing tokens at {t.pos}: {t.value!r}")
        return s

    # -- set operations (UNION / INTERSECT / EXCEPT) --------------------
    def query_expr(self) -> "A.Select | A.SetSelect":
        left, lparen = self.query_term()
        while self.peek().kind == "kw" and self.peek().value in ("union", "except"):
            kind = self.next().value
            all_ = self.accept("all")
            self.accept("distinct")
            right, rparen = self.query_term()
            left = self._make_setop(kind, all_, left, lparen, right, rparen)
            lparen = False
        # trailing ORDER BY / LIMIT after a parenthesized last branch still
        # sits in the token stream; it scopes to the whole set result
        if isinstance(left, A.SetSelect):
            order_by = list(left.order_by)
            limit, offset = left.limit, left.offset
            changed = False
            if self.peek().kind == "kw" and self.peek().value == "order":
                if order_by:
                    raise SyntaxError("duplicate ORDER BY on set operation")
                self.next()
                self.expect("by")
                order_by = [self.order_item()]
                while self.accept(","):
                    order_by.append(self.order_item())
                changed = True
            if self.peek().kind == "kw" and self.peek().value == "limit":
                if limit is not None:
                    raise SyntaxError("duplicate LIMIT on set operation")
                self.next()
                limit = int(self.next().value)
                if self.accept("offset"):
                    offset = int(self.next().value)
                changed = True
            if changed:
                left = A.SetSelect(
                    left.kind, left.all, left.left, left.right,
                    tuple(order_by), limit, offset, left.ctes,
                )
        return left

    def query_term(self):
        left, lparen = self.query_primary()
        while self.peek().kind == "kw" and self.peek().value == "intersect":
            self.next()
            all_ = self.accept("all")
            self.accept("distinct")
            right, rparen = self.query_primary()
            left = self._make_setop("intersect", all_, left, lparen, right, rparen)
            lparen = False
        return left, lparen

    def query_primary(self):
        if self.peek().value == "(" and self.peek().kind == "op":
            self.next()
            q = self.query_expr()
            self.expect(")")
            return q, True
        return self.select(), False

    @staticmethod
    def _make_setop(kind, all_, left, lparen, right, rparen):
        """Combine two branches. A trailing ORDER BY / LIMIT greedily parsed
        into an UNPARENTHESIZED right branch scopes to the whole set result
        (SQL scoping) and hoists onto the SetSelect node — including from a
        nested SetSelect built by a tighter-binding INTERSECT. Parenthesized
        branches keep their clauses (branch-local top-N is legitimate)."""
        order_by, limit, offset = (), None, None
        if (
            not lparen
            and isinstance(left, A.Select)
            and (left.order_by or left.limit is not None)
        ):
            raise SyntaxError(
                "ORDER BY/LIMIT on a set-operation branch needs parentheses"
            )
        if not rparen and isinstance(right, A.Select) and (
            right.order_by or right.limit is not None
        ):
            order_by, limit, offset = right.order_by, right.limit, right.offset
            right = A.Select(
                items=right.items, from_=right.from_, where=right.where,
                group_by=right.group_by, having=right.having,
                distinct=right.distinct, ctes=right.ctes,
            )
        elif not rparen and isinstance(right, A.SetSelect) and (
            right.order_by or right.limit is not None
        ):
            order_by, limit, offset = right.order_by, right.limit, right.offset
            right = A.SetSelect(
                right.kind, right.all, right.left, right.right,
                (), None, None, right.ctes,
            )
        return A.SetSelect(kind, all_, left, right, order_by, limit, offset)

    def select(self) -> A.Select:
        self.expect("select")
        distinct = self.accept("distinct")
        items = [self.select_item()]
        while self.accept(","):
            items.append(self.select_item())
        from_ = ()
        if self.accept("from"):
            from_ = [self.table_expr()]
            while self.accept(","):
                from_.append(self.table_expr())
        where = self.expr() if self.accept("where") else None
        group_by = ()
        group_sets = None
        if self.accept("group"):
            self.expect("by")
            if self.peek().kind == "kw" and self.peek().value in (
                "rollup", "cube"
            ):
                kind = self.next().value
                self.expect("(")
                group_by = [self.expr()]
                while self.accept(","):
                    group_by.append(self.expr())
                self.expect(")")
                k = len(group_by)
                if kind == "rollup":
                    group_sets = tuple(
                        tuple(range(k - i)) for i in range(k + 1)
                    )
                else:  # cube: all subsets, largest first
                    group_sets = tuple(sorted(
                        (tuple(i for i in range(k) if m & (1 << i))
                         for m in range(1 << k)),
                        key=lambda s: (-len(s), s),
                    ))
            elif self.peek().kind == "kw" and self.peek().value == "grouping":
                self.next()
                self.expect("sets")
                self.expect("(")
                sets_ast: list[list] = []
                while True:
                    self.expect("(")
                    one: list = []
                    if not self.accept(")"):
                        one.append(self.expr())
                        while self.accept(","):
                            one.append(self.expr())
                        self.expect(")")
                    sets_ast.append(one)
                    if not self.accept(","):
                        break
                self.expect(")")
                group_by = []
                sets_idx = []
                for one in sets_ast:
                    idxs = []
                    for e in one:
                        if e not in group_by:
                            group_by.append(e)
                        idxs.append(group_by.index(e))
                    sets_idx.append(tuple(idxs))
                group_sets = tuple(sets_idx)
            else:
                group_by = [self.expr()]
                while self.accept(","):
                    group_by.append(self.expr())
        having = self.expr() if self.accept("having") else None
        order_by = []
        if self.accept("order"):
            self.expect("by")
            order_by = [self.order_item()]
            while self.accept(","):
                order_by.append(self.order_item())
        limit = offset = None
        if self.accept("limit"):
            limit = int(self.next().value)
            if self.accept("offset"):
                offset = int(self.next().value)
        return A.Select(
            items=tuple(items),
            from_=tuple(from_),
            where=where,
            group_by=tuple(group_by),
            having=having,
            order_by=tuple(order_by),
            limit=limit,
            offset=offset,
            distinct=distinct,
            group_sets=group_sets,
        )

    def select_item(self) -> A.SelectItem:
        if self.peek().value == "*" and self.peek().kind == "op":
            self.next()
            return A.SelectItem(A.Star())
        e = self.expr()
        alias = None
        if self.accept("as"):
            alias = self.next().value
        elif self.peek().kind == "name":
            alias = self.next().value
        return A.SelectItem(e, alias)

    def order_item(self) -> A.OrderItem:
        e = self.expr()
        desc = False
        if self.accept("desc"):
            desc = True
        else:
            self.accept("asc")
        return A.OrderItem(e, desc)

    # -- FROM -----------------------------------------------------------
    def table_expr(self) -> A.Node:
        left = self.table_primary()
        while True:
            kind = None
            if self.accept("inner"):
                kind = "inner"
            elif self.accept("left"):
                self.accept("outer")
                kind = "left"
            elif self.accept("right"):
                self.accept("outer")
                kind = "right"
            elif self.accept("full"):
                self.accept("outer")
                kind = "full"
            elif self.accept("cross"):
                kind = "cross"
            elif self.peek().value == "join":
                kind = "inner"
            if kind is None:
                return left
            self.expect("join")
            right = self.table_primary()
            on = None
            if kind != "cross" and self.accept("on"):
                on = self.expr()
            left = A.Join(kind, left, right, on)

    def table_primary(self) -> A.Node:
        if self.accept("("):
            sub = self.select()
            self.expect(")")
            self.accept("as")
            alias = self.next().value
            return A.SubqueryRef(sub, alias)
        name = self.next()
        if name.kind not in ("name", "kw"):
            raise SyntaxError(f"expected table name, got {name.value!r}")
        alias = None
        snapshot = None
        if self.accept("as"):
            if self.peek().value == "of":
                # FLASHBACK: t AS OF SNAPSHOT <ts> [alias]
                self.next()
                if self.next().value != "snapshot":
                    raise SyntaxError("expected AS OF SNAPSHOT <ts>")
                snapshot = int(self.next().value)
                if self.accept("as"):
                    alias = self.next().value
                elif self.peek().kind == "name":
                    alias = self.next().value
            else:
                alias = self.next().value
        elif self.peek().kind == "name":
            alias = self.next().value
        return A.TableRef(name.value, alias, snapshot)

    # -- expressions ----------------------------------------------------
    def expr(self) -> A.Node:
        return self.or_expr()

    def or_expr(self) -> A.Node:
        e = self.and_expr()
        while self.accept("or"):
            e = A.BinOp("or", e, self.and_expr())
        return e

    def and_expr(self) -> A.Node:
        e = self.not_expr()
        while self.accept("and"):
            e = A.BinOp("and", e, self.not_expr())
        return e

    def not_expr(self) -> A.Node:
        if self.accept("not"):
            return A.UnaryOp("not", self.not_expr())
        return self.predicate()

    def predicate(self) -> A.Node:
        e = self.additive()
        negated = False
        if self.peek().value == "not" and self.peek(1).value in (
            "between", "in", "like",
        ):
            self.next()
            negated = True
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            # ANY/ALL/SOME subquery comparisons
            if self.peek().value in ("any", "all", "some"):
                raise NotImplementedError("quantified comparisons")
            return A.BinOp(t.value, e, self.additive())
        if self.accept("between"):
            low = self.additive()
            self.expect("and")
            high = self.additive()
            return A.BetweenOp(e, low, high, negated)
        if self.accept("in"):
            self.expect("(")
            if self.peek().value == "select":
                sub = self.select()
                self.expect(")")
                return A.InOp(e, None, sub, negated)
            items = [self.expr()]
            while self.accept(","):
                items.append(self.expr())
            self.expect(")")
            return A.InOp(e, tuple(items), None, negated)
        if self.accept("like"):
            return A.LikeOp(e, self.additive(), negated)
        if self.accept("is"):
            neg = self.accept("not")
            t2 = self.peek()
            if t2.kind == "name" and t2.value == "json":
                # x IS [NOT] JSON -> json_valid(x) (the SQL/JSON predicate;
                # MySQL spells it json_valid, Oracle IS JSON)
                self.next()
                f = A.FuncCall("json_valid", (e,))
                return A.UnaryOp("not", f) if neg else f
            self.expect("null")
            return A.IsNullOp(e, neg)
        return e

    def additive(self) -> A.Node:
        e = self.multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                e = A.BinOp(t.value, e, self.multiplicative())
            else:
                return e

    def multiplicative(self) -> A.Node:
        e = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                e = A.BinOp(t.value, e, self.unary())
            else:
                return e

    def unary(self) -> A.Node:
        if self.peek().value == "-" and self.peek().kind == "op":
            self.next()
            return A.UnaryOp("-", self.unary())
        if self.peek().value == "+" and self.peek().kind == "op":
            self.next()
            return self.unary()
        return self._postfix(self.atom())

    def _postfix(self, e: A.Node) -> A.Node:
        """MySQL JSON arrow operators: col->'$.p' = json_extract,
        col->>'$.p' = json_unquote(json_extract)."""
        while self.peek().kind == "op" and self.peek().value in ("->", "->>"):
            op = self.next().value
            t = self.next()
            if t.kind != "str":
                raise SyntaxError(
                    f"JSON path string expected after {op} @{t.pos}")
            ex = A.FuncCall("json_extract", (e, A.StringLit(t.value)))
            e = ex if op == "->" else A.FuncCall("json_unquote", (ex,))
        return e

    def atom(self) -> A.Node:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return A.NumberLit(t.value)
        if t.kind == "str":
            self.next()
            return A.StringLit(t.value)
        if t.value == "(":
            self.next()
            if self.peek().value == "select":
                sub = self.select()
                self.expect(")")
                return A.ScalarSubquery(sub)
            e = self.expr()
            self.expect(")")
            return e
        if t.value == "date" and self.peek(1).kind == "str":
            self.next()
            return A.DateLit(self.next().value)
        if t.value == "interval":
            self.next()
            v = self.next().value  # quoted or bare number
            unit = self.next().value
            return A.IntervalLit(str(v), unit)
        if t.value == "exists":
            self.next()
            self.expect("(")
            sub = self.select()
            self.expect(")")
            return A.ExistsOp(sub)
        if t.value == "case":
            return self.case_expr()
        if t.value == "cast":
            self.next()
            self.expect("(")
            e = self.expr()
            self.expect("as")
            tn = self.type_name()
            self.expect(")")
            return A.CastOp(e, tn)
        if t.value == "extract":
            self.next()
            self.expect("(")
            fld = self.next().value
            self.expect("from")
            e = self.expr()
            self.expect(")")
            return A.ExtractOp(fld, e)
        if t.value == "substring":
            self.next()
            self.expect("(")
            e = self.expr()
            if self.accept("from"):
                start = self.expr()
                length = self.expr() if self.accept("for") else None
            else:
                self.expect(",")
                start = self.expr()
                length = self.expr() if self.accept(",") else None
            self.expect(")")
            return A.SubstringOp(e, start, length)
        if t.kind in ("name", "kw"):
            self.next()
            # function call?
            if self.peek().value == "(" and self.peek().kind == "op":
                self.next()
                distinct = self.accept("distinct")
                if self.peek().value == "*" and self.peek().kind == "op":
                    self.next()
                    args = (A.Star(),)
                else:
                    args = []
                    if self.peek().value != ")":
                        args = [self.expr()]
                        while self.accept(","):
                            args.append(self.expr())
                    args = tuple(args)
                self.expect(")")
                if self.peek().value == "over" and self.peek().kind == "kw":
                    self.next()
                    self.expect("(")
                    partition_by = []
                    if self.accept("partition"):
                        self.expect("by")
                        partition_by = [self.expr()]
                        while self.accept(","):
                            partition_by.append(self.expr())
                    order_by = []
                    if self.accept("order"):
                        self.expect("by")
                        order_by = [self.order_item()]
                        while self.accept(","):
                            order_by.append(self.order_item())
                    frame = self._frame_clause()
                    self.expect(")")
                    if distinct:
                        raise SyntaxError("DISTINCT window aggregates unsupported")
                    return A.WindowCall(
                        t.value, args, tuple(partition_by), tuple(order_by),
                        frame,
                    )
                return A.FuncCall(t.value, args, distinct)
            parts = [t.value]
            while self.peek().value == "." and self.peek().kind == "op":
                self.next()
                parts.append(self.next().value)
            return A.Name(tuple(parts))
        raise SyntaxError(f"unexpected token {t.value!r} @{t.pos}")

    def _frame_clause(self):
        """[ROWS|RANGE [BETWEEN <bound> AND <bound> | <bound>]] inside an
        OVER(). Returns (unit, lo, hi) or None; bounds are signed row/value
        offsets (negative = PRECEDING), 0 = CURRENT ROW, None = UNBOUNDED
        toward that end."""
        if self.peek().kind != "kw" or self.peek().value not in ("rows", "range"):
            return None
        unit = self.next().value

        def bound(direction_required=None):
            if self.accept("unbounded"):
                d = self.next().value  # preceding | following
                if d not in ("preceding", "following"):
                    raise SyntaxError(f"UNBOUNDED {d.upper()}?")
                return None, d
            if self.accept("current"):
                self.expect("row")
                return 0, "current"
            n = self.next()
            if n.kind != "num":
                raise SyntaxError(f"frame bound needs a number, got {n.value!r}")
            k = int(n.value)
            d = self.next().value
            if d == "preceding":
                return -k, d
            if d == "following":
                return k, d
            raise SyntaxError(f"frame bound direction {d!r}")

        if self.accept("between"):
            lo, lod = bound()
            self.expect("and")
            hi, hid = bound()
        else:
            lo, lod = bound()
            if lod == "following":
                raise SyntaxError("frame start cannot be FOLLOWING without BETWEEN")
            hi, hid = 0, "current"
        if lod == "following" and lo is None:
            raise SyntaxError("frame start cannot be UNBOUNDED FOLLOWING")
        if hid == "preceding" and hi is None:
            raise SyntaxError("frame end cannot be UNBOUNDED PRECEDING")
        # normalize UNBOUNDED: start-side None means -inf, end-side +inf
        return (unit, lo, hi)

    def case_expr(self) -> A.Node:
        self.expect("case")
        whens = []
        while self.accept("when"):
            c = self.expr()
            self.expect("then")
            v = self.expr()
            whens.append((c, v))
        default = self.expr() if self.accept("else") else None
        self.expect("end")
        return A.CaseOp(tuple(whens), default)

    def type_name(self) -> str:
        base = self.next().value
        if self.accept("("):
            args = [self.next().value]
            while self.accept(","):
                args.append(self.next().value)
            self.expect(")")
            return f"{base}({','.join(args)})"
        return base


def parse_statement(sql: str) -> A.Node:
    """Parse any statement (SELECT, DDL, DML, tx control)."""
    return Parser(sql).parse_statement()


def parse(sql: str) -> A.Select:
    return Parser(sql).parse()
