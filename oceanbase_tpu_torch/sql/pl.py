"""PL: stored procedures — parser + host interpreter.

Reference surface: src/pl (ObPLResolver/ObPLExecutor — OceanBase's
159k-line PL/SQL layer) and src/objit (its LLVM JIT). The rebuild keeps
the architectural split the reference has, at this engine's scale:

- CONTROL FLOW is host-side (a tree-walking interpreter over the
  procedure AST — the reference interprets or JITs it; either way it is
  scalar host work),
- every SQL STATEMENT inside a body executes through the session's
  normal dispatch, so it rides the plan cache — and the plan cache's
  artifact IS a compiled XLA executable. That is this engine's
  equivalent of objit: the hot data-parallel parts of a procedure are
  jitted machine code on the accelerator; only the scalar glue walks
  the tree.

Grammar (MySQL-flavored subset):

  CREATE PROCEDURE name ([IN|OUT|INOUT] p type, ...) BEGIN body END
  body:  DECLARE v type [DEFAULT expr] ;
         SET v = expr ;
         IF expr THEN body [ELSEIF expr THEN body]* [ELSE body] END IF ;
         WHILE expr DO body END WHILE ;
         RETURN [expr] ;
         CALL name(args) ;
         <any SQL statement> [INTO v, ...] ;

Variables substitute into embedded SQL as literals at execution (the
statement text itself was parsed once at CREATE; substitution is an AST
rewrite, so plans parameterize and re-use exactly like client SQL).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ast as A
from .parser import Parser, tokenize


class PlError(Exception):
    pass


# ---------------------------------------------------------------- AST

@dataclass(frozen=True)
class PlParam:
    mode: str  # in | out | inout
    name: str
    type_name: str


@dataclass(frozen=True)
class PlProcedure:
    name: str
    params: tuple[PlParam, ...]
    body: tuple  # of Pl* statements
    text: str    # original definition (SHOW/replication surface)


@dataclass(frozen=True)
class PlDeclare:
    name: str
    type_name: str
    default: A.Node | None


@dataclass(frozen=True)
class PlSet:
    name: str
    expr: A.Node


@dataclass(frozen=True)
class PlIf:
    branches: tuple[tuple[A.Node, tuple], ...]  # (cond, body)*
    orelse: tuple


@dataclass(frozen=True)
class PlWhile:
    cond: A.Node
    body: tuple


@dataclass(frozen=True)
class PlReturn:
    expr: A.Node | None


@dataclass(frozen=True)
class PlCall:
    name: str
    args: tuple[A.Node, ...]


@dataclass(frozen=True)
class PlSql:
    stmt: object          # parsed statement AST
    into: tuple[str, ...]  # SELECT ... INTO targets (empty otherwise)


# ------------------------------------------------------------- parser

class PlParser(Parser):
    """Extends the SQL parser with the procedure grammar (shares the
    lexer, expression grammar and statement parsers)."""

    def parse_procedure(self) -> PlProcedure:
        self.expect("create")
        if self.next().value != "procedure":
            raise SyntaxError("expected CREATE PROCEDURE")
        name = self.next().value
        params: list[PlParam] = []
        self.expect("(")
        if not self.accept(")"):
            while True:
                mode = "in"
                if self.peek().value in ("in", "out", "inout"):
                    mode = self.next().value
                pname = self.next().value
                ptype = self.type_name()
                params.append(PlParam(mode, pname, ptype))
                if not self.accept(","):
                    break
            self.expect(")")
        body = self._block()
        return PlProcedure(name, tuple(params), body, self.sql)

    def _block(self) -> tuple:
        self.expect("begin")
        out: list = []
        while not self.accept("end"):
            out.append(self._pl_statement())
        return tuple(out)

    def _pl_statement(self):
        t = self.peek()
        v = t.value
        if v == "declare":
            self.next()
            name = self.next().value
            tname = self.type_name()
            dflt = None
            if self.peek().value == "default":
                self.next()
                dflt = self.expr_node()
            self.expect(";")
            return PlDeclare(name, tname, dflt)
        if v == "set":
            self.next()
            name = self.next().value
            self.expect("=")
            e = self.expr_node()
            self.expect(";")
            return PlSet(name, e)
        if v == "if":
            self.next()
            branches = []
            cond = self.expr_node()
            if self.next().value != "then":
                raise SyntaxError("expected THEN")
            body = self._stmts_until("elseif", "else", "end")
            branches.append((cond, body))
            orelse: tuple = ()
            while True:
                nxt = self.next().value
                if nxt == "elseif":
                    c2 = self.expr_node()
                    if self.next().value != "then":
                        raise SyntaxError("expected THEN")
                    branches.append(
                        (c2, self._stmts_until("elseif", "else", "end")))
                elif nxt == "else":
                    orelse = self._stmts_until("end")
                elif nxt == "end":
                    if self.next().value != "if":
                        raise SyntaxError("expected END IF")
                    self.expect(";")
                    break
                else:
                    raise SyntaxError(f"unexpected {nxt!r} in IF")
            return PlIf(tuple(branches), orelse)
        if v == "while":
            self.next()
            cond = self.expr_node()
            if self.next().value != "do":
                raise SyntaxError("expected DO")
            body = self._stmts_until("end")
            self.next()  # end
            if self.next().value != "while":
                raise SyntaxError("expected END WHILE")
            self.expect(";")
            return PlWhile(cond, body)
        if v == "return":
            self.next()
            e = None
            if self.peek().value != ";":
                e = self.expr_node()
            self.expect(";")
            return PlReturn(e)
        if v == "call":
            self.next()
            name = self.next().value
            args: list = []
            self.expect("(")
            if not self.accept(")"):
                args.append(self.expr_node())
                while self.accept(","):
                    args.append(self.expr_node())
                self.expect(")")
            self.expect(";")
            return PlCall(name, tuple(args))
        # otherwise: one embedded SQL statement up to ';' (re-lexed so
        # the statement parsers see a clean stream)
        start = t.pos
        depth = 0
        toks: list = []  # (token, paren depth) — for token-level INTO strip
        while True:
            tok = self.peek()
            if tok.kind == "eof":
                raise SyntaxError("unterminated SQL statement in body")
            if tok.value == "(":
                depth += 1
            elif tok.value == ")":
                depth -= 1
            if tok.value == ";" and depth == 0:
                end = tok.pos
                self.next()
                break
            toks.append((tok, depth))
            self.next()
        text = self.sql[start:end]
        into: tuple[str, ...] = ()
        if toks and toks[0][0].value == "select":
            # SELECT ... INTO v[, v] [FROM ...]: strip the INTO clause at
            # the TOKEN level — a string literal containing ' into ', or
            # an INTO in a subquery (depth > 0), must not match.
            ii = next((k for k, (tk, d) in enumerate(toks)
                       if d == 0 and tk.kind == "kw" and tk.value == "into"),
                      None)
            if ii is not None:
                jj = next((k for k in range(ii + 1, len(toks))
                           if toks[k][1] == 0
                           and toks[k][0].kind == "kw"
                           and toks[k][0].value == "from"), None)
                stop = jj if jj is not None else len(toks)
                # variable names may lex as kw (row, key, date, ...);
                # only the separating commas are ops
                into = tuple(tk.value for tk, _ in toks[ii + 1:stop]
                             if tk.kind in ("name", "kw"))
                j = toks[jj][0].pos if jj is not None else end
                text = self.sql[start:toks[ii][0].pos] + " " + self.sql[j:end]
        from . import parser as P

        return PlSql(P.parse_statement(text), into)

    def _stmts_until(self, *enders) -> tuple:
        out: list = []
        while self.peek().value not in enders:
            out.append(self._pl_statement())
        return tuple(out)

    def expr_node(self) -> A.Node:
        """One scalar expression as raw AST (interpreted host-side)."""
        return self.expr()


def parse_procedure(text: str) -> PlProcedure:
    return PlParser(text).parse_procedure()


# -------------------------------------------------------- interpreter

class _Return(Exception):
    def __init__(self, value):
        self.value = value


MAX_PL_OPS = 1_000_000  # runaway-loop guard (cte_max_recursion analog)


@dataclass
class PlInterpreter:
    """Executes a procedure against a session-like object exposing
    .sql(text)->ResultSet and .db (for nested CALL lookup)."""

    session: object
    depth: int = 0
    ops: list = field(default_factory=lambda: [0])

    def call(self, proc: PlProcedure, args: list):
        if self.depth > 64:
            raise PlError("procedure call depth exceeded")
        env: dict[str, object] = {}
        if len(args) != len(proc.params):
            raise PlError(
                f"{proc.name} expects {len(proc.params)} args, "
                f"got {len(args)}"
            )
        for p, a in zip(proc.params, args):
            env[p.name] = a
        try:
            self._run_block(proc.body, env)
        except _Return as r:
            return r.value, env
        return None, env

    def _tick(self):
        self.ops[0] += 1
        if self.ops[0] > MAX_PL_OPS:
            raise PlError("procedure exceeded the statement budget")

    def _run_block(self, body, env):
        for st in body:
            self._tick()
            self._run_stmt(st, env)

    def _run_stmt(self, st, env):
        if isinstance(st, PlDeclare):
            env[st.name] = (
                self._eval(st.default, env) if st.default is not None
                else None
            )
            return
        if isinstance(st, PlSet):
            if st.name not in env:
                raise PlError(f"unknown variable {st.name}")
            env[st.name] = self._eval(st.expr, env)
            return
        if isinstance(st, PlIf):
            for cond, body in st.branches:
                if self._truthy(self._eval(cond, env)):
                    self._run_block(body, env)
                    return
            self._run_block(st.orelse, env)
            return
        if isinstance(st, PlWhile):
            while self._truthy(self._eval(st.cond, env)):
                self._tick()
                self._run_block(st.body, env)
            return
        if isinstance(st, PlReturn):
            raise _Return(
                self._eval(st.expr, env) if st.expr is not None else None
            )
        if isinstance(st, PlCall):
            vals = [self._eval(a, env) for a in st.args]
            ret, callee_env = self._call_by_name(st.name, vals)
            # OUT/INOUT writeback for simple variable arguments
            proc = self._lookup(st.name)
            for p, anode in zip(proc.params, st.args):
                if p.mode in ("out", "inout") and isinstance(anode, A.Name) \
                        and len(anode.parts) == 1:
                    env[anode.parts[0]] = callee_env[p.name]
            return
        if isinstance(st, PlSql):
            stmt = _substitute_vars(st.stmt, env)
            # cache key = the STORED node's identity: substituted
            # literals parameterize inside the plan cache, so every CALL
            # reuses one compiled plan per embedded statement
            rs = self.session.run_statement(
                stmt, cache_key=f"#pl:{id(st.stmt)}")
            if st.into:
                if rs.nrows < 1:
                    raise PlError("SELECT INTO returned no rows")
                row = rs.rows()[0]
                if len(st.into) != len(row):
                    raise PlError("SELECT INTO arity mismatch")
                for n, v in zip(st.into, row):
                    env[n] = v
            return
        raise PlError(f"unknown PL statement {type(st).__name__}")

    def _lookup(self, name) -> PlProcedure:
        proc = self.session.lookup_procedure(name)
        if proc is None:
            raise PlError(f"no procedure {name}")
        return proc

    def _call_by_name(self, name, vals):
        sub = PlInterpreter(self.session, self.depth + 1, self.ops)
        return sub.call(self._lookup(name), vals)

    @staticmethod
    def _truthy(v) -> bool:
        return bool(v) and v is not None

    def _eval(self, node, env):
        """Scalar expression evaluation over host values + variables."""
        self._tick()
        if isinstance(node, A.NumberLit):
            v = node.value
            try:
                return int(v)
            except ValueError:
                return float(v)  # '.' or scientific notation (1e5)
        if isinstance(node, A.StringLit):
            return node.value
        if isinstance(node, A.Name):
            key = node.parts[-1]
            if len(node.parts) == 1 and key in env:
                return env[key]
            raise PlError(f"unknown variable {'.'.join(node.parts)}")
        if isinstance(node, A.BinOp):
            op = node.op
            if op == "and":
                return self._truthy(self._eval(node.left, env)) and \
                    self._truthy(self._eval(node.right, env))
            if op == "or":
                return self._truthy(self._eval(node.left, env)) or \
                    self._truthy(self._eval(node.right, env))
            l = self._eval(node.left, env)
            r = self._eval(node.right, env)
            if l is None or r is None:
                return None
            if op == "+":
                return l + r
            if op == "-":
                return l - r
            if op == "*":
                return l * r
            if op == "/":
                return l / r
            if op == "%":
                return l % r
            if op == "=":
                return l == r
            if op in ("!=", "<>"):
                return l != r
            if op == "<":
                return l < r
            if op == "<=":
                return l <= r
            if op == ">":
                return l > r
            if op == ">=":
                return l >= r
            raise PlError(f"unsupported operator {op}")
        if isinstance(node, A.UnaryOp):
            v = self._eval(node.operand, env)
            if node.op == "-":
                return -v if v is not None else None
            return not self._truthy(v)
        raise PlError(
            f"unsupported expression {type(node).__name__} in PL context"
        )


def _substitute_vars(node, env):
    """Rewrite single-part Name nodes bound in `env` into Literals — the
    bridge from PL variables into embedded SQL (plans then parameterize
    on those literals like any client statement)."""
    import dataclasses

    if isinstance(node, A.Name) and len(node.parts) == 1 \
            and node.parts[0] in env:
        v = env[node.parts[0]]
        if v is None:
            return A.Name(("null",))
        if isinstance(v, str):
            return A.StringLit(v)
        if isinstance(v, bool):
            return A.NumberLit(str(int(v)))
        return A.NumberLit(repr(v))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            cur = getattr(node, f.name)
            new = _substitute_vars(cur, env)
            if new is not cur:
                changes[f.name] = new
        return dataclasses.replace(node, **changes) if changes else node
    if isinstance(node, tuple):
        items = tuple(_substitute_vars(x, env) for x in node)
        if any(a is not b for a, b in zip(items, node)):
            return items
        return node
    return node


