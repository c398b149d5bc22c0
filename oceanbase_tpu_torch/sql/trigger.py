"""Row-level triggers (BEFORE/AFTER INSERT/UPDATE/DELETE ... FOR EACH ROW).

Reference surface: src/sql/resolver/ddl/ob_trigger_resolver.cpp and the
trigger execution hooks in the DML executors. The rebuild keeps the
MySQL-shaped subset that covers the reference's row-trigger tests:

  * body = one statement or BEGIN ... END; statements are
      - SET NEW.col = <expr>        (BEFORE INSERT/UPDATE only)
      - INSERT / UPDATE / DELETE    (audit-log style side effects)
  * NEW.col / OLD.col references substitute per row as LITERALS into the
    body's AST before execution — side-effect DML then runs through the
    normal session dispatch INSIDE the firing statement's transaction
    (atomic with it, like the reference executing trigger bodies through
    the inner-SQL connection of the same tx).

Bodies parse at CREATE TRIGGER (errors surface to the DDL, not the first
firing) and the parsed form is cached per trigger.
"""

from __future__ import annotations

from dataclasses import replace

from . import ast as A
from .parser import Parser, tokenize


class TriggerError(ValueError):
    pass


def parse_body(body: str) -> tuple:
    """Trigger body text -> tuple of actions:
    ("setnew", col, expr_ast) | ("stmt", stmt_ast)."""
    text = body.strip().rstrip(";")
    toks = tokenize(text)
    if toks and toks[0].value == "begin":
        # BEGIN ... END block: strip the wrapper on the RAW text
        if toks[-2].value != "end":  # [-1] is eof
            raise TriggerError("BEGIN block missing END")
        text = text[toks[0].pos + 5:toks[-2].pos].strip()
    stmts = _split_statements(text)
    if not stmts:
        raise TriggerError("empty trigger body")
    actions = []
    for s in stmts:
        st = tokenize(s)
        if st and st[0].value == "set":
            p = Parser(s)
            p.expect("set")
            t = p.next()
            if not (t.value == "new" and p.accept(".")):
                raise TriggerError("SET target must be NEW.<column>")
            col = p.next().value
            p.expect("=")
            expr = p.expr()
            actions.append(("setnew", col, expr))
        else:
            node = Parser(s).parse_statement()
            if not isinstance(node, (A.Insert, A.Update, A.Delete)):
                raise TriggerError(
                    "trigger statements must be SET NEW.x or DML, got "
                    f"{type(node).__name__}")
            actions.append(("stmt", node))
    return tuple(actions)


def _split_statements(text: str) -> list[str]:
    """Split on top-level ';' using token positions (string literals with
    semicolons stay intact)."""
    cuts = [t.pos for t in tokenize(text) if t.kind == "op" and t.value == ";"]
    out, start = [], 0
    for c in cuts:
        piece = text[start:c].strip()
        if piece:
            out.append(piece)
        start = c + 1
    tail = text[start:].strip()
    if tail:
        out.append(tail)
    return out


def _literal_node(v) -> A.Node:
    import numpy as np

    if v is None:
        return A.Name(("null",))
    if isinstance(v, (bool, np.bool_)):
        return A.NumberLit(str(int(v)))
    if isinstance(v, str):
        return A.StringLit(v)
    if isinstance(v, (int, np.integer)):
        # ints stay ints: a float round-trip corrupts values above 2^53
        return A.NumberLit(str(int(v)))
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return A.NumberLit(str(int(f)))
    return A.NumberLit(repr(f))


def substitute(node: A.Node, new_map: dict | None, old_map: dict | None):
    """Replace NEW.col / OLD.col name references with literal AST nodes
    (one shared walker: ast.rewrite)."""

    def fn(n):
        if isinstance(n, A.Name) and len(n.parts) == 2:
            scope, col = n.parts
            if scope == "new":
                if new_map is None or col not in new_map:
                    raise TriggerError(f"no NEW.{col} in this trigger event")
                return _literal_node(new_map[col])
            if scope == "old":
                if old_map is None or col not in old_map:
                    raise TriggerError(f"no OLD.{col} in this trigger event")
                return _literal_node(old_map[col])
        return None

    return A.rewrite(node, fn)
