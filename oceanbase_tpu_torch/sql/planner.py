"""Query planner: AST -> resolved, rewritten, join-ordered logical plan.

Reference surfaces:
- rewrite: the 82-rule transformer (src/sql/rewrite/ob_transformer_impl.h).
  Implemented rules: conjunct splitting, equi-join extraction, predicate
  pushdown to scans, OR-common-conjunct hoisting (or-expansion analog),
  subquery unnesting (ob_transform_subquery_coalesce/aggr_subquery):
    EXISTS / IN-subquery        -> semi / anti join with lifted correlation
    correlated scalar aggregate -> group-by over correlation keys + join
    uncorrelated scalar agg     -> 1-row aggregate broadcast-joined
  DISTINCT-aggregate expansion (distinct pre-dedup, the two-phase analog of
  the reference's distinct-agg hash infra).
- optimizer: CBO join ordering (src/sql/optimizer/ob_join_order.h) — greedy
  connected-subgraph heuristic on estimated filtered cardinalities.

Derived tables (FROM subqueries) and CTEs plan their block recursively and
join as relations whose outputs are renamed into the block's namespace.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace

from ..core.dtypes import Schema
from ..expr import ir as E
from . import ast as A
from .logical import (
    Aggregate,
    Distinct,
    Filter,
    JoinOp,
    Limit,
    LogicalOp,
    Project,
    ResolveError,
    Resolver,
    Scan,
    SetOp,
    Sort,
    TopN,
    Window,
    output_schema,
)

_sub_counter = itertools.count()


@dataclass
class PlannedQuery:
    plan: LogicalOp
    output_names: tuple[str, ...]


def capture_node_estimates(executor, plan: LogicalOp) -> dict:
    """Optimizer cardinality estimate per pre-order node id, keyed
    exactly like the compiled program's node numbering (the executor
    re-numbers the ROUTED plan at compile time, so callers pass that
    plan, not the raw planner output). Captured once at compile time and
    pinned to the PreparedPlan / plan artifact, so every profiled actual
    (engine/plan_profile.py) pairs with the estimate the optimizer
    planned with — not a later re-estimate over evolved stats."""
    from ..engine.executor import _number_nodes

    return {
        nid: int(executor._est_rows(op))
        for nid, op in _number_nodes(plan).items()
    }


@dataclass
class Relation:
    """One FROM item: a base scan or a planned derived table."""

    alias: str
    plan: LogicalOp
    is_scan: bool

    @property
    def scan(self) -> Scan:
        assert isinstance(self.plan, Scan)
        return self.plan


def split_conjuncts(e: E.Expr | None) -> list[E.Expr]:
    if e is None:
        return []
    if isinstance(e, E.BoolOp) and e.op == "and":
        out = []
        for a in e.args:
            out.extend(split_conjuncts(a))
        return out
    return [e]


def split_ast_conjuncts(node: A.Node | None) -> list[A.Node]:
    if node is None:
        return []
    if isinstance(node, A.BinOp) and node.op == "and":
        return split_ast_conjuncts(node.left) + split_ast_conjuncts(node.right)
    return [node]


def hoist_common_or_conjuncts(e: E.Expr) -> list[E.Expr]:
    """OR(a&b&c, a&d) -> [a, OR(b&c, d)] — factors conjuncts common to every
    OR branch so join keys and single-table filters buried in OR arms (TPC-H
    Q19 shape) become visible to pushdown/join extraction. (Reference: the
    or-expansion transform family, sql/rewrite/ob_transform_or_expansion.*.)
    """
    if not (isinstance(e, E.BoolOp) and e.op == "or"):
        return [e]
    branches = [split_conjuncts(b) for b in e.args]
    common = [c for c in branches[0] if all(c in b for b in branches[1:])]
    if not common:
        return [e]
    rest_branches = []
    for b in branches:
        rest = [c for c in b if c not in common]
        rest_branches.append(E.and_(*rest) if rest else E.lit(True))
    if any(isinstance(rb, E.Literal) for rb in rest_branches):
        return common
    return common + [E.or_(*rest_branches)]


def or_to_in(e: E.Expr) -> E.Expr:
    """OR of equalities on ONE column against literals -> InList
    (x=1 OR x=2 OR x=3 -> x IN (1,2,3)): one vectorized membership test
    instead of an OR chain, and a stabler plan-cache shape. (Reference:
    sql/rewrite or-expansion / in-list normalization.)"""
    if not (isinstance(e, E.BoolOp) and e.op == "or"):
        return e
    col = None
    vals = []
    for b in e.args:
        if not (
            isinstance(b, E.Compare) and b.op in ("=", "==")
            and isinstance(b.left, E.ColRef)
            and isinstance(b.right, E.Literal)
        ):
            return e
        if col is None:
            col = b.left.name
        elif b.left.name != col:
            return e
        vals.append(b.right.value)
    if col is None or len(vals) < 2:
        return e
    dtypes = {type(v) for v in vals}
    if len(dtypes) != 1:
        return e
    return E.InList(E.ColRef(col), tuple(vals))


def _tables_of(e: E.Expr) -> set[str]:
    return {n.split(".", 1)[0] for n in E.referenced_columns(e)}


def _is_equi_join(e: E.Expr) -> tuple[E.ColRef, E.ColRef] | None:
    if (
        isinstance(e, E.Compare)
        and e.op in ("=", "==")
        and isinstance(e.left, E.ColRef)
        and isinstance(e.right, E.ColRef)
    ):
        lt = e.left.name.split(".", 1)[0]
        rt = e.right.name.split(".", 1)[0]
        if lt != rt:
            return e.left, e.right
    return None


def _contains_subquery(node: A.Node) -> bool:
    if isinstance(node, (A.ScalarSubquery, A.ExistsOp)):
        return True
    if isinstance(node, A.InOp) and node.subquery is not None:
        return True
    for attr in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, attr)
        if isinstance(v, A.Node) and _contains_subquery(v):
            return True
        if isinstance(v, tuple):
            for x in v:
                if isinstance(x, A.Node) and _contains_subquery(x):
                    return True
                if isinstance(x, tuple) and any(
                    isinstance(y, A.Node) and _contains_subquery(y) for y in x
                ):
                    return True
    return False


class Planner:
    def __init__(self, catalog, stats=None, unique_keys=None, views=None):
        self.catalog = catalog  # name -> Table
        # share/stats.StatsManager (None = heuristic-only estimates)
        self.stats = stats
        # table -> unique key column tuple (DISTINCT elimination)
        self.unique_keys = unique_keys or {}
        self.ctes: dict[str, A.Select] = {}
        # plain views: name -> defining SELECT text (shared MUTABLE dict —
        # the server's DDL updates it in place). Expanded at plan time;
        # simple SPJ bodies MERGE into the referencing block
        # (ob_transform_view_merge), everything else plans as a derived
        # table. Plan-cache safety: planning precedes the cache lookup and
        # plan_fingerprint is part of the key, so redefinition changes the
        # key automatically.
        self.views: dict[str, str] = views if views is not None else {}
        self._view_depth = 0

    def _distinct_redundant(self, plan) -> bool:
        """True when `plan`'s rows are already unique, so a Distinct above
        it is a no-op (reference: ob_transform_distinct_elimination):
        a projection carrying ALL group keys of an Aggregate below it, or
        ALL unique-key columns of a single base table."""
        if not isinstance(plan, Project):
            return False
        srcs = {
            e.name for _n, e in plan.exprs if isinstance(e, E.ColRef)
        }
        node = plan.child
        if isinstance(node, Aggregate) and node.group_keys:
            return {n for n, _ in node.group_keys} <= srcs
        while isinstance(node, Filter):
            node = node.child
        if isinstance(node, Scan):
            uk = self.unique_keys.get(node.table)
            if uk:
                qual = {f"{node.alias}.{c}" for c in uk}
                return qual <= srcs
        return False

    # -- cardinality estimates (stats-backed with heuristic fallback) --
    def _scan_rows(self, scan: Scan) -> float:
        if scan.table == "$dual":
            return 1.0
        t = self.catalog[scan.table]
        base = t.nrows or 1
        if scan.pushed_filter is not None:
            ts = self.stats.table_stats(scan.table) if self.stats else None
            if ts is not None and ts.nrows > 0:
                base = base * ts.selectivity(scan.pushed_filter, t)
            else:
                n_conj = len(split_conjuncts(scan.pushed_filter))
                base = base * (0.25 ** min(n_conj, 3))
        return max(base, 1.0)

    def _rel_rows(self, rel: Relation) -> float:
        if rel.is_scan:
            return self._scan_rows(rel.scan)
        return self._est_op(rel.plan)

    def _est_op(self, op) -> float:
        if isinstance(op, Scan):
            return self._scan_rows(op)
        if isinstance(op, Filter):
            return max(self._est_op(op.child) * 0.5, 1.0)
        if isinstance(op, Aggregate):
            return max(self._est_op(op.child) * 0.1, 1.0)
        if isinstance(op, JoinOp):
            return max(self._est_op(op.left), self._est_op(op.right))
        if isinstance(op, (Project, Sort, Distinct)):
            return self._est_op(op.child)
        if isinstance(op, Limit):
            return float(op.n)
        return 1e4

    # ================================================================ API
    def plan(self, sel: "A.Select | A.SetSelect", outer: Resolver | None = None) -> PlannedQuery:
        for name, csel in getattr(sel, "ctes", ()):
            self.ctes[name] = csel
        if isinstance(sel, A.SetSelect):
            return self._plan_setop(sel, outer)
        plan, r, out_items, visible = self._plan_block(sel, outer)
        plan = self._simplify_outer_joins(plan)
        plan = self._eliminate_left_joins(plan)
        return PlannedQuery(plan, visible)

    def _simplify_outer_joins(self, op, null_rejected: frozenset = frozenset()):
        """Outer-join elimination (ob_transform_simplify's outer->inner
        rule): a LEFT join under a NULL-REJECTING predicate on its right
        side cannot produce surviving null-extended rows, so it is an
        inner join — which unlocks the engine's merge/affine fast paths
        and the right-deep rotation that left joins block.

        `null_rejected` carries columns that some ancestor filter
        rejects NULLs on (comparisons, BETWEEN, IN: all yield NULL/false
        for NULL inputs, and compile_predicate drops those rows)."""
        if isinstance(op, Filter):
            nr = set(null_rejected)
            for c in split_conjuncts(op.pred):
                nr |= _null_rejecting_cols(c)
            child = self._simplify_outer_joins(op.child, frozenset(nr))
            return op if child is op.child else replace(op, child=child)
        if isinstance(op, JoinOp):
            kind = op.kind
            if kind in ("left", "full"):
                rej_r = any(n in null_rejected
                            for n in output_schema(op.right).names())
                rej_l = kind == "full" and any(
                    n in null_rejected
                    for n in output_schema(op.left).names())
                if kind == "full":
                    if rej_l and rej_r:
                        kind = "inner"
                    elif rej_r:
                        kind = "left"
                    # rej_l alone would be a RIGHT join (the resolver
                    # mirrors those away; not representable here): keep
                elif rej_r:
                    kind = "inner"
            # predicates keep rejecting through the preserved (probe)
            # side; the null-extended sides reset
            left = self._simplify_outer_joins(
                op.left,
                null_rejected if kind in ("inner", "left", "semi", "anti")
                else frozenset(),
            )
            right = self._simplify_outer_joins(op.right, frozenset())
            if kind == op.kind and left is op.left and right is op.right:
                return op
            return replace(op, kind=kind, left=left, right=right)
        if isinstance(op, (Project, Sort, Distinct, Limit, TopN)):
            # only Sort/Distinct are sound pass-throughs: a Limit/TopN
            # below the filter SAMPLES rows, and converting a join under
            # it changes which rows the sample draws from; Project
            # renames would need mapping through
            passes = isinstance(op, (Sort, Distinct))
            child = self._simplify_outer_joins(
                op.child, null_rejected if passes else frozenset())
            return op if child is op.child else replace(op, child=child)
        if hasattr(op, "child"):
            child = self._simplify_outer_joins(op.child, frozenset())
            return op if child is op.child else replace(op, child=child)
        if isinstance(op, SetOp):
            left = self._simplify_outer_joins(op.left, frozenset())
            right = self._simplify_outer_joins(op.right, frozenset())
            if left is op.left and right is op.right:
                return op
            return replace(op, left=left, right=right)
        return op

    def _plan_setop(self, node: A.SetSelect, outer: Resolver | None) -> PlannedQuery:
        lq = self.plan(node.left, outer)
        rq = self.plan(node.right, outer)
        if len(lq.output_names) != len(rq.output_names):
            raise ResolveError(
                f"set operation arity mismatch: {len(lq.output_names)} vs "
                f"{len(rq.output_names)}"
            )
        # align the right side positionally onto the left side's names
        rplan = Project(
            rq.plan,
            tuple(
                (ln, E.ColRef(rn))
                for ln, rn in zip(lq.output_names, rq.output_names)
            ),
        )
        plan: LogicalOp = SetOp(node.kind, node.all, lq.plan, rplan)
        names = lq.output_names
        order_keys = []
        for oi in node.order_by:
            if (
                isinstance(oi.expr, A.Name)
                and len(oi.expr.parts) == 1
                and oi.expr.parts[0] in names
            ):
                order_keys.append((E.ColRef(oi.expr.parts[0]), oi.descending))
            elif isinstance(oi.expr, A.NumberLit):
                order_keys.append(
                    (E.ColRef(names[int(oi.expr.value) - 1]), oi.descending)
                )
            else:
                raise ResolveError(
                    "set-operation ORDER BY must use output names or ordinals"
                )
        if order_keys and node.limit is not None:
            plan = TopN(plan, tuple(order_keys), node.limit, node.offset or 0)
        elif order_keys:
            plan = Sort(plan, tuple(order_keys))
        elif node.limit is not None:
            plan = Limit(plan, node.limit, node.offset or 0)
        return PlannedQuery(plan, names)

    # ======================================================== block core
    def _plan_block(self, sel: A.Select, outer: Resolver | None):
        """Plan one SELECT block. Returns (plan, resolver, out_items, visible)."""
        r = Resolver({n: t for n, t in self.catalog.items()}, outer)

        relations: list[Relation] = []
        join_conds: list[E.Expr] = []
        outer_join_specs: list[tuple[str, str, A.Node | None]] = []  # (kind, right_alias, on)
        merged_where_asts: list[A.Node] = []
        outer_has_star = any(isinstance(it.expr, A.Star) for it in sel.items)

        def add_relation_from(node: A.Node, allow_merge: bool = True):
            if isinstance(node, A.TableRef):
                alias = node.alias or node.name
                if node.name in self.ctes:
                    relations.append(self._plan_derived(self.ctes[node.name], alias, r))
                elif node.name in self.views and node.name not in self.catalog:
                    if self._view_depth > 16:
                        raise ResolveError(
                            f"view expansion too deep at {node.name} "
                            "(cyclic views?)")
                    from .parser import parse as _parse

                    self._view_depth += 1
                    try:
                        body = _parse(self.views[node.name])
                        if (allow_merge
                                and not outer_has_star
                                and self._view_mergeable(body)):
                            # ob_transform_view_merge: splice the view's
                            # tables + predicates into THIS block so the
                            # optimizer join-orders across the boundary
                            # and predicates push into the view's scans
                            self._merge_view(
                                body, alias, r, add_relation_from,
                                merged_where_asts)
                        else:
                            relations.append(
                                self._plan_derived(body, alias, r))
                    finally:
                        self._view_depth -= 1
                else:
                    relations.append(Relation(alias, r.add_table(node.name, alias), True))
                return alias
            if isinstance(node, A.SubqueryRef):
                relations.append(self._plan_derived(node.subquery, node.alias, r))
                return node.alias
            if isinstance(node, A.Join):
                if node.kind == "inner" or node.kind == "cross":
                    add_relation_from(node.left)
                    add_relation_from(node.right)
                    if node.on is not None:
                        join_conds.extend(split_conjuncts(r.expr(node.on)))
                    return None
                if node.kind in ("left", "full"):
                    # the null-extended side must stay ONE relation — a
                    # merged view would splice in as inner tables and its
                    # WHERE would wrongly filter null-extended rows (FULL
                    # null-extends BOTH sides)
                    add_relation_from(
                        node.left, allow_merge=(node.kind == "left"))
                    ra = add_relation_from(node.right, allow_merge=False)
                    if ra is None:
                        raise ResolveError(
                            f"{node.kind} join right side must be a relation"
                        )
                    outer_join_specs.append((node.kind, ra, node.on))
                    return None
                if node.kind == "right":
                    # A RIGHT JOIN B == B LEFT JOIN A (the reference's
                    # resolver does the same side swap)
                    la = add_relation_from(node.right)
                    ra = add_relation_from(node.left, allow_merge=False)
                    if ra is None:
                        raise ResolveError("right join left side must be a relation")
                    outer_join_specs.append(("left", ra, node.on))
                    return None
                raise ResolveError(f"{node.kind} join not yet supported")
            raise ResolveError(f"bad FROM item {node!r}")

        for f in sel.from_:
            add_relation_from(f)

        # ---- WHERE: split AST conjuncts; subquery conjuncts unnest -----
        semi_specs = []  # (kind, sub_plan_rel, keys, residual)
        post_join_filters: list[E.Expr] = []
        where_conjs: list[E.Expr] = []
        where_ast_conjs = split_ast_conjuncts(sel.where)
        for mw in merged_where_asts:  # merged views' predicates (pushable)
            where_ast_conjs.extend(split_ast_conjuncts(mw))
        for ast_c in where_ast_conjs:
            if isinstance(ast_c, A.ExistsOp):
                semi_specs.append(self._plan_exists(ast_c.subquery, ast_c.negated, r))
            elif isinstance(ast_c, A.UnaryOp) and ast_c.op == "not" and isinstance(ast_c.operand, A.ExistsOp):
                semi_specs.append(
                    self._plan_exists(ast_c.operand.subquery, not ast_c.operand.negated, r)
                )
            elif isinstance(ast_c, A.InOp) and ast_c.subquery is not None:
                semi_specs.append(self._plan_in_subquery(ast_c, r))
            elif _contains_subquery(ast_c):
                rel, rewritten = self._plan_scalar_conjunct(ast_c, r)
                semi_specs.append(rel)
                post_join_filters.append(rewritten)
            else:
                where_conjs.extend(split_conjuncts(r.expr(ast_c)))

        where_conjs = join_conds + where_conjs
        where_conjs = [h for c in where_conjs for h in hoist_common_or_conjuncts(c)]
        where_conjs = [or_to_in(c) for c in where_conjs]

        # classify: single-relation -> pushdown; equi-join; residual
        by_alias = {rel.alias: rel for rel in relations}
        outer_right = {ra for _, ra, _ in outer_join_specs}

        # ---- predicate move-around (ob_transform_predicate_move_around):
        # x = y makes every single-column restriction on x equally true of
        # y, so the restriction CLONES onto y's relation and pre-filters
        # its scan — both scans shrink before the join instead of one
        where_conjs.extend(
            self._move_around_predicates(where_conjs, outer_right)
        )
        # a FULL join null-extends BOTH sides, so no WHERE conjunct may be
        # pushed below it — scans pre-filtered on the preserved side would
        # resurrect their partners as spurious unmatched rows
        has_full = any(kind == "full" for kind, _ra, _on in outer_join_specs)
        equi: list[tuple[E.ColRef, E.ColRef]] = []
        residual: list[E.Expr] = []
        post_outer: list[E.Expr] = []
        for c in where_conjs:
            tabs = _tables_of(c)
            ej = _is_equi_join(c)
            if (
                ej is not None
                and not has_full
                and not (
                    {ej[0].name.split(".")[0], ej[1].name.split(".")[0]}
                    & outer_right
                )
            ):
                equi.append(ej)
            elif (
                len(tabs) == 1
                and next(iter(tabs)) in by_alias
                and next(iter(tabs)) not in outer_right
                and not has_full
            ):
                rel = by_alias[next(iter(tabs))]
                self._push_filter(rel, c)
            elif (tabs & outer_right) or has_full:
                # references a null-extended side (or any side under a
                # FULL join): WHERE applies after the outer joins
                post_outer.append(c)
            else:
                residual.append(c)

        # ---- join order over inner relations; outer joins apply after --
        inner_rels = [rel for rel in relations if rel.alias not in outer_right]
        plan = self._order_joins(inner_rels, equi, residual)
        for kind, ra, on_ast in outer_join_specs:
            rel = by_alias[ra]
            on_conjs = split_conjuncts(r.expr(on_ast)) if on_ast is not None else []
            lkeys, rkeys, resid = [], [], []
            for c in on_conjs:
                ej = _is_equi_join(c)
                if ej is not None and (ra in (ej[0].name.split(".")[0], ej[1].name.split(".")[0])):
                    l_, r_ = ej
                    if l_.name.split(".")[0] == ra:
                        l_, r_ = r_, l_
                    lkeys.append(l_)
                    rkeys.append(r_)
                elif _tables_of(c) == {ra} and kind == "left":
                    # right-side-only ON condition filters the build input
                    # (LEFT join only: a FULL join must still emit right
                    # rows that fail the ON condition as unmatched)
                    self._push_filter(rel, c)
                else:
                    resid.append(c)
            plan = JoinOp(
                kind, plan, rel.plan, tuple(lkeys), tuple(rkeys),
                E.and_(*resid) if resid else None,
            )
        for c in post_outer:
            plan = Filter(plan, c)

        # ---- semi/anti/scalar joins on top of the join tree ------------
        for spec in semi_specs:
            kind, sub_plan, lkeys, rkeys, resid = spec
            plan = JoinOp(kind, plan, sub_plan, tuple(lkeys), tuple(rkeys), resid)
        for f in post_join_filters:
            plan = Filter(plan, f)

        # ---- GROUP BY / aggregates ------------------------------------
        alias_map: dict[str, E.Expr] = {}
        agg_out_sub: dict[E.Expr, E.Expr] = {}
        group_nodes = list(sel.group_by)
        has_agg_in_select = _select_has_agg(sel)
        agg_order_keys: list[tuple[E.Expr, bool]] | None = None
        scalar_join_after_agg: list[tuple] = []
        if group_nodes or has_agg_in_select or sel.having is not None:
            item_alias_ast = {
                it.alias: it.expr for it in sel.items if it.alias
            }
            key_exprs = []
            for i, g in enumerate(group_nodes):
                try:
                    ge = r.expr(g)
                except ResolveError:
                    # MySQL scoping: GROUP BY may name a select alias
                    if (isinstance(g, A.Name) and len(g.parts) == 1
                            and g.parts[0] in item_alias_ast):
                        ge = r.expr(item_alias_ast[g.parts[0]])
                        key_exprs.append((g.parts[0], ge))
                        continue
                    raise
                name = ge.name if isinstance(ge, E.ColRef) else f"$gkey{i}"
                key_exprs.append((name, ge))
            out_items = []
            for i, item in enumerate(sel.items):
                e = r.expr(item.expr, allow_agg=True)
                name = item.alias or _default_name(item.expr, i)
                out_items.append((name, e))
                alias_map[name] = e
            having_e = None
            if sel.having is not None:
                having_ast = sel.having
                if _contains_subquery(having_ast):
                    having_ast, scalar_join_after_agg = self._extract_having_subqueries(
                        having_ast, r
                    )
                having_e = r.expr(having_ast, allow_agg=True)
            agg_order_keys = []
            for oi in sel.order_by:
                if (
                    isinstance(oi.expr, A.Name)
                    and len(oi.expr.parts) == 1
                    and oi.expr.parts[0] in alias_map
                ):
                    agg_order_keys.append((E.ColRef(oi.expr.parts[0]), oi.descending))
                elif isinstance(oi.expr, A.NumberLit):
                    agg_order_keys.append(
                        (E.ColRef(out_items[int(oi.expr.value) - 1][0]), oi.descending)
                    )
                else:
                    oe = r.expr(oi.expr, allow_agg=True)
                    matched = [n for n, e2 in out_items if e2 == oe]
                    agg_order_keys.append(
                        (E.ColRef(matched[0]) if matched else oe, oi.descending)
                    )
            plan, agg_out_sub = self._build_aggregate(
                plan, key_exprs, r.agg_exprs,
                group_sets=getattr(sel, "group_sets", None),
            )
            out_items = [(n, _substitute(e, agg_out_sub)) for n, e in out_items]
            for kind, sub_plan, lkeys, rkeys, resid in scalar_join_after_agg:
                plan = JoinOp(kind, plan, sub_plan, tuple(lkeys), tuple(rkeys), resid)
            if having_e is not None:
                having_e = _substitute(having_e, agg_out_sub)
                plan = Filter(plan, having_e)
        else:
            out_items = []
            for i, item in enumerate(sel.items):
                if isinstance(item.expr, A.Star):
                    s = output_schema(plan)
                    for f in s.fields:
                        short = f.name.split(".", 1)[1] if "." in f.name else f.name
                        out_items.append((short, E.ColRef(f.name)))
                        alias_map[short] = E.ColRef(f.name)
                    continue
                e = r.expr(item.expr)
                name = item.alias or _default_name(item.expr, i)
                out_items.append((name, e))
                alias_map[name] = e

        # ---- ORDER BY (resolves select aliases, then input columns) ---
        if agg_order_keys is not None:
            order_keys = [
                (_substitute_out(e, out_items), d) for e, d in agg_order_keys
            ]
        else:
            order_keys = []
            for oi in sel.order_by:
                if (
                    isinstance(oi.expr, A.Name)
                    and len(oi.expr.parts) == 1
                    and oi.expr.parts[0] in alias_map
                ):
                    oe = E.ColRef(oi.expr.parts[0])
                elif isinstance(oi.expr, A.NumberLit):
                    oe = E.ColRef(out_items[int(oi.expr.value) - 1][0])
                else:
                    oe = r.expr(oi.expr)
                    matched = [n for n, e in out_items if e == oe]
                    oe = E.ColRef(matched[0]) if matched else oe
                order_keys.append((oe, oi.descending))

        # ---- window functions (after grouping/HAVING, before projection)
        if r.win_exprs:
            from ..expr.compile import infer_type
            from ..sql.logical import output_schema as _oschema

            specs = []
            for name, fn, arg, pk, ok, extra in r.win_exprs:
                if agg_out_sub:
                    arg = _substitute(arg, agg_out_sub) if arg is not None else None
                    pk = tuple(_substitute(p, agg_out_sub) for p in pk)
                    ok = tuple((_substitute(o, agg_out_sub), d) for o, d in ok)
                    if fn in ("lag", "lead") and extra is not None \
                            and extra[1] is not None:
                        extra = (extra[0], _substitute(extra[1], agg_out_sub))
                if (
                    isinstance(extra, tuple) and len(extra) == 3
                    and extra[0] == "range"
                    and (extra[1] not in (None, 0) or extra[2] not in (None, 0))
                ):
                    # value-offset RANGE frames run on the integer storage
                    # domain (ints, dates, scaled decimals); float keys
                    # would silently truncate
                    kt = infer_type(ok[0][0], _oschema(plan))
                    import numpy as _np

                    if not _np.issubdtype(kt.storage_np, _np.integer):
                        raise ResolveError(
                            "RANGE frame with a value offset requires an "
                            "integer-domain ORDER BY key (int/date/decimal)"
                        )
                specs.append((name, fn, arg, pk, ok, extra))
            plan = Window(plan, tuple(specs))

        visible = tuple(n for n, _ in out_items)
        fixed_order = []
        for i, (oe, d) in enumerate(order_keys):
            if isinstance(oe, E.ColRef) and any(n == oe.name for n, _ in out_items):
                fixed_order.append((oe, d))
            else:
                if sel.distinct:
                    raise ResolveError(
                        "ORDER BY expression must appear in the select list "
                        "of a SELECT DISTINCT"
                    )
                hidden = f"$ord{i}"
                out_items.append((hidden, oe))
                fixed_order.append((E.ColRef(hidden), d))
        order_keys = fixed_order

        plan = Project(plan, tuple(out_items))
        if sel.distinct and not self._distinct_redundant(plan):
            plan = Distinct(plan)
        if order_keys and sel.limit is not None:
            # ORDER BY + LIMIT fuse into top-n (ob_pd_topn_sort_filter
            # analog): only the surviving rows ever materialize
            plan = TopN(plan, tuple(order_keys), sel.limit, sel.offset or 0)
        elif order_keys:
            plan = Sort(plan, tuple(order_keys))
        elif sel.limit is not None:
            plan = Limit(plan, sel.limit, sel.offset or 0)

        return plan, r, out_items, visible

    # ------------------------------------------------- aggregate helper
    def _build_aggregate(self, plan, key_exprs, agg_exprs, group_sets=None):
        """Build the Aggregate node; expands DISTINCT aggregates into a
        pre-dedup (Distinct over keys+arg) + plain aggregate."""
        # group keys that are dictionary TRANSFORMS (substr / json_*)
        # cannot evaluate inside the aggregate (the engine's group-by
        # paths see plain columns): pre-project them below the Aggregate
        # into named dict columns (derive_dict_column) and group by those
        # select items referencing a transformed key must substitute by the
        # ORIGINAL expression, not the post-rewrite ColRef
        orig_key_exprs = list(key_exprs)
        from ..expr.compile import STRING_VIEW_FUNCS

        viewy = {
            n for n, e in key_exprs
            if isinstance(e, E.Func) and e.name in STRING_VIEW_FUNCS
        }
        if viewy:
            needed: set[str] = set()
            for _n, _fn, arg, _d in agg_exprs:
                if arg is not None:
                    needed |= set(E.referenced_columns(arg))
            for n, e in key_exprs:
                if n not in viewy:
                    needed |= set(E.referenced_columns(e))
            proj = [(n, e) for n, e in key_exprs if n in viewy]
            proj += [(c, E.ColRef(c)) for c in sorted(needed - viewy)]
            plan = Project(plan, tuple(proj))
            key_exprs = [
                (n, E.ColRef(n) if n in viewy else e) for n, e in key_exprs
            ]
        distinct_aggs = [a for a in agg_exprs if a[3]]
        if group_sets is not None:
            # ROLLUP/CUBE/GROUPING SETS: one EXPAND-style Aggregate
            # (executor replicates per set and NULL-masks missing keys)
            plan = Aggregate(plan, tuple(key_exprs), tuple(agg_exprs),
                             grouping_sets=tuple(group_sets))
            return plan, {e: E.ColRef(n) for n, e in key_exprs}
        if len(distinct_aggs) == 1 and len(agg_exprs) == 1 \
                and distinct_aggs[0][1] == "count":
            # lone COUNT(DISTINCT): pre-dedup (Distinct over keys+arg) +
            # plain count — two-phase, so under PX the dedup repartitions
            # before any aggregation state exists
            name, fn, arg, _ = distinct_aggs[0]
            proj = [(n, e) for n, e in key_exprs] + [("$darg", arg)]
            plan = Distinct(Project(plan, tuple(proj)))
            key_refs = [(n, E.ColRef(n)) for n, _ in key_exprs]
            plan = Aggregate(
                plan, tuple(key_refs),
                ((name, "count", E.ColRef("$darg"), False),),
            )
            sub = {e: E.ColRef(n) for n, e in orig_key_exprs}
            return plan, sub
        # mixed / multiple / non-count DISTINCT aggregates flow through:
        # the executor masks each distinct agg to first occurrences
        plan = Aggregate(plan, tuple(key_exprs), tuple(agg_exprs),
                         grouping_sets=group_sets)
        sub = {e: E.ColRef(n) for n, e in orig_key_exprs}
        return plan, sub

    # ------------------------------------------------- derived tables
    def _plan_derived(self, sub_sel: "A.Select | A.SetSelect", alias: str,
                      r: Resolver) -> Relation:
        if isinstance(sub_sel, A.SetSelect):
            pq = self._plan_setop(sub_sel, None)
            renamed = tuple(
                (f"{alias}.{n}", E.ColRef(n)) for n in pq.output_names
            )
            plan = Project(pq.plan, renamed)
            r.scopes.append((alias, output_schema(plan)))
            return Relation(alias, plan, False)
        sub_plan, _, out_items, visible = self._plan_block(sub_sel, None)
        # rename outputs into this block's namespace: alias.col
        renamed = tuple((f"{alias}.{n}", E.ColRef(n)) for n in visible)
        plan = Project(sub_plan, renamed)
        r.scopes.append((alias, output_schema(plan)))
        return Relation(alias, plan, False)

    # --------------------------------------------- predicate move-around
    @staticmethod
    def _move_around_predicates(where_conjs: list, outer_right: set) -> list:
        """Derive transferable restrictions across equi-join equivalence
        classes. Sound because an INNER equi-join result satisfies x = y
        with both non-NULL, so P(x) <=> P(y) on surviving rows; columns
        touching a null-extended side never participate."""
        eq_pairs = []
        for c in where_conjs:
            ej = _is_equi_join(c)
            if ej is None:
                continue
            if {ej[0].name.split(".")[0], ej[1].name.split(".")[0]} \
                    & outer_right:
                continue
            eq_pairs.append(ej)
        if not eq_pairs:
            return []
        parent: dict[str, str] = {}

        def find(x: str) -> str:
            while parent.get(x, x) != x:
                x = parent[x]
            return x

        for l_, r_ in eq_pairs:
            a, b = find(l_.name), find(r_.name)
            if a != b:
                parent[a] = b
        classes: dict[str, list[str]] = {}
        for n in sorted({n for p in eq_pairs for n in (p[0].name, p[1].name)}):
            classes.setdefault(find(n), []).append(n)
        seen = {repr(c) for c in where_conjs}
        derived = []
        for c in where_conjs:
            if _is_equi_join(c) is not None:
                continue
            refs = set(E.referenced_columns(c))
            if len(refs) != 1:
                continue
            (src,) = refs
            if src.split(".")[0] in outer_right:
                continue
            for other in classes.get(find(src), ()):
                if other == src or other.split(".")[0] in outer_right:
                    continue
                c2 = _substitute(c, {E.ColRef(src): E.ColRef(other)})
                if repr(c2) not in seen:
                    seen.add(repr(c2))
                    derived.append(c2)
        return derived

    # --------------------------------------------- join elimination
    @staticmethod
    def _node_col_refs(op) -> set:
        """Column names referenced by THIS node's expressions (children
        excluded)."""
        import dataclasses as _dc

        out: set = set()

        def grab(v):
            if isinstance(v, E.Expr):
                out.update(E.referenced_columns(v))
            elif isinstance(v, tuple):
                for x in v:
                    grab(x)

        for f in _dc.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, LogicalOp):
                continue
            grab(v)
        return out

    def _eliminate_left_joins(self, op, needed: frozenset = frozenset()):
        """ob_transform_join_elimination: a LEFT JOIN on a UNIQUE key of
        the right side whose columns nothing above consumes changes
        neither row count (unique key -> at most one match per left row;
        unmatched rows null-extend) nor any surviving column — drop it."""
        import dataclasses as _dc

        if isinstance(op, JoinOp) and op.kind == "left":
            rnames = set(output_schema(op.right).names())
            if not (rnames & needed) and isinstance(op.right, Scan):
                uk = self.unique_keys.get(op.right.table)
                rk = {
                    k.name for k in op.right_keys if isinstance(k, E.ColRef)
                }
                if uk and {f"{op.right.alias}.{c}" for c in uk} == rk \
                        and len(rk) == len(op.right_keys):
                    return self._eliminate_left_joins(op.left, needed)
        # whole-row operators consume every child column implicitly
        if isinstance(op, (Distinct, SetOp)):
            sub_needed = needed
            for f in _dc.fields(op):
                v = getattr(op, f.name)
                if isinstance(v, LogicalOp):
                    sub_needed = sub_needed | set(output_schema(v).names())
        else:
            sub_needed = needed | frozenset(self._node_col_refs(op))
        kw = {}
        for f in _dc.fields(op):
            v = getattr(op, f.name)
            if isinstance(v, LogicalOp):
                v2 = self._eliminate_left_joins(v, frozenset(sub_needed))
                if v2 is not v:
                    kw[f.name] = v2
        return _dc.replace(op, **kw) if kw else op

    # ------------------------------------------------- view merge
    def _view_mergeable(self, body) -> bool:
        """True when the view body is simple select-project-join over
        catalog base tables: bare-column outputs, optional WHERE without
        subqueries, inner joins only (ob_transform_view_merge scope)."""
        if not isinstance(body, A.Select):
            return False
        if (body.group_by or body.having is not None or body.distinct
                or body.order_by or body.limit is not None or body.offset
                or body.ctes or body.group_sets or not body.from_):
            return False
        if _select_has_agg(body):
            return False
        if not all(isinstance(it.expr, A.Name) for it in body.items):
            return False
        if body.where is not None and _contains_subquery(body.where):
            return False

        def leafs_ok(node) -> bool:
            if isinstance(node, A.TableRef):
                return node.name in self.catalog
            if isinstance(node, A.Join):
                return (node.kind in ("inner", "cross")
                        and leafs_ok(node.left) and leafs_ok(node.right))
            return False

        return all(leafs_ok(f) for f in body.from_)

    def _merge_view(self, body: A.Select, alias: str, r,
                    add_relation_from, merged_where_asts: list) -> None:
        """Inline a mergeable view body into the CURRENT block: base
        tables join the outer relation list under gensym'd aliases, the
        view's WHERE joins the outer conjunct pool, and the view alias
        becomes a resolver REDIRECT mapping its output columns onto the
        inlined tables."""
        # inner alias -> (renamed alias, table name)
        ren: dict[str, tuple[str, str]] = {}

        def collect(node):
            if isinstance(node, A.TableRef):
                ia = node.alias or node.name
                # '#' is outside the lexer's name charset: the internal
                # alias is UNTYPEABLE, so user text can never address the
                # merged-in tables directly (a view grant must not leak
                # base columns outside the view's select list)
                ren[ia] = (f"{alias}#{ia}", node.name)
            else:
                collect(node.left)
                collect(node.right)

        for f in body.from_:
            collect(f)

        def owner_of(col: str) -> str:
            hits = [
                ra for ia, (ra, tn) in ren.items()
                if any(f.name == col for f in self.catalog[tn].schema.fields)
            ]
            if len(hits) != 1:
                raise ResolveError(
                    f"column {col} is {'ambiguous' if hits else 'unknown'} "
                    f"inside view {alias}")
            return hits[0]

        def rn_expr(node):
            """Requalify every column reference onto the renamed aliases
            (one shared walker: ast.rewrite)."""

            def fn(n):
                if not isinstance(n, A.Name):
                    return None
                if n.parts == ("null",):
                    return n
                if len(n.parts) == 2 and n.parts[0] in ren:
                    return A.Name((ren[n.parts[0]][0], n.parts[1]))
                if len(n.parts) == 1:
                    return A.Name((owner_of(n.parts[0]), n.parts[0]))
                return n

            return A.rewrite(node, fn)

        def rn_from(node):
            if isinstance(node, A.TableRef):
                ia = node.alias or node.name
                return A.TableRef(node.name, ren[ia][0])
            return A.Join(
                node.kind, rn_from(node.left), rn_from(node.right),
                rn_expr(node.on) if node.on is not None else None,
            )

        for f in body.from_:
            add_relation_from(rn_from(f))
        if body.where is not None:
            merged_where_asts.append(rn_expr(body.where))
        colmap: dict[str, str] = {}
        for it in body.items:
            parts = it.expr.parts
            if len(parts) == 2:
                tgt = f"{ren[parts[0]][0]}.{parts[1]}"
            else:
                tgt = f"{owner_of(parts[0])}.{parts[0]}"
            colmap[it.alias or parts[-1]] = tgt
        r.redirects[alias] = colmap

    def _push_filter(self, rel: Relation, c: E.Expr) -> None:
        if rel.is_scan:
            s = rel.scan
            s.pushed_filter = c if s.pushed_filter is None else E.and_(s.pushed_filter, c)
        else:
            rel.plan = Filter(rel.plan, c)

    # --------------------------------------------- subquery unnesting
    def _assemble_sub_block(self, sub_sel, sub, relations, join_conds,
                            where_conjs, correlated, local_aliases):
        by_alias = {rel.alias: rel for rel in relations}
        equi, residual = [], []
        for c in join_conds + where_conjs:
            for h in hoist_common_or_conjuncts(c):
                tabs = _tables_of(h)
                ej = _is_equi_join(h)
                if ej is not None and tabs <= local_aliases:
                    equi.append(ej)
                elif len(tabs) == 1 and next(iter(tabs)) in by_alias:
                    self._push_filter(by_alias[next(iter(tabs))], h)
                elif tabs <= local_aliases:
                    residual.append(h)
                else:
                    correlated.append(h)
        plan = self._order_joins(relations, equi, residual)
        return plan, sub, correlated

    def _split_correlation(self, correlated, local_aliases):
        """Split correlated conjuncts into equi key pairs (outer_col,
        inner_col) and residual correlated conditions."""
        keys, resid = [], []
        for c in correlated:
            ej = None
            if isinstance(c, E.Compare) and c.op in ("=", "=="):
                if isinstance(c.left, E.ColRef) and isinstance(c.right, E.ColRef):
                    lt = c.left.name.split(".")[0]
                    rt = c.right.name.split(".")[0]
                    if lt in local_aliases and rt not in local_aliases:
                        ej = (c.right, c.left)  # (outer, inner)
                    elif rt in local_aliases and lt not in local_aliases:
                        ej = (c.left, c.right)
            if ej is not None:
                keys.append(ej)
            else:
                resid.append(c)
        return keys, resid

    def _plan_exists(self, sub_sel: A.Select, negated: bool, r: Resolver):
        """EXISTS/NOT EXISTS -> semi/anti join spec."""
        plan, sub, correlated = self._plan_sub_block_simple(sub_sel, r)
        local_aliases = {a for a, _ in sub.scopes}
        keys, resid = self._split_correlation(correlated, local_aliases)
        if not keys:
            raise ResolveError("EXISTS without equi correlation is unsupported")
        sid = f"$sub{next(_sub_counter)}"
        # project inner columns referenced by keys/residual under new names
        inner_cols: dict[str, str] = {}
        proj = []
        rkeys = []
        for i, (oc, ic) in enumerate(keys):
            nn = f"{sid}.k{i}"
            inner_cols[ic.name] = nn
            proj.append((nn, ic))
            rkeys.append(E.ColRef(nn))
        resid2 = []
        for c in resid:
            for col in E.referenced_columns(c):
                if col.split(".")[0] in local_aliases and col not in inner_cols:
                    nn = f"{sid}.r{len(inner_cols)}"
                    inner_cols[col] = nn
                    proj.append((nn, E.ColRef(col)))
            resid2.append(_rename_cols(c, inner_cols))
        sub_plan = Project(plan, tuple(proj))
        kind = "anti" if negated else "semi"
        lkeys = [oc for oc, _ in keys]
        return (kind, sub_plan, lkeys, rkeys, E.and_(*resid2) if resid2 else None)

    def _plan_in_subquery(self, node: A.InOp, r: Resolver):
        """expr IN (SELECT item FROM ...) -> semi/anti join on equality."""
        outer_e = r.expr(node.expr)
        plan, sub, correlated = self._plan_sub_block_simple(node.subquery, r)
        local_aliases = {a for a, _ in sub.scopes}
        keys, resid = self._split_correlation(correlated, local_aliases)
        if len(node.subquery.items) != 1:
            raise ResolveError("IN subquery must select exactly one column")
        # resolve the selected item in the sub scope (may itself be grouped)
        plan_out, item_ref = self._sub_output_expr(node.subquery, plan, sub)
        sid = f"$sub{next(_sub_counter)}"
        proj = [(f"{sid}.v", item_ref)]
        rkeys = [E.ColRef(f"{sid}.v")]
        lkeys = [outer_e]
        inner_cols = {}
        for i, (oc, ic) in enumerate(keys):
            nn = f"{sid}.k{i+1}"
            inner_cols[ic.name] = nn
            proj.append((nn, ic))
            rkeys.append(E.ColRef(nn))
            lkeys.append(oc)
        resid2 = [_rename_cols(c, inner_cols) for c in resid]
        sub_plan = Project(plan_out, tuple(proj))
        kind = "anti" if node.negated else "semi"
        return (kind, sub_plan, lkeys, rkeys, E.and_(*resid2) if resid2 else None)

    def _sub_output_expr(self, sub_sel: A.Select, plan, sub: Resolver):
        """Resolve the single select item of an IN subquery over its plan.
        Handles grouped subqueries (Q18: group by + having) by planning the
        aggregate inside."""
        item = sub_sel.items[0]
        if sub_sel.group_by or _select_has_agg(sub_sel) or sub_sel.having is not None:
            key_exprs = []
            for i, g in enumerate(sub_sel.group_by):
                ge = sub.expr(g)
                name = ge.name if isinstance(ge, E.ColRef) else f"$gkey{i}"
                key_exprs.append((name, ge))
            e = sub.expr(item.expr, allow_agg=True)
            having_e = (
                sub.expr(sub_sel.having, allow_agg=True)
                if sub_sel.having is not None
                else None
            )
            plan, agg_sub = self._build_aggregate(plan, key_exprs, sub.agg_exprs)
            e = _substitute(e, agg_sub)
            if having_e is not None:
                plan = Filter(plan, _substitute(having_e, agg_sub))
            return plan, e
        return plan, sub.expr(item.expr)

    def _plan_sub_block_simple(self, sub_sel: A.Select, r: Resolver):
        """Plan a correlated sub block's FROM+WHERE (no select processing).
        Nested subqueries inside its WHERE unnest recursively."""
        sub = Resolver({n: t for n, t in self.catalog.items()}, outer=r)
        relations: list[Relation] = []
        join_conds: list[E.Expr] = []

        def add_from(node):
            if isinstance(node, A.TableRef):
                alias = node.alias or node.name
                if node.name in self.ctes:
                    relations.append(self._plan_derived(self.ctes[node.name], alias, sub))
                else:
                    relations.append(Relation(alias, sub.add_table(node.name, alias), True))
            elif isinstance(node, A.Join) and node.kind in ("inner", "cross"):
                add_from(node.left)
                add_from(node.right)
                if node.on is not None:
                    join_conds.extend(split_conjuncts(sub.expr(node.on)))
            else:
                raise ResolveError("unsupported FROM in correlated subquery")

        for f in sub_sel.from_:
            add_from(f)
        local_aliases = {rel.alias for rel in relations}

        nested_specs = []
        nested_filters = []
        correlated: list[E.Expr] = []
        where_conjs: list[E.Expr] = []
        for ast_c in split_ast_conjuncts(sub_sel.where):
            if isinstance(ast_c, A.ExistsOp):
                nested_specs.append(self._plan_exists(ast_c.subquery, ast_c.negated, sub))
            elif isinstance(ast_c, A.InOp) and ast_c.subquery is not None:
                nested_specs.append(self._plan_in_subquery(ast_c, sub))
            elif _contains_subquery(ast_c):
                spec, rewritten = self._plan_scalar_conjunct(ast_c, sub)
                nested_specs.append(spec)
                nested_filters.append(rewritten)
            else:
                c = sub.expr(ast_c)
                if _tables_of(c) <= local_aliases:
                    where_conjs.append(c)
                else:
                    correlated.append(c)

        plan, sub, correlated2 = self._assemble_sub_block(
            sub_sel, sub, relations, join_conds, where_conjs, correlated, local_aliases
        )
        for spec in nested_specs:
            kind, sp, lk, rk, resid = spec
            plan = JoinOp(kind, plan, sp, tuple(lk), tuple(rk), resid)
        for f in nested_filters:
            plan = Filter(plan, f)
        return plan, sub, correlated2

    def _plan_scalar_conjunct(self, ast_c: A.Node, r: Resolver):
        """A WHERE conjunct containing a scalar subquery: plan the subquery
        as a joinable relation and rewrite the conjunct over its output.

        Returns (join spec, rewritten conjunct expr). Inner-join semantics:
        an empty subquery result yields NULL, which fails any comparison, so
        dropping unmatched outer rows is equivalent for comparison conjuncts.
        """
        subs: list[A.ScalarSubquery] = []

        def find(n):
            if isinstance(n, A.ScalarSubquery):
                subs.append(n)
                return
            for attr in getattr(n, "__dataclass_fields__", {}):
                v = getattr(n, attr)
                if isinstance(v, A.Node):
                    find(v)
                elif isinstance(v, tuple):
                    for x in v:
                        if isinstance(x, A.Node):
                            find(x)

        find(ast_c)
        if len(subs) != 1:
            raise ResolveError("exactly one scalar subquery per conjunct supported")
        sub_sel = subs[0].subquery
        spec, value_name = self._plan_scalar_subquery(sub_sel, r)

        # rewrite the AST conjunct replacing the subquery with a column ref
        def rewrite(n):
            if isinstance(n, A.ScalarSubquery):
                return A.Name((value_name.split(".")[0], value_name.split(".")[1]))
            if not isinstance(n, A.Node):
                return n
            kwargs = {}
            for attr in getattr(n, "__dataclass_fields__", {}):
                v = getattr(n, attr)
                if isinstance(v, A.Node):
                    kwargs[attr] = rewrite(v)
                elif isinstance(v, tuple):
                    kwargs[attr] = tuple(
                        rewrite(x) if isinstance(x, A.Node) else x for x in v
                    )
                else:
                    kwargs[attr] = v
            return type(n)(**kwargs)

        rewritten_ast = rewrite(ast_c)
        rewritten = r.expr(rewritten_ast)
        return spec, rewritten

    def _plan_scalar_subquery(self, sub_sel: A.Select, r: Resolver):
        """Scalar aggregate subquery -> join spec.

        Uncorrelated: 1-row scalar Aggregate broadcast-joined (no keys).
        Correlated (equi): Aggregate grouped by correlation keys, inner join.
        """
        plan, sub, correlated = self._plan_sub_block_simple(sub_sel, r)
        local_aliases = {a for a, _ in sub.scopes}
        keys, resid = self._split_correlation(correlated, local_aliases)
        if resid:
            raise ResolveError("non-equi correlation in scalar subquery")
        if len(sub_sel.items) != 1:
            raise ResolveError("scalar subquery must select one expression")
        if not _select_has_agg(sub_sel) or sub_sel.group_by:
            raise ResolveError("scalar subquery must be a single aggregate")
        sid = f"$sub{next(_sub_counter)}"
        value_expr = sub.expr(sub_sel.items[0].expr, allow_agg=True)
        if keys:
            key_exprs = [(f"{sid}.k{i}", ic) for i, (_, ic) in enumerate(keys)]
            plan = Aggregate(plan, tuple(key_exprs), tuple(sub.agg_exprs))
            proj = [(n, E.ColRef(n)) for n, _ in key_exprs]
            proj.append((f"{sid}.v", value_expr))
            plan = Project(plan, tuple(proj))
            lkeys = [oc for oc, _ in keys]
            rkeys = [E.ColRef(n) for n, _ in key_exprs]
            # the sub's output joins the outer block: make it resolvable
            r.scopes.append((sid, output_schema(plan)))
            return ("inner", plan, lkeys, rkeys, None), f"{sid}.v"
        plan = Aggregate(plan, (), tuple(sub.agg_exprs))
        plan = Project(plan, ((f"{sid}.v", value_expr),))
        r.scopes.append((sid, output_schema(plan)))
        # broadcast: no keys; executor routes through the 1-row build path
        return ("inner", plan, [], [], None), f"{sid}.v"

    def _extract_having_subqueries(self, having_ast: A.Node, r: Resolver):
        """HAVING with scalar subqueries: plan each as a broadcast join to
        apply above the Aggregate; returns (rewritten AST, join specs)."""
        specs = []

        def rewrite(n):
            if isinstance(n, A.ScalarSubquery):
                spec, value_name = self._plan_scalar_subquery(n.subquery, r)
                specs.append(spec)
                a, b = value_name.split(".")
                return A.Name((a, b))
            if not isinstance(n, A.Node):
                return n
            kwargs = {}
            for attr in getattr(n, "__dataclass_fields__", {}):
                v = getattr(n, attr)
                if isinstance(v, A.Node):
                    kwargs[attr] = rewrite(v)
                elif isinstance(v, tuple):
                    kwargs[attr] = tuple(
                        rewrite(x) if isinstance(x, A.Node) else x for x in v
                    )
                else:
                    kwargs[attr] = v
            return type(n)(**kwargs)

        return rewrite(having_ast), specs

    # -------------------------------------------------------- join order
    def _order_joins(
        self,
        relations: list[Relation],
        equi: list[tuple[E.ColRef, E.ColRef]],
        residual: list[E.Expr],
    ) -> LogicalOp:
        if not relations:
            # FROM-less SELECT: a one-row dual relation (MySQL's implicit
            # DUAL); the executor serves '$dual' without a catalog entry
            from ..core.dtypes import DataType, Field as F, Schema as S

            plan = Scan(
                "$dual", "$dual",
                S((F("$dual.$one", DataType.int8()),)),
            )
            for c in residual:
                plan = Filter(plan, c)
            return plan
        if len(relations) == 1:
            plan = relations[0].plan
            for c in residual:
                plan = Filter(plan, c)
            return plan
        remaining = {rel.alias: rel for rel in relations}
        sizes = {rel.alias: self._rel_rows(rel) for rel in relations}
        alias_table = {
            rel.alias: (rel.scan.table if rel.is_scan else None)
            for rel in relations
        }

        def key_ndv(ref: E.ColRef) -> float | None:
            alias, col = ref.name.split(".", 1)
            t = alias_table.get(alias)
            if t is None or self.stats is None:
                return None
            ts = self.stats.table_stats(t)
            if ts is not None:
                n = ts.ndv_of(col)
                if n:
                    return float(n)
            uk = self.unique_keys.get(t)
            if uk and tuple(uk) == (col,):
                return float(self.catalog[t].nrows or 1)
            return None

        def est_out(cur: float, alias: str, keys) -> float:
            """|R join S| ~= |R||S| / max(V(R,k), V(S,k)) — the NDV rule
            that keeps many-to-many keys (Q5's c_nationkey=s_nationkey,
            25 distinct values over millions of rows) from being picked
            just because S itself is small."""
            rows_a = sizes[alias]
            best_sel = None
            for l, r_ in keys:
                a_ref, j_ref = (
                    (l, r_) if l.name.split(".")[0] == alias else (r_, l)
                )
                va = key_ndv(a_ref)
                vj = key_ndv(j_ref)
                denom = max(
                    min(va if va is not None else rows_a, rows_a),
                    min(vj if vj is not None else cur, cur),
                    1.0,
                )
                sel = 1.0 / denom
                best_sel = sel if best_sel is None else min(best_sel, sel)
            return cur * rows_a * (best_sel if best_sel is not None else 1.0)

        start = max(sizes, key=lambda a: sizes[a])
        joined = {start}
        plan = remaining.pop(start).plan
        cur_rows = sizes[start]
        pending_equi = list(equi)
        while remaining:
            best = None
            best_rank = None
            for alias in sorted(remaining):
                keys = [
                    (l, r_)
                    for l, r_ in pending_equi
                    if (
                        l.name.split(".")[0] in joined
                        and r_.name.split(".")[0] == alias
                    )
                    or (
                        r_.name.split(".")[0] in joined
                        and l.name.split(".")[0] == alias
                    )
                ]
                if not keys:
                    continue
                rank = (est_out(cur_rows, alias, keys), sizes[alias])
                if best_rank is None or rank < best_rank:
                    best = (alias, keys)
                    best_rank = rank
            if best is None:
                alias = min(remaining, key=lambda a: sizes[a])
                cur_rows *= max(sizes[alias], 1.0)
                plan = JoinOp("cross", plan, remaining.pop(alias).plan)
                joined.add(alias)
                continue
            alias, keys = best
            cur_rows = max(best_rank[0], 1.0)
            lkeys, rkeys = [], []
            for l, r_ in keys:
                if l.name.split(".")[0] == alias:
                    l, r_ = r_, l
                lkeys.append(l)
                rkeys.append(r_)
                pending_equi.remove(
                    (l, r_) if (l, r_) in pending_equi else (r_, l)
                )
            plan = JoinOp(
                "inner",
                plan,
                remaining.pop(alias).plan,
                tuple(lkeys),
                tuple(rkeys),
            )
            joined.add(alias)
        plan = self._rotate_right_deep(plan)
        leftover = [E.Compare("=", l, r_) for l, r_ in pending_equi] + residual
        for c in leftover:
            plan = Filter(plan, c)
        return plan

    def _rotate_right_deep(self, op) -> LogicalOp:
        """Rotate J2(J1(A, B), C) into J1(A, J2'(B, C)) when J2's join
        condition only touches B — join associativity, applied whenever A
        is the bigger side. Keeps the large probe relation A as the single
        probe spine so every join above it stays layout-preserving and
        the engine's direct-address / clustered-FK paths apply (the
        reference reaches the same shapes through bushy-tree costing in
        sql/optimizer/ob_join_order.cpp; here the right-deep shape is the
        one whose joins all ride gathers instead of sorts)."""
        if not isinstance(op, JoinOp):
            if hasattr(op, "child"):
                return replace(op, child=self._rotate_right_deep(op.child))
            return op
        op = replace(
            op,
            left=self._rotate_right_deep(op.left),
            right=self._rotate_right_deep(op.right),
        )
        while True:
            j1 = op.left
            if not (
                op.kind in ("inner", "semi", "anti")
                and op.left_keys
                and isinstance(j1, JoinOp)
                and j1.kind == "inner"
                and j1.left_keys
            ):
                break
            a_names = set(output_schema(j1.left).names())
            b_names = set(output_schema(j1.right).names())
            refs: set[str] = set()
            for e in op.left_keys:
                refs |= set(E.referenced_columns(e))
            res_refs = (
                set(E.referenced_columns(op.residual))
                if op.residual is not None
                else set()
            )
            if not (refs <= b_names and not (res_refs & a_names)):
                break
            if self._est_op(j1.left) <= self._est_op(j1.right):
                break
            inner = JoinOp(
                op.kind, j1.right, op.right,
                op.left_keys, op.right_keys, op.residual,
            )
            op = replace(j1, right=self._rotate_right_deep(inner))
        return op


def _null_rejecting_cols(c: E.Expr) -> set[str]:
    """Columns a conjunct provably rejects NULLs on: comparisons,
    BETWEEN and IN yield NULL for NULL inputs (rows dropped by
    compile_predicate); IS NULL / OR / NOT are NOT null-rejecting."""
    if isinstance(c, E.Compare):
        out = set()
        for side in (c.left, c.right):
            if isinstance(side, E.ColRef):
                out.add(side.name)
        return out
    if isinstance(c, E.Between) and not c.negated:
        return {c.arg.name} if isinstance(c.arg, E.ColRef) else set()
    if isinstance(c, E.InList) and not c.negated:
        return {c.arg.name} if isinstance(c.arg, E.ColRef) else set()
    if isinstance(c, E.IsNull) and c.negated:  # IS NOT NULL
        return {c.arg.name} if isinstance(c.arg, E.ColRef) else set()
    return set()


def _rename_cols(e: E.Expr, mapping: dict[str, str]) -> E.Expr:
    sub = {E.ColRef(old): E.ColRef(new) for old, new in mapping.items()}
    return _substitute(e, sub)


def _select_has_agg(sel: A.Select) -> bool:
    def walk(n) -> bool:
        if isinstance(n, (A.ScalarSubquery, A.ExistsOp)):
            return False  # nested subqueries have their own scope
        if isinstance(n, A.InOp) and n.subquery is not None:
            return False
        if isinstance(n, A.FuncCall) and n.name in (
            "sum", "count", "min", "max", "avg", "approx_count_distinct",
        ):
            return True
        for attr in getattr(n, "__dataclass_fields__", {}):
            v = getattr(n, attr)
            if isinstance(v, A.Node) and walk(v):
                return True
            if isinstance(v, tuple):
                for x in v:
                    if isinstance(x, A.Node) and walk(x):
                        return True
                    if (
                        isinstance(x, tuple)
                        and any(isinstance(y, A.Node) and walk(y) for y in x)
                    ):
                        return True
        return False

    return any(walk(i.expr) for i in sel.items)


def _substitute_out(e: E.Expr, out_items: list[tuple[str, E.Expr]]) -> E.Expr:
    for n, oe in out_items:
        if e == oe:
            return E.ColRef(n)
    return e


def _default_name(node: A.Node, i: int) -> str:
    if isinstance(node, A.Name):
        return node.parts[-1]
    return f"$col{i}"


def _substitute(e: E.Expr, sub: dict[E.Expr, E.Expr]) -> E.Expr:
    if e in sub:
        return sub[e]
    if isinstance(e, E.BinaryOp):
        return E.BinaryOp(e.op, _substitute(e.left, sub), _substitute(e.right, sub))
    if isinstance(e, E.Compare):
        return E.Compare(e.op, _substitute(e.left, sub), _substitute(e.right, sub))
    if isinstance(e, E.BoolOp):
        return E.BoolOp(e.op, tuple(_substitute(a, sub) for a in e.args))
    if isinstance(e, E.Not):
        return E.Not(_substitute(e.arg, sub))
    if isinstance(e, E.Cast):
        return E.Cast(_substitute(e.arg, sub), e.dtype)
    if isinstance(e, E.Case):
        return E.Case(
            tuple((_substitute(c, sub), _substitute(v, sub)) for c, v in e.whens),
            _substitute(e.default, sub) if e.default is not None else None,
        )
    if isinstance(e, E.Func):
        return E.Func(e.name, tuple(_substitute(a, sub) for a in e.args))
    if isinstance(e, E.Between):
        return E.Between(
            _substitute(e.arg, sub),
            _substitute(e.low, sub),
            _substitute(e.high, sub),
            e.negated,
        )
    if isinstance(e, E.InList):
        return E.InList(_substitute(e.arg, sub), e.values, e.negated)
    if isinstance(e, E.IsNull):
        return E.IsNull(_substitute(e.arg, sub), e.negated)
    return e
