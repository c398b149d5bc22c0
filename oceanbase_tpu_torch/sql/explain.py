"""EXPLAIN: render the planned (and physically-routed) operator tree.

Reference surface: the plan printer (sql/printer, EXPLAIN [FORMAT=...])
— the operator tree with estimated rows and physical choices. Here the
annotations surface THIS engine's physical decisions: which join rides
direct-address/merge/expand, which scan swapped onto a sorted projection
(and its slice capacity), which aggregate collapsed into clustered-FK
segment reductions, which TopN serves from the IVF index. EXPLAIN never
compiles: everything shown is host-side planning state."""

from __future__ import annotations

from .logical import (
    Aggregate,
    Distinct,
    Filter,
    JoinOp,
    Limit,
    Project,
    Scan,
    SetOp,
    Sort,
    TopN,
    Window,
)


def explain_plan(executor, plan, params) -> list[str]:
    """Lines of an EXPLAIN rendering for a routed plan + seeded params."""
    from ..engine.executor import _number_nodes

    nodes = _number_nodes(plan)
    nid_of = {id(op): nid for nid, op in nodes.items()}
    lines: list[str] = []

    def est(op) -> str:
        try:
            return f"~{int(executor._est_rows(op))} rows"
        except Exception:
            return ""

    def join_route(op: JoinOp) -> str:
        if op.kind in ("semi", "anti"):
            if len(op.left_keys) == 1 and executor._affine_build_info(
                op
            ) is not None:
                return "direct-address probe"
            return "sorted-build range probe"
        if not executor._merge_joinable(op):
            return "expand (M:N sort + binary search)"
        if op.left_keys and executor._affine_build_info(op) is not None:
            return "direct-address (affine build key)"
        return "merge (combined sort, unique build)"

    def rec(op, depth):
        pad = "  " * depth
        nid = nid_of.get(id(op))
        if isinstance(op, Scan):
            extra = ""
            if "#sp:" in op.table:
                cap = params.scan_cap.get(nid)
                extra = " [sorted projection"
                extra += f", sliced cap={cap}]" if cap else "]"
            flt = f" filter={op.pushed_filter}" if op.pushed_filter else ""
            lines.append(
                f"{pad}SCAN {op.table} as {op.alias}{extra}{flt} {est(op)}"
            )
            return
        if isinstance(op, JoinOp):
            lines.append(
                f"{pad}JOIN {op.kind} [{join_route(op)}] "
                f"on {list(map(str, op.left_keys))} = "
                f"{list(map(str, op.right_keys))} {est(op)}"
            )
        elif isinstance(op, Aggregate):
            spec = params.clustered_aggs.get(nid)
            mode = (
                f"clustered-FK segment reduction over "
                f"{spec.probe_table}.{spec.fk_col} -> "
                f"{spec.build_table}.{spec.pk_col}"
                if spec is not None else
                "grouping sets expand" if op.grouping_sets is not None
                else "sort/direct group-by"
            )
            keys = [n for n, _ in op.group_keys]
            lines.append(
                f"{pad}AGGREGATE [{mode}] keys={keys} "
                f"aggs={[f'{f}({n})' for n, f, _a, _d in op.aggs]} {est(op)}"
            )
        elif isinstance(op, TopN):
            vspec = params.vector_topns.get(nid)
            if vspec is not None:
                mode = (
                    f"ANN IVF probe (nprobe={vspec.nprobe}, "
                    f"max_list={vspec.max_list}")
                if vspec.filters or getattr(vspec, "est_sel", 1.0) < 1.0:
                    nf = len(vspec.filters) + (
                        1 if getattr(vspec.scan, "pushed_filter", None)
                        is not None else 0)
                    mode += (f", filtered sel~{vspec.est_sel:.3g}"
                             f" fused={nf}")
                if vspec.nprobe > vspec.base_nprobe > 0:
                    mode += f", over-probe from {vspec.base_nprobe}"
                mode += (f") route: ivf={vspec.ivf_cost:.3g} < "
                         f"brute={vspec.brute_cost:.3g}"
                         f" [{vspec.cost_basis}]")
            else:
                mode = "top-n sort"
            lines.append(f"{pad}TOPN [{mode}] n={op.n} {est(op)}")
        elif isinstance(op, Filter):
            lines.append(f"{pad}FILTER {op.pred}")
        elif isinstance(op, Project):
            lines.append(
                f"{pad}PROJECT {[n for n, _ in op.exprs]}"
            )
        elif isinstance(op, Sort):
            lines.append(f"{pad}SORT {[str(e) for e, _ in op.keys]}")
        elif isinstance(op, Limit):
            lines.append(f"{pad}LIMIT {op.n} offset={op.offset}")
        elif isinstance(op, Distinct):
            lines.append(f"{pad}DISTINCT")
        elif isinstance(op, SetOp):
            lines.append(
                f"{pad}{op.kind.upper()}{' ALL' if op.all else ''}"
            )
        elif isinstance(op, Window):
            lines.append(
                f"{pad}WINDOW {[n for n, *_ in op.funcs]}"
            )
        else:
            lines.append(f"{pad}{type(op).__name__}")
        for attr in ("child", "left", "right"):
            c = getattr(op, attr, None)
            if c is not None:
                rec(c, depth + 1)

    rec(plan, 0)
    return lines


def annotate_plan_lines(lines, op_profile, miss_mark: float = 8.0
                        ) -> list[str]:
    """EXPLAIN ANALYZE: fold a profiled run's per-operator measurements
    (engine/plan_profile.py, via Session.last_op_profile) into the plan
    rendering. explain_plan emits exactly one line per operator in the
    SAME pre-order _number_nodes assigns, so line i annotates node i:
    est vs actual rows, the misestimation factor (`>>` marker at >=
    miss_mark x) and the operator's fenced device time."""
    from ..engine.plan_profile import miss_factor

    samples = {s.node_id: s for s in op_profile.get("samples", ())}
    est = op_profile.get("estimates", {})
    absorbed = op_profile.get("absorbed", {}) or {}
    out = []
    for i, ln in enumerate(lines):
        s = samples.get(i)
        if s is None:
            if i in absorbed:
                # never emitted standalone: its work is measured inside
                # the absorbing parent's stage
                out.append(f"{ln} (absorbed into node {absorbed[i]})")
            else:
                out.append(ln)
            continue
        e = int(est.get(i, 0))
        mf = miss_factor(e, s.rows)
        mark = ">> " if mf >= miss_mark else ""
        out.append(
            f"{mark}{ln} (est_rows={e} actual_rows={s.rows} "
            f"miss={mf:.1f}x device={int(s.device_us)}us)"
        )
    return out
