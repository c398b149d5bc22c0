"""Physical execution of a logical plan on one torch device.

Counterpart of `oceanbase_tpu/engine/executor.py`, restricted to the plan
nodes of the port's first slice: Scan (with its pushed filter), Filter,
Project, Aggregate (the direct-addressed and the scalar paths), Sort and
Limit, plus the root compaction. Every other node or path raises
NotImplementedError naming it (joins, sort and hash group-bys, windows,
set operations, top-n, clustered aggregation, ANN, chunked streaming).

The JAX package traces a whole plan into one jitted program; here
`compile` returns a plain Python closure that runs the same emission
eagerly on the session's device, with the device functions the slice
cannot run without on hand-written kernels (K1-K4, `kernels.py`). The
static-capacity contract is unchanged: every intermediate keeps its
producer's capacity under a live-row `sel` mask, capacity-bound operators
report overflow counters in ONE stacked vector, and the host reads it
once per attempt and re-runs at larger capacities (PhysicalParams.bump).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .. import device as _device
from ..core.column import (
    ColumnBatch,
    batch_rows_storage,
    host_rows,
    to_numpy,
    torch_dtype,
    upload,
)
from ..core.dtypes import DataType, Field, Schema, TypeKind
from ..expr import ir as E
from ..expr.compile import (
    compile_predicate,
    derive_dict_column,
    evaluate,
    infer_type,
)
from ..ops.gather import gather_rows
from ..ops.hashagg import groupby_direct, scalar_aggregate
from ..ops.hashing import next_pow2, pack_keys
from ..ops.sort import sort_indices
from ..sql.logical import (
    Aggregate,
    Distinct,
    Filter,
    JoinOp,
    Limit,
    LogicalOp,
    Project,
    Scan,
    SetOp,
    Sort,
    TopN,
    Window,
)

# largest packed key domain served by the direct group-by (kernel K2)
DIRECT_GROUPBY_MAX_DOMAIN = 1 << 6

# synthetic PhysicalParams id for the root result-compaction capacity
ROOT_COMPACT = -1


def gather_payload(cols: dict, valid: dict, idx, sel=None):
    """Gather a whole batch payload (values, validity, optionally sel) by
    one index array, in one multi-column gather (K4)."""
    payload = {("c", n): c for n, c in cols.items()}
    payload.update({("v", n): v for n, v in valid.items()})
    if sel is not None:
        payload[("s", "")] = sel
    out = gather_rows(payload, idx)
    cols2 = {n: out[("c", n)] for n in cols}
    valid2 = {n: out[("v", n)] for n in valid}
    return cols2, valid2, out.get(("s", ""))


def compact_batch(b: ColumnBatch, cap2: int):
    """Compact live rows to a smaller capacity, preserving their relative
    order: a stable sort on deadness (K3, one 1-bit key) and a gather of
    the first cap2 rows (K4). Returns (batch, overflow count)."""
    dev = b.device
    if b.capacity <= cap2:
        return b, torch.zeros((), dtype=torch.int64, device=dev)
    take = sort_indices([], [], b.sel)[:cap2]
    nlive = torch.sum(b.sel, dtype=torch.int64)
    sel = torch.arange(cap2, dtype=torch.int64, device=dev) < nlive
    cols, valid, _ = gather_payload(b.cols, b.valid, take)
    out = ColumnBatch(
        cols=cols,
        valid=valid,
        sel=sel,
        nrows=torch.clamp(nlive, max=cap2),
        schema=b.schema,
        dicts=b.dicts,
    )
    return out, torch.clamp(nlive - cap2, min=0)


@dataclass
class PhysicalParams:
    """Static capacities per plan node (keyed by pre-order node index).
    The slice's plans carry one: the root compaction (ROOT_COMPACT)."""

    join_cap: dict[int, int] = field(default_factory=dict)

    def bump(self, overflows: dict[int, int]):
        for nid in overflows:
            if nid in self.join_cap:
                self.join_cap[nid] *= 4


def _number_nodes(plan: LogicalOp) -> dict[int, LogicalOp]:
    out = {}

    def rec(op):
        out[len(out)] = op
        for c in _children(op):
            rec(c)

    rec(plan)
    return out


def _children(op: LogicalOp):
    if isinstance(op, (Filter, Project, Sort, Limit, Distinct, Aggregate,
                       Window, TopN)):
        return [op.child]
    if isinstance(op, (JoinOp, SetOp)):
        return [op.left, op.right]
    return []


def _dict_domain(batch: ColumnBatch, e: E.Expr) -> int | None:
    """Static domain size of a group key expr (dict columns, bools)."""
    if isinstance(e, E.ColRef):
        d = batch.dicts.get(e.name)
        if d is not None:
            return len(d)
        t = batch.schema[e.name]
        if t.kind is TypeKind.BOOL:
            return 2
        if t.kind is TypeKind.INT8:
            return 256
    return None


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the torch engine yet")


class Executor:
    def __init__(self, catalog, default_rows_estimate=1 << 16, stats=None,
                 device=None):
        self.catalog = catalog
        self.default_rows_estimate = default_rows_estimate
        self.stats = stats
        self.device = _device(device)
        # per-column device cache: (table, column) -> (values, validity),
        # plus (table, "#sel"); and the assembled batch per column set
        self._batch_cache: dict = {}
        self._assembled: dict[tuple, ColumnBatch] = {}

    # ---- input preparation -------------------------------------------
    def _collect_scans(self, plan: LogicalOp) -> list[Scan]:
        out = []

        def rec(op):
            if isinstance(op, Scan):
                out.append(op)
            for c in _children(op):
                rec(c)

        rec(plan)
        return out

    def _needed_columns(self, plan: LogicalOp) -> dict[str, set[str]]:
        """alias -> set of unqualified column names referenced anywhere."""
        needed: dict[str, set[str]] = {}

        def note(e: E.Expr):
            for q in E.referenced_columns(e):
                if "." in q:
                    a, c = q.split(".", 1)
                    needed.setdefault(a, set()).add(c)

        def rec(op):
            if isinstance(op, Scan) and op.pushed_filter is not None:
                note(op.pushed_filter)
            if isinstance(op, Filter):
                note(op.pred)
            if isinstance(op, Project):
                for _, e in op.exprs:
                    note(e)
            if isinstance(op, Aggregate):
                for _, e in op.group_keys:
                    note(e)
                for _, _, a, _ in op.aggs:
                    if a is not None:
                        note(a)
            if isinstance(op, (Sort, TopN)):
                for e, _ in op.keys:
                    note(e)
            for c in _children(op):
                rec(c)

        rec(plan)
        return needed

    def input_batch(self, alias: str, table: str, cols: tuple):
        return self.table_batch(table, cols)

    def table_batch(self, name: str, cols: tuple[str, ...]) -> ColumnBatch:
        """Device batch of a table's columns. The device cache is PER
        COLUMN: statements with overlapping needs share one upload."""
        dev = self.device
        if name == "$dual":  # FROM-less SELECT: one anonymous row
            return ColumnBatch(
                cols={"$one": torch.zeros(1, dtype=torch.int8, device=dev)},
                valid={},
                sel=torch.ones(1, dtype=torch.bool, device=dev),
                nrows=torch.ones((), dtype=torch.int64, device=dev),
                schema=Schema((Field("$one", DataType.int8()),)),
                dicts={},
            )
        memo = self._assembled.get((name, cols))
        if memo is not None:
            return memo
        t = self.catalog[name]
        sub_schema = Schema(
            tuple(f for f in t.schema.fields if f.name in cols)
        )
        n = t.nrows
        cap = max(1024, -(-max(n, 1) // 1024) * 1024)
        dcols: dict[str, torch.Tensor] = {}
        dvalid: dict[str, torch.Tensor] = {}
        for f in sub_schema.fields:
            key = (name, f.name)
            hit = self._batch_cache.get(key)
            if hit is None:
                a = np.asarray(t.data[f.name], dtype=f.dtype.storage_np)
                dev_col = upload(a, cap, dev)
                vdev = None
                if f.dtype.nullable:
                    v = (
                        np.asarray(t.valid[f.name], dtype=np.bool_)
                        if f.name in t.valid
                        else np.ones(n, dtype=np.bool_)
                    )
                    vdev = upload(v, cap, dev, fill=False)
                hit = (dev_col, vdev)
                self._batch_cache[key] = hit
            dcols[f.name] = hit[0]
            if hit[1] is not None:
                dvalid[f.name] = hit[1]
        skey = (name, "#sel")
        sel = self._batch_cache.get(skey)
        if sel is None:
            sel = upload(np.ones(n, dtype=np.bool_), cap, dev, fill=False)
            self._batch_cache[skey] = sel
        batch = ColumnBatch(
            cols=dcols,
            valid=dvalid,
            sel=sel,
            nrows=torch.tensor(n, dtype=torch.int64, device=dev),
            schema=sub_schema,
            dicts={c: d for c, d in t.dicts.items() if c in cols},
        )
        self._assembled[(name, cols)] = batch
        return batch

    # ---- physical parameter seeding ----------------------------------
    def _est_rows(self, op) -> float:
        """Cardinality estimate driving static capacities."""
        est_rows = self._est_rows
        if isinstance(op, Scan):
            if op.table == "$dual":
                return 1.0
            t = self.catalog[op.table]
            base = t.nrows or 1
            if op.pushed_filter is not None:
                ts = self.stats.table_stats(op.table) if self.stats else None
                if ts is not None and ts.nrows > 0:
                    base *= ts.selectivity(op.pushed_filter, t)
                else:
                    base *= 0.25 ** min(
                        len(self._conjuncts(op.pushed_filter)), 3
                    )
            return max(base, 1.0)
        if isinstance(op, Filter):
            return max(est_rows(op.child) * 0.5, 1.0)
        if isinstance(op, Aggregate):
            child = est_rows(op.child)
            nd = self._group_ndv(op)
            if nd is not None:
                return max(min(child, nd), 1.0)
            return min(child, float(self.default_rows_estimate))
        if isinstance(op, (Project, Sort, Distinct, Window)):
            return est_rows(op.child)
        if isinstance(op, (Limit, TopN)):
            return float(op.n + op.offset)
        return float(self.default_rows_estimate)

    @staticmethod
    def _conjuncts(e):
        from ..sql.planner import split_conjuncts

        return split_conjuncts(e)

    def _group_ndv(self, op: Aggregate) -> float | None:
        """Product of group-key NDVs (grouping cardinality upper bound)."""
        if self.stats is None or not op.group_keys:
            return None
        prod = 1.0
        amap = {s.alias: s.table for s in self._collect_scans(op.child)}
        for _name, e in op.group_keys:
            if not isinstance(e, E.ColRef) or "." not in e.name:
                return None
            a, c = e.name.split(".", 1)
            tname = amap.get(a)
            if tname is None:
                return None
            ts = self.stats.table_stats(tname)
            nd = ts.ndv_of(c) if ts is not None else None
            if nd is None or nd <= 0:
                return None
            prod *= nd
        return prod

    def seed_params(self, plan: LogicalOp) -> PhysicalParams:
        params = PhysicalParams()
        # root compaction capacity: results travel device->host compacted
        # to the estimated output size; overflow retries apply
        params.join_cap[ROOT_COMPACT] = next_pow2(
            int(2 * self._est_rows(plan)) + 1024
        )
        return params

    # ---- program construction -----------------------------------------
    def compile(self, plan: LogicalOp, params: PhysicalParams):
        """The plan as a Python closure run(inputs, qparams) -> (out batch,
        stacked overflow vector), plus its input spec and the node ids of
        the overflow vector's entries."""
        nodes = _number_nodes(plan)
        id_of = {id(op): nid for nid, op in nodes.items()}
        needed = self._needed_columns(plan)
        scans = self._collect_scans(plan)
        input_spec = []
        for s in scans:
            cols = needed.get(s.alias, set())
            if not cols:
                cols = (
                    {"$one"} if s.table == "$dual"
                    else {self.catalog[s.table].schema.fields[0].name}
                )
            input_spec.append((s.alias, s.table, tuple(sorted(cols))))

        overflow_nodes: list[int] = sorted(params.join_cap)

        def emit(op, inputs):
            return self._emit_node(op, inputs, emit, params, id_of)

        dev = self.device

        def run(inputs: dict[str, ColumnBatch], qparams=()):
            from ..expr import compile as expr_compile

            prev = expr_compile.set_params(qparams if len(qparams) else None)
            try:
                out, ovf = emit(plan, inputs)
            finally:
                expr_compile.set_params(prev)
            out, oc = compact_batch(out, params.join_cap[ROOT_COMPACT])
            ovf = dict(ovf)
            ovf[ROOT_COMPACT] = oc
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            # ONE stacked vector: the host reads every counter in one copy
            ovf_vec = torch.stack([
                ovf.get(nid, zero).to(torch.int64) for nid in overflow_nodes
            ]) if overflow_nodes else torch.zeros(0, dtype=torch.int64,
                                                  device=dev)
            return out, ovf_vec

        return run, input_spec, overflow_nodes

    def _emit_node(self, op, inputs, emit, params, id_of):
        if isinstance(op, Scan):
            b = inputs[op.alias]
            qschema = Schema(
                tuple(
                    Field(f"{op.alias}.{f.name}", f.dtype)
                    for f in b.schema.fields
                )
            )
            qb = ColumnBatch(
                cols={f"{op.alias}.{n}": c for n, c in b.cols.items()},
                valid={f"{op.alias}.{n}": v for n, v in b.valid.items()},
                sel=b.sel,
                nrows=b.nrows,
                schema=qschema,
                dicts={f"{op.alias}.{n}": d for n, d in b.dicts.items()},
            )
            if op.pushed_filter is not None:
                qb = qb.with_sel(compile_predicate(op.pushed_filter, qb))
            return qb, {}

        if isinstance(op, Filter):
            child, ovf = emit(op.child, inputs)
            return child.with_sel(compile_predicate(op.pred, child)), ovf

        if isinstance(op, Project):
            child, ovf = emit(op.child, inputs)
            return self._project_batch(op, child), ovf

        if isinstance(op, Aggregate):
            return self._emit_aggregate(op, inputs, emit)

        if isinstance(op, Sort):
            child, ovf = emit(op.child, inputs)
            keys, desc = [], []
            for e, d in op.keys:
                v, _ = evaluate(e, child)
                if v.dim() == 0:
                    v = v.expand(child.capacity)
                keys.append(v.contiguous())
                desc.append(d)
            order = sort_indices(keys, desc, child.sel)
            cols, valid, ssel = gather_payload(
                child.cols, child.valid, order, child.sel
            )
            return replace(child, cols=cols, valid=valid, sel=ssel), ovf

        if isinstance(op, Limit):
            child, ovf = emit(op.child, inputs)
            pos = torch.cumsum(child.sel.to(torch.int64), 0) - 1
            keep = (
                child.sel
                & (pos >= op.offset)
                & (pos < op.offset + op.n)
            )
            return child.with_sel(keep), ovf

        raise _not_ported(f"plan node {type(op).__name__}")

    def _project_batch(self, op: Project, child: ColumnBatch) -> ColumnBatch:
        cols, valid, dicts, fields = {}, {}, {}, []
        for name, e in op.exprs:
            derived = derive_dict_column(e, child)
            if derived is not None:
                # string transform (substr): new dict column
                v, vv, d2 = derived
                dicts[name] = d2
            else:
                v, vv = evaluate(e, child)
            if v.dim() == 0:
                # all-literal expression: broadcast the scalar to the batch
                v = v.expand(child.capacity).contiguous()
            cols[name] = v
            if vv is not None:
                valid[name] = vv
            t = infer_type(e, child.schema)
            fields.append(Field(name, t))
            if isinstance(e, E.ColRef) and e.name in child.dicts:
                dicts[name] = child.dicts[e.name]
        return ColumnBatch(
            cols=cols,
            valid=valid,
            sel=child.sel,
            nrows=child.nrows,
            schema=Schema(tuple(fields)),
            dicts=dicts,
        )

    def _emit_aggregate(self, op: Aggregate, inputs, emit):
        if op.grouping_sets is not None:
            raise _not_ported("grouping sets")
        if any(fn == "approx_ndv" for _n, fn, _a, _d in op.aggs):
            raise _not_ported("approx_ndv")
        child, ovf = emit(op.child, inputs)
        dev = child.device
        key_vals, key_valids, domains = [], [], []
        for _, e in op.group_keys:
            v, vv = evaluate(e, child)
            if vv is None and isinstance(e, E.ColRef):
                vv = child.valid.get(e.name)
            if vv is not None:
                # SQL: NULLs form ONE group keyed on (value, validity)
                v = torch.where(vv, v, torch.zeros_like(v))
            key_vals.append(v)
            key_valids.append(vv)
            domains.append(_dict_domain(child, e))
        n_nullable = sum(1 for vv in key_valids if vv is not None)

        # per-aggregate (op, values, effective row mask): NULL inputs skip
        # via the argument's validity mask; count(*) counts live rows
        agg_ops, agg_vals, agg_masks = [], [], []
        for name, fn, arg, distinct in op.aggs:
            if arg is None:
                agg_ops.append("count")
                agg_vals.append(None)
                agg_masks.append(child.sel)
            else:
                if distinct and fn in ("count", "sum", "avg"):
                    raise _not_ported("DISTINCT aggregates")
                v, vv = evaluate(arg, child)
                if v.dim() == 0:
                    v = v.expand(child.capacity)
                am = child.sel if vv is None else child.sel & vv
                agg_ops.append(fn)
                agg_vals.append(None if fn == "count" else v.contiguous())
                agg_masks.append(am.contiguous())

        out_schema = _agg_schema(op, child.schema)
        out_valid = {}
        if (
            op.group_keys
            and all(d is not None for d in domains)
            and int(np.prod([d for d in domains])) * (2 ** n_nullable)
            <= DIRECT_GROUPBY_MAX_DOMAIN
        ):
            # direct path: every (slot, aggregate) reduction, plus the
            # live-row count per slot, in one pass of kernel K2; nullable
            # keys contribute a domain-2 validity plane
            pk_vals, pk_doms = list(key_vals), list(domains)
            for vv in key_valids:
                if vv is not None:
                    pk_vals.append(vv.to(torch.int64))
                    pk_doms.append(2)
            packed, domain = pack_keys(pk_vals, pk_doms)
            slot_used, res = groupby_direct(
                packed.contiguous(), domain, child.sel, agg_ops, agg_vals,
                agg_masks)
            bits = [max(1, int(d - 1).bit_length()) for d in pk_doms]
            slots = torch.arange(domain, dtype=torch.int64, device=dev)
            cols = {}
            shift = 0
            for (name, e), b in zip(op.group_keys, bits):
                t = infer_type(e, child.schema)
                cols[name] = ((slots >> shift) & ((1 << b) - 1)).to(
                    torch_dtype(t.storage_np)
                )
                shift += b
            for (name, _e), vv in zip(op.group_keys, key_valids):
                if vv is not None:
                    # each validity plane is exactly one bit, in key order
                    out_valid[name] = ((slots >> shift) & 1) == 1
                    shift += 1
            for (name, _, _, _), r in zip(op.aggs, res):
                cols[name] = r
            sel = slot_used
        elif op.group_keys:
            raise _not_ported(
                "sort-based group-by (key domain beyond the direct path)")
        else:
            # scalar aggregate: single-row output, per-agg masks; SQL:
            # sum/min/max over ZERO rows is NULL (count is 0)
            cols = {}
            for (name, _, _, _), aop, av, am in zip(
                op.aggs, agg_ops, agg_vals, agg_masks
            ):
                (v,) = scalar_aggregate(am, [aop], [av])
                cols[name] = v[None]
                if aop != "count":
                    out_valid[name] = torch.any(am)[None]
            sel = torch.ones(1, dtype=torch.bool, device=dev)

        dicts = {}
        for name, e in op.group_keys:
            if isinstance(e, E.ColRef) and e.name in child.dicts:
                dicts[name] = child.dicts[e.name]
        out = ColumnBatch(
            cols=cols,
            valid=out_valid,
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=out_schema,
            dicts=dicts,
        )
        return out, ovf

    # ---- execution ------------------------------------------------------
    def prepare(self, plan: LogicalOp):
        """Build the plan's program once; the PreparedPlan is what the
        plan cache stores."""
        params = self.seed_params(plan)
        run, input_spec, overflow_nodes = self.compile(plan, params)
        return PreparedPlan(self, plan, params, run, input_spec,
                            overflow_nodes)

    def execute(self, plan: LogicalOp, max_retries: int = 3):
        return self.prepare(plan).run(max_retries)


class PreparedPlan:
    """A built plan: its program closure + static capacities. Re-runnable;
    re-builds at larger capacities on overflow."""

    def __init__(self, executor, plan, params, program, input_spec,
                 overflow_nodes):
        self.executor = executor
        self.plan = plan
        self.params = params
        self.program = program
        self.input_spec = input_spec
        self.overflow_nodes = overflow_nodes
        self.retries = 0  # lifetime overflow-recompile count

    def recompile(self) -> None:
        self.program, self.input_spec, self.overflow_nodes = (
            self.executor.compile(self.plan, self.params)
        )

    def _inputs(self):
        return {
            alias: self.executor.input_batch(alias, table, cols)
            for alias, table, cols in self.input_spec
        }

    def call(self, qparams):
        return self.program(self._inputs(), qparams)

    def _overflows(self, hovf) -> dict:
        return {
            nid: int(v)
            for nid, v in zip(self.overflow_nodes, hovf)
            if int(v) > 0
        }

    def run(self, max_retries: int = 3, qparams=()):
        for attempt in range(max_retries + 1):
            out, ovf_vec = self.call(qparams)
            overflows = self._overflows(to_numpy(ovf_vec))  # ONE copy
            if not overflows:
                return out
            if attempt == max_retries:
                raise RuntimeError(
                    f"capacity overflow after {max_retries} retries: {overflows}"
                )
            self.retries += 1
            self.params.bump(overflows)
            self.recompile()
        raise AssertionError

    def run_host(self, max_retries: int = 3, qparams=()):
        """Run + fetch everything (columns, validity, sel) to the host.
        Returns (host_cols, host_valid, host_sel, schema, dicts)."""
        out = self.run(max_retries, qparams)
        hcols = {n: to_numpy(c) for n, c in out.cols.items()}
        hvalid = {n: to_numpy(v) for n, v in out.valid.items()}
        return hcols, hvalid, to_numpy(out.sel), out.schema, out.dicts

    def run_device(self, qparams=()):
        """Dispatch without the overflow check: (out batch, overflow
        vector); the check moves to the first fetch (DeviceResult)."""
        return self.call(qparams)


class DeviceResult:
    """Lazy device-resident result cursor. The first host access fetches
    the overflow counters and the live row count (a capacity overflow
    re-runs the plan here, as PreparedPlan.run would); column data
    transfers on demand."""

    def __init__(self, prepared, qparams, out, ovf_vec, max_retries: int = 3):
        self.prepared = prepared
        self._qparams = qparams
        self._out = out
        self._ovf = ovf_vec
        self._max_retries = max_retries
        self._nrows: int | None = None
        self._hcols: dict = {}
        self._hvalid: dict = {}
        self._hsel = None

    def _sync(self) -> None:
        if self._nrows is not None:
            return
        p = self.prepared
        for attempt in range(self._max_retries + 1):
            overflows = p._overflows(to_numpy(self._ovf))
            if not overflows:
                self._nrows = int(self._out.nrows)
                return
            if attempt == self._max_retries:
                raise RuntimeError(
                    f"capacity overflow after {self._max_retries} retries: "
                    f"{overflows}")
            p.retries += 1
            p.params.bump(overflows)
            p.recompile()
            self._out, self._ovf = p.call(self._qparams)

    @property
    def nrows(self) -> int:
        self._sync()
        return self._nrows

    @property
    def schema(self):
        return self._out.schema

    @property
    def dicts(self):
        return self._out.dicts

    def _fetch(self, names) -> None:
        for n in names:
            if n not in self._hcols:
                self._hcols[n] = to_numpy(self._out.cols[n])
                if n in self._out.valid:
                    self._hvalid[n] = to_numpy(self._out.valid[n])
        if self._hsel is None:
            self._hsel = to_numpy(self._out.sel)

    def fetch_columns(self, names=None) -> dict:
        """Host rows (sel-compacted, dict-decoded) for the requested
        columns — all of them when names is None."""
        self._sync()
        fields = [f for f in self._out.schema.fields
                  if names is None or f.name in names]
        self._fetch([f.name for f in fields])
        return host_rows(Schema(tuple(fields)), self._out.dicts, self._hcols,
                         self._hvalid, self._hsel)

    def fetch_head(self, limit: int) -> dict:
        host = self.fetch_columns()
        return {n: v[:limit] for n, v in host.items()}

    def fetch_storage(self, names=None) -> dict:
        """Live rows in the STORAGE domain (scaled-int decimals, day
        numbers, dictionary codes): exact values for result checks."""
        self._sync()
        names = list(names) if names is not None else self._out.schema.names()
        return batch_rows_storage(self._out, names)


def _agg_schema(op: Aggregate, child_schema: Schema) -> Schema:
    fields = []
    gs = op.grouping_sets
    for i, (name, e) in enumerate(op.group_keys):
        t = infer_type(e, child_schema)
        if gs is not None and any(i not in s for s in gs):
            t = replace(t, nullable=True)  # NULL-filled in coarser sets
        fields.append(Field(name, t))
    for name, fn, arg, _ in op.aggs:
        if fn in ("count", "approx_ndv"):
            fields.append(Field(name, DataType.int64()))
        else:
            t = infer_type(arg, child_schema)
            if fn == "sum" and t.is_decimal:
                t = DataType.decimal(18, t.scale)
            elif fn == "sum" and t.is_integer:
                t = DataType.int64()
            fields.append(Field(name, t))
    return Schema(tuple(fields))
