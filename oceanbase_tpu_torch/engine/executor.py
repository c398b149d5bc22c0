"""Physical execution of a logical plan on one torch device.

Counterpart of `oceanbase_tpu/engine/executor.py` for the plan nodes of
a single-chip statement: Scan (with its pushed filter), Filter, Project,
the inner joins (the direct-address route of an affine unique build, the
unique-build merge join, the M:N expansion), the semi and anti joins
(affine probe, sorted-range search, the hash set of multi-column keys,
residual pairs), the left and full outer joins (RIGHT joins arrive as
left joins from the planner), Distinct, the set operations (UNION,
INTERSECT, EXCEPT, with and without ALL), Window, Aggregate (the
direct-addressed, the sort-based with its pack guard, the clustered-FK
segment and the scalar paths; DISTINCT aggregates, approx_count_distinct
and ROLLUP/CUBE/GROUPING SETS), Sort, Limit and TopN (with its exact
top-k candidate prefilter), plus the root compaction; and the two
branches of `prepare` before the plan is built: the scan router that
swaps a selective range scan onto a sorted projection of its table
(read through the range slice, kernel K17), and the out-of-core routes
for inputs beyond the device budget (engine/chunked.py streams the
biggest table in chunks decoded by kernel K18; engine/pipeline.py's
grace-hash route partitions both join sides to host spill files); and
the ANN top-n over an IVF vector index (`_emit_vector_topn`: the
nearest lists by kernel K21, the fused filtered re-rank by kernel K22,
over-probe escalation through the overflow channel). A statement's
result leaves through a lazy cursor (DeviceResult: the head of a large
result by kernel K23) or, when the plan narrows, as one small frame of
its first live rows (kernel K23 again; a frame no wider than the narrowed
one goes as it is), copied to the host in one transfer. Not ported: the PX executors and the batched program of the
statement batcher; a plan node this module does not know raises
NotImplementedError naming it.

The JAX package traces a whole plan into one jitted program; here
`compile` returns a plain Python closure that runs the same emission
eagerly on the session's device, with the device functions on the path
as hand-written kernels (K1-K23, `kernels.py`). The static-capacity
contract is unchanged: every intermediate keeps its producer's capacity
under a live-row `sel` mask, capacity-bound operators report overflow
counters in ONE stacked vector, and the host reads it once per attempt
and re-runs at larger capacities (PhysicalParams.bump).
"""

from __future__ import annotations

import time
import weakref
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
from ..core.dictionary import Dictionary
from ..core.dtypes import DataType, Field, Schema, TypeKind
from ..expr import ir as E
from ..expr.compile import (
    _div_scale,
    compile_predicate,
    derive_dict_column,
    evaluate,
    evaluate_vector_literal,
    infer_type,
)
from ..kernels import (
    ENTRY_LAUNCHES,
    affine_join,
    affine_probe,
    bound_search,
    clustered_segments,
    first_live,
    gather_columns,
    ivf_lists,
    ivf_probe,
    mark_build,
    scalar_reduce,
    scatter_rows,
    slice_scan,
    topk_candidates,
)
from ..ops.gather import gather_rows
from ..ops.hashagg import (
    distinct_first_mask,
    groupby_direct,
    scalar_aggregate,
    sort_groupby,
)
from ..ops.hashing import next_pow2, pack_keys
from ..ops.join import (
    build_hash_table,
    expand_join,
    hash_join_probe,
    merge_join_unique,
    probe_has_match,
    probe_run_any,
    sort_build_side,
)
from ..ops.sort import sort_indices
from ..ops.window import (
    agg_identity,
    boundaries,
    peer_ends,
    prefix_sum,
    segment_starts,
    segmented_scan_minmax,
    suffix_scan_minmax,
)
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
    output_schema,
    setop_schema,
    window_out_type,
)

# largest packed key domain served by the direct group-by (kernel K2)
DIRECT_GROUPBY_MAX_DOMAIN = 1 << 6

# synthetic PhysicalParams id for the root result-compaction capacity
ROOT_COMPACT = -1

# synthetic overflow-node id space for the pack-validity guards (disjoint
# from plan node ids)
PACK_GUARD_BASE = 5_000_000

# synthetic overflow-node id space for ANN over-probe escalation: a
# candidate-starvation counter (live re-rank candidates < k) rides the
# overflow channel at ANN_PROBE_BASE + nid and widens the node's nprobe
# instead of a capacity
ANN_PROBE_BASE = 9_000_000


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
    """Static capacities per plan node (keyed by pre-order node index)."""

    join_cap: dict[int, int] = field(default_factory=dict)
    # stats-packed group keys: nid -> ((vmin, bits) per key). A runtime
    # pack-validity counter rides the overflow channel (PACK_GUARD_BASE +
    # nid); overflow disables packing for that node and recompiles.
    pack_guard: dict[int, tuple] = field(default_factory=dict)
    groupby_nopack: set = field(default_factory=set)
    # clustered-FK segment aggregation specs (nid -> ClusteredAggSpec),
    # re-detected on every compile (deterministic from plan + catalog)
    clustered_aggs: dict = field(default_factory=dict)
    # top-k candidate prefilter sizes (TopN via the exact top-k of the
    # first key, under the tie-overflow guard)
    topn_cand: dict[int, int] = field(default_factory=dict)
    # range-sliced sorted-projection scans: nid -> _SliceSpec, with the
    # static slice capacity in scan_cap (overflow-bumped like join caps)
    scan_slice: dict = field(default_factory=dict)
    scan_cap: dict[int, int] = field(default_factory=dict)
    # ANN: TopN-over-vec_l2 nodes served by an IVF index (nid -> spec)
    vector_topns: dict = field(default_factory=dict)
    # ANN over-probe state: nid -> effective nprobe (survives the
    # per-compile vector_topns re-detection so an escalation sticks),
    # nid -> total list count (the escalation ceiling: probing every list
    # IS the exact answer, so the retry always resolves there)
    ann_nprobe: dict[int, int] = field(default_factory=dict)
    ann_lists: dict[int, int] = field(default_factory=dict)
    ann_escalations: int = 0  # lifetime over-probe bumps

    def bump(self, overflows: dict[int, int]):
        for nid in overflows:
            if nid >= ANN_PROBE_BASE:
                # candidate starvation (the filter decimated the probed
                # lists): widen nprobe x8 toward the full list count
                vid = nid - ANN_PROBE_BASE
                cur = self.ann_nprobe.get(vid)
                if cur is not None:
                    self.ann_nprobe[vid] = min(
                        cur * 8, self.ann_lists.get(vid, cur * 8))
                    self.ann_escalations += 1
                continue
            if nid >= PACK_GUARD_BASE:
                self.groupby_nopack.add(nid - PACK_GUARD_BASE)
                continue
            if nid in self.join_cap:
                self.join_cap[nid] *= 4
            if nid in self.scan_cap:
                # the slice capacity was seeded from ONE representative
                # parameter value; a wider runtime range is the normal
                # plan-cache reuse case, so the retry must always
                # resolve: drop back to the unsliced full scan (a cap of
                # at least the table's rows disables the slice)
                self.scan_cap[nid] = 1 << 62
            if nid in self.topn_cand:
                # ties on a low-cardinality first key can exceed ANY
                # candidate budget: one overflow disables the prefilter
                # (cand >= capacity skips it at emit) and the full sort runs
                self.topn_cand[nid] = 1 << 62


class ClusteredPremiseInvalidated(Exception):
    """A cached plan's clustered-FK premise no longer holds (the probe
    table's data changed and its fk column is no longer monotone), or a
    vector index rebuild changed the list window the plan was built for;
    PreparedPlan recompiles, which re-detects the spec."""


@dataclass(frozen=True)
class _SliceSpec:
    """Range bounds of a sorted-projection scan: the scan reads only the
    contiguous key range [max(lows), min(highs)) through kernel K17.
    Bounds are (Literal, searchsorted side) pairs, so slotted literals
    keep the plan reusable across parameter values."""

    key: str                   # qualified sort-key column
    lows: tuple = ()           # (E.Literal, 'left'|'right') lower bounds
    highs: tuple = ()          # (E.Literal, 'left'|'right') upper bounds


@dataclass(frozen=True)
class VectorTopNSpec:
    """ORDER BY vec_l2(col, q) LIMIT k over an IVF-indexed scan: the
    nearest lists (K21), their contiguous row windows re-ranked exactly
    and the top k (K22). Filter predicates between the TopN and the Scan
    ride into the probe as selection masks; a starvation counter on the
    overflow channel widens nprobe when the filter decimates the probed
    lists."""

    table: str
    column: str        # unqualified vector column
    qual_col: str      # alias-qualified name in the scan batch
    input_alias: str
    nprobe: int        # probed lists (over-probe escalated)
    max_list: int      # per-list read window
    nrows: int         # live rows of the table at compile
    k: int
    key: object        # the vec_l2 Func (resolved through the Project)
    scan: object       # the Scan node to emit
    proj: object       # Project between TopN and Scan (or None)
    filters: tuple = ()    # Filter predicates fused into the probe
    lists: int = 0         # total IVF list count (escalation ceiling)
    base_nprobe: int = 0   # registered nprobe before over-probe seeding
    est_sel: float = 1.0   # estimated filter selectivity at compile
    ivf_cost: float = 0.0  # route cost, IVF side
    brute_cost: float = 0.0  # route cost of the brute-force matmul
    cost_basis: str = "flops"  # "measured" when calibration records won


@dataclass(frozen=True)
class ClusteredAggSpec:
    """One Aggregate-over-PK-FK-join collapsed into segment reductions
    (see Executor._clustered_agg_spec)."""

    ji: object        # the JoinOp replaced by per-build-row range sums
    probe_table: str
    fk_col: str       # clustered probe key (unqualified storage column)
    fk_name: str      # qualified probe-side join key name
    build_table: str
    pk_col: str
    input_alias: str  # inputs key carrying the (starts, ends) arrays


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


def _device_nbytes(obj) -> int:
    """Sum nbytes over the device tensors inside an executor input: a
    ColumnBatch, or a derived structure's tuple (fk_ranges, ivf arrays)."""
    if isinstance(obj, torch.Tensor):
        return int(obj.nbytes)
    if isinstance(obj, ColumnBatch):
        return (
            _device_nbytes(obj.cols)
            + _device_nbytes(obj.valid)
            + _device_nbytes(obj.sel)
        )
    if isinstance(obj, dict):
        return sum(_device_nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_device_nbytes(v) for v in obj)
    return int(getattr(obj, "nbytes", 0) or 0)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the torch engine yet")


class Executor:
    # executors that manage their own inputs (the merge and partition
    # executors of the out-of-core routes) disable chunking
    chunking_enabled = True
    # clustered-FK segment aggregation and the top-k prefilter need
    # whole-table inputs in storage order; chunk sources disable them
    clustered_agg_enabled = True
    # the sorted-projection slice needs whole-table device columns
    # (chunks and partitions would misindex); the projection SWAP itself
    # is layout-only and stays on everywhere
    scan_slice_enabled = True

    def __init__(self, catalog, unique_keys=None,
                 default_rows_estimate=1 << 16, stats=None, device=None,
                 device_budget=None, chunk_rows=None):
        import os

        from .chunked import DEFAULT_CHUNK_ROWS, DEFAULT_DEVICE_BUDGET
        from .memory_governor import detect_device_budget

        self.catalog = catalog
        self.unique_keys = unique_keys or {}
        self.default_rows_estimate = default_rows_estimate
        self.stats = stats
        self.device = _device(device)
        # out-of-core: inputs beyond this many bytes stream through the
        # plan in chunks (engine/chunked.py). The default is the card's
        # own (detect_device_budget) on CUDA, and the library default on
        # the CPU, where it routes as the JAX Executor does
        if device_budget is None:
            device_budget = (detect_device_budget(self.device)
                             if self.device.type == "cuda"
                             else DEFAULT_DEVICE_BUDGET)
        self.device_budget = device_budget
        self.chunk_rows = chunk_rows or DEFAULT_CHUNK_ROWS
        # engine/memory_governor.MemoryGovernor, when wired: its effective
        # budget clamps device_budget, and it holds the staged ledger of
        # the streaming prefetcher
        self.governor = None
        # streaming knobs (engine/pipeline.py): prefetch depth 0 turns the
        # prefetch thread off (the wire and the device alternate, the A/B
        # baseline); stream_compress off ships raw / FOR chunks
        self.stream_prefetch_depth = max(0, int(os.environ.get(
            "OB_STREAM_PREFETCH", "2")))
        self.stream_compress = os.environ.get(
            "OB_STREAM_COMPRESS", "1") not in ("0", "false", "off")
        # per-column device cache: (table, column) -> (values, validity),
        # plus (table, "#sel") and the clustered-FK ranges; and the
        # assembled batch per column set
        self._batch_cache: dict = {}
        self._assembled: dict[tuple, ColumnBatch] = {}
        # bumped by invalidate_table; derived device structures that span
        # TWO tables (fk_ranges) revalidate against both versions
        self._table_version: dict[str, int] = {}
        # the last routed plan's sliced scans: id(Scan) -> (_SliceSpec,
        # capacity), read by seed_params
        self._pending_slices: dict = {}
        # vector indexes: (table, column) -> the last build's record, and
        # the Session's per-statement counters [queries, probed lists,
        # over-probe escalations]
        self.ann_builds: dict = {}
        self.ann_stats: dict = {}
        # lifetime host->device upload bytes (QueryProfile reads the delta
        # around one execution; warm statements upload nothing)
        self.h2d_bytes = 0
        # hook: share/timeline.ServingTimeline (cold uploads land as
        # transfer interference; the server wires it)
        self.timeline = None
        # lifetime counts of compile() runs (cold builds + overflow
        # rebuilds), of narrowed result-frame programs built (one per
        # plan and pow2 frame width) and of batched programs (none: the
        # batched program is not ported, PreparedPlan.batchable is False)
        self.compiles = 0
        self.narrow_compiles = 0
        self.batched_compiles = 0
        # hook: engine/plan_profile.OperatorProfileStore; its measured
        # route rates cost the IVF route against brute force
        self.profile_store = None
        # set on the degraded host executor of the server's device-OOM
        # ladder (it cannot run out of device memory)
        self.host_fallback = False

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
            if isinstance(op, JoinOp):
                for e in op.left_keys + op.right_keys:
                    note(e)
                if op.residual is not None:
                    note(op.residual)
            if isinstance(op, Aggregate):
                for _, e in op.group_keys:
                    note(e)
                for _, _, a, _ in op.aggs:
                    if a is not None:
                        note(a)
            if isinstance(op, (Sort, TopN)):
                for e, _ in op.keys:
                    note(e)
            if isinstance(op, Window):
                for _name, fn, a, pk, ok, extra in op.funcs:
                    if a is not None:
                        note(a)
                    if fn in ("lag", "lead") and extra is not None \
                            and extra[1] is not None:
                        note(extra[1])
                    for p in pk:
                        note(p)
                    for oe, _d in ok:
                        note(oe)
            for c in _children(op):
                rec(c)

        rec(plan)
        return needed

    def _access_columns(self, plan: LogicalOp) -> dict[str, set]:
        """alias -> set of (column, role) pairs for the workload access
        stats: the columns the plan uses as filter predicates, join keys,
        group keys or sort keys (server/workload.ROLE_* indices). The
        same walk as _needed_columns, keeping the role."""
        from ..server.workload import (
            ROLE_FILTER,
            ROLE_GROUP,
            ROLE_JOIN,
            ROLE_SORT,
        )

        acc: dict[str, set] = {}
        # output name -> defining expr across every Project: the planner
        # rewrites sort/group keys into projected columns ($ordN), so an
        # unqualified ColRef chases its definition to base columns
        defs: dict[str, E.Expr] = {}

        def collect_defs(op):
            if isinstance(op, Project):
                for name, e in op.exprs:
                    defs.setdefault(name, e)
            for c in _children(op):
                collect_defs(c)

        collect_defs(plan)

        def note(e: E.Expr, role: int, depth: int = 0):
            for q in E.referenced_columns(e):
                if "." in q:
                    a, c = q.split(".", 1)
                    acc.setdefault(a, set()).add((c, role))
                elif depth < 4 and q in defs:
                    note(defs[q], role, depth + 1)

        def rec(op):
            if isinstance(op, Scan) and op.pushed_filter is not None:
                note(op.pushed_filter, ROLE_FILTER)
            if isinstance(op, Filter):
                note(op.pred, ROLE_FILTER)
            if isinstance(op, JoinOp):
                for e in op.left_keys + op.right_keys:
                    note(e, ROLE_JOIN)
            if isinstance(op, Aggregate):
                for _, e in op.group_keys:
                    note(e, ROLE_GROUP)
            if isinstance(op, (Sort, TopN)):
                for e, _ in op.keys:
                    note(e, ROLE_SORT)
            for c in _children(op):
                rec(c)

        rec(plan)
        return acc

    def _access_profile(self, scans0: list, routed_plan: LogicalOp,
                        roles: dict[str, set]) -> tuple:
        """Static access profile of a prepared plan, one entry per scan:
        (base table, rows at prepare time, has sorted projections, routed
        to one, ((column, role), ...)). scans0 are the scans before
        routing; routing keeps the plan's shape, so the routed scans pair
        by position (a projection hit shows as a changed table). Virtual
        tables and planner-internal relations are left out."""
        scans1 = self._collect_scans(routed_plan)
        out = []
        cat = self.catalog
        for s0, s1 in zip(scans0, scans1):
            if s0.table.startswith(("__all_virtual", "$")):
                continue
            t = cat[s0.table] if s0.table in cat else None
            rows = t.nrows if t is not None else 0
            has_proj = bool(getattr(t, "sorted_projections", None))
            cols = tuple(sorted(roles.get(s0.alias, ())))
            out.append((s0.table, rows, has_proj, s1.table != s0.table,
                        cols))
        return tuple(out)

    def invalidate_table(self, name: str) -> None:
        """Drop cached device batches of one table (its data changed)."""
        self._table_version[name] = self._table_version.get(name, 0) + 1
        for key in [k for k in self._batch_cache if k[0] == name]:
            del self._batch_cache[key]
        for key in [k for k in self._assembled if k[0] == name]:
            del self._assembled[key]

    def input_device_bytes(self, input_spec) -> int:
        """Device-resident bytes of a prepared plan's inputs (the
        QueryProfile's device_bytes). Called after execution, so every
        input is already in the device cache and nothing uploads."""
        total = 0
        for alias, table, cols in input_spec:
            try:
                total += _device_nbytes(self.input_batch(alias, table, cols))
            except Exception:  # noqa: BLE001 - accounting never fails a query
                continue
        return total

    def fk_ranges(self, probe_table: str, fk_col: str,
                  build_table: str, pk_col: str):
        """Device (starts, ends) int32 tensors over build-table rows: build
        row i joins exactly the probe rows [starts[i], ends[i]) -- valid
        because the probe's fk column is stored CLUSTERED (monotone
        nondecreasing, checked by _monotone_col before any caller gets
        here). Host-precomputed by binary search once per table version
        and cached beside the device columns; padded build rows get
        [0, 0)."""
        vp = self._table_version.get(probe_table, 0)
        vb = self._table_version.get(build_table, 0)
        key = (probe_table, ("#fkr", fk_col, build_table, pk_col))
        hit = self._batch_cache.get(key)
        if hit is not None and hit[0] == (vp, vb):
            return hit[1]
        # data changed since the spec was detected: the clustering premise
        # must be re-proven, not assumed
        if not self._monotone_col(probe_table, fk_col):
            raise ClusteredPremiseInvalidated(
                f"{probe_table}.{fk_col} is no longer monotone"
            )
        tp = self.catalog[probe_table]
        tb = self.catalog[build_table]
        fk = np.asarray(tp.data[fk_col])
        pk = np.asarray(tb.data[pk_col])
        lo = np.searchsorted(fk, pk, side="left").astype(np.int32)
        hi = np.searchsorted(fk, pk, side="right").astype(np.int32)
        cap = max(1024, -(-max(tb.nrows, 1) // 1024) * 1024)
        dev = (upload(lo, cap, self.device), upload(hi, cap, self.device))
        self._batch_cache[key] = ((vp, vb), dev)
        return dev

    def input_batch(self, alias: str, table: str, cols: tuple):
        """One program input from its input_spec entry: a table
        ColumnBatch, or a derived structure ('#fkr:' = clustered-FK join
        ranges, '#ivf:' = IVF vector-index arrays)."""
        if alias.startswith("#fkr:"):
            return self.fk_ranges(*cols)
        if alias.startswith("#ivf:"):
            tname, col, max_list = cols
            return self.ivf_device(tname, col, max_list)
        return self.table_batch(table, cols)

    def ivf_host(self, table: str, col: str):
        """Built IvfIndex for (table, col), staleness-checked two ways: the
        table VERSION (DML through invalidate_table bumps it) and the
        column array's IDENTITY (weakref): an array swapped without an
        invalidation never serves a stale index. Invalidation means a lazy
        rebuild on the next use, on this executor's device."""
        from ..storage.vector_index import build_ivf

        t = self.catalog[table]
        spec = getattr(t, "vector_indexes", {}).get(col)
        if spec is None:
            return None
        arr = t.data[col]
        v = self._table_version.get(table, 0)
        key = (table, ("#ivfh", col))
        hit = self._batch_cache.get(key)
        if hit is not None and hit[0] == v and hit[2]() is arr:
            return hit[1]
        t0 = time.perf_counter()
        idx = build_ivf(np.asarray(arr), lists=spec.lists, device=self.device)
        self._batch_cache[key] = (v, idx, weakref.ref(arr))
        self.ann_builds[(table, col)] = {
            "build_version": v,
            "build_unix": time.time(),
            "build_s": time.perf_counter() - t0,
            "rows": int(len(arr)),
            "iterations": idx.iterations,
        }
        return idx

    def install_ivf(self, table: str, col: str, idx) -> None:
        """Serve `idx` (an IvfIndex built elsewhere, e.g. by
        storage/vector_index.ivf_from_arrays) as the index of (table, col)
        at the table's current version, as if ivf_host had built it."""
        t = self.catalog[table]
        if col not in getattr(t, "vector_indexes", {}):
            raise KeyError(f"no vector index registered on {table}.{col}")
        v = self._table_version.get(table, 0)
        self._batch_cache[(table, ("#ivfh", col))] = (
            v, idx, weakref.ref(t.data[col]))

    def ivf_device(self, table: str, col: str, expect_max_list: int):
        """(centroids, perm, offsets, lengths) device tensors; raises the
        premise-invalidated recompile signal when a rebuild changed the
        list window the compiled plan assumed. Keyed on the host index
        OBJECT too: an identity-detected rebuild re-uploads although the
        version never moved."""
        idx = self.ivf_host(table, col)
        if idx is None or idx.max_list != expect_max_list:
            raise ClusteredPremiseInvalidated(
                f"vector index on {table}.{col} changed shape"
            )
        v = self._table_version.get(table, 0)
        key = (table, ("#ivfd", col))
        hit = self._batch_cache.get(key)
        if hit is not None and hit[0] == v and hit[2] is idx:
            return hit[1]
        dev = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (idx.centroids, idx.perm, idx.offsets, idx.lengths)
        )
        self._batch_cache[key] = (v, dev, idx)
        return dev

    def ann_residency(self) -> dict:
        """(table, column) -> device bytes of the uploaded IVF arrays."""
        out: dict = {}
        for k, hit in list(self._batch_cache.items()):
            if (isinstance(k, tuple) and len(k) == 2
                    and isinstance(k[1], tuple) and k[1]
                    and k[1][0] == "#ivfd"):
                out[(k[0], k[1][1])] = sum(
                    a.numel() * a.element_size() for a in hit[1])
        return out

    def ann_device_bytes(self) -> int:
        return sum(self.ann_residency().values())

    # host-side monotonicity cache (id + weakref: a bare id can be reused
    # by a new array after the old one is collected)
    _monotone_cache: dict = {}

    def _monotone_col(self, table: str, col: str) -> bool:
        """True when the stored column array is monotone NONDECREASING --
        the table is physically clustered by this column (TPC-H lineitem
        by l_orderkey). Nullable columns are excluded: NULL rows carry
        arbitrary storage values."""
        try:
            t = self.catalog[table]
            arr = t.data[col]
        except (KeyError, AttributeError):
            return False
        if col in getattr(t, "valid", {}):
            return False
        if not isinstance(arr, np.ndarray) or arr.ndim != 1 or len(arr) < 1:
            return False
        if not np.issubdtype(arr.dtype, np.integer):
            return False
        key = id(arr)
        hit = Executor._monotone_cache.get(key)
        if hit is not None and hit[0]() is arr:
            return hit[1]
        if len(Executor._monotone_cache) > 4096:
            Executor._monotone_cache.clear()
        out = bool(np.all(arr[1:] >= arr[:-1]))
        Executor._monotone_cache[key] = (weakref.ref(arr), out)
        return out

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
        is_private = getattr(self.catalog, "is_private", None)
        if is_private is not None and is_private(name):
            # a transaction's private view: it never enters (or reads) the
            # shared device cache, so no other session sees its rows
            return self._build_batch(name, cols)
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
                self._note_upload(int(dev_col.nbytes) + (
                    int(vdev.nbytes) if vdev is not None else 0))
            dcols[f.name] = hit[0]
            if hit[1] is not None:
                dvalid[f.name] = hit[1]
        skey = (name, "#sel")
        sel = self._batch_cache.get(skey)
        if sel is None:
            sel = upload(np.ones(n, dtype=np.bool_), cap, dev, fill=False)
            self._batch_cache[skey] = sel
            self._note_upload(int(sel.nbytes))
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

    def _note_upload(self, nbytes: int) -> None:
        self.h2d_bytes += nbytes
        tl = self.timeline
        if tl is not None and tl.enabled:
            # a cold-column upload takes device time from the serving
            # stream: transfer interference
            tl.record_transfer(nbytes)

    def _build_batch(self, name: str, cols: tuple[str, ...]) -> ColumnBatch:
        from ..core.column import make_batch

        t = self.catalog[name]
        sub_schema = Schema(
            tuple(f for f in t.schema.fields if f.name in cols)
        )
        return make_batch(
            {c: t.data[c] for c in sub_schema.names()},
            sub_schema,
            {c: d for c, d in t.dicts.items() if c in cols},
            valid={c: v for c, v in t.valid.items() if c in cols},
            device=self.device,
        )

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
        if isinstance(op, JoinOp):
            l = est_rows(op.left)
            r = est_rows(op.right)
            if op.kind in ("semi", "anti"):
                return max(l * 0.5, 1.0)
            if op.kind == "left":
                return l * 2
            if op.kind == "full":
                return l + r
            if not op.left_keys:  # cross / scalar broadcast
                return l if self._is_scalar_relation(op.right) else l * r
            if self._join_build_unique(op):
                # each probe row matches at most one build row; the MATCH
                # RATE is the filtered fraction of the build's key space
                # (containment), floored at 0.05
                rb = self._build_base_rows(op.right)
                if rb and rb > 0:
                    return max(l * max(min(r / rb, 1.0), 0.05), 1.0)
                return l
            # M:N equi-join: |L||R| / max(ndv(Lkeys), ndv(Rkeys))
            lndv = self._keys_ndv(op.left, op.left_keys)
            rndv = self._keys_ndv(op.right, op.right_keys)
            if lndv is not None and rndv is not None:
                denom = max(min(lndv, l), min(rndv, r), 1.0)
                return max((l * r) / denom, 1.0)
            return max(l, r) * 2
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
        if isinstance(op, SetOp):
            l, r = est_rows(op.left), est_rows(op.right)
            if op.kind == "union":
                return l + r
            if op.kind == "intersect":
                return min(l, r)
            return l  # except
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

    def _static_key_range(self, child: LogicalOp, e) -> tuple[int, int] | None:
        """(vmin, bits) for a group-key expr whose value domain is known
        statically: dictionary codes (exact domain from the dict length)
        or stats min/max (exact at collection; 4x headroom covers drift,
        and the runtime pack guard catches anything beyond). None = not
        packable."""
        name = e.name if isinstance(e, E.ColRef) else None
        if name is None:
            return None

        def resolve(node, name):
            if isinstance(node, Filter):
                return resolve(node.child, name)
            if isinstance(node, Project):
                nxt = dict(node.exprs).get(name)
                if not isinstance(nxt, E.ColRef):
                    return None
                return resolve(node.child, nxt.name)
            if isinstance(node, JoinOp):
                return resolve(node.left, name) or resolve(node.right, name)
            if isinstance(node, Scan) and "." in name:
                alias, col = name.split(".", 1)
                if alias == node.alias:
                    return (node.table, col)
            return None

        hit = resolve(child, name)
        if hit is None:
            return None
        table, col = hit
        try:
            t = self.catalog[table]
        except KeyError:
            return None
        d = t.dicts.get(col)
        if d is not None:
            dom = max(len(d), 1)
            # append-dictionaries can grow: headroom + runtime guard
            return 0, max((4 * dom - 1).bit_length(), 1)
        try:
            ct = t.schema[col]
        except Exception:
            return None
        if not np.issubdtype(ct.storage_np, np.integer):
            # float keys would TRUNCATE into the packed int domain and
            # merge distinct groups without tripping the range guard
            return None
        ts = self.stats.table_stats(table) if self.stats else None
        cs = ts.cols.get(col) if ts is not None else None
        if cs is None or cs.ndv <= 0:
            return None
        span = int(cs.vmax) - int(cs.vmin) + 1
        if span <= 0:
            return None
        return int(cs.vmin), max((4 * span - 1).bit_length(), 1)

    def seed_params(self, plan: LogicalOp) -> PhysicalParams:
        params = PhysicalParams()
        nodes = _number_nodes(plan)
        # root compaction capacity: results travel device->host compacted
        # to the estimated output size; overflow retries apply
        params.join_cap[ROOT_COMPACT] = next_pow2(
            int(2 * self._est_rows(plan)) + 1024
        )
        for nid, op in nodes.items():
            if isinstance(op, Scan) and self.scan_slice_enabled:
                ps = self._pending_slices.get(id(op))
                if ps is not None and nid not in params.scan_slice:
                    params.scan_slice[nid], params.scan_cap[nid] = ps
            if (
                isinstance(op, TopN)
                and self.clustered_agg_enabled  # whole-batch executors only
                and op.n + op.offset <= 1024
                and nid not in params.topn_cand
            ):
                params.topn_cand[nid] = max(
                    256, -(-4 * (op.n + op.offset) // 64) * 64
                )
            if (
                isinstance(op, Aggregate) and len(op.group_keys) > 1
                and op.grouping_sets is None
            ):
                # multi-key sort group-bys pack into ONE int64 sort key
                # when every key's domain is statically known
                ranges = [
                    self._static_key_range(op.child, e)
                    for _n, e in op.group_keys
                ]
                if all(r is not None for r in ranges) and sum(
                    b for _v, b in ranges
                ) <= 62:
                    params.pack_guard[nid] = tuple(ranges)
            if isinstance(op, JoinOp):
                needs_cap = (
                    (op.kind in ("inner", "cross")
                     and not self._merge_joinable(op))
                    or (op.kind in ("semi", "anti")
                        and op.residual is not None)
                    or op.kind in ("left", "full")
                )
                if needs_cap:
                    if op.kind in ("semi", "anti", "left", "full"):
                        # candidate-pair capacity, not output rows
                        cap = int(
                            max(self._est_rows(op.left),
                                self._est_rows(op.right)) * 2
                        ) + 1024
                    else:
                        cap = int(self._est_rows(op)) * 2 + 1024
                    params.join_cap[nid] = -(-cap // 1024) * 1024
        return params

    # host-side column-layout property cache. Keyed by id(array) with a
    # WEAK reference in the value: a bare id can be reused by a new array
    # after the old one is collected, which would apply a stale
    # (a0, stride) to an unrelated column and drop matching join rows.
    _affine_cache: dict[int, tuple["weakref.ref", tuple[int, int] | None]] = {}

    def _resolve_layout_col(self, node: LogicalOp, name: str):
        """(table, col) when output column `name` of `node` IS a base
        Scan's stored array (same length, same order -- only the sel mask
        differs), seen through the layout-preserving ops: Filter, Project
        renames, and the PROBE side of joins that keep the probe layout
        (semi/anti always; inner via the merge/affine path, which emits
        probe columns untouched and only gathers build columns). None
        when the column is computed, gathered, or re-ordered."""
        while True:
            if isinstance(node, Filter):
                node = node.child
            elif isinstance(node, Project):
                nxt = dict(node.exprs).get(name)
                if not isinstance(nxt, E.ColRef):
                    return None
                name = nxt.name
                node = node.child
            elif isinstance(node, JoinOp) and (
                node.kind in ("semi", "anti")
                or (node.kind == "inner" and self._merge_joinable(node))
            ):
                # a build-side column would gather (new layout), but then
                # its alias only exists in the right subtree and the final
                # Scan-alias check below fails
                node = node.left
            else:
                break
        if not isinstance(node, Scan) or "." not in name:
            return None
        alias, col = name.split(".", 1)
        if alias != node.alias:
            return None
        return node.table, col

    def _affine_build_info(self, op: JoinOp) -> tuple[int, int] | None:
        """(a0, stride) when the build side's single join-key column is an
        AFFINE sequence in storage order (key[i] = a0 + stride*i) -- true
        for identifier columns of tables laid out in key order with
        regular keys (every TPC-H key column). Such joins skip sorting
        entirely: the matching build row is (key - a0) / stride, verified
        by one gather (kernel K5)."""
        if not op.left_keys or len(op.right_keys) != 1:
            return None
        e = op.right_keys[0]
        if not isinstance(e, E.ColRef):
            return None
        hit = self._resolve_layout_col(op.right, e.name)
        if hit is None:
            return None
        table, col = hit
        if "#sp:" in table:
            # a routed projection scan may be SLICED (params.scan_slice):
            # affine candidates index full-table rows and would misindex
            # the sliced batch
            return None
        try:
            arr = self.catalog[table].data[col]
        except (KeyError, AttributeError):
            return None
        if not isinstance(arr, np.ndarray) or arr.ndim != 1 or len(arr) < 2:
            return None
        key = id(arr)
        hit = Executor._affine_cache.get(key)
        if hit is not None and hit[0]() is arr:
            return hit[1]
        if len(Executor._affine_cache) > 4096:
            Executor._affine_cache.clear()
        out = None
        if np.issubdtype(arr.dtype, np.integer):
            stride = int(arr[1]) - int(arr[0])
            if stride > 0:
                d = np.diff(arr)
                if (d == stride).all():
                    out = (int(arr[0]), stride)
        Executor._affine_cache[key] = (weakref.ref(arr), out)
        return out

    def _merge_joinable(self, op: JoinOp) -> bool:
        """True when the join takes the unique-build route (no pair
        expansion, no capacity): unique build side and one integer-typed
        key per side (dates, dict codes, ints, decimals)."""
        if not self._join_build_unique(op):
            return False
        if not op.left_keys:  # scalar-subquery cross: constant int key
            return True
        if len(op.left_keys) != 1:
            return False
        try:
            lt = infer_type(op.left_keys[0], output_schema(op.left))
            rt = infer_type(op.right_keys[0], output_schema(op.right))
        except Exception:
            return False
        return (
            np.issubdtype(lt.storage_np, np.integer)
            and np.issubdtype(rt.storage_np, np.integer)
        )

    def _keys_ndv(self, side: LogicalOp, keys) -> float | None:
        """Product of base-column NDVs for join keys resolvable to scans of
        `side` (None when any key isn't a plain column or stats are off)."""
        if self.stats is None:
            return None
        amap = {s.alias: s.table for s in self._collect_scans(side)}
        prod = 1.0
        for k in keys:
            if not isinstance(k, E.ColRef) or "." not in k.name:
                return None
            a, c = k.name.split(".", 1)
            tname = amap.get(a)
            if tname is None:
                return None
            ts = self.stats.table_stats(tname)
            nd = ts.ndv_of(c) if ts is not None else None
            if nd is None or nd <= 0:
                return None
            prod *= nd
        return prod

    def _build_base_rows(self, node: LogicalOp) -> float | None:
        """UNFILTERED row count of the base relation a unique-build side
        reads -- the denominator of the join match-rate estimate."""
        while isinstance(node, (Filter, Project)):
            node = node.child
        if isinstance(node, JoinOp) and node.kind in ("inner", "semi", "anti"):
            return self._build_base_rows(node.left)
        if isinstance(node, Scan):
            try:
                return float(self.catalog[node.table].nrows or 1)
            except KeyError:
                return None
        return None

    @staticmethod
    def _is_scalar_relation(node: LogicalOp) -> bool:
        """True for a guaranteed-1-row relation (grand aggregate, possibly
        under projections/filters)."""
        while isinstance(node, (Filter, Project)):
            node = node.child
        return isinstance(node, Aggregate) and not node.group_keys

    def _join_build_unique(self, op: JoinOp) -> bool:
        """True if the build (right) side's join keys cover a unique key of
        its source: a base table's declared unique key, an Aggregate's full
        group-key set, or a Distinct's full column set -- seen through
        Filter/Project (renames followed) and through joins that cannot
        duplicate probe rows (semi/anti, and inner joins whose own build
        side is unique)."""
        if self._is_scalar_relation(op.right):
            return True
        names = []
        for e in op.right_keys:
            if not isinstance(e, E.ColRef):
                return False
            names.append(e.name)
        node = op.right
        while True:
            if isinstance(node, Filter):
                node = node.child
            elif isinstance(node, Project):
                rename = {n: ex for n, ex in node.exprs}
                nxt = []
                for n in names:
                    ex = rename.get(n)
                    if not isinstance(ex, E.ColRef):
                        return False
                    nxt.append(ex.name)
                names = nxt
                node = node.child
            elif isinstance(node, JoinOp) and (
                node.kind in ("semi", "anti")
                or (node.kind == "inner" and self._join_build_unique(node))
            ):
                node = node.left
            else:
                break
        if isinstance(node, Aggregate):
            gk = {n for n, _ in node.group_keys}
            return bool(gk) and gk <= set(names)
        if isinstance(node, Distinct):
            cols = set(output_schema(node).names())
            return cols <= set(names)
        if isinstance(node, Scan):
            # a routed sorted projection keeps the base table's rows (and
            # so its unique keys) under the '#sp:' name
            base = node.table.split("#sp:", 1)[0]
            uks = tuple(self.unique_keys.get(node.table, ())) + tuple(
                self.unique_keys.get(base, ()))
            key_cols = {
                n.split(".", 1)[1] for n in names
                if n.startswith(node.alias + ".")
            }
            return any(set(uk) <= key_cols for uk in uks)
        return False

    # ---- clustered-FK segment aggregation -----------------------------
    def _clustered_agg_spec(self, op: Aggregate):
        """Match Aggregate directly over an inner PK-FK join whose probe
        (left) side is a Filter chain over a Scan stored CLUSTERED by the
        single join key. The join + group-by then collapse into one
        reduction per build row over its host-precomputed probe range
        (fk_ranges, kernel K6): no sort, no hash table, no per-probe-row
        gather.

        Matched shape:
        - group keys: exprs over the join key and/or build-side columns,
          one of them the join key itself (each group IS one build row)
        - aggregates: non-DISTINCT sum/count over probe-side exprs
        - join: merge-joinable (unique build, single integer key both
          sides with equal storage types), no residual
        """
        if not op.group_keys or op.grouping_sets is not None:
            return None
        ji = op.child
        if (
            not isinstance(ji, JoinOp)
            or ji.kind != "inner"
            or ji.residual is not None
            or len(ji.left_keys) != 1
            or not isinstance(ji.left_keys[0], E.ColRef)
            or not isinstance(ji.right_keys[0], E.ColRef)
        ):
            return None
        if not self._merge_joinable(ji):
            return None
        try:
            lt = infer_type(ji.left_keys[0], output_schema(ji.left))
            rt = infer_type(ji.right_keys[0], output_schema(ji.right))
        except Exception:
            return None
        if lt.storage_np != rt.storage_np:
            # the group-key output substitutes the build pk for the probe
            # fk; a dtype mismatch would change the output column type
            return None
        node = ji.left
        while isinstance(node, Filter):
            node = node.child
        if not isinstance(node, Scan):
            return None
        base = node
        if "#sp:" in base.table:
            # a routed projection scan may be SLICED (params.scan_slice):
            # fk_ranges index full-table rows and would misindex the
            # sliced batch
            return None
        fk_name = ji.left_keys[0].name
        if "." not in fk_name:
            return None
        alias, fk_col = fk_name.split(".", 1)
        if alias != base.alias or not self._monotone_col(base.table, fk_col):
            return None
        hit = self._resolve_layout_col(ji.right, ji.right_keys[0].name)
        if hit is None:
            return None
        build_table, pk_col = hit
        build_names = set(output_schema(ji.right).names())
        # groups must be 1:1 with build rows: some group key must BE the
        # join key itself. Keys that are merely functions of the build
        # side (TPC-H Q10) make groups coarser than build rows.
        if not any(
            e == ji.left_keys[0] or e == ji.right_keys[0]
            for _n, e in op.group_keys
        ):
            return None
        for _name, e in op.group_keys:
            if not set(E.referenced_columns(e)) <= (build_names | {fk_name}):
                return None
        probe_names = set(output_schema(ji.left).names())
        for _name, fn, arg, distinct in op.aggs:
            if distinct or fn not in ("sum", "count"):
                return None
            if arg is not None and not (
                set(E.referenced_columns(arg)) <= probe_names
            ):
                return None
        input_alias = f"#fkr:{base.table}.{fk_col}->{build_table}.{pk_col}"
        return ClusteredAggSpec(
            ji, base.table, fk_col, fk_name, build_table, pk_col,
            input_alias,
        )

    def _emit_clustered_agg(self, op: Aggregate, spec: ClusteredAggSpec,
                            inputs, emit):
        """Emit the matched Aggregate-over-join as segment reductions: each
        live build row with >= 1 joined live probe row becomes a group,
        its aggregates reduced over its probe range by K6. Exact (no
        hashing, no capacities, no overflow); NULL arguments skip through
        their validity, and a sum over an empty or all-NULL group is 0,
        as in the generic paths."""
        from ..sql.planner import _substitute

        ji = spec.ji
        L, lovf = emit(ji.left, inputs)
        R, rovf = emit(ji.right, inputs)
        ovf = {**lovf, **rovf}
        starts, ends = inputs[spec.input_alias]
        seg_aggs, which = [], []
        for i, (_name, fn, arg, _d) in enumerate(op.aggs):
            if arg is None:
                continue  # count(*) counts joined live rows == cnt
            v, vv = evaluate(arg, L)
            if v.dim() == 0:
                v = v.expand(L.capacity)
            seg_aggs.append((fn, v.contiguous() if fn == "sum" else None,
                             vv.contiguous() if vv is not None else None))
            which.append(i)
        cnt, res = clustered_segments(starts, ends, L.sel, seg_aggs)
        seg = dict(zip(which, res))
        sel = R.sel & (cnt > 0)
        # group keys evaluate on the build side; the probe fk substitutes
        # to the build pk (equal on every surviving group by definition)
        sub = {ji.left_keys[0]: ji.right_keys[0]}
        cols, valid, dicts = {}, {}, {}
        for name, e in op.group_keys:
            e2 = _substitute(e, sub)
            v, vv = evaluate(e2, R)
            cols[name] = v
            if vv is not None:
                valid[name] = vv
            if isinstance(e2, E.ColRef) and e2.name in R.dicts:
                dicts[name] = R.dicts[e2.name]
        for i, (name, _fn, arg, _d) in enumerate(op.aggs):
            cols[name] = cnt if arg is None else seg[i]
        out = ColumnBatch(
            cols=cols,
            valid=valid,
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=_agg_schema(op, output_schema(op.child)),
            dicts=dicts,
        )
        return out, ovf

    # ---- program construction -----------------------------------------
    def compile(self, plan: LogicalOp, params: PhysicalParams):
        """The plan as a Python closure run(inputs, qparams) -> (out batch,
        stacked overflow vector), plus its input spec and the node ids of
        the overflow vector's entries."""
        self.compiles += 1
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

        # clustered-FK aggregates + ANN top-n: re-detect every compile
        # (deterministic from plan + catalog) and feed the precomputed
        # derived structures as inputs
        params.clustered_aggs.clear()
        params.vector_topns.clear()
        for nid2, op2 in nodes.items():
            if not self.clustered_agg_enabled:
                continue
            if isinstance(op2, TopN):
                vspec = self._vector_topn_spec(op2)
                if vspec is not None:
                    # an earlier bump() widened this node's nprobe: the
                    # recompile keeps it, or the retry loops forever
                    esc = params.ann_nprobe.get(nid2)
                    if esc is not None and esc > vspec.nprobe:
                        vspec = replace(vspec, nprobe=min(esc, vspec.lists))
                    params.ann_nprobe[nid2] = vspec.nprobe
                    params.ann_lists[nid2] = vspec.lists
                    params.vector_topns[nid2] = vspec
                    if all(a != vspec.input_alias for a, _t, _c in input_spec):
                        input_spec.append((
                            vspec.input_alias,
                            vspec.table,
                            (vspec.table, vspec.column, vspec.max_list),
                        ))
            if not isinstance(op2, Aggregate):
                continue
            spec = self._clustered_agg_spec(op2)
            if spec is not None:
                params.clustered_aggs[nid2] = spec
                if all(a != spec.input_alias for a, _t, _c in input_spec):
                    input_spec.append((
                        spec.input_alias,
                        spec.probe_table,
                        (spec.probe_table, spec.fk_col,
                         spec.build_table, spec.pk_col),
                    ))

        overflow_nodes: list[int] = sorted(
            set(params.join_cap) | set(params.scan_cap)
            | set(params.topn_cand)
            | {
                PACK_GUARD_BASE + nid
                for nid in params.pack_guard
                if nid not in params.groupby_nopack
            }
            | {
                ANN_PROBE_BASE + nid
                for nid, vs in params.vector_topns.items()
                if vs.nprobe < vs.lists
            }
        )

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
        nid = id_of[id(op)]
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
            ovf = {}
            sl = params.scan_slice.get(nid)
            if sl is not None and sl.key in qb.cols:
                cap = params.scan_cap[nid]
                n = self.catalog[op.table].nrows
                if cap < n:
                    qb, ovf[nid] = self._slice_sorted_scan(qb, sl, cap, n)
            if op.pushed_filter is not None:
                qb = qb.with_sel(compile_predicate(op.pushed_filter, qb))
            return qb, ovf

        if isinstance(op, Filter):
            child, ovf = emit(op.child, inputs)
            return child.with_sel(compile_predicate(op.pred, child)), ovf

        if isinstance(op, Project):
            child, ovf = emit(op.child, inputs)
            return self._project_batch(op, child), ovf

        if isinstance(op, JoinOp):
            return self._emit_join(op, nid, inputs, emit, params)

        if isinstance(op, Aggregate):
            return self._emit_aggregate(op, nid, inputs, emit, params)

        if isinstance(op, Distinct):
            child, ovf = emit(op.child, inputs)
            return self._dedup_batch(child, ovf)

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

        if isinstance(op, TopN):
            vspec = params.vector_topns.get(nid)
            if vspec is not None and vspec.input_alias in inputs:
                return self._emit_vector_topn(nid, vspec, inputs, emit)
            child, ovf = emit(op.child, inputs)
            cand = params.topn_cand.get(nid)
            if cand is not None and cand < child.capacity:
                got = self._topn_candidates(child, op.keys, cand)
                if got is not None:
                    mini, over = got
                    ovf = dict(ovf)
                    ovf[nid] = over
                    return (
                        self._topn_batch(mini, op.keys, op.n, op.offset),
                        ovf,
                    )
            return self._topn_batch(child, op.keys, op.n, op.offset), ovf

        if isinstance(op, SetOp):
            return self._emit_setop(op, nid, inputs, emit, params)

        if isinstance(op, Window):
            return self._emit_window(op, nid, inputs, emit, params)

        raise _not_ported(f"plan node {type(op).__name__}")

    def _topn_candidates(self, child: ColumnBatch, keys, C: int):
        """EXACT top-k candidate prefilter (kernel K7): the C best rows by
        the FIRST sort key; any true top-(n+offset) row under the full
        lexicographic order has a first-key value >= the worst
        candidate's, so when at most C live rows tie-or-beat that value
        the candidate set is a superset -- otherwise the tie count rides
        the overflow channel and the plan retries without the prefilter.
        None = ineligible (nullable, non-integer, or no key) and the
        generic sort path runs."""
        if not keys:
            return None
        e0, desc0 = keys[0]
        v, vv = evaluate(e0, child)
        if vv is not None or v.dim() != 1:
            return None
        if v.dtype.is_floating_point or v.dtype == torch.bool:
            return None  # float NaNs would outrank everything
        idx, cnt = topk_candidates(v.contiguous(), child.sel, desc0, C)
        cols, valid, csel = gather_payload(
            child.cols, child.valid, idx, child.sel
        )
        # guard BOTH clip hazards: boundary ties beyond C, and a LIVE row
        # whose flipped key equals the dead sentinel being displaced by
        # dead rows in the index tie-break (it would vanish with cnt <= C)
        # -- fewer live candidates than min(C, nlive) means something real
        # was dropped
        nlive = torch.sum(child.sel, dtype=torch.int64)
        live_cand = torch.sum(csel, dtype=torch.int64)
        short = torch.clamp(torch.clamp(nlive, max=C) - live_cand, min=0)
        over = torch.clamp(cnt - C, min=0) + short
        mini = ColumnBatch(
            cols=cols,
            valid=valid,
            sel=csel,
            nrows=live_cand,
            schema=child.schema,
            dicts=child.dicts,
        )
        return mini, over

    def _topn_batch(self, child: ColumnBatch, keys, n: int,
                    offset: int) -> ColumnBatch:
        """Fused ORDER BY + LIMIT: sort for the order (K3), materialize only
        the top n+offset rows (K4 over a few rows instead of a
        full-capacity payload permutation). The output keeps global order
        in its row order."""
        key_vals, desc = [], []
        for e, d in keys:
            v, _ = evaluate(e, child)
            if v.dim() == 0:
                v = v.expand(child.capacity)
            key_vals.append(v.contiguous())
            desc.append(d)
        order = sort_indices(key_vals, desc, child.sel)
        k = n + offset
        cap2 = min(child.capacity, max(8, -(-k // 8) * 8))
        take = order[:cap2]
        pos = torch.arange(cap2, dtype=torch.int64, device=child.device)
        nlive = torch.sum(child.sel, dtype=torch.int64)
        sel = (pos >= offset) & (pos < torch.clamp(nlive, max=k))
        cols, valid, _ = gather_payload(child.cols, child.valid, take)
        return ColumnBatch(
            cols=cols, valid=valid, sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=child.schema, dicts=child.dicts,
        )

    # ---- ANN vector top-n ---------------------------------------------
    def _vector_topn_spec(self, op: TopN):
        """Match ORDER BY vec_l2(col, q) [ASC] LIMIT k over a Scan of a
        table with an IVF index on `col`, through an optional Project (the
        hoisted $ordN) and any Filter chain or pushed scan filter. Index
        presence is the opt-in to approximate results; whether the route
        wins is costed against the brute-force matmul on the flops basis
        (centroid pass + probed re-rank against the full-table distance,
        in rows of d-dim work), or on the measured per-row rates of the
        plan profiler's store once both routes have been profiled. A
        filtered route seeds over-probe from the estimated
        selectivity and escalates at run time through the overflow
        channel."""
        if op.offset != 0 or len(op.keys) != 1:
            return None
        e, desc = op.keys[0]
        if desc:
            return None
        node = op.child
        proj = None
        if isinstance(node, Project):
            # the planner hoists ORDER BY exprs into the projection as
            # $ordN; resolve the key ColRef back to its expression
            proj = node
            if isinstance(e, E.ColRef):
                e = dict(node.exprs).get(e.name, e)
            node = node.child
        if not isinstance(e, E.Func) or e.name != "vec_l2":
            return None
        filters = []
        filt_top = node
        while isinstance(node, Filter):
            filters.append(node.pred)
            node = node.child
        if not isinstance(node, Scan):
            return None
        colref = e.args[0]
        if not isinstance(colref, E.ColRef) or "." not in colref.name:
            return None
        alias, col = colref.name.split(".", 1)
        if alias != node.alias:
            return None
        try:
            t = self.catalog[node.table]
        except KeyError:
            return None
        spec = getattr(t, "vector_indexes", {}).get(col)
        if spec is None:
            return None
        idx = self.ivf_host(node.table, col)
        if idx is None or idx.max_list == 0:
            return None
        lists = len(idx.lengths)
        base_nprobe = max(1, min(spec.nprobe, lists))
        nprobe = base_nprobe
        filtered = bool(filters) or node.pushed_filter is not None
        est_sel = 1.0
        if filtered:
            # the over-probe seed: probing nprobe / est_sel lists keeps the
            # EXPECTED live candidate count at the unfiltered level
            try:
                est_sel = float(self._est_rows(filt_top)) / max(
                    float(t.nrows), 1.0)
            except Exception:  # noqa: BLE001 - stats must not kill the route
                est_sel = 1.0
            est_sel = min(1.0, max(est_sel, 1e-6))
            boost = min(8, max(1, int(np.ceil(1.0 / max(est_sel, 0.125)))))
            nprobe = min(lists, nprobe * boost)
        d = int(np.asarray(idx.centroids).shape[1]) if lists else 1
        cand_rows = lists + nprobe * idx.max_list
        brute_rows = max(int(t.nrows), 1)
        ivf_cost = float(cand_rows * d)
        brute_cost = float(brute_rows * d)
        cost_basis = "flops"
        rates = None
        store = self.profile_store
        if store is not None:
            try:
                rates = store.ann_route_rates()
            except Exception:  # noqa: BLE001 - stats must not kill the route
                rates = None
        if rates is not None:
            ivf_cost = float(cand_rows) * rates[0]
            brute_cost = float(brute_rows) * rates[1]
            cost_basis = "measured"
        if ivf_cost >= brute_cost:
            # the index loses (a tiny table, nprobe near every list):
            # brute force runs exactly through the generic TopN
            return None
        return VectorTopNSpec(
            table=node.table,
            column=col,
            qual_col=colref.name,
            input_alias=f"#ivf:{node.table}.{col}",
            nprobe=nprobe,
            max_list=idx.max_list,
            nrows=t.nrows,
            k=op.n,
            key=e,
            scan=node,
            proj=proj,
            filters=tuple(filters),
            lists=lists,
            base_nprobe=base_nprobe,
            est_sel=est_sel,
            ivf_cost=ivf_cost,
            brute_cost=brute_cost,
            cost_basis=cost_basis,
        )

    def _emit_vector_topn(self, nid, spec: VectorTopNSpec, inputs, emit):
        """The IVF probe: the Scan (not the Project above it, whose
        distance column would cost the full matmul the index avoids), the
        fused filter masks, the nprobe nearest lists (K21), the exact
        re-rank of their row windows and the top k (K22), the k winners'
        payload (K4), and the Project re-applied over them."""
        child, ovf = emit(spec.scan, inputs)
        for pred in spec.filters:
            child = child.with_sel(compile_predicate(pred, child))
        cent, perm, offs, lens = inputs[spec.input_alias]
        q = evaluate_vector_literal(spec.key.args[1], child.device)
        probes = ivf_lists(cent, q, spec.nprobe)
        rows, sel, starved = ivf_probe(
            child.cols[spec.qual_col], child.sel, perm, offs, lens, probes,
            q, spec.max_list, spec.nrows, spec.k)
        if spec.nprobe < spec.lists:
            # fewer than k live candidates: bump() widens nprobe and the
            # retry recompiles. At nprobe == lists the probe is exhaustive
            # (exact), so no counter is emitted and the ladder ends.
            ovf = dict(ovf)
            ovf[ANN_PROBE_BASE + nid] = starved
        cols, valid, _ = gather_payload(child.cols, child.valid, rows)
        out = ColumnBatch(
            cols=cols,
            valid=valid,
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=child.schema,
            dicts=child.dicts,
        )
        if spec.proj is not None:
            out = self._project_batch(spec.proj, out)
        return out, ovf

    # ---- join emission -------------------------------------------------
    @staticmethod
    def _key_columns(exprs, batch: ColumnBatch) -> list[torch.Tensor]:
        out = []
        for e in exprs:
            v = evaluate(e, batch)[0]
            if v.dim() == 0:
                v = v.expand(batch.capacity)
            out.append(v.contiguous())
        return out

    @staticmethod
    def _pair_batch(left, right, pr, br, sel) -> ColumnBatch:
        """The expanded pairs as one batch: left columns gathered by the
        probe rows, right columns by the build rows (K4)."""
        cols, valid, _ = gather_payload(left.cols, left.valid, pr)
        rcols, rvalid, _ = gather_payload(right.cols, right.valid, br)
        cols.update(rcols)
        valid.update(rvalid)
        return ColumnBatch(
            cols=cols,
            valid=valid,
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=_join_schema(left.schema, right.schema),
            dicts={**left.dicts, **right.dicts},
        )

    def _emit_join(self, op: JoinOp, nid, inputs, emit, params):
        """Inner joins. A unique build with one integer key merges: an
        affine key column takes the direct-address route (candidate,
        verify and payload gather in one K5 launch), any other goes
        through the hash join of K9 and one payload gather; probe columns
        pass through untouched. Otherwise the build side sorts by its
        64-bit key (K12 hashes several columns, K3 + K4 sort), K10 expands
        the pairs into the node's capacity (the total rides the overflow
        channel) and multi-column keys are verified exactly per pair."""
        if op.kind in ("semi", "anti"):
            return self._emit_semi_anti(op, nid, inputs, emit, params)
        if op.kind == "left":
            return self._emit_left(op, nid, inputs, emit, params)
        if op.kind == "full":
            return self._emit_full(op, nid, inputs, emit, params)
        # every other kind (inner, cross) runs the inner body; a key-less
        # join gets constant keys below
        left, lovf = emit(op.left, inputs)
        right, rovf = emit(op.right, inputs)
        ovf = {**lovf, **rovf}
        lkeys = self._key_columns(op.left_keys, left)
        rkeys = self._key_columns(op.right_keys, right)
        dev = left.device
        if not lkeys:
            # cross join: a constant key matches every probe row to every
            # build row; a 1-row build (scalar subquery) merges as a
            # broadcast, a general cross join expands
            lkeys = [torch.zeros(left.capacity, dtype=torch.int32, device=dev)]
            rkeys = [torch.zeros(right.capacity, dtype=torch.int32,
                                 device=dev)]
        if self._merge_joinable(op):
            aff = self._affine_build_info(op) if op.left_keys else None
            cols = dict(left.cols)
            valid = dict(left.valid)
            if aff is not None:
                names, vnames = list(right.cols), list(right.valid)
                payload = [right.cols[n] for n in names] + [
                    right.valid[n] for n in vnames]
                sel, outs = affine_join(
                    lkeys[0], left.sel, aff[0], aff[1], rkeys[0], right.sel,
                    payload)
                cols.update(zip(names, outs[:len(names)]))
                valid.update(zip(vnames, outs[len(names):]))
            else:
                match = merge_join_unique(rkeys[0], right.sel, lkeys[0],
                                          left.sel)
                sel = left.sel & (match >= 0)
                rcols, rvalid, _ = gather_payload(
                    right.cols, right.valid, match.clamp(min=0))
                cols.update(rcols)
                valid.update(rvalid)
            out = ColumnBatch(
                cols=cols,
                valid=valid,
                sel=sel,
                nrows=torch.sum(sel, dtype=torch.int64),
                schema=_join_schema(left.schema, right.schema),
                dicts={**left.dicts, **right.dicts},
            )
        else:
            cap = params.join_cap[nid]
            skeys, order = sort_build_side(rkeys, right.sel)
            pr, br, valid_rows, total, _st, _of = expand_join(
                skeys, order, right.nrows, lkeys, left.sel, cap)
            sel = valid_rows
            if len(op.left_keys) > 1:
                sel = sel & _pair_keys_equal(lkeys, rkeys, pr, br)
            out = self._pair_batch(left, right, pr, br, sel)
            ovf = dict(ovf)
            ovf[nid] = torch.clamp(total - cap, min=0)
        if op.residual is not None:
            out = out.with_sel(compile_predicate(op.residual, out))
        return out, ovf

    def _emit_semi_anti(self, op: JoinOp, nid, inputs, emit, params):
        """Semi/anti join: the left rows with (without) a matching right
        row. No residual and one integer key: the affine probe (K5's probe
        entry) where the build key column is affine, else the sorted build
        side and a range search per probe key (K10's first phase), exact
        on true keys. No residual and several (or float) key columns: the
        open-addressing hash set of the right rows' key tuples and an
        existence probe (K14). With a residual: the candidate pairs expand
        (K10), the residual runs per pair, and each left row ORs its pairs
        (K11)."""
        left, lovf = emit(op.left, inputs)
        right, rovf = emit(op.right, inputs)
        ovf = {**lovf, **rovf}
        lkeys = self._key_columns(op.left_keys, left)
        rkeys = self._key_columns(op.right_keys, right)
        if op.residual is None:
            if len(lkeys) != 1 or not (_is_int(lkeys[0])
                                       and _is_int(rkeys[0])):
                ts = next_pow2(max(2 * rkeys[0].shape[0], 16))
                slot_tag, slot_row = build_hash_table(rkeys, right.sel, ts)
                has = hash_join_probe(slot_tag, slot_row, rkeys, lkeys,
                                      left.sel) >= 0
                sel = left.sel & (has if op.kind == "semi" else ~has)
                return left.with_sel(sel), ovf
            aff = self._affine_build_info(op)
            if aff is not None:
                has = _affine_probe(rkeys[0], right.sel, lkeys[0], left.sel,
                                    aff) >= 0
            else:
                skeys, _order = sort_build_side(rkeys, right.sel)
                has = probe_has_match(skeys, right.nrows, lkeys[0], left.sel)
        else:
            cap = params.join_cap[nid]
            skeys, order = sort_build_side(rkeys, right.sel)
            pr, br, valid_rows, total, starts, offs = expand_join(
                skeys, order, right.nrows, lkeys, left.sel, cap)
            pair_sel = valid_rows
            if len(op.left_keys) > 1:
                pair_sel = pair_sel & _pair_keys_equal(lkeys, rkeys, pr, br)
            pairs = self._pair_batch(left, right, pr, br, pair_sel)
            pair_ok = compile_predicate(op.residual, pairs)
            del pairs
            has = probe_run_any(pair_ok, starts, offs)
            ovf = dict(ovf)
            ovf[nid] = torch.clamp(total - cap, min=0)
        sel = left.sel & (has if op.kind == "semi" else ~has)
        return left.with_sel(sel), ovf

    def _emit_left(self, op: JoinOp, nid, inputs, emit, params):
        """Left outer join by expansion: the matched pairs (K10, the
        residual per pair) plus, in a tail of the left capacity, each left
        row that no pair kept, with NULL right columns (K11 finds them).
        The output is [cap matched pairs] ++ [nl unmatched left rows], and
        the right columns become nullable."""
        left, lovf = emit(op.left, inputs)
        right, rovf = emit(op.right, inputs)
        ovf = {**lovf, **rovf}
        lkeys = self._key_columns(op.left_keys, left)
        rkeys = self._key_columns(op.right_keys, right)
        cap = params.join_cap[nid]
        skeys, order = sort_build_side(rkeys, right.sel)
        pr, br, valid_rows, total, starts, offs = expand_join(
            skeys, order, right.nrows, lkeys, left.sel, cap)
        pair_sel = valid_rows
        if len(op.left_keys) > 1:
            pair_sel = pair_sel & _pair_keys_equal(lkeys, rkeys, pr, br)
        pairs = self._pair_batch(left, right, pr, br, pair_sel)
        if op.residual is not None:
            pair_sel = compile_predicate(op.residual, pairs)
        nl = left.capacity
        dev = left.device
        has = probe_run_any(pair_sel, starts, offs)
        cols, valid = {}, {}
        for n, c in left.cols.items():
            cols[n] = torch.cat([pairs.cols[n], c])
        for n, v in left.valid.items():
            valid[n] = torch.cat([pairs.valid[n], v])
        for n, c in right.cols.items():
            cols[n] = torch.cat([pairs.cols[n],
                                 torch.zeros(nl, dtype=c.dtype, device=dev)])
            matched = (pairs.valid[n] if n in right.valid
                       else torch.ones(cap, dtype=torch.bool, device=dev))
            valid[n] = torch.cat([matched, torch.zeros(nl, dtype=torch.bool,
                                                       device=dev)])
        del pairs
        sel = torch.cat([pair_sel, left.sel & ~has])
        rs_nullable = Schema(tuple(
            Field(f.name, f.dtype.with_nullable(True))
            for f in right.schema.fields
        ))
        out = ColumnBatch(
            cols=cols,
            valid=valid,
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=_join_schema(left.schema, rs_nullable),
            dicts={**left.dicts, **right.dicts},
        )
        ovf = dict(ovf)
        ovf[nid] = torch.clamp(total - cap, min=0)
        return out, ovf

    def _emit_full(self, op: JoinOp, nid, inputs, emit, params):
        """Full outer join: [cap matched pairs] ++ [nl left rows no pair
        kept, right NULL] ++ [nr right rows no pair kept, left NULL]; both
        sides' columns become nullable. The pairs expand as in the left
        join (K10, the residual per pair); K11 finds the unmatched left
        rows, and its second entry marks the build rows some kept pair
        joins (the reference's scatter-max of pair_sel by build row)."""
        left, lovf = emit(op.left, inputs)
        right, rovf = emit(op.right, inputs)
        ovf = {**lovf, **rovf}
        lkeys = self._key_columns(op.left_keys, left)
        rkeys = self._key_columns(op.right_keys, right)
        cap = params.join_cap[nid]
        skeys, order = sort_build_side(rkeys, right.sel)
        pr, br, valid_rows, total, starts, offs = expand_join(
            skeys, order, right.nrows, lkeys, left.sel, cap)
        pair_sel = valid_rows
        if len(op.left_keys) > 1:
            pair_sel = pair_sel & _pair_keys_equal(lkeys, rkeys, pr, br)
        pairs = self._pair_batch(left, right, pr, br, pair_sel)
        if op.residual is not None:
            pair_sel = compile_predicate(op.residual, pairs)
        nl, nr = left.capacity, right.capacity
        dev = left.device
        has_l = probe_run_any(pair_sel, starts, offs)
        has_r = mark_build(br, pair_sel, nr)
        cols, valid = {}, {}
        for side, other, tail_first in ((left, nr, True), (right, nl, False)):
            n_own = side.capacity
            for n, c in side.cols.items():
                zeros = torch.zeros(other, dtype=c.dtype, device=dev)
                mv = (pairs.valid[n] if n in side.valid
                      else torch.ones(cap, dtype=torch.bool, device=dev))
                tv = side.valid.get(n)
                if tv is None:
                    tv = torch.ones(n_own, dtype=torch.bool, device=dev)
                nulls = torch.zeros(other, dtype=torch.bool, device=dev)
                if tail_first:
                    cols[n] = torch.cat([pairs.cols[n], c, zeros])
                    valid[n] = torch.cat([mv, tv, nulls])
                else:
                    cols[n] = torch.cat([pairs.cols[n], zeros, c])
                    valid[n] = torch.cat([mv, nulls, tv])
        del pairs
        sel = torch.cat([pair_sel, left.sel & ~has_l, right.sel & ~has_r])
        out = ColumnBatch(
            cols=cols,
            valid=valid,
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=output_schema(op),
            dicts={**left.dicts, **right.dicts},
        )
        ovf = dict(ovf)
        ovf[nid] = torch.clamp(total - cap, min=0)
        return out, ovf

    # ---- set-operation emission ----------------------------------------
    @staticmethod
    def _cast_col(c, from_t: DataType, to_t: DataType):
        """Physically convert one column to the promoted set-op type."""
        to_dt = torch_dtype(to_t.storage_np)
        if from_t.kind == to_t.kind and not to_t.is_decimal:
            return c if c.dtype == to_dt else c.to(to_dt)
        if from_t.is_decimal and to_t.is_decimal:
            shift = 10 ** (to_t.scale - from_t.scale)
            return c.to(to_dt) * shift if shift != 1 else c.to(to_dt)
        if to_t.kind is TypeKind.FLOAT64:
            if from_t.is_decimal:
                return _div_scale(c.to(torch.float64), from_t.decimal_factor)
            return c.to(torch.float64)
        if to_t.is_integer:
            return c.to(to_dt)
        raise NotImplementedError(f"set-op cast {from_t} -> {to_t}")

    @staticmethod
    def _setop_key_cols(cols, valids, schema: Schema):
        """Compare key columns with SQL set-op NULL semantics (NULLs compare
        equal): NULL payloads normalize to 0 and the validity bit joins the
        key."""
        keys = []
        for f in schema.fields:
            c = cols[f.name]
            v = valids.get(f.name)
            if v is not None:
                keys.append(torch.where(
                    v, c, torch.zeros((), dtype=c.dtype, device=c.device)))
                keys.append(v)
            else:
                keys.append(c)
        return [k.contiguous() for k in keys]

    def _setop_promote(self, op: SetOp, left: ColumnBatch,
                       right: ColumnBatch):
        """Align both sides positionally onto the promoted schema: merged
        dictionaries (codes remapped by one gather), numeric casts,
        materialized validity. Returns (lb, rb, out_schema, dicts)."""
        out_schema = setop_schema(left.schema, right.schema)
        lcols, rcols, lvalid, rvalid, dicts = {}, {}, {}, {}, {}
        for i, f in enumerate(out_schema.fields):
            ln = left.schema.fields[i].name
            rn = right.schema.fields[i].name
            lt = left.schema.fields[i].dtype
            rt = right.schema.fields[i].dtype
            lc, rc = left.cols[ln], right.cols[rn]
            if f.dtype.kind is TypeKind.VARCHAR:
                md, lmap, rmap = Dictionary.merge(
                    left.dicts.get(ln), right.dicts.get(rn))
                if md is not None:
                    dicts[f.name] = md
                if lmap is not None:
                    lc = _remap_codes(lc, lmap)
                if rmap is not None:
                    rc = _remap_codes(rc, rmap)
            else:
                lc = self._cast_col(lc, lt, f.dtype)
                rc = self._cast_col(rc, rt, f.dtype)
            lcols[f.name], rcols[f.name] = lc, rc
            if f.dtype.nullable:
                lv, rv = left.valid.get(ln), right.valid.get(rn)
                lvalid[f.name] = (lv if lv is not None else torch.ones(
                    left.capacity, dtype=torch.bool, device=left.device))
                rvalid[f.name] = (rv if rv is not None else torch.ones(
                    right.capacity, dtype=torch.bool, device=right.device))
        lb = ColumnBatch(cols=lcols, valid=lvalid, sel=left.sel,
                         nrows=left.nrows, schema=out_schema, dicts=dicts)
        rb = ColumnBatch(cols=rcols, valid=rvalid, sel=right.sel,
                         nrows=right.nrows, schema=out_schema, dicts=dicts)
        return lb, rb, out_schema, dicts

    def _emit_setop(self, op: SetOp, nid, inputs, emit, params):
        left, lovf = emit(op.left, inputs)
        right, rovf = emit(op.right, inputs)
        ovf = {**lovf, **rovf}
        lb, rb, out_schema, dicts = self._setop_promote(op, left, right)
        return self._setop_combine(op, lb, rb, out_schema, dicts, ovf)

    def _setop_combine(self, op: SetOp, left: ColumnBatch,
                       right: ColumnBatch, out_schema, dicts, ovf):
        """Combine two promoted same-schema sides. UNION concatenates (and
        dedups through the Distinct's sort); INTERSECT/EXCEPT dedup the
        left side and probe each of its rows in the hash set of the right
        side's key tuples (K14); the ALL forms count runs of one combined
        sort (_emit_setop_all)."""
        if op.kind == "union":
            cols = {n: torch.cat([left.cols[n], right.cols[n]])
                    for n in left.cols}
            valid = {n: torch.cat([left.valid[n], right.valid[n]])
                     for n in left.valid}
            sel = torch.cat([left.sel, right.sel])
            out = ColumnBatch(cols=cols, valid=valid, sel=sel,
                              nrows=torch.sum(sel, dtype=torch.int64),
                              schema=out_schema, dicts=dicts)
            if op.all:
                return out, ovf
            return self._dedup_batch(out, ovf)
        if op.all:
            return self._emit_setop_all(op.kind, left, right, out_schema,
                                        dicts, ovf)
        db, ovf = self._dedup_batch(left, ovf)
        lkeys = self._setop_key_cols(db.cols, db.valid, out_schema)
        rkeys = self._setop_key_cols(right.cols, right.valid, out_schema)
        # a table sized by the right capacity never fills: no overflow
        bts = next_pow2(max(2 * right.capacity, 16))
        slot_tag, slot_row = build_hash_table(rkeys, right.sel, bts)
        has = hash_join_probe(slot_tag, slot_row, rkeys, lkeys, db.sel) >= 0
        sel = db.sel & (has if op.kind == "intersect" else ~has)
        return db.with_sel(sel), ovf

    def _emit_setop_all(self, kind, left: ColumnBatch, right: ColumnBatch,
                        out_schema, dicts, ovf):
        """INTERSECT ALL / EXCEPT ALL (bag semantics): one stable sort of
        both sides (K3) with the side flag as the last key, so in each run
        of equal rows with l left and r right copies the left copies come
        first; the k-th left copy survives iff k < r (INTERSECT ALL) or
        k >= r (EXCEPT ALL). Run starts, run ends and the count of left
        rows before a position are K13 scans."""
        nl, nr = left.capacity, right.capacity
        n = nl + nr
        dev = left.device
        cols = {f.name: torch.cat([left.cols[f.name], right.cols[f.name]])
                for f in out_schema.fields}
        valid = {name: torch.cat([left.valid[name], right.valid[name]])
                 for name in left.valid}
        live = torch.cat([left.sel, right.sel])
        side = torch.cat([torch.zeros(nl, dtype=torch.int32, device=dev),
                          torch.ones(nr, dtype=torch.int32, device=dev)])
        operands, spec = _row_key_operands(cols, valid, out_schema)
        order = sort_indices(operands + [side],
                             [False] * (len(operands) + 1), live)
        g = gather_columns(operands + [live, side], order)
        svals, slive, sside = g[:-2], g[-2], g[-1]
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        # runs are delimited by value (and liveness) changes, not by side
        new_run = boundaries(svals + [slive])
        run_start = segment_starts(new_run)
        run_end = peer_ends(new_run) + 1  # exclusive: the next run's start
        is_left = sside == 0
        cum_left = prefix_sum(is_left.to(torch.int64))

        def left_before(x):
            return torch.where(x > 0, _take(cum_left, x - 1), 0)

        l_run = left_before(run_end) - left_before(run_start)
        r_run = (run_end - run_start) - l_run
        left_rank = pos - run_start
        keep = left_rank < r_run if kind == "intersect" \
            else left_rank >= r_run
        sel = slive & is_left & keep
        out_cols, out_valid = {}, {}
        i = 0
        for name, nullable in spec:
            out_cols[name] = svals[i]
            i += 1
            if nullable:
                out_valid[name] = svals[i]
                i += 1
        out = ColumnBatch(cols=out_cols, valid=out_valid, sel=sel,
                          nrows=torch.sum(sel, dtype=torch.int64),
                          schema=out_schema, dicts=dicts)
        return out, ovf

    # ---- window emission ------------------------------------------------
    def _emit_window(self, op: Window, nid, inputs, emit, params):
        """Window functions. Per (partition keys, order keys) spec: one
        stable sort (K3) and the keys in sorted order (K4); segment and
        peer-group flags, starts and ends, running sums and segmented
        min/max as scans over the sorted rows (K13); every function of the
        spec computed in sorted order and written back to row order in one
        scatter through the permutation (K15), where the reference gathers
        by an argsort inverse."""
        child, ovf = emit(op.child, inputs)
        n = child.capacity
        dev = child.device
        i64 = torch.int64
        out_cols = dict(child.cols)
        out_valid = dict(child.valid)
        out_dicts = dict(child.dicts)
        fields = list(child.schema.fields)

        by_spec: dict[tuple, list] = {}
        for name, fn, arg, pk, ok, extra in op.funcs:
            by_spec.setdefault((pk, ok), []).append((name, fn, arg, extra))

        idx = torch.arange(n, dtype=i64, device=dev)
        for (pk, ok), funcs in by_spec.items():
            pkv = self._key_columns(pk, child)
            okv = self._key_columns([e for e, _d in ok], child)
            odesc = [d for _e, d in ok]
            order = sort_indices(pkv + okv, [False] * len(pkv) + odesc,
                                 child.sel)
            g = gather_columns([child.sel] + pkv + okv, order)
            ssel, spk, sok = g[0], g[1:1 + len(pkv)], g[1 + len(pkv):]
            # dead rows sort to the tail; the live->dead transition starts
            # its OWN segment, or frames that end at the segment end (ntile,
            # lead defaults, UNBOUNDED FOLLOWING) would count dead rows
            new_seg = boundaries(spk + [ssel])
            seg_start = segment_starts(new_seg)
            seg_end = peer_ends(new_seg)
            if ok:
                new_peer = boundaries(spk + [ssel] + sok)
                peer_start = segment_starts(new_peer)
                pend_idx = peer_ends(new_peer)
            else:
                # no ORDER BY: the frame is the whole partition
                new_peer = peer_start = None
                pend_idx = seg_end

            def sorted_arg(e):
                """(values, live-and-valid) of an expression in sorted
                order."""
                v, vv = evaluate(e, child)
                if v.dim() == 0:
                    v = v.expand(n)
                if vv is None:
                    return _take(v, order), ssel
                vs, vvs = gather_columns([v.contiguous(), vv.contiguous()],
                                         order)
                return vs, ssel & vvs

            def frame_lo_hi(extra):
                """Inclusive frame bounds [lo, hi] per row in sorted
                order. None = the SQL default frame (partition start ..
                last peer with ORDER BY, the whole partition without)."""
                if extra is None:
                    return seg_start, pend_idx
                unit, lo_b, hi_b = extra
                if unit == "rows":
                    lo = seg_start if lo_b is None else torch.maximum(
                        seg_start, idx + lo_b)
                    hi = seg_end if hi_b is None else torch.minimum(
                        seg_end, idx + hi_b)
                    return lo, hi
                # RANGE: value bounds on the single order key; CURRENT
                # ROW maps to the peer group's edges
                lo = hi = None
                if lo_b is None:
                    lo = seg_start
                elif lo_b == 0:
                    lo = peer_start
                if hi_b is None:
                    hi = seg_end
                elif hi_b == 0:
                    hi = pend_idx
                if lo is not None and hi is not None:
                    return lo, hi
                return self._range_bounds(
                    ok, odesc, sok, ssel, new_seg, seg_start, seg_end,
                    child, lo, hi, lo_b, hi_b)

            def csum_range(masked_vals, lo, hi):
                """Sum over [lo, hi] from one global inclusive prefix sum
                (frames never cross segments)."""
                c = prefix_sum(masked_vals)
                hi_v = _take(c, hi)
                lo_v = torch.where(lo > 0, _take(c, lo - 1),
                                   torch.zeros((), dtype=c.dtype, device=dev))
                return torch.where(hi >= lo, hi_v - lo_v,
                                   torch.zeros((), dtype=c.dtype, device=dev))

            pending, pending_valid = [], []
            for name, fn, arg, extra in funcs:
                res_valid = None
                if fn == "row_number":
                    res = idx - seg_start + 1
                elif fn == "rank":
                    res = peer_start - seg_start + 1
                elif fn == "dense_rank":
                    dcum = prefix_sum(new_peer.to(i64))
                    res = dcum - _take(dcum, seg_start) + 1
                elif fn == "ntile":
                    k = int(extra)
                    cnt = seg_end - seg_start + 1
                    j = idx - seg_start
                    q = cnt // k
                    r = cnt % k
                    cut = r * (q + 1)
                    res = torch.where(
                        j < cut, j // (q + 1),
                        r + (j - cut) // torch.clamp(q, min=1)) + 1
                elif fn in ("lag", "lead"):
                    off, dflt = extra
                    av_s, srcvalid = sorted_arg(arg)
                    src = idx - off if fn == "lag" else idx + off
                    inside = src >= seg_start if fn == "lag" \
                        else src <= seg_end
                    val = _take(av_s, src)
                    vvalid = _take(srcvalid, src)
                    if dflt is None:
                        res = torch.where(inside, val,
                                          torch.zeros((), dtype=val.dtype,
                                                      device=dev))
                        res_valid = inside & vvalid
                    else:
                        dv, dvv = evaluate(dflt, child)
                        dv_s = _take(dv.expand(n) if dv.dim() == 0 else dv,
                                     order)
                        dvalid = (torch.ones(n, dtype=torch.bool, device=dev)
                                  if dvv is None else _take(dvv, order))
                        res = torch.where(inside, val, dv_s.to(val.dtype))
                        res_valid = torch.where(inside, vvalid, dvalid)
                elif fn in ("first_value", "last_value"):
                    av_s, srcvalid = sorted_arg(arg)
                    lo, hi = frame_lo_hi(extra)
                    at = lo if fn == "first_value" else hi
                    res = _take(av_s, at)
                    res_valid = (hi >= lo) & _take(srcvalid, at)
                else:
                    # frame aggregates: count / sum from prefix-sum range
                    # reads; min/max from one-end-bounded segmented scans
                    if arg is None:
                        av_s, vmask = None, ssel
                    else:
                        av_s, vmask = sorted_arg(arg)
                    lo, hi = frame_lo_hi(extra)
                    frame_cnt = csum_range(vmask.to(i64), lo, hi)
                    if fn == "count":
                        res = frame_cnt
                    elif fn == "sum":
                        acc = av_s.dtype if av_s.dtype.is_floating_point \
                            else i64
                        mv = torch.where(vmask, av_s.to(acc),
                                         torch.zeros((), dtype=acc,
                                                     device=dev))
                        res = csum_range(mv, lo, hi)
                        res_valid = frame_cnt > 0
                    elif fn in ("min", "max"):
                        is_min = fn == "min"
                        mv = torch.where(vmask, av_s, torch.full(
                            (), agg_identity(av_s.dtype, is_min),
                            dtype=av_s.dtype, device=dev))
                        if extra is None or extra[1] is None:
                            res = _take(segmented_scan_minmax(
                                mv, new_seg, is_min), hi)
                        else:
                            # hi unbounded (the resolver guarantees one end)
                            res = _take(suffix_scan_minmax(
                                mv, new_seg, is_min), lo)
                        res_valid = frame_cnt > 0
                    else:
                        raise NotImplementedError(f"window function {fn}")

                dt = window_out_type(fn, arg, child.schema)
                pending.append((name, res.to(torch_dtype(dt.storage_np))))
                if res_valid is not None:
                    pending_valid.append((name, res_valid))
                    dt = dt.with_nullable(True)
                fields.append(Field(name, dt))
                if (
                    fn in ("min", "max", "lag", "lead",
                           "first_value", "last_value")
                    and isinstance(arg, E.ColRef)
                    and arg.name in child.dicts
                ):
                    out_dicts[name] = child.dicts[arg.name]

            # one write-back scatter per spec group (K15)
            back = scatter_rows(
                [c.contiguous() for _n, c in pending]
                + [v.contiguous() for _n, v in pending_valid], order)
            out_cols.update(zip([nm for nm, _c in pending],
                                back[:len(pending)]))
            out_valid.update(zip([nm for nm, _v in pending_valid],
                                 back[len(pending):]))

        out = ColumnBatch(
            cols=out_cols, valid=out_valid, sel=child.sel, nrows=child.nrows,
            schema=Schema(tuple(fields)), dicts=out_dicts,
        )
        return out, ovf

    def _range_bounds(self, ok, odesc, sok, ssel, new_seg, seg_start,
                      seg_end, child, lo, hi, lo_b, hi_b):
        """The value-offset ends of a RANGE frame over the single order key
        in sorted order. The reference packs (segment rank, key - kmin)
        into one nondecreasing int64 and searches it globally while
        nseg * span < 2^62, else binary-searches each row's own segment
        (34 rounds), choosing at run time with lax.cond. Here both searches
        run (K13) and a torch.where keeps the one the reference chooses:
        the choice stays on the device, at the cost of one more search per
        frame end."""
        i64 = torch.int64
        dev = ssel.device
        imax, imin = torch.iinfo(i64).max, torch.iinfo(i64).min
        kk = sok[0].to(i64)
        kt = infer_type(ok[0][0], child.schema)
        if kt.is_decimal:
            # RANGE offsets are in value units; the column stores scaled ints
            lo_b = None if lo_b is None else lo_b * kt.decimal_factor
            hi_b = None if hi_b is None else hi_b * kt.decimal_factor
        if odesc[0]:
            # ~k = -k - 1 reverses the order without int64-min overflow;
            # the uniform shift cancels in every key-target comparison
            kk = ~kk
        kk = kk.contiguous()
        live_k = torch.where(ssel, kk, torch.zeros((), dtype=i64, device=dev))
        kmin = scalar_reduce("min", ssel, kk)
        kmax = scalar_reduce("max", ssel, kk)
        one = torch.ones((), dtype=i64, device=dev)
        span = torch.maximum(kmax - kmin + 1, one)
        seg_rank = prefix_sum(new_seg.to(i64)) - 1
        nseg_total = torch.maximum(seg_rank[-1] + 1, one)
        lim = torch.div(torch.full((), 1 << 62, dtype=i64, device=dev),
                        nseg_total, rounding_mode="floor")
        pack_ok = span <= lim
        span_c = torch.minimum(span, lim)
        zero = torch.zeros((), dtype=i64, device=dev)
        packed = torch.where(
            ssel,
            seg_rank * span_c + torch.minimum(
                torch.maximum(live_k - kmin, zero), span_c),
            torch.full((), imax, dtype=i64, device=dev)).contiguous()
        seg_hi = seg_end + 1

        def sat_add(v, off):
            # saturating v + off: a wrapped target would flip comparisons
            t = v + off
            if off >= 0:
                return torch.where(t < v, imax, t)
            return torch.where(t > v, imin, t)

        def bound_at(off, side):
            # out-of-domain targets give EMPTY frames (lo > hi), never the
            # edge rows
            off = max(min(off, imax), imin)
            if side == "lo":
                rel = torch.minimum(torch.maximum(
                    sat_add(live_k - kmin, off), zero), span_c)
                p = bound_search(packed, seg_rank * span_c + rel)
                q = bound_search(kk, sat_add(live_k, off), seg_start, seg_hi)
                return torch.where(pack_ok, p, q)
            rel = torch.minimum(torch.maximum(
                sat_add(live_k - kmin, off), -one), span_c - 1)
            p = bound_search(packed, seg_rank * span_c + rel, right=True)
            q = bound_search(kk, sat_add(live_k, off), seg_start, seg_hi,
                             right=True)
            return torch.where(pack_ok, p, q) - 1

        if lo is None:
            lo = bound_at(lo_b, "lo")
        if hi is None:
            hi = bound_at(hi_b, "hi")
        return lo, hi

    def _dedup_batch(self, b: ColumnBatch, ovf):
        """Distinct over all columns, NULLs comparing equal: one stable
        sort over every column (K3; a nullable column contributes its
        values zeroed under NULL, then its validity), the sorted operands
        and live flags gathered (K4), and run boundaries marking the one
        surviving row of each run -- no hash table, no capacity. NaN is
        not equal to NaN at a boundary, as in the reference."""
        keys, spec = _row_key_operands(b.cols, b.valid, b.schema)
        order = sort_indices(keys, [False] * len(keys), b.sel)
        gathered = gather_columns(keys + [b.sel], order)
        svals, ssel = gathered[:-1], gathered[-1]
        new = boundaries([~ssel] + svals)
        sel = new & ssel
        cols, valid = {}, {}
        i = 0
        for name, nullable in spec:
            cols[name] = svals[i]
            i += 1
            if nullable:
                valid[name] = svals[i]
                i += 1
        if b.device.type == "cuda":
            ENTRY_LAUNCHES["dedup_batch"] += 1
        out = ColumnBatch(
            cols=cols, valid=valid, sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=b.schema, dicts=b.dicts,
        )
        return out, ovf

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

    def _emit_aggregate(self, op: Aggregate, nid, inputs, emit, params):
        if any(fn == "approx_ndv" for _n, fn, _a, _d in op.aggs) and (
            op.group_keys or op.grouping_sets is not None
        ):
            # grouped approx NDV: per-group registers would need a [groups,
            # 16K] sketch; the reference runs the exact first-occurrence
            # distinct count instead, and so does the port
            op = replace(op, aggs=tuple(
                (n, "count", a, True) if fn == "approx_ndv"
                else (n, fn, a, d)
                for n, fn, a, d in op.aggs
            ))
        if op.grouping_sets is not None:
            return self._emit_grouping_sets(op, nid, inputs, emit, params)
        spec = params.clustered_aggs.get(nid)
        if spec is not None and spec.input_alias in inputs:
            return self._emit_clustered_agg(op, spec, inputs, emit)
        child, ovf = emit(op.child, inputs)
        return self._aggregate_batch(op, nid, child, ovf, params)

    def _emit_grouping_sets(self, op: Aggregate, nid, inputs, emit, params):
        """ROLLUP/CUBE/GROUPING SETS: the child batch is emitted ONCE and
        aggregated once per set on the ordinary group-by routes; the
        results stack, with the keys a set lacks NULL-filled. (The
        reference re-emits the child per set and relies on XLA's CSE to
        merge the copies; this executor runs eagerly, so it shares the
        batch instead. The results are the same.)"""
        child, ovf = emit(op.child, inputs)
        out_schema = _agg_schema(op, child.schema)
        parts = []
        ovf_all = dict(ovf)
        for si, idxs in enumerate(op.grouping_sets):
            sub = Aggregate(op.child, tuple(op.group_keys[i] for i in idxs),
                            op.aggs)
            # a pseudo node id: nothing seeded, so each set takes the
            # parameter-free routes (direct or unpacked sort)
            pseudo = -(1_000_000 + nid * 64 + si)
            b, o = self._aggregate_batch(sub, pseudo, child, ovf, params)
            ovf_all.update(o)
            parts.append((idxs, b))
        key_names = [n for n, _e in op.group_keys]
        cols: dict[str, list] = {n: [] for n in out_schema.names()}
        valid: dict[str, list] = {}
        sels = []
        for idxs, b in parts:
            cap = b.capacity
            dev = b.device
            present = {key_names[i] for i in idxs}
            for f in out_schema.fields:
                n = f.name
                dt = torch_dtype(f.dtype.storage_np)
                if n in present or n not in key_names:
                    cols[n].append(b.cols[n].to(dt))
                    if f.dtype.nullable:
                        v = b.valid.get(n)
                        valid.setdefault(n, []).append(
                            v if v is not None else torch.ones(
                                cap, dtype=torch.bool, device=dev))
                else:  # a key this set lacks: NULL
                    cols[n].append(torch.zeros(cap, dtype=dt, device=dev))
                    valid.setdefault(n, []).append(
                        torch.zeros(cap, dtype=torch.bool, device=dev))
            sels.append(b.sel)
        sel = torch.cat(sels)
        out = ColumnBatch(
            cols={n: torch.cat(v) for n, v in cols.items()},
            valid={n: torch.cat(v) for n, v in valid.items()},
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=out_schema,
            dicts={n: d for _idxs, b in parts for n, d in b.dicts.items()},
        )
        return out, ovf_all

    def _aggregate_batch(self, op: Aggregate, nid, child: ColumnBatch, ovf,
                         params):
        """One Aggregate over its child's batch: the direct, sort-based or
        scalar route."""
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
                v, vv = evaluate(arg, child)
                if v.dim() == 0:
                    v = v.expand(child.capacity)
                am = child.sel if vv is None else child.sel & vv
                if distinct and fn in ("count", "sum", "avg"):
                    # DISTINCT: only the first live row of each (group
                    # keys, value) feeds the aggregate; min/max need no
                    # dedup. The keys' validity planes join the dedup key,
                    # so the NULL group shares no first rows with group 0
                    dk = key_vals + [kv.to(torch.int32)
                                     for kv in key_valids if kv is not None]
                    am = am & distinct_first_mask(dk, v, am)
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
            # sort-based group-by: K3 order, K4 key gather, K8 reduction;
            # no hash table, no capacity
            key_vals = [
                (v.expand(child.capacity) if v.dim() == 0 else v).contiguous()
                for v in key_vals
            ]
            pack_spec = (
                params.pack_guard.get(nid)
                if nid not in params.groupby_nopack else None
            )
            if n_nullable:
                # validity planes don't fit the static pack spec
                pack_spec = None
            if pack_spec is not None:
                # pack all keys into ONE int64 sort key (static bits from
                # stats/dict domains); a validity counter rides the
                # overflow channel -- domain drift disables packing and
                # recompiles rather than mis-grouping
                pk = torch.zeros(child.capacity, dtype=torch.int64,
                                 device=dev)
                invalid = torch.zeros(child.capacity, dtype=torch.bool,
                                      device=dev)
                for v, (vmin, bits) in zip(key_vals, pack_spec):
                    off = v.to(torch.int64) - vmin
                    invalid = invalid | (off < 0) | (off >= (1 << bits))
                    pk = (pk << bits) | off.clamp(0, (1 << bits) - 1)
                ovf = dict(ovf)
                ovf[PACK_GUARD_BASE + nid] = torch.sum(
                    invalid & child.sel, dtype=torch.int64)
                skeys_p, sel, agg_cols, _order = sort_groupby(
                    [pk], child.sel, agg_ops, agg_vals, agg_masks)
                # decode the original key columns from the packed bits
                cols = {}
                shift = 0
                for (name, _e), v, (vmin, bits) in zip(
                    reversed(op.group_keys), reversed(key_vals),
                    reversed(pack_spec),
                ):
                    part = (skeys_p[0] >> shift) & ((1 << bits) - 1)
                    cols[name] = (part + vmin).to(v.dtype)
                    shift += bits
            else:
                vplanes = [
                    vv.to(torch.int32) for vv in key_valids
                    if vv is not None
                ]
                skeys, sel, agg_cols, _order = sort_groupby(
                    key_vals + vplanes, child.sel, agg_ops, agg_vals,
                    agg_masks)
                cols = {}
                for (name, _e), kv in zip(op.group_keys, skeys):
                    cols[name] = kv
                vi = len(op.group_keys)
                for (name, _e), vv in zip(op.group_keys, key_valids):
                    if vv is not None:
                        out_valid[name] = skeys[vi].to(torch.bool)
                        vi += 1
            for (name, _, _, _), av in zip(op.aggs, agg_cols):
                cols[name] = av
        else:
            # scalar aggregate: single-row output, per-agg masks; SQL:
            # sum/min/max over ZERO rows is NULL (count is 0)
            cols = {}
            for (name, _, _, _), aop, av, am in zip(
                op.aggs, agg_ops, agg_vals, agg_masks
            ):
                (v,) = scalar_aggregate(am, [aop], [av])
                cols[name] = v[None]
                if aop not in ("count", "approx_ndv"):
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

    # ---- sorted-projection scan routing ---------------------------------
    _RANGE_KINDS = (TypeKind.DATE, TypeKind.INT8, TypeKind.INT16,
                    TypeKind.INT32, TypeKind.INT64)

    def _route_projections(self, plan: LogicalOp) -> LogicalOp:
        """Swap eligible Scans to sorted projections of their table (the
        index-selection step: a selective range predicate on a
        projection's sort key and covered columns). The swap alone is
        layout-only (same rows, another order) and correct under every
        executor; the slice rides separately in params.scan_slice where
        scan_slice_enabled."""
        self._pending_slices = {}
        needed = self._needed_columns(plan)

        def rec(op):
            # identity-preserving: untouched subtrees come back as they are
            if isinstance(op, Scan):
                out = self._projection_choice(op, needed.get(op.alias, set()))
                return out if out is not None else op
            if isinstance(op, (JoinOp, SetOp)):
                left, right = rec(op.left), rec(op.right)
                if left is op.left and right is op.right:
                    return op
                return replace(op, left=left, right=right)
            if hasattr(op, "child"):
                child = rec(op.child)
                return op if child is op.child else replace(op, child=child)
            return op

        return rec(plan)

    def _projection_choice(self, scan: Scan, needed_cols: set):
        if scan.pushed_filter is None:
            return None
        try:
            t = self.catalog[scan.table]
        except KeyError:
            return None
        projs = getattr(t, "sorted_projections", None)
        if not projs:
            return None
        from ..expr.compile import bind_value

        conj = self._conjuncts(scan.pushed_filter)
        best = None
        for key_col, pname in projs.items():
            if key_col in t.dicts:
                continue  # dict codes are not value-ordered
            try:
                kt = t.schema[key_col]
            except Exception:
                continue
            if kt.kind not in self._RANGE_KINDS:
                continue  # decimal scales / floats: sides would mis-round
            qual = f"{scan.alias}.{key_col}"
            lows, highs = [], []
            for c in conj:
                for kind, lit in _key_bounds(c, qual):
                    if not (lit.value is not None
                            and lit.dtype.kind in self._RANGE_KINDS):
                        continue
                    if kind in ("ge", "gt"):
                        lows.append(
                            (lit, "left" if kind == "ge" else "right"))
                    elif kind in ("lt", "le"):
                        highs.append(
                            (lit, "left" if kind == "lt" else "right"))
                    else:  # eq
                        lows.append((lit, "left"))
                        highs.append((lit, "right"))
            if not lows and not highs:
                continue
            try:
                pt = self.catalog[pname]
            except KeyError:
                continue
            pcols = {f.name for f in pt.schema.fields}
            if not needed_cols <= pcols:
                continue
            arr = pt.data[key_col]
            n = len(arr)
            if n < 2:
                continue
            # representative bounds (parameterized literals keep their
            # planning-time value) -> exact count for the static capacity;
            # a different runtime value overflows and bumps the capacity
            lo_i = max(
                (int(np.searchsorted(arr, bind_value(l.value, l.dtype), s))
                 for l, s in lows), default=0,
            )
            hi_i = min(
                (int(np.searchsorted(arr, bind_value(h.value, h.dtype), s))
                 for h, s in highs), default=n,
            )
            cnt = max(hi_i - lo_i, 0)
            if cnt > 0.25 * n:
                continue  # not selective enough to beat the masked scan
            # tie-break equally selective candidates by covered width: a
            # narrower projection uploads fewer columns for the same slice
            width = len(pt.schema.fields)
            if best is None or (cnt, width) < (best[0], best[3]):
                best = (cnt, pname,
                        _SliceSpec(qual, tuple(lows), tuple(highs)), width)
        if best is None:
            return None
        cnt, pname, spec, _width = best
        new_scan = replace(scan, table=pname)
        cap = -(-int(cnt * 1.25 + 1024) // 1024) * 1024
        self._pending_slices[id(new_scan)] = (spec, cap)
        return new_scan

    def _slice_sorted_scan(self, qb: ColumnBatch, sl: _SliceSpec, cap: int,
                           n: int):
        """Read only the qualifying key range of a sorted-projection scan
        (kernel K17): the device binary search finds [lo, hi) from the
        (possibly parameterized) bounds, `cap` rows from lo are copied out
        of every column, and rows outside [lo, hi) mask off. Returns (the
        sliced batch, overflow = max(hi - lo - cap, 0)): a runtime range
        wider than the static capacity rides the overflow retry."""
        from ..expr.compile import literal_scalar

        dev = qb.device
        names = list(qb.cols)
        vnames = list(qb.valid)
        outs, sel, nrows, over = slice_scan(
            qb.cols[sl.key], n,
            [(literal_scalar(lit, dev), side) for lit, side in sl.lows],
            [(literal_scalar(lit, dev), side) for lit, side in sl.highs],
            cap, [qb.cols[k] for k in names] + [qb.valid[k] for k in vnames],
            qb.sel)
        out = ColumnBatch(
            cols=dict(zip(names, outs[:len(names)])),
            valid=dict(zip(vnames, outs[len(names):])),
            sel=sel,
            nrows=nrows,
            schema=qb.schema,
            dicts=qb.dicts,
        )
        return out, over

    # ---- execution ------------------------------------------------------
    def make_chunk_source(self, stream_table: str, chunk_rows: int):
        """The chunk-program executor of out-of-core streaming."""
        from .chunked import _ChunkSourceExecutor

        return _ChunkSourceExecutor(
            self.catalog, stream_table, chunk_rows,
            unique_keys=self.unique_keys, stats=self.stats,
            device=self.device,
        )

    def _clamped_chunk_rows(self, plan, stream, budget: int) -> int:
        """Chunk rows sized from the DECODED on-device width of the
        streamed columns: the pipeline holds up to depth+1 decoded chunks
        in flight, so each must fit its slice of the budget (the staged
        wire bytes are charged through the governor's staged ledger)."""
        from .memory_governor import derive_chunk_rows
        from .pipeline import decoded_row_bytes

        needed = self._needed_columns(plan).get(stream.alias) or set()
        row_b = decoded_row_bytes(
            self.catalog, stream.table, sorted(needed))
        slots = max(1, int(self.stream_prefetch_depth)) + 1
        return derive_chunk_rows(
            max(1, budget // slots), self.chunk_rows, row_bytes=row_b)

    def prepare(self, plan: LogicalOp):
        """Build the plan's program once; the returned plan is what the
        plan cache stores. Scans with a selective range on a sorted
        projection's key read the projection; inputs beyond the device
        budget return a ChunkedPreparedPlan that streams the biggest
        table through the program (engine/chunked.py), or a
        GraceHashPreparedPlan when the build side is too big as well.
        The plan carries its workload access profile and, when built
        whole, the optimizer's row estimate per node."""
        scans0 = self._collect_scans(plan)
        roles = self._access_columns(plan)
        plan = self._route_projections(plan)
        # workload access heat: computed once here, folded per execution
        access = self._access_profile(scans0, plan, roles)
        if self.chunking_enabled:
            from .chunked import (
                ChunkedPreparedPlan,
                NotStreamable,
                _find_stream_split,
                plan_input_bytes,
            )

            # the governor's effective budget (shrunk after an observed
            # OOM) clamps the static threshold
            budget = self.device_budget
            if self.governor is not None:
                budget = min(budget, self.governor.upload_budget())
            if plan_input_bytes(self, plan) > budget:
                try:
                    stream, split, kind = _find_stream_split(
                        self, plan, budget)
                    chunk_rows = self._clamped_chunk_rows(
                        plan, stream, budget)
                    cp = ChunkedPreparedPlan(
                        self, plan, stream, split, kind, chunk_rows)
                    cp.access_profile = access
                    return cp
                except NotStreamable:
                    # grace-hash partitioned spill: the BUILD side exceeds
                    # the budget too
                    from .pipeline import NotPartitionable, try_grace_hash

                    try:
                        gp = try_grace_hash(self, plan, budget)
                        gp.access_profile = access
                        return gp
                    except NotPartitionable:
                        # whole-table upload
                        pass
        params = self.seed_params(plan)
        run, input_spec, overflow_nodes = self.compile(plan, params)
        prepared = PreparedPlan(self, plan, params, run, input_spec,
                                overflow_nodes)
        prepared.access_profile = access
        # the estimate half of the operator profiler's (estimate, actual)
        # pairs (engine/plan_profile.py), pinned when the plan is built
        from ..sql.planner import capture_node_estimates

        prepared.node_estimates = capture_node_estimates(self, plan)
        return prepared

    def execute(self, plan: LogicalOp, max_retries: int = 3):
        return self.prepare(plan).run(max_retries)


def _narrow_seed(plan, default_rows: int) -> int:
    """Row-count seed of the narrowed result frame: how many live rows
    the client can receive from this plan root. LIMIT/TopN roots bound it
    exactly (n + offset: the limit keeps the offset rows live and the
    cursor slices); a group-less aggregate yields one row; anything else
    takes the caller's default (grown on a frame overflow like any other
    static capacity)."""
    node = plan
    while isinstance(node, Project):
        node = node.child
    if isinstance(node, (Limit, TopN)):
        return max(1, int(node.n) + int(getattr(node, "offset", 0) or 0))
    if isinstance(node, Aggregate) and not node.group_keys and (
        getattr(node, "grouping_sets", None) is None
    ):
        return 1
    return max(1, int(default_rows))


_NP_DTYPES: dict = {}


def _np_dtype(dt: torch.dtype) -> np.dtype:
    got = _NP_DTYPES.get(dt)
    if got is None:
        got = _NP_DTYPES[dt] = torch.empty(0, dtype=dt).numpy().dtype
    return got


def _to_host_many(tensors) -> list:
    """Host numpy copies of several tensors in one device-to-host copy:
    on CUDA their bytes are packed on the device (one cat) and split on
    the host, so a frame's completion is one transfer and one sync."""
    ts = list(tensors)
    if not ts or ts[0].device.type != "cuda":
        return [to_numpy(t) for t in ts]
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in ts]
    buf = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t in ts:
        nb = t.numel() * t.element_size()
        out.append(buf[off:off + nb].copy().view(_np_dtype(t.dtype))
                   .reshape(tuple(t.shape)))
        off += nb
    return out


def _frame_fits(out: ColumnBatch, ncap: int) -> bool:
    """Whether a result frame is no wider than the narrowed frame of ncap
    rows, so it is sent as it is."""
    return int(out.sel.shape[-1]) <= ncap


def _first_live_frame(out: ColumnBatch, k: int):
    """K23 over a result frame: (nlive, cols, valid) of its first k live
    rows in row order, row 0 in the lanes past the live ones."""
    cn, vn = list(out.cols), list(out.valid)
    _idx, nlive, g = first_live(
        out.sel, k,
        [out.cols[n].contiguous() for n in cn]
        + [out.valid[n].contiguous() for n in vn])
    return nlive, dict(zip(cn, g[:len(cn)])), dict(zip(vn, g[len(cn):]))


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
        # narrowed result frames: pow2 frame width -> program (dropped by
        # recompile), the current width (0 = unseeded), and the opt-out
        # of a plan whose result is too wide to narrow
        self._narrow: dict[int, object] = {}
        self._narrow_cap = 0
        self._narrow_off = False
        # optimizer row estimate per node id (prepare fills it)
        self.node_estimates: dict[int, int] = {}
        self.access_profile = ()

    def recompile(self) -> None:
        """Rebuild after a capacity change; the narrowed programs close
        over the old capacities and drop with it."""
        self.program, self.input_spec, self.overflow_nodes = (
            self.executor.compile(self.plan, self.params)
        )
        self._narrow.clear()

    def _inputs(self):
        try:
            return {
                alias: self.executor.input_batch(alias, table, cols)
                for alias, table, cols in self.input_spec
            }
        except ClusteredPremiseInvalidated:
            # the probe's clustering dissolved under a cached plan:
            # recompile (spec re-detection drops the fast path) and
            # assemble again
            self.recompile()
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
        from ..share.interrupt import checkpoint

        for attempt in range(max_retries + 1):
            checkpoint()  # between overflow retries (and before the first)
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
        from ..share.interrupt import checkpoint

        checkpoint()
        return self.call(qparams)

    # ---- the narrowed result frame -------------------------------------
    def narrow_frame(self, default_rows: int, max_rows: int) -> int:
        """Pow2 width of the narrowed result frame, or 0 when this plan
        opted out (its result is wider than the ceiling, or an earlier
        narrowed run overflowed past it). Seeded from the plan root
        (LIMIT/aggregate bounds) and clamped to the root compaction's
        capacity: narrowing past what compact_batch emits moves no fewer
        bytes."""
        if self._narrow_off:
            return 0
        ncap = self._narrow_cap
        if ncap == 0:
            ncap = next_pow2(_narrow_seed(self.plan, default_rows))
            root = self.params.join_cap.get(ROOT_COMPACT)
            if root:
                ncap = min(ncap, next_pow2(int(root)))
            self._narrow_cap = ncap
        if ncap > max_rows:
            self._narrow_off = True
            return 0
        return ncap

    def _build_narrow(self, ncap: int):
        """The plan's program followed by the result-frame compaction
        (K23: the first ncap live rows in row order, every column and
        validity plane gathered in one pass), so the frame equals the
        plain path's host-side sel masking row for row. nkeep, the lanes
        and the frame overflow derive from nlive on the device. A frame
        of at most ncap rows (a TopN, LIMIT or aggregate root is often
        one) cannot overflow and compacting it moves no fewer bytes: it
        is the narrowed frame as it is, with its own sel."""

        def run_narrow(inputs, qparams):
            out, ovf_vec = self.program(inputs, qparams)
            if _frame_fits(out, ncap):
                return out, ovf_vec, torch.zeros(
                    (), dtype=torch.int64, device=out.sel.device)
            nlive, cols, valid = _first_live_frame(out, ncap)
            nkeep = torch.clamp(nlive, max=ncap)
            lanes = torch.arange(ncap, dtype=torch.int64,
                                 device=out.sel.device) < nkeep
            nb = ColumnBatch(cols=cols, valid=valid, sel=lanes,
                             nrows=nkeep, schema=out.schema, dicts=out.dicts)
            return nb, ovf_vec, torch.clamp(nlive - ncap, min=0)

        return run_narrow

    def run_device_narrow(self, qparams, ncap: int):
        """Narrowed dispatch without a host sync: (frame batch, the
        plan's overflow vector, the frame overflow), all on the device;
        the statement's one host round trip is NarrowDeviceResult's
        completion copy."""
        from ..share.interrupt import checkpoint

        checkpoint()
        fn = self._narrow.get(ncap)
        if fn is None:
            fn = self._narrow[ncap] = self._build_narrow(ncap)
            self.executor.narrow_compiles += 1
        return fn(self._inputs(), qparams)

    # ---- cross-session micro-batching ----------------------------------
    @property
    def batchable(self) -> bool:
        """Whether the statement batcher may fold this plan's concurrent
        fast hits into one batched dispatch. The batched program (a packed
        [B, width] parameter block through one dispatch) is not ported,
        so every hit dispatches solo, with the same rows."""
        return False

    def run_batched_host(self, qblock, max_retries: int = 3):
        raise NotImplementedError(
            "PreparedPlan.run_batched_host (the batched program over a "
            "packed parameter block) is not ported to the torch engine yet")


class DeviceResult:
    """Lazy device-resident result cursor. The first host access fetches
    the overflow counters and the live row count (a capacity overflow
    re-runs the plan here, as PreparedPlan.run would); column data
    transfers on demand: per touched column, or the first k rows through
    K23. `ovf_vec` None marks a batch whose plan already checked its
    counters (the out-of-core plans run to the end)."""

    def __init__(self, prepared, qparams, out, ovf_vec, max_retries: int = 3,
                 profile=None, phases=None):
        self.prepared = prepared
        self._qparams = qparams
        self._out = out
        self._ovf = ovf_vec
        self._max_retries = max_retries
        # observability sinks, updated in place as transfers happen:
        # server/diag.QueryProfile (fetch_s / d2h_bytes) and the session's
        # last_phases dict of this statement
        self.profile = profile
        self.phases = phases
        self._nrows: int | None = None
        self._hcols: dict = {}
        self._hvalid: dict = {}
        self._hsel = None

    def _observe(self, seconds: float, nbytes: int,
                 kind: str = "sync") -> None:
        if self.profile is not None:
            self.profile.fetch_s += seconds
            self.profile.d2h_bytes += nbytes
        if self.phases is not None:
            self.phases["fetch_s"] = self.phases.get("fetch_s", 0.0) + seconds
            if kind == "d2h":
                # column transfers, split from the dispatch sync so the
                # host-tax ledger can tell "d2h" from "device wait"
                self.phases["d2h_s"] = (
                    self.phases.get("d2h_s", 0.0) + seconds)

    def _sync(self) -> None:
        """Overflow check + row count, the deferred tail of the dispatch:
        the same bump/recompile/re-run loop as PreparedPlan.run. A small
        result (known from the per-plan footprint memo) brings its column
        data along in the same copy."""
        if self._nrows is not None:
            return
        from ..share.interrupt import checkpoint

        if self._ovf is None:
            # an out-of-core plan's result: its runs checked every counter
            t0 = time.perf_counter()
            self._nrows = int(self._out.nrows)
            self._observe(time.perf_counter() - t0, 8)
            return
        p = self.prepared
        rmemo = getattr(p, "_result_bytes_memo", None)
        small = (rmemo is not None and rmemo[0] == getattr(p, "retries", 0)
                 and rmemo[1] <= 65536 and not self._hcols
                 and self._hsel is None)
        for attempt in range(self._max_retries + 1):
            t0 = time.perf_counter()
            if small:
                cn, vn = list(self._out.cols), list(self._out.valid)
                got = _to_host_many(
                    [self._ovf, self._out.sel]
                    + [self._out.cols[n] for n in cn]
                    + [self._out.valid[n] for n in vn])
                hovf, hsel = got[0], got[1]
                harrs = dict(zip(cn, got[2:2 + len(cn)]))
                hvals = dict(zip(vn, got[2 + len(cn):]))
                hn = int(hsel.sum())
            else:
                hovf, hn = _to_host_many([self._ovf, self._out.nrows])
                hn = int(hn)
            self._observe(time.perf_counter() - t0,
                          int(getattr(hovf, "nbytes", 0)) + 8)
            overflows = p._overflows(hovf)
            if not overflows:
                self._nrows = int(hn)
                if small:
                    # commit only a clean run: an overflowed attempt's
                    # arrays are garbage
                    self._hcols.update(harrs)
                    self._hvalid.update(hvals)
                    self._hsel = hsel
                    self._observe(0.0, sum(
                        int(a.nbytes) for d in (harrs, hvals)
                        for a in d.values()) + int(hsel.nbytes))
                return
            if attempt == self._max_retries:
                raise RuntimeError(
                    f"capacity overflow after {self._max_retries} retries: "
                    f"{overflows}")
            p.retries += 1
            p.params.bump(overflows)
            p.recompile()
            checkpoint()
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
        need = [n for n in names if n not in self._hcols]
        if not need and self._hsel is not None:
            return
        vn = [n for n in need if n in self._out.valid]
        ts = ([self._out.cols[n] for n in need]
              + [self._out.valid[n] for n in vn])
        sel_fetched = self._hsel is None
        if sel_fetched:
            ts.append(self._out.sel)
        t0 = time.perf_counter()
        got = _to_host_many(ts)
        self._observe(time.perf_counter() - t0,
                      sum(int(a.nbytes) for a in got), kind="d2h")
        self._hcols.update(zip(need, got[:len(need)]))
        self._hvalid.update(zip(vn, got[len(need):len(need) + len(vn)]))
        if sel_fetched:
            self._hsel = got[-1]

    def fetch_columns(self, names=None) -> dict:
        """Host rows (sel-compacted, dict-decoded) for the requested
        columns, all of them when names is None. Each column transfers
        at most once; repeats serve from the host cache."""
        self._sync()
        fields = [f for f in self._out.schema.fields
                  if names is None or f.name in names]
        self._fetch([f.name for f in fields])
        return host_rows(Schema(tuple(fields)), self._out.dicts, self._hcols,
                         self._hvalid, self._hsel)

    def fetch_head(self, limit: int) -> dict:
        """The first `limit` live rows through K23: about limit rows per
        column cross to the host instead of the frame's capacity. The
        width buckets to a power of two, so a client sweeping LIMIT
        values (pagination) uses log2(cap) widths, not one per limit.
        Serves from the host cache after a full fetch."""
        self._sync()
        k = min(int(limit), self._nrows)
        if self._hsel is not None and not (
            set(self._out.schema.names()) - set(self._hcols)
        ):
            host = host_rows(self._out.schema, self._out.dicts, self._hcols,
                             self._hvalid, self._hsel)
            return {n: v[:k] for n, v in host.items()}
        cap = int(self._out.sel.shape[-1])
        kb = min(next_pow2(max(k, 1)), cap)
        _nlive, cols, valid = _first_live_frame(self._out, kb)
        cn, vn = list(cols), list(valid)
        t0 = time.perf_counter()
        got = _to_host_many([cols[n] for n in cn] + [valid[n] for n in vn])
        self._observe(time.perf_counter() - t0,
                      sum(int(a.nbytes) for a in got), kind="d2h")
        host = host_rows(self._out.schema, self._out.dicts,
                         dict(zip(cn, got[:len(cn)])),
                         dict(zip(vn, got[len(cn):])),
                         np.ones(kb, dtype=np.bool_))
        return {n: v[:k] for n, v in host.items()}

    def fetch_storage(self, names=None) -> dict:
        """Live rows in the STORAGE domain (scaled-int decimals, day
        numbers, dictionary codes): exact values for result checks."""
        self._sync()
        names = list(names) if names is not None else self._out.schema.names()
        return batch_rows_storage(self._out, names)


class NarrowDeviceResult(DeviceResult):
    """DeviceResult over a narrowed dispatch: `out` is the final ncap-row
    result frame, so the completion sync copies the whole client-visible
    payload in one round trip, with no separate column transfer. A frame
    overflow grows the pow2 width and re-runs; past the ceiling the plan
    gives up narrowing and this cursor falls back to the plain lazy
    contract."""

    narrowed = True

    def __init__(self, prepared, qparams, out, ovf_vec, novf, ncap: int,
                 narrow_max: int, max_retries: int = 3, profile=None,
                 phases=None):
        super().__init__(prepared, qparams, out, ovf_vec,
                         max_retries=max_retries, profile=profile,
                         phases=phases)
        self._novf = novf
        self._ncap = int(ncap)
        self._narrow_max = int(narrow_max)
        self._fallback = False

    def _sync(self) -> None:
        if self._nrows is not None:
            return
        if self._fallback:
            return super()._sync()
        from ..share.interrupt import checkpoint

        p = self.prepared
        for attempt in range(self._max_retries + 1):
            t0 = time.perf_counter()
            # the frame IS the result: the overflow counters and every
            # ncap-row leaf in one copy
            cn, vn = list(self._out.cols), list(self._out.valid)
            got = _to_host_many(
                [self._ovf, self._novf, self._out.sel]
                + [self._out.cols[n] for n in cn]
                + [self._out.valid[n] for n in vn])
            hovf, hnovf, hsel = got[0], int(got[1]), got[2]
            harrs = dict(zip(cn, got[3:3 + len(cn)]))
            hvals = dict(zip(vn, got[3 + len(cn):]))
            self._observe(time.perf_counter() - t0,
                          int(getattr(hovf, "nbytes", 0)) + 8)
            overflows = p._overflows(hovf)
            if not overflows and hnovf == 0:
                self._nrows = int(hsel.sum())
                # commit only a clean run (overflowed frames are garbage)
                self._hcols.update(harrs)
                self._hvalid.update(hvals)
                self._hsel = hsel
                self._observe(0.0, sum(
                    int(a.nbytes) for d in (harrs, hvals)
                    for a in d.values()) + int(hsel.nbytes))
                return
            if attempt == self._max_retries:
                raise RuntimeError(
                    f"capacity overflow after {self._max_retries} "
                    f"retries: {overflows or {'narrow': hnovf}}")
            if overflows:
                p.retries += 1
                p.params.bump(overflows)
                p.recompile()
            if hnovf > 0:
                grown = next_pow2(self._ncap + hnovf)
                p._narrow_cap = max(p._narrow_cap, grown)
                if grown > self._narrow_max:
                    # too wide to narrow: the plan remembers (the next
                    # warm hit skips narrowing) and THIS statement
                    # finishes on the plain path
                    p._narrow_off = True
                    self._fallback = True
                    checkpoint()
                    self._out, self._ovf = p.call(self._qparams)
                    return super()._sync()
                self._ncap = grown
            checkpoint()
            self._out, self._ovf, self._novf = p.run_device_narrow(
                self._qparams, self._ncap)
        raise AssertionError


def _key_bounds(c: E.Expr, qual: str) -> list:
    """Classify one conjunct as bounds on column `qual`: a list of
    ('gt'|'ge'|'lt'|'le'|'eq', Literal) pairs (empty = not a bound).
    Handles both operand orders and a non-negated BETWEEN
    (the reference's executor._range_bounds)."""
    if isinstance(c, E.Between) and not c.negated:
        if (
            isinstance(c.arg, E.ColRef) and c.arg.name == qual
            and isinstance(c.low, E.Literal)
            and isinstance(c.high, E.Literal)
        ):
            return [("ge", c.low), ("le", c.high)]
        return []
    if not isinstance(c, E.Compare):
        return []
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    op, lhs, rhs = c.op, c.left, c.right
    if isinstance(rhs, E.ColRef) and isinstance(lhs, E.Literal):
        op, lhs, rhs = flip.get(op), rhs, lhs
    if not (
        isinstance(lhs, E.ColRef) and lhs.name == qual
        and isinstance(rhs, E.Literal) and op in flip
    ):
        return []
    kind = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "=": "eq"}[op]
    return [(kind, rhs)]


def _pair_keys_equal(lkeys, rkeys, pr, br) -> torch.Tensor:
    """Exact key equality of expanded pairs: multi-column keys join on
    their 64-bit hash, so a 2^-64 collision must not make a row."""
    eq = torch.ones(pr.shape[0], dtype=torch.bool, device=pr.device)
    for a, b in zip(gather_columns(lkeys, pr), gather_columns(rkeys, br)):
        eq = eq & (a == b)
    return eq


def _is_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


def _row_key_operands(cols, valid, schema):
    """Whole-row sort operands with NULLs-compare-equal semantics: each
    column's values (zeroed under NULL), then its validity if nullable.
    Returns (operands, spec of (name, nullable)) for unpacking."""
    operands, spec = [], []
    for f in schema.fields:
        c = cols[f.name]
        v = valid.get(f.name)
        if v is not None:
            c = torch.where(v, c, torch.zeros((), dtype=c.dtype,
                                              device=c.device))
        operands.append(c.contiguous())
        if v is not None:
            operands.append(v.contiguous())
        spec.append((f.name, v is not None))
    return operands, spec


def _affine_probe(build_key, build_sel, probe_key, probe_sel, aff):
    """Verified affine probe for callers that need only the match row
    (semi/anti joins): int32 candidate build rows, -1 where the probe row
    has no live build row with its key (K5's probe entry)."""
    return affine_probe(probe_key.contiguous(), probe_sel, aff[0], aff[1],
                        build_key.contiguous(), build_sel)


def _join_schema(ls: Schema, rs: Schema) -> Schema:
    return Schema(tuple(list(ls.fields) + list(rs.fields)))


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


def _take(col: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """col[at] with `at` clipped into the column, by one K4 gather."""
    n = int(col.shape[0])
    idx = at.clamp(0, max(n - 1, 0)).to(torch.int32)
    return gather_columns([col.contiguous()], idx)[0]


def _remap_codes(codes: torch.Tensor, remap) -> torch.Tensor:
    """Dictionary codes through a merge's remap table (codes clipped into
    the table, as a jnp gather clips)."""
    table = torch.as_tensor(np.asarray(remap), device=codes.device)
    return _take(table, codes.to(torch.int64))
