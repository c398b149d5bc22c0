"""Profiled execution mode + the operator calibration record store.

Counterpart of `oceanbase_tpu/engine/plan_profile.py`. A prepared plan's
program runs its operators back to back and says nothing of which one
took the device time or missed its cardinality estimate. This module runs
a prepared plan as a sequence of per-operator stages, split at the
`LogicalOp` node boundaries `_number_nodes` assigns, each stage timed on
its own (CUDA events on the card, the host clock on the CPU) and measured
for output cardinality and output device bytes (joins and group-bys also
get a measured build/probe split). The segmented run produces the SAME
root batch and overflow vector as the plain program, bit for bit, so a
profiled execution serves its statement's result; nothing runs twice.

Profiling is never on the hot path: `PlanProfiler` samples per digest
(the first RE-execution, then 1-in-N under ob_plan_profile_sample), is
forced by EXPLAIN ANALYZE and armed by the slow-query watermark, and every
sample folds into the bounded `OperatorProfileStore` keyed by (digest,
node_id, op_kind): device-time/rows/bytes histograms plus the optimizer's
estimated cardinality captured when the plan was built, an (estimate,
actual) calibration pair.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

from ..core.column import to_numpy
from .executor import (
    ROOT_COMPACT,
    _children,
    _device_nbytes,
    _number_nodes,
    compact_batch,
)

# log2 histogram buckets: bucket i holds values in [2^(i-1), 2^i)
_NB = 48


def _bucket(v) -> int:
    return min(int(max(v, 0)).bit_length(), _NB - 1)


def hist_quantile(hist, q: float) -> float:
    """Approximate quantile from a log2-bucket histogram (upper bound
    of the bucket the q-th observation falls in)."""
    total = sum(hist)
    if total <= 0:
        return 0.0
    want = q * total
    seen = 0
    for i, c in enumerate(hist):
        seen += c
        if seen >= want:
            return float(1 << i)
    return float(1 << (_NB - 1))


def _vec_project(op) -> bool:
    """True when a Project computes a vec_l2 distance column — the
    full-batch matmul that dominates the brute-force ANN route, and the
    measurement the optimizer's brute-side us/row rate comes from."""
    from ..expr import ir as E

    for _name, e in getattr(op, "exprs", ()) or ():
        if isinstance(e, E.Func) and e.name == "vec_l2":
            return True
    return False


def op_kind(op) -> str:
    """Display kind of one plan node (JoinOp carries its join kind —
    an anti join and an inner join calibrate very differently)."""
    k = type(op).__name__
    kind = getattr(op, "kind", None)
    if k in ("JoinOp", "SetOp") and kind:
        return f"{k[:-2] if k == 'JoinOp' else k}:{kind}"
    return k


def miss_factor(est, actual) -> float:
    """Symmetric misestimation ratio, floor-clamped so empty operators
    (0 rows either side) read as 1.0, never inf."""
    e = max(float(est), 1.0)
    a = max(float(actual), 1.0)
    return max(e / a, a / e)


# ---- segmented execution ----------------------------------------------------


@dataclass
class OpSample:
    """One operator's measurements from one profiled execution."""

    node_id: int
    op_kind: str
    device_us: float
    rows: int
    out_bytes: int
    build_us: float = 0.0
    probe_us: float = 0.0
    # rows of work the operator actually touched (candidate rows for an
    # IVF probe, the full batch for a brute top-n): the denominator the
    # ANN route costing calibrates us/row against; 0 = not tracked
    work_rows: int = 0


class _StageTimer:
    """Device time of the work enqueued between start and stop: CUDA
    events around it on the card (the stop event is waited for), the host
    clock on the CPU, where torch ops run synchronously."""

    def __init__(self, dev: torch.device):
        self._cuda = dev.type == "cuda"
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t1 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop_us(self) -> float:
        if self._cuda:
            self._t1.record()
            self._t1.synchronize()
            return float(self._t0.elapsed_time(self._t1)) * 1e3
        return (time.perf_counter() - self._t0) * 1e6


class SegmentedPlan:
    """Per-operator stages of one PreparedPlan.

    Each stage emits exactly one plan node through Executor._emit_node,
    with an emit stub that hands back the already computed child batches
    instead of recursing, so each node runs the same operations as in the
    plain program and the composition reproduces its result. Stages run
    in post-order (children first); the root output goes through the same
    compact_batch the plain program applies, and the per-stage overflow
    counters stack over the same sorted overflow_nodes order: (out,
    ovf_vec) match the plain program's.

    Segmentation follows the nodes the executor actually EMITS: a
    clustered-FK aggregate absorbs its Join child and asks emit() for the
    join's own children, so the absorbed Join gets no stage and no sample
    (`absorbed` maps it to the absorbing parent); likewise the nodes
    between an IVF top-n and its scan.

    The stages close over the plan's PhysicalParams capacities, so they
    are rebuilt whenever the plan recompiled (`stale()`).
    """

    def __init__(self, prepared):
        ex = prepared.executor
        plan = prepared.plan
        params = prepared.params
        self.device = ex.device
        self.nodes = _number_nodes(plan)
        id_of = {id(op): nid for nid, op in self.nodes.items()}
        self.overflow_nodes = list(prepared.overflow_nodes)
        self._retries0 = getattr(prepared, "retries", 0)
        self._params = params

        from ..sql.logical import Aggregate as _Agg, TopN as _TopN

        self.absorbed: dict[int, int] = {}

        def eff_children(op):
            nid = id_of[id(op)]
            if (isinstance(op, _Agg) and op.grouping_sets is None
                    and nid in params.clustered_aggs):
                ji = params.clustered_aggs[nid].ji
                self.absorbed[id_of[id(ji)]] = nid
                return (ji.left, ji.right)
            if isinstance(op, _TopN) and nid in params.vector_topns:
                # the ANN top-n emits from the SCAN, fusing any Project /
                # Filter between into its own kernels
                vs = params.vector_topns[nid]
                node = op.child
                while id(node) != id(vs.scan):
                    self.absorbed[id_of[id(node)]] = nid
                    node = node.child
                return (vs.scan,)
            return _children(op)

        # post-order over unique node ids: children before parents (a
        # shared subtree runs once)
        order: list[int] = []
        seen: set[int] = set()

        def walk(op):
            nid = id_of[id(op)]
            if nid in seen:
                return
            for c in eff_children(op):
                walk(c)
            if nid not in seen:
                seen.add(nid)
                order.append(nid)

        walk(plan)
        self.order = order
        self.root = id_of[id(plan)]
        self.stages = {}
        self.builders = {}
        for nid in order:
            op = self.nodes[nid]
            child_ids = tuple(id_of[id(c)] for c in eff_children(op))
            self.stages[nid] = (
                child_ids,
                self._make_stage(ex, op, child_ids, params, id_of),
            )
            bf = self._make_build(op, clustered=nid in params.clustered_aggs)
            if bf is not None:
                self.builders[nid] = bf
        self._root_cap = params.join_cap[ROOT_COMPACT]

    def stale(self, prepared) -> bool:
        """An overflow bump rebuilt the plan: the stages hold the OLD
        capacities; rebuild before the next profile."""
        return (getattr(prepared, "retries", 0) != self._retries0
                or prepared.params is not self._params)

    @staticmethod
    def _make_stage(ex, op, child_ids, params, id_of):
        def stage(inputs, child_outs, qparams):
            from ..expr import compile as expr_compile

            # the same parameter frame the plain program installs
            prev = expr_compile.set_params(qparams if len(qparams) else None)
            try:
                def emit(child, _inputs):
                    return child_outs[child_ids.index(id_of[id(child)])], {}

                out, ovf = ex._emit_node(op, inputs, emit, params, id_of)
            finally:
                expr_compile.set_params(prev)
            return out, ovf, torch.sum(out.sel, dtype=torch.int64)

        return stage

    @staticmethod
    def _make_build(op, clustered: bool = False):
        """Build-phase-only program of a join or group-by: the build
        side's key evaluation + sort, timed on its own so probe_us =
        device_us - build_us. A measured approximation (the merge-join
        route skips the sort in the real stage), enough to say WHICH side
        of a join dominates. Clustered-FK aggregates have no build phase
        (their ranges are precomputed on the host)."""
        from ..sql.logical import Aggregate as _Agg, JoinOp as _Join

        if clustered:
            return None
        if isinstance(op, _Join) and op.right_keys:

            def jbuild(inputs, child_outs, qparams):
                from ..expr import compile as expr_compile
                from ..expr.compile import evaluate
                from ..ops.join import sort_build_side

                prev = expr_compile.set_params(
                    qparams if len(qparams) else None)
                try:
                    right = child_outs[1]
                    rkeys = [evaluate(e, right)[0] for e in op.right_keys]
                    return sort_build_side(rkeys, right.sel)
                finally:
                    expr_compile.set_params(prev)

            return jbuild
        if (isinstance(op, _Agg) and op.group_keys
                and op.grouping_sets is None):

            def gbuild(inputs, child_outs, qparams):
                from ..expr import compile as expr_compile
                from ..expr.compile import evaluate

                prev = expr_compile.set_params(
                    qparams if len(qparams) else None)
                try:
                    child = child_outs[0]
                    _name, e = op.group_keys[0]
                    v, vv = evaluate(e, child)
                    if vv is not None:
                        v = torch.where(vv, v, torch.zeros_like(v))
                    return torch.sort(v).values
                finally:
                    expr_compile.set_params(prev)

            return gbuild
        return None

    def run(self, inputs, qparams=()):
        """Run every stage, each timed on its own; returns (out, ovf_vec,
        samples). samples is None when a capacity overflowed mid-run: the
        profile is dropped but (out, ovf_vec) still carry the counters,
        so the caller's normal re-run takes over (a dropped sample, never
        a failed statement)."""
        from ..share.interrupt import checkpoint

        checkpoint()
        dev = self.device
        outs: dict[int, object] = {}
        ovf: dict[int, object] = {}
        samples: list[OpSample] = []
        for nid in self.order:
            child_ids, fn = self.stages[nid]
            childs = tuple(outs[c] for c in child_ids)
            timer = _StageTimer(dev)
            out, novf, nrows = fn(inputs, childs, qparams)
            device_us = timer.stop_us()
            outs[nid] = out
            ovf.update(novf)
            build_us = 0.0
            bf = self.builders.get(nid)
            if bf is not None:
                try:
                    tb = _StageTimer(dev)
                    bf(inputs, childs, qparams)
                    build_us = tb.stop_us()
                except Exception:  # noqa: BLE001 - an approximation only
                    # an exotic key type: report probe-only from now on
                    self.builders.pop(nid, None)
            build_us = min(build_us, device_us)
            kind = op_kind(self.nodes[nid])
            work_rows = 0
            if kind == "TopN":
                vs = self._params.vector_topns.get(nid)
                if vs is not None:
                    # IVF route: centroid pass + padded candidate windows
                    kind = "VectorTopN"
                    work_rows = vs.lists + vs.nprobe * vs.max_list
            elif (kind == "Project" and childs
                    and _vec_project(self.nodes[nid])):
                # brute route: the distance matmul ranks the whole batch
                kind = "VecDistance"
                work_rows = int(childs[0].sel.shape[0])
            samples.append(OpSample(
                node_id=nid,
                op_kind=kind,
                device_us=device_us,
                rows=int(nrows),
                out_bytes=int(_device_nbytes(out)),
                build_us=build_us,
                probe_us=max(device_us - build_us, 0.0),
                work_rows=work_rows,
            ))
        timer = _StageTimer(dev)
        out, oc = compact_batch(outs[self.root], self._root_cap)
        # result compaction is the root's work: charge it to the root
        samples[-1].device_us += timer.stop_us()
        ovf[ROOT_COMPACT] = oc
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ovf_vec = (
            torch.stack([ovf.get(n, zero).to(torch.int64)
                         for n in self.overflow_nodes])
            if self.overflow_nodes
            else torch.zeros(0, dtype=torch.int64, device=dev)
        )
        if any(int(v) > 0 for v in to_numpy(ovf_vec)):
            return out, ovf_vec, None
        return out, ovf_vec, samples


def run_profiled(prepared, qparams=()):
    """Run one PreparedPlan through the segmented profiler. Returns
    (out, ovf_vec, samples) as the plain dispatch returns (out, ovf_vec);
    the SegmentedPlan caches on the prepared plan and is rebuilt after
    any overflow recompile."""
    inputs = prepared._inputs()
    seg = getattr(prepared, "_segmented", None)
    if seg is None or seg.stale(prepared):
        seg = prepared._segmented = SegmentedPlan(prepared)
    return seg.run(inputs, qparams)


def profile_eligible(prepared) -> bool:
    """Only whole-plan PreparedPlans segment: chunked and grace-hash plans
    stream (their stages ARE the chunk loop) and keep the plan-level
    monitor row."""
    return (hasattr(prepared, "run_device")
            and getattr(prepared, "plan", None) is not None
            and not getattr(prepared, "px_nsh", 0)
            and getattr(prepared, "params", None) is not None)


# ---- calibration record store ----------------------------------------------


@dataclass
class OperatorRecord:
    """Cumulative per-(digest, node_id, op_kind) calibration record.
    Counters only grow; window consumers (awr_report, the sentinel)
    diff last-first exactly like the host-tax registry rows."""

    digest: str
    node_id: int
    op_kind: str
    est_rows: int = 0
    plan_id: int = 0
    executions: int = 0
    device_us: float = 0.0
    build_us: float = 0.0
    probe_us: float = 0.0
    rows: int = 0
    out_bytes: int = 0
    work_rows: int = 0
    last_rows: int = 0
    last_device_us: float = 0.0
    max_miss: float = 1.0
    hist_us: list = field(default_factory=lambda: [0] * _NB)
    hist_rows: list = field(default_factory=lambda: [0] * _NB)
    hist_bytes: list = field(default_factory=lambda: [0] * _NB)

    @property
    def avg_rows(self) -> float:
        return self.rows / self.executions if self.executions else 0.0

    @property
    def miss(self) -> float:
        """(estimate, actual) calibration ratio over the record's
        lifetime average actual cardinality."""
        if not self.executions:
            return 1.0
        return miss_factor(self.est_rows, self.avg_rows)

    def fold(self, s: OpSample) -> None:
        self.executions += 1
        self.device_us += s.device_us
        self.build_us += s.build_us
        self.probe_us += s.probe_us
        self.rows += s.rows
        self.out_bytes += s.out_bytes
        self.work_rows += s.work_rows
        self.last_rows = s.rows
        self.last_device_us = s.device_us
        self.max_miss = max(self.max_miss,
                            miss_factor(self.est_rows, s.rows))
        self.hist_us[_bucket(s.device_us)] += 1
        self.hist_rows[_bucket(s.rows)] += 1
        self.hist_bytes[_bucket(s.out_bytes)] += 1

    def as_dict(self) -> dict:
        return {
            "digest": self.digest,
            "node_id": self.node_id,
            "op_kind": self.op_kind,
            "est_rows": self.est_rows,
            "plan_id": self.plan_id,
            "executions": self.executions,
            "device_us": self.device_us,
            "build_us": self.build_us,
            "probe_us": self.probe_us,
            "rows": self.rows,
            "out_bytes": self.out_bytes,
            "work_rows": self.work_rows,
            "last_rows": self.last_rows,
            "last_device_us": self.last_device_us,
            "avg_rows": self.avg_rows,
            "miss_factor": self.miss,
            "max_miss": self.max_miss,
            "hist_us": list(self.hist_us),
            "hist_rows": list(self.hist_rows),
            "hist_bytes": list(self.hist_bytes),
        }


class OperatorProfileStore:
    """Bounded per-digest store of operator calibration records.

    Keyed digest -> node_id; eviction is coldest-digest-first by fold
    sequence (the same policy the statement summary uses), bounded by
    ob_plan_profile_max_digests. snapshot() emits plain cumulative data
    the WorkloadRepository embeds per snapshot — every downstream
    consumer (awr, sentinel, obdiag) windows by diffing snapshots."""

    def __init__(self, max_digests: int = 128):
        self._lock = threading.Lock()
        # digest -> {"seq": last-fold seq, "nodes": {nid: OperatorRecord}}
        self._digests: dict[str, dict] = {}
        self.max_digests = max_digests
        self._seq = 0
        self.enabled = True
        self.profiles = 0
        self.evictions = 0

    def set_max_digests(self, n: int) -> None:
        with self._lock:
            self.max_digests = int(n)
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._digests) > max(self.max_digests, 1):
            cold = min(self._digests, key=lambda d: self._digests[d]["seq"])
            del self._digests[cold]
            self.evictions += 1

    def fold(self, digest: str, samples, est: dict | None,
             plan_id: int = 0) -> None:
        """Fold one profiled execution's samples under `digest`; `est`
        maps node_id -> compile-time estimated rows."""
        if not self.enabled or not samples:
            return
        est = est or {}
        with self._lock:
            self._seq += 1
            d = self._digests.get(digest)
            if d is None:
                d = self._digests[digest] = {"seq": self._seq, "nodes": {}}
                if len(self._digests) > max(self.max_digests, 1):
                    self._evict_locked()
            d["seq"] = self._seq
            self.profiles += 1
            nodes = d["nodes"]
            for s in samples:
                r = nodes.get(s.node_id)
                if r is None:
                    r = nodes[s.node_id] = OperatorRecord(
                        digest=digest, node_id=s.node_id,
                        op_kind=s.op_kind,
                        est_rows=int(est.get(s.node_id, 0)),
                        plan_id=plan_id,
                    )
                if plan_id:
                    r.plan_id = plan_id
                r.fold(s)

    def rows(self) -> list[dict]:
        """Flat per-operator rows (virtual-table surface), ordered by
        digest then node id."""
        with self._lock:
            out = []
            for digest in sorted(self._digests):
                nodes = self._digests[digest]["nodes"]
                for nid in sorted(nodes):
                    out.append(nodes[nid].as_dict())
            return out

    def digest_profile(self, digest: str) -> list[dict]:
        """One digest's operator records (flight-recorder bundles)."""
        with self._lock:
            d = self._digests.get(digest)
            if d is None:
                return []
            return [d["nodes"][n].as_dict() for n in sorted(d["nodes"])]

    def ann_route_rates(self) -> tuple[float, float] | None:
        """Measured (ivf_us_per_row, brute_us_per_row) for the ANN route
        decision, aggregated across every digest's VectorTopN /
        VecDistance records. None until BOTH routes have been profiled
        with tracked work — the optimizer then falls back to its flops
        model rather than cost against a one-sided measurement."""
        ivf_us = ivf_rows = brute_us = brute_rows = 0.0
        with self._lock:
            for d in self._digests.values():
                for r in d["nodes"].values():
                    if r.work_rows <= 0:
                        continue
                    if r.op_kind == "VectorTopN":
                        ivf_us += r.device_us
                        ivf_rows += r.work_rows
                    elif r.op_kind == "VecDistance":
                        brute_us += r.device_us
                        brute_rows += r.work_rows
        if ivf_rows <= 0 or brute_rows <= 0:
            return None
        return (ivf_us / ivf_rows, brute_us / brute_rows)

    def snapshot(self) -> dict:
        """Cumulative plain-data image for workload snapshots. Node ids
        are stringified so the image round-trips JSON identically."""
        with self._lock:
            return {
                "profiles": self.profiles,
                "evictions": self.evictions,
                "digests": {
                    digest: {
                        str(nid): d["nodes"][nid].as_dict()
                        for nid in d["nodes"]
                    }
                    for digest, d in self._digests.items()
                },
            }


# ---- sampling policy --------------------------------------------------------


class PlanProfiler:
    """Per-digest sampling policy + the statement-digest handoff.

    The server layer sets the pending digest (thread-local) before
    dispatch; the engine's _execute_entry takes it, asks decide(), and
    when a reason comes back runs the statement through run_profiled —
    serving the result FROM the profiled run, never executing twice.
    Forcing: EXPLAIN ANALYZE calls force_next(); the slow-query
    watermark calls mark_slow() so the NEXT occurrence of a slow digest
    carries an operator profile into its flight-recorder bundle."""

    def __init__(self, store: OperatorProfileStore | None = None,
                 sample_every: int = 64):
        self.store = store if store is not None else OperatorProfileStore()
        self.sample_every = sample_every
        self.enabled = True
        self._counts: dict[str, int] = {}
        self._force: set[str] = set()
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.slow_marks = 0

    # -- per-statement digest handoff (server layer) --
    def set_pending(self, digest: str) -> None:
        self._tls.digest = digest

    def clear_pending(self) -> None:
        self._tls.digest = None

    def take_pending(self) -> str | None:
        return getattr(self._tls, "digest", None)

    # -- forcing --
    def force_next(self, digest: str) -> None:
        with self._lock:
            self._force.add(digest)

    def mark_slow(self, digest: str) -> None:
        self.slow_marks += 1
        self.force_next(digest)

    def wants_force(self, digest: str) -> bool:
        """Peek (no mutation): a pending forced profile needs a REAL
        execution, so the result cache must not serve this digest."""
        with self._lock:
            return digest in self._force

    def decide(self, digest: str) -> str | None:
        """Count one execution of `digest`; return the profiling reason
        ("forced" | "first" | "sample") or None. Deterministic — cadence
        is execution-count based, so tests drive it without a clock."""
        if not self.enabled or not self.store.enabled:
            return None
        with self._lock:
            if digest in self._force:
                self._force.discard(digest)
                self._counts[digest] = self._counts.get(digest, 0) + 1
                return "forced"
            n = self._counts.get(digest, 0)
            if len(self._counts) > 4 * max(self.store.max_digests, 1):
                # bounded alongside the store; a reset re-arms
                # first-recurrence sampling, which only over-profiles
                self._counts.clear()
                n = 0
            self._counts[digest] = n + 1
            if n == 1:
                # Profile the first RE-execution, not the very first run:
                # a digest must prove it recurs before paying a segmented
                # trace, so one-shot ad-hoc statements never see the
                # profiling compile cost.  EXPLAIN ANALYZE and the slow
                # watermark still force a profile on demand.
                return "first"
            se = self.sample_every
            if se > 0 and n > 1 and n % se == 0:
                return "sample"
            return None
