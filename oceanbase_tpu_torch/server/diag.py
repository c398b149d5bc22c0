"""Diagnostics: full-link tracing, sql_audit, plan monitor, ASH sampler.

Reference surface:
  * ObTrace full-link tracing with spans flowing through the request path
    (deps/oblib/src/lib/trace/ob_trace.h);
  * sql_audit request ring buffer (observer/mysql/ob_mysql_request_manager.h)
    surfaced as __all_virtual_sql_audit;
  * per-operator plan monitor (ObMonitorNode,
    share/diagnosis/ob_sql_plan_monitor_node_list.h) -> GV$SQL_PLAN_MONITOR;
  * ASH active-session sampling (lib/ash/ob_active_session_guard.h).

TPU redesign note: a plan executes as ONE fused XLA program, so the
reference's per-operator rdtsc windows have no physical analog on device —
the honest monitoring unit is the plan run (compile time, device time,
rows, overflow retries) plus host-side phase spans (parse/plan/compile),
which is what the trace + plan monitor record here.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field


# ---- full-link tracing ------------------------------------------------------


@dataclass(slots=True)
class Span:
    trace_id: int
    span_id: int
    parent_id: int
    name: str
    start: float
    end: float = 0.0
    tags: dict = field(default_factory=dict)
    # the owning tracer's clock: a live span's elapsed must tick on the
    # SAME timebase as start/end, or injected-clock tests read nonsense
    clock: object = None

    @property
    def elapsed(self) -> float:
        end = self.end or (self.clock or time.perf_counter)()
        return end - self.start


class _SpanGuard:
    """Hand-rolled context manager for Tracer.span. The serving hot path
    enters two spans per statement; a generator-based contextmanager
    costs several times as much per enter/exit, and the finished-span
    ring is a deque whose append is atomic under the GIL — no lock."""

    __slots__ = ("_tracer", "_stack", "_span", "_record")

    def __init__(self, tracer, stack, span, record):
        self._tracer = tracer
        self._stack = stack
        self._span = span
        self._record = record

    def __enter__(self):
        self._stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        s = self._span
        if exc is not None:
            # failed statements must stay findable in the span ring
            # (__all_virtual_trace_span filters on error != '')
            s.tags["error"] = repr(exc)
        if self._record:
            s.end = self._tracer._clock()
        self._stack.pop()
        if self._record:
            self._tracer._done.append(s)
        return False


class Tracer:
    """Per-database tracer: thread-local span stacks, finished-span ring.

    Two recording shapes:
      * `span()` — a contextmanager for work on the CURRENT thread; nests
        via the thread-local stack (or an explicit `ctx=` parent when the
        logical parent lives on another thread, e.g. a DAG task running a
        statement-initiated compaction);
      * `record_span()` — a retrospective finished span for work measured
        on a DIFFERENT clock/thread (palf replication rounds timed on the
        bus virtual clock), stitched into a trace via an explicit
        (trace_id, parent_span_id) context captured at submit time.
    """

    def __init__(self, capacity: int = 4096, clock=time.perf_counter):
        self._ids = itertools.count(1)
        self._clock = clock
        self._local = threading.local()
        self._done: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.enabled = True

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, ctx: tuple | None = None, **tags):
        st = self._stack()
        parent = st[-1] if st else None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif ctx:
            # adopt a propagated (trace_id, parent_span_id) — task
            # dispatch across threads / bus hops carries this explicitly
            # because thread-locals do not travel
            trace_id, parent_id = int(ctx[0]), int(ctx[1])
        else:
            trace_id, parent_id = next(self._ids), 0
        # the span goes on the stack even when disabled: nested spans must
        # inherit the parent's trace_id either way, or callers that stash
        # current_trace_id() get ids that differ by flag state. Only the
        # RING write (the allocation that costs memory) is gated — and on
        # the disabled path the clock reads and the tag-dict copy go too
        # (hot-path overhead diet: a disabled span is id bookkeeping only).
        record = self.enabled
        s = Span(
            trace_id=trace_id,
            span_id=next(self._ids),
            parent_id=parent_id,
            name=name,
            start=self._clock() if record else 0.0,
            tags=dict(tags) if record else tags,
            clock=self._clock,
        )
        return _SpanGuard(self, st, s, record)

    def current_trace_id(self) -> int:
        st = self._stack()
        return st[-1].trace_id if st else 0

    def current_ctx(self) -> tuple[int, int] | None:
        """(trace_id, span_id) of the active span — the propagation
        context stamped onto bus messages and background-task dispatch."""
        st = self._stack()
        return (st[-1].trace_id, st[-1].span_id) if st else None

    def record_span(self, name: str, ctx: tuple | None, start: float,
                    end: float, **tags) -> Span | None:
        """Append an already-finished span measured elsewhere (bus virtual
        clock, another node). `ctx` is the propagated parent context; a
        missing one mints a fresh trace so the span is still findable."""
        if not self.enabled:
            return None
        if ctx:
            trace_id, parent_id = int(ctx[0]), int(ctx[1])
        else:
            trace_id, parent_id = next(self._ids), 0
        s = Span(
            trace_id=trace_id,
            span_id=next(self._ids),
            parent_id=parent_id,
            name=name,
            start=start,
            end=end,
            tags=dict(tags),
            clock=self._clock,
        )
        with self._lock:
            self._done.append(s)
        return s

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._done)

    def trace_tree(self, trace_id: int) -> list[tuple[int, Span]]:
        """Spans of one trace as a depth-first (depth, span) walk — the
        rendering order of SHOW TRACE. Orphans (parent fell off the ring
        or lives on another tenant's tracer) surface at depth 0."""
        spans = [s for s in self.spans() if s.trace_id == trace_id]
        by_parent: dict[int, list[Span]] = {}
        ids = {s.span_id for s in spans}
        for s in spans:
            pid = s.parent_id if s.parent_id in ids else 0
            by_parent.setdefault(pid, []).append(s)
        for v in by_parent.values():
            v.sort(key=lambda s: (s.start, s.span_id))
        out: list[tuple[int, Span]] = []

        def walk(pid: int, depth: int) -> None:
            for s in by_parent.get(pid, ()):
                out.append((depth, s))
                walk(s.span_id, depth + 1)

        walk(0, 0)
        return out


# ---- sql_audit --------------------------------------------------------------


@dataclass(slots=True)
class AuditRecord:
    request_id: int
    session_id: int
    trace_id: int
    sql: str
    stmt_type: str
    elapsed_s: float
    rows: int
    affected: int
    plan_cache_hit: bool
    error: str = ""
    ts: float = 0.0
    # per-query resource profile (QueryProfile): compile + data-movement
    # attribution, the accelerator analog of sql_audit's rpc/io columns
    compile_s: float = 0.0
    device_bytes: int = 0
    transfer_bytes: int = 0
    peak_bytes: int = 0
    # statement retry controller (ObQueryRetryCtrl): how many times the
    # statement was transparently redriven and why ("reason xN; ...")
    retry_cnt: int = 0
    retry_info: str = ""
    # statement fast path: serving-phase breakdown at record time. For a
    # lazy result set fetch_us covers only the completion sync (ovf+nrows);
    # column transfers the client performs later accrue to the in-place
    # QueryProfile, not to this snapshot.
    fastparse_us: int = 0
    bind_us: int = 0
    dispatch_us: int = 0
    fetch_us: int = 0
    is_fast_path: bool = False
    # cross-session micro-batching (server/batcher.py): statements that
    # rode a shared batched dispatch carry the batch id (join lanes of
    # one launch) and the time spent in the group-commit window
    is_batched: bool = False
    batch_id: int = 0
    batch_wait_us: int = 0
    # host-tax gap ledger (share/gap_ledger.py): time the chip sat idle
    # during this statement's wall, and the wall the ledger could not
    # attribute to any named phase (the conservation residual)
    chip_idle_us: int = 0
    unattributed_us: int = 0


class SqlAudit:
    """Fixed-capacity ring of per-statement records (ob_mysql_request_manager
    keeps a memory-bounded ring; entry count is the proxy here). The
    timestamp clock is injectable so virtual-clock tests get deterministic
    `ts` values (live servers keep wall time)."""

    def __init__(self, capacity: int = 10000, clock=time.time):
        self._ring: deque[AuditRecord] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._clock = clock
        self.enabled = True

    def record(self, **kw) -> None:
        if not self.enabled:
            return
        # itertools.count and deque.append are both atomic under the GIL:
        # one audit record per statement appends lock-free. (A record
        # racing set_capacity's ring swap may land in the retired ring —
        # an accepted loss, capacity changes are a rare admin action.)
        self._ring.append(
            AuditRecord(request_id=next(self._ids), ts=self._clock(), **kw)
        )

    def records(self) -> list[AuditRecord]:
        with self._lock:
            return list(self._ring)

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=capacity)


# ---- plan monitor -----------------------------------------------------------


@dataclass
class PlanMonitorEntry:
    """Per compiled plan (the TPU monitoring unit — one XLA executable)."""

    plan_id: int
    sql: str
    compile_s: float = 0.0
    runs: int = 0
    total_exec_s: float = 0.0
    last_rows: int = 0
    overflow_retries: int = 0
    # QueryProfile accumulation across runs of this plan: data movement
    # and working-set footprint per compiled executable
    total_transfer_bytes: int = 0
    last_device_bytes: int = 0
    peak_bytes: int = 0
    # mesh-SPMD plans: cumulative XLA collectives dispatched / their byte
    # capacity, plus a compact per-collective layout ("all_to_all:2,psum:1")
    px_collective_ops: int = 0
    px_collective_bytes: int = 0
    px_exchanges: str = ""
    # streaming pipeline (engine/pipeline.py): chunks streamed through
    # this plan, last run's H2D/compute overlap fraction, and grace-hash
    # partitions spilled to host segments
    stream_chunks: int = 0
    h2d_overlap_pct: float = 0.0
    spill_partitions: int = 0

    @property
    def avg_exec_s(self) -> float:
        return self.total_exec_s / self.runs if self.runs else 0.0


class PlanMonitor:
    def __init__(self, capacity: int = 1024):
        self._entries: deque[PlanMonitorEntry] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.enabled = True

    def register(self, sql: str, compile_s: float) -> PlanMonitorEntry:
        e = PlanMonitorEntry(next(self._ids), sql, compile_s=compile_s)
        with self._lock:
            self._entries.append(e)
        return e

    def entries(self) -> list[PlanMonitorEntry]:
        with self._lock:
            return list(self._entries)


# ---- ASH (active session history) ------------------------------------------


@dataclass(slots=True)
class AshSample:
    ts: float
    session_id: int
    activity: str
    sql: str
    trace_id: int


class _ActivityGuard:
    """Hand-rolled context manager for AshSampler.activity — one per
    statement on the serving hot path."""

    __slots__ = ("_active", "_sid")

    def __init__(self, active, sid):
        self._active = active
        self._sid = sid

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        self._active.pop(self._sid, None)
        return False


class AshSampler:
    """Samples what every active session is doing.

    Sessions publish their current activity via `activity()` guards; the
    sampler snapshots all active entries — on a timer thread in live
    deployments (`start`), or on demand (`sample_once`) in deterministic
    tests. History is a bounded ring like the reference's ASH buffer."""

    def __init__(self, capacity: int = 90000, interval_s: float = 1.0,
                 clock=time.time):
        self._active: dict[int, tuple[str, str, int]] = {}
        self._ring: deque[AshSample] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._interval = interval_s
        self._clock = clock
        self._timer: threading.Timer | None = None

    def activity(self, session_id: int, activity: str, sql: str = "",
                 trace_id: int = 0):
        # dict store/pop on a per-session key are atomic under the GIL;
        # taking the sampler lock twice per statement made this the most
        # contended point of the serving hot path under many sessions.
        # sample_once snapshots via list(...) so it never iterates a
        # dict being mutated by session threads.
        self._active[session_id] = (activity, sql, trace_id)
        return _ActivityGuard(self._active, session_id)

    def sample_once(self, now: float | None = None) -> int:
        ts = self._clock() if now is None else now
        snap = list(self._active.items())
        with self._lock:
            for sid, (act, sql, tid) in snap:
                self._ring.append(AshSample(ts, sid, act, sql, tid))
        return len(snap)

    def start(self) -> None:
        def tick():
            self.sample_once()
            with self._lock:
                if self._timer is not None:
                    self._timer = threading.Timer(self._interval, tick)
                    self._timer.daemon = True
                    self._timer.start()

        with self._lock:
            if self._timer is None:
                self._timer = threading.Timer(self._interval, tick)
                self._timer.daemon = True
                self._timer.start()

    def stop(self) -> None:
        with self._lock:
            t, self._timer = self._timer, None
        if t is not None:
            t.cancel()

    def samples(self) -> list[AshSample]:
        with self._lock:
            return list(self._ring)


# ---- per-query resource profile ---------------------------------------------


@dataclass(slots=True)
class QueryProfile:
    """TPU cost attribution for ONE statement execution.

    The unit economics of an accelerator engine are compile time, bytes
    moved across the host<->device boundary, and device-resident working
    set (PAPERS.md: Tailwind's accounting prerequisite). All numbers are
    host-observed: array `nbytes` at the operator boundaries (input
    batches, parameter upload, result fetch) — nothing here runs inside
    traced code."""

    compile_hit: bool = False  # plan cache served the XLA executable
    compile_s: float = 0.0  # trace + XLA compile seconds (0 on hit)
    h2d_bytes: int = 0  # host->device: new batch uploads + parameters
    d2h_bytes: int = 0  # device->host: bytes ACTUALLY fetched (lazy
    # results grow this in place as the cursor transfers columns)
    device_bytes: int = 0  # device-resident input + output footprint
    peak_bytes: int = 0  # working-set estimate (inputs+outputs+exchanges)
    # serving-path phase breakdown (statement fast path): where the host
    # microseconds go once the kernel is no longer the bottleneck
    fastparse_s: float = 0.0  # tokenize + text-tier lookup + literal bind
    bind_s: float = 0.0  # parameter pack (one int64 vector upload)
    dispatch_s: float = 0.0  # async XLA dispatch (enqueue, no sync)
    fetch_s: float = 0.0  # device->host syncs: ovf/nrows + column fetches
    fast_path_hit: bool = False  # statement skipped parse/resolve/plan

    @property
    def transfer_bytes(self) -> int:
        return self.h2d_bytes + self.d2h_bytes

    def as_dict(self) -> dict:
        return {
            "compile_hit": self.compile_hit,
            "compile_us": int(self.compile_s * 1e6),
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "transfer_bytes": self.transfer_bytes,
            "device_bytes": self.device_bytes,
            "peak_bytes": self.peak_bytes,
            "fastparse_us": int(self.fastparse_s * 1e6),
            "bind_us": int(self.bind_s * 1e6),
            "dispatch_us": int(self.dispatch_s * 1e6),
            "fetch_us": int(self.fetch_s * 1e6),
            "is_fast_path": self.fast_path_hit,
        }


# ---- long-running operations ------------------------------------------------


@dataclass
class LongOp:
    """One background job's progress row (__all_virtual_long_ops analog:
    the reference surfaces index build / migration / compaction progress
    through ob_all_virtual_long_ops_status)."""

    op_id: int
    name: str  # e.g. "mini_compaction", "index_backfill", "ha_migration"
    target: str  # what it operates on (tablet/table/ls identity)
    total: int = 0  # work units expected (0 = unknown)
    done: int = 0
    status: str = "RUNNING"  # RUNNING | DONE | FAILED
    trace_id: int = 0  # initiating statement's trace (0 = autonomous)
    start_ts: float = 0.0
    end_ts: float = 0.0
    message: str = ""

    @property
    def percent(self) -> float:
        if self.status == "DONE":
            return 100.0
        return 100.0 * self.done / self.total if self.total else 0.0


class LongOps:
    """Registry of running + recently-finished background jobs. Handles
    are plain LongOp rows the owning job mutates through the registry
    (update/finish), so readers always see a consistent snapshot."""

    def __init__(self, capacity: int = 256, clock=time.perf_counter):
        self._ids = itertools.count(1)
        self._active: dict[int, LongOp] = {}
        self._finished: deque[LongOp] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._clock = clock

    def start(self, name: str, target: str = "", total: int = 0,
              trace_id: int = 0) -> LongOp:
        op = LongOp(next(self._ids), name, target, total=total,
                    trace_id=trace_id, start_ts=self._clock())
        with self._lock:
            self._active[op.op_id] = op
        return op

    def update(self, op: LongOp, done: int | None = None,
               message: str = "") -> None:
        with self._lock:
            if done is not None:
                op.done = done
            if message:
                op.message = message

    def finish(self, op: LongOp, ok: bool = True, message: str = "") -> None:
        with self._lock:
            if self._active.pop(op.op_id, None) is None:
                return  # double-finish: first decision wins
            op.status = "DONE" if ok else "FAILED"
            op.end_ts = self._clock()
            if ok and op.total:
                op.done = op.total
            if message:
                op.message = message
            self._finished.append(op)

    def ops(self) -> list[LongOp]:
        with self._lock:
            return list(self._finished) + sorted(
                self._active.values(), key=lambda o: o.op_id
            )


# ---- slow-query flight recorder ---------------------------------------------


class FlightRecorder:
    """Bounded ring of diagnostic bundles for statements that crossed the
    trace_log_slow_query_watermark — evidence captured AT the moment the
    slow statement finished, not reconstructed later (the obdiag 'gather'
    pain point: by the time anyone runs it, sysstat moved on).

    The metrics-delta baseline advances on every recorded bundle: each
    bundle's `metrics_delta` covers the window since the previous bundle
    (or process start) at zero per-statement cost — snapshotting counters
    around EVERY statement would show up in the overhead bench."""

    def __init__(self, capacity: int = 64, watermark_s: float = 1.0):
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._baseline: dict[str, float] = {}
        self._ids = itertools.count(1)
        self.watermark_s = watermark_s
        self.enabled = True

    def should_record(self, elapsed_s: float) -> bool:
        return self.enabled and elapsed_s >= self.watermark_s

    def record(self, bundle: dict, counters: dict | None = None) -> dict:
        """Store one bundle; when a counters snapshot is provided, attach
        the delta vs the previous bundle's baseline."""
        with self._lock:
            bundle = dict(bundle)
            bundle["bundle_id"] = next(self._ids)
            if counters is not None:
                delta = {
                    k: v - self._baseline.get(k, 0)
                    for k, v in counters.items()
                    if v != self._baseline.get(k, 0)
                }
                bundle["metrics_delta"] = delta
                self._baseline = dict(counters)
            self._ring.append(bundle)
            return bundle

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=capacity)
