"""Time-sliced serving telemetry: the device/host utilization timeline.

The workload repository (server/workload.py) answers "what ran" with
point-in-time snapshots; this module answers "when, and how hard" — the
time-resolved view the async-serving front end (ROADMAP item 1) needs to
decide whether the HOST or the DEVICE is the serving ceiling. It is the
rebuild's analog of the reference's time-window stats behind
GV$OB_SERVERS cpu/time columns plus a per-tenant QoS ledger over the
OMT worker queues.

Shape: a ring of fixed-width time buckets (injectable clock — tests
drive it without sleeping; bounded memory — the ring never grows past
`capacity` buckets). Three layers feed it:

  * engine (Session._execute_entry / Executor uploads) — device-dispatch
    busy seconds, compile events, host<->device transfer interference;
  * batcher (StatementBatcher._dispatch) — batched-dispatch busy
    seconds + window-occupancy histogram (lanes per batch);
  * server (DbSession.sql / _sql_inner) — per-tenant admission waits /
    rejections against the TenantUnit worker quota, statement
    completions with host wall seconds and in-flight depth.

Every record call is a handful of GIL-atomic scalar adds into the
current bucket — no lock on the hot path (the ring lock guards only
bucket resets and readers; a preempted increment can drop a count,
which telemetry tolerates). `enabled = False` turns each record into
an attribute read; the obs_overhead_bench timeline A/B leg measures
exactly this switch under 32 serving threads.

Readout: __all_virtual_server_timeline / __all_virtual_tenant_qos
virtual tables, Database.metrics_text() gauges, and WorkloadRepository
snapshots (so tools/awr_report.py windows gain a saturation section and
server/sentinel.py can watch for starvation/compile storms).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left

from .metrics import DEFAULT_BUCKETS

# pow2 occupancy/depth histogram slots: bucket i counts samples whose
# value's next_pow2 is 2**i (slot 0 = 1, slot 10 = 1024+, clamped)
_POW2_SLOTS = 11

# per-tenant accumulator indices (one small list per tenant per bucket,
# plus one cumulative list per tenant for snapshot-diffable QoS totals)
_T_STMTS, _T_ERRORS, _T_ADMITTED, _T_REJECTED = 0, 1, 2, 3
_T_WAIT_S, _T_MAX_INFLIGHT, _T_HOST_S = 4, 5, 6
_T_FIELDS = 7

_TENANT_KEYS = ("stmts", "errors", "admitted", "rejected",
                "wait_s", "max_in_flight", "host_busy_s")


def _pow2_slot(n: int) -> int:
    s = 0
    v = 1
    while v < n and s < _POW2_SLOTS - 1:
        v <<= 1
        s += 1
    return s


def hist_quantile(bounds, counts, q: float) -> float:
    """Bucket-boundary quantile (same estimate share/metrics reports)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


class _Bucket:
    """One fixed-width time slice of serving activity."""

    __slots__ = (
        "period", "stmts", "errors", "host_busy_s", "device_busy_s",
        "dispatches", "batch_dispatches", "batch_lanes", "compile_events",
        "compile_s", "transfer_events", "transfer_bytes",
        "collective_ops", "collective_bytes",
        "stream_chunks", "stream_h2d_s", "stream_compute_s",
        "stream_overlap_s", "stream_spill_parts", "max_in_flight",
        "admitted", "rejected", "admission_wait_s", "sched_queue_max",
        "gate_admissions", "gate_wait_s", "occ_hist",
        "depth_hist", "wait_hist", "tenants",
    )

    def __init__(self):
        self.period = -1
        self.occ_hist = [0] * _POW2_SLOTS
        self.depth_hist = [0] * _POW2_SLOTS
        self.wait_hist = [0] * (len(DEFAULT_BUCKETS) + 1)
        self.tenants: dict[str, list] = {}
        self._zero()

    def _zero(self) -> None:
        self.stmts = 0
        self.errors = 0
        self.host_busy_s = 0.0
        self.device_busy_s = 0.0
        self.dispatches = 0
        self.batch_dispatches = 0
        self.batch_lanes = 0
        self.compile_events = 0
        self.compile_s = 0.0
        self.transfer_events = 0
        self.transfer_bytes = 0
        self.collective_ops = 0
        self.collective_bytes = 0
        self.stream_chunks = 0
        self.stream_h2d_s = 0.0
        self.stream_compute_s = 0.0
        self.stream_overlap_s = 0.0
        self.stream_spill_parts = 0
        self.max_in_flight = 0
        self.admitted = 0
        self.rejected = 0
        self.admission_wait_s = 0.0
        self.sched_queue_max = 0
        self.gate_admissions = 0
        self.gate_wait_s = 0.0

    def reset(self, period: int) -> None:
        self.period = period
        self._zero()
        # zero in place: the ring never reallocates its histograms
        for h in (self.occ_hist, self.depth_hist, self.wait_hist):
            for i in range(len(h)):
                h[i] = 0
        self.tenants.clear()


class ServingTimeline:
    """Bounded ring of serving-telemetry buckets, shared cluster-wide
    (tenants feed under their own name; one reader sees all of them —
    starvation is only visible ACROSS tenants)."""

    def __init__(self, bucket_s: float = 1.0, capacity: int = 120,
                 clock=time.time):
        self._lock = threading.Lock()
        self._clock = clock
        self.bucket_s = max(float(bucket_s), 1e-3)
        self.capacity = max(int(capacity), 2)
        self._ring = [_Bucket() for _ in range(self.capacity)]
        self.enabled = True
        # self-metering: records folded since construction (sysstat gauge)
        self.records = 0
        # cumulative per-tenant QoS ledger (snapshot-diffable: windows
        # longer than the ring still diff cleanly) + TenantUnit seeds
        self._totals: dict[str, list] = {}
        self._limits: dict[str, tuple] = {}

    # ---------------------------------------------------------- tenants
    def register_tenant(self, name: str, max_workers=None,
                        queue_timeout_s: float = 0.0) -> None:
        """Seed the QoS ledger from the tenant's TenantUnit limits — the
        share the scheduler (ROADMAP item 1) will enforce against."""
        with self._lock:
            self._totals.setdefault(name, [0] * _T_FIELDS)
            self._limits[name] = (max_workers, queue_timeout_s)

    # ------------------------------------------------------------ feeds
    #
    # The record_* hot path takes NO lock: under 32 serving threads the
    # single ring lock convoys and costs ~6% of throughput (measured by
    # obs_overhead_bench's timeline A/B, budget 2%). The adds are plain
    # CPython scalar/list increments — a preempted read-modify-write can
    # drop a count, which telemetry tolerates; the lock guards only the
    # once-per-period bucket reset and the reader methods below.
    def _bucket(self, now: float) -> _Bucket:
        period = int(now / self.bucket_s)
        b = self._ring[period % self.capacity]
        if b.period != period:
            with self._lock:
                if b.period < period:
                    b.reset(period)
        return b

    def _tenant(self, b: _Bucket, name: str) -> list:
        t = b.tenants.get(name)
        if t is None:
            t = b.tenants[name] = [0] * _T_FIELDS
        return t

    def _total(self, name: str) -> list:
        t = self._totals.get(name)
        if t is None:
            t = self._totals[name] = [0] * _T_FIELDS
        return t

    def record_stmt(self, tenant: str, elapsed_s: float, failed: bool,
                    in_flight: int) -> None:
        """One completed statement (the exactly-once completion point):
        host wall seconds + admitted count + in-flight depth sample."""
        if not self.enabled:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.stmts += 1
        b.admitted += 1
        b.host_busy_s += elapsed_s
        if failed:
            b.errors += 1
        if in_flight > b.max_in_flight:
            b.max_in_flight = in_flight
        b.depth_hist[_pow2_slot(max(in_flight, 1))] += 1
        t = self._tenant(b, tenant)
        t[_T_STMTS] += 1
        t[_T_ADMITTED] += 1
        t[_T_HOST_S] += elapsed_s
        if failed:
            t[_T_ERRORS] += 1
        if in_flight > t[_T_MAX_INFLIGHT]:
            t[_T_MAX_INFLIGHT] = in_flight
        tt = self._total(tenant)
        tt[_T_STMTS] += 1
        tt[_T_ADMITTED] += 1
        tt[_T_HOST_S] += elapsed_s
        if failed:
            tt[_T_ERRORS] += 1
        if in_flight > tt[_T_MAX_INFLIGHT]:
            tt[_T_MAX_INFLIGHT] = in_flight

    def record_admission(self, tenant: str, wait_s: float,
                         admitted: bool) -> None:
        """One pass through the TenantUnit worker queue (DbSession.sql):
        wait seconds into the bucket's queue-wait histogram; a timeout
        counts the tenant a rejection."""
        if not self.enabled:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.admission_wait_s += wait_s
        b.wait_hist[bisect_left(DEFAULT_BUCKETS, wait_s)] += 1
        t = self._tenant(b, tenant)
        tt = self._total(tenant)
        t[_T_WAIT_S] += wait_s
        tt[_T_WAIT_S] += wait_s
        if not admitted:
            b.rejected += 1
            t[_T_REJECTED] += 1
            tt[_T_REJECTED] += 1

    def record_exec(self, dispatch_s: float, compile_s: float,
                    d2h_bytes: int) -> None:
        """One solo device dispatch (engine Session._execute_entry):
        device busy seconds + compile/transfer interference."""
        if not self.enabled:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.device_busy_s += dispatch_s
        b.dispatches += 1
        if compile_s > 0.0:
            b.compile_events += 1
            b.compile_s += compile_s
        if d2h_bytes:
            b.transfer_events += 1
            b.transfer_bytes += d2h_bytes

    def record_batch(self, dispatch_s: float, lanes: int,
                     queued: int = 0) -> None:
        """One batched device dispatch (StatementBatcher._dispatch):
        the whole cohort's busy time once + window occupancy + the
        dispatch-gate queue depth left behind it."""
        if not self.enabled:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.device_busy_s += dispatch_s
        b.dispatches += 1
        b.batch_dispatches += 1
        b.batch_lanes += lanes
        b.occ_hist[_pow2_slot(max(lanes, 1))] += 1
        if queued > b.sched_queue_max:
            b.sched_queue_max = queued

    def record_gate(self, wait_s: float, queued: int = 0) -> None:
        """One cohort leader through the continuous-batching dispatch
        gate (StatementBatcher._lead): admission wait seconds + the
        queue depth it observed — the scheduler's backpressure trace."""
        if not self.enabled:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.gate_admissions += 1
        b.gate_wait_s += wait_s
        if queued > b.sched_queue_max:
            b.sched_queue_max = queued

    def record_transfer(self, nbytes: int) -> None:
        """One host->device upload (Executor): transfer interference —
        a cold upload stealing device time from the serving stream."""
        if not self.enabled or not nbytes:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.transfer_events += 1
        b.transfer_bytes += nbytes

    def record_collective(self, ops: int, nbytes: int) -> None:
        """One SPMD dispatch's exchange traffic (mesh PX): how many XLA
        collectives the program ran and their static byte capacity —
        cross-chip interconnect pressure, the third interference axis
        next to compiles and host transfers."""
        if not self.enabled or not ops:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.collective_ops += ops
        b.collective_bytes += nbytes

    def record_stream(self, chunks: int, h2d_s: float, compute_s: float,
                      overlap_s: float, spill_parts: int = 0) -> None:
        """One streaming execution's pipeline activity (engine
        Session._execute_entry, from the prepared plan's StreamStats
        delta): wire-busy vs compute-busy seconds and their interval-
        union overlap — the fourth interference axis, answering whether
        the H2D tunnel or the device is the out-of-core ceiling."""
        if not self.enabled or not chunks:
            return
        b = self._bucket(self._clock())
        self.records += 1
        b.stream_chunks += chunks
        b.stream_h2d_s += h2d_s
        b.stream_compute_s += compute_s
        b.stream_overlap_s += overlap_s
        b.stream_spill_parts += spill_parts

    # ---------------------------------------------------------- readout
    def snapshot(self) -> list[dict]:
        """Live buckets as dicts, oldest first. The current (partial)
        bucket reports the wall seconds actually elapsed into it, so
        busy fractions never understate a window still filling."""
        now = self._clock()
        cur_period = int(now / self.bucket_s)
        out = []
        with self._lock:
            for b in self._ring:
                if b.period < 0 or b.period > cur_period:
                    continue
                if b.period == cur_period:
                    wall = max(now - b.period * self.bucket_s, 1e-9)
                else:
                    wall = self.bucket_s
                busy = min(b.device_busy_s / wall, 1.0) if wall else 0.0
                out.append({
                    "ts": b.period * self.bucket_s,
                    "wall_s": wall,
                    "stmts": b.stmts,
                    "errors": b.errors,
                    "host_busy_s": b.host_busy_s,
                    "device_busy_s": b.device_busy_s,
                    "device_busy_frac": busy,
                    "dispatches": b.dispatches,
                    "batch_dispatches": b.batch_dispatches,
                    "batch_lanes": b.batch_lanes,
                    "compile_events": b.compile_events,
                    "compile_s": b.compile_s,
                    "transfer_events": b.transfer_events,
                    "transfer_bytes": b.transfer_bytes,
                    "collective_ops": b.collective_ops,
                    "collective_bytes": b.collective_bytes,
                    "stream_chunks": b.stream_chunks,
                    "stream_h2d_s": b.stream_h2d_s,
                    "stream_compute_s": b.stream_compute_s,
                    "stream_overlap_s": b.stream_overlap_s,
                    "stream_spill_parts": b.stream_spill_parts,
                    "h2d_overlap_frac": (
                        b.stream_overlap_s / b.stream_h2d_s
                        if b.stream_h2d_s else 0.0),
                    "max_in_flight": b.max_in_flight,
                    "admitted": b.admitted,
                    "rejected": b.rejected,
                    "admission_wait_s": b.admission_wait_s,
                    "sched_queue_max": b.sched_queue_max,
                    "gate_admissions": b.gate_admissions,
                    "gate_wait_s": b.gate_wait_s,
                    "wait_p99_s": hist_quantile(
                        DEFAULT_BUCKETS, b.wait_hist, 0.99),
                    "occ_hist": list(b.occ_hist),
                    "depth_hist": list(b.depth_hist),
                    "wait_hist": list(b.wait_hist),
                    "tenants": {
                        name: dict(zip(_TENANT_KEYS, vals))
                        for name, vals in sorted(b.tenants.items())
                    },
                })
        out.sort(key=lambda d: d["ts"])
        return out

    def meta(self) -> dict:
        """Shape constants a stdlib-only offline reader (tools/
        awr_report.py) needs to merge bucket histograms from a dump."""
        return {"bucket_s": self.bucket_s, "capacity": self.capacity,
                "wait_bounds": list(DEFAULT_BUCKETS)}

    def qos_totals(self) -> dict[str, dict]:
        """Cumulative per-tenant QoS ledger (+ TenantUnit seeds).
        Monotone since process start: two snapshots diff into exact
        window numbers even after the bucket ring wrapped."""
        with self._lock:
            out = {}
            for name in sorted(self._totals):
                d = dict(zip(_TENANT_KEYS, self._totals[name]))
                mw, qt = self._limits.get(name, (None, 0.0))
                d["max_workers"] = -1 if mw is None else int(mw)
                d["queue_timeout_s"] = qt
                out[name] = d
            return out

    def stats(self) -> dict:
        """Self-metering (bounded-memory evidence): live bucket count,
        approximate resident bytes, records folded."""
        with self._lock:
            live = sum(1 for b in self._ring if b.period >= 0)
            nten = sum(len(b.tenants) for b in self._ring)
            # ~fixed per-bucket footprint: 3 histograms + a dozen scalars
            per_bucket = (
                (_POW2_SLOTS * 2 + len(DEFAULT_BUCKETS) + 1) * 8 + 200)
            approx = (self.capacity * per_bucket
                      + (nten + len(self._totals)) * _T_FIELDS * 8 + 120)
            return {"buckets": live, "capacity": self.capacity,
                    "bytes": approx, "records": self.records}

    def meter(self, metrics) -> None:
        """Publish the self-metering stats as sysstat gauges."""
        st = self.stats()
        snap = self.snapshot()
        wall = sum(b["wall_s"] for b in snap)
        busy = sum(b["device_busy_s"] for b in snap)
        metrics.gauge_set("timeline buckets", st["buckets"])
        metrics.gauge_set("timeline bytes", st["bytes"])
        metrics.gauge_set("timeline records", st["records"])
        metrics.gauge_set(
            "timeline device busy pct",
            round(100.0 * busy / wall, 3) if wall else 0.0)

    # ----------------------------------------------------------- config
    def set_bucket_s(self, v: float) -> None:
        with self._lock:
            self.bucket_s = max(float(v), 1e-3)
            for b in self._ring:
                b.reset(-1)  # re-keyed ring: old periods no longer map

    def set_capacity(self, n: int) -> None:
        with self._lock:
            n = max(int(n), 2)
            if n == self.capacity:
                return
            self.capacity = n
            self._ring = [_Bucket() for _ in range(n)]
