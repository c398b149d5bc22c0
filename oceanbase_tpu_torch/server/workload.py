"""Workload repository: digest-keyed statement summaries, table/column
access heat, device-residency census, and bounded AWR-style snapshots.

Reference surface: OceanBase's statement-summary / workload-repository
machinery (gv$sql_audit is a ring that evicts under load; the summary
tables aggregate per statement *digest* forever) plus Oracle-AWR-style
periodic snapshots that make "before vs. after a tuning change" a diff
instead of a guess.

Three collectors, one snapshot engine:

  * StatementSummaryRegistry — every completed statement folds into the
    per-digest rolling stats (exec/fail/retry counts, latency histogram,
    phase sums, transfer bytes). The digest is the kind-marked normalized
    text sql/parser.fast_normalize already produces for the fast path, so
    warm serving statements pay ZERO extra tokenization. Surfaced as
    __all_virtual_statement_summary.
  * TableAccessStats — per-table scan/row/DAS counts and per-column
    filter/join/group/sort reference counts, attributed at plan-compile
    time (Executor.prepare builds an access profile once per compiled
    plan; each execution folds the precomputed profile — no plan walks on
    the hot path). Surfaced as __all_virtual_table_access_stat.
  * device_census() — what actually lives on the device right now:
    per-table device-cache bytes, compiled-plan entries with hit counts
    and pow2 batch-bucket shapes, the fast text tier, and the block
    cache. Surfaced as __all_virtual_device_census.

WorkloadRepository captures all three plus a sysstat counter snapshot
into a bounded ring (SNAPSHOT WORKLOAD statement, or periodic via
workload_snapshot_interval on an injectable clock); tools/awr_report.py
diffs two snapshots into a report + machine-readable advisor block (the
data contract ROADMAP item 3's layout advisor consumes).

Hot-path discipline (same rules as server/diag.py): `enabled` early
returns, the per-statement step is one buffered tuple append under a
per-session lock (the real folding runs cache-hot in batch drains; see
_SessionFold), and the drain measures its own cost (stmt summary fold
ns) so the overhead is itself a sysstat line.
"""

from __future__ import annotations

import threading
import time
import weakref
from bisect import bisect_left
from dataclasses import dataclass, field

from ..share.metrics import DEFAULT_BUCKETS, Histogram

# all digest histograms share the default bucket bounds; accumulators
# bucket locally by index and merge counts on flush
_HIST_BOUNDS = DEFAULT_BUCKETS

# column-role indices in ColumnAccess.counts / access-profile entries
ROLE_FILTER, ROLE_JOIN, ROLE_GROUP, ROLE_SORT = 0, 1, 2, 3


@dataclass(slots=True)
class StatementSummary:
    """Rolling per-digest aggregate of every completed execution.

    exec/fail/retry counts and total/max elapsed are EXACT (folded per
    statement). The detail fields — row counts, hit counts, phase sums,
    transfer bytes, histogram — accumulate from the accumulators'
    sampled statements (sampled_count of them; digests with at
    most _SessionFold.SAMPLE_ALL consecutive executions are fully
    sampled and thus exact). as_dict() scales the sampled sums back to
    whole-population estimates by exec_count/sampled_count; histogram
    counts stay RAW because quantiles are scale-invariant and windowed
    deltas (awr_report) must subtract cleanly."""

    digest: str
    stmt_type: str = ""
    exec_count: int = 0
    fail_count: int = 0
    retry_count: int = 0
    sampled_count: int = 0
    rows_returned: int = 0
    affected_rows: int = 0
    fast_path_count: int = 0
    batched_count: int = 0
    cache_hit_count: int = 0
    total_elapsed_s: float = 0.0
    max_elapsed_s: float = 0.0
    hist: Histogram = None  # per-digest latency distribution (sampled)
    fastparse_s: float = 0.0
    bind_s: float = 0.0
    dispatch_s: float = 0.0
    fetch_s: float = 0.0
    compile_s: float = 0.0
    transfer_bytes: int = 0
    max_device_bytes: int = 0
    max_peak_bytes: int = 0
    first_seen: float = 0.0
    last_seen: float = 0.0
    # recency sequence for cold-digest eviction (cheaper than an
    # OrderedDict move_to_end on every fold)
    seq: int = 0

    def as_dict(self) -> dict:
        h = self.hist
        # scale sampled sums to whole-population estimates; k == 1.0
        # (fully sampled) for low-traffic digests, so those are exact
        k = (self.exec_count / self.sampled_count
             if self.sampled_count else 0.0)
        return {
            "digest": self.digest,
            "stmt_type": self.stmt_type,
            "exec_count": self.exec_count,
            "fail_count": self.fail_count,
            "retry_count": self.retry_count,
            "sampled_count": self.sampled_count,
            "rows_returned": round(self.rows_returned * k),
            "affected_rows": round(self.affected_rows * k),
            "fast_path_count": round(self.fast_path_count * k),
            "batched_count": round(self.batched_count * k),
            "cache_hit_count": round(self.cache_hit_count * k),
            "total_elapsed_s": self.total_elapsed_s,
            "max_elapsed_s": self.max_elapsed_s,
            "p50_s": h.p50, "p95_s": h.p95, "p99_s": h.p99,
            "hist_bounds": list(h.bounds),
            "hist_counts": list(h.counts),
            "fastparse_s": self.fastparse_s * k,
            "bind_s": self.bind_s * k,
            "dispatch_s": self.dispatch_s * k,
            "fetch_s": self.fetch_s * k,
            "compile_s": self.compile_s * k,
            "transfer_bytes": round(self.transfer_bytes * k),
            "max_device_bytes": self.max_device_bytes,
            "max_peak_bytes": self.max_peak_bytes,
            "first_seen": self.first_seen,
            "last_seen": self.last_seen,
        }


# session-local accumulation state: one plain list per digest, indexed
# by the _A_* slots below — list-index adds in the drain loop are
# cheaper than attribute writes on a stats object. The first block
# (through _A_RETRIES) is EXACT (every statement lands in it); the
# second block is fed by the sampled detail tuples and is scaled by
# exec/sampled on read (see StatementSummary.as_dict).
(_A_TYPE, _A_N, _A_ELAPSED, _A_MAX, _A_FAILS, _A_RETRIES,
 _A_SAMPLED, _A_BUCKETS, _A_ROWS, _A_AFFECTED, _A_CACHE, _A_FAST,
 _A_BATCHED, _A_FASTPARSE, _A_BIND, _A_DISPATCH, _A_FETCH, _A_COMPILE,
 _A_TRANSFER, _A_MAXDEV, _A_MAXPEAK) = range(21)


def _new_state(stmt_type: str) -> list:
    return [stmt_type, 0, 0.0, 0.0, 0, 0,
            0, {}, 0, 0, 0, 0, 0,
            0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0]


class _SessionFold:
    """Per-session statement-summary accumulator — the serving hot path.

    Per statement, only what MUST be exact is folded inline: execution
    count, elapsed sum/max, failures, retries — a handful of adds on
    this one object, all under the session's own uncontended lock. The
    expensive detail (histogram bucket, row counts, hit flags, the
    profiler's phase sums) is recorded for a 1-in-(SAMPLE_MASK+1)
    SAMPLE of each digest run, buffered as a tuple and batch-folded every
    DRAIN_AT samples; readers scale the sampled sums back up by the
    exact execution count. Short runs (the first SAMPLE_ALL statements
    after a digest change) are always sampled, so low-traffic digests
    — DDL, one-off analytics, a failing statement under diagnosis —
    report exact detail, while the hot serving digest pays the sampled
    price: folding every statement's ~20 detail fields is what used to
    cost 3-4% of serving throughput, all of it cache-cold at statement
    completion because the statement's own work just evicted it.

    The drain folds into a session-LOCAL digest map (no shared lock);
    the shared registry is touched only when a reader forces a flush
    (snapshot / virtual table / workload capture), the local map
    outgrows its cap, or the session is garbage-collected. Exact
    counts are exact at every read point because readers flush all
    live accumulators first. Each sampled tuple keeps a reference to
    the statement's QueryProfile and reads the phase sums at drain
    time — profiles are per-statement objects, and late reads also
    catch fetch time the client spent on the result after
    completion."""

    __slots__ = ("_reg", "_lock", "_sample", "_reported", "digest",
                 "stmt_type", "n", "elapsed_sum", "elapsed_max", "fails",
                 "retries", "sampled", "_buf", "_states", "__weakref__")

    DRAIN_AT = 64       # buffered sample tuples per batch fold
    SAMPLE_ALL = 8      # first statements of a run are always sampled
    SAMPLE_MASK = 15    # then 1-in-(SAMPLE_MASK+1)
    MAX_LOCAL_DIGESTS = 128  # push to the shared map past this

    def __init__(self, reg: "StatementSummaryRegistry"):
        self._reg = reg
        self._lock = threading.Lock()
        self._sample = 0    # doubles as the exact lifetime fold count
        self._reported = 0  # folds already reported to sysstat
        self._buf = []     # sampled (digest, elapsed, rows, ...) tuples
        self._states = {}  # digest -> _new_state list
        self._zero_run("", "")

    def _zero_run(self, digest: str, stmt_type: str) -> None:
        self.digest = digest
        self.stmt_type = stmt_type
        self.n = 0
        self.elapsed_sum = 0.0
        self.elapsed_max = 0.0
        self.fails = 0
        self.retries = 0
        self.sampled = 0

    def fold(self, digest: str, stmt_type: str, elapsed_s: float, err: str,
             retry_cnt: int, rs, batched: bool, prof) -> None:
        with self._lock:
            if digest != self.digest:
                if self.n:
                    self._push_run()
                self._zero_run(digest, stmt_type)
            self.n = n = self.n + 1
            self.elapsed_sum += elapsed_s
            if elapsed_s > self.elapsed_max:
                self.elapsed_max = elapsed_s
            if err:
                self.fails += 1
            if retry_cnt:
                self.retries += retry_cnt
            self._sample = sn = self._sample + 1
            if n <= self.SAMPLE_ALL or (sn & self.SAMPLE_MASK) == 0:
                # the result-set reads (memoized nrows, two attributes)
                # happen only on sampled statements
                self.sampled += 1
                b = self._buf
                if rs is not None:
                    b.append((digest, elapsed_s, rs.nrows, rs.affected,
                              rs.plan_cache_hit, batched, prof))
                else:
                    b.append((digest, elapsed_s, 0, 0, False, batched,
                              prof))
                if len(b) >= self.DRAIN_AT:
                    self._drain()

    def _push_run(self) -> None:
        """Fold the current digest run's exact counters into the local
        state map. Caller holds self._lock."""
        states = self._states
        st = states.get(self.digest)
        if st is None:
            st = states[self.digest] = _new_state(self.stmt_type)
        elif not st[_A_TYPE]:
            # state was created by a drained sample tuple (which doesn't
            # carry the statement type) before the run itself landed
            st[_A_TYPE] = self.stmt_type
        st[_A_N] += self.n
        st[_A_ELAPSED] += self.elapsed_sum
        if self.elapsed_max > st[_A_MAX]:
            st[_A_MAX] = self.elapsed_max
        st[_A_FAILS] += self.fails
        st[_A_RETRIES] += self.retries
        st[_A_SAMPLED] += self.sampled

    def _drain(self) -> None:
        """Batch-fold the buffered sample tuples into the local digest
        map. Caller holds self._lock. Times itself (whole batch, two
        timer reads) into the `stmt summary fold ns` sysstat line."""
        buf = self._buf
        if not buf:
            if self._sample != self._reported:
                self._reg._note_drain(self._sample - self._reported, 0)
                self._reported = self._sample
            return
        t0 = time.perf_counter_ns()
        self._buf = []
        states = self._states
        for (digest, elapsed_s, rows, affected, cache_hit, batched,
             prof) in buf:
            st = states.get(digest)
            if st is None:
                st = states[digest] = _new_state("")
            bk = st[_A_BUCKETS]
            i = bisect_left(_HIST_BOUNDS, elapsed_s)
            bk[i] = bk.get(i, 0) + 1
            if rows:
                st[_A_ROWS] += rows
            if affected:
                st[_A_AFFECTED] += affected
            if cache_hit:
                st[_A_CACHE] += 1
            if batched:
                st[_A_BATCHED] += 1
            if prof is not None:
                if prof.fast_path_hit:
                    st[_A_FAST] += 1
                st[_A_FASTPARSE] += prof.fastparse_s
                st[_A_BIND] += prof.bind_s
                st[_A_DISPATCH] += prof.dispatch_s
                st[_A_FETCH] += prof.fetch_s
                st[_A_COMPILE] += prof.compile_s
                st[_A_TRANSFER] += prof.h2d_bytes + prof.d2h_bytes
                if prof.device_bytes > st[_A_MAXDEV]:
                    st[_A_MAXDEV] = prof.device_bytes
                if prof.peak_bytes > st[_A_MAXPEAK]:
                    st[_A_MAXPEAK] = prof.peak_bytes
        if len(states) > self.MAX_LOCAL_DIGESTS:
            self._states = {}
            self._reg._merge_states(states)
        folds = self._sample - self._reported
        self._reported = self._sample
        self._reg._note_drain(folds, time.perf_counter_ns() - t0)

    def flush(self) -> None:
        with self._lock:
            if self.n:
                self._push_run()
                self._zero_run(self.digest, self.stmt_type)
            self._drain()
            if self._states:
                states, self._states = self._states, {}
                self._reg._merge_states(states)

    def __del__(self):
        # a dropped session flushes its tail so no completed statement
        # is ever lost (guarded: interpreter teardown order is arbitrary)
        try:
            self.flush()
        except Exception:  # noqa: BLE001
            pass


class StatementSummaryRegistry:
    """Digest -> StatementSummary, bounded by ob_sql_stat_max_digests
    with cold-digest (least-recently-merged) eviction. Sessions fold
    through per-session accumulators (`session_acc`); every reader
    (snapshot / VT / workload capture) flushes live accumulators first,
    so reads are exact without a shared lock on the serving path."""

    def __init__(self, max_digests: int = 256, clock=time.time,
                 metrics=None):
        self._lock = threading.Lock()
        self._map: dict[str, StatementSummary] = {}
        self._accs: list = []  # weakrefs to live _SessionFold
        self._clock = clock
        self._metrics = metrics
        self._seq = 0
        self.max_digests = max_digests
        self.evictions = 0
        self.enabled = True

    def session_acc(self) -> _SessionFold:
        acc = _SessionFold(self)
        with self._lock:
            self._accs.append(weakref.ref(acc))
        return acc

    def _note_drain(self, n: int, ns: int) -> None:
        """Account one accumulator drain: n statements folded, ns spent.
        The drain self-meters as a whole batch — two timer reads per
        DRAIN_AT statements instead of two per statement."""
        m = self._metrics
        if m is not None and m.enabled:
            m.bulk(adds=(("stmt summary folds", n),
                         ("stmt summary fold ns", ns)))

    def _merge_states(self, states: dict) -> None:
        """Merge a session-local digest map into the shared one. Called
        by accumulators holding their own lock; lock order is always
        acc -> registry -> metrics."""
        evicted = 0
        with self._lock:
            now = self._clock()
            mp = self._map
            for digest, st in states.items():
                s = mp.get(digest)
                if s is None:
                    if len(mp) >= self.max_digests:
                        evicted += self._evict_cold()
                    s = mp[digest] = StatementSummary(
                        digest, stmt_type=st[_A_TYPE],
                        hist=Histogram(digest), first_seen=now)
                elif not s.stmt_type and st[_A_TYPE]:
                    s.stmt_type = st[_A_TYPE]
                s.last_seen = now
                self._seq += 1
                s.seq = self._seq
                s.exec_count += st[_A_N]
                s.total_elapsed_s += st[_A_ELAPSED]
                if st[_A_MAX] > s.max_elapsed_s:
                    s.max_elapsed_s = st[_A_MAX]
                nsamp = st[_A_SAMPLED]
                s.sampled_count += nsamp
                h = s.hist
                hc = h.counts
                for i, c in st[_A_BUCKETS].items():
                    hc[i] += c
                h.count += nsamp
                if st[_A_N]:
                    # sampled share of the exact elapsed sum (the drain
                    # doesn't keep a separate per-sample time sum)
                    h.sum_s += st[_A_ELAPSED] * nsamp / st[_A_N]
                s.rows_returned += st[_A_ROWS]
                s.affected_rows += st[_A_AFFECTED]
                s.fail_count += st[_A_FAILS]
                s.retry_count += st[_A_RETRIES]
                s.cache_hit_count += st[_A_CACHE]
                s.fast_path_count += st[_A_FAST]
                s.batched_count += st[_A_BATCHED]
                s.fastparse_s += st[_A_FASTPARSE]
                s.bind_s += st[_A_BIND]
                s.dispatch_s += st[_A_DISPATCH]
                s.fetch_s += st[_A_FETCH]
                s.compile_s += st[_A_COMPILE]
                s.transfer_bytes += st[_A_TRANSFER]
                if st[_A_MAXDEV] > s.max_device_bytes:
                    s.max_device_bytes = st[_A_MAXDEV]
                if st[_A_MAXPEAK] > s.max_peak_bytes:
                    s.max_peak_bytes = st[_A_MAXPEAK]
        if evicted:
            m = self._metrics
            if m is not None and m.enabled:
                m.add("stmt summary evictions", evicted)

    def flush_all(self) -> None:
        """Pull every live session accumulator into the digest map (and
        prune accumulators whose sessions were collected)."""
        with self._lock:
            refs = list(self._accs)
        dead = 0
        for r in refs:
            acc = r()
            if acc is None:
                dead += 1
                continue
            acc.flush()
        if dead:
            with self._lock:
                self._accs = [r for r in self._accs if r() is not None]

    def _evict_cold(self) -> int:
        """Drop least-recently-merged digests down to the cap (called
        under self._lock, only when a NEW digest arrives at capacity —
        rare, so an O(n) recency scan beats per-merge LRU bookkeeping)."""
        n = 0
        while len(self._map) >= self.max_digests:
            cold = min(self._map.values(), key=lambda s: s.seq)
            del self._map[cold.digest]
            n += 1
        self.evictions += n
        return n

    def set_max_digests(self, n: int) -> None:
        with self._lock:
            self.max_digests = n
            if len(self._map) > n:
                over = len(self._map) - n
                self.evictions += over
                for s in sorted(self._map.values(),
                                key=lambda s: s.seq)[:over]:
                    del self._map[s.digest]

    def peak_estimate(self, digest: str) -> int:
        """Measured peak device working set of a digest (bytes), 0 when
        the digest is cold. The memory governor sizes admission-time
        reservations from this — the feedback loop that turns measured
        QueryProfile peaks into next-execution estimates. Reads the
        merged map only (no accumulator flush): this sits on the
        admission path of every read, and an estimate that lags one
        drain window is still conservative enough — cold digests fall
        back to ob_governor_cold_reserve anyway."""
        with self._lock:
            s = self._map.get(digest)
            return int(s.max_peak_bytes) if s is not None else 0

    def snapshot(self) -> list[dict]:
        self.flush_all()
        with self._lock:
            return [s.as_dict() for s in self._map.values()]

    def reset(self) -> None:
        self.flush_all()  # pendings die with the map, not after it
        with self._lock:
            self._map.clear()


# --------------------------------------------------------------------------
# table/column access heat
# --------------------------------------------------------------------------


# stride-sample cap for key_evidence (same budget as share/stats.py)
_EVIDENCE_CAP = 1 << 16


@dataclass(slots=True)
class ColumnAccess:
    column: str
    # [filter, join, group, sort] reference counts (ROLE_* indices)
    counts: list = field(default_factory=lambda: [0, 0, 0, 0])
    # measured key-skew evidence (key_evidence): sampled distinct count and
    # the sample fraction held by the single heaviest value, cached against
    # the snapshot Table identity so a memtable flush re-measures
    ndv: float = 0.0
    top_frac: float = 0.0
    evidence_snap: object = None


@dataclass(slots=True)
class TableAccess:
    table: str
    scans: int = 0
    rows_read: int = 0
    das_lookups: int = 0
    das_rows: int = 0
    proj_hits: int = 0
    proj_misses: int = 0
    cols: dict = field(default_factory=dict)  # name -> ColumnAccess


@dataclass(slots=True)
class _ResolvedScan:
    """One scan of one prepared plan with its stat objects pre-resolved:
    the per-execution fold touches only these references (no dict/catalog
    lookups on the hot path)."""

    tstat: TableAccess
    rows: int
    has_proj: bool
    proj_hit: bool
    cols: tuple  # of (ColumnAccess, role_index)


class TableAccessStats:
    """Per-table/column access accounting, fed by two producers: compiled
    plans (Executor.prepare builds the profile, Session._execute_entry
    folds it per execution) and the host-side DAS index/PK route
    (record_das). `epoch` invalidates the per-prepared resolved memo
    after a reset."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: dict[str, TableAccess] = {}
        self.enabled = True
        self.epoch = 0

    def resolve(self, profile) -> tuple:
        """Map an access profile — tuple of (table, scan_rows, has_proj,
        proj_hit, ((col, role), ...)) — to live stat objects, creating
        them on first sight. Called once per (prepared plan, epoch)."""
        out = []
        with self._lock:
            for table, rows, has_proj, proj_hit, cols in profile:
                t = self._tables.get(table)
                if t is None:
                    t = self._tables[table] = TableAccess(table)
                rcols = []
                for col, role in cols:
                    c = t.cols.get(col)
                    if c is None:
                        c = t.cols[col] = ColumnAccess(col)
                    rcols.append((c, role))
                out.append(_ResolvedScan(t, rows, has_proj, proj_hit,
                                         tuple(rcols)))
        return tuple(out)

    def fold_resolved(self, resolved: tuple) -> None:
        with self._lock:
            for r in resolved:
                t = r.tstat
                t.scans += 1
                t.rows_read += r.rows
                if r.proj_hit:
                    t.proj_hits += 1
                elif r.has_proj:
                    t.proj_misses += 1
                for c, role in r.cols:
                    c.counts[role] += 1

    def record_das(self, table: str, rows: int) -> None:
        """Host-side DAS index/PK lookup (server _index_route): counted
        separately from device scans — the advisor treats a das-served
        table differently from one paying full device materialization."""
        if not self.enabled:
            return
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                t = self._tables[table] = TableAccess(table)
            t.das_lookups += 1
            t.das_rows += rows

    def key_evidence(self, table: str, col: str,
                     table_obj=None) -> tuple[float, float] | None:
        """Measured join-key skew evidence: (sampled NDV, fraction of the
        sample held by the single heaviest value) for `col` of `table`,
        from a stride sample of the live snapshot column. Returns None
        when the column is absent, non-numeric, or empty. Cached against
        the snapshot Table identity — a memtable flush installs a new
        Table object, so evidence re-measures exactly when data moved."""
        if table_obj is None:
            return None
        with self._lock:
            t = self._tables.get(table)
            if t is None:
                t = self._tables[table] = TableAccess(table)
            c = t.cols.get(col)
            if c is None:
                c = t.cols[col] = ColumnAccess(col)
            if c.evidence_snap is table_obj:
                return (c.ndv, c.top_frac) if c.ndv > 0 else None
        import numpy as np

        ndv, top_frac = 0.0, 0.0
        arr = getattr(table_obj, "data", {}).get(col)
        if arr is not None and arr.dtype.kind in "iufb":
            nn = np.asarray(arr)
            valid = getattr(table_obj, "valid", {}).get(col)
            if valid is not None:
                nn = nn[np.asarray(valid, dtype=bool)]
            if len(nn) > _EVIDENCE_CAP:
                nn = nn[:: len(nn) // _EVIDENCE_CAP]
            if len(nn):
                _, counts = np.unique(nn, return_counts=True)
                ndv = float(len(counts))
                top_frac = float(counts.max()) / float(len(nn))
        with self._lock:
            c.ndv, c.top_frac, c.evidence_snap = ndv, top_frac, table_obj
        return (ndv, top_frac) if ndv > 0 else None

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "table": t.table,
                    "scans": t.scans,
                    "rows_read": t.rows_read,
                    "das_lookups": t.das_lookups,
                    "das_rows": t.das_rows,
                    "proj_hits": t.proj_hits,
                    "proj_misses": t.proj_misses,
                    "columns": [
                        {
                            "column": c.column,
                            "filter_count": c.counts[ROLE_FILTER],
                            "join_count": c.counts[ROLE_JOIN],
                            "group_count": c.counts[ROLE_GROUP],
                            "sort_count": c.counts[ROLE_SORT],
                        }
                        for c in t.cols.values()
                    ],
                }
                for t in self._tables.values()
            ]

    def reset(self) -> None:
        with self._lock:
            self._tables.clear()
            self.epoch += 1


# --------------------------------------------------------------------------
# device-residency and compile census
# --------------------------------------------------------------------------


def _dev_nbytes(o, depth: int = 0) -> int:
    """Best-effort device bytes of one batch-cache value: arrays report
    nbytes; tuples/dicts of arrays sum; ColumnBatch-shaped objects walk
    cols/valid/sel. Accounting must never fail a census."""
    if o is None or depth > 4:
        return 0
    nb = getattr(o, "nbytes", None)
    if nb is not None:
        try:
            return int(nb)
        except Exception:  # noqa: BLE001
            return 0
    if isinstance(o, (tuple, list)):
        return sum(_dev_nbytes(v, depth + 1) for v in o)
    if isinstance(o, dict):
        return sum(_dev_nbytes(v, depth + 1) for v in o.values())
    total = 0
    for attr in ("cols", "valid", "sel"):
        v = getattr(o, attr, None)
        if v is not None:
            total += _dev_nbytes(v, depth + 1)
    return total


def device_census(db) -> list[dict]:
    """What the executor/device currently holds, as flat rows of
    {kind, name, detail, entries, hits, bytes}:

      table_device  — per-table device-cache footprint (batch cache)
      compiled_plan — one row per logical plan-cache entry (hits, pow2
                      batch-bucket shapes, memoized input bytes)
      fast_text     — one row per text-tier entry (hits, stmt type)
      plan_cache    — tier totals + lifetime batched-compile count
      block_cache   — decoded-micro-block cache residency
    """
    rows: list[dict] = []
    ex = db.engine.executor
    by_table: dict[str, list] = {}
    for key, val in list(ex._batch_cache.items()):
        by_table.setdefault(key[0], [0, 0])
        acc = by_table[key[0]]
        acc[0] += 1
        acc[1] += _dev_nbytes(val)
    for name in sorted(by_table):
        entries, nbytes = by_table[name]
        rows.append({"kind": "table_device", "name": name, "detail": "",
                     "entries": entries, "hits": 0, "bytes": nbytes})
    logical, fast = db.plan_cache.census()
    tot_hits = 0
    for e in logical:
        tot_hits += e["hits"]
        detail = ""
        if e["buckets"]:
            detail = "buckets=" + ",".join(str(b) for b in e["buckets"])
        rows.append({"kind": "compiled_plan", "name": e["norm_key"][:120],
                     "detail": detail, "entries": 1, "hits": e["hits"],
                     "bytes": e["dev_bytes"]})
    for e in fast:
        rows.append({"kind": "fast_text", "name": e["text_key"][:120],
                     "detail": e["stmt_type"], "entries": 1,
                     "hits": e["hits"], "bytes": 0})
    rows.append({"kind": "plan_cache", "name": "totals",
                 "detail": f"batched_compiles={ex.batched_compiles}",
                 "entries": len(logical) + len(fast), "hits": tot_hits,
                 "bytes": sum(e["dev_bytes"] for e in logical)})
    bc = db.block_cache
    rows.append({"kind": "block_cache", "name": "block_cache",
                 "detail": (f"misses={bc.misses},"
                            f"evictions={bc.evictions},"
                            f"capacity={bc.capacity_bytes}"),
                 "entries": len(bc), "hits": bc.hits,
                 "bytes": bc.bytes_used})
    return rows


# --------------------------------------------------------------------------
# snapshot engine
# --------------------------------------------------------------------------


def ls_replica_health(db) -> list[dict]:
    """Per-replica reachability + apply-watermark lag, from the cluster
    keepalives (ha/detect.py) — the replica_unreachable sentinel rule's
    evidence. Empty when the cluster runs without keepalives (pure unit
    harnesses)."""
    cluster = getattr(db, "cluster", None)
    if cluster is None or not getattr(cluster, "keepalives", None):
        return []
    dead = cluster.unreachable_nodes()
    now_ts = cluster.gts.current()
    rows = []
    for ls_id, group in sorted(cluster.ls_groups.items()):
        for node, rep in sorted(group.items()):
            wm = rep.apply_watermark
            rows.append({
                "ls_id": ls_id, "node": node,
                "role": rep.palf.role.name,
                "unreachable": int(node in dead),
                "watermark": wm,
                "lag_us": max(0, now_ts - wm),
            })
    return rows


def build_snapshot(db, snap_id: int, ts: float) -> dict:
    tl = getattr(db, "timeline", None)
    return {
        "snap_id": snap_id,
        "ts": ts,
        "summary": db.stmt_summary.snapshot(),
        "access": db.access.snapshot(),
        "census": device_census(db),
        "sysstat": db.metrics.counters_snapshot(),
        # serving saturation view (share/timeline.py): time-sliced device
        # busy/queue buckets + the cumulative per-tenant QoS ledger — what
        # awr_report's saturation section and the health sentinel consume
        "timeline": tl.snapshot() if tl is not None else [],
        "timeline_meta": tl.meta() if tl is not None else {},
        "qos": tl.qos_totals() if tl is not None else {},
        # replica serving health (keepalive reachability + watermark lag):
        # the replica_unreachable sentinel rule's input
        "ls_replica": ls_replica_health(db),
        # device-memory governor ledger (reservation pressure + shrink
        # state): the device_memory_pressure sentinel rule's input
        "governor": (db.governor.stats()
                     if getattr(db, "governor", None) is not None else {}),
        # storage-scrub state (storage/scrub.py): pass/quarantine/repair
        # tallies — the storage_corruption sentinel rule's input
        "integrity": (db.scrubber.stats()
                      if getattr(db, "scrubber", None) is not None else {}),
        # host-tax ledger (share/gap_ledger.py): cumulative per-digest
        # phase walls + recent chip-idle windows — awr_report's "Host tax
        # (window)" section diffs two of these
        "host_tax": (db.host_tax.snapshot()
                     if getattr(db, "host_tax", None) is not None else {}),
        # operator calibration store (engine/plan_profile.py): cumulative
        # per-(digest, node) est-vs-actual records — awr_report's "Hot
        # operators (window)" section and the cardinality_misestimate
        # sentinel rule diff two of these
        "plan_profile": (db.plan_profiler.store.snapshot()
                         if getattr(db, "plan_profiler", None) is not None
                         else {}),
    }


class WorkloadRepository:
    """Bounded ring of workload snapshots. Triggered by the SNAPSHOT
    WORKLOAD statement or, when workload_snapshot_interval > 0, by the
    statement-completion path checking maybe_auto() (the clock is
    injectable, so tests drive periodic capture without sleeping)."""

    def __init__(self, capacity: int = 16, clock=time.time):
        self._lock = threading.Lock()
        self._snaps: list[dict] = []
        self._clock = clock
        self._next_id = 1
        self._last_auto: float | None = None
        self.capacity = capacity
        self.interval_s = 0.0  # 0 = periodic capture off
        # called with (previous snapshot, new snapshot) after each
        # capture — the health sentinel's evaluation hook. Exceptions are
        # swallowed: a watching rule must never fail the statement whose
        # completion triggered the capture.
        self.on_snapshot = None

    def take(self, db) -> dict:
        with self._lock:
            snap_id = self._next_id
            self._next_id += 1
        snap = build_snapshot(db, snap_id, self._clock())
        with self._lock:
            prev = self._snaps[-1] if self._snaps else None
            self._snaps.append(snap)
            while len(self._snaps) > self.capacity:
                self._snaps.pop(0)
        cb = self.on_snapshot
        if cb is not None and prev is not None:
            try:
                cb(prev, snap)
            except Exception:  # noqa: BLE001
                pass
        return snap

    def maybe_auto(self, db) -> dict | None:
        """Periodic capture: at most one snapshot per interval, stamped
        from the injected clock. Callers pre-check interval_s > 0 so the
        disabled path costs one attribute read."""
        now = self._clock()
        with self._lock:
            if (self._last_auto is not None
                    and now - self._last_auto < self.interval_s):
                return None
            self._last_auto = now
        return self.take(db)

    def snapshots(self) -> list[dict]:
        with self._lock:
            return list(self._snaps)

    def set_capacity(self, n: int) -> None:
        with self._lock:
            self.capacity = n
            while len(self._snaps) > n:
                self._snaps.pop(0)

    def dump(self, path: str) -> int:
        """Write every held snapshot as one JSON document (the
        tools/awr_report.py input format). Returns the snapshot count."""
        import json

        snaps = self.snapshots()
        with open(path, "w") as f:
            json.dump({"snapshots": snaps}, f)
        return len(snaps)
