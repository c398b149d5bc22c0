"""Tenant-wide metrics registry: counters, gauges, wait events, histograms.

Reference surface: the uniform stats/event fabric the reference threads
through every layer — ob_stat_event.h counter ids (GV$SYSSTAT),
ob_wait_event.h wait classes with count/total/max accumulators
(GV$SYSTEM_EVENT), and the response-time histogram behind
QUERY_RESPONSE_TIME. The rebuild keeps the same three shapes:

  * Counter/Gauge  — monotonically-added / last-set numeric stats,
    surfaced by __all_virtual_sysstat;
  * WaitEvent      — count / total_time / max_time per event class,
    surfaced by __all_virtual_system_event;
  * Histogram      — fixed log-spaced latency buckets with p50/p95/p99
    readout, surfaced by __all_virtual_query_response_time.

One registry per Database (per tenant). Everything is guarded by a single
lock — the hot-path cost is one dict lookup + float add, and the
`enabled` flag turns every record call into a cheap early return so the
overhead bench (tools/obs_overhead_bench.py) can compare on/off.

Device-side note: nothing here may be called from traced/jitted code
(Python side effects don't survive tracing). All recording happens at the
host boundaries: statement dispatch, compile, result fetch, bus delivery.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from contextlib import contextmanager
from dataclasses import dataclass, field

# log-spaced upper bounds (seconds) shared by every latency histogram:
# 50us..10s covers host parse (<100us) through XLA compiles (seconds)
DEFAULT_BUCKETS: tuple[float, ...] = (
    50e-6, 100e-6, 250e-6, 500e-6,
    1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3, 100e-3, 250e-3, 500e-3,
    1.0, 2.5, 5.0, 10.0,
)


@dataclass
class WaitEvent:
    """count/total_time/max_time accumulator for one wait-event class."""

    event: str
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def avg_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class Histogram:
    """Fixed-bucket latency histogram (cumulative-on-read, prometheus
    style: bucket i counts observations <= bounds[i], +Inf catches all)."""

    name: str
    bounds: tuple[float, ...] = DEFAULT_BUCKETS
    counts: list[int] = field(default_factory=list)
    count: int = 0
    sum_s: float = 0.0

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, seconds: float) -> None:
        self.counts[bisect_left(self.bounds, seconds)] += 1
        self.count += 1
        self.sum_s += seconds

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (the bucket boundary the
        cumulative count crosses q*total at; the last bucket reports the
        largest finite bound — an +Inf readout is useless for dashboards)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)


def _prom_name(name: str) -> str:
    """Stat names are human ('sql select count'); prometheus names are
    [a-zA-Z_][a-zA-Z0-9_]*."""
    out = []
    for ch in name.lower():
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return "ob_" + s


class MetricsRegistry:
    """Thread-safe named metrics. Names are free-form strings (the stat
    catalog grows with the engine; the virtual tables sort them)."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._waits: dict[str, WaitEvent] = {}
        self._hists: dict[str, Histogram] = {}
        self.enabled = True

    # ------------------------------------------------------------ counters
    def add(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def bulk(self, adds=(), observes=(), waits=()) -> None:
        """Apply several counter bumps / histogram observations / wait
        samples under ONE lock acquisition. The serving hot path finishes
        every statement with 2-4 metric updates; taking the registry's
        shared lock once instead of per-update keeps it off the contended
        list when many session threads complete statements together.

        `adds` is an iterable of (name, n); `observes` of (name,
        seconds); `waits` of (event, seconds)."""
        if not self.enabled:
            return
        with self._lock:
            self.bulk_locked(adds, observes, waits)

    def bulk_locked(self, adds=(), observes=(), waits=()) -> None:
        """bulk() body for callers already holding self._lock — lets a
        collaborator that shares this lock (the statement-summary
        registry) fold its own state and apply the statement's metric
        updates in ONE acquisition."""
        c = self._counters
        for name, n in adds:
            c[name] = c.get(name, 0) + n
        for name, seconds in observes:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            h.observe(seconds)
        for event, seconds in waits:
            w = self._waits.get(event)
            if w is None:
                w = self._waits[event] = WaitEvent(event)
            w.count += 1
            w.total_s += seconds
            if seconds > w.max_s:
                w.max_s = seconds

    # -------------------------------------------------------------- gauges
    def gauge_set(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        """High-watermark gauge: keep the largest value ever observed
        (queue-depth peaks outlive the instant a snapshot is taken)."""
        if not self.enabled:
            return
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0)

    # --------------------------------------------------------- wait events
    def wait(self, event: str, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            w = self._waits.get(event)
            if w is None:
                w = self._waits[event] = WaitEvent(event)
            w.count += 1
            w.total_s += seconds
            if seconds > w.max_s:
                w.max_s = seconds

    @contextmanager
    def waiting(self, event: str):
        """Time a host-side wait (lock/queue/log-sync) into its class."""
        if not self.enabled:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            self.wait(event, self._clock() - t0)

    def wait_event(self, event: str) -> WaitEvent | None:
        with self._lock:
            w = self._waits.get(event)
            return WaitEvent(w.event, w.count, w.total_s, w.max_s) if w else None

    # ----------------------------------------------------------- histograms
    def observe(self, name: str, seconds: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            h.observe(seconds)

    @contextmanager
    def timed(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            self.observe(name, self._clock() - t0)

    def histogram(self, name: str) -> Histogram | None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return None
            return Histogram(h.name, h.bounds, list(h.counts), h.count, h.sum_s)

    # ------------------------------------------------------------ snapshots
    def counters_snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges_snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def waits_snapshot(self) -> list[WaitEvent]:
        with self._lock:
            return [
                WaitEvent(w.event, w.count, w.total_s, w.max_s)
                for w in self._waits.values()
            ]

    def hists_snapshot(self) -> list[Histogram]:
        with self._lock:
            return [
                Histogram(h.name, h.bounds, list(h.counts), h.count, h.sum_s)
                for h in self._hists.values()
            ]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._waits.clear()
            self._hists.clear()

    # ------------------------------------------------------------- exporter
    def prometheus_text(self) -> str:
        """Text exposition format (one scrape of the whole registry):
        counters as `counter`, gauges as `gauge`, wait events as a
        count/sum/max triple, histograms as cumulative `le` buckets."""
        lines: list[str] = []
        for name, v in sorted(self.counters_snapshot().items()):
            p = _prom_name(name) + "_total"
            lines.append(f"# HELP {p} {name}")
            lines.append(f"# TYPE {p} counter")
            lines.append(f"{p} {v:g}")
        for name, v in sorted(self.gauges_snapshot().items()):
            p = _prom_name(name)
            lines.append(f"# HELP {p} {name}")
            lines.append(f"# TYPE {p} gauge")
            lines.append(f"{p} {v:g}")
        for w in sorted(self.waits_snapshot(), key=lambda x: x.event):
            p = _prom_name("wait " + w.event)
            lines.append(f"# HELP {p}_seconds wait event: {w.event}")
            lines.append(f"# TYPE {p}_seconds summary")
            lines.append(f"{p}_seconds_count {w.count}")
            lines.append(f"{p}_seconds_sum {w.total_s:g}")
            # a summary family only owns _count/_sum/quantile samples;
            # the max rides as its own declared gauge family so every
            # sample in the scrape belongs to a typed family
            lines.append(f"# HELP {p}_seconds_max wait event max: {w.event}")
            lines.append(f"# TYPE {p}_seconds_max gauge")
            lines.append(f"{p}_seconds_max {w.max_s:g}")
        for h in sorted(self.hists_snapshot(), key=lambda x: x.name):
            p = _prom_name(h.name) + "_seconds"
            lines.append(f"# HELP {p} latency histogram: {h.name}")
            lines.append(f"# TYPE {p} histogram")
            acc = 0
            for bound, c in zip(h.bounds, h.counts):
                acc += c
                lines.append(f'{p}_bucket{{le="{bound:g}"}} {acc}')
            lines.append(f'{p}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{p}_count {h.count}")
            lines.append(f"{p}_sum {h.sum_s:g}")
        return "\n".join(lines) + "\n"
