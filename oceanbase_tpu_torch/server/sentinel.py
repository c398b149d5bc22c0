"""Health sentinel: typed rules watching the AWR snapshot stream.

The workload repository records what happened; nothing else *watches*
it. This module evaluates a fixed set of typed rules over each pair of
consecutive workload snapshots (the reference's diagnostic-info/alarm
analog, scoped to what the rebuild can actually measure) and emits
deduplicated, severity-tagged alerts with the triggering evidence —
digest, metric deltas, snapshot ids — into a bounded ring surfaced as
__all_virtual_alert_history and rendered by tools/health_report.py.

Rules (all pure functions of two snapshots, deterministic — the tier-1
sentinel test replays a recorded pair and asserts the exact alert set):

  digest_latency_regression — a digest's window p99 vs its trailing
      cumulative baseline (first snapshot's histogram);
  error_spike / retry_spike — window failure/retry rate over the
      statement stream;
  compile_storm — compile interference events in the window's timeline
      buckets (or new compiled-plan census entries when no timeline);
  device_cache_pressure — plan/fast/block cache evictions in window;
  tenant_starvation — one tenant's admission wait diverging from its
      peers' (or repeated worker-queue rejections) in the QoS ledger;
  fastpath_collapse — warm fast-path hit rate falling off a healthy
      baseline;
  replica_unreachable — a node's replicas went dark inside the window
      (edge-triggered on the keepalive transition);
  device_memory_pressure — sustained governor reservation-wait p99 plus
      degraded executions (OOM retries / chunked / host fallbacks) in
      the window, edge-triggered like replica_unreachable;
  storage_corruption — checksum failures detected inside the window
      (scrubber or read path); critical when corruption is sitting
      UNREPAIRED at the window end, warn when every detection was
      repaired (quarantine + rewrite/rebuild/recompute);
  cardinality_misestimate — an operator's window-average actual
      cardinality diverged >= miss_ratio x from the optimizer's
      compile-time estimate (plan-profile calibration records);
      edge-triggered per (digest, node), critical when the
      misestimated operator also tops window device time.

Evaluating the same window twice never duplicates an alert: the dedup
key is (rule, subject key, window-ending snap_id).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


def _hist_quantile(bounds, counts, q: float) -> float:
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


@dataclass(frozen=True)
class SentinelConfig:
    """Rule thresholds. Defaults are deliberately conservative — a
    sentinel that cries on every window trains DBAs to ignore it."""

    regress_ratio: float = 2.0  # window p99 >= ratio * baseline p99
    regress_critical_ratio: float = 3.0
    regress_min_execs: int = 8  # window executions
    regress_min_baseline: int = 8  # baseline executions
    error_rate: float = 0.10
    error_min_stmts: int = 10
    retry_rate: float = 0.25
    compile_storm_events: int = 10
    cache_pressure_evictions: int = 16
    starve_wait_floor_s: float = 0.01  # absolute: below this, never starved
    starve_ratio: float = 5.0  # vs the best-served peer's avg wait
    starve_min_queued: int = 4  # rejections alone can prove starvation
    fastpath_floor: float = 0.5  # window hit rate at/below = collapse
    fastpath_baseline: float = 0.8  # only off a healthy baseline
    fastpath_min_stmts: int = 20
    # device_memory_pressure: reservation-wait p99 above the floor AND
    # degraded executions (OOM retries / chunked / host fallbacks) in
    # the window
    govr_wait_p99_s: float = 0.05
    govr_min_degraded: int = 1
    # storage_corruption: checksum failures in window to fire at all
    corruption_min_failures: int = 1
    # cardinality_misestimate: window miss factor + executions floor
    miss_ratio: float = 8.0
    miss_min_execs: int = 5


@dataclass
class Alert:
    alert_id: int
    ts: float
    rule: str
    severity: str  # warn | critical
    key: str  # subject (digest / tenant / "" for engine-wide)
    summary: str
    first_snap_id: int
    last_snap_id: int
    evidence: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "alert_id": self.alert_id, "ts": self.ts, "rule": self.rule,
            "severity": self.severity, "key": self.key,
            "summary": self.summary, "first_snap_id": self.first_snap_id,
            "last_snap_id": self.last_snap_id, "evidence": self.evidence,
        }


def _sys_delta(first: dict, last: dict, name: str) -> float:
    return (last.get("sysstat", {}).get(name, 0)
            - first.get("sysstat", {}).get(name, 0))


def _rule_digest_regression(first, last, cfg, out) -> None:
    f_by = {s["digest"]: s for s in first.get("summary", ())}
    for s in last.get("summary", ()):
        f = f_by.get(s["digest"])
        if f is None:
            continue
        base_execs = f.get("exec_count", 0)
        win_execs = s.get("exec_count", 0) - base_execs
        if (win_execs < cfg.regress_min_execs
                or base_execs < cfg.regress_min_baseline):
            continue
        bounds = s.get("hist_bounds", ())
        f_counts = f.get("hist_counts", ())
        base_p99 = _hist_quantile(f.get("hist_bounds", bounds),
                                  f_counts, 0.99)
        win_counts = [
            max(0, c - (f_counts[i] if i < len(f_counts) else 0))
            for i, c in enumerate(s.get("hist_counts", ()))
        ]
        win_p99 = _hist_quantile(bounds, win_counts, 0.99)
        if base_p99 <= 0.0 or win_p99 < cfg.regress_ratio * base_p99:
            continue
        ratio = win_p99 / base_p99
        out.append({
            "rule": "digest_latency_regression",
            "severity": ("critical"
                         if ratio >= cfg.regress_critical_ratio
                         else "warn"),
            "key": s["digest"],
            "summary": (f"p99 {base_p99 * 1e6:.0f}us -> "
                        f"{win_p99 * 1e6:.0f}us ({ratio:.1f}x) over "
                        f"{win_execs} window executions"),
            "evidence": {
                "digest": s["digest"],
                "baseline_p99_s": base_p99,
                "window_p99_s": win_p99,
                "ratio": round(ratio, 3),
                "window_execs": win_execs,
                "baseline_execs": base_execs,
            },
        })


def _rule_error_retry(first, last, cfg, out) -> None:
    stmts = _sys_delta(first, last, "sql statements")
    if stmts < cfg.error_min_stmts:
        return
    fails = _sys_delta(first, last, "sql fail count")
    rate = fails / stmts
    if rate >= cfg.error_rate:
        out.append({
            "rule": "error_spike",
            "severity": "critical" if rate >= 2 * cfg.error_rate else "warn",
            "key": "",
            "summary": (f"{fails:.0f}/{stmts:.0f} statements failed "
                        f"({100 * rate:.0f}%) in window"),
            "evidence": {"window_stmts": stmts, "window_fails": fails,
                         "fail_rate": round(rate, 4)},
        })
    f_by = {s["digest"]: s for s in first.get("summary", ())}
    retries = sum(
        max(0, s.get("retry_count", 0)
            - f_by.get(s["digest"], {}).get("retry_count", 0))
        for s in last.get("summary", ())
    )
    rrate = retries / stmts
    if rrate >= cfg.retry_rate:
        out.append({
            "rule": "retry_spike",
            "severity": "warn",
            "key": "",
            "summary": (f"{retries} statement retries over {stmts:.0f} "
                        f"statements ({100 * rrate:.0f}%) in window"),
            "evidence": {"window_stmts": stmts, "window_retries": retries,
                         "retry_rate": round(rrate, 4)},
        })


def _window_timeline(first, last) -> list[dict]:
    t0, t1 = first.get("ts", 0.0), last.get("ts", 0.0)
    # bucket ts is the floored bucket START: include the bucket the
    # window starts inside, else short windows see zero buckets
    bucket_s = last.get("timeline_meta", {}).get("bucket_s", 1.0)
    return [b for b in last.get("timeline", ())
            if t0 - bucket_s < b.get("ts", -1.0 - bucket_s) <= t1]


def _rule_compile_storm(first, last, cfg, out) -> None:
    buckets = _window_timeline(first, last)
    events = sum(b.get("compile_events", 0) for b in buckets)
    compile_s = sum(b.get("compile_s", 0.0) for b in buckets)
    if not buckets:
        # old dumps without a timeline: fall back to census churn
        f_plans = {r["name"] for r in first.get("census", ())
                   if r.get("kind") == "compiled_plan"}
        events = sum(1 for r in last.get("census", ())
                     if r.get("kind") == "compiled_plan"
                     and r["name"] not in f_plans)
    if events < cfg.compile_storm_events:
        return
    out.append({
        "rule": "compile_storm",
        "severity": "warn",
        "key": "",
        "summary": (f"{events} compile events "
                    f"({compile_s:.2f}s of XLA compiles) in window"),
        "evidence": {"compile_events": events,
                     "compile_s": round(compile_s, 4)},
    })


def _census_block_evictions(snap: dict) -> int:
    for r in snap.get("census", ()):
        if r.get("kind") == "block_cache":
            for part in str(r.get("detail", "")).split(","):
                if part.startswith("evictions="):
                    try:
                        return int(part.split("=", 1)[1])
                    except ValueError:
                        return 0
    return 0


def _rule_cache_pressure(first, last, cfg, out) -> None:
    ev = (_sys_delta(first, last, "plan cache eviction")
          + _sys_delta(first, last, "plan cache fast eviction"))
    bev = max(0, _census_block_evictions(last)
              - _census_block_evictions(first))
    total = ev + bev
    if total < cfg.cache_pressure_evictions:
        return
    out.append({
        "rule": "device_cache_pressure",
        "severity": "warn",
        "key": "",
        "summary": (f"{total:.0f} cache evictions in window "
                    f"(plan/fast {ev:.0f}, block {bev})"),
        "evidence": {"plan_evictions": ev, "block_evictions": bev},
    })


def _rule_tenant_starvation(first, last, cfg, out) -> None:
    q0, q1 = first.get("qos", {}), last.get("qos", {})
    win = {}
    for name, t1 in q1.items():
        t0 = q0.get(name, {})
        admitted = t1.get("admitted", 0) - t0.get("admitted", 0)
        rejected = t1.get("rejected", 0) - t0.get("rejected", 0)
        wait_s = t1.get("wait_s", 0.0) - t0.get("wait_s", 0.0)
        queued = admitted + rejected
        if queued <= 0:
            continue
        win[name] = (admitted, rejected, wait_s, wait_s / queued)
    if not win:
        return
    for name, (admitted, rejected, wait_s, avg_wait) in sorted(win.items()):
        peers = [w[3] for n, w in win.items() if n != name and w[0] > 0]
        starved_by_wait = (
            avg_wait >= cfg.starve_wait_floor_s
            and peers
            and avg_wait >= cfg.starve_ratio * max(min(peers), 1e-9)
        )
        starved_by_reject = rejected >= cfg.starve_min_queued
        if not (starved_by_wait or starved_by_reject):
            continue
        best_peer = min(peers) if peers else 0.0
        out.append({
            "rule": "tenant_starvation",
            "severity": ("critical" if starved_by_wait and starved_by_reject
                         else "warn"),
            "key": name,
            "summary": (f"tenant {name}: avg admission wait "
                        f"{avg_wait * 1e3:.1f}ms "
                        f"(best peer {best_peer * 1e3:.1f}ms), "
                        f"{rejected} rejections in window"),
            "evidence": {
                "tenant": name,
                "window_admitted": admitted,
                "window_rejected": rejected,
                "window_wait_s": round(wait_s, 6),
                "avg_wait_s": round(avg_wait, 6),
                "best_peer_avg_wait_s": round(best_peer, 6),
            },
        })


def _rule_fastpath_collapse(first, last, cfg, out) -> None:
    wh = _sys_delta(first, last, "plan cache fast hit")
    wm = _sys_delta(first, last, "plan cache fast miss")
    if wh + wm < cfg.fastpath_min_stmts:
        return
    s0 = first.get("sysstat", {})
    bh, bm = s0.get("plan cache fast hit", 0), s0.get(
        "plan cache fast miss", 0)
    if bh + bm < cfg.fastpath_min_stmts:
        return
    base_rate = bh / (bh + bm)
    win_rate = wh / (wh + wm)
    if base_rate < cfg.fastpath_baseline or win_rate > cfg.fastpath_floor:
        return
    out.append({
        "rule": "fastpath_collapse",
        "severity": "warn",
        "key": "",
        "summary": (f"fast-path hit rate {100 * win_rate:.0f}% in window "
                    f"(baseline {100 * base_rate:.0f}%)"),
        "evidence": {"window_hits": wh, "window_misses": wm,
                     "window_rate": round(win_rate, 4),
                     "baseline_rate": round(base_rate, 4)},
    })


def _rule_replica_unreachable(first, last, cfg, out) -> None:
    """A node's replicas went dark inside the window: the keepalive
    majority vote (cluster.unreachable_nodes, recorded per snapshot as
    ls_replica rows) flipped to unreachable between the two snapshots.
    Only the TRANSITION alerts — a node that stays down does not re-fire
    every window; recovery resets the edge so a flapping node alerts on
    each new outage."""
    rep0 = {(r["ls_id"], r["node"]): r for r in first.get("ls_replica", [])}
    down_nodes: dict[int, list[dict]] = {}
    for r in last.get("ls_replica", []):
        if not r.get("unreachable"):
            continue
        prev = rep0.get((r["ls_id"], r["node"]))
        if prev is not None and prev.get("unreachable"):
            continue  # was already down at the window start
        down_nodes.setdefault(r["node"], []).append(r)
    for node, reps in sorted(down_nodes.items()):
        led = sorted(r["ls_id"] for r in reps if r["role"] == "LEADER")
        out.append({
            "rule": "replica_unreachable",
            "severity": "critical" if led else "warn",
            "key": f"node{node}",
            "summary": (f"node {node} unreachable (keepalive majority "
                        f"vote); {len(reps)} replicas dark"
                        + (f", was leading ls {led}" if led else "")),
            "evidence": {
                "node": node,
                "ls_ids": sorted(r["ls_id"] for r in reps),
                "leader_ls_ids": led,
                "max_lag_us": max(r["lag_us"] for r in reps),
            },
        })


def _rule_device_memory_pressure(first, last, cfg, out) -> None:
    """Device memory stayed scarce across the window: the governor's
    reservation-wait p99 is over the floor at the window end AND
    statements actually degraded (OOM retries, chunked re-plans, host
    fallbacks or reservation rejects) inside it. Edge-triggered like
    replica_unreachable: a window that STARTS pressured doesn't re-fire
    — pressure must clear before the next alert."""
    g1 = last.get("governor") or {}
    if not g1:
        return
    degraded = int(
        _sys_delta(first, last, "device OOM retries")
        + _sys_delta(first, last, "stmt degraded chunked")
        + _sys_delta(first, last, "stmt degraded host")
        + _sys_delta(first, last, "device memory rejects"))

    def pressured(snap) -> bool:
        g = snap.get("governor") or {}
        return float(g.get("wait_p99_s", 0.0)) >= cfg.govr_wait_p99_s

    if not pressured(last) or degraded < cfg.govr_min_degraded:
        return
    if pressured(first):
        return  # was already pressured at the window start
    host = int(_sys_delta(first, last, "stmt degraded host"))
    out.append({
        "rule": "device_memory_pressure",
        "severity": "critical" if host else "warn",
        "key": "",
        "summary": (f"device memory pressure: reservation-wait p99 "
                    f"{g1.get('wait_p99_s', 0.0) * 1e3:.1f}ms, {degraded} "
                    f"degraded executions in window"),
        "evidence": {
            "wait_p99_s": g1.get("wait_p99_s", 0.0),
            "degraded": degraded,
            "oom_retries": int(_sys_delta(first, last,
                                          "device OOM retries")),
            "chunked": int(_sys_delta(first, last, "stmt degraded chunked")),
            "host": host,
            "rejects": int(_sys_delta(first, last, "device memory rejects")),
            "reserved": g1.get("reserved", 0),
            "effective_budget": g1.get("effective_budget", 0),
            "shrink": g1.get("shrink", 1.0),
        },
    })


def _rule_storage_corruption(first, last, cfg, out) -> None:
    """Checksum failures surfaced inside the window — from any verified
    read path or a scrub pass. Severity is the repair state at the
    window end: corruption that is sitting UNREPAIRED (a backup with no
    source to regenerate from, a replica that could not rebuild) is
    critical; fully-repaired detections (quarantine + rewrite/rebuild/
    recompute) warn. Edge-triggered by construction: the rule fires on
    the failure-count DELTA, so a window with no new detections is
    silent no matter how much history sysstat carries."""
    fails = int(_sys_delta(first, last, "checksum failures"))
    if fails < cfg.corruption_min_failures:
        return
    i0 = first.get("integrity") or {}
    i1 = last.get("integrity") or {}
    unrepaired = max(0, int(i1.get("unrepaired", 0))
                     - int(i0.get("unrepaired", 0)))
    quarantined = int(_sys_delta(first, last, "quarantined files"))
    repairs = int(_sys_delta(first, last, "replica repairs"))
    by_class = i1.get("by_class") or {}
    bad_classes = sorted(
        c for c, v in by_class.items() if v.get("failures", 0) > 0)
    out.append({
        "rule": "storage_corruption",
        "severity": "critical" if unrepaired else "warn",
        "key": "",
        "summary": (f"{fails} checksum failures in window "
                    f"({quarantined} quarantined, {repairs} replica "
                    f"repairs); "
                    + (f"{unrepaired} UNREPAIRED" if unrepaired
                       else "all repaired")),
        "evidence": {
            "window_failures": fails,
            "window_quarantined": quarantined,
            "window_replica_repairs": repairs,
            "unrepaired": unrepaired,
            "classes": bad_classes,
            "scrub_passes": int(i1.get("passes", 0)),
        },
    })


def _rule_cardinality_misestimate(first, last, cfg, out) -> None:
    """An operator's WINDOW-average actual cardinality diverged >=
    miss_ratio x from the optimizer's compile-time estimate, with
    enough window executions (profiled samples) to trust the average.
    Reads the plan-profile calibration records workload snapshots embed
    (engine/plan_profile.OperatorProfileStore.snapshot). Edge-triggered
    per (digest, node): a record that was ALREADY misestimated at the
    window start stays silent — one alert per divergence, not one per
    window — until a recompile/eviction resets its estimate. Critical
    when the misestimated operator also tops window device time: the
    worst estimate is sitting on the hottest operator."""
    from ..engine.plan_profile import miss_factor

    p0 = (first.get("plan_profile") or {}).get("digests") or {}
    p1 = (last.get("plan_profile") or {}).get("digests") or {}
    if not p1:
        return

    def window(digest, nid, rec):
        r0 = (p0.get(digest) or {}).get(nid) or {}
        execs = (int(rec.get("executions", 0))
                 - int(r0.get("executions", 0)))
        rows = int(rec.get("rows", 0)) - int(r0.get("rows", 0))
        dev = (float(rec.get("device_us", 0.0))
               - float(r0.get("device_us", 0.0)))
        return execs, rows, dev

    hot = None  # (digest, nid) with the most window device time
    hot_dev = 0.0
    cand = []
    for digest, nodes in p1.items():
        for nid, rec in nodes.items():
            execs, rows, dev = window(digest, nid, rec)
            if dev > hot_dev:
                hot_dev, hot = dev, (digest, nid)
            if execs < cfg.miss_min_execs:
                continue
            est = rec.get("est_rows", 0)
            avg = rows / execs
            mf = miss_factor(est, avg)
            if mf < cfg.miss_ratio:
                continue
            r0 = (p0.get(digest) or {}).get(nid)
            if (r0 is not None
                    and int(r0.get("executions", 0)) >= cfg.miss_min_execs
                    and miss_factor(r0.get("est_rows", 0),
                                    r0.get("avg_rows", 0.0))
                    >= cfg.miss_ratio):
                continue  # was already misestimated at the window start
            cand.append((digest, nid, rec, execs, est, avg, mf, dev))
    for digest, nid, rec, execs, est, avg, mf, dev in cand:
        tops = (digest, nid) == hot
        out.append({
            "rule": "cardinality_misestimate",
            "severity": "critical" if tops else "warn",
            "key": f"{digest}#{nid}",
            "summary": (
                f"node {nid} ({rec.get('op_kind', '?')}) of "
                f"{digest[:60]}: est {int(est)} vs actual {avg:.0f} rows "
                f"({mf:.1f}x miss over {execs} profiled execs)"
                + (", tops window device time" if tops else "")),
            "evidence": {
                "digest": digest,
                "node_id": int(nid) if str(nid).lstrip("-").isdigit()
                else nid,
                "op_kind": rec.get("op_kind", ""),
                "est_rows": int(est),
                "window_avg_rows": avg,
                "miss_factor": mf,
                "window_executions": execs,
                "window_device_us": dev,
                "tops_window_device_time": tops,
            },
        })


_RULES = (
    _rule_digest_regression,
    _rule_error_retry,
    _rule_compile_storm,
    _rule_cache_pressure,
    _rule_tenant_starvation,
    _rule_fastpath_collapse,
    _rule_replica_unreachable,
    _rule_device_memory_pressure,
    _rule_storage_corruption,
    _rule_cardinality_misestimate,
)


def evaluate_window(first: dict, last: dict,
                    config: SentinelConfig | None = None) -> list[dict]:
    """Pure rule pass over one snapshot pair. Returns plain alert dicts
    (no ids, no dedup) in deterministic order — tools/health_report.py
    replays recorded dumps through this offline."""
    cfg = config or SentinelConfig()
    out: list[dict] = []
    for rule in _RULES:
        rule(first, last, cfg, out)
    for a in out:
        a["first_snap_id"] = first.get("snap_id", 0)
        a["last_snap_id"] = last.get("snap_id", 0)
    return out


class HealthSentinel:
    """Bounded, deduplicating alert ring over the live snapshot stream.
    WorkloadRepository calls observe() after every capture."""

    def __init__(self, capacity: int = 256,
                 config: SentinelConfig | None = None, clock=time.time):
        self._lock = threading.Lock()
        self._clock = clock
        self.config = config or SentinelConfig()
        self.capacity = max(int(capacity), 8)
        self._alerts: list[Alert] = []
        self._seen: set[tuple] = set()
        self._seen_order: list[tuple] = []
        self._next_id = 1
        self.enabled = True

    def observe(self, first: dict, last: dict) -> list[Alert]:
        """Evaluate one window; record and return only NEW alerts (the
        (rule, key, last snap) dedup makes re-evaluation idempotent)."""
        if not self.enabled or first is None or last is None:
            return []
        found = evaluate_window(first, last, self.config)
        fresh: list[Alert] = []
        now = self._clock()
        with self._lock:
            for a in found:
                dk = (a["rule"], a["key"], a["last_snap_id"])
                if dk in self._seen:
                    continue
                self._seen.add(dk)
                self._seen_order.append(dk)
                alert = Alert(
                    alert_id=self._next_id, ts=now, rule=a["rule"],
                    severity=a["severity"], key=a["key"],
                    summary=a["summary"],
                    first_snap_id=a["first_snap_id"],
                    last_snap_id=a["last_snap_id"],
                    evidence=a["evidence"],
                )
                self._next_id += 1
                self._alerts.append(alert)
                fresh.append(alert)
            while len(self._alerts) > self.capacity:
                self._alerts.pop(0)
            # the dedup memory is bounded too (it outlives the ring on
            # purpose — an alert evicted by ring pressure must not
            # resurrect on a re-evaluation of its window)
            while len(self._seen_order) > self.capacity * 4:
                self._seen.discard(self._seen_order.pop(0))
        return fresh

    def alerts(self) -> list[Alert]:
        with self._lock:
            return list(self._alerts)

    def set_capacity(self, n: int) -> None:
        with self._lock:
            self.capacity = max(int(n), 8)
            while len(self._alerts) > self.capacity:
                self._alerts.pop(0)
