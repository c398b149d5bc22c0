"""Virtual observability tables, queryable through the SQL engine.

Reference surface: the ~240 __all_virtual_* tables implemented under
src/observer/virtual_table (sql_audit, plan_cache_stat, ASH, trace,
parameters, ls/tablet info...). The rebuild materializes each on demand as
a host Table the moment a statement references it, so the full SQL surface
(filters, joins, aggregates — on the device engine) works over
observability data exactly like user data.
"""

from __future__ import annotations

import numpy as np

from ..core.dtypes import DataType, Field, Schema
from ..core.table import Table


def _t(name: str, cols: list[tuple[str, DataType, list]]) -> Table:
    schema = Schema(tuple(Field(n, dt) for n, dt, _ in cols))
    return Table.from_pydict(name, schema, {n: v for n, _dt, v in cols})


def _parameters(db) -> Table:
    snap = db.config.snapshot()
    return _t("__all_virtual_parameters", [
        ("name", DataType.varchar(), [n for n, _, _ in snap]),
        ("value", DataType.varchar(), [str(v) for _, v, _ in snap]),
        ("type", DataType.varchar(), [p.type for _, _, p in snap]),
        ("scope", DataType.varchar(), [p.scope for _, _, p in snap]),
        ("dynamic", DataType.int32(), [int(p.dynamic) for _, _, p in snap]),
        ("info", DataType.varchar(), [p.info for _, _, p in snap]),
    ])


def _tables(db) -> Table:
    tis = [db.tables[n] for n in sorted(db.tables)]
    return _t("__all_virtual_table", [
        ("table_name", DataType.varchar(), [ti.name for ti in tis]),
        ("ls_id", DataType.int64(), [ti.ls_id for ti in tis]),
        ("tablet_id", DataType.int64(), [ti.tablet_id for ti in tis]),
        ("schema_version", DataType.int64(), [ti.schema_version for ti in tis]),
        ("data_version", DataType.int64(), [ti.data_version for ti in tis]),
        ("columns", DataType.int64(), [len(ti.schema.fields) for ti in tis]),
    ])


def _plan_cache_stat(db) -> Table:
    st = db.plan_cache.stats
    return _t("__all_virtual_plan_cache_stat", [
        ("hits", DataType.int64(), [st.hits]),
        ("misses", DataType.int64(), [st.misses]),
        ("evictions", DataType.int64(), [st.evictions]),
        ("entries", DataType.int64(), [len(db.plan_cache)]),
        ("hit_rate_pct", DataType.float64(), [100.0 * st.hit_rate]),
    ])


def _sql_audit(db) -> Table:
    recs = db.audit.records()
    return _t("__all_virtual_sql_audit", [
        ("request_id", DataType.int64(), [r.request_id for r in recs]),
        ("session_id", DataType.int64(), [r.session_id for r in recs]),
        ("trace_id", DataType.int64(), [r.trace_id for r in recs]),
        ("stmt_type", DataType.varchar(), [r.stmt_type for r in recs]),
        ("query_sql", DataType.varchar(), [r.sql for r in recs]),
        ("elapsed_us", DataType.int64(),
         [int(r.elapsed_s * 1e6) for r in recs]),
        ("return_rows", DataType.int64(), [r.rows for r in recs]),
        ("affected_rows", DataType.int64(), [r.affected for r in recs]),
        ("is_hit_plan", DataType.int32(),
         [int(r.plan_cache_hit) for r in recs]),
        ("error", DataType.varchar(), [r.error for r in recs]),
        # per-query TPU resource profile (QueryProfile): the accelerator
        # analog of the reference's rpc/io cost columns
        ("compile_time_us", DataType.int64(),
         [int(r.compile_s * 1e6) for r in recs]),
        ("device_bytes", DataType.int64(), [r.device_bytes for r in recs]),
        ("transfer_bytes", DataType.int64(),
         [r.transfer_bytes for r in recs]),
        ("peak_bytes", DataType.int64(), [r.peak_bytes for r in recs]),
        # statement retry controller: redrive count + classified reasons
        ("retry_cnt", DataType.int64(), [r.retry_cnt for r in recs]),
        ("retry_info", DataType.varchar(), [r.retry_info for r in recs]),
        # statement fast path: serving-phase breakdown (fastparse = the
        # literal-extracting tokenizer, bind = literal re-bind + qparam
        # pack, dispatch = async XLA enqueue, fetch = completion sync)
        ("fastparse_us", DataType.int64(), [r.fastparse_us for r in recs]),
        ("bind_us", DataType.int64(), [r.bind_us for r in recs]),
        ("dispatch_us", DataType.int64(), [r.dispatch_us for r in recs]),
        ("fetch_us", DataType.int64(), [r.fetch_us for r in recs]),
        ("is_fast_path", DataType.int32(),
         [int(r.is_fast_path) for r in recs]),
        # cross-session micro-batching: lanes of one batched dispatch
        # share a batch_id; batch_wait_us is the group-commit window time
        ("is_batched", DataType.int32(),
         [int(r.is_batched) for r in recs]),
        ("batch_id", DataType.int64(), [r.batch_id for r in recs]),
        ("batch_wait_us", DataType.int64(),
         [r.batch_wait_us for r in recs]),
        # host-tax gap ledger: chip-idle wall + the conservation residual
        # (e2e minus every attributed phase) — see __all_virtual_host_tax
        # for the per-digest phase breakdown
        ("chip_idle_us", DataType.int64(),
         [r.chip_idle_us for r in recs]),
        ("unattributed_us", DataType.int64(),
         [r.unattributed_us for r in recs]),
    ])


def _host_tax(db) -> Table:
    """Per-digest host-tax breakdown (share/gap_ledger.py): where every
    second of e2e wall went, phase by phase, with the residual named
    instead of silently absorbed — the standing surface for ROADMAP
    item 2 ("crush the host tax")."""
    import json

    rows = db.host_tax.rows()

    def top(ph: dict):
        if not ph:
            return "", 0
        k, v = max(ph.items(), key=lambda kv: kv[1])
        return k, int(v * 1e6)

    tops = [top(r["phases"]) for r in rows]
    return _t("__all_virtual_host_tax", [
        ("digest", DataType.varchar(), [str(r["digest"]) for r in rows]),
        ("executions", DataType.int64(), [r["count"] for r in rows]),
        ("e2e_us", DataType.int64(),
         [int(r["e2e_s"] * 1e6) for r in rows]),
        ("device_us", DataType.int64(),
         [int(r["device_s"] * 1e6) for r in rows]),
        ("chip_idle_pct", DataType.float64(),
         [r["chip_idle_pct"] for r in rows]),
        ("unattributed_us", DataType.int64(),
         [int(r["unattributed_s"] * 1e6) for r in rows]),
        ("unattributed_pct", DataType.float64(),
         [r["unattributed_pct"] for r in rows]),
        ("top_phase", DataType.varchar(), [t[0] for t in tops]),
        ("top_phase_us", DataType.int64(), [t[1] for t in tops]),
        ("phases_json", DataType.varchar(),
         [json.dumps({k: round(v, 9) for k, v in sorted(
             r["phases"].items())}) for r in rows]),
    ])


def _result_cache(db) -> Table:
    """Device-resident result cache, entry by entry (LRU -> MRU):
    which tables each cached narrowed frame reads, how many live rows
    it answers with, its byte charge against the tenant unit, and how
    many repeats it has served. Aggregate hit/miss/put/eviction
    counters live in __all_virtual_sysstat (`result cache *`)."""
    rows = db.result_cache.rows()
    return _t("__all_virtual_result_cache", [
        ("tables", DataType.varchar(), [r[0] for r in rows]),
        ("result_rows", DataType.int64(), [r[1] for r in rows]),
        ("nbytes", DataType.int64(), [r[2] for r in rows]),
        ("hits", DataType.int64(), [r[3] for r in rows]),
    ])


def _plan_monitor(db) -> Table:
    """Plan monitor, reworked per-operator: every PlanMonitorEntry keeps
    its plan-level row (node_id = -1, operator columns zeroed), and every
    profiled plan additionally emits ONE ROW PER OPERATOR from the
    calibration store (engine/plan_profile.py) — node_id, op_kind,
    est_rows vs actual_rows with the misestimation factor, fenced device
    time and output bytes, keyed by the statement digest in query_sql."""
    rows: list[dict] = []
    for e in db.plan_monitor.entries():
        rows.append({
            "plan_id": e.plan_id, "query_sql": e.sql,
            "node_id": -1, "op_kind": "",
            "compile_us": int(e.compile_s * 1e6), "executions": e.runs,
            "total_exec_us": int(e.total_exec_s * 1e6),
            "avg_exec_us": int(e.avg_exec_s * 1e6),
            "last_rows": e.last_rows,
            "overflow_retries": e.overflow_retries,
            "total_transfer_bytes": e.total_transfer_bytes,
            "last_device_bytes": e.last_device_bytes,
            "peak_bytes": e.peak_bytes,
            "px_collective_ops": e.px_collective_ops,
            "px_collective_bytes": e.px_collective_bytes,
            "px_exchanges": e.px_exchanges,
            "stream_chunks": e.stream_chunks,
            "h2d_overlap_pct": round(e.h2d_overlap_pct, 3),
            "spill_partitions": e.spill_partitions,
            "est_rows": 0, "actual_rows": 0, "miss_factor": 0.0,
            "device_us": 0, "out_bytes": 0, "op_executions": 0,
        })
    pp = getattr(db, "plan_profiler", None)
    if pp is not None:
        for r in pp.store.rows():
            rows.append({
                "plan_id": r["plan_id"], "query_sql": r["digest"],
                "node_id": r["node_id"], "op_kind": r["op_kind"],
                "compile_us": 0, "executions": r["executions"],
                "total_exec_us": 0, "avg_exec_us": 0,
                "last_rows": r["last_rows"], "overflow_retries": 0,
                "total_transfer_bytes": 0, "last_device_bytes": 0,
                "peak_bytes": 0, "px_collective_ops": 0,
                "px_collective_bytes": 0, "px_exchanges": "",
                "stream_chunks": 0, "h2d_overlap_pct": 0.0,
                "spill_partitions": 0,
                "est_rows": r["est_rows"],
                "actual_rows": int(round(r["avg_rows"])),
                "miss_factor": round(r["miss_factor"], 3),
                "device_us": int(r["device_us"]),
                "out_bytes": int(r["out_bytes"]),
                "op_executions": r["executions"],
            })
    spec = [
        ("plan_id", DataType.int64()),
        ("query_sql", DataType.varchar()),
        # per-operator identity: -1/"" on plan-level rows
        ("node_id", DataType.int64()),
        ("op_kind", DataType.varchar()),
        ("compile_us", DataType.int64()),
        ("executions", DataType.int64()),
        ("total_exec_us", DataType.int64()),
        ("avg_exec_us", DataType.int64()),
        ("last_rows", DataType.int64()),
        ("overflow_retries", DataType.int64()),
        ("total_transfer_bytes", DataType.int64()),
        ("last_device_bytes", DataType.int64()),
        ("peak_bytes", DataType.int64()),
        # mesh-SPMD plans: how many XLA collectives each execution
        # dispatches, their byte capacity, and the exchange layout
        # ("all_to_all:2,psum:1"); zeros/empty for single-chip plans
        ("px_collective_ops", DataType.int64()),
        ("px_collective_bytes", DataType.int64()),
        ("px_exchanges", DataType.varchar()),
        # streaming pipeline (engine/pipeline.py): chunks streamed through
        # the plan, last run's H2D/compute overlap percentage, grace-hash
        # partitions spilled; zeros for resident plans
        ("stream_chunks", DataType.int64()),
        ("h2d_overlap_pct", DataType.float64()),
        ("spill_partitions", DataType.int64()),
        # operator calibration columns (engine/plan_profile.py):
        # estimate vs measured cardinality + fenced device time
        ("est_rows", DataType.int64()),
        ("actual_rows", DataType.int64()),
        ("miss_factor", DataType.float64()),
        ("device_us", DataType.int64()),
        ("out_bytes", DataType.int64()),
        ("op_executions", DataType.int64()),
    ]
    return _t("__all_virtual_sql_plan_monitor", [
        (name, dt, [r[name] for r in rows]) for name, dt in spec
    ])


def _ash(db) -> Table:
    ss = db.ash.samples()
    return _t("__all_virtual_ash", [
        ("sample_ts", DataType.float64(), [s.ts for s in ss]),
        ("session_id", DataType.int64(), [s.session_id for s in ss]),
        ("activity", DataType.varchar(), [s.activity for s in ss]),
        ("query_sql", DataType.varchar(), [s.sql for s in ss]),
        ("trace_id", DataType.int64(), [s.trace_id for s in ss]),
    ])


def _trace(db) -> Table:
    sp = db.tracer.spans()
    return _t("__all_virtual_trace_span", [
        ("trace_id", DataType.int64(), [s.trace_id for s in sp]),
        ("span_id", DataType.int64(), [s.span_id for s in sp]),
        ("parent_id", DataType.int64(), [s.parent_id for s in sp]),
        ("span_name", DataType.varchar(), [s.name for s in sp]),
        ("elapsed_us", DataType.int64(), [int(s.elapsed * 1e6) for s in sp]),
        ("node", DataType.varchar(),
         [str(s.tags.get("node", "")) for s in sp]),
        ("tags", DataType.varchar(),
         [",".join(f"{k}={v}" for k, v in sorted(s.tags.items())
                   if k != "node") for s in sp]),
        ("error", DataType.varchar(),
         [str(s.tags.get("error", "")) for s in sp]),
    ])


def _long_ops(db) -> Table:
    """__all_virtual_long_ops analog: background-job progress tracking."""
    ops = db.long_ops.ops()
    return _t("__all_virtual_long_ops", [
        ("op_id", DataType.int64(), [o.op_id for o in ops]),
        ("op_name", DataType.varchar(), [o.name for o in ops]),
        ("target", DataType.varchar(), [o.target for o in ops]),
        ("total", DataType.int64(), [o.total for o in ops]),
        ("done", DataType.int64(), [o.done for o in ops]),
        ("percent", DataType.int64(), [int(o.percent) for o in ops]),
        ("status", DataType.varchar(), [o.status for o in ops]),
        ("trace_id", DataType.int64(), [o.trace_id for o in ops]),
        ("message", DataType.varchar(), [o.message for o in ops]),
    ])


def _sysstat(db) -> Table:
    """GV$SYSSTAT analog: every counter and gauge in the tenant registry."""
    cs = db.metrics.counters_snapshot()
    gs = db.metrics.gauges_snapshot()
    rows = sorted(
        [(n, float(v), "counter") for n, v in cs.items()]
        + [(n, float(v), "gauge") for n, v in gs.items()]
    )
    return _t("__all_virtual_sysstat", [
        ("name", DataType.varchar(), [r[0] for r in rows]),
        ("value", DataType.int64(), [int(r[1]) for r in rows]),
        ("stat_class", DataType.varchar(), [r[2] for r in rows]),
    ])


def _system_event(db) -> Table:
    """GV$SYSTEM_EVENT analog: wait classes with count/total/max/avg."""
    ws = sorted(db.metrics.waits_snapshot(), key=lambda w: w.event)
    return _t("__all_virtual_system_event", [
        ("event", DataType.varchar(), [w.event for w in ws]),
        ("total_waits", DataType.int64(), [w.count for w in ws]),
        ("time_waited", DataType.int64(),
         [int(w.total_s * 1e6) for w in ws]),
        ("max_wait", DataType.int64(), [int(w.max_s * 1e6) for w in ws]),
        ("average_wait", DataType.int64(),
         [int(w.avg_s * 1e6) for w in ws]),
    ])


def _query_response_time(db) -> Table:
    """QUERY_RESPONSE_TIME analog: per-histogram latency buckets plus a
    quantile row set (p50/p95/p99 as bucket upper-bound estimates)."""
    rows = []
    for h in sorted(db.metrics.hists_snapshot(), key=lambda x: x.name):
        acc = 0
        for bound, c in zip(h.bounds, h.counts):
            acc += c
            rows.append((h.name, "bucket", int(bound * 1e6), acc))
        rows.append((h.name, "count", 0, h.count))
        for q, v in (("p50", h.p50), ("p95", h.p95), ("p99", h.p99)):
            rows.append((h.name, q, int(v * 1e6), h.count))
    return _t("__all_virtual_query_response_time", [
        ("histogram", DataType.varchar(), [r[0] for r in rows]),
        ("kind", DataType.varchar(), [r[1] for r in rows]),
        ("le_us", DataType.int64(), [r[2] for r in rows]),
        ("count", DataType.int64(), [r[3] for r in rows]),
    ])


def _ls(db) -> Table:
    rows = []
    for ls_id, group in sorted(db.cluster.ls_groups.items()):
        for node, rep in sorted(group.items()):
            rows.append((ls_id, node, rep.palf.role.name,
                         int(rep.is_ready), len(rep.tablets)))
    return _t("__all_virtual_ls", [
        ("ls_id", DataType.int64(), [r[0] for r in rows]),
        ("svr_node", DataType.int64(), [r[1] for r in rows]),
        ("role", DataType.varchar(), [r[2] for r in rows]),
        ("is_ready", DataType.int32(), [r[3] for r in rows]),
        ("tablet_count", DataType.int64(), [r[4] for r in rows]),
    ])


def _ls_replica(db) -> Table:
    """Per-replica serving health: role, keepalive reachability (majority
    vote over peers' NetKeepAlive evidence) and the apply watermark with
    its lag behind GTS — the staleness a follower read of that replica
    would observe."""
    cluster = db.cluster
    dead = cluster.unreachable_nodes() if cluster.keepalives else set()
    now_ts = cluster.gts.current()
    rows = []
    for ls_id, group in sorted(cluster.ls_groups.items()):
        for node, rep in sorted(group.items()):
            wm = rep.apply_watermark
            rows.append((ls_id, node, rep.palf.role.name,
                         int(rep.is_ready), int(node in dead),
                         rep.palf.applied_lsn, wm, max(0, now_ts - wm)))
    return _t("__all_virtual_ls_replica", [
        ("ls_id", DataType.int64(), [r[0] for r in rows]),
        ("svr_node", DataType.int64(), [r[1] for r in rows]),
        ("role", DataType.varchar(), [r[2] for r in rows]),
        ("is_ready", DataType.int32(), [r[3] for r in rows]),
        ("unreachable", DataType.int32(), [r[4] for r in rows]),
        ("applied_lsn", DataType.int64(), [r[5] for r in rows]),
        ("apply_watermark", DataType.int64(), [r[6] for r in rows]),
        ("watermark_lag_us", DataType.int64(), [r[7] for r in rows]),
    ])


def _processlist(db) -> Table:
    rows = sorted(db._active_stmts.items())
    return _t("__all_virtual_processlist", [
        ("session_id", DataType.int64(), [sid for sid, _ in rows]),
        ("stmt_tag", DataType.varchar(),
         [":".join(map(str, iid)) for _, iid in rows]),
        ("tenant", DataType.varchar(), [db.tenant_name for _ in rows]),
    ])


def _tablets(db) -> Table:
    rows = []
    for name in sorted(db.tables):
        ti = db.tables[name]
        for ls_id, tablet_id in ti.all_partitions():
            rows.append((tablet_id, name, ls_id))
    return _t("__all_virtual_tablet", [
        ("tablet_id", DataType.int64(), [r[0] for r in rows]),
        ("table_name", DataType.varchar(), [r[1] for r in rows]),
        ("ls_id", DataType.int64(), [r[2] for r in rows]),
    ])


def _users(db) -> Table:
    pm = db.privileges
    names = sorted(pm.users)
    return _t("__all_virtual_user", [
        ("user_name", DataType.varchar(), names),
        ("grant_count", DataType.int64(),
         [sum(len(p) for p in pm.grants.get(u, {}).values())
          for u in names]),
        ("is_root", DataType.int32(), [int(u == "root") for u in names]),
    ])


def _privileges(db) -> Table:
    pm = db.privileges
    rows = [
        (u, obj, priv)
        for u in sorted(pm.grants)
        for obj in sorted(pm.grants[u])
        for priv in sorted(pm.grants[u][obj])
    ]
    return _t("__all_virtual_privilege", [
        ("user_name", DataType.varchar(), [r[0] for r in rows]),
        ("object", DataType.varchar(), [r[1] for r in rows]),
        ("privilege", DataType.varchar(), [r[2] for r in rows]),
    ])


def _deadlock_stat(db) -> Table:
    lm = db.lock_mgr
    waits = lm.waiting_snapshot()
    return _t("__all_virtual_deadlock_stat", [
        ("deadlocks_resolved", DataType.int64(), [lm.deadlocks]),
        ("waiting_txs", DataType.int64(), [len(waits)]),
        ("wait_edges", DataType.int64(),
         [sum(len(v) for v in waits.values())]),
    ])


def _memory(db) -> Table:
    names = sorted(db.tables)
    sizes = []
    for n in names:
        t = db.catalog.get(n)
        sizes.append(
            sum(getattr(a, "nbytes", 0) for a in t.data.values())
            if t is not None else 0
        )
    return _t("__all_virtual_memory", [
        ("table_name", DataType.varchar(), names),
        ("resident_bytes", DataType.int64(), sizes),
    ])


def _indexes(db) -> Table:
    rows = []
    for name in sorted(db.tables):
        ti = db.tables[name]
        idxs = getattr(ti, "indexes", None) or {}
        if isinstance(idxs, dict):
            idxs = idxs.values()
        for ix in idxs:
            rows.append((ix.name, name, ",".join(ix.cols),
                         int(ix.unique)))
    for tname, specs in sorted(db._vector_specs.items()):
        for col, (lists, nprobe) in sorted(specs.items()):
            rows.append((f"ivf:{col}", tname, col, 0))
    return _t("__all_virtual_index", [
        ("index_name", DataType.varchar(), [r[0] for r in rows]),
        ("table_name", DataType.varchar(), [r[1] for r in rows]),
        ("columns", DataType.varchar(), [r[2] for r in rows]),
        ("is_unique", DataType.int32(), [r[3] for r in rows]),
    ])


def _external_tables(db) -> Table:
    rows = sorted(db._external_specs.items())
    return _t("__all_virtual_external_table", [
        ("table_name", DataType.varchar(), [n for n, _ in rows]),
        ("format", DataType.varchar(), [f for _, (f, _p) in rows]),
        ("location", DataType.varchar(), [p for _, (_f, p) in rows]),
    ])


def _server_stat(db) -> Table:
    n_repl = sum(len(g) for g in db.cluster.ls_groups.values())
    return _t("__all_virtual_server_stat", [
        ("tenant", DataType.varchar(), [db.tenant_name]),
        ("nodes", DataType.int64(), [db.cluster.n_nodes]),
        ("ls_groups", DataType.int64(), [len(db.cluster.ls_groups)]),
        ("replicas", DataType.int64(), [n_repl]),
        ("tables", DataType.int64(), [len(db.tables)]),
        ("active_statements", DataType.int64(), [len(db._active_stmts)]),
    ])


def _procedures(db) -> Table:
    names = sorted(db._procedure_texts)
    return _t("__all_virtual_procedure", [
        ("procedure_name", DataType.varchar(), names),
        ("definition", DataType.varchar(),
         [db._procedure_texts[n].strip()[:200] for n in names]),
    ])


def _sequences(db) -> Table:
    names = sorted(db._sequences)
    return _t("__all_virtual_sequence", [
        ("sequence_name", DataType.varchar(), names),
        ("next_value", DataType.int64(),
         [int(db._sequences[n]["next"]) for n in names]),
        ("increment_by", DataType.int64(),
         [int(db._sequences[n]["inc"]) for n in names]),
        ("reserved_until", DataType.int64(),
         [int(db._sequences[n]["reserved"]) for n in names]),
    ])


def _views(db) -> Table:
    names = sorted(db._view_specs)
    return _t("__all_virtual_view", [
        ("view_name", DataType.varchar(), names),
        ("definition", DataType.varchar(),
         [db._view_specs[n].strip()[:200] for n in names]),
    ])


def _triggers(db) -> Table:
    names = sorted(db._trigger_specs)
    return _t("__all_virtual_trigger", [
        ("trigger_name", DataType.varchar(), names),
        ("timing", DataType.varchar(),
         [db._trigger_specs[n]["timing"] for n in names]),
        ("event", DataType.varchar(),
         [db._trigger_specs[n]["event"] for n in names]),
        ("table_name", DataType.varchar(),
         [db._trigger_specs[n]["table"] for n in names]),
        ("body", DataType.varchar(),
         [db._trigger_specs[n]["body"].strip()[:200] for n in names]),
    ])


def _mviews(db) -> Table:
    names = sorted(db._mview_specs)
    return _t("__all_virtual_mview", [
        ("mview_name", DataType.varchar(), names),
        ("definition", DataType.varchar(),
         [db._mview_specs[n].strip()[:200] for n in names]),
    ])


def _statement_summary(db) -> Table:
    """Digest-keyed rolling statement aggregates (server/workload.py) —
    the durable view the sql_audit ring cannot give: per-digest exec/fail
    counts, latency quantiles and phase sums across every execution."""
    ss = db.stmt_summary.snapshot()
    us = 1e6
    return _t("__all_virtual_statement_summary", [
        ("digest", DataType.varchar(), [s["digest"] for s in ss]),
        ("stmt_type", DataType.varchar(), [s["stmt_type"] for s in ss]),
        ("executions", DataType.int64(), [s["exec_count"] for s in ss]),
        ("fails", DataType.int64(), [s["fail_count"] for s in ss]),
        ("retries", DataType.int64(), [s["retry_count"] for s in ss]),
        ("rows_returned", DataType.int64(),
         [s["rows_returned"] for s in ss]),
        ("affected_rows", DataType.int64(),
         [s["affected_rows"] for s in ss]),
        ("fast_path_hits", DataType.int64(),
         [s["fast_path_count"] for s in ss]),
        ("batched", DataType.int64(), [s["batched_count"] for s in ss]),
        ("cache_hits", DataType.int64(),
         [s["cache_hit_count"] for s in ss]),
        ("total_elapsed_us", DataType.int64(),
         [int(s["total_elapsed_s"] * us) for s in ss]),
        ("avg_elapsed_us", DataType.int64(),
         [int(s["total_elapsed_s"] / s["exec_count"] * us) for s in ss]),
        ("max_elapsed_us", DataType.int64(),
         [int(s["max_elapsed_s"] * us) for s in ss]),
        ("p50_us", DataType.int64(), [int(s["p50_s"] * us) for s in ss]),
        ("p95_us", DataType.int64(), [int(s["p95_s"] * us) for s in ss]),
        ("p99_us", DataType.int64(), [int(s["p99_s"] * us) for s in ss]),
        ("fastparse_us", DataType.int64(),
         [int(s["fastparse_s"] * us) for s in ss]),
        ("bind_us", DataType.int64(), [int(s["bind_s"] * us) for s in ss]),
        ("dispatch_us", DataType.int64(),
         [int(s["dispatch_s"] * us) for s in ss]),
        ("fetch_us", DataType.int64(),
         [int(s["fetch_s"] * us) for s in ss]),
        ("compile_us", DataType.int64(),
         [int(s["compile_s"] * us) for s in ss]),
        ("transfer_bytes", DataType.int64(),
         [s["transfer_bytes"] for s in ss]),
        ("max_device_bytes", DataType.int64(),
         [s["max_device_bytes"] for s in ss]),
        ("max_peak_bytes", DataType.int64(),
         [s["max_peak_bytes"] for s in ss]),
    ])


def _table_access_stat(db) -> Table:
    """Table/column access heat: table-level rows carry scan/DAS/
    projection counters (column_name = ''), column-level rows carry the
    per-role reference counts."""
    rows = []
    for t in db.access.snapshot():
        rows.append((t["table"], "", t["scans"], t["rows_read"],
                     t["das_lookups"], t["das_rows"], t["proj_hits"],
                     t["proj_misses"], 0, 0, 0, 0))
        for c in t["columns"]:
            rows.append((t["table"], c["column"], 0, 0, 0, 0, 0, 0,
                         c["filter_count"], c["join_count"],
                         c["group_count"], c["sort_count"]))
    return _t("__all_virtual_table_access_stat", [
        ("table_name", DataType.varchar(), [r[0] for r in rows]),
        ("column_name", DataType.varchar(), [r[1] for r in rows]),
        ("scans", DataType.int64(), [r[2] for r in rows]),
        ("rows_read", DataType.int64(), [r[3] for r in rows]),
        ("das_lookups", DataType.int64(), [r[4] for r in rows]),
        ("das_rows", DataType.int64(), [r[5] for r in rows]),
        ("proj_hits", DataType.int64(), [r[6] for r in rows]),
        ("proj_misses", DataType.int64(), [r[7] for r in rows]),
        ("filter_count", DataType.int64(), [r[8] for r in rows]),
        ("join_count", DataType.int64(), [r[9] for r in rows]),
        ("group_count", DataType.int64(), [r[10] for r in rows]),
        ("sort_count", DataType.int64(), [r[11] for r in rows]),
    ])


def _device_census(db) -> Table:
    """Device-residency and compile census: per-table device bytes,
    compiled-plan entries with hit counts and pow2 batch buckets, the
    fast text tier, block-cache residency."""
    from .workload import device_census

    rows = device_census(db)
    return _t("__all_virtual_device_census", [
        ("kind", DataType.varchar(), [r["kind"] for r in rows]),
        ("name", DataType.varchar(), [r["name"] for r in rows]),
        ("detail", DataType.varchar(), [r["detail"] for r in rows]),
        ("entries", DataType.int64(), [r["entries"] for r in rows]),
        ("hits", DataType.int64(), [r["hits"] for r in rows]),
        ("bytes", DataType.int64(), [r["bytes"] for r in rows]),
    ])


def _server_timeline(db) -> Table:
    """GV$OB_SERVERS-over-time analog: the serving timeline's bucket
    ring (share/timeline.py) — device/host busy seconds per fixed-width
    time slice, dispatch + batch-occupancy counts, compile/transfer
    interference, admission queue pressure."""
    bs = db.timeline.snapshot()
    return _t("__all_virtual_server_timeline", [
        ("bucket_ts", DataType.float64(), [b["ts"] for b in bs]),
        ("wall_us", DataType.int64(),
         [int(b["wall_s"] * 1e6) for b in bs]),
        ("stmts", DataType.int64(), [b["stmts"] for b in bs]),
        ("errors", DataType.int64(), [b["errors"] for b in bs]),
        ("host_busy_us", DataType.int64(),
         [int(b["host_busy_s"] * 1e6) for b in bs]),
        ("device_busy_us", DataType.int64(),
         [int(b["device_busy_s"] * 1e6) for b in bs]),
        ("device_busy_pct", DataType.float64(),
         [round(100.0 * b["device_busy_frac"], 3) for b in bs]),
        ("dispatches", DataType.int64(), [b["dispatches"] for b in bs]),
        ("batch_dispatches", DataType.int64(),
         [b["batch_dispatches"] for b in bs]),
        ("batch_lanes", DataType.int64(), [b["batch_lanes"] for b in bs]),
        ("compile_events", DataType.int64(),
         [b["compile_events"] for b in bs]),
        ("compile_us", DataType.int64(),
         [int(b["compile_s"] * 1e6) for b in bs]),
        ("transfer_events", DataType.int64(),
         [b["transfer_events"] for b in bs]),
        ("transfer_bytes", DataType.int64(),
         [b["transfer_bytes"] for b in bs]),
        # cross-chip interconnect pressure (mesh-SPMD dispatches): XLA
        # collectives run in the slice + their static byte capacity
        ("collective_ops", DataType.int64(),
         [b["collective_ops"] for b in bs]),
        ("collective_bytes", DataType.int64(),
         [b["collective_bytes"] for b in bs]),
        # streaming pipeline pressure per slice: chunks streamed,
        # wire-busy vs compute-busy seconds and their overlap fraction
        # (is the H2D tunnel or the device the out-of-core ceiling?),
        # grace-hash partitions spilled
        ("stream_chunks", DataType.int64(),
         [b["stream_chunks"] for b in bs]),
        ("stream_h2d_us", DataType.int64(),
         [int(b["stream_h2d_s"] * 1e6) for b in bs]),
        ("stream_compute_us", DataType.int64(),
         [int(b["stream_compute_s"] * 1e6) for b in bs]),
        ("h2d_overlap_pct", DataType.float64(),
         [round(100.0 * b["h2d_overlap_frac"], 3) for b in bs]),
        ("stream_spill_parts", DataType.int64(),
         [b["stream_spill_parts"] for b in bs]),
        ("max_in_flight", DataType.int64(),
         [b["max_in_flight"] for b in bs]),
        ("admitted", DataType.int64(), [b["admitted"] for b in bs]),
        ("rejected", DataType.int64(), [b["rejected"] for b in bs]),
        ("admission_wait_us", DataType.int64(),
         [int(b["admission_wait_s"] * 1e6) for b in bs]),
        # continuous-batching scheduler pressure per slice: queue
        # high-water mark, gate admissions and the time cohorts spent
        # queued at the dispatch gate
        ("sched_queue_max", DataType.int64(),
         [b["sched_queue_max"] for b in bs]),
        ("gate_admissions", DataType.int64(),
         [b["gate_admissions"] for b in bs]),
        ("gate_wait_us", DataType.int64(),
         [int(b["gate_wait_s"] * 1e6) for b in bs]),
        ("wait_p99_us", DataType.int64(),
         [int(b["wait_p99_s"] * 1e6) for b in bs]),
    ])


def _tenant_qos(db) -> Table:
    """Per-tenant QoS ledger: cumulative admission/served/rejected
    accounting against the TenantUnit limits each tenant was given."""
    qos = db.timeline.qos_totals()
    names = list(qos)
    return _t("__all_virtual_tenant_qos", [
        ("tenant", DataType.varchar(), names),
        ("max_workers", DataType.int64(),
         [qos[n]["max_workers"] for n in names]),
        ("queue_timeout_us", DataType.int64(),
         [int(qos[n]["queue_timeout_s"] * 1e6) for n in names]),
        ("stmts", DataType.int64(), [qos[n]["stmts"] for n in names]),
        ("errors", DataType.int64(), [qos[n]["errors"] for n in names]),
        ("admitted", DataType.int64(),
         [qos[n]["admitted"] for n in names]),
        ("rejected", DataType.int64(),
         [qos[n]["rejected"] for n in names]),
        ("wait_us", DataType.int64(),
         [int(qos[n]["wait_s"] * 1e6) for n in names]),
        ("avg_wait_us", DataType.int64(),
         [int(qos[n]["wait_s"] / max(qos[n]["admitted"]
                                     + qos[n]["rejected"], 1) * 1e6)
          for n in names]),
        ("max_in_flight", DataType.int64(),
         [qos[n]["max_in_flight"] for n in names]),
        ("host_busy_us", DataType.int64(),
         [int(qos[n]["host_busy_s"] * 1e6) for n in names]),
    ])


def _alert_history(db) -> Table:
    """Health-sentinel alert ring (server/sentinel.py): deduplicated,
    severity-tagged rule firings with their snapshot window + evidence."""
    import json

    als = db.sentinel.alerts()
    return _t("__all_virtual_alert_history", [
        ("alert_id", DataType.int64(), [a.alert_id for a in als]),
        ("ts", DataType.float64(), [a.ts for a in als]),
        ("rule", DataType.varchar(), [a.rule for a in als]),
        ("severity", DataType.varchar(), [a.severity for a in als]),
        ("subject", DataType.varchar(), [a.key for a in als]),
        ("summary", DataType.varchar(), [a.summary for a in als]),
        ("first_snap_id", DataType.int64(),
         [a.first_snap_id for a in als]),
        ("last_snap_id", DataType.int64(),
         [a.last_snap_id for a in als]),
        ("evidence", DataType.varchar(),
         [json.dumps(a.evidence, sort_keys=True)[:400] for a in als]),
    ])


def _layout_advisor(db) -> Table:
    """Latest layout-advisor pass: each ranked recommendation with its
    evidence, estimated benefit, byte cost, and what happened to it
    (dry_run / queued / applied / rejected:budget)."""
    adv = getattr(db, "layout_advisor", None)
    recs = list(adv.last) if adv is not None else []
    return _t("__all_virtual_layout_advisor", [
        ("action", DataType.varchar(), [r.action for r in recs]),
        ("table_name", DataType.varchar(), [r.table for r in recs]),
        ("column_name", DataType.varchar(), [r.column for r in recs]),
        ("detail", DataType.varchar(), [r.detail for r in recs]),
        ("benefit", DataType.float64(), [float(r.benefit) for r in recs]),
        ("cost_bytes", DataType.int64(), [int(r.cost_bytes) for r in recs]),
        ("status", DataType.varchar(), [r.status for r in recs]),
        ("evidence", DataType.varchar(), [r.evidence for r in recs]),
    ])


def _plan_artifact(db) -> Table:
    """On-disk compiled-plan artifact tier (engine/plan_artifact.py):
    one row per exported executable — identity, byte cost, statement-
    summary exec ranking, exported batch buckets, and this boot's
    hydration hit/miss/load-time tallies. `warm` = 1 means the live
    plan-cache entry is backed by this artifact (hydrated, not
    compiled)."""
    store = getattr(db, "plan_artifact", None)
    rows = store.census() if store is not None else []
    return _t("__all_virtual_plan_artifact", [
        ("artifact_id", DataType.varchar(),
         [r["artifact_id"] for r in rows]),
        ("statement", DataType.varchar(), [r["statement"] for r in rows]),
        ("bytes", DataType.int64(), [r["bytes"] for r in rows]),
        ("execs", DataType.int64(), [r["execs"] for r in rows]),
        ("buckets", DataType.varchar(),
         [",".join(str(b) for b in r["buckets"]) for r in rows]),
        ("hits", DataType.int64(), [r["hits"] for r in rows]),
        ("misses", DataType.int64(), [r["misses"] for r in rows]),
        ("load_us", DataType.int64(), [r["load_us"] for r in rows]),
        ("warm", DataType.int64(), [r["warm"] for r in rows]),
    ])


def _memory_governor(db) -> Table:
    """Device-memory governor ledger (engine/memory_governor.py): the
    budget and its OOM-shrunk effective value, live/peak reserved bytes,
    grant/reject/oom counters, reservation-wait p99, and one
    `reserved:<tenant>` / `limit:<tenant>` row pair per registered
    tenant share."""
    gov = getattr(db, "governor", None)
    st = gov.stats() if gov is not None else {}
    rows: list[tuple[str, int]] = [
        ("budget", int(st.get("budget", 0))),
        ("effective_budget", int(st.get("effective_budget", 0))),
        ("reserved", int(st.get("reserved", 0))),
        ("peak_reserved", int(st.get("peak_reserved", 0))),
        # staged ledger: host-pinned wire-encoded chunk buffers held by
        # the streaming prefetcher (zero between statements — a leak
        # here means a cancelled prefetch did not drain)
        ("staged", int(st.get("staged", 0))),
        ("peak_staged", int(st.get("peak_staged", 0))),
        ("waiters", int(st.get("waiters", 0))),
        ("grants", int(st.get("grants", 0))),
        ("rejects", int(st.get("rejects", 0))),
        ("oom_notes", int(st.get("oom_notes", 0))),
        ("shrink_pct", int(round(st.get("shrink", 1.0) * 100))),
        ("wait_p99_us", int(st.get("wait_p99_s", 0.0) * 1e6)),
    ]
    for name, t in sorted(st.get("tenants", {}).items()):
        rows.append((f"reserved:{name}", int(t["reserved"])))
        rows.append((f"limit:{name}",
                     int(t["limit"]) if t["limit"] is not None else -1))
    return _t("__all_virtual_memory_governor", [
        ("metric", DataType.varchar(), [m for m, _ in rows]),
        ("value", DataType.int64(), [v for _, v in rows]),
    ])


def _storage_integrity(db) -> Table:
    """Storage-scrub ledger (storage/scrub.py): one row per artifact
    class with cumulative scrubbed/failure/quarantine/repair counts,
    plus one `quarantine:<class>` row per quarantined file (its new
    path and the verification failure that sent it there)."""
    scr = getattr(db, "scrubber", None)
    st = scr.stats() if scr is not None else {}
    rows: list[tuple[str, int, int, int, int, int, str]] = []
    for cls, v in sorted((st.get("by_class") or {}).items()):
        rows.append((
            cls, int(v.get("scrubbed", 0)), int(v.get("failures", 0)),
            int(v.get("quarantined", 0)), int(v.get("repaired", 0)),
            int(v.get("unrepaired", 0)),
            f"passes={int(st.get('passes', 0))}",
        ))
    for cls, qpath, reason in st.get("quarantined", ()):
        rows.append((f"quarantine:{cls}", 0, 0, 1, 0, 0,
                     f"{qpath}: {reason}"[:160]))
    return _t("__all_virtual_storage_integrity", [
        ("path_class", DataType.varchar(), [r[0] for r in rows]),
        ("scrubbed", DataType.int64(), [r[1] for r in rows]),
        ("failures", DataType.int64(), [r[2] for r in rows]),
        ("quarantined", DataType.int64(), [r[3] for r in rows]),
        ("repaired", DataType.int64(), [r[4] for r in rows]),
        ("unrepaired", DataType.int64(), [r[5] for r in rows]),
        ("detail", DataType.varchar(), [r[6] for r in rows]),
    ])


def _vector_index(db) -> Table:
    """Registered vector indexes with build + serving counters: spec
    (lists/nprobe), built artifact metadata (version/scn/rows/build
    seconds), uploaded device bytes, and cumulative probe / over-probe /
    query counters folded at statement completion."""
    ex = db.engine.executor
    residency = {}
    try:
        residency = ex.ann_residency()
    except Exception:  # noqa: BLE001 - diagnostics never fail a read
        pass
    builds = getattr(ex, "ann_builds", {}) or {}
    stats = getattr(ex, "ann_stats", {}) or {}
    rows = []
    for tname, specs in sorted(db._vector_specs.items()):
        t = db.catalog.get(tname)
        live = getattr(t, "vector_indexes", {}) if t is not None else {}
        for col, (lists, nprobe) in sorted(specs.items()):
            spec = live.get(col)
            b = builds.get((tname, col), {})
            st = stats.get((tname, col), (0, 0, 0))
            rows.append((
                tname, col,
                int(getattr(spec, "lists", lists) or lists),
                int(getattr(spec, "nprobe", nprobe) or nprobe),
                int(residency.get((tname, col), 0)),
                int(b.get("build_version", -1)),
                float(b.get("build_s", 0.0)),
                int(b.get("rows", 0)),
                int(st[0]), int(st[1]), int(st[2]),
            ))
    return _t("__all_virtual_vector_index", [
        ("table_name", DataType.varchar(), [r[0] for r in rows]),
        ("column_name", DataType.varchar(), [r[1] for r in rows]),
        ("lists", DataType.int64(), [r[2] for r in rows]),
        ("nprobe", DataType.int64(), [r[3] for r in rows]),
        ("device_bytes", DataType.int64(), [r[4] for r in rows]),
        ("build_scn", DataType.int64(), [r[5] for r in rows]),
        ("build_seconds", DataType.float64(), [r[6] for r in rows]),
        ("build_rows", DataType.int64(), [r[7] for r in rows]),
        ("queries", DataType.int64(), [r[8] for r in rows]),
        ("probes", DataType.int64(), [r[9] for r in rows]),
        ("over_probe_escalations", DataType.int64(), [r[10] for r in rows]),
    ])


def _xa(db) -> Table:
    rows = sorted(db._xa_prepared.items())
    return _t("__all_virtual_xa_transaction", [
        ("xid", DataType.varchar(), [x for x, _ in rows]),
        ("owner", DataType.varchar(), [e[1] for _, e in rows]),
        ("state", DataType.varchar(), ["PREPARED" for _ in rows]),
    ])


PROVIDERS = {
    "__all_virtual_parameters": _parameters,
    "__all_virtual_table": _tables,
    "__all_virtual_plan_cache_stat": _plan_cache_stat,
    "__all_virtual_sql_audit": _sql_audit,
    "__all_virtual_host_tax": _host_tax,
    "__all_virtual_result_cache": _result_cache,
    "__all_virtual_sql_plan_monitor": _plan_monitor,
    "__all_virtual_ash": _ash,
    "__all_virtual_trace_span": _trace,
    "__all_virtual_long_ops": _long_ops,
    "__all_virtual_sysstat": _sysstat,
    "__all_virtual_system_event": _system_event,
    "__all_virtual_query_response_time": _query_response_time,
    "__all_virtual_ls": _ls,
    "__all_virtual_ls_replica": _ls_replica,
    "__all_virtual_processlist": _processlist,
    "__all_virtual_tablet": _tablets,
    "__all_virtual_user": _users,
    "__all_virtual_privilege": _privileges,
    "__all_virtual_deadlock_stat": _deadlock_stat,
    "__all_virtual_memory": _memory,
    "__all_virtual_index": _indexes,
    "__all_virtual_external_table": _external_tables,
    "__all_virtual_server_stat": _server_stat,
    "__all_virtual_procedure": _procedures,
    "__all_virtual_view": _views,
    "__all_virtual_trigger": _triggers,
    "__all_virtual_sequence": _sequences,
    "__all_virtual_mview": _mviews,
    "__all_virtual_vector_index": _vector_index,
    "__all_virtual_xa_transaction": _xa,
    "__all_virtual_statement_summary": _statement_summary,
    "__all_virtual_table_access_stat": _table_access_stat,
    "__all_virtual_device_census": _device_census,
    "__all_virtual_server_timeline": _server_timeline,
    "__all_virtual_tenant_qos": _tenant_qos,
    "__all_virtual_alert_history": _alert_history,
    "__all_virtual_layout_advisor": _layout_advisor,
    "__all_virtual_plan_artifact": _plan_artifact,
    "__all_virtual_memory_governor": _memory_governor,
    "__all_virtual_storage_integrity": _storage_integrity,
}
