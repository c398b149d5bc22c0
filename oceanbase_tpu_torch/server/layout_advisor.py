"""Closed-loop layout advisor: workload-adaptive physical design.

Reference surface: OceanBase exposes the evidence (GV$SQL_AUDIT,
GV$SQL_PLAN_MONITOR, table access stats) and leaves index/layout choice to
the DBA; "Fine-Tuning Data Structures for Analytical Query Processing"
(PAPERS.md) is the blueprint for closing that loop from the query log.
This module folds the workload repository's evidence — `TableAccessStats`
column roles, statement-summary latency, `device_census()` bytes — into
ranked, costed layout actions:

  * create/drop sorted projections (storage/sorted_projection.py): a hot
    filter column with a range-routable dtype earns a projection; an
    advisor-created projection that goes unused for N consecutive
    snapshot windows is dropped again (hysteresis, so recommendations
    don't flap between snapshots);
  * per-column encodings (storage/encoding.py cost model): quantifies
    FOR/RLE/const savings over raw for hot tables' integer columns, and
    records the choice as a hint for the sstable dump path;
  * per-table device-residency priorities that `Database._enforce_memory`
    and the block cache's eviction respect under memory pressure.

Actions apply through the existing `TenantDagScheduler` as BACKGROUND-
priority rebuild DAGs (visible in `__all_virtual_long_ops`), bounded by
the `layout_advisor_max_bytes` budget. Control surface:

  ALTER SYSTEM RUN LAYOUT ADVISOR          -- one pass now (root only)
  ob_layout_advisor_mode = off|dry_run|auto
  select * from __all_virtual_layout_advisor

`auto` mode additionally runs a pass on every workload snapshot
(WorkloadRepository.on_snapshot, chained next to the health sentinel) and
re-queues DML-invalidated projections for background rebuild instead of
losing them silently.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..storage import encoding as enc
from ..storage.sorted_projection import projection_name

# snapshot windows an advisor-created projection may sit unused (base
# table scanned, zero projection hits) before a drop is recommended
DROP_AFTER_WINDOWS = 3
# cumulative scans a table needs before it produces any recommendation
MIN_SCANS = 2
# encoding recommendations below this byte saving are noise
MIN_ENC_SAVINGS = 4 << 10

_ENC_NAMES = {enc.ENC_RAW: "raw", enc.ENC_CONST: "const",
              enc.ENC_FOR: "for", enc.ENC_RLE: "rle"}


@dataclass
class Recommendation:
    """One ranked layout action with its evidence and estimated benefit."""

    action: str  # create_projection | drop_projection | set_encoding | set_residency | create_vector_index
    table: str
    column: str = ""
    detail: str = ""  # action payload: covered cols / encoding / priority
    benefit: float = 0.0  # ranking score (higher first)
    cost_bytes: int = 0  # bytes the action would materialize
    evidence: str = ""
    status: str = "proposed"


def _covered_bytes(t, cols=None) -> int:
    total = 0
    for c, a in t.data.items():
        if cols is None or c in cols:
            total += int(getattr(a, "nbytes", 0))
    return total


def _routable(t, col, range_kinds) -> bool:
    """Mirror the scan router's eligibility: the projection key must be a
    value-ordered range dtype (dict codes and floats never route)."""
    if col in getattr(t, "dicts", {}):
        return False
    try:
        kind = t.schema[col].kind
    except Exception:
        return False
    return kind in range_kinds


def propose(
    access_rows,
    catalog,
    *,
    budget_bytes: int | None = None,
    created: dict | None = None,
    idle: dict | None = None,
    dropped: dict | None = None,
    census_rows=None,
    drop_after: int = DROP_AFTER_WINDOWS,
    min_scans: int = MIN_SCANS,
) -> list[Recommendation]:
    """Pure core: evidence in, ranked costed actions out. No side effects,
    so tests and bench can drive it without a Database.

    `access_rows` is `TableAccessStats.snapshot()`; `catalog` maps table
    name -> core Table; `created`/`idle`/`dropped` are the advisor's
    hysteresis registries ((table, key_col) keyed); `census_rows` is
    `device_census()` output (folded into residency evidence).
    """
    from ..engine.executor import Executor

    range_kinds = Executor._RANGE_KINDS
    created = created or {}
    idle = idle or {}
    dropped = dropped or {}
    dev_bytes = {}
    for r in census_rows or ():
        if r.get("kind") == "table_device":
            dev_bytes[r.get("name")] = (
                dev_bytes.get(r.get("name"), 0) + int(r.get("bytes", 0)))

    recs: list[Recommendation] = []
    # bytes already spent on advisor-created projections count against
    # the budget, so repeated passes under the same budget are stable
    spent = 0
    for (_tab, _key), pname in created.items():
        pt = catalog.get(pname)
        if pt is not None:
            spent += _covered_bytes(pt)

    # ---- create sorted projections ----------------------------------
    for row in sorted(access_rows, key=lambda r: -int(r.get("rows_read", 0))):
        table = row["table"]
        t = catalog.get(table)
        if t is None or "#sp:" in table or table.startswith("__all_virtual"):
            continue
        scans = int(row.get("scans", 0))
        if scans < min_scans:
            continue
        cols = sorted(
            row.get("columns", ()),
            key=lambda c: -int(c.get("filter_count", 0)),
        )
        best = next(
            (c for c in cols
             if int(c.get("filter_count", 0)) > 0
             and _routable(t, c["column"], range_kinds)),
            None,
        )
        if best is None:
            continue
        key_col = best["column"]
        if key_col in getattr(t, "sorted_projections", {}):
            continue  # already laid out (advisor-built or hand-built)
        fcount = int(best.get("filter_count", 0))
        prev = dropped.get((table, key_col))
        if prev is not None and fcount < prev + min_scans:
            # hysteresis: a projection the advisor just dropped only
            # comes back once NEW filtered scans accumulate
            continue
        rows_read = int(row.get("rows_read", 0))
        score = float(fcount * max(rows_read, 1))
        cost = _covered_bytes(t)
        detail = "cover=all"
        status = "proposed"
        if budget_bytes is not None and spent + cost > budget_bytes:
            # narrow to the role-referenced columns + key before giving
            # up (uncovered columns make the router fall back, so this
            # only helps queries that touch the hot column set)
            narrow = {c["column"] for c in row.get("columns", ())
                      if any(int(c.get(k, 0)) > 0 for k in
                             ("filter_count", "join_count",
                              "group_count", "sort_count"))}
            narrow.add(key_col)
            cost = _covered_bytes(t, narrow)
            detail = "cover=" + ",".join(sorted(narrow))
            if spent + cost > budget_bytes:
                status = "rejected:budget"
        if status == "proposed":
            spent += cost
        recs.append(Recommendation(
            action="create_projection", table=table, column=key_col,
            detail=detail, benefit=score, cost_bytes=cost,
            evidence=(f"scans={scans} rows_read={rows_read} "
                      f"filter_count={fcount} "
                      f"proj_hits={int(row.get('proj_hits', 0))}"),
            status=status,
        ))

    # ---- create vector indexes (ANN route enablement) ---------------
    # query heat on a VECTOR column's SORT role means someone is running
    # ORDER BY vec_l2(col, ?) LIMIT k as a brute-force full matmul; an
    # IVF index turns that into the optimizer's probe route
    from ..core.dtypes import TypeKind

    for row in access_rows:
        table = row["table"]
        t = catalog.get(table)
        if t is None or "#sp:" in table or table.startswith("__all_virtual"):
            continue
        if int(row.get("scans", 0)) < min_scans:
            continue
        for c in row.get("columns", ()):
            sc = int(c.get("sort_count", 0))
            if sc <= 0:
                continue
            cname = c["column"]
            fld = next(
                (f for f in t.schema.fields if f.name == cname), None)
            if fld is None or fld.dtype.kind is not TypeKind.VECTOR:
                continue
            if cname in getattr(t, "vector_indexes", {}):
                continue
            arr = t.data.get(cname)
            nrows = int(len(arr)) if arr is not None else 0
            if nrows <= 0:
                continue
            dim = int(np.asarray(arr).shape[1])
            # index footprint: perm (4B/row) + ~sqrt(n) centroids
            L = max(4, int(np.sqrt(nrows)))
            cost = nrows * 4 + L * dim * 4
            recs.append(Recommendation(
                action="create_vector_index", table=table, column=cname,
                detail="lists=auto", benefit=float(sc) * nrows,
                cost_bytes=cost,
                evidence=(f"vec_sorted_scans={sc} rows={nrows} dim={dim} "
                          f"brute_rows_per_query={nrows}"),
            ))

    # ---- drop idle advisor-created projections ----------------------
    for (table, key_col), pname in created.items():
        n_idle = int(idle.get((table, key_col), 0))
        if n_idle >= drop_after:
            recs.append(Recommendation(
                action="drop_projection", table=table, column=key_col,
                detail=pname, benefit=1.0,
                cost_bytes=-_covered_bytes(catalog.get(pname, _EMPTY)),
                evidence=(f"no projection hits for {n_idle} consecutive "
                          f"snapshot windows"),
            ))

    # ---- device residency priorities --------------------------------
    hot = [r for r in access_rows
           if int(r.get("scans", 0)) > 0
           and "#sp:" not in r["table"]
           and not r["table"].startswith("__all_virtual")]
    hot.sort(key=lambda r: -(int(r.get("rows_read", 0))
                             + int(r.get("das_rows", 0))))
    for rank, row in enumerate(hot):
        table = row["table"]
        score = int(row.get("rows_read", 0)) + int(row.get("das_rows", 0))
        prio = float(len(hot) - rank)
        recs.append(Recommendation(
            action="set_residency", table=table, detail=f"{prio:g}",
            benefit=float(score),
            evidence=(f"scans={int(row.get('scans', 0))} "
                      f"rows_read={int(row.get('rows_read', 0))} "
                      f"device_bytes={dev_bytes.get(table, 0)}"),
        ))

    # ---- column encodings (hot tables only) -------------------------
    for row in hot[:8]:
        table = row["table"]
        t = catalog.get(table)
        if t is None:
            continue
        for cname, a in t.data.items():
            a = np.asarray(a)
            if not np.issubdtype(a.dtype, np.integer) or len(a) == 0:
                continue
            stats = enc.analyze_ints(a)
            e, params = enc.choose_encoding(a, stats)
            if e == enc.ENC_RAW:
                continue
            raw_b = len(a) * a.dtype.itemsize
            if e == enc.ENC_CONST:
                best_b = a.dtype.itemsize
            elif e == enc.ENC_FOR:
                best_b = len(a) * params["width"]
            else:  # RLE
                best_b = 4 + stats.nruns * (4 + a.dtype.itemsize)
            saved = raw_b - best_b
            if saved < MIN_ENC_SAVINGS:
                continue
            via = "dict codes" if cname in getattr(t, "dicts", {}) else "raw"
            recs.append(Recommendation(
                action="set_encoding", table=table, column=cname,
                detail=_ENC_NAMES[e], benefit=float(saved),
                evidence=(f"{via} {raw_b}B -> {_ENC_NAMES[e]} {best_b}B "
                          f"(runs={stats.nruns} "
                          f"span={stats.vmax - stats.vmin})"),
            ))

    recs.sort(key=lambda r: (-r.benefit, r.action, r.table, r.column))
    return recs


@dataclass
class _Empty:
    data: dict = field(default_factory=dict)


_EMPTY = _Empty()


class LayoutAdvisor:
    """Stateful wrapper: hysteresis registries + the apply path through
    the tenant DAG scheduler. One per Database."""

    def __init__(self, db):
        self.db = db
        self._lock = threading.RLock()
        # (table, key_col) -> pname for projections THIS advisor built
        # (hand-built ones are never auto-dropped)
        self.created: dict[tuple, str] = {}
        # (table, key_col) -> consecutive snapshot windows with base-table
        # scans but zero projection hits
        self.idle: dict[tuple, int] = {}
        # (table, key_col) -> filter_count at auto-drop time (re-create
        # only after NEW filtered scans arrive)
        self.dropped: dict[tuple, int] = {}
        # (table, col) -> encoding name chosen by the cost model
        self.encoding_hints: dict[tuple, str] = {}
        # (table, column) vector indexes THIS advisor created: their
        # DML-invalidated rebuilds re-queue in any mode, like created[]
        self.created_vec: dict[tuple, bool] = {}
        self.last: list[Recommendation] = []
        self.runs = 0

    @property
    def mode(self) -> str:
        return str(self.db.config["ob_layout_advisor_mode"])

    # ------------------------------------------------------------ passes
    def run(self, apply: bool | None = None) -> list[Recommendation]:
        """One advisor pass over cumulative evidence. `apply=None` follows
        the configured mode (only `auto` mutates); explicit True/False
        overrides it (the smoke uses apply=True after a dry run)."""
        db = self.db
        with self._lock:
            recs = propose(
                db.access.snapshot(),
                db.catalog,
                budget_bytes=int(db.config["layout_advisor_max_bytes"]),
                created=self.created,
                idle=self.idle,
                dropped=self.dropped,
                census_rows=self._census(),
            )
            do_apply = (self.mode == "auto") if apply is None else apply
            if do_apply:
                self._apply(recs)
            else:
                for r in recs:
                    if r.status == "proposed":
                        r.status = "dry_run"
            self.last = recs
            self.runs += 1
            db.metrics.add("layout advisor runs")
            return recs

    def _census(self):
        try:
            from .workload import device_census

            return device_census(self.db)
        except Exception:  # census is evidence, never a failure mode
            return ()

    def on_snapshot(self, first, last) -> None:
        """WorkloadRepository.on_snapshot hook (chained after the health
        sentinel): track per-window projection usage for the drop rule,
        then run a pass (auto applies; dry_run refreshes proposals)."""
        if self.mode == "off":
            return
        win = self._window(first, last)
        with self._lock:
            for (table, key_col) in list(self.created):
                w = win.get(table)
                if w is None:
                    continue
                if w["proj_hits"] > 0:
                    self.idle[(table, key_col)] = 0
                elif w["scans"] > 0:
                    self.idle[(table, key_col)] = (
                        self.idle.get((table, key_col), 0) + 1)
        self.run()

    @staticmethod
    def _window(first, last) -> dict:
        f = {r["table"]: r for r in (first or {}).get("access", ())}
        out = {}
        for r in (last or {}).get("access", ()):
            fr = f.get(r["table"], {})
            d = {}
            for k in ("scans", "proj_hits"):
                delta = int(r.get(k, 0)) - int(fr.get(k, 0))
                # counter reset (TableAccessStats.reset bumps the epoch):
                # the window is the whole new accumulation
                d[k] = delta if delta >= 0 else int(r.get(k, 0))
            out[r["table"]] = d
        return out

    # ------------------------------------------------------------- apply
    def _apply(self, recs: list[Recommendation]) -> None:
        applied = 0
        for r in recs:
            if r.status != "proposed":
                continue
            if r.action == "create_projection":
                cols = None
                if r.detail.startswith("cover=") and r.detail != "cover=all":
                    cols = r.detail[len("cover="):].split(",")
                queued = self._queue_rebuild(r.table, r.column, cols)
                r.status = "queued" if queued else "queued:duplicate"
                applied += queued
            elif r.action == "drop_projection":
                self._drop(r.table, r.column, r.detail)
                r.status = "applied"
                applied += 1
            elif r.action == "create_vector_index":
                queued = self._queue_vector_build(r.table, r.column)
                r.status = "queued" if queued else "queued:duplicate"
                applied += queued
            elif r.action == "set_residency":
                self.db.residency_priority[r.table] = float(r.detail)
                r.status = "applied"
                applied += 1
            elif r.action == "set_encoding":
                self.encoding_hints[(r.table, r.column)] = r.detail
                self._push_encoding(r.table, r.column, r.detail)
                r.status = "applied"
                applied += 1
        if applied:
            self.db.metrics.add("layout advisor actions applied", applied)

    def _push_encoding(self, table: str, column: str, encoding: str) -> None:
        """Install the hint on every replica tablet of the table: the next
        dump/compaction writes its blocks with the chosen encoding, which
        is how the advisor's FOR/RLE/const picks persist on disk (and so
        across restarts — enc_hints also rides node_meta)."""
        db = self.db
        ti = db.tables.get(table)
        if ti is None:
            return
        for pls, ptab in ti.all_partitions():
            for rep in db.cluster.ls_groups.get(pls, {}).values():
                t = rep.tablets.get(ptab)
                if t is not None:
                    t.enc_hints[column] = encoding

    def _queue_rebuild(self, table: str, key_col: str,
                       cols=None) -> bool:
        """Enqueue a BACKGROUND-priority projection (re)build DAG; dedup
        by key while queued. Never runs on the statement path — workers or
        run_maintenance() drain it."""
        from ..share.dag_scheduler import Dag, DagPriority

        db = self.db
        pname = projection_name(table, key_col)
        with self._lock:
            self.created[(table, key_col)] = pname
            self.idle.setdefault((table, key_col), 0)
            self.dropped.pop((table, key_col), None)

        def build():
            from ..storage.sorted_projection import make_sorted_projection

            ti = db.tables.get(table)
            if ti is not None and ti.cached_data_version != ti.data_version:
                # DML landed since queueing: refresh the snapshot first so
                # the projection sorts current data, not the stale copy
                db.refresh_catalog([table])
            t = db.catalog.get(table)
            if t is None or key_col not in t.data:
                return  # table dropped while queued
            if key_col in getattr(t, "sorted_projections", {}):
                return  # already built (hand or a racing rebuild)
            make_sorted_projection(db.catalog, table, key_col, cols)
            db._invalidate(pname)
            # cached plans were routed before this layout existed
            db.plan_cache.flush()
            db.metrics.add("layout advisor projections built")

        dag = Dag("layout rebuild", DagPriority.BACKGROUND,
                  key=("layout rebuild", pname))
        dag.add_task(build, name=f"build {pname}")
        return db.dag_scheduler.add_dag(dag)

    def _queue_vector_build(self, table: str, column: str) -> bool:
        """Enqueue a BACKGROUND IVF build DAG: register the spec (auto
        lists, default nprobe — the same durable registration the DDL
        path writes) and warm the executor's index artifact off the
        statement path, so the first ANN query probes instead of paying
        the k-means build inline. Dedup by (table, column) while
        queued."""
        from ..share.dag_scheduler import Dag, DagPriority

        db = self.db
        with self._lock:
            self.created_vec[(table, column)] = True

        def build():
            from ..storage.vector_index import register_vector_index

            # ti is None for preloaded read-only tables that live only in
            # the catalog — the build still proceeds off the catalog copy
            ti = db.tables.get(table)
            if ti is not None and ti.cached_data_version != ti.data_version:
                db.refresh_catalog([table])
            t = db.catalog.get(table)
            if t is None or column not in t.data:
                return
            if column not in getattr(t, "vector_indexes", {}):
                specs = db._vector_specs.setdefault(table, {})
                specs.setdefault(column, (0, 8))
                lists, nprobe = specs[column]
                register_vector_index(db.catalog, table, column,
                                      lists, nprobe)
                db._save_node_meta()
            try:
                db.engine.executor.ivf_host(table, column)
            except Exception:  # noqa: BLE001 - warm-build is advisory
                pass
            # cached brute-force plans predate the index route
            db.plan_cache.flush()
            db.metrics.add("layout advisor vector indexes built")

        dag = Dag("vector index build", DagPriority.BACKGROUND,
                  key=("vector index build", table, column))
        dag.add_task(build, name=f"build ivf {table}.{column}")
        return db.dag_scheduler.add_dag(dag)

    def note_vector_invalidated(self, table: str, cols) -> None:
        """refresh_catalog hook, after a DML-invalidated table's vector
        specs re-register: queue background rebuilds (auto mode, or any
        advisor-created index) so the next ANN query probes a warm index
        instead of paying the k-means rebuild inline."""
        for col in cols:
            if self.mode != "auto" and (table, col) not in self.created_vec:
                continue
            self._queue_vector_build(table, col)

    def _drop(self, table: str, key_col: str, pname: str) -> None:
        db = self.db
        t = db.catalog.get(table)
        projs = getattr(t, "sorted_projections", {}) if t is not None else {}
        if projs.get(key_col) == pname:
            t.sorted_projections = {
                k: v for k, v in projs.items() if k != key_col}
        db.catalog.pop(pname, None)
        db._invalidate(pname)
        db.plan_cache.flush()
        with self._lock:
            self.created.pop((table, key_col), None)
            self.idle.pop((table, key_col), None)
            # remember the evidence level so the same cumulative counters
            # don't immediately re-create what we just dropped
            fcount = 0
            for row in db.access.snapshot():
                if row["table"] != table:
                    continue
                for c in row.get("columns", ()):
                    if c["column"] == key_col:
                        fcount = int(c.get("filter_count", 0))
            self.dropped[(table, key_col)] = fcount
        db.metrics.add("layout advisor projections dropped")

    # ------------------------------------------------- DML invalidation
    def note_invalidated(self, table: str, projs: dict):
        """Called by refresh_catalog BEFORE it drops a DML-invalidated
        table's projections (the catalog still holds them, so covered
        column sets survive into the rebuild). Returns a zero-arg
        callable the caller invokes AFTER the refreshed snapshot lands —
        queueing any earlier lets a live dag worker observe the stale
        table version and re-enter refresh_catalog concurrently (double-
        counted invalidation, duplicate rebuild). In auto mode — or for
        any advisor-created projection — the layout is re-queued for
        background rebuild instead of silently lost."""
        db = self.db
        jobs = []
        for key_col, pname in projs.items():
            if self.mode != "auto" and (table, key_col) not in self.created:
                continue
            cols = None
            pt = db.catalog.get(pname)
            base = db.catalog.get(table)
            if (pt is not None and base is not None
                    and len(pt.schema.fields) < len(base.schema.fields)):
                cols = [f.name for f in pt.schema.fields]
            jobs.append((key_col, cols))

        def queue():
            for key_col, cols in jobs:
                self._queue_rebuild(table, key_col, cols)

        return queue
