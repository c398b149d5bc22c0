"""Session facade: SQL text in, result rows out, with a plan cache.

Counterpart of `oceanbase_tpu/engine/session.py` (reference surface:
ObSql::stmt_query + ObPlanCache, src/sql/ob_sql.cpp:153,
src/sql/plan_cache/ob_plan_cache.h:227): text -> fast-parser key ->
(text-tier hit: re-bind literals into the cached plan) or (parse ->
resolve/plan -> parameterize -> logical-tier lookup or prepare) -> one
device pass -> lazy result cursor.

The server layer (server/database.py) wires the serving spine into it:
the statement fast path (`fast_lookup` + `fast_execute`), the result
cache (`result_cache_key`, `result_cache_probe`, `_result_cache_put`),
the narrowed result frame (`narrow_*`: the plan's program plus the
result-frame compaction, kernel K23, so a warm statement is one dispatch
and one completion copy), the per-operator plan profiler
(`plan_profiler`, engine/plan_profile.py), the metrics, tracer, plan
monitor, workload access heat and serving timeline. Used directly, a
Session runs with those hooks unset.

A statement whose inputs exceed the executor's device budget runs out of
core (chunked or grace-hash) and reports its streaming walls in
`last_phases`. WITH RECURSIVE runs as a host fixpoint
(engine/recursive.py); JSON_OBJECT/JSON_ARRAY select items split into
hidden argument columns and are formatted on the host
(sql/json_host.py). The session owns its `torch.device`: None means the
first CUDA device and raises when there is none; the CPU tests pass
``device="cpu"``.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from dataclasses import replace as _replace

from .. import device as _device
from ..core.column import (
    batch_rows_storage,
    batch_to_host,
    batch_valid_storage,
    host_rows,
    renamed_storage_schema,
)
from ..core.dtypes import Field, Schema
from ..core.table import Table
from ..sql import parser as P
from ..sql.json_host import apply_host_json, split_host_json
from ..sql.logical import ResolveError, output_schema
from ..sql.plan_cache import (
    CacheEntry,
    FastEntry,
    PlanCache,
    build_slot_map,
    parameterize,
    plan_fingerprint,
)
from ..sql.planner import Planner
from .executor import (
    DeviceResult,
    Executor,
    NarrowDeviceResult,
    upload_qparams,
)
from .recursive import recursive_cte_of, run_recursive


@dataclass
class ResultSet:
    names: tuple[str, ...]
    columns: dict[str, object]  # name -> np.ndarray | list
    affected: int = 0  # DML-affected row count (0 for queries)
    plan_cache_hit: bool = False  # this statement reused a compiled plan
    fast_path_hit: bool = False  # served by the text-keyed fast tier

    @property
    def nrows(self) -> int:
        if not self.names:
            return 0
        return len(self.columns[self.names[0]])

    def rows(self, limit: int | None = None) -> list[tuple]:
        cols = [self.columns[n] for n in self.names]
        out = list(zip(*cols)) if cols else []
        return out[:limit] if limit is not None else out


class LazyResultSet:
    """Device-resident ResultSet: the same read surface as ResultSet, but
    column data stays on the device behind a DeviceResult cursor until a
    host access touches it. `nrows` is the sync point (overflow re-runs
    happen there); `.columns` fetches everything once; `column(name)`
    transfers only that column; `rows(limit=k)` transfers only the first
    k rows (kernel K23)."""

    def __init__(self, names: tuple[str, ...], cursor, affected: int = 0,
                 plan_cache_hit: bool = False, fast_path_hit: bool = False):
        self.names = names
        self.affected = affected
        self.plan_cache_hit = plan_cache_hit
        self.fast_path_hit = fast_path_hit
        self._cursor = cursor
        self._columns_cache: dict | None = None
        self._nrows: int | None = None

    @property
    def nrows(self) -> int:
        # memoized: the completion path reads nrows several times
        n = self._nrows
        if n is None:
            n = self._nrows = self._cursor.nrows if self.names else 0
        return n

    @property
    def columns(self) -> dict[str, object]:
        if self._columns_cache is None:
            host = self._cursor.fetch_columns()
            self._columns_cache = {n: host[n] for n in self.names}
        return self._columns_cache

    def column(self, name: str):
        """One column's host values: transfers only this column (and the
        shared sel mask once)."""
        return self._cursor.fetch_columns((name,))[name]

    def rows(self, limit: int | None = None) -> list[tuple]:
        if limit is not None:
            host = self._cursor.fetch_head(limit)
        else:
            host = self._cursor.fetch_columns()
        cols = [host[n] for n in self.names]
        return list(zip(*cols)) if cols else []

    def storage_columns(self) -> dict:
        """Result columns in the storage domain (exact scaled ints)."""
        host = self._cursor.fetch_storage()
        return {n: host[n] for n in self.names}


# fast_execute's "caller did not probe the result cache" marker (None is
# a real probe outcome: probed, uncacheable)
_RC_UNSET = object()


@dataclass
class _FastHit:
    """A resolved fast-tier lookup: the text entry, the re-bound slot
    values for THIS statement's literals, and the logical entry."""

    text_key: str
    fe: FastEntry
    values: list
    entry: CacheEntry
    # logical cache key of the entry (schema/dict versions ride its
    # key_extra): the result cache's identity base
    key: tuple | None = None


class Session:
    def __init__(self, catalog, unique_keys=None, device=None,
                 plan_cache: PlanCache | None = None, key_extra_fn=None,
                 cache_enabled_fn=None, plan_monitor=None, views=None,
                 metrics=None, tracer=None, profile_enabled_fn=None):
        from ..share.stats import StatsManager

        self.catalog = catalog
        self.device = _device(device)
        self.stats = StatsManager(catalog)
        self.planner = Planner(catalog, stats=self.stats,
                               unique_keys=unique_keys, views=views)
        self.executor = Executor(catalog, unique_keys=unique_keys,
                                 stats=self.stats, device=self.device)
        # shareable across sessions (the cache is per tenant, not per
        # session: ob_plan_cache.h:227)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        # hook: extra cache-key material per referenced table set (the
        # DML-backed catalog keys entries on table dictionary versions)
        self.key_extra_fn = key_extra_fn
        # hook: ob_enable_plan_cache (a disabled cache prepares every time)
        self.cache_enabled_fn = cache_enabled_fn
        # hook: server/diag.PlanMonitor (per-plan build/exec stats)
        self.plan_monitor = plan_monitor
        # hook: share/metrics.MetricsRegistry (phase histograms, counters)
        self.metrics = metrics
        # hook: server/diag.Tracer
        self.tracer = tracer
        # hook: config enable_query_profile (None = always profile)
        self.profile_enabled_fn = profile_enabled_fn
        # hook: server/workload.TableAccessStats (per-execution fold of the
        # prepared plan's access profile)
        self.access = None
        # hook: share/timeline.ServingTimeline (per-dispatch feed)
        self.timeline = None
        # phase breakdown of the LAST statement (seconds)
        self.last_phases: dict = {}
        # server/diag.QueryProfile of the LAST run_ast call (None when
        # profiling is off)
        self.last_profile = None
        # logical plan of the LAST run_ast call
        self.last_plan = None
        # hook: engine/plan_profile.PlanProfiler (sampled per-operator
        # profiled execution; the server sets the statement digest)
        self.plan_profiler = None
        # profiled runs that raised and fell back to the plain dispatch
        self.profile_fallbacks = 0
        # the narrowed result frame (the server wires these to
        # ob_enable_result_narrow / ob_result_narrow_rows /
        # ob_result_narrow_max_rows)
        self.narrow_enabled_fn = None
        self.narrow_default_rows = 256
        self.narrow_max_rows = 4096
        # hook: engine/result_cache.ResultCache (device-resident narrowed
        # results keyed by logical key, bound literals and watermark)
        self.result_cache = None
        # hook: tables -> snapshot watermark tuple
        self.result_watermark_fn = None
        # per-operator profile of the LAST profiled statement
        self.last_op_profile = None

    def materialize(self, text: str, name: str) -> Table:
        """Run a SELECT and return its result as a storage-domain Table
        (exact round trip: decimals stay scaled ints, dates day numbers,
        NULLs keep their validity masks), the engine half of
        materialized views."""
        ast = P.parse(text)
        if getattr(ast, "ctes", None) and recursive_cte_of(ast) is not None:
            batch, out_names = run_recursive(self, ast)
            names = list(out_names)
            schema_src = batch.schema
        else:
            planned = self.planner.plan(ast)
            schema_src = output_schema(planned.plan)
            batch = self.executor.execute(planned.plan)
            names = list(planned.output_names)
        valid = batch_valid_storage(batch, names)
        schema = renamed_storage_schema(schema_src, names)
        if valid:
            # a validity mask forces the field nullable, or the next read
            # of the table would drop the mask
            schema = Schema(tuple(
                Field(f.name, _replace(f.dtype, nullable=True))
                if f.name in valid else f
                for f in schema.fields
            ))
        return Table(
            name,
            schema,
            batch_rows_storage(batch, names),
            {n: batch.dicts[n] for n in names if n in batch.dicts},
            valid,
        )

    def sql(self, text: str):
        # fast-parser front end: one tokenize pass normalizes the
        # text-tier key and extracts the literal tokens; a warm repeat
        # skips parse + resolve + plan + parameterize entirely
        t0 = time.perf_counter()
        fkey, params, kinds = P.fast_normalize(text)
        use_cache = self.cache_enabled_fn() if self.cache_enabled_fn else True
        if use_cache:
            hit = self.fast_lookup(fkey, params)
            if hit is not None:
                return self.fast_execute(
                    hit, fastparse_s=time.perf_counter() - t0)
        fastparse_s = time.perf_counter() - t0
        # the plain plan-cache key is the fast key with kind markers
        # collapsed (the tokenizer never emits a bare '?')
        norm_key = fkey.replace("?n", "?").replace("?s", "?")
        ast = P.parse(text)
        return self.run_ast(
            ast, norm_key,
            fast_reg=(fkey, params, kinds) if use_cache else None,
            fastparse_s=fastparse_s,
        )

    def fast_lookup(self, text_key: str, params: tuple, fe=None,
                    defer_adds=None):
        """Text-tier lookup + literal re-bind + logical-tier fetch, or None
        (counted as a fast miss) when any stage rejects: unknown text, a
        baked token changed, a converter refused the new literal, or the
        logical entry is gone (which also drops the text entry). A caller
        that already peeked the text tier passes its FastEntry as `fe`;
        `defer_adds` goes to fast_hit_get (statement-end counter
        batching)."""
        pc = self.plan_cache
        if fe is None:
            fe = pc.fast_peek(text_key)
            if fe is None:
                pc.note_fast_miss()
                return None
        vals = fe.bind_tokens(params)
        if vals is None:
            pc.note_fast_miss()
            return None
        extra = (self.key_extra_fn(fe.tables)
                 if self.key_extra_fn is not None else ())
        key = (id(self.catalog), fe.norm_key, fe.sig, fe.baked,
               fe.fingerprint, extra)
        entry = pc.fast_hit_get(key, defer_adds=defer_adds)
        if entry is None:
            pc.fast_invalidate(text_key)
            pc.note_fast_miss()
            return None
        return _FastHit(text_key, fe, vals, entry, key)

    def result_cache_key(self, hit: _FastHit):
        """Result-cache identity of a fast hit, or None when the statement
        is uncacheable (not a SELECT, cache off). The key embeds the
        logical entry key (schema + dictionary versions ride key_extra),
        the bound literals and the referenced tables' snapshot watermark:
        any committed DML, schema bump or dictionary growth changes the
        key instead of serving a stale frame."""
        rc = self.result_cache
        if rc is None or not rc.enabled() or hit.key is None:
            return None
        if getattr(hit.fe, "stmt_type", None) != "Select":
            return None
        wm = (self.result_watermark_fn(hit.fe.tables)
              if self.result_watermark_fn is not None else ())
        # long string literals (query embeddings) key by digest
        vals = tuple(
            hashlib.sha256(v.encode()).digest()
            if type(v) is str and len(v) > 256 else v
            for v in hit.values
        )
        return (hit.key, vals, wm)

    def result_cache_probe(self, hit: _FastHit, rc_key,
                           fastparse_s: float = 0.0):
        """Serve a fast hit from the result cache, or None on a miss. A
        hit skips bind, dispatch and sync, and still fills last_phases /
        last_profile so completion accounting sees a normal statement."""
        rc = self.result_cache
        if rc is None or rc_key is None:
            return None
        ce = rc.get(rc_key)
        if ce is None:
            return None
        rs = ResultSet(ce.names, ce.copy_columns(), plan_cache_hit=True,
                       fast_path_hit=True)
        self.last_phases = {
            "plan_s": 0.0, "compile_s": 0.0, "fastparse_s": fastparse_s,
            "bind_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0,
            "exec_s": 0.0, "rows": rs.nrows, "cache_hit": True,
            "fast_hit": True, "result_cache": True,
        }
        profile = None
        if self.profile_enabled_fn is None or self.profile_enabled_fn():
            from ..server.diag import QueryProfile

            profile = QueryProfile(
                compile_hit=True, fastparse_s=fastparse_s,
                fast_path_hit=True)
        self.last_profile = profile
        self.last_plan = getattr(hit.entry.prepared, "plan", None)
        self.last_op_profile = None
        m = self.metrics
        if m is not None and m.enabled:
            m.add("result rows returned", rs.nrows)
            vts = getattr(
                getattr(hit.entry.prepared, "params", None),
                "vector_topns", None)
            if vts:
                m.add("ann cache hits")
        # a cached serve is still a read of its tables for access heat
        acc = self.access
        if acc is not None and acc.enabled:
            prepared = hit.entry.prepared
            memo = getattr(prepared, "_access_memo", None)
            if memo is None or memo[0] != acc.epoch:
                memo = (acc.epoch, acc.resolve(
                    getattr(prepared, "access_profile", ())))
                prepared._access_memo = memo
            acc.fold_resolved(memo[1])
        return rs

    def _result_cache_put(self, rc_key, hit: _FastHit, rs) -> None:
        """Admit a freshly executed result: only clean narrowed frames
        within the entry cap. The cursor reference pins the device frame;
        the decoded host columns make hits free of decode work."""
        rc = self.result_cache
        cur = getattr(rs, "_cursor", None)
        if rc is None or cur is None:
            return
        if not getattr(cur, "narrowed", False) \
                or getattr(cur, "_fallback", False):
            return
        nbytes = sum(
            int(getattr(a, "nbytes", 0))
            for d in (cur._hcols, cur._hvalid) for a in d.values()
        ) + int(getattr(cur._hsel, "nbytes", 0))
        if nbytes > rc.entry_limit:
            return
        try:
            cols = rs.columns
        except Exception:  # noqa: BLE001 - admission never fails a statement
            return
        rc.put(rc_key, rs.names, {n: cols[n] for n in rs.names}, nbytes,
               getattr(hit.fe, "tables", ()), cursor=cur)

    def fast_execute(self, hit: _FastHit, fastparse_s: float = 0.0,
                     rc_key=_RC_UNSET):
        """Execute a fast-tier hit: bind + dispatch the cached plan. Any
        failure drops the text entry (the next occurrence re-registers
        through the full path) and re-raises for the retry controller.
        `rc_key` carries a result-cache identity the caller already
        probed; left unset, this probes and admits itself."""
        profiling = (self.profile_enabled_fn() if self.profile_enabled_fn
                     else True)
        if rc_key is _RC_UNSET:
            rc_key = self.result_cache_key(hit)
            rs = self.result_cache_probe(hit, rc_key, fastparse_s)
            if rs is not None:
                return rs
        h2d0 = self.executor.h2d_bytes if profiling else 0
        try:
            rs = self._execute_entry(
                hit.entry, hit.values, ex=self.executor, was_hit=True,
                fast=True, plan_s=0.0, compile_s=0.0,
                fastparse_s=fastparse_s, profiling=profiling, h2d0=h2d0,
                plan_obj=getattr(hit.entry.prepared, "plan", None),
            )
        except Exception:
            self.plan_cache.fast_invalidate(hit.text_key)
            raise
        if rc_key is not None:
            try:
                self._result_cache_put(rc_key, hit, rs)
            except Exception:  # noqa: BLE001 - admission never fails it
                pass
        return rs

    def cached_entry(self, text: str):
        """(CacheEntry, bound qparams) of a statement already run through
        sql(), in the form sql() bound them: re-running
        `entry.prepared` with them re-plans nothing. (None, None) on a
        cache miss."""
        norm_key, _ = P.normalize_for_cache(text)
        planned = self.planner.plan(P.parse(text))
        pz = parameterize(planned.plan)
        key = self._key_parts(norm_key, pz)[0]
        entry = self.plan_cache.get(key)
        if entry is None:
            return None, None
        return entry, _bind(entry, pz.values, self.executor.device)

    def _key_parts(self, norm_key: str, pz, executor=None
                   ) -> tuple[tuple, tuple, str]:
        """(logical cache key, referenced table names, plan fingerprint);
        the tables and fingerprint also seed fast-tier registration."""
        tables = tuple(sorted(
            {s.table for s in self.executor._collect_scans(pz.plan)}
        ))
        extra = self.key_extra_fn(tables) if self.key_extra_fn is not None \
            else ()
        # an executor override (the degraded rungs) builds a different
        # program for the same text: its entry must not collide
        if executor is not None and executor is not self.executor:
            extra = (*extra, "#exec", id(executor))
        fp = plan_fingerprint(pz.plan)
        # id(catalog) scopes entries to one table set; the fingerprint
        # catches literals consumed at plan time (ORDER BY ordinals)
        key = (id(self.catalog), norm_key, pz.sig, pz.baked, fp, extra)
        return key, tables, fp

    def run_ast(self, ast, norm_key: str, use_cache: bool | None = None,
                executor=None, fast_reg=None, fastparse_s: float = 0.0):
        """Plan + execute a parsed SELECT under the plan cache. Shared by
        text queries and internal consumers (the DML layer's qualification
        scans, virtual-table queries). use_cache=False bypasses the plan
        cache; `executor` overrides the executor for this statement (the
        server's degraded rungs); `fast_reg` = (text_key, raw_params,
        kinds) registers the statement in the text tier on success."""
        if getattr(ast, "ctes", None) and recursive_cte_of(ast) is not None:
            out_batch, names = run_recursive(self, ast)
            host = batch_to_host(out_batch)
            return ResultSet(tuple(names), {n: host[n] for n in names})
        # JSON_OBJECT/JSON_ARRAY select items: the device computes the
        # argument columns, the host formats the JSON text at result
        # assembly; the spec joins the cache key, so statements that
        # differ only in constructor literals never share an entry
        try:
            ast, jspecs, jhidden = split_host_json(ast)
        except ValueError as err:
            raise ResolveError(str(err)) from None
        if jspecs:
            norm_key = f"{norm_key}|jh:{jspecs!r}"
        ex = executor if executor is not None else self.executor
        t0 = time.perf_counter()
        planned = self.planner.plan(ast)
        pz = parameterize(planned.plan)
        key, tables, fp = self._key_parts(norm_key, pz, executor)
        plan_s = time.perf_counter() - t0
        if use_cache is None:
            use_cache = self.cache_enabled_fn() if self.cache_enabled_fn \
                else True
        entry = self.plan_cache.get(key) if use_cache else None
        was_hit = entry is not None
        profiling = (self.profile_enabled_fn() if self.profile_enabled_fn
                     else True)
        h2d0 = ex.h2d_bytes if profiling else 0
        compile_s = 0.0
        if entry is None:
            t0 = time.perf_counter()
            prepared = ex.prepare(pz.plan)
            compile_s = time.perf_counter() - t0
            entry = CacheEntry(prepared, planned.output_names, pz.dtypes)
            entry.json_specs, entry.json_hidden = jspecs, jhidden
            if self.plan_monitor is not None and self.plan_monitor.enabled:
                entry.monitor = self.plan_monitor.register(norm_key, compile_s)
            if use_cache:
                self.plan_cache.put(key, entry)
        rs = self._execute_entry(
            entry, pz.values, ex=ex, was_hit=was_hit, fast=False,
            plan_s=plan_s, compile_s=compile_s, fastparse_s=fastparse_s,
            profiling=profiling, h2d0=h2d0, plan_obj=pz.plan,
        )
        # the text tier keys on the literal-free text, which cannot tell
        # constructor literals apart: JSON-split statements never
        # register, nor do executor overrides and cache-bypassed ones
        if fast_reg is not None and use_cache and executor is None \
                and not jspecs:
            fkey, params, kinds = fast_reg
            self.plan_cache.fast_put(fkey, FastEntry(
                norm_key=norm_key, sig=pz.sig, baked=pz.baked,
                fingerprint=fp, tables=tables,
                slot_map=build_slot_map(params, kinds, pz.values),
                base_values=tuple(pz.values),
                stmt_type=type(ast).__name__,
            ))
        return rs

    def _dispatch_lazy(self, entry, qparams, ex):
        """Dispatch a whole-plan statement without a host sync: the
        profiled segmented run when the profiler samples this digest, the
        narrowed frame when the plan narrows, else the plain program.
        Returns (cursor, out, narrow, op_samples, digest, reason)."""
        prepared = entry.prepared
        op_samples = prof_digest = prof_reason = None
        narrow = None
        out = None
        pp = self.plan_profiler
        if pp is not None and pp.enabled:
            from . import plan_profile as _PP

            if _PP.profile_eligible(prepared):
                # the server hands the statement digest down thread-
                # locally; direct engine use keys by the monitor's text
                mon0 = getattr(entry, "monitor", None)
                prof_digest = pp.take_pending() or (
                    mon0.sql if mon0 is not None else None)
                if prof_digest is not None:
                    prof_reason = pp.decide(prof_digest)
        if prof_reason is not None:
            from . import plan_profile as _PP

            try:
                # the statement is served from the profiled run: nothing
                # executes twice, and (out, ovf_vec) equal the plain run's
                out, ovf_vec, op_samples = _PP.run_profiled(prepared, qparams)
            except Exception:  # noqa: BLE001 - a profile never fails a query
                self.profile_fallbacks += 1
                m = self.metrics
                if m is not None and m.enabled:
                    m.add("plan profile fallbacks")
                out = op_samples = None
        if out is None:
            nfn = self.narrow_enabled_fn
            if ((nfn is None or nfn()) and ex is self.executor
                    and hasattr(prepared, "narrow_frame")):
                ncap = prepared.narrow_frame(
                    self.narrow_default_rows, self.narrow_max_rows)
                if ncap:
                    out, ovf_vec, novf = prepared.run_device_narrow(
                        qparams, ncap)
                    narrow = (novf, ncap)
        if out is None:
            out, ovf_vec = prepared.run_device(qparams=qparams)
        if narrow is not None:
            cursor = NarrowDeviceResult(
                prepared, qparams, out, ovf_vec, narrow[0], narrow[1],
                self.narrow_max_rows)
        else:
            cursor = DeviceResult(prepared, qparams, out, ovf_vec)
        return cursor, out, narrow, op_samples, prof_digest, prof_reason

    def _execute_entry(self, entry, values, *, ex, was_hit, fast, plan_s,
                       compile_s, fastparse_s, profiling, h2d0, plan_obj):
        """Bind + dispatch a cached or fresh entry and assemble the result,
        profile, monitor row, phase breakdown and metrics. Shared by the
        full path (run_ast) and the fast path (fast_execute).

        Whole-plan statements take the lazy route: dispatch enqueues the
        device work, the host bookkeeping overlaps it, and the one sync
        is the overflow + row-count read (or the narrowed frame's one
        completion copy). An out-of-core plan runs to its end in dispatch
        and hands its checked batch to the same cursor. A JSON-split
        statement fetches every column eagerly (the host formatting reads
        them all) and returns a ResultSet."""
        from ..share.errsim import errsim_point

        if not getattr(ex, "host_fallback", False):
            # device OOM injection point (EN_DEVICE_OOM): the fast path,
            # the full path and the out-of-core dispatch alike; the host
            # rung never device-OOMs, which ends the degradation ladder
            errsim_point("EN_DEVICE_OOM")
        jn = getattr(entry, "json_specs", ())
        prepared = entry.prepared
        retries0 = getattr(prepared, "retries", 0)
        params = getattr(prepared, "params", None)
        ann0 = getattr(params, "ann_escalations", 0)
        # out-of-core plans carry streaming counters; fold this run's deltas
        sstats = getattr(prepared, "stream_stats", None)
        stream0 = sstats.snapshot() if sstats is not None else None
        t0 = time.perf_counter()
        qparams = _bind(entry, values, ex.device)
        bind_s = time.perf_counter() - t0
        d2h_bytes = 0
        exec_t0 = time.perf_counter()
        self.last_op_profile = None
        op_samples = prof_digest = prof_reason = None
        narrow = None
        lazy = not jn
        if lazy:
            if hasattr(prepared, "run_device"):
                (cursor, out, narrow, op_samples, prof_digest,
                 prof_reason) = self._dispatch_lazy(entry, qparams, ex)
            else:
                # chunked / grace-hash plans run to their end here
                out = prepared.run(qparams=qparams)
                cursor = DeviceResult(prepared, qparams, out, None)
            dispatch_s = time.perf_counter() - exec_t0
            rs = LazyResultSet(entry.output_names, cursor,
                               plan_cache_hit=was_hit, fast_path_hit=fast)
        else:
            if hasattr(prepared, "run_host"):
                hcols, hvalid, hsel, oschema, odicts = prepared.run_host(
                    qparams=qparams)
                host = host_rows(oschema, odicts, hcols, hvalid, hsel)
                if profiling:
                    d2h_bytes = sum(
                        int(getattr(a, "nbytes", 0))
                        for d in (hcols, hvalid) for a in d.values()
                    ) + int(getattr(hsel, "nbytes", 0))
            else:
                host = batch_to_host(prepared.run(qparams=qparams))
                if profiling:
                    d2h_bytes = sum(
                        int(getattr(a, "nbytes", 0)) for a in host.values())
            dispatch_s = time.perf_counter() - exec_t0
            names, cols = apply_host_json(
                jn, entry.json_hidden, entry.output_names,
                {n: host[n] for n in entry.output_names})
            rs = ResultSet(names, cols, plan_cache_hit=was_hit,
                           fast_path_hit=fast)
        profile = None
        if profiling:
            from ..server.diag import QueryProfile

            device_bytes = 0
            input_spec = getattr(prepared, "input_spec", None)
            if input_spec is not None:
                # warm statements reuse the footprint walk: device inputs
                # change only through an upload, which moves h2d_bytes
                memo = getattr(prepared, "_dev_bytes_memo", None)
                if (memo is not None and memo[0] == ex.h2d_bytes
                        and memo[1] is ex):
                    device_bytes = memo[2]
                else:
                    device_bytes = ex.input_device_bytes(input_spec)
                    prepared._dev_bytes_memo = (
                        ex.h2d_bytes, ex, device_bytes)
            if lazy:
                # the result's device footprint (no transfer); the cursor
                # adds the bytes it actually copies as fetches happen
                rmemo = getattr(prepared, "_result_bytes_memo", None)
                if narrow is not None:
                    # the frame's bytes, not memoized: the memo feeds the
                    # plain cursor's small-result test against the
                    # un-narrowed output shape
                    result_bytes = sum(
                        int(getattr(a, "nbytes", 0))
                        for d in (out.cols, out.valid) for a in d.values()
                    ) + int(getattr(out.sel, "nbytes", 0))
                elif rmemo is not None and rmemo[0] == retries0:
                    result_bytes = rmemo[1]
                else:
                    result_bytes = sum(
                        int(getattr(a, "nbytes", 0))
                        for d in (out.cols, out.valid) for a in d.values()
                    ) + int(getattr(out.sel, "nbytes", 0))
                    if hasattr(prepared, "run_device"):
                        prepared._result_bytes_memo = (retries0,
                                                       result_bytes)
            else:
                result_bytes = d2h_bytes
            profile = QueryProfile(
                compile_hit=was_hit,
                compile_s=compile_s,
                h2d_bytes=ex.h2d_bytes - h2d0,
                d2h_bytes=d2h_bytes,
                device_bytes=device_bytes,
                peak_bytes=device_bytes + result_bytes,
                fastparse_s=fastparse_s,
                bind_s=bind_s,
                dispatch_s=dispatch_s,
                fetch_s=0.0,
                fast_path_hit=fast,
            )
        self.last_profile = profile
        self.last_plan = plan_obj
        phases = {
            "plan_s": plan_s, "compile_s": compile_s,
            "fastparse_s": fastparse_s, "bind_s": bind_s,
            "dispatch_s": dispatch_s, "fetch_s": 0.0,
            "cache_hit": was_hit, "fast_hit": fast,
        }
        self.last_phases = phases
        if lazy:
            # wire the in-place observability sinks, THEN force the sync
            # point; the sync wall is the statement's device wait
            cursor.profile = profile
            cursor.phases = phases
            tf = time.perf_counter()
            nrows = rs.nrows
            fetch_s = time.perf_counter() - tf
            phases["fetch_s"] = fetch_s
            if profile is not None:
                profile.fetch_s = fetch_s
        else:
            nrows = rs.nrows
        exec_s = time.perf_counter() - exec_t0
        phases["exec_s"] = exec_s
        phases["rows"] = nrows
        acc = self.access
        if acc is not None and acc.enabled:
            # access heat: the profile resolves to live stat objects once
            # per (prepared, epoch); later executions fold directly
            memo = getattr(prepared, "_access_memo", None)
            if memo is None or memo[0] != acc.epoch:
                memo = (acc.epoch, acc.resolve(
                    getattr(prepared, "access_profile", ())))
                prepared._access_memo = memo
            if memo[1]:
                acc.fold_resolved(memo[1])
        # PX collective accounting: the MeshPlan rides the prepared plan
        # (recorded on its first run), so cached plans fold identically
        mesh_plan = getattr(prepared, "mesh_plan", None)
        if mesh_plan is not None and not mesh_plan.total_ops:
            mesh_plan = None
        stream_d = None
        if sstats is not None:
            d = tuple(b - a for a, b in zip(stream0, sstats.snapshot()))
            if d[0] or d[6]:  # chunks streamed or partitions spilled
                stream_d = d
                phases["stream_h2d_s"] = d[3]
                phases["stream_compute_s"] = d[4]
                phases["stream_overlap_s"] = d[5]
        mon = getattr(entry, "monitor", None)
        if mon is not None:
            mon.runs += 1
            mon.total_exec_s += exec_s
            mon.last_rows = nrows
            mon.overflow_retries = getattr(prepared, "retries", 0)
            if profile is not None:
                mon.total_transfer_bytes += profile.transfer_bytes
                mon.last_device_bytes = profile.device_bytes
                mon.peak_bytes = max(mon.peak_bytes, profile.peak_bytes)
            if mesh_plan is not None:
                mon.px_collective_ops += mesh_plan.total_ops
                mon.px_collective_bytes += mesh_plan.total_bytes
                mon.px_exchanges = mesh_plan.describe()
            if stream_d is not None:
                mon.stream_chunks += stream_d[0]
                mon.spill_partitions += stream_d[6]
                h2d_d, overlap_d = stream_d[3], stream_d[5]
                mon.h2d_overlap_pct = (
                    100.0 * overlap_d / h2d_d if h2d_d else 0.0)
        if op_samples is not None and self.plan_profiler is not None:
            # fold the (estimate, actual) calibration pairs; EXPLAIN
            # ANALYZE reads last_op_profile right after this run
            est = getattr(prepared, "node_estimates", None)
            self.plan_profiler.store.fold(
                prof_digest, op_samples, est,
                plan_id=mon.plan_id if mon is not None else 0,
            )
            seg = getattr(prepared, "_segmented", None)
            self.last_op_profile = {
                "digest": prof_digest,
                "reason": prof_reason,
                "estimates": dict(est or {}),
                "samples": op_samples,
                # plan nodes never emitted on their own (a Join absorbed
                # by a clustered-FK aggregate): no sample, charged to the
                # absorbing parent
                "absorbed": dict(getattr(seg, "absorbed", None) or {}),
            }
            pm = self.metrics
            if pm is not None and pm.enabled:
                pm.add("plan profiles")
                pm.add(f"plan profiles: {prof_reason}")
                for smp in op_samples:
                    pm.add(f"plan profile ops: {smp.op_kind}")
        vts = getattr(params, "vector_topns", None)
        esc = getattr(params, "ann_escalations", 0) - ann0
        if vts:
            # per (table, column): queries, probed lists, escalations
            stats = ex.ann_stats
            for v in vts.values():
                st = stats.setdefault((v.table, v.column), [0, 0, 0])
                st[0] += 1
                st[1] += v.nprobe
                st[2] += max(esc, 0)
        m = self.metrics
        if m is not None and m.enabled:
            m.observe("sql plan", plan_s)
            if not was_hit:
                m.observe("sql compile", compile_s)
            m.observe("sql execute", exec_s)
            m.add("result rows returned", nrows)
            if narrow is not None:
                m.add("stmt fused dispatches")
            retries = getattr(prepared, "retries", 0) - retries0
            if retries > 0:
                m.add("overflow recompiles", retries)
            if vts:
                m.add("ann probes", sum(v.nprobe for v in vts.values()))
                if esc > 0:
                    m.add("ann over-probe escalations", esc)
            if mesh_plan is not None:
                for coll, cnt in mesh_plan.ops_by_collective().items():
                    m.add(f"px collective {coll}", cnt)
                m.add("px collective bytes", mesh_plan.total_bytes)
            if stream_d is not None:
                m.add("stream chunks", stream_d[0])
                m.add("stream h2d overlap", int(stream_d[5] * 1e6))
                if stream_d[6]:
                    m.add("stream spill partitions", stream_d[6])
        tl = self.timeline
        if tl is not None and tl.enabled:
            # serving timeline: this dispatch's device-busy seconds plus
            # build and result-transfer interference
            tl.record_exec(dispatch_s, 0.0 if was_hit else compile_s,
                           d2h_bytes)
            if mesh_plan is not None:
                tl.record_collective(
                    mesh_plan.total_ops, mesh_plan.total_bytes)
            if stream_d is not None:
                tl.record_stream(stream_d[0], stream_d[3], stream_d[4],
                                 stream_d[5], stream_d[6])
        return rs


def _bind(entry, values, device):
    """Bound parameters in their dispatch form: every prepared plan (the
    out-of-core ones too) packs them into one int64 row uploaded in one
    copy (K24 reads its literals from it); a plan whose slots cannot be
    packed keeps the legacy tuple of 0-d tensors."""
    return upload_qparams(entry.prepared.bind(values, entry.dtypes), device)
