"""Session facade: SQL text in, result rows out, with a plan cache.

Counterpart of `oceanbase_tpu/engine/session.py` without the server hooks
(metrics, tracer, plan monitor, profiler, result cache, timeline): text ->
fast-parser key -> (text-tier hit: re-bind literals into the cached plan)
or (parse -> resolve/plan -> parameterize -> logical-tier lookup or
prepare) -> one device pass -> lazy result cursor. A statement whose
inputs exceed the executor's device budget runs out of core (chunked or
grace-hash) and reports its streaming walls in `last_phases`
(stream_h2d_s, stream_compute_s, stream_overlap_s). WITH RECURSIVE runs
as a host fixpoint (engine/recursive.py); JSON_OBJECT/JSON_ARRAY select
items split into hidden argument columns and are formatted on the host
(sql/json_host.py); `materialize` returns a SELECT as a storage-domain
Table; `cached_entry` hands the prepared plan of a statement already run
back with its bound parameters. A statement served by the IVF route adds
to the executor's `ann_stats` per (table, column): queries, probed lists
and over-probe escalations.

The session owns its `torch.device`: None means the first CUDA device
and raises when there is none; the CPU tests pass ``device="cpu"``.
"""

from __future__ import annotations

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
    bind,
    build_slot_map,
    parameterize,
    plan_fingerprint,
)
from ..sql.planner import Planner
from .executor import DeviceResult, Executor
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
    happen there); `.columns` fetches everything once."""

    def __init__(self, names: tuple[str, ...], cursor,
                 plan_cache_hit: bool = False, fast_path_hit: bool = False):
        self.names = names
        self.affected = 0
        self.plan_cache_hit = plan_cache_hit
        self.fast_path_hit = fast_path_hit
        self._cursor = cursor
        self._columns_cache: dict | None = None

    @property
    def nrows(self) -> int:
        return self._cursor.nrows if self.names else 0

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


@dataclass
class _FastHit:
    """A resolved fast-tier lookup: the text entry, the re-bound slot
    values for THIS statement's literals, and the logical entry."""

    text_key: str
    fe: FastEntry
    values: list
    entry: CacheEntry


class Session:
    def __init__(self, catalog, unique_keys=None, device=None):
        from ..share.stats import StatsManager

        self.catalog = catalog
        self.device = _device(device)
        self.stats = StatsManager(catalog)
        self.planner = Planner(catalog, stats=self.stats,
                               unique_keys=unique_keys)
        self.executor = Executor(catalog, unique_keys=unique_keys,
                                 stats=self.stats, device=self.device)
        self.plan_cache = PlanCache()
        # phase breakdown of the LAST statement (seconds)
        self.last_phases: dict = {}

    def materialize(self, text: str, name: str) -> Table:
        """Run a SELECT and return its result as a storage-domain Table
        (exact round trip: decimals stay scaled ints, dates day numbers,
        NULLs keep their validity masks), the engine half of
        materialized views."""
        ast = P.parse(text)
        if recursive_cte_of(ast) is not None:
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
        hit = self.fast_lookup(fkey, params)
        if hit is not None:
            return self._execute_entry(
                hit.entry, hit.values, was_hit=True, fast=True,
                phases={"fastparse_s": time.perf_counter() - t0},
                text_key=hit.text_key)
        fastparse_s = time.perf_counter() - t0
        # the plain plan-cache key is the fast key with kind markers
        # collapsed (the tokenizer never emits a bare '?')
        norm_key = fkey.replace("?n", "?").replace("?s", "?")
        ast = P.parse(text)
        return self.run_ast(ast, norm_key, fast_reg=(fkey, params, kinds),
                            fastparse_s=fastparse_s)

    def fast_lookup(self, text_key: str, params: tuple):
        """Text-tier lookup + literal re-bind + logical-tier fetch, or None
        (counted as a fast miss) when any stage rejects."""
        pc = self.plan_cache
        fe = pc.fast_peek(text_key)
        if fe is None:
            pc.note_fast_miss()
            return None
        vals = fe.bind_tokens(params)
        if vals is None:
            pc.note_fast_miss()
            return None
        key = (id(self.catalog), fe.norm_key, fe.sig, fe.baked,
               fe.fingerprint, ())
        entry = pc.fast_hit_get(key)
        if entry is None:
            pc.fast_invalidate(text_key)
            pc.note_fast_miss()
            return None
        return _FastHit(text_key, fe, vals, entry)

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
        return entry, bind(pz.values, entry.dtypes, self.executor.device)

    def _key_parts(self, norm_key: str, pz) -> tuple[tuple, tuple, str]:
        """(logical cache key, referenced table names, plan fingerprint)."""
        tables = tuple(sorted(
            {s.table for s in self.executor._collect_scans(pz.plan)}
        ))
        fp = plan_fingerprint(pz.plan)
        key = (id(self.catalog), norm_key, pz.sig, pz.baked, fp, ())
        return key, tables, fp

    def run_ast(self, ast, norm_key: str, fast_reg=None,
                fastparse_s: float = 0.0):
        """Plan + execute a parsed SELECT under the plan cache; a success
        registers the text in the fast tier when `fast_reg` is given."""
        if recursive_cte_of(ast) is not None:
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
        t0 = time.perf_counter()
        planned = self.planner.plan(ast)
        pz = parameterize(planned.plan)
        key, tables, fp = self._key_parts(norm_key, pz)
        plan_s = time.perf_counter() - t0
        entry = self.plan_cache.get(key)
        was_hit = entry is not None
        compile_s = 0.0
        if entry is None:
            t0 = time.perf_counter()
            prepared = self.executor.prepare(pz.plan)
            compile_s = time.perf_counter() - t0
            entry = CacheEntry(prepared, planned.output_names, pz.dtypes)
            entry.json_specs, entry.json_hidden = jspecs, jhidden
            self.plan_cache.put(key, entry)
        rs = self._execute_entry(
            entry, pz.values, was_hit=was_hit, fast=False,
            phases={"fastparse_s": fastparse_s, "plan_s": plan_s,
                    "compile_s": compile_s},
        )
        # the text tier keys on the literal-free text, which cannot tell
        # constructor literals apart: JSON-split statements never register
        if fast_reg is not None and not jspecs:
            fkey, params, kinds = fast_reg
            self.plan_cache.fast_put(fkey, FastEntry(
                norm_key=norm_key, sig=pz.sig, baked=pz.baked,
                fingerprint=fp, tables=tables,
                slot_map=build_slot_map(params, kinds, pz.values),
                base_values=tuple(pz.values),
                stmt_type=type(ast).__name__,
            ))
        return rs

    def _execute_entry(self, entry, values, *, was_hit, fast, phases,
                       text_key=None):
        """Bind + dispatch a cached/compiled entry behind a lazy cursor;
        the row count (two small reads) is the statement's sync point.
        A JSON-split statement fetches every column eagerly (the host
        formatting reads them all) and returns a ResultSet."""
        prepared = entry.prepared
        jn = getattr(entry, "json_specs", ())
        params = getattr(prepared, "params", None)
        ann0 = getattr(params, "ann_escalations", 0)
        # out-of-core plans carry streaming counters; the statement reads
        # its own run's deltas
        sstats = getattr(prepared, "stream_stats", None)
        stream0 = sstats.snapshot() if sstats is not None else None
        t0 = time.perf_counter()
        try:
            qparams = bind(values, entry.dtypes, self.executor.device)
            t1 = time.perf_counter()
            if jn:
                if hasattr(prepared, "run_host"):
                    hcols, hvalid, hsel, oschema, odicts = prepared.run_host(
                        qparams=qparams)
                    host = host_rows(oschema, odicts, hcols, hvalid, hsel)
                else:
                    host = batch_to_host(prepared.run(qparams=qparams))
                t2 = time.perf_counter()
                names, cols = apply_host_json(
                    jn, entry.json_hidden, entry.output_names,
                    {n: host[n] for n in entry.output_names})
                rs = ResultSet(names, cols, plan_cache_hit=was_hit,
                               fast_path_hit=fast)
            else:
                if hasattr(prepared, "run_device"):
                    out, ovf_vec = prepared.run_device(qparams=qparams)
                else:
                    # chunked / grace-hash plans run to the end here
                    out, ovf_vec = prepared.run(qparams=qparams), None
                t2 = time.perf_counter()
                cursor = DeviceResult(prepared, qparams, out, ovf_vec)
                rs = LazyResultSet(entry.output_names, cursor,
                                   plan_cache_hit=was_hit,
                                   fast_path_hit=fast)
            nrows = rs.nrows
        except Exception:
            if text_key is not None:
                # the next occurrence re-registers through the full path
                self.plan_cache.fast_invalidate(text_key)
            raise
        t3 = time.perf_counter()
        phases.update(bind_s=t1 - t0, dispatch_s=t2 - t1, fetch_s=t3 - t2,
                      exec_s=t3 - t0, rows=nrows, cache_hit=was_hit,
                      fast_hit=fast)
        vts = getattr(params, "vector_topns", None)
        if vts:
            # per (table, column): queries, probed lists, escalations (the
            # reference's per-statement ANN record)
            esc = getattr(params, "ann_escalations", 0) - ann0
            stats = self.executor.ann_stats
            for v in vts.values():
                st = stats.setdefault((v.table, v.column), [0, 0, 0])
                st[0] += 1
                st[1] += v.nprobe
                st[2] += max(esc, 0)
        if sstats is not None:
            d = tuple(b - a for a, b in zip(stream0, sstats.snapshot()))
            if d[0] or d[6]:  # chunks streamed or partitions spilled
                phases["stream_h2d_s"] = d[3]
                phases["stream_compute_s"] = d[4]
                phases["stream_overlap_s"] = d[5]
        self.last_phases = phases
        return rs

