"""Session facade: SQL text in, result rows out, with a plan cache.

Counterpart of `oceanbase_tpu/engine/session.py` without the server hooks
(metrics, tracer, plan monitor, profiler, result cache, timeline): text ->
fast-parser key -> (text-tier hit: re-bind literals into the cached plan)
or (parse -> resolve/plan -> parameterize -> logical-tier lookup or
prepare) -> one device pass -> lazy result cursor. A statement whose
inputs exceed the executor's device budget runs out of core (chunked or
grace-hash) and reports its streaming walls in `last_phases`
(stream_h2d_s, stream_compute_s, stream_overlap_s).

The session owns its `torch.device`: None means the first CUDA device
and raises when there is none; the CPU tests pass ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

from .. import device as _device
from ..sql import ast as A
from ..sql import parser as P
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
        if _self_referencing_cte(ast):
            raise NotImplementedError(
                "WITH RECURSIVE (engine/recursive.py) is not ported to the "
                "torch engine yet")
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
            self.plan_cache.put(key, entry)
        rs = self._execute_entry(
            entry, pz.values, was_hit=was_hit, fast=False,
            phases={"fastparse_s": fastparse_s, "plan_s": plan_s,
                    "compile_s": compile_s},
        )
        if fast_reg is not None:
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
        the row count (two small reads) is the statement's sync point."""
        prepared = entry.prepared
        # out-of-core plans carry streaming counters; the statement reads
        # its own run's deltas
        sstats = getattr(prepared, "stream_stats", None)
        stream0 = sstats.snapshot() if sstats is not None else None
        t0 = time.perf_counter()
        try:
            qparams = bind(values, entry.dtypes, self.executor.device)
            t1 = time.perf_counter()
            if hasattr(prepared, "run_device"):
                out, ovf_vec = prepared.run_device(qparams=qparams)
            else:
                # chunked / grace-hash plans run to the end here
                out, ovf_vec = prepared.run(qparams=qparams), None
            t2 = time.perf_counter()
            cursor = DeviceResult(prepared, qparams, out, ovf_vec)
            rs = LazyResultSet(entry.output_names, cursor,
                               plan_cache_hit=was_hit, fast_path_hit=fast)
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
        if sstats is not None:
            d = tuple(b - a for a, b in zip(stream0, sstats.snapshot()))
            if d[0] or d[6]:  # chunks streamed or partitions spilled
                phases["stream_h2d_s"] = d[3]
                phases["stream_compute_s"] = d[4]
                phases["stream_overlap_s"] = d[5]
        self.last_phases = phases
        return rs


def _self_referencing_cte(ast) -> bool:
    """True when a CTE declared RECURSIVE names itself in its body (the
    reference runs such statements as a host-driven fixpoint,
    engine/recursive.py); a plain WITH naming its own name reads the
    catalog table, as standard scoping says."""
    declared = set(getattr(ast, "recursive_ctes", ()) or ())
    return any(name in declared and name in _table_refs(body, set())
               for name, body in getattr(ast, "ctes", ()) or ())


def _table_refs(node, out: set) -> set:
    if isinstance(node, A.TableRef):
        out.add(node.name)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            _table_refs(getattr(node, f.name), out)
    elif isinstance(node, (tuple, list)):
        for x in node:
            _table_refs(x, out)
    return out
