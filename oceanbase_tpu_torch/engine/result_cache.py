"""Device-resident result cache: the tier ABOVE the plan cache.

The statement fast path (engine/session.py) already skips parse, resolve,
plan and compile for a warm statement; what remains per hit is bind +
dispatch + the completion sync. For the repeated-dashboard shape — the
same normalized text with the same bound literals against unchanged
tables — even that is redundant: the narrowed result frame the fused
program produced last time is still exactly the answer. This cache holds
those frames, keyed like the fast tier plus the bound literals and a
snapshot watermark, so a repeat serves decoded host columns with ZERO
device dispatches.

Identity = (logical entry key, bound literal values, snapshot watermark):
- the logical key embeds schema + dictionary versions via key_extra, so a
  schema bump or dictionary growth changes the key (never a stale serve);
- the watermark is the referenced tables' committed data versions (the
  server wires it), so committed DML changes the key;
- DML/flush additionally REMOVE entries eagerly (invalidate_tables /
  flush) — the key change alone would strand dead frames at capacity.

Each entry keeps a reference to the NarrowDeviceResult cursor that
produced it, pinning the ncap-row frame on device: the cache is charged
against the tenant's memory unit through the governor residency surface
(server/database.py _resident_bytes) and drops its pins under the same
OOM/eviction ladder as cold table residency (rung 1 flushes it first —
cached results are the most re-creatable bytes on the chip).
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class ResultEntry:
    """One cached narrowed result: decoded host columns (hits pay no
    fold work) + the device frame pin via the producing cursor."""

    __slots__ = ("names", "columns", "nbytes", "tables", "cursor", "hits")

    def __init__(self, names, columns, nbytes, tables, cursor=None):
        self.names = tuple(names)
        self.columns = columns
        self.nbytes = int(nbytes)
        self.tables = tuple(tables)
        self.cursor = cursor
        self.hits = 0

    def copy_columns(self) -> dict:
        """Defensive per-serve copy: clients may mutate result arrays in
        place, and a shared reference would corrupt every later hit."""
        out = {}
        for n, v in self.columns.items():
            if isinstance(v, list):
                out[n] = list(v)
            elif hasattr(v, "copy"):
                out[n] = v.copy()
            else:
                out[n] = v
        return out


def _copy_columns(columns: dict) -> dict:
    return ResultEntry((), columns, 0, ()).copy_columns()


class ResultCache:
    """LRU by bytes with a per-table inverted index for DML invalidation.

    Thread-safe: server sessions probe/admit concurrently. Unhashable
    keys (a statement bound an unhashable literal) degrade to a miss /
    no-admit instead of failing the statement."""

    def __init__(self, capacity_bytes: int = 4 << 20,
                 entry_limit: int = 65536, enabled_fn=None,
                 pressure_fn=None, metrics=None):
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._by_table: dict[str, set] = {}
        self.capacity_bytes = int(capacity_bytes)
        self.entry_limit = int(entry_limit)
        # hook: ob_enable_result_cache (session checks before keying)
        self.enabled_fn = enabled_fn
        # hook: governor under_pressure — a pressured tenant must not
        # grow its device pins for a speculative cache admit
        self.pressure_fn = pressure_fn
        self.metrics = metrics
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.invalidations = 0

    # ------------------------------------------------------------ knobs
    def enabled(self) -> bool:
        fn = self.enabled_fn
        return bool(fn()) if fn is not None else True

    def _count(self, name: str) -> None:
        m = self.metrics
        if m is not None and m.enabled:
            m.add(name)

    # ------------------------------------------------------------ probe
    def get(self, key):
        with self._lock:
            try:
                e = self._entries.get(key)
            except TypeError:
                e = None
            if e is None:
                self.misses += 1
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                e.hits += 1
        self._count("result cache hits" if e is not None
                    else "result cache misses")
        return e

    # ------------------------------------------------------------ admit
    def put(self, key, names, columns, nbytes, tables, cursor=None) -> bool:
        nbytes = int(nbytes)
        if nbytes > self.entry_limit or nbytes > self.capacity_bytes:
            return False
        pf = self.pressure_fn
        if pf is not None and pf():
            self._count("result cache admit refused: pressure")
            return False
        entry = ResultEntry(names, _copy_columns(columns), nbytes, tables,
                            cursor=cursor)
        with self._lock:
            try:
                old = self._entries.pop(key, None)
            except TypeError:
                return False
            if old is not None:
                self._forget(key, old)
            self._entries[key] = entry
            self.bytes_used += nbytes
            for t in entry.tables:
                self._by_table.setdefault(t, set()).add(key)
            self.puts += 1
            while self.bytes_used > self.capacity_bytes and self._entries:
                k2, e2 = self._entries.popitem(last=False)
                self._forget(k2, e2)
                self.evictions += 1
        self._count("result cache puts")
        return True

    def _forget(self, key, e) -> None:
        # lock held: undo one entry's byte + index accounting
        self.bytes_used -= e.nbytes
        for t in e.tables:
            s = self._by_table.get(t)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._by_table[t]

    # ------------------------------------------------------- invalidate
    def invalidate_tables(self, tables) -> int:
        """Eager drop of every entry touching any of `tables` (committed
        DML, schema change). Returns the number dropped."""
        n = 0
        with self._lock:
            keys = set()
            for t in tables:
                keys |= self._by_table.get(t, set())
            for k in keys:
                e = self._entries.pop(k, None)
                if e is not None:
                    self._forget(k, e)
                    n += 1
            self.invalidations += n
        if n:
            self._count("result cache invalidations")
        return n

    def flush(self) -> int:
        """Drop everything (plan-cache flush, OOM eviction rung)."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_table.clear()
            self.bytes_used = 0
            self.invalidations += n
        return n

    # ---------------------------------------------------- observability
    def device_bytes(self) -> int:
        """Device-pinned frame bytes (governor residency charge). The
        narrowed frame mirrors the host copy byte-for-byte, so the host
        accounting doubles as the device charge."""
        return self.bytes_used

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes_used": self.bytes_used,
                "capacity_bytes": self.capacity_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }

    def rows(self):
        """(tables, nrows, nbytes, hits) per entry, LRU->MRU — the
        __all_virtual_result_cache surface."""
        with self._lock:
            out = []
            for e in self._entries.values():
                nrows = 0
                if e.names:
                    nrows = len(e.columns[e.names[0]])
                out.append((",".join(e.tables), nrows, e.nbytes, e.hits))
            return out
