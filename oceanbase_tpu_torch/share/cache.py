"""KV cache: memory-budgeted LRU for decoded storage blocks.

Reference surface: ObKVGlobalCache (share/cache) — a tenant-aware cache
framework whose main users are the block cache (decoded micro blocks) and
row cache; eviction is by memory watermark.

The rebuild caches decoded column arrays keyed by (sstable uid, block,
column). Byte-accounted LRU; hit/miss stats surface through virtual
tables. One instance per Database (= tenant); storage readers take the
cache as an optional collaborator so unit tests can run cacheless.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


class KVCache:
    def __init__(self, capacity_bytes: int = 256 << 20):
        self.capacity_bytes = capacity_bytes
        self._map: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # optional residency hook (key -> priority, higher = keep
        # longer): eviction scans a bounded LRU-ordered window and takes
        # the coldest entry of the lowest priority tier, so the layout
        # advisor's hot tables survive memory pressure
        self.priority_of = None

    # bounded so a priority-heavy cache can't turn eviction into a full
    # scan; within the window the LRU-most entry of the lowest tier goes
    _EVICT_SCAN = 32

    def _evict_one(self) -> None:
        if self.priority_of is None:
            _, ev = self._map.popitem(last=False)
        else:
            best_k = best_p = None
            for i, k in enumerate(self._map):
                if i >= self._EVICT_SCAN:
                    break
                try:
                    p = float(self.priority_of(k))
                except Exception:  # noqa: BLE001 - advisory hook
                    p = 0.0
                if best_p is None or p < best_p:
                    best_k, best_p = k, p
                if p <= 0.0:
                    break  # default tier: nothing beats evicting it
            ev = self._map.pop(best_k)
        self._bytes -= int(ev.nbytes)
        self.evictions += 1

    def get(self, key: tuple):
        with self._lock:
            v = self._map.get(key)
            if v is None:
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key: tuple, value: np.ndarray) -> None:
        nbytes = int(value.nbytes)
        if nbytes > self.capacity_bytes:
            return  # larger than the whole budget: bypass
        with self._lock:
            old = self._map.pop(key, None)
            if old is not None:
                self._bytes -= int(old.nbytes)
            self._map[key] = value
            self._bytes += nbytes
            while self._bytes > self.capacity_bytes and self._map:
                self._evict_one()

    def set_capacity(self, capacity_bytes: int) -> None:
        with self._lock:
            self.capacity_bytes = capacity_bytes
            while self._bytes > self.capacity_bytes and self._map:
                self._evict_one()

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._map)
