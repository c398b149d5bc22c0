"""LS leader location cache.

Reference surface: ObLocationService (share/location_cache/
ob_location_service.h:34) — a cache of LS/tablet -> server mappings,
refreshed by RPC on miss or on NOT_MASTER feedback, so statement routing
never blocks on consensus state.

The rebuild caches ls_id -> leader node with a TTL; `resolve` refreshes
through a pluggable resolver (LocalCluster.leader_node in-process; a real
RPC in multi-process deployments). NotMaster feedback calls `invalidate`.
"""

from __future__ import annotations

import threading
import time


class LocationService:
    def __init__(self, resolver, ttl: float = 10.0, clock=time.monotonic):
        self._resolver = resolver  # ls_id -> node (may block on election)
        self._ttl = ttl
        self._clock = clock
        self._cache: dict[int, tuple[int, float]] = {}
        self._lock = threading.RLock()
        self.refreshes = 0

    def leader(self, ls_id: int) -> int:
        now = self._clock()
        with self._lock:
            hit = self._cache.get(ls_id)
            if hit is not None and hit[1] > now:
                return hit[0]
        node = self._resolver(ls_id)
        with self._lock:
            self.refreshes += 1
            self._cache[ls_id] = (node, self._clock() + self._ttl)
        return node

    def invalidate(self, ls_id: int) -> None:
        """Drop a mapping (NOT_MASTER feedback / peer death)."""
        with self._lock:
            self._cache.pop(ls_id, None)

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
