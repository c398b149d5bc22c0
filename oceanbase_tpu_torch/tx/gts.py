"""Global timestamp service (GTS).

Reference surface: storage/tx ObTsMgr (ob_ts_mgr.h:358) + ObGtsSource
(ob_gts_source.h:69) — one timestamp authority per tenant serving strictly
increasing commit/read timestamps over RPC, with local caching. The rebuild
keeps one authority per tenant; timestamps are hybrid (wall-clock µs
max'd with a counter) so they are monotonic under clock skew and still
roughly wall-ordered. A `clock` callable injects virtual time in tests.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class GtsService:
    """The per-tenant timestamp authority (lives with the tenant's LS1 leader)."""

    clock: Callable[[], float] = time.time
    _last: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)
    # Serializes commit-version fetch + log submit (tx/txn.py holds it
    # around both). With the fetch and the append atomic, commit versions
    # appear in each LS log in nondecreasing order, so an applied entry's
    # scn = max(prev_scn+1, commit_version) dominates the commit version
    # of EVERY earlier decisive record — the invariant that makes a
    # replica's applied scn a sound follower-read watermark.
    submit_lock: threading.RLock = field(default_factory=threading.RLock)

    def next_ts(self) -> int:
        """Strictly increasing timestamp (µs domain)."""
        wall = int(self.clock() * 1_000_000)
        with self._lock:
            self._last = max(self._last + 1, wall)
            return self._last

    def current(self) -> int:
        """A read snapshot: >= every previously issued ts. Does NOT burn a
        sequence slot (ObTsMgr serves reads from its local cache the same
        way, ob_ts_mgr.h:358): the last issued ts already dominates every
        committed commit version, which is all a snapshot needs."""
        with self._lock:
            return self._last

    def advance_to(self, ts: int) -> None:
        """Fast-forward past restored/replayed history so new timestamps
        never collide below it (restore-time invariant)."""
        with self._lock:
            self._last = max(self._last, ts)
