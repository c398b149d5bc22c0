"""Table locks + deadlock detection.

Reference surface: storage/tablelock (table/partition lock objects taken
inside transactions, released at tx end) and share/deadlock — the LCL
(lock-chain-length) distributed deadlock detection that finds wait cycles
and kills one participant.

Rebuild semantics: S/X locks on arbitrary lock ids (table tablet ids), one
outstanding wait per tx. `lock()` either grants, or registers the wait
edge and raises WouldBlock so the caller retries after the holder ends —
the deterministic analog of queueing on the lock-wait manager. Before
raising WouldBlock the manager walks the wait-for graph; a cycle aborts
the REQUESTER with DeadlockDetected (the youngest-tx victim policy: the
cycle closer is by construction the newest edge)."""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field


class LockMode(enum.IntEnum):
    ROW_X = 0  # intention-exclusive: taken implicitly by DML
    SHARE = 1  # LOCK TABLE ... IN SHARE MODE (blocks writes)
    EXCLUSIVE = 2  # LOCK TABLE ... IN EXCLUSIVE MODE (blocks everything)


# requested-vs-held compatibility (symmetric): IX+IX coexist (row conflicts
# are the memtable's job); S+S coexist; X conflicts with all
_COMPAT = {
    (LockMode.ROW_X, LockMode.ROW_X): True,
    (LockMode.SHARE, LockMode.SHARE): True,
}


class WouldBlock(Exception):
    """Lock held in a conflicting mode; retry after the holder finishes."""


class DeadlockDetected(Exception):
    """Granting this wait would close a wait-for cycle; abort the tx."""


@dataclass
class LockManager:
    # lock_id -> {tx_id: set of granted base modes}. A tx may hold several
    # base modes at once (SHARE + ROW_X == the SIX combination); keeping the
    # set — instead of one "max" enum — means upgrades are checked against
    # other holders per base mode, never granted by enum comparison.
    _granted: dict[object, dict[int, set[LockMode]]] = field(default_factory=dict)
    # tx_id -> (lock_id, mode) one outstanding wait
    _waiting: dict[int, tuple[object, LockMode]] = field(default_factory=dict)
    _lock: threading.RLock = field(default_factory=threading.RLock)
    # txs killed by the distributed detector (share/deadlock): surfaced as
    # DeadlockDetected on the victim's next lock() retry
    _aborted: set[int] = field(default_factory=set)
    # tx -> wait instance counter, bumped on each (re)registered wait:
    # lets the distributed detector drop probes from superseded waits
    # (the classic CMH phantom-cycle hazard)
    _wait_seq: dict[int, int] = field(default_factory=dict)
    deadlocks: int = 0

    @staticmethod
    def _compatible(a: LockMode, b: LockMode) -> bool:
        return _COMPAT.get((a, b), False)

    def _conflicting_holders(self, tx_id: int, lock_id, mode) -> set[int]:
        return {
            t for t, ms in self._granted.get(lock_id, {}).items()
            if t != tx_id and any(not self._compatible(mode, m) for m in ms)
        }

    def _wait_edges(self, tx_id: int) -> set[int]:
        """Who tx_id waits for (via its registered wait)."""
        w = self._waiting.get(tx_id)
        if w is None:
            return set()
        return self._conflicting_holders(tx_id, w[0], w[1])

    def _would_deadlock(self, start_tx: int) -> bool:
        """DFS over the wait-for graph from start_tx back to itself."""
        seen = set()
        stack = list(self._wait_edges(start_tx))
        while stack:
            t = stack.pop()
            if t == start_tx:
                return True
            if t in seen:
                continue
            seen.add(t)
            stack.extend(self._wait_edges(t))
        return False

    # ---------------------------------------- distributed-detector hooks
    def waiting_snapshot(self) -> dict[int, set[int]]:
        """tx -> conflicting holder txs, for every locally-waiting tx."""
        with self._lock:
            return {t: self._wait_edges(t) for t in list(self._waiting)}

    def wait_edges_of(self, tx_id: int) -> set[int]:
        with self._lock:
            return self._wait_edges(tx_id)

    def hosts_wait(self, tx_id: int) -> bool:
        with self._lock:
            return tx_id in self._waiting

    def wait_token(self, tx_id: int) -> int | None:
        """Current wait-instance token of a waiting tx (None = not
        waiting). A probe stamped with an older token chased a wait
        that no longer exists and must not abort anyone."""
        with self._lock:
            if tx_id not in self._waiting:
                return None
            return self._wait_seq.get(tx_id, 0)

    def abort(self, tx_id: int) -> None:
        """Mark a tx as a deadlock victim (distributed detector verdict);
        its next lock() retry raises DeadlockDetected."""
        with self._lock:
            self.deadlocks += 1
            self._aborted.add(tx_id)
            self._waiting.pop(tx_id, None)

    # -------------------------------------------------------------- API
    def lock(self, tx_id: int, lock_id, mode: LockMode) -> None:
        """Grant, or raise WouldBlock/DeadlockDetected."""
        with self._lock:
            if tx_id in self._aborted:
                self._aborted.discard(tx_id)
                raise DeadlockDetected(
                    f"tx {tx_id} chosen as distributed deadlock victim"
                )
            holders = self._granted.setdefault(lock_id, {})
            held = holders.get(tx_id, set())
            if mode in held or LockMode.EXCLUSIVE in held:
                return  # this exact strength (or a superset) already granted
            conflicts = self._conflicting_holders(tx_id, lock_id, mode)
            if not conflicts:
                holders.setdefault(tx_id, set()).add(mode)
                self._waiting.pop(tx_id, None)
                return
            if self._waiting.get(tx_id) != (lock_id, mode):
                self._wait_seq[tx_id] = self._wait_seq.get(tx_id, 0) + 1
            self._waiting[tx_id] = (lock_id, mode)
            if self._would_deadlock(tx_id):
                self.deadlocks += 1
                self._waiting.pop(tx_id, None)
                raise DeadlockDetected(
                    f"tx {tx_id} waiting on {lock_id} closes a cycle"
                )
            raise WouldBlock(
                f"lock {lock_id} held by {sorted(conflicts)}"
            )

    def release_all(self, tx_id: int) -> None:
        with self._lock:
            self._waiting.pop(tx_id, None)
            self._aborted.discard(tx_id)
            for lock_id in [
                k for k, hs in self._granted.items() if tx_id in hs
            ]:
                hs = self._granted[lock_id]
                del hs[tx_id]
                if not hs:
                    del self._granted[lock_id]

    def holders(self, lock_id) -> dict[int, LockMode]:
        """Strongest base mode per holder (display/assert surface)."""
        with self._lock:
            return {
                t: max(ms) for t, ms in self._granted.get(lock_id, {}).items()
            }
