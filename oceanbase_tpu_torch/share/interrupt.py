"""Global query interrupt: cluster-wide abort of a running statement.

Counterpart of `oceanbase_tpu/share/interrupt.py` (reference surface:
share/interrupt, ObGlobalInterruptManager, ob_global_interrupt_call.h:246).
Every node runs an InterruptManager; a statement registers an interrupt id
and polls its checker at its host-side checkpoints: between chunks of an
out-of-core run, between overflow retries, between DML qualification and
staging. interrupt() reaches every node through the cluster bus, so a
coordinator can kill work running anywhere (KILL QUERY <session>). A
checker made without a manager (an engine used directly) is fired through
its own `interrupt()`.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .retry import checkpoint_deadline


class QueryInterrupted(Exception):
    """Raised at a statement checkpoint after an interrupt arrived."""


class InterruptChecker:
    """One statement's interrupt flag: held in its manager's fired map
    when registered there, else in the checker itself."""

    __slots__ = ("interrupt_id", "_mgr", "_reason")

    def __init__(self, interrupt_id=None, mgr: "InterruptManager" = None):
        self.interrupt_id = interrupt_id
        self._mgr = mgr
        self._reason = None

    def interrupt(self, reason: str = "killed") -> None:
        if self._mgr is not None:
            self._mgr._fire(self.interrupt_id, reason)
        else:
            self._reason = reason

    @property
    def is_set(self) -> bool:
        if self._mgr is not None:
            return self.interrupt_id in self._mgr._fired
        return self._reason is not None

    @property
    def reason(self) -> str:
        if self._mgr is not None:
            return self._mgr._fired.get(self.interrupt_id, "")
        return self._reason or ""

    def check(self) -> None:
        if self.is_set:
            raise QueryInterrupted(
                f"query {self.interrupt_id} interrupted: {self.reason}"
            )


@dataclass
class InterruptManager:
    """Per-node registry of live interrupt ids (one per running statement).

    Cluster propagation: `attach_bus` registers a handler at a dedicated
    bus address; interrupt() sends to every peer manager so checkers fire
    on whichever node hosts the work."""

    node_id: int = 0
    _live: set = field(default_factory=set)
    _fired: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _bus: object = None
    _peer_addrs: list = field(default_factory=list)
    _addr: int | None = None

    def register(self, interrupt_id: tuple) -> InterruptChecker:
        # set.add / dict.pop are atomic under the GIL, and interrupt ids
        # carry a per-statement sequence number (never reused), so there
        # is no stale state that needs clearing atomically — the serving
        # hot path registers and unregisters lock-free.
        self._live.add(interrupt_id)
        self._fired.pop(interrupt_id, None)
        return InterruptChecker(interrupt_id, self)

    def unregister(self, interrupt_id: tuple) -> None:
        self._live.discard(interrupt_id)
        self._fired.pop(interrupt_id, None)

    def interrupt(self, interrupt_id: tuple, reason: str = "killed") -> None:
        """Fire locally and broadcast to every peer node."""
        self._fire(interrupt_id, reason)
        if self._bus is not None:
            for addr in self._peer_addrs:
                if addr != self._addr:
                    self._bus.send(
                        self._addr, addr, ("interrupt", interrupt_id, reason)
                    )

    def _fire(self, interrupt_id: tuple, reason: str) -> None:
        with self._lock:
            self._fired[interrupt_id] = reason

    # ------------------------------------------------------- cluster wire
    def attach_bus(self, bus, addr: int, peer_addrs: list[int]) -> None:
        self._bus = bus
        self._addr = addr
        self._peer_addrs = list(peer_addrs)
        bus.register(addr, self._on_message)

    def _on_message(self, _src: int, msg) -> None:
        if isinstance(msg, tuple) and msg and msg[0] == "interrupt":
            self._fire(msg[1], msg[2])


# ------------------------------------------------- per-statement plumbing
_tls = threading.local()


def set_current(checker: InterruptChecker | None):
    """Install the running statement's checker for this thread; returns
    the previous one (restore in a finally)."""
    prev = getattr(_tls, "checker", None)
    _tls.checker = checker
    return prev


def current_checker() -> InterruptChecker | None:
    return getattr(_tls, "checker", None)


def checkpoint() -> None:
    """Host-side interrupt checkpoint: raises QueryInterrupted if the
    current statement was killed, or a StatementTimeout if its deadline
    (SET ob_query_timeout / ob_trx_timeout) expired. Engines call this
    between device programs (chunks, retries, staging batches)."""
    c = current_checker()
    if c is not None:
        c.check()
    checkpoint_deadline()


# address space for interrupt managers on the LocalBus (disjoint from
# palf replica addresses, which are small ls-base + node numbers)
INTERRUPT_ADDR_BASE = 900_000


def attach_cluster_interrupts(cluster) -> dict[int, InterruptManager]:
    """One InterruptManager per node, wired through the cluster bus."""
    addrs = [INTERRUPT_ADDR_BASE + n for n in range(cluster.n_nodes)]
    managers = {}
    for n in range(cluster.n_nodes):
        m = InterruptManager(node_id=n)
        m.attach_bus(cluster.bus, addrs[n], addrs)
        managers[n] = m
    return managers
