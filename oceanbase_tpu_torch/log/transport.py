"""Message transport for replication: in-process bus with fault injection.

Reference surface: the RPC plane PALF rides on — obrpc typed async proxies
(deps/oblib/src/rpc/obrpc) and LogNetService push/ack/fetch
(logservice/palf/log_net_service.h:38) — and the ERRSIM tracepoint style of
fault injection (deps/oblib/src/lib/utility/ob_tracepoint_def.h).

The rebuild separates the consensus state machine from time and wires: the
LocalBus delivers messages between in-process replicas under an explicit
virtual clock, with programmable drop/delay/partition faults. This makes the
3-replica tests deterministic (no sleeps, no flakes) — the same pattern the
reference gets from forking three observers (mittest/multi_replica) but
simulable. A TCP transport with the same interface slots in for real
multi-process deployment (cluster services layer).
"""

from __future__ import annotations

import random
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Envelope:
    src: int
    dst: int
    msg: Any
    deliver_at: float
    # full-link trace context: (trace_id, parent_span_id) of the statement
    # that caused this message, or None for autonomous traffic (ticks,
    # elections). Carried across hops so replica-side work lands in the
    # originating statement's span tree (ObTrace's flt_trace_id analog).
    trace_ctx: Any = None


@dataclass
class LocalBus:
    """Deterministic in-process message bus with a virtual clock."""

    now: float = 0.0
    latency: float = 0.001
    drop_prob: float = 0.0
    seed: int = 0
    _queue: list[Envelope] = field(default_factory=list)
    _handlers: dict[int, Callable[[int, Any], None]] = field(default_factory=dict)
    _partitions: set[frozenset] = field(default_factory=set)
    _down: set[int] = field(default_factory=set)
    _rng: random.Random = None  # type: ignore[assignment]
    # tenant metrics registry (share/metrics.MetricsRegistry); when wired,
    # sent/dropped/delivered surface in __all_virtual_sysstat as
    # "rpc packets ..." instead of living only in the private dict below
    metrics: Any = None
    # tenant tracer (server/diag.Tracer); when wired, send() stamps each
    # envelope with the sender's current trace context and advance() makes
    # it visible to handlers via delivery_ctx(), so replies sent while
    # handling a delivery inherit the originating statement's trace
    tracer: Any = None
    stats: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _delivery_ctx: Any = field(default=None, repr=False)
    # serializes clock advancement and queue mutation: multiple serving
    # sessions retry statements concurrently and each retry path may drive
    # the cluster (settle/leader_node). Reentrant because handlers called
    # under advance() send replies through the same bus.
    drive_lock: threading.RLock = field(
        default_factory=threading.RLock, repr=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def delivery_ctx(self) -> Any:
        """Trace context of the envelope currently being delivered (only
        meaningful inside a handler called from advance())."""
        return self._delivery_ctx

    def _current_ctx(self) -> Any:
        if self.tracer is not None:
            ctx = self.tracer.current_ctx()
            if ctx is not None:
                return ctx
        return self._delivery_ctx

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        if self.metrics is not None:
            self.metrics.add(f"rpc packets {key}", n)

    def register(self, node_id: int, handler: Callable[[int, Any], None]) -> None:
        self._handlers[node_id] = handler

    # ------------------------------------------------------------ faults
    def partition(self, group_a: set[int], group_b: set[int]) -> None:
        for a in group_a:
            for b in group_b:
                self._partitions.add(frozenset((a, b)))

    def heal(self) -> None:
        self._partitions.clear()

    def kill(self, node_id: int) -> None:
        self._down.add(node_id)

    def revive(self, node_id: int) -> None:
        self._down.discard(node_id)

    def _blocked(self, a: int, b: int) -> bool:
        return (
            a in self._down
            or b in self._down
            or frozenset((a, b)) in self._partitions
        )

    # ---------------------------------------------------------- delivery
    def send(self, src: int, dst: int, msg: Any) -> None:
        with self.drive_lock:
            self._bump("sent")
            if self._blocked(src, dst):
                self._bump("dropped")
                return
            if self.drop_prob and self._rng.random() < self.drop_prob:
                self._bump("dropped")
                return
            self._queue.append(
                Envelope(src, dst, msg, self.now + self.latency,
                         trace_ctx=self._current_ctx())
            )

    def advance(self, dt: float) -> int:
        """Advance virtual time, delivering everything due. Returns count."""
        with self.drive_lock:
            self.now += dt
            delivered = 0
            while True:
                due = [e for e in self._queue if e.deliver_at <= self.now]
                if not due:
                    break
                self._queue = [
                    e for e in self._queue if e.deliver_at > self.now
                ]
                due.sort(key=lambda e: e.deliver_at)
                for e in due:
                    if self._blocked(e.src, e.dst):
                        self._bump("dropped")
                        continue
                    h = self._handlers.get(e.dst)
                    if h is not None:
                        self._delivery_ctx = e.trace_ctx
                        try:
                            h(e.src, e.msg)
                        finally:
                            self._delivery_ctx = None
                        delivered += 1
            self._bump("delivered", delivered)
            return delivered
