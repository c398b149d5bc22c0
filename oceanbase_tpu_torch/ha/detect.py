"""Peer-death detection + orphaned-state GC.

Reference surface:
  * ObNetKeepAlive (deps/oblib/src/rpc/obrpc/ob_net_keepalive.h): every
    node pings its peers off the RPC path; a peer silent past the window
    is reported dead so RPC callers fail fast instead of timing out;
  * ObDetectManager (share/detect/ob_detect_manager.h): components
    register (peer, resource) pairs — PX tasks, DTL channels, tx contexts
    — and get a cleanup callback when the peer dies, GC'ing state that
    would otherwise leak forever.

The rebuild runs both over the deterministic LocalBus: keepalive ids live
in their own id space (KA_BASE + node) so they coexist with palf
replica handlers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

KA_BASE = 10_000_000


@dataclass
class _Ping:
    t: float


@dataclass
class _Pong:
    t: float


class NetKeepAlive:
    """One node's keepalive endpoint over the bus."""

    def __init__(self, bus, node: int, peers: list[int],
                 interval: float = 0.5, dead_after: float = 2.0):
        self.bus = bus
        self.node = node
        self.my_id = KA_BASE + node
        self.peer_ids = {p: KA_BASE + p for p in peers if p != node}
        self.interval = interval
        self.dead_after = dead_after
        self._last_heard: dict[int, float] = {p: bus.now for p in self.peer_ids}
        self._last_ping = -1e9
        bus.register(self.my_id, self._on_message)

    def _on_message(self, src: int, msg) -> None:
        if isinstance(msg, _Ping):
            self.bus.send(self.my_id, src, _Pong(msg.t))
        elif isinstance(msg, _Pong):
            self._last_heard[src - KA_BASE] = self.bus.now

    def tick(self) -> None:
        if self.bus.now - self._last_ping >= self.interval:
            self._last_ping = self.bus.now
            for pid in self.peer_ids.values():
                self.bus.send(self.my_id, pid, _Ping(self.bus.now))

    def is_dead(self, peer: int) -> bool:
        return (self.bus.now - self._last_heard.get(peer, -1e9)) > self.dead_after

    def dead_peers(self) -> set[int]:
        return {p for p in self.peer_ids if self.is_dead(p)}


class DetectManager:
    """Register distributed resources against the peer that owns their
    remote half; when keepalive declares the peer dead, run the cleanups."""

    def __init__(self, keepalive: NetKeepAlive):
        self.keepalive = keepalive
        self._resources: dict[int, dict[object, object]] = {}
        self.cleaned: list[tuple[int, object]] = []

    def register(self, peer: int, resource_id, cleanup) -> None:
        self._resources.setdefault(peer, {})[resource_id] = cleanup

    def unregister(self, peer: int, resource_id) -> None:
        self._resources.get(peer, {}).pop(resource_id, None)

    def tick(self) -> int:
        """GC resources of dead peers; returns cleanups run."""
        n = 0
        for peer in list(self._resources):
            if self.keepalive.is_dead(peer):
                for rid, cleanup in self._resources.pop(peer).items():
                    cleanup()
                    self.cleaned.append((peer, rid))
                    n += 1
        return n
