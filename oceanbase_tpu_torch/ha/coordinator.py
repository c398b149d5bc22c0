"""Failure detection feeding leadership placement.

Reference surface: logservice/leader_coordinator — ObFailureDetector
(ob_failure_detector.h:48) aggregates local health events (clog disk hang,
schema refresh stuck, RS connectivity) and feeds the election priority so
a sick node's leaders demote to healthy replicas within a lease window.

The rebuild keeps the two halves:
  * FailureDetector: named health checks per node; any failing check makes
    the node unhealthy (events mirror the reference's FailureEvent list);
  * LeaderCoordinator: watches every LS whose leader sits on an unhealthy
    node and hands leadership to a healthy replica via the palf
    TimeoutNow handshake (the election-priority demotion analog).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class FailureDetector:
    """Per-node aggregate of named health checks (True = healthy)."""

    def __init__(self):
        self._checks: dict[str, object] = {}

    def register(self, name: str, check) -> None:
        self._checks[name] = check

    def failing(self) -> list[str]:
        return [n for n, c in self._checks.items() if not c()]

    @property
    def healthy(self) -> bool:
        return not self.failing()


@dataclass
class LeaderCoordinator:
    """Moves leadership off unhealthy nodes.

    ls_groups: {ls_id: {node: LSReplica}}; detectors: {node:
    FailureDetector}. tick() starts at most one transfer per LS per call
    (transfers complete asynchronously through the consensus messages)."""

    ls_groups: dict
    detectors: dict[int, FailureDetector]
    transfers_started: int = 0
    _inflight: set = field(default_factory=set)

    def tick(self) -> int:
        started = 0
        for ls_id, group in self.ls_groups.items():
            leader_node = None
            for node, rep in group.items():
                if rep.is_leader:
                    leader_node = node
                    break
            if leader_node is None:
                self._inflight.discard(ls_id)
                continue
            det = self.detectors.get(leader_node)
            if det is None or det.healthy:
                self._inflight.discard(ls_id)
                continue
            if ls_id in self._inflight:
                continue  # handshake already underway
            target = next(
                (n for n, r in sorted(group.items())
                 if n != leader_node
                 and self.detectors.get(n) is not None
                 and self.detectors[n].healthy),
                None,
            )
            if target is None:
                continue  # nowhere healthy to go
            # transfer_leader returns False while the target is still
            # catching up (it sent a catch-up append, not TimeoutNow) —
            # keep retrying on later ticks rather than marking inflight
            if group[leader_node].palf.transfer_leader(
                group[target].palf.node_id
            ):
                self._inflight.add(ls_id)
                self.transfers_started += 1
                started += 1
        return started
