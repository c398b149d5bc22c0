"""LocalCluster: an in-process multi-replica cluster harness.

Reference surface: the reference's test env pyramid (SURVEY.md §4) — mittest
MockTenantModuleEnv (tier 2) and the 3-zone forked cluster (tier 4,
mittest/multi_replica). The rebuild gets both from one harness: N "nodes"
(replica sets) share a virtual-clock LocalBus; each LS replicates across all
nodes; a TransService per node. `drive_until` pumps ticks + delivery, so
tests and single-process deployments (the SQL engine's DML path) run the
full consensus + tx stack deterministically with zero threads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.dtypes import Schema
from ..ha.detect import KA_BASE, NetKeepAlive
from ..log import LocalBus, leader_of, run_until
from .gts import GtsService
from .ls import LSReplica, make_ls_group
from .txn import TransService, TxContext


@dataclass
class LocalCluster:
    n_nodes: int = 3
    bus: LocalBus = None  # type: ignore[assignment]
    gts: GtsService = None  # type: ignore[assignment]
    ls_groups: dict[int, dict[int, LSReplica]] = field(default_factory=dict)
    services: dict[int, TransService] = field(default_factory=dict)
    # durable mode: palf logs live under {data_dir}/n{node}/ls_{ls}
    data_dir: str | None = None
    fsync: bool = True
    # multi-tenant record observation: when several tenants share this
    # cluster, each registers here and a dispatcher fans records out
    # (each observer ignores tablets it does not own)
    record_observers: list = field(default_factory=list)
    # per-node keepalive endpoints (ha/detect.NetKeepAlive) riding the
    # drive loop; dead-peer evidence feeds the ls-replica virtual table,
    # the health sentinel and rootserver rebalancing
    keepalives: dict[int, NetKeepAlive] = field(default_factory=dict)
    _next_ls_base: int = 0

    def __post_init__(self):
        if self.bus is None:
            self.bus = LocalBus()
        if self.gts is None:
            # GTS rides the virtual clock so timestamps are deterministic
            self.gts = GtsService(clock=lambda: self.bus.now)

    # ------------------------------------------------------------- build
    def create_ls(self, ls_id: int) -> dict[int, LSReplica]:
        group = make_ls_group(
            ls_id, list(range(self.n_nodes)), self.bus,
            palf_id_base=self._next_ls_base,
            data_dir=self.data_dir, fsync=self.fsync,
        )
        self._next_ls_base += 1000
        self.ls_groups[ls_id] = group
        return group

    def create_tablet(self, ls_id: int, tablet_id: int, schema: Schema,
                      key_cols: list[str]) -> None:
        for rep in self.ls_groups[ls_id].values():
            rep.create_tablet(tablet_id, schema, key_cols)

    def finalize(self) -> None:
        """Build per-node TransServices and elect initial leaders."""
        nodes = list(range(self.n_nodes))
        for n in nodes:
            self.services[n] = TransService(
                n, self.gts, {ls: g[n] for ls, g in self.ls_groups.items()}
            )
            if n not in self.keepalives:
                self.keepalives[n] = NetKeepAlive(self.bus, n, nodes)
        self.elect_all()

    def add_node(self, node: int) -> None:
        """Join an empty node (no replicas yet); the balance loop
        (ha/migrate.balance_cluster) migrates replicas onto it."""
        if node in self.services:
            raise ValueError(f"node {node} already exists")
        self.services[node] = TransService(node, self.gts, {})
        self.n_nodes = max(self.n_nodes, node + 1)

    # ------------------------------------------------------------- drive
    def _palfs(self):
        return [r.palf for g in self.ls_groups.values() for r in g.values()]

    def _tickables(self):
        # keepalives share the palf drive loop: run_until only needs .tick()
        return self._palfs() + list(self.keepalives.values())

    def drive_until(self, cond, max_time: float = 30.0) -> bool:
        return run_until(self.bus, self._tickables(), cond, max_time=max_time)

    def settle(self, t: float = 1.0) -> None:
        self.drive_until(lambda: False, max_time=t)

    def elect_all(self) -> None:
        for ls_id, group in self.ls_groups.items():
            ok = self.drive_until(
                lambda g=group: any(r.is_ready for r in g.values())
            )
            if not ok:
                raise RuntimeError(f"ls {ls_id}: no ready leader elected")

    # ----------------------------------------------------------- routing
    def leader_node(self, ls_id: int, max_time: float = 15.0) -> int:
        """Node of the ls's READY leader, driving the clock until one exists
        (a fresh leader needs its no-op committed + replay caught up)."""
        group = self.ls_groups[ls_id]
        ok = self.drive_until(
            lambda: any(r.is_ready for r in group.values()), max_time=max_time
        )
        if not ok:
            raise RuntimeError(f"ls {ls_id}: no ready leader")
        for node, rep in group.items():
            if rep.is_ready:
                return node
        raise AssertionError

    def kill_node(self, node: int, settle: float = 1.0) -> None:
        """Disconnect a node and advance time past the lease window so its
        leader replicas notice and step down (a killed process's clients see
        silence; the virtual-clock analog needs the clock to move)."""
        for group in self.ls_groups.values():
            self.bus.kill(group[node].palf.node_id)
        if node in self.keepalives:
            self.bus.kill(KA_BASE + node)
        self.settle(settle)

    def revive_node(self, node: int, settle: float = 1.0) -> None:
        """Reconnect a killed node's replicas + keepalive endpoint and let
        the cluster settle so they catch up (rolling-restart recovery)."""
        for group in self.ls_groups.values():
            self.bus.revive(group[node].palf.node_id)
            # rejoin grace: wait a lease window for the incumbent's
            # heartbeat instead of campaigning off the stale timer and
            # deposing a healthy leader (restart disruption)
            group[node].palf.reset_election_timer()
        if node in self.keepalives:
            self.bus.revive(KA_BASE + node)
        self.settle(settle)

    def unreachable_nodes(self) -> set[int]:
        """Majority keepalive vote: node d is unreachable when more than
        half of the OTHER nodes' keepalives have lost it (a one-link
        partition never indicts a node; a kill always does)."""
        out: set[int] = set()
        for d in self.keepalives:
            observers = [ka for n, ka in self.keepalives.items() if n != d]
            if not observers:
                continue
            votes = sum(1 for ka in observers if ka.is_dead(d))
            if votes >= len(observers) // 2 + 1:
                out.add(d)
        return out

    def transfer_leader(self, ls_id: int, target_node: int,
                        max_time: float = 10.0) -> None:
        """Move ls leadership to target_node (palf TimeoutNow handshake)."""
        group = self.ls_groups[ls_id]
        target_addr = group[target_node].palf.node_id

        def try_transfer():
            lead = leader_of([r.palf for r in group.values()])
            if lead is not None and lead.node_id == target_addr:
                return True
            if lead is not None:
                lead.transfer_leader(target_addr)
            return False

        if not run_until(self.bus, self._tickables(), try_transfer, max_time=max_time):
            raise TimeoutError(f"ls {ls_id}: leader transfer to node {target_node} failed")

    def service_for(self, *ls_ids: int) -> TransService:
        """A TransService on a node leading ALL given LS.

        A multi-LS transaction needs its coordinator on a node leading every
        participant (the rebuild's TransService talks only to local
        replicas); co-locate by transferring leadership to the first LS's
        leader node — the analog of the reference routing a query to a
        server hosting the participant leaders.
        """
        home = self.leader_node(ls_ids[0])
        for ls in ls_ids[1:]:
            if self.leader_node(ls) != home:
                self.transfer_leader(ls, home)
        return self.services[home]

    # ------------------------------------------------------- tx shortcuts
    def commit_sync(self, svc: TransService, ctx: TxContext,
                    max_time: float = 30.0) -> None:
        svc.commit(ctx)

        def done() -> bool:
            svc.retry_decisions(ctx)
            return ctx.is_done

        if not self.drive_until(done, max_time=max_time):
            raise TimeoutError(f"tx {ctx.tx_id} did not finish")
