"""Replica rebuild: replace a dead/wrecked replica from a leader snapshot.

Reference surface: storage/high_availability — ObLSMigrationHandler
(ob_ls_migration_handler.h:88) and ObStorageHAService (ob_storage_ha_service.h:27)
rebuild/migrate replicas by copying a macro-block snapshot from a source
replica and then catching up through the log; the rootserver's disaster
recovery tasks trigger them when a replica is permanently gone.

The rebuild's analog: a dead (ls, node) replica is replaced in place —
same consensus address, so no membership change — by

  1. a consistent storage snapshot cut from the current READY leader
     (tablets + tx table + pending 2PC redo at its applied LSN; refused
     while the leader holds locally-staged uncommitted rows, exactly like
     the checkpointer);
  2. a fresh palf replica whose log starts EMPTY at base = covered+1 with
     the base-predecessor term recorded, so ordinary log replication
     back-fills everything after the snapshot (the "copy then catch up"
     shape of the reference's migration);
  3. swapping the replica into the LS group and the node's TransService.

RebuildService watches the failure detectors and triggers rebuilds for
nodes reported dead — the disaster-recovery-task analog.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

from ..log.palf import LogView, PalfReplica
from ..tx.ls import LSReplica


class RebuildError(Exception):
    pass


def snapshot_source(leader: LSReplica) -> dict:
    """Deep-copied storage snapshot of a READY source replica."""
    if leader._locally_staged:
        raise RebuildError(
            "source leader has in-flight staged txs; retry after they end"
        )
    state = {
        "applied_lsn": leader.palf.applied_lsn,
        "tablets": leader.tablets,
        "tx_table": dict(leader.tx_table),
        "pending_redo": dict(leader._pending_redo),
    }
    return pickle.loads(pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL))


def rebuild_replica(cluster, ls_id: int, node: int,
                    data_dir: str | None = None, fsync: bool = True) -> LSReplica:
    """Rebuild the (ls, node) replica from the group's ready leader."""
    group = cluster.ls_groups[ls_id]
    old = group[node]
    addr = old.palf.node_id
    peers = list(old.palf.peers)
    leader = next(
        (r for n2, r in group.items() if n2 != node and r.is_ready), None
    )
    if leader is None:
        raise RebuildError(f"ls {ls_id}: no ready leader to copy from")
    state = snapshot_source(leader)
    covered = state["applied_lsn"]
    if covered >= leader.palf.log.base:
        prev_term = leader.palf.log[covered].term
    else:
        prev_term = leader.palf.log.base_prev_term

    # the address returns to service with a brand-new identity
    cluster.bus.revive(addr)
    store = None
    if data_dir is not None:
        import os
        import shutil

        from ..log.store import LogStore

        root = os.path.join(data_dir, f"n{node}", f"ls_{ls_id}")
        shutil.rmtree(root, ignore_errors=True)
        store = LogStore(root, fsync=fsync)
        store.set_base_info(covered, prev_term)
    palf = PalfReplica(addr, peers, cluster.bus, store=store)
    palf.log = LogView(covered + 1, [], prev_term)
    palf.commit_lsn = covered
    palf.applied_lsn = covered

    rep = LSReplica(ls_id, node, palf)
    rep.tablets = state["tablets"]
    rep.tx_table = dict(state["tx_table"])
    rep._pending_redo = dict(state["pending_redo"])
    rep.on_record = old.on_record
    rep.on_tx_applied = old.on_tx_applied

    group[node] = rep
    svc = cluster.services.get(node)
    if svc is not None:
        svc.replicas[ls_id] = rep
    return rep


@dataclass
class RebuildService:
    """Disaster-recovery task runner: rebuilds every LS replica of nodes
    their failure detectors report dead (rootserver DR-task analog)."""

    cluster: object
    detectors: dict[int, object]  # node -> ha.FailureDetector
    data_dir: str | None = None
    fsync: bool = True
    rebuilds: int = 0
    on_rebuilt: object = None  # callback(ls_id, node, replica)

    def tick(self) -> int:
        done = 0
        for node, det in self.detectors.items():
            if det.healthy:
                continue
            for ls_id, group in self.cluster.ls_groups.items():
                rep = group[node]
                # "dead" = its consensus address is disconnected
                if rep.palf.node_id not in self.cluster.bus._down:
                    continue
                try:
                    new_rep = rebuild_replica(
                        self.cluster, ls_id, node,
                        data_dir=self.data_dir, fsync=self.fsync,
                    )
                except RebuildError:
                    continue  # no ready source yet; retry next tick
                self.rebuilds += 1
                done += 1
                if self.on_rebuilt is not None:
                    self.on_rebuilt(ls_id, node, new_rep)
        return done
