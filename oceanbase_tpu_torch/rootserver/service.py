"""RootService-lite: bootstrap, DDL orchestration, placement.

Reference surface: src/rootserver — cluster bootstrap (ob_bootstrap.cpp),
the DDL service through which every schema change flows
(ob_ddl_service.h:99), and load balancing (rootserver/balance). The
rebuild's RootService owns:

  * bootstrap: create the log streams and elect initial leaders;
  * DDL: allocate tablet ids, create tablets on every replica, publish the
    new schema through the multi-version SchemaService;
  * placement: least-loaded-LS choice for new tablets + a balance report
    (the decision side of the reference's balance groups; replica movement
    itself is the HA layer's job).
"""

from __future__ import annotations

import threading

from ..share.schema_service import SchemaError, SchemaService
from ..tx.cluster import LocalCluster


def plan_leader_moves(leader_map: dict[int, int],
                      replica_nodes: dict[int, list[int]],
                      alive: set[int],
                      spread: bool = False) -> list[tuple[int, int, int]]:
    """Pure leader-placement decision (the decision side of the
    reference's rootserver/balance leader coordinator). Returns
    [(ls_id, from_node, to_node)] such that applying every move leaves:

      * no LS led by a node outside `alive` (evacuation — FailureDetector
        evidence says the node is dead, don't wait for its lease to buy
        every client a NotMaster round-trip);
      * when `spread` (QoS ledger shows serving pressure), leader counts
        across alive nodes differing by at most 1 (each alive node's
        worker pool carries its fair share of the strong-read load).

    Deterministic: ties break toward the lowest node id, LS are visited
    in id order — same inputs, same plan, replayable from a bench log.
    """
    moves: list[tuple[int, int, int]] = []
    counts = {n: 0 for n in sorted(alive)}
    for _ls, n in leader_map.items():
        if n in counts:
            counts[n] += 1
    if not counts:
        return moves

    def least_loaded(cands: list[int]) -> int | None:
        live = [c for c in cands if c in counts]
        return min(live, key=lambda c: (counts[c], c)) if live else None

    # 1. evacuation: any LS led by a dead node moves to the least-loaded
    #    alive replica holder
    for ls_id in sorted(leader_map):
        frm = leader_map[ls_id]
        if frm in alive:
            continue
        to = least_loaded(replica_nodes.get(ls_id, []))
        if to is None:
            continue
        moves.append((ls_id, frm, to))
        counts[to] += 1

    # 2. spread under pressure: peel leaders off the most-loaded node
    #    while the imbalance is observable (diff >= 2)
    if spread:
        placed = {ls: to for ls, _f, to in moves}
        lead_at = {ls: placed.get(ls, n) for ls, n in leader_map.items()}
        while True:
            hi = max(counts, key=lambda c: (counts[c], -c))
            lo = min(counts, key=lambda c: (counts[c], c))
            if counts[hi] - counts[lo] < 2:
                break
            cand = next(
                (ls for ls in sorted(lead_at)
                 if lead_at[ls] == hi and ls not in placed
                 and lo in replica_nodes.get(ls, [])),
                None)
            if cand is None:
                break
            moves.append((cand, hi, lo))
            placed[cand] = lo
            lead_at[cand] = lo
            counts[hi] -= 1
            counts[lo] += 1
    return moves


class RootService:
    def __init__(self, cluster: LocalCluster, schema: SchemaService):
        self.cluster = cluster
        self.schema = schema
        self.next_tablet_id = 200001  # plain int: restorable across restarts
        self._lock = threading.RLock()

    def _alloc_tablet_id(self) -> int:
        with self._lock:
            v = self.next_tablet_id
            self.next_tablet_id += 1
            return v

    # ---------------------------------------------------------- bootstrap
    @staticmethod
    def bootstrap(n_nodes: int, n_ls: int, data_dir: str | None = None,
                  fsync: bool = True,
                  finalize: bool = True) -> tuple[LocalCluster, "RootService"]:
        """Build the cluster. finalize=False defers TransService creation +
        initial election: a restarting node must recreate tablets and load
        storage checkpoints BEFORE commit/replay can run (the reference's
        staged ObServer::init ordering — storage before log service start,
        ob_server.cpp:232/923)."""
        cluster = LocalCluster(n_nodes=n_nodes, data_dir=data_dir, fsync=fsync)
        for ls in range(1, n_ls + 1):
            cluster.create_ls(ls)
        if finalize:
            cluster.finalize()
        return cluster, RootService(cluster, SchemaService())

    # ---------------------------------------------------------- placement
    def tablet_counts(self) -> dict[int, int]:
        """Tablets per LS (from any replica; groups are symmetric)."""
        out = {}
        for ls_id, group in self.cluster.ls_groups.items():
            rep = next(iter(group.values()))
            out[ls_id] = len(rep.tablets)
        return out

    def choose_ls(self) -> int:
        counts = self.tablet_counts()
        return min(sorted(counts), key=lambda ls: counts[ls])

    # ------------------------------------------------------ leader balance
    def leader_map(self) -> dict[int, int]:
        """ls_id -> node currently holding palf leadership. LS mid-election
        (no leader) are omitted — there is nothing to move yet and the
        election will place one without rootserver help."""
        from ..log.palf import leader_of

        out: dict[int, int] = {}
        for ls_id, group in self.cluster.ls_groups.items():
            lead = leader_of([r.palf for r in group.values()])
            if lead is None:
                continue
            for node, rep in group.items():
                if rep.palf is lead:
                    out[ls_id] = node
                    break
        return out

    def balance_leaders(self, unreachable: set[int] = frozenset(),
                        spread: bool = False) -> list[tuple[int, int, int]]:
        """Decide leader moves from FailureDetector evidence (`unreachable`,
        the keepalive majority vote) and serving pressure (`spread`, from
        the tenant QoS ledger). Pure decision — the caller applies the
        moves (Database queues them as background dags)."""
        alive = set(range(self.cluster.n_nodes)) - set(unreachable)
        replica_nodes = {
            ls: sorted(group) for ls, group in self.cluster.ls_groups.items()
        }
        return plan_leader_moves(self.leader_map(), replica_nodes, alive,
                                 spread=spread)

    # ---------------------------------------------------------------- DDL
    def create_table(self, info_factory, n_partitions: int = 1) -> object:
        """Run a CREATE TABLE: pick placement for every partition (least-
        loaded LS round-robin), build the TableInfo via
        `info_factory(partitions)` with partitions = [(ls_id, tablet_id)],
        create tablets on all replicas, publish the schema version."""
        with self._lock:
            partitions = []
            counts = self.tablet_counts()
            for _ in range(max(1, n_partitions)):
                ls_id = min(sorted(counts), key=lambda ls: counts[ls])
                counts[ls_id] += 1
                partitions.append((ls_id, self._alloc_tablet_id()))
            ti = info_factory(partitions)

            def mutate(tables: dict):
                if ti.name in tables:
                    raise SchemaError(f"table {ti.name} already exists")
                tables[ti.name] = ti

            for ls_id, tablet_id in partitions:
                self.cluster.create_tablet(
                    ls_id, tablet_id, ti.schema, ti.key_cols
                )
            try:
                ti.schema_version = self.schema.apply_ddl(mutate)
            except SchemaError:
                for ls_id, tablet_id in partitions:
                    for rep in self.cluster.ls_groups[ls_id].values():
                        rep.tablets.pop(tablet_id, None)
                raise
            return ti

    def create_index_tablet(self, ls_id: int, schema, key_cols) -> int:
        """Allocate and create an index tablet co-located with its base
        table's LS (same log stream => index maintenance stays 1PC)."""
        with self._lock:
            tablet_id = self._alloc_tablet_id()
        self.cluster.create_tablet(ls_id, tablet_id, schema, key_cols)
        return tablet_id

    def drop_table(self, name: str) -> object:
        with self._lock:
            dropped = {}

            def mutate(tables: dict):
                if name not in tables:
                    raise SchemaError(f"no such table {name}")
                dropped["ti"] = tables.pop(name)

            self.schema.apply_ddl(mutate)
            ti = dropped["ti"]
            for ls_id, tablet_id in getattr(
                ti, "partitions", [(ti.ls_id, ti.tablet_id)]
            ):
                for rep in self.cluster.ls_groups[ls_id].values():
                    rep.tablets.pop(tablet_id, None)
            return ti
