"""Log stream (LS): the replication unit binding tablets to a replicated log.

Reference surface: storage/ls + tx_storage — an LS is the unit of Paxos
replication; it hosts tablets, a palf log, an apply service (leader) and a
replay service (followers): committed tx log entries drive memtable state
(ObLSTabletService, apply/replay services logservice/applyservice,
replayservice; ObTxReplayExecutor storage/tx/ob_tx_replay_executor.cpp:28).

The rebuild's LSReplica owns {palf replica, tablets, tx table} for one
replica of one LS. All replicas apply the same committed records in LSN
order; the difference between leader "apply" and follower "replay" is only
whether the mutations were already staged locally by an executing tx:

  * leader: tx staged rows at execution time -> apply resolves them
    (memtable.commit / abort);
  * follower (or a restarted leader): nothing staged -> replay inserts the
    committed versions directly.

Commit acknowledgement: on_tx_applied callbacks fire when a tx's decisive
record (REDO_COMMIT / COMMIT / ABORT) is applied on this replica — the
TransService uses the leader's callback to release the waiting session
(the ObEndTransCallback analog).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..core.dtypes import Schema
from ..log import LocalBus, LogEntry, PalfReplica, Role
from ..storage import Tablet
from .records import Mutation, RecordType, TxRecord


@dataclass
class LSReplica:
    ls_id: int
    node_id: int
    palf: PalfReplica
    tablets: dict[int, Tablet] = field(default_factory=dict)
    # tx table: uncommitted tx state on this replica (ObTxTable analog)
    tx_table: dict[int, str] = field(default_factory=dict)  # tx_id -> state
    # txs whose mutations this replica staged at execution time (leader path)
    _locally_staged: set[int] = field(default_factory=set)
    # follower-side redo retained from PREPARE until COMMIT/ABORT
    _pending_redo: dict[int, tuple[Mutation, ...]] = field(default_factory=dict)
    on_tx_applied: Callable[[int, RecordType, int], None] | None = None
    # observer of every applied record (the multi-data-source consumer
    # analog): the server layer uses it to re-apply logged dictionary
    # appends and advance GTS during boot-time replay
    on_record: Callable[[TxRecord], None] | None = None

    def __post_init__(self):
        self.palf.on_commit = self._apply

    # ----------------------------------------------------------- tablets
    def create_tablet(self, tablet_id: int, schema: Schema, key_cols: list[str]) -> Tablet:
        t = Tablet(tablet_id, schema, key_cols)
        self.tablets[tablet_id] = t
        return t

    @property
    def is_leader(self) -> bool:
        return self.palf.role is Role.LEADER

    @property
    def is_ready(self) -> bool:
        """Leader with all committed entries applied — safe to serve."""
        return self.palf.is_ready_leader

    # ------------------------------------------------------ execution path
    def stage_locally(self, tx_id: int, read_snapshot: int, m: Mutation) -> None:
        """Leader-side execution: stage into the tablet memtable now; the
        redo reaches the log only at commit time."""
        self.tablets[m.tablet_id].stage(tx_id, read_snapshot, m.key, m.op, m.values)
        self._locally_staged.add(tx_id)
        self.tx_table[tx_id] = "active"

    def abort_locally(self, tx_id: int) -> None:
        for t in self.tablets.values():
            t.abort_tx(tx_id)
        self._locally_staged.discard(tx_id)
        self.tx_table.pop(tx_id, None)

    def submit_record(self, rec: TxRecord) -> int | None:
        # scn latches to max(prev+1, commit_version): with submits
        # serialized under GtsService.submit_lock, a replica's applied scn
        # then dominates every applied commit version — the follower-read
        # watermark (see apply_watermark)
        return self.palf.submit_log(rec.to_bytes(), scn=rec.commit_version)

    @property
    def apply_watermark(self) -> int:
        """Every tx with commit_version <= this has applied on THIS
        replica; a snapshot read at any ts <= watermark is complete."""
        return self.palf.applied_scn

    # ------------------------------------------------------- apply/replay
    def _apply(self, entry: LogEntry) -> None:
        if not entry.payload:
            return  # leadership no-op entry
        rec = TxRecord.from_bytes(entry.payload)
        if self.on_record is not None:
            self.on_record(rec)
        staged = rec.tx_id in self._locally_staged
        if rec.rtype is RecordType.REDO_COMMIT:
            if staged:
                for t in self.tablets.values():
                    t.commit_tx(rec.tx_id, rec.commit_version)
                self._locally_staged.discard(rec.tx_id)
            else:
                self._replay_mutations(rec.mutations, rec.commit_version)
            self.tx_table.pop(rec.tx_id, None)
            self._notify(rec.tx_id, rec.rtype, rec.commit_version)
        elif rec.rtype in (RecordType.PREPARE, RecordType.XA_PREPARE):
            if not staged:
                # follower: remember redo; rows become visible at COMMIT with
                # the final version (staging uncommitted rows would need
                # speculative nodes — simpler and equivalent to defer)
                self.tx_table[rec.tx_id] = "prepared"
                self._pending_redo[rec.tx_id] = rec.mutations
            else:
                self.tx_table[rec.tx_id] = "prepared"
            self._notify(rec.tx_id, rec.rtype, 0)
        elif rec.rtype is RecordType.COMMIT:
            if staged:
                for t in self.tablets.values():
                    t.commit_tx(rec.tx_id, rec.commit_version)
                self._locally_staged.discard(rec.tx_id)
            else:
                self._replay_mutations(
                    self._pending_redo.pop(rec.tx_id, ()), rec.commit_version
                )
            self.tx_table.pop(rec.tx_id, None)
            self._notify(rec.tx_id, rec.rtype, rec.commit_version)
        elif rec.rtype is RecordType.ABORT:
            if staged:
                self.abort_locally(rec.tx_id)
            self._pending_redo.pop(rec.tx_id, None)
            self.tx_table.pop(rec.tx_id, None)
            self._notify(rec.tx_id, rec.rtype, 0)

    def _replay_mutations(self, mutations, version: int) -> None:
        for m in mutations:
            t = self.tablets.get(m.tablet_id)
            if t is not None:
                t.active.replay(m.key, m.op, m.values, version)

    def _notify(self, tx_id: int, rtype: RecordType, version: int) -> None:
        if self.on_tx_applied is not None:
            self.on_tx_applied(tx_id, rtype, version)


def make_ls_group(
    ls_id: int,
    node_ids: list[int],
    bus: LocalBus,
    palf_id_base: int = 0,
    data_dir: str | None = None,
    fsync: bool = True,
) -> dict[int, LSReplica]:
    """Create one LS's replicas across nodes sharing a bus.

    Bus addresses must be unique per (ls, node): address = base + node_id.
    With data_dir, each replica gets a durable LogStore at
    `{data_dir}/n{node}/ls_{ls}` and reloads any existing log + election
    meta from it (restart recovery).
    """
    addrs = [palf_id_base + n for n in node_ids]
    out = {}
    for n in node_ids:
        store = None
        if data_dir is not None:
            import os

            from ..log.store import LogStore

            store = LogStore(
                os.path.join(data_dir, f"n{n}", f"ls_{ls_id}"), fsync=fsync
            )
        palf = PalfReplica(palf_id_base + n, addrs, bus, store=store)
        out[n] = LSReplica(ls_id, n, palf)
    return out
