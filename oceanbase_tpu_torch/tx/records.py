"""Transaction log records (the redo/commit wire format).

Reference surface: storage/tx tx log types written through the log-cb
manager (ob_tx_log_cb_mgr.h) — redo (memtable mutators,
ob_memtable_mutator.h), prepare, commit, abort records — replayed on
followers by ObTxReplayExecutor (ob_tx_replay_executor.cpp:28).

Records serialize with a small tag + pickle body. Pickle is acceptable here
because log payloads are produced and consumed only by this process group
(never untrusted input); a fixed binary layout can replace it without
touching any call site (to_bytes/from_bytes is the only boundary).
"""

from __future__ import annotations

import enum
import pickle
from dataclasses import dataclass, field


class RecordType(enum.IntEnum):
    REDO_COMMIT = 1  # 1PC: mutations + commit version in one record
    PREPARE = 2  # 2PC phase 1: mutations, participant list
    COMMIT = 3  # 2PC phase 2: commit version
    ABORT = 4
    # XA phase 1: like PREPARE (redo + participants reach the log, replicas
    # retain pending redo) but the decision belongs to an EXTERNAL
    # coordinator — applying it must never auto-commit. The record also
    # carries the xid/owner/tenant so a restarted node can rebuild its
    # parked-branch registry from replay alone (the reference logs prepare
    # state through the part ctx, ob_trans_part_ctx.h:154).
    XA_PREPARE = 5


@dataclass(frozen=True)
class Mutation:
    tablet_id: int
    key: tuple
    op: int  # storage.OP_PUT / OP_DELETE
    values: tuple | None


@dataclass(frozen=True)
class TxRecord:
    rtype: RecordType
    tx_id: int
    mutations: tuple[Mutation, ...] = ()
    commit_version: int = 0
    coordinator_ls: int = 0
    participants: tuple[int, ...] = ()
    # dictionary growth caused by this tx: (tablet_id, column, code,
    # string). VARCHAR cells in mutations store dictionary CODES; logging
    # the appends makes the log self-describing for CDC and PITR restore
    # (the multi-data-source analog: non-row state atomically logged with
    # the tx, storage/multi_data_source).
    dict_appends: tuple = ()
    # XA_PREPARE only: external branch id + the preparing user + owning
    # tenant (records are observed by every tenant on a shared cluster;
    # tenant scopes the registry rebuild)
    xid: str = ""
    owner: str = ""
    tenant: str = ""

    def to_bytes(self) -> bytes:
        return bytes([self.rtype]) + pickle.dumps(
            (self.tx_id, self.mutations, self.commit_version,
             self.coordinator_ls, self.participants, self.dict_appends,
             self.xid, self.owner, self.tenant),
            protocol=pickle.HIGHEST_PROTOCOL,
        )

    @staticmethod
    def from_bytes(b: bytes) -> "TxRecord":
        rtype = RecordType(b[0])
        fields = pickle.loads(b[1:])
        return TxRecord(rtype, *fields)
