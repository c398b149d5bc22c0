"""Transactions: GTS, log streams, snapshot isolation, 1PC/2PC.

Layer map (SURVEY.md §2.3 storage/tx + §2.4 -> rebuild):
  gts.py      per-tenant timestamp authority
  records.py  tx log record formats (redo/prepare/commit/abort)
  ls.py       log stream replica: tablets + palf + apply/replay
  txn.py      TransService: tx contexts, conflicts, 1PC/2PC state machine
  cluster.py  in-process multi-replica cluster harness
"""

from .cluster import LocalCluster
from .gts import GtsService
from .ls import LSReplica, make_ls_group
from .records import Mutation, RecordType, TxRecord
from .txn import NotMaster, TransService, TxContext, TxState

__all__ = [
    "GtsService",
    "LSReplica",
    "make_ls_group",
    "Mutation",
    "RecordType",
    "TxRecord",
    "TransService",
    "TxContext",
    "TxState",
    "NotMaster",
    "LocalCluster",
]
