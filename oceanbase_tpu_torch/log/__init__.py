"""Replicated log service (PALF-lite) + transports.

Layer map (SURVEY.md §2.4 -> rebuild):
  transport.py  message bus w/ virtual clock + fault injection (obrpc analog)
  palf.py       leader-based replicated log: sliding window, majority commit,
                lease election, log reconciliation
"""

from .palf import (
    AppendAck,
    AppendReq,
    LogEntry,
    LogView,
    PalfReplica,
    Role,
    VoteReq,
    VoteResp,
    leader_of,
    run_until,
)
from .store import LogStore
from .transport import LocalBus

__all__ = [
    "LocalBus",
    "LogEntry",
    "LogView",
    "LogStore",
    "PalfReplica",
    "Role",
    "AppendReq",
    "AppendAck",
    "VoteReq",
    "VoteResp",
    "run_until",
    "leader_of",
]
