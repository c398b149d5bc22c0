"""LS checkpoint: durable snapshot of replica storage state.

Reference surface: storage/slog + slog_ckpt — the storage-meta redo log and
its periodic checkpoints, which bound boot-time replay and let palf recycle
log blocks below the checkpointed point (SURVEY §5: "boot = slog ckpt
replay + palf replay", ob_server.cpp:923).

The rebuild collapses slog+ckpt into an atomic whole-replica snapshot (the
LSM state at test scale pickles in one file): {applied_lsn, tablets,
tx_table, pending 2PC redo}. Correctness rules:

  * a checkpoint is only taken when the replica has no locally-staged
    uncommitted rows (a leader mid-transaction): those belong to a live
    coordinator whose state is not durable, so the snapshot would leak
    orphan stages. Follower-side prepared redo IS included — it is
    log-derived and must survive restart for 2PC to finish.
  * the file is written tmp + fsync + rename (a torn checkpoint is
    invisible; boot falls back to the previous one).
  * after a successful checkpoint the caller may recycle the palf log
    strictly below applied_lsn + 1.

Boot order matters: restore tablets BEFORE the replica's palf elects or
receives appends, so replay (applied_lsn+1 ..] lands on restored state.
"""

from __future__ import annotations

import os
import pickle


def write_ls_checkpoint(path: str, rep, fsync: bool = True) -> int | None:
    """Snapshot one LSReplica's storage state. Returns the applied_lsn the
    snapshot covers (the ONLY safe recycle bound — the replica's live
    applied_lsn may advance while/after the pickle is cut), or None while
    leader-staged uncommitted rows exist. The previous checkpoint is kept
    as `<path>.prev` so a damaged latest file still has a fallback."""
    if rep._locally_staged:
        return None
    covered = rep.palf.applied_lsn
    # max commit version inside the snapshot: boot must advance GTS past it
    # even when NO log records remain to replay (fully-applied checkpoint)
    hwm = 0
    for t in rep.tablets.values():
        hwm = max(hwm, t.active._max_version)
        for m in t.frozen:
            hwm = max(hwm, m._max_version)
        for ss in t.deltas:
            hwm = max(hwm, ss.end_version)
        if t.base is not None:
            hwm = max(hwm, t.base.end_version)
    state = {
        "ls_id": rep.ls_id,
        "applied_lsn": covered,
        "max_version": hwm,
        "tablets": rep.tablets,
        "tx_table": dict(rep.tx_table),
        "pending_redo": dict(rep._pending_redo),
    }
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    if os.path.exists(path):
        try:
            os.replace(path, path + ".prev")
        except OSError:
            pass
    from .integrity import CKPT, write_atomic

    write_atomic(path, blob, fsync=fsync, path_class=CKPT)
    return covered


def read_ls_checkpoint(path: str, metrics=None) -> dict | None:
    """Read the newest verifiable checkpoint.

    Missing and corrupt are DIFFERENT outcomes: None means no checkpoint
    was ever written (fresh boot, full log replay); a damaged latest file
    is counted ("checkpoint corruption"), quarantined, and recovery falls
    back to the retained previous snapshot — replay then covers the gap
    from that older applied_lsn. Only when every existing copy fails
    verification does this raise CorruptBlock, so the caller can decide
    whether log replay from zero (or a replica rebuild) is still safe."""
    from .integrity import CKPT, CorruptBlock, quarantine_file, read_verified

    last_err: CorruptBlock | None = None
    for p in (path, path + ".prev"):
        if not os.path.exists(p):
            continue
        try:
            return pickle.loads(read_verified(p, path_class=CKPT))
        except CorruptBlock as e:
            last_err = e
        except Exception as e:  # unpicklable payload despite a valid crc
            last_err = CorruptBlock(p, f"{type(e).__name__}: {e}")
        if metrics is not None:
            metrics.add("checkpoint corruption")
            metrics.add("checksum failures")
        quarantine_file(p, last_err.reason)
    if last_err is not None:
        raise last_err
    return None


def restore_ls_replica(rep, state: dict) -> None:
    """Install a checkpoint into a freshly-built replica (before election/
    appends). Replay then resumes at applied_lsn + 1."""
    if state["applied_lsn"] < rep.palf.log.base - 1:
        # the log below base was recycled on the promise of a NEWER
        # checkpoint; this snapshot cannot be completed by replay
        raise RuntimeError(
            f"ls {rep.ls_id} node {rep.node_id}: checkpoint covers lsn "
            f"{state['applied_lsn']} but the log was recycled to "
            f"{rep.palf.log.base}; replica needs a snapshot rebuild"
        )
    rep.tablets = state["tablets"]
    rep.tx_table = dict(state["tx_table"])
    rep._pending_redo = dict(state["pending_redo"])
    rep.palf.applied_lsn = max(rep.palf.applied_lsn, state["applied_lsn"])
