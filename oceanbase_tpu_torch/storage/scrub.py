"""Background storage scrubber: proactive at-rest verification + typed
repair.

Reference surface: OceanBase's background macroblock inspector — data at
rest is re-verified on a cadence so bit rot is found by the scrubber,
not by the unlucky query that reads the block years later. Repair is
typed by artifact:

    checkpoint      quarantine the bad copy, rewrite a fresh snapshot
                    from the live replica ("checkpoint rewrites"); when
                    the replica's node is down too, fall back to a full
                    replica rebuild from a healthy peer (ha/rebuild.py,
                    "replica repairs")
    node meta       quarantine + rewrite from the live catalog
    sstable         an in-memory block whose payload crc fails means the
                    replica's storage is untrustworthy -> rebuild from a
                    healthy peer
    plan artifact   quarantine + drop the index entry; the next
                    statement recompiles (never a wrong answer)
    backup          quarantine only — there is nothing to regenerate a
                    backup from, so it stays UNREPAIRED and drives the
                    storage_corruption sentinel alert to critical

Scheduling: a BACKGROUND dag on the tenant dag scheduler, queued from
run_maintenance() when ob_scrub_interval elapsed (0 = off). Every file
visited counts "blocks scrubbed"; every verification failure counts
"checksum failures"; quarantines and repairs have their own counters and
all of it surfaces in __all_virtual_storage_integrity and AWR snapshots.

A quarantined file is NEVER re-read: it moves into a sibling
quarantine/ directory on first failure, so a scrub pass over a clean
tree reports zero failures — the pass after a corruption event proves
the repair actually converged.
"""

from __future__ import annotations

import os
import time

from .integrity import (ARTIFACT, BACKUP, CKPT, META, SSTABLE,
                        CorruptBlock, QUARANTINE_DIR, quarantine_file,
                        verify_file)

#: per-class accounting row shape (also the VT row shape)
_CLASSES = (CKPT, META, ARTIFACT, SSTABLE, BACKUP)


class StorageScrubber:
    """One tenant's scrubber; owns the pass loop and repair dispatch."""

    def __init__(self, db):
        self.db = db
        self.passes = 0
        self.last_pass_at: float | None = None
        #: extra roots to verify (backup sets registered by backup tools)
        self.backup_roots: list[str] = []
        self.by_class: dict[str, dict[str, int]] = {
            c: {"scrubbed": 0, "failures": 0, "quarantined": 0,
                "repaired": 0, "unrepaired": 0}
            for c in _CLASSES
        }
        #: (path_class, quarantine path, reason) — forensics surface
        self.quarantined: list[tuple[str, str, str]] = []

    # ---------------------------------------------------------- counting
    def _count(self, name: str, n: int = 1) -> None:
        m = getattr(self.db, "metrics", None)
        if m is not None:
            m.add(name, n)

    def _scrubbed(self, cls: str, n: int = 1) -> None:
        self.by_class[cls]["scrubbed"] += n
        self._count("blocks scrubbed", n)

    def _failed(self, cls: str) -> None:
        self.by_class[cls]["failures"] += 1
        self._count("checksum failures")

    def _quarantined(self, cls: str, qpath: str | None, reason: str) -> None:
        self.by_class[cls]["quarantined"] += 1
        self._count("quarantined files")
        if qpath:
            self.quarantined.append((cls, qpath, reason))

    def _repaired(self, cls: str) -> None:
        self.by_class[cls]["repaired"] += 1

    def _unrepaired(self, cls: str) -> None:
        self.by_class[cls]["unrepaired"] += 1

    # ------------------------------------------------------------ driver
    def maybe_queue(self) -> bool:
        """Queue one scrub pass as a BACKGROUND dag when the interval
        elapsed (dag key dedups a still-queued pass)."""
        try:
            interval = float(self.db.config["ob_scrub_interval"])
        except Exception:
            return False
        if interval <= 0:
            return False
        now = time.monotonic()
        if self.last_pass_at is not None \
                and now - self.last_pass_at < interval:
            return False
        from ..share.dag_scheduler import Dag, DagPriority

        dag = Dag("storage scrub", DagPriority.BACKGROUND,
                  key=("storage scrub",))
        dag.add_task(self.run_pass, name="scrub pass")
        self.db.dag_scheduler.add_dag(dag)
        return True

    def run_pass(self) -> dict:
        """One full verification sweep over every durable artifact class.
        Returns this pass's failure/repair tally (also folded into the
        cumulative stats the VT and AWR read)."""
        before = {c: dict(v) for c, v in self.by_class.items()}
        self._scrub_node_meta()
        self._scrub_checkpoints()
        self._scrub_sstables()
        self._scrub_plan_artifacts()
        self._scrub_backups()
        self.passes += 1
        self.last_pass_at = time.monotonic()
        delta = {
            c: {k: self.by_class[c][k] - before[c][k]
                for k in self.by_class[c]}
            for c in self.by_class
        }
        return {"pass": self.passes, "delta": delta}

    # ----------------------------------------------------------- targets
    def _scrub_node_meta(self) -> None:
        db = self.db
        if db.data_dir is None:
            return
        base = db._meta_path()
        bad = False
        for p in (base, base + ".prev"):
            if not os.path.exists(p):
                continue
            try:
                verify_file(p, META)
                self._scrubbed(META)
            except FileNotFoundError:
                continue
            except CorruptBlock as e:
                self._scrubbed(META)
                self._failed(META)
                self._quarantined(META, quarantine_file(p, e.reason),
                                  e.reason)
                bad = True
        if bad:
            # the live catalog is authoritative: rewrite the snapshot
            # (write rotates the surviving copy into .prev)
            try:
                db._save_node_meta()
                self._count("node meta rewrites")
                self._repaired(META)
            except Exception:
                self._unrepaired(META)

    def _scrub_checkpoints(self) -> None:
        db = self.db
        if db.data_dir is None:
            return
        from .ckpt import write_ls_checkpoint

        for ls_id, group in db.cluster.ls_groups.items():
            for node, rep in group.items():
                base = db._ckpt_path(node, ls_id)
                bad = False
                for p in (base, base + ".prev"):
                    if not os.path.exists(p):
                        continue
                    try:
                        verify_file(p, CKPT)
                        self._scrubbed(CKPT)
                    except FileNotFoundError:
                        continue
                    except CorruptBlock as e:
                        self._scrubbed(CKPT)
                        self._failed(CKPT)
                        self._quarantined(
                            CKPT, quarantine_file(p, e.reason), e.reason)
                        bad = True
                if not bad:
                    continue
                # typed repair: the live replica IS the data — cut a
                # fresh snapshot over the quarantined one
                try:
                    covered = write_ls_checkpoint(base, rep,
                                                  fsync=db._fsync)
                except Exception:
                    covered = None
                if covered is not None:
                    self._count("checkpoint rewrites")
                    self._repaired(CKPT)
                elif self._rebuild(ls_id, node):
                    self._repaired(CKPT)
                else:
                    self._unrepaired(CKPT)

    def _scrub_sstables(self) -> None:
        """Deep verify: every replica's resident sstable payload crc (the
        at-rest envelope covers the file; this covers the block bytes a
        checkpoint pickled). A failed replica-local block means that
        replica's storage lies -> rebuild it from a healthy peer."""
        db = self.db
        for ls_id, group in db.cluster.ls_groups.items():
            for node, rep in group.items():
                ok = True
                for t in rep.tablets.values():
                    tables = list(t.deltas)
                    if t.base is not None:
                        tables.append(t.base)
                    for ss in tables:
                        self._scrubbed(SSTABLE)
                        if not ss.verify():
                            self._failed(SSTABLE)
                            ok = False
                if not ok:
                    if self._rebuild(ls_id, node):
                        self._repaired(SSTABLE)
                    else:
                        self._unrepaired(SSTABLE)

    def _scrub_plan_artifacts(self) -> None:
        pa = getattr(self.db, "plan_artifact", None)
        if pa is None or not os.path.isdir(pa.root):
            return
        idx = pa._index_path()
        for name in sorted(os.listdir(pa.root)):
            path = os.path.join(pa.root, name)
            if not os.path.isfile(path) or ".tmp" in name:
                continue  # xla/ + quarantine/ subdirs, in-flight tmps
            try:
                verify_file(path, ARTIFACT)
                self._scrubbed(ARTIFACT)
                continue
            except FileNotFoundError:
                continue
            except CorruptBlock as e:
                self._scrubbed(ARTIFACT)
                self._failed(ARTIFACT)
                reason = e.reason
            # aid = filename up to the first dot ("<aid>.meta",
            # "<aid>.x", "<aid>.b<K>.x"); the index file quarantines
            # through the store too (it restarts empty)
            if path == idx:
                self._quarantined(ARTIFACT, quarantine_file(path, reason),
                                  reason)
                with pa._lock:
                    pa._index["entries"] = {}
                    pa._save_index()
                self._count("plan artifact quarantined")
                self._repaired(ARTIFACT)
                continue
            aid = name.split(".", 1)[0]
            pa.quarantine(aid, path, reason)
            self._quarantined(ARTIFACT, None, reason)
            # artifacts are recomputable: quarantine IS the repair (the
            # next statement honestly recompiles)
            self._repaired(ARTIFACT)

    def _scrub_backups(self) -> None:
        for root in list(self.backup_roots):
            if not os.path.isdir(root):
                continue
            for name in sorted(os.listdir(root)):
                path = os.path.join(root, name)
                if not os.path.isfile(path) or ".tmp" in name:
                    continue
                cls = BACKUP if name == "meta.json" else SSTABLE
                try:
                    verify_file(path, cls)
                    self._scrubbed(BACKUP)
                except FileNotFoundError:
                    continue
                except CorruptBlock as e:
                    self._scrubbed(BACKUP)
                    self._failed(BACKUP)
                    self._quarantined(
                        BACKUP, quarantine_file(path, e.reason), e.reason)
                    # nothing regenerates a backup set: stays unrepaired
                    # (the sentinel escalates to critical on this)
                    self._unrepaired(BACKUP)

    # ------------------------------------------------------------ repair
    def _rebuild(self, ls_id: int, node: int) -> bool:
        """Last-resort typed repair: wipe + resync one replica from a
        healthy peer (ha/rebuild.py)."""
        db = self.db
        try:
            from ..ha.rebuild import rebuild_replica

            rebuild_replica(db.cluster, ls_id, node,
                            data_dir=db.data_dir, fsync=db._fsync)
        except Exception:
            return False
        self._count("replica repairs")
        return True

    # ------------------------------------------------------------- stats
    def unrepaired_total(self) -> int:
        return sum(v["unrepaired"] for v in self.by_class.values())

    def stats(self) -> dict:
        """Cumulative scrub state for the VT, AWR snapshots and the
        sentinel's corruption rule."""
        return {
            "passes": self.passes,
            "last_pass_at": self.last_pass_at,
            "by_class": {c: dict(v) for c, v in self.by_class.items()},
            "quarantined": list(self.quarantined),
            "unrepaired": self.unrepaired_total(),
        }


def find_quarantined(root: str) -> list[str]:
    """Every quarantined file under a tree (diagnostics helper)."""
    out: list[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        if os.path.basename(dirpath) == QUARANTINE_DIR:
            out.extend(os.path.join(dirpath, f) for f in sorted(filenames))
            dirnames[:] = []
    return out
