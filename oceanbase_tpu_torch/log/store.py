"""LogStore: the disk log engine behind a palf replica.

Reference surface: logservice/palf's LogEngine = LogStorage (fixed-size
block files of group entries, log_engine.h) + LogIOWorker (ordered appends
with batched sync, log_io_worker.h), plus the durable vote/term state the
election code keeps (palf persists proposal ids and membership meta through
LogMetaStorage). The rebuild keeps the same split at test scale:

  * segment files `seg_XXXXXXXX.plog` of fixed entry count — dense LSNs
    make segment membership arithmetic (lsn // SEGMENT_ENTRIES), the analog
    of PALF's fixed 64MB blocks (log_define.h:67);
  * appends are buffered and made durable by `sync()` — the group-commit
    point. A replica MUST sync before acking an append or counting its own
    log in a commit quorum (raft durability rule; the reference achieves
    it by acking from the IO worker's completion path);
  * `meta` file holds (term, voted_for), replaced atomically + fsynced
    BEFORE any message that promises the vote/term (a vote that survives
    restart is what makes double-voting impossible);
  * crash recovery truncates a torn final record at load;
  * `recycle(upto_lsn)` deletes whole segments strictly below the
    checkpoint point (slog_ckpt advancing the palf recycle point).

Record format: `<q lsn><q term><q scn><I payload_len><I crc32>payload`.
"""

from __future__ import annotations

import os
import struct
import zlib

from .palf import LogEntry

_REC = struct.Struct("<qqqII")
SEGMENT_ENTRIES = 8192


def scan_records(buf: bytes) -> tuple[list[tuple[int, int, int, bytes]], int]:
    """Parse `<q lsn><q term><q scn><I len><I crc>payload` records from buf.

    Returns ([(lsn, term, scn, payload), ...], good_end): whole, crc-valid
    records and the byte offset of the last valid boundary. A torn or
    corrupt tail simply ends the scan — the ONE shared implementation of
    crash-boundary detection for the log store and the archive (divergent
    copies of this loop invite divergent crash behavior)."""
    recs = []
    pos = 0
    n = len(buf)
    while pos + _REC.size <= n:
        lsn, term, scn, plen, crc = _REC.unpack_from(buf, pos)
        end = pos + _REC.size + plen
        if plen < 0 or end > n:
            break
        payload = bytes(buf[pos + _REC.size : end])
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break
        recs.append((lsn, term, scn, payload))
        pos = end
    return recs, pos


class LogStore:
    """Durable storage of one replica's log + election meta."""

    def __init__(self, root: str, fsync: bool = True):
        self.root = root
        self.fsync = fsync
        os.makedirs(root, exist_ok=True)
        self._meta_path = os.path.join(root, "meta")
        # open tail file handle (append mode), lazily (re)opened
        self._tail_fh = None
        self._tail_seg = -1
        self._dirty = False
        # cached meta fields (term, voted_for, recycle-point info)
        self._term = 0
        self._voted_for: int | None = None
        self.base_prev_lsn = -1
        self.base_prev_term = 0

    # ------------------------------------------------------------- paths
    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.root, f"seg_{seg:08d}.plog")

    def _segments(self) -> list[int]:
        return sorted(
            int(f[4:-5]) for f in os.listdir(self.root)
            if f.startswith("seg_") and f.endswith(".plog")
        )

    # -------------------------------------------------------------- load
    def load(self) -> tuple[list[LogEntry], int, int, int | None]:
        """Scan all segments; returns (entries, base_lsn, term, voted_for).

        Torn final records (crash mid-append) are truncated. Entries are
        contiguous from base_lsn (the first LSN still on disk after
        recycling)."""
        term, voted_for = 0, None
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                parts = f.read().split()
            term = int(parts[0])
            voted_for = None if parts[1] == "-" else int(parts[1])
            if len(parts) >= 4:
                self.base_prev_lsn = int(parts[2])
                self.base_prev_term = int(parts[3])
        self._term, self._voted_for = term, voted_for
        entries: list[LogEntry] = []
        segs = self._segments()
        for i, seg in enumerate(segs):
            path = self._seg_path(seg)
            with open(path, "rb") as f:
                buf = f.read()
            recs, pos = scan_records(buf)
            entries.extend(LogEntry(*r) for r in recs)
            if pos < len(buf):
                # torn/corrupt tail: only legal on the LAST segment; chop it
                with open(path, "r+b") as f:
                    f.truncate(pos)
                # anything recorded in later segments was written after the
                # torn record and is unreachable — drop those files
                for later in segs[i + 1 :]:
                    os.remove(self._seg_path(later))
                break
        base_lsn = entries[0].lsn if entries else (
            segs[0] * SEGMENT_ENTRIES if segs else 0
        )
        return entries, base_lsn, term, voted_for

    # ------------------------------------------------------------ append
    def append(self, entries) -> None:
        """Buffered append in LSN order; call sync() to make durable."""
        for e in entries:
            seg = e.lsn // SEGMENT_ENTRIES
            if seg != self._tail_seg or self._tail_fh is None:
                self._roll_to(seg)
            self._tail_fh.write(
                _REC.pack(e.lsn, e.term, e.scn, len(e.payload),
                          zlib.crc32(e.payload) & 0xFFFFFFFF)
            )
            self._tail_fh.write(e.payload)
            self._dirty = True

    def _roll_to(self, seg: int) -> None:
        if self._tail_fh is not None:
            self._tail_fh.flush()
            if self.fsync:
                os.fsync(self._tail_fh.fileno())
            self._tail_fh.close()
        self._tail_fh = open(self._seg_path(seg), "ab")
        self._tail_seg = seg

    def sync(self) -> None:
        """Group-commit point: flush buffered appends to disk."""
        if self._tail_fh is not None and self._dirty:
            self._tail_fh.flush()
            if self.fsync:
                os.fsync(self._tail_fh.fileno())
            self._dirty = False

    # ---------------------------------------------------------- truncate
    def truncate_from(self, lsn: int) -> None:
        """Remove entries >= lsn (conflicting-suffix reconciliation)."""
        if self._tail_fh is not None:
            self._tail_fh.flush()
            self._tail_fh.close()
            self._tail_fh = None
            self._tail_seg = -1
        seg = lsn // SEGMENT_ENTRIES
        for s in self._segments():
            if s > seg:
                os.remove(self._seg_path(s))
        path = self._seg_path(seg)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            buf = f.read()
        pos = 0
        for elsn, _t, _s, payload in scan_records(buf)[0]:
            if elsn >= lsn:
                break
            pos += _REC.size + len(payload)
        if pos == 0:
            os.remove(path)
        else:
            with open(path, "r+b") as f:
                f.truncate(pos)

    # ----------------------------------------------------------- recycle
    def recycle(self, upto_lsn: int) -> int:
        """Delete whole segments entirely below upto_lsn (all entries are
        covered by a durable checkpoint). Returns segments removed. The
        tail segment is never removed (consensus keeps indexing the last
        entry for prev-term checks).

        Disk recycling is SEGMENT-aligned: the post-restart base is the
        first retained segment's start, not upto_lsn — so the durable base
        info must describe the entry just below THAT boundary (read from
        the last victim before it is deleted), or log matching at the new
        base would use a term from the wrong lsn."""
        segs = self._segments()
        victims = [
            s for s in segs[:-1] if (s + 1) * SEGMENT_ENTRIES <= upto_lsn
        ]
        if not victims:
            return 0
        new_base = (victims[-1] + 1) * SEGMENT_ENTRIES
        prev_term = self._term_of(victims[-1], new_base - 1)
        if prev_term is None:
            return 0  # boundary entry unreadable: keep everything
        self.set_base_info(new_base - 1, prev_term)  # durable BEFORE rm
        removed = 0
        for s in victims:
            os.remove(self._seg_path(s))
            removed += 1
        return removed

    def _term_of(self, seg: int, lsn: int) -> int | None:
        """Scan one segment file for the entry at lsn; returns its term."""
        path = self._seg_path(seg)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            buf = f.read()
        for elsn, t, _s, _p in scan_records(buf)[0]:
            if elsn == lsn:
                return t
        return None

    # -------------------------------------------------------------- meta
    def save_meta(self, term: int, voted_for: int | None) -> None:
        """Atomically persist election state; durable BEFORE any message
        that acts on it (vote grants, term bumps)."""
        self._term, self._voted_for = term, voted_for
        self._write_meta()

    def set_base_info(self, prev_lsn: int, prev_term: int) -> None:
        """Record the (lsn, term) of the last entry about to be recycled so
        log matching at the new base still works after restart."""
        self.base_prev_lsn, self.base_prev_term = prev_lsn, prev_term
        self._write_meta()

    def _write_meta(self) -> None:
        from ..share.fsutil import atomic_write

        vf = "-" if self._voted_for is None else self._voted_for
        atomic_write(
            self._meta_path,
            f"{self._term} {vf} {self.base_prev_lsn} {self.base_prev_term}".encode(),
            fsync=self.fsync,
        )

    def close(self) -> None:
        self.sync()
        if self._tail_fh is not None:
            self._tail_fh.close()
            self._tail_fh = None
