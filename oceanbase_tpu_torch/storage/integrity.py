"""Shared storage-integrity envelope: end-to-end checksums for every
durable artifact, plus the disk-fault injection layer that proves the
readers actually check them.

Reference surface: OceanBase treats silent disk corruption as a
first-class failure mode — every macroblock carries a physical checksum
(ObMacroBlockCommonHeader / ObMicroBlockHeader data_checksum), a
background inspector re-verifies data at rest, and ERRSIM builds corrupt
I/O on purpose to exercise the repair paths. Before this module the
rebuild only protected the palf log (log/store.py crc32 + torn-tail
truncation); checkpoints, node meta, plan artifacts, spill segments and
backups were trusted blindly.

The envelope is a fixed 20-byte header in front of the payload:

    magic u32 | version u16 | flags u16 | length u64 | crc32 u32

crc32 (zlib) covers the payload; length must match the remaining bytes
exactly, so torn tails, truncation, and header bitflips all surface as a
typed CorruptBlock — never a half-parsed pickle. `write_atomic` layers
the envelope over the shared tmp -> fsync -> rename sequence, and
`read_verified` is the single verified read path every adopter shares
(storage/ckpt.py, storage/backup.py, storage/tmp_file.py spill segments,
engine/plan_artifact.py, sstable at-rest framing, node meta).

Fault injection (share/errsim.py arms, probability- and path-class-
scoped so a chaos run can corrupt ONLY checkpoints, or everything):

    EN_DISK_BITFLIP     flip one payload byte as it lands on disk /
                        decay one byte of the file before a read
    EN_DISK_TORN_WRITE  persist only a prefix of the envelope
    EN_DISK_TRUNCATE    lose the file's tail before a read
    EN_IO_ERROR         raise OSError at the read/write point
    EN_CRASH_TMP_PARTIAL / EN_CRASH_BEFORE_RENAME /
    EN_CRASH_AFTER_RENAME
                        kill the writer at each write/fsync/rename
                        boundary (the crash-consistency property test
                        schedules these and asserts recovery)
"""

from __future__ import annotations

import os
import struct
import zlib

from ..share.errsim import ERRSIM, InjectedError

MAGIC = 0x0B5EA1ED
VERSION = 1
_HDR = struct.Struct("<IHHQI")  # magic, version, flags, length, crc32
HEADER_SIZE = _HDR.size

# path classes: every adopter tags its reads/writes so errsim arms (and
# the scrubber's per-class accounting) can scope to one artifact family
CKPT = "ckpt"
META = "meta"
ARTIFACT = "artifact"
SPILL = "spill"
BACKUP = "backup"
SSTABLE = "sstable"

PATH_CLASSES = (CKPT, META, ARTIFACT, SPILL, BACKUP, SSTABLE)

#: quarantine subdirectory name (bad files move here exactly once and
#: are never re-read on the hot path)
QUARANTINE_DIR = "quarantine"


class CorruptBlock(Exception):
    """A persisted block failed integrity verification. Carries the path
    and a machine-checkable reason so recovery can be typed (checkpoint
    -> log replay, artifact -> recompute, tablet -> replica rebuild)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt block {path}: {reason}")
        self.path = path
        self.reason = reason


class CounterSink:
    """Minimal metrics adapter for boot-time code that runs before the
    real metrics registry exists; counts fold into sysstat later."""

    def __init__(self, counts: dict[str, float] | None = None):
        self.counts = counts if counts is not None else {}

    def add(self, name: str, n: float = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n


# ------------------------------------------------------------- envelope


def wrap(payload: bytes) -> bytes:
    """Prepend the integrity header to a payload."""
    payload = bytes(payload)
    return _HDR.pack(MAGIC, VERSION, 0, len(payload),
                     zlib.crc32(payload) & 0xFFFFFFFF) + payload


def unwrap(data: bytes, path: str = "<mem>") -> bytes:
    """Verify and strip the envelope; raises CorruptBlock on any damage."""
    if len(data) < HEADER_SIZE:
        raise CorruptBlock(path, f"short header ({len(data)} bytes)")
    magic, version, _flags, length, crc = _HDR.unpack_from(data)
    if magic != MAGIC:
        raise CorruptBlock(path, f"bad magic 0x{magic:08X}")
    if version != VERSION:
        raise CorruptBlock(path, f"unsupported envelope version {version}")
    payload = data[HEADER_SIZE:]
    if len(payload) != length:
        raise CorruptBlock(
            path, f"length mismatch: header {length}, got {len(payload)}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CorruptBlock(path, "crc mismatch")
    return bytes(payload)


# ------------------------------------------------------ fault injection


def _flip_byte(data: bytes) -> bytes:
    """Deterministically flip one payload byte (middle of the payload
    region, so both crc and content checks see it)."""
    if not data:
        return data
    pos = HEADER_SIZE + max(0, (len(data) - HEADER_SIZE) // 2) \
        if len(data) > HEADER_SIZE else len(data) // 2
    pos = min(pos, len(data) - 1)
    b = bytearray(data)
    b[pos] ^= 0xFF
    return bytes(b)


def apply_write_faults(data: bytes, path_class: str | None) -> bytes:
    """Consult the disk-fault arms for one write: may raise OSError
    (EN_IO_ERROR) or return bytes corrupted the way a bad disk would
    persist them (the file on disk is then genuinely damaged, so every
    reader's corruption path and the scrubber are exercised for real)."""
    if ERRSIM.should_fire("EN_IO_ERROR", path_class):
        raise OSError(f"EN_IO_ERROR injected ({path_class})")
    if ERRSIM.should_fire("EN_DISK_BITFLIP", path_class):
        data = _flip_byte(data)
    if ERRSIM.should_fire("EN_DISK_TORN_WRITE", path_class):
        keep = HEADER_SIZE + max(1, (len(data) - HEADER_SIZE) // 2) \
            if len(data) > HEADER_SIZE + 1 else max(1, len(data) // 2)
        data = data[:keep]
    if ERRSIM.should_fire("EN_DISK_TRUNCATE", path_class):
        data = data[:max(0, len(data) - 8)]
    return data


def apply_read_faults(path: str, path_class: str | None) -> None:
    """Consult the disk-fault arms before one read: may raise OSError or
    persistently decay the on-disk file (bit rot / lost tail blocks) so
    detection, quarantine, and never-re-read semantics operate on a file
    that is actually bad."""
    if ERRSIM.should_fire("EN_IO_ERROR", path_class):
        raise OSError(f"EN_IO_ERROR injected ({path_class})")
    try:
        if ERRSIM.should_fire("EN_DISK_BITFLIP", path_class):
            with open(path, "r+b") as f:
                raw = f.read()
                if raw:
                    f.seek(0)
                    f.write(_flip_byte(raw))
        if ERRSIM.should_fire("EN_DISK_TRUNCATE", path_class):
            sz = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(0, sz - 8))
    except FileNotFoundError:
        pass


def _crash_point(name: str, path_class: str | None) -> None:
    if ERRSIM.should_fire(name, path_class):
        raise InjectedError(f"{name} ({path_class})")


# ------------------------------------------------------------ file I/O


def write_atomic(path: str, payload: bytes, fsync: bool = True,
                 path_class: str | None = None) -> None:
    """Envelope + tmp -> flush -> fsync -> rename -> fsync-dir. Crash
    points at every boundary let the crash-consistency harness kill the
    writer mid-sequence; a torn write is invisible (tmp never renamed)
    and a renamed file is complete."""
    data = apply_write_faults(wrap(payload), path_class)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    if ERRSIM.should_fire("EN_CRASH_TMP_PARTIAL", path_class):
        # die mid-write: a partial tmp file is left behind (never renamed,
        # so recovery must simply ignore it)
        with open(tmp, "wb") as f:
            f.write(data[:max(1, len(data) // 2)])
        raise InjectedError(f"EN_CRASH_TMP_PARTIAL ({path_class})")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    _crash_point("EN_CRASH_BEFORE_RENAME", path_class)
    os.replace(tmp, path)
    _crash_point("EN_CRASH_AFTER_RENAME", path_class)
    if fsync and d:
        try:
            dfd = os.open(d, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def read_verified(path: str, path_class: str | None = None) -> bytes:
    """The single verified read path: FileNotFoundError means *missing*
    (a legitimate state, e.g. no checkpoint yet); CorruptBlock means the
    file exists but failed verification — the two are never conflated."""
    apply_read_faults(path, path_class)
    with open(path, "rb") as f:
        data = f.read()
    return unwrap(data, path)


def verify_file(path: str, path_class: str | None = None) -> int:
    """Scrubber entry point: verify one file's envelope, returning the
    payload length. Raises FileNotFoundError / CorruptBlock."""
    return len(read_verified(path, path_class))


def quarantine_file(path: str, reason: str = "") -> str | None:
    """Move a corrupt file into a sibling quarantine/ directory so it is
    kept for forensics but NEVER re-read on the hot path (re-reading a
    bad file on every boot/scan is the bug this exists to kill).
    Returns the quarantine path, or None when the move failed."""
    try:
        d = os.path.dirname(path) or "."
        qdir = os.path.join(d, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        base = os.path.basename(path)
        dst = os.path.join(qdir, base)
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(qdir, f"{base}.{n}")
        os.replace(path, dst)
        return dst
    except OSError:
        return None
