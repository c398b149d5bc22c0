"""The storage-integrity envelope of spill segments.

Counterpart of the envelope half of `oceanbase_tpu/storage/integrity.py`
(`wrap`, `unwrap`, `CorruptBlock` and the SPILL path class), without its
fault-injection arms: a fixed 20-byte header in front of the payload,

    magic u32 | version u16 | flags u16 | length u64 | crc32 u32

crc32 (zlib) covers the payload and the length must match the remaining
bytes exactly, so truncation and bit flips surface as a typed
CorruptBlock, never as a half-parsed segment.
"""

from __future__ import annotations

import struct
import zlib

MAGIC = 0x0B5EA1ED
VERSION = 1
_HDR = struct.Struct("<IHHQI")  # magic, version, flags, length, crc32
HEADER_SIZE = _HDR.size

# path class of the grace-hash spill segments (storage/tmp_file.py)
SPILL = "spill"


class CorruptBlock(Exception):
    """A persisted block failed integrity verification."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt block {path}: {reason}")
        self.path = path
        self.reason = reason


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
