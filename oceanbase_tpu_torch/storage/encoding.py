"""Per-column micro-block encodings (host side).

Counterpart of `oceanbase_tpu/storage/encoding.py` (reference surface:
storage/blocksstable/encoding + cs_encoding): four byte-aligned encodings,
RAW, CONST, FOR (frame of reference at byte width) and RLE, chosen per
block by a one-pass cost model. The port keeps the reference's numpy
implementation, whose wire format the native C++ codec there shares, and
no native codec: the streaming stager (`engine/pipeline.py`) and the
storage engine read and write the same bytes as the JAX package.

Floats are stored RAW (or CONST); integers, dates, dictionary codes and
decimals go through the integer encodings. Validity (null) bitmaps are
packed little-endian with np.packbits(bitorder="little").
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np


ENC_RAW = 0
ENC_CONST = 1
ENC_FOR = 2
ENC_RLE = 3

def crc32(data: bytes | np.ndarray, seed: int = 0) -> int:
    b = data.tobytes() if isinstance(data, np.ndarray) else data
    return zlib.crc32(b, seed) & 0xFFFFFFFF


@dataclass(frozen=True)
class ColumnStats:
    vmin: int
    vmax: int
    nruns: int


def analyze_ints(a: np.ndarray) -> ColumnStats:
    """min/max/run-count in one pass (cost model input + zone map)."""
    if len(a) == 0:
        return ColumnStats(0, 0, 0)
    vmin = int(a.min())
    vmax = int(a.max())
    nruns = int(1 + np.count_nonzero(a[1:] != a[:-1])) if len(a) > 1 else 1
    return ColumnStats(vmin, vmax, nruns)


def _for_width(span: int) -> int:
    if span < (1 << 8):
        return 1
    if span < (1 << 16):
        return 2
    if span < (1 << 32):
        return 4
    return 8


def choose_encoding(a: np.ndarray, stats: ColumnStats) -> tuple[int, dict]:
    """Pick the cheapest encoding; returns (enc, params)."""
    n = len(a)
    if not np.issubdtype(a.dtype, np.integer):
        if n and bool(np.all(a == a.flat[0])):
            return ENC_CONST, {}
        return ENC_RAW, {}
    if n == 0:
        return ENC_RAW, {}
    if stats.vmin == stats.vmax:
        return ENC_CONST, {}
    span = stats.vmax - stats.vmin
    width = _for_width(span)
    for_bytes = n * width
    rle_bytes = 4 + stats.nruns * (4 + a.dtype.itemsize)
    raw_bytes = n * a.dtype.itemsize
    best = min(for_bytes, rle_bytes, raw_bytes)
    if best == rle_bytes:
        return ENC_RLE, {}
    if best == for_bytes and for_bytes < raw_bytes:
        return ENC_FOR, {"min": stats.vmin, "width": width}
    return ENC_RAW, {}


_HINT_ENCS = {"raw": ENC_RAW, "const": ENC_CONST, "for": ENC_FOR,
              "rle": ENC_RLE}


def hinted_encoding(a: np.ndarray, stats: ColumnStats,
                    hint: str) -> tuple[int, dict] | None:
    """Resolve an advisor encoding hint ("for"/"rle"/"const"/"raw") to
    (enc, params), or None when the hint cannot be honored losslessly on
    THIS block — a hint is a cost-model preference, never a correctness
    override (e.g. "const" on a block that stopped being constant)."""
    e = _HINT_ENCS.get(hint)
    if e is None or len(a) == 0 or not np.issubdtype(a.dtype, np.integer):
        return None
    if e == ENC_CONST:
        return (ENC_CONST, {}) if stats.vmin == stats.vmax else None
    if e == ENC_FOR:
        return ENC_FOR, {"min": stats.vmin,
                         "width": _for_width(stats.vmax - stats.vmin)}
    return e, {}


# ------------------------------------------------------------- encoders

def encode_column(a: np.ndarray, enc: int, params: dict) -> bytes:
    a = np.ascontiguousarray(a)
    if enc == ENC_RAW:
        return a.tobytes()
    if enc == ENC_CONST:
        return a[:1].tobytes()
    if enc == ENC_FOR:
        return _for_encode(a, params["min"], params["width"])
    if enc == ENC_RLE:
        return _rle_encode(a)
    raise ValueError(f"unknown encoding {enc}")


def decode_column(buf: memoryview | bytes, enc: int, params: dict,
                  dtype: np.dtype, n: int) -> np.ndarray:
    if enc == ENC_RAW:
        return np.frombuffer(buf, dtype=dtype, count=n).copy()
    if enc == ENC_CONST:
        v = np.frombuffer(buf, dtype=dtype, count=1)
        return np.full(n, v[0], dtype=dtype)
    if enc == ENC_FOR:
        return _for_decode(buf, params["min"], params["width"], dtype, n)
    if enc == ENC_RLE:
        return _rle_decode(buf, dtype, n)
    raise ValueError(f"unknown encoding {enc}")


def _for_encode(a: np.ndarray, vmin: int, width: int) -> bytes:
    udt = np.dtype(f"u{width}")
    deltas = (a.astype(np.int64) - vmin).astype(udt)
    return deltas.tobytes()


def _for_decode(buf, vmin: int, width: int, dtype: np.dtype, n: int) -> np.ndarray:
    udt = np.dtype(f"u{width}")
    deltas = np.frombuffer(buf, dtype=udt, count=n).astype(np.int64)
    return (deltas + vmin).astype(dtype)


def _rle_encode(a: np.ndarray) -> bytes:
    if len(a) == 0:
        return np.uint32(0).tobytes()
    starts = np.flatnonzero(np.concatenate(([True], a[1:] != a[:-1])))
    lens = np.diff(np.concatenate((starts, [len(a)]))).astype(np.uint32)
    vals = a[starts]
    nruns = np.uint32(len(starts))
    # interleave {u32 len, value} pairs
    pair = np.dtype([("len", np.uint32), ("val", a.dtype)], align=False)
    runs = np.empty(len(starts), dtype=pair)
    runs["len"] = lens
    runs["val"] = vals
    return nruns.tobytes() + runs.tobytes()


def _rle_decode(buf, dtype: np.dtype, n: int) -> np.ndarray:
    dtype = np.dtype(dtype)
    raw = np.frombuffer(buf, dtype=np.uint8)
    nruns = int(np.frombuffer(raw, dtype=np.uint32, count=1)[0])
    pair = np.dtype([("len", np.uint32), ("val", dtype)], align=False)
    runs = np.frombuffer(raw, dtype=pair, count=nruns, offset=4)
    out = np.repeat(runs["val"], runs["len"].astype(np.int64))
    if len(out) != n:
        raise ValueError(f"RLE decoded {len(out)} rows, expected {n}")
    return out


# ----------------------------------------------------- validity bitmaps

def pack_validity(valid: np.ndarray) -> bytes:
    return np.packbits(valid.astype(np.bool_), bitorder="little").tobytes()


def unpack_validity(buf, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8), bitorder="little")
    return bits[:n].astype(np.bool_)
