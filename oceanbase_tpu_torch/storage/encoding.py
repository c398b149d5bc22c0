"""The planning half of the per-column encodings (host side).

Counterpart of `oceanbase_tpu/storage/encoding.py:28-141` without the
native codec: the one-pass column statistics and the cost model that
picks RAW, CONST, FOR (frame of reference at byte width) or RLE. The
streaming stager (`engine/pipeline.py`) freezes its wire plan from
these, so it must pick what the JAX stager picks; the reference's numpy
branch of `analyze_ints` gives the same (vmin, vmax, nruns) as its
native one, and is the one kept here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ENC_RAW = 0
ENC_CONST = 1
ENC_FOR = 2
ENC_RLE = 3


@dataclass(frozen=True)
class ColumnStats:
    vmin: int
    vmax: int
    nruns: int


def analyze_ints(a: np.ndarray) -> ColumnStats:
    """min/max/run-count (cost model input + zone map)."""
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
