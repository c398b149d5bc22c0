"""Spill operators: sort/join/group-by over data larger than one device
batch, with host tmp-file runs between device passes.

Counterpart of `oceanbase_tpu/ops/spill.py`. Reference surface: the
spill paths of the vectorized operators -- external merge sort via tmp
files (sql/engine/sort), partitioned hash join (ObHJPartition,
sql/engine/join/hash_join) and hash-agg partitioning
(ob_hp_infras_vec_op.h), all backed by storage/tmp_file.

The device processes fixed-size chunks (sorted runs, hash partitions)
and the host streams spilled segments, so host memory stays bounded by
the chunk size:

  external_sort           device-sorts chunks into runs (K3), then
                          streaming 2-way merges of page-sized blocks
  partitioned_groupby_sum hash-partition rows to segment files, a device
                          hash group-by per partition (K29), concatenate
  partitioned_join_sum    hash-partition both sides, a device hash join
                          per partition pair (K14) and its matched
                          product sum (K30)

Keys are int64 (dict codes / dates / ints -- the engine's universal key
domain). Each public function runs its device steps on `device` (None:
``cuda:0``, raising without CUDA; the tests pass ``"cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as resolve_device
from ..kernels import hash_groupby, join_product_sum, sort_order
from ..storage.tmp_file import TmpFileManager
from .hashing import next_pow2
from .join import build_hash_table, hash_join_probe

_TOP_BIT = np.uint64(1 << 63)


def pack_sort_key(cols: list[np.ndarray], descending: list[bool]) -> np.ndarray:
    """Pack multiple int columns into one orderable uint64 composite.

    Each column is offset to non-negative and bit-packed MSB-first; a
    descending column packs its complement. Raises if the combined bit
    width exceeds 64 (callers fall back to single-key sorts)."""
    widths = []
    shifted = []
    for c, desc in zip(cols, descending):
        c = c.astype(np.int64)
        lo, hi = int(c.min()), int(c.max())
        span = hi - lo
        w = max(1, int(span).bit_length())
        v = (c - lo).astype(np.uint64)
        if desc:
            v = np.uint64(span) - v
        widths.append(w)
        shifted.append(v)
    if sum(widths) > 64:
        raise ValueError(f"sort key too wide: {sum(widths)} bits")
    out = np.zeros(len(cols[0]), dtype=np.uint64)
    for v, w in zip(shifted, widths):
        out = (out << np.uint64(w)) | v
    return out


def sort_image(key: np.ndarray) -> np.ndarray:
    """A key K3 takes with the same order: uint64 (which K3 has no type
    for) maps to int64 with its top bit flipped, narrower unsigned types
    widen to int64, signed and float keys stay as they are."""
    key = np.asarray(key)
    if key.dtype == np.uint64:
        return (key ^ _TOP_BIT).view(np.int64)
    if key.dtype.kind == "u" and key.dtype != np.uint8:
        return key.astype(np.int64)
    return key


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dev.type == "cpu" else t.to(dev)


def _device_sort_chunk(key: torch.Tensor) -> torch.Tensor:
    """The stable ascending order of one chunk's key (K3; ties by row, as
    jnp.argsort's stable sort breaks them)."""
    live = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    return sort_order([key], [False], live)


class _RunCursor:
    """Streams one sorted run (a list of page segment files) page by page;
    holds at most one page in memory."""

    def __init__(self, pages: list[str], tmp: TmpFileManager):
        self.pages = pages
        self.tmp = tmp
        self.cur: dict[str, np.ndarray] | None = None
        self.pos = 0
        self._advance()

    def _advance(self):
        while self.pages and (
            self.cur is None or self.pos >= len(self.cur["__key__"])
        ):
            path = self.pages.pop(0)
            self.cur = self.tmp.read_segment(path)
            self.tmp.free_segment(path)
            self.pos = 0
        if self.cur is not None and self.pos >= len(self.cur["__key__"]):
            self.cur = None

    @property
    def head(self):
        return None if self.cur is None else self.cur["__key__"][self.pos]

    def take_until(self, limit_key, max_rows: int) -> dict[str, np.ndarray]:
        """Consume up to max_rows rows with key <= limit_key (or all
        remaining in the current page if limit_key is None)."""
        k = self.cur["__key__"]
        end = min(self.pos + max_rows, len(k))
        if limit_key is not None:
            end = min(end, self.pos + int(np.searchsorted(
                k[self.pos:end], limit_key, side="right")))
            end = max(end, self.pos + 1)
        out = {c: v[self.pos:end] for c, v in self.cur.items()}
        self.pos = end
        self._advance()
        return out


def external_sort(
    cols: dict[str, np.ndarray],
    key: np.ndarray,
    chunk_rows: int,
    tmp: TmpFileManager,
    page_rows: int | None = None,
    device=None,
) -> dict[str, np.ndarray]:
    """Sort columns by an int/uint key using bounded working memory.

    Device-sorts `chunk_rows`-sized runs (K3) spilled as page files, then
    streaming 2-way merges that hold O(page_rows) rows per input run and
    flush output pages as they fill -- classic external merge sort. (The
    returned dict materializes the final order; callers sorting beyond
    host memory consume the final run's pages instead.)"""
    dev = resolve_device(device)
    n = len(key)
    page_rows = page_rows or max(1024, chunk_rows // 8)
    names = list(cols)
    image = sort_image(key)

    # phase 1: sorted runs (device order per chunk), paged on disk
    runs: list[list[str]] = []
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        order = _device_sort_chunk(_to_device(image[s:e], dev)).cpu().numpy()
        pages = []
        for ps in range(0, e - s, page_rows):
            pe = min(ps + page_rows, e - s)
            pidx = order[ps:pe]
            seg = {"__key__": key[s:e][pidx]}
            for c in names:
                seg[c] = cols[c][s:e][pidx]
            pages.append(tmp.write_segment(seg))
        runs.append(pages)
    if not runs:
        return {c: cols[c][:0] for c in names} | {"__key__": key[:0]}

    def merge(pa: list[str], pb: list[str]) -> list[str]:
        a, b = _RunCursor(pa, tmp), _RunCursor(pb, tmp)
        out_pages: list[str] = []
        buf: list[dict[str, np.ndarray]] = []
        buffered = 0

        def flush():
            nonlocal buf, buffered
            if buf:
                merged = {
                    k: np.concatenate([p[k] for p in buf]) for k in buf[0]
                }
                out_pages.append(tmp.write_segment(merged))
                buf, buffered = [], 0

        while a.head is not None or b.head is not None:
            if b.head is None or (a.head is not None and a.head <= b.head):
                part = a.take_until(b.head, page_rows)
            else:
                part = b.take_until(a.head, page_rows)
            buf.append(part)
            buffered += len(part["__key__"])
            if buffered >= page_rows:
                flush()
        flush()
        return out_pages

    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(merge(runs[i], runs[i + 1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt

    parts = []
    for path in runs[0]:
        parts.append(tmp.read_segment(path))
        tmp.free_segment(path)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _partition(
    cols: dict[str, np.ndarray], key: np.ndarray, n_parts: int,
    tmp: TmpFileManager,
) -> list[list[str]]:
    """Hash-partition rows into per-partition segment files."""
    h = (key.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
    part = (h % np.uint64(n_parts)).astype(np.int64)
    segs: list[list[str]] = [[] for _ in range(n_parts)]
    for p in range(n_parts):
        m = part == p
        if m.any():
            seg = {c: cols[c][m] for c in cols} | {"__key__": key[m]}
            segs[p].append(tmp.write_segment(seg))
    return segs


def _device_groupby_sum(key: torch.Tensor, vals: torch.Tensor, ts: int):
    """SUM and COUNT of one partition by key (K29): (keys [T], sums [T],
    counts [T], slot_used [T]); unused slots hold key 0."""
    live = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    _rs, _sr, used, (keys,), (sums, cnts) = hash_groupby(
        [key], live, [("sum", vals.to(torch.int64)), ("count", None)], ts)
    return keys, sums, cnts, used


def partitioned_groupby_sum(
    key: np.ndarray, vals: np.ndarray, n_parts: int, tmp: TmpFileManager,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SUM/COUNT group-by over arbitrary row counts: hash partitions spill
    to tmp files, each partition aggregates on the device. Returns (keys,
    sums, counts)."""
    dev = resolve_device(device)
    segs = _partition({"v": vals}, key, n_parts, tmp)
    ks, ss, cs = [], [], []
    for plist in segs:
        if not plist:
            continue
        seg = tmp.read_segment(plist[0])
        tmp.free_segment(plist[0])
        k, v = seg["__key__"], seg["v"]
        ts = next_pow2(max(2 * len(np.unique(k)), 16))
        ko, so, co, used = (x.cpu().numpy() for x in _device_groupby_sum(
            _to_device(k, dev), _to_device(v, dev), ts))
        ks.append(ko[used])
        ss.append(so[used])
        cs.append(co[used])
    if not ks:
        z = np.zeros(0, np.int64)
        return z, z, z
    return np.concatenate(ks), np.concatenate(ss), np.concatenate(cs)


def _device_join_sum(lk: torch.Tensor, lv: torch.Tensor, rk: torch.Tensor,
                     rv: torch.Tensor, ts: int):
    """One partition pair of the unique-build join: the build table and
    the probe (K14), then sum(lv * rv) over the matches and their count
    (K30), int64 0-d tensors."""
    rsel = torch.ones(rk.shape[0], dtype=torch.bool, device=rk.device)
    lsel = torch.ones(lk.shape[0], dtype=torch.bool, device=lk.device)
    slot_tag, slot_row = build_hash_table([rk], rsel, ts)
    match = hash_join_probe(slot_tag, slot_row, [rk], [lk], lsel)
    return join_product_sum(lv, rv, match)


def partitioned_join_sum(
    lkey: np.ndarray, lval: np.ndarray,
    rkey: np.ndarray, rval: np.ndarray,
    n_parts: int, tmp: TmpFileManager, device=None,
) -> tuple[int, int]:
    """Unique-build hash join over arbitrary sizes: co-partition both
    sides to tmp files, join each partition pair on the device. Returns
    (sum(lval*rval over matches), match count), the products and the sum
    wrapping as int64."""
    dev = resolve_device(device)
    lsegs = _partition({"v": lval}, lkey, n_parts, tmp)
    rsegs = _partition({"v": rval}, rkey, n_parts, tmp)
    total = np.int64(0)
    matches = np.int64(0)
    for p in range(n_parts):
        if not lsegs[p] or not rsegs[p]:
            for plist in (lsegs[p], rsegs[p]):
                for path in plist:
                    tmp.free_segment(path)
            continue
        ls = tmp.read_segment(lsegs[p][0])
        rs = tmp.read_segment(rsegs[p][0])
        tmp.free_segment(lsegs[p][0])
        tmp.free_segment(rsegs[p][0])
        ts = next_pow2(max(2 * len(rs["__key__"]), 16))
        s, m = _device_join_sum(
            _to_device(ls["__key__"], dev), _to_device(ls["v"], dev),
            _to_device(rs["__key__"], dev), _to_device(rs["v"], dev), ts)
        with np.errstate(over="ignore"):
            total += np.int64(int(s))
            matches += np.int64(int(m))
    return int(total), int(matches)
