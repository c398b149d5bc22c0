"""Streaming pipeline engine: the out-of-core data path.

Counterpart of `oceanbase_tpu/engine/pipeline.py`. Three mechanisms,
composed by engine/chunked.ChunkedPreparedPlan and by the grace-hash
route of Executor.prepare:

  1. prefetch (ChunkPrefetcher): while chunk k's program runs, chunk k+1
     is host-encoded and its host-to-device copy is in flight on a staging
     thread with its own CUDA stream. The queue depth bounds the staged
     chunks in flight; each holds a governor staged lease, released only
     after the device work that reads its buffers has finished, and
     released on every exit (the ledger balances even when a statement
     dies with a prefetch in flight).

  2. compressed chunk streaming with decode on the device (ChunkStager +
     kernel K18): each streamed column freezes a wire plan on its first
     chunk -- FOR (frame of reference at byte width), RLE (run values +
     run lengths at a frozen power-of-two run capacity) or raw -- chosen
     by the storage encodings' cost model (storage/encoding.py). The copy
     carries the encoded bytes; K18 expands them on the device in one
     launch, so the chunk program sees full-width columns. A chunk outside
     its frozen frame ships raw for that chunk: never a wrong answer.

  3. grace-hash partitioned join/group-by (GraceHashPreparedPlan): when
     the build side also exceeds the budget (chunked.NotStreamable), both
     sides hash-partition by a join key into host tmp-file segments
     (storage/tmp_file.py), and one program -- the split subtree over
     fixed-capacity $live-masked overlay tables -- runs each partition
     pair. Group-by mode partitions one table by a GROUP BY key, so even
     a count distinct is exact per partition and the merge concatenates.

OverlapMeter accounts the host-to-device and compute walls exactly (an
interval union), so the overlap is measured, not assumed.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import contextmanager
from dataclasses import replace as dc_replace

import numpy as np
import torch

from .. import kernels as K
from ..core.column import ColumnBatch, to_numpy, torch_dtype
from ..core.dtypes import DataType, Field, Schema
from ..core.table import Table
from ..expr import ir as E
from ..share import gap_ledger as _gap
from ..share.interrupt import checkpoint
from ..sql.logical import (
    Aggregate,
    Filter,
    JoinOp,
    Project,
    Scan,
    output_schema,
)
from ..storage.encoding import ENC_FOR, ENC_RLE, analyze_ints, choose_encoding

# ---------------------------------------------------------------------------
# telemetry


class StreamStats:
    """Cumulative streaming counters carried by a prepared plan; the
    session reads per-run deltas (snapshot-diff)."""

    __slots__ = ("chunks", "staged_bytes", "decoded_bytes", "h2d_s",
                 "compute_s", "overlap_s", "spill_partitions")

    def __init__(self):
        self.chunks = 0
        self.staged_bytes = 0
        self.decoded_bytes = 0
        self.h2d_s = 0.0
        self.compute_s = 0.0
        self.overlap_s = 0.0
        self.spill_partitions = 0

    def snapshot(self) -> tuple:
        return (self.chunks, self.staged_bytes, self.decoded_bytes,
                self.h2d_s, self.compute_s, self.overlap_s,
                self.spill_partitions)


class OverlapMeter:
    """Exact interval-union accounting of two activity sides ("h2d" and
    "compute"): on every enter/exit the slice since the previous event is
    credited to whichever sides were active -- and to `overlap_s` when
    both were. Thread-safe (the prefetch thread meters h2d while the
    consumer meters compute)."""

    def __init__(self, clock=time.perf_counter):
        self._lock = threading.Lock()
        self._clock = clock
        self._active = {"h2d": 0, "compute": 0}
        self._last: float | None = None
        self.h2d_s = 0.0
        self.compute_s = 0.0
        self.overlap_s = 0.0

    def _account(self, now: float) -> None:
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                h = self._active["h2d"] > 0
                c = self._active["compute"] > 0
                if h:
                    self.h2d_s += dt
                if c:
                    self.compute_s += dt
                if h and c:
                    self.overlap_s += dt
        self._last = now

    def enter(self, side: str) -> None:
        with self._lock:
            self._account(self._clock())
            self._active[side] += 1

    def exit(self, side: str) -> None:
        with self._lock:
            self._account(self._clock())
            self._active[side] = max(0, self._active[side] - 1)

    @contextmanager
    def track(self, side: str):
        self.enter(side)
        try:
            yield
        finally:
            self.exit(side)


# ---------------------------------------------------------------------------
# compressed chunk staging + decode on the device

# wire-plan entry kinds (per streamed column, frozen on first chunk)
_W_RAW = "raw"      # full storage width, zero base
_W_FOR = "for"      # frame-of-reference: narrow deltas + base
_W_RLE = "rle"      # run values (narrow) + run lengths, frozen run cap
_W_BITS = "bits"    # validity bitmap, packbits little-endian

_NARROW = (np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.uint32))


def _narrow_for(span: int) -> np.dtype | None:
    for dt in _NARROW:
        if span <= int(np.iinfo(dt).max):
            return dt
    return None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class ChunkStager:
    """Host-side encoder for one streamed table: freezes a per-column
    wire plan on first chunk (cost model: storage/encoding), then turns
    each [start, end) window into a staged tree of wire-encoded numpy
    arrays whose shapes are constant across chunks. `compress=False` pins
    every column to the raw/FOR baseline (the A/B lever)."""

    def __init__(self, table: Table, cols, cap: int, compress: bool = True):
        self.table = table
        self.cols = tuple(sorted(set(cols)))
        self.cap = int(cap)
        self.compress = compress
        self.sub_schema = Schema(tuple(
            f for f in table.schema.fields if f.name in self.cols))
        # key -> (_W_*, narrow_dtype|None, base, run_cap) frozen entries
        self._plan: dict[str, tuple] = {}
        self.dtypes = {f.name: torch_dtype(f.dtype.storage_np)
                       for f in self.sub_schema.fields}
        for c in table.valid:
            if c in self.cols:
                self.dtypes[f"#v:{c}"] = torch.bool

    # -------------------------------------------------------- wire plan
    def _freeze(self, key: str, full: np.ndarray, storage: np.dtype) -> tuple:
        hit = self._plan.get(key)
        if hit is not None:
            return hit
        a = np.asarray(full)
        entry = (_W_RAW, None, 0, 0)
        if np.dtype(storage).kind in "iu" and a.ndim == 1 and len(a):
            st = analyze_ints(a.astype(np.int64, copy=False))
            span = st.vmax - st.vmin
            nt = _narrow_for(span)
            enc = _W_RAW
            if self.compress:
                e, _p = choose_encoding(a.astype(np.int64, copy=False), st)
                if e == ENC_RLE:
                    enc = _W_RLE
                elif e == ENC_FOR and nt is not None and (
                        nt.itemsize < np.dtype(storage).itemsize):
                    enc = _W_FOR
            elif nt is not None and nt.itemsize < np.dtype(storage).itemsize:
                # the baseline keeps the plain FOR narrowing
                enc = _W_FOR
            if enc == _W_RLE and nt is None:
                enc = _W_RAW
            if enc == _W_RLE:
                # frozen run capacity: 2x the table-wide per-chunk run
                # density (a chunk of cap rows holds ~nruns*cap/n runs),
                # clamped to the chunk capacity itself
                n = max(len(a), 1)
                est = int(st.nruns * self.cap / n) + 1
                run_cap = min(_next_pow2(max(2 * est, 16)), self.cap)
                entry = (_W_RLE, nt, st.vmin, run_cap)
            elif enc == _W_FOR:
                entry = (_W_FOR, nt, st.vmin, 0)
        self._plan[key] = entry
        return entry

    # ---------------------------------------------------------- staging
    def stage(self, s: int, e: int):
        """Encode one window. Returns (staged, bases, meta, wire_bytes,
        decoded_bytes): `staged` is the host tree to copy to the device,
        `meta` the decode plan for THIS chunk (normally the frozen plan;
        a frame-violating chunk degrades its column to raw)."""
        t = self.table
        cap = self.cap
        staged: dict = {}
        bases: dict = {}
        meta: list[tuple[str, str]] = []
        decoded = 0

        def add_raw(key, a, storage):
            pad = cap - len(a)
            if pad:
                a = np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)])
            staged[key] = np.ascontiguousarray(a, dtype=storage)
            bases[key] = np.dtype(storage).type(0)
            meta.append((key, _W_RAW))

        def add(key, full, storage):
            nonlocal decoded
            a = np.asarray(full[s:e], dtype=storage)
            decoded += cap * np.dtype(storage).itemsize
            kind, nt, base, run_cap = self._freeze(key, full, storage)
            if kind == _W_RLE:
                starts = np.flatnonzero(
                    np.concatenate(([True], a[1:] != a[:-1]))
                ) if len(a) else np.zeros(0, np.int64)
                nruns = len(starts)
                if 0 < nruns <= run_cap:
                    vals = a[starts].astype(np.int64) - base
                    if int(vals.min()) >= 0 and int(vals.max()) <= int(
                            np.iinfo(nt).max):
                        lens = np.diff(
                            np.concatenate((starts, [len(a)]))
                        ).astype(np.int32)
                        vpad = np.zeros(run_cap - nruns, dtype=nt)
                        lpad = np.zeros(run_cap - nruns, dtype=np.int32)
                        staged[key] = (
                            np.concatenate([vals.astype(nt), vpad]),
                            np.concatenate([lens, lpad]),
                        )
                        bases[key] = np.dtype(storage).type(base)
                        meta.append((key, _W_RLE))
                        return
                # run blow-up / frame violation: this chunk ships wide
                add_raw(key, a, storage)
                return
            if kind == _W_FOR:
                d = a.astype(np.int64) - base
                if len(d) == 0 or (int(d.min()) >= 0 and int(d.max())
                                   <= int(np.iinfo(nt).max)):
                    d = d.astype(nt)
                    pad = cap - len(d)
                    if pad:
                        # pad INSIDE the frame (zero delta = table min)
                        d = np.concatenate([d, np.zeros(pad, dtype=nt)])
                    staged[key] = d
                    bases[key] = np.dtype(storage).type(base)
                    meta.append((key, _W_FOR))
                    return
                add_raw(key, a, storage)
                return
            add_raw(key, a, storage)

        for f in self.sub_schema.fields:
            add(f.name, t.data[f.name], f.dtype.storage_np)
        for c, v in t.valid.items():
            if c in self.cols:
                decoded += cap
                bits = np.packbits(
                    np.asarray(v[s:e], np.bool_), bitorder="little")
                nbytes = (cap + 7) >> 3
                if len(bits) < nbytes:
                    # pad rows read as INVALID; sel masks them anyway
                    bits = np.concatenate(
                        [bits, np.zeros(nbytes - len(bits), np.uint8)])
                staged[f"#v:{c}"] = bits
                meta.append((f"#v:{c}", _W_BITS))

        wire = sum(
            (a[0].nbytes + a[1].nbytes) if isinstance(a, tuple) else a.nbytes
            for a in staged.values())
        return staged, bases, tuple(sorted(meta)), wire, decoded

    def decode_batch(self, item: "StagedChunk", cols=None):
        """Decoded ColumnBatch of a staged chunk (kernel K18): the chunk
        executor's table read of the streamed table. `cols` narrows the
        batch to a requested subset (must be within the staged set)."""
        want = self.cols if cols is None else tuple(sorted(set(cols)))
        decoded, sel = K.decode_staged(
            item.staged, item.bases, item.count, item.meta, self.cap,
            self.dtypes, item.device)
        dcols = {k: v for k, v in decoded.items()
                 if not k.startswith("#v:") and k in want}
        dvalid = {k[3:]: v for k, v in decoded.items()
                  if k.startswith("#v:") and k[3:] in want}
        t = self.table
        schema = self.sub_schema if want == self.cols else Schema(tuple(
            f for f in t.schema.fields if f.name in want))
        return ColumnBatch(
            cols=dcols,
            valid=dvalid,
            sel=sel,
            nrows=torch.sum(sel, dtype=torch.int64),
            schema=schema,
            dicts={c: d for c, d in t.dicts.items() if c in want},
        )


class Uploader:
    """Moves one staged tree to the device. On a CUDA device every array
    is packed into one pinned host buffer (kept and grown across chunks:
    pinning afresh per chunk costs more than the copy) and crosses in ONE
    non-blocking copy on the uploader's own stream; the arrays are views
    of one device buffer, ready once `event` has completed. On the CPU the
    arrays are wrapped without a copy. One uploader serves one thread."""

    _ALIGN = 16

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned: torch.Tensor | None = None
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def put(self, staged: dict):
        """(device tree, device buffer or None, event or None)."""
        arrays = []
        for v in staged.values():
            arrays.extend(v if isinstance(v, tuple) else (v,))
        if self.device.type != "cuda":
            return ({k: (tuple(torch.from_numpy(x) for x in v)
                         if isinstance(v, tuple) else torch.from_numpy(v))
                     for k, v in staged.items()}, None, None)
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // self._ALIGN) * self._ALIGN
        if self._pinned is None or self._pinned.numel() < total:
            self._pinned = torch.empty(max(total, 1), dtype=torch.uint8,
                                       pin_memory=True)
        host = self._pinned.numpy()
        for a, o in zip(arrays, offs):
            host[o:o + a.nbytes] = a.view(np.uint8).reshape(-1)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            buf = torch.empty(max(total, 1), dtype=torch.uint8,
                              device=self.device)
            buf.copy_(self._pinned[:max(total, 1)], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        views = iter(
            buf[o:o + a.nbytes].view(torch_dtype_any(a.dtype))
            for a, o in zip(arrays, offs))
        tree = {k: (tuple(next(views) for _ in v) if isinstance(v, tuple)
                    else next(views))
                for k, v in staged.items()}
        return tree, buf, event


def torch_dtype_any(np_dtype) -> torch.dtype:
    """torch dtype of a staged array, the narrow unsigned types included."""
    dt = np.dtype(np_dtype)
    if dt == np.uint16:
        return torch.uint16
    if dt == np.uint32:
        return torch.uint32
    return torch_dtype(dt)


class StagedChunk:
    """One wire-encoded chunk on the device (its copy possibly still in
    flight): the prefetcher's unit of work. Holds the governor staged
    lease for its wire bytes; release is idempotent and always reached
    (drain path or prefetcher close)."""

    __slots__ = ("win", "staged", "bases", "meta", "count", "wire_bytes",
                 "decoded_bytes", "lease", "device", "buffer", "event")

    def __init__(self, win, staged, bases, meta, count, wire_bytes,
                 decoded_bytes, lease, device=None, buffer=None, event=None):
        self.win = win
        self.staged = staged
        self.bases = bases
        self.meta = meta
        self.count = count
        self.wire_bytes = wire_bytes
        self.decoded_bytes = decoded_bytes
        self.lease = lease
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.buffer = buffer
        self.event = event

    def bind_consumer(self) -> None:
        """Order the consumer's stream after the copy, and tell the
        caching allocator that the consumer's stream reads the buffer (so
        its memory is not handed out again while K18 may still read it)."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            self.buffer.record_stream(stream)

    def release(self) -> None:
        if self.lease is not None:
            self.lease.release()


def stage_chunk(stager: ChunkStager, uploader: Uploader, win, meter,
                governor=None, tenant: str = "sys") -> StagedChunk:
    """Encode one window and copy it to the device under a staged lease;
    the copy's wall (until its event completes) is the meter's h2d."""
    s, e = win
    staged, bases, meta, wire, dec = stager.stage(s, e)
    lease = governor.stage(tenant, wire) if governor is not None else None
    try:
        with meter.track("h2d"):
            tree, buf, event = uploader.put(staged)
            if event is not None:
                event.synchronize()
    except BaseException:
        if lease is not None:
            lease.release()
        raise
    return StagedChunk(win, tree, bases, meta, e - s, wire, dec, lease,
                       uploader.device, buf, event)


class ChunkPrefetcher:
    """Stages chunk windows `depth` ahead of the consumer on a small
    thread (host encode, the copy on the thread's own stream, the wait on
    its event: the h2d side of the overlap meter runs here, concurrent
    with the consumer's compute side). The bounded queue is the
    backpressure: at most `depth` staged chunks wait, each holding a
    governor staged lease. close() drains and releases everything."""

    _SENTINEL = object()

    def __init__(self, stager: ChunkStager, windows, depth: int,
                 meter: OverlapMeter, governor=None, tenant: str = "sys",
                 device="cpu"):
        self.stager = stager
        self.windows = list(windows)
        self.depth = max(1, int(depth))
        self.meter = meter
        self.governor = governor
        self.tenant = tenant
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._closed = threading.Event()
        self._exc: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, name="ob-stream-prefetch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                # the current device is per thread
                torch.cuda.set_device(self.device)
            uploader = Uploader(self.device)
            for win in self.windows:
                if self._closed.is_set():
                    return
                item = stage_chunk(self.stager, uploader, win, self.meter,
                                   self.governor, self.tenant)
                while not self._closed.is_set():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    item.release()
                    return
        except BaseException as exc:  # surfaced at the consumer's get()
            self._exc = exc
        finally:
            while True:
                try:
                    self._q.put(self._SENTINEL, timeout=0.05)
                    break
                except queue.Full:
                    if self._closed.is_set():
                        break

    def get(self) -> StagedChunk | None:
        """Next staged chunk, or None when the stream is exhausted.
        Re-raises a staging error on the consumer thread."""
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._exc is not None and self._q.empty():
                    raise self._exc
                continue
            if item is self._SENTINEL:
                if self._exc is not None:
                    raise self._exc
                return None
            return item

    def close(self) -> None:
        """Stop the thread and release every undelivered staged lease.
        Idempotent; called from the consumer's finally so a statement
        error cannot leak staged bytes."""
        self._closed.set()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not self._SENTINEL:
                item.release()
        self._thread.join(timeout=5.0)
        # anything the thread pushed between drain and join
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not self._SENTINEL:
                item.release()


# ---------------------------------------------------------------------------
# sizing helpers


def decoded_row_bytes(catalog, table: str, cols) -> int:
    """Per-row DECODED (on-device) bytes of the streamed columns -- what
    chunk sizing must budget for (the staged wire bytes are charged
    through the governor's staged ledger)."""
    t = catalog[table]
    per = 0
    for c in cols:
        if c in t.schema:
            per += t.schema[c].storage_np.itemsize
        if c in t.valid:
            per += 1
    return max(per, 1)


def assemble_partials_table(partial_schema: Schema, cols, valids, dicts,
                            cap: int):
    """Concatenate per-chunk/per-partition partial outputs into the padded
    $partials overlay Table at a grow-only power-of-two capacity (the
    merge program's input shape, stable across runs). Returns
    (table, new_cap)."""
    data = {k: np.concatenate(v) for k, v in cols.items()}
    vdata = {k: np.concatenate(v) for k, v in valids.items()}
    n_part = len(next(iter(data.values()))) if data else 0
    while cap < n_part:
        cap *= 2
    pad = cap - n_part
    if pad:
        data = {
            k: np.concatenate([v, np.zeros(pad, dtype=v.dtype)])
            for k, v in data.items()
        }
        vdata = {
            k: np.concatenate([v, np.zeros(pad, dtype=np.bool_)])
            for k, v in vdata.items()
        }
    data["$live"] = np.concatenate(
        [np.ones(n_part, np.int8), np.zeros(pad, np.int8)]
    )
    part_fields = [
        Field(f.name,
              f.dtype.with_nullable(f.dtype.nullable or f.name in vdata))
        for f in partial_schema.fields
    ]
    part_fields.append(Field("$live", DataType.int8()))
    table = Table(
        "$partials", Schema(tuple(part_fields)), data,
        {k: d for k, d in dicts.items() if k in data},
        valid=vdata,
    )
    return table, cap


def _fetch_partial(partial_schema: Schema, out, ovf):
    """The host copy of one chunk's (or partition's) partial output:
    (overflow counters, columns, validity, sel)."""
    hovf = to_numpy(ovf)
    hcols = {f.name: to_numpy(out.cols[f.name])
             for f in partial_schema.fields}
    hvalid = {k: to_numpy(v) for k, v in out.valid.items() if k in hcols}
    return hovf, hcols, hvalid, to_numpy(out.sel)


def _fold_partial(partial_schema: Schema, cols, valids, hcols, hvalid,
                  hsel) -> None:
    sel = np.asarray(hsel)
    for f in partial_schema.fields:
        cols[f.name].append(np.asarray(hcols[f.name])[sel])
        v = hvalid.get(f.name)
        if v is not None:
            valids.setdefault(f.name, []).append(np.asarray(v)[sel])
        elif f.name in valids:
            valids[f.name].append(np.ones(int(sel.sum()), np.bool_))


# ---------------------------------------------------------------------------
# the pipelined chunk loop


def run_stream(cp, qparams: tuple = (), max_retries: int = 3):
    """The streaming chunk loop of ChunkedPreparedPlan: prefetch-staged
    compressed chunks, decode on the device (K18), dispatch `depth` ahead
    of the draining fetch, fold partials.

    Returns (cols, valids, dicts) accumulators for the $partials assembly.
    Overflow keeps one bump+recompile per params generation; in-flight
    siblings re-dispatch for free on the grown capacities."""
    from collections import deque

    ex = cp.executor
    dev = ex.device
    t = ex.catalog[cp.stream.table]
    n = t.nrows or 0
    stats = cp.stream_stats
    meter = OverlapMeter()

    depth = max(0, int(getattr(ex, "stream_prefetch_depth", 2)))
    compress = bool(getattr(ex, "stream_compress", True))
    governor = getattr(ex, "governor", None)
    tenant = getattr(ex, "tenant", "sys")

    windows: deque = deque()
    s = 0
    while s < n:
        e = min(s + cp.chunk_rows, n)
        windows.append((s, e))
        s = e
    if n == 0:
        windows.append((0, 0))

    # the streamed table's columns per the compiled chunk program
    stream_cols: tuple = ()
    for _alias, tname, tcols in cp.chunk_prepared.input_spec:
        if tname == cp.stream.table:
            stream_cols = tcols
            break
    stager = ChunkStager(t, stream_cols, cp.chunk_rows, compress=compress)
    cp.chunk_exec.set_stager(stager)
    # the consumer's own uploader: overflow re-stages and the
    # no-prefetch baseline stage on this thread
    uploader = Uploader(dev)

    # in-flight device residency: decoded chunk + staged wire buffers per
    # pipeline slot; cap the dispatch depth inside the device budget
    row_b = decoded_row_bytes(ex.catalog, cp.stream.table, stream_cols)
    chunk_bytes = row_b * cp.chunk_rows
    fit = max(1, int(ex.device_budget * 0.5) // max(chunk_bytes, 1))
    dispatch_depth = max(1, min(max(depth, 1) + 1, fit))

    prefetch = ChunkPrefetcher(
        stager, list(windows), depth, meter, governor=governor,
        tenant=tenant, device=dev) if depth > 0 else None

    pending: deque = deque()  # (item, gen, out, ovf)
    redispatch: deque = deque()  # overflow re-runs (StagedChunk)
    attempts_of: dict = {}
    params_gen = 0
    cols: dict[str, list] = {f.name: [] for f in cp.partial_schema.fields}
    valids: dict[str, list] = {}
    dicts: dict = {}
    drained = 0
    total = len(windows)
    prepared = cp.chunk_prepared

    def dispatch(item: StagedChunk):
        cp.chunk_exec.set_chunk_staged(item)
        try:
            with meter.track("compute"):
                item.bind_consumer()
                out, ovf = prepared.program(prepared._inputs(), qparams)
        except BaseException:
            # a failed dispatch is the item's last owner
            item.release()
            raise
        pending.append((item, params_gen, out, ovf))

    try:
        while drained < total:
            checkpoint()  # a killed query stops between chunks
            while redispatch and len(pending) < dispatch_depth:
                dispatch(redispatch.popleft())
            while (prefetch is not None and len(pending) < dispatch_depth
                   and drained + len(pending) + len(redispatch) < total):
                item = prefetch.get()
                if item is None:
                    break
                windows.popleft()
                dispatch(item)
            if prefetch is None and not pending and windows:
                # prefetch off (the A/B baseline): stage synchronously, so
                # the wire and the device strictly alternate
                dispatch(stage_chunk(stager, uploader, windows.popleft(),
                                     meter, governor, tenant))
            if not pending:
                continue
            item, gen, out, ovf = pending.popleft()
            try:
                with meter.track("compute"):
                    hovf, hcols, hvalid, hsel = _fetch_partial(
                        cp.partial_schema, out, ovf)
            except BaseException:
                # popped from pending: the finally can no longer see it
                item.release()
                raise
            overflows = prepared._overflows(np.asarray(hovf))
            if overflows:
                ws, we = item.win
                if gen == params_gen:
                    a = attempts_of.get(ws, 0)
                    if a >= max_retries:
                        item.release()
                        raise RuntimeError(
                            f"chunk [{ws},{we}) capacity overflow after "
                            f"{max_retries} retries: {overflows}")
                    attempts_of[ws] = a + 1
                    cp.retries += 1
                    prepared.retries += 1
                    prepared.params.bump(overflows)
                    prepared.recompile()
                    params_gen += 1
                redispatch.appendleft(item)
                continue
            # the fetch above waited for the chunk's program, K18 included:
            # its wire buffers are no longer read
            item.release()
            stats.chunks += 1
            stats.staged_bytes += item.wire_bytes
            stats.decoded_bytes += item.decoded_bytes
            drained += 1
            _fold_partial(cp.partial_schema, cols, valids, hcols, hvalid,
                          hsel)
            dicts.update(out.dicts)
    finally:
        try:
            if prefetch is not None:
                prefetch.close()
            if dev.type == "cuda" and (pending or redispatch):
                # queued programs may still read the remaining buffers
                torch.cuda.current_stream(dev).synchronize()
        finally:
            for item, _gen, _out, _ovf in pending:
                item.release()
            for item in redispatch:
                item.release()
            cp.chunk_exec.set_stager(None)
            stats.h2d_s += meter.h2d_s
            stats.compute_s += meter.compute_s
            stats.overlap_s += meter.overlap_s
            led = _gap.current()
            if led is not None:
                led.add("h2d", max(0.0, meter.h2d_s - meter.overlap_s))
                led.device(meter.compute_s)

    return cols, valids, dicts


# ---------------------------------------------------------------------------
# grace-hash partitioned join / group-by


class NotPartitionable(Exception):
    """The plan shape does not admit grace-hash partitioning (the caller
    falls through to the whole-table upload, as for NotStreamable)."""


def _path_to_scan(plan, scan):
    from .executor import _children

    path = []

    def find(op) -> bool:
        path.append(op)
        if op is scan:
            return True
        for c in _children(op):
            if find(c):
                return True
        path.pop()
        return False

    if not find(plan):
        raise NotPartitionable("scan not reachable")
    return path


def _streams_down(path, from_pos: int) -> bool:
    """Filter/Project-only (plus probe-side joins) below path[from_pos]."""
    for parent, child in zip(path[from_pos + 1:], path[from_pos + 2:]):
        if isinstance(parent, (Filter, Project)):
            continue
        if isinstance(parent, JoinOp):
            if child is not parent.left:
                return False
            continue
        if isinstance(parent, Scan):
            continue
        return False
    return True


def _resolve_base_col(path_tail, name: str) -> str | None:
    """Trace a column name down a Filter/Project chain to its base-table
    column (None when any hop is a computed expression). `path_tail`
    runs from the chain's top node down to the Scan."""
    cur = name
    for node in path_tail:
        if isinstance(node, Project):
            hit = None
            for out_name, expr in node.exprs:
                if out_name == cur:
                    hit = expr
                    break
            if not isinstance(hit, E.ColRef):
                return None
            cur = hit.name
        elif isinstance(node, Filter):
            continue
        elif isinstance(node, Scan):
            a, _, c = cur.partition(".")
            return c if a == node.alias and c else None
        else:
            return None
    return None


def _live_scan(scan: Scan, overlay_name: str, cols) -> Scan:
    """The scan rewritten onto its overlay partition table: same alias,
    schema narrowed to the partitioned columns plus a `$live` guard whose
    pushed predicate masks the pad rows (one program serves every
    partition)."""
    live = E.Compare("=", E.ColRef(f"{scan.alias}.$live"), E.lit(1))
    pushed = live if scan.pushed_filter is None else E.BoolOp(
        "and", (scan.pushed_filter, live))
    fields = tuple(
        f for f in scan.schema.fields
        if f.name.split(".", 1)[1] in cols
    ) + (Field(f"{scan.alias}.$live", DataType.int8()),)
    return dc_replace(
        scan, table=overlay_name, schema=Schema(fields),
        pushed_filter=pushed, needed=None)


def _hash_partition(n_parts: int, key: np.ndarray) -> np.ndarray:
    h = (key.astype(np.uint64, copy=False)
         * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
    return (h % np.uint64(n_parts)).astype(np.int64)


def _spill_partitions(tmp, table: Table, cols, key_col: str,
                      n_parts: int):
    """Hash-partition the needed columns (+ validity) of one table into
    per-partition tmp-file segments (the host spill tier). Returns
    (segments per partition, max partition rows)."""
    key = np.asarray(table.data[key_col]).astype(np.int64, copy=False)
    part = _hash_partition(n_parts, key)
    segs: list[list[str]] = [[] for _ in range(n_parts)]
    names = [c for c in cols if c in table.schema]
    max_rows = 0
    for p in range(n_parts):
        m = part == p
        rows = int(m.sum())
        max_rows = max(max_rows, rows)
        if not rows:
            continue
        seg = {c: np.asarray(table.data[c])[m] for c in names}
        for c, v in table.valid.items():
            if c in cols:
                seg[f"#v:{c}"] = np.asarray(v, np.bool_)[m]
        segs[p].append(tmp.write_segment(seg))
    return segs, max_rows


def derive_partition_count(total_bytes: int, budget: int,
                           governor=None) -> int:
    """Power-of-two partition count sized so one partition PAIR fits
    comfortably on the device: ~budget/4 per partition (two sides +
    decode headroom), clamped to [2, 256]. The governor's remaining
    budget tightens the target."""
    avail = max(int(budget), 1)
    if governor is not None:
        rem = governor.remaining()
        if rem > 0:
            avail = min(avail, rem)
    target = max(avail // 4, 1 << 16)
    p = _next_pow2(max(2, -(-int(total_bytes) // target)))
    return min(p, 256)


class GraceHashPreparedPlan:
    """Out-of-core execution when chunk streaming is NOT enough: the
    build side of a join (or the whole input of a keyed group-by) also
    exceeds the budget. Each grace input hash-partitions by its join or
    group key into host tmp-file segments; ONE program -- the split
    subtree over fixed-capacity $live-masked overlay tables -- runs per
    partition (pair); partials merge through the same $partials machinery
    as chunk streaming.

    mode "join":    partials re-aggregate / pass through exactly as
                    chunked partials do (a group may span partitions).
    mode "groupby": partitioning ON a group key makes groups partition-
                    disjoint, so ANY aggregate -- count distinct too -- is
                    exact per partition and the merge is concatenation.
    """

    def __init__(self, executor, plan, split, kind: str, mode: str,
                 scans: dict[str, tuple[Scan, str, frozenset]],
                 n_parts: int):
        # scans: alias -> (scan node, partition-key base column,
        #                  needed base columns)
        from .chunked import (
            _merge_plan,
            _OverlayCatalog,
            _partials_scan,
            _replace_node,
        )
        from .executor import Executor, _collect_qparam_spec

        self.executor = executor
        self.plan = plan
        self.split = split
        self.kind = kind
        self.mode = mode
        self.n_parts = n_parts
        self.retries = 0
        self.stream_stats = StreamStats()
        # one packed row over the whole statement; the partition and
        # merge programs share its frame
        self._qparam_spec = _collect_qparam_spec(plan)
        self._scans = scans

        if mode == "groupby":
            # per-partition output is FINAL for its groups: the merge is
            # the rename projection whatever the aggregate computes
            out_s = output_schema(split)
            pscan = _partials_scan(out_s)
            merge_node = Project(
                pscan,
                tuple((f.name, E.ColRef(f"$m.{f.name}"))
                      for f in out_s.fields),
            )
            part_plan = split
            self.above_plan = _replace_node(plan, split, merge_node)
            self.partial_schema = out_s
        else:
            part_plan, _scan, merge_node = _merge_plan(split, kind)
            self.above_plan = _replace_node(plan, split, merge_node)
            self.partial_schema = output_schema(split)

        # rewrite every partitioned scan onto its overlay table
        self._overlay_names = {}
        for alias, (scan, _key, cols) in scans.items():
            oname = f"$gh_{alias}"
            self._overlay_names[alias] = oname
            part_plan = _replace_node(
                part_plan, scan, _live_scan(scan, oname, cols))
        self.part_plan = part_plan

        # per-partition executor over the overlay catalog: chunking off
        # (partitions are already bounded), whole-table premises off
        # (partition rows are permuted slices)
        self._overlay_extra: dict = {}
        self.part_exec = Executor(
            _OverlayCatalog(executor.catalog, self._overlay_extra),
            unique_keys={}, stats=None, device=executor.device,
        )
        self.part_exec.chunking_enabled = False
        self.part_exec.clustered_agg_enabled = False
        self.part_exec.scan_slice_enabled = False
        self._part_prepared = None
        self._out_dicts: dict = {}

        self.merge_exec = Executor(
            _OverlayCatalog(executor.catalog, self._overlay_extra),
            unique_keys=executor.unique_keys, stats=None,
            device=executor.device,
        )
        self.merge_exec.chunking_enabled = False
        self._partial_cap = 1024
        self._merge_prepared = None
        self._merge_cap = 0

    def _overlay_for(self, alias: str, scan: Scan, cols, segs, tmp,
                     cap: int) -> Table:
        """One partition of one grace input as a padded overlay Table."""
        t = self.executor.catalog[scan.table]
        names = [c for c in sorted(cols) if c in t.schema]
        parts = [tmp.read_segment(path) for path in segs]
        if parts:
            data = {c: np.concatenate([p[c] for p in parts])
                    for c in names}
            vdata = {
                c: np.concatenate([p[f"#v:{c}"] for p in parts])
                for c in t.valid if c in cols
            }
        else:
            data = {c: np.zeros(0, dtype=t.schema[c].storage_np)
                    for c in names}
            vdata = {c: np.zeros(0, np.bool_)
                     for c in t.valid if c in cols}
        n = len(next(iter(data.values()))) if data else 0
        pad = cap - n
        if pad:
            data = {
                c: np.concatenate([v, np.zeros(pad, dtype=v.dtype)])
                for c, v in data.items()
            }
            vdata = {
                c: np.concatenate([v, np.zeros(pad, np.bool_)])
                for c, v in vdata.items()
            }
        data["$live"] = np.concatenate(
            [np.ones(n, np.int8), np.zeros(pad, np.int8)])
        fields = [f for f in t.schema.fields if f.name in data]
        fields.append(Field("$live", DataType.int8()))
        return Table(
            self._overlay_names[alias], Schema(tuple(fields)), data,
            {c: d for c, d in t.dicts.items() if c in data}, valid=vdata,
        )

    def bind(self, values, dtypes):
        """Values -> one packed int64 row over the whole statement."""
        from .executor import pack_qparams

        return pack_qparams(values, dtypes, self._qparam_spec)

    def run(self, max_retries: int = 3, qparams: tuple = ()):
        from ..storage.tmp_file import TmpFileManager
        from .executor import _unpack_qparams

        qparams = _unpack_qparams(qparams, self._qparam_spec)
        stats = self.stream_stats
        cols: dict[str, list] = {
            f.name: [] for f in self.partial_schema.fields}
        valids: dict[str, list] = {}
        with TmpFileManager() as tmp:
            # phase 1: co-partition every grace input by its key column;
            # the fixed per-input capacity (max partition, pow2) lets ONE
            # program serve all partitions
            segs: dict[str, list[list[str]]] = {}
            caps: dict[str, int] = {}
            for alias, (scan, key_col, pcols) in self._scans.items():
                t = self.executor.catalog[scan.table]
                segs[alias], mx = _spill_partitions(
                    tmp, t, pcols, key_col, self.n_parts)
                caps[alias] = _next_pow2(max(mx, 16))
                checkpoint()
            stats.spill_partitions += self.n_parts

            # phase 2: one program over every partition (pair)
            for p in range(self.n_parts):
                checkpoint()
                for alias, (scan, _k, pcols) in self._scans.items():
                    oname = self._overlay_names[alias]
                    self._overlay_extra[oname] = self._overlay_for(
                        alias, scan, pcols, segs[alias][p], tmp,
                        caps[alias])
                    self.part_exec.invalidate_table(oname)
                if self._part_prepared is None:
                    self._part_prepared = self.part_exec.prepare(
                        self.part_plan)
                hcols, hvalid, hsel = self._run_partition(
                    max_retries, qparams)
                _fold_partial(self.partial_schema, cols, valids, hcols,
                              hvalid, hsel)
                for alias in segs:
                    for path in segs[alias][p]:
                        tmp.free_segment(path)

        partials, self._partial_cap = assemble_partials_table(
            self.partial_schema, cols, valids, dict(self._out_dicts),
            self._partial_cap)
        self._overlay_extra["$partials"] = partials
        self.merge_exec.invalidate_table("$partials")
        if self._merge_prepared is None or \
                self._merge_cap != self._partial_cap:
            self._merge_prepared = self.merge_exec.prepare(self.above_plan)
            self._merge_cap = self._partial_cap
        return self._merge_prepared.run(max_retries, qparams=qparams)

    def _run_partition(self, max_retries: int, qparams: tuple):
        prepared = self._part_prepared
        for attempt in range(max_retries + 1):
            out, ovf_vec = prepared.call(qparams)
            hovf, hcols, hvalid, hsel = _fetch_partial(
                self.partial_schema, out, ovf_vec)
            overflows = prepared._overflows(np.asarray(hovf))
            if not overflows:
                self._out_dicts.update(out.dicts)
                return hcols, hvalid, hsel
            if attempt == max_retries:
                raise RuntimeError(
                    f"grace partition overflow after {max_retries} "
                    f"retries: {overflows}")
            self.retries += 1
            prepared.retries += 1
            prepared.params.bump(overflows)
            prepared.recompile()
        raise AssertionError


def try_grace_hash(executor, plan, budget: int):
    """Entry hook from Executor.prepare's `except NotStreamable` branch:
    find a grace-hash-partitionable shape or raise NotPartitionable.

    join mode:    the two biggest scans both exceed the budget, they meet
                  at a JoinOp whose probe path streams and whose build
                  chain is Filter/Project-only, and one equi-key pair
                  resolves to base integer columns on both sides.
    groupby mode: one over-budget input under a keyed Aggregate whose
                  path streams and one group key resolves to a base
                  integer column (then ANY aggregate is exact per
                  partition).
    """
    from .chunked import _MERGE_FN, _row_bytes, scan_bytes

    needed = executor._needed_columns(plan)
    scans = executor._collect_scans(plan)
    if not scans:
        raise NotPartitionable("no scans")
    sizes = sorted(
        ((scan_bytes(executor.catalog, s, needed), s) for s in scans),
        key=lambda p: -p[0])

    def single_scan(s: Scan):
        if sum(1 for x in scans if x.table == s.table) > 1:
            raise NotPartitionable(
                "partitioned table scanned more than once")

    def needed_cols(s: Scan, key_col: str) -> frozenset:
        t = executor.catalog[s.table]
        base = needed.get(s.alias) or {t.schema.fields[0].name}
        return frozenset(set(base) | {key_col})

    big_bytes, big = sizes[0]
    single_scan(big)
    path = _path_to_scan(plan, big)
    gov = getattr(executor, "governor", None)

    def lowest(pred):
        best = None
        for i, node in enumerate(path):
            if pred(node):
                best = i
        return best

    # ---- join mode: second scan also over budget --------------------
    if len(sizes) > 1 and sizes[1][0] > budget:
        build_bytes, build = sizes[1]
        single_scan(build)
        if sum(b for b, _ in sizes[2:]) > budget:
            raise NotPartitionable("three or more over-budget inputs")
        # the JoinOp on the probe path whose RIGHT subtree holds `build`
        join_i = None
        for i, node in enumerate(path):
            if isinstance(node, JoinOp) and path[i + 1] is node.left:
                if any(sc is build
                       for sc in executor._collect_scans(node.right)):
                    join_i = i
                    break
        if join_i is None:
            raise NotPartitionable(
                "no probe-side join over the build scan")
        join = path[join_i]
        if join.kind not in ("inner", "left", "semi", "anti"):
            raise NotPartitionable(f"{join.kind} join not partitionable")
        build_path = _path_to_scan(join.right, build)
        if not all(isinstance(nd, (Filter, Project, Scan))
                   for nd in build_path):
            raise NotPartitionable("build chain not Filter/Project-only")
        # an equi-key pair resolving to base integer columns both sides
        probe_col = build_col = None
        for lk, rk in zip(join.left_keys, join.right_keys):
            if not (isinstance(lk, E.ColRef) and isinstance(rk, E.ColRef)):
                continue
            pc = _resolve_base_col(path[join_i + 1:], lk.name)
            bc = _resolve_base_col(build_path, rk.name)
            if pc is None or bc is None:
                continue
            t1 = executor.catalog[big.table]
            t2 = executor.catalog[build.table]
            if pc in t1.schema and bc in t2.schema \
                    and t1.schema[pc].storage_np.kind in "iu" \
                    and t2.schema[bc].storage_np.kind in "iu":
                probe_col, build_col = pc, bc
                break
        if probe_col is None:
            raise NotPartitionable("no base-resolvable equi-key pair")
        # the split above the join: lowest mergeable aggregate, else the
        # join itself as a passthrough split (budget-guarded partials)
        split_i = kind = None
        i = lowest(lambda nd: isinstance(nd, Aggregate))
        if i is not None and i < join_i and _streams_down(path, i) \
                and not path[i].grouping_sets and all(
                    not d and fn in _MERGE_FN
                    for _nm, fn, _a, d in path[i].aggs):
            split_i, kind = i, "agg"
        if split_i is None:
            if not _streams_down(path, join_i):
                raise NotPartitionable(
                    "no mergeable split above the join")
            est = executor._est_rows(join)
            if est * _row_bytes(output_schema(join)) > budget:
                raise NotPartitionable(
                    "passthrough partials exceed budget")
            split_i, kind = join_i, "passthrough"
        split = path[split_i]
        n_parts = derive_partition_count(
            big_bytes + build_bytes, budget, gov)
        return GraceHashPreparedPlan(
            executor, plan, split, kind, "join",
            {big.alias: (big, probe_col,
                         needed_cols(big, probe_col)),
             build.alias: (build, build_col,
                           needed_cols(build, build_col))},
            n_parts)

    # ---- groupby mode: one big input, keyed aggregate ---------------
    if sum(b for b, _ in sizes[1:]) > budget:
        raise NotPartitionable("multiple over-budget inputs, no join")
    i = lowest(lambda nd: isinstance(nd, Aggregate))
    if i is None or not path[i].group_keys or not _streams_down(path, i):
        raise NotPartitionable("no keyed aggregate over the big scan")
    agg = path[i]
    if agg.grouping_sets is not None:
        raise NotPartitionable("grouping sets span partitions")
    key_col = None
    for _name, e in agg.group_keys:
        if not isinstance(e, E.ColRef):
            continue
        c = _resolve_base_col(path[i + 1:], e.name)
        if c is None:
            continue
        t = executor.catalog[big.table]
        if c in t.schema and t.schema[c].storage_np.kind in "iu":
            key_col = c
            break
    if key_col is None:
        raise NotPartitionable("no base-resolvable group key")
    n_parts = derive_partition_count(big_bytes, budget, gov)
    return GraceHashPreparedPlan(
        executor, plan, agg, "agg", "groupby",
        {big.alias: (big, key_col, needed_cols(big, key_col))}, n_parts)
