"""Hand-written Hopper kernels of the port, their builds, wrappers and
plain PyTorch versions.

K1 `scalar_reduce`     masked count/sum/min/max   (csrc/k1_scalar_aggregate.cu)
K2 `groupby_slots`     direct-addressed group-by  (csrc/k2_groupby_direct.cu)
K3 `sort_order`        stable multi-key order     (csrc/k3_radix_sort.cu)
K4 `gather_columns`    multi-column row gather    (csrc/k4_gather_rows.cu)

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface (one nvcc per source, all started together, then one
link), built at first use into `_build/` and loaded with ctypes. Each
wrapper checks its inputs, allocates outputs and scratch with torch,
launches on the current stream, raises on a launch error and adds one to
its entry in `LAUNCHES`. A wrapper given CPU tensors runs the plain
version beside it instead; a CUDA tensor always goes to the kernel.
Integer results and orders equal the plain versions bit for bit; float
sums accumulate in double and in another order than the plain versions,
so they agree to rounding (the same bits on every run of a kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import torch

KERNEL_NAMES = (
    "K1_scalar_aggregate",
    "K2_groupby_direct",
    "K3_radix_sort",
    "K4_gather_rows",
)

# launches of each kernel wrapper on CUDA tensors (plain runs not counted)
LAUNCHES: dict[str, int] = {k: 0 for k in KERNEL_NAMES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = (
    "k1_scalar_aggregate.cu",
    "k2_groupby_direct.cu",
    "k3_radix_sort.cu",
    "k4_gather_rows.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# element type codes and aggregate op codes (csrc/ob_common.cuh)
DTYPE_CODE = {
    torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4, torch.float32: 5, torch.float64: 6, torch.uint8: 7,
}
AGG_CODE = {"count": 0, "sum": 1, "min": 2, "max": 3}

_lib = None
_lib_lock = threading.Lock()
BUILD_INFO: dict = {}


def _nvcc() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_digest() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in _CSRC.iterdir()):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path. Reuses a library built from identical sources."""
    import time

    digest = _source_digest()
    out = _BUILD / f"libob_kernels_{digest}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = _BUILD / f"{Path(src).stem}_{digest}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for src, obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src} (rc {p.returncode})\n{text}")
        objs.append(str(obj))
        if p.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    (_BUILD / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = out.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp.replace(out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, I, L, D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_double)
        lib.ob_k1_reduce_int.argtypes = [P, I, P, L, I, L, P, I, P]
        lib.ob_k1_reduce_float.argtypes = [P, I, P, L, I, D, P, P, I, P]
        lib.ob_k2_groupby.argtypes = [P, I, L, I, I, P, P, P, P, P, P, P, P,
                                      I, I, P]
        lib.ob_k3_minmax.argtypes = [P, I, I, L, P, I, P]
        lib.ob_k3_pack.argtypes = [I, P, P, P, P, P, P, L, P, I, P]
        lib.ob_k3_pass.argtypes = [P, P, L, I, P, P, I, P, P, P]
        lib.ob_k3_tile_rows.argtypes = []
        lib.ob_k4_gather.argtypes = [P, L, L, I, P, P, P, P, I, P]
        for fn in (lib.ob_k1_reduce_int, lib.ob_k1_reduce_float,
                   lib.ob_k2_groupby, lib.ob_k3_minmax, lib.ob_k3_pack,
                   lib.ob_k3_pass,
                   lib.ob_k3_tile_rows, lib.ob_k4_gather):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _blocks(dev: torch.device, n: int, per_block: int) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-max(n, 1) // per_block), sms * 8))


def _on_cuda(*ts) -> bool:
    """True when the tensors lie on one CUDA device, False when all lie on
    the CPU; raises on a mix."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {devs}")
    return next(iter(devs)).type == "cuda"


def _vector(t: torch.Tensor, n: int, what: str) -> None:
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{what}: expected shape [{n}], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{what}: unsupported dtype {t.dtype}")


def _identity(op: str, dtype: torch.dtype):
    """Identity of an aggregate in the value's own type, as jnp's
    where(mask, v, identity) reductions use it."""
    if op in ("count", "sum"):
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _acc_dtype(op: str, dtype: torch.dtype | None) -> torch.dtype:
    if op == "count":
        return torch.int64
    if op == "sum" and not dtype.is_floating_point:
        return torch.int64
    return dtype


# ---------------------------------------------------------------------------
# K1: masked scalar reduction
# ---------------------------------------------------------------------------


def scalar_reduce_plain(op: str, mask: torch.Tensor, values=None):
    """Plain version of K1 (ops/hashagg.py scalar_aggregate, one agg)."""
    if op == "count":
        return torch.sum(mask, dtype=torch.int64)
    acc = _acc_dtype(op, values.dtype)
    masked = torch.where(mask, values, _identity(op, values.dtype))
    if op == "sum":
        return torch.sum(masked.to(acc))
    if op == "min":
        return torch.amin(masked)
    if op == "max":
        return torch.amax(masked)
    raise NotImplementedError(op)


def scalar_reduce(op: str, mask: torch.Tensor, values=None):
    """K1: count/sum/min/max of `values` over rows where `mask` is set, as
    a 0-d tensor (int64 for count and integer sums, else the value type)."""
    if op not in AGG_CODE:
        raise NotImplementedError(op)
    if op != "count" and values is None:
        raise ValueError(f"{op} needs values")
    vals = values if op != "count" else None
    if not _on_cuda(mask, vals):
        return scalar_reduce_plain(op, mask, vals)
    n = int(mask.shape[0])
    _vector(mask, n, "K1 mask")
    if mask.dtype != torch.bool:
        raise TypeError("K1 mask must be bool")
    if vals is not None:
        _vector(vals, n, "K1 values")
    lib = _load()
    dev = mask.device
    with torch.cuda.device(dev):
        nb = _blocks(dev, n, 256 * 8)
        stream = _stream(dev)
        if vals is not None and vals.dtype.is_floating_point:
            out = torch.empty(1, dtype=torch.float64, device=dev)
            part = torch.empty(nb, dtype=torch.float64, device=dev)
            rc = lib.ob_k1_reduce_float(
                vals.data_ptr(), DTYPE_CODE[vals.dtype], mask.data_ptr(), n,
                AGG_CODE[op], float(_identity(op, vals.dtype)),
                out.data_ptr(), part.data_ptr(), nb, stream)
            _check(rc, "K1_scalar_aggregate")
            res = out[0].to(vals.dtype)
        else:
            out = torch.empty(1, dtype=torch.int64, device=dev)
            dt = DTYPE_CODE[vals.dtype] if vals is not None else 0
            ident = 0 if vals is None else int(_identity(op, vals.dtype))
            rc = lib.ob_k1_reduce_int(
                vals.data_ptr() if vals is not None else None, dt,
                mask.data_ptr(), n, AGG_CODE[op], ident, out.data_ptr(), nb,
                stream)
            _check(rc, "K1_scalar_aggregate")
            res = out[0].to(_acc_dtype(op, vals.dtype if vals is not None
                                       else None))
    LAUNCHES["K1_scalar_aggregate"] += 1
    return res


# ---------------------------------------------------------------------------
# K2: direct-addressed group-by
# ---------------------------------------------------------------------------

K2_MAX_AGGS = 32
K2_THREADS = 128
K2_SMEM_BYTES = 96 * 1024      # shared-memory budget of one K2 block
K2_SM_SMEM_BYTES = 224 * 1024  # usable shared memory of one H100 SM


def groupby_slots_plain(keys: torch.Tensor, domain: int, aggs):
    """Plain version of K2 (ops/hashagg.py groupby_direct / executor
    _direct_slot_agg): one masked reduction per (slot, aggregate)."""
    slot_is = [keys == g for g in range(domain)]
    out = []
    for op, values, mask in aggs:
        out.append(torch.stack([
            scalar_reduce_plain(op, mask & g, values) for g in slot_is
        ]))
    return out


def groupby_slots(keys: torch.Tensor, domain: int, aggs):
    """K2: for each (op, values|None, mask) in `aggs`, the [domain] tensor
    of that aggregate over rows whose packed key equals each slot."""
    if not aggs:
        return []
    if not 1 <= domain <= 64:
        raise ValueError(f"K2 domain {domain} outside 1..64")
    if not _on_cuda(keys, *(v for _, v, _ in aggs), *(m for _, _, m in aggs)):
        return groupby_slots_plain(keys, domain, aggs)
    n = int(keys.shape[0])
    _vector(keys, n, "K2 keys")
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError("K2 keys must be int32 or int64")
    for op, v, m in aggs:
        if op not in AGG_CODE:
            raise NotImplementedError(op)
        _vector(m, n, "K2 mask")
        if m.dtype != torch.bool:
            raise TypeError("K2 masks must be bool")
        if op != "count":
            _vector(v, n, "K2 values")
    lib = _load()
    dev = keys.device
    results = []
    # per-thread cells: a block holds K2_THREADS * aggregates * domain
    # 8-byte cells; split the aggregates to fit the shared-memory budget
    per_agg = K2_THREADS * domain * 8
    step = max(1, min(K2_MAX_AGGS, K2_SMEM_BYTES // per_agg))
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = _stream(dev)
        for c0 in range(0, len(aggs), step):
            chunk = aggs[c0:c0 + step]
            na = len(chunk)
            vals = (ctypes.c_void_p * na)()
            masks = (ctypes.c_void_p * na)()
            dts = (ctypes.c_int * na)()
            ops = (ctypes.c_int * na)()
            ident = (ctypes.c_longlong * na)()
            isf = (ctypes.c_int * na)()
            for j, (op, v, m) in enumerate(chunk):
                fl = v is not None and op != "count" and v.dtype.is_floating_point
                vals[j] = v.data_ptr() if op != "count" else None
                masks[j] = m.data_ptr()
                dts[j] = DTYPE_CODE[v.dtype] if op != "count" else 0
                ops[j] = AGG_CODE[op]
                isf[j] = 1 if fl else 0
                idv = _identity(op, v.dtype if op != "count" else torch.int64)
                ident[j] = (struct.unpack("<q", struct.pack("<d", idv))[0]
                            if fl else int(idv))
            out = torch.empty((na, domain), dtype=torch.int64, device=dev)
            resident = max(1, K2_SM_SMEM_BYTES // (na * per_agg))
            nb = max(1, min(-(-max(n, 1) // (K2_THREADS * 8)),
                            sms * resident))
            part = torch.empty((nb, na, domain), dtype=torch.int64,
                               device=dev)
            rc = lib.ob_k2_groupby(
                keys.data_ptr(), DTYPE_CODE[keys.dtype], n, domain, na,
                vals, dts, masks, ops, ident, isf, out.data_ptr(),
                part.data_ptr(), K2_THREADS, nb, stream)
            _check(rc, "K2_groupby_direct")
            for j, (op, v, _m) in enumerate(chunk):
                row = out[j]
                if isf[j]:
                    results.append(row.view(torch.float64).to(v.dtype))
                else:
                    results.append(row.to(_acc_dtype(
                        op, v.dtype if op != "count" else None)))
    LAUNCHES["K2_groupby_direct"] += 1
    return results


# ---------------------------------------------------------------------------
# K3: stable multi-key sort order
# ---------------------------------------------------------------------------


K3_MAX_PACK = 8


def _plain_key(k: torch.Tensor, desc: bool) -> torch.Tensor:
    """A tensor whose stable ascending torch order is lax.sort's order of
    the key (see csrc/k3_radix_sort.cu for the images)."""
    if k.dtype == torch.bool:
        return (~k if desc else k).to(torch.int8)
    if k.dtype.is_floating_point:
        x = -k if desc else k
        x = torch.where(x == 0, torch.zeros_like(x), x)  # -0.0 -> +0.0
        return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return -k if desc else k  # jnp's -v: wraps in the key's own width


def sort_order_plain(keys, descending, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: stable argsorts chained from the least
    significant key; the dead flag (~mask) is the most significant."""
    n = int(mask.shape[0])
    perm = torch.arange(n, dtype=torch.int64, device=mask.device)
    for k, d in reversed([(mask, True), *zip(keys, descending)]):
        kk = _plain_key(k, d)[perm]
        perm = perm[torch.argsort(kk, stable=True)]
    return perm.to(torch.int32)


def sort_order(keys, descending, mask: torch.Tensor) -> torch.Tensor:
    """K3: int32 [N] row order sorting live rows by `keys` (lexicographic,
    DESC per flag), dead rows last, ties by row index."""
    keys = list(keys)
    descending = list(descending)
    if len(keys) != len(descending):
        raise ValueError("one descending flag per key")
    if not _on_cuda(mask, *keys):
        return sort_order_plain(keys, descending, mask)
    n = int(mask.shape[0])
    if n >= 2**31:
        raise ValueError("K3 orders at most 2^31 - 1 rows")
    _vector(mask, n, "K3 mask")
    if mask.dtype != torch.bool:
        raise TypeError("K3 mask must be bool")
    for k in keys:
        _vector(k, n, "K3 key")
    lib = _load()
    dev = mask.device
    # most significant first: the dead flag, then the keys in order
    allk = [(mask, True)] + list(zip(keys, descending))
    with torch.cuda.device(dev):
        stream = _stream(dev)
        nb = _blocks(dev, n, 256 * 8)
        # a bool key's image spans 0..1 (the dead flag too); the spans of
        # the other keys are measured, with one host read for all of them
        measured = [i for i, (k, _d) in enumerate(allk)
                    if k.dtype != torch.bool]
        spans = [(0, 1)] * len(allk)
        if measured:
            mm = torch.empty((len(measured), 2), dtype=torch.int64,
                             device=dev)
            for row, i in enumerate(measured):
                k, d = allk[i]
                rc = lib.ob_k3_minmax(k.data_ptr(), DTYPE_CODE[k.dtype],
                                      int(bool(d)), n, mm[row].data_ptr(),
                                      nb, stream)
                _check(rc, "K3_radix_sort minmax")
            for i, (lo, hi) in zip(measured, mm.tolist()):
                spans[i] = (lo & (2**64 - 1), hi & (2**64 - 1))
        # pack least significant first into composites of <= 64 bits,
        # dropping keys measured constant (they cannot change the order)
        groups, cur, used = [], [], 0
        for (k, d), (lo, hi) in reversed(list(zip(allk, spans))):
            bits = (hi - lo).bit_length() if n and hi > lo else 0
            if bits == 0:
                continue
            if used + bits > 64 or len(cur) == K3_MAX_PACK:
                groups.append((cur, used))
                cur, used = [], 0
            cur.append((k, d, lo, used))
            used += bits
        if cur:
            groups.append((cur, used))
        tile = lib.ob_k3_tile_rows()
        ntiles = max(1, -(-n // tile))
        img = torch.empty(n, dtype=torch.int64, device=dev)
        img2 = torch.empty(n, dtype=torch.int64, device=dev)
        hist = torch.empty(256 * ntiles, dtype=torch.int32, device=dev)
        totals = torch.empty(256, dtype=torch.int32, device=dev)
        bufs = (torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))
        perm = None  # identity until the first pass
        for members, bits in groups:
            nk = len(members)
            rc = lib.ob_k3_pack(
                nk, (ctypes.c_void_p * nk)(*[k.data_ptr() for k, _, _, _ in members]),
                (ctypes.c_int * nk)(*[DTYPE_CODE[k.dtype] for k, _, _, _ in members]),
                (ctypes.c_int * nk)(*[int(bool(d)) for _, d, _, _ in members]),
                (ctypes.c_ulonglong * nk)(*[lo for _, _, lo, _ in members]),
                (ctypes.c_int * nk)(*[sh for _, _, _, sh in members]),
                perm.data_ptr() if perm is not None else None, n,
                img.data_ptr(), nb, stream)
            _check(rc, "K3_radix_sort pack")
            npass = -(-bits // 8)
            for p in range(npass):
                dst = bufs[1] if perm is bufs[0] else bufs[0]
                last = p == npass - 1
                rc = lib.ob_k3_pass(
                    img.data_ptr(),
                    perm.data_ptr() if perm is not None else None,
                    n, 8 * p, hist.data_ptr(), totals.data_ptr(), ntiles,
                    None if last else img2.data_ptr(), dst.data_ptr(), stream)
                _check(rc, "K3_radix_sort pass")
                if not last:
                    img, img2 = img2, img
                perm = dst
        if perm is None:
            perm = torch.arange(n, dtype=torch.int32, device=dev)
    LAUNCHES["K3_radix_sort"] += 1
    return perm


# ---------------------------------------------------------------------------
# K4: multi-column row gather
# ---------------------------------------------------------------------------

K4_MAX_COLS = 48
_WIDTHS = (1, 2, 4, 8)


def gather_columns_plain(cols, idx: torch.Tensor):
    """Plain version of K4: each column indexed by idx (clamped to the
    column length, like a jnp gather)."""
    if not cols:
        return []
    n = int(cols[0].shape[0])
    j = idx.long().clamp(0, max(n - 1, 0))
    return [c[j] for c in cols]


def gather_columns(cols, idx: torch.Tensor):
    """K4: [c[idx] for c in cols] in one launch for all columns."""
    cols = list(cols)
    if not cols:
        return []
    if not _on_cuda(idx, *cols):
        return gather_columns_plain(cols, idx)
    n = int(cols[0].shape[0])
    m = int(idx.shape[0])
    _vector(idx, m, "K4 idx")
    if idx.dtype != torch.int32:
        raise TypeError("K4 idx must be int32")
    for c in cols:
        _vector(c, n, "K4 column")
        if c.element_size() not in _WIDTHS:
            raise TypeError(f"K4 column width {c.element_size()}")
    outs = [torch.empty(m, dtype=c.dtype, device=c.device) for c in cols]
    if m == 0:
        return outs
    if n == 0:
        raise ValueError("K4 gathers from empty columns")
    lib = _load()
    dev = idx.device
    with torch.cuda.device(dev):
        nb = _blocks(dev, m, 256 * 4)
        stream = _stream(dev)
        order = sorted(range(len(cols)), key=lambda i: cols[i].element_size())
        for c0 in range(0, len(order), K4_MAX_COLS):
            part = order[c0:c0 + K4_MAX_COLS]
            nc = len(part)
            src = (ctypes.c_void_p * nc)(*[cols[i].data_ptr() for i in part])
            dst = (ctypes.c_void_p * nc)(*[outs[i].data_ptr() for i in part])
            gstart = (ctypes.c_int * 5)()
            gwidth = (ctypes.c_int * 4)(*_WIDTHS)
            for g, w in enumerate(_WIDTHS):
                gstart[g + 1] = gstart[g] + sum(
                    1 for i in part if cols[i].element_size() == w)
            rc = lib.ob_k4_gather(
                idx.data_ptr(), m, n, nc, src, dst, gstart, gwidth, nb,
                stream)
            _check(rc, "K4_gather_rows")
    LAUNCHES["K4_gather_rows"] += 1
    return outs
