"""Hand-written Hopper kernels of the port, their builds, wrappers and
plain PyTorch versions.

K1 `scalar_reduce`     masked count/sum/min/max   (csrc/k1_scalar_aggregate.cu)
K2 `groupby_slots`     direct-addressed group-by  (csrc/k2_groupby_direct.cu)
K3 `sort_order`        stable multi-key order     (csrc/k3_radix_sort.cu)
K4 `gather_columns`    multi-column row gather    (csrc/k4_gather_rows.cu)
K5 `affine_join`       direct-address join probe  (csrc/k5_affine_join.cu)
K6 `clustered_segments` per-range count and sums  (csrc/k6_clustered_agg.cu)
K7 `topk_candidates`   exact top-k of a masked key (csrc/k7_topk_candidates.cu)
K8 `segmented_reduce`  reduce-by-key, sorted rows (csrc/k8_segmented_reduce.cu)
K9 `merge_join`        unique-build equi-join     (csrc/k9_merge_join.cu)
K10 `expand_join`      M:N join expansion         (csrc/k10_expand_join.cu)
K11 `probe_run_any`    OR over each probe's pairs (csrc/k11_probe_run_any.cu)
K12 `hash_columns`     splitmix64 multi-key hash  (csrc/k12_hash_combine.cu)
K13 `boundaries`, `segment_starts`, `peer_ends`, `prefix_sum`,
    `segmented_scan_minmax`, `suffix_scan_minmax`, `bound_search`
                       window and bag set-op scans (csrc/k13_window_scan.cu)
K14 `hash_set_build`, `hash_set_probe`
                       multi-column hash set      (csrc/k14_hash_set.cu)
K15 `first_occurrence`, `scatter_rows`
                       first rows through an order (csrc/k15_distinct_first.cu)
K16 `hll_registers`    HyperLogLog registers      (csrc/k16_hll.cu)
K17 `slice_scan`       sorted-projection range slice (csrc/k17_slice_scan.cu)
K18 `decode_staged`    streamed chunk wire decode (csrc/k18_decode_staged.cu)
K19 `kmeans_assign`    nearest centroid per row   (csrc/k19_kmeans_assign.cu)
K20 `kmeans_update`    per-list row-order sums    (csrc/k20_kmeans_update.cu)
K21 `ivf_lists`        the nprobe nearest lists   (csrc/k21_ivf_lists.cu)
K22 `ivf_probe`        filtered re-rank + top-k   (csrc/k22_ivf_probe.cu)
K23 `first_live`       first k live rows + gather (csrc/k23_first_live.cu)

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface (one nvcc per source, all started together, then one
link), built at first use into `_build/` and loaded with ctypes. Each
wrapper checks its inputs, allocates outputs and scratch with torch,
launches on the current stream, raises on a launch error and adds one to
its entry in `LAUNCHES`. A wrapper given CPU tensors runs the plain
version beside it instead; a CUDA tensor always goes to the kernel.
Integer results and orders equal the plain versions bit for bit; float
sums accumulate in double and in another order than the plain versions,
so they agree to rounding (the same bits on every run of a kernel). The
vector kernels stay in float32 as the reference does: K20 sums each list
in row order and so equals the CPU's sequential sums bit for bit; K19,
K21 and K22 take their dot products in another order than a matmul, so
their choices equal the plain versions' except where two distances lie
within float32 rounding of each other.
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
    "K5_affine_join",
    "K6_clustered_agg",
    "K7_topk_candidates",
    "K8_segmented_reduce",
    "K9_merge_join",
    "K10_expand_join",
    "K11_probe_run_any",
    "K12_hash_combine",
    "K13_window_scan",
    "K14_hash_set",
    "K15_distinct_first",
    "K16_hll",
    "K17_slice_scan",
    "K18_decode_staged",
    "K19_kmeans_assign",
    "K20_kmeans_update",
    "K21_ivf_lists",
    "K22_ivf_probe",
    "K23_first_live",
)

# launches of each kernel wrapper on CUDA tensors (plain runs not counted)
LAUNCHES: dict[str, int] = {k: 0 for k in KERNEL_NAMES}
# launches of the second entry points, counted in their kernel's LAUNCHES
# entry too: K5's no-payload probe, K10's range search alone, K11's
# build-side marks of the full outer join and K15's write-back scatter;
# and the Distinct operator's
# runs on the card (K3 + K4 + K13, executor._dedup_batch)
ENTRY_LAUNCHES: dict[str, int] = {"K5_affine_join.probe": 0,
                                  "K10_expand_join.ranges": 0,
                                  "K11_probe_run_any.mark_build": 0,
                                  "K15_distinct_first.scatter": 0,
                                  "dedup_batch": 0}


def reset_launches() -> None:
    for d in (LAUNCHES, ENTRY_LAUNCHES):
        for k in d:
            d[k] = 0


_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = (
    "k1_scalar_aggregate.cu",
    "k2_groupby_direct.cu",
    "k3_radix_sort.cu",
    "k4_gather_rows.cu",
    "k5_affine_join.cu",
    "k6_clustered_agg.cu",
    "k7_topk_candidates.cu",
    "k8_segmented_reduce.cu",
    "k9_merge_join.cu",
    "k10_expand_join.cu",
    "k11_probe_run_any.cu",
    "k12_hash_combine.cu",
    "k13_window_scan.cu",
    "k14_hash_set.cu",
    "k15_distinct_first.cu",
    "k16_hll.cu",
    "k17_slice_scan.cu",
    "k18_decode_staged.cu",
    "k19_kmeans_assign.cu",
    "k20_kmeans_update.cu",
    "k21_ivf_lists.cu",
    "k22_ivf_probe.cu",
    "k23_first_live.cu",
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
        lib.ob_k5_affine.argtypes = [P, I, P, L, L, L, L, P, I, P, P, I, P,
                                     P, P, I, P]
        lib.ob_k6_segments.argtypes = [P, P, L, P, P, I, P, P, P, P, P, I, P]
        lib.ob_k7_topk.argtypes = [P, I, P, I, L, L, P, P, P, P, P, I, P, I,
                                   P]
        lib.ob_k7_tile_rows.argtypes = []
        lib.ob_k7_state_bytes.argtypes = []
        lib.ob_k8_segreduce.argtypes = [I, P, P, P, P, L, I, P, P, P, P, P,
                                        P, P, P, P, P, P, P, I, P]
        lib.ob_k8_tile_rows.argtypes = []
        lib.ob_k5_probe.argtypes = [P, I, P, L, L, L, L, P, I, P, P, I, P]
        lib.ob_k9_merge_join.argtypes = [P, I, P, L, P, I, P, L, P, L, P, I,
                                         P]
        lib.ob_k10_ranges.argtypes = [P, P, P, P, L, P, I, P]
        lib.ob_k10_expand.argtypes = [P, P, L, P, P, P, L, L, P, P, P, L, P,
                                      P, P, P, P, P, I, P]
        lib.ob_k10_tile_rows.argtypes = []
        lib.ob_k11_run_any.argtypes = [P, L, P, P, L, P, I, P]
        lib.ob_k12_hash.argtypes = [I, P, P, L, P, I, P]
        lib.ob_k11_mark_build.argtypes = [P, P, L, L, P, I, P]
        lib.ob_k13_tile_rows.argtypes = []
        lib.ob_k13_scan.argtypes = [P, I, P, I, I, I, I, L, P, I, L, P, P,
                                    L, P]
        lib.ob_k13_flags.argtypes = [I, P, P, L, P, I, P]
        lib.ob_k13_search.argtypes = [P, L, P, P, P, I, L, P, I, P]
        lib.ob_k14_build.argtypes = [I, P, P, P, L, P, P, L, I, P]
        lib.ob_k14_probe.argtypes = [I, P, P, P, P, P, L, P, P, L, P, I, P]
        lib.ob_k15_first.argtypes = [I, P, P, P, P, L, P, I, P]
        lib.ob_k15_scatter.argtypes = [I, P, P, P, P, P, L, I, P]
        lib.ob_k16_registers.argtypes = [P, I, P, L, P, I, P]
        lib.ob_k17_slice.argtypes = [P, I, L, L, L, I, P, P, P, I, P, P, P,
                                     P, P, P, P, P, I, P]
        lib.ob_k18_decode.argtypes = [I, P, P, P, P, P, P, P, P, P, L, L, P,
                                      P]
        lib.ob_k18_run_tile.argtypes = []
        lib.ob_k19_assign.argtypes = [P, P, P, L, I, I, P, P]
        lib.ob_k20_update.argtypes = [P, P, I, P, L, I, I, P, P, P]
        lib.ob_k21_lists.argtypes = [P, P, I, I, I, P, P, P]
        lib.ob_k22_probe.argtypes = [P, P, P, P, P, P, P, I, I, L, I, I, I,
                                     P, P, P, P, P, P]
        lib.ob_k22_tile.argtypes = []
        lib.ob_k23_first_live.argtypes = [P, L, L, P, P, P, P, I, P, P, P,
                                          P, P]
        lib.ob_k23_tile_rows.argtypes = []
        for fn in (lib.ob_k1_reduce_int, lib.ob_k1_reduce_float,
                   lib.ob_k2_groupby, lib.ob_k3_minmax, lib.ob_k3_pack,
                   lib.ob_k3_pass,
                   lib.ob_k3_tile_rows, lib.ob_k4_gather, lib.ob_k5_affine,
                   lib.ob_k6_segments, lib.ob_k7_topk, lib.ob_k7_tile_rows,
                   lib.ob_k7_state_bytes, lib.ob_k8_segreduce,
                   lib.ob_k8_tile_rows, lib.ob_k5_probe, lib.ob_k9_merge_join,
                   lib.ob_k10_ranges, lib.ob_k10_expand, lib.ob_k10_tile_rows,
                   lib.ob_k11_run_any, lib.ob_k12_hash,
                   lib.ob_k11_mark_build, lib.ob_k13_tile_rows,
                   lib.ob_k13_scan, lib.ob_k13_flags, lib.ob_k13_search,
                   lib.ob_k14_build, lib.ob_k14_probe, lib.ob_k15_first,
                   lib.ob_k15_scatter, lib.ob_k16_registers,
                   lib.ob_k17_slice, lib.ob_k18_decode, lib.ob_k18_run_tile,
                   lib.ob_k19_assign, lib.ob_k20_update, lib.ob_k21_lists,
                   lib.ob_k22_probe, lib.ob_k22_tile,
                   lib.ob_k23_first_live, lib.ob_k23_tile_rows):
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


# ---------------------------------------------------------------------------
# K5: affine (direct-address) join probe
# ---------------------------------------------------------------------------

K5_MAX_COLS = 48
_INT_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64)


def affine_join_plain(probe_key, probe_sel, a0: int, stride: int,
                      build_key, build_sel, payload):
    """Plain version of K5 (executor._affine_candidates + the verify
    gather): (sel, [column[candc] for each payload column]), with 0 in
    every payload column at dead probe rows."""
    nb = int(build_key.shape[0])
    pk = probe_key.to(torch.int64)
    off = pk - a0
    cand = torch.div(off, stride, rounding_mode="floor")
    in_range = (off >= 0) & (torch.remainder(off, stride) == 0) & (cand < nb)
    candc = cand.clamp(0, nb - 1)
    sel = (probe_sel & in_range
           & (build_key.to(torch.int64)[candc] == pk) & build_sel[candc])
    return sel, [torch.where(probe_sel, c[candc],
                             torch.zeros((), dtype=c.dtype, device=c.device))
                 for c in payload]


def affine_join(probe_key, probe_sel, a0: int, stride: int, build_key,
                build_sel, payload):
    """K5: the affine join of probe rows against a build side whose key
    column is a0 + stride * row. Returns (sel, gathered payload columns)."""
    payload = list(payload)
    if not _on_cuda(probe_key, probe_sel, build_key, build_sel, *payload):
        return affine_join_plain(probe_key, probe_sel, a0, stride,
                                 build_key, build_sel, payload)
    n = int(probe_key.shape[0])
    nb = int(build_key.shape[0])
    _vector(probe_key, n, "K5 probe key")
    _vector(probe_sel, n, "K5 probe sel")
    _vector(build_key, nb, "K5 build key")
    _vector(build_sel, nb, "K5 build sel")
    for k in (probe_key, build_key):
        if k.dtype not in _INT_DTYPES:
            raise TypeError(f"K5 keys must be integers, got {k.dtype}")
    if probe_sel.dtype != torch.bool or build_sel.dtype != torch.bool:
        raise TypeError("K5 sel masks must be bool")
    if stride <= 0 or nb < 1:
        raise ValueError(f"K5 needs stride > 0 and a build side, got "
                         f"stride {stride}, {nb} rows")
    if len(payload) > K5_MAX_COLS:
        raise ValueError(f"K5 takes at most {K5_MAX_COLS} payload columns")
    for c in payload:
        _vector(c, nb, "K5 payload column")
        if c.element_size() not in _WIDTHS:
            raise TypeError(f"K5 column width {c.element_size()}")
    dev = probe_key.device
    sel = torch.empty(n, dtype=torch.bool, device=dev)
    outs = [torch.empty(n, dtype=c.dtype, device=dev) for c in payload]
    if n == 0:
        return sel, outs
    lib = _load()
    with torch.cuda.device(dev):
        nblk = _blocks(dev, n, 256 * 4)
        stream = _stream(dev)
        nc = len(payload)
        src = (ctypes.c_void_p * max(nc, 1))(*[c.data_ptr() for c in payload])
        dst = (ctypes.c_void_p * max(nc, 1))(*[o.data_ptr() for o in outs])
        width = (ctypes.c_int * max(nc, 1))(*[c.element_size()
                                              for c in payload])
        rc = lib.ob_k5_affine(
            probe_key.data_ptr(), DTYPE_CODE[probe_key.dtype],
            probe_sel.data_ptr(), n, int(a0), int(stride), nb,
            build_key.data_ptr(), DTYPE_CODE[build_key.dtype],
            build_sel.data_ptr(), sel.data_ptr(), nc, src, dst, width, nblk,
            stream)
        _check(rc, "K5_affine_join")
    LAUNCHES["K5_affine_join"] += 1
    return sel, outs


# ---------------------------------------------------------------------------
# K6: clustered-FK segment aggregation
# ---------------------------------------------------------------------------

K6_MAX_AGGS = 16


def _range_sum_plain(x, starts, ends):
    """The reference's per-range sum: cumsum differences at the bounds."""
    n = int(x.shape[0])
    c = torch.cumsum(x, 0)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    hi = torch.where(ends > 0, c[(ends.to(torch.int64) - 1).clamp(0, n - 1)],
                     zero)
    lo = torch.where(starts > 0,
                     c[(starts.to(torch.int64) - 1).clamp(0, n - 1)], zero)
    return hi - lo


def clustered_segments_plain(starts, ends, sel, aggs):
    """Plain version of K6 (executor._emit_clustered_agg's cumsums and
    their differences at [starts, ends))."""
    cnt = _range_sum_plain(sel.to(torch.int64), starts, ends)
    outs = []
    for op, v, m in aggs:
        am = sel if m is None else sel & m
        if op == "count":
            outs.append(_range_sum_plain(am.to(torch.int64), starts, ends))
        else:
            acc = _acc_dtype("sum", v.dtype)
            outs.append(_range_sum_plain(
                torch.where(am, v.to(acc), torch.zeros((), dtype=acc,
                                                       device=v.device)),
                starts, ends))
    return cnt, outs


def clustered_segments(starts, ends, sel, aggs):
    """K6: per build row i, the count of live probe rows in
    [starts[i], ends[i]) and, for each (op, values|None, mask|None) in
    `aggs` (op count or sum), that aggregate over the range's live rows
    whose mask is set. Returns (cnt int64, [per-aggregate results])."""
    aggs = list(aggs)
    if not _on_cuda(starts, ends, sel, *(v for _, v, _ in aggs),
                    *(m for _, _, m in aggs)):
        return clustered_segments_plain(starts, ends, sel, aggs)
    nb = int(starts.shape[0])
    n = int(sel.shape[0])
    _vector(starts, nb, "K6 starts")
    _vector(ends, nb, "K6 ends")
    _vector(sel, n, "K6 sel")
    if starts.dtype != torch.int32 or ends.dtype != torch.int32:
        raise TypeError("K6 ranges must be int32")
    if sel.dtype != torch.bool:
        raise TypeError("K6 sel must be bool")
    if len(aggs) > K6_MAX_AGGS:
        raise ValueError(f"K6 takes at most {K6_MAX_AGGS} aggregates")
    for op, v, m in aggs:
        if op not in ("count", "sum"):
            raise NotImplementedError(f"K6 aggregate {op}")
        if op == "sum":
            _vector(v, n, "K6 values")
        if m is not None:
            _vector(m, n, "K6 mask")
            if m.dtype != torch.bool:
                raise TypeError("K6 masks must be bool")
    dev = sel.device
    cnt = torch.empty(nb, dtype=torch.int64, device=dev)
    raw = []
    for op, v, _m in aggs:
        fl = op == "sum" and v.dtype.is_floating_point
        raw.append(torch.empty(nb, dtype=torch.float64 if fl else torch.int64,
                               device=dev))
    if nb == 0:
        return cnt, [r for r in raw]
    lib = _load()
    with torch.cuda.device(dev):
        nblk = _blocks(dev, nb, 256)
        stream = _stream(dev)
        na = len(aggs)
        k = max(na, 1)
        vals = (ctypes.c_void_p * k)(*[
            v.data_ptr() if op == "sum" else None for op, v, _m in aggs])
        masks = (ctypes.c_void_p * k)(*[
            m.data_ptr() if m is not None else None for _op, _v, m in aggs])
        outs = (ctypes.c_void_p * k)(*[r.data_ptr() for r in raw])
        dts = (ctypes.c_int * k)(*[
            DTYPE_CODE[v.dtype] if op == "sum" else 0 for op, v, _m in aggs])
        isf = (ctypes.c_int * k)(*[
            1 if r.dtype == torch.float64 else 0 for r in raw])
        rc = lib.ob_k6_segments(
            starts.data_ptr(), ends.data_ptr(), nb, sel.data_ptr(),
            cnt.data_ptr(), na, vals, masks, outs, dts, isf, nblk, stream)
        _check(rc, "K6_clustered_agg")
    res = []
    for (op, v, _m), r in zip(aggs, raw):
        res.append(r.to(v.dtype) if r.dtype == torch.float64 else r)
    LAUNCHES["K6_clustered_agg"] += 1
    return cnt, res


# ---------------------------------------------------------------------------
# K7: exact top-k candidates
# ---------------------------------------------------------------------------

_I64_MIN = -(2**63)


def _topk_masked(key, sel, desc: bool):
    flip = key.to(torch.int64)
    if not desc:
        flip = ~flip  # exact order reversal, no int64-min overflow
    return torch.where(sel, flip, torch.full((), _I64_MIN, dtype=torch.int64,
                                             device=key.device))


def topk_candidates_plain(key, sel, desc: bool, c: int):
    """Plain version of K7: a stable descending sort of the masked key, its
    first c rows (lax.top_k's order: ties by lower index), and the count
    of live rows at or above the c-th value."""
    masked = _topk_masked(key, sel, desc)
    idx = torch.sort(masked, descending=True, stable=True).indices[:c]
    kth = masked[idx[c - 1]]
    cnt = torch.sum((masked >= kth) & sel, dtype=torch.int64)
    return idx.to(torch.int32), cnt


def topk_candidates(key, sel, desc: bool, c: int):
    """K7: (int32 [c] row indices of the c largest of
    where(sel, key or ~key, INT64_MIN), value descending and ties by lower
    index; the 0-d int64 count of live rows whose value is >= the c-th)."""
    if not _on_cuda(key, sel):
        return topk_candidates_plain(key, sel, desc, c)
    n = int(key.shape[0])
    _vector(key, n, "K7 key")
    _vector(sel, n, "K7 sel")
    if key.dtype not in _INT_DTYPES or key.dtype == torch.bool:
        raise TypeError(f"K7 key must be an integer column, got {key.dtype}")
    if sel.dtype != torch.bool:
        raise TypeError("K7 sel must be bool")
    if not 1 <= c <= n:
        raise ValueError(f"K7 needs 1 <= c <= rows, got c {c}, {n} rows")
    if n >= 2**31:
        raise ValueError("K7 takes at most 2^31 - 1 rows")
    lib = _load()
    dev = key.device
    with torch.cuda.device(dev):
        tile = lib.ob_k7_tile_rows()
        ntiles = -(-n // tile)
        out = torch.empty(c, dtype=torch.int32, device=dev)
        state = torch.empty(-(-lib.ob_k7_state_bytes() // 8),
                            dtype=torch.int64, device=dev)
        hist = torch.empty(256, dtype=torch.int64, device=dev)
        tiles = torch.empty((2, ntiles), dtype=torch.int32, device=dev)
        cand = torch.empty(c, dtype=torch.int32, device=dev)
        rc = lib.ob_k7_topk(
            key.data_ptr(), DTYPE_CODE[key.dtype], sel.data_ptr(),
            int(bool(desc)), n, c, out.data_ptr(), state.data_ptr(),
            hist.data_ptr(), tiles[0].data_ptr(), tiles[1].data_ptr(),
            ntiles, cand.data_ptr(), _blocks(dev, n, 256 * 8), _stream(dev))
        _check(rc, "K7_topk_candidates")
    LAUNCHES["K7_topk_candidates"] += 1
    # K7State: prefix, himask, need, cnt, ngt (int64 each)
    return out, state[3]


# ---------------------------------------------------------------------------
# K8: segmented reduce-by-key over sorted rows
# ---------------------------------------------------------------------------

K8_MAX_KEYS = 16
K8_MAX_AGGS = 16


def _segreduce_dtype(op: str, v) -> torch.dtype:
    if op == "count":
        return torch.int64
    if op == "sum":
        return _acc_dtype("sum", v.dtype)
    return v.dtype


# The segmented scans of the reference's ops/window.py (:31 boundaries,
# :43 segment_starts, :49 peer_ends, :60 segmented_cumsum, :67
# segmented_scan_minmax, :83 suffix_scan_minmax) as plain torch code: K8's
# plain version runs on them, and they are K13's plain versions.
def boundaries_plain(sorted_keys: list[torch.Tensor]) -> torch.Tensor:
    """True where any key column differs from the previous row (or row 0)."""
    if not sorted_keys:
        return torch.zeros(0, dtype=torch.bool)
    n = int(sorted_keys[0].shape[0])
    new = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    if n:
        new[0] = True
    for k in sorted_keys:
        new[1:] |= k[1:] != k[:-1]
    return new


def segment_starts_plain(new_seg: torch.Tensor) -> torch.Tensor:
    """Index of the segment's first row, per row (int64)."""
    idx = torch.arange(new_seg.shape[0], dtype=torch.int64,
                       device=new_seg.device)
    marked = torch.where(new_seg, idx, torch.zeros_like(idx))
    return torch.cummax(marked, 0).values


def peer_ends_plain(new_peer: torch.Tensor) -> torch.Tensor:
    """Index of the peer group's last row, per row (int64)."""
    n = int(new_peer.shape[0])
    idx = torch.arange(n, dtype=torch.int64, device=new_peer.device)
    arr = torch.where(new_peer, idx, torch.full_like(idx, n))
    suffix_min = torch.flip(torch.cummin(torch.flip(arr, [0]), 0).values,
                            [0])
    after = torch.cat([suffix_min[1:], torch.full_like(idx[:1], n)])
    return after - 1


def segmented_cumsum_plain(values: torch.Tensor,
                           seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum within each segment. `values` must already be
    masked (dead/NULL rows contribute 0)."""
    c = torch.cumsum(values, 0)
    return c - c[seg_start] + values[seg_start]


def segmented_scan_minmax_plain(values: torch.Tensor, new_seg: torch.Tensor,
                                is_min: bool) -> torch.Tensor:
    """Inclusive segmented running min/max (NaN propagating, as jnp's
    minimum/maximum); masked rows must carry the identity. A doubling
    scan over (flag, value) pairs, like lax.associative_scan's."""
    v = values.clone()
    f = new_seg.clone()
    n = int(v.shape[0])
    comb = torch.minimum if is_min else torch.maximum
    off = 1
    while off < n:
        nv = torch.where(f[off:], v[off:], comb(v[:-off], v[off:]))
        nf = f[off:] | f[:-off]
        v = torch.cat([v[:off], nv])
        f = torch.cat([f[:off], nf])
        off *= 2
    return v


def segmented_reduce_plain(skeys, ssel, order, aggs):
    """Plain version of K8 (the reduction half of ops/hashagg.py
    sort_groupby on the ops/window.py scans): segment starts where any
    sorted key or the live flag changes; each aggregate's segment total at
    the first row of each live segment, 0 elsewhere; sel = start & live."""
    new_seg = boundaries_plain(list(skeys) + [ssel])
    seg_start = segment_starts_plain(new_seg)
    seg_end = peer_ends_plain(new_seg)
    o = order.to(torch.int64)
    outs = []
    for op, v, m in aggs:
        vm = ssel if m is None else ssel & m[o]
        dt = _segreduce_dtype(op, v)
        zero = torch.zeros((), dtype=dt, device=ssel.device)
        if op == "count":
            run = segmented_cumsum_plain(vm.to(torch.int64), seg_start)
        elif op == "sum":
            run = segmented_cumsum_plain(torch.where(vm, v[o].to(dt), zero),
                                         seg_start)
        elif op in ("min", "max"):
            ident = torch.full((), _identity(op, v.dtype), dtype=v.dtype,
                               device=v.device)
            run = segmented_scan_minmax_plain(torch.where(vm, v[o], ident),
                                              new_seg, op == "min")
        else:
            raise NotImplementedError(op)
        outs.append(torch.where(new_seg & ssel, run[seg_end], zero))
    return new_seg & ssel, outs


def segmented_reduce(skeys, ssel, order, aggs):
    """K8: over rows in sorted order (`skeys` the sorted key columns,
    `ssel` the sorted live flags, `order` the sort order that maps sorted
    positions to value rows), every (op, values|None, mask|None) in `aggs`
    reduced per segment of equal keys, at the segment's first row.
    Returns (sel = segment start & live, [per-aggregate results])."""
    skeys = list(skeys)
    aggs = list(aggs)
    if not _on_cuda(ssel, order, *skeys, *(v for _, v, _ in aggs),
                    *(m for _, _, m in aggs)):
        return segmented_reduce_plain(skeys, ssel, order, aggs)
    n = int(ssel.shape[0])
    _vector(ssel, n, "K8 sorted sel")
    _vector(order, n, "K8 order")
    if ssel.dtype != torch.bool or order.dtype != torch.int32:
        raise TypeError("K8 takes a bool sorted sel and an int32 order")
    if len(skeys) > K8_MAX_KEYS:
        raise ValueError(f"K8 takes at most {K8_MAX_KEYS} keys")
    if len(aggs) > K8_MAX_AGGS:
        raise ValueError(f"K8 takes at most {K8_MAX_AGGS} aggregates")
    for k in skeys:
        _vector(k, n, "K8 sorted key")
    for op, v, m in aggs:
        if op not in AGG_CODE:
            raise NotImplementedError(op)
        if op != "count":
            _vector(v, n, "K8 values")
        if m is not None:
            _vector(m, n, "K8 mask")
            if m.dtype != torch.bool:
                raise TypeError("K8 masks must be bool")
    dev = ssel.device
    sel = torch.empty(n, dtype=torch.bool, device=dev)
    raw = []
    for op, v, _m in aggs:
        fl = op != "count" and v.dtype.is_floating_point
        raw.append(torch.empty(n, dtype=torch.float64 if fl else torch.int64,
                               device=dev))
    if n == 0:
        return sel, [r.to(_segreduce_dtype(op, v))
                     for (op, v, _m), r in zip(aggs, raw)]
    lib = _load()
    with torch.cuda.device(dev):
        tile = lib.ob_k8_tile_rows()
        ntiles = -(-n // tile)
        stream = _stream(dev)
        tile_has = torch.empty(ntiles, dtype=torch.int32, device=dev)
        last_start = torch.empty(ntiles, dtype=torch.int64, device=dev)
        first_flag = torch.empty(ntiles, dtype=torch.uint8, device=dev)
        nk = len(skeys)
        keys = (ctypes.c_void_p * max(nk, 1))(*[k.data_ptr() for k in skeys])
        kdts = (ctypes.c_int * max(nk, 1))(*[DTYPE_CODE[k.dtype]
                                             for k in skeys])
        na = len(aggs)
        k = max(na, 1)
        carries = [torch.empty(ntiles, dtype=r.dtype, device=dev) for r in raw]
        ops = (ctypes.c_int * k)(*[AGG_CODE[op] for op, _v, _m in aggs])
        vals = (ctypes.c_void_p * k)(*[
            v.data_ptr() if op != "count" else None for op, v, _m in aggs])
        vdts = (ctypes.c_int * k)(*[
            DTYPE_CODE[v.dtype] if op != "count" else 0
            for op, v, _m in aggs])
        masks = (ctypes.c_void_p * k)(*[
            m.data_ptr() if m is not None else None for _op, _v, m in aggs])
        outs = (ctypes.c_void_p * k)(*[r.data_ptr() for r in raw])
        carr = (ctypes.c_void_p * k)(*[t.data_ptr() for t in carries])
        isf = (ctypes.c_int * k)(*[
            1 if r.dtype == torch.float64 else 0 for r in raw])
        idents = (ctypes.c_longlong * k)()
        for j, (op, v, _m) in enumerate(aggs):
            idv = _identity(op, v.dtype if op != "count" else torch.int64)
            idents[j] = (struct.unpack("<q", struct.pack("<d", idv))[0]
                         if isf[j] else int(idv))
        rc = lib.ob_k8_segreduce(
            nk, keys, kdts, ssel.data_ptr(), order.data_ptr(), n, na, ops,
            vals, vdts, masks, outs, carr, isf, idents, sel.data_ptr(),
            tile_has.data_ptr(), last_start.data_ptr(), first_flag.data_ptr(),
            ntiles, stream)
        _check(rc, "K8_segmented_reduce")
    res = []
    for (op, v, _m), r in zip(aggs, raw):
        dt = _segreduce_dtype(op, v)
        res.append(r if r.dtype == dt else r.to(dt))
    LAUNCHES["K8_segmented_reduce"] += 1
    return sel, res


# ---------------------------------------------------------------------------
# K5 (second entry): the verified affine probe, no payload
# ---------------------------------------------------------------------------


def affine_probe_plain(probe_key, probe_sel, a0: int, stride: int,
                       build_key, build_sel):
    """Plain version of K5's probe entry (executor._affine_probe): the
    int32 candidate build row where the join keeps the probe row, else
    -1."""
    nb = int(build_key.shape[0])
    pk = probe_key.to(torch.int64)
    off = pk - a0
    cand = torch.div(off, stride, rounding_mode="floor")
    in_range = (off >= 0) & (torch.remainder(off, stride) == 0) & (cand < nb)
    candc = cand.clamp(0, nb - 1)
    hit = (probe_sel & in_range
           & (build_key.to(torch.int64)[candc] == pk) & build_sel[candc])
    return torch.where(hit, candc, -1).to(torch.int32)


def affine_probe(probe_key, probe_sel, a0: int, stride: int, build_key,
                 build_sel):
    """K5's probe entry: int32 [n] match rows (or -1) of probe rows against
    a build side whose key column is a0 + stride * row. Counts as a K5
    launch."""
    if not _on_cuda(probe_key, probe_sel, build_key, build_sel):
        return affine_probe_plain(probe_key, probe_sel, a0, stride,
                                  build_key, build_sel)
    n = int(probe_key.shape[0])
    nb = int(build_key.shape[0])
    _vector(probe_key, n, "K5 probe key")
    _vector(probe_sel, n, "K5 probe sel")
    _vector(build_key, nb, "K5 build key")
    _vector(build_sel, nb, "K5 build sel")
    for k in (probe_key, build_key):
        if k.dtype not in _INT_DTYPES:
            raise TypeError(f"K5 keys must be integers, got {k.dtype}")
    if probe_sel.dtype != torch.bool or build_sel.dtype != torch.bool:
        raise TypeError("K5 sel masks must be bool")
    if stride <= 0 or not 1 <= nb < 2**31:
        raise ValueError(f"K5 needs stride > 0 and 1..2^31-1 build rows, got "
                         f"stride {stride}, {nb} rows")
    dev = probe_key.device
    match = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return match
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k5_probe(
            probe_key.data_ptr(), DTYPE_CODE[probe_key.dtype],
            probe_sel.data_ptr(), n, int(a0), int(stride), nb,
            build_key.data_ptr(), DTYPE_CODE[build_key.dtype],
            build_sel.data_ptr(), match.data_ptr(), _blocks(dev, n, 256 * 4),
            _stream(dev))
        _check(rc, "K5_affine_join probe")
    LAUNCHES["K5_affine_join"] += 1
    ENTRY_LAUNCHES["K5_affine_join.probe"] += 1
    return match


# ---------------------------------------------------------------------------
# K9: unique-build equi-join on one integer key
# ---------------------------------------------------------------------------


def _int_key(k: torch.Tensor, what: str) -> None:
    if k.dtype not in _INT_DTYPES:
        raise TypeError(f"{what} must be an integer column, got {k.dtype}")


def merge_join_plain(build_key, build_sel, probe_key, probe_sel):
    """Plain version of K9 (ops/join.py merge_join_unique): for each probe
    row, the lowest live build row whose key equals its live key, or -1
    (int32, probe order). A stable sort of the live build keys, their
    first rows per key, and a binary search per probe key."""
    npr = int(probe_key.shape[0])
    dev = probe_key.device
    live = torch.nonzero(build_sel).squeeze(1)
    if live.numel() == 0:
        return torch.full((npr,), -1, dtype=torch.int32, device=dev)
    bk = build_key.to(torch.int64)[live]
    order = torch.argsort(bk, stable=True)
    sk, srow = bk[order], live[order]
    first = torch.ones(sk.shape[0], dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    uk, urow = sk[first].contiguous(), srow[first]
    pk = probe_key.to(torch.int64).contiguous()
    pos = torch.searchsorted(uk, pk)
    posc = pos.clamp(max=uk.shape[0] - 1)
    hit = probe_sel & (pos < uk.shape[0]) & (uk[posc] == pk)
    return torch.where(hit, urow[posc], -1).to(torch.int32)


def merge_join(build_key, build_sel, probe_key, probe_sel):
    """K9: int32 [np] match rows of the probe rows (probe order, -1 = no
    match) against a build side joined on one integer key; among equal
    live build keys the lowest row wins."""
    if not _on_cuda(build_key, build_sel, probe_key, probe_sel):
        return merge_join_plain(build_key, build_sel, probe_key, probe_sel)
    nb = int(build_key.shape[0])
    npr = int(probe_key.shape[0])
    _vector(build_key, nb, "K9 build key")
    _vector(build_sel, nb, "K9 build sel")
    _vector(probe_key, npr, "K9 probe key")
    _vector(probe_sel, npr, "K9 probe sel")
    _int_key(build_key, "K9 build key")
    _int_key(probe_key, "K9 probe key")
    if build_sel.dtype != torch.bool or probe_sel.dtype != torch.bool:
        raise TypeError("K9 sel masks must be bool")
    if nb >= 2**30:
        raise ValueError("K9 builds at most 2^30 - 1 rows")
    dev = probe_key.device
    tsize = 1 << max(4, (2 * nb - 1).bit_length())
    slot = torch.empty(tsize, dtype=torch.int32, device=dev)
    match = torch.empty(npr, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k9_merge_join(
            build_key.data_ptr(), DTYPE_CODE[build_key.dtype],
            build_sel.data_ptr(), nb, probe_key.data_ptr(),
            DTYPE_CODE[probe_key.dtype], probe_sel.data_ptr(), npr,
            slot.data_ptr(), tsize, match.data_ptr(),
            _blocks(dev, max(nb, npr, tsize // 4), 256 * 4), _stream(dev))
        _check(rc, "K9_merge_join")
    LAUNCHES["K9_merge_join"] += 1
    return match


# ---------------------------------------------------------------------------
# K10: M:N join expansion against a key-sorted build side
# ---------------------------------------------------------------------------


def _ranges_plain(skeys, nlive, probe_keys, probe_sel):
    """(lo, cnt) int64 per probe row: the searchsorted bounds of each probe
    key in the sorted build keys clamped to the live build count (the
    reference's expand_join), cnt zero at dead probe rows."""
    nl = nlive.to(torch.int64)
    lo = torch.minimum(torch.searchsorted(skeys, probe_keys), nl)
    hi = torch.minimum(torch.searchsorted(skeys, probe_keys, right=True), nl)
    cnt = torch.where(probe_sel, hi - lo, torch.zeros((), dtype=torch.int64,
                                                      device=lo.device))
    return lo, cnt


def join_ranges_plain(skeys, nlive, probe_keys, probe_sel):
    """Plain version of K10's range phase: cnt int64 per probe row."""
    return _ranges_plain(skeys, nlive, probe_keys, probe_sel)[1]


def _check_ranges_args(skeys, nlive, probe_keys, probe_sel):
    nb = int(skeys.shape[0])
    npr = int(probe_keys.shape[0])
    _vector(skeys, nb, "K10 sorted build keys")
    _vector(probe_keys, npr, "K10 probe keys")
    _vector(probe_sel, npr, "K10 probe sel")
    if skeys.dtype != torch.int64 or probe_keys.dtype != torch.int64:
        raise TypeError("K10 keys must be int64")
    if probe_sel.dtype != torch.bool:
        raise TypeError("K10 probe sel must be bool")
    if nlive.numel() != 1 or nlive.dtype != torch.int64:
        raise TypeError("K10 nlive must be one int64")
    if npr >= 2**31:
        raise ValueError("K10 probes at most 2^31 - 1 rows")
    return nb, npr


def join_ranges(skeys, nlive, probe_keys, probe_sel):
    """K10's range phase alone (the sorted-range semi/anti join): cnt
    int64 [np], the live build rows each live probe key matches. Counts as
    a K10 launch."""
    if not _on_cuda(skeys, nlive, probe_keys, probe_sel):
        return join_ranges_plain(skeys, nlive, probe_keys, probe_sel)
    _nb, npr = _check_ranges_args(skeys, nlive, probe_keys, probe_sel)
    dev = probe_keys.device
    cnt = torch.empty(npr, dtype=torch.int64, device=dev)
    nl = nlive.reshape(1).contiguous()
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k10_ranges(
            skeys.data_ptr(), nl.data_ptr(), probe_keys.data_ptr(),
            probe_sel.data_ptr(), npr, cnt.data_ptr(),
            _blocks(dev, npr, 256 * 4), _stream(dev))
        _check(rc, "K10_expand_join ranges")
    LAUNCHES["K10_expand_join"] += 1
    ENTRY_LAUNCHES["K10_expand_join.ranges"] += 1
    return cnt


def expand_join_plain(skeys, order, nlive, probe_keys, probe_sel, cap: int):
    """Plain version of K10 (ops/join.py expand_join, the reference's
    formulas): (probe_row int32 [cap], build_row int32 [cap], valid bool
    [cap], total 0-d int64, starts int64 [np], offs int64 [np])."""
    npr = int(probe_keys.shape[0])
    nb = int(order.shape[0])
    dev = probe_keys.device
    lo, cnt = _ranges_plain(skeys, nlive, probe_keys, probe_sel)
    offs = torch.cumsum(cnt, 0)
    total = offs[-1]
    starts = offs - cnt
    t = torch.arange(cap, dtype=torch.int64, device=dev)
    p = torch.searchsorted(offs, t, right=True)
    pc = p.clamp(0, npr - 1)
    pos = (lo[pc] + (t - starts[pc])).to(torch.int32)
    build_row = order[pos.clamp(0, nb - 1).to(torch.int64)]
    return pc.to(torch.int32), build_row, t < total, total, starts, offs


def expand_join(skeys, order, nlive, probe_keys, probe_sel, cap: int):
    """K10: the M:N expansion of probe rows (int64 keys, sel) against the
    sorted build keys `skeys` (dead tail last), `order` the build row of
    each sorted position and `nlive` the live build count (0-d int64 on
    the device). Returns what expand_join_plain returns, bit for bit."""
    if not _on_cuda(skeys, order, nlive, probe_keys, probe_sel):
        return expand_join_plain(skeys, order, nlive, probe_keys, probe_sel,
                                 cap)
    nb, npr = _check_ranges_args(skeys, nlive, probe_keys, probe_sel)
    _vector(order, nb, "K10 build order")
    if order.dtype != torch.int32:
        raise TypeError("K10 build order must be int32")
    if npr < 1 or nb < 1 or cap < 0:
        raise ValueError(f"K10 needs rows on both sides and cap >= 0, got "
                         f"{npr} probe rows, {nb} build rows, cap {cap}")
    dev = probe_keys.device
    lib = _load()
    tile = lib.ob_k10_tile_rows()
    ntiles = -(-npr // tile)
    i64 = dict(dtype=torch.int64, device=dev)
    lo = torch.empty(npr, **i64)
    cnt = torch.empty(npr, **i64)
    tsum = torch.empty(ntiles, **i64)
    total = torch.empty(1, **i64)
    starts = torch.empty(npr, **i64)
    offs = torch.empty(npr, **i64)
    pr = torch.empty(cap, dtype=torch.int32, device=dev)
    br = torch.empty(cap, dtype=torch.int32, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    nl = nlive.reshape(1).contiguous()
    with torch.cuda.device(dev):
        rc = lib.ob_k10_expand(
            skeys.data_ptr(), order.data_ptr(), nb, nl.data_ptr(),
            probe_keys.data_ptr(), probe_sel.data_ptr(), npr, cap,
            lo.data_ptr(), cnt.data_ptr(), tsum.data_ptr(), ntiles,
            total.data_ptr(), starts.data_ptr(), offs.data_ptr(),
            pr.data_ptr(), br.data_ptr(), valid.data_ptr(),
            _blocks(dev, max(npr, cap), 256 * 4), _stream(dev))
        _check(rc, "K10_expand_join")
    LAUNCHES["K10_expand_join"] += 1
    return pr, br, valid, total[0], starts, offs


# ---------------------------------------------------------------------------
# K11: OR of pair_ok over each probe row's run
# ---------------------------------------------------------------------------


def probe_run_any_plain(pair_ok, starts, offs):
    """Plain version of K11 (ops/join.py probe_run_any): cumsum of pair_ok
    and its differences at the run bounds clamped to the capacity."""
    cap = int(pair_ok.shape[0])
    c = torch.cumsum(pair_ok.to(torch.int64), 0)
    zero = torch.zeros((), dtype=torch.int64, device=c.device)

    def upto(x):
        return torch.where(x > 0, c[(x - 1).clamp(0, cap - 1)], zero)

    return (upto(offs.clamp(max=cap)) - upto(starts.clamp(max=cap))) > 0


def probe_run_any(pair_ok, starts, offs):
    """K11: bool [np], whether any pair_ok in [min(starts, cap),
    min(offs, cap)) is set, per probe row."""
    if not _on_cuda(pair_ok, starts, offs):
        return probe_run_any_plain(pair_ok, starts, offs)
    cap = int(pair_ok.shape[0])
    npr = int(starts.shape[0])
    _vector(pair_ok, cap, "K11 pair_ok")
    _vector(starts, npr, "K11 starts")
    _vector(offs, npr, "K11 offs")
    if pair_ok.dtype != torch.bool:
        raise TypeError("K11 pair_ok must be bool")
    if starts.dtype != torch.int64 or offs.dtype != torch.int64:
        raise TypeError("K11 starts and offs must be int64")
    dev = pair_ok.device
    out = torch.empty(npr, dtype=torch.bool, device=dev)
    if npr == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k11_run_any(pair_ok.data_ptr(), cap, starts.data_ptr(),
                                offs.data_ptr(), npr, out.data_ptr(),
                                _blocks(dev, npr, 256 * 4), _stream(dev))
        _check(rc, "K11_probe_run_any")
    LAUNCHES["K11_probe_run_any"] += 1
    return out


def mark_build_plain(br, pair_sel, nr: int):
    """Plain version of K11's second entry (the full outer join's
    zeros(nr).at[br].max(pair_sel, mode="drop")): bool [nr], set at every
    build row some selected pair slot names; rows outside [0, nr) drop."""
    has = torch.zeros(nr, dtype=torch.bool, device=pair_sel.device)
    b = br.to(torch.int64)
    keep = pair_sel & (b >= 0) & (b < nr)
    has[b[keep]] = True
    return has


def mark_build(br, pair_sel, nr: int):
    """K11's second entry: bool [nr], whether any selected pair slot joins
    each build row. Counts as a K11 launch."""
    if not _on_cuda(br, pair_sel):
        return mark_build_plain(br, pair_sel, nr)
    cap = int(br.shape[0])
    _vector(br, cap, "K11 build rows")
    _vector(pair_sel, cap, "K11 pair sel")
    if br.dtype != torch.int32 or pair_sel.dtype != torch.bool:
        raise TypeError("K11 marks take int32 build rows and a bool sel")
    dev = br.device
    has = torch.zeros(nr, dtype=torch.bool, device=dev)
    if cap == 0 or nr == 0:
        return has
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k11_mark_build(br.data_ptr(), pair_sel.data_ptr(), cap,
                                   nr, has.data_ptr(),
                                   _blocks(dev, cap, 256 * 4), _stream(dev))
        _check(rc, "K11_probe_run_any mark_build")
    LAUNCHES["K11_probe_run_any"] += 1
    ENTRY_LAUNCHES["K11_probe_run_any.mark_build"] += 1
    return has


# ---------------------------------------------------------------------------
# K12: splitmix64 hash of multi-column keys
# ---------------------------------------------------------------------------

K12_MAX_COLS = 8


def _i64(u: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


MIX_C1 = _i64(0xBF58476D1CE4E5B9)
MIX_C2 = _i64(0x94D049BB133111EB)
GOLDEN64 = _i64(0x9E3779B97F4A7C15)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits: the arithmetic shift with its
    sign bits masked off (torch has no uint64 shift)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64_plain(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (ops/hashing.py mix64) on int64 bits: int64
    multiplies and adds wrap modulo 2^64 as uint64 ones do, and the shifts
    are logical."""
    x = x.to(torch.int64)
    x = (x ^ _shr(x, 30)) * MIX_C1
    x = (x ^ _shr(x, 27)) * MIX_C2
    return x ^ _shr(x, 31)


def _hash_operand(c: torch.Tensor) -> torch.Tensor:
    if c.dtype.is_floating_point:
        raise NotImplementedError("hash of float key columns is not ported")
    return c.to(torch.int64)  # sign-extends, as astype(uint64) converts


def hash_columns_plain(cols):
    """Plain version of K12 (ops/hashing.py hash_combine, read as int64 as
    join_keys64 does)."""
    h = torch.zeros(cols[0].shape, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        h = mix64_plain(h ^ (_hash_operand(c) + GOLDEN64))
    return h


def hash_columns(cols):
    """K12: int64 [n] hash_combine of 1..8 integer key columns."""
    cols = list(cols)
    if not cols:
        raise ValueError("K12 needs at least one column")
    if not _on_cuda(*cols):
        return hash_columns_plain(cols)
    n = int(cols[0].shape[0])
    if len(cols) > K12_MAX_COLS:
        raise ValueError(f"K12 takes at most {K12_MAX_COLS} columns")
    for c in cols:
        _vector(c, n, "K12 key column")
        if c.dtype.is_floating_point:
            raise NotImplementedError(
                "hash of float key columns is not ported")
    dev = cols[0].device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        nc = len(cols)
        rc = lib.ob_k12_hash(
            nc, (ctypes.c_void_p * nc)(*[c.data_ptr() for c in cols]),
            (ctypes.c_int * nc)(*[DTYPE_CODE[c.dtype] for c in cols]), n,
            out.data_ptr(), _blocks(dev, n, 256 * 4), _stream(dev))
        _check(rc, "K12_hash_combine")
    LAUNCHES["K12_hash_combine"] += 1
    return out


# ---------------------------------------------------------------------------
# K13: the scans of window functions and of INTERSECT/EXCEPT ALL
# ---------------------------------------------------------------------------

K13_MAX_KEYS = 16
# value modes of ob_k13_scan (csrc/k13_window_scan.cu)
_K13_VAL, _K13_START_MARK, _K13_END_MARK = 0, 1, 2
_I64_MAX = 2**63 - 1


def _f64_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


def _k13_scan(x, flags, mode: int, op: str, reverse: bool, segmented: bool,
              n: int, out_dtype: torch.dtype, dev: torch.device):
    """One K13 scan launch (three kernels: tile pairs, carries, scan)."""
    out = torch.empty(n, dtype=out_dtype, device=dev)
    if n == 0:
        return out
    if op == "sum":
        ident = 0
    elif out_dtype.is_floating_point:
        ident = _f64_bits(float("inf") if op == "min" else float("-inf"))
    else:
        ident = _I64_MAX if op == "min" else _I64_MIN
    lib = _load()
    with torch.cuda.device(dev):
        ntiles = -(-n // lib.ob_k13_tile_rows())
        tile_v = torch.empty(ntiles, dtype=torch.int64, device=dev)
        tile_f = torch.empty(ntiles, dtype=torch.int32, device=dev)
        rc = lib.ob_k13_scan(
            x.data_ptr() if x is not None else None,
            DTYPE_CODE[x.dtype] if x is not None else 0,
            flags.data_ptr() if flags is not None else None, mode,
            AGG_CODE[op], int(reverse), int(segmented), n, out.data_ptr(),
            DTYPE_CODE[out_dtype], ident, tile_v.data_ptr(),
            tile_f.data_ptr(), ntiles, _stream(dev))
        _check(rc, "K13_window_scan")
    LAUNCHES["K13_window_scan"] += 1
    return out


def _flags_arg(flags: torch.Tensor, what: str) -> int:
    n = int(flags.shape[0])
    _vector(flags, n, what)
    if flags.dtype != torch.bool:
        raise TypeError(f"{what} must be bool")
    return n


def boundaries(sorted_keys):
    """K13: bool [n], set at row 0 and wherever any of the sorted key
    columns differs (`!=`) from the previous row."""
    keys = list(sorted_keys)
    if not keys:
        return torch.zeros(0, dtype=torch.bool)
    if not _on_cuda(*keys):
        return boundaries_plain(keys)
    n = int(keys[0].shape[0])
    for k in keys:
        _vector(k, n, "K13 key")
    dev = keys[0].device
    out = None
    lib = _load()
    with torch.cuda.device(dev):
        for c0 in range(0, len(keys), K13_MAX_KEYS):
            part = keys[c0:c0 + K13_MAX_KEYS]
            nk = len(part)
            got = torch.empty(n, dtype=torch.bool, device=dev)
            rc = lib.ob_k13_flags(
                nk, (ctypes.c_void_p * nk)(*[k.data_ptr() for k in part]),
                (ctypes.c_int * nk)(*[DTYPE_CODE[k.dtype] for k in part]), n,
                got.data_ptr(), _blocks(dev, n, 256 * 4), _stream(dev))
            _check(rc, "K13_window_scan flags")
            LAUNCHES["K13_window_scan"] += 1
            out = got if out is None else out | got
    return out


def segment_starts(new_seg: torch.Tensor) -> torch.Tensor:
    """K13: int64 [n], the index of each row's segment start (the cummax
    of the flagged positions)."""
    if not _on_cuda(new_seg):
        return segment_starts_plain(new_seg)
    n = _flags_arg(new_seg, "K13 segment flags")
    return _k13_scan(None, new_seg, _K13_START_MARK, "max", False, False, n,
                     torch.int64, new_seg.device)


def peer_ends(new_peer: torch.Tensor) -> torch.Tensor:
    """K13: int64 [n], the index of each row's last peer (the reversed
    cummin of the flagged next starts)."""
    if not _on_cuda(new_peer):
        return peer_ends_plain(new_peer)
    n = _flags_arg(new_peer, "K13 peer flags")
    return _k13_scan(None, new_peer, _K13_END_MARK, "min", True, False, n,
                     torch.int64, new_peer.device)


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K13's sum: the inclusive cumsum in x's type."""
    return torch.cumsum(x, 0)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """K13: the inclusive prefix sum of an int64, float32 or float64
    column, in its type (floats add in double, in tile order)."""
    if not _on_cuda(x):
        return prefix_sum_plain(x)
    n = int(x.shape[0])
    _vector(x, n, "K13 values")
    if x.dtype not in (torch.int64, torch.float32, torch.float64):
        raise TypeError(f"K13 sums int64 or float columns, got {x.dtype}")
    return _k13_scan(x, None, _K13_VAL, "sum", False, False, n, x.dtype,
                     x.device)


def _minmax_args(values, new_seg):
    n = int(values.shape[0])
    _vector(values, n, "K13 values")
    if values.dtype == torch.bool:
        raise TypeError("K13 min/max takes numeric values")
    if _flags_arg(new_seg, "K13 segment flags") != n:
        raise ValueError("K13 values and flags differ in length")
    return n


def segmented_scan_minmax(values: torch.Tensor, new_seg: torch.Tensor,
                          is_min: bool) -> torch.Tensor:
    """K13: inclusive running min/max within each segment (NaN
    propagating); masked rows must carry the identity."""
    if not _on_cuda(values, new_seg):
        return segmented_scan_minmax_plain(values, new_seg, is_min)
    n = _minmax_args(values, new_seg)
    return _k13_scan(values, new_seg, _K13_VAL, "min" if is_min else "max",
                     False, True, n, values.dtype, values.device)


def suffix_scan_minmax_plain(values: torch.Tensor, new_seg: torch.Tensor,
                             is_min: bool) -> torch.Tensor:
    """Plain version of K13's backward min/max (ops/window.py:83): the
    forward scan over the reversed rows with the segments' last rows as
    starts."""
    seg_last = torch.cat([new_seg[1:],
                          torch.ones(1, dtype=torch.bool,
                                     device=new_seg.device)])
    out = segmented_scan_minmax_plain(torch.flip(values, [0]),
                                      torch.flip(seg_last, [0]), is_min)
    return torch.flip(out, [0])


def suffix_scan_minmax(values: torch.Tensor, new_seg: torch.Tensor,
                       is_min: bool) -> torch.Tensor:
    """K13: min/max over [row, its segment's last row], per row."""
    if not _on_cuda(values, new_seg):
        return suffix_scan_minmax_plain(values, new_seg, is_min)
    n = _minmax_args(values, new_seg)
    return _k13_scan(values, new_seg, _K13_VAL, "min" if is_min else "max",
                     True, True, n, values.dtype, values.device)


def bound_search_plain(arr, target, lo=None, hi=None, right: bool = False):
    """Plain version of K13's search: searchsorted over the whole array
    when no ranges are given (the packed frame search), else the
    reference's 34-round binary search of each target inside its own
    [lo, hi) (executor._emit_window's _lex_bound)."""
    if lo is None:
        return torch.searchsorted(arr, target, right=right)
    n = int(arr.shape[0])
    l, h = lo.clone(), hi.clone()
    for _ in range(34):
        mid = (l + h) >> 1
        kv = arr[mid.clamp(0, n - 1)]
        go = (kv <= target) if right else (kv < target)
        act = l < h
        l = torch.where(act & go, mid + 1, l)
        h = torch.where(act & ~go, mid, h)
    return l


def bound_search(arr, target, lo=None, hi=None, right: bool = False):
    """K13: int64 [m], the first position p in [lo, hi) (all of arr when
    no ranges are given) with arr[p] > target (right) or >= target,
    else hi, for each target; arr ascends over every searched range."""
    if not _on_cuda(arr, target, lo, hi):
        return bound_search_plain(arr, target, lo, hi, right)
    n = int(arr.shape[0])
    m = int(target.shape[0])
    _vector(arr, n, "K13 search array")
    _vector(target, m, "K13 search targets")
    for t in (lo, hi):
        if t is not None:
            _vector(t, m, "K13 search range")
            if t.dtype != torch.int64:
                raise TypeError("K13 search ranges must be int64")
    if (lo is None) != (hi is None):
        raise ValueError("K13 search takes both range ends or neither")
    if arr.dtype != torch.int64 or target.dtype != torch.int64:
        raise TypeError("K13 searches int64 arrays")
    if n < 1:
        raise ValueError("K13 searches a non-empty array")
    dev = arr.device
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k13_search(
            arr.data_ptr(), n, target.data_ptr(),
            lo.data_ptr() if lo is not None else None,
            hi.data_ptr() if hi is not None else None, int(bool(right)), m,
            out.data_ptr(), _blocks(dev, m, 256 * 4), _stream(dev))
        _check(rc, "K13_window_scan search")
    LAUNCHES["K13_window_scan"] += 1
    return out


# ---------------------------------------------------------------------------
# K14: the multi-column hash set (build and existence probe)
# ---------------------------------------------------------------------------

K14_MAX_COLS = 16
M32 = 0xFFFFFFFF
MIX32_M1 = 0x85EBCA6B
MIX32_M2 = 0xC2B2AE35
GOLDEN32 = 0x9E3779B9
_I32_MAX = 2**31 - 1


def mix32_plain(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 (ops/hashing.py mix32) on uint32 values held in
    int64: the products wrap modulo 2^64 and keep their low 32 bits."""
    x = x.to(torch.int64) & M32
    x = ((x ^ (x >> 16)) * MIX32_M1) & M32
    x = ((x ^ (x >> 13)) * MIX32_M2) & M32
    return x ^ (x >> 16)


def _sat_int32(c: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA converts: truncation, saturation, NaN -> 0."""
    d = torch.nan_to_num(c.to(torch.float64), nan=0.0, posinf=2.0**31,
                         neginf=-(2.0**31))
    return torch.trunc(d).clamp(-(2.0**31), 2.0**31 - 1).to(torch.int64)


def _sat_uint64_bits(c: torch.Tensor) -> torch.Tensor:
    """float64 -> uint64 as XLA converts (truncation, saturation at 0 and
    2^64 - 1, NaN -> 0), as the int64 with the same bits."""
    d = torch.trunc(torch.nan_to_num(c.to(torch.float64), nan=0.0,
                                     posinf=2.0**64, neginf=0.0))
    zero = torch.zeros_like(d)
    low = torch.where(d < 2.0**63, d, zero).clamp(min=0.0).to(torch.int64)
    high = torch.where((d >= 2.0**63) & (d < 2.0**64), d - 2.0**63,
                       zero).to(torch.int64) + _I64_MIN
    return torch.where(d >= 2.0**64, torch.full_like(low, -1),
                       torch.where(d >= 2.0**63, high, low))


def fold32_plain(c: torch.Tensor) -> torch.Tensor:
    """ops/hashing.py fold32 as uint32 values in int64: columns of at most
    4 bytes convert to int32 and fold the sign in, 8-byte columns convert
    to uint64 and xor-fold the high word (a logical shift)."""
    if c.element_size() <= 4:
        i = _sat_int32(c) if c.dtype.is_floating_point else c.to(torch.int64)
        return (i ^ (i >> 31)) & M32
    u = _sat_uint64_bits(c) if c.dtype.is_floating_point else c.to(torch.int64)
    return (u ^ _shr(u, 32)) & M32


def hash32_combine_plain(cols) -> torch.Tensor:
    """ops/hashing.py hash32_combine as uint32 values in int64."""
    h = torch.zeros(cols[0].shape, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        h = mix32_plain(h ^ ((fold32_plain(c) + GOLDEN32) & M32))
    return h


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def hash_set_build_plain(key_cols, mask: torch.Tensor, table_size: int):
    """Plain version of K14's build (ops/join.py build_hash_table over
    ops/hashagg.py assign_group_slots): every live row probes in lockstep,
    the lowest row id wins each empty slot, rows meeting an equal tag and
    key tuple join its slot, the others advance. Returns (slot_tag,
    slot_row) int32 [T]; empty slots hold row -1, tag 0."""
    cols = list(key_cols)
    n = int(cols[0].shape[0])
    ts = int(table_size)
    dev = mask.device
    tags64 = hash32_combine_plain(cols)
    tags = _as_int32(tags64)
    h = tags64 & (ts - 1)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    slot_tag = torch.zeros(ts + 1, dtype=torch.int32, device=dev)
    slot_row = torch.full((ts + 1,), -1, dtype=torch.int32, device=dev)
    pending = mask.clone()
    probe_of = torch.zeros(n, dtype=torch.int64, device=dev)
    rnd = 0
    while rnd < ts and bool(pending.any()):
        pos = (h + probe_of) & (ts - 1)
        at_raw = slot_row[pos]
        at_used = at_raw >= 0
        at_tag = slot_tag[pos]
        at_row = at_raw.to(torch.int64).clamp(0, max(n - 1, 0))
        exact = torch.ones(n, dtype=torch.bool, device=dev)
        for c in cols:
            exact &= c[at_row] == c
        same = pending & at_used & (at_tag == tags) & exact
        want = pending & ~at_used
        claim = torch.full((ts + 1,), _I32_MAX, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(want, pos, ts), rows, "amin")
        winner = want & (claim[pos] == rows)
        wpos = torch.where(winner, pos, ts)
        slot_tag[wpos] = tags
        slot_row[wpos] = rows.to(torch.int32)
        pending = pending & ~(winner | same)
        advance = pending & at_used & ~((at_tag == tags) & exact)
        probe_of = probe_of + advance.to(torch.int64)
        rnd += 1
    return slot_tag[:ts].clone(), slot_row[:ts].clone()


def hash_set_probe_plain(slot_tag, slot_row, build_cols, probe_cols,
                         probe_mask):
    """Plain version of K14's probe (ops/join.py hash_join_probe): int32
    [np], the build row of the first slot on each live probe row's path
    with an equal tag and an equal key tuple, -1 past the first empty
    slot."""
    ts = int(slot_tag.shape[0])
    nb = int(build_cols[0].shape[0])
    n = int(probe_cols[0].shape[0])
    dev = probe_mask.device
    tags64 = hash32_combine_plain(list(probe_cols))
    tags = _as_int32(tags64)
    h = tags64 & (ts - 1)
    pending = probe_mask.clone()
    match = torch.full((n,), -1, dtype=torch.int32, device=dev)
    probe = 0
    while probe < ts and bool(pending.any()):
        pos = (h + probe) & (ts - 1)
        at_raw = slot_row[pos]
        empty = at_raw < 0
        at_row = at_raw.to(torch.int64).clamp(0, max(nb - 1, 0))
        exact = torch.ones(n, dtype=torch.bool, device=dev)
        for bc, pc in zip(build_cols, probe_cols):
            exact &= bc[at_row] == pc
        hit = pending & ~empty & (slot_tag[pos] == tags) & exact
        match = torch.where(hit, at_raw, match)
        pending = pending & ~hit & ~empty
        probe += 1
    return match


def _k14_cols(cols, n: int, what: str):
    if not 1 <= len(cols) <= K14_MAX_COLS:
        raise ValueError(f"K14 takes 1..{K14_MAX_COLS} key columns")
    for c in cols:
        _vector(c, n, what)
    k = len(cols)
    return ((ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
            (ctypes.c_int * k)(*[DTYPE_CODE[c.dtype] for c in cols]))


def hash_set_build(key_cols, mask: torch.Tensor, table_size: int):
    """K14 build: (slot_tag, slot_row) int32 [table_size] of the live rows'
    key tuples; a slot's row is the lowest live row of its key. Which key
    sits in which slot depends on the schedule; hash_set_probe's result
    does not."""
    cols = list(key_cols)
    if not _on_cuda(mask, *cols):
        return hash_set_build_plain(cols, mask, table_size)
    nb = int(mask.shape[0])
    _flags_arg(mask, "K14 build sel")
    ptrs, dts = _k14_cols(cols, nb, "K14 build key")
    ts = int(table_size)
    if ts < 2 * nb or ts & (ts - 1) or nb >= 2**31:
        raise ValueError(f"K14 needs a power-of-two table of >= 2 x {nb} "
                         f"slots, got {ts}")
    dev = mask.device
    slot_tag = torch.empty(ts, dtype=torch.int32, device=dev)
    slot_row = torch.empty(ts, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k14_build(len(cols), ptrs, dts, mask.data_ptr(), nb,
                              slot_tag.data_ptr(), slot_row.data_ptr(), ts,
                              _blocks(dev, max(nb, ts // 4), 256 * 4),
                              _stream(dev))
        _check(rc, "K14_hash_set build")
    LAUNCHES["K14_hash_set"] += 1
    return slot_tag, slot_row


def hash_set_probe(slot_tag, slot_row, build_cols, probe_cols, probe_mask):
    """K14 probe: int32 [np], per live probe row the lowest live build row
    with an equal key tuple (and tag), else -1."""
    bcols, pcols = list(build_cols), list(probe_cols)
    if len(bcols) != len(pcols):
        raise ValueError("K14 probes as many columns as it built")
    if not _on_cuda(slot_tag, slot_row, probe_mask, *bcols, *pcols):
        return hash_set_probe_plain(slot_tag, slot_row, bcols, pcols,
                                    probe_mask)
    ts = int(slot_tag.shape[0])
    _vector(slot_tag, ts, "K14 slot tags")
    _vector(slot_row, ts, "K14 slot rows")
    if slot_tag.dtype != torch.int32 or slot_row.dtype != torch.int32:
        raise TypeError("K14 slots must be int32")
    npr = _flags_arg(probe_mask, "K14 probe sel")
    bp, bd = _k14_cols(bcols, int(bcols[0].shape[0]), "K14 build key")
    pp, pd = _k14_cols(pcols, npr, "K14 probe key")
    dev = probe_mask.device
    match = torch.empty(npr, dtype=torch.int32, device=dev)
    if npr == 0:
        return match
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k14_probe(len(bcols), bp, bd, pp, pd,
                              probe_mask.data_ptr(), npr, slot_tag.data_ptr(),
                              slot_row.data_ptr(), ts, match.data_ptr(),
                              _blocks(dev, npr, 256 * 4), _stream(dev))
        _check(rc, "K14_hash_set probe")
    LAUNCHES["K14_hash_set"] += 1
    return match


# ---------------------------------------------------------------------------
# K15: first occurrences through a sort order; rows back through it
# ---------------------------------------------------------------------------

K15_MAX_COLS = 16
K15_MAX_SCATTER = 48


def first_occurrence_plain(key_cols, mask: torch.Tensor, order: torch.Tensor):
    """Plain version of K15 (the tail of ops/hashagg.py
    distinct_first_mask): run boundaries over (dead, keys...) in sorted
    order, live run starts, mapped back by the inverse permutation."""
    o = order.to(torch.int64)
    sdead = (~mask)[o]
    new_run = boundaries_plain([sdead] + [k[o] for k in key_cols])
    first = new_run & ~sdead
    return first[torch.argsort(o)]


def first_occurrence(key_cols, mask: torch.Tensor, order: torch.Tensor):
    """K15: bool [n] in row order, set at the first live row of every run
    of equal (keys...) along `order` (K3's stable order of (dead,
    keys...))."""
    cols = list(key_cols)
    if not _on_cuda(mask, order, *cols):
        return first_occurrence_plain(cols, mask, order)
    n = _flags_arg(mask, "K15 mask")
    _vector(order, n, "K15 order")
    if order.dtype != torch.int32:
        raise TypeError("K15 order must be int32")
    if not 1 <= len(cols) <= K15_MAX_COLS:
        raise ValueError(f"K15 takes 1..{K15_MAX_COLS} key columns")
    for c in cols:
        _vector(c, n, "K15 key")
    dev = mask.device
    first = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return first
    lib = _load()
    with torch.cuda.device(dev):
        k = len(cols)
        rc = lib.ob_k15_first(
            k, (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols]),
            (ctypes.c_int * k)(*[DTYPE_CODE[c.dtype] for c in cols]),
            mask.data_ptr(), order.data_ptr(), n, first.data_ptr(),
            _blocks(dev, n, 256 * 4), _stream(dev))
        _check(rc, "K15_distinct_first")
    LAUNCHES["K15_distinct_first"] += 1
    return first


def scatter_rows_plain(cols, order: torch.Tensor):
    """Plain version of K15's scatter (executor._emit_window's write-back):
    each column gathered by the inverse permutation, argsort(order)."""
    inv = torch.argsort(order.to(torch.int64))
    return [c[inv] for c in cols]


def scatter_rows(cols, order: torch.Tensor):
    """K15's second entry: out[c][order[i]] = cols[c][i] for every column,
    order a permutation. Counts as a K15 launch."""
    cols = list(cols)
    if not cols:
        return []
    if not _on_cuda(order, *cols):
        return scatter_rows_plain(cols, order)
    n = int(order.shape[0])
    _vector(order, n, "K15 order")
    if order.dtype != torch.int32:
        raise TypeError("K15 order must be int32")
    for c in cols:
        _vector(c, n, "K15 column")
        if c.element_size() not in _WIDTHS:
            raise TypeError(f"K15 column width {c.element_size()}")
    outs = [torch.empty_like(c) for c in cols]
    if n == 0:
        return outs
    dev = order.device
    inv = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        for c0 in range(0, len(cols), K15_MAX_SCATTER):
            part = list(range(c0, min(c0 + K15_MAX_SCATTER, len(cols))))
            k = len(part)
            rc = lib.ob_k15_scatter(
                k, (ctypes.c_void_p * k)(*[cols[i].data_ptr() for i in part]),
                (ctypes.c_void_p * k)(*[outs[i].data_ptr() for i in part]),
                (ctypes.c_int * k)(*[cols[i].element_size() for i in part]),
                order.data_ptr(), inv.data_ptr(), n, _blocks(dev, n, 256 * 4),
                _stream(dev))
            _check(rc, "K15_distinct_first scatter")
    LAUNCHES["K15_distinct_first"] += 1
    ENTRY_LAUNCHES["K15_distinct_first.scatter"] += 1
    return outs


# ---------------------------------------------------------------------------
# K16: HyperLogLog registers
# ---------------------------------------------------------------------------

HLL_M_LOG2 = 14
HLL_M = 1 << HLL_M_LOG2
_RANK_BITS = 6


def hll_hashes_plain(col: torch.Tensor):
    """ops/hll.py _two_hashes as uint32 values in int64: floats widen to
    float64 and fold by their bits."""
    if col.dtype.is_floating_point:
        col = col.to(torch.float64).view(torch.int64)
    f = fold32_plain(col)
    h1 = mix32_plain((f + GOLDEN32) & M32)
    h2 = mix32_plain(h1 ^ f ^ MIX32_M1)
    return h1, h2


def _bit_length32(x: torch.Tensor) -> torch.Tensor:
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        x = torch.where(big, x >> s, x)
        n = n + torch.where(big, s, 0)
    return n + (x > 0).to(torch.int64)


def hll_registers_plain(col: torch.Tensor, mask: torch.Tensor):
    """Plain version of K16 (ops/hll.py hll_registers): rank = 33 -
    bit_length(h2), which is the reference's 32 - floor(log2(h2)) and 33
    for h2 = 0; (bucket << 6 | rank) of the live rows sorted, and each
    register the rank of the largest entry of its bucket (0 if none)."""
    dev = mask.device
    if int(mask.shape[0]) == 0:
        return torch.zeros(HLL_M, dtype=torch.int32, device=dev)
    h1, h2 = hll_hashes_plain(col)
    bucket = h1 & (HLL_M - 1)
    rank = torch.where(h2 == 0, 33, 33 - _bit_length32(h2))
    packed = torch.where(mask, (bucket << _RANK_BITS) | rank, -1).to(
        torch.int32)
    sp = torch.sort(packed).values
    buckets = torch.arange(HLL_M, dtype=torch.int32, device=dev)
    pos = torch.searchsorted(sp, (buckets + 1) << _RANK_BITS) - 1
    v = sp[pos.clamp(min=0)]
    hit = (pos >= 0) & (v >= (buckets << _RANK_BITS)) & (v >= 0)
    return torch.where(hit, v & ((1 << _RANK_BITS) - 1), 0).to(torch.int32)


def hll_registers(col: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K16: int32 [16384] HyperLogLog registers of the values where mask
    is set."""
    if not _on_cuda(col, mask):
        return hll_registers_plain(col, mask)
    n = _flags_arg(mask, "K16 mask")
    _vector(col, n, "K16 values")
    dev = mask.device
    regs = torch.empty(HLL_M, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nb = max(1, min(-(-max(n, 1) // (512 * 16)), sms * 2))
        rc = lib.ob_k16_registers(col.data_ptr(), DTYPE_CODE[col.dtype],
                                  mask.data_ptr(), n, regs.data_ptr(), nb,
                                  _stream(dev))
        _check(rc, "K16_hll")
    LAUNCHES["K16_hll"] += 1
    return regs


# ---------------------------------------------------------------------------
# K17: the range slice of a sorted-projection scan
# ---------------------------------------------------------------------------

K17_MAX_COLS = 48
K17_MAX_BOUNDS = 16
_RANGE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def slice_scan_plain(key, n: int, lows, highs, cap: int, payload, sel):
    """Plain version of K17 (executor._slice_sorted_scan): lo/hi from
    searchsorted over key[:n] (each bound a 0-d tensor cast to the key's
    type first), start = clip(lo, 0, capacity - cap), and the `cap` rows
    from start of every payload column and of sel, sel cleared outside
    [lo, hi). Returns (payload slices, sel, nrows, overflow), the last two
    0-d int64 tensors."""
    dev = sel.device
    kcol = key[:n]
    lo = torch.zeros((), dtype=torch.int64, device=dev)
    hi = torch.full((), n, dtype=torch.int64, device=dev)
    for v, side in lows:
        pos = torch.searchsorted(kcol, v.to(kcol.dtype).reshape(1),
                                 right=side == "right")
        lo = torch.maximum(lo, pos[0].to(torch.int64))
    for v, side in highs:
        pos = torch.searchsorted(kcol, v.to(kcol.dtype).reshape(1),
                                 right=side == "right")
        hi = torch.minimum(hi, pos[0].to(torch.int64))
    hi = torch.maximum(hi, lo)
    cap2 = int(sel.shape[0])
    start = torch.clamp(lo, 0, cap2 - cap)
    gidx = start + torch.arange(cap, dtype=torch.int64, device=dev)
    in_range = (gidx >= lo) & (gidx < hi)
    outs = [c[gidx] for c in payload]
    osel = sel[gidx] & in_range
    return (outs, osel, torch.sum(osel, dtype=torch.int64),
            torch.clamp((hi - lo) - cap, min=0))


def slice_scan(key, n: int, lows, highs, cap: int, payload, sel):
    """K17: the sliced payload columns, sel, nrows and overflow of a
    sorted-projection scan, in one launch; the bounds are read on the
    device. lows/highs: lists of (0-d tensor, 'left'|'right')."""
    bvals = [v for v, _s in lows] + [v for v, _s in highs]
    payload = list(payload)
    if not _on_cuda(key, sel, *payload, *bvals):
        return slice_scan_plain(key, n, lows, highs, cap, payload, sel)
    cap2 = int(sel.shape[0])
    _vector(key, cap2, "K17 key")
    _vector(sel, cap2, "K17 sel")
    if key.dtype not in _RANGE_DTYPES:
        raise TypeError(f"K17 keys are integers, got {key.dtype}")
    if sel.dtype != torch.bool:
        raise TypeError("K17 sel must be bool")
    if not 0 < cap < cap2 or n > cap2:
        raise ValueError(f"K17 slices {cap} of {cap2} rows ({n} stored)")
    if len(bvals) > K17_MAX_BOUNDS:
        raise ValueError(f"K17 takes at most {K17_MAX_BOUNDS} bounds")
    if len(payload) > K17_MAX_COLS:
        raise ValueError(f"K17 takes at most {K17_MAX_COLS} columns")
    for v in bvals:
        if v.numel() != 1 or v.dtype not in _RANGE_DTYPES:
            raise TypeError("K17 bounds are integer scalars")
    for c in payload:
        _vector(c, cap2, "K17 column")
        if c.element_size() not in _WIDTHS:
            raise TypeError(f"K17 column width {c.element_size()}")
    dev = sel.device
    outs = [torch.empty(cap, dtype=c.dtype, device=dev) for c in payload]
    osel = torch.empty(cap, dtype=torch.bool, device=dev)
    nrows = torch.zeros((), dtype=torch.int64, device=dev)
    ovf = torch.empty((), dtype=torch.int64, device=dev)
    order = sorted(range(len(payload)),
                   key=lambda i: payload[i].element_size())
    nc = len(order)
    src = (ctypes.c_void_p * max(nc, 1))(
        *[payload[i].data_ptr() for i in order])
    dst = (ctypes.c_void_p * max(nc, 1))(*[outs[i].data_ptr() for i in order])
    gstart = (ctypes.c_int * 5)()
    gwidth = (ctypes.c_int * 4)(*_WIDTHS)
    for g, w in enumerate(_WIDTHS):
        gstart[g + 1] = gstart[g] + sum(
            1 for i in order if payload[i].element_size() == w)
    nb = len(bvals)
    bval = (ctypes.c_void_p * max(nb, 1))(*[v.data_ptr() for v in bvals])
    bdt = (ctypes.c_int * max(nb, 1))(*[DTYPE_CODE[v.dtype] for v in bvals])
    sides = [s for _v, s in lows] + [s for _v, s in highs]
    bflag = (ctypes.c_int * max(nb, 1))(*[
        int(side == "right") | (2 if i >= len(lows) else 0)
        for i, side in enumerate(sides)])
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k17_slice(
            key.data_ptr(), DTYPE_CODE[key.dtype], n, cap, cap2, nb, bval,
            bdt, bflag, nc, src, dst, gstart, gwidth, sel.data_ptr(),
            osel.data_ptr(), nrows.data_ptr(), ovf.data_ptr(),
            _blocks(dev, cap, 256 * 4), _stream(dev))
        _check(rc, "K17_slice_scan")
    LAUNCHES["K17_slice_scan"] += 1
    return outs, osel, nrows, ovf


# ---------------------------------------------------------------------------
# K18: the device decode of a wire-encoded streamed chunk
# ---------------------------------------------------------------------------

K18_MAX_COLS = 32
# wire-plan kinds (engine/pipeline.py) and their codes in the kernel
K18_KIND = {"raw": 0, "for": 0, "rle": 1, "bits": 2}
# element types of staged arrays: DTYPE_CODE plus the narrow unsigned ones
K18_DTYPE = {**DTYPE_CODE, torch.uint16: 8, torch.uint32: 9}
_UNSIGNED_VIEW = {torch.uint16: (torch.int16, 0xFFFF),
                  torch.uint32: (torch.int32, 0xFFFFFFFF)}


def _widen_plain(t: torch.Tensor) -> torch.Tensor:
    """A staged array ready for .to(storage): uint16/uint32 (which torch
    converts with few ops) zero-extend to int64 through a signed view."""
    hit = _UNSIGNED_VIEW.get(t.dtype)
    if hit is None:
        return t
    signed, mask = hit
    return t.view(signed).to(torch.int64) & mask


def _base_tensor(b, dtype: torch.dtype, dev) -> torch.Tensor:
    return torch.tensor(b.item() if hasattr(b, "item") else b, dtype=dtype,
                        device=dev)


def decode_staged_plain(staged, bases, count: int, meta, cap: int,
                        dtypes, device):
    """Plain version of K18 (pipeline._decode_staged): {key: column} and
    sel for one staged chunk. dtypes: key -> storage torch dtype (bool for
    the `#v:` bitmaps)."""
    out = {}
    idx = torch.arange(cap, dtype=torch.int64, device=device)
    for k, kind in meta:
        if kind == "bits":
            packed = staged[k].to(torch.int64)
            out[k] = ((packed[idx >> 3] >> (idx & 7)) & 1) != 0
        elif kind == "rle":
            vals, lens = staged[k]
            b = _base_tensor(bases[k], dtypes[k], device)
            ends = torch.cumsum(lens.to(torch.int64), 0)
            j = torch.searchsorted(ends, idx, right=True)
            j = j.clamp(0, vals.shape[0] - 1)
            out[k] = _widen_plain(vals)[j].to(dtypes[k]) + b
        else:  # raw / for: widen + add base (base is 0 for raw)
            b = _base_tensor(bases[k], dtypes[k], device)
            out[k] = _widen_plain(staged[k]).to(dtypes[k]) + b
    return out, idx < count


_k18_tile = None


def _base_bits(b, dtype: torch.dtype) -> int:
    v = b.item() if hasattr(b, "item") else b
    if dtype.is_floating_point:
        return struct.unpack("<q", struct.pack("<d", float(v)))[0]
    return _i64(int(v))


def decode_staged(staged, bases, count: int, meta, cap: int, dtypes,
                  device):
    """K18: every column of a staged chunk's wire plan decoded, and sel,
    in one launch. Returns ({key: column}, sel)."""
    global _k18_tile
    dev = torch.device(device)
    arrays = []
    for k, kind in meta:
        arrays.extend(staged[k] if kind == "rle" else (staged[k],))
    if not (_on_cuda(*arrays) if arrays else dev.type == "cuda"):
        return decode_staged_plain(staged, bases, count, meta, cap, dtypes,
                                   device)
    if any(a.device != dev for a in arrays):
        raise ValueError(f"K18 staged arrays are not on {dev}")
    if len(meta) > K18_MAX_COLS:
        raise ValueError(f"K18 takes at most {K18_MAX_COLS} columns")
    if cap < 1:
        raise ValueError("K18 decodes a chunk of at least one row")
    lib = _load()
    if _k18_tile is None:
        _k18_tile = int(lib.ob_k18_run_tile())
    nc = len(meta)
    kinds, sdt, ddt, src, lens, dst, base, rcap, state = (
        [] for _ in range(9))
    out = {}
    scratch = []
    for k, kind in meta:
        if kind not in K18_KIND:
            raise ValueError(f"K18 wire kind {kind!r}")
        dt = dtypes[k]
        col = torch.empty(cap, dtype=dt, device=dev)
        out[k] = col
        kinds.append(K18_KIND[kind])
        ddt.append(DTYPE_CODE[dt])
        dst.append(col.data_ptr())
        if kind == "rle":
            vals, ln = staged[k]
            rc_ = int(vals.shape[0])
            _vector(ln, rc_, "K18 run lengths")
            if ln.dtype != torch.int32 or not vals.is_contiguous():
                raise TypeError("K18 run lengths are int32, values dense")
            words = torch.zeros(-(-rc_ // _k18_tile) + 1, dtype=torch.int64,
                                device=dev)
            scratch.append(words)
            sdt.append(K18_DTYPE[vals.dtype])
            src.append(vals.data_ptr())
            lens.append(ln.data_ptr())
            base.append(_base_bits(bases[k], dt))
            rcap.append(rc_)
            state.append(words.data_ptr())
            continue
        a = staged[k]
        want = (cap + 7) >> 3 if kind == "bits" else cap
        if a.dim() != 1 or a.shape[0] != want or not a.is_contiguous():
            raise ValueError(f"K18 {k}: expected [{want}] contiguous")
        if kind == "bits" and a.dtype != torch.uint8:
            raise TypeError("K18 validity bitmaps are uint8")
        if dt.is_floating_point and a.dtype != dt:
            raise TypeError("K18 float columns ship raw")
        sdt.append(K18_DTYPE[a.dtype])
        src.append(a.data_ptr())
        lens.append(None)
        base.append(0 if kind == "bits" else _base_bits(bases[k], dt))
        rcap.append(0)
        state.append(None)
    sel = torch.empty(cap, dtype=torch.bool, device=dev)

    def arr(ctype, vals):
        return (ctype * max(nc, 1))(*vals)

    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        rc = lib.ob_k18_decode(
            nc, arr(ctypes.c_int, kinds), arr(ctypes.c_int, sdt),
            arr(ctypes.c_int, ddt), arr(P, src), arr(P, lens), arr(P, dst),
            arr(ctypes.c_longlong, base), arr(ctypes.c_longlong, rcap),
            arr(P, state), cap, int(count), sel.data_ptr(), _stream(dev))
        _check(rc, "K18_decode_staged")
    LAUNCHES["K18_decode_staged"] += 1
    return out, sel


# ---------------------------------------------------------------------------
# K19-K22: the IVF vector index (k-means build, filtered probe)
# ---------------------------------------------------------------------------
#
# float32 throughout, as the reference. On the card the plain versions'
# matmuls run in full float32 only while
# torch.backends.cuda.matmul.allow_tf32 is False (PyTorch's default);
# TF32 keeps about three digits and changes which centroid is nearest.


def _matrix(t: torch.Tensor, what: str, cols: int | None = None) -> None:
    if t.dim() != 2 or (cols is not None and t.shape[1] != cols):
        raise ValueError(f"{what}: expected a 2-D tensor"
                         + (f" of width {cols}" if cols is not None else "")
                         + f", got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def kmeans_assign_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of K19 (storage/vector_index.py:57 _kmeans_assign):
    argmin over l of -2 x.c_l + |c_l|^2, the lowest index on ties."""
    d2 = -2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None, :]
    return torch.argmin(d2, dim=1)


def kmeans_assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """K19: int64 [n] index of each row's nearest centroid (c: (L, d)),
    by -2 x.c + |c|^2, the lowest index on ties; the (n, L) distance
    matrix is never written."""
    if not _on_cuda(x, c):
        return kmeans_assign_plain(x, c)
    _matrix(x, "K19 x")
    d = int(x.shape[1])
    _matrix(c, "K19 centroids", d)
    n, nl = int(x.shape[0]), int(c.shape[0])
    if nl < 1 or d < 1:
        raise ValueError("K19 needs at least one centroid and one dimension")
    if n >= 2**31 or nl >= 2**31:
        raise ValueError("K19 takes at most 2^31 - 1 rows and centroids")
    lib = _load()
    dev = x.device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    cnorm = torch.empty(nl, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = lib.ob_k19_assign(x.data_ptr(), c.data_ptr(), cnorm.data_ptr(),
                               n, nl, d, out.data_ptr(), _stream(dev))
        _check(rc, "K19_kmeans_assign")
    LAUNCHES["K19_kmeans_assign"] += 1
    return out


def kmeans_update_plain(x: torch.Tensor, a: torch.Tensor, nl: int):
    """Plain version of K20 (storage/vector_index.py:64 _kmeans_update):
    per-list float32 sums (L, d) and counts (L,) of the rows by their
    assignment, as segment sums (index_add_; on the CPU each list sums in
    row order)."""
    n, d = int(x.shape[0]), int(x.shape[1])
    sums = torch.zeros((nl, d), dtype=torch.float32, device=x.device)
    cnt = torch.zeros(nl, dtype=torch.float32, device=x.device)
    sums.index_add_(0, a, x)
    cnt.index_add_(0, a, torch.ones(n, dtype=torch.float32, device=x.device))
    return sums, cnt


def kmeans_update(x: torch.Tensor, a: torch.Tensor, nl: int):
    """K20: (sums (L, d) float32, counts (L,) float32) of the rows of x by
    assignment a (int32 or int64, in [0, L)). The rows are ordered by
    assignment (K3, stable: row order within a list), then each list sums
    its rows in row order in float32 -- no atomics, so the result has the
    bits of a sequential sum on every run."""
    if not _on_cuda(x, a):
        return kmeans_update_plain(x, a, nl)
    _matrix(x, "K20 x")
    n, d = int(x.shape[0]), int(x.shape[1])
    _vector(a, n, "K20 assignment")
    if a.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"K20 assignment must be int32 or int64, got {a.dtype}")
    if nl < 1 or n >= 2**31:
        raise ValueError("K20 needs 1 <= lists and at most 2^31 - 1 rows")
    lib = _load()
    dev = x.device
    order = sort_order([a], [False], torch.ones(n, dtype=torch.bool,
                                                device=dev))
    sums = torch.empty((nl, d), dtype=torch.float32, device=dev)
    cnt = torch.empty(nl, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k20_update(x.data_ptr(), a.data_ptr(), DTYPE_CODE[a.dtype],
                               order.data_ptr(), n, d, nl, sums.data_ptr(),
                               cnt.data_ptr(), _stream(dev))
        _check(rc, "K20_kmeans_update")
    LAUNCHES["K20_kmeans_update"] += 1
    return sums, cnt


def ivf_lists_plain(cent: torch.Tensor, q: torch.Tensor,
                    nprobe: int) -> torch.Tensor:
    """Plain version of K21 (engine/executor.py:1572-1573): cdist = |c|^2 -
    2 c.q, then lax.top_k(-cdist, nprobe)'s order: nearest first, the
    lower list index on ties."""
    cdist = torch.sum(cent * cent, dim=1) - 2.0 * (cent @ q)
    return torch.sort(cdist, stable=True).indices[:nprobe].to(torch.int32)


def ivf_lists(cent: torch.Tensor, q: torch.Tensor,
              nprobe: int) -> torch.Tensor:
    """K21: int32 [nprobe] indices of the nprobe centroids nearest to q
    (cent: (L, d), q: (d,)), nearest first, the lower index on ties."""
    if not _on_cuda(cent, q):
        return ivf_lists_plain(cent, q, nprobe)
    _matrix(cent, "K21 centroids")
    nl, d = int(cent.shape[0]), int(cent.shape[1])
    _vector(q, d, "K21 query")
    if q.dtype != torch.float32:
        raise TypeError("K21 query must be float32")
    if not 1 <= nprobe <= nl:
        raise ValueError(f"K21 needs 1 <= nprobe <= lists, got {nprobe}, {nl}")
    if nl >= 2**31:
        raise ValueError("K21 takes at most 2^31 - 1 lists")
    lib = _load()
    dev = cent.device
    keys = torch.empty(nl, dtype=torch.int64, device=dev)
    out = torch.empty(nprobe, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k21_lists(cent.data_ptr(), q.data_ptr(), nl, d, nprobe,
                              keys.data_ptr(), out.data_ptr(), _stream(dev))
        _check(rc, "K21_ivf_lists")
    LAUNCHES["K21_ivf_lists"] += 1
    return out


def _probe_windows(perm, offs, lens, probes, max_list: int, n: int):
    """The candidate rows of the probed lists' windows and their window
    validity, flattened in probe order (position p * max_list + j)."""
    dev = perm.device
    starts = offs[probes.long()].to(torch.int64)
    ll = lens[probes.long()].to(torch.int64)
    j = torch.arange(max_list, dtype=torch.int64, device=dev)
    win = starts[:, None] + j[None, :]
    wvalid = j[None, :] < ll[:, None]
    rows = perm[torch.clamp(win, 0, max(n - 1, 0))].reshape(-1)
    return rows, wvalid.reshape(-1)


def ivf_probe_plain(x, sel, perm, offs, lens, probes, q, max_list: int,
                    n: int, k: int):
    """Plain version of K22 (engine/executor.py:1574-1601): the probed
    windows' rows, dist = |x|^2 - 2 x.q (inf where the window or the
    filter kills the row), lax.top_k(-dist, k)'s order (smaller distance
    first, the lower candidate position on ties); returns (int32 rows of
    the winners, their sel = dist < inf, the starvation count
    max(k - live candidates, 0) as a 0-d int64)."""
    rows, wv = _probe_windows(perm, offs, lens, probes, max_list, n)
    xv = x[rows.long()]
    dist = torch.sum(xv * xv, dim=1) - 2.0 * (xv @ q)
    live = wv & sel[rows.long()]
    dist = torch.where(live, dist, torch.full_like(dist, float("inf")))
    kk = min(k, int(rows.shape[0]))
    top = torch.sort(dist, stable=True).indices[:kk]
    starved = torch.clamp(kk - torch.sum(live, dtype=torch.int64), min=0)
    return rows[top].to(torch.int32), dist[top] < float("inf"), starved


K22_MAX_K = 2048
_k22_tile = None


def ivf_probe(x, sel, perm, offs, lens, probes, q, max_list: int, n: int,
              k: int):
    """K22: the IVF probe's gather, exact re-rank and top-k in one tile
    pass and one merge launch. x: (cap, d) float32 vectors, sel: bool
    [cap] live rows after the fused filter, perm/offs/lens: the index's
    int32 arrays, probes: int32 [nprobe] (K21). Returns (int32 [k'] rows,
    bool [k'] sel, 0-d int64 starvation count), k' = min(k, nprobe *
    max_list), in lax.top_k's order."""
    global _k22_tile
    if not _on_cuda(x, sel, perm, offs, lens, probes, q):
        return ivf_probe_plain(x, sel, perm, offs, lens, probes, q,
                               max_list, n, k)
    _matrix(x, "K22 vectors")
    cap, d = int(x.shape[0]), int(x.shape[1])
    _vector(sel, cap, "K22 sel")
    _vector(q, d, "K22 query")
    nl = int(offs.shape[0])
    _vector(offs, nl, "K22 offsets")
    _vector(lens, nl, "K22 lengths")
    _vector(perm, int(perm.shape[0]), "K22 perm")
    nprobe = int(probes.shape[0])
    _vector(probes, nprobe, "K22 probes")
    if sel.dtype != torch.bool or q.dtype != torch.float32:
        raise TypeError("K22 sel must be bool and the query float32")
    for t, what in ((perm, "perm"), (offs, "offsets"), (lens, "lengths"),
                    (probes, "probes")):
        if t.dtype != torch.int32:
            raise TypeError(f"K22 {what} must be int32")
    cand = nprobe * int(max_list)
    if cand < 1 or cand >= 2**32:
        raise ValueError(f"K22 takes 1 to 2^32 - 1 candidates, got {cand}")
    if not 1 <= n <= min(cap, int(perm.shape[0])):
        raise ValueError(f"K22 rows {n} outside the table's arrays")
    kk = min(int(k), cand)
    if not 1 <= kk <= K22_MAX_K:
        raise ValueError(f"K22 selects 1 to {K22_MAX_K} rows, got {kk}")
    lib = _load()
    if _k22_tile is None:
        _k22_tile = int(lib.ob_k22_tile())
    dev = x.device
    nblocks = max(1, min(-(-cand // _k22_tile),
                         2 * torch.cuda.get_device_properties(
                             dev).multi_processor_count))
    partial = torch.empty(nblocks * kk, dtype=torch.int64, device=dev)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.empty(kk, dtype=torch.int32, device=dev)
    osel = torch.empty(kk, dtype=torch.bool, device=dev)
    starved = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k22_probe(
            x.data_ptr(), sel.data_ptr(), perm.data_ptr(), offs.data_ptr(),
            lens.data_ptr(), probes.data_ptr(), q.data_ptr(), nprobe,
            int(max_list), int(n), d, kk, nblocks, partial.data_ptr(),
            live.data_ptr(), rows.data_ptr(), osel.data_ptr(),
            starved.data_ptr(), _stream(dev))
        _check(rc, "K22_ivf_probe")
    LAUNCHES["K22_ivf_probe"] += 1
    return rows, osel, starved


# ---------------------------------------------------------------------------
# K23: first-k live-row compaction (the head fetch and the narrowed frame)
# ---------------------------------------------------------------------------

_k23_tile = None


def first_live_plain(sel, k: int, cols):
    """Plain version of K23 (engine/executor.py:3867-3876
    `_head_gather_impl`, and the compaction of `_build_narrow`'s
    run_narrow): idx = the first k live rows of sel in ascending order,
    padded with row 0 (`jnp.nonzero(sel, size=k, fill_value=0)`); every
    column (1-D, or 2-D rows) gathered by idx. Returns (int64 [k] idx,
    0-d int64 nlive, [c[idx] for c in cols])."""
    live = torch.nonzero(sel).flatten()
    n = min(int(live.shape[0]), int(k))
    idx = torch.zeros(int(k), dtype=torch.int64, device=sel.device)
    idx[:n] = live[:n]
    nlive = torch.sum(sel, dtype=torch.int64)
    return idx, nlive, [c.index_select(0, idx) for c in cols]


def first_live(sel, k: int, cols):
    """K23: the first k live rows of sel (row 0 past the live ones) and
    every column gathered by them, in one pass over sel and no host
    sync. sel: bool [cap], cap >= 1; k >= 1 (k may exceed cap); cols:
    contiguous columns of cap rows (1-D, or 2-D with one row per sel
    entry). Returns (int64 [k] idx, 0-d int64 nlive, gathered columns)
    bit for bit as `first_live_plain`."""
    global _k23_tile
    cols = list(cols)
    if not _on_cuda(sel, *cols):
        return first_live_plain(sel, k, cols)
    cap = int(sel.shape[0])
    _vector(sel, cap, "K23 sel")
    if sel.dtype != torch.bool:
        raise TypeError("K23 sel must be bool")
    k = int(k)
    if cap < 1 or k < 1:
        raise ValueError(f"K23 needs cap >= 1 and k >= 1, got {cap}, {k}")
    for c in cols:
        if c.dim() not in (1, 2) or int(c.shape[0]) != cap:
            raise ValueError(
                f"K23 column: expected {cap} rows, got {tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError("K23 column: tensor must be contiguous")
        if c.element_size() not in _WIDTHS:
            raise TypeError(f"K23 column width {c.element_size()}")
    dev = sel.device
    lib = _load()
    if _k23_tile is None:
        _k23_tile = int(lib.ob_k23_tile_rows())
    ntiles = -(-cap // _k23_tile)
    idx = torch.empty(k, dtype=torch.int64, device=dev)
    nlive = torch.empty((), dtype=torch.int64, device=dev)
    counts = torch.empty(ntiles, dtype=torch.int32, device=dev)
    prefix = torch.empty(ntiles, dtype=torch.int64, device=dev)
    outs = [torch.empty((k, *c.shape[1:]), dtype=c.dtype, device=dev)
            for c in cols]
    nc = len(cols)
    src = (ctypes.c_void_p * max(nc, 1))(*[c.data_ptr() for c in cols])
    dst = (ctypes.c_void_p * max(nc, 1))(*[o.data_ptr() for o in outs])
    esize = (ctypes.c_int * max(nc, 1))(*[c.element_size() for c in cols])
    nper = (ctypes.c_int * max(nc, 1))(
        *[int(c.shape[1]) if c.dim() == 2 else 1 for c in cols])
    with torch.cuda.device(dev):
        rc = lib.ob_k23_first_live(
            sel.data_ptr(), cap, k, idx.data_ptr(), nlive.data_ptr(),
            counts.data_ptr(), prefix.data_ptr(), nc, src, dst, esize, nper,
            _stream(dev))
        _check(rc, "K23_first_live")
    LAUNCHES["K23_first_live"] += 1
    return idx, nlive, outs
