"""Hand-written Hopper kernels of the port, their builds, wrappers and
plain PyTorch versions.

K1 `scalar_reduce`     masked count/sum/min/max   (csrc/k1_scalar_aggregate.cu)
K2 `groupby_slots`     direct-addressed group-by  (csrc/k2_groupby_direct.cu)
K3 `sort_order`, `sort_order_images`
                       stable multi-key order     (csrc/k3_radix_sort.cu)
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
K15 `first_occurrence`, `first_occurrence_images`, `scatter_rows`
                       first rows through an order (csrc/k15_distinct_first.cu)
K16 `hll_registers`    HyperLogLog registers      (csrc/k16_hll.cu)
K17 `slice_scan`       sorted-projection range slice (csrc/k17_slice_scan.cu)
K18 `decode_staged`    streamed chunk wire decode (csrc/k18_decode_staged.cu)
K19 `kmeans_assign`    nearest centroid per row   (csrc/k19_kmeans_assign.cu)
K20 `kmeans_update`    per-list row-order sums    (csrc/k20_kmeans_update.cu)
K21 `ivf_lists`        the nprobe nearest lists   (csrc/k21_ivf_lists.cu)
K22 `ivf_probe`        filtered re-rank + top-k   (csrc/k22_ivf_probe.cu)
K23 `first_live`       first k live rows + gather (csrc/k23_first_live.cu)
K24 `fused_expr`       expression register programs (csrc/k24_fused_expr.cu)
K25 `exchange_dest`, `round_robin_dest`, `exchange_pack`
                       PX send lanes, stable     (csrc/k25_exchange_pack.cu)
K26 `exchange_recv`    PX receive from senders   (csrc/k26_exchange_recv.cu)
K27 `shard_merge`      shard-order partial merge (csrc/k27_shard_merge.cu)
K28 `range_histogram`, `hash_histogram`, `bloom_bits`, `range_bounds`,
    `hot_buckets`, `bucket_probe`
                       PX key histograms, bloom  (csrc/k28_bucket_hist.cu)
K29 `hash_groupby`, `slot_aggregate`
                       general hash group-by      (csrc/k29_hash_groupby.cu)
K30 `join_product_sum` matched product sum       (csrc/k30_join_product_sum.cu)
K31 `ann_rerank`, `ann_merge`
                       sharded IVF re-rank, merge (csrc/k31_shard_ivf.cu)

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

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from collections import OrderedDict
from typing import NamedTuple

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
    "K24_fused_expr",
    "K25_exchange_pack",
    "K26_exchange_recv",
    "K27_shard_merge",
    "K28_bucket_hist",
    "K29_hash_groupby",
    "K30_join_product_sum",
    "K31_shard_ivf",
)

# launches of each kernel wrapper on CUDA tensors (plain runs not counted)
LAUNCHES: dict[str, int] = {k: 0 for k in KERNEL_NAMES}
# launches of the second entry points, counted in their kernel's LAUNCHES
# entry too: K5's no-payload probe, K10's range search alone, K11's
# build-side marks of the full outer join, K15's write-back scatter and
# K31's merge of the gathered strips;
# and the Distinct operator's
# runs on the card (K3 + K4 + K13, executor._dedup_batch)
ENTRY_LAUNCHES: dict[str, int] = {"K5_affine_join.probe": 0,
                                  "K10_expand_join.ranges": 0,
                                  "K11_probe_run_any.mark_build": 0,
                                  "K15_distinct_first.scatter": 0,
                                  "K31_shard_ivf.merge": 0,
                                  "dedup_batch": 0}


_COUNT_LOCK = threading.Lock()


def count_launch(table: dict, name: str) -> None:
    """One more launch in a counter table: PX shards launch kernels from
    several threads at once, so the read-modify-write holds a lock."""
    with _COUNT_LOCK:
        table[name] += 1


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
    "k24_fused_expr.cu",
    "k25_exchange_pack.cu",
    "k26_exchange_recv.cu",
    "k27_shard_merge.cu",
    "k28_bucket_hist.cu",
    "k29_hash_groupby.cu",
    "k30_join_product_sum.cu",
    "k31_shard_ivf.cu",
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
    returns its path. Reuses a library built from identical sources.
    Processes that build at once (the ranks of a process mesh) take a
    file lock: the first builds, the others find its library."""
    import fcntl

    digest = _source_digest()
    out = _BUILD / f"libob_kernels_{digest}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
            return out
        return _build(digest, out)


def _build(digest: str, out: Path) -> Path:
    import time

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
        lib.ob_k2_groupby.argtypes = [ctypes.c_char_p, I, P, P, P]
        lib.ob_k2_args_bytes.argtypes = []
        lib.ob_k2_cells.argtypes = []
        lib.ob_k3_spans.argtypes = [I, P, P, P, L, P, I, P]
        lib.ob_k3_sort.argtypes = [I, P, P, P, P, P, P, P, P, P, L, P, L, P,
                                   P, P, P, P, P, I, P]
        lib.ob_k3_scratch_bytes.argtypes = [I, P, L]
        lib.ob_k3_scratch_bytes.restype = ctypes.c_longlong
        lib.ob_k3_tile_rows.argtypes = []
        lib.ob_k4_gather.argtypes = [P, L, L, I, P, P, P, I, P, P, P, P,
                                      P, I, L, I, I, I, I, P]
        lib.ob_k5_affine.argtypes = [P, I, P, L, L, L, L, P, I, P, P, I, P,
                                     P, P, I, P]
        lib.ob_k6_segments.argtypes = [P, P, L, P, P, I, P, I, P]
        lib.ob_k7_topk.argtypes = [P, I, P, I, L, L, P, P, I, P]
        lib.ob_k7_scratch_bytes.argtypes = [L]
        lib.ob_k7_scratch_bytes.restype = ctypes.c_longlong
        lib.ob_k7_fast_c.argtypes = []
        lib.ob_k7_word.argtypes = [I]
        lib.ob_k8_segreduce.argtypes = [I, I, P, I, P, P, P, L, P, P, I, P]
        lib.ob_k8_tile_rows.argtypes = []
        lib.ob_k8_inline.argtypes = []
        lib.ob_k8_scratch_entries.argtypes = [I, I]
        lib.ob_k8_scratch_entries.restype = ctypes.c_longlong
        lib.ob_k5_probe.argtypes = [P, I, P, L, L, L, L, P, I, P, P, I, P]
        lib.ob_k9_merge_join.argtypes = [P, I, P, L, P, I, P, L, P, L, P, I,
                                         P]
        lib.ob_k10_ranges.argtypes = [P, L, P, P, P, L, P, I, P]
        lib.ob_k10_expand.argtypes = [P, P, L, P, P, P, L, L, P, P, P, P, L,
                                      P, P, P, P, P, P, I, I, P]
        lib.ob_k10_scratch_bytes.argtypes = [L]
        lib.ob_k10_scratch_bytes.restype = ctypes.c_longlong
        for fn in (lib.ob_k2_kernel_launches, lib.ob_k10_kernel_launches):
            fn.argtypes = []
            fn.restype = ctypes.c_longlong
        lib.ob_k11_run_any.argtypes = [P, L, P, P, L, P, I, P]
        lib.ob_k12_hash.argtypes = [I, P, L, P, I, P]
        lib.ob_k11_mark_build.argtypes = [P, P, L, L, P, I, P]
        lib.ob_k13_tile_rows.argtypes = []
        lib.ob_k13_scan.argtypes = [P, I, P, I, I, I, I, L, P, P, L, P]
        lib.ob_k13_scratch_bytes.argtypes = [L]
        lib.ob_k13_scratch_bytes.restype = ctypes.c_longlong
        lib.ob_k13_flags.argtypes = [I, P, P, L, P, I, P]
        lib.ob_k13_search.argtypes = [P, L, P, P, P, I, L, P, I, P]
        lib.ob_k14_build.argtypes = [I, P, P, L, P, P, L, I, P]
        lib.ob_k14_probe.argtypes = [I, P, P, P, L, P, P, L, P, I, P]
        lib.ob_k15_first.argtypes = [I, P, P, P, L, P, I, P]
        lib.ob_k15_first_images.argtypes = [P, I, L, I, I, I, P, I, P]
        lib.ob_k15_first_records.argtypes = [I, P, P, P, L, I, P, P, I, P]
        lib.ob_k15_scatter.argtypes = [I, P, P, P, P, P, L, I, P]
        lib.ob_k16_registers.argtypes = [P, I, P, L, P, I, P]
        lib.ob_k17_slice.argtypes = [ctypes.c_char_p, I, P, P, P]
        lib.ob_k17_args_bytes.argtypes = []
        lib.ob_k18_decode.argtypes = [I, P, P, P, P, P, P, P, P, P, L, L, P,
                                      P]
        lib.ob_k18_run_tile.argtypes = []
        lib.ob_k19_assign.argtypes = [P, P, P, L, I, I, P, P]
        lib.ob_k20_update.argtypes = [P, P, I, P, L, I, I, P, P, P]
        lib.ob_k21_lists.argtypes = [P, P, I, I, I, P, P, P]
        lib.ob_k22_probe.argtypes = [P, P, P, P, P, P, P, I, I, L, I, I, I,
                                     P, P, P, P, P, P, P]
        lib.ob_k22_tile.argtypes = []
        lib.ob_k22_smem_k.argtypes = []
        lib.ob_k23_first_live.argtypes = [P, L, L, P, P, P, P, I, P, P, P,
                                          P, P]
        lib.ob_k23_tile_rows.argtypes = []
        lib.ob_k24_run.argtypes = [ctypes.c_char_p, I, P]
        lib.ob_k24_prog_bytes.argtypes = []
        lib.ob_k25_tile_rows.argtypes = []
        lib.ob_k25_dest.argtypes = [I, I, P, L, I, P, I, P, I, L, I, P, I, P]
        lib.ob_k25_pack.argtypes = [P, P, L, I, L, I, P, P, P, P, P, P, P, I,
                                    P]
        lib.ob_k25_round_robin.argtypes = [P, L, I, I, P, P, P, P, P]
        lib.ob_k26_recv.argtypes = [I, P, P, L, I, I, P]
        lib.ob_k26_chunk_bytes.argtypes = []
        lib.ob_k26_inline.argtypes = []
        lib.ob_k27_merge.argtypes = [I, I, P, I, I, P]
        lib.ob_k28_hist.argtypes = [I, I, P, P, L, P, L, P, I, P]
        lib.ob_k28_bounds.argtypes = [P, L, P, I, P, P]
        lib.ob_k28_hot.argtypes = [P, P, L, I, P, P]
        lib.ob_k28_probe.argtypes = [I, P, P, L, P, L, P, I, P]
        lib.ob_k29_groupby.argtypes = [I, P, P, L, L, I, P, P, P, P, P, P,
                                       P, P, P, P, I, I, P]
        lib.ob_k30_product_sum.argtypes = [P, I, P, I, P, L, P, I, P]
        lib.ob_k31_rerank.argtypes = [P, L, I, L, P, P, P, I, I, P, I, I, P,
                                      P, P, P, P]
        lib.ob_k31_merge.argtypes = [P, P, L, I, I, P, P, P, P, P]
        lib.ob_k31_tile.argtypes = []
        lib.ob_k31_smem_k.argtypes = []
        lib.ob_k31_merge_one.argtypes = [P, P, I, I, P, P, P]
        lib.ob_k31_merge_one_max.argtypes = []
        for fn in (lib.ob_k1_reduce_int, lib.ob_k1_reduce_float,
                   lib.ob_k2_groupby, lib.ob_k2_args_bytes, lib.ob_k2_cells,
                   lib.ob_k3_spans, lib.ob_k3_sort,
                   lib.ob_k3_tile_rows, lib.ob_k4_gather, lib.ob_k5_affine,
                   lib.ob_k6_segments, lib.ob_k7_topk, lib.ob_k7_fast_c,
                   lib.ob_k7_word, lib.ob_k8_segreduce,
                   lib.ob_k8_tile_rows, lib.ob_k8_inline, lib.ob_k5_probe,
                   lib.ob_k9_merge_join,
                   lib.ob_k10_ranges, lib.ob_k10_expand,
                   lib.ob_k11_run_any, lib.ob_k12_hash,
                   lib.ob_k11_mark_build, lib.ob_k13_tile_rows,
                   lib.ob_k13_scan, lib.ob_k13_flags, lib.ob_k13_search,
                   lib.ob_k14_build, lib.ob_k14_probe, lib.ob_k15_first,
                   lib.ob_k15_first_images, lib.ob_k15_first_records,
                   lib.ob_k15_scatter, lib.ob_k16_registers,
                   lib.ob_k17_slice, lib.ob_k17_args_bytes, lib.ob_k18_decode, lib.ob_k18_run_tile,
                   lib.ob_k19_assign, lib.ob_k20_update, lib.ob_k21_lists,
                   lib.ob_k22_probe, lib.ob_k22_tile, lib.ob_k22_smem_k,
                   lib.ob_k23_first_live, lib.ob_k23_tile_rows,
                   lib.ob_k24_run, lib.ob_k24_prog_bytes,
                   lib.ob_k25_tile_rows,
                   lib.ob_k25_dest, lib.ob_k25_pack,
                   lib.ob_k25_round_robin, lib.ob_k26_recv,
                   lib.ob_k26_chunk_bytes, lib.ob_k26_inline,
                   lib.ob_k27_merge,
                   lib.ob_k28_hist, lib.ob_k28_bounds, lib.ob_k28_hot,
                   lib.ob_k28_probe, lib.ob_k29_groupby,
                   lib.ob_k30_product_sum, lib.ob_k31_rerank,
                   lib.ob_k31_merge, lib.ob_k31_tile, lib.ob_k31_smem_k,
                   lib.ob_k31_merge_one, lib.ob_k31_merge_one_max):
            fn.restype = ctypes.c_int
        if (lib.ob_k3_tile_rows() != K3_TILE
                or lib.ob_k7_fast_c() != K7_FAST_C
                or lib.ob_k8_tile_rows() != K8_TILE
                or lib.ob_k8_inline() != K8_INLINE
                or lib.ob_k13_tile_rows() != K13_TILE
                or lib.ob_k13_scratch_bytes(1001) != k13_scratch_bytes(1001)
                or lib.ob_k8_scratch_entries(7, 3)
                != k8_scratch_entries(7, 3)
                or lib.ob_k26_chunk_bytes() != K26_CHUNK
                or lib.ob_k26_inline() != K26_INLINE
                or lib.ob_k31_merge_one_max() != K31_MERGE_ONE):
            raise RuntimeError("kernels.py and csrc/ disagree on the K3, "
                               "K7, K8, K13, K26 or K31 layout constants")
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


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    """The card's multiprocessor count, asked of the runtime once."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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
    count_launch(LAUNCHES, "K1_scalar_aggregate")
    return res


# ---------------------------------------------------------------------------
# K2: direct-addressed group-by
# ---------------------------------------------------------------------------

K2_MAX_AGGS = 32   # distinct aggregates a launch (csrc/k2_groupby_direct.cu)
K2_MAX_MASKS = 8   # distinct masks a launch
K2_MAX_OUTS = 64   # output rows a launch
K2_CELLS = 704     # distinct aggregates x dense slots a launch
K2_BLOCK_ROWS = 8192  # rows a block takes at a time (16 a lane, 2 chunks)
K2_BLOCKS_PER_SM = 2
K2_PLANS_MAX = 64


def k2_layout(domains) -> tuple:
    """pack_keys's layout of keys with these domains (key 0 least
    significant): (dense domain D = the product of the domains, packed
    slots = 1 << the sum of each key's whole bits, [(shift, bits, domain,
    dense radix)] of the keys of domain >= 2, the mask of the bits of the
    keys of domain 1, which are always 0). An int is one key."""
    if isinstance(domains, int):
        domains = [domains]
    dense, shift, keys, zmask = 1, 0, [], 0
    for d in domains:
        d = int(d)
        if d < 1:
            raise ValueError(f"K2 key domain {d} < 1")
        b = max(1, (d - 1).bit_length())
        if d == 1:
            zmask |= 1 << shift
        else:
            keys.append((shift, b, d, dense))
        dense *= d
        shift += b
    return dense, 1 << shift, keys, zmask


def k2_spread(domains) -> list:
    """The dense slot of each packed slot (-1: a key field outside its
    domain, no row has it): the map K2's final pass applies."""
    dense, slots, keys, zmask = k2_layout(domains)
    out = []
    for p in range(slots):
        d = 0 if not p & zmask else -1
        for shift, b, dom, radix in keys:
            f = (p >> shift) & ((1 << b) - 1)
            if d < 0 or f >= dom:
                d = -1
                break
            d += f * radix
        out.append(d)
    return out


def groupby_slots_plain(keys: torch.Tensor, domains, aggs):
    """Plain version of K2 (ops/hashagg.py groupby_direct / executor
    _direct_slot_agg): one masked reduction per (dense slot, aggregate),
    then each packed slot takes its dense slot's result, or an empty
    slot's where it has none."""
    dense, _slots, _keys, _z = k2_layout(domains)
    slot_is = [keys == g for g in range(dense)]
    slot_is.append(torch.zeros_like(keys, dtype=torch.bool))
    idx = torch.tensor([dense if d < 0 else d for d in k2_spread(domains)],
                       dtype=torch.int64, device=keys.device)
    out = []
    for op, values, mask in aggs:
        per = torch.stack([
            scalar_reduce_plain(op, mask & g, values) for g in slot_is])
        out.append(per[idx])
    return out


# csrc/k2_groupby_direct.cu's K2Params: keys, masks[8], n, slots, zmask,
# aligned, key_dt, D, nagg, nmask, nout, nk, shift/bits/dom/radix [6];
# then K2_MAX_AGGS K2Agg (vals, ident, dt, op, isf, mask) and K2_MAX_OUTS
# K2Out (agg, row, dt, pad)
_K2_HDR = struct.Struct("<Q8QqqqQ6i24i")
_K2_AGG = struct.Struct("<Qq4i")
_K2_OUT = struct.Struct("<4i")


class K2Launch(NamedTuple):
    """One K2 launch: its K2Params image and its grid."""
    blob: bytes
    nblocks: int


class K2Plan(NamedTuple):
    """A call's launches, its packed slots, and per aggregate of the call
    the output row's dtype (the kernel writes each aggregate's row, a
    repeated aggregate's too) and the dtype a float32 result narrows to
    (None: the row is the result)."""
    launches: tuple
    slots: int
    views: tuple


_K2_PLANS: OrderedDict = OrderedDict()
_K2_LOCK = threading.Lock()
_K2_SCRATCH: dict = {}


def _k2_id(t) -> tuple | None:
    """A tensor as a plan's key sees it: address, dtype, shape, strides."""
    if t is None:
        return None
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def k2_unique(aggs) -> tuple[list, list]:
    """The distinct aggregates of a call, in first-occurrence order (the
    same op over the same values and mask tensors, by `_k2_id`; a count's
    values do not matter), each reduced once; and each aggregate's index
    among them. A distinct aggregate serves at most K2_MAX_OUTS output
    rows; a further repeat starts a new one."""
    uniq, index, seen, uses = [], [], {}, []
    for op, v, m in aggs:
        key = (op, None if op == "count" else _k2_id(v), _k2_id(m))
        u = seen.get(key)
        if u is None or uses[u] == K2_MAX_OUTS:
            u = seen[key] = len(uniq)
            uniq.append((op, v, m))
            uses.append(0)
        uses[u] += 1
        index.append(u)
    return uniq, index


def k2_split(uniq, index, dense: int) -> list[list[int]]:
    """The launches of a call: consecutive runs of the distinct aggregates,
    each at most K2_MAX_AGGS of them, K2_MAX_MASKS distinct masks, K2_CELLS
    cells (aggregates x the dense domain) and K2_MAX_OUTS output rows."""
    per = max(1, min(K2_MAX_AGGS, K2_CELLS // dense))
    outs = [0] * len(uniq)
    for u in index:
        outs[u] += 1
    groups, cur, masks, nout = [], [], set(), 0
    for u, (_op, _v, m) in enumerate(uniq):
        mk = _k2_id(m)
        if cur and (len(cur) == per or nout + outs[u] > K2_MAX_OUTS
                    or (mk not in masks and len(masks) == K2_MAX_MASKS)):
            groups.append(cur)
            cur, masks, nout = [], set(), 0
        cur.append(u)
        masks.add(mk)
        nout += outs[u]
    if cur:
        groups.append(cur)
    return groups


def _k2_out_dtype(op: str, v) -> torch.dtype:
    """The dtype the kernel writes an aggregate's row in: int64 for counts
    and integer sums, float64 for float ones (a float32 result narrows in
    the wrapper), the values' own type for integer min and max."""
    if op == "count":
        return torch.int64
    if v.dtype.is_floating_point:
        return torch.float64
    return torch.int64 if op == "sum" else v.dtype


def _aligned16(t) -> bool:
    return t.data_ptr() % 16 == 0


def k2_plan(keys, domains, aggs, sms: int) -> K2Plan:
    """K2's launches for a call, cached by everything they are made of
    (each tensor's `_k2_id`, the ops, the domains, the card's SM count): a
    call over the same tensors reuses the images, and a changed address is
    another entry, built and checked anew (device, contiguity, dtypes)."""
    doms = (int(domains),) if isinstance(domains, int) else tuple(
        int(d) for d in domains)
    ck = (_k2_id(keys), doms, sms, tuple(
        (op, None if op == "count" else _k2_id(v), _k2_id(m))
        for op, v, m in aggs))
    with _K2_LOCK:
        hit = _K2_PLANS.get(ck)
        if hit is not None:
            _K2_PLANS.move_to_end(ck)
            return hit
    dense, slots, kfields, zmask = k2_layout(doms)
    # the executor admits the direct path at a dense domain <= 64
    if dense > 64:
        raise ValueError(f"K2 dense domain {dense} outside 1..64")
    if len(kfields) > 6:
        raise ValueError(f"K2 takes at most 6 keys of domain >= 2, got "
                         f"{len(kfields)}")
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
    uniq, index = k2_unique(aggs)
    nk = len(kfields)
    kf = [[f[i] for f in kfields] + [0] * (6 - nk) for i in range(4)]
    nblocks = max(1, min(-(-max(n, 1) // K2_BLOCK_ROWS),
                         sms * K2_BLOCKS_PER_SM))
    launches = []
    for group in k2_split(uniq, index, dense):
        masks, mask_ix = [], {}
        aligned = int(_aligned16(keys))
        entries = []
        for a, u in enumerate(group):
            op, v, m = uniq[u]
            mk = _k2_id(m)
            if mk not in mask_ix:
                mask_ix[mk] = len(masks)
                aligned |= int(_aligned16(m)) << (1 + len(masks))
                masks.append(m)
            fl = op != "count" and v.dtype.is_floating_point
            idv = _identity(op, v.dtype if op != "count" else torch.int64)
            ident = (struct.unpack("<q", struct.pack("<d", idv))[0] if fl
                     else int(idv))
            if op != "count":
                aligned |= int(_aligned16(v)) << (9 + a)
            entries.append(_K2_AGG.pack(
                v.data_ptr() if op != "count" else 0, ident,
                DTYPE_CODE[v.dtype] if op != "count" else 0, AGG_CODE[op],
                int(fl), mask_ix[mk]))
        outs = [_K2_OUT.pack(group.index(u), row,
                             DTYPE_CODE[_k2_out_dtype(*aggs[row][:2])], 0)
                for row, u in enumerate(index) if u in group]
        blob = _K2_HDR.pack(
            keys.data_ptr(), *([m.data_ptr() for m in masks]
                               + [0] * (K2_MAX_MASKS - len(masks))),
            n, slots, zmask, aligned, DTYPE_CODE[keys.dtype], dense,
            len(group), len(masks), len(outs), nk, *kf[0], *kf[1], *kf[2],
            *kf[3]) + b"".join(entries) + bytes(
                _K2_AGG.size * (K2_MAX_AGGS - len(group))) + b"".join(
                outs) + bytes(_K2_OUT.size * (K2_MAX_OUTS - len(outs)))
        launches.append(K2Launch(blob, nblocks))
    views = tuple(
        (_k2_out_dtype(op, v),
         v.dtype if op != "count" and v.dtype == torch.float32 else None)
        for op, v, _m in aggs)
    plan = K2Plan(tuple(launches), slots, views)
    with _K2_LOCK:
        _K2_PLANS[ck] = plan
        while len(_K2_PLANS) > K2_PLANS_MAX:
            _K2_PLANS.popitem(last=False)
    return plan


def _k2_scratch(dev: torch.device, stream: int, sms: int) -> torch.Tensor:
    """The ticket and the per-block partials of K2's launches on one
    stream (the ticket is 0 between launches: the last block puts it
    back)."""
    k = (dev.index, stream)
    t = _K2_SCRATCH.get(k)
    if t is None:
        t = _K2_SCRATCH[k] = torch.zeros(
            4 + sms * K2_BLOCKS_PER_SM * K2_CELLS, dtype=torch.int64,
            device=dev)
    return t


_k2_checked = False


def _k2_check(lib) -> None:
    global _k2_checked
    want = _K2_HDR.size + K2_MAX_AGGS * _K2_AGG.size \
        + K2_MAX_OUTS * _K2_OUT.size
    if int(lib.ob_k2_args_bytes()) != want or int(lib.ob_k2_cells()) \
            != K2_CELLS:
        raise RuntimeError("K2 argument layout differs from the source")
    _k2_checked = True


def groupby_slots(keys: torch.Tensor, domains, aggs):
    """K2: for each (op, values|None, mask) in `aggs`, the aggregate over
    the rows of each slot. keys: each row's dense mixed-radix slot over
    key domains `domains` (key 0 least significant: key i times the
    product of the domains before it; an int is one key); the results
    come out in pack_keys's packed slots (`k2_layout`), a packed slot no
    key combination maps to holding the aggregate's identity. Repeated
    aggregates are reduced once (`k2_unique`), each result its own
    tensor; one launch per `k2_split` group, counted each."""
    if not aggs:
        return []
    if not _on_cuda(keys, *(v for _, v, _ in aggs), *(m for _, _, m in aggs)):
        return groupby_slots_plain(keys, domains, aggs)
    dev = keys.device
    sms = _sm_count(dev)
    plan = k2_plan(keys, domains, aggs, sms)
    lib = _load()
    if not _k2_checked:
        _k2_check(lib)
    with _on_device(dev):
        stream = _stream(dev)
        out = torch.empty((len(aggs), plan.slots), dtype=torch.int64,
                          device=dev)
        scratch = _k2_scratch(dev, stream, sms)
        for ln in plan.launches:
            rc = lib.ob_k2_groupby(ln.blob, ln.nblocks, out.data_ptr(),
                                   scratch.data_ptr(), stream)
            _check(rc, "K2_groupby_direct")
            count_launch(LAUNCHES, "K2_groupby_direct")
    results = []
    for row, (dt, narrow) in zip(out, plan.views):
        r = row if dt == torch.int64 else row.view(dt)[:plan.slots]
        results.append(r if narrow is None else r.to(narrow))
    return results


# ---------------------------------------------------------------------------
# K3: stable multi-key sort order
# ---------------------------------------------------------------------------


K3_MAX_PACK = 8
# rows a tile of a digit pass holds (ob_k3_tile_rows)
K3_TILE = 4096


class K3Composite(NamedTuple):
    """One composite of K3's plan: `members` (key index, image min, shift)
    least significant first, packed into `bits` bits; `width` is the image
    it rides in (64 or 32 bits, or 0: a one-pass composite whose pass reads
    the keys themselves), `rbits` the bits of the order's row below the
    keys in that image (0: the order rides beside the image)."""
    members: tuple
    bits: int
    width: int
    rbits: int

    @property
    def passes(self) -> int:
        return -(-self.bits // 8)


def _k3_image(bits: int, rbits: int, row_inside: bool = False) -> tuple:
    """(width, rbits) of a composite of `bits` bits over rows that need
    `rbits` bits: the fewest bytes a pass moves (32-bit image with the row
    8, the 32-bit image beside the order or the 64-bit image with the row
    16, the 64-bit image beside the order 24); `row_inside` takes the
    64-bit image with the row over the 32-bit one beside the order (the
    same bytes a pass), so that the last pass's images say which row each
    is (K15's image route)."""
    if bits <= 8:
        return 0, 0
    if bits + rbits <= 32:
        return 32, rbits
    if bits <= 32 and not (row_inside and bits + rbits <= 64):
        return 32, 0
    if bits + rbits <= 64:
        return 64, rbits
    return 64, 0


def k3_plan(spans, n: int, row_inside: bool = False) -> list:
    """K3's composites for keys whose images span [lo, hi] (most
    significant first, the dead flag first), least significant first:
    constant keys dropped (they cannot change the order), the rest packed
    (image - lo) << shift into composites of at most 64 bits and
    K3_MAX_PACK keys; each in the image that moves the fewest bytes
    (`row_inside`: see `_k3_image`)."""
    groups, cur, used = [], [], 0
    for i in reversed(range(len(spans))):
        lo, hi = spans[i]
        bits = (hi - lo).bit_length() if n and hi > lo else 0
        if bits == 0:
            continue
        if used + bits > 64 or len(cur) == K3_MAX_PACK:
            groups.append((cur, used))
            cur, used = [], 0
        cur.append((i, lo, used))
        used += bits
    if cur:
        groups.append((cur, used))
    rbits = max(1, (n - 1).bit_length())
    return [K3Composite(tuple(m), bits, *_k3_image(bits, rbits, row_inside))
            for m, bits in groups]


def k3_kept(nk: int, unordered: int) -> int:
    """How many of K3's nk keys (most significant first, the dead flag
    first) still decide the order. Only the last K3_MAX_PACK keys, from
    first = max(0, nk - K3_MAX_PACK), are checked: bit m - first of
    `unordered` is clear when the tuple of keys m..nk - 1 never decreases
    from a row to the next. With the row index after it, such a suffix
    orders rows as the row index alone does, so the longest one drops out
    (key columns a table is stored in the order of, over every row,
    padding included). 0: the rows are already in order."""
    first = max(0, nk - K3_MAX_PACK)
    return next((m for m in range(first, nk)
                 if not unordered >> (m - first) & 1), nk)


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


def _k3_args(keys, descending):
    keys = list(keys)
    descending = list(descending)
    if len(keys) != len(descending):
        raise ValueError("one descending flag per key")
    return keys, descending


def sort_order(keys, descending, mask: torch.Tensor) -> torch.Tensor:
    """K3: int32 [N] row order sorting live rows by `keys` (lexicographic,
    DESC per flag), dead rows last, ties by row index."""
    keys, descending = _k3_args(keys, descending)
    if not _on_cuda(mask, *keys):
        return sort_order_plain(keys, descending, mask)
    return _k3_launch(keys, descending, mask, False).order


class K3Sorted(NamedTuple):
    """K3's result for K15 (`sort_order_images`): `route` is
    `k15_route`'s; `order` is K3's int32 order, or None when the rows are
    already in order ("rows") or the images carry it ("image"); `images`
    (route "image" only) are the last pass's images in sorted order, int64
    or int32 as the composite is 64 or 32 bits wide: the keys above the
    low `rbits` bits, which hold the row; the dead flag is bit `dead_bit`
    of an image, or, where `dead_bit` is -1, constant: every row live
    (`live` 1) or none (0)."""
    order: torch.Tensor | None
    images: torch.Tensor | None
    route: str
    rbits: int = 0
    dead_bit: int = -1
    live: int = 1


def sort_order_images(keys, descending, mask: torch.Tensor) -> K3Sorted:
    """K3 for K15 (the first rows of DISTINCT runs): the sort of (dead,
    keys...) with, where `k15_route` takes the image route, the sorted
    images of its last pass instead of the order (no byte more is written:
    the order's row is their low bits). On the CPU: the plain order, route
    "plain"."""
    keys, descending = _k3_args(keys, descending)
    if not _on_cuda(mask, *keys):
        return K3Sorted(sort_order_plain(keys, descending, mask), None,
                        "plain")
    return _k3_launch(keys, descending, mask, True)


def _k3_launch(keys, descending, mask, for_k15: bool) -> K3Sorted:
    """K3 on the card: the spans read back once, the plan, the sort; for
    K15 the route decides whether the last pass writes images or the
    order, and whether an order is needed at all."""
    n = int(mask.shape[0])
    if n >= 2**31:
        raise ValueError("K3 orders at most 2^31 - 1 rows")
    _vector(mask, n, "K3 mask")
    if mask.dtype != torch.bool:
        raise TypeError("K3 mask must be bool")
    for k in keys:
        _vector(k, n, "K3 key")
    dev = mask.device
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return K3Sorted(empty, None, "rows" if for_k15 else "order")
    lib = _load()
    # most significant first: the dead flag, then the keys in order
    allk = [(mask, True)] + list(zip(keys, descending))
    nk = len(allk)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        nb = _blocks(dev, n, 256 * 8)
        ptrs = [k.data_ptr() for k, _ in allk]
        dts = [DTYPE_CODE[k.dtype] for k, _ in allk]
        descs = [int(bool(d)) for _, d in allk]
        # every key's span and the keys already in row order, read back at
        # once: they decide the packing
        mm = torch.empty(2 * nk + 1, dtype=torch.int64, device=dev)
        rc = lib.ob_k3_spans(nk, (ctypes.c_void_p * nk)(*ptrs),
                             (ctypes.c_int * nk)(*dts),
                             (ctypes.c_int * nk)(*descs), n, mm.data_ptr(),
                             nb, stream)
        _check(rc, "K3_radix_sort spans")
        got = [v & (2**64 - 1) for v in mm.tolist()]
        spans = [(~got[2 * k] & (2**64 - 1), got[2 * k + 1])
                 for k in range(nk)]
        kept = k3_kept(nk, got[-1])
        plan = k3_plan(spans[:kept], n)
        route = "order"
        if for_k15:
            inside = k3_plan(spans[:kept], n, True)
            route = k15_route(inside, kept, nk, [k.dtype for k in keys])
            if route == "image":
                plan = inside
        res = K3Sorted(None, None, route)
        if route == "image":
            c = plan[0]
            images = torch.empty(n, dtype=torch.int64 if c.width == 64
                                 else torch.int32, device=dev)
            _k3_sort(lib, plan, ptrs, dts, descs, n, nb, stream, None,
                     images)
            dead = [sh for i, _lo, sh in c.members if i == 0]
            # a constant dead flag's image: 0 every row live, 1 none
            res = K3Sorted(None, images, route, c.rbits,
                           c.rbits + dead[0] if dead else -1,
                           int(not dead and spans[0][1] == 0))
        elif plan:
            out = torch.empty(n, dtype=torch.int32, device=dev)
            _k3_sort(lib, plan, ptrs, dts, descs, n, nb, stream, out, None)
            res = K3Sorted(out, None, route)
        elif not for_k15:  # every key constant or in row order
            res = K3Sorted(torch.arange(n, dtype=torch.int32, device=dev),
                           None, route)
    count_launch(LAUNCHES, "K3_radix_sort")
    return res


def _k3_sort(lib, plan, ptrs, dts, descs, n, nb, stream, out,
             img_out) -> None:
    """ob_k3_sort over `plan` into `out` (or, K15's image route, the
    sorted images into `img_out`): the packs and the digit passes in one C
    call, their buffers in one workspace (the images, the orders written
    before the last pass, the scratch)."""
    nc = len(plan)
    members = [m for c in plan for m in c.members]
    nm = len(members)
    bits = (ctypes.c_int * nc)(*[c.bits for c in plan])
    widths = (ctypes.c_int * nc)(*[c.width for c in plan])
    scratch = lib.ob_k3_scratch_bytes(nc, bits, n)
    # an imaged composite has at least two passes: two image buffers
    img = n * max(c.width for c in plan) // 8
    orders = nc > 1 or (plan[0].width and not plan[0].rbits)
    perm = 4 * n if orders else 0

    def up(b):
        return -(-b // 256) * 256

    dev = (out if out is not None else img_out).device
    ws = torch.empty(2 * up(img) + 2 * up(perm) + scratch, dtype=torch.uint8,
                     device=dev)
    at = ws.data_ptr()
    bufs = [at, at + up(img)] if img else [None, None]
    at += 2 * up(img)
    bufs += [at, at + up(perm)] if perm else [None, None]
    at += 2 * up(perm)
    rc = lib.ob_k3_sort(
        nc, (ctypes.c_int * nc)(*[len(c.members) for c in plan]), bits,
        widths, (ctypes.c_int * nc)(*[c.rbits for c in plan]),
        (ctypes.c_void_p * nm)(*[ptrs[i] for i, _, _ in members]),
        (ctypes.c_int * nm)(*[dts[i] for i, _, _ in members]),
        (ctypes.c_int * nm)(*[descs[i] for i, _, _ in members]),
        (ctypes.c_ulonglong * nm)(*[lo for _, lo, _ in members]),
        (ctypes.c_int * nm)(*[sh for _, _, sh in members]), n, at, scratch,
        *bufs, out.data_ptr() if out is not None else None,
        img_out.data_ptr() if img_out is not None else None, nb, stream)
    _check(rc, "K3_radix_sort")


# ---------------------------------------------------------------------------
# K4: multi-column row gather
# ---------------------------------------------------------------------------

K4_MAX_COLS = 48
_WIDTHS = (1, 2, 4, 8)
# the widest row image (bytes): a payload past it splits into several
K4_IMAGE_BYTES = 64
# the route's cutoffs: the image where the gathered bytes times (columns
# - 1), the random reads a row it saves, reach K4_IMAGE_MIN_GATHER, and
# the source's bytes K4_IMAGE_MIN_SOURCE (one L2 holds less). From
# bench_k4.py's random gathers on an H100 80GB HBM3 at 700 W (image vs
# direct ms): two columns, [4,1] over 30M rows (150 MB) 1.303 vs 1.267,
# [8,1] over 15M (135 MB) 0.683 vs 0.618, over 30M (270 MB) 1.382 vs
# 1.409, over 60M 2.756 vs 3.439; [8,4] 30M rows of 15M 1.222 vs 1.599,
# [8,8] 20M rows of 2M (32 MB) 0.439 vs 0.400; three, [4,4,1] over 4M
# (36 MB) 0.172 vs 0.121, over 15M (135 MB) 0.682 vs 0.894.
K4_IMAGE_MIN_GATHER = 256 << 20
K4_IMAGE_MIN_SOURCE = 64 << 20
# the probe's rule: of up to K4_PROBE_PAIRS evenly spaced pairs of
# neighbouring output rows, those whose sources lie more than K4_NEAR rows
# apart are far. The image runs where far / pairs x (columns - 1) >
# K4_IMAGE_SHARE (so two columns half in order do not: a PX shard's
# DISTINCT gathers [4,1] over 30M rows so, 0.87 ms a shard through the
# image against 0.59 for the kernel before it, which read a width at a
# time), one pass over the rows where far * K4_FAR_DIV <= pairs, else a
# pass a column.
K4_NEAR = 16
K4_FAR_DIV = 8
K4_IMAGE_SHARE = (9, 10)
K4_PROBE_PAIRS = 1 << 16


class K4Image(NamedTuple):
    """One row image: records of `rec` bytes (16, 32 or 64) holding the
    columns `cols` (indices into the call's columns, widest first) at byte
    offsets `offsets`, each aligned to its width."""
    rec: int
    cols: tuple
    offsets: tuple


def k4_images(widths) -> list[K4Image]:
    """The row images of columns of these element widths: widest first,
    each image filled in turn up to K4_IMAGE_BYTES and K4_MAX_COLS
    columns, its record the payload rounded up to 16, 32 or 64 bytes."""
    cap = K4_IMAGE_BYTES
    order = sorted(range(len(widths)), key=lambda i: -widths[i])
    groups, cur, at = [], [], 0
    for i in order:
        w = widths[i]
        if cur and (at + w > cap or len(cur) == K4_MAX_COLS):
            groups.append(cur)
            cur, at = [], 0
        cur.append((i, at))
        at += w
    if cur:
        groups.append(cur)
    out = []
    for g in groups:
        end = g[-1][1] + widths[g[-1][0]]
        rec = next(r for r in (16, 32, 64) if end <= r)
        out.append(K4Image(rec, tuple(i for i, _ in g),
                           tuple(o for _, o in g)))
    return out


def k4_route(m: int, n: int, widths) -> str:
    """K4's route by shape alone: "image" where a row image may pay (the
    gathered bytes, m rows of the payload, times (columns - 1) at least
    K4_IMAGE_MIN_GATHER; a source of K4_IMAGE_MIN_SOURCE bytes or more
    and below 2^31 rows; enough output rows to amortize the pack: m *
    (columns - 1) >= n; the probe then picks the image, one pass over the
    rows or a pass a column on the device), else "direct" (a pass a
    column; one pass for one column)."""
    k, p = len(widths), sum(widths)
    if m * p * (k - 1) >= K4_IMAGE_MIN_GATHER \
            and n * p >= K4_IMAGE_MIN_SOURCE and n < 1 << 31 \
            and m * (k - 1) >= n:
        return "image"
    return "direct"


def k4_norm_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """jnp's gather rule on an index (int64): below 0 counts from the end,
    then clamped to [0, n - 1]."""
    j = idx.long()
    return torch.where(j < 0, j + n, j).clamp(0, max(n - 1, 0))


def k4_probe_pairs(m: int) -> int:
    """How many pairs of neighbouring rows the probe samples."""
    return max(0, min(m - 1, K4_PROBE_PAIRS))


def gather_columns_plain(cols, idx: torch.Tensor):
    """Plain version of K4: each column indexed by idx under jnp's gather
    rule (an index below 0 counts from the end, then clamped to the column
    length)."""
    if not cols:
        return []
    j = k4_norm_index(idx, int(cols[0].shape[0]))
    return [c[j] for c in cols]


# the bits of the state's second word (csrc/k4_gather_rows.cu): the path
# whose launches did the work
K4_RAN = {1: "image", 2: "rows (probe)", 4: "columns (probe)"}


def gather_columns(cols, idx: torch.Tensor):
    """K4: [c[idx] for c in cols] under jnp's gather rule, through a row
    image or directly (`k4_route`, then the probe on the device)."""
    return k4_launch(cols, idx)[0]


def k4_launch(cols, idx: torch.Tensor, route: str | None = None,
              trace: bool = False):
    """K4's launches: (the gathered columns, the path). `route` ("image"
    or "direct") stands in for `k4_route`'s choice by shape, so that a
    bench can time both routes at one shape (the probe still decides on
    the image route). With `trace` the path is read back from the device
    (a host read, for checks and benches): "direct" by shape, or the
    path whose launches did the work, "image", "rows (probe)" or
    "columns (probe)"; "plain" on the CPU. Without it the path is
    None."""
    cols = list(cols)
    if not cols:
        return [], None
    if not _on_cuda(idx, *cols):
        return gather_columns_plain(cols, idx), "plain" if trace else None
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
        return outs, "direct" if trace else None
    if n == 0:
        raise ValueError("K4 gathers from empty columns")
    lib = _load()
    dev = idx.device
    widths = [c.element_size() for c in cols]
    nc = len(cols)
    if (route or k4_route(m, n, widths)) == "image":
        images = k4_images(widths)
        order = [i for im in images for i in im.cols]
    else:
        images = []
        order = sorted(range(nc), key=lambda i: -widths[i])
    ni = len(images)
    with torch.cuda.device(dev):
        # the state (the probe's count, the bits of the paths that ran),
        # then each image, 256-byte aligned; none on the direct route
        at, starts = 256, []
        for im in images:
            starts.append(at)
            at += -(-n * im.rec // 256) * 256
        scratch = torch.empty(at, dtype=torch.uint8, device=dev) \
            if images else None
        base = scratch.data_ptr() if images else None
        istart = [0]
        for im in images:
            istart.append(istart[-1] + len(im.cols))
        rc = lib.ob_k4_gather(
            idx.data_ptr(), m, n, nc,
            (ctypes.c_void_p * nc)(*[cols[i].data_ptr() for i in order]),
            (ctypes.c_void_p * nc)(*[outs[i].data_ptr() for i in order]),
            (ctypes.c_int * nc)(*[widths[i] for i in order]), ni,
            (ctypes.c_int * ni)(*[im.rec for im in images]),
            (ctypes.c_void_p * ni)(*[base + a for a in starts]),
            (ctypes.c_int * (ni + 1))(*istart),
            (ctypes.c_int * nc)(*[o for im in images for o in im.offsets]),
            base, K4_NEAR, k4_probe_pairs(m), K4_FAR_DIV, *K4_IMAGE_SHARE,
            _sm_count(dev), _stream(dev))
        _check(rc, "K4_gather_rows")
        ran = int(scratch[8:16].view(torch.int64).item()) \
            if trace and images else 0
    count_launch(LAUNCHES, "K4_gather_rows")
    if not trace:
        return outs, None
    if not images:
        return outs, "direct"
    if ran not in K4_RAN:
        raise RuntimeError(f"K4's launches left the path bits {ran}")
    return outs, K4_RAN[ran]


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
        # K5_MAX_COLS payload columns a launch (its by-value table); each
        # launch writes the same sel
        for c0 in range(0, max(len(payload), 1), K5_MAX_COLS):
            part = list(range(c0, min(c0 + K5_MAX_COLS, len(payload))))
            nc = len(part)
            src = (ctypes.c_void_p * max(nc, 1))(
                *[payload[i].data_ptr() for i in part])
            dst = (ctypes.c_void_p * max(nc, 1))(
                *[outs[i].data_ptr() for i in part])
            width = (ctypes.c_int * max(nc, 1))(
                *[payload[i].element_size() for i in part])
            rc = lib.ob_k5_affine(
                probe_key.data_ptr(), DTYPE_CODE[probe_key.dtype],
                probe_sel.data_ptr(), n, int(a0), int(stride), nb,
                build_key.data_ptr(), DTYPE_CODE[build_key.dtype],
                build_sel.data_ptr(), sel.data_ptr(), nc, src, dst, width,
                nblk, stream)
            _check(rc, "K5_affine_join")
    count_launch(LAUNCHES, "K5_affine_join")
    return sel, outs


# ---------------------------------------------------------------------------
# K6: clustered-FK segment aggregation
# ---------------------------------------------------------------------------

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


def k6_agg_entries(aggs, raw) -> list:
    """K6's aggregate table (csrc/k6_clustered_agg.cu K6Args), five int64
    entries an aggregate: values, mask, output (addresses, 0 for none),
    the values' type code, 1 for a float sum. One launch takes any number
    of aggregates."""
    out = []
    for (op, v, m), r in zip(aggs, raw):
        out += [v.data_ptr() if op == "sum" else 0,
                m.data_ptr() if m is not None else 0, r.data_ptr(),
                DTYPE_CODE[v.dtype] if op == "sum" else 0,
                int(r.dtype == torch.float64)]
    return out


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
    table = (_device_table(k6_agg_entries(aggs, raw), dev) if aggs
             else None)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k6_segments(
            starts.data_ptr(), ends.data_ptr(), nb, sel.data_ptr(),
            cnt.data_ptr(), len(aggs),
            table.data_ptr() if table is not None else None,
            _blocks(dev, nb, 256), _stream(dev))
        _check(rc, "K6_clustered_agg")
    res = []
    for (op, v, _m), r in zip(aggs, raw):
        res.append(r.to(v.dtype) if r.dtype == torch.float64 else r)
    count_launch(LAUNCHES, "K6_clustered_agg")
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


# the paths of K7 (csrc/k7_topk_candidates.cu K7State::path), its largest
# c on the survivor path and the entries its one-block selection holds
K7_PATHS = ("survivors", "overflow", "full")
K7_FAST_C = 4096
K7_SORT_MAX = 8192
_k7_consts: dict = {}


def k7_bin_plain(v: torch.Tensor) -> torch.Tensor:
    """K7's order-preserving 13-bit code of int64 values (csrc k7_bin):
    x = v or ~v; x below 64 is its own code, else (e - 5) << 6 | the six
    bits after x's top bit e; values >= 0 take 4096 + code, the others
    4095 - code. INT64_MIN (a dead row) gets 384, the lowest."""
    v = v.to(torch.int64)
    x = torch.where(v >= 0, v, ~v)
    e = torch.zeros_like(x)
    for step in (32, 16, 8, 4, 2, 1):
        e = e + step * ((x >> (e + step)) > 0).to(torch.int64)
    code = torch.where(x < 64, x,
                       ((e - 5) << 6) | ((x >> (e - 6).clamp(min=0)) & 63))
    return torch.where(v >= 0, 4096 + code, 4095 - code)


def topk_candidates_path_plain(key, sel, desc: bool, c: int) -> str:
    """The K7_PATHS name of the path K7's launch takes on these inputs:
    past K7_FAST_C candidates "full"; else "survivors" when the bin of the
    c-th largest value (dead rows in the lowest) and the bins above it
    hold at most K7_SORT_MAX rows, the one-block selection's room, else
    "overflow" (the exact path)."""
    if c > K7_FAST_C:
        return "full"
    hist = torch.bincount(k7_bin_plain(_topk_masked(key, sel, desc)),
                          minlength=8192)
    at_or_above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
    kth_bin = int(torch.nonzero(at_or_above >= c).max())
    total = int(at_or_above[kth_bin])
    return "survivors" if total <= K7_SORT_MAX else "overflow"


def _k7_launch(key, sel, desc: bool, c: int):
    """One K7 call on the card: (int32 [c] candidates, the int64 scratch
    whose words hold the tie count and the path)."""
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
    if not _k7_consts:
        _k7_consts.update(cnt=int(lib.ob_k7_word(0)),
                          path=int(lib.ob_k7_word(1)))
    out = torch.empty(c, dtype=torch.int32, device=dev)
    scratch = torch.empty(int(lib.ob_k7_scratch_bytes(c)) // 8,
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k7_topk(
            key.data_ptr(), DTYPE_CODE[key.dtype], sel.data_ptr(),
            int(bool(desc)), n, c, out.data_ptr(), scratch.data_ptr(),
            max(1, min(-(-n // 4096), 6 * _sm_count(dev))), _stream(dev))
        _check(rc, "K7_topk_candidates")
    count_launch(LAUNCHES, "K7_topk_candidates")
    return out, scratch


def topk_candidates(key, sel, desc: bool, c: int):
    """K7: (int32 [c] row indices of the c largest of
    where(sel, key or ~key, INT64_MIN), value descending and ties by lower
    index; the 0-d int64 count of live rows whose value is >= the c-th)."""
    if not _on_cuda(key, sel):
        return topk_candidates_plain(key, sel, desc, c)
    out, scratch = _k7_launch(key, sel, desc, c)
    return out, scratch[_k7_consts["cnt"]]


def topk_candidates_traced(key, sel, desc: bool, c: int):
    """`topk_candidates` and the path its launch took on the card (a
    K7_PATHS name; one host read)."""
    out, scratch = _k7_launch(key, sel, desc, c)
    return out, scratch[_k7_consts["cnt"]], K7_PATHS[
        int(scratch[_k7_consts["path"]])]


# ---------------------------------------------------------------------------
# K8: segmented reduce-by-key over sorted rows
# ---------------------------------------------------------------------------

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


K8_FIELDS = 7  # entries per aggregate (csrc/k8_segmented_reduce.cu)
K8_INLINE = 128  # table entries in the kernel's parameters
K8_TILE = 2048  # sorted rows per tile (ob_k8_tile_rows)


def k8_agg_entries(aggs, raw) -> list:
    """K8's aggregate entries (csrc/k8_segmented_reduce.cu K8Args), seven
    int64 entries an aggregate: values, mask, output (addresses, 0 for
    none), the values' type code, the op (count as a sum of ones), 1 for
    a float accumulator, the identity (a double's bits for floats)."""
    out = []
    for (op, v, m), r in zip(aggs, raw):
        isf = r.dtype == torch.float64
        idv = _identity(op, v.dtype if op != "count" else torch.int64)
        out += [v.data_ptr() if op != "count" else 0,
                m.data_ptr() if m is not None else 0, r.data_ptr(),
                DTYPE_CODE[v.dtype] if op != "count" else 0,
                AGG_CODE["sum" if op == "count" else op], int(isf),
                struct.unpack("<q", struct.pack("<d", idv))[0] if isf
                else int(idv)]
    return out


def k8_table(skeys, aggs, raw) -> list:
    """K8's whole table: the sorted keys' addresses, their type codes,
    then `k8_agg_entries`. One launch takes any number of keys and
    aggregates."""
    return ([k.data_ptr() for k in skeys]
            + [DTYPE_CODE[k.dtype] for k in skeys]
            + k8_agg_entries(aggs, raw))


def k8_scratch_entries(ntiles: int, nagg: int) -> int:
    """int64 entries of K8's look-back scratch (ob_k8_scratch_entries): the
    ticket and the tiles' published flags (zeroed by the launch), each
    tile's last start, its last and leading pieces per aggregate."""
    return 1 + (ntiles + 1) // 2 + ntiles * (1 + 2 * nagg)


def param_table(entries, limit: int, dev: torch.device):
    """(inline, table) of a kernel's int64 table: up to `limit` entries ride
    the kernel's parameters (a host array the launch copies in, nothing
    uploaded), a longer table lies in device memory."""
    if len(entries) <= limit:
        return (ctypes.c_longlong * max(len(entries), 1))(*entries), None
    return None, _device_table(entries, dev)


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
    dev = ssel.device
    for k in skeys:
        _vector(k, n, "K8 sorted key")
        if k.device != dev:
            raise ValueError(f"K8 sorted key on {k.device}, not {dev}")
    for op, v, m in aggs:
        if op not in AGG_CODE:
            raise NotImplementedError(op)
        if op != "count":
            _vector(v, n, "K8 values")
        if m is not None:
            _vector(m, n, "K8 mask")
            if m.dtype != torch.bool:
                raise TypeError("K8 masks must be bool")
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
    ntiles = -(-n // K8_TILE)
    scratch = torch.empty(k8_scratch_entries(ntiles, len(aggs)),
                          dtype=torch.int64, device=dev)
    entries = k8_table(skeys, aggs, raw)
    inline, table = param_table(entries, K8_INLINE, dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k8_segreduce(
            len(skeys), len(aggs), inline, len(entries),
            table.data_ptr() if table is not None else None,
            ssel.data_ptr(), order.data_ptr(), n, sel.data_ptr(),
            scratch.data_ptr(), ntiles, _stream(dev))
        _check(rc, "K8_segmented_reduce")
    res = []
    for (op, v, _m), r in zip(aggs, raw):
        dt = _segreduce_dtype(op, v)
        res.append(r if r.dtype == dt else r.to(dt))
    count_launch(LAUNCHES, "K8_segmented_reduce")
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
    count_launch(LAUNCHES, "K5_affine_join")
    count_launch(ENTRY_LAUNCHES, "K5_affine_join.probe")
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
    count_launch(LAUNCHES, "K9_merge_join")
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


def kernel_launches(name: str) -> int:
    """The kernels the library has launched for K2 or K10 ("K2", "K10"),
    counted where each launch is made (a call's launches are the change
    across it)."""
    lib = _load()
    return int({"K2": lib.ob_k2_kernel_launches,
                "K10": lib.ob_k10_kernel_launches}[name]())


def _k10_vec(probe_keys, probe_sel) -> int:
    """1 when K10 may read the probe keys 16 bytes and sel 2 bytes a pair
    of rows (their addresses allow it), else 0."""
    return int(probe_keys.data_ptr() % 16 == 0
               and probe_sel.data_ptr() % 2 == 0)


def join_ranges(skeys, nlive, probe_keys, probe_sel):
    """K10's range phase alone (the sorted-range semi/anti join): cnt
    int64 [np], the live build rows each live probe key matches. One
    launch; counts as a K10 launch."""
    if not _on_cuda(skeys, nlive, probe_keys, probe_sel):
        return join_ranges_plain(skeys, nlive, probe_keys, probe_sel)
    nb, npr = _check_ranges_args(skeys, nlive, probe_keys, probe_sel)
    _k10_sizes(npr, nb)
    dev = probe_keys.device
    cnt = torch.empty(npr, dtype=torch.int64, device=dev)
    nl = nlive.reshape(1).contiguous()
    lib = _load()
    with _on_device(dev):
        rc = lib.ob_k10_ranges(
            skeys.data_ptr(), nb, nl.data_ptr(), probe_keys.data_ptr(),
            probe_sel.data_ptr(), npr, cnt.data_ptr(),
            _k10_vec(probe_keys, probe_sel), _stream(dev))
        _check(rc, "K10_expand_join ranges")
    count_launch(LAUNCHES, "K10_expand_join")
    count_launch(ENTRY_LAUNCHES, "K10_expand_join.ranges")
    return cnt


def _k10_sizes(npr: int, nb: int) -> None:
    if not 0 < npr < 2**31 or not 0 < nb < 2**31:
        raise ValueError(f"K10 takes 1 to 2^31 - 1 rows a side, got {npr} "
                         f"probe rows and {nb} build rows")


_K10_SCRATCH: dict = {}
_K10_LOCK = threading.Lock()
K10_FILL_BLOCKS_PER_SM = 3  # the fill's blocks stay: a few an SM


def _k10_scratch(lib, dev: torch.device, stream: int, npr: int):
    """(scratch, epoch) of an expansion of npr probe rows on one stream:
    the ticket (0 between launches: the last taker puts it back) and a
    status a tile, whose words carry the epoch of the call that wrote
    them, so the buffer is never cleared; it grows to the largest call."""
    need = int(lib.ob_k10_scratch_bytes(npr))
    k = (dev.index, stream)
    with _K10_LOCK:
        buf, epoch = _K10_SCRATCH.get(k, (None, 0))
        if buf is None or buf.numel() * 8 < need:
            buf = torch.zeros(-(-need // 8), dtype=torch.int64, device=dev)
        epoch += 1
        _K10_SCRATCH[k] = (buf, epoch)
    return buf, epoch


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
    if cap < 0:
        raise ValueError(f"K10 needs cap >= 0, got {cap}")
    _k10_sizes(npr, nb)
    dev = probe_keys.device
    lib = _load()
    i64 = dict(dtype=torch.int64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    run_end, run_row, run_lo = (torch.empty(npr, **i64),
                                torch.empty(npr, **i32),
                                torch.empty(npr, **i32))
    total = torch.empty(1, **i64)
    starts = torch.empty(npr, **i64)
    offs = torch.empty(npr, **i64)
    pr = torch.empty(cap, dtype=torch.int32, device=dev)
    br = torch.empty(cap, dtype=torch.int32, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    nl = nlive.reshape(1).contiguous()
    with _on_device(dev):
        stream = _stream(dev)
        scratch, epoch = _k10_scratch(lib, dev, stream, npr)
        rc = lib.ob_k10_expand(
            skeys.data_ptr(), order.data_ptr(), nb, nl.data_ptr(),
            probe_keys.data_ptr(), probe_sel.data_ptr(), npr, cap,
            run_end.data_ptr(), run_row.data_ptr(), run_lo.data_ptr(),
            scratch.data_ptr(), epoch, total.data_ptr(), starts.data_ptr(),
            offs.data_ptr(), pr.data_ptr(), br.data_ptr(), valid.data_ptr(),
            _k10_vec(probe_keys, probe_sel),
            _sm_count(dev) * K10_FILL_BLOCKS_PER_SM, stream)
        _check(rc, "K10_expand_join")
    count_launch(LAUNCHES, "K10_expand_join")
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
    count_launch(LAUNCHES, "K11_probe_run_any")
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
    count_launch(LAUNCHES, "K11_probe_run_any")
    count_launch(ENTRY_LAUNCHES, "K11_probe_run_any.mark_build")
    return has


# ---------------------------------------------------------------------------
# K12: splitmix64 hash of multi-column keys
# ---------------------------------------------------------------------------



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


def float_key_image(c: torch.Tensor) -> torch.Tensor:
    """The int64 image of a float key column's values: the float64 bits,
    float32 widened exactly, -0.0 as +0.0. Equal values give equal images
    and unequal ones unequal images (NaN rows, which equal nothing, are
    the caller's to mask)."""
    f = c.to(torch.float64)
    return torch.where(f == 0, 0.0, f).view(torch.int64)


def _hash_operand(c: torch.Tensor) -> torch.Tensor:
    if c.dtype.is_floating_point:
        return float_key_image(c)
    return c.to(torch.int64)  # sign-extends, as astype(uint64) converts


def hash_columns_plain(cols):
    """Plain version of K12 (ops/hashing.py hash_combine, read as int64 as
    join_keys64 does); a float column hashes `float_key_image`, where the
    JAX package truncates it to uint64."""
    h = torch.zeros(cols[0].shape, dtype=torch.int64, device=cols[0].device)
    for c in cols:
        h = mix64_plain(h ^ (_hash_operand(c) + GOLDEN64))
    return h


def hash_columns(cols):
    """K12: int64 [n] hash_combine of the key columns (any number: the
    columns ride a device table; a float column hashes its value's
    image, as `hash_columns_plain`)."""
    cols = list(cols)
    if not cols:
        raise ValueError("K12 needs at least one column")
    if not _on_cuda(*cols):
        return hash_columns_plain(cols)
    n = int(cols[0].shape[0])
    dev = cols[0].device
    table = _key_table(cols, n, "K12 key column", dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k12_hash(
            len(cols), table.data_ptr(), n, out.data_ptr(),
            _blocks(dev, n, 256 * 4), _stream(dev))
        _check(rc, "K12_hash_combine")
    count_launch(LAUNCHES, "K12_hash_combine")
    return out


# ---------------------------------------------------------------------------
# K13: the scans of window functions and of INTERSECT/EXCEPT ALL
# ---------------------------------------------------------------------------

K13_MAX_KEYS = 16
# rows a tile of a scan holds (ob_k13_tile_rows)
K13_TILE = 4096
# value modes of ob_k13_scan (csrc/k13_window_scan.cu)
_K13_VAL, _K13_START_MARK, _K13_END_MARK = 0, 1, 2


def k13_scratch_bytes(ntiles: int) -> int:
    """Bytes of one K13 scan's scratch (ob_k13_scratch_bytes): the ticket,
    a status word a tile and a chunk of 32 tiles (8-byte aligned), each
    tile's aggregate and each chunk's inclusive prefix."""
    words = ntiles + -(-ntiles // 32)
    return 8 + ((4 * words + 7) & ~7) + 8 * words


def _k13_scan(x, flags, mode: int, op: str, reverse: bool, segmented: bool,
              n: int, out_dtype: torch.dtype, dev: torch.device):
    """One K13 scan: one launch, single pass (its ticket and status words
    zeroed by the C entry first)."""
    out = torch.empty(n, dtype=out_dtype, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        ntiles = -(-n // K13_TILE)
        scratch = torch.empty(k13_scratch_bytes(ntiles), dtype=torch.uint8,
                              device=dev)
        rc = lib.ob_k13_scan(
            x.data_ptr() if x is not None else None,
            DTYPE_CODE[x.dtype] if x is not None else 0,
            flags.data_ptr() if flags is not None else None, mode,
            AGG_CODE[op], int(reverse), int(segmented), n, out.data_ptr(),
            scratch.data_ptr(), ntiles, _stream(dev))
        _check(rc, "K13_window_scan")
    count_launch(LAUNCHES, "K13_window_scan")
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
                got.data_ptr(), _blocks(dev, n, K13_TILE), _stream(dev))
            _check(rc, "K13_window_scan flags")
            count_launch(LAUNCHES, "K13_window_scan")
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
    column, in its type (floats add in double, in an association fixed by
    the tiles, so every run gives the same bits)."""
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
    count_launch(LAUNCHES, "K13_window_scan")
    return out


# ---------------------------------------------------------------------------
# K14: the multi-column hash set (build and existence probe)
# ---------------------------------------------------------------------------

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


def _lockstep_slots(key_cols, mask: torch.Tensor, table_size: int):
    """The reference's slot assignment (ops/hashagg.py assign_group_slots):
    every live row probes in lockstep, the lowest row id wins each empty
    slot, rows meeting an equal tag and key tuple join its slot, the others
    advance; after table_size rounds a row still pending keeps slot -1.
    Returns (slot_tag, slot_row, row_slot) int32; empty slots hold row -1,
    tag 0."""
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
    row_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
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
        matched = winner | same
        row_slot = torch.where(matched, pos.to(torch.int32), row_slot)
        pending = pending & ~matched
        advance = pending & at_used & ~((at_tag == tags) & exact)
        probe_of = probe_of + advance.to(torch.int64)
        rnd += 1
    return slot_tag[:ts].clone(), slot_row[:ts].clone(), row_slot


def hash_set_build_plain(key_cols, mask: torch.Tensor, table_size: int):
    """Plain version of K14's build (ops/join.py build_hash_table over
    ops/hashagg.py assign_group_slots): (slot_tag, slot_row) int32 [T] of
    the reference's lockstep schedule."""
    slot_tag, slot_row, _ = _lockstep_slots(key_cols, mask, table_size)
    return slot_tag, slot_row


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
    if not cols:
        raise ValueError("K14 takes at least one key column")
    dev = mask.device
    # the key tuple's table in device memory (csrc/ob_common.cuh ObKeys):
    # any number of columns, e.g. the two planes of every nullable column
    # that INTERSECT and EXCEPT hash
    table = _key_table(cols, nb, "K14 build key", dev)
    ts = int(table_size)
    if ts < 2 * nb or ts & (ts - 1) or nb >= 2**31:
        raise ValueError(f"K14 needs a power-of-two table of >= 2 x {nb} "
                         f"slots, got {ts}")
    slot_tag = torch.empty(ts, dtype=torch.int32, device=dev)
    slot_row = torch.empty(ts, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k14_build(len(cols), table.data_ptr(), mask.data_ptr(),
                              nb, slot_tag.data_ptr(), slot_row.data_ptr(), ts,
                              _blocks(dev, max(nb, ts // 4), 256 * 4),
                              _stream(dev))
        _check(rc, "K14_hash_set build")
    count_launch(LAUNCHES, "K14_hash_set")
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
    dev = probe_mask.device
    btab = _key_table(bcols, int(bcols[0].shape[0]), "K14 build key", dev)
    ptab = _key_table(pcols, npr, "K14 probe key", dev)
    match = torch.empty(npr, dtype=torch.int32, device=dev)
    if npr == 0:
        return match
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k14_probe(len(bcols), btab.data_ptr(), ptab.data_ptr(),
                              probe_mask.data_ptr(), npr, slot_tag.data_ptr(),
                              slot_row.data_ptr(), ts, match.data_ptr(),
                              _blocks(dev, npr, 256 * 4), _stream(dev))
        _check(rc, "K14_hash_set probe")
    count_launch(LAUNCHES, "K14_hash_set")
    return match


# ---------------------------------------------------------------------------
# K15: first occurrences through a sort order; rows back through it
# ---------------------------------------------------------------------------

K15_MAX_SCATTER = 48
# the record route's record sizes (bytes): the keys widest first, then the
# flag byte last (csrc/k15_distinct_first.cu)
K15_RECORD_BYTES = (8, 16, 32)
K15_ROUTES = ("image", "record", "columns", "rows")


def k15_record_layout(dtypes):
    """(record bytes, each key's byte offset) of K15's record route for
    keys of these dtypes: widest first, so every key lies on its own
    alignment, and one flag byte after them, the record's last (live, and
    whether a key is NaN); None where they need more than 32 bytes."""
    widths = [torch.empty(0, dtype=d).element_size() for d in dtypes]
    offs, at = [0] * len(widths), 0
    for j in sorted(range(len(widths)), key=lambda j: -widths[j]):
        offs[j] = at
        at += widths[j]
    rb = next((r for r in K15_RECORD_BYTES if at + 1 <= r), None)
    return None if rb is None else (rb, offs)


def k15_route(plan, kept: int, nk: int, dtypes) -> str:
    """K15's route for K3's `plan` of (dead, keys...) with the row inside
    its images where it fits (`k3_plan(..., row_inside=True)`; nk keys,
    `kept` of them kept by `k3_kept`) over keys of these dtypes:
    - "rows": an empty plan (every key constant or in row order), the
      order is the identity: neighbours compared in row order;
    - "image": one composite whose image holds the row, no key dropped for
      being in row order (rows may tie on the kept keys and differ there)
      and no float key (K3's images merge every NaN): K3's sorted images;
    - "record": the keys and flags in a record of at most 32 bytes;
    - "columns": wider keys, read column by column at each sorted row."""
    if not plan:
        return "rows"
    if (kept == nk and len(plan) == 1 and plan[0].width and plan[0].rbits
            and not any(d.is_floating_point for d in dtypes)):
        return "image"
    return "record" if k15_record_layout(dtypes) else "columns"


def first_occurrence_plain(key_cols, mask: torch.Tensor, order):
    """Plain version of K15 (the tail of ops/hashagg.py
    distinct_first_mask): run boundaries over (dead, keys...) in sorted
    order (`order` None: the rows are in that order), live run starts,
    mapped back by the inverse permutation."""
    if order is None:
        order = torch.arange(mask.shape[0], device=mask.device)
    o = order.to(torch.int64)
    sdead = (~mask)[o]
    new_run = boundaries_plain([sdead] + [k[o] for k in key_cols])
    first = new_run & ~sdead
    return first[torch.argsort(o)]


def first_occurrence(key_cols, mask: torch.Tensor, order,
                     route: str | None = None):
    """K15: bool [n] in row order, set at the first live row of every run
    of equal (keys...) along `order` (K3's stable order of (dead,
    keys...); None: the rows are in that order). `route` ("record",
    "columns" or "rows") defaults to the record route where the keys fit
    a 32-byte record; see `k15_route`."""
    cols = list(key_cols)
    if not _on_cuda(mask, order, *cols):
        return first_occurrence_plain(cols, mask, order)
    n = _flags_arg(mask, "K15 mask")
    if not cols:
        raise ValueError("K15 takes at least one key column")
    if order is not None:
        _vector(order, n, "K15 order")
        if order.dtype != torch.int32:
            raise TypeError("K15 order must be int32")
    layout = k15_record_layout([c.dtype for c in cols])
    if route is None:
        route = "rows" if order is None else (
            "record" if layout else "columns")
    if (route == "rows") != (order is None) or route not in K15_ROUTES[1:] \
            or (route == "record" and layout is None):
        raise ValueError(f"K15 route {route!r} with this order and keys")
    dev = mask.device
    first = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return first
    lib = _load()
    with torch.cuda.device(dev):
        if route == "record":
            rb, offs = layout
            table = _key_table(cols, n, "K15 key", dev, offs)
            rec = torch.empty(n * rb, dtype=torch.uint8, device=dev)
            rc = lib.ob_k15_first_records(
                len(cols), table.data_ptr(), mask.data_ptr(),
                order.data_ptr(), n, rb, rec.data_ptr(), first.data_ptr(),
                _blocks(dev, n, 256 * 4), _stream(dev))
        else:
            table = _key_table(cols, n, "K15 key", dev)
            rc = lib.ob_k15_first(
                len(cols), table.data_ptr(), mask.data_ptr(),
                order.data_ptr() if order is not None else None, n,
                first.data_ptr(), _blocks(dev, n, 256 * 4), _stream(dev))
        _check(rc, f"K15_distinct_first {route}")
    count_launch(LAUNCHES, "K15_distinct_first")
    return first


def first_occurrence_images(s: K3Sorted) -> torch.Tensor:
    """K15's image route: bool [n] in row order from K3's sorted images
    (`sort_order_images`): a row starts a run where its image's key bits
    differ from the previous image's, and is marked when live."""
    if s.route != "image" or s.images is None:
        raise ValueError("K15's image route takes K3's images")
    img = s.images
    n = int(img.shape[0])
    _vector(img, n, "K15 images")
    dev = img.device
    first = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return first
    lib = _load()
    live_const = -1 if s.dead_bit >= 0 else s.live
    with torch.cuda.device(dev):
        rc = lib.ob_k15_first_images(
            img.data_ptr(), img.element_size() * 8, n, s.rbits,
            max(s.dead_bit, 0), live_const, first.data_ptr(),
            _blocks(dev, n, 256 * 4), _stream(dev))
        _check(rc, "K15_distinct_first image")
    count_launch(LAUNCHES, "K15_distinct_first")
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
    count_launch(LAUNCHES, "K15_distinct_first")
    count_launch(ENTRY_LAUNCHES, "K15_distinct_first.scatter")
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
    count_launch(LAUNCHES, "K16_hll")
    return regs


# ---------------------------------------------------------------------------
# K17: the range slice of a sorted-projection scan
# ---------------------------------------------------------------------------

_RANGE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)
K17_INLINE = 64  # table entries in the kernel's parameters


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


# the head of csrc/k17_slice_scan.cu's K17Args: key, sel, table, n, cap,
# cap2, sel_off, key_dt, ncols, nbounds, pad; K17_INLINE entries follow
_K17_HDR = struct.Struct("<QQQqqqqiiii")
K17_THREADS = 256
K17_PLANS_MAX = 64


class K17Plan(NamedTuple):
    """One call's arguments to K17 but for the output's address: the
    K17Args image, the device table past K17_INLINE entries (kept alive
    with the plan), the output allocation's bytes, its parts (sizes for
    one split: nrows and overflow, then each column's slice and sel, each
    followed by its padding to 16 bytes) with the dtype of each part that
    is an output, and the grid."""
    blob: bytes
    table: torch.Tensor | None
    nbytes: int
    sizes: tuple
    views: tuple
    sel_off: int
    nblocks: int


_K17_PLANS: OrderedDict = OrderedDict()
_K17_LOCK = threading.Lock()
_K17_SCRATCH: dict = {}


def _k17_id(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t.dtype, t.shape)


def _pad16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def k17_plan(key, n: int, lows, highs, cap: int, payload, sel,
             sms: int) -> K17Plan:
    """K17's arguments for a call, cached by everything they are made of
    (every tensor's address, dtype and shape, the bounds' sides, n, cap,
    the card's SM count): a call over the same columns and bounds reuses
    the table, and a changed address is another entry, built and checked
    anew (device, contiguity, widths). The outputs lie in one allocation:
    nrows and overflow in its first 16 bytes, then each column's slice
    and sel at 16-byte aligned offsets."""
    ck = (_k17_id(key), n, cap, _k17_id(sel), sms,
          tuple(_k17_id(c) for c in payload),
          tuple((_k17_id(v), s) for v, s in lows),
          tuple((_k17_id(v), s) for v, s in highs))
    with _K17_LOCK:
        hit = _K17_PLANS.get(ck)
        if hit is not None:
            _K17_PLANS.move_to_end(ck)
            return hit
    cap2 = int(sel.shape[0])
    _vector(key, cap2, "K17 key")
    _vector(sel, cap2, "K17 sel")
    if key.dtype not in _RANGE_DTYPES:
        raise TypeError(f"K17 keys are integers, got {key.dtype}")
    if sel.dtype != torch.bool:
        raise TypeError("K17 sel must be bool")
    if not 0 < cap < cap2 or n > cap2:
        raise ValueError(f"K17 slices {cap} of {cap2} rows ({n} stored)")
    bounds = [(v, s, False) for v, s in lows] + [(v, s, True)
                                                 for v, s in highs]
    for v, _s, _h in bounds:
        if v.numel() != 1 or v.dtype not in _RANGE_DTYPES:
            raise TypeError("K17 bounds are integer scalars")
    _on_cuda(key, sel, *payload, *(v for v, _s, _h in bounds))
    entries, views, sizes, off = [], [], [16], 16
    for c in payload:
        _vector(c, cap2, "K17 column")
        w = c.element_size()
        if w not in _WIDTHS:
            raise TypeError(f"K17 column width {w}")
        entries += [c.data_ptr(), off * 16 + w]
        views.append((len(sizes), c.dtype))
        sizes += [cap * w, _pad16(cap * w) - cap * w]
        off += _pad16(cap * w)
    sel_off = off
    views.append((len(sizes), torch.bool))
    sizes += [cap, _pad16(cap) - cap]
    off += _pad16(cap)
    for v, side, high in bounds:
        entries += [v.data_ptr(), DTYPE_CODE[v.dtype] * 4
                    + int(side == "right") + (2 if high else 0)]
    table = None
    if len(entries) > K17_INLINE:
        table = _device_table(entries, key.device)
        entries = []
    vectors = sum(_pad16(cap * c.element_size()) // 16 for c in payload) \
        + _pad16(cap) // 16
    nblocks = max(1, min(-(-vectors // (K17_THREADS * 4)), sms * 4))
    blob = _K17_HDR.pack(
        key.data_ptr(), sel.data_ptr(),
        table.data_ptr() if table is not None else 0, n, cap, cap2, sel_off,
        DTYPE_CODE[key.dtype], len(payload), len(bounds), 0) + struct.pack(
        f"<{K17_INLINE}q", *(entries + [0] * (K17_INLINE - len(entries))))
    plan = K17Plan(blob, table, off, tuple(sizes), tuple(views), sel_off,
                   nblocks)
    with _K17_LOCK:
        _K17_PLANS[ck] = plan
        while len(_K17_PLANS) > K17_PLANS_MAX:
            _K17_PLANS.popitem(last=False)
    return plan


def _k17_scratch(dev: torch.device, stream: int, sms: int) -> torch.Tensor:
    """The ticket and the per-block counts of K17's launches on one stream
    (the ticket is 0 between launches: the last block puts it back)."""
    k = (dev.index, stream)
    t = _K17_SCRATCH.get(k)
    if t is None:
        t = _K17_SCRATCH[k] = torch.zeros(1 + sms * 4, dtype=torch.int64,
                                          device=dev)
    return t


def slice_scan(key, n: int, lows, highs, cap: int, payload, sel):
    """K17: the sliced payload columns, sel, nrows and overflow of a
    sorted-projection scan, in one launch and nothing else; the bounds are
    read on the device. lows/highs: lists of (0-d tensor, 'left'|'right').
    The outputs are views of one allocation. The plan (`k17_plan`) checks
    that every tensor lies on sel's device."""
    if not sel.is_cuda:
        return slice_scan_plain(key, n, lows, highs, cap, list(payload), sel)
    dev = sel.device
    sms = _sm_count(dev)
    plan = k17_plan(key, n, lows, highs, cap, payload, sel, sms)
    lib = _load()
    if not _k17_checked:
        _k17_check(lib)
    with _on_device(dev):
        stream = _stream(dev)
        buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
        rc = lib.ob_k17_slice(plan.blob, plan.nblocks, buf.data_ptr(),
                              _k17_scratch(dev, stream, sms).data_ptr(),
                              stream)
        _check(rc, "K17_slice_scan")
    count_launch(LAUNCHES, "K17_slice_scan")
    parts = buf.split_with_sizes(plan.sizes)
    outs = [parts[i].view(dt) for i, dt in plan.views]
    nrows, ovf = parts[0].view(torch.int64).unbind()
    return outs[:-1], outs[-1], nrows, ovf


_k17_checked = False


def _k17_check(lib) -> None:
    global _k17_checked
    if int(lib.ob_k17_args_bytes()) != _K17_HDR.size + 8 * K17_INLINE:
        raise RuntimeError("K17 argument layout differs from the source")
    _k17_checked = True


def _on_device(dev: torch.device):
    """The device context a launch on `dev` needs (none when it is the
    current device already)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


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
    """K18: every column of a staged chunk's wire plan decoded, and sel.
    One launch per K18_MAX_COLS planes of `meta`; the first writes sel.
    Returns ({key: column}, sel)."""
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
    if cap < 1:
        raise ValueError("K18 decodes a chunk of at least one row")
    lib = _load()
    if _k18_tile is None:
        _k18_tile = int(lib.ob_k18_run_tile())
    out = {}
    sel = torch.empty(cap, dtype=torch.bool, device=dev)
    meta = list(meta)
    for g in range(0, max(len(meta), 1), K18_MAX_COLS):
        _k18_launch(lib, dev, meta[g:g + K18_MAX_COLS], staged, bases,
                    count, cap, dtypes, out, sel if g == 0 else None)
    return out, sel


def _k18_launch(lib, dev, meta, staged, bases, count: int, cap: int, dtypes,
                out: dict, sel) -> None:
    """One K18 launch over at most K18_MAX_COLS planes, their columns put
    in `out`; sel is written when given."""
    nc = len(meta)
    kinds, sdt, ddt, src, lens, dst, base, rcap, state = (
        [] for _ in range(9))
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

    def arr(ctype, vals):
        return (ctype * max(nc, 1))(*vals)

    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        rc = lib.ob_k18_decode(
            nc, arr(ctypes.c_int, kinds), arr(ctypes.c_int, sdt),
            arr(ctypes.c_int, ddt), arr(P, src), arr(P, lens), arr(P, dst),
            arr(ctypes.c_longlong, base), arr(ctypes.c_longlong, rcap),
            arr(P, state), cap, int(count),
            sel.data_ptr() if sel is not None else None, _stream(dev))
        _check(rc, "K18_decode_staged")
    count_launch(LAUNCHES, "K18_decode_staged")


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
    count_launch(LAUNCHES, "K19_kmeans_assign")
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
    count_launch(LAUNCHES, "K20_kmeans_update")
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
    count_launch(LAUNCHES, "K21_ivf_lists")
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


_k22_tile = None
_k22_smem_k = None


def ivf_probe(x, sel, perm, offs, lens, probes, q, max_list: int, n: int,
              k: int):
    """K22: the IVF probe's gather, exact re-rank and top-k in one tile
    pass and one merge launch (the runs in shared memory up to
    `ob_k22_smem_k` keys, in device memory past it: any k). x: (cap, d)
    float32 vectors, sel: bool
    [cap] live rows after the fused filter, perm/offs/lens: the index's
    int32 arrays, probes: int32 [nprobe] (K21). Returns (int32 [k'] rows,
    bool [k'] sel, 0-d int64 starvation count), k' = min(k, nprobe *
    max_list), in lax.top_k's order."""
    global _k22_tile, _k22_smem_k
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
    if kk < 1:
        raise ValueError(f"K22 selects at least one row, got {kk}")
    lib = _load()
    if _k22_tile is None:
        _k22_tile = int(lib.ob_k22_tile())
        _k22_smem_k = int(lib.ob_k22_smem_k())
    dev = x.device
    nblocks = max(1, min(-(-cand // _k22_tile),
                         2 * torch.cuda.get_device_properties(
                             dev).multi_processor_count))
    partial = torch.empty(nblocks * kk, dtype=torch.int64, device=dev)
    # past the shared-memory runs: each block's run and the merge's in
    # device memory
    gruns = (torch.empty((nblocks + 1) * 2 * kk, dtype=torch.int64,
                         device=dev) if kk > _k22_smem_k else None)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.empty(kk, dtype=torch.int32, device=dev)
    osel = torch.empty(kk, dtype=torch.bool, device=dev)
    starved = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k22_probe(
            x.data_ptr(), sel.data_ptr(), perm.data_ptr(), offs.data_ptr(),
            lens.data_ptr(), probes.data_ptr(), q.data_ptr(), nprobe,
            int(max_list), int(n), d, kk, nblocks, partial.data_ptr(),
            gruns.data_ptr() if gruns is not None else None,
            live.data_ptr(), rows.data_ptr(), osel.data_ptr(),
            starved.data_ptr(), _stream(dev))
        _check(rc, "K22_ivf_probe")
    count_launch(LAUNCHES, "K22_ivf_probe")
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
    count_launch(LAUNCHES, "K23_first_live")
    return idx, nlive, outs


# ---------------------------------------------------------------------------
# K24: fused expression register programs (expr/program.py)
# ---------------------------------------------------------------------------

# the header of csrc/k24_fused_expr.cu's K24Prog: n, qrow, in[32],
# out[32], n_ins, n_uni, n32, n64, rows, pad; the instructions follow,
# 16 bytes each, the uniform prologue first
_K24_HDR = struct.Struct("<qQ32Q32Qiiiiii")
_K24_MAX_INS = 160
_k24_checked = False


def _k24_io(program, batch, ext, dev):
    """Output and temporary columns of one run, and a resolver from an
    input descriptor of a chunk to its tensor."""
    cap = batch.capacity
    outs = [torch.empty(cap, dtype=dt, device=dev)
            for dt in program.out_dtypes]
    tmps = [torch.empty(cap, dtype=dt, device=dev)
            for dt in program.tmp_dtypes]
    luts = program.luts_on(dev)

    def resolve(desc):
        kind = desc[0]
        if kind == "lut":
            return luts[desc[1]]
        if kind == "tmp":
            return tmps[desc[1]]
        if kind == "col":
            t = batch.cols[desc[1]]
        elif kind == "valid":
            t = batch.valid[desc[1]]
        elif kind == "sel":
            t = batch.sel
        elif kind == "ext":
            t = ext[desc[1]][0]
        else:
            t = ext[desc[1]][1]
        if t.dim() != 1 or int(t.shape[0]) != cap:
            raise ValueError(f"K24 input {desc}: expected [{cap}], got "
                             f"{tuple(t.shape)}")
        return t.contiguous()

    return outs, tmps, resolve


def _k24_wide(code: int) -> bool:
    return code in (DTYPE_CODE[torch.int64], DTYPE_CODE[torch.float64])


def fused_expr_plain(program, batch, qrow=None, ext=()):
    """Plain version of K24: the same chunks, instruction by instruction,
    as torch ops of each instruction's dtype (operands are already of
    it, so no torch promotion applies): a chunk's uniform prologue as 0-d
    tensors, its row code over a file of two classes (32-bit values,
    int64 / float64). Returns the output columns."""
    from .expr import program as P

    dev = batch.sel.device
    outs, tmps, resolve = _k24_io(program, batch, ext, dev)
    code_dt = P.CODE_DTYPE
    for ch in program.chunks:
        ins = [resolve(d) for d in ch.inputs]
        dst = [outs[k] if kind == "out" else tmps[k]
               for kind, k in ch.outputs]
        u = {}
        regs = {}

        def get(x, wide):
            if x & P.UNI:
                return u[x & ~P.UNI]
            return regs[(wide, x)]

        for op, t, d, a, b, c, t2, imm in ch.ucode:
            dt = code_dt[t]
            if op == P.OP_PARAM:
                if dt.is_floating_point:
                    v = qrow[imm:imm + 1].view(torch.float64).reshape(
                        ()).to(dt)
                else:
                    v = qrow[imm].to(dt)
            elif op == P.OP_CONST:
                v = P.const_tensor(imm, dt, dev)
            elif op == P.OP_LUT:
                v = ins[imm][get(a, True)]
            elif op == P.OP_CAST:
                v = get(a, False).to(dt)
            elif op == P.OP_SELECT:
                v = torch.where(get(a, False), get(b, False), get(c, False))
            elif op in P.PLAIN_UNARY:
                v = P.PLAIN_UNARY[op](get(a, False))
            else:
                v = P.PLAIN_BINARY[op](get(a, False), get(b, False))
            u[d] = v
        for op, t, d, a, b, c, t2, imm in ch.code:
            dt = code_dt[t]
            w = _k24_wide(t)
            if op == P.OP_LOAD:
                v = ins[imm]
                if v.dtype != dt:
                    raise TypeError(f"K24 load of {v.dtype} as {dt}")
            elif op == P.OP_LUT:
                v = ins[imm][get(a, True)]
            elif op == P.OP_CAST:
                v = get(a, _k24_wide(t2)).to(dt)
            elif op == P.OP_STORE:
                dst[imm].copy_(get(a, w))
                continue
            elif op == P.OP_SELECT:
                v = torch.where(get(a, False), get(b, w), get(c, w))
            elif op in P.PLAIN_UNARY:
                v = P.PLAIN_UNARY[op](get(a, w))
            else:
                v = P.PLAIN_BINARY[op](get(a, w), get(b, w))
            regs[(_k24_wide(DTYPE_CODE[v.dtype]), d)] = v
    return outs


def fused_expr(program, batch, qrow=None, ext=()):
    """K24: run a lowered program over a batch, one launch per chunk.
    batch: a ColumnBatch whose columns the program reads (1-D, capacity
    rows); qrow: the packed int64 parameter row on the same device (or
    None when the program reads no parameter); ext: (values, validity)
    of each subtree the torch route evaluated. Returns the output
    columns, bit for bit as `fused_expr_plain`."""
    global _k24_checked
    sel = batch.sel
    if not _on_cuda(sel, qrow):
        return fused_expr_plain(program, batch, qrow, ext)
    if qrow is not None and (qrow.dtype != torch.int64 or qrow.dim() != 1
                             or not qrow.is_contiguous()):
        raise TypeError("K24 parameter row must be contiguous int64 [w]")
    dev = sel.device
    lib = _load()
    if not _k24_checked:
        size = _K24_HDR.size + 16 * _K24_MAX_INS
        if int(lib.ob_k24_prog_bytes()) != size:
            raise RuntimeError("K24 program layout differs from the source")
        _k24_checked = True
    outs, tmps, resolve = _k24_io(program, batch, ext, dev)
    cap = batch.capacity
    if cap == 0:
        return outs
    sms = _sm_count(dev)
    qptr = qrow.data_ptr() if qrow is not None else 0
    pad = b"\0" * (16 * _K24_MAX_INS)
    with _on_device(dev):
        stream = _stream(dev)
        for ch in program.chunks:
            ins = [resolve(d) for d in ch.inputs]
            for t in ins:
                if t.device != dev:
                    raise ValueError(f"K24 input on {t.device}, not {dev}")
            dst = [outs[k] if kind == "out" else tmps[k]
                   for kind, k in ch.outputs]
            ptrs = [t.data_ptr() for t in ins]
            optrs = [t.data_ptr() for t in dst]
            hdr = _K24_HDR.pack(
                cap, qptr, *(ptrs + [0] * (32 - len(ptrs))),
                *(optrs + [0] * (32 - len(optrs))),
                len(ch.ucode) + len(ch.code), len(ch.ucode), ch.n32, ch.n64,
                ch.rows, 0)
            blob = hdr + ch.blob + pad[len(ch.blob):]
            rc = lib.ob_k24_run(blob, sms, stream)
            _check(rc, "K24_fused_expr")
            count_launch(LAUNCHES, "K24_fused_expr")
    return outs


# ---------------------------------------------------------------------------
# K25-K28: the PX exchanges (parallel/exchange.py, parallel/px.py)
# ---------------------------------------------------------------------------

_K25_MODE = {"hash": 0, "range": 1, "partition": 2}
_K25_MAX_SHARDS = 64  # csrc/k25_exchange_pack.cu K25_MAX_SHARDS
_K28_MODE = {"range": 0, "count": 1, "bits": 2}
_K27_OP = {"sum": 1, "min": 2, "max": 3, "or": 4}


def _device_table(values, dev: torch.device) -> torch.Tensor:
    """An int64 table (column addresses, type codes, sizes) on the card,
    copied from pinned memory without a host sync."""
    host = torch.tensor(list(values), dtype=torch.int64)
    if dev.type == "cpu":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def _key_table(keys, n: int, what: str, dev: torch.device,
               extra=()) -> torch.Tensor:
    """ObKeys' device table: the addresses, the type codes, then `extra`
    (a kernel's own entries a column)."""
    for k in keys:
        _vector(k, n, what)
        if k.device != dev:
            raise ValueError(f"{what} on {k.device}, not {dev}")
    return _device_table([k.data_ptr() for k in keys]
                         + [DTYPE_CODE[k.dtype] for k in keys] + list(extra),
                         dev)


def _plane(t: torch.Tensor, what: str) -> None:
    """A plane K25 and K26 move: a contiguous column, or a contiguous
    (rows, d) tensor of fixed-width rows (a VECTOR column)."""
    if t.dim() not in (1, 2) or not t.is_contiguous():
        raise ValueError(f"{what}: planes must be contiguous 1-D columns "
                         "or 2-D row planes")
    if t.dim() == 1 and t.element_size() not in _WIDTHS:
        raise TypeError(f"{what}: element width {t.element_size()}")
    if t.dim() == 2 and plane_row_bytes(t) < 1:
        raise TypeError(f"{what}: a row plane of width 0")


def plane_row_bytes(t: torch.Tensor) -> int:
    """Bytes of one row of a plane (an element of a 1-D column, d values
    of a row plane)."""
    return t.element_size() * (int(t.shape[1]) if t.dim() == 2 else 1)


def exchange_dest_plain(mode: str, n_shards: int, keys, bounds=None,
                        owner=None, desc: bool = False) -> torch.Tensor:
    """Plain version of K25's destination step: int32 [n] dest shard of
    every row (live or not). "hash": hash32_combine(keys) % n_shards
    (parallel/exchange.py:45); "range": searchsorted(bounds, key,
    side="right") (:52), flipped to n_shards - 1 - d when desc;
    "partition": owner[part] (:231), negative ids wrapping once and the
    rest clamped as jnp indexes."""
    if mode == "hash":
        return (hash32_combine_plain(list(keys)) % n_shards).to(torch.int32)
    if mode == "range":
        k = keys[0].to(torch.int64)
        d = torch.searchsorted(bounds.to(torch.int64).contiguous(), k,
                               right=True).to(torch.int32)
        return (n_shards - 1 - d).to(torch.int32) if desc else d
    if mode == "partition":
        m = int(owner.shape[0])
        p = keys[0].to(torch.int64)
        p = torch.where(p < 0, p + m, p).clamp(0, m - 1)
        return owner[p].to(torch.int32)
    raise ValueError(f"unknown K25 mode {mode!r}")


def exchange_dest(mode: str, n_shards: int, keys, bounds=None, owner=None,
                  desc: bool = False) -> torch.Tensor:
    """K25 destination step (modes as `exchange_dest_plain`): one thread a
    row, the hash over any number of key columns."""
    keys = list(keys)
    extra = [bounds] if mode == "range" else (
        [owner] if mode == "partition" else [])
    if not _on_cuda(*keys, *extra):
        return exchange_dest_plain(mode, n_shards, keys, bounds, owner, desc)
    if mode not in _K25_MODE:
        raise ValueError(f"unknown K25 mode {mode!r}")
    if not 1 <= n_shards <= _K25_MAX_SHARDS:
        raise ValueError(f"K25 takes 1..{_K25_MAX_SHARDS} shards")
    if mode != "hash" and len(keys) != 1:
        raise ValueError(f"K25 {mode} takes one key column")
    n = int(keys[0].shape[0])
    dev = keys[0].device
    if mode in ("range", "partition") and keys[0].dtype.is_floating_point:
        raise TypeError(f"K25 {mode} key must be an integer column")
    table = _key_table(keys, n, "K25 key", dev)
    nb, bptr, optr, odt, on = 0, None, None, 0, 0
    if mode == "range":
        bounds = bounds.to(torch.int64).contiguous()
        nb, bptr = int(bounds.shape[0]), bounds.data_ptr()
        if nb != n_shards - 1:
            raise ValueError(f"K25 range needs {n_shards - 1} bounds")
    if mode == "partition":
        _vector(owner, int(owner.shape[0]), "K25 owner")
        optr, odt, on = owner.data_ptr(), DTYPE_CODE[owner.dtype], int(
            owner.shape[0])
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k25_dest(_K25_MODE[mode], len(keys), table.data_ptr(), n,
                             n_shards, bptr, nb, optr, odt, on, int(desc),
                             dest.data_ptr(), _blocks(dev, n, 256 * 4),
                             _stream(dev))
        _check(rc, "K25_exchange_pack dest")
    count_launch(LAUNCHES, "K25_exchange_pack")
    return dest


def round_robin_dest_plain(mask: torch.Tensor, n_shards: int,
                           shard: int) -> torch.Tensor:
    """Plain version of K25's round robin (parallel/exchange.py:59):
    ((cumsum(mask) - 1 + shard) mod n_shards) as int32."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    return ((pos + int(shard)) % n_shards).to(torch.int32)


def round_robin_dest(mask: torch.Tensor, n_shards: int,
                     shard: int) -> torch.Tensor:
    """K25 round robin: the live rows dealt to the shards in row order,
    starting at `shard`."""
    if not _on_cuda(mask):
        return round_robin_dest_plain(mask, n_shards, shard)
    n = int(mask.shape[0])
    _flags_arg(mask, "K25 mask")
    dev = mask.device
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dest
    lib = _load()
    ntiles = -(-n // int(lib.ob_k25_tile_rows()))
    counts = torch.empty(ntiles, dtype=torch.int32, device=dev)
    offs = torch.empty(ntiles, dtype=torch.int64, device=dev)
    totals = torch.empty(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k25_round_robin(mask.data_ptr(), n, int(n_shards),
                                    int(shard), dest.data_ptr(),
                                    counts.data_ptr(), offs.data_ptr(),
                                    totals.data_ptr(), _stream(dev))
        _check(rc, "K25_exchange_pack round robin")
    count_launch(LAUNCHES, "K25_exchange_pack")
    return dest


def exchange_pack_plain(planes, mask: torch.Tensor, dest: torch.Tensor,
                        n_shards: int, cap: int):
    """Plain version of K25's pack (the send half of parallel/
    exchange.py:65 repartition): the live rows stably ordered by dest,
    lane d holding the first cap of dest d's rows in row order. Returns
    (lane planes [n_shards * cap] each, sent mask bool [n_shards * cap],
    overflow int64 0-d = sum of max(count - cap, 0)); dead slots hold
    zeros."""
    n = int(mask.shape[0])
    dev = mask.device
    d = torch.where(mask, dest.to(torch.int64),
                    torch.full((), n_shards, dtype=torch.int64, device=dev))
    order = torch.sort(d, stable=True).indices
    counts = torch.bincount(d, minlength=n_shards + 1)[:n_shards]
    offs = torch.cumsum(counts, 0) - counts
    s = torch.arange(cap, dtype=torch.int64, device=dev)
    pos = (offs[:, None] + s[None, :]).clamp(0, max(n - 1, 0))
    live = (s[None, :] < counts.clamp(max=cap)[:, None]).reshape(-1)
    take = order[pos.reshape(-1)]
    lanes = [torch.where(live.view(-1, *([1] * (p.dim() - 1))), p[take],
                         torch.zeros((), dtype=p.dtype, device=dev))
             for p in planes]
    overflow = torch.clamp(counts - cap, min=0).sum()
    return lanes, live, overflow


def exchange_pack(planes, mask: torch.Tensor, dest: torch.Tensor,
                  n_shards: int, cap: int):
    """K25 pack: lanes of every plane in one pass after the count, scan
    and stable place steps; bit for bit as `exchange_pack_plain`."""
    planes = list(planes)
    if not _on_cuda(mask, dest, *planes):
        return exchange_pack_plain(planes, mask, dest, n_shards, cap)
    n = int(mask.shape[0])
    _flags_arg(mask, "K25 mask")
    _vector(dest, n, "K25 dest")
    if dest.dtype != torch.int32:
        raise TypeError("K25 dest must be int32")
    if not 1 <= n_shards <= _K25_MAX_SHARDS or cap < 1 or n < 1:
        raise ValueError(f"K25 pack: {n_shards} shards, cap {cap}, {n} rows")
    for p in planes:
        _plane(p, "K25 plane")
        if int(p.shape[0]) != n:
            raise ValueError(f"K25 plane of {p.shape[0]} rows, mask {n}")
    dev = mask.device
    lib = _load()
    ntiles = -(-n // int(lib.ob_k25_tile_rows()))
    slots = n_shards * cap
    lanes = [torch.empty((slots, *p.shape[1:]), dtype=p.dtype, device=dev)
             for p in planes]
    sent = torch.empty(slots, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    counts = torch.empty(n_shards * ntiles, dtype=torch.int32, device=dev)
    offs = torch.empty(n_shards * ntiles, dtype=torch.int64, device=dev)
    totals = torch.empty(n_shards, dtype=torch.int64, device=dev)
    take = torch.empty(slots, dtype=torch.int64, device=dev)
    table = _device_table([p.data_ptr() for p in planes]
                          + [q.data_ptr() for q in lanes]
                          + [plane_row_bytes(p) for p in planes], dev) \
        if planes else torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k25_pack(dest.data_ptr(), mask.data_ptr(), n, n_shards,
                             cap, len(planes), table.data_ptr(),
                             sent.data_ptr(), overflow.data_ptr(),
                             counts.data_ptr(), offs.data_ptr(),
                             totals.data_ptr(), take.data_ptr(),
                             _blocks(dev, slots, 256 * 4), _stream(dev))
        _check(rc, "K25_exchange_pack")
    count_launch(LAUNCHES, "K25_exchange_pack")
    return lanes, sent, overflow


def exchange_recv_plain(senders, rows: int, lane: int, outs,
                        out_base: int = 0, mask_plane: int = -1,
                        per_host: int = 0, host_lane: int = 0):
    """Plain version of K26: outs[c][out_base + s * rows + j] =
    senders[c][s][lane * rows + j]; the plane at mask_plane keeps only
    rows r with r % per_host == host_lane when per_host > 0. Writes and
    returns outs."""
    for c, blocks in enumerate(senders):
        for s, b in enumerate(blocks):
            at = out_base + s * rows
            outs[c][at:at + rows] = b[lane * rows:(lane + 1) * rows]
        if c == mask_plane and per_host > 0:
            r = torch.arange(out_base, out_base + len(blocks) * rows,
                             device=outs[c].device)
            seg = outs[c][out_base:out_base + len(blocks) * rows]
            outs[c][out_base:out_base + len(blocks) * rows] = seg & (
                r % per_host == host_lane)
    return outs


K26_CHUNK = 32 * 1024  # bytes a chunk (csrc/k26_exchange_recv.cu)
K26_FIELDS = 5  # entries per segment
K26_INLINE = 160  # table entries in the kernel's parameters


def k26_plan(senders, rows: int, lane: int, outs, out_base: int = 0,
             mask_plane: int = -1, per_host: int = 0):
    """K26's work list: one segment per (plane, sender) with bytes, five
    int64 entries each (the source address, the destination address, the
    bytes, its first chunk, and the destination row of its first byte on
    the striped mask plane, -1 elsewhere), and the number of K26_CHUNK
    chunks in all. Returns (entries, nchunks)."""
    entries, chunk = [], 0
    for c, blocks in enumerate(senders):
        esz = plane_row_bytes(outs[c])
        nb = rows * esz
        if nb == 0:
            continue
        striped = c == mask_plane and per_host > 0
        base = outs[c].data_ptr()
        for s, b in enumerate(blocks):
            at = out_base + s * rows
            entries += [b.data_ptr() + lane * nb, base + at * esz, nb, chunk,
                        at if striped else -1]
            chunk += -(-nb // K26_CHUNK)
    return entries, chunk


def exchange_recv(senders, rows: int, lane: int, outs, out_base: int = 0,
                  mask_plane: int = -1, per_host: int = 0,
                  host_lane: int = 0):
    """K26: a receiver's rows from every sender's block, every plane in
    one launch (modes as `exchange_recv_plain`). senders[c][s] lies on
    the receiver's device."""
    flat = [b for blocks in senders for b in blocks]
    if not _on_cuda(*flat, *outs):
        return exchange_recv_plain(senders, rows, lane, outs, out_base,
                                   mask_plane, per_host, host_lane)
    np_ = len(senders)
    nsend = len(senders[0]) if np_ else 0
    if np_ < 1 or nsend < 1 or any(len(b) != nsend for b in senders):
        raise ValueError("K26 takes at least one plane, the same senders "
                         "for every plane")
    if rows < 0 or lane < 0 or out_base < 0:
        raise ValueError("K26 rows, lane and out_base are not negative")
    for c, blocks in enumerate(senders):
        _plane(outs[c], "K26 out")
        if int(outs[c].shape[0]) < out_base + nsend * rows:
            raise ValueError("K26 out plane too short")
        for b in blocks:
            _plane(b, "K26 sender block")
            if b.dtype != outs[c].dtype or b.shape[1:] != outs[c].shape[1:]:
                raise TypeError("K26 sender and out types differ")
            if int(b.shape[0]) < (lane + 1) * rows:
                raise ValueError("K26 sender block too short for its lane")
    if mask_plane >= 0 and outs[mask_plane].dtype != torch.bool:
        raise TypeError("K26 mask plane must be bool")
    entries, nchunks = k26_plan(senders, rows, lane, outs, out_base,
                                mask_plane, per_host)
    if nchunks == 0:
        return outs
    dev = outs[0].device
    lib = _load()
    inline, table = param_table(entries, K26_INLINE, dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k26_recv(len(entries) // K26_FIELDS, inline,
                             table.data_ptr() if table is not None else None,
                             nchunks, int(per_host), int(host_lane),
                             _stream(dev))
        _check(rc, "K26_exchange_recv")
    count_launch(LAUNCHES, "K26_exchange_recv")
    return outs


def shard_merge_plain(planes, ops):
    """Plain version of K27: each plane's shard tensors folded left in
    shard order: "sum" (integers wrap), "min" / "max" (NaN propagates),
    "or" (any non-zero, a bool plane)."""
    out = []
    for shards, op in zip(planes, ops):
        if op == "or":
            acc = shards[0] != 0
            for x in shards[1:]:
                acc = acc | (x != 0)
        else:
            acc = shards[0].clone()
            for x in shards[1:]:
                if op == "sum":
                    acc = acc + x
                elif op == "min":
                    acc = torch.minimum(acc, x)
                elif op == "max":
                    acc = torch.maximum(acc, x)
                else:
                    raise ValueError(f"unknown K27 op {op!r}")
        out.append(acc)
    return out


def shard_merge(planes, ops):
    """K27: every plane merged over the shards in one launch, bit for bit
    as `shard_merge_plain` (floats added in shard order in their own
    type). planes[c][s] is shard s's partial of plane c, all on one
    device."""
    planes = [list(p) for p in planes]
    ops = list(ops)
    flat = [x for p in planes for x in p]
    if not _on_cuda(*flat):
        return shard_merge_plain(planes, ops)
    nsh = len(planes[0]) if planes else 0
    if not planes or nsh < 1 or any(len(p) != nsh for p in planes):
        raise ValueError("K27 takes the same shards for every plane")
    dev = flat[0].device
    outs = []
    for p, op in zip(planes, ops):
        if op not in _K27_OP:
            raise ValueError(f"unknown K27 op {op!r}")
        n = int(p[0].reshape(-1).shape[0])
        for x in p:
            if x.dtype != p[0].dtype or x.numel() != n or \
                    not x.is_contiguous():
                raise ValueError("K27 shards of a plane differ in type, "
                                 "size or layout")
        outs.append(torch.empty(p[0].shape, device=dev,
                                dtype=torch.bool if op == "or"
                                else p[0].dtype))
    lib = _load()
    table = _device_table(
        [x.data_ptr() for x in flat] + [o.data_ptr() for o in outs]
        + [DTYPE_CODE[p[0].dtype] for p in planes]
        + [_K27_OP[op] for op in ops]
        + [int(p[0].numel()) for p in planes], dev)
    longest = max(int(p[0].numel()) for p in planes)
    with torch.cuda.device(dev):
        rc = lib.ob_k27_merge(len(planes), nsh, table.data_ptr(),
                              _blocks(dev, longest, 256 * 4),
                              min(len(planes), 65535), _stream(dev))
        _check(rc, "K27_shard_merge")
    count_launch(LAUNCHES, "K27_shard_merge")
    return outs


def _floor_div64(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def range_step_plain(minmax: torch.Tensor, resolution: int) -> torch.Tensor:
    """The equal-width bucket step over the merged span [kmin, kmax]
    (parallel/exchange.py:196-199), in wrapping int64."""
    span = torch.clamp(minmax[1] - minmax[0] + 1, min=1)
    return torch.clamp(_floor_div64(span + (resolution - 1), resolution),
                       min=1)


def range_histogram_plain(key: torch.Tensor, mask: torch.Tensor,
                          minmax: torch.Tensor, resolution: int):
    """Plain version of K28's range histogram: int64 [resolution] live
    rows per bucket clip((k - kmin) // step, 0, resolution - 1)."""
    step = range_step_plain(minmax, resolution)
    b = torch.clamp(_floor_div64(key.to(torch.int64) - minmax[0], step), 0,
                    resolution - 1)
    b = torch.where(mask, b, torch.full_like(b, resolution))
    return torch.bincount(b, minlength=resolution + 1)[:resolution]


def hash_histogram_plain(keys, mask: torch.Tensor, resolution: int):
    """Plain version of K28's hash buckets (parallel/px.py:579-583): int64
    [resolution] live rows per hash32_combine(keys) % resolution."""
    h = hash32_combine_plain(list(keys)) % resolution
    h = torch.where(mask, h, torch.full_like(h, resolution))
    return torch.bincount(h, minlength=resolution + 1)[:resolution]


def bloom_bits_plain(keys, mask: torch.Tensor, m: int):
    """Plain version of K28's bloom bitset (parallel/px.py:612-615): int32
    [m], 1 at hash32_combine(keys) % m of every live row."""
    h = hash32_combine_plain(list(keys)) % m
    bits = torch.zeros(m + 1, dtype=torch.int32, device=mask.device)
    bits[torch.where(mask, h, torch.full_like(h, m))] = 1
    return bits[:m]


def range_bounds_plain(hist: torch.Tensor, minmax: torch.Tensor,
                       n_shards: int) -> torch.Tensor:
    """Plain version of K28's bounds (parallel/exchange.py:205-214): int64
    [n_shards - 1] from the merged histogram and span."""
    res = int(hist.shape[0])
    step = range_step_plain(minmax, res)
    cdf = torch.cumsum(hist, 0)
    total = cdf[-1]
    targets = _floor_div64(
        torch.arange(1, n_shards, dtype=torch.int64, device=hist.device)
        * total, n_shards)
    idx = torch.searchsorted(cdf, targets, right=False)
    return minmax[0] + (idx + 1) * step


def hot_buckets_plain(cnt_a: torch.Tensor, cnt_b, n_shards: int):
    """Plain version of K28's hot test (parallel/px.py:585-590): bool
    [resolution], a bucket hot on either side when its merged count
    exceeds max(2 * total // n_shards, 1)."""
    def hot(c):
        lim = torch.clamp(_floor_div64(c.sum() * 2, n_shards), min=1)
        return c > lim

    return hot(cnt_a) | hot(cnt_b) if cnt_b is not None else hot(cnt_a)


def bucket_probe_plain(keys, mask: torch.Tensor, table: torch.Tensor):
    """Plain version of K28's probe: mask & table[hash32_combine(keys) %
    len(table)] (the bloom prefilter px.py:623, the popular rows :593)."""
    m = int(table.shape[0])
    h = hash32_combine_plain(list(keys)) % m
    return mask & (table[h] != 0)


def _k28_hist(mode: str, keys, mask, minmax, res: int, out):
    n = int(mask.shape[0])
    _flags_arg(mask, "K28 mask")
    dev = mask.device
    table = _key_table(keys, n, "K28 key", dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k28_hist(_K28_MODE[mode], len(keys), table.data_ptr(),
                             mask.data_ptr(), n,
                             minmax.data_ptr() if minmax is not None
                             else None, int(res), out.data_ptr(),
                             _blocks(dev, n, 256 * 4), _stream(dev))
        _check(rc, "K28_bucket_hist")
    count_launch(LAUNCHES, "K28_bucket_hist")
    return out


def range_histogram(key, mask, minmax, resolution: int):
    """K28 range histogram (as `range_histogram_plain`); minmax is the
    merged int64 [2] span on the card."""
    if not _on_cuda(key, mask, minmax):
        return range_histogram_plain(key, mask, minmax, resolution)
    if key.dtype.is_floating_point:
        raise TypeError("K28 range keys must be integers")
    if minmax.dtype != torch.int64 or minmax.shape != (2,):
        raise TypeError("K28 minmax must be int64 [2]")
    out = torch.zeros(resolution, dtype=torch.int64, device=key.device)
    return _k28_hist("range", [key], mask, minmax.contiguous(), resolution,
                     out)


def hash_histogram(keys, mask, resolution: int):
    """K28 hash buckets (as `hash_histogram_plain`)."""
    keys = list(keys)
    if not _on_cuda(mask, *keys):
        return hash_histogram_plain(keys, mask, resolution)
    out = torch.zeros(resolution, dtype=torch.int64, device=mask.device)
    return _k28_hist("count", keys, mask, None, resolution, out)


def bloom_bits(keys, mask, m: int):
    """K28 bloom bitset (as `bloom_bits_plain`)."""
    keys = list(keys)
    if not _on_cuda(mask, *keys):
        return bloom_bits_plain(keys, mask, m)
    out = torch.zeros(m, dtype=torch.int32, device=mask.device)
    return _k28_hist("bits", keys, mask, None, m, out)


def range_bounds(hist, minmax, n_shards: int):
    """K28 bounds (as `range_bounds_plain`), one block."""
    if not _on_cuda(hist, minmax):
        return range_bounds_plain(hist, minmax, n_shards)
    res = int(hist.shape[0])
    if hist.dtype != torch.int64 or not 1 <= res <= 4096:
        raise ValueError("K28 bounds take an int64 histogram of <= 4096")
    dev = hist.device
    out = torch.empty(max(n_shards - 1, 0), dtype=torch.int64, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k28_bounds(hist.contiguous().data_ptr(), res,
                               minmax.contiguous().data_ptr(), int(n_shards),
                               out.data_ptr(), _stream(dev))
        _check(rc, "K28_bucket_hist bounds")
    count_launch(LAUNCHES, "K28_bucket_hist")
    return out


def hot_buckets(cnt_a, cnt_b, n_shards: int):
    """K28 hot test (as `hot_buckets_plain`), one block."""
    if not _on_cuda(cnt_a, cnt_b):
        return hot_buckets_plain(cnt_a, cnt_b, n_shards)
    res = int(cnt_a.shape[0])
    dev = cnt_a.device
    out = torch.empty(res, dtype=torch.bool, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k28_hot(cnt_a.contiguous().data_ptr(),
                            cnt_b.contiguous().data_ptr()
                            if cnt_b is not None else None, res,
                            int(n_shards), out.data_ptr(), _stream(dev))
        _check(rc, "K28_bucket_hist hot")
    count_launch(LAUNCHES, "K28_bucket_hist")
    return out


def bucket_probe(keys, mask, table):
    """K28 probe (as `bucket_probe_plain`): table is bool [m]."""
    keys = list(keys)
    if not _on_cuda(mask, table, *keys):
        return bucket_probe_plain(keys, mask, table)
    n = int(mask.shape[0])
    _flags_arg(mask, "K28 mask")
    if table.dtype != torch.bool:
        raise TypeError("K28 probe table must be bool")
    dev = mask.device
    ktab = _key_table(keys, n, "K28 key", dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k28_probe(len(keys), ktab.data_ptr(), mask.data_ptr(), n,
                              table.contiguous().data_ptr(),
                              int(table.shape[0]), out.data_ptr(),
                              _blocks(dev, n, 256 * 4), _stream(dev))
        _check(rc, "K28_bucket_hist probe")
    count_launch(LAUNCHES, "K28_bucket_hist")
    return out


# ---------------------------------------------------------------------------
# K29: the general hash group-by (slot assignment + per-slot aggregates)
# ---------------------------------------------------------------------------

K29_MAX_AGGS = 16
_K29_ACC = {torch.int64: 0, torch.float32: 1, torch.float64: 2}


def _k29_out_dtype(op: str, v) -> torch.dtype:
    """The reference's _apply_agg output type: count and integer sums in
    int64, float sums and min/max in the value's own type."""
    if op == "count":
        return torch.int64
    if op == "sum":
        return v.dtype if v.dtype.is_floating_point else torch.int64
    if op in ("min", "max"):
        if v.dtype == torch.bool:
            raise TypeError(f"{op} of a bool column has no identity")
        return v.dtype
    raise NotImplementedError(op)


def _k29_key_dtype(dtype: torch.dtype) -> torch.dtype:
    """A group key column's output type: jnp.where(used, key, 0) keeps the
    key's type but promotes bool to int64."""
    return torch.int64 if dtype == torch.bool else dtype


def slot_aggregate_plain(row_slot, mask: torch.Tensor, aggs,
                         table_size: int):
    """Plain version of K29's aggregate pass (ops/hashagg.py _apply_agg):
    each live row's values scattered into its slot. A dead row drops; a
    negative slot wraps to slot + T, as JAX's scatter normalizes the index
    (so a live row left with slot -1 lands in T - 1)."""
    ts = int(table_size)
    idx = torch.where(mask, row_slot.to(torch.int64), ts)
    idx = torch.where(idx < 0, idx + ts, idx)
    idx = torch.where((idx < 0) | (idx > ts), ts, idx)
    out = []
    for op, v in aggs:
        dt = _k29_out_dtype(op, v)
        if op == "count":
            acc = torch.zeros(ts + 1, dtype=dt, device=mask.device)
            acc.index_add_(0, idx, torch.ones_like(idx))
        elif op == "sum":
            acc = torch.zeros(ts + 1, dtype=dt, device=mask.device)
            acc.index_add_(0, idx, v.to(dt))
        else:
            acc = torch.full((ts + 1,), _identity(op, dt), dtype=dt,
                             device=mask.device)
            acc.scatter_reduce_(0, idx, v, "amin" if op == "min" else "amax")
        out.append(acc[:ts].clone())
    return out


def hash_groupby_plain(key_cols, mask: torch.Tensor, aggs, table_size: int):
    """Plain version of K29 (ops/hashagg.py groupby_hash over
    assign_group_slots and _apply_agg), the reference's lockstep schedule:
    (row_slot [N] int32, slot_row [T] int32, slot_used [T] bool, the key
    columns at each used slot's row (0 elsewhere), the aggregates [T])."""
    cols = list(key_cols)
    _tag, slot_row, row_slot = _lockstep_slots(cols, mask, table_size)
    slot_used = slot_row >= 0
    rep = slot_row.to(torch.int64).clamp(0, max(int(cols[0].shape[0]) - 1, 0))
    keys = []
    for c in cols:
        g = c[rep].to(_k29_key_dtype(c.dtype))
        keys.append(torch.where(slot_used, g, torch.zeros_like(g)))
    return (row_slot, slot_row, slot_used, keys,
            slot_aggregate_plain(row_slot, mask, aggs, table_size))


def _k29_aggs(aggs, n: int, ts: int, dev):
    """ctypes arrays of one launch's aggregate specs (at most
    K29_MAX_AGGS) and their output tensors."""
    aggs = list(aggs)
    if len(aggs) > K29_MAX_AGGS:
        raise ValueError(f"one K29 launch takes at most {K29_MAX_AGGS} "
                         "aggregates")
    ops, vdts, kinds, odts, vals, accs, outs = ([] for _ in range(7))
    results, keep = [], []
    for op, v in aggs:
        if op not in AGG_CODE:
            raise NotImplementedError(op)
        dt = _k29_out_dtype(op, v)
        if op != "count":
            _vector(v, n, "K29 values")
            if v.device != dev:
                raise ValueError("K29 values lie on another device")
        acc_dt = dt if dt in _K29_ACC else torch.int64
        acc = torch.empty(ts, dtype=acc_dt, device=dev)
        out = acc if acc_dt == dt else torch.empty(ts, dtype=dt, device=dev)
        keep.append(acc)
        results.append(out)
        ops.append(AGG_CODE[op])
        vdts.append(DTYPE_CODE[v.dtype] if op != "count" else 0)
        kinds.append(_K29_ACC[acc_dt])
        odts.append(-1 if out is acc else DTYPE_CODE[dt])
        vals.append(v.data_ptr() if op != "count" else None)
        accs.append(acc.data_ptr())
        outs.append(out.data_ptr() if out is not acc else None)
    k = max(len(aggs), 1)
    ia = ctypes.c_int * k
    pa = ctypes.c_void_p * k
    args = (len(aggs), ia(*ops), ia(*vdts), ia(*kinds), ia(*odts),
            pa(*vals), pa(*accs), pa(*outs))
    return args, results, keep


def _k29_launch(lib, dev, keys, mask, n: int, ts: int, agg_args, row_slot,
                slot_row, slot_used, key_out, what: str) -> None:
    table = (_device_table([c.data_ptr() for c in keys]
                           + [DTYPE_CODE[c.dtype] for c in keys]
                           + [o.data_ptr() for o in key_out], dev)
             if keys else None)
    with torch.cuda.device(dev):
        rc = lib.ob_k29_groupby(
            len(keys), table.data_ptr() if table is not None else None,
            mask.data_ptr(), n, ts, *agg_args,
            row_slot.data_ptr(),
            slot_row.data_ptr() if slot_row is not None else None,
            slot_used.data_ptr() if slot_used is not None else None,
            _blocks(dev, n, 256 * 4), _blocks(dev, ts, 256 * 4),
            _stream(dev))
        _check(rc, what)
    count_launch(LAUNCHES, "K29_hash_groupby")


def agg_groups(aggs, size: int) -> list:
    """`aggs` in groups of at most `size`, in order (at least one group):
    the launches of a kernel whose aggregates ride a by-value table."""
    aggs = list(aggs)
    return [aggs[i:i + size] for i in range(0, max(len(aggs), 1), size)]


def _k29_table(ts: int) -> int:
    ts = int(ts)
    if ts < 1 or ts & (ts - 1) or ts >= 2**31:
        raise ValueError(f"K29 needs a power-of-two table, got {ts}")
    return ts


def hash_groupby(key_cols, mask: torch.Tensor, aggs, table_size: int):
    """K29: the hash group-by of the live rows' key tuples into a table of
    `table_size` (a power of two) slots, in one launch (and one of the
    aggregate-only entry per 16 aggregates past the first 16). aggs:
    (op, values) pairs (values None for count). Returns (row_slot, slot_row, slot_used,
    keys, aggregates) as `hash_groupby_plain`; which key sits in which
    slot depends on the schedule, the groups and their aggregates do
    not."""
    cols = list(key_cols)
    aggs = list(aggs)
    vals = [v for op, v in aggs if op != "count"]
    if not _on_cuda(mask, *cols, *vals):
        return hash_groupby_plain(cols, mask, aggs, table_size)
    n = _flags_arg(mask, "K29 sel")
    if not cols:
        raise ValueError("K29 takes at least one key column")
    for c in cols:
        _vector(c, n, "K29 key")
    if n >= 2**31:
        raise ValueError("K29 numbers at most 2^31 - 1 rows")
    ts = _k29_table(table_size)
    dev = mask.device
    first, *rest = agg_groups(aggs, K29_MAX_AGGS)
    agg_args, results, _keep = _k29_aggs(first, n, ts, dev)
    row_slot = torch.empty(n, dtype=torch.int32, device=dev)
    slot_row = torch.empty(ts, dtype=torch.int32, device=dev)
    slot_used = torch.empty(ts, dtype=torch.bool, device=dev)
    keys = [torch.empty(ts, dtype=_k29_key_dtype(c.dtype), device=dev)
            for c in cols]
    _k29_launch(_load(), dev, cols, mask, n, ts, agg_args, row_slot,
                slot_row, slot_used, keys, "K29_hash_groupby")
    # the aggregates past the first 16: the aggregate-only entry over the
    # slots just assigned (the slot pass runs once)
    for group in rest:
        results += slot_aggregate(row_slot, mask, group, ts)
    return row_slot, slot_row, slot_used, keys, results


def slot_aggregate(row_slot, mask: torch.Tensor, aggs, table_size: int):
    """K29's aggregate pass alone over given slots (ops/hashagg.py
    _apply_agg): the aggregates [T] as `slot_aggregate_plain`."""
    aggs = list(aggs)
    vals = [v for op, v in aggs if op != "count"]
    if not _on_cuda(row_slot, mask, *vals):
        return slot_aggregate_plain(row_slot, mask, aggs, table_size)
    n = _flags_arg(mask, "K29 sel")
    _vector(row_slot, n, "K29 row slots")
    if row_slot.dtype != torch.int32:
        raise TypeError("K29 row slots are int32")
    ts = _k29_table(table_size)
    dev = mask.device
    results = []
    for group in agg_groups(aggs, K29_MAX_AGGS):
        agg_args, res, _keep = _k29_aggs(group, n, ts, dev)
        _k29_launch(_load(), dev, [], mask, n, ts, agg_args, row_slot, None,
                    None, [], "K29_hash_groupby aggregate")
        results += res
    return results


# ---------------------------------------------------------------------------
# K30: the matched product sum of a unique-build join
# ---------------------------------------------------------------------------


def join_product_sum_plain(lv: torch.Tensor, rv: torch.Tensor,
                           match: torch.Tensor):
    """Plain version of K30 (ops/spill.py _device_join_sum after its
    probe): (sum of lv[i] * rv[match[i]] over match[i] >= 0, their
    count), int64 0-d tensors, wrapping as int64 arithmetic does."""
    hit = match >= 0
    idx = match.to(torch.int64).clamp(min=0)
    if rv.shape[0] == 0:
        prod = torch.zeros(lv.shape[0], dtype=torch.int64, device=lv.device)
    else:
        prod = lv.to(torch.int64) * rv.to(torch.int64)[idx]
    prod = torch.where(hit, prod, torch.zeros_like(prod))
    return prod.sum(), hit.sum(dtype=torch.int64)


def join_product_sum(lv: torch.Tensor, rv: torch.Tensor,
                     match: torch.Tensor):
    """K30: (sum of lv[i] * rv[match[i]] where match[i] >= 0, count), int64
    0-d tensors, in one pass."""
    if not _on_cuda(lv, rv, match):
        return join_product_sum_plain(lv, rv, match)
    n = int(match.shape[0])
    _vector(lv, n, "K30 probe values")
    _vector(match, n, "K30 match")
    _vector(rv, int(rv.shape[0]), "K30 build values")
    if match.dtype != torch.int32:
        raise TypeError("K30 match rows are int32")
    if lv.dtype.is_floating_point or rv.dtype.is_floating_point:
        raise TypeError("K30 multiplies integer values")
    dev = match.device
    out = torch.empty(2, dtype=torch.int64, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.ob_k30_product_sum(
            lv.data_ptr(), DTYPE_CODE[lv.dtype], rv.data_ptr(),
            DTYPE_CODE[rv.dtype], match.data_ptr(), n, out.data_ptr(),
            _blocks(dev, n, 256 * 8), _stream(dev))
        _check(rc, "K30_join_product_sum")
    count_launch(LAUNCHES, "K30_join_product_sum")
    return out[0], out[1]


# ---------------------------------------------------------------------------
# K31: the mesh-sharded IVF probe (parallel/ann.py)
# ---------------------------------------------------------------------------

_k31_consts = None


def _ann_top(dist: torch.Tensor, kk: int) -> torch.Tensor:
    """lax.top_k(-dist, kk)'s indices: the smaller distance first, the
    lower index on ties."""
    return torch.sort(dist, stable=True).indices[:kk]


def ann_rerank_plain(xs, lo: int, offs, lens, probes, q, max_list: int,
                     kk: int):
    """Plain version of K31's re-rank (oceanbase_tpu/parallel/ann.py
    :101-116): candidate c = p * max_list + j has window position pos =
    offs[probes[p]] + j; it is mine when j < lens[probes[p]] and pos lies
    in the block [lo, lo + rps); dist = |x|^2 - 2 x.q of the block's row
    pos - lo, +inf where not mine; the kk smallest in lax.top_k's order.
    Returns (float32 [kk] dist, int32 [kk] pos)."""
    rps = int(xs.shape[0])
    pr = probes.long()
    starts = offs[pr].to(torch.int64)
    ll = lens[pr].to(torch.int64)
    j = torch.arange(max_list, dtype=torch.int64, device=xs.device)
    pos = (starts[:, None] + j[None, :]).reshape(-1)
    valid = (j[None, :] < ll[:, None]).reshape(-1)
    mine = valid & (pos >= lo) & (pos < lo + rps)
    xv = xs[torch.clamp(pos - lo, 0, max(rps - 1, 0))]
    dist = torch.sum(xv * xv, dim=1) - 2.0 * (xv @ q)
    dist = torch.where(mine, dist, torch.full_like(dist, float("inf")))
    top = _ann_top(dist, kk)
    return dist[top], pos[top].to(torch.int32)


def ann_merge_plain(gd: torch.Tensor, gp: torch.Tensor, kk: int):
    """Plain version of K31's merge (ann.py:119-121): the kk smallest of
    the gathered distances, ties to the lower gathered index. Returns
    (dist, pos)."""
    top = _ann_top(gd, kk)
    return gd[top], gp[top]


def _k31_scratch(dev, cand: int, kk: int):
    """(nblocks, partial, gruns) of one K31 launch pair: runs past
    `ob_k31_smem_k` keys lie in device memory."""
    global _k31_consts
    lib = _load()
    if _k31_consts is None:
        _k31_consts = (int(lib.ob_k31_tile()), int(lib.ob_k31_smem_k()))
    tile, smem_k = _k31_consts
    nblocks = max(1, min(-(-cand // tile), 2 * _sm_count(dev)))
    partial = torch.empty(nblocks * kk, dtype=torch.int64, device=dev)
    gruns = (torch.empty((nblocks + 1) * 2 * kk, dtype=torch.int64,
                         device=dev) if kk > smem_k else None)
    return lib, nblocks, partial, gruns


def ann_rerank(xs, lo: int, offs, lens, probes, q, max_list: int, kk: int):
    """K31's re-rank: one shard's (dist, pos) strip of kk, as
    `ann_rerank_plain`. xs: the shard's (rps, d) float32 block; offs,
    lens: the index's int32 [L]; probes: int32 [nprobe] (K21); q: float32
    [d]; kk <= nprobe * max_list."""
    if not _on_cuda(xs, offs, lens, probes, q):
        return ann_rerank_plain(xs, lo, offs, lens, probes, q, max_list, kk)
    _matrix(xs, "K31 block")
    rps, d = int(xs.shape[0]), int(xs.shape[1])
    nl = int(offs.shape[0])
    _vector(offs, nl, "K31 offsets")
    _vector(lens, nl, "K31 lengths")
    nprobe = int(probes.shape[0])
    _vector(probes, nprobe, "K31 probes")
    _vector(q, d, "K31 query")
    if q.dtype != torch.float32:
        raise TypeError("K31 takes a float32 query")
    for t, what in ((offs, "offsets"), (lens, "lengths"),
                    (probes, "probes")):
        if t.dtype != torch.int32:
            raise TypeError(f"K31 {what} must be int32")
    cand = nprobe * int(max_list)
    if not 1 <= kk <= cand or cand >= 2**32 or rps < 1 or lo < 0:
        raise ValueError(f"K31 selects 1..{cand} of {cand} candidates, got "
                         f"{kk} (rps {rps}, lo {lo})")
    dev = xs.device
    lib, nblocks, partial, gruns = _k31_scratch(dev, cand, kk)
    dist = torch.empty(kk, dtype=torch.float32, device=dev)
    pos = torch.empty(kk, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ob_k31_rerank(
            xs.data_ptr(), rps, d, int(lo), offs.data_ptr(), lens.data_ptr(),
            probes.data_ptr(), nprobe, int(max_list), q.data_ptr(), int(kk),
            nblocks, partial.data_ptr(),
            gruns.data_ptr() if gruns is not None else None,
            dist.data_ptr(), pos.data_ptr(), _stream(dev))
        _check(rc, "K31_shard_ivf rerank")
    count_launch(LAUNCHES, "K31_shard_ivf")
    return dist, pos


K31_MERGE_ONE = 1024  # gathered pairs of the one-launch merge (csrc)


def ann_merge(gd: torch.Tensor, gp: torch.Tensor, kk: int):
    """K31's merge: the kk smallest of the gathered strips' distances (ties
    to the lower gathered index) and their positions, as
    `ann_merge_plain`. Up to K31_MERGE_ONE pairs it is one launch that
    allocates only its outputs; past that, two launches. Its host work is
    kept to the checks and the launch: the call is a few microseconds of
    device work. Counts as a K31 launch."""
    if gd.device.type != "cuda" or gp.device.type != "cuda":
        _on_cuda(gd, gp)  # raises on a mix
        return ann_merge_plain(gd, gp, kk)
    m = gd.shape[0]
    if (gd.dim() != 1 or gp.shape != gd.shape or gd.device != gp.device
            or not (gd.is_contiguous() and gp.is_contiguous())):
        raise ValueError("K31 merges two contiguous 1-D strips of one "
                         "length on one device")
    if gd.dtype != torch.float32 or gp.dtype != torch.int32:
        raise TypeError("K31 merges float32 distances and int32 positions")
    if not 1 <= kk <= m or m >= 2**32:
        raise ValueError(f"K31 merges 1..{m} of {m} gathered rows, got {kk}")
    dev = gd.device
    dist = torch.empty(kk, dtype=torch.float32, device=dev)
    pos = torch.empty(kk, dtype=torch.int32, device=dev)
    lib = _lib if _lib is not None else _load()
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        if m <= K31_MERGE_ONE:
            rc = lib.ob_k31_merge_one(
                gd.data_ptr(), gp.data_ptr(), m, int(kk), dist.data_ptr(),
                pos.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
        else:
            lib, nblocks, partial, gruns = _k31_scratch(dev, m, kk)
            rc = lib.ob_k31_merge(
                gd.data_ptr(), gp.data_ptr(), m, int(kk), nblocks,
                partial.data_ptr(),
                gruns.data_ptr() if gruns is not None else None,
                dist.data_ptr(), pos.data_ptr(), _stream(dev))
    _check(rc, "K31_shard_ivf merge")
    with _COUNT_LOCK:
        LAUNCHES["K31_shard_ivf"] += 1
        ENTRY_LAUNCHES["K31_shard_ivf.merge"] += 1
    return dist, pos
