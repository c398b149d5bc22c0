#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Builds the port's CUDA kernels from `oceanbase_tpu_torch/csrc`, generates
TPC-H at SF 10 (seed 19920101), and drives the port's main path through
`Session(..., device="cuda").sql(...)`: Q1, Q6, the sorted selective scan
S1 and S1 again with a rebound date literal, the join statements Q14, Q3,
Q10, Q7, Q8 and Q19, a tie-heavy ORDER BY ... LIMIT (T1, whose top-k
prefilter overflows and re-runs through the full sort), and the other 14
TPC-H queries (merge joins, expansion joins, semi/anti/left joins,
DISTINCT), each once cold and `--warm` times warm, then once more under
torch.profiler for its device busy time. The results with an int64 numpy
oracle (Q1, Q6, S1, Q14, Q3, Q10, Q7, Q8, Q19, T1, Q4, Q11, Q12, Q13,
Q20) must equal it exactly (a ratio to rel 1e-12), the others must be
non-empty and finite (Q11 runs with TPC-H's FRACTION for the scale,
0.0001 / SF), and every kernel on a statement's path must have launched during
its runs. Then each kernel is called at the main path's shapes (the
arguments of the join kernels are captured from one more run of Q17,
Q21, Q13, Q9 and Q16) and held against its plain PyTorch version (exact
agreement, and the same bits on two runs), and timed beside the plain
version, a one-call PyTorch yardstick and its memory-bandwidth bound.
Last, all 22 queries run on the card at SF 0.01 against sqlite, and every
statement runs on the card and on the CPU at SF 0.1, where the two
results must hold the same bits.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py            # SF 10, 5 warm runs per statement
    python3 chip_smoke.py --sf 1     # a smaller, faster check

Prints the card's name and power limit, the build time, one line per
statement and per kernel, a JSON line {"kernels": [...]}, and as its last
line {"ok": true, "device": {...}}. Exits non-zero on any failure, and
when no CUDA device is present. Details (per-run times, the nvcc log)
go to the JSON file named by --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

S1 = """select l_orderkey, l_linenumber, l_extendedprice, l_shipdate
from lineitem
where l_shipdate = date '{day}' and l_quantity < 10
order by l_extendedprice desc, l_orderkey, l_linenumber"""
S1_DAYS = ("1995-06-17", "1996-02-29")

T1 = """select l_orderkey, l_linenumber, l_quantity from lineitem
order by l_quantity desc limit 5"""


def q11_fraction(sf: float) -> str:
    """Q11's FRACTION for a scale factor: 0.0001 / SF (TPC-H 2.4.11.3);
    the suite's text carries the SF 1 value."""
    from decimal import Decimal

    return str(Decimal("0.0001") / Decimal(repr(sf)))


def statement_text(queries_text, q: int, sf: float) -> str:
    text = queries_text[q]
    if q == 11:
        text = text.replace("* 0.0001", f"* {q11_fraction(sf)}")
    return text

CMP_SF = 0.1  # the scale at which card and CPU results are compared
SQLITE_SF = 0.01  # the scale of the sqlite oracle (its Q20/Q21 are quadratic)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12    # H100 SXM non-tensor FP32 rate, as the op rate

KERNEL_META = {
    "K1_scalar_aggregate": (
        "oceanbase_tpu_torch/csrc/k1_scalar_aggregate.cu",
        "oceanbase_tpu/ops/hashagg.py:384"),
    "K2_groupby_direct": (
        "oceanbase_tpu_torch/csrc/k2_groupby_direct.cu",
        "oceanbase_tpu/ops/hashagg.py:181"),
    "K3_radix_sort": (
        "oceanbase_tpu_torch/csrc/k3_radix_sort.cu",
        "oceanbase_tpu/ops/sort.py:57"),
    "K4_gather_rows": (
        "oceanbase_tpu_torch/csrc/k4_gather_rows.cu",
        "oceanbase_tpu/ops/gather.py:54"),
    "K5_affine_join": (
        "oceanbase_tpu_torch/csrc/k5_affine_join.cu",
        "oceanbase_tpu/engine/executor.py:4227"),
    "K6_clustered_agg": (
        "oceanbase_tpu_torch/csrc/k6_clustered_agg.cu",
        "oceanbase_tpu/engine/executor.py:1779"),
    "K7_topk_candidates": (
        "oceanbase_tpu_torch/csrc/k7_topk_candidates.cu",
        "oceanbase_tpu/engine/executor.py:2095"),
    "K8_segmented_reduce": (
        "oceanbase_tpu_torch/csrc/k8_segmented_reduce.cu",
        "oceanbase_tpu/ops/hashagg.py:271"),
    "K9_merge_join": (
        "oceanbase_tpu_torch/csrc/k9_merge_join.cu",
        "oceanbase_tpu/ops/join.py:120"),
    "K10_expand_join": (
        "oceanbase_tpu_torch/csrc/k10_expand_join.cu",
        "oceanbase_tpu/ops/join.py:177"),
    "K11_probe_run_any": (
        "oceanbase_tpu_torch/csrc/k11_probe_run_any.cu",
        "oceanbase_tpu/ops/join.py:228"),
    "K12_hash_combine": (
        "oceanbase_tpu_torch/csrc/k12_hash_combine.cu",
        "oceanbase_tpu/ops/hashing.py:40"),
    # a second entry of K5 (its launches count as K5's too)
    "K5_affine_join.probe": (
        "oceanbase_tpu_torch/csrc/k5_affine_join.cu",
        "oceanbase_tpu/engine/executor.py:4240"),
    # not a kernel of its own: the Distinct operator on K3 + K4
    "dedup_batch": (
        "oceanbase_tpu_torch/engine/executor.py",
        "oceanbase_tpu/engine/executor.py:2606"),
}

# the entries of the {"kernels": ...} line: K1-K12 and K5's probe entry
KERNEL_LINE = [k for k in KERNEL_META if k != "dedup_batch"]

# the TPC-H queries run through the merge, expansion, semi/anti/left
# joins and DISTINCT, by query number
NEW_QUERIES = (2, 4, 5, 9, 11, 12, 13, 15, 16, 17, 18, 20, 21, 22)

# kernels each statement's path must launch
PATH_KERNELS = {
    "Q1": ("K2_groupby_direct", "K3_radix_sort", "K4_gather_rows"),
    "Q6": ("K1_scalar_aggregate",),
    "S1": ("K3_radix_sort", "K4_gather_rows"),
    "S1_rebound": ("K3_radix_sort", "K4_gather_rows"),
    "Q14": ("K5_affine_join", "K1_scalar_aggregate"),
    "Q3": ("K5_affine_join", "K6_clustered_agg", "K7_topk_candidates",
           "K3_radix_sort", "K4_gather_rows"),
    "Q10": ("K5_affine_join", "K3_radix_sort", "K8_segmented_reduce",
            "K7_topk_candidates"),
    "Q7": ("K5_affine_join", "K3_radix_sort", "K8_segmented_reduce"),
    "Q8": ("K5_affine_join", "K3_radix_sort", "K8_segmented_reduce"),
    "Q19": ("K5_affine_join", "K1_scalar_aggregate"),
    "T1": ("K7_topk_candidates", "K3_radix_sort", "K4_gather_rows"),
    "Q2": ("K9_merge_join", "K5_affine_join", "K3_radix_sort",
           "K4_gather_rows", "K8_segmented_reduce", "K7_topk_candidates"),
    "Q4": ("K10_expand_join", "K3_radix_sort", "K4_gather_rows",
           "K2_groupby_direct"),
    "Q5": ("K10_expand_join", "K12_hash_combine", "K5_affine_join",
           "K3_radix_sort", "K4_gather_rows", "K2_groupby_direct"),
    "Q9": ("K10_expand_join", "K12_hash_combine", "K5_affine_join",
           "K3_radix_sort", "K4_gather_rows", "K8_segmented_reduce"),
    "Q11": ("K9_merge_join", "K5_affine_join", "K3_radix_sort",
            "K4_gather_rows", "K8_segmented_reduce", "K1_scalar_aggregate"),
    "Q12": ("K10_expand_join", "K3_radix_sort", "K4_gather_rows",
            "K2_groupby_direct"),
    "Q13": ("K10_expand_join", "K11_probe_run_any", "K3_radix_sort",
            "K4_gather_rows", "K8_segmented_reduce"),
    "Q15": ("K9_merge_join", "K5_affine_join", "K3_radix_sort",
            "K4_gather_rows", "K8_segmented_reduce", "K1_scalar_aggregate"),
    "Q16": ("K5_affine_join", "K3_radix_sort", "K4_gather_rows",
            "K8_segmented_reduce"),
    "Q17": ("K9_merge_join", "K5_affine_join", "K3_radix_sort",
            "K4_gather_rows", "K8_segmented_reduce", "K1_scalar_aggregate"),
    "Q18": ("K10_expand_join", "K5_affine_join", "K3_radix_sort",
            "K4_gather_rows", "K8_segmented_reduce", "K7_topk_candidates"),
    "Q20": ("K10_expand_join", "K12_hash_combine", "K5_affine_join",
            "K3_radix_sort", "K4_gather_rows", "K8_segmented_reduce"),
    "Q21": ("K10_expand_join", "K11_probe_run_any", "K5_affine_join",
            "K3_radix_sort", "K4_gather_rows", "K8_segmented_reduce",
            "K7_topk_candidates"),
    "Q22": ("K9_merge_join", "K10_expand_join", "K3_radix_sort",
            "K4_gather_rows", "K2_groupby_direct", "K1_scalar_aggregate"),
}

# second entry points and operators each statement's path must run:
# K5's probe (the affine semi/anti join), K10's range search alone (the
# sorted-range semi/anti join) and the Distinct operator
PATH_ENTRIES = {
    "Q4": ("K10_expand_join.ranges",),
    "Q16": ("K5_affine_join.probe", "dedup_batch"),
    "Q18": ("K10_expand_join.ranges",),
    "Q20": ("K5_affine_join.probe", "K10_expand_join.ranges"),
    "Q22": ("K10_expand_join.ranges",),
}

# exact launch counts over a statement's runs: T1's first run overflows
# the top-k prefilter (a low-cardinality key ties beyond C), which turns
# the prefilter off for the cached plan, so K7 runs once in all its runs
EXACT_LAUNCHES = {"T1": {"K7_topk_candidates": 1}}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sector_bytes(rows, elem: int) -> int:
    """Bytes that reading the elements at `rows` (row indices) of an array
    of `elem`-byte elements moves: the card reads whole 32-byte sectors, so
    each distinct sector those rows touch counts once."""
    import torch

    if rows.numel() == 0:
        return 0
    return 32 * int(torch.unique(rows.to(torch.int64) * elem // 32).numel())


def check_q1(rs, lineitem, queries) -> int:
    import numpy as np

    got = rs.storage_columns()
    ref = queries.q1_numpy_fast(lineitem)
    nls = len(lineitem.dicts["l_linestatus"])
    keys = got["l_returnflag"].astype(np.int64) * nls + got["l_linestatus"]
    live = np.flatnonzero(ref["count"] > 0)
    require(sorted(keys.tolist()) == keys.tolist(), "Q1 rows out of order")
    require(keys.tolist() == live.tolist(), "Q1 group set differs")
    pairs = (("sum_qty", "sum_qty"), ("sum_base_price", "sum_price"),
             ("sum_disc_price", "sum_dp"), ("sum_charge", "sum_ch"),
             ("count_order", "count"))
    for col, rcol in pairs:
        require(np.array_equal(got[col].astype(np.int64), ref[rcol][keys]),
                f"Q1 {col} differs from the int64 oracle")
    cnt = ref["count"][keys].astype(np.float64)
    for col, num, scale in (("avg_qty", ref["sum_qty"], 100.0),
                            ("avg_price", ref["sum_price"], 100.0),
                            ("avg_disc", ref["sum_disc"], 100.0)):
        want = num[keys].astype(np.float64) / scale / cnt
        require(bool(np.all(np.isfinite(got[col]))), f"Q1 {col} not finite")
        require(np.allclose(got[col], want, rtol=1e-12, atol=0.0),
                f"Q1 {col} differs from the oracle beyond rel 1e-12")
    return len(keys)


def check_q6(rs, lineitem, queries) -> int:
    got = rs.storage_columns()["revenue"]
    require(len(got) == 1, "Q6 must return one row")
    require(int(got[0]) == queries.q6_numpy(lineitem),
            "Q6 revenue differs from the int64 oracle")
    return 1


def check_s1(rs, lineitem, queries, day: str) -> int:
    import numpy as np

    got = rs.storage_columns()
    ref = queries.s1_numpy(lineitem, day)
    for col, want in ref.items():
        require(np.array_equal(got[col], want),
                f"S1 ({day}) column {col} differs from the oracle")
    n = len(ref["l_orderkey"])
    require(n > 0, f"S1 ({day}) selected no rows")
    return n


def check_oracle(name, rs, ref, allow_empty=False) -> int:
    """Every column of the result against the oracle's column of the same
    name: integers (scaled decimals, dates, dictionary codes) exactly,
    floats (a ratio) to rel 1e-12. Only a statement whose oracle may be
    empty (Q20: this generator draws l_suppkey uniformly, so few lines
    match a partsupp pair) may return no rows."""
    import numpy as np

    got = rs.storage_columns()
    n = None
    for col, v in got.items():
        want = np.atleast_1d(np.asarray(ref[col]))
        v = np.asarray(v)
        require(v.shape == want.shape, f"{name} {col}: {v.shape} rows, "
                f"the oracle has {want.shape}")
        if v.dtype.kind == "f":
            require(bool(np.all(np.isfinite(v))), f"{name} {col} not finite")
            require(np.allclose(v, want, rtol=1e-12, atol=0.0),
                    f"{name} {col} differs from the oracle beyond rel 1e-12")
        else:
            require(np.array_equal(v.astype(np.int64), want.astype(np.int64)),
                    f"{name} {col} differs from the int64 oracle")
        n = len(v)
    require(bool(n) or allow_empty, f"{name} returned no rows")
    return n


def check_sane(name, rs) -> int:
    """A statement with no oracle at this scale (sqlite and the CPU hold it
    at smaller ones): rows of one length, finite floats, at least one row."""
    import numpy as np

    got = rs.storage_columns()
    lens = {len(v) for v in got.values()}
    require(len(lens) == 1, f"{name}: columns of different lengths {lens}")
    for col, v in got.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            require(bool(np.all(np.isfinite(v))), f"{name} {col} not finite")
    n = lens.pop()
    require(n > 0, f"{name} returned no rows")
    return n


def check_q19(rs, tables, queries) -> int:
    got = rs.storage_columns()["revenue"]
    want = queries.q19_numpy(tables)
    require(want > 0, "Q19's oracle selected no rows")
    require(len(got) == 1 and int(got[0]) == want,
            "Q19 revenue differs from the int64 oracle")
    return 1


def device_busy_ms(fn) -> tuple[float, float, list, list]:
    """(device ms, wall ms, longest idle gaps, device ms by kernel) of one
    fn() call under torch.profiler. Device time is the union of the
    intervals of the trace's CUDA events (kernels, copies, sets), so
    overlapping records count once and host-side records not at all; the
    wall is the host clock around the same traced call. The gaps are the
    three longest stretches between device intervals, with the events on
    either side; the kernels are the six names with the most device time,
    summed over the same CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    require(bool(spans), "the traced run recorded no device activity")
    busy_us, gaps = 0.0, []
    cur_s, cur_e, cur_name = spans[0]
    for s, e, name in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append(((s - cur_e) / 1e3, cur_name, name))
            cur_s = s
        if e >= cur_e:
            cur_e, cur_name = e, name
    busy_us += cur_e - cur_s
    gaps.sort(reverse=True)
    by_name: dict = {}
    for st, en, name in spans:
        short = name.split("(")[0].split("<")[0].replace("void ", "")
        by_name[short] = by_name.get(short, 0.0) + (en - st) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return busy_us / 1e3, wall, gaps[:3], top


def checked_by(name: str) -> str:
    if name in SANE_ONLY:
        return "non-empty and finite (no oracle at this scale)"
    return "exact against the int64 oracle"


SANE_ONLY = ({f"Q{q}" for q in NEW_QUERIES}
             - {"Q4", "Q11", "Q12", "Q13", "Q20"})


def run_statement(sess, kernels, name, text, check, warm, nrows_li):
    import torch

    before = dict(kernels.LAUNCHES)
    before_e = dict(kernels.ENTRY_LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rs = sess.sql(text)
    n = rs.nrows
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        rs = sess.sql(text)
        n = rs.nrows
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rows = check(rs)
    require(rows == n, f"{name}: row count {n} != checked rows {rows}")
    busy, traced, gaps, top = device_busy_ms(lambda: sess.sql(text).nrows)
    require(busy <= traced, f"{name}: device busy {busy} ms exceeds the "
            f"traced wall {traced} ms")
    peak = torch.cuda.max_memory_allocated()
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    entries = {k: kernels.ENTRY_LAUNCHES[k] - before_e[k]
               for k in kernels.ENTRY_LAUNCHES}
    for k in PATH_KERNELS[name]:
        require(launches[k] > 0, f"{name}: kernel {k} was never launched")
    for k in PATH_ENTRIES.get(name, ()):
        require(entries[k] > 0, f"{name}: {k} was never run on the card")
    for k, want in EXACT_LAUNCHES.get(name, {}).items():
        require(launches[k] == want, f"{name}: kernel {k} launched "
                f"{launches[k]} times, expected {want}")
    med = statistics.median(times) if times else cold
    rec = {
        "statement": name, "cold_ms": cold, "warm_median_ms": med,
        "warm_ms": times, "lineitem_rows_per_s": nrows_li / (med / 1e3),
        "result_rows": rows, "checked_by": checked_by(name),
        "launches": launches,
        "entries": {k: v for k, v in entries.items() if v},
        "peak_memory_bytes": peak,
        "fast_path_hit": bool(rs.fast_path_hit),
        "device_busy_ms": busy, "traced_wall_ms": traced,
        "device_idle_share": 1 - busy / traced,
        "longest_idle_gaps": [{"ms": g, "after": a, "before": b}
                              for g, a, b in gaps],
        "device_ms_by_kernel": [{"name": k, "ms": v} for k, v in top],
    }
    print(f"statement {name}: cold {cold:.3f} ms, warm median {med:.3f} ms, "
          f"{rec['lineitem_rows_per_s']:.6g} lineitem rows/s, {rows} rows, "
          f"{rec['checked_by']}, peak memory {peak / 2**30:.3f} GiB, "
          f"launches { {k: v for k, v in launches.items() if v} }, "
          f"entries {rec['entries']}, device busy {busy:.3f} ms of "
          f"{traced:.3f} ms traced (idle share "
          f"{rec['device_idle_share']:.4f}, longest gap "
          f"{gaps[0][0] if gaps else 0.0:.3f} ms); most device time: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in top[:4]), flush=True)
    return rec


def capture_args(sess, text: str, targets: dict) -> dict:
    """Run `text` once more with each wrapper of `targets` ({key: (module,
    attribute, size of a call's arguments)}) wrapped to keep the arguments
    of its largest call, and return {key: arguments}."""
    got, saved = {}, []
    for key, (mod, attr, size_of) in targets.items():
        orig = getattr(mod, attr)

        def wrapped(*a, _o=orig, _k=key, _sz=size_of, **kw):
            n = _sz(*a)
            if _k not in got or n > got[_k][0]:
                got[_k] = (n, a)
            return _o(*a, **kw)

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, orig))
    try:
        sess.sql(text).nrows
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    for key in targets:
        require(key in got, f"capture: {key} was not called by {text[:40]!r}")
    return {k: a for k, (_n, a) in got.items()}


def capture_join_kernels(sess, kernels, queries_text) -> dict:
    """The arguments the main path gives the join kernels at this scale:
    K9 in Q17, K10 in Q21, K11 in Q13, K12 in Q9, and K5's probe entry and
    the Distinct operator in Q16."""
    import oceanbase_tpu_torch.engine.executor as ex
    import oceanbase_tpu_torch.ops.join as join

    plan = {
        17: {"K9_merge_join": (kernels, "merge_join",
                               lambda bk, bs, pk, ps: pk.numel())},
        21: {"K10_expand_join": (kernels, "expand_join",
                                 lambda sk, o, nl, pk, ps, cap: cap
                                 + pk.numel())},
        13: {"K11_probe_run_any": (kernels, "probe_run_any",
                                   lambda ok, st, of: ok.numel())},
        9: {"K12_hash_combine": (join, "hash_combine",
                                 lambda cols: cols[0].numel() * len(cols))},
        16: {"K5_affine_join.probe": (ex, "affine_probe",
                                      lambda pk, *rest: pk.numel()),
             "dedup_batch": (ex.Executor, "_dedup_batch",
                             lambda self, b, ovf: b.capacity)},
    }
    out = {}
    for q, targets in plan.items():
        out.update(capture_args(sess, queries_text[q], targets))
    return out


def dedup_steps(kernels, b, plain: bool):
    """The Distinct operator's device steps (executor._dedup_batch): the
    sort order over every operand, the gather, the run boundaries; returns
    [sel, sorted operands...]."""
    from oceanbase_tpu_torch.engine.executor import _row_key_operands

    keys, _spec = _row_key_operands(b.cols, b.valid, b.schema)
    sort = kernels.sort_order_plain if plain else kernels.sort_order
    gather = kernels.gather_columns_plain if plain else kernels.gather_columns
    order = sort(keys, [False] * len(keys), b.sel)
    g = gather(keys + [b.sel], order)
    new = kernels.boundaries([~g[-1]] + g[:-1])
    return [new & g[-1]] + g[:-1]


def kernel_checks(sess, kernels, reps: int, captured: dict) -> list[dict]:
    """Each kernel at the main path's shapes against its plain version."""
    import torch

    from oceanbase_tpu_torch.expr.compile import _parse_date
    from oceanbase_tpu_torch.ops.hashing import pack_keys

    cols = ("l_discount", "l_extendedprice", "l_linenumber", "l_linestatus",
            "l_orderkey", "l_partkey", "l_quantity", "l_returnflag",
            "l_shipdate", "l_suppkey", "l_tax")
    b = sess.executor.table_batch("lineitem", cols)
    c = b.cols
    sel = b.sel
    n = b.capacity
    out = []

    def record(name, got, want, k_fn, p_fn, lib_fn, nbytes, ops):
        if isinstance(got, (list, tuple)):
            pairs = list(zip(got, want))
        else:
            pairs = [(got, want)]
        err = 0.0
        for g, w in pairs:
            require(g.dtype == w.dtype and g.shape == w.shape,
                    f"{name}: dtype/shape differs from the plain version")
            if g.dtype == torch.bool:
                d = (g != w).any().item()
            else:
                d = (g.to(torch.float64) - w.to(torch.float64)).abs().max().item() \
                    if g.numel() else 0.0
            err = max(err, float(d))
        require(err == 0.0, f"{name}: max |kernel - plain| = {err}")
        again = k_fn()
        if not isinstance(again, (list, tuple)):
            again = [again]
        for g, a in zip([g for g, _w in pairs], again):
            require(torch.equal(g, a), f"{name}: two runs differ in their bits")
        km = cuda_ms(k_fn, reps)
        pm = cuda_ms(p_fn, max(1, reps // 2))
        lm = cuda_ms(lib_fn, reps) if lib_fn is not None else None
        bm, by = bound_ms(nbytes, ops)
        src, rep = KERNEL_META[name]
        rec = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "max_abs_err": err, "ms": km, "plain_ms": pm, "bound_ms": bm,
               "bound_by": by, "library_ms": lm}
        print(f"kernel {name}: match exact, two runs bit-identical, "
              f"kernel_ms {km:.6f}, plain_ms "
              f"{pm:.6f}, library_ms {lm}, bound_ms {bm:.6f} ({by})",
              flush=True)
        out.append(rec)

    # K1 at Q6's shape: revenue = sum(price * discount) under the filter
    d0, d1 = _parse_date("1994-01-01"), _parse_date("1995-01-01")
    m6 = (sel & (c["l_shipdate"] >= d0) & (c["l_shipdate"] < d1)
          & (c["l_discount"] >= 5) & (c["l_discount"] <= 7)
          & (c["l_quantity"] < 2400))
    v6 = c["l_extendedprice"].to(torch.int64) * c["l_discount"].to(torch.int64)
    nsel6 = int(m6.sum())
    live6 = m6.nonzero().squeeze(1)
    record(
        "K1_scalar_aggregate",
        kernels.scalar_reduce("sum", m6, v6),
        kernels.scalar_reduce_plain("sum", m6, v6),
        lambda: kernels.scalar_reduce("sum", m6, v6),
        lambda: kernels.scalar_reduce_plain("sum", m6, v6),
        lambda: torch.sum(torch.where(m6, v6, 0)),
        n + sector_bytes(live6, 8) + 8, nsel6)

    # K2 at Q1's shape: domain 8, the live count + 9 aggregates
    cutoff = _parse_date("1998-09-02")
    m1 = sel & (c["l_shipdate"] <= cutoff)
    packed, dom = pack_keys([c["l_returnflag"], c["l_linestatus"]],
                            [len(b.dicts["l_returnflag"]),
                             len(b.dicts["l_linestatus"])])
    packed = packed.contiguous()
    price = c["l_extendedprice"]
    dp = price * (100 - c["l_discount"].to(torch.int64))
    ch = dp * (100 + c["l_tax"].to(torch.int64))
    aggs = [("count", None, m1), ("sum", c["l_quantity"], m1),
            ("sum", price, m1), ("sum", dp, m1), ("sum", ch, m1),
            ("count", None, m1), ("count", None, m1),
            ("sum", c["l_discount"], m1), ("count", None, m1),
            ("count", None, m1)]
    # every row's key and mask; values only where the (one shared) mask is set
    vals = [v for _op, v, _m in aggs if v is not None]
    nsel1 = int(m1.sum())
    live1 = m1.nonzero().squeeze(1)
    k2_bytes = n * (packed.element_size() + 1) \
        + sum(sector_bytes(live1, v.element_size()) for v in vals) \
        + len(aggs) * dom * 8

    def k2_library():
        res = []
        for op, v, mm in aggs:
            w = mm.to(torch.int64) if v is None else torch.where(mm, v, 0).to(torch.int64)
            res.append(torch.zeros(dom, dtype=torch.int64, device=w.device)
                       .index_add_(0, packed.long(), w))
        return res

    record(
        "K2_groupby_direct",
        kernels.groupby_slots(packed, dom, aggs),
        kernels.groupby_slots_plain(packed, dom, aggs),
        lambda: kernels.groupby_slots(packed, dom, aggs),
        lambda: kernels.groupby_slots_plain(packed, dom, aggs),
        k2_library, k2_bytes, nsel1 * len(aggs))

    # K3 at S1's shape: (price desc, orderkey, linenumber) over 60M rows,
    # most of them dead
    ms = sel & (c["l_shipdate"] == _parse_date(S1_DAYS[0])) \
        & (c["l_quantity"] < 1000)
    keys = [c["l_extendedprice"], c["l_orderkey"], c["l_linenumber"]]
    desc = [True, False, False]

    def k3_library():
        perm = torch.arange(n, device=sel.device)
        for k, d in reversed([(~ms, False), *zip(keys, desc)]):
            kk = (-k if d else k)[perm]
            perm = perm[torch.sort(kk, stable=True).indices]
        return perm

    order = kernels.sort_order(keys, desc, ms)
    record(
        "K3_radix_sort", order, kernels.sort_order_plain(keys, desc, ms),
        lambda: kernels.sort_order(keys, desc, ms),
        lambda: kernels.sort_order_plain(keys, desc, ms),
        k3_library, n * (8 + 8 + 1 + 1 + 4), n * 4)

    # K4 at S1's Sort shape: the projected payload + sel by the order
    payload = [c["l_orderkey"], c["l_linenumber"], c["l_extendedprice"],
               c["l_shipdate"], ms]
    width = sum(p.element_size() for p in payload)
    record(
        "K4_gather_rows",
        kernels.gather_columns(payload, order),
        kernels.gather_columns_plain(payload, order),
        lambda: kernels.gather_columns(payload, order),
        lambda: kernels.gather_columns_plain(payload, order),
        lambda: [p.index_select(0, order) for p in payload],
        n * (4 + 2 * width), n * len(payload))

    vol = c["l_extendedprice"] * (100 - c["l_discount"].to(torch.int64))

    def flat(res):
        """(mask or count, [columns]) -> one list of tensors."""
        return [res[0], *res[1]]

    # K5 at Q14's shape: lineitem's September 1995 rows probe part by
    # l_partkey, gathering p_partkey and p_type
    ex = sess.executor
    pb = ex.table_batch("part", ("p_partkey", "p_type"))
    pkeys = ex.catalog["part"].data["p_partkey"]
    a0, stride = int(pkeys[0]), int(pkeys[1]) - int(pkeys[0])
    m14 = (sel & (c["l_shipdate"] >= _parse_date("1995-09-01"))
           & (c["l_shipdate"] < _parse_date("1995-10-01")))
    lk, bkey = c["l_partkey"], pb.cols["p_partkey"]
    pay = [pb.cols["p_partkey"], pb.cols["p_type"]]
    nb5 = int(bkey.shape[0])

    def k5_library():
        cand = torch.div(lk.to(torch.int64) - a0, stride,
                         rounding_mode="floor").clamp(0, nb5 - 1)
        hit = (m14 & (bkey.index_select(0, cand) == lk)
               & pb.sel.index_select(0, cand))
        return [hit] + [p.index_select(0, cand) for p in pay]

    # every probe row's sel in, sel and payload out; the probe key, and the
    # build key, sel and payload at the candidate, only at live probe rows
    pw = sum(p.element_size() for p in pay)
    live14 = m14.nonzero().squeeze(1)
    cand14 = torch.div(lk[live14].to(torch.int64) - a0, stride,
                       rounding_mode="floor").clamp(0, nb5 - 1)
    k5_bytes = (n * (1 + 1 + pw) + sector_bytes(live14, lk.element_size())
                + sum(sector_bytes(cand14, t.element_size())
                      for t in (bkey, pb.sel, *pay)))
    record(
        "K5_affine_join",
        flat(
            kernels.affine_join(lk, m14, a0, stride, bkey, pb.sel, pay)),
        flat(
            kernels.affine_join_plain(lk, m14, a0, stride, bkey, pb.sel,
                                      pay)),
        lambda: flat(
            kernels.affine_join(lk, m14, a0, stride, bkey, pb.sel, pay)),
        lambda: kernels.affine_join_plain(lk, m14, a0, stride, bkey, pb.sel,
                                          pay),
        k5_library, k5_bytes, n)

    # K6 at Q3's shape: per order, the live lineitem rows of its range
    # (l_shipdate > 1995-03-15) and their discounted volume
    ob = ex.table_batch("orders", ("o_orderdate", "o_orderkey"))
    starts, ends = ex.fk_ranges("lineitem", "l_orderkey", "orders",
                                "o_orderkey")
    m3 = sel & (c["l_shipdate"] > _parse_date("1995-03-15"))
    aggs6 = [("sum", vol, None)]
    lengths = (ends - starts).to(torch.int64)
    covered = int(lengths.sum())
    require(int(starts[0]) == 0, "K6: the first range must start at row 0")
    vals6 = torch.where(m3, vol, 0).to(torch.float64)[:covered].contiguous()
    nb6 = int(starts.shape[0])
    # the ranges and the covered rows' sel in, the count and the sum out;
    # the values only at live rows
    k6_bytes = (nb6 * 8 + covered
                + sector_bytes(m3[:covered].nonzero().squeeze(1), 8) + nb6 * 16)
    k6_out = kernels.clustered_segments(starts, ends, m3, aggs6)
    record(
        "K6_clustered_agg", flat(k6_out),
        flat(
            kernels.clustered_segments_plain(starts, ends, m3, aggs6)),
        lambda: flat(
            kernels.clustered_segments(starts, ends, m3, aggs6)),
        lambda: kernels.clustered_segments_plain(starts, ends, m3, aggs6),
        lambda: torch.segment_reduce(vals6, "sum", lengths=lengths),
        k6_bytes, covered)

    # K7 at Q3's shape: the 256 best order revenues among the orders that
    # qualify (o_orderdate < 1995-03-15, at least one live line)
    rev = k6_out[1][0]
    osel = (ob.sel & (ob.cols["o_orderdate"] < _parse_date("1995-03-15"))
            & (k6_out[0] > 0))
    C = 256
    masked7 = torch.where(osel, rev, torch.iinfo(torch.int64).min)
    record(
        "K7_topk_candidates", list(kernels.topk_candidates(rev, osel, True, C)),
        list(kernels.topk_candidates_plain(rev, osel, True, C)),
        lambda: list(kernels.topk_candidates(rev, osel, True, C)),
        lambda: kernels.topk_candidates_plain(rev, osel, True, C),
        lambda: torch.topk(masked7, C),
        nb6 + sector_bytes(osel.nonzero().squeeze(1), 8) + C * 4 + 8, nb6)

    # K8 at Q7's shape: three int32 keys (two nation-like codes and a
    # year) over 60M rows in sorted order, one int64 volume sum, the
    # two-nation filter keeping a few rows live
    sk = (c["l_suppkey"] % 25).to(torch.int32)
    ck = (c["l_partkey"] % 25).to(torch.int32)
    yr = (torch.div(c["l_shipdate"].to(torch.int64) * 4 + 2, 1461,
                    rounding_mode="floor") + 1970).to(torch.int32)
    m7 = (sel & (c["l_shipdate"] >= _parse_date("1995-01-01"))
          & (c["l_shipdate"] <= _parse_date("1996-12-31"))
          & (((sk == 6) & (ck == 7)) | ((sk == 7) & (ck == 6))))
    keys8 = [sk, ck, yr]
    order8 = kernels.sort_order(keys8, [False] * 3, m7)
    g8 = kernels.gather_columns(keys8 + [m7], order8)
    skeys8, ssel8 = g8[:-1], g8[-1]
    aggs8 = [("sum", vol, None)]
    packed8 = (((~ssel8).to(torch.int64) << 60)
               | (skeys8[0].to(torch.int64) << 40)
               | (skeys8[1].to(torch.int64) << 20)
               | skeys8[2].to(torch.int64))
    svals8 = torch.where(ssel8, vol[order8.to(torch.int64)], 0).to(
        torch.float64)

    def k8_library():
        _u, counts = torch.unique_consecutive(packed8, return_counts=True)
        return torch.segment_reduce(svals8, "sum", lengths=counts)

    # every row's sorted sel in, sel and result out; the sorted keys and
    # the order only over the live rows (the sorted prefix; the result does
    # not depend on the dead rows' keys), the values at their order rows
    live7 = int(m7.sum())
    k8_bytes = (n * (1 + 1 + 8) + live7 * (3 * 4 + 4)
                + sector_bytes(order8[:live7], vol.element_size()))
    record(
        "K8_segmented_reduce",
        flat(
            kernels.segmented_reduce(skeys8, ssel8, order8, aggs8)),
        flat(
            kernels.segmented_reduce_plain(skeys8, ssel8, order8, aggs8)),
        lambda: flat(
            kernels.segmented_reduce(skeys8, ssel8, order8, aggs8)),
        lambda: kernels.segmented_reduce_plain(skeys8, ssel8, order8, aggs8),
        k8_library, k8_bytes, n * 4)

    i64max = torch.iinfo(torch.int64).max

    def live_rows(m):
        return m.nonzero().squeeze(1)

    # K9 at Q17's shape: lineitem probes the per-part aggregate (a build
    # side at lineitem's capacity with one live row per part)
    bk9, bs9, pk9, ps9 = captured["K9_merge_join"]
    nb9, np9 = int(bk9.shape[0]), int(pk9.shape[0])

    def k9_library():
        sk, si = torch.sort(torch.where(bs9, bk9.to(torch.int64), i64max))
        pk = pk9.to(torch.int64)
        pos = torch.searchsorted(sk, pk).clamp(max=nb9 - 1)
        hit = ps9 & (sk[pos] == pk) & bs9[si[pos]]
        return torch.where(hit, si[pos], -1)

    k9_bytes = (nb9 + sector_bytes(live_rows(bs9), bk9.element_size())
                + np9 + sector_bytes(live_rows(ps9), pk9.element_size())
                + np9 * 4)
    record("K9_merge_join", kernels.merge_join(bk9, bs9, pk9, ps9),
           kernels.merge_join_plain(bk9, bs9, pk9, ps9),
           lambda: kernels.merge_join(bk9, bs9, pk9, ps9),
           lambda: kernels.merge_join_plain(bk9, bs9, pk9, ps9),
           k9_library, k9_bytes, nb9 + np9)

    # K10 at Q21's shape: lineitem l1 expands against lineitem l2 sorted by
    # l_orderkey, into the capacity the overflow retries settled on
    sk10, or10, nl10, pk10, ps10, cap10 = captured["K10_expand_join"]
    np10 = int(pk10.shape[0])
    nlive10 = int(nl10)

    def k10_library():
        lo = torch.searchsorted(sk10, pk10).clamp(max=nlive10)
        hi = torch.searchsorted(sk10, pk10, right=True).clamp(max=nlive10)
        cnt = torch.where(ps10, hi - lo, 0)
        starts = torch.cumsum(cnt, 0) - cnt
        pr = torch.repeat_interleave(cnt)
        t = torch.arange(pr.shape[0], device=pr.device)
        return pr, or10[lo[pr] + t - starts[pr]]

    k10_bytes = (np10 * (1 + 16) + sector_bytes(live_rows(ps10), 8)
                 + nlive10 * (8 + 4) + cap10 * 9 + 8)
    record("K10_expand_join",
           list(kernels.expand_join(sk10, or10, nl10, pk10, ps10, cap10)),
           list(kernels.expand_join_plain(sk10, or10, nl10, pk10, ps10,
                                          cap10)),
           lambda: list(kernels.expand_join(sk10, or10, nl10, pk10, ps10,
                                            cap10)),
           lambda: kernels.expand_join_plain(sk10, or10, nl10, pk10, ps10,
                                             cap10),
           k10_library, k10_bytes, np10 * max(1, nlive10).bit_length() + cap10)

    # K11 at Q13's shape: customers OR their orders' residual over the pairs
    ok11, st11, of11 = captured["K11_probe_run_any"]
    cap11, np11 = int(ok11.shape[0]), int(st11.shape[0])
    lens11 = of11.clamp(max=cap11) - st11.clamp(max=cap11)
    used11 = int(lens11.sum())
    data11 = ok11[:used11].to(torch.float32)
    record("K11_probe_run_any", kernels.probe_run_any(ok11, st11, of11),
           kernels.probe_run_any_plain(ok11, st11, of11),
           lambda: kernels.probe_run_any(ok11, st11, of11),
           lambda: kernels.probe_run_any_plain(ok11, st11, of11),
           lambda: torch.segment_reduce(data11, "max", lengths=lens11,
                                        unsafe=True, initial=0),
           np11 * (16 + 1) + used11, used11)

    # K12 at Q9's shape: lineitem's (l_partkey, l_suppkey) hashed to probe
    # partsupp
    (cols12,) = captured["K12_hash_combine"]
    cols12 = list(cols12)
    n12 = int(cols12[0].shape[0])
    record("K12_hash_combine", kernels.hash_columns(cols12),
           kernels.hash_columns_plain(cols12),
           lambda: kernels.hash_columns(cols12),
           lambda: kernels.hash_columns_plain(cols12),
           lambda: kernels.hash_columns_plain(cols12),
           sum(c.numel() * c.element_size() for c in cols12) + n12 * 8,
           n12 * len(cols12) * 9)

    # K5's probe entry at Q16's shape: partsupp's suppliers against the
    # complaining suppliers (the NOT IN anti join)
    pk5, ps5, a05, st5, bk5, bs5 = captured["K5_affine_join.probe"]
    nb5p, np5 = int(bk5.shape[0]), int(pk5.shape[0])
    live5 = live_rows(ps5)
    cand5 = torch.div(pk5[live5].to(torch.int64) - a05, st5,
                      rounding_mode="floor").clamp(0, nb5p - 1)

    def k5p_library():
        cand = torch.div(pk5.to(torch.int64) - a05, st5,
                         rounding_mode="floor").clamp(0, nb5p - 1)
        hit = (ps5 & (bk5.index_select(0, cand) == pk5)
               & bs5.index_select(0, cand))
        return torch.where(hit, cand, -1)

    record("K5_affine_join.probe",
           kernels.affine_probe(pk5, ps5, a05, st5, bk5, bs5),
           kernels.affine_probe_plain(pk5, ps5, a05, st5, bk5, bs5),
           lambda: kernels.affine_probe(pk5, ps5, a05, st5, bk5, bs5),
           lambda: kernels.affine_probe_plain(pk5, ps5, a05, st5, bk5, bs5),
           k5p_library,
           np5 * (1 + 4) + sector_bytes(live5, pk5.element_size())
           + sector_bytes(cand5, bk5.element_size()) + sector_bytes(cand5, 1),
           np5)

    # the Distinct operator at Q16's shape (K3 + K4 and one boundary pass)
    from oceanbase_tpu_torch.engine.executor import _row_key_operands

    (_self, b16, _ovf) = captured["dedup_batch"]
    cols16, _spec = _row_key_operands(b16.cols, b16.valid, b16.schema)
    width16 = sum(c.element_size() for c in cols16)
    rows16 = live_rows(b16.sel)

    def dedup_library():
        live = torch.stack([c.to(torch.int64) for c in cols16])[:, rows16]
        return torch.unique(live, dim=1)

    record("dedup_batch", dedup_steps(kernels, b16, plain=False),
           dedup_steps(kernels, b16, plain=True),
           lambda: dedup_steps(kernels, b16, plain=False),
           lambda: dedup_steps(kernels, b16, plain=True),
           dedup_library, b16.capacity * (2 * (width16 + 1) + 1),
           b16.capacity * len(cols16))
    return out


def float_checks(sess, kernels) -> list[dict]:
    """The kernels on float inputs at the main path's shapes (the port's
    decimals are scaled integers, so its statements send no floats): two
    runs of a kernel must give the same bits. K1 and K2 must agree with
    the plain version to rel 1e-12 (float64) or 1e-4 (float32, as
    tests/test_torch_ops.py holds the plain float32 sum to JAX's; the
    kernels add in double, the plain versions in float32), min and max
    exactly; K6 and K8 exactly on integer-valued float64."""
    import torch

    from oceanbase_tpu_torch.expr.compile import _parse_date
    from oceanbase_tpu_torch.ops.hashing import pack_keys

    b = sess.executor.table_batch(
        "lineitem", ("l_extendedprice", "l_linestatus", "l_returnflag",
                     "l_shipdate"))
    c = b.cols
    mask = b.sel & (c["l_shipdate"] <= _parse_date("1998-09-02"))
    packed, dom = pack_keys([c["l_returnflag"], c["l_linestatus"]],
                            [len(b.dicts["l_returnflag"]),
                             len(b.dicts["l_linestatus"])])
    packed = packed.contiguous()
    out = []
    for dt, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        v = (c["l_extendedprice"].to(torch.float64) / 100.0).to(dt)
        for name, fn, plain in (
            ("K1_scalar_aggregate",
             lambda op: [kernels.scalar_reduce(op, mask, v)],
             lambda op: [kernels.scalar_reduce_plain(op, mask, v)]),
            ("K2_groupby_direct",
             lambda op: kernels.groupby_slots(packed, dom, [(op, v, mask)]),
             lambda op: kernels.groupby_slots_plain(
                 packed, dom, [(op, v, mask)])),
        ):
            for op in ("sum", "min", "max"):
                got, again, want = fn(op)[0], fn(op)[0], plain(op)[0]
                require(got.dtype == want.dtype and got.shape == want.shape,
                        f"{name} {op} {dt}: dtype/shape differs")
                require(torch.equal(got, again),
                        f"{name} {op} {dt}: two runs differ in their bits")
                if op == "sum":
                    g, w = got.to(torch.float64), want.to(torch.float64)
                    rel = ((g - w).abs()
                           / w.abs().clamp(min=1e-300)).max().item()
                    tol = rtol
                else:  # empty slots hold +-inf: compare exactly
                    rel = 0.0 if torch.equal(got, want) else float("inf")
                    tol = 0.0
                require(rel <= tol, f"{name} {op} {dt}: rel error {rel} "
                        f"above {tol}")
                rec = {"name": name, "op": op, "dtype": str(dt),
                       "max_rel_err": rel, "rtol": tol, "repeatable": True}
                print(f"float check {name} {op} {dt}: rel err {rel:.3e} "
                      f"(limit {tol}), two runs bit-identical", flush=True)
                out.append(rec)

    # K6 and K8 on integer-valued float64 (prices in cents): every prefix
    # sum is exact, so the kernels' direct sums and the plain versions'
    # cumsum differences must agree bit for bit, and two runs too. K8 runs
    # over Q1's two keys, whose few groups span thousands of tiles.
    ex = sess.executor
    cents = c["l_extendedprice"].to(torch.float64)
    starts, ends = ex.fk_ranges("lineitem", "l_orderkey", "orders",
                                "o_orderkey")
    keys = [c["l_returnflag"], c["l_linestatus"]]
    order = kernels.sort_order(keys, [False, False], mask)
    g = kernels.gather_columns(keys + [mask], order)
    cases = [
        ("K6_clustered_agg", "sum",
         lambda: kernels.clustered_segments(
             starts, ends, mask, [("sum", cents, None)])[1][0],
         lambda: kernels.clustered_segments_plain(
             starts, ends, mask, [("sum", cents, None)])[1][0]),
    ] + [
        ("K8_segmented_reduce", op,
         (lambda op=op: kernels.segmented_reduce(
             g[:-1], g[-1], order, [(op, cents, None)])[1][0]),
         (lambda op=op: kernels.segmented_reduce_plain(
             g[:-1], g[-1], order, [(op, cents, None)])[1][0]))
        for op in ("sum", "min", "max")
    ]
    for name, op, fn, plain in cases:
        got, again, want = fn(), fn(), plain()
        require(torch.equal(got, again),
                f"{name} {op} float64: two runs differ in their bits")
        require(torch.equal(got, want), f"{name} {op} float64 (integer "
                "values): differs from the plain version")
        out.append({"name": name, "op": op, "dtype": "torch.float64",
                    "max_rel_err": 0.0, "rtol": 0.0, "repeatable": True})
        print(f"float check {name} {op} torch.float64 (integer values): "
              "exact, two runs bit-identical", flush=True)
    return out


# --- the sqlite oracle (a copy of tests/test_tpch_full.py's transliteration)

_DATE_ARITH = (r"date\s+'(\d{4}-\d{2}-\d{2})'\s*([-+])\s*interval\s+'(\d+)'"
               r"\s+(day|month|year)")
_DATE_LIT = r"date\s+'(\d{4}-\d{2}-\d{2})'"
_EXTRACT = r"extract\s*\(\s*year\s+from\s+([A-Za-z_][\w.]*)\s*\)"
_SUBSTRING = (r"substring\s*\(\s*([A-Za-z_][\w.]*)\s+from\s+(\d+)\s+for"
              r"\s+(\d+)\s*\)")


def _fold_date(m) -> str:
    import numpy as np

    d = np.datetime64(m.group(1), "D")
    n = int(m.group(3)) * (-1 if m.group(2) == "-" else 1)
    unit = m.group(4)
    if unit == "day":
        d = d + np.timedelta64(n, "D")
    else:
        months = n * (12 if unit == "year" else 1)
        mo = d.astype("datetime64[M]") + np.timedelta64(months, "M")
        dom = (d - d.astype("datetime64[M]")).astype(int)
        nxt = (mo + np.timedelta64(1, "M")).astype("datetime64[D]")
        last = (nxt - mo.astype("datetime64[D]")).astype(int) - 1
        d = mo.astype("datetime64[D]") + np.timedelta64(
            min(int(dom), int(last)), "D")
    return f"'{d}'"


def to_sqlite(sql: str) -> str:
    import re

    sql = re.sub(_DATE_ARITH, _fold_date, sql)
    sql = re.sub(_DATE_LIT, lambda m: f"'{m.group(1)}'", sql)
    sql = re.sub(_EXTRACT, lambda m: f"cast(substr({m.group(1)}, 1, 4) as "
                 "integer)", sql)
    sql = re.sub(_SUBSTRING, lambda m: f"substr({m.group(1)}, {m.group(2)}, "
                 f"{m.group(3)})", sql)
    return sql


def _norm(v):
    import math

    import numpy as np

    if v is None:
        return None
    if isinstance(v, (float, np.floating)):
        if math.isnan(v):
            return None  # the engine surfaces SQL NULL as NaN for floats
        return round(float(v), 2)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, np.str_):
        return str(v)
    return v


def _norm_engine_value(v, name):
    import numpy as np

    if isinstance(v, (int, np.integer)) and ("date" in name):
        return str(np.datetime64("1970-01-01", "D") + int(v))
    return _norm(v)


def sqlite_checks(tables, Session, unique_keys, queries) -> list[dict]:
    """All 22 queries through Session(device="cuda") against sqlite over
    the same tables, as multisets of rounded rows (floats to rel 1e-4,
    abs 1e-2, as tests/test_tpch_full.py compares them). Four indexes let
    sqlite answer the correlated Q19 and Q21 in a second instead of
    minutes; they change no result."""
    import sqlite3

    import numpy as np

    sess = Session(tables, unique_keys=unique_keys, device="cuda")
    conn = sqlite3.connect(":memory:")
    for name, t in tables.items():
        cols = t.schema.names()
        decoded = {}
        for c in cols:
            dt = t.schema[c]
            if dt.kind.value == "varchar":
                decoded[c] = t.dicts[c].decode(t.data[c])
            elif dt.is_decimal:
                decoded[c] = (t.data[c] / dt.decimal_factor).tolist()
            elif dt.kind.value == "date":
                base = np.datetime64("1970-01-01", "D")
                decoded[c] = [str(base + int(v)) for v in t.data[c]]
            else:
                decoded[c] = t.data[c].tolist()
        conn.execute(f"create table {name} ({', '.join(cols)})")
        conn.executemany(
            f"insert into {name} values ({','.join('?' * len(cols))})",
            list(zip(*[decoded[c] for c in cols])))
    for ddl in ("create index li_ok on lineitem(l_orderkey)",
                "create index li_ps on lineitem(l_partkey, l_suppkey)",
                "create index ps_pk on partsupp(ps_partkey)",
                "create index o_ck on orders(o_custkey)"):
        conn.execute(ddl)
    conn.commit()
    out, bad = [], []
    for qid, text in queries:
        rs = sess.sql(text)
        want = [tuple(_norm(v) for v in row)
                for row in conn.execute(to_sqlite(text)).fetchall()]
        got = [tuple(_norm_engine_value(rs.columns[n][i], n)
                     for n in rs.names) for i in range(rs.nrows)]
        ok = len(got) == len(want)
        if ok:
            for g, w in zip(sorted(got, key=repr), sorted(want, key=repr)):
                for gv, wv in zip(g, w):
                    if isinstance(gv, float) or isinstance(wv, float):
                        ok &= (gv is not None and wv is not None
                               and abs(gv - wv) <= max(1e-2, 1e-4 * abs(wv)))
                    else:
                        ok &= gv == wv
        out.append({"query": qid, "rows": len(got), "sqlite_rows": len(want),
                    "match": bool(ok)})
        print(f"sqlite Q{qid}: {len(got)} rows, sqlite {len(want)}, "
              + ("match" if ok else "DIFFER"), flush=True)
        if not ok:
            bad.append(qid)
    conn.close()
    require(not bad, f"results differ from sqlite: {bad}")
    return out


def card_vs_cpu(tables, Session, unique_keys, stmts) -> list[dict]:
    """Every statement on the card and on the CPU (the plain versions) over
    the same small tables: each column must hold the same bits, floats
    too, since both run the same IEEE operations. A difference is reported
    by column, with its largest ulp and relative distance for floats."""
    import numpy as np

    card = Session(tables, unique_keys=unique_keys, device="cuda")
    cpu = Session(tables, unique_keys=unique_keys, device="cpu")
    out, bad = [], []
    for name, text in stmts:
        got = card.sql(text).storage_columns()
        want = cpu.sql(text).storage_columns()
        require(list(got) == list(want), f"card vs CPU {name}: columns differ")
        diffs = []
        for col, g in got.items():
            g, w = np.asarray(g), np.asarray(want[col])
            if g.dtype == w.dtype and g.shape == w.shape \
                    and g.tobytes() == w.tobytes():
                continue
            d = {"column": col, "rows": int(w.shape[0])}
            if g.shape == w.shape and g.dtype.kind == "f":
                g64, w64 = g.astype(np.float64), w.astype(np.float64)
                d["rows_differing"] = int(np.sum(g64 != w64))
                d["max_ulp"] = int(np.max(np.abs(
                    g64.view(np.int64) - w64.view(np.int64))))
                d["max_rel"] = float(np.max(np.abs(g64 - w64)
                                            / np.maximum(np.abs(w64), 1e-300)))
            diffs.append(d)
        out.append({"statement": name, "rows": len(next(iter(want.values()))),
                    "columns": len(want), "differing": diffs})
        print(f"card vs CPU {name}: {len(want)} columns, "
              + ("identical bits" if not diffs else f"DIFFER {diffs}"),
              flush=True)
        if diffs:
            bad.append(name)
    require(not bad, f"card and CPU results differ: {bad}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10,
                    help="timed repetitions per kernel")
    ap.add_argument("--out", default="smoke_out/chip_smoke.json",
                    help="details file, relative to the repository root")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from oceanbase_tpu_torch import kernels
    from oceanbase_tpu_torch.engine.session import Session
    from oceanbase_tpu_torch.models.tpch import datagen, queries, sql_suite

    card = gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.build()
    kernels._load()
    build_s = time.perf_counter() - t0
    print(f"kernel build seconds {build_s:.3f}", flush=True)

    t0 = time.perf_counter()
    tables = datagen.generate(sf=args.sf, seed=args.seed)
    li = tables["lineitem"]
    print(f"datagen sf {args.sf}: {li.nrows} lineitem rows in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    sess = Session(tables, unique_keys=sql_suite.UNIQUE_KEYS, device="cuda")
    t0 = time.perf_counter()
    refs = {
        "Q14": queries.q14_numpy(tables),
        "Q3": queries.q3_numpy(tables),
        "Q10": queries.q10_numpy(tables),
        "Q7": queries.q7_numpy(tables),
        "Q8": queries.q8_numpy(tables),
        "T1": queries.topn_desc_numpy(
            li, "l_quantity", 5, ("l_orderkey", "l_linenumber",
                                  "l_quantity")),
        "Q4": queries.q4_numpy(tables),
        "Q12": queries.q12_numpy(tables),
        "Q13": queries.q13_numpy(tables),
        "Q20": queries.q20_numpy(tables),
        "Q11": queries.q11_numpy(tables, q11_fraction(args.sf)),
    }
    print(f"join oracles in {time.perf_counter() - t0:.3f} s", flush=True)

    def oracle(name):
        return lambda rs: check_oracle(name, rs, refs[name],
                                       allow_empty=name == "Q20")

    stmts = [
        ("Q1", sql_suite.QUERIES[1], lambda rs: check_q1(rs, li, queries)),
        ("Q6", sql_suite.QUERIES[6], lambda rs: check_q6(rs, li, queries)),
        ("S1", S1.format(day=S1_DAYS[0]),
         lambda rs: check_s1(rs, li, queries, S1_DAYS[0])),
        ("S1_rebound", S1.format(day=S1_DAYS[1]),
         lambda rs: check_s1(rs, li, queries, S1_DAYS[1])),
        ("Q14", sql_suite.QUERIES[14], oracle("Q14")),
        ("Q3", sql_suite.QUERIES[3], oracle("Q3")),
        ("Q10", sql_suite.QUERIES[10], oracle("Q10")),
        ("Q7", sql_suite.QUERIES[7], oracle("Q7")),
        ("Q8", sql_suite.QUERIES[8], oracle("Q8")),
        ("Q19", sql_suite.QUERIES[19],
         lambda rs: check_q19(rs, tables, queries)),
        ("T1", T1, oracle("T1")),
    ]
    for q in NEW_QUERIES:
        name = f"Q{q}"
        stmts.append((name, statement_text(sql_suite.QUERIES, q, args.sf),
                      oracle(name) if name in refs
                      else (lambda rs, name=name: check_sane(name, rs))))
    # the main path: counts at 0 just before, read just after
    kernels.reset_launches()
    stmt_recs = [
        run_statement(sess, kernels, name, text, check, args.warm, li.nrows)
        for name, text, check in stmts
    ]
    main_launches = dict(kernels.LAUNCHES)
    rebound = next(r for r in stmt_recs if r["statement"] == "S1_rebound")
    require(rebound["fast_path_hit"],
            "rebound S1 did not reuse the cached plan through the text tier")
    for k, v in main_launches.items():
        require(v > 0, f"kernel {k} was never launched on the main path")

    main_entries = dict(kernels.ENTRY_LAUNCHES)
    for k, v in main_entries.items():
        require(v > 0, f"{k} was never run on the main path")

    captured = capture_join_kernels(sess, kernels, sql_suite.QUERIES)
    krecs = kernel_checks(sess, kernels, args.reps, captured)
    del captured
    frecs = float_checks(sess, kernels)
    del sess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tiny = datagen.generate(sf=SQLITE_SF, seed=args.seed)
    srecs = sqlite_checks(tiny, Session, sql_suite.UNIQUE_KEYS,
                          [(q, sql_suite.QUERIES[q]) for q in range(1, 23)])
    print(f"sqlite phase in {time.perf_counter() - t0:.3f} s", flush=True)
    small = datagen.generate(sf=CMP_SF, seed=args.seed)
    # every statement: all 22 queries, S1 twice and T1
    crecs = card_vs_cpu(small, Session, sql_suite.UNIQUE_KEYS,
                        [(name, text) for name, text, _check in stmts])
    for r in krecs:
        r["launches"] = (main_launches[r["name"]] if r["name"] in main_launches
                         else main_entries[r["name"]])
    kernels_line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in krecs if r["name"] in KERNEL_LINE
    ]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_path = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"gpu": card, "sf": args.sf, "build_s": build_s,
                   "lineitem_rows": li.nrows, "statements": stmt_recs,
                   "kernels": krecs, "float_checks": frecs,
                   "sqlite": {"sf": SQLITE_SF, "queries": srecs},
                   "card_vs_cpu": {"sf": CMP_SF, "statements": crecs},
                   "main_launches": main_launches,
                   "main_entries": main_entries,
                   "device": device,
                   "build_log": kernels.BUILD_INFO.get("log", "")},
                  f, indent=1)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
