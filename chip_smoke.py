#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Builds the port's CUDA kernels from `oceanbase_tpu_torch/csrc`, generates
TPC-H at SF 10 (seed 19920101), and drives the port's main path through
`Session(..., device="cuda").sql(...)`: Q1, Q6, the sorted selective scan
S1 and S1 again with a rebound date literal, each once cold and
`--warm` times warm, then once more under torch.profiler for its device
busy time. Every result must equal the int64 numpy oracles
exactly, and every kernel on a statement's path must have launched
during the main path. Then each kernel is called at the main path's
shapes and held against its plain PyTorch version (exact agreement), and
timed beside the plain version, a one-call PyTorch yardstick and its
memory-bandwidth bound.

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
}

# kernels each statement's path must launch
PATH_KERNELS = {
    "Q1": ("K2_groupby_direct", "K3_radix_sort", "K4_gather_rows"),
    "Q6": ("K1_scalar_aggregate",),
    "S1": ("K3_radix_sort", "K4_gather_rows"),
    "S1_rebound": ("K3_radix_sort", "K4_gather_rows"),
}


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


def device_busy_ms(fn) -> tuple[float, float, list]:
    """(device ms, wall ms, longest idle gaps) of one fn() call under
    torch.profiler. Device time is the union of the intervals of the
    trace's CUDA events (kernels, copies, sets), so overlapping records
    count once and host-side records not at all; the wall is the host
    clock around the same traced call. The gaps are the three longest
    stretches between device intervals, with the events on either side."""
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
    return busy_us / 1e3, wall, gaps[:3]


def run_statement(sess, kernels, name, text, check, warm, nrows_li):
    import torch

    before = dict(kernels.LAUNCHES)
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
    busy, traced, gaps = device_busy_ms(lambda: sess.sql(text).nrows)
    require(busy <= traced, f"{name}: device busy {busy} ms exceeds the "
            f"traced wall {traced} ms")
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    for k in PATH_KERNELS[name]:
        require(launches[k] > 0, f"{name}: kernel {k} was never launched")
    med = statistics.median(times) if times else cold
    rec = {
        "statement": name, "cold_ms": cold, "warm_median_ms": med,
        "warm_ms": times, "lineitem_rows_per_s": nrows_li / (med / 1e3),
        "result_rows": rows, "exact": True, "launches": launches,
        "fast_path_hit": bool(rs.fast_path_hit),
        "device_busy_ms": busy, "traced_wall_ms": traced,
        "device_idle_share": 1 - busy / traced,
        "longest_idle_gaps": [{"ms": g, "after": a, "before": b}
                              for g, a, b in gaps],
    }
    print(f"statement {name}: cold {cold:.3f} ms, warm median {med:.3f} ms, "
          f"{rec['lineitem_rows_per_s']:.6g} lineitem rows/s, {rows} rows, "
          f"exact, launches {launches}, device busy {busy:.3f} ms of "
          f"{traced:.3f} ms traced (idle share "
          f"{rec['device_idle_share']:.4f}, longest gap "
          f"{gaps[0][0] if gaps else 0.0:.3f} ms)", flush=True)
    return rec


def kernel_checks(sess, kernels, reps: int) -> list[dict]:
    """Each kernel at the main path's shapes against its plain version."""
    import torch

    from oceanbase_tpu_torch.expr.compile import _parse_date
    from oceanbase_tpu_torch.ops.hashing import pack_keys

    cols = ("l_discount", "l_extendedprice", "l_linenumber", "l_linestatus",
            "l_orderkey", "l_quantity", "l_returnflag", "l_shipdate",
            "l_tax")
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
        km = cuda_ms(k_fn, reps)
        pm = cuda_ms(p_fn, max(1, reps // 2))
        lm = cuda_ms(lib_fn, reps) if lib_fn is not None else None
        bm, by = bound_ms(nbytes, ops)
        src, rep = KERNEL_META[name]
        rec = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "max_abs_err": err, "ms": km, "plain_ms": pm, "bound_ms": bm,
               "bound_by": by, "library_ms": lm}
        print(f"kernel {name}: match exact, kernel_ms {km:.6f}, plain_ms "
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
    record(
        "K1_scalar_aggregate",
        kernels.scalar_reduce("sum", m6, v6),
        kernels.scalar_reduce_plain("sum", m6, v6),
        lambda: kernels.scalar_reduce("sum", m6, v6),
        lambda: kernels.scalar_reduce_plain("sum", m6, v6),
        lambda: torch.sum(torch.where(m6, v6, 0)),
        n + nsel6 * 8 + 8, nsel6)

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
    k2_bytes = n * (packed.element_size() + 1) \
        + nsel1 * sum(v.element_size() for v in vals) + len(aggs) * dom * 8

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
    return out


def float_checks(sess, kernels) -> list[dict]:
    """K1 and K2 on float inputs at the main path's shapes (the slice's
    decimals are scaled integers, so its statements send no floats): two
    runs of a kernel must give the same bits, and each result must agree
    with the plain version to rel 1e-12 (float64) or 1e-4 (float32, as
    tests/test_torch_ops.py holds the plain float32 sum to JAX's; the
    kernels add in double, the plain versions in float32), min and max
    exactly."""
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
    stmts = [
        ("Q1", sql_suite.QUERIES[1], lambda rs: check_q1(rs, li, queries)),
        ("Q6", sql_suite.QUERIES[6], lambda rs: check_q6(rs, li, queries)),
        ("S1", S1.format(day=S1_DAYS[0]),
         lambda rs: check_s1(rs, li, queries, S1_DAYS[0])),
        ("S1_rebound", S1.format(day=S1_DAYS[1]),
         lambda rs: check_s1(rs, li, queries, S1_DAYS[1])),
    ]
    # the main path: counts at 0 just before, read just after
    kernels.reset_launches()
    stmt_recs = [
        run_statement(sess, kernels, name, text, check, args.warm, li.nrows)
        for name, text, check in stmts
    ]
    main_launches = dict(kernels.LAUNCHES)
    require(stmt_recs[-1]["fast_path_hit"],
            "rebound S1 did not reuse the cached plan through the text tier")
    for k, v in main_launches.items():
        require(v > 0, f"kernel {k} was never launched on the main path")

    krecs = kernel_checks(sess, kernels, args.reps)
    frecs = float_checks(sess, kernels)
    for r in krecs:
        r["launches"] = main_launches[r["name"]]
    kernels_line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")}
        for r in krecs
    ]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_path = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"gpu": card, "sf": args.sf, "build_s": build_s,
                   "lineitem_rows": li.nrows, "statements": stmt_recs,
                   "kernels": krecs, "float_checks": frecs,
                   "main_launches": main_launches,
                   "device": device,
                   "build_log": kernels.BUILD_INFO.get("log", "")},
                  f, indent=1)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
