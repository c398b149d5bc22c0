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
its runs. The analytic statements follow in the same way: window
functions over all orders (W1-W3) and TPC-DS's revenue ratio (W4), set
operations (U1-U4), DISTINCT aggregates (D1, D2), approx_count_distinct
(A1, within 2% of the exact NDVs and equal to the plain estimate), ROLLUP
and CUBE (R1, R2), FULL and RIGHT joins (F1, F2), and the four TPC-DS
star queries (DS3, DS42, DS52, DS55) over TPC-DS at the same scale factor
(seed 20030101); U1, D2, F1 and F2 against int64 numpy oracles. Then each
kernel is called at the main path's shapes (the arguments of the join and
analytic kernels are captured from one more run of Q17, Q21, Q13, Q9,
Q16, W1-W3, U2, D1, A1 and F1) and held against its plain PyTorch version
(exact agreement, and the same bits on two runs), and timed beside the
plain version, a one-call PyTorch yardstick and its memory-bandwidth
bound. Then all 22 queries and the analytic statements run on the card
at SF 0.01 against sqlite (ROLLUP/CUBE against the union of plain
group-bys, INTERSECT/EXCEPT ALL against bag counts, approx_count_distinct
against the plain estimate), and every statement runs on the card and on
the CPU at SF 0.1, where the two results must hold the same bits.

The rest of Executor.prepare follows, each path with its launch counts
set to 0 just before it and read just after. The projection phase builds
`lineitem#sp:l_shipdate` (the reference bench's covered columns) and runs
Q6, Q6 over 1995 (rebound through the text tier), Q14, a one-week range
and the same statement over six months (wider than the slice capacity
seeded from the week: it overflows once and re-runs as a full scan), and
Q1 (not selective, so it stays on the base table), each through the
range slice K17 where routed. The streamed phase runs Q1, Q6, Q3 and Q14
under a 1 GiB device budget (scaled by SF / 10) and a memory governor:
the chunks are wire-encoded on the host, copied by the prefetch thread
and decoded by K18; then Q1 once in each prefetch x compression leg. The
grace phase runs a lineitem-orders join and a keyed group-by with a
count distinct under 128 MiB (scaled likewise), partitioned to host
spill files, once cold and once traced. All are exact against int64
oracles and the default Session's rows, balance the governor's ledger,
and every one of the 45 statements above prepared a resident plan at the
card's default budget. K17 and K18 are held against their plain versions
on the arguments of Q6's projection run, of one streamed Q3 chunk and of
a synthetic chunk (validity bits, runs that exactly fill their capacity,
-0.0 and NaN), and the projection and streamed statements run on the
card and on the CPU at SF 0.1 with identical bits.

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

# The analytic statements. Each wraps an operator whose result would be
# millions of rows in an outer aggregate, so it measures the operator and
# not the copy to the host.
WIN_SPEC = "partition by o_custkey order by o_orderdate, o_orderkey"
W1 = f"""select count(*) as n, max(rn) as max_rn, sum(rk) as sum_rk,
       sum(run) as sum_run, sum(rmax) as sum_rmax
from (select row_number() over ({WIN_SPEC}) as rn,
             rank() over (partition by o_custkey order by o_orderdate) as rk,
             sum(o_totalprice) over ({WIN_SPEC}) as run,
             max(o_totalprice) over ({WIN_SPEC}) as rmax
      from orders) w"""
W2 = f"""select count(*) as n, sum(mv) as sum_mv, sum(mx) as sum_mx,
       sum(lg) as sum_lg, sum(ld) as sum_ld
from (select sum(o_totalprice) over ({WIN_SPEC}
                 rows between 2 preceding and current row) as mv,
             max(o_totalprice) over ({WIN_SPEC}
                 rows between current row and unbounded following) as mx,
             lag(o_totalprice, 1, 0) over ({WIN_SPEC}) as lg,
             lead(o_shippriority, 2, -1) over ({WIN_SPEC}) as ld
      from orders) w"""
W3 = """select count(*) as n, sum(recent) as sum_recent,
       max(recent) as max_recent
from (select count(*) over (partition by o_custkey order by o_orderdate
                 range between 30 preceding and current row) as recent
      from orders) w"""
# TPC-DS Q98/Q12/Q20's revenue ratio (an aggregate's share of its
# category's total, a window over the aggregate) on store_sales
W4 = """select item.i_category, item.i_brand,
       sum(ss.ss_ext_sales_price) as itemrevenue,
       sum(ss.ss_ext_sales_price) * 100
         / sum(sum(ss.ss_ext_sales_price))
           over (partition by item.i_category) as revenueratio
from store_sales ss, item, date_dim dt
where ss.ss_item_sk = item.i_item_sk
  and ss.ss_sold_date_sk = dt.d_date_sk
  and dt.d_year = 2000 and dt.d_moy between 1 and 3
group by item.i_category, item.i_brand
order by item.i_category, item.i_brand"""
U1 = """with u as (
    select c_custkey from customer
    except
    select o_custkey from orders)
select count(*) as n, sum(c_custkey) as sum_key from u"""
U2 = """with u as (
    select o_custkey, o_orderpriority from orders
    where o_orderdate < date '1995-01-01'
    intersect
    select o_custkey, o_orderpriority from orders
    where o_orderdate >= date '1995-01-01')
select count(*) as n, sum(o_custkey) as sum_key from u"""
U3_SIDES = ("select l_suppkey as s from lineitem where l_shipmode = 'AIR'",
            "select l_suppkey from lineitem where l_shipmode = 'RAIL'")
U3 = f"""with u as (
    {U3_SIDES[0]}
    intersect all
    {U3_SIDES[1]})
select count(*) as n, sum(s) as sum_supp from u"""
U3E = U3.replace("intersect all", "except all")
U4 = """with u as (
    select l_orderkey as k from lineitem where l_shipmode = 'AIR'
    union
    select o_orderkey from orders where o_orderpriority = '1-URGENT')
select count(*) as n, sum(k) as sum_k from u"""
D1 = """select l_returnflag, l_linestatus,
       count(distinct l_suppkey) as n_supp,
       sum(distinct l_quantity) as sum_qty,
       count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""
D2 = """select o_orderpriority, approx_count_distinct(o_custkey) as n_cust
from orders group by o_orderpriority order by o_orderpriority"""
A1_COLS = ("l_orderkey", "l_partkey", "l_extendedprice")
A1 = ("select " + ", ".join(f"approx_count_distinct({c}) as ndv_{c}"
                            for c in A1_COLS) + " from lineitem")
R1_PARTS = ("lineitem", "where l_shipdate <= date '1998-09-02'",
            ("l_returnflag", "l_linestatus"),
            "sum(l_quantity) as sum_qty, count(*) as count_order")
R2_PARTS = ("orders", "", ("o_orderstatus", "o_orderpriority"),
            "count(*) as n, sum(o_totalprice) as total")


def grouping_text(parts, how: str) -> str:
    table, where, keys, aggs = parts
    return (f"select {', '.join(keys)}, {aggs} from {table} {where} "
            f"group by {how}({', '.join(keys)})")


R1 = grouping_text(R1_PARTS, "rollup")
R2 = grouping_text(R2_PARTS, "cube")
F1 = """select count(*) as n, count(c_custkey) as n_cust,
       count(o_orderkey) as n_ord
from customer full join orders on c_custkey = o_custkey"""
F2 = """select count(*) as n, count(o_orderkey) as n_ord,
       sum(c_acctbal) as bal
from orders right join customer on o_custkey = c_custkey"""

# name -> (text, data set); the TPC-DS star queries are added in main()
ANALYTIC = {
    "W1": (W1, "tpch"), "W2": (W2, "tpch"), "W3": (W3, "tpch"),
    "W4": (W4, "tpcds"), "U1": (U1, "tpch"), "U2": (U2, "tpch"),
    "U3": (U3, "tpch"), "U3E": (U3E, "tpch"), "U4": (U4, "tpch"),
    "D1": (D1, "tpch"), "D2": (D2, "tpch"), "A1": (A1, "tpch"),
    "R1": (R1, "tpch"), "R2": (R2, "tpch"), "F1": (F1, "tpch"),
    "F2": (F2, "tpch"),
}
DS_QUERIES = (3, 42, 52, 55)
DS_SEED = 20030101  # the TPC-DS generator's default seed


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
    "K13_window_scan": (
        "oceanbase_tpu_torch/csrc/k13_window_scan.cu",
        "oceanbase_tpu/ops/window.py:31"),
    "K14_hash_set": (
        "oceanbase_tpu_torch/csrc/k14_hash_set.cu",
        "oceanbase_tpu/ops/join.py:56"),
    "K15_distinct_first": (
        "oceanbase_tpu_torch/csrc/k15_distinct_first.cu",
        "oceanbase_tpu/ops/hashagg.py:240"),
    "K16_hll": (
        "oceanbase_tpu_torch/csrc/k16_hll.cu",
        "oceanbase_tpu/ops/hll.py:55"),
    "K17_slice_scan": (
        "oceanbase_tpu_torch/csrc/k17_slice_scan.cu",
        "oceanbase_tpu/engine/executor.py:4179"),
    "K18_decode_staged": (
        "oceanbase_tpu_torch/csrc/k18_decode_staged.cu",
        "oceanbase_tpu/engine/pipeline.py:187"),
    # second entries of K5, K11 and K15 (their launches count as the
    # kernel's too)
    "K5_affine_join.probe": (
        "oceanbase_tpu_torch/csrc/k5_affine_join.cu",
        "oceanbase_tpu/engine/executor.py:4240"),
    "K11_probe_run_any.mark_build": (
        "oceanbase_tpu_torch/csrc/k11_probe_run_any.cu",
        "oceanbase_tpu/engine/executor.py:2998"),
    "K15_distinct_first.scatter": (
        "oceanbase_tpu_torch/csrc/k15_distinct_first.cu",
        "oceanbase_tpu/engine/executor.py:2687"),
    # not a kernel of its own: the Distinct operator on K3 + K4
    "dedup_batch": (
        "oceanbase_tpu_torch/engine/executor.py",
        "oceanbase_tpu/engine/executor.py:2606"),
}

# the entries of the {"kernels": ...} line: K1-K18 and the second entries
KERNEL_LINE = [k for k in KERNEL_META if k != "dedup_batch"]
# the kernels of each path (the rest of prepare's paths launch K17, K18)
MAIN_KERNELS = [k for k in KERNEL_LINE
                if "." not in k and k not in ("K17_slice_scan",
                                              "K18_decode_staged")]

# the reference bench's sorted projection: lineitem by l_shipdate,
# covering every column of the headline queries (bench.py SP_COLS)
SP_COLS = ["l_shipdate", "l_quantity", "l_extendedprice", "l_discount",
           "l_tax", "l_returnflag", "l_linestatus", "l_partkey",
           "l_orderkey"]
P_RANGE = """select sum(l_extendedprice) as s, count(*) as n from lineitem
where l_shipdate >= date '{lo}' and l_shipdate < date '{hi}'"""
P_NARROW = ("1995-03-01", "1995-03-08")
P_WIDE = ("1995-03-01", "1995-09-01")
# the reference tests' grace-hash statements (tests/test_stream_pipeline.py)
GRACE_JOIN = """select o.o_orderpriority, sum(l.l_quantity) as qty,
       count(*) as cnt
from lineitem l, orders o
where l.l_orderkey = o.o_orderkey and l.l_quantity < 30
group by o.o_orderpriority
order by o.o_orderpriority"""
GRACE_GROUPBY = """select l_orderkey, sum(l_quantity) as q,
       count(distinct l_linenumber) as dl
from lineitem group by l_orderkey order by l_orderkey limit 7"""
# the budgets at SF 10, scaled by SF / 10 (the reference tests' 1 MiB and
# 48 KiB at SF 0.01, raised to what makes both grace sides exceed it)
STREAM_BUDGET_SF10 = 1 << 30
GRACE_BUDGET_SF10 = 128 << 20

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
    "W1": ("K3_radix_sort", "K4_gather_rows", "K13_window_scan",
           "K15_distinct_first", "K1_scalar_aggregate"),
    "W2": ("K3_radix_sort", "K4_gather_rows", "K13_window_scan",
           "K15_distinct_first", "K1_scalar_aggregate"),
    "W3": ("K3_radix_sort", "K4_gather_rows", "K13_window_scan",
           "K15_distinct_first", "K1_scalar_aggregate"),
    "W4": ("K5_affine_join", "K3_radix_sort", "K4_gather_rows",
           "K8_segmented_reduce", "K13_window_scan", "K15_distinct_first"),
    "U1": ("K14_hash_set", "K3_radix_sort", "K4_gather_rows",
           "K13_window_scan", "K1_scalar_aggregate"),
    "U2": ("K14_hash_set", "K3_radix_sort", "K4_gather_rows",
           "K13_window_scan", "K1_scalar_aggregate"),
    "U3": ("K3_radix_sort", "K4_gather_rows", "K13_window_scan",
           "K1_scalar_aggregate"),
    "U3E": ("K3_radix_sort", "K4_gather_rows", "K13_window_scan",
            "K1_scalar_aggregate"),
    "U4": ("K3_radix_sort", "K4_gather_rows", "K13_window_scan",
           "K1_scalar_aggregate"),
    "D1": ("K3_radix_sort", "K15_distinct_first", "K2_groupby_direct"),
    "D2": ("K3_radix_sort", "K15_distinct_first", "K2_groupby_direct"),
    "A1": ("K16_hll",),
    "R1": ("K2_groupby_direct",),
    "R2": ("K2_groupby_direct",),
    "F1": ("K10_expand_join", "K11_probe_run_any", "K3_radix_sort",
           "K4_gather_rows", "K1_scalar_aggregate"),
    "F2": ("K10_expand_join", "K11_probe_run_any", "K3_radix_sort",
           "K4_gather_rows", "K1_scalar_aggregate"),
    # the star joins probe each unique dimension by its affine key
    **{f"DS{q}": ("K5_affine_join", "K3_radix_sort", "K4_gather_rows",
                  "K8_segmented_reduce", "K7_topk_candidates")
       for q in (3, 42, 52, 55)},
    # the projection phase: the sliced scans, and Q1 on the base table
    "P_Q6": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_Q6_1995": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_Q14": ("K17_slice_scan", "K5_affine_join", "K1_scalar_aggregate"),
    "P_NARROW": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_WIDE": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_Q1": ("K2_groupby_direct",),
    # the streamed phase: every chunk decoded by K18
    "ST_Q1": ("K18_decode_staged", "K2_groupby_direct"),
    "ST_Q6": ("K18_decode_staged", "K1_scalar_aggregate"),
    "ST_Q3": ("K18_decode_staged", "K5_affine_join", "K3_radix_sort",
              "K4_gather_rows", "K8_segmented_reduce"),
    "ST_Q14": ("K18_decode_staged", "K5_affine_join", "K1_scalar_aggregate"),
    # the grace phase: partitions of host spill files (a partition of
    # orders is no longer affine, nor declared unique: the expansion join)
    "G_JOIN": ("K10_expand_join", "K2_groupby_direct", "K3_radix_sort",
               "K4_gather_rows"),
    "G_GROUPBY": ("K3_radix_sort", "K4_gather_rows", "K8_segmented_reduce",
                  "K15_distinct_first"),
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
    "W1": ("K15_distinct_first.scatter",),
    "W2": ("K15_distinct_first.scatter",),
    "W3": ("K15_distinct_first.scatter",),
    "W4": ("K15_distinct_first.scatter",),
    "U1": ("dedup_batch",),
    "U2": ("dedup_batch",),
    "U4": ("dedup_batch",),
    "F1": ("K11_probe_run_any.mark_build",),
}

# exact launch counts over a statement's runs: T1's first run overflows
# the top-k prefilter (a low-cardinality key ties beyond C), which turns
# the prefilter off for the cached plan, so K7 runs once in all its runs
EXACT_LAUNCHES = {"T1": {"K7_topk_candidates": 1},
                  # the six-month range overflows the week's slice once;
                  # the bumped plan scans the whole projection
                  "P_WIDE": {"K17_slice_scan": 1},
                  "P_Q1": {"K17_slice_scan": 0}}


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
    if name == "A1":
        return "within 2% of the exact NDVs, equal to the plain estimate"
    return "exact against the int64 oracle"


SANE_ONLY = ({f"Q{q}" for q in NEW_QUERIES}
             - {"Q4", "Q11", "Q12", "Q13", "Q20"}
             | ({*ANALYTIC} - {"U1", "D2", "F1", "F2", "A1"})
             | {f"DS{q}" for q in DS_QUERIES})


def analytic_oracles(tables) -> dict:
    """int64 numpy oracles of U1 (customers with no order), D2 (distinct
    customers per order priority, in priority order), F1 and F2 (the
    full and right joins' counts and the balance sum)."""
    import numpy as np

    cust = np.asarray(tables["customer"].data["c_custkey"], dtype=np.int64)
    bal = np.asarray(tables["customer"].data["c_acctbal"], dtype=np.int64)
    ocust = np.asarray(tables["orders"].data["o_custkey"], dtype=np.int64)
    prio = np.asarray(tables["orders"].data["o_orderpriority"],
                      dtype=np.int64)
    no = len(ocust)
    without = np.setdiff1d(np.unique(cust), ocust)
    cust_wo = len(cust) - int(np.isin(cust, ocust).sum())
    # orders per customer row (c_custkey is unique)
    order = np.argsort(cust, kind="stable")
    pos = np.minimum(np.searchsorted(cust[order], ocust), len(cust) - 1)
    hit = cust[order][pos] == ocust
    matched = int(hit.sum())
    per_cust = np.bincount(order[pos[hit]], minlength=len(cust))
    pairs = np.unique((prio << 32) | ocust)
    d2 = np.bincount(pairs >> 32, minlength=int(prio.max()) + 1)
    pdict = tables["orders"].dicts["o_orderpriority"]
    codes = np.flatnonzero(d2)
    strings = pdict.decode(codes)
    by_name = np.argsort(np.asarray(strings, dtype=object), kind="stable")
    return {
        "U1": {"n": len(without), "sum_key": int(without.sum())},
        "D2": {"o_orderpriority": codes[by_name], "n_cust": d2[codes][by_name]},
        "F1": {"n": no + cust_wo, "n_cust": matched + cust_wo, "n_ord": no},
        "F2": {"n": matched + cust_wo, "n_ord": matched,
               "bal": int((bal * np.maximum(per_cust, 1)).sum())},
    }


def check_a1(rs, sess, kernels) -> int:
    """A1's estimates: within 2% of the exact NDVs (numpy on the host) and
    equal to the estimates of the plain registers on the same columns."""
    import numpy as np

    from oceanbase_tpu_torch.ops.hll import hll_estimate

    got = rs.storage_columns()
    t = sess.executor.catalog["lineitem"]
    b = sess.executor.table_batch("lineitem", A1_COLS)
    for c in A1_COLS:
        est = int(got[f"ndv_{c}"][0])
        exact = len(np.unique(np.asarray(t.data[c])))
        plain = int(hll_estimate(kernels.hll_registers_plain(b.cols[c],
                                                             b.sel)))
        require(abs(est - exact) <= 0.02 * exact,
                f"A1 {c}: estimate {est} vs exact NDV {exact}")
        require(est == plain, f"A1 {c}: estimate {est} != plain {plain}")
        print(f"A1 {c}: estimate {est}, exact NDV {exact} (rel "
              f"{(est - exact) / exact:+.5f}), plain estimate {plain}",
              flush=True)
    return 1


def run_statement(sess, kernels, name, text, check, warm, fact_rows,
                  fact="lineitem", after=None):
    """Run `text` cold, `warm` times warm and once traced; `check` holds
    the result to its oracle, `after(rs)` (when given) checks the route
    and the state after the runs."""
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
    extra = after(rs) if after is not None else {}
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
        "warm_ms": times, "fact_table": fact,
        "fact_rows_per_s": fact_rows / (med / 1e3),
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
        "plan": type(rs._cursor.prepared).__name__,
        "result": rs.storage_columns(),
        **extra,
    }
    print(f"statement {name}: cold {cold:.3f} ms, warm median {med:.3f} ms, "
          f"{rec['fact_rows_per_s']:.6g} {fact} rows/s, {rows} rows, "
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


def capture_analytic_kernels(sess, kernels) -> dict:
    """The arguments the main path gives K11's mark entry (F1), K13 (W1:
    flags, starts, ends, prefix sum and running max; W2: the suffix max;
    W3: the frame-bound search), K14 (U2's build and probe), K15 (D1's
    first occurrences, W1's write-back) and K16 (A1)."""
    import oceanbase_tpu_torch.engine.executor as ex
    import oceanbase_tpu_torch.ops.hashagg as hashagg
    import oceanbase_tpu_torch.ops.hll as hll

    def n0(t, *rest):
        return t.numel()

    def cols_n(cols, *rest):
        return cols[0].numel() * len(cols)

    plan = [
        (W1, {"K13.flags": (ex, "boundaries", lambda keys: keys[0].numel()
                            * len(keys)),
              "K13.starts": (ex, "segment_starts", n0),
              "K13.ends": (ex, "peer_ends", n0),
              "K13.sum": (ex, "prefix_sum", n0),
              "K13.fwd": (ex, "segmented_scan_minmax", n0),
              "K15_distinct_first.scatter": (ex, "scatter_rows", cols_n)}),
        (W2, {"K13.suffix": (ex, "suffix_scan_minmax", n0)}),
        (W3, {"K13.search": (ex, "bound_search",
                             lambda arr, t, lo=None, hi=None, right=False:
                             t.numel() + (0 if lo is None else 1))}),
        (U2, {"K14.build": (ex, "build_hash_table", cols_n),
              "K14.probe": (ex, "hash_join_probe",
                            lambda tag, row, b, p, m: m.numel())}),
        (D1, {"K15_distinct_first": (hashagg, "first_occurrence", cols_n)}),
        (A1, {"K16_hll": (hll, "hll_registers", n0)}),
        (F1, {"K11_probe_run_any.mark_build": (ex, "mark_build", n0)}),
    ]
    out = {}
    for text, targets in plan:
        out.update(capture_args(sess, text, targets))
    return out


def k13_steps(kernels, cap: dict, plain: bool) -> list:
    """K13's entries on their captured main-path arguments (run flags,
    segment starts and ends, the prefix sum, the forward and backward
    segmented max, the frame-bound search), through the kernel or the
    plain versions."""
    def fn(name):
        return getattr(kernels, f"{name}_plain" if plain else name)

    (keys,) = cap["K13.flags"]
    vals, flags, is_min = cap["K13.fwd"]
    svals, sflags, s_is_min = cap["K13.suffix"]
    arr, target, lo, hi, *right = cap["K13.search"]
    return [
        fn("boundaries")(keys),
        fn("segment_starts")(*cap["K13.starts"]),
        fn("peer_ends")(*cap["K13.ends"]),
        fn("prefix_sum")(*cap["K13.sum"]),
        fn("segmented_scan_minmax")(vals, flags, is_min),
        fn("suffix_scan_minmax")(svals, sflags, s_is_min),
        fn("bound_search")(arr, target, lo, hi, *right),
    ]


def k14_steps(kernels, cap: dict, plain: bool):
    """K14's build and probe on U2's captured arguments: the match rows
    (the slot layout depends on the schedule; the match rows do not)."""
    build = kernels.hash_set_build_plain if plain else kernels.hash_set_build
    probe = kernels.hash_set_probe_plain if plain else kernels.hash_set_probe
    keys, mask, ts = cap["K14.build"]
    _tag, _row, bcols, pcols, pmask = cap["K14.probe"]
    tag, row = build(keys, mask, ts)
    return probe(tag, row, bcols, pcols, pmask)


def dedup_steps(kernels, b, plain: bool):
    """The Distinct operator's device steps (executor._dedup_batch): the
    sort order over every operand, the gather, the run boundaries; returns
    [sel, sorted operands...]."""
    from oceanbase_tpu_torch.engine.executor import _row_key_operands

    keys, _spec = _row_key_operands(b.cols, b.valid, b.schema)
    sort = kernels.sort_order_plain if plain else kernels.sort_order
    gather = kernels.gather_columns_plain if plain else kernels.gather_columns
    bounds = kernels.boundaries_plain if plain else kernels.boundaries
    order = sort(keys, [False] * len(keys), b.sel)
    g = gather(keys + [b.sel], order)
    new = bounds([~g[-1]] + g[:-1])
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

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))

    # K13 at W1/W2/W3's shapes (15M orders): every entry once; the bound
    # reads each entry's inputs once and writes its outputs once
    got13 = k13_steps(kernels, captured, plain=False)
    (keys13,) = captured["K13.flags"]
    args13 = ([*keys13], captured["K13.starts"], captured["K13.ends"],
              captured["K13.sum"], captured["K13.fwd"][:2],
              captured["K13.suffix"][:2], captured["K13.search"][:4])
    k13_bytes = (sum(nbytes(a) for a in args13) + nbytes(got13))
    sum_in = captured["K13.sum"][0]
    fwd_in = captured["K13.fwd"][0]
    arr13, tgt13 = captured["K13.search"][:2]

    def k13_library():
        return [torch.cumsum(sum_in, 0), torch.cummax(fwd_in, 0).values,
                torch.searchsorted(arr13, tgt13)]

    record("K13_window_scan", got13,
           k13_steps(kernels, captured, plain=True),
           lambda: k13_steps(kernels, captured, plain=False),
           lambda: k13_steps(kernels, captured, plain=True),
           k13_library, k13_bytes, sum(int(t.numel()) for t in got13))

    # K14 at U2's shape: the later orders' (o_custkey, o_orderpriority)
    # built into the set, the earlier orders' distinct pairs probed
    bkeys14, bmask14, _ts = captured["K14.build"]
    _t, _r, _b, pkeys14, pmask14 = captured["K14.probe"]
    np14 = int(pmask14.shape[0])

    def k14_library():
        hb = kernels.hash_columns_plain(bkeys14)
        hb = torch.where(bmask14, hb, torch.iinfo(torch.int64).max)
        sk, si = torch.sort(hb)
        hp = kernels.hash_columns_plain(pkeys14)
        pos = torch.searchsorted(sk, hp).clamp(max=sk.numel() - 1)
        return torch.where(pmask14 & (sk[pos] == hp), si[pos], -1)

    record("K14_hash_set", k14_steps(kernels, captured, plain=False),
           k14_steps(kernels, captured, plain=True),
           lambda: k14_steps(kernels, captured, plain=False),
           lambda: k14_steps(kernels, captured, plain=True),
           k14_library,
           nbytes([*bkeys14, bmask14, *pkeys14, pmask14]) + np14 * 4,
           int(bmask14.numel()) + np14)

    # K15 at D1's shape: lineitem's (flag, status, l_suppkey) first rows
    # along K3's order, written straight into row order
    cols15, mask15, order15 = captured["K15_distinct_first"]
    packed15 = torch.zeros_like(cols15[0], dtype=torch.int64)
    for c in cols15:
        packed15 = packed15 * 1_000_003 + c.to(torch.int64)

    record("K15_distinct_first",
           kernels.first_occurrence(cols15, mask15, order15),
           kernels.first_occurrence_plain(cols15, mask15, order15),
           lambda: kernels.first_occurrence(cols15, mask15, order15),
           lambda: kernels.first_occurrence_plain(cols15, mask15, order15),
           lambda: torch.unique(packed15, return_inverse=True),
           nbytes([*cols15, mask15, order15]) + mask15.numel(),
           int(mask15.numel()) * len(cols15))

    # K15's write-back at W1's shape (the results of one window spec)
    cols15s, order15s = captured["K15_distinct_first.scatter"]

    def scatter_library():
        o = order15s.to(torch.int64)
        return [torch.empty_like(c).index_copy_(0, o, c) for c in cols15s]

    record("K15_distinct_first.scatter",
           kernels.scatter_rows(cols15s, order15s),
           kernels.scatter_rows_plain(cols15s, order15s),
           lambda: kernels.scatter_rows(cols15s, order15s),
           lambda: kernels.scatter_rows_plain(cols15s, order15s),
           scatter_library, 2 * nbytes(cols15s) + nbytes([order15s]),
           int(order15s.numel()) * len(cols15s))

    # K16 at A1's shape: one lineitem column, 60M values
    col16, mask16 = captured["K16_hll"]

    def k16_library():
        h1, h2 = kernels.hll_hashes_plain(col16)
        rank = torch.where(h2 == 0, 33, 33 - kernels._bit_length32(h2))
        regs = torch.zeros(kernels.HLL_M, dtype=torch.int64,
                           device=col16.device)
        return regs.scatter_reduce_(
            0, h1 & (kernels.HLL_M - 1), torch.where(mask16, rank, 0),
            "amax")

    record("K16_hll", kernels.hll_registers(col16, mask16),
           kernels.hll_registers_plain(col16, mask16),
           lambda: kernels.hll_registers(col16, mask16),
           lambda: kernels.hll_registers_plain(col16, mask16),
           k16_library, nbytes([col16, mask16]) + kernels.HLL_M * 4,
           int(col16.numel()) * 24)

    # K11's build-side marks at F1's shape (orders into customer)
    br11, ps11, nr11 = captured["K11_probe_run_any.mark_build"]

    def mark_library():
        return torch.zeros(nr11, dtype=torch.bool, device=br11.device
                           ).index_fill_(0, br11[ps11].to(torch.int64), True)

    record("K11_probe_run_any.mark_build",
           kernels.mark_build(br11, ps11, nr11),
           kernels.mark_build_plain(br11, ps11, nr11),
           lambda: kernels.mark_build(br11, ps11, nr11),
           lambda: kernels.mark_build_plain(br11, ps11, nr11),
           mark_library, nbytes([br11, ps11]) + nr11, int(br11.numel()))
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
    conn = sqlite_conn(tables)
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
        ok = same_rows(engine_rows(rs), want)
        out.append({"query": qid, "rows": rs.nrows, "sqlite_rows": len(want),
                    "match": bool(ok)})
        print(f"sqlite Q{qid}: {rs.nrows} rows, sqlite {len(want)}, "
              + ("match" if ok else "DIFFER"), flush=True)
        if not ok:
            bad.append(qid)
    conn.close()
    require(not bad, f"results differ from sqlite: {bad}")
    return out


def sqlite_conn(tables):
    """An in-memory sqlite database holding the tables decoded (strings,
    decimals as floats, dates as ISO text)."""
    import sqlite3

    import numpy as np

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
    conn.commit()
    return conn


def engine_rows(rs) -> list:
    return [tuple(_norm_engine_value(rs.columns[n][i], n) for n in rs.names)
            for i in range(rs.nrows)]


def same_rows(got, want) -> bool:
    """Multisets of rounded rows equal, floats to rel 1e-4, abs 1e-2."""
    if len(got) != len(want):
        return False
    ok = True
    for g, w in zip(sorted(got, key=repr), sorted(want, key=repr)):
        for gv, wv in zip(g, w):
            if isinstance(gv, float) or isinstance(wv, float):
                ok &= (gv is not None and wv is not None
                       and abs(gv - wv) <= max(1e-2, 1e-4 * abs(wv)))
            else:
                ok &= gv == wv
    return bool(ok)


def analytic_sqlite_checks(tiny, tiny_ds, Session, uk, uk_ds,
                           ds_stmts) -> list[dict]:
    """The analytic statements on the card against sqlite (3.39 or later:
    windows, set operations and FULL/RIGHT joins). sqlite lacks ROLLUP,
    CUBE, INTERSECT ALL, EXCEPT ALL and approx_count_distinct, so R1/R2
    hold to the union of their plain group-bys, U3/U3E to the bag counts
    of their two sides, D2 to count(distinct) and A1 to the plain
    estimate (the port's Session on the CPU, whose wrappers run the plain
    versions). W3's RANGE frame orders by julianday(), since the dates are
    text there."""
    import itertools
    import sqlite3
    from collections import Counter

    require(sqlite3.sqlite_version_info >= (3, 39),
            f"sqlite {sqlite3.sqlite_version} lacks FULL/RIGHT JOIN")
    conns = {"tpch": sqlite_conn(tiny), "tpcds": sqlite_conn(tiny_ds)}
    card = {"tpch": Session(tiny, unique_keys=uk, device="cuda"),
            "tpcds": Session(tiny_ds, unique_keys=uk_ds, device="cuda")}
    cpu = Session(tiny, unique_keys=uk, device="cpu")

    def fetch(conn, text):
        return [tuple(_norm(v) for v in row)
                for row in conn.execute(to_sqlite(text)).fetchall()]

    def grouping_union(conn, parts, sets):
        table, where, keys, aggs = parts
        rows = []
        for present in sets:
            cols = [k if k in present else f"null as {k}" for k in keys]
            grp = f"group by {', '.join(present)}" if present else ""
            rows += fetch(conn, f"select {', '.join(cols)}, {aggs} "
                                f"from {table} {where} {grp}")
        return rows

    def bag(conn, intersect):
        left = Counter(r[0] for r in fetch(conn, U3_SIDES[0]))
        right = Counter(r[0] for r in fetch(conn, U3_SIDES[1]))
        keep = {v: (min(c, right[v]) if intersect
                    else max(c - right[v], 0)) for v, c in left.items()}
        return [(sum(keep.values()), sum(v * c for v, c in keep.items()))]

    out, bad = [], []
    stmts = list(ANALYTIC.items()) + [(n, (t, "tpcds")) for n, t in ds_stmts]
    for name, (text, data) in stmts:
        conn = conns[data]
        if name == "R1":
            keys = R1_PARTS[2]
            want = grouping_union(conn, R1_PARTS, [keys[:i] for i in
                                                   range(len(keys), -1, -1)])
        elif name == "R2":
            keys = R2_PARTS[2]
            want = grouping_union(conn, R2_PARTS, [
                c for r in range(len(keys), -1, -1)
                for c in itertools.combinations(keys, r)])
        elif name in ("U3", "U3E"):
            want = bag(conn, name == "U3")
        elif name == "A1":
            want = engine_rows(cpu.sql(text))
        else:
            text_sql = text
            if name == "W3":
                text_sql = text.replace("order by o_orderdate",
                                        "order by julianday(o_orderdate)")
            if name == "D2":
                text_sql = text.replace("approx_count_distinct(o_custkey)",
                                        "count(distinct o_custkey)")
            want = fetch(conn, text_sql)
        got = engine_rows(card[data].sql(text))
        ok = same_rows(got, want)
        out.append({"statement": name, "rows": len(got),
                    "oracle_rows": len(want), "match": ok})
        print(f"sqlite {name}: {len(got)} rows, oracle {len(want)}, "
              + ("match" if ok else f"DIFFER {got[:3]} vs {want[:3]}"),
              flush=True)
        if not ok:
            bad.append(name)
    for c in conns.values():
        c.close()
    require(not bad, f"analytic results differ from their oracles: {bad}")
    return out


def card_vs_cpu(tables, Session, unique_keys, stmts, setup=None,
                route=None) -> list[dict]:
    """Every statement on the card and on the CPU (the plain versions) over
    the same small tables: each column must hold the same bits, floats
    too, since both run the same IEEE operations. A difference is reported
    by column, with its largest ulp and relative distance for floats.
    `setup(session)` configures both sessions (a device budget), and
    `route(name, rs)` checks each result's plan."""
    import numpy as np

    card = Session(tables, unique_keys=unique_keys, device="cuda")
    cpu = Session(tables, unique_keys=unique_keys, device="cpu")
    for se in (card, cpu):
        if setup is not None:
            setup(se)
    out, bad = [], []
    for name, text in stmts:
        crs, prs = card.sql(text), cpu.sql(text)
        if route is not None:
            route(name, crs)
            route(name, prs)
        got = crs.storage_columns()
        want = prs.storage_columns()
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


def release_device() -> None:
    """Free the device memory of dropped sessions before the next phase
    (an executor's program closure is a reference cycle, so only the
    cyclic collector frees its cached columns), so that each phase's
    peak memory counts its own tensors."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def q6_text(queries_text, year: int) -> str:
    """TPC-H Q6 over shipping year `year` (the suite's text has 1994)."""
    return queries_text[6].replace("1995-01-01", f"{year + 1}-01-01") \
        .replace("1994-01-01", f"{year}-01-01")


def same_bits(got: dict, want: dict) -> bool:
    import numpy as np

    return list(got) == list(want) and all(
        np.asarray(got[c]).dtype == np.asarray(want[c]).dtype
        and np.asarray(got[c]).tobytes() == np.asarray(want[c]).tobytes()
        for c in want)


def range_oracle(lineitem, lo: str, hi: str) -> dict:
    import numpy as np

    from oceanbase_tpu_torch.models.tpch.queries import _day

    d = lineitem.data
    m = (d["l_shipdate"] >= _day(lo)) & (d["l_shipdate"] < _day(hi))
    return {"s": np.array([int(d["l_extendedprice"][m].astype(np.int64)
                               .sum())]),
            "n": np.array([int(m.sum())])}


def grace_oracles(tables) -> dict:
    """int64 oracles of the grace statements: per order priority, the
    quantity sum and count of the lines under 30 units; and the first 7
    order keys' quantity sums and distinct line numbers (lineitem is
    stored by l_orderkey, so they lie in its first rows)."""
    import numpy as np

    li, od = tables["lineitem"].data, tables["orders"].data
    m = li["l_quantity"] < 3000
    okeys = np.asarray(od["o_orderkey"], dtype=np.int64)
    order = np.argsort(okeys, kind="stable")
    pos = np.searchsorted(okeys[order], li["l_orderkey"][m])
    prio = np.asarray(od["o_orderpriority"])[order][pos].astype(np.int64)
    codes = np.unique(prio)  # the dictionary is sorted: code order = text
    cnt = np.bincount(prio, minlength=int(codes.max()) + 1)
    # float64 sums of integers far below 2**53 are exact
    qsum = np.bincount(prio, weights=li["l_quantity"][m],
                       minlength=int(codes.max()) + 1).astype(np.int64)
    lk = np.asarray(li["l_orderkey"], dtype=np.int64)
    head = lk[:4096]
    first = np.unique(head)[:7]
    require(int(lk[4096:].min(initial=first[-1] + 1)) > int(first[-1]),
            "lineitem is not stored by l_orderkey")
    q = np.array([int(li["l_quantity"][:4096][head == k].astype(np.int64)
                      .sum()) for k in first])
    dl = np.array([len(np.unique(li["l_linenumber"][:4096][head == k]))
                   for k in first])
    return {
        "G_JOIN": {"o_orderpriority": codes, "qty": qsum[codes],
                   "cnt": cnt[codes]},
        "G_GROUPBY": {"l_orderkey": first, "q": q, "dl": dl},
    }


def _join_of(prepared):
    from oceanbase_tpu_torch.engine.executor import _number_nodes
    from oceanbase_tpu_torch.sql.logical import JoinOp

    return next(op for op in _number_nodes(prepared.plan).values()
                if isinstance(op, JoinOp))


def projection_phase(tables, Session, uk, kernels, queries_text, oracles,
                     resident, warm) -> tuple[list, dict, dict]:
    """The sorted-projection path: build lineitem#sp:l_shipdate, run the
    projection statements through a fresh Session (launch counts from 0),
    capture K17's arguments from one more Q6 run, drop the projection.
    Returns (statement records, launches, K17 arguments)."""
    import oceanbase_tpu_torch.engine.executor as ex
    from oceanbase_tpu_torch.storage.sorted_projection import (
        drop_projections,
        make_sorted_projection,
        projection_name,
    )

    li = tables["lineitem"]
    pname = projection_name("lineitem", "l_shipdate")
    t0 = time.perf_counter()
    make_sorted_projection(tables, "lineitem", "l_shipdate", cols=SP_COLS)
    print(f"projection {pname} over {len(SP_COLS)} columns built in "
          f"{time.perf_counter() - t0:.3f} s (host)", flush=True)
    psess = Session(tables, unique_keys=uk, device="cuda")

    def sliced(name):
        def after(rs):
            prep = rs._cursor.prepared
            scans = [s.table for s in prep.executor._collect_scans(prep.plan)]
            require(pname in scans, f"{name}: the scan did not route to "
                    f"{pname} ({scans})")
            require(bool(prep.params.scan_slice), f"{name}: no slice")
            return {"scans": scans, "scan_cap": list(
                prep.params.scan_cap.values())}
        return after

    def q14_after(rs):
        out = sliced("P_Q14")(rs)
        prep = rs._cursor.prepared
        join = _join_of(prep)
        build = [s.table for s in prep.executor._collect_scans(join.right)]
        probe = [s.table for s in prep.executor._collect_scans(join.left)]
        require(prep.executor._affine_build_info(join) is not None
                and build == ["part"] and probe == [pname],
                f"P_Q14: not the affine join of part over the sliced "
                f"lineitem (build {build}, probe {probe})")
        return out

    def wide_after(rs):
        prep = rs._cursor.prepared
        require(list(prep.params.scan_cap.values()) == [1 << 62],
                "P_WIDE: the overflow did not bump the slice to a full "
                "scan")
        return {"retries": prep.retries}

    def base_after(rs):
        prep = rs._cursor.prepared
        scans = [s.table for s in prep.executor._collect_scans(prep.plan)]
        require(scans == ["lineitem"], f"P_Q1 routed to {scans}")
        return {"scans": scans}

    def exact(name):
        def check(rs):
            rows = oracles[name](rs)
            require(same_bits(rs.storage_columns(), resident[name]),
                    f"{name}: differs from the default Session's rows")
            return rows
        return check

    stmts = [
        ("P_Q6", queries_text[6], sliced("P_Q6")),
        ("P_Q6_1995", q6_text(queries_text, 1995), sliced("P_Q6_1995")),
        ("P_Q14", queries_text[14], q14_after),
        ("P_NARROW", P_RANGE.format(lo=P_NARROW[0], hi=P_NARROW[1]),
         sliced("P_NARROW")),
        ("P_WIDE", P_RANGE.format(lo=P_WIDE[0], hi=P_WIDE[1]), wide_after),
        ("P_Q1", queries_text[1], base_after),
    ]
    kernels.reset_launches()
    recs = [run_statement(psess, kernels, name, text, exact(name), warm,
                          li.nrows, after=after)
            for name, text, after in stmts]
    launches = dict(kernels.LAUNCHES)
    require(launches["K17_slice_scan"] > 0,
            "K17 was never launched on the projection path")
    rebound = next(r for r in recs if r["statement"] == "P_Q6_1995")
    require(rebound["fast_path_hit"],
            "P_Q6_1995 did not reuse Q6's plan through the text tier")
    cap = capture_args(psess, queries_text[6], {
        "K17_slice_scan": (ex, "slice_scan",
                           lambda key, n, lo, hi, c, pay, sel: c)})
    del psess
    drop_projections(tables, "lineitem")
    require(pname not in tables, "drop_projections left the projection")
    return recs, launches, cap


def stream_phase(tables, Session, uk, kernels, queries_text, oracles,
                 resident, warm, budget: int):
    """The streamed path: Q1, Q6, Q3 and Q14 under `budget` and a memory
    governor of the same size, then Q1 in each A/B leg, then one more Q3
    run whose largest K18 call is kept. Returns (records, launches, A/B
    legs, K18 arguments)."""
    from oceanbase_tpu_torch.engine.chunked import ChunkedPreparedPlan
    from oceanbase_tpu_torch.engine.memory_governor import MemoryGovernor

    li = tables["lineitem"]
    ssess = Session(tables, unique_keys=uk, device="cuda")
    gov = MemoryGovernor(budget=budget)
    ssess.executor.device_budget = budget
    ssess.executor.governor = gov
    runs = warm + 2

    def after_of(name):
        def after(rs):
            prep = rs._cursor.prepared
            require(isinstance(prep, ChunkedPreparedPlan),
                    f"{name}: prepared {type(prep).__name__}, not streamed")
            require(gov.ledger_balanced(),
                    f"{name}: the governor's ledger is not balanced")
            ss = prep.stream_stats
            ph = ssess.last_phases
            out = {"split": prep.kind, "chunk_rows": prep.chunk_rows,
                   "chunks_per_run": ss.chunks / runs,
                   "wire_bytes_per_run": ss.staged_bytes / runs,
                   "decoded_bytes_per_run": ss.decoded_bytes / runs,
                   "h2d_s_per_run": ss.h2d_s / runs,
                   "compute_s_per_run": ss.compute_s / runs,
                   "overlap_s_per_run": ss.overlap_s / runs,
                   "last_run_phases": {k: v for k, v in ph.items()
                                       if k.startswith("stream_")},
                   "peak_staged_bytes": gov.peak_staged}
            print(f"{name}: split {prep.kind}, {prep.chunk_rows} chunk rows, "
                  f"{ss.chunks / runs:g} chunks per run, wire "
                  f"{ss.staged_bytes / runs:.6g} B of "
                  f"{ss.decoded_bytes / runs:.6g} B decoded per run, h2d "
                  f"{ss.h2d_s / runs:.6f} s, compute "
                  f"{ss.compute_s / runs:.6f} s, overlap "
                  f"{ss.overlap_s / runs:.6f} s per run, staged peak "
                  f"{gov.peak_staged} B", flush=True)
            return out
        return after

    def exact(name):
        def check(rs):
            rows = oracles[name](rs)
            require(same_bits(rs.storage_columns(), resident[name]),
                    f"{name}: differs from the resident rows")
            return rows
        return check

    stmts = [("ST_Q1", queries_text[1]), ("ST_Q6", queries_text[6]),
             ("ST_Q3", queries_text[3]), ("ST_Q14", queries_text[14])]
    kernels.reset_launches()
    recs = [run_statement(ssess, kernels, name, text, exact(name), warm,
                          li.nrows, after=after_of(name))
            for name, text in stmts]
    launches = dict(kernels.LAUNCHES)
    require(launches["K18_decode_staged"] > 0,
            "K18 was never launched on the streamed path")
    legs = []
    for depth in (0, 2):
        for compress in (True, False):
            ssess.executor.stream_prefetch_depth = depth
            ssess.executor.stream_compress = compress
            t0 = time.perf_counter()
            rs = ssess.sql(queries_text[1])
            got = rs.storage_columns()
            wall = time.perf_counter() - t0
            ph = ssess.last_phases
            require(same_bits(got, resident["ST_Q1"]),
                    f"Q1 leg depth {depth} compress {compress} differs")
            require(gov.ledger_balanced(), "A/B leg left the ledger open")
            if depth == 0:
                require(ph["stream_overlap_s"] == 0.0,
                        "no prefetch, yet h2d overlapped compute")
            leg = {"depth": depth, "compress": compress, "wall_s": wall,
                   **{k: ph[k] for k in ("stream_h2d_s", "stream_compute_s",
                                         "stream_overlap_s")}}
            legs.append(leg)
            print(f"ST_Q1 leg prefetch depth {depth}, compress {compress}: "
                  f"{wall:.6f} s wall, h2d {leg['stream_h2d_s']:.6f} s, "
                  f"compute {leg['stream_compute_s']:.6f} s, overlap "
                  f"{leg['stream_overlap_s']:.6f} s, rows identical",
                  flush=True)
    ssess.executor.stream_prefetch_depth = 2
    ssess.executor.stream_compress = True
    cap = capture_args(ssess, queries_text[3], {
        "K18_decode_staged": (kernels, "decode_staged",
                              lambda st, b, count, *rest: count)})
    require(gov.ledger_balanced(), "the streamed phase left the ledger open")
    return recs, launches, legs, cap


def grace_phase(tables, Session, uk, kernels, oracles, resident, warm,
                budget: int):
    """The grace-hash path: the join and the keyed group-by under
    `budget`; returns (records, launches)."""
    from oceanbase_tpu_torch.engine.memory_governor import MemoryGovernor
    from oceanbase_tpu_torch.engine.pipeline import GraceHashPreparedPlan

    li = tables["lineitem"]
    gsess = Session(tables, unique_keys=uk, device="cuda")
    gov = MemoryGovernor(budget=budget)
    gsess.executor.device_budget = budget
    gsess.executor.governor = gov

    def after_of(name, mode):
        def after(rs):
            prep = rs._cursor.prepared
            require(isinstance(prep, GraceHashPreparedPlan)
                    and prep.mode == mode,
                    f"{name}: prepared {type(prep).__name__}, not grace "
                    f"{mode}")
            require(gov.ledger_balanced(), f"{name}: ledger not balanced")
            print(f"{name}: grace {mode}, {prep.n_parts} partitions, "
                  f"split {prep.kind}", flush=True)
            return {"mode": mode, "partitions": prep.n_parts,
                    "split": prep.kind}
        return after

    def exact(name):
        def check(rs):
            rows = oracles[name](rs)
            require(same_bits(rs.storage_columns(), resident[name]),
                    f"{name}: differs from the resident rows")
            return rows
        return check

    kernels.reset_launches()
    recs = [run_statement(gsess, kernels, name, text, exact(name), warm,
                          li.nrows, after=after_of(name, mode))
            for name, text, mode in (("G_JOIN", GRACE_JOIN, "join"),
                                     ("G_GROUPBY", GRACE_GROUPBY,
                                      "groupby"))]
    return recs, dict(kernels.LAUNCHES)


def prepare_checks(kernels, reps: int, k17: dict, k18: dict) -> list:
    """K17 on Q6's projection run and K18 on one streamed Q3 chunk and on
    a synthetic chunk, each against its plain version (every bit, floats
    compared as their bit patterns), twice, timed beside its yardstick and
    its bound."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.engine.pipeline import Uploader

    out = []

    def bits(ts):
        res = []
        for t in ts:
            if t.dtype == torch.float64:
                t = t.view(torch.int64)
            elif t.dtype == torch.float32:
                t = t.view(torch.int32)
            res.append(t)
        return res

    def record(name, k_fn, p_fn, lib_fn, nbytes, ops):
        got, want = bits(k_fn()), bits(p_fn())
        require(len(got) == len(want), f"{name}: outputs differ in number")
        for g, w in zip(got, want):
            require(g.dtype == w.dtype and g.shape == w.shape
                    and torch.equal(g, w),
                    f"{name}: differs from the plain version")
        for g, a in zip(got, bits(k_fn())):
            require(torch.equal(g, a), f"{name}: two runs differ")
        km = cuda_ms(k_fn, reps)
        pm = cuda_ms(p_fn, max(1, reps // 2))
        lm = cuda_ms(lib_fn, reps)
        bm, by = bound_ms(nbytes, ops)
        src, rep = KERNEL_META[name]
        print(f"kernel {name}: match exact, two runs bit-identical, "
              f"kernel_ms {km:.6f}, plain_ms {pm:.6f}, library_ms {lm}, "
              f"bound_ms {bm:.6f} ({by})", flush=True)
        return {"name": name, "route": "cuda", "source": src,
                "replaces": rep, "max_abs_err": 0.0, "ms": km,
                "plain_ms": pm, "bound_ms": bm, "bound_by": by,
                "library_ms": lm}

    # K17 at Q6's projection shape: the sliced columns, validity and sel
    key, n, lows, highs, cap, pay, sel = k17["K17_slice_scan"]

    def k17_run(fn):
        def run():
            outs, osel, nrows, ovf = fn(key, n, lows, highs, cap, pay, sel)
            return [*outs, osel, nrows, ovf]
        return run

    def k17_library():
        # the yardstick reads the range's start on the host (narrow needs
        # a host offset); the kernel never does
        kcol = key[:n]
        lo = max(int(torch.searchsorted(kcol, v.to(kcol.dtype).reshape(1),
                                        right=s == "right")[0])
                 for v, s in lows) if lows else 0
        start = min(lo, int(sel.shape[0]) - cap)
        return [c.narrow(0, start, cap).clone() for c in [*pay, sel]]

    k17_bytes = 2 * cap * (sum(c.element_size() for c in pay) + 1)
    out.append(record("K17_slice_scan", k17_run(kernels.slice_scan),
                      k17_run(kernels.slice_scan_plain), k17_library,
                      k17_bytes, cap * (len(pay) + 1)))

    # K18 at one streamed Q3 chunk, and at a synthetic chunk of the same
    # capacity with validity bits, exactly full runs and raw float64
    staged, bases, count, meta, ccap, dtypes, dev = k18["K18_decode_staged"]
    rng = np.random.default_rng(20240)
    run_cap = 1 << max(1, (ccap // 2).bit_length() - 1)
    per = ccap // run_cap
    flt = rng.standard_normal(ccap)
    flt[::7] = -0.0
    flt[3::11] = np.nan
    syn = {
        "#v:x": rng.integers(0, 256, (ccap + 7) >> 3).astype(np.uint8),
        "r": (rng.integers(0, 2**32 - 1, run_cap).astype(np.uint32),
              np.full(run_cap, per, np.int32)),
        "f": flt,
        "d": rng.integers(0, 60_000, ccap).astype(np.uint16),
    }
    syn_tree = Uploader(dev).put(syn)[0]
    torch.cuda.synchronize()
    syn_bases = {"r": np.int64(-(2**40)), "f": np.float64(0.0),
                 "d": np.int32(-5)}
    syn_meta = (("#v:x", "bits"), ("d", "for"), ("f", "raw"), ("r", "rle"))
    syn_dtypes = {"#v:x": torch.bool, "r": torch.int64, "f": torch.float64,
                  "d": torch.int32}
    cases = [(staged, bases, count, meta, dtypes),
             (syn_tree, syn_bases, run_cap * per, syn_meta, syn_dtypes)]

    def k18_run(fn):
        def run():
            res = []
            for st, b, c, m, dt in cases:
                cols, s = fn(st, b, c, m, ccap, dt, dev)
                res.extend(cols[k] for k, _kind in m)
                res.append(s)
            return res
        return run

    def k18_library():
        # .to(dtype) + base, repeat_interleave and shift-and-mask
        res = []
        idx = torch.arange(ccap, device=dev)
        for st, b, c, m, dt in cases:
            for k, kind in m:
                if kind == "bits":
                    res.append(((st[k][idx >> 3] >> (idx & 7)) & 1) != 0)
                elif kind == "rle":
                    vals, lens = st[k]
                    v = kernels._widen_plain(vals).repeat_interleave(
                        lens.to(torch.int64))
                    res.append(v.to(dt[k]) + int(b[k]))
                else:
                    res.append(kernels._widen_plain(st[k]).to(dt[k])
                               + b[k].item())
        return res

    def nbytes_of(tree):
        total = 0
        for v in tree.values():
            for a in (v if isinstance(v, tuple) else (v,)):
                total += a.numel() * a.element_size()
        return total

    wire = nbytes_of(staged) + nbytes_of(syn_tree)
    decoded = sum(ccap * torch.empty((), dtype=dt[k]).element_size()
                  for _st, _b, _c, m, dt in cases for k, _kind in m)
    out.append(record("K18_decode_staged", k18_run(kernels.decode_staged),
                      k18_run(kernels.decode_staged_plain), k18_library,
                      wire + decoded + 2 * ccap,
                      ccap * (len(meta) + len(syn_meta))))
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
    from oceanbase_tpu_torch.models import tpcds
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

    t0 = time.perf_counter()
    ds_tables = tpcds.datagen.generate(sf=args.sf, seed=DS_SEED)
    ss = ds_tables["store_sales"]
    print(f"TPC-DS datagen sf {args.sf}: {ss.nrows} store_sales rows in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    sess = Session(tables, unique_keys=sql_suite.UNIQUE_KEYS, device="cuda")
    ds_sess = Session(ds_tables, unique_keys=tpcds.UNIQUE_KEYS,
                      device="cuda")
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
        **analytic_oracles(tables),
    }
    print(f"join and analytic oracles in {time.perf_counter() - t0:.3f} s",
          flush=True)

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
    ds_stmts = [(f"DS{q}", tpcds.QUERIES[q]) for q in DS_QUERIES]
    runs = [(sess, name, text, check, li.nrows, "lineitem")
            for name, text, check in stmts]
    for name, (text, data) in ANALYTIC.items():
        if name == "A1":
            check = (lambda rs: check_a1(rs, sess, kernels))
        elif name in refs:
            check = oracle(name)
        else:
            check = (lambda rs, name=name: check_sane(name, rs))
        if data == "tpch":
            runs.append((sess, name, text, check, li.nrows, "lineitem"))
        else:
            runs.append((ds_sess, name, text, check, ss.nrows, "store_sales"))
    for name, text in ds_stmts:
        runs.append((ds_sess, name, text,
                     lambda rs, name=name: check_sane(name, rs), ss.nrows,
                     "store_sales"))
    # the main path: counts at 0 just before, read just after
    kernels.reset_launches()
    stmt_recs = [
        run_statement(se, kernels, name, text, check, args.warm, rows, fact)
        for se, name, text, check, rows, fact in runs
    ]
    main_launches = dict(kernels.LAUNCHES)
    rebound = next(r for r in stmt_recs if r["statement"] == "S1_rebound")
    require(rebound["fast_path_hit"],
            "rebound S1 did not reuse the cached plan through the text tier")
    for k in MAIN_KERNELS:
        require(main_launches[k] > 0,
                f"kernel {k} was never launched on the main path")
    for k in ("K17_slice_scan", "K18_decode_staged"):
        require(main_launches[k] == 0, f"{k} ran on the resident main path")
    # the route guard: at the card's default budget every statement above
    # prepared a resident plan
    budget = sess.executor.device_budget
    streamed = [r["statement"] for r in stmt_recs
                if r["plan"] != "PreparedPlan"]
    require(not streamed, f"statements left the resident route at the "
            f"default budget {budget} B: {streamed}")
    print(f"route guard: all {len(stmt_recs)} statements prepared a "
          f"resident PreparedPlan at the card's default device budget "
          f"{budget} B", flush=True)
    for r in stmt_recs:
        del r["result"]

    main_entries = dict(kernels.ENTRY_LAUNCHES)
    for k, v in main_entries.items():
        require(v > 0, f"{k} was never run on the main path")

    captured = capture_join_kernels(sess, kernels, sql_suite.QUERIES)
    captured.update(capture_analytic_kernels(sess, kernels))
    krecs = kernel_checks(sess, kernels, args.reps, captured)
    del captured
    frecs = float_checks(sess, kernels)
    # the statement list holds both sessions (and their cached columns)
    del sess, ds_sess, runs
    release_device()
    t0 = time.perf_counter()
    tiny = datagen.generate(sf=SQLITE_SF, seed=args.seed)
    srecs = sqlite_checks(tiny, Session, sql_suite.UNIQUE_KEYS,
                          [(q, sql_suite.QUERIES[q]) for q in range(1, 23)])
    tiny_ds = tpcds.datagen.generate(sf=SQLITE_SF, seed=DS_SEED)
    arecs = analytic_sqlite_checks(tiny, tiny_ds, Session,
                                   sql_suite.UNIQUE_KEYS, tpcds.UNIQUE_KEYS,
                                   ds_stmts)
    print(f"sqlite phase in {time.perf_counter() - t0:.3f} s", flush=True)
    small = datagen.generate(sf=CMP_SF, seed=args.seed)
    small_ds = tpcds.datagen.generate(sf=CMP_SF, seed=DS_SEED)
    # every statement: all 22 queries, S1 twice, T1, the analytic ones and
    # the TPC-DS star queries
    crecs = card_vs_cpu(small, Session, sql_suite.UNIQUE_KEYS,
                        [(name, text) for name, text, _check in stmts]
                        + [(n, t) for n, (t, d) in ANALYTIC.items()
                           if d == "tpch"])
    crecs += card_vs_cpu(small_ds, Session, tpcds.UNIQUE_KEYS,
                         [(n, t) for n, (t, d) in ANALYTIC.items()
                          if d == "tpcds"] + ds_stmts)
    del small_ds, tiny, tiny_ds
    release_device()

    # ---- the rest of Executor.prepare: each path its own counts --------
    Q = sql_suite.QUERIES
    uk = sql_suite.UNIQUE_KEYS
    p_texts = {
        "P_Q6": Q[6], "P_Q6_1995": q6_text(Q, 1995), "P_Q14": Q[14],
        "P_NARROW": P_RANGE.format(lo=P_NARROW[0], hi=P_NARROW[1]),
        "P_WIDE": P_RANGE.format(lo=P_WIDE[0], hi=P_WIDE[1]),
        "P_Q1": Q[1],
    }
    st_texts = {"ST_Q1": Q[1], "ST_Q6": Q[6], "ST_Q3": Q[3], "ST_Q14": Q[14]}
    g_texts = {"G_JOIN": GRACE_JOIN, "G_GROUPBY": GRACE_GROUPBY}
    t0 = time.perf_counter()
    rsess = Session(tables, unique_keys=uk, device="cuda")
    resident = {name: rsess.sql(text).storage_columns()
                for name, text in {**p_texts, **st_texts, **g_texts}.items()}
    del rsess
    release_device()
    goracles = grace_oracles(tables)
    print(f"resident rows and grace oracles of the prepare phases in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def q1_check(rs):
        return check_q1(rs, li, queries)

    def ref_check(name, ref):
        return lambda rs: check_oracle(name, rs, ref)

    oracles = {
        "P_Q6": ref_check("P_Q6", {"revenue": queries.q6_numpy(li)}),
        "P_Q6_1995": ref_check("P_Q6_1995", {"revenue": queries.q6_numpy(
            li, "1995-01-01", "1996-01-01")}),
        "P_Q14": ref_check("P_Q14", refs["Q14"]),
        "P_NARROW": ref_check("P_NARROW", range_oracle(li, *P_NARROW)),
        "P_WIDE": ref_check("P_WIDE", range_oracle(li, *P_WIDE)),
        "P_Q1": q1_check, "ST_Q1": q1_check,
        "ST_Q6": ref_check("ST_Q6", {"revenue": queries.q6_numpy(li)}),
        "ST_Q3": ref_check("ST_Q3", refs["Q3"]),
        "ST_Q14": ref_check("ST_Q14", refs["Q14"]),
        "G_JOIN": ref_check("G_JOIN", goracles["G_JOIN"]),
        "G_GROUPBY": ref_check("G_GROUPBY", goracles["G_GROUPBY"]),
    }
    t0 = time.perf_counter()
    precs, p_launches, k17_args = projection_phase(
        tables, Session, uk, kernels, Q, oracles, resident, args.warm)
    release_device()
    print(f"projection phase in {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    stream_budget = int(STREAM_BUDGET_SF10 * args.sf / 10)
    strecs, st_launches, legs, k18_args = stream_phase(
        tables, Session, uk, kernels, Q, oracles, resident, args.warm,
        stream_budget)
    release_device()
    print(f"streamed phase (budget {stream_budget} B) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    grace_budget = int(GRACE_BUDGET_SF10 * args.sf / 10)
    # the grace statements spend ~20 s a run on the host at SF 10: a cold
    # and a traced run each keep the whole script inside half its limit
    grecs, g_launches = grace_phase(tables, Session, uk, kernels, oracles,
                                    resident, 0, grace_budget)
    release_device()
    print(f"grace phase (budget {grace_budget} B, no warm run) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for r in precs + strecs + grecs:
        del r["result"]
    krecs += prepare_checks(kernels, args.reps, k17_args, k18_args)
    del k17_args, k18_args
    release_device()

    # card vs CPU at SF 0.1: the projection statements, and the streamed
    # ones under a budget that streams lineitem at this scale
    from oceanbase_tpu_torch.engine.chunked import ChunkedPreparedPlan
    from oceanbase_tpu_torch.storage.sorted_projection import (
        drop_projections,
        make_sorted_projection,
    )

    make_sorted_projection(small, "lineitem", "l_shipdate", cols=SP_COLS)
    crecs += card_vs_cpu(small, Session, uk, list(p_texts.items()))
    drop_projections(small, "lineitem")
    cmp_budget = int(STREAM_BUDGET_SF10 * CMP_SF / 10)

    def streamed(name, rs):
        require(isinstance(rs._cursor.prepared, ChunkedPreparedPlan),
                f"card vs CPU {name}: did not stream at {cmp_budget} B")

    crecs += card_vs_cpu(
        small, Session, uk, list(st_texts.items()),
        setup=lambda se: setattr(se.executor, "device_budget", cmp_budget),
        route=streamed)

    phase_launches = {"projection": p_launches, "streamed": st_launches,
                      "grace": g_launches}
    for r in krecs:
        if r["name"] == "K17_slice_scan":
            r["launches"] = p_launches[r["name"]]
        elif r["name"] == "K18_decode_staged":
            r["launches"] = st_launches[r["name"]]
        else:
            r["launches"] = (main_launches[r["name"]]
                             if r["name"] in main_launches
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
                   "lineitem_rows": li.nrows, "store_sales_rows": ss.nrows,
                   "statements": stmt_recs,
                   "prepare_phases": {
                       "projection": precs, "streamed": strecs,
                       "stream_ab_legs": legs, "grace": grecs,
                       "stream_budget": stream_budget,
                       "grace_budget": grace_budget,
                       "default_budget": budget,
                       "launches": phase_launches},
                   "kernels": krecs, "float_checks": frecs,
                   "sqlite": {"sf": SQLITE_SF, "queries": srecs,
                              "analytic": arecs},
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
