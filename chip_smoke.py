#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Builds the port's CUDA kernels from `oceanbase_tpu_torch/csrc`, generates
TPC-H at SF 10 (seed 19920101), and drives the port's main path through
`Session(..., device="cuda").sql(...)`: Q1, Q6, the sorted selective scan
S1 and S1 again with a rebound date literal, the join statements Q14, Q3,
Q10, Q7, Q8 and Q19, a tie-heavy ORDER BY ... LIMIT (T1, whose top-k
prefilter overflows and re-runs through the full sort), a FROM-list cross
join of one week of orders with every region (X1), and the other 14
TPC-H queries (merge joins, expansion joins, semi/anti/left joins,
DISTINCT), each once cold and `--warm` times warm, then once more under
torch.profiler for its device busy time. The results with an int64 numpy
oracle (Q1, Q6, S1, Q14, Q3, Q10, Q7, Q8, Q19, T1, X1, Q4, Q11, Q12, Q13,
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
bound. K3 (the one-sweep radix sort order) is also held twice, bit for
bit, to its plain version on edge cases of its plan, tiles and look-back
(`k3_synthetic`: 0, 1, a tile - 1, a tile and a tile + 1 rows, every or
no row dead, constant keys, spans of 1 to 64 bits in every image mode,
trivial digits, least significant keys already in row order, DESC on
minimums, NaN and -0.0, two composites, seventy keys), and run
K3_REPEAT_RUNS times at K3_REPEAT_ROWS rows with bit-identical orders.
K15 runs at D1's shape on its image route (K3's sorted images), with its
record and columns routes forced beside it, and on `k15_cases`' edge
cases, each on the route `kernels.k15_route` gives it; K13's entries
are timed one by one at W1-W3's shapes and held on `k13_synthetic`'s
edge cases (ragged tiles, segments across many tiles, flags on every
row and none, NaN), float sums bit-identical over two runs; K17 and its
yardstick are also timed in turns over K17_ROUNDS rounds. K10 and K2 are
held to their plain versions on their edge shapes at card sizes
(`k10_edge_phase`: a run across many output tiles, tile edges, sorted
and random probes, wide windows, the total against the capacity, dead
sides, int64 extremes, unaligned views, Q21's kind; `k2_edge_phase`:
repeated aggregates, per-aggregate masks, every value type, NaN, a split
into several launches, odd views), with each call's launches counted by the
library where it makes them (K10: 2 an expansion, 1 a range search; K2:
its split plan). One more run
of Q18, Q20,
Q21, Q10, Q15, Q4, Q12, Q13 and S1 records each K3 call's rows, kept
keys and composites (bits, image width, row bits, passes). Every
expression tree the statements evaluate runs on K24 (the fused
expression kernel): each statement's trees on K24 and on the
torch route are counted, and no tree of the main path may take the
torch route. K24 is held bit for bit to its plain version on the card
and to the torch route's evaluate / compile_predicate on every program
of Q1, Q6, Q14, Q19, Q7, DS3 and W4, and on synthetic edge cases (NULL
planes, NaN and -0.0, negative decimals and days, int32 edges, an empty
sel, a capacity no multiple of the block, programs at and past one
launch's limits, float literals 0.0 and -0.0 in equal trees), and timed
on Q6's predicate; a tree the tracer cannot record must raise on the
card, never run on the torch route. Then all 22 queries and
the analytic statements run on the card at SF 0.01 against sqlite (ROLLUP/CUBE against the union of plain
group-bys, INTERSECT/EXCEPT ALL against bag counts, approx_count_distinct
against the plain estimate), and every statement runs on the card and on
the CPU at SF 0.1, where the two results must hold the same bits; so do
three cross joins, two JSON constructor statements and two recursive
CTEs.

The vector phase follows, with its own counts (before the rest of
prepare: after the streamed phase's prefetch threads, torch.profiler
records only part of a traced run's device events): the reference's ANN bench
deployment (tools/ann_bench.py: 1,000,000 x 128 float32 embeddings in 256
blobs, seed 4, grp = id % 10), each statement cold, warm over distinct
query vectors on one plan, and traced. V_BRUTE (no index) must equal
numpy's exact top-10; V_BUILD builds the IVF index (1024 lists) through
K19 (assignment) and K20 (list sums); V_L2 and V_F50 (`where grp < 5`,
the filter fused into the probe) take the IVF route (nprobe 32, K21 the
nearest lists, K22 the re-rank and top-k) on one cached plan at
recall@10 >= 0.9; V_DIST's distance column is held to float64; V_STARVE
(the reference tests' 20,000 x 32 table, `where blob = <a far blob>`)
starves the probe, escalates nprobe to every list and must then equal
the exact filtered top-10. Ids compare by the margin rule: two rows may
swap where their exact distances differ by less than 1e-5 x (|x|^2 +
|q|^2), the scale of float32 rounding in a dot product summed in another
order. K19-K22 are held to their plain versions on the phase's arguments
and on a synthetic case (8192 lists, ties, a long list, dead rows; K20
bit for bit against the CPU) and timed; at 20,000 x 32 the card's
statements equal the CPU's on the CPU-built index carried across, and
the card's own build equals the CPU's perm and lengths.

The server phase follows, with its own counts: a Database(n_nodes=1,
n_ls=1) of the port on the card with the TPC-H tables preloaded, its
MySQL wire front on localhost and a minimal protocol-41 client. Q1, Q6,
Q3 and Q14 run through the engine Session (held to the int64 oracles),
then through DbSession.sql with the result cache off (cold, warm
fast-tier hits on the narrowed result frame, one traced run), from the
result cache (no device work on a hit) and over the wire, every time
with the engine's rows bit for bit. A year of shipments (~9.1M live
rows at SF 10) is fetched LIMIT 10 and LIMIT 1000 through K23; a
point-range read narrows its frame through K23; a LEFT JOIN onto 40
columns (83 columns and validity planes) goes through K23 in its
narrowed frame and its head fetch; a served table is loaded by
multi-row INSERTs, updated and deleted against a numpy model, with the
result cache invalidated by the writes; the degraded rungs (and the
card's refusal of the host rung) and the profiled-run fallback must
stay untaken. K23 is held to its plain version bit for bit on the
phase's arguments and on synthetic edge cases, and timed. Small results
of the main path and the vector statements are timed with the narrowed
frame off, on, and on with K23 forced (the narrowed frame's A/B).

The PX phase follows, in two legs with their own counts. Leg 1, in the
server phase's Database after its statements: `SET ob_px_dop = 1`, so
Q1, Q6, Q3 and Q14 run through DbSession.sql on Database._px_executor()
(make_mesh() over the card: one shard, in the caller's thread), cold,
warm and traced; their rows bit-identical to the same session's at dop 0
and held to the int64 oracles, no `px fallbacks`, the PX admission quota
back at its target. Leg 2, just before the batched phase and untraced
(its shards run in threads): a PxExecutor over make_mesh(4, devices=
[cuda:0] * 4) runs Q1 and Q6 (partials merged by K27), Q3 and Q18 (hash
exchanges on K25 + K26), a DISTINCT over every lineitem row, the range
sort of every lineitem row (tests/test_px_range.py's statement; bounds
by K28) and a hybrid-hash join of a zipf-skewed fact of 2^20 rows a
shard (hot buckets and the join bloom by K28), each equal to the single
device executor's rows (floats to rel 1e-12); every one of K25-K28 must
launch. K25-K28 are held bit for bit to their plain versions on the
calls captured from leg 2 and on synthetic edge cases, twice, and timed
beside their plain versions, a library yardstick and their bounds.

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
and every one of the 46 statements above prepared a resident plan at the
card's default budget. K17 and K18 are held against their plain versions
on the arguments of Q6's projection run, of one streamed Q3 chunk and of
a synthetic chunk (validity bits, runs that exactly fill their capacity,
-0.0 and NaN), and the projection and streamed statements run on the
card and on the CPU at SF 0.1 with identical bits.

Out-of-core PX follows (after the streamed phase, untraced, its own
counts): leg 1, a Database of the port with `SET ob_px_dop = 1` and its
PX executor's budget at the streamed phase's 1 GiB, runs Q1, Q6 and Q3
through DbSession.sql, each a ChunkedPreparedPlan on the PX chunk source
(`_PxChunkSourceExecutor`: each chunk's narrowed host planes split over
the mesh and widened on the card by K18); leg 2, a PxExecutor over 4
shards of the card at the same budget (1/4 GiB a shard), runs Q1 and Q6
through PreparedPlan.run; each cold and twice warm, rows bit-identical
to the single device's streamed runs and held to the int64 oracles, `px
dtl host hops` equal to the chunks, K18 launched, no `px fallbacks`, the
governor's ledger balanced. The wide leg streams the sums of 40 bigint
columns (40 planes: K18 launches once per 32) under 256 MiB on one
device and on the 4 shards, both equal to numpy's sums. K18 is held bit
for bit to its plain version on one shard's chunk of leg 2 and on the
40-plane call, and timed. Then the spill phase (its own counts):
`partitioned_groupby_sum` (l_partkey, l_quantity) and
`partitioned_join_sum` (against part's p_partkey, p_size) over the first
2^23 lineitem rows in 8 hash partitions, and `external_sort` of the first
2^21 rows by (l_shipdate, l_orderkey desc) in runs of 2^19, each against
numpy with every spill segment freed, the device steps' time split from
the host's; then the device steps alone at deployment size: K3 over
2^23 packed uint64 keys (their int64 image), K29 over one hash partition
of all lineitem (~7.5M rows, ~250,000 groups) and a two-column group-by
with sum/count/min/max on int64 and float64 (group sets equal to the
plain version's, float sums to rel 1e-12), K14 + K30 over one partition
pair (exact, also with products that wrap), each timed.

The caps leg (after the main path's kernel checks, its own counts): the
statements that reach a wrapper past its old by-value width, at SF 10 on
the card (an INTERSECT and an EXCEPT over 18 key planes of a LEFT JOIN's
null-extended side: K14; a GROUP BY l_suppkey with 17 aggregates and one
over 17 key planes: K8; 17 sums over lineitem clustered by l_orderkey
joined to orders: K6; a self-join of lineitem on 9 integer columns: K12;
count(DISTINCT l_suppkey) under 8 nullable keys, 17 keys: K15), each past
its old cap at the call (the projection phase adds P_BOUNDS17, a range
of 17 conjuncts: K17 over 17 bounds), and at SF 0.1 with the card's bits
equal to the CPU's; every repaired wrapper (K5, K6,
K8, K12, K14, K15, K17, K22, K29) past its old cap against its plain
version on synthetic inputs, and K31's synthetic cases (1, 3 and 4
shards, k 10, 3000 and every candidate) bit for bit. The vector phase's
card-vs-CPU check adds LIMIT 4096 through K22. Late and untraced (their
shards run in threads or processes): the sharded ANN leg lays the vector
phase's deployment across 4 shards of the card (`parallel/ann.py`
shard_ivf, K21 + K31 + K26's all_gather), searches its 50 queries (ids
equal to the single device's IVF route by the margin rule, distances
within VEC_DIST_TOL of float64, the merge's all_gather in the MeshPlan),
and times K31's two entries on its calls; the multi-process leg spawns
2 ranks of one gloo process group, each holding 2 shards of the card (a
4-shard mesh across 2 processes), runs Q1, Q3 and Q6 at SF 1 through
PxExecutor.execute (both ranks' rows bit-identical to the parent's
4-shard single-process mesh and the int64 oracles) and a sharded kNN of
200,000 x 128 (equal to the single-process search), and prints each
statement's warm time and the bytes its MeshPlan says cross between the
processes.

The batched phase comes last (after its client threads have run
statements on the card, torch.profiler records no device event of a
later traced run): a Database of its own with the TPC-H tables and its
wire front; 8 client threads in 16 barrier-synced rounds of point reads
over orders (`select o_totalprice, o_orderdate ... where o_orderkey =
k`, keys drawn from the table by --seed) through DbSession.sql and over
the wire, the statement batcher on and then off, and a coalescing leg
that interleaves a lineitem point read. Rows are bit-identical on and
off and equal a numpy oracle; the on-legs batch (statements per
dispatch > 1) with at most 4 bucket programs for the plan; `_combo_run`
carries both plans' cohorts in one call, lane by lane equal to the
oracle; K24 is held to its plain version and the torch route on the
lanes' programs (parameters read from the lane's row of the block).
Statements/s and p50/p99 per leg.

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
import queue
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

S1 = """select l_orderkey, l_linenumber, l_extendedprice, l_shipdate
from lineitem
where l_shipdate = date '{day}' and l_quantity < 10
order by l_extendedprice desc, l_orderkey, l_linenumber"""
S1_DAYS = ("1995-06-17", "1996-02-29")
# K3's repeated runs (k3_synthetic): a race in its look-back would make
# two runs differ
K3_REPEAT_ROWS = 1 << 24
K3_REPEAT_RUNS = 20
# the statements whose traced device time K3 leads (PERF.md section 5):
# their K3 calls by shape
K3_SHAPE_STMTS = ("Q18", "Q20", "Q21", "Q10", "Q15", "Q4", "Q12", "Q13",
                  "S1")
# K4's repeated runs (k4_synthetic) and the statements whose traced device
# time K4 leads (PERF.md section 5): their K4 calls by shape and path
K4_REPEAT_ROWS = 1 << 24
K4_REPEAT_RUNS = 20
# warm runs of each streamed statement (stream_phase)
STREAM_WARM = 2
K4_SHAPE_STMTS = ("S1", "U3", "U3E", "Q15", "Q21", "Q20", "Q18", "W1", "W2")

T1 = """select l_orderkey, l_linenumber, l_quantity from lineitem
order by l_quantity desc limit 5"""

# a FROM-list cross join: one week of orders against every region
X1_WEEK = ("1995-03-01", "1995-03-08")
X1 = f"""select r_name, count(*) as n, sum(o_totalprice) as s
from orders, region
where o_orderdate >= date '{X1_WEEK[0]}' and o_orderdate < date '{X1_WEEK[1]}'
group by r_name order by r_name"""
# the rest of the Session's surface, held card = CPU at SF 0.1
SURFACE = (
    ("X_FROM_LIST", "select count(*) as n from nation, region"),
    ("X_CROSS", "select count(*) as n from nation cross join region"),
    ("X_RESIDUAL", "select count(*) as n from region r1, region r2 "
     "where r1.r_regionkey + 1 = r2.r_regionkey"),
    ("J_ARRAY", "select json_array(n_nationkey, 'x') as a from nation "
     "where n_nationkey = 1"),
    ("J_OBJECT", "select json_object('k', n_nationkey, 'name', n_name) as o "
     "from nation where n_nationkey < 3 order by n_nationkey"),
    ("R_COUNTER", "with recursive cnt as (select 1 as n union all "
     "select n + 1 as n from cnt where n < 50) select n from cnt order by n"),
    ("R_JOIN", """with recursive chain as (
      select o_orderkey as k, o_custkey as c from orders where o_orderkey = 4
      union
      select o.o_orderkey as k, o.o_custkey as c
      from chain, orders as o where o.o_orderkey = chain.k * 2
         and o.o_orderkey <= 512
    ) select k, c from chain order by k"""),
)

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
# a direct GROUP BY whose 45 groups pack into 128 slots (k2_domain_phase)
K2_C1 = ("select o_orderpriority, o_orderstatus, l_returnflag, count(*) as n"
         " from orders, lineitem where o_orderkey = l_orderkey group by "
         "o_orderpriority, o_orderstatus, l_returnflag")
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
    "K19_kmeans_assign": (
        "oceanbase_tpu_torch/csrc/k19_kmeans_assign.cu",
        "oceanbase_tpu/storage/vector_index.py:57"),
    "K20_kmeans_update": (
        "oceanbase_tpu_torch/csrc/k20_kmeans_update.cu",
        "oceanbase_tpu/storage/vector_index.py:64"),
    "K21_ivf_lists": (
        "oceanbase_tpu_torch/csrc/k21_ivf_lists.cu",
        "oceanbase_tpu/engine/executor.py:1572"),
    "K22_ivf_probe": (
        "oceanbase_tpu_torch/csrc/k22_ivf_probe.cu",
        "oceanbase_tpu/engine/executor.py:1574"),
    "K23_first_live": (
        "oceanbase_tpu_torch/csrc/k23_first_live.cu",
        "oceanbase_tpu/engine/executor.py:3867"),
    "K24_fused_expr": (
        "oceanbase_tpu_torch/csrc/k24_fused_expr.cu",
        "oceanbase_tpu/expr/compile.py:260"),
    "K25_exchange_pack": (
        "oceanbase_tpu_torch/csrc/k25_exchange_pack.cu",
        "oceanbase_tpu/parallel/exchange.py:65"),
    "K26_exchange_recv": (
        "oceanbase_tpu_torch/csrc/k26_exchange_recv.cu",
        "oceanbase_tpu/parallel/exchange.py:101"),
    "K27_shard_merge": (
        "oceanbase_tpu_torch/csrc/k27_shard_merge.cu",
        "oceanbase_tpu/parallel/exchange.py:166"),
    "K28_bucket_hist": (
        "oceanbase_tpu_torch/csrc/k28_bucket_hist.cu",
        "oceanbase_tpu/parallel/exchange.py:171"),
    "K29_hash_groupby": (
        "oceanbase_tpu_torch/csrc/k29_hash_groupby.cu",
        "oceanbase_tpu/ops/hashagg.py:155"),
    "K30_join_product_sum": (
        "oceanbase_tpu_torch/csrc/k30_join_product_sum.cu",
        "oceanbase_tpu/ops/spill.py:245"),
    "K31_shard_ivf": (
        "oceanbase_tpu_torch/csrc/k31_shard_ivf.cu",
        "oceanbase_tpu/parallel/ann.py:86"),
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
    "K31_shard_ivf.merge": (
        "oceanbase_tpu_torch/csrc/k31_shard_ivf.cu",
        "oceanbase_tpu/parallel/ann.py:119"),
    # K4 at S1's payload by the compaction order of its filter (the
    # direct path after the probe; its launches are the main path's K4
    # launches)
    "K4_gather_rows.monotone": (
        "oceanbase_tpu_torch/csrc/k4_gather_rows.cu",
        "oceanbase_tpu/ops/gather.py:54"),
    # K8 at Q17's dense shape (the correlated avg's group-by of lineitem
    # by l_partkey; its launches are the main path's K8 launches)
    "K8_segmented_reduce.dense": (
        "oceanbase_tpu_torch/csrc/k8_segmented_reduce.cu",
        "oceanbase_tpu/ops/hashagg.py:271"),
    # K3 and K14 at the spill's shapes, K18 on the PX chunk source's
    # decode (their launches counted on those paths)
    "K3_radix_sort.spill": (
        "oceanbase_tpu_torch/csrc/k3_radix_sort.cu",
        "oceanbase_tpu/ops/spill.py:63"),
    "K14_hash_set.spill": (
        "oceanbase_tpu_torch/csrc/k14_hash_set.cu",
        "oceanbase_tpu/ops/spill.py:251"),
    "K18_decode_staged.px": (
        "oceanbase_tpu_torch/csrc/k18_decode_staged.cu",
        "oceanbase_tpu/engine/chunked.py:63"),
    # not a kernel of its own: the Distinct operator on K3 + K4
    "dedup_batch": (
        "oceanbase_tpu_torch/engine/executor.py",
        "oceanbase_tpu/engine/executor.py:2606"),
}

# the entries of the {"kernels": ...} line: K1-K30 and the second entries
KERNEL_LINE = [k for k in KERNEL_META if k != "dedup_batch"]
# the kernels of the vector phase's own path
VECTOR_KERNELS = ("K19_kmeans_assign", "K20_kmeans_update", "K21_ivf_lists",
                  "K22_ivf_probe")
# the kernels of PX's exchanges (the PX phase's path)
PX_KERNELS = ("K25_exchange_pack", "K26_exchange_recv", "K27_shard_merge",
              "K28_bucket_hist")
# the kernels of the spill operators' path (ops/spill.py, the spill phase)
SPILL_KERNELS = ("K29_hash_groupby", "K30_join_product_sum")
# the kernel of the mesh-sharded IVF probe (parallel/ann.py, the sharded
# ANN leg)
ANN_KERNELS = ("K31_shard_ivf",)
# the kernels of each path (the rest of prepare's paths launch K17, K18)
MAIN_KERNELS = [k for k in KERNEL_LINE
                if "." not in k and k not in ("K17_slice_scan",
                                              "K18_decode_staged",
                                              *VECTOR_KERNELS, *PX_KERNELS,
                                              *SPILL_KERNELS, *ANN_KERNELS)]

# the reference bench's sorted projection: lineitem by l_shipdate,
# covering every column of the headline queries (bench.py SP_COLS)
SP_COLS = ["l_shipdate", "l_quantity", "l_extendedprice", "l_discount",
           "l_tax", "l_returnflag", "l_linestatus", "l_partkey",
           "l_orderkey"]
P_RANGE = """select sum(l_extendedprice) as s, count(*) as n from lineitem
where l_shipdate >= date '{lo}' and l_shipdate < date '{hi}'"""
P_NARROW = ("1995-03-01", "1995-03-08")
P_WIDE = ("1995-03-01", "1995-09-01")
# a range of 17 conjuncts on the sort key: K17 over 17 bounds (its old by-
# value table took 16); the largest low (03-16) and the high decide it
P_BOUNDS17 = ("select sum(l_extendedprice) as s, count(*) as n from "
              "lineitem where " + " and ".join(
                  f"l_shipdate >= date '1995-03-{d:02d}'"
                  for d in range(1, 17))
              + " and l_shipdate < date '1995-03-20'")
P_BOUNDS17_RANGE = ("1995-03-16", "1995-03-20")
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

# rounds of K17's interleaved timing beside its yardstick
K17_ROUNDS = 200

# the TPC-H queries run through the merge, expansion, semi/anti/left
# joins and DISTINCT, by query number
NEW_QUERIES = (2, 4, 5, 9, 11, 12, 13, 15, 16, 17, 18, 20, 21, 22)

# kernels each statement's path must launch
PATH_KERNELS = {
    "Q1": ("K2_groupby_direct", "K3_radix_sort", "K4_gather_rows",
           "K24_fused_expr"),
    "Q6": ("K1_scalar_aggregate", "K24_fused_expr"),
    "S1": ("K3_radix_sort", "K4_gather_rows"),
    "S1_rebound": ("K3_radix_sort", "K4_gather_rows"),
    "Q14": ("K5_affine_join", "K1_scalar_aggregate", "K24_fused_expr"),
    "Q3": ("K5_affine_join", "K6_clustered_agg", "K7_topk_candidates",
           "K3_radix_sort", "K4_gather_rows"),
    "Q10": ("K5_affine_join", "K3_radix_sort", "K8_segmented_reduce",
            "K7_topk_candidates"),
    "Q7": ("K5_affine_join", "K3_radix_sort", "K8_segmented_reduce",
           "K24_fused_expr"),
    "Q8": ("K5_affine_join", "K3_radix_sort", "K8_segmented_reduce"),
    "Q19": ("K5_affine_join", "K1_scalar_aggregate", "K24_fused_expr"),
    "T1": ("K7_topk_candidates", "K3_radix_sort", "K4_gather_rows"),
    "X1": ("K10_expand_join", "K3_radix_sort", "K4_gather_rows",
           "K2_groupby_direct"),
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
           "K8_segmented_reduce", "K13_window_scan", "K15_distinct_first",
           "K24_fused_expr"),
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
                  "K8_segmented_reduce", "K7_topk_candidates",
                  "K24_fused_expr")
       for q in (3, 42, 52, 55)},
    # the projection phase: the sliced scans, and Q1 on the base table
    "P_Q6": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_Q6_1995": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_Q14": ("K17_slice_scan", "K5_affine_join", "K1_scalar_aggregate"),
    "P_NARROW": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_WIDE": ("K17_slice_scan", "K1_scalar_aggregate"),
    "P_BOUNDS17": ("K17_slice_scan", "K1_scalar_aggregate"),
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
    # the vector phase: brute force sorts the float distances; the IVF
    # route probes (K21), re-ranks (K22) and gathers the winners (K4)
    "V_BRUTE": ("K3_radix_sort", "K4_gather_rows"),
    **{v: ("K21_ivf_lists", "K22_ivf_probe", "K4_gather_rows")
       for v in ("V_L2", "V_F50", "V_DIST", "V_STARVE")},
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


def interleaved_ms(fns, rounds: int) -> list:
    """The median milliseconds of each of fns, timed in turns over the
    same rounds (CUDA events around one call each, after one warm-up
    call), so that both see the same clocks and neighbours."""
    import statistics

    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, t in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


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


def x1_oracle(tables) -> dict:
    """X1: each region pairs with every order of the week: per region (in
    name order) the week's order count and its o_totalprice sum (scaled
    int64)."""
    import numpy as np

    from oceanbase_tpu_torch.expr.compile import _parse_date

    o = tables["orders"]
    day = np.asarray(o.data["o_orderdate"])
    week = (day >= _parse_date(X1_WEEK[0])) & (day < _parse_date(X1_WEEK[1]))
    price = np.asarray(o.data["o_totalprice"], dtype=np.int64)[week]
    r = tables["region"]
    codes = np.asarray(r.data["r_name"])
    names = np.asarray(r.dicts["r_name"].decode(codes), dtype=object)
    codes = codes[np.argsort(names, kind="stable")]
    return {"r_name": codes,
            "n": np.full(len(codes), int(week.sum()), dtype=np.int64),
            "s": np.full(len(codes), int(price.sum()), dtype=np.int64)}


def check_q19(rs, tables, queries) -> int:
    got = rs.storage_columns()["revenue"]
    want = queries.q19_numpy(tables)
    require(want > 0, "Q19's oracle selected no rows")
    require(len(got) == 1 and int(got[0]) == want,
            "Q19 revenue differs from the int64 oracle")
    return 1


def device_busy_ms(fn) -> tuple[float, float, list, list, int]:
    """(device ms, wall ms, longest idle gaps, device ms by kernel, traced
    attempts) of one fn() call under torch.profiler. Device time is the union of the
    intervals of the trace's CUDA events (kernels, copies, sets), so
    overlapping records count once and host-side records not at all; the
    wall is the host clock around the same traced call. The gaps are the
    three longest stretches between device intervals, with the events on
    either side; the kernels are the six names with the most device time,
    summed over the same CUDA events. A trace with no device event is
    taken again (at most 3 attempts); the records keep the count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
        # torch.profiler has dropped a whole trace's device events on
        # this card (PERF.md §7): the run is traced again, and says so
        print(f"traced attempt {attempt}: torch.profiler recorded no "
              "device event", flush=True)
    require(bool(spans), "the traced run recorded no device activity in "
            "3 attempts")
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
    # every kernel of the run, most device time first (the K8 and K26
    # rows of PERF.md read theirs even where they are not among the top)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return busy_us / 1e3, wall, gaps[:3], top, attempt


VECTOR_CHECKS = {
    "V_BRUTE": "ids equal numpy's exact top-10 (margin rule)",
    "V_L2": "recall@10 >= 0.9 over 10 queries; 10 rows in distance order",
    "V_F50": "recall@10 >= 0.9 over 10 queries; 10 filtered rows in "
             "distance order",
    "V_DIST": "distances within 2e-5 x (|x|^2 + |q|^2) of float64",
    "V_STARVE": "escalated to every list; ids equal the exact filtered "
                "top-10 (margin rule)",
}


def checked_by(name: str) -> str:
    if name in VECTOR_CHECKS:
        return VECTOR_CHECKS[name]
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
    the result of the last untraced run to its oracle, `after(rs)` (when
    given) checks the route and the state after the runs. `text` may be a
    list of warm + 2 texts, one per run (distinct query vectors)."""
    import torch

    texts = [text] * (warm + 2) if isinstance(text, str) else list(text)
    require(len(texts) == warm + 2, f"{name}: {len(texts)} texts for "
            f"{warm + 2} runs")
    from oceanbase_tpu_torch.expr.program import EXPR_COUNTS

    before = dict(kernels.LAUNCHES)
    before_e = dict(kernels.ENTRY_LAUNCHES)
    before_x = dict(EXPR_COUNTS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rs = sess.sql(texts[0])
    n = rs.nrows
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    times = []
    for i in range(warm):
        t0 = time.perf_counter()
        rs = sess.sql(texts[1 + i])
        n = rs.nrows
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rows = check(rs)
    require(rows == n, f"{name}: row count {n} != checked rows {rows}")
    busy, traced, gaps, top, attempts = device_busy_ms(
        lambda: sess.sql(texts[-1]).nrows)
    extra = after(rs) if after is not None else {}
    require(busy <= traced, f"{name}: device busy {busy} ms exceeds the "
            f"traced wall {traced} ms")
    peak = torch.cuda.max_memory_allocated()
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    entries = {k: kernels.ENTRY_LAUNCHES[k] - before_e[k]
               for k in kernels.ENTRY_LAUNCHES}
    expr = {k: EXPR_COUNTS[k] - before_x[k] for k in EXPR_COUNTS}
    if not name.startswith("V_"):
        # the main path's trees all run on K24 (the vector statements'
        # distances run on the torch route by design: printed, not held)
        require(expr["expr torch route"] == 0, f"{name}: "
                f"{expr['expr torch route']} trees ran on the torch route")
    if expr["expr k24 trees"]:
        require(launches["K24_fused_expr"] > 0,
                f"{name}: trees were fused but K24 never launched")
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
        "expr_k24_trees": expr["expr k24 trees"],
        "expr_torch_route": expr["expr torch route"],
        "peak_memory_bytes": peak,
        "fast_path_hit": bool(rs.fast_path_hit),
        "device_busy_ms": busy, "traced_wall_ms": traced,
        "traced_attempts": attempts,
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
          f"entries {rec['entries']}, expression trees on K24 "
          f"{expr['expr k24 trees']}, on the torch route "
          f"{expr['expr torch route']}, device busy {busy:.3f} ms of "
          f"{traced:.3f} ms traced (idle share "
          f"{rec['device_idle_share']:.4f}, longest gap "
          f"{gaps[0][0] if gaps else 0.0:.3f} ms); most device time: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in top[:4]), flush=True)
    return rec


# the narrowed frame's A/B: rounds per leg (after one round that warms
# each leg), interleaved so that drift falls on every leg alike
NARROW_AB_ROUNDS = 9
# small results of the main path: aggregates, a TopN, and filters whose
# root compaction is wider than the narrowed frame
NARROW_AB_MAIN = ("Q1", "Q6", "Q3", "Q2", "Q11", "Q22")


def narrow_ab(sess, name, text, rounds=NARROW_AB_ROUNDS) -> dict:
    """Warm latency of one statement to its host rows (`rows()`), on one
    Session, in three legs interleaved round by round: the narrowed frame
    off (the plain cursor and its small-result copy), on (a frame no
    wider than the narrowed one goes as it is), and on with K23 over
    every frame (the compaction that a fitting frame skips). Medians in
    ms; every leg's rows must be the same."""
    import torch

    import oceanbase_tpu_torch.engine.executor as ex

    fits = ex._frame_fits
    legs = {"off": (lambda: False, fits), "on": (None, fits),
            "on_k23": (None, lambda out, ncap: False)}
    times = {leg: [] for leg in legs}
    rows = {}
    try:
        for i in range(rounds + 1):
            for leg, (enabled, fit) in legs.items():
                sess.narrow_enabled_fn, ex._frame_fits = enabled, fit
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = sess.sql(text).rows()
                ms = (time.perf_counter() - t0) * 1e3
                if i:
                    times[leg].append(ms)
                rows.setdefault(leg, got)
                require(got == rows["off"], f"narrow A/B {name}: leg {leg} "
                        "rows differ from the plain cursor's")
    finally:
        sess.narrow_enabled_fn, ex._frame_fits = None, fits
    rec = {"statement": name, "rounds": rounds,
           **{f"{leg}_ms": statistics.median(v) for leg, v in times.items()},
           "ms": times}
    print(f"narrow A/B {name}: warm to rows, median of {rounds}: off "
          f"{rec['off_ms']:.3f} ms, on {rec['on_ms']:.3f} ms, on with K23 "
          f"forced {rec['on_k23_ms']:.3f} ms", flush=True)
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
    the Distinct operator in Q16; and K8's largest call (most live rows)
    in Q17, its dense shape."""
    import oceanbase_tpu_torch.engine.executor as ex
    import oceanbase_tpu_torch.ops.hashagg as hashagg
    import oceanbase_tpu_torch.ops.join as join

    plan = {
        17: {"K9_merge_join": (kernels, "merge_join",
                               lambda bk, bs, pk, ps: pk.numel()),
             "K8_segmented_reduce.dense": (
                 hashagg, "segmented_reduce",
                 lambda sk, ss, o, aggs: int(ss.sum()))},
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
        (D1, {"K15_distinct_first": (ex, "distinct_first_mask",
                                     lambda dk, v, m: m.numel() * (len(dk)
                                                                   + 1))}),
        (A1, {"K16_hll": (hll, "hll_registers", n0)}),
        (F1, {"K11_probe_run_any.mark_build": (ex, "mark_build", n0)}),
    ]
    out = {}
    for text, targets in plan:
        out.update(capture_args(sess, text, targets))
    return out


def k13_entries(kernels, cap: dict, plain: bool) -> list:
    """K13's entries on their captured main-path arguments, as (name,
    call) pairs: the run flags, segment starts and ends, the prefix sum,
    the forward and backward segmented max, the frame-bound search,
    through the kernel or the plain versions."""
    def fn(name):
        return getattr(kernels, f"{name}_plain" if plain else name)

    (keys,) = cap["K13.flags"]
    vals, flags, is_min = cap["K13.fwd"]
    svals, sflags, s_is_min = cap["K13.suffix"]
    arr, target, lo, hi, *right = cap["K13.search"]
    return [
        ("boundaries", lambda: fn("boundaries")(keys)),
        ("segment_starts", lambda: fn("segment_starts")(*cap["K13.starts"])),
        ("peer_ends", lambda: fn("peer_ends")(*cap["K13.ends"])),
        ("prefix_sum", lambda: fn("prefix_sum")(*cap["K13.sum"])),
        ("segmented_scan_minmax",
         lambda: fn("segmented_scan_minmax")(vals, flags, is_min)),
        ("suffix_scan_minmax",
         lambda: fn("suffix_scan_minmax")(svals, sflags, s_is_min)),
        ("bound_search",
         lambda: fn("bound_search")(arr, target, lo, hi, *right)),
    ]


def k13_steps(kernels, cap: dict, plain: bool) -> list:
    """Every K13 entry once (`k13_entries`), their results in order."""
    return [call() for _name, call in k13_entries(kernels, cap, plain)]


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

    from oceanbase_tpu_torch.bench_ab import chained_sort
    from oceanbase_tpu_torch.expr.compile import _parse_date
    from oceanbase_tpu_torch.ops.hashing import dense_keys

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

    # K2 at Q1's shape: the dense slots of (returnflag, linestatus), 6
    # of them, laid out in 8 packed slots; the live count + 9 aggregates
    cutoff = _parse_date("1998-09-02")
    m1 = sel & (c["l_shipdate"] <= cutoff)
    doms = [len(b.dicts["l_returnflag"]), len(b.dicts["l_linestatus"])]
    packed = dense_keys([c["l_returnflag"], c["l_linestatus"]],
                        doms).contiguous()
    dom = kernels.k2_layout(doms)[0]
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
        + len(aggs) * kernels.k2_layout(doms)[1] * 8

    def k2_library():
        res = []
        for op, v, mm in aggs:
            w = mm.to(torch.int64) if v is None else torch.where(mm, v, 0).to(torch.int64)
            res.append(torch.zeros(dom, dtype=torch.int64, device=w.device)
                       .index_add_(0, packed.long(), w))
        return res

    record(
        "K2_groupby_direct",
        kernels.groupby_slots(packed, doms, aggs),
        kernels.groupby_slots_plain(packed, doms, aggs),
        lambda: kernels.groupby_slots(packed, doms, aggs),
        lambda: kernels.groupby_slots_plain(packed, doms, aggs),
        k2_library, k2_bytes, nsel1 * len(aggs))

    # K3 at S1's shape: (price desc, orderkey, linenumber) over 60M rows,
    # most of them dead
    ms = sel & (c["l_shipdate"] == _parse_date(S1_DAYS[0])) \
        & (c["l_quantity"] < 1000)
    keys = [c["l_extendedprice"], c["l_orderkey"], c["l_linenumber"]]
    desc = [True, False, False]

    def k3_library():
        return chained_sort(torch, keys, desc, ms)

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
    out[-1]["path"] = kernels.k4_launch(payload, order, trace=True)[1]
    require(out[-1]["path"] == "image",
            f"K4 at S1's shape took the {out[-1]['path']} path")
    # K4 at the same payload by the compaction order of S1's filter (live
    # rows first, each run in row order): the probe sends it direct
    mono = kernels.sort_order([], [], ms)
    record(
        "K4_gather_rows.monotone",
        kernels.gather_columns(payload, mono),
        kernels.gather_columns_plain(payload, mono),
        lambda: kernels.gather_columns(payload, mono),
        lambda: kernels.gather_columns_plain(payload, mono),
        lambda: [p.index_select(0, mono) for p in payload],
        n * (4 + 2 * width), n * len(payload))
    out[-1]["path"] = kernels.k4_launch(payload, mono, trace=True)[1]
    require(out[-1]["path"] == "rows (probe)",
            f"K4 at the monotone shape took the {out[-1]['path']} path")
    del mono

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
    path7 = kernels.topk_candidates_traced(rev, osel, True, C)[2]
    want7 = kernels.topk_candidates_path_plain(rev, osel, True, C)
    require(path7 == want7, f"K7 at Q3's shape: the {path7} path ran, the "
            f"model predicts {want7}")
    out[-1].update(path=path7, rows=int(rev.numel()),
                   live=int(osel.sum()),
                   launches_a_call=3 if path7 == "full" else 4)
    print(f"kernel K7_topk_candidates at Q3's shape: the {path7} path "
          f"({int(osel.sum())} live of {int(rev.numel())} rows, c {C})",
          flush=True)

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
    # held bit for bit too (record's error is taken in float64)
    _exact("K8 at Q7's shape",
           flat(kernels.segmented_reduce(skeys8, ssel8, order8, aggs8)),
           flat(kernels.segmented_reduce_plain(skeys8, ssel8, order8,
                                               aggs8)),
           flat(kernels.segmented_reduce(skeys8, ssel8, order8, aggs8)))

    # K8 at Q17's dense shape: the largest call Q17's correlated group-by
    # makes (lineitem by l_partkey), captured on the main path; the same
    # bound formula, and the same library yardstick (keys packed and
    # values gathered outside the timed call)
    skd, ssd, od, aggd = captured["K8_segmented_reduce.dense"]
    skd, aggd = list(skd), list(aggd)
    nd = int(ssd.shape[0])
    lrd = ssd.nonzero().squeeze(1)
    live_ord = od[lrd].to(torch.int64)
    seen, kd_sectors = set(), 0
    for _op, v, m in aggd:
        for arr in (v, m):
            if arr is not None and arr.data_ptr() not in seen:
                seen.add(arr.data_ptr())
                kd_sectors += sector_bytes(live_ord, arr.element_size())
    kd_bytes = (nd * (1 + 1 + 8 * len(aggd))
                + int(lrd.numel()) * (sum(k.element_size() for k in skd) + 4)
                + kd_sectors)
    if len(skd) == 1 and not skd[0].dtype.is_floating_point:
        packed_d = torch.where(ssd, skd[0].to(torch.int64),
                               torch.iinfo(torch.int64).min)

        def kd_unique():
            return torch.unique_consecutive(packed_d, return_counts=True)
    else:
        stack_d = torch.stack([(~ssd).to(torch.int64)]
                              + [k.to(torch.float64).view(torch.int64)
                                 if k.dtype.is_floating_point
                                 else k.to(torch.int64) for k in skd], 1)

        def kd_unique():
            return torch.unique_consecutive(stack_d, dim=0,
                                            return_counts=True)
    ofull = od.to(torch.int64)
    kd_vals = []
    for op, v, m in aggd:
        keep = ssd if m is None else ssd & m[ofull]
        if op == "count":
            kd_vals.append((keep.to(torch.float64), "sum"))
        else:
            fill = {"sum": 0.0, "min": float("inf"),
                    "max": float("-inf")}[op]
            kd_vals.append((torch.where(keep, v[ofull].to(torch.float64),
                                        fill), op))

    def kd_library():
        _u, counts = kd_unique()
        return [torch.segment_reduce(x, red, lengths=counts)
                for x, red in kd_vals]

    _exact("K8 at Q17's dense shape",
           flat(kernels.segmented_reduce(skd, ssd, od, aggd)),
           flat(kernels.segmented_reduce_plain(skd, ssd, od, aggd)),
           flat(kernels.segmented_reduce(skd, ssd, od, aggd)))
    record(
        "K8_segmented_reduce.dense",
        flat(kernels.segmented_reduce(skd, ssd, od, aggd)),
        flat(kernels.segmented_reduce_plain(skd, ssd, od, aggd)),
        lambda: flat(kernels.segmented_reduce(skd, ssd, od, aggd)),
        lambda: kernels.segmented_reduce_plain(skd, ssd, od, aggd),
        kd_library, kd_bytes, nd * 4)
    segs_d = int(kernels.segmented_reduce(skd, ssd, od, aggd)[0].sum())
    out[-1]["shape"] = {
        "rows": nd, "live": int(lrd.numel()), "groups": segs_d,
        "keys": [str(k.dtype) for k in skd],
        "aggregates": [[op, None if v is None else str(v.dtype),
                        m is not None] for op, v, m in aggd],
        "bytes": kd_bytes}
    print(f"K8 dense shape (Q17): {out[-1]['shape']}", flush=True)

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
    # each entry alone: its time and its bound (its inputs read once, its
    # output written once)
    entries = {}
    for (name, call), a, g in zip(k13_entries(kernels, captured, False),
                                  args13, got13):
        bm, _by = bound_ms(nbytes(a) + nbytes([g]), int(g.numel()))
        entries[name] = {"ms": cuda_ms(call, reps), "bound_ms": bm}
    out[-1]["entries"] = entries
    print("K13 by entry (ms, bound ms): " + ", ".join(
        f"{k} {v['ms']:.6f} ({v['bound_ms']:.6f})"
        for k, v in entries.items()), flush=True)

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

    # K15 at D1's shape: lineitem's (flag, status, l_suppkey) first rows,
    # from K3's sorted images (the image route: the images read once, one
    # byte written a row at most); the order routes forced on the same
    # rows beside it (the record route, and the columns route, which is
    # previous design's walk)
    dk15, v15, mask15 = captured["K15_distinct_first"]
    nn15 = int(mask15.shape[0])
    cols15 = [(k.expand(nn15) if k.dim() == 0 else k).contiguous()
              for k in (*dk15, v15)]
    s15 = kernels.sort_order_images(cols15, [False] * len(cols15), mask15)
    require(s15.route == "image", f"K15 at D1's shape took the {s15.route} "
            "route, not the image route")
    order15 = (s15.images & ((1 << s15.rbits) - 1)).to(torch.int32)
    packed15 = torch.zeros_like(cols15[0], dtype=torch.int64)
    for c in cols15:
        packed15 = packed15 * 1_000_003 + c.to(torch.int64)

    got15 = kernels.first_occurrence_images(s15)
    record("K15_distinct_first", got15,
           kernels.first_occurrence_plain(cols15, mask15, order15),
           lambda: kernels.first_occurrence_images(s15),
           lambda: kernels.first_occurrence_plain(cols15, mask15, order15),
           lambda: torch.unique(packed15, return_inverse=True),
           nbytes([s15.images]) + nn15, nn15)
    for route in ("record", "columns"):
        _exact(f"K15 {route} route at D1's shape",
               kernels.first_occurrence(cols15, mask15, order15, route),
               got15,
               kernels.first_occurrence(cols15, mask15, order15, route))
        out[-1][f"{route}_route_ms"] = cuda_ms(
            lambda: kernels.first_occurrence(cols15, mask15, order15, route),
            reps)
    out[-1]["path"] = "image"
    out[-1]["k3_images_ms"] = cuda_ms(lambda: kernels.sort_order_images(
        cols15, [False] * len(cols15), mask15), max(1, reps // 2))
    out[-1]["k3_order_ms"] = cuda_ms(lambda: kernels.sort_order(
        cols15, [False] * len(cols15), mask15), max(1, reps // 2))
    print(f"K15 at D1's shape: path image, record route "
          f"{out[-1]['record_route_ms']:.6f} ms, columns route "
          f"{out[-1]['columns_route_ms']:.6f} ms, K3 with images "
          f"{out[-1]['k3_images_ms']:.6f} ms, with the order "
          f"{out[-1]['k3_order_ms']:.6f} ms", flush=True)

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
    from oceanbase_tpu_torch.ops.hashing import dense_keys

    b = sess.executor.table_batch(
        "lineitem", ("l_extendedprice", "l_linestatus", "l_returnflag",
                     "l_shipdate"))
    c = b.cols
    mask = b.sel & (c["l_shipdate"] <= _parse_date("1998-09-02"))
    dom = [len(b.dicts["l_returnflag"]), len(b.dicts["l_linestatus"])]
    packed = dense_keys([c["l_returnflag"], c["l_linestatus"]],
                        dom).contiguous()
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


def k8_synthetic(kernels, dev) -> int:
    """K8 against its plain version, twice, bit for bit, on edge cases of
    its tiles and its look-back: no live row; a row count no multiple of a
    tile; live segments 40 tiles long (past a look-back step of 32) and
    one segment over every row; live and dead rows interleaved, not sorted
    last; short segments over every row (the dense shape); 20 keys and 15
    aggregates (past the parameter table, so the table lies in device
    memory). Each case runs count, masked count, wrapping int64 sums,
    integer-valued float64 sums, int8 min, float max and min, masked max.
    Returns the number of cases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(88)
    T = kernels.K8_TILE

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def aggs_for(n):
        v64 = rng.integers(-10**15, 10**15, n)
        v64[::97] = np.iinfo(np.int64).max
        v8 = rng.integers(-128, 128, n).astype(np.int8)
        cents = rng.integers(-10**6, 10**6, n).astype(np.float64)
        mask = t(rng.random(n) < 0.8)
        return [("count", None, None), ("count", None, mask),
                ("sum", t(v64), None), ("sum", t(cents), mask),
                ("min", t(v8), None), ("max", t(cents), None),
                ("max", t(v64), mask), ("min", t(cents), mask)]

    def sorted_case(keys, live):
        idx = np.lexsort(tuple(reversed([~live, *keys])))
        return [k[idx] for k in keys], live[idx]

    cases = []
    n = 5 * T + 3
    k, lv = sorted_case([rng.integers(0, 9, n)], np.zeros(n, dtype=bool))
    cases.append(("no live row", k, lv))
    n = 37 * T + 1001
    k, lv = sorted_case([rng.integers(0, 50, n).astype(np.int32),
                         rng.integers(0, 3, n).astype(np.int16)],
                        rng.random(n) < 0.7)
    cases.append(("ragged last tile", k, lv))
    n = 200 * T + 17
    cases.append(("segments of 40 tiles",
                  [(np.arange(n) // (40 * T)).astype(np.int32)],
                  np.ones(n, dtype=bool)))
    cases.append(("one segment", [np.zeros(n, dtype=np.int64)],
                  np.ones(n, dtype=bool)))
    n = 50 * T + 5
    cases.append(("interleaved live and dead",
                  [np.sort(rng.integers(0, 400, n)).astype(np.int32)],
                  rng.random(n) < 0.5))
    n = 64 * T
    cases.append(("dense short segments",
                  [np.sort(rng.integers(0, n // 30, n)).astype(np.int32)],
                  np.ones(n, dtype=bool)))
    n = 9 * T + 77
    wide = [rng.integers(0, 2, n).astype(dt) for dt in
            (np.int16, np.int32, np.int64, np.bool_, np.float32) * 4]
    k, lv = sorted_case(wide, rng.random(n) < 0.9)
    cases.append(("20 keys, 15 aggregates", k, lv))
    for name, keys, live in cases:
        n = len(live)
        skeys = [t(k) for k in keys]
        ssel = t(live)
        order = t(rng.permutation(n).astype(np.int32))
        aggs = aggs_for(n)
        if len(keys) == 20:
            aggs = (aggs * 2)[:15]
            entries = 2 * len(keys) + kernels.K8_FIELDS * len(aggs)
            require(entries > kernels.K8_INLINE,
                    "K8 synthetic: the wide case fits the parameters")

        def run(fn):
            sel, res = fn(skeys, ssel, order, aggs)
            return [sel, *res]

        _exact(f"K8 synthetic ({name})", run(kernels.segmented_reduce),
               run(kernels.segmented_reduce_plain),
               run(kernels.segmented_reduce))
        print(f"K8 synthetic ({name}, {n} rows, {len(keys)} keys, "
              f"{len(aggs)} aggregates): exact, two runs bit-identical",
              flush=True)
    return len(cases)


def k3_synthetic(kernels, dev) -> int:
    """K3 against its plain version, twice, bit for bit, on edge cases of
    its plan, its tiles and its look-back: 0, 1, a tile - 1, a tile and a
    tile + 1 rows (a 64-bit image over 2 composites, and the dead flag
    alone); every row dead, no row dead; constant keys (no pass); spans of
    1, 8, 32, 33 and 64 bits (a one-pass composite that reads its keys, a
    32-bit image beside the order, a 64-bit one with the row in it, a
    64-bit one beside the order and two composites); 12 bits over 2^20
    rows (a 32-bit image with the row in it); trivial digits (values 0
    and 2^20: two passes that move nothing before one that moves); least
    significant keys the rows already follow (dropped), and a tuple the
    rows follow whose last key alone they do not; eleven keys (two span
    sweeps, 12 spans); seventy keys (nine span sweeps; the keys past the
    64th decide the order of most rows, the suffix check on the last
    eight); DESC on int8/int32/int64 minimums; floats with
    NaN, -0.0 and infinities; three 30-bit keys (two composites, the
    second gathered through the order).
    Then K3_REPEAT_RUNS runs at K3_REPEAT_ROWS rows, each bit-identical to
    the first (a race in the look-back would break that). Returns the
    number of cases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(33)
    T = kernels.K3_TILE
    i64 = np.iinfo(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def full64(n):
        return rng.integers(i64.min, i64.max, n, endpoint=True)

    def spanning(lo, hi, n):
        # values in [lo, hi] that reach both ends: a span of hi - lo
        a = rng.integers(lo, hi, n, endpoint=True)
        a[:2] = (lo, hi)
        return a

    big = 3_000_017
    a3, b3 = rng.integers(0, 1 << 12, big), rng.integers(0, 1 << 16, big)
    # a whole-row sort's operands (_row_key_operands) over two tables of 33
    # nullable columns: a value and a validity plane each, most rows equal
    # on them, then four keys the rows do not follow (past the 64th key)
    wide = 1_000_003
    wide_keys = []
    for _ in range(33):
        wide_keys += [(rng.random(wide) < 0.005).astype(np.int32),
                      rng.random(wide) < 0.995]
    wide_keys += [full64(wide), rng.integers(-9, 9, wide).astype(np.int32),
                  rng.random(wide) < 0.5,
                  rng.integers(-128, 128, wide).astype(np.int8)]
    idx = np.lexsort((b3, a3))
    cases = []
    for n in (0, 1, T - 1, T, T + 1):
        live = rng.random(n) < 0.7
        cases.append((f"{n} rows, full int64", [full64(n)], [False], live))
        cases.append((f"{n} rows, the dead flag alone", [], [], live))
    cases += [
        ("every row dead", [rng.integers(0, 1000, big)], [False],
         np.zeros(big, dtype=bool)),
        ("no row dead", [rng.integers(0, 1000, big)], [True],
         np.ones(big, dtype=bool)),
        ("constant keys", [np.full(big, 7, np.int32),
                           np.full(big, -2.5)], [False, True],
         np.ones(big, dtype=bool)),
        ("1-bit span", [rng.random(big) < 0.5], [False],
         np.ones(big, dtype=bool)),
        ("8-bit span", [rng.integers(-100, 156, big).astype(np.int16)],
         [False], np.ones(big, dtype=bool)),
        ("32-bit span", [spanning(0, (1 << 32) - 1, big)], [True],
         np.ones(big, dtype=bool)),
        ("33-bit span", [spanning(0, 1 << 32, big)], [False],
         np.ones(big, dtype=bool)),
        ("64-bit span", [spanning(i64.min, i64.max, big)], [True],
         rng.random(big) < 0.5),
        ("trivial digits", [np.where(rng.random(big) < 0.5, 0, 1 << 20)],
         [False], np.ones(big, dtype=bool)),
        ("12 bits over 2^20 rows", [spanning(0, 4095, 1 << 20)], [True],
         np.ones(1 << 20, dtype=bool)),
        ("a suffix in row order", [rng.integers(0, 1 << 24, big),
                                   np.sort(rng.integers(0, 1 << 26, big)),
                                   rng.integers(0, 8, big).astype(np.int8)],
         [True, False, False], rng.random(big) < 0.01),
        ("a tuple in row order, its last key not",
         [rng.integers(0, 1 << 20, big)] + [c[idx] for c in (a3, b3)],
         [False, False, False], rng.random(big) < 0.5),
        ("eleven keys", [rng.integers(0, 1 << 6, big).astype(np.int8)
                         for _ in range(9)]
         + [np.arange(big) // 7, np.arange(big) % 7], [False, True] * 5
         + [False], rng.random(big) < 0.9),
        ("DESC on minimums",
         [rng.choice(np.array([-128, -1, 0, 127], np.int8), big),
          rng.choice(np.array([np.iinfo(np.int32).min, -1, 0,
                               np.iinfo(np.int32).max], np.int32), big),
          rng.choice(np.array([i64.min, -1, 0, i64.max]), big)],
         [True, True, True], rng.random(big) < 0.8),
        ("floats with NaN and -0.0",
         [rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5,
                               -1.5], np.float32), big),
          rng.choice(np.array([np.nan, -np.nan, -0.0, 0.0, np.inf,
                               -np.inf, 2.25]), big)],
         [True, False], rng.random(big) < 0.8),
        ("three 30-bit keys", [rng.integers(0, 1 << 30, big)
                               for _ in range(3)], [False, True, False],
         rng.random(big) < 0.6),
        ("seventy keys", wide_keys, [False, True] * 35,
         rng.random(wide) < 0.8),
    ]
    for name, keys, desc, live in cases:
        tk, tl = [t(k) for k in keys], t(live)
        _exact(f"K3 synthetic ({name})", kernels.sort_order(tk, desc, tl),
               kernels.sort_order_plain(tk, desc, tl),
               kernels.sort_order(tk, desc, tl))
        print(f"K3 synthetic ({name}, {len(live)} rows, {len(keys)} "
              f"keys): exact, two runs bit-identical", flush=True)
    n = K3_REPEAT_ROWS
    tk = [t(full64(n)), t(rng.integers(0, 1 << 20, n).astype(np.int32))]
    tl = t(rng.random(n) < 0.9)
    first = kernels.sort_order(tk, [False, True], tl)
    _exact(f"K3 at {n} rows", first,
           kernels.sort_order_plain(tk, [False, True], tl), first)
    for r in range(K3_REPEAT_RUNS - 1):
        require(torch.equal(first, kernels.sort_order(tk, [False, True], tl)),
                f"K3 at {n} rows: run {r + 2} differs from run 1")
    print(f"K3 at {n} rows: {K3_REPEAT_RUNS} runs bit-identical, equal to "
          f"the plain version", flush=True)
    return len(cases) + 1


def k3_call_shapes(sess, kernels, texts: dict) -> dict:
    """One more run of each statement with K3's planner wrapped: every
    sort_order call's rows, the keys that still decide its order (the dead
    flag counted) and its composites (bits, image width, row bits,
    passes), identical calls merged with their count."""
    got, calls = {}, []
    orig = kernels.k3_plan

    def wrapped(spans, n):
        plan = orig(spans, n)
        calls.append((n, len(spans), tuple((c.bits, c.width, c.rbits,
                                            c.passes) for c in plan)))
        return plan

    kernels.k3_plan = wrapped
    try:
        for name, text in texts.items():
            calls.clear()
            sess.sql(text).nrows
            merged = {}
            for c in calls:
                merged[c] = merged.get(c, 0) + 1
            got[name] = [{"rows": n, "keys": nk,
                          "composites": [list(x) for x in comp],
                          "passes": sum(x[3] for x in comp), "calls": k}
                         for (n, nk, comp), k in merged.items()]
            print(f"K3 calls of {name}: " + "; ".join(
                f"{r['calls']} x {r['rows']} rows, {r['keys']} keys kept, "
                f"composites (bits, width, row bits, passes) "
                f"{r['composites']}" for r in got[name]), flush=True)
    finally:
        kernels.k3_plan = orig
    return got


def k7_synthetic(kernels, dev) -> dict:
    """K7 against its plain version, twice, bit for bit (the candidates
    and the tie count), on its edge cases, each case's path read back from
    the device (`topk_candidates_traced`) and held to the path
    `topk_candidates_path_plain` predicts from the same inputs: spread
    keys of every integer width, DESC and ASC (the survivor path); dense
    values at 8M rows, ties across the C-th value, fewer live rows than C
    and every row dead (the exact path: overflow); ASC on INT64_MAX (live
    rows at the dead rows' INT64_MIN) on both paths; c = n on the survivor
    and the full path; c past K7_FAST_C; a kth bin of exactly
    K7_SORT_MAX rows and one more; a sel view that is not 16-byte aligned;
    1, 5, 17 and 600 rows. Returns {"cases": n, "paths": {path: n}}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(77)
    i64 = np.iinfo(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def spread(dtype, n):
        info = np.iinfo(dtype)
        return rng.integers(int(info.min), int(info.max), n,
                            endpoint=True).astype(dtype)

    cases = []
    n = 1 << 20
    for dtype in (np.int8, np.int16, np.int32, np.int64):
        for desc in (True, False):
            cases.append((f"spread {np.dtype(dtype).name} desc {desc}",
                          spread(dtype, n), rng.random(n) < 0.5, desc, 256))
    ties = rng.integers(0, 7, n).astype(np.int32)
    cases.append(("ties", ties, rng.random(n) < 0.6, True, 256))
    dense = rng.integers(0, 1 << 25, 8 * n)
    cases.append(("dense values, half live", dense, rng.random(8 * n) < 0.5,
                  True, 256))
    few = np.zeros(n, dtype=bool)
    few[rng.choice(n, 40, replace=False)] = True
    cases.append(("few live", spread(np.int64, n), few, True, 256))
    cases.append(("all dead", spread(np.int64, n), np.zeros(n, bool), True,
                  256))
    for rows in (n, 5000):
        key = rng.integers(-10**6, 10**6, rows)
        sel = rng.random(rows) < 0.03
        live = sel.nonzero()[0]
        key[live[-4:]] = i64.max
        key[live[-8:-4]] = i64.min
        for desc in (True, False):
            cases.append((f"sentinels {rows} rows desc {desc}", key, sel,
                          desc, 256))
    key = spread(np.int64, 3000)
    cases.append(("c = n, 3000 rows", key, rng.random(3000) < 0.7, True,
                  3000))
    key = spread(np.int32, 20000)
    cases.append(("c = n, 20000 rows", key, rng.random(20000) < 0.7, False,
                  20000))
    cases.append(("c past K7_FAST_C", spread(np.int64, n),
                  rng.random(n) < 0.5, True, kernels.K7_FAST_C + 1))
    for rows in (kernels.K7_SORT_MAX, kernels.K7_SORT_MAX + 1):
        cases.append((f"one value in {rows} rows",
                      np.full(rows, 1995, np.int32), np.ones(rows, bool),
                      True, 1))
    for rows in (1, 5, 17, 600):
        key = spread(np.int64, rows)
        sel = rng.random(rows) < 0.6
        cases.append((f"{rows} rows, c = n", key, sel, True, rows))
        cases.append((f"{rows} rows, c = 1", key, sel, False, 1))
    paths: dict = {}
    for what, key, sel, desc, c in cases:
        tk, ts = t(key), t(sel)
        got = kernels.topk_candidates_traced(tk, ts, desc, c)
        want = kernels.topk_candidates_plain(tk, ts, desc, c)
        again = kernels.topk_candidates(tk, ts, desc, c)
        _exact(f"K7 {what}", list(got[:2]), list(want), list(again))
        expect = kernels.topk_candidates_path_plain(tk, ts, desc, c)
        require(got[2] == expect, f"K7 {what}: the {got[2]} path ran, the "
                f"model predicts {expect}")
        paths[got[2]] = paths.get(got[2], 0) + 1
    # a sel view that starts off a 16-byte boundary
    full = rng.random(n + 3) < 0.5
    key = spread(np.int64, n)
    ts = t(full)[3:]
    tk = t(key)
    got = kernels.topk_candidates_traced(tk, ts, True, 256)
    _exact("K7 misaligned sel", list(got[:2]),
           list(kernels.topk_candidates_plain(tk, ts, True, 256)),
           list(kernels.topk_candidates(tk, ts, True, 256)))
    paths[got[2]] = paths.get(got[2], 0) + 1
    torch.cuda.synchronize()
    require(set(paths) == set(kernels.K7_PATHS),
            f"K7: the edge cases ran the paths {paths}, not all three")
    print(f"K7: {len(cases) + 1} edge cases equal the plain version bit "
          f"for bit, twice, on the paths the model predicts: {paths}",
          flush=True)
    return {"cases": len(cases) + 1, "paths": paths}


def k15_cases(rows: int = 1 << 20, big: int = 1 << 24) -> list:
    """K15's edge cases as numpy arrays, each with the route `k15_route`
    gives it: (what, key columns, live mask, route). `rows` and `big` set
    their sizes (the CPU tests build them smaller)."""
    import numpy as np

    rng = np.random.default_rng(1515)
    n = rows

    def ints(hi, m=n, dtype=np.int64):
        return rng.integers(0, hi, m).astype(dtype)

    def floats(dtype):
        v = rng.integers(-20, 20, n).astype(dtype) / 4
        v[rng.random(n) < 0.05] = np.nan
        v[rng.random(n) < 0.05] = -0.0
        v[rng.random(n) < 0.05] = 0.0
        return v.astype(dtype)

    i64 = np.iinfo(np.int64)
    half = rng.random(n) < 0.5
    blocks = (np.arange(n) // 1000) % 3 != 1
    return [
        ("ties", [ints(50, dtype=np.int32), ints(30)], half, "image"),
        ("dead rows between live ones",
         [ints(1 << 20), ints(1000, dtype=np.int32)], blocks, "image"),
        ("no live row", [ints(7), ints(1 << 16)], np.zeros(n, bool), "image"),
        ("every row live", [ints(7), ints(1 << 16)], np.ones(n, bool),
         "image"),
        ("one row", [ints(5, 1), ints(9, 1)], np.ones(1, bool), "rows"),
        ("a constant key", [np.full(n, 7, np.int32), ints(5000)], half,
         "image"),
        ("keys in row order", [np.sort(ints(100)), np.arange(n) // 3],
         np.ones(n, bool), "rows"),
        ("a value in row order", [ints(100, dtype=np.int32), np.arange(n)],
         half, "record"),
        ("keys past 64 bits", [rng.integers(i64.min, i64.max, n),
                               rng.integers(i64.min, i64.max, n)], half,
         "record"),
        ("float64 with NaN and -0.0", [ints(9, dtype=np.int32),
                                       floats(np.float64)], half, "record"),
        ("float32 beside int8", [ints(9, dtype=np.int8),
                                 floats(np.float32)], half, "record"),
        ("one-pass composite", [ints(2, dtype=np.bool_),
                                ints(6, dtype=np.int8)], half, "record"),
        ("17 keys", [ints(3, dtype=np.int32) for _ in range(17)], half,
         "columns"),
        ("17 narrow keys", [ints(3, dtype=np.int8) for _ in range(16)]
         + [ints(300, dtype=np.int16)], half, "record"),
        ("many rows", [ints(3, big, np.int32), ints(2, big, np.int32),
                       ints(100000, big)], rng.random(big) < 0.98, "image"),
    ]


def k15_synthetic(kernels, dev) -> dict:
    """K15 on its edge cases (`k15_cases`: ties, dead rows between live
    ones, no live row, every row live, one row, a constant key, keys in
    row order (no sort at all), a value in row order (K3 drops it: the
    record route), keys past 64 bits, float keys with NaN and -0.0, a
    one-pass composite, 17 keys (past a 32-byte record: the columns
    route), 17 narrow keys, 16M rows), each on the route `k15_route` must
    send it (read back from `sort_order_images`), against
    `first_occurrence_plain` over the plain order bit for bit, and again
    through `distinct_first_mask`; then the record and columns routes
    forced on an image-route case. Returns {"cases": n, "routes": {route:
    n}}."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.ops.hashagg import distinct_first_mask

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = k15_cases()
    routes: dict = {}
    for what, cols, mask, route in cases:
        tc, tm = [t(c) for c in cols], t(mask)
        desc = [False] * len(tc)
        s = kernels.sort_order_images(tc, desc, tm)
        require(s.route == route, f"K15 {what}: the {s.route} route, not "
                f"the {route} route the rule gives")
        if s.images is not None:
            got = kernels.first_occurrence_images(s)
        else:
            got = kernels.first_occurrence(tc, tm, s.order, s.route)
        want = kernels.first_occurrence_plain(
            tc, tm, kernels.sort_order_plain(tc, desc, tm))
        again = distinct_first_mask(tc[:-1], tc[-1], tm)
        _exact(f"K15 {what}", got, want, again)
        routes[route] = routes.get(route, 0) + 1
    # the order routes forced where the image route would run
    _what, cols, mask, _route = cases[1]
    tc, tm = [t(c) for c in cols], t(mask)
    order = kernels.sort_order(tc, [False] * len(tc), tm)
    want = kernels.first_occurrence_plain(tc, tm, order)
    for route in ("record", "columns"):
        _exact(f"K15 {route} route forced",
               kernels.first_occurrence(tc, tm, order, route), want,
               kernels.first_occurrence(tc, tm, order, route))
    torch.cuda.synchronize()
    require(set(routes) == set(kernels.K15_ROUTES),
            f"K15: the edge cases ran the routes {routes}, not all four")
    print(f"K15: {len(cases) + 2} edge cases equal the plain version bit for "
          f"bit, twice, on the routes the rule gives: {routes}", flush=True)
    return {"cases": len(cases) + 2, "routes": routes}


def k13_synthetic(kernels, dev) -> dict:
    """K13's entries on their edge cases against the plain versions: a
    ragged last tile (1, 17, a tile - 1, a tile, a tile + 1, 3 tiles + 17
    and 1,000,003 rows), segments that cross many tiles, a flag on every
    row and on none, NaN and -0.0 among float values; the run flags over
    int64, float64 (NaN, -0.0), int8 and bool keys. Integers, min/max and
    the marks exactly (floats by value: -0.0 == 0.0, NaN where the plain
    version has NaN); float64 sums within rel 1e-12 of the running sum of
    |x|, float32 sums within one float32 ulp of the float64 cumsum plus
    that; every entry twice, bit-identical, and float sums also at
    15,000,577 rows. Returns {"cases": n}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1313)
    tile = kernels.K13_TILE
    count = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def twice(what, fn):
        a, b = fn(), fn()
        require(torch.equal(_bits(a), _bits(b)), f"K13 {what}: two runs "
                "differ in their bits")
        return a

    def same_values(what, got, want):
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"K13 {what}: dtype/shape differs from the plain version")
        if got.dtype.is_floating_point:
            nan = torch.isnan(want)
            ok = torch.equal(torch.isnan(got), nan) and bool(
                (got[~nan] == want[~nan]).all())
        else:
            ok = torch.equal(got, want)
        require(ok, f"K13 {what}: differs from the plain version")

    def sum_close(what, got, x):
        x64 = x.to(torch.float64)
        ref = torch.cumsum(x64, 0)
        scale = torch.cumsum(x64.abs(), 0)
        tol = 1e-12 * scale
        if got.dtype == torch.float32:
            ref = ref.to(torch.float32).to(torch.float64)
            ulp = torch.finfo(torch.float32).eps * ref.abs()
            tol = tol + ulp
        err = (got.to(torch.float64) - ref).abs()
        require(bool((err <= tol).all()), f"K13 {what}: float sum off by "
                f"{float((err - tol).max())} past its tolerance")

    def values(dtype, m):
        if dtype in (np.float32, np.float64):
            v = rng.normal(0, 1000, m)
            v[rng.random(m) < 0.01] = np.nan
            v[rng.random(m) < 0.01] = -0.0
            v[rng.random(m) < 0.01] = 0.0
            return v.astype(dtype)
        info = np.iinfo(dtype)
        return rng.integers(int(info.min), int(info.max), m,
                            endpoint=True).astype(dtype)

    dtypes = (np.int8, np.int16, np.int32, np.int64, np.uint8, np.float32,
              np.float64)
    for m in (1, 17, tile - 1, tile, tile + 1, 3 * tile + 17, 1_000_003):
        flags = {"random": rng.random(m) < 0.03,
                 "across tiles": rng.random(m) < 2e-5,
                 "every row": np.ones(m, bool),
                 "none": np.zeros(m, bool)}
        for fname, f in flags.items():
            tf = t(f)
            tag = f"{m} rows, flags {fname}"
            for name in ("segment_starts", "peer_ends"):
                got = twice(f"{name} {tag}",
                            lambda: getattr(kernels, name)(tf))
                same_values(f"{name} {tag}", got,
                            getattr(kernels, name + "_plain")(tf))
                count += 1
            for dt in dtypes:
                tv = t(values(dt, m))
                for name in ("segmented_scan_minmax", "suffix_scan_minmax"):
                    for is_min in (True, False):
                        what = f"{name} {np.dtype(dt).name} min {is_min} {tag}"
                        got = twice(what, lambda: getattr(kernels, name)(
                            tv, tf, is_min))
                        same_values(what, got, getattr(
                            kernels, name + "_plain")(tv, tf, is_min))
                        count += 1
        for dt in (np.int64, np.float32, np.float64):
            tv = t(values(dt, m))
            if dt != np.int64:
                tv = torch.nan_to_num(tv)
            what = f"prefix_sum {np.dtype(dt).name} {m} rows"
            got = twice(what, lambda: kernels.prefix_sum(tv))
            if dt == np.int64:
                same_values(what, got, kernels.prefix_sum_plain(tv))
            else:
                sum_close(what, got, tv)
            count += 1
        fk = rng.integers(-2, 2, m) / 2
        fk[rng.random(m) < 0.01] = np.nan
        fk[fk == 0] = rng.choice([0.0, -0.0], int((fk == 0).sum()))
        keys = [t(rng.integers(0, 3, m)), t(fk),
                t(rng.integers(-2, 2, m).astype(np.int8)),
                t(rng.random(m) < 0.5)]
        what = f"boundaries {m} rows"
        got = twice(what, lambda: kernels.boundaries(keys))
        same_values(what, got, kernels.boundaries_plain(keys))
        count += 1
    big = t(rng.normal(0, 1e6, 15_000_577))
    for x in (big, big.to(torch.float32)):
        what = f"prefix_sum {x.dtype} 15,000,577 rows"
        sum_close(what, twice(what, lambda: kernels.prefix_sum(x)), x)
        count += 1
    torch.cuda.synchronize()
    print(f"K13: {count} edge cases equal the plain versions (float sums "
          f"within their tolerance), each twice bit-identical", flush=True)
    return {"cases": count}


def k17_synthetic(kernels, dev) -> dict:
    """K17 on its edge cases against its plain version, every output bit
    for bit and twice: a slice starting at every residue mod 16 (the
    kernel copies 16 bytes a thread by funnel shifts), an empty range, a
    low bound past the high one, a range wider than the slice (overflow),
    a slice clipped at the table's end with a capacity that is no multiple
    of 16, 17 bounds, int8 / int16 / int64 bounds against int8, int32 and
    int64 keys, 5 columns of every width and 40 (a table past the kernel's
    64 parameter entries, in device memory), and a 15,000,577-row table.
    Returns {"cases": n}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1717)
    count = 0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def check(what, key, n, lows, highs, cap, pay, sel):
        nonlocal count

        def run(fn):
            o, s_, r_, v_ = fn(key, n, lows, highs, cap, pay, sel)
            return [*o, s_, r_, v_]

        got, again = run(kernels.slice_scan), run(kernels.slice_scan)
        want = run(kernels.slice_scan_plain)
        for i, (g, a, w) in enumerate(zip(got, again, want)):
            require(g.dtype == w.dtype and g.shape == w.shape
                    and torch.equal(g, w), f"K17 {what}: output {i} differs "
                    "from the plain version")
            require(torch.equal(g, a), f"K17 {what}: two runs differ")
        count += 1

    n, cap2 = 3000, 4096
    widths = (np.int64, np.int16, np.int8, np.int32, np.bool_)
    cols = [t(rng.integers(-100, 100, cap2).astype(w)) for w in widths]
    sel = t((rng.random(cap2) < 0.9) & (np.arange(cap2) < n))
    for kdt, bdts in ((np.int32, (np.int16, np.int64)),
                      (np.int64, (np.int8, np.int32)),
                      (np.int8, (np.int16, np.int8))):
        if kdt is np.int8:
            keys = np.sort(rng.integers(-128, 128, n))
        else:
            keys = np.arange(n)
        key = t(np.concatenate([keys, np.zeros(cap2 - n)]).astype(kdt))
        for bdt in bdts:
            def b(v, side, dt=bdt):
                # numpy's astype wraps a value past the bound's width
                return (t(np.array([v]).astype(dt)).reshape(()), side)

            cases = [(f"residue {r}", [b(512 + r, "left")],
                      [b(512 + r + 700, "left")], 1024) for r in range(16)]
            cases += [
                ("empty", [b(200, "left")], [b(200, "left")], 1024),
                ("lo above hi", [b(300, "right")], [b(100, "left")], 1024),
                ("overflow", [b(10, "left")], [b(2900, "right")], 1024),
                ("clip at the end", [b(2990, "left")], [], 1029),
                ("17 bounds", [b(v, s) for v, s in zip(
                    rng.integers(100, 700, 9), ["left", "right"] * 5)],
                 [b(v, s) for v, s in zip(rng.integers(900, 1500, 8),
                                          ["right", "left"] * 4)], 1024)]
            for what, lows, highs, cap in cases:
                for pay in (cols, (cols * 8)[:40]):
                    check(f"{what} ({kdt.__name__} key, {bdt.__name__} "
                          f"bounds, {len(pay)} columns)", key, n, lows,
                          highs, cap, pay, sel)
    big = 15_000_577
    key = torch.sort(torch.randint(0, 1 << 20, (big,), device=dev)).values
    pay = [key, key.to(torch.int32), (key & 1).to(torch.bool)]
    bsel = torch.rand(big, device=dev) < 0.9
    for r in range(3):
        lo = torch.tensor(300_001 + r, dtype=torch.int64, device=dev)
        hi = torch.tensor(700_003, dtype=torch.int64, device=dev)
        check(f"{big} rows", key, big - r, [(lo, "left")], [(hi, "right")],
              big // 2 + 13, pay, bsel)
    print(f"kernel K17_slice_scan: {count} synthetic cases bit-identical to "
          "the plain version (every start residue mod 16, empty, lo > hi, "
          "overflow, clipped, 17 bounds, narrow bounds, 40 columns, "
          f"{big} rows), two runs bit-identical", flush=True)
    return {"cases": count}


def k24_paths(kernels, dev) -> dict:
    """K24's two row widths and its uniform values on the card, against
    the plain version bit for bit: Q6's predicate form (8 rows a thread),
    the same tree on 4 rows, an AND of
    40 compares (a chunk's file past FILE8_BYTES a row: 4 rows), and a
    program whose row code reads only uniform values (a constant column
    stored from the prologue). 1,000,003 rows, a capacity no multiple of a
    tile.
    Returns {"cases": n, "paths": [...]}."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.core.column import ColumnBatch
    from oceanbase_tpu_torch.core.dtypes import DataType, Field, Schema
    from oceanbase_tpu_torch.expr import compile as xc
    from oceanbase_tpu_torch.expr import ir as E
    from oceanbase_tpu_torch.expr import program as xp

    rng = np.random.default_rng(2424)
    cap = 1_000_003
    cols = {"d": rng.integers(8000, 10600, cap).astype(np.int32),
            "disc": rng.integers(0, 11, cap).astype(np.int32),
            "q": rng.integers(100, 5100, cap).astype(np.int32),
            "i64": rng.integers(-2**40, 2**40, cap)}
    types = {"d": DataType.date(), "disc": DataType.decimal(12, 2),
             "q": DataType.decimal(12, 2), "i64": DataType.int64()}
    b = ColumnBatch(
        cols={k: torch.from_numpy(v).to(dev) for k, v in cols.items()},
        valid={}, sel=torch.from_numpy(rng.random(cap) < 0.95).to(dev),
        nrows=torch.tensor(0, device=dev),
        schema=Schema(tuple(Field(k, types[k]) for k in cols)), dicts={})
    c, lit = E.ColRef, E.Literal
    dec2 = DataType.decimal(12, 2)
    q6 = E.BoolOp("and", (
        E.Compare(">=", c("d"), lit("1994-01-01", DataType.date())),
        E.Compare("<", c("d"), lit("1995-01-01", DataType.date())),
        E.Between(c("disc"), lit(0.05, dec2), lit(0.07, dec2)),
        E.Compare("<", c("q"), lit(24, DataType.int64()))))
    wide = E.BoolOp("and", tuple(
        E.Compare("<", c("i64"), lit(i * 1000, DataType.int64()))
        for i in range(40)))

    def lowered(e):
        return xp.lower((e,), b, xc._route, xc._predicate_route,
                        xc.set_params, {}, False, True)

    def same(prog, what):
        got = kernels.fused_expr(prog, b)
        again = kernels.fused_expr(prog, b)
        want = kernels.fused_expr_plain(prog, b)
        for g, a, w in zip(got, again, want):
            require(_same_t(g, w), f"K24 {what}: differs from the plain "
                    "version")
            require(_same_t(g, a), f"K24 {what}: two runs differ")

    def shape(prog):
        return [(ch.rows, ch.n32, ch.n64) for ch in prog.chunks]

    paths = []
    p8 = lowered(q6)
    require([ch.rows for ch in p8.chunks] == [8],
            "K24: Q6's predicate form left 8 rows a thread")
    same(p8, "Q6's form on 8 rows")
    paths.append(("q6 form", shape(p8)))
    keep = xp.FILE8_BYTES
    xp.FILE8_BYTES = 0
    try:
        p4 = lowered(q6)
    finally:
        xp.FILE8_BYTES = keep
    require([ch.rows for ch in p4.chunks] == [4],
            "K24: a zero threshold did not take 4 rows")
    same(p4, "Q6's form on 4 rows")
    for g, w in zip(kernels.fused_expr(p8, b), kernels.fused_expr(p4, b)):
        require(_same_t(g, w), "K24: the two row widths differ on Q6's form")
    paths.append(("q6 form, 4 rows", shape(p4)))
    p_wide = lowered(wide)
    require(any(ch.rows == 4 for ch in p_wide.chunks),
            "K24: 40 live compares took no chunk to 4 rows")
    same(p_wide, "an AND of 40 compares")
    paths.append(("and of 40", shape(p_wide)))
    # a row code of uniform operands only: zeros_like(column) + 5, stored
    rec = xp._Recorder(b.cols, b.valid, {})
    tb = xp.TraceBatch(rec, b)
    col = tb.cols["i64"]
    s5 = rec.binary("add", torch.zeros_like(col), 5)
    p_uni = xp.Program()
    p_uni.out_dtypes = [rec.vtype[s5.vid]]
    p_uni.pairs = [(0, None)]
    xp.schedule(rec.ins, rec.vtype, [s5.vid], p_uni)
    require(all(x & xp.UNI for ch in p_uni.chunks for op, *r in ch.code
                if op == xp.OP_STORE for x in r[2:3]),
            "K24: the constant column is not stored from the prologue")
    same(p_uni, "a store of uniform values")
    require(bool((kernels.fused_expr(p_uni, b)[0] == 5).all()),
            "K24: the uniform store is not 5 on every row")
    paths.append(("uniform store", shape(p_uni)))
    print(f"kernel K24_fused_expr: both row widths and a uniform store "
          f"bit-identical to the plain version on {cap} rows: {paths}",
          flush=True)
    return {"cases": 4, "paths": paths}


def k2_domain_phase(small, Session, uk, kernels) -> dict:
    """The direct GROUP BY past 64 packed slots on the card against the
    CPU, every row bit for bit: the statement whose 5 x 3 x 3 groups pack
    into 128 slots at SF 0.1, and two dictionary keys of 5 values, one
    nullable (50 dense slots, 128 packed) with and without a key of
    domain 1, over 200,000 rows. Each must take the direct path (the
    domains recorded at engine.executor.groupby_direct) and launch K2 on
    the card. Returns one record per statement."""
    import numpy as np
    import torch

    import oceanbase_tpu_torch.engine.executor as ex
    from oceanbase_tpu_torch.core.table import table_from_arrays

    rng = np.random.default_rng(1818)
    m = 200_000
    data = {"a": rng.integers(0, 5, m).astype(np.int32),
            "b": rng.integers(0, 5, m).astype(np.int32),
            "one": np.zeros(m, np.int32),
            "v": rng.integers(-10**6, 10**6, m)}
    valid = {"b": rng.random(m) > 0.2}
    data["b"][~valid["b"]] = 0
    dt = table_from_arrays(
        "kd", [("a", "varchar", 0, 0, False), ("b", "varchar", 0, 0, True),
               ("one", "varchar", 0, 0, False), ("v", "int64", 0, 0, False)],
        data, {"a": [f"a{i}" for i in range(5)],
               "b": [f"b{i}" for i in range(5)], "one": ["only"]}, valid)
    stmts = [
        ("K2_C1", small, K2_C1 + " order by o_orderpriority, o_orderstatus, "
         "l_returnflag", [5, 3, 3]),
        ("K2_NULLABLE", {"kd": dt}, "select a, b, count(*) as n, sum(v) as s,"
         " min(v) as lo from kd group by a, b order by a, b", [5, 5, 2]),
        ("K2_DOMAIN1", {"kd": dt}, "select one, a, b, count(*) as n, "
         "max(v) as hi from kd group by one, a, b order by a, b",
         [1, 5, 5, 2])]
    seen = []
    orig = ex.groupby_direct

    def counted(keys, domains, *a, **kw):
        seen.append(list(domains))
        return orig(keys, domains, *a, **kw)

    ex.groupby_direct = counted
    recs = []
    try:
        for name, tables, text, doms in stmts:
            rows = {}
            for dev in ("cuda", "cpu"):
                seen.clear()
                k0 = kernels.LAUNCHES["K2_groupby_direct"]
                sess = Session(tables, unique_keys=uk, device=dev)
                rs = sess.sql(text)
                rows[dev] = row_bits(rs.rows())
                require(doms in seen, f"{name} on {dev}: not the direct path "
                        f"over {doms} (saw {seen})")
                if dev == "cuda":
                    torch.cuda.synchronize()
                    require(kernels.LAUNCHES["K2_groupby_direct"] > k0,
                            f"{name}: K2 was not launched on the card")
                del sess
            require(rows["cuda"] == rows["cpu"], f"{name}: the card's rows "
                    "differ from the CPU's")
            dense, slots = kernels.k2_layout(doms)[:2]
            print(f"{name}: {len(rows['cuda'])} rows on the card equal to the "
                  f"CPU's, direct path over {doms} ({dense} dense slots, "
                  f"{slots} packed)", flush=True)
            recs.append({"statement": name, "rows": len(rows["cuda"]),
                         "domains": doms, "dense": dense, "packed": slots})
    finally:
        ex.groupby_direct = orig
    return recs


def call_launches(kernels, name: str, fn) -> int:
    """The kernels one fn() call launched for K2 or K10, by the library's
    own count at each launch (`kernels.kernel_launches`)."""
    import torch

    torch.cuda.synchronize()
    k0 = kernels.kernel_launches(name)
    fn()
    torch.cuda.synchronize()
    return kernels.kernel_launches(name) - k0


def _same_bits(torch, got, want, what: str) -> None:
    """Each tensor of `got` equals its twin in `want`: dtype, shape and
    values, NaN equal to NaN."""
    require(len(got) == len(want), f"{what}: {len(got)} outputs, want "
            f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{what}: output {i} is {g.dtype} {tuple(g.shape)}, the "
                f"plain version's {w.dtype} {tuple(w.shape)}")
        ok = torch.equal(g, w) if not g.dtype.is_floating_point else bool(
            ((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
        require(ok, f"{what}: output {i} differs from the plain version")


def k10_edge_phase(kernels, dev=None) -> list:
    """K10's edge shapes at card sizes: every output of expand_join equal
    to expand_join_plain bit for bit (and two runs alike), join_ranges to
    join_ranges_plain, with the kernels each call launched (2 for an
    expansion with slots, 1 without, 1 for the range search alone). Shapes: one probe row whose run spans many output
    tiles; runs across tile edges (probe rows not a multiple of the tile);
    a sorted probe against the same keys in random order; a window of live
    keys wider than the shared tile (fan-out 20); the pairs' total above,
    equal to and below the capacity, and capacity 0; all dead on either
    side; int64 extremes (live build keys of int64 max beside the dead
    tail's); probe keys and sel at unaligned addresses; one probe row; and
    Q21's kind (1.5% of a sorted probe live, the capacity twice the rows:
    the slots past the total dominate). The launches are the library's own
    count (`call_launches`). Returns one record a case."""
    import torch

    dev = dev or torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1919)
    i64max = torch.iinfo(torch.int64).max

    def build(keys, live):
        """sort_build_side's layout: live keys ascending, the dead after
        them as int64 max; order the row of each sorted position."""
        k = torch.where(live, keys, i64max)
        sk, order = torch.sort(k, stable=True)
        nl = live.sum().reshape(())
        return sk.contiguous(), order.to(torch.int32), nl

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), device=dev, generator=g,
                             dtype=torch.int64)

    def frac(n, p):
        return torch.rand(n, device=dev, generator=g) < p

    cases = []
    # one probe row's run spans many fill tiles
    bk = torch.cat([torch.full((300_000,), 7, device=dev,
                               dtype=torch.int64), ints(700_000, 8, 10**6)])
    sk, od, nl = build(bk, frac(1_000_000, 0.9))
    pk = ints(10_000, 8, 10**6)
    pk[4321] = 7
    cases.append(("long_run", sk, od, nl, pk, frac(10_000, 0.7)
                  | (torch.arange(10_000, device=dev) == 4321)))
    # sorted probe across tile edges, then the same keys in random order
    bk = ints(3_000_000, 0, 1_000_000)
    sk, od, nl = build(bk, frac(3_000_000, 0.8))
    pk = ints(1_000_003, 0, 1_000_000).sort().values
    ps = frac(1_000_003, 0.6)
    cases.append(("tile_edges", sk, od, nl, pk, ps))
    perm = torch.randperm(1_000_003, device=dev, generator=g)
    cases.append(("random_order", sk, od, nl, pk[perm].contiguous(),
                  ps[perm].contiguous()))
    # fan-out 20: a tile's window of live keys is wider than shared memory
    bk = ints(4_000_000, 0, 200_000)
    sk, od, nl = build(bk, torch.ones(4_000_000, device=dev,
                                      dtype=torch.bool))
    cases.append(("wide_window", sk, od, nl,
                  ints(600_000, 0, 200_000).sort().values,
                  frac(600_000, 0.9)))
    # all dead on either side
    bk = ints(500_000, 0, 1000)
    sk, od, nl = build(bk, torch.zeros(500_000, device=dev, dtype=torch.bool))
    cases.append(("dead_build", sk, od, nl, ints(70_001, 0, 1000),
                  frac(70_001, 0.9)))
    sk, od, nl = build(bk, frac(500_000, 0.5))
    cases.append(("dead_probe", sk, od, nl, ints(70_001, 0, 1000),
                  torch.zeros(70_001, device=dev, dtype=torch.bool)))
    # int64 extremes: live build keys of int64 max and min beside the tail
    bk = ints(200_000, -50, 50)
    bk[:1000] = i64max
    bk[1000:2000] = torch.iinfo(torch.int64).min
    sk, od, nl = build(bk, frac(200_000, 0.7))
    pk = ints(100_000, -60, 60)
    pk[::5] = i64max
    pk[1::7] = torch.iinfo(torch.int64).min
    cases.append(("int64_extremes", sk, od, nl, pk, frac(100_000, 0.8)))
    # unaligned probe keys and sel (views one element in)
    bk = ints(800_000, 0, 100_000)
    sk, od, nl = build(bk, frac(800_000, 0.9))
    pk = ints(300_001, 0, 100_000)
    ps = frac(300_001, 0.5)
    cases.append(("unaligned", sk, od, nl, pk[1:], ps[1:]))
    cases.append(("one_row", sk, od, nl, pk[:1].clone(),
                  torch.ones(1, device=dev, dtype=torch.bool)))
    # Q21's kind: a sorted probe, 1.5% live, the capacity twice the rows
    bk = ints(1 << 23, 0, 1 << 21).sort().values
    sk, od, nl = build(bk, torch.arange(1 << 23, device=dev) < (1 << 23) - 77)
    cases.append(("q21_kind", sk, od, nl, bk.clone(), frac(1 << 23, 0.015)))

    recs = []
    for name, sk, od, nl, pk, ps in cases:
        want_cnt = kernels.join_ranges_plain(sk, nl, pk, ps)
        total = int(want_cnt.sum())
        npr = int(pk.numel())
        caps = ([total, max(total - 1, 0), total + 4097, 0]
                if name in ("long_run", "tile_edges")
                else [2 * npr + 1024] if name == "q21_kind" else [total + 333])
        for cap in caps:
            def call(cap=cap):
                return list(kernels.expand_join(sk, od, nl, pk, ps, cap))

            got = call()
            _same_bits(torch, got, list(kernels.expand_join_plain(
                sk, od, nl, pk, ps, cap)), f"K10 {name} cap {cap}")
            _same_bits(torch, call(), got, f"K10 {name} cap {cap} run 2")
            n_k = call_launches(kernels, "K10", call)
            require(n_k == (2 if cap > 0 else 1), f"K10 {name} cap {cap}: "
                    f"{n_k} launches a call")
            recs.append({"case": name, "probe_rows": npr,
                         "build_rows": int(sk.numel()), "nlive": int(nl),
                         "live": int(ps.sum()), "total": total, "cap": cap,
                         "launches": n_k})
        got = kernels.join_ranges(sk, nl, pk, ps)
        _same_bits(torch, [got], [want_cnt], f"K10 ranges {name}")
        n_r = call_launches(kernels, "K10",
                            lambda: kernels.join_ranges(sk, nl, pk, ps))
        require(n_r == 1, f"K10 ranges {name}: {n_r} launches a call")
        recs[-1]["ranges_launches"] = n_r
        print(f"k10_edge {name}: {npr} probe rows, {int(ps.sum())} live, "
              f"{total} pairs, caps {caps}: the six outputs and the counts "
              f"bit-identical to the plain versions, 2 launches an "
              f"expansion, 1 a range search", flush=True)
    return recs


def k2_edge_phase(kernels, dev=None, n: int = 4_000_037) -> list:
    """K2's edge shapes at card sizes against groupby_slots_plain, two
    runs alike in their bits: integer results exact, float64 sums to rel
    1e-12, float32 sums to rel 1e-4 (the plain version adds in float32,
    the kernel in double), min and max exact with NaN; each call's
    launches, by the library's own count (`call_launches`), equal to its
    split plan (`k2_split`), LAUNCHES counting each. Shapes: Q1's repeated aggregates (10 over 6
    distinct, one mask); per-aggregate masks beside a shared one; int8,
    int16, int32, int64, uint8 and bool values; float32 and float64 with
    NaN under min and max; more aggregates than a launch takes (40 over 64
    dense slots); keys, masks and values at odd offsets with a length not
    a multiple of 16; 70 repeats of one count; one row; `n` rows (the
    views n // 4 + 3). Returns one record a case."""
    import torch

    dev = dev or torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(219)

    def ints(n, lo, hi, dt=torch.int64):
        return torch.randint(lo, hi, (n,), device=dev, generator=g,
                             dtype=dt)

    def frac(n, p):
        return torch.rand(n, device=dev, generator=g) < p

    cases = []
    k = ints(n, 0, 6, torch.int32)
    m = frac(n, 0.97)
    q, p = ints(n, 1, 51, torch.int32), ints(n, 90_000, 10_500_000)
    cases.append(("repeats", k, [3, 2], [
        ("count", None, m), ("sum", q, m), ("sum", p, m), ("count", None, m),
        ("sum", q, m), ("min", p, m), ("count", None, m), ("max", q, m),
        ("count", None, m), ("sum", p, m)]))
    m2, m3 = frac(n, 0.5), frac(n, 0.1)
    cases.append(("masks", k, [3, 2], [
        ("count", None, m), ("sum", q, m2), ("count", None, m3),
        ("max", p, m2), ("sum", p, m), ("min", q, m3)]))
    vals = [ints(n, -128, 128, torch.int8), ints(n, -30000, 30000,
                                                  torch.int16),
            ints(n, -2**31, 2**31 - 1, torch.int32), ints(n, -2**62, 2**62),
            ints(n, 0, 256, torch.uint8), frac(n, 0.5)]
    cases.append(("int_types", k, [3, 2], [
        (op, v, m2) for v in vals
        for op in (("sum",) if v.dtype == torch.bool else ("sum", "min",
                                                           "max"))]))
    f64 = torch.randn(n, device=dev, generator=g, dtype=torch.float64) * 1e3
    f64[::1001] = float("nan")
    f32 = (torch.randn(n, device=dev, generator=g) * 1e3).to(torch.float32)
    f32[5::2003] = float("nan")
    fm = frac(n, 0.8)
    fm[::1001] = False  # NaN reaches min and max through the other mask
    cases.append(("floats", k, [3, 2], [
        ("sum", f64, fm), ("min", f64, m), ("max", f64, m), ("sum", f32, fm),
        ("min", f32, m), ("max", f32, m), ("sum", f64, m)]))
    k64 = ints(n, 0, 64)
    cases.append(("split", k64, [4, 4, 4], [
        (("sum", "min", "max", "count")[i % 4],
         ints(n, -10**6, 10**6) if i % 4 != 3 else None, frac(n, 0.9))
        for i in range(40)]))
    big = n // 4 + 3
    kb, mb = ints(big + 3, 0, 15, torch.int32), frac(big + 3, 0.7)
    vb, wb = ints(big + 1, -10**9, 10**9), ints(big + 3, -1000, 1000,
                                                 torch.int32)
    cases.append(("views", kb[3:], [3, 5], [
        ("count", None, mb[1:big + 1]), ("sum", vb[1:], mb[1:big + 1]),
        ("min", wb[3:], mb[2:big + 2]), ("max", vb[1:], mb[3:])]))
    cases.append(("many_outs", k, [3, 2], [("count", None, m)] * 70
                  + [("sum", q, m)]))
    cases.append(("one_row", k[:1].clone(), [3, 2], [
        ("count", None, m[:1].clone()), ("sum", p[:1].clone(),
                                         m[:1].clone())]))

    recs = []
    for name, keys, doms, aggs in cases:
        def call():
            return kernels.groupby_slots(keys, doms, aggs)

        l0 = kernels.LAUNCHES["K2_groupby_direct"]
        got = call()
        torch.cuda.synchronize()
        plan = kernels.k2_plan(keys, doms, aggs,
                               kernels._sm_count(keys.device))
        require(kernels.LAUNCHES["K2_groupby_direct"] - l0
                == len(plan.launches), f"K2 {name}: LAUNCHES counted "
                f"{kernels.LAUNCHES['K2_groupby_direct'] - l0}, the plan "
                f"has {len(plan.launches)} launches")
        want = kernels.groupby_slots_plain(keys, doms, aggs)
        _same_bits(torch, call(), got, f"K2 {name} run 2")
        worst = 0.0
        for i, ((op, v, _m), a, b) in enumerate(zip(aggs, got, want)):
            require(a.dtype == b.dtype and a.shape == b.shape,
                    f"K2 {name} aggregate {i}: {a.dtype} {tuple(a.shape)} "
                    f"against {b.dtype} {tuple(b.shape)}")
            if op == "sum" and a.dtype.is_floating_point:
                tol = 1e-12 if a.dtype == torch.float64 else 1e-4
                fa, fb = a.to(torch.float64), b.to(torch.float64)
                both = torch.isnan(fa) & torch.isnan(fb)
                rel = torch.where(both, 0.0, (fa - fb).abs()
                                  / fb.abs().clamp(min=1e-300))
                rel = float(rel.max())
                require(rel <= tol, f"K2 {name} aggregate {i}: rel error "
                        f"{rel} above {tol}")
                worst = max(worst, rel)
            else:
                _same_bits(torch, [a], [b], f"K2 {name} aggregate {i}")
        n_k = call_launches(kernels, "K2", call)
        require(n_k == len(plan.launches), f"K2 {name}: {n_k} kernels a "
                f"call, the plan has {len(plan.launches)}")
        uniq, _ix = kernels.k2_unique(aggs)
        recs.append({"case": name, "rows": int(keys.numel()),
                     "domains": doms, "aggregates": len(aggs),
                     "distinct": len(uniq), "launches": n_k,
                     "max_rel_err_float_sum": worst})
        print(f"k2_edge {name}: {int(keys.numel())} rows, {len(aggs)} "
              f"aggregates ({len(uniq)} distinct) in {n_k} launches, equal "
              f"to the plain version (float sums rel {worst:.3e}), two runs "
              f"bit-identical", flush=True)
    return recs


def k12_float_check(kernels, dev) -> int:
    """K12 over float64 and float32 key columns (with -0.0 beside 0.0) and
    beside an integer column, against `hash_columns_plain` bit for bit,
    twice; equal values hash alike. Returns the number of cases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(12)
    n = 1 << 23
    f64 = rng.integers(-400, 400, n) / 4
    f64[rng.random(n) < 0.05] = -0.0
    f32 = (rng.integers(-400, 400, n) / 8).astype(np.float32)
    f32[rng.random(n) < 0.05] = -0.0
    i32 = rng.integers(-1000, 1000, n).astype(np.int32)
    cols = {"f64": torch.from_numpy(f64).to(dev),
            "f32": torch.from_numpy(f32).to(dev),
            "i32": torch.from_numpy(i32).to(dev)}
    combos = (("f64",), ("f32",), ("f64", "i32"), ("f32", "f64", "i32"))
    for combo in combos:
        cs = [cols[c] for c in combo]
        _exact(f"K12 over {combo}", kernels.hash_columns(cs),
               kernels.hash_columns_plain(cs), kernels.hash_columns(cs))
    z = torch.tensor([0.0, -0.0, 2.5, 2.5], dtype=torch.float64,
                     device=dev)
    h = kernels.hash_columns([z, torch.tensor([7, 7, 1, 1], device=dev)])
    require(int(h[0]) == int(h[1]) and int(h[2]) == int(h[3]),
            "K12: equal float values hash apart")
    torch.cuda.synchronize()
    print(f"K12: float64 and float32 key columns ({n} rows, "
          f"{len(combos)} column sets) equal the plain version bit for "
          "bit, twice; -0.0 hashes as 0.0", flush=True)
    return len(combos)


def k4_synthetic(kernels, dev) -> int:
    """K4 against its plain version, twice, bit for bit, on edge cases of
    its paths, tiles and index rule: one row; fewer rows than a tile;
    repeated indices; indices in [-n, -1], below -n and at or past n;
    each element width alone (one column, direct by shape; eight columns,
    the image); payloads of 1,
    17, 33 and 79 bytes a row (one record of 16, 32 and 64 bytes, then two
    images); 60 one-byte columns (two images, or two direct launches);
    each path forced by shape (image and direct, random and monotone
    indices; two columns half in order, a pass a column) and an index
    view that is not 16-byte aligned; each case's
    path read back from the device (the bit that the launches doing the
    work set, `kernels.k4_launch` with trace) and required. Then
    K4_REPEAT_RUNS runs at K4_REPEAT_ROWS rows, each bit-identical to the
    first. Returns the number of cases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(44)
    kinds = {1: (np.bool_, np.int8, np.uint8), 2: (np.int16,),
             4: (np.int32, np.float32), 8: (np.int64, np.float64)}

    def column(w, i, n):
        kind = kinds[w][i % len(kinds[w])]
        a = rng.integers(0, 256, n * w, dtype=np.uint8).view(
            np.dtype(f"u{w}"))
        if kind == np.bool_:
            a = (a & 1).astype(np.bool_)
        else:
            a = a.view(kind)
        return torch.from_numpy(a).to(dev)

    def cols_of(widths, n):
        return [column(w, i, n) for i, w in enumerate(widths)]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    s1w = [8, 1, 8, 4, 1]
    # 17 bytes a row in 3 columns of it pass K4_IMAGE_MIN_GATHER (bytes x
    # (columns - 1)), as do 16 in 2 columns of half
    big = 8_000_009
    half = kernels.K4_IMAGE_MIN_GATHER // 16 + 1001
    small = 50_000

    def perm(n):
        return rng.permutation(n)

    def compaction(n):
        live = rng.random(n) < 0.01
        return np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)])

    def half_random(n):
        """Half the rows first in random order, the rest in row order (a
        PX shard's DISTINCT gathers so)."""
        p, live = perm(n), rng.random(n) < 0.5
        return np.concatenate([p[live[p]], np.flatnonzero(~live)])

    wild = np.concatenate([rng.integers(0, big, 400_000),
                           rng.integers(-big, 0, 400_000),
                           rng.integers(big, 4 * big, 100_000),
                           rng.integers(-4 * big, -big, 100_000)])
    rng.shuffle(wild)
    wild[:4] = (-1, -big, big, np.iinfo(np.int32).min)
    cases = [
        ("m = 1", s1w, big, [big // 2], "direct"),
        ("m below a tile", s1w, big, rng.integers(0, big, 700), "direct"),
        ("repeated indices", s1w, big, rng.integers(0, 1000, 2 * big),
         "image"),
        ("negative and out-of-range indices", s1w, big,
         np.concatenate([wild, perm(big)]), "image"),
        ("payload 1 byte", [1], big, perm(big), "direct"),
        ("payload 17 bytes", [8, 8, 1], big, perm(big), "image"),
        ("payload 33 bytes", [8, 8, 8, 8, 1], big, perm(big), "image"),
        ("payload 79 bytes", [8] * 9 + [4, 2, 1], big, perm(big), "image"),
        ("60 one-byte columns, image", [1] * 60, big, perm(big), "image"),
        ("60 one-byte columns, direct", [1] * 60, big, compaction(big),
         "rows (probe)"),
        ("image shape, random", s1w, big, perm(big), "image"),
        ("image shape, monotone", s1w, big, compaction(big),
         "rows (probe)"),
        ("image shape, two columns half in order", [8, 8], half,
         half_random(half), "columns (probe)"),
        ("direct shape, random", s1w, small, perm(small), "direct"),
        ("direct shape, monotone", s1w, small, compaction(small), "direct"),
    ]
    for w in (1, 2, 4, 8):
        cases.append((f"width {w} alone", [w], big, perm(big), "direct"))
        n8 = max(big, kernels.K4_IMAGE_MIN_SOURCE // (8 * w) + 1001)
        cases.append((f"width {w}, eight columns", [w] * 8, n8, perm(n8),
                      "image"))
    for name, widths, n, idx, path in cases:
        cols, ti = cols_of(widths, n), t(idx)
        first, got = kernels.k4_launch(cols, ti, trace=True)
        require(got == path, f"K4 synthetic ({name}): the {got} path, "
                f"not the {path} one")
        _exact(f"K4 synthetic ({name})", first,
               kernels.gather_columns_plain(cols, ti),
               kernels.gather_columns(cols, ti))
        print(f"K4 synthetic ({name}, {len(idx)} of {n} rows, "
              f"{sum(widths)} bytes a row, {path}): exact, two runs "
              f"bit-identical", flush=True)
    # an index that starts 4 bytes past an aligned address
    cols = cols_of(s1w, big)
    ti = t(np.concatenate([[0], perm(big)]))[1:]
    require(ti.data_ptr() % 16 != 0, "K4 synthetic: the view is aligned")
    first, got = kernels.k4_launch(cols, ti, trace=True)
    require(got == "image", f"K4 synthetic (an unaligned index view): the "
            f"{got} path")
    _exact("K4 synthetic (an unaligned index view)", first,
           kernels.gather_columns_plain(cols, ti),
           kernels.gather_columns(cols, ti))
    print("K4 synthetic (an unaligned index view, image): exact, two runs "
          "bit-identical", flush=True)
    n = K4_REPEAT_ROWS
    cols, ti = cols_of(s1w, n), t(perm(n))
    first, got = kernels.k4_launch(cols, ti, trace=True)
    require(got == "image", f"K4 at {n} rows: the {got} path")
    _exact(f"K4 at {n} rows", first, kernels.gather_columns_plain(cols, ti),
           first)
    for r in range(K4_REPEAT_RUNS - 1):
        again = kernels.gather_columns(cols, ti)
        require(all(torch.equal(_bits(a), _bits(b))
                    for a, b in zip(first, again)),
                f"K4 at {n} rows: run {r + 2} differs from run 1")
    print(f"K4 at {n} rows: {K4_REPEAT_RUNS} runs bit-identical, equal to "
          f"the plain version", flush=True)
    return len(cases) + 2


def k4_call_shapes(sess, kernels, texts: dict) -> dict:
    """One more run of each statement with every module's gather_columns
    wrapped: each K4 call's rows, source rows, element widths and path
    (read back from the device, `kernels.k4_launch` with trace), identical
    calls merged with their count."""
    orig = kernels.gather_columns
    calls = []

    def wrapped(cols, idx):
        cols = list(cols)
        if not cols or not idx.numel():
            return orig(cols, idx)
        outs, path = kernels.k4_launch(cols, idx, trace=True)
        calls.append((int(idx.shape[0]), int(cols[0].shape[0]),
                       tuple(c.element_size() for c in cols), path))
        return outs

    mods = [m for k, m in list(sys.modules.items())
            if k.startswith("oceanbase_tpu_torch")
            and getattr(m, "gather_columns", None) is orig]
    got = {}
    for m in mods:
        m.gather_columns = wrapped
    try:
        for name, text in texts.items():
            calls.clear()
            sess.sql(text).nrows
            merged = {}
            for c in calls:
                merged[c] = merged.get(c, 0) + 1
            got[name] = [{"rows": m, "source_rows": n, "widths": list(w),
                          "path": path, "calls": k}
                         for (m, n, w, path), k in merged.items()]
            print(f"K4 calls of {name}: " + "; ".join(
                f"{r['calls']} x {r['rows']} of {r['source_rows']} rows, "
                f"widths {r['widths']}, {r['path']}" for r in got[name]),
                flush=True)
    finally:
        for m in mods:
            m.gather_columns = orig
    return got


def k4_device_ms(stmt_recs, names) -> dict:
    """The k4_* kernels' device ms in each named statement's traced run,
    by kernel and in all."""
    out = {}
    for r in stmt_recs:
        if r["statement"] in names:
            per = {k["name"]: k["ms"] for k in r["device_ms_by_kernel"]
                   if k["name"].startswith("k4_")}
            out[r["statement"]] = {"total": sum(per.values()), **per}
            print(f"k4 device ms of {r['statement']}: {out[r['statement']]}",
                  flush=True)
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
    def columns(rs):
        # host-assembled results (JSON text, recursive CTEs) carry their
        # columns as built; the others their storage-domain columns
        if hasattr(rs, "storage_columns"):
            return rs.storage_columns()
        return {n: np.asarray(rs.columns[n]) for n in rs.names}

    for name, text in stmts:
        crs, prs = card.sql(text), cpu.sql(text)
        if route is not None:
            route(name, crs)
            route(name, prs)
        got = columns(crs)
        want = columns(prs)
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

    def bounds_after(rs):
        out = sliced("P_BOUNDS17")(rs)
        spec = next(iter(rs._cursor.prepared.params.scan_slice.values()))
        nb = len(spec.lows) + len(spec.highs)
        require(nb >= 17, f"P_BOUNDS17: K17 got {nb} bounds, not the 17 "
                "past its old cap of 16")
        out["bounds"] = nb
        return out

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
        ("P_BOUNDS17", P_BOUNDS17, bounds_after),
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
    # K17 sits at parity with its yardstick: both timed in turns
    km, lm = interleaved_ms([k17_run(kernels.slice_scan), k17_library],
                            K17_ROUNDS)
    out[-1]["interleaved"] = {"rounds": K17_ROUNDS, "ms_median": km,
                              "library_ms_median": lm}
    print(f"K17 interleaved over {K17_ROUNDS} rounds: median {km:.6f} ms, "
          f"library median {lm:.6f} ms", flush=True)

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


# ---- the server phase ----------------------------------------------------
# The system's users connect to the MySQL-compatible server: a
# Database(n_nodes=1, n_ls=1) of the port with the TPC-H tables preloaded
# as read-only tables (as tools/ann_smoke.py:85-92 preloads its docs),
# its wire front on localhost, and a DML table it serves.
SERVER_STMTS = (1, 6, 3, 14)
# the head fetch: one year of shipments, ~9.1M of lineitem's 60M rows at
# SF 10, taken LIMIT 10 and LIMIT 1000 from the lazy cursor
HEAD_TEXT = """select l_orderkey, l_linenumber, l_extendedprice from lineitem
where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'"""
HEAD_LIMITS = (10, 1000)
# a point-range read: a filter root's compaction (>= 1024 rows) is wider
# than the narrowed frame (256), so its warm runs compact through K23
LOOKUP_TEXT = ("select l_orderkey, l_linenumber, l_quantity from lineitem "
               "where l_orderkey < 40")
# a result wider than one K23 write pass (48 columns and validity
# planes): SELECT * of a LEFT JOIN onto 40 bigint columns, every fifth
# key unmatched (NULLs): 42 columns + 41 validity planes
WIDE_COLS, WIDE_KEYS = 40, 600
WIDE_TEXT = ("select * from keys_t left join wide_t on keys_t.k = wide_t.id "
             "where keys_t.k {}")
# result-cache repeats per statement: the first admits, the rest hit
RC_REPEATS = 3
# the served DML table: 100,000 rows by 1,000-row INSERTs (~12 s of host
# time at ~8k rows/s), 16 groups
DML_ROWS, DML_BATCH, DML_GROUPS, DML_SEED = 100_000, 1_000, 16, 7
DML_TAGS = ("alpha", "beta", "gamma", "delta")


class WireClient:
    """A minimal MySQL protocol-41 client (handshake v10, native password
    login, COM_QUERY text result sets), as tests/test_mysql_front.py
    carries one."""

    def __init__(self, port: int, user: str = "root", password: str = ""):
        import socket
        import struct

        from oceanbase_tpu_torch.server.mysql_front import (
            native_password_scramble,
        )

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        self.seq = 0
        greeting = self._read()
        require(greeting[0] == 10, "wire: not a protocol-10 greeting")
        nul = greeting.index(b"\x00", 1)
        p = nul + 1 + 4
        salt = greeting[p:p + 8]
        p += 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt += greeting[p:greeting.index(b"\x00", p)]
        auth = native_password_scramble(password, salt[:20])
        self._send(struct.pack("<IIB23x", 0x0200 | 0x8000, 1 << 24, 33)
                   + user.encode() + b"\x00" + bytes([len(auth)]) + auth)
        require(self._read()[0] == 0x00, "wire: login refused")

    def _read(self) -> bytes:
        head = self._read_n(4)
        self.seq = (head[3] + 1) & 0xFF
        return self._read_n(int.from_bytes(head[:3], "little"))

    def _read_n(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            c = self.sock.recv(n - len(buf))
            require(bool(c), "wire: connection closed")
            buf += c
        return buf

    def _send(self, payload: bytes) -> None:
        self.sock.sendall(len(payload).to_bytes(3, "little")
                          + bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) & 0xFF

    @staticmethod
    def _lenenc(buf: bytes, pos: int):
        f = buf[pos]
        if f < 251:
            return f, pos + 1
        width = {0xFC: 2, 0xFD: 3}.get(f, 8)
        return (int.from_bytes(buf[pos + 1:pos + 1 + width], "little"),
                pos + 1 + width)

    def query(self, sql: str):
        """(names, rows of str/None) of a result set, or the OK count."""
        self.seq = 0
        self._send(b"\x03" + sql.encode())
        first = self._read()
        require(first[0] != 0xFF, f"wire: {first[9:].decode()}")
        if first[0] == 0x00:
            return self._lenenc(first, 1)[0]
        ncols, _ = self._lenenc(first, 0)
        names = []
        for _ in range(ncols):
            col, pos, vals = self._read(), 0, []
            for _f in range(6):
                ln, pos = self._lenenc(col, pos)
                vals.append(col[pos:pos + ln])
                pos += ln
            names.append(vals[4].decode())
        require(self._read()[0] == 0xFE, "wire: no EOF after the columns")
        rows = []
        while True:
            pkt = self._read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return names, rows
            pos, row = 0, []
            for _ in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    ln, pos = self._lenenc(pkt, pos)
                    row.append(pkt[pos:pos + ln].decode())
                    pos += ln
            rows.append(tuple(row))

    def close(self) -> None:
        self.seq = 0
        try:
            self._send(b"\x01")
        except OSError:
            pass
        self.sock.close()


def wire_text(v):
    """A result value as the wire front's text protocol writes it
    (server/mysql_front.py `_cell`): floats by repr, so the text carries
    every bit."""
    import numpy as np

    if v is None or (isinstance(v, (float, np.floating)) and v != v):
        return None
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def row_bits(rows) -> list:
    """Rows with every float as its float64 bit pattern: equal lists are
    bit-identical results."""
    import numpy as np

    def cell(v):
        if isinstance(v, (float, np.floating)):
            return ("f", np.float64(v).view(np.int64).item())
        if isinstance(v, (int, np.integer)):
            return ("i", int(v))
        return ("s", v)

    return [tuple(cell(v) for v in r) for r in rows]


def timed(fn, n: int) -> list:
    """Host milliseconds of n calls of fn() (each ends in a device sync)."""
    import torch

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def server_statement(db, fe, esess, kernels, q, text, check, warm) -> dict:
    """One TPC-H statement through the engine Session (the reference rows,
    held to the int64 oracle), through DbSession.sql with the result cache
    off (cold, warm fast-tier hits, one traced run), from the result
    cache, and over the wire."""
    import torch

    name = f"Q{q}"
    erows = []

    def eng():
        rs = esess.sql(text)
        erows[:] = [rs]
        return rs.nrows

    e_ms = timed(eng, warm + 1)
    n = check(erows[0])
    ref = erows[0].rows()
    require(len(ref) == n, f"server {name}: engine rows")
    # DbSession.sql, result cache off: the fast tier and the narrowed
    # frame on every warm run
    s = db.session()
    s.sql("set ob_enable_result_cache = 0")
    st = db.plan_cache.stats
    f0 = st.fast_hits
    got = []

    def dbs():
        rs = s.sql(text)
        got.append(rs)
        return rs.nrows

    from oceanbase_tpu_torch.expr.program import EXPR_COUNTS

    x0 = dict(EXPR_COUNTS)
    cold = timed(dbs, 1)[0]
    warm_ms = timed(dbs, warm)
    expr = {k: EXPR_COUNTS[k] - x0[k] for k in EXPR_COUNTS}
    require(expr["expr torch route"] == 0 and expr["expr k24 trees"] > 0,
            f"server {name}: expression trees on K24 / the torch route: "
            f"{expr}")
    fast = st.fast_hits - f0
    require(fast >= warm, f"server {name}: {fast} fast hits in {warm} warm "
            "runs")
    require(all(r.fast_path_hit for r in got[1:]),
            f"server {name}: a warm run missed the fast tier")
    for rs in got:
        require(row_bits(rs.rows()) == row_bits(ref),
                f"server {name}: DbSession rows differ from the engine's")
    # the first re-execution of a digest is profiled (per-operator stages,
    # not narrowed); the later warm runs narrow
    narrowed = bool(getattr(got[-1]._cursor, "narrowed", False))
    if q == 3:
        require(narrowed, "server Q3: the warm result frame was not narrowed")
    busy, traced, gaps, top, attempts = device_busy_ms(
        lambda: s.sql(text).nrows)
    med = statistics.median(warm_ms)
    # the result cache: a session with it on; the first repeat admits the
    # narrowed frame, the rest hit with no device work at all
    rc = db.result_cache
    s2 = db.session()
    h0 = rc.stats()["hits"]
    rc_hits, rc_ms = 0, []
    for _ in range(RC_REPEATS):
        before = sum(kernels.LAUNCHES.values())
        hits = rc.stats()["hits"]
        t0 = time.perf_counter()
        rs = s2.sql(text)
        rows = rs.rows()
        ms = (time.perf_counter() - t0) * 1e3
        require(row_bits(rows) == row_bits(ref),
                f"server {name}: result-cache rows differ")
        if rc.stats()["hits"] > hits:
            rc_hits += 1
            rc_ms.append(ms)
            require(sum(kernels.LAUNCHES.values()) == before,
                    f"server {name}: a result-cache hit launched a kernel")
            require(db.engine.last_phases.get("result_cache", False)
                    and db.engine.last_phases["dispatch_s"] == 0.0,
                    f"server {name}: a result-cache hit dispatched")
    require(rc_hits > 0 and rc.stats()["hits"] - h0 == rc_hits,
            f"server {name}: no result-cache hit in {RC_REPEATS} repeats")
    # over the wire, result cache off: the same rows, as text
    c = WireClient(fe.port)
    c.query("set ob_enable_result_cache = 0")
    wrows = []

    def wire():
        wrows[:] = [c.query(text)]

    w_ms = timed(wire, warm + 1)
    c.close()
    names, wr = wrows[0]
    require(names == list(erows[0].names) and wr == [
        tuple(wire_text(v) for v in r) for r in ref],
        f"server {name}: wire rows differ from the engine's")
    rec = {
        "statement": name, "rows": n,
        "engine_warm_median_ms": statistics.median(e_ms[1:]),
        "db_cold_ms": cold, "db_warm_median_ms": med, "db_warm_ms": warm_ms,
        "server_overhead_ms": med - statistics.median(e_ms[1:]),
        "wire_cold_ms": w_ms[0], "wire_warm_median_ms":
            statistics.median(w_ms[1:]),
        "fast_hits": fast, "result_cache_hits": rc_hits,
        "expr_k24_trees": expr["expr k24 trees"],
        "expr_torch_route": expr["expr torch route"],
        "result_cache_hit_ms": rc_ms, "narrowed": narrowed,
        "device_busy_ms": busy, "traced_wall_ms": traced,
        "traced_attempts": attempts,
        "device_idle_share": 1 - busy / med,
        "traced_idle_share": 1 - busy / traced,
        "device_ms_by_kernel": [{"name": k, "ms": v} for k, v in top],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    print(f"server {name}: engine warm {rec['engine_warm_median_ms']:.3f} "
          f"ms, DbSession cold {cold:.3f} ms warm {med:.3f} ms, wire warm "
          f"{rec['wire_warm_median_ms']:.3f} ms, {n} rows bit-identical "
          f"(DbSession, result cache, wire), fast hits {fast}, result-cache "
          f"hits {rc_hits} ({', '.join(f'{m:.3f}' for m in rc_ms)} ms), "
          f"narrowed {narrowed}, device busy {busy:.3f} ms (idle share "
          f"{rec['device_idle_share']:.4f}); most device time: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in top[:3]), flush=True)
    return rec


def head_fetch(db, kernels, lineitem, sf) -> dict:
    """rows(limit) of a result of ~9M live rows (at SF 10) through K23,
    against the table's rows in row order."""
    import numpy as np

    s = db.session()
    t0 = time.perf_counter()
    rs = s.sql(HEAD_TEXT)
    n = rs.nrows
    ms = (time.perf_counter() - t0) * 1e3
    require(n >= 1_000_000 * sf / 10, f"head fetch: only {n} live rows")
    cur = rs._cursor
    cap = int(cur._out.sel.shape[0])
    d = lineitem.data
    lo = int(np.datetime64("1994-01-01", "D").astype(np.int64))
    hi = int(np.datetime64("1995-01-01", "D").astype(np.int64))
    rows = np.flatnonzero((d["l_shipdate"] >= lo) & (d["l_shipdate"] < hi))
    require(len(rows) == n, f"head fetch: {n} rows, the table has "
            f"{len(rows)}")
    fetches = []
    for lim in HEAD_LIMITS:
        before = kernels.LAUNCHES["K23_first_live"]
        t0 = time.perf_counter()
        got = rs.rows(limit=lim)
        f_ms = (time.perf_counter() - t0) * 1e3
        require(kernels.LAUNCHES["K23_first_live"] == before + 1,
                f"head fetch LIMIT {lim} did not launch K23 once")
        r = rows[:lim]
        want = list(zip(d["l_orderkey"][r].tolist(),
                        d["l_linenumber"][r].tolist(),
                        (d["l_extendedprice"][r].astype(np.float64)
                         / 100).tolist()))
        require(row_bits(got) == row_bits(want),
                f"head fetch LIMIT {lim} differs from the table's rows")
        fetches.append({"limit": lim, "ms": f_ms})
    print(f"server head fetch: {n} live rows of a {cap}-row frame in "
          f"{ms:.3f} ms; " + ", ".join(f"LIMIT {f['limit']} in "
                                       f"{f['ms']:.3f} ms" for f in fetches)
          + " through K23, equal to the table's rows", flush=True)
    return {"live_rows": n, "frame_rows": cap, "statement_ms": ms,
            "fetches": fetches}


def lookup_leg(db, esess, kernels, lineitem, warm) -> dict:
    """LOOKUP_TEXT through DbSession.sql with the result cache off: cold,
    then warm runs whose narrowed frame K23 compacts; rows bit-identical
    to the engine Session's, keys the table's in row order."""
    import numpy as np

    ref = esess.sql(LOOKUP_TEXT).rows()
    d = lineitem.data
    r = np.flatnonzero(d["l_orderkey"] < 40)
    require([(int(a), int(b)) for a, b, _q in ref]
            == list(zip(d["l_orderkey"][r].tolist(),
                        d["l_linenumber"][r].tolist())),
            "server lookup: the engine's keys differ from the table's")
    s = db.session()
    s.sql("set ob_enable_result_cache = 0")
    got = []

    def run():
        rs = s.sql(LOOKUP_TEXT)
        got.append(rs)
        return rs.nrows

    before = kernels.LAUNCHES["K23_first_live"]
    ms = timed(run, warm + 1)
    launches = kernels.LAUNCHES["K23_first_live"] - before
    for rs in got:
        require(row_bits(rs.rows()) == row_bits(ref),
                "server lookup: DbSession rows differ from the engine's")
    require(getattr(got[-1]._cursor, "narrowed", False),
            "server lookup: the warm result frame was not narrowed")
    require(launches > 0, "server lookup: the narrowed frame did not "
            "launch K23")
    rec = {"statement": "SV_LOOKUP", "rows": len(ref), "cold_ms": ms[0],
           "warm_median_ms": statistics.median(ms[1:]),
           "k23_launches": launches}
    print(f"server lookup: {len(ref)} rows, cold {ms[0]:.3f} ms, warm "
          f"median {rec['warm_median_ms']:.3f} ms, narrowed through K23 "
          f"({launches} launches), rows bit-identical to the engine's",
          flush=True)
    return rec


def wide_leg(db, planes) -> dict:
    """WIDE_TEXT: its narrowed frame (the key range < 100) and the head
    fetch of its plain cursor (keys >= 10, LIMIT 300), each through K23
    over 83 columns and validity planes (`planes` collects the count of
    every K23 call), against the inserted values."""
    import numpy as np

    s = db.session()
    s.sql("set ob_enable_result_cache = 0")
    s.sql("create table keys_t (k bigint primary key)")
    s.sql("create table wide_t (id bigint primary key, "
          + ", ".join(f"c{i} bigint" for i in range(WIDE_COLS)) + ")")
    s.sql("insert into keys_t values "
          + ", ".join(f"({r})" for r in range(WIDE_KEYS)))
    rng = np.random.default_rng(41)
    vals = rng.integers(-1000, 1000, (WIDE_KEYS, WIDE_COLS))
    present = [r for r in range(WIDE_KEYS) if r % 5]
    for lo in range(0, len(present), 160):
        s.sql("insert into wide_t values " + ", ".join(
            f"({r}, " + ", ".join(str(int(x)) for x in vals[r]) + ")"
            for r in present[lo:lo + 160]))

    def model(r):
        return (r,) + ((None,) * (1 + WIDE_COLS) if r % 5 == 0
                       else (r, *(int(x) for x in vals[r])))

    def held(rows, keys):
        got = [tuple(None if x is None else int(x) for x in row)
               for row in rows]
        require(sorted(row[0] for row in got) == sorted(keys)
                and all(row == model(row[0]) for row in got),
                "server wide: rows differ from the inserted values")

    planes.clear()
    for _ in range(3):  # cold, the profiled repeat, narrowed
        rs = s.sql(WIDE_TEXT.format("< 100"))
        held(rs.rows(), range(100))
    narrowed = max(planes, default=0)
    require(narrowed > 48, f"server wide: the narrowed frame's K23 calls "
            f"gathered {narrowed} planes")
    db.config.set("ob_enable_result_narrow", False)
    try:
        rs = s.sql(WIDE_TEXT.format(">= 10"))
        planes.clear()
        head = rs.rows(limit=300)
    finally:
        db.config.set("ob_enable_result_narrow", True)
    require(planes and min(planes) > 48, f"server wide: the head fetch's "
            f"K23 calls gathered {planes} planes")
    got_keys = [int(row[0]) for row in head]
    require(len(set(got_keys)) == 300 and min(got_keys) >= 10,
            "server wide: the head fetch's keys")
    held(head, got_keys)
    print(f"server wide: {narrowed} columns and validity planes through "
          f"K23 in the narrowed frame and the head fetch (LIMIT 300), "
          f"equal to the inserted values", flush=True)
    return {"planes": narrowed, "head_rows": len(head)}


def dml_leg(db) -> dict:
    """A served table: multi-row INSERT, UPDATE, DELETE and SELECT back
    against a numpy model, and the result cache's invalidation by DML
    (hit, write, miss, re-admit)."""
    import numpy as np

    s = db.session()
    s.sql("create table dml_t (id bigint primary key, g bigint not null, "
          "v bigint not null, tag varchar(16) not null)")
    rng = np.random.default_rng(DML_SEED)
    ids = np.arange(DML_ROWS, dtype=np.int64)
    g = rng.integers(0, DML_GROUPS, DML_ROWS)
    v = rng.integers(-10**6, 10**6, DML_ROWS)
    tag = rng.integers(0, len(DML_TAGS), DML_ROWS)
    live = np.ones(DML_ROWS, dtype=bool)
    t0 = time.perf_counter()
    for i in range(0, DML_ROWS, DML_BATCH):
        j = range(i, min(DML_ROWS, i + DML_BATCH))
        n = s.sql("insert into dml_t values " + ", ".join(
            f"({k}, {g[k]}, {v[k]}, '{DML_TAGS[tag[k]]}')" for k in j)
        ).affected
        require(n == len(j), f"DML: insert affected {n} of {len(j)}")
    insert_s = time.perf_counter() - t0

    def by_group():
        want = [(k, int(((g == k) & live).sum()), int(v[(g == k) & live].sum()))
                for k in range(DML_GROUPS) if ((g == k) & live).any()]
        got = [tuple(int(x) for x in r) for r in s.sql(
            "select g, count(*) as n, sum(v) as s from dml_t group by g "
            "order by g").rows()]
        require(got == want, "DML: the group sums differ from the model")

    def head_rows():
        want = [(int(k), int(v[k]), DML_TAGS[tag[k]])
                for k in np.flatnonzero(live[:80])]
        got = [(int(a), int(b), c) for a, b, c in s.sql(
            "select id, v, tag from dml_t where id < 80 order by id").rows()]
        require(got == want, "DML: the first rows differ from the model")

    by_group()
    head_rows()
    # the result cache over the served table: admit, hit, write, miss,
    # re-admit
    rc = db.result_cache
    q = "select count(*) as n, sum(v) as s from dml_t where g = 3"

    def cached():
        m = (g == 3) & live
        got = [tuple(int(x) for x in r) for r in s.sql(q).rows()]
        require(got == [(int(m.sum()), int(v[m].sum()))],
                "DML: the cached statement differs from the model")

    for _ in range(3):
        cached()
    h0, inv0 = rc.stats()["hits"], rc.stats()["invalidations"]
    require(h0 > 0, "DML: the cached statement never hit")
    t0 = time.perf_counter()
    m = g == 3
    n = s.sql("update dml_t set v = v + 7 where g = 3").affected
    update_s = time.perf_counter() - t0
    require(n == int((m & live).sum()), f"DML: update affected {n}")
    v[m] += 7
    cached()
    require(rc.stats()["hits"] == h0, "DML: a stale frame served after the "
            "update")
    require(rc.stats()["invalidations"] > inv0,
            "DML: the update did not invalidate the cached frame")
    cached()
    require(rc.stats()["hits"] == h0 + 1, "DML: the recomputed frame was "
            "not re-admitted")
    t0 = time.perf_counter()
    m = g == 5
    n = s.sql("delete from dml_t where g = 5").affected
    delete_s = time.perf_counter() - t0
    require(n == int((m & live).sum()), f"DML: delete affected {n}")
    live &= ~m
    by_group()
    head_rows()
    rec = {"rows": DML_ROWS, "batch": DML_BATCH, "insert_s": insert_s,
           "insert_rows_per_s": DML_ROWS / insert_s, "update_s": update_s,
           "delete_s": delete_s, "result_cache": rc.stats()}
    print(f"server DML leg: {DML_ROWS} rows inserted in {insert_s:.3f} s "
          f"({rec['insert_rows_per_s']:.6g} rows/s), update "
          f"{update_s:.3f} s, delete {delete_s:.3f} s; every SELECT equals "
          "the numpy model; DML invalidated the cached frame (hit, write, "
          "miss, re-admit)", flush=True)
    return rec


def server_phase(tables, uk, kernels, queries_text, checks, warm, sf):
    """The server entry point on the card: its own launch counts. Returns
    (records, launches, the K23 arguments captured from the head fetch,
    the lookup's narrowed frame and the wide leg)."""
    import oceanbase_tpu_torch.engine.executor as ex
    from oceanbase_tpu_torch.engine.session import Session
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.server.mysql_front import MySqlFrontend

    db = Database(n_nodes=1, n_ls=1, extra_catalog=tables)
    require(db.device.type == "cuda", f"the Database runs on {db.device}")
    # preloaded tables carry no DDL primary keys: register their unique
    # keys so the physical fast paths are eligible
    db._unique_keys.update(uk)
    db.engine.executor.unique_keys = db._unique_keys
    db.engine.planner.unique_keys = db._unique_keys
    fe = MySqlFrontend(db).start()
    esess = Session(tables, unique_keys=uk, device="cuda")
    # K23's arguments: the largest call of each leg (the head fetch over
    # lineitem, the lookup's narrowed frame, the wide leg's head fetch),
    # and the planes of every call
    captured, tag, planes = {}, ["head"], []
    orig = ex.first_live

    def recording(sel, k, cols):
        cols = list(cols)
        planes.append(len(cols))
        key = tag[0]
        if key not in captured or int(k) > int(captured[key][1]):
            captured[key] = (sel, int(k), cols)
        return orig(sel, k, cols)

    kernels.reset_launches()
    recs = []
    try:
        for q in SERVER_STMTS:
            recs.append(server_statement(db, fe, esess, kernels, q,
                                         queries_text[q], checks[q], warm))
        ex.first_live = recording
        head = head_fetch(db, kernels, tables["lineitem"], sf)
        tag[0] = "narrow"
        lookup = lookup_leg(db, esess, kernels, tables["lineitem"], warm)
        tag[0] = "wide"
        wide = wide_leg(db, planes)
        ex.first_live = orig
        dml = dml_leg(db)
        launches = dict(kernels.LAUNCHES)
        degraded = {k: db.metrics.counter(k) for k in (
            "stmt degraded chunked", "stmt degraded host",
            "stmt degraded host refused")}
        require(not any(degraded.values()),
                f"server: a degraded rung was taken: {degraded}")
        require(db.engine.profile_fallbacks == 0,
                "server: a profiled run fell back to the plain dispatch")
        profiles = db.plan_profiler.store.profiles
        require(profiles > 0, "server: no statement was profiled")
        require(launches["K23_first_live"] > 0, "server: K23 never launched")
        # the PX phase's leg 1, in the same Database: its own counts
        px_leg = px_server_leg(db, kernels, queries_text, checks, warm)
    finally:
        ex.first_live = orig
        fe.stop()
        db.close()
    require({"head", "narrow", "wide"} <= set(captured),
            f"server: K23 arguments captured for {sorted(captured)}")
    return ({"statements": recs, "head_fetch": head, "lookup": lookup,
             "wide": wide, "dml": dml, "px_leg": px_leg,
             "degraded": degraded, "profile_fallbacks": 0,
             "operator_profiles": profiles}, launches, captured)


# ---- the PX phase: SET ob_px_dop through the server, then a 4-shard mesh
# leg 1: the server statements at dop 1 (the mesh of the one card)
PX_SERVER_STMTS = (1, 6, 3, 14)
# leg 2: shards of the mesh on one card
PX_MESH_SHARDS = 4
PX_DISTINCT = "select distinct l_suppkey from lineitem"
# tests/test_px_range.py's range sort, at SF 10 every lineitem row
PX_SORT = """select l_orderkey, l_linenumber, l_shipdate
from lineitem
order by l_shipdate, l_orderkey, l_linenumber"""
# tests/test_mesh_spmd.py's zipf join, scaled to 2^20 probe rows a shard;
# the dim's keys clipped at 2M (the test's 20,000 x 100), so that the
# exchange cost model hash-partitions (a broadcast of the dim to 3 more
# shards moves more rows than the fact's one hash exchange)
PX_ZIPF = ("select sum(f.v + d.w) as s, count(*) as c "
           "from fact f, dim d where f.fk = d.dk")
PX_ZIPF_ROWS_PER_SHARD = 1 << 20
PX_ZIPF_DIM = 2_000_000
# a VECTOR column across the exchanges: vdocs (the vector cell's width,
# 128 float32, a quarter of a million rows) joined to the zipf leg's dim,
# then range-sorted by id: its rows cross as 512-byte row planes through
# K25's pack and K26's all_to_all and all_gather
PX_VECTOR = ("select v.id, v.emb, d.w from vdocs v, dim d "
             "where v.id = d.dk and v.g = 3 order by v.id")
PX_VECTOR_ROWS = 1 << 18
# the PX executor's broadcast threshold on TPC-H (the reference default)
PX_BROADCAST_THRESHOLD = 1 << 16
# leg 2's warm runs per statement (the range sort moves every lineitem
# row: its runs are seconds, and the phase keeps inside ~150 s)
PX_MESH_WARM = 3
# the functions of K25-K28 whose calls leg 2 captures (largest each)
PX_CAPTURE = ("exchange_dest", "exchange_pack", "exchange_recv",
              "shard_merge", "range_histogram", "range_bounds",
              "hash_histogram", "bloom_bits", "hot_buckets", "bucket_probe")


def px_server_leg(db, kernels, queries_text, checks, warm) -> dict:
    """Leg 1: `SET ob_px_dop = 1` through DbSession.sql in the server
    phase's Database, so the statements run on Database._px_executor():
    make_mesh() over the one card, one shard in the caller's thread. Q1,
    Q6, Q3 and Q14 cold, `warm` times warm and once traced; their rows
    bit-identical to the same session's at dop 0 and held to the int64
    oracles; no `px fallbacks`, the admission quota back at its target.
    Its own launch counts."""
    import torch

    s = db.session()
    s.sql("set ob_enable_result_cache = 0")
    adm = db._px_admission()
    target = adm.target
    fb0 = db.metrics.counter("px fallbacks")
    up0 = db.metrics.counter("px sharded upload bytes")
    kernels.reset_launches()
    recs = []
    for q in PX_SERVER_STMTS:
        text = queries_text[q]
        name = f"PX_Q{q}"
        s.sql("set ob_px_dop = 0")
        ref = []

        def serial():
            rs = s.sql(text)
            ref[:] = [rs.rows()]
            return rs.nrows

        serial_ms = timed(serial, warm + 1)[1:]
        s.sql("set ob_px_dop = 1")
        got = []

        def px():
            rs = s.sql(text)
            got.append(rs)
            return rs.nrows

        torch.cuda.reset_peak_memory_stats()
        cold = timed(px, 1)[0]
        warm_ms = timed(px, warm)
        busy, traced, gaps, top, attempts = device_busy_ms(
            lambda: s.sql(text).nrows)
        peak = torch.cuda.max_memory_allocated()
        for rs in got:
            require(row_bits(rs.rows()) == row_bits(ref[0]),
                    f"{name}: rows at dop 1 differ from dop 0's")
        # the int64 oracle reads the PX result's own storage columns
        n = checks[q](got[-1])
        med = statistics.median(warm_ms)
        med0 = statistics.median(serial_ms)
        rec = {"statement": name, "rows": n, "cold_ms": cold,
               "warm_ms": warm_ms, "warm_median_ms": med,
               "dop0_warm_median_ms": med0, "device_busy_ms": busy,
               "traced_wall_ms": traced, "traced_attempts": attempts,
               "device_idle_share": 1 - busy / med,
               "device_ms_by_kernel": [{"name": k, "ms": v} for k, v in top],
               "peak_memory_bytes": peak}
        recs.append(rec)
        print(f"{name}: dop 1 cold {cold:.3f} ms warm {med:.3f} ms (dop 0 "
              f"{med0:.3f} ms), {n} rows bit-identical to dop 0 and the "
              f"oracle, device busy {busy:.3f} ms (idle share "
              f"{rec['device_idle_share']:.4f}), peak "
              f"{peak / 2**30:.3f} GiB; most device time: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in top[:3]), flush=True)
    launches = dict(kernels.LAUNCHES)
    s.sql("set ob_px_dop = 0")
    px_ex = db._px_executor_obj
    require(px_ex is not None and px_ex.nsh == 1
            and px_ex.mesh.devices[0] == db.device,
            "PX leg 1: the server's PX executor is not make_mesh()'s one "
            "card")
    fallbacks = db.metrics.counter("px fallbacks") - fb0
    require(fallbacks == 0, f"PX leg 1: {fallbacks} px fallbacks")
    require(adm.used == 0 and adm.target == target,
            f"PX leg 1: admission {adm.used} in use, target {adm.target} "
            f"(was {target})")
    uploads = db.metrics.counter("px sharded upload bytes") - up0
    require(uploads > 0, "PX leg 1: no sharded upload")
    for k in ("K26_exchange_recv", "K27_shard_merge"):
        require(launches[k] > 0, f"PX leg 1: {k} never launched")
    print(f"PX leg 1: px fallbacks 0, admission back at {target}, sharded "
          f"upload {uploads:.0f} B, launches " + ", ".join(
              f"{k} {launches[k]}" for k in PX_KERNELS), flush=True)
    return {"statements": recs, "launches": launches,
            "sharded_upload_bytes": uploads, "fallbacks": fallbacks}


def zipf_tables(seed: int) -> dict:
    """tests/test_mesh_spmd.py's zipf join tables with 2^20 probe rows on
    each of the leg's shards: fact.fk ~ zipf(1.3) clipped to the dim's
    PX_ZIPF_DIM + 1 keys."""
    import numpy as np

    from oceanbase_tpu_torch.core.dtypes import DataType, Schema
    from oceanbase_tpu_torch.core.table import Table

    rng = np.random.default_rng(seed)
    n = PX_MESH_SHARDS * PX_ZIPF_ROWS_PER_SHARD
    fk = np.minimum(rng.zipf(1.3, n) - 1, PX_ZIPF_DIM).astype(np.int64)
    fact = Table.from_pydict(
        "fact", Schema.of(fk=DataType.int64(), v=DataType.int64()),
        {"fk": fk, "v": rng.integers(0, 100, n)})
    dim = Table.from_pydict(
        "dim", Schema.of(dk=DataType.int64(), w=DataType.int64()),
        {"dk": np.arange(PX_ZIPF_DIM + 1),
         "w": np.arange(PX_ZIPF_DIM + 1) * 3})
    vdocs = vec_catalog(
        rng.normal(size=(PX_VECTOR_ROWS, ANN_D)).astype(np.float32),
        {"g": np.arange(PX_VECTOR_ROWS, dtype=np.int64) % 16})["docs"]
    vdocs.name = "vdocs"
    return {"fact": fact, "dim": dim, "vdocs": vdocs}


def same_storage(name, got: dict, want: dict, ordered: bool) -> None:
    """Result columns equal: integers exactly, floats to rel 1e-12; an
    unordered statement's rows compare after one sort of both sides."""
    import numpy as np

    require(list(got) == list(want), f"{name}: columns differ")
    names = list(got)
    if not ordered and names:
        def perm(cols):
            return np.lexsort([np.asarray(cols[c]) for c in reversed(names)])

        pg, pw = perm(got), perm(want)
        got = {c: np.asarray(got[c])[pg] for c in names}
        want = {c: np.asarray(want[c])[pw] for c in names}
    for c in names:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        require(g.shape == w.shape, f"{name} {c}: {g.shape} vs {w.shape}")
        if g.dtype.kind == "f":
            require(np.allclose(g, w, rtol=1e-12, atol=0.0, equal_nan=True),
                    f"{name} {c}: differs beyond rel 1e-12")
        else:
            require(np.array_equal(g, w), f"{name} {c}: differs")


def recv_event_ms(kernels, run) -> tuple[float, int]:
    """One more run with every K26 launch between two CUDA events (the C
    entry wrapped, so the wrapper's host work falls outside): the summed
    milliseconds between them and the number of launches. The shards'
    threads share the card's one stream, so each thread holds a lock from
    its first event to its second: no other shard's work is queued
    between them. The run's launches are taken back out of the counts,
    which stay those of the warm and cold runs."""
    import torch

    lib = kernels._load()
    orig = lib.ob_k26_recv
    evs = []
    lock = threading.Lock()
    counts = [dict(d) for d in (kernels.LAUNCHES, kernels.ENTRY_LAUNCHES)]

    def timed_launch(*a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        with lock:
            s.record()
            rc = orig(*a)
            e.record()
            evs.append((s, e))
        return rc

    lib.ob_k26_recv = timed_launch
    try:
        run()
    finally:
        lib.ob_k26_recv = orig
        for d, before in zip((kernels.LAUNCHES, kernels.ENTRY_LAUNCHES),
                             counts):
            d.update(before)
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs), len(evs)


def px_mesh_leg(tables, uk, kernels, queries_text, seed, warm, dev):
    """Leg 2: PxExecutor(tables, make_mesh(4, devices=[cuda:0] * 4)), one
    thread a shard on the card: Q1 and Q6 (partials merged by K27), Q3,
    Q18 (hash group-by repartitions, K25 + K26), a big DISTINCT, the
    range sort of every lineitem row (bounds by K28) and a hybrid-hash
    join over a zipf-skewed fact table (hot buckets and the bloom by
    K28), each equal to the single-device executor's rows. Its own
    launch counts; the largest call of each K25-K28 function is captured
    for the kernel checks. Untraced: the shards run in threads."""
    import torch

    from oceanbase_tpu_torch.core.column import batch_rows_storage
    from oceanbase_tpu_torch.engine.executor import Executor
    from oceanbase_tpu_torch.parallel.mesh import make_mesh
    from oceanbase_tpu_torch.parallel.px import PxExecutor
    from oceanbase_tpu_torch.sql.parser import parse
    from oceanbase_tpu_torch.sql.planner import Planner

    mesh = make_mesh(PX_MESH_SHARDS, devices=[dev] * PX_MESH_SHARDS)
    zt = zipf_tables(seed)
    zuk = {"dim": ("dk",)}
    px = PxExecutor(tables, mesh, unique_keys=uk,
                    broadcast_threshold=PX_BROADCAST_THRESHOLD)
    pz = PxExecutor(zt, mesh, unique_keys=zuk, broadcast_threshold=1,
                    hybrid_hash=True)
    pv = PxExecutor(zt, mesh, unique_keys=zuk, broadcast_threshold=1)
    single = Executor(tables, unique_keys=uk, device=dev)
    zsingle = Executor(zt, unique_keys=zuk, device=dev)
    planner, zplanner = Planner(tables), Planner(zt)
    Q = queries_text
    stmts = [("PX4_Q1", Q[1], True), ("PX4_Q6", Q[6], True),
             ("PX4_Q3", Q[3], True), ("PX4_Q18", Q[18], True),
             ("PX4_DISTINCT", PX_DISTINCT, False),
             ("PX4_SORT", PX_SORT, True), ("PX4_HYBRID", PX_ZIPF, False),
             ("PX4_VECTOR", PX_VECTOR, True)]

    captured: dict = {}
    lock = threading.Lock()
    orig = {f: getattr(kernels, f) for f in PX_CAPTURE}

    def size(args):
        tot = 0
        for a in args:
            if isinstance(a, torch.Tensor):
                tot += a.numel()
            elif isinstance(a, (list, tuple)):
                tot += size(a)
        return tot

    def capturing(fname, stmt):
        def wrapper(*args, **kw):
            with lock:
                key = (fname, stmt)
                if key not in captured or size(args) > captured[key][0]:
                    captured[key] = (size(args), args, kw)
            return orig[fname](*args, **kw)
        return wrapper

    kernels.reset_launches()
    recs = []
    try:
        for name, text, ordered in stmts:
            zipf = name in ("PX4_HYBRID", "PX4_VECTOR")
            ex, sx, pl = ((pz if name == "PX4_HYBRID" else pv, zsingle,
                           zplanner) if zipf else (px, single, planner))
            plan = pl.plan(parse(text))
            names = list(plan.output_names)
            for f in PX_CAPTURE:
                setattr(kernels, f, capturing(f, name))
            prepared = ex.prepare(plan.plan)
            out = []

            def run():
                out[:] = [prepared.run()]
                return out[0].nrows

            cold = timed(run, 1)[0]
            for f in PX_CAPTURE:
                setattr(kernels, f, orig[f])
            got = batch_rows_storage(out[0], names)
            warm_ms = timed(run, warm)
            k26_ms, k26_calls = recv_event_ms(kernels, run)
            sprep = sx.prepare(plan.plan)
            want_b = sprep.run()
            want = batch_rows_storage(want_b, names)
            single_ms = timed(lambda: sprep.run().nrows, warm)
            same_storage(name, got, want, ordered)
            n = len(got[names[0]])
            require(n > 0, f"{name}: no rows")
            kinds = sorted({e.kind for e in prepared.mesh_plan.exchanges})
            rec = {"statement": name, "rows": n, "cold_ms": cold,
                   "warm_ms": warm_ms,
                   "warm_median_ms": statistics.median(warm_ms),
                   "single_warm_median_ms": statistics.median(single_ms),
                   "k26_event_ms": k26_ms, "k26_calls": k26_calls,
                   "exchanges": kinds,
                   "collectives": prepared.mesh_plan.describe()}
            recs.append(rec)
            print(f"{name}: {PX_MESH_SHARDS} shards on one card, {n} rows "
                  f"equal to the single device's, cold {cold:.3f} ms warm "
                  f"{rec['warm_median_ms']:.3f} ms (single device "
                  f"{rec['single_warm_median_ms']:.3f} ms), K26 "
                  f"{k26_ms:.6f} ms in {k26_calls} calls, exchanges "
                  f"{kinds} ({rec['collectives']})", flush=True)
            del out, got, want, want_b, sprep, prepared
    finally:
        for f in PX_CAPTURE:
            setattr(kernels, f, orig[f])
    launches = dict(kernels.LAUNCHES)
    for k in PX_KERNELS:
        require(launches[k] > 0, f"PX leg 2: {k} never launched")
    hyb = next(r for r in recs if r["statement"] == "PX4_HYBRID")
    require({"skew_histogram", "bloom", "broadcast", "repartition"}
            <= set(hyb["exchanges"]),
            f"PX leg 2: the hybrid join's exchanges {hyb['exchanges']}")
    srt = next(r for r in recs if r["statement"] == "PX4_SORT")
    require("range_sample" in srt["exchanges"],
            "PX leg 2: the sort did not exchange by range")
    vec = next(r for r in recs if r["statement"] == "PX4_VECTOR")
    require("repartition" in vec["exchanges"],
            f"PX leg 2: the VECTOR join's exchanges {vec['exchanges']}")
    print("PX leg 2: launches " + ", ".join(
        f"{k} {launches[k]}" for k in PX_KERNELS), flush=True)
    return recs, launches, captured


def _pick(captured, fname, prefer):
    """The captured call of fname from the first statement of `prefer`
    that made one, else the largest from any statement."""
    for stmt in prefer:
        hit = captured.get((fname, stmt))
        if hit is not None:
            return stmt, hit[1], hit[2]
    hits = [(v[0], k[1], v) for k, v in captured.items() if k[0] == fname]
    require(bool(hits), f"PX: no {fname} call was captured")
    _n, stmt, v = max(hits, key=lambda t: t[0])
    return stmt, v[1], v[2]


def _bits(t):
    import torch

    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _exact(what, got, want, again) -> None:
    import torch

    if isinstance(got, torch.Tensor):
        got, want, again = [got], [want], [again]
    for a, b, c in zip(got, want, again):
        require(a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(_bits(a), _bits(b)),
                f"{what}: differs from the plain version")
        require(torch.equal(_bits(a), _bits(c)), f"{what}: two runs differ")


def _check_call(kernels, fname, args, kw, what) -> None:
    """The kernel call against its plain version on the same inputs (the
    outputs K26 writes into are cloned for each run), twice."""
    import torch

    plain = getattr(kernels, fname + "_plain")
    kern = getattr(kernels, fname)
    if fname == "exchange_recv":
        senders, rows, lane, outs = args[:4]
        rest = args[4:]

        def fresh():
            return [torch.zeros_like(o) for o in outs]

        got = kern(senders, rows, lane, fresh(), *rest, **kw)
        want = plain(senders, rows, lane, fresh(), *rest, **kw)
        again = kern(senders, rows, lane, fresh(), *rest, **kw)
    else:
        got, want, again = (kern(*args, **kw), plain(*args, **kw),
                            kern(*args, **kw))
    if fname == "exchange_pack":
        _exact(what, [*got[0], got[1], got[2]], [*want[0], want[1], want[2]],
               [*again[0], again[1], again[2]])
    else:
        _exact(what, got, want, again)


def px_synthetic(kernels, dev) -> int:
    """K25-K28 against their plain versions on edge cases, twice: lanes
    at cap - 1, cap and cap + 1 of the fullest lane, every row bound for
    one shard, no live row, a row count no multiple of a tile, 64
    shards; a stripe, ring offsets, misaligned bool and int16 planes, a
    one-row receive and 40 planes for K26; NaN, wrapping sums and
    ORs over 64 shards for K27; one key value, no live row and a span
    past 2^62 for K28's range; hot buckets, bits and probes of several
    key types. Returns the number of cases."""
    import numpy as np
    import torch

    rng = np.random.default_rng(29)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    n = (1 << 20) + 37
    key = t(rng.integers(0, 1 << 40, n))
    k32 = t(rng.integers(-50, 50, n).astype(np.int32))
    f32 = t(rng.normal(size=n).astype(np.float32))
    b8 = t(rng.random(n) < 0.5)
    mask = t(rng.random(n) < 0.7)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    planes = [key, k32, f32, b8]
    cases = 0
    for nsh in (4, 64):
        d = kernels.exchange_dest("hash", nsh, [key, k32])
        _exact(f"K25 dest hash {nsh}", d,
               kernels.exchange_dest_plain("hash", nsh, [key, k32]),
               kernels.exchange_dest("hash", nsh, [key, k32]))
        counts = torch.bincount(d[mask].long(), minlength=nsh)
        top = int(counts.max())
        for cap in (top - 1, top, top + 1):
            _check_call(kernels, "exchange_pack",
                        (planes, mask, d, nsh, cap), {},
                        f"K25 pack {nsh} shards cap {cap}")
            cases += 1
    one = torch.full((n,), 3, dtype=torch.int32, device=dev)
    for m, what in ((mask, "one shard"), (none, "no live row")):
        _check_call(kernels, "exchange_pack", (planes, m, one, 4, n), {},
                    f"K25 pack {what}")
        cases += 1
    bounds = torch.sort(key[:7]).values
    for desc in (False, True):
        _exact(f"K25 dest range desc={desc}",
               kernels.exchange_dest("range", 8, [key], bounds=bounds,
                                     desc=desc),
               kernels.exchange_dest_plain("range", 8, [key], bounds=bounds,
                                           desc=desc),
               kernels.exchange_dest("range", 8, [key], bounds=bounds,
                                     desc=desc))
        cases += 1
    owner = t((np.arange(16) * 3 % 4).astype(np.int32))
    part = t(rng.integers(-16, 20, n))
    _exact("K25 dest partition",
           kernels.exchange_dest("partition", 1, [part], owner=owner),
           kernels.exchange_dest_plain("partition", 1, [part], owner=owner),
           kernels.exchange_dest("partition", 1, [part], owner=owner))
    _exact("K25 round robin", kernels.round_robin_dest(mask, 4, 3),
           kernels.round_robin_dest_plain(mask, 4, 3),
           kernels.round_robin_dest(mask, 4, 3))
    cases += 2
    rows = 1 << 16
    snd = [[t(rng.integers(0, 1 << 60, 4 * rows)) for _ in range(4)],
           [t(rng.random(4 * rows) < 0.5) for _ in range(4)],
           [t(rng.integers(0, 9, 4 * rows).astype(np.int16))
            for _ in range(4)]]
    outs = [torch.empty(4 * rows, dtype=p[0].dtype, device=dev)
            for p in snd]
    _check_call(kernels, "exchange_recv", (snd, rows, 2, outs, 0, 1, 2, 1),
                {}, "K26 stripe")
    big = [torch.empty(8 * rows, dtype=p[0].dtype, device=dev) for p in snd]
    _check_call(kernels, "exchange_recv",
                ([[p[0]] for p in snd], rows, 3, big, 5 * rows), {},
                "K26 ring offset")
    cases += 2
    # sources and destinations that disagree mod 16 on bool and int16
    # planes (lane 1 of rows 65,537 or 7 into out_base 3), a one-row
    # receive, each plain and striped; 40 planes of 4 senders, past the
    # parameter table (the work list then lies in device memory)
    for rows_m, base_m in ((65_537, 3), (7, 3), (1, 0)):
        snd_m = [[t(rng.random(2 * rows_m + 5) < 0.5) for _ in range(4)],
                 [t(rng.integers(-9, 9, 2 * rows_m + 5).astype(np.int16))
                  for _ in range(4)]]
        outs_m = [torch.empty(base_m + 4 * rows_m + 9, dtype=p[0].dtype,
                              device=dev) for p in snd_m]
        _check_call(kernels, "exchange_recv",
                    (snd_m, rows_m, 1, outs_m, base_m), {},
                    f"K26 misaligned rows {rows_m} out_base {base_m}")
        _check_call(kernels, "exchange_recv",
                    (snd_m, rows_m, 1, outs_m, base_m, 0, 3, 2), {},
                    f"K26 misaligned stripe rows {rows_m}")
        cases += 2
    dts = (np.int64, np.bool_, np.int16, np.int32, np.int8) * 8
    snd_w = [[t(rng.integers(0, 2, 3 * 1001).astype(dt)) for _ in range(4)]
             for dt in dts]
    outs_w = [torch.empty(2 + 4 * 1001, dtype=p[0].dtype, device=dev)
              for p in snd_w]
    require(len(dts) * 4 * kernels.K26_FIELDS > kernels.K26_INLINE,
            "K26 synthetic: the wide case fits the parameters")
    _check_call(kernels, "exchange_recv", (snd_w, 1001, 2, outs_w, 2), {},
                "K26 40 planes")
    cases += 1
    for nsh in (4, 64):
        pl = [[t(rng.integers(-(1 << 62), 1 << 62, 4096))
               for _ in range(nsh)],
              [t(rng.normal(size=4096)) for _ in range(nsh)],
              [t(rng.normal(size=4096).astype(np.float32))
               for _ in range(nsh)],
              [t(rng.random(4096) < 0.05) for _ in range(nsh)],
              [t(rng.integers(0, 3, 4096).astype(np.int32))
               for _ in range(nsh)]]
        pl[1][1][7] = float("nan")
        for ops in (["sum", "sum", "sum", "or", "or"],
                    ["min", "max", "min", "or", "max"]):
            _check_call(kernels, "shard_merge", (pl, ops), {},
                        f"K27 {nsh} shards {ops}")
            cases += 1
    for kv, m, what in ((key, mask, "spread"),
                        (torch.full_like(key, 12345), mask, "one value"),
                        (key, none, "no live row"),
                        (t(rng.integers(-(1 << 62), 1 << 62, n)), mask,
                         "wide span")):
        lo = kernels.scalar_reduce("min", m, kv)
        hi = kernels.scalar_reduce("max", m, kv)
        mm = torch.stack([lo, hi])
        _check_call(kernels, "range_histogram", (kv, m, mm, 4096), {},
                    f"K28 range histogram {what}")
        hist = kernels.range_histogram(kv, m, mm, 4096)
        _check_call(kernels, "range_bounds", (hist, mm, 8), {},
                    f"K28 bounds {what}")
        cases += 2
    for ks in ([key], [k32, f32], [b8]):
        _check_call(kernels, "hash_histogram", (ks, mask, 4096), {},
                    "K28 hash histogram")
        _check_call(kernels, "bloom_bits", (ks, mask, 1 << 20), {},
                    "K28 bloom bits")
        bits = kernels.bloom_bits(ks, mask, 1 << 20) != 0
        _check_call(kernels, "bucket_probe", (ks, mask, bits), {},
                    "K28 probe")
        cases += 3
    ca = kernels.hash_histogram([k32], mask, 4096)
    cb = kernels.hash_histogram([key], mask, 4096)
    _check_call(kernels, "hot_buckets", (ca, cb, 4), {}, "K28 hot")
    _check_call(kernels, "hot_buckets", (cb, None, 4), {}, "K28 hot one side")
    return cases + 2


def px_kernel_checks(kernels, reps: int, captured: dict) -> list:
    """K25-K28 against their plain versions bit for bit on the arguments
    captured from leg 2 (K25's pack and K28's histogram and bounds from
    the range sort, K25's hash destinations from Q3, K26 from the sort's
    receive, K27 from Q1's partial merge, K28's hot buckets, bloom and
    probes from the hybrid join) and on synthetic edge cases, twice; each
    timed with CUDA events beside its plain version, its library
    yardstick and its bound (bytes read and written once at 3.35 TB/s;
    a lane layout counts every slot K25 writes)."""
    import torch

    recs = []
    for fname, prefer in (("exchange_dest", ("PX4_Q3",)),
                          ("exchange_pack", ("PX4_SORT",)),
                          ("exchange_recv", ("PX4_SORT",)),
                          ("shard_merge", ("PX4_Q1",)),
                          ("range_histogram", ("PX4_SORT",)),
                          ("range_bounds", ("PX4_SORT",)),
                          ("hash_histogram", ("PX4_HYBRID",)),
                          ("bloom_bits", ("PX4_HYBRID",)),
                          ("hot_buckets", ("PX4_HYBRID",)),
                          ("bucket_probe", ("PX4_HYBRID",))):
        stmt, args, kw = _pick(captured, fname, prefer)
        _check_call(kernels, fname, args, kw, f"{fname} ({stmt})")
    _stmt, args, _kw = _pick(captured, "exchange_pack", ("PX4_SORT",))
    ncases = px_synthetic(kernels, args[1].device)

    def esum(ts):
        return sum(t.element_size() for t in ts)

    # K25: the range sort's pack, the largest lane layout of the path
    stmt, (planes, mask, dest, nsh, cap), _kw = _pick(
        captured, "exchange_pack", ("PX4_SORT",))
    n = int(mask.shape[0])
    sent = int(mask.sum())
    k25 = (lambda: kernels.exchange_pack(planes, mask, dest, nsh, cap),
           lambda: kernels.exchange_pack_plain(planes, mask, dest, nsh, cap))

    def k25_lib():
        d = torch.where(mask, dest.long(), nsh)
        order = torch.sort(d, stable=True).indices
        return [p.index_select(0, order) for p in planes]

    k25_bytes = n * 5 + min(sent, nsh * cap) * esum(planes) + \
        nsh * cap * (esum(planes) + 1)
    k25_shape = {"statement": stmt, "rows": n, "live": sent, "shards": nsh,
                 "lane_cap": cap, "planes": len(planes)}
    # K26: the sort's receive (every sender's lane of every plane)
    stmt26, args26, kw26 = _pick(captured, "exchange_recv", ("PX4_SORT",))
    senders, rows, lane, outs = args26[:4]
    rest26 = args26[4:]
    nsend = len(senders[0])
    k26 = (lambda: kernels.exchange_recv(senders, rows, lane, outs, *rest26,
                                         **kw26),
           lambda: kernels.exchange_recv_plain(senders, rows, lane, outs,
                                               *rest26, **kw26))

    def k26_lib():
        return [torch.cat([b[lane * rows:(lane + 1) * rows] for b in p])
                for p in senders]

    k26_bytes = 2 * nsend * rows * sum(p[0].element_size() for p in senders)
    k26_shape = {"statement": stmt26, "senders": nsend, "rows": rows,
                 "planes": len(senders), "lane": lane,
                 "dtypes": [str(p[0].dtype).replace("torch.", "")
                            for p in senders]}
    # K27: Q1's partial-aggregate merge
    stmt27, (pl27, ops27), _kw = _pick(captured, "shard_merge", ("PX4_Q1",))
    k27 = (lambda: kernels.shard_merge(pl27, ops27),
           lambda: kernels.shard_merge_plain(pl27, ops27))

    def k27_lib():
        return [torch.stack(p).sum(0) for p in pl27]

    k27_bytes = sum((len(p) + 1) * p[0].numel() * p[0].element_size()
                    for p in pl27)
    k27_shape = {"statement": stmt27, "planes": len(pl27),
                 "shards": len(pl27[0]),
                 "elements": [int(p[0].numel()) for p in pl27]}
    # K28: the range sort's histogram over one shard's keys
    stmt28, (kv, m28, mm, res), _kw = _pick(captured, "range_histogram",
                                            ("PX4_SORT",))
    k28 = (lambda: kernels.range_histogram(kv, m28, mm, res),
           lambda: kernels.range_histogram_plain(kv, m28, mm, res))
    step = kernels.range_step_plain(mm, res)

    def k28_lib():
        b = torch.clamp(torch.div(kv - mm[0], step, rounding_mode="floor"),
                        0, res - 1)
        return torch.bincount(b[m28], minlength=res)

    k28_bytes = int(kv.shape[0]) * (kv.element_size() + 1) + res * 8
    k28_shape = {"statement": stmt28, "rows": int(kv.shape[0]),
                 "buckets": res}
    libs = {"K25_exchange_pack": "torch.sort(stable) + index_select",
            "K26_exchange_recv": "torch.cat of the lane slices",
            "K27_shard_merge": "torch.stack(...).sum(0)",
            "K28_bucket_hist": "torch.bincount over the torch bucket index"}
    for name, (kern, plain), lib, nbytes, shape in (
            ("K25_exchange_pack", k25, k25_lib, k25_bytes, k25_shape),
            ("K26_exchange_recv", k26, k26_lib, k26_bytes, k26_shape),
            ("K27_shard_merge", k27, k27_lib, k27_bytes, k27_shape),
            ("K28_bucket_hist", k28, k28_lib, k28_bytes, k28_shape)):
        km = cuda_ms(kern, reps)
        pm = cuda_ms(plain, max(1, reps // 2))
        lm = cuda_ms(lib, reps)
        bm, by = bound_ms(nbytes, 0)
        src, rep = KERNEL_META[name]
        print(f"kernel {name}: match exact on leg 2's captured calls and "
              f"{ncases} synthetic cases, two runs bit-identical, "
              f"kernel_ms {km:.6f}, plain_ms {pm:.6f}, library_ms {lm:.6f} "
              f"({libs[name]}), bound_ms {bm:.6f} ({by}, {nbytes} B) at "
              f"{shape}", flush=True)
        recs.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "max_abs_err": 0.0, "ms": km,
                     "plain_ms": pm, "bound_ms": bm, "bound_by": by,
                     "library_ms": lm, "library": libs[name],
                     "bytes": nbytes, "shape": shape})
    return recs


# the batched leg: 8 client threads in barrier-synced rounds of point
# reads over orders (and, interleaved in the coalescing legs, over
# lineitem), keys drawn from the table by --seed
BATCH_THREADS = 8
BATCH_ROUNDS = 16
BATCH_WAIT_US = 20_000
BATCH_A = ("select o_totalprice, o_orderdate from orders "
           "where o_orderkey = {k}")
BATCH_B = ("select l_extendedprice from lineitem "
           "where l_orderkey = {k} and l_linenumber = 1")


def batch_oracles(tables):
    """numpy oracles of BATCH_A and BATCH_B: key -> the one row, decoded
    as the Session decodes it (decimals as storage / 100 in float64,
    dates as int32 days)."""
    import numpy as np

    o, li = tables["orders"].data, tables["lineitem"].data
    ok = np.asarray(o["o_orderkey"])
    oo = np.argsort(ok, kind="stable")
    first = np.nonzero(np.asarray(li["l_linenumber"]) == 1)[0]
    lk = np.asarray(li["l_orderkey"])[first]
    lo = np.argsort(lk, kind="stable")

    def a(k):
        i = oo[np.searchsorted(ok, k, sorter=oo)]
        require(ok[i] == k, f"batched oracle: order {k} missing")
        return [(np.float64(o["o_totalprice"][i]) / 100,
                 np.int32(o["o_orderdate"][i]))]

    def b(k):
        j = lo[np.searchsorted(lk, k, sorter=lo)]
        require(lk[j] == k, f"batched oracle: line 1 of {k} missing")
        return [(np.float64(li["l_extendedprice"][first[j]]) / 100,)]

    return a, b


def batched_leg(db, fe, kernels, tables, seed) -> dict:
    """The batched program through the server: BATCH_THREADS threads in
    barrier-synced rounds over DbSession.sql and over the wire, the
    batcher on then off, then the coalescing legs (BATCH_A and BATCH_B
    interleaved by thread). Every leg's rows equal the numpy oracle and
    the on-leg's rows equal the off-leg's bit for bit; the on-legs batch
    (statements per dispatch > 1) within the pow2 compile bound; K24 is
    held to its plain version and the torch route on one batched round's
    programs. Statements/s and p50/p99 per leg (host clock)."""
    import numpy as np

    from oceanbase_tpu_torch.expr.compile import PackedParams

    rng = np.random.default_rng(seed)
    keys = rng.choice(np.asarray(tables["orders"].data["o_orderkey"]),
                      size=(BATCH_THREADS, BATCH_ROUNDS))
    oracle_a, oracle_b = batch_oracles(tables)
    s = db.session()
    s.sql("set ob_enable_result_cache = 0")
    for text in (BATCH_A, BATCH_B):  # admit both texts to the fast tier
        for k in keys[0, :3]:
            s.sql(text.format(k=int(k))).rows()
    ex = db.engine.executor

    def leg(name, mode, batching, texts, capture=None):
        db.batcher.enabled = batching
        n = BATCH_THREADS
        rows = [[None] * BATCH_ROUNDS for _ in range(n)]
        lat = [[] for _ in range(n)]
        errors = []
        barrier = threading.Barrier(n)
        setup = (f"set ob_batch_max_size = {n}",
                 f"set ob_batch_max_wait_us = {BATCH_WAIT_US}",
                 "set ob_enable_result_cache = 0")
        clients = []
        for _ in range(n):
            if mode == "wire":
                c = WireClient(fe.port)
                for q in setup:
                    c.query(q)
            else:
                c = db.session()
                for q in setup:
                    c.sql(q)
            clients.append(c)

        def worker(i):
            c = clients[i]
            text = texts[i % len(texts)]
            try:
                for r in range(BATCH_ROUNDS):
                    q = text.format(k=int(keys[i, r]))
                    barrier.wait()
                    t0 = time.perf_counter()
                    got = (c.query(q)[1] if mode == "wire"
                           else c.sql(q).rows())
                    lat[i].append((time.perf_counter() - t0) * 1e3)
                    rows[i][r] = got
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)
                barrier.abort()

        c0 = db.metrics.counters_snapshot()
        b0 = ex.batched_compiles
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        t0 = time.perf_counter()
        if capture is not None:
            with capture:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        else:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        wall = time.perf_counter() - t0
        c1 = db.metrics.counters_snapshot()
        for c in clients:
            if mode == "wire":
                c.close()
        if errors:
            raise errors[0]
        for i in range(n):
            oracle = oracle_a if texts[i % len(texts)] == BATCH_A \
                else oracle_b
            for r in range(BATCH_ROUNDS):
                want = oracle(int(keys[i, r]))
                if mode == "wire":
                    want = [tuple(wire_text(v) for v in w) for w in want]
                    require(rows[i][r] == want, f"batched {name}: thread "
                            f"{i} round {r}: {rows[i][r]} != {want}")
                else:
                    require(row_bits(rows[i][r]) == row_bits(want),
                            f"batched {name}: thread {i} round {r}: "
                            f"{rows[i][r]} != {want}")
        all_ms = sorted(x for v in lat for x in v)
        stmts = n * BATCH_ROUNDS
        batched = (c1.get("stmt batched statements", 0)
                   - c0.get("stmt batched statements", 0))
        disp = (c1.get("stmt batched dispatches", 0)
                - c0.get("stmt batched dispatches", 0))
        rec = {"leg": name, "statements": stmts, "wall_s": wall,
               "statements_per_s": stmts / wall,
               "p50_ms": float(np.percentile(all_ms, 50)),
               "p99_ms": float(np.percentile(all_ms, 99)),
               "batched_statements": batched, "batched_dispatches": disp,
               "coalesced_dispatches": (
                   c1.get("stmt batch coalesced dispatches", 0)
                   - c0.get("stmt batch coalesced dispatches", 0)),
               "batched_compiles": ex.batched_compiles - b0,
               "rows": [[row_bits(x) for x in v] for v in rows]}
        print(f"batched leg {name}: {stmts} statements in {wall:.3f} s "
              f"({rec['statements_per_s']:.1f} statements/s), p50 "
              f"{rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms, "
              f"{batched} batched statements in {disp} dispatches "
              f"({rec['coalesced_dispatches']} coalesced), rows equal the "
              "numpy oracle", flush=True)
        return rec

    cap = K24Capture()
    b_start = ex.batched_compiles
    legs = [leg("db_on", "db", True, [BATCH_A], capture=cap),
            leg("db_off", "db", False, [BATCH_A]),
            leg("wire_on", "wire", True, [BATCH_A]),
            leg("wire_off", "wire", False, [BATCH_A])]
    single_compiles = ex.batched_compiles - b_start
    legs += [leg("coalesce_on", "db", True, [BATCH_A, BATCH_B]),
             leg("coalesce_off", "db", False, [BATCH_A, BATCH_B])]
    db.batcher.enabled = True
    by = {r["leg"]: r for r in legs}
    for on, off in (("db_on", "db_off"), ("wire_on", "wire_off"),
                    ("coalesce_on", "coalesce_off")):
        require(by[on]["rows"] == by[off]["rows"],
                f"batched {on}: rows differ from {off}")
        r = by[on]
        require(r["batched_dispatches"] > 0 and r["batched_statements"]
                / r["batched_dispatches"] > 1,
                f"batched {on}: {r['batched_statements']} statements in "
                f"{r['batched_dispatches']} dispatches")
    require(single_compiles <= 4, f"batched: {single_compiles} bucket "
            "programs for one plan (pow2 bound 4)")
    # the two plans' cohorts in one call and one copy (_combo_run),
    # against the oracle lane by lane
    from oceanbase_tpu_torch.server.batcher import _combo_run

    def rows_of(text, ks):
        """The plan's cache entry and each key's packed row, as the
        Session binds the statement."""
        got = [db.engine.cached_entry(text.format(k=int(k))) for k in ks]
        return got[0][0], np.stack([q.cpu().numpy() for _e, q in got])

    ka, kb = keys[0, :5], keys[1, :3]
    (ea, qa), (eb, qb) = rows_of(BATCH_A, ka), rows_of(BATCH_B, kb)
    res = _combo_run(ea.prepared, eb.prepared, qa, qb)
    require(res is not None, "batched: _combo_run overflowed")
    from oceanbase_tpu_torch.core.column import host_rows_batched

    for (hc, hv, hs, sch, dic), ks, oracle, names in (
            (res[0], ka, oracle_a, ea.output_names),
            (res[1], kb, oracle_b, eb.output_names)):
        lanes = host_rows_batched(sch, dic, hc, hv, hs)
        for lane, k in zip(lanes, ks):
            got = list(zip(*[lane[n] for n in names]))
            require(row_bits(got) == row_bits(oracle(int(k))),
                    f"batched: _combo_run lane of key {k}: {got}")
    calls = list(cap.calls.values())
    require(any(isinstance(c["frame"], PackedParams) for c in calls),
            "batched: no K24 call read a lane row")
    for i, c in enumerate(calls):
        k24_check_call(kernels, c, f"batched call {i}")
    for r in legs:
        del r["rows"]
    return {"legs": legs, "threads": BATCH_THREADS, "rounds": BATCH_ROUNDS,
            "batched_compiles_one_plan": single_compiles,
            "batched_compiles_total": ex.batched_compiles - b_start,
            "k24_programs_checked": len(calls)}


def batched_phase(tables, uk, kernels, seed) -> tuple:
    """The batched leg on a Database of its own (the TPC-H tables
    preloaded, the wire front on localhost), with its own launch counts.
    It runs last: after its client threads have run statements on the
    card, torch.profiler records no device event of a later traced run
    (seen on the H100)."""
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.server.mysql_front import MySqlFrontend

    db = Database(n_nodes=1, n_ls=1, extra_catalog=tables)
    db._unique_keys.update(uk)
    db.engine.executor.unique_keys = db._unique_keys
    db.engine.planner.unique_keys = db._unique_keys
    fe = MySqlFrontend(db).start()
    kernels.reset_launches()
    try:
        rec = batched_leg(db, fe, kernels, tables, seed)
        launches = dict(kernels.LAUNCHES)
    finally:
        fe.stop()
        db.close()
    require(launches["K24_fused_expr"] > 0, "batched: K24 never launched")
    return rec, launches


def k23_checks(kernels, reps: int, captured: dict) -> list:
    """K23 against its plain version bit for bit on the server phase's
    arguments (the head fetch over lineitem at widths 16 and 1024, the
    lookup's narrowed frame, the wide leg's 83 planes) and on synthetic
    edge cases (no live row, every row live with k == cap, a live row
    only at the last index, k > nlive and k > cap, every column type, a
    VECTOR column, 72 columns), twice; timed on the head
    fetch's 1024-row width beside its plain version, the yardstick
    `torch.nonzero(sel)[:k]` + `index_select` (which syncs the host) and
    its bound: sel read once, k rows of every column read and written."""
    import numpy as np
    import torch

    dev = captured["head"][0].device
    sel, k, cols = captured["head"]
    nsel, nk, ncols = captured["narrow"]
    cases = [("head", sel, k, cols), ("head16", sel, 16, cols),
             ("narrow", nsel, nk, ncols), ("wide", *captured["wide"])]
    rng = np.random.default_rng(23)
    cap = (1 << 20) + 5
    syn_cols = [torch.from_numpy(rng.integers(-2**62, 2**62, cap)).to(dev)]
    for dt in (torch.int32, torch.int16, torch.int8, torch.uint8,
               torch.float64, torch.float32, torch.bool):
        syn_cols.append(torch.from_numpy(
            rng.integers(0, 200, cap)).to(dev).to(dt))
    syn_cols.append(torch.from_numpy(
        rng.standard_normal((cap, 8)).astype(np.float32)).to(dev))
    last = torch.zeros(cap, dtype=torch.bool, device=dev)
    last[-1] = True
    rnd = torch.from_numpy(rng.random(cap) < 0.01).to(dev)
    cases += [
        ("all_dead", torch.zeros(cap, dtype=torch.bool, device=dev), 64,
         syn_cols),
        ("all_live_k_cap", torch.ones(cap, dtype=torch.bool, device=dev),
         cap, syn_cols),
        ("last_only", last, 16, syn_cols),
        ("k_above_nlive", rnd, 1 << 14, syn_cols),
        ("k_above_cap", rnd, cap + 1000, syn_cols[:3]),
        ("wide_72", rnd[:1 << 16], 1 << 12,
         [c[:1 << 16] for c in syn_cols] * 8),
    ]

    def bits(t):
        if t.dtype == torch.float64:
            return t.view(torch.int64)
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        return t

    for name, cs, ck, ccols in cases:
        got = kernels.first_live(cs, ck, ccols)
        want = kernels.first_live_plain(cs, ck, ccols)
        again = kernels.first_live(cs, ck, ccols)
        for a, b, c in zip([got[0], got[1], *got[2]],
                           [want[0], want[1], *want[2]],
                           [again[0], again[1], *again[2]]):
            require(a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(bits(a), bits(b)),
                    f"K23 {name}: differs from the plain version")
            require(torch.equal(bits(a), bits(c)), f"K23 {name}: two runs "
                    "differ")
    del syn_cols, cases

    def library():
        idx = torch.nonzero(sel).flatten()[:k]
        return [c.index_select(0, idx) for c in cols]

    km = cuda_ms(lambda: kernels.first_live(sel, k, cols), reps)
    pm = cuda_ms(lambda: kernels.first_live_plain(sel, k, cols),
                 max(1, reps // 2))
    lm = cuda_ms(library, reps)
    row = sum(c.element_size() * (c.shape[1] if c.dim() == 2 else 1)
              for c in cols)
    cap_h = int(sel.shape[0])
    bm, by = bound_ms(cap_h + k * 8 + 2 * k * row, cap_h)
    src, rep = KERNEL_META["K23_first_live"]
    print(f"kernel K23_first_live: match exact on the head fetch (cap "
          f"{cap_h}, k {k} and 16), the lookup's frame (cap "
          f"{int(nsel.shape[0])}, k {nk}), the wide leg "
          f"({len(captured['wide'][2])} planes) and 6 synthetic cases, two "
          f"runs bit-identical, "
          f"kernel_ms {km:.6f}, plain_ms {pm:.6f}, library_ms {lm:.6f}, "
          f"bound_ms {bm:.6f} ({by})", flush=True)
    return [{"name": "K23_first_live", "route": "cuda", "source": src,
             "replaces": rep, "max_abs_err": 0.0, "ms": km, "plain_ms": pm,
             "bound_ms": bm, "bound_by": by, "library_ms": lm,
             "shape": {"cap": cap_h, "k": k, "columns": len(cols),
                       "row_bytes": row}}]


# ---- K24: the fused expression kernel -------------------------------------
# The statements whose expression trees K24 is held against its plain
# version and the torch route on (the main path's, and the batched leg's)
K24_STMTS = ("Q1", "Q6", "Q14", "Q19", "Q7", "DS3", "W4")


class K24Capture:
    """Within the block, every fused expression call is recorded: the
    trees, the mode, the batch and parameter frame (compile._fused), and
    the program, parameter row and torch-route columns K24 ran with
    (kernels.fused_expr). `keep` bounds the records to the widest call
    of each program."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from oceanbase_tpu_torch import kernels
        from oceanbase_tpu_torch.expr import compile as xc

        self._saved = (xc._fused, kernels.fused_expr)
        orig_fused, orig_fx = self._saved
        local = threading.local()  # the server's sessions run on threads

        def fused(exprs, batch, predicate):
            local.cur = (exprs, predicate, batch, xc._active_params())
            try:
                return orig_fused(exprs, batch, predicate)
            finally:
                local.cur = None

        def fx(program, batch, qrow=None, ext=()):
            cur = getattr(local, "cur", None)
            if cur is not None:
                exprs, predicate, b, frame = cur
                key = id(program)
                old = self.calls.get(key)
                if old is None or batch.capacity > old["batch"].capacity:
                    self.calls[key] = {
                        "exprs": exprs, "predicate": predicate,
                        "batch": batch, "frame": frame, "program": program,
                        "qrow": qrow, "ext": list(ext)}
            return orig_fx(program, batch, qrow, ext)

        xc._fused, kernels.fused_expr = fused, fx
        return self

    def __exit__(self, *exc):
        from oceanbase_tpu_torch import kernels
        from oceanbase_tpu_torch.expr import compile as xc

        xc._fused, kernels.fused_expr = self._saved
        return False


def _bits_t(t):
    import torch

    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _same_t(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is None and b is None
    if b.dim() == 0 and a.dim() == 1:
        b = b.expand(a.shape[0])
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits_t(a.contiguous()), _bits_t(b.contiguous())))


def k24_bytes(prog, batch, ext) -> int:
    """Bytes K24 must move for one run of `prog`: each input column,
    validity plane, sel, LUT and torch-route column read once, each
    output written once (spilled temporaries are not counted)."""
    seen, total = set(), 0
    luts = prog.luts_on(batch.sel.device)
    for ch in prog.chunks:
        for d in ch.inputs:
            if d in seen or d[0] == "tmp":
                continue
            seen.add(d)
            if d[0] == "col":
                t = batch.cols[d[1]]
            elif d[0] == "valid":
                t = batch.valid[d[1]]
            elif d[0] == "sel":
                t = batch.sel
            elif d[0] == "lut":
                t = luts[d[1]]
            else:
                t = ext[d[1]][0 if d[0] == "ext" else 1]
            total += t.numel() * t.element_size()
    cap = batch.capacity
    total += sum(cap * dt.itemsize for dt in prog.out_dtypes)
    return total


def k24_check_call(kernels, c, what: str) -> None:
    """One captured call: K24 (twice) equals its plain version on the
    card and the torch route's evaluate / compile_predicate under the
    same parameter frame, bit for bit, with the route's dtypes and the
    None-ness of every validity plane."""
    from oceanbase_tpu_torch.expr import compile as xc

    prog, batch, qrow, ext = c["program"], c["batch"], c["qrow"], c["ext"]
    got = kernels.fused_expr(prog, batch, qrow, ext)
    again = kernels.fused_expr(prog, batch, qrow, ext)
    plain = kernels.fused_expr_plain(prog, batch, qrow, ext)
    for a, b, p in zip(got, again, plain):
        require(_same_t(a, p), f"K24 {what}: differs from the plain version")
        require(_same_t(a, b), f"K24 {what}: two runs differ")
    prev = xc.set_params(c["frame"])
    try:
        if c["predicate"]:
            ref = [(xc._predicate_route(c["exprs"][0], batch), None)]
        else:
            ref = [xc._route(e, batch) for e in c["exprs"]]
    finally:
        xc.set_params(prev)
    for (vi, ii), (rv, rvv) in zip(prog.pairs, ref):
        require(_same_t(got[vi], rv), f"K24 {what}: values differ from the "
                "torch route")
        require((ii is None) == (rvv is None), f"K24 {what}: validity "
                "None-ness differs from the torch route")
        if ii is not None:
            require(_same_t(got[ii], rvv), f"K24 {what}: validity differs "
                    "from the torch route")


def k24_statement_checks(kernels, runs: dict, reps: int) -> tuple:
    """Each statement of K24_STMTS once more with its fused calls
    captured; every captured program held to its plain version and the
    torch route (k24_check_call). Returns (per-statement records, the
    timing record of Q6's predicate)."""
    recs, q6 = [], None
    for name in K24_STMTS:
        sess, text = runs[name]
        with K24Capture() as cap:
            sess.sql(text).nrows
        calls = list(cap.calls.values())
        require(calls, f"K24 {name}: no fused call was captured")
        for i, c in enumerate(calls):
            k24_check_call(kernels, c, f"{name} call {i}")
        widest = max(calls, key=lambda c: c["batch"].capacity)
        recs.append({
            "statement": name, "programs": len(calls),
            "chunks": sum(len(c["program"].chunks) for c in calls),
            "instructions": [c["program"].n_instructions for c in calls],
            "widest_rows": widest["batch"].capacity})
        if name == "Q6":
            preds = [c for c in calls if c["predicate"]]
            require(preds, "K24 Q6: no predicate program")
            q6 = max(preds, key=lambda c: c["batch"].capacity)
        else:
            del calls
    prog, batch, qrow, ext = q6["program"], q6["batch"], q6["qrow"], q6["ext"]
    km = cuda_ms(lambda: kernels.fused_expr(prog, batch, qrow, ext), reps)
    pm = cuda_ms(lambda: kernels.fused_expr_plain(prog, batch, qrow, ext),
                 max(1, reps // 2))
    nbytes = k24_bytes(prog, batch, ext)
    bm, by = bound_ms(nbytes, 0)
    src, rep = KERNEL_META["K24_fused_expr"]
    rec = {"name": "K24_fused_expr", "route": "cuda", "source": src,
           "replaces": rep, "max_abs_err": 0.0, "ms": km, "plain_ms": pm,
           "bound_ms": bm, "bound_by": by, "library_ms": None,
           "shape": {"statement": "Q6", "rows": batch.capacity,
                     "bytes": nbytes, "chunks": len(prog.chunks),
                     "instructions": prog.n_instructions}}
    print(f"kernel K24_fused_expr: bit-identical to its plain version and "
          f"the torch route on every program of {', '.join(K24_STMTS)} "
          f"({sum(r['programs'] for r in recs)} programs), two runs "
          f"bit-identical; Q6's predicate ({batch.capacity} rows, "
          f"{prog.n_instructions} instructions, {nbytes} B): kernel_ms "
          f"{km:.6f}, plain_ms {pm:.6f}, bound_ms {bm:.6f} ({by})",
          flush=True)
    return recs, rec


def k24_synthetic(kernels, dev="cuda") -> dict:
    """K24 against its plain version and the torch route on synthetic
    edge cases on the card: NULL planes (one all NULL), NaN, infinities
    and -0.0 in float32 and float64, negative decimals at scales 0-6,
    int32 edges, negative days into extract_year/month/day, dictionary
    compares, IN and LIKE, an empty sel, a capacity that is no multiple
    of the block, a program at the register limit and one split past
    it (instruction limit too)."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.core.column import ColumnBatch
    from oceanbase_tpu_torch.core.dictionary import Dictionary
    from oceanbase_tpu_torch.core.dtypes import DataType, Field, Schema
    from oceanbase_tpu_torch.expr import ir as E
    from oceanbase_tpu_torch.expr import program as xp

    dev = torch.device(dev)
    rng = np.random.default_rng(24)
    cap = 1_000_003
    i32 = rng.integers(-2**31, 2**31, cap).astype(np.int32)
    i32[:6] = [-2**31, 2**31 - 1, 0, -1, 1, -2**31 + 1]
    f64 = rng.standard_normal(cap) * 1e3
    f64[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324]
    f32 = f64.astype(np.float32)
    days = rng.integers(-800_000, 800_000, cap).astype(np.int32)
    days[:4] = [-719468, -1, 0, -146097]
    words = sorted({f"w{i:03d}{'ab'[i % 2]}" for i in range(300)})
    d = Dictionary(words, sorted_=True)
    codes = rng.integers(0, len(words), cap).astype(np.int32)
    cols = {"i32": i32, "i64": rng.integers(-2**40, 2**40, cap),
            "f32": f32, "f64": f64, "day": days, "s": codes}
    types = {"i32": DataType.int32(True), "i64": DataType.int64(True),
             "f32": DataType.float32(True), "f64": DataType.float64(True),
             "day": DataType.date(True), "s": DataType.varchar(True)}
    for sc in range(7):
        cols[f"d{sc}"] = rng.integers(-10**9, 10**9, cap)
        types[f"d{sc}"] = DataType.decimal(18, sc, True)
    cols["nul"] = rng.integers(0, 100, cap)
    types["nul"] = DataType.int64(True)
    valid = {n: rng.random(cap) < 0.9 for n in cols}
    valid["nul"] = np.zeros(cap, bool)
    schema = Schema(tuple(Field(n, types[n]) for n in cols))

    def batch_of(sel):
        return ColumnBatch(
            cols={n: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for n, v in cols.items()},
            valid={n: torch.from_numpy(v).to(dev) for n, v in valid.items()},
            sel=torch.from_numpy(sel).to(dev),
            nrows=torch.tensor(int(sel.sum()), device=dev),
            schema=schema, dicts={"s": d})

    c, lit = E.ColRef, E.Literal

    def cmp(op, a, b):
        return E.Compare(op, a, b)

    dec2 = DataType.decimal(12, 2)
    trees = [
        E.BinaryOp("+", c("i32"), c("i64")),
        E.BinaryOp("*", c("i32"), c("i32")),
        E.BinaryOp("-", lit(0, DataType.int32()), c("i32")),
        E.BinaryOp("%", c("i64"), c("i32")),
        E.BinaryOp("/", c("i64"), c("i32")),
        E.BinaryOp("*", c("f32"), c("f32")),
        E.BinaryOp("+", E.BinaryOp("*", c("f64"), c("f64")), c("f64")),
        E.BinaryOp("/", c("f32"), c("f64")),
        E.BinaryOp("%", c("f64"), lit(7.5, DataType.float64())),
        E.BinaryOp("*", c("d2"), E.BinaryOp("-", lit(1, DataType.int64()),
                                             c("d3"))),
        E.BinaryOp("+", c("d0"), c("d6")),
        E.BinaryOp("/", c("d5"), c("d1")),
        E.BinaryOp("*", c("d4"), c("f32")),
        E.Cast(c("d6"), DataType.decimal(18, 1)),
        E.Cast(c("d3"), DataType.int32()),
        E.Cast(c("f64"), DataType.int32()),
        E.Cast(c("f64"), dec2),
        E.Cast(c("i32"), DataType.float32()),
        E.Func("extract_year", (c("day"),)),
        E.Func("extract_month", (c("day"),)),
        E.Func("extract_day", (c("day"),)),
        E.Func("abs", (c("i32"),)), E.Func("neg", (c("f64"),)),
        E.Func("abs", (c("f32"),)),
        E.Func("least", (c("f64"), c("f32"), c("i32"))),
        E.Func("greatest", (c("i64"), c("d2"))),
        E.Case(((cmp("<", c("i32"), lit(0, DataType.int32())), c("f64")),
                (E.IsNull(c("i64")), c("d2"))), c("nul")),
        E.Case(((cmp(">", c("f32"), c("f64")), c("i32")),)),
        E.BinaryOp("+", c("nul"), c("i64")),
        # equal trees (0.0 == -0.0) with their own programs: +inf, -inf
        E.BinaryOp("/", lit(1.0, DataType.float64()), E.BinaryOp(
            "+", c("f64"), lit(0.0, DataType.float64()))),
        E.BinaryOp("/", lit(1.0, DataType.float64()), E.BinaryOp(
            "+", c("f64"), lit(-0.0, DataType.float64()))),
    ]
    preds = [
        E.BoolOp("and", (cmp(">=", c("i32"), lit(-5, DataType.int32())),
                         cmp("<", c("f64"), c("f32")),
                         E.Not(E.IsNull(c("d2"))))),
        E.BoolOp("or", (cmp("=", c("nul"), lit(3, DataType.int64())),
                        cmp("!=", c("f32"), c("f32")),
                        E.IsNull(c("i32"), True))),
        E.BoolOp("and", (cmp("=", c("nul"), c("nul")),
                         cmp("<=", c("d2"), lit(-1.5, dec2)))),
        E.Between(c("day"), lit("1960-01-01", DataType.date()),
                  lit("1999-12-31", DataType.date())),
        E.InList(c("i64"), (1, -2, 3, 2**40 - 1)),
        E.InList(c("s"), (words[3], words[7], "nope"), True),
        cmp("<", c("s"), lit(words[150], DataType.varchar())),
        cmp("=", c("s"), lit(words[9], DataType.varchar())),
        E.Func("like", (c("s"), lit("w1%a", DataType.varchar()))),
        E.Func("prefix", (c("s"), lit("w2", DataType.varchar()))),
        E.Not(cmp("<>", c("f64"), lit(0.0, DataType.float64()))),
    ]
    # the register limit: an AND of n compares keeps n values live
    def wide_and(n):
        return E.BoolOp("and", tuple(
            cmp("<", c("i64"), lit(i * 1000, DataType.int64()))
            for i in range(n)))

    # the instruction limit: a long chain of additions
    def long_chain(n):
        e = c("i64")
        for i in range(n):
            e = E.BinaryOp("+", E.BinaryOp("*", e, lit(3, DataType.int64())),
                           c(f"d{i % 7}"))
        return e

    sel = rng.random(cap) < 0.5
    b = batch_of(sel)

    def lowered(e, predicate):
        from oceanbase_tpu_torch.expr import compile as xc

        return xp.lower((e,), b, xc._route, xc._predicate_route,
                        xc.set_params, {}, False, predicate)

    at_limit = max(n for n in range(2, 64)
                   if len(lowered(wide_and(n), True).chunks) == 1)
    p_at = lowered(wide_and(at_limit), True)
    p_past = lowered(wide_and(at_limit + 1), True)
    require(len(p_past.chunks) > 1, "K24: the tree past the register "
            "limit did not split")
    chain_n = 80
    p_chain = lowered(long_chain(chain_n), False)
    require(len(p_chain.chunks) > 1 and all(
        len(ch.code) <= xp.MAX_INS for ch in p_chain.chunks),
        "K24: the long chain did not split within the instruction limit")
    cases = 0
    for sel_case in (sel, np.zeros(cap, bool)):
        bb = batch_of(sel_case)
        for predicate, group in ((False, trees), (True, preds + [
                wide_and(at_limit), wide_and(at_limit + 1)])):
            for e in group:
                with K24Capture() as capt:
                    if predicate:
                        from oceanbase_tpu_torch.expr.compile import (
                            compile_predicate,
                        )
                        compile_predicate(e, bb)
                    else:
                        from oceanbase_tpu_torch.expr.compile import evaluate
                        evaluate(e, bb)
                require(len(capt.calls) == 1, f"K24 synthetic {e}: not lowered")
                for call in capt.calls.values():
                    k24_check_call(kernels, call, f"synthetic {e}")
                cases += 1
        with K24Capture() as capt:
            from oceanbase_tpu_torch.expr.compile import evaluate
            evaluate(long_chain(chain_n), bb)
        for call in capt.calls.values():
            k24_check_call(kernels, call, "synthetic long chain")
        cases += 1
    # a tree the tracer cannot record is the statement's error on the
    # card: it never runs whole on the torch route
    from oceanbase_tpu_torch.expr import compile as xc

    real_func = xc._eval_func

    def planted(e, batch):
        if e.name == "abs":
            v, vv = xc._route(e.args[0], batch)
            return torch.sin(v), vv
        return real_func(e, batch)

    x0 = dict(xp.EXPR_COUNTS)
    xc._eval_func = planted
    try:
        xc.evaluate(E.Func("abs", (c("f64"),)), b)
        refused = False
    except xp.NotLowerable:
        refused = True
    finally:
        xc._eval_func = real_func
    require(refused and xp.EXPR_COUNTS == x0,
            "K24: an untraceable tree did not raise on the card")
    print(f"kernel K24_fused_expr: {cases} synthetic cases bit-identical to "
          f"the plain version and the torch route (cap {cap}, half and "
          f"empty sel; register limit at {at_limit} live compares: "
          f"{p_at.chunks[0].nregs} registers in 1 chunk, "
          f"{len(p_past.chunks)} chunks past it; a {chain_n}-step chain in "
          f"{len(p_chain.chunks)} chunks of <= {xp.MAX_INS} instructions); "
          f"an untraceable tree raised NotLowerable", flush=True)
    return {"cases": cases, "cap": cap, "register_limit_terms": at_limit,
            "regs_at_limit": p_at.chunks[0].nregs,
            "chunks_past_limit": len(p_past.chunks),
            "chain_chunks": len(p_chain.chunks)}


# ---- the vector phase ----------------------------------------------------
# The reference's ANN benchmark deployment (tools/ann_bench.py:80-100):
# 1M x 128 float32 embeddings (the shape of ANN-Benchmarks' SIFT-128 base
# set), 256 gaussian blobs (centers x 4, unit noise), numpy seed 4, grp =
# id % 10; IVF lists 1024, nprobe 32, k 10; 50 query vectors (a random row
# + 0.05 noise).
ANN_N, ANN_D, ANN_BLOBS, ANN_SEED, ANN_NQ = 1_000_000, 128, 256, 4, 50
ANN_LISTS, ANN_NPROBE, ANN_K = 1024, 32, 10
# the reference tests' shape (tests/test_vector_index.py::_vec_table), for
# the card against the CPU and the starved probe
SMALL_N, SMALL_D, SMALL_BLOBS, SMALL_SEED = 20000, 32, 40, 0
SMALL_LISTS, SMALL_NPROBE = 64, 8
# Two distances closer than this x (|x|^2 + |q|^2) may swap places: float32
# dot products summed in another order differ by about 1e-6 of that scale.
VEC_MARGIN = 1e-5
# A distance column holds |x|^2 - 2 x.q + |q|^2 in float32, which cancels
# terms of size |x|^2 + |q|^2: it is held to numpy's float64 value within
# this x (|x|^2 + |q|^2).
VEC_DIST_TOL = 2e-5
# the kernels' synthetic case: lists (above one block's share), rows, dims
VEC_SYNTHETIC = (8192, 60_000, 64)
# a LIMIT past K22's old cap of 2048 (the card against the CPU)
K22_BIG_K = 4096


def ann_data(n, d, blobs, seed, nq):
    """(x, blob of each row, centers, queries), drawn in the bench's order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(blobs, d)).astype(np.float32) * 4
    a = rng.integers(0, blobs, n)
    x = centers[a] + rng.normal(size=(n, d)).astype(np.float32)
    queries = x[rng.integers(0, n, nq)] + rng.normal(
        size=(nq, d)).astype(np.float32) * 0.05
    return x, a, centers, queries


def vec_catalog(x, extra):
    """{"docs": id int64, the extra int64 columns, emb vector(d)}."""
    import numpy as np

    from oceanbase_tpu_torch.core.dtypes import (
        DataType,
        Field,
        Schema,
        TypeKind,
    )
    from oceanbase_tpu_torch.core.table import Table

    n, d = x.shape
    data = {"id": np.arange(n, dtype=np.int64), **extra, "emb": x}
    schema = Schema(tuple(Field(c, DataType(TypeKind.INT64))
                          for c in ("id", *extra))
                    + (Field("emb", DataType.vector(d)),))
    return {"docs": Table("docs", schema, data)}


def vec_text(q, where="", dist=False, k=ANN_K) -> str:
    lit = "[" + ",".join(f"{v:.6f}" for v in q) + "]"
    if dist:
        return (f"select id, vec_l2(emb, '{lit}') as d from docs {where}"
                f"order by d limit {k}")
    return (f"select id from docs {where}order by vec_l2(emb, '{lit}') "
            f"limit {k}")


class ExactL2:
    """numpy's exact nearest neighbours: float64 |x - q|^2, ties to the
    lower id (a stable argsort). Candidates come from the float64
    expansion |x|^2 - 2 x.q + |q|^2 (error ~1e-13 of the scale), and the
    64 best are re-ranked exactly."""

    def __init__(self, x):
        import numpy as np

        self.x = x
        self.x64 = x.astype(np.float64)
        self.xn = (self.x64 * self.x64).sum(axis=1)

    def dist(self, ids, q):
        q64 = q.astype(self.x64.dtype)
        return ((self.x64[ids] - q64[None, :]) ** 2).sum(axis=1)

    def top(self, q, k=ANN_K, mask=None):
        import numpy as np

        q64 = q.astype(np.float64)
        approx = self.xn - 2.0 * (self.x64 @ q64)
        ids = np.arange(len(self.x))
        if mask is not None:
            approx, ids = approx[mask], ids[mask]
        m = min(len(ids), 64)
        cand = ids[np.argpartition(approx, m - 1)[:m]]
        d = self.dist(cand, q)
        order = np.lexsort((cand, d))
        return cand[order[:k]], d[order[:k]]

    def scale(self, ids, q):
        """|x|^2 + |q|^2 of the rows `ids`: the size of the terms a float32
        distance cancels."""
        q64 = q.astype(self.x64.dtype)
        return self.xn[ids] + float(q64 @ q64)


def margin_equal(exact, got, want, q, what) -> int:
    """`got` ids equal `want` ids rank by rank, except where the exact
    distances of the two differ by less than VEC_MARGIN x (|x|^2 +
    |q|^2), a swap float32 rounding may cause. Returns the swaps."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    require(len(got) == len(want), f"{what}: {len(got)} rows, the "
            f"reference has {len(want)}")
    swaps = 0
    for r in np.flatnonzero(got != want):
        dg = exact.dist(got[r:r + 1], q)[0]
        dw = exact.dist(want[r:r + 1], q)[0]
        tol = VEC_MARGIN * max(exact.scale(got[r:r + 1], q)[0],
                               exact.scale(want[r:r + 1], q)[0])
        require(abs(dg - dw) <= tol, f"{what}: rank {r} holds id {got[r]} "
                f"(distance {dg!r}) where the reference has {want[r]} "
                f"({dw!r}), beyond the margin {tol!r}")
        swaps += 1
    return swaps


def vec_ids(rs):
    import numpy as np

    return np.asarray(rs.storage_columns()["id"], dtype=np.int64)


def vector_phase(Session, kernels, warm, reps):
    """The IVF vector path on the bench deployment; the launch counts
    from 0 just before and read just after. Returns (statement records,
    build record, launches, kernel arguments, the V_STARVE table's
    vectors, the narrowed frame's A/B records, the deployment for the
    sharded ANN leg)."""
    import numpy as np
    import torch

    import oceanbase_tpu_torch.engine.executor as ex
    from oceanbase_tpu_torch.storage.vector_index import (
        register_vector_index,
    )

    t0 = time.perf_counter()
    x, _blob, _c, queries = ann_data(ANN_N, ANN_D, ANN_BLOBS, ANN_SEED,
                                     ANN_NQ)
    grp = np.arange(ANN_N, dtype=np.int64) % 10
    cat = vec_catalog(x, {"grp": grp})
    exact = ExactL2(x)
    f50 = grp < 5
    print(f"vector data {ANN_N} x {ANN_D} ({ANN_BLOBS} blobs, seed "
          f"{ANN_SEED}) in {time.perf_counter() - t0:.3f} s (host)",
          flush=True)
    runs = warm + 2
    # query vectors: 0-9 hold the recall truth (as the bench), the rest
    # give each statement distinct vectors for its runs
    spare = iter(range(10, ANN_NQ))
    qsets = {name: [next(spare) for _ in range(runs)]
             for name in ("V_BRUTE", "V_L2", "V_F50", "V_DIST")}

    def exact_check(name):
        qi = qsets[name][warm]  # the last untraced run

        def check(rs):
            want, _d = exact.top(queries[qi])
            got = vec_ids(rs)
            swaps = margin_equal(exact, got, want, queries[qi],
                                 f"{name} query {qi}")
            print(f"{name}: ids equal numpy's exact top-{ANN_K} "
                  f"({swaps} margin swaps)", flush=True)
            return len(got)
        return check

    def ann_check(name, mask=None):
        """An approximate answer: k distinct rows that pass the filter,
        in ascending exact distance (the margin rule); recall is held
        over 10 queries apart."""
        qi = qsets[name][warm]

        def check(rs):
            q = queries[qi]
            got = vec_ids(rs)
            require(len(got) == ANN_K and len(set(got.tolist())) == ANN_K,
                    f"{name}: {len(got)} rows, expected {ANN_K} distinct")
            if mask is not None:
                require(bool(mask[got].all()), f"{name}: a row fails the "
                        "filter")
            dg = exact.dist(got, q)
            tol = VEC_MARGIN * exact.scale(got, q)
            require(bool(np.all(np.diff(dg) >= -np.maximum(tol[1:],
                                                           tol[:-1]))),
                    f"{name}: rows out of distance order")
            return len(got)
        return check

    def recall(sess, name, where, mask):
        hits = 0
        for qi in range(10):
            got = vec_ids(sess.sql(vec_text(queries[qi], where)))
            want, _d = exact.top(queries[qi], mask=mask)
            hits += len(set(got.tolist()) & set(want.tolist()))
        r = hits / (10 * ANN_K)
        print(f"{name}: recall@{ANN_K} {r} over 10 queries", flush=True)
        require(r >= 0.9, f"{name}: recall@{ANN_K} {r} below 0.9")
        return r

    kernels.reset_launches()
    recs = []
    bsess = Session(cat, device="cuda")

    def brute_after(rs):
        prep = rs._cursor.prepared
        require(not prep.params.vector_topns, "V_BRUTE took the IVF route")
        return {"route": "brute"}

    recs.append(run_statement(
        bsess, kernels, "V_BRUTE",
        [vec_text(queries[i]) for i in qsets["V_BRUTE"]],
        exact_check("V_BRUTE"), warm, ANN_N, "docs", after=brute_after))
    ab = [narrow_ab(bsess, "V_BRUTE", vec_text(queries[qsets["V_BRUTE"][0]]))]
    del bsess
    release_device()

    register_vector_index(cat, "docs", "emb", lists=ANN_LISTS,
                          nprobe=ANN_NPROBE)
    sess = Session(cat, device="cuda")
    k0 = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = sess.executor.ivf_host("docs", "emb")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bl = {k: kernels.LAUNCHES[k] - k0[k] for k in kernels.LAUNCHES}
    build = {"build_s": build_s, "iterations": idx.iterations,
             "max_list": idx.max_list, "lists": len(idx.lengths),
             "mean_list": float(np.mean(idx.lengths)),
             "launches": {k: v for k, v in bl.items() if v}}
    print(f"V_BUILD: lists {len(idx.lengths)} over {ANN_N} rows in "
          f"{build_s:.3f} s, {idx.iterations} iterations, max_list "
          f"{idx.max_list} (mean {build['mean_list']:.1f}), launches "
          f"{build['launches']}", flush=True)
    require(bl["K19_kmeans_assign"] == idx.iterations + 1
            and bl["K20_kmeans_update"] == idx.iterations,
            f"V_BUILD: K19 {bl['K19_kmeans_assign']} and K20 "
            f"{bl['K20_kmeans_update']} launches for {idx.iterations} "
            "iterations")

    def ivf_after(name, nprobe_at_least=ANN_NPROBE):
        def after(rs):
            prep = rs._cursor.prepared
            vts = prep.params.vector_topns
            require(bool(vts), f"{name}: the IVF route did not engage")
            (v,) = vts.values()
            require(v.nprobe >= nprobe_at_least, f"{name}: nprobe "
                    f"{v.nprobe}")
            entries = {id(sess.cached_entry(vec_text(
                queries[i], where_of[name], name == "V_DIST"))[0])
                for i in qsets[name]}
            require(len(entries) == 1, f"{name}: {len(entries)} cached "
                    "entries for its query vectors, expected one")
            return {"nprobe": v.nprobe, "lists": v.lists,
                    "max_list": v.max_list, "est_sel": v.est_sel,
                    "ivf_cost": v.ivf_cost, "brute_cost": v.brute_cost}
        return after

    where_of = {"V_L2": "", "V_F50": "where grp < 5 ", "V_DIST": ""}
    for name, mask in (("V_L2", None), ("V_F50", f50)):
        recs.append(run_statement(
            sess, kernels, name,
            [vec_text(queries[i], where_of[name]) for i in qsets[name]],
            ann_check(name, mask), warm, ANN_N, "docs",
            after=ivf_after(name)))
        recs[-1]["recall_at_10"] = recall(sess, name, where_of[name], mask)

    def dist_check(rs):
        qi = qsets["V_DIST"][warm]
        q = queries[qi]
        ann_check("V_DIST")(rs)
        got = rs.storage_columns()
        ids = np.asarray(got["id"], dtype=np.int64)
        err = np.abs(np.asarray(got["d"], np.float64) - exact.dist(ids, q))
        tol = VEC_DIST_TOL * exact.scale(ids, q)
        require(bool(np.all(err <= tol)), f"V_DIST: distance error "
                f"{err.max()!r} beyond {VEC_DIST_TOL} x (|x|^2 + |q|^2)")
        print(f"V_DIST: distances within {VEC_DIST_TOL} x (|x|^2 + |q|^2) "
              f"of float64 (largest error {err.max():.6g}, "
              f"{(err / tol).max():.4f} of the limit)", flush=True)
        return len(ids)

    recs.append(run_statement(
        sess, kernels, "V_DIST",
        [vec_text(queries[i], dist=True) for i in qsets["V_DIST"]],
        dist_check, warm, ANN_N, "docs", after=ivf_after("V_DIST")))
    for r in recs[1:]:
        for k in ("K21_ivf_lists", "K22_ivf_probe"):
            require(r["launches"][k] == runs, f"{r['statement']}: {k} "
                    f"launched {r['launches'][k]} times in {runs} runs")

    srecs, small_x = starve_statement(Session, kernels, warm)
    recs += srecs
    launches = dict(kernels.LAUNCHES)
    for k in VECTOR_KERNELS:
        require(launches[k] > 0, f"{k} was never launched on the vector "
                "path")
    ab += [narrow_ab(sess, name, vec_text(queries[qsets[name][0]],
                                          where_of[name], name == "V_DIST"))
           for name in ("V_L2", "V_F50", "V_DIST")]
    # the arguments of this phase's build and of one V_F50 run
    xd = torch.from_numpy(x).cuda()
    cent = torch.from_numpy(idx.centroids).cuda()
    assign = kernels.kmeans_assign(xd, cent)
    cap = capture_args(sess, vec_text(queries[0], where_of["V_F50"]), {
        "K21_ivf_lists": (ex, "ivf_lists", lambda c, q, p: p),
        "K22_ivf_probe": (ex, "ivf_probe",
                          lambda x_, s_, pe, of, le, pr, *r: pr.numel())})
    args = {"K19_kmeans_assign": (xd, cent),
            "K20_kmeans_update": (xd, assign, len(idx.lengths)),
            **cap}
    del sess
    # the sharded ANN leg (late, untraced) lays this deployment across a
    # mesh: the data, the queries and the index the card built
    ann_ctx = {"x": x, "queries": queries, "idx": idx}
    return recs, build, launches, args, small_x, ab, ann_ctx


def starve_statement(Session, kernels, warm):
    """V_STARVE: the reference tests' 20,000 x 32 table with each row's
    blob, an index of 64 lists probed 2 at a time, a query near blob 0 and
    `where blob = <the farthest blob>`: the estimate (1/40) seeds nprobe
    16, the probed lists hold fewer than k live rows, the counter fires
    and the retry widens nprobe to all 64 lists; the exhaustive probe must
    equal the exact filtered top-k."""
    import numpy as np

    from oceanbase_tpu_torch.storage.vector_index import (
        register_vector_index,
    )

    x, blob, centers, _q = ann_data(SMALL_N, SMALL_D, SMALL_BLOBS,
                                    SMALL_SEED, 1)
    grp = np.arange(SMALL_N, dtype=np.int64) % 10
    cat = vec_catalog(x, {"grp": grp, "blob": blob.astype(np.int64)})
    register_vector_index(cat, "docs", "emb", lists=SMALL_LISTS, nprobe=2)
    far = int(np.argmax(((centers - centers[0]) ** 2).sum(axis=1)))
    rng = np.random.default_rng(SMALL_SEED + 1)
    qs = [centers[0] + rng.normal(size=SMALL_D).astype(np.float32) * 0.05
          for _ in range(warm + 2)]
    where = f"where blob = {far} "
    exact = ExactL2(x)
    sess = Session(cat, device="cuda")

    def check(rs):
        q = qs[warm]
        want, _d = exact.top(q, mask=blob == far)
        got = vec_ids(rs)
        margin_equal(exact, got, want, q, "V_STARVE")
        return len(got)

    def after(rs):
        prep = rs._cursor.prepared
        p = prep.params
        (v,) = p.vector_topns.values()
        require(p.ann_escalations >= 1, "V_STARVE: no over-probe escalation")
        require(v.nprobe == v.lists == SMALL_LISTS, f"V_STARVE: nprobe "
                f"{v.nprobe} of {v.lists} lists after the escalation")
        print(f"V_STARVE: registered nprobe {v.base_nprobe}, estimated "
              f"selectivity {v.est_sel:.4f}, {p.ann_escalations} "
              f"escalation(s) to nprobe {v.nprobe} = lists, "
              f"{prep.retries} retries", flush=True)
        return {"escalations": p.ann_escalations, "nprobe": v.nprobe,
                "est_sel": v.est_sel, "retries": prep.retries,
                "ann_stats": sess.executor.ann_stats[("docs", "emb")]}

    rec = run_statement(sess, kernels, "V_STARVE",
                        [vec_text(q, where) for q in qs], check, warm,
                        SMALL_N, "docs", after=after)
    return [rec], x


def vector_kernel_checks(kernels, reps, args) -> list:
    """K19-K22 on the vector phase's arguments and on a synthetic case
    (L = 8192 lists with tied centroids, one list far longer than the
    rest, dead rows), each against its plain version: K20 bit for bit
    against the plain version on the CPU; K19, K21 and K22 equal except
    where the plain version's neighbouring distances lie within
    VEC_MARGIN x (|x|^2 + |c or q|^2), and exactly on the synthetic case's
    integer-valued data (every dot product exact in float32). Two runs
    give the same bits. Timed beside the plain version, the one-call
    PyTorch yardstick and the bound. The plain versions and yardsticks
    run with torch.backends.cuda.matmul.allow_tf32 = False."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    rng = np.random.default_rng(8192)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same_twice(name, run):
        a, b = run(), run()
        for x, y in zip(a, b):
            require(torch.equal(bits(x), bits(y)),
                    f"{name}: two runs differ in their bits")

    def record(name, err, k_run, p_run, lib_run, nbytes, ops, note):
        same_twice(name, k_run)
        km = cuda_ms(k_run, reps)
        pm = cuda_ms(p_run, max(1, reps // 2))
        lm = cuda_ms(lib_run, reps)
        bm, by = bound_ms(nbytes, ops)
        src, rep = KERNEL_META[name]
        print(f"kernel {name}: {note}, two runs bit-identical, kernel_ms "
              f"{km:.6f}, plain_ms {pm:.6f}, library_ms {lm:.6f}, bound_ms "
              f"{bm:.6f} ({by})", flush=True)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "max_abs_err": err, "ms": km,
                    "plain_ms": pm, "bound_ms": bm, "bound_by": by,
                    "library_ms": lm})

    def ints(shape, lo=-3, hi=4):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(
            np.float32)).cuda()

    # the synthetic case: 8192 lists, tied centroids, one long list, and
    # dead rows
    syn_l, syn_n, syn_d = VEC_SYNTHETIC
    sx = ints((syn_n, syn_d))
    sc = ints((syn_l, syn_d))
    sc[4096:4160] = sc[17]
    sa = torch.from_numpy(np.where(rng.random(syn_n) < 0.3, 5, rng.integers(
        0, syn_l, syn_n))).cuda()
    ssel = torch.from_numpy(rng.random(syn_n) < 0.7).cuda()
    sq = ints((syn_d,))

    # K19 at the build's final centroids over the 1M rows
    x, c = args["K19_kmeans_assign"]
    got = kernels.kmeans_assign(x, c)
    d2 = -2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None, :]
    want = torch.argmin(d2, dim=1)
    two = torch.topk(d2, 2, dim=1, largest=False).values
    tol = VEC_MARGIN * (torch.sum(x * x, dim=1) + torch.sum(c * c, dim=1)[want])
    diff = got != want
    strict = diff & ((two[:, 1] - two[:, 0]) > tol)
    gap = d2.gather(1, got[:, None])[:, 0] - two[:, 0]
    require(not bool(strict.any()), f"K19: {int(strict.sum())} rows choose "
            "another centroid where the plain version's two nearest differ "
            "beyond the margin")
    require(bool((gap <= tol).all()), "K19: a chosen distance exceeds the "
            "minimum beyond the margin")
    err19 = float(gap.max())
    del d2, two
    require(torch.equal(kernels.kmeans_assign(sx, sc),
                        kernels.kmeans_assign_plain(sx, sc)),
            "K19: differs from the plain version on the synthetic case")
    n, d = int(x.shape[0]), int(x.shape[1])
    nl = int(c.shape[0])
    record("K19_kmeans_assign", err19, lambda: [kernels.kmeans_assign(x, c)],
           lambda: [kernels.kmeans_assign_plain(x, c)],
           lambda: torch.argmin(-2.0 * (x @ c.T) + torch.sum(
               c * c, dim=1)[None, :], dim=1),
           4 * n * d + 4 * nl * d + 8 * n, 2.0 * n * nl * d,
           f"{int(diff.sum())} of {n} rows on near-ties (margin rule), "
           "synthetic exact")

    # K20 at the build's arguments, bit for bit against the CPU
    x, a, nl = args["K20_kmeans_update"]
    gs, gc = kernels.kmeans_update(x, a, nl)
    ps, pc = kernels.kmeans_update_plain(x.cpu(), a.cpu(), nl)
    require(torch.equal(bits(gs.cpu()), bits(ps)) and torch.equal(
        gc.cpu(), pc), "K20: differs from the plain version on the CPU "
        "(row-order float32 sums)")
    ss, scn = kernels.kmeans_update(sx, sa, syn_l)
    ps2, pc2 = kernels.kmeans_update_plain(sx.cpu(), sa.cpu(), syn_l)
    require(torch.equal(bits(ss.cpu()), bits(ps2)) and torch.equal(
        scn.cpu(), pc2), "K20: differs from the plain version on the "
        "synthetic case")
    longest = int(torch.bincount(a, minlength=nl).max())
    record("K20_kmeans_update", 0.0,
           lambda: list(kernels.kmeans_update(x, a, nl)),
           lambda: list(kernels.kmeans_update_plain(x, a, nl)),
           lambda: torch.zeros((nl, d), device=x.device).index_add_(
               0, a, x),
           4 * n * d + 8 * n + 4 * nl * d + 4 * nl, float(n * d),
           f"bit for bit against the CPU (largest list {longest} rows, "
           f"mean {n / nl:.1f})")

    # K21 at one V_F50 run's arguments
    cent, q, nprobe = args["K21_ivf_lists"]
    got = kernels.ivf_lists(cent, q, nprobe)
    want = kernels.ivf_lists_plain(cent, q, nprobe)
    cd = torch.sum(cent * cent, dim=1) - 2.0 * (cent @ q)
    scale = torch.sum(cent * cent, dim=1) + torch.dot(q, q)
    err21 = 0.0
    for r in torch.nonzero(got != want).flatten().tolist():
        g, w = int(got[r]), int(want[r])
        e = abs(float(cd[g]) - float(cd[w]))
        require(e <= VEC_MARGIN * float(max(scale[g], scale[w])),
                f"K21: rank {r} holds list {g} where the plain version has "
                f"{w}, beyond the margin")
        err21 = max(err21, e)
    for p in (100, syn_l):
        require(torch.equal(kernels.ivf_lists(sc, sq, p),
                            kernels.ivf_lists_plain(sc, sq, p)),
                f"K21: differs from the plain version on the synthetic case "
                f"(nprobe {p})")
    nl = int(cent.shape[0])
    record("K21_ivf_lists", err21, lambda: [kernels.ivf_lists(cent, q,
                                                               nprobe)],
           lambda: [kernels.ivf_lists_plain(cent, q, nprobe)],
           lambda: torch.topk(-(torch.sum(cent * cent, dim=1)
                                - 2.0 * (cent @ q)), nprobe),
           4 * nl * d + 4 * d + 4 * nprobe, 4.0 * nl * d,
           f"{int((got != want).sum())} of {nprobe} ranks on near-ties "
           "(margin rule), synthetic exact at nprobe 100 and 8192")

    # K22 at one V_F50 run's arguments
    (x, sel, perm, offs, lens, probes, q, max_list, nrows, k) = args[
        "K22_ivf_probe"]
    got = kernels.ivf_probe(x, sel, perm, offs, lens, probes, q, max_list,
                            nrows, k)
    want = kernels.ivf_probe_plain(x, sel, perm, offs, lens, probes, q,
                                   max_list, nrows, k)
    require(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
            "K22: sel or the starvation count differs from the plain "
            "version")
    rows_g, rows_w = got[0].long(), want[0].long()
    dg = torch.sum(x[rows_g] * x[rows_g], 1) - 2.0 * (x[rows_g] @ q)
    dw = torch.sum(x[rows_w] * x[rows_w], 1) - 2.0 * (x[rows_w] @ q)
    sc22 = torch.sum(x[rows_w] * x[rows_w], 1) + torch.dot(q, q)
    bad = (rows_g != rows_w) & ((dg - dw).abs() > VEC_MARGIN * sc22)
    require(not bool(bad.any()), "K22: a winner differs from the plain "
            "version's beyond the margin")
    err22 = float((dg - dw).abs().max()) if len(dg) else 0.0
    cand_rows, wv = kernels._probe_windows(perm, offs, lens, probes,
                                           max_list, nrows)
    live = wv & sel[cand_rows.long()]
    nlive = int(live.sum())
    # the synthetic probe: 300 of 8192 lists, the long list among them,
    # dead rows, a k above the live rows of some windows
    sperm = torch.sort(sa, stable=True).indices.to(torch.int32)
    slen = torch.bincount(sa, minlength=syn_l).to(torch.int32)
    soff = (torch.cumsum(slen, 0) - slen).to(torch.int32)
    sprobe = kernels.ivf_lists(sc, sq, 300)
    sprobe[0] = 5
    for kk in (10, 2048):
        sargs = (sx, ssel, sperm, soff, slen, sprobe, sq,
                 int(slen.max()), syn_n, kk)
        g, w = kernels.ivf_probe(*sargs), kernels.ivf_probe_plain(*sargs)
        require(all(torch.equal(a_, b_) for a_, b_ in zip(g, w)),
                f"K22: differs from the plain version on the synthetic "
                f"case (k {kk})")

    def k22_library():
        xv = x.index_select(0, cand_rows.long())
        dist = torch.sum(xv * xv, dim=1) - 2.0 * (xv @ q)
        dist = torch.where(live, dist, torch.full_like(dist, float("inf")))
        return torch.topk(-dist, min(k, int(dist.shape[0])))

    cand = int(cand_rows.numel())
    record("K22_ivf_probe", err22,
           lambda: list(kernels.ivf_probe(x, sel, perm, offs, lens, probes,
                                          q, max_list, nrows, k)),
           lambda: list(kernels.ivf_probe_plain(x, sel, perm, offs, lens,
                                                probes, q, max_list, nrows,
                                                k)),
           k22_library,
           cand * (4 + 1) + nlive * 4 * d + 12 * int(probes.numel())
           + 4 * d + 5 * k + 8, 4.0 * nlive * d,
           f"{cand} candidates ({nlive} live), "
           f"{int((rows_g != rows_w).sum())} of {len(rows_g)} ranks on "
           "near-ties (margin rule), sel and the counter exact, synthetic "
           "exact at k 10 and 2048")
    return out


def vector_card_vs_cpu(Session, kernels, x) -> dict:
    """At the reference tests' shape (20,000 x 32, 40 blobs, lists 64,
    nprobe 8): the CPU's index carried onto the card (ivf_from_arrays +
    install_ivf), the V_L2 and V_F50 statements equal on both (the margin
    rule against exact distances), and the card's own build equal to the
    CPU's perm and lengths."""
    import numpy as np

    from oceanbase_tpu_torch.storage.vector_index import (
        ivf_from_arrays,
        register_vector_index,
    )

    grp = np.arange(SMALL_N, dtype=np.int64) % 10
    exact = ExactL2(x)

    def fresh():
        cat = vec_catalog(x, {"grp": grp})
        register_vector_index(cat, "docs", "emb", lists=SMALL_LISTS,
                              nprobe=SMALL_NPROBE)
        return cat

    cpu = Session(fresh(), device="cpu")
    cidx = cpu.executor.ivf_host("docs", "emb")
    card = Session(fresh(), device="cuda")
    card.executor.install_ivf("docs", "emb", ivf_from_arrays(
        cidx.centroids, cidx.perm, cidx.offsets, cidx.lengths))
    rng = np.random.default_rng(SMALL_SEED + 2)
    swaps = stmts = ivf = 0
    for _ in range(5):
        q = x[rng.integers(0, SMALL_N)] + rng.normal(
            size=SMALL_D).astype(np.float32) * 0.05
        for where in ("", "where grp < 5 "):
            text = vec_text(q, where)
            crs, prs = card.sql(text), cpu.sql(text)
            routes = [bool(rs._cursor.prepared.params.vector_topns)
                      for rs in (crs, prs)]
            require(routes[0] == routes[1], f"card vs CPU vectors: routes "
                    f"{routes} ({where or 'all'})")
            ivf += routes[0]
            swaps += margin_equal(exact, vec_ids(crs), vec_ids(prs), q,
                                  f"card vs CPU vectors ({where or 'all'})")
            stmts += 1
    # K22 past its old cap of k = 2048: LIMIT 4096 on the carried index,
    # the card's ids equal the CPU's (the margin rule)
    import oceanbase_tpu_torch.engine.executor as ex

    widths = []
    orig_probe = ex.ivf_probe

    def probe_width(*a, **kw):
        widths.append(min(int(a[-1]), int(a[5].numel()) * int(a[7])))
        return orig_probe(*a, **kw)

    q = x[rng.integers(0, SMALL_N)]
    text = vec_text(q, k=K22_BIG_K)
    ex.ivf_probe = probe_width
    try:
        crs = card.sql(text)
    finally:
        ex.ivf_probe = orig_probe
    prs = cpu.sql(text)
    require(widths and min(widths) > 2048, f"LIMIT {K22_BIG_K}: K22 "
            f"selected {widths} rows, not past its old cap of 2048")
    big_swaps = margin_equal(exact, vec_ids(crs), vec_ids(prs), q,
                             f"card vs CPU LIMIT {K22_BIG_K}")
    print(f"card vs CPU vectors: LIMIT {K22_BIG_K} through K22 at k' "
          f"{widths[0]} (old cap 2048) equal ({big_swaps} margin swaps)",
          flush=True)
    require(not card.executor.ann_builds, "the card built its own index "
            "instead of serving the carried one")
    own = Session(fresh(), device="cuda")
    k0 = dict(kernels.LAUNCHES)
    oidx = own.executor.ivf_host("docs", "emb")
    same_perm = np.array_equal(oidx.perm, cidx.perm)
    same_len = np.array_equal(oidx.lengths, cidx.lengths)
    if not (same_perm and same_len):
        moved = int(np.sum(oidx.perm != cidx.perm))
        print(f"card vs CPU build: perm differs at {moved} places, lengths "
              f"{'equal' if same_len else 'differ'}; iterations card "
              f"{oidx.iterations} cpu {cidx.iterations}", flush=True)
    require(same_perm and same_len, "card vs CPU build: the card's perm "
            "and lengths differ from the CPU's (an argmin near-tie)")
    same_cent = np.array_equal(oidx.centroids.view(np.int32),
                               cidx.centroids.view(np.int32))
    require(ivf > 0, "card vs CPU vectors: no statement took the IVF route")
    print(f"card vs CPU vectors: {stmts} statements (V_L2, V_F50 texts; "
          f"{ivf} on the IVF route) equal on a carried index ({swaps} "
          f"margin swaps); the card's own "
          f"build equals the CPU's perm and lengths ({oidx.iterations} "
          f"iterations, K19 {kernels.LAUNCHES['K19_kmeans_assign'] - k0['K19_kmeans_assign']} "
          f"launches), centroid bits {'equal' if same_cent else 'differ'}",
          flush=True)
    return {"statements": stmts, "ivf_route": ivf, "swaps": swaps,
            "k22_big_k": {"k": K22_BIG_K, "k_selected": widths[0],
                          "swaps": big_swaps},
            "build_perm_equal": True,
            "build_lengths_equal": True, "centroid_bits_equal": same_cent,
            "iterations": oidx.iterations}



# ---- the spill operators (ops/spill.py) on K3, K29, K14 and K30 --------
# End to end on the SF 10 tables, cut only because the host merge and
# partitioning are Python and numpy: a group-by and a join over the first
# 2^23 lineitem rows (8 hash partitions, the join against all of part),
# and an external sort of the first 2^21 rows in runs of 2^19.
SPILL_GROUP_ROWS = 1 << 23
SPILL_SORT_ROWS = 1 << 21
SPILL_SORT_CHUNK = 1 << 19
SPILL_PARTS = 8
# K29's float sums add in any order (atomics): held to the plain
# version's within this relative tolerance (sums of at most a few hundred
# positive terms differ by a few ulps)
K29_FLOAT_RTOL = 1e-12


class _Stored:
    """A result's storage columns in the shape the oracle checks read."""

    def __init__(self, cols: dict):
        self.cols = cols

    def storage_columns(self) -> dict:
        return self.cols


def _partition_rows(key, part: int, n_parts: int):
    """The rows of one hash partition, as ops/spill.py _partition cuts."""
    import numpy as np

    h = (key.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) \
        >> np.uint64(33)
    return np.flatnonzero((h % np.uint64(n_parts)) == np.uint64(part))


def spill_phase(tables, kernels, dev) -> tuple:
    """partitioned_groupby_sum, partitioned_join_sum and external_sort
    end to end on the card, each against numpy (bincount, direct
    indexing, lexsort) with every spill segment freed; the device steps'
    time (synchronized) split from the host's. Its own launch counts."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.ops import spill
    from oceanbase_tpu_torch.storage.tmp_file import TmpFileManager

    li, part = tables["lineitem"], tables["part"]
    n = min(SPILL_GROUP_ROWS, li.nrows)
    key = np.asarray(li.data["l_partkey"][:n], np.int64)
    qty = np.asarray(li.data["l_quantity"][:n], np.int64)
    rkey = np.asarray(part.data["p_partkey"], np.int64)
    rval = np.asarray(part.data["p_size"], np.int64)
    ns = min(SPILL_SORT_ROWS, li.nrows)
    ship = np.asarray(li.data["l_shipdate"][:ns], np.int64)
    okey = np.asarray(li.data["l_orderkey"][:ns], np.int64)
    price = np.asarray(li.data["l_extendedprice"][:ns])

    steps = ("_device_sort_chunk", "_device_groupby_sum", "_device_join_sum")
    orig = {f: getattr(spill, f) for f in steps}
    dev_s = [0.0]

    def timed_step(fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            dev_s[0] += time.perf_counter() - t0
            return out
        return run

    def groupby(tmp):
        return spill.partitioned_groupby_sum(key, qty, SPILL_PARTS, tmp,
                                             device=dev)

    def groupby_check(res):
        ks, ss, cs = res
        uk, inv = np.unique(key, return_inverse=True)
        o = np.argsort(ks)
        require(np.array_equal(ks[o], uk), "SPILL_GROUPBY: keys differ")
        want_s = np.bincount(inv, weights=qty).astype(np.int64)
        require(np.array_equal(ss[o], want_s), "SPILL_GROUPBY: sums differ")
        require(np.array_equal(cs[o], np.bincount(inv)),
                "SPILL_GROUPBY: counts differ")
        return {"rows": n, "groups": int(len(uk))}

    def join(tmp):
        return spill.partitioned_join_sum(key, qty, rkey, rval, SPILL_PARTS,
                                          tmp, device=dev)

    def join_check(res):
        pos = np.full(int(rkey.max()) + 1, -1, np.int64)
        pos[rkey] = np.arange(len(rkey))
        m = np.where(key <= rkey.max(), pos[np.minimum(key, rkey.max())], -1)
        hit = m >= 0
        want = (int(np.sum(qty[hit] * rval[m[hit]])), int(hit.sum()))
        require(tuple(res) == want, f"SPILL_JOIN: {res} vs numpy {want}")
        return {"rows": n, "build_rows": int(len(rkey)), "matches": want[1]}

    skey = spill.pack_sort_key([ship, okey], [False, True])

    def sort(tmp):
        return spill.external_sort({"p": price}, skey, SPILL_SORT_CHUNK, tmp,
                                   device=dev)

    def sort_check(res):
        order = np.lexsort((-okey, ship))
        require(np.array_equal(res["__key__"], skey[order]),
                "SPILL_SORT: keys out of order")
        require(np.array_equal(res["p"], price[order]),
                "SPILL_SORT: payload differs from numpy's lexsort")
        return {"rows": ns, "key_bits": int(skey.max()).bit_length(),
                "runs": -(-ns // SPILL_SORT_CHUNK)}

    kernels.reset_launches()
    recs = []
    try:
        for f in steps:
            setattr(spill, f, timed_step(orig[f]))
        for name, fn, check in (("SPILL_GROUPBY", groupby, groupby_check),
                                ("SPILL_JOIN", join, join_check),
                                ("SPILL_SORT", sort, sort_check)):
            dev_s[0] = 0.0
            with TmpFileManager() as tmp:
                t0 = time.perf_counter()
                res = fn(tmp)
                wall = time.perf_counter() - t0
                left = tmp.bytes_used
            require(left == 0, f"{name}: {left} spill bytes left")
            info = check(res)
            rec = {"statement": name, "wall_s": wall, "device_s": dev_s[0],
                   "host_s": wall - dev_s[0], **info}
            recs.append(rec)
            print(f"{name}: {info}, wall {wall:.3f} s (device steps "
                  f"{dev_s[0]:.3f} s, host {wall - dev_s[0]:.3f} s), equal "
                  f"to numpy, every segment freed", flush=True)
    finally:
        for f in steps:
            setattr(spill, f, orig[f])
    launches = dict(kernels.LAUNCHES)
    for k in ("K3_radix_sort", "K14_hash_set", *SPILL_KERNELS):
        require(launches[k] > 0, f"spill phase: {k} never launched")
    print("spill phase: launches " + ", ".join(
        f"{k} {launches[k]}" for k in ("K3_radix_sort", "K14_hash_set",
                                       *SPILL_KERNELS)), flush=True)
    return recs, launches


def _group_set(res):
    """{key tuple: aggregates} of a hash group-by's used slots."""
    import numpy as np

    _rs, _sr, used, keys, aggs = res
    u = used.cpu().numpy()
    ks = [k.cpu().numpy()[u] for k in keys]
    ag = [a.cpu().numpy()[u] for a in aggs]
    return {tuple(k[i].item() for k in ks): tuple(a[i].item() for a in ag)
            for i in range(int(u.sum()))}, int(np.count_nonzero(u))


def spill_kernel_checks(tables, kernels, reps: int, dev) -> list:
    """The spill's device steps alone at deployment size, each against
    its plain version on the card and timed beside it, a PyTorch
    yardstick and its bound: K3 over one 2^23-row chunk of packed uint64
    keys (their int64 image), K29 over one hash partition of all
    lineitem (l_partkey, ~250,000 groups) and a two-column group-by with
    sum/count/min/max on int64 and float64, K14 + K30 over one partition
    pair (lineitem against part)."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.ops import spill
    from oceanbase_tpu_torch.ops.hashing import next_pow2

    li, part = tables["lineitem"], tables["part"]
    out = []

    def record(name, km, pm, lm, nbytes, ops, err=0.0):
        bm, by = bound_ms(nbytes, ops)
        src, rep = KERNEL_META[name]
        print(f"kernel {name}: kernel_ms {km:.6f}, plain_ms {pm:.6f}, "
              f"library_ms {lm}, bound_ms {bm:.6f} ({by}), max_abs_err "
              f"{err}", flush=True)
        return {"name": name, "route": "cuda", "source": src,
                "replaces": rep, "max_abs_err": err, "ms": km,
                "plain_ms": pm, "bound_ms": bm, "bound_by": by,
                "library_ms": lm}

    # K3 over one chunk of the spill sort's packed keys
    n3 = min(SPILL_GROUP_ROWS, li.nrows)
    pk = spill.pack_sort_key(
        [np.asarray(li.data["l_shipdate"][:n3], np.int64),
         np.asarray(li.data["l_orderkey"][:n3], np.int64)], [False, True])
    img = torch.from_numpy(spill.sort_image(pk)).to(dev)
    live3 = torch.ones(n3, dtype=torch.bool, device=dev)
    got = kernels.sort_order([img], [False], live3)
    want = kernels.sort_order_plain([img], [False], live3)
    require(torch.equal(got, want), "K3 on the uint64 image differs")
    require(torch.equal(got, kernels.sort_order([img], [False], live3)),
            "K3 on the uint64 image: two runs differ")
    require(np.array_equal(got.cpu().numpy(), np.argsort(pk, kind="stable")),
            "K3 on the uint64 image differs from numpy's unsigned order")
    out.append(record(
        "K3_radix_sort.spill",
        cuda_ms(lambda: kernels.sort_order([img], [False], live3), reps),
        cuda_ms(lambda: kernels.sort_order_plain([img], [False], live3),
                max(1, reps // 2)),
        cuda_ms(lambda: torch.argsort(img, stable=True), reps),
        n3 * (8 + 1 + 4), 0))
    del img, live3, got, want

    # K29 over one hash partition of every lineitem row
    lk_all = np.asarray(li.data["l_partkey"], np.int64)
    rows = _partition_rows(lk_all, 0, SPILL_PARTS)
    key = torch.from_numpy(lk_all[rows]).to(dev)
    qty = torch.from_numpy(
        np.asarray(li.data["l_quantity"], np.int64)[rows]).to(dev)
    n = int(rows.shape[0])
    ndv = int(torch.unique(key).numel())
    ts = next_pow2(max(2 * ndv, 16))
    live = torch.ones(n, dtype=torch.bool, device=dev)
    aggs = [("sum", qty), ("count", None)]

    def k29():
        return kernels.hash_groupby([key], live, aggs, ts)

    def k29_plain():
        return kernels.hash_groupby_plain([key], live, aggs, ts)

    g1, u1 = _group_set(k29())
    g2, u2 = _group_set(k29())
    gp, up = _group_set(k29_plain())
    require(g1 == gp and u1 == up == ndv,
            f"K29: {u1} used slots and {up} plain for {ndv} groups, or "
            "their aggregates differ")
    require(g2 == g1, "K29: two runs hold different groups")

    def k29_library():
        uniq, inv = torch.unique(key, return_inverse=True)
        s = torch.zeros(uniq.numel(), dtype=torch.int64, device=dev)
        c = torch.zeros(uniq.numel(), dtype=torch.int64, device=dev)
        s.index_add_(0, inv, qty)
        c.index_add_(0, inv, torch.ones_like(qty))
        return uniq, s, c

    # two key columns, sum/count/min/max on int64 and float64 values
    flag = torch.from_numpy(
        np.asarray(li.data["l_returnflag"])[rows]).to(dev).contiguous()
    price = torch.from_numpy(
        np.asarray(li.data["l_extendedprice"])[rows].astype(np.float64)
        / 100.0).to(dev)
    ops2 = [("count", None), ("sum", qty), ("min", qty), ("max", qty),
            ("sum", price), ("min", price), ("max", price)]
    ts2 = next_pow2(2 * 3 * ndv)
    g3, u3 = _group_set(kernels.hash_groupby([key, flag], live, ops2, ts2))
    g4, u4 = _group_set(kernels.hash_groupby_plain([key, flag], live, ops2,
                                                   ts2))
    require(u3 == u4 and set(g3) == set(g4),
            f"K29 two columns: {u3} vs {u4} groups")
    err = 0.0
    for k, w in g4.items():
        g = g3[k]
        for j, (a, b) in enumerate(zip(g, w)):
            if j == 4:
                err = max(err, abs(a - b))
                require(abs(a - b) <= K29_FLOAT_RTOL * abs(b),
                        f"K29 float sum of {k}: {a} vs {b}")
            else:
                require(a == b, f"K29 aggregate {j} of {k}: {a} vs {b}")
    # K29's aggregate-only entry (ops/hashagg.py _apply_agg) over the
    # card's own slots: live rows moved to slot -1 (they land in slot
    # T - 1, as JAX's scatter wraps), dead rows, min/max on narrow ints,
    # sums of int8 and float64 values
    row_slot = k29()[0].clone()
    row_slot[::97] = -1
    live_a = live.clone()
    live_a[5::89] = False
    q8 = (qty % 100 - 50).to(torch.int8)
    q16 = (qty * 37 - 900).to(torch.int16)
    q32 = (qty * -1000).to(torch.int32)
    ops_a = [("count", None), ("sum", q8), ("min", q8), ("max", q8),
             ("min", q16), ("max", q16), ("min", q32), ("max", q32),
             ("sum", price), ("min", price)]
    got_a = kernels.slot_aggregate(row_slot, live_a, ops_a, ts)
    want_a = kernels.slot_aggregate_plain(row_slot, live_a, ops_a, ts)
    err_a = 0.0
    for (op, v), a, b in zip(ops_a, got_a, want_a):
        what = f"K29 slot_aggregate {op} of {v.dtype if v is not None else ''}"
        require(a.dtype == b.dtype and a.shape == b.shape,
                f"{what}: {a.dtype} {tuple(a.shape)} vs plain {b.dtype} "
                f"{tuple(b.shape)}")
        if op == "sum" and a.dtype.is_floating_point:
            err_a = max(err_a, float((a - b).abs().max()))
            require(bool(((a - b).abs()
                          <= K29_FLOAT_RTOL * b.abs()).all()),
                    f"{what}: float sums beyond {K29_FLOAT_RTOL}")
        else:
            require(torch.equal(a, b), f"{what}: differs from plain")
    print(f"K29 slot_aggregate: {len(ops_a)} aggregates over {n} rows "
          f"({int((row_slot < 0).sum())} at slot -1, "
          f"{int((~live_a).sum())} dead) equal to the plain version, "
          f"float sums within {K29_FLOAT_RTOL} (max abs err {err_a})",
          flush=True)
    del row_slot, live_a, q8, q16, q32, got_a, want_a

    print(f"K29: {ndv} groups of {n} rows (ts {ts}) equal to the plain "
          f"version's as sets, twice; two columns {u3} groups, integer "
          f"aggregates and float min/max exact, float sums within "
          f"{K29_FLOAT_RTOL} (max abs err {err})", flush=True)
    out.append(record(
        "K29_hash_groupby", cuda_ms(k29, reps),
        cuda_ms(k29_plain, max(1, reps // 5)), cuda_ms(k29_library, reps),
        n * (8 + 8 + 1 + 4) + ts * (4 + 1 + 8 + 8 + 8), 0, err))
    del g1, g2, gp, g3, g4, flag, price

    # K14 + K30 over the same partition pair (lineitem against part)
    pkey_all = np.asarray(part.data["p_partkey"], np.int64)
    prow = _partition_rows(pkey_all, 0, SPILL_PARTS)
    rk = torch.from_numpy(pkey_all[prow]).to(dev)
    rv = torch.from_numpy(
        np.asarray(part.data["p_size"], np.int64)[prow]).to(dev)
    nb = int(prow.shape[0])
    ts3 = next_pow2(max(2 * nb, 16))
    rsel = torch.ones(nb, dtype=torch.bool, device=dev)

    def k14():
        tag, slot = kernels.hash_set_build([rk], rsel, ts3)
        return kernels.hash_set_probe(tag, slot, [rk], [key], live)

    def k14_plain():
        tag, slot = kernels.hash_set_build_plain([rk], rsel, ts3)
        return kernels.hash_set_probe_plain(tag, slot, [rk], [key], live)

    match = k14()
    require(torch.equal(match, k14_plain()) and torch.equal(match, k14()),
            "K14 on the spill's partition pair differs from its plain "
            "version")
    out.append(record(
        "K14_hash_set.spill", cuda_ms(k14, reps),
        cuda_ms(k14_plain, max(1, reps // 5)), None,
        nb * (8 + 1) + n * (8 + 1 + 4), 0))
    got = kernels.join_product_sum(qty, rv, match)
    want = kernels.join_product_sum_plain(qty, rv, match)
    require([int(x) for x in got] == [int(x) for x in want]
            and int(got[1]) > 0, f"K30: {got} vs plain {want}")
    # products that wrap: int64 values near 2^62
    rng = np.random.default_rng(30)
    big_l = torch.from_numpy(rng.integers(-(2**40), 2**40, n)).to(dev)
    big_r = torch.from_numpy(rng.integers(2**40, 2**62, nb)).to(dev)
    got_w = kernels.join_product_sum(big_l, big_r, match)
    want_w = kernels.join_product_sum_plain(big_l, big_r, match)
    require([int(x) for x in got_w] == [int(x) for x in want_w],
            f"K30 wrapping: {got_w} vs plain {want_w}")
    hit = match >= 0
    idx = match.to(torch.int64).clamp(min=0)

    def k30_library():
        p = qty * rv.index_select(0, idx)
        return torch.where(hit, p, 0).sum(), hit.sum()

    print(f"K14 + K30: {n} probe rows against {nb} build rows, "
          f"{int(got[1])} matches, exact (and the wrapping case)",
          flush=True)
    out.append(record(
        "K30_join_product_sum",
        cuda_ms(lambda: kernels.join_product_sum(qty, rv, match), reps),
        cuda_ms(lambda: kernels.join_product_sum_plain(qty, rv, match),
                reps),
        cuda_ms(k30_library, reps),
        n * (8 + 4) + sector_bytes(match[hit], 8) + 16, 2 * n))
    return out


# ---- out-of-core PX (the PX chunk source, decode_chunk on K18) ----------
# Leg 1: DbSession.sql at ob_px_dop = 1 (the card's one shard) over the
# streamed phase's budget; leg 2: PreparedPlan.run on 4 shards of the card
# at 1/4 of that budget a shard (the port's budget is per device: 4 x
# 1/4 on the one card); then the wide leg: 40 bigint columns (40 planes,
# more than one K18 launch takes) streamed on one device and on PX.
PXS_STMTS = (1, 6, 3)
PXS_MESH_STMTS = (1, 6)
PXS_WARM = 2
STREAM_WIDE_COLS = 40
STREAM_WIDE_ROWS = 1 << 22
STREAM_WIDE_BUDGET = 256 << 20
STREAM_WIDE_TEXT = "select " + ", ".join(
    f"sum(c{i:02d}) as s{i:02d}"
    for i in range(STREAM_WIDE_COLS)) + " from wide40"


def _wide_table(seed: int):
    import numpy as np

    from oceanbase_tpu_torch.core.dtypes import DataType, Schema
    from oceanbase_tpu_torch.core.table import Table

    rng = np.random.default_rng(seed)
    names = [f"c{i:02d}" for i in range(STREAM_WIDE_COLS)]
    data = {c: rng.integers(0, 1000, STREAM_WIDE_ROWS) + 1000 * i
            for i, c in enumerate(names)}
    t = Table.from_pydict("wide40", Schema.of(
        **{c: DataType.int64() for c in names}), data)
    want = {f"s{i:02d}": np.asarray([int(data[c].sum())])
            for i, c in enumerate(names)}
    return {"wide40": t}, want


def px_stream_phase(tables, uk, kernels, queries_text, oracles, resident,
                    budget: int, seed: int, dev):
    """Out-of-core PX: leg 1, leg 2 and the wide leg (above). Every run:
    a ChunkedPreparedPlan on the PX chunk source, rows bit-identical to
    the single-device streamed runs and held to the int64 oracles, `px
    dtl host hops` equal to the chunks dispatched, K18 launched, no `px
    fallbacks`, the governor's ledger balanced. Returns (records, the
    launches of the PX runs alone, the largest K18 call of each leg's PX
    runs, kept for the checks)."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.core.column import batch_rows_storage
    from oceanbase_tpu_torch.engine.chunked import ChunkedPreparedPlan
    from oceanbase_tpu_torch.engine.executor import Executor
    from oceanbase_tpu_torch.engine.memory_governor import MemoryGovernor
    from oceanbase_tpu_torch.engine.session import Session
    from oceanbase_tpu_torch.parallel.mesh import make_mesh
    from oceanbase_tpu_torch.parallel.px import (
        PxExecutor,
        _PxChunkSourceExecutor,
    )
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.share.metrics import MetricsRegistry
    from oceanbase_tpu_torch.sql.parser import parse
    from oceanbase_tpu_torch.sql.planner import Planner

    # K18 calls are kept, and launches counted, only inside the PX runs
    # (run_counted): the single-device reference runs between them stream
    # through the same wrapper
    captured: dict = {}
    px_counts: dict = {}
    active = {"tag": None}
    lock = threading.Lock()
    orig_decode = kernels.decode_staged

    def capturing(staged, bases, count, meta, cap, dtypes, device):
        tag = active["tag"]
        if tag is not None:
            with lock:
                size = len(meta) * int(cap)
                if tag not in captured or size > captured[tag][0]:
                    captured[tag] = (size, (staged, bases, count, meta, cap,
                                            dtypes, device))
        return orig_decode(staged, bases, count, meta, cap, dtypes, device)

    def streamed_px(name, prep):
        require(isinstance(prep, ChunkedPreparedPlan)
                and isinstance(prep.chunk_exec, _PxChunkSourceExecutor),
                f"{name}: prepared {type(prep).__name__} "
                f"({type(getattr(prep, 'chunk_exec', None)).__name__}), "
                "not streamed on the PX chunk source")

    def run_counted(name, tag, fn, prep_of, metrics, gov):
        """One PX run, its K18 calls kept under `tag` and its launches
        added to the phase's counts: (result, wall ms, chunks, host hops,
        K18 launches)."""
        h0 = metrics.counter("px dtl host hops")
        l0 = dict(kernels.LAUNCHES)
        active["tag"] = tag
        t0 = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            active["tag"] = None
        wall = (time.perf_counter() - t0) * 1e3
        for k, v in kernels.LAUNCHES.items():
            px_counts[k] = px_counts.get(k, 0) + v - l0.get(k, 0)
        k18 = kernels.LAUNCHES["K18_decode_staged"] - l0["K18_decode_staged"]
        prep = prep_of(res)
        streamed_px(name, prep)
        c0 = getattr(prep, "_smoke_chunks", 0)
        chunks = prep.stream_stats.chunks - c0
        prep._smoke_chunks = prep.stream_stats.chunks
        hops = metrics.counter("px dtl host hops") - h0
        require(hops == chunks and chunks > 0,
                f"{name}: {hops} host hops for {chunks} chunks")
        require(k18 >= chunks, f"{name}: {k18} K18 launches, {chunks} chunks")
        require(gov.ledger_balanced(), f"{name}: the ledger is not balanced")
        return res, wall, chunks, hops, k18

    def leg_record(name, walls, chunks, hops, k18, n, extra=None):
        rec = {"statement": name, "rows": n, "cold_ms": walls[0],
               "warm_ms": walls[1:],
               "warm_median_ms": statistics.median(walls[1:]),
               "chunks_per_run": chunks, "host_hops_per_run": hops,
               "k18_launches_per_run": k18, **(extra or {})}
        print(f"{name}: streamed on the PX chunk source, {n} rows "
              f"bit-identical to the single-device streamed run and the "
              f"oracle, cold {walls[0]:.3f} ms warm "
              f"{rec['warm_median_ms']:.3f} ms, {chunks} chunks = {hops} "
              f"host hops, {k18} K18 launches a run", flush=True)
        return rec

    kernels.reset_launches()
    recs = []
    # leg 1: the server at dop 1
    db = Database(n_nodes=1, n_ls=1, extra_catalog=tables, device=dev)
    try:
        db._unique_keys.update(uk)
        db.engine.executor.unique_keys = db._unique_keys
        db.engine.planner.unique_keys = db._unique_keys
        s = db.session()
        s.sql("set ob_enable_result_cache = 0")
        s.sql("set ob_px_dop = 1")
        px = db._px_executor()
        px.device_budget = budget
        fb0 = db.metrics.counter("px fallbacks")
        kernels.decode_staged = capturing
        for q in PXS_STMTS:
            name = f"PXS_Q{q}"
            walls, last = [], None
            for _ in range(1 + PXS_WARM):
                rs, wall, chunks, hops, k18 = run_counted(
                    name, "leg1", lambda: s.sql(queries_text[q]),
                    lambda rs: rs._cursor.prepared, db.metrics, db.governor)
                walls.append(wall)
                require(same_bits(rs.storage_columns(),
                                  resident[f"ST_Q{q}"]),
                        f"{name}: rows differ from the streamed rows")
                last = rs
            n = oracles[f"ST_Q{q}"](last)
            recs.append(leg_record(name, walls, chunks, hops, k18, n))
        fallbacks = db.metrics.counter("px fallbacks") - fb0
        require(fallbacks == 0, f"PX streamed leg 1: {fallbacks} fallbacks")
        require(db._px_admission().used == 0,
                "PX streamed leg 1: admission not released")
    finally:
        kernels.decode_staged = orig_decode
        db.close()
    del db, s, px
    release_device()

    # leg 2: 4 shards of the card
    mesh = make_mesh(PX_MESH_SHARDS, devices=[dev] * PX_MESH_SHARDS)
    m = MetricsRegistry()
    gov = MemoryGovernor(budget=budget)
    px2 = PxExecutor(tables, mesh, unique_keys=uk, device_budget=budget,
                     metrics=m)
    px2.governor = gov
    gov.register_sharded_residency(px2.residency.per_device_bytes)
    single = Executor(tables, unique_keys=uk, device=dev,
                      device_budget=budget)
    single.governor = MemoryGovernor(budget=budget)
    planner = Planner(tables)
    try:
        kernels.decode_staged = capturing
        for q in PXS_MESH_STMTS:
            name = f"PX4S_Q{q}"
            plan = planner.plan(parse(queries_text[q]))
            names = list(plan.output_names)
            sprep = single.prepare(plan.plan)
            require(isinstance(sprep, ChunkedPreparedPlan),
                    f"{name}: the single device did not stream")
            want = batch_rows_storage(sprep.run(), names)
            prepared = px2.prepare(plan.plan)
            walls = []
            for _ in range(1 + PXS_WARM):
                outb, wall, chunks, hops, k18 = run_counted(
                    name, "leg2", prepared.run, lambda _o: prepared, m, gov)
                walls.append(wall)
                got = batch_rows_storage(outb, names)
                require(same_bits(got, want),
                        f"{name}: rows differ from the single device's "
                        "streamed run")
            n = oracles[f"ST_Q{q}"](_Stored(got))
            recs.append(leg_record(name, walls, chunks, hops, k18, n, {
                "shards": PX_MESH_SHARDS, "chunk_rows": prepared.chunk_rows,
                "chunk_capacity": prepared.chunk_exec.chunk_rows}))
            del sprep, prepared, outb
    finally:
        kernels.decode_staged = orig_decode
    del px2, single
    release_device()

    # the wide leg: 40 planes on one device (run_stream) and on PX
    wt, wwant = _wide_table(seed)
    wplan = Planner(wt).plan(parse(STREAM_WIDE_TEXT))
    wnames = list(wplan.output_names)
    wsess = Session(wt, device=dev)
    wsess.executor.device_budget = STREAM_WIDE_BUDGET
    wgov = MemoryGovernor(budget=STREAM_WIDE_BUDGET)
    wsess.executor.governor = wgov
    k0 = kernels.LAUNCHES["K18_decode_staged"]
    t0 = time.perf_counter()
    rs = wsess.sql(STREAM_WIDE_TEXT)
    wall1 = (time.perf_counter() - t0) * 1e3
    prep = rs._cursor.prepared
    require(isinstance(prep, ChunkedPreparedPlan),
            "WIDE: the single device did not stream")
    k18_1 = kernels.LAUNCHES["K18_decode_staged"] - k0
    chunks1 = prep.stream_stats.chunks
    require(k18_1 >= 2 * chunks1,
            f"WIDE: {k18_1} K18 launches for {chunks1} chunks of 40 planes")
    check_oracle("WIDE", rs, wwant)
    require(wgov.ledger_balanced(), "WIDE: the ledger is not balanced")
    got1 = rs.storage_columns()
    wm = MetricsRegistry()
    pw = PxExecutor(wt, mesh, device_budget=STREAM_WIDE_BUDGET, metrics=wm)
    pgov = MemoryGovernor(budget=STREAM_WIDE_BUDGET)
    pw.governor = pgov
    try:
        kernels.decode_staged = capturing
        pprep = pw.prepare(wplan.plan)
        outb, wall2, chunks2, hops2, k18_2 = run_counted(
            "PX4S_WIDE", "wide", pprep.run, lambda _o: pprep, wm, pgov)
    finally:
        kernels.decode_staged = orig_decode
    require(k18_2 >= 2 * PX_MESH_SHARDS * chunks2,
            f"PX4S_WIDE: {k18_2} K18 launches for {chunks2} chunks")
    gotw = batch_rows_storage(outb, wnames)
    check_oracle("PX4S_WIDE", _Stored(gotw), wwant)
    require(same_bits(gotw, got1), "PX4S_WIDE: differs from one device's")
    recs.append({"statement": "WIDE", "rows": 1, "wall_ms": wall1,
                 "chunks": chunks1, "k18_launches": k18_1,
                 "planes": STREAM_WIDE_COLS})
    recs.append({"statement": "PX4S_WIDE", "rows": 1, "wall_ms": wall2,
                 "chunks": chunks2, "host_hops": hops2,
                 "k18_launches": k18_2, "planes": STREAM_WIDE_COLS})
    print(f"WIDE: {STREAM_WIDE_COLS} bigint planes streamed under "
          f"{STREAM_WIDE_BUDGET} B: "
          f"one device {chunks1} chunks, {k18_1} K18 launches, "
          f"{wall1:.3f} ms; PX on {PX_MESH_SHARDS} shards {chunks2} chunks "
          f"= {hops2} host hops, {k18_2} K18 launches, {wall2:.3f} ms; "
          f"both equal to the numpy sums", flush=True)
    require(px_counts.get("K18_decode_staged", 0) > 0,
            "PX streamed phase: K18 never launched on a PX run")
    require(set(captured) == {"leg1", "leg2", "wide"},
            f"PX streamed phase: K18 calls kept for {sorted(captured)}")
    del wt, wsess, pw, pprep, outb
    release_device()
    return recs, px_counts, {k: v[1] for k, v in captured.items()}


def px_decode_checks(kernels, reps: int, captured: dict) -> list:
    """K18 on the PX chunk source's decode, each call kept from the PX
    runs alone: one shard's chunk of leg 2 (4 shards; the record), leg
    1's one-shard chunk, and the wide leg's 40-plane decode (two
    launches); each against its plain version bit for bit, twice,
    timed."""
    import numpy as np
    import torch

    calls = {k: captured[k] for k in ("leg2", "leg1", "wide")}
    require(len(calls["wide"][3]) > kernels.K18_MAX_COLS,
            "the wide call does not pass K18_MAX_COLS planes")

    def run(fn, call):
        staged, bases, count, meta, cap, dtypes, dev = call
        cols, sel = fn(staged, bases, count, meta, cap, dtypes, dev)
        return [_bits(cols[k]) for k, _ in meta] + [sel]

    for tag, call in calls.items():
        a = run(kernels.decode_staged, call)
        b = run(kernels.decode_staged_plain, call)
        c = run(kernels.decode_staged, call)
        require(all(torch.equal(x, y) and torch.equal(x, z)
                    for x, y, z in zip(a, b, c)),
                f"K18 on the {tag} PX decode ({len(call[3])} planes) "
                "differs from its plain version or between two runs")

    def timed(call):
        staged, bases, count, meta, cap, dtypes, dev = call

        def library():
            return [kernels._widen_plain(staged[k]).to(dtypes[k])
                    + np.asarray(bases[k]).item() for k, _ in meta]

        nbytes = sum(staged[k].numel() * staged[k].element_size()
                     for k, _ in meta) + sum(
            cap * torch.empty((), dtype=dtypes[k]).element_size()
            for k, _ in meta) + cap
        bm, by = bound_ms(nbytes, cap * len(meta))
        return {"ms": cuda_ms(lambda: run(kernels.decode_staged, call),
                              reps),
                "plain_ms": cuda_ms(
                    lambda: run(kernels.decode_staged_plain, call), reps),
                "library_ms": cuda_ms(library, reps), "bound_ms": bm,
                "bound_by": by, "planes": len(meta), "rows": cap}

    shard, dop1, wide = (timed(calls[k]) for k in ("leg2", "leg1", "wide"))
    src, rep = KERNEL_META["K18_decode_staged.px"]
    print(f"kernel K18_decode_staged.px: one shard of 4, {shard['planes']} "
          f"planes of {shard['rows']} rows: kernel_ms {shard['ms']:.6f}, "
          f"plain_ms {shard['plain_ms']:.6f}, library_ms "
          f"{shard['library_ms']:.6f}, bound_ms {shard['bound_ms']:.6f} "
          f"({shard['bound_by']}); dop 1, {dop1['planes']} planes of "
          f"{dop1['rows']} rows: {dop1['ms']:.6f} ms (bound "
          f"{dop1['bound_ms']:.6f}); wide, {wide['planes']} planes of "
          f"{wide['rows']} rows in two launches: {wide['ms']:.6f} ms "
          f"(bound {wide['bound_ms']:.6f}); all exact, twice", flush=True)
    return [{"name": "K18_decode_staged.px", "route": "cuda", "source": src,
             "replaces": rep, "max_abs_err": 0.0,
             **{k: shard[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
             "shard": shard, "dop1": dop1, "wide": wide}]


# ---- the caps leg's statements: each reaches a repaired wrapper past its
# old cap. The set operations compare 9 columns of the null-extended side
# of a LEFT JOIN (each nullable: its value and its validity plane, 18 key
# planes of K14); the group-bys take 17 aggregates, and 8 nullable CASE
# keys with l_suppkey (17 key planes of K8); K6, K12 and K15 below. {hi}
# bounds the driving key
# (every row at SF 0.1; a slice at SF 10, where the whole table would only
# repeat the same work).
CAPS_CASES = (
    "case when l_quantity < 45 then l_partkey end as c0",
    "case when l_discount < 0.09 then l_suppkey end as c1",
    "case when l_tax < 0.07 then l_linenumber end as c2",
    "case when l_shipmode <> 'AIR' then l_quantity end as c3",
    "case when l_returnflag <> 'R' then l_partkey % 1000 end as c4",
    "case when l_linestatus = 'O' then l_suppkey % 100 end as c5",
    "case when l_quantity > 5 then l_linenumber end as c6",
    "case when l_discount > 0.01 then l_quantity end as c7",
)
CAPS_SIDE = ("select o_orderstatus as c0, o_orderpriority as c1, "
             "o_shippriority as c2, o_clerk as c3, o_orderdate as c4, "
             "o_totalprice as c5, o_custkey as c6, o_orderkey as c7, "
             "o_comment as c8 from customer left join orders on "
             "c_custkey = o_custkey and o_orderpriority = '1-URGENT' "
             "where c_custkey < {hi}")
CAPS_ORDER = " order by " + ", ".join(f"c{i}" for i in range(9))
CAPS_AGGS = ("count(*) as n", "sum(l_quantity) as s1",
             "sum(l_extendedprice) as s2", "sum(l_discount) as s3",
             "sum(l_tax) as s4", "min(l_quantity) as m1",
             "min(l_extendedprice) as m2", "min(l_discount) as m3",
             "min(l_tax) as m4", "max(l_quantity) as x1",
             "max(l_extendedprice) as x2", "max(l_discount) as x3",
             "max(l_tax) as x4", "min(l_shipdate) as d1",
             "max(l_shipdate) as d2", "sum(l_linenumber) as s5",
             "max(l_partkey) as x5")
CAPS_STMTS = {
    "CAP_INTERSECT": (CAPS_SIDE + " intersect " + CAPS_SIDE
                      + " and c_nationkey < 12" + CAPS_ORDER),
    "CAP_EXCEPT": (CAPS_SIDE + " except " + CAPS_SIDE
                   + " and c_nationkey < 12" + CAPS_ORDER),
    "CAP_AGG17": ("select l_suppkey, " + ", ".join(CAPS_AGGS)
                  + " from lineitem where l_orderkey < {hi} "
                  "group by l_suppkey order by l_suppkey"),
    "CAP_KEY17": ("select " + ", ".join(CAPS_CASES[:8])
                  + ", l_suppkey, count(*) as n from lineitem "
                  "where l_orderkey < {hi} group by "
                  + ", ".join(f"c{i}" for i in range(8))
                  + ", l_suppkey order by "
                  + ", ".join(f"c{i}" for i in range(8)) + ", l_suppkey"),
}
# K6: 17 sums and counts over lineitem's clustered l_orderkey joined to
# orders (the clustered-FK group-by); K12: a self-join of lineitem on 9
# integer columns (the 64-bit key hashes them all); K15: a DISTINCT
# aggregate under 8 nullable keys (8 values, 8 validity planes and the
# value: 17 keys)
CAPS_SUMS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
             "l_linenumber", "l_partkey", "l_suppkey",
             "l_quantity * l_discount", "l_extendedprice * l_tax",
             "l_quantity + l_linenumber", "l_partkey % 7", "l_suppkey % 11",
             "l_linenumber * l_linenumber", "l_quantity * l_tax",
             "l_extendedprice * l_discount")
CAPS_JOIN_COLS = ("l_orderkey", "l_linenumber", "l_partkey", "l_suppkey",
                  "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipmode",
                  "l_shipinstruct")
CAPS_STMTS.update({
    "CAP_CLUSTERED17": (
        "select o_orderkey, "
        + ", ".join(f"sum({e}) as s{i}" for i, e in enumerate(CAPS_SUMS))
        + ", count(l_shipdate) as c1, count(l_commitdate) as c2 "
        "from lineitem, orders where l_orderkey = o_orderkey and "
        "l_orderkey < {hi} group by o_orderkey order by o_orderkey"),
    "CAP_JOIN9": (
        "select count(*) as n, sum(a.l_quantity) as q from lineitem a "
        "join lineitem b on "
        + " and ".join(f"a.{c} = b.{c}" for c in CAPS_JOIN_COLS)
        + " where a.l_orderkey < {hi} and b.l_orderkey < {hi}"),
    "CAP_DISTINCT17": (
        "select " + ", ".join(CAPS_CASES[:8])
        + ", count(distinct l_suppkey) as d, count(*) as n from lineitem "
        "where l_orderkey < {hi} group by "
        + ", ".join(f"c{i}" for i in range(8)) + " order by "
        + ", ".join(f"c{i}" for i in range(8))),
})
# the kernel and its width each statement must reach (see caps_phase),
# past the old caps: K14 16 key planes, K8 16 keys or aggregates, K6 16
# aggregates, K12 8 columns, K15 16 keys
CAPS_WIDTH = {"CAP_INTERSECT": ("K14_hash_set", 18),
              "CAP_EXCEPT": ("K14_hash_set", 18),
              "CAP_AGG17": ("K8_segmented_reduce", 17),
              "CAP_KEY17": ("K8_segmented_reduce", 17),
              "CAP_CLUSTERED17": ("K6_clustered_agg", 17),
              "CAP_JOIN9": ("K12_hash_combine", 9),
              "CAP_DISTINCT17": ("K15_distinct_first", 17)}
# the driving keys' bound at SF 10: the set operations' customers (of
# 1.5M), the other statements' orders (of 60M)
CAPS_HI_SF10 = {"CAP_INTERSECT": 300_000, "CAP_EXCEPT": 300_000,
                "CAP_AGG17": 2_000_000, "CAP_KEY17": 2_000_000,
                "CAP_CLUSTERED17": 2_000_000, "CAP_JOIN9": 2_000_000,
                "CAP_DISTINCT17": 2_000_000}


def caps_phase(tables, Session, uk, kernels) -> tuple:
    """The caps leg's statements at SF 10 on the card, the launch counts
    from 0 just before and read just after: each once cold and once warm,
    non-empty and finite, and the kernel call it reaches wider than the
    old cap (the width seen at the call). The card-against-CPU phase then
    holds their bits at SF 0.1. Returns (records, launches)."""
    import torch

    import oceanbase_tpu_torch.engine.executor as ex
    import oceanbase_tpu_torch.ops.hashagg as ha
    import oceanbase_tpu_torch.ops.join as oj

    sess = Session(tables, unique_keys=uk, device="cuda")
    seen: dict = {}
    # (module, function, kernel, the width of a call)
    taps = [(ex, "build_hash_table", "K14_hash_set",
             lambda keys, *a, **kw: len(keys)),
            (ha, "segmented_reduce", "K8_segmented_reduce",
             lambda skeys, ssel, order, aggs: max(len(skeys), len(aggs))),
            (ex, "clustered_segments", "K6_clustered_agg",
             lambda starts, ends, sel, aggs: len(aggs)),
            (oj, "hash_combine", "K12_hash_combine", lambda cols: len(cols)),
            (ex, "distinct_first_mask", "K15_distinct_first",
             lambda key_vals, val, mask: len(key_vals) + 1)]
    orig = [getattr(mod, fn) for mod, fn, _k, _w in taps]

    def tap(real, kname, width):
        def call(*a, **kw):
            seen.setdefault(kname, []).append(width(*a, **kw))
            return real(*a, **kw)
        return call

    for (mod, fn, kname, width), real in zip(taps, orig):
        setattr(mod, fn, tap(real, kname, width))
    recs = []
    kernels.reset_launches()
    try:
        for name, text in CAPS_STMTS.items():
            kname, width = CAPS_WIDTH[name]
            seen.clear()
            sql = text.format(hi=CAPS_HI_SF10[name])
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rs = sess.sql(sql)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            n = check_sane(name, rs)
            got = max(seen.get(kname, [0]))
            require(got >= width, f"{name}: {kname} saw width {got}, not "
                    f"the {width} past its old cap")
            print(f"{name}: {n} rows, {kname} at width {got}, cold "
                  f"{times[0]:.3f} ms, warm {times[1]:.3f} ms", flush=True)
            recs.append({"statement": name, "rows": n, "kernel": kname,
                         "width": got, "cold_ms": times[0],
                         "warm_ms": times[1]})
    finally:
        for (mod, fn, _k, _w), real in zip(taps, orig):
            setattr(mod, fn, real)
    launches = dict(kernels.LAUNCHES)
    for _mod, _fn, k, _w in taps:
        require(launches[k] > 0, f"{k} was never launched in the caps leg")
    del sess
    return recs, launches


# ---- the caps leg: each repaired wrapper over its old cap ----------------
# (a width the plain version and the JAX package take, and a by-value
# table once made the wrapper refuse on the card)
CAPS_SEED = 20261018
CAPS_FLOAT_RTOL = 1e-12


def _close(what, got, want) -> None:
    """Float sums to rel CAPS_FLOAT_RTOL (the kernel adds in double in
    another order), everything else bit for bit."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    for a, b in zip(got, want):
        require(a.dtype == b.dtype and a.shape == b.shape,
                f"{what}: type or shape differs from the plain version")
        if a.dtype.is_floating_point:
            a64, b64 = a.double(), b.double()
            same = (a64 == b64) | (torch.isnan(a64) & torch.isnan(b64))
            rel = ((a64 - b64).abs() / b64.abs().clamp(min=1e-300))
            require(bool((same | (rel <= CAPS_FLOAT_RTOL)).all()),
                    f"{what}: float results past rel {CAPS_FLOAT_RTOL}")
        else:
            require(torch.equal(a, b), f"{what}: differs from the plain "
                    "version")


def caps_synthetic(kernels, dev) -> list:
    """Every wrapper whose by-value table capped its width, run on the
    card past the old cap and held to its plain version on the same
    inputs (integers and orders bit for bit, float sums to rel 1e-12; the
    hash tables by their probe matches and groups, whose slot layouts
    depend on the schedule): K5 over 50 payload columns, K6 over 17
    aggregates, K8 over 17 keys and 17 aggregates, K12 over 9 columns,
    K14 over 18 key planes, K15 over 17 keys, K17 over 50 columns and 17
    bounds, K22 at k = 4096, K29 over 17 keys and 17 aggregates. Returns
    one record per case."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(CAPS_SEED)

    def ints(n, hi, dtype=torch.int64):
        return torch.randint(0, hi, (n,), generator=g).to(dtype).to(dev)

    def flags(n, p=0.8):
        return (torch.rand(n, generator=g) < p).to(dev)

    def dyadic(n):
        # float64 values whose partial sums are exact in any order: the
        # plain versions' cumsum differences then equal the kernels' sums
        return (torch.randint(-2**20, 2**20, (n,), generator=g)
                .to(torch.float64) / 16).to(dev)

    recs = []

    def done(name, width, old_cap, what):
        recs.append({"kernel": name, "width": width, "old_cap": old_cap,
                     "check": what})
        print(f"caps leg: {name} at {width} (old cap {old_cap}) equals its "
              f"plain version ({what})", flush=True)

    # K5: 50 payload columns of a 10,000-row build side
    n, nb = 200_000, 10_000
    pk, ps = ints(n, nb + 50), flags(n)
    bk = torch.arange(nb, dtype=torch.int64, device=dev)
    bs = flags(nb, 0.9)
    pay = [ints(nb, 1 << 40, torch.int64 if i % 2 else torch.int32)
           for i in range(50)]
    sel, outs = kernels.affine_join(pk, ps, 0, 1, bk, bs, pay)
    psel, pouts = kernels.affine_join_plain(pk, ps, 0, 1, bk, bs, pay)
    _close("K5 50 columns", [sel, *outs], [psel, *pouts])
    done("K5_affine_join", 50, kernels.K5_MAX_COLS, "bit for bit")

    # K6: 17 aggregates over clustered ranges
    nbu = 50_000
    lens = torch.randint(0, 8, (nbu,), generator=g)
    ends = torch.cumsum(lens, 0).to(torch.int32)
    starts = (ends - lens.to(torch.int32)).to(dev)
    ends = ends.to(dev)
    nr = int(lens.sum())
    s6 = flags(nr)
    aggs6 = []
    for i in range(17):
        m = flags(nr, 0.7) if i % 3 == 0 else None
        if i % 4 == 0:
            aggs6.append(("count", None, m))
        elif i % 4 == 1:
            aggs6.append(("sum", dyadic(nr), m))
        else:
            aggs6.append(("sum", ints(nr, 1 << 50), m))
    cnt, r6 = kernels.clustered_segments(starts, ends, s6, aggs6)
    pc, p6 = kernels.clustered_segments_plain(starts, ends, s6, aggs6)
    _close("K6 17 aggregates", [cnt, *r6], [pc, *p6])
    done("K6_clustered_agg", 17, 16, "ints bit for bit, float sums rel 1e-12")

    # K8: 17 sorted keys and 17 aggregates
    n8 = 300_000
    # lexicographically sorted key tuples of small random keys
    cols = torch.stack([ints(n8, 3) for _ in range(17)], 1)
    for i in reversed(range(17)):
        cols = cols[torch.sort(cols[:, i], stable=True).indices]
    k8 = [cols[:, i].contiguous() for i in range(17)]
    ssel = torch.sort(flags(n8, 0.9).to(torch.int8), descending=True,
                      stable=True).values.bool()
    order = torch.randperm(n8, generator=g).to(torch.int32).to(dev)
    aggs8 = []
    for i in range(17):
        m = flags(n8, 0.8) if i % 2 else None
        op = ("count", "sum", "min", "max")[i % 4]
        v = None if op == "count" else (
            dyadic(n8) if i % 5 == 1 else ints(n8, 1 << 40))
        aggs8.append((op, v, m))
    s8, r8 = kernels.segmented_reduce(k8, ssel, order, aggs8)
    ps8, p8 = kernels.segmented_reduce_plain(k8, ssel, order, aggs8)
    _close("K8 17 keys, 17 aggregates", [s8, *r8], [ps8, *p8])
    done("K8_segmented_reduce", "17 keys, 17 aggregates", 16,
         "ints bit for bit, float sums rel 1e-12")

    # K12: 9 join columns
    c12 = [ints(100_000, 1 << 31, (torch.int32, torch.int64)[i % 2])
           for i in range(9)]
    _close("K12 9 columns", kernels.hash_columns(c12),
           kernels.hash_columns_plain(c12))
    done("K12_hash_combine", 9, 8, "bit for bit")

    # K14: 18 key planes (9 nullable columns: value and validity)
    nb14, np14 = 20_000, 60_000
    bcols = [ints(nb14, 4, torch.int64 if i % 2 == 0 else torch.bool)
             for i in range(18)]
    pidx = torch.randint(0, nb14, (np14,), generator=g).to(dev)
    pcols = [c[pidx].clone() for c in bcols]
    pcols[0][::7] += 100  # rows with no match
    bm, pm = flags(nb14, 0.9), flags(np14, 0.9)
    ts = 1 << (2 * nb14 - 1).bit_length()
    tag, row = kernels.hash_set_build(bcols, bm, ts)
    got = kernels.hash_set_probe(tag, row, bcols, pcols, pm)
    ptag, prow = kernels.hash_set_build_plain(bcols, bm, ts)
    want = kernels.hash_set_probe_plain(ptag, prow, bcols, pcols, pm)
    _close("K14 18 planes", got, want)
    done("K14_hash_set", 18, 16, "probe matches bit for bit")

    # K15: 17 keys through K3's order
    n15 = 200_000
    k15 = [ints(n15, 3) for _ in range(17)]
    m15 = flags(n15)
    o15 = kernels.sort_order_plain(k15, [False] * 17, m15)
    _close("K15 17 keys", kernels.first_occurrence(k15, m15, o15),
           kernels.first_occurrence_plain(k15, m15, o15))
    done("K15_distinct_first", 17, 16, "bit for bit")

    # K17: 50 columns and 17 bounds
    n17 = 400_000
    key = torch.sort(ints(n17, 100_000)).values
    pay17 = [ints(n17, 1 << 20, (torch.int32, torch.int64, torch.int8,
                                 torch.int16)[i % 4]) for i in range(50)]
    s17 = flags(n17)
    lows = [(torch.tensor(1000 + 10 * i, device=dev), "left")
            for i in range(9)]
    highs = [(torch.tensor(60_000 - 10 * i, dtype=torch.int32, device=dev),
              "right") for i in range(8)]
    got = kernels.slice_scan(key, n17, lows, highs, 300_000, pay17, s17)
    want = kernels.slice_scan_plain(key, n17, lows, highs, 300_000, pay17,
                                    s17)
    _close("K17 50 columns, 17 bounds", [*got[0], got[1], got[2], got[3]],
           [*want[0], want[1], want[2], want[3]])
    done("K17_slice_scan", "50 columns, 17 bounds", "48 columns, 16 bounds",
         "bit for bit")

    # K22: k = 4096 over 8 lists of integer-valued vectors (exact dots)
    nx, d, nl, ml = 40_000, 16, 32, 1250
    x = torch.randint(-4, 5, (nx, d), generator=g).float().to(dev)
    perm = torch.randperm(nx, generator=g).to(torch.int32).to(dev)
    lens22 = torch.full((nl,), ml, dtype=torch.int32)
    lens22[::3] = ml - 17
    offs22 = (torch.arange(nl, dtype=torch.int32) * ml).to(dev)
    lens22 = lens22.to(dev)
    probes = torch.randperm(nl, generator=g)[:8].to(torch.int32).to(dev)
    q = torch.randint(-4, 5, (d,), generator=g).float().to(dev)
    s22 = flags(nx, 0.7)
    got = kernels.ivf_probe(x, s22, perm, offs22, lens22, probes, q, ml, nx,
                            4096)
    want = kernels.ivf_probe_plain(x, s22, perm, offs22, lens22, probes, q,
                                   ml, nx, 4096)
    _close("K22 k 4096", list(got), list(want))
    done("K22_ivf_probe", "k 4096", 2048, "bit for bit (exact dots)")

    # K29: 17 keys and 17 aggregates
    n29 = 200_000
    gid = ints(n29, 5000)
    k29 = [(gid * (i + 3)) % (7 + i) for i in range(17)]
    m29 = flags(n29)
    aggs29 = []
    for i in range(17):
        op = ("count", "sum", "min", "max")[i % 4]
        aggs29.append((op, None if op == "count" else ints(n29, 1 << 40)))
    ts29 = 1 << 16
    got = _group_set(kernels.hash_groupby(k29, m29, aggs29, ts29))
    want = _group_set(kernels.hash_groupby_plain(k29, m29, aggs29, ts29))
    require(got == want, "K29 17 keys, 17 aggregates: groups differ from "
            "the plain version")
    done("K29_hash_groupby", "17 keys, 17 aggregates", 16, "groups as sets")
    torch.cuda.synchronize()
    return recs


def k31_synthetic(kernels, dev) -> int:
    """K31's two entries against their plain versions on integer-valued
    vectors (every distance exact in float32, so ties are real and their
    order is tested): 1, 3 and 4 shards (3 leaves pad rows), k 10 and k
    3000 (past the shared-memory run), k equal to the candidates; each
    shard's strip and the merge of the gathered strips bit for bit,
    twice. Returns the number of cases."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(CAPS_SEED + 31)
    n, d, nl = 30_000, 16, 64
    x = torch.randint(-3, 4, (n, d), generator=g).float()
    sizes = torch.randint(200, 700, (nl,), generator=g)
    sizes = (sizes * n / sizes.sum()).long()
    sizes[-1] += n - int(sizes.sum())
    offs = (torch.cumsum(sizes, 0) - sizes).to(torch.int32).to(dev)
    lens = sizes.to(torch.int32).to(dev)
    ml = int(sizes.max())
    q = torch.randint(-3, 4, (d,), generator=g).float().to(dev)
    cases = 0
    for nsh in (1, 3, 4):
        rps = -(-n // nsh)
        xs = torch.cat([x, torch.zeros(nsh * rps - n, d)]).to(dev)
        for nprobe, k in ((8, 10), (16, 3000), (2, 2 * ml)):
            probes = torch.randperm(nl, generator=g)[:nprobe].to(
                torch.int32).to(dev)
            kk = min(k, nprobe * ml)
            strips, pstrips = [], []
            for s in range(nsh):
                blk = xs[s * rps:(s + 1) * rps]
                args = (blk, s * rps, offs, lens, probes, q, ml, kk)
                got, want = kernels.ann_rerank(*args), \
                    kernels.ann_rerank_plain(*args)
                _exact(f"K31 rerank nsh {nsh} shard {s} k {kk}", list(got),
                       list(want), list(kernels.ann_rerank(*args)))
                strips.append(got)
                pstrips.append(want)
            gd = torch.cat([t[0] for t in strips])
            gp = torch.cat([t[1] for t in strips])
            got = kernels.ann_merge(gd, gp, kk)
            want = kernels.ann_merge_plain(gd, gp, kk)
            _exact(f"K31 merge nsh {nsh} k {kk}", list(got), list(want),
                   list(kernels.ann_merge(gd, gp, kk)))
            cases += 1
    # the merge at and past its one-launch limit (integer distances: real
    # ties; +inf lanes)
    lim = kernels.K31_MERGE_ONE
    for m, kk in ((1, 1), (lim, 10), (lim, lim), (lim + 1, 10),
                  (lim + 1, lim + 1)):
        gd = torch.randint(-4, 5, (m,), generator=g).float()
        gd[torch.rand(m, generator=g) < 0.3] = float("inf")
        gd = gd.to(dev)
        gp = torch.randint(0, 10**6, (m,), generator=g).to(
            torch.int32).to(dev)
        _exact(f"K31 merge of {m} pairs, k {kk}",
               list(kernels.ann_merge(gd, gp, kk)),
               list(kernels.ann_merge_plain(gd, gp, kk)),
               list(kernels.ann_merge(gd, gp, kk)))
        cases += 1
    torch.cuda.synchronize()
    print(f"K31: {cases} synthetic cases equal the plain versions bit for "
          "bit, twice", flush=True)
    return cases


# ---- the sharded ANN leg: parallel/ann.py on K31 -------------------------
# The vector phase's deployment (ANN_N x ANN_D, the ANN_LISTS-list index
# the card built there) across 4 shards of the card; no deployment stands
# behind 4 shards on one card: they drive the merge, as PX leg 2 does.
ANN_MESH_SHARDS = 4


class _Cols:
    """A result's storage-domain columns behind the ResultSet method the
    oracle checks read."""

    def __init__(self, cols):
        self._cols = cols

    def storage_columns(self):
        return self._cols


def ann_mesh_leg(Session, kernels, ctx, dev) -> tuple:
    """shard_ivf over 4 shards of the card and every query of the vector
    phase searched at nprobe ANN_NPROBE, k ANN_K, the launch counts from 0
    just before and read just after: the ids equal the single device's
    IVF route (K21 + K22) at the same nprobe under the margin rule, the
    distances lie within VEC_DIST_TOL x (|x|^2 + |q|^2) of numpy's float64
    value, and the MeshPlan counts the merge's all_gather. Untraced (its
    shards run in threads). Returns (record, launches, K31's arguments)."""
    import numpy as np
    import torch

    from oceanbase_tpu_torch.parallel.ann import shard_ivf
    from oceanbase_tpu_torch.parallel.mesh import make_mesh
    from oceanbase_tpu_torch.storage.vector_index import (
        register_vector_index,
    )

    x, queries, idx = ctx["x"], ctx["queries"], ctx["idx"]
    mesh = make_mesh(ANN_MESH_SHARDS, devices=[dev] * ANN_MESH_SHARDS)
    t0 = time.perf_counter()
    siv = shard_ivf(mesh, x, idx)
    torch.cuda.synchronize()
    lay_s = time.perf_counter() - t0
    kernels.reset_launches()
    got, times = [], []
    for q in queries:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got.append(siv.search(q, ANN_K, ANN_NPROBE))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {**kernels.LAUNCHES, **kernels.ENTRY_LAUNCHES}
    nq = len(queries)
    require(launches["K31_shard_ivf"] == 2 * ANN_MESH_SHARDS * nq,
            f"sharded ANN: K31 launched {launches['K31_shard_ivf']} times "
            f"for {nq} queries on {ANN_MESH_SHARDS} shards")
    colls = siv.mesh_plan.ops_by_collective()
    require(colls.get("all_gather", 0) >= 1, f"sharded ANN: the MeshPlan "
            f"counts no all_gather ({colls})")
    # the single device's IVF route at the same nprobe
    cat = vec_catalog(x, {"grp": np.arange(len(x), dtype=np.int64) % 10})
    register_vector_index(cat, "docs", "emb", lists=ANN_LISTS,
                          nprobe=ANN_NPROBE)
    sess = Session(cat, device=dev)
    sess.executor.install_ivf("docs", "emb", idx)
    exact = ExactL2(x)
    swaps, worst = 0, 0.0
    for qi, (q, (rid, dist)) in enumerate(zip(queries, got)):
        rs = sess.sql(vec_text(q))
        require(bool(rs._cursor.prepared.params.vector_topns),
                "sharded ANN: the single device did not take the IVF route")
        swaps += margin_equal(exact, rid, vec_ids(rs), q,
                              f"sharded ANN query {qi}")
        want = exact.xn[rid] - 2.0 * (exact.x64[rid] @ q.astype(np.float64))
        tol = VEC_DIST_TOL * exact.scale(rid, q)
        err = np.abs(dist.astype(np.float64) - want)
        require(bool(np.all(err <= tol)), f"sharded ANN query {qi}: a "
                f"distance {err.max()!r} from float64, beyond {VEC_DIST_TOL}"
                " x (|x|^2 + |q|^2)")
        worst = max(worst, float((err / tol).max()))
    require(not sess.executor.ann_builds, "sharded ANN: the single device "
            "rebuilt the index")
    del sess
    # K31's arguments: query 0's probe of shard 0, and its gathered strips
    q0 = torch.from_numpy(queries[0]).to(dev)
    probes = kernels.ivf_lists(siv.cent[0], q0, ANN_NPROBE)
    kk = min(ANN_K, ANN_NPROBE * siv.max_list)
    rps = siv.rows_per_shard
    strips = [kernels.ann_rerank_plain(siv.xs[i], i * rps, siv.offs[i],
                                       siv.lens[i], probes, q0, siv.max_list,
                                       kk) for i in range(ANN_MESH_SHARDS)]
    args = {"rerank": (siv.xs[0], 0, siv.offs[0], siv.lens[0], probes, q0,
                       siv.max_list, kk),
            "merge": (torch.cat([t[0] for t in strips]),
                      torch.cat([t[1] for t in strips]), kk),
            "perm": siv.perm, "exact": exact, "q": queries[0]}
    rec = {"statement": "ANN_MESH", "shards": ANN_MESH_SHARDS,
           "queries": nq, "nprobe": ANN_NPROBE, "k": ANN_K,
           "rows": len(x), "lists": len(idx.lengths),
           "layout_s": lay_s, "search_median_ms": statistics.median(times),
           "search_ms": times, "margin_swaps": swaps,
           "dist_err_of_limit": worst, "collectives": colls,
           "mesh_plan_bytes": siv.mesh_plan.total_bytes,
           "device_bytes": siv.device_bytes()}
    print(f"ANN_MESH: {nq} queries on {ANN_MESH_SHARDS} shards of the card "
          f"({len(x)} x {x.shape[1]}, {len(idx.lengths)} lists, nprobe "
          f"{ANN_NPROBE}, k {ANN_K}): ids equal the single device's IVF "
          f"route ({swaps} margin swaps), distances within "
          f"{worst:.4f} of the limit, search median "
          f"{rec['search_median_ms']:.3f} ms, layout {lay_s:.3f} s, "
          f"collectives {colls}", flush=True)
    return rec, launches, args


def k31_checks(kernels, reps: int, args: dict) -> list:
    """K31's two entries on the sharded ANN leg's calls: the re-rank of
    shard 0's block against its plain version (positions equal but where
    two exact distances lie within the margin, distances to float32
    rounding, two runs bit-identical), the merge bit for bit; each timed
    beside its plain version, its library yardstick and its bound."""
    import numpy as np
    import torch

    recs = []
    ra = args["rerank"]
    xs, lo, offs, lens, probes, q, ml, kk = ra
    got = kernels.ann_rerank(*ra)
    want = kernels.ann_rerank_plain(*ra)
    again = kernels.ann_rerank(*ra)
    _exact("K31 rerank, two runs", list(got), list(again), list(again))
    perm, exact, qh = args["perm"], args["exact"], args["q"]
    gp, wp = got[1].cpu().numpy(), want[1].cpu().numpy()
    gd, wd = got[0].cpu().numpy(), want[0].cpu().numpy()
    live_g, live_w = np.isfinite(gd), np.isfinite(wd)
    require(np.array_equal(live_g, live_w), "K31 rerank: live lanes differ "
            "from the plain version")
    margin_equal(exact, perm[gp[live_g]], perm[wp[live_w]], qh,
                 "K31 rerank against its plain version")
    same = (gp == wp) & live_g
    err = float(np.max(np.abs(gd[same] - wd[same]))) if same.any() else 0.0
    # where both name one row, the two float32 distances lie within the
    # vector tolerance of the terms they cancel
    diff = np.abs(gd[same].astype(np.float64) - wd[same].astype(np.float64))
    lim = VEC_DIST_TOL * exact.scale(perm[gp[same]], qh)
    require(bool(np.all(diff <= lim)), f"K31 rerank: distance error "
            f"{err!r} beyond {VEC_DIST_TOL} x (|x|^2 + |q|^2) of the plain "
            f"version's")
    err_share = float((diff / lim).max()) if same.any() else 0.0
    # the rows of the block the probed windows hold, and their mask
    rps, d = int(xs.shape[0]), int(xs.shape[1])
    mask = torch.zeros(rps, dtype=torch.bool, device=xs.device)
    mine = 0
    for p in probes.tolist():
        a = int(offs[p]) - lo
        b = a + int(lens[p])
        a, b = max(a, 0), min(b, rps)
        if b > a:
            mask[a:b] = True
            mine += b - a
    nrm = (xs * xs).sum(1)
    inf = torch.tensor(float("inf"), device=xs.device)

    def lib_rerank():
        return torch.topk(torch.where(mask, nrm - 2.0 * (xs @ q), inf), kk,
                          largest=False)

    cand = int(probes.numel()) * ml
    # the owned rows, each probe's list entry (probe, offset, length), q,
    # the strip
    nbytes = mine * d * 4 + int(probes.numel()) * 12 + d * 4 + kk * 8
    km = cuda_ms(lambda: kernels.ann_rerank(*ra), reps)
    pm = cuda_ms(lambda: kernels.ann_rerank_plain(*ra), max(1, reps // 2))
    lm = cuda_ms(lib_rerank, reps)
    bm, by = bound_ms(nbytes, mine * 4 * d)
    src, rep = KERNEL_META["K31_shard_ivf"]
    shape = {"rows_per_shard": rps, "d": d, "nprobe": int(probes.numel()),
             "max_list": ml, "candidates": cand, "mine": mine, "k": kk}
    print(f"kernel K31_shard_ivf (rerank): positions equal the plain "
          f"version's (margin rule), max_abs_err {err:.6g} ({err_share:.4f} "
          f"of the limit {VEC_DIST_TOL} x (|x|^2 + |q|^2)), two runs "
          f"bit-identical, kernel_ms {km:.6f}, plain_ms {pm:.6f}, library_ms "
          f"{lm:.6f} (xs @ q, torch.where, torch.topk), bound_ms {bm:.6f} "
          f"({by}, {nbytes} B) at {shape}", flush=True)
    recs.append({"name": "K31_shard_ivf", "route": "cuda", "source": src,
                 "replaces": rep, "max_abs_err": err, "ms": km,
                 "plain_ms": pm, "bound_ms": bm, "bound_by": by,
                 "library_ms": lm,
                 "library": "block @ q, torch.where, torch.topk",
                 "bytes": nbytes, "shape": shape})
    ma = args["merge"]
    _exact("K31 merge", list(kernels.ann_merge(*ma)),
           list(kernels.ann_merge_plain(*ma)), list(kernels.ann_merge(*ma)))
    gd_, gp_, kk_ = ma

    def lib_merge():
        v, i = torch.topk(gd_, kk_, largest=False)
        return v, gp_[i]

    m = int(gd_.numel())
    nb2 = m * 8 + kk_ * 8
    km = cuda_ms(lambda: kernels.ann_merge(*ma), reps)
    pm = cuda_ms(lambda: kernels.ann_merge_plain(*ma), reps)
    lm = cuda_ms(lib_merge, reps)
    bm, by = bound_ms(nb2, 0)
    src, rep = KERNEL_META["K31_shard_ivf.merge"]
    print(f"kernel K31_shard_ivf.merge: match exact, two runs "
          f"bit-identical, kernel_ms {km:.6f}, plain_ms {pm:.6f}, "
          f"library_ms {lm:.6f} (torch.topk + index), bound_ms {bm:.6f} "
          f"({by}, {nb2} B) at {m} gathered rows, k {kk_}", flush=True)
    recs.append({"name": "K31_shard_ivf.merge", "route": "cuda",
                 "source": src, "replaces": rep, "max_abs_err": 0.0,
                 "ms": km, "plain_ms": pm, "bound_ms": bm, "bound_by": by,
                 "library_ms": lm, "library": "torch.topk + index",
                 "bytes": nb2, "shape": {"gathered": m, "k": kk_}})
    return recs


# ---- the multi-process leg: a 4-shard mesh across 2 processes ----------
# Two spawned processes, each holding 2 shards of the card, one gloo
# process group (NCCL refuses two ranks on one GPU): TPC-H at SF 1 (cut
# from SF 10: each process generates and uploads its own tables, and the
# leg must fit the run's time limit), Q1, Q3, Q6 through
# PxExecutor.execute, and a sharded kNN of 200,000 x 128 (256 lists,
# nprobe 16, k 10).
MP_PROCS, MP_PER = 2, 2
MP_SF = 1.0
MP_QIDS = (1, 3, 6)
MP_WARM = 3
MP_ANN = {"n": 200_000, "d": 128, "blobs": 256, "lists": 256, "nprobe": 16,
          "k": 10, "nq": 10}
MP_BACKEND = "gloo"
MP_PG_TIMEOUT_S = 240
MP_WAIT_S = 480


def mp_child(rank, port, q, seed, arrays, device, sf, ann):
    """One rank of the multi-process leg (spawned: it imports the port,
    never JAX, and loads the kernels the parent built): TPC-H at `sf`,
    and the kNN of `ann` over the index arrays the parent built."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    try:
        sys.path.insert(0, ROOT)
        dist.init_process_group(
            MP_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
            world_size=MP_PROCS, rank=rank,
            timeout=timedelta(seconds=MP_PG_TIMEOUT_S))
        from oceanbase_tpu_torch import kernels
        from oceanbase_tpu_torch.core.column import batch_rows_storage
        from oceanbase_tpu_torch.models.tpch import datagen, sql_suite
        from oceanbase_tpu_torch.parallel.ann import shard_ivf
        from oceanbase_tpu_torch.parallel.group import WIRE_BYTES
        from oceanbase_tpu_torch.parallel.mesh import process_mesh
        from oceanbase_tpu_torch.parallel.px import PxExecutor
        from oceanbase_tpu_torch.sql.parser import parse
        from oceanbase_tpu_torch.sql.planner import Planner
        from oceanbase_tpu_torch.storage.vector_index import ivf_from_arrays

        dev = torch.device(device)
        if dev.type == "cuda":
            kernels._load()
            require(not kernels.BUILD_INFO.get("log"), "a child rebuilt "
                    "the kernels")
        mesh = process_mesh([dev] * MP_PER, MP_BACKEND)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        tables = datagen.generate(sf=sf, seed=seed)
        planner = Planner(tables)
        px = PxExecutor(tables, mesh, unique_keys=sql_suite.UNIQUE_KEYS)
        out = {}
        for qid in MP_QIDS:
            planned = planner.plan(parse(sql_suite.QUERIES[qid]))
            names = list(planned.output_names)
            times = []
            for _ in range(MP_WARM + 1):
                sync()
                t0 = time.perf_counter()
                b = px.execute(planned.plan)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            w0 = WIRE_BYTES["sent"]
            prepared = px.prepare(planned.plan)
            b2 = prepared.run()
            wire = WIRE_BYTES["sent"] - w0
            out[qid] = {"cols": batch_rows_storage(b, names),
                        "again": batch_rows_storage(b2, names),
                        "cold_ms": times[0], "warm_ms": times[1:],
                        "cross_bytes": prepared.mesh_plan.cross_process_bytes,
                        "wire_bytes": wire}
        a = ann
        x, _blob, _c, queries = ann_data(a["n"], a["d"], a["blobs"], seed,
                                         a["nq"])
        siv = shard_ivf(mesh, x, ivf_from_arrays(*arrays))
        knn, ktimes = [], []
        for qv in queries:
            sync()
            t0 = time.perf_counter()
            knn.append(siv.search(qv, a["k"], a["nprobe"]))
            ktimes.append((time.perf_counter() - t0) * 1e3)
        out["knn"] = {"results": knn, "ms": ktimes,
                      "cross_bytes": siv.mesh_plan.cross_process_bytes,
                      "collectives": siv.mesh_plan.ops_by_collective()}
        out["jax_imported"] = "jax" in sys.modules
        q.put(("ok", rank, out))
    except BaseException:  # noqa: BLE001 - the parent fails the leg
        q.put(("err", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mp_leg(kernels, seed, dev) -> dict:
    """The multi-process leg: the parent's references first (the 4-shard
    single-process mesh on the card at SF 1 with the int64 oracles, the
    index built on the card and its 4-shard search), then the 2 ranks;
    both ranks' rows equal each other, bit for bit the single-process
    mesh's and the oracles; the kNN equals the single-process search
    exactly. Every wait is bounded and no child outlives the leg."""
    import multiprocessing as mp
    import socket

    import numpy as np
    import torch

    from oceanbase_tpu_torch.core.column import batch_rows_storage
    from oceanbase_tpu_torch.models.tpch import datagen, queries, sql_suite
    from oceanbase_tpu_torch.parallel.ann import shard_ivf
    from oceanbase_tpu_torch.parallel.mesh import make_mesh
    from oceanbase_tpu_torch.parallel.px import PxExecutor
    from oceanbase_tpu_torch.sql.parser import parse
    from oceanbase_tpu_torch.sql.planner import Planner
    from oceanbase_tpu_torch.storage.vector_index import build_ivf

    t0 = time.perf_counter()
    tables = datagen.generate(sf=MP_SF, seed=seed)
    li = tables["lineitem"]
    nsh = MP_PROCS * MP_PER
    mesh = make_mesh(nsh, devices=[dev] * nsh)
    px = PxExecutor(tables, mesh, unique_keys=sql_suite.UNIQUE_KEYS)
    planner = Planner(tables)
    ref = {}
    oracle = {1: lambda r: check_q1(r, li, queries),
              6: lambda r: check_q6(r, li, queries),
              3: lambda r: check_oracle("MP_Q3", r, queries.q3_numpy(tables))}
    for qid in MP_QIDS:
        planned = planner.plan(parse(sql_suite.QUERIES[qid]))
        ref[qid] = batch_rows_storage(px.execute(planned.plan),
                                      list(planned.output_names))
        oracle[qid](_Cols(ref[qid]))
    a = MP_ANN
    x, _blob, _c, qs = ann_data(a["n"], a["d"], a["blobs"], seed, a["nq"])
    idx = build_ivf(x, lists=a["lists"], device=dev)
    siv = shard_ivf(mesh, x, idx)
    kref = [siv.search(qv, a["k"], a["nprobe"]) for qv in qs]
    arrays = (idx.centroids, idx.perm, idx.offsets, idx.lengths)
    del px, siv, mesh
    release_device()
    ref_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [ctx.Process(target=mp_child,
                         args=(r, port, q, seed, arrays, str(dev), MP_SF,
                               MP_ANN),
                         daemon=True) for r in range(MP_PROCS)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + MP_WAIT_S
    try:
        while len(got) < MP_PROCS:
            require(time.monotonic() < deadline, f"multi-process leg: no "
                    f"result from every rank in {MP_WAIT_S} s")
            try:
                kind, rank, payload = q.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                require(not dead, f"multi-process leg: a rank died "
                        f"(exit codes {dead}) without a result")
                continue
            require(kind == "ok", f"multi-process leg: rank {rank} "
                    f"failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    require(not any(p.is_alive() for p in procs),
            "multi-process leg: a child outlived the leg")
    leg_s = time.perf_counter() - t0
    recs = []
    for qid in MP_QIDS:
        name = f"MP_Q{qid}"
        for rank in range(MP_PROCS):
            r = got[rank][qid]
            # bit for bit: the same shards run the same kernels in the same
            # merge order as the single-process mesh
            for col, want in ref[qid].items():
                for which in ("cols", "again"):
                    g = np.asarray(r[which][col])
                    require(g.dtype == np.asarray(want).dtype and
                            g.tobytes() == np.asarray(want).tobytes(),
                            f"{name} rank {rank}: {col} differs from the "
                            "single-process mesh")
        r0 = got[0][qid]
        require(r0["cross_bytes"] > 0, f"{name}: the MeshPlan counts no "
                "bytes between the processes")
        rec = {"statement": name, "cold_ms": r0["cold_ms"],
               "warm_median_ms": statistics.median(r0["warm_ms"]),
               "warm_ms_rank1": statistics.median(got[1][qid]["warm_ms"]),
               "mesh_plan_cross_bytes": r0["cross_bytes"],
               "wire_bytes_sent": [got[k][qid]["wire_bytes"]
                                   for k in range(MP_PROCS)],
               "rows": len(next(iter(ref[qid].values())))}
        print(f"{name}: rows equal in both ranks, bit-identical to the "
              f"single-process mesh and the int64 oracle; cold "
              f"{rec['cold_ms']:.3f} ms, warm median "
              f"{rec['warm_median_ms']:.3f} ms (rank 1 "
              f"{rec['warm_ms_rank1']:.3f} ms), MeshPlan cross-process "
              f"bytes {rec['mesh_plan_cross_bytes']}, sent "
              f"{rec['wire_bytes_sent']} B a run", flush=True)
        recs.append(rec)
    for rank in range(MP_PROCS):
        require(not got[rank]["jax_imported"], "a child imported JAX")
        kn = got[rank]["knn"]
        require(kn["collectives"].get("all_gather", 0) >= 1,
                "MP_KNN: no all_gather in the MeshPlan")
        for i, ((gi, gd), (wi, wd)) in enumerate(zip(kn["results"], kref)):
            require(np.array_equal(gi, wi) and
                    np.asarray(gd).tobytes() == np.asarray(wd).tobytes(),
                    f"MP_KNN rank {rank} query {i}: differs from the "
                    "single-process 4-shard search")
    kn = got[0]["knn"]
    krec = {"statement": "MP_KNN", "queries": len(kref),
            "search_median_ms": statistics.median(kn["ms"]),
            "mesh_plan_cross_bytes": kn["cross_bytes"], **MP_ANN}
    print(f"MP_KNN: {len(kref)} queries over 2 processes x 2 shards equal "
          f"the single-process 4-shard search exactly; search median "
          f"{krec['search_median_ms']:.3f} ms, MeshPlan cross-process "
          f"bytes {kn['cross_bytes']}", flush=True)
    recs.append(krec)
    print(f"multi-process leg ({MP_BACKEND}, {MP_PROCS} ranks x {MP_PER} "
          f"shards of the card, TPC-H SF {MP_SF}): references "
          f"{ref_s:.3f} s, ranks {leg_s:.3f} s", flush=True)
    return {"backend": MP_BACKEND, "procs": MP_PROCS, "per": MP_PER,
            "sf": MP_SF, "statements": recs, "ref_s": ref_s,
            "ranks_s": leg_s}


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
    # float32 products in full float32 (PyTorch's default, stated): the
    # plain versions and yardsticks of the vector kernels must not round
    # through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from oceanbase_tpu_torch import kernels
    from oceanbase_tpu_torch.engine.session import Session
    from oceanbase_tpu_torch.models import tpcds
    from oceanbase_tpu_torch.models.tpch import datagen, queries, sql_suite

    card = gpu_line()
    print(card, flush=True)
    t_run = time.perf_counter()
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
        "X1": x1_oracle(tables),
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
        ("X1", X1, oracle("X1")),
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
        # K31's merge runs on the sharded ANN leg's path, not this one
        require(v > 0 or k.startswith(ANN_KERNELS),
                f"{k} was never run on the main path")
    # the narrowed frame on and off on small results (after the counts)
    ab_text = {name: text for name, text, _check in stmts}
    narrow_recs = [narrow_ab(sess, name, ab_text[name])
                   for name in NARROW_AB_MAIN]

    k3_shapes = k3_call_shapes(sess, kernels, {
        name: ab_text[name] for name in K3_SHAPE_STMTS})
    k4_texts = {**ab_text, **{n: t for n, (t, d) in ANALYTIC.items()
                              if d == "tpch"}}
    k4_shapes = k4_call_shapes(sess, kernels, {
        name: k4_texts[name] for name in K4_SHAPE_STMTS})
    k4_ms = k4_device_ms(stmt_recs, K4_SHAPE_STMTS)
    captured = capture_join_kernels(sess, kernels, sql_suite.QUERIES)
    captured.update(capture_analytic_kernels(sess, kernels))
    krecs = kernel_checks(sess, kernels, args.reps, captured)
    del captured
    k24_stmts, k24_rec = k24_statement_checks(
        kernels, {name: (se, text) for se, name, text, _c, _r, _f in runs
                  if name in K24_STMTS}, args.reps)
    krecs.append(k24_rec)
    k24_syn = k24_synthetic(kernels, sess.executor.device)
    release_device()
    frecs = float_checks(sess, kernels)
    k8_cases = k8_synthetic(kernels, torch.device("cuda", 0))
    k3_cases = k3_synthetic(kernels, torch.device("cuda", 0))
    k4_cases = k4_synthetic(kernels, torch.device("cuda", 0))
    k7_cases = k7_synthetic(kernels, torch.device("cuda", 0))
    k15_cases = k15_synthetic(kernels, torch.device("cuda", 0))
    k13_cases = k13_synthetic(kernels, torch.device("cuda", 0))
    k17_cases = k17_synthetic(kernels, torch.device("cuda", 0))
    k24_path = k24_paths(kernels, torch.device("cuda", 0))
    k12_cases = k12_float_check(kernels, torch.device("cuda", 0))
    # the statement list holds both sessions (and their cached columns)
    del sess, ds_sess, runs
    release_device()

    # ---- the caps leg: its own counts, then each repaired wrapper past
    # its old cap against its plain version (and K31's synthetic cases)
    t0 = time.perf_counter()
    caps_recs, caps_launches = caps_phase(tables, Session,
                                          sql_suite.UNIQUE_KEYS, kernels)
    release_device()
    caps_kernels = caps_synthetic(kernels, torch.device("cuda", 0))
    k31_cases = k31_synthetic(kernels, torch.device("cuda", 0))
    release_device()
    caps_s = time.perf_counter() - t0
    print(f"caps leg in {caps_s:.3f} s", flush=True)
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
    k2_recs = k2_domain_phase(small, Session, sql_suite.UNIQUE_KEYS, kernels)
    t0 = time.perf_counter()
    k10_edge = k10_edge_phase(kernels)
    k2_edge = k2_edge_phase(kernels)
    print(f"K10 and K2 edge phases in {time.perf_counter() - t0:.3f} s",
          flush=True)
    # every statement: all 22 queries, S1 twice, T1, the analytic ones and
    # the TPC-DS star queries
    crecs = card_vs_cpu(small, Session, sql_suite.UNIQUE_KEYS,
                        [(name, text) for name, text, _check in stmts]
                        + [(n, t) for n, (t, d) in ANALYTIC.items()
                           if d == "tpch"] + list(SURFACE))
    crecs += card_vs_cpu(small_ds, Session, tpcds.UNIQUE_KEYS,
                         [(n, t) for n, (t, d) in ANALYTIC.items()
                          if d == "tpcds"] + ds_stmts)
    # the caps leg's statements, every row at this scale
    crecs += card_vs_cpu(small, Session, sql_suite.UNIQUE_KEYS,
                         [(n, t.format(hi=10**9))
                          for n, t in CAPS_STMTS.items()])
    del small_ds, tiny, tiny_ds
    release_device()

    # ---- the vector phase: its own counts ------------------------------
    # It runs before the streamed phase: once that phase's prefetch
    # threads have run, torch.profiler records only part of the device
    # events of later traced runs (seen on the H100), and the vector
    # statements' busy times would read low.
    t0 = time.perf_counter()
    vrecs, vbuild, v_launches, v_args, small_x, v_ab, ann_ctx = \
        vector_phase(Session, kernels, args.warm, args.reps)
    for r in vrecs:
        del r["result"]
    release_device()
    print(f"vector phase in {time.perf_counter() - t0:.3f} s", flush=True)
    krecs += vector_kernel_checks(kernels, args.reps, v_args)
    del v_args
    release_device()
    vcmp = vector_card_vs_cpu(Session, kernels, small_x)
    del small_x
    release_device()

    # ---- the server phase: its own counts ------------------------------
    # Also before the streamed phase, for the profiler's sake (above).
    t0 = time.perf_counter()
    server_checks = {
        1: lambda rs: check_q1(rs, li, queries),
        6: lambda rs: check_q6(rs, li, queries),
        3: oracle("Q3"),
        14: oracle("Q14"),
    }
    srv, sv_launches, k23_args = server_phase(
        tables, sql_suite.UNIQUE_KEYS, kernels, sql_suite.QUERIES,
        server_checks, args.warm, args.sf)
    release_device()
    srv["seconds"] = time.perf_counter() - t0
    print(f"server phase in {srv['seconds']:.3f} s", flush=True)
    krecs += k23_checks(kernels, args.reps, k23_args)
    del k23_args
    release_device()

    # ---- the rest of Executor.prepare: each path its own counts --------
    Q = sql_suite.QUERIES
    uk = sql_suite.UNIQUE_KEYS
    p_texts = {
        "P_Q6": Q[6], "P_Q6_1995": q6_text(Q, 1995), "P_Q14": Q[14],
        "P_NARROW": P_RANGE.format(lo=P_NARROW[0], hi=P_NARROW[1]),
        "P_WIDE": P_RANGE.format(lo=P_WIDE[0], hi=P_WIDE[1]),
        "P_BOUNDS17": P_BOUNDS17,
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
        "P_BOUNDS17": ref_check("P_BOUNDS17",
                                range_oracle(li, *P_BOUNDS17_RANGE)),
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
    # the streamed statements spend 4-10 s a run on the host at SF 10:
    # STREAM_WARM warm runs each keep the script inside its limit
    strecs, st_launches, legs, k18_args = stream_phase(
        tables, Session, uk, kernels, Q, oracles, resident,
        min(args.warm, STREAM_WARM), stream_budget)
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

    # ---- out-of-core PX (after the streamed phase, untraced): its own
    # counts
    t0 = time.perf_counter()
    pxsrecs, pxs_launches, pxs_calls = px_stream_phase(
        tables, uk, kernels, Q, oracles, resident, stream_budget, args.seed,
        torch.device("cuda", 0))
    release_device()
    krecs += px_decode_checks(kernels, args.reps, pxs_calls)
    del pxs_calls
    release_device()
    print(f"PX streamed phase and the K18 PX decode checks in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---- the spill operators: their own counts, then their device steps
    # alone at deployment size
    t0 = time.perf_counter()
    sprecs, sp_launches = spill_phase(tables, kernels,
                                      torch.device("cuda", 0))
    release_device()
    krecs += spill_kernel_checks(tables, kernels, args.reps,
                                 torch.device("cuda", 0))
    release_device()
    print(f"spill phase and the K3/K29/K14/K30 spill checks in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---- the PX phase's leg 2: a 4-shard mesh on the card, its own
    # counts (untraced: its shards run in threads, and torch.profiler
    # loses device events after threads have run, PERF.md §7)
    t0 = time.perf_counter()
    pxrecs, px_launches, px_captured = px_mesh_leg(
        tables, uk, kernels, Q, args.seed, PX_MESH_WARM,
        torch.device("cuda", 0))
    release_device()
    krecs += px_kernel_checks(kernels, args.reps, px_captured)
    del px_captured
    release_device()
    print(f"PX phase leg 2 and the K25-K28 checks in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---- the sharded ANN leg: its own counts (untraced: threads), then
    # K31 on its calls
    t0 = time.perf_counter()
    ann_rec, ann_launches, ann_args = ann_mesh_leg(
        Session, kernels, ann_ctx, torch.device("cuda", 0))
    del ann_ctx
    release_device()
    krecs += k31_checks(kernels, args.reps, ann_args)
    del ann_args
    release_device()
    print(f"sharded ANN leg and the K31 checks in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # ---- the multi-process leg: 2 spawned ranks x 2 shards of the card
    t0 = time.perf_counter()
    mp_rec = mp_leg(kernels, args.seed, torch.device("cuda", 0))
    release_device()
    print(f"multi-process leg in {time.perf_counter() - t0:.3f} s",
          flush=True)

    # ---- the batched program through the server: its own counts, last
    t0 = time.perf_counter()
    bat, b_launches = batched_phase(tables, uk, kernels, args.seed)
    release_device()
    print(f"batched phase in {time.perf_counter() - t0:.3f} s", flush=True)

    phase_launches = {"projection": p_launches, "streamed": st_launches,
                      "grace": g_launches, "vector": v_launches,
                      "server": sv_launches, "batched": b_launches,
                      "px_server": srv["px_leg"]["launches"],
                      "px_mesh": px_launches, "px_stream": pxs_launches,
                      "spill": sp_launches, "caps": caps_launches,
                      "ann_mesh": ann_launches}
    for r in krecs:
        if r["name"] == "K17_slice_scan":
            r["launches"] = p_launches[r["name"]]
        elif r["name"] == "K18_decode_staged":
            r["launches"] = st_launches[r["name"]]
        elif r["name"] in VECTOR_KERNELS:
            r["launches"] = v_launches[r["name"]]
        elif r["name"] in PX_KERNELS:
            # this slice's path: leg 2, where all four run (leg 1's one
            # shard launches K26 and K27, its record in the server phase)
            r["launches"] = px_launches[r["name"]]
        elif (r["name"] in SPILL_KERNELS
              or r["name"] in ("K3_radix_sort.spill", "K14_hash_set.spill")):
            # the spill operators' path: the spill phase
            r["launches"] = sp_launches[r["name"].split(".")[0]]
        elif r["name"] == "K18_decode_staged.px":
            # out-of-core PX: the PX runs of the PX streamed phase
            r["launches"] = pxs_launches["K18_decode_staged"]
        elif r["name"] in ANN_KERNELS or r["name"] == "K31_shard_ivf.merge":
            # the sharded ANN leg (both entries; the merge's own count)
            r["launches"] = ann_launches[r["name"]]
        elif r["name"] == "K8_segmented_reduce.dense":
            # Q17's call, one of the main path's K8 launches
            r["launches"] = main_launches["K8_segmented_reduce"]
        elif r["name"] == "K4_gather_rows.monotone":
            # the compaction orders' calls, among the main path's K4
            # launches
            r["launches"] = main_launches["K4_gather_rows"]
        elif r["name"] == "K23_first_live":
            # this slice's path: the server phase (the main path's
            # narrowed frames launch it too, main_launches)
            r["launches"] = sv_launches[r["name"]]
        else:
            r["launches"] = (main_launches[r["name"]]
                             if r["name"] in main_launches
                             else main_entries[r["name"]])
    kernels_line = {"kernels": [
        {**{k: r[k] for k in ("name", "route", "source", "replaces",
                              "launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms")},
         **({"path": r["path"]} if "path" in r else {})}
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
                   "vector_phase": {"statements": vrecs, "build": vbuild,
                                    "card_vs_cpu": vcmp},
                   "narrow_ab": narrow_recs + v_ab,
                   "server_phase": srv, "batched_phase": bat,
                   "px_phase": {"mesh_leg": pxrecs,
                                "server_leg": srv["px_leg"],
                                "streamed": pxsrecs},
                   "spill_phase": sprecs,
                   "caps_leg": {"statements": caps_recs, "seconds": caps_s,
                                "kernels": caps_kernels,
                                "k31_synthetic_cases": k31_cases},
                   "ann_mesh_leg": ann_rec, "multi_process_leg": mp_rec,
                   "k24": {"statements": k24_stmts, "synthetic": k24_syn},
                   "kernels": krecs, "float_checks": frecs,
                   "k8_synthetic_cases": k8_cases,
                   "k3_synthetic_cases": k3_cases,
                   "k4_synthetic_cases": k4_cases,
                   "k7_synthetic": k7_cases,
                   "k15_synthetic": k15_cases,
                   "k13_synthetic": k13_cases,
                   "k17_synthetic": k17_cases,
                   "k24_paths": k24_path,
                   "k2_domain": k2_recs,
                   "k10_edge": k10_edge, "k2_edge": k2_edge,
                   "k12_float_cases": k12_cases,
                   "k3_call_shapes": k3_shapes,
                   "k4_call_shapes": k4_shapes, "k4_device_ms": k4_ms,
                   "sqlite": {"sf": SQLITE_SF, "queries": srecs,
                              "analytic": arecs},
                   "card_vs_cpu": {"sf": CMP_SF, "statements": crecs},
                   "main_launches": main_launches,
                   "main_entries": main_entries,
                   "device": device,
                   "build_log": kernels.BUILD_INFO.get("log", "")},
                  f, indent=1)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_run:.3f} s", flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
