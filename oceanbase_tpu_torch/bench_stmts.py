"""Time whole statements on one card at SF 10, so two checkouts can be
compared end to end in one call.

    python3 oceanbase_tpu_torch/bench_stmts.py [--root DIR] [--reps N]

The tables are the port's TPC-H generator's at SF 10 and chip_smoke's
seed. Statements: S1, Q2, Q11, Q15, Q18 and Q21 on the Session; the
statements that run K2 or K10 (Q1, Q4, Q5, Q9, Q12, X1, D1, D2, R1, R2,
F1, F2, texts from the checkout's chip_smoke.py); and Q18, the range
sort of every lineitem row (PX4_SORT) and a DISTINCT over l_suppkey
(PX4_DISTINCT) on a PxExecutor over four shards of the one card (one
thread a shard), with chip_smoke.py's texts.

`--root` and the parent / change order are as `bench_ab.py` says. Prints
one JSON line a statement: the root, the card, the statement, its rows,
the cold run's wall ms, the wall ms of `reps` warm runs (each to its row
count, then the card synchronized) and their median, the peak memory the
warm runs allocated, and from torch.profiler over one more run the device
ms by kernel (`kernels_ms`), their sum (`device_ms`) and the sums over
K2's, K4's and K10's kernels (`k2_ms`, `k4_ms`, `k10_ms`: every kernel
whose name starts "k2_", "k4_", "k10_"); all null where the profiler saw
no device event (it may lose them once the PX shards' threads have run).
"""

import importlib.util
import os

import statistics
import sys
import time

try:
    from . import bench_ab
except ImportError:
    import bench_ab

SF = 10.0
SEED = 19920101
PX_SHARDS = 4
PX_BROADCAST_THRESHOLD = 1 << 16
S1 = """select l_orderkey, l_linenumber, l_extendedprice, l_shipdate
from lineitem
where l_shipdate = date '1995-06-17' and l_quantity < 10
order by l_extendedprice desc, l_orderkey, l_linenumber"""
PX_DISTINCT = "select distinct l_suppkey from lineitem"
PX_SORT = """select l_orderkey, l_linenumber, l_shipdate
from lineitem
order by l_shipdate, l_orderkey, l_linenumber"""
# Q11's FRACTION at SF 10: 0.0001 / SF (TPC-H 2.4.11.3)
Q11_FRACTION = "0.00001"


def smoke_texts():
    """chip_smoke.py's module beside this checkout's package (its texts)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_texts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def statements(queries):
    q11 = queries[11].replace("* 0.0001", f"* {Q11_FRACTION}")
    cs = smoke_texts()
    return [("S1", S1, False), ("Q2", queries[2], False), ("Q11", q11, False),
            ("Q15", queries[15], False), ("Q18", queries[18], False),
            ("Q21", queries[21], False)] + [
        (f"Q{q}", queries[q], False) for q in (1, 4, 5, 9, 12)] + [
        (name, getattr(cs, name), False)
        for name in ("X1", "D1", "D2", "R1", "R2", "F1", "F2")] + [
        ("PX4_Q18", queries[18], True), ("PX4_SORT", PX_SORT, True),
        ("PX4_DISTINCT", PX_DISTINCT, True)]


def main() -> int:
    got = bench_ab.start("bench_stmts", reps=9)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    from oceanbase_tpu_torch.engine.session import Session
    from oceanbase_tpu_torch.models.tpch import datagen, sql_suite
    from oceanbase_tpu_torch.parallel.mesh import make_mesh
    from oceanbase_tpu_torch.parallel.px import PxExecutor
    from oceanbase_tpu_torch.sql.parser import parse
    from oceanbase_tpu_torch.sql.planner import Planner

    kernels.build()
    tables = datagen.generate(sf=SF, seed=SEED)
    uk = sql_suite.UNIQUE_KEYS
    sess = Session(tables, unique_keys=uk, device="cuda")
    px = PxExecutor(tables, make_mesh(PX_SHARDS, devices=[dev] * PX_SHARDS),
                    unique_keys=uk, broadcast_threshold=PX_BROADCAST_THRESHOLD)
    planner = Planner(tables)
    for name, text, on_px in statements(sql_suite.QUERIES):
        if on_px:
            prepared = px.prepare(planner.plan(parse(text)).plan)

            def run(prepared=prepared):
                return int(prepared.run().nrows)
        else:
            def run(text=text):
                return sess.sql(text).nrows

        def wall(fn):
            t0 = time.perf_counter()
            rows = fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, rows

        cold, rows = wall(run)
        torch.cuda.reset_peak_memory_stats()
        warm = [wall(run)[0] for _ in range(reps)]
        peak = torch.cuda.max_memory_allocated()
        per = bench_ab.device_kernels(torch, run, 1)
        bench_ab.report(
            torch, root, statement=name, rows=rows, cold_ms=cold,
            warm_ms=warm, warm_median_ms=statistics.median(warm),
            peak_memory_bytes=peak,
            device_ms=sum(per.values()) if per else None,
            **{f"{k}_ms": sum(v for n, v in per.items()
                              if n.replace("void ", "").startswith(k + "_"))
               if per else None for k in ("k2", "k4", "k10")},
            kernels_ms=per)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
