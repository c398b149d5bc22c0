"""Time K2 (the direct-addressed GROUP BY) at two shapes, so two versions
of the kernel can be compared on one card in one call.

    python3 oceanbase_tpu_torch/bench_k2.py [--root DIR] [--reps N]

The inputs, made on the card from SEED:

- q1, the shape chip_smoke times (TPC-H Q1 at SF 10): 59,997,999 lineitem
  rows in a capacity of 59,998,208; the dense slot of (l_returnflag,
  l_linestatus), 3 x 2 = 6 slots in 8 packed ones, four of them reached as
  TPC-H's data reaches them (A/F, R/F 25% each, N/O 49%, N/F 1%); the
  ship-date filter live on 98.6% of the rows; Q1's ten aggregates as the
  executor hands them over (a count, sums of int32 l_quantity and
  l_discount, of int64 l_extendedprice and two int64 products, and five
  more counts under the same mask);
- r2, the shape of R2 (`group by cube(o_orderstatus, o_orderpriority)`
  over 15,000,000 orders at SF 10): the grouping sets' three calls, over
  3 x 5, 3 and 5 dense slots (32, 4 and 8 packed), each two counts and
  an int64 sum of o_totalprice, timed as one step.

`--root` and the parent / change order are as `bench_ab.py` says. The
kernel's results are held to its plain version bit for bit first. Prints
one JSON line a shape: the root, the card, the shape, the mean
milliseconds of `reps` calls (`bench_ab.timed`), the device ms by kernel
(`bench_ab.device_kernels`), the library's mean ms (`index_add_` an
aggregate, as chip_smoke's K2 record), rows and aggregates.
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

ROWS = 59_997_999
CAPACITY = 59_998_208
ORDERS = 15_000_000
SEED = 2


def q1_calls(torch, dev, g):
    u = torch.rand(CAPACITY, device=dev, generator=g)
    # dense slot = returnflag + 3 * linestatus; A 0, N 1, R 2; F 0, O 1
    slot = torch.where(u < 0.25, 0, torch.where(u < 0.50, 2, torch.where(
        u < 0.51, 1, 4)))
    keys = slot.to(torch.int32)
    live = torch.arange(CAPACITY, device=dev) < ROWS
    mask = live & (torch.rand(CAPACITY, device=dev, generator=g) < 0.986)
    qty = torch.randint(100, 5100, (CAPACITY,), device=dev, generator=g,
                        dtype=torch.int32)
    price = torch.randint(90_000, 10_500_000, (CAPACITY,), device=dev,
                          generator=g, dtype=torch.int64)
    disc = torch.randint(0, 11, (CAPACITY,), device=dev, generator=g,
                         dtype=torch.int32)
    tax = torch.randint(0, 9, (CAPACITY,), device=dev, generator=g,
                        dtype=torch.int64)
    dp = price * (100 - disc.to(torch.int64))
    ch = dp * (100 + tax)
    aggs = [("count", None, mask), ("sum", qty, mask), ("sum", price, mask),
            ("sum", dp, mask), ("sum", ch, mask), ("count", None, mask),
            ("count", None, mask), ("sum", disc, mask),
            ("count", None, mask), ("count", None, mask)]
    return [(keys, [3, 2], aggs)]


def r2_calls(torch, dev, g):
    st = torch.randint(0, 3, (ORDERS,), device=dev, generator=g,
                       dtype=torch.int32)
    pr = torch.randint(0, 5, (ORDERS,), device=dev, generator=g,
                       dtype=torch.int32)
    mask = torch.ones(ORDERS, device=dev, dtype=torch.bool)
    total = torch.randint(90_000, 50_000_000, (ORDERS,), device=dev,
                          generator=g, dtype=torch.int64)
    aggs = [("count", None, mask), ("count", None, mask),
            ("sum", total, mask)]
    return [((st + 3 * pr).contiguous(), [3, 5], aggs), (st, [3], aggs),
            (pr, [5], aggs)]


SHAPES = {"q1": q1_calls, "r2": r2_calls}


def main() -> int:
    got = bench_ab.start("bench_k2", reps=20)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    for name, make in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(SEED)
        calls = make(torch, dev, g)

        def run(fn):
            return [r for keys, doms, aggs in calls
                    for r in fn(keys, doms, aggs)]

        if not bench_ab.same(torch, run(kernels.groupby_slots),
                             run(kernels.groupby_slots_plain)):
            print(f"K2 differs from its plain version at {name}",
                  file=sys.stderr)
            return 1

        def library():
            res = []
            for keys, doms, aggs in calls:
                dense = kernels.k2_layout(doms)[0]
                for op, v, m in aggs:
                    w = m.to(torch.int64) if v is None else torch.where(
                        m, v, 0).to(torch.int64)
                    res.append(torch.zeros(dense, dtype=torch.int64,
                                           device=dev).index_add_(
                                               0, keys.long(), w))
            return res

        ms = bench_ab.timed(torch, lambda: run(kernels.groupby_slots), reps)
        dev_ms = bench_ab.device_kernels(
            torch, lambda: run(kernels.groupby_slots))
        lib_ms = bench_ab.timed(torch, library, max(1, reps // 4))
        bench_ab.report(torch, root, shape=name, ms=ms, device_ms=dev_ms,
                        library_ms=lib_ms, rows=int(calls[0][0].numel()),
                        aggregates=sum(len(a) for _k, _d, a in calls))
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
