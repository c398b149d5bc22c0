"""Time K15 (the first rows of DISTINCT runs) and the DISTINCT mask around
it at D1's and D2's shapes, so two versions can be compared on one card in
one call.

    python3 oceanbase_tpu_torch/bench_k15.py [--root DIR] [--reps N]

The inputs are made on the card from SEED. D1 (count(DISTINCT l_suppkey)
and sum(DISTINCT l_quantity) by l_returnflag, l_linestatus over TPC-H SF
10's lineitem): 59,998,208 rows (the table's capacity), 98% live, the
flag in [0, 3) and the status in [0, 2) as int32 dictionary codes, the
supplier key in [1, 100,000] and the quantity in 100..5,000 (scaled by
100) as int64. D2 (grouped approx_count_distinct(o_custkey) by
o_orderpriority, run as an exact first-occurrence count): 15,000,576
rows, every row live, the priority in [0, 5), the customer key in [1,
1,499,999]. "unique": the D1 rows with a value unique to each row (every
live row starts a run: 59M random byte writes). For each shape: the whole
mask (`ops.hashagg.distinct_first_mask`: K3 + K15, the path the
executor runs), then K15 alone on the order the parent's kernel walks
and, where the checkout has them, each route (`first_occurrence_images`
on K3's images; the record and columns routes forced) with K3's time
with images and with the order; `torch.unique(return_inverse)` of the
packed keys as the yardstick. Every result is held to
`first_occurrence_plain` bit for bit first. `--root` and the parent /
change order are as `bench_ab.py` says. Prints one JSON line: the root,
the card, and per shape the mean milliseconds of each call and the route
K15 took.
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

SEED = 17
D1_ROWS = 59_998_208
D2_ROWS = 15_000_576


def shapes(torch, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)

    def ints(lo, hi, n, dtype=torch.int64):
        return torch.randint(lo, hi, (n,), device=dev, generator=g,
                             dtype=dtype)

    n = D1_ROWS
    live = torch.rand(n, device=dev, generator=g) < 0.98
    flag, status = ints(0, 3, n, torch.int32), ints(0, 2, n, torch.int32)
    out = {
        "d1_suppkey": ([flag, status], ints(1, 100_001, n), live),
        "d1_quantity": ([flag, status], ints(1, 51, n) * 100, live),
        "unique": ([flag, status], torch.randperm(n, device=dev,
                                                   generator=g), live),
    }
    m = D2_ROWS
    out["d2"] = ([ints(0, 5, m, torch.int32)], ints(1, 1_500_000, m),
                 torch.ones(m, dtype=torch.bool, device=dev))
    return out


def main() -> int:
    got = bench_ab.start("bench_k15", reps=10)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    from oceanbase_tpu_torch.ops.hashagg import distinct_first_mask

    images = getattr(kernels, "sort_order_images", None)
    res = {}
    for name, (dk, v, live) in shapes(torch, dev).items():
        cols = [*dk, v]
        desc = [False] * len(cols)
        order = kernels.sort_order(cols, desc, live)
        want = kernels.first_occurrence_plain(cols, live, order)
        if not bench_ab.same(torch, [distinct_first_mask(dk, v, live)],
                             [want]):
            print(f"the DISTINCT mask differs from the plain version at "
                  f"{name}", file=sys.stderr)
            return 1
        packed = torch.zeros_like(v)
        for c in cols:
            packed = packed * 1_000_003 + c.to(torch.int64)
        rec = {
            "rows": int(live.shape[0]), "live": int(live.sum()),
            "mask_ms": bench_ab.timed(
                torch, lambda: distinct_first_mask(dk, v, live), reps),
            "k3_order_ms": bench_ab.timed(
                torch, lambda: kernels.sort_order(cols, desc, live), reps),
            "unique_ms": bench_ab.timed(
                torch, lambda: torch.unique(packed, return_inverse=True),
                reps),
        }
        if images is None:  # the parent: one route, the columns walk
            rec["route"] = "columns"
            rec["k15_ms"] = bench_ab.timed(
                torch, lambda: kernels.first_occurrence(cols, live, order),
                reps)
        else:
            s = images(cols, desc, live)
            rec["route"] = s.route
            rec["k3_images_ms"] = bench_ab.timed(
                torch, lambda: images(cols, desc, live), reps)
            if s.images is not None:
                if not bench_ab.same(
                        torch, [kernels.first_occurrence_images(s)], [want]):
                    print(f"K15's image route differs at {name}",
                          file=sys.stderr)
                    return 1
                rec["k15_ms"] = bench_ab.timed(
                    torch, lambda: kernels.first_occurrence_images(s), reps)
            for route in ("record", "columns"):
                got_r = kernels.first_occurrence(cols, live, order, route)
                if not bench_ab.same(torch, [got_r], [want]):
                    print(f"K15's {route} route differs at {name}",
                          file=sys.stderr)
                    return 1
                rec[f"{route}_ms"] = bench_ab.timed(
                    torch,
                    lambda: kernels.first_occurrence(cols, live, order,
                                                     route), reps)
        rec["runs"] = int(want.sum())
        res[name] = rec
    bench_ab.report(torch, root, k15=res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
