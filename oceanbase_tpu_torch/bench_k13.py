"""Time K13 (the window and bag set-op scans) entry by entry at the shapes
of W1-W3 and U3, so two versions can be compared on one card in one call.

    python3 oceanbase_tpu_torch/bench_k13.py [--root DIR] [--reps N]

The inputs are made on the card from SEED. W (the window statements over
TPC-H SF 10's orders, partitioned by o_custkey and ordered by
o_orderdate): 15,000,576 rows in that order, the customer key ascending
over 1,499,999 values, the date in [0, 2,406) ascending within a
customer, the total price an int64 in [90,000, 55,000,000); the run
flags over (customer, date), then the segment starts and peer ends, the
prefix sum of the prices (int64, and as float64), the running max and the
suffix max within customers, and the frame-bound search of the packed
(rank, date) keys. U3 (INTERSECT ALL of two lineitem sides by
l_suppkey): 119,996,416 rows sorted by (supplier key in [1, 100,000],
side), the run flags over both, the starts, the ends and the prefix sum of
the left side's flags. Every result is held to the plain version
(integers, min/max and marks exactly, float sums within rel 1e-12 of
the running sum of |x|), and each float sum twice, bit for bit. `--root`
and the parent / change order are as `bench_ab.py` says. Prints one JSON
line: the root, the card, and per shape and entry the mean milliseconds
(and `torch.cumsum`'s, `torch.cummax`'s and `torch.searchsorted`'s, the
yardsticks of the sums, the max and the search).
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

SEED = 13
W_ROWS = 15_000_576
U3_ROWS = 119_996_416


def w_inputs(torch, kernels, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = W_ROWS
    cust = torch.randint(1, 1_500_000, (n,), device=dev, generator=g)
    date = torch.randint(0, 2406, (n,), device=dev, generator=g,
                         dtype=torch.int32)
    order = torch.argsort(cust * 4096 + date)
    cust, date = cust[order], date[order]
    price = torch.randint(90_000, 55_000_000, (n,), device=dev, generator=g)
    new_seg = kernels.boundaries_plain([cust])
    new_peer = kernels.boundaries_plain([cust, date])
    rank = kernels.prefix_sum_plain(new_seg.to(torch.int64)) - 1
    packed = rank * 4096 + date.to(torch.int64)
    target = packed - 30
    return {
        "boundaries": ("boundaries", ([cust, date],)),
        "segment_starts": ("segment_starts", (new_seg,)),
        "peer_ends": ("peer_ends", (new_peer,)),
        "prefix_sum": ("prefix_sum", (price,)),
        "prefix_sum_f64": ("prefix_sum", (price.to(torch.float64) / 100,)),
        "segmented_max": ("segmented_scan_minmax", (price, new_seg, False)),
        "suffix_max": ("suffix_scan_minmax", (price, new_seg, False)),
        "bound_search": ("bound_search", (packed, target)),
    }


def u3_inputs(torch, kernels, dev):
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n = U3_ROWS
    supp = torch.randint(1, 100_001, (n,), device=dev, generator=g)
    left = torch.rand(n, device=dev, generator=g) < 0.5
    key = supp * 2 + (~left).to(torch.int64)
    order = torch.argsort(key)
    supp, left = supp[order], left[order]
    new_run = kernels.boundaries_plain([supp, left])
    return {
        "boundaries": ("boundaries", ([supp, left],)),
        "segment_starts": ("segment_starts", (new_run,)),
        "peer_ends": ("peer_ends", (new_run,)),
        "prefix_sum": ("prefix_sum", (left.to(torch.int64),)),
    }


def held(torch, got, want, x=None) -> bool:
    """Integers and min/max by value (NaN where the plain version has
    NaN), float sums within rel 1e-12 of the running sum of |x|."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.dtype.is_floating_point:
        return bool(torch.equal(got, want))
    if x is None:
        nan = torch.isnan(want)
        return bool(torch.equal(torch.isnan(got), nan)
                    and (got[~nan] == want[~nan]).all())
    scale = torch.cumsum(x.to(torch.float64).abs(), 0)
    return bool(((got - want).abs() <= 1e-12 * scale).all())


def main() -> int:
    got = bench_ab.start("bench_k13", reps=10)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    res = {}
    for shape, make in (("w", w_inputs), ("u3", u3_inputs)):
        rec = {}
        inputs = make(torch, kernels, dev)
        for name, (fn, args) in inputs.items():
            kern = getattr(kernels, fn)
            out = kern(*args)
            want = getattr(kernels, fn + "_plain")(*args)
            is_sum = fn == "prefix_sum" and out.dtype.is_floating_point
            if not held(torch, out, want, args[0] if is_sum else None):
                print(f"K13 {shape} {name} differs from the plain version",
                      file=sys.stderr)
                return 1
            if is_sum and not torch.equal(out, kern(*args)):
                print(f"K13 {shape} {name}: two runs differ",
                      file=sys.stderr)
                return 1
            rec[name] = bench_ab.timed(torch, lambda: kern(*args), reps)
        if shape == "w":
            (price,) = inputs["prefix_sum"][1]
            packed, target = inputs["bound_search"][1]
            rec["cumsum_lib"] = bench_ab.timed(
                torch, lambda: torch.cumsum(price, 0), reps)
            rec["cummax_lib"] = bench_ab.timed(
                torch, lambda: torch.cummax(price, 0), reps)
            rec["searchsorted_lib"] = bench_ab.timed(
                torch, lambda: torch.searchsorted(packed, target), reps)
        rec["total"] = sum(v for k, v in rec.items()
                           if not k.endswith("_lib"))
        res[shape] = rec
        del inputs
        torch.cuda.empty_cache()
    bench_ab.report(torch, root, k13=res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
