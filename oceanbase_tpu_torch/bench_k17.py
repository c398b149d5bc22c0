"""Time K17 (the range slice of a sorted-projection scan) at the shape of
TPC-H Q6's sliced scan at SF 10, so two versions of the kernel can be
compared on one card in one call.

    python3 oceanbase_tpu_torch/bench_k17.py [--root DIR] [--reps N]

The inputs: 59,986,052 sorted int32 ship dates (lineitem's row count at SF
10, uniform over TPC-H's ship-date days), the year 1994 as one low and one
high bound (0-d int32 tensors on the card, as Q6's literals), the slice
capacity the projection router gives that range, and the four planes Q6
reads (l_shipdate, l_quantity and l_discount int32, l_extendedprice
int64), every row live. `--root` and the parent / change order are as
`bench_ab.py` says. The kernel's result is held to its plain version bit
for bit first. Prints one JSON line: the root, the card, the mean
milliseconds of `reps` calls back to back (`bench_ab.timed`), the medians
of K17 and of its yardstick (searchsorted, a host read, then
`narrow().clone()` of each plane, as chip_smoke's K17 record) timed in
turns over `ROUNDS` single calls (`bench_ab.interleaved`: a single call's
host work is in its time), the yardstick's mean back to back, the rows
and the slice capacity.
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

ROWS = 59_986_052
DAY0, DAY1 = 8036, 10561  # 1992-01-02 .. 1998-12-01, days since 1970
LOW, HIGH = 8766, 9131  # 1994-01-01, 1995-01-01
SEED = 6
ROUNDS = 200


def main() -> int:
    got = bench_ab.start("bench_k17", reps=50)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    g = torch.Generator(device=dev).manual_seed(SEED)
    key = torch.randint(DAY0, DAY1 + 1, (ROWS,), device=dev, generator=g,
                        dtype=torch.int32).sort().values
    lo = int(torch.searchsorted(key, torch.tensor([LOW], device=dev)))
    hi = int(torch.searchsorted(key, torch.tensor([HIGH], device=dev)))
    # the router's capacity for a range of (hi - lo) rows
    cap = -(-int((hi - lo) * 1.25 + 1024) // 1024) * 1024
    lows = [(torch.tensor(LOW, dtype=torch.int32, device=dev), "left")]
    highs = [(torch.tensor(HIGH, dtype=torch.int32, device=dev), "left")]
    pay = [key,
           torch.randint(100, 5100, (ROWS,), device=dev, generator=g,
                         dtype=torch.int32),
           torch.randint(90_000, 10_500_000, (ROWS,), device=dev,
                         generator=g, dtype=torch.int64),
           torch.randint(0, 11, (ROWS,), device=dev, generator=g,
                         dtype=torch.int32)]
    sel = torch.ones(ROWS, dtype=torch.bool, device=dev)

    def run(fn):
        outs, osel, nrows, ovf = fn(key, ROWS, lows, highs, cap, pay, sel)
        return [*outs, osel, nrows, ovf]

    if not bench_ab.same(torch, run(kernels.slice_scan),
                         run(kernels.slice_scan_plain)):
        print("K17 differs from its plain version", file=sys.stderr)
        return 1
    def library():
        start = min(int(torch.searchsorted(key, lows[0][0].reshape(1))),
                    ROWS - cap)
        return [c.narrow(0, start, cap).clone() for c in [*pay, sel]]

    ms = bench_ab.timed(torch, lambda: run(kernels.slice_scan), reps)
    lib_ms = bench_ab.timed(torch, library, reps)
    turn_ms, turn_lib = bench_ab.interleaved(
        torch, [lambda: run(kernels.slice_scan), library], ROUNDS)
    bench_ab.report(torch, root, ms=ms, library_ms=lib_ms,
                    interleaved={"rounds": ROUNDS, "ms_median": turn_ms,
                                 "library_ms_median": turn_lib},
                    rows=ROWS, cap=cap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
