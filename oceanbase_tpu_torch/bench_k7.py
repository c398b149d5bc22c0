"""Time K7 (the exact top-k candidates) and K31's merge at the shapes that
decide their paths, so two versions can be compared on one card in one
call.

    python3 oceanbase_tpu_torch/bench_k7.py [--root DIR] [--reps N]

K7's inputs, made on the card from SEED: 15,000,000 int64 keys in
[10^5, 5 x 10^7) (Q3's order revenues' range and row count), DESC, c 256,
under sel masks of 3.8% live (Q3's share), 10%, 1%, none, 100 rows; one
value over 50% live rows (a tied first key); and keys in [0, 2^25) at 50%
live (dense values). K31's merge: 40 gathered pairs to k 10 (the sharded
ANN leg's call). `--root` and the parent / change order are as
`bench_ab.py` says. Each result is held to its plain version bit for bit
first. Prints one JSON line: the root, the card, and for each shape the
mean milliseconds of `reps` calls (`bench_ab.timed`), `torch.topk`'s (the
yardstick; `torch.topk` + an index for the merge), K7's path (read back
from the device where the checkout has `topk_candidates_traced`) and the
device microseconds of each of its kernels a call (torch.profiler).
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

ROWS = 15_000_000
C = 256
SEED = 7
LIVE = (("q3", 0.038), ("10pct", 0.10), ("1pct", 0.01), ("none", 0.0))


def kernel_us(torch, fn, calls: int = 10) -> dict:
    """Device microseconds of each kernel a call of fn, from a trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0]: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> int:
    got = bench_ab.start("bench_k7", reps=20)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    g = torch.Generator(device=dev).manual_seed(SEED)
    rev = torch.randint(10**5, 5 * 10**7, (ROWS,), device=dev, generator=g)
    shapes = []
    for name, share in LIVE:
        shapes.append((name, rev,
                       torch.rand(ROWS, device=dev, generator=g) < share))
    few = torch.zeros(ROWS, dtype=torch.bool, device=dev)
    few[torch.randperm(ROWS, device=dev, generator=g)[:100]] = True
    shapes.append(("100_live", rev, few))
    half = torch.rand(ROWS, device=dev, generator=g) < 0.5
    shapes.append(("one_value", torch.full((ROWS,), 1995, device=dev), half))
    shapes.append(("dense", torch.randint(0, 1 << 25, (ROWS,), device=dev,
                                          generator=g), half))
    traced = getattr(kernels, "topk_candidates_traced", None)
    out = {}
    for name, key, sel in shapes:
        res = kernels.topk_candidates(key, sel, True, C)
        want = kernels.topk_candidates_plain(key, sel, True, C)
        if not bench_ab.same(torch, [res[0], res[1]], list(want)):
            print(f"K7 differs from its plain version at {name}",
                  file=sys.stderr)
            return 1
        masked = torch.where(sel, key, torch.iinfo(torch.int64).min)
        out[name] = {
            "live": int(sel.sum()),
            "ms": bench_ab.timed(
                torch, lambda: kernels.topk_candidates(key, sel, True, C),
                reps),
            "topk_ms": bench_ab.timed(torch, lambda: torch.topk(masked, C),
                                      reps),
            "path": traced(key, sel, True, C)[2] if traced else None,
            "kernel_us": kernel_us(
                torch, lambda: kernels.topk_candidates(key, sel, True, C)),
        }
    gd = torch.randn(40, device=dev, generator=g)
    gp = torch.randint(0, 10**6, (40,), device=dev, generator=g,
                       dtype=torch.int32)
    if not bench_ab.same(torch, list(kernels.ann_merge(gd, gp, 10)),
                         list(kernels.ann_merge_plain(gd, gp, 10))):
        print("K31's merge differs from its plain version", file=sys.stderr)
        return 1

    def library():
        v, i = torch.topk(gd, 10, largest=False)
        return v, gp[i]

    merge = {"ms": bench_ab.timed(torch, lambda: kernels.ann_merge(gd, gp,
                                                                   10),
                                  reps * 10),
             "library_ms": bench_ab.timed(torch, library, reps * 10)}
    bench_ab.report(torch, root, rows=ROWS, c=C, k7=out, k31_merge=merge)
    return 0


if __name__ == "__main__":
    sys.exit(main())
