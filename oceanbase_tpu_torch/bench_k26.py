"""Time K26 (the receive half of a PX exchange) at the shape of the PX
range sort's receive at SF 10, so two versions of the kernel can be
compared on one card in one call.

    python3 oceanbase_tpu_torch/bench_k26.py [--root DIR] [--reps N]

The inputs, made on the card from SEED: 4 senders, each holding two lanes
of 30,001,152 rows of every plane, received at lane 1 into 4 x 30,001,152
rows at out_base 0. The planes' types are those of the sort's receive
that chip_smoke records for K26 (l_orderkey int64, l_linenumber int8,
l_shipdate int32, the row mask bool: 14 bytes a row). `--root` and the
parent / change order are as `bench_ab.py` says. The kernel's result is
held to its plain version bit for bit first. Prints one JSON line: the
root, the card, the mean milliseconds of `reps` calls
(`bench_ab.timed`), the same for torch.cat of the lane slices (the
yardstick), and the bytes read and written.
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

ROWS = 30_001_152
SENDERS = 4
LANE = 1
DTYPES = ("int64", "int8", "int32", "bool")
SEED = 26


def main() -> int:
    got = bench_ab.start("bench_k26", reps=30)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    g = torch.Generator(device=dev).manual_seed(SEED)
    dtypes = [getattr(torch, d) for d in DTYPES]
    n = (LANE + 1) * ROWS
    senders = []
    for dt in dtypes:
        if dt == torch.bool:
            blocks = [torch.rand(n, device=dev, generator=g) < 0.5
                      for _ in range(SENDERS)]
        else:
            hi = min(torch.iinfo(dt).max, 1 << 40)
            blocks = [torch.randint(0, hi, (n,), device=dev, generator=g,
                                    dtype=dt) for _ in range(SENDERS)]
        senders.append(blocks)
    outs = [torch.empty(SENDERS * ROWS, dtype=dt, device=dev)
            for dt in dtypes]
    want = [torch.zeros_like(o) for o in outs]
    kernels.exchange_recv(senders, ROWS, LANE, outs)
    kernels.exchange_recv_plain(senders, ROWS, LANE, want)
    if not bench_ab.same(torch, outs, want):
        print("K26 differs from its plain version", file=sys.stderr)
        return 1
    del want

    def cat():
        return [torch.cat([b[LANE * ROWS:(LANE + 1) * ROWS] for b in p])
                for p in senders]

    ms = bench_ab.timed(
        torch, lambda: kernels.exchange_recv(senders, ROWS, LANE, outs),
        reps)
    cat_ms = bench_ab.timed(torch, cat, reps)
    nbytes = 2 * SENDERS * ROWS * sum(o.element_size() for o in outs)
    bench_ab.report(torch, root, ms=ms, cat_ms=cat_ms, rows=ROWS,
                    senders=SENDERS, lane=LANE, dtypes=list(DTYPES),
                    bytes=nbytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
