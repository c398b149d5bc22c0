"""Time K10 (the M:N join expansion) at three shapes, so two versions of
the kernel can be compared on one card in one call.

    python3 oceanbase_tpu_torch/bench_k10.py [--root DIR] [--reps N]

The inputs, made on the card from SEED:

- q21, the shape chip_smoke times (TPC-H Q21's lineitem l1 against
  lineitem l2 at SF 10): 59,997,999 lineitem rows in a capacity of
  59,998,208, l_orderkey ascending (15,000,000 orders of 1 to 7 lines);
  the build side is those keys sorted (the dead padding last, int64 max),
  the probe side the same keys in row order with 1.49% of the rows live
  (Q21's filtered l1), and the capacity twice the probe rows plus 1,024,
  as the overflow retry settles it (the pairs are about 4.4 million);
- random: 15,000,000 probe rows in random key order, half live, against
  the same build (every tile's window is the whole build);
- skew: a build of 8,000,000 rows whose key 0 holds 2,000,000 of them,
  probed by 4,000,000 rows of which 64 carry key 0 (one run of 2,000,000
  slots a row), the capacity the pairs' total.

`--root` and the parent / change order are as `bench_ab.py` says. The
kernel's six outputs are held to its plain version bit for bit first.
Prints one JSON line a shape: the root, the card, the shape, the mean
milliseconds of `reps` calls (`bench_ab.timed`), the device ms by kernel
(`bench_ab.device_kernels`), the library's mean ms (two searchsorted, a
cumsum and repeat_interleave, as chip_smoke's K10 record), rows, pairs
and the capacity.
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

ROWS = 59_997_999
CAPACITY = 59_998_208
ORDERS = 15_000_000
Q21_LIVE = 0.0149
SEED = 10


def lineitem_keys(torch, dev, g):
    """l_orderkey of ROWS lineitem rows: ORDERS orders of 1 to 7 lines,
    ascending, padded to CAPACITY with int64 max (dead rows)."""
    lines = torch.randint(1, 8, (ORDERS,), device=dev, generator=g)
    keys = torch.repeat_interleave(
        torch.arange(1, ORDERS + 1, device=dev, dtype=torch.int64) * 4,
        lines)[:ROWS]
    if keys.numel() < ROWS:
        extra = torch.arange(ROWS - keys.numel(), device=dev,
                             dtype=torch.int64) + 4 * ORDERS + 4
        keys = torch.cat([keys, extra])
    pad = torch.full((CAPACITY - ROWS,), torch.iinfo(torch.int64).max,
                     device=dev, dtype=torch.int64)
    return torch.cat([keys, pad])


def q21_inputs(torch, dev, g):
    skeys = lineitem_keys(torch, dev, g)
    order = torch.arange(CAPACITY, device=dev, dtype=torch.int32)
    nlive = torch.tensor(ROWS, device=dev, dtype=torch.int64)
    live = torch.rand(CAPACITY, device=dev, generator=g) < Q21_LIVE
    live[ROWS:] = False
    return skeys, order, nlive, skeys.clone(), live, 2 * CAPACITY + 1024


def random_inputs(torch, dev, g):
    skeys = lineitem_keys(torch, dev, g)
    order = torch.randperm(CAPACITY, device=dev, generator=g).to(torch.int32)
    nlive = torch.tensor(ROWS, device=dev, dtype=torch.int64)
    n = 15_000_000
    pk = skeys[torch.randint(0, ROWS, (n,), device=dev, generator=g)]
    live = torch.rand(n, device=dev, generator=g) < 0.5
    return skeys, order, nlive, pk, live, None


def skew_inputs(torch, dev, g):
    nb, hot, npr = 8_000_000, 2_000_000, 4_000_000
    rest = torch.randint(1, 1_000_000, (nb - hot,), device=dev, generator=g)
    skeys = torch.cat([torch.zeros(hot, device=dev, dtype=torch.int64),
                       rest]).sort().values
    order = torch.randperm(nb, device=dev, generator=g).to(torch.int32)
    nlive = torch.tensor(nb, device=dev, dtype=torch.int64)
    pk = torch.randint(1, 1_000_000, (npr,), device=dev, generator=g)
    pk[torch.randint(0, npr, (64,), device=dev, generator=g)] = 0
    pk = pk.sort().values
    live = torch.ones(npr, device=dev, dtype=torch.bool)
    return skeys, order, nlive, pk, live, None


SHAPES = {"q21": q21_inputs, "random": random_inputs, "skew": skew_inputs}


def main() -> int:
    got = bench_ab.start("bench_k10", reps=20)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    for name, make in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(SEED)
        skeys, order, nlive, pk, live, cap = make(torch, dev, g)
        nl = int(nlive)
        if cap is None:  # the pairs' total: no slot past it
            lo = torch.searchsorted(skeys, pk).clamp(max=nl)
            hi = torch.searchsorted(skeys, pk, right=True).clamp(max=nl)
            cap = int(torch.where(live, hi - lo, 0).sum())

        def run(fn):
            return list(fn(skeys, order, nlive, pk, live, cap))

        out = run(kernels.expand_join)
        if not bench_ab.same(torch, out, run(kernels.expand_join_plain)):
            print(f"K10 differs from its plain version at {name}",
                  file=sys.stderr)
            return 1

        def library():
            lo = torch.searchsorted(skeys, pk).clamp(max=nl)
            hi = torch.searchsorted(skeys, pk, right=True).clamp(max=nl)
            cnt = torch.where(live, hi - lo, 0)
            starts = torch.cumsum(cnt, 0) - cnt
            pr = torch.repeat_interleave(cnt)
            t = torch.arange(pr.shape[0], device=dev)
            return pr, order[lo[pr] + t - starts[pr]]

        ms = bench_ab.timed(torch, lambda: run(kernels.expand_join), reps)
        dev_ms = bench_ab.device_kernels(
            torch, lambda: run(kernels.expand_join))
        lib_ms = bench_ab.timed(torch, library, max(1, reps // 4))
        bench_ab.report(torch, root, shape=name, ms=ms, device_ms=dev_ms,
                        library_ms=lib_ms, probe_rows=int(pk.numel()),
                        live=int(live.sum()), build_rows=int(skeys.numel()),
                        pairs=int(out[3]), cap=cap)
        del skeys, order, pk, live, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
