"""Time K8 (the segmented reduce-by-key of the sort group-by) at two
shapes, so two versions of the kernel can be compared on one card in one
call.

    python3 oceanbase_tpu_torch/bench_k8.py [--root DIR] [--reps N]

The inputs, made on the card from SEED, at lineitem's capacity at SF 10
(59,998,208 rows):

- q7, the sparse shape chip_smoke times: three int32 keys (two nation
  codes in [0, 25) and a year in 1992..1998) and one int64 sum; about
  55,000 rows live (Q7's two-nation, two-year filter), sorted first;
- dense, the shape of Q17's correlated group-by (its avg(l_quantity)):
  one int32 key of about 2,000,000 distinct values (l_partkey at SF 10),
  every row live, the sum of an int32 value (l_quantity) and a count,
  both under a bool mask (the value's validity, every row valid).

Each is sorted on the card (live rows first, then the keys), the keys and
sel gathered in sorted order, and the values left in row order (K8 reads
them through the order). `--root` and the parent / change order are as
`bench_ab.py` says. The kernel's result is held to its plain version bit
for bit first. Prints one JSON line a shape: the root, the card, the
shape, the mean milliseconds of `reps` calls (`bench_ab.timed`), the
rows, live rows and groups.
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

ROWS = 59_998_208
Q7_LIVE = 55_000
PARTS = 2_000_000
SEED = 8


def q7_inputs(torch, dev, g):
    sk = torch.randint(0, 25, (ROWS,), device=dev, generator=g,
                       dtype=torch.int32)
    ck = torch.randint(0, 25, (ROWS,), device=dev, generator=g,
                       dtype=torch.int32)
    yr = torch.randint(1992, 1999, (ROWS,), device=dev, generator=g,
                       dtype=torch.int32)
    live = torch.rand(ROWS, device=dev, generator=g) < Q7_LIVE / ROWS
    vol = torch.randint(90_000, 10_500_000, (ROWS,), device=dev,
                        generator=g, dtype=torch.int64) * 90
    packed = (((~live).to(torch.int64) << 60) | (sk.to(torch.int64) << 40)
              | (ck.to(torch.int64) << 20) | yr.to(torch.int64))
    order = torch.sort(packed, stable=True).indices
    o = order
    return ([sk[o], ck[o], yr[o]], live[o], order.to(torch.int32),
            [("sum", vol, None)])


def dense_inputs(torch, dev, g):
    pk = torch.randint(1, PARTS + 1, (ROWS,), device=dev, generator=g,
                       dtype=torch.int32)
    qty = torch.randint(100, 5100, (ROWS,), device=dev, generator=g,
                        dtype=torch.int32)
    valid = torch.ones(ROWS, dtype=torch.bool, device=dev)
    order = torch.sort(pk, stable=True).indices
    live = torch.ones(ROWS, dtype=torch.bool, device=dev)
    return ([pk[order]], live, order.to(torch.int32),
            [("sum", qty, valid), ("count", None, valid)])


SHAPES = (("q7", q7_inputs), ("dense", dense_inputs))


def main() -> int:
    got = bench_ab.start("bench_k8", reps=30)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    for shape, make in SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED)
        skeys, ssel, order, aggs = make(torch, dev, g)

        def run(fn):
            sel, res = fn(skeys, ssel, order, aggs)
            return [sel, *res]

        out = run(kernels.segmented_reduce)
        if not bench_ab.same(torch, out,
                             run(kernels.segmented_reduce_plain)):
            print(f"K8 differs from its plain version at {shape}",
                  file=sys.stderr)
            return 1
        groups = int(out[0].sum())
        ms = bench_ab.timed(torch, lambda: run(kernels.segmented_reduce),
                            reps)
        bench_ab.report(torch, root, shape=shape, ms=ms, rows=ROWS,
                        live=int(ssel.sum()), groups=groups)
        del skeys, ssel, order, aggs, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
