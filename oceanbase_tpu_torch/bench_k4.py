"""Time K4 (the multi-column row gather) at the shapes the main path gives
it, so two versions of the kernel can be compared on one card in one call.

    python3 oceanbase_tpu_torch/bench_k4.py [--root DIR] [--reps N]

The lineitem columns are `bench_k3.s1_columns`' (SF 10: 59,998,208 rows
of capacity, zero padding past the table's 59,997,999, made on the card
from bench_k3.SEED). Shapes:

- s1: S1's Sort payload (l_orderkey int64, l_linenumber int8,
  l_extendedprice int64, l_shipdate int32, the filter as sel) by K3's
  order (price DESC, orderkey, linenumber; dead rows last, by their keys
  too, so a random permutation of the table);
- monotone: the same payload by the compaction order of S1's filter
  (live rows first, then the dead ones, each in row order);
- u3: U3's gather (l_suppkey int32, live, side int32) over both sides'
  concatenation (119,996,416 rows; each side live where l_shipmode is
  one of seven modes), by its whole-row order;
- small: a 4,096-row top-k gather of S1's payload (the first rows of
  K3's order) from the 60M-row columns;
- wide: S1's payload and four more int64 columns (54 bytes a row) by
  K3's order, a payload past 32 bytes (one 64-byte image);
- single: one int64 column of 15,000,000 rows (orders at SF 10) by a
  random order, as the window statements (W1, W2) gather each function's
  argument: one column, so the direct path;
- q20: Q20's group-by gather, two columns (an int64 key and the filter,
  9 bytes a row) over lineitem's capacity by K3's order of the key (a
  part-supplier pair, 1994's rows live);
- q15: Q15's, an int32 key (l_suppkey) and the filter (5 bytes a row) by
  K3's order of the key (one quarter's rows live);
- random ...: the SWEEP's gathers of random bytes by a random
  permutation, two or three columns over 4M-30M rows, where the route's
  cutoffs by source size and columns lie;
- half random ...: MIXED's, half the rows first in random order and the
  rest in row order (a PX shard's DISTINCT and range sort gather so);
- random ... of ...: EXPAND's, more random rows than the source holds.

`--root` and the parent / change order are as `bench_ab.py` says. Every
call is held to the plain version bit for bit first. Prints one JSON line
a shape: the root, the card, the shape, the rows gathered and the
source's, the payload's bytes a row, the path the wrapper took (read back
from the device, `kernels.k4_launch` with trace, where the checkout has
it), the mean milliseconds of `reps` calls (`bench_ab.timed`),
`index_select`'s (one call a column, the same gather), torch.profiler's
device ms by kernel over PROFILED calls and their sum (`device_ms`), the
host wait (`ms - device_ms`), and, where the checkout has `k4_launch`,
each route's mean ms with the shape's route set to it (`routes`: "image"
and "direct"; the probe still decides on the image route, and the path
that ran is beside each time).
"""

import sys

try:
    from . import bench_ab, bench_k3
except ImportError:
    import bench_ab
    import bench_k3

PROFILED = 5
SMALL_ROWS = 4096
U3_MODES = 7
ORDERS_ROWS = 15_000_000
# random gathers at the route's edges: element widths, source rows (m = n)
SWEEP = (([8, 1], 4_000_000), ([8, 1], 15_000_000), ([8, 1], 30_000_000),
         ([4, 1], 8_000_000), ([4, 1], 15_000_000), ([4, 1], 30_000_000),
         ([4, 4, 1], 4_000_000), ([4, 4, 1], 15_000_000))
# half random gathers (PX4_DISTINCT's and PX4_SORT's per shard at SF 10)
MIXED = (([4, 1], 30_000_000), ([8, 1, 4, 1], 30_000_000))
# random gathers of more rows than the source holds: widths, source rows,
# output rows a source row (F1's [8,4] over 15M orders, twice over; a
# small source many times over)
EXPAND = (([8, 4], 15_000_000, 2), ([8, 8], 2_000_000, 10))
# days since 1970-01-01: Q20's year of ship dates, Q15's quarter
YEAR_1994 = (8766, 9131)
QUARTER_1996 = (9496, 9587)


def _payload(c):
    return [c["okey"], c["line"], c["price"], c["ship"], c["live"]]


def s1(torch, kernels, c):
    order = kernels.sort_order([c["price"], c["okey"], c["line"]],
                               [True, False, False], c["live"])
    return _payload(c), order


def monotone(torch, kernels, c):
    return _payload(c), kernels.sort_order([], [], c["live"])


def small(torch, kernels, c):
    cols, order = s1(torch, kernels, c)
    return cols, order[:SMALL_ROWS].contiguous()


def wide(torch, kernels, c):
    cols, order = s1(torch, kernels, c)
    g = torch.Generator(device=order.device).manual_seed(bench_k3.SEED + 1)
    n = order.shape[0]
    extra = [torch.randint(-(1 << 62), 1 << 62, (n,), device=order.device,
                           generator=g) for _ in range(4)]
    return cols + extra, order


def u3(torch, kernels, c):
    dev = c["live"].device
    n = c["live"].shape[0]
    g = torch.Generator(device=dev).manual_seed(bench_k3.SEED + 2)
    supp = torch.randint(1, 100_001, (n,), device=dev, generator=g,
                         dtype=torch.int32)
    supp[bench_k3.LINEITEM_ROWS:] = 0
    mode = torch.randint(0, U3_MODES, (n,), device=dev, generator=g)
    real = torch.arange(n, device=dev) < bench_k3.LINEITEM_ROWS
    vals = torch.cat([supp, supp])
    live = torch.cat([(mode == 0) & real, (mode == 1) & real])
    side = torch.cat([torch.zeros(n, dtype=torch.int32, device=dev),
                      torch.ones(n, dtype=torch.int32, device=dev)])
    order = kernels.sort_order([vals, side], [False, False], live)
    return [vals, live, side], order


def single(torch, kernels, c):
    dev = c["live"].device
    g = torch.Generator(device=dev).manual_seed(bench_k3.SEED + 3)
    col = torch.randint(-(1 << 62), 1 << 62, (ORDERS_ROWS,), device=dev,
                        generator=g)
    order = torch.randperm(ORDERS_ROWS, device=dev, generator=g)
    return [col], order.to(torch.int32)


def _keyed(torch, kernels, key, live):
    return [key, live], kernels.sort_order([key], [False], live)


def q20(torch, kernels, c):
    dev = c["live"].device
    n = c["live"].shape[0]
    g = torch.Generator(device=dev).manual_seed(bench_k3.SEED + 4)
    part = torch.randint(1, 2_000_001, (n,), device=dev, generator=g)
    supp = torch.randint(1, 100_001, (n,), device=dev, generator=g)
    key = part * 100_001 + supp
    live = (c["ship"] >= YEAR_1994[0]) & (c["ship"] < YEAR_1994[1])
    key[bench_k3.LINEITEM_ROWS:] = 0
    return _keyed(torch, kernels, key, live)


def q15(torch, kernels, c):
    dev = c["live"].device
    n = c["live"].shape[0]
    g = torch.Generator(device=dev).manual_seed(bench_k3.SEED + 5)
    supp = torch.randint(1, 100_001, (n,), device=dev, generator=g,
                         dtype=torch.int32)
    live = (c["ship"] >= QUARTER_1996[0]) & (c["ship"] < QUARTER_1996[1])
    supp[bench_k3.LINEITEM_ROWS:] = 0
    return _keyed(torch, kernels, supp, live)


def random_gather(widths, rows, mixed=False, times=1):
    """Columns of these widths and `rows` random bytes each, by a random
    permutation: the route's cutoffs by source size and columns. With
    `mixed`, half the rows (at random) come first in random order, the
    rest after them in row order, as a PX shard's sort of its receive
    lanes orders live rows and then dead ones. With `times` > 1, rows x
    times random rows (a join's expansion)."""
    def make(torch, kernels, c):
        dev = c["live"].device
        g = torch.Generator(device=dev).manual_seed(bench_k3.SEED + 6)
        kind = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}
        cols = [torch.randint(0, 256, (rows * w,), dtype=torch.uint8,
                              device=dev, generator=g).view(kind[w])
                for w in widths]
        order = torch.randperm(rows, device=dev, generator=g)
        if times > 1:
            order = torch.randint(0, rows, (rows * times,), device=dev,
                                  generator=g)
        if mixed:
            live = torch.rand(rows, device=dev, generator=g) < 0.5
            order = torch.cat([order[live[order]],
                               torch.nonzero(~live).squeeze(1)])
        return cols, order.to(torch.int32)
    return make


SHAPES = (("s1", s1), ("monotone", monotone), ("u3", u3),
          ("small", small), ("wide", wide), ("single", single),
          ("q20", q20), ("q15", q15)) + tuple(
    (f"random {'+'.join(map(str, w))} B x {rows}", random_gather(w, rows))
    for w, rows in SWEEP) + tuple(
    (f"half random {'+'.join(map(str, w))} B x {rows}",
     random_gather(w, rows, mixed=True)) for w, rows in MIXED) + tuple(
    (f"random {'+'.join(map(str, w))} B x {rows * t} of {rows}",
     random_gather(w, rows, times=t)) for w, rows, t in EXPAND)


def main() -> int:
    got = bench_ab.start("bench_k4", reps=20)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    traced = hasattr(kernels, "k4_launch")
    c = bench_k3.s1_columns(torch, dev)
    for shape, make in SHAPES:
        cols, idx = make(torch, kernels, c)
        want = kernels.gather_columns_plain(cols, idx)
        if not bench_ab.same(torch, kernels.gather_columns(cols, idx), want):
            print(f"K4 differs from its plain version at {shape}",
                  file=sys.stderr)
            return 1
        del want
        ms = bench_ab.timed(torch, lambda: kernels.gather_columns(cols, idx),
                            reps)
        lib = bench_ab.timed(
            torch, lambda: [x.index_select(0, idx) for x in cols], reps)
        per = bench_ab.device_kernels(
            torch, lambda: kernels.gather_columns(cols, idx), PROFILED)
        dms = sum(per.values()) if per else None
        routes = {}
        if traced:
            path = kernels.k4_launch(cols, idx, trace=True)[1]
            for r in ("image", "direct"):
                got_r, ran = kernels.k4_launch(cols, idx, route=r,
                                               trace=True)
                if not bench_ab.same(torch, got_r,
                                     kernels.gather_columns_plain(cols,
                                                                  idx)):
                    print(f"K4's {r} route differs from its plain version "
                          f"at {shape}", file=sys.stderr)
                    return 1
                del got_r
                routes[r] = {"path": ran, "ms": bench_ab.timed(
                    torch, lambda r=r: kernels.k4_launch(cols, idx,
                                                         route=r), reps)}
        else:
            path = "one launch"
        bench_ab.report(
            torch, root, shape=shape, rows=int(idx.shape[0]),
            source_rows=int(cols[0].shape[0]),
            payload=sum(x.element_size() for x in cols), path=path, ms=ms,
            index_select_ms=lib, device_ms=dms,
            host_wait_ms=None if dms is None else ms - dms, kernels_ms=per,
            routes=routes)
        del cols, idx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
