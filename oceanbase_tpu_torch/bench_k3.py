"""Time K3 (the stable radix sort order) at the two shapes chip_smoke
records for it, so two versions of the kernel can be compared on one card
in one call.

    python3 oceanbase_tpu_torch/bench_k3.py [--root DIR] [--reps N]

The inputs follow TPC-H's lineitem as the port's generator makes it
(orders keyed 4, 8, 12, ...; 1-7 lines an order; quantity 1-50; price
quantity x (900 + partkey % 1000 / 10 + 100 (partkey % 10)) in cents; ship
date 1-121 days after an order date in 1992-01-01 .. 1998-07-02), made
from SEED:

- spill, the spill sort's chunk: the first 2^23 rows' (l_shipdate ASC,
  l_orderkey DESC) packed into one uint64 by `ops.spill.pack_sort_key`
  and handed to K3 as its int64 image (`spill.sort_image`), every row
  live; made with numpy on the host;
- s1, the S1 statement's Sort at SF 10: lineitem's capacity (59,998,208
  rows: 59,997,999 of the table, then rows of zeros, dead, as the
  executor pads a table to a multiple of 1024), keys l_extendedprice DESC
  (int64 cents), l_orderkey (int64), l_linenumber (int8), live where
  l_shipdate is 1995-06-17 and l_quantity < 10 (a few thousand rows);
  made on the card.

`--root` and the parent / change order are as `bench_ab.py` says. The
kernel's order is held to its plain version bit for bit first. Prints one
JSON line a shape: the root, the card, the shape, the mean milliseconds of
`reps` calls (`bench_ab.timed`), the yardstick's (spill:
`torch.argsort(img, stable=True)`; s1: chained stable `torch.sort`s, least
significant key first), the rows and the live rows; then, from
torch.profiler over PROFILED calls, each device kernel's milliseconds a
call and their sum (`device_ms`: what the card is busy with; `ms` -
`device_ms` is the time it waits on the host, the span read among it).
"""

import sys

try:
    from . import bench_ab
except ImportError:
    import bench_ab

SPILL_ROWS = 1 << 23
S1_ROWS = 59_998_208
LINEITEM_ROWS = 59_997_999
S1_ORDERS = 15_010_000
START = 8035        # 1992-01-01 in days since 1970-01-01
ORDER_DAYS = 2375   # order dates 1992-01-01 .. 1998-07-02
S1_DAY = 9298       # 1995-06-17
SEED = 3
PROFILED = 5


def spill_inputs(torch, dev):
    import numpy as np

    from oceanbase_tpu_torch.ops import spill

    rng = np.random.default_rng(SEED)
    per = rng.integers(1, 8, SPILL_ROWS // 2)
    order = np.repeat(np.arange(per.shape[0]), per)[:SPILL_ROWS]
    okey = (order + 1) * 4
    ship = START + rng.integers(0, ORDER_DAYS, per.shape[0])[order] \
        + rng.integers(1, 122, SPILL_ROWS)
    pk = spill.pack_sort_key([ship.astype(np.int64), okey.astype(np.int64)],
                             [False, True])
    img = torch.from_numpy(spill.sort_image(pk)).to(dev)
    live = torch.ones(SPILL_ROWS, dtype=torch.bool, device=dev)
    return [img], [False], live


def s1_columns(torch, dev) -> dict:
    """S1's lineitem columns at SF 10 on the card: price, okey, line,
    ship, qty and S1's filter (live), zero past the table's rows."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    per = torch.randint(1, 8, (S1_ORDERS,), device=dev, generator=g)
    first = torch.cumsum(per, 0) - per
    order = torch.repeat_interleave(
        torch.arange(S1_ORDERS, device=dev), per)[:S1_ROWS]
    if order.shape[0] != S1_ROWS:
        raise RuntimeError("bench_k3: too few orders for S1's rows")
    okey = (order + 1) * 4
    line = (torch.arange(S1_ROWS, device=dev) - first[order] + 1).to(
        torch.int8)
    qty = torch.randint(1, 51, (S1_ROWS,), device=dev, generator=g)
    part = torch.randint(1, 2_000_001, (S1_ROWS,), device=dev, generator=g)
    price = qty * (90_000 + (part % 1000) * 10 + 10_000 * (part % 10))
    odate = START + torch.randint(0, ORDER_DAYS, (S1_ORDERS,), device=dev,
                                  generator=g)
    ship = odate[order] + torch.randint(1, 122, (S1_ROWS,), device=dev,
                                        generator=g)
    live = (ship == S1_DAY) & (qty < 10)
    cols = {"price": price, "okey": okey, "line": line,
            "ship": ship.to(torch.int32), "qty": qty, "live": live}
    for c in cols.values():
        c[LINEITEM_ROWS:] = 0
    return cols


def s1_inputs(torch, dev):
    c = s1_columns(torch, dev)
    return [c["price"], c["okey"], c["line"]], [True, False, False], \
        c["live"]


SHAPES = (("spill", spill_inputs), ("s1", s1_inputs))


def main() -> int:
    got = bench_ab.start("bench_k3", reps=20)
    if got is None:
        return 1
    root, reps, torch, kernels, dev = got
    for shape, make in SHAPES:
        keys, desc, live = make(torch, dev)
        order = kernels.sort_order(keys, desc, live)
        if not bench_ab.same(torch, [order],
                             [kernels.sort_order_plain(keys, desc, live)]):
            print(f"K3 differs from its plain version at {shape}",
                  file=sys.stderr)
            return 1
        ms = bench_ab.timed(torch, lambda: kernels.sort_order(keys, desc,
                                                              live), reps)
        if shape == "spill":
            yard = bench_ab.timed(
                torch, lambda: torch.argsort(keys[0], stable=True), reps)
        else:
            yard = bench_ab.timed(
                torch, lambda: bench_ab.chained_sort(torch, keys, desc, live),
                max(1, reps // 4))
        per = bench_ab.device_kernels(
            torch, lambda: kernels.sort_order(keys, desc, live), PROFILED)
        bench_ab.report(torch, root, shape=shape, ms=ms, yardstick_ms=yard,
                        rows=int(live.shape[0]), live=int(live.sum()),
                        device_ms=sum(per.values()) if per else None,
                        kernels_ms=per)
        del keys, live, order
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
