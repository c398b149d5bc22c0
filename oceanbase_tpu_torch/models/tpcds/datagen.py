"""Spec-shaped TPC-DS subset generator (vectorized numpy, no dsdgen).

Generates the star-schema core (date_dim / item / store / store_sales)
with the distributions the star-join queries rely on: a calendar spanning
1998-2002 with correct year/month/day breakdowns, items carrying
brand/manufacturer/category hierarchies, and a fact table whose foreign
keys are drawn non-uniformly (sales skew toward Q4 / popular items) so
group-bys and joins see realistic distributions.

`sf` scales the fact-table row count like dsdgen's scale factor:
sf=1 -> ~2.88M store_sales rows (the spec's ratio for SF1)."""

from __future__ import annotations

import numpy as np

from ...core.table import Table
from . import schema as S

EPOCH = np.datetime64("1970-01-01", "D")
CAL_START = np.datetime64("1998-01-01", "D")
CAL_END = np.datetime64("2002-12-31", "D")

CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]
STATES = ["TN", "CA", "TX", "WA", "NY", "GA", "OH", "IL"]


def _table(name, schema, cols, dict_cols=()):
    pydata = dict(cols)
    return Table.from_pydict(name, schema, pydata)


def gen_date_dim() -> Table:
    days = np.arange(CAL_START, CAL_END + np.timedelta64(1, "D"))
    dsk = np.arange(2450000, 2450000 + len(days), dtype=np.int64)
    years = days.astype("datetime64[Y]").astype(int) + 1970
    months = days.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (days - days.astype("datetime64[M]")).astype(int) + 1
    return _table("date_dim", S.DATE_DIM, {
        "d_date_sk": dsk,
        "d_date": (days - EPOCH).astype(np.int64),
        "d_year": years.astype(np.int32),
        "d_moy": months.astype(np.int32),
        "d_dom": dom.astype(np.int32),
    })


def gen_item(sf: float, rng) -> Table:
    n = max(int(18000 * min(sf, 1.0) + 2000 * sf), 1000)
    isk = np.arange(1, n + 1, dtype=np.int64)
    manufact = rng.integers(1, 1001, n).astype(np.int32)
    brand_id = (manufact * 100 + rng.integers(1, 10, n)).astype(np.int32)
    brand = np.char.add(
        np.char.add("Brand#", manufact.astype(str)), rng.integers(1, 10, n).astype(str)
    )
    cat_id = rng.integers(0, len(CATEGORIES), n)
    manager = rng.integers(1, 101, n).astype(np.int32)
    return _table("item", S.ITEM, {
        "i_item_sk": isk,
        "i_brand_id": brand_id,
        "i_brand": brand,
        "i_manufact_id": manufact,
        "i_category_id": (cat_id + 1).astype(np.int32),
        "i_category": np.array(CATEGORIES)[cat_id],
        "i_manager_id": manager,
    })


def gen_store(sf: float, rng) -> Table:
    n = max(int(12 * sf), 4)
    ssk = np.arange(1, n + 1, dtype=np.int64)
    return _table("store", S.STORE, {
        "s_store_sk": ssk,
        "s_store_name": np.array([f"Store{k:04d}" for k in range(n)]),
        "s_state": np.array(STATES)[rng.integers(0, len(STATES), n)],
    })


def gen_store_sales(sf: float, rng, dates: Table, n_item: int,
                    n_store: int) -> Table:
    n = max(int(2_880_000 * sf), 10_000)
    dsk = dates.data["d_date_sk"]
    moy = dates.data["d_moy"]
    # seasonal skew: November/December sell ~2x (the spec's holiday surge)
    w = np.where(np.isin(moy, (11, 12)), 2.0, 1.0)
    w = w / w.sum()
    date_pick = rng.choice(len(dsk), n, p=w)
    # popularity skew on items: Zipf-ish via squared uniform
    item_pick = (np.minimum(rng.random(n) ** 2 * n_item, n_item - 1)).astype(
        np.int64
    ) + 1
    qty = rng.integers(1, 101, n).astype(np.int32)
    price_c = rng.integers(100, 30001, n, dtype=np.int64)  # cents
    ext = price_c * qty
    profit = (ext * (rng.random(n) * 0.6 - 0.1)).astype(np.int64)
    return _table("store_sales", S.STORE_SALES, {
        "ss_sold_date_sk": dsk[date_pick],
        "ss_item_sk": item_pick,
        "ss_store_sk": rng.integers(1, n_store + 1, n).astype(np.int64),
        "ss_customer_sk": rng.integers(1, int(100_000 * max(sf, 0.01)) + 2, n).astype(np.int64),
        "ss_quantity": qty,
        "ss_ext_sales_price": ext / 100.0,
        "ss_net_profit": profit / 100.0,
    })


def generate(sf: float = 0.01, seed: int = 20030101) -> dict[str, Table]:
    rng = np.random.default_rng(seed)
    date_dim = gen_date_dim()
    item = gen_item(sf, rng)
    store = gen_store(sf, rng)
    store_sales = gen_store_sales(
        sf, rng, date_dim, item.nrows, store.nrows
    )
    return {
        "date_dim": date_dim,
        "item": item,
        "store": store,
        "store_sales": store_sales,
    }
