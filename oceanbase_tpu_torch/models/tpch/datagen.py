"""Spec-shaped TPC-H data generator (vectorized numpy, no dbgen).

Generates the 8 TPC-H tables with the distributions, domains and PK-FK
relationships the 22 queries rely on (dates within [1992-01-01, 1998-08-02],
shipdate = orderdate + U[1,121], returnflag correlated with receiptdate,
1-7 lineitems per order, etc.). Values are drawn with numpy vectorized RNG —
generation of SF1 (6M lineitem rows) takes seconds, and the same generator
with the same seed feeds both the CPU baseline and the TPU engine so
benchmark comparisons are apples-to-apples.

Comments are built from a small template vocabulary that still contains the
keyword patterns queries grep for (Q13 '%special%requests%',
Q16 '%Customer%Complaints%').
"""

from __future__ import annotations

import numpy as np

from ...core.dictionary import Dictionary
from ...core.table import Table
from . import schema as S

EPOCH = np.datetime64("1970-01-01", "D")
START = int(np.datetime64("1992-01-01", "D").astype(int))
END = int(np.datetime64("1998-12-01", "D").astype(int))
CURRENT = int(np.datetime64("1995-06-17", "D").astype(int))

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINERS_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
    "white", "yellow",
]
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "final", "pending", "regular", "express", "bold", "even", "silent",
    "unusual", "daring", "accounts", "packages", "deposits", "requests",
    "instructions", "foxes", "pinto", "beans", "theodolites", "platelets",
]


def _comments(rng: np.random.Generator, n: int, special: str | None = None,
              special_rate: float = 0.01) -> np.ndarray:
    """Short comments from a bounded vocabulary; optionally inject a keyword
    phrase (e.g. 'special requests') at special_rate. Vectorized: numpy
    char ops over the word table, no per-row Python."""
    vocab = np.array(COMMENT_WORDS)
    w = rng.integers(0, len(COMMENT_WORDS), (n, 3))
    out = np.char.add(
        np.char.add(vocab[w[:, 0]], " "),
        np.char.add(np.char.add(vocab[w[:, 1]], " "), vocab[w[:, 2]]),
    )
    if special:
        hit = rng.random(n) < special_rate
        if hit.any():
            out = out.astype("U64")
            out[hit] = np.char.add(np.char.add(out[hit], " "), special)
    return out


def _comment_codes(
    rng: np.random.Generator, n: int, special: str | None = None,
    special_rate: float = 0.01,
):
    """Dict-code fast path for huge tables: every possible 3-word comment
    (optionally + special suffix) forms the dictionary; rows draw codes.
    Generation cost is O(n) int ops + one O(|vocab|^3) string build."""
    from ...core.dictionary import Dictionary

    nw = len(COMMENT_WORDS)
    combos = [
        f"{a} {b} {c}"
        for a in COMMENT_WORDS for b in COMMENT_WORDS for c in COMMENT_WORDS
    ]
    variants = list(combos)
    if special:
        variants += [f"{s} {special}" for s in combos]
    values, inv = np.unique(np.array(variants), return_inverse=True)
    d = Dictionary([str(v) for v in values], sorted_=True)
    w = rng.integers(0, nw, (n, 3))
    flat = (w[:, 0] * nw + w[:, 1]) * nw + w[:, 2]
    if special:
        sp = rng.random(n) < special_rate
        flat = flat + sp * (nw ** 3)
    return inv[flat].astype(np.int32), d


def _choice_codes(rng: np.random.Generator, values: list[str], n: int):
    """Dict-code fast path for a uniform choice over a small vocabulary."""
    from ...core.dictionary import Dictionary

    sv, _ = np.unique(np.array(values), return_inverse=True)
    d = Dictionary([str(v) for v in sv], sorted_=True)
    order = {v: i for i, v in enumerate(sv)}
    lut = np.array([order[v] for v in values], dtype=np.int32)
    return lut[rng.integers(0, len(values), n)], d


def _money(rng, n, lo, hi):
    return np.round(rng.uniform(lo, hi, n), 2)


def _zfill_name(prefix: str, keys: np.ndarray, width: int = 9) -> np.ndarray:
    return np.char.add(prefix, np.char.zfill(keys.astype(f"U{width}"), width))


def _phones(keys: np.ndarray) -> np.ndarray:
    k = keys.astype(np.int64)
    return np.char.add(
        np.char.add((10 + k % 25).astype("U2"), "-"),
        np.char.add(
            np.char.add(np.char.zfill((k % 1000).astype("U3"), 3), "-"),
            np.char.add(
                np.char.add(np.char.zfill(((k * 7) % 1000).astype("U3"), 3), "-"),
                np.char.zfill(((k * 13) % 10000).astype("U4"), 4),
            ),
        ),
    )


def _table_mixed(name, schema, plain: dict, coded: dict) -> "Table":
    """Build a Table from plain columns (from_pydict semantics) plus
    pre-dictionary-encoded VARCHAR columns (codes, Dictionary) — the fast
    path that keeps huge-table generation free of per-row Python."""
    from ...core.dtypes import TypeKind

    data: dict[str, np.ndarray] = {}
    dicts = {}
    for f in schema.fields:
        if f.name in coded:
            codes, d = coded[f.name]
            data[f.name] = np.asarray(codes, dtype=np.int32)
            dicts[f.name] = d
        elif f.dtype.kind is TypeKind.VARCHAR:
            arr = np.asarray(plain[f.name])
            if arr.dtype.kind not in ("U", "S"):
                arr = arr.astype(str)
            d, codes = Dictionary.from_strings_bulk(arr)
            data[f.name] = codes
            dicts[f.name] = d
        elif f.dtype.is_decimal:
            a = np.asarray(plain[f.name])
            if np.issubdtype(a.dtype, np.floating):
                a = np.round(a * f.dtype.decimal_factor)
            data[f.name] = a.astype(f.dtype.storage_np)
        else:
            data[f.name] = np.asarray(plain[f.name], dtype=f.dtype.storage_np)
    return Table(name, schema, data, dicts)


def gen_region() -> Table:
    return Table.from_pydict("region", S.REGION, {
        "r_regionkey": np.arange(5), "r_name": REGIONS,
    })


def gen_nation() -> Table:
    return Table.from_pydict("nation", S.NATION, {
        "n_nationkey": np.arange(25),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": [r for _, r in NATIONS],
    })


def gen_supplier(sf: float, rng) -> Table:
    n = max(1, int(S.BASE_ROWS["supplier"] * sf))
    keys = np.arange(1, n + 1)
    return Table.from_pydict("supplier", S.SUPPLIER, {
        "s_suppkey": keys,
        "s_name": _zfill_name("Supplier#", keys),
        "s_address": _comments(rng, n),
        "s_nationkey": rng.integers(0, 25, n),
        "s_phone": _phones(keys),
        "s_acctbal": _money(rng, n, -999.99, 9999.99),
        "s_comment": _comments(rng, n, "Customer Complaints", 0.0005),
    })


def gen_customer(sf: float, rng) -> Table:
    n = max(1, int(S.BASE_ROWS["customer"] * sf))
    keys = np.arange(1, n + 1)
    return _table_mixed("customer", S.CUSTOMER, {
        "c_custkey": keys,
        "c_name": _zfill_name("Customer#", keys),
        "c_address": _comments(rng, n),
        "c_nationkey": rng.integers(0, 25, n),
        "c_phone": _phones(keys),
        "c_acctbal": _money(rng, n, -999.99, 9999.99),
        "c_mktsegment": rng.choice(SEGMENTS, n),
    }, {
        "c_comment": _comment_codes(rng, n, "special requests", 0.01),
    })


def gen_part(sf: float, rng) -> Table:
    n = max(1, int(S.BASE_ROWS["part"] * sf))
    keys = np.arange(1, n + 1)
    vocab = np.array(P_NAME_WORDS)
    w = rng.integers(0, len(P_NAME_WORDS), (n, 5))
    names = vocab[w[:, 0]]
    for j in range(1, 5):
        names = np.char.add(np.char.add(names, " "), vocab[w[:, j]])
    mfgr = rng.integers(1, 6, n)
    brand = mfgr * 10 + rng.integers(1, 6, n)
    types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
    type_idx = (
        rng.integers(0, 6, n) * 25 + rng.integers(0, 5, n) * 5
        + rng.integers(0, 5, n)
    )
    containers = [f"{a} {b}" for a in CONTAINERS_1 for b in CONTAINERS_2]
    cont_idx = rng.integers(0, 5, n) * 8 + rng.integers(0, 8, n)
    t_codes, t_dict = _lut_codes(types, type_idx)
    c_codes, c_dict = _lut_codes(containers, cont_idx)
    return _table_mixed("part", S.PART, {
        "p_partkey": keys,
        "p_name": names,
        "p_mfgr": np.char.add("Manufacturer#", mfgr.astype("U1")),
        "p_brand": np.char.add("Brand#", brand.astype("U2")),
        "p_size": rng.integers(1, 51, n),
        "p_retailprice": np.round(
            900 + (keys % 1000) / 10 + 100 * (keys % 10), 2
        ),
    }, {
        "p_type": (t_codes, t_dict),
        "p_container": (c_codes, c_dict),
    })


def _lut_codes(values: list[str], idx: np.ndarray):
    """Codes for rows drawing strings by index into a small value list."""
    sv, inv = np.unique(np.array(values), return_inverse=True)
    d = Dictionary([str(v) for v in sv], sorted_=True)
    return inv.astype(np.int32)[idx], d


def gen_partsupp(sf: float, rng, n_part: int, n_supp: int) -> Table:
    # 4 suppliers per part, spec-style spread
    pk = np.repeat(np.arange(1, n_part + 1), 4)
    n = len(pk)
    j = np.tile(np.arange(4), n_part)
    sk = ((pk + (j * (n_supp // 4 + (pk - 1) // n_supp))) % n_supp) + 1
    return Table.from_pydict("partsupp", S.PARTSUPP, {
        "ps_partkey": pk,
        "ps_suppkey": sk,
        "ps_availqty": rng.integers(1, 10000, n),
        "ps_supplycost": _money(rng, n, 1.00, 1000.00),
    })


def gen_orders_lineitem(sf: float, rng, n_cust: int, n_part: int, n_supp: int):
    n_ord = max(1, int(S.BASE_ROWS["orders"] * sf))
    okey = np.arange(1, n_ord + 1, dtype=np.int64) * 4  # sparse like spec
    # only 2/3 of customers have orders (spec): custkey % 3 != 0
    ck = rng.integers(1, max(n_cust, 2), n_ord).astype(np.int64)
    ck = np.where(ck % 3 == 0, np.maximum((ck + 1) % (n_cust + 1), 1), ck)
    odate = rng.integers(START, END - 151, n_ord)
    n_li_per = rng.integers(1, 8, n_ord)
    nl = int(n_li_per.sum())

    # lineitem parent mapping
    li_order = np.repeat(np.arange(n_ord), n_li_per)
    l_orderkey = okey[li_order]
    l_linenumber = (
        np.arange(nl) - np.repeat(np.cumsum(n_li_per) - n_li_per, n_li_per) + 1
    )
    l_partkey = rng.integers(1, n_part + 1, nl)
    l_suppkey = rng.integers(1, n_supp + 1, nl)
    qty = rng.integers(1, 51, nl).astype(np.float64)
    retail = 900 + (l_partkey % 1000) / 10 + 100 * (l_partkey % 10)
    extprice = np.round(qty * retail, 2)
    disc = rng.integers(0, 11, nl) / 100
    tax = rng.integers(0, 9, nl) / 100
    o_date_li = odate[li_order]
    shipdate = o_date_li + rng.integers(1, 122, nl)
    commitdate = o_date_li + rng.integers(30, 91, nl)
    receiptdate = shipdate + rng.integers(1, 31, nl)
    returned = receiptdate <= CURRENT
    # dict-code fast paths: sorted vocab positions are fixed —
    # ["A","N","R"] and ["F","O"]
    rf_codes = np.where(
        returned, np.where(rng.random(nl) < 0.5, 2, 0), 1
    ).astype(np.int32)
    rf_dict = Dictionary(["A", "N", "R"], sorted_=True)
    is_open = shipdate > CURRENT
    ls_codes = is_open.astype(np.int32)
    ls_dict = Dictionary(["F", "O"], sorted_=True)
    si_codes, si_dict = _choice_codes(rng, INSTRUCTS, nl)
    sm_codes, sm_dict = _choice_codes(rng, SHIPMODES, nl)

    lineitem = _table_mixed("lineitem", S.LINEITEM, {
        "l_orderkey": l_orderkey,
        "l_partkey": l_partkey,
        "l_suppkey": l_suppkey,
        "l_linenumber": l_linenumber,
        "l_quantity": qty,
        "l_extendedprice": extprice,
        "l_discount": disc,
        "l_tax": tax,
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
    }, {
        "l_returnflag": (rf_codes, rf_dict),
        "l_linestatus": (ls_codes, ls_dict),
        "l_shipinstruct": (si_codes, si_dict),
        "l_shipmode": (sm_codes, sm_dict),
    })

    # order status/totalprice derived from lineitems
    charge = extprice * (1 - disc) * (1 + tax)
    totalprice = np.zeros(n_ord)
    np.add.at(totalprice, li_order, charge)
    is_f = ~is_open
    all_f = np.ones(n_ord, bool)
    any_f = np.zeros(n_ord, bool)
    np.logical_and.at(all_f, li_order, is_f)
    np.logical_or.at(any_f, li_order, is_f)
    # sorted vocab ["F","O","P"]: F=0, O=1, P=2
    status_codes = np.where(all_f, 0, np.where(any_f, 2, 1)).astype(np.int32)
    status_dict = Dictionary(["F", "O", "P"], sorted_=True)
    pr_codes, pr_dict = _choice_codes(rng, PRIORITIES, n_ord)
    n_clerks = max(1, int(1000 * sf))
    clerk_vocab = [f"Clerk#{k:09d}" for k in range(1, n_clerks + 1)]
    clerk_codes = rng.integers(0, n_clerks, n_ord).astype(np.int32)
    clerk_dict = Dictionary(clerk_vocab, sorted_=True)
    oc_codes, oc_dict = _comment_codes(rng, n_ord, "special requests", 0.01)

    orders = _table_mixed("orders", S.ORDERS, {
        "o_orderkey": okey,
        "o_custkey": ck,
        "o_totalprice": np.round(totalprice, 2),
        "o_orderdate": odate,
        "o_shippriority": np.zeros(n_ord, dtype=np.int32),
    }, {
        "o_orderstatus": (status_codes, status_dict),
        "o_orderpriority": (pr_codes, pr_dict),
        "o_clerk": (clerk_codes, clerk_dict),
        "o_comment": (oc_codes, oc_dict),
    })
    return orders, lineitem


def generate(sf: float = 0.01, seed: int = 19920101) -> dict[str, Table]:
    """Generate all 8 tables at the given scale factor."""
    rng = np.random.default_rng(seed)
    region = gen_region()
    nation = gen_nation()
    supplier = gen_supplier(sf, rng)
    customer = gen_customer(sf, rng)
    part = gen_part(sf, rng)
    partsupp = gen_partsupp(sf, rng, part.nrows, supplier.nrows)
    orders, lineitem = gen_orders_lineitem(
        sf, rng, customer.nrows, part.nrows, supplier.nrows
    )
    return {
        "region": region,
        "nation": nation,
        "supplier": supplier,
        "customer": customer,
        "part": part,
        "partsupp": partsupp,
        "orders": orders,
        "lineitem": lineitem,
    }
