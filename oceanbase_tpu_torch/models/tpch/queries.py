"""numpy oracles for TPC-H statements that the port runs.

Counterparts of `q6_numpy` and `q1_numpy_fast` in
`oceanbase_tpu/models/tpch/queries.py`, with every sum taken in int64 so
results compare exactly in the storage domain: at SF 10 the float64
bincount weights of the original pass 2^53 and round.
"""

from __future__ import annotations

import re

import numpy as np


def _day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def q6_numpy(lineitem, start: str = "1994-01-01",
             end: str = "1995-01-01") -> int:
    """Q6 revenue as an int64 sum at scale 4 (price x discount), over the
    ship dates [start, end)."""
    d = lineitem.data
    m = (
        (d["l_shipdate"] >= _day(start))
        & (d["l_shipdate"] < _day(end))
        & (d["l_discount"] >= 5)
        & (d["l_discount"] <= 7)
        & (d["l_quantity"] < 2400)
    )
    return int(np.sum(
        d["l_extendedprice"][m].astype(np.int64)
        * d["l_discount"][m].astype(np.int64)
    ))


def q1_numpy_fast(lineitem) -> dict:
    """Q1 per-group int64 sums over the packed (returnflag, linestatus)
    code key rf * |linestatus| + ls, each array of length |rf| * |ls|.
    sum_dp is at scale 4 and sum_ch at scale 6, like the engine's."""
    d = lineitem.data
    m = d["l_shipdate"] <= _day("1998-09-02")
    rf = d["l_returnflag"].astype(np.int64)
    ls = d["l_linestatus"].astype(np.int64)
    nls = len(lineitem.dicts["l_linestatus"])
    key = (rf * nls + ls)[m]
    dom = len(lineitem.dicts["l_returnflag"]) * nls
    qty = d["l_quantity"].astype(np.int64)[m]
    price = d["l_extendedprice"].astype(np.int64)[m]
    disc = d["l_discount"].astype(np.int64)[m]
    tax = d["l_tax"].astype(np.int64)[m]
    dp = price * (100 - disc)
    ch = dp * (100 + tax)

    def isum(w):
        out = np.zeros(dom, dtype=np.int64)
        np.add.at(out, key, w)
        return out

    return {
        "count": np.bincount(key, minlength=dom).astype(np.int64),
        "sum_qty": isum(qty),
        "sum_price": isum(price),
        "sum_dp": isum(dp),
        "sum_ch": isum(ch),
        "sum_disc": isum(disc),
    }


def s1_numpy(lineitem, day: str) -> dict:
    """S1: the rows with l_shipdate = day and l_quantity < 10 ordered by
    (l_extendedprice desc, l_orderkey, l_linenumber), storage domain."""
    d = lineitem.data
    m = (d["l_shipdate"] == _day(day)) & (d["l_quantity"] < 1000)
    ok = d["l_orderkey"][m]
    ln = d["l_linenumber"][m]
    px = d["l_extendedprice"][m]
    sd = d["l_shipdate"][m]
    order = np.lexsort((ln, ok, -px.astype(np.int64)))
    return {
        "l_orderkey": ok[order],
        "l_linenumber": ln[order],
        "l_extendedprice": px[order],
        "l_shipdate": sd[order],
    }


# ---------------------------------------------------------------------------
# The join slice: Q3, Q14, Q10, Q7, Q8, Q19. Joins look build keys up with
# np.searchsorted over the stored key columns, group-bys are np.lexsort +
# np.add.reduceat, and every sum is int64 in the storage domain
# (price * (100 - discount) is the volume at scale 4). Strings come back
# as the table dictionary's codes; a ratio is a float64.
# ---------------------------------------------------------------------------


def _code(table, col: str, s: str) -> int:
    return table.dicts[col].encode_one(s, add=False)


def _codes(table, col: str, pred) -> np.ndarray:
    return np.asarray([i for i, s in enumerate(table.dicts[col].values())
                       if pred(s)], dtype=np.int64)


def _lookup(build_keys: np.ndarray, probe_keys: np.ndarray):
    """(row, found) of each probe key in a unique sorted build key column."""
    bk = np.asarray(build_keys)
    pos = np.searchsorted(bk, probe_keys)
    row = np.minimum(pos, len(bk) - 1)
    return row, (pos < len(bk)) & (bk[row] == probe_keys)


def _volume(li: dict, m) -> np.ndarray:
    return (li["l_extendedprice"][m].astype(np.int64)
            * (100 - li["l_discount"][m].astype(np.int64)))


def _year(days: np.ndarray) -> np.ndarray:
    return (np.asarray(days, dtype=np.int64).astype("datetime64[D]")
            .astype("datetime64[Y]").astype(np.int64) + 1970)


def _group_sum(keys: list[np.ndarray], vals: np.ndarray):
    """Rows grouped by the key columns (lexsort, first key most
    significant): (the keys of each group, int64 sums)."""
    order = np.lexsort(tuple(reversed(keys)))
    sk = [k[order] for k in keys]
    sv = vals[order]
    n = len(sv)
    new = np.zeros(n, dtype=bool)
    if n:
        new[0] = True
    for k in sk:
        new[1:] |= k[1:] != k[:-1]
    starts = np.flatnonzero(new)
    sums = (np.add.reduceat(sv, starts) if n
            else np.zeros(0, dtype=np.int64))
    return [k[starts] for k in sk], sums.astype(np.int64)


def q3_numpy(tables) -> dict:
    """Q3: revenue per qualifying order, the 10 best by (revenue desc,
    o_orderdate), ties by o_orderkey."""
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    cd, od, ld = c.data, o.data, li.data
    crow, cok = _lookup(cd["c_custkey"], od["o_custkey"])
    om = (cok & (cd["c_mktsegment"][crow] == _code(c, "c_mktsegment",
                                                   "BUILDING"))
          & (od["o_orderdate"] < _day("1995-03-15")))
    lm = ld["l_shipdate"] > _day("1995-03-15")
    orow, ook = _lookup(od["o_orderkey"], ld["l_orderkey"][lm])
    keep = ook & om[orow]
    vol = _volume(ld, lm)[keep]
    (okey,), rev = _group_sum([ld["l_orderkey"][lm][keep]], vol)
    row, _ = _lookup(od["o_orderkey"], okey)
    odate = od["o_orderdate"][row]
    top = np.lexsort((okey, odate, -rev))[:10]
    return {
        "l_orderkey": okey[top],
        "revenue": rev[top],
        "o_orderdate": odate[top],
        "o_shippriority": od["o_shippriority"][row][top],
    }


def q14_numpy(tables) -> dict:
    """Q14: the promotion share of September 1995's revenue, as
    100 * promo / total (float64), with the two int64 sums."""
    p, li = tables["part"], tables["lineitem"]
    ld = li.data
    m = ((ld["l_shipdate"] >= _day("1995-09-01"))
         & (ld["l_shipdate"] < _day("1995-10-01")))
    prow, ok = _lookup(p.data["p_partkey"], ld["l_partkey"][m])
    vol = _volume(ld, m)[ok]
    promo = np.isin(p.data["p_type"][prow[ok]],
                    _codes(p, "p_type", lambda s: s.startswith("PROMO")))
    num, den = int(np.sum(vol[promo])), int(np.sum(vol))
    return {"promo": num, "total": den,
            "promo_revenue": 100.0 * num / den}


def q10_numpy(tables) -> dict:
    """Q10: returned-item revenue per customer in 1993 Q4, the 20 best by
    revenue, ties by c_custkey."""
    c, o, li, n = (tables["customer"], tables["orders"], tables["lineitem"],
                   tables["nation"])
    cd, od, ld = c.data, o.data, li.data
    om = ((od["o_orderdate"] >= _day("1993-10-01"))
          & (od["o_orderdate"] < _day("1994-01-01")))
    lm = ld["l_returnflag"] == _code(li, "l_returnflag", "R")
    orow, ook = _lookup(od["o_orderkey"], ld["l_orderkey"][lm])
    keep = ook & om[orow]
    cust = od["o_custkey"][orow[keep]]
    (ck,), rev = _group_sum([cust.astype(np.int64)], _volume(ld, lm)[keep])
    crow, _ = _lookup(cd["c_custkey"], ck)
    nrow, _ = _lookup(n.data["n_nationkey"], cd["c_nationkey"][crow])
    top = np.lexsort((ck, -rev))[:20]
    crow = crow[top]
    return {
        "c_custkey": ck[top],
        "c_name": cd["c_name"][crow],
        "revenue": rev[top],
        "c_acctbal": cd["c_acctbal"][crow],
        "n_name": n.data["n_name"][nrow[top]],
        "c_address": cd["c_address"][crow],
        "c_phone": cd["c_phone"][crow],
        "c_comment": cd["c_comment"][crow],
    }


def q7_numpy(tables) -> dict:
    """Q7: shipping volume between FRANCE and GERMANY per (supplier
    nation, customer nation, year), ordered by the names and the year."""
    s, o, c, n, li = (tables["supplier"], tables["orders"],
                      tables["customer"], tables["nation"],
                      tables["lineitem"])
    ld = li.data
    names = n.data["n_name"]
    fr, de = _code(n, "n_name", "FRANCE"), _code(n, "n_name", "GERMANY")
    lm = ((ld["l_shipdate"] >= _day("1995-01-01"))
          & (ld["l_shipdate"] <= _day("1996-12-31")))
    srow, sok = _lookup(s.data["s_suppkey"], ld["l_suppkey"][lm])
    snat, _ = _lookup(n.data["n_nationkey"], s.data["s_nationkey"][srow])
    orow, ook = _lookup(o.data["o_orderkey"], ld["l_orderkey"][lm])
    crow, cok = _lookup(c.data["c_custkey"], o.data["o_custkey"][orow])
    cnat, _ = _lookup(n.data["n_nationkey"], c.data["c_nationkey"][crow])
    sn, cn = names[snat], names[cnat]
    keep = (sok & ook & cok
            & (((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))))
    sn, cn = sn[keep].astype(np.int64), cn[keep].astype(np.int64)
    yr = _year(ld["l_shipdate"][lm][keep])
    # order by the nation NAMES: rank the codes by their strings
    vals = n.dicts["n_name"].values()
    rank = np.argsort(np.argsort(np.asarray(vals, dtype=object)))
    (rs, rc, y), rev = _group_sum([rank[sn], rank[cn], yr],
                                  _volume(ld, lm)[keep])
    code_of = np.argsort(rank)
    return {"supp_nation": code_of[rs], "cust_nation": code_of[rc],
            "l_year": y, "revenue": rev}


def q8_numpy(tables) -> dict:
    """Q8: BRAZIL's share of AMERICA's ECONOMY ANODIZED STEEL volume per
    order year (float64), with the two int64 sums."""
    p, s, o, c, n, r, li = (tables["part"], tables["supplier"],
                            tables["orders"], tables["customer"],
                            tables["nation"], tables["region"],
                            tables["lineitem"])
    ld = li.data
    prow, pok = _lookup(p.data["p_partkey"], ld["l_partkey"])
    lm = pok & (p.data["p_type"][prow]
                == _code(p, "p_type", "ECONOMY ANODIZED STEEL"))
    orow, ook = _lookup(o.data["o_orderkey"], ld["l_orderkey"][lm])
    odate = o.data["o_orderdate"][orow]
    crow, cok = _lookup(c.data["c_custkey"], o.data["o_custkey"][orow])
    n1, _ = _lookup(n.data["n_nationkey"], c.data["c_nationkey"][crow])
    rrow, _ = _lookup(r.data["r_regionkey"], n.data["n_regionkey"][n1])
    srow, sok = _lookup(s.data["s_suppkey"], ld["l_suppkey"][lm])
    n2, _ = _lookup(n.data["n_nationkey"], s.data["s_nationkey"][srow])
    keep = (ook & cok & sok
            & (r.data["r_name"][rrow] == _code(r, "r_name", "AMERICA"))
            & (odate >= _day("1995-01-01")) & (odate <= _day("1996-12-31")))
    vol = _volume(ld, lm)[keep]
    yr = _year(odate[keep])
    brazil = n.data["n_name"][n2[keep]] == _code(n, "n_name", "BRAZIL")
    (y,), tot = _group_sum([yr], vol)
    (_y2,), br = _group_sum([yr], np.where(brazil, vol, 0))
    return {"o_year": y, "brazil": br, "total": tot,
            "mkt_share": br / tot}


def q19_numpy(tables) -> int:
    """Q19: discounted revenue of the three brand/container/size/quantity
    groups shipped by air in person, as an int64 sum at scale 4."""
    p, li = tables["part"], tables["lineitem"]
    ld, pd = li.data, p.data
    air = np.asarray([_code(li, "l_shipmode", "AIR"),
                      _code(li, "l_shipmode", "AIR REG")])
    lm = (np.isin(ld["l_shipmode"], air)
          & (ld["l_shipinstruct"]
             == _code(li, "l_shipinstruct", "DELIVER IN PERSON")))
    prow, ok = _lookup(pd["p_partkey"], ld["l_partkey"][lm])
    qty = ld["l_quantity"][lm]
    brand, cont, size = (pd["p_brand"][prow], pd["p_container"][prow],
                         pd["p_size"][prow])
    hit = np.zeros(len(qty), dtype=bool)
    for b, conts, qlo, qhi, smax in (
        ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5),
        ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20,
         10),
        ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15),
    ):
        cc = np.asarray([_code(p, "p_container", x) for x in conts])
        hit |= ((brand == _code(p, "p_brand", b)) & np.isin(cont, cc)
                & (qty >= qlo * 100) & (qty <= qhi * 100)
                & (size >= 1) & (size <= smax))
    return int(np.sum(_volume(ld, lm)[ok & hit]))


def topn_desc_numpy(lineitem, col: str, n: int, cols) -> dict:
    """ORDER BY col DESC LIMIT n over lineitem, ties in storage order (the
    engine's row-index tie-break), for the named columns."""
    v = np.asarray(lineitem.data[col]).astype(np.int64)
    # the n best values' threshold, then the rows at or above it in order
    kth = np.partition(v, len(v) - n)[len(v) - n]
    rows = np.flatnonzero(v >= kth)
    rows = rows[np.argsort(-v[rows], kind="stable")][:n]
    return {c: np.asarray(lineitem.data[c])[rows] for c in cols}


def _by_string(table, col: str, codes: np.ndarray) -> np.ndarray:
    """Dictionary codes ordered by their strings (ORDER BY the column)."""
    values = table.dicts[col].values()
    return np.asarray(sorted(codes.tolist(), key=lambda c: values[c]),
                      dtype=np.int64)


def q4_numpy(tables) -> dict:
    """Q4: per o_orderpriority, the orders of 1993-Q3 with at least one
    line received after its commit date."""
    o, li = tables["orders"], tables["lineitem"]
    od, ld = o.data, li.data
    late = ld["l_commitdate"] < ld["l_receiptdate"]
    orow, ok = _lookup(od["o_orderkey"], ld["l_orderkey"][late])
    has = np.bincount(orow[ok], minlength=o.nrows) > 0
    m = (has & (od["o_orderdate"] >= _day("1993-07-01"))
         & (od["o_orderdate"] < _day("1993-10-01")))
    counts = np.bincount(od["o_orderpriority"][m].astype(np.int64),
                         minlength=len(o.dicts["o_orderpriority"]))
    prio = _by_string(o, "o_orderpriority", np.flatnonzero(counts))
    return {"o_orderpriority": prio, "order_count": counts[prio]}


def q12_numpy(tables) -> dict:
    """Q12: per ship mode (MAIL, SHIP), the 1994 lines received late but
    shipped before their commit date, split by their order's priority."""
    o, li = tables["orders"], tables["lineitem"]
    od, ld = o.data, li.data
    modes = np.asarray([_code(li, "l_shipmode", x) for x in ("MAIL", "SHIP")])
    m = (np.isin(ld["l_shipmode"], modes)
         & (ld["l_commitdate"] < ld["l_receiptdate"])
         & (ld["l_shipdate"] < ld["l_commitdate"])
         & (ld["l_receiptdate"] >= _day("1994-01-01"))
         & (ld["l_receiptdate"] < _day("1995-01-01")))
    orow, ok = _lookup(od["o_orderkey"], ld["l_orderkey"][m])
    mode = ld["l_shipmode"][m][ok].astype(np.int64)
    urgent = np.asarray([_code(o, "o_orderpriority", x)
                         for x in ("1-URGENT", "2-HIGH")])
    high = np.isin(od["o_orderpriority"][orow[ok]], urgent)
    dom = len(li.dicts["l_shipmode"])
    hi = np.bincount(mode[high], minlength=dom)
    lo = np.bincount(mode[~high], minlength=dom)
    keys = _by_string(li, "l_shipmode", np.flatnonzero(hi + lo))
    return {"l_shipmode": keys, "high_line_count": hi[keys],
            "low_line_count": lo[keys]}


def q13_numpy(tables) -> dict:
    """Q13: how many customers have each count of orders whose comment
    does not match '%special%requests%' (customers with none count 0),
    ordered by custdist desc, c_count desc."""
    c, o = tables["customer"], tables["orders"]
    pat = re.compile("special.*requests", re.S)
    bad = _codes(o, "o_comment", lambda s: pat.search(s) is not None)
    keep = ~np.isin(o.data["o_comment"], bad)
    crow, ok = _lookup(c.data["c_custkey"], o.data["o_custkey"][keep])
    c_count = np.bincount(crow[ok], minlength=c.nrows)
    dist = np.bincount(c_count)
    cc = np.flatnonzero(dist)
    order = np.lexsort((-cc, -dist[cc]))
    return {"c_count": cc[order].astype(np.int64),
            "custdist": dist[cc][order].astype(np.int64)}


def q20_numpy(tables, nation: str = "CANADA") -> dict:
    """Q20: the suppliers of `nation` holding a 'forest%' part whose
    available quantity exceeds half the 1994 shipped quantity of that
    (part, supplier) pair -- pairs with no 1994 lines drop out (the
    subquery's NULL) -- ordered by s_name. The decimal compare is exact:
    ps_availqty > 0.5 * sum(l_quantity) at scale 3 is
    200 * ps_availqty > sum(l_quantity at scale 2)."""
    p, ps, li = tables["part"], tables["partsupp"], tables["lineitem"]
    s, n = tables["supplier"], tables["nation"]
    forest = np.isin(p.data["p_name"],
                     _codes(p, "p_name", lambda x: x.startswith("forest")))
    fkeys = p.data["p_partkey"][forest].astype(np.int64)
    ld = li.data
    m = (np.isin(ld["l_partkey"], fkeys)
         & (ld["l_shipdate"] >= _day("1994-01-01"))
         & (ld["l_shipdate"] < _day("1995-01-01")))
    span = int(s.data["s_suppkey"].max()) + 1
    pair = ld["l_partkey"][m].astype(np.int64) * span + ld["l_suppkey"][m]
    upair, inv = np.unique(pair, return_inverse=True)
    qty = np.zeros(len(upair), dtype=np.int64)
    np.add.at(qty, inv, ld["l_quantity"][m].astype(np.int64))
    pd = ps.data
    pm = np.isin(pd["ps_partkey"], fkeys)
    ppair = pd["ps_partkey"][pm].astype(np.int64) * span + pd["ps_suppkey"][pm]
    row, found = _lookup(upair, ppair) if len(upair) else (
        np.zeros(len(ppair), dtype=np.int64), np.zeros(len(ppair), bool))
    ok = found & (200 * pd["ps_availqty"][pm].astype(np.int64)
                  > (qty[row] if len(upair) else 0))
    supp = np.unique(pd["ps_suppkey"][pm][ok])
    nk = n.data["n_nationkey"][n.data["n_name"] == _code(n, "n_name", nation)]
    sm = np.isin(s.data["s_suppkey"], supp) & np.isin(s.data["s_nationkey"],
                                                      nk)
    names = s.data["s_name"][sm]
    values = s.dicts["s_name"].values()
    order = sorted(range(len(names)), key=lambda i: values[names[i]])
    return {"s_name": names[order].astype(np.int64),
            "s_address": s.data["s_address"][sm][order].astype(np.int64)}


def q11_numpy(tables, fraction: str = "0.0001") -> dict:
    """Q11: per part, the value (ps_supplycost * ps_availqty, scale 2) of
    its German suppliers' stock, kept above `fraction` of the German
    total (TPC-H sets FRACTION = 0.0001 / SF), by value desc and then
    partkey. The compare is exact on integers:
    value > total * n / d  <=>  value * d > total * n."""
    from fractions import Fraction

    ps, s, n = tables["partsupp"], tables["supplier"], tables["nation"]
    nk = n.data["n_nationkey"][n.data["n_name"] == _code(n, "n_name",
                                                         "GERMANY")]
    srow, ok = _lookup(s.data["s_suppkey"], ps.data["ps_suppkey"])
    m = ok & np.isin(s.data["s_nationkey"][srow], nk)
    v = (ps.data["ps_supplycost"][m].astype(np.int64)
         * ps.data["ps_availqty"][m].astype(np.int64))
    (pk,), value = _group_sum([ps.data["ps_partkey"][m].astype(np.int64)], v)
    total = int(value.sum())
    f = Fraction(fraction)
    keep = value * f.denominator > total * f.numerator
    pk, value = pk[keep], value[keep]
    order = np.lexsort((pk, -value))
    return {"ps_partkey": pk[order], "value": value[order]}
