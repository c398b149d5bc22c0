"""numpy oracles for the TPC-H statements of the port's first slice.

Counterparts of `q6_numpy` and `q1_numpy_fast` in
`oceanbase_tpu/models/tpch/queries.py`, with every sum taken in int64 so
results compare exactly in the storage domain: at SF 10 the float64
bincount weights of the original pass 2^53 and round.
"""

from __future__ import annotations

import numpy as np


def _day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def q6_numpy(lineitem) -> int:
    """Q6 revenue as an int64 sum at scale 4 (price x discount)."""
    d = lineitem.data
    m = (
        (d["l_shipdate"] >= _day("1994-01-01"))
        & (d["l_shipdate"] < _day("1995-01-01"))
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
