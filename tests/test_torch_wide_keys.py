"""Statements wider than a kernel's old by-value table, and the launch
logic that lifted those caps.

Before these repairs a wrapper refused on the card a width its plain
version and the JAX package take: K14 more than 16 key planes (INTERSECT
and EXCEPT give each nullable column two planes), K8 more than 16 keys or
16 aggregates (every GROUP BY past the direct-address domain that takes
the sort route), K29 16 aggregates, K6 16 aggregates, K12 8 columns, K15
16 keys, K17 48 columns or 16 bounds, K22 k > 2048, K5 48 payload
columns. The tables now ride device memory (or a launch per group of
aggregates). On the CPU the wrappers run their plain versions, so these
tests hold:

- the statements that reach the old caps, as twins against the JAX
  Session (tests/torch_twins.py), with the kernel's width at the call
  recorded so the statement is shown to pass the old cap;
- the split launches' composition against one call of the plain version
  (K29's aggregates past 16 through the aggregate-only entry, K5's
  payload in groups), and the device tables' layouts;
- K14's plain hash set at 18 planes against the JAX package's
  build_hash_table / hash_join_probe, and K22's plain probe at k = 4096
  against numpy's tie order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.ops.join import build_hash_table as j_build
from oceanbase_tpu.ops.join import hash_join_probe as j_probe
from oceanbase_tpu.storage.sorted_projection import (
    make_sorted_projection as j_make,
)
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.core.table import table_from_arrays
from oceanbase_tpu_torch.engine import executor as TX
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch import sql_suite as TS
from oceanbase_tpu_torch.ops import hashagg as THA
from oceanbase_tpu_torch.ops import join as TJ
from oceanbase_tpu_torch.storage.sorted_projection import (
    make_sorted_projection,
    projection_name,
)
from tests.torch_twins import check_twin

NCOLS = 9
ROWS = 400


def _wide_table(name, seed, wide_values=False, ncols=NCOLS, rows=ROWS):
    """`ncols` nullable int64 columns c0, c1, ... (about a fifth NULL) and
    a group key g of 300 values, `rows` rows."""
    rng = np.random.default_rng(seed)
    data, valid = {}, {}
    for i in range(ncols):
        if wide_values:
            # three values 2^40 apart: the keys cannot pack into 64 bits
            data[f"c{i}"] = rng.integers(0, 3, rows).astype(np.int64) << 40
        else:
            data[f"c{i}"] = rng.integers(0, 2, rows).astype(np.int64)
        valid[f"c{i}"] = rng.random(rows) > 0.2
        data[f"c{i}"][~valid[f"c{i}"]] = 0
    data["g"] = rng.integers(0, 300, rows).astype(np.int64)
    names = [f"c{i}" for i in range(ncols)]
    jt = JTable(name, JSchema(tuple(
        [JField(n, JDT.int64(nullable=True)) for n in names]
        + [JField("g", JDT.int64())])), dict(data), {}, dict(valid))
    tt = table_from_arrays(
        name, [(n, "int64", 0, 0, True) for n in names]
        + [("g", "int64", 0, 0, False)], data, valid=valid)
    return jt, tt


@pytest.fixture(scope="module")
def engines():
    ja, ta = _wide_table("wa", 1)
    jb, tb = _wide_table("wb", 2)
    jw, tw = _wide_table("ww", 3, wide_values=True)
    js = JSession({"wa": ja, "wb": jb, "ww": jw})
    ts = TSession({"wa": ta, "wb": tb, "ww": tw}, device="cpu")
    return js, ts


COLS = ", ".join(f"c{i}" for i in range(NCOLS))


@pytest.mark.parametrize("kind", ["intersect", "except"])
def test_setop_over_18_key_planes(engines, monkeypatch, kind):
    """INTERSECT / EXCEPT of two tables of 9 nullable columns: K14's hash
    set over 18 planes (each column's zeroed value and its validity)."""
    js, ts = engines
    widths = []
    orig = TX.build_hash_table

    def counted(keys, *a, **k):
        widths.append(len(keys))
        return orig(keys, *a, **k)

    monkeypatch.setattr(TX, "build_hash_table", counted)
    rows = check_twin(js, ts, f"select {COLS} from wa {kind} "
                              f"select {COLS} from wb order by {COLS}")
    # (the port emits at every run: one width a run)
    assert widths and set(widths) == {2 * NCOLS} and widths[0] > 16
    assert len(rows) > 10


def _k8_widths(monkeypatch):
    seen = []
    orig = THA.segmented_reduce

    def counted(skeys, ssel, order, aggs):
        seen.append((len(list(skeys)), len(list(aggs))))
        return orig(skeys, ssel, order, aggs)

    monkeypatch.setattr(THA, "segmented_reduce", counted)
    return seen


def test_groupby_17_aggregates(engines, monkeypatch):
    """GROUP BY g (300 values, past the direct-address domain) with 17
    aggregates: the sort group-by's K8 over 17 aggregates."""
    js, ts = engines
    seen = _k8_widths(monkeypatch)
    aggs = ", ".join([f"sum(c{i}) as s{i}" for i in range(NCOLS)]
                     + [f"min(c{i}) as m{i}" for i in range(8)])
    check_twin(js, ts, f"select g, {aggs} from wa group by g order by g")
    assert seen and max(a for _k, a in seen) >= 17


def test_groupby_17_key_planes(engines, monkeypatch):
    """GROUP BY 8 nullable columns and g whose values cannot pack: K8
    over 17 key planes (8 values, 8 validity planes, g)."""
    js, ts = engines
    seen = _k8_widths(monkeypatch)
    keys = ", ".join(f"c{i}" for i in range(8))
    check_twin(js, ts, f"select {keys}, g, count(*) as n from ww "
                       f"group by {keys}, g order by {keys}, g")
    assert seen and max(k for k, _a in seen) >= 17


def test_k29_split_launch_equals_one_group():
    """K29 with 17 aggregates runs the slot pass and the first 16
    aggregates in one launch and the 17th through the aggregate-only
    entry over the same row slots: that composition equals one call of
    the plain version."""
    rng = np.random.default_rng(29)
    n, ts = 5000, 1 << 13
    gid = rng.integers(0, 700, n)
    keys = [torch.from_numpy((gid * (i + 3)) % (7 + i)) for i in range(17)]
    mask = torch.from_numpy(rng.random(n) > 0.1)
    aggs = [(("count", "sum", "min", "max")[i % 4],
             None if i % 4 == 0 else torch.from_numpy(
                 rng.integers(-10**9, 10**9, n)))
            for i in range(17)]
    groups = K.agg_groups(aggs, K.K29_MAX_AGGS)
    assert [len(g) for g in groups] == [16, 1]
    one = K.hash_groupby_plain(keys, mask, aggs, ts)
    first = K.hash_groupby_plain(keys, mask, groups[0], ts)
    rest = K.slot_aggregate_plain(first[0], mask, groups[1], ts)
    for a, b in zip(one[4], first[4] + rest):
        assert torch.equal(a, b)
    assert torch.equal(one[0], first[0]) and torch.equal(one[1], first[1])


def test_k5_split_launch_equals_one_group():
    """K5 with 50 payload columns launches once per 48 (each launch
    writing the same sel): the plain join of 48 + 2 columns equals one of
    50."""
    rng = np.random.default_rng(5)
    n, nb = 3000, 400
    pk = torch.from_numpy(rng.integers(0, nb + 40, n))
    ps = torch.from_numpy(rng.random(n) > 0.2)
    bk = torch.arange(nb, dtype=torch.int64)
    bs = torch.from_numpy(rng.random(nb) > 0.1)
    pay = [torch.from_numpy(rng.integers(0, 1 << 30, nb)) for _ in range(50)]
    sel, outs = K.affine_join(pk, ps, 0, 1, bk, bs, pay)
    s1, o1 = K.affine_join_plain(pk, ps, 0, 1, bk, bs,
                                 pay[:K.K5_MAX_COLS])
    s2, o2 = K.affine_join_plain(pk, ps, 0, 1, bk, bs,
                                 pay[K.K5_MAX_COLS:])
    assert torch.equal(sel, s1) and torch.equal(sel, s2)
    for a, b in zip(outs, o1 + o2):
        assert torch.equal(a, b)


def test_device_table_layouts():
    """The aggregate tables of K6 (device memory) and K8 (the kernel's
    parameters, or device memory past K8_INLINE entries): one entry block
    per aggregate, in order, with its addresses, type code, op and
    identity (a double's bits for a float accumulator)."""
    n = 16
    v64 = torch.arange(n, dtype=torch.int64)
    f64 = torch.ones(n, dtype=torch.float64)
    m = torch.ones(n, dtype=torch.bool)
    aggs = [("count", None, None), ("sum", v64, m), ("sum", f64, None)] * 6
    raw = [torch.empty(4, dtype=torch.float64 if op == "sum" and
                       v is f64 else torch.int64) for op, v, _m in aggs]
    t6 = K.k6_agg_entries(aggs, raw)
    assert len(t6) == 5 * len(aggs) == 90
    for j, ((op, v, mm), r) in enumerate(zip(aggs, raw)):
        e = t6[5 * j:5 * j + 5]
        assert e[0] == (v.data_ptr() if op == "sum" else 0)
        assert e[1] == (mm.data_ptr() if mm is not None else 0)
        assert e[2] == r.data_ptr()
        assert e[4] == int(r.dtype == torch.float64)
    aggs8 = [("count", None, None), ("min", v64, m), ("max", f64, None),
             ("sum", v64, None)] * 5
    raw8 = [torch.empty(4, dtype=torch.float64 if v is f64 else torch.int64)
            for _op, v, _m in aggs8]
    t8 = K.k8_agg_entries(aggs8, raw8)
    assert K.K8_FIELDS == 7
    assert len(t8) == 7 * len(aggs8) == 140
    for j, (op, v, mm) in enumerate(aggs8):
        e = t8[7 * j:7 * j + 7]
        assert e[0] == (v.data_ptr() if op != "count" else 0)
        assert e[1] == (mm.data_ptr() if mm is not None else 0)
        assert e[2] == raw8[j].data_ptr()
        assert e[4] == K.AGG_CODE["sum" if op == "count" else op]
        assert e[5] == int(v is f64)
        if op == "max" and v is f64:
            assert e[6] == np.float64(-np.inf).view(np.int64)
        if op == "min" and v is v64:
            assert e[6] == np.iinfo(np.int64).max


def test_k14_plain_18_planes_equals_jax():
    """K14's plain hash set over 18 planes against the JAX package's
    build_hash_table and hash_join_probe: the match rows bit for bit."""
    rng = np.random.default_rng(14)
    nb, npr, ts = 300, 900, 1024
    b = [rng.integers(0, 2, nb).astype(np.int64) if i % 2 == 0
         else rng.random(nb) > 0.3 for i in range(18)]
    pidx = rng.integers(0, nb, npr)
    p = [c[pidx].copy() for c in b]
    p[0][::5] += 7
    bm = rng.random(nb) > 0.1
    pm = rng.random(npr) > 0.1
    jt, jr = j_build([jnp.asarray(c) for c in b], jnp.asarray(bm), ts)
    jm = j_probe(jt, jr, [jnp.asarray(c) for c in b],
                 [jnp.asarray(c) for c in p], jnp.asarray(pm))
    tt, tr = K.hash_set_build([torch.from_numpy(c) for c in b],
                              torch.from_numpy(bm), ts)
    tm = K.hash_set_probe(tt, tr, [torch.from_numpy(c) for c in b],
                          [torch.from_numpy(c) for c in p],
                          torch.from_numpy(pm))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tm >= 0).sum() > 100


def test_k22_plain_k_4096_keeps_the_tie_order():
    """K22's plain probe at k = 4096 (past the old 2048) on
    integer-valued vectors: the winners in numpy's stable order of
    (distance, candidate position)."""
    rng = np.random.default_rng(22)
    n, d, nl, ml = 9000, 4, 6, 1500
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    offs = (np.arange(nl) * ml).astype(np.int32)
    lens = np.full(nl, ml, np.int32)
    lens[2] = ml - 100
    probes = np.array([4, 2, 0, 5], np.int32)
    q = rng.integers(-2, 3, d).astype(np.float32)
    sel = rng.random(n) > 0.2
    rows, osel, starved = K.ivf_probe(
        torch.from_numpy(x), torch.from_numpy(sel), torch.from_numpy(perm),
        torch.from_numpy(offs), torch.from_numpy(lens),
        torch.from_numpy(probes), torch.from_numpy(q), ml, n, 4096)
    cand = []
    for p in probes:
        for j in range(ml):
            r = perm[min(offs[p] + j, n - 1)]
            live = j < lens[p] and sel[r]
            dist = float((x[r] * x[r]).sum() - 2 * (x[r] @ q)) if live \
                else np.inf
            cand.append((dist, len(cand), r))
    cand.sort(key=lambda t: (t[0], t[1]))
    want = cand[:4096]
    assert rows.numpy().tolist() == [int(r) for _d, _i, r in want]
    assert osel.numpy().tolist() == [bool(np.isfinite(dd))
                                     for dd, _i, _r in want]
    assert int(starved) == max(
        0, 4096 - sum(1 for dd, _i, _r in cand if np.isfinite(dd)))


# ---------------------------------------------------------------------------
# the other caps a statement reaches: K6 (16 aggregates), K12 (8 columns),
# K15 (16 keys), K17 (48 columns, 16 bounds)


def _widths(monkeypatch, mod, name, width):
    """Wrap mod.name; the returned list gets width(*args) of every call."""
    seen = []
    orig = getattr(mod, name)

    def counted(*a, **kw):
        seen.append(width(*a, **kw))
        return orig(*a, **kw)

    monkeypatch.setattr(mod, name, counted)
    return seen


@pytest.fixture(scope="module")
def tpch():
    """TPC-H at SF 0.01 in both packages, lineitem with a sorted projection
    on l_shipdate."""
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    cols = ["l_shipdate", "l_extendedprice", "l_quantity"]
    j_make(jt, "lineitem", "l_shipdate", cols=cols)
    make_sorted_projection(tt, "lineitem", "l_shipdate", cols=cols)
    return (JSession(jt, unique_keys=TS.UNIQUE_KEYS),
            TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu"))


SUMS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_linenumber", "l_partkey", "l_suppkey", "l_quantity * l_discount",
        "l_extendedprice * l_tax", "l_quantity + l_linenumber",
        "l_partkey % 7", "l_suppkey % 11", "l_linenumber * l_linenumber",
        "l_quantity * l_tax", "l_extendedprice * l_discount")


def test_clustered_groupby_17_aggregates(tpch, monkeypatch):
    """17 sums and counts over lineitem (clustered by l_orderkey) joined
    to orders and grouped by o_orderkey: the clustered-FK group-by's K6
    over 17 aggregates."""
    js, ts = tpch
    seen = _widths(monkeypatch, TX, "clustered_segments",
                   lambda starts, ends, sel, aggs: len(aggs))
    sql = ("select o_orderkey, "
           + ", ".join(f"sum({e}) as s{i}" for i, e in enumerate(SUMS))
           + ", count(l_shipdate) as c1, count(l_commitdate) as c2 "
           "from lineitem, orders where l_orderkey = o_orderkey and "
           "l_orderkey < 20000 group by o_orderkey order by o_orderkey")
    rows = check_twin(js, ts, sql)
    assert seen and min(seen) == 17
    assert len(rows) > 1000


def test_join_over_9_key_columns(tpch, monkeypatch):
    """A self-join of lineitem on 9 integer columns: K12 hashes the 9
    columns into the 64-bit join key."""
    js, ts = tpch
    seen = _widths(monkeypatch, TJ, "hash_combine", lambda cols: len(cols))
    cols = ("l_orderkey", "l_linenumber", "l_partkey", "l_suppkey",
            "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipmode",
            "l_shipinstruct")
    sql = ("select count(*) as n, sum(a.l_quantity) as q from lineitem a "
           "join lineitem b on "
           + " and ".join(f"a.{c} = b.{c}" for c in cols)
           + " where a.l_orderkey < 20000 and b.l_orderkey < 20000")
    rows = check_twin(js, ts, sql)
    assert seen and min(seen) == 9
    assert rows[0][0] > 1000


def test_distinct_under_17_key_planes(engines, monkeypatch):
    """count(DISTINCT g) beside count(*) under 8 nullable group keys: K15
    marks the first rows over 17 keys (8 values, 8 validity planes and
    the value)."""
    js, ts = engines
    seen = _widths(monkeypatch, TX, "distinct_first_mask",
                   lambda key_vals, val, mask: len(key_vals) + 1)
    keys = ", ".join(f"c{i}" for i in range(8))
    check_twin(js, ts, f"select {keys}, count(distinct g) as d, "
                       f"count(*) as n from wa group by {keys} "
                       f"order by {keys}")
    assert seen and min(seen) == 17


def test_projection_slice_over_17_bounds(tpch, monkeypatch):
    """A range of 17 conjuncts on the sort key of lineitem#sp:l_shipdate:
    K17 reads 17 bounds."""
    js, ts = tpch
    seen = _widths(monkeypatch, TX, "slice_scan",
                   lambda key, n, lows, highs, *a: len(lows) + len(highs))
    sql = ("select sum(l_extendedprice) as s, count(*) as n from lineitem "
           "where " + " and ".join(f"l_shipdate >= date '1995-03-{d:02d}'"
                                   for d in range(1, 17))
           + " and l_shipdate < date '1995-03-20'")
    rows = check_twin(js, ts, sql)
    assert seen == [17]
    assert rows[0][1] > 0


WIDE_COLS = 26


def test_projection_slice_over_53_planes(monkeypatch):
    """A sorted projection of a table of 26 nullable columns, every
    column read in a selective range of its key: K17 copies 53 planes
    (26 values, 26 validity planes and g). (8000 rows, so that the
    slice's capacity lies below the table's.)"""
    jt, tt = _wide_table("wt", 4, ncols=WIDE_COLS, rows=8000)
    jcat, tcat = {"wt": jt}, {"wt": tt}
    j_make(jcat, "wt", "g")
    make_sorted_projection(tcat, "wt", "g")
    assert projection_name("wt", "g") in tcat
    js, ts = JSession(jcat), TSession(tcat, device="cpu")
    seen = _widths(monkeypatch, TX, "slice_scan",
                   lambda key, n, lows, highs, cap, pay, sel: len(pay))
    cols = ", ".join(f"c{i}" for i in range(WIDE_COLS))
    rows = check_twin(js, ts, f"select {cols}, g from wt where g >= 100 "
                              f"and g < 110 order by g, {cols}")
    assert seen and set(seen) == {2 * WIDE_COLS + 1}
    assert len(rows) > 10
