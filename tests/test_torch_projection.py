"""Sorted-projection scan routing in the port against the JAX package.

Each package builds its own `lineitem#sp:l_shipdate` projection (the
covered columns of the reference bench) over the same generated TPC-H
tables at SF 0.01 (seed 19920101), and the JAX Session and the port's
Session(device="cpu") must return the same rows for Q6 routed through it,
Q6 rebound to another year through the text tier, and Q14 (one month of
lineitem probing part). The router cases of tests/test_projection_router.py
run on Sessions over the catalog: a column-subset projection serves a
covered query, an uncovered column falls back to the base table, and of
two equally selective projections the narrower one wins. A range wider
than the seeded slice capacity overflows once and re-runs as a full scan.
K17's plain version is held against the JAX `_slice_sorted_scan` on
crafted batches (start clipped at the end, an empty range, hi < lo,
parameter bounds, the capacity pad), every output exactly. The two
`#sp:` guards keep a sliced projection out of the affine join's build
side and out of the clustered-FK aggregation's probe.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from oceanbase_tpu.core.column import ColumnBatch as JBatch
from oceanbase_tpu.core.dtypes import DataType as JDataType
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine import executor as JX
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.expr import compile as JC
from oceanbase_tpu.expr import ir as JE
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.storage.sorted_projection import (
    drop_projections as j_drop,
)
from oceanbase_tpu.storage.sorted_projection import (
    make_sorted_projection as j_make,
)
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.core.column import ColumnBatch as TBatch
from oceanbase_tpu_torch.core.dtypes import DataType, Field, Schema
from oceanbase_tpu_torch.core.table import Table
from oceanbase_tpu_torch.engine import executor as TX
from oceanbase_tpu_torch.engine.executor import Executor
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.expr import compile as TC
from oceanbase_tpu_torch.expr import ir as TE
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch import sql_suite as TS
from oceanbase_tpu_torch.sql.parser import parse
from oceanbase_tpu_torch.sql.planner import Planner
from oceanbase_tpu_torch.storage.sorted_projection import (
    drop_projections,
    make_sorted_projection,
    projection_name,
)
from torch_twins import check_twin

import torch

SP_COLS = ["l_shipdate", "l_quantity", "l_extendedprice", "l_discount",
           "l_tax", "l_returnflag", "l_linestatus", "l_partkey",
           "l_orderkey"]


def q6(year: int) -> str:
    """TPC-H Q6 over shipping year `year` (the suite's text has 1994)."""
    return TS.QUERIES[6].replace("1995-01-01", f"{year + 1}-01-01").replace(
        "1994-01-01", f"{year}-01-01")


Q6_1995 = q6(1995)
Q14 = TS.QUERIES[14]
NARROW = """select sum(l_extendedprice) as s, count(*) as n from lineitem
where l_shipdate >= date '1995-03-01' and l_shipdate < date '1995-03-08'"""
WIDE = NARROW.replace("1995-03-08", "1995-09-01")


@pytest.fixture(scope="module")
def engines():
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    j_make(jt, "lineitem", "l_shipdate", cols=SP_COLS)
    make_sorted_projection(tt, "lineitem", "l_shipdate", cols=SP_COLS)
    js = JSession(jt, unique_keys=TS.UNIQUE_KEYS)
    ts = TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu")
    yield js, ts, tt
    j_drop(jt, "lineitem")
    drop_projections(tt, "lineitem")


def _prepare(ex, catalog, sql):
    plan = Planner(catalog).plan(parse(sql)).plan
    return ex.prepare(plan)


def _scan_tables(prepared):
    return sorted(s.table for s in
                  prepared.executor._collect_scans(prepared.plan))


class _SliceCalls:
    """Counts the executor's calls of K17's wrapper (the plain version
    runs on the CPU, where LAUNCHES counts nothing)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = TX.slice_scan

        def counted(*a, **kw):
            self.n += 1
            return real(*a, **kw)

        monkeypatch.setattr(TX, "slice_scan", counted)


@pytest.mark.parametrize("sql", [TS.QUERIES[6], Q6_1995, Q14],
                         ids=["q6", "q6_rebound", "q14"])
def test_projection_statements_match_jax(engines, sql, monkeypatch):
    js, ts, tt = engines
    calls = _SliceCalls(monkeypatch)
    check_twin(js, ts, sql)
    assert calls.n == 1, "the routed scan did not slice (K17)"
    prepared = _prepare(ts.executor, tt, sql)
    assert projection_name("lineitem", "l_shipdate") in _scan_tables(
        prepared)
    assert prepared.params.scan_slice


def test_q6_rebind_uses_fast_tier_and_slices(engines, monkeypatch):
    js, ts, _tt = engines
    ts.sql(TS.QUERIES[6]).nrows
    calls = _SliceCalls(monkeypatch)
    rs = ts.sql(q6(1996))
    assert rs.fast_path_hit
    want = js.sql(q6(1996))
    assert rs.storage_columns()["revenue"] > 0
    assert rs.rows() == want.rows()
    assert calls.n == 1


def test_q14_keeps_part_as_the_affine_build(engines):
    _js, ts, tt = engines
    prepared = _prepare(ts.executor, tt, Q14)
    join = next(op for op in TX._number_nodes(prepared.plan).values()
                if isinstance(op, TX.JoinOp))
    assert ts.executor._affine_build_info(join) is not None
    assert [s.table for s in ts.executor._collect_scans(join.left)] == [
        projection_name("lineitem", "l_shipdate")]


def test_q1_not_selective_stays_on_base(engines):
    js, ts, tt = engines
    prepared = _prepare(ts.executor, tt, TS.QUERIES[1])
    assert _scan_tables(prepared) == ["lineitem"]
    check_twin(js, ts, TS.QUERIES[1])


def test_wider_range_overflows_once_to_full_scan(engines, monkeypatch):
    js, _ts, tt = engines
    sess = TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu")
    narrow = sess.sql(NARROW)
    assert narrow.rows() == js.sql(NARROW).rows()
    calls = _SliceCalls(monkeypatch)
    wide = sess.sql(WIDE)
    assert wide.fast_path_hit
    assert wide.rows() == js.sql(WIDE).rows()
    # the one sliced run overflowed; the retry and every later run scan
    # the whole projection
    assert calls.n == 1
    prepared = wide._cursor.prepared
    assert prepared.retries == 1
    assert list(prepared.params.scan_cap.values()) == [1 << 62]
    again = sess.sql(NARROW)
    assert again.rows() == narrow.rows()
    assert calls.n == 1


# ---------------------------------------------------------------------------
# the router cases of tests/test_projection_router.py, on Sessions


def _router_tables(table_cls, schema_cls, field_cls, dtype_cls):
    rows = np.arange(2000)
    rt = table_cls.from_pydict("rt", schema_cls(tuple(
        field_cls(n, dtype_cls.int32()) for n in ("id", "k", "k2", "a", "b"))),
        {"id": rows, "k": rows // 10, "k2": rows // 10, "a": rows * 3,
         "b": rows % 11})
    rt2 = table_cls.from_pydict("rt2", schema_cls(tuple(
        field_cls(n, dtype_cls.int32()) for n in ("id", "k", "k2", "a"))),
        {"id": rows, "k": rows // 10, "k2": rows // 10, "a": rows * 3})
    return {"rt": rt, "rt2": rt2}


@pytest.fixture(scope="module")
def router():
    jcat = _router_tables(JTable, JSchema, JField, JDataType)
    tcat = _router_tables(Table, Schema, Field, DataType)
    for make, cat in ((j_make, jcat), (make_sorted_projection, tcat)):
        make(cat, "rt", "k", cols=["k", "k2", "a"])
        make(cat, "rt2", "k")
        make(cat, "rt2", "k2", cols=["k", "k2", "a"])
    uk = {"rt": [("id",)], "rt2": [("id",)]}
    js = JSession(jcat, unique_keys=uk)
    ts = TSession(tcat, unique_keys=uk, device="cpu")
    return js, ts, tcat


@pytest.mark.parametrize("sql,table", [
    ("select sum(a) as sa from rt where k >= 5 and k < 10", "rt#sp:k"),
    ("select sum(b) as sb from rt where k >= 5 and k < 10", "rt"),
    ("select sum(a) as sa from rt2 where k >= 5 and k < 10 "
     "and k2 >= 5 and k2 < 10", "rt2#sp:k2"),
    ("select * from rt where k >= 5 and k < 10 order by id limit 3", "rt"),
], ids=["covered_subset", "uncovered_falls_back", "narrower_tie_break",
        "star_falls_back"])
def test_router_cases(router, sql, table):
    js, ts, tcat = router
    assert _scan_tables(_prepare(ts.executor, tcat, sql)) == [table]
    check_twin(js, ts, sql)


# ---------------------------------------------------------------------------
# the #sp: guards of the affine join and the clustered-FK aggregation


@pytest.fixture(scope="module")
def guard_tables():
    """orders sorted by o_orderkey (affine) with a projection on
    o_orderdate; lineitem clustered by l_orderkey with a projection on
    l_orderkey itself."""
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    for make, cat in ((j_make, jt), (make_sorted_projection, tt)):
        make(cat, "orders", "o_orderdate")
        make(cat, "lineitem", "l_orderkey",
             cols=["l_orderkey", "l_quantity", "l_extendedprice"])
    js = JSession(jt, unique_keys=TS.UNIQUE_KEYS)
    ts = TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu")
    return js, ts, tt


# the build side (orders) is a sliced projection of o_orderdate
BUILD_SIDE = """select count(*) as n, sum(l_quantity) as q
from lineitem, orders
where l_orderkey = o_orderkey and o_orderdate >= date '1995-01-01'
  and o_orderdate < date '1995-02-01'"""
# the clustered probe (lineitem by l_orderkey) is a sliced projection
CLUSTERED = """select o_orderkey, sum(l_extendedprice) as rev
from lineitem, orders
where l_orderkey = o_orderkey and l_orderkey < 3000
group by o_orderkey order by o_orderkey"""


def test_affine_guard_keeps_sliced_build_off_the_direct_route(
        guard_tables, monkeypatch):
    js, ts, tt = guard_tables
    prepared = _prepare(ts.executor, tt, BUILD_SIDE)
    join = next(op for op in TX._number_nodes(prepared.plan).values()
                if isinstance(op, TX.JoinOp))
    assert "orders#sp:o_orderdate" in [
        s.table for s in ts.executor._collect_scans(join.right)]
    assert prepared.params.scan_slice
    assert ts.executor._affine_build_info(join) is None
    calls = _SliceCalls(monkeypatch)
    check_twin(js, ts, BUILD_SIDE)
    assert calls.n == 1


def test_clustered_guard_keeps_sliced_probe_off_the_segment_route(
        guard_tables, monkeypatch):
    js, ts, tt = guard_tables
    prepared = _prepare(ts.executor, tt, CLUSTERED)
    assert "lineitem#sp:l_orderkey" in _scan_tables(prepared)
    assert prepared.params.scan_slice
    assert not prepared.params.clustered_aggs
    calls = _SliceCalls(monkeypatch)
    check_twin(js, ts, CLUSTERED)
    assert calls.n == 1


# ---------------------------------------------------------------------------
# K17's plain version against the JAX _slice_sorted_scan


def _k17_case(keys, n, cap2, lows, highs, cap, slotted):
    """Both packages' slice of one crafted batch: a sorted int32 key over
    `n` rows padded to `cap2`, an int64 payload, a nullable int16 column
    and a sel with holes."""
    rng = np.random.default_rng(11)
    key = np.concatenate([np.sort(keys), np.full(cap2 - n, 0, np.int32)])
    val = rng.integers(-10**12, 10**12, cap2)
    small = rng.integers(-300, 300, cap2).astype(np.int16)
    vmask = rng.random(cap2) < 0.8
    sel = (rng.random(cap2) < 0.9) & (np.arange(cap2) < n)
    names = ("t.k", "t.v", "t.s")

    def lits(ir, dt, bounds, first_slot):
        out = []
        for i, (v, side) in enumerate(bounds):
            slot = first_slot + i if slotted else None
            out.append((ir.Literal(v, dt.int32(), slot), side))
        return tuple(out)

    params = [np.int32(v) for v, _s in lows + highs]
    jb = JBatch(
        cols={"t.k": jnp.asarray(key), "t.v": jnp.asarray(val),
              "t.s": jnp.asarray(small)},
        valid={"t.s": jnp.asarray(vmask)}, sel=jnp.asarray(sel),
        nrows=jnp.asarray(int(sel.sum()), jnp.int64),
        schema=JSchema(tuple(JField(nm, JDataType.int64())
                             for nm in names)), dicts={})
    jspec = JX._SliceSpec("t.k", lits(JE, JDataType, lows, 0),
                          lits(JE, JDataType, highs, len(lows)))
    prev = JC.set_params(tuple(jnp.asarray(p) for p in params)
                         if slotted else None)
    try:
        jout, jovf = JX._slice_sorted_scan(jb, jspec, cap, n)
    finally:
        JC.set_params(prev)
    tb = TBatch(
        cols={"t.k": torch.from_numpy(key), "t.v": torch.from_numpy(val),
              "t.s": torch.from_numpy(small)},
        valid={"t.s": torch.from_numpy(vmask)}, sel=torch.from_numpy(sel),
        nrows=torch.tensor(int(sel.sum())),
        schema=Schema(tuple(Field(nm, DataType.int64()) for nm in names)),
        dicts={})
    tspec = TX._SliceSpec("t.k", lits(TE, DataType, lows, 0),
                          lits(TE, DataType, highs, len(lows)))
    prev = TC.set_params(tuple(torch.tensor(p) for p in params)
                         if slotted else None)
    try:
        ex = Executor({}, device="cpu")
        tout, tovf = ex._slice_sorted_scan(tb, tspec, cap, n)
    finally:
        TC.set_params(prev)
    for c in names:
        np.testing.assert_array_equal(tout.cols[c].numpy(),
                                      np.asarray(jout.cols[c]), err_msg=c)
    np.testing.assert_array_equal(tout.valid["t.s"].numpy(),
                                  np.asarray(jout.valid["t.s"]))
    np.testing.assert_array_equal(tout.sel.numpy(), np.asarray(jout.sel))
    assert int(tout.nrows) == int(jout.nrows)
    assert int(tovf) == int(jovf)
    return int(tovf), int(tout.nrows)


KEYS = np.random.default_rng(5).integers(0, 500, 3000).astype(np.int32)


@pytest.mark.parametrize("slotted", [False, True], ids=["inline", "params"])
@pytest.mark.parametrize("lows,highs,cap,over", [
    ([(490, "left")], [], 1024, False),               # start clips at the end
    ([(200, "left")], [(200, "left")], 1024, False),  # empty range
    ([(300, "right")], [(100, "left")], 1024, False), # hi < lo
    ([(10, "left"), (12, "right")], [(300, "left"), (290, "right")], 1024,
     True),                                           # wider than cap
    ([(100, "left")], [(150, "right")], 2048, False), # cap covers the range
    ([], [(3, "right")], 1024, False),                # high bound only
], ids=["clip_end", "empty", "hi_below_lo", "overflow", "inside",
        "high_only"])
def test_k17_plain_matches_jax(lows, highs, cap, over, slotted):
    got_over, _live = _k17_case(KEYS, len(KEYS), 4096, lows, highs, cap,
                                slotted)
    assert (got_over > 0) == over


def test_k17_capacity_pad_rows_never_match():
    # the key's pad rows (zeros past n) must not enter the search: a low
    # bound of 0 finds the table's first row, not a pad row
    keys = np.arange(100, 1100, dtype=np.int32)
    over, live = _k17_case(keys, len(keys), 2048, [(0, "left")],
                           [(150, "left")], 1024, True)
    assert over == 0 and live <= 50


def test_k17_wrapper_runs_the_plain_version_on_cpu():
    key = torch.arange(4096, dtype=torch.int32)
    sel = torch.ones(4096, dtype=torch.bool)
    lo = torch.tensor(1000, dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    outs, osel, nrows, ovf = kernels.slice_scan(
        key, 4096, [(lo, "left")], [], 1024, [key], sel)
    assert kernels.LAUNCHES == before  # plain runs are not launches
    assert int(outs[0][0]) == 1000 and int(nrows) == 1024
    assert int(ovf) == 4096 - 1000 - 1024
