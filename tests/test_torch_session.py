"""The port end to end: SQL text through the JAX Session and the torch
port's Session (on the CPU, plain kernel versions) over the same TPC-H
data at SF 0.01, plus the plan cache's text tier, the overflow retries
(root compaction, the top-k prefilter, the pack guard), the clustered-FK
route, the int64 numpy oracles of the join statements, and the Distinct
operator against the JAX package's `_dedup_batch` on NULLs and NaNs.

Integers, scaled decimals, dates, dictionary strings, counts and row order
must match exactly; float64 columns (the AVGs) compare at rel 1e-12.
"""

import numpy as np
import pytest
import torch

from oceanbase_tpu.engine.executor import PACK_GUARD_BASE as J_PACK
from oceanbase_tpu.engine.executor import ROOT_COMPACT as J_ROOT
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.sql import parser as JP
from oceanbase_tpu_torch.engine.executor import PACK_GUARD_BASE as T_PACK
from oceanbase_tpu_torch.engine.executor import ROOT_COMPACT as T_ROOT
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch import queries as TQ
from oceanbase_tpu_torch.models.tpch import sql_suite as TS
from oceanbase_tpu_torch.sql import parser as TP

S1 = """select l_orderkey, l_linenumber, l_extendedprice, l_shipdate
from lineitem
where l_shipdate = date '{day}' and l_quantity < 10
order by l_extendedprice desc, l_orderkey, l_linenumber"""

STATEMENTS = {
    "q1": TS.QUERIES[1],
    "q6": TS.QUERIES[6],
    "s1": S1.format(day="1995-06-17"),
    "s1_rebound": S1.format(day="1996-02-29"),
    "direct_minmax": """select l_shipmode, min(l_quantity), max(l_extendedprice),
        count(*), sum(l_tax) from lineitem where l_discount > 0.04
        group by l_shipmode order by l_shipmode""",
    "scalar_minmax": """select min(l_shipdate), max(l_discount), count(l_tax),
        sum(l_quantity) from lineitem where l_shipdate > date '1998-01-01'""",
    "scalar_empty": """select sum(l_quantity), count(*), min(l_tax)
        from lineitem where l_quantity < 0""",
    "limit": """select l_orderkey, l_partkey from lineitem
        where l_quantity < 5 limit 7""",
    "filter_sort_strings": """select l_returnflag, l_shipmode, l_orderkey
        from lineitem where l_shipmode = 'AIR' and l_quantity > 49
        order by l_returnflag desc, l_orderkey desc, l_linenumber""",
    # the join slice: affine joins (K5), clustered-FK aggregation (K6),
    # top-k candidates (K7), the sort group-by (K3 + K4 + K8)
    "q3": TS.QUERIES[3],
    "q14": TS.QUERIES[14],
    "q10": TS.QUERIES[10],
    "q7": TS.QUERIES[7],
    "q8": TS.QUERIES[8],
    "q19": TS.QUERIES[19],
    "affine_filtered_build": """select p_brand, count(*), sum(l_extendedprice),
        min(p_size) from lineitem, part
        where l_partkey = p_partkey and p_size < 10 and l_quantity < 5
        group by p_brand order by p_brand""",
    "clustered_count_col": """select l_orderkey, o_orderdate, count(*),
        count(case when l_quantity > 2500 then l_tax end), sum(l_quantity)
        from lineitem, orders
        where l_orderkey = o_orderkey and o_orderdate < date '1992-03-01'
        group by l_orderkey, o_orderdate order by l_orderkey limit 15""",
    "tie_topn": """select l_orderkey, l_linenumber, l_quantity from lineitem
        order by l_quantity desc limit 5""",
    "sort_groupby_packed": """select l_suppkey, l_returnflag, count(*),
        sum(l_quantity), min(l_discount), max(l_tax) from lineitem
        where l_shipdate < date '1992-06-01'
        group by l_suppkey, l_returnflag order by l_suppkey, l_returnflag""",
    "sort_groupby_three_keys": """select o_orderpriority, o_orderstatus,
        extract(year from o_orderdate) as y, count(*), max(o_totalprice),
        min(o_custkey) from orders where o_orderdate < date '1993-01-01'
        group by o_orderpriority, o_orderstatus, y
        order by o_orderpriority, o_orderstatus, y""",
    # left joins with a residual, Distinct over NULL groups, semi/anti
    # joins on each route
    "left_join_residual": """select c_custkey, count(o_orderkey),
        sum(o_totalprice), min(o_orderdate) from customer left join orders
        on c_custkey = o_custkey and o_totalprice > c_acctbal * 20
        group by c_custkey order by c_custkey limit 40""",
    "left_join_rows": """select c_custkey, o_orderkey, o_totalprice
        from customer left outer join orders on c_custkey = o_custkey
        and o_orderdate < date '1992-02-01' where c_custkey < 60
        order by c_custkey, o_orderkey""",
    "distinct_null_groups": """select distinct o_orderstatus, l_returnflag,
        l_linestatus from orders left join lineitem
        on o_orderkey = l_orderkey and l_quantity > 49
        order by o_orderstatus, l_returnflag, l_linestatus""",
    "distinct_keys": """select distinct l_shipmode, l_returnflag, l_quantity
        from lineitem where l_discount = 0.1
        order by l_shipmode, l_returnflag, l_quantity""",
    "semi_residual": """select o_orderpriority, count(*) from orders
        where exists (select * from lineitem where l_orderkey = o_orderkey
        and l_suppkey <> o_custkey and l_quantity > 4800)
        group by o_orderpriority order by o_orderpriority""",
    "anti_sorted_range": """select count(*), sum(c_acctbal) from customer
        where not exists (select * from orders where o_custkey = c_custkey)""",
    "anti_affine": """select count(*) from partsupp where ps_suppkey not in
        (select s_suppkey from supplier where s_acctbal < 0)""",
}


@pytest.fixture(scope="module")
def sessions():
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    js = JSession(jt, unique_keys=TS.UNIQUE_KEYS)
    ts = TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu")
    return js, ts, tt


def _rows_equal(jrows, trows, what):
    assert len(jrows) == len(trows), what
    for i, (a, b) in enumerate(zip(jrows, trows)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, (float, np.floating)):
                assert isinstance(y, (float, np.floating)), what
                if np.isnan(x):
                    assert np.isnan(y), f"{what} row {i}"
                else:
                    assert y == pytest.approx(x, rel=1e-12, abs=0.0), \
                        f"{what} row {i}: {x} vs {y}"
            else:
                assert type(x) is type(y) or (x is None) == (y is None), \
                    f"{what} row {i}: {type(x)} vs {type(y)}"
                assert x == y, f"{what} row {i}: {x} vs {y}"


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_matches_jax(sessions, name):
    js, ts, _ = sessions
    text = STATEMENTS[name]
    jr = js.sql(text)
    tr = ts.sql(text)
    assert tuple(jr.names) == tuple(tr.names)
    assert jr.nrows == tr.nrows
    _rows_equal(jr.rows(), tr.rows(), name)


def test_rebound_literal_hits_the_text_tier(sessions):
    js, ts, _ = sessions
    for day in ("1995-03-01", "1996-08-08", "1997-01-31"):
        text = S1.format(day=day)
        jr, tr = js.sql(text), ts.sql(text)
        _rows_equal(jr.rows(), tr.rows(), day)
    # same normalized text, new literal: the cached plan re-bound
    assert tr.fast_path_hit and tr.plan_cache_hit
    assert ts.last_phases["fast_hit"]


def test_slice_results_equal_int64_oracles(sessions):
    _, ts, tt = sessions
    li = tt["lineitem"]
    q6 = ts.sql(TS.QUERIES[6]).storage_columns()["revenue"]
    assert int(q6[0]) == TQ.q6_numpy(li)
    q1 = ts.sql(TS.QUERIES[1]).storage_columns()
    ref = TQ.q1_numpy_fast(li)
    nls = len(li.dicts["l_linestatus"])
    keys = q1["l_returnflag"].astype(np.int64) * nls + q1["l_linestatus"]
    assert np.array_equal(q1["sum_charge"], ref["sum_ch"][keys])
    assert np.array_equal(q1["sum_disc_price"], ref["sum_dp"][keys])
    assert np.array_equal(q1["count_order"], ref["count"][keys])
    for day in ("1995-06-17", "1996-02-29"):
        got = ts.sql(S1.format(day=day)).storage_columns()
        want = TQ.s1_numpy(li, day)
        for c in want:
            assert np.array_equal(got[c], want[c]), (day, c)


def _prepared(sess, parser, root, text, cap):
    planned = sess.planner.plan(parser.parse(text))
    prep = sess.executor.prepare(planned.plan)
    prep.params.join_cap[root] = cap
    prep.recompile()
    return prep


def test_root_compaction_overflow_retry_matches_jax(sessions):
    """A root-compaction capacity far below the result forces an overflow:
    both engines bump it x4 and re-run the same number of times, and land
    on the same rows."""
    from oceanbase_tpu.core.column import batch_to_host as j_host
    from oceanbase_tpu_torch.core.column import batch_to_host as t_host

    js, ts, _ = sessions
    text = S1.format(day="1995-06-17")
    jp = _prepared(js, JP, J_ROOT, text, 1)
    tp = _prepared(ts, TP, T_ROOT, text, 1)
    jo, to = jp.run(), tp.run()
    assert jp.retries == tp.retries >= 1
    assert jp.params.join_cap[J_ROOT] == tp.params.join_cap[T_ROOT]
    jh, th = j_host(jo), t_host(to)
    for c in jh:
        assert np.array_equal(np.asarray(jh[c]), np.asarray(th[c])), c


def test_overflow_retry_through_the_lazy_cursor(sessions):
    """The same retry when the overflow surfaces at the result cursor's
    first sync (the Session path)."""
    from oceanbase_tpu_torch.engine.executor import DeviceResult

    js, ts, _ = sessions
    text = S1.format(day="1995-06-17")
    tp = _prepared(ts, TP, T_ROOT, text, 2)
    out, ovf = tp.run_device()
    cur = DeviceResult(tp, (), out, ovf)
    want = js.sql(text)
    assert cur.nrows == want.nrows
    assert tp.retries >= 1
    got = cur.fetch_columns()
    _rows_equal(want.rows(), list(zip(*[got[n] for n in want.names])),
                "cursor retry")


def test_unported_nodes_raise_by_name(sessions):
    """WITH RECURSIVE, which the port once refused by name, now runs as
    the reference's host fixpoint and returns its rows."""
    js, ts, _ = sessions
    text = ("with recursive cnt as (select 1 as n union all "
            "select n + 1 as n from cnt where n < 5) select n from cnt")
    jr, tr = js.sql(text), ts.sql(text)
    assert tuple(tr.names) == tuple(jr.names)
    _rows_equal(jr.rows(), tr.rows(), "recursive counter")
    assert [r[0] for r in tr.rows()] == [1, 2, 3, 4, 5]


def _dedup_case(seed: int):
    """A batch with duplicate rows, NULLs in two columns, NaNs, int64
    extremes, a bool column and dead rows."""
    rng = np.random.default_rng(seed)
    n = 900
    pool = 40
    f = rng.normal(0.0, 5.0, pool).round(1)
    f[:3] = np.nan
    i64 = rng.integers(-3, 3, pool) * (2**62)
    i64[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    rows = rng.integers(0, pool, n)
    data = {
        "a": rng.integers(0, 4, pool).astype(np.int32)[rows],
        "f": f[rows],
        "i": i64[rows],
        "b": (rng.random(pool) < 0.5)[rows],
    }
    vf = rng.random(pool) < 0.8
    vf[:3] = True  # the NaN values are not NULL
    valid = {"a": (rng.random(pool) < 0.7)[rows], "f": vf[rows]}
    sel = rng.random(n) < 0.8
    return data, valid, sel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_batch_matches_jax(seed):
    """The Distinct operator (Executor._dedup_batch) on both engines over
    the same batch: NULLs compare equal (a NULL group per column), NaN
    does not equal NaN (each NaN row survives), dead rows drop out; the
    surviving rows, in sorted order, must be the same values and
    validity bit for bit."""
    from oceanbase_tpu.core.column import make_batch as j_make
    from oceanbase_tpu.core.dtypes import DataType as JDT
    from oceanbase_tpu.core.dtypes import Field as JF
    from oceanbase_tpu.core.dtypes import Schema as JS
    from oceanbase_tpu.engine.executor import Executor as JEx
    from oceanbase_tpu_torch.core.column import make_batch as t_make
    from oceanbase_tpu_torch.core.dtypes import DataType as TDT
    from oceanbase_tpu_torch.core.dtypes import Field as TF
    from oceanbase_tpu_torch.core.dtypes import Schema as TSch
    from oceanbase_tpu_torch.engine.executor import Executor as TEx

    data, valid, sel = _dedup_case(seed)
    types = {"a": "int32", "f": "float64", "i": "int64", "b": "bool_"}
    nullable = {"a", "f"}
    js = JS(tuple(JF(c, getattr(JDT, t)(nullable=c in nullable))
                  for c, t in types.items()))
    tsch = TSch(tuple(TF(c, getattr(TDT, t)(nullable=c in nullable))
                      for c, t in types.items()))
    jb = j_make(data, js, valid=valid)
    tb = t_make(data, tsch, valid=valid, device="cpu")
    jb = jb.with_sel(jb.sel & np.pad(sel, (0, jb.capacity - len(sel))))
    tb = tb.with_sel(tb.sel & torch.from_numpy(
        np.pad(sel, (0, tb.capacity - len(sel)))))
    jo, _ = JEx({})._dedup_batch(jb, {})
    to, _ = TEx({}, device="cpu")._dedup_batch(tb, {})
    jsel, tsel = np.asarray(jo.sel), to.sel.numpy()
    assert jsel.sum() == tsel.sum() > 0
    assert int(to.nrows) == int(jo.nrows)
    for c in types:
        j = np.asarray(jo.cols[c])[jsel]
        t = to.cols[c].numpy()[tsel]
        assert j.dtype == t.dtype, c
        assert np.array_equal(j, t, equal_nan=j.dtype.kind == "f"), c
        if c in nullable:
            assert np.array_equal(np.asarray(jo.valid[c])[jsel],
                                  to.valid[c].numpy()[tsel]), c
    # NaN != NaN: every live NaN row survives on its own
    fv = to.cols["f"].numpy()[tsel]
    live_nan = np.isnan(data["f"]) & valid["f"] & sel
    assert np.isnan(fv).sum() >= 1 and np.isnan(fv).sum() <= live_nan.sum()


def test_run_host_matches_lazy_cursor(sessions):
    from oceanbase_tpu_torch.core.column import host_rows

    js, ts, _ = sessions
    text = STATEMENTS["direct_minmax"]
    planned = ts.planner.plan(TP.parse(text))
    hcols, hvalid, hsel, schema, dicts = \
        ts.executor.prepare(planned.plan).run_host()
    host = host_rows(schema, dicts, hcols, hvalid, hsel)
    want = js.sql(text)
    got = list(zip(*[host[n] for n in schema.names()]))
    _rows_equal(want.rows(), got, "run_host")


ORACLES = {
    "q3": (3, TQ.q3_numpy),
    "q14": (14, TQ.q14_numpy),
    "q10": (10, TQ.q10_numpy),
    "q7": (7, TQ.q7_numpy),
    "q8": (8, TQ.q8_numpy),
    "q19": (19, TQ.q19_numpy),
}


@pytest.mark.parametrize("name", list(ORACLES))
def test_join_oracles_equal_jax(sessions, name):
    """Each int64 oracle equals the JAX Session's result: scaled decimals,
    dates and dictionary codes exactly, a ratio at rel 1e-12."""
    from oceanbase_tpu.core.column import batch_rows_storage

    js, _ts, tt = sessions
    q, oracle = ORACLES[name]
    planned = js.planner.plan(JP.parse(TS.QUERIES[q]))
    out = js.executor.prepare(planned.plan).run()
    got = batch_rows_storage(out, list(planned.output_names))
    ref = oracle(tt)
    if name == "q19":
        assert int(got["revenue"][0]) == ref
        return
    for col, v in got.items():
        want = ref[col]
        if np.asarray(v).dtype.kind == "f":
            np.testing.assert_allclose(v, want, rtol=1e-12, atol=0.0)
        else:
            assert np.array_equal(np.asarray(v), np.asarray(want)), col


def test_topn_tie_overflow_retry_matches_jax(sessions):
    """A low-cardinality first key puts more live ties at the C-th value
    than C candidates: both engines count the overflow, turn the
    prefilter off and re-run through the full sort the same number of
    times, and land on the same rows."""
    from oceanbase_tpu.core.column import batch_to_host as j_host
    from oceanbase_tpu_torch.core.column import batch_to_host as t_host

    js, ts, _ = sessions
    text = STATEMENTS["tie_topn"]
    jp = js.executor.prepare(js.planner.plan(JP.parse(text)).plan)
    tp = ts.executor.prepare(ts.planner.plan(TP.parse(text)).plan)
    assert jp.params.topn_cand == tp.params.topn_cand
    assert tp.params.topn_cand
    jo, to = jp.run(), tp.run()
    assert jp.retries == tp.retries == 1
    assert jp.params.topn_cand == tp.params.topn_cand
    assert set(tp.params.topn_cand.values()) == {1 << 62}
    jh, th = j_host(jo), t_host(to)
    for c in jh:
        assert np.array_equal(np.asarray(jh[c]), np.asarray(th[c])), c


def test_pack_guard_overflow_retry_matches_jax(sessions):
    """A pack spec narrower than the data trips the pack-validity guard:
    both engines drop packing for the node and re-run unpacked, the same
    number of times, with the same rows."""
    js, ts, _ = sessions
    text = STATEMENTS["sort_groupby_packed"]
    jp = js.executor.prepare(js.planner.plan(JP.parse(text)).plan)
    tp = ts.executor.prepare(ts.planner.plan(TP.parse(text)).plan)
    assert jp.params.pack_guard == tp.params.pack_guard
    (nid, spec), = tp.params.pack_guard.items()
    narrow = tuple((vmin, 2) for vmin, _bits in spec)
    for prep in (jp, tp):
        prep.params.pack_guard[nid] = narrow
        prep.recompile()
    jo, to = jp.run(), tp.run()
    assert jp.retries == tp.retries == 1
    assert jp.params.groupby_nopack == tp.params.groupby_nopack == {nid}
    assert J_PACK == T_PACK
    from oceanbase_tpu.core.column import batch_to_host as j_host
    from oceanbase_tpu_torch.core.column import batch_to_host as t_host

    jh, th = j_host(jo), t_host(to)
    for c in jh:
        assert np.array_equal(np.asarray(jh[c]), np.asarray(th[c])), c


@pytest.mark.parametrize("name,want", [("q3", True), ("q10", False),
                                       ("clustered_count_col", True)])
def test_clustered_route_detection_matches_jax(sessions, name, want):
    """The clustered-FK segment route is chosen for the same plans (Q3
    groups by the join key; Q10 groups coarser than build rows)."""
    js, ts, _ = sessions
    text = STATEMENTS[name]
    jp = js.executor.prepare(js.planner.plan(JP.parse(text)).plan)
    tp = ts.executor.prepare(ts.planner.plan(TP.parse(text)).plan)
    assert sorted(jp.params.clustered_aggs) == sorted(tp.params.clustered_aggs)
    assert bool(tp.params.clustered_aggs) is want
    assert [a for a, _t, _c in jp.input_spec] == [
        a for a, _t, _c in tp.input_spec]


def test_clustered_premise_invalidation_matches_jax():
    """The clustered-FK route rests on lineitem being stored in l_orderkey
    order. Reorder the rows (same data, so the answer stays) and
    invalidate the table: a cached plan finds the premise gone at input
    assembly, recompiles without the segment route, and both engines
    still give the same rows."""
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    js = JSession(jt, unique_keys=TS.UNIQUE_KEYS)
    ts = TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu")
    text = STATEMENTS["clustered_count_col"]
    jp = js.executor.prepare(js.planner.plan(JP.parse(text)).plan)
    tp = ts.executor.prepare(ts.planner.plan(TP.parse(text)).plan)
    assert tp.params.clustered_aggs and jp.params.clustered_aggs
    _rows_equal(js.sql(text).rows(), ts.sql(text).rows(), "clustered")
    perm = np.random.default_rng(4).permutation(tt["lineitem"].nrows)
    for tables, sess in ((jt, js), (tt, ts)):
        li = tables["lineitem"]
        for c in list(li.data):
            li.data[c] = np.ascontiguousarray(li.data[c][perm])
        sess.executor.invalidate_table("lineitem")
    from oceanbase_tpu.core.column import batch_to_host as j_host
    from oceanbase_tpu_torch.core.column import batch_to_host as t_host

    jo, to = jp.run(), tp.run()
    assert not tp.params.clustered_aggs and not jp.params.clustered_aggs
    jh, th = j_host(jo), t_host(to)
    for c in jh:
        assert np.array_equal(np.asarray(jh[c]), np.asarray(th[c])), c
