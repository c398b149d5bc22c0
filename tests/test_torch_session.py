"""The slice end to end: SQL text through the JAX Session and the torch
port's Session (on the CPU, plain kernel versions) over the same TPC-H
data at SF 0.01, plus the plan cache's text tier and the root-compaction
overflow retry.

Integers, scaled decimals, dates, dictionary strings, counts and row order
must match exactly; float64 columns (the AVGs) compare at rel 1e-12.
"""

import numpy as np
import pytest

from oceanbase_tpu.engine.executor import ROOT_COMPACT as J_ROOT
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.sql import parser as JP
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
    _, ts, _ = sessions
    with pytest.raises(NotImplementedError, match="TopN"):
        ts.sql(TS.QUERIES[3])
    with pytest.raises(NotImplementedError, match="JoinOp"):
        ts.sql("select count(*) from orders, lineitem "
               "where o_orderkey = l_orderkey")


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
