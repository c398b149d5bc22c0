"""Window functions through the port's Session on the CPU against the JAX
Session: the single-chip window cases of tests/test_window_setops.py on
the same TPC-H tables (SF 0.003, seed 19920101), the small padded-table
cases, and the frames the reference rejects, which the port must reject
too. Rows must be equal (storage exact, floats such as window AVG to rel
1e-12, tests/torch_twins.py).
"""

import numpy as np
import pytest

from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.sql.logical import ResolveError as JResolveError
from oceanbase_tpu_torch.core.table import table_from_arrays
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import UNIQUE_KEYS
from oceanbase_tpu_torch.sql.logical import ResolveError as TResolveError
from tests.torch_twins import check_twin

SEED = 19920101


@pytest.fixture(scope="module")
def engines():
    js = JSession(JD.generate(sf=0.003, seed=SEED), unique_keys=UNIQUE_KEYS)
    ts = TSession(TD.generate(sf=0.003, seed=SEED), unique_keys=UNIQUE_KEYS,
                  device="cpu")
    return js, ts


WINDOW_CASES = {
    "row_number": """
        select o_orderkey, row_number() over (
            partition by o_custkey order by o_orderdate, o_orderkey) as rn
        from orders where o_orderkey <= 2000""",
    "rank_dense_rank": """
        select c_custkey,
               rank() over (partition by c_nationkey order by c_acctbal desc) as r,
               dense_rank() over (partition by c_nationkey order by c_acctbal desc) as dr
        from customer where c_custkey <= 300""",
    "sum_over_partition": """
        select o_orderkey, o_custkey,
               sum(o_totalprice) over (partition by o_custkey) as tot,
               count(*) over (partition by o_custkey) as cnt
        from orders where o_orderkey <= 2000""",
    "running_sum": """
        select o_orderkey,
               sum(o_totalprice) over (
                   partition by o_custkey order by o_orderdate, o_orderkey) as run
        from orders where o_orderkey <= 2000""",
    "running_sum_with_peers": """
        select o_orderkey,
               sum(o_totalprice) over (
                   partition by o_custkey order by o_orderdate) as run,
               count(*) over (
                   partition by o_custkey order by o_orderdate) as cnt
        from orders where o_orderkey <= 2000""",
    "min_max_running": """
        select o_orderkey,
               min(o_totalprice) over (
                   partition by o_custkey order by o_orderdate, o_orderkey) as mn,
               max(o_totalprice) over (
                   partition by o_custkey order by o_orderdate, o_orderkey) as mx
        from orders where o_orderkey <= 2000""",
    "avg_window": """
        select c_custkey,
               avg(c_acctbal) over (partition by c_nationkey) as a
        from customer where c_custkey <= 300""",
    "no_partition": """
        select o_orderkey,
               row_number() over (order by o_totalprice desc, o_orderkey) as rn
        from orders where o_orderkey <= 1000""",
    "over_aggregate": """
        select c_nationkey, count(*) as n,
               rank() over (order by count(*) desc, c_nationkey) as r
        from customer group by c_nationkey""",
    "then_orderby_alias": """
        select o_orderkey,
               row_number() over (partition by o_custkey
                                  order by o_orderdate, o_orderkey) as rn
        from orders where o_orderkey <= 1000
        order by rn, o_orderkey
        limit 20""",
    "lag_lead": """
        select o_orderkey,
               lag(o_totalprice) over (partition by o_custkey
                                       order by o_orderdate, o_orderkey) as p,
               lead(o_totalprice) over (partition by o_custkey
                                        order by o_orderdate, o_orderkey) as nx
        from orders where o_orderkey <= 3000""",
    "lag_offset_default": """
        select o_orderkey,
               lag(o_shippriority, 2, -1) over (
                   partition by o_custkey
                   order by o_orderdate, o_orderkey) as p2
        from orders where o_orderkey <= 3000""",
    "ntile": """
        select c_custkey, ntile(4) over (
            partition by c_nationkey order by c_acctbal, c_custkey) as q
        from customer""",
    "first_last_value": """
        select o_orderkey,
               first_value(o_totalprice) over (
                   partition by o_custkey
                   order by o_orderdate, o_orderkey) as fv,
               last_value(o_totalprice) over (
                   partition by o_custkey
                   order by o_orderdate, o_orderkey) as lv
        from orders where o_orderkey <= 3000""",
    "rows_moving_sum": """
        select o_orderkey,
               sum(o_totalprice) over (
                   partition by o_custkey order by o_orderdate, o_orderkey
                   rows between 2 preceding and current row) as mv,
               count(*) over (
                   partition by o_custkey order by o_orderdate, o_orderkey
                   rows between 1 preceding and 1 following) as c3
        from orders where o_orderkey <= 3000""",
    "rows_unbounded_following": """
        select o_orderkey,
               sum(o_totalprice) over (
                   partition by o_custkey order by o_orderdate, o_orderkey
                   rows between current row and unbounded following) as rest,
               max(o_totalprice) over (
                   partition by o_custkey order by o_orderdate, o_orderkey
                   rows between current row and unbounded following) as mx
        from orders where o_orderkey <= 3000""",
    "rows_shorthand": """
        select o_orderkey,
               sum(o_shippriority) over (
                   order by o_orderkey rows 3 preceding) as s
        from orders where o_orderkey <= 2000""",
    "range_value_offset_date": """
        select o_orderkey,
               count(*) over (
                   partition by o_custkey order by o_orderdate
                   range between 30 preceding and current row) as recent
        from orders where o_orderkey <= 3000""",
    "range_int_key": """
        select o_orderkey,
               sum(o_shippriority) over (
                   order by o_orderkey
                   range between 500 preceding and 500 following) as s
        from orders where o_orderkey <= 4000""",
    "range_desc_key": """
        select o_orderkey,
               count(*) over (
                   partition by o_custkey order by o_orderdate desc
                   range between 30 preceding and current row) as upcoming
        from orders where o_orderkey <= 3000""",
    "range_decimal_key": """
        select c_custkey,
               count(*) over (
                   partition by c_nationkey order by c_acctbal
                   range between 100 preceding and 50 following) as near
        from customer where c_custkey <= 600""",
    "avg_window_frame": """
        select o_orderkey,
               avg(o_totalprice) over (
                   partition by o_custkey order by o_orderdate, o_orderkey
                   rows between 2 preceding and current row) as a
        from orders where o_orderkey <= 3000""",
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_window_matches_jax(engines, name):
    js, ts = engines
    check_twin(js, ts, WINDOW_CASES[name])


@pytest.fixture(scope="module")
def small():
    """A 6-row table padded to capacity 1024, in both packages."""
    k = np.arange(6)
    v = (np.arange(6) + 1) * 10
    I64 = JDT.int64()
    jt = JTable.from_pydict("t", JSchema((JField("k", I64), JField("v", I64))),
                            {"k": k, "v": v})
    tt = table_from_arrays("t", [("k", "int64", 0, 0, False),
                                 ("v", "int64", 0, 0, False)],
                           {"k": k, "v": v})
    return JSession({"t": jt}), TSession({"t": tt}, device="cpu")


SMALL_CASES = {
    "ntile_padding": "select k, ntile(3) over (order by k) as b from t",
    "lead_default": "select k, lead(v, 1, -99) over (order by k) as nx "
                    "from t",
    "unbounded_following": """
        select k, sum(v) over (order by k
            rows between current row and unbounded following) as rest,
            last_value(v) over (order by k
            rows between current row and unbounded following) as lv
        from t""",
    "range_outside_domain_is_empty": """
        select k,
            sum(v) over (order by k
                range between 5 preceding and 3 preceding) as s,
            count(v) over (order by k
                range between 3 following and 5 following) as c
        from t""",
}


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_window_small_table_matches_jax(small, name):
    js, ts = small
    rows = check_twin(js, ts, SMALL_CASES[name])
    assert len(rows) == 6
    if name == "ntile_padding":
        assert [int(r[1]) for r in rows] == [1, 1, 2, 2, 3, 3]
    if name == "range_outside_domain_is_empty":
        assert [int(r[2]) for r in rows] == [3, 2, 1, 0, 0, 0]


def test_rejected_frames_raise_in_both(engines):
    js, ts = engines
    sql = """select min(o_totalprice) over (
                 order by o_orderkey
                 rows between 2 preceding and current row) as m
             from orders"""
    with pytest.raises(JResolveError, match="one end"):
        js.sql(sql)
    with pytest.raises(TResolveError, match="one end"):
        ts.sql(sql)
    k = np.array([1.2, 2.5])
    v = np.array([1, 2])
    jt = JTable.from_pydict(
        "t", JSchema((JField("k", JDT.float64()), JField("v", JDT.int64()))),
        {"k": k, "v": v})
    tt = table_from_arrays("t", [("k", "float64", 0, 0, False),
                                 ("v", "int64", 0, 0, False)],
                           {"k": k, "v": v})
    fsql = """select count(v) over (order by k
                  range between 1 preceding and current row) as c from t"""
    with pytest.raises(JResolveError, match="integer-domain"):
        JSession({"t": jt}).sql(fsql)
    with pytest.raises(TResolveError, match="integer-domain"):
        TSession({"t": tt}, device="cpu").sql(fsql)
