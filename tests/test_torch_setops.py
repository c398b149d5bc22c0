"""Set operations, DISTINCT aggregates, approx_count_distinct and the
hash-set semi/anti join through the port's Session on the CPU against the
JAX Session: the set-operation and DISTINCT cases of
tests/test_window_setops.py on the same TPC-H tables (SF 0.003, seed
19920101), the SQL cases of tests/test_hll.py on a table built from
arrays (the port has no server layer yet), and multi-column semi/anti
joins without a residual (kernel K14's route). Rows must be equal
(storage exact, floats to rel 1e-12, tests/torch_twins.py); HLL estimates
exactly.
"""

import numpy as np
import pytest

from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu_torch.core.table import table_from_arrays
from oceanbase_tpu_torch.engine import executor as TX
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import UNIQUE_KEYS
from tests.torch_twins import check_twin

SEED = 19920101


@pytest.fixture(scope="module")
def engines():
    js = JSession(JD.generate(sf=0.003, seed=SEED), unique_keys=UNIQUE_KEYS)
    ts = TSession(TD.generate(sf=0.003, seed=SEED), unique_keys=UNIQUE_KEYS,
                  device="cpu")
    return js, ts


SETOP_CASES = {
    "union_all": """
        select c_nationkey as k from customer where c_acctbal < 0
        union all
        select s_nationkey from supplier where s_acctbal < 0""",
    "union_distinct": """
        select c_nationkey as k from customer
        union
        select s_nationkey from supplier""",
    "union_strings_distinct_dicts": """
        select c_mktsegment as v from customer where c_custkey <= 50
        union
        select o_orderpriority from orders where o_orderkey <= 400""",
    "intersect": """
        select c_nationkey as k from customer where c_acctbal > 5000
        intersect
        select s_nationkey from supplier""",
    "except": """
        select c_nationkey as k from customer
        except
        select s_nationkey from supplier where s_acctbal > 0""",
    "order_limit": """
        select c_nationkey as k from customer
        union
        select s_nationkey from supplier
        order by k desc
        limit 5""",
    "type_promotion": """
        select c_nationkey as k from customer where c_custkey < 5
        union
        select c_custkey from customer where c_custkey < 30""",
    "intersect_all": """
        select c_nationkey as k from customer where c_acctbal > 1000
        intersect all select s_nationkey from supplier""",
    "except_all": """
        select c_nationkey as k from customer where c_custkey <= 300
        except all select s_nationkey from supplier""",
    "intersect_all_multicol_dups": """
        select c_nationkey as a, c_mktsegment as b from customer
        where c_custkey <= 200
        intersect all
        select c_nationkey, c_mktsegment from customer
        where c_custkey between 100 and 400""",
    "intersect_all_with_nulls": """
        select c.c_nationkey as a, s.s_suppkey as b from customer c
        left join supplier s on c.c_custkey = s.s_suppkey
        where c.c_custkey <= 40
        intersect all
        select c.c_nationkey, s.s_suppkey from customer c
        left join supplier s on c.c_custkey = s.s_suppkey
        where c.c_custkey between 10 and 80""",
    "except_all_with_nulls": """
        select c.c_nationkey as a, s.s_suppkey as b from customer c
        left join supplier s on c.c_custkey = s.s_suppkey
        where c.c_custkey <= 40
        except all
        select c.c_nationkey, s.s_suppkey from customer c
        left join supplier s on c.c_custkey = s.s_suppkey
        where c.c_custkey between 10 and 80""",
    "intersect_with_nulls": """
        select c.c_nationkey as a, s.s_suppkey as b from customer c
        left join supplier s on c.c_custkey = s.s_suppkey
        where c.c_custkey <= 40
        intersect
        select c.c_nationkey, s.s_suppkey from customer c
        left join supplier s on c.c_custkey = s.s_suppkey
        where c.c_custkey between 10 and 80""",
    "except_all_surplus_duplicates": """
        select o_orderpriority as p from orders where o_orderkey <= 600
        except all
        select o_orderpriority from orders where o_orderkey <= 200""",
    "with_aggregates": """
        select c_nationkey as k, count(*) as n from customer
        group by c_nationkey
        except
        select s_nationkey, count(*) from supplier group by s_nationkey""",
    "two_column_intersect": """
        select o_custkey, o_orderpriority from orders
        where o_orderdate < date '1995-01-01'
        intersect
        select o_custkey, o_orderpriority from orders
        where o_orderdate >= date '1995-01-01'""",
    "customers_without_orders": """
        select c_custkey from customer
        except
        select o_custkey from orders""",
    "decimal_float_union": """
        select c_acctbal as v from customer where c_custkey <= 20
        union
        select cast(o_totalprice as double) from orders
        where o_orderkey <= 40""",
}


@pytest.mark.parametrize("name", sorted(SETOP_CASES))
def test_setop_matches_jax(engines, name):
    js, ts = engines
    check_twin(js, ts, SETOP_CASES[name])


DISTINCT_CASES = {
    "count_distinct_grouped": """
        select c_nationkey as k, count(distinct c_mktsegment) as d
        from customer group by c_nationkey""",
    "mixed_distinct_and_plain": """
        select c_nationkey as k,
               count(distinct c_mktsegment) as d,
               count(*) as n,
               sum(c_acctbal) as s
        from customer group by c_nationkey""",
    "sum_avg_distinct": """
        select o_orderpriority as p,
               sum(distinct o_shippriority) as sd,
               avg(distinct o_shippriority) as ad
        from orders group by o_orderpriority""",
    "scalar_distinct": """
        select count(distinct c_nationkey) as d, count(*) as n
        from customer""",
    "distinct_over_sort_groupby": """
        select l_returnflag, l_linestatus,
               count(distinct l_suppkey) as ns, sum(distinct l_quantity) as sq
        from lineitem where l_shipdate <= date '1998-09-02'
        group by l_returnflag, l_linestatus""",
    "distinct_nullable_group_key": """
        select s.s_nationkey as k, count(distinct c.c_mktsegment) as d
        from customer c left join supplier s on c.c_custkey = s.s_suppkey
        where c.c_custkey <= 60
        group by s.s_nationkey""",
    "grouped_approx_ndv_is_exact": """
        select o_orderpriority, approx_count_distinct(o_custkey) as n
        from orders group by o_orderpriority""",
    "scalar_approx_ndv": """
        select approx_count_distinct(l_orderkey) as a,
               approx_count_distinct(l_partkey) as b,
               approx_count_distinct(l_extendedprice) as c
        from lineitem""",
}


@pytest.mark.parametrize("name", sorted(DISTINCT_CASES))
def test_distinct_aggregates_match_jax(engines, name):
    js, ts = engines
    check_twin(js, ts, DISTINCT_CASES[name])


SEMI_CASES = {
    "exists_two_columns": """
        select count(*) as n from partsupp where exists (
            select * from lineitem
            where l_partkey = ps_partkey and l_suppkey = ps_suppkey)""",
    "not_exists_two_columns": """
        select ps_partkey, ps_suppkey from partsupp where not exists (
            select * from lineitem
            where l_partkey = ps_partkey and l_suppkey = ps_suppkey)
        order by ps_partkey, ps_suppkey limit 50""",
}


@pytest.mark.parametrize("name", sorted(SEMI_CASES))
def test_multicolumn_semi_anti_on_hash_set(engines, name, monkeypatch):
    js, ts = engines
    builds = []
    orig = TX.build_hash_table

    def counted(*a, **k):
        builds.append(len(a[0]))
        return orig(*a, **k)

    # the port's plans emit at every run, so the wrapper sees cached ones
    monkeypatch.setattr(TX, "build_hash_table", counted)
    check_twin(js, ts, SEMI_CASES[name])
    assert builds == [2], "the semi/anti join did not take the hash set"


@pytest.fixture(scope="module")
def ev():
    """tests/test_hll.py's table: 2000 rows, uid = id % 700, grp = id % 3."""
    ids = np.arange(2000, dtype=np.int64)
    data = {"id": ids, "uid": ids % 700, "grp": (ids % 3).astype(np.int32)}
    fields = (("id", "int64"), ("uid", "int64"), ("grp", "int32"))
    jt = JTable.from_pydict(
        "ev", JSchema(tuple(JField(n, getattr(JDT, k)())
                            for n, k in fields)), data)
    tt = table_from_arrays("ev", [(n, k, 0, 0, False) for n, k in fields],
                           data)
    return JSession({"ev": jt}), TSession({"ev": tt}, device="cpu")


def test_sql_scalar_approx_ndv(ev):
    js, ts = ev
    rows = check_twin(js, ts, "select approx_count_distinct(uid) as n "
                              "from ev")
    assert abs(int(rows[0][0]) - 700) / 700 < 0.05


def test_sql_grouped_approx_ndv_falls_back_exact(ev):
    js, ts = ev
    rows = check_twin(js, ts, "select grp, approx_count_distinct(uid) as n "
                              "from ev group by grp order by grp")
    ids = np.arange(2000)
    assert [int(r[1]) for r in rows] == [
        len(np.unique(ids[ids % 3 == g] % 700)) for g in range(3)]


def test_sql_approx_ndv_with_filter(ev):
    js, ts = ev
    rows = check_twin(js, ts, "select approx_count_distinct(uid) as n "
                              "from ev where id < 350")
    assert int(rows[0][0]) == 350
