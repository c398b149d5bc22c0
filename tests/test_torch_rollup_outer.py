"""ROLLUP / CUBE / GROUPING SETS and RIGHT / FULL outer joins through the
port's Session on the CPU against the JAX Session: the grouping-set cases
of tests/test_recursive_rollup.py and the cases of
tests/test_outer_joins.py on the same TPC-H tables (SF 0.003, seed
19920101). Rows must be equal (storage exact, floats to rel 1e-12,
tests/torch_twins.py). The grouping sets must emit their child once per
run (the reference re-traces it per set and leaves the copies to XLA's
common-subexpression pass), and the full join must mark its build side
through K11's second entry.
"""

import pytest

from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu_torch.engine import executor as TX
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import UNIQUE_KEYS
from oceanbase_tpu_torch.sql.logical import Scan
from tests.torch_twins import check_twin

SEED = 19920101


@pytest.fixture(scope="module")
def engines():
    js = JSession(JD.generate(sf=0.003, seed=SEED), unique_keys=UNIQUE_KEYS)
    ts = TSession(TD.generate(sf=0.003, seed=SEED), unique_keys=UNIQUE_KEYS,
                  device="cpu")
    return js, ts


GROUPING_CASES = {
    "rollup_q1_shape": """
        select l_returnflag, l_linestatus,
               sum(l_quantity) as sq, count(*) as n
        from lineitem
        where l_shipdate <= date '1998-09-02'
        group by rollup(l_returnflag, l_linestatus)""",
    "cube_counts": """
        select o_orderstatus, o_shippriority, count(*) as n
        from orders group by cube(o_orderstatus, o_shippriority)""",
    "grouping_sets_explicit": """
        select l_returnflag, l_linestatus, sum(l_extendedprice) as s
        from lineitem
        group by grouping sets ((l_returnflag), (l_linestatus), ())""",
    "rollup_under_cte": """
        with base as (select l_returnflag as f, l_quantity as q
                      from lineitem)
        select f, sum(q) as s from base group by rollup(f)""",
    "rollup_having_order": """
        select l_returnflag, l_linestatus, count(*) as n
        from lineitem group by rollup(l_returnflag, l_linestatus)
        having count(*) > 10 order by n desc""",
    "cube_wide_keys_distinct": """
        select o_orderpriority, o_clerk, count(distinct o_custkey) as c,
               sum(o_totalprice) as s
        from orders where o_orderkey <= 3000
        group by cube(o_orderpriority, o_clerk)""",
}


@pytest.mark.parametrize("name", sorted(GROUPING_CASES))
def test_grouping_sets_match_jax(engines, name):
    js, ts = engines
    check_twin(js, ts, GROUPING_CASES[name])


def test_grouping_sets_emit_child_once(engines, monkeypatch):
    _js, ts = engines
    scans = []
    orig = TX.Executor._emit_node

    def counted(self, op, *a, **k):
        if isinstance(op, Scan):
            scans.append(op.table)
        return orig(self, op, *a, **k)

    monkeypatch.setattr(TX.Executor, "_emit_node", counted)
    rows = ts.sql(GROUPING_CASES["cube_counts"]).rows()
    assert len(rows) > 4
    assert scans == ["orders"], scans


OUTER_CASES = {
    "right_join": """
        select o_orderkey, c_custkey, c_acctbal
        from orders o right join customer c on o_custkey = c_custkey
        where c_custkey <= 120""",
    "full_join": """
        select c_custkey, o_orderkey
        from customer c full join orders o on c_custkey = o_custkey
        where c_custkey <= 60 or c_custkey is null""",
    "full_join_counts": """
        select count(*) as n, count(c_custkey) as nc, count(o_orderkey) as no
        from customer c full join orders o on c_custkey = o_custkey""",
    "full_join_on_condition_not_pushed": """
        select c_custkey, o_orderkey
        from customer c full join orders o
          on c_custkey = o_custkey and o_orderkey < 1000
        where c_custkey <= 30 or c_custkey is null""",
    "full_join_two_keys": """
        select count(*) as n, count(l.l_orderkey) as nl,
               count(o.o_orderkey) as no
        from lineitem l full join orders o
          on l.l_orderkey = o.o_orderkey and l.l_linenumber = o.o_shippriority + 1""",
}


@pytest.mark.parametrize("name", sorted(OUTER_CASES))
def test_outer_joins_match_jax(engines, name, monkeypatch):
    js, ts = engines
    marks = []
    orig = TX.mark_build

    def counted(*a, **k):
        marks.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(TX, "mark_build", counted)
    check_twin(js, ts, OUTER_CASES[name])
    if name.startswith("full"):
        assert marks, "the full join did not mark its build side"
