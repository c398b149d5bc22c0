"""PX distributed execution of the port against the JAX package: twins of
tests/test_px.py's TPC-H and aggregate cases and of tests/test_px_single.py.

Every statement runs three ways over the same generated tables (the two
packages' own generators, one seed): the port's PxExecutor on 8 `cpu`
shards (parallel/px.py, one thread a shard), the port's single-device
Executor, and the JAX PxExecutor on its 8 virtual CPU devices. The rows
(order-free, tests/torch_twins.px_rows) must agree: integers, decimals,
dates and strings exactly, float columns to rel 1e-12 (the backends and
the merges sum in different orders).
"""

import numpy as np
import pytest

from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.parallel.mesh import make_mesh as j_make_mesh
from oceanbase_tpu.parallel.px import PxExecutor as JPx
from oceanbase_tpu.sql import parser as JP
from oceanbase_tpu.sql.planner import Planner as JPlanner
from oceanbase_tpu_torch.engine.executor import Executor as TExecutor
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import QUERIES, UNIQUE_KEYS
from oceanbase_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from oceanbase_tpu_torch.parallel.px import PxExecutor as TPx
from oceanbase_tpu_torch.sql import parser as TP
from oceanbase_tpu_torch.sql.planner import Planner as TPlanner
from torch_twins import px_rows, rows_equal

NSH = 8
_EMPTY_AT_SF001 = {20}  # Q20's nested filters select no suppliers at sf=0.01


def build_env(sf: float):
    jt = JD.generate(sf=sf, seed=19920101)
    tt = TD.generate(sf=sf, seed=19920101)
    return {
        "jt": jt, "tt": tt,
        "jplanner": JPlanner(jt), "tplanner": TPlanner(tt),
        "jpx": JPx(jt, j_make_mesh(NSH), unique_keys=UNIQUE_KEYS),
        "tpx": TPx(tt, t_make_mesh(devices=["cpu"] * NSH),
                   unique_keys=UNIQUE_KEYS),
        "single": TExecutor(tt, unique_keys=UNIQUE_KEYS, device="cpu"),
    }


def check_three(env, sql, expect_rows=True, tpx=None, jpx=None,
                vs_single=True):
    """Port PX == port single device == JAX PX; returns the port's rows."""
    jp = env["jplanner"].plan(JP.parse(sql))
    tp = env["tplanner"].plan(TP.parse(sql))
    names = list(tp.output_names)
    assert names == list(jp.output_names)
    got = px_rows((tpx or env["tpx"]).execute(tp.plan), names)
    single = px_rows(env["single"].execute(tp.plan), names)
    ref = px_rows((jpx or env["jpx"]).execute(jp.plan), names)
    what = " ".join(sql.split())[:60]
    if vs_single:
        rows_equal(single, got, f"port PX vs single device: {what}")
    rows_equal(ref, got, f"port PX vs JAX PX: {what}")
    if expect_rows:
        assert got, f"{what}: every executor empty"
    return got


@pytest.fixture(scope="module")
def env():
    return build_env(0.01)


# every distribution shape, via the real TPC-H suite: all 22 queries
@pytest.mark.parametrize("qid", list(range(1, 23)))
def test_tpch_distributed(env, qid):
    check_three(env, QUERIES[qid], expect_rows=qid not in _EMPTY_AT_SF001)


def test_small_groupby_is_merge_not_exchange(env):
    """Q1's small-domain group-by moves no rows: local partials merged
    over the shards (K27), the result replicated."""
    check_three(env, QUERIES[1])
    tp = env["tplanner"].plan(TP.parse(QUERIES[1]))
    prepared = env["tpx"].prepare(tp.plan)
    prepared.run()
    kinds = [e.kind for e in prepared.mesh_plan.exchanges]
    assert "merge" in kinds and "repartition" not in kinds


def test_distinct_aggs_distributed(env):
    """DISTINCT aggregates do not double-count across shards: grouped
    distinct repartitions by the group keys, scalar distinct by the
    distinct argument before the partials merge."""
    check_three(env, """
        select c_nationkey, count(distinct c_mktsegment) as d,
               count(*) as n
        from customer group by c_nationkey
    """)
    check_three(env, """
        select count(distinct c_nationkey) as d, count(*) as n
        from customer
    """)
    check_three(env, """
        select sum(distinct o_shippriority) as sd
        from orders
    """)


# ---------------------------------------------------- tests/test_px_single.py

@pytest.fixture(scope="module")
def env_single():
    return build_env(0.005)


@pytest.mark.parametrize("qid", [1, 6, 3])
def test_px_matches_single_chip(env_single, qid):
    check_three(env_single, QUERIES[qid])


def test_px_scalar_approx_ndv(env_single):
    """Scalar approx_count_distinct under PX: rows colocate by the
    argument, per-shard HLL sketches of disjoint value sets merge: a sum
    of 8 estimates, not the single device's one, so it equals the
    reference PX's estimate, and each is within 5% of the exact NDV."""
    sql = "select approx_count_distinct(l_partkey) as n from lineitem"
    got = check_three(env_single, sql, vs_single=False)
    tp = env_single["tplanner"].plan(TP.parse(sql))
    (single,) = px_rows(env_single["single"].execute(tp.plan), ["n"])
    exact = len(np.unique(np.asarray(
        env_single["tt"]["lineitem"].data["l_partkey"])))
    for (n,) in (got[0], single):
        assert abs(int(n) - exact) / max(exact, 1) < 0.05
