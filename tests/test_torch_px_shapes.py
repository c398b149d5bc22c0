"""PX distribution shapes of the port against the JAX package: twins of
tests/test_px.py's big DISTINCT, big set operations, auto hybrid hash and
admission cases, and of tests/test_px_range.py (RANGE-distributed sorts,
hash-partitioned windows).

As in tests/test_torch_px.py, the port's PxExecutor on `cpu` shards, its
single-device Executor and the JAX PxExecutor must agree on the rows; each
reference assertion about the plan's shape (no full-capacity gather, the
hybrid route taken, the sort and window left SHARDED) holds on the port.
"""

import threading
import time

import numpy as np
import pytest

from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.parallel.mesh import make_mesh as j_make_mesh
from oceanbase_tpu.parallel.px import PxExecutor as JPx
from oceanbase_tpu.sql import parser as JP
from oceanbase_tpu.sql.planner import Planner as JPlanner
from oceanbase_tpu_torch.core.dtypes import DataType as TDT
from oceanbase_tpu_torch.core.dtypes import Field as TField
from oceanbase_tpu_torch.core.dtypes import Schema as TSchema
from oceanbase_tpu_torch.core.table import Table as TTable
from oceanbase_tpu_torch.engine.executor import Executor as TExecutor
from oceanbase_tpu_torch.engine.executor import _children
from oceanbase_tpu_torch.models.tpch.sql_suite import UNIQUE_KEYS
from oceanbase_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from oceanbase_tpu_torch.parallel.px import (
    _SORT_CHILD,
    SHARDED,
    PxAdmission,
)
from oceanbase_tpu_torch.parallel.px import PxExecutor as TPx
from oceanbase_tpu_torch.sql import parser as TP
from oceanbase_tpu_torch.sql.logical import Sort, Window
from oceanbase_tpu_torch.sql.planner import Planner as TPlanner
from test_torch_px import build_env, check_three
from torch_twins import rows_equal

NSH = 8


@pytest.fixture(scope="module")
def env():
    return build_env(0.01)


def _cpu_mesh(n=NSH):
    return t_make_mesh(devices=["cpu"] * n)


class _GatherSpy(TPx):
    """Records the capacity of every batch the plan gathers."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gathered = []

    def _gather_batch(self, b):
        self.gathered.append(b.capacity)
        return super()._gather_batch(b)


def test_big_distinct_repartitions_not_gathers(env):
    """A DISTINCT over a sharded relation above broadcast_threshold
    hash-repartitions: the only gather is the compacted root result."""
    px = _GatherSpy(env["tt"], _cpu_mesh(), unique_keys=UNIQUE_KEYS,
                    broadcast_threshold=1024)
    jpx = JPx(env["jt"], j_make_mesh(NSH), unique_keys=UNIQUE_KEYS,
              broadcast_threshold=1024)
    check_three(env, "select distinct l_suppkey from lineitem", tpx=px,
                jpx=jpx)
    li_cap = env["tt"]["lineitem"].nrows
    assert px.gathered, "root gather expected"
    assert all(c < li_cap for c in px.gathered), (px.gathered, li_cap)


@pytest.mark.parametrize("sql", [
    "select l_suppkey from lineitem union select s_suppkey from supplier",
    "select l_suppkey from lineitem union all select s_suppkey from supplier",
    "select l_suppkey from lineitem intersect select s_suppkey from supplier",
    "select l_suppkey from lineitem except all select s_suppkey from supplier",
])
def test_big_setops_copartition_not_gather(env, sql):
    """INTERSECT/EXCEPT/UNION over big sharded inputs co-partition by
    whole-row hash; UNION ALL concatenates with no exchange at all."""
    px = _GatherSpy(env["tt"], _cpu_mesh(), unique_keys=UNIQUE_KEYS,
                    broadcast_threshold=1024)
    jpx = JPx(env["jt"], j_make_mesh(NSH), unique_keys=UNIQUE_KEYS,
              broadcast_threshold=1024)
    check_three(env, sql, tpx=px, jpx=jpx)
    li_cap = env["tt"]["lineitem"].nrows
    assert all(c < li_cap for c in px.gathered), (sql, px.gathered)


def _skew_tables(pkg):
    DT, F, S, T = pkg
    I64 = DT.int64()
    rng = np.random.default_rng(5)
    n = 200_000
    nd = 100_000  # dim big enough that broadcast loses to hash on cost
    # 60% of fact rows hit key 7; the rest spread over the dim domain
    fk = np.where(rng.random(n) < 0.6, 7,
                  rng.integers(0, nd, n)).astype(np.int64)
    fact = T.from_pydict(
        "fact", S((F("fk", I64), F("v", I64))),
        {"fk": fk, "v": np.arange(n, dtype=np.int64)})
    dim = T.from_pydict(
        "dim", S((F("dk", I64), F("dv", I64))),
        {"dk": np.arange(nd, dtype=np.int64),
         "dv": np.arange(nd, dtype=np.int64) * 3})
    return {"fact": fact, "dim": dim}


def test_auto_hybrid_hash_on_skew():
    """A join key where one value dominates picks hybrid hash from the
    histograms alone (no explicit flag)."""
    jt = _skew_tables((JDT, JField, JSchema, JTable))
    tt = _skew_tables((TDT, TField, TSchema, TTable))
    calls = []

    class Spy(TPx):
        def _hybrid_exchange(self, *a, **kw):
            calls.append(1)
            return super()._hybrid_exchange(*a, **kw)

    uk = {"dim": ("dk",)}
    sql = "select sum(d.dv) as s from fact f, dim d where f.fk = d.dk"
    env = {
        "jplanner": JPlanner(jt), "tplanner": TPlanner(tt),
        "tpx": Spy(tt, _cpu_mesh(), unique_keys=uk, broadcast_threshold=256),
        "jpx": JPx(jt, j_make_mesh(NSH), unique_keys=uk,
                   broadcast_threshold=256),
        "single": TExecutor(tt, unique_keys=uk, device="cpu"),
    }
    check_three(env, sql)
    assert calls, "skewed join did not choose hybrid hash"


def test_admission_quota():
    adm = PxAdmission(target=10, queue_timeout_s=0.2)
    g1 = adm.acquire(8)
    assert g1 == 8
    g2 = adm.acquire(8)  # degraded to the remaining quota
    assert g2 == 2
    with pytest.raises(RuntimeError):
        adm.acquire(1)  # exhausted, nobody releasing: the queue times out
    adm.release(g1)
    assert adm.acquire(4) == 4


def test_admission_queues_bursts():
    """A burst beyond the target QUEUES and drains as quota frees."""
    adm = PxAdmission(target=4, queue_timeout_s=5.0)
    grants, errors = [], []

    def worker(i):
        try:
            g = adm.acquire(2)
            grants.append((i, g))
            time.sleep(0.05)
            adm.release(g)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
    for x in threads:
        x.start()
    for x in threads:
        x.join(timeout=10)
    assert not errors, errors
    assert len(grants) == 10
    assert adm.queued_total > 0
    assert adm.used == 0


# ---------------------------------------------------- tests/test_px_range.py

@pytest.fixture(scope="module")
def env_range():
    env = build_env(0.003)
    env["jpx"] = None  # each case builds its executors on a 4-shard mesh
    env["tpx"] = None
    return env


SORT_SQL = """
    select l_orderkey, l_linenumber, l_shipdate
    from lineitem
    order by l_shipdate, l_orderkey, l_linenumber
"""

SORT_DESC_SQL = """
    select l_orderkey, l_linenumber, l_shipdate
    from lineitem
    order by l_shipdate desc, l_orderkey, l_linenumber
"""


def _walk(plan):
    yield plan
    for c in _children(plan):
        yield from _walk(c)


def _ordered(env, sql, **kw):
    """(port PX, its prepared plan, its rows in order, JAX PX rows in
    order, single-device rows in order) on 4 shards."""
    from oceanbase_tpu.core.column import batch_to_host as j_host
    from oceanbase_tpu_torch.core.column import batch_to_host as t_host

    tp = env["tplanner"].plan(TP.parse(sql))
    jp = env["jplanner"].plan(JP.parse(sql))
    names = list(tp.output_names)
    px = TPx(env["tt"], _cpu_mesh(4), unique_keys=UNIQUE_KEYS, **kw)
    prepared = px.prepare(tp.plan)

    def rows(host):
        return [tuple(r) for r in zip(*[list(host[n]) for n in names])]

    got = rows(t_host(prepared.run()))
    jpx = JPx(env["jt"], j_make_mesh(4), unique_keys=UNIQUE_KEYS, **kw)
    ref = rows(j_host(jpx.execute(jp.plan)))
    single = rows(t_host(env["single"].execute(tp.plan)))
    return px, prepared, tp, got, ref, single


@pytest.mark.parametrize("sql", [SORT_SQL, SORT_DESC_SQL])
def test_px_range_sort_matches_and_stays_sharded(env_range, sql):
    px, prepared, tp, got, ref, single = _ordered(
        env_range, sql, broadcast_threshold=1024)
    sort_nids = [nid for nid in prepared.params.exchange_cap
                 if (nid - 1_000_000) % 4 == _SORT_CHILD]
    assert sort_nids, "no RANGE sort exchange lane was seeded"
    sorts = [op for op in _walk(tp.plan) if isinstance(op, Sort)]
    assert any(px._dist.get(id(s)) == SHARDED for s in sorts), (
        "sort was replicated instead of RANGE-partitioned")
    rows_equal(ref, got, "range sort vs JAX PX")
    rows_equal(single, got, "range sort vs single device")


def test_px_small_sort_still_gathers(env_range):
    sql = """
        select c_custkey from customer where c_custkey <= 100
        order by c_custkey desc
    """
    _px, _p, _tp, got, ref, single = _ordered(
        env_range, sql, broadcast_threshold=1 << 20)
    rows_equal(ref, got, "small sort vs JAX PX")
    rows_equal(single, got, "small sort vs single device")


def test_px_window_partition_exchange(env_range):
    sql = """
        select o_orderkey,
               sum(o_totalprice) over (partition by o_custkey) as tot,
               row_number() over (partition by o_custkey
                                  order by o_orderdate, o_orderkey) as rn
        from orders
    """
    px, _p, tp, got, ref, single = _ordered(
        env_range, sql, broadcast_threshold=64)
    wins = [op for op in _walk(tp.plan) if isinstance(op, Window)]
    assert any(px._dist.get(id(w)) == SHARDED for w in wins), (
        "window was replicated instead of hash-partitioned")
    rows_equal(sorted(ref), sorted(got), "window vs JAX PX")
    rows_equal(sorted(single), sorted(got), "window vs single device")
