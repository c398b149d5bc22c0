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
from torch_twins import px_rows, rows_equal

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


# ---------------------------------------------------------------------------
# VECTOR columns and float join keys across the exchanges (PX answers on
# the mesh: `px fallbacks` stays 0)


def _vector_twin(monkeypatch):
    from oceanbase_tpu_torch.parallel import mesh as t_mesh
    from torch_twins import TwinDatabase

    monkeypatch.setattr(t_mesh, "CPU_SHARDS", 8)
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    s = d.session()
    s.sql("create table docs (id int primary key, g int, emb vector(4))")
    rng = np.random.default_rng(2)
    vals = ", ".join(
        f"({i}, {i % 5}, '[{', '.join(repr(float(x)) for x in rng.normal(size=4))}]')"
        for i in range(64))
    s.sql(f"insert into docs values {vals}")
    return d, s


VECTOR_SQL = [("select id, emb from docs order by id limit 5", 5),
              ("select id, emb from docs where g = 3", 13)]


@pytest.mark.parametrize("sql,nrows", VECTOR_SQL)
def test_px_vector_column_crosses_exchanges(monkeypatch, sql, nrows):
    """A VECTOR column crosses the gather and the exchanges as one plane of
    fixed-width rows (K25, K26): at dop 2 the rows equal the JAX
    Database's and dop 0's, with no `px fallbacks` on either side."""
    d, s = _vector_twin(monkeypatch)
    try:
        serial = s.t.sql(sql).rows()
        s.sql("set ob_px_dop = 2")
        jr, tr = s.j.sql(sql).rows(), s.t.sql(sql).rows()
        assert len(tr) == len(jr) == len(serial) == nrows
        for got, want, one in zip(tr, jr, serial):
            assert got[0] == want[0] == one[0]
            assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
            assert np.array_equal(np.asarray(got[1]), np.asarray(one[1]))
        assert d.t._px_executor_obj is not None
        for db in (d.j, d.t):
            assert db.metrics.counter("px fallbacks") == 0
    finally:
        d.close()


def test_px_repartition_moves_row_planes():
    """repartition and both broadcasts carry a (rows, d) plane: every row
    arrives whole, at the slot its scalar columns arrive at."""
    import torch

    from oceanbase_tpu_torch.parallel import exchange as X
    from oceanbase_tpu_torch.parallel.group import run_spmd

    mesh = _cpu_mesh(4)
    n, dim = 37, 5
    rng = np.random.default_rng(31)
    ids = [torch.from_numpy(np.arange(n, dtype=np.int64) + 100 * s)
           for s in range(4)]
    embs = [torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
            for _s in range(4)]
    masks = [torch.from_numpy(rng.random(n) < 0.7) for _s in range(4)]

    def body(s):
        cols = {"id": ids[s], "emb": embs[s]}
        dest = X.dest_by_hash([ids[s]], 4)
        got = [X.repartition(cols, masks[s], dest, 4, n)[:2],
               X.broadcast_rows(cols, masks[s]),
               X.ring_broadcast_rows(cols, masks[s], 4)]
        return got

    outs = run_spmd(mesh, body)
    allid = torch.cat(ids)
    allemb = torch.cat(embs)
    for shard in outs:
        for cols, mask in shard:
            live = mask.nonzero().squeeze(1)
            assert cols["emb"].shape == (mask.shape[0], dim)
            rows = torch.searchsorted(allid, cols["id"][live])
            assert torch.equal(cols["emb"][live], allemb[rows])


def test_px_accounting_counts_vector_row_bytes():
    """The MeshPlan and `px exchange bytes capacity` count a VECTOR
    column's rows by their bytes: 8-byte lanes, d x 4 bytes a row."""
    from types import SimpleNamespace

    import torch

    from oceanbase_tpu_torch.parallel.px import _payload_units

    b = SimpleNamespace(
        cols={"id": torch.zeros(8, dtype=torch.int64),
              "emb": torch.zeros((8, 128), dtype=torch.float32),
              "tiny": torch.zeros((8, 3), dtype=torch.float32)},
        valid={"emb": torch.ones(8, dtype=torch.bool)})
    assert _payload_units(b) == 1 + 64 + 2 + 1


def _float_key_catalog(pkg: str, n_a: int = 300, n_b: int = 400):
    """a and b as tests/test_torch_float_keys.py builds them (f DOUBLE, k
    BIGINT, v BIGINT, g FLOAT), with a signed BIGINT n = k - 2 for a
    negative key meeting a DOUBLE; b the larger, so a hash join
    repartitions both sides."""
    fields = (("f", "float64"), ("k", "int64"), ("v", "int64"),
              ("g", "float32"), ("n", "int64"))
    out = {}
    for name, seed, size in (("a", 1, n_a), ("b", 2, n_b)):
        r = np.random.default_rng(seed)
        d = {"f": r.integers(0, 40, size) / 4 - 3,
             "k": r.integers(0, 5, size).astype(np.int64),
             "v": r.integers(0, 1000, size).astype(np.int64),
             "g": (r.integers(0, 30, size) / 2).astype(np.float32)}
        d["n"] = d["k"] - 2
        z = np.flatnonzero(d["f"] == 0.0)
        d["f"][z[::2]] = -0.0
        d["f"][[3]] = np.nan
        if pkg == "jax":
            out[name] = JTable.from_pydict(name, JSchema(tuple(
                JField(c, getattr(JDT, k)()) for c, k in fields)), d)
        else:
            from oceanbase_tpu_torch.core.table import table_from_arrays

            out[name] = table_from_arrays(
                name, [(c, k, 0, 0, False) for c, k in fields], d)
        out[name + "_np"] = d
    return out


FLOAT_PX = [
    # (sql, the numpy oracle's left and right keys or None for a twin)
    ("select count(*), sum(a.v) from a, b where a.f = b.f", ["f"], ["f"]),
    ("select count(*), sum(a.v) from a, b where a.n = b.f", ["n"], ["f"]),
    ("select count(*), sum(a.v) from a, b where a.g = b.f", ["g"], ["f"]),
    ("select count(*), sum(a.v) from a, b where a.f = b.f and a.k = b.k",
     None, None),
    ("select count(*), sum(b.v) from a left join b on a.g = b.g "
     "and a.k = b.k", None, None),
]


@pytest.fixture(scope="module")
def float_env():
    tt = _float_key_catalog("torch")
    jt = _float_key_catalog("jax")
    cat_t = {k: v for k, v in tt.items() if not k.endswith("_np")}
    cat_j = {k: v for k, v in jt.items() if not k.endswith("_np")}
    return {"np": tt, "tplanner": TPlanner(cat_t), "jplanner": JPlanner(cat_j),
            "cat_t": cat_t, "jpx": JPx(cat_j, j_make_mesh(4))}


class _KeySpy(TPx):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.hashed = []

    def _exchange_keys(self, b, keys, cap):
        self.hashed.append([k.dtype for k in keys])
        return super()._exchange_keys(b, keys, cap)

    def _hybrid_exchange(self, probe, pk, build, bk, *a):
        self.hashed += [[k.dtype for k in pk], [k.dtype for k in bk]]
        return super()._hybrid_exchange(probe, pk, build, bk, *a)


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("case", range(len(FLOAT_PX)))
def test_px_float_key_joins_hash_on_values(float_env, case, hybrid):
    """Float join keys hash-repartition over 4 shards (the broadcast
    threshold at 0, the hybrid route on and off): equal values, -0.0 and
    0.0, a
    BIGINT and a DOUBLE, a FLOAT and a DOUBLE, meet on one shard, since
    both sides hash the same float64 keys. One key against numpy, two
    keys against the JAX PxExecutor."""
    import torch

    sql, lk, rk = FLOAT_PX[case]
    px = _KeySpy(float_env["cat_t"], _cpu_mesh(4), broadcast_threshold=0,
                 hybrid_hash=hybrid, join_bloom=not hybrid)
    tp = float_env["tplanner"].plan(TP.parse(sql))
    names = list(tp.output_names)
    got = px_rows(px.execute(tp.plan), names)
    assert px.hashed, "the join did not hash-repartition"
    if lk is not None and len({a[0] for a in (lk, rk)}) > 1:
        # a float meeting another type: both sides hash float64
        assert all(dts == [torch.float64] for dts in px.hashed)
    if lk is None:
        jp = float_env["jplanner"].plan(JP.parse(sql))
        rows_equal(px_rows(float_env["jpx"].execute(jp.plan), names), got,
                   sql)
        return
    a, b = float_env["np"]["a_np"], float_env["np"]["b_np"]
    eq = np.ones((len(a["v"]), len(b["v"])), dtype=bool)
    for x, y in zip(lk, rk):
        eq &= (a[x].astype(np.float64)[:, None]
               == b[y].astype(np.float64)[None, :])
    li, _ri = np.nonzero(eq)
    assert got == [(len(li), int(a["v"][li].sum()))], sql


def test_px_float_key_twin_at_dop2(monkeypatch):
    """The float-key statements through a Database pair at dop 2: the
    two-key join equals the JAX Database, the one-key join numpy, and
    the port's `px fallbacks` stays 0."""
    from oceanbase_tpu_torch.parallel import mesh as t_mesh
    from torch_twins import TwinDatabase

    monkeypatch.setattr(t_mesh, "CPU_SHARDS", 8)
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    try:
        s = d.session()
        tabs = _float_key_catalog("torch", 60, 80)
        for name in ("a", "b"):
            s.sql(f"create table {name} (id int primary key, f double, "
                  "k bigint, v bigint, g float)")
            t = tabs[name + "_np"]
            t["f"] = np.nan_to_num(t["f"], nan=0.5)  # DML takes no NULL
            vals = ", ".join(
                f"({i}, {float(t['f'][i])!r}, {int(t['k'][i])}, "
                f"{int(t['v'][i])}, {float(t['g'][i])!r})"
                for i in range(len(t["v"])))
            s.sql(f"insert into {name} values {vals}")
        two = ("select count(*), sum(a.v) from a, b where a.f = b.f "
               "and a.k = b.k")
        one = "select count(*), sum(a.v) from a, b where a.f = b.f"
        s.sql("set ob_px_dop = 2")
        s.sql(two)  # the twin: equal to the JAX Database
        a, b = tabs["a_np"], tabs["b_np"]
        li, _ri = np.nonzero(a["f"][:, None] == b["f"][None, :])
        assert s.t.sql(one).rows() == [(len(li), int(a["v"][li].sum()))]
        assert d.t._px_executor_obj is not None
        assert d.t.metrics.counter("px fallbacks") == 0
    finally:
        d.close()
