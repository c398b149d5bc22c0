"""The SQL server of the port against the JAX package's: DDL, DML and
transactions over the replicated cluster with SELECTs on the engine
(twins of tests/test_server.py), materialized views (tests/test_mview.py),
the scan router over column-subset sorted projections
(tests/test_projection_router.py) and vector-index DDL through the server
(tests/test_vector_index.py::test_server_ddl_and_query).

Every statement runs through a JAX `Database` and a port
`Database(device="cpu")` built alike (tests/torch_twins.TwinDatabase):
the same names, rows, affected counts and fast-path routing, or the same
error; each reference assertion then holds on the port (and, where it
reads server state, on both).
"""

import numpy as np
import pytest

from oceanbase_tpu.storage.sorted_projection import (
    make_sorted_projection as j_make_projection,
)
from oceanbase_tpu_torch.server.database import Database, SqlError
from oceanbase_tpu_torch.storage.sorted_projection import (
    make_sorted_projection as t_make_projection,
)
from torch_twins import TwinDatabase


def test_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Database(n_nodes=1, n_ls=1)


def test_unported_server_paths_raise_by_name(tmp_path):
    """PX execution (a session with ob_px_dop > 0) and the persistent plan
    artifacts are not ported: each raises NotImplementedError naming
    itself, and `SET ob_px_dop = 0` keeps serving."""
    d = Database(n_nodes=1, n_ls=1, device="cpu")
    try:
        s = d.session()
        s.sql("create table kv (id int primary key, k int)")
        s.sql("insert into kv values (1, 10), (2, 20)")
        s.sql("set ob_px_dop = 4")
        with pytest.raises(NotImplementedError, match="_px_admission"):
            s.sql("select sum(k) from kv where k > 5")
        s.sql("set ob_px_dop = 0")
        assert s.sql("select sum(k) as s from kv where k > 5").rows() == [
            (30,)]
    finally:
        d.close()
    d = Database(n_nodes=1, n_ls=1, device="cpu",
                 data_dir=str(tmp_path / "a"), fsync=False)
    try:
        with pytest.raises(NotImplementedError, match="PlanArtifactStore"):
            d.session().sql("alter system set ob_plan_artifact_mode = 'rw'")
    finally:
        d.close()


# ---------------------------------------------------------------------------
# tests/test_server.py


@pytest.fixture(scope="module")
def db():
    d = TwinDatabase.build(n_nodes=3, n_ls=2)
    s = d.session()
    s.sql("""
        create table accounts (
            id bigint primary key,
            balance decimal(12,2) not null,
            owner varchar(32) not null,
            opened date not null
        )
    """)
    s.sql("""
        create table branches (
            branch_id bigint primary key,
            city varchar(32) not null
        )
    """)
    yield d
    d.close()


def test_create_and_insert(db):
    s = db.session()
    n = s.sql(
        "insert into accounts values "
        "(1, 100.50, 'alice', date '2020-01-01'),"
        "(2, 250.00, 'bob',   date '2021-06-15'),"
        "(3, 75.25,  'carol', date '2022-03-10')"
    ).affected
    assert n == 3
    rs = s.sql("select id, balance, owner from accounts order by id")
    assert rs.rows() == [
        (1, 100.50, "alice"), (2, 250.00, "bob"), (3, 75.25, "carol")
    ]


def test_insert_duplicate_key_rejected(db):
    s = db.session()
    with pytest.raises(SqlError, match="duplicate"):
        s.sql("insert into accounts values (1, 0, 'x', date '2020-01-01')")
    rs = s.sql("select balance from accounts where id = 1")
    assert rs.rows() == [(100.50,)]


def test_update_with_expression(db):
    s = db.session()
    n = s.sql(
        "update accounts set balance = balance + 10 where id <= 2").affected
    assert n == 2
    rs = s.sql("select id, balance from accounts order by id")
    assert rs.rows() == [(1, 110.50), (2, 260.00), (3, 75.25)]
    s.sql("update accounts set balance = balance - 10 where id <= 2")


def test_update_string_column_new_dict_value(db):
    s = db.session()
    s.sql("update accounts set owner = 'zed' where id = 3")
    rs = s.sql("select owner from accounts order by id")
    assert [r[0] for r in rs.rows()] == ["alice", "bob", "zed"]
    rs = s.sql("select id from accounts where owner >= 'bob' order by id")
    assert [r[0] for r in rs.rows()] == [2, 3]
    s.sql("update accounts set owner = 'carol' where id = 3")


def test_delete(db):
    s = db.session()
    s.sql("insert into accounts values (99, 1.00, 'temp', date '2024-01-01')")
    assert s.sql("delete from accounts where id = 99").affected == 1
    assert s.sql("select count(*) as c from accounts").rows() == [(3,)]


def test_transaction_commit_and_visibility(db):
    s1, s2 = db.session(), db.session()
    s1.sql("begin")
    s1.sql("insert into accounts values (10, 5.00, 'dave', date '2023-01-01')")
    assert s1.sql("select count(*) as c from accounts").rows() == [(4,)]
    assert s2.sql("select count(*) as c from accounts").rows() == [(3,)]
    s1.sql("commit")
    assert s2.sql("select count(*) as c from accounts").rows() == [(4,)]
    s2.sql("delete from accounts where id = 10")


def test_transaction_rollback(db):
    s = db.session()
    s.sql("begin")
    s.sql("update accounts set balance = 0 where id = 1")
    s.sql("rollback")
    assert s.sql(
        "select balance from accounts where id = 1").rows() == [(100.50,)]


def test_multi_table_tx_two_ls(db):
    """accounts and branches land on different log streams -> 2PC."""
    s = db.session()
    s.sql("begin")
    s.sql("insert into branches values (1, 'paris')")
    s.sql("insert into accounts values (20, 9.99, 'eve', date '2024-05-05')")
    s.sql("commit")
    rs = s.sql(
        "select a.owner, b.city from accounts a, branches b "
        "where a.id = 20 and b.branch_id = 1"
    )
    assert rs.rows() == [("eve", "paris")]
    s.sql("delete from accounts where id = 20")
    s.sql("delete from branches where branch_id = 1")


def test_insert_select(db):
    s = db.session()
    s.sql("""
        create table rich_accounts (
            id bigint primary key,
            balance decimal(12,2) not null
        )
    """)
    s.sql(
        "insert into rich_accounts (id, balance) "
        "select id, balance from accounts where balance > 200"
    )
    rs = s.sql("select id from rich_accounts order by id")
    assert [r[0] for r in rs.rows()] == [2]
    s.sql("drop table rich_accounts")


def test_aggregate_after_writes(db):
    s = db.session()
    rs = s.sql(
        "select owner, sum(balance) as total from accounts "
        "group by owner order by owner"
    )
    assert rs.rows() == [("alice", 100.50), ("bob", 250.00),
                         ("carol", 75.25)]


def test_plan_cache_reuse_on_literal_change(db):
    s = db.session()
    s.sql("select id from accounts where balance > 50")
    h0 = db.both(lambda d: d.plan_cache.stats.hits)
    s.sql("select id from accounts where balance > 200")
    assert db.both(lambda d: d.plan_cache.stats.hits) == (h0[0] + 1,
                                                          h0[1] + 1)


def test_statement_atomicity_in_explicit_tx(db):
    s = db.session()
    s.sql("create table atom_t (k bigint primary key, tag varchar(8) not null)")
    s.sql("insert into atom_t values (1, 'a')")
    s.sql("begin")
    with pytest.raises(SqlError, match="duplicate"):
        s.sql("insert into atom_t values (3, 'zed'), (1, 'dup')")
    s.sql("commit")
    assert s.sql("select k from atom_t order by k").rows() == [(1,)]
    assert s.sql("select tag from atom_t").rows() == [("a",)]
    s.sql("drop table atom_t")


def test_repeatable_reads_in_tx(db):
    s1, s2 = db.session(), db.session()
    s2.sql("create table rr_t (k bigint primary key, v bigint not null)")
    s2.sql("insert into rr_t values (1, 10)")
    s1.sql("begin")
    assert s1.sql("select count(*) as c from rr_t").rows() == [(1,)]
    s2.sql("insert into rr_t values (2, 20)")
    assert s1.sql("select count(*) as c from rr_t").rows() == [(1,)]
    s1.sql("commit")
    assert s1.sql("select count(*) as c from rr_t").rows() == [(2,)]
    s2.sql("drop table rr_t")


def test_dml_qualification_plan_cached_across_literals(db):
    s = db.session()
    s.sql("create table pc_t (k bigint primary key, v bigint not null)")
    s.sql("insert into pc_t values (1, 1), (2, 2), (3, 3)")
    s.sql("delete from pc_t where k = 1")
    st0 = db.both(lambda d: (d.plan_cache.stats.hits,
                             d.plan_cache.stats.misses))
    s.sql("delete from pc_t where k = 2")
    s.sql("delete from pc_t where k = 3")
    st1 = db.both(lambda d: (d.plan_cache.stats.hits,
                             d.plan_cache.stats.misses))
    for (h0, m0), (h1, m1) in zip(st0, st1):
        assert h1 == h0 + 2 and m1 == m0
    assert s.sql("select count(*) as c from pc_t").rows() == [(0,)]
    s.sql("drop table pc_t")


def test_drop_table(db):
    s = db.session()
    s.sql("create table t_tmp (a bigint primary key, b bigint)")
    s.sql("insert into t_tmp values (1, 2)")
    s.sql("drop table t_tmp")
    with pytest.raises(Exception):
        s.sql("select * from t_tmp")


# ---------------------------------------------------------------------------
# tests/test_mview.py


@pytest.fixture()
def mdb():
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    s = d.session()
    s.sql("create table sales (id int primary key, grp int, "
          "amt decimal(10,2))")
    s.sql("insert into sales values (1, 1, 10.50), (2, 1, 4.50), "
          "(3, 2, 7.00)")
    yield d
    d.close()


def test_mview_create_query_refresh(mdb):
    s = mdb.session()
    s.sql("""
        create materialized view mv_sales as
        select grp, sum(amt) as total, count(*) as n
        from sales group by grp order by grp
    """)
    rs = s.sql("select grp, total, n from mv_sales order by grp")
    assert [(int(g), float(t), int(n)) for g, t, n in rs.rows()] == [
        (1, 15.0, 2), (2, 7.0, 1)
    ]
    s.sql("insert into sales values (4, 2, 3.00)")
    rs = s.sql("select sum(n) as rows_seen from mv_sales")
    assert int(rs.columns["rows_seen"][0]) == 3
    s.sql("refresh materialized view mv_sales")
    rs = s.sql("select grp, total from mv_sales order by grp")
    assert [(int(g), float(t)) for g, t in rs.rows()] == [
        (1, 15.0), (2, 10.0)
    ]


def test_mview_joins_with_base(mdb):
    s = mdb.session()
    s.sql("""
        create materialized view mv_g as
        select grp, count(*) as n from sales group by grp
    """)
    rs = s.sql(
        "select sum(s.amt) as t from sales as s, mv_g "
        "where s.grp = mv_g.grp and mv_g.n > 1"
    )
    assert abs(float(rs.columns["t"][0]) - 15.0) < 1e-9


def test_mview_dml_rejected_and_drop(mdb):
    s = mdb.session()
    s.sql("create materialized view m1 as select id from sales")
    with pytest.raises(SqlError):
        s.sql("insert into m1 values (99)")
    s.sql("drop materialized view m1")
    with pytest.raises(SqlError):
        s.sql("refresh materialized view m1")


def test_mview_preserves_nulls(mdb):
    s = mdb.session()
    s.sql("create table cust (ck int primary key)")
    s.sql("insert into cust values (1), (2), (9)")
    s.sql("""
        create materialized view mv_n as
        select c.ck as ck, o.amt as amt
        from cust as c left join sales as o on c.ck = o.grp
    """)
    rs = s.sql("select ck, amt from mv_n where amt is null")
    assert [int(r[0]) for r in rs.rows()] == [9]
    rs2 = s.sql("select count(amt) as c, count(*) as n from mv_n")
    assert int(rs2.columns["c"][0]) == 3
    assert int(rs2.columns["n"][0]) == 4


def test_mview_survives_restart(tmp_path):
    data = str(tmp_path / "d")
    d = TwinDatabase.build(n_nodes=1, n_ls=1, data_dir=data, fsync=False)
    s = d.session()
    s.sql("create table t (a int primary key, b int)")
    s.sql("insert into t values (1, 5), (2, 7)")
    s.sql("create materialized view mv as select sum(b) as sb from t")
    d.both(lambda x: x.checkpoint())
    d.close()
    d2 = TwinDatabase.build(n_nodes=1, n_ls=1, data_dir=data, fsync=False)
    try:
        rs = d2.session().sql("select sb from mv")
        assert int(rs.columns["sb"][0]) == 12
    finally:
        d2.close()


def test_mview_refresh_requires_base_select(mdb):
    root = mdb.session()
    root.sql("create user tia")
    root.sql("grant create, select on mv_t to tia")
    root.sql("grant select on sales to tia")
    tia = mdb.session(user="tia")
    tia.sql("create materialized view mv_t as select id from sales")
    root.sql("revoke select on sales from tia")
    with pytest.raises(SqlError) as e:
        tia.sql("refresh materialized view mv_t")
    assert e.value.code == 1142


def test_mview_privileges(mdb):
    root = mdb.session()
    root.sql("create user ana")
    root.sql("grant create, drop on mv_p to ana")
    ana = mdb.session(user="ana")
    with pytest.raises(SqlError) as e:
        ana.sql("create materialized view mv_p as select id from sales")
    assert e.value.code == 1142
    root.sql("grant select on sales to ana")
    ana.sql("create materialized view mv_p as select id from sales")
    root.sql("grant select on mv_p to ana")
    assert ana.sql("select count(*) as n from mv_p").nrows == 1


# ---------------------------------------------------------------------------
# tests/test_projection_router.py


@pytest.fixture(scope="module")
def rdb():
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    s = d.session()
    s.sql("create table rt (id int primary key, k int, k2 int, a int, b int)")
    s.sql("insert into rt values " + ", ".join(
        f"({i}, {i // 10}, {i // 10}, {i * 3}, {i % 11})"
        for i in range(2000)))
    s.sql("select count(*) from rt").rows()  # materialize the snapshot
    s.sql("create table rt2 (id int primary key, k int, k2 int, a int)")
    s.sql("insert into rt2 values " + ", ".join(
        f"({i}, {i // 10}, {i // 10}, {i * 3})" for i in range(2000)))
    s.sql("select count(*) from rt2").rows()
    for make, x in ((j_make_projection, d.j), (t_make_projection, d.t)):
        # column-subset projection: covers the hot columns, not b
        make(x.catalog, "rt", "k", cols=["k", "k2", "a"])
        # tie-break: k and k2 carry identical values, widths differ
        make(x.catalog, "rt2", "k")
        make(x.catalog, "rt2", "k2", cols=["k", "k2", "a"])
    yield d
    d.close()


def _plan(d, sql):
    """EXPLAIN from both packages, equal once the planner's synthetic
    column names ($aggN, $ordN: a per-process counter) are set aside;
    returns the port's."""
    import re

    texts = ["\n".join(r[0] for r in x.session().sql("explain " + sql).rows())
             for x in (d.j, d.t)]
    same = [re.sub(r"\$([a-z_]+)\d+", r"$\1#", t) for t in texts]
    assert same[0] == same[1], texts
    return texts[1]


def test_subset_projection_routes_covered_query(rdb):
    sql = "select sum(a) as sa from rt where k >= 5 and k < 10"
    assert "rt#sp:k" in _plan(rdb, sql)
    rs = rdb.session().sql(sql)
    rows = np.arange(2000)
    expect = int((rows * 3)[(rows // 10 >= 5) & (rows // 10 < 10)].sum())
    assert int(rs.columns["sa"][0]) == expect


def test_uncovered_column_falls_back_to_base_table(rdb):
    sql = "select sum(b) as sb from rt where k >= 5 and k < 10"
    assert "#sp:" not in _plan(rdb, sql)
    rs = rdb.session().sql(sql)
    rows = np.arange(2000)
    expect = int((rows % 11)[(rows // 10 >= 5) & (rows // 10 < 10)].sum())
    assert int(rs.columns["sb"][0]) == expect
    for d in (rdb.j, rdb.t):
        misses = [r["proj_misses"] for r in d.access.snapshot()
                  if r["table"] == "rt"]
        assert misses and misses[0] >= 1


def test_star_projection_falls_back_and_returns_all_columns(rdb):
    rs = rdb.session().sql("select * from rt where k >= 5 and k < 10 "
                           "order by id limit 3")
    assert set(rs.columns) == {"id", "k", "k2", "a", "b"}
    assert rs.rows()[0] == (50, 5, 5, 150, 6)


def test_tie_break_prefers_narrower_covering_projection(rdb):
    sql = ("select sum(a) as sa from rt2 "
           "where k >= 5 and k < 10 and k2 >= 5 and k2 < 10")
    assert "rt2#sp:k2" in _plan(rdb, sql)
    rows = np.arange(2000)
    expect = int((rows * 3)[(rows // 10 >= 5) & (rows // 10 < 10)].sum())
    assert int(rdb.session().sql(sql).columns["sa"][0]) == expect


# ---------------------------------------------------------------------------
# tests/test_vector_index.py::test_server_ddl_and_query


def test_vector_server_ddl_and_query():
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    try:
        s = d.session()
        s.sql("create table docs (id int primary key, emb vector(4))")
        rng = np.random.default_rng(2)
        for i in range(64):
            v = rng.normal(size=4)
            lit = "[" + ",".join(f"{a:.4f}" for a in v) + "]"
            s.sql(f"insert into docs values ({i}, '{lit}')")
        s.sql("create vector index ix on docs (emb) "
              "with (lists = 8, nprobe = 8)")
        q = "[0.0,0.0,0.0,0.0]"
        rs = s.sql(f"select id from docs order by vec_l2(emb, '{q}') limit 3")
        assert rs.nrows == 3
        t = d.t.catalog["docs"]
        x = np.asarray(t.data["emb"], dtype=np.float32)
        want = np.argsort((x * x).sum(axis=1), kind="stable")[:3]
        ids = t.data["id"]
        assert [int(v) for v in rs.columns["id"]] == [
            int(ids[i]) for i in want
        ]
    finally:
        d.close()


# ---------------------------------------------------------------------------
# tests/test_vector_serving.py: the cases that need the server alone (the
# coalesced lanes wait for the batched program, the mesh case for PX)

VD, VK = 16, 10


def _vtext(q, where="", k=VK):
    lit = "[" + ",".join(f"{v:.5f}" for v in q) + "]"
    return (f"select id from docs {where}"
            f"order by vec_l2(emb, '{lit}') limit {k}")


def _vec_db(n=20000, seed=7, lists=64, nprobe=8):
    """A port Database over a preloaded clustered docs table with a
    registered IVF index and a selectivity column grp = id % 100, as
    tests/test_vector_serving.py builds the JAX one."""
    from oceanbase_tpu_torch.core.dtypes import (
        DataType,
        Field,
        Schema,
        TypeKind,
    )
    from oceanbase_tpu_torch.core.table import Table
    from oceanbase_tpu_torch.storage.vector_index import (
        register_vector_index,
    )

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(lists, VD)).astype(np.float32) * 4
    x = (centers[rng.integers(0, lists, n)]
         + rng.normal(size=(n, VD)).astype(np.float32))
    grp = np.arange(n, dtype=np.int64) % 100
    db = Database(n_nodes=1, n_ls=1, device="cpu")
    db.catalog["docs"] = Table("docs", Schema((
        Field("id", DataType(TypeKind.INT64)),
        Field("grp", DataType(TypeKind.INT64)),
        Field("emb", DataType.vector(VD)),
    )), {"id": np.arange(n, dtype=np.int64), "grp": grp, "emb": x})
    db._vector_specs.setdefault("docs", {})["emb"] = (lists, nprobe)
    register_vector_index(db.catalog, "docs", "emb",
                          lists=lists, nprobe=nprobe)
    return db, x, grp, rng


@pytest.mark.parametrize("where,sel_mask", [
    ("", None),
    ("where grp < 10 ", lambda g: g < 10),
    ("where grp = 0 ", lambda g: g == 0),
])
def test_vector_filtered_recall_at_10(where, sel_mask):
    db, x, grp, rng = _vec_db()
    try:
        s = db.session()
        mask = (sel_mask(grp) if sel_mask is not None
                else np.ones(len(x), bool))
        ids = np.arange(len(x), dtype=np.int64)[mask]
        xf = x[mask]
        hits = total = 0
        for _ in range(12):
            q = (x[rng.integers(0, len(x))]
                 + rng.normal(size=VD).astype(np.float32) * 0.05)
            got = [int(r[0]) for r in s.sql(_vtext(q, where)).rows()]
            d2 = ((xf - q) ** 2).sum(axis=1)
            want = set(ids[np.argsort(d2, kind="stable")[:VK]].tolist())
            assert len(got) == VK
            hits += len(set(got) & want)
            total += VK
        assert hits / total >= 0.9, (where, hits / total)
    finally:
        db.close()


def test_vector_unfiltered_route_engages_and_counts():
    db, x, grp, rng = _vec_db()
    try:
        s = db.session()
        q = x[3]
        plan = "\n".join(r[0] for r in s.sql("explain " + _vtext(q)).rows())
        assert "ANN IVF probe" in plan, plan
        c0 = db.metrics.counters_snapshot().get("ann probes", 0)
        s.sql(_vtext(q)).rows()
        assert db.metrics.counters_snapshot().get("ann probes", 0) > c0
        vt = s.sql("select table_name, column_name, queries from "
                   "__all_virtual_vector_index").rows()
        assert any(r[0] == "docs" and r[1] == "emb" and int(r[2]) >= 1
                   for r in vt), vt
    finally:
        db.close()


def test_vector_dml_then_query_rebuilds_not_stale():
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    try:
        s = d.session()
        s.sql("create table docs (id int primary key, grp int, "
              "emb vector(4))")
        rng = np.random.default_rng(3)
        vals = []
        for i in range(256):
            v = rng.normal(size=4) * 0.1 + 5.0  # far from the probe
            lit = "[" + ",".join(f"{a:.4f}" for a in v) + "]"
            vals.append(f"({i}, {i % 4}, '{lit}')")
        s.sql("insert into docs values " + ", ".join(vals))
        s.sql("create vector index ix on docs (emb) "
              "with (lists = 8, nprobe = 8)")
        q = np.zeros(4, np.float32)
        got = [int(r[0]) for r in s.sql(_vtext(q, k=3)).rows()]
        assert len(got) == 3 and 999 not in got
        s.sql("insert into docs values (999, 1, '[0.01,0.01,0.01,0.01]')")
        got = [int(r[0]) for r in s.sql(_vtext(q, k=3)).rows()]
        assert got[0] == 999, f"stale IVF served after DML: {got}"
        got = [int(r[0]) for r in
               s.sql(_vtext(q, "where grp = 1 ", k=3)).rows()]
        assert got[0] == 999, f"stale filtered ANN after DML: {got}"
    finally:
        d.close()


# ---------------------------------------------------------------------------
# a result wider than one K23 write pass (48 columns and validity planes)

WIDE = 40  # bigint columns, nullable on the outer side of a LEFT JOIN
JOIN_WIDE = ("select * from keys_t left join wide_t on keys_t.k = "
             "wide_t.id ")


def test_wide_result_frames_and_head_fetch(monkeypatch):
    """SELECT * of a LEFT JOIN onto 40 columns (42 columns and 41 validity
    planes): ORDER BY ... LIMIT, the narrowed frame of a filter (K23 past
    one 48-plane write pass) and the head fetch of a plain cursor, each
    equal to the JAX Database's and to the inserted values."""
    from oceanbase_tpu_torch.engine import executor as TX
    from torch_twins import rows_equal

    planes = []
    first_live = TX.first_live

    def recording(sel, k, cols):
        cols = list(cols)
        planes.append(len(cols))
        return first_live(sel, k, cols)

    monkeypatch.setattr(TX, "first_live", recording)
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    try:
        s = d.session()
        s.sql("create table keys_t (k bigint primary key)")
        s.sql("create table wide_t (id bigint primary key, "
              + ", ".join(f"c{i} bigint" for i in range(WIDE)) + ")")
        s.sql("insert into keys_t values "
              + ", ".join(f"({r})" for r in range(600)))
        rng = np.random.default_rng(41)
        vals = rng.integers(-1000, 1000, (600, WIDE))
        present = [r for r in range(600) if r % 5]  # every fifth key unmatched
        for lo in range(0, len(present), 160):
            s.sql("insert into wide_t values " + ", ".join(
                f"({r}, " + ", ".join(str(int(x)) for x in vals[r]) + ")"
                for r in present[lo:lo + 160]))
        for q in ("order by keys_t.k desc limit 10", "where keys_t.k < 100",
                  "where keys_t.k >= 37 and keys_t.k < 45"):
            for _ in range(3):  # cold, the profiled repeat, narrowed
                s.sql(JOIN_WIDE + q)
        narrowed = max(planes)
        d.both(lambda x: x.config.set("ob_enable_result_narrow", False))
        jr = s.j.sql(JOIN_WIDE + "where keys_t.k >= 10")
        tr = s.t.sql(JOIN_WIDE + "where keys_t.k >= 10")
        del planes[:]
        for k in (1, 10, 300):
            rows_equal(jr.rows(limit=k), tr.rows(limit=k), f"limit {k}")
        assert planes and min(planes) > 48 and narrowed > 48, \
            (planes, narrowed)
        # every head row is its key's row of the inserted values (the
        # join emits matched keys before unmatched ones, as the JAX one)
        head = [tuple(None if x is None else int(x) for x in row)
                for row in tr.rows(limit=300)]
        assert len({row[0] for row in head}) == 300
        for row in head:
            r = row[0]
            assert r >= 10 and row[1:] == (
                (None,) * (1 + WIDE) if r % 5 == 0
                else (r, *(int(x) for x in vals[r]))), r
    finally:
        d.close()
