"""The serving spine of the port against the JAX package's: the statement
fast path (twins of tests/test_fastpath_stmt.py) and the result cache
(tests/test_result_cache.py), engine Sessions and server Databases built
alike from one seed (tests/torch_twins.py).

Every statement runs through both packages with equal rows and equal
fast-path routing; counters the reference asserts on (fast hits, misses,
invalidations, result-cache hits, puts, evictions) move the same way on
both. The port narrows its result frames with kernel K23's plain version
here (the tensors are on the CPU).
"""

import numpy as np
import pytest

from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as jdatagen
from oceanbase_tpu.share import retry as JR
from oceanbase_tpu.share.errsim import ERRSIM as JERRSIM
from oceanbase_tpu.sql.plan_cache import _convert_token as j_convert
from oceanbase_tpu.sql.plan_cache import build_slot_map as j_slot_map
from oceanbase_tpu_torch.engine import executor as TX
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as tdatagen
from oceanbase_tpu_torch.server.database import SqlError
from oceanbase_tpu_torch.share import retry as TR
from oceanbase_tpu_torch.share.errsim import ERRSIM as TERRSIM
from oceanbase_tpu_torch.sql import parser as P
from oceanbase_tpu_torch.sql import parser as TP
from oceanbase_tpu_torch.sql.plan_cache import _convert_token as t_convert
from oceanbase_tpu_torch.sql.plan_cache import build_slot_map as t_slot_map
from torch_twins import TwinDatabase, TwinSession, rows_equal

# ---------------------------------------------------------------------------
# unit: the fast normalizer and the slot map (host code, both packages)


def test_fast_normalize_kind_markers():
    from oceanbase_tpu.sql import parser as JP

    for mod in (JP, TP):
        k1, p1, t1 = mod.fast_normalize("select a from t where a = 5")
        k2, p2, t2 = mod.fast_normalize("select a from t where a = '5'")
        assert k1 != k2
        assert "?n" in k1 and "?s" in k2
        assert p1 == ("5",) and p2 == ("5",)
        assert t1 == ("num",) and t2 == ("str",)
        assert k1.replace("?n", "?").replace("?s", "?") == \
            mod.normalize_for_cache("select a from t where a = 5")[0]


def test_slot_map_unique_values_map_to_slots():
    for fn in (j_slot_map, t_slot_map):
        slot_map = fn(("5", "1.5"), ("num", "num"), [5, 1.5])
        assert slot_map[0][0] == "slot" and slot_map[1][0] == "slot"


def test_slot_map_ambiguous_values_bake():
    for fn in (j_slot_map, t_slot_map):
        slot_map = fn(("5", "5"), ("num", "num"), [5, 5])
        assert all(s[0] == "baked" for s in slot_map)


def test_slot_map_int_converter_refuses_float_token():
    for conv in (j_convert, t_convert):
        assert conv("7", "int") == 7
        assert conv("7.5", "int") is None
        assert conv("7.5", "float") == 7.5
        assert conv("7", "float") is None


# ---------------------------------------------------------------------------
# engine level


@pytest.fixture(scope="module")
def esession():
    j_orders, j_li = jdatagen.gen_orders_lineitem(
        0.01, np.random.default_rng(11), 1500, 2000, 100)
    t_orders, t_li = tdatagen.gen_orders_lineitem(
        0.01, np.random.default_rng(11), 1500, 2000, 100)
    js = JSession({"orders": j_orders, "lineitem": j_li})
    ts = TSession({"orders": t_orders, "lineitem": t_li}, device="cpu")
    return TwinSession(js, ts)


def _q6(d1, d2, lo, hi, qty):
    return (
        "select sum(l_extendedprice * l_discount) as revenue from lineitem "
        f"where l_shipdate >= date '{d1}' and l_shipdate < date '{d2}' "
        f"and l_discount between {lo} and {hi} and l_quantity < {qty}"
    )


def _q6_numpy(li, d1, d2, lo, hi, qty):
    ship, disc = li.data["l_shipdate"], li.data["l_discount"]
    qtyc, ep = li.data["l_quantity"], li.data["l_extendedprice"]
    m = (
        (ship >= int(np.datetime64(d1, "D").astype(np.int64)))
        & (ship < int(np.datetime64(d2, "D").astype(np.int64)))
        & (disc >= round(lo * 100)) & (disc <= round(hi * 100))
        & (qtyc < qty * 100)
    )
    return float(np.sum(ep[m].astype(np.int64)
                        * disc[m].astype(np.int64))) / 1e4


def _both_stats(tw, name):
    return (getattr(tw.j.plan_cache.stats, name),
            getattr(tw.t.plan_cache.stats, name))


def test_fast_hit_rebinds_dates_floats_ints(esession):
    li = esession.t.catalog["lineitem"]
    r1 = esession.sql(_q6("1994-01-01", "1995-01-01", 0.05, 0.07, 24))
    assert not r1.fast_path_hit
    h0 = _both_stats(esession, "fast_hits")
    r2 = esession.sql(_q6("1995-01-01", "1996-01-01", 0.02, 0.09, 30))
    assert _both_stats(esession, "fast_hits") == (h0[0] + 1, h0[1] + 1)
    assert r2.fast_path_hit
    got = float(r2.rows()[0][0])
    want = _q6_numpy(li, "1995-01-01", "1996-01-01", 0.02, 0.09, 30)
    assert got == pytest.approx(want, rel=1e-9)


def test_fast_widening_falls_back_then_reregisters(esession):
    q = "select count(*) from lineitem where l_quantity < {}"
    esession.sql(q.format(20))
    assert esession.sql(q.format(25)).fast_path_hit
    m0 = _both_stats(esession, "fast_misses")
    r_f = esession.sql(q.format(25.5))
    assert not r_f.fast_path_hit
    assert _both_stats(esession, "fast_misses") == (m0[0] + 1, m0[1] + 1)
    li = esession.t.catalog["lineitem"]
    assert r_f.rows()[0][0] == int((li.data["l_quantity"] < 2550).sum())
    r_f2 = esession.sql(q.format(30.5))
    assert r_f2.fast_path_hit
    assert r_f2.rows()[0][0] == int((li.data["l_quantity"] < 3050).sum())


def test_lazy_rows_limit_and_full(esession):
    q = "select l_orderkey, l_quantity from lineitem where l_discount >= 0.05"
    esession.sql(q)
    rs = esession.sql(q)
    assert rs.fast_path_hit
    li = esession.t.catalog["lineitem"]
    mask = li.data["l_discount"] >= 5  # stored scaled x100
    want_n = int(mask.sum())
    assert rs.nrows == want_n
    head = rs.rows(limit=3)
    assert len(head) == min(3, want_n)
    full = rs.rows()
    assert len(full) == want_n
    assert full[:3] == head
    assert [r[0] for r in full] == list(li.data["l_orderkey"][mask])


def test_fetch_head_limit_sweep_reuses_one_width(esession, monkeypatch):
    """A LIMIT sweep inside one pow2 bucket takes the head through one
    K23 width; the rows equal the JAX head gather's."""
    q = "select l_orderkey, l_quantity from lineitem where l_discount >= 0.03"
    jr, tr = esession.j.sql(q), esession.t.sql(q)
    widths = []
    first_live = TX.first_live

    def recording(sel, k, cols):
        widths.append(int(k))
        return first_live(sel, k, cols)

    monkeypatch.setattr(TX, "first_live", recording)
    for k in (5, 6, 7, 8):
        rows_equal(jr.rows(limit=k), tr.rows(limit=k), f"limit {k}")
    assert widths == [8, 8, 8, 8]


# ---------------------------------------------------------------------------
# server level


@pytest.fixture()
def sdb():
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    s = d.session()
    s.sql("create table kv (id int primary key, k int, v int, "
          "name varchar(20))")
    s.sql("insert into kv values (1, 10, 100, 'aa'), (2, 20, 200, 'bb'), "
          "(3, 30, 300, 'it''s'), (4, 40, 400, 'dd')")
    yield d, s
    d.close()


def _last_select(db):
    return [a for a in db.audit.records() if a.stmt_type == "Select"][-1]


def test_server_fast_hit_and_audit(sdb):
    db, s = sdb
    q = "select v from kv where k = {}"
    assert s.sql(q.format(10)).rows() == [(100,)]
    r = s.sql(q.format(30))
    assert r.fast_path_hit and r.rows() == [(300,)]
    for d in (db.j, db.t):
        rec = _last_select(d)
        assert rec.is_fast_path
        assert rec.plan_cache_hit
        assert rec.dispatch_us >= 0 and rec.compile_s == 0.0


def test_server_string_escape_and_null_literals(sdb):
    db, s = sdb
    q = "select id from kv where name = '{}'"
    assert s.sql(q.format("aa")).rows() == [(1,)]
    r = s.sql(q.format("it''s"))
    assert not r.fast_path_hit
    assert r.rows() == [(3,)]
    r2 = s.sql(q.format("it''s"))
    assert r2.fast_path_hit and r2.rows() == [(3,)]
    qn = "select count(*) from kv where name is not null and k >= {}"
    assert s.sql(qn.format(0)).rows() == [(4,)]
    rn = s.sql(qn.format(35))
    assert rn.fast_path_hit and rn.rows() == [(1,)]


def test_server_ddl_set_and_vt_bypass(sdb):
    db, s = sdb
    h0 = _both_stats(db, "fast_hits")
    s.sql("set ob_px_dop = 0")
    s.sql("create table other (a int primary key)")
    s.sql("drop table other")
    assert _both_stats(db, "fast_hits") == h0
    # virtual-table rows are each package's own counters: run them on
    # each side, never registered in the text tier
    for x in (s.j, s.t):
        x.sql("select name, value from __all_virtual_sysstat "
              "where value > 0")
        x.sql("select name, value from __all_virtual_sysstat "
              "where value > 1")
    assert _both_stats(db, "fast_hits") == h0


def test_server_tx_bypasses_fast_path(sdb):
    db, s = sdb
    q = "select v from kv where k = {}"
    s.sql(q.format(10))
    assert s.sql(q.format(10)).fast_path_hit
    s.sql("begin")
    try:
        r = s.sql(q.format(10))
        assert not r.fast_path_hit
        assert r.rows() == [(100,)]
    finally:
        s.sql("rollback")


def test_flush_clears_both_tiers(sdb):
    db, s = sdb
    q = "select v from kv where k = {}"
    s.sql(q.format(10))
    assert s.sql(q.format(20)).fast_path_hit
    inv0 = _both_stats(db, "fast_invalidations")
    db.both(lambda d: d.plan_cache.flush())
    assert db.both(lambda d: len(d.plan_cache._fast)) == (0, 0)
    inv1 = _both_stats(db, "fast_invalidations")
    assert inv1[0] > inv0[0] and inv1[1] > inv0[1]
    r = s.sql(q.format(30))
    assert not r.fast_path_hit and r.rows() == [(300,)]
    assert s.sql(q.format(40)).fast_path_hit


def test_fast_capacity_eviction(sdb):
    db, s = sdb
    caps = db.both(lambda d: d.plan_cache.capacity)
    db.both(lambda d: setattr(d.plan_cache, "capacity", 2))
    try:
        qs = ["select v from kv where k = 10 and id < {}",
              "select k from kv where v = 100 and id < {}",
              "select id from kv where k > 0 and id < {}"]
        ev0 = _both_stats(db, "fast_evictions")
        for q in qs:
            s.sql(q.format(99))
        assert all(n <= 2 for n in db.both(lambda d: len(d.plan_cache._fast)))
        ev1 = _both_stats(db, "fast_evictions")
        assert ev1[0] > ev0[0] and ev1[1] > ev0[1]
        r = s.sql(qs[0].format(98))
        assert r.rows() == [(100,)]
    finally:
        db.j.plan_cache.capacity, db.t.plan_cache.capacity = caps


def test_ddl_invalidates_stale_text_entry(sdb):
    db, s = sdb
    q = "select sum(v) from kv where k < {}"
    s.sql(q.format(100))
    assert s.sql(q.format(100)).fast_path_hit
    s.sql("drop table kv")
    s.sql("create table kv (id int primary key, k int, v int, "
          "name varchar(20))")
    s.sql("insert into kv values (1, 10, 7, 'x')")
    assert s.sql(q.format(100)).rows() == [(7,)]


def test_retry_flush_never_replays_stale_text_entry(sdb):
    db, s = sdb
    q = "select v from kv where k = {}"
    s.sql(q.format(10))
    assert s.sql(q.format(20)).fast_path_hit
    fired = {"n": 0}
    origs = {}
    for d, R in ((db.j, JR), (db.t, TR)):
        origs[id(d)] = d.engine.fast_execute

        def boom(hit, _R=R, **kw):
            fired["n"] += 1
            raise _R.SchemaVersionMismatch("injected: schema moved")

        d.engine.fast_execute = boom
    try:
        h0 = _both_stats(db, "fast_hits")
        r = s.sql(q.format(30))  # fast hit raises -> retry flushes -> slow
        assert r.rows() == [(300,)]
        assert fired["n"] == 2  # once per package, never re-entered
        assert _both_stats(db, "fast_hits") == (h0[0] + 1, h0[1] + 1)
    finally:
        for d in (db.j, db.t):
            d.engine.fast_execute = origs[id(d)]
    for d in (db.j, db.t):
        rec = _last_select(d)
        assert rec.retry_cnt == 1
        assert not rec.is_fast_path
    s.sql(q.format(10))
    assert s.sql(q.format(40)).fast_path_hit


def test_privileges_bite_on_warm_fast_hits(sdb):
    db, s = sdb
    s.sql("create user bob")
    s.sql("grant select on kv to bob")
    sb = db.session(user="bob")
    q = "select v from kv where k = {}"
    sb.sql(q.format(10))
    assert sb.sql(q.format(20)).fast_path_hit
    s.sql("revoke select on kv from bob")
    with pytest.raises(SqlError):
        sb.sql(q.format(30))


def test_sequence_draws_never_served_from_fast_tier(sdb):
    db, s = sdb
    s.sql("create sequence sq_fp")
    q = "select nextval('sq_fp') as v"
    vals = [int(s.sql(q).rows()[0][0]) for _ in range(4)]
    assert vals == [1, 2, 3, 4]
    key = P.fast_normalize(q)[0]
    assert db.both(lambda d: d.plan_cache.fast_peek(key)) == (None, None)


def test_sysstat_exposes_fast_counters(sdb):
    db, s = sdb
    q = "select v from kv where k = {}"
    s.sql(q.format(10))
    s.sql(q.format(20))
    for x in (s.j, s.t):
        rows = dict(x.sql(
            "select name, value from __all_virtual_sysstat "
            "where name like 'plan cache fast%'").rows())
        assert rows.get("plan cache fast hit", 0) >= 1
        assert rows.get("plan cache fast miss", 0) >= 1


# ---------------------------------------------------------------------------
# tests/test_result_cache.py

N = 32


def _mkdb(n_nodes=1, n_ls=1):
    d = TwinDatabase.build(n_nodes=n_nodes, n_ls=n_ls)
    # deterministic admission: a profiled run would claim the first warm
    # repeat (plain cursor, no admission)
    d.both(lambda x: x.config.set("enable_plan_profile", False))
    s = d.session()
    s.sql("create table rc (id int primary key, k int, v int)")
    s.sql("insert into rc values " + ", ".join(
        f"({i + 1}, {i}, {i * 7 + 3})" for i in range(N)))
    return d


@pytest.fixture(scope="module")
def rdb():
    d = _mkdb()
    yield d
    d.close()


def _warm(s, q, n=2):
    out = None
    for _ in range(n):
        out = s.sql(q).rows()
    return out


def _rc(d, key):
    return (d.j.result_cache.stats()[key], d.t.result_cache.stats()[key])


def _plus(pair, n):
    return (pair[0] + n, pair[1] + n)


def test_warm_repeat_hits_and_matches_uncached(rdb):
    s = rdb.session()
    q = "select v from rc where k = 7"
    p0 = _rc(rdb, "puts")
    r1 = s.sql(q).rows()
    r2 = s.sql(q).rows()  # first warm repeat: narrowed dispatch + admit
    assert _rc(rdb, "puts") == _plus(p0, 1)
    h1 = _rc(rdb, "hits")
    r3 = s.sql(q).rows()  # served from the cache
    assert _rc(rdb, "hits") == _plus(h1, 1)
    assert r1 == r2 == r3 == [(7 * 7 + 3,)]
    s2 = rdb.session()
    s2.sql("set ob_enable_result_cache = 0")
    st3 = (_rc(rdb, "hits"), _rc(rdb, "misses"))
    assert s2.sql(q).rows() == r3
    assert s2.sql(q).rows() == r3
    assert (_rc(rdb, "hits"), _rc(rdb, "misses")) == st3


def test_virtual_table_surfaces_entries(rdb):
    s = rdb.session()
    _warm(s, "select v from rc where k = 23", 3)
    for x in (s.j, s.t):
        rows = x.sql(
            "select tables, result_rows, nbytes, hits "
            "from __all_virtual_result_cache").rows()
        assert any(t == "rc" and n == 1 and b > 0 and h >= 1
                   for (t, n, b, h) in rows)


def test_dml_invalidates_then_recomputes_and_readmits(rdb):
    s = rdb.session()
    q = "select v from rc where k = 9"
    _warm(s, q, 2)
    assert s.sql(q).rows() == [(9 * 7 + 3,)]
    inv0 = _rc(rdb, "invalidations")
    s.sql("update rc set v = 1000 where k = 9")
    h0 = _rc(rdb, "hits")
    assert s.sql(q).rows() == [(1000,)]
    assert _rc(rdb, "hits") == h0
    inv1 = _rc(rdb, "invalidations")
    assert inv1[0] > inv0[0] and inv1[1] > inv0[1]
    assert s.sql(q).rows() == [(1000,)]
    assert _rc(rdb, "hits") == _plus(h0, 1)


def test_schema_bump_rotates_key_and_readmits(rdb):
    s = rdb.session()
    q = "select v from rc where k = 11"
    _warm(s, q, 2)
    h0 = _rc(rdb, "hits")
    assert s.sql(q).rows() == [(11 * 7 + 3,)]
    assert _rc(rdb, "hits") == _plus(h0, 1)
    s.sql("create index rc_v on rc (v)")
    h1 = _rc(rdb, "hits")
    rows = [s.sql(q).rows() for _ in range(4)]
    assert all(r == [(11 * 7 + 3,)] for r in rows)
    h2 = _rc(rdb, "hits")
    assert h2[0] > h1[0] and h2[1] > h1[1]
    assert h2[0] - h1[0] < 4 and h2[1] - h1[1] < 4
    assert h2[0] - h1[0] == h2[1] - h1[1]


def test_revoke_bites_cached_hit(rdb):
    root = rdb.session()
    root.sql("create user carol identified by 'pw'")
    root.sql("grant select on rc to carol")
    s = rdb.session(user="carol")
    q = "select v from rc where k = 13"
    _warm(s, q, 2)
    h0 = _rc(rdb, "hits")
    assert s.sql(q).rows() == [(13 * 7 + 3,)]
    assert _rc(rdb, "hits") == _plus(h0, 1)
    root.sql("revoke select on rc from carol")
    with pytest.raises(SqlError):
        s.sql(q)
    assert _rc(rdb, "hits") == _plus(h0, 1)


def test_governor_pressure_refuses_admission(rdb):
    s = rdb.session()
    q = "select v from rc where k = 17"
    olds = rdb.both(lambda d: d.result_cache.pressure_fn)
    rdb.both(lambda d: setattr(d.result_cache, "pressure_fn", lambda: True))
    name = "result cache admit refused: pressure"
    try:
        p0 = _rc(rdb, "puts")
        c0 = rdb.both(lambda d: d.metrics.counter(name))
        _warm(s, q, 3)
        assert _rc(rdb, "puts") == p0
        c1 = rdb.both(lambda d: d.metrics.counter(name))
        assert c1[0] > c0[0] and c1[1] > c0[1]
    finally:
        rdb.j.result_cache.pressure_fn, rdb.t.result_cache.pressure_fn = olds
    s.sql(q).rows()  # pressure gone: admits
    h0 = _rc(rdb, "hits")
    assert s.sql(q).rows() == [(17 * 7 + 3,)]
    assert _rc(rdb, "hits") == _plus(h0, 1)


def test_capacity_eviction_keeps_bytes_bounded(rdb):
    s = rdb.session()
    olds = rdb.both(lambda d: d.result_cache.capacity_bytes)
    rdb.both(lambda d: d.config.set("ob_result_cache_size", "4096"))
    try:
        ev0 = _rc(rdb, "evictions")
        for k in range(8):
            _warm(s, f"select v from rc where k = {k}", 2)
        for d, e0 in zip((rdb.j, rdb.t), ev0):
            st = d.result_cache.stats()
            assert st["evictions"] > e0
            assert st["bytes_used"] <= 4096
            assert st["entries"] >= 1
    finally:
        for d, old in zip((rdb.j, rdb.t), olds):
            d.config.set("ob_result_cache_size", str(old))


def test_device_oom_ladder_flushes_result_cache(rdb):
    s = rdb.session()
    _warm(s, "select v from rc where k = 19", 3)
    assert all(n >= 1 for n in _rc(rdb, "entries"))
    name = "result cache evictions: device oom"
    ev0 = rdb.both(lambda d: d.metrics.counter(name))
    JERRSIM.arm("EN_DEVICE_OOM", error=JR.DeviceOOM("EN_DEVICE_OOM"),
                prob=1.0, count=1)
    TERRSIM.arm("EN_DEVICE_OOM", error=TR.DeviceOOM("EN_DEVICE_OOM"),
                prob=1.0, count=1)
    try:
        assert s.sql("select v from rc where k = 21").rows() == [(150,)]
    finally:
        JERRSIM.clear("EN_DEVICE_OOM")
        TERRSIM.clear("EN_DEVICE_OOM")
    assert _rc(rdb, "entries") == (0, 0)
    ev1 = rdb.both(lambda d: d.metrics.counter(name))
    assert ev1[0] > ev0[0] and ev1[1] > ev0[1]


LADDER_Q = ("select v, count(*) as n, sum(id) as s from lt group by v "
            "order by v")


def _ladder_db():
    d = TwinDatabase.build(n_nodes=1, n_ls=1)
    s = d.session()
    s.sql("create table lt (id bigint primary key, v bigint)")
    for i in range(0, 1500, 500):
        s.sql("insert into lt values " + ", ".join(
            f"({j}, {j * 37 % 100})" for j in range(i, i + 500)))
    return d, s


def test_device_oom_ladder_walks_every_rung_on_the_cpu():
    """A Database on the CPU absorbs three device OOMs as the JAX one
    does (evict, chunked, host) and returns the unfaulted rows."""
    d, s = _ladder_db()
    try:
        base = s.sql(LADDER_Q).rows()
        JERRSIM.arm("EN_DEVICE_OOM", error=JR.DeviceOOM("EN_DEVICE_OOM"),
                    prob=1.0, count=3)
        TERRSIM.arm("EN_DEVICE_OOM", error=TR.DeviceOOM("EN_DEVICE_OOM"),
                    prob=1.0, count=3)
        try:
            assert s.sql(LADDER_Q).rows() == base
        finally:
            JERRSIM.clear("EN_DEVICE_OOM")
            TERRSIM.clear("EN_DEVICE_OOM")
        assert s.j._ladder == s.t._ladder == ["evict", "chunked", "host"]
        assert d.both(lambda x: x.metrics.counter("stmt degraded host")) \
            == (1, 1)
    finally:
        d.close()


def test_card_database_ends_the_ladder_at_the_chunk_rung(monkeypatch):
    """Where the JAX Database falls back to the host, a Database on the
    card raises the third OOM (its tensors live on the card) and counts
    it; no statement of it runs on a CPU executor."""
    import torch

    d, s = _ladder_db()
    try:
        base = s.sql(LADDER_Q).rows()
        monkeypatch.setattr(d.t, "device", torch.device("cuda", 0))
        JERRSIM.arm("EN_DEVICE_OOM", error=JR.DeviceOOM("EN_DEVICE_OOM"),
                    prob=1.0, count=3)
        TERRSIM.arm("EN_DEVICE_OOM", error=TR.DeviceOOM("EN_DEVICE_OOM"),
                    prob=1.0, count=3)
        try:
            assert s.j.sql(LADDER_Q).rows() == base
            assert s.j._ladder[-1] == "host"
            with pytest.raises(TR.DeviceOOM, match="EN_DEVICE_OOM"):
                s.t.sql(LADDER_Q)
        finally:
            JERRSIM.clear("EN_DEVICE_OOM")
            TERRSIM.clear("EN_DEVICE_OOM")
        m = d.t.metrics
        assert s.t._ladder == ["evict", "chunked"]
        assert m.counter("stmt degraded host refused") == 1
        assert m.counter("stmt degraded host") == 0
        assert m.counter("stmt degraded chunked") == 1
    finally:
        d.close()


def test_weak_consistency_bypasses_result_cache():
    d = _mkdb(n_nodes=3, n_ls=2)
    try:
        d.both(lambda x: x.cluster.settle(1.0))
        s = d.session()
        q = "select v from rc where k = 5"
        _warm(s, q, 2)
        h0 = _rc(d, "hits")
        assert s.sql(q).rows() == [(5 * 7 + 3,)]
        assert _rc(d, "hits") == _plus(h0, 1)
        s.sql("set ob_read_consistency = 'weak'")
        try:
            assert s.sql(q).rows() == [(5 * 7 + 3,)]
            assert s.sql(q).rows() == [(5 * 7 + 3,)]
            assert s.j.last_follower_read is not None
            assert s.t.last_follower_read is not None
            assert _rc(d, "hits") == _plus(h0, 1)
        finally:
            s.sql("set ob_read_consistency = 'strong'")
    finally:
        d.close()


def test_concurrent_statements_keep_their_own_literals(esession):
    """Server threads share one engine Session (db.engine); each plan runs
    eagerly under its statement's bound literals, so two threads running
    one cached plan with different literals must each see their own."""
    import sys
    import threading

    ts = esession.t
    li = ts.catalog["lineitem"]
    q = "select count(*) from lineitem where l_quantity < {}"
    ts.sql(q.format(1))
    want = {x: int((li.data["l_quantity"] < x * 100).sum())
            for x in range(2, 50, 3)}
    errors = []

    def worker(xs):
        try:
            for _ in range(4):
                for x in xs:
                    got = int(ts.sql(q.format(x)).rows()[0][0])
                    if got != want[x]:
                        errors.append((x, got, want[x]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    xs = sorted(want)
    threads = [threading.Thread(target=worker, args=(xs[i::4],))
               for i in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
