"""The rest of the Session's SQL surface in the port against the JAX package.

The same statements through the JAX Session and the port's
Session(device="cpu") over tables made by the two packages' own
generators from one seed (TPC-H SF 0.01), compared with
tests/torch_twins.py:

- cross joins: an explicit CROSS JOIN, a FROM-list table no
  equi-predicate reaches, a self cross join under a residual, and the
  reference's tests/test_fastpath.py::test_affine_through_join statement
  against that test's oracle;
- JSON_OBJECT / JSON_ARRAY select items (split into hidden argument
  columns, formatted on the host), including the statements of
  tests/test_json.py over a table with a JSON document column, and two
  statements that differ only in constructor literals (they must not
  share a cached formatting spec);
- the four WITH RECURSIVE statements of tests/test_recursive_rollup.py;
- `Session.materialize` (a storage-domain Table equal to the reference's,
  NULL masks included), `Session.cached_entry` (the entry sql() used, with
  the same bound parameters) and `LazyResultSet.column`.
"""

import json

import numpy as np
import pytest

from oceanbase_tpu.core.dtypes import DataType as JDataType
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.dtypes import TypeKind as JTypeKind
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu_torch.core.dtypes import DataType, Field, Schema, TypeKind
from oceanbase_tpu_torch.core.table import Table
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch import sql_suite as TS
from oceanbase_tpu_torch.sql.logical import ResolveError
from torch_twins import check_twin


@pytest.fixture(scope="module")
def sessions():
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    return (JSession(jt, unique_keys=TS.UNIQUE_KEYS),
            TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu"))


# ---------------------------------------------------------------- cross joins

CROSS = {
    "from_list": ("select count(*) as n from nation, region", 125),
    "cross_join": ("select count(*) as n from nation cross join region",
                   125),
    "self_residual": ("select count(*) as n from region r1, region r2 "
                      "where r1.r_regionkey + 1 = r2.r_regionkey", 4),
    "rows": ("select n_name, r_name from nation, region "
             "where n_nationkey < 4 order by n_name, r_name", None),
}


@pytest.mark.parametrize("name", list(CROSS))
def test_cross_join_matches_jax(sessions, name):
    js, ts = sessions
    text, want = CROSS[name]
    rows = check_twin(js, ts, text)
    if want is not None:
        assert rows == [(want,)]


def test_affine_through_join_equals_its_oracle():
    """tests/test_fastpath.py::test_affine_through_join: `big, a, b` with
    `av + 1 = bk`, whose join order leaves a FROM-list cross join, against
    that test's own oracle (the JAX Session answers it in ~26 s on the
    CPU, expanding the 16M-pair cross join, so it is not run here)."""
    n = 2000
    data = {
        "a": {"ak": np.arange(1, n + 1, dtype=np.int64) * 3,
              "av": np.arange(n, dtype=np.int64)},
        "b": {"bk": np.arange(1, n + 1, dtype=np.int64),
              "bv": np.arange(n, dtype=np.int64) * 7},
        "big": {"gk": (np.arange(4 * n, dtype=np.int64) % (2 * n)) * 3,
                "gv": np.arange(4 * n, dtype=np.int64)},
    }

    def catalog(T, S, F, DT, TK):
        return {t: T(t, S(tuple(F(c, DT(TK.INT64)) for c in cols)),
                     dict(cols))
                for t, cols in data.items()}

    tc = catalog(Table, Schema, Field, DataType, TypeKind)
    uk = {"a": (("ak",),), "b": (("bk",),)}
    q = """select sum(gv) as s, sum(bv) as t from big, a, b
    where gk = ak and av + 1 = bk"""
    sess = TSession(tc, unique_keys=uk, device="cpu")
    rs = sess.sql(q)
    rows = rs.rows()
    assert sess.cached_entry(q)[0].prepared.params.join_cap
    amap = dict(zip(data["a"]["ak"].tolist(), data["a"]["av"].tolist()))
    bmap = dict(zip(data["b"]["bk"].tolist(), data["b"]["bv"].tolist()))
    s = t = 0
    for gk, gv in zip(data["big"]["gk"].tolist(), data["big"]["gv"].tolist()):
        av = amap.get(gk)
        if av is not None and av + 1 in bmap:
            s += gv
            t += bmap[av + 1]
    assert rows == [(s, t)] and s > 0


# ------------------------------------------------------- JSON constructors

DOCS = [
    (1, '{"name": "ann", "age": 31, "tags": ["a", "b"]}'),
    (2, '{"name": "bob", "age": 25}'),
    (3, '{"name": "cy", "meta": null}'),
    (4, 'not valid json at all'),
]


@pytest.fixture(scope="module")
def json_sessions():
    cols = {"id": np.asarray([i for i, _ in DOCS], dtype=np.int64),
            "j": np.asarray([t for _, t in DOCS])}
    jt = JTable.from_pydict("docs", JSchema((
        JField("id", JDataType(JTypeKind.INT64)),
        JField("j", JDataType(JTypeKind.VARCHAR)))), cols)
    tt = Table.from_pydict("docs", Schema((
        Field("id", DataType(TypeKind.INT64)),
        Field("j", DataType(TypeKind.VARCHAR)))), cols)
    return JSession({"docs": jt}), TSession({"docs": tt}, device="cpu")


JSON_STATEMENTS = {
    "object_extract": ("select json_object('id', id, 'who', j->>'$.name') "
                       "as o from docs where id <= 2 order by id"),
    "array_nested": ("select json_array(1, 'x', json_object('k', id)) as a "
                     "from docs where id = 1"),
    "array_with_other_items": ("select id, json_array(id, null, 2.5) as a, "
                               "j->>'$.age' as age from docs order by id"),
}


@pytest.mark.parametrize("name", list(JSON_STATEMENTS))
def test_json_constructor_matches_jax(json_sessions, name):
    js, ts = json_sessions
    text = JSON_STATEMENTS[name]
    jr, tr = js.sql(text), ts.sql(text)
    assert tuple(jr.names) == tuple(tr.names)
    assert tr.rows() == jr.rows()
    assert tr.rows()


def test_json_constructor_values(json_sessions):
    _js, ts = json_sessions
    (row,) = ts.sql(JSON_STATEMENTS["array_nested"]).rows()
    assert json.loads(row[0]) == [1, "x", {"k": 1}]
    got = [json.loads(r[0]) for r in
           ts.sql(JSON_STATEMENTS["object_extract"]).rows()]
    assert got == [{"id": 1, "who": "ann"}, {"id": 2, "who": "bob"}]


def test_constructor_literals_not_cache_confused(json_sessions):
    _js, ts = json_sessions
    a = ts.sql("select json_object('a', id) as o from docs where id = 1")
    b = ts.sql("select json_object('b', id) as o from docs where id = 1")
    assert json.loads(a.rows()[0][0]) == {"a": 1}
    assert json.loads(b.rows()[0][0]) == {"b": 1}
    c = ts.sql("select json_object('b', id) as o from docs where id = 2")
    assert json.loads(c.rows()[0][0]) == {"b": 2}
    assert not c.fast_path_hit and c.plan_cache_hit


@pytest.mark.parametrize("text,want", [
    ("select json_array(n_nationkey, 'x') as a from nation "
     "where n_nationkey = 1", ['[1, "x"]']),
    ("select json_object('k', n_nationkey, 'name', n_name) as o from nation "
     "where n_nationkey < 3 order by n_nationkey", None),
])
def test_json_on_tpch_matches_jax(sessions, text, want):
    js, ts = sessions
    got = ts.sql(text).rows()
    assert got == js.sql(text).rows()
    if want is not None:
        assert [r[0] for r in got] == want
    else:
        assert json.loads(got[0][0]) == {"k": 0, "name": "ALGERIA"}


def test_json_constructor_misuse_is_a_resolve_error(json_sessions):
    _js, ts = json_sessions
    with pytest.raises(ResolveError):
        ts.sql("select json_object('k') as o from docs")
    with pytest.raises(ResolveError):
        ts.sql("select json_object('k', id) as o from docs order by o")


# -------------------------------------------------------- WITH RECURSIVE

RECURSIVE = {
    "counter": """with recursive cnt as (
      select 1 as n union all select n + 1 as n from cnt where n < 50
    ) select n from cnt order by n""",
    "transitive_closure": """with recursive reach as (
      select c_custkey as k from customer where c_custkey = 1
      union
      select r.k + 3 as k from reach as r where r.k + 3 <= 40
    ) select k from reach order by k""",
    "over_table_join": """with recursive chain as (
      select o_orderkey as k, o_custkey as c from orders where o_orderkey = 4
      union
      select o.o_orderkey as k, o.o_custkey as c
      from chain, orders as o where o.o_orderkey = chain.k * 2
         and o.o_orderkey <= 512
    ) select k, c from chain order by k""",
    "union_dedups": """with recursive m as (
      select 0 as v
      union
      select (v + 7) % 20 as v from m
    ) select v from m order by v""",
}


@pytest.mark.parametrize("name", list(RECURSIVE))
def test_recursive_matches_jax(sessions, name):
    js, ts = sessions
    jr, tr = js.sql(RECURSIVE[name]), ts.sql(RECURSIVE[name])
    assert tuple(jr.names) == tuple(tr.names)
    assert tr.rows() == jr.rows()
    want = {"counter": 50, "transitive_closure": 14, "union_dedups": 20}
    assert len(tr.rows()) == want.get(name, len(jr.rows())) > 0


# ------------------------------------ materialize, cached_entry, column

MATERIALIZE = {
    "join": """select n_nationkey, n_name, r_name from nation, region
        where n_regionkey = r_regionkey""",
    "nulls": """select c_custkey, o_orderkey, o_totalprice from customer
        left join orders on o_custkey = c_custkey and o_totalprice > 40000000
        where c_custkey < 40""",
    "recursive": RECURSIVE["transitive_closure"],
}


@pytest.mark.parametrize("name", list(MATERIALIZE))
def test_materialize_matches_jax(sessions, name):
    js, ts = sessions
    jt = js.materialize(MATERIALIZE[name], "mv")
    tt = ts.materialize(MATERIALIZE[name], "mv")
    assert tt.name == "mv" and tt.nrows == jt.nrows > 0
    assert [(f.name, f.dtype.kind.value, f.dtype.precision, f.dtype.scale,
             f.dtype.nullable) for f in tt.schema.fields] == \
        [(f.name, f.dtype.kind.value, f.dtype.precision, f.dtype.scale,
          f.dtype.nullable) for f in jt.schema.fields]
    assert list(tt.data) == list(jt.data)
    for c in jt.data:
        assert tt.data[c].dtype == jt.data[c].dtype, c
        assert np.array_equal(tt.data[c], jt.data[c]), c
    assert sorted(tt.valid) == sorted(jt.valid)
    for c in jt.valid:
        assert np.array_equal(tt.valid[c], jt.valid[c]), c
    assert sorted(tt.dicts) == sorted(jt.dicts)
    for c in jt.dicts:
        n = len(jt.dicts[c])
        assert list(tt.dicts[c].decode(np.arange(n))) == \
            list(jt.dicts[c].decode(np.arange(n)))
    if name == "nulls":
        assert tt.valid and not all(v.all() for v in tt.valid.values())


def test_cached_entry_is_the_entry_sql_used(sessions):
    _js, ts = sessions
    text = ("select l_orderkey, l_quantity from lineitem "
            "where l_quantity < 3 and l_shipdate > date '1997-02-01' "
            "order by l_orderkey, l_linenumber limit 20")
    rs = ts.sql(text)
    entry, qparams = ts.cached_entry(text)
    assert entry is not None and entry.prepared is rs._cursor.prepared
    n_entries = len(ts.plan_cache._entries) \
        if hasattr(ts.plan_cache, "_entries") else None
    out = entry.prepared.run(qparams=qparams)
    from oceanbase_tpu_torch.core.column import batch_to_host

    host = batch_to_host(out)
    assert [tuple(r) for r in zip(*(host[n] for n in rs.names))] == rs.rows()
    if n_entries is not None:
        assert len(ts.plan_cache._entries) == n_entries
    assert ts.cached_entry(text.replace("< 3", "< 4"))[0] is entry
    assert ts.cached_entry("select count(*) from region") == (None, None)


def test_lazy_column_fetches_one_column(sessions):
    js, ts = sessions
    text = ("select n_nationkey, n_name from nation where n_regionkey = 2 "
            "order by n_nationkey")
    # the plain lazy cursor transfers only the touched column; a Session
    # narrows its result frame by default (as the JAX Session does), and
    # a narrowed frame arrives whole with the completion copy, as does a
    # result whose footprint the profile measured to be small
    ts.narrow_enabled_fn = ts.profile_enabled_fn = lambda: False
    try:
        rs = ts.sql(text)
    finally:
        ts.narrow_enabled_fn = ts.profile_enabled_fn = None
    assert list(rs.column("n_name")) == list(js.sql(text).columns["n_name"])
    assert "n_nationkey" not in rs._cursor._hcols
    rs = ts.sql(text)
    assert rs._cursor.narrowed
    assert list(rs.column("n_name")) == list(js.sql(text).columns["n_name"])
