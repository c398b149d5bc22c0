"""The MySQL wire front of the port against the JAX package's: twins of
tests/test_mysql_front.py over two local fronts, one serving a JAX
`Database` and one a port `Database(device="cpu")`. A minimal protocol-41
client (tests/test_mysql_front.MiniMySqlClient) drives both with the same
packets; every answer (text and binary result sets, OK counts, errors)
must be the same from both.
"""

import pytest

from oceanbase_tpu.server.database import Database as JDatabase
from oceanbase_tpu.server.mysql_front import MySqlFrontend as JFrontend
from oceanbase_tpu_torch.server.database import Database as TDatabase
from oceanbase_tpu_torch.server.mysql_front import MySqlFrontend as TFrontend
from test_mysql_front import MiniMySqlClient


def _call(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 - compared by the caller
        return None, e


class TwinClient:
    """One MiniMySqlClient per front; each command goes to both and the
    answers must agree. Returns the port front's answer."""

    def __init__(self, fronts, user="root", password=""):
        jfe, tfe = fronts
        self.j = MiniMySqlClient(jfe.port, user, password)
        self.t = MiniMySqlClient(tfe.port, user, password)
        assert self.j.server_version == self.t.server_version

    def _both(self, name, *args, **kw):
        jr, jerr = _call(lambda: getattr(self.j, name)(*args, **kw))
        tr, terr = _call(lambda: getattr(self.t, name)(*args, **kw))
        if jerr is not None or terr is not None:
            assert jerr is not None and terr is not None, (args, jerr, terr)
            assert type(jerr) is type(terr), (jerr, terr)
            # ERR packets name the same code
            assert str(jerr).split(":")[0] == str(terr).split(":")[0]
            raise terr
        assert jr == tr, (args, jr, tr)
        return tr

    def query(self, sql):
        return self._both("query", sql)

    def ping(self):
        return self._both("ping")

    def prepare(self, sql):
        return self._both("prepare", sql)

    def execute(self, sid, params=(), send_types=True):
        return self._both("execute", sid, params, send_types=send_types)

    @property
    def server_version(self):
        return self.t.server_version

    def close(self):
        self.j.close()
        self.t.close()


def _start(n_nodes, n_ls, **kw):
    jfe = JFrontend(JDatabase(n_nodes=n_nodes, n_ls=n_ls), **kw).start()
    tfe = TFrontend(TDatabase(n_nodes=n_nodes, n_ls=n_ls, device="cpu"),
                    **kw).start()
    return jfe, tfe


@pytest.fixture()
def front():
    fronts = _start(3, 1)
    yield fronts
    for fe in fronts:
        fe.stop()


def test_connect_ping_and_ddl_dml_query(front):
    c = TwinClient(front)
    assert b"oceanbase-tpu" in c.server_version
    assert c.ping()
    assert c.query(
        "create table t (id bigint primary key, v int, s varchar)") == 0
    assert c.query("insert into t values (1, 10, 'a'), (2, 20, 'b')") == 2
    names, rows = c.query("select id, v, s from t order by id")
    assert names == ["id", "v", "s"]
    assert rows == [("1", "10", "a"), ("2", "20", "b")]
    c.close()


def test_aggregate_query_and_error(front):
    c = TwinClient(front)
    c.query("create table t (id bigint primary key, v int)")
    for i in range(1, 6):
        c.query(f"insert into t values ({i}, {i * 10})")
    names, rows = c.query("select sum(v) as total, count(*) as n from t")
    assert names == ["total", "n"]
    assert rows == [("150", "5")]
    with pytest.raises(RuntimeError, match="ERR"):
        c.query("select * from nonexistent_table")
    assert c.ping()
    c.close()


def test_transaction_spans_statements(front):
    c1 = TwinClient(front)
    c2 = TwinClient(front)
    c1.query("create table t (id bigint primary key, v int)")
    c1.query("begin")
    c1.query("insert into t values (1, 1)")
    _, rows = c2.query("select id from t")
    assert rows == []
    c1.query("commit")
    _, rows = c2.query("select id from t")
    assert rows == [("1",)]
    c1.close()
    c2.close()


def test_q6_over_the_wire(front):
    from oceanbase_tpu.models.tpch import datagen as jdatagen
    from oceanbase_tpu.models.tpch.sql_suite import QUERIES
    from oceanbase_tpu_torch.models.tpch import datagen as tdatagen
    from oceanbase_tpu_torch.models.tpch.queries import q6_numpy

    jfe, tfe = front
    jfe.db.catalog.update(jdatagen.generate(sf=0.01))
    tables = tdatagen.generate(sf=0.01)
    tfe.db.catalog.update(tables)
    c = TwinClient(front)
    names, rows = c.query(QUERIES[6])
    assert names == ["revenue"] and len(rows) == 1
    want = q6_numpy(tables["lineitem"]) / 1e4  # the oracle's scale 4
    assert abs(float(rows[0][0]) - want) <= 1e-6 * max(1.0, abs(want))
    c.close()


def test_password_verification():
    fronts = _start(1, 1, users={"root": "s3cret", "ro": ""})
    try:
        c = TwinClient(fronts, "root", "s3cret")
        assert c.ping()
        c.close()
        c2 = TwinClient(fronts, "ro", "")
        assert c2.ping()
        c2.close()
        for fe in fronts:
            with pytest.raises(PermissionError):
                MiniMySqlClient(fe.port, "root", "wrong")
            with pytest.raises(PermissionError):
                MiniMySqlClient(fe.port, "nobody", "s3cret")
    finally:
        for fe in fronts:
            fe.stop()


def test_prepared_statements_binary_protocol(front):
    c = TwinClient(front)
    c.query("create table pt (id bigint primary key, v bigint, s varchar)")
    sid, np_ = c.prepare("insert into pt values (?, ?, ?)")
    assert np_ == 3
    for i in range(1, 6):
        assert c.execute(sid, (i, i * 10, f"row{i}")) == 1
    sid2, np2 = c.prepare("select id, v, s from pt where id >= ? order by id")
    assert np2 == 1
    types, rows = c.execute(sid2, (3,))
    assert types[:2] == [8, 8]
    assert rows == [(3, 30, "row3"), (4, 40, "row4"), (5, 50, "row5")]
    _t, rows2 = c.execute(sid2, (5,))
    assert rows2 == [(5, 50, "row5")]
    sid3, _ = c.prepare("select s from pt where s = ?")
    _t, r3 = c.execute(sid3, ("row2",))
    assert r3 == [("row2",)]
    c.execute(sid, (6, 60, "it's"))
    _t, r4 = c.execute(sid3, ("it's",))
    assert r4 == [("it's",)]
    sid4, _ = c.prepare("select count(*) as n from pt where v = ?")
    _t, r5 = c.execute(sid4, (None,))
    assert r5 == [(0,)]
    c.close()


def _coldef_types(c, sql):
    c.seq = 0
    c._send(b"\x03" + sql.encode())
    first = c._read()
    ncols, _ = c._lenenc(first, 0)
    tys = []
    for _ in range(ncols):
        col = c._read()
        pos = 0
        for _f in range(6):
            ln, pos = c._lenenc(col, pos)
            pos += ln
        pos += 1 + 2 + 4
        tys.append(col[pos])
    eofs = 0
    while eofs < 2:  # the column EOF, then the rows' EOF
        pkt = c._read()
        if pkt[0] == 0xFE and len(pkt) < 9:
            eofs += 1
    return tys


def test_typed_text_coldefs(front):
    c = TwinClient(front)
    c.query("create table ty (id bigint primary key, s varchar)")
    c.query("insert into ty values (1, 'x')")
    tys = [_coldef_types(x, "select id, s from ty") for x in (c.j, c.t)]
    assert tys[0] == tys[1] == [8, 253]  # LONGLONG, VAR_STRING
    c.close()


def test_stmt_reexecute_without_types(front):
    c = TwinClient(front)
    c.query("create table rx (id bigint primary key, v bigint)")
    for i in range(1, 4):
        c.query(f"insert into rx values ({i}, {i * 7})")
    sid, _ = c.prepare("select v from rx where id = ?")
    _t, r1 = c.execute(sid, (2,))
    assert r1 == [(14,)]
    _t, r2 = c.execute(sid, (3,), send_types=False)
    assert r2 == [(21,)]
    _t, r3 = c.execute(sid, (1,), send_types=False)
    assert r3 == [(7,)]
    c.close()


def test_stmt_execute_no_params(front):
    c = TwinClient(front)
    c.query("create table np0 (id bigint primary key)")
    c.query("insert into np0 values (1), (2)")
    sid, np_ = c.prepare("select id from np0 order by id")
    assert np_ == 0
    _t, rows = c.execute(sid, ())
    assert rows == [(1,), (2,)]
    c.close()
