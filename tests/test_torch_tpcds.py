"""The TPC-DS star suite on the port: its generator gives the JAX
package's arrays and dictionaries from the same seed, and the four star
queries (TPC-DS Q3, Q42, Q52, Q55) through the port's Session on the CPU
equal the JAX Session's rows (storage exact, floats to rel 1e-12) and
sqlite's (floats to rel 1e-6, abs 1e-2, as tests/test_tpcds.py holds
the reference), at SF 0.005. The revenue-ratio window shape of TPC-DS
Q98/Q12/Q20 runs beside them. Each session gets its own package's unique
keys: the port's list each dimension's key as a key tuple, so its star
joins take the unique-build routes, where the reference's flat tuples
leave them on the M:N expansion; the rows must agree all the same.
"""

import sqlite3

import numpy as np
import pytest

from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpcds import UNIQUE_KEYS as J_UNIQUE_KEYS
from oceanbase_tpu.models.tpcds import datagen as JD
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpcds import QUERIES, UNIQUE_KEYS
from oceanbase_tpu_torch.models.tpcds import datagen as TD
from tests.torch_twins import check_twin

SF = 0.005
SEED = 20030101

REVENUE_RATIO = """
    select item.i_category, item.i_brand,
           sum(ss.ss_ext_sales_price) as itemrevenue,
           sum(ss.ss_ext_sales_price) * 100
             / sum(sum(ss.ss_ext_sales_price))
               over (partition by item.i_category) as revenueratio
    from store_sales ss, item, date_dim dt
    where ss.ss_item_sk = item.i_item_sk
      and ss.ss_sold_date_sk = dt.d_date_sk
      and dt.d_year = 2000 and dt.d_moy between 1 and 3
    group by item.i_category, item.i_brand
    order by item.i_category, item.i_brand"""


@pytest.fixture(scope="module")
def db():
    jt = JD.generate(sf=SF, seed=SEED)
    tt = TD.generate(sf=SF, seed=SEED)
    js = JSession(jt, unique_keys=J_UNIQUE_KEYS)
    ts = TSession(tt, unique_keys=UNIQUE_KEYS, device="cpu")
    conn = sqlite3.connect(":memory:")
    for name, t in tt.items():
        cols = t.schema.names()
        decoded = {}
        for c in cols:
            dt = t.schema[c]
            if dt.kind.value == "varchar":
                decoded[c] = t.dicts[c].decode(t.data[c])
            elif dt.is_decimal:
                decoded[c] = (t.data[c] / dt.decimal_factor).tolist()
            elif dt.kind.value == "date":
                base = np.datetime64("1970-01-01", "D")
                decoded[c] = [str(base + int(v)) for v in t.data[c]]
            else:
                decoded[c] = t.data[c].tolist()
        conn.execute(f"create table {name} ({', '.join(cols)})")
        conn.executemany(
            f"insert into {name} values ({','.join('?' * len(cols))})",
            list(zip(*[decoded[c] for c in cols])))
    conn.commit()
    yield jt, tt, js, ts, conn
    conn.close()


def test_generator_matches_jax(db):
    jt, tt, *_ = db
    assert list(jt) == list(tt)
    for name in jt:
        a, b = jt[name], tt[name]
        assert a.nrows == b.nrows
        assert a.schema.names() == b.schema.names()
        for c in a.schema.names():
            assert np.array_equal(np.asarray(a.data[c]),
                                  np.asarray(b.data[c])), f"{name}.{c}"
        assert sorted(a.dicts) == sorted(b.dicts)
        for c in a.dicts:
            assert a.dicts[c]._values == b.dicts[c]._values, f"{name}.{c}"


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_star_join_matches_jax_and_sqlite(db, qid):
    _jt, _tt, js, ts, conn = db
    got = check_twin(js, ts, QUERIES[qid])
    want = conn.execute(QUERIES[qid]).fetchall()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert float(gv) == pytest.approx(wv, rel=1e-6, abs=1e-2)
            elif isinstance(wv, str):
                assert str(gv) == wv
            else:
                assert int(gv) == int(wv)


def test_revenue_ratio_window_matches_jax(db):
    _jt, _tt, js, ts, _conn = db
    rows = check_twin(js, ts, REVENUE_RATIO)
    by_cat: dict = {}
    for cat, _brand, _rev, ratio in rows:
        by_cat[cat] = by_cat.get(cat, 0.0) + float(ratio)
    for cat, total in by_cat.items():
        assert total == pytest.approx(100.0, rel=1e-9), cat


def test_star_joins_take_unique_build_routes(db, monkeypatch):
    """With the dimensions' keys unique, the star joins never expand."""
    from oceanbase_tpu_torch.engine import executor as TX

    *_rest, ts, _conn = db
    calls = []
    orig = TX.expand_join

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(TX, "expand_join", counted)
    for qid in sorted(QUERIES):
        assert ts.sql(QUERIES[qid]).nrows > 0
    assert not calls
