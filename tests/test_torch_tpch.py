"""All 22 TPC-H queries through the port's Session on the CPU against the
JAX Session, on the same generated tables at SF 0.01 (seed 19920101).

Every result must hold the same rows in the same order: integers, scaled
decimals, dates and dictionary codes exactly in the storage domain, and
every decoded row (strings exact, float columns at rel 1e-12, since the
two backends sum in different orders). Q20 selects no supplier at this
scale as written, so it also runs with its nation rebound to GERMANY,
where the reference finds one. Last, expansion-join capacities seeded far
too small make the overflow retry run, and the retried plan must land on
the same rows as the reference.
"""

import numpy as np
import pytest

from oceanbase_tpu.core.column import batch_rows_storage as j_storage
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.sql import parser as JP
from oceanbase_tpu_torch.core.column import batch_rows_storage as t_storage
from oceanbase_tpu_torch.engine.executor import ROOT_COMPACT
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch import queries as TQ
from oceanbase_tpu_torch.models.tpch import sql_suite as TS
from oceanbase_tpu_torch.sql import parser as TP

Q20_GERMANY = TS.QUERIES[20].replace("'CANADA'", "'GERMANY'")


@pytest.fixture(scope="module")
def engines():
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    js = JSession(jt, unique_keys=TS.UNIQUE_KEYS)
    ts = TSession(tt, unique_keys=TS.UNIQUE_KEYS, device="cpu")
    return js, ts, tt


def _rows_equal(jrows, trows, what):
    assert len(jrows) == len(trows), what
    for i, (a, b) in enumerate(zip(jrows, trows)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            if isinstance(x, (float, np.floating)):
                assert isinstance(y, (float, np.floating)), what
                if np.isnan(x):
                    assert np.isnan(y), f"{what} row {i}"
                else:
                    assert y == pytest.approx(x, rel=1e-12, abs=0.0), \
                        f"{what} row {i}: {x} vs {y}"
            else:
                assert (x is None) == (y is None), f"{what} row {i}"
                assert x == y, f"{what} row {i}: {x} vs {y}"


def _storage_equal(jcols, tcols, what):
    assert list(jcols) == list(tcols), what
    for c in jcols:
        j, t = np.asarray(jcols[c]), np.asarray(tcols[c])
        assert j.shape == t.shape, f"{what} {c}"
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=1e-12, atol=0.0,
                                       err_msg=f"{what} {c}")
        else:
            assert np.array_equal(j, t), f"{what} {c}"


def _run_both(js, ts, text):
    """(JAX rows, port rows, JAX storage columns, port storage columns)."""
    jp = js.planner.plan(JP.parse(text))
    tp = ts.planner.plan(TP.parse(text))
    jo = js.executor.prepare(jp.plan).run()
    to = ts.executor.prepare(tp.plan).run()
    names = list(jp.output_names)
    assert names == list(tp.output_names)
    return (js.sql(text).rows(), ts.sql(text).rows(), j_storage(jo, names),
            t_storage(to, names))


@pytest.mark.parametrize("qid", TS.SUPPORTED)
def test_query_matches_jax(engines, qid):
    js, ts, _tt = engines
    jrows, trows, jcols, tcols = _run_both(js, ts, TS.QUERIES[qid])
    _rows_equal(jrows, trows, f"Q{qid}")
    _storage_equal(jcols, tcols, f"Q{qid}")


def test_supported_covers_all_22():
    assert tuple(TS.SUPPORTED) == tuple(range(1, 23))


def test_q20_rebound_to_a_nation_with_rows(engines):
    js, ts, tt = engines
    jrows, trows, jcols, tcols = _run_both(js, ts, Q20_GERMANY)
    assert len(jrows) == 1
    _rows_equal(jrows, trows, "Q20 GERMANY")
    _storage_equal(jcols, tcols, "Q20 GERMANY")
    assert len(ts.sql(TS.QUERIES[20]).rows()) == 0
    for nation in ("CANADA", "GERMANY"):
        text = TS.QUERIES[20].replace("'CANADA'", f"'{nation}'")
        got = ts.sql(text).storage_columns()
        want = TQ.q20_numpy(tt, nation)
        for c in want:
            assert np.array_equal(np.asarray(got[c]).astype(np.int64),
                                  want[c]), (nation, c)


@pytest.mark.parametrize("qid,oracle", [(4, TQ.q4_numpy), (11, TQ.q11_numpy),
                                        (12, TQ.q12_numpy),
                                        (13, TQ.q13_numpy),
                                        (20, TQ.q20_numpy)])
def test_new_oracles_equal_jax(engines, qid, oracle):
    """The int64 oracles chip_smoke.py checks at SF 10 equal the JAX
    Session's storage-domain result here."""
    js, _ts, tt = engines
    jp = js.planner.plan(JP.parse(TS.QUERIES[qid]))
    got = j_storage(js.executor.prepare(jp.plan).run(),
                    list(jp.output_names))
    want = oracle(tt)
    for c, v in got.items():
        assert np.array_equal(np.asarray(v).astype(np.int64), want[c]), c


@pytest.mark.parametrize("qid", [9, 13, 21])
def test_join_cap_overflow_retry_matches_jax(engines, qid):
    """Every expansion join's capacity seeded at 16 (far below its
    pairs): the total rides the overflow channel, the plan re-runs at x4
    capacities until it fits, and the rows equal the reference's first
    run at seeded capacities."""
    js, ts, _tt = engines
    text = TS.QUERIES[qid]
    tp = ts.executor.prepare(ts.planner.plan(TP.parse(text)).plan)
    caps = [nid for nid in tp.params.join_cap if nid != ROOT_COMPACT]
    assert caps, "the plan has an expansion join"
    for nid in caps:
        tp.params.join_cap[nid] = 16
    tp.recompile()
    out = tp.run(max_retries=8)
    assert tp.retries >= 1
    names = list(ts.planner.plan(TP.parse(text)).output_names)
    jp = js.planner.plan(JP.parse(text))
    want = j_storage(js.executor.prepare(jp.plan).run(), names)
    _storage_equal(want, t_storage(out, names), f"Q{qid} retried")
