"""The port's batched program and packed parameter ABI against the JAX
package's: twins of tests/test_stmt_batch.py over
tests/torch_twins.TwinDatabase (a JAX Database and a port
Database(device="cpu") built alike), a twin of
tests/test_vector_serving.py::test_batched_lanes_identical_to_solo, the
packed rows of pack_qparams / _collect_qparam_spec against the JAX
functions' on the same plans (bit for bit, VECTOR slots included), and
_combo_run on two cohorts against their solo rows. Rows are compared
exactly (integers and the storage domain).
"""

import threading

import numpy as np
import pytest

from oceanbase_tpu.engine import executor as JX
from oceanbase_tpu_torch.engine import executor as TX
from oceanbase_tpu_torch.server import batcher as TB
from torch_twins import TwinDatabase

N_KEYS = 50


def _fill(db):
    s = db.session()
    s.sql("create table kv (id int primary key, k int, v int)")
    rows = ", ".join(f"({i + 1}, {i}, {i * 7 + 3})" for i in range(N_KEYS))
    s.sql(f"insert into kv values {rows}")
    # register the fast entry outside the concurrent phase
    for k in range(3):
        assert s.sql(f"select v from kv where k = {k}").rows() == [
            (k * 7 + 3,)]
    return db


def _mk_twins():
    tw = TwinDatabase.build(n_nodes=1, n_ls=1)
    tw.both(_fill)
    return tw


@pytest.fixture(scope="module")
def twins():
    tw = _mk_twins()
    yield tw
    tw.close()


def _run_rounds(db, nthreads: int, rounds: int, wait_us: int = 50_000,
                max_size: int = 0):
    """Barrier-synced closed rounds on ONE entry (tests/test_stmt_batch.py's
    rounds): {(thread, round): (key, rows)}."""
    sessions = [db.session() for _ in range(nthreads)]
    for s in sessions:
        s.sql(f"set ob_batch_max_wait_us = {wait_us}")
        s.sql(f"set ob_batch_max_size = {max_size or nthreads}")
        s.sql("set ob_enable_result_cache = 0")
    barrier = threading.Barrier(nthreads)
    results: dict = {}
    errors: list = []

    def worker(i: int) -> None:
        s = sessions[i]
        try:
            for r in range(rounds):
                barrier.wait()
                k = (i + r) % N_KEYS
                results[(i, r)] = (k, s.sql(
                    f"select v from kv where k = {k}").rows())
        except Exception as e:  # pragma: no cover - surfaced by assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return results


def _delta(c0, c1, name):
    return c1.get(name, 0) - c0.get(name, 0)


def test_batched_results_match_solo(twins):
    """Batcher on and off give the same rows, equal to the JAX
    Database's; the port's on-leg batches (statements per dispatch > 1)
    within the pow2 compile bound."""
    legs = {}
    for name, db in (("jax", twins.j), ("port", twins.t)):
        c0 = db.metrics.counters_snapshot()
        db.batcher.enabled = True
        on = _run_rounds(db, nthreads=8, rounds=8)
        c1 = db.metrics.counters_snapshot()
        db.batcher.enabled = False
        try:
            off = _run_rounds(db, nthreads=8, rounds=8)
        finally:
            db.batcher.enabled = True
        for key, (k, rows) in on.items():
            assert [tuple(int(x) for x in r) for r in rows] == [
                (k * 7 + 3,)], key
        assert on == off
        batched = _delta(c0, c1, "stmt batched statements")
        dispatches = _delta(c0, c1, "stmt batched dispatches")
        assert dispatches > 0 and batched / dispatches > 1.0, name
        legs[name] = on
    assert {k: [tuple(int(x) for x in r) for r in v[1]]
            for k, v in legs["jax"].items()} == {
        k: [tuple(int(x) for x in r) for r in v[1]]
        for k, v in legs["port"].items()}
    assert twins.t.engine.executor.batched_compiles <= 4


def test_batch_observability(twins):
    """Audit rows carry is_batched / batch_id / batch_wait_us, lanes of
    one dispatch share a batch_id, sysstat grows the pow2 size counters
    and the batcher wait event: on the port as on the JAX Database."""
    for db in (twins.j, twins.t):
        # a round batches only when its arrivals overlap an in-flight
        # dispatch; on a loaded host a few rounds may all run solo
        for _attempt in range(3):
            a0 = len(db.audit.records())
            _run_rounds(db, nthreads=4, rounds=4)
            recs = [r for r in db.audit.records()[a0:]
                    if r.sql.startswith("select v from kv") and r.is_batched]
            if recs:
                break
        assert recs, "no batched audit rows"
        by_batch: dict = {}
        for r in recs:
            assert r.batch_id > 0 and r.batch_wait_us >= 0
            by_batch.setdefault(r.batch_id, []).append(r)
        assert any(len(v) > 1 for v in by_batch.values())
        snap = db.metrics.counters_snapshot()
        assert any(name.startswith("stmt batch size ") for name in snap)
        assert any(w.event == "stmt batch window"
                   for w in db.metrics.waits_snapshot())


def test_solo_leader_degrades(twins):
    """A leader nobody joins runs the plain fast path: right rows, `stmt
    batch solo` counted, no batched dispatch."""
    for db in (twins.j, twins.t):
        s = db.session()
        s.sql("set ob_batch_max_wait_us = 100")
        s.sql("set ob_batch_max_size = 8")
        s.sql("set ob_enable_result_cache = 0")
        c0 = db.metrics.counters_snapshot()
        assert [tuple(int(x) for x in r) for r in s.sql(
            "select v from kv where k = 11").rows()] == [(80,)]
        c1 = db.metrics.counters_snapshot()
        assert _delta(c0, c1, "stmt batch solo") > 0
        assert _delta(c0, c1, "stmt batched dispatches") == 0


def test_tx_scoped_statements_never_batch(twins):
    """An open transaction pins its snapshot: tx statements skip the
    fast path and never ride a batch."""
    ts = twins.session()
    a0 = len(twins.t.audit.records())
    ts.sql("begin")
    assert [tuple(int(x) for x in r) for r in ts.sql(
        "select v from kv where k = 5").rows()] == [(38,)]
    ts.sql("commit")
    recs = [r for r in twins.t.audit.records()[a0:]
            if r.sql.startswith("select v from kv")]
    assert recs and all(not r.is_batched for r in recs)


def test_fast_tier_hammer_8_threads(twins):
    """8 threads hammer one FastEntry while another flushes the plan
    cache: every statement returns the right rows on the port."""
    db = twins.t
    nthreads, iters = 8, 40
    stop = threading.Event()
    errors: list = []

    def flusher() -> None:
        while not stop.is_set():
            db.plan_cache.flush()
            stop.wait(0.005)

    def worker(i: int) -> None:
        s = db.session()
        s.sql("set ob_batch_max_wait_us = 500")
        try:
            for j in range(iters):
                k = (i * 11 + j) % N_KEYS
                got = s.sql(f"select v from kv where k = {k}").rows()
                assert [tuple(int(x) for x in r) for r in got] == [
                    (k * 7 + 3,)], (i, j, k, got)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert
            errors.append(e)

    fl = threading.Thread(target=flusher)
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(nthreads)]
    fl.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    fl.join()
    assert not errors, errors
    st = db.plan_cache.stats
    assert st.fast_hits > 0 and st.fast_misses > 0


def test_fetch_head_pow2_compile_bound(twins):
    """A LIMIT k sweep over a device-resident result gives the JAX rows
    for every k, and a repeat sweep builds nothing new (the port's head
    fetch is K23, whose width needs no program per k)."""
    ts = twins.session()
    sweep = list(range(1, 13))
    ex = twins.t.engine.executor

    def run_sweep() -> None:
        for k in sweep:
            rows = ts.t.sql("select id, v from kv where v > 0").rows(limit=k)
            jrows = ts.j.sql("select id, v from kv where v > 0").rows(limit=k)
            assert len(rows) == min(k, N_KEYS)
            assert [tuple(int(x) for x in r) for r in rows] == [
                tuple(int(x) for x in r) for r in jrows]

    run_sweep()
    built = (ex.compiles, ex.narrow_compiles, ex.batched_compiles)
    run_sweep()
    assert (ex.compiles, ex.narrow_compiles, ex.batched_compiles) == built


# ---------------------------------------------------------------- wire e2e


def _wire_worker(port, user, password, keys, out, errors, barrier):
    from test_mysql_front import MiniMySqlClient

    try:
        c = MiniMySqlClient(port, user=user, password=password)
        c.query("set ob_batch_max_wait_us = 20000")
        barrier.wait()
        got = []
        for k in keys:
            _names, rows = c.query(f"select v from kv where k = {k}")
            got.append(rows)
        out.append(got)
        c.close()
    except Exception as e:  # pragma: no cover - surfaced by assert
        errors.append(e)


def test_mysql_front_concurrent_on_off_identical():
    """6 threaded wire connections give identical result sets with
    batching on and off, on both fronts, and the two fronts agree."""
    from oceanbase_tpu.server.mysql_front import MySqlFrontend as JFront
    from oceanbase_tpu_torch.server.mysql_front import (
        MySqlFrontend as TFront,
    )

    tw = _mk_twins()
    fronts = (JFront(tw.j).start(), TFront(tw.t).start())
    try:
        per_front = []
        for db, front in zip((tw.j, tw.t), fronts):
            legs = {}
            for batching in (True, False):
                db.batcher.enabled = batching
                nthreads = 6
                keys = [[(i * 7 + j) % N_KEYS for j in range(12)]
                        for i in range(nthreads)]
                outs = [[] for _ in range(nthreads)]
                errors: list = []
                barrier = threading.Barrier(nthreads)
                threads = [
                    threading.Thread(target=_wire_worker, args=(
                        front.port, "root", "", keys[i], outs[i], errors,
                        barrier))
                    for i in range(nthreads)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                assert not errors, errors
                legs[batching] = outs
                for i in range(nthreads):
                    for j, k in enumerate(keys[i]):
                        assert outs[i][0][j] == [(str(k * 7 + 3),)]
            assert legs[True] == legs[False]
            assert db.metrics.counter("stmt batched statements") > 0
            per_front.append(legs)
        assert per_front[0] == per_front[1]
    finally:
        for db in (tw.j, tw.t):
            db.batcher.enabled = True
        for f in fronts:
            f.stop()
        tw.close()


def test_mysql_front_revoke_bites_batched_entries():
    """REVOKE mid-stream: a revoked user's next hit on a warm batched
    entry fails with 1142 over the port's wire."""
    from oceanbase_tpu_torch.server.database import Database
    from oceanbase_tpu_torch.server.mysql_front import MySqlFrontend
    from test_mysql_front import MiniMySqlClient

    db = _fill(Database(n_nodes=1, n_ls=1, device="cpu"))
    root = db.session()
    root.sql("create user alice identified by 'pw'")
    root.sql("grant select on kv to alice")
    front = MySqlFrontend(db).start()
    try:
        clients = [MiniMySqlClient(front.port, user="alice", password="pw")
                   for _ in range(4)]
        barrier = threading.Barrier(5)
        phase2 = threading.Event()
        errors: list = []
        denied = [0] * 4

        def worker(i: int) -> None:
            c = clients[i]
            try:
                barrier.wait()
                for k in range(8):
                    _n, rows = c.query(f"select v from kv where k = {k}")
                    assert rows == [(str(k * 7 + 3),)]
                barrier.wait()
                phase2.wait()
                for k in range(8):
                    try:
                        c.query(f"select v from kv where k = {k}")
                    except RuntimeError as e:
                        assert "1142" in str(e), e
                        denied[i] += 1
            except Exception as e:  # noqa: BLE001 - surfaced by the assert
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        barrier.wait()
        barrier.wait()
        root.sql("revoke select on kv from alice")
        phase2.set()
        for t in threads:
            t.join()
        assert not errors, errors
        assert all(d == 8 for d in denied), denied
        for c in clients:
            c.close()
    finally:
        front.stop()
        db.close()


# ------------------------------------------------- vector lanes, solo replay


def test_vector_batched_lanes_identical_to_solo():
    """>= 4 concurrent vector statements coalesced into one batched
    dispatch (the embedding as a packed VECTOR slot) return the rows of
    their solo replays."""
    from test_torch_server import VD, _vec_db, _vtext

    db, x, _grp, rng = _vec_db(n=8000)
    try:
        s = db.session()
        for _ in range(3):
            s.sql(_vtext(rng.standard_normal(VD).astype(np.float32))).rows()
        qs = (x[rng.integers(0, len(x), 8)]
              + rng.normal(size=(8, VD)).astype(np.float32) * 0.05)
        sessions = [db.session() for _ in range(8)]
        out = [None] * 8
        coalesced = 0
        for _attempt in range(3):
            barrier = threading.Barrier(8)

            def run(i):
                barrier.wait()
                out[i] = sessions[i].sql(_vtext(qs[i])).rows()

            c0 = db.metrics.counters_snapshot()
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            c1 = db.metrics.counters_snapshot()
            coalesced = max(
                (int(name.rsplit(" ", 1)[1]) for name in c1
                 if name.startswith("stmt batch size ")
                 and c1[name] > c0.get(name, 0)), default=0)
            if coalesced >= 4:
                break
            db.result_cache.flush()
        assert coalesced >= 4, coalesced
        db.result_cache.flush()
        for i in range(8):
            assert out[i] == s.sql(_vtext(qs[i])).rows(), i
    finally:
        db.close()


# -------------------------------------------------- the packed parameter ABI


_SPEC_TEXTS = [
    "select v from kv where k = 7",
    "select id, v from kv where k > 3 and v < 200.5 and id between 2 and 40",
    "select sum(v * 2) from kv where k in (1, 2, 3) and v <> 17",
]


@pytest.mark.parametrize("text", _SPEC_TEXTS)
def test_pack_qparams_equals_jax(twins, text):
    """The same statement's slot spec and packed row are the JAX
    package's: the same (dtype, offset, width) per slot and the same
    int64 bits."""
    js = twins.j.session()
    ts = twins.t.session()
    js.sql(text).rows()
    ts.sql(text).rows()
    jentry, _ = twins.j.engine.cached_entry(text)
    tentry, _ = twins.t.engine.cached_entry(text)
    jspec = JX._collect_qparam_spec(jentry.prepared.plan)
    tspec = TX._collect_qparam_spec(tentry.prepared.plan)
    assert [(str(d), o, w) for d, o, w in jspec] == [
        (str(d), o, w) for d, o, w in tspec]
    assert JX.packed_width(jspec) == TX.packed_width(tspec)
    from oceanbase_tpu_torch.sql.planner import Planner  # noqa: F401

    vals = [7, 3.25, 19, -2, 40]
    vals = vals[:len(tspec)]
    dts = [d for d, _o, _w in tspec]
    jdts = [d for d, _o, _w in jspec]
    jrow = JX.pack_qparams(vals, jdts, jspec)
    trow = TX.pack_qparams(vals, dts, tspec)
    assert jrow.dtype == trow.dtype == np.int64
    assert np.array_equal(jrow, trow)


def test_pack_qparams_vector_and_int32_equal_jax():
    """VECTOR slots carry float32 components widened to float64 bits and
    an int32 slot is range-checked, as in the JAX package."""
    from oceanbase_tpu.core.dtypes import DataType as JD
    from oceanbase_tpu_torch.core.dtypes import DataType as TD

    jspec = [(JD.int32(), 0, 1), (JD.vector(3), 1, 3), (JD.float64(), 4, 1),
             (JD.decimal(12, 2), 5, 1), (JD.date(), 6, 1)]
    tspec = [(TD.int32(), 0, 1), (TD.vector(3), 1, 3), (TD.float64(), 4, 1),
             (TD.decimal(12, 2), 5, 1), (TD.date(), 6, 1)]
    vals = [-5, "[0.1, -2.5, 3e-8]", -0.0, 12.34, "1995-06-17"]
    j = JX.pack_qparams(vals, [d for d, _o, _w in jspec], jspec)
    t = TX.pack_qparams(vals, [d for d, _o, _w in tspec], tspec)
    assert np.array_equal(j, t)
    assert JX.packed_width(jspec) == TX.packed_width(tspec) == 7
    with pytest.raises((OverflowError, ValueError)):
        TX.pack_qparams([2 ** 31] + vals[1:],
                        [d for d, _o, _w in tspec], tspec)


def test_combo_run_two_cohorts_equal_solo():
    """_combo_run carries two plans' cohorts in one call and one fetch;
    every lane equals its plan's solo row."""
    from oceanbase_tpu_torch.server.database import Database

    db = _fill(Database(n_nodes=1, n_ls=1, device="cpu"))
    try:
        s = db.session()
        ta = "select v from kv where k = 4"
        tb = "select id from kv where v = 38"
        for text in (ta, tb):
            s.sql(text).rows()
        ea, _ = db.engine.cached_entry(ta)
        eb, _ = db.engine.cached_entry(tb)
        pa, pb = ea.prepared, eb.prepared
        assert pa.batchable and pb.batchable
        ka = [1, 9, 30]
        kb = [3, 10, 17, 24, 31]
        qa = np.stack([pa.bind([k], ea.dtypes) for k in ka])
        qb = np.stack([pb.bind([k * 7 + 3], eb.dtypes) for k in kb])
        res = TB._combo_run(pa, pb, qa, qb)
        assert res is not None
        (ha, hva, hsa, _sca, _dca), (hb, hvb, hsb, _scb, _dcb) = res
        assert hsa.shape[0] == 4 and hsb.shape[0] == 8  # pow2 buckets
        for i, k in enumerate(ka):
            col = next(iter(ha.values()))[i][hsa[i]]
            assert col.tolist() == [k * 7 + 3]
        for i, k in enumerate(kb):
            col = next(iter(hb.values()))[i][hsb[i]]
            assert col.tolist() == [k + 1]
        # and run_batched_host gives the same lanes as the combo
        hcols, _hv, hsel, _sc, _dc = pa.run_batched_host(qa)
        for i in range(len(ka)):
            assert np.array_equal(next(iter(hcols.values()))[i][hsel[i]],
                                  next(iter(ha.values()))[i][hsa[i]])
    finally:
        db.close()
