"""Out-of-core execution in the port against the JAX package: the twins of
tests/test_chunked.py and tests/test_stream_pipeline.py.

Over the same generated TPC-H tables at SF 0.01 (seed 19920101), a 1 MiB
device budget makes lineitem (~60k rows) stream through the plan in
16384-row chunks (>= 3 chunks, the last one padded) while every other
table stays resident, and a 48 KiB budget sends the lineitem-orders join
and a keyed group-by down the grace-hash route. The port's streamed rows
must equal its resident rows bit for bit (every statement sums scaled
int64 decimals) and the JAX package's streamed rows (floats to rel
1e-12); the A/B legs (prefetch off, raw wire) change nothing but timing.
The port's ChunkStager must freeze the same wire plans as the JAX stager
(kinds, bases, run capacities, the staged arrays and their bytes), and
K18's plain version must decode every row of a staged chunk to the same
bits as the JAX `_decode_staged`: FOR at uint8/16/32, RLE with padded
and with exactly full runs, bitmaps at a capacity that is not a multiple
of 8, raw int/bool/float64 (-0.0 and NaN included), full and padded
chunks. The governor's staged ledger must balance after a cancelled
prefetch and after a statement that fails mid-stream.
"""

import os

import jax
import numpy as np
import pytest
import torch

from oceanbase_tpu.core.column import batch_rows_storage as j_storage
from oceanbase_tpu.core.dtypes import DataType as JDataType
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine import pipeline as JP
from oceanbase_tpu.engine.executor import Executor as JExecutor
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.sql.parser import parse as jparse
from oceanbase_tpu.sql.planner import Planner as JPlanner
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.core.column import batch_rows_storage as t_storage
from oceanbase_tpu_torch.core.dtypes import DataType, Field, Schema
from oceanbase_tpu_torch.core.table import Table
from oceanbase_tpu_torch.engine import pipeline as TP
from oceanbase_tpu_torch.engine.chunked import ChunkedPreparedPlan
from oceanbase_tpu_torch.engine.executor import Executor
from oceanbase_tpu_torch.engine.memory_governor import (
    MemoryGovernor,
    derive_chunk_rows,
)
from oceanbase_tpu_torch.engine.session import Session
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import QUERIES, UNIQUE_KEYS
from oceanbase_tpu_torch.sql.parser import parse
from oceanbase_tpu_torch.sql.planner import Planner
from torch_twins import storage_equal

BUDGET = 1 << 20
CHUNK = 1 << 14
# small enough that BOTH join sides (lineitem AND orders) exceed it
GRACE_BUDGET = 48 << 10

GRACE_JOIN_SQL = """
    select o.o_orderpriority, sum(l.l_quantity) as qty, count(*) as cnt
    from lineitem l, orders o
    where l.l_orderkey = o.o_orderkey and l.l_quantity < 30
    group by o.o_orderpriority
    order by o.o_orderpriority
"""
GRACE_GROUPBY_SQL = """
    select l_orderkey, sum(l_quantity) as q,
           count(distinct l_linenumber) as dl
    from lineitem group by l_orderkey order by l_orderkey limit 7
"""


@pytest.fixture(scope="module")
def tables():
    return (JD.generate(sf=0.01, seed=19920101),
            TD.generate(sf=0.01, seed=19920101))


def _exec(tt, *, depth=2, compress=True, budget=BUDGET, governor=None):
    ex = Executor(tt, unique_keys=UNIQUE_KEYS, device="cpu",
                  device_budget=budget, chunk_rows=CHUNK)
    ex.stream_prefetch_depth = depth
    ex.stream_compress = compress
    ex.governor = governor
    return ex


def _run(ex, catalog, sql):
    pq = Planner(catalog).plan(parse(sql))
    prepared = ex.prepare(pq.plan)
    return prepared, t_storage(prepared.run(), pq.output_names)


def _resident(tt, sql):
    return _run(Executor(tt, unique_keys=UNIQUE_KEYS, device="cpu"), tt,
                sql)[1]


def _jax_rows(jt, sql, **kw):
    ex = JExecutor(jt, unique_keys=UNIQUE_KEYS, **kw)
    pq = JPlanner(jt).plan(jparse(sql))
    prepared = ex.prepare(pq.plan)
    return prepared, j_storage(prepared.run(), pq.output_names)


def _bits_equal(got: dict, want: dict, what: str):
    assert list(got) == list(want), what
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {c}"
        assert g.tobytes() == w.tobytes(), f"{what} {c}"


# ---------------------------------------------------------------------------
# streamed statements


@pytest.mark.parametrize("qid", [6, 1, 3, 5, 14])
def test_streamed_matches_resident_and_jax(tables, qid):
    jt, tt = tables
    sql = QUERIES[qid]
    gov = MemoryGovernor(budget=BUDGET)
    prepared, got = _run(_exec(tt, governor=gov), tt, sql)
    assert isinstance(prepared, ChunkedPreparedPlan), f"Q{qid} did not chunk"
    assert tt["lineitem"].nrows % prepared.chunk_rows != 0  # padded last
    _bits_equal(got, _resident(tt, sql), f"Q{qid} streamed vs resident")
    ss = prepared.stream_stats
    assert ss.chunks >= 3
    assert 0 < ss.staged_bytes <= ss.decoded_bytes
    assert gov.ledger_balanced() and gov.peak_staged > 0
    jprep, want = _jax_rows(jt, sql, device_budget=BUDGET, chunk_rows=CHUNK)
    assert type(jprep).__name__ == "ChunkedPreparedPlan"
    assert (jprep.kind, jprep.chunk_rows) == (prepared.kind,
                                              prepared.chunk_rows)
    storage_equal(want, got, f"Q{qid} port vs JAX streamed")


@pytest.mark.parametrize("depth,compress", [(0, True), (2, False), (0, False)])
def test_streamed_ab_legs_identical(tables, depth, compress):
    _jt, tt = tables
    sql = QUERIES[1]
    prepared, got = _run(_exec(tt, depth=depth, compress=compress), tt, sql)
    assert isinstance(prepared, ChunkedPreparedPlan)
    _bits_equal(got, _resident(tt, sql), "Q1 A/B leg")
    if depth == 0:
        # no prefetch thread: the wire and the compute strictly alternate
        assert prepared.stream_stats.overlap_s == 0.0


SPLITS = {
    "topn": ("""select l_orderkey from lineitem where l_quantity < 2
        order by l_orderkey limit 5""", 256 << 10),
    "distinct": ("select distinct l_shipmode from lineitem", 128 << 10),
    "passthrough": ("""select l_orderkey, l_quantity from lineitem
        where l_quantity < 3 and l_discount < 0.03
        order by l_orderkey, l_quantity""", 256 << 10),
    "join_rooted": ("""select o.o_orderpriority, l.l_quantity
        from lineitem l, orders o
        where l.l_orderkey = o.o_orderkey and l.l_quantity < 2
          and o.o_orderdate < date '1992-03-01'
        order by o.o_orderpriority, l.l_quantity""", 256 << 10),
    "scan": ("""select l_orderkey, l_quantity,
               row_number() over (partition by l_orderkey
                                  order by l_quantity, l_linenumber) as rn
        from lineitem where l_quantity < 2
        order by l_orderkey, rn""", 512 << 10),
    "agg": ("""select sum(l_extendedprice * l_discount) as revenue
        from lineitem where l_shipdate >= date '1998-08-01'""", BUDGET >> 2),
}
SPLIT_KIND = {"join_rooted": "passthrough"}


@pytest.mark.parametrize("name", list(SPLITS))
def test_stream_splits_match_resident(tables, name):
    """Each split kind, and chunks with no qualifying rows (the scalar
    aggregate over August 1998: most chunks contribute NULL partials)."""
    _jt, tt = tables
    sql, budget = SPLITS[name]
    prepared, got = _run(_exec(tt, budget=budget), tt, sql)
    assert isinstance(prepared, ChunkedPreparedPlan), name
    assert prepared.kind == SPLIT_KIND.get(name, name)
    _bits_equal(got, _resident(tt, sql), name)


def test_session_reports_stream_phases(tables):
    _jt, tt = tables
    sess = Session(tt, unique_keys=UNIQUE_KEYS, device="cpu")
    sess.executor.device_budget = BUDGET
    sess.executor.chunk_rows = CHUNK
    rs = sess.sql(QUERIES[6])
    assert rs.nrows == 1
    ph = sess.last_phases
    assert ph["stream_h2d_s"] > 0.0 and ph["stream_compute_s"] > 0.0
    assert 0.0 <= ph["stream_overlap_s"] <= ph["stream_h2d_s"]
    whole = Session(tt, unique_keys=UNIQUE_KEYS, device="cpu")
    assert rs.storage_columns() == whole.sql(QUERIES[6]).storage_columns()
    assert "stream_h2d_s" not in whole.last_phases


@pytest.mark.parametrize("budget,kind,sql,lits", [
    (BUDGET, ChunkedPreparedPlan,
     "select sum(l_extendedprice * l_discount) as revenue, count(*) as c "
     "from lineitem where l_quantity < {} and l_discount > {} "
     "and l_shipdate >= date '1994-01-01'", ((24, 0.02), (30, 0.05))),
    (GRACE_BUDGET, TP.GraceHashPreparedPlan,
     GRACE_JOIN_SQL.replace("< 30", "< {}"), ((30,), (25,))),
])
def test_out_of_core_statements_bind_one_packed_row(tables, monkeypatch,
                                                    budget, kind, sql, lits):
    """A streamed or grace-hash statement binds its literals as one
    packed int64 row over the whole statement, as a resident plan does:
    its chunk, partition and merge programs share that frame, no legacy
    tuple frame is packed, and a plan-cache hit with new literals returns
    the resident rows bit for bit."""
    from oceanbase_tpu_torch.expr import compile as xc

    def no_legacy(*_a):
        raise AssertionError("a legacy tuple frame was packed")

    _jt, tt = tables
    monkeypatch.setattr(xc, "_legacy_layout", no_legacy)
    sess = Session(tt, unique_keys=UNIQUE_KEYS, device="cpu")
    sess.executor.device_budget = budget
    sess.executor.chunk_rows = CHUNK
    whole = Session(tt, unique_keys=UNIQUE_KEYS, device="cpu")
    for vals in lits:
        text = sql.format(*vals)
        rs = sess.sql(text)
        _bits_equal(rs.storage_columns(), whole.sql(text).storage_columns(),
                    f"{kind.__name__} {vals}")
    assert rs.plan_cache_hit
    entry, qparams = sess.cached_entry(text)
    assert isinstance(entry.prepared, kind)
    assert isinstance(qparams, torch.Tensor) and qparams.dtype == torch.int64
    assert qparams.dim() == 1 and qparams.numel() >= len(lits[0])


# ---------------------------------------------------------------------------
# the stager's wire plans and K18's decode against the JAX package


def _twin_tables():
    """One table in each package with every wire-plan case: FOR at
    uint8/16/32, RLE, a dictionary column, raw float64 (-0.0 and NaN), a
    raw bool and a nullable column."""
    n = 5000
    rng = np.random.default_rng(7)
    flt = rng.standard_normal(n)
    flt[::97] = -0.0
    flt[5::131] = np.nan
    data = {
        "f8": rng.integers(0, 200, n) + 7_000_000_000,
        "f16": rng.integers(0, 60_000, n) - 5,
        "f32": rng.integers(0, 3_000_000_000, n) - 17,
        "runs": np.repeat(np.arange(n // 100, dtype=np.int64), 100),
        "mode": [("AIR", "RAIL", "SHIP")[i % 3] for i in range(n)],
        "flt": flt,
        "flag": rng.random(n) < 0.3,
        "nn": rng.integers(0, 50, n),
    }
    valid = rng.random(n) < 0.8
    out = []
    for tcls, scls, fcls, dcls in ((JTable, JSchema, JField, JDataType),
                                   (Table, Schema, Field, DataType)):
        schema = scls((
            fcls("f8", dcls.int64()), fcls("f16", dcls.int64()),
            fcls("f32", dcls.int64()), fcls("runs", dcls.int64()),
            fcls("mode", dcls.varchar()), fcls("flt", dcls.float64()),
            fcls("flag", dcls.bool_()),
            fcls("nn", dcls.int64().with_nullable(True)),
        ))
        t = tcls.from_pydict("wt", schema, data)
        t.valid["nn"] = valid.copy()
        out.append(t)
    return out


def _staged_equal(js, ts):
    assert set(js) == set(ts)
    for k in js:
        a, b = js[k], ts[k]
        if isinstance(a, tuple):
            assert isinstance(b, tuple)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _decode_both(jstager, tstager, s, e, cap):
    jst = jstager.stage(s, e)
    tst = tstager.stage(s, e)
    _staged_equal(jst[0], tst[0])
    assert jst[2] == tst[2]           # meta
    assert jst[3:] == tst[3:]         # wire and decoded bytes
    for k in jst[1]:
        assert jst[1][k] == tst[1][k] and jst[1][k].dtype == tst[1][k].dtype
    staged, bases, meta, _w, _d = tst
    jout, jsel = JP._decode_staged(jax.device_put(jst[0]), jst[1], e - s,
                                   meta=meta, cap=cap)
    tree, _buf, _ev = TP.Uploader("cpu").put(staged)
    tout, tsel = kernels.decode_staged_plain(
        tree, bases, e - s, meta, cap, tstager.dtypes, "cpu")
    assert np.array_equal(tsel.numpy(), np.asarray(jsel))
    assert set(tout) == set(jout)
    for k in jout:
        j, t = np.asarray(jout[k]), tout[k].numpy()
        assert j.dtype == t.dtype and j.shape == t.shape == (cap,), k
        assert j.tobytes() == t.tobytes(), k  # every row, bit for bit
    return meta


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("cap", [2048, 1021], ids=["cap2048", "cap1021"])
def test_stager_plans_and_k18_decode_match_jax(cap, compress):
    jt, tt = _twin_tables()
    cols = ("f8", "f16", "f32", "runs", "mode", "flt", "flag", "nn")
    jstager = JP.ChunkStager(jt, cols, cap, compress=compress)
    tstager = TP.ChunkStager(tt, cols, cap, compress=compress)
    n = tt.nrows
    for s in range(0, n, cap):  # the last window is padded
        meta = _decode_both(jstager, tstager, s, min(s + cap, n), cap)
    assert jstager._plan == tstager._plan
    kinds = dict(meta)
    if compress:
        assert kinds["runs"] == "rle"
        assert {k: tstager._plan[k][1] for k in ("f8", "f16", "f32")} == {
            "f8": np.uint8, "f16": np.uint16, "f32": np.uint32}
    assert kinds["#v:nn"] == "bits" and kinds["flt"] == "raw"
    assert kinds["flag"] == "raw"


def test_k18_rle_exactly_full_runs_and_dead_rows_match_jax():
    """RLE whose runs exactly fill the frozen run capacity, and a chunk
    whose padded runs (length 0) leave rows past the total: those read
    the last run value, as the reference's clip defines."""
    cap, run_cap = 256, 64
    rng = np.random.default_rng(3)
    lens_full = np.full(run_cap, cap // run_cap, np.int32)
    lens_pad = np.concatenate([rng.integers(1, 4, 40), np.zeros(24)]) \
        .astype(np.int32)
    for lens, count in ((lens_full, cap), (lens_pad, int(lens_pad.sum()))):
        vals = rng.integers(0, 60_000, run_cap).astype(np.uint16)
        staged = {"r": (vals, lens)}
        bases = {"r": np.int32(-123_456)}
        meta = (("r", "rle"),)
        jout, jsel = JP._decode_staged(jax.device_put(staged), bases, count,
                                       meta=meta, cap=cap)
        tree, _b, _e = TP.Uploader("cpu").put(staged)
        tout, tsel = kernels.decode_staged_plain(
            tree, bases, count, meta, cap, {"r": kernels.torch.int32}, "cpu")
        assert np.asarray(jout["r"]).tobytes() == tout["r"].numpy().tobytes()
        assert np.array_equal(np.asarray(jsel), tsel.numpy())


def test_frame_violating_chunk_degrades_to_raw():
    """A chunk outside the frozen FOR frame (data changed under a cached
    plan) ships raw for that chunk -- still exact, as in the reference."""
    n, cap = 1000, 512
    base = np.arange(n, dtype=np.int64) + 100
    t = Table.from_pydict("ft", Schema((Field("k", DataType.int64()),)),
                          {"k": base})
    stager = TP.ChunkStager(t, ("k",), cap, compress=True)
    stager.stage(0, cap)  # freeze the frame from the original data
    t.data["k"] = base - 5000  # every value now below the frozen min
    staged, bases, meta, wire, dec = stager.stage(0, cap)
    assert dict(meta)["k"] == "raw"
    item = TP.StagedChunk((0, cap), TP.Uploader("cpu").put(staged)[0], bases,
                          meta, cap, wire, dec, None)
    got = stager.decode_batch(item).cols["k"].numpy()[:cap]
    np.testing.assert_array_equal(got, t.data["k"][:cap])


# ---------------------------------------------------------------------------
# governor ledger hygiene on error and cancel paths


def test_prefetch_cancel_releases_staged_ledger(tables):
    _jt, tt = tables
    gov = MemoryGovernor(budget=BUDGET)
    t = tt["lineitem"]
    stager = TP.ChunkStager(t, ("l_quantity", "l_discount"), CHUNK)
    windows = [(s, min(s + CHUNK, t.nrows))
               for s in range(0, t.nrows, CHUNK)]
    pf = TP.ChunkPrefetcher(stager, windows, depth=2,
                            meter=TP.OverlapMeter(), governor=gov)
    item = pf.get()  # consume ONE chunk, leave the rest in flight
    assert item is not None and gov.staged >= item.wire_bytes
    pf.close()  # cancelled mid-stream: undelivered leases drain here
    item.release()
    assert gov.ledger_balanced(), gov.stats()
    assert gov.peak_staged > 0


def test_statement_error_mid_stream_balances_ledger(tables):
    _jt, tt = tables
    gov = MemoryGovernor(budget=BUDGET)
    ex = _exec(tt, governor=gov)
    pq = Planner(tt).plan(parse(QUERIES[6]))
    cp = ex.prepare(pq.plan)
    assert isinstance(cp, ChunkedPreparedPlan)
    calls = {"n": 0}
    real = cp.chunk_prepared.program

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected mid-stream failure")
        return real(*a, **kw)

    cp.chunk_prepared.program = boom
    with pytest.raises(RuntimeError, match="injected"):
        cp.run()
    assert gov.ledger_balanced(), gov.stats()
    # the plan recovers once the fault clears
    cp.chunk_prepared.program = real
    got = t_storage(cp.run(), pq.output_names)
    _bits_equal(got, _resident(tt, QUERIES[6]), "Q6 after the fault")
    assert gov.ledger_balanced()


def test_interrupt_between_chunks_balances_ledger(tables):
    """A statement killed mid-stream stops at the next chunk checkpoint,
    with every staged lease released; the host-tax ledger installed for
    the statement's thread records its h2d wall and device compute."""
    from oceanbase_tpu_torch.share import gap_ledger, interrupt

    _jt, tt = tables
    gov = MemoryGovernor(budget=BUDGET)
    cp = _exec(tt, governor=gov).prepare(
        Planner(tt).plan(parse(QUERIES[6])).plan)
    checker = interrupt.InterruptChecker("q6")
    real = cp.chunk_prepared.program

    def kill_after_first(*a, **kw):
        checker.interrupt("KILL QUERY")
        return real(*a, **kw)

    cp.chunk_prepared.program = kill_after_first
    prev = interrupt.set_current(checker)
    try:
        with pytest.raises(interrupt.QueryInterrupted, match="KILL QUERY"):
            cp.run()
    finally:
        interrupt.set_current(prev)
    assert gov.ledger_balanced(), gov.stats()
    cp.chunk_prepared.program = real
    led = gap_ledger.GapLedger()
    gap_ledger.set_current(led)
    try:
        cp.run()
    finally:
        gap_ledger.set_current(None)
    assert led.device_s > 0.0 and "h2d" in led.phases
    assert gov.ledger_balanced()


def test_spill_segments_round_trip_and_reject_corruption():
    from oceanbase_tpu_torch.storage.integrity import CorruptBlock
    from oceanbase_tpu_torch.storage.tmp_file import TmpFileManager

    seg = {"k": np.arange(1000, dtype=np.int64),
           "#v:k": np.arange(1000) % 3 > 0}
    with TmpFileManager() as tmp:
        path = tmp.write_segment(seg)
        back = tmp.read_segment(path)
        assert set(back) == set(seg)
        for k in seg:
            np.testing.assert_array_equal(back[k], seg[k])
        with open(path, "r+b") as f:
            f.seek(100)
            b = f.read(1)
            f.seek(100)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(CorruptBlock, match="crc mismatch"):
            tmp.read_segment(path)
        assert not os.path.exists(path)  # never read again
        root = tmp.root
    assert not os.path.exists(root)


def test_chunk_out_of_retries_balances_ledger(tables):
    """A chunk whose join capacity overflows past the retry budget raises,
    and its staged lease is released with the rest. (The reference's
    run_stream raises before releasing that chunk's lease: on this input
    its governor is left holding the chunk's wire bytes.)"""
    _jt, tt = tables
    sql = """select ps_suppkey, sum(l_quantity) as q from lineitem, partsupp
        where l_partkey = ps_partkey and l_quantity < 3
        group by ps_suppkey"""
    gov = MemoryGovernor(budget=256 << 10)
    cp = _exec(tt, budget=256 << 10, governor=gov).prepare(
        Planner(tt).plan(parse(sql)).plan)
    assert isinstance(cp, ChunkedPreparedPlan)
    params = cp.chunk_prepared.params
    caps = [nid for nid in params.join_cap if nid >= 0]
    assert caps
    for nid in caps:
        params.join_cap[nid] = 64
    cp.chunk_prepared.recompile()
    with pytest.raises(RuntimeError, match="overflow after 0 retries"):
        cp.run(max_retries=0)
    assert gov.ledger_balanced(), gov.stats()
    # with retries the grown capacities reach the resident rows
    got = t_storage(cp.run(), Planner(tt).plan(parse(sql)).output_names)
    _bits_equal(got, _resident(tt, sql), "out-of-retries rerun")
    assert gov.ledger_balanced()


def test_derive_chunk_rows_uses_decoded_width(tables):
    _jt, tt = tables
    assert derive_chunk_rows(1 << 20, 1 << 20, row_bytes=16) \
        == 4 * derive_chunk_rows(1 << 20, 1 << 20, row_bytes=64)
    assert derive_chunk_rows(1 << 20, 1 << 14) == 1 << 13
    assert derive_chunk_rows(1, 1 << 14, row_bytes=128) == 4096
    t = tt["lineitem"]
    cols = ("l_quantity", "l_discount", "l_extendedprice")
    assert TP.decoded_row_bytes(tt, "lineitem", cols) == sum(
        t.schema[c].storage_np.itemsize for c in cols)


# ---------------------------------------------------------------------------
# grace-hash partitioned spill


def test_grace_hash_join_matches_resident_and_jax(tables):
    jt, tt = tables
    gov = MemoryGovernor(budget=GRACE_BUDGET)
    prepared, got = _run(_exec(tt, budget=GRACE_BUDGET, governor=gov), tt,
                         GRACE_JOIN_SQL)
    assert isinstance(prepared, TP.GraceHashPreparedPlan), type(prepared)
    assert prepared.mode == "join" and prepared.n_parts >= 2
    _bits_equal(got, _resident(tt, GRACE_JOIN_SQL), "grace join")
    assert prepared.stream_stats.spill_partitions >= prepared.n_parts
    assert gov.ledger_balanced()
    jprep, want = _jax_rows(jt, GRACE_JOIN_SQL, device_budget=GRACE_BUDGET,
                            chunk_rows=CHUNK)
    assert jprep.n_parts == prepared.n_parts
    storage_equal(want, got, "grace join port vs JAX")


def test_grace_hash_groupby_matches_resident_and_jax(tables):
    jt, tt = tables
    ex = _exec(tt, budget=GRACE_BUDGET)
    pq = Planner(tt).plan(parse(GRACE_GROUPBY_SQL))
    gp = TP.try_grace_hash(ex, pq.plan, GRACE_BUDGET)
    assert gp.mode == "groupby"
    got = t_storage(gp.run(), pq.output_names)
    _bits_equal(got, _resident(tt, GRACE_GROUPBY_SQL), "grace group-by")
    jex = JExecutor(jt, unique_keys=UNIQUE_KEYS, device_budget=GRACE_BUDGET,
                    chunk_rows=CHUNK)
    jpq = JPlanner(jt).plan(jparse(GRACE_GROUPBY_SQL))
    jgp = JP.try_grace_hash(jex, jpq.plan, GRACE_BUDGET)
    assert jgp.n_parts == gp.n_parts
    storage_equal(j_storage(jgp.run(), jpq.output_names), got,
                  "grace group-by port vs JAX")


def test_grace_hash_rejects_unpartitionable(tables):
    _jt, tt = tables
    pq = Planner(tt).plan(parse("select sum(l_quantity) as q from lineitem"))
    with pytest.raises(TP.NotPartitionable):
        TP.try_grace_hash(_exec(tt, budget=GRACE_BUDGET), pq.plan,
                          GRACE_BUDGET)


def test_grace_hash_repeated_runs(tables):
    """The partition program and the merge program are reused across
    runs: the second run gives the same answer."""
    _jt, tt = tables
    want = _resident(tt, GRACE_JOIN_SQL)
    pq = Planner(tt).plan(parse(GRACE_JOIN_SQL))
    gp = _exec(tt, budget=GRACE_BUDGET).prepare(pq.plan)
    assert isinstance(gp, TP.GraceHashPreparedPlan)
    for _ in range(2):
        _bits_equal(t_storage(gp.run(), pq.output_names), want, "grace rerun")
