"""Out-of-core PX in the port against the JAX package, on the CPU (the
kernels' plain versions):

- twins of tests/test_chunked.py::test_px_chunked_streams_over_mesh: a
  PX statement over the device budget streams its biggest table through
  the SPMD run chunk by chunk (`_PxChunkSourceExecutor`), one counted
  host hop a chunk, with the single device's rows and the JAX mesh's;
- the PX chunk source's read of a window (`_chunk_narrow`, then
  `shard_put_chunk`: one `decode_chunk`, K18, a shard) on 1 and 2 `cpu`
  shards bit for bit against JAX's host-slice read (`_decode_chunk`) of
  the same window, and `decode_chunk` on hand-made narrowed planes:
  uint8/16/32 tiers, a padded last chunk, validity planes, a
  float column with -0.0 and NaN, and a chunk outside the frozen frame
  after the table grew (full width);
- a chunk whose capacity overflows retries once (the params generation
  rule) and lands on equal rows;
- the server: a PX statement over budget streams on PX, no fallback;
- K18's split launch: more than 32 planes decode as one group would.

The port's budget is per device (PxExecutor.budget_scale counts distinct
devices), and its 8 `cpu` shards share one device, so it gets the whole
BUDGET where the JAX PxExecutor, whose 8 virtual devices hold one shard
each, gets BUDGET // 8: both stream the same working set.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine import chunked as JC
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.parallel.mesh import make_mesh as j_make_mesh
from oceanbase_tpu.parallel.px import PxExecutor as JPx
from oceanbase_tpu.sql import parser as JP
from oceanbase_tpu.sql.planner import Planner as JPlanner
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.core.dtypes import DataType as TDT
from oceanbase_tpu_torch.core.dtypes import Schema as TSchema
from oceanbase_tpu_torch.core.table import Table as TTable
from oceanbase_tpu_torch.engine import chunked as TC
from oceanbase_tpu_torch.engine.executor import ROOT_COMPACT
from oceanbase_tpu_torch.engine.executor import Executor as TExecutor
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import QUERIES, UNIQUE_KEYS
from oceanbase_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from oceanbase_tpu_torch.parallel.px import PxExecutor as TPx
from oceanbase_tpu_torch.parallel.px import _PxChunkSourceExecutor
from oceanbase_tpu_torch.share.metrics import MetricsRegistry
from oceanbase_tpu_torch.sql import parser as TP
from oceanbase_tpu_torch.sql.planner import Planner as TPlanner
from torch_twins import TwinDatabase, px_rows, rows_equal

BUDGET = 1 << 20  # lineitem at sf=0.01 exceeds it; every other table fits
CHUNK = 1 << 14
NSH = 8


@pytest.fixture(scope="module")
def env():
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    return {"jt": jt, "tt": tt, "jplanner": JPlanner(jt),
            "tplanner": TPlanner(tt),
            "single": TExecutor(tt, unique_keys=UNIQUE_KEYS, device="cpu")}


def _px(env, metrics=None):
    return TPx(env["tt"], t_make_mesh(devices=["cpu"] * NSH),
               unique_keys=UNIQUE_KEYS, device_budget=BUDGET,
               chunk_rows=CHUNK, metrics=metrics)


@pytest.mark.parametrize("qid", [6, 1, 3])
def test_px_chunked_streams_over_mesh_twin(env, qid):
    sql = QUERIES[qid]
    tp = env["tplanner"].plan(TP.parse(sql))
    want = px_rows(env["single"].prepare(tp.plan).run(), tp.output_names)
    m = MetricsRegistry()
    prepared = _px(env, m).prepare(tp.plan)
    assert isinstance(prepared, TC.ChunkedPreparedPlan), f"Q{qid}"
    assert isinstance(prepared.chunk_exec, _PxChunkSourceExecutor)
    assert not prepared.chunk_exec.supports_staged
    got = px_rows(prepared.run(), tp.output_names)
    assert got == want, f"Q{qid} px-chunked vs the single device"
    chunks = prepared.stream_stats.chunks
    n = env["tt"]["lineitem"].nrows
    assert chunks == -(-n // prepared.chunk_rows) >= 3
    assert m.counters_snapshot().get("px dtl host hops", 0) == chunks
    assert prepared.chunk_exec.chunk_rows % (1024 * NSH) == 0
    jp = env["jplanner"].plan(JP.parse(sql))
    jpx = JPx(env["jt"], j_make_mesh(NSH), unique_keys=UNIQUE_KEYS,
              device_budget=BUDGET // NSH, chunk_rows=CHUNK)
    jprep = jpx.prepare(jp.plan)
    assert isinstance(jprep, JC.ChunkedPreparedPlan)
    rows_equal(px_rows(jprep.run(), jp.output_names), got,
               f"Q{qid} vs the JAX mesh")


def test_px_chunk_overflow_retries_once(env):
    """The chunk program's root compaction seeded at 4 rows a shard: the
    first overflow bumps the capacities (x4) and spends the one retry,
    the chunks already in flight re-run on the grown capacities for
    free, and the rows equal the single device's."""
    tp = env["tplanner"].plan(TP.parse(QUERIES[3]))
    want = px_rows(env["single"].prepare(tp.plan).run(), tp.output_names)
    cp = _px(env).prepare(tp.plan)
    assert isinstance(cp, TC.ChunkedPreparedPlan)
    cpp = cp.chunk_prepared
    cpp.params.join_cap[ROOT_COMPACT] = 4
    cpp.recompile()
    got = px_rows(cp.run(max_retries=3), tp.output_names)
    assert cp.retries == 1 and cpp.retries == 1
    assert got == want
    n = env["tt"]["lineitem"].nrows
    assert cp.stream_stats.chunks == -(-n // cp.chunk_rows)


# ------------------------------------------------------------ _decode_chunk

def _decode_tables(pkg, n, grow=False):
    DT, S, T = pkg
    rng = np.random.default_rng(11)
    a8 = rng.integers(1000, 1200, n).astype(np.int32)      # uint8 tier
    a16 = rng.integers(-5000, 40000, n).astype(np.int64)   # uint16 tier
    a32 = rng.integers(0, 3 * 10**9, n).astype(np.int64)   # uint32 tier
    wide = rng.integers(-(2**62), 2**62, n).astype(np.int64)  # full width
    f = rng.standard_normal(n)
    f[::7] = -0.0
    f[3::11] = np.nan
    b = rng.random(n) < 0.5
    nul = rng.integers(0, 100, n).astype(np.int32)
    if grow:
        # rows beyond the frozen frame: the INSERT's values fall outside
        # every narrowed tier
        a8[-3:] = 90_000
        a16[-3:] = -(2**40)
        a32[-3:] = 2**50
    schema = S.of(a8=DT.int32(), a16=DT.int64(), a32=DT.int64(),
                  wide=DT.int64(), f=DT.float64(), b=DT.bool_(),
                  nul=DT.int32(nullable=True))
    t = T("t", schema, {"a8": a8, "a16": a16, "a32": a32, "wide": wide,
                        "f": f, "b": b, "nul": nul},
          valid={"nul": rng.random(n) < 0.8})
    return {"t": t}


def _bits(x):
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return x.view(np.int64 if x.itemsize == 8 else np.int32)
    return x


def _same_batch(jb, tb, what):
    assert set(jb.cols) == set(tb.cols), what
    for c in jb.cols:
        j, t = np.asarray(jb.cols[c]), tb.cols[c].numpy()
        assert j.dtype == t.dtype, (what, c, j.dtype, t.dtype)
        assert np.array_equal(_bits(j), _bits(t)), (what, c)
    assert set(jb.valid) == set(tb.valid), what
    for c in jb.valid:
        assert np.array_equal(np.asarray(jb.valid[c]), tb.valid[c].numpy())
    assert np.array_equal(np.asarray(jb.sel), tb.sel.numpy()), what
    assert int(jb.nrows) == int(tb.nrows), what


def _px_chunk(tx, cols):
    """The PX chunk source's read of its current window (`_chunk_narrow`,
    then `shard_put_chunk`: one decode a shard), the shards' slices
    concatenated in mesh order."""
    raw = tx.table_batch("t", cols)

    def cat(part):
        return {c: torch.cat([r[part][c] for r in raw]) for c in raw[0][part]}

    sel = torch.cat([r["sel"] for r in raw])
    return SimpleNamespace(cols=cat("cols"), valid=cat("valid"), sel=sel,
                           nrows=sel.sum())


@pytest.mark.parametrize("nsh", [1, 2])
def test_decode_chunk_bit_for_bit(nsh):
    """The PX chunk source on `nsh` cpu shards against JAX's host-slice
    read (`_chunk_slice_batch`, one `_decode_chunk`) window for window."""
    n, cap = 10_000, 4096
    cols = ("a16", "a32", "a8", "b", "f", "nul", "wide")
    jcat = _decode_tables((JDT, JSchema, JTable), n)
    tcat = _decode_tables((TDT, TSchema, TTable), n)
    jx = JC._ChunkSourceExecutor(jcat, "t", cap)
    tx = _PxChunkSourceExecutor(tcat, "t", cap,
                                mesh=t_make_mesh(devices=["cpu"] * nsh))
    windows = [(0, 4096), (4096, 8192), (8192, n)]  # the last one padded
    for s, e in windows:
        jx.set_chunk(s, e)
        tx.set_chunk(s, e)
        _same_batch(jx._chunk_slice_batch("t", cols), _px_chunk(tx, cols),
                    (s, e))
    narrow, bases, count, _schema, _dicts = tx._chunk_narrow("t", cols)
    assert count == n - 8192
    assert narrow["a8"].dtype == np.uint8
    assert narrow["a16"].dtype == np.uint16
    assert narrow["a32"].dtype == np.uint32
    assert narrow["wide"].dtype == np.int64
    assert narrow["#v:nul"].dtype == np.uint8
    # the table grows under the cached tiers: its last chunk falls outside
    # the frozen frame and ships at full width, base 0
    jcat.update(_decode_tables((JDT, JSchema, JTable), n, grow=True))
    tcat.update(_decode_tables((TDT, TSchema, TTable), n, grow=True))
    jx.set_chunk(8192, n)
    tx.set_chunk(8192, n)
    _same_batch(jx._chunk_slice_batch("t", cols), _px_chunk(tx, cols),
                "outside the frame")
    narrow, bases, _count, _s, _d = tx._chunk_narrow("t", cols)
    assert narrow["a8"].dtype == np.int32 and int(bases["a8"]) == 0
    assert narrow["a32"].dtype == np.int64


def test_decode_chunk_direct_twin():
    """`decode_chunk` on hand-made narrowed planes, float -0.0 and NaN
    bits included (base +0.0 turns -0.0 into +0.0 in both)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    cap, count = 3000, 2500
    f = rng.standard_normal(cap).astype(np.float32)
    f[::5] = -0.0
    f[1::9] = np.nan
    narrow = {"x": rng.integers(0, 255, cap).astype(np.uint8),
              "y": rng.integers(0, 65535, cap).astype(np.uint16),
              "z": rng.integers(0, 2**32 - 1, cap).astype(np.uint32),
              "f": f, "#v:y": (rng.random(cap) < 0.5).astype(np.uint8)}
    bases = {"x": np.int16(-100), "y": np.int32(7), "z": np.int64(-(2**40)),
             "f": np.float32(0.0)}
    jd, jsel = JC._decode_chunk({k: jnp.asarray(v) for k, v in narrow.items()},
                                {k: jnp.asarray(v) for k, v in bases.items()},
                                count)
    td, tsel = TC.decode_chunk(
        {k: torch.from_numpy(v) for k, v in narrow.items()}, bases, count,
        "cpu")
    assert set(jd) == set(td)
    for k in jd:
        j, t = np.asarray(jd[k]), td[k].numpy()
        assert j.dtype == t.dtype, (k, j.dtype, t.dtype)
        assert np.array_equal(_bits(j), _bits(t)), k
    assert np.array_equal(np.asarray(jsel), tsel.numpy())
    assert not np.signbit(td["f"].numpy()[::5]).any()


def test_k18_split_launch_equals_one_group():
    """More than K18_MAX_COLS planes: decode_staged launches once per 32
    planes on the card; on the CPU the plain decode of 40 planes equals
    one decode per plane."""
    rng = np.random.default_rng(8)
    cap, count = 2048, 1900
    planes = 40
    staged, bases, meta, dtypes = {}, {}, [], {}
    for i in range(planes):
        k = f"c{i:02d}"
        staged[k] = torch.from_numpy(
            rng.integers(0, 65535, cap).astype(np.uint16))
        bases[k] = np.int64(i * 1000 - 7)
        meta.append((k, "for"))
        dtypes[k] = torch.int64
    assert len(meta) > K.K18_MAX_COLS
    out, sel = K.decode_staged(staged, bases, count, meta, cap, dtypes,
                               "cpu")
    for k, kind in meta:
        one, sel1 = K.decode_staged({k: staged[k]}, {k: bases[k]}, count,
                                    [(k, kind)], cap, dtypes, "cpu")
        assert torch.equal(out[k], one[k]), k
        assert torch.equal(sel, sel1)
    assert int(sel.sum()) == count


# ------------------------------------------------------------------ server

def test_px_statement_over_budget_streams_on_px(monkeypatch):
    """A Database on the CPU with a 2-shard mesh, `SET ob_px_dop = 2` and
    a PX budget that streams lineitem: Q6 and Q1 answer from the PX chunk
    source (host hops counted, no `px fallbacks`) with the JAX
    Database's rows and dop 0's."""
    from oceanbase_tpu_torch.parallel import mesh as t_mesh

    monkeypatch.setattr(t_mesh, "CPU_SHARDS", 2)
    jt = JD.generate(sf=0.01, seed=19920101)
    tt = TD.generate(sf=0.01, seed=19920101)
    d = TwinDatabase.build(jextra=jt, textra=tt, n_nodes=1, n_ls=1)
    try:
        for db in (d.j, d.t):
            db._unique_keys.update(UNIQUE_KEYS)
        s = d.session()
        s.sql("set ob_enable_result_cache = 0")
        serial = {q: s.sql(QUERIES[q]).rows() for q in (6, 1)}
        px = d.t._px_executor()
        assert px.nsh == 2
        px.device_budget = BUDGET
        s.sql("set ob_px_dop = 2")
        for q in (6, 1):
            assert s.sql(QUERIES[q]).rows() == serial[q]  # and JAX's
        assert d.t.metrics.counter("px fallbacks") == 0
        assert d.t.metrics.counter("px dtl host hops") > 0
        assert d.t._px_admission().used == 0
    finally:
        d.close()
