"""The port's mesh-SPMD subsystem against the JAX package's: twins of 10
of the 12 tests of tests/test_mesh_spmd.py and of the 5 of
tests/test_exchange_methods.py, the port on `cpu` shards (one thread a
shard), JAX on its 8 virtual CPU devices.

Two test_mesh_spmd cases wait:
- test_shard_map_shim_tracks_pinned_jax: the shard_map version shim is
  JAX-only; the port runs its shards eagerly and has no shim;
- test_artifact_mesh_shape_mismatch_recompiles: needs PlanArtifactStore,
  not ported yet.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.parallel import exchange as JX
from oceanbase_tpu.parallel.mesh import SHARD_AXIS
from oceanbase_tpu.parallel.mesh import make_mesh as j_make_mesh
from oceanbase_tpu.parallel.mesh import shard_map_compat
from oceanbase_tpu.parallel.px import PxExecutor as JPx
from oceanbase_tpu.share.metrics import MetricsRegistry as JMetrics
from oceanbase_tpu.sql import parser as JP
from oceanbase_tpu.sql.planner import Planner as JPlanner
from oceanbase_tpu_torch.core.dtypes import DataType as TDT
from oceanbase_tpu_torch.core.dtypes import Schema as TSchema
from oceanbase_tpu_torch.core.table import Table as TTable
from oceanbase_tpu_torch.engine.executor import Executor as TExecutor
from oceanbase_tpu_torch.engine.memory_governor import MemoryGovernor
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import QUERIES, UNIQUE_KEYS
from oceanbase_tpu_torch.parallel import exchange as TX
from oceanbase_tpu_torch.parallel.group import current, run_spmd
from oceanbase_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from oceanbase_tpu_torch.parallel.mesh import mesh_signature
from oceanbase_tpu_torch.parallel.px import PxExecutor as TPx
from oceanbase_tpu_torch.parallel.spmd import KIND_COLLECTIVE, SpmdLowering
from oceanbase_tpu_torch.share.metrics import MetricsRegistry
from oceanbase_tpu_torch.sql import parser as TP
from oceanbase_tpu_torch.sql.planner import Planner as TPlanner
from torch_twins import px_rows, rows_equal

NSH = 8
JOIN_SQL = ("select l.l_returnflag as rf, count(*) as c, "
            "sum(l.l_extendedprice) as s "
            "from lineitem l, orders o where l.l_orderkey = o.o_orderkey "
            "and o.o_totalprice > 1000 group by rf order by rf")


def _cpu_mesh(n=NSH):
    return t_make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def env():
    jt = JD.generate(sf=0.005, seed=19920101)
    tt = TD.generate(sf=0.005, seed=19920101)
    return {
        "jt": jt, "tt": tt,
        "jplanner": JPlanner(jt), "tplanner": TPlanner(tt),
        "single": TExecutor(tt, unique_keys=UNIQUE_KEYS, device="cpu"),
        "px": TPx(tt, _cpu_mesh(), unique_keys=UNIQUE_KEYS),
        "px1": TPx(tt, _cpu_mesh(1), unique_keys=UNIQUE_KEYS),
        "jpx": JPx(jt, j_make_mesh(NSH), unique_keys=UNIQUE_KEYS),
    }


def _rows(ex, planned):
    return px_rows(ex.execute(planned.plan), planned.output_names)


def _both(env, sql):
    return (env["tplanner"].plan(TP.parse(sql)),
            env["jplanner"].plan(JP.parse(sql)))


# --------------------------------------------------------- bit-identity

@pytest.mark.parametrize("qid", [1, 6, 3])
def test_mesh_bit_identity_tpch(env, qid):
    """8-shard mesh == 1-shard mesh == single device, bit for bit, and
    equal to the JAX mesh's rows."""
    tp, jp = _both(env, QUERIES[qid])
    want = _rows(env["single"], tp)
    assert _rows(env["px"], tp) == want
    assert _rows(env["px1"], tp) == want
    rows_equal(_rows(env["jpx"], jp), want, f"Q{qid} vs JAX mesh")
    assert len(want) > 0


def test_mesh_bit_identity_join(env):
    """lineitem join orders group-by: repartition + broadcast exchanges."""
    tp, jp = _both(env, JOIN_SQL)
    want = _rows(env["single"], tp)
    assert _rows(env["px"], tp) == want
    assert _rows(env["px1"], tp) == want
    rows_equal(_rows(env["jpx"], jp), want, "join vs JAX mesh")
    assert len(want) > 0


def _zipf_tables(pkg, n_fact, hi, seed=23, zipf=True):
    DT, S, T = pkg
    rng = np.random.default_rng(seed)
    if zipf:
        fk = np.minimum(rng.zipf(1.3, n_fact) - 1, hi).astype(np.int64)
    else:
        fk = np.where(rng.random(n_fact) < 0.6, 7,
                      rng.integers(0, hi, n_fact))
    fact = T.from_pydict(
        "fact", S.of(fk=DT.int64(), v=DT.int64()),
        {"fk": fk, "v": rng.integers(0, 100, n_fact)})
    nd = hi + 1 if zipf else hi
    dim = T.from_pydict(
        "dim", S.of(dk=DT.int64(), w=DT.int64()),
        {"dk": np.arange(nd), "w": np.arange(nd) * 3})
    return {"fact": fact, "dim": dim}


ZIPF_SQL = ("select sum(f.v + d.w) as s, count(*) as c "
            "from fact f, dim d where f.fk = d.dk")


def test_zipf_join_hot_key_broadcast_bit_identity():
    """Zipfian probe side: the hybrid exchange broadcasts the hot keys and
    merges the skew histogram over the shards, and stays bit-identical
    to the single device and to the JAX mesh."""
    tt = _zipf_tables((TDT, TSchema, TTable), NSH * 4096, 20_000)
    jt = _zipf_tables((JDT, JSchema, JTable), NSH * 4096, 20_000)
    uk = {"dim": ("dk",)}
    tp = TPlanner(tt).plan(TP.parse(ZIPF_SQL))
    jp = JPlanner(jt).plan(JP.parse(ZIPF_SQL))
    want = _rows(TExecutor(tt, unique_keys=uk, device="cpu"), tp)
    px = TPx(tt, _cpu_mesh(), unique_keys=uk, broadcast_threshold=1,
             hybrid_hash=True)
    prepared = px.prepare(tp.plan)
    got = px_rows(prepared.run(), tp.output_names)
    assert got == want
    jpx = JPx(jt, j_make_mesh(NSH), unique_keys=uk, broadcast_threshold=1,
              hybrid_hash=True)
    assert px_rows(jpx.execute(jp.plan), jp.output_names) == want
    kinds = {e.kind for e in prepared.mesh_plan.exchanges}
    assert {"skew_histogram", "broadcast", "repartition"} <= kinds


def test_ring_broadcast_impl_bit_identity(env):
    """The ring broadcast is a drop-in for the all_gather: same rows, the
    ppermute collective in the mesh plan."""
    px_ring = TPx(env["tt"], _cpu_mesh(), unique_keys=UNIQUE_KEYS,
                  broadcast_impl="ring")
    tp, _jp = _both(env, QUERIES[3])
    prepared = px_ring.prepare(tp.plan)
    got = px_rows(prepared.run(), tp.output_names)
    assert got == _rows(env["single"], tp)
    colls = {e.collective for e in prepared.mesh_plan.exchanges
             if e.kind == "broadcast"}
    assert colls == {"ppermute"}


# ------------------------------------------------- mesh-plan representation

def test_mesh_plan_records_collectives(env):
    """The first run's exchanges land in PreparedPlan.mesh_plan with
    collective names, bytes and lane capacities, exactly the JAX trace's
    layout; the triple log agrees; a re-run records nothing more."""
    tp, jp = _both(env, QUERIES[3])
    prepared = env["px"].prepare(tp.plan)
    assert prepared.mesh_plan.total_ops == 0  # recorded by the first run
    prepared.run()
    mp = prepared.mesh_plan
    assert mp.mesh_sig == mesh_signature(env["px"].mesh)
    assert mp.n_shards == NSH
    assert mp.total_ops == len(mp.exchanges) > 0
    assert mp.total_bytes > 0
    assert mp.host_hops == 0
    for e in mp.exchanges:
        assert e.collective == KIND_COLLECTIVE.get(e.kind, e.collective)
        assert e.lanes > 0 and e.lane_cap > 0 and e.nbytes > 0
    parts = dict(p.split(":") for p in mp.describe().split(","))
    assert sum(int(v) for v in parts.values()) == mp.total_ops
    assert mp.ops_by_collective() == {k: int(v) for k, v in parts.items()}
    want_legacy = [(e.kind, e.ncols, e.lane_cap) for e in mp.exchanges
                   if e.kind in ("broadcast", "repartition")]
    assert list(prepared.px_exchanges) == want_legacy
    # the reference's traced layout, exchange by exchange
    jprep = env["jpx"].prepare(jp.plan)
    jprep.run()
    assert mp.exchanges == [
        type(mp.exchanges[0])(**vars(e)) for e in jprep.mesh_plan.exchanges]
    n_ops = mp.total_ops
    prepared.run()
    assert mp.total_ops == n_ops


def test_collective_counters_fold_into_metrics(env):
    m = MetricsRegistry()
    px = TPx(env["tt"], _cpu_mesh(), unique_keys=UNIQUE_KEYS, metrics=m)
    tp, _jp = _both(env, QUERIES[6])
    px.execute(tp.plan)
    snap = m.counters_snapshot()
    assert snap.get("px collective psum", 0) >= 1
    assert snap.get("px collective bytes", 0) > 0
    assert snap.get("px sharded upload bytes", 0) > 0
    assert snap.get("px dtl host hops", 0) == 0


def test_streamed_chunks_are_the_only_host_hops(env):
    """Out-of-core PX (a device budget that streams lineitem) pays one
    counted host hop per chunk dispatch, and its rows equal the single
    device's and the JAX mesh's; the resident run above counted none.
    The port's budget is per device and its 8 shards share one, so it
    gets 8 x the 32 KiB the JAX executor multiplies by its 8 devices."""
    m = MetricsRegistry()
    px = TPx(env["tt"], _cpu_mesh(), unique_keys=UNIQUE_KEYS, metrics=m,
             device_budget=NSH * (32 << 10), chunk_rows=1 << 13)
    tp, jp = _both(env, QUERIES[6])
    prepared = px.prepare(tp.plan)
    got = px_rows(prepared.run(), tp.output_names)
    assert got == _rows(env["single"], tp)
    n_chunks = -(-env["tt"]["lineitem"].nrows // prepared.chunk_rows)
    assert n_chunks >= 2
    assert prepared.stream_stats.chunks == n_chunks
    assert m.counters_snapshot().get("px dtl host hops", 0) == n_chunks
    jm = JMetrics()
    jpx = JPx(env["jt"], j_make_mesh(NSH), unique_keys=UNIQUE_KEYS,
              metrics=jm, device_budget=32 << 10, chunk_rows=1 << 13)
    rows_equal(px_rows(jpx.execute(jp.plan), jp.output_names), got,
               "Q6 streamed vs JAX mesh")
    assert jm.counters_snapshot().get("px dtl host hops", 0) >= n_chunks


def test_mesh_signature_identifies_geometry():
    sig8 = mesh_signature(_cpu_mesh())
    sig1 = mesh_signature(_cpu_mesh(1))
    assert sig8 == ((NSH,), ("shard",))
    assert sig1 == ((1,), ("shard",))
    assert sig8 != sig1
    with pytest.raises(ValueError, match="silently shrinking"):
        t_make_mesh(9, devices=["cpu"] * NSH)


# --------------------------------------------- residency + governor

def test_sharded_residency_charges_governor_per_device(env):
    """Row sharding leaves each device its shards' share of a table: the
    8 `cpu` shards share one device, which holds all of it, and the
    governor sees that sum (a mesh of one shard per device would charge
    total / 8 to each)."""
    px = TPx(env["tt"], _cpu_mesh(), unique_keys=UNIQUE_KEYS)
    tp, _jp = _both(env, QUERIES[6])
    px.execute(tp.plan)
    total = px.residency.total_bytes()
    assert total > 0
    assert px.residency.per_device_bytes() == total
    assert "lineitem" in px.residency.tables()

    gov = MemoryGovernor(budget=64 << 20)
    gov.register_sharded_residency(px.residency.per_device_bytes)
    gov.register_sharded_residency(px.residency.per_device_bytes)  # idempotent
    assert gov.sharded_resident_bytes() == px.residency.per_device_bytes()
    assert gov.remaining() == gov.budget - px.residency.per_device_bytes()
    assert gov.stats()["sharded_resident"] == px.residency.per_device_bytes()
    r = gov.reserve("t", gov.budget - (1 << 10), timeout_s=0.1)
    assert r is not None
    r.release()

    px.invalidate_table("lineitem")
    assert "lineitem" not in px.residency.tables()
    assert px.residency.total_bytes() < total


# ----------------------------------------------------------- spmd units

def test_spmd_lowering_reset_guards_retrace():
    low = SpmdLowering(((8,), ("shard",)), 8)
    low.note("broadcast", 3, 1024, 8)
    low.note("merge", 2, 64, 8, collective="psum", legacy=False)
    assert low.plan.total_ops == 2
    assert low.legacy_log == [("broadcast", 3, 1024)]
    low.reset()  # a re-recording replays every note
    assert low.plan.total_ops == 0 and low.legacy_log == []
    low.note("repartition", 2, 512, 64)
    assert low.plan.describe() == "all_to_all:1"
    assert low.plan.total_bytes == 2 * 512 * 64 * 8


# ------------------------------------------- tests/test_exchange_methods.py

def _jrun(fn, arrays, out_specs):
    f = jax.jit(shard_map_compat(
        fn, mesh=j_make_mesh(NSH),
        in_specs=tuple(P(SHARD_AXIS) for _ in arrays),
        out_specs=out_specs, check_replication=False))
    return jax.tree_util.tree_map(
        np.asarray, f(*[jnp.asarray(a) for a in arrays]))


def _trun(fn, arrays):
    parts = [np.split(np.asarray(a), NSH) for a in arrays]
    res = run_spmd(_cpu_mesh(), lambda i: fn(
        *[torch.from_numpy(p[i].copy()) for p in parts]))
    return [[t.numpy() if isinstance(t, torch.Tensor) else t for t in r]
            for r in res]


def test_range_repartition_balances_and_orders():
    rng = np.random.default_rng(3)
    n = NSH * 2048
    keys = rng.integers(0, 1_000_000, n).astype(np.int64)
    mask = rng.random(n) < 0.9
    cap = 2048

    def tstep(k, m):
        bounds = TX.sample_range_bounds(k, m, NSH)
        dest = TX.dest_by_range(k, bounds)
        out, nm, ovf = TX.repartition({"k": k}, m, dest, NSH, cap)
        sid = current().shard
        big = np.iinfo(np.int64).max
        lo = -big - 1 if sid == 0 else int(bounds[sid - 1])
        hi = big if sid == NSH - 1 else int(bounds[sid])
        kk = out["k"][nm]
        ok = bool(((kk >= lo) & (kk < hi)).all())
        return out["k"], nm, ovf, ok, bounds

    res = _trun(tstep, [keys, mask])

    def jstep(k, m):
        return JX.sample_range_bounds(k, m, NSH)

    jb = _jrun(jstep, [keys, mask], P())
    got = []
    counts = []
    for k_out, m_out, ovf, ok, bounds in res:
        assert int(ovf) == 0 and ok
        assert np.array_equal(bounds, jb)
        got.append(k_out[m_out])
        counts.append(int(m_out.sum()))
    want = np.sort(keys[mask])
    assert np.array_equal(np.sort(np.concatenate(got)), want)
    assert max(counts) < int(want.size / NSH * 1.3)  # balanced within 30%


def test_bc2host_stripes_hosts():
    n = NSH * 256
    vals = np.arange(n, dtype=np.int64)
    mask = np.ones(n, bool)
    per_host = 4  # 8 shards = 2 hosts of 4

    def tstep(v, m):
        out, nm = TX.bc2host({"v": v}, m, per_host)
        return out["v"], nm

    res = _trun(tstep, [vals, mask])
    for h in range(2):
        rows = np.concatenate([
            res[s][0][res[s][1]]
            for s in range(h * per_host, (h + 1) * per_host)])
        assert np.array_equal(np.sort(rows), vals)
    s0 = set(res[0][0][res[0][1]].tolist())
    s1 = set(res[1][0][res[1][1]].tolist())
    assert not (s0 & s1)


def test_dest_by_partition_affine():
    n = NSH * 128
    part = np.random.default_rng(0).integers(0, 16, n)
    owner = np.arange(16) % NSH

    def tstep(p, m):
        dest = TX.dest_by_partition(p, torch.from_numpy(owner))
        out, nm, ovf = TX.repartition({"p": p}, m, dest, NSH, 1024)
        sid = current().shard
        ok = bool((torch.from_numpy(owner)[out["p"][nm]] == sid).all())
        return ok, ovf

    def jstep(p, m):
        dest = JX.dest_by_partition(p, jnp.asarray(owner))
        out, nm, ovf = JX.repartition({"p": p}, m, dest, NSH, 1024)
        sid = lax.axis_index(SHARD_AXIS)
        return jnp.all(jnp.where(nm, jnp.asarray(owner)[out["p"]] == sid,
                                 True))[None], ovf

    jok, jovf = _jrun(jstep, [part, np.ones(n, bool)], (P(SHARD_AXIS), P()))
    assert bool(np.all(jok)) and int(jovf) == 0
    for ok, ovf in _trun(tstep, [part, np.ones(n, bool)]):
        assert ok and int(ovf) == 0


def test_hybrid_hash_join_handles_skew():
    """A 60%-one-key probe side overflows plain hash lanes at a cap the
    hybrid method handles, and the hybrid result equals the single
    device's and the JAX mesh's."""
    tt = _zipf_tables((TDT, TSchema, TTable), NSH * 4096, 50_000, seed=11,
                      zipf=False)
    jt = _zipf_tables((JDT, JSchema, JTable), NSH * 4096, 50_000, seed=11,
                      zipf=False)
    uk = {"dim": ("dk",)}
    tp = TPlanner(tt).plan(TP.parse(ZIPF_SQL))
    jp = JPlanner(jt).plan(JP.parse(ZIPF_SQL))
    want = _rows(TExecutor(tt, unique_keys=uk, device="cpu"), tp)
    # hybrid succeeds with no lane-cap bump: max_retries=0
    px_h = TPx(tt, _cpu_mesh(), unique_keys=uk, broadcast_threshold=1,
               hybrid_hash=True)
    got = px_rows(px_h.prepare(tp.plan).run(max_retries=0), tp.output_names)
    assert got == want
    jpx = JPx(jt, j_make_mesh(NSH), unique_keys=uk, broadcast_threshold=1,
              hybrid_hash=True)
    assert px_rows(jpx.prepare(jp.plan).run(max_retries=0),
                   jp.output_names) == want
    # plain hash at the same seeded caps overflows on the hot key
    px_p = TPx(tt, _cpu_mesh(), unique_keys=uk, broadcast_threshold=1,
               hybrid_hash=False)
    with pytest.raises(RuntimeError, match="overflow"):
        px_p.prepare(tp.plan).run(max_retries=0)


def test_hybrid_hash_on_tpch_unskewed(env):
    """Hybrid mode stays correct on ordinary (unskewed) queries."""
    px = TPx(env["tt"], _cpu_mesh(), unique_keys=UNIQUE_KEYS,
             broadcast_threshold=64, hybrid_hash=True)
    for qid in (3, 12):  # hash-repartition join shapes
        tp, _jp = _both(env, QUERIES[qid])
        assert _rows(px, tp) == _rows(env["single"], tp), f"Q{qid}"


# ------------------------------------------------ the SPMD runner itself

def test_a_failing_shard_aborts_the_rendezvous():
    """A shard that raises (an overflow, an OOM) must not leave the others
    waiting at their next collective: the group's barrier aborts and the
    caller gets the shard's own error, not a broken-barrier one."""
    import threading
    import time

    def fn(i):
        current().gather(i)
        if i == 3:
            raise ValueError("shard 3 failed")
        current().gather(i)  # the others wait here until the abort
        return i

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="shard 3 failed"):
        run_spmd(_cpu_mesh(), fn)
    assert time.monotonic() - t0 < 30
    assert not any(t.name.startswith("px-shard-")
                   for t in threading.enumerate())
    # a clean run afterwards: every shard sees every value in shard order
    assert run_spmd(_cpu_mesh(), lambda i: current().gather(i * i)) == \
        [[i * i for i in range(NSH)]] * NSH


def test_concurrent_statements_on_one_executor(env):
    """Several sessions' statements on one PxExecutor at once (each shard
    keeps its distribution map and parameter frame per thread): every
    result equals the single device's, with a short switch interval so
    the threads interleave often."""
    import sys
    import threading

    texts = [QUERIES[q] for q in (1, 6, 3, 12)]
    plans = [env["tplanner"].plan(TP.parse(t)) for t in texts]
    want = [_rows(env["single"], p) for p in plans]
    prepared = [env["px"].prepare(p.plan) for p in plans]
    errors, done = [], []

    def client(k):
        try:
            for r in range(3):
                i = (k + r) % len(plans)
                got = px_rows(prepared[i].run(), plans[i].output_names)
                assert got == want[i], texts[i][:40]
            done.append(k)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert sorted(done) == list(range(6))
