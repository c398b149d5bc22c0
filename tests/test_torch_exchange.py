"""The port's PX exchanges (parallel/exchange.py on K25-K28, run here
through the kernels' plain versions) against the JAX package's
`oceanbase_tpu/parallel/exchange.py`, on 8 shards: the port's 8 `cpu`
shards in threads (parallel/group.py) against JAX's 8 virtual CPU
devices under shard_map_compat, each shard given the same seeded numpy
slice.

Checked: the destination of every row bit for bit on every key dtype
(hash, range, round robin, partition); the received lanes' contents and
order exactly (live slots; the reference's dead slots hold whatever row
its sort left there, the port's zeros); the overflow at cap - 1, cap and
cap + 1 and with every row bound for one shard; the all_gather and ring
layouts; the bc2host stripe; the merges (integers exact, floats to rel
1e-12: XLA's psum sums in no documented order, the port in shard order);
and the range bounds, hot buckets and bloom bits exactly, including one
key value everywhere and shards with no live row. Every comparison but
the float merges is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from oceanbase_tpu.ops.hashing import hash32_combine as j_hash32
from oceanbase_tpu.parallel import exchange as JX
from oceanbase_tpu.parallel.mesh import SHARD_AXIS
from oceanbase_tpu.parallel.mesh import make_mesh as j_make_mesh
from oceanbase_tpu.parallel.mesh import shard_map_compat
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.parallel import exchange as TX
from oceanbase_tpu_torch.parallel.group import run_spmd
from oceanbase_tpu_torch.parallel.mesh import make_mesh as t_make_mesh

NSH = 8
N = 1024  # rows per shard
FLOAT_RTOL = 1e-12


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh(NSH), t_make_mesh(devices=["cpu"] * NSH)


def jrun(jmesh, fn, arrays, out_specs):
    """fn over the JAX mesh, every array row-sharded; returns numpy."""
    f = jax.jit(shard_map_compat(
        fn, mesh=jmesh, in_specs=tuple(P(SHARD_AXIS) for _ in arrays),
        out_specs=out_specs, check_replication=False))
    out = f(*[jnp.asarray(a) for a in arrays])
    return jax.tree_util.tree_map(np.asarray, out)


def trun(tmesh, fn, arrays):
    """fn(shard, *slices) on every port shard; returns the per-shard
    results as numpy (trees of tensors)."""
    parts = [np.split(np.asarray(a), NSH) for a in arrays]

    def one(i):
        return fn(i, *[torch.from_numpy(p[i].copy()) for p in parts])

    res = run_spmd(tmesh, one)
    return [jax.tree_util.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, r)
        for r in res]


def _keys(rng, dt, n):
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(dt, np.floating):
        v = rng.normal(0, 1e6, n).astype(dt)
        v[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 3e9, -3e9, 0.5]
        return v
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    v[:2] = [info.min, info.max]
    return v


# ------------------------------------------------------------ destinations

@pytest.mark.parametrize("dt", [np.int8, np.int16, np.int32, np.int64,
                                np.uint8, np.bool_, np.float32, np.float64])
def test_dest_by_hash_bits(dt):
    rng = np.random.default_rng(1)
    a = _keys(rng, dt, 4096)
    b = rng.integers(0, 50, 4096).astype(np.int32)
    for cols in ([a], [a, b]):
        want = np.asarray(JX.dest_by_hash([jnp.asarray(c) for c in cols],
                                          NSH))
        got = TX.dest_by_hash([torch.from_numpy(c) for c in cols], NSH)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("desc", [False, True])
def test_dest_by_range_partition_round_robin(desc):
    rng = np.random.default_rng(2)
    key = rng.integers(-1000, 1000, 4096).astype(np.int64)
    bounds = np.sort(rng.integers(-900, 900, NSH - 1)).astype(np.int64)
    bounds[3] = bounds[2]  # an empty range
    want = np.asarray(JX.dest_by_range(jnp.asarray(key), jnp.asarray(bounds)))
    if desc:
        want = (NSH - 1) - want
    got = TX.dest_by_range(torch.from_numpy(key), torch.from_numpy(bounds),
                           desc=desc)
    assert np.array_equal(got.numpy(), want)
    mask = rng.random(4096) < 0.7
    mask[:5] = False  # dead rows before the first live one
    for shard in (0, 3, 7):
        want = np.asarray(JX.dest_round_robin(jnp.asarray(mask), NSH, shard))
        got = TX.dest_round_robin(torch.from_numpy(mask), NSH, shard)
        assert np.array_equal(got.numpy(), want)
    owner = (np.arange(16) * 5 % NSH).astype(np.int32)
    part = rng.integers(-16, 20, 4096)  # negative ids and past the end
    want = np.asarray(JX.dest_by_partition(jnp.asarray(part),
                                           jnp.asarray(owner)))
    got = TX.dest_by_partition(torch.from_numpy(part), torch.from_numpy(owner))
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ repartition

def _repart_both(meshes, key, mask, extra, cap):
    """JAX and port repartition of {k, x, v} by dest_by_hash(k) at cap:
    (per-shard live rows of each side, overflow of each side)."""
    jmesh, tmesh = meshes

    def jstep(k, m, x, v):
        dest = JX.dest_by_hash([k], NSH)
        out, nm, ovf = JX.repartition({"k": k, "x": x, "v": v}, m, dest,
                                      NSH, cap)
        return out["k"], out["x"], out["v"], nm, ovf

    jk, jx, jv, jm, jo = jrun(
        jmesh, jstep, [key, mask, *extra],
        (P(SHARD_AXIS),) * 4 + (P(),))

    def tstep(i, k, m, x, v):
        dest = TX.dest_by_hash([k], NSH)
        out, nm, ovf = TX.repartition({"k": k, "x": x, "v": v}, m, dest,
                                      NSH, cap)
        return out["k"], out["x"], out["v"], nm, ovf

    tres = trun(tmesh, tstep, [key, mask, *extra])
    lane = NSH * cap
    jl, tl = [], []
    for s in range(NSH):
        sl = slice(s * lane, (s + 1) * lane)
        jl.append((jm[sl], [a[sl][jm[sl]] for a in (jk, jx, jv)]))
        tk, tx, tv, tm, _to = tres[s]
        tl.append((tm, [a[tm] for a in (tk, tx, tv)]))
        # a dead slot holds zeros on the port
        assert not tk[~tm].any() and not tv[~tm].any()
    return jl, tl, int(jo), [int(r[4]) for r in tres]


def test_repartition_lanes_exact(meshes):
    rng = np.random.default_rng(3)
    n = NSH * N
    key = rng.integers(0, 10_000, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    x = rng.normal(size=n)
    v = rng.random(n) < 0.5
    jl, tl, jo, to = _repart_both(meshes, key, mask, [x, v], cap=N)
    assert jo == 0 and to == [0] * NSH
    for (jm, jc), (tm, tc) in zip(jl, tl):
        assert np.array_equal(jm, tm)  # the same slots, lane by lane
        for a, b in zip(jc, tc):
            assert np.array_equal(a, b)  # rows in ascending source order


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_repartition_overflow_at_cap(meshes, delta):
    rng = np.random.default_rng(4)
    n = NSH * N
    key = rng.integers(0, 64, n).astype(np.int64)
    mask = rng.random(n) < 0.9
    dest = np.asarray(JX.dest_by_hash([jnp.asarray(key)], NSH))
    # the fullest (src, dst) lane decides the cap
    lanes = np.zeros((NSH, NSH), np.int64)
    for s in range(NSH):
        sl = slice(s * N, (s + 1) * N)
        lanes[s] = np.bincount(dest[sl][mask[sl]], minlength=NSH)
    cap = int(lanes.max()) + delta
    want = int(np.maximum(lanes - cap, 0).sum())
    x = rng.normal(size=n)
    v = rng.random(n) < 0.5
    jl, tl, jo, to = _repart_both(meshes, key, mask, [x, v], cap=cap)
    assert jo == want and to == [want] * NSH
    for (jm, jc), (tm, tc) in zip(jl, tl):
        assert np.array_equal(jm, tm)
        for a, b in zip(jc, tc):
            assert np.array_equal(a, b)


def test_repartition_all_rows_to_one_shard(meshes):
    jmesh, tmesh = meshes
    n = NSH * N
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 40, n).astype(np.int64)
    mask = np.ones(n, bool)
    mask[::7] = False
    cap = N

    def jstep(x, m):
        dest = jnp.full(x.shape, 5, jnp.int32)
        out, nm, ovf = JX.repartition({"x": x}, m, dest, NSH, cap)
        return out["x"], nm, ovf

    jx, jm, jo = jrun(jmesh, jstep, [x, mask], (P(SHARD_AXIS),) * 2 + (P(),))

    def tstep(i, x, m):
        dest = torch.full(x.shape, 5, dtype=torch.int32)
        out, nm, ovf = TX.repartition({"x": x}, m, dest, NSH, cap)
        return out["x"], nm, ovf

    tres = trun(tmesh, tstep, [x, mask])
    lane = NSH * cap
    for s in range(NSH):
        sl = slice(s * lane, (s + 1) * lane)
        tx, tm, to = tres[s]
        assert np.array_equal(jm[sl], tm)
        assert np.array_equal(jx[sl][jm[sl]], tx[tm])
        assert int(to) == int(jo) == 0
        assert tm.any() == (s == 5)


# ------------------------------------------------------------ gathers

@pytest.mark.parametrize("ring", [False, True])
def test_all_gather_and_ring_layouts(meshes, ring):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(6)
    n = NSH * 256
    a = rng.integers(-5, 5, n).astype(np.int32)
    f = rng.normal(size=n)
    mask = rng.random(n) < 0.6

    def jstep(a, f, m):
        if ring:
            out, nm = JX.ring_broadcast_rows({"a": a, "f": f}, m, NSH)
        else:
            out, nm = JX.broadcast_rows({"a": a, "f": f}, m)
        return out["a"], out["f"], nm

    ja, jf, jm = jrun(jmesh, jstep, [a, f, mask], (P(SHARD_AXIS),) * 3)

    def tstep(i, a, f, m):
        if ring:
            out, nm = TX.ring_broadcast_rows({"a": a, "f": f}, m, NSH)
        else:
            out, nm = TX.broadcast_rows({"a": a, "f": f}, m)
        return out["a"], out["f"], nm

    tres = trun(tmesh, tstep, [a, f, mask])
    for s in range(NSH):
        sl = slice(s * n, (s + 1) * n)
        ta, tf, tm = tres[s]
        # every shard holds all rows, shard i's at offset i * rows
        assert np.array_equal(ja[sl], ta) and np.array_equal(jf[sl], tf)
        assert np.array_equal(jm[sl], tm)
        assert np.array_equal(ta, a)


def test_bc2host_stripe(meshes):
    jmesh, tmesh = meshes
    n = NSH * 256
    vals = np.arange(n, dtype=np.int64)
    mask = np.ones(n, bool)
    mask[3::11] = False
    per_host = 4

    def jstep(v, m):
        out, nm = JX.bc2host({"v": v}, m, per_host)
        return out["v"], nm

    jv, jm = jrun(jmesh, jstep, [vals, mask], (P(SHARD_AXIS),) * 2)

    def tstep(i, v, m):
        out, nm = TX.bc2host({"v": v}, m, per_host)
        return out["v"], nm

    tres = trun(tmesh, tstep, [vals, mask])
    for s in range(NSH):
        sl = slice(s * n, (s + 1) * n)
        tv, tm = tres[s]
        assert np.array_equal(jv[sl], tv) and np.array_equal(jm[sl], tm)


# ------------------------------------------------------------ merges

def test_merges(meshes):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(7)
    t = 64
    ints = rng.integers(-(1 << 62), 1 << 62, NSH * t).astype(np.int64)
    i32 = rng.integers(-1000, 1000, NSH * t).astype(np.int32)
    f64 = rng.normal(0, 1e9, NSH * t)
    f32 = rng.normal(0, 1e3, NSH * t).astype(np.float32)
    # a NaN partial in the sum (the max plane stays NaN-free: XLA's CPU
    # all-reduce max keeps or drops a NaN by its reduction order, the
    # port propagates it as jnp.maximum does)
    fmax = f64.copy()
    f64[5] = np.nan
    flags = rng.random(NSH * t) < 0.2

    def jstep(a, b, c, d, e, g):
        return (JX.merge_partials({"a": a, "b": b, "c": c, "d": d}),
                lax.pmin(a, SHARD_AXIS), lax.pmax(g, SHARD_AXIS),
                lax.psum(e.astype(jnp.int32), SHARD_AXIS) > 0)

    jsum, jmin, jmax, jor = jrun(
        jmesh, jstep, [ints, i32, f64, f32, flags, fmax], (P(),) * 4)

    def tstep(i, a, b, c, d, e, g):
        tree = TX.merge_partials({"a": a, "b": b, "c": c, "d": d})
        mn, mx, orr = TX.merge([(a, "min"), (g, "max"), (e, "or")])
        return tree, mn, mx, orr

    for tsum, tmin, tmax, tor in trun(tmesh, tstep,
                                      [ints, i32, f64, f32, flags, fmax]):
        assert np.array_equal(tsum["a"], jsum["a"])  # wraps like int64 jnp
        assert np.array_equal(tsum["b"], jsum["b"])
        np.testing.assert_allclose(tsum["c"], jsum["c"], rtol=FLOAT_RTOL,
                                   equal_nan=True)
        np.testing.assert_allclose(tsum["d"], jsum["d"], rtol=1e-6)
        assert tsum["d"].dtype == np.float32
        assert np.array_equal(tmin, jmin)
        np.testing.assert_array_equal(tmax, jmax)
        assert np.array_equal(tor, jor)


# ------------------------------------------------- histograms and bounds

@pytest.mark.parametrize("case", ["spread", "one_value", "dead_shards",
                                  "nothing_live", "wide_span"])
def test_range_bounds_exact(meshes, case):
    jmesh, tmesh = meshes
    rng = np.random.default_rng(8)
    n = NSH * N
    key = rng.integers(0, 3_000_000, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    if case == "one_value":
        key[:] = 12345  # kmin == kmax
    elif case == "dead_shards":
        mask[: 3 * N] = False  # shards 0-2 hold no live row
    elif case == "nothing_live":
        mask[:] = False
    elif case == "wide_span":
        key = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)

    def jstep(k, m):
        return JX.sample_range_bounds(k, m, NSH)

    jb = jrun(jmesh, jstep, [key, mask], P())
    for tb in trun(tmesh, lambda i, k, m: TX.sample_range_bounds(k, m, NSH),
                   [key, mask]):
        assert tb.dtype == np.int64
        assert np.array_equal(tb, jb), (tb, jb)


def _j_hot(h, sel, hb):
    cnt = jnp.zeros(hb, dtype=jnp.int64).at[
        jnp.where(sel, h, hb)].add(1, mode="drop")
    cnt = lax.psum(cnt, SHARD_AXIS)
    return cnt > jnp.maximum(jnp.sum(cnt) * 2 // NSH, 1)


def test_hot_buckets_and_bloom_exact(meshes):
    """The reference's px.py:579-593 hot-bucket route and :608-623 bloom
    prefilter, computed as px.py computes them, against K28 + K27."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(9)
    n = NSH * N
    hb, m = 4096, 1 << 14
    pk = np.where(rng.random(n) < 0.4, 7, rng.integers(0, 50_000, n))
    pk = pk.astype(np.int64)
    bk = rng.integers(0, 50_000, n).astype(np.int32)
    psel = rng.random(n) < 0.9
    bsel = rng.random(n) < 0.5
    bsel[N:2 * N] = False  # a build shard with no live row

    def jstep(pk, bk, ps, bs):
        ph = (j_hash32([pk]) % jnp.uint32(hb)).astype(jnp.int32)
        bh = (j_hash32([bk]) % jnp.uint32(hb)).astype(jnp.int32)
        popular = _j_hot(ph, ps, hb) | _j_hot(bh, bs, hb)
        p_pop = popular[ph] & ps
        h = (j_hash32([bk]) % jnp.uint32(m)).astype(jnp.int32)
        bits = jnp.zeros(m, dtype=jnp.int32).at[
            jnp.where(bs, h, m)].set(1, mode="drop")
        bits = lax.psum(bits, SHARD_AXIS) > 0
        php = (j_hash32([pk]) % jnp.uint32(m)).astype(jnp.int32)
        return popular, p_pop, bits, ps & bits[php]

    jpop, jppop, jbits, jkeep = jrun(
        jmesh, jstep, [pk, bk, psel, bsel],
        (P(), P(SHARD_AXIS), P(), P(SHARD_AXIS)))
    assert jpop.any()  # the hot key is hot

    def tstep(i, pk, bk, ps, bs):
        cp, cb = TX.merge([(K.hash_histogram([pk], ps, hb), "sum"),
                           (K.hash_histogram([bk], bs, hb), "sum")])
        popular = K.hot_buckets(cp, cb, NSH)
        p_pop = K.bucket_probe([pk], ps, popular)
        (bits,) = TX.merge([(K.bloom_bits([bk], bs, m), "or")])
        return popular, p_pop, bits, K.bucket_probe([pk], ps, bits)

    for s, (pop, ppop, bits, keep) in enumerate(
            trun(tmesh, tstep, [pk, bk, psel, bsel])):
        sl = slice(s * N, (s + 1) * N)
        assert np.array_equal(pop, jpop)
        assert np.array_equal(ppop, jppop[sl])
        assert np.array_equal(bits, jbits)
        assert np.array_equal(keep, jkeep[sl])
