"""The mesh-sharded IVF probe of the port (`parallel/ann.py` on K31)
against the JAX package's `shard_ivf(...).search` and numpy's reference.

The index is built by the JAX package's `build_ivf` and carried over
through the port's `ivf_from_arrays`; the port's meshes are `cpu` shards
(one thread each), the JAX meshes the 8 virtual CPU devices. Ids compare
as sets (the shards' merge order of equal distances is the reference's,
but the sets are what a kNN answer promises); distances within rtol 1e-5
and atol 1e-5 (float32 sums in another order). K31's plain entries are
held to the reference's `local` math on integer-valued vectors with
duplicate rows, so their tie order is tested bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.parallel.ann import shard_ivf as j_shard_ivf
from oceanbase_tpu.parallel.mesh import make_mesh as j_make_mesh
from oceanbase_tpu.storage.vector_index import build_ivf
from oceanbase_tpu_torch import kernels as TK
from oceanbase_tpu_torch.parallel import mesh as t_mesh
from oceanbase_tpu_torch.parallel.ann import shard_ivf
from oceanbase_tpu_torch.storage.vector_index import ivf_from_arrays

D = 16
K = 10
N = 4000
LISTS = 32


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(N, D)).astype(np.float32)
    jidx = build_ivf(x, lists=LISTS)
    tidx = ivf_from_arrays(np.asarray(jidx.centroids), np.asarray(jidx.perm),
                           np.asarray(jidx.offsets), np.asarray(jidx.lengths))
    return x, jidx, tidx, rng


def _reference(x, idx, q, k, nprobe):
    """numpy's single-host probe: same probe, same arithmetic."""
    cent = np.asarray(idx.centroids)
    offs = np.asarray(idx.offsets)
    lens = np.asarray(idx.lengths)
    perm = np.asarray(idx.perm)
    xs = x[perm]
    nprobe = max(1, min(nprobe, len(lens)))
    cd = (cent * cent).sum(1) - 2.0 * (cent @ q)
    probes = np.argsort(cd, kind="stable")[:nprobe]
    pos = np.concatenate([np.arange(offs[p], offs[p] + lens[p])
                          for p in probes])
    xv = xs[pos]
    dd = (xv * xv).sum(1) - 2.0 * (xv @ q)
    order = np.argsort(dd, kind="stable")[:k]
    return perm[pos[order]], dd[order]


def _cpu_mesh(n):
    return t_mesh.make_mesh(devices=[torch.device("cpu")] * n)


def _check(got, jgot, ref):
    rid, dist = got
    assert sorted(rid.tolist()) == sorted(jgot[0].tolist())
    assert sorted(rid.tolist()) == sorted(ref[0].tolist())
    np.testing.assert_allclose(np.sort(dist), np.sort(jgot[1]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.sort(dist), np.sort(ref[1]), rtol=1e-5,
                               atol=1e-5)


def test_mesh_sharded_knn_identical_to_single_chip(index):
    """Twin of test_vector_serving.py::
    test_mesh_sharded_knn_identical_to_single_chip: 4 shards, nprobe 4,
    5 queries; the MeshPlan counts the merge's all_gather."""
    x, jidx, tidx, _rng = index
    rng = np.random.default_rng(18)
    siv = shard_ivf(_cpu_mesh(4), x, tidx)
    jsiv = j_shard_ivf(j_make_mesh(4), x, jidx)
    for _ in range(5):
        q = rng.normal(size=D).astype(np.float32)
        _check(siv.search(q, k=K, nprobe=4), jsiv.search(q, k=K, nprobe=4),
               _reference(x, jidx, q, K, 4))
    plan = siv.mesh_plan
    assert plan.ops_by_collective().get("all_gather", 0) >= 1
    assert plan.total_bytes > 0
    assert plan.ops_by_collective() == jsiv.mesh_plan.ops_by_collective()
    assert plan.total_bytes == jsiv.mesh_plan.total_bytes
    # one process: nothing crosses between processes
    assert plan.cross_process_bytes == 0
    assert siv.device_bytes() == jsiv.device_bytes()


@pytest.mark.parametrize("nsh", [1, 3, 8])
def test_sharded_knn_any_shard_count(index, nsh):
    """1, 3 (pad rows in the last block) and 8 shards, each against the
    JAX package's sharded search on as many devices."""
    x, jidx, tidx, _rng = index
    rng = np.random.default_rng(100 + nsh)
    siv = shard_ivf(_cpu_mesh(nsh), x, tidx)
    jsiv = j_shard_ivf(j_make_mesh(nsh), x, jidx)
    assert siv.rows_per_shard == jsiv.rows_per_shard
    if nsh == 3:
        assert nsh * siv.rows_per_shard > N
        pad = siv.xs[-1][N - (nsh - 1) * siv.rows_per_shard:]
        assert bool((pad == 0).all())
    for _ in range(3):
        q = rng.normal(size=D).astype(np.float32)
        _check(siv.search(q, k=K, nprobe=6), jsiv.search(q, k=K, nprobe=6),
               _reference(x, jidx, q, K, 6))


def test_k_past_the_live_candidates_drops_the_inf_lanes(index):
    """k above the candidates one list holds: the merged strip keeps the
    masked (+inf) lanes, and search drops them, as the reference."""
    x, jidx, tidx, _rng = index
    q = np.random.default_rng(5).normal(size=D).astype(np.float32)
    siv = shard_ivf(_cpu_mesh(4), x, tidx)
    jsiv = j_shard_ivf(j_make_mesh(4), x, jidx)
    got = siv.search(q, k=2000, nprobe=1)
    jgot = jsiv.search(q, k=2000, nprobe=1)
    ref = _reference(x, jidx, q, 2000, 1)
    assert len(got[0]) == len(ref[0]) < 2000
    assert np.isfinite(got[1]).all()
    _check(got, jgot, ref)


def test_nprobe_clamped_to_the_list_count(index):
    """nprobe past the list count probes every list, as the reference
    clamps it."""
    x, jidx, tidx, _rng = index
    q = np.random.default_rng(6).normal(size=D).astype(np.float32)
    siv = shard_ivf(_cpu_mesh(4), x, tidx)
    jsiv = j_shard_ivf(j_make_mesh(4), x, jidx)
    _check(siv.search(q, k=K, nprobe=LISTS + 50),
           jsiv.search(q, k=K, nprobe=LISTS + 50),
           _reference(x, jidx, q, K, LISTS))


def _jax_local(xs, cent, offs, lens, q, sid, rps, nprobe, max_list, kk):
    """The reference's per-shard body (oceanbase_tpu/parallel/ann.py
    :93-116) for one shard, outside shard_map."""
    lo = sid * rps
    cdist = jnp.sum(cent * cent, axis=1) - 2.0 * (cent @ q)
    _neg, probes = jax.lax.top_k(-cdist, nprobe)
    starts = offs[probes]
    ll = lens[probes]
    pos = (starts[:, None] + jnp.arange(max_list, dtype=jnp.int32)).reshape(-1)
    valid = (jnp.arange(max_list, dtype=jnp.int32)[None, :]
             < ll[:, None]).reshape(-1)
    mine = valid & (pos >= lo) & (pos < lo + rps)
    li = jnp.clip(pos - lo, 0, max(rps - 1, 0))
    xv = xs[li]
    dist = jnp.sum(xv * xv, axis=1) - 2.0 * (xv @ q)
    dist = jnp.where(mine, dist, jnp.inf)
    negd, ti = jax.lax.top_k(-dist, kk)
    return probes, -negd, pos[ti]


@pytest.mark.parametrize("kk", [10, 333])
def test_plain_k31_equals_the_reference_local_math(kk):
    """K31's plain re-rank and merge against the reference's shard body
    and its all_gather + top_k, on integer-valued vectors with duplicate
    rows (exact distances, real ties): values and positions bit for bit,
    ties to the lower candidate and the lower gathered index. K21's plain
    version gives the reference's probes."""
    rng = np.random.default_rng(31)
    n, d, nl, nsh = 1200, 8, 12, 3
    base = rng.integers(-2, 3, size=(n // 4, d)).astype(np.float32)
    x = np.concatenate([base] * 4)  # every row four times
    sizes = rng.multinomial(n, [1 / nl] * nl).astype(np.int32)
    offs = (np.cumsum(sizes) - sizes).astype(np.int32)
    cent = rng.integers(-2, 3, size=(nl, d)).astype(np.float32)
    cent[5] = cent[2]  # a centroid tie
    q = rng.integers(-2, 3, size=d).astype(np.float32)
    max_list, nprobe = int(sizes.max()), 5
    rps = -(-n // nsh)
    xs = np.concatenate([x, np.zeros((nsh * rps - n, d), np.float32)])
    tq = torch.from_numpy(q)
    probes = TK.ivf_lists_plain(torch.from_numpy(cent), tq, nprobe)
    strips, jstrips = [], []
    for sid in range(nsh):
        jp, jd, jpos = _jax_local(jnp.asarray(xs[sid * rps:(sid + 1) * rps]),
                                  jnp.asarray(cent), jnp.asarray(offs),
                                  jnp.asarray(sizes), jnp.asarray(q), sid,
                                  rps, nprobe, max_list, kk)
        assert probes.numpy().tolist() == np.asarray(jp).tolist()
        dist, pos = TK.ann_rerank_plain(
            torch.from_numpy(xs[sid * rps:(sid + 1) * rps]), sid * rps,
            torch.from_numpy(offs), torch.from_numpy(sizes), probes, tq,
            max_list, kk)
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        strips.append((dist, pos))
        jstrips.append((jd, jpos))
    gd = torch.cat([s[0] for s in strips])
    gp = torch.cat([s[1] for s in strips])
    md, mp = TK.ann_merge_plain(gd, gp, kk)
    jgd = jnp.concatenate([s[0] for s in jstrips])
    jgp = jnp.concatenate([s[1] for s in jstrips])
    neg2, t2 = jax.lax.top_k(-jgd, kk)
    np.testing.assert_array_equal(md.numpy(), np.asarray(-neg2))
    np.testing.assert_array_equal(mp.numpy(), np.asarray(jgp[t2]))
    # the CPU wrappers are the plain versions
    d2, p2 = TK.ann_merge(gd, gp, kk)
    assert torch.equal(d2, md) and torch.equal(p2, mp)


def test_process_mesh_needs_a_process_group():
    """A mesh over processes is built only when asked for, and raises by
    name without a process group (it never shrinks to one process)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        t_mesh.process_mesh([torch.device("cpu")] * 2, "gloo")
    with pytest.raises(NotImplementedError, match="nccl"):
        t_mesh.process_mesh([torch.device("cpu")], "nccl")
