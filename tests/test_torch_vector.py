"""IVF vector search in the port against the JAX package.

The same numpy inputs go through the JAX functions and the port's
(Session(device="cpu"), plain kernel versions):

- `build_ivf` at the four shapes of the reference's vector tests: perm,
  offsets and lengths equal, and the centroids' bits equal (both packages
  draw from numpy's `default_rng(seed)` and, on the CPU, sum each list in
  row order);
- the plain versions of K19/K20 against `_kmeans_assign` /
  `_kmeans_update`, and of K21/K22 against the reference's steps of
  `_emit_vector_topn` (engine/executor.py:1572-1601), on integer-valued
  float32 data: every dot product is exact in float32 whatever the
  summation order, so ties are real ties and the results must be equal,
  including an L above 4096, dead rows and the starvation counter;
- port twins of the Session tests of tests/test_vector_index.py and of
  the filtered recall of tests/test_vector_serving.py (recall@10 >= 0.9 at
  selectivity 1.0, 0.1 and 0.01);
- the probe over a JAX-built index carried across (`ivf_from_arrays` +
  `Executor.install_ivf`): the same ids, and distance columns within
  2e-5 x (|x|^2 + |q|^2): float32 dot products summed in another order,
  and `vec_l2` = |x|^2 - 2 x.q + |q|^2 cancels terms of that size, so a
  near neighbour's distance carries their rounding, not its own;
- the over-probe escalation: a starved filtered probe widens nprobe to
  every list in both packages, with the same escalation count, and then
  equals the exact filtered top-k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.core.dtypes import DataType as JDataType
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.core.dtypes import TypeKind as JTypeKind
from oceanbase_tpu.core.table import Table as JTable
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.storage import vector_index as JV
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.core.dtypes import DataType, Field, Schema, TypeKind
from oceanbase_tpu_torch.core.table import Table
from oceanbase_tpu_torch.engine.executor import ClusteredPremiseInvalidated
from oceanbase_tpu_torch.engine.session import Session
from oceanbase_tpu_torch.storage.vector_index import (
    build_ivf,
    drop_vector_index,
    ivf_from_arrays,
    register_vector_index,
)

DIST_RTOL = 2e-5


def _blobs(n, d, blobs, seed):
    """The reference tests' clustered data: gaussian blobs x 4, unit noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(blobs, d)).astype(np.float32) * 4
    a = rng.integers(0, blobs, n)
    x = centers[a] + rng.normal(size=(n, d)).astype(np.float32)
    return x, a, centers, rng


def _catalogs(x, extra=None):
    """One docs table per package over the same arrays."""
    n, d = x.shape
    data = {"id": np.arange(n, dtype=np.int64), **(extra or {}), "emb": x}
    names = ["id", *(extra or {})]
    jt = JTable("docs", JSchema(tuple(
        JField(c, JDataType(JTypeKind.INT64)) for c in names)
        + (JField("emb", JDataType.vector(d)),)), dict(data))
    tt = Table("docs", Schema(tuple(
        Field(c, DataType(TypeKind.INT64)) for c in names)
        + (Field("emb", DataType.vector(d)),)), dict(data))
    return {"docs": jt}, {"docs": tt}


def _lit(q):
    return "[" + ",".join(f"{v:.6f}" for v in q) + "]"


def _qtext(q, k, where=""):
    return (f"select id from docs {where}order by vec_l2(emb, '{_lit(q)}') "
            f"limit {k}")


def _exact(x, q, k, mask=None):
    ids = np.arange(len(x))
    if mask is not None:
        x, ids = x[mask], ids[mask]
    d = ((x.astype(np.float64) - q[None, :]) ** 2).sum(axis=1)
    return ids[np.argsort(d, kind="stable")[:k]]


def _ids(rs):
    return [int(v) for v in rs.columns["id"]]


# ---------------------------------------------------------------- the build

BUILD_SHAPES = {
    # tests/test_vector_index.py::test_build_ivf_structure
    "normal_1000x8_l16": (
        lambda: np.random.default_rng(1).normal(size=(1000, 8)).astype(
            np.float32), 16),
    # tests/test_vector_index.py::_vec_table (recall)
    "blobs_20000x32_l64": (lambda: _blobs(20000, 32, 40, 0)[0], 64),
    # tests/test_vector_serving.py::_mk_db
    "blobs_20000x16_l64": (lambda: _blobs(20000, 16, 64, 7)[0], 64),
    # tests/test_vector_index.py::test_index_rebuild_after_dml
    "blobs_4000x32_l32": (lambda: _blobs(4000, 32, 40, 0)[0], 32),
}


@pytest.mark.parametrize("shape", list(BUILD_SHAPES))
def test_build_ivf_matches_jax_bit_for_bit(shape):
    make, lists = BUILD_SHAPES[shape]
    x = make()
    want = JV.build_ivf(x, lists=lists)
    got = build_ivf(x, lists=lists, device="cpu")
    assert np.array_equal(got.perm, want.perm)
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.lengths, want.lengths)
    assert got.max_list == want.max_list
    assert got.centroids.dtype == np.float32
    assert np.array_equal(got.centroids.view(np.int32),
                          want.centroids.view(np.int32))
    assert 1 <= got.iterations <= 10


# ------------------------------------------------- plain kernels vs the JAX

def _int_data(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


@pytest.mark.parametrize("n,d,L", [(3000, 8, 64), (600, 4, 5000)])
def test_kmeans_assign_plain_matches_jax(n, d, L):
    """K19's plain version against `_kmeans_assign`: integer coordinates
    make many exact ties, which both must break to the lowest index."""
    rng = np.random.default_rng(n + L)
    x = _int_data(rng, (n, d))
    c = _int_data(rng, (L, d))
    c[L // 2:L // 2 + 8] = c[3]  # duplicated centroids: exact ties
    want = np.asarray(JV._kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    got = kernels.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def test_kmeans_update_plain_matches_jax():
    """K20's plain version against `_kmeans_update` on real float data:
    both sum each list in row order on the CPU, so every bit agrees."""
    x, a, _c, _r = _blobs(20000, 32, 40, 3)
    L = 64
    a = np.random.default_rng(5).integers(0, L - 3, len(x))  # 3 empty lists
    ws, wc = JV._kmeans_update(jnp.asarray(x), jnp.asarray(a), L)
    gs, gc = kernels.kmeans_update(torch.from_numpy(x), torch.from_numpy(a), L)
    assert np.array_equal(gs.numpy().view(np.int32),
                          np.asarray(ws).view(np.int32))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert not gc[L - 3:].any()


def _ref_lists(cent, q, nprobe):
    """engine/executor.py:1572-1573."""
    cdist = jnp.sum(cent * cent, axis=1) - 2.0 * (cent @ q)
    return jax.lax.top_k(-cdist, nprobe)[1]


@pytest.mark.parametrize("L,d,nprobe", [(64, 16, 8), (5000, 8, 300),
                                        (5000, 8, 5000)])
def test_ivf_lists_plain_matches_jax(L, d, nprobe):
    rng = np.random.default_rng(L + nprobe)
    cent = _int_data(rng, (L, d), -2, 3)
    q = _int_data(rng, (d,), -2, 3)
    want = np.asarray(_ref_lists(jnp.asarray(cent), jnp.asarray(q), nprobe))
    got = kernels.ivf_lists(torch.from_numpy(cent), torch.from_numpy(q),
                            nprobe)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _ref_probe(x, sel, perm, offs, lens, probes, q, max_list, n, k, lists):
    """engine/executor.py:1574-1601, the candidate re-rank and top-k."""
    starts = offs[probes]
    ll = lens[probes]
    win = starts[:, None] + jnp.arange(max_list, dtype=jnp.int32)
    wvalid = jnp.arange(max_list, dtype=jnp.int32)[None, :] < ll[:, None]
    rows = perm[jnp.clip(win, 0, max(n - 1, 0))].reshape(-1)
    wv = wvalid.reshape(-1)
    xv = x[rows]
    dist = jnp.sum(xv * xv, axis=1) - 2.0 * (xv @ q)
    live = wv & sel[rows]
    dist = jnp.where(live, dist, jnp.inf)
    kk = min(k, rows.shape[0])
    starved = None
    if len(probes) < lists:
        starved = jnp.maximum(
            jnp.int64(kk) - jnp.sum(live, dtype=jnp.int64), jnp.int64(0))
    neg, top_i = jax.lax.top_k(-dist, kk)
    return rows[top_i], neg > -jnp.inf, starved


@pytest.mark.parametrize("dens,k,nprobe", [(1.0, 10, 8), (0.3, 25, 16),
                                           (0.002, 10, 4), (1.0, 5000, 40)])
def test_ivf_probe_plain_matches_jax(dens, k, nprobe):
    """K22's plain version against the reference's steps: dead rows (the
    fused filter), exact distance ties (duplicated rows), k larger than
    the live candidates (the starvation counter) and than the windows."""
    rng = np.random.default_rng(int(dens * 1000) + k)
    n, d, L = 6000, 12, 40
    x = _int_data(rng, (n, d), -2, 3)
    x[100:140] = x[7]  # exact ties across lists
    a = rng.integers(0, L, n)
    perm = np.argsort(a, kind="stable").astype(np.int32)
    lens = np.bincount(a, minlength=L).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    cap = 6144
    xp = np.zeros((cap, d), np.float32)
    xp[:n] = x
    sel = np.zeros(cap, bool)
    sel[:n] = rng.random(n) < dens
    q = x[7] + 1.0
    probes = rng.choice(L, nprobe, replace=False).astype(np.int32)
    max_list = int(lens.max())
    rows, osel, starved = _ref_probe(
        jnp.asarray(xp), jnp.asarray(sel), jnp.asarray(perm),
        jnp.asarray(offs), jnp.asarray(lens), jnp.asarray(probes),
        jnp.asarray(q), max_list, n, k, L)
    grows, gsel, gstarved = kernels.ivf_probe(
        torch.from_numpy(xp), torch.from_numpy(sel), torch.from_numpy(perm),
        torch.from_numpy(offs), torch.from_numpy(lens),
        torch.from_numpy(probes), torch.from_numpy(q), max_list, n, k)
    assert grows.dtype == torch.int32
    assert np.array_equal(grows.numpy(), np.asarray(rows))
    assert np.array_equal(gsel.numpy(), np.asarray(osel))
    if starved is not None:  # nprobe < lists: the reference's counter
        assert int(gstarved) == int(starved)
    assert (int(gstarved) > 0) == (np.asarray(osel).sum() < len(osel))


# --------------------------------------- tests/test_vector_index.py, twins

def _vec_session(n=20000, d=32, seed=0, lists=None, nprobe=8):
    x, _a, _c, rng = _blobs(n, d, 40, seed)
    _jc, tc = _catalogs(x)
    if lists is not None:
        register_vector_index(tc, "docs", "emb", lists=lists, nprobe=nprobe)
    return tc, Session(tc, device="cpu"), x, rng


def test_brute_force_exact():
    tc, sess, x, rng = _vec_session(n=5000)
    for _ in range(3):
        q = x[rng.integers(0, len(x))] + 0.1
        rs = sess.sql(_qtext(q, 10))
        assert _ids(rs) == [int(v) for v in _exact(x, q, 10)]
        assert not sess.cached_entry(_qtext(q, 10))[0].prepared.params \
            .vector_topns


def test_ivf_recall_at_10_on_one_plan():
    tc, sess, x, rng = _vec_session(lists=64, nprobe=8)
    hits = total = 0
    first = None
    for _ in range(25):
        q = x[rng.integers(0, len(x))] + rng.normal(
            size=x.shape[1]).astype(np.float32) * 0.05
        rs = sess.sql(_qtext(q, 10))
        hits += len(set(_ids(rs)) & {int(v) for v in _exact(x, q, 10)})
        total += 10
        entry, qparams = sess.cached_entry(_qtext(q, 10))
        assert entry.prepared.params.vector_topns, "ANN path did not engage"
        if first is None:
            first = entry
        else:
            # every distinct query vector reuses ONE prepared plan
            assert entry is first
    assert hits / total >= 0.9, f"recall@10 = {hits / total}"
    assert sess.executor.ann_stats[("docs", "emb")] == [25, 25 * 8, 0]
    assert sess.executor.ann_device_bytes() > 0


def test_index_rebuild_after_dml():
    tc, sess, x, rng = _vec_session(n=4000, lists=32, nprobe=32)
    q = x[7]
    assert _ids(sess.sql(_qtext(q, 1))) == [7]
    x2 = x.copy()
    x2[7] += 50.0
    x2[3] = q
    tc["docs"].data["emb"] = x2
    sess.executor.invalidate_table("docs")
    assert _ids(sess.sql(_qtext(q, 1))) == [3], "stale vector index served"


def test_stale_index_is_rebuilt_by_identity():
    """An array swapped without an invalidation is caught by identity,
    and a device request for another list window than the index has
    raises the re-prepare signal."""
    tc, sess, x, rng = _vec_session(n=4000, lists=32, nprobe=4)
    assert _ids(sess.sql(_qtext(x[11], 1))) == [11]
    before = sess.executor.ivf_host("docs", "emb")
    assert sess.executor.ivf_host("docs", "emb") is before
    tc["docs"].data["emb"] = np.concatenate([x[2000:], x[:2000]])
    after = sess.executor.ivf_host("docs", "emb")
    assert after is not before
    assert sess.executor.ivf_device("docs", "emb", after.max_list)[1] \
        .shape == (4000,)
    with pytest.raises(ClusteredPremiseInvalidated):
        sess.executor.ivf_device("docs", "emb", after.max_list + 1)


def test_nprobe_full_is_exact():
    tc, sess, x, rng = _vec_session(n=3000, lists=16, nprobe=16)
    for _ in range(3):
        q = rng.normal(size=x.shape[1]).astype(np.float32) * 3
        assert _ids(sess.sql(_qtext(q, 5))) == [int(v)
                                                for v in _exact(x, q, 5)]


def test_ip_and_cosine_metrics():
    tc, sess, x, rng = _vec_session(n=3000)
    q = x[11]
    rs = sess.sql(f"select id from docs order by vec_ip(emb, '{_lit(q)}') "
                  "limit 5")
    assert _ids(rs) == [int(v) for v in np.argsort(-(x @ q),
                                                   kind="stable")[:5]]
    rs = sess.sql(f"select id from docs order by vec_cosine(emb, "
                  f"'{_lit(q)}') limit 5")
    sims = (x @ q) / (np.linalg.norm(x, axis=1) * np.linalg.norm(q) + 1e-30)
    assert _ids(rs) == [int(v) for v in np.argsort(-sims, kind="stable")[:5]]


def test_build_ivf_structure():
    x = np.random.default_rng(1).normal(size=(1000, 8)).astype(np.float32)
    idx = build_ivf(x, lists=16, device="cpu")
    assert idx.centroids.shape == (16, 8)
    assert sorted(idx.perm.tolist()) == list(range(1000))
    assert int(idx.lengths.sum()) == 1000
    assert idx.max_list == int(idx.lengths.max())
    assert int((idx.offsets + idx.lengths).max()) == 1000


def test_drop_vector_index_returns_to_brute_force():
    tc, sess, x, rng = _vec_session(n=3000, lists=16, nprobe=2)
    q = x[5] + 0.01
    sess.sql(_qtext(q, 5))
    assert sess.cached_entry(_qtext(q, 5))[0].prepared.params.vector_topns
    drop_vector_index(tc, "docs", "emb")
    sess2 = Session(tc, device="cpu")
    assert _ids(sess2.sql(_qtext(q, 5))) == [int(v) for v in _exact(x, q, 5)]
    assert not sess2.cached_entry(_qtext(q, 5))[0].prepared.params \
        .vector_topns


# --------------------------- tests/test_vector_serving.py, filtered recall

@pytest.mark.parametrize("where,sel_mask", [
    ("", None),
    ("where grp < 10 ", lambda g: g < 10),
    ("where grp = 0 ", lambda g: g == 0),
])
def test_filtered_recall_at_10(where, sel_mask):
    """recall@10 >= 0.9 against exact numpy at selectivity 1.0, 0.1 and
    0.01, whatever route the costing picks (the fused probe or the exact
    brute TopN); the escalations of the IVF route are counted."""
    d, n, lists = 16, 20000, 64
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(lists, d)).astype(np.float32) * 4
    x = (centers[rng.integers(0, lists, n)]
         + rng.normal(size=(n, d)).astype(np.float32))
    grp = np.arange(n, dtype=np.int64) % 100
    _jc, tc = _catalogs(x, {"grp": grp})
    register_vector_index(tc, "docs", "emb", lists=lists, nprobe=8)
    sess = Session(tc, device="cpu")
    mask = sel_mask(grp) if sel_mask is not None else np.ones(n, bool)
    hits = total = ivf_runs = esc = 0
    for _ in range(12):
        q = (x[rng.integers(0, n)]
             + rng.normal(size=d).astype(np.float32) * 0.05)
        text = _qtext(q, 10, where)
        got = _ids(sess.sql(text))
        assert len(got) == 10
        hits += len(set(got) & {int(v) for v in _exact(x, q, 10, mask)})
        total += 10
        params = sess.cached_entry(text)[0].prepared.params
        if params.vector_topns:
            ivf_runs += 1
            esc = params.ann_escalations
    assert hits / total >= 0.9, f"recall@10 {hits / total:.3f} ({where!r})"
    st = sess.executor.ann_stats.get(("docs", "emb"), [0, 0, 0])
    assert st[0] == ivf_runs and st[2] == esc


# ----------------------------------- the probe on a carried JAX-built index

def _carried(n=20000, d=32, lists=64, nprobe=8, seed=0):
    x, a, centers, rng = _blobs(n, d, 40, seed)
    grp = np.arange(n, dtype=np.int64) % 10
    jc, tc = _catalogs(x, {"grp": grp, "blob": a.astype(np.int64)})
    JV.register_vector_index(jc, "docs", "emb", lists=lists, nprobe=nprobe)
    register_vector_index(tc, "docs", "emb", lists=lists, nprobe=nprobe)
    js = JSession(jc)
    ts = Session(tc, device="cpu")
    ji = js.executor.ivf_host("docs", "emb")
    ts.executor.install_ivf("docs", "emb", ivf_from_arrays(
        ji.centroids, ji.perm, ji.offsets, ji.lengths))
    return js, ts, x, a, centers, rng


def test_probe_on_carried_index_matches_jax():
    js, ts, x, a, centers, rng = _carried()
    for where in ("", "where grp < 5 "):
        for _ in range(3):
            q = x[rng.integers(0, len(x))] + rng.normal(
                size=x.shape[1]).astype(np.float32) * 0.05
            text = _qtext(q, 10, where)
            assert _ids(ts.sql(text)) == _ids(js.sql(text)), where
    dtext = (f"select id, vec_l2(emb, '{_lit(q)}') as d from docs "
             "order by d limit 10")
    jr, tr = js.sql(dtext), ts.sql(dtext)
    assert ts.cached_entry(dtext)[0].prepared.params.vector_topns
    assert _ids(tr) == _ids(jr)
    # |x|^2 - 2 x.q + |q|^2 cancels terms of size |x|^2 + |q|^2 in
    # float32: the tolerance is relative to that scale
    ids = np.asarray(_ids(tr))
    scale = (x[ids].astype(np.float64) ** 2).sum(axis=1) + float(q @ q)
    err = np.abs(np.asarray(tr.columns["d"], np.float64)
                 - np.asarray(jr.columns["d"], np.float64))
    assert np.all(err <= DIST_RTOL * scale), err / scale
    assert ts.executor.ann_builds == {}  # the carried index served


def test_starved_probe_escalates_like_jax():
    """A filter on a blob far from the query starves the probed lists:
    both packages escalate nprobe x8 up to every list, as many times, and
    the exhaustive probe equals the exact filtered top-k."""
    js, ts, x, a, centers, rng = _carried(lists=64, nprobe=2)
    far = int(np.argmax(((centers - centers[0]) ** 2).sum(axis=1)))
    q = centers[0] + rng.normal(size=x.shape[1]).astype(np.float32) * 0.05
    text = _qtext(q, 10, f"where blob = {far} ")
    got, want = _ids(ts.sql(text)), _ids(js.sql(text))
    assert got == want
    assert got == [int(v) for v in _exact(x, q, 10, a == far)]
    tp = ts.cached_entry(text)[0].prepared.params
    jp = js.cached_entry(text)[0].prepared.params
    assert tp.ann_escalations == jp.ann_escalations >= 1
    assert tp.ann_nprobe == jp.ann_nprobe == {0: 64}
    assert ts.executor.ann_stats[("docs", "emb")][2] == tp.ann_escalations
