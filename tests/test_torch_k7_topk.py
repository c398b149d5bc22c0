"""K7 (the exact top-k candidates) and K31's merge: their plain versions
against the JAX package's steps, and the model of K7's survivor path.

The same numpy-seeded inputs go to `jax.lax.top_k` (and the reference's
`_topn_candidates` tie count) and to the port's plain versions, over every
integer key width, ties across the C-th value, fewer live rows than C,
every row dead, ASC on INT64_MAX (a live row whose flipped key is the
dead rows' INT64_MIN) and c = n; the merge with ties, +inf lanes and
kk = m. On the card K7 is held to these plain versions bit for bit by
chip_smoke.py, which also reads back the path each launch took and holds
it to `topk_candidates_path_plain`; K7's 13-bit code is modelled here by
`k7_bin_plain`, whose order the survivor path relies on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oceanbase_tpu  # noqa: F401 - x64 on, as the reference runs
from oceanbase_tpu_torch import kernels as K

I64 = np.iinfo(np.int64)
DTYPES = (np.int8, np.int16, np.int32, np.int64)


def _j_topk(key, sel, desc, c):
    flip = jnp.asarray(key).astype(jnp.int64)
    if not desc:
        flip = ~flip
    masked = jnp.where(jnp.asarray(sel), flip, jnp.iinfo(jnp.int64).min)
    cand_v, cand_i = jax.lax.top_k(masked, c)
    cnt = jnp.sum((masked >= cand_v[c - 1]) & jnp.asarray(sel),
                  dtype=jnp.int64)
    return np.asarray(cand_i), int(cnt)


def _case(kind, dtype, n, seed=7):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    lo, hi = int(info.min), int(info.max)
    if kind == "ties":  # a few values: ties across the C-th
        key = rng.integers(-3, 4, n)
        sel = rng.random(n) < 0.6
    elif kind == "spread":
        key = rng.integers(lo, hi, n, endpoint=True)
        sel = rng.random(n) < 0.5
    elif kind == "few_live":
        key = rng.integers(lo, hi, n, endpoint=True)
        sel = np.zeros(n, dtype=bool)
        sel[rng.choice(n, max(1, n // 50), replace=False)] = True
    elif kind == "all_dead":
        key = rng.integers(lo, hi, n, endpoint=True)
        sel = np.zeros(n, dtype=bool)
    else:  # "extremes": the type's min and max among live rows
        key = rng.integers(lo, hi, n, endpoint=True)
        key[::5] = hi
        key[1::7] = lo
        sel = rng.random(n) < 0.7
    return key.astype(dtype), sel


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("kind", ["ties", "spread", "few_live", "all_dead",
                                  "extremes"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_topk_plain_every_width_matches_lax_top_k(dtype, kind, desc):
    key, sel = _case(kind, dtype, 2000)
    for c in (1, 100, 2000):  # c = n among them
        ji, jc = _j_topk(key, sel, desc, c)
        ti, tc = K.topk_candidates(torch.from_numpy(key),
                                   torch.from_numpy(sel), desc, c)
        assert ti.dtype == torch.int32 and tc.dtype == torch.int64
        np.testing.assert_array_equal(ti.numpy(), ji)
        assert int(tc) == jc


@pytest.mark.parametrize("desc", [True, False])
def test_topk_plain_int64_sentinels_and_asc_max(desc):
    """ASC on INT64_MAX and DESC on INT64_MIN: live rows whose flipped key
    equals the dead rows' INT64_MIN tie with the dead rows by index."""
    rng = np.random.default_rng(11)
    n = 5000
    key = rng.integers(-10**6, 10**6, n)
    sel = rng.random(n) < 0.03
    live = sel.nonzero()[0]
    key[live[-4:]] = I64.max
    key[live[-8:-4]] = I64.min
    for c in (64, 200, n):
        ji, jc = _j_topk(key, sel, desc, c)
        ti, tc = K.topk_candidates(torch.from_numpy(key),
                                   torch.from_numpy(sel), desc, c)
        np.testing.assert_array_equal(ti.numpy(), ji)
        assert int(tc) == jc


def test_k7_bin_preserves_order():
    """k7_bin_plain never decreases with the value, puts INT64_MIN (a dead
    row) in the lowest bin, 384, and a bin past 64 spans at most 1/64 of
    its values' magnitude."""
    rng = np.random.default_rng(3)
    v = np.concatenate([
        rng.integers(I64.min, I64.max, 20000, endpoint=True),
        rng.integers(-200, 200, 2000),
        np.array([I64.min, I64.min + 1, -1, 0, 1, 63, 64, 65, I64.max]),
        (1 << np.arange(63, dtype=np.int64)),
        -(1 << np.arange(63, dtype=np.int64)),
    ])
    v = np.sort(v)
    b = K.k7_bin_plain(torch.from_numpy(v)).numpy()
    assert np.all(np.diff(b) >= 0)
    assert b[0] == 384 and b.min() >= 384 and b.max() <= 4096 + 3711
    pos = v[(v >= 64)]
    pb = K.k7_bin_plain(torch.from_numpy(pos)).numpy()
    for bin_ in np.unique(pb)[:: max(1, len(np.unique(pb)) // 50)]:
        vals = pos[pb == bin_]
        assert vals.max() - vals.min() <= vals.min() // 64


def test_k7_path_model():
    """Which path K7's launch takes, as chip_smoke reads it back: a
    spread key leaves a thin kth bin (the survivor path); dense values,
    one value over many rows or a kth bin of dead rows overflow to the
    exact path; c past K7_FAST_C takes it from the start."""
    rng = np.random.default_rng(5)
    n = 200_000
    rev = torch.from_numpy(rng.integers(10**5, 5 * 10**7, n))
    sel = torch.from_numpy(rng.random(n) < 0.3)
    assert K.topk_candidates_path_plain(rev, sel, True, 256) == "survivors"
    dense = torch.from_numpy(rng.integers(0, 1 << 25, 4_000_000))
    half = torch.from_numpy(rng.random(4_000_000) < 0.5)
    assert K.topk_candidates_path_plain(dense, half, True, 256) == "overflow"
    const = torch.full((n,), 1995, dtype=torch.int32)
    assert K.topk_candidates_path_plain(const, sel, True, 256) == "overflow"
    few = torch.zeros(n, dtype=torch.bool)
    few[:100] = True
    assert K.topk_candidates_path_plain(rev, few, True, 256) == "overflow"
    small = torch.ones(300, dtype=torch.bool)
    small[::3] = False
    assert K.topk_candidates_path_plain(rev[:300], small, True, 256) \
        == "survivors"
    assert K.topk_candidates_path_plain(rev, sel, True, K.K7_FAST_C + 1) \
        == "full"


def _j_merge(gd, gp, kk):
    neg, t = jax.lax.top_k(-jnp.asarray(gd), kk)
    return np.asarray(-neg), np.asarray(jnp.asarray(gp)[t])


@pytest.mark.parametrize("m,kk", [(40, 10), (40, 40), (1, 1), (1024, 10),
                                  (1025, 1025), (3000, 777)])
def test_ann_merge_plain_matches_lax_top_k(m, kk):
    """The merge of gathered strips: integer distances (real ties, to the
    lower gathered index) and +inf lanes (a shard's strip past its owned
    rows), kk up to m, on both sides of the one-launch limit."""
    rng = np.random.default_rng(m + kk)
    gd = rng.integers(-4, 5, m).astype(np.float32)
    gd[rng.random(m) < 0.3] = np.inf
    gp = rng.integers(0, 10**6, m).astype(np.int32)
    jd, jp = _j_merge(gd, gp, kk)
    td, tp = K.ann_merge(torch.from_numpy(gd), torch.from_numpy(gp), kk)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tp.numpy(), jp)
