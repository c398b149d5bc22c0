"""The port's join machinery against the JAX package, on the same numpy
inputs: K9 (the unique-build join) against `merge_join_unique`,
K10 (the expansion) against `sort_build_side` + `expand_join` and the
sorted-range semi/anti search of `_emit_semi_anti`, K11 against
`probe_run_any`, K12 against `hash_combine` / `join_keys64` / `mix64`, and
K5's probe entry against `_affine_probe`.

On the CPU every wrapper runs its kernel's plain PyTorch version, so these
tests pin the plain versions to the JAX package; chip_smoke.py holds the
CUDA kernels to the same plain versions on the card. Every output is
compared exactly, every slot of the expansion included: the port keeps the
reference's clip values in the slots past the total (probe row np - 1 and
the build row its clipped sorted position gives), so no slot is left out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.engine.executor import _affine_probe as j_affine_probe
from oceanbase_tpu.ops import hashing as JH
from oceanbase_tpu.ops import join as JJ
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.engine.executor import _affine_probe as t_affine_probe
from oceanbase_tpu_torch.ops import hashing as TH
from oceanbase_tpu_torch.ops import join as TJ

I64 = np.iinfo(np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t, what):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype, f"{what}: {j.dtype} vs {t.dtype}"
    assert j.shape == t.shape, f"{what}: {j.shape} vs {t.shape}"
    np.testing.assert_array_equal(t, j, err_msg=what)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

CASES = ("random", "extremes", "dup_keys", "all_dead_build", "one_row_build",
         "max_probe_vs_dead_tail")


def _keys(case, seed, nb=300, npr=500):
    """(build key, build sel, probe key, probe sel) int64 numpy arrays."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(-40, 40, nb)
    bs = rng.random(nb) < 0.75
    pk = rng.integers(-45, 45, npr)
    ps = rng.random(npr) < 0.8
    if case == "extremes":
        bk[:4] = [I64.min, I64.max, I64.min + 1, I64.max - 1]
        bs[:4] = True
        pk[:6] = [I64.min, I64.max, I64.min + 1, I64.max - 1, 0, -1]
        ps[:6] = True
    elif case == "dup_keys":
        bk = rng.integers(0, 8, nb)  # every key many times, some rows dead
    elif case == "all_dead_build":
        bs[:] = False
    elif case == "one_row_build":
        bk, bs = bk[:1], np.ones(1, dtype=bool)
        pk[::3] = bk[0]
    elif case == "max_probe_vs_dead_tail":
        # live probe keys of int64 max against a build whose live rows
        # never hold it, and whose dead rows do (the sorted tail's value)
        bk[bk > 30] = 0
        bk[~bs] = I64.max
        pk[::4] = I64.max
    return bk, bs, pk, ps


# ---------------------------------------------------------------------------
# K12: the 64-bit key hash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_mix64_bits_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(I64.min, I64.max, 4096, dtype=np.int64)
    x[:4] = [I64.min, I64.max, 0, -1]
    want = np.asarray(JH.mix64(jnp.asarray(x))).view(np.int64)
    _eq(want, TH.mix64(_t(x)), "mix64")


@pytest.mark.parametrize("dtypes", [
    (np.int32, np.int32),       # Q9's (l_partkey, l_suppkey)
    (np.int32, np.int64),
    (np.int64, np.int64, np.int32),
    (np.int16, np.int8, np.uint8, np.bool_),
])
def test_hash_combine_bits_match_jax(dtypes):
    rng = np.random.default_rng(len(dtypes))
    n = 3000
    cols = []
    for dt in dtypes:
        if dt == np.bool_:
            c = rng.random(n) < 0.5
        else:
            info = np.iinfo(dt)
            c = rng.integers(info.min, info.max, n, dtype=np.int64).astype(dt)
            c[:2] = [info.min, info.max]
            if info.min < 0:
                c[2] = -1  # sign-extends to 2^64 - 1 in the uint64 convert
        cols.append(c)
    jcols = [jnp.asarray(c) for c in cols]
    tcols = [_t(c) for c in cols]
    want = np.asarray(JH.hash_combine(jcols)).view(np.int64)
    _eq(want, TH.hash_combine(tcols), "hash_combine")
    _eq(np.asarray(JJ.join_keys64(jcols)), TJ.join_keys64(tcols),
        "join_keys64")


def test_join_keys64_single_column_passes_through():
    x = np.array([I64.min, -1, 0, 7, I64.max], dtype=np.int64)
    for dt in (np.int64, np.int32):
        c = x.astype(dt) if dt == np.int64 else np.array([-5, 0, 9], dt)
        _eq(np.asarray(JJ.join_keys64([jnp.asarray(c)])),
            TJ.join_keys64([_t(c)]), f"join_keys64 {dt}")


# ---------------------------------------------------------------------------
# K9: the unique-build join
# ---------------------------------------------------------------------------


# int64 extremes fit only int64 columns
MERGE_CASES = [(c, w) for c in CASES
               for w in ((np.int64, np.int64), (np.int32, np.int64),
                         (np.int32, np.int32))
               if c != "extremes" or w == (np.int64, np.int64)]


@pytest.mark.parametrize("case,widths", MERGE_CASES)
def test_merge_join_unique_matches_jax(case, widths):
    bk, bs, pk, ps = _keys(case, 11)
    bt, pt = widths
    bk, pk = bk.astype(bt), pk.astype(pt)
    want = JJ.merge_join_unique(jnp.asarray(bk), jnp.asarray(bs),
                                jnp.asarray(pk), jnp.asarray(ps))
    got = TJ.merge_join_unique(_t(bk), _t(bs), _t(pk), _t(ps))
    _eq(want, got, f"match_row {case}")


def test_merge_join_duplicates_lowest_live_row_wins():
    bk = np.array([5, 5, 5, 9, 9], dtype=np.int64)
    bs = np.array([False, True, True, True, True])
    pk = np.array([5, 9, 4, 5], dtype=np.int64)
    ps = np.array([True, True, True, False])
    got = TJ.merge_join_unique(_t(bk), _t(bs), _t(pk), _t(ps)).numpy()
    assert got.tolist() == [1, 3, -1, -1]
    want = JJ.merge_join_unique(jnp.asarray(bk), jnp.asarray(bs),
                                jnp.asarray(pk), jnp.asarray(ps))
    _eq(want, got, "duplicates")


def test_merge_join_empty_build():
    pk = np.array([0, 1, I64.max], dtype=np.int64)
    ps = np.ones(3, dtype=bool)
    empty = np.zeros(0, dtype=np.int64)
    got = TJ.merge_join_unique(_t(empty), _t(empty.astype(bool)), _t(pk),
                               _t(ps))
    want = JJ.merge_join_unique(jnp.asarray(empty),
                                jnp.asarray(empty.astype(bool)),
                                jnp.asarray(pk), jnp.asarray(ps))
    _eq(want, got, "empty build")


# ---------------------------------------------------------------------------
# K10: sort_build_side + expand_join, and the range search alone
# ---------------------------------------------------------------------------


def _expand_both(bcols, bs, pcols, ps, cap):
    js, jo = JJ.sort_build_side([jnp.asarray(c) for c in bcols],
                                jnp.asarray(bs))
    ts, to = TJ.sort_build_side([_t(c) for c in bcols], _t(bs))
    _eq(js, ts, "sorted keys")
    _eq(jo, to, "build order")
    nlive = int(bs.sum())
    jr = JJ.expand_join(js, jo, jnp.asarray(nlive, jnp.int64),
                        [jnp.asarray(c) for c in pcols], jnp.asarray(ps), cap)
    tr = TJ.expand_join(ts, to, torch.tensor(nlive), [_t(c) for c in pcols],
                        _t(ps), cap)
    return jr, tr


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cap", [4096, 700, 37])
def test_expand_join_matches_jax(case, cap):
    bk, bs, pk, ps = _keys(case, 23)
    jr, tr = _expand_both([bk], bs, [pk], ps, cap)
    names = ("probe_row", "build_row", "valid", "total", "starts", "offs")
    for name, j, t in zip(names, jr, tr):
        _eq(j, t, f"{name} ({case}, cap {cap})")
    total = int(tr[3])
    if cap < total:  # truncation: every slot is a live pair
        assert bool(tr[2].all())


def test_expand_join_int32_probe_against_int64_build():
    """Q13's width mix: int32 o_custkey probes int64-widened c_custkey."""
    bk, bs, pk, ps = _keys("random", 5)
    jr, tr = _expand_both([bk.astype(np.int32)], bs, [pk.astype(np.int32)],
                          ps, 2048)
    for j, t in zip(jr, tr):
        _eq(j, t, "int32 keys")


@pytest.mark.parametrize("seed", [3, 4])
def test_expand_join_two_column_keys_match_jax(seed):
    """Q9/Q20's multi-column keys ride the hash (K12) into the expansion."""
    rng = np.random.default_rng(seed)
    nb, npr = 400, 600
    b0 = rng.integers(-6, 6, nb).astype(np.int32)
    b1 = rng.integers(-(2**40), 2**40, nb)
    b1 = b1[rng.integers(0, 5, nb)]  # few distinct second keys
    bs = rng.random(nb) < 0.8
    take = rng.integers(0, nb, npr)
    p0, p1 = b0[take].copy(), b1[take].copy()
    p0[::7] = 99  # no match
    ps = rng.random(npr) < 0.9
    jr, tr = _expand_both([b0, b1], bs, [p0, p1], ps, 3000)
    for j, t in zip(jr, tr):
        _eq(j, t, "two-column keys")


@pytest.mark.parametrize("case", CASES)
def test_sorted_range_semi_search_matches_jax(case):
    """The no-residual semi/anti route: has = live & the clamped range is
    non-empty (executor._emit_semi_anti's searchsorted formula)."""
    bk, bs, pk, ps = _keys(case, 31)
    js, _jo = JJ.sort_build_side([jnp.asarray(bk)], jnp.asarray(bs))
    nlive = int(bs.sum())
    jpk = jnp.asarray(pk)
    lo = jnp.minimum(jnp.searchsorted(js, jpk, side="left"), nlive)
    hi = jnp.minimum(jnp.searchsorted(js, jpk, side="right"), nlive)
    want = jnp.asarray(ps) & (hi > lo)
    ts, _to = TJ.sort_build_side([_t(bk)], _t(bs))
    got = TJ.probe_has_match(ts, torch.tensor(nlive), _t(pk), _t(ps))
    _eq(want, got, f"has ({case})")


# ---------------------------------------------------------------------------
# K11: probe_run_any
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "dup_keys", "all_dead_build"])
@pytest.mark.parametrize("cap", [4096, 300])
def test_probe_run_any_matches_jax(case, cap):
    bk, bs, pk, ps = _keys(case, 41)
    jr, tr = _expand_both([bk], bs, [pk], ps, cap)
    rng = np.random.default_rng(cap)
    ok = (rng.random(cap) < 0.2) & np.asarray(jr[2])
    want = JJ.probe_run_any(jnp.asarray(ok), jr[4], jr[5])
    got = TJ.probe_run_any(_t(ok), tr[4], tr[5])
    _eq(want, got, f"probe_run_any ({case}, cap {cap})")


# ---------------------------------------------------------------------------
# K5's probe entry: _affine_probe
# ---------------------------------------------------------------------------

A0, STRIDE, NB = 11, 4, 400


@pytest.mark.parametrize("probe_dtype,build_dtype", [
    (np.int32, np.int64), (np.int64, np.int64), (np.int32, np.int32)])
def test_affine_probe_matches_jax(probe_dtype, build_dtype):
    rng = np.random.default_rng(7)
    bk = (A0 + STRIDE * np.arange(NB)).astype(build_dtype)
    bs = rng.random(NB) < 0.8
    pk = rng.integers(-30, A0 + STRIDE * NB + 40, 900).astype(probe_dtype)
    pk[::4] = bk[rng.integers(0, NB, len(pk[::4]))]
    ps = rng.random(900) < 0.7
    want = j_affine_probe(jnp.asarray(bk), jnp.asarray(bs), jnp.asarray(pk),
                          jnp.asarray(ps), (A0, STRIDE))
    got = t_affine_probe(_t(bk), _t(bs), _t(pk), _t(ps), (A0, STRIDE))
    _eq(want, got, "affine probe")


def test_affine_probe_int64_extremes():
    bk = (A0 + STRIDE * np.arange(NB)).astype(np.int64)
    bs = np.ones(NB, dtype=bool)
    pk = np.array([I64.min, I64.max, A0, A0 + STRIDE * (NB - 1),
                   A0 + STRIDE * NB, A0 - STRIDE], dtype=np.int64)
    ps = np.ones(len(pk), dtype=bool)
    want = j_affine_probe(jnp.asarray(bk), jnp.asarray(bs), jnp.asarray(pk),
                          jnp.asarray(ps), (A0, STRIDE))
    got = kernels.affine_probe(_t(pk), _t(ps), A0, STRIDE, _t(bk), _t(bs))
    _eq(want, got, "affine probe extremes")
    assert got.tolist() == [-1, -1, 0, NB - 1, -1, -1]
