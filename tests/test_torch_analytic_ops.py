"""The port's analytic-SQL device functions against the JAX package's, on
the same seeded numpy inputs, on the CPU (the kernels' plain versions):

- `ops.hashing` mix32 / fold32 / hash32_combine bit-equal on every key
  dtype, floats included (XLA's saturating float-to-int conversions);
- `ops.join` build_hash_table + hash_join_probe (K14): the plain table
  equals the reference's lockstep table slot for slot, and match_row is
  equal, with duplicate build keys, NULL planes, NaN keys, mixed widths
  and a tiny table that forces tag collisions;
- `ops.hashagg.distinct_first_mask` (K3 + K15) with NaN, -0.0 and NULL
  group planes;
- `ops.window` boundaries / segment_starts / peer_ends / segmented and
  suffix min/max (K13) with NaN, and the frame-bound search both ways;
- `ops.hll` registers and estimates (K16) exactly, on ints, floats, a mask
  and empty input; K11's mark_build against the reference's `.at[].max`.

Every comparison is exact: these are integer, bool or min/max results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops import hashing as JH
from oceanbase_tpu.ops import hll as JL
from oceanbase_tpu.ops import join as JJ
from oceanbase_tpu.ops import window as JW
from oceanbase_tpu.ops.hashagg import distinct_first_mask as j_first
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.ops import hashing as TH
from oceanbase_tpu_torch.ops import hll as TL
from oceanbase_tpu_torch.ops import join as TJ
from oceanbase_tpu_torch.ops import window as TW
from oceanbase_tpu_torch.ops.hashagg import distinct_first_mask as t_first

DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint8, np.bool_,
          np.float32, np.float64)


def _col(rng, dt, n):
    if dt == np.bool_:
        return rng.integers(0, 2, n).astype(np.bool_)
    if np.issubdtype(dt, np.floating):
        v = rng.normal(0, 3e9, n)
        v[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 0.5, -0.5, 1e20]
        return v.astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64
                        ).astype(dt)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_hash32_bits_equal_jax(dt):
    rng = np.random.default_rng(7)
    a = _col(rng, dt, 4000)
    want_fold = np.asarray(JH.fold32(jnp.asarray(a))).astype(np.int64)
    assert np.array_equal(TH.fold32(_t(a)).numpy(), want_fold)
    u = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(TH.mix32(_t(u.astype(np.int64))).numpy(),
                          np.asarray(JH.mix32(jnp.asarray(u))).astype(np.int64))
    b = _col(rng, np.int32, 4000)
    want = np.asarray(JH.hash32_combine([jnp.asarray(a), jnp.asarray(b)]))
    got = TH.hash32_combine([_t(a), _t(b)]).numpy()
    assert np.array_equal(got, want.astype(np.int64))


def _hash_case(rng, nb, npr, dtypes):
    """Build and probe key columns drawn from small pools (duplicate build
    keys), float pools holding NaN, -0.0 and 0.0."""
    build, probe = [], []
    for dt in dtypes:
        pool = _col(rng, dt, 40)
        if np.issubdtype(dt, np.floating):
            pool[0] = np.nan
            pool[1] = -0.0
            pool[2] = 0.0
        build.append(pool[rng.integers(0, 40, nb)])
        probe.append(pool[rng.integers(0, 40, npr)])
    bsel = rng.random(nb) < 0.8
    psel = rng.random(npr) < 0.9
    return build, bsel, probe, psel


@pytest.mark.parametrize("case", [
    ("int32x2", (np.int32, np.int32), 64),
    ("int64_bool_planes", (np.int64, np.bool_, np.int8), 64),
    ("floats_nan", (np.float64, np.int32), 64),
    ("float32_uint8", (np.float32, np.uint8, np.int16), 64),
    ("tiny_table_collisions", (np.int64, np.int32), 16),
], ids=lambda c: c[0])
def test_hash_table_build_probe_match_jax(case):
    _name, dtypes, nb = case
    rng = np.random.default_rng(len(dtypes) * 31 + nb)
    build, bsel, probe, psel = _hash_case(rng, nb, 300, dtypes)
    ts = 1 << max(4, (2 * nb - 1).bit_length())
    jtag, jrow = JJ.build_hash_table([jnp.asarray(c) for c in build],
                                     jnp.asarray(bsel), ts)
    ttag, trow = TJ.build_hash_table([_t(c) for c in build], _t(bsel), ts)
    assert np.array_equal(ttag.numpy(), np.asarray(jtag))
    assert np.array_equal(trow.numpy(), np.asarray(jrow))
    jm = JJ.hash_join_probe(jtag, jrow, [jnp.asarray(c) for c in build],
                            [jnp.asarray(c) for c in probe],
                            jnp.asarray(psel))
    tm = TJ.hash_join_probe(ttag, trow, [_t(c) for c in build],
                            [_t(c) for c in probe], _t(psel))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    # the contract the kernel keeps whatever its slot layout: the lowest
    # live build row with an equal key tuple
    for i in np.flatnonzero(psel):
        eq = bsel.copy()
        for b, p in zip(build, probe):
            eq &= b == p[i]
        want = int(np.flatnonzero(eq)[0]) if eq.any() else -1
        assert int(tm[i]) == want


def test_hash_table_mixed_widths_probe():
    # an int32 build column probed by an int64 column with the same values
    # (fold32 is width-stable, so the tags agree)
    rng = np.random.default_rng(3)
    b = rng.integers(-50, 50, 100).astype(np.int32)
    p = rng.integers(-60, 60, 500).astype(np.int64)
    c = rng.integers(0, 3, 100).astype(np.int8)
    d = rng.integers(0, 3, 500).astype(np.int64)
    bsel = np.ones(100, bool)
    psel = np.ones(500, bool)
    jt, jr = JJ.build_hash_table([jnp.asarray(b), jnp.asarray(c)],
                                 jnp.asarray(bsel), 256)
    tt, tr = TJ.build_hash_table([_t(b), _t(c)], _t(bsel), 256)
    jm = JJ.hash_join_probe(jt, jr, [jnp.asarray(b), jnp.asarray(c)],
                            [jnp.asarray(p), jnp.asarray(d)],
                            jnp.asarray(psel))
    tm = TJ.hash_join_probe(tt, tr, [_t(b), _t(c)], [_t(p), _t(d)], _t(psel))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert (tm.numpy() >= 0).sum() > 50


@pytest.mark.parametrize("vdt", (np.int64, np.float64, np.float32, np.int32))
def test_distinct_first_mask_matches_jax(vdt):
    rng = np.random.default_rng(11)
    n = 3000
    k1 = rng.integers(0, 7, n).astype(np.int32)
    kv = rng.random(n) < 0.85            # a NULL group plane
    k1 = np.where(kv, k1, 0).astype(np.int32)
    if np.issubdtype(vdt, np.floating):
        v = rng.integers(-5, 5, n).astype(vdt)
        v[rng.random(n) < 0.05] = np.nan
        v[rng.random(n) < 0.05] = -0.0
    else:
        v = rng.integers(-5, 5, n).astype(vdt)
    mask = rng.random(n) < 0.9
    keys = [k1, kv.astype(np.int32)]
    want = j_first([jnp.asarray(k) for k in keys], jnp.asarray(v),
                   jnp.asarray(mask))
    got = t_first([_t(k) for k in keys], _t(v), _t(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("is_min", (True, False))
@pytest.mark.parametrize("vdt", (np.int64, np.float64, np.int32))
def test_window_scans_match_jax(is_min, vdt):
    rng = np.random.default_rng(5)
    n = 2500
    new_seg = rng.random(n) < 0.03
    new_seg[0] = True
    if np.issubdtype(vdt, np.floating):
        v = rng.normal(0, 100, n).astype(vdt)
        v[rng.random(n) < 0.01] = np.nan
    else:
        v = rng.integers(-1000, 1000, n).astype(vdt)
    for jf, tf in ((JW.segmented_scan_minmax, TW.segmented_scan_minmax),
                   (JW.suffix_scan_minmax, TW.suffix_scan_minmax)):
        want = np.asarray(jf(jnp.asarray(v), jnp.asarray(new_seg), is_min))
        got = tf(_t(v), _t(new_seg), is_min).numpy()
        assert np.array_equal(got, want, equal_nan=True)
    assert TW.agg_identity(torch.int32, is_min) == JW.agg_identity(
        jnp.int32, is_min)
    keys = [rng.integers(0, 3, n).astype(np.int64),
            np.round(rng.random(n) * 4).astype(np.float64)]
    keys[1][rng.random(n) < 0.02] = np.nan
    assert np.array_equal(
        TW.boundaries([_t(k) for k in keys]).numpy(),
        np.asarray(JW.boundaries([jnp.asarray(k) for k in keys])))
    assert np.array_equal(TW.segment_starts(_t(new_seg)).numpy(),
                          np.asarray(JW.segment_starts(jnp.asarray(new_seg))))
    assert np.array_equal(TW.peer_ends(_t(new_seg)).numpy(),
                          np.asarray(JW.peer_ends(jnp.asarray(new_seg))))


@pytest.mark.parametrize("right", (False, True))
def test_bound_search_both_routes(right):
    """The frame-bound search: over a globally sorted array it equals
    searchsorted; inside per-row [lo, hi) it equals the reference's
    34-round binary search."""
    rng = np.random.default_rng(9)
    n = 3000
    arr = np.sort(rng.integers(-10**6, 10**6, n)).astype(np.int64)
    tgt = rng.integers(-2 * 10**6, 2 * 10**6, n).astype(np.int64)
    got = K.bound_search(_t(arr), _t(tgt), right=right).numpy()
    want = np.searchsorted(arr, tgt, side="right" if right else "left")
    assert np.array_equal(got, want)
    lo = rng.integers(0, n, n).astype(np.int64)
    hi = np.minimum(lo + rng.integers(0, 200, n), n).astype(np.int64)
    got = K.bound_search(_t(arr), _t(tgt), _t(lo), _t(hi), right).numpy()
    for i in range(0, n, 7):
        seg = arr[lo[i]:hi[i]]
        w = lo[i] + np.searchsorted(seg, tgt[i],
                                    side="right" if right else "left")
        assert got[i] == w


@pytest.mark.parametrize("dt", (np.int64, np.int32, np.float64, np.float32,
                                np.bool_))
def test_hll_registers_and_estimate_match_jax(dt):
    rng = np.random.default_rng(13)
    n = 20000
    if dt == np.bool_:
        v = rng.integers(0, 2, n).astype(np.bool_)
    elif np.issubdtype(dt, np.floating):
        v = (rng.integers(0, 5000, n) / 7.0).astype(dt)
    else:
        v = rng.integers(0, 9000, n).astype(dt)
    mask = rng.random(n) < 0.7
    jr = JL.hll_registers(jnp.asarray(v), jnp.asarray(mask))
    tr = K.hll_registers(_t(v), _t(mask))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert int(TL.hll_estimate(tr)) == int(JL.hll_estimate(jr))
    assert int(TL.hll_count(_t(v), _t(mask))) == int(
        JL.hll_count(jnp.asarray(v), jnp.asarray(mask)))


def test_hll_large_ndv_empty_and_merge():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1_000_000, 300_000).astype(np.int64)
    ones = np.ones(v.shape[0], bool)
    want = int(JL.hll_count(jnp.asarray(v), jnp.asarray(ones)))
    assert int(TL.hll_count(_t(v), _t(ones))) == want
    exact = len(np.unique(v))
    assert abs(want - exact) / exact < 0.02
    z = np.zeros(100, bool)
    assert int(TL.hll_count(_t(v[:100]), _t(z))) == 0 == int(
        JL.hll_count(jnp.asarray(v[:100]), jnp.asarray(z)))
    a = K.hll_registers(_t(v[:1000]), _t(ones[:1000]))
    b = K.hll_registers(_t(v[500:3000]), _t(ones[500:3000]))
    assert np.array_equal(
        TL.hll_merge(a, b).numpy(),
        np.asarray(JL.hll_merge(jnp.asarray(a.numpy()),
                                jnp.asarray(b.numpy()))))


def test_mark_build_matches_reference_scatter():
    rng = np.random.default_rng(2)
    nr, cap = 500, 3000
    br = rng.integers(0, nr, cap).astype(np.int32)
    br[-50:] = nr + 7                     # out of range: dropped
    sel = rng.random(cap) < 0.3
    want = np.asarray(jnp.zeros(nr, dtype=jnp.bool_).at[jnp.asarray(br)].max(
        jnp.asarray(sel), mode="drop"))
    assert np.array_equal(K.mark_build(_t(br), _t(sel), nr).numpy(), want)
