"""The sort-based group-by against the JAX package, on the same numpy
inputs: the port's `ops.hashagg.sort_groupby` (the order from K3, the key
gather through K4, the segmented reduction K8) against
`oceanbase_tpu.ops.hashagg.sort_groupby`, and the plain segmented scans of
the port's `ops/window.py` against the JAX ones.

On the CPU the wrappers run their plain versions; chip_smoke.py holds the
CUDA kernels to the same plain versions on the card. `sel` must match
exactly everywhere; the group keys and the aggregates where `sel` is set
(the other rows are dead: the port writes a result at each segment
start and 0 at the other rows). Integers match
exactly; float64 sums compare at rel 1e-12, because the reference takes
them as cumsum differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops import window as jw
from oceanbase_tpu.ops.hashagg import sort_groupby as j_sort_groupby
from oceanbase_tpu_torch.ops import window as tw
from oceanbase_tpu_torch.ops.hashagg import sort_groupby as t_sort_groupby

N = 1500
OPS = ("count", "sum", "min", "max")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _values(kind, rng, n=N):
    if kind == "int8":
        return rng.integers(-128, 128, n).astype(np.int8)
    if kind == "int32":
        return rng.integers(-10**9, 10**9, n).astype(np.int32)
    if kind == "int64":
        v = rng.integers(-10**15, 10**15, n)
        v[::97] = np.iinfo(np.int64).max   # sums wrap as in the reference
        return v
    return rng.normal(0.0, 1e3, n)          # float64


def _keys(nkeys, rng, n=N):
    cols = [rng.integers(0, 6, n).astype(np.int32),
            rng.integers(-3, 3, n),
            (rng.random(n) < 0.5)]
    return cols[:nkeys]


def _compare(keys, mask, ops, vals, amasks):
    jk, jsel, jaggs, jorder = j_sort_groupby(
        [jnp.asarray(k) for k in keys], jnp.asarray(mask), list(ops),
        [None if v is None else jnp.asarray(v) for v in vals],
        [None if m is None else jnp.asarray(m) for m in amasks])
    tk, tsel, taggs, torder = t_sort_groupby(
        [_t(k) for k in keys], _t(mask), list(ops),
        [None if v is None else _t(v) for v in vals],
        [None if m is None else _t(m) for m in amasks])
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    s = np.asarray(jsel)
    np.testing.assert_array_equal(tsel.numpy(), s)
    for i, (j, t) in enumerate(zip(jk, tk)):
        assert t.numpy().dtype == np.asarray(j).dtype, f"key {i}"
        np.testing.assert_array_equal(t.numpy()[s], np.asarray(j)[s])
    for i, (j, t) in enumerate(zip(jaggs, taggs)):
        j = np.asarray(j)
        t = t.numpy()
        assert t.dtype == j.dtype, f"aggregate {i} ({ops[i]})"
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t[s], j[s], rtol=1e-12, atol=0.0,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(t[s], j[s], err_msg=f"agg {i}")
    return s


@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("vkind", ["int8", "int32", "int64", "float64"])
def test_sort_groupby_matches_jax(nkeys, vkind):
    rng = np.random.default_rng(nkeys * 10 + len(vkind))
    keys = _keys(nkeys, rng)
    mask = rng.random(N) < 0.8
    v = _values(vkind, rng)
    nulls = rng.random(N) < 0.2
    ops = OPS + ("sum", "min")
    vals = [None, v, v, v, v, v]
    amasks = [mask, mask, mask, mask, mask & ~nulls, mask & ~nulls]
    s = _compare(keys, mask, ops, vals, amasks)
    assert s.sum() > 1


@pytest.mark.parametrize("case", ["empty_masks", "one_segment", "all_dead",
                                  "no_agg_masks"])
def test_sort_groupby_edges(case):
    rng = np.random.default_rng(3)
    keys = _keys(2, rng)
    mask = rng.random(N) < 0.7
    v = _values("int64", rng)
    amasks = [mask] * 4
    if case == "empty_masks":       # no row feeds the aggregates
        amasks = [np.zeros(N, dtype=bool)] * 4
    elif case == "one_segment":
        keys = [np.zeros(N, dtype=np.int32), np.full(N, 9, np.int64)]
    elif case == "all_dead":
        mask = np.zeros(N, dtype=bool)
        amasks = [mask] * 4
    elif case == "no_agg_masks":
        amasks = [None] * 4
    s = _compare(keys, mask, OPS, [None, v, v, v], amasks)
    if case == "all_dead":
        assert not s.any()
    if case == "one_segment":
        assert s.sum() == 1


def test_sort_groupby_float_keys():
    """Float keys group by value: -0.0 joins +0.0, each NaN row is its own
    group, as the reference's k[1:] != k[:-1]."""
    rng = np.random.default_rng(8)
    k = rng.integers(-2, 3, N).astype(np.float64)
    k[::17] = -0.0
    k[::29] = np.nan
    mask = rng.random(N) < 0.9
    v = _values("int32", rng)
    _compare([k], mask, OPS, [None, v, v, v], [mask] * 4)


@pytest.mark.parametrize("is_min", [True, False])
def test_window_scans_match_jax(is_min):
    rng = np.random.default_rng(5)
    new_seg = rng.random(N) < 0.05
    new_seg[0] = True
    iv = rng.integers(-10**12, 10**12, N)
    fv = rng.normal(size=N)
    fv[::53] = np.nan
    for a, b in ((jw.segment_starts(jnp.asarray(new_seg)),
                  tw.segment_starts(_t(new_seg))),
                 (jw.peer_ends(jnp.asarray(new_seg)),
                  tw.peer_ends(_t(new_seg)))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    starts = jw.segment_starts(jnp.asarray(new_seg))
    np.testing.assert_array_equal(
        tw.segmented_cumsum(_t(iv), _t(np.array(starts))).numpy(),
        np.asarray(jw.segmented_cumsum(jnp.asarray(iv), starts)))
    for v in (iv, fv):
        np.testing.assert_array_equal(
            tw.segmented_scan_minmax(_t(v), _t(new_seg), is_min).numpy(),
            np.asarray(jw.segmented_scan_minmax(
                jnp.asarray(v), jnp.asarray(new_seg), is_min)))
    keys = [rng.integers(0, 3, N), rng.integers(0, 2, N).astype(np.int32)]
    np.testing.assert_array_equal(
        tw.boundaries([_t(k) for k in keys]).numpy(),
        np.asarray(jw.boundaries([jnp.asarray(k) for k in keys])))
