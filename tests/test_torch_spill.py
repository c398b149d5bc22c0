"""The port's spill operators and general hash group-by against the JAX
package's, on the same seeded numpy inputs, on the CPU (the kernels'
plain versions):

- `ops.spill` external_sort (K3), partitioned_groupby_sum (K29) and
  partitioned_join_sum (K14 + K30): twins of tests/test_maintenance.py's
  spill tests (their seeds and sizes); the outputs equal the JAX
  functions' arrays exactly and in order, and every segment is freed;
- `ops.hashagg` groupby_hash / assign_group_slots / _apply_agg (K29): a
  twin of tests/test_ops.py::test_groupby_hash_matches_numpy, and the
  plain lockstep table slot for slot against JAX (a table too small for
  its keys, float keys with NaN, -0.0 and 0.0, several key columns),
  min/max on int64 and float64, float sums;
- pack_sort_key and the uint64 -> int64 image that K3 sorts;
- the join's product sum wrapping as int64.

Exact everywhere but the float64 sums, which agree to rel 1e-12 (the
scatter adds in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops import hashagg as JA
from oceanbase_tpu.ops import spill as JS
from oceanbase_tpu.storage.tmp_file import TmpFileManager as JTmp
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.ops import groupby_hash as t_groupby_hash
from oceanbase_tpu_torch.ops import hashagg as TA
from oceanbase_tpu_torch.ops import spill as TS
from oceanbase_tpu_torch.ops.hashing import next_pow2
from oceanbase_tpu_torch.storage.tmp_file import TmpFileManager as TTmp


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


# ------------------------------------------------------------ spill twins

def test_external_sort_bounded_memory_twin():
    rng = np.random.default_rng(9)
    n = 50_000
    a = rng.integers(0, 1000, n)
    b = rng.permutation(n).astype(np.int64)
    payload = rng.integers(0, 100, n)
    key = TS.pack_sort_key([a, b], [False, True])
    assert np.array_equal(key, JS.pack_sort_key([a, b], [False, True]))
    cols = {"a": a, "b": b, "p": payload}
    with TTmp() as tmp:
        got = TS.external_sort(cols, key, chunk_rows=4096, tmp=tmp,
                               device="cpu")
        assert tmp.bytes_used == 0
    with JTmp() as jtmp:
        want = JS.external_sort(cols, key, chunk_rows=4096, tmp=jtmp)
        assert jtmp.bytes_used == 0
    assert set(got) == set(want)
    for c in want:
        _same(got[c], want[c], c)
    order = np.lexsort((-b, a))
    assert np.array_equal(got["p"], payload[order])


def test_partitioned_groupby_matches_numpy_twin():
    rng = np.random.default_rng(4)
    n = 80_000
    key = rng.integers(0, 5000, n)
    val = rng.integers(0, 50, n)
    with TTmp() as tmp:
        got = TS.partitioned_groupby_sum(key, val, n_parts=8, tmp=tmp,
                                         device="cpu")
        assert tmp.bytes_used == 0
    with JTmp() as jtmp:
        want = JS.partitioned_groupby_sum(key, val, n_parts=8, tmp=jtmp)
    for g, w, what in zip(got, want, ("keys", "sums", "counts")):
        _same(g, w, what)
    uk = np.unique(key)
    order = np.argsort(got[0])
    assert np.array_equal(got[0][order], uk)
    assert np.array_equal(got[1][order], np.bincount(
        key, weights=val, minlength=5000)[uk].astype(np.int64))


def test_partitioned_join_matches_numpy_twin():
    rng = np.random.default_rng(2)
    n_l, n_r = 60_000, 10_000
    rkey = np.arange(n_r)
    rval = rng.integers(0, 7, n_r)
    lkey = rng.integers(0, 2 * n_r, n_l)
    lval = rng.integers(0, 9, n_l)
    with TTmp() as tmp:
        got = TS.partitioned_join_sum(lkey, lval, rkey, rval, n_parts=8,
                                      tmp=tmp, device="cpu")
        assert tmp.bytes_used == 0
    with JTmp() as jtmp:
        want = JS.partitioned_join_sum(lkey, lval, rkey, rval, n_parts=8,
                                       tmp=jtmp)
    assert got == want
    hit = lkey < n_r
    assert got == (int(np.sum(lval[hit] * rval[lkey[hit]])), int(hit.sum()))


def test_device_join_sum_wraps_as_int64():
    """Products and their sum overflow int64 and wrap as XLA's do."""
    rng = np.random.default_rng(31)
    nb, npr = 500, 3000
    rk = rng.permutation(4 * nb)[:nb].astype(np.int64)
    rv = rng.integers(2**40, 2**62, nb)
    lk = rng.integers(0, 4 * nb, npr)
    lv = rng.integers(-(2**40), 2**40, npr)
    ts = next_pow2(2 * nb)
    js, jm = JS._device_join_sum(jnp.asarray(lk), jnp.asarray(lv),
                                 jnp.asarray(rk), jnp.asarray(rv), ts)
    ts_, tm = TS._device_join_sum(torch.from_numpy(lk), torch.from_numpy(lv),
                                  torch.from_numpy(rk), torch.from_numpy(rv),
                                  ts)
    assert int(ts_) == int(js) and int(tm) == int(jm)
    hit = np.isin(lk, rk)
    assert int(tm) == int(hit.sum()) > 0
    pos = {int(k): i for i, k in enumerate(rk)}
    with np.errstate(over="ignore"):
        want = np.sum(np.array([lv[i] * rv[pos[int(lk[i])]]
                                for i in np.flatnonzero(hit)], np.int64))
    assert int(ts_) == int(want)


def test_pack_sort_key_top_bit_orders_through_the_image():
    """Two 32-bit columns pack into a key with its top bit set; K3's int64
    image (top bit flipped) keeps the unsigned order, ties by row."""
    rng = np.random.default_rng(5)
    n = 20_000
    a = rng.integers(0, 2**32 - 1, n)
    a[:5] = 2**32 - 1
    b = rng.integers(0, 2**32 - 1, n)
    b[rng.integers(0, n, 500)] = 7  # ties in the low half
    cols = [a, b]
    key = TS.pack_sort_key(cols, [False, False])
    assert np.array_equal(key, JS.pack_sort_key(cols, [False, False]))
    assert key.dtype == np.uint64 and int(key.max()) >= 2**63
    img = torch.from_numpy(TS.sort_image(key))
    order = TS._device_sort_chunk(img).numpy()
    assert np.array_equal(order, np.argsort(key, kind="stable"))
    assert np.array_equal(
        order, np.asarray(JS._device_sort_chunk(jnp.asarray(key))))
    with TTmp() as tmp:
        out = TS.external_sort({"i": np.arange(n)}, key, chunk_rows=4096,
                               tmp=tmp, device="cpu")
        assert tmp.bytes_used == 0
    assert np.array_equal(out["i"], np.argsort(key, kind="stable"))
    with pytest.raises(ValueError, match="too wide"):
        TS.pack_sort_key([a, b, a], [False] * 3)


# ------------------------------------------------------ hash group-by

def test_groupby_hash_matches_numpy_twin(rng):
    """Twin of tests/test_ops.py::test_groupby_hash_matches_numpy."""
    n = 8192
    k1 = rng.integers(0, 1 << 40, 50)[rng.integers(0, 50, n)]
    k2 = rng.integers(0, 97, n)
    v = rng.integers(-1000, 1000, n)
    mask = rng.random(n) < 0.9
    ts = next_pow2(50 * 97 * 2)
    jk, jused, jaggs = jax.jit(
        lambda k1, k2, v, m: JA.groupby_hash([k1, k2], m, ["sum", "count"],
                                             [v, None], ts))(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(v), jnp.asarray(mask))
    tk, tused, taggs = t_groupby_hash(
        [torch.from_numpy(k1), torch.from_numpy(k2)], torch.from_numpy(mask),
        ["sum", "count"], [torch.from_numpy(v), None], ts)
    _same(tused, jused, "slot_used")
    for i in range(2):
        _same(tk[i], jk[i], f"key {i}")
        _same(taggs[i], jaggs[i], f"agg {i}")
    import collections

    sums, cnts = collections.Counter(), collections.Counter()
    for i in range(n):
        if mask[i]:
            sums[(k1[i], k2[i])] += v[i]
            cnts[(k1[i], k2[i])] += 1
    used = tused.numpy()
    got = {(int(tk[0][i]), int(tk[1][i])): (int(taggs[0][i]),
                                            int(taggs[1][i]))
           for i in range(ts) if used[i]}
    assert len(got) == len(cnts)
    for key, cnt in cnts.items():
        assert got[key] == (sums[key], cnt)


def _slot_cases():
    rng = np.random.default_rng(17)
    n = 3000
    ints = [rng.integers(0, 400, n)]
    small = [rng.integers(0, 200, 600)]  # 200 keys in a 64-slot table
    f = rng.integers(0, 50, n).astype(np.float64)
    f[rng.integers(0, n, 40)] = np.nan
    f[rng.integers(0, n, 40)] = -0.0
    f[rng.integers(0, n, 40)] = 0.0
    floats = [f]
    multi = [rng.integers(-5, 5, n).astype(np.int8),
             rng.random(n) < 0.5,
             rng.integers(0, 30, n).astype(np.float32),
             rng.integers(0, 1 << 40, 20)[rng.integers(0, 20, n)]]
    return {
        "int64": (ints, 1024, rng.random(n) < 0.8),
        "too_small": (small, 64, np.ones(600, bool)),
        "float_nan_zero": (floats, 512, rng.random(n) < 0.9),
        "four_columns": (multi, 4096, rng.random(n) < 0.7),
    }


SLOT_CASES = _slot_cases()


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_assign_group_slots_slot_for_slot(case):
    cols, ts, mask = SLOT_CASES[case]
    jr, ju, jrow = jax.jit(lambda cs, m: JA.assign_group_slots(cs, m, ts))(
        [jnp.asarray(c) for c in cols], jnp.asarray(mask))
    tr, tu, trow = TA.assign_group_slots(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(mask), ts)
    _same(tr, jr, "row_slot")
    _same(tu, ju, "slot_used")
    _same(trow, jrow, "slot_row")
    if case == "too_small":
        assert int((tr.numpy() < 0).sum()) > 0  # rows dropped, as JAX does


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_groupby_hash_aggregates_twin(case):
    """count/sum/min/max on int64 and float64 values: integers and
    min/max exact, float sums to rel 1e-12; dropped rows land where JAX's
    scatter puts them."""
    cols, ts, mask = SLOT_CASES[case]
    rng = np.random.default_rng(len(case))
    n = len(mask)
    vi = rng.integers(-(10**12), 10**12, n)
    vf = rng.standard_normal(n) * 1e3
    vi32 = rng.integers(-1000, 1000, n).astype(np.int32)
    ops = ["count", "sum", "min", "max", "sum", "min", "max", "min", "sum"]
    vals = [None, vi, vi, vi, vf, vf, vf, vi32, vi32]
    jk, ju, jaggs = jax.jit(lambda cs, m, vs: JA.groupby_hash(
        cs, m, ops, vs, ts))(
        [jnp.asarray(c) for c in cols], jnp.asarray(mask),
        [None if v is None else jnp.asarray(v) for v in vals])
    tk, tu, taggs = t_groupby_hash(
        [torch.from_numpy(c) for c in cols], torch.from_numpy(mask), ops,
        [None if v is None else torch.from_numpy(v) for v in vals], ts)
    _same(tu, ju, "slot_used")
    for i, (g, w) in enumerate(zip(tk, jk)):
        _same(g, w, f"key {i}")
    for i, (op, g, w) in enumerate(zip(ops, taggs, jaggs)):
        g, w = _np(g), _np(w)
        if op == "sum" and w.dtype.kind == "f":
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            _same(g, w, f"agg {i} {op}")


def test_apply_agg_wraps_slot_minus_one_as_jax():
    """_apply_agg on given slots: a live row with slot -1 lands in T - 1
    (JAX's scatter wraps the index), a dead row drops."""
    rng = np.random.default_rng(3)
    n, ts = 500, 32
    row_slot = rng.integers(-1, ts, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    v = rng.integers(-50, 50, n)
    for op in ("count", "sum", "min", "max"):
        val = None if op == "count" else v
        want = JA._apply_agg(op, jnp.asarray(row_slot), jnp.asarray(mask),
                             None if val is None else jnp.asarray(val), ts)
        got = TA._apply_agg(op, torch.from_numpy(row_slot),
                            torch.from_numpy(mask),
                            None if val is None else torch.from_numpy(val),
                            ts)
        _same(got, want, op)


def test_k29_k30_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    launch."""
    K.reset_launches()
    key = torch.arange(10) % 3
    live = torch.ones(10, dtype=torch.bool)
    K.hash_groupby([key], live, [("count", None)], 8)
    K.join_product_sum(torch.ones(4, dtype=torch.int64),
                       torch.ones(2, dtype=torch.int64),
                       torch.tensor([0, -1, 1, 1], dtype=torch.int32))
    assert K.LAUNCHES["K29_hash_groupby"] == 0
    assert K.LAUNCHES["K30_join_product_sum"] == 0
