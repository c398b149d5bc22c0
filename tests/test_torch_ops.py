"""Device operators: the JAX functions and the port's kernel wrappers on
the same numpy inputs.

On the CPU every wrapper runs its kernel's plain PyTorch version, so these
tests pin the plain versions (K1 scalar_aggregate, K2 groupby_direct, K3
sort_indices / compact_batch, K4 gather_rows) to the JAX package. The CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py. Integer results, masks and orders must match exactly;
float sums compare at rel 1e-12 (summation order differs).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.core.column import ColumnBatch as JBatch
from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.engine.executor import _direct_slot_agg as j_direct_slot_agg
from oceanbase_tpu.engine.executor import compact_batch as j_compact
from oceanbase_tpu.ops.gather import gather_rows as j_gather
from oceanbase_tpu.ops.hashagg import groupby_direct as j_groupby
from oceanbase_tpu.ops.hashagg import scalar_aggregate as j_scalar
from oceanbase_tpu.ops.hashing import pack_keys as j_pack
from oceanbase_tpu.ops.sort import sort_indices as j_sort
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.core.column import ColumnBatch as TBatch
from oceanbase_tpu_torch.core.dtypes import DataType as TDT
from oceanbase_tpu_torch.core.dtypes import Field as TField
from oceanbase_tpu_torch.core.dtypes import Schema as TSchema
from oceanbase_tpu_torch.engine.executor import compact_batch as t_compact
from oceanbase_tpu_torch.ops.gather import gather_rows as t_gather
from oceanbase_tpu_torch.ops.hashagg import groupby_direct as t_groupby
from oceanbase_tpu_torch.ops.hashagg import scalar_aggregate as t_scalar
from oceanbase_tpu_torch.ops.hashing import pack_keys as t_pack
from oceanbase_tpu_torch.ops.sort import sort_indices as t_sort

N = 777
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(j, t, what=""):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype, f"{what}: {j.dtype} vs {t.dtype}"
    assert j.shape == t.shape, f"{what}: {j.shape} vs {t.shape}"
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, rtol=1e-12, atol=0.0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


def _values(kind, rng, n=N):
    if kind == "int64_extremes":
        v = rng.integers(-10**6, 10**6, n).astype(np.int64)
        v[::97] = I64.max
        v[5::89] = I64.min
        return v
    if kind == "int32":
        return rng.integers(I32.min, I32.max, n, dtype=np.int32)
    if kind == "int8":
        return rng.integers(-128, 128, n).astype(np.int8)
    if kind == "float64":
        return rng.normal(0.0, 1e3, n)
    if kind == "float32":
        return rng.normal(0.0, 10.0, n).astype(np.float32)
    raise KeyError(kind)


def _mask(kind, rng, n=N):
    if kind == "all_live":
        return np.ones(n, bool)
    if kind == "all_dead":
        return np.zeros(n, bool)
    return rng.random(n) < 0.4


VKINDS = ["int64_extremes", "int32", "int8", "float64", "float32"]
MKINDS = ["random", "all_live", "all_dead"]


@pytest.mark.parametrize("mkind", MKINDS)
@pytest.mark.parametrize("vkind", VKINDS)
@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
def test_k1_scalar_aggregate(op, vkind, mkind):
    rng = np.random.default_rng(zlib.crc32(f"{op}{vkind}{mkind}".encode()))
    v, m = _values(vkind, rng), _mask(mkind, rng)
    (jv,) = j_scalar(jnp.asarray(m), [op], [jnp.asarray(v)])
    before = dict(kernels.LAUNCHES)
    (tv,) = t_scalar(_t(m), [op], [_t(v)])
    assert kernels.LAUNCHES == before  # CPU tensors: plain version
    if vkind == "float32" and op == "sum":
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4)
        return
    _same(jv, tv, f"{op} {vkind} {mkind}")


@pytest.mark.parametrize("mkind", MKINDS)
@pytest.mark.parametrize("domain", [8, 64])
def test_k2_groupby_direct(domain, mkind):
    rng = np.random.default_rng(domain)
    keys = rng.integers(0, max(domain // 2, 1), N).astype(np.int32)
    keys[::7] = domain - 1
    m = _mask(mkind, rng)
    vals = {
        "sum": _values("int64_extremes", rng), "min": _values("int32", rng),
        "max": _values("int8", rng), "count": None,
    }
    fsum = _values("float64", rng)
    ops = ["sum", "min", "max", "count", "sum"]
    jv = [None if o == "count" else jnp.asarray(vals[o]) for o in ops[:4]]
    jv.append(jnp.asarray(fsum))
    tv = [None if o == "count" else _t(vals[o]) for o in ops[:4]]
    tv.append(_t(fsum))
    ju, ja = j_groupby(jnp.asarray(keys), domain, jnp.asarray(m), ops, jv)
    tu, ta = t_groupby(_t(keys), domain, _t(m), ops, tv)
    _same(ju, tu, "slot_used")
    for o, a, b in zip(ops, ja, ta):
        _same(a, b, o)


def test_k2_per_aggregate_masks():
    """The executor's direct path gives each aggregate its own mask: the
    port's groupby_direct with agg_masks against JAX's _direct_slot_agg."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 8, N).astype(np.int32)
    live = _mask("random", rng)
    masks = [live & _mask("random", rng) for _ in range(5)]
    ops = ["sum", "count", "min", "max", "sum"]
    vals = [_values("int64_extremes", rng), None, _values("int32", rng),
            _values("int8", rng), _values("float64", rng)]
    slot_is = [jnp.asarray(keys) == g for g in range(8)]
    tu, ta = t_groupby(_t(keys), 8, _t(live), ops,
                       [None if v is None else _t(v) for v in vals],
                       [_t(m) for m in masks])
    ju = jnp.stack([jnp.sum(jnp.asarray(live) & g, dtype=jnp.int64)
                    for g in slot_is]) > 0
    _same(ju, tu, "slot_used")
    for op, v, m, got in zip(ops, vals, masks, ta):
        want = j_direct_slot_agg(op, slot_is, jnp.asarray(m),
                                 None if v is None else jnp.asarray(v))
        _same(want, got, op)


def _sort_keys(kind, rng):
    if kind == "int64_extremes_desc":
        k = rng.integers(-3, 3, N).astype(np.int64)
        k[::11] = I64.min
        k[3::13] = I64.max
        return [k], [True]
    if kind == "int64_extremes_asc":
        k = rng.integers(-3, 3, N).astype(np.int64)
        k[::11] = I64.min
        k[3::13] = I64.max
        return [k], [False]
    if kind == "int32_min_desc":
        k = rng.integers(-5, 5, N).astype(np.int32)
        k[::9] = I32.min
        return [k], [True]
    if kind == "int8_min_desc":
        k = rng.integers(-128, 128, N).astype(np.int8)
        k[::5] = -128
        return [k], [True]
    if kind == "bool_keys":
        return [rng.random(N) < 0.5, rng.random(N) < 0.3], [False, True]
    if kind == "ties_multi":
        return ([rng.integers(0, 3, N).astype(np.int64),
                 rng.integers(0, 2, N).astype(np.int32),
                 rng.integers(0, 4, N).astype(np.int8)],
                [True, False, False])
    if kind in ("float64_zero_nan", "float64_zero_nan_desc",
                "float32_zero_nan"):
        k = rng.choice(np.array([0.0, -0.0, np.nan, -np.nan, np.inf,
                                 -np.inf, 1.5, -1.5]), N)
        if kind.startswith("float32"):
            k = k.astype(np.float32)
        return [k], [kind.endswith("desc")]
    if kind == "no_keys":
        return [], []
    raise KeyError(kind)


SKINDS = ["int64_extremes_desc", "int64_extremes_asc", "int32_min_desc",
          "int8_min_desc", "bool_keys", "ties_multi", "float64_zero_nan",
          "float64_zero_nan_desc", "float32_zero_nan", "no_keys"]


@pytest.mark.parametrize("mkind", MKINDS)
@pytest.mark.parametrize("skind", SKINDS)
def test_k3_sort_indices(skind, mkind):
    rng = np.random.default_rng(len(skind) * 31 + len(mkind))
    keys, desc = _sort_keys(skind, rng)
    m = _mask(mkind, rng)
    jo = j_sort([jnp.asarray(k) for k in keys], desc, jnp.asarray(m))
    to = t_sort([_t(k) for k in keys], desc, _t(m))
    _same(jo, to, f"{skind} {mkind}")


def test_k3_int_min_desc_sorts_first():
    """jnp's -v maps the type's minimum to itself, so under DESC it sorts
    FIRST (a bitwise-NOT image would put it last); the port keeps that."""
    k = np.array([5, I64.min, 7, -1], np.int64)
    m = np.ones(4, bool)
    order = t_sort([_t(k)], [True], _t(m)).tolist()
    assert order == [1, 2, 0, 3]
    assert order == np.asarray(j_sort([jnp.asarray(k)], [True],
                                      jnp.asarray(m))).tolist()


def _batch_pair(rng, sel, cap):
    data = {
        "a": rng.integers(-10**9, 10**9, cap).astype(np.int64),
        "b": rng.integers(-100, 100, cap).astype(np.int8),
        "c": rng.normal(size=cap),
        "d": rng.integers(0, 50, cap).astype(np.int32),
    }
    vb = rng.random(cap) < 0.8
    jschema = JSchema((JField("a", JDT.int64()), JField("b", JDT.int8()),
                       JField("c", JDT.float64()),
                       JField("d", JDT.int32(nullable=True))))
    tschema = TSchema((TField("a", TDT.int64()), TField("b", TDT.int8()),
                       TField("c", TDT.float64()),
                       TField("d", TDT.int32(nullable=True))))
    jb = JBatch({k: jnp.asarray(v) for k, v in data.items()},
                {"d": jnp.asarray(vb)}, jnp.asarray(sel),
                jnp.asarray(int(sel.sum()), jnp.int64), jschema, {})
    tb = TBatch({k: _t(v) for k, v in data.items()}, {"d": _t(vb)},
                _t(sel), torch.tensor(int(sel.sum())), tschema, {})
    return jb, tb


@pytest.mark.parametrize("cap2", [16, 64, 512, 4096])
@pytest.mark.parametrize("mkind", MKINDS)
def test_k3_k4_compact_batch(mkind, cap2):
    rng = np.random.default_rng(cap2)
    cap = 2048
    sel = _mask(mkind, rng, cap)
    jb, tb = _batch_pair(rng, sel, cap)
    jo, jovf = j_compact(jb, cap2)
    to, tovf = t_compact(tb, cap2)
    _same(jovf, tovf, "overflow")
    _same(jo.sel, to.sel, "sel")
    _same(jo.nrows, to.nrows, "nrows")
    for n in jo.cols:
        _same(jo.cols[n], to.cols[n], n)
    for n in jo.valid:
        _same(jo.valid[n], to.valid[n], f"valid {n}")


@pytest.mark.parametrize("m", [1, 100, 3000])
def test_k4_gather_rows(m):
    rng = np.random.default_rng(m)
    n = 1500
    cols = {
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i16": rng.integers(-3000, 3000, n).astype(np.int16),
        "i32": rng.integers(I32.min, I32.max, n, dtype=np.int32),
        "i64": _values("int64_extremes", rng, n),
        "f32": rng.normal(size=n).astype(np.float32),
        "f64": rng.normal(size=n),
        "b": rng.random(n) < 0.5,
    }
    idx = rng.integers(0, n, m).astype(np.int32)
    jo = j_gather({k: jnp.asarray(v) for k, v in cols.items()},
                  jnp.asarray(idx))
    to = t_gather({k: _t(v) for k, v in cols.items()}, _t(idx))
    for k in cols:
        _same(jo[k], to[k], k)


@pytest.mark.parametrize("domains", [[3, 2], [2, 2, 2], [64], [5, 7]])
def test_pack_keys(domains):
    rng = np.random.default_rng(sum(domains))
    cols = [rng.integers(0, d, N).astype(np.int32) for d in domains]
    jp, jd = j_pack([jnp.asarray(c) for c in cols], domains)
    tp, td = t_pack([_t(c) for c in cols], domains)
    assert jd == td
    _same(jp, tp, "packed")


def test_wrappers_reject_mixed_devices():
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels._on_cuda(m, torch.ones(4, device="meta"))


@pytest.mark.parametrize("n_top", [1, 10, 500])
def test_topn_indices(n_top):
    from oceanbase_tpu.ops.sort import topn_indices as j_topn
    from oceanbase_tpu_torch.ops.sort import topn_indices as t_topn

    rng = np.random.default_rng(n_top)
    k = rng.integers(0, 20, N).astype(np.int64)
    m = _mask("random", rng)
    jo, jv = j_topn([jnp.asarray(k)], [True], jnp.asarray(m), n_top)
    to, tv = t_topn([_t(k)], [True], _t(m), n_top)
    _same(jo, to, "order")
    _same(jv, tv, "valid")
