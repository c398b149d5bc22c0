"""Kernel K23's plain version (`kernels.first_live_plain`: the first k
live rows of a frame, padded with row 0, every column and validity plane
gathered) against the JAX package's two users of the same step: the head
fetch's `_head_gather_impl` (oceanbase_tpu/engine/executor.py:3867) and
the narrowed frame's `_build_narrow` (:3691), bit for bit, on seeded
numpy inputs. The port's narrowed frame is built by its own
`PreparedPlan._build_narrow` over the same batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.core.column import ColumnBatch as JBatch
from oceanbase_tpu.core.dtypes import DataType as JDataType
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.engine import executor as JX
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.core.column import ColumnBatch as TBatch
from oceanbase_tpu_torch.core.dtypes import DataType as TDataType
from oceanbase_tpu_torch.core.dtypes import Field as TField
from oceanbase_tpu_torch.core.dtypes import Schema as TSchema
from oceanbase_tpu_torch.engine import executor as TX

CAP = 3001  # not a multiple of the kernel's 16-row thread strip

# every column type the result frames carry
DTYPES = (np.int64, np.int32, np.int16, np.int8, np.uint8, np.float64,
          np.float32, np.bool_)


def _columns(rng, cap):
    cols = {}
    for dt in DTYPES:
        name = f"c_{np.dtype(dt).name}"
        if dt is np.bool_:
            cols[name] = rng.random(cap) < 0.5
        elif np.dtype(dt).kind == "f":
            a = rng.normal(size=cap).astype(dt) * 1e3
            a[::97] = np.nan
            a[::89] = -0.0
            cols[name] = a
        else:
            info = np.iinfo(dt)
            cols[name] = rng.integers(info.min, info.max, cap, dtype=dt,
                                      endpoint=True)
    # NULL planes of two columns
    valid = {"c_int64": rng.random(cap) < 0.8,
             "c_float32": rng.random(cap) < 0.6}
    return cols, valid


def _sel(kind, rng, cap):
    if kind == "random":
        return rng.random(cap) < 0.3
    if kind == "all_dead":
        return np.zeros(cap, dtype=np.bool_)
    if kind == "all_live":
        return np.ones(cap, dtype=np.bool_)
    s = np.zeros(cap, dtype=np.bool_)
    s[-1] = True  # one live row, at the last index
    return s


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.kind in "fb" else a


def _same(ja, ta, what):
    ja, ta = np.asarray(ja), np.asarray(ta)
    assert ja.dtype == ta.dtype and ja.shape == ta.shape, \
        (what, ja.dtype, ta.dtype, ja.shape, ta.shape)
    assert np.array_equal(_bits(ja), _bits(ta)), what


SELS = ("random", "all_dead", "all_live", "last_only")


@pytest.mark.parametrize("kind", SELS)
@pytest.mark.parametrize("k", (1, 10, 1024, 1800, CAP))
def test_plain_head_gather_equals_jax(kind, k):
    rng = np.random.default_rng(SELS.index(kind) * 100_000 + k)
    cols, valid = _columns(rng, CAP)
    sel = _sel(kind, rng, CAP)
    jc, jv = JX._head_gather_impl(
        {n: jnp.asarray(a) for n, a in cols.items()},
        {n: jnp.asarray(a) for n, a in valid.items()}, jnp.asarray(sel), k)
    names = list(cols) + [f"v:{n}" for n in valid]
    idx, nlive, outs = K.first_live_plain(
        torch.from_numpy(sel), k,
        [torch.from_numpy(cols[n]) for n in cols]
        + [torch.from_numpy(valid[n]) for n in valid])
    want_idx = np.nonzero(sel)[0][:k]
    assert np.array_equal(idx.numpy()[:len(want_idx)], want_idx)
    assert not idx.numpy()[len(want_idx):].any()  # padded with row 0
    assert int(nlive) == int(sel.sum())
    got = dict(zip(names, outs))
    for n in cols:
        _same(jc[n], got[n].numpy(), n)
    for n in valid:
        _same(jv[n], got[f"v:{n}"].numpy(), f"valid {n}")


def test_plain_head_gather_wide_frame_equals_jax():
    """80 columns and validity planes (more than one 48-column write pass
    of the kernel), against the JAX head gather."""
    rng = np.random.default_rng(80)
    cols, valid = {}, {}
    for i in range(40):
        cols[f"c{i}"] = rng.integers(-2**40, 2**40, CAP, dtype=np.int64) \
            if i % 2 else rng.normal(size=CAP).astype(np.float32)
        valid[f"c{i}"] = rng.random(CAP) < 0.7
    sel = rng.random(CAP) < 0.2
    k = 512
    jc, jv = JX._head_gather_impl(
        {n: jnp.asarray(a) for n, a in cols.items()},
        {n: jnp.asarray(a) for n, a in valid.items()}, jnp.asarray(sel), k)
    _idx, nlive, outs = K.first_live(
        torch.from_numpy(sel), k,
        [torch.from_numpy(cols[n]) for n in cols]
        + [torch.from_numpy(valid[n]) for n in valid])
    assert len(outs) == 80 and int(nlive) == int(sel.sum())
    for n, o in zip(cols, outs[:40]):
        _same(jc[n], o.numpy(), n)
    for n, o in zip(valid, outs[40:]):
        _same(jv[n], o.numpy(), f"valid {n}")


class _JPlan:
    """Enough of a JAX PreparedPlan for `_build_narrow`: its program
    returns one fixed batch."""

    def __init__(self, batch):
        ovf = jnp.zeros((0,), jnp.int64)
        self.jitted = lambda inputs, qparams: (batch, ovf)


class _TPlan:
    def __init__(self, batch):
        ovf = torch.zeros(0, dtype=torch.int64)
        self.program = lambda inputs, qparams: (batch, ovf)


def _frames(kind, seed, with_vector=True):
    rng = np.random.default_rng(seed)
    cols, valid = _columns(rng, CAP)
    if with_vector:
        cols["emb"] = rng.normal(size=(CAP, 4)).astype(np.float32)
    sel = _sel(kind, rng, CAP)

    def fields(F, D):
        out = []
        for n, a in cols.items():
            dt = {np.dtype(np.int64): D.int64(), np.dtype(np.int32):
                  D.int32(), np.dtype(np.float64): D.float64()}.get(
                      a.dtype, D.int64())
            out.append(F(n, dt))
        return tuple(out)

    jb = JBatch(cols={n: jnp.asarray(a) for n, a in cols.items()},
                valid={n: jnp.asarray(a) for n, a in valid.items()},
                sel=jnp.asarray(sel), nrows=jnp.int64(int(sel.sum())),
                schema=JSchema(fields(JField, JDataType)), dicts={})
    tb = TBatch(cols={n: torch.from_numpy(a) for n, a in cols.items()},
                valid={n: torch.from_numpy(a) for n, a in valid.items()},
                sel=torch.from_numpy(sel),
                nrows=torch.tensor(int(sel.sum())),
                schema=TSchema(fields(TField, TDataType)), dicts={})
    return jb, tb


@pytest.mark.parametrize("kind", SELS)
@pytest.mark.parametrize("ncap", (1, 256, 1024, 4096))
def test_plain_narrow_frame_equals_jax(kind, ncap):
    """The narrowed frame (K23's compaction + nkeep, lanes and the frame
    overflow derived from nlive), ncap both below and above the live
    count and above the capacity. A frame no wider than ncap goes as it
    is: its live rows, in row order, are the JAX frame's live lanes."""
    jb, tb = _frames(kind, seed=SELS.index(kind) * 100_000 + ncap)
    jnb, _jovf, jnovf = JX.PreparedPlan._build_narrow(_JPlan(jb), ncap)(
        None, ())
    tnb, _tovf, tnovf = TX.PreparedPlan._build_narrow(_TPlan(tb), ncap)(
        None, ())
    assert int(jnovf) == int(tnovf)
    assert int(jnb.nrows) == int(tnb.nrows)
    if ncap >= CAP:
        assert tnb is tb
        jl, tl = np.asarray(jnb.sel), tnb.sel.numpy()
        assert int(jl.sum()) == int(tl.sum())
        for n in jb.cols:
            _same(np.asarray(jnb.cols[n])[jl], tnb.cols[n].numpy()[tl], n)
        for n in jb.valid:
            _same(np.asarray(jnb.valid[n])[jl], tnb.valid[n].numpy()[tl],
                  f"valid {n}")
        return
    _same(jnb.sel, tnb.sel.numpy(), "lanes")
    for n in jb.cols:
        _same(jnb.cols[n], tnb.cols[n].numpy(), n)
    for n in jb.valid:
        _same(jnb.valid[n], tnb.valid[n].numpy(), f"valid {n}")


def test_first_live_routes_cpu_tensors_to_plain():
    sel = torch.tensor([False, True, True, False])
    before = dict(K.LAUNCHES)
    idx, nlive, (c,) = K.first_live(sel, 4, [torch.arange(4) * 3])
    assert K.LAUNCHES == before  # the plain version counts no launch
    assert idx.tolist() == [1, 2, 0, 0] and int(nlive) == 2
    assert c.tolist() == [3, 6, 0, 0]
