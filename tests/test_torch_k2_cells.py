"""K2 (the direct GROUP BY) at the shapes its kernel splits on.

The CUDA kernel (csrc/k2_groupby_direct.cu) reduces each distinct
aggregate of a call once (the same op over the same values and mask
tensors), reads each distinct mask once a row, takes a lane's 16 adjacent
rows a chunk by 16-byte loads where the addresses allow (else element by
element), folds each row into the lane's register accumulator of its slot
(8 slots a pass), meets the lanes in a butterfly and keeps its cells per
warp; the last block folds every block's partials in a fixed order. Here, on the
CPU, the same numpy inputs go through the JAX package's `groupby_direct`
(over the packed key, as tests/test_torch_k2_domain.py reaches it; one
call per distinct mask) and the port's `groupby_slots` (its plain version
on CPU tensors): repeated identical aggregates, per-aggregate masks beside
a shared one, int32, int64, float32 and float64 values with NaN under min
and max, more aggregates than one launch takes, views at odd offsets,
lengths not a multiple of 16. A numpy model of the kernel's order of folds
(`_k2_model`: a warp's two chunks, a lane's accumulator a slot in passes
of 8 slots, the lanes' butterfly, warp and block folds, the last block's
lanes and shuffle tree) is held to `groupby_slots_plain`,
and the wrapper's host logic (the deduplication, the split into launches,
the launch images cached by address, dtype, shape and strides) is tested
directly. Tolerance: exact for integers and for min and max (NaN equal to
NaN); float sums rel 1e-12 (a float64 sum in another order), float32 sums
on integer-valued data, exact in any order.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops.hashagg import groupby_direct as j_groupby
from oceanbase_tpu.ops.hashing import pack_keys as j_pack
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.ops.hashing import dense_keys

FLOAT_SUM_RTOL = 1e-12


def _case(name, seed):
    """(key columns, domains, [(op, values | None, mask)]) in numpy."""
    rng = np.random.default_rng(seed)
    n = 5003 if name != "views" else 4099
    doms = [3, 2]
    cols = [rng.integers(0, d, n).astype(np.int32) for d in doms]
    m = rng.random(n) < 0.8
    q = rng.integers(1, 51, n).astype(np.int32)
    p = rng.integers(-2**40, 2**40, n)
    if name == "repeats":
        aggs = [("count", None, m), ("sum", q, m), ("sum", p, m),
                ("count", None, m), ("sum", q, m), ("min", p, m),
                ("count", None, m), ("max", q, m), ("sum", p, m)]
    elif name == "masks":
        m2, m3 = rng.random(n) < 0.5, rng.random(n) < 0.1
        aggs = [("count", None, m), ("sum", q, m2), ("count", None, m3),
                ("max", p, m2), ("sum", p, m), ("min", q, m3)]
    elif name == "floats":
        f64 = rng.standard_normal(n) * 1e3
        f64[::101] = np.nan
        f32 = rng.integers(-1000, 1000, n).astype(np.float32)
        f32[7::211] = np.nan
        fm = m.copy()
        fm[::101] = False
        aggs = [("sum", f64, fm), ("min", f64, m), ("max", f64, m),
                ("sum", f32, fm), ("min", f32, m), ("max", f32, m),
                ("sum", q, m), ("min", p, m)]
    elif name == "split":
        doms = [4, 4, 4]
        cols = [rng.integers(0, 4, n).astype(np.int32) for _ in doms]
        aggs = [(("sum", "min", "max", "count")[i % 4],
                 rng.integers(-10**6, 10**6, n) if i % 4 != 3 else None,
                 rng.random(n) < 0.9) for i in range(40)]
    elif name == "views":
        aggs = [("count", None, m), ("sum", p, m), ("min", q, m),
                ("max", p, m)]
    else:
        raise ValueError(name)
    return cols, doms, aggs


CASES = ("repeats", "masks", "floats", "split", "views")


def _torch_side(cols, doms, aggs, name):
    """The port's inputs; for "views", every tensor a view one to three
    elements into a larger buffer (addresses off 16 bytes, a length that
    is not a multiple of 16)."""
    def t(a, off):
        if name != "views" or a is None:
            return None if a is None else torch.from_numpy(a)
        buf = np.zeros(a.size + off, a.dtype)
        buf[off:] = a
        return torch.from_numpy(buf)[off:]

    keys = dense_keys([torch.from_numpy(c) for c in cols], doms)
    if name == "views":
        keys = t(keys.numpy(), 3)
    return keys, [(op, t(v, 1), t(mk, 3)) for op, v, mk in aggs]


def _jax_side(cols, doms, aggs):
    """The JAX package's results, one groupby_direct per distinct mask."""
    packed, space = j_pack([jnp.asarray(c) for c in cols], doms)
    out = [None] * len(aggs)
    groups: dict = {}
    for i, (_op, _v, mk) in enumerate(aggs):
        groups.setdefault(id(mk), []).append(i)
    for ix in groups.values():
        mk = aggs[ix[0]][2]
        _used, res = j_groupby(packed, space, jnp.asarray(mk),
                               [aggs[i][0] for i in ix],
                               [None if aggs[i][1] is None
                                else jnp.asarray(aggs[i][1]) for i in ix])
        for i, r in zip(ix, res):
            out[i] = np.asarray(r)
    return out


def _agree(got, want, op, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if op == "sum" and np.issubdtype(got.dtype, np.floating):
        both = np.isnan(got) & np.isnan(want)
        assert np.array_equal(np.isnan(got), np.isnan(want)), what
        g, w = got.astype(np.float64), want.astype(np.float64)
        with np.errstate(invalid="ignore"):
            rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
        assert np.all(both | (rel <= FLOAT_SUM_RTOL)), what
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", CASES)
def test_groupby_slots_matches_jax(name):
    """Every aggregate of the port's groupby_slots (its plain version on
    the CPU) equals the JAX package's groupby_direct over the packed key."""
    cols, doms, aggs = _case(name, 2019)
    keys, taggs = _torch_side(cols, doms, aggs, name)
    got = K.groupby_slots(keys, doms, taggs)
    want = _jax_side(cols, doms, aggs)
    for i, ((op, _v, _m), g, w) in enumerate(zip(aggs, got, want)):
        _agree(g.numpy(), w, op, f"{name} aggregate {i} ({op})")


# ---------------------------------------------------------------------------
# a numpy model of the kernel's order of folds
# ---------------------------------------------------------------------------

def _comb(op, a, b, isf):
    if op in ("sum", "count"):
        return a + b
    if isf:  # ob_combine_f64: NaN wins, the first one
        if np.isnan(a):
            return a
        if np.isnan(b):
            return b
    if op == "min":
        return b if b < a else a
    return b if b > a else a


def _k2_model(keys, dense, aggs, nblocks, lane_rows=16, batch=2, width=8,
              warps=8):
    """The kernel in numpy: chunks of 32 x lane_rows rows, taken `batch`
    at a time by warp q mod (nblocks x warps) for batch q; lane l holds rows
    c x 512 + 16 l + j of chunk c. Per aggregate and pass of `width` dense
    slots, each lane folds its rows in order (chunk, then j) into its
    accumulator of the row's slot, the lanes meet in a butterfly (lane k
    keeps slot base + k), which lane k folds into the warp's cell. Blocks
    fold their warps in order; the last block's lane l folds blocks l,
    l + 32, ... in order, then a shuffle tree. Returns each aggregate's
    dense cells."""
    n = keys.size
    chunk = 32 * lane_rows
    gw = nblocks * warps
    info = []
    for op, v, _m in aggs:
        isf = op != "count" and np.issubdtype(v.dtype, np.floating)
        if op in ("count", "sum"):
            ident = 0.0 if isf else 0
        elif isf:
            ident = np.inf if op == "min" else -np.inf
        else:
            ii = np.iinfo(v.dtype)
            ident = int(ii.max if op == "min" else ii.min)
        info.append((isf, ident))
    cells = [[[info[a][1]] * dense for a in range(len(aggs))]
             for _w in range(gw)]
    nchunks = -(-n // chunk)
    for q in range(-(-nchunks // batch)):
        w = q % gw
        rows = [c * chunk + lane * lane_rows + j
                for c in range(q * batch, min(q * batch + batch, nchunks))
                for lane in range(32) for j in range(lane_rows)]
        for a, (op, v, m) in enumerate(aggs):
            isf, ident = info[a]
            for base in range(0, dense, width):
                acc = [[ident] * width for _l in range(32)]
                for r in rows:  # lane-major within a chunk, j inner
                    lane = (r % chunk) // lane_rows
                    if r >= n or not m[r] or not base <= keys[r] < base + width:
                        continue
                    k = keys[r] - base
                    x = 1 if op == "count" else (float(v[r]) if isf
                                                 else int(v[r]))
                    acc[lane][k] = _comb(op, acc[lane][k], x, isf)
                for k in range(min(width, dense - base)):
                    r_l = [acc[lane][k] for lane in range(32)]
                    o = 16
                    while o:
                        r_l = [_comb(op, r_l[lane], r_l[lane ^ o], isf)
                               for lane in range(32)]
                        o >>= 1
                    cells[w][a][base + k] = _comb(op, cells[w][a][base + k],
                                                  r_l[k], isf)
    out = []
    for a, (op, _v, _m) in enumerate(aggs):
        isf, ident = info[a]
        part = []
        for b in range(nblocks):
            row = list(cells[b * warps][a])
            for w in range(1, warps):
                row = [_comb(op, x, y, isf)
                       for x, y in zip(row, cells[b * warps + w][a])]
            part.append(row)
        res = []
        for d in range(dense):
            lane_v = []
            for lane in range(32):
                acc = ident
                for b in range(lane, nblocks, 32):
                    acc = _comb(op, acc, part[b][d], isf)
                lane_v.append(acc)
            o = 16
            while o:
                lane_v = [_comb(op, lane_v[lane], lane_v[lane + o]
                                if lane + o < 32 else lane_v[lane], isf)
                          for lane in range(32)]
                o >>= 1
            res.append(lane_v[0])
        out.append(res)
    return out


@pytest.mark.parametrize("nblocks", [1, 3, 40])
@pytest.mark.parametrize("name", ["repeats", "masks", "floats", "split"])
def test_fold_model_matches_plain(name, nblocks):
    """The kernel's order of folds, modelled in numpy, gives
    groupby_slots_plain's dense cells (exact, float sums rel 1e-12)."""
    cols, doms, aggs = _case(name, 2020)
    dense = K.k2_layout(doms)[0]
    keys = dense_keys([torch.from_numpy(c) for c in cols], doms)
    spread = np.array(K.k2_spread(doms))
    uniq, _ix = K.k2_unique([(op, None if v is None else torch.from_numpy(v),
                              torch.from_numpy(mk)) for op, v, mk in aggs])
    uaggs = [(op, None if v is None else v.numpy(), mk.numpy())
             for op, v, mk in uniq]
    got = _k2_model(keys.numpy(), dense, uaggs, nblocks)
    want = K.groupby_slots_plain(keys, doms, uniq)
    for i, ((op, _v, _m), g, w) in enumerate(zip(uaggs, got, want)):
        w = w.numpy()
        g = np.array(g, dtype=np.float64 if w.dtype.kind == "f"
                     else np.int64)
        keep = spread >= 0
        _agree(g.astype(w.dtype), w[keep][np.argsort(spread[keep])], op,
               f"{name} aggregate {i} ({op}), {nblocks} blocks")


# ---------------------------------------------------------------------------
# the wrapper's host logic
# ---------------------------------------------------------------------------


def _tensors():
    g = torch.Generator().manual_seed(5)
    n = 256
    m = torch.rand(n, generator=g) < 0.5
    v = torch.randint(-9, 9, (n,), generator=g)
    w = torch.randint(-9, 9, (n,), generator=g, dtype=torch.int32)
    return n, m, v, w


def test_unique_reduces_identical_specs_once():
    """The same op over the same values and mask tensors is one distinct
    aggregate (a count's values do not matter); another op, another
    tensor or another view of the same memory is not."""
    n, m, v, w = _tensors()
    buf = torch.zeros(n + 1, dtype=torch.int64)
    aggs = [("count", None, m), ("sum", v, m), ("count", v, m),
            ("sum", v, m), ("min", v, m), ("sum", w, m), ("sum", v, ~m),
            ("sum", buf[1:], m), ("sum", buf[:n], m), ("sum", v.view(-1), m)]
    uniq, index = K.k2_unique(aggs)
    assert index == [0, 1, 0, 1, 2, 3, 4, 5, 6, 1]
    assert [u[0] for u in uniq] == ["count", "sum", "min", "sum", "sum",
                                    "sum", "sum"]


def test_unique_caps_the_rows_a_spec_serves():
    """A distinct aggregate serves at most K2_MAX_OUTS output rows; the
    next repeat starts another."""
    _n, m, _v, _w = _tensors()
    uniq, index = K.k2_unique([("count", None, m)] * (K.K2_MAX_OUTS + 6))
    assert len(uniq) == 2
    assert index == [0] * K.K2_MAX_OUTS + [1] * 6


@pytest.mark.parametrize("dense,naggs,nmasks,repeats", [
    (6, 10, 1, 1), (64, 40, 1, 1), (64, 40, 40, 1), (1, 70, 3, 1),
    (6, 20, 2, 5), (12, 33, 9, 1)])
def test_split_respects_every_launch_limit(dense, naggs, nmasks, repeats):
    """Each launch of `k2_split` holds at most K2_MAX_AGGS distinct
    aggregates, K2_MAX_MASKS distinct masks, K2_CELLS cells and
    K2_MAX_OUTS output rows; the launches cover every aggregate once, in
    order, and no two neighbouring launches could have been one."""
    n = 64
    masks = [torch.rand(n) < 0.5 for _ in range(nmasks)]
    vals = [torch.randint(0, 9, (n,)) for _ in range(naggs)]
    aggs = [("sum", vals[i], masks[i % nmasks]) for i in range(naggs)
            for _r in range(repeats)]
    uniq, index = K.k2_unique(aggs)
    groups = K.k2_split(uniq, index, dense)
    assert [u for g in groups for u in g] == list(range(len(uniq)))
    outs = [index.count(u) for u in range(len(uniq))]

    def fits(g):
        return (len(g) <= K.K2_MAX_AGGS and len(g) * dense <= K.K2_CELLS
                and len({K._k2_id(uniq[u][2]) for u in g}) <= K.K2_MAX_MASKS
                and sum(outs[u] for u in g) <= K.K2_MAX_OUTS)

    assert all(fits(g) for g in groups)
    assert all(not fits(a + b[:1]) for a, b in zip(groups, groups[1:]))


def _decode(blob):
    hdr = K._K2_HDR.unpack_from(blob, 0)
    aggs = [K._K2_AGG.unpack_from(blob, K._K2_HDR.size + i * K._K2_AGG.size)
            for i in range(hdr[15])]
    off = K._K2_HDR.size + K.K2_MAX_AGGS * K._K2_AGG.size
    outs = [K._K2_OUT.unpack_from(blob, off + i * K._K2_OUT.size)
            for i in range(hdr[17])]
    return hdr, aggs, outs


def test_plan_image_and_cache():
    """The launch image of a call: keys, distinct masks, sizes, the
    alignment bits (a view one element in is not 16-byte aligned), each
    distinct aggregate's values, identity, type, op and mask index, and
    an output row per aggregate of the call in its output type; the plan
    is cached by each tensor's address, dtype, shape and strides."""
    n, m, v, w = _tensors()
    f = torch.rand(n + 1, dtype=torch.float32)[1:]
    keys = torch.randint(0, 6, (n,), dtype=torch.int32)
    notm = ~m
    aggs = [("count", None, m), ("sum", v, m), ("min", w, notm),
            ("count", None, m), ("max", f, m)]
    K._K2_PLANS.clear()
    plan = K.k2_plan(keys, [3, 2], aggs, 132)
    assert K.k2_plan(keys, [3, 2], aggs, 132) is plan
    assert len(plan.launches) == 1 and plan.slots == 8
    blob = plan.launches[0].blob
    assert len(blob) == K._K2_HDR.size + K.K2_MAX_AGGS * K._K2_AGG.size \
        + K.K2_MAX_OUTS * K._K2_OUT.size
    hdr, entries, outs = _decode(blob)
    assert hdr[0] == keys.data_ptr()
    assert hdr[1:4] == (m.data_ptr(), notm.data_ptr(), 0)
    assert hdr[9:12] == (n, 8, 0)  # rows, packed slots, domain-1 bits
    assert hdr[13:19] == (K.DTYPE_CODE[torch.int32], 6, 4, 2, 5, 2)
    aligned = hdr[12]
    assert aligned & 1 and aligned >> 1 & 1 and aligned >> 2 & 1
    assert not aligned >> (9 + 3) & 1  # the float view, one element in
    assert [(e[0], e[3], e[5]) for e in entries] == [
        (0, K.AGG_CODE["count"], 0), (v.data_ptr(), K.AGG_CODE["sum"], 0),
        (w.data_ptr(), K.AGG_CODE["min"], 1),
        (f.data_ptr(), K.AGG_CODE["max"], 0)]
    assert entries[2][1] == 2**31 - 1  # int32 min's identity
    assert entries[3][1] == struct.unpack("<q", struct.pack(
        "<d", float("-inf")))[0] and entries[3][4] == 1
    assert [o[:3] for o in outs] == [
        (0, 0, K.DTYPE_CODE[torch.int64]), (1, 1, K.DTYPE_CODE[torch.int64]),
        (2, 2, K.DTYPE_CODE[torch.int32]), (0, 3, K.DTYPE_CODE[torch.int64]),
        (3, 4, K.DTYPE_CODE[torch.float64])]
    assert plan.views[4] == (torch.float64, torch.float32)
    # the same memory seen with another dtype is another plan
    other = K.k2_plan(keys, [3, 2], aggs[:2] + [
        ("min", w.view(torch.float32), notm)], 132)
    assert other is not plan and _decode(other.launches[0].blob)[1][2][2] \
        == K.DTYPE_CODE[torch.float32]
    # a strided view at a cached contiguous tensor's address, dtype and
    # shape misses the cache and is refused
    wide = torch.zeros(2 * n, dtype=torch.int32)
    K.k2_plan(keys, [3, 2], [("sum", wide[:n], m)], 132)
    with pytest.raises(ValueError, match="contiguous"):
        K.k2_plan(keys, [3, 2], [("sum", wide[::2], m)], 132)
    K._K2_PLANS.clear()
