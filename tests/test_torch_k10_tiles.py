"""K10 (the M:N join expansion) at the shapes its kernel splits on.

The CUDA kernel (csrc/k10_expand_join.cu) works in tiles: a tile of probe
rows finds the window of sorted build keys its live keys span, searches a
staged copy of it (or, past K10_WIN keys, a sample of it and then the
sample's gap), gallops for each run's end, scans the counts and lists the
non-empty runs; a tile of output slots finds the runs that meet it and
writes its slots, the slots past the total taking the reference's clip
values. Here, on the
CPU, the same numpy inputs go through the JAX package's `sort_build_side`
+ `expand_join` and the port's (whose wrapper runs `expand_join_plain` on
CPU tensors), all six outputs compared exactly, at the shapes those tiles
split on: one probe row whose run spans many output tiles, runs across
tile edges, a sorted probe and a random one, a window wider than the
shared tile, the total above, equal to and below the capacity and a
capacity of 0, all dead on either side, int64 extremes. A numpy model of
the kernel's tiling (`_k10_model`, the CUDA code's arithmetic step by
step, at the kernel's tile sizes and at small ones that force every
branch) is held to `expand_join_plain` on the same shapes, and the
wrapper's host logic (the alignment flag, the epoch scratch) is tested
directly. chip_smoke.py's `k10_edge_phase` holds the kernel itself to the
plain version at card sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops import join as JJ
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.ops import join as TJ

I64 = np.iinfo(np.int64)
# the kernel's sizes (csrc/k10_expand_join.cu), and small ones that make
# every tile, window and chunk boundary appear in a few hundred rows
SIZES = {"kernel": dict(tile=2048, win=4096, fill=4096, frows=2048),
         "small": dict(tile=64, win=16, fill=128, frows=8)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _shape(name, seed):
    """(build keys, build sel, probe keys, probe sel) of one shape."""
    rng = np.random.default_rng(seed)
    if name == "long_run":  # one probe row's run spans many output tiles
        bk = np.concatenate([np.full(20_000, 7), rng.integers(8, 5000, 3000)])
        bs = rng.random(bk.size) < 0.9
        pk = rng.integers(8, 5000, 900)
        pk[401] = 7
        ps = rng.random(900) < 0.7
        ps[401] = True
    elif name in ("tile_edges", "random_order"):
        bk = rng.integers(0, 3000, 9000)
        bs = rng.random(9000) < 0.8
        pk = np.sort(rng.integers(0, 3000, 5003))
        ps = rng.random(5003) < 0.6
        if name == "random_order":
            perm = rng.permutation(5003)
            pk, ps = pk[perm], ps[perm]
    elif name == "wide_window":  # fan-out 20: windows past K10_WIN keys
        bk = rng.integers(0, 1500, 30_000)
        bs = np.ones(30_000, bool)
        pk = np.sort(rng.integers(0, 1500, 4500))
        ps = rng.random(4500) < 0.9
    elif name == "dead_build":
        bk = rng.integers(0, 100, 3000)
        bs = np.zeros(3000, bool)
        pk = rng.integers(0, 100, 700)
        ps = rng.random(700) < 0.9
    elif name == "dead_probe":
        bk = rng.integers(0, 100, 3000)
        bs = rng.random(3000) < 0.5
        pk = rng.integers(0, 100, 700)
        ps = np.zeros(700, bool)
    elif name == "int64_extremes":
        bk = rng.integers(-50, 50, 4000)
        bk[:40] = I64.max
        bk[40:80] = I64.min
        bs = rng.random(4000) < 0.7
        pk = rng.integers(-60, 60, 3000)
        pk[::5] = I64.max
        pk[1::7] = I64.min
        ps = rng.random(3000) < 0.8
    elif name == "sparse_sorted":  # Q21's kind: 1.5% of a sorted probe live
        bk = np.sort(rng.integers(0, 5000, 20_000))
        bs = np.arange(20_000) < 19_950
        pk = bk.copy()
        ps = rng.random(20_000) < 0.015
    else:
        raise ValueError(name)
    return bk.astype(np.int64), bs, pk.astype(np.int64), ps


SHAPES = ("long_run", "tile_edges", "random_order", "wide_window",
          "dead_build", "dead_probe", "int64_extremes", "sparse_sorted")


def _total(bk, bs, pk, ps):
    live = np.sort(bk[bs])
    lo = np.searchsorted(live, pk, "left")
    hi = np.searchsorted(live, pk, "right")
    return int(np.where(ps, hi - lo, 0).sum())


def _caps(name, total, npr):
    if name in ("long_run", "tile_edges"):
        return [total, max(total - 1, 0), total + 4097, 0]
    if name == "sparse_sorted":
        return [2 * npr + 1024]
    return [total + 333]


CASES = [(name, cap_ix) for name in SHAPES
         for cap_ix in range(4 if name in ("long_run", "tile_edges") else 1)]


@pytest.mark.parametrize("name,cap_ix", CASES)
def test_expand_join_matches_jax(name, cap_ix):
    """All six outputs of the port's expansion equal the JAX package's."""
    bk, bs, pk, ps = _shape(name, 1910)
    cap = _caps(name, _total(bk, bs, pk, ps), pk.size)[cap_ix]
    js, jo = JJ.sort_build_side([jnp.asarray(bk)], jnp.asarray(bs))
    ts, to = TJ.sort_build_side([_t(bk)], _t(bs))
    nlive = int(bs.sum())
    jr = JJ.expand_join(js, jo, jnp.asarray(nlive, jnp.int64),
                        [jnp.asarray(pk)], jnp.asarray(ps), cap)
    tr = TJ.expand_join(ts, to, torch.tensor(nlive), [_t(pk)], _t(ps), cap)
    names = ("probe_row", "build_row", "valid", "total", "starts", "offs")
    for what, j, t in zip(names, jr, tr):
        j, t = np.asarray(j), t.numpy()
        assert j.dtype == t.dtype and j.shape == t.shape, (name, what)
        np.testing.assert_array_equal(t, j, err_msg=f"{name} cap {cap} "
                                      f"{what}")
    if cap < int(tr[3]):  # truncated: every slot is a live pair
        assert bool(tr[2].all())


@pytest.mark.parametrize("name", SHAPES)
def test_join_ranges_matches_jax(name):
    """The range search alone (the sorted-range semi/anti join's counts)
    against the JAX formula of `_emit_semi_anti`."""
    bk, bs, pk, ps = _shape(name, 1911)
    js, _jo = JJ.sort_build_side([jnp.asarray(bk)], jnp.asarray(bs))
    nlive = int(bs.sum())
    jpk = jnp.asarray(pk)
    lo = jnp.minimum(jnp.searchsorted(js, jpk, side="left"), nlive)
    hi = jnp.minimum(jnp.searchsorted(js, jpk, side="right"), nlive)
    want = np.asarray(jnp.where(jnp.asarray(ps), hi - lo, 0))
    ts, _to = TJ.sort_build_side([_t(bk)], _t(bs))
    got = kernels.join_ranges(ts, torch.tensor(nlive), _t(pk), _t(ps))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# a numpy model of the kernel's tiles
# ---------------------------------------------------------------------------


def _k10_model(skeys, order, nlive, pkey, psel, cap, tile, win, fill,
               frows):
    """The CUDA kernel's two launches in numpy: (a) per tile of probe rows,
    the window [lower(kmin), upper(kmax)) of the live sorted keys, its
    sample (every step-th key, step = ceil(W / win) past win keys), each
    live row's lower bound in the sample then in the sample's gap, its
    upper bound by galloping from it; the counts' scan and the compacted
    list of non-empty runs; (b) per tile of `fill` output slots below the
    total, the runs [p0, p1] that meet its valid slots, staged `frows` at a
    time, each slot's run by a search of the staged ends, the tile's slots
    past the total and every slot after the last such tile taking the clip
    values."""
    npr, nb = pkey.size, order.size
    live_keys = skeys[:nlive]
    cnt = np.zeros(npr, np.int64)
    lo = np.zeros(npr, np.int64)
    for t0 in range(0, npr, tile):
        rows = np.arange(t0, min(t0 + tile, npr))
        lv = rows[psel[rows]]
        if lv.size == 0:
            continue
        kmin, kmax = pkey[lv].min(), pkey[lv].max()
        wlo = int(np.searchsorted(live_keys, kmin, "left"))
        whi = int(np.searchsorted(live_keys, kmax, "right"))
        w = whi - wlo
        step = -(-w // win) if w > win else 1
        m = -(-w // step) if w > 0 else 0
        sample = skeys[wlo + np.arange(m) * step]
        for r in lv:
            key = pkey[r]
            c = int(np.searchsorted(sample, key, "left"))
            if step == 1 or c == 0:
                lor = wlo + c * step
            else:
                gb = wlo + (c - 1) * step + 1
                end = min(wlo + c * step, whi)
                lor = gb + int(np.searchsorted(skeys[gb:end], key, "left"))
            b, d = lor, 1
            while True:  # gallop from lo, then bisect the last stride
                probe = b + d - 1
                if probe >= whi:
                    h = whi
                    break
                if skeys[probe] > key:
                    h = probe
                    break
                b, d = probe + 1, d * 2
            b += int(np.searchsorted(skeys[b:h], key, "right"))
            cnt[r], lo[r] = b - lor, lor
    lo_last = np.searchsorted(live_keys, pkey[npr - 1], "left")
    offs = np.cumsum(cnt)
    starts = offs - cnt
    total = int(offs[-1])
    # the compacted runs: each non-empty row's end, row and lo, in row order
    rows = np.flatnonzero(cnt > 0)
    run_end, run_row, run_lo = offs[rows], rows, lo[rows]
    pr = np.empty(cap, np.int32)
    br = np.empty(cap, np.int32)
    valid = np.zeros(cap, bool)
    b0 = lo_last - starts[npr - 1]

    def clip_values(ts):
        pr[ts] = npr - 1
        br[ts] = order[np.clip((b0 + ts).astype(np.int32), 0, nb - 1)]

    vtiles = -(-min(total, cap) // fill)
    for t0 in range(0, vtiles * fill, fill):
        t1 = min(t0 + fill, cap)
        vend = min(total, t1)
        p0 = int(np.searchsorted(run_end, t0, "right"))
        p1 = int(np.searchsorted(run_end, vend - 1, "right"))
        for c0 in range(p0, p1 + 1, frows):
            k = min(p1 - c0 + 1, frows)
            s_off = np.array([run_end[c0 + i - 1] if c0 + i >= 1 else 0
                              for i in range(k + 1)])
            ts = np.arange(max(t0, s_off[0]), min(vend, s_off[k]))
            i = np.searchsorted(s_off[1:], ts, "right")
            pr[ts] = run_row[c0 + i]
            br[ts] = order[run_lo[c0 + i] + ts - s_off[i]]
            valid[ts] = True
        clip_values(np.arange(vend, t1))
    clip_values(np.arange(vtiles * fill, cap))  # streamed past the tiles
    return pr, br, valid, total, starts, offs


@pytest.mark.parametrize("sizes", sorted(SIZES))
@pytest.mark.parametrize("name,cap_ix", CASES)
def test_tile_model_matches_plain(sizes, name, cap_ix):
    """The kernel's tiling, modelled in numpy, gives expand_join_plain's
    six outputs exactly, at the kernel's tile sizes and at small ones."""
    bk, bs, pk, ps = _shape(name, 1912)
    cap = _caps(name, _total(bk, bs, pk, ps), pk.size)[cap_ix]
    skeys, order = TJ.sort_build_side([_t(bk)], _t(bs))
    nlive = int(bs.sum())
    want = kernels.expand_join_plain(skeys, order, torch.tensor(nlive),
                                     _t(pk), _t(ps), cap)
    got = _k10_model(skeys.numpy(), order.numpy(), nlive, pk, ps, cap,
                     **SIZES[sizes])
    for what, g, w in zip(("probe_row", "build_row", "valid", "total",
                           "starts", "offs"), got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy(),
                                      err_msg=f"{name} {sizes} {what}")


# ---------------------------------------------------------------------------
# the wrapper's host logic
# ---------------------------------------------------------------------------


def test_vector_flag_follows_the_addresses():
    """K10 reads keys 16 bytes and sel 2 bytes a pair only where both
    addresses allow it; a view one element in takes the scalar path."""
    keys = torch.zeros(64, dtype=torch.int64)  # fresh: 64-byte aligned
    sel = torch.zeros(64, dtype=torch.bool)
    assert kernels._k10_vec(keys, sel) == 1
    assert kernels._k10_vec(keys[1:], sel[1:]) == 0
    assert kernels._k10_vec(keys[2:], sel[1:]) == 0
    assert kernels._k10_vec(keys[2:], sel[2:]) == 1


class _ScratchLib:
    """The one entry `_k10_scratch` asks of the library."""

    @staticmethod
    def ob_k10_scratch_bytes(npr):
        return 32 + 32 * (-(-npr // 2048))


def test_scratch_epochs_grow_and_never_repeat():
    """Each expansion on a stream takes the next epoch (the tile statuses
    of earlier calls never match it), and the buffer grows to the largest
    call without shrinking; another stream has its own."""
    dev = torch.device("cpu")
    kernels._K10_SCRATCH.pop((dev.index, 11), None)
    kernels._K10_SCRATCH.pop((dev.index, 12), None)
    b1, e1 = kernels._k10_scratch(_ScratchLib, dev, 11, 5000)
    assert e1 == 1 and b1.numel() * 8 >= _ScratchLib.ob_k10_scratch_bytes(
        5000) and int(b1.abs().sum()) == 0
    b2, e2 = kernels._k10_scratch(_ScratchLib, dev, 11, 100)
    assert e2 == 2 and b2 is b1
    b3, e3 = kernels._k10_scratch(_ScratchLib, dev, 11, 10**6)
    assert e3 == 3 and b3.numel() * 8 >= _ScratchLib.ob_k10_scratch_bytes(
        10**6)
    b4, e4 = kernels._k10_scratch(_ScratchLib, dev, 12, 100)
    assert e4 == 1 and b4 is not b3
    kernels._K10_SCRATCH.pop((dev.index, 11), None)
    kernels._K10_SCRATCH.pop((dev.index, 12), None)
