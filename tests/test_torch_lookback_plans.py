"""K8's single-pass look-back and K26's byte-range work list, on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them to their
plain versions there). What surrounds them is Python, or an algorithm
that can be modelled here:

- K26's plan (`kernels.k26_plan`, walked by `k26_chunk_ranges` as the
  kernel walks it): every byte of
  every (plane, sender) pair is covered by exactly one chunk, at the
  addresses the receive layout wants, and a byte-level model of the
  kernel's walk over the plan (the stripe included) equals
  `exchange_recv_plain`, which tests/test_torch_exchange.py holds to the
  JAX package's collectives;
- K8's tile algorithm, modelled in numpy at a small tile: segment
  starts, the dead-tile shortcut, the per-tile descriptors (last start,
  last piece, leading piece) and the look-back to the tile that holds a
  segment's start, against `segmented_reduce_plain` on the edge cases
  (no live row, a ragged last tile, segments across many tiles, dead rows
  between live ones) and against the JAX package's sort_groupby;
- the by-value and device-memory table layouts of both kernels.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops.hashagg import sort_groupby as j_sort_groupby
from oceanbase_tpu_torch import kernels as K

I64 = 1 << 64


def _wrap(x: int) -> int:
    return ((x + (1 << 63)) % I64) - (1 << 63)


def _comb(op, a, b, isf):
    if op in ("sum", "count"):
        return a + b if isf else _wrap(a + b)
    return min(a, b) if op == "min" else max(a, b)


def k8_model(skeys, ssel, order, aggs, tile):
    """K8's tile algorithm in numpy (csrc/k8_segmented_reduce.cu): every
    tile's local pass first, in any order, then the look-back of each
    tile whose leading segment began earlier and ends in it."""
    n = len(ssel)
    live = np.asarray(ssel, dtype=bool)
    fs = np.zeros(n, dtype=bool)
    fs[0] = True
    fs[1:] = live[1:] != live[:-1]
    both = live[1:] & live[:-1]
    for k in skeys:
        k = np.asarray(k)
        fs[1:] |= both & (k[1:] != k[:-1])
    ntiles = -(-n // tile)
    sel = np.zeros(n, dtype=bool)
    outs, specs = [], []
    for op, v, m in aggs:
        isf = op != "count" and np.asarray(v).dtype.kind == "f"
        if op in ("count", "sum"):
            ident = 0.0 if isf else 0
        elif isf:
            ident = float("inf") if op == "min" else float("-inf")
        else:
            info = np.iinfo(np.asarray(v).dtype)
            ident = int(info.max if op == "min" else info.min)
        outs.append([0.0 if isf else 0] * n)
        specs.append((op, v, m, isf, ident))
    start = [-1] * ntiles
    piece, lead = {}, {}
    closes = [False] * ntiles
    for t in range(ntiles):
        a, b = t * tile, min(n, (t + 1) * tile)
        if not live[a:b].any():
            continue  # zeros already; its start stays -1
        sel[a:b] = fs[a:b] & live[a:b]
        closes[t] = b == n or fs[b]
        st = np.nonzero(fs[a:b])[0]
        start[t] = a + int(st[-1]) if len(st) else -1
        for g, (op, v, m, isf, ident) in enumerate(specs):
            cur, run = -1, ident
            for r in range(a, b):
                x = ident
                if live[r]:
                    src = int(order[r])
                    if m is None or m[src]:
                        x = 1 if op == "count" else (
                            float(v[src]) if isf else int(v[src]))
                if fs[r]:
                    run, cur = x, r
                else:
                    run = _comb(op, run, x, isf)
                    outs[g][r] = 0.0 if isf else 0
                tile_last = r == b - 1
                if tile_last or fs[r + 1]:
                    ends = not tile_last or closes[t]
                    if cur >= 0:
                        outs[g][cur] = run if (live[r] and ends) else (
                            0.0 if isf else 0)
                    elif live[r]:
                        lead[t, g] = run
                if tile_last:
                    piece[t, g] = run
    for t in range(1, ntiles):
        a, b = t * tile, min(n, (t + 1) * tile)
        if fs[a] or not live[a]:
            continue
        if not (closes[t] or fs[a:b].any()):
            continue
        head = max(j for j in range(t) if start[j] >= 0)
        for g, (op, _v, _m, isf, ident) in enumerate(specs):
            acc = ident
            for j in range(t - 1, head - 1, -1):
                acc = _comb(op, piece[j, g], acc, isf)
            outs[g][start[head]] = _comb(op, acc, lead[t, g], isf)
    return sel, outs


def _k8_case(name, rng):
    n = {"ragged": 203, "long": 1000, "dead": 150}.get(name, 400)
    keys = [rng.integers(0, 4, n).astype(np.int32), rng.integers(-2, 2, n)]
    if name == "long":
        # segments of 300 rows: 75 tiles of 4, more than a look-back step
        keys = [np.zeros(n, dtype=np.int32), (np.arange(n) // 300)]
    live = rng.random(n) < 0.6
    if name == "dead":
        live[:] = False
    if name == "alternating":
        live = np.arange(n) % 3 != 1
    v64 = rng.integers(-10**15, 10**15, n)
    v64[::37] = np.iinfo(np.int64).max
    v8 = rng.integers(-128, 128, n).astype(np.int8)
    cents = rng.integers(-10**6, 10**6, n).astype(np.float64)
    mask = rng.random(n) < 0.8
    aggs = [("count", None, None), ("count", None, mask), ("sum", v64, None),
            ("sum", cents, mask), ("min", v8, None), ("max", cents, None),
            ("max", v64, mask)]
    order = rng.permutation(n).astype(np.int32)
    if name != "alternating":
        # sorted order: live rows first, keys ascending within them
        idx = np.lexsort(tuple(reversed([~live, *keys])))
        keys = [k[idx] for k in keys]
        live = live[idx]
    return keys, live, order, aggs


@pytest.mark.parametrize("tile", [4, 16])
@pytest.mark.parametrize("name", ["sorted", "ragged", "long", "dead",
                                  "alternating"])
def test_k8_model_equals_plain(name, tile):
    """The look-back model equals K8's plain version bit for bit: integer
    sums wrap, float sums are integer-valued, min and max exact; every
    row but a live segment's first holds 0."""
    rng = np.random.default_rng(8)
    keys, live, order, aggs = _k8_case(name, rng)
    sel, outs = k8_model(keys, live, order, aggs, tile)
    tsel, touts = K.segmented_reduce_plain(
        [torch.from_numpy(k) for k in keys], torch.from_numpy(live),
        torch.from_numpy(order),
        [(op, None if v is None else torch.from_numpy(v),
          None if m is None else torch.from_numpy(m)) for op, v, m in aggs])
    np.testing.assert_array_equal(sel, tsel.numpy())
    for (op, v, _m), got, want in zip(aggs, outs, touts):
        want = want.numpy()
        got = np.asarray(got, dtype=np.float64 if want.dtype.kind == "f"
                         else np.int64).astype(want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=op)
        assert not got[~sel].any()


def test_k8_model_equals_jax_sort_groupby():
    """The model on the sorted rows equals the JAX package's sort_groupby
    at every group row."""
    rng = np.random.default_rng(81)
    n = 700
    keys = [rng.integers(0, 9, n).astype(np.int32), rng.integers(-3, 3, n)]
    mask = rng.random(n) < 0.7
    vals = rng.integers(-10**9, 10**9, n)
    ops = ["count", "sum", "min", "max"]
    jk, jsel, jaggs, jorder = j_sort_groupby(
        [jnp.asarray(k) for k in keys], jnp.asarray(mask), ops,
        [None, jnp.asarray(vals), jnp.asarray(vals), jnp.asarray(vals)])
    order = np.asarray(jorder).astype(np.int32)
    skeys = [k[order] for k in keys]
    sel, outs = k8_model(skeys, mask[order], order,
                         [(op, None if op == "count" else vals, None)
                          for op in ops], 8)
    s = np.asarray(jsel)
    np.testing.assert_array_equal(sel, s)
    for got, want in zip(outs, jaggs):
        np.testing.assert_array_equal(np.asarray(got)[s],
                                      np.asarray(want)[s])


def test_k8_table_inline_and_device(monkeypatch):
    """K8's table: the keys' addresses, their type codes, seven entries an
    aggregate; up to K8_INLINE entries in the parameters (nothing
    uploaded), past that in device memory."""
    n = 8
    keys = [torch.zeros(n, dtype=torch.int32), torch.zeros(n)]
    v = torch.arange(n)
    aggs = [("count", None, None), ("sum", v, None)]
    raw = [torch.empty(n, dtype=torch.int64) for _ in aggs]
    e = K.k8_table(keys, aggs, raw)
    assert e[:4] == [keys[0].data_ptr(), keys[1].data_ptr(),
                     K.DTYPE_CODE[torch.int32], K.DTYPE_CODE[torch.float32]]
    assert e[4:] == K.k8_agg_entries(aggs, raw)
    assert len(e) == 4 + K.K8_FIELDS * 2
    uploads = []
    monkeypatch.setattr(K, "_device_table",
                        lambda entries, dev: uploads.append(list(entries)))
    inline, table = K.param_table(e, K.K8_INLINE, torch.device("cpu"))
    assert table is None and not uploads
    assert isinstance(inline, ctypes.Array) and list(inline) == e
    wide_keys = [torch.zeros(n, dtype=torch.int16)] * 20
    wide = [("sum", v, None)] * 15
    e = K.k8_table(wide_keys, wide, [raw[0]] * 15)
    assert len(e) == 40 + 7 * 15 > K.K8_INLINE
    inline, _table = K.param_table(e, K.K8_INLINE, torch.device("cpu"))
    assert inline is None and uploads == [e]
    # the scratch: ticket and flags, then starts and two pieces a tile
    assert K.k8_scratch_entries(5, 3) == 1 + 3 + 5 * 7
    assert K.k8_scratch_entries(4, 0) == 1 + 2 + 4


def k26_chunk_ranges(entries, nchunks: int):
    """(segment, byte offset, bytes) of every chunk of a K26 plan, the
    segment found as csrc/k26_exchange_recv.cu finds it: the last whose
    first chunk is at most the chunk's index."""
    nseg = len(entries) // K.K26_FIELDS
    first = [entries[i * K.K26_FIELDS + 3] for i in range(nseg)]
    out = []
    for c in range(nchunks):
        lo, hi = 0, nseg - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if first[mid] <= c:
                lo = mid
            else:
                hi = mid - 1
        off = (c - first[lo]) * K.K26_CHUNK
        nb = entries[lo * K.K26_FIELDS + 2]
        out.append((lo, off, min(K.K26_CHUNK, nb - off)))
    return out


def _planes(rng, rows_in, dtypes, nsend, lane):
    senders = []
    for dt in dtypes:
        blocks = []
        for _s in range(nsend):
            if dt == np.bool_:
                a = rng.random(rows_in) < 0.5
            else:
                a = rng.integers(-100, 100, rows_in).astype(dt)
            blocks.append(torch.from_numpy(a))
        senders.append(blocks)
    return senders


def _run_model(senders, rows, lane, outs, out_base, mask_plane, per_host,
               host_lane):
    """K26's walk over its plan, byte for byte: each chunk's bytes from
    the source address to the destination address, the striped rows
    cleared."""
    entries, nchunks = K.k26_plan(senders, rows, lane, outs, out_base,
                                  mask_plane, per_host)
    mem = [(t.data_ptr(), t.numel() * t.element_size(),
            t.numpy().view(np.uint8))
           for t in [b for bl in senders for b in bl] + list(outs)]

    def at(addr, nb):
        for base, size, arr in mem:
            if base <= addr and addr + nb <= base + size:
                return arr, addr - base
        raise AssertionError(f"address {addr} + {nb} lies in no tensor")

    for seg, off, nb in k26_chunk_ranges(entries, nchunks):
        f = entries[seg * K.K26_FIELDS:(seg + 1) * K.K26_FIELDS]
        sa, so = at(f[0] + off, nb)
        da, do = at(f[1] + off, nb)
        chunk = sa[so:so + nb].copy()
        if f[4] >= 0:
            rowsof = f[4] + off + np.arange(nb)
            chunk[rowsof % per_host != host_lane] = 0
        da[do:do + nb] = chunk
    return entries, nchunks


K26_CASES = {
    # name: (rows, planes' dtypes, senders, lane, out_base, stripe)
    "misaligned": (65_537, [np.bool_, np.int16], 4, 1, 3, None),
    "seven_rows": (7, [np.bool_, np.int16, np.int64], 3, 2, 3, None),
    "one_row": (1, [np.bool_, np.int32], 4, 0, 0, None),
    "many_chunks": (3 * K.K26_CHUNK // 8 + 5, [np.int64, np.bool_], 2, 1,
                    1, None),
    "stripe": (1000, [np.int64, np.bool_, np.int16], 4, 0, 0, (1, 3, 2)),
    "stripe_offset": (999, [np.bool_, np.int32], 4, 1, 5, (0, 4, 1)),
    "wide": (33, [np.int16, np.bool_, np.int64, np.int8] * 10, 4, 1, 2,
             None),
    "no_rows": (0, [np.int64, np.bool_], 4, 0, 0, None),
}


@pytest.mark.parametrize("name", sorted(K26_CASES))
def test_k26_plan_covers_every_byte_once(name):
    rows, dts, nsend, lane, base, stripe = K26_CASES[name]
    rng = np.random.default_rng(26)
    senders = _planes(rng, rows * (lane + 1) + 3, dts, nsend, lane)
    outs = [torch.zeros(base + nsend * rows + 4, dtype=p[0].dtype)
            for p in senders]
    mp, per_host = (stripe[0], stripe[1]) if stripe else (-1, 0)
    entries, nchunks = K.k26_plan(senders, rows, lane, outs, base, mp,
                                  per_host)
    nseg = len(entries) // K.K26_FIELDS
    assert nseg == (len(dts) * nsend if rows else 0)
    covered = {}
    for seg, off, nb in k26_chunk_ranges(entries, nchunks):
        assert 0 < nb <= K.K26_CHUNK and off % K.K26_CHUNK == 0
        covered.setdefault(seg, []).append((off, nb))
    i = 0
    for c, blocks in enumerate(senders):
        esz = outs[c].element_size()
        for s, b in enumerate(blocks):
            if rows == 0:
                continue
            f = entries[i * K.K26_FIELDS:(i + 1) * K.K26_FIELDS]
            assert f[0] == b.data_ptr() + lane * rows * esz
            assert f[1] == outs[c].data_ptr() + (base + s * rows) * esz
            assert f[2] == rows * esz
            assert f[4] == ((base + s * rows) if c == mp else -1)
            spans = sorted(covered[i])
            pos = 0
            for off, nb in spans:
                assert off == pos  # no gap, no overlap
                pos += nb
            assert pos == rows * esz
            i += 1


@pytest.mark.parametrize("name", sorted(K26_CASES))
def test_k26_plan_model_equals_plain(name):
    """The plan walked byte by byte equals exchange_recv_plain: the ring
    and all_to_all offsets, misaligned bool and int16 planes, the stripe
    of the mask plane."""
    rows, dts, nsend, lane, base, stripe = K26_CASES[name]
    rng = np.random.default_rng(62)
    senders = _planes(rng, rows * (lane + 1) + 3, dts, nsend, lane)
    mp, per_host, host_lane = stripe if stripe else (-1, 0, 0)
    size = base + nsend * rows + 4
    got = [torch.zeros(size, dtype=p[0].dtype) for p in senders]
    want = [torch.zeros(size, dtype=p[0].dtype) for p in senders]
    _run_model(senders, rows, lane, got, base, mp, per_host, host_lane)
    K.exchange_recv_plain(senders, rows, lane, want, base, mp, per_host,
                          host_lane)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if stripe:
        kept = got[mp][base:base + nsend * rows]
        r = torch.arange(base, base + nsend * rows)
        assert not kept[r % per_host != host_lane].any()


def test_k26_table_inline_and_device(monkeypatch):
    """Up to K26_INLINE entries (32 segments) ride the parameters, more
    (40 planes from 4 senders) device memory."""
    uploads = []
    monkeypatch.setattr(K, "_device_table",
                        lambda entries, dev: uploads.append(list(entries)))
    rng = np.random.default_rng(3)
    for nplanes, fits in ((8, True), (40, False)):
        senders = _planes(rng, 40, [np.int32] * nplanes, 4, 0)
        outs = [torch.zeros(160, dtype=torch.int32) for _ in senders]
        entries, _n = K.k26_plan(senders, 40, 0, outs)
        assert len(entries) == 5 * 4 * nplanes
        inline, _t = K.param_table(entries, K.K26_INLINE,
                                   torch.device("cpu"))
        assert (inline is not None) == fits
        if fits:
            assert list(inline) == entries
    assert len(uploads) == 1 and len(uploads[0]) == 800
