"""K13's single-pass scans (csrc/k13_window_scan.cu), on the CPU.

The CUDA kernels run only on the card (chip_smoke.py's `k13_synthetic`
holds every entry to its plain version there, twice). What surrounds them
is Python, or an algorithm that can be modelled here: the whole scan in
numpy at a small tile (a few lanes, threads and items; chunks of a few
tiles):

- each tile's (flag, value) pairs in scan order (a reverse scan walks the
  tiles from the end and each tile from its last row), folded by each
  thread over its rows, a fixed shuffle tree within the warp, the warps in
  order;
- the tile's aggregate published, then the look-back: the tile's chunk's
  earlier tiles scanned, the nearest chunk prefix published (or a chunk
  whose aggregate holds a segment start, or chunk 0), the later chunks'
  aggregates folded on one by one, the chunk prefixes published in turn;
- walked in random interleavings of the tiles (a tile only ever waits on
  tiles with earlier tickets, at most a few resident at once);

for every mode (the values, the marked segment starts, the marked segment
ends), op (sum, min, max) and direction, against the plain versions and
the JAX package's ops/window.py functions: a ragged last tile, segments
that cross many tiles, a flag on every row and on none, NaN among min/max
values. Every op takes the same pass: its association is fixed, so a
float sum (in double) has the same bits in every interleaving, which the
model shows; the wrapper makes one C call a scan, float sums included.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops import window as JW
from oceanbase_tpu_torch import kernels as K

I64 = 1 << 64


def _wrap(x: int) -> int:
    return ((x + (1 << 63)) % I64) - (1 << 63)


class Shape:
    """The model's tile: `lanes` a warp, `warps` a block, `items` rows a
    thread; `chunk` tiles a chunk (the kernel: 32, 8, 16, 32)."""

    def __init__(self, lanes, warps, items, chunk):
        self.lanes, self.warps, self.items = lanes, warps, items
        self.threads = lanes * warps
        self.rows = self.threads * items
        self.chunk = chunk


SMALL = Shape(4, 2, 3, 3)


def op_of(op, isf):
    def f(a, b):
        if op == "sum":
            return a + b if isf else _wrap(a + b)
        if isf and a != a:
            return a
        if isf and b != b:
            return b
        if op == "min":
            return b if b < a else a
        return b if b > a else a
    return f


def comb(f):
    def c(a, b):
        return (a[0] | b[0], b[1] if b[0] else f(a[1], b[1]))
    return c


def warp_scan(c, xs):
    """The inclusive shuffle scan of one pair a lane (lane l from lanes
    0..l: up = lane l - d's value, then up (+) own, d = 1, 2, 4, ...)."""
    xs = list(xs)
    d = 1
    while d < len(xs):
        xs = [c(xs[i - d], xs[i]) if i >= d else xs[i]
              for i in range(len(xs))]
        d *= 2
    return xs


def pairs(mode, vals, flags, reverse, segmented, n):
    """The (flag, value) pair of every row, and the scan order of rows."""
    f_ext = np.append(np.asarray(flags, bool), True) if flags is not None \
        else np.ones(n + 1, bool)
    idx = np.arange(n)
    if mode == "start":
        v = np.where(f_ext[:n], idx, 0)
        f = np.zeros(n, bool)
    elif mode == "end":
        v = np.where(f_ext[1:], idx, n - 1)
        f = np.zeros(n, bool)
    else:
        v = np.asarray(vals)
        f = ((f_ext[1:] if reverse else f_ext[:n]) if segmented
             else np.zeros(n, bool))
    return f, v


def tile_parts(c, items_pairs, sh: Shape):
    """A tile's rows (pairs in scan order) as the kernel associates them:
    each thread's prefix from the tile's earlier threads (None for none),
    each thread's rows, and the tile's aggregate."""
    mine, per = [], []
    for t in range(sh.threads):
        rows = items_pairs[t * sh.items:(t + 1) * sh.items]
        agg = None
        for p in rows:
            agg = p if agg is None else c(agg, p)
        mine.append(agg)
        per.append(rows)
    L = sh.lanes
    warps = [mine[w * L:(w + 1) * L] for w in range(sh.warps)]
    exc, totals = [], []
    for w, lanes in enumerate(warps):
        # empty threads (past the tile's rows) hold the identity pair
        filled = [x if x is not None else (False, None) for x in lanes]
        inc = warp_scan(lambda a, b: b if a[1] is None else (
            a if b[1] is None else c(a, b)), filled)
        totals.append(inc[-1])
        for i in range(L):
            exc.append(inc[i - 1] if i > 0 else None)
    # earlier warps folded in order
    out = []
    for w in range(sh.warps):
        before = None
        for k in range(w):
            t = totals[k]
            if t[1] is None:
                continue
            before = t if before is None else c(before, t)
        for i in range(L):
            e = exc[w * L + i]
            if e is not None and e[1] is None:
                e = None
            if before is not None:
                e = before if e is None else c(before, e)
            out.append(e)
    total = None
    for t in totals:
        if t[1] is not None:
            total = t if total is None else c(total, t)
    return out, per, total


def scan_model(vals, flags, mode, op, reverse, segmented, sh: Shape, rng,
               resident=3, isf=False):
    """The kernel's scan in numpy: tiles by ticket in random interleavings;
    returns the output in row order."""
    n = len(flags) if flags is not None else len(vals)
    f, v = pairs(mode, vals, flags, reverse, segmented, n)
    c = comb(op_of(op, isf))
    ntiles = -(-n // sh.rows)
    # scan tile q: physical tile p, its rows in scan order
    tiles = []
    for q in range(ntiles):
        p = ntiles - 1 - q if reverse else q
        rows = np.arange(p * sh.rows, min(n, (p + 1) * sh.rows))
        tiles.append(rows[::-1] if reverse else rows)
    conv = float if isf else int
    agg, qv = {}, {}
    out = [None] * n
    state = {}
    waiting = list(range(ntiles))
    running = []
    steps = 0
    while waiting or running:
        while waiting and len(running) < resident:
            running.append(waiting.pop(0))
        q = running[rng.integers(len(running))]
        st = state.setdefault(q, {"phase": 0})
        steps += 1
        assert steps < 100 * (ntiles + 1) ** 2, "the model's look-back hangs"
        rows = tiles[q]
        if st["phase"] == 0:
            ps = [(bool(f[r]), conv(v[r])) for r in rows]
            st["exc"], st["per"], st["total"] = tile_parts(c, ps, sh)
            agg[q] = st["total"]
            st["phase"] = 1
            continue
        if st["phase"] == 1:
            ex = lookback(c, q, agg, qv, sh) if q > 0 else None
            if q > 0 and ex is False:
                continue  # a tile it waits on has not published
            st["carry"] = ex
            st["phase"] = 2
            continue
        # rows out
        for t in range(sh.threads):
            run = st["exc"][t]
            if st["carry"] is not None:
                run = st["carry"] if run is None else c(st["carry"], run)
            for j, p in enumerate(st["per"][t]):
                run = p if run is None else c(run, p)
                out[rows[t * sh.items + j]] = run[1]
        running.remove(q)
    return out


def lookback(c, q, agg, qv, sh: Shape):
    """K13's look-back for scan tile q (False: wait), publishing chunk
    prefixes into qv as the kernel does."""
    ch = sh.chunk
    g, k = divmod(q, ch)
    own = [agg.get(g * ch + i) for i in range(k)]
    if any(a is None for a in own):
        return False
    scan = warp_scan(c, own + [agg[q]])
    loc = scan[k - 1] if k > 0 else None
    chunk_c = scan[-1]
    if g == 0 or (loc is not None and loc[0]):
        if k == ch - 1:
            qv[g] = chunk_c
        return loc
    held, direct = [], False
    for w in range(sh.lanes):
        cc = g - 1 - w
        if cc in qv:
            held.append(qv[cc])
            direct = w == 0
            break
        tiles = [agg.get(cc * ch + i) for i in range(ch)]
        if any(a is None for a in tiles):
            return False
        cagg = warp_scan(c, tiles)[-1]
        held.append(cagg)
        if cagg[0] or cc == 0:
            break
    else:
        return False  # none of `lanes` chunks settles it yet: poll again
    acc = held[-1]
    for x in reversed(held[:-1]):
        acc = c(acc, x)
    if not direct:
        qv[g - 1] = acc
    if k == ch - 1:
        qv[g] = c(acc, chunk_c)
    return c(acc, loc) if loc is not None else acc


# ---- the edge cases ------------------------------------------------------


def flags_of(kind, n, rng):
    if kind == "random":
        f = rng.random(n) < 0.1
    elif kind == "across tiles":
        f = np.zeros(n, bool)
        f[rng.choice(n, max(1, n // 200), replace=False)] = True
    elif kind == "every row":
        f = np.ones(n, bool)
    else:
        f = np.zeros(n, bool)
    return f


def values_of(dt, n, rng):
    if dt in (np.float32, np.float64):
        v = rng.normal(0, 100, n)
        v[rng.random(n) < 0.05] = np.nan
        v[rng.random(n) < 0.05] = -0.0
        return v.astype(dt)
    info = np.iinfo(dt)
    return rng.integers(int(info.min), int(info.max), n,
                        endpoint=True).astype(dt)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype.kind == "f":
        return np.array_equal(got.astype(want.dtype), want, equal_nan=True)
    return np.array_equal(got.astype(want.dtype), want)


SIZES = (1, 5, SMALL.rows - 1, SMALL.rows, SMALL.rows + 1,
         7 * SMALL.rows + 5, 40 * SMALL.rows + 3)
FLAGS = ("random", "across tiles", "every row", "none")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", FLAGS)
def test_k13_model_marks(n, kind):
    rng = np.random.default_rng(n * 7 + len(kind))
    f = flags_of(kind, n, rng)
    starts = scan_model(None, f, "start", "max", False, False, SMALL, rng)
    ends = scan_model(None, f, "end", "min", True, False, SMALL, rng)
    assert same(starts, K.segment_starts_plain(_t(f)).numpy())
    assert same(ends, K.peer_ends_plain(_t(f)).numpy())
    assert same(starts, np.asarray(JW.segment_starts(jnp.asarray(f))))
    assert same(ends, np.asarray(JW.peer_ends(jnp.asarray(f))))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", FLAGS)
@pytest.mark.parametrize("dt", (np.int8, np.int32, np.int64, np.float32,
                                np.float64))
def test_k13_model_segmented_minmax(n, kind, dt):
    rng = np.random.default_rng(n + len(kind) + np.dtype(dt).itemsize)
    f = flags_of(kind, n, rng)
    v = values_of(dt, n, rng)
    isf = np.dtype(dt).kind == "f"
    for is_min in (True, False):
        op = "min" if is_min else "max"
        fwd = scan_model(v, f, "val", op, False, True, SMALL, rng, isf=isf)
        bwd = scan_model(v, f, "val", op, True, True, SMALL, rng, isf=isf)
        tv, tf = _t(v), _t(f)
        assert same(fwd, K.segmented_scan_minmax_plain(tv, tf, is_min))
        assert same(bwd, K.suffix_scan_minmax_plain(tv, tf, is_min))
        assert same(fwd, np.asarray(JW.segmented_scan_minmax(
            jnp.asarray(v), jnp.asarray(f), is_min)))
        assert same(bwd, np.asarray(JW.suffix_scan_minmax(
            jnp.asarray(v), jnp.asarray(f), is_min)))


@pytest.mark.parametrize("n", SIZES)
def test_k13_model_int_sums(n):
    rng = np.random.default_rng(n)
    v = values_of(np.int64, n, rng)
    got = scan_model(v, None, "val", "sum", False, False, SMALL, rng)
    assert same(got, K.prefix_sum_plain(_t(v)).numpy())
    assert same(got, np.asarray(jnp.cumsum(jnp.asarray(v))))


@pytest.mark.parametrize("n", (SMALL.rows + 1, 40 * SMALL.rows + 3,
                               300 * SMALL.rows + 7))
@pytest.mark.parametrize("dt", (np.float32, np.float64))
def test_k13_model_float_sums_have_fixed_bits(n, dt):
    """Three interleavings, 2 to 12 tiles resident: the same bits; within
    rel 1e-12 of the running sum of |x| from the plain version."""
    rng = np.random.default_rng(n)
    v = np.nan_to_num(values_of(dt, n, rng))
    runs = [np.asarray(scan_model(v, None, "val", "sum", False, False,
                                  SMALL, np.random.default_rng(seed),
                                  resident=res, isf=True), np.float64)
            for seed, res in ((1, 2), (2, 5), (3, 12))]
    for r in runs[1:]:
        assert np.array_equal(r.view(np.int64), runs[0].view(np.int64))
    got = runs[0].astype(dt).astype(np.float64)
    want = K.prefix_sum_plain(_t(v.astype(np.float64))).numpy()
    tol = 1e-12 * np.cumsum(np.abs(v.astype(np.float64)))
    if dt == np.float32:
        tol = tol + np.finfo(np.float32).eps * np.abs(want)
    assert (np.abs(got - want) <= tol).all()
    jax_sum = np.asarray(jnp.cumsum(jnp.asarray(v.astype(np.float64))))
    assert (np.abs(got - jax_sum) <= tol + 1e-12 * np.abs(jax_sum)).all()


def test_k13_model_chunk_walks_and_polls():
    """Many tiles and one resident at a time (every chunk prefix is
    published before it is needed) or many (tiles walk back over chunks
    and poll): integer sums equal the plain cumsum either way."""
    rng = np.random.default_rng(8)
    n = 200 * SMALL.rows + 1
    v = values_of(np.int64, n, rng)
    want = K.prefix_sum_plain(_t(v)).numpy()
    for res in (1, 4, 40):
        got = scan_model(v, None, "val", "sum", False, False, SMALL,
                         np.random.default_rng(res), resident=res)
        assert same(got, want)


# ---- the wrapper: one C call a scan ------------------------------------------


class ScanLib:
    """ob_k13_scan recorded; the output written by the plain versions so
    the wrappers' results can be checked too."""

    def __init__(self):
        self.calls = []

    def ob_k13_scan(self, x, dt, flags, mode, op, reverse, segmented, n,
                    out, scratch, ntiles, stream):
        self.calls.append({"mode": mode, "op": op, "reverse": reverse,
                           "segmented": segmented, "n": n, "ntiles": ntiles,
                           "dt": dt})
        return 0


@pytest.mark.parametrize("entry", ("segment_starts", "peer_ends",
                                   "prefix_sum_i64", "prefix_sum_f32",
                                   "prefix_sum_f64", "segmented_min",
                                   "suffix_max"))
def test_k13_one_call_a_scan(entry, monkeypatch):
    lib = ScanLib()
    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_load", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setitem(K.LAUNCHES, "K13_window_scan", 0)
    rng = np.random.default_rng(2)
    n = 3 * K.K13_TILE + 17
    f = _t(rng.random(n) < 0.01)
    v = _t(rng.normal(size=n))
    calls = {
        "segment_starts": lambda: K.segment_starts(f),
        "peer_ends": lambda: K.peer_ends(f),
        "prefix_sum_i64": lambda: K.prefix_sum(v.to(torch.int64)),
        "prefix_sum_f32": lambda: K.prefix_sum(v.to(torch.float32)),
        "prefix_sum_f64": lambda: K.prefix_sum(v),
        "segmented_min": lambda: K.segmented_scan_minmax(v, f, True),
        "suffix_max": lambda: K.suffix_scan_minmax(v, f, False),
    }
    out = calls[entry]()
    assert out.shape == (n,)
    (call,) = lib.calls
    assert K.LAUNCHES["K13_window_scan"] == 1
    assert call["n"] == n and call["ntiles"] == 4
    want = {"segment_starts": (1, 3, 0, 0), "peer_ends": (2, 2, 1, 0),
            "segmented_min": (0, 2, 0, 1), "suffix_max": (0, 3, 1, 1)}
    mode, op, rev, seg = want.get(entry, (0, 1, 0, 0))
    assert (call["mode"], call["op"], call["reverse"],
            call["segmented"]) == (mode, op, rev, seg)


def test_k13_scratch_layout():
    """The ticket, a status word a tile and a chunk (8-byte aligned), then
    an 8-byte aggregate a tile and prefix a chunk."""
    for ntiles, want in ((1, 8 + 8 + 16), (32, 8 + 136 + 8 * 33),
                         (33, 8 + 144 + 8 * 35), (3663, None)):
        got = K.k13_scratch_bytes(ntiles)
        if want is not None:
            assert got == want
        chunks = -(-ntiles // 32)
        assert got % 8 == 0 and got >= 8 + 12 * (ntiles + chunks)
