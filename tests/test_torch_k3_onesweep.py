"""K3's one-sweep radix sort (csrc/k3_radix_sort.cu), on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them to their
plain version there, twice, on edge cases and at the main path's shapes).
What surrounds them is Python, or an algorithm that can be modelled here:

- the wrapper's plan (`kernels.k3_plan`, `kernels.k3_kept`): constant
  keys dropped, and the longest least significant suffix of keys that the
  rows already follow; spans packed least significant first into
  composites of at most 64 bits and K3_MAX_PACK keys, each in the image
  that moves the fewest bytes (none for a one-pass composite, else 32 or
  64 bits, with the order's row in its low bits where both fit), a pass
  per 8 bits;
- the whole algorithm modelled in numpy at a small tile (a few lanes and
  warps): the key images, the spans, the pack with every pass's
  histogram, the device state that says which buffer holds the image and
  the order, the pass whose digit is constant and moves nothing, the
  ranking of a tile through warp-private counters in (warp, item, lane)
  order, the published counts and the per-digit look-back, walked in
  several random interleavings of the tiles (a tile's index is its
  ticket, so it only ever waits on tiles that started earlier);
- the wrapper itself (`kernels.sort_order`) on CPU tensors, with the
  library replaced by the model, so its spans, composites and buffers
  are what the C entry gets;

all held to `sort_order_plain` and to the JAX package's `sort_indices` on
the edge cases: 0, 1, a tile - 1, a tile and a tile + 1 rows; every row
dead, no row dead; constant keys; spans of 1, 8, 32, 33 and 64 bits; DESC
on the type's minimum; floats with NaN and -0.0; more than one composite.
"""

import contextlib
import ctypes
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.ops.sort import sort_indices as j_sort
from oceanbase_tpu_torch import kernels as K

M64 = (1 << 64) - 1
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)
DT = {np.dtype(bool): 0, np.dtype(np.int8): 1, np.dtype(np.int16): 2,
      np.dtype(np.int32): 3, np.dtype(np.int64): 4, np.dtype(np.float32): 5,
      np.dtype(np.float64): 6, np.dtype(np.uint8): 7}


def image(a, desc: bool) -> np.ndarray:
    """k3_image in numpy: uint64 images whose ascending order is lax.sort's
    order of the key."""
    a = np.asarray(a)
    if a.dtype == bool:
        b = a.astype(np.uint64)
        return np.uint64(1) - b if desc else b
    if a.dtype == np.uint8:
        x = a.astype(np.int64)
        return ((-x if desc else x) % 256).astype(np.uint64)
    if a.dtype.kind == "i":
        x = np.negative(a) if desc else a  # wraps in the key's own width
        return x.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    if a.dtype == np.float32:
        u = a.view(np.uint32).copy()
        if desc:
            u ^= np.uint32(0x80000000)
        mag = u & np.uint32(0x7FFFFFFF)
        u[mag == 0] = 0
        u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
        out = u.astype(np.uint64)
        out[mag > 0x7F800000] = 0xFFFFFFFF
        return out
    u = a.view(np.uint64).copy()
    if desc:
        u ^= np.uint64(1 << 63)
    mag = u & np.uint64(0x7FFFFFFFFFFFFFFF)
    u[mag == 0] = 0
    u = np.where(u & np.uint64(1 << 63), ~u, u | np.uint64(1 << 63))
    u[mag > 0x7FF0000000000000] = np.uint64(M64)
    return u


# ---- the tile: ranking through warp-private counters ----------------------


class Tile:
    """The tile shape of the model: `lanes` lanes a warp, `warps` warps a
    block, `items` keys a lane (the kernel: 32, 8, 16)."""

    def __init__(self, lanes, warps, items):
        self.lanes, self.warps, self.items = lanes, warps, items
        self.rows = lanes * warps * items


def rank_tile(d: np.ndarray, tl: Tile):
    """The staged slot of each of the tile's rows (digits d) and the tile's
    digit counts, as k3_onesweep computes them: warp w owns rows [w L I,
    (w + 1) L I), item i of lane l is its row L i + l; a key's rank is its
    warp's count of the digit so far plus its lower peers; the slot adds
    the earlier warps' counts and the smaller digits' tile count."""
    m = len(d)
    wh = np.zeros((tl.warps, 256), np.int64)
    rk = np.zeros(m, np.int64)
    for w in range(tl.warps):
        for it in range(tl.items):
            base = w * tl.lanes * tl.items + it * tl.lanes
            lanes = [r for r in range(base, base + tl.lanes) if r < m]
            add = {}
            for r in lanes:  # every lane reads the counter, then adds
                peers_below = sum(1 for q in lanes if q < r and d[q] == d[r])
                rk[r] = wh[w, d[r]] + peers_below
                add[d[r]] = add.get(d[r], 0) + 1
            for dig, c in add.items():
                wh[w, dig] += c
    cnt = wh.sum(axis=0)
    off = np.cumsum(wh, axis=0) - wh  # earlier warps' counts
    lbase = np.cumsum(cnt) - cnt
    warp = np.arange(m) // (tl.lanes * tl.items)
    slot = lbase[d] + off[warp, d] + rk
    return slot, cnt, lbase


def onesweep_pass(vals, shift, hist, tl: Tile, rng, resident: int):
    """One digit pass: the position of every row. Blocks start in a random
    order, each takes the next ticket as its tile; at most `resident`
    blocks run at once; every step advances a random running tile. A tile
    publishes its counts (the first tile an inclusive prefix, the others
    an aggregate), then, digit by digit, adds the counts of earlier tiles
    back to the nearest inclusive prefix (waiting while a count is not yet
    published), publishes its inclusive prefix and stores its rows."""
    n = len(vals)
    d = ((vals >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
    gbase = np.cumsum(hist) - hist
    ntiles = -(-n // tl.rows)
    status = {}
    pos = np.full(n, -1, np.int64)
    waited_on = []

    def tile_steps(t):
        rows = slice(t * tl.rows, min(n, (t + 1) * tl.rows))
        slot, cnt, lbase = rank_tile(d[rows], tl)
        for dig in range(256):
            status[t, dig] = ("I" if t == 0 else "A", int(cnt[dig]))
        yield
        excl = np.zeros(256, np.int64)
        if t > 0:
            for dig in range(256):
                j = t - 1
                while True:
                    while (j, dig) not in status:
                        waited_on.append((t, j))
                        yield
                    kind, c = status[j, dig]
                    excl[dig] += c
                    if kind == "I":
                        break
                    j -= 1
            for dig in range(256):
                status[t, dig] = ("I", int(excl[dig] + cnt[dig]))
        yield
        dr = d[rows]
        pos[rows] = gbase[dr] + excl[dr] + slot - lbase[dr]

    launch = list(rng.permutation(ntiles))  # block ids, in start order
    running, ticket = [], 0
    while launch or running:
        while launch and len(running) < resident:
            launch.pop(0)
            running.append(tile_steps(ticket))
            ticket += 1
        g = running[rng.integers(len(running))]
        try:
            next(g)
        except StopIteration:
            running.remove(g)
    assert all(j < t for t, j in waited_on)  # only earlier tickets
    assert sorted(pos.tolist()) == list(range(n))
    return pos


def sort_model(comps, n, tl: Tile, rng, resident=3, moved=None):
    """ob_k3_sort in numpy: comps = [(members [(uint64 image, min, shift)],
    bits, width, rbits)], least significant first. The state of pass g says
    which image (0, 1) and which order (0 identity, 1, 2) it reads, as on
    the device; with rbits the order's row rides the image's low bits and
    the composite's last pass writes it out; `moved` collects whether each
    pass moved rows."""
    state = {0: (0, 0)}
    img = [None, None]
    perm = [None, None]
    out = np.full(n, -1, np.int64)
    g = 0
    for ci, (members, bits, width, rbits) in enumerate(comps):
        npass = -(-bits // 8)
        _isel, psel = state[g]
        j = np.arange(n) if psel == 0 else perm[psel - 1]
        comp = np.zeros(n, np.uint64)
        for im, lo, shift in members:
            comp |= (im[j] - np.uint64(lo)) << np.uint64(shift)
        assert bits == 64 or int(comp.max(initial=0)) < (1 << bits)
        assert bits + rbits <= max(width, 8)
        hist = [np.bincount(((comp >> np.uint64(8 * q)) & np.uint64(255))
                            .astype(np.int64), minlength=256)
                for q in range(npass)]
        row = np.uint64((1 << rbits) - 1)
        if width:
            img[0] = (comp << np.uint64(rbits)) | j.astype(np.uint64)
            if not rbits:
                img[0] = comp.copy()
        for q in range(npass):
            isel, psel = state[g]
            pin = np.arange(n) if psel == 0 else perm[psel - 1]
            last = q == npass - 1
            final = last and ci == len(comps) - 1
            trivial = bool((hist[q] == n).any())
            order_out = not trivial and (last or not rbits)
            pout = 0 if psel == 2 or psel == 0 else 1
            if moved is not None:
                moved.append(not trivial)
            # a composite's top digit is never trivial (its span reaches
            # its top bit), so its last pass always writes the order
            assert not (trivial and last)
            if not trivial:
                vals = comp if width == 0 else img[isel]
                p = onesweep_pass(vals, rbits + 8 * q, hist[q], tl, rng,
                                  resident)
                if width and not last:
                    nxt = np.empty_like(vals)
                    nxt[p] = vals
                    img[1 - isel] = nxt
                if order_out:
                    dst = np.empty(n, np.int64)
                    dst[p] = (vals & row).astype(np.int64) if rbits else pin
                    if final:
                        out[:] = dst
                    else:
                        perm[pout] = dst
            state[g + 1] = (0 if last else isel if trivial else 1 - isel,
                            (2 if psel == 1 else 1) if order_out else psel)
            g += 1
    return out.astype(np.int32)


def unordered(imgs) -> int:
    """k3_span_group's mask over the last K3_MAX_PACK keys, from first =
    max(0, nk - K3_MAX_PACK): bit m - first set when the tuple of keys m..
    decreases somewhere from a row to the next (fits 64 bits for any
    number of keys)."""
    nk, bad = len(imgs), 0
    if len(imgs[0]) < 2:
        return 0
    first = max(0, nk - K.K3_MAX_PACK)
    s = np.zeros(len(imgs[0]) - 1, np.int64)
    for k in range(nk - 1, first - 1, -1):
        a, b = imgs[k][:-1], imgs[k][1:]
        s = np.where(a < b, -1, np.where(a > b, 1, s))
        if (s > 0).any():
            bad |= 1 << (k - first)
    return bad


def model_order(keys, desc, mask, tl: Tile, rng, moved=None):
    """Spans, plan and model, as the wrapper and the C entry run them."""
    n = len(mask)
    allk = [(np.asarray(mask), True)] + list(zip(keys, desc))
    imgs = [image(k, d) for k, d in allk]
    spans = [(int(i.min()), int(i.max())) if n else (M64, 0) for i in imgs]
    plan = K.k3_plan(spans[:K.k3_kept(len(imgs), unordered(imgs))], n)
    if not plan:
        return np.arange(n, dtype=np.int32), plan
    comps = [([(imgs[i], lo, sh) for i, lo, sh in c.members], c.bits,
              c.width, c.rbits) for c in plan]
    return sort_model(comps, n, tl, rng, moved=moved), plan


# ---- the cases ----------------------------------------------------------

SMALL = Tile(4, 2, 2)  # 16 rows a tile


def _spanning(rng, lo, hi, n):
    a = rng.integers(lo, hi, n, endpoint=True)
    a[:2] = (lo, hi)
    return a


def case(name, rng, tile_rows=SMALL.rows):
    """(keys, desc, mask) of a named edge case."""
    n = 150
    live = rng.random(n) < 0.7
    if name.startswith("rows "):
        m = {"0": 0, "1": 1, "t-1": tile_rows - 1, "t": tile_rows,
             "t+1": tile_rows + 1}[name.split()[1]]
        return ([rng.integers(I64.min, I64.max, m, endpoint=True)], [False],
                rng.random(m) < 0.6)
    if name == "flag alone":
        return [], [], live
    if name == "every row dead":
        return [rng.integers(0, 9, n)], [False], np.zeros(n, bool)
    if name == "no row dead":
        return [rng.integers(0, 9, n)], [True], np.ones(n, bool)
    if name == "constant keys":
        return ([np.full(n, 7, np.int32), np.full(n, -2.5)], [False, True],
                np.ones(n, bool))
    if name == "1-bit span":
        return [rng.random(n) < 0.5], [False], np.ones(n, bool)
    if name == "8-bit span":
        return ([_spanning(rng, -100, 155, n).astype(np.int16)], [False],
                np.ones(n, bool))
    if name == "32-bit span":
        return [_spanning(rng, 0, (1 << 32) - 1, n)], [True], np.ones(n, bool)
    if name == "33-bit span":
        return [_spanning(rng, 0, 1 << 32, n)], [False], np.ones(n, bool)
    if name == "64-bit span":
        return [_spanning(rng, I64.min, I64.max, n)], [True], live
    if name == "desc minimums":
        return ([rng.choice(np.array([-128, -1, 0, 127], np.int8), n),
                 rng.choice(np.array([I32.min, -1, 0, I32.max], np.int32), n),
                 rng.choice(np.array([I64.min, -1, 0, I64.max]), n)],
                [True, True, True], live)
    if name == "floats nan -0.0":
        return ([rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf,
                                      1.5, -1.5], np.float32), n),
                 rng.choice(np.array([np.nan, -np.nan, -0.0, 0.0, np.inf,
                                      -np.inf, 2.25]), n)],
                [True, False], live)
    if name == "two composites":
        return ([rng.integers(0, 1 << 30, n) for _ in range(3)],
                [False, True, False], live)
    if name == "trivial digits":
        return ([np.where(rng.random(n) < 0.5, 0, 1 << 20)], [False],
                np.ones(n, bool))
    if name == "suffix in row order":
        # price DESC, then (orderkey, linenumber) of a table stored in
        # orderkey order: only the flag and the price sort
        per = rng.integers(1, 8, n)
        okey = np.repeat(np.arange(1, n + 1) * 4, per)[:n]
        line = (np.arange(n) - np.repeat(np.cumsum(per) - per, per)[:n]
                + 1).astype(np.int8)
        return ([rng.integers(9, 999, n), okey, line], [True, False, False],
                live)
    if name == "tuple in row order, last key not":
        a, b = rng.integers(0, 20, n), rng.integers(0, 9, n)
        idx = np.lexsort((b, a))
        return ([rng.integers(0, 5, n), a[idx], b[idx]],
                [False, False, False], live)
    if name == "ten keys":
        # past K3_MAX_PACK: two span sweeps, the suffix check on the last
        # eight, whose last two the rows follow
        ks = [rng.integers(0, 1 << 7, n) for _ in range(8)]
        return (ks + [np.arange(n) // 9, np.arange(n) % 9], [True] * 10,
                live)
    if name == "seventy keys":
        # a whole-row sort's operands over two tables of 33 nullable
        # columns (a value and a validity plane each), most rows equal on
        # them, then four keys the rows do not follow: past the 64th key,
        # the suffix check on the last eight
        ks = []
        for _ in range(33):
            ks += [(rng.random(n) < 0.01).astype(np.int32),
                   rng.random(n) < 0.99]
        ks += [rng.integers(I64.min, I64.max, n, endpoint=True),
               rng.integers(-9, 9, n).astype(np.int32), rng.random(n) < 0.5,
               rng.integers(-128, 128, n).astype(np.int8)]
        return ks, [False, True] * 35, live
    if name == "uint8 and bool keys":
        return ([rng.integers(0, 256, n).astype(np.uint8),
                 rng.random(n) < 0.5], [True, True], live)
    raise KeyError(name)


CASES = ["rows 0", "rows 1", "rows t-1", "rows t", "rows t+1", "flag alone",
         "every row dead", "no row dead", "constant keys", "1-bit span",
         "8-bit span", "32-bit span", "33-bit span", "64-bit span",
         "desc minimums", "floats nan -0.0", "two composites",
         "trivial digits", "uint8 and bool keys", "suffix in row order",
         "tuple in row order, last key not", "ten keys", "seventy keys"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain(keys, desc, mask):
    return K.sort_order_plain([_t(k) for k in keys], desc, _t(mask)).numpy()


def _jax(keys, desc, mask):
    return np.asarray(j_sort([jnp.asarray(k) for k in keys], desc,
                             jnp.asarray(mask)))


# ---- the plan -----------------------------------------------------------


def test_k3_plan_widths_and_passes():
    """The image that moves the fewest bytes a pass: none up to 8 bits (one
    pass); 32 bits with the row below the keys while both fit, else 32 bits
    beside the order; 64 bits with the row while both fit, else beside the
    order; a pass per 8 bits; constant keys dropped."""
    n = 10  # rows 0..9: 4 bits
    for bits, width, rbits, passes in ((1, 0, 0, 1), (8, 0, 0, 1),
                                       (9, 32, 4, 2), (28, 32, 4, 4),
                                       (29, 32, 0, 4), (32, 32, 0, 4),
                                       (33, 64, 4, 5), (60, 64, 4, 8),
                                       (61, 64, 0, 8), (64, 64, 0, 8)):
        (c,) = K.k3_plan([(7, 7), (5, 5 + (1 << bits) - 1)], n)
        assert (c.bits, c.width, c.rbits, c.passes) == (bits, width, rbits,
                                                        passes)
        assert c.members == ((1, 5, 0),)
        # the dead flag (1 bit) joins the key's composite, most significant
        plan = K.k3_plan([(0, 1), (5, 5 + (1 << bits) - 1)], n)
        if bits < 64:
            assert len(plan) == 1 and plan[0].bits == bits + 1
            assert plan[0].members == ((1, 5, 0), (0, 0, bits))
        else:
            assert [(c.bits, c.width) for c in plan] == [(64, 64), (1, 0)]
    # the row's bits follow the row count: 2^23 rows need 23, 2^23 + 1 24
    assert K.k3_plan([(7, 7), (0, (1 << 35) - 1)], 1 << 23)[0].rbits == 23
    (c,) = K.k3_plan([(7, 7), (0, (1 << 41) - 1)], (1 << 23) + 1)
    assert (c.width, c.rbits) == (64, 0)
    assert K.k3_plan([(7, 7), (0, 3 << 8)], 1)[0].rbits == 1
    assert K.k3_plan([(3, 3), (0, 0)], 10) == []
    assert K.k3_plan([(0, 1)], 0) == []


def test_k3_plan_packing_limits():
    """Least significant first; a composite closes before 64 bits would
    be passed or K3_MAX_PACK keys held."""
    spans = [(0, 1)] + [(0, (1 << 30) - 1)] * 3
    plan = K.k3_plan(spans, 5)
    assert [(c.bits, c.width, c.rbits) for c in plan] == [(60, 64, 3),
                                                           (31, 32, 0)]
    assert [m[0] for m in plan[0].members] == [3, 2]
    assert plan[1].members == ((1, 0, 0), (0, 0, 30))
    spans = [(0, 1)] * (K.K3_MAX_PACK + 3)
    plan = K.k3_plan(spans, 5)
    assert [len(c.members) for c in plan] == [K.K3_MAX_PACK, 3]
    assert [c.width for c in plan] == [0, 0]  # 8 bits and 3 bits
    assert [m[2] for m in plan[0].members] == list(range(K.K3_MAX_PACK))


# ---- the tile model -----------------------------------------------------


@pytest.mark.parametrize("tl", [Tile(4, 2, 2), Tile(8, 3, 1), Tile(2, 1, 3)],
                         ids=["4x2x2", "8x3x1", "2x1x3"])
def test_k3_rank_tile_is_the_stable_digit_order(tl):
    rng = np.random.default_rng(tl.rows)
    for m in (1, tl.rows - 1, tl.rows):
        d = rng.integers(0, 4, m) * 60
        slot, cnt, lbase = rank_tile(d, tl)
        np.testing.assert_array_equal(np.argsort(slot),
                                      np.argsort(d, kind="stable"))
        assert (cnt == np.bincount(d, minlength=256)).all()


@pytest.mark.parametrize("name", CASES)
def test_k3_model_equals_plain_and_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    keys, desc, mask = case(name, rng)
    want = _plain(keys, desc, mask)
    np.testing.assert_array_equal(want, _jax(keys, desc, mask))
    for seed, tl, resident in ((1, SMALL, 3), (2, Tile(8, 3, 1), 1),
                               (3, Tile(2, 1, 3), 7)):
        got, _plan = model_order(keys, desc, mask, tl,
                                 np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {seed}")


def test_k3_kept_drops_the_suffix_in_row_order():
    """The longest suffix whose tuple never decreases drops out; only the
    last K3_MAX_PACK keys are checked; all keys in order: none kept."""
    assert K.k3_kept(4, 0b0011) == 2
    assert K.k3_kept(4, 0b1011) == 2  # keys 2, 3 in order, key 3 alone not
    assert K.k3_kept(4, 0b1111) == 4
    assert K.k3_kept(4, 0) == 0
    nk = K.K3_MAX_PACK + 2
    assert K.k3_kept(nk, 0) == 2
    assert K.k3_kept(nk, (1 << K.K3_MAX_PACK) - 1) == nk
    # the mask counts from the first checked key, so 70 keys fit it: keys
    # 62 and 63 out of order, 64.. in order keeps 64
    assert K.k3_kept(70, 0b11) == 64
    assert K.k3_kept(70, 0b11111111) == 70
    rng = np.random.default_rng(4)
    keys, desc, mask = case("suffix in row order", rng)
    imgs = [image(k, d) for k, d in [(mask, True), *zip(keys, desc)]]
    assert K.k3_kept(4, unordered(imgs)) == 2
    keys, desc, mask = case("tuple in row order, last key not", rng)
    imgs = [image(k, d) for k, d in [(mask, True), *zip(keys, desc)]]
    bad = unordered(imgs)
    assert bad >> 3 & 1 and not bad >> 2 & 1
    assert K.k3_kept(4, bad) == 2


def test_k3_model_skips_trivial_digits():
    """Values 0 and 2^20: 21 bits, three passes; the low two digits are 0
    in every row, so only the third pass moves rows."""
    rng = np.random.default_rng(5)
    keys, desc, mask = case("trivial digits", rng)
    moved = []
    got, plan = model_order(keys, desc, mask, SMALL, rng, moved)
    assert [(c.bits, c.width, c.rbits) for c in plan] == [(21, 32, 8)]
    assert moved == [False, False, True]
    np.testing.assert_array_equal(got, _plain(keys, desc, mask))


def test_k3_model_over_many_tiles():
    """Several hundred tiles and random interleavings: the look-back
    crosses long runs of aggregates."""
    rng = np.random.default_rng(9)
    n = 3000
    keys = [rng.integers(0, 1 << 12, n), rng.integers(-5, 5, n)]
    desc = [True, False]
    mask = rng.random(n) < 0.9
    want = _plain(keys, desc, mask)
    for seed in (11, 12):
        got, plan = model_order(keys, desc, mask, Tile(2, 2, 2),
                                np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    assert [c.bits for c in plan] == [17]


# ---- the wrapper, with the model in place of the library ----------------


class ModelLib:
    """ob_k3_spans / ob_k3_scratch_bytes / ob_k3_sort over CPU tensors: the
    spans from the numpy images, the sort from the model; keeps what
    ob_k3_sort was given."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.sorts = []

    def ob_k3_spans(self, nk, keys, dts, descs, n, mm, nb, stream):
        out = (ctypes.c_uint64 * (2 * nk + 1)).from_address(mm)
        imgs = []
        for k in range(nk):
            t = self.by_ptr[keys[k]]
            assert DT[t.numpy().dtype] == dts[k]
            imgs.append(image(t.numpy(), bool(descs[k])))
            out[2 * k] = ~int(imgs[-1].min()) & M64
            out[2 * k + 1] = int(imgs[-1].max())
        out[2 * nk] = unordered(imgs)
        return 0

    def ob_k3_scratch_bytes(self, nc, bits, n):
        return 64

    def ob_k3_sort(self, nc, nkeys, bits, widths, rbits, keys, dts, descs,
                   mins, shifts, n, scratch, scratch_bytes, img_a, img_b,
                   perm_a, perm_b, out, img_out, nb, stream):
        assert img_out is None  # sort_order asks for the order alone
        comps, m = [], 0
        for c in range(nc):
            members = []
            for _ in range(nkeys[c]):
                t = self.by_ptr[keys[m]]
                assert DT[t.numpy().dtype] == dts[m]
                members.append((image(t.numpy(), bool(descs[m])), mins[m],
                                shifts[m]))
                m += 1
            comps.append((members, bits[c], widths[c], rbits[c]))
        self.sorts.append({"bits": list(bits[:nc]),
                           "widths": list(widths[:nc]),
                           "rbits": list(rbits[:nc]),
                           "images": (img_a, img_b), "perms": (perm_a, perm_b),
                           "scratch_bytes": scratch_bytes})
        order = sort_model(comps, n, SMALL, np.random.default_rng(n))
        ctypes.memmove(out, order.ctypes.data, 4 * n)
        return 0


@pytest.mark.parametrize("name", ["rows 0", "rows t+1", "flag alone",
                                  "constant keys", "1-bit span",
                                  "32-bit span", "33-bit span",
                                  "64-bit span", "two composites",
                                  "floats nan -0.0", "desc minimums",
                                  "suffix in row order", "ten keys",
                                  "seventy keys"])
def test_k3_wrapper_plans_what_the_kernel_gets(name, monkeypatch):
    rng = np.random.default_rng(len(name))
    keys, desc, mask = case(name, rng)
    tk, tm = [_t(k) for k in keys], _t(mask)
    lib = ModelLib([tm, *tk])
    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_load", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda dev: 0)
    monkeypatch.setattr(K, "_blocks", lambda dev, n, per: 1)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setitem(K.LAUNCHES, "K3_radix_sort", 0)
    got = K.sort_order(tk, desc, tm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _plain(keys, desc, mask))
    np.testing.assert_array_equal(got.numpy(), _jax(keys, desc, mask))
    _order, plan = model_order(keys, desc, mask, SMALL,
                               np.random.default_rng(0))
    assert K.LAUNCHES["K3_radix_sort"] == (1 if len(mask) else 0)
    if not plan:
        assert lib.sorts == []
        return
    (call,) = lib.sorts
    assert call["bits"] == [c.bits for c in plan]
    assert call["widths"] == [c.width for c in plan]
    assert call["rbits"] == [c.rbits for c in plan]
    assert call["scratch_bytes"] == 64
    imaged = any(c.width for c in plan)
    assert all((p is not None) == imaged for p in call["images"])
    # an order written before the last pass: two composites, or a 64/32-bit
    # image with the order beside it
    orders = len(plan) > 1 or bool(plan[0].width and not plan[0].rbits)
    assert all((p is not None) == orders for p in call["perms"])
