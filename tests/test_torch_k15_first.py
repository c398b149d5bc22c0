"""K15's routes (csrc/k15_distinct_first.cu) for DISTINCT aggregates, on
the CPU.

The CUDA kernels run only on the card (chip_smoke.py's `k15_synthetic`
holds each route to `first_occurrence_plain` there, bit for bit, on the
route the rule gives). What surrounds them is Python, or an algorithm that
can be modelled here:

- the route rule (`kernels.k15_route`) on K3's plan with the row inside
  its images (`k3_plan(..., row_inside=True)`) and `k3_kept`, from spans
  of the numpy key images: every edge case goes to the route named for it,
  chip_smoke's cases too;
- the image route modelled in numpy: K3's images built from the plan,
  sorted, each image's key bits compared with its neighbour's, the row
  taken from the low bits, the dead flag from its bit (or constant);
- the record route: each row's keys packed into a record of 8, 16 or 32
  bytes (widest first, -0.0 as 0.0, a NaN bit and the live bit in the
  last byte), the order walked, records compared by their bytes;
- the columns route (and the rows route, in row order);
- the wrapper itself (`ops.hashagg.distinct_first_mask` through
  `sort_order_images`, `first_occurrence_images` and `first_occurrence`)
  on CPU tensors with those models as its library, so the plans, layouts
  and arguments are what the C entries get;

each held to `first_occurrence_plain` and to the JAX package's
`distinct_first_mask` on: ties; dead rows between live ones; no live row;
one row; a constant key; keys already in row order (the dropped suffix);
keys past 64 bits; float keys with NaN and -0.0; 17 keys. One known
difference: the port images -0.0 and 0.0 alike and takes a run's lowest
row; a backend whose sort puts -0.0 before 0.0 may mark another row of
that run. Where the masks differ, they may differ only inside such runs,
and the DISTINCT aggregates over the marked rows must still be equal
(`_jax_agrees`). Then Session twins of count/sum/avg DISTINCT, grouped
and ungrouped, over nullable keys.
"""

import contextlib
import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from oceanbase_tpu.engine.session import Session as JSession
from oceanbase_tpu.models.tpch import datagen as JD
from oceanbase_tpu.ops.hashagg import distinct_first_mask as j_first
from oceanbase_tpu_torch import kernels as K
from oceanbase_tpu_torch.engine.session import Session as TSession
from oceanbase_tpu_torch.models.tpch import datagen as TD
from oceanbase_tpu_torch.models.tpch.sql_suite import UNIQUE_KEYS
from oceanbase_tpu_torch.ops import hashagg as H
from tests.test_torch_k3_onesweep import image, unordered
from tests.torch_twins import check_twin

M64 = (1 << 64) - 1


def _tdtype(a) -> torch.dtype:
    return torch.from_numpy(np.asarray(a)[:0].copy()).dtype


def plan_of(cols, mask):
    """What `sort_order_images` decides from the spans: (route, the plan
    with the row inside, kept, nk, the images of (dead, keys...), spans)."""
    allk = [(np.asarray(mask), True)] + [(np.asarray(c), False) for c in cols]
    imgs = [image(a, d) for a, d in allk]
    n = len(mask)
    spans = [(int(i.min()), int(i.max())) for i in imgs]
    kept = K.k3_kept(len(allk), unordered(imgs))
    plan = K.k3_plan(spans[:kept], n, True)
    route = K.k15_route(plan, kept, len(allk), [_tdtype(c) for c in cols])
    return route, plan, kept, len(allk), imgs, spans


# ---- the routes, modelled ---------------------------------------------------


def composite_images(plan, imgs, n):
    """K3's images of the plan's one composite: the keys' images minus
    their span's low end, shifted into place, above the row."""
    (c,) = plan
    comp = np.zeros(n, np.uint64)
    for i, lo, sh in c.members:
        comp |= (imgs[i] - np.uint64(lo)) << np.uint64(sh)
    return (comp << np.uint64(c.rbits)) | np.arange(n, dtype=np.uint64)


def image_model(images, rbits, dead_bit, live):
    """The image route: sorted images (the row in the low rbits bits), a
    run starts where the key bits change; first[row] where it is live."""
    srt = np.sort(np.asarray(images, dtype=np.uint64))
    n = len(srt)
    key = srt >> np.uint64(rbits)
    row = (srt & np.uint64((1 << rbits) - 1)).astype(np.int64)
    new = np.ones(n, bool)
    new[1:] = key[1:] != key[:-1]
    if dead_bit >= 0:
        lv = ((srt >> np.uint64(dead_bit)) & np.uint64(1)) == 0
    else:
        lv = np.full(n, bool(live))
    first = np.zeros(n, bool)
    first[row[new & lv]] = True
    return first


def image_route_model(cols, mask):
    route, plan, _kept, _nk, imgs, spans = plan_of(cols, mask)
    assert route == "image"
    (c,) = plan
    dead = [sh for i, _lo, sh in c.members if i == 0]
    return image_model(composite_images(plan, imgs, len(mask)), c.rbits,
                       c.rbits + dead[0] if dead else -1,
                       int(not dead and spans[0][1] == 0))


def pack_records(cols, mask):
    """The record route's pack: a record a row of `rb` bytes, each key at
    its offset (-0.0 as 0.0, a NaN as 0 with the NaN bit), the live bit and
    the NaN bit in the last byte."""
    rb, offs = K.k15_record_layout([_tdtype(c) for c in cols])
    n = len(mask)
    rec = np.zeros((n, rb), np.uint8)
    nan = np.zeros(n, bool)
    for c, off in zip(cols, offs):
        a = np.array(c)
        if a.dtype.kind == "f":
            bad = np.isnan(a)
            nan |= bad
            a = np.where(bad | (a == 0), 0, a).astype(a.dtype)
        w = a.dtype.itemsize
        rec[:, off:off + w] = a.view(np.uint8).reshape(n, w)
    rec[:, rb - 1] = np.asarray(mask, np.uint8) | (nan.astype(np.uint8) << 1)
    return rec


def record_model(rec, order):
    """The record route's walk: the records in sorted order, a run starts
    where a record's bytes differ from the previous one or it holds a NaN
    key; first[row] where it is live."""
    order = np.asarray(order, np.int64)
    srec = rec[order]
    n, rb = rec.shape
    new = np.ones(n, bool)
    new[1:] = (srec[1:] != srec[:-1]).any(1)
    new |= (srec[:, rb - 1] & 2) != 0
    first = np.zeros(n, bool)
    first[order[new & ((srec[:, rb - 1] & 1) != 0)]] = True
    return first


def columns_model(cols, mask, order):
    """The columns route (order None: the rows route, in row order): the
    live flag and every key compared with `!=` at each sorted row."""
    n = len(mask)
    order = np.arange(n) if order is None else np.asarray(order, np.int64)
    live = np.asarray(mask)[order]
    new = np.ones(n, bool)
    new[1:] = live[1:] != live[:-1]
    for c in cols:
        s = np.asarray(c)[order]
        new[1:] |= s[1:] != s[:-1]
    first = np.zeros(n, bool)
    first[order[new & live]] = True
    return first


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def plain(cols, mask):
    tc, tm = [_t(c) for c in cols], _t(mask)
    order = K.sort_order_plain(tc, [False] * len(tc), tm)
    return K.first_occurrence_plain(tc, tm, order).numpy(), order.numpy()


def _jax_agrees(got, cols, mask):
    """got (the port's mask) against the JAX package's: equal, or unequal
    only inside runs where -0.0 and 0.0 meet, with the DISTINCT count and
    sum of the value per group of keys equal over the marked rows."""
    want = np.asarray(j_first([jnp.asarray(c) for c in cols[:-1]],
                              jnp.asarray(cols[-1]), jnp.asarray(mask)))
    if np.array_equal(got, want):
        return True
    v = np.asarray(cols[-1])
    diff = got != want
    assert v.dtype.kind == "f" and bool((v[diff] == 0).all()), \
        "the masks differ outside runs of -0.0 and 0.0"

    def aggregate(m):
        out = {}
        for r in np.nonzero(m)[0]:
            key = tuple(np.asarray(c)[r].item() for c in cols[:-1])
            cnt, tot = out.get(key, (0, 0.0))
            out[key] = (cnt + 1, tot + float(v[r]))
        return out

    assert aggregate(got) == aggregate(want)
    return True


def _cols(rng, kind, n):
    if kind == "ties":
        return ([rng.integers(0, 7, n).astype(np.int32),
                 rng.integers(0, 300, n)], rng.random(n) < 0.8)
    if kind == "dead rows between live ones":
        return ([rng.integers(0, 1000, n), rng.integers(0, 90, n)],
                (np.arange(n) // 37) % 3 != 1)
    if kind == "no live row":
        return ([rng.integers(0, 7, n), rng.integers(0, 1 << 12, n)],
                np.zeros(n, bool))
    if kind == "every row live":
        return ([rng.integers(0, 7, n), rng.integers(0, 1 << 12, n)],
                np.ones(n, bool))
    if kind == "one row":
        return [np.array([4]), np.array([9])], np.ones(1, bool)
    if kind == "a constant key":
        return ([np.full(n, 7, np.int32), rng.integers(0, 700, n)],
                rng.random(n) < 0.7)
    if kind == "keys in row order":
        return ([np.sort(rng.integers(0, 50, n)), np.arange(n) // 3],
                np.ones(n, bool))
    if kind == "a value in row order":
        return ([rng.integers(0, 9, n).astype(np.int32), np.arange(n)],
                rng.random(n) < 0.6)
    if kind == "keys past 64 bits":
        i64 = np.iinfo(np.int64)
        big = rng.integers(i64.min, i64.max, n)
        return ([big, rng.permutation(np.concatenate([big[: n // 2]] * 2))],
                rng.random(n) < 0.9)
    if kind == "float keys with NaN and -0.0":
        v = rng.integers(-4, 4, n) / 2
        v[rng.random(n) < 0.1] = np.nan
        z = v == 0
        v[z] = rng.choice([0.0, -0.0], int(z.sum()))
        return [rng.integers(0, 5, n).astype(np.int32), v], \
            rng.random(n) < 0.85
    if kind == "float32 beside int8":
        v = (rng.integers(-4, 4, n) / 2).astype(np.float32)
        v[rng.random(n) < 0.1] = np.nan
        v[v == 0] = -0.0
        return [rng.integers(-3, 3, n).astype(np.int8), v], \
            rng.random(n) < 0.85
    if kind == "17 keys":
        return ([rng.integers(0, 2, n).astype(np.int32) for _ in range(17)],
                rng.random(n) < 0.8)
    if kind == "17 narrow keys":
        return ([rng.integers(0, 2, n).astype(np.int8) for _ in range(17)],
                rng.random(n) < 0.8)
    if kind == "one-pass composite":
        return ([rng.integers(0, 2, n).astype(np.bool_),
                 rng.integers(0, 3, n).astype(np.int8)], rng.random(n) < 0.8)
    raise KeyError(kind)


CASES = {
    "ties": "image",
    "dead rows between live ones": "image",
    "no live row": "image",
    "every row live": "image",
    "one row": "rows",
    "a constant key": "image",
    "keys in row order": "rows",
    "a value in row order": "record",
    "keys past 64 bits": "record",
    "float keys with NaN and -0.0": "record",
    "float32 beside int8": "record",
    "17 keys": "columns",
    "17 narrow keys": "record",
    "one-pass composite": "record",
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_k15_route_models_equal_plain_and_jax(kind):
    rng = np.random.default_rng(len(kind))
    cols, mask = _cols(rng, kind, 3000)
    route, _plan, _kept, _nk, _imgs, _spans = plan_of(cols, mask)
    assert route == CASES[kind]
    want, order = plain(cols, mask)
    assert _jax_agrees(want, cols, mask)
    models = {"columns": columns_model(cols, mask, order)}
    if route == "image":
        models["image"] = image_route_model(cols, mask)
    if route == "rows":
        assert np.array_equal(order, np.arange(len(mask)))
        models["rows"] = columns_model(cols, mask, None)
    if K.k15_record_layout([_tdtype(c) for c in cols]) is not None:
        models["record"] = record_model(pack_records(cols, mask), order)
    assert route in models
    for name, got in models.items():
        assert np.array_equal(got, want), f"{kind}: the {name} model"


@functools.lru_cache(maxsize=1)
def _smoke_cases():
    return {c[0]: c for c in chip_smoke.k15_cases(rows=1 << 20, big=1 << 16)}


@pytest.mark.parametrize("what", [c[0] for c in chip_smoke.k15_cases(
    rows=1 << 12, big=1 << 12)])
def test_k15_chip_smoke_cases_take_their_routes(what):
    """chip_smoke's edge cases at their card sizes go to the route it
    requires there (the last one's spans taken at 2^16 rows, its plan at
    the card's 2^24)."""
    _what, cols, mask, route = _smoke_cases()[what]
    if what != "many rows":
        assert plan_of(cols, mask)[0] == route
        return
    _r, _p, kept, nk, _imgs, spans = plan_of(cols, mask)
    plan = K.k3_plan(spans[:kept], 1 << 24, True)
    assert K.k15_route(plan, kept, nk, [_tdtype(c) for c in cols]) == route


def test_k15_record_layout():
    """Widest key first, each on its own alignment, the flag byte last;
    past 31 key bytes there is no record."""
    i8, i16, i32, i64 = torch.int8, torch.int16, torch.int32, torch.int64
    f32, f64, b = torch.float32, torch.float64, torch.bool
    assert K.k15_record_layout([i8, f32]) == (8, [4, 0])
    assert K.k15_record_layout([i32, i64]) == (16, [8, 0])
    assert K.k15_record_layout([i32, i32, i64]) == (32, [8, 12, 0])
    assert K.k15_record_layout([i64, f64, i16, b]) == (32, [0, 8, 16, 18])
    assert K.k15_record_layout([i64] * 3 + [i32, i16, i8]) == (32, [
        0, 8, 16, 24, 28, 30])
    assert K.k15_record_layout([i64] * 4) is None
    assert K.k15_record_layout([i32] * 17) is None
    assert K.k15_record_layout([i8] * 31) == (32, list(range(31)))
    assert K.k15_record_layout([i8] * 32) is None


def test_k15_route_rule_by_plan():
    """The rule on hand-made plans: the row inside one composite and no
    dropped key -> image; floats, several composites, a dropped suffix, a
    one-pass composite or an image without the row -> record, or columns
    past 32 bytes; an empty plan -> rows."""
    one = [K.K3Composite(((0, 0, 20),), 21, 64, 26)]
    i32, f64 = torch.int32, torch.float64
    assert K.k15_route(one, 3, 3, [i32, i32]) == "image"
    assert K.k15_route(one, 3, 3, [i32, f64]) == "record"
    assert K.k15_route(one, 2, 3, [i32, i32]) == "record"
    assert K.k15_route(one * 2, 3, 3, [i32, i32]) == "record"
    assert K.k15_route([K.K3Composite(((0, 0, 0),), 7, 0, 0)], 3, 3,
                       [i32, i32]) == "record"
    assert K.k15_route([K.K3Composite(((0, 0, 0),), 40, 64, 0)], 3, 3,
                       [i32, i32]) == "record"
    assert K.k15_route(one * 2, 3, 3, [i32] * 8) == "columns"
    assert K.k15_route([], 0, 3, [f64, f64]) == "rows"
    # the row rides inside a 64-bit image where the 32-bit one beside the
    # order moves as many bytes a pass: K15 takes the former
    assert K.k3_plan([(0, 1), (0, (1 << 20) - 1)], 1 << 26)[0].rbits == 0
    c = K.k3_plan([(0, 1), (0, (1 << 20) - 1)], 1 << 26, True)[0]
    assert (c.width, c.rbits) == (64, 26)


# ---- the wrapper, with the models as its library -----------------------


class ModelLib:
    """The C entries of K3 and K15 over CPU memory: the spans and the sort
    from the numpy images (the sort's last pass writes the images where it
    is given img_out), K15's three entries from the route models; records
    which K15 entry ran and with what."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []

    def _np(self, ptr, dtype, n):
        return np.ctypeslib.as_array(
            (ctypes.c_uint8 * (n * np.dtype(dtype).itemsize)).from_address(
                ptr)).view(dtype)

    def _keys(self, ncols, table):
        t = self._np(table, np.int64, 3 * ncols)
        return [self.by_ptr[int(t[j])].numpy() for j in range(ncols)], t

    def ob_k3_spans(self, nk, keys, dts, descs, n, mm, nb, stream):
        out = (ctypes.c_uint64 * (2 * nk + 1)).from_address(mm)
        imgs = []
        for k in range(nk):
            imgs.append(image(self.by_ptr[keys[k]].numpy(), bool(descs[k])))
            out[2 * k] = ~int(imgs[-1].min()) & M64
            out[2 * k + 1] = int(imgs[-1].max())
        out[2 * nk] = unordered(imgs)
        return 0

    def ob_k3_scratch_bytes(self, nc, bits, n):
        return 64

    def ob_k3_sort(self, nc, nkeys, bits, widths, rbits, keys, dts, descs,
                   mins, shifts, n, scratch, scratch_bytes, img_a, img_b,
                   perm_a, perm_b, out, img_out, nb, stream):
        comps, m = [], 0
        for c in range(nc):
            comp = np.zeros(n, np.uint64)
            for _ in range(nkeys[c]):
                img = image(self.by_ptr[keys[m]].numpy(), bool(descs[m]))
                comp |= (img - np.uint64(mins[m])) << np.uint64(shifts[m])
                m += 1
            comps.append(comp)
        order = np.lexsort(comps).astype(np.int32)  # stable: ties by row
        if img_out is not None:
            assert nc == 1 and rbits[0] > 0 and out is None
            imgs = (comps[0] << np.uint64(rbits[0])) | np.arange(
                n, dtype=np.uint64)
            dt = np.uint64 if widths[0] == 64 else np.uint32
            self._np(img_out, dt, n)[:] = imgs[order].astype(dt)
        else:
            self._np(out, np.int32, n)[:] = order
        return 0

    def ob_k15_first_images(self, img, width, n, rbits, dead_bit,
                            live_const, first, nb, stream):
        dt = np.uint64 if width == 64 else np.uint32
        images = self._np(img, dt, n).astype(np.uint64)
        self.calls.append(("image", rbits, dead_bit, live_const))
        got = image_model(images, rbits, dead_bit if live_const < 0 else -1,
                          live_const)
        self._np(first, np.uint8, n)[:] = got
        return 0

    def ob_k15_first_records(self, ncols, table, live, order, n, rbytes,
                             rec, first, nb, stream):
        cols, t = self._keys(ncols, table)
        rb, offs = K.k15_record_layout([_tdtype(c) for c in cols])
        assert rb == rbytes and list(t[2 * ncols:]) == offs
        mask = self._np(live, np.bool_, n)
        packed = pack_records(cols, mask)
        self._np(rec, np.uint8, n * rb)[:] = packed.reshape(-1)
        self.calls.append(("record", rb))
        self._np(first, np.uint8, n)[:] = record_model(
            packed, self._np(order, np.int32, n))
        return 0

    def ob_k15_first(self, ncols, table, live, order, n, first, nb, stream):
        cols, _t = self._keys(ncols, table)
        mask = self._np(live, np.bool_, n)
        o = None if order is None else self._np(order, np.int32, n)
        self.calls.append(("columns" if o is not None else "rows",))
        self._np(first, np.uint8, n)[:] = columns_model(cols, mask, o)
        return 0


@contextlib.contextmanager
def model_library(monkeypatch, tensors):
    lib = ModelLib(tensors)
    monkeypatch.setattr(K, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(K, "_load", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda dev: 0)
    monkeypatch.setattr(K, "_blocks", lambda dev, n, per: 1)
    monkeypatch.setattr(K, "_device_table", lambda values, dev: torch.tensor(
        list(values), dtype=torch.int64))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setitem(K.LAUNCHES, "K3_radix_sort", 0)
    monkeypatch.setitem(K.LAUNCHES, "K15_distinct_first", 0)
    yield lib


@pytest.mark.parametrize("kind", sorted(CASES))
def test_k15_wrapper_routes_what_the_kernels_get(kind, monkeypatch):
    rng = np.random.default_rng(len(kind) + 100)
    cols, mask = _cols(rng, kind, 3000)
    tc, tm = [_t(c) for c in cols], _t(mask)
    want, _order = plain(cols, mask)
    with model_library(monkeypatch, [tm, *tc]) as lib:
        s = K.sort_order_images(tc, [False] * len(tc), tm)
        assert s.route == CASES[kind]
        assert (s.images is not None) == (s.route == "image")
        assert (s.order is None) == (s.route in ("image", "rows"))
        got = H.distinct_first_mask(tc[:-1], tc[-1], tm)
        assert K.LAUNCHES["K3_radix_sort"] == 2
        assert K.LAUNCHES["K15_distinct_first"] == 1
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert [c[0] for c in lib.calls] == [CASES[kind]]
    if s.route == "image":
        route, plan, _k, _n, _i, spans = plan_of(cols, mask)
        (c,) = plan
        assert s.rbits == c.rbits == lib.calls[0][1]
        assert (s.images.dtype == torch.int64) == (c.width == 64)
        dead = [sh for i, _lo, sh in c.members if i == 0]
        assert s.dead_bit == (c.rbits + dead[0] if dead else -1)
        if kind == "no live row":
            assert (s.dead_bit, s.live) == (-1, 0)
        if kind == "every row live":
            assert (s.dead_bit, s.live) == (-1, 1)


def test_k15_forced_routes_on_the_wrapper(monkeypatch):
    """The record and columns routes forced on an image-route case, and a
    route the keys cannot take refused."""
    rng = np.random.default_rng(3)
    cols, mask = _cols(rng, "ties", 2000)
    tc, tm = [_t(c) for c in cols], _t(mask)
    want, order = plain(cols, mask)
    with model_library(monkeypatch, [tm, *tc]) as lib:
        to = _t(order)
        for route in ("record", "columns"):
            got = K.first_occurrence(tc, tm, to, route)
            assert np.array_equal(got.numpy(), want), route
        with pytest.raises(ValueError):
            K.first_occurrence(tc, tm, to, "rows")
        wide = [_t(rng.integers(0, 3, 2000)) for _ in range(5)]
        lib.by_ptr.update({t.data_ptr(): t for t in wide})
        with pytest.raises(ValueError):
            K.first_occurrence(wide, tm, to, "record")
    assert [c[0] for c in lib.calls] == ["record", "columns"]


# ---- DISTINCT aggregates through both Sessions ------------------------------


@pytest.fixture(scope="module")
def engines():
    js = JSession(JD.generate(sf=0.003, seed=19920101), unique_keys=UNIQUE_KEYS)
    ts = TSession(TD.generate(sf=0.003, seed=19920101),
                  unique_keys=UNIQUE_KEYS, device="cpu")
    return js, ts


# orders LEFT JOIN a third of the customers: every customer column is NULL
# on the unmatched orders
NULLABLE = """(select o_orderpriority as g, c.c_mktsegment as h,
        c.c_nationkey as v, c.c_acctbal as p, o_totalprice as t
    from orders left join (select c_custkey, c_mktsegment, c_nationkey,
        c_acctbal from customer where c_nationkey < 9) c
    on o_custkey = c.c_custkey) x"""

DISTINCT_CASES = {
    "grouped by a nullable key": f"""
        select h, count(distinct v) as c, sum(distinct v) as s,
               avg(distinct v) as a, count(*) as n
        from {NULLABLE} group by h order by h""",
    "grouped by two nullable keys": f"""
        select h, v, count(distinct p) as c, sum(distinct p) as s,
               count(distinct g) as cg, count(*) as n
        from {NULLABLE} group by h, v order by h, v""",
    "grouped, distinct over a float": f"""
        select h, count(distinct p) as c, sum(distinct p) as s,
               avg(distinct p) as a
        from {NULLABLE} group by h order by h""",
    "ungrouped": f"""
        select count(distinct v) as c, sum(distinct v) as s,
               avg(distinct v) as a, count(distinct h) as ch,
               count(*) as n
        from {NULLABLE}""",
    "ungrouped over a non-null key": """
        select count(distinct o_custkey) as c, sum(distinct o_custkey) as s,
               avg(distinct o_shippriority) as a, count(*) as n
        from orders""",
}


@pytest.mark.parametrize("name", sorted(DISTINCT_CASES))
def test_distinct_aggregates_match_jax(engines, name):
    js, ts = engines
    check_twin(js, ts, DISTINCT_CASES[name])
