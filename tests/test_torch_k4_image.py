"""K4's row image, on the CPU: the layout the wrapper hands the kernel
(`kernels.k4_images`) and the route by shape (`kernels.k4_route`), and a
numpy model of what `csrc/k4_gather_rows.cu` does with them -- the
probe's count, the pack through its swizzled shared tile, the gather of
each warp's rows into the tile (the lanes of a record fetching its parts
together), the unpack column by column -- held against
`gather_columns_plain` for every dtype. The CUDA kernels themselves run
only on the card (chip_smoke.py holds them against the plain version
there and reads back which path did the work)."""

import numpy as np
import pytest
import torch

from oceanbase_tpu_torch import kernels

# csrc/k4_gather_rows.cu: threads a block, bytes a lane's strip, the
# gather's shared tile (K4_THREADS * K4_STRIP bytes) and the pack's
# (K4_PACK_CHUNKS * 16 bytes)
THREADS = 256
STRIP = 64
TILE = THREADS * STRIP
PACK_TILE = 2048 * 16

DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
          torch.int64, torch.float32, torch.float64)


def swz(b):
    """k4_swz: chunk c of the tile lies at c ^ ((c >> 3) & 7)."""
    return b ^ (((b >> 7) & 7) << 4)


def _column(dtype, rng, n):
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype.is_floating_point:
        a = rng.normal(size=n).astype(str(dtype).split(".")[1])
        a[::13] = np.nan
        a[::17] = -0.0
        return torch.from_numpy(a)
    info = torch.iinfo(dtype)
    a = rng.integers(info.min, info.max, n, endpoint=True, dtype=np.int64)
    return torch.from_numpy(a).to(dtype)


def _bytes(c: torch.Tensor) -> np.ndarray:
    """(n, width) little-endian bytes of a column."""
    return c.numpy().view(np.uint8).reshape(c.shape[0], c.element_size())


def pack(cols, image, n):
    """k4_pack: tiles of PACK_TILE // rec records; every column into the
    swizzled tile, then the tile out chunk by chunk."""
    rec = image.rec
    tr = PACK_TILE // rec
    out = np.zeros(n * rec, dtype=np.uint8)
    for t0 in range(0, n, tr):
        rows = min(tr, n - t0)
        tile = np.zeros(PACK_TILE, dtype=np.uint8)
        i = np.arange(rows)
        for c, off in zip(image.cols, image.offsets):
            b = _bytes(cols[c])
            at = swz(i * rec + off)
            for k in range(b.shape[1]):
                tile[at + k] = b[t0 + i, k]
        k = np.arange(rows * rec // 16)
        chunks = tile.reshape(-1, 16)[k ^ ((k >> 3) & 7)]
        out[t0 * rec:(t0 + rows) * rec] = chunks.reshape(-1)
    return out.reshape(n, rec)


def warp_loads(rec):
    """k4_gather_image's loads: (tile row, part, chunk) of load j of lane
    l of warp w, the row j * LR + l // CH of the warp's WR rows, the chunk
    32 NL w + 32 j + l before the swizzle."""
    rpt, ch, nl = STRIP // rec, rec // 16, STRIP // 16
    w = np.arange(THREADS // 32)[:, None, None]
    j = np.arange(nl)[None, :, None]
    lane = np.arange(32)[None, None, :]
    row = w * 32 * rpt + j * (32 // ch) + lane // ch
    return [a.reshape(-1) for a in np.broadcast_arrays(
        row, lane % ch, 32 * nl * w + 32 * j + lane)]


def gather_unpack(cols, image, img, idx, n, outs):
    """k4_gather_image: each warp's rows into its part of the tile, each
    record's 16-byte parts fetched by neighbouring lanes; then each column
    out of the tile."""
    rec = image.rec
    rpt, ch = STRIP // rec, rec // 16
    tr = THREADS * rpt
    m = idx.shape[0]
    s = kernels.k4_norm_index(idx, n).numpy()
    chunks = img.reshape(-1, 16)
    row, part, chunk = warp_loads(rec)
    for t0 in range(0, m, tr):
        r = t0 + row
        sk = np.where(r < m, s[np.minimum(r, m - 1)], 0)
        tile = np.zeros((TILE // 16, 16), dtype=np.uint8)
        tile[chunk ^ ((chunk >> 3) & 7)] = chunks[sk * ch + part]
        tile = tile.reshape(-1)
        rows = min(tr, m - t0)
        i = np.arange(rows)
        for c, off in zip(image.cols, image.offsets):
            w = cols[c].element_size()
            at = swz(i * rec + off)
            for k in range(w):
                outs[c][t0 + i, k] = tile[at + k]


def emulate(cols, idx):
    """K4's image path end to end in numpy: [column[idx]] for cols."""
    n, m = cols[0].shape[0], idx.shape[0]
    images = kernels.k4_images([c.element_size() for c in cols])
    outs = [np.zeros((m, c.element_size()), dtype=np.uint8) for c in cols]
    for image in images:
        gather_unpack(cols, image, pack(cols, image, n), idx, n, outs)
    return [torch.from_numpy(o.reshape(-1).view(
        cols[c].numpy().dtype).copy()) for c, o in enumerate(outs)]


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


WIDTH_SETS = {
    "S1's payload": [8, 1, 8, 4, 1],
    "one byte": [1],
    "17 bytes": [8, 8, 1],
    "33 bytes": [8, 8, 8, 8, 1],
    "past 64 bytes": [8] * 9 + [4, 2, 1],
    "every width twice": [1, 2, 4, 8] * 2,
    "60 one-byte columns": [1] * 60,
    "100 mixed columns": [1, 2, 4, 8] * 25,
}


@pytest.mark.parametrize("name", sorted(WIDTH_SETS))
def test_k4_image_layout(name):
    """Every column in one image once, at an offset aligned to its width,
    no two overlapping; images of at most 64 bytes and K4_MAX_COLS
    columns, each record the smallest of 16, 32 or 64 bytes that holds
    it; the images laid end to end keep every column widest first (the
    order the kernel's direct launches and its checks take)."""
    widths = WIDTH_SETS[name]
    image_bytes = 64
    assert kernels.K4_IMAGE_BYTES == image_bytes
    images = kernels.k4_images(widths)
    seen = [i for im in images for i in im.cols]
    assert sorted(seen) == list(range(len(widths)))
    assert [widths[i] for i in seen] == sorted(widths, reverse=True)
    for im in images:
        assert 1 <= len(im.cols) <= kernels.K4_MAX_COLS
        spans = sorted((o, o + widths[c]) for c, o in zip(im.cols,
                                                          im.offsets))
        for (a0, a1), (b0, _b1) in zip(spans, spans[1:]):
            assert a1 <= b0
        for c, o in zip(im.cols, im.offsets):
            assert o % widths[c] == 0
        end = spans[-1][1]
        assert end <= image_bytes
        assert im.rec in (16, 32, 64)
        assert end <= im.rec and (im.rec == 16 or end > im.rec // 2)
    total = sum(widths)
    if len(widths) <= kernels.K4_MAX_COLS and total <= image_bytes:
        assert len(images) == 1


def test_k4_image_splits_past_48_columns():
    """60 one-byte columns fit 64 bytes but not one launch's column
    table: two images, 48 and 12 columns."""
    images = kernels.k4_images([1] * 60)
    assert [len(im.cols) for im in images] == [48, 12]
    assert [im.rec for im in images] == [64, 16]


def test_k4_swizzle_keeps_values_in_their_chunk():
    """The tile's swizzle is a permutation of its bytes that moves whole
    16-byte chunks, so a value aligned to its width (at most 8 bytes)
    stays in one piece; each 8 lanes of a warp's load, which store 8
    consecutive chunks, still land in 8 distinct bank groups."""
    b = np.arange(PACK_TILE)
    s = swz(b)
    assert np.array_equal(np.sort(s), b)
    assert np.array_equal(s & 15, b & 15)
    for w in (1, 2, 4, 8):
        x = np.arange(0, PACK_TILE, w)
        assert np.array_equal(swz(x + w - 1), swz(x) + w - 1)
    for rec in (16, 32, 64):
        _row, _part, c = warp_loads(rec)
        groups = (c ^ ((c >> 3) & 7)).reshape(-1, 8) % 8
        assert all(len(set(g)) == 8 for g in groups)


@pytest.mark.parametrize("rec", [16, 32, 64])
def test_k4_warp_loads_fill_the_tile(rec):
    """Each chunk of the tile is loaded once, and the chunk of a row's
    part is row * CH + part, as the unpack reads it; the lanes of one
    load take whole records."""
    row, part, c = warp_loads(rec)
    ch = rec // 16
    assert np.array_equal(np.sort(c), np.arange(TILE // 16))
    assert np.array_equal(c, row * ch + part)
    per_load = row.reshape(-1, 32)
    for rows in per_load:
        assert np.array_equal(np.bincount(rows - rows.min()),
                              np.full(32 // ch, ch))


@pytest.mark.parametrize("name", sorted(WIDTH_SETS))
def test_k4_image_emulation_equals_plain(name):
    """Pack, gather and unpack as the kernels do them, on every dtype of
    each width, with negative, out-of-range and repeated indices and row
    counts that end mid-tile, equal to gather_columns_plain bit for
    bit."""
    rng = np.random.default_rng(len(name))
    by_width = {1: (torch.bool, torch.int8, torch.uint8), 2: (torch.int16,),
                4: (torch.int32, torch.float32),
                8: (torch.int64, torch.float64)}
    widths = WIDTH_SETS[name]
    n = 3001
    cols = [_column(by_width[w][i % len(by_width[w])], rng, n)
            for i, w in enumerate(widths)]
    m = 2 * n + 7
    idx = rng.integers(-n - 50, n + 50, m).astype(np.int32)
    idx[:3] = (5, 5, 5)
    idx = torch.from_numpy(idx)
    got = emulate(cols, idx)
    want = kernels.gather_columns_plain(cols, idx)
    for c, g, w in zip(cols, got, want):
        assert g.dtype == w.dtype == c.dtype
        assert np.array_equal(_bits(g), _bits(w))


def test_k4_emulation_covers_every_dtype():
    """The emulation over one column of each dtype the port gathers."""
    rng = np.random.default_rng(8)
    n = 2500
    cols = [_column(d, rng, n) for d in DTYPES]
    idx = torch.from_numpy(rng.integers(-n, n, 4099).astype(np.int32))
    for g, w in zip(emulate(cols, idx),
                    kernels.gather_columns_plain(cols, idx)):
        assert np.array_equal(_bits(g), _bits(w))


def test_k4_route_by_shape():
    """The image where the gathered bytes times (columns - 1) reach 256
    MiB, the source 64 MiB, and m * (columns - 1) >= n: S1's, U3's, Q20's
    and Q15's gathers at SF 10, the window statements' [1,4,4,8] over 15M
    rows, a PX shard's range sort [8,1,4,1] over 30M and F1's [8,4] of
    30M rows from 15M; not a PX shard's DISTINCT [4,1] over 30M (150 MB),
    20M rows from a 32 MB source, one column, or a top-k gather."""
    big = kernels.K4_IMAGE_MIN_GATHER
    assert big == 256 << 20 and kernels.K4_IMAGE_MIN_SOURCE == 64 << 20
    s1 = [8, 1, 8, 4, 1]
    n = 59_998_208
    assert kernels.k4_route(n, n, s1) == "image"
    assert kernels.k4_route(2 * n, 2 * n, [4, 1, 4]) == "image"
    assert kernels.k4_route(n, n, [8, 1]) == "image"
    assert kernels.k4_route(n, n, [4, 1]) == "image"
    assert kernels.k4_route(15_000_576, 15_000_576, [1, 4, 4, 8]) == "image"
    assert kernels.k4_route(30_000_000, 30_000_000, [8, 1, 4, 1]) == "image"
    assert kernels.k4_route(30_000_000, 30_000_000, [4, 1]) == "direct"
    assert kernels.k4_route(30_002_368, 15_001_184, [8, 4]) == "image"
    assert kernels.k4_route(20_000_000, 2_000_000, [8, 8]) == "direct"
    # one column, a small source, too few rows to pay for the pack
    assert kernels.k4_route(n, n, [8]) == "direct"
    assert kernels.k4_route(1 << 16, 1 << 16, s1) == "direct"
    assert kernels.k4_route(4096, n, s1) == "direct"
    assert kernels.k4_route(n // 4, n, s1) == "image"
    assert kernels.k4_route(n // 4 - 1, n, s1) == "direct"
    assert kernels.k4_route(n, n, [4, 4]) == "image"
    assert kernels.k4_route(n - 1, n, [4, 4]) == "direct"
    assert kernels.k4_route(big // 2, big // 2, [1, 1]) == "image"
    assert kernels.k4_route(big // 2 - 1, big // 2 - 1, [1, 1]) == "direct"
    n3 = -(-big // 6)
    assert kernels.k4_route(n3, n3, [1, 1, 1]) == "image"
    assert kernels.k4_route(n3 - 1, n3 - 1, [1, 1, 1]) == "direct"
    assert kernels.k4_route(1 << 31, 1 << 31, [1, 1]) == "direct"


def probe_model(idx: torch.Tensor, n: int) -> tuple[int, int]:
    """k4_probe: (far, pairs) over its evenly spaced pairs of neighbouring
    rows (pair i: rows r - 1 and r = 1 + i * (m - 1) // pairs), far where
    their normalized sources lie more than K4_NEAR rows apart."""
    m = int(idx.shape[0])
    pairs = kernels.k4_probe_pairs(m)
    if pairs == 0:
        return 0, 0
    r = 1 + torch.arange(pairs) * (m - 1) // pairs
    s = kernels.k4_norm_index(idx, n)
    d = s[r] - s[r - 1]
    near = kernels.K4_NEAR
    return int(((d > near) | (d < -near)).sum()), pairs


def path_model(far: int, pairs: int, k: int) -> str:
    """k4_path on the image route: the image where far / pairs x (k - 1)
    passes K4_IMAGE_SHARE, one pass over the rows where far * K4_FAR_DIV
    <= pairs, else a pass a column."""
    num, den = kernels.K4_IMAGE_SHARE
    if far * den * (k - 1) > pairs * num:
        return "image"
    return "columns" if far * kernels.K4_FAR_DIV > pairs else "rows"


@pytest.mark.parametrize("k, order, path", [
    (5, "random", "image"), (2, "random", "image"), (4, "half", "image"),
    (2, "half", "columns"), (3, "half", "image"), (2, "compaction", "rows"),
    (5, "compaction", "rows")])
def test_k4_path_rule(k, order, path):
    """The probe's three-way choice on S1's random order, a PX shard's
    half-ordered DISTINCT ([4,1], a pass a column) and range sort ([8,1,
    4,1], the image), and a compaction order (one pass over the rows)."""
    rng = np.random.default_rng(k)
    n = 1 << 18
    perm = rng.permutation(n)
    if order == "random":
        idx = perm
    else:
        live = rng.random(n) < (0.5 if order == "half" else 0.01)
        first = perm[live[perm]] if order == "half" else np.flatnonzero(live)
        idx = np.concatenate([first, np.flatnonzero(~live)])
    far, pairs = probe_model(torch.from_numpy(idx.astype(np.int32)), n)
    assert path_model(far, pairs, k) == path


@pytest.mark.parametrize("n", [1 << 16, (1 << 18) + 3])
def test_k4_probe_rule(n):
    """A random order is far almost everywhere (the image); a compaction
    order (live rows first, each run in row order) is not (direct). Past
    K4_PROBE_PAIRS + 1 rows the probe samples evenly spaced pairs."""
    rng = np.random.default_rng(4)
    rule = kernels.K4_FAR_DIV

    def probe(idx):
        far, pairs = probe_model(idx, n)
        assert pairs == min(n - 1, kernels.K4_PROBE_PAIRS)
        return far, pairs

    far, pairs = probe(torch.from_numpy(rng.permutation(n).astype(np.int32)))
    assert far * rule > pairs
    for share in (0.3, 0.01):
        live = torch.from_numpy(rng.random(n) < share)
        comp = torch.cat([live.nonzero().squeeze(1),
                          (~live).nonzero().squeeze(1)]).to(torch.int32)
        far, pairs = probe(comp)
        assert far * rule <= pairs


def test_k4_probe_edges():
    """Near is inclusive, normalized indices count, one row has no pair,
    and the sampled rows are 1 + i * (m - 1) // pairs."""
    n, near = 1 << 16, kernels.K4_NEAR
    idx = torch.tensor([0, near, 2 * near + 1, -1, n + 5], dtype=torch.int32)
    assert probe_model(idx, n) == (2, 4)
    assert probe_model(torch.tensor([7], dtype=torch.int32), n) == (0, 0)
    m = 3 * kernels.K4_PROBE_PAIRS + 2
    idx = torch.zeros(m, dtype=torch.int32)
    i = torch.arange(kernels.K4_PROBE_PAIRS)
    r = 1 + i * (m - 1) // kernels.K4_PROBE_PAIRS
    idx[r[::2]] = 1000
    assert probe_model(idx, n) == (kernels.K4_PROBE_PAIRS // 2,
                                   kernels.K4_PROBE_PAIRS)


@pytest.mark.parametrize("route", [None, "image", "direct"])
def test_k4_launch_on_the_cpu(route):
    """On CPU tensors k4_launch is the plain version whatever the route,
    its traced path "plain", its untraced path None; no columns, none."""
    rng = np.random.default_rng(5)
    n = 4099
    cols = [_column(d, rng, n) for d in DTYPES]
    idx = torch.from_numpy(rng.integers(-n - 9, n + 9, 777).astype(np.int32))
    want = kernels.gather_columns_plain(cols, idx)
    for trace, path in ((True, "plain"), (False, None)):
        got, p = kernels.k4_launch(cols, idx, route=route, trace=trace)
        assert p == path
        for g, w in zip(got, want):
            assert np.array_equal(_bits(g), _bits(w))
    assert kernels.k4_launch([], idx, route=route, trace=True) == ([], None)
