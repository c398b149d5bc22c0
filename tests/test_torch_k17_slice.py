"""K17, the sorted-projection range slice, as redesigned for the card.

K17's plain version is held against the JAX package's `_slice_sorted_scan`
on crafted batches, every output exactly: starts at every residue mod 16
(the kernel copies 16 bytes a thread from a start at any row), an empty
range, a low bound past the high one, a range wider than the slice, int8
and int16 bounds cast to an int64 or int8 key's width, 17 bounds, and a
projection of 40 columns (more than the 64 table entries the kernel's
parameters hold). The kernel's argument table is cached (`k17_plan`): a
call over the same tensors reuses the plan, a changed column or bound
address builds a new one, and the table past 64 entries lies in a tensor.
The warp search's 33-way cut is modelled in numpy against searchsorted.
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
from oceanbase_tpu.expr import compile as JC
from oceanbase_tpu.expr import ir as JE
from oceanbase_tpu_torch import kernels

CAP2 = 4096


def _case(key, n, lows, highs, cap, ncols=3, seed=11):
    """One crafted batch through JAX's _slice_sorted_scan (bounds as
    slotted parameters of their own dtype) and K17's plain version."""
    rng = np.random.default_rng(seed)
    widths = [np.int64, np.int16, np.int8, np.int32, np.bool_]
    cols = [rng.integers(-100, 100, CAP2).astype(widths[i % len(widths)])
            for i in range(ncols)]
    sel = (rng.random(CAP2) < 0.9) & (np.arange(CAP2) < n)
    names = ["k"] + [f"c{i}" for i in range(ncols)]
    bounds = lows + highs
    jb = JBatch(
        cols={"k": jnp.asarray(key),
              **{f"c{i}": jnp.asarray(c) for i, c in enumerate(cols)}},
        valid={}, sel=jnp.asarray(sel),
        nrows=jnp.asarray(int(sel.sum()), jnp.int64),
        schema=JSchema(tuple(JField(nm, JDataType.int64()) for nm in names)),
        dicts={})
    lits = [(JE.Literal(0, JDataType.int64(), i), side)
            for i, (_v, side) in enumerate(bounds)]
    spec = JX._SliceSpec("k", tuple(lits[:len(lows)]),
                         tuple(lits[len(lows):]))
    prev = JC.set_params(tuple(jnp.asarray(v) for v, _s in bounds))
    try:
        jout, jovf = JX._slice_sorted_scan(jb, spec, cap, n)
    finally:
        JC.set_params(prev)
    tb = [(torch.from_numpy(np.asarray(v)), s) for v, s in bounds]
    outs, osel, nrows, ovf = kernels.slice_scan_plain(
        torch.from_numpy(key), n, tb[:len(lows)], tb[len(lows):], cap,
        [torch.from_numpy(c) for c in cols], torch.from_numpy(sel))
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jout.cols[f"c{i}"]))
    np.testing.assert_array_equal(osel.numpy(), np.asarray(jout.sel))
    assert int(nrows) == int(jout.nrows)
    assert int(ovf) == int(jovf)
    return int(ovf), int(nrows), osel.numpy()


# a sorted int32 key of 3000 rows, each value 0..2999 once: the low bound
# v (side left) starts the slice at row v
N = 3000
KEY32 = np.concatenate([np.arange(N, dtype=np.int32),
                        np.zeros(CAP2 - N, np.int32)])


@pytest.mark.parametrize("residue", range(16))
def test_starts_at_every_residue_mod_16(residue):
    lo = 512 + residue
    over, live, osel = _case(KEY32, N, [(np.int32(lo), "left")],
                             [(np.int32(lo + 700), "left")], 1024)
    assert over == 0 and 0 < live <= 700 and not osel[700:].any()


@pytest.mark.parametrize("lows,highs,cap,what", [
    ([(np.int32(200), "left")], [(np.int32(200), "left")], 1024, "empty"),
    ([(np.int32(300), "right")], [(np.int32(100), "left")], 1024,
     "lo_above_hi"),
    ([(np.int32(10), "left")], [(np.int32(2900), "right")], 1024,
     "overflow"),
    ([(np.int32(2990), "left")], [], 1024, "clip_end"),
    ([], [(np.int32(-5), "left")], 1024, "below_every_key"),
])
def test_edge_ranges(lows, highs, cap, what):
    over, live, _ = _case(KEY32, N, lows, highs, cap)
    if what in ("empty", "lo_above_hi", "below_every_key"):
        assert live == 0 and over == 0
    if what == "overflow":
        assert over == 2891 - 1024


@pytest.mark.parametrize("kdt,bdt", [(np.int64, np.int8), (np.int64,
                                     np.int16), (np.int8, np.int16),
                                     (np.int16, np.int8)])
def test_narrow_bounds_cast_to_the_key(kdt, bdt):
    """A bound of another width is cast to the key's type first (astype's
    two's-complement truncation): an int16 300 against an int8 key is 44."""
    key = np.concatenate([np.sort(np.random.default_rng(3).integers(
        -128, 128, N)).astype(kdt), np.zeros(CAP2 - N, kdt)])
    lo = 300 if (kdt is np.int8 and bdt is np.int16) else -20
    _case(key, N, [(bdt(lo), "left")], [(bdt(60), "right")], 2048)


def test_seventeen_bounds():
    rng = np.random.default_rng(17)
    lows = [(np.int32(v), s) for v, s in zip(rng.integers(100, 700, 9),
                                           ["left", "right"] * 5)]
    highs = [(np.int32(v), s) for v, s in zip(rng.integers(900, 1500, 8),
                                            ["right", "left"] * 4)]
    assert len(lows) + len(highs) == 17
    over, live, _ = _case(KEY32, N, lows, highs, 1024)
    assert live > 0 and over == 0


def test_a_table_past_64_entries():
    """40 columns and 3 bounds: 86 entries, past the kernel's parameters."""
    ncols = 40
    lows = [(np.int32(1000), "left")]
    highs = [(np.int32(1800), "left"), (np.int32(1700), "right")]
    _case(KEY32, N, lows, highs, 1024, ncols=ncols)
    tensors = [torch.zeros(CAP2, dtype=torch.int32) for _ in range(ncols)]
    key, sel = torch.from_numpy(KEY32), torch.ones(CAP2, dtype=torch.bool)
    tl = [(torch.tensor(1000, dtype=torch.int32), "left")]
    th = [(torch.tensor(1800, dtype=torch.int32), "left")]
    plan = kernels.k17_plan(key, N, tl, th, 1024, tensors, sel, 132)
    assert plan.table is not None and plan.table.numel() == 2 * ncols + 4
    assert plan.table[0].item() == tensors[0].data_ptr()


def _plan_inputs():
    key = torch.from_numpy(KEY32.copy())
    sel = torch.ones(CAP2, dtype=torch.bool)
    cols = [torch.zeros(CAP2, dtype=dt) for dt in (torch.int64, torch.int8,
                                                   torch.int32)]
    lows = [(torch.tensor(100, dtype=torch.int32), "left")]
    highs = [(torch.tensor(900, dtype=torch.int32), "right")]
    return key, sel, cols, lows, highs


def test_plan_is_cached_and_rebuilt_when_an_address_changes():
    key, sel, cols, lows, highs = _plan_inputs()
    p1 = kernels.k17_plan(key, N, lows, highs, 1024, cols, sel, 132)
    p2 = kernels.k17_plan(key, N, lows, highs, 1024, cols, sel, 132)
    assert p1 is p2
    assert p1.table is None and p1.nblocks >= 1
    # the image holds every address: key, sel, each column, each bound
    words = np.frombuffer(p1.blob, dtype=np.int64)
    assert words[0] == key.data_ptr() and words[1] == sel.data_ptr()
    e = words[72 // 8:]
    assert list(e[:6:2]) == [c.data_ptr() for c in cols]
    assert e[6] == lows[0][0].data_ptr() and e[8] == highs[0][0].data_ptr()
    # each slice at a 16-byte aligned offset past nrows and overflow, its
    # padding a part of its own
    assert p1.sizes == (16, 8192, 0, 1024, 0, 4096, 0, 1024, 0)
    assert p1.views == ((1, torch.int64), (3, torch.int8), (5, torch.int32),
                        (7, torch.bool))
    assert p1.sel_off == 16 + 8192 + 1024 + 4096
    assert p1.nbytes == p1.sel_off + 1024 == sum(p1.sizes)
    # a changed column address: another plan, with the new address in it
    moved = list(cols)
    moved[1] = cols[1].clone()
    p3 = kernels.k17_plan(key, N, lows, highs, 1024, moved, sel, 132)
    assert p3 is not p1
    assert np.frombuffer(p3.blob, dtype=np.int64)[9 + 2] == \
        moved[1].data_ptr()
    # a new bound tensor, another cap, another n: other plans
    nb = [(lows[0][0].clone(), "left")]
    assert kernels.k17_plan(key, N, nb, highs, 1024, cols, sel, 132) \
        is not p1
    assert kernels.k17_plan(key, N, lows, highs, 2048, cols, sel, 132) \
        is not p1
    assert kernels.k17_plan(key, N - 1, lows, highs, 1024, cols, sel, 132) \
        is not p1
    # and the first inputs find their plan again
    assert kernels.k17_plan(key, N, lows, highs, 1024, cols, sel, 132) is p1


def test_plan_checks_its_inputs_when_built():
    key, sel, cols, lows, highs = _plan_inputs()
    with pytest.raises(TypeError):
        kernels.k17_plan(key, N, [(torch.tensor(1.5), "left")], highs, 1024,
                         cols, sel, 132)
    with pytest.raises(ValueError):
        kernels.k17_plan(key, N, lows, highs, CAP2, cols, sel, 132)
    with pytest.raises(ValueError):
        kernels.k17_plan(key, N, lows, highs, 1024,
                         [torch.zeros(CAP2 - 1, dtype=torch.int32)], sel, 132)


def _search33(keys, v, right):
    """csrc/k17_slice_scan.cu k17_search, lane by lane."""
    lo, hi = 0, len(keys)
    rounds = 0
    while hi - lo > 32:
        m = hi - lo
        probes = [lo + (j + 1) * m // 33 for j in range(32)]
        c = sum(1 for p in probes if (keys[p] <= v if right else keys[p] < v))
        nlo = lo + c * m // 33 + 1 if c > 0 else lo
        if c < 32:
            hi = lo + (c + 1) * m // 33
        lo = nlo
        rounds += 1
    t = [keys[lo + j] <= v if right else keys[lo + j] < v
         for j in range(hi - lo)]
    return lo + sum(t), rounds + 1


class _Runs:
    """A sorted key of n rows in runs of 7 (row p holds p // 7), read on
    demand: 60M keys without the memory."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, p):
        assert 0 <= p < self.n
        return p // 7

    def searchsorted(self, v, right):
        return min(max(7 * (v + 1 if right else v), 0), self.n)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 60_000_000])
def test_warp_search_model(n):
    """The 33-way search finds searchsorted's position in at most
    ceil(log33(n / 32)) + 1 rounds (6 over 60M keys)."""
    keys = _Runs(n)
    vals = sorted({-1, 0, 1, 5, n // 14, n // 7 - 1, n // 7, n // 7 + 1,
                   10**9})
    for v in vals:
        for right in (False, True):
            got, rounds = _search33(keys, v, right)
            assert got == keys.searchsorted(v, right), (n, v, right)
            assert rounds <= (6 if n <= 60_000_000 else 7)
