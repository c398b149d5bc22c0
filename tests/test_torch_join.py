"""The join slice's kernels against the JAX package, on the same numpy
inputs: K5 (the affine join probe) against `_affine_candidates` and the
verify gather of `_emit_join`, K6 (the clustered-FK segment aggregation)
against the cumsum-difference formula of `_emit_clustered_agg`, and K7
(the top-k candidates) against `jax.lax.top_k` and
`Executor._topn_candidates`.

On the CPU every wrapper runs its kernel's plain PyTorch version, so these
tests pin the plain versions to the JAX package; chip_smoke.py holds the
CUDA kernels to the same plain versions on the card. Integers, masks,
orders and counters must match exactly; the float sums here are of
integer values, whose prefix sums are exact, so they match exactly too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oceanbase_tpu.core.column import ColumnBatch as JBatch
from oceanbase_tpu.core.dtypes import DataType as JDT
from oceanbase_tpu.core.dtypes import Field as JField
from oceanbase_tpu.core.dtypes import Schema as JSchema
from oceanbase_tpu.engine.executor import Executor as JExecutor
from oceanbase_tpu.engine.executor import _affine_candidates as j_affine
from oceanbase_tpu.engine.executor import gather_payload as j_gather_payload
from oceanbase_tpu.expr import ir as JE
from oceanbase_tpu.ops.gather import gather_rows as j_gather_rows
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.core.column import ColumnBatch as TBatch
from oceanbase_tpu_torch.core.dtypes import DataType as TDT
from oceanbase_tpu_torch.core.dtypes import Field as TField
from oceanbase_tpu_torch.core.dtypes import Schema as TSchema
from oceanbase_tpu_torch.engine.executor import Executor as TExecutor
from oceanbase_tpu_torch.expr import ir as TE

I64 = np.iinfo(np.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t, what):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype, f"{what}: {j.dtype} vs {t.dtype}"
    assert j.shape == t.shape, f"{what}: {j.shape} vs {t.shape}"
    np.testing.assert_array_equal(t, j, err_msg=what)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

A0, STRIDE, NB = 7, 3, 500


def _affine_case(seed, probe_dtype, build_dtype, n=777):
    rng = np.random.default_rng(seed)
    bkey = (A0 + STRIDE * np.arange(NB)).astype(build_dtype)
    bsel = rng.random(NB) < 0.8          # dead build rows
    # keys below a0, off % stride != 0, cand >= nb, and exact hits
    pkey = rng.integers(-20, A0 + STRIDE * NB + 60, n).astype(probe_dtype)
    pkey[::5] = bkey[rng.integers(0, NB, len(pkey[::5]))]
    psel = rng.random(n) < 0.7
    payload = {
        "b.i8": rng.integers(-128, 128, NB).astype(np.int8),
        "b.i32": rng.integers(-10**9, 10**9, NB).astype(np.int32),
        "b.i64": rng.integers(-10**15, 10**15, NB),
        "b.f64": rng.normal(0.0, 1e3, NB),
    }
    valid = {"b.i32": rng.random(NB) < 0.9}
    return pkey, psel, bkey, bsel, payload, valid


@pytest.mark.parametrize("probe_dtype,build_dtype", [
    (np.int32, np.int64),   # l_partkey against p_partkey's width mix
    (np.int64, np.int64),
    (np.int32, np.int32),
    (np.int8, np.int8),     # nation keys
])
def test_affine_join_matches_jax(probe_dtype, build_dtype):
    pkey, psel, bkey, bsel, payload, valid = _affine_case(
        11, probe_dtype, build_dtype)
    # reference: direct-address candidates + the packed verify gather
    candc, in_range = j_affine(jnp.asarray(pkey), (A0, STRIDE), NB)
    rcols, rvalid, rsel = j_gather_payload(
        {**{k: jnp.asarray(v) for k, v in payload.items()},
         "#bk": jnp.asarray(bkey)},
        {k: jnp.asarray(v) for k, v in valid.items()},
        candc, jnp.asarray(bsel))
    bk_at = rcols.pop("#bk")
    jsel = (jnp.asarray(psel) & in_range & (bk_at == jnp.asarray(pkey))
            & rsel)
    names = list(payload) + [f"v:{k}" for k in valid]
    cols = [_t(payload[k]) for k in payload] + [_t(valid[k]) for k in valid]
    tsel, touts = kernels.affine_join(
        _t(pkey), _t(psel), A0, STRIDE, _t(bkey), _t(bsel), cols)
    _eq(jsel, tsel, "sel")
    assert int(np.sum(np.asarray(jsel))) > 0
    ref = dict(rcols)
    ref.update({f"v:{k}": v for k, v in rvalid.items()})
    # payload: the reference's gather wherever the probe row is live; 0
    # (the allowed dead-row difference) wherever it is dead
    for name, got in zip(names, touts):
        want = np.asarray(ref[name])
        g = got.numpy()
        assert g.dtype == want.dtype, name
        np.testing.assert_array_equal(g[psel], want[psel], err_msg=name)
        assert not g[~psel].any(), name


def test_affine_join_no_payload_and_all_dead_probe():
    pkey, psel, bkey, bsel, _p, _v = _affine_case(3, np.int64, np.int64)
    dead = np.zeros_like(psel)
    tsel, touts = kernels.affine_join(
        _t(pkey), _t(dead), A0, STRIDE, _t(bkey), _t(bsel), [])
    assert touts == [] and not tsel.any()


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def _clustered_case(seed, n=2000, nb_rows=600, cap=1024):
    rng = np.random.default_rng(seed)
    fk = np.sort(rng.integers(0, nb_rows + 40, n))   # clustered probe key
    pk = np.arange(nb_rows)                           # some keys absent
    lo = np.searchsorted(fk, pk, side="left").astype(np.int32)
    hi = np.searchsorted(fk, pk, side="right").astype(np.int32)
    pad = np.zeros(cap - nb_rows, dtype=np.int32)     # padded build rows
    starts, ends = np.concatenate([lo, pad]), np.concatenate([hi, pad])
    sel = rng.random(n) < 0.75
    vals = {
        "i64": rng.integers(-10**15, 10**15, n),
        "i32": rng.integers(-10**6, 10**6, n).astype(np.int32),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "f64": rng.integers(-10**6, 10**6, n).astype(np.float64),
    }
    nulls = rng.random(n) < 0.3
    return starts, ends, sel, vals, nulls


def _j_clustered(starts, ends, sel, aggs):
    """executor._emit_clustered_agg's formula: per-aggregate cumsums over
    the probe side, differenced at the gathered range bounds."""
    base = jnp.asarray(sel)
    running = {"#cnt": jnp.cumsum(base.astype(jnp.int64))}
    for i, (fn, v, vv) in enumerate(aggs):
        am = base if vv is None else base & jnp.asarray(vv)
        if fn == "count":
            running[i] = jnp.cumsum(am.astype(jnp.int64))
        else:
            v = jnp.asarray(v)
            acc = (jnp.int64 if jnp.issubdtype(v.dtype, jnp.integer)
                   else v.dtype)
            running[i] = jnp.cumsum(jnp.where(am, v, 0).astype(acc))
    cap = base.shape[0]
    s, e = jnp.asarray(starts), jnp.asarray(ends)
    at_hi = j_gather_rows(running, jnp.clip(e - 1, 0, cap - 1))
    at_lo = j_gather_rows(running, jnp.clip(s - 1, 0, cap - 1))

    def seg(k):
        return (jnp.where(e > 0, at_hi[k], 0)
                - jnp.where(s > 0, at_lo[k], 0))

    return seg("#cnt"), [seg(i) for i in range(len(aggs))]


@pytest.mark.parametrize("seed", [0, 1])
def test_clustered_segments_match_jax(seed):
    starts, ends, sel, vals, nulls = _clustered_case(seed)
    aggs = [
        ("sum", vals["i64"], None),
        ("sum", vals["i32"], ~nulls),       # sum(col) skipping NULLs
        ("count", None, ~nulls),            # count(col) with NULLs
        ("sum", vals["i8"], None),
        ("sum", vals["f64"], ~nulls),
    ]
    jcnt, jres = _j_clustered(starts, ends, sel, aggs)
    tcnt, tres = kernels.clustered_segments(
        _t(starts), _t(ends), _t(sel),
        [(fn, None if v is None else _t(v),
          None if m is None else _t(m)) for fn, v, m in aggs])
    _eq(jcnt, tcnt, "count(*)")
    for i, (j, t) in enumerate(zip(jres, tres)):
        _eq(j, t, f"aggregate {i}")
    # padded rows and empty ranges give 0; starts = 0 is the first range
    assert starts[0] == 0
    assert not tcnt.numpy()[ends == starts].any()
    assert tcnt.numpy()[600:].sum() == 0


def test_clustered_segments_count_only():
    starts, ends, sel, _vals, _n = _clustered_case(5)
    jcnt, _ = _j_clustered(starts, ends, sel, [])
    tcnt, tres = kernels.clustered_segments(
        _t(starts), _t(ends), _t(sel), [])
    _eq(jcnt, tcnt, "count(*)")
    assert tres == []


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def _j_topk(key, sel, desc, c):
    flip = jnp.asarray(key).astype(jnp.int64)
    if not desc:
        flip = ~flip
    masked = jnp.where(jnp.asarray(sel), flip, jnp.iinfo(jnp.int64).min)
    cand_v, cand_i = jax.lax.top_k(masked, c)
    cnt = jnp.sum((masked >= cand_v[c - 1]) & jnp.asarray(sel),
                  dtype=jnp.int64)
    return cand_i, cnt


def _topk_case(kind, seed, n=3000):
    rng = np.random.default_rng(seed)
    if kind == "ties":          # ties across the C-th candidate
        key = rng.integers(0, 7, n).astype(np.int32)
        sel = rng.random(n) < 0.6
    elif kind == "all_dead":
        key = rng.integers(-10**9, 10**9, n)
        sel = np.zeros(n, dtype=bool)
    elif kind == "few_live":    # nlive < C
        key = rng.integers(-10**9, 10**9, n)
        sel = np.zeros(n, dtype=bool)
        sel[rng.choice(n, 40, replace=False)] = True
    elif kind == "sentinel":    # live rows whose flipped key is INT64_MIN
        key = rng.integers(-10**6, 10**6, n)
        sel = rng.random(n) < 0.05
        # the last live rows, so dead rows' lower indices displace them
        key[sel.nonzero()[0][-3:]] = I64.min    # DESC: flip == INT64_MIN
        key[sel.nonzero()[0][-6:-3]] = I64.max  # ASC: ~INT64_MAX == INT64_MIN
    else:                       # wide int64 keys with extremes
        key = rng.integers(-10**15, 10**15, n)
        key[::101] = I64.max
        key[7::103] = I64.min
        sel = rng.random(n) < 0.5
    return key, sel


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("kind", ["ties", "all_dead", "few_live",
                                  "sentinel", "wide"])
@pytest.mark.parametrize("c", [256, 1024])
def test_topk_candidates_match_lax_top_k(kind, desc, c):
    key, sel = _topk_case(kind, 4)
    ji, jc = _j_topk(key, sel, desc, c)
    ti, tc = kernels.topk_candidates(_t(key), _t(sel), desc, c)
    _eq(ji, ti, f"{kind} indices")
    _eq(jc, tc, f"{kind} tie count")


def _batches(key, sel, rng):
    n = len(key)
    pay = rng.integers(-10**6, 10**6, n)
    jb = JBatch(
        cols={"t.k": jnp.asarray(key), "t.p": jnp.asarray(pay)},
        valid={}, sel=jnp.asarray(sel),
        nrows=jnp.sum(jnp.asarray(sel), dtype=jnp.int64),
        schema=JSchema((JField("t.k", JDT.int64()),
                        JField("t.p", JDT.int64()))), dicts={})
    tb = TBatch(
        cols={"t.k": _t(key), "t.p": _t(pay)}, valid={}, sel=_t(sel),
        nrows=torch.tensor(int(sel.sum())),
        schema=TSchema((TField("t.k", TDT.int64()),
                        TField("t.p", TDT.int64()))), dicts={})
    return jb, tb


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("kind", ["ties", "all_dead", "few_live",
                                  "sentinel", "wide"])
def test_topn_candidates_match_executor(kind, desc):
    """The executor's prefilter: candidate rows, their sel, and the
    overflow counter (tie overflow + the `short` guard) all equal."""
    key, sel = _topk_case(kind, 9)
    jb, tb = _batches(key, sel, np.random.default_rng(2))
    C = 256
    jmini, jover = JExecutor._topn_candidates(
        None, jb, [(JE.ColRef("t.k"), desc)], C)
    tmini, tover = TExecutor._topn_candidates(
        None, tb, [(TE.ColRef("t.k"), desc)], C)
    _eq(jover, tover, f"{kind} overflow")
    _eq(jmini.sel, tmini.sel, f"{kind} candidate sel")
    live = np.asarray(jmini.sel)
    for c in ("t.k", "t.p"):
        np.testing.assert_array_equal(
            tmini.cols[c].numpy()[live], np.asarray(jmini.cols[c])[live])
    if kind == "ties":
        assert int(tover) > 0          # the retry fires
    if kind == "sentinel":
        # the live sentinel rows are displaced by dead rows' lower
        # indices: the short guard fires in both engines
        assert int(tover) > 0
