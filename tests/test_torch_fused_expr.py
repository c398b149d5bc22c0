"""K24's lowering (oceanbase_tpu_torch/expr/program.py) through its plain
version against the JAX package and the port's torch route.

Every tree is evaluated three ways on batches built from the same numpy
arrays: the port's `evaluate` / `compile_predicate` (the tree lowered to a
register program and run by `kernels.fused_expr`, which on CPU tensors
runs `fused_expr_plain` instruction by instruction), the port's torch
route (`compile._route`, one torch op per node), and the JAX package's
`evaluate` / `compile_predicate`. The program must equal the torch route
bit for bit: values, dtype and the None-ness of every validity plane.
Against JAX, integers, scaled decimals, dates, codes and masks are exact
on the live rows; floats hold to rel 1e-12, as in tests/test_torch_expr.py
(the same IEEE operations; XLA may rewrite a division by a constant).

Cases: every node kind of the op set (NULL planes, decimals at scales 0-6,
float32 and float64 with NaN and -0.0, dates before 1970, dictionary
compares, IN and LIKE), the Kleene AND/OR truth tables, the Filter and
Project trees of Q1, Q6, Q14, Q19, Q7 and Q22 at SF 0.01 (captured from
the port's Session and carried to the JAX package's evaluate), a
Hypothesis search over random trees, trees past one launch's register and
instruction limits, a dictionary grown by an INSERT (its stale program
replaced), the trees that are not lowered (a bare column, a constant
tree), float literals 0.0 and -0.0 in otherwise equal trees, a tree the
tracer cannot record (it raises: nothing runs whole on the torch route),
the byte bounds of the program cache and of the shared device lookup
tables, and string views, JSON functions and fts_match lowered as lookup
tables.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import oceanbase_tpu.core as JC
import oceanbase_tpu.expr as JE
import oceanbase_tpu.expr.compile as JEC
import oceanbase_tpu_torch.core as TC
import oceanbase_tpu_torch.expr as TE
import oceanbase_tpu_torch.expr.compile as TEC
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.expr import program as TP

N = 257
WORDS = sorted({f"{a}{b}{c}" for a in "abc" for b in "xyz" for c in "01"})


def _data():
    rng = np.random.default_rng(20240817)
    f64 = rng.standard_normal(N) * 100
    f64[:5] = [np.nan, -0.0, 0.0, 1e300, -2.5]
    i32 = rng.integers(-10**6, 10**6, N).astype(np.int32)
    i32[:4] = [-2**31, 2**31 - 1, 0, -1]
    data = {
        "i32": i32,
        "i64": rng.integers(-10**12, 10**12, N),
        "f32": (rng.standard_normal(N) * 10).astype(np.float32),
        "f64": f64,
        "day": rng.integers(-30000, 30000, N).astype(np.int32),
        "s": rng.integers(0, len(WORDS), N).astype(np.int32),
        "k": rng.integers(-3, 4, N).astype(np.int32),
        "g": rng.standard_normal(N) * 1000,
    }
    data["f32"][:3] = [np.nan, -0.0, np.inf]
    for sc in range(7):
        data[f"d{sc}"] = rng.integers(-10**9, 10**9, N)
    valid = {n: rng.random(N) < 0.85 for n in ("i32", "f64", "d2", "s")}
    valid["k"] = rng.random(N) < 0.7
    return data, valid


DATA, VALID = _data()


def _fields(C):
    DT = C.DataType
    out = [("i32", DT.int32(True)), ("i64", DT.int64()),
           ("f32", DT.float32()), ("f64", DT.float64(True)),
           ("day", DT.date()), ("s", DT.varchar(True)),
           ("k", DT.int32(True)), ("g", DT.float64())]
    out += [(f"d{sc}", DT.decimal(18, sc, sc == 2)) for sc in range(7)]
    return out


def _batch(C, **kw):
    schema = C.Schema(tuple(C.Field(n, t) for n, t in _fields(C)))
    t = C.Table("t", schema, {n: v.copy() for n, v in DATA.items()},
                {"s": C.Dictionary(list(WORDS), sorted_=True)},
                {n: v.copy() for n, v in VALID.items()})
    return C.make_batch(t.data, t.schema, t.dicts, valid=t.valid, **kw)


@pytest.fixture(scope="module")
def batches():
    return _batch(JC), _batch(TC, device="cpu")


J = types.SimpleNamespace(E=JE, DT=JC.DataType, col=JE.col, lit=JE.lit)
T = types.SimpleNamespace(E=TE, DT=TC.DataType, col=TE.col, lit=TE.lit)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bits(a):
    a = _np(a)
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _same_bits(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    if b.ndim == 0 and a.ndim == 1:
        b = np.broadcast_to(b, a.shape)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _same_jax(jv, tv, live, what):
    jv, tv = _np(jv), _np(tv)
    assert jv.dtype == tv.dtype, f"{what}: dtype {jv.dtype} vs {tv.dtype}"
    if jv.ndim:
        jv, tv = jv[live], tv[live]
    if jv.dtype.kind == "f":
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0.0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(tv, jv, err_msg=what)


def _counts():
    return dict(TP.EXPR_COUNTS)


def _fused_vs_route(te, tb, predicate=False):
    """The port's lowered result and its torch route's, held bit for bit;
    returns the lowered (values, valid)."""
    c0 = _counts()
    if predicate:
        got = (TEC.compile_predicate(te, tb), None)
        want = (TEC._predicate_route(te, tb), None)
    else:
        got = TEC.evaluate(te, tb)
        want = TEC._route(te, tb)
    c1 = _counts()
    assert c1["expr k24 trees"] == c0["expr k24 trees"] + 1, "not lowered"
    assert c1["expr torch route"] == c0["expr torch route"]
    _same_bits(got[0], want[0], "values vs the torch route")
    assert (got[1] is None) == (want[1] is None), "validity None-ness"
    if got[1] is not None:
        _same_bits(got[1], want[1], "validity vs the torch route")
    return got


def _check(jb, tb, je, te, predicate=False):
    got = _fused_vs_route(te, tb, predicate)
    live = np.asarray(jb.sel)
    if predicate:
        _same_jax(JEC.compile_predicate(je, jb), got[0], slice(None),
                  "mask vs JAX")
        return
    jv, jvalid = JEC.evaluate(je, jb)
    assert (jvalid is None) == (got[1] is None), "validity None-ness vs JAX"
    if jvalid is not None:
        _same_jax(jvalid, got[1], live, "validity vs JAX")
        live = live & np.asarray(jvalid)
    _same_jax(jv, got[0], live, "values vs JAX")


# ---------------------------------------------------------------------------
# every node kind


def _case(X, name):
    E, c, lit, DT = X.E, X.col, X.lit, X.DT
    return {
        "colref_in_arith": E.BinaryOp("+", c("i64"), lit(1)),
        "slotless_literal_mix": E.BinaryOp("*", c("i32"), lit(3)),
        "int_add_wraps": E.BinaryOp("+", c("i32"), c("i32")),
        "int_sub": E.BinaryOp("-", c("i64"), c("i32")),
        "int_mul": E.BinaryOp("*", c("i32"), c("k")),
        "int_floor_mod": E.BinaryOp("%", c("i32"), lit(-7)),
        "int_mod_nullable": E.BinaryOp("%", c("i64"), c("k")),
        "int_div_float": E.BinaryOp("/", c("i64"), c("i32")),
        **{f"dec_add_s{sc}": E.BinaryOp("+", c(f"d{sc}"), c("d2"))
           for sc in range(7)},
        **{f"dec_mul_s{sc}": E.BinaryOp("*", c(f"d{sc}"), c("d3"))
           for sc in range(7)},
        "dec_sub_int": E.BinaryOp("-", lit(1), c("d2")),
        "dec_div": E.BinaryOp("/", c("d5"), c("d1")),
        "dec_times_float": E.BinaryOp("*", c("d4"), c("f32")),
        "dec_mod": E.BinaryOp("%", c("d2"), c("d0")),
        "f32_mul": E.BinaryOp("*", c("f32"), c("f32")),
        "f32_div_f64": E.BinaryOp("/", c("f32"), c("f64")),
        "f64_fma_shape": E.BinaryOp(
            "+", E.BinaryOp("*", c("f64"), c("f64")), c("f64")),
        "f64_mod": E.BinaryOp("%", c("f64"), lit(7.5, DT.float64())),
        "f32_plus_int": E.BinaryOp("+", c("f32"), c("i32")),
        "cmp_eq": E.Compare("=", c("k"), lit(1)),
        "cmp_ne_float": E.Compare("!=", c("f32"), c("f32")),
        "cmp_lt_dec": E.Compare("<", c("d2"), lit(-1.5)),
        "cmp_le_mixed": E.Compare("<=", c("d3"), c("f64")),
        "cmp_gt_int": E.Compare(">", c("i32"), c("k")),
        "cmp_ge_date": E.Compare(">=", c("day"), lit("1960-03-01")),
        "dict_eq": E.Compare("=", c("s"), lit("bz1")),
        "dict_ne": E.Compare("!=", c("s"), lit("ax0")),
        "dict_lt": E.Compare("<", c("s"), lit("by0")),
        "dict_ge_flipped": E.Compare(">=", lit("bx1"), c("s")),
        "dict_in": E.InList(c("s"), ("ax0", "cz1", "none")),
        "dict_not_in": E.InList(c("s"), ("ay1",), True),
        "like": E.Func("like", (c("s"), lit("%y_"))),
        "prefix": E.Func("prefix", (c("s"), lit("c"))),
        "contains": E.Func("contains", (c("s"), lit("z"))),
        "int_in": E.InList(c("k"), (1, -2, 3)),
        "int_not_in": E.InList(c("i64"), (5,), True),
        "between": E.Between(c("i32"), lit(-100), lit(5000)),
        "not_between": E.Between(c("d2"), lit(-3.5), lit(7.25), True),
        "and3": E.BoolOp("and", (E.Compare(">", c("k"), lit(0)),
                                 E.Compare("<", c("f64"), lit(1.5)),
                                 E.IsNull(c("s"), True))),
        "or3": E.BoolOp("or", (E.Compare("=", c("k"), lit(2)),
                               E.Compare(">", c("i32"), lit(0)),
                               E.Compare("=", c("s"), lit("cx0")))),
        "not": E.Not(E.Compare(">", c("k"), lit(0))),
        "is_null": E.IsNull(c("d2")),
        "is_not_null": E.IsNull(c("i32"), True),
        "is_null_nonnullable": E.IsNull(c("i64")),
        "case": E.Case(((E.Compare("<", c("k"), lit(0)), c("d2")),
                        (E.IsNull(c("i32")), c("d3"))), c("d0")),
        "case_no_default": E.Case(((E.Compare(">", c("f32"), lit(0.0)),
                                    c("i32")),)),
        "case_null_literal": E.Case(((E.Compare("=", c("k"), lit(1)),
                                      lit(None)),), c("k")),
        "cast_dec_down": E.Cast(c("d6"), DT.decimal(18, 1)),
        "cast_dec_up": E.Cast(c("d1"), DT.decimal(18, 4)),
        "cast_dec_int": E.Cast(c("d3"), DT.int32()),
        "cast_dec_float": E.Cast(c("d2"), DT.float64()),
        "cast_float_int": E.Cast(c("g"), DT.int64()),
        "cast_float_int32": E.Cast(E.BinaryOp("*", c("g"), lit(2.5)),
                                   DT.int32()),
        "cast_float_dec": E.Cast(c("g"), DT.decimal(18, 2)),
        # NaN, infinities and 1e300: saturated as XLA converts, NaN to 0
        "cast_nan_inf_int64": E.Cast(c("f32"), DT.int64()),
        "cast_nan_inf_int32": E.Cast(c("f64"), DT.int32()),
        "cast_nan_inf_dec": E.Cast(c("f64"), DT.decimal(18, 2)),
        "cast_int_dec": E.Cast(c("i32"), DT.decimal(18, 3)),
        "cast_int_float": E.Cast(c("i64"), DT.float32()),
        "extract_year": E.Func("extract_year", (c("day"),)),
        "extract_month": E.Func("extract_month", (c("day"),)),
        "extract_day": E.Func("extract_day", (c("day"),)),
        "abs_int": E.Func("abs", (c("i32"),)),
        "abs_float": E.Func("abs", (c("f32"),)),
        "neg_dec": E.Func("neg", (c("d4"),)),
        "neg_float": E.Func("neg", (c("f64"),)),
        "least": E.Func("least", (c("i32"), c("k"), lit(5))),
        "greatest_float": E.Func("greatest", (c("f64"), c("f32"))),
        "greatest_dec": E.Func("greatest", (c("d2"), c("d5"))),
    }[name]


NODE_CASES = [
    "colref_in_arith", "slotless_literal_mix", "int_add_wraps", "int_sub",
    "int_mul", "int_floor_mod", "int_mod_nullable", "int_div_float",
    *[f"dec_add_s{sc}" for sc in range(7)],
    *[f"dec_mul_s{sc}" for sc in range(7)],
    "dec_sub_int", "dec_div", "dec_times_float", "dec_mod", "f32_mul",
    "f32_div_f64", "f64_fma_shape", "f64_mod", "f32_plus_int", "cmp_eq",
    "cmp_ne_float", "cmp_lt_dec", "cmp_le_mixed", "cmp_gt_int",
    "cmp_ge_date", "dict_eq", "dict_ne", "dict_lt", "dict_ge_flipped",
    "dict_in", "dict_not_in", "like", "prefix", "contains", "int_in",
    "int_not_in", "between", "not_between", "and3", "or3", "not",
    "is_null", "is_not_null", "is_null_nonnullable", "case",
    "case_no_default", "case_null_literal", "cast_dec_down", "cast_dec_up",
    "cast_dec_int", "cast_dec_float", "cast_float_int", "cast_float_int32",
    "cast_float_dec", "cast_nan_inf_int64", "cast_nan_inf_int32",
    "cast_nan_inf_dec",
    "cast_int_dec", "cast_int_float", "extract_year", "extract_month",
    "extract_day", "abs_int", "abs_float", "neg_dec", "neg_float", "least",
    "greatest_float", "greatest_dec",
]
BOOL_CASES = [n for n in NODE_CASES if n.startswith(
    ("cmp_", "dict_", "like", "prefix", "contains", "int_in", "int_not_in",
     "between", "not_between", "and3", "or3", "not", "is_"))]


@pytest.mark.parametrize("name", NODE_CASES)
def test_node_kind_matches_route_and_jax(batches, name):
    jb, tb = batches
    _check(jb, tb, _case(J, name), _case(T, name))


@pytest.mark.parametrize("name", BOOL_CASES)
def test_predicate_matches_route_and_jax(batches, name):
    jb, tb = batches
    _check(jb, tb, _case(J, name), _case(T, name), predicate=True)


def test_multi_output_program_shares_subexpressions(batches):
    """evaluate_many lowers a list as ONE program whose outputs equal
    each tree's torch route."""
    _jb, tb = batches
    names = ["dec_mul_s2", "dec_sub_int", "case", "abs_int", "is_null"]
    trees = [_case(T, n) for n in names]
    c0 = _counts()
    got = TEC.evaluate_many(trees, tb)
    assert _counts()["expr k24 trees"] == c0["expr k24 trees"] + len(trees)
    for n, t, (v, vv) in zip(names, trees, got):
        rv, rvv = TEC._route(t, tb)
        _same_bits(v, rv, n)
        assert (vv is None) == (rvv is None), n
        if vv is not None:
            _same_bits(vv, rvv, n)


# ---------------------------------------------------------------------------
# Kleene truth tables


def _kleene_batch(C, **kw):
    # x > 0 is TRUE, FALSE or NULL on rows 0-2; y likewise; all 9 pairs
    xs = np.array([1, -1, 0] * 3, np.int32)
    ys = np.repeat(np.array([1, -1, 0], np.int32), 3)
    vx = np.array([True, True, False] * 3)
    vy = np.repeat(np.array([True, True, False]), 3)
    DT = C.DataType
    schema = C.Schema((C.Field("x", DT.int32(True)),
                       C.Field("y", DT.int32(True))))
    t = C.Table("k", schema, {"x": xs, "y": ys}, {}, {"x": vx, "y": vy})
    return C.make_batch(t.data, t.schema, t.dicts, valid=t.valid, **kw)


_TRUTH = {
    # (x, y) in T F N order, row = 3 * y + x: (value, known)
    "and": [(True, True), (False, True), (None, False),
            (False, True), (False, True), (False, True),
            (None, False), (False, True), (None, False)],
    "or": [(True, True), (True, True), (True, True),
           (True, True), (False, True), (None, False),
           (True, True), (None, False), (None, False)],
}


@pytest.mark.parametrize("op", ["and", "or"])
def test_kleene_truth_table(op):
    jb, tb = _kleene_batch(JC), _kleene_batch(TC, device="cpu")
    mk = (lambda X: X.E.BoolOp(op, (X.E.Compare(">", X.col("x"), X.lit(0)),
                                    X.E.Compare(">", X.col("y"), X.lit(0)))))
    v, vv = _fused_vs_route(mk(T), tb)
    jv, jvv = JEC.evaluate(mk(J), jb)
    _same_bits(np.asarray(jvv), vv, "Kleene validity vs JAX")
    vv, v = _np(vv), _np(v)
    for row, (want, known) in enumerate(_TRUTH[op]):
        assert bool(vv[row]) == known, (op, row)
        if known:
            assert bool(v[row]) == want, (op, row)
            assert bool(np.asarray(jv)[row]) == want, (op, row)
    # NOT keeps the plane
    nv, nvv = _fused_vs_route(T.E.Not(mk(T)), tb)
    _same_bits(nvv, vv, "NOT validity")
    # and the predicate form rejects every row that is not TRUE
    m = _np(_fused_vs_route(mk(T), tb, predicate=True)[0])
    assert [bool(x) for x in m[:9]] == [w is True for w, _k in _TRUTH[op]]
    assert not m[9:].any()  # padding rows are dead


# ---------------------------------------------------------------------------
# the TPC-H statements' trees at SF 0.01


def _to_jax(x):
    """A port IR node, DataType or dictionary as the JAX package's."""
    from oceanbase_tpu_torch.core.dictionary import Dictionary as TD
    from oceanbase_tpu_torch.core.dtypes import DataType as TDT

    if isinstance(x, TDT):
        return JC.DataType(JC.TypeKind(x.kind.value), x.precision, x.scale,
                           x.nullable)
    if isinstance(x, TD):
        return JC.Dictionary(x.values(), sorted_=x.sorted)
    if isinstance(x, tuple):
        return tuple(_to_jax(v) for v in x)
    if isinstance(x, TE.Expr):
        cls = getattr(JE, type(x).__name__)
        return cls(**{f.name: _to_jax(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    return x


def _batch_to_jax(tb):
    import jax.numpy as jnp
    from oceanbase_tpu.core.column import ColumnBatch as JB

    schema = JC.Schema(tuple(JC.Field(f.name, _to_jax(f.dtype))
                             for f in tb.schema.fields))
    return JB(cols={n: jnp.asarray(c.numpy()) for n, c in tb.cols.items()},
              valid={n: jnp.asarray(v.numpy()) for n, v in tb.valid.items()},
              sel=jnp.asarray(tb.sel.numpy()),
              nrows=jnp.asarray(int(tb.nrows)), schema=schema,
              dicts={n: _to_jax(d) for n, d in tb.dicts.items()})


def _frame_to_jax(frame):
    import jax.numpy as jnp

    if frame is None:
        return None
    return tuple(jnp.asarray(frame[i].numpy()) for i in range(len(frame)))


@pytest.fixture(scope="module")
def tpch_calls():
    """Every fused call of Q1, Q6, Q14, Q19, Q7 and Q22 (cold and warm,
    so both the inline-literal and the packed-row frames) on the port's
    Session at SF 0.01: (query, trees, predicate, batch, frame)."""
    from oceanbase_tpu_torch.engine.session import Session
    from oceanbase_tpu_torch.models.tpch import datagen, sql_suite

    tables = datagen.generate(sf=0.01, seed=19920101)
    sess = Session(tables, unique_keys=sql_suite.UNIQUE_KEYS, device="cpu")
    calls = []
    orig = TEC._fused

    def capture(exprs, batch, predicate):
        calls.append((q, exprs, predicate, batch, TEC._active_params()))
        return orig(exprs, batch, predicate)

    TEC._fused = capture
    try:
        for q in (1, 6, 14, 19, 7, 22):
            for _ in range(2):
                sess.sql(sql_suite.QUERIES[q]).rows()
    finally:
        TEC._fused = orig
    return calls


@pytest.mark.parametrize("q", [1, 6, 14, 19, 7, 22])
def test_tpch_trees_match_route_and_jax(tpch_calls, q):
    mine = [c for c in tpch_calls if c[0] == q]
    assert mine, f"Q{q}: no fused call"
    assert any(c[2] for c in mine), f"Q{q}: no filter tree"
    for _q, exprs, predicate, tb, frame in mine:
        prev = TEC.set_params(frame)
        try:
            for e in exprs:
                got = _fused_vs_route(e, tb, predicate)
                jb = _batch_to_jax(tb)
                jprev = JEC.set_params(_frame_to_jax(frame))
                try:
                    je = _to_jax(e)
                    if predicate:
                        _same_jax(JEC.compile_predicate(je, jb), got[0],
                                  slice(None), f"Q{q} mask vs JAX")
                        continue
                    jv, jvv = JEC.evaluate(je, jb)
                finally:
                    JEC.set_params(jprev)
                live = np.asarray(jb.sel)
                assert (jvv is None) == (got[1] is None), f"Q{q} {e}"
                if jvv is not None:
                    _same_jax(jvv, got[1], live, f"Q{q} validity")
                    live = live & np.asarray(jvv)
                _same_jax(jv, got[0], live, f"Q{q} {e}")
        finally:
            TEC.set_params(prev)


# ---------------------------------------------------------------------------
# random trees


_NUM = ["i32", "i64", "f32", "f64", "k", "d0", "d2", "d3", "d6"]


def _tree(draw, depth):
    if depth == 0 or draw(st.integers(0, 3)) == 0:
        if draw(st.booleans()):
            return ("col", draw(st.sampled_from(_NUM)))
        return ("lit", draw(st.sampled_from([0, 1, -3, 7, 2.5, -0.25])))
    kind = draw(st.sampled_from(["arith", "case", "func", "cast"]))
    if kind == "arith":
        return ("arith", draw(st.sampled_from("+-*")), _tree(draw, depth - 1),
                _tree(draw, depth - 1))
    if kind == "case":
        return ("case", _pred(draw, depth - 1), _tree(draw, depth - 1),
                _tree(draw, depth - 1))
    if kind == "cast":
        return ("cast", draw(st.sampled_from(["int64", "float64", "dec2"])),
                _tree(draw, depth - 1))
    return ("func", draw(st.sampled_from(["abs", "neg", "least",
                                          "greatest"])),
            _tree(draw, depth - 1), _tree(draw, depth - 1))


def _pred(draw, depth):
    kind = draw(st.sampled_from(["cmp", "bool", "not", "null", "between",
                                 "in"]))
    if kind == "cmp" or depth <= 0:
        return ("cmp", draw(st.sampled_from(["=", "!=", "<", "<=", ">",
                                             ">="])),
                _tree(draw, max(depth - 1, 0)),
                _tree(draw, max(depth - 1, 0)))
    if kind == "bool":
        return ("bool", draw(st.sampled_from(["and", "or"])),
                _pred(draw, depth - 1), _pred(draw, depth - 1))
    if kind == "not":
        return ("not", _pred(draw, depth - 1))
    if kind == "null":
        return ("null", draw(st.booleans()), _tree(draw, depth - 1))
    if kind == "between":
        return ("between", _tree(draw, depth - 1), draw(st.integers(-5, 0)),
                draw(st.integers(0, 5)))
    return ("in", draw(st.sampled_from(["k", "i32"])),
            tuple(draw(st.lists(st.integers(-3, 3), min_size=1,
                                max_size=4))))


def _build(X, t):
    E, c, lit, DT = X.E, X.col, X.lit, X.DT
    tag = t[0]
    if tag == "col":
        return c(t[1])
    if tag == "lit":
        return lit(t[1])
    if tag == "arith":
        return E.BinaryOp(t[1], _build(X, t[2]), _build(X, t[3]))
    if tag == "case":
        return E.Case(((_build(X, t[1]), _build(X, t[2])),), _build(X, t[3]))
    if tag == "cast":
        dt = {"int64": DT.int64(), "float64": DT.float64(),
              "dec2": DT.decimal(18, 2)}[t[1]]
        return E.Cast(_build(X, t[2]), dt)
    if tag == "func":
        args = (_build(X, t[2]),) if t[1] in ("abs", "neg") else (
            _build(X, t[2]), _build(X, t[3]))
        return E.Func(t[1], args)
    if tag == "cmp":
        return E.Compare(t[1], _build(X, t[2]), _build(X, t[3]))
    if tag == "bool":
        return E.BoolOp(t[1], (_build(X, t[2]), _build(X, t[3])))
    if tag == "not":
        return E.Not(_build(X, t[1]))
    if tag == "null":
        return E.IsNull(_build(X, t[2]), t[1])
    if tag == "between":
        return E.Between(_build(X, t[1]), lit(t[2]), lit(t[3]))
    return E.InList(c(t[1]), t[2])


@st.composite
def _trees(draw):
    if draw(st.booleans()):
        return ("value", _tree(draw, 3))
    return ("predicate", _pred(draw, 3))


_RANDOM_BATCHES = {}


@settings(derandomize=True, max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_trees())
def test_random_trees_match_route(spec):
    """Random trees over every numeric column kind: the lowered program
    equals the torch route bit for bit (or raises what the route
    raises), and a tree that reads no column stays on the route."""
    if not _RANDOM_BATCHES:
        _RANDOM_BATCHES["t"] = _batch(TC, device="cpu")
    tb = _RANDOM_BATCHES["t"]
    mode, t = spec
    te = _build(T, t)
    predicate = mode == "predicate"
    try:
        want = (TEC._predicate_route(te, tb) if predicate
                else TEC._route(te, tb))
    except Exception as e:  # noqa: BLE001 - the lowering must raise alike
        with pytest.raises(type(e)):
            if predicate:
                TEC.compile_predicate(te, tb)
            else:
                TEC.evaluate(te, tb)
        return
    if not TEC._refs_of((te,))[0] or isinstance(te, TE.ColRef):
        got = TEC.evaluate(te, tb) if not predicate else (
            TEC.compile_predicate(te, tb), None)
        ref = want if not predicate else (want, None)
        _same_bits(got[0], ref[0], "unlowered tree")
        return
    _fused_vs_route(te, tb, predicate)


# ---------------------------------------------------------------------------
# past one launch's limits


def _wide_and(X, n):
    return X.E.BoolOp("and", tuple(
        X.E.Compare("<", X.col("i64"), X.lit(i * 1000 - 10**11))
        for i in range(n)))


def _long_chain(X, n):
    e = X.col("i64")
    for i in range(n):
        e = X.E.BinaryOp("+", X.E.BinaryOp("*", e, X.lit(3)),
                         X.col(f"d{i % 7}"))
    return e


def test_split_past_the_register_limit(batches):
    """An AND of many compares keeps one value live per term: past the
    register limit the program splits into chained launches, and the
    result still equals the route and JAX."""
    jb, tb = batches
    n = 40
    prog = TP.lower((_wide_and(T, n),), tb, TEC._route, TEC._predicate_route,
                    TEC.set_params, {}, False, True)
    assert len(prog.chunks) > 1
    assert all(ch.nregs <= TP.MAX_REGS for ch in prog.chunks)
    assert any(o[0] == "tmp" for ch in prog.chunks for o in ch.outputs)
    _check(jb, tb, _wide_and(J, n), _wide_and(T, n), predicate=True)


def test_split_past_the_instruction_limit(batches):
    jb, tb = batches
    n = 80
    prog = TP.lower((_long_chain(T, n),), tb, TEC._route,
                    TEC._predicate_route, TEC.set_params, {}, False, False)
    assert len(prog.chunks) > 1
    assert all(len(ch.code) <= TP.MAX_INS for ch in prog.chunks)
    _check(jb, tb, _long_chain(J, n), _long_chain(T, n))


def test_small_limits_split_every_tree(batches):
    """The same trees scheduled under tiny limits (many chunks, spills
    at every cut) compute the same bits."""
    _jb, tb = batches
    for name in ("case", "dec_mul_s5", "or3", "extract_day", "like"):
        te = _case(T, name)
        from oceanbase_tpu_torch.expr import compile as xc

        b = TP._Recorder(tb.cols, tb.valid, {})
        tr = TP.TraceBatch(b, tb)
        v, vv = xc._route(te, tr)
        outs = [v.vid] + ([vv.vid] if isinstance(vv, TP._Val) else [])
        prog = TP.Program()
        prog.out_dtypes = [b.vtype[o] for o in outs]
        prog.pairs = [(0, 1 if len(outs) > 1 else None)]
        TP.schedule(b.ins, b.vtype, outs, prog, max_ins=8, max_regs=4,
                    max_in=4, max_out=6)
        prog.luts = b.luts
        assert len(prog.chunks) > 1, name
        got = kernels.fused_expr_plain(prog, tb)
        rv, rvv = xc._route(te, tb)
        _same_bits(got[0], rv, name)
        if len(outs) > 1:
            _same_bits(got[1], rvv, name)


# ---------------------------------------------------------------------------
# dictionaries grown by DML, and what is not lowered


def test_dictionary_grown_by_insert_gets_a_fresh_lut():
    """A LIKE and an IN over a dictionary column; an INSERT appends a
    matching value to the dictionary; the next run must see it (a new
    program with fresh LUTs), on the port as on the JAX Database."""
    from torch_twins import TwinDatabase

    tw = TwinDatabase.build(n_nodes=1, n_ls=1)
    try:
        s = tw.session()
        s.sql("create table tags (id int primary key, name varchar(16))")
        s.sql("insert into tags values (1, 'alpha'), (2, 'beta'), "
              "(3, 'gamma')")
        like = "select id from tags where name like 'b%' order by id"
        inl = "select id from tags where name in ('delta', 'beta') " \
              "order by id"
        assert s.sql(like).rows() == [(2,)]
        assert s.sql(inl).rows() == [(2,)]

        def tag_programs():
            return [v for v in TEC._PROGRAMS.values()
                    if any(d is not None and "alpha" in d.values()
                           for d in v[1])]

        n0 = len(tag_programs())
        assert n0 >= 2
        s.sql("insert into tags values (4, 'bravo'), (5, 'delta')")
        assert s.sql(like).rows() == [(2,), (4,)]
        assert s.sql(inl).rows() == [(2,), (5,)]
        # the grown dictionary's programs replaced the stale ones: no
        # program (or its LUTs) is kept for the old length
        progs = tag_programs()
        assert len(progs) == n0
        for _prog, dicts, vers in progs:
            for d, ver in zip(dicts, vers):
                if d is not None:
                    assert ver == (len(d), d.sorted)
    finally:
        tw.close()


def test_unlowered_trees_keep_the_route_forms(batches):
    """A bare column costs no copy (the batch's own tensor), a tree that
    reads no column stays 0-d, and neither counts as a K24 tree."""
    _jb, tb = batches
    c0 = _counts()
    v, vv = TEC.evaluate(T.col("d2"), tb)
    assert v is tb.cols["d2"] and vv is tb.valid["d2"]
    v, vv = TEC.evaluate(T.E.BinaryOp("*", T.lit(2.5), T.lit(4)), tb)
    assert v.dim() == 0 and vv is None
    assert _counts() == c0
    # a lowered tree over non-nullable inputs keeps valid None
    v, vv = TEC.evaluate(_case(T, "f32_mul"), tb)
    assert vv is None and v.shape == (tb.capacity,)
    # IS NULL of a non-nullable column: a column of FALSE, valid None
    v, vv = TEC.evaluate(_case(T, "is_null_nonnullable"), tb)
    assert vv is None and not _np(v).any()


def test_slotted_literals_read_the_packed_row(batches):
    """A slotted literal in a lowered tree reads its slot from the
    packed int64 row (a PackedParams frame) exactly as the route reads
    the frame's 0-d tensor: int32, float32, decimal and date slots."""
    _jb, tb = batches
    DT = TC.DataType
    from oceanbase_tpu_torch.engine.executor import pack_qparams

    spec = [(DT.int32(), 0, 1), (DT.float32(), 1, 1),
            (DT.decimal(18, 2), 2, 1), (DT.date(), 3, 1)]
    row = torch.from_numpy(pack_qparams(
        [-17, 0.1, -3.25, "1961-07-04"], [d for d, _o, _w in spec], spec))
    lit = [T.E.Literal(v, d, slot=i) for i, (v, (d, _o, _w)) in enumerate(
        zip([0, 0.0, 0.0, "1970-01-01"], spec))]
    trees = [T.E.BinaryOp("*", T.col("i32"), lit[0]),
             T.E.BinaryOp("+", T.col("f32"), lit[1]),
             T.E.Compare("<", T.col("d2"), lit[2]),
             T.E.Compare(">=", T.col("day"), lit[3])]
    prev = TEC.set_params(TEC.PackedParams(row, spec))
    try:
        for e in trees:
            _fused_vs_route(e, tb)
    finally:
        TEC.set_params(prev)
    # the legacy tuple frame gives the same bits
    frame = tuple(TEC.PackedParams(row, spec)[i] for i in range(4))
    prev = TEC.set_params(frame)
    try:
        for e in trees:
            _fused_vs_route(e, tb)
    finally:
        TEC.set_params(prev)


# ---------------------------------------------------------------------------
# what the cache keys and bounds, and what is refused


def test_float_zero_literals_key_their_own_programs(batches):
    """Literal(0.0) == Literal(-0.0) with equal hashes, yet the constant's
    bits are baked into the program: 1 / (f + 0.0) and 1 / (f + -0.0)
    differ where f is -0.0 (+inf against -inf), and each must equal the
    route and JAX however the two follow each other."""
    jb, tb = batches

    def tree(X, z):
        return X.E.BinaryOp("/", X.lit(1.0), X.E.BinaryOp(
            "+", X.col("f64"), X.E.Literal(z, X.DT.float64())))

    assert tree(T, 0.0) == tree(T, -0.0)
    outs = []
    for z in (0.0, -0.0, 0.0, -0.0):
        v, _vv = _fused_vs_route(tree(T, z), tb)
        _check(jb, tb, tree(J, z), tree(T, z))
        outs.append(_np(v)[1])
    assert outs == [np.inf, -np.inf, np.inf, -np.inf]


def _plant_untraceable(monkeypatch):
    """Make the route compute abs() with a torch call the tracer does not
    record (torch.sin)."""
    real = TEC._eval_func

    def planted(e, batch):
        if e.name == "abs":
            v, valid = TEC._route(e.args[0], batch)
            return torch.sin(v), valid
        return real(e, batch)

    monkeypatch.setattr(TEC, "_eval_func", planted)
    return T.E.Func("abs", (T.E.BinaryOp("+", T.col("f64"), T.lit(1.5)),))


def _untraceable_raises(tb, tree):
    c0, n0 = _counts(), len(TEC._PROGRAMS)
    with pytest.raises(TP.NotLowerable):
        TEC.evaluate(tree, tb)
    with pytest.raises(TP.NotLowerable):
        TEC.evaluate_many((T.col("i64"), tree), tb)
    with pytest.raises(TP.NotLowerable):
        TEC.compile_predicate(T.E.Compare("<", tree, T.lit(0.5)), tb)
    # nothing ran on the route in its place, and nothing was cached
    assert _counts() == c0 and len(TEC._PROGRAMS) == n0


def test_untraceable_tree_raises(batches, monkeypatch):
    """A tree the tracer cannot record is the statement's error: it never
    runs whole on the torch route."""
    _jb, tb = batches
    _untraceable_raises(tb, _plant_untraceable(monkeypatch))


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="a CUDA batch needs the card (K24 launches there)")
def test_untraceable_tree_raises_on_a_cuda_batch(monkeypatch):
    tb = _batch(TC, device="cuda")
    _untraceable_raises(tb, _plant_untraceable(monkeypatch))


def test_device_luts_are_shared_and_bounded_by_bytes(monkeypatch):
    """Programs holding the same host table share one device copy; the
    copies are bounded by bytes, least recently used out first (the
    "meta" device stands in for the card: copies without storage)."""
    monkeypatch.setattr(TP, "_DEV_LUTS", TP.OrderedDict())
    monkeypatch.setattr(TP, "_dev_lut_bytes", 0)
    monkeypatch.setattr(TP, "_DEV_LUT_BYTES_MAX", 3000)
    cpu = torch.zeros(10, dtype=torch.bool)
    assert TP.device_lut(cpu, "cpu") is cpu
    a, b, c = (torch.zeros(1000, dtype=torch.bool) for _ in range(3))
    p1, p2 = TP.Program(), TP.Program()
    p1.luts, p2.luts = [a, b], [b]
    da, db = p1.luts_on("meta")
    assert da.device.type == "meta" and p2.luts_on("meta")[0] is db
    assert TP._dev_lut_bytes == 2000 and p1.nbytes == 2000
    TP.device_lut(a, "meta")  # a is now the most recently used
    TP.device_lut(c, "meta")
    TP.device_lut(torch.zeros(1000, dtype=torch.bool), "meta")
    assert TP._dev_lut_bytes <= 3000
    keys = {k[0] for k in TP._DEV_LUTS}
    assert id(b) not in keys and id(a) in keys and id(c) in keys


def test_program_cache_is_bounded_by_lut_bytes(batches, monkeypatch):
    """The program cache holds at most _PROGRAM_BYTES_MAX bytes of host
    lookup tables, oldest programs out first; an evicted tree lowers
    again and still equals the route."""
    _jb, tb = batches
    monkeypatch.setattr(TEC, "_PROGRAMS", {})
    monkeypatch.setattr(TEC, "_program_bytes", 0)
    words = [w for w in WORDS if w.startswith("a")]
    trees = [T.E.Func("like", (T.col("s"), T.lit(f"%{w[1:]}")))
             for w in words]
    nb = len(WORDS)  # one bool per dictionary value
    monkeypatch.setattr(TEC, "_PROGRAM_BYTES_MAX", 2 * nb)
    for e in trees + trees[:1]:
        _fused_vs_route(e, tb, predicate=True)
        assert TEC._program_bytes <= 2 * nb
        assert len(TEC._PROGRAMS) <= 2
    assert TEC._program_bytes == sum(v[0].nbytes
                                     for v in TEC._PROGRAMS.values())


DOCS = ['{"a": 1, "b": [1, 2, 3], "c": "x"}', '{"a": 2, "b": [], "c": "y"}',
        "not json", '{"b": [1]}', "[1, 2]", '{"a": null, "c": "x"}']
TEXTS = ["the quick fox", "lazy dog", "quick brown fox jumps", "A B",
         "  padded  ", "qa"]
NUMS = ["1.5", "x", "-3", "1e3", " 7 "]


def _text_batch(C, **kw):
    rng = np.random.default_rng(88)
    n = 97
    DT = C.DataType
    data = {"doc": rng.integers(0, len(DOCS), n).astype(np.int32),
            "txt": rng.integers(0, len(TEXTS), n).astype(np.int32),
            "num": rng.integers(0, len(NUMS), n).astype(np.int32),
            "i": rng.integers(-5, 5, n)}
    valid = {"doc": rng.random(n) < 0.8, "txt": rng.random(n) < 0.8}
    schema = C.Schema((C.Field("doc", DT.varchar(True)),
                       C.Field("txt", DT.varchar(True)),
                       C.Field("num", DT.varchar()), C.Field("i", DT.int64())))
    dicts = {"doc": C.Dictionary(list(DOCS)), "txt": C.Dictionary(list(TEXTS)),
             "num": C.Dictionary(list(NUMS))}
    return C.make_batch(data, schema, dicts, valid=valid, **kw)


def _text_trees(X):
    E, c, lit, DT = X.E, X.col, X.lit, X.DT

    def f(name, *args):
        return E.Func(name, tuple(args))

    ja = f("json_extract", c("doc"), lit("$.a"))
    return {
        "json_extract_eq": E.Compare("=", ja, lit("1")),
        "json_extract_null": E.IsNull(ja),
        "json_unquote_eq": E.Compare("=", f("json_unquote", f(
            "json_extract", c("doc"), lit("$.c"))), lit("x")),
        "json_type_eq": E.Compare("=", f("json_type", ja), lit("INTEGER")),
        "json_valid": f("json_valid", c("doc")),
        "json_array_length": E.BinaryOp(
            "+", f("json_array_length", c("doc"), lit("$.b")), c("i")),
        "fts_match": f("fts_match", c("txt"), lit("quick fox")),
        "upper_eq": E.Compare("=", f("upper", c("txt")), lit("LAZY DOG")),
        "trim_in": E.InList(f("trim", c("txt")), ("padded", "qa")),
        "substr_lt": E.Compare("<", f("substr", c("txt"), lit(1), lit(3)),
                               lit("qz")),
        "cast_num": E.BinaryOp("*", E.Cast(c("num"), DT.float64()), c("i")),
        "and_mix": E.BoolOp("and", (f("json_valid", c("doc")),
                                    E.Compare(">", c("i"), lit(0)))),
    }


@pytest.mark.parametrize("name", list(_text_trees(T)))
def test_string_views_json_and_fts_lower_as_lookup_tables(name):
    """String views (substr, upper, trim), the JSON functions, fts_match
    and a varchar cast are inside the op set: the route builds a table
    over the dictionary's values on the host, and the program reads it
    by code. Each tree lowers with nothing on the torch route, and equals
    the route bit for bit and JAX."""
    jb, tb = _text_batch(JC), _text_batch(TC, device="cpu")
    je, te = _text_trees(J)[name], _text_trees(T)[name]
    _check(jb, tb, je, te)
    if TEC.infer_type(te, tb.schema).kind is TC.TypeKind.BOOL:
        _check(jb, tb, je, te, predicate=True)
