"""Expression evaluation: the JAX engine and the torch port on the same
batch, expression for expression.

Every case of tests/test_expr.py plus promotion, negative-decimal rescale,
floor-mod, NULL and function cases runs through both backends on one
batch built from the same numpy arrays. Integers, scaled decimals, dates,
dictionary codes and masks must match exactly, dtype included; float
results compare at rel 1e-12 (each is the same IEEE division of equal
integers; the tolerance only guards XLA's constant-divisor rewrite).
"""

import types

import numpy as np
import pytest
import torch

import oceanbase_tpu.core as JC
import oceanbase_tpu.expr as JE
import oceanbase_tpu.expr.compile as JEC
import oceanbase_tpu_torch.core as TC
import oceanbase_tpu_torch.expr as TE
import oceanbase_tpu_torch.expr.compile as TEC


def _day(s):
    return int(np.datetime64(s, "D").astype(np.int64))


DATA = {
    "qty": np.array([100, 200, 300, 400, 250], np.int32),
    "price": np.array([1000, 2000, 3000, 4000, -1550], np.int64),
    "disc": np.array([5, 6, 7, 10, -149], np.int32),
    "tag": np.array([0, 1, 0, 2, 1], np.int32),
    "d": np.array([_day("1994-01-01"), _day("1994-06-01"), _day("1995-01-01"),
                   _day("1993-12-31"), _day("2000-02-29")], np.int32),
    "n": np.array([1, 2, 3, 4, -7], np.int32),
    "x": np.array([1, 2, 3, 0, -5], np.int32),
    "f": np.array([0.5, -0.0, 2.25, -3.5, 1e10], np.float64),
    "w": np.array([150, -150, 149, -149, -250], np.int64),
}
VALID = {"x": np.array([True, False, True, True, False])}
TAGS = ["AIR", "RAIL", "SHIP"]


def _fields(C):
    DT = C.DataType
    return (
        ("qty", DT.decimal(9, 2)), ("price", DT.decimal(12, 2)),
        ("disc", DT.decimal(9, 2)), ("tag", DT.varchar()),
        ("d", DT.date()), ("n", DT.int32()),
        ("x", DT.int32(nullable=True)), ("f", DT.float64()),
        ("w", DT.decimal(12, 4)),
    )


def _batch(C, **kw):
    schema = C.Schema(tuple(C.Field(n, t) for n, t in _fields(C)))
    t = C.Table("t", schema, dict(DATA),
                {"tag": C.Dictionary(list(TAGS), sorted_=True)}, dict(VALID))
    return C.make_batch(t.data, t.schema, t.dicts, valid=t.valid, **kw)


@pytest.fixture(scope="module")
def batches():
    return _batch(JC), _batch(TC, device="cpu")


J = types.SimpleNamespace(E=JE, DT=JC.DataType, col=JE.col, lit=JE.lit)
T = types.SimpleNamespace(E=TE, DT=TC.DataType, col=TE.col, lit=TE.lit)


def _case(X, name):
    E, col, lit, DT = X.E, X.col, X.lit, X.DT
    return {
        "decimal_mul": E.BinaryOp("*", col("price"),
                                  E.BinaryOp("-", lit(1), col("disc"))),
        "decimal_cmp_float_literal": E.Compare("<=", col("disc"), lit(0.06)),
        "date_range": E.and_(E.Compare(">=", col("d"), lit("1994-01-01")),
                             E.Compare("<", col("d"), lit("1995-01-01"))),
        "between": E.Between(col("n"), lit(2), lit(3)),
        "dict_eq": E.Compare("=", col("tag"), lit("AIR")),
        "dict_ne": E.Compare("!=", col("tag"), lit("AIR")),
        "dict_in": E.InList(col("tag"), ("AIR", "SHIP")),
        "dict_like": E.Func("like", (col("tag"), lit("%AI%"))),
        "dict_range": E.Compare("<", col("tag"), lit("RAIL")),
        "dict_prefix": E.Func("prefix", (col("tag"), lit("SH"))),
        "extract_year": E.Func("extract_year", (col("d"),)),
        "extract_month": E.Func("extract_month", (col("d"),)),
        "extract_day": E.Func("extract_day", (col("d"),)),
        "case_when": E.Case(
            whens=((E.Compare("=", col("tag"), lit("AIR")),
                    E.BinaryOp("*", col("price"), col("disc"))),),
            default=lit(0)),
        "case_null_default": E.Case(
            whens=((E.Compare(">", col("n"), lit(1)), col("n")),)),
        "division_float": E.BinaryOp("/", col("price"), col("qty")),
        "float_arith": E.BinaryOp("+", col("f"), col("n")),
        "float_mod": E.BinaryOp("%", col("f"), lit(2.0, DT.float64())),
        "int_floor_mod": E.BinaryOp("%", col("n"), lit(-3)),
        "int_mod_by_zero_col": E.BinaryOp("%", col("n"), col("x")),
        "nullable_compare": E.Compare(">", col("x"), lit(0)),
        "is_null": E.IsNull(col("x")),
        "is_not_null": E.IsNull(col("x"), negated=True),
        "kleene_and": E.and_(E.Compare(">", col("x"), lit(0)),
                             E.Compare(">", col("n"), lit(2))),
        "kleene_or": E.or_(E.Compare(">", col("x"), lit(0)),
                           E.Compare(">", col("n"), lit(2))),
        "not": E.Not(E.Compare(">", col("n"), lit(2))),
        "neg_decimal_rescale_down": E.Cast(col("w"), DT.decimal(12, 2)),
        "neg_decimal_to_int": E.Cast(col("price"), DT.int64()),
        "decimal_mul_rescale_down": E.BinaryOp("*", col("w"), col("w")),
        "decimal_add_rescale_up": E.BinaryOp("+", col("w"), col("disc")),
        "decimal_to_float": E.Cast(col("disc"), DT.float64()),
        "int_to_decimal": E.Cast(col("n"), DT.decimal(9, 2)),
        "float_to_decimal": E.Cast(col("f"), DT.decimal(18, 2)),
        "abs": E.Func("abs", (col("n"),)),
        "neg": E.Func("neg", (col("price"),)),
        "least": E.Func("least", (col("n"), col("x"))),
        "greatest": E.Func("greatest", (col("qty"), col("n"))),
        "literal_only": E.BinaryOp("+", lit(2), lit(3)),
        "in_list_ints": E.InList(col("n"), (1, 3, -7)),
    }[name]


CASES = [
    "decimal_mul", "decimal_cmp_float_literal", "date_range", "between",
    "dict_eq", "dict_ne", "dict_in", "dict_like", "dict_range",
    "dict_prefix", "extract_year", "extract_month", "extract_day",
    "case_when", "case_null_default", "division_float", "float_arith",
    "float_mod", "int_floor_mod", "int_mod_by_zero_col", "nullable_compare",
    "is_null", "is_not_null", "kleene_and", "kleene_or", "not",
    "neg_decimal_rescale_down", "neg_decimal_to_int",
    "decimal_mul_rescale_down", "decimal_add_rescale_up", "decimal_to_float",
    "int_to_decimal", "float_to_decimal", "abs", "neg", "least", "greatest",
    "literal_only", "in_list_ints",
]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _assert_same(jv, tv, what):
    jv, tv = _np(jv), _np(tv)
    assert jv.dtype == tv.dtype, f"{what}: dtype {jv.dtype} vs {tv.dtype}"
    assert jv.shape == tv.shape, f"{what}: shape {jv.shape} vs {tv.shape}"
    if jv.dtype.kind == "f":
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0.0,
                                   equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(tv, jv, err_msg=what)


@pytest.mark.parametrize("name", CASES)
def test_evaluate_matches_jax(batches, name):
    jb, tb = batches
    je, te = _case(J, name), _case(T, name)
    assert JEC.infer_type(je, jb.schema).kind.value == \
        TEC.infer_type(te, tb.schema).kind.value
    jv, jvalid = JEC.evaluate(je, jb)
    tv, tvalid = TEC.evaluate(te, tb)
    assert (jvalid is None) == (tvalid is None)
    # live rows only: dead padding rows hold arbitrary storage values
    live = np.asarray(jb.sel)
    if jvalid is not None:
        _assert_same(np.asarray(jvalid)[live], _np(tvalid)[live],
                     f"{name} validity")
        live = live & np.asarray(jvalid)
    if np.ndim(jv):
        jv, tv = np.asarray(jv)[live], _np(tv)[live]
    _assert_same(jv, tv, name)


@pytest.mark.parametrize("name", ["decimal_cmp_float_literal", "date_range",
                                  "dict_in", "nullable_compare", "kleene_or",
                                  "between"])
def test_compile_predicate_matches_jax(batches, name):
    jb, tb = batches
    jm = JEC.compile_predicate(_case(J, name), jb)
    tm = TEC.compile_predicate(_case(T, name), tb)
    assert not _np(tm)[~np.asarray(jb.sel)].any()
    _assert_same(jm, tm, name)


def _slotted(X, value):
    return X.E.Literal(value, X.DT.int64(), slot=0)


@pytest.mark.parametrize("op", ["<", "*", "="])
def test_zero_d_int64_param_widens_int32(batches, op):
    """int32[n] op a bound 0-d int64: JAX promotes to int64. torch would
    keep int32 (0-d tensors never widen) and wrap 3e9; the port casts."""
    jb, tb = batches
    big = 3_000_000_000
    mk = (lambda X: X.E.Compare(op, X.col("n"), _slotted(X, big))) \
        if op != "*" else (lambda X: X.E.BinaryOp("*", X.col("n"),
                                                 _slotted(X, big)))
    import jax.numpy as jnp

    prev = JEC.set_params((jnp.asarray(np.int64(big)),))
    try:
        jv, _ = JEC.evaluate(mk(J), jb)
    finally:
        JEC.set_params(prev)
    prev = TEC.set_params((torch.tensor(big, dtype=torch.int64),))
    try:
        tv, _ = TEC.evaluate(mk(T), tb)
    finally:
        TEC.set_params(prev)
    live = np.asarray(jb.sel)
    _assert_same(np.asarray(jv)[live], _np(tv)[live], op)
    if op == "<":
        assert _np(tv).all()


def test_torch_zero_d_tensors_do_not_widen():
    """The hazard the port's explicit casts guard against, pinned."""
    a = torch.tensor([1, 2], dtype=torch.int32)
    assert (a * torch.tensor(5, dtype=torch.int64)).dtype == torch.int32
    lv, rv = TEC._promote(a, torch.tensor(5, dtype=torch.int64))
    assert lv.dtype == rv.dtype == torch.int64


@pytest.mark.parametrize("vals,to_scale", [
    ([-150, -149, -151, 150, 149, -5, 5, 0], 0),
    ([-12345, -12350, 12350, -1, 1], 1),
])
def test_negative_decimal_rescale(vals, to_scale):
    """Round-half-away-from-zero scale-down on negatives (floor division
    on both sides, as jnp's //)."""
    a = np.asarray(vals, np.int64)
    import jax.numpy as jnp

    jv = JEC._rescale_decimal(jnp.asarray(a), 2, to_scale)
    tv = TEC._rescale_decimal(torch.from_numpy(a), 2, to_scale)
    _assert_same(jv, tv, "rescale")


def test_bind_value_matches_jax():
    for v, t in [("1995-06-17", "date"), (0.07, "dec"), (24, "int")]:
        jt = {"date": JC.DataType.date(), "dec": JC.DataType.decimal(3, 2),
              "int": JC.DataType.int64()}[t]
        tt = {"date": TC.DataType.date(), "dec": TC.DataType.decimal(3, 2),
              "int": TC.DataType.int64()}[t]
        a, b = JEC.bind_value(v, jt), TEC.bind_value(v, tt)
        assert type(a) is type(b) and a == b
