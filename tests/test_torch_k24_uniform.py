"""K24's redesigned lowering: uniform values, register classes and the
file's two row widths, run through `fused_expr_plain` (the kernel's plain
version, which interprets the same code: the uniform prologue as 0-d
tensors, the row code over a file of two classes).

- Uniform marking: parameters, constants and every instruction whose
  operands are all uniform leave the row code for the chunk's prologue;
  a row operand may name a uniform slot (a compare with a literal reads
  one row value).
- Register classes: values of 32 bits or fewer and int64 / float64 values
  are allocated from their own pools of file slots.
- Order: each tree is evaluated heaviest operand first (as Sethi and
  Ullman order a tree), which keeps few values live.
- Row widths: a chunk whose file takes at most FILE8_BYTES a row runs 8
  rows a thread, a larger one 4. Q6's predicate and Q1's chunks take 8
  rows with their LOADs first; both widths, and a program forced onto 4
  rows, equal the torch route bit for bit and the JAX package's evaluate /
  compile_predicate.
- Derandomized Hypothesis trees that mix uniform subtrees (literals and
  parameters combined) with row operands.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import oceanbase_tpu.expr.compile as JEC
import oceanbase_tpu_torch.core as TC
import oceanbase_tpu_torch.expr.compile as TEC
from oceanbase_tpu_torch import kernels
from oceanbase_tpu_torch.expr import program as TP
from tests.test_torch_fused_expr import (
    J,
    T,
    _batch,
    _batch_to_jax,
    _check,
    _frame_to_jax,
    _fused_vs_route,
    _same_jax,
    _to_jax,
    batches,  # noqa: F401 - the module's fixture
    tpch_calls,  # noqa: F401 - the module's fixture
)

NAMES = {v: k for k, v in vars(TP).items() if k.startswith("OP_")}


def _lower(tree, tb, predicate):
    return TP.lower((tree,), tb, TEC._route, TEC._predicate_route,
                    TEC.set_params, {}, False, predicate)


def _check_layout(prog):
    """Every chunk's code is well formed: the prologue holds only uniform
    values and reads only uniform slots, the row code holds no PARAM or
    CONST, each file slot within its class's count, the row width as the
    file's bytes give it, a hoisted chunk's LOADs first."""
    for ch in prog.chunks:
        nuni = len(ch.ucode)
        assert nuni <= TP.MAX_UNI
        assert len(ch.ucode) + len(ch.code) <= TP.MAX_INS
        for op, _t, d, a, b, c, _t2, _imm in ch.ucode:
            assert op != TP.OP_LOAD and op != TP.OP_STORE
            assert d < nuni
            nargs = {TP.OP_PARAM: 0, TP.OP_CONST: 0, TP.OP_LUT: 1,
                     TP.OP_CAST: 1, TP.OP_SELECT: 3}.get(
                op, 1 if op in TP.PLAIN_UNARY else 2)
            for x in (a, b, c)[:nargs]:
                assert x & TP.UNI and (x & ~TP.UNI) < d
        wide = {kernels.DTYPE_CODE[torch.int64],
                kernels.DTYPE_CODE[torch.float64]}
        for op, t, d, a, b, c, t2, _imm in ch.code:
            assert op not in (TP.OP_PARAM, TP.OP_CONST), NAMES[op]
            nargs = {TP.OP_LOAD: 0, TP.OP_LUT: 1, TP.OP_CAST: 1,
                     TP.OP_STORE: 1, TP.OP_SELECT: 3}.get(
                op, 1 if op in TP.PLAIN_UNARY else 2)
            for i, x in enumerate((a, b, c)[:nargs]):
                if x & TP.UNI:
                    assert (x & ~TP.UNI) < nuni
                else:
                    cls = (t2 if op == TP.OP_CAST else
                           kernels.DTYPE_CODE[torch.int64]
                           if op == TP.OP_LUT else
                           kernels.DTYPE_CODE[torch.bool]
                           if op == TP.OP_SELECT and i == 0 else t)
                    assert x < (ch.n64 if cls in wide else ch.n32)
            if op != TP.OP_STORE:
                rcls = (kernels.DTYPE_CODE[torch.bool]
                        if TP.OP_EQ <= op <= TP.OP_GE else t)
                assert d < (ch.n64 if rcls in wide else ch.n32)
        nbytes = 4 * ch.n32 + 8 * ch.n64
        assert ch.rows == (8 if nbytes <= TP.FILE8_BYTES else 4)
        ops = [c[0] for c in ch.code]
        if ch.hoisted:
            nload = ops.count(TP.OP_LOAD)
            assert ops[:nload] == [TP.OP_LOAD] * nload


# ---------------------------------------------------------------------------
# the TPC-H trees


def _captured_programs(monkeypatch, calls, q):
    """Each fused call of q run again with the program it ran recorded."""
    seen = []
    orig = kernels.fused_expr

    def rec(program, batch, qrow=None, ext=()):
        seen.append(program)
        return orig(program, batch, qrow, ext)

    monkeypatch.setattr(kernels, "fused_expr", rec)
    for _q, exprs, predicate, tb, frame in calls:
        if _q != q:
            continue
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
                assert (jvv is None) == (got[1] is None)
                if jvv is not None:
                    _same_jax(jvv, got[1], live, f"Q{q} validity")
                    live = live & np.asarray(jvv)
                _same_jax(jv, got[0], live, f"Q{q} {e}")
        finally:
            TEC.set_params(prev)
    return seen


@pytest.mark.parametrize("q", [1, 6, 14, 19, 7, 22])
def test_tpch_programs_layout_and_results(tpch_calls, monkeypatch, q):
    """Every program of the query is well formed, and its trees equal the
    torch route and JAX (the same check as test_torch_fused_expr's, here
    on the programs this lowering makes)."""
    progs = _captured_programs(monkeypatch, tpch_calls, q)
    assert progs
    for p in progs:
        _check_layout(p)


def test_q6_predicate_runs_eight_rows_with_its_loads_first(tpch_calls,
                                                          monkeypatch):
    """Q6's predicate: one chunk, its 6 literals and the product of a
    literal and 100 in the prologue, 16 row instructions, its four LOADs
    first, a file of at most FILE8_BYTES a row."""
    progs = _captured_programs(monkeypatch, tpch_calls, 6)
    preds = [p for p in progs if p.out_dtypes == [torch.bool]]
    assert preds
    ch = max(preds, key=lambda p: p.n_instructions).chunks[0]
    assert ch.rows == 8 and ch.hoisted
    assert [c[0] for c in ch.code[:4]] == [TP.OP_LOAD] * 4
    assert len(ch.code) == 16
    u = [NAMES[c[0]] for c in ch.ucode]
    assert u.count("OP_PARAM") + u.count("OP_CONST") >= 5
    assert "OP_MUL" in u  # the uniform product left the rows
    # every compare with a literal reads one row value and one slot
    cmps = [c for c in ch.code if c[0] in (TP.OP_GE, TP.OP_LT, TP.OP_LE)]
    assert cmps and all((c[3] & TP.UNI) != (c[4] & TP.UNI) for c in cmps)


def test_q1_chunks_run_eight_rows(tpch_calls, monkeypatch):
    progs = _captured_programs(monkeypatch, tpch_calls, 1)
    chunks = [ch for p in progs for ch in p.chunks]
    assert chunks and all(ch.rows == 8 and ch.hoisted for ch in chunks)


def test_q19_large_chunk_keeps_its_literals_in_the_prologue(tpch_calls,
                                                           monkeypatch):
    """Q19's 71-instruction chunk: its literals and what is computed from
    them in the prologue, its row values in a file of both classes."""
    progs = _captured_programs(monkeypatch, tpch_calls, 19)
    big = max((ch for p in progs for ch in p.chunks),
              key=lambda ch: len(ch.code) + len(ch.ucode))
    assert len(big.code) + len(big.ucode) >= 60
    assert len(big.ucode) >= 15
    assert big.n32 > 0 and big.n64 > 0


# ---------------------------------------------------------------------------
# the budget's two paths on the same trees


def _file8(monkeypatch, nbytes):
    """Another row-width threshold, and a program cache of the test's own
    (the programs it lowers hold their widths)."""
    monkeypatch.setattr(TP, "FILE8_BYTES", nbytes)
    monkeypatch.setattr(TEC, "_PROGRAMS", {})
    monkeypatch.setattr(TEC, "_program_bytes", 0)


@pytest.mark.parametrize("nbytes", [0, 96, 10**6],
                         ids=["four_rows", "threshold", "eight_rows"])
def test_both_row_widths_compute_the_same_bits(batches, monkeypatch,
                                               nbytes):
    """The same trees with every chunk on 4 rows a thread, on the real
    threshold and on 8: each chunk names its width, and the results equal
    the route and JAX."""
    jb, tb = batches
    _file8(monkeypatch, nbytes)
    trees = [
        ("value", lambda X: X.E.BinaryOp("+", X.E.BinaryOp(
            "*", X.col("i64"), X.E.BinaryOp("+", X.lit(3), X.lit(4))),
            X.col("d2"))),
        ("pred", lambda X: X.E.BoolOp("and", (
            X.E.Compare(">=", X.col("i32"), X.lit(-5)),
            X.E.Compare("<", X.col("f64"), X.col("f32")),
            X.E.Not(X.E.IsNull(X.col("d2")))))),
        ("value", lambda X: X.E.Case(((X.E.Compare(
            "<", X.col("k"), X.lit(0)), X.col("f64")),), X.col("d3"))),
        ("pred", lambda X: X.E.InList(X.col("k"), (1, -2, 3))),
    ]
    widths = set()
    for kind, make in trees:
        predicate = kind == "pred"
        prog = _lower(make(T), tb, predicate)
        _check_layout(prog)
        widths |= {ch.rows for ch in prog.chunks}
        _check(jb, tb, make(J), make(T), predicate=predicate)
    if nbytes == 0:
        assert widths == {4}
    if nbytes == 10**6:
        assert widths == {8}


def test_a_large_file_runs_four_rows(batches):
    """An AND of 30 compares keeps 30 bool values live in the file (past
    FILE8_BYTES a row): the chunk runs 4 rows a thread; the result equals
    route and JAX."""
    jb, tb = batches

    def wide_and(X):
        return X.E.BoolOp("and", tuple(
            X.E.Compare("<", X.col("i32"), X.lit(i * 1000))
            for i in range(30)))

    prog = _lower(wide_and(T), tb, True)
    assert [ch.rows for ch in prog.chunks][0] == 4
    assert 4 * prog.chunks[0].n32 > TP.FILE8_BYTES
    _check_layout(prog)
    _check(jb, tb, wide_and(J), wide_and(T), predicate=True)


def test_uniform_only_outputs_store_from_the_prologue(batches):
    """A projection whose value is a constant column (zeros_like of a
    column: uniform) stores a uniform slot on every row."""
    _jb, tb = batches
    b = TP._Recorder(tb.cols, tb.valid, {})
    tr = TP.TraceBatch(b, tb)
    col = tr.cols["i64"]
    z = torch.zeros_like(col)
    s = TP._Recorder.binary(b, "add", z, 5)
    m = TP._Recorder.binary(b, "mul", col, s)
    prog = TP.Program()
    prog.out_dtypes = [b.vtype[s.vid], b.vtype[m.vid]]
    prog.pairs = [(0, None), (1, None)]
    TP.schedule(b.ins, b.vtype, [s.vid, m.vid], prog)
    _check_layout(prog)
    (ch,) = prog.chunks
    stores = [c for c in ch.code if c[0] == TP.OP_STORE]
    assert any(c[3] & TP.UNI for c in stores)
    got = kernels.fused_expr_plain(prog, tb)
    assert torch.equal(got[0], torch.full_like(tb.cols["i64"], 5))
    assert torch.equal(got[1], tb.cols["i64"] * 5)


# ---------------------------------------------------------------------------
# random trees mixing uniform subtrees and row operands

_COLS = ["i32", "i64", "f32", "f64", "k", "d2", "d6"]
_LITS = [0, 1, -3, 7, 2.5, -0.25, 100]


def _uni(draw, depth):
    """A subtree of literals only: uniform."""
    if depth == 0 or draw(st.booleans()):
        return ("lit", draw(st.sampled_from(_LITS)))
    kind = draw(st.sampled_from(["arith", "cast", "func"]))
    if kind == "arith":
        return ("arith", draw(st.sampled_from("+-*")), _uni(draw, depth - 1),
                _uni(draw, depth - 1))
    if kind == "cast":
        return ("cast", draw(st.sampled_from(["int64", "float64", "dec2"])),
                _uni(draw, depth - 1))
    return ("func", draw(st.sampled_from(["abs", "neg"])),
            _uni(draw, depth - 1), None)


def _mixed(draw, depth):
    """A row subtree whose operands are columns, uniform subtrees or
    other mixed subtrees."""
    if depth == 0:
        return ("col", draw(st.sampled_from(_COLS)))
    kind = draw(st.sampled_from(["arith", "arith", "case", "func", "cast"]))
    row = _mixed(draw, depth - 1)
    if kind == "cast":
        return ("cast", draw(st.sampled_from(["int64", "float64", "dec2"])),
                row)
    left, right = row, (_uni(draw, 2) if draw(st.booleans())
                        else _mixed(draw, depth - 1))
    if draw(st.booleans()):
        left, right = right, left
    if kind == "arith":
        return ("arith", draw(st.sampled_from("+-*")), left, right)
    if kind == "case":
        cond = ("cmp", draw(st.sampled_from(["<", ">=", "=", "!="])),
                _mixed(draw, depth - 1), _uni(draw, 1))
        return ("case", cond, left, right)
    return ("func", draw(st.sampled_from(["least", "greatest"])), left,
            right)


def _mixed_pred(draw, depth):
    kind = draw(st.sampled_from(["cmp", "bool", "between"]))
    if kind == "cmp" or depth <= 0:
        a, b = _mixed(draw, max(depth - 1, 0)), _uni(draw, 2)
        if draw(st.booleans()):
            a, b = b, a
        return ("cmp", draw(st.sampled_from(["=", "!=", "<", "<=", ">",
                                             ">="])), a, b)
    if kind == "bool":
        return ("bool", draw(st.sampled_from(["and", "or"])),
                _mixed_pred(draw, depth - 1), _mixed_pred(draw, depth - 1))
    return ("between", _mixed(draw, depth - 1), draw(st.integers(-5, 0)),
            draw(st.integers(0, 5)))


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
        args = (_build(X, t[2]),) if t[3] is None else (
            _build(X, t[2]), _build(X, t[3]))
        return E.Func(t[1], args)
    if tag == "cmp":
        return E.Compare(t[1], _build(X, t[2]), _build(X, t[3]))
    if tag == "bool":
        return E.BoolOp(t[1], (_build(X, t[2]), _build(X, t[3])))
    return E.Between(_build(X, t[1]), lit(t[2]), lit(t[3]))


@st.composite
def _mixed_trees(draw):
    if draw(st.booleans()):
        return ("value", _mixed(draw, 3))
    return ("predicate", _mixed_pred(draw, 3))


_RANDOM_BATCHES = {}


@settings(derandomize=True, max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_mixed_trees())
def test_random_mixed_trees_match_route(spec):
    """Random trees of columns and literal-only subtrees: the lowered
    program (well formed, its uniform subtrees in the prologue) equals the
    torch route bit for bit, or raises what the route raises."""
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
    del want
    _check_layout(_lower(te, tb, predicate))
    _fused_vs_route(te, tb, predicate)
