"""Expression compiler: IR -> whole-batch torch elementwise code.

Counterpart of `oceanbase_tpu/expr/compile.py`, evaluated eagerly on the
batch's device instead of under a trace. The semantics are the JAX
package's, operation for operation:

- Decimals are scaled integers with compile-time scales: + - rescale to
  the max scale, * adds scales (promoting storage to int64), / leaves the
  decimal domain and produces float.
- String predicates on dictionary-encoded columns are evaluated once
  against the host dictionary (a code threshold or a boolean LUT that
  becomes a gather on device).
- NULL semantics: separate validity masks, Kleene AND/OR; filters treat
  NULL as reject.

Type promotion. JAX (x64 on) promotes a 0-d array like any other array:
int32[n] * int64 0-d -> int64. torch does not: a 0-d tensor never widens a
dimensioned one, so int32[n] * tensor(5, int64) stays int32 and can
overflow. Every bound literal is such a 0-d tensor, so each binary
operation here casts both sides to `torch.promote_types` of their dtypes
first (`_promote`), which is JAX's lattice for the signed, bool and float
types the engine stores.
"""

from __future__ import annotations

import functools
import math
import re
import threading

import numpy as np
import torch

from ..core.column import ColumnBatch, torch_dtype
from ..core.dtypes import (
    BOOL,
    DataType,
    Schema,
    TypeKind,
    common_numeric_type,
)
from . import program as _program
from .ir import (
    Between,
    BinaryOp,
    BoolOp,
    Case,
    Cast,
    ColRef,
    Compare,
    Expr,
    Func,
    InList,
    IsNull,
    Literal,
    Not,
)

MAX_DECIMAL_SCALE = 6


# ---------------------------------------------------------------------------
# query parameters (plan-cache parameterized literals)
# ---------------------------------------------------------------------------

# Bound 0-d device tensors for slotted Literals, active only while an
# executor runs a parameterized plan (the parameter frame): a tuple of
# 0-d tensors (the legacy form) or a PackedParams over the packed int64
# row. Per thread: the server runs concurrent statements on their
# connections' threads, and each plan runs eagerly under its own frame.
_FRAME = threading.local()


def set_params(params):
    """Install the active parameter frame of this thread; returns the
    previous one."""
    prev = getattr(_FRAME, "params", None)
    _FRAME.params = params
    return prev


class PackedParams:
    """The parameter frame over the packed int64 row (the packed
    parameter ABI, `engine/executor.py` pack_qparams): K24 reads each
    slot straight from `row`; the torch route reads slot i as a 0-d
    tensor made from the row on first use (a view for int64 and float64
    slots; VECTOR slots come back as (d,) float32)."""

    __slots__ = ("row", "spec", "_vals")

    def __init__(self, row: torch.Tensor, spec):
        self.row, self.spec = row, spec
        self._vals = [None] * len(spec)

    def __len__(self):
        return len(self.spec)

    def __getitem__(self, i):
        v = self._vals[i]
        if v is None:
            dt, off, w = self.spec[i]
            tdt = torch_dtype(dt.storage_np)
            if w != 1 or dt.is_float:
                v = self.row[off:off + w].view(torch.float64)
                v = v.to(tdt) if w != 1 else v.reshape(()).to(tdt)
            else:
                v = self.row[off].to(tdt)
            self._vals[i] = v
        return v

    def layout(self, slots):
        """{slot: (offset, dtype)} of the scalar slots among `slots`."""
        out = {}
        for s in slots:
            if s < len(self.spec):
                dt, off, w = self.spec[s]
                if w == 1:
                    out[s] = (off, torch_dtype(dt.storage_np))
        return out


def _active_params() -> tuple | None:
    return getattr(_FRAME, "params", None)


def literal_scalar(e, device):
    """Storage-domain value of a Literal as a 0-d tensor on `device`
    (slotted literals read the active parameter tuple)."""
    params = _active_params()
    if e.slot is not None and params is not None:
        return params[e.slot]
    return _scalar(bind_value(e.value, e.dtype), device)


# VECTOR literals resolve identically (the 'scalar' is a (d,) tensor)
evaluate_vector_literal = literal_scalar


def bind_value(value, dtype: DataType) -> np.generic:
    """Convert a python literal to its physical storage scalar (host side).

    A bound parameter lands in exactly the domain an inline literal
    would: decimals as scaled ints, dates as int32 days."""
    if dtype.kind is TypeKind.VECTOR:
        if isinstance(value, str):
            value = [float(x) for x in value.strip("[] ").split(",")]
        a = np.asarray(value, dtype=np.float32)
        if a.shape != (dtype.precision,):
            raise ValueError(
                f"vector literal dim {a.shape} != column dim "
                f"({dtype.precision},)"
            )
        return a
    if dtype.kind is TypeKind.DATE:
        if isinstance(value, str):
            value = _parse_date(value)
        return np.int32(value)
    if dtype.is_decimal:
        return dtype.storage_np.type(int(round(float(value) * dtype.decimal_factor)))
    return dtype.storage_np.type(value)


def _scalar(s, device) -> torch.Tensor:
    """A host storage scalar (or small array) as a tensor of its own dtype."""
    return torch.as_tensor(np.asarray(s), device=device)


# ---------------------------------------------------------------------------
# type inference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=65536)
def infer_type(e: Expr, schema: Schema) -> DataType:
    if isinstance(e, ColRef):
        return schema[e.name]
    if isinstance(e, Literal):
        return e.dtype
    if isinstance(e, BinaryOp):
        lt, rt = infer_type(e.left, schema), infer_type(e.right, schema)
        if e.op == "/":
            return DataType.float64(lt.nullable or rt.nullable)
        if lt.is_decimal or rt.is_decimal:
            # float operand forces float result
            if lt.is_float or rt.is_float:
                return DataType.float64(lt.nullable or rt.nullable)
            ls = lt.scale if lt.is_decimal else 0
            rs = rt.scale if rt.is_decimal else 0
            if e.op == "*":
                scale = min(ls + rs, MAX_DECIMAL_SCALE)
                return DataType.decimal(18, scale, lt.nullable or rt.nullable)
            scale = max(ls, rs)
            prec = 18 if (lt.storage_np.itemsize > 4 or rt.storage_np.itemsize > 4 or e.op in "+-") else 9
            return DataType.decimal(prec, scale, lt.nullable or rt.nullable)
        return common_numeric_type(lt, rt)
    if isinstance(e, (Compare, BoolOp, Not, IsNull, InList, Between)):
        return BOOL
    if isinstance(e, Cast):
        return e.dtype
    if isinstance(e, Case):
        branch_types = [infer_type(v, schema) for _, v in e.whens]
        if e.default is not None:
            branch_types.append(infer_type(e.default, schema))
        t = branch_types[0]
        for bt in branch_types[1:]:
            if bt != t:
                t = common_numeric_type(t, bt)
        return t
    if isinstance(e, Func):
        if e.name in ("vec_l2", "vec_ip", "vec_cosine"):
            return DataType.float32()
        if e.name in ("extract_year", "extract_month", "extract_day"):
            return DataType.int32()
        if e.name in ("like", "prefix", "contains", "fts_match",
                      "json_valid"):
            return BOOL
        if e.name in ("json_extract", "json_unquote", "json_type"):
            # path misses / invalid docs yield SQL NULL
            return DataType.varchar(nullable=True)
        if e.name == "json_array_length":
            return DataType.int64(nullable=True)
        if e.name in ("abs", "neg"):
            return infer_type(e.args[0], schema)
        if e.name in ("least", "greatest"):
            t = infer_type(e.args[0], schema)
            for a in e.args[1:]:
                t = common_numeric_type(t, infer_type(a, schema))
            return t
        if e.name == "substr" or e.name in CASE_FUNC_IMPL:
            return DataType.varchar(infer_type(e.args[0], schema).nullable)
        raise NotImplementedError(f"function {e.name}")
    raise NotImplementedError(type(e))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _parse_date(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def _like_to_regex(pattern: str) -> re.Pattern:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


# every function evaluable as a per-dictionary-value transform (the
# string-view family): ONE list shared by type inference, projection
# derivation, value-context errors, and the planner's group-key
# pre-projection
STRING_VIEW_FUNCS = (
    "substr", "json_extract", "json_unquote", "json_type",
    "lower", "upper", "trim",
)
# host implementations of the simple case/space transforms
CASE_FUNC_IMPL = {"lower": str.lower, "upper": str.upper, "trim": str.strip}


def _promote(a, b):
    """Cast two operands to their common dtype (see the module note).
    A traced value (expr/program.py) counts as a tensor."""
    if hasattr(a, "__torch_function__") and hasattr(b, "__torch_function__") \
            and a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        return a.to(t), b.to(t)
    return a, b


def _where(c, a, b):
    a, b = _promote(a, b)
    return torch.where(c, a, b)


def _merge_valid(*vs):
    vs = [v for v in vs if v is not None]
    if not vs:
        return None
    out = vs[0]
    for v in vs[1:]:
        out = out & v
    return out


def _lut_gather(lut, codes: torch.Tensor) -> torch.Tensor:
    """A lookup table (host array or device tensor) indexed on device by
    (clamped) dictionary codes."""
    n = max(len(lut) - 1, 0)
    t = lut if isinstance(lut, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(lut)).to(codes.device)
    return t[codes.clamp(0, n).long()]


# Boolean LUTs over dictionary values, per (dictionary, test, device),
# each built for the dictionary's length at the time. The JAX package builds them once when it traces a plan;
# the port's plans run eagerly, so without this a LIKE over a 2M-value
# dictionary (Q9's p_name at SF 10) would rerun its regex on every
# statement. A dictionary only grows (appends change its length): a table
# built for an older length is replaced, never kept beside the new one,
# and the entry keeps the dictionary itself to rule out a reused id.
_LUT_CACHE: dict = {}
_LUT_CACHE_MAX = 256


def _cached_lut(d, key, test, device) -> torch.Tensor:
    ck = (id(d), key, str(device))
    hit = _LUT_CACHE.get(ck)
    if hit is not None and hit[0] is d and hit[1] == len(d):
        return hit[2]
    lut = np.fromiter((test(v) for v in d.values()), dtype=np.bool_,
                      count=len(d))
    t = torch.from_numpy(lut).to(device)
    if hit is None and len(_LUT_CACHE) >= _LUT_CACHE_MAX:
        _LUT_CACHE.clear()
    _LUT_CACHE[ck] = (d, len(d), t)
    return t


def _rescale_decimal(vals, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return vals
    if to_scale > from_scale:
        return vals.to(torch.int64) * (10 ** (to_scale - from_scale))
    # scale down, SQL round-half-away-from-zero (sign-aware), with floor
    # division exactly as jnp's // on integers
    f = 10 ** (from_scale - to_scale)
    half = f // 2
    return torch.where(vals >= 0, (vals + half) // f, -((-vals + half) // f))


def _div_scale(v: torch.Tensor, factor) -> torch.Tensor:
    """v / factor as an IEEE division on every device. CUDA divides by a
    host scalar as a multiply by its reciprocal, which can land one ulp
    off the quotient; a divisor on v's own device is divided exactly, as
    on the CPU."""
    return v / torch.full((), factor, dtype=v.dtype, device=v.device)


def _literal_as(value, target: DataType, batch: ColumnBatch, col_name: str | None):
    """Materialize a python literal in the physical domain of `target`
    (bind_value is the single source of truth, so inline and bound
    literals land in bit-identical domains)."""
    if value is None:
        return None
    if target.kind is TypeKind.VARCHAR:
        raise AssertionError("string literals handled by dictionary paths")
    return _scalar(bind_value(value, target), batch.device)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _route(e: Expr, batch: ColumnBatch):
    """The torch route: evaluate an expression over a batch -> (values,
    valid|None), one torch op per node. Also the tracer of
    `expr/program.py`, which runs it over a trace batch."""
    if isinstance(e, Func) and e.name in _program.TORCH_ROUTE_FUNCS \
            and _program.is_trace(batch):
        t = infer_type(e, batch.schema)
        return _program.external_route(
            e, batch, torch_dtype(t.storage_np), _refs_of((e,))[0])
    if isinstance(e, ColRef):
        return batch.cols[e.name], batch.valid.get(e.name)

    if isinstance(e, Literal):
        t = e.dtype
        if e.value is None:
            cap = batch.capacity
            return (
                torch.zeros(cap, dtype=torch_dtype(t.storage_np),
                            device=batch.device),
                torch.zeros(cap, dtype=torch.bool, device=batch.device),
            )
        params = _active_params()
        if e.slot is not None and params is not None:
            # parameterized plan: the bound 0-d tensor is already in the
            # literal's physical storage domain (bind_value)
            return params[e.slot], None
        if t.kind is TypeKind.VARCHAR:
            raise NotImplementedError(
                "bare string literal outside a dictionary comparison"
            )
        return _literal_as(e.value, t, batch, None), None

    if isinstance(e, BinaryOp):
        return _eval_arith(e, batch)

    if isinstance(e, Compare):
        return _eval_compare(e, batch)

    if isinstance(e, BoolOp):
        vals_valid = [_route(a, batch) for a in e.args]
        if e.op == "and":
            out = vals_valid[0][0]
            for v, _ in vals_valid[1:]:
                out = out & v
            # Kleene: NULL unless result decidable
            if all(vv is None for _, vv in vals_valid):
                return out, None
            known_false = torch.zeros_like(out)
            all_valid = torch.ones_like(out)
            for v, vv in vals_valid:
                if vv is None:
                    known_false = known_false | ~v
                    continue
                known_false = known_false | (vv & ~v)
                all_valid = all_valid & vv
            return out, all_valid | known_false
        else:
            out = vals_valid[0][0]
            for v, _ in vals_valid[1:]:
                out = out | v
            if all(vv is None for _, vv in vals_valid):
                return out, None
            known_true = torch.zeros_like(out)
            all_valid = torch.ones_like(out)
            for v, vv in vals_valid:
                if vv is None:
                    known_true = known_true | v
                    continue
                known_true = known_true | (vv & v)
                all_valid = all_valid & vv
            return out, all_valid | known_true

    if isinstance(e, Not):
        v, valid = _route(e.arg, batch)
        return ~v, valid

    if isinstance(e, IsNull):
        # string-view exprs (json_*/substr) carry NULLness in their view,
        # not in a device validity channel: fold it here
        view = (
            _string_view(e.arg, batch)
            if isinstance(e.arg, Func) else None
        )
        if view is not None:
            codes, valid, vals = view
            valid = _fold_view_nulls(codes, valid, vals)
        else:
            _, valid = _route(e.arg, batch)
        if valid is None:
            out = torch.zeros(batch.capacity, dtype=torch.bool,
                              device=batch.device)
        else:
            out = ~valid
        if e.negated:
            out = ~out
        return out, None

    if isinstance(e, Cast):
        return _eval_cast(e, batch)

    if isinstance(e, Case):
        return _eval_case(e, batch)

    if isinstance(e, InList):
        return _eval_in_list(e, batch)

    if isinstance(e, Between):
        from .ir import and_

        lo = Compare(">=", e.arg, e.low)
        hi = Compare("<=", e.arg, e.high)
        v, valid = _route(and_(lo, hi), batch)
        return (~v if e.negated else v), valid

    if isinstance(e, Func):
        return _eval_func(e, batch)

    raise NotImplementedError(type(e))


def _numeric_align(e_left: Expr, e_right: Expr, batch: ColumnBatch):
    """Evaluate two numeric operands into a common physical domain.

    Returns (lv, rv, lvalid, rvalid, result_kind, scale) where result_kind
    is 'float' or 'decimal'/'int' with the given scale (0 for pure ints).
    """
    lt, rt = infer_type(e_left, batch.schema), infer_type(e_right, batch.schema)
    lv, lvalid = _route(e_left, batch)
    rv, rvalid = _route(e_right, batch)

    if lt.is_float or rt.is_float:
        tgt = torch.promote_types(
            lv.dtype if lt.is_float else torch.float32,
            rv.dtype if rt.is_float else torch.float32,
        )
        if lt.is_decimal:
            lv = _div_scale(lv.to(tgt), lt.decimal_factor)
        else:
            lv = lv.to(tgt)
        if rt.is_decimal:
            rv = _div_scale(rv.to(tgt), rt.decimal_factor)
        else:
            rv = rv.to(tgt)
        return lv, rv, lvalid, rvalid, "float", 0

    ls = lt.scale if lt.is_decimal else 0
    rs = rt.scale if rt.is_decimal else 0
    s = max(ls, rs)
    if s > 0:
        # integer literals evaluate at scale 0; rescale both sides to s
        lv = _rescale_decimal(lv, ls, s)
        rv = _rescale_decimal(rv, rs, s)
        return lv, rv, lvalid, rvalid, "decimal", s
    return lv, rv, lvalid, rvalid, "int", 0


def _eval_arith(e: BinaryOp, batch: ColumnBatch):
    out_t = infer_type(e, batch.schema)
    lt = infer_type(e.left, batch.schema)
    rt = infer_type(e.right, batch.schema)

    if e.op == "/" or out_t.is_float:
        lv, rv, lvalid, rvalid, _, _ = _numeric_align_float(e.left, e.right, batch)
        ops = {
            "+": torch.add,
            "-": torch.sub,
            "*": torch.mul,
            "/": torch.div,
            "%": torch.remainder,
        }
        return ops[e.op](lv, rv), _merge_valid(lvalid, rvalid)

    if e.op == "*" and (lt.is_decimal or rt.is_decimal):
        lv, lvalid = _route(e.left, batch)
        rv, rvalid = _route(e.right, batch)
        prod = lv.to(torch.int64) * rv.to(torch.int64)
        ls = lt.scale if lt.is_decimal else 0
        rs = rt.scale if rt.is_decimal else 0
        prod = _rescale_decimal(prod, ls + rs, out_t.scale)
        return prod.to(torch_dtype(out_t.storage_np)), _merge_valid(lvalid, rvalid)

    lv, rv, lvalid, rvalid, kind, s = _numeric_align(e.left, e.right, batch)
    tgt = torch_dtype(out_t.storage_np)
    lv = lv.to(tgt)
    rv = rv.to(tgt)
    if e.op == "+":
        out = lv + rv
    elif e.op == "-":
        out = lv - rv
    elif e.op == "*":
        out = lv * rv
    elif e.op == "%":
        # integer % is floor-mod (sign of the divisor), as jnp's
        safe = torch.where(rv == 0, torch.ones_like(rv), rv)
        out = torch.where(rv != 0, lv % safe, torch.zeros_like(lv % safe))
    else:
        raise NotImplementedError(e.op)
    return out, _merge_valid(lvalid, rvalid)


def _numeric_align_float(e_left: Expr, e_right: Expr, batch: ColumnBatch):
    lt, rt = infer_type(e_left, batch.schema), infer_type(e_right, batch.schema)
    lv, lvalid = _route(e_left, batch)
    rv, rvalid = _route(e_right, batch)
    tgt = torch.float64 if (lt.kind is TypeKind.FLOAT64 or rt.kind is TypeKind.FLOAT64
                            or not (lt.is_float or rt.is_float)) else torch.float32
    if lt.is_decimal:
        lv = _div_scale(lv.to(tgt), lt.decimal_factor)
    else:
        lv = lv.to(tgt)
    if rt.is_decimal:
        rv = _div_scale(rv.to(tgt), rt.decimal_factor)
    else:
        rv = rv.to(tgt)
    return lv, rv, lvalid, rvalid, "float", 0


def _cmp(op: str, a, b):
    a, b = _promote(a, b)
    if op in ("=", "=="):
        return a == b
    if op in ("!=", "<>"):
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise NotImplementedError(op)


# host-side comparisons for LUT builders over dictionary values
_CMP = {
    "=": lambda a, b: a == b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _eval_compare(e: Compare, batch: ColumnBatch):
    lt = infer_type(e.left, batch.schema)
    rt = infer_type(e.right, batch.schema)

    # date vs 'YYYY-MM-DD' string literal: parse on host, compare as int days
    if lt.kind is TypeKind.DATE and isinstance(e.right, Literal) and isinstance(e.right.value, str):
        lv, lvalid = _route(e.left, batch)
        rv = _literal_as(e.right.value, lt, batch, None)
        return _cmp(e.op, lv, rv), lvalid
    if rt.kind is TypeKind.DATE and isinstance(e.left, Literal) and isinstance(e.left.value, str):
        rv, rvalid = _route(e.right, batch)
        lv = _literal_as(e.left.value, rt, batch, None)
        return _cmp(e.op, lv, rv), rvalid

    # --- dictionary string comparisons -------------------------------
    if lt.kind is TypeKind.VARCHAR or rt.kind is TypeKind.VARCHAR:
        if isinstance(e.right, Literal) and isinstance(e.left, ColRef):
            return _dict_compare(e.left, e.op, e.right.value, batch)
        if isinstance(e.left, Literal) and isinstance(e.right, ColRef):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            op = flip.get(e.op, e.op)
            return _dict_compare(e.right, op, e.left.value, batch)
        # string transforms (substr) vs literal: boolean LUT over the view
        if isinstance(e.right, Literal):
            view = _string_view(e.left, batch)
            if view is not None:
                codes, valid, vals = view
                valid = _fold_view_nulls(codes, valid, vals)
                lut = np.fromiter(
                    (
                        False if v is None else _CMP[e.op](v, e.right.value)
                        for v in vals
                    ),
                    dtype=np.bool_, count=len(vals),
                )
                return _lut_gather(lut, codes), valid
        if lt.kind is TypeKind.VARCHAR and rt.kind is TypeKind.VARCHAR:
            # col-vs-col code comparison is only sound when both columns
            # share one dictionary object; distinct dictionaries assign
            # incomparable codes.
            if (
                isinstance(e.left, ColRef)
                and isinstance(e.right, ColRef)
                and batch.dicts.get(e.left.name) is not batch.dicts.get(e.right.name)
            ):
                raise NotImplementedError(
                    f"varchar comparison {e.left.name} vs {e.right.name}: "
                    "columns use different dictionaries; requires dictionary "
                    "translation (not yet implemented)"
                )
            lv, lvalid = _route(e.left, batch)
            rv, rvalid = _route(e.right, batch)
            return _cmp(e.op, lv, rv), _merge_valid(lvalid, rvalid)
        raise NotImplementedError("varchar comparison form")

    lv, rv, lvalid, rvalid, _, _ = _numeric_align(e.left, e.right, batch)
    return _cmp(e.op, lv, rv), _merge_valid(lvalid, rvalid)


def _dict_compare(col_expr: ColRef, op: str, value: str, batch: ColumnBatch):
    d = batch.dicts.get(col_expr.name)
    if d is None:
        raise KeyError(f"no dictionary for varchar column {col_expr.name}")
    codes, valid = _route(col_expr, batch)
    if d.sorted and op in ("<", "<=", ">", ">="):
        import bisect

        vals = d.values()
        if op in ("<", ">="):
            thr = bisect.bisect_left(vals, value)
            out = codes < thr if op == "<" else codes >= thr
        else:
            thr = bisect.bisect_right(vals, value)
            out = codes < thr if op == "<=" else codes >= thr
        return out, valid
    if op in ("=", "=="):
        code = d.encode_one(value, add=False)
        return codes == code, valid
    if op in ("!=", "<>"):
        code = d.encode_one(value, add=False)
        return codes != code, valid
    # general fallback: boolean LUT over dictionary values
    lut = _cached_lut(d, ("cmp", op, value), lambda v: _CMP[op](v, value),
                      codes.device)
    return _lut_gather(lut, codes), valid


def _eval_cast(e: Cast, batch: ColumnBatch):
    src_t = infer_type(e.arg, batch.schema)
    dst = e.dtype
    dst_t = torch_dtype(dst.storage_np) if dst.kind is not TypeKind.VARCHAR \
        else torch.int32
    if src_t.kind is TypeKind.VARCHAR and dst.kind is not TypeKind.VARCHAR:
        # string -> number through the dictionary: parse each DISTINCT
        # value once into a numeric LUT (unparseable -> SQL NULL)
        view = _string_view(e.arg, batch)
        if view is None:
            raise NotImplementedError(
                f"CAST from varchar requires a dictionary view: {e.arg}")
        codes, valid, vals = view

        def parse(v):
            if v is None:
                return None
            try:
                return float(v)
            except ValueError:
                return None

        nums = [parse(v) for v in vals]
        nn = np.fromiter(
            (x is not None for x in nums), dtype=np.bool_,
            count=len(nums),
        )
        fl = np.fromiter(
            (0.0 if x is None else x for x in nums), dtype=np.float64,
            count=len(nums),
        )
        fv = _lut_gather(fl, codes)
        valid = _merge_valid(valid, _lut_gather(nn, codes))
        if dst.is_decimal:
            out = _float_to_int(torch.round(fv * dst.decimal_factor), dst_t)
        elif dst.is_integer:
            out = _float_to_int(torch.round(fv), dst_t)
        else:
            out = fv.to(dst_t)
        return out, valid
    v, valid = _route(e.arg, batch)
    if src_t.is_decimal and dst.is_decimal:
        return _rescale_decimal(v, src_t.scale, dst.scale).to(dst_t), valid
    if src_t.is_decimal and dst.is_float:
        return _div_scale(v.to(dst_t), src_t.decimal_factor), valid
    if src_t.is_decimal and dst.is_integer:
        return _rescale_decimal(v, src_t.scale, 0).to(dst_t), valid
    if dst.is_decimal:
        if src_t.is_float:
            return _float_to_int(torch.round(v * dst.decimal_factor),
                                 dst_t), valid
        return (v.to(dst_t) * dst.decimal_factor), valid
    if src_t.is_float and dst.is_integer:
        return _float_to_int(v, dst_t), valid
    return v.to(dst_t), valid


def _float_to_int(v, dt: torch.dtype):
    """A float tensor as integer dtype `dt`, converted as XLA converts
    (the JAX package's astype): NaN to 0, values past the type's range
    saturated to its bounds, the rest truncated toward zero. torch's own
    `.to` leaves NaN and out-of-range values undefined."""
    info = torch.iinfo(dt)
    lim = float(2 ** (info.bits - 1))
    big, small = v >= lim, v < -lim
    safe = torch.where((v != v) | big | small, torch.zeros_like(v), v)
    out = torch.where(big, info.max, safe.to(dt))
    return torch.where(small, info.min, out)


def _eval_case(e: Case, batch: ColumnBatch):
    out_t = infer_type(e, batch.schema)
    dt = torch_dtype(out_t.storage_np)
    dev = batch.device
    if e.default is not None:
        out, out_valid = _route(Cast(e.default, out_t), batch)
    else:
        out = torch.zeros(batch.capacity, dtype=dt, device=dev)
        out_valid = torch.zeros(batch.capacity, dtype=torch.bool, device=dev)
    for cond, val in reversed(e.whens):
        c, cvalid = _route(cond, batch)
        take = c if cvalid is None else (c & cvalid)
        v, vvalid = _route(Cast(val, out_t), batch)
        out = _where(take, v, out)
        if out_valid is not None or vvalid is not None:
            ones = torch.ones(batch.capacity, dtype=torch.bool, device=dev)
            ov = out_valid if out_valid is not None else ones
            vv = vvalid if vvalid is not None else ones
            out_valid = torch.where(take, vv, ov)
    return out, out_valid


def _eval_in_list(e: InList, batch: ColumnBatch):
    t = infer_type(e.arg, batch.schema)
    if t.kind is TypeKind.VARCHAR:
        view = _string_view(e.arg, batch)
        if view is None:
            raise NotImplementedError(f"IN over varchar expr {e.arg}")
        codes, valid, vals = view
        valid = _fold_view_nulls(codes, valid, vals)
        members = set(e.values)
        lut = np.fromiter(
            (v is not None and v in members for v in vals),
            dtype=np.bool_, count=len(vals),
        )
        out = _lut_gather(lut, codes)
        return (~out if e.negated else out), valid
    v, valid = _route(e.arg, batch)
    out = torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
    for item in e.values:
        out = out | _cmp("=", v, _literal_as(item, t, batch, None))
    return (~out if e.negated else out), valid


# --- date decomposition (Howard Hinnant's civil-from-days, branch-free) ----


def _civil_from_days(days):
    z = days.to(torch.int32) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(
        doe - doe // 1460 + doe // 36524 - doe // 146096, 365,
        rounding_mode="floor",
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = mp + torch.where(mp < 10, 3, -9).to(mp.dtype)
    y = y + (m <= 2).to(y.dtype)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _string_view(e: Expr, batch: ColumnBatch):
    """A 'string view' of an expression: (codes, valid, per-code values).

    Works for a dictionary-encoded column or a host-computable string
    transform of one. The per-code value list lets predicates become
    boolean LUTs indexed by code (strings never reach the device).
    """
    if isinstance(e, ColRef):
        d = batch.dicts.get(e.name)
        if d is None:
            return None
        codes, valid = _route(e, batch)
        return codes, valid, list(d.values())
    if isinstance(e, Func) and e.name == "substr":
        base = _string_view(e.args[0], batch)
        if base is None:
            return None
        codes, valid, vals = base
        if not (isinstance(e.args[1], Literal) and isinstance(e.args[2], Literal)):
            return None
        s0 = int(e.args[1].value) - 1  # SQL is 1-based
        length = int(e.args[2].value)
        if length >= 0:
            vals2 = [None if v is None else v[s0 : s0 + length] for v in vals]
        else:
            vals2 = [None if v is None else v[s0:] for v in vals]
        return codes, valid, vals2
    if isinstance(e, Func) and e.name in CASE_FUNC_IMPL:
        # case mapping / trimming once per DISTINCT value
        base = _string_view(e.args[0], batch)
        if base is None:
            return None
        codes, valid, vals = base
        f = CASE_FUNC_IMPL[e.name]
        return codes, valid, [None if v is None else f(v) for v in vals]
    if isinstance(e, Func) and e.name in (
        "json_extract", "json_unquote", "json_type"
    ):
        # JSON transforms compose through the view like substr: evaluated
        # once per DISTINCT document; a None in vals is SQL NULL
        from .jsonpath import (
            extract_repr,
            json_type_of,
            parse_path,
            unquote,
        )

        base = _string_view(e.args[0], batch)
        if base is None:
            return None
        codes, valid, vals = base
        if e.name == "json_extract":
            if not isinstance(e.args[1], Literal):
                return None
            steps = parse_path(str(e.args[1].value))
            vals2 = [
                None if v is None else extract_repr(v, steps) for v in vals
            ]
        elif e.name == "json_unquote":
            vals2 = [unquote(v) for v in vals]
        else:
            vals2 = [json_type_of(v) for v in vals]
        return codes, valid, vals2
    return None


def _fold_view_nulls(codes, valid, vals):
    """NULL results in a string view (None entries) become row-level
    invalidity; remaining values are safe to feed LUT builders."""
    if any(v is None for v in vals):
        nn = np.fromiter(
            (v is not None for v in vals), dtype=np.bool_, count=len(vals)
        )
        valid = _merge_valid(valid, _lut_gather(nn, codes))
    return valid


def derive_dict_column(e: Expr, batch: ColumnBatch):
    """Materialize a string-transform expr as a NEW dict column:
    (codes, valid, Dictionary)."""
    from ..core.dictionary import Dictionary

    if not (isinstance(e, Func) and e.name in STRING_VIEW_FUNCS):
        return None
    view = _string_view(e, batch)
    if view is None:
        return None
    codes, valid, vals = view
    valid = _fold_view_nulls(codes, valid, vals)
    safe = ["" if v is None else v for v in vals]  # NULL rows are invalid
    d2, mapping = Dictionary.from_strings_bulk(np.asarray(safe, dtype=str))
    return _lut_gather(mapping.astype(np.int32), codes), valid, d2


def _dict_lut(e: Func, batch: ColumnBatch, test):
    """Boolean LUT over a dictionary column's values, gathered by code;
    `test` is the function's fixed test of its literal argument."""
    col_expr = e.args[0]
    assert isinstance(col_expr, ColRef) and isinstance(e.args[1], Literal)
    d = batch.dicts[col_expr.name]
    codes, valid = _route(col_expr, batch)
    lut = _cached_lut(d, (e.name, str(e.args[1].value)), test, codes.device)
    return _lut_gather(lut, codes), valid


def _eval_func(e: Func, batch: ColumnBatch):
    if e.name in ("extract_year", "extract_month", "extract_day"):
        v, valid = _route(e.args[0], batch)
        y, m, d = _civil_from_days(v)
        return {"extract_year": y, "extract_month": m, "extract_day": d}[e.name], valid

    if e.name == "like":
        rx = _like_to_regex(str(e.args[1].value))
        return _dict_lut(e, batch, lambda v: rx.match(v) is not None)

    if e.name == "fts_match":
        # word-level full-text match against a dict-encoded column: every
        # distinct value tokenizes ONCE into a boolean LUT
        want = [t for t in str(e.args[1].value).lower().split() if t]
        return _dict_lut(
            e, batch, lambda v: all(t in v.lower().split() for t in want))

    if e.name == "json_valid":
        view = _string_view(e.args[0], batch)
        if view is None:
            raise NotImplementedError("json_valid needs a dictionary view")
        from .jsonpath import is_valid

        codes, valid, vals = view
        lut = np.fromiter(
            (v is not None and is_valid(v) for v in vals),
            dtype=np.bool_, count=len(vals),
        )
        return _lut_gather(lut, codes), valid

    if e.name == "json_array_length":
        from .jsonpath import array_length, parse_path

        view = _string_view(e.args[0], batch)
        if view is None:
            raise NotImplementedError(
                "json_array_length needs a dictionary view")
        codes, valid, vals = view
        steps = (
            parse_path(str(e.args[1].value)) if len(e.args) > 1 else ()
        )
        lens = [None if v is None else array_length(v, steps) for v in vals]
        valid = _fold_view_nulls(codes, valid, lens)
        lut = np.fromiter(
            (0 if x is None else x for x in lens), dtype=np.int64,
            count=len(lens),
        )
        return _lut_gather(lut, codes), valid

    if e.name in STRING_VIEW_FUNCS and e.name != "substr":
        # value context without a dictionary sink (e.g. a join key)
        raise NotImplementedError(
            f"{e.name} used where a dictionary column cannot form")

    if e.name in ("prefix", "contains"):
        p = str(e.args[1].value)
        test = (lambda v: v.startswith(p)) if e.name == "prefix" else (lambda v: p in v)
        return _dict_lut(e, batch, test)

    if e.name in ("vec_l2", "vec_ip", "vec_cosine"):
        # vector distances in matmul form: squared L2 = ||x||^2 - 2 x.q +
        # ||q||^2; vec_ip = NEGATIVE inner product and vec_cosine = 1 -
        # cosine similarity, so ORDER BY <dist> ASC means "nearest"
        xv, valid = _route(e.args[0], batch)
        q = evaluate_vector_literal(e.args[1], batch.device)
        xq = xv @ q
        if e.name == "vec_ip":
            return -xq, valid
        if e.name == "vec_cosine":
            xn = torch.sqrt(torch.sum(xv * xv, dim=1))
            qn = torch.sqrt(torch.sum(q * q))
            return 1.0 - xq / torch.clamp(xn * qn, min=1e-30), valid
        xn = torch.sum(xv * xv, dim=1)
        return xn - 2.0 * xq + torch.sum(q * q), valid
    if e.name == "abs":
        v, valid = _route(e.args[0], batch)
        return torch.abs(v), valid
    if e.name == "neg":
        v, valid = _route(e.args[0], batch)
        return -v, valid
    if e.name in ("least", "greatest"):
        op = torch.minimum if e.name == "least" else torch.maximum
        v, valid = _route(e.args[0], batch)
        for a in e.args[1:]:
            v2, valid2 = _route(a, batch)
            v = op(*_promote(v, v2))
            valid = _merge_valid(valid, valid2)
        return v, valid
    raise NotImplementedError(f"function {e.name}")


def _predicate_route(e: Expr, batch: ColumnBatch) -> torch.Tensor:
    """The torch route of compile_predicate."""
    v, valid = _route(e, batch)
    mask = v if valid is None else (v & valid)
    return mask & batch.sel


# ---------------------------------------------------------------------------
# the fused route: trees lowered to K24 programs (expr/program.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=65536)
def _refs_of(exprs: tuple) -> tuple:
    """(column names, parameter slots, whether a float literal is zero)
    of the trees. Trees compare as dataclasses, and 0.0 == -0.0: a tree
    holding a float zero literal needs its signs in a cache key
    (`_zero_signs`)."""
    import dataclasses as _dc

    names: dict = {}
    slots: set = set()
    fzero = False

    def walk(e):
        nonlocal fzero
        if isinstance(e, ColRef):
            names[e.name] = None
            return
        if isinstance(e, Literal):
            if e.slot is not None:
                slots.add(e.slot)
            if isinstance(e.value, float) and e.value == 0.0:
                fzero = True
            return
        if not _dc.is_dataclass(e):
            return
        for f in _dc.fields(e):
            sub(getattr(e, f.name))

    def sub(v):
        if isinstance(v, Expr):
            walk(v)
        elif isinstance(v, tuple):
            for x in v:
                sub(x)

    for e in exprs:
        walk(e)
    return tuple(names), tuple(sorted(slots)), fzero


def _zero_signs(exprs: tuple) -> tuple:
    """The sign bit of each float zero literal of the trees, in walk
    order (not cached: equal trees may differ here)."""
    import dataclasses as _dc

    out = []

    def walk(v):
        if isinstance(v, Literal):
            if isinstance(v.value, float) and v.value == 0.0:
                out.append(math.copysign(1.0, v.value) < 0)
        elif isinstance(v, tuple):
            for x in v:
                walk(x)
        elif isinstance(v, Expr) and _dc.is_dataclass(v):
            for f in _dc.fields(v):
                walk(getattr(v, f.name))

    walk(exprs)
    return tuple(out)


def _legacy_layout(params, slots):
    """The packed row of a legacy tuple frame (made once per frame on
    its device: integers widened to int64, floats as float64 bits) and
    {slot: (offset, dtype)} of its 0-d slots among `slots`. Only a plan
    whose slots cannot be packed (`_collect_qparam_spec` None: a VECTOR
    slot of unknown width, non-dense slots) or a direct caller's tuple
    comes here; every Session statement binds one packed row."""
    hit = getattr(_FRAME, "legacy", None)
    if hit is not None and hit[0] is params:
        row, offs = hit[1], hit[2]
    else:
        parts, offs, off = [], [], 0
        for p in params:
            t = torch.as_tensor(p)
            raw = (t.to(torch.float64).reshape(-1).view(torch.int64)
                   if t.dtype.is_floating_point
                   else t.to(torch.int64).reshape(-1))
            offs.append((off, t.dtype, t.dim()))
            parts.append(raw)
            off += int(raw.shape[0])
        row = torch.cat(parts) if parts else None
        _FRAME.legacy = (params, row, offs)
    return row, {s: offs[s][:2] for s in slots
                 if s < len(offs) and offs[s][2] == 0}


# Lowered programs, one entry per (trees, mode, schema, input columns,
# parameter layout): the entry also holds the dictionaries and the
# version (length, order flag) each was lowered for, and a dictionary
# grown or replaced by DML replaces its stale program instead of adding
# one. Bounded by entries and by the host bytes of the programs' lookup
# tables (oldest first out); their device copies are shared and bounded
# in `expr/program.py` (`device_lut`).
_PROGRAMS: dict = {}
_PROGRAMS_MAX = 4096
_PROGRAM_BYTES_MAX = 256 << 20
_PROGRAMS_LOCK = threading.Lock()
_program_bytes = 0


def _cache_program(key, entry) -> None:
    global _program_bytes
    with _PROGRAMS_LOCK:
        old = _PROGRAMS.pop(key, None)
        if old is not None:
            _program_bytes -= old[0].nbytes
        _PROGRAMS[key] = entry
        _program_bytes += entry[0].nbytes
        while len(_PROGRAMS) > 1 and (len(_PROGRAMS) > _PROGRAMS_MAX or
                                      _program_bytes > _PROGRAM_BYTES_MAX):
            _program_bytes -= _PROGRAMS.pop(next(iter(_PROGRAMS)))[0].nbytes


def _fused(exprs: tuple, batch: ColumnBatch, predicate: bool):
    """Run the trees as one K24 program: the list of (values, valid|None)
    per tree (predicate mode: [mask]). A tree the tracer cannot record
    raises `NotLowerable` on every device: no tree falls back to the
    torch route whole (only the vector distances enter a program as
    columns the route computed, counted in EXPR_COUNTS)."""
    refs, slots, fzero = _refs_of(exprs)
    params = _active_params()
    qrow, qslots = None, {}
    if params is not None and slots:
        if isinstance(params, PackedParams):
            qrow, qslots = params.row, params.layout(slots)
        else:
            qrow, qslots = _legacy_layout(params, slots)
    cols, valid, dicts = batch.cols, batch.valid, batch.dicts
    sig, dref, vers = [], [], []
    for n in refs:
        c = cols.get(n)
        d = dicts.get(n)
        dref.append(d)
        vers.append(None if d is None else (len(d), d.sorted))
        sig.append(None if c is None else (
            c.dtype, c.dim(), n in valid, d is not None))
    key = (exprs, _zero_signs(exprs) if fzero else (), predicate,
           batch.schema, tuple(sig), tuple(sorted(qslots.items())),
           batch.device.type, params is not None)
    hit = _PROGRAMS.get(key)
    if hit is None or hit[2] != vers or \
            not all(a is b for a, b in zip(hit[1], dref)):
        prog = _program.lower(
            exprs, batch, _route, _predicate_route, set_params, qslots,
            params is not None, predicate)
        hit = (prog, tuple(dref), vers)
        _cache_program(key, hit)
    prog = hit[0]
    ext = []
    for e in prog.externals:
        _program.EXPR_COUNTS["expr torch route"] += 1
        ext.append(_route(e, batch))
    from ..kernels import fused_expr

    outs = fused_expr(prog, batch, qrow, ext)
    _program.EXPR_COUNTS["expr k24 trees"] += len(exprs)
    return [(outs[a] if a is not None else None,
             outs[b] if b is not None else None) for a, b in prog.pairs]


def _lowers(e: Expr) -> bool:
    """A tree runs as a program unless it is a bare column (no copy) or
    reads no column (it stays 0-d, as the route returns it)."""
    return not isinstance(e, ColRef) and bool(_refs_of((e,))[0])


def evaluate(e: Expr, batch: ColumnBatch):
    """Evaluate an expression over a batch -> (values, valid|None): one
    K24 launch (`kernels.fused_expr`) for a tree with a column
    reference, the torch route for a bare column or a constant tree."""
    if _program.is_trace(batch) or not _lowers(e):
        return _route(e, batch)
    return _fused((e,), batch, False)[0]


def evaluate_many(exprs, batch: ColumnBatch) -> list:
    """evaluate() of several trees over one batch, the lowered ones as
    ONE multi-output program (a projection's or an aggregate's argument
    list is one launch, shared subexpressions computed once)."""
    exprs = tuple(exprs)
    out = [None] * len(exprs)
    idx = [i for i, e in enumerate(exprs) if _lowers(e)]
    if idx and not _program.is_trace(batch):
        res = _fused(tuple(exprs[i] for i in idx), batch, False)
        for i, r in zip(idx, res):
            out[i] = r
    for i, e in enumerate(exprs):
        if out[i] is None:
            out[i] = _route(e, batch)
    return out


def compile_predicate(e: Expr, batch: ColumnBatch) -> torch.Tensor:
    """Predicate -> bool mask over the batch; NULL results reject the
    row. A predicate with a column reference is one K24 launch that
    writes v & valid & sel."""
    if _program.is_trace(batch) or not _refs_of((e,))[0]:
        return _predicate_route(e, batch)
    return _fused((e,), batch, True)[0][0]
