"""K24's register programs: expression trees lowered for the fused
expression kernel (`csrc/k24_fused_expr.cu`).

Counterpart of what XLA does to `oceanbase_tpu/expr/compile.py:260
evaluate` and `:912 compile_predicate` when it fuses a statement's
predicate and projection arithmetic into one loop. The port's torch route
(`expr/compile.py`) runs one torch op per node, a pass over the column
each; a lowered tree runs as one kernel launch that reads every input
column once and writes each output once.

How a tree is lowered. The torch route itself is run once over a trace
batch whose columns, validity planes, sel and parameters are symbolic
values (`_Val`). Every torch call the route makes on them is caught by
`_Val.__torch_function__` and recorded as typed instructions: the
operands are cast to the dtype torch would compute in
(`torch.result_type` over stand-in tensors of the same dtype and rank,
so a 0-d parameter promotes exactly as it does in the route), then one
operation of that dtype. The route's host-side work (dictionary
thresholds, LIKE and IN lookup tables, date literals) runs as it does in
the route, once per program; its small tensors become constants and LUT
inputs. So the program computes, row for row, what the route computes,
and its output dtypes and the None-ness of each validity plane are the
route's by construction.

A program is a list of instructions (opcode, dtype, dst, a, b, c, src
dtype, imm) over at most MAX_REGS 64-bit registers, an input table
(columns and validity planes at their storage width, sel, LUTs, spilled
intermediates, columns the torch route made), slotted literals read by
offset from the packed int64 parameter row, and one or more outputs.
Validity planes are bool registers like any other value: Kleene AND/OR
need the route's exact plane arithmetic, not one bit per register. A
tree larger than one launch's limits is split into chained programs
(chunks): a value live across the cut is stored to a temporary column by
one chunk and loaded by the next.

String views, JSON functions, fts_match, LIKE and string IN lists are
inside the op set: the route turns each into a host-built table read by
dictionary code, which the program reads as a LUT input. Outside it are
the vector distances (a matmul over a [cap, d] column): such a subtree
runs on the torch route and enters the program as an input column,
counted in `EXPR_COUNTS["expr torch route"]`. A tree the tracer cannot
record for any other reason raises NotLowerable, on the card as on the
CPU: no tree runs whole on the torch route.

Each program keeps its lookup tables on the host; their device copies are
shared by every program holding the same host table and bounded by bytes
(`device_lut`).
"""

from __future__ import annotations

import operator
import struct
import threading
from collections import OrderedDict

import torch

from ..kernels import DTYPE_CODE

# launch limits of one chunk (csrc/k24_fused_expr.cu must match):
# instructions (the prologue's and the row code's), row values live at
# once (a shared file's slots), inputs, outputs, uniform slots
MAX_INS = 160
MAX_REGS = 32
MAX_IN = 32
MAX_OUT = 32
MAX_UNI = 64

# opcodes (csrc/k24_fused_expr.cu must match)
(OP_LOAD, OP_PARAM, OP_CONST, OP_LUT, OP_CAST, OP_ADD, OP_SUB, OP_MUL,
 OP_DIV, OP_FLOORDIV, OP_MOD, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE,
 OP_AND, OP_OR, OP_NOT, OP_NEG, OP_ABS, OP_MIN, OP_MAX, OP_ROUND,
 OP_SELECT, OP_STORE) = range(27)

CODE_DTYPE = {v: k for k, v in DTYPE_CODE.items()}
# the torch op of each arithmetic, compare and logic opcode: what K24's
# plain version runs (kernels.fused_expr_plain), with operands already of
# the instruction's dtype
PLAIN_BINARY = {
    OP_ADD: torch.add, OP_SUB: torch.sub, OP_MUL: torch.mul,
    OP_DIV: torch.div,
    OP_FLOORDIV: lambda x, y: torch.div(x, y, rounding_mode="floor"),
    OP_MOD: torch.remainder, OP_EQ: torch.eq, OP_NE: torch.ne,
    OP_LT: torch.lt, OP_LE: torch.le, OP_GT: torch.gt, OP_GE: torch.ge,
    OP_AND: torch.bitwise_and, OP_OR: torch.bitwise_or,
    OP_MIN: torch.minimum, OP_MAX: torch.maximum,
}
PLAIN_UNARY = {OP_NOT: torch.bitwise_not, OP_NEG: torch.neg,
               OP_ABS: torch.abs, OP_ROUND: torch.round}

# Trees run through K24 (one per evaluate/compile_predicate of a lowered
# tree, one per evaluate_many) and trees or subtrees run on the torch
# route instead; chip_smoke.py reads both per statement.
EXPR_COUNTS = {"expr k24 trees": 0, "expr torch route": 0}


# subtrees evaluated by the torch route and fed to a program as a column
TORCH_ROUTE_FUNCS = frozenset({"vec_l2", "vec_ip", "vec_cosine"})


class NotLowerable(NotImplementedError):
    """The tracer met a torch call it does not record: the statement's
    error, as the route's own NotImplementedError is."""


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

# the torch calls the route makes with a traced operand: the torch
# functions it calls, and a real tensor's operator with a traced right
# side (torch reports `a - b` as Tensor.sub, `a & b` as Tensor.__and__)
_T = torch.Tensor
_BINARY = {
    torch.add: "add", _T.add: "add", torch.sub: "sub", _T.sub: "sub",
    torch.mul: "mul", _T.mul: "mul", _T.__floordiv__: "floordiv",
    torch.remainder: "mod", _T.remainder: "mod", _T.eq: "eq",
    _T.ne: "ne", _T.lt: "lt", _T.le: "le", _T.gt: "gt", _T.ge: "ge",
    _T.__and__: "and", _T.__or__: "or", torch.minimum: "min",
    torch.maximum: "max",
}
_UNARY = {torch.abs: "abs", torch.round: "round"}
_OPCODE = {
    "add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
    "floordiv": OP_FLOORDIV, "mod": OP_MOD, "eq": OP_EQ, "ne": OP_NE,
    "lt": OP_LT, "le": OP_LE, "gt": OP_GT, "ge": OP_GE, "and": OP_AND,
    "or": OP_OR, "min": OP_MIN, "max": OP_MAX, "neg": OP_NEG,
    "abs": OP_ABS, "not": OP_NOT, "round": OP_ROUND,
}
# the same operations on stand-in tensors: result dtype and rank
_SHADOW_OP = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": operator.truediv,
    "floordiv": lambda a, b: torch.div(a, b, rounding_mode="floor"),
    "mod": operator.mod, "eq": operator.eq, "ne": operator.ne,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge, "and": operator.and_, "or": operator.or_,
    "min": torch.minimum, "max": torch.maximum,
}


def _bits(t: torch.Tensor) -> int:
    """A 0-d tensor's register form: integers sign-extended, bool 0/1,
    float32 bits zero-extended, float64 bits."""
    if t.dtype == torch.float32:
        return int(t.reshape(1).view(torch.int32).item()) & 0xFFFFFFFF
    if t.dtype == torch.float64:
        return int(t.reshape(1).view(torch.int64).item())
    return int(t.item())


def const_tensor(bits: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-d tensor of a register-form constant."""
    if dtype == torch.float32:
        raw = torch.tensor([struct.unpack("<i", struct.pack(
            "<I", bits & 0xFFFFFFFF))[0]], dtype=torch.int32)
        return raw.view(torch.float32).reshape(()).to(device)
    if dtype == torch.float64:
        return torch.tensor([bits], dtype=torch.int64).view(
            torch.float64).reshape(()).to(device)
    return torch.tensor(bits, dtype=torch.int64).to(dtype).to(device)


class _Val:
    """A symbolic per-row value of the program under construction:
    its SSA id, dtype and rank (0-d values promote like the route's 0-d
    tensors)."""

    __slots__ = ("b", "vid", "dtype", "scalar")
    __hash__ = object.__hash__

    def __init__(self, b, vid: int, dtype: torch.dtype, scalar: bool):
        self.b, self.vid, self.dtype, self.scalar = b, vid, dtype, scalar

    @property
    def device(self):
        return torch.device("cpu")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        for a in list(args) + list((kwargs or {}).values()):
            if isinstance(a, _Val):
                return a.b.call(func, args, kwargs or {})
        raise NotLowerable(func)

    def __bool__(self):
        raise NotLowerable("a host branch on a traced value")

    def _bin(self, name, other, swap=False):
        return self.b.binary(name, other, self) if swap else \
            self.b.binary(name, self, other)

    __add__ = lambda s, o: s._bin("add", o)          # noqa: E731
    __radd__ = lambda s, o: s._bin("add", o, True)   # noqa: E731
    __sub__ = lambda s, o: s._bin("sub", o)          # noqa: E731
    __rsub__ = lambda s, o: s._bin("sub", o, True)   # noqa: E731
    __mul__ = lambda s, o: s._bin("mul", o)          # noqa: E731
    __rmul__ = lambda s, o: s._bin("mul", o, True)   # noqa: E731
    __truediv__ = lambda s, o: s._bin("div", o)      # noqa: E731
    __rtruediv__ = lambda s, o: s._bin("div", o, True)  # noqa: E731
    __floordiv__ = lambda s, o: s._bin("floordiv", o)   # noqa: E731
    __rfloordiv__ = lambda s, o: s._bin("floordiv", o, True)  # noqa: E731
    __mod__ = lambda s, o: s._bin("mod", o)          # noqa: E731
    __rmod__ = lambda s, o: s._bin("mod", o, True)   # noqa: E731
    __eq__ = lambda s, o: s._bin("eq", o)            # noqa: E731
    __ne__ = lambda s, o: s._bin("ne", o)            # noqa: E731
    __lt__ = lambda s, o: s._bin("lt", o)            # noqa: E731
    __le__ = lambda s, o: s._bin("le", o)            # noqa: E731
    __gt__ = lambda s, o: s._bin("gt", o)            # noqa: E731
    __ge__ = lambda s, o: s._bin("ge", o)            # noqa: E731
    __and__ = lambda s, o: s._bin("and", o)          # noqa: E731
    __rand__ = lambda s, o: s._bin("and", o, True)   # noqa: E731
    __or__ = lambda s, o: s._bin("or", o)            # noqa: E731
    __ror__ = lambda s, o: s._bin("or", o, True)     # noqa: E731
    __invert__ = lambda s: s.b.unary("not", s)       # noqa: E731
    __neg__ = lambda s: s.b.unary("neg", s)          # noqa: E731
    __abs__ = lambda s: s.b.unary("abs", s)          # noqa: E731

    def to(self, *args, **kwargs):
        return self.b.call(_T.to, (self, *args), kwargs)

    def long(self):
        return self.b.cast(self, torch.int64)

    def clamp(self, min=None, max=None):  # noqa: A002 - torch's names
        return self.b.clamp(self, min, max)


def _shadow(x):
    """A stand-in of x's dtype and rank (ones: no stand-in divides by
    zero), or x itself when it is a real tensor or a python number."""
    if isinstance(x, _Val):
        return torch.ones(() if x.scalar else (1,), dtype=x.dtype)
    return x


class _Recorder:
    """Records one program's SSA instructions [op, dtype, args, src
    dtype, imm], with common subexpressions merged."""

    def __init__(self, cols: dict, valid: dict, qslots: dict):
        self.ins: list = []
        self.vtype: list = []
        self._memo: dict = {}
        self.luts: list = []
        self._lut_ids: dict = {}
        self.externals: list = []
        self.cols = cols      # name -> real column (dtype, rank)
        self.valid = valid    # name -> real validity plane
        self.qslots = qslots  # slot -> (offset, dtype) of the packed row

    def emit(self, op, dtype, args=(), t2=None, imm=0, scalar=False,
             rtype=None):
        """One instruction computing in `dtype`; its value has dtype
        `rtype` (bool for a compare), `dtype` by default."""
        key = (op, dtype, args, t2, imm)
        vid = self._memo.get(key)
        if vid is None:
            vid = self._memo[key] = len(self.ins)
            self.ins.append((op, dtype, args, t2, imm))
            self.vtype.append(rtype or dtype)
        return _Val(self, vid, rtype or dtype, scalar)

    # ---- operands ----------------------------------------------------
    def operand(self, x, dtype: torch.dtype) -> int:
        if isinstance(x, _Val):
            if x.dtype == dtype:
                return x.vid
            return self.emit(OP_CAST, dtype, (x.vid,), t2=x.dtype).vid
        if isinstance(x, torch.Tensor):
            if x.numel() != 1:
                raise NotLowerable("a tensor constant of more than one value")
            c = x.detach().reshape(()).cpu().to(dtype)
        elif isinstance(x, (bool, int, float)):
            c = torch.tensor(x).to(dtype)
        else:
            raise NotLowerable(f"operand {type(x).__name__}")
        return self.emit(OP_CONST, dtype, imm=_bits(c)).vid

    def load(self, desc, dtype, scalar=False) -> _Val:
        return self.emit(OP_LOAD, dtype, imm=desc, scalar=scalar)

    def param(self, slot: int) -> _Val:
        off, dtype = self.qslots[slot]
        return self.emit(OP_PARAM, dtype, imm=off, scalar=True)

    # ---- torch calls -------------------------------------------------
    def call(self, func, args, kwargs):
        name = _BINARY.get(func)
        if name is not None:
            if len(args) != 2 or kwargs:
                raise NotLowerable(f"{func} with {len(args)} args")
            return self.binary(name, *args)
        if func is torch.div or func is _T.div:
            mode = kwargs.get("rounding_mode")
            if len(args) != 2 or set(kwargs) - {"rounding_mode"}:
                raise NotLowerable("torch.div form")
            if mode is None:
                return self.binary("div", *args)
            if mode == "floor":
                return self.binary("floordiv", *args)
            raise NotLowerable(f"rounding_mode {mode}")
        name = _UNARY.get(func)
        if name is not None:
            if len(args) != 1 or kwargs:
                raise NotLowerable(f"{func} form")
            return self.unary(name, args[0])
        if func is torch.where:
            if len(args) != 3 or kwargs:
                raise NotLowerable("torch.where form")
            return self.where(*args)
        if func in (torch.zeros_like, torch.ones_like):
            x = args[0]
            dt = kwargs.get("dtype") or x.dtype
            c = torch.zeros((), dtype=dt) if func is torch.zeros_like \
                else torch.ones((), dtype=dt)
            return self.emit(OP_CONST, dt, imm=_bits(c), scalar=x.scalar)
        if func is _T.to:
            dts = [a for a in args[1:] if isinstance(a, torch.dtype)]
            if "dtype" in kwargs:
                dts.append(kwargs["dtype"])
            if len(dts) > 1:
                raise NotLowerable(".to form")
            return self.cast(args[0], dts[0]) if dts else args[0]
        if func is _T.__getitem__:
            return self.lut(*args)
        raise NotLowerable(getattr(func, "__name__", str(func)))

    def binary(self, name, x, y):
        sx, sy = _shadow(x), _shadow(y)
        res = _SHADOW_OP[name](sx, sy)  # raises where the route raises
        ct = torch.result_type(sx, sy)
        if name == "div" and not ct.is_floating_point:
            ct = res.dtype
        a, b = self.operand(x, ct), self.operand(y, ct)
        return self.emit(_OPCODE[name], ct, (a, b), scalar=res.dim() == 0,
                         rtype=res.dtype)

    def unary(self, name, x):
        if not isinstance(x, _Val):
            raise NotLowerable("unary op on a constant")
        res = {"neg": torch.neg, "abs": torch.abs, "not": torch.bitwise_not,
               "round": torch.round}[name](_shadow(x))
        return self.emit(_OPCODE[name], x.dtype, (x.vid,), scalar=x.scalar,
                         rtype=res.dtype)

    def cast(self, x, dtype):
        if not isinstance(x, _Val):
            raise NotLowerable("cast of a constant")
        if x.dtype == dtype:
            return x
        return self.emit(OP_CAST, dtype, (x.vid,), t2=x.dtype,
                         scalar=x.scalar)

    def clamp(self, x, lo, hi):
        res = torch.clamp(_shadow(x), lo, hi)
        ct = res.dtype
        v = self.operand(x, ct)
        if lo is not None:
            v = self.emit(OP_MAX, ct, (v, self.operand(lo, ct))).vid
        if hi is not None:
            v = self.emit(OP_MIN, ct, (v, self.operand(hi, ct))).vid
        return _Val(self, v, ct, x.scalar)

    def where(self, c, x, y):
        res = torch.where(_shadow(c), _shadow(x), _shadow(y))
        ct = res.dtype
        cv = self.operand(c, torch.bool)
        a, b = self.operand(x, ct), self.operand(y, ct)
        return self.emit(OP_SELECT, ct, (cv, a, b), scalar=res.dim() == 0)

    def lut(self, table, idx):
        if not (isinstance(table, torch.Tensor) and isinstance(idx, _Val)
                and table.dim() == 1 and not idx.dtype.is_floating_point
                and idx.dtype != torch.bool and table.dtype in DTYPE_CODE):
            raise NotLowerable("indexing form")
        # keyed by identity: the entry keeps the table alive, so a later
        # temporary table cannot reuse its id within this trace
        hit = self._lut_ids.get(id(table))
        if hit is not None and hit[0] is table:
            k = hit[1]
        else:
            k = len(self.luts)
            self._lut_ids[id(table)] = (table, k)
            host = table
            if table.device.type != "cpu" or not table.is_contiguous():
                host = table.detach().cpu().contiguous()
            if host.numel() == 0:
                # an empty dictionary: every code clamps to 0, and no row
                # that reads it is valid
                host = torch.zeros(1, dtype=table.dtype)
            # the route's cached tables (`_cached_lut`) stay the same
            # object, so programs share their device copies
            self.luts.append(host)
        i = self.operand(idx, torch.int64)
        return self.emit(OP_LUT, table.dtype, (i,), imm=("lut", k),
                         scalar=idx.scalar)

    def external(self, e, dtype, has_valid: bool):
        """A subtree the torch route evaluates at run time, as a column
        (and its validity plane)."""
        for k, x in enumerate(self.externals):
            if x == e:
                break
        else:
            k = len(self.externals)
            self.externals.append(e)
        return (self.load(("ext", k), dtype),
                self.load(("extv", k), torch.bool) if has_valid else None)


class _TraceCols:
    """The trace batch's columns: a load on first use."""

    def __init__(self, b: _Recorder, real: dict, kind: str):
        self.b, self.real, self.kind = b, real, kind

    def __getitem__(self, name):
        t = self.real[name]
        if t.dim() != 1 or t.dtype not in DTYPE_CODE:
            raise NotLowerable(f"column {name} of shape {tuple(t.shape)}")
        return self.b.load((self.kind, name), t.dtype)

    def get(self, name, default=None):
        if name not in self.real:
            return default
        return self[name]

    def __contains__(self, name):
        return name in self.real


class TraceBatch:
    """The trace batch: schema and dictionaries of the real batch;
    columns, validity planes and sel as symbolic loads; a capacity of 1,
    so the route's column-shaped constants (zeros(capacity)) are tensors
    of one value."""

    capacity = 1
    device = torch.device("cpu")

    def __init__(self, b: _Recorder, real):
        self.b = b
        self.schema = real.schema
        self.dicts = real.dicts
        self.cols = _TraceCols(b, real.cols, "col")
        self.valid = _TraceCols(b, real.valid, "valid")

    @property
    def sel(self):
        return self.b.load(("sel",), torch.bool)


class _TraceParams:
    """The parameter frame while tracing: slot i is a symbolic read of
    the packed row."""

    def __init__(self, b: _Recorder):
        self.b = b

    def __getitem__(self, slot):
        if slot not in self.b.qslots:
            raise NotLowerable(f"parameter slot {slot} outside the row")
        return self.b.param(slot)


def is_trace(batch) -> bool:
    return isinstance(batch, TraceBatch)


# ---------------------------------------------------------------------------
# scheduling: SSA -> chunks of register code
# ---------------------------------------------------------------------------

# the shared file's bytes a row (32-bit slots 4, int64 / float64 slots 8)
# up to which a chunk runs 8 rows a thread, past which 4
# (csrc/k24_fused_expr.cu K24_FILE8_BYTES)
FILE8_BYTES = 96
# an operand naming a uniform slot (the prologue's values) has this bit
UNI = 0x80
_WIDE = (torch.int64, torch.float64)
_CMP = (OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE)


def uniform_values(ins) -> list:
    """Which SSA values are the same on every row: parameters, constants
    and every instruction whose operands all are (a LUT read at a uniform
    index included). The kernel computes them once, in a chunk's
    prologue, and no row register holds them."""
    uni = []
    for op, _t, args, _t2, _imm in ins:
        if op in (OP_PARAM, OP_CONST):
            uni.append(True)
        elif op == OP_LOAD:
            uni.append(False)
        else:
            uni.append(all(uni[a] for a in args))
    return uni


class Chunk:
    """One launch: the uniform prologue `ucode` (dst a uniform slot) and
    the row code `code` [(op, t, dst, a, b, c, t2, imm)] with dtype codes,
    an operand being a slot of the shared file in its class (32-bit
    values, int64 / float64) or UNI | a uniform slot; its input and output
    tables; n32 / n64 the file's slots of each class; `rows` the rows a
    thread runs (8 where the file is small, else 4); `hoisted`: the row
    code starts with every LOAD; `nregs` the row values live at once; the
    code's bytes in the kernel's layout (prologue first)."""

    __slots__ = ("code", "ucode", "inputs", "outputs", "nregs", "n32", "n64",
                 "rows", "hoisted", "blob")

    def __init__(self):
        self.code: list = []
        self.ucode: list = []
        self.inputs: list = []
        self.outputs: list = []
        self.nregs = 0
        self.n32 = 0
        self.n64 = 0
        self.rows = 4
        self.hoisted = True
        self.blob = b""


class Program:
    """A lowered tree (or list of trees): chunks, output dtypes, the
    (value, validity) output index pairs of each tree (None = no plane),
    LUTs, temporaries and the subtrees the torch route evaluates."""

    def __init__(self):
        self.chunks: list[Chunk] = []
        self.out_dtypes: list = []
        self.tmp_dtypes: list = []
        self.pairs: list = []
        self.luts: list = []
        self.externals: list = []

    def luts_on(self, device) -> list:
        return [device_lut(t, device) for t in self.luts]

    @property
    def nbytes(self) -> int:
        """Host bytes of the program's lookup tables."""
        return sum(t.numel() * t.element_size() for t in self.luts)

    @property
    def n_instructions(self) -> int:
        return sum(len(c.code) + len(c.ucode) for c in self.chunks)


# Device copies of the programs' host lookup tables, keyed by the host
# table's identity (the entry keeps it alive, so an id is not reused) and
# device: a dictionary's LUT is on the card once however many programs
# read it. Bounded by bytes, least recently used out first.
_DEV_LUTS: OrderedDict = OrderedDict()
_DEV_LUT_BYTES_MAX = 64 << 20
_DEV_LUT_LOCK = threading.Lock()
_dev_lut_bytes = 0


def device_lut(t: torch.Tensor, device) -> torch.Tensor:
    """The copy of host table `t` on `device` (t itself on the CPU)."""
    global _dev_lut_bytes
    device = torch.device(device)
    if device.type == "cpu":
        return t
    key = (id(t), str(device))
    with _DEV_LUT_LOCK:
        hit = _DEV_LUTS.get(key)
        if hit is not None and hit[0] is t:
            _DEV_LUTS.move_to_end(key)
            return hit[1]
    dev = t.to(device)
    nb = t.numel() * t.element_size()
    with _DEV_LUT_LOCK:
        old = _DEV_LUTS.pop(key, None)
        if old is not None:
            _dev_lut_bytes -= old[2]
        _DEV_LUTS[key] = (t, dev, nb)
        _dev_lut_bytes += nb
        while len(_DEV_LUTS) > 1 and _dev_lut_bytes > _DEV_LUT_BYTES_MAX:
            _dev_lut_bytes -= _DEV_LUTS.popitem(last=False)[1][2]
    return dev


_INS = struct.Struct("<8Bq")


def _encode(code) -> bytes:
    out = bytearray()
    for op, t, dst, a, b, c, t2, imm in code:
        out += _INS.pack(op, t, dst, a, b, c, t2, 0, imm)
    return bytes(out)


def _order(vcode, hoist: bool) -> list:
    """The chunk's virtual row code [(op, dtype, dst vid, arg vids, t2,
    imm)] reordered to keep few values live: from each store (in order),
    an instruction's operands are computed before it, the one with the
    most instructions under it first (as Sethi and Ullman order a tree).
    `hoist`: every LOAD first (in order), else each LOAD where its value
    is first needed."""
    by_dst = {e[2]: i for i, e in enumerate(vcode) if e[2] is not None}
    size: dict = {}

    def weight(i):
        if i not in size:
            size[i] = 1 + sum(weight(by_dst[a]) for a in vcode[i][3]
                              if a in by_dst)
        return size[i]

    out, seen = [], set()
    if hoist:
        for i, e in enumerate(vcode):
            if e[0] == OP_LOAD:
                out.append(e)
                seen.add(i)

    def visit(i):
        stack = [(i, False)]
        while stack:
            j, done = stack.pop()
            if j in seen:
                continue
            if done:
                seen.add(j)
                out.append(vcode[j])
                continue
            stack.append((j, True))
            args = [by_dst[a] for a in dict.fromkeys(vcode[j][3])
                    if a in by_dst and by_dst[a] not in seen]
            # the heaviest operand first: pushed last
            for k in sorted(args, key=weight):
                stack.append((k, False))

    for i, e in enumerate(vcode):
        if e[2] is None:
            visit(i)
    return out


def _allocate(vcode, vtype, uslot, hoist: bool):
    """File slots for a chunk's virtual row code, reordered (`_order`):
    each value a slot of its class (32-bit values, int64 / float64), the
    lowest free first, an operand's slot free for the result of the
    instruction that reads it last. Returns (code, n32, n64)."""
    vcode = _order(vcode, hoist)
    last: dict = {}
    for i, e in enumerate(vcode):
        for a in e[3]:
            if a not in uslot:
                last[a] = i
    free = {False: [], True: []}
    top = {False: 0, True: 0}
    reg: dict = {}
    code = []
    for i, (op, t, dst, args, t2, imm) in enumerate(vcode):
        ops = [UNI | uslot[a] if a in uslot else reg[a] for a in args]
        for a in dict.fromkeys(args):
            if a not in uslot and last[a] == i:
                free[vtype[a] in _WIDE].append(reg.pop(a))
        d = 0
        if dst is not None:
            w = vtype[dst] in _WIDE
            if free[w]:
                free[w].sort()
                d = free[w].pop(0)
            else:
                d = top[w]
                top[w] += 1
            reg[dst] = d
            if last.get(dst, -1) <= i:
                free[w].append(reg.pop(dst))
        ops += [0] * (3 - len(ops))
        code.append((op, DTYPE_CODE[t], d, ops[0], ops[1], ops[2],
                     DTYPE_CODE[t2] if t2 is not None else 0, imm))
    return code, top[False], top[True]


def schedule(ins, vtype, outputs, prog: Program, max_ins=MAX_INS,
             max_regs=MAX_REGS, max_in=MAX_IN, max_out=MAX_OUT,
             max_uni=MAX_UNI):
    """Cut the SSA list into chunks within the launch limits and allocate
    each chunk's registers. `outputs` lists the vids the program writes,
    in order; a row value live across a cut is spilled to a temporary.
    Uniform values (`uniform_values`) leave the row code: each chunk's
    prologue computes the ones it reads, once per block."""
    uni = uniform_values(ins)
    for v, (op, t, _a, _t2, _imm) in enumerate(ins):
        if not uni[v] and op not in _CMP and vtype[v] != t:
            raise NotLowerable(f"opcode {op} of {t} makes {vtype[v]}")
    # live instructions only, with the output stores placed right after
    # each output's definition (at the end for reloadable values)
    live = set(outputs)
    for i in range(len(ins) - 1, -1, -1):
        if i in live:
            for a in ins[i][2]:
                live.add(a)
    stores_after: dict = {}
    tail = []
    for k, v in enumerate(outputs):
        if ins[v][0] == OP_LOAD or uni[v]:
            tail.append((k, v))
        else:
            stores_after.setdefault(v, []).append(k)
    order = []
    for i in range(len(ins)):
        if i in live and not uni[i]:
            order.append(("ins", i))
            for k in stores_after.get(i, ()):
                order.append(("store", k, i))
    order += [("store", k, v) for k, v in tail]
    last: dict = {}
    for pos, item in enumerate(order):
        args = ins[item[1]][2] if item[0] == "ins" else (item[2],)
        for a in args:
            if not uni[a]:
                last[a] = pos
    spilled: dict = {}

    def closure(vs, have):
        """The uniform values `vs` need that `have` lacks, in SSA order."""
        need, stack = set(), [v for v in vs if uni[v] and v not in have]
        while stack:
            v = stack.pop()
            if v in need:
                continue
            need.add(v)
            stack += [a for a in ins[v][2] if a not in have]
        return sorted(need)

    class _Cut:
        def __init__(self):
            self.chunk = Chunk()
            self.vcode = []      # (op, dtype, dst vid, arg vids, t2, imm)
            self.live = set()    # row vids in registers
            self.uvals = []      # uniform vids, SSA order
            self.in_idx = {}

        def input_slot(self, desc):
            k = self.in_idx.get(desc)
            if k is None:
                k = self.in_idx[desc] = len(self.chunk.inputs)
                self.chunk.inputs.append(desc)
            return k

        def note_live(self):
            self.chunk.nregs = max(self.chunk.nregs, len(self.live))

    cur = _Cut()

    def bring(v):
        """Make v available to this chunk's row code."""
        if uni[v]:
            for u in closure((v,), set(cur.uvals)):
                cur.uvals.append(u)
                if ins[u][0] == OP_LUT:
                    cur.input_slot(ins[u][4])
            cur.uvals.sort()
            return
        if v in cur.live:
            return
        op, t, _args, _t2, imm = ins[v]
        if op == OP_LOAD:
            cur.vcode.append((OP_LOAD, t, v, (), None, cur.input_slot(imm)))
        else:
            cur.vcode.append((OP_LOAD, vtype[v], v, (), None,
                              cur.input_slot(("tmp", spilled[v]))))
        cur.live.add(v)
        cur.note_live()

    def close(pos):
        for v in sorted(cur.live):
            if ins[v][0] == OP_LOAD or v in spilled or last.get(v, -1) < pos:
                continue
            k = len(prog.tmp_dtypes)
            prog.tmp_dtypes.append(vtype[v])
            spilled[v] = k
            cur.vcode.append((OP_STORE, vtype[v], None, (v,), None,
                              len(cur.chunk.outputs)))
            cur.chunk.outputs.append(("tmp", k))
        finish(cur)
        prog.chunks.append(cur.chunk)

    def finish(c):
        ch = c.chunk
        uslot = {u: i for i, u in enumerate(c.uvals)}
        for u in c.uvals:
            op, t, args, t2, imm = ins[u]
            if op == OP_LUT:
                imm = c.in_idx[imm]
            ops = [UNI | uslot[a] for a in args] + [0] * (3 - len(args))
            ch.ucode.append((op, DTYPE_CODE[t], uslot[u], ops[0], ops[1],
                             ops[2], DTYPE_CODE[t2] if t2 is not None else 0,
                             imm))
        # every LOAD first where the file's slots allow, else each LOAD at
        # its first reader
        code, n32, n64 = _allocate(c.vcode, vtype, uslot, True)
        ch.hoisted = n32 + n64 <= max_regs
        if not ch.hoisted:
            code, n32, n64 = _allocate(c.vcode, vtype, uslot, False)
        ch.code, ch.n32, ch.n64 = code, n32, n64
        ch.rows = 8 if 4 * n32 + 8 * n64 <= FILE8_BYTES else 4
        ch.blob = _encode(ch.ucode + ch.code)

    def fits(args, new_in, new_out, pos):
        rows = [a for a in dict.fromkeys(args) if not uni[a]]
        missing = [a for a in rows if a not in cur.live]
        unew = closure([a for a in args if uni[a]], set(cur.uvals))
        ndead = sum(1 for a in rows if a in cur.live and last[a] <= pos)
        spills = sum(1 for v in cur.live if ins[v][0] != OP_LOAD
                     and v not in spilled and last.get(v, -1) > pos) + 1
        nuni = len(cur.uvals) + len(unew)
        nins = (len(cur.vcode) + nuni + len(missing) + 1 + spills)
        nregs = len(cur.live) + len(missing) + 1 - ndead
        nin = (len(cur.chunk.inputs) + new_in + len(missing)
               + sum(1 for u in unew if ins[u][0] == OP_LUT))
        nout = len(cur.chunk.outputs) + new_out + spills
        return (nins <= max_ins and nregs <= max_regs and nin <= max_in
                and nout <= max_out and nuni <= max_uni)

    for pos, item in enumerate(order):
        if item[0] == "store":
            _s, k, v = item
            args, new_in, new_out = (v,), 0, 1
        else:
            v = item[1]
            op, t, args, t2, imm = ins[v]
            if op == OP_LOAD:
                continue
            new_in, new_out = (1 if op == OP_LUT else 0), 0
        if cur.vcode and not fits(args, new_in, new_out, pos):
            close(pos)
            cur = _Cut()
        for a in args:
            bring(a)
        for a in dict.fromkeys(args):
            if not uni[a] and last[a] <= pos:
                cur.live.discard(a)
        if item[0] == "store":
            cur.vcode.append((OP_STORE, vtype[v], None, (v,), None,
                              len(cur.chunk.outputs)))
            cur.chunk.outputs.append(("out", k))
            continue
        imm2 = cur.input_slot(imm) if op == OP_LUT else imm
        cur.vcode.append((op, t, v, tuple(args), t2, imm2))
        if last.get(v, -1) > pos:
            cur.live.add(v)
            cur.note_live()
        else:
            cur.chunk.nregs = max(cur.chunk.nregs, len(cur.live) + 1)
    close(len(order))


# ---------------------------------------------------------------------------
# lowering entry
# ---------------------------------------------------------------------------

_LOWER_LOCK = threading.Lock()


def lower(exprs, batch, route, predicate_route, set_params, qslots,
          framed: bool, predicate: bool) -> Program:
    """Trace `route` (the torch route's evaluate) over each tree, or
    `predicate_route` over the one tree in predicate mode, and schedule
    the result. `framed`: a parameter frame is active, and `qslots` maps
    each of its slots the trees read to (offset, dtype) in the packed
    row. Raises NotLowerable."""
    with _LOWER_LOCK:
        b = _Recorder(batch.cols, batch.valid, qslots)
        tb = TraceBatch(b, batch)
        prev = set_params(_TraceParams(b) if framed else None)
        try:
            with torch.no_grad():
                if predicate:
                    results = [(predicate_route(exprs[0], tb), None)]
                else:
                    results = [route(e, tb) for e in exprs]
        finally:
            set_params(prev)
        prog = Program()
        outputs = []

        def out(x):
            if x is None:
                return None
            if not isinstance(x, _Val):
                if not isinstance(x, torch.Tensor) or x.dim() != 1:
                    raise NotLowerable("a 0-d output")
                x = b.emit(OP_CONST, x.dtype, imm=_bits(x.reshape(())))
            elif x.scalar:
                raise NotLowerable("a 0-d output")
            outputs.append(x.vid)
            prog.out_dtypes.append(x.dtype)
            return len(outputs) - 1

        for v, vv in results:
            prog.pairs.append((out(v), out(vv)))
        schedule(b.ins, b.vtype, outputs, prog)
        prog.luts = b.luts
        prog.externals = b.externals
        return prog


def external_route(e, batch, dtype, refs):
    """Inside a trace: a torch-route subtree enters as an input column,
    with a validity plane where a column it reads has one (the vector
    distances carry their argument's)."""
    has_valid = any(n in batch.valid for n in refs)
    return batch.b.external(e, dtype, has_valid)
