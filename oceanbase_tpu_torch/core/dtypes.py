"""SQL type system mapped onto TPU-friendly physical representations.

Reference surface: OceanBase's ObObjType / ObObjMeta boxed-value type system
(deps/oblib/src/common/object/ob_object.h) and the datum width table
(src/share/datum/ob_datum.h:30). The rebuild collapses that 40+-type lattice
into a small set of *physical* representations chosen for the TPU:

- integers:   int8/16/32/64 device arrays (int64 is emulated on TPU as an
              int32 pair by XLA; kernels prefer the narrowest width that fits)
- floats:     float32 / float64 (f64 only on CPU paths; TPU kernels use f32)
- decimal:    scaled integers (DECIMAL(p,s) -> int32 if p-s small else int64).
              This mirrors the reference's own trick of storing decimals as
              integer words (lib/number) but with a fixed compile-time scale so
              arithmetic stays on the VPU/MXU with no per-value interpretation.
- date:       int32 days since 1970-01-01 (reference: ObDateType).
- varchar:    dictionary-encoded int32 codes + a host-side Dictionary
              (reference precedent: the dict encodings in
              storage/blocksstable/encoding/ob_dict_decoder_simd.cpp; here the
              dictionary is global per column so joins/group-bys on strings
              become integer problems on device).
- bool:       bool_ arrays (predicate masks are first-class; the analog of
              ObBitVector / ObBatchRows.skip_, src/sql/engine/ob_bit_vector.h).

Null handling: a separate validity bool array per column (True = present),
the SoA analog of ObDatum's null_ flag bit (src/share/datum/ob_datum.h:111).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class TypeKind(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL = "decimal"  # scaled integer
    DATE = "date"  # int32 days since epoch
    TIMESTAMP = "timestamp"  # int64 microseconds since epoch
    VARCHAR = "varchar"  # dict-encoded int32 codes
    VECTOR = "vector"  # fixed-dim float32 rows; precision = dimension


_INT_KINDS = {TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64}


@dataclass(frozen=True)
class DataType:
    """A logical SQL type with a fixed physical representation.

    For DECIMAL, `precision`/`scale` follow SQL DECIMAL(p, s); the physical
    array holds value * 10**s as an integer of width `storage_np` (int32 when
    the scaled magnitude provably fits, else int64).
    """

    kind: TypeKind
    precision: int = 0
    scale: int = 0
    nullable: bool = False

    # ---- constructors ------------------------------------------------
    @staticmethod
    def bool_(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.BOOL, nullable=nullable)

    @staticmethod
    def int8(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.INT8, nullable=nullable)

    @staticmethod
    def int16(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.INT16, nullable=nullable)

    @staticmethod
    def int32(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.INT32, nullable=nullable)

    @staticmethod
    def int64(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.INT64, nullable=nullable)

    @staticmethod
    def float32(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.FLOAT32, nullable=nullable)

    @staticmethod
    def float64(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.FLOAT64, nullable=nullable)

    @staticmethod
    def decimal(precision: int, scale: int, nullable: bool = False) -> "DataType":
        if not (0 < precision <= 18 and 0 <= scale <= precision):
            raise ValueError(f"unsupported DECIMAL({precision},{scale})")
        return DataType(TypeKind.DECIMAL, precision, scale, nullable)

    @staticmethod
    def date(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.DATE, nullable=nullable)

    @staticmethod
    def timestamp(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.TIMESTAMP, nullable=nullable)

    @staticmethod
    def varchar(nullable: bool = False) -> "DataType":
        return DataType(TypeKind.VARCHAR, nullable=nullable)

    @staticmethod
    def vector(dim: int) -> "DataType":
        """Fixed-dimension embedding column: float32 rows of shape (dim,)
        (reference: src/storage/vector_index — obvec stores float arrays;
        here the whole column is one (n, dim) device matrix so distance
        scoring is a matmul on the MXU)."""
        return DataType(TypeKind.VECTOR, precision=dim)

    # ---- physical representation -------------------------------------
    @property
    def storage_np(self) -> np.dtype:
        k = self.kind
        if k is TypeKind.BOOL:
            return np.dtype(np.bool_)
        if k is TypeKind.INT8:
            return np.dtype(np.int8)
        if k is TypeKind.INT16:
            return np.dtype(np.int16)
        if k in (TypeKind.INT32, TypeKind.DATE, TypeKind.VARCHAR):
            return np.dtype(np.int32)
        if k in (TypeKind.INT64, TypeKind.TIMESTAMP):
            return np.dtype(np.int64)
        if k in (TypeKind.FLOAT32, TypeKind.VECTOR):
            return np.dtype(np.float32)
        if k is TypeKind.FLOAT64:
            return np.dtype(np.float64)
        if k is TypeKind.DECIMAL:
            # 9 decimal digits fit int32; wider needs int64.
            return np.dtype(np.int32) if self.precision <= 9 else np.dtype(np.int64)
        raise AssertionError(k)

    @property
    def is_integer(self) -> bool:
        return self.kind in _INT_KINDS

    @property
    def is_numeric(self) -> bool:
        return self.kind in _INT_KINDS or self.kind in (
            TypeKind.FLOAT32,
            TypeKind.FLOAT64,
            TypeKind.DECIMAL,
        )

    @property
    def is_float(self) -> bool:
        return self.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64)

    @property
    def is_decimal(self) -> bool:
        return self.kind is TypeKind.DECIMAL

    @property
    def decimal_factor(self) -> int:
        """10**scale for DECIMAL, 1 otherwise."""
        return 10**self.scale if self.kind is TypeKind.DECIMAL else 1

    def with_nullable(self, nullable: bool) -> "DataType":
        return DataType(self.kind, self.precision, self.scale, nullable)

    def __str__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            s = f"decimal({self.precision},{self.scale})"
        else:
            s = self.kind.value
        return s + ("?" if self.nullable else "")


# Common singletons
BOOL = DataType.bool_()
INT8 = DataType.int8()
INT16 = DataType.int16()
INT32 = DataType.int32()
INT64 = DataType.int64()
FLOAT32 = DataType.float32()
FLOAT64 = DataType.float64()
DATE = DataType.date()
TIMESTAMP = DataType.timestamp()
VARCHAR = DataType.varchar()


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Result type for arithmetic between two numeric types.

    Mirrors (in spirit) the reference's implicit-cast lattice
    (sql/engine/expr/ob_expr_operator.*): float dominates decimal dominates
    integer; integer widths promote to the wider side; decimal arithmetic
    result scales are handled by the expression compiler (see expr/compile.py),
    this only merges storage class.
    """
    if a.is_float or b.is_float:
        k = (
            TypeKind.FLOAT64
            if TypeKind.FLOAT64 in (a.kind, b.kind)
            else TypeKind.FLOAT32
        )
        return DataType(k, nullable=a.nullable or b.nullable)
    if a.is_decimal or b.is_decimal:
        scale = max(a.scale, b.scale)
        prec = max(a.precision - a.scale, b.precision - b.scale) + scale
        return DataType.decimal(min(prec, 18), scale, a.nullable or b.nullable)
    order = [TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64]
    if a.is_integer and b.is_integer:
        k = order[max(order.index(a.kind), order.index(b.kind))]
        return DataType(k, nullable=a.nullable or b.nullable)
    raise TypeError(f"no common numeric type for {a} and {b}")


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType


@dataclass(frozen=True)
class Schema:
    """Ordered, named fields. The analog of a resolved output row type."""

    fields: tuple[Field, ...] = field(default_factory=tuple)

    @staticmethod
    def of(**cols: DataType) -> "Schema":
        return Schema(tuple(Field(n, t) for n, t in cols.items()))

    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def __getitem__(self, name: str) -> DataType:
        for f in self.fields:
            if f.name == name:
                return f.dtype
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)
