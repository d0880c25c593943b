"""Logical type system for the query engine.

Role parity: ``velox/type/Type.h`` (TypeKind enum at Type.h:60-81, RowType,
type parsing/serde). Departures for the device:

* Every scalar type carries its **device dtype** (the jnp dtype its column
  data uses in HBM). SQL logical types map onto dense numeric device arrays:
  DATE -> int32 days, TIMESTAMP -> int64 micros, short DECIMAL -> int64
  scaled integer. There is no per-value boxing anywhere.
* VARCHAR columns live on device as dictionary ids (int32) with a host-side
  value dictionary, or as fixed-width byte matrices for kernel-side string
  ops — both are *layout metadata* (see vector/device.py), not subclasses.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


class TypeKind(enum.Enum):
    # Mirrors velox/type/Type.h:60-81 (minus OPAQUE/FUNCTION; UNKNOWN kept).
    BOOLEAN = "boolean"
    TINYINT = "tinyint"
    SMALLINT = "smallint"
    INTEGER = "integer"
    BIGINT = "bigint"
    HUGEINT = "hugeint"
    REAL = "real"
    DOUBLE = "double"
    VARCHAR = "varchar"
    VARBINARY = "varbinary"
    TIMESTAMP = "timestamp"
    DATE = "date"
    DECIMAL = "decimal"
    ARRAY = "array"
    MAP = "map"
    ROW = "row"
    UNKNOWN = "unknown"


_FIXED_WIDTH_NP = {
    TypeKind.BOOLEAN: np.dtype(np.bool_),
    TypeKind.TINYINT: np.dtype(np.int8),
    TypeKind.SMALLINT: np.dtype(np.int16),
    TypeKind.INTEGER: np.dtype(np.int32),
    TypeKind.BIGINT: np.dtype(np.int64),
    TypeKind.REAL: np.dtype(np.float32),
    TypeKind.DOUBLE: np.dtype(np.float64),
    TypeKind.TIMESTAMP: np.dtype(np.int64),  # micros since epoch
    TypeKind.DATE: np.dtype(np.int32),  # days since epoch
    TypeKind.DECIMAL: np.dtype(np.int64),  # scaled integer (short decimal)
    TypeKind.UNKNOWN: np.dtype(np.bool_),  # all-null column
}

_INTEGRAL_KINDS = frozenset(
    {TypeKind.TINYINT, TypeKind.SMALLINT, TypeKind.INTEGER, TypeKind.BIGINT}
)
_FLOATING_KINDS = frozenset({TypeKind.REAL, TypeKind.DOUBLE})


@dataclass(frozen=True)
class DataType:
    """A logical SQL type. Hashable/frozen so it can be jit-static metadata."""

    kind: TypeKind
    # DECIMAL parameters.
    precision: int = 0
    scale: int = 0
    # Complex-type children (ARRAY: [elem], MAP: [key, value], ROW: fields).
    children: Tuple["DataType", ...] = ()
    names: Tuple[str, ...] = ()  # ROW field names

    # ---- classification ----
    @property
    def is_fixed_width(self) -> bool:
        return self.kind in _FIXED_WIDTH_NP

    @property
    def is_integral(self) -> bool:
        return self.kind in _INTEGRAL_KINDS

    @property
    def is_floating(self) -> bool:
        return self.kind in _FLOATING_KINDS

    @property
    def is_numeric(self) -> bool:
        return self.is_integral or self.is_floating or self.kind is TypeKind.DECIMAL

    @property
    def is_string(self) -> bool:
        return self.kind in (TypeKind.VARCHAR, TypeKind.VARBINARY)

    @property
    def is_complex(self) -> bool:
        return self.kind in (TypeKind.ARRAY, TypeKind.MAP, TypeKind.ROW)

    @property
    def is_long_decimal(self) -> bool:
        """DECIMAL(19..38): int128 backing as two int64 limb columns
        (lo = primary data, hi = child; ops/int128.py). Parity:
        velox/type/HugeInt.h, type/DecimalUtil.h."""
        return self.kind is TypeKind.DECIMAL and self.precision > 18

    # ---- device layout ----
    def np_dtype(self) -> np.dtype:
        """The numpy/jnp dtype of this type's primary device buffer.

        Strings use int32 dictionary ids; complex types use int32 offsets
        (their children carry their own buffers).
        """
        if self.kind in _FIXED_WIDTH_NP:
            return _FIXED_WIDTH_NP[self.kind]
        if self.is_string:
            return np.dtype(np.int32)  # dictionary ids
        if self.is_complex:
            return np.dtype(np.int32)  # offsets
        raise TypeError(f"no device dtype for {self.kind}")

    # ---- constructors for complex types ----
    def __str__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.kind is TypeKind.ARRAY:
            return f"array({self.children[0]})"
        if self.kind is TypeKind.MAP:
            return f"map({self.children[0]},{self.children[1]})"
        if self.kind is TypeKind.ROW:
            inner = ",".join(
                f"{n}:{c}" for n, c in zip(self.names, self.children)
            )
            return f"row({inner})"
        return self.kind.value

    # ROW accessors
    def field_index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"field {name!r} not in {self}") from None

    def field_type(self, name: str) -> "DataType":
        return self.children[self.field_index(name)]

    @property
    def size(self) -> int:
        return len(self.children)


# Singleton scalar types.
BOOLEAN = DataType(TypeKind.BOOLEAN)
TINYINT = DataType(TypeKind.TINYINT)
SMALLINT = DataType(TypeKind.SMALLINT)
INTEGER = DataType(TypeKind.INTEGER)
BIGINT = DataType(TypeKind.BIGINT)
HUGEINT = DataType(TypeKind.HUGEINT)
REAL = DataType(TypeKind.REAL)
DOUBLE = DataType(TypeKind.DOUBLE)
VARCHAR = DataType(TypeKind.VARCHAR)
VARBINARY = DataType(TypeKind.VARBINARY)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
DATE = DataType(TypeKind.DATE)
UNKNOWN = DataType(TypeKind.UNKNOWN)


def decimal(precision: int, scale: int) -> DataType:
    if not (1 <= precision <= 38):
        raise ValueError(f"unsupported decimal precision {precision}")
    return DataType(TypeKind.DECIMAL, precision=precision, scale=scale)


def array(elem: DataType) -> DataType:
    return DataType(TypeKind.ARRAY, children=(elem,))


def map_(key: DataType, value: DataType) -> DataType:
    return DataType(TypeKind.MAP, children=(key, value))


def row(names, types) -> DataType:
    names = tuple(names)
    types = tuple(types)
    assert len(names) == len(types)
    return DataType(TypeKind.ROW, children=types, names=names)


RowType = DataType  # alias: a ROW-kind DataType


_PARSE_SIMPLE = {t.kind.value: t for t in (
    BOOLEAN, TINYINT, SMALLINT, INTEGER, BIGINT, HUGEINT, REAL, DOUBLE,
    VARCHAR, VARBINARY, TIMESTAMP, DATE, UNKNOWN,
)}


def parse_type(s: str) -> DataType:
    """Parse 'bigint', 'decimal(12,2)', 'array(bigint)', 'row(a:bigint,...)'."""
    s = s.strip().lower()
    if s in _PARSE_SIMPLE:
        return _PARSE_SIMPLE[s]
    if s.startswith("decimal(") and s.endswith(")"):
        p, sc = s[len("decimal("):-1].split(",")
        return decimal(int(p), int(sc))
    if s.startswith("array(") and s.endswith(")"):
        return array(parse_type(s[len("array("):-1]))
    if s.startswith("map(") and s.endswith(")"):
        k, v = _split_top(s[len("map("):-1])
        return map_(parse_type(k), parse_type(v))
    if s.startswith("row(") and s.endswith(")"):
        parts = _split_top(s[len("row("):-1])
        names, types = [], []
        for part in parts:
            n, t = part.split(":", 1)
            names.append(n.strip())
            types.append(parse_type(t))
        return row(names, types)
    raise ValueError(f"cannot parse type {s!r}")


def _split_top(s: str):
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


# ---- pyarrow interop -------------------------------------------------------

def to_arrow(dt: DataType):
    import pyarrow as pa

    m = {
        TypeKind.BOOLEAN: pa.bool_(),
        TypeKind.TINYINT: pa.int8(),
        TypeKind.SMALLINT: pa.int16(),
        TypeKind.INTEGER: pa.int32(),
        TypeKind.BIGINT: pa.int64(),
        TypeKind.REAL: pa.float32(),
        TypeKind.DOUBLE: pa.float64(),
        TypeKind.VARCHAR: pa.string(),
        TypeKind.VARBINARY: pa.binary(),
        TypeKind.TIMESTAMP: pa.timestamp("us"),
        TypeKind.DATE: pa.date32(),
        TypeKind.UNKNOWN: pa.null(),
    }
    if dt.kind in m:
        return m[dt.kind]
    if dt.kind is TypeKind.DECIMAL:
        return pa.decimal128(dt.precision, dt.scale)
    if dt.kind is TypeKind.ARRAY:
        return pa.list_(to_arrow(dt.children[0]))
    if dt.kind is TypeKind.MAP:
        return pa.map_(to_arrow(dt.children[0]), to_arrow(dt.children[1]))
    if dt.kind is TypeKind.ROW:
        return pa.struct(
            [pa.field(n, to_arrow(c)) for n, c in zip(dt.names, dt.children)]
        )
    raise TypeError(f"no arrow type for {dt}")


def from_arrow(at) -> DataType:
    import pyarrow as pa
    import pyarrow.types as pat

    if pat.is_boolean(at):
        return BOOLEAN
    if pat.is_int8(at):
        return TINYINT
    if pat.is_int16(at):
        return SMALLINT
    if pat.is_int32(at):
        return INTEGER
    if pat.is_int64(at):
        return BIGINT
    if pat.is_float32(at):
        return REAL
    if pat.is_float64(at):
        return DOUBLE
    if pat.is_string(at) or pat.is_large_string(at):
        return VARCHAR
    if pat.is_binary(at) or pat.is_large_binary(at):
        return VARBINARY
    if pat.is_timestamp(at):
        return TIMESTAMP
    if pat.is_date(at):
        return DATE
    if pat.is_decimal(at):
        return decimal(at.precision, at.scale)
    if pat.is_dictionary(at):
        return from_arrow(at.value_type)
    if pat.is_list(at):
        return array(from_arrow(at.value_type))
    if pat.is_map(at):
        return map_(from_arrow(at.key_type), from_arrow(at.item_type))
    if pat.is_struct(at):
        return row([f.name for f in at], [from_arrow(f.type) for f in at])
    if pat.is_null(at):
        return UNKNOWN
    raise TypeError(f"no DataType for arrow type {at}")
