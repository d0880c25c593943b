"""Aggregate function package.

Role parity: ``velox/exec/Aggregate.h:43`` (the accumulator SPI:
addRawInput/addIntermediateResults/extractValues) and the Presto aggregate
library (velox/functions/prestosql/aggregates).

Device-first redesign: accumulators are **columnar state vectors**, not rows in
a RowContainer. An aggregate is described by a list of *states*, each with a
segment-combine op (sum/min/max); the execution layer computes per-row
addends once per batch and reduces them with jax segment ops into dense
per-group state. Velox's companion-function split (partial/merge/extract,
exec/AggregateCompanionAdapter.h:172) maps onto:

  map_raw()    -> per-row addends from raw inputs    (addRawInput)
  states       -> the intermediate layout            (accumulator)
  combine ops  -> merging intermediates              (addIntermediateResults)
  extract()    -> final result from state columns    (extractValues)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue


@dataclass(frozen=True)
class StateSpec:
    suffix: str           # physical column suffix, e.g. "sum", "count"
    dtype: T.DataType     # device dtype of the state column
    combine: str          # 'sum' | 'min' | 'max'
    width: int = 1        # >1: per-group state VECTOR (e.g. HLL registers)

    def identity(self):
        """Identity element for masked-out rows."""
        np_dt = self.dtype.np_dtype()
        if self.combine == "sum":
            return np.zeros((), np_dt)
        if self.combine == "min":
            return (np.array(np.inf, np_dt) if self.dtype.is_floating
                    else np.iinfo(np_dt).max)
        if self.combine == "max":
            return (np.array(-np.inf, np_dt) if self.dtype.is_floating
                    else np.iinfo(np_dt).min)
        raise ValueError(self.combine)


class AggregateFunction:
    """One resolved aggregate (name + input types)."""

    name: str
    states: Tuple[StateSpec, ...]
    result_type: T.DataType

    @property
    def intermediate_type(self) -> T.DataType:
        if len(self.states) == 1:
            return self.states[0].dtype
        return T.row([s.suffix for s in self.states],
                     [s.dtype for s in self.states])

    def map_raw(self, ctx, args: List[EvalValue], active) -> List:
        """Per-row addend arrays (one per state) from raw inputs; rows where
        `active` is False (or input null) must contribute the identity."""
        raise NotImplementedError

    def extract(self, state_arrays: List, group_valid) -> EvalValue:
        """Final result from dense per-group state columns."""
        raise NotImplementedError


def _masked(data, keep, identity):
    return jnp.where(keep, data, identity)


def _valid_and_active(v: EvalValue, active, capacity):
    keep = active
    if v.validity is not None:
        keep = keep & v.full_validity(capacity)
    return keep


# ---------------------------------------------------------------------------

class SumAgg(AggregateFunction):
    def __init__(self, input_type: T.DataType):
        self.name = "sum"
        # EVERY decimal sum returns DECIMAL(38, s) over int128 limb
        # states (parity: Presto sum(decimal) -> decimal(38, s),
        # DecimalSumAggregate over int128). Short-decimal inputs used to
        # keep an int64 state with the INPUT precision declared — at
        # SF10 Q1's sum_charge has 19 digits, overflowing the declared
        # precision (and eventually int64 itself).
        self._long = input_type.kind is T.TypeKind.DECIMAL
        self._two_part = self._long and not input_type.is_long_decimal
        if self._two_part:
            # short-decimal input: TWO planar parts (v & M32 >= 0 and
            # the signed v >> 32) recombine to int128 at extraction
            # (ops/int128.py combine_two_parts) — half the limb states
            # of the long-decimal form
            self.input_type = input_type
            self.result_type = T.decimal(38, input_type.scale)
            self.states = (StateSpec("slo", T.BIGINT, "sum"),
                           StateSpec("shi", T.BIGINT, "sum"),
                           StateSpec("count", T.BIGINT, "sum"))
            return
        if self._long:
            # long decimal: four planar 32-bit limb parts accumulate in
            # independent int64 sums and recombine at extraction
            # (ops/int128.py split_parts/combine_parts; parity:
            # DecimalSumAggregate over int128, type/DecimalUtil.h)
            st = T.decimal(38, input_type.scale)
            self.input_type = input_type
            self.result_type = st
            self.states = tuple(
                StateSpec(f"p{i}", T.BIGINT, "sum") for i in range(4)
            ) + (StateSpec("count", T.BIGINT, "sum"),)
            return
        if input_type.is_integral:
            st = T.BIGINT
        elif input_type.kind is T.TypeKind.DECIMAL:
            st = T.decimal(18, input_type.scale)
        elif input_type.kind is T.TypeKind.REAL:
            st = T.DOUBLE
        else:
            st = T.DOUBLE
        self.input_type = input_type
        self.result_type = st
        self.states = (StateSpec("sum", st, "sum"),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        data = v.full_data(ctx.capacity)
        if self._two_part:
            lo = data.astype(jnp.int64)
            p_lo = lo & jnp.int64(0xFFFFFFFF)
            p_hi = lo >> jnp.int64(32)  # arithmetic: keeps the sign
            return [_masked(p_lo, keep, 0), _masked(p_hi, keep, 0),
                    keep.astype(np.int64)]
        if self._long:
            from velox_tpu.ops.int128 import split_parts
            lo = data.astype(jnp.int64)
            if v.dtype.is_long_decimal and v.children:
                hi = v.children[0].data
                if hi.ndim == 0:
                    hi = jnp.broadcast_to(hi, lo.shape)
            else:
                hi = lo >> jnp.int64(63)  # short decimal: sign extension
            parts = split_parts(lo, hi)
            return [_masked(p, keep, 0) for p in parts] \
                + [keep.astype(np.int64)]
        if v.dtype.kind is T.TypeKind.DECIMAL:
            from velox_tpu.functions.scalar import _rescale_decimal
            data = _rescale_decimal(
                data, v.dtype.scale, self.result_type.scale)
        # widen to the state dtype: decimal columns may be stored narrow
        # (int32) but sums accumulate in int64
        data = data.astype(self.result_type.np_dtype())
        return [_masked(data, keep, 0),
                keep.astype(np.int64)]

    def extract(self, state_arrays, group_valid):
        if self._two_part:
            from velox_tpu.ops.int128 import combine_two_parts
            from velox_tpu.vector.device import DeviceColumn
            s_lo, s_hi, c = state_arrays
            lo, hi = combine_two_parts(s_lo, s_hi)
            hi_col = DeviceColumn(hi, None, T.BIGINT, None)
            return EvalValue(lo, group_valid & (c > 0),
                             self.result_type, children=(hi_col,))
        if self._long:
            from velox_tpu.ops.int128 import combine_parts
            from velox_tpu.vector.device import DeviceColumn
            p0, p1, p2, p3, c = state_arrays
            lo, hi = combine_parts(p0, p1, p2, p3)
            hi_col = DeviceColumn(hi, None, T.BIGINT, None)
            return EvalValue(lo, group_valid & (c > 0),
                             self.result_type, children=(hi_col,))
        s, c = state_arrays
        return EvalValue(s, group_valid & (c > 0), self.result_type)


class CountAgg(AggregateFunction):
    def __init__(self, input_type: Optional[T.DataType]):
        self.name = "count"
        self.input_type = input_type  # None => count(*)
        self.result_type = T.BIGINT
        self.states = (StateSpec("count", T.BIGINT, "sum"),)

    def map_raw(self, ctx, args, active):
        if not args:
            keep = active
        else:
            keep = _valid_and_active(args[0], active, ctx.capacity)
        return [keep.astype(np.int64)]

    def extract(self, state_arrays, group_valid):
        (c,) = state_arrays
        # count over an empty/all-null group is 0, never null.
        c = jnp.where(group_valid, c, 0)
        return EvalValue(c, None, T.BIGINT)


class AvgAgg(AggregateFunction):
    def __init__(self, input_type: T.DataType):
        self.name = "avg"
        self._long = input_type.is_long_decimal
        self._two_part = (input_type.kind is T.TypeKind.DECIMAL
                          and not input_type.is_long_decimal)
        if self._two_part:
            # short-decimal avg: the internal SUM runs at int128 (two
            # planar parts — the int64 sum state overflowed at scale),
            # divided half-up by the count at extraction; the quotient
            # fits the input type (avg <= max input). Parity:
            # DecimalAverageAggregate (sum at 38 digits).
            self.input_type = input_type
            self.result_type = input_type
            self.states = (StateSpec("slo", T.BIGINT, "sum"),
                           StateSpec("shi", T.BIGINT, "sum"),
                           StateSpec("count", T.BIGINT, "sum"))
            return
        if self._long:
            # long decimal: planar limb sums (as SumAgg) + exact int128
            # half-up division by count at extraction (ops/int128.py
            # div128_round_half_up; parity: DecimalAvgAggregate +
            # type/DecimalUtil.h divideWithRoundUp)
            self.input_type = input_type
            self.result_type = input_type
            self.states = tuple(
                StateSpec(f"p{i}", T.BIGINT, "sum") for i in range(4)
            ) + (StateSpec("count", T.BIGINT, "sum"),)
            return
        self.input_type = input_type
        if input_type.kind is T.TypeKind.DECIMAL:
            sum_t = T.decimal(18, input_type.scale)
            self.result_type = input_type
        else:
            sum_t = T.DOUBLE
            self.result_type = T.DOUBLE
        self.states = (StateSpec("sum", sum_t, "sum"),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        data = v.full_data(ctx.capacity)
        if self._two_part:
            lo = data.astype(jnp.int64)
            p_lo = lo & jnp.int64(0xFFFFFFFF)
            p_hi = lo >> jnp.int64(32)  # arithmetic: keeps the sign
            return [_masked(p_lo, keep, 0), _masked(p_hi, keep, 0),
                    keep.astype(np.int64)]
        if self._long:
            from velox_tpu.ops.int128 import split_parts
            lo = data.astype(jnp.int64)
            if v.dtype.is_long_decimal and v.children:
                hi = v.children[0].data
                if hi.ndim == 0:
                    hi = jnp.broadcast_to(hi, lo.shape)
            else:
                hi = lo >> jnp.int64(63)  # short decimal: sign extension
            parts = split_parts(lo, hi)
            return [_masked(p, keep, 0) for p in parts] \
                + [keep.astype(np.int64)]
        st = self.states[0].dtype
        if v.dtype.kind is T.TypeKind.DECIMAL:
            from velox_tpu.functions.scalar import _rescale_decimal
            data = _rescale_decimal(data, v.dtype.scale, st.scale)
        data = data.astype(st.np_dtype())
        return [_masked(data, keep, 0), keep.astype(np.int64)]

    def extract(self, state_arrays, group_valid):
        if self._two_part:
            from velox_tpu.ops.int128 import (
                combine_two_parts, div128_round_half_up,
            )
            s_lo, s_hi, c = state_arrays
            lo, hi = combine_two_parts(s_lo, s_hi)
            qlo, _ = div128_round_half_up(lo, hi, jnp.maximum(c, 1))
            return EvalValue(qlo, group_valid & (c > 0),
                             self.result_type)
        if self._long:
            from velox_tpu.ops.int128 import (
                combine_parts, div128_round_half_up,
            )
            from velox_tpu.vector.device import DeviceColumn
            p0, p1, p2, p3, c = state_arrays
            lo, hi = combine_parts(p0, p1, p2, p3)
            qlo, qhi = div128_round_half_up(lo, hi, jnp.maximum(c, 1))
            hi_col = DeviceColumn(qhi, None, T.BIGINT, None)
            return EvalValue(qlo, group_valid & (c > 0),
                             self.result_type, children=(hi_col,))
        s, c = state_arrays
        valid = group_valid & (c > 0)
        c_safe = jnp.maximum(c, 1)
        if self.result_type.kind is T.TypeKind.DECIMAL:
            # decimal avg: half-up rounded division at the same scale
            half = c_safe // 2
            q = jnp.where(s >= 0, (s + half) // c_safe,
                          -((-s + half) // c_safe))
            return EvalValue(q, valid, self.result_type)
        return EvalValue(s / c_safe, valid, T.DOUBLE)


class MinMaxAgg(AggregateFunction):
    def __init__(self, name: str, input_type: T.DataType):
        self.name = name
        if input_type.is_long_decimal:
            raise NotImplementedError(
                f"{name} over DECIMAL(>18) rides the collect pathway "
                "(resolve_aggregate routes it to CollectMinMaxByAgg)")
        self.input_type = input_type
        self.result_type = input_type
        self.states = (StateSpec(name, input_type, name),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        ident = self.states[0].identity()
        data = v.full_data(ctx.capacity)
        return [_masked(data, keep, ident), keep.astype(np.int64)]

    def extract(self, state_arrays, group_valid):
        m, c = state_arrays
        out = EvalValue(m, group_valid & (c > 0), self.result_type)
        # carry dictionary through for string min/max (ids order-preserving
        # only if dictionary sorted; enforced by the planner)
        return out


class CountIfAgg(AggregateFunction):
    """Parity: functions/prestosql/aggregates/CountIfAggregate.cpp."""

    def __init__(self):
        self.name = "count_if"
        self.result_type = T.BIGINT
        self.states = (StateSpec("count", T.BIGINT, "sum"),)

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        keep = keep & v.full_data(ctx.capacity).astype(bool)
        return [keep.astype(np.int64)]

    def extract(self, state_arrays, group_valid):
        (c,) = state_arrays
        return EvalValue(jnp.where(group_valid, c, 0), None, T.BIGINT)


class BoolAgg(AggregateFunction):
    """bool_and / bool_or (aka every). Parity: prestosql BoolAnd/OrAggregate."""

    def __init__(self, name: str):
        self.name = name
        self.result_type = T.BOOLEAN
        combine = "min" if name == "bool_and" else "max"
        self.states = (StateSpec("b", T.INTEGER, combine),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        b = v.full_data(ctx.capacity).astype(jnp.int32)
        ident = self.states[0].identity()
        return [_masked(b, keep, ident), keep.astype(np.int64)]

    def extract(self, state_arrays, group_valid):
        b, c = state_arrays
        return EvalValue(b.astype(bool), group_valid & (c > 0), T.BOOLEAN)


class VarianceAgg(AggregateFunction):
    """variance/var_samp/var_pop/stddev/stddev_samp/stddev_pop.
    Parity: functions/prestosql/aggregates/VarianceAggregates.cpp
    (count/mean/m2 accumulator folded to count/sum/sumsq here)."""

    def __init__(self, name: str, input_type: T.DataType):
        self.name = name
        self.input_type = input_type
        self.result_type = T.DOUBLE
        self.states = (StateSpec("n", T.BIGINT, "sum"),
                       StateSpec("sum", T.DOUBLE, "sum"),
                       StateSpec("sumsq", T.DOUBLE, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        data = v.full_data(ctx.capacity)
        if v.dtype.kind is T.TypeKind.DECIMAL:
            data = data.astype(np.float64) / (10.0 ** v.dtype.scale)
        else:
            data = data.astype(np.float64)
        data = jnp.where(keep, data, 0.0)
        return [keep.astype(np.int64), data, data * data]

    def extract(self, state_arrays, group_valid):
        n, s, ss = state_arrays
        pop = self.name.endswith("_pop")
        nf = n.astype(np.float64)
        m2 = ss - s * s / jnp.maximum(nf, 1.0)
        denom = nf if pop else (nf - 1.0)
        out = m2 / jnp.maximum(denom, 1.0)
        out = jnp.maximum(out, 0.0)  # clamp fp negatives
        if self.name.startswith("stddev"):
            out = jnp.sqrt(out)
        min_n = 1 if pop else 2
        return EvalValue(out, group_valid & (n >= min_n), T.DOUBLE)


class CentralMomentsAgg(AggregateFunction):
    """skewness / kurtosis via raw power sums (n, sum x, x^2, x^3, x^4).

    Parity: functions/prestosql/aggregates/CentralMomentsAggregates.cpp
    (same result formulas; the reference carries central moments m2..m4
    directly, here they derive from segment-combinable power sums:
    m2 = s2 - s1^2/n, m3 = s3 - 3 s2 s1/n + 2 s1^3/n^2,
    m4 = s4 - 4 s3 s1/n + 6 s2 s1^2/n^2 - 3 s1^4/n^3). Also registered
    for the Spark package (sparksql shares the implementations)."""

    def __init__(self, name: str, input_type: T.DataType):
        self.name = name
        self.input_type = input_type
        self.result_type = T.DOUBLE
        self.states = (StateSpec("n", T.BIGINT, "sum"),
                       StateSpec("s1", T.DOUBLE, "sum"),
                       StateSpec("s2", T.DOUBLE, "sum"),
                       StateSpec("s3", T.DOUBLE, "sum"),
                       StateSpec("s4", T.DOUBLE, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        data = v.full_data(ctx.capacity)
        if v.dtype.kind is T.TypeKind.DECIMAL:
            data = data.astype(np.float64) / (10.0 ** v.dtype.scale)
        else:
            data = data.astype(np.float64)
        x = jnp.where(keep, data, 0.0)
        x2 = x * x
        return [keep.astype(np.int64), x, x2, x2 * x, x2 * x2]

    def extract(self, state_arrays, group_valid):
        n, s1, s2, s3, s4 = state_arrays
        nf = jnp.maximum(n.astype(np.float64), 1.0)
        m2 = s2 - s1 * s1 / nf
        m2 = jnp.maximum(m2, 0.0)
        if self.name == "skewness":
            m3 = s3 - 3.0 * s2 * s1 / nf + 2.0 * s1 ** 3 / (nf * nf)
            out = jnp.sqrt(nf) * m3 / jnp.maximum(m2, 1e-300) ** 1.5
            # hasResult (CentralMomentsAggregates.cpp) + zero-variance
            # groups are NULL, not 0/0 = NaN
            ok = (n >= 3) & (m2 > 0.0)
        else:  # kurtosis (sample excess, reference formula)
            m4 = (s4 - 4.0 * s3 * s1 / nf + 6.0 * s2 * s1 * s1 / (nf * nf)
                  - 3.0 * s1 ** 4 / (nf ** 3))
            c = nf
            denom = jnp.maximum((c - 2.0) * (c - 3.0), 1.0)
            out = ((c - 1.0) * c * (c + 1.0)) / denom \
                * m4 / jnp.maximum(m2 * m2, 1e-300) \
                - 3.0 * (c - 1.0) * (c - 1.0) / denom
            ok = (n >= 4) & (m2 > 0.0)
        return EvalValue(out, group_valid & ok, T.DOUBLE)


_PACKABLE_32 = (T.TypeKind.BOOLEAN, T.TypeKind.TINYINT, T.TypeKind.SMALLINT,
                T.TypeKind.INTEGER, T.TypeKind.DATE, T.TypeKind.VARCHAR,
                T.TypeKind.VARBINARY, T.TypeKind.REAL)


def _pack32(v: EvalValue, capacity: int):
    """Order-preserving biased-u32 (as int64) for 32-bit-representable
    types; None if not packable."""
    from velox_tpu.exec.sort import value_words
    if v.dtype.kind not in _PACKABLE_32:
        return None
    (w,) = value_words(v, capacity)
    return w.astype(jnp.int64)  # 0..2^32-1


class MinMaxByAgg(AggregateFunction):
    """min_by(x, y) / max_by(x, y) for 32-bit-packable x and y: the pair
    (y, x) packs into one int64 so the existing min/max segment combine is
    an exact argmin/argmax. Parity: prestosql MinMaxByAggregates.cpp."""

    def __init__(self, name: str, x_type: T.DataType, y_type: T.DataType):
        self.name = name
        self.x_type, self.y_type = x_type, y_type
        if x_type.kind not in _PACKABLE_32 \
                or y_type.kind not in _PACKABLE_32:
            raise NotImplementedError(
                f"{name} over ({x_type}, {y_type}): only 32-bit-packable "
                "types supported (int32 and smaller, date, real, strings)")
        self.result_type = x_type
        combine = "min" if name == "min_by" else "max"
        self.states = (StateSpec("pair", T.BIGINT, combine),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        if getattr(self, "position_ordered", False):
            # first/last: the ordering key is the within-batch position
            (x,) = args
            cap = ctx.capacity
            y = EvalValue(jnp.arange(cap, dtype=jnp.int32), None,
                          T.INTEGER)
        else:
            x, y = args
        cap = ctx.capacity
        keep = _valid_and_active(y, active, cap)
        keep = keep & (jnp.ones((cap,), bool) if x.validity is None
                       else x.full_validity(cap))
        xp = _pack32(x, cap)
        yp = _pack32(y, cap)
        if self.name == "max_by":
            xp = (1 << 32) - 1 - xp  # tie-break: smaller x on max packs
        # bias y into [-2^31, 2^31) so the shifted pair spans int64 without
        # overflow; (hi << 32) | lo is monotone in (hi, lo)
        pair = ((yp - (1 << 31)) << 32) | xp
        ident = self.states[0].identity()
        return [_masked(pair, keep, ident), keep.astype(np.int64)]

    def extract(self, state_arrays, group_valid):
        from velox_tpu.exec.sort import value_words  # noqa: F401
        pair, c = state_arrays
        xp = pair & 0xFFFFFFFF
        if self.name == "max_by":
            xp = (1 << 32) - 1 - xp
        data = _unpack32(xp, self.x_type)
        return EvalValue(data, group_valid & (c > 0), self.x_type)


def _unpack32(u, dtype: T.DataType):
    """Invert the order-preserving u32 word back to the native value."""
    import jax
    u = u.astype(jnp.uint32)
    if dtype.kind is T.TypeKind.REAL:
        sign = (u & np.uint32(0x80000000)) != 0
        bits = jnp.where(sign, u ^ np.uint32(0x80000000), ~u)
        return jax.lax.bitcast_convert_type(
            bits.astype(jnp.uint32), jnp.float32)
    if dtype.kind is T.TypeKind.BOOLEAN:
        return u.astype(bool)
    i = jax.lax.bitcast_convert_type(
        u ^ np.uint32(0x80000000), jnp.int32)
    return i.astype(dtype.np_dtype())


class ApproxDistinctAgg(AggregateFunction):
    """approx_distinct via HyperLogLog register vectors.

    Parity: functions/prestosql/aggregates (HLL over common/hyperloglog).
    The per-group state is a WIDTH-register int32 vector state
    column combined with segment_max; per-row addends are the one-hot
    (row, register) rho contributions, fused by XLA into the segment
    reduce. Default 512 registers (~4.6% standard error); a second
    argument sets the target max standard error like Presto's
    approx_distinct(x, e) (registers = (1.04/e)^2 rounded to a power of
    two, capped at 4096)."""

    def __init__(self, input_type: T.DataType, max_error: float = 0.046):
        self.name = "approx_distinct"
        self.input_type = input_type
        self.result_type = T.BIGINT
        m = int((1.04 / max_error) ** 2)
        m = max(16, min(4096, 1 << (m - 1).bit_length()))
        self.m = m
        self.p = m.bit_length() - 1
        self.states = (StateSpec("hll", T.INTEGER, "max", width=m),)

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        from velox_tpu.exec.hashtable import hash_rows
        h = hash_rows([v], ctx.capacity)  # uint32
        reg = (h & np.uint32(self.m - 1)).astype(jnp.int32)
        w = (h >> np.uint32(self.p)).astype(jnp.int32)
        # rho = leading zeros of w within (32-p) bits, + 1
        bits = 32 - self.p
        wl = jnp.where(w > 0,
                       jnp.floor(jnp.log2(jnp.maximum(
                           w, 1).astype(jnp.float32))).astype(jnp.int32)
                       + 1, 0)
        rho = bits - wl + 1
        onehot = (jnp.arange(self.m, dtype=jnp.int32)[None, :]
                  == reg[:, None])
        addend = jnp.where(onehot & keep[:, None], rho[:, None], 0) \
            .astype(jnp.int32)
        return [addend]

    def extract(self, state_arrays, group_valid):
        (regs,) = state_arrays  # (groups, m) int32
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        rf = regs.astype(jnp.float64)
        est = alpha * m * m / jnp.sum(jnp.exp2(-rf), axis=1)
        zeros = jnp.sum((regs == 0).astype(jnp.float64), axis=1)
        # linear counting small-range correction
        lin = m * jnp.log(m / jnp.maximum(zeros, 1.0))
        out = jnp.where((est <= 2.5 * m) & (zeros > 0), lin, est)
        return EvalValue(jnp.round(out).astype(jnp.int64), group_valid,
                         T.BIGINT)


# ---------------------------------------------------------------------------
# Collect-style aggregates: results are per-group COLLECTIONS (or
# order-statistics) rather than segment-combinable scalars. They have no
# StateSpec states; the aggregation operator runs them through the
# sort-based collect pathway (exec/aggregation.py): rows sorted by
# (group keys [+ value]) and elements emitted by prefix compaction of the
# sorted runs. Parity: prestosql ArrayAggAggregate.cpp / SetAggAggregate /
# MapAggAggregate / HistogramAggregate / ApproxPercentileAggregate — but
# approx_percentile here is EXACT (rank over the sorted run), which
# trivially satisfies any approximation bound.
# ---------------------------------------------------------------------------


class CollectAgg(AggregateFunction):
    states: Tuple[StateSpec, ...] = ()
    collect_kind: str = ""
    # True: this aggregate's collect sort appends its value words (set_agg /
    # map_agg / histogram / approx_percentile); False: skeleton (input)
    # order (array_agg)
    value_sorted = True


class ArrayAgg(CollectAgg):
    collect_kind = "array_agg"
    value_sorted = False

    def __init__(self, input_type: T.DataType):
        self.name = "array_agg"
        self.input_type = input_type
        self.result_type = T.array(input_type)


class SetAgg(CollectAgg):
    collect_kind = "set_agg"

    def __init__(self, input_type: T.DataType):
        self.name = "set_agg"
        self.input_type = input_type
        self.result_type = T.array(input_type)


class MapAgg(CollectAgg):
    collect_kind = "map_agg"

    def __init__(self, key_type: T.DataType, value_type: T.DataType):
        self.name = "map_agg"
        self.input_type = key_type
        self.value_type = value_type
        self.result_type = T.map_(key_type, value_type)


class MultimapAgg(CollectAgg):
    """multimap_agg(K, V) -> map(K, array(V)): all values per key.
    Parity: prestosql/aggregates/MultimapAggAggregates.cpp."""
    collect_kind = "multimap_agg"

    def __init__(self, key_type: T.DataType, value_type: T.DataType):
        self.name = "multimap_agg"
        self.input_type = key_type
        self.value_type = value_type
        self.result_type = T.map_(key_type, T.array(value_type))


class MapUnionAgg(CollectAgg):
    """map_union(m): marker only — the Task rewrites the plan to
    Unnest + map_agg (exec/task.py _rewrite_map_union; ref prestosql
    MapUnionAggregate.cpp)."""
    collect_kind = "map_union"

    def __init__(self, map_type: T.DataType):
        self.name = "map_union"
        self.input_type = map_type
        self.result_type = map_type


class ModeAgg(CollectAgg):
    """mode(x): the most frequent non-null value per group (ties ->
    smallest value). Parity: Spark Mode / Presto mode — realized on the
    approx_most_frequent two-pass run-count machinery
    (exec/aggregation.py _collect_result kind 'mode')."""
    collect_kind = "mode"

    def __init__(self, input_type: T.DataType):
        self.name = "mode"
        self.input_type = input_type
        self.result_type = input_type


class BloomFilterAgg(CollectAgg):
    """bloom_filter_agg(x[, estimatedNumItems[, numBits]]): a bloom
    sketch over the non-null inputs, k=3 double-hashed probes.

    Parity target: sparksql BloomFilterAggAggregate.h + MightContain.h.
    Deviation: the sketch type is ARRAY(INTEGER) of packed 32-bit words
    (this engine's VARBINARY values are trace-time dictionaries, which
    cannot hold data-dependent bytes); might_contain consumes the same
    layout on-device. GLOBAL aggregation only (the Spark usage: a scalar
    subquery over the build side)."""
    collect_kind = "bloom"
    K = 3

    def __init__(self, input_type: T.DataType):
        self.name = "bloom_filter_agg"
        self.input_type = input_type
        self.result_type = T.array(T.INTEGER)
        self.num_bits = 1 << 20  # operator overrides from const args


class HistogramAgg(CollectAgg):
    collect_kind = "histogram"

    def __init__(self, input_type: T.DataType):
        self.name = "histogram"
        self.input_type = input_type
        self.result_type = T.map_(input_type, T.BIGINT)


class ApproxMostFrequentAgg(CollectAgg):
    """approx_most_frequent(buckets, value, capacity) — EXACT top-b
    values by count per group (trivially within the approximation bound;
    ref prestosql ApproxMostFrequentAggregates.cpp). Collect pathway:
    one (group, value) sort for run counts, one (group, -count, value)
    re-sort for the per-group top-b selection."""
    collect_kind = "approx_most_frequent"

    def __init__(self, input_type: T.DataType):
        self.name = "approx_most_frequent"
        self.input_type = input_type
        self.result_type = T.map_(input_type, T.BIGINT)
        self.buckets = 3  # operator injects the constant argument


class CollectMinMaxByAgg(CollectAgg):
    """min_by/max_by for types beyond the 32-bit pair-packing fast path
    (BIGINT/DOUBLE/TIMESTAMP/DECIMAL arguments): rides the sort-based
    collect pathway — rows sorted by (group, y), the first/last passing
    row's x is the answer. Single-step only (collect limitation);
    32-bit-packable argument pairs keep the segment-combinable MinMaxByAgg.
    Parity: prestosql/aggregates/MinMaxByAggregates.cpp."""

    def __init__(self, name: str, x_type: T.DataType, y_type: T.DataType):
        self.name = name
        # "min"/"max" over long decimals route here with x == y
        # (single-argument calls; the operator reuses the one input for
        # both roles)
        self.collect_kind = name if name.endswith("_by") else name + "_by"
        self.input_type = x_type
        self.y_type = y_type
        self.result_type = x_type


class ApproxPercentileAgg(CollectAgg):
    """approx_percentile(x, p): exact rank-based percentile over the
    value-sorted group run (rank = ceil(p*n), 1-based lower value) for
    SINGLE-step plans; PARTIAL/FINAL split via the mergeable
    quantile-knot summary (exec/aggregation.py _pct_compress — the KLL
    analogue, ref functions/lib/KllSketch.h)."""
    collect_kind = "approx_percentile"

    def __init__(self, input_type: T.DataType):
        self.name = "approx_percentile"
        self.input_type = input_type
        self.result_type = input_type
        self.percentile = 0.5  # operator injects the constant argument

    @property
    def intermediate_type(self) -> T.DataType:
        # physical layout: two columns "<name>$v" / "<name>$w" (weighted
        # quantile knots), mirroring multi-state scalar aggregates
        return T.row(["v", "w"], [self.input_type, T.BIGINT])


def resolve_aggregate(name: str, input_types) -> AggregateFunction:
    name = name.lower()
    if name == "sum":
        return SumAgg(input_types[0])
    if name == "count":
        return CountAgg(input_types[0] if input_types else None)
    if name == "avg":
        return AvgAgg(input_types[0])
    if name in ("min", "max"):
        if input_types[0].is_long_decimal:
            return CollectMinMaxByAgg(name, input_types[0],
                                      input_types[0])
        return MinMaxAgg(name, input_types[0])
    if name == "arbitrary" or name == "any_value":
        agg = MinMaxAgg("min", input_types[0])
        agg.name = name
        return agg
    if name == "count_if":
        return CountIfAgg()
    if name in ("bool_and", "every"):
        return BoolAgg("bool_and")
    if name == "bool_or":
        return BoolAgg("bool_or")
    if name in ("variance", "var_samp", "var_pop",
                "stddev", "stddev_samp", "stddev_pop"):
        canon = {"variance": "var_samp", "stddev": "stddev_samp"}.get(
            name, name)
        return VarianceAgg(canon, input_types[0])
    if name in ("skewness", "kurtosis"):
        return CentralMomentsAgg(name, input_types[0])
    if name in ("first", "first_value", "last", "last_value") \
            and len(input_types) == 1:
        # Spark first/last: non-deterministic without an explicit order
        # ("depends on the order of the rows", Spark docs) — realized as
        # min_by/max_by over the within-batch row position, null inputs
        # skipped (ignoreNulls semantics)
        if input_types[0].kind not in _PACKABLE_32:
            # wider types: any value is a conforming result (the Spark
            # contract is explicitly non-deterministic without an order);
            # min/max keeps the result deterministic per data set
            if input_types[0].is_long_decimal:
                agg = CollectMinMaxByAgg(
                    "min" if name.startswith("first") else "max",
                    input_types[0], input_types[0])
            else:
                agg = MinMaxAgg(
                    "min" if name.startswith("first") else "max",
                    input_types[0])
            agg.agg_name = name
            return agg
        agg = MinMaxByAgg(
            "min_by" if name.startswith("first") else "max_by",
            input_types[0], T.INTEGER)
        agg.agg_name = name
        agg.position_ordered = True
        return agg
    if name in ("min_by", "max_by"):
        if (input_types[0].kind in _PACKABLE_32
                and input_types[1].kind in _PACKABLE_32):
            return MinMaxByAgg(name, input_types[0], input_types[1])
        return CollectMinMaxByAgg(name, input_types[0], input_types[1])
    if name == "approx_distinct":
        return ApproxDistinctAgg(input_types[0])
    if name == "array_agg":
        return ArrayAgg(input_types[0])
    if name == "set_agg":
        return SetAgg(input_types[0])
    if name == "map_agg":
        return MapAgg(input_types[0], input_types[1])
    if name == "multimap_agg":
        return MultimapAgg(input_types[0], input_types[1])
    if name == "map_union":
        return MapUnionAgg(input_types[0])
    if name == "mode":
        return ModeAgg(input_types[0])
    if name == "bloom_filter_agg":
        return BloomFilterAgg(input_types[0])
    if name == "histogram":
        return HistogramAgg(input_types[0])
    if name == "approx_percentile":
        return ApproxPercentileAgg(input_types[0])
    if name == "approx_most_frequent":
        return ApproxMostFrequentAgg(input_types[1])
    raise KeyError(f"unknown aggregate function {name!r}")
