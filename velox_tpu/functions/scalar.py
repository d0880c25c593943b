"""Presto-semantics scalar function package.

Role parity: ``velox/functions/prestosql`` (the subset needed by TPC-H plus
general-purpose arithmetic/comparison/string/date functions; the package
grows breadth-first). Each function is a traced JAX computation over dense
device arrays; strings operate in dictionary-id space with host-side (trace
time) dictionary transforms — the structural analogue of Velox's dictionary
memoization (velox/expression/Expr.cpp:1091).

Null semantics: default null propagation (result null if any input null) is
applied here via merge_validity; Kleene and/or live in expression/eval.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import (
    EvalValue, merge_validity, _align_strings,
)
from velox_tpu.functions.registry import register
from velox_tpu.vector.device import Dictionary


# ---------------------------------------------------------------------------
# Type promotion
# ---------------------------------------------------------------------------

_INT_ORDER = [T.TypeKind.TINYINT, T.TypeKind.SMALLINT, T.TypeKind.INTEGER,
              T.TypeKind.BIGINT]


def promote_numeric(a: T.DataType, b: T.DataType) -> T.DataType:
    if a == b:
        return a
    if a.kind is T.TypeKind.DOUBLE or b.kind is T.TypeKind.DOUBLE:
        return T.DOUBLE
    if a.kind is T.TypeKind.REAL or b.kind is T.TypeKind.REAL:
        # real + int -> real; real + decimal -> double
        other = b if a.kind is T.TypeKind.REAL else a
        return T.DOUBLE if other.kind is T.TypeKind.DECIMAL else T.REAL
    if a.kind is T.TypeKind.DECIMAL or b.kind is T.TypeKind.DECIMAL:
        da = a if a.kind is T.TypeKind.DECIMAL else T.decimal(18, 0)
        db = b if b.kind is T.TypeKind.DECIMAL else T.decimal(18, 0)
        s = max(da.scale, db.scale)
        if da.is_long_decimal or db.is_long_decimal:
            # long inputs: Presto result type (max integer digits +
            # common scale + carry, capped 38; ref type/DecimalUtil.h),
            # computed on int128 limbs (ops/int128.py)
            idig = max(da.precision - da.scale, db.precision - db.scale)
            return T.decimal(min(38, idig + s + 1), s)
        # short inputs stay on the int64 fast path: result capped at
        # DECIMAL(18) (documented deviation — Presto would widen; at
        # TPC-H value ranges 18 digits are exact, and implicit widening
        # to limb math would put every money expression on the slow path)
        return T.decimal(18, s)
    # integer widths
    ia, ib = _INT_ORDER.index(a.kind), _INT_ORDER.index(b.kind)
    return a if ia >= ib else b


def _rescale_decimal(data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    return data // (10 ** (from_scale - to_scale))


def _numeric_data(v: EvalValue, target: T.DataType, ctx):
    """Convert EvalValue data to the computation dtype of `target`."""
    data = v.data
    if v.dtype.is_long_decimal:
        if target.is_floating:
            # approximate: hi*2^64 + unsigned(lo), then unscale
            lo = jax.lax.bitcast_convert_type(
                data.astype(jnp.int64), jnp.uint64)
            f = (v.children[0].data.astype(jnp.float64) * (2.0 ** 64)
                 + lo.astype(jnp.float64))
            return (f / (10.0 ** v.dtype.scale)).astype(
                target.np_dtype())
        raise NotImplementedError(
            f"long decimal {v.dtype} in a {target} context is not "
            "supported (limb paths exist for +,-,*,compare,sum,cast-to-"
            "double)")
    if v.dtype.kind is T.TypeKind.DECIMAL:
        if target.kind is T.TypeKind.DECIMAL:
            if target.is_long_decimal:
                raise NotImplementedError(
                    "short->long decimal conversion happens in the limb "
                    "operators, not _numeric_data")
            return _rescale_decimal(data, v.dtype.scale, target.scale)
        return data.astype(target.np_dtype()) / (10.0 ** v.dtype.scale)
    if target.kind is T.TypeKind.DECIMAL:
        return data.astype(np.int64) * (10 ** target.scale)
    return data.astype(target.np_dtype())


# ---------------------------------------------------------------------------
# Resolvers
# ---------------------------------------------------------------------------

def _all_numeric(arg_types):
    return all(t.is_numeric for t in arg_types)


def arith_resolver(name):
    def resolver(arg_types):
        if len(arg_types) != 2 or not _all_numeric(arg_types):
            return None
        a, b = arg_types
        if name in ("plus", "minus", "multiply") and a.is_integral \
                and b.is_integral:
            # Integer arithmetic computes and returns BIGINT. Departure
            # from Presto's width-preserving CHECKED ops (velox
            # functions/prestosql/Arithmetic.h): per-row overflow errors
            # would force a host sync per batch under dense masked
            # execution; 64-bit results avoid silent 32-bit wraparound.
            return T.BIGINT
        if name == "divide":
            if (a.kind is T.TypeKind.DECIMAL or b.kind is T.TypeKind.DECIMAL):
                return T.DOUBLE  # simplification: decimal division -> double
            if a.is_integral and b.is_integral:
                return promote_numeric(a, b)  # integer division
            return promote_numeric(a, b)
        if name == "multiply" and (a.kind is T.TypeKind.DECIMAL
                                   and b.kind is T.TypeKind.DECIMAL):
            if a.is_long_decimal or b.is_long_decimal:
                return T.decimal(min(38, a.precision + b.precision),
                                 a.scale + b.scale)
            # short x short stays int64 (see promote_numeric note)
            return T.decimal(min(18, a.precision + b.precision),
                             a.scale + b.scale)
        return promote_numeric(a, b)
    return resolver


def _cmp_resolver(arg_types):
    if len(arg_types) != 2:
        return None
    a, b = arg_types
    if a.is_numeric and b.is_numeric:
        return T.BOOLEAN
    ok_same = (a.kind == b.kind) or {a.kind, b.kind} <= {
        T.TypeKind.VARCHAR, T.TypeKind.VARBINARY}
    if ok_same and (a.is_string or a.kind in (
            T.TypeKind.DATE, T.TypeKind.TIMESTAMP, T.TypeKind.BOOLEAN)):
        return T.BOOLEAN
    if {a.kind, b.kind} <= {T.TypeKind.DATE, T.TypeKind.TIMESTAMP}:
        return T.BOOLEAN
    return None


def fixed(out: T.DataType, *kinds_ok):
    def resolver(arg_types):
        if kinds_ok and len(arg_types) != len(kinds_ok):
            return None
        for t, ok in zip(arg_types, kinds_ok):
            if callable(ok):
                if not ok(t):
                    return None
            elif t.kind is not ok:
                return None
        return out
    return resolver


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def _both_valid(a, b, ctx):
    v = merge_validity(a, b)
    if v is None:
        return jnp.ones((ctx.capacity,), bool)
    return jnp.broadcast_to(v, (ctx.capacity,))


def _flag(ctx, err, validity):
    """Flag checked-op failures on non-null lanes; result lanes go NULL
    (observable value semantics unchanged; the Task surfaces the count as
    VeloxUserError, common/errors.py)."""
    ctx.flag_error(err)
    return ~err if validity is None else (validity & ~err)


def _limbs(v: "EvalValue", to_scale: int, ctx):
    """EvalValue -> (lo, hi) int128 limbs rescaled to `to_scale`.
    Widens short decimals / integers first so upscale cannot wrap."""
    from velox_tpu.ops import int128 as I
    cap = ctx.capacity
    if v.dtype.is_long_decimal:
        lo = v.full_data(cap)
        hi = v.children[0].data if v.children else jnp.zeros_like(lo)
        if hi.ndim == 0:
            hi = jnp.broadcast_to(hi, lo.shape)
        s = v.dtype.scale
    else:
        s = v.dtype.scale if v.dtype.kind is T.TypeKind.DECIMAL else 0
        lo, hi = I.from_i64(v.full_data(cap).astype(jnp.int64))
    return I.rescale_up(lo, hi, to_scale - s)


def _long_value(lo, hi, validity, out_dtype) -> "EvalValue":
    from velox_tpu.vector.device import DeviceColumn
    hi_col = DeviceColumn(hi, None, T.BIGINT, None)
    return EvalValue(lo, validity, out_dtype, children=(hi_col,))


def _is_long(*vals) -> bool:
    return any(v.dtype.is_long_decimal for v in vals
               if hasattr(v.dtype, "is_long_decimal"))


def _binary_arith(op_name, op, checked=None):
    def eval_fn(ctx, out_dtype, args):
        a, b = args
        if out_dtype.is_long_decimal:
            from velox_tpu.ops import int128 as I
            alo, ahi = _limbs(a, out_dtype.scale, ctx)
            blo, bhi = _limbs(b, out_dtype.scale, ctx)
            f = I.add128 if op_name == "plus" else I.sub128
            lo, hi = f(alo, ahi, blo, bhi)
            return _long_value(lo, hi, merge_validity(a, b), out_dtype)
        da = _numeric_data(a, out_dtype, ctx)
        db = _numeric_data(b, out_dtype, ctx)
        data = op(da, db, out_dtype)
        validity = merge_validity(a, b)
        if checked is not None and out_dtype.is_integral:
            # checked integer arithmetic (Presto semantics: velox
            # prestosql Arithmetic.h checkedPlus/Minus/Multiply)
            err = checked(da, db, data) & _both_valid(a, b, ctx)
            validity = _flag(ctx, err, validity)
        return EvalValue(data, validity, out_dtype)
    register(op_name, arith_resolver(op_name), eval_fn)


def _ovf_plus(a, b, r):
    return ((a > 0) & (b > 0) & (r < 0)) | ((a < 0) & (b < 0) & (r >= 0))


def _ovf_minus(a, b, r):
    return ((a >= 0) & (b < 0) & (r < 0)) | ((a < 0) & (b > 0) & (r >= 0))


def _ovf_mul(a, b, r):
    i64min = jnp.iinfo(jnp.int64).min
    bad = (b != 0) & (r // jnp.where(b == 0, 1, b) != a)
    return bad | ((a == i64min) & (b == -1))


def _register_arith():
    _binary_arith("plus", lambda a, b, o: a + b, checked=_ovf_plus)
    _binary_arith("minus", lambda a, b, o: a - b, checked=_ovf_minus)

    def mul_eval(ctx, out_dtype, args):
        a, b = args
        if out_dtype.is_long_decimal:
            from velox_tpu.ops import int128 as I
            cap = ctx.capacity
            long_a = a.dtype.is_long_decimal
            long_b = b.dtype.is_long_decimal
            if long_a and long_b:
                raise NotImplementedError(
                    "decimal multiply with BOTH operands over 18 digits "
                    "overflows int128")
            big, small = (a, b) if long_a else (b, a)
            blo = big.full_data(cap)
            bhi = (big.children[0].data if big.children
                   else jnp.zeros_like(blo))
            if bhi.ndim == 0:
                bhi = jnp.broadcast_to(bhi, blo.shape)
            sd = small.full_data(cap).astype(jnp.int64)
            lo, hi = I.mul128_i64(blo, bhi, sd)
            ss = (small.dtype.scale
                  if small.dtype.kind is T.TypeKind.DECIMAL else 0)
            lo, hi = I.rescale_up(
                lo, hi, out_dtype.scale - big.dtype.scale - ss)
            return _long_value(lo, hi, merge_validity(a, b), out_dtype)
        if out_dtype.kind is T.TypeKind.DECIMAL:
            # Exact decimal multiply: scales add (resolver set out scale).
            da = a.data.astype(np.int64) if a.dtype.kind is T.TypeKind.DECIMAL \
                else _numeric_data(a, T.decimal(18, 0), ctx)
            db = b.data.astype(np.int64) if b.dtype.kind is T.TypeKind.DECIMAL \
                else _numeric_data(b, T.decimal(18, 0), ctx)
            sa = a.dtype.scale if a.dtype.kind is T.TypeKind.DECIMAL else 0
            sb = b.dtype.scale if b.dtype.kind is T.TypeKind.DECIMAL else 0
            data = _rescale_decimal(da * db, sa + sb, out_dtype.scale)
            return EvalValue(data, merge_validity(a, b), out_dtype)
        da = _numeric_data(a, out_dtype, ctx)
        db = _numeric_data(b, out_dtype, ctx)
        data = da * db
        validity = merge_validity(a, b)
        if out_dtype.is_integral:
            err = _ovf_mul(da, db, data) & _both_valid(a, b, ctx)
            validity = _flag(ctx, err, validity)
        return EvalValue(data, validity, out_dtype)
    register("multiply", arith_resolver("multiply"), mul_eval)

    def div_eval(ctx, out_dtype, args):
        a, b = args
        da = _numeric_data(a, out_dtype, ctx)
        db = _numeric_data(b, out_dtype, ctx)
        if out_dtype.is_integral:
            # SQL integer division truncates toward zero; /0 is a checked
            # error (Presto DIVISION_BY_ZERO), NULL until surfaced.
            db_safe = jnp.where(db == 0, jnp.ones_like(db), db)
            q = jnp.sign(da) * jnp.sign(db_safe) \
                * (jnp.abs(da) // jnp.abs(db_safe))
            data = q.astype(out_dtype.np_dtype())
            err = (db == 0) & _both_valid(a, b, ctx)
            validity = _flag(ctx, err, merge_validity(a, b))
            return EvalValue(data, validity, out_dtype)
        return EvalValue(da / db, merge_validity(a, b), out_dtype)
    register("divide", arith_resolver("divide"), div_eval)

    def mod_eval(ctx, out_dtype, args):
        a, b = args
        da = _numeric_data(a, out_dtype, ctx)
        db = _numeric_data(b, out_dtype, ctx)
        # SQL mod: sign follows dividend; %0 is a checked error.
        db_safe = jnp.where(db == 0, jnp.ones_like(db), db)
        data = jnp.sign(da) * (jnp.abs(da) % jnp.abs(db_safe))
        err = (db == 0) & _both_valid(a, b, ctx)
        validity = _flag(ctx, err, merge_validity(a, b))
        return EvalValue(data.astype(out_dtype.np_dtype()), validity,
                         out_dtype)
    register("mod", arith_resolver("mod"), mod_eval)

    def neg_eval(ctx, out_dtype, args):
        (a,) = args
        if out_dtype.is_long_decimal:
            from velox_tpu.ops import int128 as I
            lo, hi = _limbs(a, out_dtype.scale, ctx)
            nlo, nhi = I.neg128(lo, hi)
            return _long_value(nlo, nhi, a.validity, out_dtype)
        return EvalValue(-a.data, a.validity, out_dtype)
    register("negate",
             lambda ts: ts[0] if len(ts) == 1 and ts[0].is_numeric else None,
             neg_eval)

    def abs_eval(ctx, out_dtype, args):
        (a,) = args
        return EvalValue(jnp.abs(a.data), a.validity, out_dtype)
    register("abs",
             lambda ts: ts[0] if len(ts) == 1 and ts[0].is_numeric else None,
             abs_eval)


_register_arith()


# ---------------------------------------------------------------------------
# Math (double domain)
# ---------------------------------------------------------------------------

def _unary_math(name, fn, out=T.DOUBLE):
    def eval_fn(ctx, out_dtype, args):
        (a,) = args
        da = _numeric_data(a, T.DOUBLE, ctx)
        return EvalValue(fn(da), a.validity, out_dtype)
    register(name,
             lambda ts: out if len(ts) == 1 and ts[0].is_numeric else None,
             eval_fn)


_unary_math("sqrt", jnp.sqrt)
_unary_math("cbrt", jnp.cbrt)
_unary_math("ln", jnp.log)
_unary_math("log2", jnp.log2)
_unary_math("log10", jnp.log10)
_unary_math("exp", jnp.exp)
_unary_math("sin", jnp.sin)
_unary_math("cos", jnp.cos)
_unary_math("tan", jnp.tan)


def _ceil_floor(name, fn):
    def resolver(ts):
        if len(ts) != 1 or not ts[0].is_numeric:
            return None
        return ts[0] if ts[0].is_integral else (
            T.decimal(ts[0].precision, 0)
            if ts[0].kind is T.TypeKind.DECIMAL else T.DOUBLE)

    def eval_fn(ctx, out_dtype, args):
        (a,) = args
        if a.dtype.is_integral:
            return EvalValue(a.data, a.validity, out_dtype)
        if a.dtype.kind is T.TypeKind.DECIMAL:
            s = 10 ** a.dtype.scale
            d = a.data
            data = (jnp.where(d >= 0, (d + s - 1) // s, d // s) if name ==
                    "ceiling" else jnp.where(d >= 0, d // s, -((-d + s - 1) // s)))
            return EvalValue(data, a.validity, out_dtype)
        return EvalValue(fn(a.data.astype(np.float64)), a.validity, out_dtype)
    register(name, resolver, eval_fn)


_ceil_floor("ceiling", jnp.ceil)
_ceil_floor("floor", jnp.floor)
from velox_tpu.functions.registry import _REGISTRY  # noqa: E402
_REGISTRY["ceil"] = _REGISTRY["ceiling"]


def _round_eval(ctx, out_dtype, args):
    a = args[0]
    nd = 0
    if len(args) > 1:
        nd = int(args[1].py_value if args[1].py_value is not None
                 else args[1].data)
    if a.dtype.kind is T.TypeKind.DECIMAL:
        diff = a.dtype.scale - nd
        if diff <= 0:
            return EvalValue(a.data, a.validity, out_dtype)
        p = 10 ** diff
        half = p // 2
        d = a.data
        data = jnp.where(d >= 0, (d + half) // p, -((-d + half) // p)) * p
        return EvalValue(data, a.validity, out_dtype)
    scale = 10.0 ** nd
    d = a.data.astype(np.float64) * scale
    # round half away from zero (Presto), not banker's rounding
    data = jnp.where(d >= 0, jnp.floor(d + 0.5), jnp.ceil(d - 0.5)) / scale
    if a.dtype.is_integral:
        return EvalValue(a.data, a.validity, out_dtype)
    return EvalValue(data, a.validity, out_dtype)


register("round",
         lambda ts: (ts[0] if ts and ts[0].is_numeric and len(ts) <= 2
                     else None),
         _round_eval)


def _power_eval(ctx, out_dtype, args):
    a, b = args
    da = _numeric_data(a, T.DOUBLE, ctx)
    db = _numeric_data(b, T.DOUBLE, ctx)
    return EvalValue(jnp.power(da, db), merge_validity(a, b), T.DOUBLE)


register("power",
         lambda ts: T.DOUBLE if len(ts) == 2 and _all_numeric(ts) else None,
         _power_eval)
_REGISTRY["pow"] = _REGISTRY["power"]


def _sign_eval(ctx, out_dtype, args):
    (a,) = args
    return EvalValue(jnp.sign(a.data).astype(out_dtype.np_dtype()),
                     a.validity, out_dtype)


register("sign",
         lambda ts: (ts[0] if len(ts) == 1 and ts[0].is_floating
                     else T.BIGINT if len(ts) == 1 and ts[0].is_numeric
                     else None),
         _sign_eval)


def _minmax2(name, fn):
    def eval_fn(ctx, out_dtype, args):
        out = args[0]
        for b in args[1:]:
            da = _numeric_data(out, out_dtype, ctx)
            db = _numeric_data(b, out_dtype, ctx)
            out = EvalValue(fn(da, db), merge_validity(out, b), out_dtype)
        return out

    def resolver(ts):
        if not ts or not _all_numeric(ts):
            return None
        out = ts[0]
        for t in ts[1:]:
            out = promote_numeric(out, t)
        return out
    register(name, resolver, eval_fn)


_minmax2("greatest", jnp.maximum)
_minmax2("least", jnp.minimum)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

def compare_value(ctx, a: EvalValue, b: EvalValue, op: str) -> EvalValue:
    """Comparison over numerics, dates, booleans, and dictionary strings."""
    ops = {
        "eq": lambda x, y: x == y, "neq": lambda x, y: x != y,
        "lt": lambda x, y: x < y, "lte": lambda x, y: x <= y,
        "gt": lambda x, y: x > y, "gte": lambda x, y: x >= y,
    }
    if a.dtype.is_string or b.dtype.is_string:
        return _compare_strings(ctx, a, b, op)
    if _is_long(a, b):
        from velox_tpu.ops import int128 as I
        s = max(a.dtype.scale if a.dtype.kind is T.TypeKind.DECIMAL
                else 0,
                b.dtype.scale if b.dtype.kind is T.TypeKind.DECIMAL
                else 0)
        alo, ahi = _limbs(a, s, ctx)
        blo, bhi = _limbs(b, s, ctx)
        lt, eq = I.lt128(alo, ahi, blo, bhi), I.eq128(alo, ahi, blo, bhi)
        res = {"eq": eq, "neq": ~eq, "lt": lt, "lte": lt | eq,
               "gt": ~(lt | eq), "gte": ~lt}[op]
        return EvalValue(res, merge_validity(a, b), T.BOOLEAN)
    if a.dtype.is_numeric and b.dtype.is_numeric:
        common = promote_numeric(a.dtype, b.dtype)
        da = _numeric_data(a, common, ctx)
        db = _numeric_data(b, common, ctx)
    else:
        da, db = a.data, b.data
        if a.dtype.kind != b.dtype.kind:
            # date vs timestamp: lift date to micros
            if a.dtype.kind is T.TypeKind.DATE:
                da = da.astype(np.int64) * 86400_000_000
            if b.dtype.kind is T.TypeKind.DATE:
                db = db.astype(np.int64) * 86400_000_000
    return EvalValue(ops[op](da, db), merge_validity(a, b), T.BOOLEAN)


def eq_value(ctx, a, b):
    return compare_value(ctx, a, b, "eq")


def _compare_strings(ctx, a, b, op):
    """Dictionary-id comparison. Requires sorted dictionaries for ordering
    (connectors build sorted dictionaries; see vector/device.py).
    Raw (flat byte-matrix) columns compare on device bytes."""
    from velox_tpu.vector import strings as _S
    if _S.is_raw(a) or _S.is_raw(b):
        from velox_tpu.functions.raw_strings import raw_compare
        return raw_compare(a, b, op)
    a, b = _align_strings(a, b)
    if a.data is None or b.data is None:
        raise ValueError("string comparison needs at least one dictionary-"
                         "backed side")
    if a.dictionary is not None and b.dictionary is not None \
            and a.dictionary is not b.dictionary:
        # Translate b's ids into a's dictionary ordering via host table.
        bvals = b.dictionary.values
        avals = a.dictionary
        if op in ("eq", "neq"):
            table = np.array([avals.id_of(v) for v in bvals], dtype=np.int32)
            db = jnp.asarray(table)[b.data]
            res = (a.data == db) if op == "eq" else (a.data != db)
            return EvalValue(res, merge_validity(a, b), T.BOOLEAN)
        raise NotImplementedError(
            "ordered comparison across distinct dictionaries")
    if op == "eq":
        res = a.data == b.data
    elif op == "neq":
        res = a.data != b.data
    else:
        # Ordered compare valid only when the shared dictionary is sorted.
        d = a.dictionary or b.dictionary
        if d is not None and not getattr(d, "is_sorted", False):
            vals = d.values
            if not all(vals[i] <= vals[i + 1] for i in range(len(vals) - 1)):
                raise ValueError(
                    "ordered string comparison requires a sorted dictionary")
            d.is_sorted = True  # memoize
        ops = {"lt": jnp.less, "lte": jnp.less_equal,
               "gt": jnp.greater, "gte": jnp.greater_equal}
        res = ops[op](a.data, b.data)
    return EvalValue(res, merge_validity(a, b), T.BOOLEAN)


def _register_comparisons():
    for op in ("eq", "neq", "lt", "lte", "gt", "gte"):
        def eval_fn(ctx, out_dtype, args, _op=op):
            return compare_value(ctx, args[0], args[1], _op)
        register(op, _cmp_resolver, eval_fn)


_register_comparisons()


# ---------------------------------------------------------------------------
# String functions (dictionary-space transforms, host at trace time)
# ---------------------------------------------------------------------------

def _require_dict(v: EvalValue, fname: str) -> Dictionary:
    if v.dictionary is None:
        raise NotImplementedError(
            f"{fname} on non-dictionary string columns not yet supported")
    return v.dictionary


def _dict_map(v: EvalValue, f, out_dtype=T.VARCHAR) -> EvalValue:
    """Dictionary-space transform with DEDUPLICATION: f may collapse
    distinct inputs to one output (substr, lower, trim), and duplicate
    values in a dictionary break id-space equality and grouping — so the
    output dictionary is unique+sorted and the row ids are remapped via
    one device gather."""
    d = _require_dict(v, "string function")
    vals = [f(x) for x in d.values]
    uniq = sorted(set(vals))
    new_id = {x: i for i, x in enumerate(uniq)}
    remap = np.array([new_id[x] for x in vals], dtype=np.int32)
    new_dict = Dictionary(uniq)
    new_dict.is_sorted = True
    data = jnp.asarray(remap)[v.data]
    return EvalValue(data, v.validity, out_dtype, new_dict)


def _dict_lookup(v: EvalValue, f, out_dtype) -> EvalValue:
    """Apply f per dictionary value, gather results by id on device."""
    d = _require_dict(v, "string function")
    table = np.array([f(x) for x in d.values],
                     dtype=out_dtype.np_dtype())
    data = jnp.asarray(table)[v.data]
    return EvalValue(data, v.validity, out_dtype)


def _str_resolver(out):
    def resolver(ts):
        return out if ts and ts[0].is_string else None
    return resolver


def _dict_map_pa(v: EvalValue, pa_fn, py_f, out_dtype=T.VARCHAR
                 ) -> EvalValue:
    """_dict_map with a pyarrow.compute kernel: the WHOLE distinct-value
    transform runs as one C++-vectorized call, which is what keeps
    high-cardinality VARCHAR columns viable (the reference's analogue is
    its SIMD batch string loops, functions/lib/StringImpl + Re2Functions).
    Output nulls become NULL rows. Falls back to the per-value python
    loop when the kernel rejects the input (e.g. RE2-unsupported regex
    features)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    d = _require_dict(v, "string function")
    try:
        src = d.arrow()
        out = pa_fn(src)
        nulls = pc.is_null(out)
        has_null = pc.any(nulls).as_py() if len(out) else False
        filled = pc.fill_null(out, "") if has_null else out
        # one hash pass: dictionary_encode gives (codes, distinct);
        # sorting the distinct set + an inverse permutation re-sorts the
        # codes without a second hash join (index_in)
        enc = filled.dictionary_encode()
        codes = enc.indices.to_numpy(zero_copy_only=False) \
            .astype(np.int32)
        order = pc.array_sort_indices(enc.dictionary) \
            .to_numpy(zero_copy_only=False)
        inv = np.empty(len(order), np.int32)
        inv[order] = np.arange(len(order), dtype=np.int32)
        remap = inv[codes]
        uniq_np = enc.dictionary.take(pa.array(order)) \
            .to_numpy(zero_copy_only=False)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        if py_f is None:
            raise
        return _dict_map(v, py_f, out_dtype)
    new_dict = Dictionary(uniq_np)
    new_dict.is_sorted = True
    data = jnp.asarray(remap)[v.data]
    validity = v.validity
    if has_null:
        is_null = jnp.asarray(
            nulls.to_numpy(zero_copy_only=False))[v.data]
        validity = ~is_null if validity is None else validity & ~is_null
    return EvalValue(data, validity, out_dtype, new_dict)


def _dict_lookup_pa(v: EvalValue, pa_fn, py_f, out_dtype) -> EvalValue:
    """_dict_lookup with a C++-vectorized pyarrow kernel building the
    per-distinct-value table; output nulls become NULL rows."""
    import pyarrow as pa
    import pyarrow.compute as pc
    d = _require_dict(v, "string function")
    try:
        src = d.arrow()
        out = pa_fn(src)
        nulls = pc.is_null(out)
        has_null = pc.any(nulls).as_py() if len(out) else False
        table = (pc.fill_null(out, 0) if has_null else out) \
            .to_numpy(zero_copy_only=False).astype(out_dtype.np_dtype())
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        if py_f is None:
            raise
        return _dict_lookup(v, py_f, out_dtype)
    data = jnp.asarray(table)[v.data]
    validity = v.validity
    if has_null:
        is_null = jnp.asarray(
            nulls.to_numpy(zero_copy_only=False))[v.data]
        validity = ~is_null if validity is None else validity & ~is_null
    return EvalValue(data, validity, out_dtype)


def _pa_c():
    import pyarrow.compute as pc
    return pc


register("lower", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_pa(a[0], _pa_c().utf8_lower,
                                        str.lower))
register("upper", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_pa(a[0], _pa_c().utf8_upper,
                                        str.upper))
register("length", _str_resolver(T.BIGINT),
         lambda ctx, o, a: _dict_lookup_pa(a[0], _pa_c().utf8_length,
                                           len, T.BIGINT))
register("trim", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_pa(
             a[0], _pa_c().utf8_trim_whitespace, str.strip))
register("ltrim", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_pa(
             a[0], _pa_c().utf8_ltrim_whitespace, str.lstrip))
register("rtrim", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_pa(
             a[0], _pa_c().utf8_rtrim_whitespace, str.rstrip))
register("reverse", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_pa(a[0], _pa_c().utf8_reverse,
                                        lambda s: s[::-1]))


def _substr_eval(ctx, out_dtype, args):
    v = args[0]
    start = int(args[1].py_value)
    length = None
    if len(args) > 2:
        length = int(args[2].py_value)

    def f(s):
        # SQL substr: 1-based start; negative counts from end.
        i = start - 1 if start > 0 else len(s) + start
        if i < 0:
            i = 0
        return s[i:i + length] if length is not None else s[i:]
    return _dict_map(v, f)


register("substr",
         lambda ts: T.VARCHAR if ts and ts[0].is_string else None,
         _substr_eval)
_REGISTRY["substring"] = _REGISTRY["substr"]


def _like_eval(ctx, out_dtype, args):
    import re
    v, pat = args[0], args[1]
    pattern = pat.py_value
    if pattern is None:
        raise NotImplementedError("LIKE pattern must be a constant")
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    rx = re.compile("^" + "".join(out) + "$", re.S)
    return _dict_lookup(v, lambda s: bool(rx.match(s)), T.BOOLEAN)


register("like", _str_resolver(T.BOOLEAN), _like_eval)


def _starts_ends(name, f):
    def eval_fn(ctx, out_dtype, args):
        v, pre = args
        s = pre.py_value
        return _dict_lookup(v, lambda x: f(x, s), T.BOOLEAN)
    register(name, _str_resolver(T.BOOLEAN), eval_fn)


_starts_ends("starts_with", lambda x, s: x.startswith(s))
_starts_ends("ends_with", lambda x, s: x.endswith(s))


def _strpos_eval(ctx, out_dtype, args):
    v, sub = args
    s = sub.py_value
    return _dict_lookup(v, lambda x: x.find(s) + 1, T.BIGINT)


register("strpos", _str_resolver(T.BIGINT), _strpos_eval)


def _concat_eval(ctx, out_dtype, args):
    # constant-suffix/prefix concat in dictionary space; general col||col
    # needs the product dictionary (deferred).
    col = None
    for a in args:
        if a.py_value is None:
            if col is not None:
                raise NotImplementedError("concat of two string columns")
            col = a
    parts = [a.py_value if a.py_value is not None else None for a in args]

    def f(s):
        return "".join(p if p is not None else s for p in parts)
    return _dict_map(col, f)


register("concat",
         lambda ts: T.VARCHAR if ts and all(t.is_string for t in ts)
         else None, _concat_eval)


def _replace_eval(ctx, out_dtype, args):
    v = args[0]
    old = args[1].py_value
    new = args[2].py_value if len(args) > 2 else ""
    return _dict_map(v, lambda s: s.replace(old, new))


register("replace", _str_resolver(T.VARCHAR), _replace_eval)


# ---------------------------------------------------------------------------
# Date/time functions (DATE = int32 days since epoch)
# ---------------------------------------------------------------------------

def _civil_from_days(days):
    """Vectorized days-since-epoch -> (year, month, day); Howard Hinnant's
    algorithm, branch-free — runs on device."""
    z = days.astype(np.int64) + 719468
    era = jnp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = jnp.where(mp < 10, mp + 3, mp - 9)
    y = jnp.where(m <= 2, y + 1, y)
    return y, m, d


def _date_days(v: EvalValue):
    if v.dtype.kind is T.TypeKind.DATE:
        return v.data
    if v.dtype.kind is T.TypeKind.TIMESTAMP:
        return (v.data // 86400_000_000).astype(np.int32)
    raise TypeError(f"not a date: {v.dtype}")


def _date_part(name, picker):
    def eval_fn(ctx, out_dtype, args):
        (v,) = args
        y, m, d = _civil_from_days(_date_days(v))
        return EvalValue(picker(y, m, d).astype(np.int64), v.validity,
                         T.BIGINT)
    register(name, fixed(T.BIGINT, lambda t: t.kind in (
        T.TypeKind.DATE, T.TypeKind.TIMESTAMP)), eval_fn)


_date_part("year", lambda y, m, d: y)
_date_part("month", lambda y, m, d: m)
_date_part("day", lambda y, m, d: d)
_date_part("quarter", lambda y, m, d: (m - 1) // 3 + 1)


def _dow_eval(ctx, out_dtype, args):
    (v,) = args
    days = _date_days(v).astype(np.int64)
    # 1970-01-01 was a Thursday; ISO day-of-week 1=Mon..7=Sun.
    dow = (days + 3) % 7 + 1
    return EvalValue(dow, v.validity, T.BIGINT)


register("day_of_week", fixed(T.BIGINT, lambda t: t.kind in (
    T.TypeKind.DATE, T.TypeKind.TIMESTAMP)), _dow_eval)
_REGISTRY["dow"] = _REGISTRY["day_of_week"]


def _doy_eval(ctx, out_dtype, args):
    (v,) = args
    days = _date_days(v)
    y, m, d = _civil_from_days(days)
    jan1 = _days_from_civil(y, jnp.ones_like(m), jnp.ones_like(d))
    return EvalValue((days.astype(np.int64) - jan1 + 1), v.validity, T.BIGINT)


def _days_from_civil(y, m, d):
    y = y - (m <= 2)
    era = jnp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


register("day_of_year", fixed(T.BIGINT, lambda t: t.kind in (
    T.TypeKind.DATE, T.TypeKind.TIMESTAMP)), _doy_eval)
_REGISTRY["doy"] = _REGISTRY["day_of_year"]


# ---------------------------------------------------------------------------
# Hashing (used for partitioning / joins; internal but exposed as $hash)
# ---------------------------------------------------------------------------

def hash64(data):
    """Murmur3-style 64-bit finalizer over int64 lanes (elementwise)."""
    x = data.astype(jnp.uint64)
    x = x ^ (x >> 33)
    x = x * jnp.uint64(0xFF51AFD7ED558CCD)
    x = x ^ (x >> 33)
    x = x * jnp.uint64(0xC4CEB9FE1A85EC53)
    x = x ^ (x >> 33)
    return x


def combine_hash(h1, h2):
    return h1 * jnp.uint64(0x9E3779B97F4A7C15) + h2 + jnp.uint64(0x2545F4914F6CDD1D)


def hash_value(v: EvalValue, capacity: int):
    """uint64 hash of an EvalValue; nulls hash to a fixed tag."""
    import jax.lax as lax
    if v.dtype.is_floating:
        data = v.full_data(capacity)
        if v.dtype.kind is T.TypeKind.REAL:
            raw = lax.bitcast_convert_type(data, jnp.int32).astype(jnp.int64)
        else:
            raw = lax.bitcast_convert_type(data, jnp.int64)
        h = hash64(raw)
    else:
        h = hash64(v.full_data(capacity).astype(jnp.int64))
    if v.validity is not None:
        h = jnp.where(v.full_validity(capacity), h,
                      jnp.uint64(0x9E3779B97F4A7C15))
    return h


def _hash_eval(ctx, out_dtype, args):
    h = hash_value(args[0], ctx.capacity)
    for a in args[1:]:
        h = combine_hash(h, hash_value(a, ctx.capacity))
    return EvalValue(h.astype(jnp.int64), None, T.BIGINT)


register("$hash", lambda ts: T.BIGINT if ts else None, _hash_eval)
