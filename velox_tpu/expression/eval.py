"""Vectorized expression evaluation: typed expr tree -> traced JAX program.

Role parity: ``velox/expression/Expr.cpp`` + ``ExprCompiler.cpp`` — the
ExprSet/Expr::eval machinery with its encoding peeling, CSE caching, lazy
loading and flat-no-nulls fast paths (Expr.cpp:774-1154).

Design: an ExprSet here is *traced once per (plan, schema,
capacity)* and compiled by XLA, so the reference's runtime adaptivity
collapses into compile-time structure:

* CSE: identical (hashable) subtrees are evaluated once per eval() via a
  value cache; XLA additionally dedupes at the HLO level.
* Encoding peeling/dictionary memoization: strings stay dictionary-encoded
  end-to-end; string functions run on the (host, trace-time) dictionary and
  become id-space lookups on device — the memoization is structural.
* Flat-no-nulls fast path: validity is Optional — None means "no nulls" and
  all null bookkeeping disappears from the traced program.
* SelectivityVector: dense masked execution; the batch mask only matters to
  operators, not to expression eval (masked lanes compute garbage safely).

SQL 3-valued logic lives here: default null propagation (validity AND), and
Kleene AND/OR in the special forms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.core import expressions as ex
from velox_tpu.vector.device import DeviceBatch, DeviceColumn, Dictionary


@dataclass
class EvalValue:
    """A (possibly scalar-broadcast) column value during evaluation.

    data: jnp array, shape () or (capacity,). For strings: int32 dict ids.
    validity: None (no nulls) or bool array broadcastable to data.
    py_value: set for unresolved string/complex constants (data is None).
    """

    data: Any
    validity: Optional[Any]
    dtype: T.DataType
    dictionary: Optional[Dictionary] = None
    py_value: Any = None
    children: tuple = ()  # complex types: flattened element columns
    starts: Any = None    # complex: explicit element offsets (see
    #                       vector/device.py DeviceColumn.starts)

    @property
    def is_scalar(self) -> bool:
        return self.data is not None and getattr(self.data, "ndim", 0) == 0

    def full_data(self, capacity: int):
        if self.data is None:
            raise ValueError(
                f"unresolved constant {self.py_value!r}: string constants "
                "must be consumed by a string-aware function")
        if self.data.ndim == 0:
            return jnp.broadcast_to(self.data, (capacity,))
        return self.data

    def full_validity(self, capacity: int):
        if self.validity is None:
            return jnp.ones((capacity,), dtype=bool)
        if self.validity.ndim == 0:
            return jnp.broadcast_to(self.validity, (capacity,))
        return self.validity

    def to_column(self, capacity: int) -> DeviceColumn:
        v = self.validity
        if v is not None and v.ndim == 0:
            v = jnp.broadcast_to(v, (capacity,))
        return DeviceColumn(self.full_data(capacity), v, self.dtype,
                            self.dictionary, self.children, self.starts)


def value_from_column(col: DeviceColumn) -> EvalValue:
    return EvalValue(col.data, col.validity, col.dtype, col.dictionary,
                     children=col.children,
                     starts=getattr(col, "starts", None))


def merge_validity(*vals: EvalValue):
    """AND of argument validities (default SQL null propagation)."""
    out = None
    for v in vals:
        if v.validity is None:
            continue
        out = v.validity if out is None else (out & v.validity)
    return out


_cse_disabled = False


def set_cse_disabled(flag: bool):
    """kDebugDisableCommonSubExpressions: turn off trace-time common-
    subexpression caching (debugging aid; set per-Task around run())."""
    global _cse_disabled
    _cse_disabled = flag


class EvalCtx:
    """Per-eval context: input columns + static capacity + error channel.

    ``errors`` is a lazily-created bool[capacity] mask of rows where a
    checked operation failed (div-by-zero, int overflow, bad cast) —
    parity: velox EvalCtx's error vector (expression/EvalCtx.h). TRY
    evaluates its child under a fresh channel and converts flagged rows
    to NULL (TryExpr.h); unhandled errors surface as a per-batch count
    the Task raises on (common/errors.py).
    """

    def __init__(self, columns: Dict[str, EvalValue], capacity: int):
        self.columns = columns
        self.capacity = capacity
        self.errors = None

    def flag_error(self, mask) -> None:
        self.errors = mask if self.errors is None else (self.errors | mask)


class ExprSet:
    """A compiled set of expressions evaluated together with CSE.

    Parity: velox/expression/Expr.h:718 (ExprSet). eval() is pure-traceable:
    call it inside jit with a DeviceBatch pytree.
    """

    def __init__(self, exprs: List[ex.TypedExpr], input_type: T.DataType):
        self.exprs = list(exprs)
        self.input_type = input_type

    def eval_batch(self, batch: DeviceBatch,
                   err_sink: Optional[list] = None) -> List[EvalValue]:
        """Evaluate all expressions. When ``err_sink`` (a list) is given,
        the per-row error mask (or None) is appended to it — callers that
        surface checked-operation errors pass one; others keep the
        round-1 behavior (errors observable only as NULLs)."""
        cols = {
            name: value_from_column(col) for name, col in batch.columns.items()
        }
        ctx = EvalCtx(cols, batch.capacity)
        cache: Dict[ex.TypedExpr, EvalValue] = {}
        out = [_eval(e, ctx, cache) for e in self.exprs]
        if err_sink is not None:
            err_sink.append(ctx.errors)
        return out


def compile_exprs(exprs, input_type: T.DataType) -> ExprSet:
    return ExprSet(exprs, input_type)


def evaluate(expr: ex.TypedExpr, batch: DeviceBatch) -> EvalValue:
    """One-off evaluation of a single expression against a batch."""
    return ExprSet([expr], batch.row_type()).eval_batch(batch)[0]


# ---------------------------------------------------------------------------
# Core recursive evaluator.
# ---------------------------------------------------------------------------

_SPECIAL_FORMS = {}


def special_form(name):
    def deco(fn):
        _SPECIAL_FORMS[name] = fn
        return fn
    return deco


def _eval(expr: ex.TypedExpr, ctx: EvalCtx, cache) -> EvalValue:
    if _cse_disabled:
        return _eval_uncached(expr, ctx, cache)
    hit = cache.get(expr)
    if hit is not None:
        return hit
    out = _eval_uncached(expr, ctx, cache)
    cache[expr] = out
    return out


def _eval_uncached(expr, ctx, cache) -> EvalValue:
    if isinstance(expr, ex.FieldAccess):
        try:
            return ctx.columns[expr.name]
        except KeyError:
            raise KeyError(
                f"column {expr.name!r} not in input "
                f"{sorted(ctx.columns)}") from None

    if isinstance(expr, ex.Constant):
        return _eval_constant(expr)

    if isinstance(expr, ex.Cast):
        child = _eval(expr.child, ctx, cache)
        from velox_tpu.functions import casts
        return casts.cast(ctx, child, expr.dtype, is_try=expr.is_try)

    if isinstance(expr, ex.Call):
        sf = _SPECIAL_FORMS.get(expr.name)
        if sf is not None:
            return sf(expr, ctx, cache)
        args = [_eval(a, ctx, cache) for a in expr.args]
        from velox_tpu.functions.registry import lookup
        fn = lookup(expr.name, [a.dtype for a in expr.args])
        return fn.eval(ctx, expr.dtype, args)

    raise TypeError(f"cannot evaluate {type(expr).__name__}")


def _eval_constant(expr: ex.Constant) -> EvalValue:
    dt = expr.dtype
    v = expr.value
    if v is None:
        data = jnp.zeros((), dtype=dt.np_dtype() if dt.is_fixed_width
                         else np.int32)
        return EvalValue(data, jnp.zeros((), dtype=bool), dt)
    if dt.is_string:
        # Unresolved until a consumer binds it against a dictionary.
        return EvalValue(None, None, dt, py_value=v)
    if dt.kind is T.TypeKind.DECIMAL and not isinstance(v, int):
        # Accept float/Decimal literals; store scaled int.
        import decimal as pydec
        v = int(pydec.Decimal(str(v)).scaleb(dt.scale)
                .to_integral_value(rounding=pydec.ROUND_HALF_UP))
    if dt.is_long_decimal:
        from velox_tpu.ops.int128 import from_python_int
        from velox_tpu.vector.device import DeviceColumn
        lo, hi = from_python_int(int(v))
        hi_col = DeviceColumn(jnp.asarray(hi), None, T.BIGINT, None)
        return EvalValue(jnp.asarray(lo), None, dt,
                         children=(hi_col,), py_value=v)
    if dt.kind is T.TypeKind.DATE and isinstance(v, str):
        v = _parse_date_days(v)
    # keep the static python value alongside the device scalar: trace-time
    # consumers (dictionary-space string transforms, substr bounds) need
    # concrete constants even under jit
    return EvalValue(jnp.asarray(v, dtype=dt.np_dtype()), None, dt,
                     py_value=v)


def _parse_date_days(s: str) -> int:
    import datetime
    return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days


# ---------------------------------------------------------------------------
# Special forms. Parity: velox/expression special forms
# (ConjunctExpr.cpp Kleene AND/OR, SwitchExpr, CoalesceExpr, TryExpr).
# In dense masked execution there is no short-circuiting; adaptive conjunct
# reordering (ConjunctExpr.cpp) is moot because XLA fuses all conjuncts into
# one elementwise pass over the batch.
# ---------------------------------------------------------------------------

def _as_bool3(v: EvalValue, ctx):
    """(value, known) pair for 3-valued logic; null -> known=False."""
    data = v.full_data(ctx.capacity).astype(bool)
    if v.validity is None:
        return data, None
    return data, v.full_validity(ctx.capacity)


@special_form("and")
def _and(expr, ctx, cache):
    vals = [_eval(a, ctx, cache) for a in expr.args]
    # Kleene: FALSE dominates NULL.
    acc_v, acc_k = _as_bool3(vals[0], ctx)
    for v in vals[1:]:
        d, k = _as_bool3(v, ctx)
        res = acc_v & d
        if acc_k is None and k is None:
            acc_v, acc_k = res, None
        else:
            ak = acc_k if acc_k is not None else jnp.ones_like(res)
            bk = k if k is not None else jnp.ones_like(res)
            known = (ak & bk) | (ak & ~acc_v) | (bk & ~d)
            acc_v, acc_k = res & ak & bk, known
    return EvalValue(acc_v, acc_k, T.BOOLEAN)


@special_form("or")
def _or(expr, ctx, cache):
    vals = [_eval(a, ctx, cache) for a in expr.args]
    acc_v, acc_k = _as_bool3(vals[0], ctx)
    for v in vals[1:]:
        d, k = _as_bool3(v, ctx)
        res = acc_v | d
        if acc_k is None and k is None:
            acc_v, acc_k = res, None
        else:
            ak = acc_k if acc_k is not None else jnp.ones_like(res)
            bk = k if k is not None else jnp.ones_like(res)
            known = (ak & bk) | (ak & acc_v) | (bk & d)
            acc_v = (acc_v & ak) | (d & bk)
            acc_k = known
    return EvalValue(acc_v, acc_k, T.BOOLEAN)


@special_form("not")
def _not(expr, ctx, cache):
    v = _eval(expr.args[0], ctx, cache)
    return EvalValue(~v.data.astype(bool), v.validity, T.BOOLEAN)


@special_form("if")
def _if(expr, ctx, cache):
    cond = _eval(expr.args[0], ctx, cache)
    then = _eval(expr.args[1], ctx, cache)
    els = (_eval(expr.args[2], ctx, cache) if len(expr.args) > 2
           else ex_null(expr.dtype))
    c, ck = _as_bool3(cond, ctx)
    take_then = c if ck is None else (c & ck)
    then, els = _align_strings(then, els)
    data = jnp.where(take_then, then.full_data(ctx.capacity),
                     els.full_data(ctx.capacity))
    if then.validity is None and els.validity is None:
        validity = None
    else:
        validity = jnp.where(take_then, then.full_validity(ctx.capacity),
                             els.full_validity(ctx.capacity))
    return EvalValue(data, validity, expr.dtype,
                     then.dictionary or els.dictionary)


@special_form("coalesce")
def _coalesce(expr, ctx, cache):
    vals = [_eval(a, ctx, cache) for a in expr.args]
    out = vals[-1]
    for v in reversed(vals[:-1]):
        if v.validity is None:
            out = v
            continue
        vk = v.full_validity(ctx.capacity)
        v2, out2 = _align_strings(v, out)
        data = jnp.where(vk, v2.full_data(ctx.capacity),
                         out2.full_data(ctx.capacity))
        validity = (vk | out2.full_validity(ctx.capacity)
                    if out2.validity is not None else None)
        out = EvalValue(data, validity, expr.dtype,
                        v2.dictionary or out2.dictionary)
    return out


@special_form("try")
def _try(expr, ctx, cache):
    """TRY(expr): suppress row-level errors -> NULL (velox TryExpr.h).

    The child evaluates under a FRESH error channel (and a copied CSE
    cache so inner evaluations don't suppress error flags of identical
    outer subexpressions); rows the child flagged become NULL and the
    flags are swallowed."""
    saved = ctx.errors
    ctx.errors = None
    inner_cache = dict(cache)
    v = _eval(expr.args[0], ctx, inner_cache)
    errs = ctx.errors
    ctx.errors = saved
    if errs is None:
        return v
    validity = (~errs if v.validity is None
                else v.full_validity(ctx.capacity) & ~errs)
    return EvalValue(v.full_data(ctx.capacity), validity, v.dtype,
                     v.dictionary, children=v.children)


@special_form("is_null")
def _is_null(expr, ctx, cache):
    v = _eval(expr.args[0], ctx, cache)
    if v.validity is None:
        return EvalValue(jnp.zeros((), dtype=bool), None, T.BOOLEAN)
    return EvalValue(~v.full_validity(ctx.capacity), None, T.BOOLEAN)


@special_form("is_not_null")
def _is_not_null(expr, ctx, cache):
    v = _eval(expr.args[0], ctx, cache)
    if v.validity is None:
        return EvalValue(jnp.ones((), dtype=bool), None, T.BOOLEAN)
    return EvalValue(v.full_validity(ctx.capacity), None, T.BOOLEAN)


@special_form("in")
def _in(expr, ctx, cache):
    """x IN (c1, c2, ...) with constant list."""
    x = _eval(expr.args[0], ctx, cache)
    from velox_tpu.functions.scalar import eq_value
    hits = None
    for arg in expr.args[1:]:
        c = _eval(arg, ctx, cache)
        h = eq_value(ctx, x, c).data
        hits = h if hits is None else (hits | h)
    return EvalValue(hits, x.validity, T.BOOLEAN)


@special_form("between")
def _between(expr, ctx, cache):
    x, lo, hi = (_eval(a, ctx, cache) for a in expr.args)
    from velox_tpu.functions.scalar import compare_value
    ge = compare_value(ctx, x, lo, "gte")
    le = compare_value(ctx, x, hi, "lte")
    return EvalValue(ge.data & le.data,
                     merge_validity(x, lo, hi), T.BOOLEAN)


def ex_null(dtype: T.DataType) -> EvalValue:
    data = jnp.zeros((), dtype=dtype.np_dtype() if dtype.is_fixed_width
                     else np.int32)
    return EvalValue(data, jnp.zeros((), dtype=bool), dtype)


def _align_strings(a: EvalValue, b: EvalValue):
    """Resolve unresolved string constants against the other side's dict."""
    if a.dtype.is_string or b.dtype.is_string:
        if a.data is None and b.dictionary is not None:
            a = EvalValue(jnp.asarray(b.dictionary.id_of(a.py_value),
                                      jnp.int32), None, a.dtype, b.dictionary)
        if b.data is None and a.dictionary is not None:
            b = EvalValue(jnp.asarray(a.dictionary.id_of(b.py_value),
                                      jnp.int32), None, b.dtype, a.dictionary)
    return a, b
