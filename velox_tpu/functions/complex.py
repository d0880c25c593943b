"""Array/map scalar functions over the lengths+children device layout.

Role parity: velox/functions/prestosql (ArrayFunctions: cardinality,
element_at, contains; MapFunctions: map_keys-adjacent via children).
Element gathers are bounds-clamped with null-out — the dense masked
analogue of per-row bounds checks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue, merge_validity
from velox_tpu.functions.registry import register
from velox_tpu.functions.scalar import eq_value
from velox_tpu.functions.signature import sig


def _offsets(v):
    st = getattr(v, "starts", None)
    if st is not None:
        return st.astype(jnp.int32)
    lens = v.data.astype(jnp.int32)
    return jnp.cumsum(lens) - lens


def _require_dense(v, fname: str):
    """Element-space transforms assume each row OWNS its element slice
    (dense cumsum layout). A column with explicit starts shares/reorders
    children (e.g. an array carried through a join) — materialize first."""
    if getattr(v, "starts", None) is not None:
        raise NotImplementedError(
            f"{fname}: element-space transform over a shared-slice array "
            "(carried through a join) is not supported; project the "
            "array before the join instead")


def _cardinality_eval(ctx, out_dtype, args):
    (v,) = args
    return EvalValue(v.data.astype(jnp.int64), v.validity, T.BIGINT)


register("cardinality", sig("complex -> bigint"), _cardinality_eval)


def _element_at_eval(ctx, out_dtype, args):
    arr, idx = args
    child = arr.children[0]
    lens = arr.data.astype(jnp.int64)
    starts = _offsets(arr).astype(jnp.int64)
    i = idx.full_data(ctx.capacity).astype(jnp.int64)
    # 1-based; negative indexes from the end (Presto semantics)
    pos = jnp.where(i > 0, i - 1, lens + i)
    in_bounds = (pos >= 0) & (pos < lens)
    src = jnp.clip(starts + pos, 0, child.capacity - 1).astype(jnp.int32)
    data = child.data[src]
    validity = in_bounds
    if arr.validity is not None:
        validity = validity & arr.validity
    if idx.validity is not None:
        validity = validity & idx.full_validity(ctx.capacity)
    if child.validity is not None:
        validity = validity & child.validity[src]
    elem_t = arr.dtype.children[0]
    out = EvalValue(data, validity, elem_t, child.dictionary)
    return out


def _element_at_resolver(ts):
    if len(ts) == 2 and ts[0].kind is T.TypeKind.ARRAY \
            and ts[1].is_integral:
        return ts[0].children[0]
    return None


register("element_at", _element_at_resolver, _element_at_eval)


def _contains_eval(ctx, out_dtype, args):
    arr, x = args
    child = arr.children[0]
    ecap = child.capacity
    # _element_row_map guards shared-slice (starts-bearing) inputs: its
    # searchsorted inversion requires the dense sorted-starts layout
    row_c, in_row = _element_row_map(arr, ctx)
    from velox_tpu.expression.eval import EvalValue as EV
    elem_val = EV(child.data, child.validity, arr.dtype.children[0],
                  child.dictionary)
    # lift the needle into element space (per-row needles gather by row)
    if x.data is not None and getattr(x.data, "ndim", 0) > 0:
        xv = x.data[row_c]
        xvalid = (x.validity[row_c]
                  if x.validity is not None and x.validity.ndim > 0
                  else x.validity)
        x = EV(xv, xvalid, x.dtype, x.dictionary)

    class _ECtx:
        capacity = ecap
    eq = eq_value(_ECtx, elem_val, x)
    hit = eq.data.astype(bool)
    if eq.validity is not None:
        hit = hit & eq.validity
    hit = hit & in_row
    seg = jnp.where(in_row, row_c, jnp.int32(ctx.capacity))
    import jax
    found = jax.ops.segment_max(hit.astype(jnp.int32), seg,
                                num_segments=ctx.capacity + 1)[
        :ctx.capacity] > 0
    validity = arr.validity
    return EvalValue(found, validity, T.BOOLEAN)


def _contains_resolver(ts):
    if len(ts) == 2 and ts[0].kind is T.TypeKind.ARRAY:
        return T.BOOLEAN
    return None


register("contains", _contains_resolver, _contains_eval)


# ---------------------------------------------------------------------------
# Higher-order functions (lambdas) + more array/map functions.
#
# Role parity: velox/expression/LambdaExpr.cpp + prestosql ArrayFunctions
# (transform/filter/any_match/..., array_sort/array_distinct) and
# MapFunctions (map_keys/map_values/map_filter/transform_values).
#
# Lambdas evaluate in ELEMENT SPACE — the flattened children
# arrays are one dense vector; the lambda parameter binds the child column
# directly and captured outer columns lift via one row-index gather. No
# per-row loops, no per-row function calls (the reference's
# SimpleFunctionAdapter per-row lambda dispatch has no analogue here).
# ---------------------------------------------------------------------------

from velox_tpu.core import expressions as _ex
from velox_tpu.expression.eval import (
    EvalCtx as _EvalCtx, _eval as _eval_expr, special_form,
)
from velox_tpu.functions.registry import register as _register


def _element_row_map(arr: EvalValue, ctx):
    """(row_of_element, in_row mask) over the child capacity."""
    _require_dense(arr, "element-space transform")
    child = arr.children[0]
    ecap = child.capacity
    lens = arr.data.astype(jnp.int32)
    starts = _offsets(arr)
    e = jnp.arange(ecap, dtype=jnp.int32)
    row = jnp.searchsorted(starts, e, side="right").astype(jnp.int32) - 1
    row_c = jnp.clip(row, 0, ctx.capacity - 1)
    in_row = (e >= starts[row_c]) & (e < starts[row_c] + lens[row_c])
    if arr.validity is not None:
        in_row = in_row & arr.validity[row_c]
    return row_c, in_row


class _LiftedColumns(dict):
    """Element-space view of row-space columns: lifts on first access."""

    def __init__(self, base: dict, row_map, ecap: int):
        super().__init__()
        self._base = base
        self._row = row_map
        self._ecap = ecap

    def __missing__(self, name):
        v = self._base[name]
        data = (v.data if v.is_scalar
                else v.full_data(self._base_cap())[self._row])
        validity = None
        if v.validity is not None:
            validity = (v.validity if getattr(v.validity, "ndim", 0) == 0
                        else v.validity[self._row])
        out = EvalValue(data, validity, v.dtype, v.dictionary)
        self[name] = out
        return out

    def _base_cap(self):
        for v in self._base.values():
            if not v.is_scalar and v.data is not None:
                return v.data.shape[0]
        return self._ecap


def _lambda_eval_bound(lam: "_ex.Lambda", coll: EvalValue, binds, ctx):
    """Evaluate a lambda body in element space with explicit parameter
    bindings. ``binds`` pairs each ``lam.params`` name with an EvalValue
    already laid out over the element capacity. Returns
    (EvalValue over element capacity, row_c, in_row)."""
    ecap = coll.children[0].capacity
    row_c, in_row = _element_row_map(coll, ctx)
    cols = _LiftedColumns(ctx.columns, row_c, ecap)
    for name, val in binds:
        cols[name] = val
    ectx = _EvalCtx(cols, ecap)
    out = _eval_expr(lam.body, ectx, {})
    if ectx.errors is not None:
        # propagate lambda-body errors (only on real elements)
        ctx.flag_error(jax.ops.segment_max(
            (ectx.errors & in_row).astype(jnp.int32),
            jnp.where(in_row, row_c, ctx.capacity),
            num_segments=ctx.capacity + 1)[:ctx.capacity] > 0)
    return out, row_c, in_row


def _lambda_eval(lam: "_ex.Lambda", arr: EvalValue, ctx, cache):
    """1-param form over an ARRAY: the parameter binds the child column."""
    child = arr.children[0]
    elem_t = arr.dtype.children[0]
    bind = EvalValue(child.data, child.validity, elem_t, child.dictionary,
                     children=child.children)
    return _lambda_eval_bound(lam, arr, [(lam.params[0], bind)], ctx)


def _lambda_eval_map(lam: "_ex.Lambda", m: EvalValue, ctx):
    """2-param form over a MAP: params bind (keys, values) children
    (entry-aligned, same element capacity)."""
    kc, vc = m.children
    kt, vt = m.dtype.children
    binds = [
        (lam.params[0], EvalValue(kc.data, kc.validity, kt, kc.dictionary,
                                  children=kc.children)),
        (lam.params[1], EvalValue(vc.data, vc.validity, vt, vc.dictionary,
                                  children=vc.children)),
    ]
    return _lambda_eval_bound(lam, m, binds, ctx)


def _array_of(lengths, validity, elem_value: EvalValue, elem_t,
              dtype=None) -> EvalValue:
    child = elem_value.to_column(elem_value.data.shape[0])
    return EvalValue(lengths, validity, dtype or T.array(elem_t),
                     children=(child,))


@special_form("transform")
def _transform(expr, ctx, cache):
    arr = _eval_expr(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval(lam, arr, ctx, cache)
    ecap = arr.children[0].capacity
    data = out.full_data(ecap)
    validity = out.validity
    return _array_of(arr.data, arr.validity, 
                     EvalValue(data, validity, lam.dtype, out.dictionary),
                     lam.dtype, expr.dtype)


@special_form("filter")
def _filter_hof(expr, ctx, cache):
    arr = _eval_expr(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval(lam, arr, ctx, cache)
    ecap = arr.children[0].capacity
    keep = out.full_data(ecap).astype(bool) & in_row
    if out.validity is not None:
        keep = keep & out.full_validity(ecap)
    # global prefix compaction preserves per-row grouping and order
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, jnp.int32(ecap))
    child = arr.children[0]
    new_data = jnp.zeros_like(child.data).at[tgt].set(child.data,
                                                      mode="drop")
    new_validity = None
    if child.validity is not None:
        new_validity = jnp.ones_like(child.validity).at[tgt].set(
            child.validity, mode="drop")
    new_lens = jax.ops.segment_sum(
        keep.astype(jnp.int32),
        jnp.where(in_row, row_c, jnp.int32(ctx.capacity)),
        num_segments=ctx.capacity + 1)[:ctx.capacity]
    elem_t = arr.dtype.children[0]
    from velox_tpu.vector.device import DeviceColumn as _DC
    new_child = _DC(new_data, new_validity, elem_t, child.dictionary,
                    child.children)
    return EvalValue(new_lens, arr.validity, arr.dtype,
                     children=(new_child,))


def _match_reduce(expr, ctx, cache, mode):
    arr = _eval_expr(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval(lam, arr, ctx, cache)
    ecap = arr.children[0].capacity
    hit = out.full_data(ecap).astype(bool) & in_row
    if out.validity is not None:
        hit = hit & out.full_validity(ecap)
    seg = jnp.where(in_row, row_c, jnp.int32(ctx.capacity))
    any_hit = jax.ops.segment_max(hit.astype(jnp.int32), seg,
                                  num_segments=ctx.capacity + 1)[
        :ctx.capacity] > 0
    misses = in_row & ~hit
    any_miss = jax.ops.segment_max(misses.astype(jnp.int32), seg,
                                   num_segments=ctx.capacity + 1)[
        :ctx.capacity] > 0
    if mode == "any":
        res = any_hit
    elif mode == "all":
        res = ~any_miss
    else:  # none
        res = ~any_hit
    return EvalValue(res, arr.validity, T.BOOLEAN)


@special_form("any_match")
def _any_match(expr, ctx, cache):
    return _match_reduce(expr, ctx, cache, "any")


@special_form("all_match")
def _all_match(expr, ctx, cache):
    return _match_reduce(expr, ctx, cache, "all")


@special_form("none_match")
def _none_match(expr, ctx, cache):
    return _match_reduce(expr, ctx, cache, "none")


# type resolvers for the special forms (evaluation is intercepted above;
# the registry only answers return types for plan construction)
def _no_eval(*a, **k):
    raise AssertionError("special form must intercept")


_register("transform", sig("array(T), U -> array(U)"), _no_eval)
_register("filter", sig("array(T), any -> array(T)"), _no_eval)
for _n in ("any_match", "all_match", "none_match"):
    _register(_n, sig("array(T), any -> boolean"), _no_eval)


# ---- order/dedup array functions ------------------------------------------

def _per_row_sorted_perm(arr: EvalValue, ctx, desc=False):
    """Element permutation sorting each row's elements by value (stable;
    elements stay within their row: row index is the leading sort key)."""
    from velox_tpu.exec.sort import radix_sort_perm, value_words
    child = arr.children[0]
    ecap = child.capacity
    row_c, in_row = _element_row_map(arr, ctx)
    elem_t = arr.dtype.children[0]
    ev = EvalValue(child.data, child.validity, elem_t, child.dictionary)
    words = [jnp.where(in_row, row_c, jnp.int32(ctx.capacity))
             .astype(jnp.uint32)]
    bits = [max(1, int(ctx.capacity + 1).bit_length())]
    null_w = None
    if child.validity is not None:
        null_w = (~child.validity).astype(jnp.uint32)
    vw = value_words(ev, ecap)
    if desc:
        vw = [~w for w in vw]
    if null_w is not None:
        words.append(null_w)  # nulls last within row
        bits.append(1)
    words.extend(vw)
    bits.extend([32] * len(vw))
    return radix_sort_perm(words, bits, ecap), row_c, in_row


def _array_sort_eval(ctx, out_dtype, args):
    raise AssertionError("special form must intercept")


@special_form("array_sort")
def _array_sort(expr, ctx, cache):
    arr = _eval_expr(expr.args[0], ctx, cache)
    child = arr.children[0]
    perm, row_c, in_row = _per_row_sorted_perm(arr, ctx)
    from velox_tpu.vector.device import DeviceColumn as _DC
    data = child.data[perm]
    validity = child.validity[perm] if child.validity is not None else None
    new_child = _DC(data, validity, arr.dtype.children[0],
                    child.dictionary)
    return EvalValue(arr.data, arr.validity, arr.dtype,
                     children=(new_child,))


@special_form("array_distinct")
def _array_distinct(expr, ctx, cache):
    """Distinct elements per row in FIRST-OCCURRENCE order (Presto
    semantics): duplicates are detected in (row, value)-sorted space —
    the stable sort makes the first occurrence the run head — and the
    keep flags scatter back to original element order for compaction."""
    arr = _eval_expr(expr.args[0], ctx, cache)
    child = arr.children[0]
    ecap = child.capacity
    perm, row_c, in_row = _per_row_sorted_perm(arr, ctx)
    data_s = child.data[perm]
    row_all = jnp.where(in_row, row_c, jnp.int32(ctx.capacity))
    row_s = row_all[perm]
    valid_s = (child.validity[perm] if child.validity is not None
               else jnp.ones((ecap,), bool))
    prev_d = jnp.concatenate([data_s[:1], data_s[:-1]])
    prev_r = jnp.concatenate([jnp.full((1,), -1, row_s.dtype), row_s[:-1]])
    prev_v = jnp.concatenate([valid_s[:1], valid_s[:-1]])
    first = (row_s != prev_r) | (data_s != prev_d) | (prev_v != valid_s)
    first = first.at[0].set(True)
    keep_sorted = first & (row_s < ctx.capacity)
    # back to original element order, then prefix-compact (preserves
    # first-occurrence order because elements stay row-contiguous)
    keep = jnp.zeros((ecap,), bool).at[perm].set(keep_sorted)
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, jnp.int32(ecap))
    new_data = jnp.zeros_like(child.data).at[tgt].set(child.data,
                                                      mode="drop")
    new_validity = None
    if child.validity is not None:
        new_validity = jnp.ones((ecap,), bool).at[tgt].set(
            child.validity, mode="drop")
    new_lens = jax.ops.segment_sum(
        keep.astype(jnp.int32), row_all,
        num_segments=ctx.capacity + 1)[:ctx.capacity]
    from velox_tpu.vector.device import DeviceColumn as _DC
    new_child = _DC(new_data, new_validity, arr.dtype.children[0],
                    child.dictionary)
    return EvalValue(new_lens, arr.validity, arr.dtype,
                     children=(new_child,))


_register("array_sort", sig("array(T) -> array(T)"), _array_sort_eval)
_register("array_distinct", sig("array(T) -> array(T)"), _array_sort_eval)


def _array_extreme(ctx, arr, combine):
    child = arr.children[0]
    ecap = child.capacity
    row_c, in_row = _element_row_map(arr, ctx)
    seg = jnp.where(in_row, row_c, jnp.int32(ctx.capacity))
    has_null = jnp.zeros((ctx.capacity,), bool)
    if child.validity is not None:
        has_null = jax.ops.segment_max(
            (in_row & ~child.validity).astype(jnp.int32), seg,
            num_segments=ctx.capacity + 1)[:ctx.capacity] > 0
        seg = jnp.where(in_row & child.validity, row_c,
                        jnp.int32(ctx.capacity))
    op = jax.ops.segment_min if combine == "min" else jax.ops.segment_max
    red = op(child.data, seg, num_segments=ctx.capacity + 1)[:ctx.capacity]
    n = jax.ops.segment_sum(jnp.ones_like(seg), seg,
                            num_segments=ctx.capacity + 1)[:ctx.capacity]
    # Presto: NULL element -> NULL result; empty array -> NULL
    validity = (n > 0) & ~has_null
    if arr.validity is not None:
        validity = validity & arr.validity
    elem_t = arr.dtype.children[0]
    return EvalValue(red, validity, elem_t, child.dictionary)


def _array_max_eval(ctx, out_dtype, args):
    return _array_extreme(ctx, args[0], "max")


def _array_min_eval(ctx, out_dtype, args):
    return _array_extreme(ctx, args[0], "min")


_register("array_max", sig("array(T) -> T"), _array_max_eval)
_register("array_min", sig("array(T) -> T"), _array_min_eval)


def _map_child_eval(which):
    def eval_fn(ctx, out_dtype, args):
        (m,) = args
        child = m.children[which]
        return EvalValue(m.data, m.validity, out_dtype,
                         children=(child,),
                         starts=getattr(m, "starts", None))
    return eval_fn


_register("map_keys", sig("map(K, V) -> array(K)"), _map_child_eval(0))
_register("map_values", sig("map(K, V) -> array(V)"), _map_child_eval(1))


# ---------------------------------------------------------------------------
# ROW (struct) field access. Parity: velox FieldReference on ROW inputs
# (expression/FieldReference.h) / Presto row.field dereference.
# ---------------------------------------------------------------------------

def _get_field_eval(ctx, out_dtype, args):
    row, fname = args[0], args[1]
    name = fname.py_value
    i = list(row.dtype.names).index(name)
    child = row.children[i]
    validity = child.validity
    if row.validity is not None:
        validity = (row.validity if validity is None
                    else (validity & row.validity))
    return EvalValue(child.data, validity, row.dtype.children[i],
                     child.dictionary, children=child.children,
                     starts=getattr(child, "starts", None))


def _get_field_resolver(ts):
    if len(ts) == 2 and ts[0].kind is T.TypeKind.ROW:
        return T.UNKNOWN  # refined by the parser (needs the field name)
    return None


_register("get_field", _get_field_resolver, _get_field_eval)


# ---------------------------------------------------------------------------
# Map higher-order functions + zip_with + reduce.
#
# Role parity: velox/functions/prestosql MapFilter.cpp / TransformKeys.cpp /
# TransformValues.cpp / ZipWith.cpp / Reduce.cpp. All element-space (see the
# lambda design note above); reduce is the one inherently sequential HOF and
# runs a lax.while_loop over element positions (bounded by the longest row),
# applying the combine lambda to ALL rows at position i per step — the dense
# analogue of the reference's row-set iteration (Reduce.cpp applies the
# lambda maxLength times over shrinking selectivity vectors).
# ---------------------------------------------------------------------------


def _compact_children(children, keep, row_all, ecap, capacity, elem_ts):
    """Prefix-compact flattened element columns by a keep mask; returns
    (new_children, new_lens)."""
    from velox_tpu.vector.device import DeviceColumn as _DC
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, jnp.int32(ecap))
    outs = []
    for child, et in zip(children, elem_ts):
        nd = jnp.zeros_like(child.data).at[tgt].set(child.data, mode="drop")
        nv = None
        if child.validity is not None:
            nv = jnp.ones((ecap,), bool).at[tgt].set(child.validity,
                                                     mode="drop")
        outs.append(_DC(nd, nv, et, child.dictionary))
    new_lens = jax.ops.segment_sum(
        keep.astype(jnp.int32), row_all,
        num_segments=capacity + 1)[:capacity]
    return tuple(outs), new_lens


@special_form("map_filter")
def _map_filter(expr, ctx, cache):
    m = _eval_expr(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval_map(lam, m, ctx)
    ecap = m.children[0].capacity
    keep = out.full_data(ecap).astype(bool) & in_row
    if out.validity is not None:
        keep = keep & out.full_validity(ecap)
    row_all = jnp.where(in_row, row_c, jnp.int32(ctx.capacity))
    children, new_lens = _compact_children(
        m.children, keep, row_all, ecap, ctx.capacity, m.dtype.children)
    return EvalValue(new_lens, m.validity, m.dtype, children=children)


@special_form("transform_values")
def _transform_values(expr, ctx, cache):
    m = _eval_expr(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval_map(lam, m, ctx)
    ecap = m.children[0].capacity
    from velox_tpu.vector.device import DeviceColumn as _DC
    nv = _DC(out.full_data(ecap), out.validity, lam.dtype, out.dictionary)
    return EvalValue(m.data, m.validity, expr.dtype,
                     children=(m.children[0], nv))


@special_form("transform_keys")
def _transform_keys(expr, ctx, cache):
    m = _eval_expr(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval_map(lam, m, ctx)
    ecap = m.children[0].capacity
    # Presto: transformed keys must not be NULL (TransformKeys.cpp)
    if out.validity is not None:
        ctx.flag_error(jax.ops.segment_max(
            (in_row & ~out.full_validity(ecap)).astype(jnp.int32),
            jnp.where(in_row, row_c, ctx.capacity),
            num_segments=ctx.capacity + 1)[:ctx.capacity] > 0)
    from velox_tpu.vector.device import DeviceColumn as _DC
    nk = _DC(out.full_data(ecap), None, lam.dtype, out.dictionary)
    return EvalValue(m.data, m.validity, expr.dtype,
                     children=(nk, m.children[1]))


@special_form("zip_with")
def _zip_with(expr, ctx, cache):
    """zip_with(a, b, (x, y) -> z): per-row positional zip; the shorter
    row pads with NULLs (Presto semantics). Output element space is a
    fresh layout of capacity ecap1+ecap2 (sum of max-per-row bounds)."""
    a1 = _eval_expr(expr.args[0], ctx, cache)
    a2 = _eval_expr(expr.args[1], ctx, cache)
    lam = expr.args[2]
    c1, c2 = a1.children[0], a2.children[0]
    cap = ctx.capacity
    l1 = a1.data.astype(jnp.int32)
    l2 = a2.data.astype(jnp.int32)
    out_lens = jnp.maximum(l1, l2)
    ocap = c1.capacity + c2.capacity
    ostarts = jnp.cumsum(out_lens) - out_lens
    e = jnp.arange(ocap, dtype=jnp.int32)
    row = jnp.searchsorted(ostarts, e, side="right").astype(jnp.int32) - 1
    row_c = jnp.clip(row, 0, cap - 1)
    p = e - ostarts[row_c]
    in_row = (p >= 0) & (p < out_lens[row_c])
    row_valid = None
    for a in (a1, a2):
        if a.validity is not None:
            row_valid = (a.validity if row_valid is None
                         else row_valid & a.validity)
    if row_valid is not None:
        in_row = in_row & row_valid[row_c]

    def _side(a, child, ln):
        starts = _offsets(a)
        idx = jnp.clip(starts[row_c] + p, 0, child.capacity - 1)
        have = in_row & (p < ln[row_c])
        valid = have if child.validity is None \
            else have & child.validity[idx]
        et = a.dtype.children[0]
        return EvalValue(child.data[idx], valid, et, child.dictionary)

    binds = [(lam.params[0], _side(a1, c1, l1)),
             (lam.params[1], _side(a2, c2, l2))]
    cols = _LiftedColumns(ctx.columns, row_c, ocap)
    for name, val in binds:
        cols[name] = val
    ectx = _EvalCtx(cols, ocap)
    out = _eval_expr(lam.body, ectx, {})
    if ectx.errors is not None:
        ctx.flag_error(jax.ops.segment_max(
            (ectx.errors & in_row).astype(jnp.int32),
            jnp.where(in_row, row_c, cap),
            num_segments=cap + 1)[:cap] > 0)
    from velox_tpu.vector.device import DeviceColumn as _DC
    nc = _DC(out.full_data(ocap), out.validity, lam.dtype, out.dictionary)
    return EvalValue(out_lens, row_valid, expr.dtype, children=(nc,))


@special_form("reduce")
def _reduce_hof(expr, ctx, cache):
    """reduce(array, init, (s, x) -> s', s -> out).

    Sequential fold per row, vectorised ACROSS rows: a lax.while_loop over
    element positions 0..max(row length); step i applies the combine lambda
    to every row's i-th element at once (inactive rows carry state through).
    Parity: prestosql Reduce.cpp (iterative lambda application)."""
    arr = _eval_expr(expr.args[0], ctx, cache)
    init = _eval_expr(expr.args[1], ctx, cache)
    comb, outf = expr.args[2], expr.args[3]
    child = arr.children[0]
    cap = ctx.capacity
    if child.dictionary is not None or init.dictionary is not None:
        raise NotImplementedError("reduce over string state")
    lens = arr.data.astype(jnp.int32)
    starts = _offsets(arr)
    maxlen = jnp.max(lens)
    state_t = comb.dtype
    s0 = init.full_data(cap).astype(state_t.np_dtype())
    sv0 = (init.full_validity(cap) if init.validity is not None
           else jnp.ones((cap,), bool))
    err0 = jnp.zeros((cap,), bool)
    elem_t = arr.dtype.children[0]

    def body(carry):
        i, s, sv, err = carry
        idx = jnp.clip(starts + i, 0, child.capacity - 1)
        active = i < lens
        x = child.data[idx]
        xv = active if child.validity is None \
            else active & child.validity[idx]
        cols = dict(ctx.columns)
        cols[comb.params[0]] = EvalValue(s, sv, state_t)
        cols[comb.params[1]] = EvalValue(x, xv, elem_t)
        ectx = _EvalCtx(cols, cap)
        out = _eval_expr(comb.body, ectx, {})
        od = out.full_data(cap).astype(s.dtype)
        ov = (out.full_validity(cap) if out.validity is not None
              else jnp.ones((cap,), bool))
        ns = jnp.where(active, od, s)
        nsv = jnp.where(active, ov, sv)
        nerr = err if ectx.errors is None else err | (ectx.errors & active)
        return i + jnp.int32(1), ns, nsv, nerr

    _, s, sv, err = jax.lax.while_loop(
        lambda c: c[0] < maxlen, body, (jnp.int32(0), s0, sv0, err0))
    ctx.flag_error(err)
    cols = dict(ctx.columns)
    cols[outf.params[0]] = EvalValue(s, sv, state_t)
    ectx2 = _EvalCtx(cols, cap)
    res = _eval_expr(outf.body, ectx2, {})
    if ectx2.errors is not None:
        ctx.flag_error(ectx2.errors)
    validity = res.validity
    if arr.validity is not None:
        fv = (res.full_validity(cap) if validity is not None
              else jnp.ones((cap,), bool))
        validity = fv & arr.validity
    return EvalValue(res.full_data(cap), validity, expr.dtype,
                     res.dictionary)


_register("map_filter", sig("map(K, V), any -> map(K, V)"), _no_eval)
_register("transform_values",
          sig("map(K, V), U -> map(K, U)"), _no_eval)
_register("transform_keys",
          sig("map(K, V), U -> map(U, V)"), _no_eval)
_register("zip_with", sig("array(T), array(U), V -> array(V)"), _no_eval)
_register("reduce", sig("array(T), A, B, C -> C"), _no_eval)


# ---------------------------------------------------------------------------
# Round-3 array batch: position/remove/slice/concat/flatten/map_entries/
# arrays_overlap. Parity: prestosql ArrayFunctions (ArrayPositionFunction,
# ArrayRemoveFunction, SliceFunction, ArrayConcatFunction,
# ArrayFlattenFunction, MapEntriesFunction, ArraysOverlapFunction).
# ---------------------------------------------------------------------------

def _unify_dicts(ca, cb):
    """(dictionary, data_a, data_b): remap two dictionary-id columns
    onto ONE merged sorted dictionary so ids compare across columns
    (host work is O(distinct), trace-time — the same cost class as
    dictionary construction itself)."""
    if ca.dictionary is None or cb.dictionary is None \
            or ca.dictionary is cb.dictionary:
        return (ca.dictionary if ca.dictionary is not None
                else cb.dictionary), ca.data, cb.data
    from velox_tpu.vector.device import Dictionary
    va = ca.dictionary.values
    vb = cb.dictionary.values
    merged = sorted(set(va.tolist()) | set(vb.tolist()))
    idx = {v: i for i, v in enumerate(merged)}
    ra = np.array([idx[v] for v in va], np.int32)
    rb = np.array([idx[v] for v in vb], np.int32)
    d = Dictionary(merged)
    d.is_sorted = True
    return d, jnp.asarray(ra)[ca.data.astype(jnp.int32)], \
        jnp.asarray(rb)[cb.data.astype(jnp.int32)]


def _elem_hit(ctx, arr, x, row_c, in_row, ecap):
    """Element-space equality mask vs a (possibly per-row) needle."""
    child = arr.children[0]
    elem_val = EvalValue(child.data, child.validity,
                         arr.dtype.children[0], child.dictionary)
    if x.data is not None and getattr(x.data, "ndim", 0) > 0:
        xv = x.data[row_c]
        xvalid = (x.validity[row_c]
                  if x.validity is not None and x.validity.ndim > 0
                  else x.validity)
        x = EvalValue(xv, xvalid, x.dtype, x.dictionary)

    class _ECtx:
        capacity = ecap
    eq = eq_value(_ECtx, elem_val, x)
    hit = eq.data.astype(bool)
    if eq.validity is not None:
        hit = hit & eq.validity
    return hit & in_row


def _compact_elements(arr, keep, row_c, in_row, ctx):
    """Prefix-compact kept elements (row-contiguity preserved) ->
    (new_lengths, new_child)."""
    child = arr.children[0]
    ecap = child.capacity
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, jnp.int32(ecap))
    new_data = jnp.zeros_like(child.data).at[tgt].set(child.data,
                                                      mode="drop")
    new_validity = None
    if child.validity is not None:
        new_validity = jnp.ones((ecap,), bool).at[tgt].set(
            child.validity, mode="drop")
    seg = jnp.where(in_row, row_c, jnp.int32(ctx.capacity))
    new_lens = jax.ops.segment_sum(
        keep.astype(jnp.int32), seg,
        num_segments=ctx.capacity + 1)[:ctx.capacity]
    from velox_tpu.vector.device import DeviceColumn as _DC
    new_child = _DC(new_data, new_validity, arr.dtype.children[0],
                    child.dictionary)
    return new_lens, new_child


def _array_position_eval(ctx, out_dtype, args):
    arr, x = args
    child = arr.children[0]
    ecap = child.capacity
    row_c, in_row = _element_row_map(arr, ctx)
    starts = _offsets(arr)
    hit = _elem_hit(ctx, arr, x, row_c, in_row, ecap)
    e = jnp.arange(ecap, dtype=jnp.int32)
    within = e - starts[row_c] + 1  # 1-based
    seg = jnp.where(hit, row_c, jnp.int32(ctx.capacity))
    first = jax.ops.segment_min(
        jnp.where(hit, within, jnp.int32(ecap + 1)), seg,
        num_segments=ctx.capacity + 1)[:ctx.capacity]
    data = jnp.where(first > ecap, 0, first).astype(jnp.int64)
    return EvalValue(data, merge_validity(arr, x), T.BIGINT)


register("array_position", sig("array(T), T -> bigint"),
         _array_position_eval)


def _array_remove_eval(ctx, out_dtype, args):
    arr, x = args
    child = arr.children[0]
    row_c, in_row = _element_row_map(arr, ctx)
    hit = _elem_hit(ctx, arr, x, row_c, in_row, child.capacity)
    keep = in_row & ~hit
    new_lens, new_child = _compact_elements(arr, keep, row_c, in_row, ctx)
    return EvalValue(new_lens, merge_validity(arr, x), arr.dtype,
                     children=(new_child,))


register("array_remove", sig("array(T), T -> array(T)"),
         _array_remove_eval)


def _slice_eval(ctx, out_dtype, args):
    arr, start, length = args
    child = arr.children[0]
    ecap = child.capacity
    row_c, in_row = _element_row_map(arr, ctx)
    starts = _offsets(arr)
    lens = arr.data.astype(jnp.int32)[row_c]
    s = start.full_data(ctx.capacity).astype(jnp.int32)[row_c]
    ln = length.full_data(ctx.capacity).astype(jnp.int32)[row_c]
    e = jnp.arange(ecap, dtype=jnp.int32)
    pos = e - starts[row_c]            # 0-based position in row
    begin = jnp.where(s > 0, s - 1, lens + s)
    keep = in_row & (pos >= begin) & (pos < begin + ln) & (s != 0)
    new_lens, new_child = _compact_elements(arr, keep, row_c, in_row, ctx)
    return EvalValue(new_lens, merge_validity(arr, start, length),
                     arr.dtype, children=(new_child,))


register("slice", sig("array(T), integral, integral -> array(T)"),
         _slice_eval)


def _array_concat_eval(ctx, out_dtype, args):
    a, b = args
    ca, cb = a.children[0], b.children[0]
    shared_dict, da_data, db_data = _unify_dicts(ca, cb)
    from velox_tpu.vector.device import DeviceColumn as _DC0
    ca = _DC0(da_data, ca.validity, ca.dtype, shared_dict, ca.children)
    cb = _DC0(db_data, cb.validity, cb.dtype, shared_dict, cb.children)
    la = a.data.astype(jnp.int32)
    lb = b.data.astype(jnp.int32)
    lo = la + lb
    starts_out = jnp.cumsum(lo) - lo
    out_cap = ca.capacity + cb.capacity
    row_a, in_a = _element_row_map(a, ctx)
    row_b, in_b = _element_row_map(b, ctx)
    ea = jnp.arange(ca.capacity, dtype=jnp.int32)
    eb = jnp.arange(cb.capacity, dtype=jnp.int32)
    pos_a = ea - _offsets(a)[row_a]
    pos_b = eb - _offsets(b)[row_b]
    tgt_a = jnp.where(in_a, starts_out[row_a] + pos_a,
                      jnp.int32(out_cap))
    tgt_b = jnp.where(in_b, starts_out[row_b] + la[row_b] + pos_b,
                      jnp.int32(out_cap))
    data = jnp.zeros((out_cap + 1,), ca.data.dtype) \
        .at[tgt_a].set(ca.data, mode="drop") \
        .at[tgt_b].set(cb.data, mode="drop")[:out_cap]
    validity = None
    if ca.validity is not None or cb.validity is not None:
        va = ca.validity if ca.validity is not None \
            else jnp.ones((ca.capacity,), bool)
        vb = cb.validity if cb.validity is not None \
            else jnp.ones((cb.capacity,), bool)
        validity = jnp.ones((out_cap + 1,), bool) \
            .at[tgt_a].set(va, mode="drop") \
            .at[tgt_b].set(vb, mode="drop")[:out_cap]
    from velox_tpu.vector.device import DeviceColumn as _DC
    new_child = _DC(data, validity, a.dtype.children[0], shared_dict)
    return EvalValue(lo, merge_validity(a, b), a.dtype,
                     children=(new_child,))


register("concat", sig("array(T), array(T) -> array(T)"),
         _array_concat_eval)


def _flatten_eval(ctx, out_dtype, args):
    (arr,) = args           # array(array(T))
    inner = arr.children[0]  # ARRAY column in outer-element space
    row_c, in_row = _element_row_map(arr, ctx)   # outer elem -> row

    # inner elements -> outer element map (same machinery, one level in)
    class _OCtx:
        capacity = inner.capacity
    inner_val = EvalValue(inner.data, inner.validity,
                          arr.dtype.children[0],
                          children=inner.children)
    oe_of_ie, in_inner = _element_row_map(inner_val, _OCtx)
    keep = in_inner & in_row[oe_of_ie]
    row_of_ie = row_c[oe_of_ie]
    leaf = inner.children[0]
    iecap = leaf.capacity
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, jnp.int32(iecap))
    data = jnp.zeros_like(leaf.data).at[tgt].set(leaf.data, mode="drop")
    validity = None
    if leaf.validity is not None:
        validity = jnp.ones((iecap,), bool).at[tgt].set(
            leaf.validity, mode="drop")
    seg = jnp.where(keep, row_of_ie, jnp.int32(ctx.capacity))
    new_lens = jax.ops.segment_sum(
        keep.astype(jnp.int32), seg,
        num_segments=ctx.capacity + 1)[:ctx.capacity]
    from velox_tpu.vector.device import DeviceColumn as _DC
    new_child = _DC(data, validity, out_dtype.children[0],
                    leaf.dictionary)
    return EvalValue(new_lens, arr.validity, out_dtype,
                     children=(new_child,))


register("flatten", sig("array(array(T)) -> array(T)"), _flatten_eval)


def _map_entries_eval(ctx, out_dtype, args):
    (m,) = args
    kchild, vchild = m.children
    from velox_tpu.vector.device import DeviceColumn as _DC
    rt = out_dtype.children[0]  # row(K, V)
    row_child = _DC(jnp.zeros((kchild.capacity,), jnp.int32), None, rt,
                    None, (kchild, vchild))
    return EvalValue(m.data, m.validity, out_dtype,
                     starts=getattr(m, "starts", None),
                     children=(row_child,))


register("map_entries",
         sig("map(K, V) -> array(row(K, V))"), _map_entries_eval)


def _arrays_overlap_eval(ctx, out_dtype, args):
    """true if a common non-null element exists; NULL when no overlap
    but either side contains a null element (Presto semantics)."""
    from velox_tpu.exec.sort import radix_sort_perm, value_words
    a, b = args
    ca, cb = a.children[0], b.children[0]
    shared_dict, da_data, db_data = _unify_dicts(ca, cb)
    row_a, in_a = _element_row_map(a, ctx)
    row_b, in_b = _element_row_map(b, ctx)
    n = ca.capacity + cb.capacity
    va = ca.validity if ca.validity is not None \
        else jnp.ones((ca.capacity,), bool)
    vb = cb.validity if cb.validity is not None \
        else jnp.ones((cb.capacity,), bool)
    rows = jnp.concatenate([jnp.where(in_a & va, row_a,
                                      jnp.int32(ctx.capacity)),
                            jnp.where(in_b & vb, row_b,
                                      jnp.int32(ctx.capacity))])
    src_b = jnp.concatenate([jnp.zeros((ca.capacity,), bool),
                             jnp.ones((cb.capacity,), bool)])
    et = a.dtype.children[0]
    vals = EvalValue(
        jnp.concatenate([da_data.astype(et.np_dtype()),
                         db_data.astype(et.np_dtype())]),
        None, et, shared_dict)
    words = [rows.astype(jnp.uint32)]
    bits = [max(1, int(ctx.capacity + 1).bit_length())]
    vw = value_words(vals, n)
    words.extend(vw)
    bits.extend([32] * len(vw))
    perm = radix_sort_perm(words, bits, n)
    rows_s = rows[perm]
    data_s = vals.data[perm]
    src_s = src_b[perm]
    prev_same = jnp.concatenate([
        jnp.zeros((1,), bool),
        (rows_s[1:] == rows_s[:-1]) & (data_s[1:] == data_s[:-1])])
    run_id = jnp.cumsum((~prev_same).astype(jnp.int32)) - 1
    has_a = jax.ops.segment_max((~src_s).astype(jnp.int32), run_id,
                                num_segments=n)
    has_b = jax.ops.segment_max(src_s.astype(jnp.int32), run_id,
                                num_segments=n)
    both = (has_a + has_b == 2)[run_id] & (rows_s < ctx.capacity)
    seg = jnp.where(rows_s < ctx.capacity, rows_s,
                    jnp.int32(ctx.capacity))
    overlap = jax.ops.segment_max(
        both.astype(jnp.int32), seg,
        num_segments=ctx.capacity + 1)[:ctx.capacity] > 0
    # null handling: no overlap + a null element on either side -> NULL
    has_null = jnp.zeros((ctx.capacity,), bool)
    for (cc, rr, ii) in ((ca, row_a, in_a), (cb, row_b, in_b)):
        if cc.validity is not None:
            s = jnp.where(ii, rr, jnp.int32(ctx.capacity))
            hn = jax.ops.segment_max(
                (ii & ~cc.validity).astype(jnp.int32), s,
                num_segments=ctx.capacity + 1)[:ctx.capacity] > 0
            has_null = has_null | hn
    validity = overlap | ~has_null
    mv = merge_validity(a, b)
    if mv is not None:
        validity = validity & mv
    return EvalValue(overlap, validity, T.BOOLEAN)


register("arrays_overlap", sig("array(T), array(T) -> boolean"),
         _arrays_overlap_eval)


def _array_setop(ctx, a, b, mode, out_dtype):
    """intersect/union/except over the combined (row, null, value)-sorted
    element stream: one stable sort, per-run has_a/has_b, emit run heads
    that satisfy the mode. Output elements are value-sorted within each
    row (Presto leaves set-op ordering unspecified); null elements
    compare equal to each other (Presto set semantics)."""
    from velox_tpu.exec.sort import radix_sort_perm, value_words
    ca, cb = a.children[0], b.children[0]
    shared_dict, da_data, db_data = _unify_dicts(ca, cb)
    row_a, in_a = _element_row_map(a, ctx)
    row_b, in_b = _element_row_map(b, ctx)
    n = ca.capacity + cb.capacity
    rows = jnp.concatenate([jnp.where(in_a, row_a, jnp.int32(ctx.capacity)),
                            jnp.where(in_b, row_b, jnp.int32(ctx.capacity))])
    src_b = jnp.concatenate([jnp.zeros((ca.capacity,), bool),
                             jnp.ones((cb.capacity,), bool)])
    va = ca.validity if ca.validity is not None \
        else jnp.ones((ca.capacity,), bool)
    vb = cb.validity if cb.validity is not None \
        else jnp.ones((cb.capacity,), bool)
    valid = jnp.concatenate([va, vb])
    et = a.dtype.children[0]
    raw = jnp.concatenate([da_data.astype(et.np_dtype()),
                           db_data.astype(et.np_dtype())])
    vals = EvalValue(jnp.where(valid, raw, jnp.zeros_like(raw)), None,
                     et, shared_dict)
    words = [rows.astype(jnp.uint32),
             (~valid).astype(jnp.uint32)]  # nulls sort after values
    bits = [max(1, int(ctx.capacity + 1).bit_length()), 1]
    vw = value_words(vals, n)
    words.extend(vw)
    bits.extend([32] * len(vw))
    perm = radix_sort_perm(words, bits, n)
    rows_s = rows[perm]
    data_s = vals.data[perm]
    valid_s = valid[perm]
    src_s = src_b[perm]
    prev_same = jnp.concatenate([
        jnp.zeros((1,), bool),
        (rows_s[1:] == rows_s[:-1]) & (data_s[1:] == data_s[:-1])
        & (valid_s[1:] == valid_s[:-1])])
    head = ~prev_same
    run_id = jnp.cumsum(head.astype(jnp.int32)) - 1
    has_a = jax.ops.segment_max((~src_s).astype(jnp.int32), run_id,
                                num_segments=n) > 0
    has_b = jax.ops.segment_max(src_s.astype(jnp.int32), run_id,
                                num_segments=n) > 0
    if mode == "intersect":
        want = has_a & has_b
    elif mode == "union":
        want = has_a | has_b
    else:  # except: in a, not in b
        want = has_a & ~has_b
    keep = head & want[run_id] & (rows_s < ctx.capacity)
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, jnp.int32(n))
    out_data = jnp.zeros((n + 1,), raw.dtype) \
        .at[tgt].set(data_s, mode="drop")[:n]
    out_valid = jnp.ones((n + 1,), bool) \
        .at[tgt].set(valid_s, mode="drop")[:n]
    seg = jnp.where(rows_s < ctx.capacity, rows_s, jnp.int32(ctx.capacity))
    new_lens = jax.ops.segment_sum(
        keep.astype(jnp.int32), seg,
        num_segments=ctx.capacity + 1)[:ctx.capacity]
    from velox_tpu.vector.device import DeviceColumn as _DC
    new_child = _DC(out_data, out_valid, et, shared_dict)
    return EvalValue(new_lens, merge_validity(a, b), out_dtype,
                     children=(new_child,))


def _setop_eval(mode):
    def eval_fn(ctx, out_dtype, args):
        return _array_setop(ctx, args[0], args[1], mode, out_dtype)
    return eval_fn


register("array_intersect", sig("array(T), array(T) -> array(T)"),
         _setop_eval("intersect"))
register("array_union", sig("array(T), array(T) -> array(T)"),
         _setop_eval("union"))
register("array_except", sig("array(T), array(T) -> array(T)"),
         _setop_eval("except"))


def _map_concat_eval(ctx, out_dtype, args):
    """map_concat(m1, m2): union of entries, m2 wins duplicate keys.
    Same combined-run machinery as the array set ops, but the kept
    entry is the run TAIL (stable sort puts m1 before m2 in a run, so
    the tail is m2's entry when both sides carry the key). Ref
    prestosql MapConcatFunction."""
    from velox_tpu.exec.sort import radix_sort_perm, value_words
    a, b = args
    ka, va_ = a.children
    kb, vb_ = b.children
    kdict, ka_data, kb_data = _unify_dicts(ka, kb)
    vdict, va_data, vb_data = _unify_dicts(va_, vb_)
    row_a, in_a = _element_row_map(a, ctx)
    row_b, in_b = _element_row_map(b, ctx)
    n = ka.capacity + kb.capacity
    rows = jnp.concatenate([jnp.where(in_a, row_a, jnp.int32(ctx.capacity)),
                            jnp.where(in_b, row_b, jnp.int32(ctx.capacity))])
    kt = a.dtype.children[0]
    keys = EvalValue(jnp.concatenate([ka_data.astype(kt.np_dtype()),
                                      kb_data.astype(kt.np_dtype())]),
                     None, kt, kdict)
    vdata = jnp.concatenate([va_data, vb_data])
    vvalid = None
    if va_.validity is not None or vb_.validity is not None:
        vvalid = jnp.concatenate([
            va_.validity if va_.validity is not None
            else jnp.ones((ka.capacity,), bool),
            vb_.validity if vb_.validity is not None
            else jnp.ones((kb.capacity,), bool)])
    words = [rows.astype(jnp.uint32)]
    bits = [max(1, int(ctx.capacity + 1).bit_length())]
    vw = value_words(keys, n)
    words.extend(vw)
    bits.extend([32] * len(vw))
    perm = radix_sort_perm(words, bits, n)
    rows_s = rows[perm]
    keys_s = keys.data[perm]
    next_same = jnp.concatenate([
        (rows_s[1:] == rows_s[:-1]) & (keys_s[1:] == keys_s[:-1]),
        jnp.zeros((1,), bool)])
    keep = ~next_same & (rows_s < ctx.capacity)  # run TAILS
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, jnp.int32(n))
    out_k = jnp.zeros((n + 1,), keys.data.dtype) \
        .at[tgt].set(keys_s, mode="drop")[:n]
    vdata_s = vdata[perm]
    out_v = jnp.zeros((n + 1,), vdata.dtype) \
        .at[tgt].set(vdata_s, mode="drop")[:n]
    out_vv = None
    if vvalid is not None:
        out_vv = jnp.ones((n + 1,), bool) \
            .at[tgt].set(vvalid[perm], mode="drop")[:n]
    seg = jnp.where(rows_s < ctx.capacity, rows_s, jnp.int32(ctx.capacity))
    new_lens = jax.ops.segment_sum(
        keep.astype(jnp.int32), seg,
        num_segments=ctx.capacity + 1)[:ctx.capacity]
    from velox_tpu.vector.device import DeviceColumn as _DC
    kchild = _DC(out_k, None, kt, kdict)
    vchild = _DC(out_v, out_vv, a.dtype.children[1], vdict)
    return EvalValue(new_lens, merge_validity(a, b), out_dtype,
                     children=(kchild, vchild))


register("map_concat", sig("map(K, V), map(K, V) -> map(K, V)"),
         _map_concat_eval)


@special_form("map_zip_with")
def _map_zip_with(expr, ctx, cache):
    """map_zip_with(m1, m2, (k, v1, v2) -> r): merge by KEY UNION; keys
    present in only one map see NULL for the other value. Parity:
    prestosql MapZipWithFunction. Concatenate both entry
    streams, ONE sort by (row, key, source) over the combined element
    space, and read each union key's v1/v2 off the <=2-entry runs
    (map keys are unique per map by construction)."""
    from velox_tpu.exec.sort import (
        lane_bit_widths, lane_prefix_neq, sort_perm_key, sort_words,
    )
    from velox_tpu.ops.wide import scatter_unique_set
    from velox_tpu.vector.device import DeviceColumn as _DC

    m1 = _eval_expr(expr.args[0], ctx, cache)
    m2 = _eval_expr(expr.args[1], ctx, cache)
    lam = expr.args[2]
    _require_dense(m1, "map_zip_with")
    _require_dense(m2, "map_zip_with")
    cap = ctx.capacity
    k1, v1c = m1.children
    k2, v2c = m2.children
    kdict, k1d, k2d = _unify_dicts(k1, k2)
    E1, E2 = k1.capacity, k2.capacity
    M = E1 + E2
    row1, in1 = _element_row_map(m1, ctx)
    row2, in2 = _element_row_map(m2, ctx)
    rows = jnp.concatenate([row1, row2]).astype(jnp.int32)
    ink = jnp.concatenate([in1, in2])
    kt = m1.dtype.children[0]
    if kt.is_string:
        kdata = jnp.concatenate([k1d.astype(jnp.int32),
                                 k2d.astype(jnp.int32)])
    else:
        common = np.result_type(np.dtype(k1.data.dtype),
                                np.dtype(k2.data.dtype))
        kdata = jnp.concatenate([k1.data.astype(common),
                                 k2.data.astype(common)])
    src = jnp.concatenate([jnp.zeros((E1,), bool), jnp.ones((E2,), bool)])
    key_ev = EvalValue(kdata, None, kt, kdict)
    row_ev = EvalValue(rows, None, T.INTEGER)
    src_ev = EvalValue(src, None, T.BOOLEAN)
    words, bits = sort_words([row_ev, key_ev, src_ev], None, M, ink,
                             ranges=((0, max(1, cap - 1)), None, None))
    perm, skey = sort_perm_key(words, bits, M)
    total = int(sum(bits))
    boundary = lane_prefix_neq(skey, lane_bit_widths(total),
                               total - 1)  # (row, key) runs: drop src
    ink_s = ink[perm]
    rows_s = jnp.clip(rows[perm], 0, cap - 1)
    src_s = src[perm]
    is_end = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
    idx1 = jnp.clip(perm, 0, E1 - 1)
    idx2 = jnp.clip(perm - E1, 0, E2 - 1)
    ks = kdata[perm]

    def _val(child, idx, have):
        d = child.data[idx]
        valid = have if child.validity is None \
            else have & child.validity[idx]
        return d, valid

    v1_here, v1_ok = _val(v1c, idx1, ~src_s & ink_s)
    v2_here, v2_ok = _val(v2c, idx2, src_s & ink_s)
    # v2 of a 2-entry run lives at the NEXT sorted position (src sorts
    # m1-entries first within a run)
    nxt = lambda a, fill: jnp.concatenate([a[1:], jnp.full((1,), fill,
                                                           a.dtype)])
    v2_start = jnp.where(is_end, v2_here, nxt(v2_here, 0))
    v2_start_ok = jnp.where(is_end, v2_ok, nxt(v2_ok, False))
    take = boundary & ink_s
    # lambda over the sorted element space at run starts
    binds = [
        (lam.params[0], EvalValue(ks, None, kt, kdict)),
        (lam.params[1], EvalValue(v1_here, v1_ok, m1.dtype.children[1],
                                  v1c.dictionary)),
        (lam.params[2], EvalValue(v2_start, v2_start_ok,
                                  m2.dtype.children[1],
                                  v2c.dictionary)),
    ]
    cols = _LiftedColumns(ctx.columns, rows_s, M)
    for name, val in binds:
        cols[name] = val
    ectx = _EvalCtx(cols, M)
    out = _eval_expr(lam.body, ectx, {})
    if ectx.errors is not None:
        ctx.flag_error(jax.ops.segment_max(
            (ectx.errors & take).astype(jnp.int32),
            jnp.where(take, rows_s, cap),
            num_segments=cap + 1)[:cap] > 0)
    # compact union entries (run starts) to a dense output layout
    pos = jnp.cumsum(take.astype(jnp.int32)) - 1
    tgt = jnp.where(take, pos, jnp.int32(M))
    out_k = scatter_unique_set(M + 1, tgt, ks)[:M]
    od = out.full_data(M)
    out_v = scatter_unique_set(M + 1, tgt, od)[:M]
    ov_valid = None
    if out.validity is not None:
        ov_valid = jnp.ones((M,), bool).at[tgt].set(
            out.full_validity(M), mode="drop")
    lens = jnp.zeros((cap,), jnp.int32).at[
        jnp.where(take, rows_s, jnp.int32(cap))].add(1, mode="drop")
    row_valid = None
    for mm in (m1, m2):
        if mm.validity is not None:
            row_valid = (mm.validity if row_valid is None
                         else row_valid & mm.validity)
    kchild = _DC(out_k, None, kt, kdict)
    vchild = _DC(out_v, ov_valid, lam.dtype, out.dictionary)
    return EvalValue(lens, row_valid, expr.dtype,
                     children=(kchild, vchild))


_register("map_zip_with",
          sig("map(K, V), map(K, U), W -> map(K, W)"), _no_eval)
