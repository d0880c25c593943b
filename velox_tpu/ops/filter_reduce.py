"""Fused scan-filter-sum(product): one reduction per scan batch.

Role parity: the reference's selective scan + aggregation pushdown
(``velox/dwio/common/ColumnVisitors.h:140`` fuses decode + Filter::test +
``SumHook`` so ``sum(expr) WHERE range-filters`` never materializes
intermediates; see also ``velox/exec/AggregationHook.h:27``).

Pattern handled: global ``sum(a * b)`` over int32-stored columns with a
conjunction of per-column range predicates — TPC-H Q6 exactly, and any
scan pipeline of that shape. Each batch reduces to one int64 in a single
jitted masked multiply-reduce, which XLA fuses into one pass over the
columns. The operator skips the generic aggregation's per-batch state
programs; on the H100 its warm Q6 wall was below the generic fused
superstep's (PERF.md). Exactness: connector column stats bound |a * b|,
a batch is taken only when its capacity times that bound fits int64, and
batch sums accumulate as int128 limbs.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.core import expressions as ex
from velox_tpu.core import plan as P
from velox_tpu.ops import int128 as I


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def filtered_sum_product(cols, ranges, ai: int, bi: int, n_active):
    """sum over the first n_active rows passing all ranges of
    cols[ai] * cols[bi], as an int64 device scalar.

    cols: integer arrays of one shared length (rows past n_active are
    excluded). ranges: tuple of (col_idx, lo, hi) inclusive int bounds.
    The caller guarantees the sum fits int64.
    """
    n = cols[0].shape[0]
    keep = jnp.arange(n, dtype=jnp.int32) < n_active
    for (i, lo, hi) in ranges:
        keep = keep & (cols[i] >= lo) & (cols[i] <= hi)
    prod = cols[ai].astype(jnp.int64) * cols[bi].astype(jnp.int64)
    return jnp.sum(jnp.where(keep, prod, 0))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _accumulate(total, cols, ranges, ai: int, bi: int, n_active):
    """One batch's sum added to the (lo, hi) int128 running total."""
    s = filtered_sum_product(cols, ranges, ai, bi, n_active)
    return I.add128(*total, *I.from_i64(s))


# ---------------------------------------------------------------------------
# Plan matcher: recognize the Q6 shape in a fused scan chain + aggregation.
# ---------------------------------------------------------------------------

class FilterSumSpec:
    def __init__(self, scan_cols: List[str], ranges, a_col: str, b_col: str,
                 out_name: str, out_dtype: T.DataType,
                 max_abs_product: int):
        self.scan_cols = scan_cols      # reduction's column order
        self.ranges = ranges            # (idx, lo, hi) into scan_cols
        self.a_col = a_col
        self.b_col = b_col
        self.out_name = out_name
        self.out_dtype = out_dtype
        self.max_abs_product = max_abs_product  # bound on |a * b| per row


def _const_int(c: ex.TypedExpr, col_dtype: T.DataType) -> Optional[int]:
    """Constant -> storage-int at the COLUMN's scale, or None."""
    if not isinstance(c, ex.Constant) or c.value is None:
        return None
    dt = c.dtype
    if dt.kind is T.TypeKind.DATE:
        v = c.value
        if isinstance(v, str):
            v = int((np.datetime64(v) - np.datetime64("1970-01-01"))
                    .astype(int))
        return int(v)
    if dt.kind is T.TypeKind.DECIMAL:
        if col_dtype.kind is not T.TypeKind.DECIMAL:
            return None
        v = int(c.value)
        ds = col_dtype.scale - dt.scale
        if ds >= 0:
            return v * (10 ** ds)
        # constant finer than storage: only exact rescales are safe
        f = 10 ** (-ds)
        if v % f:
            return None
        return v // f
    if dt.is_integral:
        return int(c.value)
    return None


def _collect_ranges(pred: ex.TypedExpr, bounds: Dict[str, List[int]],
                    scan_names) -> bool:
    """Fold a conjunction of range predicates into per-column [lo, hi]
    (intersection). Returns False if any conjunct is not a range test."""
    if isinstance(pred, ex.Call) and pred.name == "and":
        return all(_collect_ranges(a, bounds, scan_names)
                   for a in pred.args)
    if not isinstance(pred, ex.Call):
        return False
    args = pred.args
    name = pred.name
    if name == "between" and len(args) == 3 \
            and isinstance(args[0], ex.FieldAccess):
        f = args[0]
        lo = _const_int(args[1], f.dtype)
        hi = _const_int(args[2], f.dtype)
        if lo is None or hi is None or f.name not in scan_names:
            return False
        b = bounds.setdefault(f.name, [-(2 ** 31), 2 ** 31 - 1])
        b[0] = max(b[0], lo)
        b[1] = min(b[1], hi)
        return True
    if name in ("lt", "lte", "gt", "gte") and len(args) == 2:
        f, c = args
        flip = False
        if isinstance(c, ex.FieldAccess) and isinstance(f, ex.Constant):
            f, c = c, f
            flip = True
        if not isinstance(f, ex.FieldAccess) or f.name not in scan_names:
            return False
        v = _const_int(c, f.dtype)
        if v is None:
            return False
        op = {("lt", False): "lt", ("lte", False): "lte",
              ("gt", False): "gt", ("gte", False): "gte",
              ("lt", True): "gt", ("lte", True): "gte",
              ("gt", True): "lt", ("gte", True): "lte"}[(name, flip)]
        b = bounds.setdefault(f.name, [-(2 ** 31), 2 ** 31 - 1])
        if op == "lt":
            b[1] = min(b[1], v - 1)
        elif op == "lte":
            b[1] = min(b[1], v)
        elif op == "gt":
            b[0] = max(b[0], v + 1)
        else:
            b[0] = max(b[0], v)
        return True
    return False


def match_filter_sum(node: "P.AggregationNode", chain,
                     stats: Optional[Dict[str, Tuple[int, int]]]
                     ) -> Optional[FilterSumSpec]:
    """Match a global single-step sum(a*b) over a fused range-filtered scan
    chain; returns a spec or None. `stats` maps scan column -> (min, max)
    value bounds (connector-provided) that bound each row's product."""
    if node.grouping_keys or node.step is not P.AggregationStep.SINGLE:
        return None
    if len(node.aggregates) != 1 or node.aggregates[0].name != "sum":
        return None
    agg = node.aggregates[0]
    if agg.mask is not None or len(agg.inputs) != 1:
        return None
    if not isinstance(chain.source, P.TableScanNode):
        return None
    scan_names = set(chain.source.output_type().names)
    # resolve the aggregate input through the chain's projections
    mapping = dict(zip(chain.names, chain.exprs))
    e = agg.inputs[0]
    if isinstance(e, ex.FieldAccess) and e.name in mapping:
        e = mapping[e.name]
    if not (isinstance(e, ex.Call) and e.name == "multiply"
            and len(e.args) == 2
            and all(isinstance(a, ex.FieldAccess) for a in e.args)
            and all(a.name in scan_names for a in e.args)):
        return None
    a_f, b_f = e.args
    if stats is None or a_f.name not in stats or b_f.name not in stats:
        return None
    max_abs_product = 1
    for f in (a_f, b_f):
        lo, hi = stats[f.name]
        max_abs_product *= max(abs(lo), abs(hi))
    bounds: Dict[str, List[int]] = {}
    if chain.predicate is not None:
        if not _collect_ranges(chain.predicate, bounds, scan_names):
            return None
    cols = sorted(set(list(bounds) + [a_f.name, b_f.name]))
    idx = {c: i for i, c in enumerate(cols)}
    ranges = tuple((idx[c], int(b[0]), int(b[1]))
                   for c, b in bounds.items())
    out_dtype = node.output_type().children[0]
    return FilterSumSpec(cols, ranges, a_f.name, b_f.name,
                         node.aggregate_names[0], out_dtype,
                         max_abs_product)


def _operator_base():
    from velox_tpu.exec.operator import Operator
    return Operator


class FilterSumOperator(_operator_base()):
    """Operator running the fused reduction per scan batch; falls back to
    the generic AggregationOperator if a batch defeats it (non-int32
    columns, validity masks present, or a capacity whose sum could
    overflow int64)."""

    def __init__(self, node, spec: FilterSumSpec, fallback_factory):
        super().__init__(node)
        self.spec = spec
        self._fallback_factory = fallback_factory
        self._fallback = None
        self._total = (jnp.int64(0), jnp.int64(0))  # int128 (lo, hi)
        self._done = False

    def _batch_ok(self, batch) -> bool:
        if batch.capacity * self.spec.max_abs_product >= 2 ** 63:
            return False
        for c in self.spec.scan_cols:
            col = batch.columns.get(c)
            if col is None or col.validity is not None \
                    or col.data.dtype != jnp.int32:
                return False
        return True

    def add_input(self, batch):
        if self._fallback is not None:
            self._fallback.add_input(batch)
            return
        if not self._batch_ok(batch):
            self._fallback = self._fallback_factory()
            self._fallback.add_input(batch)
            return
        cols = [batch.columns[c].data for c in self.spec.scan_cols]
        idx = {c: i for i, c in enumerate(self.spec.scan_cols)}
        self._total = _accumulate(
            self._total, cols, self.spec.ranges, idx[self.spec.a_col],
            idx[self.spec.b_col], batch.num_active())

    def no_more_input(self):
        super().no_more_input()
        if self._fallback is not None:
            self._fallback.no_more_input()

    def get_output(self):
        if self._fallback is not None:
            return self._fallback.get_output()
        if self._done or not self._no_more_input:
            return None
        self._done = True
        from velox_tpu.vector.device import DeviceBatch, DeviceColumn
        lo, hi = self._total
        data = jnp.asarray(lo, jnp.int64)[None]
        children = None
        if self.spec.out_dtype.is_long_decimal:
            # sum(decimal) declares DECIMAL(38, s): attach the hi limb
            children = (DeviceColumn(jnp.asarray(hi, jnp.int64)[None],
                                     None, T.BIGINT, None),)
        col = DeviceColumn(data, None, self.spec.out_dtype, None,
                           children)
        return DeviceBatch({self.spec.out_name: col},
                           jnp.ones((1,), bool))

    def needs_input(self):
        return not self._no_more_input

    def is_finished(self):
        if self._fallback is not None:
            return self._fallback.is_finished()
        return self._done

