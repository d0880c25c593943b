"""Window operator: partitioned, ordered analytic functions.

Role parity: ``velox/exec/Window.h:38`` + ``WindowBuild.h:29`` (SortWindowBuild
variant), ``velox/exec/WindowFunction.h:34``, frame semantics from
``velox/core/PlanNode.h:2139-2165`` (ROWS/RANGE frames, bound types
UNBOUNDED_PRECEDING/PRECEDING/CURRENT_ROW/FOLLOWING/UNBOUNDED_FOLLOWING),
and ``velox/exec/AggregateWindow.h`` (any aggregate as a window function).

Device-first redesign: the reference walks partitions row-by-row; here the
whole buffered input is sorted once by (partition keys, order keys)
and every function is computed **closed-form over the sorted batch**:

* partition boundaries -> flag diffs + cumsum (segment ids);
* row_number/rank/dense_rank/ntile/percent_rank/cume_dist -> index
  arithmetic on positions within partitions;
* lead/lag/first/last/nth_value -> bounds-clamped gathers;
* sum/count/avg over frames -> difference of per-partition prefix sums;
* min/max over frames -> a sparse table (log2 levels of pairwise min/max),
  two gathers per row for arbitrary per-row frame bounds;
* RANGE bounds -> searchsorted over the order key within partitions.

Everything is one jitted program per (schema, capacity) — no per-row or
per-partition host work.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.core import plan as P
from velox_tpu.exec.batch_utils import concat_batches, take
from velox_tpu.exec.operator import Operator
from velox_tpu.exec.sort import sort_permutation
from velox_tpu.expression.eval import EvalValue, value_from_column
from velox_tpu.vector.device import DeviceBatch, DeviceColumn


class BoundType(enum.Enum):
    # Parity: core/PlanNode.h:2147-2158.
    UNBOUNDED_PRECEDING = "unbounded_preceding"
    PRECEDING = "preceding"
    CURRENT_ROW = "current_row"
    FOLLOWING = "following"
    UNBOUNDED_FOLLOWING = "unbounded_following"


class FrameType(enum.Enum):
    ROWS = "rows"
    RANGE = "range"


@dataclass(frozen=True)
class WindowFrame:
    """k-bound values are int constants OR str column names (per-row
    offsets — parity: velox WindowNode frame bounds as field references,
    core/PlanNode.h:2147; null/negative offsets raise VeloxUserError)."""
    frame_type: FrameType = FrameType.RANGE
    start_type: BoundType = BoundType.UNBOUNDED_PRECEDING
    start_value: object = 0
    end_type: BoundType = BoundType.CURRENT_ROW
    end_value: object = 0


DEFAULT_FRAME = WindowFrame()


@dataclass(frozen=True)
class WindowFunctionCall:
    name: str                      # row_number, rank, sum, lead, ...
    inputs: Tuple = ()             # FieldAccess args
    result_type: T.DataType = T.BIGINT
    frame: WindowFrame = DEFAULT_FRAME
    ignore_nulls: bool = False


_RANKING = {"row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
            "ntile"}
_OFFSET = {"lead", "lag"}
_VALUE = {"first_value", "last_value", "nth_value"}
_AGG = {"sum", "count", "avg", "min", "max"}


def _segment_prefix(x, pstart_idx):
    """Per-partition inclusive prefix sum: cumsum(x) - cumsum_before_start."""
    c = jnp.cumsum(x, axis=0)
    before = jnp.where(pstart_idx > 0, c[jnp.clip(pstart_idx - 1, 0, None)],
                       jnp.zeros_like(c[:1])[0])
    return c - before


class _SparseTable:
    """Range-min/max queries over arbitrary per-row bounds in O(1) gathers."""

    def __init__(self, data, op):
        n = data.shape[0]
        levels = [data]
        k, size = 1, 1
        while size * 2 <= n:
            prev = levels[-1]
            shifted = jnp.concatenate([prev[size:], prev[-size:]])
            levels.append(op(prev, shifted))
            size *= 2
            k += 1
        self.table = jnp.stack(levels)  # (L, n)
        self.op = op
        self.n = n

    def query(self, lo, hi):
        """op-reduce over [lo, hi] inclusive; requires lo <= hi."""
        length = jnp.maximum(hi - lo + 1, 1)
        k = (jnp.log2(length.astype(jnp.float32))).astype(jnp.int32)
        k = jnp.clip(k, 0, self.table.shape[0] - 1)
        left = self.table[k, jnp.clip(lo, 0, self.n - 1)]
        right_pos = hi - (1 << k.astype(jnp.int64)) + 1
        right = self.table[k, jnp.clip(right_pos, 0, self.n - 1)]
        return self.op(left, right)


class WindowOperator(Operator):
    """Sort-based window build (parity: exec/SortWindowBuild.h)."""

    def __init__(self, node: "P.WindowNode"):
        super().__init__(node)
        self._node = node
        self._batches: List[DeviceBatch] = []
        self._out: Optional[DeviceBatch] = None
        self._flags = None
        self._trace_flags: List = []
        from velox_tpu.exec.jit_cache import cached_jit
        self._fn = cached_jit((type(self).__name__, node),
                              lambda: jax.jit(self._compute_flagged))

    def _compute_flagged(self, batch: DeviceBatch):
        """_compute plus any in-trace sanity flags (RANGE-k composite
        overflow) accumulated during tracing."""
        self._trace_flags = []
        out = self._compute(batch)
        flags = jnp.int32(0)
        for f in self._trace_flags:  # bit 1: overflow, bit 2: bad offset
            flags = flags | f
        return out, flags

    def add_input(self, batch):
        self._batches.append(batch)

    def device_state(self):
        return self._out

    def no_more_input(self):
        super().no_more_input()
        if self._batches:
            merged = concat_batches(self._batches)
            self._batches = []
            self._out, self._flags = self._fn(merged)

    def get_output(self):
        out, self._out = self._out, None
        if out is not None and self._flags is not None:
            # only k-bound windows ever set flags; the fetch is one
            # scalar right before output extraction syncs anyway
            k_bounds = (BoundType.PRECEDING, BoundType.FOLLOWING)
            has_k = any(
                (fr := getattr(c, "frame", None)) is not None
                and (fr.start_type in k_bounds or fr.end_type in k_bounds)
                for c in self._node.functions)
            if has_k:
                f = int(jax.device_get(self._flags))
                if f & 2:
                    from velox_tpu.common.errors import VeloxUserError
                    raise VeloxUserError(
                        "window frame offset is null or negative")
                if f & 1:
                    from velox_tpu.common.errors import VeloxRuntimeError
                    raise VeloxRuntimeError(
                        "RANGE k-PRECEDING/FOLLOWING: partition count x "
                        "ORDER BY key span overflows the int64 composite; "
                        "narrow the key range or reduce partitions")
            self._flags = None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None

    # ---- the traced program --------------------------------------------------

    def _compute(self, batch: DeviceBatch) -> DeviceBatch:
        node = self._node
        cap = batch.capacity
        pkeys = [value_from_column(batch.columns[k.name])
                 for k in node.partition_keys]
        okeys = [value_from_column(batch.columns[k.name])
                 for k in node.sort_keys]
        keys = pkeys + okeys
        orders = ([P.SortOrder.ASC_NULLS_LAST] * len(pkeys)
                  + list(node.sort_orders))
        if keys:
            perm = sort_permutation(keys, orders, cap, batch.mask)
            s = take(batch, perm, batch.mask[perm])
        else:
            s = batch
        mask = s.mask
        iota = jnp.arange(cap, dtype=jnp.int64)
        n_rows = jnp.sum(mask.astype(jnp.int64))

        # partition boundaries over the sorted batch
        new_part = jnp.zeros((cap,), bool).at[0].set(True)
        for k in node.partition_keys:
            col = s.columns[k.name]
            d = col.data
            prev = jnp.concatenate([d[:1], d[:-1]])
            new_part = new_part | (d != prev)
            if col.validity is not None:
                v = col.validity
                pv = jnp.concatenate([v[:1], v[:-1]])
                new_part = new_part | (v != pv)
        new_part = new_part & mask
        # peer boundaries (same partition AND same order keys)
        new_peer = new_part
        for k in node.sort_keys:
            col = s.columns[k.name]
            d = col.data
            prev = jnp.concatenate([d[:1], d[:-1]])
            new_peer = new_peer | (d != prev)
            if col.validity is not None:
                v = col.validity
                pv = jnp.concatenate([v[:1], v[:-1]])
                new_peer = new_peer | (v != pv)
        new_peer = new_peer & mask

        pid = jnp.cumsum(new_part.astype(jnp.int64)) - 1  # partition index
        # index of this row's partition start / end (inclusive)
        pstart = jnp.where(new_part, iota, 0)
        pstart = jax.lax.cummax(pstart)
        # partition end: next partition's start - 1 (or last active row)
        is_last = iota == jnp.maximum(n_rows - 1, 0)
        pend_rev = jnp.where(
            jnp.concatenate([new_part[1:], jnp.ones((1,), bool)]) | is_last,
            iota, jnp.int64(cap))
        pend = jax.lax.cummin(pend_rev, reverse=True)
        pend = jnp.minimum(pend, jnp.maximum(n_rows - 1, 0))
        pos = iota - pstart          # 0-based position within partition
        psize = pend - pstart + 1

        # peer group start (for rank/cume_dist/RANGE CURRENT_ROW)
        peer_start = jnp.where(new_peer, iota, 0)
        peer_start = jax.lax.cummax(peer_start)
        is_peer_end = jnp.concatenate(
            [new_peer[1:], jnp.ones((1,), bool)]) | is_last
        peer_end = jnp.where(is_peer_end, iota, jnp.int64(cap))
        peer_end = jax.lax.cummin(peer_end, reverse=True)
        peer_end = jnp.minimum(peer_end, jnp.maximum(n_rows - 1, 0))

        out_cols: Dict[str, DeviceColumn] = dict(s.columns)
        for out_name, call in zip(node.output_names, node.functions):
            out_cols[out_name] = self._one_function(
                call, s, cap, mask, iota, pstart, pend, pos, psize,
                peer_start, peer_end, new_peer, pid)
        return DeviceBatch(out_cols, mask)

    # ---- individual functions -------------------------------------------------

    def _one_function(self, call, s, cap, mask, iota, pstart, pend, pos,
                      psize, peer_start, peer_end, new_peer, pid
                      ) -> DeviceColumn:
        name = call.name
        if name == "row_number":
            return DeviceColumn((pos + 1), None, T.BIGINT, None)
        if name == "rank":
            return DeviceColumn(peer_start - pstart + 1, None, T.BIGINT,
                                None)
        if name == "dense_rank":
            dr = _segment_prefix(new_peer.astype(jnp.int64),
                                 pstart)
            return DeviceColumn(dr, None, T.BIGINT, None)
        if name == "percent_rank":
            r = (peer_start - pstart).astype(jnp.float64)
            denom = jnp.maximum(psize - 1, 1).astype(jnp.float64)
            out = jnp.where(psize == 1, 0.0, r / denom)
            return DeviceColumn(out, None, T.DOUBLE, None)
        if name == "cume_dist":
            out = (peer_end - pstart + 1).astype(jnp.float64) \
                / psize.astype(jnp.float64)
            return DeviceColumn(out, None, T.DOUBLE, None)
        if name == "ntile":
            n = self._const_arg(call, 0)
            n = jnp.maximum(jnp.int64(n), 1)
            small = psize // n          # base bucket size
            rem = psize % n
            # first `rem` buckets have size small+1
            cut = rem * (small + 1)
            bucket = jnp.where(
                pos < cut, pos // jnp.maximum(small + 1, 1),
                rem + (pos - cut) // jnp.maximum(small, 1))
            return DeviceColumn(bucket + 1, None, T.BIGINT, None)
        if name in _OFFSET:
            v = value_from_column(s.columns[call.inputs[0].name])
            off = self._const_arg(call, 1, default=1)
            off = off if name == "lead" else -off
            src = iota + off
            in_part = (src >= pstart) & (src <= pend) & mask
            src_c = jnp.clip(src, 0, cap - 1)
            data = v.full_data(cap)[src_c]
            validity = in_part
            if v.validity is not None:
                validity = validity & v.full_validity(cap)[src_c]
            if len(call.inputs) > 2:
                dflt = value_from_column(s.columns[call.inputs[2].name])
                data = jnp.where(in_part, data, dflt.full_data(cap))
                if dflt.validity is None:
                    validity = jnp.where(in_part, validity, True)
                else:
                    validity = jnp.where(in_part, validity,
                                         dflt.full_validity(cap))
            return DeviceColumn(data, validity, v.dtype, v.dictionary)

        # frame-based functions
        lo, hi = self._frame_bounds(call.frame, s, cap, iota, pstart, pend,
                                    peer_start, peer_end, pid)
        empty = lo > hi
        lo_c = jnp.clip(lo, 0, cap - 1)
        hi_c = jnp.clip(hi, 0, cap - 1)

        if name in _VALUE:
            v = value_from_column(s.columns[call.inputs[0].name])
            if name == "first_value":
                src = lo_c
            elif name == "last_value":
                src = hi_c
            else:  # nth_value(x, n) - 1-based within frame
                n = self._const_arg(call, 1)
                src = lo_c + (n - 1)
                empty = empty | (src > hi_c)
                src = jnp.clip(src, 0, cap - 1)
            data = v.full_data(cap)[src]
            validity = ~empty & mask
            if v.validity is not None:
                validity = validity & v.full_validity(cap)[src]
            return DeviceColumn(data, validity, v.dtype, v.dictionary)

        if name in _AGG:
            return self._frame_aggregate(call, s, cap, mask, lo_c, hi_c,
                                         empty, pstart)
        raise NotImplementedError(f"window function {name}")

    def _const_arg(self, call, i, default=None):
        from velox_tpu.core import expressions as ex
        if len(call.inputs) <= i:
            if default is None:
                raise ValueError(f"{call.name} missing argument {i}")
            return default
        arg = call.inputs[i]
        if isinstance(arg, ex.Constant):
            return int(arg.value)
        raise NotImplementedError(
            f"{call.name}: non-constant argument {i} not supported")

    def _range_k_comp(self, s, cap, pid):
        """(comp, kmin, span, sign): a per-row monotone composite
        pid*span + biased(order key) enabling RANGE k-PRECEDING bound
        lookups via one searchsorted over the sorted batch (keys ascend
        within partitions by construction; DESC order negates)."""
        node = self._node
        if len(node.sort_keys) != 1:
            # parity: the reference enforces the same single-key contract
            # (checkKRangeFrameBounds, velox/exec/Window.cpp:94-105 —
            # "The order by needs to be a single column")
            raise NotImplementedError(
                "RANGE k frames require exactly one ORDER BY key")
        from velox_tpu.expression.eval import value_from_column as vfc
        v = vfc(s.columns[node.sort_keys[0].name])
        if not (v.dtype.is_integral or v.dtype.kind in (
                T.TypeKind.DATE, T.TypeKind.DECIMAL)):
            raise NotImplementedError(
                "RANGE k frames need an integral/date/decimal key")
        key = v.full_data(cap).astype(jnp.int64)
        if not node.sort_orders[0].ascending:
            key = -key
        kmin = jnp.min(jnp.where(s.mask, key, jnp.iinfo(jnp.int64).max))
        kmax = jnp.max(jnp.where(s.mask, key, jnp.iinfo(jnp.int64).min))
        span = kmax - kmin + 1
        # overflow guard: pid_max * (span + 2^33) must stay inside int64
        # (huge key spans x many partitions would silently wrap and give
        # wrong frame bounds); the flag rides the traced output and the
        # operator raises after one device fetch
        pid_max = jnp.max(jnp.where(s.mask, pid, 0))
        safe = pid_max <= (jnp.int64(1) << 62) // (span + 2 * (1 << 32))
        self._trace_flags.append(
            jnp.where(safe, jnp.int32(0), jnp.int32(1)))  # flag bit 1
        comp = pid * (span + 2 * (1 << 32)) + (key - kmin) + (1 << 32)
        # inactive (padding) rows sort last in the batch; force their
        # composites to +inf so the array stays monotone for searchsorted
        comp = jnp.where(s.mask, comp, jnp.iinfo(jnp.int64).max)
        return comp, 2 * (1 << 32) + span

    def _frame_k(self, value, s, cap):
        """Frame offset: python int (constant) or per-row int64 array
        (str column name, read from the SORTED batch). Null/negative
        per-row offsets set trace-flag bit 2 (Velox raises
        VeloxUserError for invalid frame offsets)."""
        if not isinstance(value, str):
            return int(value)
        v = value_from_column(s.columns[value])
        k = v.full_data(cap).astype(jnp.int64)
        bad = k < 0
        if v.validity is not None:
            vv = v.full_validity(cap)
            bad = bad | ~vv
            k = jnp.where(vv, k, 0)
        bad = bad & s.mask
        self._trace_flags.append(
            jnp.where(jnp.any(bad), jnp.int32(2), jnp.int32(0)))
        return jnp.maximum(k, 0)

    def _frame_bounds(self, frame: WindowFrame, s, cap, iota, pstart, pend,
                      peer_start, peer_end, pid=None):
        """Per-row inclusive frame [lo, hi] as sorted-batch indices."""
        if frame.frame_type is FrameType.ROWS:
            def rbound(btype, value):
                if btype is BoundType.UNBOUNDED_PRECEDING:
                    return pstart
                if btype is BoundType.UNBOUNDED_FOLLOWING:
                    return pend
                if btype is BoundType.CURRENT_ROW:
                    return iota
                k = self._frame_k(value, s, cap)
                return iota - k if btype is BoundType.PRECEDING \
                    else iota + k
            lo = rbound(frame.start_type, frame.start_value)
            hi = rbound(frame.end_type, frame.end_value)
        else:  # RANGE: peers collapse; k-range bounds need the order key
            def bound(btype, value, is_start):
                if btype is BoundType.UNBOUNDED_PRECEDING:
                    return pstart
                if btype is BoundType.UNBOUNDED_FOLLOWING:
                    return pend
                if btype is BoundType.CURRENT_ROW:
                    return peer_start if is_start else peer_end
                # k PRECEDING / FOLLOWING on the order-key VALUE: one
                # searchsorted over the (partition, key) composite
                comp, pspan = self._range_k_comp(s, cap, pid)
                k = self._frame_k(value, s, cap)
                # DESC needs no special-casing: the composite already
                # negates the key, so -k always points at frame starts.
                # Clamp |delta| to the partition block span: any larger
                # offset already lands outside the partition (lo/hi are
                # clamped to pstart/pend) and unclamped huge offsets
                # would overflow the int64 composite.
                delta = -k if btype is BoundType.PRECEDING else k
                delta = jnp.clip(delta, -pspan, pspan)
                if is_start:
                    return jnp.searchsorted(
                        comp, comp + delta, side="left").astype(iota.dtype)
                return jnp.searchsorted(
                    comp, comp + delta, side="right").astype(iota.dtype) - 1
            lo = bound(frame.start_type, frame.start_value, True)
            hi = bound(frame.end_type, frame.end_value, False)
        lo = jnp.maximum(lo, pstart)
        hi = jnp.minimum(hi, pend)
        return lo, hi

    def _frame_aggregate(self, call, s, cap, mask, lo, hi, empty, pstart
                         ) -> DeviceColumn:
        name = call.name
        if name == "count" and not call.inputs:
            cnt = jnp.where(empty, 0, hi - lo + 1)
            return DeviceColumn(cnt, None, T.BIGINT, None)
        v = value_from_column(s.columns[call.inputs[0].name])
        data = v.full_data(cap)
        valid = mask if v.validity is None \
            else (mask & v.full_validity(cap))

        if name == "count":
            pc = jnp.cumsum(valid.astype(jnp.int64))
            total = _range_sum(pc, lo, hi, cap)
            cnt = jnp.where(empty, 0, total)
            return DeviceColumn(cnt, None, T.BIGINT, None)

        if name in ("sum", "avg"):
            from velox_tpu.functions.aggregates import resolve_aggregate
            agg = resolve_aggregate(name, [v.dtype])
            # decimal frames accumulate in plain int64 (frame sums are
            # range differences of one batch's prefix sum — int64-exact);
            # the declared DECIMAL(38, s) result gets a sign-extension hi
            # limb below
            acc_np = (jnp.int64 if v.dtype.kind is T.TypeKind.DECIMAL
                      else agg.states[0].dtype.np_dtype())
            contrib = jnp.where(valid, data, 0).astype(acc_np)
            pref = jnp.cumsum(contrib)
            ssum = _range_sum(pref, lo, hi, cap)
            pc = jnp.cumsum(valid.astype(jnp.int64))
            cnt = _range_sum(pc, lo, hi, cap)
            has = (~empty) & (cnt > 0) & mask
            if name == "sum":
                rt = agg.result_type
                children = None
                if rt.is_long_decimal:
                    children = (DeviceColumn(ssum >> jnp.int64(63), None,
                                             T.BIGINT, None),)
                return DeviceColumn(ssum, has, rt, v.dictionary,
                                    children)
            if agg.result_type.kind is T.TypeKind.DECIMAL:
                c_safe = jnp.maximum(cnt, 1)
                half = c_safe // 2
                q = jnp.where(ssum >= 0, (ssum + half) // c_safe,
                              -((-ssum + half) // c_safe))
                return DeviceColumn(q, has, agg.result_type, None)
            return DeviceColumn(
                ssum / jnp.maximum(cnt, 1), has, T.DOUBLE, None)

        # min / max via sparse table
        op = jnp.minimum if name == "min" else jnp.maximum
        from velox_tpu.functions.aggregates import MinMaxAgg
        agg = MinMaxAgg(name, v.dtype)
        ident = agg.states[0].identity()
        table = _SparseTable(jnp.where(valid, data, ident), op)
        res = table.query(lo, hi)
        pc = jnp.cumsum(valid.astype(jnp.int64))
        cnt = _range_sum(pc, lo, hi, cap)
        has = (~empty) & (cnt > 0) & mask
        return DeviceColumn(res, has, v.dtype, v.dictionary)


def _range_sum(prefix, lo, hi, cap):
    """Inclusive-range sum from an inclusive prefix array."""
    hi_v = prefix[jnp.clip(hi, 0, cap - 1)]
    lo_prev = jnp.where(lo > 0, prefix[jnp.clip(lo - 1, 0, None)],
                        jnp.zeros_like(prefix[0]))
    return hi_v - lo_prev


# ---------------------------------------------------------------------------
# RowNumber operator (no sort): running count per partition across batches.
# Parity: velox/exec/RowNumber.h:24.
# ---------------------------------------------------------------------------

class RowNumberOperator(Operator):
    """Streaming row_number per partition-key group (hash-based, no sort)."""

    def __init__(self, node: "P.RowNumberNode"):
        super().__init__(node)
        self._node = node
        self._out: Optional[DeviceBatch] = None
        self._table = None
        self._counts = None
        from velox_tpu.exec.jit_cache import cached_jit
        self._fn = cached_jit((type(self).__name__, node),
                              lambda: jax.jit(self._step))

    def _step(self, batch: DeviceBatch, table, counts):
        from velox_tpu.exec import hashtable as H
        node = self._node
        cap = batch.capacity
        keys = [value_from_column(batch.columns[k.name])
                for k in node.partition_keys]
        if table is None:
            table = H.empty_table(keys, H.table_size_for(cap))
            counts = jnp.zeros((table.size,), jnp.int64)
        table, slots, _ = H.insert(table, keys, batch.mask, cap)
        S = table.size
        seg = jnp.where(batch.mask, slots, jnp.int32(S))
        # rank of each row within its group in this batch: stable sort
        # by slot, then position within the run of equal slots
        from velox_tpu.exec.sort import radix_sort_perm
        order = radix_sort_perm([seg.astype(jnp.uint32)],
                                [max(1, S.bit_length())], cap)
        s_sorted = seg[order]
        newg = jnp.concatenate([jnp.ones((1,), bool),
                                s_sorted[1:] != s_sorted[:-1]])
        gstart = jnp.where(newg, jnp.arange(cap), 0)
        gstart = jax.lax.cummax(gstart)
        rank_sorted = jnp.arange(cap) - gstart
        # scatter in int32 (rank < cap), widened after: chosen for the engine's
        # first accelerator, where int64 scatters were slow; not yet measured
        # on the H100
        rank = jnp.zeros((cap,), jnp.int32).at[order].set(
            rank_sorted.astype(jnp.int32)).astype(jnp.int64)
        base = counts[jnp.clip(slots, 0, S - 1)]
        rn = base + rank + 1
        add = jax.ops.segment_sum(batch.mask.astype(jnp.int64), seg,
                                  num_segments=S + 1)[:S]
        counts = counts + add
        mask = batch.mask
        if node.limit is not None:
            mask = mask & (rn <= node.limit)
        cols = dict(batch.columns)
        if node.row_number_column:
            cols[node.row_number_column] = DeviceColumn(rn, None, T.BIGINT,
                                                        None)
        return DeviceBatch(cols, mask), table, counts

    def add_input(self, batch):
        if self._table is None:
            # first batch initializes the table inside the traced step
            from velox_tpu.exec.jit_cache import cached_jit
            init_fn = cached_jit(
                (type(self).__name__, self._node, "init"),
                lambda: jax.jit(lambda b: self._step(b, None, None)))
            out, self._table, self._counts = init_fn(batch)
        else:
            out, self._table, self._counts = self._fn(
                batch, self._table, self._counts)
        self._out = out

    def get_output(self):
        out, self._out = self._out, None
        return out

    def needs_input(self):
        return not self._no_more_input and self._out is None

    def is_finished(self):
        return self._no_more_input and self._out is None


# ---------------------------------------------------------------------------
# TopNRowNumber: per-partition top-k by sort keys.
# Parity: velox/exec/TopNRowNumber.h:37.
# ---------------------------------------------------------------------------

class TopNRowNumberOperator(Operator):
    """Buffered per-partition top-k (sort-based)."""

    def __init__(self, node: "P.TopNRowNumberNode"):
        super().__init__(node)
        self._node = node
        self._batches: List[DeviceBatch] = []
        self._out: Optional[DeviceBatch] = None
        from velox_tpu.exec.jit_cache import cached_jit
        self._fn = cached_jit((type(self).__name__, node),
                              lambda: jax.jit(self._compute))

    def _compute(self, batch: DeviceBatch) -> DeviceBatch:
        node = self._node
        cap = batch.capacity
        pkeys = [value_from_column(batch.columns[k.name])
                 for k in node.partition_keys]
        okeys = [value_from_column(batch.columns[k.name])
                 for k in node.sort_keys]
        orders = ([P.SortOrder.ASC_NULLS_LAST] * len(pkeys)
                  + list(node.sort_orders))
        perm = sort_permutation(pkeys + okeys, orders, cap, batch.mask)
        s = take(batch, perm, batch.mask[perm])
        iota = jnp.arange(cap, dtype=jnp.int64)
        new_part = jnp.zeros((cap,), bool).at[0].set(True)
        for k in node.partition_keys:
            d = s.columns[k.name].data
            prev = jnp.concatenate([d[:1], d[:-1]])
            new_part = new_part | (d != prev)
        new_part = new_part & s.mask
        pstart = jnp.where(new_part, iota, 0)
        pstart = jax.lax.cummax(pstart)
        rn = iota - pstart + 1
        mask = s.mask & (rn <= node.limit)
        cols = dict(s.columns)
        if node.row_number_column:
            cols[node.row_number_column] = DeviceColumn(rn, None, T.BIGINT,
                                                        None)
        return DeviceBatch(cols, mask)

    def add_input(self, batch):
        self._batches.append(batch)

    def no_more_input(self):
        super().no_more_input()
        if self._batches:
            self._out = self._fn(concat_batches(self._batches))
            self._batches = []

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None
