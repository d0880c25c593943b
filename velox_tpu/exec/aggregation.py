"""Hash-aggregation operator (group-by and global).

Role parity: ``velox/exec/HashAggregation.h:23`` + ``GroupingSet.cpp``
(addInput -> groupProbe -> Aggregate::addRawInput; getOutput/extract;
partial/final steps per core/PlanNode.h:512-525).

Device-first (SURVEY.md §7.1/§7.2 step 4): no probing hash table. Per input
batch, a jitted *partial* program computes per-row addends and reduces them
into dense per-group state using array mode (small known key domains) or
sort mode (normalized keys + lax.sort + segment ops) — see groupby.py. The
host accumulates partial group batches; a jitted *merge* program re-groups
the concatenated partials and extracts final values. This mirrors the
reference's partial->final split and its spill "sorted run merge"
(GroupingSet::getOutputWithSpill, GroupingSet.cpp:1043) — partial runs here
are the in-HBM analogue of spill runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.core import plan as P
from velox_tpu.exec import groupby as G
from velox_tpu.exec.batch_utils import concat_batches
from velox_tpu.exec.operator import Operator
from velox_tpu.expression.eval import (
    EvalCtx, EvalValue, ExprSet, value_from_column,
)
from velox_tpu.functions.aggregates import resolve_aggregate
from velox_tpu.vector.device import DeviceBatch, DeviceColumn


def _state_col_name(out_name: str, agg, suffix: str) -> str:
    if len(agg.states) == 1:
        return out_name
    return f"{out_name}${suffix}"


# (plan node, has_pre_chain) -> (partial_fn, merge_fn, compact_fn, ...).
# The pre-chain flag is part of the key: the jitted partial step bakes in
# self._pre_fn at trace time, and a DistributedTask constructs the same
# value-equal node WITHOUT a fused pre-chain (parallel/distributed.py) while
# a local Task fuses the upstream Filter/Project chain in. The chain itself
# is derived deterministically from node.source (part of node equality), so
# (node, pre_fn is None) fully determines the traced programs.
_AGG_JIT_CACHE: Dict = {}


class AggregationOperator(Operator):
    """Group-by aggregation over one or more key columns."""

    def __init__(self, node: P.AggregationNode, pre_fn=None,
                 host_offload: bool = False, compact_threshold: int = 8,
                 abandon_min_rows: int = 100_000,
                 abandon_min_pct: float = 0.8):
        super().__init__(node)
        # fused upstream Filter/Project chain, applied inside the same
        # jitted program as the partial step (exec/fuse.py)
        self._pre_fn = pre_fn
        # host-RAM offload of compacted partial runs — the spill analogue
        # (exec/memory.py; parity velox GroupingSet::spill)
        self._host_offload = host_offload
        self._host_runs = []
        self._step = node.step
        self._keys = list(node.grouping_keys)
        # static (min, max) bounds per grouping key (core/stats.py):
        # narrows the sort-mode normalized keys to their information
        # content — fewer sort lanes
        from velox_tpu.core.stats import resolve_column_stats
        self._key_ranges = tuple(
            resolve_column_stats(node.source, k.name) if node.source
            is not None else None
            for k in self._keys)
        self._agg_calls = list(node.aggregates)
        self._agg_names = list(node.aggregate_names)
        self._aggs = [resolve_aggregate(a.name, [i.dtype for i in a.inputs])
                      for a in self._agg_calls]
        # collect-style aggregates (array_agg/set_agg/map_agg/histogram/
        # approx_percentile) retain rows and finalize through the sort-based
        # collect pathway below (no segment-combinable state)
        from velox_tpu.functions.aggregates import (
            ApproxPercentileAgg, CollectAgg,
        )
        self._collect_mode = any(
            isinstance(a, CollectAgg) for a in self._aggs)
        if self._collect_mode:
            # partial/final split exists for ONE approx_percentile: the
            # PARTIAL emits a mergeable quantile-knot summary (value +
            # weight rows; see _pct_compress). Other collect aggregates
            # are single-step only. Parity goal: the reference's KLL
            # sketch partial/final (functions/lib/KllSketch.h,
            # AggregateCompanionAdapter.h:172).
            from velox_tpu.functions.aggregates import ApproxPercentileAgg
            self._pct_split = self._step is not P.AggregationStep.SINGLE
            if self._pct_split and not (
                    len(self._aggs) == 1
                    and isinstance(self._aggs[0], ApproxPercentileAgg)):
                raise NotImplementedError(
                    "collect aggregates support single-step aggregation "
                    "only (exception: a single approx_percentile, which "
                    "splits via the mergeable quantile-knot summary)")
            if any(st.width > 1 for a in self._aggs for st in a.states):
                raise NotImplementedError(
                    "vector-state aggregates cannot mix with collect "
                    "aggregates")
            from velox_tpu.functions.aggregates import (
                ApproxMostFrequentAgg,
            )
            for a, call in zip(self._aggs, self._agg_calls):
                if isinstance(a, ApproxPercentileAgg):
                    from velox_tpu.core import expressions as ex
                    if not isinstance(call.inputs[1], ex.Constant):
                        raise NotImplementedError(
                            "approx_percentile: percentage must be a "
                            "constant")
                    c = call.inputs[1]
                    p = float(c.value)
                    if c.dtype.kind is T.TypeKind.DECIMAL:
                        p /= 10.0 ** c.dtype.scale  # unscaled literal
                    a.percentile = p
                    if len(call.inputs) > 2:
                        # approx_percentile(x, p, accuracy): the
                        # reference's kFromEpsilon contract — pick the
                        # summary size so the normalized rank error
                        # stays within `accuracy` (KllSketch.h:51)
                        acc = call.inputs[2]
                        if not isinstance(acc, ex.Constant):
                            raise NotImplementedError(
                                "approx_percentile: accuracy must be a "
                                "constant")
                        av = float(acc.value)
                        if acc.dtype.kind is T.TypeKind.DECIMAL:
                            av /= 10.0 ** acc.dtype.scale
                        if not 0.0 < av < 1.0:
                            from velox_tpu.common.errors import (
                                VeloxUserError,
                            )
                            raise VeloxUserError(
                                "approx_percentile accuracy must be in "
                                f"(0, 1), got {av}")
                        a.accuracy = av
                from velox_tpu.functions.aggregates import BloomFilterAgg
                if isinstance(a, BloomFilterAgg) and len(call.inputs) > 1:
                    from velox_tpu.core import expressions as ex
                    for ci in call.inputs[1:]:
                        if not isinstance(ci, ex.Constant):
                            raise NotImplementedError(
                                "bloom_filter_agg: size hints must be "
                                "constants")
                    # numBits explicit (arg 3) or ~8 bits/item (arg 2)
                    want = (int(call.inputs[2].value)
                            if len(call.inputs) > 2
                            else 8 * int(call.inputs[1].value))
                    a.num_bits = max(
                        1 << 10, min(1 << 23,
                                     1 << max(1, want - 1).bit_length()))
                if isinstance(a, ApproxMostFrequentAgg):
                    from velox_tpu.core import expressions as ex
                    if not isinstance(call.inputs[0], ex.Constant):
                        raise NotImplementedError(
                            "approx_most_frequent: buckets must be a "
                            "constant")
                    a.buckets = int(call.inputs[0].value)
            self._collect_rows: List[DeviceBatch] = []
            # collect steps read only node-derived state (incl. stats
            # ranges) — cache across Tasks like the grouped steps below;
            # string aggregates bake dictionaries, so those stay per-Task
            from velox_tpu.exec.jit_cache import cached_jit
            _c_ok = not any(a.inputs and a.inputs[0].dtype.is_string
                            for a in self._agg_calls)
            ck = ("agg_collect", node, self._key_ranges)

            def _mk(name, fn):
                if not _c_ok:
                    return jax.jit(fn)
                return cached_jit(ck + (name,), lambda: jax.jit(fn))
            self._collect_prep_fn = _mk("prep", self._collect_prep)
            self._collect_final_fn = _mk("final", self._collect_finalize)
            # Knots per group and partial: rank error <= W/K per
            # compression and compressions happen at TWO depths (partial
            # fragments, then the final merged re-select), so total
            # normalized rank error <= 2/K. The reference's randomized
            # KLL compactors exist for single-pass streams of unknown
            # length; this engine compresses BULK sorted runs, where
            # evenly spaced deterministic knots achieve the same
            # mergeable contract with a deterministic bound
            # (functions/lib/KllSketch.h:51 kFromEpsilon; default k=200
            # ~ epsilon 1.33% — the default here is tighter).
            self._pct_k = 1024
            acc = getattr(self._aggs[0], "accuracy", None)
            if acc:
                self._pct_k = min(1 << 20, max(2, int(np.ceil(2.0 / acc))))
            if self._pct_split:
                self._pct_compress_fn = _mk("pctc", self._pct_compress)
                self._pct_final_fn = _mk("pctf", self._pct_final)
        self._partials: List[DeviceBatch] = []
        self._outputs: List[DeviceBatch] = []
        self.error_scalars: List = []  # collected by Task._drive
        self._finished = False
        # cache the jitted programs across Task instances by plan node
        # (everything the traced steps read derives from the node) —
        # except string aggregates, whose extraction bakes in the first
        # task's dictionaries at trace time
        cacheable = not any(
            a.inputs and a.inputs[0].dtype.is_string
            for a in self._agg_calls)
        # key includes the resolved stats ranges: the traced steps bake
        # them in, and re-registering a table under the same name can
        # change them (jit_cache.py contract)
        cache_key = (node, pre_fn is None, self._key_ranges)
        # exported for the distributed layer's vmapped-step caching
        # (None = string aggregates bake dictionaries; never share)
        self._cross_task_key = cache_key if cacheable else None
        cached = _AGG_JIT_CACHE.get(cache_key) if cacheable else None
        if cached is None:
            cached = (jax.jit(self._partial_step),
                      jax.jit(self._merge_step),
                      jax.jit(self._compact_step),
                      jax.jit(self._passthrough_step))
            if cacheable:
                _AGG_JIT_CACHE[cache_key] = cached
        (self._partial_fn, self._merge_fn, self._compact_fn,
         self._passthrough_fn) = cached
        # Fold accumulated partial runs when this many pile up — the in-HBM
        # analogue of velox's spill-run merging (GroupingSet.cpp:1043).
        self._compact_threshold = compact_threshold
        # SINGLE-shot mode (round 3): per-batch partial grouping pays a
        # full sort per batch AND a full-capacity concat at the end (the
        # partial output keeps the input capacity), so for SINGLE/FINAL/
        # INTERMEDIATE steps it is strictly more sorted rows than ONE
        # sort over the buffered rows. Buffer per-row state batches
        # (SINGLE evaluates keys+addends per batch via the passthrough
        # program; FINAL/INTERMEDIATE inputs already ARE state batches)
        # and group once at the end. Memory stays bounded by folding to
        # a grouped run past _single_merge_max_rows (the spill analogue).
        self._single_shot = (bool(self._keys) and not self._collect_mode
                             and not host_offload
                             and self._step is not
                             P.AggregationStep.PARTIAL)
        self._single_merge_max_rows = 1 << 24
        self._buffered_rows = 0
        # string aggregate outputs need the input dictionary carried over
        self._agg_dicts: List = [None] * len(self._aggs)
        # adaptive partial-agg abandonment (parity: velox
        # kAbandonPartialAggregationMinRows/Pct, QueryConfig.h:137-141):
        # when grouping barely reduces cardinality, PARTIAL stops grouping
        # and passes raw per-row states through to the final stage
        self._abandoned = False
        self._abandon_min_rows = abandon_min_rows
        self._abandon_min_pct = abandon_min_pct
        self._in_rows = []  # device scalars; synced at compact time

    def _passthrough_step(self, batch: DeviceBatch) -> DeviceBatch:
        """Abandoned partial: emit per-row states without grouping."""
        errs = []
        if self._pre_fn is not None:
            batch = self._pre_fn(batch)
            if batch.errors is not None:
                errs.append(batch.errors)
        keys, addends, active = self._eval_keys_and_addends(
            batch, True, err_sink=errs)
        out = self._make_state_batch(
            keys, [a for a, _ in addends], active, batch.capacity)
        if errs:
            out = DeviceBatch(out.columns, out.mask, errors=sum(errs))
        return out

    # ---- traced programs ---------------------------------------------------

    def _eval_keys_and_addends(self, batch: DeviceBatch, raw: bool,
                               err_sink: Optional[list] = None):
        """Evaluate grouping keys and per-row addends (raw or intermediate)."""
        cap = batch.capacity
        cols = {n: value_from_column(c) for n, c in batch.columns.items()}
        ctx = EvalCtx(cols, cap)
        keys = [cols[k.name] for k in self._keys]
        active = batch.mask
        addends: List[Tuple[jnp.ndarray, str]] = []
        for out_name, agg_call, agg in zip(
                self._agg_names, self._agg_calls, self._aggs):
            if raw:
                es = ExprSet(list(agg_call.inputs), None)
                sink = [] if err_sink is not None else None
                args = es.eval_batch(batch, err_sink=sink)
                if sink and sink[0] is not None:
                    err_sink.append(jnp.sum(sink[0] & active,
                                            dtype=jnp.int32))
                row_active = active
                if agg_call.mask is not None:
                    m = ExprSet([agg_call.mask], None).eval_batch(batch)[0]
                    mm = m.full_data(cap).astype(bool)
                    if m.validity is not None:
                        mm = mm & m.full_validity(cap)
                    row_active = row_active & mm
                arrays = agg.map_raw(ctx, args, row_active)
                for arr, st in zip(arrays, agg.states):
                    addends.append((arr, st.combine))
            else:
                # intermediate input: state columns combine with identity
                # masking for inactive rows
                for st in agg.states:
                    cname = _state_col_name(out_name, agg, st.suffix)
                    col = cols[cname]
                    data = col.full_data(cap)
                    ident = st.identity()
                    keep = active
                    if col.validity is not None:
                        keep = keep & col.full_validity(cap)
                    if data.ndim > 1:  # vector-width state (e.g. HLL)
                        keep = keep[:, None]
                    data = jnp.where(keep, data, ident)
                    addends.append((data, st.combine))
        return keys, addends, active

    def _partial_step(self, batch: DeviceBatch) -> DeviceBatch:
        errs = []
        if self._pre_fn is not None:
            batch = self._pre_fn(batch)
            if batch.errors is not None:
                errs.append(batch.errors)
        raw = self._step in (P.AggregationStep.PARTIAL,
                             P.AggregationStep.SINGLE)
        keys, addends, active = self._eval_keys_and_addends(
            batch, raw, err_sink=errs)
        cap = batch.capacity
        domain = G.array_mode_domain(keys) if keys else None
        if keys and domain is not None and domain <= cap:
            gk, gs, gmask = G.reduce_array_mode(
                keys, addends, active, cap, domain)
            out_cap = domain
        else:
            gk, gs, gmask = G.reduce_sort_mode(keys, addends, active, cap,
                                               ranges=self._key_ranges)
            out_cap = cap
        out = self._make_state_batch(gk, gs, gmask, out_cap)
        if errs:
            # error counts RIDE THE RETURN VALUE (pytree scalar): jit-safe;
            # add_input strips them into self.error_scalars
            out = DeviceBatch(out.columns, out.mask, errors=sum(errs))
        return out

    def _make_state_batch(self, group_keys, group_states, group_mask,
                          out_cap) -> DeviceBatch:
        cols: Dict[str, DeviceColumn] = {}
        for k, v in zip(self._keys, group_keys):
            cols[k.name] = v.to_column(out_cap)
        i = 0
        for out_name, agg in zip(self._agg_names, self._aggs):
            for st in agg.states:
                cname = _state_col_name(out_name, agg, st.suffix)
                cols[cname] = DeviceColumn(group_states[i], None, st.dtype,
                                           None)
                i += 1
        # pad group arrays to a power-of-two-ish capacity is unnecessary:
        # out_cap is static (domain or input capacity)
        return DeviceBatch(cols, group_mask)


    # ---- collect aggregates (array_agg/set_agg/map_agg/histogram/
    # approx_percentile) ----------------------------------------------------
    #
    # Parity: prestosql ArrayAgg/SetAgg/MapAgg/Histogram/ApproxPercentile
    # accumulators. Instead of per-group growable accumulators,
    # rows are RETAINED (prep step: keys + aggregate inputs evaluated and
    # stored), then one finalize program sorts rows by (group keys
    # [+ value]) and emits per-group collections by prefix-compacting the
    # sorted runs. approx_percentile is EXACT: rank-select over the
    # value-sorted run.

    def _collect_inputs(self, i: int):
        from velox_tpu.functions.aggregates import (
            ApproxMostFrequentAgg, ApproxPercentileAgg,
        )
        from velox_tpu.functions.aggregates import BloomFilterAgg
        call = self._agg_calls[i]
        if isinstance(self._aggs[i], (ApproxPercentileAgg,
                                      BloomFilterAgg)):
            return [call.inputs[0]]
        if isinstance(self._aggs[i], ApproxMostFrequentAgg):
            return [call.inputs[1]]  # the value; buckets/cap are consts
        return list(call.inputs)

    def _collect_prep(self, batch: DeviceBatch) -> DeviceBatch:
        """Evaluate keys + aggregate inputs; emit a row batch to retain."""
        errs = []
        if self._pre_fn is not None:
            batch = self._pre_fn(batch)
            if batch.errors is not None:
                errs.append(batch.errors)
        cap = batch.capacity
        cols = {n: value_from_column(c) for n, c in batch.columns.items()}
        out: Dict[str, DeviceColumn] = {}
        for k in self._keys:
            out[k.name] = cols[k.name].to_column(cap)
        for i, call in enumerate(self._agg_calls):
            exprs = self._collect_inputs(i)
            if exprs:
                es = ExprSet(exprs, None)
                sink = []
                vals = es.eval_batch(batch, err_sink=sink)
                if sink and sink[0] is not None:
                    errs.append(jnp.sum(sink[0] & batch.mask,
                                        dtype=jnp.int32))
                for j, v in enumerate(vals):
                    out[f"__a{i}_{j}"] = v.to_column(cap)
            if call.mask is not None:
                m = ExprSet([call.mask], None).eval_batch(batch)[0]
                out[f"__m{i}"] = m.to_column(cap)
        res = DeviceBatch(out, batch.mask)
        if errs:
            res = DeviceBatch(res.columns, res.mask, errors=sum(errs))
        return res

    def _collect_finalize(self, merged: DeviceBatch) -> DeviceBatch:
        from velox_tpu.functions.aggregates import CollectAgg
        from velox_tpu.ops.wide import segmented_reduce_sorted
        cap = merged.capacity
        active = merged.mask
        cols = {n: value_from_column(c) for n, c in merged.columns.items()}
        keys = [cols[k.name] for k in self._keys]
        perm, gid, boundary, act_s, num_groups = G.sorted_group_info(
            keys, active, cap, self._key_ranges)
        out_keys, gmask = G.group_keys_sorted(
            keys, perm, gid, boundary, act_s, num_groups, cap)
        out_cols: Dict[str, DeviceColumn] = {}
        for k, v in zip(self._keys, out_keys):
            out_cols[k.name] = v.to_column(cap)
        ctx = EvalCtx(cols, cap)
        for i, (out_name, agg) in enumerate(zip(self._agg_names,
                                                self._aggs)):
            row_active = active
            mval = cols.get(f"__m{i}")
            if mval is not None:
                mm = mval.full_data(cap).astype(bool)
                if mval.validity is not None:
                    mm = mm & mval.full_validity(cap)
                row_active = row_active & mm
            args = []
            j = 0
            while f"__a{i}_{j}" in cols:
                args.append(cols[f"__a{i}_{j}"])
                j += 1
            if isinstance(agg, CollectAgg):
                out_cols[out_name] = self._collect_result(
                    agg, args, row_active, keys, active,
                    (perm, gid, boundary, act_s), gmask, cap)
            else:
                arrays = agg.map_raw(ctx, args, row_active)
                gs = [segmented_reduce_sorted(
                    a[perm], gid, boundary, act_s, cap, st.combine)
                    for a, st in zip(arrays, agg.states)]
                res = agg.extract(gs, gmask)
                col = res.to_column(cap)
                if res.dtype.is_string and col.dictionary is None:
                    col = DeviceColumn(col.data, col.validity, col.dtype,
                                       self._agg_dicts[i])
                out_cols[out_name] = col
        mask_out = gmask
        if not self._keys:
            # global aggregation: exactly one output row (NULL collect
            # results when there was no input)
            mask_out = jnp.zeros((cap,), bool).at[0].set(True)
        return DeviceBatch(out_cols, mask_out)

    def _collect_result(self, agg, args, row_active, keys, active,
                        skeleton, gmask, cap) -> DeviceColumn:
        from velox_tpu.ops.wide import (
            scatter_unique_set, segmented_reduce_sorted,
        )
        kind = agg.collect_kind
        v = args[0]

        def _emit(vals, keep, gid, boundary, act_s):
            """Prefix-compact sorted rows into child element columns +
            per-group lengths (groups stay contiguous: rows are sorted by
            group)."""
            keep = keep & act_s
            pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
            tgt = jnp.where(keep, pos, jnp.int32(cap))
            children = []
            for data, validity in vals:
                d = scatter_unique_set(cap + 1, tgt, data)[:cap]
                cv = None
                if validity is not None:
                    cv = jnp.ones((cap,), bool).at[tgt].set(
                        validity, mode="drop")
                children.append((d, cv))
            lengths = segmented_reduce_sorted(
                keep.astype(jnp.int32), gid, boundary, act_s, cap, "sum")
            return children, lengths

        if kind == "array_agg":
            perm, gid, boundary, act_s = skeleton
            keep = jnp.asarray(row_active)[perm]
            vals = [(v.full_data(cap)[perm],
                     None if v.validity is None
                     else v.full_validity(cap)[perm])]
            children, lengths = _emit(vals, keep, gid, boundary, act_s)
            cd, cv = children[0]
            et = agg.result_type.children[0]
            child = DeviceColumn(cd, cv, et, v.dictionary)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (child,))

        if kind == "approx_most_frequent":
            vvf = (None if v.validity is None else v.full_validity(cap))
            # pass 1: (group, value) sort -> per-run counts
            perm, gid, boundary, act_s, _, vb = G.sorted_group_info_vals(
                keys, [v], active, cap, self._key_ranges)
            pass_ = jnp.asarray(row_active)[perm] & act_s
            if vvf is not None:
                pass_ = pass_ & vvf[perm]
            run_id = jnp.cumsum(vb.astype(jnp.int32)) - 1
            c = jnp.cumsum(pass_.astype(jnp.int32))
            ce = c - pass_.astype(jnp.int32)
            rs_ce = scatter_unique_set(
                cap + 1, jnp.where(vb, run_id, jnp.int32(cap)), ce)[:cap]
            is_end = jnp.concatenate([vb[1:], jnp.ones((1,), bool)])
            re_c = scatter_unique_set(
                cap + 1, jnp.where(is_end, run_id, jnp.int32(cap)),
                c)[:cap]
            run_cnt = (re_c - rs_ce)[run_id]
            # int32 scatter (counts <= cap), widened after: chosen for the
            # engine's first accelerator, where int64 scatters were slow; not
            # yet measured on the H100
            cnt_orig = jnp.zeros((cap,), jnp.int32).at[perm].set(
                run_cnt.astype(jnp.int32)).astype(jnp.int64)
            # pass 2: (group, -count, value) -> per-group top-b runs
            negc = EvalValue(-cnt_orig, None, T.BIGINT)
            perm2, gid2, b2, act2, _, vb2 = G.sorted_group_info_vals(
                keys, [negc, v], active, cap, self._key_ranges)
            pass2 = jnp.asarray(row_active)[perm2] & act2
            if vvf is not None:
                pass2 = pass2 & vvf[perm2]
            run_id2 = jnp.cumsum(vb2.astype(jnp.int32)) - 1
            c2 = jnp.cumsum(pass2.astype(jnp.int32))
            ce2 = c2 - pass2.astype(jnp.int32)
            rs_ce2 = scatter_unique_set(
                cap + 1, jnp.where(vb2, run_id2, jnp.int32(cap)),
                ce2)[:cap]
            first2 = pass2 & (ce2 == rs_ce2[run_id2])
            cf = jnp.cumsum(first2.astype(jnp.int32))
            cfe = cf - first2.astype(jnp.int32)
            iota = jnp.arange(cap, dtype=jnp.int32)
            grp_start = jax.lax.cummax(jnp.where(b2, iota, jnp.int32(0)))
            take = first2 & ((cfe - cfe[grp_start]) < agg.buckets)
            data2 = v.full_data(cap)[perm2]
            cnt2 = cnt_orig[perm2]
            children, lengths = _emit([(data2, None), (cnt2, None)],
                                      take, gid2, b2, act2)
            kt = agg.result_type.children[0]
            kchild = DeviceColumn(children[0][0], None, kt, v.dictionary)
            vchild = DeviceColumn(children[1][0], None, T.BIGINT, None)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (kchild, vchild))

        if kind == "bloom":
            if self._keys:
                raise NotImplementedError(
                    "bloom_filter_agg supports GLOBAL aggregation only "
                    "(build it with a scalar subquery, Spark-style)")
            from velox_tpu.exec.hashtable import bloom_hashes
            m = agg.num_bits
            keep = jnp.asarray(row_active)
            if v.validity is not None:
                keep = keep & v.full_validity(cap)
            h1, h2 = bloom_hashes(v, cap)
            bits = jnp.zeros((m,), jnp.int32)
            for i in range(agg.K):
                p = ((h1 + np.uint32(i) * h2)
                     & np.uint32(m - 1)).astype(jnp.int32)
                bits = bits.at[jnp.where(keep, p, jnp.int32(m))].max(
                    1, mode="drop")
            # pack 32 bits/word (uint32 shifts; bitcast back to int32)
            ub = jax.lax.bitcast_convert_type(bits, jnp.uint32) \
                .reshape(m // 32, 32)
            words_u = jnp.sum(
                ub << jnp.arange(32, dtype=jnp.uint32)[None, :],
                axis=1, dtype=jnp.uint32)
            words = jax.lax.bitcast_convert_type(words_u, jnp.int32)
            child = DeviceColumn(words, None, T.INTEGER, None)
            lengths = jnp.zeros((cap,), jnp.int32).at[0].set(m // 32)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (child,))

        if kind == "mode":
            # Spark/Presto mode(x): value of the most frequent run —
            # the approx_most_frequent pass-2 ordering ((group, -count,
            # value) sort) with exactly ONE taken run per group; ties
            # resolve to the smallest value (deterministic).
            vvf = (None if v.validity is None else v.full_validity(cap))
            perm, gid, boundary, act_s, _, vb = G.sorted_group_info_vals(
                keys, [v], active, cap, self._key_ranges)
            pass_ = jnp.asarray(row_active)[perm] & act_s
            if vvf is not None:
                pass_ = pass_ & vvf[perm]
            run_id = jnp.cumsum(vb.astype(jnp.int32)) - 1
            c = jnp.cumsum(pass_.astype(jnp.int32))
            ce = c - pass_.astype(jnp.int32)
            rs_ce = scatter_unique_set(
                cap + 1, jnp.where(vb, run_id, jnp.int32(cap)), ce)[:cap]
            is_end = jnp.concatenate([vb[1:], jnp.ones((1,), bool)])
            re_c = scatter_unique_set(
                cap + 1, jnp.where(is_end, run_id, jnp.int32(cap)),
                c)[:cap]
            run_cnt = (re_c - rs_ce)[run_id]
            cnt_orig = jnp.zeros((cap,), jnp.int32).at[perm].set(
                run_cnt.astype(jnp.int32)).astype(jnp.int64)
            negc = EvalValue(-cnt_orig, None, T.BIGINT)
            perm2, gid2, b2, act2, _, vb2 = G.sorted_group_info_vals(
                keys, [negc, v], active, cap, self._key_ranges)
            pass2 = jnp.asarray(row_active)[perm2] & act2
            if vvf is not None:
                pass2 = pass2 & vvf[perm2]
            # first passing row per GROUP in pass-2 order = the mode row
            cg = jnp.cumsum(pass2.astype(jnp.int32))
            iota = jnp.arange(cap, dtype=jnp.int32)
            grp_start = jax.lax.cummax(jnp.where(b2, iota, jnp.int32(0)))
            cg_before_grp = (cg - pass2.astype(jnp.int32))[grp_start]
            take = pass2 & ((cg - pass2.astype(jnp.int32))
                            == cg_before_grp)
            tgt = jnp.where(take, gid2, jnp.int32(cap))
            data = scatter_unique_set(
                cap + 1, tgt, v.full_data(cap)[perm2])[:cap]
            has = jnp.zeros((cap,), bool).at[tgt].set(True, mode="drop")
            return DeviceColumn(data, gmask & has, agg.result_type,
                                v.dictionary)

        if kind in ("min_by", "max_by"):
            # sort by (group, y); first/last passing row's x per group.
            # min/max over long decimals arrive with ONE argument (x==y).
            if len(args) == 1:
                x = y = args[0]
            else:
                x, y = args
            perm, gid, boundary, act_s, _, _vb = G.sorted_group_info_vals(
                keys, [y], active, cap, self._key_ranges)
            pass_ = jnp.asarray(row_active)[perm] & act_s
            if y.validity is not None:
                pass_ = pass_ & y.full_validity(cap)[perm]
            iota = jnp.arange(cap, dtype=jnp.int32)
            run_start = jax.lax.cummax(
                jnp.where(boundary, iota, jnp.int32(0)))
            c = jnp.cumsum(pass_.astype(jnp.int32))
            ce = c - pass_.astype(jnp.int32)
            within = ce - ce[run_start]  # passing-row ordinal in group
            n_pass = segmented_reduce_sorted(
                pass_.astype(jnp.int32), gid, boundary, act_s, cap,
                "sum")
            if kind == "min_by":
                sel = pass_ & (within == 0)
            else:
                sel = pass_ & (within == n_pass[gid] - 1)
            xd = x.full_data(cap)[perm]
            tgt = jnp.where(sel, gid, jnp.int32(cap))
            gdata = scatter_unique_set(cap + 1, tgt, xd)[:cap]
            gvalid = gmask & (n_pass > 0)
            if x.validity is not None:
                xv = x.full_validity(cap)[perm]
                gxv = jnp.ones((cap + 1,), bool).at[tgt].set(
                    xv, mode="drop")[:cap]
                gvalid = gvalid & gxv
            gchildren = ()
            if x.dtype.is_long_decimal and x.children:
                # scatter the row-aligned hi limb alongside the lo limb
                hd = x.children[0].data
                if hd.ndim == 0 or hd.shape[0] != cap:
                    hd = jnp.broadcast_to(hd, (cap,))
                ghd = scatter_unique_set(cap + 1, tgt, hd[perm])[:cap]
                gchildren = (DeviceColumn(ghd, None, T.BIGINT, None),)
            return DeviceColumn(gdata, gvalid, agg.result_type,
                                x.dictionary, gchildren)

        # value-sorted kinds: re-sort with this aggregate's value appended
        # (group numbering matches the skeleton: same key words + active)
        perm, gid, boundary, act_s, _, vb = G.sorted_group_info_vals(
            keys, [v], active, cap, self._key_ranges)
        pass_ = jnp.asarray(row_active)[perm] & act_s
        data_s = v.full_data(cap)[perm]
        val_s = (None if v.validity is None
                 else v.full_validity(cap)[perm])
        if kind in ("map_agg", "multimap_agg", "histogram",
                    "approx_percentile") and val_s is not None:
            pass_ = pass_ & val_s  # null keys/values are dropped

        if kind == "approx_percentile":
            children, lengths = _emit([(data_s, None)], pass_, gid,
                                      boundary, act_s)
            n = lengths
            starts = jnp.cumsum(n) - n
            rank = jnp.clip(
                jnp.ceil(agg.percentile * n).astype(jnp.int32) - 1,
                0, jnp.maximum(n - 1, 0))
            idx = jnp.clip(starts + rank, 0, cap - 1)
            data = children[0][0][idx]
            return DeviceColumn(data, gmask & (n > 0), agg.result_type,
                                v.dictionary)

        # first passing row of each (group, value) run — dedup primitive
        run_id = jnp.cumsum(vb.astype(jnp.int32)) - 1
        c = jnp.cumsum(pass_.astype(jnp.int32))
        ce = c - pass_.astype(jnp.int32)
        run_start_ce = scatter_unique_set(
            cap + 1, jnp.where(vb, run_id, jnp.int32(cap)), ce)[:cap]
        first = pass_ & (ce == run_start_ce[run_id])

        if kind == "set_agg":
            children, lengths = _emit([(data_s, val_s)], first, gid,
                                      boundary, act_s)
            cd, cv = children[0]
            et = agg.result_type.children[0]
            child = DeviceColumn(cd, cv, et, v.dictionary)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (child,))

        if kind == "multimap_agg":
            # outer map: one entry per (group, key) run; inner array:
            # that run's values, compacted in the same global row order
            # so the nested offsets line up with the key compaction
            w = args[1]
            wd = w.full_data(cap)[perm]
            wv = (None if w.validity is None
                  else w.full_validity(cap)[perm])
            is_end = jnp.concatenate([vb[1:], jnp.ones((1,), bool)])
            run_end_c = scatter_unique_set(
                cap + 1, jnp.where(is_end, run_id, jnp.int32(cap)),
                c)[:cap]
            run_cnt = (run_end_c - run_start_ce)[run_id]
            children, lengths = _emit(
                [(data_s, None), (run_cnt.astype(jnp.int32), None)],
                first, gid, boundary, act_s)
            vals_children, _vl = _emit([(wd, wv)], pass_, gid,
                                       boundary, act_s)
            kt, at = agg.result_type.children
            vt = at.children[0]
            elem = DeviceColumn(vals_children[0][0],
                                vals_children[0][1], vt, w.dictionary)
            arr_col = DeviceColumn(
                children[1][0].astype(jnp.int32), None, at, None,
                (elem,))
            kchild = DeviceColumn(children[0][0], None, kt,
                                  v.dictionary)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (kchild, arr_col))

        if kind == "map_agg":
            w = args[1]
            wd = w.full_data(cap)[perm]
            wv = (None if w.validity is None
                  else w.full_validity(cap)[perm])
            children, lengths = _emit([(data_s, None), (wd, wv)], first,
                                      gid, boundary, act_s)
            kt, vt = agg.result_type.children
            kchild = DeviceColumn(children[0][0], None, kt, v.dictionary)
            vchild = DeviceColumn(children[1][0], children[1][1], vt,
                                  w.dictionary)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (kchild, vchild))

        # histogram: count passing rows per (group, value) run
        is_end = jnp.concatenate([vb[1:], jnp.ones((1,), bool)])
        run_end_c = scatter_unique_set(
            cap + 1, jnp.where(is_end, run_id, jnp.int32(cap)), c)[:cap]
        run_cnt = (run_end_c - run_start_ce)[run_id]
        children, lengths = _emit(
            [(data_s, None), (run_cnt.astype(jnp.int64), None)], first,
            gid, boundary, act_s)
        kt = agg.result_type.children[0]
        kchild = DeviceColumn(children[0][0], None, kt, v.dictionary)
        vchild = DeviceColumn(children[1][0], None, T.BIGINT, None)
        return DeviceColumn(lengths, gmask, agg.result_type, None,
                            (kchild, vchild))

    # ---- mergeable approx_percentile (partial/final split) ----------------
    #
    # PARTIAL compresses its rows into <= K quantile KNOTS per group:
    # rows value-sorted within group, cumulative weight cw computed, and
    # the first row crossing each of the K evenly spaced weight
    # thresholds kept with weight = cw - cw(previous knot). A knot's
    # cumulative weight is its exact local rank, so per-fragment rank
    # error <= W/K; weights ADD under concatenation, so merging
    # fragments' knots and re-selecting by weighted rank keeps the error
    # additive — the mergeability contract of the reference's KLL sketch
    # (functions/lib/KllSketch.h) on fixed shapes with no per-group
    # growable state.

    def _pct_sorted(self, merged: DeviceBatch):
        """Common prologue: value-append group sort + weighted cumsums."""
        from velox_tpu.ops.wide import segmented_reduce_sorted
        cap = merged.capacity
        active = merged.mask
        cols = {n: value_from_column(c) for n, c in merged.columns.items()}
        keys = [cols[k.name] for k in self._keys]
        name = self._agg_names[0]
        if self._step is P.AggregationStep.PARTIAL:
            v, w = cols["__a0_0"], None
        else:
            v, w = cols[f"{name}$v"], cols[f"{name}$w"]
        perm, gid, boundary, act_s, num_groups, _vb = \
            G.sorted_group_info_vals(keys, [v], active, cap,
                                     self._key_ranges)
        data_s = v.full_data(cap)[perm]
        vv = (None if v.validity is None
              else v.full_validity(cap)[perm])
        pass_ = act_s if vv is None else (act_s & vv)
        wd = (jnp.ones((cap,), jnp.int64) if w is None
              else w.full_data(cap)[perm].astype(jnp.int64))
        wd = jnp.where(pass_, wd, 0)
        iota = jnp.arange(cap, dtype=jnp.int32)
        run_start = jax.lax.cummax(jnp.where(boundary, iota,
                                             jnp.int32(0)))
        cs = jnp.cumsum(wd)
        cw = cs - (cs - wd)[run_start]  # inclusive within-group weight
        W = segmented_reduce_sorted(wd, gid, boundary, act_s, cap, "sum")
        return dict(cap=cap, keys=keys, v=v, perm=perm, gid=gid,
                    boundary=boundary, act_s=act_s,
                    num_groups=num_groups, data_s=data_s, pass_=pass_,
                    wd=wd, cw=cw, W=W, run_start=run_start)

    def _pct_compress(self, merged: DeviceBatch) -> DeviceBatch:
        """PARTIAL/INTERMEDIATE: rows -> <=K weighted knots per group."""
        s = self._pct_sorted(merged)
        cap, K = s["cap"], self._pct_k
        cw, wd, pass_ = s["cw"], s["wd"], s["pass_"]
        Wrow = s["W"][s["gid"]]
        safe = jnp.maximum(Wrow, 1)
        # keep the first row crossing each ceil(cw*K/W) threshold
        bk = (cw * K + safe - 1) // safe
        bk_prev = ((cw - wd) * K + safe - 1) // safe
        keep = pass_ & (wd > 0) & (bk > bk_prev)
        iota = jnp.arange(cap, dtype=jnp.int32)
        incl = jax.lax.cummax(jnp.where(keep, iota, jnp.int32(-1)))
        prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                incl[:-1]])
        prev = jnp.where(prev >= s["run_start"], prev, -1)
        prev_cw = jnp.where(prev >= 0, cw[jnp.maximum(prev, 0)],
                            jnp.int64(0))
        new_w = jnp.where(keep, cw - prev_cw, 0)
        out: Dict[str, DeviceColumn] = {}
        for k, kv in zip(self._keys, s["keys"]):
            data = kv.full_data(cap)[s["perm"]]
            val = (None if kv.validity is None
                   else kv.full_validity(cap)[s["perm"]])
            out[k.name] = DeviceColumn(data, val, kv.dtype,
                                       kv.dictionary)
        name = self._agg_names[0]
        out[f"{name}$v"] = DeviceColumn(
            s["data_s"], keep, self._aggs[0].input_type,
            s["v"].dictionary)
        out[f"{name}$w"] = DeviceColumn(new_w, None, T.BIGINT, None)
        return DeviceBatch(out, keep)

    def _pct_final(self, merged: DeviceBatch) -> DeviceBatch:
        """FINAL: weighted rank-select over merged knots."""
        from velox_tpu.ops.wide import scatter_unique_set
        s = self._pct_sorted(merged)
        cap = s["cap"]
        agg = self._aggs[0]
        W = s["W"]
        r = jnp.maximum(jnp.ceil(agg.percentile * W).astype(jnp.int64),
                        1)
        r_row = r[s["gid"]]
        cw, wd, pass_ = s["cw"], s["wd"], s["pass_"]
        crossing = pass_ & (wd > 0) & (cw >= r_row) & ((cw - wd) < r_row)
        tgt = jnp.where(crossing, s["gid"], jnp.int32(cap))
        gdata = scatter_unique_set(cap + 1, tgt, s["data_s"])[:cap]
        out_keys, gmask = G.group_keys_sorted(
            s["keys"], s["perm"], s["gid"], s["boundary"], s["act_s"],
            s["num_groups"], cap)
        out_cols: Dict[str, DeviceColumn] = {}
        for k, kv in zip(self._keys, out_keys):
            out_cols[k.name] = kv.to_column(cap)
        name = self._agg_names[0]
        out_cols[name] = DeviceColumn(
            gdata, gmask & (W > 0), agg.result_type,
            s["v"].dictionary)
        mask_out = gmask
        if not self._keys:
            mask_out = jnp.zeros((cap,), bool).at[0].set(True)
        return DeviceBatch(out_cols, mask_out)

    def _regroup_states(self, merged: DeviceBatch):
        cap = merged.capacity
        cols = {n: value_from_column(c) for n, c in merged.columns.items()}
        keys = [cols[k.name] for k in self._keys]
        active = merged.mask
        addends = []
        for out_name, agg in zip(self._agg_names, self._aggs):
            for st in agg.states:
                cname = _state_col_name(out_name, agg, st.suffix)
                data = cols[cname].full_data(cap)
                keep = active[:, None] if data.ndim > 1 else active
                data = jnp.where(keep, data, st.identity())
                addends.append((data, st.combine))
        domain = G.array_mode_domain(keys) if keys else None
        if keys and domain is not None and domain <= cap:
            gk, gs, gmask = G.reduce_array_mode(
                keys, addends, active, cap, domain)
            out_cap = domain
        else:
            gk, gs, gmask = G.reduce_sort_mode(keys, addends, active, cap,
                                               ranges=self._key_ranges)
            out_cap = cap
        return gk, gs, gmask, out_cap

    def _compact_step(self, merged: DeviceBatch) -> DeviceBatch:
        """Re-group concatenated partials back into one state batch."""
        gk, gs, gmask, out_cap = self._regroup_states(merged)
        return self._make_state_batch(gk, gs, gmask, out_cap)

    def _merge_step(self, merged: DeviceBatch) -> DeviceBatch:
        """Re-group concatenated partial state batches; extract if final."""
        gk, gs, gmask, out_cap = self._regroup_states(merged)

        if self._step in (P.AggregationStep.PARTIAL,
                          P.AggregationStep.INTERMEDIATE):
            return self._make_state_batch(gk, gs, gmask, out_cap)

        # FINAL / SINGLE: extract results
        out_cols: Dict[str, DeviceColumn] = {}
        for k, v in zip(self._keys, gk):
            out_cols[k.name] = v.to_column(out_cap)
        i = 0
        for out_name, agg, d in zip(self._agg_names, self._aggs,
                                    self._agg_dicts):
            n_states = len(agg.states)
            res = agg.extract(gs[i:i + n_states], gmask)
            i += n_states
            col = res.to_column(out_cap)
            if res.dtype.is_string and col.dictionary is None:
                col = DeviceColumn(col.data, col.validity, col.dtype, d)
            out_cols[out_name] = col
        return DeviceBatch(out_cols, gmask)

    # ---- operator contract -------------------------------------------------

    def add_input(self, batch: DeviceBatch):
        # remember dictionaries of string aggregate inputs for extraction
        for j, agg_call in enumerate(self._agg_calls):
            if agg_call.inputs and agg_call.inputs[0].dtype.is_string:
                from velox_tpu.core import expressions as ex
                inp = agg_call.inputs[0]
                if isinstance(inp, ex.FieldAccess):
                    col = batch.columns.get(inp.name)
                    if col is not None:
                        self._agg_dicts[j] = col.dictionary
        if self._collect_mode:
            if self._pct_split \
                    and self._step is not P.AggregationStep.PARTIAL:
                # INTERMEDIATE/FINAL inputs already are knot batches
                self._collect_rows.append(batch)
            else:
                self._collect_rows.append(self._strip_errs(
                    self._collect_prep_fn(batch)))
            return
        if self._keys:
            if self._single_shot:
                if self._step is P.AggregationStep.SINGLE:
                    self._partials.append(self._strip_errs(
                        self._passthrough_fn(batch)))
                else:  # FINAL/INTERMEDIATE: already state batches
                    self._partials.append(batch)
                self._buffered_rows += batch.capacity
                if self._buffered_rows > self._single_merge_max_rows:
                    merged = self._shrink(self._compact_fn(
                        concat_batches(self._partials)))
                    self._partials = [merged]
                    self._buffered_rows = merged.capacity
                return
            if self._abandoned:
                self._outputs.append(self._strip_errs(
                    self._passthrough_fn(batch)))
                return
            if self._step is P.AggregationStep.PARTIAL:
                self._in_rows.append(batch.num_active())
            self._partials.append(self._strip_errs(
                self._partial_fn(batch)))
            if len(self._partials) >= self._compact_threshold:
                self._compact_partials()
        else:
            self._accumulate_global(batch)

    def _strip_errs(self, out: DeviceBatch) -> DeviceBatch:
        if out.errors is not None:
            self.error_scalars.append(out.errors)
            out = DeviceBatch(out.columns, out.mask)
        return out

    def device_state(self):
        return (self._partials, self._outputs,
                getattr(self, "_collect_rows", None),
                getattr(self, "_global_state", None))

    @staticmethod
    def _pow2_suffix_actives(mask):
        """Active-row counts past each power-of-two boundary (traced;
        ~log2(cap) scalars). Fetching this small vector WITH the group
        count makes the shrink decision ONE host sync instead of two."""
        cap = mask.shape[0]
        cm = jnp.cumsum(mask.astype(jnp.int32))
        total = cm[-1]
        bounds = [1 << k for k in range((max(1, cap - 1)).bit_length())
                  if (1 << k) < cap]
        if not bounds:
            return total, jnp.zeros((1,), jnp.int32)
        idx = jnp.asarray([b - 1 for b in bounds], jnp.int32)
        return total, total - cm[idx]  # actives at positions >= 2^k

    def _compact_partials(self):
        """Fold all pending partial runs into one right-sized state batch.

        ONE host read per fold (group count + pow2-boundary tail counts
        in a single device_get) picks the static capacity — the analogue
        of velox's adaptive hash-table resize, HashTable::decideHashMode."""
        merged = self._compact_fn(concat_batches(self._partials))
        from velox_tpu.exec.jit_cache import cached_jit
        suffix_fn = cached_jit(("pow2_suffix", merged.capacity),
                               lambda: jax.jit(self._pow2_suffix_actives))
        rows_dev = (sum(self._in_rows)
                    if (self._step is P.AggregationStep.PARTIAL
                        and not self._abandoned and self._in_rows)
                    else None)
        fetched = jax.device_get((suffix_fn(merged.mask), rows_dev))
        (num_groups, tails), rows = fetched
        num_groups = int(num_groups)
        if rows is not None:
            rows = int(rows)
            if rows >= self._abandon_min_rows \
                    and num_groups >= self._abandon_min_pct * rows:
                # grouping is not reducing cardinality: emit the compacted
                # run and switch to passthrough (velox partial-agg abandon)
                self._abandoned = True
                self._outputs.append(merged)
                self._partials = []
                return
        merged = self._shrink(merged, num_groups, tails)
        if self._host_offload:
            from velox_tpu.common import metrics as M
            from velox_tpu.exec.memory import HostBatch
            M.record_counter(M.K_AGG_HOST_OFFLOADS)
            self._host_runs.append(HostBatch(merged))
            self._partials = []
        else:
            self._partials = [merged]

    def _shrink(self, merged: DeviceBatch,
                num_groups: Optional[int] = None,
                tails=None) -> DeviceBatch:
        """Cut a compacted run down to a pow2 capacity near its group count
        (the analogue of HashTable::decideHashMode resize). ``tails``
        (pow2-boundary suffix actives, from _pow2_suffix_actives) avoids
        a second device round trip; without it both the count and the
        boundary tails come back in one fetch."""
        from velox_tpu.exec.batch_utils import slice_batch
        if num_groups is None:
            from velox_tpu.exec.jit_cache import cached_jit
            suffix_fn = cached_jit(
                ("pow2_suffix", merged.capacity),
                lambda: jax.jit(self._pow2_suffix_actives))
            num_groups, tails = jax.device_get(suffix_fn(merged.mask))
            num_groups = int(num_groups)
        cap = merged.capacity
        want = max(1024, 1 << (max(1, num_groups - 1)).bit_length())
        if want < cap:
            # Safe only when groups are a dense prefix (hash mode); array
            # mode scatters groups over the domain — verify before cutting.
            if tails is not None:
                k = max(0, int(want).bit_length() - 1)
                tail = int(tails[k]) if k < len(tails) else 0
            else:
                tail = int(jax.device_get(jnp.sum(merged.mask[want:])))
            if tail == 0:
                from velox_tpu.exec.jit_cache import cached_jit
                fn = cached_jit(("agg_shrink_slice", want),
                                lambda: jax.jit(slice_batch,
                                                static_argnums=(1, 2)))
                merged = fn(merged, 0, want)
        return merged

    def no_more_input(self):
        super().no_more_input()
        if self._collect_mode:
            if self._collect_rows:
                merged = (self._collect_rows[0]
                          if len(self._collect_rows) == 1
                          else concat_batches(self._collect_rows))
                self._collect_rows = []
                if not self._pct_split:
                    self._outputs.append(self._collect_final_fn(merged))
                elif self._step is P.AggregationStep.FINAL:
                    self._outputs.append(self._pct_final_fn(merged))
                else:  # PARTIAL/INTERMEDIATE -> knot summary
                    self._outputs.append(self._pct_compress_fn(merged))
            self._finished_inputs = True
            return
        if self._keys:
            if self._host_runs:
                self._partials = [hb.restore() for hb in self._host_runs] \
                    + self._partials
                self._host_runs = []
            if self._partials:
                total_cap = sum(b.capacity for b in self._partials)
                if total_cap <= self._single_merge_max_rows:
                    # one sort over everything buffered (round 3); shrink
                    # the output capacity to ~the group count — the merge
                    # keeps the 4x-8x padded concat capacity otherwise,
                    # and every downstream operator (join build, TopN)
                    # pays for the padding (2 scalar fetches vs 4x work)
                    self._outputs.append(self._shrink(self._merge_fn(
                        concat_batches(self._partials))))
                    self._partials = []
                else:
                    # hierarchical run merge: fold runs k at a time so
                    # peak HBM is bounded by k runs + one table, instead
                    # of one giant concat of every run (a 2M-row-split Q3
                    # SF1 needed 22.6G that way). Parity: velox's
                    # multi-level spill merge (kMaxSpillLevel recursion).
                    k = 4
                    runs = self._partials
                    self._partials = []
                    while len(runs) > 1:
                        head, runs = runs[:k], runs[k:]
                        folded = self._compact_fn(concat_batches(head))
                        runs.append(self._shrink(folded))
                    self._outputs.append(self._merge_fn(runs[0]))
        else:
            self._outputs = [self._extract_global()]
        self._finished_inputs = True

    def get_output(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def is_finished(self):
        return self._no_more_input and not self._outputs

    # ---- global (no grouping keys) ----------------------------------------

    _global_state: Optional[List] = None

    def _accumulate_global(self, batch: DeviceBatch):
        if not hasattr(self, "_global_fn"):
            def _step(batch, state):
                errs = []
                if self._pre_fn is not None:
                    batch = self._pre_fn(batch)
                    if batch.errors is not None:
                        errs.append(batch.errors)
                raw = self._step in (P.AggregationStep.PARTIAL,
                                     P.AggregationStep.SINGLE)
                _, addends, _ = self._eval_keys_and_addends(
                    batch, raw, err_sink=errs)
                new_state = []
                for (data, combine), s in zip(addends, state):
                    if combine == "sum":
                        new_state.append(s + jnp.sum(data, axis=0))
                    elif combine == "min":
                        new_state.append(jnp.minimum(
                            s, jnp.min(data, axis=0)))
                    else:
                        new_state.append(jnp.maximum(
                            s, jnp.max(data, axis=0)))
                return new_state, (sum(errs) if errs else None)
            _c_ok = not any(a.inputs and a.inputs[0].dtype.is_string
                            for a in self._agg_calls)
            if _c_ok:
                from velox_tpu.exec.jit_cache import cached_jit
                self._global_fn = cached_jit(
                    ("agg_global", self.node, self._pre_fn is None,
                     self._key_ranges),
                    lambda: jax.jit(_step))
            else:
                self._global_fn = jax.jit(_step)
        if self._global_state is None:
            self._global_state = []
            for agg in self._aggs:
                for st in agg.states:
                    ident = jnp.asarray(st.identity(),
                                        st.dtype.np_dtype())
                    if st.width > 1:
                        ident = jnp.full((st.width,), ident)
                    self._global_state.append(ident)
        self._global_state, err = self._global_fn(batch,
                                                  self._global_state)
        if err is not None:
            self.error_scalars.append(err)

    def _extract_global(self) -> DeviceBatch:
        if self._global_state is None:
            self._accumulate_empty_global()
        state = self._global_state
        out_cols: Dict[str, DeviceColumn] = {}
        i = 0
        one = jnp.ones((1,), dtype=bool)
        if self._step in (P.AggregationStep.PARTIAL,
                          P.AggregationStep.INTERMEDIATE):
            for out_name, agg in zip(self._agg_names, self._aggs):
                for st in agg.states:
                    cname = _state_col_name(out_name, agg, st.suffix)
                    out_cols[cname] = DeviceColumn(
                        state[i][None], None, st.dtype, None)
                    i += 1
            return DeviceBatch(out_cols, one)
        for out_name, agg, d in zip(self._agg_names, self._aggs,
                                    self._agg_dicts):
            n_states = len(agg.states)
            arrays = [s[None] for s in state[i:i + n_states]]
            res = agg.extract(arrays, one)
            i += n_states
            col = res.to_column(1)
            if res.dtype.is_string and col.dictionary is None:
                col = DeviceColumn(col.data, col.validity, col.dtype, d)
            out_cols[out_name] = col
        return DeviceBatch(out_cols, one)

    def _accumulate_empty_global(self):
        self._global_state = []
        for agg in self._aggs:
            for st in agg.states:
                self._global_state.append(
                    jnp.asarray(st.identity(), st.dtype.np_dtype()))
