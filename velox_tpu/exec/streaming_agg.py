"""Streaming aggregation: group-by over key-sorted input, no table.

Role parity: ``velox/exec/StreamingAggregation.h:29`` — when rows arrive
sorted by the grouping keys, groups are contiguous runs; aggregate states
accumulate run-by-run and a group is final the moment the key changes.

Device-first redesign: per input batch one jitted step
  1. stably compacts active rows to a dense prefix (no sort — the input
     order IS the group order),
  2. finds run boundaries by adjacent key comparison and segment-reduces
     each run's addends (ops/wide.py segmented_reduce_sorted),
  3. merges the carried last-group state when the first run continues it,
  4. emits every run except the last (which may continue into the next
     batch) and carries the last run's (key, state) forward as device
     scalars.
The carry is a tiny pytree of scalars — no growable state, no host sync
per batch. ``no_more_input`` flushes the carry as the final group.

Only StateSpec-based aggregates with scalar (width-1) states stream;
collect aggregates and HLL-style vector states go through the regular
AggregationOperator.
"""

from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.core import plan as P
from velox_tpu.exec.aggregation import AggregationOperator
from velox_tpu.exec.groupby import group_keys_sorted
from velox_tpu.exec.operator import Operator
from velox_tpu.expression.eval import EvalValue
from velox_tpu.functions.aggregates import CollectAgg, resolve_aggregate
from velox_tpu.ops.wide import scatter_unique_set, segmented_reduce_sorted
from velox_tpu.vector.device import DeviceBatch, DeviceColumn

_COMBINE = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}


def streaming_supported(node: P.AggregationNode) -> bool:
    """Streaming handles SINGLE-step grouped aggregation with scalar
    combinable states (no collect aggregates, no vector states)."""
    if node.step is not P.AggregationStep.SINGLE or not node.grouping_keys:
        return False
    try:
        aggs = [resolve_aggregate(a.name, [i.dtype for i in a.inputs])
                for a in node.aggregates]
    except (KeyError, NotImplementedError):
        return False
    return not any(isinstance(a, CollectAgg)
                   or any(st.width > 1 for st in a.states) for a in aggs)


class StreamingAggregationOperator(Operator):
    """Group-by over input sorted by the grouping keys."""

    # reuse the addend-evaluation logic (keys + per-row state addends)
    _eval_keys_and_addends = AggregationOperator._eval_keys_and_addends

    def __init__(self, node: P.AggregationNode, pre_fn=None):
        super().__init__(node)
        assert streaming_supported(node)
        self._pre_fn = pre_fn
        self._step = node.step
        self._keys = list(node.grouping_keys)
        self._agg_calls = list(node.aggregates)
        self._agg_names = list(node.aggregate_names)
        self._aggs = [resolve_aggregate(a.name, [i.dtype for i in a.inputs])
                      for a in self._agg_calls]
        self._specs = [st for a in self._aggs for st in a.states]
        self._outputs: List[DeviceBatch] = []
        self.error_scalars: List = []
        self._carry = None
        self._key_dicts: List = [None] * len(self._keys)
        self._agg_dicts: List = [None] * len(self._aggs)
        # cache traced programs across Tasks unless string dictionaries
        # would be baked at trace time (mirrors exec/aggregation.py)
        cacheable = not any(k.dtype.is_string for k in self._keys) \
            and not any(c.inputs and c.inputs[0].dtype.is_string
                        for c in self._agg_calls)
        if cacheable:
            from velox_tpu.exec.jit_cache import cached_jit
            self._step_fn = cached_jit(
                ("streaming_agg", node, pre_fn is None),
                lambda: jax.jit(self._batch_step))
            self._flush_fn = cached_jit(
                ("streaming_agg_flush", node),
                lambda: jax.jit(self._flush))
        else:
            self._step_fn = jax.jit(self._batch_step)
            self._flush_fn = jax.jit(self._flush)

    # ---- carry pytree ------------------------------------------------------

    def _empty_carry(self):
        kd, kv = [], []
        for k in self._keys:
            kd.append(jnp.zeros((), k.dtype.np_dtype()))
            kv.append(jnp.ones((), bool))
        states = [jnp.asarray(st.identity(), st.dtype.np_dtype())
                  for st in self._specs]
        return (jnp.zeros((), bool), tuple(kd), tuple(kv), tuple(states))

    # ---- traced programs ---------------------------------------------------

    def _batch_step(self, batch: DeviceBatch, carry):
        cvalid, ckd, ckv, cstates = carry
        errs = []
        if self._pre_fn is not None:
            batch = self._pre_fn(batch)
            if batch.errors is not None:
                errs.append(batch.errors)
        keys, addends, active = self._eval_keys_and_addends(
            batch, True, err_sink=errs)
        cap = batch.capacity
        # 1. stable compaction of active rows to a dense prefix
        pos = jnp.cumsum(active.astype(jnp.int32)) - 1
        tgt = jnp.where(active, pos, jnp.int32(cap))
        n_rows = jnp.sum(active.astype(jnp.int32))
        active_d = jnp.arange(cap, dtype=jnp.int32) < n_rows
        # 2. run boundaries by adjacent comparison of dense keys
        dkeys = []
        neq = jnp.zeros((cap,), bool)
        for v in keys:
            kd = scatter_unique_set(cap + 1, tgt, v.full_data(cap))[:cap]
            kv = None
            if v.validity is not None:
                kv = jnp.ones((cap,), bool).at[tgt].set(
                    v.full_validity(cap), mode="drop")
                pv = jnp.concatenate([kv[:1], kv[:-1]])
                neq = neq | (kv != pv)
            prev = jnp.concatenate([kd[:1], kd[:-1]])
            ne = kd != prev
            if kv is not None:
                ne = ne & kv & pv  # null==null: only non-null diffs split
            neq = neq | ne
            dkeys.append(EvalValue(kd, kv, v.dtype, v.dictionary))
        boundary = neq.at[0].set(True)
        gid = jnp.cumsum(boundary.astype(jnp.int32)) - 1
        num_groups = jnp.sum((boundary & active_d).astype(jnp.int32))
        gstates = []
        for (data, combine), st in zip(addends, self._specs):
            dd = scatter_unique_set(cap + 1, tgt, data)[:cap]
            dd = jnp.where(active_d, dd,
                           jnp.asarray(st.identity(), dd.dtype))
            gstates.append(segmented_reduce_sorted(
                dd, gid, boundary, active_d, cap, combine))
        gkeys, _ = group_keys_sorted(
            dkeys, jnp.arange(cap, dtype=jnp.int32), gid, boundary,
            active_d, num_groups, cap)
        # 3. carry continues group 0 iff keys equal (null == null)
        same = cvalid & (num_groups > 0)
        for ck, ckvf, gv in zip(ckd, ckv, gkeys):
            g0 = gv.data[0]
            g0v = (gv.validity[0] if gv.validity is not None
                   else jnp.ones((), bool))
            same = same & ((g0v & ckvf & (g0 == ck)) | (~g0v & ~ckvf))
        merged = []
        for g, cs, st in zip(gstates, cstates, self._specs):
            comb = _COMBINE[st.combine]
            merged.append(g.at[0].set(
                jnp.where(same, comb(g[0], cs.astype(g.dtype)), g[0])))
        gstates = merged
        # 4. emit: row 0 = flushed old carry (when not continued), rows
        #    1..cap = groups 0..num_groups-2 (hold the last group back)
        emit_carry = cvalid & ~same & (num_groups > 0)
        emit_g = jnp.arange(cap, dtype=jnp.int32) < (num_groups - 1)
        out_active = jnp.concatenate([emit_carry[None], emit_g])
        out_states = [jnp.concatenate([cs.astype(g.dtype)[None], g])
                      for cs, g in zip(cstates, gstates)]
        out_keys = []
        for ck, ckvf, gv in zip(ckd, ckv, gkeys):
            data = jnp.concatenate([ck[None], gv.data])
            validity = None
            if gv.validity is not None:
                validity = jnp.concatenate([ckvf[None], gv.validity])
            out_keys.append((data, validity))
        out = self._extract(out_keys, out_states, out_active)
        # new carry = the held-back last group (or the old carry unchanged)
        has = num_groups > 0
        last = jnp.clip(num_groups - 1, 0, cap - 1)
        nckd = tuple(jnp.where(has, gv.data[last], ck)
                     for ck, gv in zip(ckd, gkeys))
        nckv = tuple(
            jnp.where(has,
                      gv.validity[last] if gv.validity is not None
                      else jnp.ones((), bool), ckvf)
            for ckvf, gv in zip(ckv, gkeys))
        ncst = tuple(jnp.where(has, g[last],
                               cs.astype(g.dtype)).astype(cs.dtype)
                     for cs, g in zip(cstates, gstates))
        new_carry = (cvalid | has, nckd, nckv, ncst)
        err = sum(errs) if errs else None
        return out, new_carry, err

    def _extract(self, out_keys, out_states, out_active) -> DeviceBatch:
        m = out_active.shape[0]
        cols: Dict[str, DeviceColumn] = {}
        for k, (data, validity), d in zip(self._keys, out_keys,
                                          self._key_dicts):
            cols[k.name] = DeviceColumn(data, validity, k.dtype, d)
        i = 0
        for out_name, agg, d in zip(self._agg_names, self._aggs,
                                    self._agg_dicts):
            n = len(agg.states)
            res = agg.extract(out_states[i:i + n], out_active)
            i += n
            col = res.to_column(m)
            if res.dtype.is_string and col.dictionary is None:
                col = DeviceColumn(col.data, col.validity, col.dtype, d)
            cols[out_name] = col
        return DeviceBatch(cols, out_active)

    def _flush(self, carry) -> DeviceBatch:
        cvalid, ckd, ckv, cstates = carry
        out_keys = [(ck[None], kv[None]) for ck, kv in zip(ckd, ckv)]
        out_states = [cs[None] for cs in cstates]
        return self._extract(out_keys, out_states, cvalid[None])

    # ---- operator contract -------------------------------------------------

    def add_input(self, batch: DeviceBatch):
        # remember input dictionaries for extraction (string keys/aggs)
        from velox_tpu.core import expressions as ex
        for i, k in enumerate(self._keys):
            col = batch.columns.get(k.name)
            if col is not None and self._key_dicts[i] is None:
                self._key_dicts[i] = col.dictionary
        for j, call in enumerate(self._agg_calls):
            if call.inputs and call.inputs[0].dtype.is_string \
                    and isinstance(call.inputs[0], ex.FieldAccess):
                col = batch.columns.get(call.inputs[0].name)
                if col is not None:
                    self._agg_dicts[j] = col.dictionary
        if self._carry is None:
            self._carry = self._empty_carry()
        out, self._carry, err = self._step_fn(batch, self._carry)
        if err is not None:
            self.error_scalars.append(err)
        self._outputs.append(out)

    def no_more_input(self):
        super().no_more_input()
        if self._carry is not None:
            self._outputs.append(self._flush_fn(self._carry))
        self._finished_inputs = True

    def get_output(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def is_finished(self):
        return self._no_more_input and not self._outputs
