"""Sort operators: OrderBy and TopN.

Role parity: ``velox/exec/OrderBy.h:35`` (SortBuffer + PrefixSort) and
``velox/exec/TopN.h:23``.

PrefixSort's normalized binary keys (exec/prefixsort/PrefixSortEncoder.h:31)
become order-preserving unsigned words packed into u64 lanes and sorted by
one ``lax.sort`` (exec/sort.py). TopN keeps a device-resident top-k buffer
merged with each incoming batch (one sort per batch), the analogue of
the reference's bounded row-container heap.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp

from velox_tpu.core import plan as P
from velox_tpu.exec.batch_utils import concat_batches, slice_batch, take
from velox_tpu.exec.operator import Operator
from velox_tpu.exec.sort import sort_permutation, sort_words
from velox_tpu.expression.eval import value_from_column
from velox_tpu.vector.device import DeviceBatch


def sort_batch(batch: DeviceBatch, keys, orders,
               ranges=None) -> DeviceBatch:
    """Stable sort of a batch's rows by keys/orders; inactive rows last.
    ``ranges`` (per key, optional) narrows the normalized sort words via
    static column stats — fewer sort lanes (exec/sort.py)."""
    from velox_tpu.exec.sort import radix_sort_perm
    cap = batch.capacity
    key_vals = [value_from_column(batch.columns[k.name]) for k in keys]
    words, bits = sort_words(key_vals, orders, cap, batch.mask,
                             ranges=ranges)
    perm = radix_sort_perm(words, bits, cap)
    return take(batch, perm, batch.mask[perm])


def _key_ranges(node, keys):
    from velox_tpu.core.stats import resolve_column_stats
    return tuple(resolve_column_stats(node.source, k.name) for k in keys)


class OrderByOperator(Operator):
    """Full sort: buffer all input, sort once at the end."""

    def __init__(self, node: P.OrderByNode, offload_bytes=None,
                 pool=None, host_budget_bytes=None, spill_dir=None,
                 max_spill_bytes=None):
        super().__init__(node)
        from velox_tpu.common import metrics as M
        from velox_tpu.exec.memory import OffloadBuffer
        self._keys = list(node.keys)
        self._orders = list(node.orders)
        # buffered input spills to host RAM past the budget, and past
        # the host budget to DISK spill files (parity: velox Spiller
        # kOrderBy, exec/Spiller.h:29)
        self._buffer = OffloadBuffer(offload_bytes,
                                     metric_key=M.K_SORT_OFFLOADS,
                                     pool=pool,
                                     host_budget_bytes=host_budget_bytes,
                                     spill_dir=spill_dir,
                                     max_spill_bytes=max_spill_bytes)
        self._out: Optional[DeviceBatch] = None
        rngs = _key_ranges(node, self._keys)
        from velox_tpu.exec.jit_cache import cached_jit
        # rngs in the key: the traced body bakes connector column stats,
        # which can change if a table is re-registered (jit_cache contract)
        self._sort_fn = cached_jit(
            ("orderby", node, rngs), lambda: jax.jit(
                lambda b: sort_batch(b, self._keys, self._orders, rngs)))

    def add_input(self, batch):
        self._buffer.add(batch)

    def device_state(self):
        return self._out

    def no_more_input(self):
        super().no_more_input()
        if len(self._buffer):
            self._out = self._sort_fn(
                concat_batches(self._buffer.restore_all()))

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None


class TopNOperator(Operator):
    """Bounded sort: device-resident top-k buffer, merged per batch."""

    def __init__(self, node: P.TopNNode):
        super().__init__(node)
        self._keys = list(node.keys)
        self._orders = list(node.orders)
        self._n = node.count
        self._topk: Optional[DeviceBatch] = None
        self._out: Optional[DeviceBatch] = None
        # static buffer capacity: round n up for alignment
        self._buf_cap = max(1024, -(-node.count // 128) * 128)

        rngs = _key_ranges(node, self._keys)

        def _merge(buf: Optional[DeviceBatch], batch: DeviceBatch):
            """Key-ONLY sort: sort (packed key, iota), slice the top buf_cap
            indices, and gather full rows just for those — the payload never
            rides the sort (chosen for the engine's first accelerator, where
            full-payload sorts were gather-bound; not yet measured on the
            H100)."""
            from velox_tpu.exec.sort import radix_sort_perm
            merged = concat_batches([buf, batch]) if buf is not None \
                else batch
            cap = merged.capacity
            key_vals = [value_from_column(merged.columns[k.name])
                        for k in self._keys]
            words, bits = sort_words(key_vals, self._orders, cap,
                                     merged.mask, ranges=rngs)
            perm = radix_sort_perm(words, bits, cap)
            k = min(self._buf_cap, cap)
            top = perm[:k]
            s = take(merged, top, merged.mask[top])
            keep = (jnp.arange(k, dtype=jnp.int32) < self._n) & s.mask
            return s.with_mask(keep)

        from velox_tpu.exec.jit_cache import cached_jit
        self._merge_fn = cached_jit(("topn", node, rngs),
                                    lambda: jax.jit(_merge))

    def add_input(self, batch):
        self._topk = self._merge_fn(self._topk, batch)

    def device_state(self):
        return (self._topk, self._out)

    def no_more_input(self):
        super().no_more_input()
        self._out, self._topk = self._topk, None

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None
