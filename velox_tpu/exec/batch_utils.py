"""Batch-level utilities: concat, compaction, chunking.

Compaction (moving active rows to the front) is the device analogue of the
reference's selection-vector materialization — done only at operator
boundaries that profit (exchange, buffered sorts), per SURVEY.md §7.1.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from velox_tpu.vector.device import DeviceBatch, DeviceColumn


def concat_batches(batches: List[DeviceBatch]) -> DeviceBatch:
    """Concatenate batches (same schema) into one larger batch."""
    if len(batches) == 1:
        return batches[0]
    names = batches[0].names
    cols = {}

    def concat_cols(parts):
        first = parts[0]
        if first.dtype.is_string and first.dictionary is None \
                and getattr(first.data, "ndim", 1) == 2 \
                and len(parts) > 1:
            # raw string columns: align byte-matrix size classes by
            # zero-padding the narrower parts, then concat rows
            w = max(p.data.shape[1] for p in parts)
            datas = [jnp.pad(p.data, ((0, 0), (0, w - p.data.shape[1])))
                     if p.data.shape[1] < w else p.data for p in parts]
            data = jnp.concatenate(datas)
        else:
            data = jnp.concatenate([p.data for p in parts])
        if any(p.validity is not None for p in parts):
            validity = jnp.concatenate([
                p.validity if p.validity is not None
                else jnp.ones((p.capacity,), dtype=bool)
                for p in parts])
        else:
            validity = None
        children = first.children
        if first.dtype.kind is T.TypeKind.ROW \
                or first.dtype.is_long_decimal \
                or (first.dtype.is_string and first.dictionary is None
                    and getattr(first.data, "ndim", 1) == 2):
            # row-aligned children (ROW fields, decimal hi limb, raw
            # string lens) concatenate with the parent
            children = tuple(
                concat_cols([p.children[i] for p in parts])
                for i in range(len(first.children)))
        elif first.dtype.is_complex and len(parts) > 1:
            # ARRAY/MAP: element children concatenate in ELEMENT space
            # and every part's row starts shift by the element capacity
            # before it (explicit starts — keeping only part 0's
            # children pointed part 2+'s rows at the wrong elements)
            children = tuple(
                concat_cols([p.children[i] for p in parts])
                for i in range(len(first.children)))
            off = 0
            sp = []
            for p in parts:
                sp.append(p.offsets() + jnp.int32(off))
                off += p.children[0].capacity
            return DeviceColumn(data, validity, first.dtype,
                                first.dictionary, children,
                                jnp.concatenate(sp))
        return DeviceColumn(data, validity, first.dtype,
                            first.dictionary, children)

    from velox_tpu import types as T
    for name in names:
        cols[name] = concat_cols([b.columns[name] for b in batches])
    mask = jnp.concatenate([b.mask for b in batches])
    return DeviceBatch(cols, mask)


def compact(batch: DeviceBatch) -> DeviceBatch:
    """Move active rows to the front (stable), preserving order.

    cumsum + scatter, no sort."""
    cap = batch.capacity
    dense = jnp.cumsum(batch.mask.astype(jnp.int32)) - 1
    target = jnp.where(batch.mask, dense, jnp.int32(cap))

    def scat(a):
        return jnp.zeros_like(a).at[target].set(a, mode="drop")

    # map_column_rows: row-aligned children (ROW fields, the
    # long-decimal hi limb) must compact along with the parent
    cols = {name: map_column_rows(col, scat)
            for name, col in batch.columns.items()}
    n = batch.num_active()
    mask = jnp.arange(cap, dtype=jnp.int32) < n
    return DeviceBatch(cols, mask)


def map_column_rows(col: DeviceColumn, f) -> DeviceColumn:
    """Apply a row-axis transform to a column, recursing into
    row-aligned children: ROW fields and the long-decimal hi limb.
    ARRAY/MAP children live in element space and stay SHARED — the
    per-row element START offsets are materialized and transformed
    along, so reordering/duplicating rows keeps each row's slice valid
    (vector/device.py DeviceColumn.starts)."""
    from velox_tpu import types as T
    data = f(col.data)
    validity = f(col.validity) if col.validity is not None else None
    children = col.children
    starts = None
    if col.dtype.kind is T.TypeKind.ROW or col.dtype.is_long_decimal:
        children = tuple(map_column_rows(c, f) for c in col.children)
    elif col.dtype.is_string and col.dictionary is None \
            and getattr(col.data, "ndim", 1) == 2:
        # raw string column: the lens child is row-aligned (the byte
        # matrix itself transforms along axis 0 like any column)
        children = tuple(map_column_rows(c, f) for c in col.children)
    elif col.dtype.is_complex:
        starts = f(col.offsets())
    return DeviceColumn(data, validity, col.dtype, col.dictionary,
                        children, starts)


def take(batch: DeviceBatch, indices, valid_rows) -> DeviceBatch:
    """Gather rows by index; `valid_rows` becomes the new mask."""
    cols = {
        name: map_column_rows(col, lambda a: a[indices])
        for name, col in batch.columns.items()
    }
    return DeviceBatch(cols, valid_rows)


def slice_batch(batch: DeviceBatch, start: int, length: int) -> DeviceBatch:
    """Static slice of a batch's rows (used to re-chunk large batches)."""
    def f(a):
        return jax.lax.dynamic_slice_in_dim(a, start, length)
    cols = {name: map_column_rows(col, f)
            for name, col in batch.columns.items()}
    mask = jax.lax.dynamic_slice_in_dim(batch.mask, start, length)
    return DeviceBatch(cols, mask)


def compact_batch(batch: DeviceBatch, out_cap: int) -> DeviceBatch:
    """Gather active rows into a dense prefix of a smaller batch (traced;
    out_cap static). Used before host extraction so padded capacities do
    not ride the device->host transfer."""
    import jax.numpy as jnp
    cap = batch.capacity
    m = batch.mask.astype(jnp.int32)
    pos = jnp.cumsum(m) - m
    tgt = jnp.where(batch.mask, jnp.minimum(pos, out_cap - 1),
                    jnp.int32(out_cap))

    def scatter(a, fill=0):
        out = jnp.zeros((out_cap + 1,) + a.shape[1:], a.dtype)
        return out.at[tgt].set(a, mode="drop")[:out_cap]

    cols = {n: map_column_rows(c, scatter)
            for n, c in batch.columns.items()}
    n_active = jnp.sum(m)
    mask = jnp.arange(out_cap, dtype=jnp.int32) < n_active
    return DeviceBatch(cols, mask)
