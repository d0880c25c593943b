"""Group-by core: sort + segment-reduce, plus the dense "array mode".

Role parity: ``velox/exec/GroupingSet.cpp`` + ``velox/exec/HashTable.cpp``
(groupProbe / kArray / kNormalizedKey / kHash modes, HashTable.h:122).

Device-first redesign (SURVEY.md §7.1):

  * **array mode** (parity: kArray, HashTable.h:119): when every key has a
    small known domain (dictionary-encoded strings, booleans), the group id
    is the mixed-radix combination of dictionary ids — a pure index — and
    aggregation is one ``segment_sum`` per state. No sort, no probe.
  * **hash mode** (parity: kNormalizedKey/kHash): the scatter-probe device
    hash table (exec/hashtable.py) assigns every row a slot; addends are
    segment-reduced by slot and groups compacted to a dense prefix. No sorting:
    chosen for the engine's first accelerator, where lax.sort compiles were
    slow; not yet measured on the H100.

Both modes are pure traced JAX — one compiled program per (schema,
capacity). Partial/final split (velox AggregationNode steps) reuses the same
machinery: partial emits state columns; final re-groups state columns and
extracts results.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue

_SEGMENT_OPS = {
    "sum": jax.ops.segment_sum,
    "min": jax.ops.segment_min,
    "max": jax.ops.segment_max,
}


def _dtype_max(dt):
    return jnp.inf if jnp.issubdtype(dt, jnp.floating) else \
        jnp.iinfo(dt).max


def _dtype_min(dt):
    return -jnp.inf if jnp.issubdtype(dt, jnp.floating) else \
        jnp.iinfo(dt).min


def array_mode_domain(keys: List[EvalValue]) -> Optional[int]:
    """Total combined domain if all keys are small-domain, else None.
    Parity: kArrayHashMaxSize cutoff (velox/exec/HashTable.h:119)."""
    total = 1
    for v in keys:
        if v.dtype.is_string and v.dictionary is not None:
            total *= max(1, len(v.dictionary))
        elif v.dtype.kind is T.TypeKind.BOOLEAN:
            total *= 2
        else:
            return None
        if v.validity is not None:
            total += 1  # null bucket handled by +1 radix; conservative
    return total if total <= (1 << 21) else None


def group_ids_array_mode(keys: List[EvalValue], capacity: int, active):
    """Mixed-radix dense group id per row. Returns (ids, num_groups)."""
    ids = jnp.zeros((capacity,), dtype=jnp.int32)
    domain = 1
    for v in keys:
        if v.dtype.is_string:
            card = max(1, len(v.dictionary))
        else:
            card = 2
        data = v.full_data(capacity).astype(jnp.int32)
        if v.dtype.kind is T.TypeKind.BOOLEAN:
            data = data.astype(jnp.int32)
        if v.validity is not None:
            # nulls get their own id = card (radix grows by 1)
            data = jnp.where(v.full_validity(capacity), data, card)
            card += 1
        ids = ids * card + data
        domain *= card
    return ids, domain


def reduce_array_mode(
    keys: List[EvalValue],
    addends: List[Tuple[jnp.ndarray, str]],
    active,
    capacity: int,
    domain: int,
):
    """Dense segment reduce over the mixed-radix key domain.

    Returns (group_key_values, group_addends, group_mask) where arrays have
    length `domain` (occupied groups flagged in group_mask).
    """
    ids, _ = group_ids_array_mode(keys, capacity, active)
    ids = jnp.where(active, ids, domain)  # inactive -> overflow bucket
    occupied = jax.ops.segment_max(
        active.astype(jnp.int32), ids, num_segments=domain + 1)[:domain] > 0
    out_states = []
    small = domain <= 64
    for data, combine in addends:
        if small and data.ndim == 1:
            # tiny domains (Q1-style dict keys): one masked DENSE reduction per
            # group id instead of int64 scatter-adds (segment ops): chosen for
            # the engine's first accelerator, not yet measured on the H100
            op = {"sum": jnp.sum, "min": jnp.min, "max": jnp.max}[combine]
            ident = {"sum": jnp.zeros((), data.dtype),
                     "min": jnp.asarray(_dtype_max(data.dtype)),
                     "max": jnp.asarray(_dtype_min(data.dtype))}[combine]
            per = [op(jnp.where(ids == d, data, ident.astype(data.dtype)))
                   for d in range(domain)]
            out_states.append(jnp.stack(per))
            continue
        red = _SEGMENT_OPS[combine](data, ids, num_segments=domain + 1)
        out_states.append(red[:domain])
    # reconstruct key values per group from the mixed-radix id
    gid = jnp.arange(domain, dtype=jnp.int32)
    cards = []
    for v in keys:
        card = max(1, len(v.dictionary)) if v.dtype.is_string else 2
        if v.validity is not None:
            card += 1
        cards.append(card)
    key_vals = []
    rem = gid
    for card in reversed(cards):
        key_vals.append(rem % card)
        rem = rem // card
    key_vals.reverse()
    out_keys = []
    for v, kv, card in zip(keys, key_vals, cards):
        base_card = card - 1 if v.validity is not None else card
        is_null = (kv == base_card) if v.validity is not None else None
        data = jnp.minimum(kv, base_card - 1).astype(
            v.dtype.np_dtype() if not v.dtype.is_string else jnp.int32)
        validity = None if is_null is None else ~is_null
        out_keys.append(EvalValue(data, validity, v.dtype, v.dictionary))
    return out_keys, out_states, occupied


def sorted_group_info(keys: Sequence[EvalValue], active, capacity: int,
                      ranges=None):
    """Radix-sort rows by key words and segment equal-key runs.

    The device-first replacement for probing (parity: velox kNormalizedKey —
    normalized binary-comparable keys, exec/prefixsort/PrefixSortEncoder.h —
    but *sorted* instead of probed: one lax.sort over packed key lanes,
    where scatter-probe rounds are many random gather/scatter passes).

    Returns (perm, gid, boundary, active_sorted, num_groups):
      perm[i]        = original row at sorted position i (active first)
      gid[i]         = dense group id of sorted position i (grows with i)
      boundary[i]    = True iff sorted position i starts a new key run
      active_sorted  = active mask permuted
      num_groups     = traced count of active groups (gids 0..n-1)
    """
    from velox_tpu.exec.sort import sort_perm_key, sort_words

    words, bits = sort_words(keys, None, capacity, active, ranges=ranges)
    perm, skey = sort_perm_key(words, bits, capacity)
    # boundaries from the sorted key lanes, without re-gathering any word
    neq = jnp.zeros((capacity,), bool)
    for w in skey:
        prev = jnp.concatenate([w[:1], w[:-1]])
        neq = neq | (w != prev)
    boundary = neq.at[0].set(True)
    gid = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    active_sorted = jnp.asarray(active)[perm]
    num_groups = jnp.sum((boundary & active_sorted).astype(jnp.int32))
    return perm, gid, boundary, active_sorted, num_groups


def sorted_group_info_vals(keys: Sequence[EvalValue],
                           vals: Sequence[EvalValue], active, capacity: int,
                           ranges=None):
    """Like sorted_group_info, but rows within each key run are further
    sorted by ``vals`` (ascending, nulls first). Returns the usual
    5-tuple plus ``vboundary``: True where sorted position i starts a new
    (key, value) run — the dedup/run-length primitive for set_agg /
    map_agg / histogram (exec/aggregation.py collect pathway)."""
    from velox_tpu.exec.sort import (
        lane_bit_widths, lane_prefix_neq, sort_perm_key, sort_words,
        value_words,
    )

    words, bits = sort_words(keys, None, capacity, active, ranges=ranges)
    key_bits = int(sum(bits))
    for v in vals:
        if v.validity is not None:
            words.append((~v.full_validity(capacity)).astype(jnp.uint32))
            bits.append(1)
        vw = value_words(v, capacity)
        words.extend(vw)
        bits.extend([32] * len(vw))
    perm, skey = sort_perm_key(words, bits, capacity)
    lw = lane_bit_widths(int(sum(bits)))
    boundary = lane_prefix_neq(skey, lw, key_bits)
    vboundary = lane_prefix_neq(skey, lw, int(sum(bits)))
    gid = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    active_sorted = jnp.asarray(active)[perm]
    num_groups = jnp.sum((boundary & active_sorted).astype(jnp.int32))
    return perm, gid, boundary, active_sorted, num_groups, vboundary


def group_keys_sorted(keys: Sequence[EvalValue], perm, gid, boundary,
                      active_sorted, num_groups, capacity: int):
    """Dense per-group key columns (group g's key values), taken from each
    group's first sorted row. Shared by reduce_sort_mode and the collect
    aggregate pathway."""
    from velox_tpu.ops.wide import scatter_unique_set
    from velox_tpu.vector import strings as S
    group_mask = jnp.arange(capacity, dtype=jnp.int32) < num_groups
    target = jnp.where(boundary & active_sorted, gid, jnp.int32(capacity))
    out_keys = []
    for v in keys:
        ks = v.full_data(capacity)[perm]
        gd = scatter_unique_set(capacity + 1, target, ks)[:capacity]
        if v.validity is not None:
            vs = v.full_validity(capacity)[perm]
            validity = jnp.zeros((capacity,), bool) \
                .at[target].set(vs, mode="drop")
            validity = validity | ~group_mask  # padding rows: non-null
        else:
            validity = None
        if S.is_raw(v):
            lens = S.lens_of(v)[perm]
            glens = scatter_unique_set(capacity + 1, target,
                                       lens)[:capacity]
            out_keys.append(S.raw_value(gd, glens, validity))
            continue
        out_keys.append(EvalValue(gd, validity, v.dtype, v.dictionary))
    return out_keys, group_mask


def row_group_ids(keys: Sequence[EvalValue], active, capacity: int,
                  ranges=None):
    """Per-row dense group ids in ORIGINAL row order.

    Returns (ids, is_first, num_groups): ids[r] in [0, num_groups) for
    active rows (undefined for inactive), is_first[r] marks the first
    (sorted-order) row of each group. Used by window partitioning and
    MarkDistinct in place of hash-table slots.
    """
    perm, gid, boundary, active_sorted, num_groups = sorted_group_info(
        keys, active, capacity, ranges)
    ids = jnp.zeros((capacity,), jnp.int32).at[perm].set(gid)
    first = jnp.zeros((capacity,), bool).at[perm].set(boundary)
    return ids, first & jnp.asarray(active), num_groups


# operand budget for the payload-riding lax.sort: chosen for the engine's
# first accelerator, whose compile time grew steeply with operand count;
# not yet measured on the H100 (ROADMAP C3)
_RIDE_MAX_OPERANDS = 8
_RIDE_MAX_KEY_LANES = 4


def reduce_sort_mode(
    keys: List[EvalValue],
    addends: List[Tuple[jnp.ndarray, str]],
    active,
    capacity: int,
    ranges=None,
):
    """Generic grouping: sort by packed key words + segment reduce.

    Same output contract as reduce_hash_mode: (group_keys, group_states,
    group_mask) with groups as a dense prefix of length `capacity` — but
    groups come out in key-sorted order and states land dense directly
    (no compaction scatter).

    Fast path: addends RIDE the lax.sort as payload operands and group
    keys are DECODED from the sorted lane bits — zero N-sized gathers,
    where the plain formulation sorts a permutation and then gathers every
    addend and key column through it.

    Run ends are compacted to the dense group prefix by ONE flag-keyed lax.sort
    carrying every lane (scan values + key lanes) as payload, replacing the
    per-lane scatters; the scan values at run ends ARE the group reductions, so
    no end-of-run scatter is needed either. Payload riding was chosen for the
    engine's first accelerator, where scatters and gathers were slow; it is not
    yet measured on the H100 against scatters (ROADMAP C3).
    """
    from velox_tpu.exec.sort import (
        decode_key_field, extract_lane_bits, lane_bit_widths,
        lane_prefix_neq, pack_words_u64, sort_perm_key, sort_words_layout,
    )
    from velox_tpu.ops.wide import (
        scatter_unique_set, segment_offsets, segmented_reduce_sorted,
        segmented_scan_values,
    )

    words, bits, layout = sort_words_layout(keys, None, capacity, active,
                                            ranges=ranges)
    total_bits = int(sum(bits))
    lanes = pack_words_u64(words, bits)
    ride = (all(f.decodable for f in layout)
            and all(d.ndim == 1 for d, _ in addends)
            and 0 < len(lanes) <= _RIDE_MAX_KEY_LANES
            and len(lanes) + len(addends) <= _RIDE_MAX_OPERANDS)
    if ride:
        ops = tuple(lanes) + tuple(d for d, _ in addends)
        out = jax.lax.sort(ops, num_keys=len(lanes), is_stable=True)
        skey = list(out[:len(lanes)])
        sorted_addends = out[len(lanes):]
        lw = lane_bit_widths(total_bits)
        boundary = lane_prefix_neq(skey, lw, total_bits)
        active_sorted = extract_lane_bits(skey, lw, 0, 1) == 0
        num_groups = jnp.sum((boundary & active_sorted).astype(jnp.int32))
        # per-row inclusive run scans: the value at a run's LAST row is
        # the run's reduction (int sums: global cumsum, diff'd after
        # compaction — exact in integers)
        run_off = segment_offsets(boundary, capacity)
        scans = [segmented_scan_values(d, run_off, capacity, combine)
                 for d, (_, combine) in zip(sorted_addends, addends)]
        # ONE compaction sort: active run ends (one per group, already in
        # key order) move to the prefix; everything rides as payload
        is_end = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
        flag = (~(is_end & active_sorted)).astype(jnp.uint8)
        cops = jax.lax.sort(
            (flag,) + tuple(v for v, _ in scans) + tuple(skey),
            num_keys=1, is_stable=True)
        group_mask = jnp.arange(capacity, dtype=jnp.int32) < num_groups
        out_states = []
        for (v, needs_diff), cv in zip(scans, cops[1:1 + len(scans)]):
            if needs_diff:
                prev = jnp.concatenate([jnp.zeros_like(cv[:1]), cv[:-1]])
                cv = cv - prev
            # rows past num_groups hold non-end leftovers: zero them so
            # downstream extraction math never sees garbage
            out_states.append(jnp.where(group_mask, cv,
                                        jnp.zeros_like(cv)))
        glanes = [jnp.where(group_mask, ln, jnp.zeros_like(ln))
                  for ln in cops[1 + len(scans):]]
        out_keys = []
        for v, f in zip(keys, layout):
            data, isnull = decode_key_field(f, glanes, lw, capacity)
            validity = None
            if isnull is not None:
                validity = ~isnull | ~group_mask  # padding rows: non-null
            if f.kind == "raw":
                from velox_tpu.vector import strings as S
                bytes2d, lens = data
                out_keys.append(S.raw_value(bytes2d, lens, validity))
                continue
            out_keys.append(EvalValue(data, validity, v.dtype,
                                      v.dictionary))
        return out_keys, out_states, group_mask

    perm, skey = sort_perm_key(words, bits, capacity)
    neq = jnp.zeros((capacity,), bool)
    for w in skey:
        prev = jnp.concatenate([w[:1], w[:-1]])
        neq = neq | (w != prev)
    boundary = neq.at[0].set(True)
    gid = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    active_sorted = jnp.asarray(active)[perm]
    num_groups = jnp.sum((boundary & active_sorted).astype(jnp.int32))
    out_states = []
    for data, combine in addends:
        # sorted-run reduction: dense cumulative ops + ONE end-of-run
        # scatter instead of int64 scatter-adds (segment_sum): chosen for
        # the engine's first accelerator, not yet measured on the H100
        # (ops/wide.py)
        out_states.append(segmented_reduce_sorted(
            data[perm], gid, boundary, active_sorted, capacity, combine))
    # group keys = key values at each group's first sorted row
    out_keys, group_mask = group_keys_sorted(
        keys, perm, gid, boundary, active_sorted, num_groups, capacity)
    return out_keys, out_states, group_mask


def reduce_hash_mode(
    keys: List[EvalValue],
    addends: List[Tuple[jnp.ndarray, str]],
    active,
    capacity: int,
):
    """Generic grouping via the scatter-probe hash table (hashtable.py).

    Parity: velox kNormalizedKey/kHash modes (exec/HashTable.h:122), redesigned
    without sorting. Returns (group_keys: List[EvalValue], group_states,
    group_mask). Output arrays have length `capacity`; groups are a dense
    prefix in arbitrary (hash) order.
    """
    from velox_tpu.exec import hashtable as H

    S = H.table_size_for(capacity)
    table = H.empty_table(keys, S)
    table, slots, _ = H.insert(table, keys, active, capacity)

    seg = jnp.where(active, slots, jnp.int32(S))
    out_states_full = []
    for data, combine in addends:
        red = _SEGMENT_OPS[combine](data, seg, num_segments=S + 1)
        out_states_full.append(red[:S])

    occupied = table.occupied
    didx = jnp.cumsum(occupied.astype(jnp.int32)) - 1
    num_groups = jnp.sum(occupied.astype(jnp.int32))
    # compact slots -> dense prefix of length `capacity` (groups <= rows)
    target = jnp.where(occupied, didx, jnp.int32(capacity))

    def compact(arr):
        return jnp.zeros((capacity,) + arr.shape[1:], arr.dtype) \
            .at[target].set(arr, mode="drop")

    out_states = [compact(s) for s in out_states_full]
    group_mask = jnp.arange(capacity, dtype=jnp.int32) < num_groups

    out_keys = []
    for v, col, cval in zip(keys, table.key_cols, table.key_valid):
        gd = compact(col)
        validity = None if v.validity is None else compact(cval)
        out_keys.append(EvalValue(gd, validity, v.dtype, v.dictionary))
    return out_keys, out_states, group_mask
