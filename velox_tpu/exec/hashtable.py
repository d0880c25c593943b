"""Device hash table: parallel insert/lookup via scatter/gather rounds.

Role parity: ``velox/exec/HashTable.h:108-443`` (the F14-style SIMD table
with kArray/kNormalizedKey/kHash modes) and ``VectorHasher``.

Device-first redesign: instead of 128-byte tagged buckets probed 4-way with
SIMD, the table is a struct-of-arrays in HBM — one ``occupied`` flag array
plus one *native-dtype* column per key — probed with **batched linear-probe
rounds**: every pending row gathers its slot, compares keys vectorized, and
unresolved rows claim empty slots with a scatter-min "ticket" (winner writes
its keys, same-key losers resolve on the re-check). Each round is a handful
of gathers/scatters, and ``lax.while_loop`` runs rounds until all rows
resolve — the data-parallel analogue of the reference's per-row probe loop
(HashTable.cpp:383 fullProbe).

Keys stay in native dtype (int64/int32/f64/dict-id), so no f64 bitcasts are
needed: equality is native, and hashing goes through order/equality-safe
integer words (exec/sort.py value_words).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu.exec.sort import value_words
from velox_tpu.expression.eval import EvalValue


def table_size_for(n: int, load: float = 0.5) -> int:
    """Power-of-two table size with max `load` fill."""
    want = max(16, int(n / load))
    return 1 << (want - 1).bit_length()


def _mix32(h):
    h = h.astype(jnp.uint32)
    h = (h ^ (h >> 16)) * jnp.uint32(0x85EBCA6B)
    h = (h ^ (h >> 13)) * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def hash_rows(keys: Sequence[EvalValue], capacity: int):
    """uint32 hash per row from all key columns (via integer words)."""
    h = jnp.full((capacity,), np.uint32(0x9E3779B9), jnp.uint32)
    for v in keys:
        for w in value_words(v, capacity):
            if v.validity is not None:
                w = jnp.where(v.full_validity(capacity), w, jnp.uint32(0))
            h = _mix32(h ^ w.astype(jnp.uint32))
    return h


class HashTable(NamedTuple):
    """Functional table state (carried through jitted steps)."""
    occupied: jnp.ndarray          # bool[S]
    key_cols: Tuple                # per key: data[S] in native dtype
    key_valid: Tuple               # per key: bool[S] (True = non-null slot)
    slot_row: jnp.ndarray          # int32[S]: row id of the inserting row

    @property
    def size(self) -> int:
        return self.occupied.shape[0]


def empty_table(keys: Sequence[EvalValue], size: int) -> HashTable:
    cols, valids = [], []
    for v in keys:
        cols.append(jnp.zeros((size,), v.data.dtype))
        valids.append(jnp.ones((size,), bool))
    return HashTable(
        occupied=jnp.zeros((size,), bool),
        key_cols=tuple(cols),
        key_valid=tuple(valids),
        slot_row=jnp.full((size,), -1, jnp.int32),
    )


def _keys_data(keys: Sequence[EvalValue], capacity: int):
    """(data, valid) per key with null lanes canonicalized to zero."""
    datas, valids = [], []
    for v in keys:
        d = v.full_data(capacity)
        if v.validity is not None:
            val = v.full_validity(capacity)
            d = jnp.where(val, d, jnp.zeros_like(d))
        else:
            val = jnp.ones((capacity,), bool)
        datas.append(d)
        valids.append(val)
    return datas, valids


def _slot_matches(table: HashTable, pos, datas, valids):
    """Row-wise: does slot `pos` hold exactly my key tuple?"""
    m = table.occupied[pos]
    for col, cval, d, val in zip(table.key_cols, table.key_valid,
                                 datas, valids):
        m = m & (col[pos] == d) & (cval[pos] == val)
    return m


def insert(table: HashTable, keys: Sequence[EvalValue], active,
           capacity: int):
    """Insert active rows' keys; returns (table, slots, is_new).

    slots[i] = the slot of row i's key group (undefined for inactive rows);
    is_new[i] = True iff row i is the row that created its slot.
    NULL keys are grouped like values (SQL GROUP BY semantics: nulls equal).
    """
    S = table.size
    mask = np.uint32(S - 1)
    datas, valids = _keys_data(keys, capacity)
    h0 = hash_rows(keys, capacity)
    iota = jnp.arange(capacity, dtype=jnp.int32)
    big = jnp.int32(capacity)

    def cond(state):
        _, _, _, unresolved, _ = state
        return jnp.any(unresolved)

    def body(state):
        table, slots, is_new, unresolved, r = state
        pos = ((h0 + r) & mask).astype(jnp.int32)
        match = _slot_matches(table, pos, datas, valids)
        want = unresolved & ~table.occupied[pos]
        # claim: smallest row id wins each contested empty slot
        ticket = jnp.where(want, iota, big)
        pos_w = jnp.where(want, pos, jnp.int32(S))  # OOB -> dropped
        claim = jnp.full((S,), big, jnp.int32).at[pos_w].min(
            ticket, mode="drop")
        winner = want & (claim[pos] == iota)
        pos_win = jnp.where(winner, pos, jnp.int32(S))
        occupied = table.occupied.at[pos_win].set(True, mode="drop")
        key_cols = tuple(
            c.at[pos_win].set(d, mode="drop")
            for c, d in zip(table.key_cols, datas))
        key_valid = tuple(
            c.at[pos_win].set(v, mode="drop")
            for c, v in zip(table.key_valid, valids))
        slot_row = table.slot_row.at[pos_win].set(iota, mode="drop")
        table = HashTable(occupied, key_cols, key_valid, slot_row)
        # re-check after writes: winners and same-key losers both match now
        match2 = match | _slot_matches(table, pos, datas, valids)
        resolved_now = unresolved & match2
        slots = jnp.where(resolved_now, pos, slots)
        is_new = is_new | winner
        unresolved = unresolved & ~match2
        return table, slots, is_new, unresolved, r + jnp.uint32(1)

    init = (table,
            jnp.full((capacity,), -1, jnp.int32),
            jnp.zeros((capacity,), bool),
            jnp.asarray(active),
            jnp.uint32(0))
    table, slots, is_new, _, _ = jax.lax.while_loop(cond, body, init)
    return table, slots, is_new


def lookup(table: HashTable, keys: Sequence[EvalValue], active,
           capacity: int):
    """Probe; returns (slots, found). Stops at first empty slot (absent) —
    valid for linear probing without deletions."""
    S = table.size
    mask = np.uint32(S - 1)
    datas, valids = _keys_data(keys, capacity)
    h0 = hash_rows(keys, capacity)

    def cond(state):
        _, _, pending, _ = state
        return jnp.any(pending)

    def body(state):
        slots, found, pending, r = state
        pos = ((h0 + r) & mask).astype(jnp.int32)
        occ = table.occupied[pos]
        match = _slot_matches(table, pos, datas, valids)
        hit = pending & match
        slots = jnp.where(hit, pos, slots)
        found = found | hit
        pending = pending & occ & ~match
        return slots, found, pending, r + jnp.uint32(1)

    init = (jnp.full((capacity,), -1, jnp.int32),
            jnp.zeros((capacity,), bool),
            jnp.asarray(active),
            jnp.uint32(0))
    slots, found, _, _ = jax.lax.while_loop(cond, body, init)
    return slots, found


def extract_keys(table: HashTable,
                 keys: Sequence[EvalValue]) -> List[EvalValue]:
    """Per-slot key columns as EvalValues (length = table size)."""
    out = []
    for v, col, cval in zip(keys, table.key_cols, table.key_valid):
        validity = None if v.validity is None else cval
        out.append(EvalValue(col, validity, v.dtype, v.dictionary))
    return out


def bloom_hashes(v, capacity: int):
    """(h1, h2) uint32 pair for double-hashed bloom filters — the SHARED
    contract between bloom_filter_agg and might_contain (bit i of k is
    (h1 + k*h2) mod m). Parity target: sparksql BloomFilterAggAggregate /
    MightContain (layout differs; see functions/spark_batch3.py).

    Hashes are VALUE-canonical, not storage-canonical: the build and
    probe sides have independent dictionaries / storage widths, so
    string columns hash their distinct VALUES at trace time (device
    gather by id) and numeric columns canonicalize to the type's
    np_dtype before word extraction — otherwise present values could
    hash differently on the two sides and test false-NEGATIVE."""
    from velox_tpu.expression.eval import EvalValue as _EV
    if v.dtype.is_string:
        if v.dictionary is None:
            raise NotImplementedError(
                "bloom over non-dictionary string columns")
        import zlib
        tbl = np.array([zlib.crc32(str(x).encode("utf-8"))
                        for x in v.dictionary.values], np.uint32)
        if len(tbl) == 0:
            tbl = np.zeros((1,), np.uint32)
        ids = jnp.clip(v.data.astype(jnp.int32), 0, len(tbl) - 1)
        h0 = jnp.asarray(tbl)[ids]
        h1 = _mix32(h0 ^ np.uint32(0x9E3779B9))
    else:
        want = v.dtype.np_dtype()
        data = v.full_data(capacity)
        if data.dtype != want:
            v = _EV(data.astype(want), v.validity, v.dtype)
        h1 = hash_rows([v], capacity)
    h2 = _mix32(h1 ^ np.uint32(0xB5297A4D))
    return h1, h2
