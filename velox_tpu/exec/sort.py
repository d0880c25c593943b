"""Sort permutations over order-preserving unsigned key words.

Role parity: ``velox/exec/PrefixSort.h:92`` + ``prefixsort/PrefixSortEncoder.h``
(normalized binary-comparable keys + sort). Keys become order-preserving
unsigned words, packed msb-first into u64 lanes, and one stable
``lax.sort`` over the lanes plus an i32 iota yields the permutation.

Key encoding notes:

* signed ints  -> biased unsigned words (hi/lo for 64-bit)
* f32          -> monotone u32 via i32 bitcast + sign fold
* f64          -> THREE f32 words (hi = f32(x), lo = f32(x - hi),
                  lo2 = f32(x - hi - lo)): within equal hi (and lo) the
                  residual orders exactly, and 3x24 bits >= 53 mantissa bits.
                  This form was chosen for the engine's first accelerator,
                  whose x64 mode forbids f64 bitcasts; it is not yet
                  measured on the H100 against one f64 -> u64 bitcast word
                  (ROADMAP C3).
* strings      -> sorted-dictionary ids (i32)
* descending   -> bitwise-not every value word (reverses lexicographic order)
* nulls        -> a leading 1-bit word per nullable key (independent of desc)
* active       -> the most significant word: inactive rows sort last
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue

_SIGN32 = np.uint32(0x80000000)


def _f32_monotone_u32(x):
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    u = jax.lax.bitcast_convert_type(bits, jnp.uint32)
    return jnp.where(bits < 0, ~u, u | _SIGN32)


def _signed_words(data) -> List:
    """Biased unsigned words (most significant first) for an integer array."""
    if data.dtype == jnp.int64:
        hi = (data >> 32).astype(jnp.int32)
        lo = (data & 0xFFFFFFFF).astype(jnp.uint32)
        hi_u = jax.lax.bitcast_convert_type(hi, jnp.uint32) ^ _SIGN32
        return [hi_u, lo]
    data32 = data.astype(jnp.int32)
    return [jax.lax.bitcast_convert_type(data32, jnp.uint32) ^ _SIGN32]


def value_words(v: EvalValue, capacity: int) -> List:
    """Order-preserving unsigned words, most significant first."""
    dt = v.dtype
    if dt.is_string and v.dictionary is None \
            and getattr(v.data, "ndim", 1) == 2:
        # raw string column: big-endian packed byte words + length lane
        # (vector/strings.py ordering contract)
        from velox_tpu.vector import strings as S
        words, _ = S.sort_key_words(v.data, S.lens_of(v))
        return words
    data = v.full_data(capacity)
    if dt.is_long_decimal:
        # int128 limbs: hi is the signed limb (biased like int64), lo is
        # the unsigned limb (ops/int128.py convention) -> 4x32-bit words
        hi = (v.children[0].data if v.children
              else jnp.zeros_like(data))
        if hi.ndim == 0:
            hi = jnp.broadcast_to(hi, data.shape)
        hi = jnp.broadcast_to(hi, (capacity,)) if hi.shape[0] != capacity \
            else hi
        lo_u = jax.lax.bitcast_convert_type(data.astype(jnp.int64),
                                            jnp.uint64)
        return _signed_words(hi) + [
            (lo_u >> np.uint64(32)).astype(jnp.uint32),
            (lo_u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)]
    if dt.kind is T.TypeKind.DOUBLE:
        hi = data.astype(jnp.float32)
        lo = (data - hi.astype(jnp.float64)).astype(jnp.float32)
        lo2 = (data - hi.astype(jnp.float64)
               - lo.astype(jnp.float64)).astype(jnp.float32)
        return [_f32_monotone_u32(hi), _f32_monotone_u32(lo),
                _f32_monotone_u32(lo2)]
    if dt.kind is T.TypeKind.REAL:
        return [_f32_monotone_u32(data)]
    if dt.kind is T.TypeKind.BOOLEAN:
        return [data.astype(jnp.uint32)]
    if dt.is_string:
        # sorted-dictionary ids (order-preserving; see device.py)
        return _signed_words(data.astype(jnp.int32))
    return _signed_words(data)


def _narrow_bits(v: EvalValue, rng) -> int:
    """Static bit width of the normalized (value - min) field, or -1 when
    the key cannot be narrowed. Dictionary strings narrow automatically
    (ids in [0, len)); BOOLEAN is 1 bit; integral/date/decimal keys narrow
    when the caller provides true (min, max) storage bounds (core/stats.py
    — the kNormalizedKey trick, prefixsort/PrefixSortEncoder.h, driven by
    connector stats instead of per-batch analysis)."""
    dt = v.dtype
    if dt.is_long_decimal:
        return -1  # limbed storage: stats ranges don't apply to lo alone
    if dt.kind is T.TypeKind.BOOLEAN:
        return 1
    if dt.is_string and v.dictionary is not None:
        return max(0, max(1, len(v.dictionary)) - 1).bit_length()
    if rng is None:
        return -1
    if not (dt.is_integral or dt.kind in (T.TypeKind.DATE,
                                          T.TypeKind.DECIMAL)):
        return -1
    lo, hi = int(rng[0]), int(rng[1])
    span = hi - lo
    if span < 0 or span >= (1 << 32):
        return -1
    return span.bit_length()


class KeyFieldLayout:
    """Bit layout of one sort key inside the packed msb-first key stream —
    enough to DECODE the key value back out of sorted lane words, so group-by /
    order-by never gather key columns through the permutation (chosen for the
    engine's first accelerator, where gathers were slow; not yet measured on
    the H100).

    kind: 'const' (contributes no bits; value == base), 'narrow'
    (stats-narrowed: value = base + bits), 'words' (full-width
    order-preserving words; decode per dtype), 'raw' (raw string byte
    words + length word; ``base`` holds the byte-matrix width W and
    decode reassembles the (cap, W) matrix from the lanes with pure
    shifts), 'opaque' (not invertible — DOUBLE's 3xf32 split, int128
    limbs)."""

    __slots__ = ("kind", "off", "nb", "base", "desc", "null_off",
                 "null_is_one", "dtype", "arr_dtype", "dictionary")

    def __init__(self, kind, off, nb, base, desc, null_off, null_is_one,
                 dtype, arr_dtype, dictionary):
        self.kind = kind
        self.off = off
        self.nb = nb
        self.base = base
        self.desc = desc
        self.null_off = null_off
        self.null_is_one = null_is_one
        self.dtype = dtype
        self.arr_dtype = arr_dtype
        self.dictionary = dictionary

    @property
    def decodable(self) -> bool:
        return self.kind != "opaque"


def sort_words(
    keys: Sequence[EvalValue],
    orders,
    capacity: int,
    active,
    ranges=None,
) -> Tuple[List, List[int]]:
    words, bits, _ = sort_words_layout(keys, orders, capacity, active,
                                       ranges)
    return words, bits


def sort_words_layout(
    keys: Sequence[EvalValue],
    orders,
    capacity: int,
    active,
    ranges=None,
):
    """(words, bit_widths, layout) for a multi-key sort, most significant
    first. ``layout`` is one KeyFieldLayout per key (decode metadata).

    `orders` is a list of plan.SortOrder or None entries (None = grouping /
    equality only). The leading word puts inactive rows last. `ranges`
    optionally gives (min, max) storage bounds per key: narrowed keys are
    BIT-PACKED msb-first into shared 32-bit words, so the u64 sort lanes
    track the information content of the key tuple, not 32 bits per word
    (fewer sort operands).
    """
    # fields: (uint32 array with the value in the LOW nb bits, nb)
    fields: List = [((~active).astype(jnp.uint32), 1)]
    layout: List[KeyFieldLayout] = []
    off = 1  # bit offset after the leading active bit
    for i, v in enumerate(keys):
        order = orders[i] if orders is not None else None
        desc = order is not None and not order.ascending
        rng = ranges[i] if ranges is not None else None
        null = None
        null_off = None
        null_is_one = True
        if v.validity is not None:
            null = ~v.full_validity(capacity)
            nulls_first = order is not None and order.nulls_first
            nw = jnp.where(null ^ nulls_first, jnp.uint32(1),
                           jnp.uint32(0)) \
                if order is not None else null.astype(jnp.uint32)
            fields.append((nw, 1))
            null_off = off
            null_is_one = not (order is not None and nulls_first)
            off += 1
        arr_dt = v.full_data(capacity).dtype
        nb = _narrow_bits(v, rng)
        if nb == 0:
            base = 0 if (v.dtype.is_string
                         or v.dtype.kind is T.TypeKind.BOOLEAN) \
                else int(rng[0])
            layout.append(KeyFieldLayout(
                "const", off, 0, base, desc, null_off, null_is_one,
                v.dtype, arr_dt, v.dictionary))
            continue  # provably constant: contributes nothing
        if nb > 0:
            data = v.full_data(capacity)
            if v.dtype.is_string or v.dtype.kind is T.TypeKind.BOOLEAN:
                base = 0
            else:
                base = int(rng[0])
            w = (data.astype(jnp.int64) - base).astype(jnp.uint32) \
                & np.uint32((1 << nb) - 1)
            if null is not None:
                w = jnp.where(null, jnp.uint32(0), w)
            if desc:
                w = w ^ np.uint32((1 << nb) - 1)
            fields.append((w, nb))
            layout.append(KeyFieldLayout(
                "narrow", off, nb, base, desc, null_off, null_is_one,
                v.dtype, arr_dt, v.dictionary))
            off += nb
            continue
        vw = value_words(v, capacity)
        if null is not None:
            vw = [jnp.where(null, jnp.uint32(0), x) for x in vw]
        if desc:
            vw = [~x for x in vw]
        fields.extend((x, 32) for x in vw)
        kind = "words"
        base_val = 0
        if v.dtype.kind is T.TypeKind.DOUBLE or v.dtype.is_long_decimal:
            kind = "opaque"  # 3xf32 split / int128 limbs: not invertible
        elif v.dtype.is_string and v.dictionary is None \
                and getattr(v.data, "ndim", 1) == 2:
            kind = "raw"     # byte words + length word; base stores W
            base_val = int(v.data.shape[1])
        layout.append(KeyFieldLayout(
            kind, off, 32 * len(vw), base_val, desc, null_off,
            null_is_one, v.dtype, arr_dt, v.dictionary))
        off += 32 * len(vw)

    # msb-first bit packing into up-to-32-bit words
    words: List = []
    bits: List[int] = []
    cur = None
    cur_bits = 0
    for val, nb in fields:
        while nb > 0:
            take = min(32 - cur_bits, nb)
            piece = (val >> np.uint32(nb - take)) \
                & np.uint32((1 << take) - 1)
            cur = piece if cur is None else \
                ((cur << np.uint32(take)) | piece)
            cur_bits += take
            nb -= take
            if cur_bits == 32:
                words.append(cur)
                bits.append(32)
                cur, cur_bits = None, 0
    if cur_bits:
        words.append(cur)
        bits.append(cur_bits)
    return words, bits, layout


def extract_lane_bits(lanes: List, lane_bits: List[int], off: int,
                      nb: int):
    """Extract the ``nb``-bit field at msb-first stream offset ``off``
    from packed u64 lanes (inverse of pack_words_u64). nb <= 32; returns
    uint32. All static shifts — dense elementwise ops, no gathers."""
    assert nb <= 32
    lane_start = 0
    for lane, lb in zip(lanes, lane_bits):
        if off < lane_start + lb:
            s = off - lane_start
            avail = lb - s
            if avail >= nb:
                piece = (lane >> np.uint64(lb - s - nb)) \
                    & np.uint64((1 << nb) - 1)
                return piece.astype(jnp.uint32)
            # spans into the next lane
            hi = (lane & np.uint64((1 << avail) - 1)).astype(jnp.uint32)
            rest = extract_lane_bits(lanes, lane_bits, lane_start + lb,
                                     nb - avail)
            return (hi << np.uint32(nb - avail)) | rest
        lane_start += lb
    raise ValueError(f"bit range [{off}, {off + nb}) beyond lanes")


def _decode_f32_word(u):
    """Inverse of _f32_monotone_u32."""
    neg = (u & _SIGN32) == 0
    bits_u = jnp.where(neg, ~u, u ^ _SIGN32)
    return jax.lax.bitcast_convert_type(bits_u, jnp.float32)


def decode_key_field(f: KeyFieldLayout, lanes: List, lane_bits: List[int],
                     capacity: int):
    """(data, isnull_or_None) for one key decoded from packed sorted
    lanes. Works on any lane arrays with the sort_words bit layout
    (sorted or compacted)."""
    isnull = None
    if f.null_off is not None:
        nb = extract_lane_bits(lanes, lane_bits, f.null_off, 1)
        isnull = (nb == 1) if f.null_is_one else (nb == 0)
    if f.kind == "const":
        return jnp.full((capacity,), f.base).astype(f.arr_dtype), isnull
    if f.kind == "narrow":
        w = extract_lane_bits(lanes, lane_bits, f.off, f.nb)
        if f.desc:
            w = w ^ np.uint32((1 << f.nb) - 1)
        if f.dtype.kind is T.TypeKind.BOOLEAN:
            return (w != 0).astype(f.arr_dtype), isnull
        data = w.astype(jnp.int64) + jnp.int64(f.base)
        return data.astype(f.arr_dtype), isnull
    if f.kind == "raw":
        # raw string: W/4 big-endian byte words + a length word, packed
        # by vector/strings.py sort_key_words. Reassembling the (cap, W)
        # byte matrix is pure shifts — no gathers.
        w_bytes = f.base
        nwords = f.nb // 32
        ws = [extract_lane_bits(lanes, lane_bits, f.off + 32 * j, 32)
              for j in range(nwords)]
        if f.desc:
            ws = [~w for w in ws]
        cols = []
        for j in range(w_bytes // 4):
            word = ws[j]
            for shift in (24, 16, 8, 0):
                cols.append(((word >> np.uint32(shift))
                             & np.uint32(0xFF)).astype(jnp.uint8))
        data = jnp.stack(cols, axis=1)
        lens = ws[-1].astype(jnp.int32)
        return (data, lens), isnull
    if f.kind == "words":
        nwords = f.nb // 32
        ws = [extract_lane_bits(lanes, lane_bits, f.off + 32 * j, 32)
              for j in range(nwords)]
        if f.desc:
            ws = [~w for w in ws]
        dt = f.dtype
        if dt.kind is T.TypeKind.BOOLEAN:
            return (ws[0] != 0).astype(f.arr_dtype), isnull
        if dt.kind is T.TypeKind.REAL:
            return _decode_f32_word(ws[0]).astype(f.arr_dtype), isnull
        if nwords == 1:  # biased int32 (incl. dict-id strings, DATE)
            v32 = jax.lax.bitcast_convert_type(ws[0] ^ _SIGN32, jnp.int32)
            return v32.astype(f.arr_dtype), isnull
        if nwords == 2:  # biased-hi int64
            hi = jax.lax.bitcast_convert_type(ws[0] ^ _SIGN32, jnp.int32)
            v = (hi.astype(jnp.int64) << jnp.int64(32)) \
                | ws[1].astype(jnp.int64)
            return v.astype(f.arr_dtype), isnull
    raise NotImplementedError(f"cannot decode key field kind {f.kind}")


def pack_words_u64(words: List, bits: List[int]):
    """Pack order-preserving words into as few uint64 lanes as possible
    (words[0] most significant). Returns the list of u64 lane arrays."""
    lanes: List = []
    fields = list(zip(words, bits))
    # greedy msb-first fill of 64-bit lanes
    cur = None
    cur_bits = 0
    for w, nb in fields:
        v = w.astype(jnp.uint64)
        while nb > 0:
            take = min(64 - cur_bits, nb)
            piece = (v >> np.uint64(nb - take)) \
                & np.uint64((1 << take) - 1) if nb > take else \
                (v & np.uint64((1 << take) - 1))
            cur = piece if cur is None else \
                ((cur << np.uint64(take)) | piece)
            cur_bits += take
            nb -= take
            if cur_bits == 64:
                lanes.append(cur)
                cur, cur_bits = None, 0
    if cur_bits:
        lanes.append(cur)
    return lanes


def sort_perm_key(words: List, bits: List[int], capacity: int):
    """(perm, sorted_lanes): stable sort permutation, plus the packed
    sorted key lanes (so callers can derive run boundaries without
    re-gathering key words); no lanes when the key has no bits.

    One ``lax.sort`` over every packed u64 key lane plus an i32 iota
    payload, whatever the key width: on the H100 it beat a counting radix
    sort on a 6-lane key (PERF.md).
    """
    total = int(sum(bits))
    iota = jnp.arange(capacity, dtype=jnp.int32)
    if total == 0:
        return iota, []
    lanes = pack_words_u64(words, bits)
    from velox_tpu.common import metrics as M
    M.record_counter(M.K_SORT_PROGRAMS)
    out = jax.lax.sort(tuple(lanes) + (iota,),
                       num_keys=len(lanes), is_stable=True)
    return out[-1], list(out[:-1])


def lane_prefix_neq(lanes: List, lane_bits: List[int], prefix_bits: int):
    """Row-boundary mask over SORTED packed key lanes: True at row i when
    the first ``prefix_bits`` of row i's key differ from row i-1's.
    ``lane_bits[j]`` is the bit width held by lane j (64 except possibly
    the last). Position 0 is always True."""
    neq = None
    consumed = 0
    for lane, nb in zip(lanes, lane_bits):
        if consumed >= prefix_bits:
            break
        take = min(nb, prefix_bits - consumed)
        w = lane >> np.uint64(nb - take) if take < nb else lane
        prev = jnp.concatenate([w[:1], w[:-1]])
        d = w != prev
        neq = d if neq is None else (neq | d)
        consumed += take
    if neq is None:
        n = lanes[0].shape[0] if lanes else 0
        neq = jnp.zeros((n,), bool)
    return neq.at[0].set(True)


def lane_bit_widths(total_bits: int) -> List[int]:
    """Per-lane bit widths produced by pack_words_u64 for a key of
    ``total_bits`` bits."""
    out = []
    rem = total_bits
    while rem > 0:
        out.append(min(64, rem))
        rem -= 64
    return out


def radix_sort_perm(words: List, bits: List[int], capacity: int):
    """Stable permutation sorting rows by unsigned words (lexicographic,
    words[0] most significant)."""
    perm, _ = sort_perm_key(words, bits, capacity)
    return perm


def sort_permutation(keys, orders, capacity, active):
    """Permutation putting active rows first, ordered by keys (stable)."""
    words, bits = sort_words(keys, orders, capacity, active)
    return radix_sort_perm(words, bits, capacity)


def num_value_words(dt: T.DataType) -> int:
    """Static word count of value_words() over a column stored at the
    type's CANONICAL dtype (np_dtype); pack_key_u64 casts to it first so
    both join sides pack identically even if one is storage-narrowed."""
    if dt.is_long_decimal:
        return 4
    if dt.kind is T.TypeKind.DOUBLE:
        return 3
    if dt.kind in (T.TypeKind.REAL, T.TypeKind.BOOLEAN):
        return 1
    if dt.is_string or dt.is_complex:
        return 1
    return 2 if dt.np_dtype() == np.int64 else 1


def packable_words(dtypes: Sequence[T.DataType]) -> bool:
    """True if the key tuple's order-preserving words fit in one uint64 —
    the precondition for the sorted-join searchsorted path (exec/join.py)."""
    return sum(num_value_words(dt) for dt in dtypes) <= 2


def sortable_words(dtypes: Sequence[T.DataType]) -> bool:
    """True if the key tuple's order-preserving words (plus the active /
    null bits) fit four u64 lanes — the precondition for the WIDE-key
    sorted-join path (exec/join.py build_sorted_table wide mode): such
    builds probe via the merge-rank sort, which never packs keys into one
    u64. Beyond this, the scatter-probe hash table remains the fallback.
    The limit dates from a sort-lane cap of the engine's first
    accelerator; which join mode wins for
    wider keys on the H100 is not yet measured (ROADMAP C4)."""
    return sum(num_value_words(dt) for dt in dtypes) <= 7


def pack_key_u64(keys: Sequence[EvalValue], capacity: int):
    """One order-preserving uint64 per row from <=2 total value words.

    Key data is cast to each type's canonical np_dtype so build and probe
    sides pack identically regardless of storage narrowing. Null lanes are
    NOT canonicalized: callers exclude null-key rows (SQL join semantics)
    before using the packed value.
    """
    words: List = []
    for v in keys:
        canon = v
        want = v.dtype.np_dtype()
        if not v.dtype.is_string and v.data.dtype != want:
            canon = EvalValue(v.full_data(capacity).astype(want),
                              v.validity, v.dtype, v.dictionary)
        words.extend(value_words(canon, capacity))
    assert len(words) <= 2, "keys exceed one packed u64"
    w0 = words[0].astype(jnp.uint64)
    if len(words) == 1:
        return w0
    return (w0 << np.uint64(32)) | words[1].astype(jnp.uint64)
