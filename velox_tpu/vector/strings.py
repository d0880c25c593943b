"""Device-native raw string columns: padded byte matrices in HBM.

Role parity: ``velox/type/StringView.h:51`` (inline/pointered string
views over shared byte buffers) and the byte-level string kernels of
``velox/functions/prestosql/StringFunctions.h`` / ``functions/lib/
StringImpl``. The reference's layout — 16-byte views pointing into
variable-length buffers — is built for pointer-chasing CPUs; on a device
random byte addressing is costly, so the layout here is dense:

  * ``data``: a dense ``uint8[capacity, W]`` byte matrix, zero-padded,
    where W is the column's size class (16/32/64/.../2048 — pow2 of the
    max byte length). Every string kernel is a dense elementwise /
    lane-shift computation over this matrix: no offsets, no gathers.
  * ``lens``: ``int32[capacity]`` byte lengths (zero-padding makes
    equality/order *almost* positional; lens breaks padding ties).

Dictionary encoding (vector/device.py Dictionary) remains available as
an *encoding* for low-cardinality columns; this flat representation is
the scaling path for high-cardinality VARCHAR (UUIDs, URLs, comments)
where a host dictionary would materialize the whole column on the host.

Ordering contract: big-endian packed u32 words over zero-padded bytes
compare exactly like byte-wise lexicographic order, with equal-prefix
ties broken by length — so ``sort_key_words`` emits K u32 lanes + a
length lane and raw strings ride the SAME lax.sort machinery as
integral keys (exec/sort.py), giving sort/group-by/join on raw strings
with zero new sorting code.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.vector.device import DeviceColumn

# size classes: pow2 byte widths; ≥16 keeps tiles sane, ≤2048 bounds the
# padded footprint (longer strings stay on the dictionary path)
MIN_WIDTH = 16
MAX_WIDTH = 2048


def size_class(max_len: int) -> int:
    w = MIN_WIDTH
    while w < max_len:
        w <<= 1
    if w > MAX_WIDTH:
        raise ValueError(
            f"string length {max_len} exceeds the raw-string max width "
            f"{MAX_WIDTH}; use dictionary encoding for this column")
    return w


def is_raw(col) -> bool:
    """True for a raw (flat) string column/EvalValue: VARCHAR dtype, no
    dictionary, byte-matrix data + lens child."""
    return (col is not None and getattr(col, "dtype", None) is not None
            and col.dtype.is_string and col.dictionary is None
            and getattr(col.data, "ndim", 0) == 2)


def lens_of(col) -> jnp.ndarray:
    """int32 byte lengths of a raw string column/EvalValue."""
    child = col.children[0]
    return (child.data if isinstance(child, DeviceColumn) else child)


def raw_column(bytes2d, lens, validity=None) -> DeviceColumn:
    lens_col = DeviceColumn(lens.astype(jnp.int32), None, T.INTEGER)
    return DeviceColumn(bytes2d, validity, T.VARCHAR, None, (lens_col,))


def raw_value(bytes2d, lens, validity=None):
    from velox_tpu.expression.eval import EvalValue
    lens_col = DeviceColumn(lens.astype(jnp.int32), None, T.INTEGER)
    return EvalValue(bytes2d, validity, T.VARCHAR, None,
                     children=(lens_col,))


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------

def pack_pylist(values, capacity: int,
                width: Optional[int] = None) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Python str/bytes/None list -> (uint8[capacity, W], int32 lens).
    None packs as empty (callers carry validity separately)."""
    bs = [(v.encode() if isinstance(v, str) else (v or b""))
          for v in values]
    max_len = max((len(b) for b in bs), default=0)
    w = width if width is not None else size_class(max_len)
    out = np.zeros((capacity, w), np.uint8)
    lens = np.zeros((capacity,), np.int32)
    for i, b in enumerate(bs):
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return out, lens


def pack_arrow(arr, capacity: int,
               width: Optional[int] = None) -> Tuple[np.ndarray,
                                                     np.ndarray,
                                                     Optional[np.ndarray]]:
    """Vectorized pyarrow string array -> (bytes2d, lens, validity) with
    NO per-value python loop (the 10M-row ingest path)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_large_string(arr.type) or \
            pa.types.is_large_binary(arr.type):
        arr = arr.cast(pa.string())
    n = len(arr)
    validity = None
    if arr.null_count:
        validity = np.asarray(pc.is_valid(arr))
        arr = pc.fill_null(arr, "")
    offs = np.frombuffer(arr.buffers()[1], np.int32,
                         count=n + 1 + arr.offset)[arr.offset:]
    databuf = arr.buffers()[2]
    data = (np.frombuffer(databuf, np.uint8, count=len(databuf))
            if databuf is not None else np.zeros((0,), np.uint8))
    lens = np.diff(offs).astype(np.int32)
    max_len = int(lens.max()) if n else 0
    w = width if width is not None else size_class(max_len)
    # gather each row's bytes: idx = start + lane, masked past len
    lane = np.arange(w, dtype=np.int64)[None, :]
    idx = offs[:-1, None].astype(np.int64) + lane
    valid = lane < lens[:, None]
    idx = np.where(valid, idx, 0)
    out = np.where(valid, data[idx] if len(data) else 0, 0).astype(np.uint8)
    full = np.zeros((capacity, w), np.uint8)
    full[:n] = out
    full_lens = np.zeros((capacity,), np.int32)
    full_lens[:n] = lens
    if validity is not None:
        v = np.zeros((capacity,), bool)
        v[:n] = validity
        validity = v
    return full, full_lens, validity


def unpack_numpy(bytes2d: np.ndarray, lens: np.ndarray) -> list:
    """Host byte matrix -> python str list (invalid UTF-8 kept as bytes)."""
    out = []
    for row, ln in zip(bytes2d, lens):
        b = bytes(row[:int(ln)])
        try:
            out.append(b.decode())
        except UnicodeDecodeError:
            out.append(b)
    return out


def to_arrow(bytes2d: np.ndarray, lens: np.ndarray,
             validity: Optional[np.ndarray]):
    """Host byte matrix -> pyarrow string array (vectorized build)."""
    import pyarrow as pa
    n = len(lens)
    lens64 = lens.astype(np.int64)
    offs = np.zeros((n + 1,), np.int32)
    offs[1:] = np.cumsum(lens64).astype(np.int32)
    lane = np.arange(bytes2d.shape[1], dtype=np.int64)[None, :]
    take = lane < lens64[:, None]
    flat = bytes2d[take]  # row-major boolean take = concatenated strings
    buf = pa.py_buffer(flat.tobytes())
    mask_buf = None
    if validity is not None and not validity.all():
        mask_buf = pa.py_buffer(np.packbits(validity, bitorder="little")
                                .tobytes())
    return pa.Array.from_buffers(
        pa.string(), n,
        [mask_buf, pa.py_buffer(offs.tobytes()), buf])


# ---------------------------------------------------------------------------
# device kernels (dense work over (cap, W) u8)
# ---------------------------------------------------------------------------

def sort_key_words(bytes2d, lens) -> Tuple[List[jnp.ndarray], List[int]]:
    """(u32 word lanes, bit widths) whose lexicographic word order equals
    string order: big-endian packed bytes, most-significant lane first,
    then the length lane to break zero-padding ties."""
    cap, w = bytes2d.shape
    b = bytes2d.astype(jnp.uint32)
    words = []
    for j in range(0, w, 4):
        word = (b[:, j] << 24) | (b[:, j + 1] << 16) \
            | (b[:, j + 2] << 8) | b[:, j + 3]
        words.append(word)
    words.append(lens.astype(jnp.uint32))
    return words, [32] * (w // 4) + [max(1, int(w).bit_length() + 1)]


def equal(a_bytes, a_lens, b_bytes, b_lens) -> jnp.ndarray:
    wa, wb = a_bytes.shape[1], b_bytes.shape[1]
    if wa != wb:  # compare across size classes: pad the narrower
        w = max(wa, wb)
        a_bytes = jnp.pad(a_bytes, ((0, 0), (0, w - wa)))
        b_bytes = jnp.pad(b_bytes, ((0, 0), (0, w - wb)))
    return jnp.all(a_bytes == b_bytes, axis=1) & (a_lens == b_lens)


def less(a_bytes, a_lens, b_bytes, b_lens,
         or_equal: bool = False) -> jnp.ndarray:
    """Byte-wise lexicographic a < b (or <=)."""
    wa, wb = a_bytes.shape[1], b_bytes.shape[1]
    if wa != wb:
        w = max(wa, wb)
        a_bytes = jnp.pad(a_bytes, ((0, 0), (0, w - wa)))
        b_bytes = jnp.pad(b_bytes, ((0, 0), (0, w - wb)))
    ne = a_bytes != b_bytes
    # first differing byte decides; all-equal bytes -> shorter is less
    first = jnp.argmax(ne, axis=1)
    any_ne = jnp.any(ne, axis=1)
    a_at = jnp.take_along_axis(a_bytes, first[:, None], axis=1)[:, 0]
    b_at = jnp.take_along_axis(b_bytes, first[:, None], axis=1)[:, 0]
    lt = jnp.where(any_ne, a_at < b_at,
                   (a_lens <= b_lens) if or_equal else (a_lens < b_lens))
    return lt


def broadcast_literal(value, capacity: int, width: int):
    """A python string literal as (bytes2d, lens) broadcast to capacity."""
    b = value.encode() if isinstance(value, str) else bytes(value)
    w = max(width, size_class(max(1, len(b))))
    row = np.zeros((w,), np.uint8)
    row[:len(b)] = np.frombuffer(b, np.uint8)
    bytes2d = jnp.broadcast_to(jnp.asarray(row), (capacity, w))
    lens = jnp.full((capacity,), len(b), jnp.int32)
    return bytes2d, lens


def length_bytes(lens) -> jnp.ndarray:
    return lens.astype(jnp.int64)


def length_chars(bytes2d, lens) -> jnp.ndarray:
    """UTF-8 code-point count: bytes that are NOT continuation bytes
    (0b10xxxxxx) within the length window."""
    w = bytes2d.shape[1]
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    in_len = lane < lens[:, None]
    is_start = (bytes2d & 0xC0) != 0x80
    return jnp.sum(in_len & is_start, axis=1, dtype=jnp.int64)


def _char_starts(bytes2d, lens):
    """(cap, W) bool: byte begins a UTF-8 code point (within length)."""
    w = bytes2d.shape[1]
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    return (lane < lens[:, None]) & ((bytes2d & 0xC0) != 0x80)


def shift_left(bytes2d, lens, nbytes) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Drop the first `nbytes` (per-row i32) bytes. take_along_axis over
    the lane axis — a row-local gather, not an HBM scatter."""
    cap, w = bytes2d.shape
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    src = lane + nbytes[:, None]
    out = jnp.take_along_axis(bytes2d, jnp.clip(src, 0, w - 1), axis=1)
    new_len = jnp.clip(lens - nbytes, 0, None)
    out = jnp.where(lane < new_len[:, None], out, 0).astype(jnp.uint8)
    return out, new_len


def truncate(bytes2d, lens, nbytes) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Keep only the first `nbytes` (per-row) bytes."""
    w = bytes2d.shape[1]
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    new_len = jnp.clip(jnp.minimum(lens, nbytes), 0, None)
    out = jnp.where(lane < new_len[:, None], bytes2d, 0).astype(jnp.uint8)
    return out, new_len


def _char_to_byte(bytes2d, lens, char_idx):
    """Byte offset of 1-based code-point index `char_idx` (per-row).
    char_idx past the end maps to lens (empty tail)."""
    w = bytes2d.shape[1]
    starts = _char_starts(bytes2d, lens)
    # rank of each byte among char starts (1-based at start bytes)
    rank = jnp.cumsum(starts.astype(jnp.int32), axis=1)
    # byte offset of the k-th char = first lane where starts & rank == k
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    hit = starts & (rank == char_idx[:, None])
    off = jnp.min(jnp.where(hit, lane, w), axis=1)
    return jnp.minimum(off, lens)


def substr(bytes2d, lens, start, length=None):
    """SQL substr: 1-based `start` in CODE POINTS; negative counts from
    the end; `length` in code points (None = to end)."""
    nchars = length_chars(bytes2d, lens).astype(jnp.int32)
    start = start.astype(jnp.int32)
    # SQL semantics: negative start counts from the end; 0 -> empty
    s = jnp.where(start < 0, nchars + start + 1, start)
    invalid = (start == 0) | (s < 1) | (s > nchars)
    s = jnp.clip(s, 1, None)
    b0 = _char_to_byte(bytes2d, lens, s)
    out, out_len = shift_left(bytes2d, lens, b0)
    if length is not None:
        ln = jnp.clip(length.astype(jnp.int32), 0, None)
        # byte offset of char s+ln within the SHIFTED string
        bend = _char_to_byte(out, out_len, ln + 1)
        out, out_len = truncate(out, out_len, bend)
        invalid = invalid | (length.astype(jnp.int32) < 0)
    w = out.shape[1]
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    out_len = jnp.where(invalid, 0, out_len)
    out = jnp.where(invalid[:, None] | (lane >= out_len[:, None]), 0,
                    out).astype(jnp.uint8)
    return out, out_len


def concat(a_bytes, a_lens, b_bytes, b_lens):
    """a || b. Output width = next size class of the max combined len
    (static: sum of the two class widths, clamped)."""
    wa, wb = a_bytes.shape[1], b_bytes.shape[1]
    w = size_class(min(wa + wb, MAX_WIDTH))
    cap = a_bytes.shape[0]
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    a_pad = jnp.pad(a_bytes, ((0, 0), (0, w - wa)))
    # b shifted right by a_lens: out[j] = b[j - a_len]
    src = lane - a_lens[:, None]
    b_pad = jnp.pad(b_bytes, ((0, 0), (0, w - wb)))
    b_shift = jnp.take_along_axis(b_pad, jnp.clip(src, 0, w - 1), axis=1)
    from_a = lane < a_lens[:, None]
    new_len = jnp.minimum(a_lens + b_lens, w)
    in_len = lane < new_len[:, None]
    out = jnp.where(from_a, a_pad, jnp.where(in_len, b_shift, 0))
    return out.astype(jnp.uint8), new_len


def _window_equal(bytes2d, lens, needle: bytes, at):
    """Per-row: bytes[at : at+len(needle)] == needle (at = i32 offsets)."""
    w = bytes2d.shape[1]
    p = len(needle)
    ok = at >= 0
    ok = ok & (at + p <= lens)
    for j, ch in enumerate(needle):
        col = jnp.take_along_axis(
            bytes2d, jnp.clip(at + j, 0, w - 1)[:, None], axis=1)[:, 0]
        ok = ok & (col == ch)
    return ok


def starts_with(bytes2d, lens, needle: bytes) -> jnp.ndarray:
    cap = bytes2d.shape[0]
    return _window_equal(bytes2d, lens, needle,
                         jnp.zeros((cap,), jnp.int32))


def ends_with(bytes2d, lens, needle: bytes) -> jnp.ndarray:
    return _window_equal(bytes2d, lens, needle,
                         lens - len(needle))


def contains_at(bytes2d, lens, needle: bytes) -> jnp.ndarray:
    """First BYTE position (0-based) of `needle`, or -1. Dense windowed
    compare at every offset — O(W·|needle|) lanes, zero random HBM
    access (the dense answer to memmem)."""
    cap, w = bytes2d.shape
    p = len(needle)
    if p == 0:
        return jnp.zeros((cap,), jnp.int32)
    if p > w:
        return jnp.full((cap,), -1, jnp.int32)
    # match[o] = all(bytes[o+j] == needle[j]) computed as shifted compares
    match = jnp.ones((cap, w), bool)
    for j, ch in enumerate(needle):
        shifted = bytes2d[:, j:] if j else bytes2d
        if j:
            shifted = jnp.pad(shifted, ((0, 0), (0, j)))
        match = match & (shifted == ch)
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    match = match & (lane + p <= lens[:, None])
    pos = jnp.min(jnp.where(match, lane, w), axis=1)
    return jnp.where(pos == w, -1, pos).astype(jnp.int32)


def strpos_chars(bytes2d, lens, needle: bytes) -> jnp.ndarray:
    """Presto strpos: 1-based CODE POINT position of needle, 0 if absent."""
    byte_pos = contains_at(bytes2d, lens, needle)
    starts = _char_starts(bytes2d, lens)
    rank = jnp.cumsum(starts.astype(jnp.int32), axis=1)
    w = bytes2d.shape[1]
    char_pos = jnp.take_along_axis(
        rank, jnp.clip(byte_pos, 0, w - 1)[:, None], axis=1)[:, 0]
    return jnp.where(byte_pos < 0, 0, char_pos).astype(jnp.int64)


def like(bytes2d, lens, pattern: str, escape=None) -> jnp.ndarray:
    """SQL LIKE compiled to dense kernels by pattern shape (parity:
    velox/functions/lib/Re2Functions.cpp determinePatternKind —
    kExactlyN/kPrefix/kSuffix/kSubstring specializations):

      'abc'    exact    '%abc'  suffix     'abc%'   prefix
      '%abc%'  contains 'a%b'   prefix+suffix  'a%b%c' segment chain
      '_' wildcards fall back to per-offset masked compares (byte-level;
      multi-byte UTF-8 '_' matches one byte — documented limitation).
    """
    esc = escape
    segs: List[bytes] = []
    cur = bytearray()
    has_underscore = False
    i = 0
    pct_positions = []  # segment boundaries
    while i < len(pattern):
        c = pattern[i]
        if esc is not None and c == esc and i + 1 < len(pattern):
            cur.append(ord(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            segs.append(bytes(cur))
            cur = bytearray()
        elif c == "_":
            has_underscore = True
            cur.append(0)  # placeholder; handled only in simple forms
        else:
            cur.extend(c.encode())
        i += 1
    segs.append(bytes(cur))

    if has_underscore:
        raise NotImplementedError(
            "LIKE with '_' on raw string columns is not supported yet; "
            "use a dictionary-encoded column or regexp_like")

    cap = bytes2d.shape[0]
    if len(segs) == 1:  # exact
        lit = segs[0]
        blit, llit = broadcast_literal(lit, cap, bytes2d.shape[1])
        return equal(bytes2d, lens, blit, llit)
    ok = jnp.ones((cap,), bool)
    first, *mids, last = segs
    if first:
        ok = ok & starts_with(bytes2d, lens, first)
    if last:
        ok = ok & ends_with(bytes2d, lens, last)
    # middle segments must appear in order after the prefix and before
    # the suffix; single-middle is the overwhelmingly common case
    cur_b, cur_l = bytes2d, lens
    consumed = jnp.full((cap,), len(first), jnp.int32)
    min_tail = len(last)
    for m in mids:
        if not m:
            continue
        shifted, sl = shift_left(cur_b, cur_l, consumed)
        pos = contains_at(shifted, sl, m)
        ok = ok & (pos >= 0)
        # ensure the match leaves room for the suffix
        ok = ok & (consumed + pos + len(m) + min_tail <= lens)
        consumed = consumed + jnp.clip(pos, 0, None) + len(m)
    # prefix+suffix must not overlap
    ok = ok & (lens >= consumed + min_tail)
    return ok


def upper_ascii(bytes2d, lens):
    is_lower = (bytes2d >= ord("a")) & (bytes2d <= ord("z"))
    return jnp.where(is_lower, bytes2d - 32, bytes2d).astype(jnp.uint8), \
        lens


def lower_ascii(bytes2d, lens):
    is_upper = (bytes2d >= ord("A")) & (bytes2d <= ord("Z"))
    return jnp.where(is_upper, bytes2d + 32, bytes2d).astype(jnp.uint8), \
        lens


def _space_runs(bytes2d, lens):
    w = bytes2d.shape[1]
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    in_len = lane < lens[:, None]
    return (bytes2d == ord(" ")) & in_len, lane, in_len


def ltrim(bytes2d, lens):
    is_sp, lane, in_len = _space_runs(bytes2d, lens)
    non_sp = in_len & ~is_sp
    first = jnp.min(jnp.where(non_sp, lane, lens[:, None]), axis=1)
    return shift_left(bytes2d, lens, first.astype(jnp.int32))


def rtrim(bytes2d, lens):
    is_sp, lane, in_len = _space_runs(bytes2d, lens)
    non_sp = in_len & ~is_sp
    last = jnp.max(jnp.where(non_sp, lane + 1, 0), axis=1)
    return truncate(bytes2d, lens, last.astype(jnp.int32))


def trim(bytes2d, lens):
    b, ln = ltrim(bytes2d, lens)
    return rtrim(b, ln)


def reverse_bytes(bytes2d, lens):
    """Byte reversal within each row's length window (exact for ASCII;
    multi-byte UTF-8 sequences are NOT re-ordered — callers on the
    Presto-exact path use the dictionary encoding)."""
    cap, w = bytes2d.shape
    lane = jnp.arange(w, dtype=jnp.int32)[None, :]
    src = lens[:, None] - 1 - lane
    out = jnp.take_along_axis(bytes2d, jnp.clip(src, 0, w - 1), axis=1)
    out = jnp.where(lane < lens[:, None], out, 0).astype(jnp.uint8)
    return out, lens
