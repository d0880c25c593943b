"""Spark SQL function package.

Role parity: ``velox/functions/sparksql`` — Spark-faithful semantics where
they differ from Presto (pmod, size, datediff argument order, add_months),
plus aliases onto the shared implementations (functions/lib parity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue, merge_validity
from velox_tpu.functions.registry import _REGISTRY, register
from velox_tpu.functions.scalar import _all_numeric, _numeric_data


def _alias(new: str, old: str):
    if old in _REGISTRY:
        _REGISTRY[new] = _REGISTRY[old]


def _alias_special(new: str, old: str):
    from velox_tpu.expression.eval import _SPECIAL_FORMS
    if old in _SPECIAL_FORMS:
        _SPECIAL_FORMS[new] = _SPECIAL_FORMS[old]


# straight aliases onto shared implementations / special forms
_alias_special("nvl", "coalesce")
_alias_special("ifnull", "coalesce")
_alias_special("isnull", "is_null")
_alias_special("isnotnull", "is_not_null")
_alias("shiftleft", "bitwise_shift_left")
_alias("shiftright", "bitwise_arithmetic_shift_right")
_alias("power", "power")
_alias("pow", "power")
_alias("lcase", "lower")
_alias("ucase", "upper")
_alias("char_length", "length")
_alias("dayofweek", "day_of_week")
_alias("dayofyear", "day_of_year")
_alias("weekofyear", "week")
_alias("std", "stddev")


def _pmod_eval(ctx, out_dtype, args):
    """Spark pmod: result is non-negative (sign follows divisor=positive)."""
    a, b = args
    da = _numeric_data(a, out_dtype, ctx)
    db = _numeric_data(b, out_dtype, ctx)
    # Spark's Pmod is `r = a javamod b; if (r < 0) (r + b) javamod b`
    # with Java's truncating %. That reduces to: the floored (python/jax)
    # remainder when b > 0, and the Java truncated remainder when b < 0 —
    # so pmod(10, -3) == 1 and pmod(-10, -3) == -1 (Spark-checked cases).
    floored = da % db
    trunc = jnp.sign(da) * (jnp.abs(da) % jnp.abs(db))
    r = jnp.where(db > 0, floored, trunc).astype(floored.dtype)
    validity = merge_validity(a, b)
    zero = db == 0
    validity = (~zero if validity is None else validity & ~zero)
    return EvalValue(r, validity, out_dtype)


register("pmod",
         lambda ts: (T.BIGINT if all(t.is_integral for t in ts)
                     else T.DOUBLE)
         if len(ts) == 2 and _all_numeric(ts) else None, _pmod_eval)


def _size_eval(ctx, out_dtype, args):
    """Spark size(): element count; INTEGER (not BIGINT)."""
    (v,) = args
    return EvalValue(v.data.astype(jnp.int32), v.validity, T.INTEGER)


register("size",
         lambda ts: T.INTEGER if len(ts) == 1 and ts[0].is_complex
         else None, _size_eval)


def _days_of(v, ctx):
    d = v.full_data(ctx.capacity).astype(jnp.int64)
    if v.dtype.kind is T.TypeKind.TIMESTAMP:
        d = d // 86_400_000_000
    return d


_DATELIKE = (T.TypeKind.DATE, T.TypeKind.TIMESTAMP)


def _datediff_eval(ctx, out_dtype, args):
    """Spark datediff(end, start) -> days (note the argument order)."""
    end, start = args
    return EvalValue(_days_of(end, ctx) - _days_of(start, ctx),
                     merge_validity(end, start), T.BIGINT)


register("datediff",
         lambda ts: T.BIGINT if len(ts) == 2 and all(
             t.kind in _DATELIKE for t in ts) else None,
         _datediff_eval)


def _add_months_eval(ctx, out_dtype, args):
    from velox_tpu.functions.datetime import _shift_months
    d, n = args
    days = _days_of(d, ctx)
    months = n.full_data(ctx.capacity).astype(jnp.int64)
    out = _shift_months(days, months)
    return EvalValue(out.astype(jnp.int32), merge_validity(d, n), T.DATE)


register("add_months",
         lambda ts: T.DATE if len(ts) == 2
         and ts[0].kind in _DATELIKE and ts[1].is_integral
         else None, _add_months_eval)


# ---------------------------------------------------------------------------
# Spark murmur3 hash parity. Parity: velox/functions/sparksql/Hash.cpp
# (Murmur3Hash: hashInt32/hashInt64/hashFloat/hashDouble/hashBytes, seed 42,
# seed chains across arguments, NULL leaves the seed unchanged) — required
# for Gluten-compatible shuffles.
#
# The whole mixer runs on uint32 lanes (wrapping multiplies) —
# one fused elementwise program per hash() call. Strings hash in
# dictionary-block space: each dictionary entry's utf8 bytes expand ONCE on
# the host into Spark's block sequence (aligned 4-byte LE words, then each
# tail byte sign-extended as its own block); rows gather their entry's
# block row and fold it with a fori loop.
# ---------------------------------------------------------------------------

_MM_C1 = np.uint32(0xCC9E2D51)
_MM_C2 = np.uint32(0x1B873593)


def _rotl32(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mm_mix_k1(k1):
    k1 = (k1 * _MM_C1).astype(jnp.uint32)
    k1 = _rotl32(k1, 15)
    return (k1 * _MM_C2).astype(jnp.uint32)


def _mm_mix_h1(h1, k1):
    h1 = (h1 ^ k1).astype(jnp.uint32)
    h1 = _rotl32(h1, 13)
    return (h1 * np.uint32(5) + np.uint32(0xE6546B64)).astype(jnp.uint32)


def _mm_fmix(h1, length):
    h1 = h1 ^ jnp.asarray(length, jnp.uint32)
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = (h1 * np.uint32(0x85EBCA6B)).astype(jnp.uint32)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = (h1 * np.uint32(0xC2B2AE35)).astype(jnp.uint32)
    return h1 ^ (h1 >> np.uint32(16))


def _mm_hash_i32(u32, seed):
    return _mm_fmix(_mm_mix_h1(seed, _mm_mix_k1(u32)), 4)


def _mm_hash_i64(i64, seed):
    u = i64.astype(jnp.uint64)
    lo = (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (u >> jnp.uint64(32)).astype(jnp.uint32)
    h1 = _mm_mix_h1(seed, _mm_mix_k1(lo))
    h1 = _mm_mix_h1(h1, _mm_mix_k1(hi))
    return _mm_fmix(h1, 8)


def _double_bits(x):
    """IEEE-754 double bits WITHOUT bitcast (the engine's first accelerator
    had no f64<->i64 bitcast): sign/exponent/mantissa reconstructed
    arithmetically.
    Denormals (|x| < 2^-1022) are explicitly flushed to zero — a
    documented deviation from Spark, which hashes their true bit
    patterns; normal values remain bit-exact."""
    x = jnp.where(jnp.abs(x) < 2.0 ** -1022, 0.0, x)  # flush denormals
    x = jnp.where(x == 0.0, 0.0, x)           # -0.0 -> 0.0 (Spark)
    sign = jnp.where(jnp.signbit(x), jnp.uint64(1) << jnp.uint64(63),
                     jnp.uint64(0))
    ax = jnp.abs(x)
    m, e = jnp.frexp(ax)                      # m in [0.5, 1)
    mant = jnp.round((m * 2.0 - 1.0) * (2.0 ** 52)).astype(jnp.uint64)
    expb = jnp.clip(e + 1022, 1, 2046).astype(jnp.uint64)
    bits = sign | (expb << jnp.uint64(52)) | mant
    bits = jnp.where(ax == 0.0, jnp.uint64(0), bits)
    bits = jnp.where(jnp.isinf(ax),
                     sign | jnp.uint64(0x7FF0000000000000), bits)
    bits = jnp.where(jnp.isnan(x), jnp.uint64(0x7FF8000000000000), bits)
    return bits.astype(jnp.int64)


def _spark_string_blocks(dictionary):
    """(blocks[n, maxB] int32, nblocks[n] int32, bytelen[n] int32) —
    Spark's hashUnsafeBytes block sequence per dictionary entry."""
    rows = []
    lens = []
    for v in dictionary.values:
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        words = [int.from_bytes(b[i:i + 4], "little")
                 for i in range(0, len(b) - len(b) % 4, 4)]
        for t in b[len(b) - len(b) % 4:]:
            words.append(t - 256 if t >= 128 else t)  # signed byte
        rows.append(words)
        lens.append(len(b))
    max_b = max((len(r) for r in rows), default=0)
    blocks = np.zeros((len(rows), max(max_b, 1)), np.int64)
    nb = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        blocks[i, :len(r)] = np.asarray(r, np.int64)
        nb[i] = len(r)
    return (blocks.astype(np.uint32).astype(np.int64),  # u32 payload
            nb, np.asarray(lens, np.int32))


def _hash_one_column(v, seed, ctx):
    from velox_tpu import types as T
    cap = ctx.capacity
    k = v.dtype.kind
    if v.dtype.is_string:
        blocks, nb, blen = _spark_string_blocks(v.dictionary)
        blocks_d = jnp.asarray(blocks.astype(np.uint32))
        nb_d = jnp.asarray(nb)
        blen_d = jnp.asarray(blen)
        ids = jnp.clip(v.full_data(cap).astype(jnp.int32), 0,
                       max(len(nb) - 1, 0))
        row_blocks = blocks_d[ids]            # (cap, maxB) uint32
        row_nb = nb_d[ids]
        max_b = int(blocks.shape[1])

        def body(b, h1):
            k1 = _mm_mix_k1(row_blocks[:, b])
            return jnp.where(b < row_nb, _mm_mix_h1(h1, k1), h1)

        h1 = jax.lax.fori_loop(0, max_b, body, seed)
        return _mm_fmix(h1, blen_d[ids].astype(jnp.uint32))
    data = v.full_data(cap)
    if k in (T.TypeKind.BOOLEAN, T.TypeKind.TINYINT, T.TypeKind.SMALLINT,
             T.TypeKind.INTEGER, T.TypeKind.DATE):
        u = jax.lax.bitcast_convert_type(
            data.astype(jnp.int32), jnp.uint32)
        return _mm_hash_i32(u, seed)
    if k is T.TypeKind.REAL:
        f = data.astype(jnp.float32)
        f = jnp.where(f == 0.0, jnp.float32(0.0), f)
        u = jax.lax.bitcast_convert_type(f, jnp.uint32)
        u = jnp.where(jnp.isnan(f), jnp.uint32(0x7FC00000), u)
        return _mm_hash_i32(u, seed)
    if k is T.TypeKind.DOUBLE:
        return _mm_hash_i64(_double_bits(data.astype(jnp.float64)), seed)
    if k in (T.TypeKind.BIGINT, T.TypeKind.TIMESTAMP,
             T.TypeKind.DECIMAL):
        return _mm_hash_i64(data.astype(jnp.int64), seed)
    raise NotImplementedError(f"spark hash over {v.dtype}")


def _spark_hash_eval(ctx, out_dtype, args, seed=42):
    import jax as _jax  # noqa: F401
    cap = ctx.capacity
    seed = jnp.full((cap,), np.uint32(seed & 0xFFFFFFFF), jnp.uint32)
    for v in args:
        h = _hash_one_column(v, seed, ctx)
        if v.validity is not None:
            valid = v.full_validity(cap)
            h = jnp.where(valid, h, seed)     # NULL: seed unchanged
        seed = h
    out = jax.lax.bitcast_convert_type(seed, jnp.int32)
    return EvalValue(out, None, T.INTEGER)


register("hash", lambda ts: T.INTEGER if ts else None, _spark_hash_eval)


# ---------------------------------------------------------------------------
# Spark xxhash64 parity. Parity: velox/functions/sparksql/Hash.cpp
# (XxHash64: seed 42, chains across arguments, NULL passes the seed).
# uint64 lane arithmetic (exact).
# ---------------------------------------------------------------------------

_XP1 = np.uint64(0x9E3779B185EBCA87)
_XP2 = np.uint64(0xC2B2AE3D27D4EB4F)
_XP3 = np.uint64(0x165667B19E3779F9)
_XP4 = np.uint64(0x85EBCA77C2B2AE63)
_XP5 = np.uint64(0x27D4EB2F165667C5)


def _rotl64(x, r):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _xx_fmix(h):
    h = h ^ (h >> np.uint64(33))
    h = (h * _XP2).astype(jnp.uint64)
    h = h ^ (h >> np.uint64(29))
    h = (h * _XP3).astype(jnp.uint64)
    return h ^ (h >> np.uint64(32))


def _xx_hash_i32(u32, seed):
    h = (seed + _XP5 + np.uint64(4)).astype(jnp.uint64)
    h = h ^ (u32.astype(jnp.uint64) * _XP1).astype(jnp.uint64)
    h = (_rotl64(h, 23) * _XP2 + _XP3).astype(jnp.uint64)
    return _xx_fmix(h)


def _xx_hash_i64(u64, seed):
    h = (seed + _XP5 + np.uint64(8)).astype(jnp.uint64)
    h = h ^ (_rotl64((u64 * _XP2).astype(jnp.uint64), 31)
             * _XP1).astype(jnp.uint64)
    h = (_rotl64(h, 27) * _XP1 + _XP4).astype(jnp.uint64)
    return _xx_fmix(h)


def _xx_string_words(dictionary):
    """(words[n, W] uint64 little-endian 8-byte blocks, bytelen[n] int32);
    W padded so stripe/tail indexing never leaves the array."""
    lens = []
    packed = []
    for v in dictionary.values:
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        lens.append(len(b))
        pad = b + b"\0" * ((-len(b)) % 8)
        packed.append([int.from_bytes(pad[i:i + 8], "little")
                       for i in range(0, len(pad), 8)])
    max_w = max((len(p) for p in packed), default=0) + 5
    max_w += (-max_w) % 4
    words = np.zeros((len(packed), max_w), np.uint64)
    for i, p in enumerate(packed):
        words[i, :len(p)] = np.asarray(p, np.uint64)
    return words, np.asarray(lens, np.int32)


def _xx_hash_bytes(row_words, length, seed):
    """XXH64 over per-row byte strings laid out as uint64 word rows.
    row_words: (cap, W) uint64; length: (cap,) int32; seed: (cap,) u64."""
    L = length.astype(jnp.uint64)
    nstripes = (length // 32).astype(jnp.int32)
    max_stripes = row_words.shape[1] // 4

    def wcol(idx):
        return jnp.take_along_axis(row_words, idx[:, None], axis=1)[:, 0]

    def stripe_step(v, k):
        return (_rotl64((v + (k * _XP2).astype(jnp.uint64))
                        .astype(jnp.uint64), 31) * _XP1).astype(jnp.uint64)

    v1 = (seed + _XP1 + _XP2).astype(jnp.uint64)
    v2 = (seed + _XP2).astype(jnp.uint64)
    v3 = seed
    v4 = (seed - _XP1).astype(jnp.uint64)

    def sbody(s, vs):
        v1, v2, v3, v4 = vs
        base = jnp.full_like(nstripes, 4 * s)
        cond = s < nstripes
        nv = [stripe_step(v, wcol(base + j))
              for j, v in enumerate((v1, v2, v3, v4))]
        return tuple(jnp.where(cond, n, o)
                     for n, o in zip(nv, (v1, v2, v3, v4)))

    v1, v2, v3, v4 = jax.lax.fori_loop(
        0, max_stripes, sbody, (v1, v2, v3, v4))
    merged = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
              + _rotl64(v4, 18)).astype(jnp.uint64)
    for v in (v1, v2, v3, v4):
        merged = merged ^ (_rotl64((v * _XP2).astype(jnp.uint64), 31)
                           * _XP1).astype(jnp.uint64)
        merged = (merged * _XP1 + _XP4).astype(jnp.uint64)
    h = jnp.where(nstripes > 0, merged,
                  (seed + _XP5).astype(jnp.uint64))
    h = (h + L).astype(jnp.uint64)
    # tail 8-byte words (at most 3)
    rem = length % 32
    n8 = rem // 8
    w0 = nstripes * 4

    def rbody(j, h):
        k = wcol(w0 + j)
        nh = h ^ (_rotl64((k * _XP2).astype(jnp.uint64), 31)
                  * _XP1).astype(jnp.uint64)
        nh = (_rotl64(nh, 27) * _XP1 + _XP4).astype(jnp.uint64)
        return jnp.where(j < n8, nh, h)

    h = jax.lax.fori_loop(0, 3, rbody, h)
    # tail 4-byte chunk
    kw = wcol(w0 + n8)
    rem4 = rem % 8
    has4 = rem4 >= 4
    k4 = (kw & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint64)
    nh = h ^ (k4 * _XP1).astype(jnp.uint64)
    nh = (_rotl64(nh, 23) * _XP2 + _XP3).astype(jnp.uint64)
    h = jnp.where(has4, nh, h)
    # tail bytes (at most 3), offset past the 4-byte chunk when taken
    nbytes = rem4 - jnp.where(has4, 4, 0)
    boff = jnp.where(has4, 4, 0).astype(jnp.uint64)

    def bbody(j, h):
        shift = ((boff + j) * jnp.uint64(8))
        byte = (kw >> shift) & jnp.uint64(0xFF)
        nh = (_rotl64(h ^ (byte * _XP5).astype(jnp.uint64), 11)
              * _XP1).astype(jnp.uint64)
        return jnp.where(j < nbytes, nh, h)

    h = jax.lax.fori_loop(0, 3, bbody, h)
    return _xx_fmix(h)


def _xx_one_column(v, seed, ctx):
    cap = ctx.capacity
    k = v.dtype.kind
    if v.dtype.is_string:
        words, blen = _xx_string_words(v.dictionary)
        ids = jnp.clip(v.full_data(cap).astype(jnp.int32), 0,
                       max(len(blen) - 1, 0))
        return _xx_hash_bytes(jnp.asarray(words)[ids],
                              jnp.asarray(blen)[ids], seed)
    data = v.full_data(cap)
    if k in (T.TypeKind.BOOLEAN, T.TypeKind.TINYINT, T.TypeKind.SMALLINT,
             T.TypeKind.INTEGER, T.TypeKind.DATE):
        u = jax.lax.bitcast_convert_type(
            data.astype(jnp.int32), jnp.uint32)
        return _xx_hash_i32(u, seed)
    if k is T.TypeKind.REAL:
        f = data.astype(jnp.float32)
        f = jnp.where(f == 0.0, jnp.float32(0.0), f)
        u = jax.lax.bitcast_convert_type(f, jnp.uint32)
        u = jnp.where(jnp.isnan(f), jnp.uint32(0x7FC00000), u)
        return _xx_hash_i32(u, seed)
    if k is T.TypeKind.DOUBLE:
        bits = _double_bits(data.astype(jnp.float64))
        return _xx_hash_i64(bits.astype(jnp.uint64), seed)
    if k in (T.TypeKind.BIGINT, T.TypeKind.TIMESTAMP, T.TypeKind.DECIMAL):
        return _xx_hash_i64(data.astype(jnp.int64).astype(jnp.uint64),
                            seed)
    raise NotImplementedError(f"xxhash64 over {v.dtype}")


def _spark_xxhash64_eval(ctx, out_dtype, args, seed=42):
    cap = ctx.capacity
    seed = jnp.full((cap,), np.uint64(seed & 0xFFFFFFFFFFFFFFFF),
                    jnp.uint64)
    for v in args:
        h = _xx_one_column(v, seed, ctx)
        if v.validity is not None:
            h = jnp.where(v.full_validity(cap), h, seed)
        seed = h
    out = jax.lax.bitcast_convert_type(seed, jnp.int64)
    return EvalValue(out, None, T.BIGINT)


register("xxhash64", lambda ts: T.BIGINT if ts else None,
         _spark_xxhash64_eval)


# ---------------------------------------------------------------------------
# Breadth batch (round 3): Spark-semantics scalar functions.
# Parity: velox/functions/sparksql/{DateTimeFunctions.h,String.h,
# Arithmetic.h,Register.cpp}.
# ---------------------------------------------------------------------------

_alias("dayofmonth", "day")
_alias("array_contains", "contains")


def _date_int_resolver(ts):
    if (len(ts) == 2 and ts[0].kind is T.TypeKind.DATE
            and ts[1].is_integral):
        return T.DATE
    return None


def _spark_date_add_eval(ctx, out_dtype, args):
    d, n = args
    from velox_tpu.expression.eval import merge_validity
    out = (d.full_data(ctx.capacity).astype(jnp.int64)
           + n.full_data(ctx.capacity).astype(jnp.int64))
    return EvalValue(out.astype(jnp.int32), merge_validity(d, n), T.DATE)


def _spark_date_sub_eval(ctx, out_dtype, args):
    d, n = args
    from velox_tpu.expression.eval import merge_validity
    out = (d.full_data(ctx.capacity).astype(jnp.int64)
           - n.full_data(ctx.capacity).astype(jnp.int64))
    return EvalValue(out.astype(jnp.int32), merge_validity(d, n), T.DATE)


# Spark's two-argument forms coexist with Presto's 3-arg date_add via
# resolver overloading (registry tries entries in order)
register("date_add", _date_int_resolver, _spark_date_add_eval)
register("date_sub", _date_int_resolver, _spark_date_sub_eval)


def _unix_date_eval(ctx, out_dtype, args):
    (v,) = args
    return EvalValue(v.full_data(ctx.capacity).astype(jnp.int32),
                     v.validity, T.INTEGER)


from velox_tpu.functions.signature import sig  # noqa: E402

register("unix_date", sig("date -> integer"), _unix_date_eval)


def _weekday_eval(ctx, out_dtype, args):
    """Spark weekday(): 0 = Monday ... 6 = Sunday."""
    (v,) = args
    from velox_tpu.functions.scalar import _date_days
    days = _date_days(v).astype(jnp.int64)
    return EvalValue((days + 3) % 7, v.validity, T.INTEGER)


register("weekday",
         lambda ts: T.INTEGER if len(ts) == 1 and ts[0].kind in (
             T.TypeKind.DATE, T.TypeKind.TIMESTAMP) else None,
         _weekday_eval)


def _last_day_eval(ctx, out_dtype, args):
    """Last day of the month of the given date."""
    (v,) = args
    from velox_tpu.functions.scalar import (_civil_from_days, _date_days,
                                            _days_from_civil)
    days = _date_days(v)
    y, m, _ = _civil_from_days(days)
    ny = jnp.where(m == 12, y + 1, y)
    nm = jnp.where(m == 12, jnp.ones_like(m), m + 1)
    first_next = _days_from_civil(ny, nm, jnp.ones_like(nm))
    return EvalValue((first_next - 1).astype(jnp.int32), v.validity,
                     T.DATE)


register("last_day", sig("date -> date"), _last_day_eval)


def _make_date_eval(ctx, out_dtype, args):
    y, m, d = args
    from velox_tpu.expression.eval import merge_validity
    from velox_tpu.functions.scalar import _days_from_civil
    cap = ctx.capacity
    days = _days_from_civil(y.full_data(cap).astype(jnp.int64),
                            m.full_data(cap).astype(jnp.int64),
                            d.full_data(cap).astype(jnp.int64))
    return EvalValue(days.astype(jnp.int32),
                     merge_validity(y, m, d), T.DATE)


register("make_date", sig("integral, integral, integral -> date"),
         _make_date_eval)


def _ascii_eval(ctx, out_dtype, args):
    from velox_tpu.functions.scalar import _dict_lookup
    return _dict_lookup(args[0],
                        lambda s: ord(s[0]) if s else 0, T.INTEGER)


register("ascii", sig("string -> integer"), _ascii_eval)


def _crc32_eval(ctx, out_dtype, args):
    import zlib

    from velox_tpu.functions.scalar import _dict_lookup
    return _dict_lookup(
        args[0],
        lambda s: zlib.crc32(s.encode() if isinstance(s, str) else s),
        T.BIGINT)


register("crc32", sig("string -> bigint"), _crc32_eval)


def _md5_eval(ctx, out_dtype, args):
    import hashlib

    from velox_tpu.functions.scalar import _dict_map
    return _dict_map(
        args[0],
        lambda s: hashlib.md5(
            s.encode() if isinstance(s, str) else s).hexdigest())


register("md5", sig("string -> varchar"), _md5_eval)


def _nary_minmax(name, pick):
    """Spark least/greatest: n-ary, SKIPS null arguments (null only when
    every argument is null) — unlike Presto's null-propagating form."""
    def eval_fn(ctx, out_dtype, args):
        cap = ctx.capacity
        from velox_tpu.functions.scalar import _numeric_data
        acc = None
        any_valid = jnp.zeros((cap,), bool)
        for v in args:
            d = jnp.broadcast_to(_numeric_data(v, out_dtype, ctx), (cap,))
            valid = (jnp.ones((cap,), bool) if v.validity is None
                     else jnp.broadcast_to(v.validity, (cap,)))
            if acc is None:
                acc = jnp.where(valid, d, d)
            else:
                take_new = valid & (~any_valid | pick(d, acc))
                acc = jnp.where(take_new, d, acc)
            any_valid = any_valid | valid
        return EvalValue(acc, any_valid, out_dtype)
    return eval_fn


def _nary_resolver(ts):
    from velox_tpu.functions.scalar import promote_numeric
    if len(ts) >= 2 and all(t.is_numeric for t in ts):
        out = ts[0]
        for t in ts[1:]:
            out = promote_numeric(out, t)
        return out
    return None


register("least_skipnull", _nary_resolver, _nary_minmax(
    "least", lambda d, acc: d < acc))
register("greatest_skipnull", _nary_resolver, _nary_minmax(
    "greatest", lambda d, acc: d > acc))


# ---------------------------------------------------------------------------
# Round-3 breadth batch 2: string / bitwise / date functions
# (parity: functions/sparksql String.h, Bitwise.h, DateTimeFunctions.h)
# ---------------------------------------------------------------------------

from velox_tpu.functions.scalar import (  # noqa: E402
    _civil_from_days, _date_days, _days_from_civil, _dict_lookup,
    _dict_map,
)


def _const_arg(args, i, fname, default=None):
    v = args[i] if len(args) > i else None
    if v is None:
        if default is None:
            raise ValueError(f"{fname}: missing argument {i}")
        return default
    if v.py_value is None:
        raise NotImplementedError(f"{fname}: argument {i} must be a "
                                  "constant")
    return v.py_value


def _initcap_eval(ctx, out_dtype, args):
    import re as _re

    def f(s):
        return _re.sub(r"(^|\s)(\S)",
                       lambda m: m.group(1) + m.group(2).upper(),
                       s.lower())
    return _dict_map(args[0], f)


register("initcap", sig("string -> varchar"), _initcap_eval)


def _lpad_eval(ctx, out_dtype, args):
    n = int(_const_arg(args, 1, "lpad"))
    pad = str(_const_arg(args, 2, "lpad", " "))

    def f(s):
        if len(s) >= n:
            return s[:n]
        return ((pad * n)[:n - len(s)] if pad else "") + s
    return _dict_map(args[0], f)


def _rpad_eval(ctx, out_dtype, args):
    n = int(_const_arg(args, 1, "rpad"))
    pad = str(_const_arg(args, 2, "rpad", " "))

    def f(s):
        if len(s) >= n:
            return s[:n]
        return s + ((pad * n)[:n - len(s)] if pad else "")
    return _dict_map(args[0], f)


register("lpad", sig("string, integral, string -> varchar"), _lpad_eval)
register("lpad", sig("string, integral -> varchar"), _lpad_eval)
register("rpad", sig("string, integral, string -> varchar"), _rpad_eval)
register("rpad", sig("string, integral -> varchar"), _rpad_eval)


def _levenshtein_eval(ctx, out_dtype, args):
    other = str(_const_arg(args, 1, "levenshtein"))

    def f(s):
        a, b = s, other
        if len(a) < len(b):
            a, b = b, a
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]
    return _dict_lookup(args[0], f, T.INTEGER)


register("levenshtein", sig("string, string -> integer"),
         _levenshtein_eval)


def _translate_eval(ctx, out_dtype, args):
    src = str(_const_arg(args, 1, "translate"))
    dst = str(_const_arg(args, 2, "translate"))
    # Spark: chars beyond len(dst) are DELETED
    table = {ord(c): (dst[i] if i < len(dst) else None)
             for i, c in enumerate(src)}
    return _dict_map(args[0], lambda s: s.translate(table))


register("translate", sig("string, string, string -> varchar"),
         _translate_eval)


def _locate_eval(ctx, out_dtype, args):
    sub = str(_const_arg(args, 0, "locate"))
    start = int(_const_arg(args, 2, "locate", 1))

    def f(s):
        if start < 1:
            return 0
        return s.find(sub, start - 1) + 1
    return _dict_lookup(args[1], f, T.INTEGER)


register("locate", sig("string, string, integral -> integer"),
         _locate_eval)
register("locate", sig("string, string -> integer"), _locate_eval)


def _find_in_set_eval(ctx, out_dtype, args):
    lst = str(_const_arg(args, 1, "find_in_set")).split(",")

    def f(s):
        if "," in s:
            return 0
        try:
            return lst.index(s) + 1
        except ValueError:
            return 0
    return _dict_lookup(args[0], f, T.INTEGER)


register("find_in_set", sig("string, string -> integer"),
         _find_in_set_eval)


def _substring_index_eval(ctx, out_dtype, args):
    delim = str(_const_arg(args, 1, "substring_index"))
    cnt = int(_const_arg(args, 2, "substring_index"))

    def f(s):
        if cnt == 0 or not delim:
            return ""
        parts = s.split(delim)
        if cnt > 0:
            return delim.join(parts[:cnt])
        return delim.join(parts[cnt:])
    return _dict_map(args[0], f)


register("substring_index", sig("string, string, integral -> varchar"),
         _substring_index_eval)


def _repeat_eval(ctx, out_dtype, args):
    n = int(_const_arg(args, 1, "repeat"))
    return _dict_map(args[0], lambda s: s * max(n, 0))


register("repeat", sig("string, integral -> varchar"), _repeat_eval)


def _overlay_eval(ctx, out_dtype, args):
    repl = str(_const_arg(args, 1, "overlay"))
    pos = int(_const_arg(args, 2, "overlay"))
    ln = int(_const_arg(args, 3, "overlay", -1))
    use_len = ln if ln >= 0 else len(repl)

    def f(s):
        p = max(pos, 1) - 1
        return s[:p] + repl + s[p + use_len:]
    return _dict_map(args[0], f)


register("overlay",
         sig("string, string, integral, integral -> varchar"),
         _overlay_eval)
register("overlay", sig("string, string, integral -> varchar"),
         _overlay_eval)


_SOUNDEX_CODES = {**{c: "1" for c in "BFPV"},
                  **{c: "2" for c in "CGJKQSXZ"},
                  **{c: "3" for c in "DT"}, "L": "4",
                  **{c: "5" for c in "MN"}, "R": "6"}


def _soundex_eval(ctx, out_dtype, args):
    def f(s):
        if not s or not s[0].isalpha():
            return s
        u = s.upper()
        out = [u[0]]
        prev = _SOUNDEX_CODES.get(u[0], "")
        for ch in u[1:]:
            code = _SOUNDEX_CODES.get(ch, "")
            if code and code != prev:
                out.append(code)
                if len(out) == 4:
                    break
            if ch not in "HW":
                prev = code
        return "".join(out).ljust(4, "0")
    return _dict_map(args[0], f)


register("soundex", sig("string -> varchar"), _soundex_eval)


def _hex_str_eval(ctx, out_dtype, args):
    return _dict_map(args[0], lambda s: (
        s.encode() if isinstance(s, str) else bytes(s)).hex().upper())


register("hex", sig("string -> varchar"), _hex_str_eval)


def _unhex_eval(ctx, out_dtype, args):
    def f(s):
        try:
            return bytes.fromhex(s).decode("latin-1")
        except ValueError:
            return None
    from velox_tpu.functions.strings_ext import _dict_map_nullable
    return _dict_map_nullable(args[0], f)


register("unhex", sig("string -> varchar"), _unhex_eval)


# ---- bitwise ---------------------------------------------------------------

def _bit_count_eval(ctx, out_dtype, args):
    (v,) = args
    x = v.full_data(ctx.capacity).astype(jnp.int64)
    u = jax.lax.bitcast_convert_type(x, jnp.uint64)
    # SWAR popcount (Hacker's Delight 5-2) — branch-free arithmetic
    u = u - ((u >> jnp.uint64(1)) & jnp.uint64(0x5555555555555555))
    u = (u & jnp.uint64(0x3333333333333333)) \
        + ((u >> jnp.uint64(2)) & jnp.uint64(0x3333333333333333))
    u = (u + (u >> jnp.uint64(4))) & jnp.uint64(0x0F0F0F0F0F0F0F0F)
    with np.errstate(over="ignore"):
        cnt = (u * jnp.uint64(0x0101010101010101)) >> jnp.uint64(56)
    return EvalValue(cnt.astype(jnp.int32), v.validity, T.INTEGER)


register("bit_count", sig("integral -> integer"), _bit_count_eval)


def _bit_get_eval(ctx, out_dtype, args):
    v, p = args
    x = v.full_data(ctx.capacity).astype(jnp.int64)
    pos = p.full_data(ctx.capacity).astype(jnp.int64)
    bit = ((x >> jnp.clip(pos, 0, 63)) & 1).astype(jnp.int8)
    return EvalValue(bit, merge_validity(v, p), T.TINYINT)


register("bit_get", sig("integral, integral -> tinyint"), _bit_get_eval)


_FACTORIALS = np.array(
    [1, 1, 2, 6, 24, 120, 720, 5040, 40320, 362880, 3628800,
     39916800, 479001600, 6227020800, 87178291200, 1307674368000,
     20922789888000, 355687428096000, 6402373705728000,
     121645100408832000, 2432902008176640000], dtype=np.int64)


def _factorial_eval(ctx, out_dtype, args):
    (v,) = args
    x = v.full_data(ctx.capacity).astype(jnp.int64)
    ok = (x >= 0) & (x <= 20)
    idx = jnp.clip(x, 0, 20)
    data = jnp.asarray(_FACTORIALS)[idx]
    validity = ok if v.validity is None \
        else v.full_validity(ctx.capacity) & ok
    return EvalValue(data, validity, T.BIGINT)


register("factorial", sig("integral -> bigint"), _factorial_eval)


# ---- dates -----------------------------------------------------------------

def _next_day_eval(ctx, out_dtype, args):
    dows = {"MO": 0, "TU": 1, "WE": 2, "TH": 3, "FR": 4, "SA": 5,
            "SU": 6}
    want = dows.get(str(_const_arg(args, 1, "next_day"))[:2].upper())
    (v,) = args[:1]
    days = _date_days(v).astype(jnp.int64)
    if want is None:
        return EvalValue(jnp.zeros_like(days, dtype=jnp.int32),
                         jnp.zeros((ctx.capacity,), bool), T.DATE)
    cur = (days + 3) % 7  # 0 = Monday
    delta = (want - cur - 1) % 7 + 1
    return EvalValue((days + delta).astype(jnp.int32), v.validity,
                     T.DATE)


register("next_day", sig("date, string -> date"), _next_day_eval)


def _months_between_eval(ctx, out_dtype, args):
    a, b = args
    da = _date_days(a).astype(jnp.int64)
    db = _date_days(b).astype(jnp.int64)
    ya, ma, ka = _civil_from_days(da)
    yb, mb, kb = _civil_from_days(db)
    whole = (ya - yb) * 12 + (ma - mb)
    # Spark: same day-of-month OR both last-day-of-month -> integer
    last_a = _days_from_civil(ya + (ma == 12), jnp.where(
        ma == 12, 1, ma + 1), jnp.ones_like(ka)) - 1
    last_b = _days_from_civil(yb + (mb == 12), jnp.where(
        mb == 12, 1, mb + 1), jnp.ones_like(kb)) - 1
    both_last = (da == last_a) & (db == last_b)
    frac = jnp.where((ka == kb) | both_last, 0.0,
                     (ka - kb).astype(jnp.float64) / 31.0)
    return EvalValue(whole.astype(jnp.float64) + frac,
                     merge_validity(a, b), T.DOUBLE)


register("months_between", sig("date, date -> double"),
         _months_between_eval)


def _unix_timestamp_eval(ctx, out_dtype, args):
    (v,) = args
    micros = v.full_data(ctx.capacity)
    secs = jnp.where(micros >= 0, micros // 1_000_000,
                     -((-micros) // 1_000_000))
    return EvalValue(secs.astype(jnp.int64), v.validity, T.BIGINT)


register("unix_timestamp", sig("timestamp -> bigint"),
         _unix_timestamp_eval)
