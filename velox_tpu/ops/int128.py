"""int128 limb arithmetic for long decimals (DECIMAL(19..38)).

Role parity: ``velox/type/HugeInt.h`` + ``type/DecimalUtil.h`` — the
reference backs long decimals with __int128. Representation here:
two int64 limbs per value, `lo` carrying the low 64 bits (unsigned bit
pattern stored in int64) and `hi` the signed high 64 bits. Columns store
lo as the DeviceColumn data and hi as a child column
(vector/device.py); all math here is branch-free jnp on the limbs.

x64 mode is required (velox_tpu always enables it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_M32 = np.uint64(0xFFFFFFFF)


def _u(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.int64), jnp.uint64)


def _s(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.uint64), jnp.int64)


def from_i64(x):
    """Sign-extend int64 -> (lo, hi) limbs."""
    x = x.astype(jnp.int64)
    return x, x >> np.int64(63)


def add128(alo, ahi, blo, bhi):
    lo = _s(_u(alo) + _u(blo))
    carry = (_u(lo) < _u(alo)).astype(jnp.int64)
    return lo, ahi + bhi + carry


def neg128(lo, hi):
    nlo = _s(~_u(lo) + np.uint64(1))
    borrow = (_u(nlo) == np.uint64(0)).astype(jnp.int64)
    return nlo, ~hi + borrow


def sub128(alo, ahi, blo, bhi):
    nlo, nhi = neg128(blo, bhi)
    return add128(alo, ahi, nlo, nhi)


def eq128(alo, ahi, blo, bhi):
    return (alo == blo) & (ahi == bhi)


def lt128(alo, ahi, blo, bhi):
    return (ahi < bhi) | ((ahi == bhi) & (_u(alo) < _u(blo)))


def mul_i64_full(a, b):
    """Signed 64x64 -> full 128-bit product as (lo, hi) limbs."""
    ua, ub = _u(a), _u(b)
    a0, a1 = ua & _M32, ua >> np.uint64(32)
    b0, b1 = ub & _M32, ub >> np.uint64(32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | (mid << np.uint64(32))
    hi_u = p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) \
        + (mid >> np.uint64(32))
    hi = _s(hi_u)
    # signed correction: if a < 0 subtract b from hi; if b < 0 subtract a
    hi = hi - jnp.where(a < 0, b, jnp.int64(0)) \
        - jnp.where(b < 0, a, jnp.int64(0))
    return _s(lo), hi


def mul128_u64(lo, hi, c: int):
    """(lo, hi) * small positive constant c (fits u64; e.g. 10^k)."""
    c = np.uint64(c)
    ulo = _u(lo)
    l0, l1 = ulo & _M32, ulo >> np.uint64(32)
    c0, c1 = c & _M32, c >> np.uint64(32)
    p00 = l0 * c0
    p01 = l0 * c1
    p10 = l1 * c0
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    new_lo = (p00 & _M32) | (mid << np.uint64(32))
    carry = _s((l1 * c1) + (p01 >> np.uint64(32))
               + (p10 >> np.uint64(32)) + (mid >> np.uint64(32)))
    return _s(new_lo), hi * np.int64(c) + carry


def rescale_up(lo, hi, k: int):
    """Multiply by 10^k (k >= 0) — decimal scale alignment."""
    while k > 0:
        step = min(k, 18)
        lo, hi = mul128_u64(lo, hi, 10 ** step)
        k -= step
    return lo, hi


def umul64_full(ua, ub):
    """Unsigned 64x64 -> (lo, hi) uint64 product limbs."""
    a0, a1 = ua & _M32, ua >> np.uint64(32)
    b0, b1 = ub & _M32, ub >> np.uint64(32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = (p00 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | (mid << np.uint64(32))
    hi = a1 * b1 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) \
        + (mid >> np.uint64(32))
    return lo, hi


def abs128(lo, hi):
    """-> (|x| lo, |x| hi, was_negative)."""
    neg = hi < 0
    nlo, nhi = neg128(lo, hi)
    return (jnp.where(neg, nlo, lo), jnp.where(neg, nhi, hi), neg)


def mul128_i64(lo, hi, c):
    """Signed (lo, hi) x per-row signed int64 c -> low 128 bits."""
    alo, ahi, aneg = abs128(lo, hi)
    uc = _u(jnp.abs(c))
    plo, pmid = umul64_full(_u(alo), uc)
    phi = pmid + _u(ahi) * uc  # low-64 wrap of the high partial
    rlo, rhi = _s(plo), _s(phi)
    neg = aneg ^ (c < 0)
    nlo, nhi = neg128(rlo, rhi)
    return jnp.where(neg, nlo, rlo), jnp.where(neg, nhi, rhi)


def combine_parts(p0, p1, p2, p3):
    """Recombine four 32-bit planar partial sums (int64 accumulators,
    p0..p2 non-negative, p3 signed) into (lo, hi) — the SUM aggregate
    extraction (exec/aggregation sum over long decimals)."""
    c0 = _u(p0)
    l0 = c0 & _M32
    c1 = (c0 >> np.uint64(32)) + _u(p1)
    l1 = c1 & _M32
    c2 = (c1 >> np.uint64(32)) + _u(p2)
    l2 = c2 & _M32
    c3 = (c2 >> np.uint64(32)) + _u(p3)
    l3 = c3 & _M32
    lo = _s(l0 | (l1 << np.uint64(32)))
    hi = _s(l2 | (l3 << np.uint64(32)))
    return lo, hi


def combine_two_parts(s_lo, s_hi):
    """(lo, hi) int128 from TWO planar parts of summed int64 values:
    s_lo = sum of (v & 0xFFFFFFFF) >= 0, s_hi = sum of (v >> 32)
    (arithmetic, signed). value = s_hi * 2^32 + s_lo exactly. Short-
    decimal SUM states use this 2-part form (half the scatters of the
    4-part int128 form; exact while row counts stay below 2^31)."""
    shl_lo = _s(_u(s_hi) << np.uint64(32))
    shl_hi = _s(((_u(s_hi) >> np.uint64(32))
                 | (_u(s_hi >> np.int64(63)) << np.uint64(32))))
    return add128(shl_lo, shl_hi, s_lo, jnp.zeros_like(s_lo))


def split_parts(lo, hi):
    """(lo, hi) -> four planar 32-bit parts as int64 (p3 keeps sign)."""
    ulo = _u(lo)
    p0 = _s(ulo & _M32)
    p1 = _s(ulo >> np.uint64(32))
    p2 = hi & np.int64(0xFFFFFFFF)
    p3 = hi >> np.int64(32)  # arithmetic: carries the sign
    return p0, p1, p2, p3


def to_numpy_ints(lo_np: np.ndarray, hi_np: np.ndarray):
    """Host: limb arrays -> python-int array (exact)."""
    lo_u = lo_np.astype(np.int64).view(np.uint64)
    out = np.empty(len(lo_np), dtype=object)
    for i in range(len(lo_np)):
        out[i] = (int(hi_np[i]) << 64) | int(lo_u[i])
    return out


def from_python_int(v: int):
    """Host: python int -> (lo, hi) numpy int64 scalars (two's compl)."""
    lo = v & 0xFFFFFFFFFFFFFFFF
    if lo >= 1 << 63:
        lo -= 1 << 64
    return np.int64(lo), np.int64(v >> 64)  # python >> is arithmetic


def divmod128_u64(lo, hi, d):
    """Unsigned (hi:lo) / d -> (qlo, qhi, rem), all int64-typed limbs.

    Restoring long division, MSB-first over the 128 dividend bits via
    ``lax.fori_loop`` (128 elementwise steps — no data-dependent Python
    control flow). Requires 0 < d < 2^63 (SQL counts), so the running
    remainder always fits one uint64. Parity: velox/type/DecimalUtil.h
    divideWithRoundUp over int128.
    """
    ulo, uhi = _u(lo), _u(hi)
    ud = _u(d.astype(jnp.int64))

    def body(i, carry):
        rem, qlo, qhi = carry
        # bit index from the top: i=0 -> bit 127
        k = np.uint64(127) - i.astype(jnp.uint64)
        bit = jnp.where(k >= np.uint64(64),
                        (uhi >> (k - np.uint64(64))) & np.uint64(1),
                        (ulo >> (k & np.uint64(63))) & np.uint64(1))
        rem = (rem << np.uint64(1)) | bit
        ge = rem >= ud
        rem = jnp.where(ge, rem - ud, rem)
        qbit = ge.astype(jnp.uint64)
        qhi = (qhi << np.uint64(1)) | (qlo >> np.uint64(63))
        qlo = (qlo << np.uint64(1)) | qbit
        return rem, qlo, qhi

    zero = jnp.zeros_like(ulo)
    rem, qlo, qhi = jax.lax.fori_loop(
        jnp.uint64(0), jnp.uint64(128), body, (zero, zero, zero))
    return _s(qlo), _s(qhi), _s(rem)


def div128_round_half_up(lo, hi, d):
    """Signed (hi:lo) / d with half-up rounding (d > 0): the decimal-avg
    division. Returns (qlo, qhi)."""
    alo, ahi, _neg = abs128(lo, hi)
    half = (d.astype(jnp.int64) >> np.int64(1))
    alo, ahi = add128(alo, ahi, half, jnp.zeros_like(half))
    qlo, qhi, _ = divmod128_u64(alo, ahi, d)
    neg = hi < 0
    nlo, nhi = neg128(qlo, qhi)
    return jnp.where(neg, nlo, qlo), jnp.where(neg, nhi, qhi)
