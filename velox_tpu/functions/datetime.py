"""Date/time arithmetic functions (Presto semantics).

Role parity: ``velox/functions/prestosql/DateTimeFunctions.h`` (date_add,
date_diff, date_trunc, week/hour/minute/second, from/to_unixtime) over our
device layouts: DATE = int32 days since epoch, TIMESTAMP = int64 micros.
All computation is branch-free integer arithmetic on device (the civil-date
conversions live in scalar.py: _civil_from_days / _days_from_civil).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue, merge_validity
from velox_tpu.functions.registry import _REGISTRY, register
from velox_tpu.functions.scalar import (
    _civil_from_days, _date_days, _days_from_civil, fixed,
)

_US_PER = {
    "millisecond": 1_000,
    "second": 1_000_000,
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": 86_400_000_000,
}
_DATE_UNITS = ("day", "week", "month", "quarter", "year")


def _unit_of(arg: EvalValue) -> str:
    if arg.py_value is None:
        raise ValueError("date_add/date_diff unit must be a string literal")
    return str(arg.py_value).lower()


def _is_datelike(t: T.DataType) -> bool:
    return t.kind in (T.TypeKind.DATE, T.TypeKind.TIMESTAMP)


def _shift_months(days, n):
    """Add n months to days-since-epoch (clamping day-of-month, Presto)."""
    y, m, d = _civil_from_days(days)
    total = (y * 12 + (m - 1)) + n
    y2 = total // 12
    m2 = total % 12 + 1
    # clamp day to the target month's length
    leap = ((y2 % 4 == 0) & (y2 % 100 != 0)) | (y2 % 400 == 0)
    mdays = jnp.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
    dmax = mdays[m2 - 1] + jnp.where((m2 == 2) & leap, 1, 0)
    d2 = jnp.minimum(d, dmax)
    return _days_from_civil(y2, m2, d2)


def _date_add_eval(ctx, out_dtype, args):
    unit, n, v = args
    u = _unit_of(unit)
    amount = n.full_data(ctx.capacity).astype(jnp.int64)
    validity = merge_validity(n, v)
    if v.dtype.kind is T.TypeKind.DATE:
        days = v.full_data(ctx.capacity).astype(jnp.int64)
        if u == "day":
            out = days + amount
        elif u == "week":
            out = days + amount * 7
        elif u == "month":
            out = _shift_months(days, amount)
        elif u == "quarter":
            out = _shift_months(days, amount * 3)
        elif u == "year":
            out = _shift_months(days, amount * 12)
        else:
            raise ValueError(f"date_add: unit {u!r} invalid for DATE")
        return EvalValue(out.astype(jnp.int32), validity, T.DATE)
    micros = v.full_data(ctx.capacity)
    if u in _US_PER:
        out = micros + amount * _US_PER[u]
    elif u in ("week", "month", "quarter", "year"):
        days = micros // 86_400_000_000
        rem = micros - days * 86_400_000_000
        months = {"week": None, "month": 1, "quarter": 3, "year": 12}[u]
        if u == "week":
            out = micros + amount * 7 * 86_400_000_000
        else:
            out = _shift_months(days, amount * months) * 86_400_000_000 \
                + rem
    else:
        raise ValueError(f"date_add: unknown unit {u!r}")
    return EvalValue(out, validity, T.TIMESTAMP)


def _date_add_resolver(ts):
    if len(ts) == 3 and ts[0].is_string and ts[1].is_integral \
            and _is_datelike(ts[2]):
        return ts[2]
    return None


register("date_add", _date_add_resolver, _date_add_eval)


def _trunc_div(x, n: int):
    """Integer division truncating toward zero (complete elapsed units —
    Presto/reference semantics, velox DateTimeImpl.h diffTimestamp)."""
    s = jnp.sign(x)
    return s * (jnp.abs(x) // n)


def _complete_months(da, rema, db, remb):
    """Complete calendar months elapsed from (da, rema) to (db, remb),
    where da/db are epoch days and rema/remb sub-day micros. Matches the
    reference: the partial month at the end does not count."""
    ya, ma, daya = _civil_from_days(da)
    yb, mb, dayb = _civil_from_days(db)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    # tie-break on (day-of-month, time-of-day): a positive span loses one
    # month if the end's day/time is earlier than the start's (and the
    # mirror image for negative spans)
    end_lt = (dayb < daya) | ((dayb == daya) & (remb < rema))
    end_gt = (dayb > daya) | ((dayb == daya) & (remb > rema))
    months = jnp.where((months > 0) & end_lt, months - 1, months)
    months = jnp.where((months < 0) & end_gt, months + 1, months)
    return months


def _date_diff_eval(ctx, out_dtype, args):
    unit, a, b = args
    u = _unit_of(unit)
    validity = merge_validity(a, b)
    both_dates = (a.dtype.kind is T.TypeKind.DATE
                  and b.dtype.kind is T.TypeKind.DATE)
    ua = a.full_data(ctx.capacity).astype(jnp.int64)
    ub = b.full_data(ctx.capacity).astype(jnp.int64)
    if a.dtype.kind is T.TypeKind.DATE:
        ua = ua * 86_400_000_000
    if b.dtype.kind is T.TypeKind.DATE:
        ub = ub * 86_400_000_000
    if u in _US_PER:
        out = ((ub - ua) // _US_PER[u] if both_dates and u == "day"
               else _trunc_div(ub - ua, _US_PER[u]))
        return EvalValue(out, validity, T.BIGINT)
    if u == "week":
        return EvalValue(_trunc_div(ub - ua, 7 * 86_400_000_000),
                         validity, T.BIGINT)
    if u in ("month", "quarter", "year"):
        da = jnp.floor_divide(ua, 86_400_000_000)
        db = jnp.floor_divide(ub, 86_400_000_000)
        months = _complete_months(da, ua - da * 86_400_000_000,
                                  db, ub - db * 86_400_000_000)
        out = _trunc_div(months, {"month": 1, "quarter": 3, "year": 12}[u])
        return EvalValue(out, validity, T.BIGINT)
    raise ValueError(f"date_diff: unknown unit {u!r}")


def _date_diff_resolver(ts):
    if len(ts) == 3 and ts[0].is_string and _is_datelike(ts[1]) \
            and _is_datelike(ts[2]):
        return T.BIGINT
    return None


register("date_diff", _date_diff_resolver, _date_diff_eval)


def _date_trunc_eval(ctx, out_dtype, args):
    unit, v = args
    u = _unit_of(unit)
    validity = v.validity
    if v.dtype.kind is T.TypeKind.DATE:
        days = v.full_data(ctx.capacity).astype(jnp.int64)
        rem = jnp.zeros_like(days)
    else:
        micros = v.full_data(ctx.capacity)
        days = micros // 86_400_000_000
        rem = micros - days * 86_400_000_000
    if u in ("second", "minute", "hour"):
        q = _US_PER[u]
        out_us = days * 86_400_000_000 + (rem // q) * q
        return EvalValue(out_us, validity, T.TIMESTAMP)
    y, m, d = _civil_from_days(days)
    one = jnp.ones_like(m)
    if u == "day":
        td = days
    elif u == "week":
        td = days - (days + 3) % 7  # ISO week starts Monday
    elif u == "month":
        td = _days_from_civil(y, m, one)
    elif u == "quarter":
        td = _days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    elif u == "year":
        td = _days_from_civil(y, one, one)
    else:
        raise ValueError(f"date_trunc: unknown unit {u!r}")
    if v.dtype.kind is T.TypeKind.DATE:
        return EvalValue(td.astype(jnp.int32), validity, T.DATE)
    return EvalValue(td * 86_400_000_000, validity, T.TIMESTAMP)


def _date_trunc_resolver(ts):
    if len(ts) == 2 and ts[0].is_string and _is_datelike(ts[1]):
        return ts[1]
    return None


register("date_trunc", _date_trunc_resolver, _date_trunc_eval)


def _week_eval(ctx, out_dtype, args):
    """ISO 8601 week-of-year."""
    (v,) = args
    days = _date_days(v).astype(jnp.int64)
    # Thursday of this ISO week determines the ISO year
    thu = days - (days + 3) % 7 + 3
    y, _, _ = _civil_from_days(thu)
    jan1 = _days_from_civil(y, jnp.ones_like(y), jnp.ones_like(y))
    week = (thu - jan1) // 7 + 1
    return EvalValue(week, v.validity, T.BIGINT)


register("week", fixed(T.BIGINT, _is_datelike), _week_eval)
_REGISTRY["week_of_year"] = _REGISTRY["week"]


def _time_part(name, divisor, modulus):
    def eval_fn(ctx, out_dtype, args):
        (v,) = args
        if v.dtype.kind is not T.TypeKind.TIMESTAMP:
            raise TypeError(f"{name} requires TIMESTAMP")
        micros = v.full_data(ctx.capacity)
        out = (micros // divisor) % modulus
        return EvalValue(out, v.validity, T.BIGINT)
    register(name, fixed(
        T.BIGINT, lambda t: t.kind is T.TypeKind.TIMESTAMP), eval_fn)


_time_part("hour", 3_600_000_000, 24)
_time_part("minute", 60_000_000, 60)
_time_part("second", 1_000_000, 60)
_time_part("millisecond", 1_000, 1000)


def _to_unixtime_eval(ctx, out_dtype, args):
    (v,) = args
    micros = v.full_data(ctx.capacity)
    return EvalValue(micros.astype(jnp.float64) / 1e6, v.validity, T.DOUBLE)


register("to_unixtime", fixed(
    T.DOUBLE, lambda t: t.kind is T.TypeKind.TIMESTAMP), _to_unixtime_eval)


def _from_unixtime_eval(ctx, out_dtype, args):
    (v,) = args
    secs = v.full_data(ctx.capacity).astype(jnp.float64)
    return EvalValue((secs * 1e6).astype(jnp.int64), v.validity,
                     T.TIMESTAMP)


register("from_unixtime",
         lambda ts: T.TIMESTAMP if len(ts) == 1 and ts[0].is_numeric
         else None, _from_unixtime_eval)


# ---------------------------------------------------------------------------
# IANA time zones. Parity: velox/type/tz/TimeZoneMap.h + prestosql datetime
# functions with zone arguments.
#
# A zone's TZif transition table (RFC 8536, read from the system
# tzdata) becomes two small device arrays (transition instants + UTC offsets);
# per row the offset is offsets[searchsorted(transitions, ts)] — one binary
# search over a few hundred entries, fully traced. Zone names must be
# constants (they select the baked table at trace time).
# ---------------------------------------------------------------------------

import os as _os
import struct as _struct
from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=None)
def _tz_table(name: str):
    """(transitions_micros int64[n+1], offsets_seconds int32[n+1]) from the
    TZif file: offsets[i] applies to instants in
    [transitions[i], transitions[i+1]). transitions[0] = -inf sentinel."""
    for base in ("/usr/share/zoneinfo",
                 _os.path.join(_os.path.dirname(
                     __import__("tzdata").__file__), "zoneinfo")):
        path = _os.path.join(base, name)
        if _os.path.exists(path):
            break
    else:
        raise ValueError(f"unknown time zone {name!r}")
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"TZif":
        raise ValueError(f"{name}: not a TZif file")

    def parse_block(off, tsize, fmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt
         ) = _struct.unpack(">6I", data[off + 20:off + 44])
        p = off + 44
        times = _struct.unpack(f">{timecnt}{fmt}",
                               data[p:p + timecnt * tsize])
        p += timecnt * tsize
        idx = data[p:p + timecnt]
        p += timecnt
        types = [_struct.unpack(">lBB", data[p + i * 6:p + i * 6 + 6])
                 for i in range(typecnt)]
        p += typecnt * 6 + charcnt + leapcnt * (tsize + 4) \
            + isstdcnt + isutcnt
        return times, idx, types, p

    version = data[4:5]
    times, idx, types, end = parse_block(0, 4, "l")
    if version in (b"2", b"3"):
        times, idx, types, _ = parse_block(end, 8, "q")
    if not types:
        raise ValueError(f"{name}: empty zone data")
    # offset before the first transition: the first non-DST type (TZif
    # convention), else type 0
    first = next((t for t in types if not t[1]), types[0])
    offs = [first[0]] + [types[i][0] for i in idx]
    trans = [-(1 << 62)] + [t * 1_000_000 for t in times]
    return (np.asarray(trans, np.int64), np.asarray(offs, np.int32))


def _tz_offset_seconds(ts_micros, tz_name: str):
    """Traced per-row UTC offset (seconds) of the zone at each instant."""
    trans, offs = _tz_table(tz_name)
    i = jnp.searchsorted(jnp.asarray(trans), ts_micros, side="right") - 1
    return jnp.asarray(offs)[jnp.clip(i, 0, len(offs) - 1)]


def _const_str(v) -> str:
    s = v.py_value if hasattr(v, "py_value") else None
    if s is None:
        raise ValueError("time zone argument must be a constant string")
    return s


def _at_timezone_eval(ctx, out_dtype, args):
    ts, tz = args
    data = ts.full_data(ctx.capacity).astype(jnp.int64)
    off = _tz_offset_seconds(data, _const_str(tz))
    local = data + off.astype(jnp.int64) * 1_000_000
    return EvalValue(local, ts.validity, T.TIMESTAMP)


register("at_timezone",
         lambda ts: T.TIMESTAMP if len(ts) == 2
         and ts[0].kind is T.TypeKind.TIMESTAMP else None,
         _at_timezone_eval)


def _tz_part_eval(minute: bool):
    def eval_fn(ctx, out_dtype, args):
        ts, tz = args
        data = ts.full_data(ctx.capacity).astype(jnp.int64)
        off = _tz_offset_seconds(data, _const_str(tz))
        # Presto truncates toward zero: -9:30 -> hour -9, minute -30
        sign = jnp.where(off < 0, -1, 1)
        a = jnp.abs(off)
        val = sign * ((a % 3600) // 60 if minute else a // 3600)
        return EvalValue(val.astype(jnp.int64), ts.validity, T.BIGINT)
    return eval_fn


register("timezone_hour",
         lambda ts: T.BIGINT if len(ts) == 2
         and ts[0].kind is T.TypeKind.TIMESTAMP else None,
         _tz_part_eval(False))
register("timezone_minute",
         lambda ts: T.BIGINT if len(ts) == 2
         and ts[0].kind is T.TypeKind.TIMESTAMP else None,
         _tz_part_eval(True))
