"""IP-address function family.

Role parity: ``velox/functions/prestosql/IPAddressFunctions.h``
(ip_prefix, ip_subnet_min/max, is_subnet_of, plus an is_private_ip
predicate). The URL family (URLFunctions.cpp parity) lives in
functions/strings_ext.py.

Placement: dictionary-space transforms — IP columns parse per
DISTINCT value at trace time (functions/strings_ext.py
_dict_map_nullable), so the device only carries remapped ids. The
reference's IPADDRESS/IPPREFIX physical types map to canonical-form
VARCHAR here; canonical text forms compare and group correctly.
Python's ``ipaddress`` supplies the parsing semantics; invalid inputs
produce NULL exactly like the reference's IPAddress failures do.
"""

from __future__ import annotations

import ipaddress

import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue
from velox_tpu.functions.registry import register
from velox_tpu.functions.scalar import _require_dict, _str_resolver
from velox_tpu.functions.strings_ext import _dict_map_nullable


def _dict_lookup_nullable(v: EvalValue, f, out_dtype) -> EvalValue:
    """Per-distinct scalar lookup where f may return None (-> NULL)."""
    d = _require_dict(v, "ip function")
    vals = [f(x) for x in d.values]
    table = np.array([0 if x is None else x for x in vals],
                     dtype=out_dtype.np_dtype())
    nulls = np.array([x is None for x in vals], dtype=bool)
    data = jnp.asarray(table)[v.data]
    isnull = jnp.asarray(nulls)[v.data]
    validity = ~isnull if v.validity is None else (v.validity & ~isnull)
    return EvalValue(data, validity, out_dtype)


def _ip(s):
    try:
        return ipaddress.ip_address(s.strip())
    except ValueError:
        return None


def _net(s):
    try:
        return ipaddress.ip_network(s.strip(), strict=False)
    except ValueError:
        return None


def _ip_prefix(s, bits: int):
    a = _ip(s)
    if a is None:
        return None
    try:
        net = ipaddress.ip_network(f"{a}/{bits}", strict=False)
    except ValueError:
        return None
    return str(net)


def _subnet_min(s):
    n = _net(s)
    return None if n is None else str(n.network_address)


def _subnet_max(s):
    n = _net(s)
    return None if n is None else str(n.broadcast_address)


def _is_private(s):
    a = _ip(s)
    return None if a is None else bool(a.is_private)


def _ip_prefix_eval(ctx, o, args):
    bits_v = args[1]
    if bits_v.py_value is None:
        raise NotImplementedError(
            "ip_prefix: prefix length must be a constant")
    bits = int(bits_v.py_value)
    return _dict_map_nullable(args[0], lambda s: _ip_prefix(s, bits))


register("ip_prefix",
         lambda ts: T.VARCHAR if len(ts) == 2 and ts[0].is_string
         and ts[1].is_integral else None,
         _ip_prefix_eval)
register("ip_subnet_min", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_nullable(a[0], _subnet_min))
register("ip_subnet_max", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_nullable(a[0], _subnet_max))
register("is_private_ip", _str_resolver(T.BOOLEAN),
         lambda ctx, o, a: _dict_lookup_nullable(a[0], _is_private,
                                                 T.BOOLEAN))


def _is_subnet_of_eval(ctx, o, args):
    """is_subnet_of(prefix, ip_or_prefix): one side may be a constant."""
    pfx, ip = args
    if pfx.py_value is not None:
        net = _net(pfx.py_value)

        def f(s):
            if net is None:
                return None
            if "/" in s:
                b = _net(s)
                if b is None:
                    return None
                return (b.subnet_of(net)
                        if b.version == net.version else False)
            a = _ip(s)
            return None if a is None else (
                a in net if a.version == net.version else False)
        return _dict_lookup_nullable(ip, f, T.BOOLEAN)
    if ip.py_value is not None:
        a = _ip(ip.py_value)

        def g(s):
            n = _net(s)
            if n is None or a is None:
                return None
            return a in n if a.version == n.version else False
        return _dict_lookup_nullable(pfx, g, T.BOOLEAN)
    raise NotImplementedError(
        "is_subnet_of: one argument must be a constant")


register("is_subnet_of",
         lambda ts: T.BOOLEAN if len(ts) == 2
         and all(t.is_string for t in ts) else None,
         _is_subnet_of_eval)
