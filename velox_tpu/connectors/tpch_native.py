"""ctypes bridge to the native TPC-H generator (velox_tpu/native/dbgen.cpp).

Produces bit-identical output to the numpy generator in tpch.py (tests
assert this); used automatically for the hot tables (lineitem, orders) when
a C++ compiler is available.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        from velox_tpu.native.build import load_native
        lib = load_native("dbgen")
    except Exception:
        lib = None
    if lib is not None:
        lib.tpch_lineitem_rows.restype = ctypes.c_int64
        lib.tpch_lineitem_rows.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.tpch_gen_lineitem.restype = None
        lib.tpch_gen_orders.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native generator compiled and loaded (otherwise the
    numpy generator in tpch.py runs)."""
    return _load() is not None


def _ptr(arr: Optional[np.ndarray], ctype):
    if arr is None:
        return ctypes.POINTER(ctype)()
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _nthreads() -> int:
    """Generator threads (0 = hardware concurrency in the native lib).
    Process-flag tier: VELOX_TPU_DBGEN_THREADS (common/flags.py)."""
    from velox_tpu.common.flags import get_flag, reset_flag
    reset_flag("dbgen_threads")  # env may change between calls (tests)
    return int(get_flag("dbgen_threads"))


_LINEITEM_LAYOUT = [
    ("l_orderkey", np.int64), ("l_partkey", np.int64),
    ("l_suppkey", np.int64), ("l_linenumber", np.int32),
    ("l_quantity", np.int64), ("l_extendedprice", np.int64),
    ("l_discount", np.int64), ("l_tax", np.int64),
    ("l_returnflag", np.int32), ("l_linestatus", np.int32),
    ("l_shipdate", np.int32), ("l_commitdate", np.int32),
    ("l_receiptdate", np.int32), ("l_shipinstruct", np.int32),
    ("l_shipmode", np.int32), ("l_comment", np.int32),
]

_ORDERS_LAYOUT = [
    ("o_orderkey", np.int64), ("o_custkey", np.int64),
    ("o_orderstatus", np.int32), ("o_totalprice", np.int64),
    ("o_orderdate", np.int32), ("o_orderpriority", np.int32),
    ("o_clerk", np.int32), ("o_shippriority", np.int32),
    ("o_comment", np.int32),
]


def lineitem_rows(lo: int, hi: int) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    return int(lib.tpch_lineitem_rows(lo, hi))


def gen_lineitem(lo: int, hi: int, columns: Sequence[str], sf: float,
                 n_words_sq: int) -> Optional[Dict[str, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    n = int(lib.tpch_lineitem_rows(lo, hi))
    bufs: Dict[str, Optional[np.ndarray]] = {
        name: (np.empty(n, dt) if name in columns else None)
        for name, dt in _LINEITEM_LAYOUT
    }
    args = [ctypes.c_int64(lo), ctypes.c_int64(hi),
            ctypes.c_int64(int(200000 * sf)),
            ctypes.c_int64(int(10000 * sf))]
    for name, dt in _LINEITEM_LAYOUT:
        ct = ctypes.c_int64 if dt == np.int64 else ctypes.c_int32
        args.append(_ptr(bufs[name], ct))
    args.append(ctypes.c_int64(n_words_sq))
    args.append(ctypes.c_int64(_nthreads()))
    lib.tpch_gen_lineitem(*args)
    return {c: bufs[c] for c in columns}


def gen_orders(lo: int, hi: int, columns: Sequence[str], sf: float,
               n_words_sq: int) -> Optional[Dict[str, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    n = hi - lo
    bufs: Dict[str, Optional[np.ndarray]] = {
        name: (np.empty(n, dt) if name in columns else None)
        for name, dt in _ORDERS_LAYOUT
    }
    ncust = int(150000 * sf)
    allowed = max(1, (ncust * 2) // 3)
    nclerk = max(1, int(10000 * sf) // 10) * 1000
    args = [ctypes.c_int64(lo), ctypes.c_int64(hi),
            ctypes.c_int64(int(200000 * sf)),
            ctypes.c_int64(int(10000 * sf)),
            ctypes.c_int64(allowed), ctypes.c_int64(nclerk)]
    for name, dt in _ORDERS_LAYOUT:
        ct = ctypes.c_int64 if dt == np.int64 else ctypes.c_int32
        args.append(_ptr(bufs[name], ct))
    args.append(ctypes.c_int64(n_words_sq))
    args.append(ctypes.c_int64(_nthreads()))
    lib.tpch_gen_orders(*args)
    out = {c: bufs[c] for c in columns}
    # match numpy generator dtypes (int64 for keys generated as int64)
    return out
