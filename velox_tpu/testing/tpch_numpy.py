"""Plain numpy references for TPC-H Q1, Q3, Q6, Q18 and an orderBy top-1000.

Each reference runs over the generator's own host arrays
(``conn.gen.generate``) and uses no engine code: masks, ``np.unique``
group-bys, ``searchsorted`` joins and sorts. Results are dicts of numpy
columns in the engine's storage form: DECIMAL as scaled int64 at the
output column's scale, DATE as int32 epoch days, VARCHAR as str, integers
as int64. ``columns_of`` brings an engine result (a pyarrow Table) into
the same form, and ``check`` compares the two.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Columns = Dict[str, np.ndarray]


def days(iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01"))
               .astype(int))


class TpchArrays:
    """Whole-table host columns of one TPC-H connector, generated once."""

    def __init__(self, conn):
        self._conn = conn
        self._cols: Dict = {}

    def __call__(self, table: str, name: str) -> np.ndarray:
        key = (table, name)
        if key not in self._cols:
            conn = self._conn
            arr = conn.gen.generate(table, 0, conn.num_index_rows(table),
                                    [name])[name]
            self._cols[key] = np.asarray(arr)
        return self._cols[key]

    def dictionary(self, table: str, name: str):
        return self._conn.gen.dictionaries(table)[name]


def exact_sum(x) -> int:
    """Exact integer sum of an int64 array (no int64 wraparound): the
    high and low 32-bit halves are summed apart."""
    x = np.asarray(x, np.int64)
    return (int((x >> np.int64(32)).sum()) << 32) \
        + int((x & np.int64(0xFFFFFFFF)).sum())


def _group_sums(inv: np.ndarray, x: np.ndarray, n: int) -> np.ndarray:
    """int64 sum of x per group id in [0, n) (every id present)."""
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(n))
    return np.add.reduceat(np.asarray(x, np.int64)[order], starts)


def _half_up_div(s: int, c: int) -> int:
    """Decimal average rounding: half away from zero."""
    q = (abs(s) + c // 2) // c
    return q if s >= 0 else -q


def _join_unique(build_keys: np.ndarray, probe_keys: np.ndarray):
    """(hit mask over probe rows, build row index per probe row) for an
    equi-join on unique build keys."""
    if len(build_keys) == 0:
        return (np.zeros(len(probe_keys), bool),
                np.zeros(len(probe_keys), np.int64))
    order = np.argsort(build_keys, kind="stable")
    sorted_keys = build_keys[order]
    pos = np.minimum(np.searchsorted(sorted_keys, probe_keys),
                     len(sorted_keys) - 1)
    return sorted_keys[pos] == probe_keys, order[pos]


def q6(a: TpchArrays) -> Columns:
    sd = a("lineitem", "l_shipdate")
    disc = a("lineitem", "l_discount")
    qty = a("lineitem", "l_quantity")
    price = a("lineitem", "l_extendedprice")
    m = ((sd >= days("1994-01-01")) & (sd < days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    rev = exact_sum(price[m].astype(np.int64) * disc[m])
    return {"revenue": np.asarray([rev], np.int64)}


def q1(a: TpchArrays) -> Columns:
    m = a("lineitem", "l_shipdate") <= days("1998-09-02")
    rf = a("lineitem", "l_returnflag")[m]
    ls = a("lineitem", "l_linestatus")[m]
    qty = a("lineitem", "l_quantity")[m].astype(np.int64)
    price = a("lineitem", "l_extendedprice")[m].astype(np.int64)
    disc = a("lineitem", "l_discount")[m].astype(np.int64)
    tax = a("lineitem", "l_tax")[m].astype(np.int64)
    rf_dict = a.dictionary("lineitem", "l_returnflag")
    ls_dict = a.dictionary("lineitem", "l_linestatus")
    disc_price = price * (100 - disc)           # scale 4
    charge = disc_price * (100 + tax)           # scale 6
    rows = []
    for r in range(len(rf_dict)):
        for s in range(len(ls_dict)):
            g = (rf == r) & (ls == s)
            c = int(g.sum())
            if not c:
                continue
            sq, sp = exact_sum(qty[g]), exact_sum(price[g])
            rows.append((str(rf_dict.take(np.asarray([r]))[0]),
                         str(ls_dict.take(np.asarray([s]))[0]),
                         sq, sp, exact_sum(disc_price[g]),
                         exact_sum(charge[g]), _half_up_div(sq, c),
                         _half_up_div(sp, c),
                         _half_up_div(exact_sum(disc[g]), c), c))
    rows.sort(key=lambda t: (t[0], t[1]))
    names = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
             "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
             "avg_disc", "count_order"]
    out = {}
    for i, n in enumerate(names):
        vals = [t[i] for t in rows]
        out[n] = np.asarray(vals, object if i < 2 else np.int64)
    return out


def q3(a: TpchArrays) -> Columns:
    seg_dict = a.dictionary("customer", "c_mktsegment")
    building = seg_dict.id_of("BUILDING")
    cust = a("customer", "c_custkey")[
        a("customer", "c_mktsegment") == building]
    od = a("orders", "o_orderdate")
    om = od < days("1995-03-15")
    ocust = a("orders", "o_custkey")[om]
    in_seg, _ = _join_unique(cust, ocust)
    okey = a("orders", "o_orderkey")[om][in_seg]
    odate = od[om][in_seg]
    oprio = a("orders", "o_shippriority")[om][in_seg]
    lm = a("lineitem", "l_shipdate") > days("1995-03-15")
    lkey = a("lineitem", "l_orderkey")[lm]
    hit, oidx = _join_unique(okey, lkey)
    lkey, oidx = lkey[hit], oidx[hit]
    rev_rows = (a("lineitem", "l_extendedprice")[lm][hit].astype(np.int64)
                * (100 - a("lineitem", "l_discount")[lm][hit]))
    keys, first, inv = np.unique(lkey, return_index=True,
                                 return_inverse=True)
    rev = _group_sums(inv, rev_rows, len(keys))
    gdate = odate[oidx[first]]
    gprio = oprio[oidx[first]]
    top = np.lexsort((gdate, -rev))[:10]
    return {"l_orderkey": keys[top].astype(np.int64), "revenue": rev[top],
            "o_orderdate": gdate[top].astype(np.int32),
            "o_shippriority": gprio[top].astype(np.int64)}


def q18(a: TpchArrays, threshold: float = 300.0) -> Columns:
    lkey = a("lineitem", "l_orderkey")
    keys, inv = np.unique(lkey, return_inverse=True)
    qsum = _group_sums(inv, a("lineitem", "l_quantity"), len(keys))
    big = qsum > int(round(threshold * 100))
    big_keys, big_qty = keys[big], qsum[big]
    okey = a("orders", "o_orderkey")
    hit, bidx = _join_unique(big_keys, okey)
    ocust = a("orders", "o_custkey")[hit]
    price = a("orders", "o_totalprice")[hit].astype(np.int64)
    odate = a("orders", "o_orderdate")[hit]
    qty = big_qty[bidx[hit]]
    okey = okey[hit]
    ckeys = a("customer", "c_custkey")
    chit, cidx = _join_unique(ckeys, ocust)
    top = np.lexsort((odate[chit], -price[chit]))[:100]
    sel = np.flatnonzero(chit)[top]
    name_ids = a("customer", "c_name")[cidx[sel]]
    names = a.dictionary("customer", "c_name").take(name_ids)
    return {"c_name": np.asarray([str(s) for s in names], object),
            "c_custkey": ocust[sel].astype(np.int64),
            "o_orderkey": okey[sel].astype(np.int64),
            "o_orderdate": odate[sel].astype(np.int32),
            "o_totalprice": price[sel],
            "quantity": qty[sel].astype(np.int64)}


def orderby(a: TpchArrays, limit: int = 1000) -> Columns:
    """ORDER BY l_shipdate, l_orderkey LIMIT ``limit``."""
    sd = a("lineitem", "l_shipdate").astype(np.int64)
    ok = a("lineitem", "l_orderkey").astype(np.int64)
    top = np.lexsort((ok, sd))[:limit]
    return {"l_shipdate": sd[top].astype(np.int32),
            "l_orderkey": ok[top]}


def columns_of(table) -> Columns:
    """pyarrow Table -> columns in the references' storage form."""
    import pyarrow as pa
    out = {}
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if pa.types.is_decimal(t):
            out[name] = np.asarray(
                [int(v.scaleb(t.scale)) for v in col.to_pylist()],
                np.int64)
        elif pa.types.is_date32(t):
            out[name] = col.cast(pa.int32()).to_numpy().astype(np.int32)
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            out[name] = np.asarray(col.to_pylist(), object)
        elif pa.types.is_integer(t):
            out[name] = col.to_numpy().astype(np.int64)
        else:
            out[name] = col.to_numpy()
    return out


def check(query: str, got: Columns, exp: Columns) -> None:
    """Raise AssertionError unless ``got`` equals ``exp`` column by column.

    Integer, decimal, date and string columns must match exactly. A
    floating column matches to a relative 1e-12: the GPU takes sums in
    another order than numpy does. No matrix product lies on the engine's
    path (nothing under velox_tpu/ calls dot or matmul), so TF32 rounding
    is not in play. None of the five queries here outputs a floating
    column.
    """
    if list(got) != list(exp):
        raise AssertionError(f"{query}: columns {list(got)} != {list(exp)}")
    for name in exp:
        g, e = np.asarray(got[name]), np.asarray(exp[name])
        if g.shape != e.shape:
            raise AssertionError(
                f"{query}.{name}: {g.shape[0]} rows, expected {e.shape[0]}")
        if e.dtype.kind == "f":
            np.testing.assert_allclose(g, e, rtol=1e-12,
                                       err_msg=f"{query}.{name}")
        elif not np.array_equal(g, e):
            bad = int(np.flatnonzero(g != e)[0])
            raise AssertionError(
                f"{query}.{name}: row {bad} is {g[bad]!r}, "
                f"expected {e[bad]!r}")
