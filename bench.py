"""Benchmark: TPC-H Q1/Q3/Q6/Q18 + orderBy through the engine on one
NVIDIA GPU, vs a pandas/numpy CPU baseline over identical data.

    python bench.py

Prints the device (platform, device_kind, count) and the card's name and
power limit, then one detail JSON line, then ONE summary JSON line
{"metric", "value", "unit", "vs_baseline"} last. Off the GPU it exits
non-zero: a CPU number is never reported as a device number.

Configs: Q6 scan+filter+sum, Q1 hash aggregate, orderBy sort, Q3
join+aggregate, Q18 skewed join at SF1; then Q1/Q3/Q18 at SF10 under a
capped query pool; then the per-operator micro suite (benchmarks.py).

Timing: each query runs twice; the reported wall is the SECOND run —
device-cached scans (connectors/cache.py), compiled programs warm.
``Task.run`` returns host data, so each wall ends after the device work.

vs_baseline: pandas/numpy (vectorized C) computing the identical query
over the identical host arrays, re-measured on whatever host runs the
bench.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import pandas as pd

from benchmarks import gpu_device, run_micro


def days(iso):
    return (np.datetime64(iso) - np.datetime64("1970-01-01")).astype(int)


# columns the pandas baselines actually read: generating full schemas
# (16 lineitem cols incl. 6M comment strings) cost minutes of host CPU
# before the first engine run
COLS_NEEDED = {
    "lineitem": ["l_orderkey", "l_quantity", "l_extendedprice",
                 "l_discount", "l_tax", "l_shipdate", "l_returnflag",
                 "l_linestatus"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate",
               "o_shippriority", "o_totalprice"],
    "customer": ["c_custkey", "c_mktsegment"],
}


def host_frame(conn, table):
    """Columnar dict -> DataFrame without block consolidation (pandas
    vstack-consolidates same-dtype columns; measured minutes at SF1 on
    one core). pyarrow's to_pandas with split_blocks skips it."""
    import pyarrow as pa
    d = conn.gen.generate(table, 0, conn.num_index_rows(table),
                          COLS_NEEDED[table])
    return pa.table(d).to_pandas(split_blocks=True, self_destruct=True)


def engine_wall(plan_fn):
    """(cold_s, warm_s, result_table) for a fresh Task."""
    from velox_tpu.exec.task import Task
    t0 = time.perf_counter()
    Task(plan_fn()).run()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = Task(plan_fn()).run()
    warm = time.perf_counter() - t0
    return cold, warm, out


def cpu_wall(fn, iters=3):
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn()
    return (time.perf_counter() - t0) / iters, r


def make_cpu_fns(li, od, cu):
    """pandas baselines over host frames (shared by SF1 and SF10)."""
    d94, d95 = days("1994-01-01"), days("1995-01-01")
    d0315 = days("1995-03-15")
    d0902 = days("1998-09-02")

    def cpu_q6():
        m = ((li.l_shipdate >= d94) & (li.l_shipdate < d95)
             & (li.l_discount >= 5) & (li.l_discount <= 7)
             & (li.l_quantity < 2400))
        return (li.l_extendedprice[m].to_numpy("int64")
                * li.l_discount[m].to_numpy("int64")).sum()

    def cpu_q1():
        m = li.l_shipdate <= d0902
        d = li[m]
        disc = d.l_extendedprice * (100 - d.l_discount)
        g = pd.DataFrame({
            "rf": d.l_returnflag, "ls": d.l_linestatus,
            "q": d.l_quantity, "p": d.l_extendedprice,
            "dp": disc, "ch": disc * (100 + d.l_tax), "di": d.l_discount,
        }).groupby(["rf", "ls"], sort=True)
        return g.agg(q=("q", "sum"), p=("p", "sum"), dp=("dp", "sum"),
                     ch=("ch", "sum"), di=("di", "mean"), n=("q", "size"))

    def cpu_q3():
        c = cu[cu.c_mktsegment == cu.c_mktsegment.mode()[0]][["c_custkey"]]
        o = od[od.o_orderdate < d0315]
        l2 = li[li.l_shipdate > d0315]
        j = l2.merge(o, left_on="l_orderkey", right_on="o_orderkey") \
            .merge(c, left_on="o_custkey", right_on="c_custkey")
        j = j.assign(rev=j.l_extendedprice * (100 - j.l_discount))
        g = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                      as_index=False).rev.sum()
        return g.nlargest(10, "rev")

    def cpu_q18():
        s = li.groupby("l_orderkey").l_quantity.sum()
        big = s[s > 30000]
        j = od[od.o_orderkey.isin(big.index)] \
            .merge(cu, left_on="o_custkey", right_on="c_custkey")
        j = j.assign(quantity=big.loc[j.o_orderkey].to_numpy())
        return j.nlargest(100, "o_totalprice")

    def cpu_orderby():
        keys = np.lexsort((li.l_orderkey.to_numpy(),
                           li.l_shipdate.to_numpy()))
        return keys[:1000]

    return {"q6": cpu_q6, "q1": cpu_q1, "q3": cpu_q3, "q18": cpu_q18,
            "orderby": cpu_orderby}


def _run_sf10():
    """Q1/Q3/Q18 at SF10 (60M lineitem rows) with a capped query pool:
    arbitration + host offload run inside the measurement, plus the
    per-query program count, peak device memory, and offload/spill
    counters. Program shapes match SF1 (same per-split
    capacity), so the warm run reuses every compiled program. Baselines
    are single-iteration pandas over the identical SF10 data."""
    from velox_tpu.common import metrics as M
    from velox_tpu.connectors.tpch import register_tpch
    from velox_tpu.core.config import QueryConfig as QC
    from velox_tpu.exec.jit_cache import program_count
    from velox_tpu.exec.memory import MemoryPool
    from velox_tpu.exec.task import QueryCtx, Task
    from velox_tpu.tpch import tpch_plan

    cid = "tpch-sf10"
    conn = register_tpch(10.0, rows_per_split=1 << 21, connector_id=cid)
    li_rows = conn.gen.num_rows("lineitem")
    out = {"lineitem_rows": li_rows}
    host = {t: host_frame(conn, t) for t in COLS_NEEDED}
    fns = make_cpu_fns(host["lineitem"], host["orders"],
                       host["customer"])
    for q in (1, 3, 18):
        ctx = QueryCtx({QC.QUERY_HBM_CAP_BYTES: 8 << 30})
        p0 = program_count()
        t0 = time.perf_counter()
        Task(tpch_plan(q, connector_id=cid), ctx).run()
        first = time.perf_counter() - t0
        ctx2 = QueryCtx({QC.QUERY_HBM_CAP_BYTES: 8 << 30})
        t0 = time.perf_counter()
        res = Task(tpch_plan(q, connector_id=cid), ctx2).run()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        fns[f"q{q}"]()
        cpu_dt = time.perf_counter() - t0
        entry = {
            "first_s": first,
            "warm_s": warm,
            "cpu_baseline_s": cpu_dt,
            "vs_baseline": cpu_dt / warm,
            "lineitem_rows_per_s_warm": li_rows / warm,
            "out_rows": res.num_rows,
            "programs_new": program_count() - p0,
            "peak_query_hbm_bytes": ctx2.memory_pool.peak,
            "device_root_peak_bytes": MemoryPool.device_root().peak,
        }
        snap = M.reporter().snapshot().get("counters", {})
        for k in (M.K_AGG_HOST_OFFLOADS, M.K_JOIN_BUILD_OFFLOADS,
                  M.K_SPILL_DISK_WRITES):
            if k in snap:
                entry[k.rsplit(".", 1)[-1]] = snap[k]
        out[f"q{q}_sf10"] = entry
    return out


def main():
    print(json.dumps({"device": gpu_device()}), flush=True)

    from velox_tpu.connectors.tpch import register_tpch
    from velox_tpu.testing.plan_builder import PlanBuilder
    from velox_tpu.tpch import tpch_plan

    sf = 1.0
    conn = register_tpch(sf, rows_per_split=1 << 21)
    li_rows = conn.gen.num_rows("lineitem")

    # host tables for the CPU baseline (shared, generated once; only the
    # columns the baselines read)
    host = {t: host_frame(conn, t) for t in COLS_NEEDED}
    fns = make_cpu_fns(host["lineitem"], host["orders"], host["customer"])

    def orderby_plan():
        return (PlanBuilder()
                .table_scan("lineitem", ["l_shipdate", "l_orderkey"],
                            connector_id="tpch")
                .order_by(["l_shipdate", "l_orderkey"])
                .limit(1000)
                .plan())

    configs = [
        ("q6_sf1", lambda: tpch_plan(6), fns["q6"]),
        ("q1_sf1", lambda: tpch_plan(1), fns["q1"]),
        ("orderby_sf1", orderby_plan, fns["orderby"]),
        ("q18_sf1", lambda: tpch_plan(18), fns["q18"]),
        ("q3_sf1", lambda: tpch_plan(3), fns["q3"]),
    ]

    detail = {}
    ratios, rates = [], []
    for name, plan_fn, cpu_fn in configs:
        cold, warm, out = engine_wall(plan_fn)
        cpu_dt, _ = cpu_wall(cpu_fn)
        detail[name] = {
            "engine_cold_s": cold,
            "engine_warm_s": warm,
            "cpu_baseline_s": cpu_dt,
            "lineitem_rows_per_s_warm": li_rows / warm,
            "vs_baseline": cpu_dt / warm,
            "out_rows": out.num_rows,
        }
        ratios.append(cpu_dt / warm)
        rates.append(li_rows / warm)

    # SF10: 10x the rows under a CAPPED query pool so arbitration/offload
    # runs inside the benchmark
    detail["sf10"] = _run_sf10()
    detail["micro_Mrows_per_s"] = run_micro(20)
    print(json.dumps(detail), flush=True)
    print(json.dumps({
        "metric": "tpch_sf1_geomean_lineitem_rows_per_s_warm",
        "value": float(np.exp(np.mean(np.log(rates)))),
        "unit": "rows/s",
        "vs_baseline": float(np.exp(np.mean(np.log(ratios)))),
    }), flush=True)


if __name__ == "__main__":
    main()
