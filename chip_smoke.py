"""Smoke run of the engine's main path on NVIDIA GPUs.

    python chip_smoke.py [--sf 10]          # one card
    python chip_smoke.py --four-cards       # DistributedTask over 4 cards

One card: TPC-H data from the dbgen connector at ``--sf`` (SF10 = 60 M
lineitem rows) runs through ``Task.run`` for Q1, Q3, Q6, Q18 and an
orderBy top-1000, each cold then warm, and every answer is checked
against a plain numpy reference over the same generated host arrays
(velox_tpu/testing/tpch_numpy.py). ``--four-cards`` runs Q1, Q3 and Q18
through ``DistributedTask`` over a four-device mesh instead, against the
same references, and nothing else.

The walls printed are a smoke readout beside the card's name and power
limit, not a benchmark. The last line of stdout is one JSON object,
``{"ok": true, "device": {...}}``; any mismatch or exception exits
non-zero before it is printed. Off the GPU the script exits non-zero
naming the platform it found.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def device_phase(n_cards: int):
    """The devices to run on; exits unless JAX's platform is the GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU, but JAX's platform is "
                 f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}; "
          f"bytes_limit {devs[0].memory_stats()['bytes_limit']}")
    return devs[:n_cards]


def orderby_plan(connector_id: str):
    from velox_tpu.testing.plan_builder import PlanBuilder
    return (PlanBuilder()
            .table_scan("lineitem", ["l_shipdate", "l_orderkey"],
                        connector_id=connector_id)
            .order_by(["l_shipdate", "l_orderkey"])
            .limit(1000)
            .plan())


def _plans():
    from velox_tpu.testing import tpch_numpy as R
    from velox_tpu.tpch import tpch_plan

    def q(n):
        return lambda cid: tpch_plan(n, connector_id=cid)
    # name -> (plan builder over a connector id, numpy reference)
    return {"q1": (q(1), R.q1), "q3": (q(3), R.q3), "q6": (q(6), R.q6),
            "q18": (q(18), R.q18), "orderby": (orderby_plan, R.orderby)}


def main_phase(sf: float, names=("q1", "q3", "q6", "q18", "orderby"),
               connector_id: str = "tpch-smoke"):
    """Run each query cold then warm through Task.run and check it against
    its numpy reference. Returns one record per query."""
    import jax

    from velox_tpu.common import metrics as M
    from velox_tpu.connectors import tpch_native
    from velox_tpu.connectors.tpch import register_tpch
    from velox_tpu.exec.jit_cache import program_count
    from velox_tpu.exec.task import Task
    from velox_tpu.testing import tpch_numpy as R

    conn = register_tpch(sf, connector_id=connector_id)
    arrays = R.TpchArrays(conn)
    plans = _plans()
    native = tpch_native.available()
    records = []
    for name in names:
        build, ref = plans[name]
        programs0 = program_count()
        sorts0 = M.reporter().snapshot()["counters"].get(
            M.K_SORT_PROGRAMS, 0)
        t0 = time.perf_counter()
        Task(build(connector_id)).run()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = Task(build(connector_id)).run()
        warm = time.perf_counter() - t0
        R.check(name, R.columns_of(out), ref(arrays))
        stats = jax.devices()[0].memory_stats() or {}
        rec = {"query": name, "sf": sf, "rows": out.num_rows,
               "cold_s": cold, "warm_s": warm,
               "programs_compiled": program_count() - programs0,
               "lax_sort_programs": M.reporter().snapshot()["counters"]
               .get(M.K_SORT_PROGRAMS, 0) - sorts0,
               "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
               "native_dbgen": native, "matches_numpy": True}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def four_card_phase(sf: float, devices,
                    connector_id: str = "tpch-smoke-4"):
    """Q1, Q3 and Q18 through DistributedTask over a one-axis mesh of the
    given devices, each checked against its numpy reference."""
    from velox_tpu.connectors.tpch import register_tpch
    from velox_tpu.parallel import DistributedTask, make_mesh
    from velox_tpu.testing import tpch_numpy as R

    conn = register_tpch(sf, connector_id=connector_id)
    arrays = R.TpchArrays(conn)
    plans = _plans()
    mesh = make_mesh(len(devices))
    records = []
    for name in ("q1", "q3", "q18"):
        build, ref = plans[name]
        t0 = time.perf_counter()
        DistributedTask(build(connector_id), mesh).run()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = DistributedTask(build(connector_id), mesh).run()
        warm = time.perf_counter() - t0
        R.check(name, R.columns_of(out), ref(arrays))
        rec = {"query": name, "sf": sf, "cards": len(devices),
               "rows": out.num_rows, "cold_s": cold, "warm_s": warm,
               "peak_bytes_in_use": [
                   (d.memory_stats() or {}).get("peak_bytes_in_use")
                   for d in devices],
               "matches_numpy": True}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run Q1/Q3/Q18 through DistributedTask on 4 GPUs "
                         "and no other phase")
    args = ap.parse_args(argv)
    devices = device_phase(4 if args.four_cards else 1)
    if args.four_cards:
        four_card_phase(args.sf, devices)
    else:
        main_phase(args.sf)
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
