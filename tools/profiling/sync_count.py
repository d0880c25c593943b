"""Count device_get syncs per warm TPC-H query, attributed to call sites.

    python tools/profiling/sync_count.py
"""
import collections
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import jax

jax.config.update("jax_enable_x64", True)

_orig = jax.device_get
SITES = collections.Counter()
ENABLED = [False]


def patched(x):
    if ENABLED[0]:
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "/velox_tpu/" in fr.filename:
                SITES[f"{fr.filename.split('/')[-1]}:{fr.lineno}"] += 1
                break
    return _orig(x)


jax.device_get = patched

from velox_tpu.connectors.tpch import register_tpch  # noqa: E402
from velox_tpu.exec.task import Task  # noqa: E402
from velox_tpu.tpch import tpch_plan  # noqa: E402

register_tpch(1.0, rows_per_split=1 << 21)

for q in (3, 18):
    Task(tpch_plan(q)).run()  # warm programs + scan cache
    Task(tpch_plan(q)).run()
    SITES.clear()
    ENABLED[0] = True
    t = Task(tpch_plan(q))
    t0 = time.perf_counter()
    out = t.run()
    wall = time.perf_counter() - t0
    ENABLED[0] = False
    print(f"Q{q}: warm {wall:.3f}s rows={out.num_rows} "
          f"syncs={sum(SITES.values())}", flush=True)
    for site, n in SITES.most_common(12):
        print(f"  {site}: {n}")
    print(t.print_plan_with_stats())
