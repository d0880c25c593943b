"""chip_smoke.py and its numpy references, on the CPU.

The references (velox_tpu/testing/tpch_numpy.py) are checked against
SQLite over the same generated tables; the smoke's main phase is driven
at SF0.01; the script itself must refuse the CPU; and the compile cache
lands where velox_tpu/__init__.py says.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import chip_smoke
from velox_tpu.connectors.tpch import TPCH_SCHEMAS, register_tpch
from velox_tpu.testing import tpch_numpy as R
from velox_tpu.testing.oracle import SqliteOracle

SF = 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = R.days

# SQLite over scaled ints and epoch days, in the references' column order
SQL = {
    "q6": ("SELECT SUM(l_extendedprice * l_discount) AS revenue"
           " FROM lineitem"
           f" WHERE l_shipdate >= {D('1994-01-01')}"
           f" AND l_shipdate < {D('1995-01-01')}"
           " AND l_discount BETWEEN 5 AND 7 AND l_quantity < 2400"),
    "q1": ("SELECT l_returnflag, l_linestatus, SUM(l_quantity),"
           " SUM(l_extendedprice),"
           " SUM(l_extendedprice * (100 - l_discount)),"
           " SUM(l_extendedprice * (100 - l_discount) * (100 + l_tax)),"
           " SUM(l_quantity), SUM(l_extendedprice), SUM(l_discount),"
           " COUNT(*)"
           " FROM lineitem"
           f" WHERE l_shipdate <= {D('1998-09-02')}"
           " GROUP BY 1, 2 ORDER BY 1, 2"),
    "q3": ("SELECT l_orderkey,"
           " SUM(l_extendedprice * (100 - l_discount)) AS revenue,"
           " o_orderdate, o_shippriority"
           " FROM customer, orders, lineitem"
           " WHERE c_mktsegment = 'BUILDING'"
           " AND c_custkey = o_custkey AND l_orderkey = o_orderkey"
           f" AND o_orderdate < {D('1995-03-15')}"
           f" AND l_shipdate > {D('1995-03-15')}"
           " GROUP BY l_orderkey, o_orderdate, o_shippriority"
           " ORDER BY revenue DESC, o_orderdate LIMIT 10"),
    # spec threshold 300 matches no order at SF0.01: 150 on both sides
    "q18": ("SELECT c_name, c_custkey, o_orderkey, o_orderdate,"
            " o_totalprice, SUM(l_quantity) AS quantity"
            " FROM customer, orders, lineitem"
            " WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem"
            "   GROUP BY l_orderkey HAVING SUM(l_quantity) > 15000)"
            " AND c_custkey = o_custkey AND o_orderkey = l_orderkey"
            " GROUP BY c_name, c_custkey, o_orderkey, o_orderdate,"
            " o_totalprice"
            " ORDER BY o_totalprice DESC, o_orderdate LIMIT 100"),
    "orderby": ("SELECT l_shipdate, l_orderkey FROM lineitem"
                " ORDER BY l_shipdate, l_orderkey LIMIT 1000"),
}


@pytest.fixture(scope="module")
def conn():
    return register_tpch(SF)


@pytest.fixture(scope="module")
def oracle(conn):
    o = SqliteOracle()
    for t in ("lineitem", "orders", "customer"):
        cols = list(TPCH_SCHEMAS[t].names)
        df = pd.DataFrame(conn.gen.generate(t, 0, conn.num_index_rows(t),
                                            cols))
        for c, d in conn.gen.dictionaries(t).items():
            if c in df:
                df[c] = np.asarray(d.take(df[c].to_numpy()))
        o.load(t, df)
    return o


def _half_up(s, c):
    return [(abs(a) + b // 2) // b * (1 if a >= 0 else -1)
            for a, b in zip(s, c)]


@pytest.mark.parametrize("query", sorted(SQL))
def test_numpy_reference_matches_sqlite(query, conn, oracle):
    arrays = R.TpchArrays(conn)
    exp = (R.q18(arrays, threshold=150.0) if query == "q18"
           else getattr(R, query)(arrays))
    rows = oracle.query(SQL[query]).itertuples(index=False)
    cols = [list(c) for c in zip(*rows)] or [[] for _ in exp]
    if query == "q1":
        # averages: half-up decimal division of the exact sums
        count = cols[9]
        cols[6:9] = [_half_up(cols[i], count) for i in (6, 7, 8)]
    assert len(cols) == len(exp)
    assert len(cols[0]) > 0
    for (name, e), g in zip(exp.items(), cols):
        assert [x if isinstance(x, str) else int(x) for x in g] \
            == [x if isinstance(x, str) else int(x) for x in e], name


@pytest.mark.parametrize("query", ["q1", "q3", "q6", "q18", "orderby"])
def test_main_phase_on_cpu(query):
    (rec,) = chip_smoke.main_phase(SF, (query,))
    assert rec["query"] == query and rec["matches_numpy"]
    assert rec["native_dbgen"] in (True, False)
    assert rec["cold_s"] > 0 and rec["warm_s"] > 0


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--sf", "0.01"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "'cpu'" in r.stderr
    assert '"ok"' not in r.stdout


_CACHE_PROBE = r"""
import jax, velox_tpu
from velox_tpu.exec.task import Task
from velox_tpu.testing.plan_builder import PlanBuilder
import pyarrow as pa
Task(PlanBuilder().values([pa.table({"x": [1, 2, 3]})])
     .single_aggregation([], ["sum(x) as s"]).plan()).run()
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(env_dir, tmp_path, monkeypatch):
    import velox_tpu
    checkout_cache = os.path.join(REPO, ".jax_cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        # the variable wins on every platform: nothing set in code
        assert velox_tpu.compile_cache_dir("gpu") is None
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert velox_tpu.compile_cache_dir("gpu") == checkout_cache
        assert velox_tpu.compile_cache_dir("cpu") is None
    r = subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    used = r.stdout.strip().splitlines()[-1]
    if env_dir:
        assert used == str(tmp_path)
        assert os.listdir(tmp_path), "no cache entry written"
    else:
        assert used == "None"  # CPU without the variable: cache off
