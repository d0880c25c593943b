"""Tests that need an NVIDIA GPU. On the card:

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py

Elsewhere every test here skips (the ``gpu`` fixture decides). All 22
TPC-H queries run on the card against the SQLite oracle of
tests/test_tpch_queries.py, or, for Q1/Q3/Q6/Q18, against the numpy
references that tests/test_chip_smoke.py checks against SQLite. The two
replacements of hand-written kernels are checked at real sizes: the Q6
fused reduction against the generic superstep, and a 6-lane lax.sort
against np.lexsort.
"""

import numpy as np
import pandas as pd
import pytest

pytestmark = pytest.mark.chip

SF = 0.01


@pytest.fixture(scope="module")
def gpu():
    import jax
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {platform!r}); "
                    "run JAX_PLATFORMS=cuda pytest -m chip "
                    "tests/test_chip.py on the card")
    return jax.devices()[0]


@pytest.fixture(scope="module")
def conn(gpu):
    from velox_tpu.connectors.tpch import register_tpch
    return register_tpch(SF, connector_id="tpch-chip")


@pytest.fixture(scope="module")
def oracle(conn):
    from velox_tpu.connectors.tpch import TPCH_SCHEMAS
    from velox_tpu.testing.oracle import SqliteOracle
    o = SqliteOracle()
    for t in TPCH_SCHEMAS:
        cols = list(TPCH_SCHEMAS[t].names)
        df = pd.DataFrame(conn.gen.generate(t, 0, conn.num_index_rows(t),
                                            cols))
        for c, d in conn.gen.dictionaries(t).items():
            if c in df:
                df[c] = np.asarray(d.take(df[c].to_numpy()))
        o.load(t, df)
    return o


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_query_on_gpu(q, conn, oracle):
    from tpch_sql import ORACLE_SQL, TOLERANCES, normalize_dates
    from velox_tpu.exec.task import Task
    from velox_tpu.testing import tpch_numpy as R
    from velox_tpu.testing.oracle import assert_frames_match
    from velox_tpu.tpch import tpch_plan
    cid = "tpch-chip"
    if q in ORACLE_SQL:
        rel_tol, min_rows = TOLERANCES.get(q, (1e-9, 1))
        got = normalize_dates(
            Task(tpch_plan(q, connector_id=cid)).run().to_pandas())
        exp = oracle.query(ORACLE_SQL[q])
        assert len(exp) >= min_rows
        assert_frames_match(got, exp, sort=True, rel_tol=rel_tol)
        return
    # Q18's spec threshold matches no order at SF0.01
    params = {"threshold": 150.0} if q == 18 else {}
    arrays = R.TpchArrays(conn)
    exp = getattr(R, f"q{q}")(arrays, **params)
    got = Task(tpch_plan(q, connector_id=cid, **params)).run()
    R.check(f"q{q}", R.columns_of(got), exp)


def test_q6_fused_reduction_matches_generic_superstep(gpu, monkeypatch):
    """ops/filter_reduce.py's plain reduction replaced a hand-written
    kernel: at SF1 its answer equals the generic fused superstep's and
    numpy's."""
    from velox_tpu.connectors.tpch import register_tpch
    from velox_tpu.exec.task import Task
    from velox_tpu.testing import tpch_numpy as R
    from velox_tpu.tpch import tpch_plan
    conn = register_tpch(1.0, connector_id="tpch-chip-sf1")
    fused = R.columns_of(Task(tpch_plan(6, connector_id="tpch-chip-sf1"))
                         .run())
    monkeypatch.setattr(Task, "_try_filter_sum", lambda self, *a: None)
    generic = R.columns_of(
        Task(tpch_plan(6, connector_id="tpch-chip-sf1")).run())
    exp = R.q6(R.TpchArrays(conn))
    R.check("q6 fused", fused, exp)
    R.check("q6 generic", generic, exp)


def test_six_lane_sort_matches_lexsort(gpu):
    """The radix fallback is gone: keys wider than four u64 lanes sort in
    one lax.sort. 2 M rows, 6 lanes, stable, against np.lexsort."""
    import jax
    import jax.numpy as jnp

    from velox_tpu.exec import sort as S
    n = 2 << 20
    rng = np.random.default_rng(0)
    words_np = [rng.integers(0, 4, n).astype(np.uint32) for _ in range(11)]
    words_np.append(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                    .astype(np.uint32))
    bits = [32] * 12
    perm, lanes = jax.jit(lambda ws: S.sort_perm_key(ws, bits, n))(
        [jnp.asarray(w) for w in words_np])
    assert len(lanes) == 6
    np.testing.assert_array_equal(
        np.asarray(perm), np.lexsort(tuple(reversed(words_np))))
