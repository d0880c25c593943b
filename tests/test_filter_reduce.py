"""Fused filter-sum-product reduction (ops/filter_reduce.py): the jitted
reduction, the plan matcher, and Q6 through Task against numpy."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from velox_tpu.ops import filter_reduce as FR


@pytest.mark.parametrize("n", [1000, 131072, 200_000])
def test_filtered_sum_product_interpret(n):
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    price = rng.randint(0, 5_0000_0000, n).astype(np.int32)
    disc = rng.randint(0, 11, n).astype(np.int32)
    date = rng.randint(8000, 10000, n).astype(np.int32)
    qty = rng.randint(0, 5000, n).astype(np.int32)
    n_active = n - 17 if n > 100 else n
    ranges = ((2, 8700, 9064), (1, 5, 7), (3, 0, 2399))
    got = int(FR.filtered_sum_product(
        [jnp.asarray(price), jnp.asarray(disc), jnp.asarray(date),
         jnp.asarray(qty)],
        ranges, 0, 1, jnp.int32(n_active)))
    m = ((date >= 8700) & (date <= 9064) & (disc >= 5) & (disc <= 7)
         & (qty <= 2399))
    m[n_active:] = False
    exp = int((price.astype(np.int64) * disc * m).sum())
    assert got == exp


def test_match_filter_sum_q6_shape():
    """The matcher recognizes the Q6 chain + aggregation."""
    from velox_tpu.connectors.tpch import register_tpch
    from velox_tpu.core import plan as P
    from velox_tpu.exec.fuse import collapse_chain
    from velox_tpu.tpch import tpch_plan
    register_tpch(0.01)
    plan = tpch_plan(6)
    # walk to the aggregation node
    node = plan
    while not isinstance(node, P.AggregationNode):
        node = node.source
    chain = collapse_chain(node.source)
    # both factors need stats: they bound each row's product
    assert FR.match_filter_sum(node, chain, {"l_discount": (0, 10)}) is None
    stats = {"l_discount": (0, 10), "l_extendedprice": (90000, 10_495_000)}
    spec = FR.match_filter_sum(node, chain, stats)
    assert spec is not None
    assert spec.b_col == "l_discount"
    assert spec.a_col == "l_extendedprice"
    assert spec.max_abs_product == 104_950_000
    assert len(spec.ranges) == 3


@pytest.mark.parametrize("rows_per_split", [4096, 20_000, 65536])
def test_q6_exact_across_split_sizes(rows_per_split):
    """Q6 through Task takes the fused reduction and matches numpy exactly
    whatever the split size: padded tail batches and int128 accumulation
    across batches."""
    from velox_tpu.common import metrics as M
    from velox_tpu.connectors.tpch import register_tpch
    from velox_tpu.exec.task import Task
    from velox_tpu.testing import tpch_numpy as R
    from velox_tpu.tpch import tpch_plan
    cid = f"tpch-q6-{rows_per_split}"
    conn = register_tpch(0.01, connector_id=cid,
                         rows_per_split=rows_per_split)
    before = M.reporter().snapshot()["counters"].get(
        M.K_FILTER_SUM_KERNEL, 0)
    out = Task(tpch_plan(6, connector_id=cid)).run()
    assert M.reporter().snapshot()["counters"][M.K_FILTER_SUM_KERNEL] \
        == before + 1
    assert len(conn.default_splits("lineitem")) > 1
    exp = R.q6(R.TpchArrays(conn))
    got = {"revenue": np.asarray(
        [int(v.scaleb(4)) for v in out.column("revenue").to_pylist()])}
    R.check("q6", got, exp)
