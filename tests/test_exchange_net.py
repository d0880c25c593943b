"""Two-process exchange: a producer Task in a CHILD OS process serves
its OutputBuffer over TCP; the parent's Exchange operator pulls pages
through SocketExchangeSource. Proves the page protocol (sequence/ack/
credit/at_end) crosses a real host boundary — the reference's
Prestissimo-HTTP shape behind the same SPI (exec/ExchangeSource.h:137,
exec/tests/MultiFragmentTest.cpp wires the in-process analogue)."""

import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from velox_tpu import types as T
from velox_tpu.core import plan as P
from velox_tpu.exec.task import QueryCtx, Task

PRODUCER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np, pandas as pd, pyarrow as pa
from velox_tpu import types as T
from velox_tpu.core import plan as P, expressions as ex
from velox_tpu.exec.task import Task, QueryCtx
from velox_tpu.exec.exchange_net import serve_exchange
from velox_tpu.testing.plan_builder import PlanBuilder

df = pd.DataFrame({"g": np.arange(300, dtype="int64") % 7,
                   "v": np.arange(300, dtype="int64")})
src = PlanBuilder().values([pa.table(df)]).plan()
pout = P.PartitionedOutputNode(
    "p0", source=src, kind="partitioned",
    keys=(ex.field("g", T.BIGINT),), num_partitions=2)
Task(pout, QueryCtx({"task.id": "nettask"})).run()
host, port = serve_exchange()
print(f"{host}:{port}", flush=True)
sys.stdin.readline()  # parent closes stdin when done
"""


def test_two_process_socket_exchange():
    from velox_tpu.exec import exchange as X
    from velox_tpu.exec.exchange_net import SocketExchangeSource

    proc = subprocess.Popen(
        [sys.executable, "-c", PRODUCER],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        addr = proc.stdout.readline().strip()
        assert ":" in addr, addr
        prev = X._SOURCE_FACTORY
        X.register_exchange_source_factory(SocketExchangeSource)
        try:
            rt = T.row(["g", "v"], [T.BIGINT, T.BIGINT])
            parts = []
            for dst in range(2):
                exch = P.ExchangeNode("ex", row_type=rt)
                ctx = QueryCtx({
                    "exchange.ex.tasks": [f"{addr}/nettask"],
                    "task.destination": dst,
                    # small credit forces several request rounds
                    "exchange.max_queue_bytes": 2048,
                })
                parts.append(Task(exch, ctx).run().to_pandas())
        finally:
            X.register_exchange_source_factory(prev)
        got = pd.concat(parts).sort_values("v").reset_index(drop=True)
        assert len(got) == 300
        np.testing.assert_array_equal(got.v, np.arange(300))
        np.testing.assert_array_equal(got.g, got.v % 7)
        # hash-partitioned: no group straddles destinations
        gsets = [set(p.g) for p in parts]
        assert not (gsets[0] & gsets[1])
    finally:
        proc.stdin.close()
        proc.wait(timeout=30)


def test_bucketize_preserves_order_within_destination():
    """Device-side PartitionedOutput groups rows by destination while
    keeping each destination's rows in input order (stable sort)."""
    import pyarrow as pa

    from velox_tpu.core import expressions as ex
    from velox_tpu.exec.exchange import OutputBufferManager
    from velox_tpu.serializers import PageSerde
    from velox_tpu.testing.plan_builder import PlanBuilder

    df = pd.DataFrame({"k": np.arange(1000, dtype="int64") * 11 % 97,
                       "v": np.arange(1000, dtype="int64")})
    src = PlanBuilder().values([pa.table(df)]).plan()
    pout = P.PartitionedOutputNode(
        "p0", source=src, kind="partitioned",
        keys=(ex.field("k", T.BIGINT),), num_partitions=4)
    Task(pout, QueryCtx({"task.id": "order-task"})).run()
    buf = OutputBufferManager.instance().get("order-task")
    serde = PageSerde()
    seen = []
    for d in range(4):
        pages, at_end = buf.get(d, 0)
        assert at_end
        for p in pages:
            from velox_tpu.vector.device import to_arrow
            t = to_arrow(serde.deserialize(p)).to_pandas()
            # within one destination, v (input order) stays ascending
            assert (np.diff(t.v) > 0).all()
            seen.append(t)
    allrows = pd.concat(seen).sort_values("v")
    np.testing.assert_array_equal(allrows.v, df.v)
    np.testing.assert_array_equal(allrows.k, df.k)
    OutputBufferManager.instance().remove("order-task")


def test_output_buffer_max_bytes_credit():
    """get(max_bytes) bounds the response but always returns at least
    one available page (parity: ExchangeSource::request(maxBytes))."""
    from velox_tpu.exec.exchange import OutputBuffer
    buf = OutputBuffer(1)
    for i in range(10):
        buf.enqueue(0, bytes([i]) * 100)
    pages, _ = buf.get(0, 0, max_bytes=250)
    assert len(pages) == 2  # 100 + 100 <= 250, third would exceed
    pages, _ = buf.get(0, 0, max_bytes=1)
    assert len(pages) == 1  # at least one page despite tiny credit
