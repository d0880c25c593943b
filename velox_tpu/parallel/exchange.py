"""Distributed exchange: hash repartition over mesh collectives.

Role parity: ``velox/exec/PartitionedOutput.h:149`` + ``OutputBuffer`` +
``Exchange`` (SURVEY.md §3.5/§5.8) — the destination-buffered, ack-based
pull shuffle. Device-native redesign: partition+serialize becomes a device-side
bucketize (radix partition by destination) and the wire protocol becomes a
single ``lax.all_to_all`` over the mesh axis; backpressure/acks are replaced
by fixed-size exchange windows with row-count headers (padding instead of
credit), exactly the plan SURVEY.md §5.8 lays out.

Current window sizing is the safe worst case (window = local capacity, i.e.
any device may send its whole batch to one destination). Count-based
windows + skew splitting are follow-up work; the API keeps the counts so the
receiving side already masks padding away.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu.exec.hashtable import hash_rows
from velox_tpu.exec.sort import radix_sort_perm
from velox_tpu.expression.eval import EvalValue, value_from_column
from velox_tpu.vector.device import DeviceBatch, DeviceColumn


def partition_ids(keys: Sequence[EvalValue], capacity: int, n: int):
    """Destination id per row = hash(keys) % n.
    Parity: exec/HashPartitionFunction.h."""
    h = hash_rows(keys, capacity)
    return (h % np.uint32(n)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# PartitionFunction SPI. Parity: core/PlanNode.h:1116 PartitionFunction +
# exec/HashPartitionFunction.h / RoundRobinPartitionFunction /
# connectors/hive/HivePartitionFunction.h. A spec name resolves to a
# traced fn(keys, mask, capacity, n, start, bucket_count) -> int32 dest
# per row; `start` is the running count of rows emitted by earlier
# batches (round-robin continuity across batches).
# ---------------------------------------------------------------------------

def _hash_partition(keys, mask, capacity, n, start, bucket_count):
    return partition_ids(keys, capacity, n)


def _round_robin_partition(keys, mask, capacity, n, start, bucket_count):
    """Active-row ordinal (continuing across batches) modulo n.
    Parity: exec/RoundRobinPartitionFunction."""
    ordinal = jnp.cumsum(mask.astype(jnp.int64)) - 1 + start
    return (ordinal % n).astype(jnp.int32)


def _hive_bucket_partition(keys, mask, capacity, n, start, bucket_count):
    """Bucket-compatible shuffle: the same murmur3 bucket function the
    Hive connector uses for bucketed WRITES (connectors/hive.py
    _np_murmur3 % bucket_count), so exchange destinations align with
    bucket files. dest = bucket % n. Parity:
    connectors/hive/HivePartitionFunction.h."""
    from velox_tpu.functions.sparksql import _hash_one_column

    class _Ctx:
        pass
    ctx = _Ctx()
    ctx.capacity = capacity
    seed = jnp.full((capacity,), 42, jnp.uint32)
    for v in keys:
        h = _hash_one_column(v, seed, ctx)
        if v.validity is not None:
            h = jnp.where(v.full_validity(capacity), h, seed)
        seed = h
    h32 = jax.lax.bitcast_convert_type(seed, jnp.int32)
    bucket = jnp.mod(h32, jnp.int32(bucket_count))  # floored: >= 0
    return jnp.mod(bucket, jnp.int32(n))


_PARTITION_FUNCTIONS = {
    "hash": _hash_partition,
    "round_robin": _round_robin_partition,
    "hive_bucket": _hive_bucket_partition,
}


def register_partition_function(name: str, fn):
    """SPI hook (parity: PartitionFunction::SpecFactory registration)."""
    _PARTITION_FUNCTIONS[name] = fn


def resolve_partition_function(name: str):
    try:
        return _PARTITION_FUNCTIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown partition function {name!r} "
            f"(have {sorted(_PARTITION_FUNCTIONS)})") from None


def partition_max_count(batch: DeviceBatch, key_names: List[str],
                        n: int):
    """Inside shard_map/vmap: this shard's max rows headed to any one
    destination — the count phase of the two-phase count-based exchange
    window (replaces the reference's credit/ack flow control,
    exec/OutputBuffer.h:157: instead of backpressure acks, the host reads
    the count maximum once and sizes the next program's static window)."""
    cap = batch.capacity
    keys = [value_from_column(batch.columns[k]) for k in key_names]
    dest = partition_ids(keys, cap, n)
    dest = jnp.where(batch.mask, dest, jnp.int32(n))
    counts = jax.ops.segment_sum(
        jnp.ones((cap,), jnp.int32), dest, num_segments=n + 1)[:n]
    return jnp.max(counts)


def window_for(max_count: int, floor: int = 1024) -> int:
    """Static exchange window from a measured count max: next power of two
    (bounds the number of distinct compiled exchange programs)."""
    return max(floor, 1 << (max(1, int(max_count)) - 1).bit_length())


def partition_histogram(batch: DeviceBatch, key_names: List[str], n: int,
                        axis_name: str):
    """Inside shard_map: GLOBAL per-destination row counts (psum over the
    mesh). The skew-detection signal (SURVEY §7.2 step 7): a destination
    holding far more than total/n rows marks its hash range as hot."""
    cap = batch.capacity
    keys = [value_from_column(batch.columns[k]) for k in key_names]
    dest = partition_ids(keys, cap, n)
    dest = jnp.where(batch.mask, dest, jnp.int32(n))
    counts = jax.ops.segment_sum(
        jnp.ones((cap,), jnp.int32), dest, num_segments=n + 1)[:n]
    return jax.lax.psum(counts, axis_name)


def _spread_dest(dest, active, hot, n: int, axis_name: str):
    """Re-route rows whose destination is hot: round-robin across all
    devices (offset by the sender's index so senders interleave). The
    key-splitting half of skew handling — the matching build rows are
    REPLICATED to every device (gather_hot_rows)."""
    cap = dest.shape[0]
    dev = jax.lax.axis_index(axis_name).astype(jnp.int32)
    rr = (jnp.arange(cap, dtype=jnp.int32) + dev) % n
    is_hot = active & (dest < n) & hot[jnp.clip(dest, 0, n - 1)]
    return jnp.where(is_hot, rr, dest)


def partition_max_count_spread(batch: DeviceBatch, key_names: List[str],
                               n: int, axis_name: str, hot):
    """Count phase matching the skew-aware exchange's final routing."""
    cap = batch.capacity
    keys = [value_from_column(batch.columns[k]) for k in key_names]
    dest = partition_ids(keys, cap, n)
    dest = jnp.where(batch.mask, dest, jnp.int32(n))
    dest = _spread_dest(dest, batch.mask, hot, n, axis_name)
    counts = jax.ops.segment_sum(
        jnp.ones((cap,), jnp.int32), dest, num_segments=n + 1)[:n]
    return jnp.max(counts)


def _map_cols(batch: DeviceBatch, f) -> "dict":
    """Apply a row transform to every column INCLUDING row-aligned
    children (long-decimal hi limbs, raw-string length lanes, ROW
    fields) — rebuilding DeviceColumns from data+validity alone silently
    dropped them (observed: Q1's DECIMAL(38) sums lost their hi limb
    through the gather exchange). ARRAY/MAP columns need element-space
    exchange, which these row-window transports do not do — refuse."""
    from velox_tpu.exec.batch_utils import map_column_rows
    cols = {}
    for name, col in batch.columns.items():
        if col.dtype.is_complex:
            raise NotImplementedError(
                f"column {name!r}: ARRAY/MAP columns are not supported "
                "across the distributed exchange yet")
        cols[name] = map_column_rows(col, f)
    return cols


def gather_hot_rows(batch: DeviceBatch, key_names: List[str], n: int,
                    axis_name: str, hot, window: int) -> DeviceBatch:
    """Inside shard_map: all_gather every device's rows whose destination
    is hot -> a replicated (n*window) batch (the build-side replication
    half of key splitting)."""
    cap = batch.capacity
    keys = [value_from_column(batch.columns[k]) for k in key_names]
    dest = partition_ids(keys, cap, n)
    is_hot = batch.mask & hot[jnp.clip(dest, 0, n - 1)]
    idx = jnp.cumsum(is_hot.astype(jnp.int32)) - 1
    tgt = jnp.where(is_hot & (idx < window), idx, jnp.int32(window))

    def compact(a, fill=0):
        out = jnp.zeros((window + 1,) + a.shape[1:], a.dtype)
        return out.at[tgt].set(a, mode="drop")[:window]

    n_local = jnp.sum(is_hot.astype(jnp.int32))
    local_mask = jnp.arange(window, dtype=jnp.int32) < n_local

    def gather(a):
        g = jax.lax.all_gather(a, axis_name, axis=0, tiled=False)
        return g.reshape((n * window,) + a.shape[2:]) if a.ndim > 1 \
            else g.reshape((n * window,))

    cols = _map_cols(batch, lambda a: gather(compact(a)))
    return DeviceBatch(cols, gather(local_mask))


def repartition_all_to_all(batch: DeviceBatch, key_names: List[str],
                           n: int, axis_name: str,
                           window: int = None,
                           spread_hot=None) -> DeviceBatch:
    """Inside shard_map: exchange rows so each row lands on device
    hash(key) % n. Returns the local received batch (capacity n * window).

    The local batch is bucketized by destination with a radix pass (the
    device-side analogue of Destination::advance serialization,
    exec/PartitionedOutput.cpp:23-70), laid out into an (n, window) send
    buffer, and exchanged with one all_to_all. ``window`` defaults to the
    safe worst case (local capacity); callers run partition_max_count
    first and pass window_for(max) to bound exchange memory n-fold.
    """
    cap = batch.capacity
    if window is None:
        window = cap  # safe worst case; see module docstring
    window = min(window, cap)
    keys = [value_from_column(batch.columns[k]) for k in key_names]
    dest = partition_ids(keys, cap, n)
    dest = jnp.where(batch.mask, dest, jnp.int32(n))  # inactive -> dropped
    if spread_hot is not None:
        dest = _spread_dest(dest, batch.mask, spread_hot, n, axis_name)

    # stable partition by destination (4-bit digits cover n <= 16 twice)
    bits = max(1, int(np.ceil(np.log2(max(2, n + 1)))))
    perm = radix_sort_perm([dest.astype(jnp.uint32)], [bits], cap)
    dest_s = dest[perm]
    counts = jax.ops.segment_sum(
        jnp.ones((cap,), jnp.int32), dest_s, num_segments=n + 1)[:n]
    offsets = jnp.cumsum(counts) - counts
    iota = jnp.arange(cap, dtype=jnp.int32)
    # position within the (n, window) send buffer
    within = iota - offsets[jnp.clip(dest_s, 0, n - 1)]
    send_pos = jnp.where(dest_s < n,
                         jnp.clip(dest_s, 0, n - 1) * window + within,
                         jnp.int32(n * window))  # inactive dropped

    def exchange_col(data):
        send = jnp.zeros((n * window,) + data.shape[1:], data.dtype) \
            .at[send_pos].set(data[perm], mode="drop")
        send = send.reshape((n, window) + data.shape[1:])
        recv = jax.lax.all_to_all(send, axis_name, split_axis=0,
                                  concat_axis=0, tiled=False)
        return recv.reshape((n * window,) + data.shape[1:])

    recv_counts = jax.lax.all_to_all(
        counts.reshape(n, 1), axis_name, split_axis=0, concat_axis=0,
        tiled=False).reshape(n)
    # received row i of block b is valid iff i < recv_counts[b]
    pos_in_block = jnp.arange(n * window, dtype=jnp.int32) % window
    block = jnp.arange(n * window, dtype=jnp.int32) // window
    mask = pos_in_block < recv_counts[block]

    cols = _map_cols(batch, exchange_col)
    return DeviceBatch(cols, mask)


def broadcast_gather(batch: DeviceBatch, n: int,
                     axis_name: str) -> DeviceBatch:
    """Inside shard_map: all_gather every device's batch (broadcast join
    build side / gather exchange). Returns capacity n * cap, replicated."""
    cap = batch.capacity

    def gather_col(data):
        g = jax.lax.all_gather(data, axis_name, axis=0, tiled=False)
        return g.reshape((n * cap,) + data.shape[1:])

    cols = _map_cols(batch, gather_col)
    return DeviceBatch(cols, gather_col(batch.mask))
