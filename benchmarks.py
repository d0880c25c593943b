"""Per-operator micro-benchmarks on one NVIDIA GPU.

Role parity: velox/benchmarks/basic/* (folly::Benchmark suites). Prints a
throughput table; bench.py prints the single-line headline.

Usage: python benchmarks.py [rows_log2]
"""

from __future__ import annotations

import sys
import time


def gpu_device() -> dict:
    """The device measured: platform, device_kind, count and the card's
    name and power limit. Exits unless JAX's platform is the GPU."""
    import subprocess

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"needs an NVIDIA GPU, JAX's platform is "
                 f"{devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind, "count": len(devs),
            "nvidia_smi": smi}


def timeit(fn, *args, iters=10):
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / iters


def run_micro(rows_log2: int = 20):
    """Micro suite -> {name: M rows/s}; bench.py prints it with its
    detail line."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from velox_tpu.exec import hashtable as H
    from velox_tpu.exec.sort import radix_sort_perm
    from velox_tpu.expression.eval import EvalValue
    from velox_tpu import types as T

    n = 1 << rows_log2
    rng = np.random.RandomState(0)
    print(f"device={jax.devices()[0]}, rows={n}",
          file=sys.stderr)
    rows = []

    # filter+sum superstep (Q6 core)
    sd = jnp.asarray(rng.randint(8000, 11000, n).astype(np.int32))
    price = jnp.asarray(rng.randint(10**5, 10**7, n).astype(np.int32))
    disc = jnp.asarray(rng.randint(0, 11, n).astype(np.int32))

    @jax.jit
    def filter_sum(sd, price, disc):
        keep = (sd >= 8766) & (sd < 9131) & (disc >= 5) & (disc <= 7)
        return jnp.sum(jnp.where(
            keep, price.astype(jnp.int64) * disc, 0))

    dt = timeit(filter_sum, sd, price, disc)
    rows.append(("filter+multiply+sum (3 int32 cols)", n / dt / 1e6))

    # radix sort permutation, 32-bit keys
    keys = jnp.asarray(rng.randint(0, 1 << 31, n).astype(np.uint32))
    sort_fn = jax.jit(lambda w: radix_sort_perm([w], [32], n))
    dt = timeit(sort_fn, keys)
    rows.append(("lax.sort perm (u32 keys)", n / dt / 1e6))

    # hash-table group-by (sum over ~64K groups)
    gk = jnp.asarray(rng.randint(0, 1 << 16, n).astype(np.int64))
    vals = jnp.asarray(rng.randint(0, 1000, n).astype(np.int64))
    active = jnp.ones((n,), bool)

    @jax.jit
    def group_sum(gk, vals, active):
        kv = [EvalValue(gk, None, T.BIGINT)]
        table = H.empty_table(kv, H.table_size_for(n))
        table, slots, _ = H.insert(table, kv, active, n)
        seg = jnp.where(active, slots, jnp.int32(table.size))
        return jax.ops.segment_sum(vals, seg,
                                   num_segments=table.size + 1)

    dt = timeit(group_sum, gk, vals, active)
    rows.append(("hash group-by sum (64K groups)", n / dt / 1e6))

    # sort-mode group-by with payload riding + lane decode (the Q3/Q18
    # aggregation hot path, exec/groupby.py reduce_sort_mode)
    from velox_tpu.exec import groupby as G
    gk2 = jnp.asarray(rng.randint(0, n, n).astype(np.int64))

    @jax.jit
    def ride_group_sum(gk2, vals, active):
        kv = [EvalValue(gk2, None, T.BIGINT)]
        _, gs, _ = G.reduce_sort_mode(kv, [(vals, "sum")], active, n,
                                      ranges=((0, n - 1),))
        return gs[0]

    dt = timeit(ride_group_sum, gk2, vals, active)
    rows.append(("sort-mode group-by sum (ride+decode)", n / dt / 1e6))

    # hash-join probe (unique build of n/4 keys)
    bk = jnp.asarray(rng.permutation(n)[:n // 4].astype(np.int64))
    pk = jnp.asarray(rng.randint(0, n, n).astype(np.int64))

    @jax.jit
    def rebuild(bk):
        bkv = [EvalValue(bk, None, T.BIGINT)]
        t = H.empty_table(bkv, H.table_size_for(n // 4))
        t, _, _ = H.insert(t, bkv, jnp.ones((n // 4,), bool), n // 4)
        return t

    table = rebuild(bk)

    @jax.jit
    def probe(table, pk):
        kv = [EvalValue(pk, None, T.BIGINT)]
        slots, found = H.lookup(table, kv, jnp.ones((n,), bool), n)
        return jnp.sum(found)

    dt = timeit(probe, table, pk)
    rows.append(("hash-join probe (25% hit domain)", n / dt / 1e6))

    # wide-key (2xBIGINT) group-by through the PRODUCTION dispatch:
    # reduce_sort_mode with no stats ranges (4 value words -> 3 lanes)
    gk3 = jnp.asarray(rng.randint(0, 1 << 8, n).astype(np.int64))

    @jax.jit
    def wide_group_sum(gk2, gk3, vals, active):
        kv = [EvalValue(gk2, None, T.BIGINT),
              EvalValue(gk3, None, T.BIGINT)]
        _, gs, _ = G.reduce_sort_mode(kv, [(vals, "sum")], active, n)
        return gs[0]

    dt = timeit(wide_group_sum, gk2, gk3, vals, active)
    rows.append(("wide-key group-by sum (2xi64, sort mode)", n / dt / 1e6))

    # array-mode join probe (HashMode::kArray analogue — the TPC-H path:
    # dense start/count domain table, two int32 gathers per probe)
    from velox_tpu import types as _T
    from velox_tpu.exec import join as J
    from velox_tpu.vector.device import DeviceBatch, DeviceColumn

    class _KF:
        def __init__(self, name, dtype):
            self.name, self.dtype = name, dtype

    kf = (_KF("k", _T.BIGINT),)
    bb = DeviceBatch({"k": DeviceColumn(bk, None, _T.BIGINT, None)},
                     jnp.ones((n // 4,), bool))
    build_fn = jax.jit(lambda b: J.build_sorted_table(b, kf, (0, n - 1)))
    bt = build_fn(bb)

    @jax.jit
    def array_probe(bt, pk):
        norm = pk - bt.arr_base
        idx = jnp.clip(norm, 0, bt.arr_start.shape[0] - 1) \
            .astype(jnp.int32)
        counts = jnp.where((norm >= 0) & (norm < bt.arr_start.shape[0]),
                           bt.arr_count[idx], 0)
        return jnp.sum(counts), bt.perm[bt.arr_start[idx]]

    dt = timeit(array_probe, bt, pk)
    rows.append(("array-mode join probe (dense domain)", n / dt / 1e6))

    # wide-key (2xBIGINT) join probe through the PRODUCTION dispatch:
    # sorted build + merge-rank probe (exec/join.py wide mode)
    bk2 = jnp.asarray(rng.randint(0, 1 << 8, n // 4).astype(np.int64))
    pk2 = jnp.asarray(rng.randint(0, 1 << 8, n).astype(np.int64))
    kf2 = (_KF("k", _T.BIGINT), _KF("k2", _T.BIGINT))
    bb2 = DeviceBatch({"k": DeviceColumn(bk, None, _T.BIGINT, None),
                       "k2": DeviceColumn(bk2, None, _T.BIGINT, None)},
                      jnp.ones((n // 4,), bool))
    bt2 = jax.jit(lambda b: J.build_table(b, kf2))(bb2)
    assert isinstance(bt2, J.SortedBuild), type(bt2)

    class _Probe(J.HashJoinOperator):
        def __init__(self):  # bare probe: skip the Operator plumbing
            self._node = type("N", (), {
                "left_keys": kf2, "right_keys": kf2})()
            self._join_key_ranges = None

    pb = DeviceBatch({"k": DeviceColumn(pk, None, _T.BIGINT, None),
                      "k2": DeviceColumn(pk2, None, _T.BIGINT, None)},
                     jnp.ones((n,), bool))
    op = _Probe()

    @jax.jit
    def wide_probe(batch, bt):
        _, lo, counts, hit = op._lookup(batch, bt)
        return jnp.sum(counts), jnp.sum(hit)

    dt = timeit(wide_probe, pb, bt2)
    rows.append(("wide-key join probe (2xi64, merge-rank)", n / dt / 1e6))

    # gather: XLA take
    data32 = jnp.asarray(rng.randint(-10**9, 10**9, min(n, 1 << 20))
                         .astype(np.int32))
    idx = jnp.asarray(rng.randint(0, data32.shape[0], n)
                      .astype(np.int32))
    dt = timeit(jax.jit(lambda d, i: d[i]), data32, idx)
    rows.append(("XLA gather (i32, 1M-row data)", n / dt / 1e6))

    return dict(rows)


def main():
    print(gpu_device())
    rows = run_micro(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
    print(f"{'operation':45s} {'M rows/s':>10s}")
    for name, thr in rows.items():
        print(f"{name:45s} {thr:10.1f}")


if __name__ == "__main__":
    main()
