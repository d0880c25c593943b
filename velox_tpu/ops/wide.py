"""Wide-dtype scatter/reduction workarounds.

They were chosen for the engine's first accelerator, where 64-bit scatters
were far slower than 32-bit ones while dense 64-bit ops were nearly free;
none is yet measured on the H100 against the plain scatter (ROADMAP C3):

* ``scatter_unique_set`` splits an int64/uint64 scatter into hi/lo int32
  scatters (CORRECT ONLY for unique indices: duplicate indices could tear
  hi from lo when the two scatters pick different winners);
* segmented reductions over SORTED runs (group-by states) use dense
  cumulative ops + ONE end-of-run scatter instead of segment_sum's
  scatter-add (exec/groupby.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _is_wide_int(dtype) -> bool:
    return dtype in (jnp.int64, jnp.uint64) or \
        np.dtype(dtype) in (np.dtype(np.int64), np.dtype(np.uint64))


def scatter_unique_set(out_len: int, idx, values, mode: str = "drop"):
    """zeros(out_len).at[idx].set(values) — fast path for 64-bit values
    via 32-bit component scatters (see the module note). REQUIRES unique (or dropped) indices: duplicates may
    tear the components."""
    dt = values.dtype
    if values.ndim == 1 and dt == jnp.float64:
        # exact triple-f32 split (same decomposition as the f64 sort-key
        # encoding, exec/sort.py): hi/lo/lo2 are successive f32 roundings
        # whose f64 sum reconstructs the value exactly (<=5 residual bits
        # after 48, and the true sum is representable). EXACT ONLY inside
        # f32's dynamic range: |v| beyond ~2^126 overflows the hi
        # component to inf (inf - inf = NaN corrupts every group
        # downstream) and |v| below ~2^-100 pushes the residuals past
        # f32 subnormals — a traced range check picks the slow exact
        # 64-bit scatter for such batches (lax.cond: one branch runs).
        av = jnp.abs(values)
        safe = jnp.all(jnp.isfinite(values) & (av < 2.0 ** 126)
                       & ((av > 2.0 ** -100) | (values == 0.0)))

        def _split(vals):
            hi = vals.astype(jnp.float32)
            lo = (vals - hi.astype(jnp.float64)).astype(jnp.float32)
            lo2 = (vals - hi.astype(jnp.float64)
                   - lo.astype(jnp.float64)).astype(jnp.float32)
            shi = jnp.zeros((out_len,), jnp.float32).at[idx].set(
                hi, mode=mode)
            slo = jnp.zeros((out_len,), jnp.float32).at[idx].set(
                lo, mode=mode)
            slo2 = jnp.zeros((out_len,), jnp.float32).at[idx].set(
                lo2, mode=mode)
            return (shi.astype(jnp.float64) + slo.astype(jnp.float64)
                    + slo2.astype(jnp.float64))

        def _wide(vals):
            return jnp.zeros((out_len,), jnp.float64).at[idx].set(
                vals, mode=mode)

        return jax.lax.cond(safe, _split, _wide, values)
    if values.ndim == 1 and _is_wide_int(dt):
        u = values.astype(jnp.uint64)
        lo = jax.lax.bitcast_convert_type(
            (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32), jnp.int32)
        hi = (u >> jnp.uint64(32)).astype(jnp.uint32)
        hi = jax.lax.bitcast_convert_type(hi, jnp.int32)
        slo = jnp.zeros((out_len,), jnp.int32).at[idx].set(lo, mode=mode)
        shi = jnp.zeros((out_len,), jnp.int32).at[idx].set(hi, mode=mode)
        out = (jax.lax.bitcast_convert_type(shi, jnp.uint32)
               .astype(jnp.uint64) << jnp.uint64(32)) \
            | jax.lax.bitcast_convert_type(slo, jnp.uint32) \
            .astype(jnp.uint64)
        return out.astype(dt)
    return jnp.zeros((out_len,) + values.shape[1:], dt).at[idx].set(
        values, mode=mode)


def segmented_reduce_sorted(data, gid, boundary, active_sorted,
                            capacity: int, combine: str):
    """Per-group reduction over rows SORTED by group (exec/groupby.py):
    groups are runs, gid is non-decreasing, inactive rows trail (already
    carrying the combine identity). Returns group values as a dense
    prefix of length `capacity`.

    sum: dense cumsum + end-of-run scatter + adjacent difference.
    min/max: segmented Hillis-Steele doubling scan (a shift + select per
    power of two, in place of jax.lax.associative_scan with a pair
    combiner, whose compiles were slow on the engine's first
    accelerator) + end-of-run scatter.

    NOTE (hot path): reduce_sort_mode's ride path no longer calls this —
    it computes per-row values with segmented_scan_values and compacts
    run ends with ONE flag-keyed lax.sort instead of per-lane scatters.
    """
    is_end = jnp.concatenate([boundary[1:], jnp.ones((1,), bool)])
    idx_end = jnp.where(is_end & active_sorted, gid, jnp.int32(capacity))
    if combine == "sum" and not jnp.issubdtype(data.dtype, jnp.floating):
        # integer sums: global cumsum + end-of-run scatter + adjacent
        # difference (exact — integer addition is associative)
        cs = jnp.cumsum(data, axis=0)
        ends = scatter_unique_set(capacity + 1, idx_end, cs)[:capacity]
        prev = jnp.concatenate([jnp.zeros_like(ends[:1]), ends[:-1]])
        return ends - prev
    if combine == "sum":
        # FLOATING sums run the SEGMENTED shift-add scan below instead:
        # the cumsum-difference form absorbs small groups that follow a
        # huge one (cs = 2e300 + 5 == 2e300 -> the 5-group differences
        # to 0.0), because the running total mixes groups
        op = jnp.add
        ident = jnp.asarray(0.0, data.dtype)
    else:
        op = jnp.minimum if combine == "min" else jnp.maximum
        if jnp.issubdtype(data.dtype, jnp.floating):
            ident = jnp.asarray(jnp.inf if combine == "min" else -jnp.inf,
                                data.dtype)
        else:
            info = jnp.iinfo(data.dtype)
            ident = jnp.asarray(info.max if combine == "min" else info.min,
                                data.dtype)
    return _segmented_scan_reduce(data, idx_end, boundary, capacity, op,
                                  ident)


def _segmented_scan_reduce(data, idx_end, boundary, capacity: int, op,
                           ident):
    """Segmented Hillis-Steele doubling scan + end-of-run scatter (the
    general-combine path of segmented_reduce_sorted)."""
    run_off = segment_offsets(boundary, capacity)
    x = _segmented_scan(data, run_off, capacity, op, ident)
    return scatter_unique_set(capacity + 1, idx_end, x)[:capacity]


def segment_offsets(boundary, capacity: int):
    """Per-row offset within its run (0 at run starts). Shared by all
    scans over the same run structure (one cummax)."""
    iota = jnp.arange(capacity, dtype=jnp.int32)
    run_start = jax.lax.cummax(jnp.where(boundary, iota, jnp.int32(0)))
    return iota - run_start


def _segmented_scan(data, run_off, capacity: int, op, ident):
    x = data
    k = 1
    while k < capacity:
        pad_shape = (k,) + x.shape[1:]
        shifted = jnp.concatenate(
            [jnp.full(pad_shape, ident, x.dtype), x[:-k]], axis=0)
        take = run_off >= k
        if x.ndim > 1:
            take = take[:, None]
        x = jnp.where(take, op(x, shifted), x)
        k <<= 1
    return x


def segmented_scan_values(data, run_off, capacity: int, combine: str):
    """Per-row INCLUSIVE segmented scan (no end-of-run scatter): the
    value at each run's last row is the run's reduction. The hot-path
    primitive behind reduce_sort_mode — run ends are compacted afterwards
    by one flag-keyed lax.sort shared across all lanes.

    The 23 shift-select passes fuse into few kernels. Float sums use the
    scan rather than a cumsum difference because a global running total
    mixes groups (cs = 2e300 + 5 == 2e300 -> small groups absorb to 0).
    Integer sums use the exact global-cumsum shortcut: the caller takes
    adjacent differences AFTER compaction (group ends are adjacent in
    the compacted prefix).

    Returns (values, needs_diff): needs_diff says the compacted values
    are a running total and the caller must take adjacent differences.
    """
    if combine == "sum" and not jnp.issubdtype(data.dtype, jnp.floating):
        return jnp.cumsum(data, axis=0), True
    if combine == "sum":
        op, ident = jnp.add, jnp.asarray(0.0, data.dtype)
    else:
        op = jnp.minimum if combine == "min" else jnp.maximum
        if jnp.issubdtype(data.dtype, jnp.floating):
            ident = jnp.asarray(jnp.inf if combine == "min" else -jnp.inf,
                                data.dtype)
        else:
            info = jnp.iinfo(data.dtype)
            ident = jnp.asarray(info.max if combine == "min" else info.min,
                                data.dtype)
    return _segmented_scan(data, run_off, capacity, op, ident), False
