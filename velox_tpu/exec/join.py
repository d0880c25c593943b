"""Hash join: build + probe.

Role parity: ``velox/exec/HashBuild.h:38`` / ``HashProbe.h:28`` /
``HashJoinBridge.h`` — all join types over a shared build-side table.

Device-first redesign: the default "table" is a **sorted key array**
— the build side is sorted by its packed order-preserving key word
(exec/sort.py pack_key_u64), and a probe is two ``searchsorted`` binary
searches giving the run [lo, hi) of equal build keys. That replaces the
reference's SIMD tagged-bucket probe (HashTable.h:377) with dense
vectorized work: log2(N) gathers, no scatter-probe rounds.
Duplicate keys need no CSR side structure — the sorted run IS the duplicate
list, and ``perm`` maps sorted positions back to build rows.

Key tuples whose order-preserving words exceed one u64 (e.g. two BIGINT
keys) fall back to the scatter-probe hash table (exec/hashtable.py), which
remains the streaming-state structure for RowNumber/MarkDistinct.

* **Unique-key builds** emit one output row per probe row — a single jitted
  program per batch, no host synchronization.
* **Duplicate-key builds** are two-pass count+emit (parity:
  HashProbe::listJoinResults, HashProbe.cpp:1054): a counts program
  computes per-probe-row match counts and their prefix sum, the host reads
  the total (one sync), and a fixed-capacity emit program materializes
  output chunks — the static-shape answer to unknown join cardinality
  (SURVEY.md §7.3).
* **Right/full/right-semi** joins track matched build rows in a device flag
  array updated per probe batch; unmatched build rows are emitted after the
  last probe batch (parity: HashProbe's "right side results" phase).
* **Join filters on outer joins** (velox HashProbe.cpp filter handling):
  the filter runs on expanded candidate rows; LEFT/FULL probe rows whose
  candidates ALL fail the filter still emit one row with a null build side,
  and semi/anti matches count only filter-passing candidates.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.core import plan as P
from velox_tpu.exec import hashtable as H
from velox_tpu.exec.batch_utils import concat_batches
from velox_tpu.exec.operator import Operator
from velox_tpu.exec.sort import (
    pack_key_u64, packable_words, radix_sort_perm, sort_words,
)
from velox_tpu.expression.eval import (
    EvalValue, ExprSet, value_from_column,
)
from velox_tpu.vector.device import DeviceBatch, DeviceColumn


class SortedBuild(NamedTuple):
    """The HashJoinBridge payload (sorted-key mode).

    When the build key is a single integral key whose plan-level stats
    span a small domain (parity: velox HashMode::kArray,
    exec/HashTable.h:119), ``arr_start``/``arr_count`` hold a dense
    direct-address table over [arr_base, arr_base + domain): probing is
    then TWO int32 gathers instead of a per-batch merge-rank sort
    (cheaper on the engine's first accelerator; not yet measured on the
    H100). All other machinery (dup
    runs via perm, right phases, merge join) reuses the sorted arrays."""
    sorted_key: jnp.ndarray   # uint64[cap]; tail past n_usable = MAX
    perm: jnp.ndarray         # int32[cap]: sorted position -> build row
    n_usable: jnp.ndarray     # int32 scalar: rows with non-null keys
    batch: DeviceBatch        # build-side rows (unpermuted)
    num_rows: jnp.ndarray     # device scalar
    has_null_key: jnp.ndarray  # device scalar bool (null-aware anti joins)
    has_dup_keys: jnp.ndarray  # device scalar bool
    arr_start: Optional[jnp.ndarray] = None  # int32[domain]: first sorted
    #                                          position of key, 0 if absent
    arr_count: Optional[jnp.ndarray] = None  # int32[domain]: run length
    arr_base: Optional[jnp.ndarray] = None   # int64 scalar: domain base
    arr_row1: Optional[jnp.ndarray] = None   # int32[domain]: BUILD ROW id
    #   + 1 of the key's FIRST match, 0 if absent — unique-build probes
    #   need ONE gather through this instead of three (start, count,
    #   perm)


class BuiltTable(NamedTuple):
    """The HashJoinBridge payload (scatter-probe fallback mode)."""
    table: H.HashTable
    batch: DeviceBatch
    slot_count: jnp.ndarray
    slot_offset: jnp.ndarray
    csr_rows: jnp.ndarray
    num_rows: jnp.ndarray
    has_null_key: jnp.ndarray
    has_dup_keys: jnp.ndarray


_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _key_values(batch: DeviceBatch, key_fields) -> List[EvalValue]:
    return [value_from_column(batch.columns[k.name]) for k in key_fields]


def _usable(batch: DeviceBatch, keys: List[EvalValue]):
    """Active rows with fully non-null keys (SQL join null semantics)."""
    ok = batch.mask
    for v in keys:
        if v.validity is not None:
            ok = ok & v.full_validity(batch.capacity)
    return ok


def build_sorted_table(b: DeviceBatch, key_fields,
                       array_range=None) -> SortedBuild:
    """Pure traced build of the sorted-key table (vmappable for
    per-device partitioned builds, parallel/distributed.py).

    ``array_range`` = static (min, max) storage bounds of a SINGLE
    integral build key: additionally builds the dense direct-address
    start/count table (HashMode::kArray parity — see SortedBuild).

    WIDE keys (value words beyond one packed u64, up to sortable_words):
    the build still sorts — probes go through the merge-rank sort, which
    never reads ``sorted_key`` — and only duplicate detection needs the
    sorted lanes, so ``sorted_key`` holds a placeholder. This replaces
    the scatter-probe hash table for multi-BIGINT/decimal key tuples
    (far faster on the engine's first accelerator; not yet measured on the
    H100)."""
    from velox_tpu.exec.sort import (
        decode_key_field, lane_bit_widths, packable_words, sort_perm_key,
        sort_words_layout,
    )
    cap = b.capacity
    keys = _key_values(b, key_fields)
    usable = _usable(b, keys)
    # sort usable rows first, ordered by key words (stable)
    words, bits, layout = sort_words_layout(keys, None, cap, usable)
    perm, skey = sort_perm_key(words, bits, cap)
    n = jnp.sum(usable.astype(jnp.int32))
    in_prefix = jnp.arange(cap, dtype=jnp.int32) < n
    if _has_raw_key(b, key_fields) \
            or not packable_words([k.dtype for k in key_fields]):
        # wide mode: adjacent-equal duplicate detection over the sorted
        # key lanes
        eq = jnp.ones((cap - 1,), bool)
        for lane in skey:
            eq = eq & (lane[1:] == lane[:-1])
        dup = eq & in_prefix[1:]
        placeholder = jnp.where(in_prefix, jnp.uint64(0), _U64_MAX)
        return SortedBuild(placeholder, perm, n, b, n.astype(jnp.int64),
                           jnp.any(b.mask & ~usable), jnp.any(dup))
    decoded_sorted = None
    if all(f.decodable for f in layout):
        # reconstruct the SORTED key values from the sorted lane bits — no
        # N-sized gathers (chosen for the engine's first accelerator, where
        # gathers were slow; not yet measured on the H100)
        lw = lane_bit_widths(int(sum(bits)))
        decoded_sorted = []
        for v, f in zip(keys, layout):
            data, isnull = decode_key_field(f, skey, lw, cap)
            validity = None if isnull is None else ~isnull
            decoded_sorted.append(EvalValue(data, validity, v.dtype,
                                            v.dictionary))
    if decoded_sorted is not None:
        packed = pack_key_u64(decoded_sorted, cap)
    else:
        packed = pack_key_u64(keys, cap)[perm]
    # force the non-usable tail to MAX so the array is globally
    # sorted for searchsorted (tail key words are arbitrary)
    packed = jnp.where(in_prefix, packed, _U64_MAX)
    dup = (packed[1:] == packed[:-1]) & in_prefix[1:]
    arr_start = arr_count = arr_base = None
    if array_range is not None:
        lo_v, hi_v = int(array_range[0]), int(array_range[1])
        domain = hi_v - lo_v + 1
        ks = (decoded_sorted[0].full_data(cap).astype(jnp.int64)
              if decoded_sorted is not None
              else keys[0].full_data(cap).astype(jnp.int64)[perm])
        ok = in_prefix & (ks >= lo_v) & (ks <= hi_v)
        norm = jnp.clip(ks - lo_v, 0, domain - 1).astype(jnp.int32)
        iota = jnp.arange(cap, dtype=jnp.int32)
        # run boundaries must treat an ok/not-ok edge as a run end: a
        # masked tail row whose CLIPPED norm equals the last usable key
        # would otherwise suppress that key's `last` flag, making
        # arr_count negative and silently dropping its matches
        prev_ok = jnp.concatenate([jnp.zeros((1,), bool), ok[:-1]])
        next_ok = jnp.concatenate([ok[1:], jnp.zeros((1,), bool)])
        prev = jnp.concatenate([norm[:1] - 1, norm[:-1]])
        nxt = jnp.concatenate([norm[1:], norm[-1:] - 1])
        first = ok & (~prev_ok | (norm != prev))
        last = ok & (~next_ok | (nxt != norm))
        arr_start = jnp.zeros((domain,), jnp.int32).at[
            jnp.where(first, norm, jnp.int32(domain))].set(
                iota, mode="drop")
        ends = jnp.zeros((domain,), jnp.int32).at[
            jnp.where(last, norm, jnp.int32(domain))].set(
                iota + 1, mode="drop")
        arr_count = ends - arr_start  # untouched keys: 0 - 0 = 0
        arr_base = jnp.int64(lo_v)
        # unique-probe fast lane: first match's BUILD row + 1 (0 absent)
        arr_row1 = jnp.zeros((domain,), jnp.int32).at[
            jnp.where(first, norm, jnp.int32(domain))].set(
                perm + 1, mode="drop")
    else:
        arr_row1 = None
    return SortedBuild(packed, perm, n, b, n.astype(jnp.int64),
                       jnp.any(b.mask & ~usable), jnp.any(dup),
                       arr_start, arr_count, arr_base, arr_row1)


def build_sorted_table_presorted(b: DeviceBatch, key_fields) -> SortedBuild:
    """SortedBuild from input ALREADY sorted by the join keys (merge join):
    usable rows compact stably to a prefix — NO radix sort. Parity: velox
    MergeJoin's right-side accumulation (exec/MergeJoin.cpp), which never
    hashes or sorts. Also returns nothing about order violations — callers
    check ``presorted_is_sorted``."""
    from velox_tpu.ops.wide import scatter_unique_set
    cap = b.capacity
    keys = _key_values(b, key_fields)
    usable = _usable(b, keys)
    n = jnp.sum(usable.astype(jnp.int32))
    pos = jnp.cumsum(usable.astype(jnp.int32)) - 1
    tgt = jnp.where(usable, pos, jnp.int32(cap))
    perm = jnp.zeros((cap,), jnp.int32).at[tgt].set(
        jnp.arange(cap, dtype=jnp.int32), mode="drop")
    packed = scatter_unique_set(cap + 1, tgt,
                                pack_key_u64(keys, cap))[:cap]
    in_prefix = jnp.arange(cap, dtype=jnp.int32) < n
    packed = jnp.where(in_prefix, packed, _U64_MAX)
    dup = (packed[1:] == packed[:-1]) & in_prefix[1:]
    return SortedBuild(packed, perm, n, b, n.astype(jnp.int64),
                       jnp.any(b.mask & ~usable), jnp.any(dup))


def presorted_is_sorted(bt: SortedBuild):
    """Device scalar: the compacted key prefix is non-decreasing (the
    merge-join input contract)."""
    return jnp.all(bt.sorted_key[1:] >= bt.sorted_key[:-1])


def build_hash_table(b: DeviceBatch, key_fields) -> BuiltTable:
    """Pure traced build of the scatter-probe fallback table."""
    cap = b.capacity
    keys = _key_values(b, key_fields)
    usable = _usable(b, keys)
    table = H.empty_table(keys, H.table_size_for(cap))
    table, slots, is_new = H.insert(table, keys, usable, cap)
    S = table.size
    seg = jnp.where(usable, slots, jnp.int32(S))
    slot_count = jax.ops.segment_sum(
        jnp.ones((cap,), jnp.int32), seg, num_segments=S + 1)[:S]
    slot_offset = jnp.cumsum(slot_count) - slot_count
    slot_bits = max(1, S.bit_length())
    csr_rows = radix_sort_perm([seg.astype(jnp.uint32)], [slot_bits], cap)
    num = jnp.sum(usable.astype(jnp.int32))
    return BuiltTable(table, b, slot_count, slot_offset, csr_rows,
                      num.astype(jnp.int64), jnp.any(b.mask & ~usable),
                      jnp.any(usable & ~is_new))


def _has_raw_key(b: DeviceBatch, key_fields) -> bool:
    from velox_tpu.vector import strings as S
    return any(S.is_raw(b.columns.get(k.name)) for k in key_fields)


def build_table(b: DeviceBatch, key_fields, array_range=None):
    from velox_tpu.exec.sort import sortable_words
    if _has_raw_key(b, key_fields):
        # raw string keys: many byte words per key — always the sorted
        # build + merge-rank probe (the whole point of the raw layout:
        # no host dictionary of every distinct value)
        return build_sorted_table(b, key_fields, None)
    if packable_words([k.dtype for k in key_fields]):
        return build_sorted_table(b, key_fields, array_range)
    if sortable_words([k.dtype for k in key_fields]):
        # wide keys: sorted build + merge-rank probes (no u64 packing)
        return build_sorted_table(b, key_fields, None)
    return build_hash_table(b, key_fields)


# Max dense direct-address domain for array-mode joins: 1<<26 entries =
# 512 MB of int32 start+count tables — well inside one chip's HBM, and
# covers every TPC-H key at SF <= ~10.
ARRAY_JOIN_MAX_DOMAIN = 1 << 26


def array_join_range(node: P.HashJoinNode):
    """Static (min, max) bounds for array-mode probing, or None: single
    integral/date/short-decimal equi-key whose PLAN-LEVEL stats (both
    sides' union would be wasteful — only build-side keys can match)
    span at most ARRAY_JOIN_MAX_DOMAIN values."""
    if len(node.right_keys) != 1:
        return None
    k = node.right_keys[0]
    dt = k.dtype
    if dt.is_long_decimal or not (
            dt.is_integral or dt.kind in (T.TypeKind.DATE,
                                          T.TypeKind.DECIMAL)):
        return None
    from velox_tpu.core.stats import resolve_column_stats
    rng = resolve_column_stats(node.right, k.name)
    if rng is None:
        return None
    lo, hi = int(rng[0]), int(rng[1])
    if hi - lo + 1 > ARRAY_JOIN_MAX_DOMAIN or hi < lo:
        return None
    return (lo, hi)


class HashBuildStage:
    """Consumes build-side batches and produces a SortedBuild (or the
    BuiltTable fallback for key tuples wider than one packed u64).

    ``offload_bytes`` bounds HBM held by buffered build batches: beyond
    it, batches spill to host RAM and return for the build (parity:
    velox Spiller kHashJoinBuild, exec/Spiller.h:29)."""

    def __init__(self, key_fields, offload_bytes=None, pool=None,
                 array_range=None, host_budget_bytes=None,
                 spill_dir=None, max_spill_bytes=None):
        from velox_tpu.common import metrics as M
        from velox_tpu.exec.memory import OffloadBuffer
        self._key_fields = list(key_fields)
        self._array_range = array_range
        self._buf = OffloadBuffer(offload_bytes,
                                  metric_key=M.K_JOIN_BUILD_OFFLOADS,
                                  pool=pool,
                                  host_budget_bytes=host_budget_bytes,
                                  spill_dir=spill_dir,
                                  max_spill_bytes=max_spill_bytes)

    def add_input(self, batch: DeviceBatch):
        self._buf.add(batch)

    def finish(self):
        batches = self._buf.restore_all()
        merged = concat_batches(batches) if batches else None
        if merged is None:
            raise RuntimeError("empty build side requires at least one "
                               "(possibly empty) batch")
        from velox_tpu.exec.jit_cache import cached_jit
        kf = tuple(self._key_fields)
        rng = self._array_range
        fn = cached_jit(("build_table", kf, rng),
                        lambda: jax.jit(lambda b: build_table(b, kf, rng)))
        return fn(merged)


_NEEDS_RIGHT_PHASE = (P.JoinType.RIGHT, P.JoinType.FULL,
                      P.JoinType.RIGHT_SEMI_FILTER)


def emit_right_phase(node: P.HashJoinNode, bt, matched) -> DeviceBatch:
    """Pure traced right-phase emission (matched/unmatched build rows) —
    module-level so the distributed path can vmap it over per-device
    partitioned tables (parallel/distributed.py)."""
    jt = node.join_type
    cap = bt.batch.capacity
    if jt is P.JoinType.RIGHT_SEMI_FILTER:
        mask = bt.batch.mask & matched
        out = DeviceBatch(dict(bt.batch.columns), mask)
    else:  # RIGHT / FULL: unmatched build rows with null probe side
        mask = bt.batch.mask & ~matched
        out_cols = {}
        lt = node.left.output_type()
        for name, dt in zip(lt.names, lt.children):
            out_cols[name] = DeviceColumn(
                jnp.zeros((cap,), dt.np_dtype()),
                jnp.zeros((cap,), bool), dt, None)
        out_cols.update(dict(bt.batch.columns))
        out = DeviceBatch(out_cols, mask)
    if node.output_columns:
        out = DeviceBatch(
            {n: out.columns[n] for n in node.output_columns}, out.mask)
    return out


class HashJoinOperator(Operator):
    """Probe-side operator; the Task feeds it a SortedBuild/BuiltTable
    first."""

    def __init__(self, node: P.HashJoinNode):
        super().__init__(node)
        self._node = node
        self._bt = None
        self._outputs: List[DeviceBatch] = []
        self._unique_build = True
        self._matched = None  # bool[build_cap] for right/full joins
        self._right_done = False

    def set_built_table(self, bt):
        jt = self._node.join_type
        self._bt = bt
        # static key ranges (union of both sides' plan-level stats) narrow
        # the merge-rank sort words (core/stats.py)
        from velox_tpu.core.stats import resolve_column_stats
        rngs = []
        for lk, rk in zip(self._node.left_keys, self._node.right_keys):
            a = resolve_column_stats(self._node.left, lk.name)
            b = resolve_column_stats(self._node.right, rk.name)
            rngs.append((min(a[0], b[0]), max(a[1], b[1]))
                        if a is not None and b is not None else None)
        self._join_key_ranges = tuple(rngs)
        # plan-level uniqueness proof skips a device round-trip per
        # join: a build keyed on a superset of a
        # provably-unique column has no dup keys
        from velox_tpu.core.stats import resolve_column_unique
        if any(resolve_column_unique(self._node.right, k.name)
               for k in self._node.right_keys):
            self._unique_build = True
        else:
            self._unique_build = not bool(jax.device_get(bt.has_dup_keys))
        if jt in _NEEDS_RIGHT_PHASE:
            self._matched = jnp.zeros((bt.batch.capacity,), bool)
        # probe programs cached across Task instances: the traced bodies
        # read only the plan node, node-derived ranges, and the two flags
        # in the key (exec/jit_cache.py)
        from velox_tpu.exec.jit_cache import cached_jit
        # _join_key_ranges in the key: the probe programs bake these
        # stats-derived ranges at trace time (jit_cache.py contract)
        key = (type(self).__name__, self._node, self._unique_build,
               isinstance(bt, SortedBuild), self._join_key_ranges)
        self._fast_fn = cached_jit(key + ("fast",),
                                   lambda: jax.jit(self._probe_fast))
        self._count_fn = cached_jit(key + ("count",),
                                    lambda: jax.jit(self._probe_counts))
        self._emit_fn = cached_jit(key + ("emit",),
                                   lambda: jax.jit(self._emit_chunk))

    # ---- table access (sorted vs scatter-probe) ------------------------------

    def _lookup(self, batch: DeviceBatch, bt):
        """Returns (probe_ok, loc, counts, hit).

        ``loc`` locates row matches: for SortedBuild it is the sorted-run
        start lo (match m of row r is build row perm[lo[r] + m]); for the
        hash fallback it is the slot. ``counts`` is matches per probe row.

        SortedBuild probes use a MERGE-RANK: one sort of the
        concatenated (build, probe) keys with a build-first tie-break, then
        dense cumulative counts give each probe row its [lo, hi) run of equal
        build keys — no binary search (``searchsorted`` is log2(N) serial
        gathers; chosen for the engine's first accelerator, not yet measured on
        the H100).
        """
        keys = _key_values(batch, self._node.left_keys)
        probe_ok = _usable(batch, keys)
        cap = batch.capacity
        if isinstance(bt, SortedBuild):
            if bt.arr_start is not None:
                # array mode: two int32 gathers into the dense domain
                # table (HashMode::kArray parity) — no per-batch sort
                domain = bt.arr_start.shape[0]
                k = keys[0].full_data(cap).astype(jnp.int64)
                norm = k - bt.arr_base
                in_range = (norm >= 0) & (norm < domain)
                idx = jnp.clip(norm, 0, domain - 1).astype(jnp.int32)
                lo = bt.arr_start[idx]
                counts = jnp.where(in_range, bt.arr_count[idx], 0)
                hit = probe_ok & (counts > 0)
                counts = jnp.where(hit, counts, 0)
                return probe_ok, lo, counts, hit
            lo, counts = self._merge_rank(batch, bt, keys, probe_ok)
            hit = probe_ok & (counts > 0)
            counts = jnp.where(hit, counts, 0)
            return probe_ok, jnp.clip(lo, 0, bt.perm.shape[0] - 1), \
                counts, hit
        slots, found = H.lookup(bt.table, keys, probe_ok, cap)
        slots = jnp.clip(slots, 0, bt.table.size - 1)
        hit = probe_ok & found
        counts = jnp.where(hit, bt.slot_count[slots], 0)
        return probe_ok, slots, counts, hit

    def _merge_rank(self, batch: DeviceBatch, bt, pkeys, probe_ok):
        """(lo, counts) per probe row: positions into the SORTED build
        (bt.perm space)."""
        from velox_tpu.exec.sort import radix_sort_perm, sort_words
        from velox_tpu.ops.wide import scatter_unique_set
        cap = batch.capacity
        bcap = bt.batch.capacity
        m = bcap + cap
        bkeys = _key_values(bt.batch, self._node.right_keys)
        busable = _usable(bt.batch, bkeys)
        both_ok = jnp.concatenate([busable, probe_ok])
        merged_keys = []
        for bv, pv in zip(bkeys, pkeys):
            from velox_tpu.vector import strings as S
            if S.is_raw(bv) or S.is_raw(pv):
                # raw string key: merge the byte matrices (dictionary /
                # constant sides convert via one device gather), padding
                # size classes to match
                from velox_tpu.functions.raw_strings import as_raw
                bb_, bl_, bval = as_raw(bv, bcap)
                pb_, pl_, pval = as_raw(pv, cap)
                w = max(bb_.shape[1], pb_.shape[1])
                if bb_.shape[1] < w:
                    bb_ = jnp.pad(bb_, ((0, 0), (0, w - bb_.shape[1])))
                if pb_.shape[1] < w:
                    pb_ = jnp.pad(pb_, ((0, 0), (0, w - pb_.shape[1])))
                data = jnp.concatenate([bb_, pb_])
                lens = jnp.concatenate([bl_, pl_])
                validity = None
                if bval is not None or pval is not None:
                    validity = jnp.concatenate([
                        bval if bval is not None
                        else jnp.ones((bcap,), bool),
                        pval if pval is not None
                        else jnp.ones((cap,), bool)])
                merged_keys.append(S.raw_value(data, lens, validity))
                continue
            want = bv.dtype.np_dtype()
            bd = bv.full_data(bcap).astype(want)
            pd_ = pv.full_data(cap).astype(want)
            data = jnp.concatenate([bd, pd_])
            validity = None
            if bv.validity is not None or pv.validity is not None:
                validity = jnp.concatenate(
                    [bv.full_validity(bcap), pv.full_validity(cap)])
            merged_keys.append(EvalValue(data, validity, bv.dtype,
                                         bv.dictionary))
        # source flag as a trailing 1-bit key: builds (False) sort before
        # probes (True) within equal keys
        src = jnp.concatenate([jnp.zeros((bcap,), bool),
                               jnp.ones((cap,), bool)])
        merged_keys.append(EvalValue(src, None, T.BOOLEAN))
        ranges = getattr(self, "_join_key_ranges", None)
        rng = (tuple(ranges) + (None,)) if ranges is not None else None
        words, bits = sort_words(merged_keys, None, m, both_ok,
                                 ranges=rng)
        from velox_tpu.exec.sort import (
            lane_bit_widths, lane_prefix_neq, sort_perm_key,
        )
        perm, skey = sort_perm_key(words, bits, m)
        is_build = (perm < bcap) & both_ok[perm]
        nb_before = jnp.cumsum(is_build.astype(jnp.int32)) - \
            is_build.astype(jnp.int32)
        # key-run starts from the SORTED lanes, dropping the trailing
        # 1-bit src word (which must not split runs) — no gather
        total = int(sum(bits))
        run_start = lane_prefix_neq(skey, lane_bit_widths(total),
                                    total - 1)
        # builds before the run start == builds with key < run key
        base = jnp.where(run_start, nb_before, jnp.int32(0))
        base = jax.lax.cummax(base)
        lo_m = base
        hi_m = nb_before
        # scatter probe rows' (lo, count) back to probe-row order
        probe_pos = jnp.where((perm >= bcap) & both_ok[perm],
                              perm - bcap, jnp.int32(cap))
        lo = scatter_unique_set(cap + 1, probe_pos, lo_m)[:cap]
        counts = scatter_unique_set(cap + 1, probe_pos,
                                    hi_m - lo_m)[:cap]
        return lo, counts

    def _build_row_at(self, bt, loc, within):
        """Build row id of match ``within`` at locator ``loc``."""
        if isinstance(bt, SortedBuild):
            idx = jnp.clip(loc + within, 0, bt.perm.shape[0] - 1)
            return bt.perm[idx]
        idx = jnp.clip(bt.slot_offset[loc] + within, 0,
                       bt.csr_rows.shape[0] - 1)
        return bt.csr_rows[idx]

    def _first_build_row(self, bt, loc):
        if isinstance(bt, SortedBuild):
            return bt.perm[loc]
        return bt.table.slot_row[loc]

    def _mark_matched(self, bt, loc, counts, hit):
        """bool[build_cap]: build rows matched by this probe batch."""
        bcap = bt.batch.capacity
        if isinstance(bt, SortedBuild):
            # difference array over sorted positions: +1 at lo, -1 at hi
            lo_w = jnp.where(hit, loc, jnp.int32(bcap))
            hi_w = jnp.where(hit, loc + counts, jnp.int32(bcap))
            diff = jnp.zeros((bcap + 1,), jnp.int32) \
                .at[lo_w].add(1, mode="drop") \
                .at[hi_w].add(-1, mode="drop")
            covered = jnp.cumsum(diff[:bcap]) > 0
            return jnp.zeros((bcap,), bool).at[bt.perm].set(covered)
        S = bt.table.size
        seg = jnp.where(hit, loc, jnp.int32(S))
        hits_per_slot = jax.ops.segment_max(
            hit.astype(jnp.int32), seg, num_segments=S + 1)[:S] > 0
        bkeys = _key_values(bt.batch, self._node.right_keys)
        busable = _usable(bt.batch, bkeys)
        bslots, bfound = H.lookup(bt.table, bkeys, busable,
                                  bt.batch.capacity)
        return busable & hits_per_slot[jnp.clip(bslots, 0, S - 1)]

    # ---- shared probe pieces -------------------------------------------------

    def _eval_filter(self, out: DeviceBatch, cap: int):
        f = ExprSet([self._node.filter], None).eval_batch(out)[0]
        passed = f.full_data(cap).astype(bool)
        if f.validity is not None:
            passed = passed & f.full_validity(cap)
        return passed

    def _project(self, out: DeviceBatch) -> DeviceBatch:
        if self._node.output_columns:
            out = DeviceBatch(
                {n: out.columns[n] for n in self._node.output_columns},
                out.mask)
        return out

    def _gather_build_cols(self, build: DeviceBatch, build_row,
                           null_out) -> Dict[str, DeviceColumn]:
        """Gather build columns at build_row; rows where null_out is True
        get NULL build values (left/full outer semantics). Only columns
        the join OUTPUTS (or its filter reads) are gathered."""
        from velox_tpu.exec.batch_utils import map_column_rows
        need = None
        if self._node.output_columns:
            from velox_tpu.core.expressions import referenced_fields
            need = set(self._node.output_columns)
            if self._node.filter is not None:
                need |= referenced_fields(self._node.filter)
        row = jnp.clip(build_row, 0, None)
        cols = {}
        for name, col in build.columns.items():
            if need is not None and name not in need:
                continue
            c = map_column_rows(col, lambda a: a[row])
            validity = c.validity
            if null_out is not None:
                validity = (~null_out if validity is None
                            else (validity & ~null_out))
            cols[name] = DeviceColumn(c.data, validity, c.dtype,
                                      c.dictionary, c.children, c.starts)
        return cols

    # ---- unique-build fast path (one program, no host sync) ------------------

    def _probe_fast(self, batch: DeviceBatch, bt):
        """Unique build keys AND no filter: emit directly."""
        node = self._node
        cap = batch.capacity
        if (isinstance(bt, SortedBuild) and bt.arr_row1 is not None
                and self._unique_build):
            # unique array-mode probe: ONE domain-table gather gives the
            # build row directly (arr_row1 = row + 1, 0 absent) — the
            # start/count/perm chain costs two more gathers
            keys = _key_values(batch, self._node.left_keys)
            probe_ok = _usable(batch, keys)
            domain = bt.arr_row1.shape[0]
            k = keys[0].full_data(cap).astype(jnp.int64)
            norm = k - bt.arr_base
            in_range = (norm >= 0) & (norm < domain)
            idx = jnp.clip(norm, 0, domain - 1).astype(jnp.int32)
            row1 = bt.arr_row1[idx]
            hit = probe_ok & in_range & (row1 > 0)
            build_row = row1 - 1
        else:
            probe_ok, loc, counts, hit = self._lookup(batch, bt)
            build_row = self._first_build_row(bt, loc)
        jt = node.join_type

        new_matched = None
        if self._matched is not None:
            pos = jnp.where(hit, jnp.clip(build_row, 0, None),
                            jnp.int32(bt.batch.capacity))
            new_matched = jnp.zeros((bt.batch.capacity,), bool) \
                .at[pos].set(True, mode="drop")

        if jt in (P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.RIGHT,
                  P.JoinType.FULL):
            out_cols = dict(batch.columns)
            null_out = None if jt is P.JoinType.INNER else ~hit
            out_cols.update(self._gather_build_cols(
                bt.batch, build_row, null_out))
            keep_all = jt in (P.JoinType.LEFT, P.JoinType.FULL)
            mask = batch.mask if keep_all else (batch.mask & hit)
            out = DeviceBatch(out_cols, mask)
        elif jt is P.JoinType.LEFT_SEMI_FILTER:
            out = batch.with_mask(batch.mask & hit)
        elif jt is P.JoinType.RIGHT_SEMI_FILTER:
            # probe side emits nothing; right phase emits matched build rows
            return None, new_matched
        elif jt is P.JoinType.ANTI:
            miss = batch.mask & ~hit
            if node.null_aware:
                miss = jnp.where(bt.has_null_key, jnp.zeros_like(miss),
                                 miss)
                miss = miss & probe_ok
            out = batch.with_mask(miss)
        else:
            raise NotImplementedError(f"join type {jt}")
        return self._project(out), new_matched

    # ---- expanding probe (count + emit chunks) -------------------------------

    def _probe_counts(self, batch: DeviceBatch, bt):
        """First pass of the general path (duplicate keys and/or filter):
        per-probe-row candidate counts + matched-build flags."""
        node = self._node
        probe_ok, loc, counts, hit = self._lookup(batch, bt)
        jt = node.join_type
        has_filter = node.filter is not None

        expand = jt in (P.JoinType.INNER, P.JoinType.RIGHT,
                        P.JoinType.LEFT, P.JoinType.FULL)
        # semi/anti with a filter need candidate expansion to evaluate it
        if has_filter and jt in (P.JoinType.LEFT_SEMI_FILTER,
                                 P.JoinType.RIGHT_SEMI_FILTER,
                                 P.JoinType.ANTI):
            expand = True

        new_matched = None
        if self._matched is not None and not has_filter:
            new_matched = self._mark_matched(bt, loc, counts, hit)

        if not expand:
            out, nm = self._probe_fast(batch, bt)
            return out, None, None, None, (new_matched if new_matched
                                           is not None else nm)
        exp_counts = counts
        if jt in (P.JoinType.LEFT, P.JoinType.FULL) and not has_filter:
            exp_counts = jnp.where(hit, counts, batch.mask.astype(jnp.int32))
        cum = jnp.cumsum(exp_counts.astype(jnp.int64))
        total = cum[-1]
        return None, (loc, hit), cum, total, new_matched

    def _emit_chunk(self, batch: DeviceBatch, bt, loc, hit, cum, start):
        """Materialize candidate rows [start, start+cap) of the expansion.

        Returns (out_batch, probe_row, build_row, passed, valid): when a
        filter is present the caller combines chunk results for outer/semi
        semantics; without one, out_batch is final (INNER/LEFT/FULL direct).
        """
        node = self._node
        cap = batch.capacity
        has_filter = node.filter is not None
        j = start + jnp.arange(cap, dtype=jnp.int64)
        total = cum[-1]
        valid = j < total
        # probe row for output j: first row whose inclusive cumsum > j
        row = jnp.searchsorted(cum, j, side="right").astype(jnp.int32)
        row_c = jnp.clip(row, 0, cap - 1)
        prev = cum[jnp.clip(row_c - 1, 0, None)]
        counts_r = cum[row_c] - jnp.where(row_c > 0, prev, 0)
        within = (j - (cum[row_c] - counts_r)).astype(jnp.int32)
        row_hit = hit[row_c]
        build_row = jnp.where(
            row_hit, self._build_row_at(bt, loc[row_c], within),
            jnp.int32(-1))
        # gather probe columns at row_c, build columns at build_row
        out_cols = {}
        from velox_tpu.exec.batch_utils import map_column_rows
        for name, col in batch.columns.items():
            out_cols[name] = map_column_rows(col, lambda a: a[row_c])
        null_out = None
        if node.join_type in (P.JoinType.LEFT, P.JoinType.FULL):
            null_out = ~row_hit
        out_cols.update(self._gather_build_cols(bt.batch, build_row,
                                                null_out))
        out = DeviceBatch(out_cols, valid)
        if not has_filter:
            return self._project(out), row_c, build_row, valid, valid
        passed = self._eval_filter(out, cap) & valid & row_hit
        out = out.with_mask(out.mask & passed)
        return self._project(out), row_c, build_row, passed, valid

    # ---- filtered-join orchestration (host side) ------------------------------

    def _probe_filtered(self, batch: DeviceBatch, bt, loc, hit, cum,
                        n_total: int):
        """Run the emit chunks, track per-probe-row / per-build-row filter
        passes, and emit join-type-correct output (velox HashProbe.cpp
        filter semantics for outer/semi/anti joins)."""
        node, jt = self._node, self._node.join_type
        cap = batch.capacity
        chunks = []
        row_pass = jnp.zeros((cap,), bool)   # probe rows w/ passing match
        bcap = bt.batch.capacity
        bld_pass = jnp.zeros((bcap,), bool)  # build rows w/ passing match

        if not hasattr(self, "_pass_fn"):
            @jax.jit
            def _acc(row_pass, bld_pass, row_c, build_row, passed):
                # sentinels derive from the argument shapes, not closed-over
                # capacities: probe batch capacity may vary between batches
                rp = row_pass.at[jnp.where(passed, row_c,
                                           row_pass.shape[0])] \
                    .max(True, mode="drop")
                bp = bld_pass.at[jnp.where(passed,
                                           jnp.clip(build_row, 0, None),
                                           bld_pass.shape[0])] \
                    .max(True, mode="drop")
                return rp, bp
            self._pass_fn = _acc

        for start in range(0, max(n_total, 1), cap):
            if n_total == 0:
                break
            out, row_c, build_row, passed, valid = self._emit_fn(
                batch, bt, loc, hit, cum, jnp.int64(start))
            row_pass, bld_pass = self._pass_fn(
                row_pass, bld_pass, row_c, build_row, passed)
            if jt in (P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.FULL,
                      P.JoinType.RIGHT):
                chunks.append(out)

        if self._matched is not None:
            self._matched = self._matched | bld_pass

        if jt in (P.JoinType.INNER, P.JoinType.RIGHT):
            self._outputs.extend(chunks)
            return
        if jt in (P.JoinType.LEFT, P.JoinType.FULL):
            self._outputs.extend(chunks)
            # probe rows with no passing candidate: one null-build row each
            if not hasattr(self, "_leftover_fn"):
                @jax.jit
                def _leftover(batch, bt, row_pass):
                    out_cols = dict(batch.columns)
                    fake = jnp.full((batch.capacity,), -1, jnp.int32)
                    out_cols.update(self._gather_build_cols(
                        bt.batch, fake,
                        jnp.ones((batch.capacity,), bool)))
                    return self._project(DeviceBatch(
                        out_cols, batch.mask & ~row_pass))
                self._leftover_fn = _leftover
            self._outputs.append(self._leftover_fn(batch, bt, row_pass))
            return
        if jt is P.JoinType.LEFT_SEMI_FILTER:
            self._outputs.append(self._project(
                batch.with_mask(batch.mask & row_pass)))
            return
        if jt is P.JoinType.RIGHT_SEMI_FILTER:
            return  # right phase emits self._matched rows
        if jt is P.JoinType.ANTI:
            if node.null_aware:
                raise NotImplementedError(
                    "filter on null-aware anti join")
            self._outputs.append(self._project(
                batch.with_mask(batch.mask & ~row_pass)))
            return
        raise NotImplementedError(f"filtered join type {jt}")

    # ---- right phase (unmatched / matched build rows) -------------------------

    def _emit_right_phase(self) -> Optional[DeviceBatch]:
        from velox_tpu.exec.jit_cache import cached_jit
        fn = cached_jit(
            ("right_phase", self._node),
            lambda: jax.jit(
                lambda bt, m: emit_right_phase(self._node, bt, m)))
        return fn(self._bt, self._matched)

    # ---- operator contract --------------------------------------------------

    def add_input(self, batch):
        assert self._bt is not None, "build side not finished"
        bt = self._bt
        jt = self._node.join_type
        has_filter = self._node.filter is not None
        needs_count_path = has_filter or ((not self._unique_build) and jt in (
            P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.RIGHT,
            P.JoinType.FULL, P.JoinType.RIGHT_SEMI_FILTER))
        if not needs_count_path and self._matched is None:
            out, _ = self._fast_fn(batch, bt)
            self._outputs.append(out)
            return
        if not needs_count_path:
            out, new_matched = self._fast_fn(batch, bt)
            if new_matched is not None:
                self._matched = self._matched | new_matched
            if out is not None:
                self._outputs.append(out)
            return
        out, loc_hit, cum, total, new_matched = self._count_fn(batch, bt)
        if new_matched is not None:
            self._matched = self._matched | new_matched
        if loc_hit is None:
            if out is not None:
                self._outputs.append(out)
            return
        loc, hit = loc_hit
        n_total = int(jax.device_get(total))
        cap = batch.capacity
        if has_filter:
            self._probe_filtered(batch, bt, loc, hit, cum, n_total)
            return
        for start in range(0, max(n_total, 1), cap):
            if n_total == 0:
                break
            out, _, _, _, _ = self._emit_fn(
                batch, bt, loc, hit, cum, jnp.int64(start))
            self._outputs.append(out)

    def no_more_input(self):
        super().no_more_input()
        if self._matched is not None and not self._right_done:
            self._right_done = True
            self._outputs.append(self._emit_right_phase())

    def device_state(self):
        return (self._outputs, self._matched)

    def get_output(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def needs_input(self):
        return not self._no_more_input and not self._outputs

    def is_finished(self):
        return self._no_more_input and not self._outputs


class MergeJoinOperator(HashJoinOperator):
    """Sorted-input join. Parity: ``velox/exec/MergeJoin.h:45``.

    With the build side already key-sorted, the table build is a
    stable compaction (build_sorted_table_presorted — no radix sort), and
    each probe is two binary searches over the packed build keys
    (log2(N) dense gathers) instead of the merge-rank sort the hash join
    uses for unsorted inputs. Probe-side sortedness is not required (each
    probe row looks up independently), so this also serves plans where only
    one side is sorted. All join types / filters / right phases inherit
    from HashJoinOperator."""

    def _lookup(self, batch: DeviceBatch, bt):
        keys = _key_values(batch, self._node.left_keys)
        probe_ok = _usable(batch, keys)
        cap = batch.capacity
        if isinstance(bt, SortedBuild):
            pk = pack_key_u64(keys, cap)
            lo = jnp.searchsorted(bt.sorted_key, pk,
                                  side="left").astype(jnp.int32)
            hi = jnp.searchsorted(bt.sorted_key, pk,
                                  side="right").astype(jnp.int32)
            # guard the U64_MAX-padded tail (a real key CAN pack to MAX):
            # clamp the run to the usable prefix so counts never cover
            # padding rows
            hi = jnp.minimum(hi, bt.n_usable.astype(hi.dtype))
            counts = hi - lo
            hit = probe_ok & (counts > 0) & (lo < bt.n_usable)
            counts = jnp.where(hit, counts, 0)
            return probe_ok, jnp.clip(lo, 0, bt.perm.shape[0] - 1), \
                counts, hit
        return super()._lookup(batch, bt)


class MergeBuildStage:
    """Accumulates the (pre-sorted) right side of a merge join; finish()
    validates the sort contract once and returns a SortedBuild."""

    def __init__(self, key_fields, offload_bytes=None, pool=None,
                 host_budget_bytes=None, spill_dir=None,
                 max_spill_bytes=None):
        from velox_tpu.common import metrics as M
        from velox_tpu.exec.memory import OffloadBuffer
        self._key_fields = list(key_fields)
        self._buf = OffloadBuffer(offload_bytes,
                                  metric_key=M.K_JOIN_BUILD_OFFLOADS,
                                  pool=pool,
                                  host_budget_bytes=host_budget_bytes,
                                  spill_dir=spill_dir,
                                  max_spill_bytes=max_spill_bytes)

    def add_input(self, batch: DeviceBatch):
        self._buf.add(batch)

    def finish(self):
        from velox_tpu.common.errors import VeloxRuntimeError
        batches = self._buf.restore_all()
        merged = concat_batches(batches) if batches else None
        if merged is None:
            raise RuntimeError("empty build side requires at least one "
                               "(possibly empty) batch")
        from velox_tpu.exec.jit_cache import cached_jit
        kf = tuple(self._key_fields)
        fn = cached_jit(
            ("build_presorted", kf),
            lambda: jax.jit(lambda b: (
                (t := build_sorted_table_presorted(b, kf)),
                presorted_is_sorted(t))))
        bt, ok = fn(merged)
        if not bool(jax.device_get(ok)):
            raise VeloxRuntimeError(
                "merge join right side is not sorted by the join keys")
        return bt
