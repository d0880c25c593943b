"""Distributed (multi-chip) plan execution over a jax.sharding.Mesh.

Role parity: the multi-task topology of the reference — N Driver threads
pulling splits (velox/exec/Task.h:166), LocalPartition/PartitionedOutput
exchanges between pipelines (SURVEY.md §2.9) — collapsed onto a device mesh:

* **split/data parallelism**: scan splits are grouped into waves of
  ``n_devices``; each wave is a stacked (n, cap) batch sharded on the mesh's
  data axis. Per-shard work (filter/project/partial agg/probe) runs as one
  vmapped jitted program — XLA SPMD partitions it with zero communication.
* **exchange**: aggregation finalization repartitions partial group states
  with an ICI ``all_to_all`` (exchange.py) so each device owns a hash range
  of the keys — the PartitionedOutput/Exchange analogue. Global (keyless)
  aggregates finalize with ``psum``/``pmax``/``pmin``.
* **broadcast join**: the build side is all_gather'd so every device probes
  a replicated table — the reference's broadcast-join strategy; partitioned
  joins ride the same all_to_all exchange.

The same code runs on a virtual CPU mesh (tests, dryrun) and real chips.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from velox_tpu import types as T
from velox_tpu import use_compile_cache
from velox_tpu.core import expressions as ex
from velox_tpu.core import plan as Pn
from velox_tpu.exec.aggregation import AggregationOperator
from velox_tpu.exec.batch_utils import concat_batches
from velox_tpu.exec.join import HashBuildStage, HashJoinOperator
from velox_tpu.exec.operator import FilterProjectOperator
from velox_tpu.exec.orderby import TopNOperator, sort_batch
from velox_tpu.expression.eval import value_from_column
from velox_tpu.parallel import exchange as X
from velox_tpu.parallel.mesh import DATA_AXIS, make_mesh
from velox_tpu.vector.device import DeviceBatch, DeviceColumn


def _pad_col_rows(c: DeviceColumn, cap: int) -> DeviceColumn:
    """Zero-pad a column's row axis (and row-aligned children) to cap."""
    from velox_tpu.exec.batch_utils import map_column_rows

    def pad(a):
        out = jnp.zeros((cap,) + a.shape[1:], a.dtype)
        return out.at[:a.shape[0]].set(a)

    return map_column_rows(c, pad)


def _stack_col(cs: List[DeviceColumn], stack) -> DeviceColumn:
    """Stack per-device columns, recursing into children. Element-space
    children (ARRAY/MAP) are padded to the wave's max element capacity
    so every shard shares one static shape."""
    children = ()
    if cs[0].children:
        kids = []
        for i in range(len(cs[0].children)):
            chs = [c.children[i] for c in cs]
            m = max(ch.data.shape[0] for ch in chs)
            chs = [ch if ch.data.shape[0] == m else _pad_col_rows(ch, m)
                   for ch in chs]
            kids.append(_stack_col(chs, stack))
        children = tuple(kids)
    data = stack([c.data for c in cs])
    validity = None
    if any(c.validity is not None for c in cs):
        validity = stack([
            c.validity if c.validity is not None
            else jnp.ones((c.data.shape[0],), bool)
            for c in cs])
    return DeviceColumn(data, validity, cs[0].dtype, cs[0].dictionary,
                        children)


def _stack_batches(batches: List[DeviceBatch], mesh: Mesh) -> DeviceBatch:
    """Stack per-device batches -> leading-axis-sharded stacked batch."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))

    def stack(arrs):
        return jax.device_put(jnp.stack(arrs), sharding)

    names = batches[0].names
    cols: Dict[str, DeviceColumn] = {}
    for name in names:
        cols[name] = _stack_col([b.columns[name] for b in batches], stack)
    mask = stack([b.mask for b in batches])
    return DeviceBatch(cols, mask)


def _zero_col(dt: T.DataType, capacity: int,
              dictionary=None) -> DeviceColumn:
    if dt.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP):
        kids = tuple(_zero_col(c, 1) for c in dt.children)
        return DeviceColumn(jnp.zeros((capacity,), jnp.int32), None, dt,
                            None, kids)
    if dt.kind is T.TypeKind.ROW:
        kids = tuple(_zero_col(c, capacity) for c in dt.children)
        return DeviceColumn(jnp.zeros((capacity,), jnp.int32), None, dt,
                            None, kids)
    children = ()
    if dt.is_long_decimal:
        children = (DeviceColumn(jnp.zeros((capacity,), jnp.int64), None,
                                 T.BIGINT, None),)
    return DeviceColumn(jnp.zeros((capacity,), dt.np_dtype()), None, dt,
                        dictionary, children)


def _empty_like_schema(row_type: T.DataType, capacity: int,
                       dictionaries) -> DeviceBatch:
    cols = {}
    for name, dt in zip(row_type.names, row_type.children):
        cols[name] = _zero_col(dt, capacity, dictionaries.get(name))
    return DeviceBatch(cols, jnp.zeros((capacity,), bool))


def _unstack(batch: DeviceBatch) -> DeviceBatch:
    """(n, cap) stacked batch -> flat (n*cap,) batch (host-side gather).
    Row-aligned children flatten along; columns with ELEMENT-SPACE
    children (ARRAY/MAP) cannot be row-flattened — DistributedTask.run
    extracts those per shard instead."""
    from velox_tpu.exec.batch_utils import map_column_rows

    def flat(a):
        return a.reshape((-1,) + a.shape[2:])

    cols = {n: map_column_rows(c, flat)
            for n, c in batch.columns.items()}
    return DeviceBatch(cols, flat(batch.mask))


class DistributedTask:
    """Executes one plan over all devices of a mesh.

    Parity: velox Task in parallel mode (Task::start, exec/Task.h:172) —
    drivers become mesh shards, exchanges become collectives.
    """

    def __init__(self, plan: Pn.PlanNode, mesh: Optional[Mesh] = None,
                 ctx=None):
        from velox_tpu.exec.task import QueryCtx
        use_compile_cache()
        self.plan = plan
        self.mesh = mesh or make_mesh()
        self.n = self.mesh.devices.size
        self.ctx = ctx or QueryCtx()

    # -- public ---------------------------------------------------------------

    def run(self):
        import pyarrow as pa
        from velox_tpu.vector.device import to_arrow
        complex_out = any(c.is_complex
                          for c in self.plan.output_type().children)
        if complex_out:
            # element-space children hold per-shard offsets: extract each
            # shard separately instead of flattening the row axis
            tables = []
            for b in self._run_node(self.plan):
                b = self._check_errors(b)
                n = b.mask.shape[0]
                for i in range(n):
                    shard = jax.tree_util.tree_map(lambda a: a[i], b)
                    tables.append(to_arrow(shard))
        else:
            tables = [to_arrow(_unstack(self._check_errors(b)))
                      for b in self._run_node(self.plan)]
        if not tables:
            schema = T.to_arrow(self.plan.output_type())
            return pa.table({n: pa.array([], type=f.type)
                             for n, f in zip(schema.names, schema)})
        return pa.concat_tables(tables)

    def _check_errors(self, b: DeviceBatch) -> DeviceBatch:
        """Surface checked-op error counts riding an output batch (the
        distributed analogue of Task.run's error fetch)."""
        if b.errors is None:
            return b
        total = int(np.asarray(jax.device_get(jnp.sum(b.errors))))
        if total:
            from velox_tpu.common.errors import VeloxUserError
            raise VeloxUserError(
                f"{total} row(s) failed a checked operation")
        return DeviceBatch(b.columns, b.mask)

    # -- plan walk (stacked (n, cap) batches, sharded on axis d) --------------

    def _run_node(self, node: Pn.PlanNode) -> Iterator[DeviceBatch]:
        if isinstance(node, Pn.TableScanNode):
            yield from self._run_scan(node)
        elif isinstance(node, Pn.ValuesNode):
            yield from self._run_values(node)
        elif isinstance(node, Pn.FilterNode):
            ot = node.output_type()
            identity = [ex.field(n, t) for n, t in zip(ot.names, ot.children)]
            op = FilterProjectOperator(node, node.predicate, ot.names,
                                       identity)
            yield from self._map_shards(node.source, op)
        elif isinstance(node, Pn.ProjectNode):
            op = FilterProjectOperator(node, None, node.names,
                                       list(node.expressions))
            yield from self._map_shards(node.source, op)
        elif isinstance(node, Pn.AggregationNode):
            yield from self._run_aggregation(node)
        elif isinstance(node, Pn.HashJoinNode):
            yield from self._run_join(node)
        elif isinstance(node, Pn.TopNNode):
            yield from self._run_topn(node)
        elif isinstance(node, (Pn.LocalPartitionNode,
                               Pn.PartitionedOutputNode)):
            yield from self._run_repartition(node)
        elif isinstance(node, Pn.OrderByNode):
            yield from self._run_orderby(node)
        elif isinstance(node, Pn.LimitNode):
            yield from self._run_limit(node)
        elif isinstance(node, Pn.WindowNode):
            yield from self._run_window(node)
        elif isinstance(node, Pn.UnnestNode):
            yield from self._run_unnest(node)
        elif isinstance(node, Pn.MarkDistinctNode):
            yield from self._run_markdistinct(node)
        elif isinstance(node, Pn.NestedLoopJoinNode):
            yield from self._run_nested_loop(node)
        elif isinstance(node, Pn.EnforceSingleRowNode):
            from velox_tpu.exec.misc_ops import EnforceSingleRowOperator
            # scalar-subquery guard: globally <= 1 row by construction
            yield from self._funnel_serial(
                EnforceSingleRowOperator(node), node.source)
        elif isinstance(node, Pn.MergeJoinNode):
            # distributed merge joins route through the hash-join
            # machinery (sortedness is a single-stream property; the
            # partitioned/broadcast exchanges do not preserve it)
            hj = Pn.HashJoinNode(
                node.id, left=node.left, right=node.right,
                join_type=node.join_type, left_keys=node.left_keys,
                right_keys=node.right_keys, filter=node.filter,
                output_columns=node.output_columns)
            yield from self._run_join(hj)
        else:
            raise NotImplementedError(
                f"distributed operator for {type(node).__name__}")

    def _funnel_serial(self, op, source_node) -> Iterator[DeviceBatch]:
        """Drive a SERIAL operator over the distributed source's
        unstacked waves, re-emitting outputs as one-active-shard stacked
        batches (the single-driver final-stage pattern — the reference
        likewise funnels stages whose parallel form does not exist)."""
        for stacked in self._run_node(source_node):
            op.add_input(_unstack(self._check_errors(stacked)))
            while True:
                o = op.get_output()
                if o is None:
                    break
                yield self._restack_one(o)
        op.no_more_input()
        while True:
            o = op.get_output()
            if o is None:
                break
            yield self._restack_one(o)

    def _restack_one(self, flat: DeviceBatch) -> DeviceBatch:
        return _stack_batches(
            [flat] + [flat.with_mask(jnp.zeros_like(flat.mask))
                      for _ in range(self.n - 1)], self.mesh)

    def _run_nested_loop(self, node) -> Iterator[DeviceBatch]:
        """Distributed nested-loop (cross/inequality) join: gather both
        the build side and each probe wave to a single flat stream and
        run the serial operator — NLJ shapes in practice are scalar-
        subquery joins (tiny sides), and the reference likewise funnels
        cross joins through one driver when one side is broadcast."""
        from velox_tpu.exec.batch_utils import concat_batches
        from velox_tpu.exec.misc_ops import NestedLoopJoinOperator
        builds = [_unstack(self._check_errors(b))
                  for b in self._run_node(node.right)]
        if not builds:
            raise RuntimeError("empty nested-loop build side")
        op = NestedLoopJoinOperator(node)
        op.set_build(concat_batches(builds))
        yield from self._funnel_serial(op, node.left)

    # -- sources ---------------------------------------------------------------

    def _run_scan(self, node: Pn.TableScanNode) -> Iterator[DeviceBatch]:
        from velox_tpu.connectors.connector import get_connector
        conn = get_connector(node.connector_id)
        # a full wave of splits per scan (one per device)
        self.ctx.config.setdefault("scan.splits_per_table", self.n)
        source = conn.create_data_source(node.table, node.columns, self.ctx)
        splits = self.ctx.get(f"splits.{node.id}") \
            or conn.default_splits(node.table, self.ctx)
        dicts = source.dictionaries()

        filter_op = None
        if node.filter is not None:
            ot = node.output_type()
            identity = [ex.field(n, t) for n, t in zip(ot.names, ot.children)]
            filter_op = FilterProjectOperator(node, node.filter, ot.names,
                                              identity)

        for lo in range(0, len(splits), self.n):
            wave = splits[lo:lo + self.n]
            batches = []
            for s in wave:
                parts = []
                while True:
                    b = source.next(s)
                    if b is None:
                        break
                    parts.append(b)
                if len(parts) == 1:
                    batches.append(parts[0])
                elif parts:
                    batches.append(concat_batches(parts))
            if not batches:
                continue
            cap = batches[0].capacity
            while len(batches) < self.n:
                batches.append(_empty_like_schema(
                    node.output_type(), cap, dicts))
            stacked = _stack_batches(batches, self.mesh)
            if filter_op is not None:
                stacked = self._vmapped(filter_op)(stacked)
            yield stacked

    def _run_values(self, node: Pn.ValuesNode) -> Iterator[DeviceBatch]:
        from velox_tpu.vector.device import from_arrow
        tables = list(node.tables)
        for lo in range(0, len(tables), self.n):
            wave = tables[lo:lo + self.n]
            batches = [t if isinstance(t, DeviceBatch) else from_arrow(t)
                       for t in wave]
            cap = max(b.capacity for b in batches)
            batches = [b if b.capacity == cap else _pad_batch(b, cap)
                       for b in batches]
            while len(batches) < self.n:
                batches.append(_empty_like_schema(node.row_type, cap, {}))
            yield _stack_batches(batches, self.mesh)

    # -- per-shard map ----------------------------------------------------------

    def _cjit(self, key, make):
        """Cross-task cache of mesh programs (exec/jit_cache.py): keyed
        by mesh identity + site key so repeated DistributedTasks skip
        re-lowering their shard_map/vmap programs. ONLY for functions
        whose device inputs all arrive as ARGUMENTS — a closure over a
        device array would pin the first task's data."""
        from velox_tpu.exec.jit_cache import cached_jit
        mk = (tuple(str(d) for d in self.mesh.devices.flat),
              tuple(self.mesh.axis_names))
        return cached_jit(("dist", mk) + key, make)

    def _vmapped(self, op) -> "callable":
        fn = op._fn if isinstance(op, FilterProjectOperator) else op
        if isinstance(op, FilterProjectOperator):
            return self._cjit(
                ("vmap_fp", op.node, op._filter, tuple(op._names),
                 tuple(op._projections)),
                lambda: jax.jit(jax.vmap(fn)))
        return jax.jit(jax.vmap(fn))

    def _map_shards(self, source: Pn.PlanNode, op) -> Iterator[DeviceBatch]:
        fn = self._vmapped(op)
        for stacked in self._run_node(source):
            yield fn(stacked)

    # -- aggregation -------------------------------------------------------------

    def _run_aggregation(self, node: Pn.AggregationNode
                         ) -> Iterator[DeviceBatch]:
        op = AggregationOperator(node)
        if not node.grouping_keys:
            yield self._run_global_aggregation(node, op)
            return
        ck = op._cross_task_key

        def _avjit(tag, fn):
            if ck is None:
                return jax.jit(jax.vmap(fn))
            return self._cjit(("agg", tag) + ck,
                              lambda: jax.jit(jax.vmap(fn)))
        partial_fn = _avjit("partial", op._partial_step)
        partials: List[DeviceBatch] = []
        for stacked in self._run_node(node.source):
            partials.append(partial_fn(stacked))
        if not partials:
            return
        # local merge of all partial waves (per device, no communication)
        merged = _avjit("compact", lambda b: op._compact_step(b))(
            _concat_stacked(partials))
        # exchange so each device owns hash-range of keys (count-based
        # window), then finalize per device
        key_names = [k.name for k in node.grouping_keys]
        window = self._count_window(merged, key_names)
        resharded = self._reshard(merged, key_names, window)
        yield _avjit("merge", op._merge_step)(resharded)

    def _run_global_aggregation(self, node, op) -> DeviceBatch:
        # per-shard accumulation then cross-device reduction of state
        raw = node.step in (Pn.AggregationStep.PARTIAL,
                            Pn.AggregationStep.SINGLE)
        from velox_tpu.functions.aggregates import AggregateFunction
        simple = (not op._collect_mode and all(
            type(a).map_raw is not AggregateFunction.map_raw
            and all(st.width == 1 for st in a.states)
            and all(st.combine in ("sum", "min", "max")
                    for st in a.states)
            for a in op._aggs))
        if not simple:
            # states the scalar sum/min/max reduction cannot combine
            # (planar long-decimal limbs, collect/percentile states):
            # funnel to the serial operator — the same single-driver
            # final step the reference uses for global aggregates
            for stacked in self._run_node(node.source):
                op.add_input(_unstack(self._check_errors(stacked)))
            op.no_more_input()
            out = op.get_output()
            return _stack_batches([out] + [
                out.with_mask(jnp.zeros_like(out.mask))
                for _ in range(self.n - 1)], self.mesh)

        def local_state(stacked: DeviceBatch):
            def one(batch):
                _, addends, _ = op._eval_keys_and_addends(batch, raw)
                outs = []
                for (data, combine) in addends:
                    if combine == "sum":
                        outs.append(jnp.sum(data))
                    elif combine == "min":
                        outs.append(jnp.min(data))
                    else:
                        outs.append(jnp.max(data))
                return outs
            return jax.vmap(one)(stacked)  # [n_states] of (n,)

        if op._cross_task_key is not None:
            fn = self._cjit(("agg", "global") + op._cross_task_key,
                            lambda: jax.jit(local_state))
        else:
            fn = jax.jit(local_state)
        combines = [st.combine for agg in op._aggs for st in agg.states]
        total: Optional[List] = None
        for stacked in self._run_node(node.source):
            states = fn(stacked)
            if total is None:
                total = states
            else:
                total = [
                    t + s if c == "sum"
                    else (jnp.minimum(t, s) if c == "min"
                          else jnp.maximum(t, s))
                    for t, s, c in zip(total, states, combines)]
        if total is None:
            op._accumulate_empty_global()
        else:
            # reduce the per-device partials (device-count-sized, tiny)
            op._global_state = [
                jnp.sum(t) if c == "sum"
                else (jnp.min(t) if c == "min" else jnp.max(t))
                for t, c in zip(total, combines)]
        out = op._extract_global()
        return _stack_batches([out] + [
            out.with_mask(jnp.zeros_like(out.mask))
            for _ in range(self.n - 1)], self.mesh)

    # -- exchange helpers (two-phase count-based windows) ----------------------

    def _count_window(self, stacked: DeviceBatch, key_names) -> int:
        """Host-synced max per-destination count -> pow2 static window.
        The flow-control replacement for OutputBuffer credits/acks
        (velox/exec/OutputBuffer.h:157): one count program + one host read
        sizes the exchange instead of worst-case window = capacity."""
        n = self.n

        def _mk():
            def cmax(local):
                m = X.partition_max_count(_squeeze0(local), list(key_names),
                                          n)
                return jax.lax.pmax(m, DATA_AXIS)
            return jax.jit(jax.shard_map(
                cmax, mesh=self.mesh, in_specs=P(DATA_AXIS),
                out_specs=P(), check_vma=False))
        fn = self._cjit(("cw", tuple(key_names)), _mk)
        return X.window_for(int(jax.device_get(fn(stacked))))

    def _reshard(self, stacked: DeviceBatch, key_names,
                 window: int, spread_hot=None) -> DeviceBatch:
        """all_to_all repartition by key hash with a static window
        (programs cached per (keys, window) — windows are pow2-quantized
        so the compile count stays bounded). ``spread_hot`` (bool[n])
        round-robins rows of hot destinations (skew key-splitting)."""
        n = self.n

        def _mk():
            if spread_hot is None:
                def repart(local):
                    local = _squeeze0(local)
                    out = X.repartition_all_to_all(
                        local, list(key_names), n, DATA_AXIS, window)
                    return _expand0(out)
                return jax.jit(jax.shard_map(
                    repart, mesh=self.mesh, in_specs=P(DATA_AXIS),
                    out_specs=P(DATA_AXIS), check_vma=False))

            def repart_s(local, h):
                local = _squeeze0(local)
                out = X.repartition_all_to_all(
                    local, list(key_names), n, DATA_AXIS, window,
                    spread_hot=h)
                return _expand0(out)
            return jax.jit(jax.shard_map(
                repart_s, mesh=self.mesh,
                in_specs=(P(DATA_AXIS), P()),
                out_specs=P(DATA_AXIS), check_vma=False))
        fn = self._cjit(
            ("rs", tuple(key_names), window, spread_hot is not None), _mk)
        return fn(stacked) if spread_hot is None else fn(stacked,
                                                         spread_hot)

    def _global_histogram(self, stacked: DeviceBatch, key_names):
        """np.int array[n]: GLOBAL rows per destination (one small fetch)."""
        n = self.n

        def _mk():
            def hist(local):
                return X.partition_histogram(_squeeze0(local),
                                             list(key_names), n, DATA_AXIS)
            return jax.jit(jax.shard_map(
                hist, mesh=self.mesh, in_specs=P(DATA_AXIS),
                out_specs=P(), check_vma=False))
        fn = self._cjit(("gh", tuple(key_names)), _mk)
        return np.asarray(jax.device_get(fn(stacked)))

    def _count_window_spread(self, stacked: DeviceBatch, key_names,
                             hot) -> int:
        n = self.n

        def _mk():
            def cmax(local, h):
                m = X.partition_max_count_spread(
                    _squeeze0(local), list(key_names), n, DATA_AXIS, h)
                return jax.lax.pmax(m, DATA_AXIS)
            return jax.jit(jax.shard_map(
                cmax, mesh=self.mesh, in_specs=(P(DATA_AXIS), P()),
                out_specs=P(), check_vma=False))
        fn = self._cjit(("cws", tuple(key_names)), _mk)
        return X.window_for(int(jax.device_get(fn(stacked, hot))))

    def _augment_build_with_hot(self, node, stacked_build, resharded_b,
                                hot):
        """Key-splitting build side: drop hot-range rows from each local
        partition and append the all_gathered union of every device's
        hot-range rows, then rebuild per-device tables. Paired with
        spread probes so every spread probe row finds its build rows
        locally (no double counting: the local copies are removed)."""
        from velox_tpu.exec import join as J
        n = self.n
        rnames = [k.name for k in node.right_keys]
        hist = self._global_histogram(stacked_build, rnames)
        hot_np = np.asarray(jax.device_get(hot))
        total_hot = int(hist[hot_np].sum()) if hot_np.any() else 0
        wh = X.window_for(max(1, total_hot), floor=128)

        def aug(local_part, local_orig, h):
            lp = _squeeze0(local_part)
            lo = _squeeze0(local_orig)
            keys = [value_from_column(lp.columns[k]) for k in rnames]
            dest = X.partition_ids(keys, lp.capacity, n)
            keep = lp.mask & ~h[jnp.clip(dest, 0, n - 1)]
            lp2 = lp.with_mask(keep)
            g = X.gather_hot_rows(lo, rnames, n, DATA_AXIS, h, wh)
            merged = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=0), lp2, g)
            return _expand0(merged)

        fn = self._cjit(("aug", node, wh), lambda: jax.jit(jax.shard_map(
            aug, mesh=self.mesh,
            in_specs=(P(DATA_AXIS), P(DATA_AXIS), P()),
            out_specs=P(DATA_AXIS), check_vma=False)))
        merged = fn(resharded_b, stacked_build, hot)
        bt = self._cjit(("build_vmap", node), lambda: jax.jit(jax.vmap(
            lambda b: J.build_table(b, tuple(node.right_keys)))))(merged)
        has_null = bool(jax.device_get(jnp.any(bt.has_null_key)))
        return bt._replace(has_null_key=jnp.broadcast_to(
            jnp.asarray(has_null), bt.has_null_key.shape))

    # -- join ---------------------------------------------------------------------

    def _run_join(self, node: Pn.HashJoinNode) -> Iterator[DeviceBatch]:
        """Distributed hash join with a broadcast/partition cost decision
        (parity: the reference host engines' broadcast-vs-partitioned
        strategy over PartitionedOutput, velox/exec/PartitionedOutput.h:149).
        Build sides up to the broadcast threshold replicate via all_gather;
        larger builds hash-partition BOTH sides so per-device HBM holds
        only 1/n of the table."""
        if node.filter is not None \
                and node.join_type is not Pn.JoinType.INNER:
            # filtered outer/semi/anti joins: the filter pass tracks
            # per-probe-row AND per-build-row pass flags across emit
            # chunks (exec/join.py _probe_filtered) — host-orchestrated
            # state that has no vmapped form yet. Funnel through the
            # serial operator (single-driver final stage; correct, not
            # scaled — the parallel form is future work).
            from velox_tpu.exec.join import HashBuildStage, HashJoinOperator
            build = HashBuildStage(node.right_keys)
            for b in self._run_node(node.right):
                build.add_input(_unstack(self._check_errors(b)))
            probe = HashJoinOperator(node)
            probe.set_built_table(build.finish())
            yield from self._funnel_serial(probe, node.left)
            return
        build_parts = [b for b in self._run_node(node.right)]
        if not build_parts:
            raise RuntimeError("empty build side")
        stacked_build = _concat_stacked(build_parts)
        from velox_tpu.core.config import QueryConfig as QC
        from velox_tpu.exec.memory import batch_nbytes
        thr = self.ctx.query_config.get_int(
            QC.JOIN_BROADCAST_THRESHOLD, 128 << 20)
        if batch_nbytes(stacked_build) <= thr:
            yield from self._run_broadcast_join(node, stacked_build)
        else:
            yield from self._run_partitioned_join(node, stacked_build)

    def _run_partitioned_join(self, node: Pn.HashJoinNode,
                              stacked_build: DeviceBatch
                              ) -> Iterator[DeviceBatch]:
        from velox_tpu.exec import join as J
        n = self.n
        jt = node.join_type
        if node.filter is not None and jt is not Pn.JoinType.INNER:
            raise NotImplementedError(
                "distributed join filter on non-inner joins")
        rnames = [k.name for k in node.right_keys]
        lnames = [k.name for k in node.left_keys]
        bwin = self._count_window(stacked_build, rnames)
        resharded_b = self._reshard(stacked_build, rnames, bwin)
        bt = self._cjit(("build_vmap", node), lambda: jax.jit(jax.vmap(
            lambda b: J.build_table(b, tuple(node.right_keys)))))(
                resharded_b)
        # globalize the null-key flag: null-aware anti must see nulls that
        # landed on ANY device
        has_null = bool(jax.device_get(jnp.any(bt.has_null_key)))
        bt = bt._replace(has_null_key=jnp.broadcast_to(
            jnp.asarray(has_null), bt.has_null_key.shape))
        probe = HashJoinOperator(node)
        probe._bt = bt
        probe._unique_build = not bool(
            jax.device_get(jnp.any(bt.has_dup_keys)))
        track = jt in J._NEEDS_RIGHT_PHASE
        # bt.batch is stacked (n, bcap): vmapped probes see (bcap,) slices
        bcap = int(bt.batch.mask.shape[1])
        matched = jnp.zeros((n, bcap), bool) if track else None
        if track:
            # the traced probe branches on `self._matched is not None`
            probe._matched = jnp.zeros((bcap,), bool)
        has_filter = node.filter is not None
        needs_expand = has_filter or ((not probe._unique_build) and jt in (
            Pn.JoinType.INNER, Pn.JoinType.LEFT, Pn.JoinType.RIGHT,
            Pn.JoinType.FULL, Pn.JoinType.RIGHT_SEMI_FILTER))

        pk = ("dprobe", node, probe._unique_build, track)
        fast_fn = self._cjit(pk + ("fast",),
                             lambda: jax.jit(jax.vmap(probe._probe_fast)))
        count_fn = self._cjit(pk + ("count",),
                              lambda: jax.jit(jax.vmap(probe._probe_counts)))
        emit_fn = self._cjit(pk + ("emit",), lambda: jax.jit(jax.vmap(
            probe._emit_chunk, in_axes=(0, 0, 0, 0, 0, None))))
        # skew handling (SURVEY §7.2 step 7): EVERY probe wave recomputes
        # the cheap global histogram; the hot set is the UNION of all
        # waves' hot destinations, and the build re-augments whenever a
        # later wave introduces NEW hot keys (round 4 — the set used to
        # freeze at first detection, so a second hot key saw no
        # splitting). Re-augmentation rebuilds from the ORIGINAL build
        # partitions, so it is idempotent over the accumulated set.
        # Right-phase joins are excluded (replicated build rows would
        # need cross-device matched merges).
        skew_ok = not track
        from velox_tpu.core.config import QueryConfig as QC
        skew_factor = self.ctx.query_config.get_int(
            QC.SKEW_FACTOR, 4)
        hot = None          # device bool[n] when skew detected
        hot_acc = None      # np bool[n]: union over waves
        bt_aug = bt         # build table, re-augmented as the set grows
        for stacked in self._run_node(node.left):
            if skew_ok:
                hist = self._global_histogram(stacked, lnames)
                mean = max(1, int(hist.sum()) // n)
                wave_hot = hist > skew_factor * mean
                if wave_hot.any() and (
                        hot_acc is None or (wave_hot & ~hot_acc).any()):
                    from velox_tpu.common import metrics as M
                    M.record_counter(M.K_SKEW_SPLITS)
                    hot_acc = (wave_hot if hot_acc is None
                               else (hot_acc | wave_hot))
                    hot = jnp.asarray(hot_acc)
                    bt_aug = self._augment_build_with_hot(
                        node, stacked_build, resharded_b, hot)
            if hot is not None:
                pwin = self._count_window_spread(stacked, lnames, hot)
                sp = self._reshard(stacked, lnames, pwin, spread_hot=hot)
                bt_use = bt_aug
            else:
                pwin = self._count_window(stacked, lnames)
                sp = self._reshard(stacked, lnames, pwin)
                bt_use = bt
            bt = bt_use
            if not needs_expand:
                out, nm = fast_fn(sp, bt)
                if track and nm is not None:
                    matched = matched | nm
                if out is not None:
                    yield out
                continue
            out, loc_hit, cum, total, nm = count_fn(sp, bt)
            if track and nm is not None:
                matched = matched | nm
            if loc_hit is None:
                if out is not None:
                    yield out
                continue
            loc, hit = loc_hit
            n_total = int(jax.device_get(jnp.max(total)))
            cap = sp.mask.shape[1]
            for start in range(0, max(n_total, 1), cap):
                if n_total == 0:
                    break
                emitted, _, _, _, _ = emit_fn(sp, bt, loc, hit, cum,
                                              jnp.int64(start))
                yield emitted
        if track:
            # build rows are PARTITIONED (each device owns its hash range)
            # so the right phase is per-device complete — no cross-device
            # matched merge needed (unlike broadcast)
            yield self._cjit(("dright", node), lambda: jax.jit(jax.vmap(
                lambda b, m: J.emit_right_phase(node, b, m))))(bt, matched)

    def _run_broadcast_join(self, node: Pn.HashJoinNode,
                            stacked_build: DeviceBatch
                            ) -> Iterator[DeviceBatch]:
        # broadcast join: gather the distributed build side onto every
        # device, build a replicated table, probe shards locally.
        n = self.n

        def gather(local):
            return _expand0(X.broadcast_gather(_squeeze0(local), n,
                                               DATA_AXIS))

        gathered = self._cjit(("bgather",), lambda: jax.jit(
            jax.shard_map(
                gather, mesh=self.mesh, in_specs=P(DATA_AXIS),
                out_specs=P(DATA_AXIS), check_vma=False)))(stacked_build)
        # every shard now holds the full build side: build once on shard 0's
        # copy (they are identical) and share the table.
        build_stage = HashBuildStage(node.right_keys)
        build_stage.add_input(_take0(gathered))
        table = build_stage.finish()

        probe = HashJoinOperator(node)
        probe.set_built_table(table)
        jt = node.join_type
        track = probe._matched is not None  # right/full/right-semi
        matched = None  # (n_shards, build_cap) bool, ORed across waves

        def _acc(m, nm):
            return nm if m is None else (m | nm)

        has_filter = node.filter is not None
        if has_filter and jt is not Pn.JoinType.INNER:
            raise NotImplementedError(
                "distributed join filter on non-inner joins")
        needs_expand = has_filter or ((not probe._unique_build) and jt in (
            Pn.JoinType.INNER, Pn.JoinType.LEFT, Pn.JoinType.RIGHT,
            Pn.JoinType.FULL, Pn.JoinType.RIGHT_SEMI_FILTER))
        if not needs_expand:
            pk = ("bprobe", node, probe._unique_build, track,
                  probe._join_key_ranges)
            probe_fn = self._cjit(pk + ("fast",), lambda: jax.jit(jax.vmap(
                probe._probe_fast, in_axes=(0, None))))
            for stacked in self._run_node(node.left):
                out, nm = probe_fn(stacked, table)
                if track:
                    matched = _acc(matched, nm)
                if out is not None:
                    yield out
        else:
            # duplicate-key expanding probe: vmapped count phase, then
            # emit chunks sized by the worst shard (one sync per wave)
            pk = ("bprobe", node, probe._unique_build, track,
                  probe._join_key_ranges)
            count_fn = self._cjit(pk + ("count",), lambda: jax.jit(jax.vmap(
                probe._probe_counts, in_axes=(0, None))))
            emit_fn = self._cjit(pk + ("emit",), lambda: jax.jit(jax.vmap(
                lambda b, t, slots, hit, cum, start: probe._emit_chunk(
                    b, t, slots, hit, cum, start),
                in_axes=(0, None, 0, 0, 0, None))))
            for stacked in self._run_node(node.left):
                out, slot_hit, cum, total, nm = count_fn(stacked, table)
                if track:
                    matched = _acc(matched, nm)
                if slot_hit is None:
                    if out is not None:
                        yield out
                    continue
                slots, hit = slot_hit
                n_total = int(jax.device_get(jnp.max(total)))
                cap = stacked.mask.shape[1]
                for start in range(0, max(n_total, 1), cap):
                    if n_total == 0:
                        break
                    emitted, _, _, _, _ = emit_fn(
                        stacked, table, slots, hit, cum, jnp.int64(start))
                    yield emitted
        if track:
            # merge matched flags across shards (build is replicated) and
            # emit the right phase once
            probe._matched = jnp.any(matched, axis=0) if matched is not None \
                else jnp.zeros((table.batch.capacity,), bool)
            right = probe._emit_right_phase()
            empties = [right.with_mask(jnp.zeros_like(right.mask))
                       for _ in range(self.n - 1)]
            yield _stack_batches([right] + empties, self.mesh)

    # -- topN ----------------------------------------------------------------------

    def _run_topn(self, node: Pn.TopNNode) -> Iterator[DeviceBatch]:
        op = TopNOperator(node)
        merge_fn = None
        buf: Optional[DeviceBatch] = None
        for stacked in self._run_node(node.source):
            if merge_fn is None:
                merge_fn = jax.jit(jax.vmap(op._merge_fn))
            buf = merge_fn(buf, stacked) if buf is not None else \
                merge_fn(None, stacked)
        if buf is None:
            return
        # gather per-device top-k candidates, final top-k on one pass
        n = self.n
        keys, orders, count = list(node.keys), list(node.orders), node.count

        def final(local):
            local = _squeeze0(local)
            allb = X.broadcast_gather(local, n, DATA_AXIS)
            s = sort_batch(allb, keys, orders)
            iota = jnp.arange(s.capacity, dtype=jnp.int32)
            keep = s.mask & (jnp.cumsum(s.mask.astype(jnp.int32))
                             <= count)
            # only device 0 emits
            dev = jax.lax.axis_index(DATA_AXIS)
            keep = keep & (dev == 0)
            return _expand0(s.with_mask(keep))

        fin = jax.jit(
            jax.shard_map(final, mesh=self.mesh, in_specs=P(DATA_AXIS),
                          out_specs=P(DATA_AXIS), check_vma=False))
        yield fin(buf)

    # -- orderby / limit / window -------------------------------------------------

    def _run_orderby(self, node: Pn.OrderByNode) -> Iterator[DeviceBatch]:
        """Distributed ORDER BY: final sort on one device after a gather.
        Parity: Presto/velox final ORDER BY stages are single-driver merges
        of partial-sorted streams (exec/Merge.h) — here the gather is the
        exchange and one sort replaces the k-way merge."""
        from velox_tpu.exec.orderby import _key_ranges
        waves = list(self._run_node(node.source))
        if not waves:
            return
        merged = _concat_stacked(waves)
        keys, orders = list(node.keys), list(node.orders)
        rngs = _key_ranges(node, keys)
        n = self.n

        def final(local):
            local = _squeeze0(local)
            allb = X.broadcast_gather(local, n, DATA_AXIS)
            s = sort_batch(allb, keys, orders, rngs)
            dev = jax.lax.axis_index(DATA_AXIS)
            return _expand0(s.with_mask(s.mask & (dev == 0)))

        fn = jax.jit(jax.shard_map(
            final, mesh=self.mesh, in_specs=P(DATA_AXIS),
            out_specs=P(DATA_AXIS), check_vma=False))
        yield fn(merged)

    def _run_limit(self, node: Pn.LimitNode) -> Iterator[DeviceBatch]:
        """Distributed LIMIT/OFFSET: global row positions via an
        all_gather of per-device counts (no data movement; parity:
        velox/exec/Limit.h over a gather exchange)."""
        n = self.n
        off, cnt = node.offset, node.count

        def step(local, seen):
            local = _squeeze0(local)
            c = jnp.sum(local.mask.astype(jnp.int64))
            counts = jax.lax.all_gather(c, DATA_AXIS)
            dev = jax.lax.axis_index(DATA_AXIS)
            before = jnp.sum(jnp.where(
                jnp.arange(n) < dev, counts, jnp.int64(0)))
            prefix = jnp.cumsum(local.mask.astype(jnp.int64)) - 1
            pos = seen + before + prefix
            keep = local.mask & (pos >= off) & (pos < off + cnt)
            return _expand0(local.with_mask(keep)), seen + jnp.sum(counts)

        fn = jax.jit(jax.shard_map(
            step, mesh=self.mesh, in_specs=(P(DATA_AXIS), P()),
            out_specs=(P(DATA_AXIS), P()), check_vma=False))
        seen = jnp.zeros((), jnp.int64)
        for stacked in self._run_node(node.source):
            out, seen = fn(stacked, seen)
            yield out

    def _run_window(self, node: Pn.WindowNode) -> Iterator[DeviceBatch]:
        """Distributed window: reshard by partition keys so each device
        owns whole partitions, then the serial sort-based window build runs
        per shard (exec/window.py). A window with no partition keys is one
        global partition: gather + compute on device 0."""
        from velox_tpu.exec.window import WindowOperator
        op = WindowOperator(node)
        waves = list(self._run_node(node.source))
        if not waves:
            return
        merged = _concat_stacked(waves)
        key_names = [k.name for k in node.partition_keys]
        if key_names:
            window = self._count_window(merged, key_names)
            resharded = self._reshard(merged, key_names, window)
            yield jax.jit(jax.vmap(op._compute))(resharded)
            return
        n = self.n

        def final(local):
            local = _squeeze0(local)
            allb = X.broadcast_gather(local, n, DATA_AXIS)
            out = op._compute(allb)
            dev = jax.lax.axis_index(DATA_AXIS)
            return _expand0(out.with_mask(out.mask & (dev == 0)))

        fn = jax.jit(jax.shard_map(
            final, mesh=self.mesh, in_specs=P(DATA_AXIS),
            out_specs=P(DATA_AXIS), check_vma=False))
        yield fn(merged)

    def _run_unnest(self, node: "Pn.UnnestNode") -> Iterator[DeviceBatch]:
        """Unnest is row-local: vmap the serial operator's traced program
        over shards — no data movement (parity: velox/exec/Unnest.h runs
        per driver)."""
        from velox_tpu.exec.misc_ops import UnnestOperator
        op = UnnestOperator(node)
        fn = jax.jit(jax.vmap(op._run))
        for stacked in self._run_node(node.source):
            yield fn(stacked)

    def _run_markdistinct(self, node: "Pn.MarkDistinctNode"
                          ) -> Iterator[DeviceBatch]:
        """Global distinct marking: reshard each wave by the distinct
        keys (hash placement is deterministic, so equal keys land on the
        same device in every wave), then the streaming per-device hash
        insert runs with its table carried between waves (parity:
        velox/exec/MarkDistinct.h over a hash exchange)."""
        from velox_tpu.exec.misc_ops import MarkDistinctOperator
        op = MarkDistinctOperator(node)
        key_names = [k.name for k in node.distinct_keys]
        if not hasattr(self, "_fn_cache"):
            self._fn_cache = {}
        table = None
        for stacked in self._run_node(node.source):
            window = self._count_window(stacked, key_names)
            resharded = self._reshard(stacked, key_names, window)
            if table is None:
                out, table = jax.jit(jax.vmap(
                    lambda b: op._step(b, None)))(resharded)
            else:
                key = ("md", node.id)
                fn = self._fn_cache.get(key)
                if fn is None:
                    fn = jax.jit(jax.vmap(op._step))
                    self._fn_cache[key] = fn
                out, table = fn(resharded, table)
            yield out

    # -- repartition ------------------------------------------------------------------

    def _run_repartition(self, node) -> Iterator[DeviceBatch]:
        key_names = [k.name if isinstance(k, ex.FieldAccess) else None
                     for k in node.keys]
        if not key_names or any(k is None for k in key_names):
            # gather / round-robin kinds: pass through (already sharded)
            yield from self._run_node(node.source)
            return
        for stacked in self._run_node(node.source):
            window = self._count_window(stacked, key_names)
            yield self._reshard(stacked, key_names, window)


# -- small pytree helpers -------------------------------------------------------


def _squeeze0(b: DeviceBatch) -> DeviceBatch:
    return jax.tree_util.tree_map(lambda a: a[0], b)


def _expand0(b: DeviceBatch) -> DeviceBatch:
    return jax.tree_util.tree_map(lambda a: a[None], b)


def _take0(b: DeviceBatch) -> DeviceBatch:
    return jax.tree_util.tree_map(lambda a: a[0], b)


def _concat_stacked(batches: List[DeviceBatch]) -> DeviceBatch:
    """Concatenate stacked (n, cap_i) batches along the capacity axis.
    Checked-op error counts ((n,)-stacked scalars, not row-shaped) are
    summed across waves instead of concatenated."""
    if len(batches) == 1:
        return batches[0]
    errs = [b.errors for b in batches if b.errors is not None]
    if errs:
        batches = [DeviceBatch(b.columns, b.mask) for b in batches]
    out = jax.tree_util.tree_map(
        lambda *arrs: jnp.concatenate(arrs, axis=1), *batches)
    if errs:
        out = DeviceBatch(out.columns, out.mask, errors=sum(errs))
    return out


def _pad_batch(b: DeviceBatch, cap: int) -> DeviceBatch:
    def pad(a):
        out = jnp.zeros((cap,) + a.shape[1:], a.dtype)
        return out.at[:a.shape[0]].set(a)
    # row-aligned children (ROW fields / long-decimal hi limb) pad along;
    # element-space children keep their own capacity
    cols = {n: _pad_col_rows(c, cap) for n, c in b.columns.items()}
    return DeviceBatch(cols, pad(b.mask))
