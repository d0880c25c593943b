"""Task: executes one plan fragment.

Role parity: ``velox/exec/Task.h:72-238`` (serial ``Task::next`` mode) +
``velox/exec/LocalPlanner.*`` (plan tree -> pipelines; pipelines split at
join builds) + ``velox/exec/Driver.cpp:478`` (the operator pull loop).

The host driver loop only shuffles batch *handles*; all per-batch
compute is inside jitted programs, so one Python-level loop iteration covers
a capacity-sized batch (vs the reference's per-1K-row operator walk). Join
build sides run as nested pipelines to completion before the probe pipeline
streams (same ordering the reference gets from its JoinBridge barrier).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

from velox_tpu import types as T
from velox_tpu import use_compile_cache
from velox_tpu.core import expressions as ex
from velox_tpu.core import plan as P
from velox_tpu.exec.aggregation import AggregationOperator
from velox_tpu.exec.join import HashBuildStage, HashJoinOperator
from velox_tpu.exec.operator import (
    FilterProjectOperator, LimitOperator, Operator, SourceOperator,
    TableScanOperator, ValuesOperator,
)
from velox_tpu.exec.orderby import OrderByOperator, TopNOperator
from velox_tpu.vector.device import DeviceBatch


class QueryCtx:
    """Per-query context. Parity: velox/core/QueryCtx.h:33."""

    def __init__(self, config: Optional[Dict] = None):
        from velox_tpu.core.config import QueryConfig
        from velox_tpu.core.config import QueryConfig as QC
        from velox_tpu.exec.memory import MemoryPool
        self.config = dict(config or {})
        self.query_config = QueryConfig(self.config)
        # query pool under the process HBM root; a cap here (or on the
        # root) makes OffloadBuffer.add trigger arbitration
        cap = self.query_config.get_int(QC.QUERY_HBM_CAP_BYTES, 0)
        self.memory_pool = MemoryPool(
            f"query-{id(self):x}", cap or None,
            parent=MemoryPool.device_root())

    def get(self, key, default=None):
        return self.config.get(key, default)


class Task:
    """Serial single-fragment execution (Task::next parity)."""

    def __init__(self, plan: P.PlanNode, ctx: Optional[QueryCtx] = None):
        use_compile_cache()
        self.plan = plan
        self.ctx = ctx or QueryCtx()
        self.operators: List[Operator] = []  # for stats
        # probe-side scans started DURING the build phase (pipeline
        # overlap): node.id -> live TableScanOperator (prefetch running)
        self._prewarmed_scans: Dict[str, Operator] = {}
        # per-driver-thread split slice for multi-driver local pipelines
        import threading as _tm
        self._driver_slice = _tm.local()
        self._error_scalars: List = []  # traced checked-op failure counts
        self._trace_writers: Dict[str, object] = {}
        qc = self.ctx.query_config
        from velox_tpu.core.config import QueryConfig as QC
        self._trace_enabled = qc.get_bool(QC.TRACE_ENABLED)
        self._trace_dir = qc.get_str(QC.TRACE_DIR)
        ids = qc.get_str(QC.TRACE_NODE_IDS)
        self._trace_ids = set(x for x in ids.split(",") if x) or None
        self._sync_ops = qc.get_bool(QC.DEBUG_SYNC_OPERATORS)
        if self._trace_enabled and self._trace_dir:
            from velox_tpu.exec.trace import write_plan
            write_plan(self._trace_dir, plan)

    def _spill_kwargs(self) -> dict:
        """Disk-tier spill knobs for offload buffers (OffloadBuffer):
        host-RAM budget before spill files take over + spill dir."""
        from velox_tpu.core.config import QueryConfig as QC
        qc = self.ctx.query_config
        hb = qc.get_int(QC.OFFLOAD_HOST_BUDGET_BYTES, 0)
        sd = qc.get_str(QC.SPILL_DIR)
        ms = qc.get_int(QC.MAX_SPILL_BYTES, 0)
        return {"host_budget_bytes": hb or None,
                "spill_dir": sd or None,
                "max_spill_bytes": ms or None}

    @staticmethod
    def _block(tree):
        """Force pending device work (debug_sync_operators)."""
        if tree is None:
            return
        import jax
        for leaf in jax.tree_util.tree_leaves(tree):
            block = getattr(leaf, "block_until_ready", None)
            if block is not None:
                block()

    def _maybe_trace(self, op: Operator, batch: DeviceBatch):
        """Record operator inputs for offline replay.
        Parity: Operator::traceInput (exec/Operator.h:437)."""
        if not (self._trace_enabled and self._trace_dir):
            return
        nid = op.stats.plan_node_id
        if self._trace_ids is not None and nid not in self._trace_ids:
            return
        w = self._trace_writers.get(nid)
        if w is None:
            from velox_tpu.exec.trace import TraceWriter
            w = TraceWriter(self._trace_dir, nid)
            self._trace_writers[nid] = w
        w.record(batch)

    def _close_traces(self):
        for w in self._trace_writers.values():
            w.close()
        self._trace_writers = {}

    # ---- public API --------------------------------------------------------

    def _strip_errors(self, batch: DeviceBatch) -> DeviceBatch:
        """Detach a batch's checked-op error count into the task-level
        accumulator (one traced scalar per producing superstep; ONE host
        fetch at query end — common/errors.py)."""
        if batch is not None and batch.errors is not None:
            self._error_scalars.append(batch.errors)
            batch = DeviceBatch(batch.columns, batch.mask)
        return batch

    def check_errors(self) -> None:
        """Raise VeloxUserError if any checked operation failed.
        Parity: Task::setError / error propagation (exec/Task.cpp:2574)."""
        if not self._error_scalars:
            return
        import jax
        import jax.numpy as jnp
        total = int(jax.device_get(sum(self._error_scalars)))
        self._error_scalars = []
        if total:
            from velox_tpu.common.errors import (
                VeloxUserError, traced_error_suffix,
            )
            raise VeloxUserError(
                f"{total} row(s) failed a checked operation (division by "
                "zero, integer overflow, or invalid cast); wrap the "
                "expression in TRY(...) to get NULLs instead"
                + traced_error_suffix())

    def batches(self) -> Iterator[DeviceBatch]:
        for b in self._run_node(self.plan):
            yield self._strip_errors(b)

    _COMPACT_MIN_CAP = 1 << 17

    def _compact_for_output(self, b: DeviceBatch) -> DeviceBatch:
        """Device-side compaction before host extraction: final batches
        often carry huge padded capacities (scan-sized) with few active
        rows, and fetching the padding costs host transfer time. One
        scalar fetch decides a right-sized prefix copy."""
        import jax
        if b.capacity < self._COMPACT_MIN_CAP:
            return b
        from velox_tpu.exec.batch_utils import compact_batch
        n = int(jax.device_get(b.num_active()))
        out_cap = max(1024, 1 << (max(1, n) - 1).bit_length())
        if out_cap * 2 >= b.capacity:
            return b
        import functools

        import jax as _jax

        from velox_tpu.exec.jit_cache import cached_jit
        fn = cached_jit(("compact_for_output", out_cap),
                        lambda: _jax.jit(functools.partial(
                            compact_batch, out_cap=out_cap)))
        return fn(b)

    def run(self):
        """Execute to completion; return a pyarrow Table."""
        import jax
        import pyarrow as pa
        from velox_tpu.common import metrics as M
        from velox_tpu.core.config import QueryConfig as QC
        from velox_tpu.vector.device import to_arrow
        t0 = time.perf_counter()
        cse_off = self.ctx.query_config.get_bool(QC.DEBUG_DISABLE_CSE)
        if cse_off:
            from velox_tpu.expression import eval as _ev
            _ev.set_cse_disabled(True)
        try:
            dev_batches = [self._compact_for_output(b)
                           for b in self.batches()]
            # ONE bulk fetch for all output batches AND the checked-op
            # error total: the error fetch rides the data fetch
            err_total = (sum(self._error_scalars)
                         if self._error_scalars else None)
            self._error_scalars = []
            host_batches, err_v = jax.device_get((dev_batches, err_total))
            tables = [to_arrow(b) for b in host_batches]
        except BaseException as e:
            self._terminate(e)
            raise
        finally:
            if cse_off:
                from velox_tpu.expression import eval as _ev
                _ev.set_cse_disabled(False)
            for op in self.operators:
                try:
                    op.close()
                except Exception:
                    pass
            # prewarmed probe scans that were never driven (early-exit
            # probes): stop their prefetch threads too
            for op in self._prewarmed_scans.values():
                try:
                    op.close()
                except Exception:
                    pass
            self._prewarmed_scans.clear()
            self._close_traces()
        if err_v is not None and int(err_v):
            from velox_tpu.common.errors import (
                VeloxUserError, traced_error_suffix,
            )
            e = VeloxUserError(
                f"{int(err_v)} row(s) failed a checked operation "
                "(division by zero, integer overflow, or invalid cast); "
                "wrap the expression in TRY(...) to get NULLs instead"
                + traced_error_suffix())
            self._terminate(e)
            raise e
        M.record_counter(M.K_TASK_QUERIES)
        M.record_histogram(M.K_QUERY_WALL_MS,
                           (time.perf_counter() - t0) * 1e3)
        for t in tables:
            M.record_counter(M.K_OUTPUT_ROWS, t.num_rows)
            M.record_counter(M.K_OUTPUT_BYTES, t.nbytes)
        if not tables:
            schema = T.to_arrow(self.plan.output_type())
            return pa.table({n: pa.array([], type=f.type)
                             for n, f in zip(schema.names, schema)})
        return pa.concat_tables(tables)

    def _rewrite_map_union(self, node: "P.AggregationNode"):
        """map_union(m) lowers to Unnest(m -> k, v) + map_agg(k, v):
        first-wins dedup over exploded entries matches Presto's
        arbitrary-value-on-duplicate contract (ref prestosql
        MapUnionAggregate.cpp). Returns the rewritten plan or None."""
        calls = [c for c in node.aggregates if c.name == "map_union"]
        if not calls:
            return None
        if len(node.aggregates) != 1:
            raise NotImplementedError(
                "map_union cannot mix with other aggregates (the unnest "
                "rewrite changes row counts)")
        call = calls[0]
        inp = call.inputs[0]
        if not isinstance(inp, ex.FieldAccess):
            raise NotImplementedError(
                "map_union argument must be a column")
        mt = inp.dtype
        kname, vname = "__mu_k", "__mu_v"
        unnest = P.UnnestNode(
            f"{node.id}__mu", source=node.source,
            unnest_column=inp.name, element_name=kname,
            value_name=vname)
        return P.AggregationNode(
            node.id, source=unnest, step=node.step,
            grouping_keys=node.grouping_keys,
            aggregate_names=node.aggregate_names,
            aggregates=(P.AggregateCall(
                "map_agg",
                (ex.field(kname, mt.children[0]),
                 ex.field(vname, mt.children[1])),
                call.result_type),))

    def _terminate(self, e: BaseException):
        """Task::terminate parity (exec/Task.cpp:1934): a failing
        fragment poisons its output buffer so CONSUMER fragments abort
        instead of waiting on a never-finished stream."""
        from velox_tpu.exec.exchange import PartitionedOutputOperator
        for op in self.operators:
            if isinstance(op, PartitionedOutputOperator):
                op.terminate(f"{type(e).__name__}: {e}")

    def stats(self):
        return [op.stats.as_dict() for op in self.operators]

    def print_plan_with_stats(self) -> str:
        """Plan tree annotated with per-operator stats.
        Parity: velox printPlanWithStats (exec/tests/utils/
        QueryAssertions.h, used by TpchBenchmark.cpp:82-103)."""
        by_node: Dict[str, List] = {}
        for op in self.operators:
            by_node.setdefault(op.stats.plan_node_id, []).append(op.stats)

        def fmt(node: P.PlanNode, indent: int) -> List[str]:
            pad = "  " * indent
            lines = [f"{pad}- {node.name}[{node.id}]"]
            for st in by_node.get(node.id, []):
                ms = (st.add_input_wall_ns + st.get_output_wall_ns
                      + st.finish_wall_ns) / 1e6
                extra = (f" (+build {st.build_wall_ns / 1e6:.1f} ms)"
                         if st.build_wall_ns else "")
                lines.append(
                    f"{pad}    {st.operator_type}: in={st.input_batches} "
                    f"out={st.output_batches} batches "
                    f"({st.input_bytes / 1e6:.0f}/"
                    f"{st.output_bytes / 1e6:.0f} MB), {ms:.1f} ms{extra}")
            for s in node.sources:
                lines.extend(fmt(s, indent + 1))
            return lines

        return "\n".join(fmt(self.plan, 0))

    # ---- pipeline construction ----------------------------------------------

    def _run_node(self, node: P.PlanNode) -> Iterator[DeviceBatch]:
        """Recursively build + drive the pipeline rooted at `node`."""
        if isinstance(node, P.ValuesNode):
            yield from self._drive_source(ValuesOperator(node))
        elif isinstance(node, P.ArrowStreamNode):
            from velox_tpu.exec.operator import ArrowStreamOperator
            yield from self._drive_source(ArrowStreamOperator(node))
        elif isinstance(node, P.TableScanNode):
            scan = self._make_scan(node)
            if node.filter is not None:
                # Pushed-down filter: fused as the scan's superstep (the
                # analogue of dwio ScanSpec filters, dwio/common/ScanSpec.h:40)
                ot = node.output_type()
                identity = [ex.field(n, t)
                            for n, t in zip(ot.names, ot.children)]
                fop = FilterProjectOperator(node, node.filter, ot.names,
                                            identity)
                self.operators.append(fop)

                def _filtered(scan=scan, fop=fop):
                    for b in self._drive_source(scan):
                        fop.add_input(b)
                        out = fop.get_output()
                        if out is not None:
                            yield out
                yield from _filtered()
            else:
                yield from self._drive_source(scan)
        elif isinstance(node, (P.FilterNode, P.ProjectNode)):
            # collapse the whole Filter/Project chain (incl. a pushed-down
            # scan filter) into ONE jitted superstep, cached across Task
            # instances by plan node (exec/fuse.py)
            from velox_tpu.exec.fuse import cached_chain
            chain, fn = cached_chain(node)
            op = FilterProjectOperator.from_fused(node, fn,
                                                  prejitted=True)
            yield from self._drive(chain.source, op)
        elif isinstance(node, P.AggregationNode):
            rewritten = self._rewrite_map_union(node)
            if rewritten is not None:
                yield from self._run_node(rewritten)
                return
            from velox_tpu.core.config import QueryConfig as QC
            from velox_tpu.exec.fuse import chain_fn, collapse_chain
            chain = collapse_chain(node.source)
            qc = self.ctx.query_config
            # input sorted by the grouping keys -> streaming aggregation
            # (parity: velox StreamingAggregation.h:29, chosen when the
            # source declares ordering)
            if (chain.is_identity
                    and isinstance(node.source, P.OrderByNode)
                    and qc.get_bool(QC.STREAMING_AGG_ENABLED, True)):
                from velox_tpu.exec.streaming_agg import (
                    StreamingAggregationOperator, streaming_supported,
                )
                knames = {k.name for k in node.grouping_keys}
                prefix = [k.name
                          for k in node.source.keys[:len(knames)]]
                if (len(node.source.keys) >= len(knames)
                        and set(prefix) == knames
                        and streaming_supported(node)):
                    yield from self._drive(
                        node.source, StreamingAggregationOperator(node))
                    return

            def mk_agg(pre):
                return AggregationOperator(
                    node, pre_fn=pre,
                    host_offload=qc.get_bool(QC.AGG_HOST_OFFLOAD),
                    compact_threshold=qc.get_int(QC.AGG_COMPACT_THRESHOLD,
                                                 8),
                    abandon_min_rows=qc.get_int(
                        QC.ABANDON_PARTIAL_AGG_MIN_ROWS, 100_000),
                    abandon_min_pct=float(qc.get(
                        QC.ABANDON_PARTIAL_AGG_MIN_PCT, 0.8)))
            # one fused reduction per batch for Q6-shaped global sums
            # (aggregation pushdown into scan; ops/filter_reduce.py)
            fr_op = self._try_filter_sum(node, chain, mk_agg)
            if fr_op is not None:
                yield from self._drive(chain.source, fr_op)
                return
            pre = None if chain.is_identity else chain_fn(chain)
            yield from self._drive(chain.source, mk_agg(pre))
        elif isinstance(node, P.OrderByNode):
            from velox_tpu.core.config import QueryConfig as QC
            qc_ = self.ctx.query_config
            ob = (qc_.get_int(QC.SORT_OFFLOAD_BYTES, 4 << 30)
                  if qc_.get_bool(QC.ORDERBY_SPILL_ENABLED, True)
                  else None)
            yield from self._drive(node.source, OrderByOperator(
                node, offload_bytes=ob,
                pool=self.ctx.memory_pool,
                **self._spill_kwargs()))
        elif isinstance(node, P.TopNNode):
            yield from self._drive(node.source, TopNOperator(node))
        elif isinstance(node, P.LimitNode):
            # OrderBy + Limit(offset=0) => TopN: a bounded key-only sort
            # per batch instead of a full sort with payload gathers
            # (parity: the Limit-over-OrderBy plans Presto lowers to
            # TopNNode, core/PlanNode.h:1871)
            if (isinstance(node.source, P.OrderByNode)
                    and node.offset == 0 and 0 < node.count <= (1 << 20)):
                ob = node.source
                tn = P.TopNNode(f"{node.id}-topn", source=ob.source,
                                keys=ob.keys, orders=ob.orders,
                                count=node.count)
                yield from self._drive(ob.source, TopNOperator(tn))
            else:
                yield from self._drive(node.source, LimitOperator(node))
        elif isinstance(node, P.HashJoinNode):
            yield from self._run_join(node)
        elif isinstance(node, P.TableWriteNode):
            from velox_tpu.exec.writer import TableWriterOperator
            yield from self._drive(node.source, TableWriterOperator(node))
        elif isinstance(node, P.MarkDistinctNode):
            from velox_tpu.exec.misc_ops import MarkDistinctOperator
            yield from self._drive(node.source, MarkDistinctOperator(node))
        elif isinstance(node, P.AssignUniqueIdNode):
            from velox_tpu.exec.misc_ops import AssignUniqueIdOperator
            yield from self._drive(node.source,
                                   AssignUniqueIdOperator(node))
        elif isinstance(node, P.EnforceSingleRowNode):
            from velox_tpu.exec.misc_ops import EnforceSingleRowOperator
            yield from self._drive(node.source,
                                   EnforceSingleRowOperator(node))
        elif isinstance(node, P.ExpandNode):
            from velox_tpu.exec.misc_ops import ExpandOperator
            yield from self._drive(node.source, ExpandOperator(node))
        elif isinstance(node, P.GroupIdNode):
            from velox_tpu.exec.misc_ops import GroupIdOperator
            yield from self._drive(node.source, GroupIdOperator(node))
        elif isinstance(node, P.UnnestNode):
            from velox_tpu.exec.misc_ops import UnnestOperator
            yield from self._drive(node.source, UnnestOperator(node))
        elif isinstance(node, P.NestedLoopJoinNode):
            yield from self._run_nested_loop_join(node)
        elif isinstance(node, P.MergeJoinNode):
            from velox_tpu.exec.sort import packable_words
            if packable_words([k.dtype for k in node.right_keys]):
                yield from self._run_merge_join(node)
            else:
                # wide key tuples: hash-join machinery (correct fallback)
                hj = P.HashJoinNode(
                    node.id, left=node.left, right=node.right,
                    join_type=node.join_type, left_keys=node.left_keys,
                    right_keys=node.right_keys, filter=node.filter,
                    output_columns=node.output_columns)
                yield from self._run_join(hj)
        elif isinstance(node, P.WindowNode):
            from velox_tpu.exec.window import WindowOperator
            yield from self._drive(node.source, WindowOperator(node))
        elif isinstance(node, P.RowNumberNode):
            from velox_tpu.exec.window import RowNumberOperator
            yield from self._drive(node.source, RowNumberOperator(node))
        elif isinstance(node, P.TopNRowNumberNode):
            from velox_tpu.exec.window import TopNRowNumberOperator
            yield from self._drive(node.source,
                                   TopNRowNumberOperator(node))
        elif isinstance(node, P.LocalPartitionNode):
            from velox_tpu.core.config import QueryConfig as QC
            n = self.ctx.query_config.get_int(
                QC.LOCAL_EXCHANGE_DRIVERS, 1)
            if n >= 1:
                # multi-driver pipeline boundary: N producer threads run
                # the subtree over split slices, feeding a bounded queue
                # (exec/local_exchange.py; parity LocalPartition.h:148)
                yield from self._run_local_partition(node, n)
            else:
                # n=0: inline pass-through (parallel layer handles the
                # mesh-sharded form)
                yield from self._run_node(node.source)
        elif isinstance(node, P.PartitionedOutputNode):
            from velox_tpu.exec.exchange import PartitionedOutputOperator
            task_id = self.ctx.get("task.id", "task-0")
            op = PartitionedOutputOperator(node, task_id)
            # sink: drive to completion, emit nothing
            for _ in self._drive(node.source, op):
                pass
        elif isinstance(node, P.LocalMergeNode):
            sort_node = P.OrderByNode(node.id, source=node.source,
                                      keys=node.keys, orders=node.orders)
            yield from self._drive(node.source, OrderByOperator(sort_node))
        elif isinstance(node, (P.ExchangeNode, P.MergeExchangeNode)):
            from velox_tpu.exec.exchange import ExchangeOperator
            remotes = self.ctx.get(f"exchange.{node.id}.tasks") or \
                self.ctx.get("exchange.tasks") or []
            dest = self.ctx.get("task.destination", 0)
            cap = self.ctx.get("exchange.batch_capacity")
            dicts = self.ctx.get(f"exchange.{node.id}.dictionaries")
            pages = self._drive_source(ExchangeOperator(
                node, remotes, dest, cap, dicts,
                self.ctx.get("exchange.max_queue_bytes")))
            if isinstance(node, P.MergeExchangeNode):
                # ordered exchange: re-establish the total order with one
                # device sort over the drained pages (see MergeExchangeNode)
                from velox_tpu.exec.batch_utils import concat_batches
                from velox_tpu.exec.orderby import sort_batch
                got = list(pages)
                if got:
                    merged = concat_batches(got)
                    yield sort_batch(merged, list(node.keys),
                                     list(node.orders))
            else:
                yield from pages
        else:
            raise NotImplementedError(f"no operator for {type(node).__name__}")

    def _try_filter_sum(self, node: P.AggregationNode, chain, mk_agg):
        """Aggregation pushdown: global sum(a*b) over a range-filtered scan
        runs as one fused reduction per batch (ops/filter_reduce.py).
        Returns the operator or None when the plan/stats don't match."""
        from velox_tpu.exec.fuse import chain_fn
        from velox_tpu.ops.filter_reduce import (
            FilterSumOperator, match_filter_sum,
        )
        if not isinstance(chain.source, P.TableScanNode):
            return None
        from velox_tpu.connectors.connector import get_connector
        try:
            conn = get_connector(chain.source.connector_id)
        except Exception:
            return None
        stats_fn = getattr(conn, "column_stats", None)
        if stats_fn is None:
            return None
        stats = {}
        for c in chain.source.output_type().names:
            s = stats_fn(chain.source.table, c)
            if s is not None:
                stats[c] = s
        spec = match_filter_sum(node, chain, stats)
        if spec is None:
            return None
        from velox_tpu.common import metrics as M
        M.record_counter(M.K_FILTER_SUM_KERNEL)
        return FilterSumOperator(
            node, spec, lambda: mk_agg(chain_fn(chain)))

    def _run_local_partition(self, node, n: int):
        """Producer/consumer overlap at a LocalPartition boundary: each
        of `n` driver threads executes the source subtree over its
        splits[i::n] slice into one byte-bounded queue."""
        import threading as _tm

        from velox_tpu.core.config import QueryConfig as QC
        from velox_tpu.exec.local_exchange import LocalExchangeQueue
        q = LocalExchangeQueue(n, max_bytes=self.ctx.query_config.get_int(
            QC.MAX_LOCAL_EXCHANGE_BUFFER_BYTES, 32 << 20))

        def produce(i):
            try:
                self._driver_slice.value = (i, n)
                for batch in self._run_node(node.source):
                    from velox_tpu.common import testvalue as TV
                    TV.adjust("LocalPartition::produce", (i, batch))
                    nb = batch.nbytes
                    if not q.put(batch, nb):
                        return
                q.producer_done()
            except BaseException as e:  # surfaced at the consumer
                q.producer_done(e)
            finally:
                self._driver_slice.value = None

        threads = [_tm.Thread(target=produce, args=(i,), daemon=True,
                              name=f"velox-lp-{node.id}-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            q.stop()
            # JOIN producers: a thread outliving its Task dispatches JAX
            # concurrently with the next query's main thread — observed
            # as an XLA:CPU segfault in the full test suite. Producers
            # exit at their next put()/stop check, so this waits at most
            # one in-flight batch per thread.
            for t in threads:
                while t.is_alive():
                    t.join(timeout=0.25)
                    q.stop()  # re-signal in case of a put/stop race

    def _prewarm_probe_scans(self, left: P.PlanNode) -> None:
        """Start the probe side's scan operators (and their prefetch
        threads) BEFORE the build side runs, so probe-side host work
        (split decode/generation + device upload) overlaps the build's
        device compute — the pipeline-overlap analogue of velox running
        HashBuild and the probe pipeline as concurrent drivers
        (exec/HashBuild.cpp + Driver scheduling). Only for the serial
        single-driver path: multi-driver slices create per-driver scans."""
        if getattr(self._driver_slice, "value", None) is not None:
            return

        def walk(n: P.PlanNode) -> None:
            if isinstance(n, P.LocalPartitionNode):
                return  # its scans are per-driver-slice copies
            if isinstance(n, P.TableScanNode) \
                    and n.id not in self._prewarmed_scans:
                try:
                    self._prewarmed_scans[n.id] = self._make_scan(n)
                    from velox_tpu.common import metrics as M
                    M.record_counter(M.K_SCAN_PREWARMED)
                except Exception:
                    return  # prewarm is best-effort; _run_node retries
            for s in n.sources:
                walk(s)

        walk(left)

    def _make_scan(self, node: P.TableScanNode) -> TableScanOperator:
        if getattr(self._driver_slice, "value", None) is None:
            warm = self._prewarmed_scans.pop(node.id, None)
            if warm is not None:
                return warm
        from velox_tpu.connectors.connector import get_connector
        conn = get_connector(node.connector_id)
        source = conn.create_data_source(node.table, node.columns, self.ctx)
        splits = self.ctx.get(f"splits.{node.id}") \
            or conn.default_splits(node.table, self.ctx)
        drv = getattr(self._driver_slice, "value", None)
        if drv is not None:
            i, k = drv
            splits = list(splits)[i::k]
        pf = node.filter if node.filter is not None \
            else getattr(node, "prune_filter", None)
        if pf is not None and hasattr(conn, "prune_splits"):
            # file/row-group statistics pruning (dwio ScanSpec filters +
            # parquet row-group stats; connectors/hive.py)
            splits = conn.prune_splits(node.table, splits, pf)
        from velox_tpu.core.config import QueryConfig as QC
        # Default prefetch: ON for accelerator backends (host decode +
        # upload overlap device compute), OFF on XLA:CPU — a
        # prefetch thread's device_put racing a main-thread compile
        # segfaulted XLA:CPU (observed: faulthandler inside
        # backend_compile_and_load with a live producer; same class as
        # the round-4 close()-join fix in operator.py). Tests of the
        # threaded prefetch machinery opt in via SCAN_PREFETCH_DEPTH.
        import jax
        default_depth = 0 if jax.default_backend() == "cpu" else 2
        depth = self.ctx.query_config.get_int(QC.SCAN_PREFETCH_DEPTH,
                                              default_depth)
        return TableScanOperator(node, source, splits, prefetch=depth)

    def _run_nested_loop_join(self, node) -> Iterator[DeviceBatch]:
        from velox_tpu.exec.batch_utils import concat_batches
        from velox_tpu.exec.misc_ops import NestedLoopJoinOperator
        self._prewarm_probe_scans(node.left)
        builds = list(self._run_node(node.right))
        if not builds:
            raise RuntimeError("empty nested-loop build side")
        op = NestedLoopJoinOperator(node)
        op.set_build(concat_batches(builds))
        yield from self._drive(node.left, op)

    def _run_join(self, node: P.HashJoinNode) -> Iterator[DeviceBatch]:
        # Build side: nested pipeline run to completion (JoinBridge parity).
        from velox_tpu.core.config import QueryConfig as QC
        from velox_tpu.exec.join import array_join_range
        qc_ = self.ctx.query_config
        build = HashBuildStage(
            node.right_keys,
            offload_bytes=(
                qc_.get_int(QC.JOIN_BUILD_OFFLOAD_BYTES, 4 << 30)
                if qc_.get_bool(QC.JOIN_SPILL_ENABLED, True) else None),
            pool=self.ctx.memory_pool,
            array_range=array_join_range(node),
            **self._spill_kwargs())
        self._prewarm_probe_scans(node.left)
        for batch in self._run_node(node.right):
            build.add_input(batch)
        t0 = time.perf_counter_ns()
        table = build.finish()
        if self._sync_ops:
            self._block(table)
        probe = HashJoinOperator(node)
        probe.stats.build_wall_ns = time.perf_counter_ns() - t0
        probe.set_built_table(table)
        left = self._maybe_push_dynamic_filter(node, table)
        if left is None:  # empty build, inner/semi: no probe at all
            return
        yield from self._drive(left, probe)

    def _run_merge_join(self, node: P.MergeJoinNode
                        ) -> Iterator[DeviceBatch]:
        """Sorted-input join (parity: velox/exec/MergeJoin.h:45): the
        pre-sorted right side compacts without sorting; probes binary-search
        the packed build keys (exec/join.py MergeJoinOperator)."""
        from velox_tpu.core.config import QueryConfig as QC
        from velox_tpu.exec.join import MergeBuildStage, MergeJoinOperator
        build = MergeBuildStage(
            node.right_keys,
            offload_bytes=self.ctx.query_config.get_int(
                QC.JOIN_BUILD_OFFLOAD_BYTES, 4 << 30),
            pool=self.ctx.memory_pool,
            **self._spill_kwargs())
        self._prewarm_probe_scans(node.left)
        for batch in self._run_node(node.right):
            build.add_input(batch)
        t0 = time.perf_counter_ns()
        table = build.finish()
        if self._sync_ops:
            self._block(table)
        probe = MergeJoinOperator(node)
        probe.stats.build_wall_ns = time.perf_counter_ns() - t0
        probe.set_built_table(table)
        yield from self._drive(node.left, probe)

    def _maybe_push_dynamic_filter(self, node: P.HashJoinNode, table
                                   ) -> P.PlanNode:
        """Dynamic filter pushdown: after the build completes, derive
        [min, max] ranges of the build keys and prepend them as probe-side
        filters, which the fusion pass folds into the probe scan superstep.
        Parity: HashProbe dynamic filters (exec/HashProbe.cpp:393) +
        Driver::pushdownFilters (exec/Driver.cpp:613).

        Only for joins where non-matching probe rows are dropped
        (inner/left-semi) and integral/date/dict-string keys."""
        import jax
        import numpy as np
        from velox_tpu.core.config import QueryConfig as QC
        if not self.ctx.query_config.get_bool(QC.DYNAMIC_FILTERS, True):
            return node.left
        if node.join_type not in (P.JoinType.INNER,
                                  P.JoinType.LEFT_SEMI_FILTER):
            return node.left
        # Cost gate: the pushdown's summaries fetch stalls the pipeline
        # (it forces the build and serializes against the probe-side scan
        # dispatch). For an
        # ARRAY-mode probe of a PROVABLY-UNIQUE build the row filter
        # buys nothing — the dense-domain lookup already rejects
        # out-of-range keys for free and masked rows cost no compute
        # under static shapes; skipping it sped Q3 and Q18 up on the
        # engine's first accelerator (not yet measured on the H100).
        # Duplicate-key (count-path) joins
        # keep the pushdown: smaller match counts mean fewer emit
        # chunks, a real win.
        from velox_tpu.core.stats import resolve_column_unique
        from velox_tpu.exec.join import array_join_range
        if array_join_range(node) is not None and any(
                resolve_column_unique(node.right, k.name)
                for k in node.right_keys):
            return node.left
        from velox_tpu.exec.join import _key_values, _usable
        left = node.left
        lt = left.output_type()
        preds = []
        bkeys = _key_values(table.batch, node.right_keys)
        # raw string keys have no scalar [min, max] summary (byte
        # matrices); no dynamic filter for such joins
        from velox_tpu.vector import strings as _S
        if any(_S.is_raw(v) for v in bkeys):
            return left

        # Everything here fetches SCALARS (or <= 64 values) — pulling the
        # raw key column to the host would move tens of MB.
        import jax.numpy as jnp

        def _summaries(batch):
            cap = batch.capacity
            keys = _key_values(batch, node.right_keys)
            ok = _usable(batch, keys)
            n = jnp.sum(ok.astype(jnp.int32))
            outs = []
            for v in keys:
                d = v.full_data(cap)
                big = jnp.iinfo(d.dtype).max if jnp.issubdtype(
                    d.dtype, jnp.integer) else jnp.inf
                lo = jnp.min(jnp.where(ok, d, big))
                hi = jnp.max(jnp.where(ok, d, -big))
                # first 64 usable values via cumsum-scatter compaction
                # (lax.sort compile cost is prohibitive here; order is
                # irrelevant — the host sorts 64 values)
                idx = jnp.cumsum(ok.astype(jnp.int32)) - 1
                tgt = jnp.where(ok & (idx < 64), idx, jnp.int32(64))
                s = jnp.zeros((65,), d.dtype).at[tgt] \
                    .set(d, mode="drop")[:64]
                outs.append((lo, hi, s))
            return n, outs

        # cross-task cache: a bare @jax.jit here compiled FRESH per Task
        # (jit caches on function identity), recompiling these two
        # summaries in every warm query
        from velox_tpu.exec.jit_cache import cached_jit
        summaries_fn = cached_jit(
            ("dyn_filter_summaries", tuple(node.right_keys)),
            lambda: jax.jit(_summaries))
        n_usable, summaries = jax.device_get(summaries_fn(table.batch))
        n_usable = int(n_usable)
        if n_usable == 0:
            # kHashProbeFinishEarlyOnEmptyBuild: an inner/semi probe of
            # an empty build emits nothing — skip the probe pipeline
            # (including its scans) entirely. The n_usable fetch rides
            # the dynamic-filter summary sync (no extra round trip).
            if self.ctx.query_config.get_bool(
                    QC.HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD, True):
                return None
            return left
        for lk, (lo, hi, small) in zip(node.left_keys, summaries):
            dt = lk.dtype
            if not (dt.is_integral or dt.kind in (
                    T.TypeKind.DATE, T.TypeKind.DECIMAL)):
                continue
            f = ex.field(lk.name, lt.field_type(lk.name))
            if n_usable <= 64:
                vals = sorted(set(int(v) for v in small[:n_usable]))
                preds.append(ex.Call(T.BOOLEAN, "in", (f,) + tuple(
                    ex.Constant(dt, v) for v in vals)))
                continue
            preds.append(ex.Call(T.BOOLEAN, "between", (
                f, ex.Constant(dt, int(lo)), ex.Constant(dt, int(hi)))))
        if not preds:
            return left
        pred = preds[0]
        for p in preds[1:]:
            pred = ex.Call(T.BOOLEAN, "and", (pred, p))
        from velox_tpu.common import metrics as M
        M.record_counter(M.K_JOIN_DYN_FILTERS)
        return P.FilterNode(f"{node.id}-dynfilter", source=left,
                            predicate=pred)

    # ---- driver loop (Driver::runInternal parity) ---------------------------

    def _drive(self, source_node: P.PlanNode, op: Operator
               ) -> Iterator[DeviceBatch]:
        self.operators.append(op)
        st = op.stats
        for batch in self._run_node(source_node):
            batch = self._strip_errors(batch)
            from velox_tpu.common import metrics as M
            from velox_tpu.common import testvalue as TV
            M.record_counter(M.K_TASK_BATCHES)
            TV.adjust("Task::drive::addInput", (op, batch))
            self._maybe_trace(op, batch)
            t0 = time.perf_counter_ns()
            from velox_tpu.common.process_trace import TraceContext
            with TraceContext(f"{st.operator_type}[{op.node.id}] add_input"):
                op.add_input(batch)
                if self._sync_ops:
                    self._block(op.device_state())
            st.add_input_wall_ns += time.perf_counter_ns() - t0
            st.input_batches += 1
            st.input_bytes += batch.nbytes
            while True:
                t0 = time.perf_counter_ns()
                out = op.get_output()
                if self._sync_ops:
                    self._block(out)
                st.get_output_wall_ns += time.perf_counter_ns() - t0
                if out is None:
                    break
                st.output_batches += 1
                st.output_bytes += out.nbytes
                yield out
        t0 = time.perf_counter_ns()
        from velox_tpu.common.process_trace import TraceContext
        with TraceContext(f"{st.operator_type}[{op.node.id}] finish"):
            op.no_more_input()
            if self._sync_ops:
                self._block(op.device_state())
        st.finish_wall_ns += time.perf_counter_ns() - t0
        while True:
            out = op.get_output()
            if out is None:
                break
            st.output_batches += 1
            st.output_bytes += out.nbytes
            yield out
        # operators that evaluate expressions inside their own jitted
        # steps (aggregation pre-chains / agg inputs) expose their error
        # scalars here
        self._error_scalars.extend(getattr(op, "error_scalars", ()))

    def _drive_source(self, op: SourceOperator) -> Iterator[DeviceBatch]:
        self.operators.append(op)
        st = op.stats
        while not op.is_finished():
            t0 = time.perf_counter_ns()
            out = op.get_output()
            if self._sync_ops:
                self._block(out)
            st.get_output_wall_ns += time.perf_counter_ns() - t0
            if out is None:
                break
            st.output_batches += 1
            st.output_bytes += out.nbytes
            yield out


class GroupedTask:
    """Grouped execution: run the plan once per leaf split group.

    Role parity: ``velox/exec/Task.h:151-171`` + ``TaskStructs.h:89``
    (ExecutionMode::kGrouped): leaf splits are partitioned into groups
    (hive bucket files) and the pipeline executes group-by-group, so
    group-local state (join builds, aggregation tables) is bounded by one
    group's data instead of the whole table — the HBM-budget tool for
    bucketed tables.

    Each group is a fresh serial Task with its scans pinned to
    the group's splits via the ``splits.{node_id}`` context mechanism.
    Scans on unbucketed tables are "mixed" (velox's mixed grouped
    execution): their full split list is replicated into every group —
    correct for broadcast-style build sides. Result correctness requires
    the plan's join/group keys to align with the table bucketing, exactly
    as in the reference.
    """

    def __init__(self, plan: P.PlanNode, ctx: Optional[QueryCtx] = None):
        self.plan = plan
        self.ctx = ctx or QueryCtx()
        self.group_tasks: List[Task] = []
        self._scan_groups = self._collect_groups()

    def _scan_nodes(self) -> List[P.TableScanNode]:
        out = []

        def walk(n):
            if isinstance(n, P.TableScanNode):
                out.append(n)
            for s in n.sources:
                walk(s)
        walk(self.plan)
        return out

    def _collect_groups(self):
        from velox_tpu.connectors.connector import get_connector
        groups: Dict[str, List] = {}
        n_groups = None
        for node in self._scan_nodes():
            conn = get_connector(node.connector_id)
            sg = conn.split_groups(node.table) \
                if hasattr(conn, "split_groups") else None
            if sg:
                if n_groups is None:
                    n_groups = len(sg)
                elif len(sg) != n_groups:
                    raise ValueError(
                        "grouped execution: scans have mismatched "
                        f"group counts ({len(sg)} vs {n_groups})")
                groups[node.id] = sg
        if n_groups is None:
            raise ValueError("grouped execution: no bucketed scan found")
        self.n_groups = n_groups
        return groups

    def run(self):
        import pyarrow as pa
        tables = []
        for g in range(self.n_groups):
            cfg = dict(self.ctx.config)
            for node in self._scan_nodes():
                if node.id in self._scan_groups:
                    cfg[f"splits.{node.id}"] = \
                        self._scan_groups[node.id][g]
            task = Task(self.plan, QueryCtx(cfg))
            self.group_tasks.append(task)
            t = task.run()
            if t.num_rows:
                tables.append(t)
        from velox_tpu.common import metrics as M
        M.record_counter(M.K_GROUPED_EXECUTIONS)
        if not tables:
            schema = T.to_arrow(self.plan.output_type())
            return pa.table({n: pa.array([], type=f.type)
                             for n, f in zip(schema.names, schema)})
        return pa.concat_tables(tables)
