"""Plan-level column statistics resolution.

Role parity: ``velox/exec/VectorHasher.h:274`` cardinality analysis +
parquet row-group stats — the reference decides hash-table modes and
normalized-key layouts from observed value ranges. Here ranges come from
connector metadata (``Connector.column_stats``) and propagate statically
through the plan, driving:

* normalized-key bit packing for sort/group-by (exec/sort.py): a key
  column with a known (min, max) contributes ceil(log2(range)) bits
  instead of full 32/64-bit words — fewer u64 sort lanes, smaller compiled
  programs;
* the fused filter-reduce's int64 overflow bound (ops/filter_reduce.py).

Stats are (min, max) STORAGE-int bounds and must be true bounds: the sort
packs values as ``value - min`` without clipping.
"""

from __future__ import annotations

from typing import Optional, Tuple

from velox_tpu.core import expressions as ex
from velox_tpu.core import plan as P


def resolve_column_stats(node: P.PlanNode,
                         name: str) -> Optional[Tuple[int, int]]:
    """(min, max) storage-int bounds of output column `name` of `node`,
    or None when unknown. Follows identity projections, filters, joins and
    aggregation grouping keys down to connector scan stats."""
    if isinstance(node, P.TableScanNode):
        from velox_tpu.connectors.connector import get_connector
        try:
            conn = get_connector(node.connector_id)
        except Exception:
            return None
        fn = getattr(conn, "column_stats", None)
        return fn(node.table, name) if fn is not None else None
    if isinstance(node, P.FilterNode):
        return resolve_column_stats(node.source, name)
    if isinstance(node, P.ProjectNode):
        for out, e in zip(node.names, node.expressions):
            if out == name:
                if isinstance(e, ex.FieldAccess):
                    return resolve_column_stats(node.source, e.name)
                return None
        return None
    if isinstance(node, (P.HashJoinNode, P.MergeJoinNode,
                         P.NestedLoopJoinNode)):
        lt = node.left.output_type()
        if name in lt.names:
            return resolve_column_stats(node.left, name)
        rt = node.right.output_type()
        if name in rt.names:
            return resolve_column_stats(node.right, name)
        return None
    if isinstance(node, P.AggregationNode):
        for k in node.grouping_keys:
            if k.name == name:
                return resolve_column_stats(node.source, name)
        return None
    if isinstance(node, (P.OrderByNode, P.TopNNode, P.LimitNode)):
        return resolve_column_stats(node.source, name)
    return None


def resolve_column_unique(node: P.PlanNode, name: str) -> bool:
    """True when output column `name` of `node` provably has no duplicate
    non-null values (a key). Drives the join build's unique-keys fast path
    WITHOUT a device round-trip (parity intent: velox decides hash modes
    from VectorHasher cardinality stats, exec/HashTable.cpp
    decideHashMode). Conservative: False when unknown.

    Propagation: connector primary-key hints at scans; row-subset
    operators (Filter/Limit/TopN/OrderBy) preserve; identity projections
    follow; a SINGLE/FINAL aggregation's sole grouping key is unique by
    construction; joins preserve a side's uniqueness when each of that
    side's rows can match at most one row of the other side (the other
    side's join key contains a unique column), or when the join emits a
    row subset of that side (semi/anti)."""
    if isinstance(node, P.TableScanNode):
        from velox_tpu.connectors.connector import get_connector
        try:
            conn = get_connector(node.connector_id)
        except Exception:
            return False
        fn = getattr(conn, "column_unique", None)
        return bool(fn(node.table, name)) if fn is not None else False
    if isinstance(node, P.FilterNode):
        return resolve_column_unique(node.source, name)
    if isinstance(node, P.ProjectNode):
        for out, e in zip(node.names, node.expressions):
            if out == name:
                if isinstance(e, ex.FieldAccess):
                    return resolve_column_unique(node.source, e.name)
                return False
        return False
    if isinstance(node, P.AggregationNode):
        if node.step in (P.AggregationStep.SINGLE,
                         P.AggregationStep.FINAL) \
                and len(node.grouping_keys) == 1 \
                and node.grouping_keys[0].name == name:
            return True
        return False
    if isinstance(node, (P.HashJoinNode, P.MergeJoinNode)):
        jt = node.join_type
        lt = node.left.output_type()
        if name in lt.names:
            if not resolve_column_unique(node.left, name):
                return False
            if jt in (P.JoinType.LEFT_SEMI_FILTER, P.JoinType.ANTI):
                return True  # row subset of the left side
            if jt in (P.JoinType.INNER, P.JoinType.LEFT):
                # n:1 — a superset of a unique key is unique
                return any(resolve_column_unique(node.right, k.name)
                           for k in node.right_keys)
            return False
        rt = node.right.output_type()
        if name in rt.names:
            if not resolve_column_unique(node.right, name):
                return False
            if jt is P.JoinType.RIGHT_SEMI_FILTER:
                return True
            if jt in (P.JoinType.INNER, P.JoinType.RIGHT):
                return any(resolve_column_unique(node.left, k.name)
                           for k in node.left_keys)
            return False
        return False
    if isinstance(node, (P.OrderByNode, P.TopNNode, P.LimitNode)):
        return resolve_column_unique(node.source, name)
    return False
