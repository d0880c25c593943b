"""Pipeline fusion: collapse Filter/Project chains into one superstep.

Role parity: ``velox/exec/FilterProject`` fusion + the reference's LocalPlanner
pipeline construction (exec/LocalPlanner.cpp) — but the payoff here is
different: every operator dispatch costs host latency, and every distinct
jitted program costs compile time, so collapsing a scan-filter -> project ->
... chain into ONE traced function both removes dispatches and shrinks the
compile surface. XLA then fuses the whole superstep into a single pass over the
batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from velox_tpu import types as T
from velox_tpu.core import expressions as ex
from velox_tpu.core import plan as P


def substitute(e: ex.TypedExpr,
               mapping: Dict[str, ex.TypedExpr]) -> ex.TypedExpr:
    """Replace FieldAccess nodes by the producing expressions (inlining)."""
    if isinstance(e, ex.FieldAccess):
        return mapping.get(e.name, e)
    if isinstance(e, ex.Call):
        args = tuple(substitute(a, mapping) for a in e.args)
        if args == e.args:
            return e
        return ex.Call(e.dtype, e.name, args)
    if isinstance(e, ex.Cast):
        child = substitute(e.child, mapping)
        if child is e.child:
            return e
        return ex.Cast(e.dtype, child, is_try=e.is_try)
    return e


class FusedChain:
    """A collapsed Filter/Project chain over a source plan node.

    predicate: conjunction of all filters (rewritten to source columns);
    names/exprs: final output projections (rewritten to source columns).
    """

    def __init__(self, source: P.PlanNode,
                 predicate: Optional[ex.TypedExpr],
                 names: List[str], exprs: List[ex.TypedExpr]):
        self.source = source
        self.predicate = predicate
        self.names = names
        self.exprs = exprs

    @property
    def is_identity(self) -> bool:
        if self.predicate is not None:
            return False
        st = self.source.output_type()
        return (list(self.names) == list(st.names)
                and all(isinstance(e, ex.FieldAccess) and e.name == n
                        for n, e in zip(self.names, self.exprs)))


def collapse_chain(node: P.PlanNode) -> FusedChain:
    """Collapse the longest Filter/Project(/scan-filter) chain ending at
    `node` into one FusedChain. AND-combined filters are evaluated against
    the values visible at their own position (correct under inlining
    because projections are pure)."""
    if isinstance(node, P.FilterNode):
        inner = collapse_chain(node.source)
        mapping = dict(zip(inner.names, inner.exprs))
        pred = substitute(node.predicate, mapping)
        if inner.predicate is not None:
            pred = ex.Call(T.BOOLEAN, "and", (inner.predicate, pred))
        return FusedChain(inner.source, pred, inner.names, inner.exprs)
    if isinstance(node, P.ProjectNode):
        inner = collapse_chain(node.source)
        mapping = dict(zip(inner.names, inner.exprs))
        exprs = [substitute(e, mapping) for e in node.expressions]
        return FusedChain(inner.source, inner.predicate,
                          list(node.names), exprs)
    if isinstance(node, P.TableScanNode) and node.filter is not None:
        st = node.output_type()
        names = list(st.names)
        exprs = [ex.field(n, t) for n, t in zip(st.names, st.children)]
        # strip the filter from the scan node: it is now part of the chain
        import dataclasses
        bare = dataclasses.replace(node, filter=None)
        # keep the original predicate visible for split pruning
        # (Task._make_scan reads it; execution uses the fused chain)
        object.__setattr__(bare, "prune_filter", node.filter)
        return FusedChain(bare, node.filter, names, exprs)
    st = node.output_type()
    names = list(st.names)
    exprs = [ex.field(n, t) for n, t in zip(st.names, st.children)]
    return FusedChain(node, None, names, exprs)


_FN_CACHE: Dict[P.PlanNode, object] = {}


def cached_chain(node: P.PlanNode):
    """(FusedChain, jitted fn) with the fn cached by plan node — plan nodes
    are frozen dataclasses, so structurally identical (sub)plans across
    Task instances share ONE compiled program instead of re-jitting per
    operator instance.

    The CHAIN is always collapsed fresh: ValuesNode equality deliberately
    ignores its data payload (tables, hash=False), so a cached
    chain.source could point at another plan's data. The traced program
    itself is payload-independent (pure structure), so caching the fn by
    node equality is sound."""
    import jax
    chain = collapse_chain(node)
    fn = _FN_CACHE.get(node)
    if fn is None:
        fn = jax.jit(chain_fn(chain))
        _FN_CACHE[node] = fn
    return chain, fn


def chain_fn(chain: FusedChain):
    """Pure traced DeviceBatch -> DeviceBatch function for a FusedChain."""
    import jax.numpy as jnp

    from velox_tpu.expression.eval import ExprSet
    from velox_tpu.vector.device import DeviceBatch

    def fn(batch: DeviceBatch) -> DeviceBatch:
        mask = batch.mask
        err = jnp.zeros((batch.capacity,), bool)
        if chain.predicate is not None:
            # predicate evaluates on all active rows; its errors count.
            # Projections then evaluate logically only on PASSING rows:
            # their errors on filtered-out rows do NOT count (velox
            # FilterProject error semantics).
            sink = []
            f = ExprSet([chain.predicate], None).eval_batch(
                batch, err_sink=sink)[0]
            if sink[0] is not None:
                err = err | (sink[0] & mask)
            passed = f.full_data(batch.capacity).astype(bool)
            if f.validity is not None:
                passed = passed & f.full_validity(batch.capacity)
            mask = mask & passed
        sink = []
        vals = ExprSet(list(chain.exprs), None).eval_batch(
            batch, err_sink=sink)
        if sink[0] is not None:
            err = err | (sink[0] & mask)
        cols = {
            name: v.to_column(batch.capacity)
            for name, v in zip(chain.names, vals)
        }
        prior = batch.errors if batch.errors is not None else 0
        return DeviceBatch(cols, mask,
                           errors=prior + jnp.sum(err, dtype=jnp.int32))

    return fn
