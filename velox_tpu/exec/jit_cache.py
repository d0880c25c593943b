"""Cross-task cache of jitted operator programs.

Re-tracing + lowering a large traced program (merge-rank join probe,
large sorts) costs seconds per jax.jit call even with the persistent
compile cache hitting — and operators used to create fresh jits per Task.
Keying the jitted callables by plan node (plus any trace-time state)
removes that per-query cost, the same way exec/fuse.py caches fused
chains and exec/aggregation.py caches its step programs.

Keys MUST include everything the traced function reads from ``self`` that
is not derived deterministically from the plan node (e.g. data-dependent
flags like a join's unique-build bit, or host dictionaries baked at trace
time).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

_CACHE: Dict = {}


def cached_jit(key: Tuple, make: Callable):
    """Return the cached callable for `key`, building it via `make()` on
    first use. Each first build counts toward the compile-budget metric
    (distinct traced PROGRAMS per process — the cold-wall driver;
    bench.py reports per-query program counts from this counter)."""
    fn = _CACHE.get(key)
    if fn is None:
        fn = make()
        _CACHE[key] = fn
        from velox_tpu.common import metrics as M
        M.record_counter(M.K_JIT_PROGRAMS)
    return fn


def program_count() -> int:
    """Distinct cached programs created so far in this process."""
    return len(_CACHE)
