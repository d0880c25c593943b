"""Scalar function registry.

Role parity: ``velox/functions/FunctionRegistry.h`` + the
SimpleFunctionAdapter machinery (velox/expression/SimpleFunctionAdapter.h:68).
There is no scalar-vs-vector function split — every function is a
batch-level traced JAX computation, so the reference's template adapter that
vectorizes scalar lambdas has no analogue; XLA *is* the vectorizer.

A function is registered as (name, type_resolver, eval_fn):
  type_resolver(arg_types) -> DataType or None (None = signature mismatch)
  eval_fn(ctx, out_dtype, args: list[EvalValue]) -> EvalValue
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from velox_tpu import types as T

_REGISTRY: Dict[str, List["ScalarFunction"]] = {}


class ScalarFunction:
    def __init__(self, name: str, resolver, eval_fn):
        self.name = name
        self.resolver = resolver
        self.eval_fn = eval_fn

    def eval(self, ctx, out_dtype, args):
        return self.eval_fn(ctx, out_dtype, args)


def register(name: str, resolver, eval_fn, *, overwrite: bool = False):
    fns = _REGISTRY.setdefault(name, [])
    if overwrite:
        fns.clear()
    fns.append(ScalarFunction(name, resolver, eval_fn))


def scalar(name: str, resolver):
    """Decorator: @scalar('plus', numeric_resolver)."""
    def deco(fn):
        register(name, resolver, fn)
        return fn
    return deco


def lookup(name: str, arg_types) -> ScalarFunction:
    for fn in _REGISTRY.get(name, ()):
        if fn.resolver(arg_types) is not None:
            return fn
    raise KeyError(
        f"no function {name}({', '.join(map(str, arg_types))}) registered; "
        f"known names: {sorted(_REGISTRY)[:40]}...")


def resolve_return_type(name: str, arg_types) -> T.DataType:
    from velox_tpu.functions import scalar as _impls  # noqa: F401 (populate)
    for fn in _REGISTRY.get(name, ()):
        rt = fn.resolver(arg_types)
        if rt is not None:
            return rt
    # Special forms resolved here too (they bypass the registry at eval).
    if name in ("and", "or", "not", "is_null", "is_not_null", "in",
                "between", "isnull", "isnotnull"):
        return T.BOOLEAN
    if name in ("if", "coalesce", "switch", "try", "nvl", "ifnull"):
        for a in arg_types[1:] if name == "if" else arg_types:
            if a.kind is not T.TypeKind.UNKNOWN:
                return a
        return T.UNKNOWN
    raise KeyError(
        f"cannot resolve return type of {name}"
        f"({', '.join(map(str, arg_types))})")


def function_names():
    from velox_tpu.functions import scalar as _impls  # noqa: F401
    return sorted(_REGISTRY)
