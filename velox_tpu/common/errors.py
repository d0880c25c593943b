"""Structured error taxonomy.

Role parity: ``velox/common/base/VeloxException.h`` — user errors
(VeloxUserError: bad input data, div-by-zero, overflow, cast failures)
vs runtime errors (VeloxRuntimeError: engine invariant violations).

Error CHANNEL: dense masked execution cannot raise per row
inside a compiled program, so checked operations flag an error mask on
the EvalCtx (expression/eval.py); supersteps reduce it to a traced
per-batch count carried on the batch (vector/device.py DeviceBatch.errors)
which the Task collects and checks with ONE host fetch at query end —
the deferred analogue of velox's EvalCtx error vector + throw-on-demand
(expression/EvalCtx.h, TryExpr.h).
"""

from __future__ import annotations


class VeloxError(Exception):
    """Base for engine errors."""


class VeloxUserError(VeloxError):
    """Errors attributable to query/data (Presto USER_ERROR class):
    division by zero, integer overflow, invalid cast."""


class VeloxRuntimeError(VeloxError):
    """Engine invariant violations (Presto INTERNAL_ERROR class)."""


# raise_error() messages registered at TRACE time: the traced channel
# carries only a count, so the Task appends these notes to the raised
# VeloxUserError. Process-wide by design (messages are trace-time
# constants; a note may describe a program compiled for another query —
# the wording says "possibly").
TRACED_ERROR_NOTES: set = set()


def note_traced_error(msg: str) -> None:
    TRACED_ERROR_NOTES.add(str(msg))


def traced_error_suffix() -> str:
    if not TRACED_ERROR_NOTES:
        return ""
    return ("; possibly raise_error(): "
            + "; ".join(sorted(TRACED_ERROR_NOTES)))
