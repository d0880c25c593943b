"""Remote scalar functions: evaluate a UDF in an external process.

Role parity: ``velox/functions/remote`` (RemoteVectorFunction: batches are
serialized in a wire format, shipped to a sidecar function server, and the
result column deserialized back — velox/functions/remote/client/Remote.cpp).

The traced expression graph cannot leave the device program, so
the remote call rides ``jax.pure_callback`` — the compiled program yields
the argument columns to the host, the host round-trips them through the
transport in the SAME framed Arrow-IPC page format the exchange uses
(serializers/pages.py), and execution resumes with the returned column.
A backend that cannot call back into this host cannot run remote functions
mid-program (gate documented at registration).

Transports implement ``send(fn_name, payload: bytes) -> bytes``. The
in-process ``LoopbackTransport`` plays the reference's local test server
(velox/functions/remote/server/) and doubles as the SPI contract test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T
from velox_tpu.expression.eval import EvalValue
from velox_tpu.functions.registry import register


class RemoteTransport:
    def send(self, fn_name: str, payload: bytes) -> bytes:
        raise NotImplementedError


class LoopbackTransport(RemoteTransport):
    """In-process function server: deserializes the request page, applies
    a registered numpy callable, serializes the response page. Exercises
    the full wire path without a network."""

    def __init__(self):
        self._fns: Dict[str, Callable] = {}

    def serve(self, name: str, fn: Callable) -> None:
        """fn(*cols: np.ndarray, valid: np.ndarray) ->
        (np.ndarray, np.ndarray)."""
        self._fns[name] = fn

    def send(self, fn_name: str, payload: bytes) -> bytes:
        import pyarrow as pa
        reader = pa.ipc.open_stream(payload)
        table = reader.read_all()
        ncols = table.num_columns - 1
        cols = [np.asarray(table.column(i)) for i in range(ncols)]
        valid = np.asarray(table.column(ncols))
        out, out_valid = self._fns[fn_name](*cols, valid=valid)
        res = pa.table({"result": pa.array(np.asarray(out)),
                        "valid": pa.array(np.asarray(out_valid))})
        import io
        sink = io.BytesIO()
        with pa.ipc.new_stream(sink, res.schema) as w:
            w.write_table(res)
        return sink.getvalue()


@dataclass
class _RemoteSpec:
    name: str
    arg_types: List[T.DataType]
    result_type: T.DataType
    transport: RemoteTransport


def register_remote_function(name: str, arg_types, result_type,
                             transport: RemoteTransport) -> None:
    """Register a scalar function evaluated via a remote transport.
    Parity: velox registerRemoteFunction (functions/remote/client)."""
    arg_types = list(arg_types)
    for t in arg_types + [result_type]:
        if t.is_string or t.is_complex:
            raise NotImplementedError(
                "remote functions: numeric/bool argument and result "
                "types only")
    spec = _RemoteSpec(name, arg_types, result_type, transport)

    def eval_fn(ctx, out_dtype, args, _spec=spec):
        cap = ctx.capacity
        datas = [v.full_data(cap) for v in args]
        valid = jnp.ones((cap,), bool)
        for v in args:
            if v.validity is not None:
                valid = valid & v.full_validity(cap)

        def host(*arrays):
            import io
            import pyarrow as pa
            *cols, vd = arrays
            tbl = pa.table({**{f"a{i}": pa.array(np.asarray(c))
                               for i, c in enumerate(cols)},
                            "valid": pa.array(np.asarray(vd))})
            sink = io.BytesIO()
            with pa.ipc.new_stream(sink, tbl.schema) as w:
                w.write_table(tbl)
            resp = _spec.transport.send(_spec.name, sink.getvalue())
            rt = pa.ipc.open_stream(resp).read_all()
            return (np.asarray(rt.column("result"),
                               _spec.result_type.np_dtype()),
                    np.asarray(rt.column("valid"), np.bool_))

        out_shape = (jax.ShapeDtypeStruct(
            (cap,), _spec.result_type.np_dtype()),
            jax.ShapeDtypeStruct((cap,), np.bool_))
        data, out_valid = jax.pure_callback(host, out_shape,
                                            *datas, valid)
        return EvalValue(data, out_valid, _spec.result_type)

    def resolver(ts, _spec=spec):
        if len(ts) != len(_spec.arg_types):
            return None
        return _spec.result_type

    register(name, resolver, eval_fn)
