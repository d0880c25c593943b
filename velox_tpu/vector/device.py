"""Device-resident columnar batches (the HBM analogue of velox/vector).

Role parity: ``velox/vector/BaseVector.h:68`` (FlatVector / DictionaryVector /
ConstantVector and friends) and ``velox/vector/SelectivityVector.h``.

Departures from the reference:

* **Struct-of-arrays in HBM, statically shaped.** A ``DeviceBatch`` holds one
  dense jnp array per column, padded to a fixed ``capacity`` so every batch of
  a pipeline shares one compiled program. There is no per-batch encoding
  dispatch: encodings are *metadata resolved at trace time*.
* **SelectivityVector -> ``mask``.** Instead of per-row branching, an active
  row bitmask rides with the batch and operators execute densely, masking
  results. Filters AND into the mask; compaction happens only at
  operator boundaries that profit from it (exchange, output).
* **Dictionary encoding** survives only for strings: a column is int32 ids
  plus a *trace-stable* host dictionary (built per table by the connector so
  jit traces don't churn). DecodedVector (vector/DecodedVector.h:26) has no
  analogue — a gather is just a gather and XLA fuses it.
* **Constant/lazy vectors** collapse into trace-time constants and deferred
  host->device transfer, respectively.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from velox_tpu import types as T


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def default_capacity(n: int) -> int:
    """Pad row counts to multiples of 1024 with a floor of 1024."""
    return max(1024, round_up(n, 1024))


class Dictionary:
    """A trace-stable host-side value dictionary for a string column.

    Hash/eq by identity: passing the same Dictionary object across batches
    keeps jit traces cached; a different dictionary forces a (correct)
    retrace. Values are a numpy object array of Python str/bytes.
    """

    __slots__ = ("values", "_index", "is_sorted", "_arrow")

    def __init__(self, values):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[Dict] = None
        self.is_sorted = False  # memoized by ordered-comparison checks
        self._arrow = None

    def arrow(self):
        """Memoized pyarrow array of the values — the input to every
        C++-vectorized dictionary-space transform (scalar._dict_map_pa)."""
        cached = getattr(self, "_arrow", None)
        if cached is None:
            import pyarrow as pa
            cached = pa.array(self.values)
            try:
                self._arrow = cached
            except AttributeError:
                pass
        return cached

    def __len__(self):
        return len(self.values)

    def id_of(self, value) -> int:
        """Return the id of `value`, or -1 if absent (never matches)."""
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index.get(value, -1)

    def take(self, ids: np.ndarray) -> np.ndarray:
        """Materialize values for the given ids (overridable for lazily
        formatted dictionaries, e.g. tpch c_name)."""
        return self.values[np.clip(ids, 0, len(self) - 1)]

    def __repr__(self):
        return f"Dictionary({len(self.values)} values)"


@jax.tree_util.register_pytree_node_class
class DeviceColumn:
    """One column: dense data array + optional validity mask (True=non-null).

    data.shape == (capacity,) for scalars; strings are int32 dictionary ids
    into ``dictionary``. ``validity is None`` means no nulls (fast path).

    Complex types (ARRAY/MAP — parity velox/vector/ComplexVector.h) keep
    Arrow's offsets+values layout split for static shapes: ``data`` holds
    per-row element *lengths* (int32; starts are a cumsum away) and
    ``children`` holds the flattened element columns with their own
    (element) capacity: [values] for ARRAY, [keys, values] for MAP.
    """

    def __init__(self, data, validity=None, dtype: T.DataType = T.BIGINT,
                 dictionary: Optional[Dictionary] = None,
                 children: Optional[tuple] = None, starts=None):
        self.data = data
        self.validity = validity
        self.dtype = dtype
        self.dictionary = dictionary
        self.children = tuple(children) if children else ()
        # complex columns: EXPLICIT per-row element start offsets. None
        # means the dense layout (starts = cumsum(lens) - lens). Row
        # gathers through joins REORDER/DUPLICATE rows while SHARING the
        # element children, so the dense contract breaks — explicit
        # starts are Arrow/Velox's offsets for exactly this reason
        # (vector/ComplexVector.h rawOffsets).
        self.starts = starts

    def tree_flatten(self):
        leaves = (self.data,) + ((self.validity,)
                                 if self.validity is not None else ())
        leaves = leaves + self.children
        if self.starts is not None:
            leaves = leaves + (self.starts,)
        return leaves, \
            (self.validity is not None, self.dtype, self.dictionary,
             len(self.children), self.starts is not None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        has_validity, dtype, dictionary, n_children, has_starts = aux
        it = list(children)
        data = it[0]
        validity = it[1] if has_validity else None
        base = 1 + int(has_validity)
        kids = tuple(it[base:base + n_children])
        starts = it[base + n_children] if has_starts else None
        return cls(data, validity, dtype, dictionary, kids, starts)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def offsets(self):
        """Exclusive element start offsets for complex columns: the
        explicit starts when present (shared/reordered children), else
        derived from the dense lengths layout."""
        import jax.numpy as jnp
        if self.starts is not None:
            return self.starts.astype(jnp.int32)
        lens = self.data.astype(jnp.int32)
        return jnp.cumsum(lens) - lens

    def __repr__(self):
        return (f"DeviceColumn({self.dtype}, cap={self.capacity}, "
                f"nulls={'y' if self.validity is not None else 'n'}"
                f"{', children=%d' % len(self.children) if self.children else ''})")


@jax.tree_util.register_pytree_node_class
class DeviceBatch:
    """A batch of rows on device: named columns + an active-row mask.

    ``errors`` (optional) is a traced SCALAR count of checked-operation
    failures produced while computing this batch (common/errors.py): the
    Task strips and accumulates it per batch and raises VeloxUserError
    after one host fetch at query end.
    """

    def __init__(self, columns: Dict[str, DeviceColumn], mask,
                 errors=None):
        self.columns = columns
        self.mask = mask
        self.errors = errors

    def tree_flatten(self):
        names = tuple(self.columns)  # preserve column order
        leaves = tuple(self.columns[n] for n in names) + (self.mask,)
        if self.errors is not None:
            leaves = leaves + (self.errors,)
        return leaves, (names, self.errors is not None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        names, has_errors = aux
        if has_errors:
            *cols, mask, errors = children
        else:
            *cols, mask = children
            errors = None
        return cls(dict(zip(names, cols)), mask, errors)

    @property
    def capacity(self) -> int:
        return self.mask.shape[0]

    @property
    def names(self):
        return list(self.columns)

    def column(self, name: str) -> DeviceColumn:
        return self.columns[name]

    def num_active(self):
        """Traced count of active rows."""
        return jnp.sum(self.mask, dtype=jnp.int32)

    @property
    def nbytes(self) -> int:
        """Static device-memory footprint of this batch (data + validity
        + mask bytes, recursing into complex-type children) — the HBM
        traffic unit for roofline accounting (OperatorStats bytes,
        exec/task.py)."""
        def col_bytes(c) -> int:
            n = int(c.data.size) * c.data.dtype.itemsize
            if c.validity is not None:
                n += int(c.validity.size) * c.validity.dtype.itemsize
            for ch in (c.children or ()):
                n += col_bytes(ch)
            return n
        total = int(self.mask.size) * self.mask.dtype.itemsize
        for c in self.columns.values():
            total += col_bytes(c)
        return total

    def row_type(self) -> T.DataType:
        names = list(self.columns)
        return T.row(names, [self.columns[n].dtype for n in names])

    def with_mask(self, mask) -> "DeviceBatch":
        return DeviceBatch(self.columns, mask)

    def with_columns(self, columns) -> "DeviceBatch":
        return DeviceBatch(columns, self.mask)

    def __repr__(self):
        return f"DeviceBatch(cap={self.capacity}, cols={list(self.columns)})"


# ---------------------------------------------------------------------------
# Arrow bridge (host <-> device). Parity: velox/vector/arrow/Bridge.h:73-163.
# ---------------------------------------------------------------------------

def _pad_np(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    n = arr.shape[0]
    if n == capacity:
        return arr
    out = np.full((capacity,), fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def column_from_arrow(
    arr,
    capacity: int,
    dictionary: Optional[Dictionary] = None,
    string_encoding: str = "dict",
) -> DeviceColumn:
    """Convert one pyarrow Array/ChunkedArray to a DeviceColumn.

    ``string_encoding`` picks the VARCHAR representation:
      * "dict": sorted-dictionary ids (the low-cardinality encoding;
        string kernels run at trace time over the distinct set)
      * "raw":  device byte matrix + lengths (vector/strings.py — the
        scaling path for high-cardinality VARCHAR; parity:
        velox/type/StringView.h flat strings)
      * "auto": raw when the distinct count exceeds half the rows (a
        dictionary would materialize ~the column on the host) and the
        longest value fits the raw width classes
    """
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()

    dtype = T.from_arrow(arr.type)
    n = len(arr)

    validity_np = None
    if arr.null_count:
        validity_np = np.asarray(pc.is_valid(arr))

    if dtype.is_string and string_encoding != "dict" \
            and not pa.types.is_dictionary(arr.type):
        from velox_tpu.vector import strings as S
        use_raw = string_encoding == "raw"
        if string_encoding == "auto" and n:
            distinct = pc.count_distinct(arr).as_py()
            max_len = pc.max(pc.binary_length(arr)).as_py() or 0
            use_raw = distinct > n // 2 and max_len <= S.MAX_WIDTH
        if use_raw:
            bytes2d, lens, validity_np = S.pack_arrow(arr, capacity)
            validity = (jnp.asarray(validity_np)
                        if validity_np is not None else None)
            return S.raw_column(jnp.asarray(bytes2d), jnp.asarray(lens),
                                validity)

    if dtype.kind is T.TypeKind.ARRAY:
        lengths = np.asarray(pc.list_value_length(arr).fill_null(0),
                             dtype=np.int32)
        values = arr.flatten()
        elem_cap = default_capacity(len(values))
        child = column_from_arrow(values, elem_cap)
        data = jnp.asarray(_pad_np(lengths, capacity))
        validity = (jnp.asarray(_pad_np(validity_np, capacity, False))
                    if validity_np is not None else None)
        return DeviceColumn(data, validity, dtype, None, (child,))

    if dtype.kind is T.TypeKind.ROW:
        # struct: children are ROW-ALIGNED (share the parent capacity),
        # unlike ARRAY/MAP element children. Parity: velox RowVector
        # (vector/ComplexVector.h).
        kids = tuple(
            column_from_arrow(arr.field(i), capacity)
            for i in range(arr.type.num_fields))
        data = jnp.zeros((capacity,), jnp.int32)  # placeholder
        validity = (jnp.asarray(_pad_np(validity_np, capacity, False))
                    if validity_np is not None else None)
        return DeviceColumn(data, validity, dtype, None, kids)

    if dtype.kind is T.TypeKind.MAP:
        offs = np.asarray(arr.offsets, dtype=np.int64)
        lengths = np.diff(offs).astype(np.int32)
        if validity_np is not None:
            lengths = np.where(validity_np, lengths, 0).astype(np.int32)
        keys = arr.keys
        items = arr.items
        elem_cap = default_capacity(len(keys))
        kchild = column_from_arrow(keys, elem_cap)
        vchild = column_from_arrow(items, elem_cap)
        data = jnp.asarray(_pad_np(lengths, capacity))
        validity = (jnp.asarray(_pad_np(validity_np, capacity, False))
                    if validity_np is not None else None)
        return DeviceColumn(data, validity, dtype, None, (kchild, vchild))

    if dtype.is_string:
        if pa.types.is_dictionary(arr.type):
            darr = arr
        else:
            darr = pc.dictionary_encode(arr)
        ids = np.asarray(darr.indices.fill_null(0)).astype(np.int32)
        values = darr.dictionary.to_pylist()
        if dictionary is None and len(values) > 1:
            # Sort the local dictionary so ordered comparisons are valid in
            # id space (ids become order-preserving).
            order = sorted(range(len(values)), key=lambda i: values[i])
            remap = np.empty(len(values), dtype=np.int32)
            for new_id, old_id in enumerate(order):
                remap[old_id] = new_id
            ids = remap[ids]
            values = [values[i] for i in order]
        if dictionary is not None:
            # Remap local ids into the provided stable dictionary.
            remap = np.array(
                [dictionary.id_of(v) for v in values], dtype=np.int32
            )
            if (remap < 0).any():
                missing = [v for v, r in zip(values, remap) if r < 0]
                raise ValueError(
                    f"values {missing[:5]} missing from stable dictionary"
                )
            ids = remap[ids]
            dict_out = dictionary
        else:
            dict_out = Dictionary(values)
        data_np = _pad_np(ids, capacity)
        col_dict = dict_out
    elif dtype.kind is T.TypeKind.DECIMAL:
        if dtype.is_long_decimal:
            # decimal128 -> two int64 limbs read straight off the
            # 16-byte little-endian storage buffer (lo = primary data,
            # hi = child column; ops/int128.py). Parity: type/HugeInt.h.
            combined = arr.combine_chunks() if hasattr(
                arr, "combine_chunks") else arr
            buf = combined.buffers()[1]
            off = combined.offset
            limbs = np.frombuffer(
                buf, dtype=np.int64,
                count=2 * (off + n))[2 * off:].reshape(-1, 2)
            lo = jnp.asarray(_pad_np(
                np.ascontiguousarray(limbs[:, 0]), capacity))
            hi_col = DeviceColumn(
                jnp.asarray(_pad_np(
                    np.ascontiguousarray(limbs[:, 1]), capacity)),
                None, T.BIGINT, None)
            validity = (jnp.asarray(_pad_np(validity_np, capacity,
                                            False))
                        if validity_np is not None else None)
            return DeviceColumn(lo, validity, dtype, None, (hi_col,))
        # decimal128 -> scaled int64 (short decimals). Slow path via
        # python objects; hot ingest (dbgen) builds scaled ints directly.
        ints = np.array(
            [0 if d is None else int(d.scaleb(dtype.scale))
             for d in arr.to_pylist()],
            dtype=np.int64)
        data_np = _pad_np(ints, capacity)
        col_dict = None
    elif dtype.kind is T.TypeKind.TIMESTAMP:
        data_np = _pad_np(
            np.asarray(arr.cast(pa.timestamp("us"))).astype(np.int64),
            capacity)
        col_dict = None
    elif dtype.kind is T.TypeKind.DATE:
        data_np = _pad_np(
            np.asarray(arr.cast(pa.int32())).astype(np.int32), capacity)
        col_dict = None
    elif dtype.kind is T.TypeKind.UNKNOWN:
        data_np = np.zeros((capacity,), dtype=np.bool_)
        validity_np = np.zeros((n,), dtype=np.bool_)
        col_dict = None
    else:
        if arr.null_count:
            arr = arr.fill_null(
                False if pa.types.is_boolean(arr.type) else 0)
        data_np = _pad_np(np.asarray(arr).astype(dtype.np_dtype()), capacity)
        col_dict = None

    validity = None
    if validity_np is not None:
        validity = jnp.asarray(_pad_np(validity_np, capacity, fill=False))

    return DeviceColumn(jnp.asarray(data_np), validity, dtype, col_dict)


def from_arrow(
    table,
    capacity: Optional[int] = None,
    dictionaries: Optional[Dict[str, Dictionary]] = None,
    string_encoding: str = "dict",
) -> DeviceBatch:
    """pyarrow Table/RecordBatch -> DeviceBatch (padded, masked)."""
    n = table.num_rows
    cap = capacity if capacity is not None else default_capacity(n)
    if n > cap:
        raise ValueError(f"{n} rows exceed capacity {cap}")
    dictionaries = dictionaries or {}
    enc = ((lambda n_: string_encoding.get(n_, "dict"))
           if isinstance(string_encoding, dict)
           else (lambda n_: string_encoding))
    cols = {
        name: column_from_arrow(table.column(name), cap,
                                dictionaries.get(name),
                                string_encoding=enc(name))
        for name in table.schema.names
    }
    mask = jnp.arange(cap, dtype=jnp.int32) < n
    return DeviceBatch(cols, mask)


def column_to_numpy(col: DeviceColumn) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    data = np.asarray(jax.device_get(col.data))
    validity = (
        np.asarray(jax.device_get(col.validity))
        if col.validity is not None else None
    )
    return data, validity


def to_arrow(batch: DeviceBatch):
    """DeviceBatch -> pyarrow Table (active rows only, in order)."""
    import pyarrow as pa

    # ONE bulk device_get for the whole batch pytree: a single fetch
    # amortizes the round trip across all columns/validities/children.
    batch = jax.device_get(batch)
    mask = np.asarray(batch.mask)
    arrays, names = [], []
    for name, col in batch.columns.items():
        if col.dtype.is_complex:
            arrays.append(_complex_to_arrow(col, mask))
        elif col.dtype.is_long_decimal:
            arrays.append(_long_decimal_to_arrow(col, mask))
        elif col.dtype.is_string and col.dictionary is None \
                and getattr(col.data, "ndim", 1) == 2:
            # raw (flat) string column: byte matrix + lens child
            from velox_tpu.vector import strings as S
            data, validity = column_to_numpy(col)
            lens = np.asarray(jax.device_get(col.children[0].data))
            valid = validity[mask] if validity is not None else None
            arrays.append(S.to_arrow(data[mask], lens[mask], valid))
        else:
            data, validity = column_to_numpy(col)
            data = data[mask]
            valid = validity[mask] if validity is not None else None
            arrays.append(_np_to_arrow(data, valid, col))
        names.append(name)
    return pa.table(arrays, names=names)


def _long_decimal_to_arrow(col: DeviceColumn, mask: np.ndarray):
    """Long decimal (lo data + hi child limb) -> pyarrow decimal128."""
    import decimal as pydec

    import pyarrow as pa

    from velox_tpu.ops.int128 import to_numpy_ints
    lo, validity = column_to_numpy(col)
    hi = np.asarray(jax.device_get(col.children[0].data))
    ints = to_numpy_ints(lo[mask], hi[mask])
    valid = validity[mask] if validity is not None else None
    s = col.dtype.scale
    with pydec.localcontext() as c:
        c.prec = 50  # default 28 silently rounds 38-digit values
        vals = [
            (None if (valid is not None and not v)
             else pydec.Decimal(int(x)).scaleb(-s))
            for x, v in zip(ints, valid if valid is not None
                            else np.ones(len(ints), bool))
        ]
    return pa.array(vals, type=T.to_arrow(col.dtype))


def _complex_to_arrow(col: DeviceColumn, mask: np.ndarray):
    """ARRAY/MAP column -> pyarrow, gathering each active row's element
    slice from the flattened children."""
    import pyarrow as pa

    validity = (np.asarray(jax.device_get(col.validity))
                if col.validity is not None else None)
    if col.dtype.kind is T.TypeKind.ROW:
        pa_valid = None if validity is None else validity[mask]
        fields = []
        for child, fname in zip(col.children, col.dtype.names):
            if child.dtype.is_complex:
                fields.append(_complex_to_arrow(child, mask))
            else:
                d, v = column_to_numpy(child)
                fields.append(_np_to_arrow(
                    d[mask], v[mask] if v is not None else None, child))
        out = pa.StructArray.from_arrays(fields,
                                         names=list(col.dtype.names))
        if pa_valid is not None and not pa_valid.all():
            indices = pa.array(
                np.where(pa_valid, np.arange(len(pa_valid)), -1),
                pa.int32(), mask=~pa_valid)
            out = out.take(indices)
        return out
    lengths = np.asarray(jax.device_get(col.data)).astype(np.int64)
    if getattr(col, "starts", None) is not None:
        # shared-slice layout (array carried through a join): explicit
        # per-row starts into the shared children
        starts = np.asarray(jax.device_get(col.starts)).astype(np.int64)
    else:
        starts = np.cumsum(lengths) - lengths
    act_len = lengths[mask]
    act_start = starts[mask]
    idx = np.concatenate([np.arange(s, s + l) for s, l in
                          zip(act_start, act_len)]) \
        if len(act_len) else np.zeros(0, np.int64)
    offsets = np.concatenate([[0], np.cumsum(act_len)]).astype(np.int32)
    pa_valid = None if validity is None else validity[mask]

    def child_values(child: DeviceColumn):
        if child.dtype.is_complex:
            if getattr(col, "starts", None) is not None:
                # shared-slice parent: idx may duplicate/reorder nested
                # ranges, which the boolean-mask gather below cannot
                # express — refuse instead of emitting misaligned rows
                raise NotImplementedError(
                    "extracting a nested complex column carried through "
                    "a join is not supported; project it before the join")
            m = np.zeros(child.capacity, bool)
            m[idx] = True
            # preserve order: _complex_to_arrow gathers in mask order ==
            # ascending index order == idx order (idx is sorted per row)
            return _complex_to_arrow(child, m)
        data, valid = column_to_numpy(child)
        return _np_to_arrow(data[idx],
                            valid[idx] if valid is not None else None,
                            child)

    if col.dtype.kind is T.TypeKind.ARRAY:
        values = child_values(col.children[0])
        out = pa.ListArray.from_arrays(pa.array(offsets, pa.int32()),
                                       values)
    else:  # MAP
        keys = child_values(col.children[0])
        items = child_values(col.children[1])
        out = pa.MapArray.from_arrays(pa.array(offsets, pa.int32()),
                                      keys, items)
    if pa_valid is not None and not pa_valid.all():
        # re-wrap with the null bitmap (pyarrow from_arrays lacks mask arg)
        indices = pa.array(
            np.where(pa_valid, np.arange(len(pa_valid)), -1),
            pa.int32(),
            mask=~pa_valid)
        out = out.take(indices)
    return out


def _np_to_arrow(data: np.ndarray, validity: Optional[np.ndarray],
                 col: DeviceColumn):
    import pyarrow as pa

    dt = col.dtype
    pa_mask = None if validity is None else ~validity
    if dt.is_string:
        if col.dictionary is None:
            raise ValueError("string column without dictionary")
        out = col.dictionary.take(data)
        if validity is not None:
            out = out.copy()
            out[~validity] = None
        return pa.array(out.tolist(), type=T.to_arrow(dt))
    if dt.kind is T.TypeKind.DECIMAL:
        import decimal as pydec
        q = pydec.Decimal(1).scaleb(-dt.scale)
        vals = [
            (None if (validity is not None and not v)
             else pydec.Decimal(int(x)).scaleb(-dt.scale))
            for x, v in zip(
                data, validity if validity is not None else
                np.ones(len(data), bool))
        ]
        return pa.array(vals, type=T.to_arrow(dt))
    if dt.kind is T.TypeKind.TIMESTAMP:
        return pa.array(data.astype("datetime64[us]"), mask=pa_mask)
    if dt.kind is T.TypeKind.DATE:
        return pa.array(data, type=pa.date32(), mask=pa_mask)
    if dt.kind is T.TypeKind.UNKNOWN:
        return pa.nulls(len(data))
    return pa.array(data, mask=pa_mask)
