"""Hive connector: file-based table scans and writes (Parquet + ORC).

Role parity: ``velox/connectors/hive`` (HiveDataSource splits/partitions,
HiveDataSink) + the dwio reader stack. Per SURVEY.md §7.4, file decoding on
the device is out of scope: pyarrow's Parquet and ORC readers play the role of
the dwio readers (dwio/parquet; the ORC flavor of dwio/dwrf — DWRF proper,
Meta's pre-ORC fork, has no host decoder in this image and stays out of
scope), and this connector supplies the split model (one split = a
row-group/stripe range of one file, parity connectors/hive/
HiveConnectorSplit), column pruning, and device upload with trace-stable
dictionaries.

String dictionaries: ordered comparisons run in dictionary-id space, which
requires one *sorted, table-stable* dictionary per column. The connector
builds them once per (file set, column) with a metadata/first-scan pass and
caches them — the analogue of the reference's per-file stride dictionaries,
hoisted to table scope so every split shares one compiled program.
"""

from __future__ import annotations

import glob as globmod
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from velox_tpu import types as T
from velox_tpu.connectors.connector import (
    Connector, ConnectorSplit, DataSink, DataSource, register_connector,
)
from velox_tpu.vector.device import (
    DeviceBatch, Dictionary, default_capacity, from_arrow,
)


@dataclass(frozen=True)
class HiveSplit(ConnectorSplit):
    """One row-group range of one file.
    Parity: connectors/hive/HiveConnectorSplit."""
    path: str = ""
    row_group_lo: int = 0
    row_group_hi: int = 0  # exclusive


# ---------------------------------------------------------------------------
# File-format layer. Parity: the dwio reader dispatch (dwio/common/
# ReaderFactory.h registers per-format readers; dwio/parquet + the ORC
# flavor of dwio/dwrf). Per SURVEY §7.4 decoding happens on the host via
# pyarrow; this layer maps both formats onto the ONE split model above —
# a parquet row group and an ORC stripe are the same unit here. DWRF
# (Meta's pre-ORC fork) has no host-side decoder in this image and stays
# out of scope.
# ---------------------------------------------------------------------------

def file_format(path: str) -> str:
    return "orc" if path.endswith(".orc") else "parquet"


_ORC_CACHE: Dict = {}  # (path, id(fs)) -> ORCFile; reopen-per-call was
# one open_input_file + footer parse per split/helper on remote fs


def _orc_file(path: str, fs=None):
    import pyarrow.orc as orc
    if fs is None:
        stamp = (os.path.getmtime(path), os.path.getsize(path))
    else:
        info = fs.get_file_info(path)
        stamp = (info.mtime_ns, info.size)
    key = (path, id(fs) if fs is not None else None, stamp)
    f = _ORC_CACHE.get(key)
    if f is None:
        f = orc.ORCFile(fs.open_input_file(path) if fs is not None
                        else path)
        if len(_ORC_CACHE) > 64:
            _ORC_CACHE.clear()
        _ORC_CACHE[key] = f
    return f


def _read_schema(path: str, fs=None):
    if file_format(path) == "orc":
        return _orc_file(path, fs).schema
    import pyarrow.parquet as pq
    return pq.read_schema(path, filesystem=fs)


def _num_row_groups(path: str, fs=None) -> int:
    if file_format(path) == "orc":
        return _orc_file(path, fs).nstripes
    import pyarrow.parquet as pq
    return pq.ParquetFile(path, filesystem=fs).metadata.num_row_groups


def _row_group_sizes(path: str, fs=None) -> List[int]:
    """Rows per row group / stripe. Parquet reads footer metadata; ORC
    (pyarrow exposes no per-stripe row counts) reads the first column of
    each stripe — paid once per table, cached by the caller."""
    if file_format(path) == "orc":
        f = _orc_file(path, fs)
        col = [f.schema.names[0]] if f.schema.names else None
        return [f.read_stripe(i, columns=col).num_rows
                for i in range(f.nstripes)]
    import pyarrow.parquet as pq
    md = pq.ParquetFile(path, filesystem=fs).metadata
    return [md.row_group(i).num_rows for i in range(md.num_row_groups)]


def _read_row_groups(path: str, fs, lo: int, hi: int, columns):
    import pyarrow as pa
    if file_format(path) == "orc":
        f = _orc_file(path, fs)
        cols = list(columns)
        drop = []
        if not cols and f.schema.names:
            # partition-column-only scans: ORC read_stripe(columns=[])
            # returns num_rows=0 (unlike parquet) — read the first
            # column to carry the row count, then drop it
            drop = [f.schema.names[0]]
            cols = drop
        batches = [f.read_stripe(i, columns=cols)
                   for i in range(lo, hi)]
        t = pa.Table.from_batches(
            batches, schema=batches[0].schema if batches else None)
        return t.drop_columns(drop) if drop else t
    import pyarrow.parquet as pq
    pf = pq.ParquetFile(path, filesystem=fs)
    return pf.read_row_groups(list(range(lo, hi)), columns=columns)


def _read_table(path: str, fs, columns):
    if file_format(path) == "orc":
        return _orc_file(path, fs).read(columns=list(columns))
    import pyarrow.parquet as pq
    return pq.read_table(path, columns=columns, filesystem=fs)


def _path_partitions(path: str) -> Dict[str, str]:
    """Hive partition values from ``key=value`` path segments."""
    out: Dict[str, str] = {}
    for seg in os.path.dirname(path).split(os.sep):
        if "=" in seg:
            k, _, v = seg.partition("=")
            out[k] = v
    return out


class HiveTable:
    """A registered file-backed table (list of parquet files). Hive
    ``key=value`` directory segments become VARCHAR partition columns
    (parity: HiveConnectorSplit partitionKeys). ``fs`` is a pyarrow
    filesystem for remote storage (S3/GCS adapters — parity:
    connectors/hive/storage_adapters/)."""

    def __init__(self, name: str, paths: List[str], fs=None,
                 string_encoding: str = "dict"):
        self.name = name
        self.fs = fs
        # VARCHAR representation policy: "dict" | "raw" | "auto"
        # ("auto" probes each string column's first row group once and
        # picks raw when distinct > rows/2 — the cardinality regime
        # where a table-stable dictionary would materialize ~the whole
        # column on the host; see vector/strings.py)
        self.string_encoding = string_encoding
        self._raw_cols: Optional[set] = None
        self.paths = sorted(paths)
        if not self.paths:
            raise ValueError(f"hive table {name!r}: no files")
        self.schema_arrow = _read_schema(self.paths[0], fs)
        self.partitions = {p: _path_partitions(p) for p in self.paths}
        self.partition_cols = sorted(
            {k for ps in self.partitions.values() for k in ps})
        names = (list(self.schema_arrow.names)
                 + [c for c in self.partition_cols
                    if c not in self.schema_arrow.names])
        types = [T.from_arrow(f.type) for f in self.schema_arrow] \
            + [T.VARCHAR] * (len(names) - len(self.schema_arrow.names))
        self.row_type = T.row(names, types)
        self._dictionaries: Optional[Dict[str, Dictionary]] = None
        self._max_row_group_rows: Optional[int] = None

    def raw_string_cols(self, columns=None) -> set:
        """String columns read as RAW byte matrices instead of
        dictionaries (table-stable decision; see string_encoding)."""
        if self.string_encoding == "dict":
            return set()
        if self._raw_cols is None:
            self._raw_cols = set()
            str_cols = [f.name for f in self.schema_arrow
                        if T.from_arrow(f.type).is_string]
            if self.string_encoding == "raw":
                self._raw_cols.update(str_cols)
            elif str_cols:
                from velox_tpu.vector import strings as S
                import pyarrow.compute as pc
                t = _read_row_groups(self.paths[0], self.fs, 0, 1,
                                     str_cols)
                for c in str_cols:
                    col = t.column(c)
                    n = len(col)
                    if not n:
                        continue
                    distinct = pc.count_distinct(col).as_py()
                    max_len = pc.max(pc.binary_length(col)).as_py() or 0
                    if distinct > n // 2 and max_len <= S.MAX_WIDTH:
                        self._raw_cols.add(c)
        return (self._raw_cols if columns is None
                else self._raw_cols & set(columns))

    def dictionaries(self, columns=None) -> Dict[str, Dictionary]:
        """Sorted table-stable dictionaries, built LAZILY PER COLUMN:
        only string columns a query actually scans pay the distinct
        pass (a scan of numeric columns never touches e.g. the
        unique-ish comment column). The per-column pass itself is
        O(distinct) host work — the documented cost of dict-id strings
        (SURVEY §7.1); columns whose distinct count approaches the row
        count read as RAW byte matrices instead (raw_string_cols)."""
        if self._dictionaries is None:
            self._dictionaries = {}
            for c in self.partition_cols:
                vals = {ps.get(c) for ps in self.partitions.values()}
                self._dictionaries[c] = Dictionary(
                    sorted(v for v in vals if v is not None))
        raw = self.raw_string_cols()
        str_cols = [f.name for f in self.schema_arrow
                    if T.from_arrow(f.type).is_string
                    and (columns is None or f.name in columns)
                    and f.name not in self._dictionaries
                    and f.name not in raw]
        if str_cols:
            import pyarrow.compute as pc
            uniq = {c: set() for c in str_cols}
            for p in self.paths:
                t = _read_table(p, self.fs, str_cols)
                for c in str_cols:
                    col = t.column(c)
                    vals = pc.unique(col.combine_chunks()).to_pylist()
                    uniq[c].update(v for v in vals if v is not None)
            for c in str_cols:
                self._dictionaries[c] = Dictionary(sorted(uniq[c]))
        return self._dictionaries

    def max_row_group_rows(self) -> int:
        if self._max_row_group_rows is None:
            m = 1
            for p in self.paths:
                m = max(m, max(_row_group_sizes(p, self.fs), default=1))
            self._max_row_group_rows = m
        return self._max_row_group_rows

    def splits(self) -> List[HiveSplit]:
        out = []
        for p in self.paths:
            for i in range(_num_row_groups(p, self.fs)):
                out.append(HiveSplit("hive", p, i, i + 1))
        return out


class HiveDataSource(DataSource):
    """Parity: connectors/hive/HiveDataSource.cpp:205 (split readers with
    column pruning; batches padded to one table-wide capacity)."""

    def __init__(self, table: HiveTable, columns: Sequence[str],
                 capacity: Optional[int] = None):
        self._table = table
        self._columns = list(columns)
        self._capacity = capacity or default_capacity(
            table.max_row_group_rows())
        self._done: set = set()

    def dictionaries(self) -> Dict[str, Dictionary]:
        d = self._table.dictionaries(columns=self._columns)
        return {c: d[c] for c in self._columns if c in d}

    def next(self, split: HiveSplit) -> Optional[DeviceBatch]:
        key = (split.path, split.row_group_lo)
        if key in self._done:
            return None
        self._done.add(key)
        from velox_tpu.connectors.cache import DataCache
        fs = self._table.fs
        if fs is None:
            mtime = os.path.getmtime(split.path)  # invalidate on rewrite
            size = os.path.getsize(split.path)
        else:
            info = fs.get_file_info(split.path)
            # some filesystems (e.g. fsspec memory) report no mtime;
            # the size rides the key so rewrites still invalidate there
            mtime = info.mtime_ns or 0
            size = info.size
        ckey = ("hive", split.path, mtime, size, split.row_group_lo,
                split.row_group_hi, tuple(self._columns), self._capacity)
        cached = DataCache.instance().get(ckey)
        if cached is not None:
            return cached
        pcols = [c for c in self._columns
                 if c in self._table.partition_cols]
        fcols = [c for c in self._columns if c not in pcols]
        t = _read_row_groups(split.path, fs, split.row_group_lo,
                             split.row_group_hi, fcols)
        if pcols:
            # partition values are path metadata -> constant columns
            import pyarrow as pa
            part = self._table.partitions[split.path]
            for c in pcols:
                t = t.append_column(
                    c, pa.array([part.get(c)] * t.num_rows, pa.string()))
            t = t.select(self._columns)
        enc = {c: "raw"
               for c in self._table.raw_string_cols(self._columns)}
        batch = from_arrow(t, capacity=self._capacity,
                           dictionaries=self.dictionaries(),
                           string_encoding=enc)
        DataCache.instance().put(ckey, batch)
        return batch


def _np_murmur3(cols: List[np.ndarray]) -> np.ndarray:
    """Vectorized Spark murmur3 over int-valued columns (host side, for
    bucket assignment at write time; mirrors functions/sparksql.py)."""
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    def mix(h1, k1):
        k1 = rotl(k1 * c1, 15) * c2
        h1 = rotl(h1 ^ k1, 13)
        return h1 * np.uint32(5) + np.uint32(0xE6546B64)

    h = np.full(len(cols[0]), 42, np.uint32)
    nbytes = 0
    with np.errstate(over="ignore"):
        for c in cols:
            u = c.astype(np.int64).view(np.uint64) \
                if c.dtype.itemsize == 8 else \
                c.astype(np.int32).view(np.uint32).astype(np.uint64)
            if c.dtype.itemsize == 8:
                h = mix(h, (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
                h = mix(h, (u >> np.uint64(32)).astype(np.uint32))
                nbytes = 8
            else:
                h = mix(h, u.astype(np.uint32))
                nbytes = 4
            h = h ^ np.uint32(nbytes)
            h ^= h >> np.uint32(16)
            h *= np.uint32(0x85EBCA6B)
            h ^= h >> np.uint32(13)
            h *= np.uint32(0xC2B2AE35)
            h ^= h >> np.uint32(16)
    return h


class HiveDataSink(DataSink):
    """Writes device batches to parquet files — plain, hive-partitioned
    (``key=value`` directories, partition columns dropped from file data),
    and/or bucketed (rows hashed on the bucket keys into
    ``bucket_count`` files per partition).
    Parity: connectors/hive/HiveDataSink.h:206-276 (HiveInsertTableHandle
    partitioned/bucketed writes)."""

    def __init__(self, path: str, partition_keys: Sequence[str] = (),
                 bucket_count: int = 0, bucket_keys: Sequence[str] = (),
                 file_format: str = None):
        self.path = path
        self.partition_keys = list(partition_keys)
        self.bucket_count = int(bucket_count)
        self.bucket_keys = list(bucket_keys)
        # format from the target path extension unless given explicitly
        # (parity: HiveInsertTableHandle tableStorageFormat)
        self.file_format = file_format or globals()["file_format"](path)
        self._tables = []
        self.rows_written = 0
        self.bytes_written = 0
        self.files_written: List[str] = []

    def append(self, batch: DeviceBatch) -> None:
        from velox_tpu.vector.device import to_arrow
        t = to_arrow(batch)
        self._tables.append(t)
        self.rows_written += t.num_rows

    def _write_file(self, table, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self.file_format == "orc":
            import pyarrow.orc as orc
            orc.write_table(table, path)
        else:
            import pyarrow.parquet as pq
            pq.write_table(table, path)
        self.bytes_written += os.path.getsize(path)
        self.files_written.append(path)

    def _write_buckets(self, table, dirpath):
        import pyarrow as pa
        cols = [np.asarray(table.column(k).combine_chunks()
                           .fill_null(0)) for k in self.bucket_keys]
        bucket = _np_murmur3(cols).view(np.int32) % self.bucket_count
        bucket = np.abs(bucket)
        ext = "orc" if self.file_format == "orc" else "parquet"
        for b in range(self.bucket_count):
            sel = table.filter(pa.array(bucket == b))
            if sel.num_rows:
                self._write_file(
                    sel, os.path.join(dirpath, f"{b:05d}_0_part.{ext}"))

    def close(self):
        import pyarrow as pa
        if not self._tables:
            return
        table = pa.concat_tables(self._tables)
        self._tables = []
        if not self.partition_keys and not self.bucket_count:
            self._write_file(table, self.path)
            return
        if not self.partition_keys:
            self._write_buckets(table, self.path)
            return
        # hive layout: one key=value directory level per partition key;
        # partition columns are path metadata, not file data
        import pandas as pd
        pcols = {k: table.column(k).to_pylist()
                 for k in self.partition_keys}
        df = pd.DataFrame(pcols)
        data = table.drop_columns(self.partition_keys)
        for combo, idx in df.groupby(self.partition_keys,
                                     dropna=False).groups.items():
            if len(self.partition_keys) == 1:
                combo = (combo,)
            segs = [f"{k}={v}" for k, v in zip(self.partition_keys, combo)]
            dirpath = os.path.join(self.path, *segs)
            sub = data.take(pa.array(np.asarray(idx, np.int64)))
            if self.bucket_count:
                self._write_buckets(sub, dirpath)
            else:
                ext = "orc" if self.file_format == "orc" else "parquet"
                self._write_file(
                    sub, os.path.join(dirpath, f"part-0.{ext}"))


class HiveConnector(Connector):
    """Parity: connectors/hive/HiveConnector.h."""

    def __init__(self, connector_id: str = "hive"):
        super().__init__(connector_id)
        self._tables: Dict[str, HiveTable] = {}

    def register_table(self, name: str, path_or_glob: str,
                       filesystem=None,
                       string_encoding: str = "dict") -> HiveTable:
        """Register parquet files as a table. ``path_or_glob`` may be a
        local path/glob, an ``s3://``/``gs://`` URI (resolved via
        pyarrow.fs — parity: connectors/hive/storage_adapters/s3fs,
        gcs), or any path paired with an explicit pyarrow
        ``filesystem``."""
        fs = filesystem
        path = path_or_glob
        if fs is None and "://" in path_or_glob \
                and not path_or_glob.startswith("file://"):
            from pyarrow import fs as pafs
            try:
                fs, path = pafs.FileSystem.from_uri(path_or_glob)
            except Exception as e:  # no credentials / unsupported scheme
                raise ValueError(
                    f"cannot open {path_or_glob!r}: {e}") from e
        if fs is not None:
            from pyarrow import fs as pafs
            info = fs.get_file_info(path)
            if info.type == pafs.FileType.Directory:
                sel = pafs.FileSelector(path, recursive=True)
                paths = [f.path for f in fs.get_file_info(sel)
                         if f.path.endswith((".parquet", ".orc"))]
            else:
                paths = [path]
            t = HiveTable(name, paths, fs=fs,
                          string_encoding=string_encoding)
        else:
            if os.path.isdir(path):
                paths = (globmod.glob(os.path.join(
                    path, "**", "*.parquet"), recursive=True)
                    + globmod.glob(os.path.join(
                        path, "**", "*.orc"), recursive=True))
            else:
                paths = globmod.glob(path) or [path]
            t = HiveTable(name, paths,
                          string_encoding=string_encoding)
        self._tables[name] = t
        return t

    def table_schema(self, table: str) -> T.DataType:
        return self._tables[table].row_type

    def create_data_source(self, table: str, columns, ctx) -> HiveDataSource:
        cap = ctx.get("hive.batch_capacity") if ctx is not None else None
        return HiveDataSource(self._tables[table], columns, cap)

    def create_data_sink(self, path: str, partition_keys=(),
                         bucket_count=0, bucket_keys=(),
                         file_format: str = None) -> HiveDataSink:
        return HiveDataSink(path, partition_keys, bucket_count,
                            bucket_keys, file_format=file_format)

    def default_splits(self, table: str, ctx=None) -> List[HiveSplit]:
        return self._tables[table].splits()

    def split_groups(self, table: str) -> Optional[List[List[HiveSplit]]]:
        """Bucket-aligned split groups for grouped execution (exec/task.py
        GroupedTask; parity velox Task.h:151). Bucket files are named
        ``{bucket:05d}_0_*.parquet`` (HiveDataSink); the same bucket id
        across partitions lands in one group. None if not bucketed."""
        import re
        t = self._tables[table]
        by_bucket: Dict[int, List[HiveSplit]] = {}
        for s in t.splits():
            m = re.match(r"^(\d{5})_", os.path.basename(s.path))
            if not m:
                return None
            by_bucket.setdefault(int(m.group(1)), []).append(s)
        if len(by_bucket) < 2:
            return None
        return [by_bucket[b] for b in sorted(by_bucket)]

    def prune_splits(self, table: str, splits: List[HiveSplit],
                     filter_expr) -> List[HiveSplit]:
        """Drop splits whose parquet row-group statistics (or hive
        partition values) cannot satisfy the pushed-down filter.
        Parity: dwio ScanSpec stride skipping + partition pruning.
        Conservative: a split is dropped only when its stats PROVE no row
        matches; missing stats keep the split."""
        import pyarrow.parquet as pq
        ranges = extract_column_ranges(filter_expr)
        if not ranges:
            return splits
        t = self._tables[table]
        md_cache: Dict[str, object] = {}
        name_idx: Dict[str, Dict[str, int]] = {}
        kept = []
        for s in splits:
            part = t.partitions.get(s.path, {})
            drop = False
            for col, (lo, hi) in ranges.items():
                if col in part:
                    v = part[col]
                    if lo is not None and str(v) == v and v < str(lo):
                        drop = True
                    if hi is not None and str(v) == v and v > str(hi):
                        drop = True
                    if lo is not None and lo == hi and v != str(lo):
                        drop = True
                if drop:
                    break
            if not drop and file_format(s.path) == "orc":
                # pyarrow exposes no per-stripe ORC statistics: keep the
                # split (conservative); partition pruning above applies
                kept.append(s)
                continue
            if not drop:
                md = md_cache.get(s.path)
                if md is None:
                    md = pq.ParquetFile(s.path,
                                        filesystem=t.fs).metadata
                    md_cache[s.path] = md
                    name_idx[s.path] = {
                        md.schema.column(i).name: i
                        for i in range(md.num_columns)}
                idx = name_idx[s.path]
                for rg_i in range(s.row_group_lo, s.row_group_hi):
                    rg = md.row_group(rg_i)
                    for col, (lo, hi) in ranges.items():
                        ci = idx.get(col)
                        if ci is None:
                            continue
                        st = rg.column(ci).statistics
                        if st is None or not st.has_min_max:
                            continue
                        try:
                            if lo is not None and st.max < lo:
                                drop = True
                            if hi is not None and st.min > hi:
                                drop = True
                        except TypeError:
                            continue  # incomparable literal: keep
                    if drop:
                        break
            if not drop:
                kept.append(s)
        if len(kept) < len(splits):
            from velox_tpu.common import metrics as M
            M.record_counter(M.K_SPLITS_PRUNED,
                             len(splits) - len(kept))
        return kept


def register_hive(connector_id: str = "hive") -> HiveConnector:
    conn = HiveConnector(connector_id)
    register_connector(conn)
    return conn


# ---------------------------------------------------------------------------
# Row-group statistics pruning. Parity: dwio/common/ScanSpec filters +
# parquet row-group stats (the reference skips strides whose min/max cannot
# satisfy the pushed-down filter).
# ---------------------------------------------------------------------------

def extract_column_ranges(expr) -> Dict[str, Tuple]:
    """Conjunctive (lo, hi) bounds per column from a pushed-down filter:
    walks AND trees of ``col <cmp> literal`` / BETWEEN. None bound = open."""
    from velox_tpu.core import expressions as ex
    out: Dict[str, List] = {}

    def bound(col, lo, hi):
        cur = out.setdefault(col, [None, None])
        if lo is not None:
            cur[0] = lo if cur[0] is None else max(cur[0], lo)
        if hi is not None:
            cur[1] = hi if cur[1] is None else min(cur[1], hi)

    def lit(e):
        if not isinstance(e, ex.Constant):
            return None
        # scaled DECIMAL literals (0.05 stored as 5) are NOT comparable to
        # raw file statistics -> never prune on them
        if e.dtype.kind is T.TypeKind.DECIMAL:
            return None
        return e.value

    def walk(e):
        if not isinstance(e, ex.Call):
            return
        if e.name == "and":
            for a in e.args:
                walk(a)
            return
        if e.name == "between" and isinstance(e.args[0], ex.FieldAccess):
            lo, hi = lit(e.args[1]), lit(e.args[2])
            bound(e.args[0].name, lo, hi)
            return
        if e.name in ("eq", "lt", "lte", "gt", "gte") and len(e.args) == 2:
            a, b = e.args
            flip = {"lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte",
                    "eq": "eq"}
            if isinstance(b, ex.FieldAccess) and lit(a) is not None:
                a, b = b, a
                name = flip[e.name]
            elif isinstance(a, ex.FieldAccess) and lit(b) is not None:
                name = e.name
            else:
                return
            v = lit(b)
            if name == "eq":
                bound(a.name, v, v)
            elif name in ("lt", "lte"):
                bound(a.name, None, v)
            else:
                bound(a.name, v, None)

    walk(expr)
    return {k: tuple(v) for k, v in out.items()}
