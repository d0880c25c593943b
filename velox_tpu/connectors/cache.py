"""Device-resident scan cache with an optional SSD (disk) tier.

Role parity: ``velox/common/caching/AsyncDataCache.h:698`` — the reference
caches decoded file chunks in RAM so repeated scans skip IO. Here the cached
unit is the *staged device batch* of one split (generation/decode + host->
device upload are the expensive ingest steps), keyed by
(connector, table, columns, split, capacity), with a byte budget and LRU
eviction. The SSD tier (``SsdTier``) mirrors ``common/caching/SsdCache.h``:
entries evicted from HBM persist to a disk directory with a checkpointed
index, so cache contents survive both memory pressure and process restarts
(SsdFile checkpoint parity).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from velox_tpu.exec.memory import batch_nbytes
from velox_tpu.vector.device import DeviceBatch

DEFAULT_BUDGET = 8 << 30  # 8 GiB of HBM for cached scans


class SsdTier:
    """Disk tier: evicted entries persist as pickled HostBatches under a
    directory with a JSON index checkpoint. Parity:
    common/caching/SsdCache.h:27 + SsdFile checkpointing."""

    INDEX = "index.json"

    def __init__(self, directory: str, budget_bytes: int = 64 << 30):
        self.dir = directory
        self.budget = budget_bytes
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._index: "OrderedDict[str, int]" = OrderedDict()  # id->bytes
        self.used = 0
        self.hits = 0
        self.misses = 0
        path = os.path.join(directory, self.INDEX)
        if os.path.exists(path):  # checkpoint recovery
            with open(path) as f:
                for k, sz in json.load(f):
                    if os.path.exists(self._path(k)):
                        self._index[k] = sz
                        self.used += sz

    @staticmethod
    def entry_id(key) -> str:
        return hashlib.sha256(repr(key).encode()).hexdigest()[:32]

    def _path(self, eid: str) -> str:
        return os.path.join(self.dir, f"{eid}.bin")

    def _checkpoint_locked(self):
        tmp = os.path.join(self.dir, self.INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump(list(self._index.items()), f)
        os.replace(tmp, os.path.join(self.dir, self.INDEX))

    def put(self, key, batch: DeviceBatch):
        from velox_tpu.exec.memory import HostBatch
        eid = self.entry_id(key)
        blob = pickle.dumps(HostBatch(batch))
        with self._lock:
            if eid in self._index:
                return
            while self.used + len(blob) > self.budget and self._index:
                old, sz = self._index.popitem(last=False)
                try:
                    os.unlink(self._path(old))
                except OSError:
                    pass
                self.used -= sz
            with open(self._path(eid), "wb") as f:
                f.write(blob)
            self._index[eid] = len(blob)
            self.used += len(blob)
            self._checkpoint_locked()
        from velox_tpu.common import metrics as M
        M.record_counter(M.K_SSD_CACHE_WRITES)
        M.record_counter(M.K_SSD_CACHE_WRITE_BYTES, len(blob))

    def get(self, key) -> Optional[DeviceBatch]:
        from velox_tpu.common import metrics as M
        eid = self.entry_id(key)
        with self._lock:
            if eid not in self._index:
                self.misses += 1
                M.record_counter(M.K_SSD_CACHE_MISSES)
                return None
            self._index.move_to_end(eid)
            self.hits += 1
            M.record_counter(M.K_SSD_CACHE_HITS)
        try:
            with open(self._path(eid), "rb") as f:
                return pickle.load(f).restore()
        except (OSError, pickle.UnpicklingError):
            return None

    def stats(self):
        return {"used": self.used, "budget": self.budget,
                "entries": len(self._index), "hits": self.hits,
                "misses": self.misses}


class DataCache:
    """LRU cache of staged device batches with a byte budget."""

    _instance: Optional["DataCache"] = None

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET):
        from velox_tpu.exec.memory import MemoryArbitrator, MemoryPool
        self.budget = budget_bytes
        self.used = 0
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[Tuple, Tuple[DeviceBatch, int]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        # cached scans are re-loadable: first in line for arbitration
        # (parity: AsyncDataCache shrink under memory pressure,
        # common/caching/AsyncDataCache.h:698)
        self._pool = MemoryPool.device_root()
        MemoryArbitrator.instance().register(
            self, MemoryArbitrator.PRI_CACHE)
        self._ssd: Optional[SsdTier] = None

    def enable_ssd(self, directory: str, budget_bytes: int = 64 << 30):
        """Attach the disk tier (parity: SsdCache behind AsyncDataCache).
        Evicted entries spill to `directory`; misses check it before
        regenerating; the index survives restarts."""
        self._ssd = SsdTier(directory, budget_bytes)
        return self._ssd

    @classmethod
    def instance(cls) -> "DataCache":
        if cls._instance is None:
            from velox_tpu.common.flags import get_flag
            budget = int(get_flag("scan_cache_bytes")) or DEFAULT_BUDGET
            cls._instance = cls(budget)
            ssd_dir = get_flag("ssd_cache_dir")
            if ssd_dir:
                cls._instance.enable_ssd(ssd_dir)
        return cls._instance

    def get(self, key) -> Optional[DeviceBatch]:
        from velox_tpu.common import metrics as M
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                M.record_counter(M.K_SCAN_CACHE_HITS)
                return hit[0]
            self.misses += 1
            M.record_counter(M.K_SCAN_CACHE_MISSES)
        if self._ssd is not None:
            batch = self._ssd.get(key)
            if batch is not None:
                self.put(key, batch)  # promote back into HBM
                return batch
        return None

    def put(self, key, batch: DeviceBatch) -> None:
        n = batch_nbytes(batch)
        if n > self.budget:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop_bytes(old[1])
            while self.used + n > self.budget and self._entries:
                from velox_tpu.common import metrics as M
                k, (b, sz) = self._entries.popitem(last=False)
                M.record_counter(M.K_SCAN_CACHE_EVICTIONS)
                if self._ssd is not None:
                    self._ssd.put(k, b)  # demote to the disk tier
                self._drop_bytes(sz)
            if not self._pool.reserve(n):
                # HBM root capped: don't cache rather than oust operator
                # state (the arbitrator can't help — WE are its first
                # eviction target)
                return
            self._entries[key] = (batch, n)
            self.used += n

    def _drop_bytes(self, n: int):
        self.used -= n
        self._pool.release(n)

    def reclaim(self, needed: int) -> int:
        """Arbitrator hook: evict LRU entries until `needed` freed
        (demoting to the SSD tier when attached)."""
        with self._lock:
            freed = 0
            while self._entries and freed < needed:
                k, (b, sz) = self._entries.popitem(last=False)
                if self._ssd is not None:
                    self._ssd.put(k, b)
                self._drop_bytes(sz)
                freed += sz
            return freed

    def clear(self):
        with self._lock:
            self._pool.release(self.used)
            self._entries.clear()
            self.used = 0

    def stats(self):
        return {"used": self.used, "budget": self.budget,
                "entries": len(self._entries), "hits": self.hits,
                "misses": self.misses}
