"""Byte-bounded multi-model LRU cache of warm `DeviceScorer`s.

Counterpart of `sml_tpu/serving/_cache.py`. Warm scorers are keyed by
(model name, version) and bounded by `DeviceScorer.resident_bytes` (the
tables a warm scorer pins on the card) under `sml.serve.modelCacheBytes`.
Eviction is LRU by touch; evicting a scorer drops the cache's reference,
so its device tensors free once in-flight batches finish.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

from ..conf import GLOBAL_CONF
from ..utils.profiler import PROFILER


class ModelCache:
    def __init__(self, max_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], Tuple[object, int]] = {}
        self._bytes = 0
        self._max_bytes = max_bytes

    def _budget(self) -> int:
        if self._max_bytes is not None:
            return int(self._max_bytes)
        return GLOBAL_CONF.getInt("sml.serve.modelCacheBytes")

    def get(self, name: str, version, loader: Callable[[], object]):
        """The warm scorer for (name, version), built by `loader` on a
        miss. Concurrent misses for one key may both load; the first
        insert wins."""
        key = (str(name), str(version))
        with self._lock:
            hit = self._entries.pop(key, None)
            if hit is not None:
                self._entries[key] = hit  # move-to-end LRU touch
        if hit is not None:
            PROFILER.count("serve.model_cache_hit")
            return hit[0]
        scorer = loader()
        cost = int(scorer.resident_bytes())
        evicted = 0
        with self._lock:
            if key not in self._entries:
                self._entries[key] = (scorer, cost)
                self._bytes += cost
                budget = self._budget()
                while self._bytes > budget and len(self._entries) > 1:
                    old = next(iter(self._entries))
                    _, old_cost = self._entries.pop(old)
                    self._bytes -= old_cost
                    evicted += old_cost
        PROFILER.count("serve.model_cache_miss")
        if evicted:
            PROFILER.count("serve.model_cache_evict_bytes", float(evicted))
        return scorer

    def invalidate(self, name: str, version=None) -> None:
        """Drop one version, or every version of `name`."""
        with self._lock:
            for key in [k for k in self._entries
                        if k[0] == str(name)
                        and (version is None or k[1] == str(version))]:
                _, cost = self._entries.pop(key)
                self._bytes -= cost

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}


#: process-wide default (endpoints share warm scorers unless given their own)
MODEL_CACHE = ModelCache()
