"""Typed configuration registry (the `spark.conf` equivalent), for the
keys the tree-ensemble serving and fit paths read.

Known keys carry a type and a default; unknown `sml.*` keys raise on
`get` so a typo cannot silently read a default. Counterpart of
`sml_tpu/conf.py`, cut to the ported slices. The JAX package's
`sml.tree.kernel` and `sml.tree.kernelBlockRows` are not ported: on the
card there is one path (the kernel, or raise), and block sizes come from
the shapes, in each kernel's wrapper. Nor is `sml.tree.histSubtraction`:
the port always builds with subtraction, its default.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    caster: Callable[[str], Any]
    doc: str = ""


_KNOWN: Dict[str, ConfEntry] = {}


def _register(key: str, default: Any, caster: Callable[[str], Any],
              doc: str = "") -> None:
    _KNOWN[key] = ConfEntry(key, default, caster, doc)


_register("sml.serve.maxBatchRows", 4096, int,
          "Serving micro-batcher: max rows coalesced into one device "
          "launch; a full batch flushes immediately")
_register("sml.serve.flushMicros", 2000, int,
          "Serving micro-batcher: microseconds a partial batch waits for "
          "more requests before flushing (deadline from the OLDEST queued "
          "request). 0 = flush as soon as the worker is free")
_register("sml.serve.queueRows", 32768, int,
          "Serving admission bound: rows queued or in flight toward the "
          "device above which new requests shed instead of queueing")
_register("sml.serve.requestTimeoutMillis", 250, int,
          "Serving deadline: a request still undispatched this long after "
          "admission is shed at flush time. 0 = no deadline")
_register("sml.serve.modelCacheBytes", 1 << 30, int,
          "Byte budget for the serving multi-model LRU cache of warm "
          "DeviceScorers (costed by DeviceScorer.resident_bytes)")
_register("sml.predict.binCacheBytes", 1 << 30, int,
          "LRU byte bound for memoized predict-time binned matrices")
_register("sml.tree.binCacheBytes", 2 << 30, int,
          "Device-bytes budget for the content-keyed cache of staged "
          "compact bin matrices")


class TorchConf:
    """Thread-safe KV config with typed known keys and free-form extras."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._values: Dict[str, Any] = {}

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            ent = _KNOWN.get(key)
            if ent is not None and not isinstance(value, type(ent.default)):
                value = ent.caster(value)
            self._values[key] = value

    def get(self, key: str, default: Optional[Any] = None) -> Any:
        with self._lock:
            if key in self._values:
                return self._values[key]
            ent = _KNOWN.get(key)
            if ent is not None:
                return ent.default
            if default is not None:
                return default
            raise KeyError(f"No such config key: {key!r} — not registered "
                           f"in sml_tpu_torch/conf.py and never set()")

    def getInt(self, key: str) -> int:
        return int(self.get(key))


GLOBAL_CONF = TorchConf()
