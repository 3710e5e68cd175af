"""Device memory ledger: live bytes and high-water marks per pool.

The port's copy of `sml_tpu/obs/_ledger.py`. The card's memory has
three long-lived tenants, each with its own byte budget but no shared
accounting: the bin cache (`ml/_staging.py`'s quantized bin matrices),
the staging cache (its fold and element stacks) and the boosted fits'
margin (`ml/tree_impl.py`); the chunked ingest charges its resident
matrix to a transient `chunk_stage` pool while it assembles. Byte counts
are the tensors' `numel * element_size` on the device. The ledger
tracks live bytes and peaks per pool (and in total), emitting
`hbm.<pool>_bytes` gauge events into the flight recorder so the Chrome
trace gets counter tracks for device residency.

Accounting is ALWAYS on (the call sites are staging and eviction
operations, already dominated by their copies); only the gauge events
are gated on the recorder, so `memory_report()` is truthful even when
recording starts mid-process.
"""

from __future__ import annotations

import threading
from typing import Dict

from ._recorder import RECORDER

# the pools the port allocates into (new call sites should add their
# pool here so memory_report's ordering stays stable)
POOLS = ("bin_cache", "stage_cache", "boost_margin", "chunk_stage")


class MemoryLedger:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pools: Dict[str, Dict[str, float]] = {}
        self._total_live = 0
        self._total_peak = 0

    def _pool(self, name: str) -> Dict[str, float]:
        p = self._pools.get(name)
        if p is None:
            p = self._pools[name] = {"live": 0, "peak": 0,
                                     "allocs": 0, "frees": 0}
        return p

    def alloc(self, pool: str, nbytes: int) -> None:
        with self._lock:
            p = self._pool(pool)
            p["live"] += int(nbytes)
            p["peak"] = max(p["peak"], p["live"])
            p["allocs"] += 1
            self._total_live += int(nbytes)
            self._total_peak = max(self._total_peak, self._total_live)
            live, total = p["live"], self._total_live
        if RECORDER.enabled:
            RECORDER.gauge(f"hbm.{pool}_bytes", live)
            RECORDER.gauge("hbm.total_bytes", total)

    def free(self, pool: str, nbytes: int) -> None:
        with self._lock:
            p = self._pool(pool)
            p["live"] = max(0, p["live"] - int(nbytes))
            p["frees"] += 1
            self._total_live = max(0, self._total_live - int(nbytes))
            live, total = p["live"], self._total_live
        if RECORDER.enabled:
            RECORDER.gauge(f"hbm.{pool}_bytes", live)
            RECORDER.gauge("hbm.total_bytes", total)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {k: dict(v) for k, v in self._pools.items()}
            out["_total"] = {"live": self._total_live,
                             "peak": self._total_peak}
            return out

    def peak_total(self) -> int:
        with self._lock:
            return int(self._total_peak)

    def reset_peaks(self) -> None:
        """Re-arm high-water marks at the current live level (live bytes
        describe real cache residency and are never zeroed by a reset)."""
        with self._lock:
            for p in self._pools.values():
                p["peak"] = p["live"]
                p["allocs"] = p["frees"] = 0
            self._total_peak = self._total_live


LEDGER = MemoryLedger()


def report() -> str:
    snap = LEDGER.snapshot()
    total = snap.pop("_total")
    lines = [f"{'pool':<16}{'live_mb':>10}{'peak_mb':>10}"
             f"{'allocs':>8}{'frees':>8}"]
    for name in list(POOLS) + sorted(set(snap) - set(POOLS)):
        p = snap.get(name)
        if p is None:
            continue
        lines.append(f"{name:<16}{p['live'] / 1e6:>10.1f}"
                     f"{p['peak'] / 1e6:>10.1f}"
                     f"{int(p['allocs']):>8}{int(p['frees']):>8}")
    lines.append(f"{'TOTAL':<16}{total['live'] / 1e6:>10.1f}"
                 f"{total['peak'] / 1e6:>10.1f}")
    return "\n".join(lines)
