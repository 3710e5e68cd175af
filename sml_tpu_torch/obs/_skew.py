"""Per-device straggler / skew attribution, and per-chunk ingest
attribution.

The port's copy of `sml_tpu/obs/_skew.py`. A row-sharded histogram
program is bulk-synchronous: every device builds its partial histograms,
then an allreduce synchronizes them, so the program's wall time is the
SLOWEST device's compute plus the collective itself, and every faster
device spends the difference waiting. That is the straggler failure mode
"Understanding and Optimizing Distributed ML on Spark" (arXiv:1612.01437)
instruments per executor. One card runs no such program, so `SKEW` has
no feed of its own here: `straggler_report()` stays None unless a caller
notes a profile (the JAX package's behaviour on one chip). The chunked
ingest feeds `INGEST_SKEW` with each chunk's host quantization wall
(`ml/_chunked.py`), whose "devices" are chunk indices: the same
decomposition names the slowest ingest chunk.

Under the BSP model:

    wait_i   = max_j(compute_j) - compute_i     (straggler-induced idle)
    skew     = max_j(compute_j) / mean_j(compute_j)

Each `note()` also lands per-device `<prefix>.compute` / `<prefix>.wait`
spans in the flight recorder, which the Chrome-trace exporter renders as
one LANE PER DEVICE on the "per-device (skew)" process for `skew.*`.
`straggler_report()` aggregates every noted program: the slowest
device's identity, its wall-time share, the skew ratio, and the
collective payload carried.

Hot-path contract (tests/test_torch_engine_health.py): with the
recorder disabled, `note()` is a no-op behind one attribute load — no
allocation.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from ._recorder import RECORDER

_MAX_PROGRAMS = 1024  # bounded like the audit: attribution must not leak


def _stats(compute: Sequence[float]) -> Dict[str, object]:
    """BSP decomposition of one per-device compute profile."""
    n = len(compute)
    mx = max(compute)
    mean = sum(compute) / n
    slowest = max(range(n), key=lambda i: compute[i])
    waits = [mx - c for c in compute]
    total_wall = mx * n  # every device occupies the full sync interval
    return {
        "n_devices": n,
        "slowest_pos": slowest,
        "slowest_compute_s": mx,
        "mean_compute_s": mean,
        "skew_ratio": (mx / mean) if mean > 0 else 1.0,
        "wait_s": sum(waits),
        "wait_share": (sum(waits) / total_wall) if total_wall > 0 else 0.0,
        "per_device_wait_s": waits,
    }


class SkewTracker:
    """Accumulates per-program, per-device compute/wait attributions.

    `prefix` names the event family the tracker emits under ("skew" for
    the per-device tracker; "ingest" for the chunked data plane's
    per-CHUNK tracker, whose "device" ids are chunk indices — the same
    BSP decomposition names the slowest ingest chunk the way the device
    tracker names the slowest device)."""

    def __init__(self, prefix: str = "skew") -> None:
        self._rec = RECORDER
        self._prefix = prefix
        self._lock = threading.Lock()
        self._programs: List[Dict[str, object]] = []
        self._compute: Dict[int, float] = {}   # device -> total compute s
        self._wait: Dict[int, float] = {}      # device -> total wait s

    # ------------------------------------------------------------ recording
    def note(self, program: str, compute_s: Sequence[float], *,
             devices: Optional[Sequence[int]] = None,
             hosts: Optional[Sequence[int]] = None,
             t0: Optional[float] = None,
             wall_s: Optional[float] = None,
             psum_bytes: Optional[float] = None,
             psum_launches: Optional[float] = None) -> Optional[dict]:
        """Attribute one fused program: `compute_s[i]` is one device's
        measured compute seconds. `devices[i]` is that device's REAL id
        (the device index, so the report indicts the right physical
        device when shard row-order differs from device numbering;
        default = positional 0..n-1). `hosts[i]` is device i's HOST-GROUP index
        on a hierarchical layout: the same
        BSP decomposition then also runs one level up — a group's
        compute is its slowest member's (the group syncs internally
        before the DCN hop), and the report names the slowest HOST next
        to the slowest device, with `{prefix}.host.compute`/`.wait` lanes
        on the trace. `wall_s` (the fused program's actual wall)
        separates collective/dispatch overhead from the straggler wait;
        `psum_bytes`/`psum_launches` carry the collective volume. Returns the per-program attribution dict (None when the
        recorder is disabled)."""
        if not self._rec.enabled:
            return None
        compute = [float(c) for c in compute_s]
        if not compute:
            return None
        ids = ([int(d) for d in devices] if devices is not None
               else list(range(len(compute))))
        if len(ids) != len(compute):
            raise ValueError(f"{len(ids)} device ids for "
                             f"{len(compute)} compute timings")
        entry = _stats(compute)
        entry["program"] = program
        entry["devices"] = ids
        entry["per_device_compute_s"] = compute
        entry["slowest_device"] = ids[entry.pop("slowest_pos")]
        per_host: Dict[int, float] = {}
        if hosts is not None:
            gids = [int(g) for g in hosts]
            if len(gids) != len(compute):
                raise ValueError(f"{len(gids)} host-group ids for "
                                 f"{len(compute)} compute timings")
            for g, c in zip(gids, compute):
                per_host[g] = max(per_host.get(g, 0.0), c)
            entry["host_ids"] = sorted(per_host)
            entry["per_host_compute_s"] = [per_host[g]
                                           for g in entry["host_ids"]]
            entry["slowest_host"] = max(
                entry["host_ids"], key=lambda g: per_host[g])
        if wall_s is not None:
            entry["wall_s"] = float(wall_s)
            # the fused wall beyond the slowest device's compute: the
            # collective + dispatch overhead the BSP model cannot see
            entry["collective_overhead_s"] = max(
                0.0, float(wall_s) - entry["slowest_compute_s"])
        if psum_bytes is not None:
            entry["psum_bytes"] = float(psum_bytes)
        if psum_launches is not None:
            entry["psum_launches"] = float(psum_launches)
        with self._lock:
            if len(self._programs) >= _MAX_PROGRAMS:
                # the per-device totals must describe the SAME programs
                # the ring retains: back out the dropped half's
                # contributions (otherwise a long-lived process reports
                # all-time ratios next to recent-only psum sums)
                dropped = self._programs[: _MAX_PROGRAMS // 2]
                del self._programs[: _MAX_PROGRAMS // 2]
                for p in dropped:
                    for d, pc, pw in zip(p["devices"],
                                         p["per_device_compute_s"],
                                         p["per_device_wait_s"]):
                        self._compute[d] = max(
                            0.0, self._compute.get(d, 0.0) - pc)
                        self._wait[d] = max(
                            0.0, self._wait.get(d, 0.0) - pw)
            self._programs.append(entry)
            for d, c, wt in zip(ids, compute,
                                entry["per_device_wait_s"]):
                self._compute[d] = self._compute.get(d, 0.0) + c
                self._wait[d] = self._wait.get(d, 0.0) + wt
        # per-device lanes on the trace: compute span, then the wait span
        # up to the sync point (the slowest device's finish)
        start = time.perf_counter() if t0 is None else float(t0)
        mx = entry["slowest_compute_s"]
        for d, c in zip(ids, compute):
            # prefix is "skew" or "ingest" — both registered wildcard
            # families in obs/taxonomy.py (the tracker is instantiated
            # exactly twice: SKEW and INGEST_SKEW below)
            self._rec.emit("span", f"{self._prefix}.compute", dur=c,
                           ts=start, args={"device": d, "program": program})
            if mx - c > 0:
                self._rec.emit("span", f"{self._prefix}.wait", dur=mx - c,
                               ts=start + c,
                               args={"device": d, "program": program})
        if per_host:
            # host-level lanes: one per group, wait measured to the
            # slowest GROUP's finish — the DCN-hop sync point
            hmx = max(per_host.values())
            for g in sorted(per_host):
                c = per_host[g]
                self._rec.emit("span", f"{self._prefix}.host.compute",
                               dur=c, ts=start,
                               args={"host": g, "program": program})
                if hmx - c > 0:
                    self._rec.emit("span", f"{self._prefix}.host.wait",
                                   dur=hmx - c, ts=start + c,
                                   args={"host": g, "program": program})
        self._rec.emit(self._prefix, f"{self._prefix}.note", args={
            "program": program, "n_devices": entry["n_devices"],
            "slowest_device": entry["slowest_device"],
            "slowest_host": entry.get("slowest_host"),
            "skew_ratio": round(entry["skew_ratio"], 4),
            "wait_share": round(entry["wait_share"], 4),
            "psum_bytes": psum_bytes, "psum_launches": psum_launches})
        return entry

    # -------------------------------------------------------------- reading
    def programs(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._programs)

    def straggler_report(self) -> Optional[Dict[str, object]]:
        """Aggregate attribution across every noted program: which device
        the program waits on, how much of its wall time is that wait,
        and the collective volume carried. None when nothing was noted."""
        with self._lock:
            if not self._programs:
                return None
            programs = list(self._programs)
            compute = dict(self._compute)
            wait = dict(self._wait)
        return _aggregate(programs, compute, wait)

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._compute.clear()
            self._wait.clear()


def _aggregate(programs: List[dict], compute: Dict[int, float],
               wait: Dict[int, float]) -> Dict[str, object]:
    devices = sorted(compute)
    total_compute = sum(compute.values())
    total_wait = sum(wait.values())
    slowest = max(devices, key=lambda d: compute[d])
    mean = total_compute / len(devices)
    psum_bytes = sum(p.get("psum_bytes") or 0.0 for p in programs)
    launches = sum(p.get("psum_launches") or 0.0 for p in programs)
    # host-level roll-up over the programs that carried group ids
    # (multi-host probes): totals per group, wait to the slowest group
    hcomp: Dict[int, float] = {}
    hwait: Dict[int, float] = {}
    for p in programs:
        gids = p.get("host_ids")
        if not gids:
            continue
        comps = p["per_host_compute_s"]
        hmx = max(comps)
        for g, c in zip(gids, comps):
            hcomp[g] = hcomp.get(g, 0.0) + c
            hwait[g] = hwait.get(g, 0.0) + (hmx - c)
    host_block = {}
    if hcomp:
        hids = sorted(hcomp)
        hslow = max(hids, key=lambda g: hcomp[g])
        hmean = sum(hcomp.values()) / len(hids)
        host_block = {
            "n_hosts": len(hids),
            "slowest_host": hslow,
            "host_skew_ratio": round(hcomp[hslow] / hmean, 4)
            if hmean > 0 else 1.0,
            "per_host": [{"host": g,
                          "compute_s": round(hcomp[g], 6),
                          "wait_s": round(hwait[g], 6)} for g in hids],
        }
    return {
        **host_block,
        "n_devices": len(devices),
        "programs": len(programs),
        "slowest_device": slowest,
        "skew_ratio": round(compute[slowest] / mean, 4) if mean > 0 else 1.0,
        "wait_share": round(
            total_wait / (total_compute + total_wait), 4)
        if total_compute + total_wait > 0 else 0.0,
        "psum_bytes": psum_bytes,
        "psum_launches": launches,
        "per_device": [{"device": d,
                        "compute_s": round(compute[d], 6),
                        "wait_s": round(wait[d], 6)} for d in devices],
    }


def report_from_trace(trace_events: List[dict]) -> Optional[Dict[str, object]]:
    """Rebuild the straggler report from an EXPORTED Chrome trace's
    `skew.compute`/`skew.wait` lanes — the round-trip stability contract:
    the report derived from the trace names the same slowest device and
    skew ratio as the live tracker (tests/test_torch_engine_health.py)."""
    compute: Dict[int, float] = {}
    wait: Dict[int, float] = {}
    per_program: Dict[str, int] = {}
    for ev in trace_events:
        if ev.get("ph") != "X" or not str(ev.get("name", "")).startswith("skew."):
            continue
        dev = int(ev["args"]["device"])
        dur_s = float(ev.get("dur", 0.0)) / 1e6
        if ev["name"] == "skew.compute":
            compute[dev] = compute.get(dev, 0.0) + dur_s
            per_program[ev["args"].get("program", "?")] = 1
        elif ev["name"] == "skew.wait":
            wait[dev] = wait.get(dev, 0.0) + dur_s
    if not compute:
        return None
    for d in compute:
        wait.setdefault(d, 0.0)
    programs = [{"program": p} for p in per_program]
    return _aggregate(programs, compute, wait)


SKEW = SkewTracker()

#: per-CHUNK attribution for the out-of-core ingest pipeline
#: (ml/_chunked.py): "device" ids are CHUNK INDICES — the straggler
#: report names the slowest ingest chunk, surfaced as the `ingest`
#: block of obs.engine_health()
INGEST_SKEW = SkewTracker("ingest")
