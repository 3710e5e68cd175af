"""The traced run's device timeline, from `torch.profiler`.

The window is the span of a `record_function` marker around the traced
fits. Device time is every CUDA activity (kernels, copies, sets) inside
it; `busy_s` is the union of their intervals, so overlapping work counts
once. Launches are the host's runtime-API launch calls. Each idle gap of
the device is put down to the innermost host operation open at its
middle (or to host code outside any recorded operation).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
#: host runtime-API calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")
OUTSIDE_OPS = "host code outside any recorded operation"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments or
    parameters."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        if stop in s:
            s = s[:s.index(stop)]
    return s.strip() or name[:80]


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every event but the
    device's copies of host annotations (a `record_function` range shows
    on the device's timeline too, and is no device work)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        if dev and (e.name() == WINDOW
                    or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        if hasattr(e, "start_ns"):
            start, dur = int(e.start_ns()), int(e.duration_ns())
        else:
            start, dur = int(e.start_us()) * 1000, int(e.duration_us()) * 1000
        out.append((e.name(), dev, start, start + max(dur, 0)))
    return out


def summarize(prof) -> dict:
    """The traced window's `window_s`, `busy_s`, device time by kernel,
    launches and idle gaps by host operation."""
    events = _events(prof)
    marks = [(s, e) for name, dev, s, e in events
             if name == WINDOW and not dev]
    if not marks:
        raise RuntimeError("the traced window's marker is missing from the "
                           "profiler's events")
    w0, w1 = min(s for s, _ in marks), max(e for _, e in marks)
    device = sorted((max(s, w0), min(e, w1), name)
                    for name, dev, s, e in events
                    if dev and e > w0 and s < w1)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    busy = 0
    gaps = []
    cursor = w0
    for s, e, name in device:
        k = kernels[short_name(name)]
        k[0] += (e - s) / 1e9
        k[1] += 1
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    launches = sum(1 for name, dev, s, e in events
                   if not dev and name in LAUNCH_CALLS and w0 <= s <= w1)
    host = sorted((s, e, name) for name, dev, s, e in events
                  if not dev and name != WINDOW and w0 <= s <= w1)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "kernels": {k: [v[0], v[1]] for k, v in kernels.items()},
            "launches": launches,
            "idle_by_host": _attribute(gaps, host)}


def _attribute(gaps, host) -> Dict[str, float]:
    """Seconds of idle gaps by the innermost host operation open at
    each gap's middle."""
    starts = [s for s, _, _ in host]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = OUTSIDE_OPS
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] += (g1 - g0) / 1e9
    return dict(out)


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    operations that the device waited on longest, in seconds."""
    ops = sorted(((k, v[0]) for k, v in summary["kernels"].items()),
                 key=lambda kv: -kv[1])[:TOP]
    idle = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
