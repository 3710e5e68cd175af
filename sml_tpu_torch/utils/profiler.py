"""Engine counters and op-level timing spans.

Counterpart of `sml_tpu/utils/profiler.py`: `count`, `span`, `now`,
`wallclock` and `start_device_trace` (a `torch.profiler` trace where
the reference takes `jax.profiler`'s). Counters always count (the
serving `serve.*` counters are the batcher's own record of requests,
batches and sheds) and feed the flight recorder while it is on; spans
are kept only while the profiler is enabled, so a long-running server
does not grow a span list. With the recorder on, a span also lands as a
recorder span tagged with the riding trace context, and a span carrying
a dispatch `route` holds a stall-watchdog ticket and hands its measured
wall to the dispatch audit.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from ..obs import _audit as _obs_audit
from ..obs import _context as _obs_ctx
from ..obs._recorder import RECORDER as _OBS
from ..obs._watchdog import WATCHDOG as _OBS_WATCHDOG


def now() -> float:
    """The engine's monotonic clock, in seconds: the one clock for
    intervals."""
    return time.perf_counter()


def wallclock() -> float:
    """The engine's epoch clock (seconds since the Unix epoch), for
    timestamps a store keeps (tracking runs, registry versions)."""
    return time.time()


@dataclass
class Span:
    name: str
    wall_s: float
    rows: Optional[int] = None
    meta: Dict[str, object] = field(default_factory=dict)


class Profiler:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._counters: Dict[str, float] = {}
        self.enabled = False

    def count(self, name: str, inc: float = 1.0) -> None:
        if _OBS.enabled:
            _OBS.counter(name, inc)
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + inc

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    @contextlib.contextmanager
    def span(self, name: str, rows: Optional[int] = None,
             **meta) -> Iterator[None]:
        """Wall time of the enclosed block, kept when `enabled`. With the
        recorder on, the span is also a recorder span event (tagged with
        the riding trace context), and a span carrying a dispatch
        `route` ("host" or "device") opens a watchdog ticket (expected
        wall: the audit's prediction of this thread's pending decision)
        and attaches its measured wall to that decision."""
        prof_on = self.enabled
        obs_on = _OBS.enabled
        if not prof_on and not obs_on:
            yield
            return
        route = meta.get("route")
        ticket = None
        if obs_on and route in ("host", "device"):
            ticket = _OBS_WATCHDOG.open(
                "dispatch", name,
                expected_s=_obs_audit.expected_wall(route),
                trace=_obs_ctx.current())
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            _OBS_WATCHDOG.close(ticket)
            if prof_on:
                with self._lock:
                    self._spans.append(Span(name, dt, rows, meta))
            if obs_on and _OBS.enabled:
                ctx = _obs_ctx.current()
                if ctx is not None and "trace" not in meta:
                    _OBS.span(name, t0, dt, rows=rows,
                              trace=ctx.trace_id, span=ctx.span_id,
                              **meta)
                else:
                    _OBS.span(name, t0, dt, rows=rows, **meta)
                if route in ("host", "device"):
                    _obs_audit.attach(route, name, dt)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()


PROFILER = Profiler()


@contextlib.contextmanager
def start_device_trace(logdir: str) -> Iterator[None]:
    """A `torch.profiler` trace of the enclosed block (the host, and the
    card where there is one), written under `logdir` in TensorBoard's
    format (`*.pt.trace.json`)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
