"""Engine counters and op-level timing spans.

Counterpart of `sml_tpu/utils/profiler.py`: `count`, `span`, `report`,
`now`, `wallclock` and `start_device_trace` (a `torch.profiler` trace
where the reference takes `jax.profiler`'s). `enabled` reads the
`sml.profiler.enabled` conf key (assigning it sets the key). Spans are
kept only while it is on, so a long-running server does not grow a span
list; a kept span carries its self time (`Span.self_s`, its wall less
the spans nested in it on the same thread), which `report()` ranks by.
Counters always count, on or off (the serving `serve.*` counters are
the batcher's own record of requests, batches and sheds; the JAX
package counts only while the profiler is on), and feed the flight
recorder while it is on. With the recorder on, a span also lands as a
recorder span tagged with the riding trace context, and a span carrying
a dispatch `route` holds a stall-watchdog ticket and hands its measured
wall to the dispatch audit. While a `torch.profiler` session collects,
with `enabled` on or off, a span is also a `record_function` range of
its name around the same block, so the device trace names the host
work the card waits on.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from torch.autograd import profiler as _torch_profiler

from ..conf import GLOBAL_CONF
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
    self_s: float = 0.0  # wall less the spans nested in it (same thread)


class Profiler:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._counters: Dict[str, float] = {}
        self._tls = threading.local()
        # bumped by reset(): a span open across a reset drops itself and
        # each thread's stack of open spans restarts (reset cannot reach
        # other threads' locals)
        self._gen = 0

    @property
    def enabled(self) -> bool:
        return GLOBAL_CONF.getBool("sml.profiler.enabled")

    @enabled.setter
    def enabled(self, on: bool) -> None:
        GLOBAL_CONF.set("sml.profiler.enabled", bool(on))

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
        and attaches its measured wall to that decision. While a
        `torch.profiler` session collects, the block is also a
        `record_function` range named `name`, whether `enabled` or not."""
        prof_on = self.enabled
        obs_on = _OBS.enabled
        # a collecting torch.profiler session: mirror the span as a range
        rng = (_torch_profiler.record_function(name)
               if _torch_profiler._is_profiler_enabled else None)
        if not prof_on and not obs_on and rng is None:
            yield
            return
        route = meta.get("route")
        ticket = None
        if obs_on and route in ("host", "device"):
            ticket = _OBS_WATCHDOG.open(
                "dispatch", name,
                expected_s=_obs_audit.expected_wall(route),
                trace=_obs_ctx.current())
        if prof_on:
            gen = self._gen
            tls = self._tls
            if getattr(tls, "gen", None) != gen:
                tls.stack, tls.gen = [], gen
            stack = tls.stack
            children = [0.0]
            stack.append(children)
        if rng is not None:
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)
            _OBS_WATCHDOG.close(ticket)
            if prof_on and self._gen == gen:
                stack.pop()
                if stack:
                    stack[-1][0] += dt
                with self._lock:
                    self._spans.append(Span(name, dt, rows, meta,
                                            max(0.0, dt - children[0])))
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
            self._gen += 1

    def report(self) -> str:
        """The Spark-UI-style table of MLE 05's debugging story: a row an
        op (calls, total wall, self time, rows, dispatch route, the
        largest skew factor), ranked by self time, then the engine
        counters (byte counters in MB)."""
        walls: Dict[str, List[float]] = {}
        selfs: Dict[str, float] = {}
        rows: Dict[str, int] = {}
        routes: Dict[str, set] = {}
        skews: Dict[str, float] = {}
        for s in self.spans():
            walls.setdefault(s.name, []).append(s.wall_s)
            selfs[s.name] = selfs.get(s.name, 0.0) + s.self_s
            if s.rows:
                rows[s.name] = rows.get(s.name, 0) + s.rows
            if s.meta.get("route"):
                routes.setdefault(s.name, set()).add(s.meta["route"])
            if s.meta.get("skew") is not None:
                skews[s.name] = max(skews.get(s.name, 0.0),
                                    float(s.meta["skew"]))
        lines = [f"{'op':<34}{'calls':>7}{'total_s':>10}{'self_s':>10}"
                 f"{'rows':>13}{'route':>9}{'skew':>7}"]
        for name in sorted(walls, key=lambda n: -selfs[n]):
            got = routes.get(name, set())
            route = next(iter(got)) if len(got) == 1 \
                else ("mixed" if got else "-")
            skew = f"{skews[name]:.2f}" if name in skews else "-"
            lines.append(f"{name:<34}{len(walls[name]):>7}"
                         f"{sum(walls[name]):>10.4f}{selfs[name]:>10.4f}"
                         f"{rows.get(name, 0):>13}{route:>9}{skew:>7}")
        counters = self.counters()
        if counters:
            lines.append("---- engine counters ----")
            for k in sorted(counters):
                v = counters[k]
                lines.append(f"{k:<34}{v / 1e6:>14.1f} MB" if "_bytes" in k
                             else f"{k:<34}{v:>14.0f}")
        return "\n".join(lines)


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
