"""Open-loop replay: fire at the schedule, charge latency to the system.

The port's copy of `sml_tpu/loadgen/_driver.py`. A closed-loop client
waits for each response before it sends the next request, so the moment
the system queues it slows its own arrivals, and its percentiles
describe a workload nobody asked for (coordinated omission). The
`OpenLoopDriver` fires every request at its scheduled instant whatever
has completed, and measures latency from the SCHEDULED arrival to the
result, so queueing anywhere (the driver's own pool included) is the
system's bill. Every instant is `utils.profiler.now`.

- A bounded worker pool (`sml.load.workers`), never a silent overrun: a
  request picked up more than `sml.load.overrunMicros` after its
  scheduled instant counts `load.overrun` (the driver, not the system,
  was the bottleneck), and its latency is still charged from the
  schedule.
- The driver's own accounting is lock-guarded and always on; the
  `load.*` counters and `load.request_ms*` histograms mirror it.
- Each request mints a trace context (`obs.mint_request`), and its id is
  the histograms' exemplar, so `load.request_ms.<phase>` names the
  phase's worst request.

`closed_loop_probe` is the deliberately wrong control: the same schedule
closed loop, latency from the send. It exists for the omission proof,
never as a load result. It counts a shed or a timeout as a sample, as
the JAX package does; any other error propagates, where the JAX
package's probe swallows it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..conf import GLOBAL_CONF
from ..obs import _context as _trace
from ..obs._metrics import METRICS as _METRICS
from ..obs._recorder import RECORDER as _OBS
from ..serving._batcher import RequestShed
from ..utils.profiler import PROFILER, now
from ._spec import Request

#: the outcomes the driver accounts a request to (a shed or a timeout
#: still gets a latency sample: hiding either would be omission again)
OUTCOMES = ("served", "shed", "timeout", "errors")


def _percentiles(samples: Sequence[float]) -> Dict[str, float]:
    if not samples:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "p999_ms": 0.0}
    arr = np.asarray(samples, dtype=np.float64)
    p50, p99, p999 = np.percentile(arr, (50.0, 99.0, 99.9))
    return {"p50_ms": round(float(p50), 3),
            "p99_ms": round(float(p99), 3),
            "p999_ms": round(float(p999), 3)}


class OpenLoopDriver:
    """Replay a compiled schedule open loop against a scoring callable.

    `score(X, priority, model)` is the system under test, typically a
    fleet router's bounded-wait `score` (raising `RequestShed` or
    `RequestTimeout` for the outcomes that are not served); each
    request scores a zero block of (rows, `feature_dim`) f32. The driver
    never retries."""

    def __init__(self, score: Callable[[np.ndarray, Optional[str],
                                        Optional[str]], object],
                 requests: Sequence[Request], *,
                 feature_dim: int = 8,
                 workers: Optional[int] = None,
                 overrun_micros: Optional[int] = None):
        self._score = score
        self._requests = list(requests)
        self._feature_dim = int(feature_dim)
        self._workers = int(GLOBAL_CONF.getInt("sml.load.workers")
                            if workers is None else workers)
        self._overrun_s = float(
            GLOBAL_CONF.getInt("sml.load.overrunMicros")
            if overrun_micros is None else overrun_micros) / 1e6
        # one block a distinct width, built up front: the fire path pays
        # no allocation that scales with the width
        self._blocks = {
            rows: np.zeros((rows, self._feature_dim), dtype=np.float32)
            for rows in {r.rows for r in self._requests}}
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in OUTCOMES}
        self._counts["requests"] = 0
        self._counts["overrun"] = 0
        # (phase, priority) -> latency samples; (phase, None) = all
        self._samples: Dict[tuple, List[float]] = {}
        # phase -> (worst latency, trace id or None)
        self._worst: Dict[str, tuple] = {}
        self._wall_s = 0.0
        self._ran = False

    # ------------------------------------------------------------ fire path
    def _record(self, r: Request, ms: float, outcome: str,
                trace_id: Optional[int]) -> None:
        with self._lock:
            self._counts["requests"] += 1
            self._counts[outcome] += 1
            self._samples.setdefault((r.phase, None), []).append(ms)
            self._samples.setdefault((r.phase, r.priority), []).append(ms)
            worst = self._worst.get(r.phase)
            if worst is None or ms > worst[0]:
                self._worst[r.phase] = (ms, trace_id)
        PROFILER.count("load.requests")
        PROFILER.count(f"load.{outcome}")
        _METRICS.observe("load.request_ms", ms, exemplar=trace_id)
        _METRICS.observe(f"load.request_ms.{r.phase}", ms,
                         exemplar=trace_id)
        _METRICS.observe(f"load.request_ms.{r.phase}.{r.priority}", ms,
                         exemplar=trace_id)

    def _fire_one(self, r: Request, epoch: float) -> None:
        sched = epoch + r.t
        if now() - sched > self._overrun_s:
            # the schedule outran the pool: the driver delayed this fire
            with self._lock:
                self._counts["overrun"] += 1
            PROFILER.count("load.overrun")
        ctx = _trace.mint_request(rows=r.rows)
        trace_id = None if ctx is None else ctx.trace_id
        outcome = "served"
        try:
            with _trace.activate(ctx):
                self._score(self._blocks[r.rows], r.priority, r.model)
        except RequestShed:
            outcome = "shed"
        except TimeoutError:  # RequestTimeout is a TimeoutError
            outcome = "timeout"
        except Exception:  # noqa: BLE001 — accounted as an outcome
            outcome = "errors"
        # from the SCHEDULED arrival: any queueing is the system's bill
        self._record(r, (now() - sched) * 1e3, outcome, trace_id)

    def run(self) -> Dict[str, object]:
        """Replay the whole schedule; returns `report()`. The loop sleeps
        to each scheduled instant and hands the fire to the pool; a full
        pool queues it (an overrun past the tolerance) and never
        re-times the schedule."""
        if self._ran:
            raise RuntimeError("OpenLoopDriver is single-shot; build a "
                               "new driver to replay again")
        self._ran = True
        if _OBS.enabled:
            _OBS.emit("load", "load.run", args={
                "requests": len(self._requests),
                "workers": self._workers,
                "phases": sorted({r.phase for r in self._requests})})
        from concurrent.futures import ThreadPoolExecutor
        width = max(1, self._workers)
        with ThreadPoolExecutor(max_workers=width,
                                thread_name_prefix="sml-loadgen") as pool:
            # start every worker thread before the clock: the executor
            # creates them lazily, and a fire that also paid a thread's
            # start would book a spurious overrun
            barrier = threading.Barrier(width + 1)
            for _ in range(width):
                pool.submit(barrier.wait)
            barrier.wait()
            t0 = epoch = now()
            futures = []
            for r in self._requests:
                delay = (epoch + r.t) - now()
                if delay > 0:
                    time.sleep(delay)
                futures.append(pool.submit(self._fire_one, r, epoch))
            for f in futures:
                f.result()
        self._wall_s = now() - t0
        from . import _register_driver
        _register_driver(self)
        return self.report()

    # ------------------------------------------------------------ reporting
    def report(self) -> Dict[str, object]:
        """Totals, overruns, and per phase and class p50 / p99 / p99.9
        with the worst request's latency and trace exemplar (the JAX
        package's shape)."""
        with self._lock:
            counts = dict(self._counts)
            samples = {k: list(v) for k, v in self._samples.items()}
            worst = dict(self._worst)
        order: List[str] = []
        for r in self._requests:
            if r.phase not in order:
                order.append(r.phase)
        phases: Dict[str, dict] = {}
        for name in order:
            overall = samples.get((name, None), [])
            block = dict(_percentiles(overall))
            block["requests"] = len(overall)
            w_ms, w_trace = worst.get(name, (0.0, None))
            block["worst_ms"] = round(float(w_ms), 3)
            block["worst_trace"] = _trace.hex_id(w_trace)
            block["classes"] = dict(sorted(
                (cls, dict(_percentiles(lat), count=len(lat)))
                for (ph, cls), lat in samples.items()
                if ph == name and cls is not None))
            phases[name] = block
        n = max(counts["requests"], 1)
        return {
            "requests": counts["requests"],
            "served": counts["served"],
            "shed": counts["shed"],
            "timeout": counts["timeout"],
            "errors": counts["errors"],
            "overrun": counts["overrun"],
            "shed_rate": round(counts["shed"] / n, 4),
            "timeout_rate": round(counts["timeout"] / n, 4),
            "wall_s": round(self._wall_s, 3),
            "workers": self._workers,
            "phases": phases,
        }


def closed_loop_probe(score: Callable[[np.ndarray, Optional[str],
                                       Optional[str]], object],
                      requests: Sequence[Request], *,
                      feature_dim: int = 8) -> List[float]:
    """The coordinated-omission control: the same requests closed loop
    (each result awaited before the next send; latency from the SEND)
    and their latencies in ms. When the system stalls these stay small:
    their divergence from the open loop's report is the omission
    proof."""
    out: List[float] = []
    blocks = {r.rows: np.zeros((r.rows, int(feature_dim)),
                               dtype=np.float32)
              for r in requests}
    for r in requests:
        t0 = now()
        try:
            score(blocks[r.rows], r.priority, r.model)
        except (RequestShed, TimeoutError):
            pass  # a naive client times a shed or a timeout all the same
        out.append((now() - t0) * 1e3)
    return out
