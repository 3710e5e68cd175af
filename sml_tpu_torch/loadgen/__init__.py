"""Open-loop, trace-driven load harness.

The port's copy of `sml_tpu/loadgen`. A closed-loop client slows its own
arrivals the moment the system queues, so its percentiles describe the
workload it degraded itself into (coordinated omission). This package
measures the offered workload:

- `TraceSpec` / `PhaseSpec` (`_spec`): phases of fixed or ramped rate,
  uniform, Poisson or bursty arrivals, a fat-tailed width mix, a
  priority-class mix and an optional model mix, compiled by a seeded
  generator into a schedule, the JAX package's draw for draw.
- `OpenLoopDriver` (`_driver`): fires each request at its scheduled
  instant from a bounded pool, counts `load.overrun` when the pool fell
  behind, and charges latency from the scheduled arrival; per phase and
  class p50 / p99 / p99.9 with worst-request exemplars.
- `closed_loop_probe` (`_driver`): the closed-loop control for the
  omission proof.
- `prewarm_widths`: the trace's declared widths, bucketed by
  `dispatch.bucket_rows`, first-called through
  `prewarm.speculative_prewarm`.

`load_report()` is `obs.engine_health()["load"]`: the last completed
replay's report (None until one ran; `reset()` forgets it).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..conf import _register

_register("sml.load.workers", 32, int,
          "Open-loop driver pool width: requests the replay can hold in "
          "flight before a fire is delayed past its scheduled instant "
          "(delays past sml.load.overrunMicros count load.overrun)")
_register("sml.load.overrunMicros", 5000, int,
          "Open-loop tolerance: a request picked up this many "
          "microseconds after its scheduled arrival counts load.overrun "
          "(the schedule outran the driver's pool; the report then "
          "indicts the harness, not the system)")
_register("sml.load.resultTimeoutSec", 30.0, float,
          "The bounded wait the load harness places on each request's "
          "result (FleetFuture / ScoreFuture.result(timeout=)); expiry "
          "raises the typed RequestTimeout, counted serve.timeout and "
          "load.timeout")

from ._driver import OpenLoopDriver, closed_loop_probe  # noqa: E402
from ._spec import PhaseSpec, Request, TraceSpec  # noqa: E402

__all__ = ["PhaseSpec", "Request", "TraceSpec", "OpenLoopDriver",
           "closed_loop_probe", "load_report", "prewarm_widths", "reset"]

# the last COMPLETED driver, for obs.engine_health()'s load block
_last_lock = threading.Lock()
_LAST: Dict[str, Optional[OpenLoopDriver]] = {"driver": None}


def _register_driver(driver: Optional[OpenLoopDriver]) -> None:
    with _last_lock:
        _LAST["driver"] = driver


def reset() -> None:
    """Forget the last replay: `load_report()` is None again."""
    _register_driver(None)


def load_report() -> Optional[Dict[str, object]]:
    """The load block of `obs.engine_health()`: the most recent completed
    open-loop replay's report, None until a replay ran."""
    with _last_lock:
        driver = _LAST["driver"]
    return None if driver is None else driver.report()


def prewarm_widths(fn, spec: TraceSpec, *, feature_dim: int = 8,
                   workers: Optional[int] = None) -> dict:
    """First-call `fn` on a zero block of each of the trace's declared
    widths, bucketed onto `dispatch.bucket_rows`'s grid, so the measured
    phases find those first calls paid
    (`prewarm.speculative_prewarm`; raises a failed call)."""
    from ..parallel import dispatch
    from ..parallel.prewarm import speculative_prewarm
    shapes = sorted({(dispatch.bucket_rows(int(rows), 1), int(feature_dim))
                     for rows, _ in spec.widths})
    return speculative_prewarm(fn, shapes, workers=workers)
