"""SLO-aware routing and priority admission over a ReplicaPool.

The port's copy of `sml_tpu/fleet/_router.py`. The routing signal is
each replica's own standing rows (`Replica.pressure`), lowest first, and
the measured batch wall (`dispatch.device_ms`, fed by the dispatch
audit) turns rows into a predicted drain wall for the health surface and
the route events. A micro-batcher wants full batches, so the router
packs the least-loaded replica instead of spraying round robin.

Priority admission (`sml.fleet.priorities`, highest first): class i of n
admits onto a replica only while its standing rows stay under (n-i)/n of
its queue bound, so the lowest class sheds first as pressure rises. The
top class is never shed by the router: past every bound it lands on the
least-loaded replica's own ladder, the endpoint's host fallback and
then its shed. The port's `sml.serve.hostFallback` is off by default, so
there the top class sheds as `serve.shed.overflow`, where the JAX
package's (on by default) degrades to the host route. An SLO burn rate
above 1.0 (`obs.slo_report` over the metrics window) halves every
non-top class's share, and a rising burn whose trend crosses 1.0 within
`sml.fleet.burstSlopeHorizonSec` tightens them by
`sml.fleet.burstSlopeTighten` first (`fleet.burst_tighten`).

`submit` returns a `FleetFuture`. If its replica dies under it
(`ReplicaGone` in flight, or a drain error on a replica the pool marked
dead), `result()` re-routes the request onto a live replica
(`fleet.reroutes`, bounded retries) or sheds it, and never hangs.
`fleet.route` / `fleet.reroute` events carry each request's trace id.
All timing is `utils.profiler.now`.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..conf import GLOBAL_CONF
from ..obs._metrics import METRICS as _METRICS
from ..obs._recorder import RECORDER as _OBS
from ..serving._batcher import RequestShed, ScoreFuture
from ..utils.profiler import PROFILER, now
from ._replica import Replica


def priority_classes() -> List[str]:
    """The configured admission classes, highest priority first."""
    raw = str(GLOBAL_CONF.get("sml.fleet.priorities"))
    classes = [c.strip() for c in raw.split(",") if c.strip()]
    return classes or ["normal"]


class FleetFuture:
    """The router's handle of one request: `result()` resolves the
    replica's `ScoreFuture` and, when that replica died under it,
    re-routes through the router. Errors from live replicas propagate:
    they are scoring errors, not fleet topology."""

    def __init__(self, router: "Router", X: np.ndarray, cls_idx: int,
                 priority: str, inner: ScoreFuture,
                 replica: Optional[Replica], retries: int):
        self._router = router
        self._X = X
        self._cls_idx = cls_idx
        self.priority = priority
        self._inner = inner
        self._replica = replica
        self._retries = int(retries)
        self._excluded: Tuple[int, ...] = ()

    @property
    def trace_id(self) -> Optional[int]:
        """The current replica-level request's trace id (a re-route
        admits afresh; `fleet.reroute` links the two)."""
        return self._inner.trace_id

    @property
    def replica_id(self) -> Optional[int]:
        r = self._replica
        return None if r is None else r.rid

    def done(self) -> bool:
        return self._inner.done()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        deadline = None if timeout is None else now() + float(timeout)
        while True:
            remaining = None if deadline is None \
                else max(deadline - now(), 1e-3)
            try:
                return self._inner.result(remaining)
            except TimeoutError:
                raise
            except BaseException as e:  # noqa: BLE001 — re-routed only
                replica = self._replica  # when its replica is dead
                if self._retries <= 0 or replica is None or replica.alive:
                    raise
                self._retries -= 1
                self._excluded = self._excluded + (replica.rid,)
                old_trace = self._inner.trace_id
                inner, rep = self._router._reroute(
                    self._X, self._cls_idx, self.priority, self._excluded)
                if inner is None:
                    raise RequestShed(
                        f"replica {replica.rid} died with this request in "
                        f"flight and no live replica admits priority "
                        f"{self.priority!r}") from e
                if _OBS.enabled:
                    _OBS.emit("fleet", "fleet.reroute", args={
                        "from_replica": replica.rid,
                        "to_replica": rep.rid,
                        "priority": self.priority,
                        "from_trace": old_trace,
                        "trace": inner.trace_id})
                self._inner, self._replica = inner, rep


class Router:
    """Replica choice and priority admission of one pool's requests."""

    #: re-route attempts a request gets (each excludes every replica it
    #: already died on)
    REROUTE_RETRIES = 2
    #: how long one computed burn rate serves admission decisions
    BURN_TTL_S = 0.5

    def __init__(self, pool, *, priorities: Optional[Sequence[str]] = None):
        self._pool = pool
        self._priorities = (list(priorities) if priorities
                            else priority_classes())
        # occupancy observed at each admission, drained by
        # Autoscaler.step(): the band averages real arrival pressure
        self._lock = threading.Lock()
        self._occ_sum = 0.0
        self._occ_n = 0
        # (burn_rate, expires_at): a histogram scan per request would
        # dominate the routing path, so the value lives BURN_TTL_S
        self._burn = (0.0, float("-inf"))
        # (t, burn) of each fresh burn_rate(): the slope's window
        self._burn_hist: deque = deque(maxlen=32)

    # -------------------------------------------------------------- signals
    def _class_index(self, priority: str) -> int:
        try:
            return self._priorities.index(priority)
        except ValueError:
            raise ValueError(
                f"unknown priority {priority!r}; configured classes "
                f"(sml.fleet.priorities, highest first): "
                f"{self._priorities}") from None

    def default_priority(self) -> str:
        """The middle class ('normal' of high,normal,low)."""
        return self._priorities[len(self._priorities) // 2]

    def burn_rate(self) -> float:
        """The serving SLO burn over the metrics window, cached for
        BURN_TTL_S."""
        t = now()
        with self._lock:
            value, expires = self._burn
            if t < expires:
                return value
        from .. import obs
        window = float(GLOBAL_CONF.getInt("sml.obs.metricsWindowSec"))
        value = float(obs.slo_report(window).get("burn_rate", 0.0))
        with self._lock:
            self._burn = (value, t + self.BURN_TTL_S)
            self._burn_hist.append((t, value))
        return value

    def _burn_slope(self) -> float:
        """Least-squares slope (burn a second) of the burn samples within
        `sml.fleet.burstSlopeWindowSec`: a burst's leading edge shows
        here while the windowed level still averages it away."""
        window = float(GLOBAL_CONF.get("sml.fleet.burstSlopeWindowSec"))
        t = now()
        with self._lock:
            pts = [(ts, v) for ts, v in self._burn_hist if t - ts <= window]
        if len(pts) < 2:
            return 0.0
        mean_t = sum(ts for ts, _ in pts) / len(pts)
        mean_v = sum(v for _, v in pts) / len(pts)
        num = sum((ts - mean_t) * (v - mean_v) for ts, v in pts)
        den = sum((ts - mean_t) ** 2 for ts, _ in pts)
        return (num / den) if den > 0 else 0.0

    def _predicts_breach(self, burn: float) -> bool:
        """Whether the burn level plus its slope over
        `sml.fleet.burstSlopeHorizonSec` crosses 1.0 (horizon 0: never)."""
        horizon = float(GLOBAL_CONF.get("sml.fleet.burstSlopeHorizonSec"))
        if horizon <= 0.0:
            return False
        slope = self._burn_slope()
        return slope > 0.0 and burn + slope * horizon > 1.0

    def predicted_wait_ms(self, replica: Replica) -> float:
        """A replica's drain estimate: batches to drain times the median
        measured card batch wall (`dispatch.device_ms`); the raw row
        count (the same ranking) before any batch was measured."""
        rows = replica.pressure()
        hist = _METRICS.histogram("dispatch.device_ms")
        if hist is None or rows == 0:
            return float(rows)
        batch_ms = hist.quantile(
            0.5, float(GLOBAL_CONF.getInt("sml.obs.metricsWindowSec")))
        if batch_ms <= 0.0:
            return float(rows)
        per_flush = max(replica.endpoint._batcher.max_batch_rows, 1)
        return math.ceil(rows / per_flush) * float(batch_ms)

    def _class_fraction(self, idx: int) -> float:
        n = len(self._priorities)
        frac = (n - idx) / n
        if idx > 0:
            burn = self.burn_rate()
            if burn > 1.0:
                frac *= 0.5
            elif self._predicts_breach(burn):
                PROFILER.count("fleet.burst_tighten")
                frac *= float(GLOBAL_CONF.get("sml.fleet.burstSlopeTighten"))
        return frac

    def take_occupancy(self) -> Optional[float]:
        """Mean fleet occupancy observed at admissions since the last
        call (None when nothing was admitted)."""
        with self._lock:
            s, n = self._occ_sum, self._occ_n
            self._occ_sum, self._occ_n = 0.0, 0
        return (s / n) if n else None

    # ------------------------------------------------------------ admission
    def _admit(self, X: np.ndarray, idx: int,
               excluded: Tuple[int, ...] = ()
               ) -> Tuple[Optional[ScoreFuture], Optional[Replica]]:
        n = int(X.shape[0])
        live = [r for r in self._pool.replicas()
                if r.alive and r.rid not in excluded]
        if not live:
            return None, None
        rows = sorted(((r.pressure(), r.rid, r) for r in live),
                      key=lambda t: (t[0], t[1]))
        total_bound = sum(r.queue_bound for r in live)
        # the occupancy AFTER this admission: sampling before it would
        # undercount a filling fleet
        occ = (sum(p for p, _, _ in rows) + n) / max(total_bound, 1)
        with self._lock:
            self._occ_sum += occ
            self._occ_n += 1
        frac = self._class_fraction(idx)
        for pressure, _, r in rows:
            if pressure + n <= frac * r.queue_bound:
                return r.endpoint.submit(X), r
        if idx == 0:
            # the top class past every bound: the least-loaded replica's
            # own ladder (host fallback, then shed) decides
            r = rows[0][2]
            return r.endpoint.submit(X), r
        return None, None

    def _reroute(self, X: np.ndarray, idx: int, priority: str,
                 excluded: Tuple[int, ...]
                 ) -> Tuple[Optional[ScoreFuture], Optional[Replica]]:
        inner, rep = self._admit(X, idx, excluded)
        if inner is None:
            PROFILER.count("fleet.shed")
            PROFILER.count(f"fleet.shed.{priority}")
            return None, None
        PROFILER.count("fleet.reroutes")
        return inner, rep

    def submit(self, X: np.ndarray,
               priority: Optional[str] = None) -> FleetFuture:
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[None, :]
        priority = self.default_priority() if priority is None else priority
        idx = self._class_index(priority)
        PROFILER.count("fleet.requests")
        PROFILER.count(f"fleet.requests.{priority}")
        inner, replica = self._admit(X, idx)
        if inner is None:
            PROFILER.count("fleet.shed")
            PROFILER.count(f"fleet.shed.{priority}")
            shed = ScoreFuture(int(X.shape[0]))
            shed._set_error(RequestShed(
                f"fleet admission refused priority {priority!r}: every "
                f"live replica is past the class's share of its queue "
                f"bound"))
            return FleetFuture(self, X, idx, priority, shed, None, 0)
        if _OBS.enabled:
            _OBS.emit("fleet", "fleet.route", args={
                "replica": replica.rid, "priority": priority,
                "rows": int(X.shape[0]), "trace": inner.trace_id,
                "predicted_wait_ms": round(
                    self.predicted_wait_ms(replica), 3)})
        return FleetFuture(self, X, idx, priority, inner, replica,
                           self.REROUTE_RETRIES)

    def score(self, X: np.ndarray, priority: Optional[str] = None,
              timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(X, priority).result(timeout)
