"""Latency-calibrated dispatch: the host (the CPU) against the card.

The port's copy of `sml_tpu/parallel/dispatch.py`, with the JAX
package's host mesh as the host device, `torch.device("cpu")`. At call
time a scoring or evaluation entry passes a work estimate (`WorkHint`)
to `decide`, which answers "device" or "host" and records the answer in
the dispatch audit (`obs/_audit.py`) with the cost model's predictions

    t_device = rt_fixed + uncached_bytes/h2d_bw + flops/dev_rate + out/d2h_bw
    t_host   = flops/host_rate[kind]

from constants MEASURED once per process against the card
(`CALIBRATION`, taken by prewarm or on demand) and host rates observed
from the host route's own runs (`OBSERVED_HOST`), bootstrapped from
`_HOST_RATES`.

`preroute` gives every answer, each with its reason in the audit: a
session whose device is the CPU ("no-tunnel": the device IS the host, as
for a CPU-backend JAX process), `sml.dispatch.mode` host or device
("forced-mode"), no hint ("no-hint"), and a card ("local-chip"). The
JAX package prices host against device only for an accelerator behind a
slow link (a calibrated round trip over 1 ms); the port serves no such
card, so it keeps every program on the card unless the caller forces the
host, and the JAX package's priced branch and its background promotion
are not ported (ROADMAP.md section 3). `DEVICE_QUEUE` is the serving
path's pressure signal (`serving/_batcher.py`).

`device_for(hint, device)` turns the answer into the device a program
runs on (the CPU for "host", the resolved card otherwise), and
`routed(hint, device)` binds it as the thread's device
(`device.use_device_local`) around a fit or a scoring body: the JAX
package's `mesh_for` and `routed`. `mesh_for(dev)` is the mesh of ranks
a program on `dev` runs over (`parallel/mesh.py`): the active mesh when
`dev` is its device, else none. Under a mesh of several ranks a program
stays on the ranks' devices: `sml.dispatch.mode=host` raises there (the
host route over ranks is ROADMAP item 10).

`bucket_rows` is the JAX package's `mesh.bucket_rows` (re-exported by
its dispatch module): the load harness buckets a trace's declared widths
with it (`loadgen.prewarm_widths`). The JAX package's
`ensure_compile_cache` has no counterpart: eager torch compiles nothing
per shape, and `native/build.py` caches each library by content hash.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import torch

from ..conf import GLOBAL_CONF, _register
from ..obs import _audit as _obs_audit
from ..obs._recorder import RECORDER as _OBS
from ..utils.profiler import now as _now

_register("sml.dispatch.mode", "auto", str,
          "auto: the session's device (a locally attached card keeps "
          "every program); device: always the card; host: scoring and "
          "evaluation on the host (the CPU)")

#: effective host rates (elementwise ops/s) per program family: the
#: BOOTSTRAP values only (the JAX package's); every hinted host run
#: feeds its measured rate back into OBSERVED_HOST, so routing converges
#: onto this host's real throughput
_HOST_RATES = {
    "blas": 6e9,       # dense matmul-shaped work (Gram, forward passes)
    "scatter": 1.2e9,  # histogram / one-hot accumulation
    "scan": 1.0e9,     # long sequential scans (boosting rounds, ARIMA)
    "traverse": 2.5e8,  # tree traversal (scoring)
    "segment": 8e7,    # sorted-segment reductions (ALS normal equations)
}
_DEVICE_RATE = 2e12  # sustained device throughput estimate


class _ObservedRates:
    """MEASURED host throughput per WorkHint kind.

    Every hinted host run calls `observe(kind, flops, seconds)`;
    `host_time` prefers the observed rate. The estimate is
    THROUGHPUT-WEIGHTED over a window of the recent large observations,
    sum(flops) / sum(seconds): big runs weigh in proportion to their
    work, and the flops floor keeps small-call noise out. Observations
    AGE OUT (`_MAX_AGE_S`), and an empty window falls back to the
    bootstrap rate, so one slow window cannot pin a kind's route for the
    life of the process. `clock` is the monotonic clock of the window
    (tests inject one)."""

    _WINDOW = 8
    _MIN_FLOPS = 1e8   # below this, per-call overhead is the signal
    _MAX_AGE_S = 120.0

    def __init__(self, clock=time.monotonic) -> None:
        self._lock = threading.Lock()
        self._recent: dict = {}  # kind -> deque of (flops, seconds, t)
        self.clock = clock

    def observe(self, kind: str, flops: float, seconds: float) -> None:
        # sub-ms timings are timer noise and Python overhead
        if seconds < 1e-3 or flops < self._MIN_FLOPS:
            return
        with self._lock:
            dq = self._recent.get(kind)
            if dq is None:
                dq = self._recent[kind] = deque(maxlen=self._WINDOW)
            dq.append((flops, seconds, self.clock()))

    def rate(self, kind: str) -> Optional[float]:
        cutoff = self.clock() - self._MAX_AGE_S
        with self._lock:
            dq = self._recent.get(kind)
            if dq:
                while dq and dq[0][2] < cutoff:
                    dq.popleft()
            if not dq:
                return None
            return sum(f for f, _, _ in dq) / sum(s for _, s, _ in dq)

    def reset(self) -> None:
        with self._lock:
            self._recent.clear()


OBSERVED_HOST = _ObservedRates()


class QueuePressure:
    """Rows currently queued for (or in flight on) the card by online
    serving: the dispatcher's backpressure signal. The micro-batcher
    feeds it (`add` at admission, `sub` when a batch completes or sheds)
    and reads `rows()` to decide when the card's lane is saturated and a
    request should take the host route instead of queueing. Not a term
    in `device_time`: a transient burst must not reroute fits.

    `parent` chains a per-batcher queue into the process-wide signal:
    every add and sub also reaches the parent."""

    def __init__(self, parent: "Optional[QueuePressure]" = None) -> None:
        self._lock = threading.Lock()
        self._rows = 0
        self._parent = parent

    def add(self, rows: int) -> None:
        with self._lock:
            self._rows += int(rows)
        parent = self._parent
        if parent is not None:
            parent.add(rows)

    def sub(self, rows: int) -> None:
        with self._lock:
            self._rows = max(0, self._rows - int(rows))
        parent = self._parent
        if parent is not None:
            parent.sub(rows)

    def rows(self) -> int:
        with self._lock:
            return self._rows


#: process-wide card-queue pressure (one card per process)
DEVICE_QUEUE = QueuePressure()


def bucket_rows(n: int, multiple: int) -> int:
    """Round a row count up to a coarse grid (8 to 16 steps per power of
    two, at most 12.5% padding) that `multiple` also divides: near-size
    requests land on one padded shape. The JAX package's
    `mesh.bucket_rows`, integer for integer."""
    n = max(int(n), 1)
    multiple = max(int(multiple), 1)
    target = max(n, multiple)
    step = 1 << max(0, target.bit_length() - 4)
    b = ((target + step - 1) // step) * step
    return ((b + multiple - 1) // multiple) * multiple


@contextlib.contextmanager
def observe_host(kind: str, flops: float):
    """Time a host-route run and feed the measured rate back into the
    router: the ONE definition of what is observed, shared by every host
    route."""
    t0 = _now()
    try:
        yield
    finally:
        OBSERVED_HOST.observe(kind, flops, _now() - t0)


@dataclass(frozen=True)
class WorkHint:
    """Caller's estimate of one program invocation's cost."""
    flops: float                 # elementwise-op / flop count of the work
    kind: str = "blas"           # which _HOST_RATES family
    out_bytes: float = 256.0     # device -> host result size
    in_bytes: Optional[float] = None  # host -> device bytes if NOT staged


class _Calibration:
    """The card's measured constants, taken lazily once per process.

    A tiny program (an 8x8 product, its sum and the copy back) runs once
    BEFORE the timing, so that the CUDA context, the cuBLAS handle and
    the caching allocator's first block stay outside `rt_fixed`; then
    `rt_fixed` is the least of 3 timed round trips (floored at 0.1 ms,
    the JAX package's floor; `rt_measured` keeps the raw least), and the
    copy rates the best of 2 copies of a 16 MB pageable host block each
    way."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._done = False
        self.rt_fixed = 0.0         # s per launch + read-back, tiny program
        self.rt_measured = 0.0      # the least timed round trip, unfloored
        self.h2d_bw = float("inf")  # bytes/s host -> device
        self.d2h_bw = float("inf")  # bytes/s device -> host

    def ensure(self, device: Optional[torch.device] = None
               ) -> "_Calibration":
        if self._done:
            return self
        with self._lock:
            if self._done:
                return self
            if device is None or device.type != "cuda":
                if not torch.cuda.is_available():
                    self._done = True
                    return self
                device = torch.device("cuda", torch.cuda.current_device())
            self._measure(device)
            self._done = True
            return self

    def _measure(self, dev: torch.device) -> None:
        x = torch.eye(8, dtype=torch.float32, device=dev)

        def trip() -> float:
            return float((x @ x).sum().item())

        trip()  # context, cuBLAS handle and allocator outside the timing
        trips = []
        for _ in range(3):
            t0 = _now()
            trip()
            trips.append(_now() - t0)
        self.rt_measured = min(trips)
        self.rt_fixed = max(self.rt_measured, 1e-4)
        blk = torch.ones(4 * 1024 * 1024, dtype=torch.float32)  # 16 MB
        nbytes = blk.numel() * blk.element_size()
        h2d, d2h = [], []
        for _ in range(2):  # best of 2: the copy rates are noisy
            t0 = _now()
            d = blk.to(dev)
            torch.cuda.synchronize(dev)
            h2d.append(_now() - t0)
            t0 = _now()
            d.cpu()
            d2h.append(_now() - t0)
            del d
        self.h2d_bw = max(nbytes / min(h2d), 1e6)
        self.d2h_bw = max(nbytes / min(d2h), 1e6)

    def set_constants(self, rt_fixed: float, h2d_bw: float,
                      d2h_bw: float) -> None:
        """Install calibration constants without measuring (the tests'
        injection, and a replica that inherits a measured set)."""
        with self._lock:
            self.rt_fixed = self.rt_measured = float(rt_fixed)
            self.h2d_bw = float(h2d_bw)
            self.d2h_bw = float(d2h_bw)
            self._done = True

    def reset(self) -> None:
        """Forget the constants: the next `ensure` measures again."""
        with self._lock:
            self._done = False
            self.rt_fixed = self.rt_measured = 0.0
            self.h2d_bw = self.d2h_bw = float("inf")

    def constants(self) -> dict:
        return {"rt_fixed_s": self.rt_fixed,
                "rt_measured_s": self.rt_measured,
                "h2d_bytes_per_s": self.h2d_bw,
                "d2h_bytes_per_s": self.d2h_bw, "calibrated": self._done}


CALIBRATION = _Calibration()


def _route_device(device) -> torch.device:
    """The device a decision is made for: `device`, else the session's
    device (which raises without a card)."""
    if isinstance(device, torch.device):
        return device
    if device is not None:
        return torch.device(device)
    from ..device import session_device
    return session_device()


def device_time(hint: WorkHint, cal: _Calibration) -> float:
    t = cal.rt_fixed + hint.flops / _DEVICE_RATE + hint.out_bytes / cal.d2h_bw
    if hint.in_bytes:
        t += hint.in_bytes / cal.h2d_bw
    return t


def host_time(hint: WorkHint) -> float:
    rate = OBSERVED_HOST.rate(hint.kind) \
        or _HOST_RATES.get(hint.kind, _HOST_RATES["blas"])
    return hint.flops / rate


def preroute(hint: Optional[WorkHint], device=None) -> str:
    """The route of `hint` on `device` (the session's by default):
    "host" only when `sml.dispatch.mode=host` forces it on a card, else
    "device". A CPU session's device is the host already."""
    dev = _route_device(device)
    if dev.type == "cpu":
        return "device"  # no card: the session's device IS the host
    if str(GLOBAL_CONF.get("sml.dispatch.mode")) == "host":
        return "host"  # forced host also catches unhinted programs
    return "device"


def preroute_reason(hint: Optional[WorkHint], device=None) -> str:
    """Why `preroute` answered: "no-tunnel", "forced-mode", "no-hint" or
    "local-chip". The dispatch audit records it."""
    dev = _route_device(device)
    if dev.type == "cpu":
        return "no-tunnel"
    mode = str(GLOBAL_CONF.get("sml.dispatch.mode"))
    if mode in ("host", "device"):
        return "forced-mode"
    if hint is None:
        return "no-hint"
    return "local-chip"


def decide(hint: Optional[WorkHint], device=None) -> str:
    """The route of one program invocation, "host" or "device"
    (`preroute`), recorded in the dispatch audit with its reason and the
    cost model's predictions when the recorder is on. Does NOT run the
    calibration: turning the recorder on must not change what the engine
    does, and an uncalibrated record is marked so (the audit's misroute
    logic does not trust it)."""
    dev = _route_device(device)
    route = preroute(hint, dev)
    if _OBS.enabled and hint is not None:
        _obs_audit.record(hint, route, host_time(hint),
                          device_time(hint, CALIBRATION), forced=True,
                          reason=preroute_reason(hint, dev),
                          calibrated=CALIBRATION._done)
    return route


def device_for(hint: Optional[WorkHint], device=None) -> torch.device:
    """The device one program invocation runs on: the CPU when `decide`
    answers "host", else `device` resolved (the thread's bound device or
    the card; raises without one)."""
    from ..device import resolve_device
    from .mesh import data_width
    dev = resolve_device(device)
    if decide(hint, dev) != "host":
        return dev
    if data_width() > 1:
        raise NotImplementedError(
            "sml.dispatch.mode=host under a mesh of several ranks: each "
            "rank holds only its block of rows, and the host route over "
            "ranks is ROADMAP item 10")
    return torch.device("cpu")


def mesh_for(dev: torch.device):
    """The mesh of ranks a program on `dev` (from `device_for` or
    `routed`) runs over: the active mesh when `dev` is its device, else
    None (the program runs on this process's rows alone)."""
    from .mesh import get_mesh
    mesh = get_mesh()
    return mesh if mesh is not None and mesh.device == dev else None


@contextlib.contextmanager
def routed(hint: Optional[WorkHint], device=None):
    """Bind `device_for(hint, device)` as this thread's device for the
    block and yield it: every `resolve_device(None)` in the body
    (staging, the kernels' operands, nested fits) resolves to the
    chosen device."""
    from ..device import use_device_local
    with use_device_local(device_for(hint, device)) as dev:
        yield dev
