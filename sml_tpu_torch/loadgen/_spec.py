"""Declarative workload model → concrete arrival schedule.

The port's copy of `sml_tpu/loadgen/_spec.py`, draw for draw: the same
spec and seed give the JAX package's schedule bit for bit.

A `TraceSpec` is a declarative description of production-shaped load —
phases of fixed rate, diurnal ramps, Poisson or bursty inter-arrivals,
a fat-tailed request-width distribution, a priority-class mix, an
optional multi-model key mix — and `compile()` turns it into a concrete
list of `Request`s (scheduled instant, rows, class, model key) with a
DETERMINISTIC seeded generator: the same spec + seed always produces
the same schedule, so a committed bench trace is reproducible and a
test can assert arrivals byte-for-byte.

Arrival processes (per phase, mean rate preserved in every mode):

- ``uniform``: deterministic spacing at the instantaneous rate — the
  zero-variance floor, useful for isolating service-time variance.
- ``poisson``: nonhomogeneous Poisson via thinning (Lewis & Shedler):
  candidates at the phase's max rate, each kept with probability
  rate(t)/rate_max. Exact for ramps; no per-step discretization bias.
- ``bursty``: Poisson modulated by an on/off square wave —
  `burst_cycles` cycles per phase, the first `burst_fraction` of each
  cycle at `burst_factor` x the nominal rate and the remainder at the
  complementary off-rate, so the PHASE MEAN stays the nominal rate
  while the instantaneous rate swings the way real traffic does
  (requires burst_factor <= 1/burst_fraction to keep the off-rate
  non-negative; validated at compile).

Ramps: `rate_end` interpolates the nominal rate linearly across the
phase (a diurnal shoulder); None holds `rate` flat.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    """One scheduled arrival: fire at `t` seconds after trace start."""
    index: int
    t: float
    rows: int
    priority: str
    phase: str
    model: Optional[str] = None


@dataclass(frozen=True)
class PhaseSpec:
    """One phase of the trace: `duration_s` of `arrival`-process load at
    a nominal `rate` (ramping to `rate_end` when set) req/s."""
    name: str
    duration_s: float
    rate: float
    rate_end: Optional[float] = None   # None = flat; else linear ramp
    arrival: str = "poisson"           # uniform | poisson | bursty
    burst_factor: float = 3.0          # burst-window rate multiplier
    burst_fraction: float = 0.2        # fraction of each cycle bursting
    burst_cycles: int = 4              # on/off cycles per phase

    def _validate(self) -> None:
        if self.duration_s <= 0 or self.rate <= 0:
            raise ValueError(
                f"phase {self.name!r}: duration_s and rate must be > 0")
        if self.arrival not in ("uniform", "poisson", "bursty"):
            raise ValueError(
                f"phase {self.name!r}: unknown arrival process "
                f"{self.arrival!r} (uniform | poisson | bursty)")
        if self.arrival == "bursty":
            if not (0.0 < self.burst_fraction < 1.0):
                raise ValueError(
                    f"phase {self.name!r}: burst_fraction must be in "
                    f"(0, 1)")
            if self.burst_factor * self.burst_fraction >= 1.0:
                raise ValueError(
                    f"phase {self.name!r}: burst_factor x burst_fraction "
                    f"must stay under 1 so the off-rate is positive "
                    f"(mean-preserving modulation)")

    # ------------------------------------------------------ rate model
    def _nominal(self, t: float) -> float:
        """The ramped nominal rate at phase-relative time t."""
        end = self.rate if self.rate_end is None else float(self.rate_end)
        return self.rate + (end - self.rate) * (t / self.duration_s)

    def _modulation(self, t: float) -> float:
        """The burst square-wave multiplier at phase-relative time t
        (1.0 outside bursty mode). Mean over a full cycle is exactly 1."""
        if self.arrival != "bursty":
            return 1.0
        cycle = self.duration_s / max(self.burst_cycles, 1)
        pos = (t % cycle) / cycle
        if pos < self.burst_fraction:
            return self.burst_factor
        off = ((1.0 - self.burst_fraction * self.burst_factor)
               / (1.0 - self.burst_fraction))
        return off

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate (req/s) at phase-relative t."""
        return self._nominal(t) * self._modulation(t)

    def _rate_max(self) -> float:
        peak = max(self.rate,
                   self.rate if self.rate_end is None else self.rate_end)
        if self.arrival == "bursty":
            peak *= self.burst_factor
        return float(peak)

    # ------------------------------------------------------- arrivals
    def arrivals(self, rng: np.random.Generator) -> List[float]:
        """Phase-relative arrival instants, deterministic under `rng`."""
        self._validate()
        if self.arrival == "uniform":
            out, t = [], 0.0
            while True:
                t += 1.0 / self.rate_at(t)
                if t >= self.duration_s:
                    return out
                out.append(t)
        # Lewis-Shedler thinning at the phase's max rate: exact for
        # ramps AND the burst square wave, no discretization grid
        lam_max = self._rate_max()
        out, t = [], 0.0
        while True:
            t += float(rng.exponential(1.0 / lam_max))
            if t >= self.duration_s:
                return out
            if float(rng.random()) * lam_max <= self.rate_at(t):
                out.append(t)


def _weighted(rng: np.random.Generator, choices: Sequence[Tuple],
              n: int) -> List:
    values = [c[0] for c in choices]
    w = np.asarray([float(c[1]) for c in choices], dtype=np.float64)
    if (w <= 0).all():
        raise ValueError("mix weights must include a positive weight")
    idx = rng.choice(len(values), size=n, p=w / w.sum())
    return [values[i] for i in idx]


@dataclass(frozen=True)
class TraceSpec:
    """The whole trace: phases in order, plus the request mixes sampled
    independently per arrival — `widths` [(rows, weight)] (fat tails go
    here), `classes` [(priority, weight)], optional `models`
    [(model key, weight)]. `seed` makes compile() deterministic."""
    phases: Tuple[PhaseSpec, ...]
    widths: Tuple[Tuple[int, float], ...] = ((1, 1.0),)
    classes: Tuple[Tuple[str, float], ...] = (("normal", 1.0),)
    models: Tuple[Tuple[str, float], ...] = ()
    seed: int = 0

    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)

    def phase_names(self) -> List[str]:
        return [p.name for p in self.phases]

    def compile(self) -> List[Request]:
        """The concrete schedule: every phase's arrivals (offset by the
        phases before it) with rows/class/model sampled per request.
        Same spec + seed → identical list, always."""
        if not self.phases:
            raise ValueError("TraceSpec needs at least one phase")
        names = [p.name for p in self.phases]
        if len(set(names)) != len(names):
            raise ValueError(f"phase names must be unique: {names}")
        rng = np.random.default_rng(int(self.seed))
        out: List[Request] = []
        offset = 0.0
        for phase in self.phases:
            times = phase.arrivals(rng)
            rows = _weighted(rng, self.widths, len(times))
            classes = _weighted(rng, self.classes, len(times))
            models = (_weighted(rng, self.models, len(times))
                      if self.models else [None] * len(times))
            for t, r, c, m in zip(times, rows, classes, models):
                out.append(Request(index=len(out), t=offset + t,
                                   rows=int(r), priority=str(c),
                                   phase=phase.name, model=m))
            offset += phase.duration_s
        return out
