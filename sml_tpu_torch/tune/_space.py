"""Search-space primitives (the `hp.*` surface).

The port's copy of `sml_tpu/tune/_space.py`, draw for draw: each
dimension samples itself from a `np.random.RandomState` with the same
calls in the same order, quantizes, and maps to and from the unit
interval for the TPE density model. The course drives hyperopt with
`hp.quniform` (`SML/ML 08 - Hyperopt.py:117-122`) and
`hp.choice`/`hp.uniform` (`SML/Labs/ML 08L - Hyperopt Lab.py:97-101`).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


class Dimension:
    def __init__(self, label: str):
        self.label = label

    def sample(self, rng: np.random.RandomState):
        raise NotImplementedError

    def to_unit(self, v) -> float:
        """Map a value into [0,1] for density modeling."""
        raise NotImplementedError

    def from_unit(self, u: float):
        raise NotImplementedError


class Uniform(Dimension):
    def __init__(self, label, low, high, q=None, log=False):
        super().__init__(label)
        self.low, self.high, self.q, self.log = float(low), float(high), q, log

    def _quant(self, v: float) -> float:
        if self.q:
            v = np.round(v / self.q) * self.q
        return float(np.clip(v, self.low if not self.log else np.exp(self.low),
                             self.high if not self.log else np.exp(self.high)))

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        if self.log:
            v = np.exp(v)
        return self._quant(v)

    def to_unit(self, v):
        x = np.log(v) if self.log else v
        return float((x - self.low) / (self.high - self.low + 1e-12))

    def from_unit(self, u):
        x = self.low + float(np.clip(u, 0, 1)) * (self.high - self.low)
        if self.log:
            x = np.exp(x)
        return self._quant(x)


class QNormal(Dimension):
    def __init__(self, label, mu, sigma, q=None, log=False):
        super().__init__(label)
        self.mu, self.sigma, self.q, self.log = float(mu), float(sigma), q, log

    def _quant(self, v):
        if self.q:
            v = np.round(v / self.q) * self.q
        return float(v)

    def sample(self, rng):
        v = rng.normal(self.mu, self.sigma)
        if self.log:
            v = np.exp(v)
        return self._quant(v)

    def to_unit(self, v):
        x = np.log(max(v, 1e-300)) if self.log else v
        return float(0.5 + 0.5 * np.tanh((x - self.mu) / (2 * self.sigma)))

    def from_unit(self, u):
        u = float(np.clip(u, 1e-6, 1 - 1e-6))
        x = self.mu + 2 * self.sigma * np.arctanh(2 * u - 1)
        if self.log:
            x = np.exp(x)
        return self._quant(x)


class Choice(Dimension):
    def __init__(self, label, options: Sequence[Any]):
        super().__init__(label)
        self.options = list(options)

    def sample(self, rng):
        return int(rng.randint(0, len(self.options)))

    def to_unit(self, v):
        return (float(v) + 0.5) / len(self.options)

    def from_unit(self, u):
        return int(np.clip(int(u * len(self.options)), 0, len(self.options) - 1))


class _HP:
    """The `hp` namespace: constructors mirror hyperopt's signatures."""

    @staticmethod
    def uniform(label, low, high):
        return Uniform(label, low, high)

    @staticmethod
    def quniform(label, low, high, q):
        return Uniform(label, low, high, q=q)

    @staticmethod
    def loguniform(label, low, high):
        return Uniform(label, low, high, log=True)

    @staticmethod
    def qloguniform(label, low, high, q):
        return Uniform(label, low, high, q=q, log=True)

    @staticmethod
    def normal(label, mu, sigma):
        return QNormal(label, mu, sigma)

    @staticmethod
    def qnormal(label, mu, sigma, q):
        return QNormal(label, mu, sigma, q=q)

    @staticmethod
    def lognormal(label, mu, sigma):
        return QNormal(label, mu, sigma, log=True)

    @staticmethod
    def choice(label, options):
        return Choice(label, options)

    @staticmethod
    def randint(label, upper):
        return Choice(label, list(range(int(upper))))


hp = _HP()


def space_eval(space: Dict[str, Dimension], point: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve a raw fmin result (choice → index) into actual values."""
    out = {}
    for k, dim in space.items():
        v = point[k]
        if isinstance(dim, Choice):
            out[k] = dim.options[int(v)]
        else:
            out[k] = v
    return out
