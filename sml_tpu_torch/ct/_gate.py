"""Canary-gated promotion: a candidate earns Production.

The port's copy of `sml_tpu/ct/_gate.py`. The serving layer already
mirrors a paced fraction of an endpoint's traffic to its Staging version
(`sml.serve.canaryFraction`, `ServingEndpoint._mirror`) and keeps the
divergence statistics. The gate judges: it drives the fresh window
through the endpoint as traffic, waits for the mirror quorum, and passes
only when every check clears; a failed gate rolls the candidate back
(the trainer, or the fleet rollout, does that).

Checks (all must pass; an unobservable canary fails the gate):

- `mirrored`:   at least sml.ct.canaryMinMirrored shadow scores within
                sml.ct.gateTimeoutSec;
- `errors`:     no new canary-shadow error and no request error while
                the gate drove traffic;
- `divergence`: the mirrored |candidate - incumbent| statistics are
                finite (a NaN-scoring candidate never promotes), and the
                worst row within `max_abs_diff` when one is given;
- `quality`:    candidate RMSE on the labelled window at most the
                incumbent's times sml.ct.gateQualityTol.

The quality check scores both specs with `predict_margin` on the
endpoint's device, or the session's (`sml.device`) with no endpoint.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np

from ..conf import GLOBAL_CONF
from ..utils.profiler import PROFILER, wallclock


def _rmse(spec, X: np.ndarray, y: np.ndarray, device) -> float:
    pred = spec.predict_margin(np.asarray(X, dtype=np.float64),
                               device=device)
    d = np.asarray(pred, dtype=np.float64) - np.asarray(y, dtype=np.float64)
    return float(np.sqrt(d @ d / max(d.size, 1)))


class CanaryGate:
    """The promotion judge of one candidate window. Thresholds default to
    the `sml.ct.*` keys; the arguments override them."""

    def __init__(self, min_mirrored: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 quality_tol: Optional[float] = None,
                 batch_rows: int = 256,
                 max_abs_diff: Optional[float] = None):
        self._min_mirrored = (
            int(min_mirrored) if min_mirrored is not None
            else GLOBAL_CONF.getInt("sml.ct.canaryMinMirrored"))
        self._timeout_s = (
            float(timeout_s) if timeout_s is not None
            else float(GLOBAL_CONF.get("sml.ct.gateTimeoutSec")))
        self._quality_tol = (
            float(quality_tol) if quality_tol is not None
            else float(GLOBAL_CONF.get("sml.ct.gateQualityTol")))
        self._batch_rows = max(int(batch_rows), 1)
        # an optional hard bound on the mirrored WORST row's |candidate -
        # incumbent| (the fleet rollout's divergence tripwire); None keeps
        # the finite-only judgment (a drift refit is meant to diverge)
        self._max_abs_diff = (None if max_abs_diff is None
                              else float(max_abs_diff))

    def run(self, endpoint, X: np.ndarray, y: Optional[np.ndarray],
            candidate_spec, incumbent_spec) -> Dict[str, object]:
        """Judge `candidate_spec` (holding Staging) against
        `incumbent_spec` (holding Production) over the (X, y) window.
        With an endpoint the window replays as live traffic, so its
        canary mirror scores the candidate on the serving path; without
        one the verdict rests on the quality bar alone."""
        from ..device import session_device
        X = np.asarray(X)
        checks: Dict[str, bool] = {}
        out: Dict[str, object] = {"rows": int(X.shape[0])}
        request_errors = 0
        if endpoint is not None:
            stats0 = endpoint.canary_stats()
            for lo in range(0, X.shape[0], self._batch_rows):
                try:
                    endpoint.score(X[lo:lo + self._batch_rows],
                                   timeout=30.0)
                except Exception:  # noqa: BLE001 — a failed request is
                    request_errors += 1  # the verdict's `errors` check
            t0 = wallclock()
            while True:
                stats = endpoint.canary_stats()
                mirrored = stats["mirrored"] - stats0["mirrored"]
                if mirrored >= self._min_mirrored \
                        or wallclock() - t0 > self._timeout_s:
                    break
                time.sleep(0.02)
            canary_errors = stats["errors"] - stats0["errors"]
            checks["mirrored"] = bool(mirrored >= self._min_mirrored)
            checks["errors"] = bool(canary_errors == 0
                                    and request_errors == 0)
            # the mean too: a running max folded against 0.0 drops a
            # NaN, the running sum cannot
            checks["divergence"] = bool(
                math.isfinite(float(stats["max_abs_diff"]))
                and math.isfinite(float(stats["mean_abs_diff"]))
                and (self._max_abs_diff is None
                     or float(stats["max_abs_diff"])
                     <= self._max_abs_diff))
            out.update({
                "mirrored": int(mirrored),
                "canary_errors": int(canary_errors),
                "request_errors": int(request_errors),
                "mean_abs_diff": float(stats["mean_abs_diff"]),
                "max_abs_diff": float(stats["max_abs_diff"]),
            })
        if y is not None and candidate_spec is not None \
                and incumbent_spec is not None:
            device = endpoint.device if endpoint is not None \
                else session_device()
            rmse_cand = _rmse(candidate_spec, X, y, device)
            rmse_inc = _rmse(incumbent_spec, X, y, device)
            checks["quality"] = bool(
                math.isfinite(rmse_cand)
                and rmse_cand <= rmse_inc * self._quality_tol)
            out.update({"rmse_candidate": round(rmse_cand, 6),
                        "rmse_incumbent": round(rmse_inc, 6),
                        "quality_tol": self._quality_tol})
        passed = bool(checks) and all(checks.values())
        out["checks"] = checks
        out["passed"] = passed
        if passed:
            PROFILER.count("ct.gate_pass")
        else:
            PROFILER.count("ct.gate_fail")
        return out
