"""Regression metrics from the five sufficient statistics.

Counterpart of `host_reg_stats` and `_reg_metric` in
`sml_tpu/ml/evaluation.py`: rmse, mse, mae, r2 and var all follow from
(n, Σd², Σ|d|, Σl, Σl²), whether the device program
(`inference.forest_eval_fn`) or host numpy computed them.
"""

from __future__ import annotations

import numpy as np


def host_reg_stats(pred: np.ndarray, lab: np.ndarray):
    """The five regression sufficient statistics in host numpy, f32
    accumulation to match the device programs. Rows where either value
    is non-finite are left out."""
    ok = np.isfinite(pred) & np.isfinite(lab)
    p32 = pred[ok].astype(np.float32)
    l32 = lab[ok].astype(np.float32)
    d = p32 - l32
    return (float(len(p32)), float(np.dot(d, d)),
            float(np.sum(np.abs(d))), float(np.sum(l32)),
            float(np.dot(l32, l32)))


def _reg_metric(metric: str, n: float, se: float, ae: float,
                sl: float, sl2: float) -> float:
    if n == 0:
        return float("nan")
    mse = se / n
    if metric == "rmse":
        return float(np.sqrt(mse))
    if metric == "mse":
        return mse
    if metric == "mae":
        return ae / n
    if metric in ("r2", "var"):
        var = sl2 / n - (sl / n) ** 2
        if metric == "var":
            return var
        return 1.0 - mse / var if var > 0 else 0.0
    raise ValueError(f"unknown metricName {metric!r}")
