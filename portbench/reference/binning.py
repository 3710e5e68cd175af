"""Quantile binning, as the estimators document it.

Each continuous feature's bin edges are the quantiles at 1/B, ..., (B-1)/B
(linear interpolation, `numpy.quantile`) of its finite values, taken from
every k-th value when there are more than 262,144 (k the least stride
that leaves at most that many), rounded to float32 and made unique. A
value's bin is the number of edges below it (`searchsorted` left); a
value that is not finite falls in bin 0. Edges are padded with +inf to
B - 1 a feature.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_ROWS = 262_144


def edges(X: np.ndarray, max_bins: int) -> np.ndarray:
    """(F, B-1) float32 edges of a host float32 matrix, +inf padded."""
    n, F = X.shape
    out = np.full((F, max_bins - 1), np.inf, dtype=np.float32)
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    for f in range(F):
        col = X[:, f]
        finite = col[np.isfinite(col)]
        if len(finite) == 0:
            continue
        if len(finite) > SAMPLE_ROWS:
            finite = finite[::-(-len(finite) // SAMPLE_ROWS)]
        e = np.unique(np.asarray(np.quantile(finite, qs)).astype(np.float32))
        out[f, :len(e)] = e
    return out


def bins(X: torch.Tensor, edges_: np.ndarray) -> torch.Tensor:
    """(n, F) int64 bins of X (on its device) under (F, B-1) edges."""
    e = torch.from_numpy(np.ascontiguousarray(edges_)).to(X.device)
    out = torch.empty(X.shape, dtype=torch.int64, device=X.device)
    for f in range(X.shape[1]):
        col = X[:, f].contiguous()
        b = torch.searchsorted(e[f].contiguous(), col, right=False)
        out[:, f] = torch.where(torch.isfinite(col), b, 0)
    return out


def thresholds(edges_: np.ndarray, split_feature: np.ndarray,
               split_bin: np.ndarray) -> np.ndarray:
    """The threshold of each split (feature f, bin b): a row goes right
    iff its value is above edges[f, b] (bin above b); leaves get +inf."""
    f = np.clip(split_feature, 0, None)
    b = np.clip(split_bin, 0, edges_.shape[1] - 1)
    thr = edges_[f, b].astype(np.float64)
    return np.where(split_feature >= 0, thr, np.inf)
