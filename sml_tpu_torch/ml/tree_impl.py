"""Predict-side host binning of the histogram tree engine.

Counterpart of the host numpy part of `sml_tpu/ml/tree_impl.py`:
quantile edges and label-ordered category ranks at fit time
(`make_bins`), and the same edges applied to fresh rows at predict time
(`bin_with`), into the narrowest bin dtype that holds every bin id.
The threaded C++ binning of the JAX package is not ported yet; this is
its numpy branch, with the same semantics (searchsorted 'left';
non-finite values fall in bin 0).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np


class FittedTree(NamedTuple):
    split_feature: np.ndarray   # (N,) int32, -1 for leaves
    split_bin: np.ndarray       # (N,) int32: go left iff bin <= split_bin
    leaf_value: np.ndarray      # (N,) float32
    gain: np.ndarray            # (N,) float32 split gains (importance source)
    cover: np.ndarray           # (N,) float32 hessian mass per node


class Binning(NamedTuple):
    edges: np.ndarray           # (F, B-1) float32 upper-inclusive thresholds (+inf padded)
    cat_remap: Dict[int, np.ndarray]  # slot -> category->rank map (label-mean order)


def bin_dtype(max_bins: int) -> np.dtype:
    """Narrowest dtype holding bin ids in [0, max_bins): uint8 up to 256
    bins, uint16 up to 65536, int32 beyond."""
    if max_bins <= (1 << 8):
        return np.dtype(np.uint8)
    if max_bins <= (1 << 16):
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def finalize_binning(F: int, max_bins: int,
                     categorical: Optional[Dict[int, int]],
                     cont_quantiles: Dict[int, Optional[np.ndarray]],
                     cat_means: Dict[int, np.ndarray],
                     max_categories_error: bool = True):
    """Assemble a `Binning` from per-feature quantile values and
    per-slot category label means. Returns (Binning, edge_list,
    out_dtype); the dtype holds max_bins and every category count."""
    categorical = categorical or {}
    for slot, card in categorical.items():
        if card > max_bins and max_categories_error:
            raise ValueError(
                f"DecisionTree requires maxBins (= {max_bins}) to be at least "
                f"as large as the number of values in each categorical feature, "
                f"but categorical feature {slot} has {card} values. "
                f"Consider removing this and other categorical features with "
                f"a large number of values, or add more training examples.")
    edges = np.full((F, max_bins - 1), np.inf, dtype=np.float32)
    remaps: Dict[int, np.ndarray] = {}
    edge_list: list = [np.zeros(0, dtype=np.float32)] * F
    for f in range(F):
        if f in categorical:
            card = int(categorical[f])
            means = cat_means[f]
            order = np.argsort(means, kind="stable")
            rank = np.empty(card, dtype=np.int32)
            rank[order] = np.arange(card, dtype=np.int32)
            remaps[f] = rank
            edges[f, :] = np.inf  # traversal uses bins directly
        else:
            qs = cont_quantiles.get(f)
            if qs is None or len(qs) == 0:
                continue
            qs = np.unique(np.asarray(qs).astype(np.float32))
            edges[f, :len(qs)] = qs
            edge_list[f] = qs
    need = max([max_bins] + [len(r) for r in remaps.values()])
    return Binning(edges=edges, cat_remap=remaps), edge_list, bin_dtype(need)


def make_bins(X: np.ndarray, y: np.ndarray, max_bins: int,
              categorical: Optional[Dict[int, int]] = None,
              max_categories_error: bool = True) -> Tuple[np.ndarray, Binning]:
    """Host-side discretization. Continuous features: quantile edges.
    Categorical slots: identity bins ordered by mean label; cardinality
    must fit in max_bins."""
    n, F = X.shape
    categorical = categorical or {}
    cont_quantiles: Dict[int, Optional[np.ndarray]] = {}
    cat_means: Dict[int, np.ndarray] = {}
    for f in range(F):
        col = X[:, f]
        if f in categorical:
            card = int(categorical[f])
            means = np.full(card, np.inf)
            ids = col.astype(np.int64)
            ids = np.clip(ids, 0, card - 1)
            for c in range(card):
                sel = ids == c
                if sel.any():
                    means[c] = float(y[sel].mean()) if y is not None else c
            cat_means[f] = means
        else:
            finite = col[np.isfinite(col)]
            if len(finite) == 0:
                cont_quantiles[f] = None
                continue
            # edges from a deterministic subsample above 256k rows
            if len(finite) > 262_144:
                stride = -(-len(finite) // 262_144)
                finite = finite[::stride]
            cont_quantiles[f] = np.quantile(
                finite, np.linspace(0, 1, max_bins + 1)[1:-1])
    binning, edge_list, out_dtype = finalize_binning(
        F, max_bins, categorical, cont_quantiles, cat_means,
        max_categories_error=max_categories_error)
    binned = _bin_columns(X, edge_list, binning.cat_remap, out_dtype)
    return binned, binning


def _bin_columns(X: np.ndarray, edge_list, remaps: Dict[int, np.ndarray],
                 out_dtype=np.int32) -> np.ndarray:
    """Full-column discretization against known edges/remaps
    (searchsorted 'left'; non-finite -> bin 0)."""
    n, F = X.shape
    binned = np.zeros((n, F), dtype=out_dtype)
    for f in range(F):
        if f in remaps:
            continue
        qs = edge_list[f]
        if len(qs) == 0:
            continue
        col = X[:, f]
        binned[:, f] = np.searchsorted(qs, col, side="left").astype(out_dtype)
        binned[~np.isfinite(col), f] = 0  # missing -> lowest bin
    for f, rank in remaps.items():
        ids = np.clip(X[:, f].astype(np.int64), 0, len(rank) - 1)
        binned[:, f] = rank[ids]
    return binned


def binning_edges_and_dtype(binning: Binning):
    """(edge_list, out_dtype) for quantizing fresh rows under a saved
    `Binning`: the finite edges per feature, and the compact dtype sized
    over max_bins and every categorical cardinality."""
    edge_list = [binning.edges[f][np.isfinite(binning.edges[f])]
                 for f in range(binning.edges.shape[0])]
    need = max([binning.edges.shape[1] + 1]
               + [len(r) for r in binning.cat_remap.values()])
    return edge_list, bin_dtype(need)


#: content-keyed LRU of predict-time bin matrices, bounded by
#: sml.predict.binCacheBytes: re-scoring the same rows with the same
#: edges skips the digitize pass
_predict_bin_cache: dict = {}
_predict_bin_lock = threading.Lock()


def bin_with(X: np.ndarray, binning: Binning) -> np.ndarray:
    """Apply training-time bin edges / category ranks at predict time.
    Memoized by (content of X, edges and ranks)."""
    from ..conf import GLOBAL_CONF
    from ._staging import _content_key, _normalize
    Xn = _normalize(X)
    edge_key = hash(tuple(e.tobytes() for e in binning.edges)) \
        ^ hash(tuple(sorted((k, v.tobytes())
                            for k, v in binning.cat_remap.items())))
    key = (_content_key(Xn), edge_key)
    with _predict_bin_lock:
        hit = _predict_bin_cache.pop(key, None)
        if hit is not None:
            _predict_bin_cache[key] = hit  # move-to-end LRU touch
            return hit
    edge_list, out_dtype = binning_edges_and_dtype(binning)
    out = _bin_columns(Xn, edge_list, binning.cat_remap, out_dtype)
    max_bytes = GLOBAL_CONF.getInt("sml.predict.binCacheBytes")
    with _predict_bin_lock:
        total = out.nbytes + sum(v.nbytes for v in _predict_bin_cache.values())
        while total > max_bytes and _predict_bin_cache:
            oldest = next(iter(_predict_bin_cache))
            total -= _predict_bin_cache.pop(oldest).nbytes
        _predict_bin_cache[key] = out
    return out
