"""The histogram tree engine: host binning, the level-wise build, fits.

Counterpart of `sml_tpu/ml/tree_impl.py`.

- Host binning: quantile edges and label-ordered category ranks at fit
  time (`make_bins`), and the same edges applied to fresh rows at
  predict time (`bin_with`), into the narrowest bin dtype that holds
  every bin id. The threaded C++ binning of the JAX package is not
  ported yet; this is its numpy branch, with the same semantics
  (searchsorted 'left'; non-finite values fall in bin 0).
- The fit: `_make_tree_builder` grows one tree level by level on the
  device through the two kernels of `native/hist_kernel.py`
  (`hist_accumulate`, `split_scan`), with histogram subtraction below
  the root; `fit_ensemble_on_device` runs the rounds of a DT, RF, GBT
  or XGBoost fit as a Python loop; `fit_tree` builds one tree.
- Sampling, as the JAX package draws it: a round's row weights (Poisson
  for a bootstrap of several trees, else Bernoulli for a subsample
  below 1) and each level's per-node feature subspace (when fewer than
  all features are candidates) come from the Threefry keys of
  `utils/prng.py`, derived on the host, and are drawn on the device by
  the kernels of `native/prng_kernel.py`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..native import hist_kernel as hk
from ..native import prng_kernel as pk
from ..utils import prng


class TreeSpec(NamedTuple):
    """Static build configuration of one tree."""
    max_depth: int
    n_bins: int
    n_features: int
    feature_k: int          # features per node; = n_features unsampled
    min_instances: int
    min_info_gain: float
    reg_lambda: float       # L2 on leaf values (0 for plain trees)
    gamma: float            # min split loss (XGBoost gamma)


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


# ------------------------------------------------------------------ fit
def _make_tree_builder(spec: TreeSpec):
    """One tree, grown level by level on the operands' device.

    Returns `build(binned_c, binned, grad, hess, weight, feat_rng) ->
    (pack, node)`: `binned_c` is the compact bin matrix the histogram
    kernel reads, `binned` the same bins as int32 for row routing,
    `feat_rng` the tree's feature key (a host pair); `pack` is the
    (5, n_nodes) f32 stack [split_feature, split_bin, leaf_value, gain,
    cover] of the level-order heap (children of i at 2i+1, 2i+2), `node`
    each row's terminal node.

    Per level: `hist_accumulate` histograms the rows of the level's nodes
    (below the root only the left children's rows: a right child is its
    parent minus its left sibling, zero under a parent that did not
    split, as under the JAX package's default `sml.tree.histSubtraction`);
    `split_scan` picks each node's best
    split among the level's candidate features (with `feature_k < F`,
    the `feature_mask` draw under `fold_in(feat_rng, level)`, else all of
    them); a node splits when its gain passes `min_info_gain` and is
    finite, and its rows go right iff their bin is above the split bin.
    Every row is routed, weighted or not, so boosting updates the margin
    of every row. The last level's statistics are a float64 one-hot
    matmul rounded once to f32: deterministic, unlike a scatter of float
    atomics, and, like the histograms, deliberately above the JAX
    package's f32 sums, so that the card and the CPU fit the same trees
    (see `native/hist_kernel.py`). A node no row reached inherits its parent's value and
    becomes a leaf."""
    D, B, F = spec.max_depth, spec.n_bins, spec.n_features
    n_nodes = 2 ** (D + 1) - 1
    lam = float(spec.reg_lambda)

    def build(binned_c, binned, grad, hess, weight, feat_rng):
        n = binned.shape[0]
        dev = binned.device
        f32 = dict(dtype=torch.float32, device=dev)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        split_feature = torch.full((n_nodes,), -1, dtype=torch.int32,
                                   device=dev)
        split_bin = torch.zeros(n_nodes, dtype=torch.int32, device=dev)
        gains = torch.zeros(n_nodes, **f32)
        node_G = torch.zeros(n_nodes, **f32)
        node_H = torch.zeros(n_nodes, **f32)
        node_W = torch.zeros(n_nodes, **f32)
        min_inst = torch.full((1, 1), float(spec.min_instances), **f32)

        hist_prev = split_prev = None
        for level in range(D):
            width = 2 ** level
            base = width - 1
            lid = node - base
            in_level = active & (lid >= 0) & (lid < width)
            lid_c = torch.where(in_level, lid, 0)
            wq = torch.where(in_level, weight, 0.0)
            if level == 0:
                hist = hk.hist_accumulate(
                    binned_c, lid_c.to(torch.int32), grad, hess, wq,
                    n_bins=B, n_slots=1).reshape(F, B, 1, 3)
            else:
                half = width // 2
                w_left = torch.where(lid_c % 2 == 0, wq, 0.0)
                left = hk.hist_accumulate(
                    binned_c, (lid_c // 2).to(torch.int32), grad, hess,
                    w_left, n_bins=B, n_slots=half).reshape(F, B, half, 3)
                parent = hist_prev \
                    * split_prev.to(torch.float32)[None, None, :, None]
                hist = torch.stack([left, parent - left], dim=3) \
                    .reshape(F, B, width, 3)
            if spec.feature_k < F:
                fmask = pk.feature_mask(prng.fold_in(feat_rng, level),
                                        width, F, spec.feature_k, dev)
            else:
                fmask = torch.ones((width, F), **f32)
            pack6 = hk.split_scan(hist, fmask, min_inst, reg_lambda=lam,
                                  gamma=spec.gamma)
            best_f = pack6[0].to(torch.int64)
            best_b = pack6[1].to(torch.int64)
            best_gain = pack6[2]
            do_split = (best_gain > spec.min_info_gain) \
                & torch.isfinite(best_gain)
            idx = slice(base, base + width)
            node_G[idx] = pack6[3]
            node_H[idx] = pack6[4]
            node_W[idx] = pack6[5]
            split_feature[idx] = torch.where(do_split, best_f, -1) \
                .to(torch.int32)
            split_bin[idx] = best_b.to(torch.int32)
            gains[idx] = torch.where(do_split, best_gain, 0.0)
            moves = in_level & do_split[lid_c]
            xbin = binned.gather(1, best_f[lid_c][:, None])[:, 0]
            child = 2 * node + 1 + (xbin > best_b[lid_c]).to(torch.int64)
            node = torch.where(moves, child, node)
            active = moves
            hist_prev, split_prev = hist, do_split

        width = 2 ** D
        base = width - 1
        lid = node - base
        in_level = (lid >= 0) & (lid < width) & (weight > 0)
        lid_c = torch.where(in_level, lid, 0)
        wq = torch.where(in_level, weight, 0.0)
        onehot = torch.nn.functional.one_hot(lid_c, width) \
            .to(torch.float64) * (wq > 0)[:, None]
        lstats = (onehot.T @ torch.stack([grad * wq, hess * wq, wq], dim=1)
                  .to(torch.float64)).to(torch.float32)
        node_G[base:] = lstats[:, 0]
        node_H[base:] = lstats[:, 1]
        node_W[base:] = lstats[:, 2]
        leaf_value = -node_G / ((node_H + lam) + 1e-12)
        parent = torch.clamp(
            (torch.arange(n_nodes, device=dev) - 1) // 2, min=0)
        covered = node_W > 0
        for _ in range(D):
            leaf_value = torch.where(covered, leaf_value, leaf_value[parent])
        split_feature = torch.where(covered, split_feature, -1)
        pack = torch.stack([split_feature.to(torch.float32),
                            split_bin.to(torch.float32), leaf_value, gains,
                            node_H])
        return pack, node

    return build


class EnsembleSpec(NamedTuple):
    """Static configuration of a whole-ensemble fit."""
    tree: TreeSpec
    n_trees: int
    loss: str           # "squared" | "logistic"
    boosting: bool
    bootstrap: bool
    subsample: float
    step_size: float


def _base_margin_fn(loss: str):
    """The base margin of the labels: their mean, or its log-odds
    (clipped to [1e-6, 1 - 1e-6]) for the logistic loss. The mean is
    taken in float64 and rounded to f32 once (the JAX package sums in
    f32), so the base does not depend on the device's order of
    summation and the card and the CPU start from the same bits."""
    def base_fn(y):
        mean = torch.mean(y.to(torch.float64)).to(torch.float32)
        if loss == "logistic":
            p0 = torch.clamp(mean, 1e-6, 1 - 1e-6)
            return torch.log(p0 / (1 - p0))
        return mean
    return base_fn


def _unpack_trees(packs) -> list:
    """(T, 5, n_nodes) host pack -> FittedTree list."""
    return [FittedTree(split_feature=p[0].astype(np.int32),
                       split_bin=p[1].astype(np.int32),
                       leaf_value=p[2].astype(np.float32),
                       gain=p[3].astype(np.float32),
                       cover=p[4].astype(np.float32)) for p in packs]


def round_weights(key, t: int, n: int, es: EnsembleSpec,
                  device) -> torch.Tensor:
    """Round t's (n,) row weights, as the JAX package draws them under
    `kt = fold_in(key, t)`: Poisson(subsample) counts for a bootstrap of
    several trees, else Bernoulli(subsample) for a subsample below 1,
    else ones. (One bootstrapped tree sees every row once.)"""
    kt = prng.fold_in(key, t)
    if es.bootstrap and es.n_trees > 1:
        return pk.row_weights(kt, n, "poisson", es.subsample, device)
    if es.subsample < 1.0:
        return pk.row_weights(kt, n, "bernoulli", es.subsample, device)
    return torch.ones(n, dtype=torch.float32, device=device)


def fit_ensemble_on_device(binned_dev: torch.Tensor, y_dev: torch.Tensor,
                           es: EnsembleSpec, seed: int
                           ) -> Tuple[List[FittedTree], float]:
    """Fit the rounds of a DT, RF, GBT or XGBoost ensemble on the
    operands' device; returns (trees, base margin).

    Each round computes the gradients and Hessians (squared: margin - y
    and 1; logistic: sigmoid(margin) - y and p(1-p) floored at 1e-6;
    without boosting -y and 1), draws its row weights (`round_weights`
    under `fold_in(prng_key(seed), 0)`), builds one tree with the
    feature key `fold_in(prng_key(seed), t)`, and with boosting adds
    `step_size * leaf` of each row's terminal node to its margin. The
    trees come back in one copy at the end."""
    from ..utils.profiler import PROFILER
    n = binned_dev.shape[0]
    dev = binned_dev.device
    with PROFILER.span("program.tree_ensemble", rows=int(n),
                       route=dev.type, trees=es.n_trees):
        PROFILER.count("tree.fit_dispatch")
        build = _make_tree_builder(es.tree)
        binned = binned_dev.to(torch.int32)
        y = y_dev
        base = _base_margin_fn(es.loss)(y)
        margin = base.expand(n).clone()
        ones = torch.ones_like(y)
        rng = prng.prng_key(seed)
        key = prng.fold_in(rng, 0)
        packs = []
        for t in range(es.n_trees):
            if not es.boosting:
                grad, hess = -y, ones
            elif es.loss == "logistic":
                p = torch.sigmoid(margin)
                grad = p - y
                hess = torch.clamp(p * (1 - p), min=1e-6)
            else:
                grad, hess = margin - y, ones
            weight = round_weights(key, t, n, es, dev)
            pack, node_fin = build(binned_dev, binned, grad, hess, weight,
                                   prng.fold_in(rng, t))
            if es.boosting:
                margin = margin + es.step_size * pack[2][node_fin]
            packs.append(pack)
        host = torch.stack(packs).cpu().numpy()
        base_f = float(base)
    return _unpack_trees(host), base_f


def fit_tree(binned_dev: torch.Tensor, grad_dev: torch.Tensor,
             hess_dev: torch.Tensor, weight_dev: torch.Tensor,
             spec: TreeSpec, rng: int = 0, feat_key=None) -> FittedTree:
    """Build one tree from staged device tensors (rows weighted by
    `weight_dev`; 0 leaves a row out). `feat_key`, a key pair, draws the
    levels' feature subspaces when `spec.feature_k` is below the feature
    count; without it the key is `prng_key(rng)`. A node of zero cover
    takes its parent's value and becomes a leaf, in node order."""
    from ..utils.profiler import PROFILER
    build = _make_tree_builder(spec)
    if feat_key is None:
        feat_key = prng.prng_key(rng)
    PROFILER.count("tree.fit_dispatch")
    pack, _ = build(binned_dev, binned_dev.to(torch.int32), grad_dev,
                    hess_dev, weight_dev, prng.as_key(feat_key))
    tree = _unpack_trees(pack.cpu().numpy()[None])[0]
    sf, lv, cov = tree.split_feature, tree.leaf_value, tree.cover
    for i in range(1, len(lv)):
        if cov[i] == 0:
            lv[i] = lv[(i - 1) // 2]
            sf[i] = -1
    return tree


def feature_importances(trees, n_features: int) -> np.ndarray:
    """Gain-weighted importance, normalized to sum 1 (Spark semantics:
    per-tree normalization, then averaged over trees)."""
    total = np.zeros(n_features, dtype=np.float64)
    for t in trees:
        imp = np.zeros(n_features, dtype=np.float64)
        for node, f in enumerate(t.split_feature):
            if f >= 0:
                imp[int(f)] += max(float(t.gain[node]), 0.0)
        s = imp.sum()
        if s > 0:
            total += imp / s
    s = total.sum()
    return total / s if s > 0 else total
