"""The histogram tree engine: host binning, the level-wise build, fits.

Counterpart of `sml_tpu/ml/tree_impl.py`.

- Host binning: quantile edges and label-ordered category ranks at fit
  time (`make_bins`), and the same edges applied to fresh rows at
  predict time (`bin_with`), into the narrowest bin dtype that holds
  every bin id. The search runs in the threaded C++ kernel of
  `native/binning.py` (`_bin_columns`); `_bin_columns_plain` is its
  NumPy version (searchsorted 'left'; non-finite values fall in bin 0).
- The fit: `_make_tree_builder` grows one tree of each of E elements
  level by level on the device through the two kernels of
  `native/hist_kernel.py` (`hist_accumulate`, `split_scan`), with
  histogram subtraction below the root and one launch of each a level
  whatever E is; `_fit_elements` runs the rounds as a Python loop, from
  a start round and margin, in segments with a hook between them.
  `fit_ensemble_on_device` fits a DT, RF, GBT or XGBoost ensemble (one
  element), `resume_ensemble_on_device` appends boosting rounds to saved
  ones after replaying their margin in one `forest_traverse` launch
  (the warm start), `fit_ensembles_folds` one spec on k fold datasets, and
  `fit_ensembles_trials` the (grid point x fold) elements of a tuning
  grid, each gated to its own hyperparameters (`TrialDyn`);
  `build_fold_stacks` stacks the folds; `fit_tree` builds one tree.
- Sampling, as the JAX package draws it: a round's row weights (Poisson
  for a bootstrap of several trees, else Bernoulli for a subsample
  below 1) and each level's per-node feature subspace (when fewer than
  all features are candidates, and always in a fused tuning fit) come
  from the Threefry keys of `utils/prng.py`, all derived on the host
  and copied to the device once a fit (`fit_keys`), and are drawn there
  by the kernels of `native/prng_kernel.py`, one launch of each a fit
  (`round_weights`, `round_masks`); each round and level slices them.
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
    """Full-column discretization against known edges/remaps: the
    threaded C++ kernel (`native/binning.py`) for the continuous
    features, then the category ranks; identical to `_bin_columns_plain`
    (searchsorted 'left'; non-finite -> bin 0). Raises if the kernel
    cannot be built."""
    from ..native import binning
    binned = binning.bin_continuous(X, edge_list, remaps) \
        .astype(out_dtype, copy=False)
    return _remap_categories(binned, X, remaps)


def _bin_columns_plain(X: np.ndarray, edge_list,
                       remaps: Dict[int, np.ndarray],
                       out_dtype=np.int32) -> np.ndarray:
    """`_bin_columns` in NumPy, the C++ kernel's plain version."""
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
    return _remap_categories(binned, X, remaps)


def _remap_categories(binned: np.ndarray, X: np.ndarray,
                      remaps: Dict[int, np.ndarray]) -> np.ndarray:
    """Each categorical slot's bins: its label-ordered category ranks
    (ids clipped to the known categories)."""
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
class TrialDyn(NamedTuple):
    """Per-element hyperparameters of a fit of E elements, each an (E,)
    host array: a fused tuning fit runs at its elements' maxima
    (`TreeSpec`) and each element gates itself down to its own. A
    sequential fit is one element whose values are its spec's."""
    depth: np.ndarray           # splits only at level < depth
    feature_k: np.ndarray       # features a node may split on
    min_instances: np.ndarray   # least weight of a child
    min_info_gain: np.ndarray   # least gain of a split


def _spec_dyn(spec: TreeSpec, E: int) -> TrialDyn:
    """Every element at `spec`'s own values."""
    return TrialDyn(depth=np.full(E, spec.max_depth),
                    feature_k=np.full(E, spec.feature_k),
                    min_instances=np.full(E, spec.min_instances, np.float32),
                    min_info_gain=np.full(E, spec.min_info_gain, np.float32))


class _Elements(NamedTuple):
    """Device constants of a fit of E elements whose rows lie end to end
    in blocks of n_pad, made once a fit (`_elements`)."""
    E: int
    n_pad: int
    erow: torch.Tensor        # (E*n_pad,) int64: each row's element
    levels: torch.Tensor      # (3, E*(2^D - 1)) f32: per level and node,
    #                           [min_inst, min_gain (+inf at or past the
    #                           element's depth), 1 below its depth else 0]
    mask_k: torch.Tensor      # (E,) int32: features a node, per element
    term_base: torch.Tensor   # (E*n_pad,) int64: first node of the row's
    #                           element's last level
    term_idx: torch.Tensor    # (E, n_nodes) int64: a node's slot in its
    #                           element's last level (clamped)
    term_mask: torch.Tensor   # (E, n_nodes) bool: the node is on it


def _elements(spec: TreeSpec, dyn: TrialDyn, n_pad: int, dev) -> _Elements:
    """The per-element gates of `dyn` laid out per level and node, and
    each element's last level, copied to `dev` once."""
    D = spec.max_depth
    E = len(dyn.depth)
    depth = np.asarray(dyn.depth, np.int64)
    if (depth < 0).any() or (depth > D).any():
        raise ValueError(f"element depths must lie in [0, {D}], got {depth}")
    cols = []
    for level in range(D):
        w = 2 ** level
        below = level < depth
        cols.append(np.stack([
            np.repeat(np.asarray(dyn.min_instances, np.float32), w),
            np.repeat(np.where(below, np.asarray(dyn.min_info_gain,
                                                 np.float32), np.inf), w),
            np.repeat(below.astype(np.float32), w)]))
    levels = np.concatenate(cols, axis=1) if cols \
        else np.zeros((3, 0), np.float32)
    n_nodes = 2 ** (D + 1) - 1
    node_level = np.floor(np.log2(np.arange(n_nodes) + 1)).astype(np.int64)
    base = 2 ** depth - 1
    term_mask = node_level[None, :] == depth[:, None]
    term_idx = np.clip(np.arange(n_nodes)[None, :] - base[:, None], 0,
                       2 ** D - 1)
    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    erow = torch.arange(E, device=dev).repeat_interleave(n_pad)
    return _Elements(E=E, n_pad=n_pad, erow=erow,
                     levels=to(levels.astype(np.float32)),
                     mask_k=to(np.asarray(dyn.feature_k, np.int32)),
                     term_base=to(base)[erow], term_idx=to(term_idx),
                     term_mask=to(term_mask))


def _make_tree_builder(spec: TreeSpec):
    """One tree for each of E elements, grown level by level on the
    operands' device; a sequential fit is E = 1.

    Returns `build(binned_c, binned, grad, hess, weight, masks, el)
    -> (pack, node)`. The E elements' rows lie end to end in blocks of
    `el.n_pad` (`_Elements`): `binned_c` is the compact (E*n_pad, F) bin
    matrix the histogram kernel reads, `binned` the same bins as int32
    for row routing, `masks` the round's (E*(2^D - 1), F) f32 feature
    masks of every level (a round of `round_masks`; level L's rows from
    E*(2^L - 1)), or None when every feature is a candidate.
    `pack` is the (E, 5, n_nodes) f32 stack [split_feature, split_bin,
    leaf_value, gain, cover] of each element's level-order heap (children
    of i at 2i+1, 2i+2), `node` each row's terminal node in its element's
    tree.

    Per level, whatever E is, one launch of each kernel: `hist_accumulate`
    histograms the rows of every element's level nodes into slot
    `e * width + node` (below the root only the left children's rows,
    into `e * width/2 + node/2`: a right child is its parent minus its
    left sibling, zero under a parent that did not split, as under the
    JAX package's default `sml.tree.histSubtraction`); `split_scan`
    picks each of the E * width nodes' best split, each held to its
    element's least child weight. A node splits when it lies above its
    element's depth and its gain is finite and passes its element's
    `min_info_gain`; its rows go right iff their bin is above the split
    bin. A node at or below its element's depth stores split bin 0, as
    its element's own (shallower) fit stores.

    Every row is routed, weighted or not, so boosting updates the margin
    of every row. The statistics of each element's last level are a
    float64 one-hot product (batched over elements) rounded once to f32:
    deterministic, unlike a scatter of float atomics, and, like the
    histograms, deliberately above the JAX package's f32 sums, so that
    the card and the CPU fit the same trees (see `native/hist_kernel.py`).
    A node no row reached inherits its parent's value and becomes a
    leaf."""
    D, B, F = spec.max_depth, spec.n_bins, spec.n_features
    n_nodes = 2 ** (D + 1) - 1
    lam = float(spec.reg_lambda)

    def build(binned_c, binned, grad, hess, weight, masks, el):
        E, n_pad = el.E, el.n_pad
        n = binned.shape[0]
        dev = binned.device
        f32 = dict(dtype=torch.float32, device=dev)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        split_feature = torch.full((E, n_nodes), -1, dtype=torch.int32,
                                   device=dev)
        split_bin = torch.zeros((E, n_nodes), dtype=torch.int32, device=dev)
        gains = torch.zeros((E, n_nodes), **f32)
        node_G = torch.zeros((E, n_nodes), **f32)
        node_H = torch.zeros((E, n_nodes), **f32)
        node_W = torch.zeros((E, n_nodes), **f32)

        hist_prev = split_prev = None
        for level in range(D):
            width = 2 ** level
            base = width - 1
            gates = el.levels[:, E * base:E * (base + width)]
            lid = node - base
            in_level = active & (lid >= 0) & (lid < width)
            lid_c = torch.where(in_level, lid, 0)
            wq = torch.where(in_level, weight, 0.0)
            if level == 0:
                hist = hk.hist_accumulate(
                    binned_c, el.erow.to(torch.int32), grad, hess, wq,
                    n_bins=B, n_slots=E).reshape(F, B, E, 3)
            else:
                half = width // 2
                w_left = torch.where(lid_c % 2 == 0, wq, 0.0)
                slot = (el.erow * half + lid_c // 2).to(torch.int32)
                left = hk.hist_accumulate(
                    binned_c, slot, grad, hess, w_left, n_bins=B,
                    n_slots=E * half).reshape(F, B, E * half, 3)
                parent = hist_prev \
                    * split_prev.to(torch.float32)[None, None, :, None]
                hist = torch.stack([left, parent - left], dim=3) \
                    .reshape(F, B, E * width, 3)
            if masks is not None:
                fmask = masks[E * base:E * (base + width)]
            else:
                fmask = torch.ones((E * width, F), **f32)
            pack6 = hk.split_scan(hist, fmask, gates[0], reg_lambda=lam,
                                  gamma=spec.gamma)
            best_f = pack6[0].to(torch.int64)
            best_b = pack6[1].to(torch.int64)
            best_gain = pack6[2]
            do_split = (best_gain > gates[1]) & torch.isfinite(best_gain)
            idx = slice(base, base + width)
            node_G[:, idx] = pack6[3].view(E, width)
            node_H[:, idx] = pack6[4].view(E, width)
            node_W[:, idx] = pack6[5].view(E, width)
            split_feature[:, idx] = torch.where(do_split, best_f, -1) \
                .to(torch.int32).view(E, width)
            split_bin[:, idx] = (pack6[1] * gates[2]).to(torch.int32) \
                .view(E, width)
            gains[:, idx] = torch.where(do_split, best_gain, 0.0) \
                .view(E, width)
            slot = el.erow * width + lid_c
            moves = in_level & do_split[slot]
            xbin = binned.gather(1, best_f[slot][:, None])[:, 0]
            child = 2 * node + 1 + (xbin > best_b[slot]).to(torch.int64)
            node = torch.where(moves, child, node)
            active = moves
            hist_prev, split_prev = hist, do_split

        # each element's last level: its rows at or past its first node
        width = 2 ** D
        lid = node - el.term_base
        in_level = (lid >= 0) & (weight > 0)
        lid_c = torch.where(in_level, lid, 0)
        wq = torch.where(in_level, weight, 0.0)
        onehot = torch.nn.functional.one_hot(lid_c, width) \
            .to(torch.float64) * (wq > 0)[:, None]
        stats = torch.stack([grad * wq, hess * wq, wq], dim=1) \
            .to(torch.float64)
        lstats = torch.bmm(onehot.view(E, n_pad, width).transpose(1, 2),
                           stats.view(E, n_pad, 3)).to(torch.float32)
        node_G = torch.where(el.term_mask,
                             lstats[..., 0].gather(1, el.term_idx), node_G)
        node_H = torch.where(el.term_mask,
                             lstats[..., 1].gather(1, el.term_idx), node_H)
        node_W = torch.where(el.term_mask,
                             lstats[..., 2].gather(1, el.term_idx), node_W)
        leaf_value = -node_G / ((node_H + lam) + 1e-12)
        parent = torch.clamp(
            (torch.arange(n_nodes, device=dev) - 1) // 2, min=0)
        covered = node_W > 0
        for _ in range(D):
            leaf_value = torch.where(covered, leaf_value,
                                     leaf_value[:, parent])
        split_feature = torch.where(covered, split_feature, -1)
        pack = torch.stack([split_feature.to(torch.float32),
                            split_bin.to(torch.float32), leaf_value, gains,
                            node_H], dim=1)
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


def _base_margins(loss: str, y: torch.Tensor, counts: torch.Tensor):
    """Each element's base margin: the mean of its labels (its first
    `counts[e]` of each n_pad block; the rest are 0), or its log-odds
    (clipped to [1e-6, 1 - 1e-6]) for the logistic loss. The mean is
    taken in float64 and rounded to f32 once (the JAX package sums in
    f32), so the base does not depend on the device's order of summation
    and the card and the CPU start from the same bits."""
    E = counts.shape[0]
    mean = (y.view(E, -1).to(torch.float64).sum(dim=1)
            / counts.to(torch.float64)).to(torch.float32)
    if loss == "logistic":
        p0 = torch.clamp(mean, 1e-6, 1 - 1e-6)
        return torch.log(p0 / (1 - p0))
    return mean


def _unpack_trees(packs) -> list:
    """(T, 5, n_nodes) host pack -> FittedTree list."""
    return [FittedTree(split_feature=p[0].astype(np.int32),
                       split_bin=p[1].astype(np.int32),
                       leaf_value=p[2].astype(np.float32),
                       gain=p[3].astype(np.float32),
                       cover=p[4].astype(np.float32)) for p in packs]


def weight_mode(bootstrap: bool, n_trees: int, subsample: float) -> str:
    """How an element's rounds weigh its rows, as the JAX package draws
    them: Poisson(subsample) counts for a bootstrap of several trees,
    else Bernoulli(subsample) for a subsample below 1, else once each.
    (One bootstrapped tree sees every row once.)"""
    if bootstrap and n_trees > 1:
        return "poisson"
    return "bernoulli" if subsample < 1.0 else "ones"


def fit_keys(rngs: np.ndarray, n_trees: int, depth: int) -> np.ndarray:
    """Every key a fit of E elements draws under, derived on the host:
    (T, 1 + D, E, 2) uint32, where [t, 0] is round t's row-weight key
    `fold_in(fold_in(rng, 0), t)` of each element and [t, 1 + level] its
    level's feature-mask key `fold_in(fold_in(rng, t), level)`."""
    rngs = np.asarray(rngs, np.uint32).reshape(-1, 2)
    t = np.arange(n_trees)[:, None]
    weights = prng.fold_in_keys(prng.fold_in_keys(rngs, 0)[None], t)
    feat = prng.fold_in_keys(rngs[None], t)
    masks = prng.fold_in_keys(feat[:, None],
                              np.arange(depth)[None, :, None])
    return np.concatenate([weights[:, None], masks], axis=1)


class Draws(NamedTuple):
    """A fit's draw operands on its device, copied once a fit."""
    keys: torch.Tensor      # (T, 1 + D, E, 2) uint32 (`fit_keys`)
    modes: torch.Tensor     # (E,) int32, rates (E,) f32, counts (E,) int32
    rates: torch.Tensor     # (`prng_kernel.weight_table`)
    counts: torch.Tensor
    sampled: bool           # False: every row of every element weighs 1


def fit_draws(rngs, n_trees: int, depth: int, modes, rates, counts,
              n_pad: int, device) -> Draws:
    """The keys and per-element weight operands of a fit of E elements,
    on `device`."""
    keys = torch.from_numpy(fit_keys(rngs, n_trees, depth)).to(device)
    sampled = any(m != "ones" for m in modes) \
        or any(int(c) != n_pad for c in counts)
    return Draws(keys, *pk.weight_table(modes, rates, counts, device),
                 sampled=sampled)


#: the most bytes of one launch's draws (a fit's row weights, or its
#: feature masks): a fit whose rounds need more draws them in blocks of
#: rounds, a launch a block
DRAW_BLOCK_BYTES = 256 << 20


def block_rounds(round_bytes: int, grid_rows: int = 1) -> int:
    """Rounds of one draw launch whose rounds take `round_bytes` each: as
    many as `DRAW_BLOCK_BYTES` holds, at least one, and no more than the
    row-weights kernel's grid holds of `grid_rows` (round, element) rows
    a round."""
    return max(1, min(DRAW_BLOCK_BYTES // max(round_bytes, 1),
                      pk.MAX_ROUND_ELEMENTS // grid_rows))


class RoundDraws:
    """Rounds t0 .. T-1 of one kind of a fit's draws, made by
    `draw(t, stop)` for rounds t .. stop-1 in blocks of `per_block`
    rounds: the first block here, before round t0, the next when a round
    passes the one held. `self[t]` is round t's draws, a view of its
    block."""

    def __init__(self, draw, t0: int, n_trees: int, per_block: int):
        self.draw, self.n_trees, self.per_block = draw, n_trees, per_block
        self.start, self.block = t0, None
        if t0 < n_trees:
            self._draw(t0)

    def _draw(self, t: int) -> None:
        self.start = t
        self.block = self.draw(t, min(self.n_trees, t + self.per_block))

    def __getitem__(self, t: int) -> torch.Tensor:
        if not self.start <= t < self.start + self.block.shape[0]:
            self._draw(t)
        return self.block[t - self.start]


def round_weights(draws: Draws, t0: int, n_trees: int,
                  n_pad: int) -> RoundDraws:
    """The (E * n_pad,) f32 row weights of rounds t0 .. T-1 of a fit
    (`fit_draws`): one `fit_row_weights` launch for all of them (a
    launch a block of rounds past `DRAW_BLOCK_BYTES`), or, when nothing
    is sampled, the same ones every round and nothing drawn."""
    E = draws.counts.shape[0]
    if not draws.sampled:
        ones = torch.ones(E * n_pad, dtype=torch.float32,
                          device=draws.keys.device)
        return RoundDraws(lambda t, stop: ones.expand(stop - t, -1), t0,
                          n_trees, max(n_trees, 1))
    return RoundDraws(
        lambda t, stop: pk.fit_row_weights(draws.keys[t:stop, 0],
                                           draws.modes, draws.rates,
                                           draws.counts, n_pad),
        t0, n_trees, block_rounds(4 * E * n_pad, E))


def round_masks(draws: Draws, t0: int, n_trees: int, ks: torch.Tensor,
                n_features: int) -> RoundDraws:
    """Every feature mask of rounds t0 .. T-1 of a fit (`fit_draws`),
    each element holding `ks[e]` features a node: one
    `fit_feature_masks` launch for all of them (a launch a block of
    rounds past `DRAW_BLOCK_BYTES`); round t's is its (E*(2^D - 1), F)
    f32 masks of every level, level-major."""
    E, D = draws.counts.shape[0], draws.keys.shape[1] - 1
    return RoundDraws(
        lambda t, stop: pk.fit_feature_masks(draws.keys[t:stop, 1:], ks,
                                             n_features),
        t0, n_trees, block_rounds(4 * E * (2 ** D - 1) * n_features))


def _fit_elements(binned_c: torch.Tensor, y: torch.Tensor, n_pad: int,
                  es: EnsembleSpec, rngs, dyn: TrialDyn, modes, rates,
                  counts, always_mask: bool, *, t0: int = 0,
                  margin: Optional[torch.Tensor] = None,
                  base: Optional[float] = None, segment: int = 0,
                  on_rounds=None):
    """Fit E elements whose rows lie end to end in blocks of n_pad
    (`binned_c` (E*n_pad, F) compact bins, `y` (E*n_pad,) f32 labels,
    0-padded past each element's `counts[e]` rows) on their device, each
    at its own `dyn` gates, row-weight mode and rate (`weight_mode`) and
    Threefry key `rngs[e]`. Runs rounds t0 .. es.n_trees - 1 and returns
    their (E, T - t0, 5, n_nodes) host packs and the (E,) f32 base
    margins.

    Each round computes the gradients and Hessians (squared: margin - y
    and 1; logistic: sigmoid(margin) - y and p(1-p) floored at 1e-6;
    without boosting -y and 1), takes its row weights and feature masks,
    builds one tree of every element (one launch of each kernel a level,
    whatever E is), and with boosting adds `step_size * leaf` of each
    row's terminal node to its margin, each multiply and add rounded in
    f32. Keys and gates are copied to the device once, for all T rounds
    (`fit_keys`), so round t draws under the same key whether it is
    fitted here from round 0 or appended to saved rounds. Before round
    t0 one launch draws the row weights of rounds t0 .. T-1
    (`round_weights`) and one their feature masks (`round_masks`, when
    some element takes fewer than all features or `always_mask`), each a
    launch a block of rounds past `DRAW_BLOCK_BYTES`; the rounds then
    slice them.

    A warm start passes the saved rounds' count `t0`, their replayed
    `margin` ((E*n_pad,) f32) and the saved `base`; a fresh fit starts
    from the base of its labels (`_base_margins`), or from `base` when
    given. The rounds run in segments of `segment` rounds (all of them
    when 0), each counted once as `tree.fit_dispatch`; `on_rounds(t_done,
    packs, bases)` fires at every segment boundary but the last, with the
    host packs (E, t_done - t0, 5, n_nodes) of the rounds so far (each
    segment's packs copied to the host once) and the (E,) bases. Without
    a hook the packs come back in one copy at the end."""
    from ..utils.profiler import PROFILER
    dev = binned_c.device
    E = len(counts)
    D, F = es.tree.max_depth, es.tree.n_features
    T = es.n_trees
    draw_masks = always_mask or bool((np.asarray(dyn.feature_k) < F).any())
    el = _elements(es.tree, dyn, n_pad, dev)
    draws = fit_draws(rngs, T, D, modes, rates, counts, n_pad, dev)
    weights = round_weights(draws, t0, T, n_pad)
    masks = round_masks(draws, t0, T, el.mask_k, F) \
        if draw_masks and D > 0 else None
    build = _make_tree_builder(es.tree)
    binned = binned_c.to(torch.int32)
    if base is None:
        bases = _base_margins(es.loss, y, draws.counts)
    else:
        bases = torch.full((E,), float(base), dtype=torch.float32,
                           device=dev)
    if margin is None:
        margin = bases[el.erow]
    ones = torch.ones_like(y)
    row_node = el.erow * (2 ** (D + 1) - 1)
    segment = segment if segment > 0 else max(T - t0, 1)
    packs, host = [], []
    for t in range(t0, T):
        if (t - t0) % segment == 0:
            PROFILER.count("tree.fit_dispatch")
        if not es.boosting:
            grad, hess = -y, ones
        elif es.loss == "logistic":
            p = torch.sigmoid(margin)
            grad = p - y
            hess = torch.clamp(p * (1 - p), min=1e-6)
        else:
            grad, hess = margin - y, ones
        pack, node_fin = build(binned_c, binned, grad, hess, weights[t],
                               None if masks is None else masks[t], el)
        if es.boosting:
            margin = margin + es.step_size \
                * pack[:, 2].reshape(-1)[row_node + node_fin]
        packs.append(pack)
        done = t + 1
        if on_rounds is not None and done < T \
                and (done - t0) % segment == 0:
            host.append(torch.stack(packs, dim=1).cpu().numpy())
            packs = []
            on_rounds(done, np.concatenate(host, axis=1),
                      bases.cpu().numpy())
    if packs:
        host.append(torch.stack(packs, dim=1).cpu().numpy())
    out = np.concatenate(host, axis=1) if host \
        else np.zeros((E, 0, 5, 2 ** (D + 1) - 1), np.float32)
    return out, bases.cpu().numpy()


def _segment(es: EnsembleSpec, rounds_per_dispatch: Optional[int]) -> int:
    """Rounds a segment of a fit (`_fit_elements`): rounds_per_dispatch,
    else `sml.tree.roundsPerDispatch`; 0 (one segment) for a fit that is
    not boosted, as the JAX package dispatches those whole."""
    from ..conf import GLOBAL_CONF
    rounds = (rounds_per_dispatch if rounds_per_dispatch is not None
              else GLOBAL_CONF.getInt("sml.tree.roundsPerDispatch"))
    return int(rounds) if es.boosting and rounds > 0 else 0


def fit_ensemble_on_device(binned_dev: torch.Tensor, y_dev: torch.Tensor,
                           es: EnsembleSpec, seed: int,
                           rounds_per_dispatch: Optional[int] = None,
                           on_rounds=None
                           ) -> Tuple[List[FittedTree], float]:
    """Fit the rounds of a DT, RF, GBT or XGBoost ensemble on the
    operands' device; returns (trees, base margin). One element of
    `_fit_elements`, keyed `prng_key(seed)`. A boosted fit runs in
    segments of `rounds_per_dispatch` rounds (`_segment`), and
    `on_rounds(t_done, trees_so_far, base)`, the round checkpoints' hook,
    fires at each boundary but the last; the trees do not depend on
    either."""
    from ..utils.profiler import PROFILER
    n = binned_dev.shape[0]
    dev = binned_dev.device
    hook = None
    if on_rounds is not None:
        def hook(t_done, packs, bases):
            on_rounds(t_done, _unpack_trees(packs[0]), float(bases[0]))
    with PROFILER.span("program.tree_ensemble", rows=int(n),
                       route=dev.type, trees=es.n_trees):
        packs, bases = _fit_elements(
            binned_dev, y_dev, n, es, np.asarray([prng.prng_key(seed)]),
            _spec_dyn(es.tree, 1),
            [weight_mode(es.bootstrap, es.n_trees, es.subsample)],
            [es.subsample], [n], always_mask=False,
            segment=_segment(es, rounds_per_dispatch), on_rounds=hook)
    return _unpack_trees(packs[0]), float(bases[0])


def resume_ensemble_on_device(binned_dev: torch.Tensor, y_dev: torch.Tensor,
                              es: EnsembleSpec, seed: int, init_trees,
                              base: float,
                              rounds_per_dispatch: Optional[int] = None,
                              on_rounds=None
                              ) -> Tuple[List[FittedTree], float]:
    """Warm-start boosting: append rounds len(init_trees) .. es.n_trees
    - 1 to saved rounds, on the operands' device. The saved rounds'
    margin is replayed in one `forest_traverse` launch with `init=base`
    and every weight `step_size`: each row's ((base + s*l0) + s*l1) + ...
    in f32, the carry of the fit that made them. The appended rounds then
    run through `_fit_elements` from round t0 under the same keys, so k
    rounds and a warm start of N - k equal N rounds bit for bit on the
    same rows. The base is the saved one, never recomputed from the new
    labels. `on_rounds(t_done, new_trees, base)` fires at each segment
    boundary but the last with the appended rounds so far. Returns
    (appended trees, base)."""
    from ..native.traverse_kernel import forest_traverse
    from ..utils.profiler import PROFILER
    if not es.boosting:
        raise ValueError("warm-start resume requires a boosting ensemble "
                         "(forest/DT rounds are independent — refit whole)")
    t0 = len(init_trees)
    if es.n_trees <= t0:
        return [], float(base)
    n = binned_dev.shape[0]
    dev = binned_dev.device
    D = es.tree.max_depth
    with PROFILER.span("program.tree_resume", rows=int(n), route=dev.type,
                       trees=es.n_trees - t0):
        if t0:
            def table(name, dtype):
                return torch.from_numpy(np.ascontiguousarray(np.stack(
                    [getattr(t, name) for t in init_trees]), dtype)).to(dev)
            margin = forest_traverse(
                binned_dev, table("split_feature", np.int32),
                table("split_bin", np.int32),
                table("leaf_value", np.float32),
                torch.full((t0,), es.step_size, dtype=torch.float32,
                           device=dev), depth=D, init=float(base))
        else:
            margin = torch.full((n,), float(base), dtype=torch.float32,
                                device=dev)
        hook = None
        if on_rounds is not None:
            def hook(t_done, packs, bases):
                on_rounds(t_done, _unpack_trees(packs[0]), float(bases[0]))
        packs, _ = _fit_elements(
            binned_dev, y_dev, n, es, np.asarray([prng.prng_key(seed)]),
            _spec_dyn(es.tree, 1),
            [weight_mode(es.bootstrap, es.n_trees, es.subsample)],
            [es.subsample], [n], always_mask=False, t0=t0, margin=margin,
            base=float(base), segment=_segment(es, rounds_per_dispatch),
            on_rounds=hook)
    return _unpack_trees(packs[0]), float(base)


#: build_fold_stacks memo: key -> (sources, ys, stacks, bytes)
_stack_memo: Dict[tuple, tuple] = {}
_stack_memo_lock = threading.Lock()


def build_fold_stacks(binned_list, y_list):
    """(bst, yst, mst) fold stacks, each fold's rows padded with zeros to
    the longest fold's, memoized by source-array identity: `_cached_bins`
    returns id-stable arrays for repeated content, so a grid over
    maxDepth x numTrees builds the stack once, not once per parameter map
    (the memo holds the sources, keeping their ids valid). The newest
    stack is always kept; older ones go while the memo holds two or more
    or passes `sml.fit.foldStackBytes`."""
    from ..conf import GLOBAL_CONF
    n_pad = max(b.shape[0] for b in binned_list)
    key = (tuple(id(b) for b in binned_list),
           tuple(id(y) for y in y_list), n_pad)
    with _stack_memo_lock:
        hit = _stack_memo.get(key)
        if hit is not None:
            return hit[2]
        fo, F = len(binned_list), binned_list[0].shape[1]
        bst = np.zeros((fo, n_pad, F), dtype=binned_list[0].dtype)
        yst = np.zeros((fo, n_pad), dtype=np.float32)
        mst = np.zeros((fo, n_pad), dtype=np.float32)
        for k, (b, y) in enumerate(zip(binned_list, y_list)):
            bst[k, :b.shape[0]] = b
            yst[k, :len(y)] = y
            mst[k, :len(y)] = 1.0
        new_bytes = bst.nbytes + yst.nbytes + mst.nbytes
        max_bytes = GLOBAL_CONF.getInt("sml.fit.foldStackBytes")
        total = new_bytes + sum(e[3] for e in _stack_memo.values())
        while _stack_memo and (len(_stack_memo) >= 2 or total > max_bytes):
            total -= _stack_memo.pop(next(iter(_stack_memo)))[3]
        _stack_memo[key] = (list(binned_list), list(y_list),
                            (bst, yst, mst), new_bytes)
    return bst, yst, mst


def _row_counts(mst: np.ndarray) -> List[int]:
    """Each element's row count from its row mask, which must be ones on
    its first rows and zeros after (`build_fold_stacks`' layout)."""
    counts = [int(m.sum()) for m in mst]
    for m, c in zip(mst, counts):
        if not ((m[:c] == 1.0).all() and (m[c:] == 0.0).all()):
            raise ValueError("a row mask must be ones on an element's first "
                             "rows and zeros after")
    return counts


def _stage_stacks(bst, yst, device):
    """The stacks' device copies as (E*n_pad, F) bins and (E*n_pad,)
    labels, through the staging cache."""
    from ..device import resolve_device
    from ._staging import stage_stacked_cached
    dev = resolve_device(device)
    E, n_pad = bst.shape[0], bst.shape[1]
    b = stage_stacked_cached(bst, dev).view(E * n_pad, bst.shape[2])
    y = stage_stacked_cached(np.asarray(yst, np.float32), dev) \
        .view(E * n_pad)
    return b, y


def fit_ensembles_folds(bst, yst, mst, es: EnsembleSpec, seed: int = 0,
                        device=None):
    """Fit the same EnsembleSpec on k stacked fold datasets (`bst` (k,
    n_pad, F), `yst` and `mst` (k, n_pad), from `build_fold_stacks`) as
    one fused fit on `device` (the card by default): one launch of each
    kernel a level for all k folds. Every fold draws under
    `prng_key(seed)`, as each of its sequential fits would. Returns
    [(trees, base)] per fold."""
    from ..utils.profiler import PROFILER
    fo, n_pad = bst.shape[0], bst.shape[1]
    counts = _row_counts(mst)
    b_dev, y_dev = _stage_stacks(bst, yst, device)
    with PROFILER.span("program.tree_ensemble_folds", rows=int(fo * n_pad),
                       route=b_dev.device.type, trees=es.n_trees * fo):
        packs, bases = _fit_elements(
            b_dev, y_dev, n_pad, es,
            np.asarray([prng.prng_key(seed)] * fo), _spec_dyn(es.tree, fo),
            [weight_mode(es.bootstrap, es.n_trees, es.subsample)] * fo,
            [es.subsample] * fo, counts, always_mask=False)
    return [(_unpack_trees(packs[k]), float(bases[k])) for k in range(fo)]


def fit_ensembles_trials(bst, yst, mst, es: EnsembleSpec, rngs, depth,
                         feature_k, min_inst, min_gain, bootstrap,
                         subsample, device=None):
    """Fit E = bst.shape[0] (grid point x fold) DT/RF elements as one
    fused fit on `device` (the card by default): `es` holds the grid
    maxima (depth, bins, trees), and each element gates itself down to
    its own depth, feature count, least child weight and least gain
    (`TrialDyn`) and draws its rows' weights (Poisson(subsample) where
    `bootstrap`, else Bernoulli(subsample) below 1, else ones) and
    feature masks (always drawn, its `feature_k` of F) under its key
    `rngs[e]`. Each level launches each kernel once, whatever E is, so a
    G-point grid over k folds costs ceil(G*k / sml.cv.maxFusedTrials)
    fits, not G*k.

    Returns the (E, n_trees, 5, n_nodes) packs at the grid maxima and
    the (E,) bases; the caller cuts each element to its own trees."""
    from ..utils.profiler import PROFILER
    if es.boosting:
        raise ValueError("fused trials fit DT and RF elements, not boosting")
    E, n_pad = bst.shape[0], bst.shape[1]
    counts = _row_counts(mst)
    dyn = TrialDyn(depth=np.asarray(depth, np.int64),
                   feature_k=np.asarray(feature_k, np.int32),
                   min_instances=np.asarray(min_inst, np.float32),
                   min_info_gain=np.asarray(min_gain, np.float32))
    sub = np.asarray(subsample, np.float32)
    # `bootstrap` already holds only for elements of several trees
    modes = ["poisson" if b else "bernoulli" if s < 1.0 else "ones"
             for b, s in zip(np.asarray(bootstrap, bool), sub)]
    b_dev, y_dev = _stage_stacks(bst, yst, device)
    with PROFILER.span("program.tree_ensemble_trials", rows=int(E * n_pad),
                       route=b_dev.device.type, trees=es.n_trees * E):
        packs, bases = _fit_elements(
            b_dev, y_dev, n_pad, es, np.asarray(rngs, np.uint32), dyn,
            modes, [float(s) for s in sub], counts, always_mask=True)
    return packs, bases


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
    dev = binned_dev.device
    n = binned_dev.shape[0]
    el = _elements(spec, _spec_dyn(spec, 1), n, dev)
    masks = None
    if spec.feature_k < spec.n_features and spec.max_depth > 0:
        keys = prng.fold_in_keys(np.asarray([prng.as_key(feat_key)]),
                                 np.arange(spec.max_depth)[:, None])
        masks = pk.fit_feature_masks(torch.from_numpy(keys[None]).to(dev),
                                     el.mask_k, spec.n_features)[0]
    PROFILER.count("tree.fit_dispatch")
    pack, _ = build(binned_dev, binned_dev.to(torch.int32), grad_dev,
                    hess_dev, weight_dev, masks, el)
    tree = _unpack_trees(pack.cpu().numpy())[0]
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
