"""Tree-ensemble estimators and models.

Counterpart of `sml_tpu/ml/_tree_models.py`: `_EnsembleSpec` (the host
description of a fitted ensemble, in the same arrays the JAX package
saves), the DT/RF/GBT regression and classification models over it,
`_fit_ensemble` (the one training path: bin on the host, fit every round
on the device; `prebinned=` is the chunked fits' entry), the warm start
(`warm_start_ensemble`, `_resume_ensemble`: rounds appended to a saved
boosted spec), tuning's device half (`_fit_ensemble_folds`,
`_fit_ensembles_grid` and `fit_cv_grid`: a grid's (grid point, fold)
fits fused on the device; `fused_reg_stats_from_matrix`: each model's
regression statistics on its validation rows) and the estimators
`DecisionTreeRegressor`, `DecisionTreeClassifier`,
`RandomForestRegressor`, `RandomForestClassifier`, `GBTRegressor` and
`GBTClassifier`.

The estimators and models are `Params` with the JAX package's params.
`fit(df)` takes a DataFrame: the features' vector column, the label
column, and the categorical slots VectorAssembler recorded in the
frame's `_ml_attrs`; it fits on the session's device (`sml.device`).
`fit(X, y, categorical=None, device=None)` takes a numpy feature matrix
and label vector (`categorical` maps a feature slot to its cardinality)
and fits on the card unless `device="cpu"`; a DataFrame and a matrix
are told apart by type. `transform(df)` appends the prediction column;
on a regressor's lazy transform a `RegressionEvaluator` takes the
pushdown (`_TreeEvalHook`): one fused traversal and reduction on the
device, and five scalars back. Random forests (a Poisson bootstrap and
a per-node feature subspace) and `subsamplingRate < 1` draw the JAX
package's Threefry streams from the estimator's seed.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

import numpy as np

from ..frame.column import block_len
from ..utils.prng import prng_key
from . import tree_impl
from .linalg import DenseVector
from .base import (Estimator, Model, RegStatsHook, load_arrays,
                   save_arrays)
from .tree_impl import (Binning, EnsembleSpec, FittedTree, TreeSpec,
                        bin_with, feature_importances, fit_ensemble_on_device,
                        make_bins)


def _feature_k(strategy: str, F: int, is_classification: bool) -> int:
    s = str(strategy).lower()
    if s == "auto":
        s = "sqrt" if is_classification else "onethird"
    if s == "all":
        return F
    if s == "sqrt":
        return max(1, int(math.sqrt(F)))
    if s == "log2":
        return max(1, int(math.log2(F)))
    if s == "onethird":
        return max(1, int(F / 3))
    try:
        v = float(strategy)
        if v <= 1.0:
            return max(1, int(v * F))
        return min(F, int(v))
    except ValueError:
        raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")


class _EnsembleSpec:
    """Host-side description of a fitted ensemble."""

    def __init__(self, trees: List[FittedTree], depth: int, binning: Binning,
                 tree_weights: Optional[np.ndarray], base: float,
                 n_features: int, mode: str):
        self.trees = trees
        self.depth = depth
        self.binning = binning
        self.tree_weights = tree_weights  # None -> average
        self.base = base
        self.n_features = n_features
        self.mode = mode  # "regression" | "binary"

    def stacked(self):
        """Stacked (T, n_nodes) tree tables + per-tree weights, cached.
        An unweighted forest averages: weights of 1/T."""
        if not hasattr(self, "_stacked"):
            sf = np.stack([t.split_feature for t in self.trees])
            sb = np.stack([t.split_bin for t in self.trees])
            lv = np.stack([t.leaf_value for t in self.trees])
            w = (np.full(len(self.trees), 1.0 / len(self.trees), np.float32)
                 if self.tree_weights is None
                 else np.asarray(self.tree_weights, dtype=np.float32))
            self._stacked = (sf, sb, lv, w)
        return self._stacked

    def predict_margin(self, X: np.ndarray, device=None) -> np.ndarray:
        """base + weighted tree sum for raw rows, on `device` (the card
        by default)."""
        from ..device import resolve_device
        from ..utils.profiler import PROFILER
        from .inference import predict_forest_sharded
        dev = resolve_device(device)
        with PROFILER.span("binning.predict", rows=int(X.shape[0])):
            binned = bin_with(X, self.binning)
        sf, sb, lv, w = self.stacked()
        with PROFILER.span("program.forest_predict", rows=binned.shape[0]):
            return predict_forest_sharded(binned, sf, sb, lv, w, self.depth,
                                          base=self.base, device=dev)

    def save(self, path: str) -> None:
        """`<path>/data.npz` in the JAX package's keys
        (`spec_from_arrays` reads them back)."""
        remap_keys = sorted(self.binning.cat_remap)
        save_arrays(
            path,
            split_feature=np.stack([t.split_feature for t in self.trees]),
            split_bin=np.stack([t.split_bin for t in self.trees]),
            leaf_value=np.stack([t.leaf_value for t in self.trees]),
            gain=np.stack([t.gain for t in self.trees]),
            cover=np.stack([t.cover for t in self.trees]),
            edges=self.binning.edges,
            tree_weights=(self.tree_weights if self.tree_weights is not None
                          else np.zeros(0)),
            scalars=np.asarray([self.depth, self.base, self.n_features,
                                1.0 if self.mode == "binary" else 0.0,
                                len(remap_keys)], dtype=np.float64),
            remap_slots=np.asarray(remap_keys, dtype=np.int64),
            **{f"remap_{k}": self.binning.cat_remap[k] for k in remap_keys})

    @classmethod
    def load(cls, path: str) -> "_EnsembleSpec":
        """The spec of a model directory saved by either package."""
        return spec_from_arrays(load_arrays(path))


def spec_from_arrays(arrays: Dict[str, np.ndarray]) -> _EnsembleSpec:
    """The port's spec from the JAX `_EnsembleSpec`'s saved arrays (the
    keys of `_EnsembleSpec.save`): tables, edges and category remaps are
    taken as they are, so `stacked()` gives the same bits."""
    d = arrays
    depth, base, n_features, is_bin, _ = d["scalars"]
    remap = {int(k): d[f"remap_{int(k)}"] for k in d["remap_slots"]}
    trees = [FittedTree(sf, sb, lv, g, c) for sf, sb, lv, g, c in
             zip(d["split_feature"], d["split_bin"], d["leaf_value"],
                 d["gain"], d["cover"])]
    tw = d["tree_weights"] if len(d["tree_weights"]) else None
    n_feat = int(n_features)
    for t in trees:
        if t.split_feature.max(initial=-1) >= n_feat:
            raise ValueError(f"a split names feature "
                             f"{int(t.split_feature.max())} of {n_feat}")
    return _EnsembleSpec(trees, int(depth),
                         Binning(edges=d["edges"], cat_remap=remap),
                         tw, float(base), n_feat,
                         "binary" if is_bin else "regression")


# ---------------------------------------------------------------- params
#: name -> (default, doc), as the JAX package declares them
_TREE_PARAMS = {
    "featuresCol": ("features", "features column"),
    "labelCol": ("label", "label column"),
    "predictionCol": ("prediction", "prediction column"),
    "maxDepth": (5, "max tree depth"),
    "maxBins": (32, "max discretization bins"),
    "minInstancesPerNode": (1, "min rows per child"),
    "minInfoGain": (0.0, "min split gain"),
    "seed": (None, "random seed"),
}
_CLASSIFIER_PARAMS = {
    "rawPredictionCol": ("rawPrediction", "raw scores"),
    "probabilityCol": ("probability", "probabilities"),
}
_RF_PARAMS = dict(_TREE_PARAMS, **{
    "numTrees": (20, "number of trees"),
    "featureSubsetStrategy": ("auto",
                              "auto|all|sqrt|log2|onethird|fraction"),
    "subsamplingRate": (1.0, "bootstrap rate"),
})
_GBT_PARAMS = dict(_TREE_PARAMS, **{
    "maxIter": (20, "boosting rounds"),
    "stepSize": (0.1, "learning rate"),
    "subsamplingRate": (1.0, "row subsample per round"),
})


def _categorical_slots(df, featuresCol: str) -> Dict[int, int]:
    """The categorical slots (slot -> cardinality) VectorAssembler
    recorded for a frame's features column."""
    attrs = getattr(df, "_ml_attrs", {}).get(featuresCol) or {}
    return {int(k): int(v) for k, v in (attrs.get("slots") or {}).items()}


class _DeclaredParams:
    """Declares the class's `_params` table (name -> (default, doc))."""
    _params: Dict[str, tuple] = {}

    def _init_params(self):
        for name, (default, doc) in self._params.items():
            self._declareParam(name, default=default, doc=doc)


class _TreeModelBase(_DeclaredParams, Model):
    """A fitted tree ensemble: its spec and its estimator's params."""

    def __init__(self, spec: Optional[_EnsembleSpec] = None):
        super().__init__()
        self._spec = spec

    @property
    def numFeatures(self) -> int:
        return self._spec.n_features

    @property
    def featureImportances(self) -> DenseVector:
        return DenseVector(feature_importances(self._spec.trees,
                                               self._spec.n_features))

    def getNumTrees(self) -> int:
        return len(self._spec.trees)

    @property
    def treeWeights(self) -> List[float]:
        if self._spec.tree_weights is None:
            return [1.0] * len(self._spec.trees)
        return [float(w) for w in self._spec.tree_weights]

    @property
    def toDebugString(self) -> str:
        """The model's class, tree count and depth, and the first 15
        nodes of its first tree, as the JAX package prints them."""
        lines = [f"{type(self).__name__} with {len(self._spec.trees)} trees, "
                 f"depth {self._spec.depth}"]
        t0 = self._spec.trees[0]
        for node in range(min(len(t0.split_feature), 15)):
            f = int(t0.split_feature[node])
            if f >= 0:
                lines.append(f"  node {node}: split feature {f} "
                             f"@bin {int(t0.split_bin[node])} "
                             f"gain {float(t0.gain[node]):.4f}")
            else:
                lines.append(f"  node {node}: leaf "
                             f"value {float(t0.leaf_value[node]):.4f}")
        return "\n".join(lines)

    def _margin(self, block, device) -> np.ndarray:
        from ._staging import features_of
        return self._spec.predict_margin(
            features_of(block, self.getOrDefault("featuresCol")), device)

    def _save_state(self, path):
        self._spec.save(path)

    def _load_state(self, path, meta):
        self._spec = _EnsembleSpec.load(path)


class _TreeEvalHook(RegStatsHook):
    """Evaluator pushdown of a lazy tree-regression transform: the
    predictions and the five statistics come from one fused traversal
    and reduction on the device (`fused_reg_stats_from_matrix`), with
    no prediction column."""

    def _compute(self, raw, lab, label_col: str):
        from ._staging import features_of
        X = features_of(raw, self._tail.getOrDefault("featuresCol"))
        return fused_reg_stats_from_matrix(self._tail._spec, X, lab,
                                           link=self._link,
                                           device=self._device)


class _TreeRegressionModel(_TreeModelBase):
    def predict(self, X: np.ndarray, device=None) -> np.ndarray:
        """The prediction column for raw rows (n, F)."""
        return self._spec.predict_margin(np.asarray(X, np.float64), device)

    def _transform(self, df):
        from ..device import session_device
        device = session_device()
        oc = self.getOrDefault("predictionCol")

        def fn(block, ctx):
            out = dict(block)
            out[oc] = self._margin(block, device) if block_len(block) \
                else np.zeros(0)
            return out

        out = df._derive_rowlocal(fn, op="predict")
        out._fused_eval = _TreeEvalHook(self, df, device)
        return out


class _TreeClassificationModel(_TreeModelBase):
    @staticmethod
    def _p1(spec: _EnsembleSpec, margin: np.ndarray) -> np.ndarray:
        """P(class 1): forests of probability leaves clip, boosted
        margins go through the sigmoid."""
        if spec.tree_weights is None:
            return np.clip(margin, 0.0, 1.0)
        return 1.0 / (1.0 + np.exp(-margin))

    def predict_probability(self, X: np.ndarray, device=None) -> np.ndarray:
        return self._p1(self._spec, self._spec.predict_margin(
            np.asarray(X, np.float64), device))

    def predict(self, X: np.ndarray, device=None) -> np.ndarray:
        """The prediction column: 1.0 where P(class 1) > 0.5."""
        return (self.predict_probability(X, device) > 0.5).astype(float)

    def _transform(self, df):
        from ..device import session_device
        device = session_device()
        oc = self.getOrDefault("predictionCol")
        rc = self.getOrDefault("rawPredictionCol")
        prc = self.getOrDefault("probabilityCol")

        def fn(block, ctx):
            out = dict(block)
            n = block_len(block)
            p1 = self._p1(self._spec, self._margin(block, device)) if n \
                else np.zeros(0)
            probs = np.stack([1 - p1, p1], axis=1)
            out[rc] = probs
            out[prc] = probs.copy()
            out[oc] = (p1 > 0.5).astype(float)
            return out

        return df._derive_rowlocal(fn, op="predict")


_bins_cache: dict = {}
_bins_cache_order: list = []
_bins_cache_bytes: list = [0]
_bins_inflight: dict = {}   # key -> Event set when that key's bins land
_bins_lock = threading.Lock()
_BINS_CACHE_MAX_BYTES = 1 << 30


def _cached_bins(X, y32, max_bins, categorical):
    """`make_bins` memoized by (content of X and y, max_bins,
    categorical): CV folds and tuning grids refit on the same matrices
    once per parameter set, and a repeated content gets the very same
    (binned, binning) objects back (`build_fold_stacks` keys on their
    ids). Bounded at 1 GB of bin matrices, oldest first; a thread that
    asks for content another thread is binning waits for it."""
    from ._staging import _content_key, _normalize
    Xc = _normalize(X)
    key = (_content_key(Xc), _content_key(_normalize(y32)), int(max_bins),
           tuple(sorted((categorical or {}).items())))
    while True:
        with _bins_lock:
            hit = _bins_cache.get(key)
            if hit is None and key not in _bins_inflight:
                _bins_inflight[key] = threading.Event()
                break  # this thread bins
            waiter = _bins_inflight.get(key) if hit is None else None
        if hit is not None:
            return hit
        waiter.wait()
    try:
        hit = make_bins(Xc, y32, max_bins, categorical)
        cost = hit[0].nbytes
        with _bins_lock:
            _bins_cache[key] = hit
            _bins_cache_order.append((key, cost))
            _bins_cache_bytes[0] += cost
            while _bins_cache_bytes[0] > _BINS_CACHE_MAX_BYTES \
                    and len(_bins_cache_order) > 1:
                old, old_cost = _bins_cache_order.pop(0)
                _bins_cache.pop(old, None)
                _bins_cache_bytes[0] -= old_cost
    finally:
        with _bins_lock:
            ev = _bins_inflight.pop(key, None)
        if ev is not None:
            ev.set()
    return hit


def _fit_ensemble(X: Optional[np.ndarray], y: np.ndarray, *,
                  categorical: Dict[int, int], max_depth: int, max_bins: int,
                  min_instances: int, min_info_gain: float, n_trees: int,
                  feature_k: Optional[int], bootstrap: bool, subsample: float,
                  seed: int, loss: str, step_size: float = 0.1,
                  reg_lambda: float = 0.0, gamma: float = 0.0,
                  boosting: bool = False, missing: Optional[float] = None,
                  rounds_per_dispatch: Optional[int] = None, prebinned=None,
                  on_rounds=None, device=None) -> _EnsembleSpec:
    """The one training path behind every tree learner: bin on the host,
    stage the compact bins and the labels on `device` (the card by
    default), and fit every round there
    (`tree_impl.fit_ensemble_on_device`). `missing`, when it is a
    number, becomes NaN before binning (NaN falls in bin 0). `seed`
    keys the Threefry streams of a sampled fit: a bootstrap of several
    trees, `subsample < 1` or `feature_k < F`.

    `prebinned=(binned, binning)` is the out-of-core entry
    (`ml/_chunked.py`): the compact matrix was quantized chunk by chunk
    and its device copy assembled into the bin cache, so X may be None;
    everything after binning is the same path. A boosted fit runs in
    segments of `rounds_per_dispatch` rounds, and `on_rounds(t_done,
    trees_so_far, base)` fires at each boundary but the last (the
    round checkpoints of `ct/`); the trees do not depend on either."""
    from ..device import resolve_device
    from ..utils.profiler import PROFILER
    from ._staging import stage_bins_cached, stage_rows
    dev = resolve_device(device)
    y32 = np.asarray(y, np.float32)
    if prebinned is not None:
        binned, binning = prebinned
    else:
        if missing is not None and not np.isnan(missing):
            X = X.copy()
            X[X == missing] = np.nan
        with PROFILER.span("binning.fit", rows=int(X.shape[0])):
            binned, binning = _cached_bins(X, y32, max_bins, categorical)
    F = binned.shape[1]
    spec = TreeSpec(max_depth=max_depth, n_bins=max_bins, n_features=F,
                    feature_k=feature_k or F, min_instances=min_instances,
                    min_info_gain=min_info_gain, reg_lambda=reg_lambda,
                    gamma=gamma)
    es = EnsembleSpec(tree=spec, n_trees=n_trees, loss=loss,
                      boosting=boosting,
                      bootstrap=bool(bootstrap) and n_trees > 1,
                      subsample=float(subsample), step_size=float(step_size))
    with PROFILER.span("staging.fit", rows=int(binned.shape[0])):
        binned_dev = stage_bins_cached(binned, dev)
        y_dev = stage_rows(y32, dev)
    trees, base = fit_ensemble_on_device(binned_dev, y_dev, es, seed,
                                         rounds_per_dispatch, on_rounds)
    mode = "binary" if loss == "logistic" else "regression"
    if boosting:
        weights = np.full(len(trees), step_size, dtype=np.float32)
        return _EnsembleSpec(trees, max_depth, binning, weights, base, F,
                             mode)
    return _EnsembleSpec(trees, max_depth, binning, None, 0.0, F, mode)


def _resume_ensemble(spec: _EnsembleSpec, binned: np.ndarray,
                     y32: np.ndarray, *, n_new_trees: int, seed: int,
                     feature_k: Optional[int] = None, min_instances: int = 1,
                     min_info_gain: float = 0.0, reg_lambda: float = 0.0,
                     gamma: float = 0.0, subsample: float = 1.0,
                     bootstrap: bool = False,
                     step_size: Optional[float] = None,
                     loss: Optional[str] = None,
                     rounds_per_dispatch: Optional[int] = None,
                     on_rounds=None, device=None) -> _EnsembleSpec:
    """The warm start of `warm_start_ensemble` and
    `ml/_chunked.warm_start_ensemble_chunked`: stage the rows, already
    binned under the saved spec's binning (the appended rounds split on
    the bin ids the saved trees use), replay the saved rounds' margin on
    `device` and append `n_new_trees` boosting rounds
    (`tree_impl.resume_ensemble_on_device`). Round t draws under the same
    key whether fitted at once or appended, so k rounds and a warm start
    of N - k equal N rounds bit for bit on the same rows and seed. The
    base is the saved spec's. Raises for a spec that is not boosted, and
    for a `step_size` other than the saved one (it would rescale the
    saved rounds' share of every prediction)."""
    from ..device import resolve_device
    from ._staging import stage_bins_cached, stage_rows
    if spec.tree_weights is None:
        raise ValueError(
            "warm start needs a boosted spec (GBT/xgboost): forest/DT "
            "trees average independent rounds — refit those whole")
    saved_step = float(spec.tree_weights[0])
    step = float(step_size) if step_size is not None else saved_step
    if np.float32(step) != np.float32(saved_step):
        raise ValueError(
            f"warm start cannot change step_size: the saved rounds were "
            f"fitted at {saved_step} (got {step}); refit full to move it")
    dev = resolve_device(device)
    loss = loss or ("logistic" if spec.mode == "binary" else "squared")
    F = spec.n_features
    max_bins = spec.binning.edges.shape[1] + 1
    n_total = len(spec.trees) + int(n_new_trees)
    tspec = TreeSpec(max_depth=spec.depth, n_bins=max_bins, n_features=F,
                     feature_k=feature_k or F, min_instances=min_instances,
                     min_info_gain=min_info_gain, reg_lambda=reg_lambda,
                     gamma=gamma)
    es = EnsembleSpec(tree=tspec, n_trees=n_total, loss=loss, boosting=True,
                      bootstrap=bool(bootstrap) and n_total > 1,
                      subsample=float(subsample), step_size=step)
    new_trees, base = tree_impl.resume_ensemble_on_device(
        stage_bins_cached(binned, dev), stage_rows(y32, dev), es, seed,
        spec.trees, float(spec.base), rounds_per_dispatch, on_rounds)
    trees = list(spec.trees) + list(new_trees)
    weights = np.full(len(trees), step, dtype=np.float32)
    return _EnsembleSpec(trees, spec.depth, spec.binning, weights,
                         float(base), F, spec.mode)


def warm_start_ensemble(spec: _EnsembleSpec, X: np.ndarray, y: np.ndarray,
                        *, n_new_trees: int, seed: int,
                        **resume_kwargs) -> _EnsembleSpec:
    """Append `n_new_trees` boosting rounds to a saved boosted spec on
    in-memory rows (X, y), binned with the saved binning (`bin_with`: a
    warm start never moves the edges). Keyword arguments are
    `_resume_ensemble`'s (subsample, step_size, feature_k,
    rounds_per_dispatch, on_rounds, device, ...); step_size and loss
    default to the saved spec's. The out-of-core twin is
    `ml/_chunked.warm_start_ensemble_chunked`."""
    binned = bin_with(np.asarray(X), spec.binning)
    return _resume_ensemble(spec, binned, np.asarray(y, np.float32),
                            n_new_trees=n_new_trees, seed=seed,
                            **resume_kwargs)


def _fit_ensemble_folds(Xs, ys, cats, *, max_depth: int, max_bins: int,
                        min_instances: int, min_info_gain: float,
                        n_trees: int, feature_k: Optional[int],
                        bootstrap: bool, subsample: float, seed: int,
                        loss: str = "squared",
                        device=None) -> List[_EnsembleSpec]:
    """`_fit_ensemble` of one DT/RF spec on k fold datasets (numpy
    matrices and labels) as one fused fit on `device`
    (`tree_impl.fit_ensembles_folds`): one launch of each kernel a level
    for all k. Each fold is binned on its own rows (`_cached_bins`), as
    its sequential fit bins it."""
    from ..utils.profiler import PROFILER
    binned_list, binnings, y32s = [], [], []
    with PROFILER.span("binning.fit", rows=int(sum(len(y) for y in ys))):
        for X, y in zip(Xs, ys):
            y32 = np.asarray(y, np.float32)
            binned, binning = _cached_bins(X, y32, max_bins, cats)
            binned_list.append(binned)
            binnings.append(binning)
            y32s.append(y32)
    F = Xs[0].shape[1]
    bst, yst, mst = tree_impl.build_fold_stacks(binned_list, y32s)
    spec = TreeSpec(max_depth=max_depth, n_bins=max_bins, n_features=F,
                    feature_k=feature_k or F, min_instances=min_instances,
                    min_info_gain=min_info_gain, reg_lambda=0.0, gamma=0.0)
    es = EnsembleSpec(tree=spec, n_trees=n_trees, loss=loss, boosting=False,
                      bootstrap=bool(bootstrap) and n_trees > 1,
                      subsample=float(subsample), step_size=0.1)
    results = tree_impl.fit_ensembles_folds(bst, yst, mst, es, seed,
                                            device=device)
    mode = "binary" if loss == "logistic" else "regression"
    return [_EnsembleSpec(trees, max_depth, binnings[k], None, 0.0, F, mode)
            for k, (trees, _) in enumerate(results)]


def _fit_ensembles_grid(Xs, ys, cats, trials, max_fused: int,
                        loss: str = "squared", device=None):
    """Grid-fused CV fits of DT/RF: `trials` holds one hyperparameter
    dict per grid point (max_depth, max_bins, min_instances,
    min_info_gain, n_trees, feature_k (None: every feature), bootstrap,
    subsample, seed); every (grid point, fold) pair becomes one element
    of a fused fit (`tree_impl.fit_ensembles_trials`) on `device`, in
    chunks of `max_fused` elements, so a G-point grid over k folds costs
    ceil(G*k / max_fused) fits.

    A chunk runs at its elements' maxima of depth, bins and trees (the
    JAX package compiles one program at the grid's; eager PyTorch
    compiles nothing, and a chunk of shallow points launches less); each
    element gates itself down to its own values, and keeps its own trees
    and the nodes of its own depth. Elements of fewer bins pad to the
    most (safe while every min_instances >= 1: a split past an element's
    own bins leaves an empty right child). Binning is per (fold,
    maxBins), through `_cached_bins`.

    Returns {(grid_index, fold_index): _EnsembleSpec}."""
    from ..utils.profiler import PROFILER
    if any(t["min_instances"] < 1 for t in trials):
        raise ValueError("fused grid fits need min_instances >= 1")
    F, k = Xs[0].shape[1], len(Xs)
    y32s = [np.asarray(y, np.float32) for y in ys]
    binned: Dict[tuple, np.ndarray] = {}
    binnings: Dict[tuple, Binning] = {}
    with PROFILER.span("binning.fit", rows=int(sum(len(y) for y in ys))):
        for mb in sorted({t["max_bins"] for t in trials}):
            for fi, (X, y32) in enumerate(zip(Xs, y32s)):
                binned[(fi, mb)], binnings[(fi, mb)] = _cached_bins(
                    X, y32, mb, cats)
    n_pad = max(b.shape[0] for b in binned.values())
    elems = [(gi, fi) for gi in range(len(trials)) for fi in range(k)]
    mode = "binary" if loss == "logistic" else "regression"
    out: Dict[tuple, _EnsembleSpec] = {}
    max_fused = max(1, int(max_fused))
    for lo in range(0, len(elems), max_fused):
        chunk = elems[lo:lo + max_fused]
        E = len(chunk)
        ts = [trials[gi] for gi, _ in chunk]
        es = EnsembleSpec(
            tree=TreeSpec(max_depth=max(t["max_depth"] for t in ts),
                          n_bins=max(t["max_bins"] for t in ts),
                          n_features=F, feature_k=F, min_instances=1,
                          min_info_gain=0.0, reg_lambda=0.0, gamma=0.0),
            n_trees=max(t["n_trees"] for t in ts), loss=loss,
            boosting=False, bootstrap=False, subsample=1.0, step_size=0.1)
        stack_dtype = np.result_type(*[binned[(fi, trials[gi]["max_bins"])]
                                       .dtype for gi, fi in chunk])
        bst = np.zeros((E, n_pad, F), dtype=stack_dtype)
        yst = np.zeros((E, n_pad), dtype=np.float32)
        mst = np.zeros((E, n_pad), dtype=np.float32)
        for e, (gi, fi) in enumerate(chunk):
            b = binned[(fi, trials[gi]["max_bins"])]
            bst[e, :b.shape[0]] = b
            yst[e, :len(y32s[fi])] = y32s[fi]
            mst[e, :len(y32s[fi])] = 1.0
        packs, _ = tree_impl.fit_ensembles_trials(
            bst, yst, mst, es,
            rngs=[prng_key(int(t["seed"])) for t in ts],
            depth=[t["max_depth"] for t in ts],
            feature_k=[t["feature_k"] or F for t in ts],
            min_inst=[t["min_instances"] for t in ts],
            min_gain=[t["min_info_gain"] for t in ts],
            bootstrap=[bool(t["bootstrap"]) and t["n_trees"] > 1
                       for t in ts],
            subsample=[t["subsample"] for t in ts], device=device)
        for e, (gi, fi) in enumerate(chunk):
            t = trials[gi]
            n_nodes = 2 ** (t["max_depth"] + 1) - 1
            trees = tree_impl._unpack_trees(
                packs[e, :t["n_trees"], :, :n_nodes])
            out[(gi, fi)] = _EnsembleSpec(
                trees, int(t["max_depth"]), binnings[(fi, t["max_bins"])],
                None, 0.0, F, mode)
    return out


def fit_cv_grid(Xs, ys, cats, trials, loss: str = "squared", device=None):
    """The device half of cross-validating a DT/RF grid: the G x k
    (grid point, fold) fits, fused in chunks of `sml.cv.maxFusedTrials`
    elements (`_fit_ensembles_grid`), or with the key at 1 or below, one
    fold-fused fit per grid point (`_fit_ensemble_folds`). Returns
    {(grid_index, fold_index): _EnsembleSpec}."""
    from ..conf import GLOBAL_CONF
    max_fused = GLOBAL_CONF.getInt("sml.cv.maxFusedTrials")
    if max_fused > 1:
        return _fit_ensembles_grid(Xs, ys, cats, trials, max_fused, loss,
                                   device)
    keys = ("max_depth", "max_bins", "min_instances", "min_info_gain",
            "n_trees", "feature_k", "bootstrap", "subsample", "seed")
    out = {}
    for gi, t in enumerate(trials):
        specs = _fit_ensemble_folds(Xs, ys, cats, loss=loss, device=device,
                                    **{k: t[k] for k in keys})
        out.update(((gi, fi), sp) for fi, sp in enumerate(specs))
    return out


def fused_reg_stats_from_matrix(spec: _EnsembleSpec, X: np.ndarray,
                                lab: np.ndarray, link: str = "identity",
                                device=None):
    """The five regression statistics (n, Σd², Σ|d|, Σl, Σl²) of a
    regression ensemble's predictions on raw rows against `lab`, from
    one fused traversal and reduction on `device`
    (`inference.forest_eval_fn`); rows whose label is not finite are
    left out. Returns None for a classification ensemble (its metrics
    are not these)."""
    from ..device import resolve_device
    from ..utils.profiler import PROFILER
    from ._staging import stage_bins_cached, stage_rows
    from .inference import _tables, forest_eval_fn
    if spec.mode != "regression":
        return None
    dev = resolve_device(device)
    with PROFILER.span("binning.predict", rows=int(X.shape[0])):
        binned = bin_with(np.asarray(X, dtype=np.float64), spec.binning)
    lab = np.asarray(lab, np.float64)
    if binned.shape[0] != len(lab):
        raise ValueError(f"{binned.shape[0]} rows against {len(lab)} labels")
    finite = np.isfinite(lab)
    stats = forest_eval_fn(spec.depth, link)(
        stage_bins_cached(binned, dev),
        stage_rows(np.where(finite, lab, 0.0), dev),
        stage_rows(finite, dev), *_tables(*spec.stacked(), dev),
        float(spec.base))
    return tuple(float(s) for s in stats)


# ------------------------------------------------------------ estimators
class _Estimator(_DeclaredParams, Estimator):
    """A tree learner: keyword params over its `_params` table (a None
    value keeps the default; an unknown name raises TypeError)."""
    _model_cls = None

    def __init__(self, **kwargs):
        super().__init__()
        for k in kwargs:
            if k not in self._params:
                raise TypeError(f"{type(self).__name__} got an unexpected "
                                f"param {k!r}")
        self._set(**kwargs)

    def fit(self, dataset, y=None, categorical: Optional[Dict[int, int]]
            = None, device=None, params: Optional[dict] = None):
        """Fit on a DataFrame (`fit(df)`, `fit(df, paramMap)`) on the
        session's device, or on a feature matrix (n, F) and labels (n,)
        (`fit(X, y, categorical, device)`) on `device`, the card by
        default. Rows whose label is not finite are dropped. Returns the
        model."""
        from ..frame.dataframe import DataFrame
        if isinstance(dataset, DataFrame):
            return super().fit(dataset, y if y is not None else params)
        X = np.asarray(dataset)
        if X.dtype != np.float32:  # f32 features bin as f32, as in JAX
            X = X.astype(np.float64)
        y = np.asarray(y, dtype=np.float64)
        ok = np.isfinite(y)
        spec = _fit_ensemble(X[ok], y[ok],
                             categorical=dict(categorical or {}),
                             device=device, **self._fit_args(X.shape[1]))
        model = self._model_cls(spec)
        model._inherit_params(self)
        return model

    def _extract(self, df):
        """(features, labels, categorical slots) of a frame, rows whose
        label is not finite dropped: what `fit(df)` fits on."""
        from ._staging import extract_xy
        fc = self.getOrDefault("featuresCol")
        X, y, _ = extract_xy(df, fc, self.getOrDefault("labelCol"))
        ok = np.isfinite(y)
        if not ok.all():
            X, y = X[ok], y[ok]
        return X, y, _categorical_slots(df, fc)

    def _fit(self, df):
        from ..device import session_device
        X, y, cats = self._extract(df)
        return self.fit(X, y, categorical=cats, device=session_device())

    def _fit_args(self, n_features: int) -> dict:
        raise NotImplementedError

    def fit_chunked(self, source, device=None):
        """Fit on a `frame._chunks.ChunkSource` through the streamed
        quantization (`ml/_chunked.fit_ensemble_chunked`) on `device` (the
        card by default): the raw rows are never whole. Returns the model
        `fit` would; with an exact sketch, the same model as `fit` on the
        materialized rows. Categorical slots are not read from a source
        (`categorical={}`, as in the JAX package). The DT, RF and GBT
        params apply; an XGBoost estimator has no `maxDepth` and raises,
        as in the JAX package (its chunked path is
        `fit_ensemble_chunked` with XGBoost's arguments)."""
        from ._chunked import fit_ensemble_chunked
        g = self.getOrDefault
        kwargs = dict(categorical={}, max_depth=int(g("maxDepth")),
                      max_bins=int(g("maxBins")),
                      min_instances=int(g("minInstancesPerNode")),
                      min_info_gain=float(g("minInfoGain")),
                      seed=self._seed(),
                      loss="logistic" if self._is_classifier else "squared")
        if self.hasParam("maxIter"):        # boosted (GBT)
            kwargs.update(n_trees=int(g("maxIter")), feature_k=None,
                          bootstrap=False,
                          subsample=float(g("subsamplingRate")),
                          step_size=float(g("stepSize")), boosting=True)
        elif self.hasParam("numTrees"):     # bootstrap forest
            kwargs.update(n_trees=int(g("numTrees")),
                          feature_k=_feature_k(g("featureSubsetStrategy"),
                                               source.n_features,
                                               self._is_classifier),
                          bootstrap=True,
                          subsample=float(g("subsamplingRate")))
        else:                               # one decision tree
            kwargs.update(n_trees=1, feature_k=None, bootstrap=False,
                          subsample=1.0)
        model = self._model_cls(fit_ensemble_chunked(source, device=device,
                                                     **kwargs))
        model._inherit_params(self)
        return model


class _TreeEstimatorBase(_Estimator):
    _params = _TREE_PARAMS
    _is_classifier = False
    _loss = "squared"

    def _seed(self) -> int:
        s = self.getOrDefault("seed")
        return int(s) if s is not None else 17

    def _fit_args(self, n_features: int) -> dict:
        g = self.getOrDefault
        return dict(max_depth=int(g("maxDepth")), max_bins=int(g("maxBins")),
                    min_instances=int(g("minInstancesPerNode")),
                    min_info_gain=float(g("minInfoGain")),
                    n_trees=1, feature_k=None, bootstrap=False,
                    subsample=1.0, seed=self._seed(), loss=self._loss)


class _RandomForestBase(_TreeEstimatorBase):
    """A bootstrap forest: Poisson(subsamplingRate) row weights per tree
    and `featureSubsetStrategy`'s features per node."""
    _params = _RF_PARAMS

    def _fit_args(self, n_features: int) -> dict:
        g = self.getOrDefault
        args = super()._fit_args(n_features)
        args.update(n_trees=int(g("numTrees")),
                    feature_k=_feature_k(g("featureSubsetStrategy"),
                                         n_features, self._is_classifier),
                    bootstrap=True, subsample=float(g("subsamplingRate")))
        return args


class _GBTBase(_TreeEstimatorBase):
    _params = _GBT_PARAMS

    def _fit_args(self, n_features: int) -> dict:
        args = super()._fit_args(n_features)
        args.update(n_trees=int(self.getOrDefault("maxIter")),
                    subsample=float(self.getOrDefault("subsamplingRate")),
                    step_size=float(self.getOrDefault("stepSize")),
                    boosting=True)
        return args


class DecisionTreeRegressionModel(_TreeRegressionModel):
    _params = _TREE_PARAMS

    @property
    def depth(self) -> int:
        return self._spec.depth


class DecisionTreeClassificationModel(_TreeClassificationModel):
    _params = dict(_TREE_PARAMS, **_CLASSIFIER_PARAMS)


class RandomForestRegressionModel(_TreeRegressionModel):
    _params = _RF_PARAMS


class RandomForestClassificationModel(_TreeClassificationModel):
    _params = dict(_RF_PARAMS, **_CLASSIFIER_PARAMS)


class GBTRegressionModel(_TreeRegressionModel):
    _params = _GBT_PARAMS


class GBTClassificationModel(_TreeClassificationModel):
    _params = dict(_GBT_PARAMS, **_CLASSIFIER_PARAMS)


class DecisionTreeRegressor(_TreeEstimatorBase):
    _model_cls = DecisionTreeRegressionModel


class DecisionTreeClassifier(_TreeEstimatorBase):
    _params = dict(_TREE_PARAMS, **_CLASSIFIER_PARAMS)
    _model_cls = DecisionTreeClassificationModel
    _is_classifier = True
    _loss = "logistic"


class RandomForestRegressor(_RandomForestBase):
    _model_cls = RandomForestRegressionModel


class RandomForestClassifier(_RandomForestBase):
    _params = dict(_RF_PARAMS, **_CLASSIFIER_PARAMS)
    _model_cls = RandomForestClassificationModel
    _is_classifier = True
    _loss = "logistic"


class GBTRegressor(_GBTBase):
    _model_cls = GBTRegressionModel


class GBTClassifier(_GBTBase):
    _params = dict(_GBT_PARAMS, **_CLASSIFIER_PARAMS)
    _model_cls = GBTClassificationModel
    _is_classifier = True
    _loss = "logistic"
