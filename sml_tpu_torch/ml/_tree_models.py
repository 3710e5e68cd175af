"""Tree-ensemble estimators and models.

Counterpart of `sml_tpu/ml/_tree_models.py`: `_EnsembleSpec` (the host
description of a fitted ensemble, in the same arrays the JAX package
saves), the DT/RF/GBT regression and classification models over it,
`_fit_ensemble` (the one training path: bin on the host, fit every round
on the device) and the estimators `DecisionTreeRegressor`,
`DecisionTreeClassifier`, `RandomForestRegressor`,
`RandomForestClassifier`, `GBTRegressor` and `GBTClassifier`.

The port has no DataFrame: `fit(X, y, categorical=None, device=None)`
takes a numpy feature matrix and label vector (`categorical` maps a
feature slot to its cardinality, as the JAX package's `_ml_attrs` do)
and fits on the card unless `device="cpu"`. Random forests (a Poisson
bootstrap and a per-node feature subspace) and `subsamplingRate < 1`
draw the JAX package's Threefry streams from the estimator's seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from .base import load_arrays
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


class _TreeModelBase:
    """A fitted tree ensemble: its spec, uid and saved params."""

    def __init__(self, spec: _EnsembleSpec, params: Optional[dict] = None,
                 uid: Optional[str] = None):
        self._spec = spec
        self.params = dict(params or {})
        self.uid = uid

    @classmethod
    def _load(cls, path: str, meta: dict):
        return cls(_EnsembleSpec.load(path), meta.get("params"),
                   meta.get("uid"))

    @property
    def numFeatures(self) -> int:
        return self._spec.n_features

    @property
    def featureImportances(self) -> np.ndarray:
        return feature_importances(self._spec.trees, self._spec.n_features)

    def getNumTrees(self) -> int:
        return len(self._spec.trees)


class _TreeRegressionModel(_TreeModelBase):
    def predict(self, X: np.ndarray, device=None) -> np.ndarray:
        """The prediction column for raw rows (n, F)."""
        return self._spec.predict_margin(np.asarray(X, np.float64), device)


class _TreeClassificationModel(_TreeModelBase):
    def predict_probability(self, X: np.ndarray, device=None) -> np.ndarray:
        """P(class 1): forests of probability leaves clip, boosted
        margins go through the sigmoid."""
        m = self._spec.predict_margin(np.asarray(X, np.float64), device)
        if self._spec.tree_weights is None:
            return np.clip(m, 0.0, 1.0)
        return 1.0 / (1.0 + np.exp(-m))

    def predict(self, X: np.ndarray, device=None) -> np.ndarray:
        """The prediction column: 1.0 where P(class 1) > 0.5."""
        return (self.predict_probability(X, device) > 0.5).astype(float)


def _fit_ensemble(X: np.ndarray, y: np.ndarray, *, categorical: Dict[int, int],
                  max_depth: int, max_bins: int, min_instances: int,
                  min_info_gain: float, n_trees: int, feature_k: Optional[int],
                  bootstrap: bool, subsample: float, seed: int, loss: str,
                  step_size: float = 0.1, reg_lambda: float = 0.0,
                  gamma: float = 0.0, boosting: bool = False,
                  missing: Optional[float] = None,
                  device=None) -> _EnsembleSpec:
    """The one training path behind every tree learner: bin on the host,
    stage the compact bins and the labels on `device` (the card by
    default), and fit every round there
    (`tree_impl.fit_ensemble_on_device`). `missing`, when it is a
    number, becomes NaN before binning (NaN falls in bin 0). `seed`
    keys the Threefry streams of a sampled fit: a bootstrap of several
    trees, `subsample < 1` or `feature_k < F`."""
    from ..device import resolve_device
    from ..utils.profiler import PROFILER
    from ._staging import stage_bins_cached, stage_rows
    dev = resolve_device(device)
    F = X.shape[1]
    spec = TreeSpec(max_depth=max_depth, n_bins=max_bins, n_features=F,
                    feature_k=feature_k or F, min_instances=min_instances,
                    min_info_gain=min_info_gain, reg_lambda=reg_lambda,
                    gamma=gamma)
    es = EnsembleSpec(tree=spec, n_trees=n_trees, loss=loss,
                      boosting=boosting,
                      bootstrap=bool(bootstrap) and n_trees > 1,
                      subsample=float(subsample), step_size=float(step_size))
    y32 = np.asarray(y, np.float32)
    if missing is not None and not np.isnan(missing):
        X = X.copy()
        X[X == missing] = np.nan
    with PROFILER.span("binning.fit", rows=int(X.shape[0])):
        binned, binning = make_bins(X, y32, max_bins, categorical)
    with PROFILER.span("staging.fit", rows=int(X.shape[0])):
        binned_dev = stage_bins_cached(binned, dev)
        y_dev = stage_rows(y32, dev)
    trees, base = fit_ensemble_on_device(binned_dev, y_dev, es, seed)
    mode = "binary" if loss == "logistic" else "regression"
    if boosting:
        weights = np.full(len(trees), step_size, dtype=np.float32)
        return _EnsembleSpec(trees, max_depth, binning, weights, base, F,
                             mode)
    return _EnsembleSpec(trees, max_depth, binning, None, 0.0, F, mode)


# ------------------------------------------------------------ estimators
_TREE_PARAMS = dict(featuresCol="features", labelCol="label",
                    predictionCol="prediction", maxDepth=5, maxBins=32,
                    minInstancesPerNode=1, minInfoGain=0.0, seed=None)
_CLASSIFIER_PARAMS = dict(rawPredictionCol="rawPrediction",
                          probabilityCol="probability")
_GBT_PARAMS = dict(maxIter=20, stepSize=0.1, subsamplingRate=1.0)
_RF_PARAMS = dict(numTrees=20, featureSubsetStrategy="auto",
                  subsamplingRate=1.0)


class _Estimator:
    """Keyword params over declared defaults (`_defaults`); a None value
    keeps the default and an unknown name raises TypeError."""
    _defaults: Dict[str, object] = {}
    _model_cls = None

    def __init__(self, **kwargs):
        self._params: Dict[str, object] = {}
        self._set(**kwargs)

    def _set(self, **kwargs):
        for k, v in kwargs.items():
            if k not in self._defaults:
                raise TypeError(f"unexpected param {k!r}")
            if v is not None:
                self._params[k] = v
        return self

    def getOrDefault(self, name: str):
        return self._params.get(name, self._defaults[name])

    @property
    def params(self) -> dict:
        return {k: self.getOrDefault(k) for k in self._defaults}

    def fit(self, X, y, categorical: Optional[Dict[int, int]] = None,
            device=None):
        """Fit on a feature matrix (n, F) and labels (n,); rows whose
        label is not finite are dropped. Returns the model."""
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        ok = np.isfinite(y)
        spec = _fit_ensemble(X[ok], y[ok],
                             categorical=dict(categorical or {}),
                             device=device, **self._fit_args(X.shape[1]))
        return self._model_cls(spec, self.params)

    def _fit_args(self, n_features: int) -> dict:
        raise NotImplementedError


class _TreeEstimatorBase(_Estimator):
    _is_classifier = False
    _loss = "squared"

    def setMaxBins(self, v):
        return self._set(maxBins=v)

    def setMaxDepth(self, v):
        return self._set(maxDepth=v)

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
    def _fit_args(self, n_features: int) -> dict:
        g = self.getOrDefault
        args = super()._fit_args(n_features)
        args.update(n_trees=int(g("numTrees")),
                    feature_k=_feature_k(g("featureSubsetStrategy"),
                                         n_features, self._is_classifier),
                    bootstrap=True, subsample=float(g("subsamplingRate")))
        return args


class _GBTBase(_TreeEstimatorBase):
    def _fit_args(self, n_features: int) -> dict:
        args = super()._fit_args(n_features)
        args.update(n_trees=int(self.getOrDefault("maxIter")),
                    subsample=float(self.getOrDefault("subsamplingRate")),
                    step_size=float(self.getOrDefault("stepSize")),
                    boosting=True)
        return args


class DecisionTreeRegressionModel(_TreeRegressionModel):
    pass


class DecisionTreeClassificationModel(_TreeClassificationModel):
    pass


class RandomForestRegressionModel(_TreeRegressionModel):
    pass


class RandomForestClassificationModel(_TreeClassificationModel):
    pass


class GBTRegressionModel(_TreeRegressionModel):
    pass


class GBTClassificationModel(_TreeClassificationModel):
    pass


class DecisionTreeRegressor(_TreeEstimatorBase):
    _defaults = dict(_TREE_PARAMS)
    _model_cls = DecisionTreeRegressionModel


class DecisionTreeClassifier(_TreeEstimatorBase):
    _defaults = dict(_TREE_PARAMS, **_CLASSIFIER_PARAMS)
    _model_cls = DecisionTreeClassificationModel
    _is_classifier = True
    _loss = "logistic"


class RandomForestRegressor(_RandomForestBase):
    _defaults = dict(_TREE_PARAMS, **_RF_PARAMS)
    _model_cls = RandomForestRegressionModel


class RandomForestClassifier(_RandomForestBase):
    _defaults = dict(_TREE_PARAMS, **_RF_PARAMS, **_CLASSIFIER_PARAMS)
    _model_cls = RandomForestClassificationModel
    _is_classifier = True
    _loss = "logistic"


class GBTRegressor(_GBTBase):
    _defaults = dict(_TREE_PARAMS, **_GBT_PARAMS)
    _model_cls = GBTRegressionModel


class GBTClassifier(_GBTBase):
    _defaults = dict(_TREE_PARAMS, **_GBT_PARAMS, **_CLASSIFIER_PARAMS)
    _model_cls = GBTClassificationModel
    _is_classifier = True
    _loss = "logistic"
