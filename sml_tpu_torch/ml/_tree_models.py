"""Fitted tree-ensemble models, far enough to predict.

Counterpart of `sml_tpu/ml/_tree_models.py` on the predict side:
`_EnsembleSpec` (the host description of a fitted ensemble, in the same
arrays the JAX package saves), and the DT/RF/GBT regression and
classification models over it. Fitting is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .base import load_arrays
from .tree_impl import Binning, FittedTree, bin_with


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
