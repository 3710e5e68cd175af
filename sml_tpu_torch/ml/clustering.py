"""KMeans: Lloyd's assign / recompute loop on one device or over ranks.

The port's copy of `sml_tpu/ml/clustering.py` (MLE 02,
`SML/ML Electives/MLE 02 - K-Means.py:183-204`). The initial centers
are drawn on the host by the JAX package's k-means++-style seeding,
verbatim, so they are its bits. Lloyd's loop then runs `maxIter` fixed
iterations on the device with no host round trip: squared distances by
the expansion |x|² - 2x·c + |c|², the argmin, per-cluster sums and
counts (a one-hot matmul), and the new centers, an empty cluster
keeping its center; then the final cost. Distances and cluster sums are
float64 and each iteration's centers are rounded to f32 (the JAX
package's center dtype), so the card and the CPU assign every point
alike; the final centers and cost come back in one copy.
`BisectingKMeans` trains plain KMeans, as in the JAX package.

Over a mesh of ranks on the fit's device every rank draws the same
initial centers from all the rows, stages only its block
(`_staging.mesh_rows`), and all-reduces each iteration's sums and
counts in one call of k*d + k float64 values, and the cost once at the
end (`tree_impl.mesh_merge`), as the JAX package psums them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..frame.column import block_len
from ..utils.profiler import PROFILER
from ._staging import extract_features, features_of
from .base import Estimator, Model, load_arrays, save_arrays


def _sq_dists(X: torch.Tensor, x2: torch.Tensor,
              centers: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances by the expansion formula, in the
    tensors' dtype (float64 here)."""
    return x2 - 2.0 * (X @ centers.T) + torch.sum(centers * centers,
                                                  dim=1)[None, :]


def lloyd(X: torch.Tensor, init_centers: np.ndarray, max_iter: int,
          mesh=None):
    """`max_iter` Lloyd iterations of the device rows `X` (n, d) from
    `init_centers` (k, d); returns (centers (k, d) f32, cost) on the
    host after one copy. Over a `mesh` `X` is this rank's block and the
    sums, counts and cost are all-reduced over its ranks."""
    merge = None
    if mesh is not None:
        from .tree_impl import mesh_merge
        merge = mesh_merge(mesh)
    k = init_centers.shape[0]
    X = X.to(torch.float64)
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    centers = torch.from_numpy(np.asarray(init_centers, np.float64)).to(
        X.device)
    ks = torch.arange(k, device=X.device)
    for _ in range(max_iter):
        assign = torch.argmin(_sq_dists(X, x2, centers), dim=1)
        onehot = (assign[:, None] == ks[None, :]).to(torch.float64)
        sums = onehot.T @ X
        counts = torch.sum(onehot, dim=0)
        if merge is not None:
            flat = merge(torch.cat([sums.reshape(-1), counts]))
            sums, counts = flat[:-k].reshape(sums.shape), flat[-k:]
        new = (sums / counts.clamp_min(1.0)[:, None]).to(
            torch.float32).to(torch.float64)
        centers = torch.where(counts[:, None] > 0, new, centers)
    cost = torch.sum(torch.min(_sq_dists(X, x2, centers), dim=1).values)
    if merge is not None:
        cost = merge(cost.reshape(1))[0]
    flat = torch.cat([centers.reshape(-1), cost.reshape(1)]).to(
        torch.float32).cpu().numpy()
    return flat[:-1].reshape(k, -1), float(flat[-1])


def kmeans_init(X: np.ndarray, k: int, seed) -> np.ndarray:
    """The JAX package's k-means++-style seeding on the host (k passes
    over a sample of at most 4,096 rows), draw for draw."""
    rng = np.random.default_rng(int(seed) if seed is not None else 0)
    sample = X[rng.choice(len(X), size=min(len(X), 4096), replace=False)]
    centers = [sample[rng.integers(len(sample))]]
    for _ in range(1, k):
        d2 = np.min(
            ((sample[:, None, :] - np.stack(centers)[None]) ** 2).sum(-1),
            axis=1)
        p = d2 / d2.sum() if d2.sum() > 0 else None
        centers.append(sample[rng.choice(len(sample), p=p)])
    return np.stack(centers).astype(np.float32)


class KMeans(Estimator):
    def _init_params(self):
        self._declareParam("featuresCol", default="features",
                           doc="features column")
        self._declareParam("predictionCol", default="prediction",
                           doc="cluster column")
        self._declareParam("k", default=2, doc="number of clusters")
        self._declareParam("maxIter", default=20, doc="Lloyd iterations")
        self._declareParam("seed", default=None, doc="init seed")
        self._declareParam("initMode", default="k-means||",
                           doc="k-means||-style init")
        self._declareParam("tol", default=1e-4,
                           doc="unused (fixed iterations)")

    def __init__(self, featuresCol=None, predictionCol=None, k=None,
                 maxIter=None, seed=None, initMode=None, tol=None):
        super().__init__()
        self._set(featuresCol=featuresCol, predictionCol=predictionCol, k=k,
                  maxIter=maxIter, seed=seed, initMode=initMode, tol=tol)

    def setK(self, v):
        return self._set(k=v)

    def setSeed(self, v):
        return self._set(seed=v)

    def setMaxIter(self, v):
        return self._set(maxIter=v)

    def _fit(self, df) -> "KMeansModel":
        from ..device import session_device
        from ..parallel.dispatch import WorkHint
        from ._staging import mesh_rows, routed_for, stage_rows
        X = extract_features(df, self.getOrDefault("featuresCol"))
        k = int(self.getOrDefault("k"))
        max_iter = int(self.getOrDefault("maxIter"))
        init = kmeans_init(X, k, self.getOrDefault("seed"))
        # Lloyd's loop routed as one program (the CPU under
        # sml.dispatch.mode=host), over a mesh each rank's block
        hint = WorkHint(flops=3.0 * max_iter * X.size * k, kind="blas")
        with routed_for(hint, X, device=session_device()) as device, \
                PROFILER.span("program.lloyd", rows=len(X),
                              route=device.type):
            mesh, rows = mesh_rows(device, len(X), (X, init),
                                   grid=("lloyd", max_iter))
            centers, cost = lloyd(stage_rows(X[rows], device), init,
                                  max_iter, mesh)
        m = KMeansModel(centers=centers, trainingCost=cost)
        m._inherit_params(self)
        return m


class KMeansSummary:
    def __init__(self, trainingCost: float, k: int):
        self.trainingCost = trainingCost
        self.k = k


class KMeansModel(Model):
    def _init_params(self):
        KMeans._init_params(self)

    def __init__(self, centers: Optional[np.ndarray] = None,
                 trainingCost: float = 0.0):
        super().__init__()
        self._centers = centers
        self._trainingCost = trainingCost

    def clusterCenters(self):
        return [c for c in np.asarray(self._centers, dtype=np.float64)]

    @property
    def summary(self) -> KMeansSummary:
        return KMeansSummary(self._trainingCost, len(self._centers))

    def computeCost(self, df) -> float:
        X = extract_features(df, self.getOrDefault("featuresCol"))
        d2 = ((X[:, None, :] - self._centers[None]) ** 2).sum(-1)
        return float(np.min(d2, axis=1).sum())

    def _transform(self, df):
        from ..device import session_device
        session_device()  # a DataFrame entry point: no card, no transform
        oc = self.getOrDefault("predictionCol")
        fc = self.getOrDefault("featuresCol")
        centers = self._centers

        def fn(block, ctx):
            out = dict(block)
            if not block_len(block):
                out[oc] = np.zeros(0, np.int32)
                return out
            X = features_of(block, fc)
            d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
            out[oc] = np.argmin(d2, axis=1).astype(np.int32)
            return out

        return df._derive_rowlocal(fn, op="predict")

    def _save_state(self, path):
        save_arrays(path, centers=self._centers,
                    cost=np.asarray([self._trainingCost]))

    def _load_state(self, path, meta):
        d = load_arrays(path)
        self._centers = d["centers"]
        self._trainingCost = float(d["cost"][0])


class BisectingKMeans(KMeans):
    """Accepted for surface parity; trains plain KMeans (the course only
    instantiates the default variant)."""
