"""Model selection: grid search CV and train/validation split.

The port's copy of `sml_tpu/ml/tuning.py`. The course's surface
(`SML/ML 07 - Random Forests and Hyperparameter Tuning.py:72-158`):
`ParamGridBuilder().addGrid(...).build()`, `CrossValidator(estimator,
evaluator, estimatorParamMaps, numFolds=3, parallelism=4, seed=42)` with
`avgMetrics`/`bestModel`, and both stage orders (CV inside the pipeline
and the pipeline inside CV, `ML 07:134-149`).

Two ways to run a grid, chosen from its shapes before any work starts
(`fused_cv_applies`):

- fused: a DT/RF regressor whose grid touches only tree
  hyperparameters fits the G x k (grid point x fold) matrix as
  ceil(G*k / `sml.cv.maxFusedTrials`) fused fits on the device
  (`_tree_models._fit_ensembles_grid`), every element its sequential fit
  bit for bit; each model is scored on its fold through the evaluator
  (one `forest_traverse` launch, the pushdown);
- placed trials: anything else fits and evaluates `est.copy(pmap)` per
  (grid point, fold), `parallelism` threads wide on the session's device
  (`device.run_placed_trials`). One card has one layout, so parallelism
  does not change a result.

Under a mesh of ranks (every rank runs the same CV on the same frame)
the fused fits split their rows over the ranks or spread their
elements over lanes of ranks (`tree_impl.fit_ensembles_trials`), and
placed trials run on disjoint groups of ranks
(`parallel.mesh.run_placed_trials`), each trial's fits data-parallel
inside its group. Either way every rank fits the one-rank models, so
`avgMetrics` do not depend on the mesh. The validation folds are
evaluated whole on every rank.

Once the fused way is chosen its errors propagate: there is no fallback
to placed trials.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Dict, List

import numpy as np

from ..device import run_placed_trials
from .base import Estimator, Model, load
from .param import Param

#: the tree params a fused grid may vary: none of them reshapes the
#: fit's data
FUSED_PARAMS = frozenset({"maxDepth", "maxBins", "numTrees",
                          "featureSubsetStrategy", "subsamplingRate",
                          "minInstancesPerNode", "minInfoGain", "seed"})


class ParamGridBuilder:
    def __init__(self):
        self._grid: Dict[Param, List[Any]] = {}

    def addGrid(self, param: Param, values) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        for m in args:
            for p, v in (m.items() if isinstance(m, dict) else [m]):
                self._grid[p] = [v]
        return self

    def build(self) -> List[Dict[Param, Any]]:
        keys = list(self._grid.keys())
        out = []
        for combo in itertools.product(*[self._grid[k] for k in keys]):
            out.append(dict(zip(keys, combo)))
        return out or [{}]


class _ValidatorParams:
    def _declare_validator_params(self):
        self._declareParam("estimator", doc="estimator to tune")
        self._declareParam("estimatorParamMaps", doc="param grid")
        self._declareParam("evaluator", doc="metric evaluator")
        self._declareParam("seed", default=None, doc="fold assignment seed")
        self._declareParam("parallelism", default=1, doc="concurrent trials")
        self._declareParam("collectSubModels", default=False,
                           doc="keep sub-models")


def _fit_and_eval(est: Estimator, pmap, train, val, evaluator) -> float:
    model = est.copy(pmap).fit(train)
    return evaluator.evaluate(model.transform(val))


def _fused_kinds() -> dict:
    from ._tree_models import (DecisionTreeRegressionModel,
                               DecisionTreeRegressor,
                               RandomForestRegressionModel,
                               RandomForestRegressor)
    return {DecisionTreeRegressor: (DecisionTreeRegressionModel, False),
            RandomForestRegressor: (RandomForestRegressionModel, True)}


def fused_cv_applies(est, grid) -> bool:
    """Whether a grid runs as fused fits: `sml.cv.batchFolds` is on, the
    estimator is a DT or RF regressor, and every param the grid sets is
    one of `FUSED_PARAMS`. Decided from these shapes alone; anything else
    takes placed trials."""
    from ..conf import GLOBAL_CONF
    return (GLOBAL_CONF.getBool("sml.cv.batchFolds")
            and type(est) in _fused_kinds()
            and all(p.name in FUSED_PARAMS for pm in grid for p in pm))


def _batched_fold_metrics(est, grid, fold_pairs, evaluator) -> np.ndarray:
    """The (len(grid), k) metric matrix of a grid that
    `fused_cv_applies` to, over k (train, validation) frame pairs: the
    G x k fits in chunks of `sml.cv.maxFusedTrials` elements
    (`_fit_ensembles_grid`), or with the key at 1 or below (or a
    minInstancesPerNode below 1, which the padded-bins argument needs),
    one fold-fused fit per grid point (`_fit_ensemble_folds`); each
    model evaluated on its validation frame."""
    from ..conf import GLOBAL_CONF
    from ..device import session_device
    from ._tree_models import (_feature_k, _fit_ensemble_folds,
                               _fit_ensembles_grid)
    model_cls, is_rf = _fused_kinds()[type(est)]
    device = session_device()
    extracted = [(est._extract(train), val) for train, val in fold_pairs]
    Xs = [e[0][0] for e in extracted]
    ys = [e[0][1] for e in extracted]
    cat = extracted[0][0][2]
    F = Xs[0].shape[1]
    cfgs = []
    for pm in grid:
        ec = est.copy(pm)
        if is_rf:
            n_trees = int(ec.getOrDefault("numTrees"))
            feature_k = _feature_k(ec.getOrDefault("featureSubsetStrategy"),
                                   F, ec._is_classifier)
            bootstrap, subsample = True, \
                float(ec.getOrDefault("subsamplingRate"))
        else:
            n_trees, feature_k, bootstrap, subsample = 1, None, False, 1.0
        cfgs.append(dict(
            est=ec,
            max_depth=int(ec.getOrDefault("maxDepth")),
            max_bins=int(ec.getOrDefault("maxBins")),
            min_instances=int(ec.getOrDefault("minInstancesPerNode")),
            min_info_gain=float(ec.getOrDefault("minInfoGain")),
            n_trees=n_trees, feature_k=feature_k, bootstrap=bootstrap,
            subsample=subsample, seed=ec._seed()))
    keys = ("max_depth", "max_bins", "min_instances", "min_info_gain",
            "n_trees", "feature_k", "bootstrap", "subsample", "seed")
    trials = [{k: c[k] for k in keys} for c in cfgs]
    max_fused = GLOBAL_CONF.getInt("sml.cv.maxFusedTrials")
    if max_fused > 1 and all(c["min_instances"] >= 1 for c in cfgs):
        specs = _fit_ensembles_grid(Xs, ys, cat, trials, max_fused,
                                    device=device)
    else:
        specs = {}
        for gi, t in enumerate(trials):
            specs.update(((gi, fi), sp) for fi, sp in enumerate(
                _fit_ensemble_folds(Xs, ys, cat, device=device, **t)))
    metrics = np.zeros((len(grid), len(fold_pairs)), dtype=np.float64)
    for (gi, fi), spec in sorted(specs.items()):
        model = model_cls(spec)
        model._inherit_params(cfgs[gi]["est"])
        metrics[gi, fi] = evaluator.evaluate(
            model.transform(extracted[fi][1]))
    return metrics


def fused_param_scores(est, pmaps, train, val, evaluator):
    """The metric of each param map of a DT/RF regressor fitted on one
    (train, val) pair, through the grid-fused fits: the evaluator behind
    TrainValidationSplit and the TPE loop's candidate generations (an
    `fmin` objective exposes it as `score_batch`). None when
    `fused_cv_applies` says no: the caller runs its per-trial path."""
    if not fused_cv_applies(est, pmaps):
        return None
    m = _batched_fold_metrics(est, pmaps, [(train, val)], evaluator)
    return [float(x) for x in m[:, 0]]


def _grid_metrics(est, grid, fold_pairs, evaluator, par: int) -> np.ndarray:
    """The (len(grid), k) metric matrix: fused when `fused_cv_applies`,
    else placed trials `par` threads wide."""
    if fused_cv_applies(est, grid):
        return _batched_fold_metrics(est, grid, fold_pairs, evaluator)
    jobs = [(gi, fi, pmap) for fi in range(len(fold_pairs))
            for gi, pmap in enumerate(grid)]

    def run(job):
        gi, fi, pmap = job
        train, val = fold_pairs[fi]
        return _fit_and_eval(est, pmap, train, val, evaluator)

    metrics = np.zeros((len(grid), len(fold_pairs)), dtype=np.float64)
    for (gi, fi, _), m in zip(jobs, run_placed_trials(jobs, run, par)):
        metrics[gi, fi] = m
    return metrics


class CrossValidator(Estimator, _ValidatorParams):
    def _init_params(self):
        self._declare_validator_params()
        self._declareParam("numFolds", default=3, doc="number of folds")

    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 numFolds=None, seed=None, parallelism=None,
                 collectSubModels=None):
        super().__init__()
        self._set(estimator=estimator, estimatorParamMaps=estimatorParamMaps,
                  evaluator=evaluator, numFolds=numFolds, seed=seed,
                  parallelism=parallelism, collectSubModels=collectSubModels)

    def _fit(self, df) -> "CrossValidatorModel":
        est = self.getOrDefault("estimator")
        grid = self.getOrDefault("estimatorParamMaps")
        evaluator = self.getOrDefault("evaluator")
        k = int(self.getOrDefault("numFolds"))
        seed = self.getOrDefault("seed")
        seed = int(seed) if seed is not None else 42
        par = max(1, int(self.getOrDefault("parallelism")))

        # seeded per-partition fold assignment, randomSplit's contract:
        # deterministic given (seed, partition layout)
        folds = df.randomSplit([1.0 / k] * k, seed=seed)
        for f in folds:
            f.cache()
        fold_pairs = []
        for fi in range(k):
            rest = [folds[j] for j in range(k) if j != fi]
            train = rest[0]
            for r in rest[1:]:
                train = train.union(r)
            fold_pairs.append((train.cache(), folds[fi]))

        avg = _grid_metrics(est, grid, fold_pairs, evaluator, par).mean(axis=1)
        best_idx = int(np.argmax(avg) if evaluator.isLargerBetter()
                       else np.argmin(avg))
        best_model = est.copy(grid[best_idx]).fit(df)
        cvm = CrossValidatorModel(bestModel=best_model, avgMetrics=list(avg))
        cvm._inherit_params(self)
        return cvm


class CrossValidatorModel(Model, _ValidatorParams):
    def _init_params(self):
        CrossValidator._init_params(self)

    def __init__(self, bestModel=None, avgMetrics=None, subModels=None):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.subModels = subModels

    def _transform(self, df):
        return self.bestModel.transform(df)

    def _extra_metadata(self):
        return {"avgMetrics": [float(m) for m in self.avgMetrics]}

    def _save_state(self, path):
        self.bestModel._save_to(os.path.join(path, "bestModel"))

    def _load_state(self, path, meta):
        self.avgMetrics = meta.get("avgMetrics", [])
        self.bestModel = load(os.path.join(path, "bestModel"))


class TrainValidationSplit(Estimator, _ValidatorParams):
    def _init_params(self):
        self._declare_validator_params()
        self._declareParam("trainRatio", default=0.75, doc="train fraction")

    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 trainRatio=None, seed=None, parallelism=None):
        super().__init__()
        self._set(estimator=estimator, estimatorParamMaps=estimatorParamMaps,
                  evaluator=evaluator, trainRatio=trainRatio, seed=seed,
                  parallelism=parallelism)

    def _fit(self, df) -> "TrainValidationSplitModel":
        est = self.getOrDefault("estimator")
        grid = self.getOrDefault("estimatorParamMaps")
        evaluator = self.getOrDefault("evaluator")
        ratio = float(self.getOrDefault("trainRatio"))
        seed = self.getOrDefault("seed")
        seed = int(seed) if seed is not None else 42
        par = max(1, int(self.getOrDefault("parallelism")))
        train, val = df.randomSplit([ratio, 1 - ratio], seed=seed)
        # one (train, val) pair: a 1-fold grid
        arr = _grid_metrics(est, grid, [(train.cache(), val.cache())],
                            evaluator, par)[:, 0]
        best_idx = int(np.argmax(arr) if evaluator.isLargerBetter()
                       else np.argmin(arr))
        best_model = est.copy(grid[best_idx]).fit(df)
        m = TrainValidationSplitModel(bestModel=best_model,
                                      validationMetrics=list(arr))
        m._inherit_params(self)
        return m


class TrainValidationSplitModel(Model, _ValidatorParams):
    def _init_params(self):
        TrainValidationSplit._init_params(self)

    def __init__(self, bestModel=None, validationMetrics=None):
        super().__init__()
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics or []

    def _transform(self, df):
        return self.bestModel.transform(df)

    def _save_state(self, path):
        self.bestModel._save_to(os.path.join(path, "bestModel"))

    def _load_state(self, path, meta):
        self.bestModel = load(os.path.join(path, "bestModel"))
