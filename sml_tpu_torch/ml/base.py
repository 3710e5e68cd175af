"""Transformer / Estimator / Model / Pipeline, and on-disk persistence.

The port's copy of `sml_tpu/ml/base.py`. A Transformer's
`.transform(df)` appends columns; an Estimator's `.fit(df)` learns and
returns a Model, itself a Transformer. `Pipeline` chains stages and
fits them one by one; `PipelineModel` applies them one by one.

Persistence is the JAX package's format: a directory with
`metadata.json` ({class, uid, params, extra}) and an optional `data.npz`
of arrays; a pipeline holds `stages/NN_uid/` subdirectories. The port
writes the JAX package's class names into `metadata.json`, and maps a
name back to its own class through `_model_classes()`, a plain table, so a
model saved by either package loads in both and loading never imports
the JAX package (nor any module a file names).

Where the stages are the course's prep chain (Imputer, StringIndexer,
OneHotEncoder, VectorAssembler) the pipeline takes the featurizer's
fused routes (`ml/featurizer.py`), as the JAX package does, with the
stage path's results: `Pipeline.fit` fits the prep stages from the raw
block and hands the estimator a one-pass block (or, for a large linear
fit, its compact form); `PipelineModel.transform` of such a chain ending
in a regression model runs one pass at first materialization and gives
the evaluator a pushdown (`_ScorerEvalHook`) that never assembles the
output frame. Whether a route applies is decided from the stages and
the frame before any work; the chosen route's errors propagate.

Not ported yet: run autologging (`autolog_fit`).
"""

from __future__ import annotations

import copy
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from .param import Params


def _model_classes() -> dict:
    """The loader's table: the JAX package's class name -> the port's
    class (built at each use: it names classes of modules that import
    this one)."""
    from .. import xgboost
    from . import _tree_models as tm
    from . import classification as cl
    from . import clustering as km
    from . import feature as ft
    from . import recommendation as rc
    from . import regression as rg
    from . import tuning as tn
    tree = {f"sml_tpu.ml._tree_models.{c}": getattr(tm, c) for c in (
        "DecisionTreeRegressionModel", "DecisionTreeClassificationModel",
        "RandomForestRegressionModel", "RandomForestClassificationModel",
        "GBTRegressionModel", "GBTClassificationModel",
        "DecisionTreeRegressor", "DecisionTreeClassifier",
        "RandomForestRegressor", "RandomForestClassifier", "GBTRegressor",
        "GBTClassifier")}
    feat = {f"sml_tpu.ml.feature.{c}": getattr(ft, c) for c in (
        "VectorAssembler", "StringIndexer", "StringIndexerModel",
        "IndexToString", "OneHotEncoder", "OneHotEncoderModel", "Imputer",
        "ImputerModel", "StandardScaler", "StandardScalerModel",
        "Bucketizer", "RFormula", "RFormulaModel")}
    xgb = {f"sml_tpu.xgboost.{c}": getattr(xgboost, c) for c in (
        "XgboostRegressorModel", "XgboostClassifierModel",
        "XgboostRegressor", "XgboostClassifier")}
    tuning = {f"sml_tpu.ml.tuning.{c}": getattr(tn, c) for c in (
        "CrossValidator", "CrossValidatorModel", "TrainValidationSplit",
        "TrainValidationSplitModel")}
    linear = {
        "sml_tpu.ml.regression.LinearRegression": rg.LinearRegression,
        "sml_tpu.ml.regression.LinearRegressionModel":
            rg.LinearRegressionModel,
        "sml_tpu.ml.classification.LogisticRegression":
            cl.LogisticRegression,
        "sml_tpu.ml.classification.LogisticRegressionModel":
            cl.LogisticRegressionModel,
        "sml_tpu.ml.clustering.KMeans": km.KMeans,
        "sml_tpu.ml.clustering.BisectingKMeans": km.BisectingKMeans,
        "sml_tpu.ml.clustering.KMeansModel": km.KMeansModel,
        "sml_tpu.ml.recommendation.ALS": rc.ALS,
        "sml_tpu.ml.recommendation.ALSModel": rc.ALSModel}
    return dict(tree, **feat, **xgb, **tuning, **linear,
                **{"sml_tpu.ml.base.Pipeline": Pipeline,
                   "sml_tpu.ml.base.PipelineModel": PipelineModel})


def jax_class_name(klass) -> str:
    """The JAX package's name of a port class, as `metadata.json` holds
    it."""
    for name, k in _model_classes().items():
        if k is klass:
            return name
    raise TypeError(f"{klass.__name__} has no counterpart in the saved "
                    f"format")


def load(path: str):
    """The port's object for a directory saved by either package's
    `save(path)`. Raises ValueError for a class the port does not carry
    yet."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    klass = _model_classes().get(meta["class"])
    if klass is None:
        raise ValueError(f"{path}: the port cannot load {meta['class']!r} "
                         f"yet (tree, linear, KMeans and ALS models and "
                         f"estimators, feature stages, pipelines and "
                         f"validators only)")
    obj = klass.__new__(klass)
    Params.__init__(obj)
    if meta.get("uid"):
        obj.uid = meta["uid"]
    obj._init_params()
    obj._params_from_dict(meta.get("params", {}))
    obj._load_state(path, meta.get("extra", {}))
    return obj


load_model = load
load_native = load


class MLWriter:
    def __init__(self, instance: "Saveable"):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "MLWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        if os.path.exists(path):
            if not self._overwrite:
                raise IOError(f"Path {path} already exists; use "
                              f".overwrite()")
            shutil.rmtree(path)
        self._instance._save_to(path)


class Saveable:
    """Mixin providing write()/save()/load() over the directory format."""

    def write(self) -> MLWriter:
        return MLWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    # -- subclass hooks ---------------------------------------------------
    def _extra_metadata(self) -> Dict[str, Any]:
        return {}

    def _save_state(self, path: str) -> None:
        """Save non-param array/object state; default: nothing."""

    def _load_state(self, path: str, meta: Dict[str, Any]) -> None:
        """Restore non-param state; default: nothing."""

    def _init_params(self) -> None:
        """Subclasses declare their Params here (called by both __init__
        and load); default: nothing."""

    # -- machinery --------------------------------------------------------
    def _save_to(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        meta = {
            "class": jax_class_name(type(self)),
            "uid": getattr(self, "uid", None),
            "params": self._params_to_dict() if isinstance(self, Params)
            else {},
            "extra": self._extra_metadata(),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        self._save_state(path)

    @classmethod
    def load(cls, path: str) -> Any:
        return load(path)

    @staticmethod
    def read():
        raise NotImplementedError("use .load(path)")


def save_arrays(path: str, **arrays) -> None:
    np.savez(os.path.join(path, "data.npz"), **arrays)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """The arrays of `<path>/data.npz` ({} when there is none). Object
    arrays are refused: the format holds numbers only."""
    fp = os.path.join(path, "data.npz")
    if not os.path.exists(fp):
        return {}
    with np.load(fp, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _save_stages(stages, path: str) -> None:
    for i, s in enumerate(stages):
        s._save_to(os.path.join(path, "stages", f"{i:02d}_{s.uid}"))


def _load_stages(path: str) -> list:
    stage_dir = os.path.join(path, "stages")
    if not os.path.exists(stage_dir):
        return []
    return [load(os.path.join(stage_dir, d))
            for d in sorted(os.listdir(stage_dir))]


class Transformer(Params, Saveable):
    def __init__(self):
        Params.__init__(self)
        self._init_params()

    def transform(self, df, params: Optional[dict] = None):
        if params:
            return self.copy(params).transform(df)
        return self._transform(df)

    def _transform(self, df):
        raise NotImplementedError


class Estimator(Params, Saveable):
    def __init__(self):
        Params.__init__(self)
        self._init_params()

    def fit(self, df, params: Optional[dict] = None):
        if params:
            return self.copy(params).fit(df)
        return self._fit(df)

    def _fit(self, df):
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer (MLlib: Model[M] extends Transformer)."""

    def _inherit_params(self, est: Params) -> "Model":
        """Copy the estimator's set params onto this model (shared
        names)."""
        for p, v in est._paramMap.items():
            if self.hasParam(p.name):
                self._paramMap[self.getParam(p.name)] = v
        return self


class Evaluator(Params, Saveable):
    def __init__(self):
        Params.__init__(self)
        self._init_params()

    def evaluate(self, df, params: Optional[dict] = None) -> float:
        """The metric of `df`. Like every DataFrame entry point it runs
        on the session's device (`sml.device`), and raises without a
        card unless that is the CPU."""
        from ..device import session_device
        session_device()
        if params:
            return self.copy(params).evaluate(df)
        return self._evaluate(df)

    def _evaluate(self, df) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


class Pipeline(Estimator):
    """`Pipeline(stages=[...])`: fit estimators and apply transformers in
    order."""

    def _init_params(self):
        self._declareParam("stages", default=[], doc="pipeline stages")

    def __init__(self, stages: Optional[List] = None):
        super().__init__()
        if stages is not None:
            self._set(stages=stages)

    def getStages(self) -> List:
        return self.getOrDefault("stages")

    def setStages(self, stages: List) -> "Pipeline":
        return self._set(stages=stages)

    def _fit(self, df) -> "PipelineModel":
        from ..frame.dataframe import DataFrame
        from .featurizer import attach_fused_features, try_fast_fit
        stages = self.getStages()
        cur = df
        raw = None
        if isinstance(df, DataFrame):
            # collapse to one partition first, as the JAX package does:
            # each stage's per-partition fn then runs once over the whole
            # frame; row-local transforms and global fits give the same
            # results in any layout
            raw = df._whole()

            def make_frame():
                f = DataFrame.from_partitions([raw], session=df._session)
                f._ml_attrs = dict(df._ml_attrs)
                return f

            # the whole-chain fused fit: the prep stages fit from the raw
            # block and the estimator reads a one-pass block; its fit
            # runs here, so its errors propagate
            fast = try_fast_fit(stages, raw, make_frame, df._ml_attrs)
            if fast is not None:
                fitted_prep, shim = fast
                return PipelineModel(fitted_prep + [stages[-1].fit(shim)])
            cur = make_frame()
        fitted: List[Transformer] = []
        for i, stage in enumerate(stages):
            last = i == len(stages) - 1
            if isinstance(stage, Estimator):
                if last and raw is not None:
                    cur = attach_fused_features(cur, fitted, stage, raw,
                                                df._ml_attrs)
                model = stage.fit(cur)
                fitted.append(model)
                if not last:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if not last:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor "
                                f"Transformer")
        return PipelineModel(fitted)

    def copy(self, extra=None) -> "Pipeline":
        that = super().copy(extra)
        # stages hold estimators with their own params: apply any extra
        # params addressed to them (tuning passes {est.param: v} through)
        if extra:
            new_stages = []
            for s in that.getStages():
                applicable = {p: v for p, v in extra.items()
                              if getattr(p, "parent", None) == s.uid}
                new_stages.append(s.copy(applicable) if applicable else s)
            that._paramMap[that.getParam("stages")] = new_stages
        return that

    def _extra_metadata(self):
        return {"n_stages": len(self.getStages())}

    def _save_state(self, path: str) -> None:
        _save_stages(self.getStages(), path)

    def _load_state(self, path: str, meta) -> None:
        self._paramMap[self.getParam("stages")] = _load_stages(path)


class PipelineModel(Model):
    def _init_params(self):
        pass

    def __init__(self, stages: Optional[List[Transformer]] = None):
        super().__init__()
        self.stages: List[Transformer] = stages or []

    def _transform(self, df):
        plan = self._fast_plan(df)
        if plan is not None:
            return self._fast_transform(df, plan)
        cur = df
        for s in self.stages:
            cur = s.transform(cur)
        return cur

    def _fast_plan(self, df):
        """The fused transform's plan for `df`, or None (the stage path
        runs): the compiled chain, memoized per stage list, and a check
        of `df`'s columns (its first row, as VectorAssembler peeks)."""
        from ..frame.dataframe import DataFrame
        from .featurizer import routes_on
        if not routes_on() or not isinstance(df, DataFrame) or \
                df.isStreaming:
            return None
        token = tuple((id(s), type(s).__name__) for s in self.stages)
        cached = self.__dict__.get("_fast_plan_cache")
        if cached is None or cached[0] != token:
            cached = (token, self._build_fast_plan())
            self._fast_plan_cache = cached
        plan = cached[1]
        if plan is None:
            return None
        feat = plan[0]
        if not feat.inputs_ok(df.limit(1)._whole(), df._ml_attrs):
            return None
        return plan

    def _build_fast_plan(self):
        """(featurizer, assembler, tail) of the fused transform, from the
        stages alone; `tail` is None for a pure feature pipeline. None
        when the stages are not the supported chain, when a regression
        tail does not read the assembler's output, or when an interim
        column could not come out of the one pass."""
        from ._tree_models import _TreeRegressionModel
        from .feature import VectorAssembler
        from .featurizer import CompiledFeaturizer
        from .regression import LinearRegressionModel
        stages = self.stages
        if not stages:
            return None
        tail = stages[-1]
        prep = stages
        if isinstance(tail, (LinearRegressionModel, _TreeRegressionModel)):
            # regression tails append exactly predictionCol; classifiers
            # (probability and rawPrediction columns) keep the stage path
            prep = stages[:-1]
        else:
            tail = None
        if not prep or not isinstance(prep[-1], VectorAssembler):
            return None
        assembler = prep[-1]
        feat = CompiledFeaturizer.from_stages(prep[:-1], assembler)
        if feat is None or not feat.columns_recoverable():
            return None
        if tail is not None and tail.getOrDefault("featuresCol") != \
                assembler.getOrDefault("outputCol"):
            return None
        return feat, assembler, tail

    def _fast_transform(self, df, plan):
        """The whole-pipeline fused transform: the prep chain runs as one
        columnar pass over the parent's block at first materialization,
        giving the interim columns, the assembled column and their
        `_ml_attrs` as the stage transforms give them, in the parent's
        partitions (less the rows an indexer skips); a regression tail
        then predicts from it through its own transform. The result
        carries `_ScorerEvalHook`, so an evaluator that reads it first
        needs no output frame at all."""
        from ..frame.column import block_len
        from ..frame.dataframe import DataFrame, take_rows
        from ..utils.profiler import PROFILER
        feat, assembler, tail = plan
        out_col = assembler.getOrDefault("outputCol")
        parent = df
        n_stages = len(self.stages)

        def compute():
            with PROFILER.span("fused_transform", stages=n_stages):
                parts = parent._materialize()
                raw = parent._whole()
                X, keep, cols = feat.transform_with_columns(raw)
                block = dict(raw) if keep is None else take_rows(raw, keep)
                block.update(cols)
                block[out_col] = X
                sizes = [block_len(p) for p in parts]
                if keep is not None:
                    edges = np.cumsum([0] + sizes)
                    sizes = [int(keep[lo:hi].sum())
                             for lo, hi in zip(edges[:-1], edges[1:])]
                bounds = np.cumsum([0] + sizes)
                return [take_rows(block, slice(lo, hi))
                        for lo, hi in zip(bounds[:-1], bounds[1:])]

        feats = DataFrame(compute, session=df._session, op="_fast_transform")
        feats._ml_attrs = dict(df._ml_attrs)
        feats._ml_attrs.update(feat.interim_attrs())
        feats._ml_attrs[out_col] = feat.feature_attrs(df._ml_attrs)
        if tail is None:
            return feats
        from ..device import session_device
        res = tail.transform(feats)
        res._fused_eval = _ScorerEvalHook(feat, tail, df, self.stages[:-1],
                                          session_device())
        return res

    def copy(self, extra=None) -> "PipelineModel":
        that = super().copy(extra)
        that.stages = [s.copy(extra) for s in self.stages]
        return that

    def _extra_metadata(self):
        return {"n_stages": len(self.stages)}

    def _save_state(self, path: str) -> None:
        _save_stages(self.stages, path)

    def _load_state(self, path: str, meta) -> None:
        self.stages = _load_stages(path)


class RegStatsHook:
    """Evaluator pushdown hook of a lazy model-transform frame.

    `RegressionEvaluator` consults `reg_stats` on an unmaterialized
    transform frame: a subclass computes the five regression sufficient
    statistics (n, Σd², Σ|d|, Σl, Σl²) from the transform's parent frame,
    without assembling the transform's output. The hook declines
    (returns None, and the evaluator materializes the frame) when the
    evaluator asks about another prediction column, or the label column
    is missing, empty or not numeric; any other error propagates."""

    #: elementwise links a hook may apply to its predictions, by numpy
    #: name (`with_link`)
    LINKS = frozenset({"identity", "exp", "log"})

    def __init__(self, tail, parent, device=None):
        self._tail = tail
        self._parent = parent
        self._device = device
        self._stats_cache: dict = {}
        self._link = "identity"

    def with_link(self, link: str, col_name: str):
        """A clone of this hook whose predictions pass through the
        elementwise `link` before the reductions (the ML 11 shape: fit
        on log(label), evaluate exp(prediction) on the raw scale). None
        (the caller keeps no hook) unless `col_name` is this hook's own
        prediction column, the link is known and no link is applied
        yet."""
        if link not in self.LINKS or self._link != "identity" or \
                self._tail.getOrDefault("predictionCol") != col_name:
            return None
        clone = copy.copy(self)
        clone._link = link
        clone._stats_cache = {}
        return clone

    def _label_ok(self, label_col: str) -> bool:
        return True

    def _compute(self, raw, lab, label_col: str):
        raise NotImplementedError

    def reg_stats(self, prediction_col: str, label_col: str):
        cached = self._stats_cache.get((prediction_col, label_col))
        if cached is not None:
            return cached  # rmse, then mae, then r2 cost one pass
        if self._tail.getOrDefault("predictionCol") != prediction_col:
            return None
        raw = self._parent._whole()
        lab = raw.get(label_col)
        if lab is None or len(lab) == 0 or lab.ndim != 1 or \
                lab.dtype.kind not in "fiub" or \
                not self._label_ok(label_col):
            return None
        stats = self._compute(raw, lab.astype(np.float64), label_col)
        if stats is not None:
            self._stats_cache[(prediction_col, label_col)] = stats
        return stats


class _ScorerEvalHook(RegStatsHook):
    """Evaluator pushdown of a fused pipeline transform: one featurize
    pass over the raw parent and the tail's predictions (for a tree tail
    the fused traversal and reduction on the device,
    `fused_reg_stats_from_matrix`), with no output frame (no interim or
    vector columns, no prediction column). The features are the f32
    block the stage path's model reads, and the labels the raw ones
    under the featurizer's row-keep mask, so the statistics are the
    stage path's."""

    def __init__(self, feat, tail, parent, prep_stages, device):
        super().__init__(tail, parent, device)
        self._feat = feat
        self._prep_stages = prep_stages

    def _label_ok(self, label_col: str) -> bool:
        # a prep stage that writes labelCol leaves raw labels that are
        # pre-transform values: the materialize path reads the right ones
        from .featurizer import produced_columns
        return label_col not in produced_columns(self._prep_stages)

    def _compute(self, raw, lab, label_col: str):
        X, keep = self._feat.transform_with_mask(raw)
        if keep is not None:
            lab = lab[keep]
        spec = getattr(self._tail, "_spec", None)
        if spec is not None:
            from ._tree_models import fused_reg_stats_from_matrix
            return fused_reg_stats_from_matrix(spec, X, lab,
                                               link=self._link,
                                               device=self._device)
        from .inference import DeviceScorer
        pred = DeviceScorer(self._tail, device=self._device).score_block(X)
        if self._link != "identity":
            pred = getattr(np, self._link)(pred)
        from .evaluation import reg_stats
        ok = np.isfinite(pred) & np.isfinite(lab)
        return reg_stats(pred[ok], lab[ok], self._device)
