"""AutoML-lite: `regress()` / `classify()`.

The port's copy of `sml_tpu/automl.py`. The reference calls
`databricks.automl.regress(train_df, target_col=..., primary_metric=
"rmse", timeout_minutes=5, max_trials=10)` and reads
`summary.best_trial.mlflow_run_id` (`SML/ML 09 - AutoML.py:48-81`). This
does the same on the port: feature-type inference from the frame's
schema -> an Imputer / StringIndexer / OneHotEncoder / VectorAssembler
pipeline -> a TPE search (`tune.fmin`, `RandomState(42)`) over model
family and hyperparameters (linear, random forest, boosted trees), each
trial fitted and evaluated on the session's device and logged as a
tracking run. Under the same seed it proposes the JAX package's trials
(the same families and parameters) through its 11th.
"""

from __future__ import annotations

import types
from typing import Any, Dict, List, Optional

import numpy as np

from . import tracking as mlflow
from .device import session_device
from .ml import Pipeline
from .ml.classification import (GBTClassifier, LogisticRegression,
                                RandomForestClassifier)
from .ml.evaluation import BinaryClassificationEvaluator, RegressionEvaluator
from .ml.feature import Imputer, OneHotEncoder, StringIndexer, VectorAssembler
from .ml.regression import (GBTRegressor, LinearRegression,
                            RandomForestRegressor)
from .tune import STATUS_OK, Trials, fmin, hp, tpe
from .utils.profiler import wallclock


class TrialInfo:
    def __init__(self, run_id: str, metrics: Dict[str, float],
                 params: Dict[str, Any], model_description: str):
        self.mlflow_run_id = run_id
        self.metrics = metrics
        self.params = params
        self.model_description = model_description

    @property
    def notebook_path(self):  # surface parity; there are no notebooks here
        return None

    def __repr__(self):
        return f"TrialInfo({self.model_description}, metrics={self.metrics})"


class AutoMLSummary:
    def __init__(self, best_trial: TrialInfo, trials: List[TrialInfo],
                 experiment_id: str, output_df_schema=None):
        self.best_trial = best_trial
        self.trials = trials
        self.experiment = types.SimpleNamespace(experiment_id=experiment_id)

    def __repr__(self):
        return (f"AutoMLSummary(best={self.best_trial!r}, "
                f"n_trials={len(self.trials)})")


def _build_feature_pipeline(df, target_col: str):
    """The prep stages for every column but the target, by the frame's
    schema: numeric columns median-imputed, text columns indexed (unseen
    labels kept) and one-hot encoded, all assembled into "features"."""
    schema = {f.name: f.dataType.simpleString() for f in df.schema.fields}
    str_cols = [c for c, t in schema.items()
                if t == "string" and c != target_col]
    num_cols = [c for c, t in schema.items()
                if t in ("double", "float", "int", "bigint")
                and c != target_col]
    stages: List = []
    assembled: List[str] = []
    if num_cols:
        out_num = [f"{c}__imp" for c in num_cols]
        stages.append(Imputer(strategy="median", inputCols=num_cols,
                              outputCols=out_num))
        assembled += out_num
    if str_cols:
        idx = [f"{c}__idx" for c in str_cols]
        ohe = [f"{c}__ohe" for c in str_cols]
        stages.append(StringIndexer(inputCols=str_cols, outputCols=idx,
                                    handleInvalid="keep"))
        stages.append(OneHotEncoder(inputCols=idx, outputCols=ohe))
        assembled += ohe
    stages.append(VectorAssembler(inputCols=assembled, outputCol="features",
                                  handleInvalid="keep"))
    return stages


def _search(df, target_col: str, primary_metric: str, timeout_minutes: float,
            max_trials: int, task: str,
            experiment_name: Optional[str]) -> AutoMLSummary:
    # no card: raise before any trial starts (fmin records a raising
    # objective as a failed trial, as hyperopt does)
    session_device()
    exp = mlflow.set_experiment(
        experiment_name or f"automl-{task}-{target_col}-{int(wallclock())}")
    feature_stages = _build_feature_pipeline(df, target_col)
    train, val = df.randomSplit([0.8, 0.2], seed=42)
    deadline = wallclock() + timeout_minutes * 60

    if task == "regress":
        evaluator = RegressionEvaluator(labelCol=target_col,
                                        metricName=primary_metric)
        families = {
            "linear": lambda p: LinearRegression(
                labelCol=target_col, regParam=p["reg"],
                elasticNetParam=p["enet"]),
            "rf": lambda p: RandomForestRegressor(
                labelCol=target_col, maxDepth=int(p["depth"]),
                numTrees=int(p["trees"]), seed=42),
            "gbt": lambda p: GBTRegressor(
                labelCol=target_col, maxDepth=int(p["depth"]),
                maxIter=int(p["trees"]), stepSize=p["lr"], seed=42),
        }
    else:
        evaluator = BinaryClassificationEvaluator(labelCol=target_col)
        families = {
            "linear": lambda p: LogisticRegression(
                labelCol=target_col, regParam=p["reg"]),
            "rf": lambda p: RandomForestClassifier(
                labelCol=target_col, maxDepth=int(p["depth"]),
                numTrees=int(p["trees"]), seed=42),
            "gbt": lambda p: GBTClassifier(
                labelCol=target_col, maxDepth=int(p["depth"]),
                maxIter=int(p["trees"]), stepSize=p["lr"], seed=42),
        }

    space = {
        "family": hp.choice("family", list(families)),
        "reg": hp.loguniform("reg", np.log(1e-4), np.log(1.0)),
        "enet": hp.uniform("enet", 0.0, 1.0),
        "depth": hp.quniform("depth", 3, 8, 1),
        "trees": hp.quniform("trees", 10, 60, 10),
        "lr": hp.loguniform("lr", np.log(0.02), np.log(0.5)),
    }
    larger_better = evaluator.isLargerBetter()
    infos: List[TrialInfo] = []

    def objective(params):
        if wallclock() > deadline:
            return {"status": "fail", "error": "timeout"}
        family = params["family"]
        est = families[family](params)
        pipeline = Pipeline(stages=feature_stages + [est])
        with mlflow.start_run(run_name=f"trial-{family}") as run:
            model = pipeline.fit(train)
            metric = evaluator.evaluate(model.transform(val))
            mlflow.log_params(dict(params))
            mlflow.log_metric(f"val_{primary_metric}", metric)
            mlflow.spark.log_model(model, "model")
        infos.append(TrialInfo(run.info.run_id,
                               {f"val_{primary_metric}": metric}, params,
                               model_description=family))
        return {"loss": -metric if larger_better else metric,
                "status": STATUS_OK}

    trials = Trials()
    fmin(objective, space, algo=tpe, max_evals=max_trials, trials=trials,
         rstate=np.random.RandomState(42))
    if not infos:
        raise RuntimeError("AutoML: no successful trials within budget")
    key = f"val_{primary_metric}"
    best = min(infos, key=lambda t: -t.metrics[key] if larger_better
               else t.metrics[key])
    return AutoMLSummary(best, infos, exp.experiment_id)


def regress(dataset, target_col: str, primary_metric: str = "rmse",
            timeout_minutes: float = 5.0, max_trials: int = 10,
            experiment_name: Optional[str] = None, **kw) -> AutoMLSummary:
    return _search(dataset, target_col, primary_metric, timeout_minutes,
                   max_trials, "regress", experiment_name)


def classify(dataset, target_col: str, primary_metric: str = "areaUnderROC",
             timeout_minutes: float = 5.0, max_trials: int = 10,
             experiment_name: Optional[str] = None, **kw) -> AutoMLSummary:
    return _search(dataset, target_col, primary_metric, timeout_minutes,
                   max_trials, "classify", experiment_name)
