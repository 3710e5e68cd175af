"""The ML pipeline API: Params, Pipeline, the tree-ensemble, linear,
logistic, KMeans and ALS estimators and models, feature stages,
evaluators, model selection, host binning and scoring (`sml_tpu.ml`)."""

from ._tree_models import (DecisionTreeClassifier, DecisionTreeRegressor,
                           GBTClassifier, GBTRegressor,
                           RandomForestClassifier, RandomForestRegressor,
                           spec_from_arrays)
from .base import (Estimator, Model, Pipeline, PipelineModel, Transformer,
                   load, load_model, load_native)
from .classification import LogisticRegression, LogisticRegressionModel
from .clustering import BisectingKMeans, KMeans, KMeansModel
from .inference import (DeviceScorer, forest_eval_fn, predict_forest_sharded,
                        predict_linear_sharded)
from .param import Param, Params
from .recommendation import ALS, ALSModel
from .regression import LinearRegression, LinearRegressionModel
from .tuning import (CrossValidator, CrossValidatorModel, ParamGridBuilder,
                     TrainValidationSplit, TrainValidationSplitModel)

__all__ = ["ALS", "ALSModel", "BisectingKMeans", "CrossValidator",
           "CrossValidatorModel", "DecisionTreeClassifier",
           "DecisionTreeRegressor", "DeviceScorer", "Estimator",
           "GBTClassifier", "GBTRegressor", "KMeans", "KMeansModel",
           "LinearRegression", "LinearRegressionModel",
           "LogisticRegression", "LogisticRegressionModel", "Model",
           "Param", "Params", "ParamGridBuilder", "Pipeline",
           "PipelineModel", "RandomForestClassifier",
           "RandomForestRegressor", "TrainValidationSplit",
           "TrainValidationSplitModel", "Transformer", "forest_eval_fn",
           "load", "load_model", "load_native", "predict_forest_sharded",
           "predict_linear_sharded", "spec_from_arrays"]
