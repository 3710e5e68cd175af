"""The ML pipeline API: Params, Pipeline, the tree-ensemble estimators
and models, feature stages, evaluators, model selection, host binning
and scoring (`sml_tpu.ml`)."""

from ._tree_models import (DecisionTreeClassifier, DecisionTreeRegressor,
                           GBTClassifier, GBTRegressor,
                           RandomForestClassifier, RandomForestRegressor,
                           spec_from_arrays)
from .base import (Estimator, Model, Pipeline, PipelineModel, Transformer,
                   load, load_model, load_native)
from .inference import DeviceScorer, forest_eval_fn, predict_forest_sharded
from .param import Param, Params
from .tuning import (CrossValidator, CrossValidatorModel, ParamGridBuilder,
                     TrainValidationSplit, TrainValidationSplitModel)

__all__ = ["CrossValidator", "CrossValidatorModel", "DecisionTreeClassifier",
           "DecisionTreeRegressor", "DeviceScorer", "Estimator",
           "GBTClassifier", "GBTRegressor", "Model", "Param", "Params",
           "ParamGridBuilder", "Pipeline", "PipelineModel",
           "RandomForestClassifier", "RandomForestRegressor",
           "TrainValidationSplit", "TrainValidationSplitModel",
           "Transformer", "forest_eval_fn", "load", "load_model",
           "load_native", "predict_forest_sharded", "spec_from_arrays"]
