"""The ML pipeline API: Params, Pipeline, the tree-ensemble estimators
and models, feature stages, evaluators, host binning and scoring
(`sml_tpu.ml`)."""

from ._tree_models import (DecisionTreeClassifier, DecisionTreeRegressor,
                           GBTClassifier, GBTRegressor,
                           RandomForestClassifier, RandomForestRegressor,
                           spec_from_arrays)
from .base import (Estimator, Model, Pipeline, PipelineModel, Transformer,
                   load, load_model, load_native)
from .inference import DeviceScorer, forest_eval_fn, predict_forest_sharded
from .param import Param, Params

__all__ = ["DecisionTreeClassifier", "DecisionTreeRegressor", "DeviceScorer",
           "Estimator", "GBTClassifier", "GBTRegressor", "Model", "Param",
           "Params", "Pipeline", "PipelineModel", "RandomForestClassifier",
           "RandomForestRegressor", "Transformer", "forest_eval_fn", "load",
           "load_model", "load_native", "predict_forest_sharded",
           "spec_from_arrays"]
