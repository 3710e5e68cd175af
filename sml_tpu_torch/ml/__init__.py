"""Tree-ensemble estimators, models, host binning and scoring
(`sml_tpu.ml`)."""

from ._tree_models import (DecisionTreeClassifier, DecisionTreeRegressor,
                           GBTClassifier, GBTRegressor,
                           RandomForestClassifier, RandomForestRegressor,
                           spec_from_arrays)
from .base import load_model
from .inference import DeviceScorer, forest_eval_fn, predict_forest_sharded

__all__ = ["DecisionTreeClassifier", "DecisionTreeRegressor", "DeviceScorer",
           "GBTClassifier", "GBTRegressor", "RandomForestClassifier",
           "RandomForestRegressor", "forest_eval_fn", "load_model",
           "predict_forest_sharded", "spec_from_arrays"]
