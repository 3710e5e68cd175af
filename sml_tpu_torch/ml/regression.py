"""Regression estimators, where the course imports them from
(`sml_tpu/ml/regression.py`): the tree learners. `LinearRegression`
waits for the port's non-tree programs."""

from ._tree_models import (DecisionTreeRegressionModel, DecisionTreeRegressor,
                           GBTRegressionModel, GBTRegressor,
                           RandomForestRegressionModel, RandomForestRegressor)

__all__ = ["DecisionTreeRegressionModel", "DecisionTreeRegressor",
           "GBTRegressionModel", "GBTRegressor",
           "RandomForestRegressionModel", "RandomForestRegressor"]
