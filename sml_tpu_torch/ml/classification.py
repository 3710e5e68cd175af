"""Classification estimators, where the course imports them from
(`sml_tpu/ml/classification.py`): the tree learners.
`LogisticRegression` waits for the port's non-tree programs."""

from ._tree_models import (DecisionTreeClassificationModel,
                           DecisionTreeClassifier, GBTClassificationModel,
                           GBTClassifier, RandomForestClassificationModel,
                           RandomForestClassifier)

__all__ = ["DecisionTreeClassificationModel", "DecisionTreeClassifier",
           "GBTClassificationModel", "GBTClassifier",
           "RandomForestClassificationModel", "RandomForestClassifier"]
