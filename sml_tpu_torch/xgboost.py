"""XGBoost-surface tree models (`sml_tpu/xgboost.py`), predict side.

The boosted ensembles of `XgboostRegressor`/`XgboostClassifier` are the
same `_EnsembleSpec` as GBT's, so the models subclass the same bases.
"""

from __future__ import annotations

from .ml._tree_models import _TreeClassificationModel, _TreeRegressionModel


class XgboostRegressorModel(_TreeRegressionModel):
    pass


class XgboostClassifierModel(_TreeClassificationModel):
    pass
