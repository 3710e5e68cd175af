"""XGBoost-surface tree estimators and models (`sml_tpu/xgboost.py`).

`XgboostRegressor` and `XgboostClassifier` take the `sparkdl.xgboost`
params and fit through the same `_fit_ensemble` as GBT: boosted
second-order trees on the port's histogram kernels. `use_gpu`, `device`,
`num_workers` and `tree_method` are accepted for surface parity and not
read: `fit(X, y, device=...)` chooses where the fit runs (the card by
default). `subsample < 1` draws each round's rows by Bernoulli weights
from the Threefry stream of `random_state`, as the JAX package does. The
boosted ensembles are the same `_EnsembleSpec`
as GBT's, so the models subclass the same bases.
"""

from __future__ import annotations

from .ml._tree_models import (_Estimator, _TreeClassificationModel,
                              _TreeRegressionModel)

_XGB_PARAMS = dict(featuresCol="features", labelCol="label",
                   predictionCol="prediction", n_estimators=100,
                   learning_rate=0.3, max_depth=6, max_bins=256,
                   reg_lambda=1.0, gamma=0.0, subsample=1.0,
                   min_child_weight=1.0, random_state=0,
                   missing=float("nan"), num_workers=None, use_gpu=False,
                   device=None, tree_method="hist")


class XgboostRegressorModel(_TreeRegressionModel):
    pass


class XgboostClassifierModel(_TreeClassificationModel):
    pass


class _XgboostBase(_Estimator):
    _loss = "squared"

    def _fit_args(self, n_features: int) -> dict:
        g = self.getOrDefault
        return dict(max_depth=int(g("max_depth")), max_bins=int(g("max_bins")),
                    min_instances=int(g("min_child_weight")),
                    min_info_gain=0.0, n_trees=int(g("n_estimators")),
                    feature_k=None, bootstrap=False,
                    subsample=float(g("subsample")),
                    seed=int(g("random_state")), loss=self._loss,
                    step_size=float(g("learning_rate")),
                    reg_lambda=float(g("reg_lambda")),
                    gamma=float(g("gamma")), boosting=True,
                    missing=float(g("missing")))


class XgboostRegressor(_XgboostBase):
    _defaults = dict(_XGB_PARAMS)
    _model_cls = XgboostRegressorModel


class XgboostClassifier(_XgboostBase):
    _defaults = dict(_XGB_PARAMS, rawPredictionCol="rawPrediction",
                     probabilityCol="probability")
    _model_cls = XgboostClassifierModel
    _loss = "logistic"
