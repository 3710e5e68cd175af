"""XGBoost-surface tree estimators and models (`sml_tpu/xgboost.py`).

`XgboostRegressor` and `XgboostClassifier` take the `sparkdl.xgboost`
params and fit through the same `_fit_ensemble` as GBT: boosted
second-order trees on the port's histogram kernels. `use_gpu`, `device`,
`num_workers` and `tree_method` are accepted for surface parity and not
read: `fit(df)` runs on the session's device (`sml.device`) and
`fit(X, y, device=...)` on the device it is given (the card by default).
`subsample < 1` draws each round's rows by Bernoulli weights from the
Threefry stream of `random_state`, as the JAX package does.
`rounds_per_dispatch` splits the rounds into segments, each counted as
one `tree.fit_dispatch` (the JAX package's staged scan); the trees do
not depend on it. The boosted
ensembles are the same `_EnsembleSpec` as GBT's, so the models subclass
the same bases.
"""

from __future__ import annotations

from .ml._tree_models import (_Estimator, _TreeClassificationModel,
                              _TreeRegressionModel)

#: name -> (default, doc), the JAX package's params
_XGB_PARAMS = {
    "featuresCol": ("features", "features column"),
    "labelCol": ("label", "label column"),
    "predictionCol": ("prediction", "prediction column"),
    "n_estimators": (100, "boosting rounds"),
    "learning_rate": (0.3, "eta"),
    "max_depth": (6, "tree depth"),
    "max_bins": (256, "histogram bins"),
    "reg_lambda": (1.0, "L2 on leaf weights"),
    "gamma": (0.0, "min split loss"),
    "subsample": (1.0, "row subsample per round"),
    "min_child_weight": (1.0, "min hessian per child"),
    "random_state": (0, "seed"),
    "missing": (float("nan"), "value treated as missing"),
    "num_workers": (None, "data shards (defaults to mesh size)"),
    "use_gpu": (False, "accepted for surface parity"),
    "device": (None, "compute engine"),
    "tree_method": ("hist", "histogram engine"),
    "rounds_per_dispatch": (None, "boosting rounds a segment of the fit "
                                  "(None = sml.tree.roundsPerDispatch "
                                  "conf; 0 = the whole ensemble as one)"),
}
_XGB_CLASSIFIER_PARAMS = dict(_XGB_PARAMS, **{
    "rawPredictionCol": ("rawPrediction", "raw scores"),
    "probabilityCol": ("probability", "probabilities"),
})


class XgboostRegressorModel(_TreeRegressionModel):
    _params = _XGB_PARAMS


class XgboostClassifierModel(_TreeClassificationModel):
    _params = _XGB_CLASSIFIER_PARAMS


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
                    missing=float(g("missing")),
                    rounds_per_dispatch=(
                        None if g("rounds_per_dispatch") is None
                        else int(g("rounds_per_dispatch"))))


class XgboostRegressor(_XgboostBase):
    _params = _XGB_PARAMS
    _model_cls = XgboostRegressorModel


class XgboostClassifier(_XgboostBase):
    _params = _XGB_CLASSIFIER_PARAMS
    _model_cls = XgboostClassifierModel
    _loss = "logistic"
