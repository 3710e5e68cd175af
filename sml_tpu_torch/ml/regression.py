"""Regression estimators, where the course imports them from
(`sml_tpu/ml/regression.py`).

`LinearRegression` (`SML/ML 02 - Linear Regression I.py:84-123`) fits
through the Gram pass of `linear_impl` on the session's device (from
the compact block when the pipeline's fused fit hands one over:
`linear_impl.fit_linear_compact`), and exposes `coefficients`,
`intercept` and a training `summary` (rmse/r2 from the same Gram
moments; the MAE, which needs a residual pass, only when read). The
tree learners come from `_tree_models`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..frame.column import block_len
from . import linear_impl
from ._staging import extract_compact, extract_xy, features_of
from ._tree_models import (DecisionTreeRegressionModel, DecisionTreeRegressor,
                           GBTRegressionModel, GBTRegressor,
                           RandomForestRegressionModel, RandomForestRegressor)
from .base import Estimator, Model, load_arrays, save_arrays
from .linalg import DenseVector

__all__ = ["DecisionTreeRegressionModel", "DecisionTreeRegressor",
           "GBTRegressionModel", "GBTRegressor", "LinearRegression",
           "LinearRegressionModel", "LinearRegressionSummary",
           "RandomForestRegressionModel", "RandomForestRegressor"]


class _PredictorParams:
    """Shared param declarations for supervised estimators/models."""

    def _declare_predictor_params(self):
        self._declareParam("featuresCol", default="features",
                           doc="features column")
        self._declareParam("labelCol", default="label", doc="label column")
        self._declareParam("predictionCol", default="prediction",
                           doc="prediction column")


class LinearRegressionSummary:
    def __init__(self, rmse: float, r2: float, mae: float,
                 explainedVariance: float, numInstances: int,
                 objectiveHistory=None, mae_fn=None):
        self.rootMeanSquaredError = rmse
        self.r2 = r2
        self._mae = mae
        self._mae_fn = mae_fn  # lazy: MAE needs a residual pass, rmse/r2 don't
        self.meanSquaredError = rmse ** 2
        self.explainedVariance = explainedVariance
        self.numInstances = numInstances
        self.objectiveHistory = objectiveHistory or []

    @property
    def meanAbsoluteError(self) -> float:
        if self._mae is None and self._mae_fn is not None:
            self._mae = self._mae_fn()
            self._mae_fn = None
        return self._mae


class LinearRegression(Estimator, _PredictorParams):
    """Least squares with an optional elastic-net penalty. `solver` and
    `weightCol` are declared and ignored, as in the JAX package."""

    def _init_params(self):
        self._declare_predictor_params()
        self._declareParam("regParam", default=0.0,
                           doc="regularization strength")
        self._declareParam("elasticNetParam", default=0.0,
                           doc="L1 mixing in [0,1]")
        self._declareParam("maxIter", default=100, doc="max iterations")
        self._declareParam("tol", default=1e-6, doc="convergence tolerance")
        self._declareParam("fitIntercept", default=True, doc="fit intercept")
        self._declareParam("standardization", default=True,
                           doc="standardize before penalty")
        self._declareParam("solver", default="auto", doc="auto|normal|l-bfgs")
        self._declareParam("weightCol", doc="instance weight column")

    def __init__(self, featuresCol=None, labelCol=None, predictionCol=None,
                 regParam=None, elasticNetParam=None, maxIter=None, tol=None,
                 fitIntercept=None, standardization=None, solver=None,
                 weightCol=None):
        super().__init__()
        self._set(featuresCol=featuresCol, labelCol=labelCol,
                  predictionCol=predictionCol, regParam=regParam,
                  elasticNetParam=elasticNetParam, maxIter=maxIter, tol=tol,
                  fitIntercept=fitIntercept, standardization=standardization,
                  solver=solver, weightCol=weightCol)

    def setLabelCol(self, v):
        return self._set(labelCol=v)

    def setFeaturesCol(self, v):
        return self._set(featuresCol=v)

    def _fit(self, df) -> "LinearRegressionModel":
        from ..device import session_device
        device = session_device()
        kw = dict(
            regParam=float(self.getOrDefault("regParam")),
            elasticNetParam=float(self.getOrDefault("elasticNetParam")),
            fitIntercept=bool(self.getOrDefault("fitIntercept")),
            standardization=bool(self.getOrDefault("standardization")),
            maxIter=int(self.getOrDefault("maxIter")),
            tol=float(self.getOrDefault("tol")))
        compact = extract_compact(df, self.getOrDefault("featuresCol"),
                                  self.getOrDefault("labelCol"))
        if compact is not None:
            # the pipeline's compact block: the one-hot slots expand on
            # the device, and the (n, d) matrix never exists on the host
            parts, y = compact
            res = linear_impl.fit_linear_compact(parts, y, device=device,
                                                 **kw)
        else:
            X, y, _ = extract_xy(df, self.getOrDefault("featuresCol"),
                                 self.getOrDefault("labelCol"))
            ok = np.isfinite(y)
            X, y = X[ok], y[ok]
            res = linear_impl.fit_linear(X, y, device=device, **kw)
        model = LinearRegressionModel(coefficients=res.coefficients,
                                      intercept=res.intercept)
        model._inherit_params(self)
        # rmse/r2/explained variance come from the fit's own Gram pass
        # (linear_impl._fit_stats); the MAE is computed only if read
        st = res.stats or {}
        n_f = st.get("n", len(y))
        mse = st.get("sse", 0.0) / n_f if n_f else 0.0
        var_y = st.get("var_y", 0.0)

        def lazy_mae(y=y, w=res.coefficients, b=res.intercept):
            if compact is not None:
                pred = compact[0].predict_affine(w, b)
            else:
                pred = linear_impl.predict_linear(X, w, b, device)
            return float(np.mean(np.abs(y - pred)))

        model._summary = LinearRegressionSummary(
            rmse=float(np.sqrt(mse)), r2=1 - mse / var_y if var_y else 0.0,
            mae=None, mae_fn=lazy_mae,
            explainedVariance=st.get("var_pred", 0.0), numInstances=int(n_f))
        return model


class LinearRegressionModel(Model, _PredictorParams):
    def _init_params(self):
        LinearRegression._init_params(self)

    def __init__(self, coefficients=None, intercept: float = 0.0):
        super().__init__()
        self._coefficients = np.asarray(coefficients, dtype=np.float64) \
            if coefficients is not None else None
        self._intercept = float(intercept)
        self._summary: Optional[LinearRegressionSummary] = None

    @property
    def coefficients(self) -> DenseVector:
        return DenseVector(self._coefficients)

    @property
    def intercept(self) -> float:
        return self._intercept

    @property
    def summary(self) -> LinearRegressionSummary:
        return self._summary

    @property
    def numFeatures(self) -> int:
        return int(self._coefficients.shape[0])

    def evaluate(self, df) -> LinearRegressionSummary:
        """The summary of `df`, scored on the session's device."""
        from ..device import session_device
        X, y, _ = extract_xy(df, self.getOrDefault("featuresCol"),
                             self.getOrDefault("labelCol"))
        pred = linear_impl.predict_linear(X, self._coefficients,
                                          self._intercept, session_device())
        resid = y - pred
        var_y = float(np.var(y))
        mse = float(np.mean(resid ** 2))
        return LinearRegressionSummary(
            rmse=float(np.sqrt(mse)), r2=1 - mse / var_y if var_y else 0.0,
            mae=float(np.mean(np.abs(resid))),
            explainedVariance=float(np.var(pred)), numInstances=len(y))

    def _transform(self, df):
        from ..device import session_device
        device = session_device()
        fc = self.getOrDefault("featuresCol")
        oc = self.getOrDefault("predictionCol")
        w, b = self._coefficients, self._intercept

        def fn(block, ctx):
            out = dict(block)
            out[oc] = linear_impl.predict_linear(
                features_of(block, fc), w, b, device) \
                if block_len(block) else np.zeros(0)
            return out

        return df._derive_rowlocal(fn, op="predict")

    def _save_state(self, path):
        save_arrays(path, coefficients=self._coefficients,
                    intercept=np.asarray([self._intercept]))

    def _load_state(self, path, meta):
        d = load_arrays(path)
        self._coefficients = d["coefficients"]
        self._intercept = float(d["intercept"][0])
        self._summary = None
