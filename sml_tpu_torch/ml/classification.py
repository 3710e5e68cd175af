"""Classification estimators, where the course imports them from
(`sml_tpu/ml/classification.py`).

`LogisticRegression` (`SML/Solutions/ML Electives/MLE 03` answer path)
fits by IRLS Newton steps on the session's device
(`linear_impl.fit_logistic`); `transform` appends the `rawPrediction`
and `probability` vector columns (2-D blocks) and the `prediction`
column, as MLlib does. The tree learners come from `_tree_models`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..frame.column import block_len
from . import linear_impl
from ._staging import extract_xy, features_of
from ._tree_models import (DecisionTreeClassificationModel,
                           DecisionTreeClassifier, GBTClassificationModel,
                           GBTClassifier, RandomForestClassificationModel,
                           RandomForestClassifier)
from .base import Estimator, Model, load_arrays, save_arrays
from .linalg import DenseVector

__all__ = ["BinaryLogisticRegressionSummary",
           "DecisionTreeClassificationModel", "DecisionTreeClassifier",
           "GBTClassificationModel", "GBTClassifier", "LogisticRegression",
           "LogisticRegressionModel", "RandomForestClassificationModel",
           "RandomForestClassifier"]


class BinaryLogisticRegressionSummary:
    """Training summary: the accuracy and the area under the ROC curve
    of the training rows' margins, and the IRLS iterations the fit ran
    (MLlib's `totalIterations`)."""

    def __init__(self, accuracy: float = None, areaUnderROC: float = None,
                 numInstances: int = 0, totalIterations: int = 0):
        self.accuracy = accuracy
        self.areaUnderROC = areaUnderROC
        self.numInstances = numInstances
        self.totalIterations = totalIterations


class LogisticRegression(Estimator):
    def _init_params(self):
        self._declareParam("featuresCol", default="features",
                           doc="features column")
        self._declareParam("labelCol", default="label", doc="label column")
        self._declareParam("predictionCol", default="prediction",
                           doc="prediction column")
        self._declareParam("rawPredictionCol", default="rawPrediction",
                           doc="margin column")
        self._declareParam("probabilityCol", default="probability",
                           doc="probability column")
        self._declareParam("regParam", default=0.0,
                           doc="regularization strength")
        self._declareParam("elasticNetParam", default=0.0,
                           doc="L1 mixing in [0,1]")
        self._declareParam("maxIter", default=100, doc="max iterations")
        self._declareParam("tol", default=1e-6, doc="convergence tolerance")
        self._declareParam("fitIntercept", default=True, doc="fit intercept")
        self._declareParam("threshold", default=0.5, doc="decision threshold")

    def __init__(self, featuresCol=None, labelCol=None, predictionCol=None,
                 regParam=None, elasticNetParam=None, maxIter=None, tol=None,
                 fitIntercept=None, threshold=None):
        super().__init__()
        self._set(featuresCol=featuresCol, labelCol=labelCol,
                  predictionCol=predictionCol, regParam=regParam,
                  elasticNetParam=elasticNetParam, maxIter=maxIter, tol=tol,
                  fitIntercept=fitIntercept, threshold=threshold)

    def setLabelCol(self, v):
        return self._set(labelCol=v)

    def setFeaturesCol(self, v):
        return self._set(featuresCol=v)

    def _fit(self, df) -> "LogisticRegressionModel":
        from ..device import session_device
        device = session_device()
        X, y, _ = extract_xy(df, self.getOrDefault("featuresCol"),
                             self.getOrDefault("labelCol"))
        ok = np.isfinite(y)
        X, y = X[ok], y[ok]
        res = linear_impl.fit_logistic(
            X, y, regParam=float(self.getOrDefault("regParam")),
            elasticNetParam=float(self.getOrDefault("elasticNetParam")),
            fitIntercept=bool(self.getOrDefault("fitIntercept")),
            maxIter=int(self.getOrDefault("maxIter")),
            tol=float(self.getOrDefault("tol")), device=device)
        model = LogisticRegressionModel(coefficients=res.coefficients,
                                        intercept=res.intercept)
        model._inherit_params(self)
        margin = X @ res.coefficients + res.intercept
        pred = (margin > 0).astype(float)
        model._summary = BinaryLogisticRegressionSummary(
            accuracy=float(np.mean(pred == y)),
            areaUnderROC=_fast_auc(margin, y), numInstances=len(y),
            totalIterations=res.iterations)
        return model


def _fast_auc(score: np.ndarray, label: np.ndarray) -> float:
    order = np.argsort(score)
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    pos = label > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


class LogisticRegressionModel(Model):
    def _init_params(self):
        LogisticRegression._init_params(self)

    def __init__(self, coefficients=None, intercept: float = 0.0):
        super().__init__()
        self._coefficients = np.asarray(coefficients, dtype=np.float64) \
            if coefficients is not None else None
        self._intercept = float(intercept)
        self._summary: Optional[BinaryLogisticRegressionSummary] = None

    @property
    def coefficients(self) -> DenseVector:
        return DenseVector(self._coefficients)

    @property
    def intercept(self) -> float:
        return self._intercept

    @property
    def summary(self):
        return self._summary

    @property
    def numClasses(self) -> int:
        return 2

    def _transform(self, df):
        from ..device import session_device
        device = session_device()
        fc = self.getOrDefault("featuresCol")
        pc = self.getOrDefault("predictionCol")
        rc = self.getOrDefault("rawPredictionCol")
        prc = self.getOrDefault("probabilityCol")
        thr = float(self.getOrDefault("threshold"))
        w, b = self._coefficients, self._intercept

        def fn(block, ctx):
            out = dict(block)
            margin = linear_impl.predict_linear(
                features_of(block, fc), w, b, device) \
                if block_len(block) else np.zeros(0)
            p1 = 1.0 / (1.0 + np.exp(-margin))
            out[rc] = np.stack([-margin, margin], axis=1)
            out[prc] = np.stack([1 - p1, p1], axis=1)
            out[pc] = (p1 > thr).astype(float)
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
