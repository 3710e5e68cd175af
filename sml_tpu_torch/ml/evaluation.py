"""Evaluators: rmse/r2/mae, AUROC/AUPR, accuracy/f1, silhouette.

The port's copy of `sml_tpu/ml/evaluation.py`. `RegressionEvaluator`
first asks a lazy model-transform frame's pushdown hook (`_fused_eval`)
for the five regression sufficient statistics (n, Σd², Σ|d|, Σl, Σl²):
for a tree model that is one fused traversal and reduction on the device
(`_tree_models.fused_reg_stats_from_matrix`), and the prediction column
is never materialized. Otherwise a materialized prediction column is
reduced on the route the dispatcher picks (`dispatch.decide`): the host
route sums in float64 numpy (`_reg_stats_host`), the device route in
float64 torch reductions on the session's device (`_reg_stats_device`),
each over the f32-rounded values, so the two agree to the last few
bits. Accuracy counts the same way. Ranking metrics sort on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import dispatch
from ..parallel.dispatch import WorkHint
from .base import Evaluator


def _reg_stats_host(pred: np.ndarray, lab: np.ndarray):
    """The five regression sufficient statistics (n, Σd², Σ|d|, Σl, Σl²)
    of finite-filtered values, in float64 numpy over the f32-rounded
    values."""
    p = pred.astype(np.float32).astype(np.float64)
    l64 = lab.astype(np.float32).astype(np.float64)
    d = p - l64
    return (float(len(p)), float(np.sum(d * d)), float(np.sum(np.abs(d))),
            float(np.sum(l64)), float(np.sum(l64 * l64)))


def _reg_stats_device(pred: np.ndarray, lab: np.ndarray, device):
    """`_reg_stats_host`'s statistics as float64 torch reductions on
    `device`."""
    p = torch.from_numpy(pred.astype(np.float32)).to(device).double()
    l64 = torch.from_numpy(lab.astype(np.float32)).to(device).double()
    d = p - l64
    stats = torch.stack([torch.sum(d * d), torch.sum(torch.abs(d)),
                         torch.sum(l64), torch.sum(l64 * l64)]).cpu()
    return (float(len(pred)),) + tuple(float(v) for v in stats)


def reg_stats(pred: np.ndarray, lab: np.ndarray, device):
    """The five regression statistics of finite-filtered values on the
    route the dispatcher picks for them on `device`: the evaluator's, and
    the linear pushdown's (`base._ScorerEvalHook`), so the two agree bit
    for bit."""
    hint = WorkHint(flops=10.0 * len(pred), kind="blas")
    if dispatch.decide(hint, device) == "host":
        return _reg_stats_host(pred, lab)
    return _reg_stats_device(pred, lab, device)


def _accuracy(pred: np.ndarray, lab: np.ndarray, device) -> float:
    """The fraction of equal f32-rounded prediction and label, counted
    on the route the dispatcher picks."""
    n = len(pred)
    if not n:
        return float("nan")
    hint = WorkHint(flops=4.0 * n, kind="blas")
    if dispatch.decide(hint, device) == "host":
        hits = int(np.sum(pred.astype(np.float32) == lab.astype(np.float32)))
    else:
        hits = int((torch.from_numpy(pred.astype(np.float32)).to(device)
                    == torch.from_numpy(lab.astype(np.float32)).to(device))
                   .sum().item())
    return hits / n


def host_reg_stats(pred: np.ndarray, lab: np.ndarray):
    """The five regression sufficient statistics in host numpy, f32
    accumulation to match the device programs. Rows where either value
    is non-finite are left out."""
    ok = np.isfinite(pred) & np.isfinite(lab)
    p32 = pred[ok].astype(np.float32)
    l32 = lab[ok].astype(np.float32)
    d = p32 - l32
    return (float(len(p32)), float(np.dot(d, d)),
            float(np.sum(np.abs(d))), float(np.sum(l32)),
            float(np.dot(l32, l32)))


def _reg_metric(metric: str, n: float, se: float, ae: float,
                sl: float, sl2: float) -> float:
    if n == 0:
        return float("nan")
    mse = se / n
    if metric == "rmse":
        return float(np.sqrt(mse))
    if metric == "mse":
        return mse
    if metric == "mae":
        return ae / n
    if metric in ("r2", "var"):
        var = sl2 / n - (sl / n) ** 2
        if metric == "var":
            return var
        return 1.0 - mse / var if var > 0 else 0.0
    raise ValueError(f"unknown metricName {metric!r}")


def _pred_label(df, predictionCol: str, labelCol: str):
    whole = df._whole()
    pred = np.asarray(whole[predictionCol], dtype=np.float64)
    lab = np.asarray(whole[labelCol], dtype=np.float64)
    ok = np.isfinite(pred) & np.isfinite(lab)
    return pred[ok], lab[ok]


class RegressionEvaluator(Evaluator):
    def _init_params(self):
        self._declareParam("predictionCol", default="prediction",
                           doc="prediction column")
        self._declareParam("labelCol", default="label", doc="label column")
        self._declareParam("metricName", default="rmse",
                           doc="rmse|mse|mae|r2|var")

    def __init__(self, predictionCol=None, labelCol=None, metricName=None):
        super().__init__()
        self._set(predictionCol=predictionCol, labelCol=labelCol,
                  metricName=metricName)

    def setMetricName(self, v):
        return self._set(metricName=v)

    def getMetricName(self):
        return self.getOrDefault("metricName")

    def isLargerBetter(self) -> bool:
        return self.getOrDefault("metricName") in ("r2", "var")

    def _evaluate(self, df) -> float:
        metric = self.getOrDefault("metricName")
        # evaluator pushdown: an unmaterialized model-transform frame
        # carries a hook that computes the five statistics without the
        # prediction column (Spark's analogue: Catalyst collapsing the
        # predict+agg plan; here the lazy frame is the plan)
        hook = getattr(df, "_fused_eval", None)
        if hook is not None and df._parts is None:
            stats = hook.reg_stats(self.getOrDefault("predictionCol"),
                                   self.getOrDefault("labelCol"))
            if stats is not None:
                return _reg_metric(metric, *stats)
        pred, lab = _pred_label(df, self.getOrDefault("predictionCol"),
                                self.getOrDefault("labelCol"))
        from ..device import session_device
        return _reg_metric(metric, *reg_stats(pred, lab, session_device()))


class BinaryClassificationEvaluator(Evaluator):
    def _init_params(self):
        self._declareParam("rawPredictionCol", default="rawPrediction",
                           doc="score column")
        self._declareParam("labelCol", default="label", doc="label column")
        self._declareParam("metricName", default="areaUnderROC",
                           doc="areaUnderROC|areaUnderPR")

    def __init__(self, rawPredictionCol=None, labelCol=None, metricName=None):
        super().__init__()
        self._set(rawPredictionCol=rawPredictionCol, labelCol=labelCol,
                  metricName=metricName)

    def setMetricName(self, v):
        return self._set(metricName=v)

    def _scores(self, df):
        whole = df._whole()
        col = self.getOrDefault("rawPredictionCol")
        if col not in whole:
            for alt in ("probability", "prediction"):
                if alt in whole:
                    col = alt
                    break
        vals = whole[col]
        if vals.ndim == 2:
            score = vals[:, -1].astype(np.float64)
        elif len(vals) and hasattr(vals[0], "toArray"):
            score = np.asarray([v.toArray()[-1] for v in vals],
                               dtype=np.float64)
        else:
            score = np.asarray(vals, dtype=np.float64)
        lab = np.asarray(whole[self.getOrDefault("labelCol")],
                         dtype=np.float64)
        ok = np.isfinite(score) & np.isfinite(lab)
        return score[ok], lab[ok]

    def _evaluate(self, df) -> float:
        score, lab = self._scores(df)
        metric = self.getOrDefault("metricName")
        order = np.argsort(-score, kind="mergesort")
        lab = lab[order]
        score = score[order]
        tp = np.cumsum(lab)
        fp = np.cumsum(1 - lab)
        # collapse ties: keep the last index of each distinct score
        distinct = np.nonzero(np.diff(score))[0]
        idx = np.concatenate([distinct, [len(score) - 1]])
        tp, fp = tp[idx], fp[idx]
        P, N = tp[-1], fp[-1]
        if P == 0 or (metric == "areaUnderROC" and N == 0):
            return float("nan")
        if metric == "areaUnderROC":
            tpr = np.concatenate([[0.0], tp / P])
            fpr = np.concatenate([[0.0], fp / N])
            return float(np.trapezoid(tpr, fpr))
        precision = tp / (tp + fp)
        recall = np.concatenate([[0.0], tp / P])
        precision = np.concatenate([[precision[0]], precision])
        return float(np.trapezoid(precision, recall))


class MulticlassClassificationEvaluator(Evaluator):
    def _init_params(self):
        self._declareParam("predictionCol", default="prediction",
                           doc="prediction column")
        self._declareParam("labelCol", default="label", doc="label column")
        self._declareParam("metricName", default="f1",
                           doc="f1|accuracy|weightedPrecision|"
                               "weightedRecall")

    def __init__(self, predictionCol=None, labelCol=None, metricName=None):
        super().__init__()
        self._set(predictionCol=predictionCol, labelCol=labelCol,
                  metricName=metricName)

    def setMetricName(self, v):
        return self._set(metricName=v)

    def _evaluate(self, df) -> float:
        pred, lab = _pred_label(df, self.getOrDefault("predictionCol"),
                                self.getOrDefault("labelCol"))
        metric = self.getOrDefault("metricName")
        if metric == "accuracy":
            from ..device import session_device
            return _accuracy(pred, lab, session_device())
        stats = []
        for k in np.unique(np.concatenate([pred, lab])):
            tp = np.sum((pred == k) & (lab == k))
            fp = np.sum((pred == k) & (lab != k))
            fn = np.sum((pred != k) & (lab == k))
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            stats.append((np.sum(lab == k), prec, rec, f1))
        support = np.array([s[0] for s in stats], dtype=np.float64)
        w = support / support.sum()
        col = {"weightedPrecision": 1, "weightedRecall": 2, "f1": 3}.get(
            metric)
        if col is None:
            raise ValueError(f"unknown metricName {metric!r}")
        return float(np.sum(w * [s[col] for s in stats]))


class ClusteringEvaluator(Evaluator):
    """Silhouette (squared euclidean), the MLlib default."""

    def _init_params(self):
        self._declareParam("predictionCol", default="prediction",
                           doc="cluster column")
        self._declareParam("featuresCol", default="features",
                           doc="features column")
        self._declareParam("metricName", default="silhouette",
                           doc="silhouette")

    def __init__(self, predictionCol=None, featuresCol=None, metricName=None):
        super().__init__()
        self._set(predictionCol=predictionCol, featuresCol=featuresCol,
                  metricName=metricName)

    def _evaluate(self, df) -> float:
        from ._staging import extract_features
        X = extract_features(df, self.getOrDefault("featuresCol"))
        labels = np.asarray(df._whole()[self.getOrDefault("predictionCol")],
                            dtype=int)
        ks = np.unique(labels)
        if len(ks) < 2:
            return float("nan")
        # the simplified silhouette through cluster means (squared
        # distances), the O(n*k) formulation MLlib uses
        centers = np.stack([X[labels == k].mean(axis=0) for k in ks])
        counts = np.array([(labels == k).sum() for k in ks],
                          dtype=np.float64)
        d2 = ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        own = np.searchsorted(ks, labels)
        a = d2[np.arange(len(X)), own]
        d2_other = d2.copy()
        d2_other[np.arange(len(X)), own] = np.inf
        b = d2_other.min(axis=1)
        s = (b - a) / np.maximum(a, b)
        s[counts[own] == 1] = 0.0
        return float(np.mean(s))
