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

The device route, and the fused predict+eval, reduce in an order that
does not depend on the layout of the rows (`block_partials`,
`reduce_blocks`): the rows fall in fixed blocks of `EVAL_BLOCK_ROWS`,
each block's statistics are summed in a fixed order (float64, two
sequential scans), and the block sums are added in block order. Over a
mesh of ranks (`dispatch.mesh_for`; every rank evaluates the same rows)
each rank takes whole blocks (`eval_blocks`: `mesh.host_partition` over
blocks), sums only those, and one all-reduce of the (blocks, s)
partials, zero outside each rank's own blocks, carries them to every
rank. Adding zeros is exact, so 1, 2 or 4 ranks give the one-device
bits. Only the block partials cross the ranks, never a row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import dispatch
from ..parallel.dispatch import WorkHint
from ._staging import device_get
from .base import Evaluator

#: rows of one block of the ordered reduction: _SCAN x _SCAN rows, each
#: block summed by two sequential scans of _SCAN adds
_SCAN = 64
EVAL_BLOCK_ROWS = _SCAN * _SCAN


def eval_blocks(n_rows: int, mesh=None):
    """(first block, blocks in all, rows) of this rank's share of
    `n_rows` rows in blocks of `EVAL_BLOCK_ROWS`: whole blocks, the
    remainder to the leading ranks (`mesh.host_partition` over blocks);
    every block outside a mesh."""
    total = -(-int(n_rows) // EVAL_BLOCK_ROWS)
    if mesh is None:
        return 0, total, slice(0, int(n_rows))
    from ..parallel.mesh import host_partition
    b0, b1 = host_partition(total, mesh.size)[mesh.rank]
    return b0, total, slice(min(b0 * EVAL_BLOCK_ROWS, int(n_rows)),
                            min(b1 * EVAL_BLOCK_ROWS, int(n_rows)))


def block_partials(cols: torch.Tensor) -> torch.Tensor:
    """(blocks, s) float64 sums of each `EVAL_BLOCK_ROWS`-row block of
    the (n, s) `cols`, the last block zero-padded. A block sums its runs
    of `_SCAN` rows, each in row order, and then the run sums in run
    order: a scan along a dim that is not the innermost runs each
    column's adds one after another, on the card as on the CPU, so a
    block's sum depends only on its rows."""
    n, s = cols.shape
    cols = cols.to(torch.float64)
    blocks = -(-n // EVAL_BLOCK_ROWS)
    pad = blocks * EVAL_BLOCK_ROWS - n
    if pad:
        cols = torch.cat([cols, cols.new_zeros((pad, s))])
    x = cols.reshape(blocks, _SCAN, _SCAN, s)
    inner = torch.cumsum(x, dim=2)[:, :, -1, :]
    return torch.cumsum(inner, dim=1)[:, -1, :]


def reduce_blocks(partials: torch.Tensor, first: int, total: int,
                  mesh=None) -> torch.Tensor:
    """The (s,) float64 sums of `total` blocks whose partials this rank
    holds from block `first` on (`eval_blocks`): over a mesh the
    (total, s) partials, zero outside this rank's blocks, are
    all-reduced (`tree_impl.mesh_merge`; one call, exact); then the
    blocks are added in block order."""
    s = partials.shape[1]
    if mesh is not None:
        from .tree_impl import mesh_merge
        full = partials.new_zeros((total, s))
        full[first:first + partials.shape[0]] = partials
        partials = mesh_merge(mesh)(full)
    if not total:
        return partials.new_zeros(s)
    return torch.cumsum(partials, dim=0)[-1]


def _reg_stats_host(pred: np.ndarray, lab: np.ndarray):
    """The five regression sufficient statistics (n, Σd², Σ|d|, Σl, Σl²)
    of finite-filtered values, in float64 numpy over the f32-rounded
    values."""
    p = pred.astype(np.float32).astype(np.float64)
    l64 = lab.astype(np.float32).astype(np.float64)
    d = p - l64
    return (float(len(p)), float(np.sum(d * d)), float(np.sum(np.abs(d))),
            float(np.sum(l64)), float(np.sum(l64 * l64)))


def _stage_block(a: np.ndarray, rows: slice, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a[rows], dtype=np.float32)).to(device).double()


def _reg_stats_device(pred: np.ndarray, lab: np.ndarray, device):
    """`_reg_stats_host`'s statistics as float64 torch reductions on
    `device`, in the ordered block reduction (over a mesh of ranks on
    `device`, each rank's blocks, merged); n comes from the
    reduction."""
    device = torch.device(device)
    mesh = dispatch.mesh_for(device)
    first, total, rows = eval_blocks(len(pred), mesh)
    p = _stage_block(pred, rows, device)
    l64 = _stage_block(lab, rows, device)
    d = p - l64
    cols = torch.stack([torch.ones_like(d), d * d, torch.abs(d), l64,
                        l64 * l64], dim=1)
    stats, = device_get(reduce_blocks(block_partials(cols), first, total,
                                      mesh))
    return tuple(float(v) for v in stats)


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
        device = torch.device(device)
        mesh = dispatch.mesh_for(device)
        first, total, rows = eval_blocks(n, mesh)
        eq = _stage_block(pred, rows, device) == \
            _stage_block(lab, rows, device)
        counts, = device_get(reduce_blocks(block_partials(eq[:, None]),
                                           first, total, mesh))
        hits = int(counts[0])
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
