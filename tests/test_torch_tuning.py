"""Tuning's host half in the port (`sml_tpu_torch/ml/tuning.py`:
ParamGridBuilder, CrossValidator, TrainValidationSplit, and the choice
between fused fits and placed trials) against the JAX package's live
one, on the CPU, on 3,000-row frames with labels that are multiples of
1/8 (every histogram sum is exact in f32, so split tables are exact).

The JAX package runs with `sml.tree.kernel=xla` and
`sml.cv.trialAxisDevices=1` at parallelism 1 (its placed trials on
submeshes draw other bootstrap streams); the port with
`sml.device=cpu`, so its kernels' plain versions run.

- Grids (`baseOn` included) are the JAX package's, point for point.
- CrossValidator's `avgMetrics` agree with the JAX package's to rtol
  1e-6 (the port's histogram sums are float64, the JAX package's f32),
  for a DT and an RF on an assembled frame and for the pipeline inside
  the CV; the best model's split tables are the JAX package's.
- Within the port, the fused grid equals placed trials, and parallelism
  1 equals 4, bit for bit; TrainValidationSplit likewise.
- The CV inside the pipeline fits and predicts as the JAX package's.
- Which way a grid runs is decided from its shapes: a grid that sets a
  param outside the fused set, a GBT, or `sml.cv.batchFolds=false` take
  placed trials.
- A CrossValidatorModel saved by either package loads in both.
- Trials share frames across threads: under a short switch interval and
  more workers than cores, a shared lazy frame is computed once, every
  trial's result comes back in job order and every placement is logged.
"""

import numpy as np
import pytest

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.device import run_placed_trials
from sml_tpu_torch.frame.dataframe import DataFrame
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.ml import tuning as ptun
from sml_tpu_torch.ml.classification import DecisionTreeClassifier

N = 3000
NUM = ["f0", "f1", "f2", "f3"]


def _cols(n=N, seed=0):
    rng = np.random.default_rng(seed)
    cols = {c: rng.normal(size=n) for c in NUM}
    cols["f2"][::23] = np.nan
    cols["kind"] = rng.choice(["a", "b", "c", "d"], n).astype(object)
    cols["kind"][::41] = None
    bump = {"a": 0.0, "b": 1.0, "c": -0.5, "d": 2.0}
    y = 2 * cols["f0"] - cols["f1"] ** 2 + (cols["f3"] > 0) * 1.5 \
        + np.array([bump.get(k, 0.0) for k in cols["kind"]]) \
        + rng.normal(0, 0.3, n)
    cols["label"] = np.round(y * 8) / 8
    return cols


@pytest.fixture()
def confs(spark):
    """The JAX fits on the XLA path with the element axis replicated;
    the port on the CPU; every key restored after each test."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    keys = ("sml.tree.kernel", "sml.cv.trialAxisDevices")
    prev = {k: JCONF.get(k) for k in keys}
    JCONF.set("sml.tree.kernel", "xla")
    JCONF.set("sml.cv.trialAxisDevices", 1)
    PCONF.set("sml.device", "cpu")
    yield JCONF
    for k, v in prev.items():
        JCONF.set(k, v)
    PCONF.unset("sml.device")
    PCONF.unset("sml.cv.batchFolds")


def _prep(feat):
    return [feat.StringIndexer(inputCols=["kind"], outputCols=["kind_idx"],
                               handleInvalid="keep"),
            feat.Imputer(strategy="median", inputCols=["f2"],
                         outputCols=["f2_imp"]),
            feat.VectorAssembler(inputCols=["kind_idx", "f0", "f1", "f2_imp",
                                            "f3"], outputCol="features")]


class _Pkg:
    """One package's classes, side by side."""

    def __init__(self, jax: bool):
        if jax:
            from sml_tpu.ml import base, evaluation, feature, regression
            from sml_tpu.ml import tuning
        else:
            base, feature, regression, tuning = pbase, pfeat, preg, ptun
            from sml_tpu_torch.ml import evaluation
        self.base, self.feat, self.reg, self.tun = (base, feature,
                                                    regression, tuning)
        self.ev = evaluation.RegressionEvaluator(labelCol="label")


def _frames(spark, jax: bool):
    """The package's raw frame and its assembled frame (prep fitted on
    the raw frame), both cached."""
    pkg = _Pkg(jax)
    if jax:
        import pandas as pd
        df = spark.createDataFrame(pd.DataFrame(_cols()))
    else:
        df = get_session().createDataFrame(_cols())
    df.cache()
    feat = pkg.base.Pipeline(stages=_prep(pkg.feat)).fit(df).transform(df)
    feat.cache()
    return pkg, df, feat


def _grid(pkg, est, kind):
    g = pkg.tun.ParamGridBuilder().addGrid(est.getParam("maxDepth"), [2, 4])
    if kind == "rf":
        g = g.addGrid(est.getParam("numTrees"), [3, 6])
    else:
        g = g.addGrid(est.getParam("minInstancesPerNode"), [1, 20])
    return g.baseOn({est.getParam("maxBins"): 16}).build()


def _est(pkg, kind, label="label"):
    if kind == "rf":
        return pkg.reg.RandomForestRegressor(labelCol=label, seed=7)
    return pkg.reg.DecisionTreeRegressor(labelCol=label)


def _cv(pkg, est, grid, par=1):
    return pkg.tun.CrossValidator(estimator=est, estimatorParamMaps=grid,
                                  evaluator=pkg.ev, numFolds=3,
                                  parallelism=par, seed=11)


def _named(grid):
    return [{p.name: v for p, v in pm.items()} for pm in grid]


@pytest.mark.parametrize("kind", ["dt", "rf"])
def test_param_grid_equals_jax(kind):
    from sml_tpu.ml import regression as jreg
    from sml_tpu.ml.tuning import ParamGridBuilder as JGrid
    pkg_p = _Pkg(False)
    jest = jreg.RandomForestRegressor() if kind == "rf" \
        else jreg.DecisionTreeRegressor()
    pest = _est(pkg_p, kind)
    jg = (JGrid().addGrid(jest.getParam("maxDepth"), [2, 4, 6])
          .addGrid(jest.getParam("maxBins"), [16, 32])
          .baseOn({jest.getParam("seed"): 3},
                  (jest.getParam("minInfoGain"), 0.0)).build())
    pg = (ptun.ParamGridBuilder().addGrid(pest.getParam("maxDepth"), [2, 4, 6])
          .addGrid(pest.getParam("maxBins"), [16, 32])
          .baseOn({pest.getParam("seed"): 3},
                  (pest.getParam("minInfoGain"), 0.0)).build())
    assert len(pg) == 6
    assert _named(pg) == _named(jg)
    assert ptun.ParamGridBuilder().build() == [{}]


def _tables_equal(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.split_bin, tb.split_bin)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["dt", "rf"])
def test_cv_avg_metrics_and_best_model_equal_jax(confs, spark, kind):
    jpkg, _, jfeat = _frames(spark, True)
    ppkg, _, pfeat_df = _frames(spark, False)
    jest, pest = _est(jpkg, kind), _est(ppkg, kind)
    jm = _cv(jpkg, jest, _grid(jpkg, jest, kind)).fit(jfeat)
    pm = _cv(ppkg, pest, _grid(ppkg, pest, kind)).fit(pfeat_df)
    np.testing.assert_allclose(pm.avgMetrics, jm.avgMetrics, rtol=1e-6)
    assert int(np.argmin(pm.avgMetrics)) == int(np.argmin(jm.avgMetrics))
    _tables_equal(pm.bestModel._spec, jm.bestModel._spec)


def test_pipeline_inside_cv_equals_jax(confs, spark):
    jpkg, jdf, _ = _frames(spark, True)
    ppkg, pdf, _ = _frames(spark, False)
    out = []
    for pkg, df in ((jpkg, jdf), (ppkg, pdf)):
        est = _est(pkg, "rf")
        pipe = pkg.base.Pipeline(stages=_prep(pkg.feat) + [est])
        out.append(_cv(pkg, pipe, _grid(pkg, est, "rf")).fit(df))
    jm, pm = out
    np.testing.assert_allclose(pm.avgMetrics, jm.avgMetrics, rtol=1e-6)
    _tables_equal(pm.bestModel.stages[-1]._spec, jm.bestModel.stages[-1]._spec)


def test_cv_inside_pipeline_equals_jax(confs, spark):
    preds = []
    for jax in (True, False):
        pkg, df, _ = _frames(spark, jax)
        train, test = df.randomSplit([0.8, 0.2], seed=42)
        est = _est(pkg, "dt")
        pipe = pkg.base.Pipeline(stages=_prep(pkg.feat)
                                 + [_cv(pkg, est, _grid(pkg, est, "dt"))])
        model = pipe.fit(train)
        assert type(model.stages[-1]).__name__ == "CrossValidatorModel"
        pred = model.transform(test)
        preds.append((model.stages[-1].avgMetrics, pkg.ev.evaluate(pred)))
    (jm, jr), (pm, pr) = preds
    np.testing.assert_allclose(pm, jm, rtol=1e-6)
    assert pr == pytest.approx(jr, rel=1e-6)


@pytest.mark.parametrize("kind", ["dt", "rf"])
def test_fused_equals_placed_and_parallelism_changes_nothing(confs, spark,
                                                             kind):
    pkg, _, feat = _frames(spark, False)
    est = _est(pkg, kind)
    grid = _grid(pkg, est, kind)
    assert ptun.fused_cv_applies(est, grid)
    fused = _cv(pkg, est, grid, 1).fit(feat)
    PCONF.set("sml.cv.batchFolds", False)
    assert not ptun.fused_cv_applies(est, grid)
    placed1 = _cv(pkg, est, grid, 1).fit(feat)
    placed4 = _cv(pkg, est, grid, 4).fit(feat)
    assert fused.avgMetrics == placed1.avgMetrics == placed4.avgMetrics
    for a, b in ((fused, placed1), (fused, placed4)):
        for ta, tb in zip(a.bestModel._spec.trees, b.bestModel._spec.trees):
            for f in ta._fields:
                np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))


def test_pipeline_inside_cv_parallelism_changes_nothing(confs, spark):
    pkg, df, _ = _frames(spark, False)
    est = _est(pkg, "rf")
    pipe = pkg.base.Pipeline(stages=_prep(pkg.feat) + [est])
    grid = _grid(pkg, est, "rf")
    assert not ptun.fused_cv_applies(pipe, grid)
    one = _cv(pkg, pipe, grid, 1).fit(df)
    four = _cv(pkg, pipe, grid, 4).fit(df)
    assert one.avgMetrics == four.avgMetrics


def test_train_validation_split(confs, spark):
    out = []
    for jax in (True, False):
        pkg, _, feat = _frames(spark, jax)
        est = _est(pkg, "rf")
        tvs = pkg.tun.TrainValidationSplit(
            estimator=est, estimatorParamMaps=_grid(pkg, est, "rf"),
            evaluator=pkg.ev, trainRatio=0.7, seed=5)
        out.append(tvs.fit(feat))
        if not jax:
            PCONF.set("sml.cv.batchFolds", False)
            placed = tvs.fit(feat)
            PCONF.unset("sml.cv.batchFolds")
            assert placed.validationMetrics == out[-1].validationMetrics
    jm, pm = out
    np.testing.assert_allclose(pm.validationMetrics, jm.validationMetrics,
                               rtol=1e-6)
    _tables_equal(pm.bestModel._spec, jm.bestModel._spec)


def test_fused_applicability_is_decided_from_shapes():
    PCONF.unset("sml.cv.batchFolds")
    rf = preg.RandomForestRegressor()
    dt = preg.DecisionTreeRegressor()
    gbt = preg.GBTRegressor()
    ok = [{rf.getParam(p): v} for p, v in (
        ("maxDepth", 3), ("maxBins", 16), ("numTrees", 4),
        ("featureSubsetStrategy", "sqrt"), ("subsamplingRate", 0.8),
        ("minInstancesPerNode", 2), ("minInfoGain", 0.1), ("seed", 1))]
    assert ptun.fused_cv_applies(rf, ok)
    assert ptun.fused_cv_applies(dt, [{dt.getParam("maxDepth"): 2}])
    # a param that reshapes the data: placed trials
    assert not ptun.fused_cv_applies(rf, ok + [{rf.getParam("labelCol"):
                                                "y"}])
    assert not ptun.fused_cv_applies(gbt, [{gbt.getParam("maxDepth"): 2}])
    assert not ptun.fused_cv_applies(
        pbase.Pipeline(stages=[rf]), [{rf.getParam("maxDepth"): 2}])
    assert not ptun.fused_cv_applies(DecisionTreeClassifier(), [{}])
    PCONF.set("sml.cv.batchFolds", "false")
    try:
        assert not ptun.fused_cv_applies(rf, ok)
    finally:
        PCONF.unset("sml.cv.batchFolds")


def test_gbt_grid_runs_placed_trials(confs, spark):
    pkg, _, feat = _frames(spark, False)
    gbt = pkg.reg.GBTRegressor(labelCol="label", maxIter=3, maxBins=16)
    grid = ptun.ParamGridBuilder().addGrid(gbt.getParam("maxDepth"),
                                           [2, 3]).build()
    assert not ptun.fused_cv_applies(gbt, grid)
    m = _cv(pkg, gbt, grid, 2).fit(feat)
    assert len(m.avgMetrics) == 2 and np.isfinite(m.avgMetrics).all()


def _preds(model, df):
    return np.asarray(model.transform(df).toPandas()["prediction"],
                      dtype=np.float64)


def test_cv_model_saved_by_either_package_loads_in_both(confs, spark,
                                                        tmp_path):
    from sml_tpu.ml.base import load_native as jload
    jpkg, _, jfeat = _frames(spark, True)
    ppkg, _, pfeat_df = _frames(spark, False)
    jest, pest = _est(jpkg, "dt"), _est(ppkg, "dt")
    jm = _cv(jpkg, jest, _grid(jpkg, jest, "dt")).fit(jfeat)
    pm = _cv(ppkg, pest, _grid(ppkg, pest, "dt")).fit(pfeat_df)
    want = _preds(pm, pfeat_df)
    pm.save(str(tmp_path / "port"))
    in_port = pbase.load(str(tmp_path / "port"))
    in_jax = jload(str(tmp_path / "port"))
    assert type(in_port) is ptun.CrossValidatorModel
    assert type(in_jax).__name__ == "CrossValidatorModel"
    assert in_port.avgMetrics == pm.avgMetrics
    assert in_jax.avgMetrics == pytest.approx(pm.avgMetrics, rel=0)
    assert in_port.getNumFolds() == 3 and in_port.getSeed() == 11
    np.testing.assert_array_equal(_preds(in_port, pfeat_df), want)
    np.testing.assert_allclose(_preds(in_jax, jfeat), want, rtol=1e-6)
    jm.save(str(tmp_path / "jax"))
    from_jax = pbase.load(str(tmp_path / "jax"))
    assert from_jax.avgMetrics == pytest.approx(jm.avgMetrics, rel=0)
    np.testing.assert_allclose(_preds(from_jax, pfeat_df),
                               _preds(jm, jfeat), rtol=1e-6)


def test_placed_trials_share_a_frame_under_threads():
    import os
    import sys
    import time
    computed = []

    def compute():
        computed.append(1)
        time.sleep(0.01)
        return [{"x": np.arange(5.0)}]

    df = DataFrame(compute)
    derived = df._derive(lambda b, ctx: {"y": b["x"] * 2}, op="double")
    jobs = list(range(96))
    workers = max(32, 4 * (os.cpu_count() or 1))
    PCONF.set("sml.device", "cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = run_placed_trials(
            jobs, lambda j: (j, float(derived._whole()["y"].sum())), workers)
    finally:
        sys.setswitchinterval(old)
        PCONF.unset("sml.device")
    assert computed == [1]
    assert out == [(j, 20.0) for j in jobs]


def _binary_frames(spark, jax: bool):
    """The assembled frame with a 0/1 label (the label above its median:
    MLE 03's priceClass, ML 07L's classifiers)."""
    pkg, df, feat = _frames(spark, jax)
    cut = float(np.median(_cols()["label"]))
    if jax:
        from sml_tpu import functions as F
    else:
        from sml_tpu_torch import functions as F
    lab = (F.col("label") > cut).cast("double")
    return pkg, df.withColumn("cls", lab).cache(), \
        feat.withColumn("cls", lab).cache()


def _classification(jax: bool):
    if jax:
        from sml_tpu.ml import classification, evaluation
    else:
        from sml_tpu_torch.ml import classification, evaluation
    return classification, evaluation


def test_cv_over_logistic_regression_in_a_pipeline_equals_jax(confs, spark):
    """MLE 03's shape: a CrossValidator over LogisticRegression's
    regParam x elasticNetParam inside a pipeline, areaUnderROC."""
    out = []
    for jax in (True, False):
        pkg, df, _ = _binary_frames(spark, jax)
        cls, ev = _classification(jax)
        lr = cls.LogisticRegression(labelCol="cls")
        grid = (pkg.tun.ParamGridBuilder()
                .addGrid(lr.getParam("regParam"), [0.0, 0.1])
                .addGrid(lr.getParam("elasticNetParam"), [0.0, 0.5])
                .build())
        pipe = pkg.base.Pipeline(stages=_prep(pkg.feat) + [lr])
        cv = pkg.tun.CrossValidator(
            estimator=pipe, estimatorParamMaps=grid,
            evaluator=ev.BinaryClassificationEvaluator(labelCol="cls"),
            numFolds=3, parallelism=1, seed=11)
        out.append(cv.fit(df))
    jm, pm = out
    np.testing.assert_allclose(pm.avgMetrics, jm.avgMetrics, rtol=1e-6)
    assert int(np.argmax(pm.avgMetrics)) == int(np.argmax(jm.avgMetrics))


def test_tvs_over_linear_regression_equals_jax(confs, spark):
    out = []
    for jax in (True, False):
        pkg, _, feat = _frames(spark, jax)
        lr = pkg.reg.LinearRegression(labelCol="label")
        grid = (pkg.tun.ParamGridBuilder()
                .addGrid(lr.getParam("regParam"), [0.0, 0.1, 1.0])
                .addGrid(lr.getParam("elasticNetParam"), [0.0, 0.5])
                .build())
        tvs = pkg.tun.TrainValidationSplit(
            estimator=lr, estimatorParamMaps=grid, evaluator=pkg.ev,
            trainRatio=0.75, seed=5)
        out.append(tvs.fit(feat))
    jm, pm = out
    np.testing.assert_allclose(pm.validationMetrics, jm.validationMetrics,
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["dt", "rf", "gbt"])
def test_tree_classifiers_on_a_dataframe_equal_jax(confs, spark, kind):
    """ML 07L's classifiers on an assembled frame: predictions equal,
    `probability` and `rawPrediction` within 1e-6, and the binary and
    multiclass metrics equal (rtol 1e-9)."""
    from sml_tpu.parallel import mesh as meshlib
    scored = []
    for jax in (True, False):
        _, _, feat = _binary_frames(spark, jax)
        cls, ev = _classification(jax)
        est = {"dt": lambda: cls.DecisionTreeClassifier(
                   labelCol="cls", maxDepth=5, maxBins=16),
               "rf": lambda: cls.RandomForestClassifier(
                   labelCol="cls", numTrees=8, maxDepth=4, maxBins=16,
                   seed=42),
               "gbt": lambda: cls.GBTClassifier(
                   labelCol="cls", maxIter=8, maxDepth=3, maxBins=16,
                   seed=42)}[kind]()
        train, test = feat.randomSplit([0.8, 0.2], seed=42)
        if jax:
            with meshlib.use_mesh(meshlib.build_mesh(1)):
                pred = est.fit(train).transform(test).cache()
                pred.toPandas()
        else:
            pred = est.fit(train).transform(test).cache()
        metrics = [ev.BinaryClassificationEvaluator(
            labelCol="cls", metricName=m).evaluate(pred)
            for m in ("areaUnderROC", "areaUnderPR")]
        metrics += [ev.MulticlassClassificationEvaluator(
            labelCol="cls", metricName=m).evaluate(pred)
            for m in ("f1", "accuracy", "weightedPrecision",
                      "weightedRecall")]
        cols = pred.toPandas() if jax else pred._whole()
        scored.append((cols, metrics))
    (jc, jmet), (pc, pmet) = scored
    np.testing.assert_array_equal(pc["prediction"],
                                  jc["prediction"].to_numpy())
    for c in ("probability", "rawPrediction"):
        want = np.stack([np.asarray(v.toArray() if hasattr(v, "toArray")
                                    else v, dtype=np.float64)
                         for v in jc[c]])
        np.testing.assert_allclose(pc[c], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pmet, jmet, rtol=1e-9)
