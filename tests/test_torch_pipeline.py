"""The course's DataFrame pipelines through the port against the JAX
package's live ones, on the CPU.

ML 06 (decision tree), ML 07 (random forest) and ML 11 (XGBoost on log
price, evaluated through `exp`) run as the course runs them:
createDataFrame -> randomSplit([0.8, 0.2], seed=42) -> Pipeline(Imputer,
StringIndexer, VectorAssembler, estimator).fit(train) -> transform(test)
-> RegressionEvaluator. The JAX fits run with `sml.tree.kernel=xla` on a
one-device mesh (the counterpart of one card); the port's with
`sml.device=cpu`, so the kernels' plain versions run.

- The frames the fits read are the JAX package's bit for bit: the
  feature block, the labels and the categorical slots.
- ML 06 and ML 07 give the JAX package's held-out rmse within the golden
  tolerance max(1e-3, 1e-5 * |rmse|), and ML 06 its split table.
- ML 11's held-out rmse is held to 1e-3 * rmse. Its inputs are the JAX
  package's bit for bit, but the port sums histograms in float64 where
  the JAX package sums in f32, and a boosted fit flips near-tied splits
  (at 5,000 rows: node 42 of the first tree, gains 0.0268860 and
  0.0268850); the held-out rmse moves by 2e-4 to 8e-4 of itself at 4,000
  to 10,000 rows, more than the golden tolerance. `tests/
  test_torch_fit.py` holds the fits themselves.
- Each DataFrame fit equals the port's own matrix fit (`fit(X, y,
  categorical)`) on the matrix the fitted prep stages assemble, bit for
  bit: split tables, leaf values, gains and covers.
- The evaluators give the JAX package's metrics; the exp-link pushdown
  gives the materialized path's rmse without materializing the
  prediction column.
- A PipelineModel saved by either package loads in both and predicts
  the same values: bit for bit within the port, within rtol 1e-6 across
  the packages (each sums its trees' leaf values in f32 in its own
  order).
"""

import numpy as np
import pytest

from sml_tpu_torch import functions as PF
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.ml._staging import extract_xy
from sml_tpu_torch.ml._tree_models import _categorical_slots
from sml_tpu_torch.ml.evaluation import RegressionEvaluator
from sml_tpu_torch.xgboost import XgboostRegressor

N_ROWS = 5_000
CAT = ["neighbourhood_cleansed", "room_type", "property_type"]
NUM = ["accommodates", "bathrooms", "bedrooms", "beds", "minimum_nights",
       "number_of_reviews", "review_scores_rating"]
IDX = [c + "_idx" for c in CAT]
IMP = [c + "_imp" for c in NUM]


def golden_tol(want: float) -> float:
    return max(1e-3, 1e-5 * abs(want))


def course_pipelines(m, feat, reg, xgb_cls, F, df):
    """The three course pipelines of one package on its frame: {name:
    (pipeline model, its train frame, its test frame, held-out rmse)}."""
    train, test = df.randomSplit([0.8, 0.2], seed=42)
    train.cache()
    test.cache()
    prep = [feat.Imputer(strategy="median", inputCols=NUM, outputCols=IMP),
            feat.StringIndexer(inputCols=CAT, outputCols=IDX,
                               handleInvalid="skip"),
            feat.VectorAssembler(inputCols=IDX + IMP, outputCol="features")]
    ev = m.RegressionEvaluator(labelCol="price")
    log_train = train.withColumn("label", F.log(F.col("price")))
    log_test = test.withColumn("label", F.log(F.col("price")))
    ests = {
        "dt": (reg.DecisionTreeRegressor(labelCol="price", maxDepth=5,
                                         maxBins=40), train, test),
        "rf": (reg.RandomForestRegressor(labelCol="price", maxDepth=6,
                                         numTrees=20, maxBins=40, seed=42),
               train, test),
        "xgb": (xgb_cls(n_estimators=40, learning_rate=0.15, max_depth=6,
                        max_bins=64, random_state=42), log_train, log_test),
    }
    out = {}
    for name, (est, tr, te) in ests.items():
        model = m.Pipeline(stages=prep + [est]).fit(tr)
        pred = model.transform(te)
        if name == "xgb":
            pred = pred.withColumn("prediction", F.exp(F.col("prediction")))
        out[name] = (model, tr, te, ev.evaluate(pred))
    return out


@pytest.fixture(scope="module")
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


@pytest.fixture(scope="module")
def runs(spark, port_device):
    import types

    from sml_tpu import functions as F
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    from sml_tpu.ml import base as jbase
    from sml_tpu.ml import evaluation as jev
    from sml_tpu.ml import feature as jfeat
    from sml_tpu.ml import regression as jreg
    from sml_tpu.parallel import mesh as meshlib
    from sml_tpu.xgboost import XgboostRegressor as JX
    prev = JCONF.get("sml.tree.kernel")
    JCONF.set("sml.tree.kernel", "xla")
    try:
        with meshlib.use_mesh(meshlib.build_mesh(1)):
            jm = types.SimpleNamespace(Pipeline=jbase.Pipeline,
                                       RegressionEvaluator=
                                       jev.RegressionEvaluator)
            jax_runs = course_pipelines(
                jm, jfeat, jreg, JX, F,
                spark.createDataFrame(jmake(n=N_ROWS, seed=42)))
    finally:
        JCONF.set("sml.tree.kernel", prev)
    pm = types.SimpleNamespace(Pipeline=pbase.Pipeline,
                               RegressionEvaluator=RegressionEvaluator)
    port_runs = course_pipelines(
        pm, pfeat, preg, XgboostRegressor, PF,
        get_session().createDataFrame(make_airbnb_dataset(n=N_ROWS,
                                                          seed=42)))
    return jax_runs, port_runs


def _same_tables(a, b, values=True):
    np.testing.assert_array_equal(a.split_feature, b.split_feature)
    np.testing.assert_array_equal(a.split_bin, b.split_bin)
    if values:
        for f in ("leaf_value", "gain", "cover"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", ["dt", "rf", "xgb"])
def test_fit_inputs_are_the_jax_packages(runs, name):
    """The fitted prep stages hand the estimator the JAX package's
    feature block, labels and categorical slots, bit for bit."""
    from sml_tpu.ml._staging import extract_xy as jxy
    from sml_tpu.ml._tree_models import _categorical_slots as jslots
    jax_runs, port_runs = runs
    jmodel, jtr, _, _ = jax_runs[name]
    pmodel, ptr, _, _ = port_runs[name]
    label = "label" if name == "xgb" else "price"
    jprep = jtr
    for s in jmodel.stages[:-1]:
        jprep = s.transform(jprep)
    pprep = ptr
    for s in pmodel.stages[:-1]:
        pprep = s.transform(pprep)
    Xj, yj, _ = jxy(jprep, "features", label)
    Xp, yp, _ = extract_xy(pprep, "features", label)
    assert Xp.dtype == Xj.dtype == np.float32
    np.testing.assert_array_equal(Xp, Xj)
    np.testing.assert_array_equal(yp, yj)
    assert _categorical_slots(pprep, "features") == \
        jslots(jprep, "features") == {0: 36, 1: 3, 2: 6}


@pytest.mark.parametrize("name", ["dt", "rf"])
def test_held_out_rmse_matches_jax_within_golden_tolerance(runs, name):
    jax_runs, port_runs = runs
    want, got = jax_runs[name][3], port_runs[name][3]
    assert abs(got - want) <= golden_tol(want), (got, want)


def test_ml11_held_out_rmse_near_jax(runs):
    jax_runs, port_runs = runs
    want, got = jax_runs["xgb"][3], port_runs["xgb"][3]
    assert abs(got - want) <= 1e-3 * want, (got, want)
    # the course's orderings hold in the port
    rmse = {k: v[3] for k, v in port_runs.items()}
    assert rmse["xgb"] < rmse["dt"]


def test_ml06_split_table_equals_jax(runs):
    jax_runs, port_runs = runs
    _same_tables(jax_runs["dt"][0].stages[-1]._spec.trees[0],
                 port_runs["dt"][0].stages[-1]._spec.trees[0],
                 values=False)


@pytest.mark.parametrize("name", ["dt", "rf", "xgb"])
def test_dataframe_fit_equals_matrix_fit(runs, name):
    _, port_runs = runs
    model, train, _, _ = port_runs[name]
    prep = train
    for s in model.stages[:-1]:
        prep = s.transform(prep)
    est = model.stages[-1]
    label = "label" if name == "xgb" else "price"
    X, y, _ = extract_xy(prep, "features", label)
    cls = type(est)
    kinds = {"dt": preg.DecisionTreeRegressor,
             "rf": preg.RandomForestRegressor, "xgb": XgboostRegressor}
    fresh = kinds[name]()
    fresh._paramMap = {fresh.getParam(p.name): v
                       for p, v in est._paramMap.items()}
    matrix = fresh.fit(X, y, categorical=_categorical_slots(prep, "features"),
                       device="cpu")
    assert type(matrix) is cls
    assert matrix.getNumTrees() == est.getNumTrees()
    for a, b in zip(est._spec.trees, matrix._spec.trees):
        _same_tables(a, b)
    np.testing.assert_array_equal(est._spec.binning.edges,
                                  matrix._spec.binning.edges)
    assert est._spec.base == matrix._spec.base


def test_exp_link_pushdown_equals_materialized_path(runs):
    from sml_tpu_torch.native import traverse_kernel as tk
    _, port_runs = runs
    model, _, test, _ = port_runs["xgb"]
    ev = RegressionEvaluator(labelCol="price")
    lazy = model.transform(test).withColumn("prediction",
                                            PF.exp(PF.col("prediction")))
    assert lazy._fused_eval is not None and lazy._fused_eval._link == "exp"
    calls = []
    hook = lazy._fused_eval
    orig = hook._compute
    hook._compute = lambda *a: calls.append(1) or orig(*a)
    pushed = ev.evaluate(lazy)
    assert calls == [1] and lazy._parts is None  # never materialized
    for metric in ("rmse", "mae", "r2"):
        mat = model.transform(test).withColumn(
            "prediction", PF.exp(PF.col("prediction"))).cache()
        want = RegressionEvaluator(labelCol="price",
                                   metricName=metric).evaluate(mat)
        got = RegressionEvaluator(labelCol="price",
                                  metricName=metric).evaluate(lazy)
        assert abs(got - want) <= golden_tol(want), (metric, got, want)
    assert pushed == ev.evaluate(lazy)
    # a link over another column drops the hook
    other = model.transform(test).withColumn("prediction",
                                             PF.exp(PF.col("price")))
    assert getattr(other, "_fused_eval", None) is None
    assert tk.LAUNCHES == 0  # the CPU ran the plain traversal


def _eval_frames(session, create):
    rng = np.random.default_rng(11)
    n = 600
    lab = (rng.random(n) < 0.4).astype(float)
    score = np.clip(lab * 0.3 + rng.random(n) * 0.8, 0, 1)
    pred3 = rng.integers(0, 3, n).astype(float)
    lab3 = np.where(rng.random(n) < 0.6, pred3, rng.integers(0, 3, n))
    X = rng.normal(size=(n, 3)) + pred3[:, None] * 2
    cols = {"label": lab, "score": score, "pred3": pred3,
            "lab3": lab3.astype(float), "reg": score * 10 + rng.normal(size=n),
            "reg_label": lab * 10, "x0": X[:, 0], "x1": X[:, 1],
            "x2": X[:, 2], "cluster": pred3.astype(np.int64)}
    return create(session, cols)


def test_evaluators_match_jax(spark, port_device):
    import pandas as pd
    from sml_tpu.ml import evaluation as jev
    from sml_tpu.ml.feature import VectorAssembler as JVA
    from sml_tpu_torch.ml import evaluation as pev
    jdf = _eval_frames(spark, lambda s, c: s.createDataFrame(
        pd.DataFrame(c)))
    pdf = _eval_frames(get_session(), lambda s, c: s.createDataFrame(c))
    jdf = JVA(inputCols=["x0", "x1", "x2"], outputCol="features") \
        .transform(jdf)
    pdf = pfeat.VectorAssembler(inputCols=["x0", "x1", "x2"],
                                outputCol="features").transform(pdf)
    cases = [("RegressionEvaluator", dict(predictionCol="reg",
                                          labelCol="reg_label"), m)
             for m in ("rmse", "mse", "mae", "r2", "var")]
    cases += [("BinaryClassificationEvaluator",
               dict(rawPredictionCol="score", labelCol="label"), m)
              for m in ("areaUnderROC", "areaUnderPR")]
    cases += [("MulticlassClassificationEvaluator",
               dict(predictionCol="pred3", labelCol="lab3"), m)
              for m in ("f1", "accuracy", "weightedPrecision",
                        "weightedRecall")]
    cases += [("ClusteringEvaluator", dict(predictionCol="cluster"),
               "silhouette")]
    for cls, kw, metric in cases:
        want = getattr(jev, cls)(metricName=metric, **kw).evaluate(jdf)
        got = getattr(pev, cls)(metricName=metric, **kw).evaluate(pdf)
        # the regression statistics are f32 sums (the JAX package's router
        # may reduce them on its mesh, in another order); the rest is
        # float64 on the host in both packages
        rel = 1e-6 if cls == "RegressionEvaluator" else 1e-12
        assert got == pytest.approx(want, rel=rel, abs=1e-12), (cls, metric)


def _predictions_of(model, df):
    return np.asarray(model.transform(df).toPandas()["prediction"],
                      dtype=np.float64)


@pytest.mark.parametrize("name", ["dt", "xgb"])
def test_pipeline_model_saved_by_either_package_loads_in_both(
        runs, tmp_path, name):
    from sml_tpu.ml.base import load_native as jload
    jax_runs, port_runs = runs
    pmodel, _, ptest, _ = port_runs[name]
    jmodel, _, jtest, _ = jax_runs[name]
    want_p = _predictions_of(pmodel, ptest)
    want_j = _predictions_of(jmodel, jtest)
    # saved by the port: loads in the JAX package and in the port
    pmodel.save(str(tmp_path / "port"))
    in_jax = jload(str(tmp_path / "port"))
    in_port = pbase.load(str(tmp_path / "port"))
    assert [type(s).__name__ for s in in_jax.stages] == \
        [type(s).__name__ for s in pmodel.stages]
    np.testing.assert_array_equal(_predictions_of(in_port, ptest), want_p)
    np.testing.assert_allclose(_predictions_of(in_jax, jtest), want_p,
                               rtol=1e-6)
    # saved by the JAX package: loads in the port
    jmodel.save(str(tmp_path / "jax"))
    from_jax = pbase.load(str(tmp_path / "jax"))
    assert [s.uid for s in from_jax.stages] == [s.uid for s in jmodel.stages]
    np.testing.assert_allclose(_predictions_of(from_jax, ptest), want_j,
                               rtol=1e-6)
