"""The port's linear programs against the JAX package's live ones, on the
CPU: `gram_stats`, `fit_linear`, `fit_logistic`, LinearRegression and
LogisticRegression in the course's pipelines, their summaries, the
linear kind of `DeviceScorer` behind the batcher, and save/load.

The JAX fits run on a one-device mesh; the port's on `device="cpu"` or
`sml.device=cpu`. Tolerances, as measured at these sizes:

- on integer features and labels whose partial sums stay below 2^24,
  the Gram moments are exact in both packages: A, b, n, y'y and the
  closed-form coefficients are bit-equal;
- on real-valued data the port sums in float64 and rounds once to f32,
  the JAX package sums in f32: coefficients within 2e-6 (relative to
  max(1, |w|));
- ML 03's one-hot Gram is nearly collinear (condition number 9.4e7 at
  5,000 rows), so its coefficients are held only through the
  predictions and the rmse: held-out rmse within rtol 2e-6 (measured
  2.9e-7 to 6.0e-7), predictions within 2e-5 of the largest |prediction|
  (measured 1.1e-5: 3.2e-3 on prices of a few hundred). Against a
  float64 least-squares solution on the same f32 features the port's
  predictions are closer than the JAX package's (6.3e-4 against 2.6e-3);
- IRLS: equal iterations at the estimator's tol 1e-6, coefficients
  within 1e-5, AUROC and accuracy within 1e-6.
"""

import numpy as np
import pytest

from sml_tpu_torch import functions as PF
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import classification as pcls
from sml_tpu_torch.ml import evaluation as pev
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import linear_impl as plin
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.ml.inference import DeviceScorer, predict_linear_sharded

N_ROWS = 5_000
CAT = ["neighbourhood_cleansed", "room_type", "property_type"]
NUM = ["accommodates", "bathrooms", "bedrooms", "beds", "minimum_nights",
       "number_of_reviews", "review_scores_rating"]
IDX = [c + "_idx" for c in CAT]
OHE = [c + "_ohe" for c in CAT]
IMP = [c + "_imp" for c in NUM]
#: the course's linear pipelines: ML 02 (one feature), ML 03 (one-hot
#: and numerics), ridge and elastic net on ML 03's features
LINEAR = {"ml02": dict(), "ml03": dict(), "ridge": dict(regParam=0.1),
          "enet": dict(regParam=0.1, elasticNetParam=0.5)}


def _one_device():
    from sml_tpu.parallel import mesh as meshlib
    return meshlib.use_mesh(meshlib.build_mesh(1))


def course_runs(m, df):
    """Each linear pipeline of one package fitted on its 80% split and
    scored on its 20%: {name: (pipeline model, predictions, metric)}."""
    F = m.F
    train, test = df.randomSplit([0.8, 0.2], seed=42)
    train.cache()
    test.cache()
    prep = [m.feat.Imputer(strategy="median", inputCols=NUM, outputCols=IMP),
            m.feat.StringIndexer(inputCols=CAT, outputCols=IDX,
                                 handleInvalid="skip"),
            m.feat.OneHotEncoder(inputCols=IDX, outputCols=OHE)]
    wide = m.feat.VectorAssembler(inputCols=OHE + IMP, outputCol="features")
    ev = m.ev.RegressionEvaluator(labelCol="price")
    out = {}
    for name, kw in LINEAR.items():
        va = m.feat.VectorAssembler(inputCols=["bedrooms_imp"],
                                    outputCol="features") \
            if name == "ml02" else wide
        model = m.Pipeline(stages=prep + [va, m.reg.LinearRegression(
            labelCol="price", **kw)]).fit(train)
        pred = model.transform(test)
        out[name] = (model, m.column(pred, "prediction"), ev.evaluate(pred),
                     train, test)
    # MLE 03 / ML 07L: priceClass at the training median
    median = float(np.median(m.column(train, "price")))
    sh_train = train.withColumn(
        "label", F.when(F.col("price") >= median, 1.0).otherwise(0.0))
    sh_test = test.withColumn(
        "label", F.when(F.col("price") >= median, 1.0).otherwise(0.0))
    logit = m.Pipeline(stages=prep + [wide, m.cls.LogisticRegression(
        labelCol="label")]).fit(sh_train)
    pred = logit.transform(sh_test)
    out["logit"] = (logit, m.column(pred, "probability")[:, 1],
                    m.ev.BinaryClassificationEvaluator(
                        labelCol="label").evaluate(pred), sh_train, sh_test)
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
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    from sml_tpu.ml import base as jbase
    from sml_tpu.ml import classification as jcls
    from sml_tpu.ml import evaluation as jev
    from sml_tpu.ml import feature as jfeat
    from sml_tpu.ml import regression as jreg

    def jcol(df, c):
        return np.stack(df.toPandas()[c].to_numpy()).astype(np.float64) \
            if c == "probability" else \
            df.toPandas()[c].to_numpy(np.float64)

    with _one_device():
        jm = types.SimpleNamespace(Pipeline=jbase.Pipeline, feat=jfeat,
                                   reg=jreg, cls=jcls, ev=jev, F=F,
                                   column=jcol)
        jax_runs = course_runs(jm, spark.createDataFrame(
            jmake(n=N_ROWS, seed=42)))
    pm = types.SimpleNamespace(
        Pipeline=pbase.Pipeline, feat=pfeat, reg=preg, cls=pcls, ev=pev,
        F=PF, column=lambda df, c: np.asarray(df._whole()[c], np.float64))
    port_runs = course_runs(pm, get_session().createDataFrame(
        make_airbnb_dataset(n=N_ROWS, seed=42)))
    return jax_runs, port_runs


def _integer_data(seed: int, n: int, d: int):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 8, (n, d)).astype(np.float32)
    y = (X @ rng.integers(-3, 4, d) + rng.integers(0, 5, n)).astype(
        np.float32)
    return X, y


def _real_data(seed: int, n: int = 3000, d: int = 6):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.5, 4.0, d)
         + rng.normal(size=d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 2.0 + rng.normal(size=n)).astype(
        np.float32)
    return X, y


@pytest.mark.parametrize("seed, n, d", [(0, 3000, 5), (1, 700, 12),
                                        (2, 10_000, 3)])
def test_gram_stats_bit_equal_on_integer_data(seed, n, d):
    from sml_tpu.ml import linear_impl as jlin
    X, y = _integer_data(seed, n, d)
    with _one_device():
        want = jlin.gram_stats(X, y)
    got = plin.gram_stats(X, y, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert type(got[2]) is float and type(got[3]) is float


@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_closed_form_bit_equal_on_integer_data(reg):
    from sml_tpu.ml import linear_impl as jlin
    X, y = _integer_data(3, 2000, 4)
    with _one_device():
        want = jlin.fit_linear(X, y, regParam=reg)
    got = plin.fit_linear(X, y, regParam=reg, device="cpu")
    np.testing.assert_array_equal(got.coefficients, want.coefficients)
    assert got.intercept == want.intercept
    assert got.stats == want.stats and got.iterations == 1


@pytest.mark.parametrize("standardization", [True, False])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("en", [0.0, 0.5])
@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_fit_linear_matches_jax(reg, en, fit_intercept, standardization):
    from sml_tpu.ml import linear_impl as jlin
    X, y = _real_data(4)
    kw = dict(regParam=reg, elasticNetParam=en, fitIntercept=fit_intercept,
              standardization=standardization)
    with _one_device():
        want = jlin.fit_linear(X, y, **kw)
    got = plin.fit_linear(X, y, device="cpu", **kw)
    scale = np.maximum(1.0, np.abs(want.coefficients))
    assert np.max(np.abs(got.coefficients - want.coefficients) / scale) \
        <= 2e-6
    assert abs(got.intercept - want.intercept) <= 2e-6 * max(
        1.0, abs(want.intercept))
    # FISTA runs maxIter fixed steps, the closed form one
    assert got.iterations == want.iterations
    for k in ("sse", "var_y", "var_pred", "n"):
        assert got.stats[k] == pytest.approx(want.stats[k], rel=1e-5)


@pytest.mark.parametrize("reg, en", [(0.0, 0.0), (0.1, 0.0), (0.1, 0.5)])
def test_fit_logistic_matches_jax(reg, en):
    from sml_tpu.ml import linear_impl as jlin
    X, y = _real_data(5, n=4000, d=8)
    lab = (y > np.median(y)).astype(np.float32)
    kw = dict(regParam=reg, elasticNetParam=en, tol=1e-6)
    with _one_device():
        want = jlin.fit_logistic(X, lab, **kw)
    got = plin.fit_logistic(X, lab, device="cpu", **kw)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=0, atol=1e-5)
    assert abs(got.intercept - want.intercept) <= 1e-5


def test_fit_logistic_keeps_fit_intercept_false_semantics():
    X, y = _real_data(6, n=1000, d=3)
    lab = (y > 0).astype(np.float32)
    res = plin.fit_logistic(X, lab, fitIntercept=False, device="cpu")
    assert res.intercept == 0.0 and res.coefficients.shape == (3,)


@pytest.mark.parametrize("name", list(LINEAR))
def test_course_pipelines_match_jax(runs, name):
    jax_runs, port_runs = runs
    _, want_pred, want_rmse, _, _ = jax_runs[name]
    model, got_pred, got_rmse, _, _ = port_runs[name]
    assert abs(got_rmse - want_rmse) <= 2e-6 * want_rmse, (got_rmse,
                                                           want_rmse)
    err = np.max(np.abs(got_pred - want_pred))
    assert err <= 2e-5 * np.max(np.abs(want_pred)), err
    assert type(model.stages[-1]) is preg.LinearRegressionModel


def test_ml03_predictions_near_the_float64_solution(runs):
    """The f32 Gram moments cost ML 03 some accuracy in both packages;
    the port's (f64 sums rounded once) cost less than the JAX package's
    (f32 sums)."""
    jax_runs, port_runs = runs
    model, got, _, train, test = port_runs["ml03"]
    Xa = np.c_[_assembled(model, train), np.ones(train.count())]
    y = train._whole()["price"].astype(np.float32).astype(np.float64)
    w = np.linalg.lstsq(Xa, y, rcond=None)[0]
    ref = np.c_[_assembled(model, test), np.ones(test.count())] @ w
    port_err = np.max(np.abs(got - ref))
    jax_err = np.max(np.abs(jax_runs["ml03"][1] - ref))
    assert port_err <= jax_err
    assert port_err <= 4e-6 * np.max(np.abs(ref)), port_err


def test_ml02_coefficients_match_jax(runs):
    jax_runs, port_runs = runs
    want = jax_runs["ml02"][0].stages[-1]
    got = port_runs["ml02"][0].stages[-1]
    assert got.numFeatures == 1
    np.testing.assert_allclose(got.coefficients.toArray(),
                               want.coefficients.toArray(), rtol=2e-6)
    assert got.intercept == pytest.approx(want.intercept, rel=2e-6)


def test_ml02_beats_the_mean_baseline(runs):
    _, port_runs = runs
    _, pred, rmse, train, test = port_runs["ml02"]
    mean = float(np.mean(train._whole()["price"]))
    price = test._whole()["price"]
    assert rmse < float(np.sqrt(np.mean((price - mean) ** 2)))


@pytest.mark.parametrize("name", ["ml02", "ml03", "enet"])
def test_training_summary_matches_jax(runs, name):
    jax_runs, port_runs = runs
    want = jax_runs[name][0].stages[-1].summary
    got = port_runs[name][0].stages[-1].summary
    assert got.numInstances == want.numInstances
    for attr in ("rootMeanSquaredError", "r2", "explainedVariance",
                 "meanSquaredError"):
        assert getattr(got, attr) == pytest.approx(getattr(want, attr),
                                                   rel=1e-5), attr
    # the MAE is computed when read, from a residual pass
    assert got._mae is None and got._mae_fn is not None
    assert got.meanAbsoluteError == pytest.approx(want.meanAbsoluteError,
                                                  rel=1e-5)
    assert got._mae_fn is None


def test_model_evaluate_matches_its_transform(runs):
    _, port_runs = runs
    model, pred, rmse, _, test = port_runs["ml03"]
    prep = test
    for s in model.stages[:-1]:
        prep = s.transform(prep)
    summary = model.stages[-1].evaluate(prep)
    # `evaluate` reads the labels as f32, as the JAX package's does; the
    # evaluator reads them as float64
    assert summary.rootMeanSquaredError == pytest.approx(rmse, rel=1e-7)
    price = prep._whole()["price"]
    assert summary.meanAbsoluteError == pytest.approx(
        float(np.mean(np.abs(price - pred))), rel=1e-9)


def test_logistic_pipeline_matches_jax(runs):
    jax_runs, port_runs = runs
    jmodel, want_p1, want_auc, _, _ = jax_runs["logit"]
    pmodel, got_p1, got_auc, _, _ = port_runs["logit"]
    assert got_auc == pytest.approx(want_auc, abs=1e-6)
    np.testing.assert_allclose(got_p1, want_p1, rtol=0, atol=1e-5)
    jsum, psum = jmodel.stages[-1].summary, pmodel.stages[-1].summary
    assert psum.accuracy == pytest.approx(jsum.accuracy, abs=1e-6)
    assert psum.areaUnderROC == pytest.approx(jsum.areaUnderROC, abs=1e-6)
    assert psum.numInstances == jsum.numInstances
    assert psum.totalIterations >= 1


def test_logistic_transform_columns(runs):
    _, port_runs = runs
    model, _, _, _, test = port_runs["logit"]
    out = model.transform(test)._whole()
    raw, prob = out["rawPrediction"], out["probability"]
    assert raw.shape == prob.shape == (len(out["price"]), 2)
    np.testing.assert_array_equal(raw[:, 0], -raw[:, 1])
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(out["prediction"],
                                  (prob[:, 1] > 0.5).astype(float))
    assert model.stages[-1].numClasses == 2


def _assembled(model, frame):
    for s in model.stages[:-1]:
        frame = s.transform(frame)
    return np.asarray(frame._whole()["features"], np.float64)


@pytest.mark.parametrize("name", ["ml03", "logit"])
def test_device_scorer_serves_a_linear_pipeline(runs, name):
    from sml_tpu_torch.serving import MicroBatcher
    _, port_runs = runs
    model, pred, _, _, test = port_runs[name]
    X = _assembled(model, test)
    scorer = DeviceScorer(model, device="cpu")
    got = scorer.score_block(X)
    np.testing.assert_allclose(got, pred, rtol=1e-12, atol=1e-12)
    tail = model.stages[-1]
    np.testing.assert_array_equal(
        got, predict_linear_sharded(X, tail._coefficients, tail.intercept,
                                    logistic=name == "logit",
                                    device="cpu"))
    assert scorer.resident_bytes() == 8 * X.shape[1]
    with MicroBatcher(scorer.score_block, max_batch_rows=256,
                      flush_micros=1000) as server:
        futures = [server.submit(X[i:i + 8]) for i in range(0, 400, 8)]
        served = np.concatenate([f.result(30) for f in futures])
    np.testing.assert_array_equal(served, got[:400])
    with pytest.raises(ValueError):
        scorer.score_block(X[:, :-1])


def test_device_scorer_matches_the_jax_scorer(runs):
    from sml_tpu.ml.inference import DeviceScorer as JScorer
    jax_runs, port_runs = runs
    jmodel = jax_runs["ml03"][0]
    pmodel, _, _, _, test = port_runs["ml03"]
    X = _assembled(pmodel, test)
    with _one_device():
        want = JScorer(jmodel).score_block(X)
    got = DeviceScorer(pmodel, device="cpu").score_block(X)
    assert np.max(np.abs(got - want)) <= 2e-5 * np.max(np.abs(want))


def _prepped_features(model, frame):
    for s in model.stages[:-1]:
        frame = s.transform(frame)
    return frame


@pytest.mark.parametrize("name", ["ml03", "logit"])
def test_models_saved_by_either_package_load_in_both(runs, tmp_path, name):
    from sml_tpu.ml.base import load_native as jload
    jax_runs, port_runs = runs
    pmodel, pred, _, _, test = port_runs[name]
    jmodel = jax_runs[name][0]
    col = "probability" if name == "logit" else "prediction"

    def port_out(model):
        out = np.asarray(model.transform(test)._whole()[col], np.float64)
        return out[:, 1] if name == "logit" else out

    pmodel.save(str(tmp_path / "port"))
    np.testing.assert_array_equal(port_out(pbase.load(str(tmp_path /
                                                          "port"))), pred)
    in_jax = jload(str(tmp_path / "port"))
    np.testing.assert_array_equal(in_jax.stages[-1].coefficients.toArray(),
                                  pmodel.stages[-1].coefficients.toArray())
    assert in_jax.stages[-1].intercept == pmodel.stages[-1].intercept
    jmodel.save(str(tmp_path / "jax"))
    from_jax = pbase.load(str(tmp_path / "jax"))
    tail = from_jax.stages[-1]
    assert type(tail) is type(pmodel.stages[-1]) and tail.summary is None
    np.testing.assert_array_equal(tail.coefficients.toArray(),
                                  jmodel.stages[-1].coefficients.toArray())
    want = jax_runs[name][1]
    assert np.max(np.abs(port_out(from_jax) - want)) <= \
        2e-5 * np.max(np.abs(want))


def test_unfitted_estimators_round_trip(tmp_path):
    for est in (preg.LinearRegression(regParam=0.3, solver="normal"),
                pcls.LogisticRegression(threshold=0.7)):
        est.save(str(tmp_path / type(est).__name__))
        back = pbase.load(str(tmp_path / type(est).__name__))
        assert type(back) is type(est)
        for p, v in est._paramMap.items():
            assert back.getOrDefault(p.name) == v, p.name


def test_non_finite_labels_are_dropped(port_device):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(200, 2))
    y = X @ [1.0, -2.0] + 0.5
    y[::7] = np.nan
    df = get_session().createDataFrame({"a": X[:, 0], "b": X[:, 1],
                                        "label": y})
    df = pfeat.VectorAssembler(inputCols=["a", "b"],
                               outputCol="features").transform(df)
    model = preg.LinearRegression().fit(df)
    ok = np.isfinite(y)
    want = plin.fit_linear(X[ok].astype(np.float32),
                           y[ok].astype(np.float32), device="cpu")
    np.testing.assert_array_equal(model.coefficients.toArray(),
                                  want.coefficients)
    assert model.summary.numInstances == int(ok.sum())
