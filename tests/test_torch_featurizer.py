"""The port's compiled featurizer and its fused pipeline routes against
the JAX package's live ones and against the port's own stage path, on
the CPU.

- `CompiledFeaturizer` blocks and row-keep masks equal the JAX
  package's bit for bit under the indexer's handleInvalid "error",
  "skip" and "keep", on batches with unseen labels and NULLs; both
  raise on an unseen label under "error".
- `compact_parts` (numeric slots, codes, layout, width, keep) equals the
  JAX package's; `expand_host` gives the featurizer's block, and
  `predict_affine` is X @ w + b within rtol 1e-6.
- A fused `Pipeline.fit` hands the estimator the stage path's features,
  labels and `_ml_attrs` bit for bit, so its LR coefficients and RF
  trees are the stage path's; against the JAX package's fused fit the
  tolerances are `tests/test_torch_pipeline.py`'s and
  `tests/test_torch_linear.py`'s (held-out rmse within the golden
  tolerance; ML 03's one-hot coefficients through their predictions,
  within 2e-5 of the largest).
- `PipelineModel.transform` through the fused pass gives the stage
  path's frame (partitions, columns, dtypes, values) and `_ml_attrs`;
  the evaluator through `_ScorerEvalHook` gives the materialized rmse.
- The route is decided before any work: a prep stage that writes the
  label, or a stage outside the chain, keeps the stage path and fits
  each prep stage once.
"""

import numpy as np
import pytest

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import featurizer as pfz
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.ml._staging import extract_xy
from sml_tpu_torch.ml.evaluation import RegressionEvaluator

INVALID = ["error", "skip", "keep"]
CAT = ["neighbourhood_cleansed", "room_type", "property_type"]
NUM = ["accommodates", "bathrooms", "bedrooms", "beds", "minimum_nights",
       "number_of_reviews", "review_scores_rating"]
IDX = [c + "_idx" for c in CAT]
OHE = [c + "_ohe" for c in CAT]
IMP = [c + "_imp" for c in NUM]


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


def _data(n=400, seed=0, nan_rate=0.1):
    """A small raw block: a text category, two numerics (x1 with NaN) and
    a label, from a seed."""
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x1[rng.random(n) < nan_rate] = np.nan
    return {"cat": rng.choice(["a", "b", "c", "d"], size=n).astype(object),
            "x1": x1, "x2": rng.normal(size=n),
            "label": rng.normal(size=n)}


def _batch(seed, invalid):
    """A batch with five unseen labels and, unless the indexer raises on
    them, three NULLs."""
    b = _data(seed=seed)
    b["cat"][:5] = "UNSEEN"
    if invalid != "error":
        b["cat"][7:10] = None
    return b


def _stages(feat, est, invalid):
    return [feat.Imputer(strategy="median", inputCols=["x1", "x2"],
                         outputCols=["x1_i", "x2_i"]),
            feat.StringIndexer(inputCols=["cat"], outputCols=["cat_idx"],
                               handleInvalid=invalid),
            feat.OneHotEncoder(inputCols=["cat_idx"], outputCols=["cat_ohe"]),
            feat.VectorAssembler(inputCols=["cat_ohe", "x1_i", "x2_i",
                                            "cat_idx"],
                                 outputCol="features"),
            est]


def _both(spark, invalid):
    """The port's and the JAX package's featurizers of the same pipeline
    fitted on the same rows."""
    import pandas as pd
    from sml_tpu.ml import Pipeline as JP
    from sml_tpu.ml import feature as jfeat
    from sml_tpu.ml.featurizer import CompiledFeaturizer as JCF
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu.parallel import mesh as meshlib
    train = _data()
    with meshlib.use_mesh(meshlib.build_mesh(1)):
        jm = JP(stages=_stages(jfeat, JLR(labelCol="label"), invalid)).fit(
            spark.createDataFrame(pd.DataFrame(train)))
    pm = pbase.Pipeline(stages=_stages(
        pfeat, preg.LinearRegression(labelCol="label"), invalid)).fit(
        get_session().createDataFrame(train))
    jf = JCF.from_stages(jm.stages[:-1], jm.stages[-2])
    pf = pfz.CompiledFeaturizer.from_stages(pm.stages[:-1], pm.stages[-2])
    assert jf is not None and pf is not None
    assert pm.stages[1].labelsArray == [list(x)
                                        for x in jm.stages[1].labelsArray]
    return jf, pf


@pytest.mark.parametrize("invalid", INVALID)
def test_featurizer_block_and_keep_equal_jax(spark, invalid):
    import pandas as pd
    jf, pf = _both(spark, invalid)
    batch = _batch(1, invalid)
    if invalid == "error":
        with pytest.raises(ValueError, match="Unseen label"):
            jf.transform_with_mask(pd.DataFrame(batch))
        with pytest.raises(ValueError, match="Unseen label"):
            pf.transform_with_mask(batch)
        batch = _data(seed=1)
    Xj, kj = jf.transform_with_mask(pd.DataFrame(batch))
    Xp, kp = pf.transform_with_mask(batch)
    assert Xp.dtype == Xj.dtype == np.float32
    np.testing.assert_array_equal(Xp, Xj)
    if kj is None:
        assert kp is None
    else:
        np.testing.assert_array_equal(kp, kj)
    if invalid == "skip":
        assert Xp.shape[0] == len(batch["x1"]) - 8
    assert pf.feature_attrs() == jf.feature_attrs()
    assert pf.interim_attrs() == jf.interim_attrs()


@pytest.mark.parametrize("invalid", ["skip", "keep"])
def test_compact_parts_equal_jax(spark, invalid):
    import pandas as pd
    jf, pf = _both(spark, invalid)
    # the assembled index column is neither numeric nor one-hot: both
    # packages decline the compact form for this chain
    batch = _batch(2, invalid)
    assert pf.compact_parts(batch) is None
    assert jf.compact_parts(pd.DataFrame(batch)) is None
    # without it: the course's shape
    jf.sources, pf.sources = jf.sources[:3], pf.sources[:3]
    jf.width = pf.width = sum(s.width for s in pf.sources)
    pf.in_cols = pf.in_cols[:3]
    pj = jf.compact_parts(pd.DataFrame(batch))
    pp = pf.compact_parts(batch)
    assert pp.layout == pj.layout and pp.width == pj.width
    np.testing.assert_array_equal(pp.num, pj.num)
    np.testing.assert_array_equal(pp.codes, pj.codes)
    assert pp.codes.dtype == np.int32 and pp.num.dtype == np.float32
    assert (pp.keep is None) == (pj.keep is None)
    if pp.keep is not None:
        np.testing.assert_array_equal(pp.keep, pj.keep)
    X, keep = pf.transform_with_mask(batch)
    np.testing.assert_array_equal(pp.expand_host(), X)
    rng = np.random.default_rng(0)
    w = rng.normal(size=pp.width)
    np.testing.assert_allclose(pp.predict_affine(w, 1.5),
                               X.astype(np.float64) @ w + 1.5, rtol=1e-6)


def test_compact_parts_decline_a_nan_row():
    """A NaN the block would carry (no imputer on x1) leaves the compact
    form to the materialized path, as in the JAX package."""
    train = get_session().createDataFrame(_data())
    pm = pbase.Pipeline(stages=[
        pfeat.StringIndexer(inputCols=["cat"], outputCols=["cat_idx"]),
        pfeat.OneHotEncoder(inputCols=["cat_idx"], outputCols=["cat_ohe"]),
        pfeat.VectorAssembler(inputCols=["cat_ohe", "x1"],
                              outputCol="features", handleInvalid="keep"),
    ]).fit(train)
    pf = pfz.CompiledFeaturizer.from_stages(pm.stages[:-1], pm.stages[-1])
    assert pf.compact_parts(_data(seed=3)) is None
    assert pf.compact_parts(_data(seed=3, nan_rate=0.0)) is not None


# ------------------------------------------------ the fused pipeline fit
def _spied(est, seen):
    """`est` recording the frame its fit reads: its `_ml_attrs`, and the
    features and labels `extract_xy` gives."""
    fit = est._fit

    def spy(df):
        X, y, _ = extract_xy(df, est.getOrDefault("featuresCol"),
                             est.getOrDefault("labelCol"))
        seen.append((dict(df._ml_attrs), X, y))
        return fit(df)

    est._fit = spy
    return est


def _course_prep(onehot: bool):
    stages = [pfeat.Imputer(strategy="median", inputCols=NUM, outputCols=IMP),
              pfeat.StringIndexer(inputCols=CAT, outputCols=IDX,
                                  handleInvalid="skip")]
    if onehot:
        stages.append(pfeat.OneHotEncoder(inputCols=IDX, outputCols=OHE))
    stages.append(pfeat.VectorAssembler(
        inputCols=(OHE if onehot else IDX) + IMP, outputCol="features"))
    return stages


def _course_est(name):
    if name == "lr":
        return preg.LinearRegression(labelCol="price")
    return preg.RandomForestRegressor(labelCol="price", maxDepth=5,
                                      numTrees=10, maxBins=40, seed=42)


@pytest.fixture(scope="module")
def course_split():
    df = get_session().createDataFrame(make_airbnb_dataset(n=5_000, seed=42))
    train, test = df.randomSplit([0.8, 0.2], seed=42)
    return train.cache(), test.cache()


@pytest.fixture(scope="module")
def fused_and_staged(course_split):
    """{name: ((fused model, what its estimator read), (stage-path model,
    what its estimator read))} for ML 03's one-hot LR and ML 07's RF."""
    train, _ = course_split
    out = {}
    for name in ("lr", "rf"):
        runs = []
        for fused in (True, False):
            seen = []
            stages = _course_prep(name == "lr") + [
                _spied(_course_est(name), seen)]
            if fused:
                model = pbase.Pipeline(stages=stages).fit(train)
            else:
                with pfz.stage_by_stage():
                    model = pbase.Pipeline(stages=stages).fit(train)
            runs.append((model, seen[0]))
        out[name] = runs
    return out


@pytest.mark.parametrize("name", ["lr", "rf"])
def test_fused_fit_reads_the_stage_paths_frame(fused_and_staged, name):
    (_, (attrs_f, Xf, yf)), (_, (attrs_s, Xs, ys)) = fused_and_staged[name]
    assert attrs_f == attrs_s
    assert Xf.dtype == Xs.dtype == np.float32
    np.testing.assert_array_equal(Xf, Xs)
    np.testing.assert_array_equal(yf, ys)


def test_fused_fit_takes_the_route(course_split):
    train, _ = course_split
    for name in ("lr", "rf"):
        stages = _course_prep(name == "lr") + [_course_est(name)]
        assert pfz.fast_fit_applies(stages, train._whole(), train._ml_attrs)
        with pfz.stage_by_stage():
            assert not pfz.fast_fit_applies(stages, train._whole())


def test_fused_lr_fit_equals_stage_path(fused_and_staged):
    (mf, _), (ms, _) = fused_and_staged["lr"]
    np.testing.assert_array_equal(mf.stages[-1]._coefficients,
                                  ms.stages[-1]._coefficients)
    assert mf.stages[-1].intercept == ms.stages[-1].intercept
    for a, b in zip(mf.stages[:-1], ms.stages[:-1]):
        assert type(a) is type(b)
    assert mf.stages[2].categorySizes == ms.stages[2].categorySizes


def test_fused_rf_fit_equals_stage_path(fused_and_staged):
    (mf, _), (ms, _) = fused_and_staged["rf"]
    tf, ts = mf.stages[-1]._spec.trees, ms.stages[-1]._spec.trees
    assert len(tf) == len(ts) == 10
    for a, b in zip(tf, ts):
        for f in ("split_feature", "split_bin", "leaf_value", "gain",
                  "cover"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.fixture(scope="module")
def jax_fused(spark):
    """The JAX package's fused fits of the same pipelines on its own frame
    of the same rows (`sml.tree.kernel=xla`, a one-device mesh), and its
    held-out rmse."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    from sml_tpu.ml import Pipeline as JP
    from sml_tpu.ml import feature as jfeat
    from sml_tpu.ml.evaluation import RegressionEvaluator as JEV
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu.ml.regression import RandomForestRegressor as JRF
    from sml_tpu.parallel import mesh as meshlib
    prev = JCONF.get("sml.tree.kernel")
    JCONF.set("sml.tree.kernel", "xla")
    try:
        with meshlib.use_mesh(meshlib.build_mesh(1)):
            df = spark.createDataFrame(jmake(n=5_000, seed=42))
            train, test = df.randomSplit([0.8, 0.2], seed=42)
            out = {}
            for name, est in (("lr", JLR(labelCol="price")),
                              ("rf", JRF(labelCol="price", maxDepth=5,
                                         numTrees=10, maxBins=40,
                                         seed=42))):
                onehot = name == "lr"
                stages = [jfeat.Imputer(strategy="median", inputCols=NUM,
                                        outputCols=IMP),
                          jfeat.StringIndexer(inputCols=CAT,
                                              outputCols=IDX,
                                              handleInvalid="skip")]
                if onehot:
                    stages.append(jfeat.OneHotEncoder(inputCols=IDX,
                                                      outputCols=OHE))
                stages.append(jfeat.VectorAssembler(
                    inputCols=(OHE if onehot else IDX) + IMP,
                    outputCol="features"))
                model = JP(stages=stages + [est]).fit(train)
                pred = model.transform(test)
                out[name] = (model, pred.toPandas()["prediction"].to_numpy(),
                             JEV(labelCol="price").evaluate(pred))
            return out
    finally:
        JCONF.set("sml.tree.kernel", prev)


def test_fused_rf_matches_jax_fused_fit(fused_and_staged, jax_fused,
                                        course_split):
    _, test = course_split
    model = fused_and_staged["rf"][0][0]
    got = RegressionEvaluator(labelCol="price").evaluate(
        model.transform(test))
    want = jax_fused["rf"][2]
    assert abs(got - want) <= max(1e-3, 1e-5 * abs(want)), (got, want)


def test_fused_lr_matches_jax_fused_fit(fused_and_staged, jax_fused,
                                        course_split):
    """ML 03's one-hot Gram is nearly collinear, so the coefficients are
    held through the predictions (`tests/test_torch_linear.py`)."""
    _, test = course_split
    model = fused_and_staged["lr"][0][0]
    pred = model.transform(test)._whole()["prediction"]
    want = jax_fused["lr"][1]
    assert pred.shape == want.shape
    assert np.max(np.abs(pred - want)) <= 2e-5 * np.max(np.abs(want))
    got = RegressionEvaluator(labelCol="price").evaluate(
        model.transform(test))
    assert abs(got - jax_fused["lr"][2]) <= 2e-6 * jax_fused["lr"][2]


# -------------------------------------------- the fused transform
def _same_frames(a, b):
    pa, pb = a._materialize(), b._materialize()
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            assert x[k].shape == y[k].shape, k
            if x[k].dtype.kind == "O":
                assert (x[k] == y[k]).all(), k
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert a._ml_attrs == b._ml_attrs


@pytest.mark.parametrize("name", ["lr", "rf"])
def test_fused_transform_equals_stage_path(fused_and_staged, course_split,
                                           name):
    _, test = course_split
    model = fused_and_staged[name][0][0]
    fused = model.transform(test)
    assert isinstance(fused._fused_eval, pbase._ScorerEvalHook)
    with pfz.stage_by_stage():
        staged = model.transform(test)
    assert not isinstance(getattr(staged, "_fused_eval", None),
                          pbase._ScorerEvalHook)
    _same_frames(fused, staged)


@pytest.mark.parametrize("invalid", INVALID)
def test_fused_transform_of_a_feature_pipeline(invalid):
    """A pipeline of prep stages alone (no model): interim columns,
    dtypes and partitions, with the indexer's drops per partition."""
    train = get_session().createDataFrame(_data())
    stages = _stages(pfeat, preg.LinearRegression(labelCol="label"),
                     invalid)[:-1]
    model = pbase.Pipeline(stages=stages).fit(train)
    batch = _data(seed=4) if invalid == "error" else _batch(4, invalid)
    frame = get_session().createDataFrame(batch)
    fused = model.transform(frame)
    with pfz.stage_by_stage():
        staged = model.transform(frame)
    _same_frames(fused, staged)


@pytest.mark.parametrize("metric", ["rmse", "mae", "r2"])
@pytest.mark.parametrize("name", ["lr", "rf"])
def test_scorer_eval_hook_equals_materialized(fused_and_staged, course_split,
                                             name, metric):
    """The pushdown gives the stage path's metric bit for bit (for a
    tree tail the stage path's own pushdown, `_TreeEvalHook`: both sum
    the statistics in the fused device reduction), and the materialized
    frame's: exactly for a linear tail, within rtol 1e-6 for a tree tail
    (the host sums the same f32 statistics in another order)."""
    _, test = course_split
    model = fused_and_staged[name][0][0]
    ev = RegressionEvaluator(labelCol="price", metricName=metric)
    lazy = model.transform(test)
    hooked = ev.evaluate(lazy)
    assert lazy._parts is None  # the hook read the raw frame only
    with pfz.stage_by_stage():
        assert hooked == ev.evaluate(model.transform(test))
    done = model.transform(test)
    done._materialize()
    if name == "lr":
        assert hooked == ev.evaluate(done)
    else:
        np.testing.assert_allclose(hooked, ev.evaluate(done), rtol=1e-6)


# ------------------------------------------------ route decisions
def test_prep_overwrites_label_matches_jax():
    from sml_tpu.ml import feature as jfeat
    from sml_tpu.ml.featurizer import prep_overwrites_label as jover
    from sml_tpu.ml.regression import LinearRegression as JLR
    cases = [(["x1"], None), (["label"], None), (["x1"], ["label"]),
             (["label"], ["label_i"])]
    for ins, outs in cases:
        pi = pfeat.Imputer(inputCols=ins, outputCols=outs)
        ji = jfeat.Imputer(inputCols=ins, outputCols=outs)
        assert pfz.prep_overwrites_label(
            [pi], preg.LinearRegression(labelCol="label")) == \
            jover([ji], JLR(labelCol="label"))


def test_prep_overwriting_the_label_keeps_the_stage_path():
    """An Imputer that fills the label in place: the raw labels are the
    wrong ones, so the fused route is not taken, and the fit is the
    stage path's."""
    raw = _data()
    raw["label"][::7] = np.nan
    df = get_session().createDataFrame(raw)

    def stages():
        return [pfeat.Imputer(strategy="mean", inputCols=["x1", "label"]),
                pfeat.VectorAssembler(inputCols=["x1", "x2"],
                                      outputCol="features"),
                preg.LinearRegression(labelCol="label")]

    assert not pfz.fast_fit_applies(stages(), df._whole())
    fused = pbase.Pipeline(stages=stages()).fit(df)
    with pfz.stage_by_stage():
        staged = pbase.Pipeline(stages=stages()).fit(df)
    np.testing.assert_array_equal(fused.stages[-1]._coefficients,
                                  staged.stages[-1]._coefficients)
    assert fused.stages[-1].summary.numInstances == len(raw["label"])


def test_unknown_stage_decided_before_any_work():
    """A StandardScaler in the chain: the fused fit declines before any
    prep stage fits (the Imputer fits once, on the stage path), the
    fused transform and the scorer's featurizer are off, and the results
    are the stage path's."""
    from sml_tpu_torch.ml.inference import DeviceScorer
    df = get_session().createDataFrame(_data())
    fits = []

    class CountingImputer(pfeat.Imputer):
        def _fit(self, frame):
            fits.append(1)
            return super()._fit(frame)

    def stages():
        return [CountingImputer(strategy="median", inputCols=["x1"],
                                outputCols=["x1_i"]),
                pfeat.VectorAssembler(inputCols=["x1_i", "x2"],
                                      outputCol="raw"),
                pfeat.StandardScaler(inputCol="raw", outputCol="features"),
                preg.LinearRegression(labelCol="label")]

    assert not pfz.fast_fit_applies(stages(), df._whole())
    model = pbase.Pipeline(stages=stages()).fit(df)
    assert len(fits) == 1
    assert model._build_fast_plan() is None
    out = model.transform(df)
    assert getattr(out, "_fused_eval", None) is None
    with pfz.stage_by_stage():
        staged = pbase.Pipeline(stages=stages()).fit(df)
    np.testing.assert_array_equal(model.stages[-1]._coefficients,
                                  staged.stages[-1]._coefficients)
    scorer = DeviceScorer(model, device="cpu")
    assert scorer._featurizer is None and scorer._factorized is None
    np.testing.assert_array_equal(
        scorer(df), out._whole()["prediction"])


def test_encoder_over_a_raw_code_column_attaches_the_block():
    """An OneHotEncoder over a raw numeric code column is outside the
    whole-chain fit, but its fitted chain compiles: the estimator reads
    the one-pass block (`attach_fused_features`), the stage path's bits."""
    raw = _data()
    raw["code"] = np.random.default_rng(5).integers(0, 5, len(raw["x1"]))
    df = get_session().createDataFrame(raw)

    def stages():
        return [pfeat.OneHotEncoder(inputCols=["code"],
                                    outputCols=["code_ohe"]),
                pfeat.VectorAssembler(inputCols=["code_ohe", "x2"],
                                      outputCol="features"),
                preg.LinearRegression(labelCol="label")]

    assert not pfz.fast_fit_applies(stages(), df._whole())
    seen = []
    est = stages()
    est[-1] = _spied(est[-1], seen)
    captured = []
    real = pfz.attach_fused_features

    def spy(cur, *a):
        out = real(cur, *a)
        captured.append(getattr(out, "_featurized", None))
        return out

    pfz_attach = pfz.attach_fused_features
    pfz.attach_fused_features = spy
    try:
        fused = pbase.Pipeline(stages=est).fit(df)
    finally:
        pfz.attach_fused_features = pfz_attach
    assert captured and captured[0] is not None
    with pfz.stage_by_stage():
        staged = pbase.Pipeline(stages=stages()).fit(df)
    np.testing.assert_array_equal(fused.stages[-1]._coefficients,
                                  staged.stages[-1]._coefficients)
