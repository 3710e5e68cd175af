"""ML 12's batch scoring through the port: `DeviceScorer` on raw batches
(its compiled featurizer and factorized linear scorer) and
`score_batches`, on the CPU (`device="cpu"`, so the kernels' plain
versions run). The cases of `tests/test_featurizer.py` (the scorer) and
`tests/test_inference.py` (batch scoring), ported:

- the factorized scorer against the block route and against the
  pipeline's transform: rtol 1e-5, atol 1e-7 (it sums the dot in
  another order), equal NaN rows, equal "skip" drops;
- against the JAX package's own factorized scorer on a model the JAX
  package saved and the port loaded: rtol 1e-12 (both host float64);
- `score_batches`' concatenation equals the whole, on the factorized
  route and on the device route (a linear block, a forest);
- `sml.infer.prefetchBatches` = 3 puts dispatches 0-2 before drain 0
  (`prefetch_pipeline`'s `order`);
- a batch missing a raw column raises KeyError naming it, and the
  scorer keeps its routes: later batches score as before (the JAX
  package switches its compiled layers off for good; ROADMAP.md
  section 3);
- `prefetch_map` keeps order and holds at most `depth` calls ahead;
- a row's linear score is the same bits in any batch.
"""

import threading

import numpy as np
import pytest
import torch

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import classification as pcls
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.ml.inference import DeviceScorer, _linear_forward
from sml_tpu_torch.parallel.pipeline import prefetch_map

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")
    PCONF.unset("sml.infer.prefetchBatches")


def _data(n=400, seed=0, nan_rate=0.1):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=n)
    x1[rng.random(n) < nan_rate] = np.nan
    return {"cat": rng.choice(["a", "b", "c", "d"], size=n).astype(object),
            "x1": x1, "x2": rng.normal(size=n),
            "label": rng.normal(size=n)}


def _pipeline(handle_invalid="keep", assembler_invalid="error",
              imputed=True):
    x = ["x1_i", "x2_i"] if imputed else ["x1", "x2"]
    stages = [pfeat.Imputer(strategy="median", inputCols=["x1", "x2"],
                            outputCols=["x1_i", "x2_i"])] if imputed else []
    return pbase.Pipeline(stages=stages + [
        pfeat.StringIndexer(inputCols=["cat"], outputCols=["cat_idx"],
                            handleInvalid=handle_invalid),
        pfeat.OneHotEncoder(inputCols=["cat_idx"], outputCols=["cat_ohe"]),
        pfeat.VectorAssembler(inputCols=["cat_ohe"] + x,
                              outputCol="features",
                              handleInvalid=assembler_invalid),
        preg.LinearRegression(labelCol="label"),
    ])


def _frame(block):
    return get_session().createDataFrame(block)


def test_scorer_uses_featurizer_and_matches_transform():
    model = _pipeline("keep").fit(_frame(_data()))
    scorer = DeviceScorer(model, device="cpu")
    assert scorer._featurizer is not None
    assert scorer._factorized is not None
    batch = _data(seed=5)
    want = model.transform(_frame(batch))._whole()["prediction"]
    np.testing.assert_allclose(scorer(batch), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(scorer(_frame(batch)), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("invalid", ["keep", "skip"])
def test_factorized_scorer_matches_block_route(invalid):
    model = _pipeline(invalid).fit(_frame(_data()))
    scorer = DeviceScorer(model, device="cpu")
    assert scorer._factorized is not None
    batch = _data(seed=8)
    batch["cat"][:5] = "ZZ_UNSEEN"
    batch["cat"][9:11] = None
    fast = scorer(batch)
    block = DeviceScorer(model, device="cpu")
    block._factorized = None  # the block route
    ref = block(batch)
    assert fast.shape == ref.shape
    if invalid == "skip":
        assert fast.shape == (len(batch["x1"]) - 7,)
    np.testing.assert_allclose(fast, ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


def test_factorized_scorer_gives_the_nan_rows():
    """No imputer and an assembler that keeps NaN: a NaN feature gives a
    NaN prediction on both routes, on the same rows."""
    model = _pipeline("keep", "keep", imputed=False).fit(
        _frame(_data(nan_rate=0.0)))
    scorer = DeviceScorer(model, device="cpu")
    assert scorer._factorized is not None
    batch = _data(seed=9, nan_rate=0.2)
    fast = scorer(batch)
    block = DeviceScorer(model, device="cpu")
    block._factorized = None
    ref = block(batch)
    assert np.isnan(fast).sum() == np.isnan(batch["x1"]).sum() > 0
    np.testing.assert_array_equal(np.isnan(fast), np.isnan(ref))
    np.testing.assert_allclose(fast, ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


def test_factorized_scorer_raises_on_nan_under_error():
    model = _pipeline("keep", "error", imputed=False).fit(
        _frame(_data(nan_rate=0.0)))
    scorer = DeviceScorer(model, device="cpu")
    with pytest.raises(ValueError, match="VectorAssembler"):
        scorer(_data(seed=9, nan_rate=0.2))
    scorer._factorized = None
    with pytest.raises(ValueError, match="VectorAssembler"):
        scorer(_data(seed=9, nan_rate=0.2))


def test_factorized_scorer_matches_jax_on_a_saved_model(spark, tmp_path):
    """A model the JAX package fitted and saved, loaded by the port: both
    packages' factorized scorers on the same batch."""
    import pandas as pd
    from sml_tpu.ml import DeviceScorer as JScorer
    from sml_tpu.ml import Pipeline as JP
    from sml_tpu.ml import feature as jfeat
    from sml_tpu.ml.regression import LinearRegression as JLR
    from sml_tpu.parallel import mesh as meshlib
    with meshlib.use_mesh(meshlib.build_mesh(1)):
        jm = JP(stages=[
            jfeat.Imputer(strategy="median", inputCols=["x1", "x2"],
                          outputCols=["x1_i", "x2_i"]),
            jfeat.StringIndexer(inputCols=["cat"], outputCols=["cat_idx"],
                                handleInvalid="keep"),
            jfeat.OneHotEncoder(inputCols=["cat_idx"],
                                outputCols=["cat_ohe"]),
            jfeat.VectorAssembler(inputCols=["cat_ohe", "x1_i", "x2_i"],
                                  outputCol="features"),
            JLR(labelCol="label")]).fit(
            spark.createDataFrame(pd.DataFrame(_data())))
        path = str(tmp_path / "lr")
        jm.save(path)
        batch = _data(seed=12)
        batch["cat"][:4] = "UNSEEN"
        want = JScorer(jm)(pd.DataFrame(batch))
    got = DeviceScorer(pbase.load(path), device="cpu")
    assert got._factorized is not None
    np.testing.assert_allclose(got(batch), want, rtol=1e-12, atol=1e-12)


def test_featurizer_rejects_unknown_stage():
    df = _frame(_data(nan_rate=0))
    model = pbase.Pipeline(stages=[
        pfeat.VectorAssembler(inputCols=["x1", "x2"], outputCol="raw"),
        pfeat.StandardScaler(inputCol="raw", outputCol="features"),
        preg.LinearRegression(labelCol="label"),
    ]).fit(df)
    scorer = DeviceScorer(model, device="cpu")
    assert scorer._featurizer is None and scorer._factorized is None
    batch = _data(seed=6, nan_rate=0)
    np.testing.assert_array_equal(
        scorer(batch),
        model.transform(_frame(batch))._whole()["prediction"])


# ------------------------------------------------ tests/test_inference.py
@pytest.fixture(scope="module")
def airbnb():
    rng = np.random.default_rng(7)
    n = 2000
    bedrooms = rng.integers(0, 5, n).astype(float)
    accommodates = (bedrooms * 2 + rng.integers(1, 3, n)).astype(float)
    price = np.round(np.exp(4.0 + 0.35 * bedrooms + 0.08 * accommodates
                            + rng.normal(0, 0.4, n)), 2)
    return {"room_type": rng.choice(["Entire home/apt", "Private room",
                                     "Shared room"], n,
                                    p=[0.6, 0.3, 0.1]).astype(object),
            "bedrooms": bedrooms,
            "bathrooms": rng.choice([1.0, 1.5, 2.0, 2.5], n),
            "accommodates": accommodates, "price": price}


FEATS = ["bedrooms", "accommodates", "bathrooms"]


@pytest.fixture(scope="module")
def fitted_lr(airbnb):
    df = _frame(airbnb)
    pipe = pbase.Pipeline(stages=[
        pfeat.VectorAssembler(inputCols=FEATS, outputCol="features"),
        preg.LinearRegression(featuresCol="features", labelCol="price"),
    ]).fit(df)
    return pipe, df


def test_device_scorer_matches_transform_linear(fitted_lr, airbnb):
    pipe, df = fitted_lr
    expected = pipe.transform(df)._whole()["prediction"]
    scorer = DeviceScorer(pipe, device="cpu")
    assert scorer._factorized is not None
    np.testing.assert_allclose(scorer(airbnb), expected, rtol=RTOL,
                               atol=ATOL)
    scorer._factorized = None
    np.testing.assert_array_equal(scorer(airbnb), expected)


def test_device_scorer_raw_block(fitted_lr):
    lr_model = fitted_lr[0].stages[-1]
    scorer = DeviceScorer(lr_model, device="cpu")
    X = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    w = lr_model.coefficients.toArray()
    np.testing.assert_allclose(scorer(X), X @ w + lr_model.intercept,
                               rtol=1e-6)


def test_device_scorer_forest(airbnb):
    df = _frame(airbnb)
    pipe = pbase.Pipeline(stages=[
        pfeat.VectorAssembler(inputCols=FEATS, outputCol="features"),
        preg.RandomForestRegressor(featuresCol="features", labelCol="price",
                                   numTrees=5, maxDepth=4, seed=42),
    ]).fit(df)
    scorer = DeviceScorer(pipe, device="cpu")
    assert scorer._featurizer is not None and scorer._factorized is None
    np.testing.assert_array_equal(
        scorer(airbnb), pipe.transform(df)._whole()["prediction"])


def test_device_scorer_logistic(airbnb):
    block = dict(airbnb)
    block["expensive"] = (airbnb["price"]
                          > np.median(airbnb["price"])).astype(float)
    df = _frame(block)
    pipe = pbase.Pipeline(stages=[
        pfeat.VectorAssembler(inputCols=["bedrooms", "accommodates"],
                              outputCol="features"),
        pcls.LogisticRegression(featuresCol="features",
                                labelCol="expensive"),
    ]).fit(df)
    want = pipe.transform(df)._whole()["probability"][:, 1]
    scorer = DeviceScorer(pipe, device="cpu")
    assert scorer._factorized is not None
    np.testing.assert_allclose(scorer(block), want, rtol=1e-6, atol=1e-9)


def _slices(block, size):
    n = len(next(iter(block.values())))
    return [{k: v[i:i + size] for k, v in block.items()}
            for i in range(0, n, size)]


@pytest.mark.parametrize("route", ["factorized", "block", "forest"])
def test_score_batches_concatenation_equals_the_whole(fitted_lr, airbnb,
                                                      route):
    pipe, df = fitted_lr
    if route == "forest":
        pipe = pbase.Pipeline(stages=[
            pfeat.VectorAssembler(inputCols=FEATS, outputCol="features"),
            preg.RandomForestRegressor(labelCol="price", numTrees=4,
                                       maxDepth=3, seed=1)]).fit(df)
    scorer = DeviceScorer(pipe, device="cpu")
    if route == "block":
        scorer._factorized = None
    assert (scorer._factorized is not None) == (route == "factorized")
    outs = list(scorer.score_batches(_slices(airbnb, 500)))
    assert len(outs) == 4
    np.testing.assert_array_equal(np.concatenate(outs), scorer(airbnb))


def test_prefetch_depth_configurable_and_overlap(fitted_lr):
    """`sml.infer.prefetchBatches` sets the lookahead, and the order
    shows batches 0-2 dispatched before batch 0 drains."""
    scorer = DeviceScorer(fitted_lr[0].stages[-1], device="cpu")
    X = np.random.default_rng(2).normal(size=(4000, 3)).astype(np.float32)
    batches = [X[i:i + 500] for i in range(0, 4000, 500)]
    PCONF.set("sml.infer.prefetchBatches", 3)
    order = []
    try:
        outs = list(scorer.score_batches(batches, order=order))
    finally:
        PCONF.unset("sml.infer.prefetchBatches")
    assert len(outs) == len(batches)
    first_drain = order.index(("drain", 0))
    ahead = {i for kind, i in order[:first_drain] if kind == "dispatch"}
    assert ahead == {0, 1, 2}
    assert [i for kind, i in order if kind == "drain"] == list(range(8))
    np.testing.assert_array_equal(np.concatenate(outs),
                                  scorer.score_block(X))


@pytest.mark.parametrize("factorized", [True, False])
def test_missing_column_mid_stream_raises_and_keeps_the_routes(
        fitted_lr, airbnb, factorized):
    pipe, _ = fitted_lr
    scorer = DeviceScorer(pipe, device="cpu")
    if not factorized:
        scorer._factorized = None
    featurizer = scorer._featurizer
    expected = scorer(airbnb)
    parts = _slices(airbnb, 500)
    bad = {k: v for k, v in parts[1].items() if k != "bathrooms"}
    # depth 1: batch 0 drains before batch 1's prep is read (deeper, the
    # error surfaces as soon as the pipeline reads batch 1's prep)
    it = scorer.score_batches(iter([parts[0], bad, parts[2]]), depth=1)
    np.testing.assert_array_equal(next(it), expected[:500])
    with pytest.raises(KeyError, match="bathrooms"):
        for _ in it:
            pass
    assert scorer._featurizer is featurizer
    assert (scorer._factorized is not None) == factorized
    outs = list(scorer.score_batches(parts))
    np.testing.assert_array_equal(np.concatenate(outs), expected)


def test_prep_keyerror_keeps_the_featurizer(airbnb):
    df = _frame(airbnb)
    pipe = pbase.Pipeline(stages=[
        pfeat.VectorAssembler(inputCols=FEATS, outputCol="features"),
        preg.RandomForestRegressor(labelCol="price", numTrees=4, maxDepth=3,
                                   seed=1)]).fit(df)
    scorer = DeviceScorer(pipe, device="cpu")
    expected = scorer(airbnb)
    with pytest.raises(KeyError, match="accommodates"):
        scorer({k: v for k, v in airbnb.items() if k != "accommodates"})
    assert scorer._featurizer is not None
    np.testing.assert_array_equal(scorer(airbnb), expected)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_map_keeps_order_and_bounds_lookahead(depth):
    lock = threading.Lock()
    pulled = []
    live = [0]
    peak = [0]
    release = threading.Event()

    def source():
        for i in range(12):
            pulled.append(i)
            yield i

    def fn(i):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        release.wait(0.01)
        with lock:
            live[0] -= 1
        return i * i

    out = []
    for k, v in enumerate(prefetch_map(source(), fn, depth=depth)):
        # at most `depth` calls submitted past the result being yielded
        assert len(pulled) - (k + 1) <= depth
        out.append(v)
    assert out == [i * i for i in range(12)]
    assert peak[0] <= depth


@pytest.mark.parametrize("width", [1, 3, 49, 65])
def test_a_rows_linear_score_does_not_depend_on_its_batch(width):
    """The block route's linear score sums each row's products in a fixed
    pairwise order: a row scores the same bits in any batch, within
    float64 rounding of X @ w + b."""
    rng = np.random.default_rng(width)
    X = torch.from_numpy(rng.normal(size=(1000, width)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=width))
    whole = _linear_forward(X, w, 1.5)
    parts = torch.cat([_linear_forward(X[i:i + 7], w, 1.5)
                       for i in range(0, 1000, 7)])
    assert torch.equal(whole, parts)
    np.testing.assert_allclose(whole.numpy(),
                               (X.double() @ w + 1.5).numpy(), rtol=1e-12,
                               atol=1e-12)
