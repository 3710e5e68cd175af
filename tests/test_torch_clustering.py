"""The port's KMeans against the JAX package's live one, on the CPU.

The initial centers are the JAX package's host seeding draw for draw,
so they are bit-equal (a fit of `maxIter=0` returns them). Lloyd's loop
then differs only in precision: the port's distances and cluster sums
are float64 with the centers rounded to f32 each iteration, the JAX
package's are f32. Measured at these sizes: centers within 5e-6 of the
largest |coordinate| (2.4e-6 absolute on blobs at 5), training cost
within rtol 2e-5 (the JAX package's f32 expansion |x|² - 2x·c + |c|²
cancels: 4e-6 on the blobs), and on the golden suite's shape (5,000
rows, k = 3 and 8) no assignment differs.
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml.clustering import (BisectingKMeans, KMeans,
                                         KMeansModel, kmeans_init, lloyd)

NUM = ["accommodates", "bathrooms", "bedrooms", "beds", "minimum_nights",
       "number_of_reviews", "review_scores_rating"]
IMP = [c + "_imp" for c in NUM]


def _one_device():
    from sml_tpu.parallel import mesh as meshlib
    return meshlib.use_mesh(meshlib.build_mesh(1))


@pytest.fixture(scope="module")
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


def _blobs():
    rng = np.random.default_rng(221)
    centers = np.array([[0.0, 0.0], [5.0, 5.0], [0.0, 6.0]])
    return np.concatenate([c + rng.normal(0, 0.4, (200, 2))
                           for c in centers])


@pytest.fixture(scope="module")
def blob_frames(spark, port_device):
    import pandas as pd
    from sml_tpu.ml.feature import VectorAssembler as JVA
    X = _blobs()
    jdf = JVA(inputCols=["x", "y"], outputCol="features").transform(
        spark.createDataFrame(pd.DataFrame({"x": X[:, 0], "y": X[:, 1]})))
    pdf = pfeat.VectorAssembler(inputCols=["x", "y"],
                                outputCol="features").transform(
        get_session().createDataFrame({"x": X[:, 0], "y": X[:, 1]}))
    return jdf, pdf


@pytest.fixture(scope="module")
def golden_frames(spark, port_device):
    """MLE 02's features as the golden suite builds them: the 7 imputed
    numerics of the 80% split of 5,000 listings."""
    from sml_tpu.courseware import make_airbnb_dataset as jmake
    from sml_tpu.ml import Pipeline as JP
    from sml_tpu.ml.feature import Imputer as JI
    from sml_tpu.ml.feature import VectorAssembler as JVA

    def feats(Pipeline, Imputer, VA, df):
        train, _ = df.randomSplit([0.8, 0.2], seed=42)
        return Pipeline(stages=[
            Imputer(strategy="median", inputCols=NUM, outputCols=IMP),
            VA(inputCols=IMP, outputCol="features")]).fit(train).transform(
                train).cache()

    with _one_device():
        jdf = feats(JP, JI, JVA, spark.createDataFrame(jmake(n=5000,
                                                             seed=42)))
    pdf = feats(pbase.Pipeline, pfeat.Imputer, pfeat.VectorAssembler,
                get_session().createDataFrame(make_airbnb_dataset(
                    n=5000, seed=42)))
    return jdf, pdf


def _jax_kmeans(df, **kw):
    from sml_tpu.ml.clustering import KMeans as JK
    with _one_device():
        return JK(**kw).fit(df)


def _centers(model) -> np.ndarray:
    return np.stack([np.asarray(c) for c in model.clusterCenters()])


@pytest.mark.parametrize("k, seed", [(3, 221), (8, 221), (5, None)])
def test_initial_centers_bit_equal(golden_frames, k, seed):
    jdf, pdf = golden_frames
    want = _centers(_jax_kmeans(jdf, k=k, maxIter=0, seed=seed))
    got = _centers(KMeans(k=k, maxIter=0, seed=seed).fit(pdf))
    np.testing.assert_array_equal(got, want)
    from sml_tpu_torch.ml._staging import extract_features
    init = kmeans_init(extract_features(pdf, "features"), k, seed)
    assert init.dtype == np.float32
    np.testing.assert_array_equal(init.astype(np.float64), want)


@pytest.mark.parametrize("max_iter", [1, 5, 20])
def test_blobs_match_jax(blob_frames, max_iter):
    jdf, pdf = blob_frames
    jm = _jax_kmeans(jdf, k=3, seed=221, maxIter=max_iter)
    pm = KMeans(k=3, seed=221, maxIter=max_iter).fit(pdf)
    want, got = _centers(jm), _centers(pm)
    assert np.max(np.abs(got - want)) <= 5e-6 * np.max(np.abs(want))
    assert pm.summary.trainingCost == pytest.approx(
        jm.summary.trainingCost, rel=2e-5)
    assert pm.summary.k == 3
    true = np.array([[0, 0], [5, 5], [0, 6]], dtype=float)
    if max_iter == 20:
        for t in true:
            assert np.min(np.linalg.norm(got - t, axis=1)) < 0.3
    labels = pm.transform(pdf)._whole()["prediction"]
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(
        labels, jm.transform(jdf).toPandas()["prediction"].to_numpy())


@pytest.mark.parametrize("k", [3, 8])
def test_golden_kmeans_matches_jax(golden_frames, k):
    jdf, pdf = golden_frames
    jm = _jax_kmeans(jdf, k=k, maxIter=20, seed=221)
    pm = KMeans(k=k, maxIter=20, seed=221).fit(pdf)
    want, got = _centers(jm), _centers(pm)
    assert np.max(np.abs(got - want)) <= 5e-6 * np.max(np.abs(want))
    assert pm.summary.trainingCost == pytest.approx(
        jm.summary.trainingCost, rel=2e-5)
    flips = int(np.sum(
        pm.transform(pdf)._whole()["prediction"]
        != jm.transform(jdf).toPandas()["prediction"].to_numpy()))
    assert flips == 0


def _numpy_lloyd(X, init, max_iter):
    """Lloyd's loop in float64 numpy with the port's rounding: centers to
    f32 each iteration, an empty cluster keeping its center."""
    X = X.astype(np.float64)
    centers = init.astype(np.float64)
    for _ in range(max_iter):
        d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = np.argmin(d2, axis=1)
        for j in range(len(centers)):
            m = assign == j
            if m.any():
                centers[j] = np.float32(X[m].sum(0) / m.sum())
    cost = np.min(((X[:, None, :] - centers[None]) ** 2).sum(-1), 1).sum()
    return centers.astype(np.float32), cost


def test_empty_cluster_keeps_its_center():
    """A center no point is nearest to stays where it is, in the port,
    in the JAX package's program and in a numpy loop."""
    import jax
    from sml_tpu.ml._staging import cached_data_parallel, stage_sharded
    from sml_tpu.ml.clustering import _lloyd_program
    X = _blobs().astype(np.float32)
    init = np.array([[0, 0], [5, 5], [0, 6], [100, 100]], np.float32)
    got, cost = lloyd(torch.from_numpy(X), init, 10)
    np.testing.assert_array_equal(got[3], init[3])
    with _one_device():
        Xd, mask, _ = stage_sharded(X)
        prog = cached_data_parallel(_lloyd_program(4, 10),
                                    replicated_argnums=(2,))
        want, jcost = jax.device_get(prog(Xd, mask, init))
    np.testing.assert_array_equal(np.asarray(want)[3], init[3])
    assert np.max(np.abs(got - want)) <= 5e-6 * np.max(np.abs(want[:3]))
    assert cost == pytest.approx(float(jcost), rel=2e-5)
    ref, ref_cost = _numpy_lloyd(X, init, 10)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert cost == pytest.approx(ref_cost, rel=1e-6)


def test_compute_cost_matches_jax(blob_frames, tmp_path):
    from sml_tpu.ml.clustering import KMeansModel as JKM
    jdf, pdf = blob_frames
    pm = KMeans(k=3, seed=7, maxIter=10).fit(pdf)
    pm.save(str(tmp_path / "km"))
    jm = JKM.load(str(tmp_path / "km"))
    got = pm.computeCost(pdf)
    assert got == jm.computeCost(jdf)
    X = np.asarray(pdf._whole()["features"], np.float32)
    d2 = ((X[:, None, :] - pm._centers[None]) ** 2).sum(-1)
    assert got == float(np.min(d2, axis=1).sum())
    assert got == pytest.approx(pm.summary.trainingCost, rel=1e-5)


def test_models_saved_by_either_package_load_in_both(blob_frames, tmp_path):
    from sml_tpu.ml.base import load_native as jload
    jdf, pdf = blob_frames
    pm = KMeans(k=3, seed=3, maxIter=5, predictionCol="c").fit(pdf)
    pm.save(str(tmp_path / "port"))
    for back in (pbase.load(str(tmp_path / "port")),
                 KMeansModel.load(str(tmp_path / "port"))):
        assert type(back) is KMeansModel
        np.testing.assert_array_equal(_centers(back), _centers(pm))
        assert back.summary.trainingCost == pm.summary.trainingCost
        assert back.getOrDefault("predictionCol") == "c"
    in_jax = jload(str(tmp_path / "port"))
    np.testing.assert_array_equal(_centers(in_jax), _centers(pm))
    jm = _jax_kmeans(jdf, k=3, seed=3, maxIter=5)
    jm.save(str(tmp_path / "jax"))
    from_jax = pbase.load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(_centers(from_jax), _centers(jm))
    np.testing.assert_array_equal(
        from_jax.transform(pdf)._whole()["prediction"],
        jm.transform(jdf).toPandas()["prediction"].to_numpy())


def test_bisecting_kmeans_trains_plain_kmeans(blob_frames):
    _, pdf = blob_frames
    a = BisectingKMeans(k=3, seed=5, maxIter=7).fit(pdf)
    b = KMeans(k=3, seed=5, maxIter=7).fit(pdf)
    assert type(a) is KMeansModel
    np.testing.assert_array_equal(_centers(a), _centers(b))
