"""The port's ALS against the JAX package's live one, on the CPU.

`make_movielens_dataset` gives the JAX package's pandas rows, bit for
bit and in its order after the dedup, and the MLlib-style init is its
draws, so a fit of `maxIter=0` returns bit-equal factors. The fit then
differs only in precision: the port's prefix sums and solves are float64
(the factors rounded to f32 after each half-step), the JAX package's
stats are f32 under a double-single prefix, and its solves f32.
Measured at the golden suite's shape (1,000 users, 400 items, 5,000
ratings, rank 8, 10 iterations): factors within 1.1e-5 absolute,
held-out rmse equal to 1e-7 relative (held here to 1e-6). Against a
dense float64 numpy ALS with the same init and the same f32 rounding,
predictions agree within 1e-5.
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.courseware import make_movielens_dataset
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml.evaluation import RegressionEvaluator
from sml_tpu_torch.ml.recommendation import (ALS, PREFIX_BLOCK, ALSModel,
                                             als_init, segment_prefix)

GOLDEN = dict(userCol="userId", itemCol="movieId", ratingCol="rating",
              rank=8, maxIter=10, regParam=0.1, seed=42,
              coldStartStrategy="drop")


def _one_device():
    from sml_tpu.parallel import mesh as meshlib
    return meshlib.use_mesh(meshlib.build_mesh(1))


@pytest.fixture(scope="module")
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")


@pytest.mark.parametrize("args", [(1000, 400, 5000, 42), (50, 20, 3000, 3),
                                  (6040, 3700, 20_000, 7)])
def test_movielens_rows_bit_equal(args):
    from sml_tpu.courseware import make_movielens_dataset as jmake
    want = jmake(*args)
    got = make_movielens_dataset(*args)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c].to_numpy())
    pairs = got["userId"] * args[1] + got["movieId"]
    assert len(np.unique(pairs)) == len(pairs) < args[2]


@pytest.fixture(scope="module")
def golden(spark, port_device):
    """Both packages' golden-suite ALS: (model, held-out rmse, train,
    test) each."""
    from sml_tpu.courseware import make_movielens_dataset as jmake
    from sml_tpu.ml.evaluation import RegressionEvaluator as JRE
    from sml_tpu.ml.recommendation import ALS as JALS
    args = (1000, 400, 100_000, 42)
    with _one_device():
        jtr, jte = spark.createDataFrame(jmake(*args)).randomSplit(
            [0.8, 0.2], seed=42)
        jm = JALS(**GOLDEN).fit(jtr)
        jrmse = JRE(labelCol="rating").evaluate(jm.transform(jte))
    ptr, pte = get_session().createDataFrame(
        make_movielens_dataset(*args)).randomSplit([0.8, 0.2], seed=42)
    pm = ALS(**GOLDEN).fit(ptr)
    prmse = RegressionEvaluator(labelCol="rating").evaluate(
        pm.transform(pte))
    return (jm, jrmse, jtr, jte), (pm, prmse, ptr, pte)


def test_golden_als_matches_jax(golden):
    (jm, jrmse, _, jte), (pm, prmse, ptr, pte) = golden
    np.testing.assert_array_equal(pm._user_ids, jm._user_ids)
    np.testing.assert_array_equal(pm._item_ids, jm._item_ids)
    assert pm._uf.dtype == pm._if.dtype == np.float32
    np.testing.assert_allclose(pm._uf, jm._uf, rtol=0, atol=5e-5)
    np.testing.assert_allclose(pm._if, jm._if, rtol=0, atol=5e-5)
    assert prmse == pytest.approx(jrmse, rel=1e-6)
    assert pm.rank == 8
    # MLE 01's baseline: the training mean rating
    mean = float(np.mean(ptr._whole()["rating"]))
    kept = pm.transform(pte)._whole()["rating"]
    assert prmse < 0.8 * float(np.sqrt(np.mean((kept - mean) ** 2)))


def test_init_bit_equal(spark, port_device):
    from sml_tpu.ml.recommendation import ALS as JALS
    import pandas as pd
    cols = make_movielens_dataset(300, 120, 2000, 5)
    kw = dict(GOLDEN, maxIter=0, rank=5, seed=11)
    with _one_device():
        jm = JALS(**kw).fit(spark.createDataFrame(pd.DataFrame(cols)))
    pm = ALS(**kw).fit(get_session().createDataFrame(cols))
    np.testing.assert_array_equal(pm._uf, np.asarray(jm._uf))
    np.testing.assert_array_equal(pm._if, np.asarray(jm._if))
    uf0, if0 = als_init(np.random.default_rng(11), len(pm._user_ids),
                        len(pm._item_ids), 5)
    np.testing.assert_array_equal(uf0, pm._uf)
    np.testing.assert_array_equal(if0, pm._if)


def test_matches_a_dense_float64_reference(port_device):
    """The sorted-segment fit against a dense float64 numpy ALS with the
    same init draws and the same f32 rounding of each half-step's
    factors (`tests/test_clustering_als.py`'s reference)."""
    rng = np.random.default_rng(3)
    n, U, I, r, reg, iters = 40_000, 50, 40, 4, 0.1, 6
    u = rng.integers(0, U, n)
    i = rng.integers(0, I, n)
    rat = rng.integers(1, 6, n).astype(float)
    df = get_session().createDataFrame({"user": u, "item": i,
                                        "rating": rat})
    model = ALS(userCol="user", itemCol="item", ratingCol="rating", rank=r,
                maxIter=iters, regParam=reg, seed=9).fit(df)
    uf_ref, if_ref = (a.astype(np.float64) for a in
                      als_init(np.random.default_rng(9), U, I, r))

    def half(ids, other_rows, n_out):
        sol = np.zeros((n_out, r))
        for e in range(n_out):
            m = ids == e
            F = other_rows[m]
            A = F.T @ F + reg * max(m.sum(), 1) * np.eye(r)
            if m.sum():
                sol[e] = np.linalg.solve(A, F.T @ rat[m])
        return sol.astype(np.float32).astype(np.float64)

    for _ in range(iters):
        uf_ref = half(u, if_ref[i], U)
        if_ref = half(i, uf_ref[u], I)
    pred = (model._uf[u].astype(np.float64) * model._if[i]).sum(1)
    pred_ref = (uf_ref[u] * if_ref[i]).sum(1)
    np.testing.assert_allclose(pred, pred_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [0, 1, PREFIX_BLOCK - 1, PREFIX_BLOCK,
                               3 * PREFIX_BLOCK + 17])
def test_segment_prefix_is_the_running_sum(n):
    rng = np.random.default_rng(n)
    n_pad = -(-n // PREFIX_BLOCK) * PREFIX_BLOCK
    stats = np.zeros((n_pad, 5))
    stats[:n] = rng.normal(size=(n, 5))
    got = segment_prefix(torch.from_numpy(stats), n).numpy()
    assert got.shape == (n + 1, 5)
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got[1:], np.cumsum(stats[:n], axis=0),
                               rtol=1e-12, atol=1e-12)


def test_cold_start_nan_and_drop(golden):
    _, (pm, _, _, _) = golden
    frame = get_session().createDataFrame(
        {"userId": np.asarray([9999, int(pm._user_ids[0]),
                               int(pm._user_ids[1])]),
         "movieId": np.asarray([int(pm._item_ids[0]), 99_999,
                                int(pm._item_ids[2])]),
         "rating": np.asarray([3.0, 4.0, 5.0])})
    out = pm.copy({pm.getParam("coldStartStrategy"): "nan"}).transform(
        frame)._whole()["prediction"]
    assert np.isnan(out[:2]).all() and np.isfinite(out[2])
    assert out[2] == pytest.approx(float(np.dot(pm._uf[1], pm._if[2])),
                                   rel=1e-6)
    kept = pm.transform(frame)._whole()
    assert kept["prediction"].shape == (1,) and kept["rating"][0] == 5.0
    assert pm.setColdStartStrategy("drop") is pm


def _recs(frame, id_col):
    block = frame._whole()
    return {int(k): [(r["id"], r["rating"]) for r in v]
            for k, v in zip(block[id_col], block["recommendations"])}


def _jax_recs(frame, id_col):
    pdf = frame.toPandas()
    return {int(k): [(r["id"], r["rating"]) for r in v]
            for k, v in zip(pdf[id_col], pdf["recommendations"])}


def test_recommendations_match_jax(golden, tmp_path):
    from sml_tpu.ml.base import load_native as jload
    _, (pm, _, ptr, _) = golden
    pm.save(str(tmp_path / "als"))
    jm = jload(str(tmp_path / "als"))
    got = _recs(pm.recommendForAllUsers(5), "userId")
    assert got == _jax_recs(jm.recommendForAllUsers(5), "userId")
    assert len(got) == len(pm._user_ids)
    for recs in list(got.values())[:20]:
        assert len(recs) == 5
        assert [s for _, s in recs] == sorted((s for _, s in recs),
                                              reverse=True)
    assert _recs(pm.recommendForAllItems(3), "movieId") == \
        _jax_recs(jm.recommendForAllItems(3), "movieId")
    subset = get_session().createDataFrame(
        {"userId": pm._user_ids[[4, 2, 4, 9]]})
    import pandas as pd
    from sml_tpu import TpuSession
    jsub = TpuSession.builder.getOrCreate().createDataFrame(
        pd.DataFrame({"userId": pm._user_ids[[4, 2, 4, 9]]}))
    sub = _recs(pm.recommendForUserSubset(subset, 4), "userId")
    assert sorted(sub) == sorted(int(x) for x in pm._user_ids[[2, 4, 9]])
    assert sub == _jax_recs(jm.recommendForUserSubset(jsub, 4), "userId")


def test_factor_frames(golden):
    _, (pm, _, _, _) = golden
    users = pm.userFactors._whole()
    np.testing.assert_array_equal(users["id"], pm._user_ids)
    assert users["features"].dtype == np.float64
    np.testing.assert_array_equal(users["features"], pm._uf)
    items = pm.itemFactors
    assert items.count() == len(pm._item_ids)
    row = items.first()
    np.testing.assert_array_equal(row["features"].toArray(), pm._if[0])


def test_cross_validation_over_rank_matches_jax(spark, port_device):
    import pandas as pd
    from sml_tpu.ml.evaluation import RegressionEvaluator as JRE
    from sml_tpu.ml.recommendation import ALS as JALS
    from sml_tpu.ml.tuning import CrossValidator as JCV
    from sml_tpu.ml.tuning import ParamGridBuilder as JPG
    from sml_tpu_torch.ml import CrossValidator, ParamGridBuilder
    cols = make_movielens_dataset(200, 80, 3000, 13)
    kw = dict(GOLDEN, maxIter=5)

    def cv(est, grid_builder, validator, evaluator, df):
        grid = grid_builder().addGrid(est.getParam("rank"), [2, 4]).build()
        return validator(estimator=est, estimatorParamMaps=grid,
                         evaluator=evaluator(labelCol="rating"),
                         numFolds=3, seed=42).fit(df)

    with _one_device():
        jcv = cv(JALS(**kw), JPG, JCV, JRE,
                 spark.createDataFrame(pd.DataFrame(cols)))
    pcv = cv(ALS(**kw), ParamGridBuilder, CrossValidator,
             RegressionEvaluator, get_session().createDataFrame(cols))
    np.testing.assert_allclose(pcv.avgMetrics, jcv.avgMetrics, rtol=1e-5)
    assert type(pcv.bestModel) is ALSModel
    assert pcv.bestModel.rank == jcv.bestModel.rank


def test_models_saved_by_either_package_load_in_both(golden, tmp_path):
    from sml_tpu.ml.base import load_native as jload
    (jm, _, _, jte), (pm, _, _, pte) = golden
    pm.save(str(tmp_path / "port"))
    back = pbase.load(str(tmp_path / "port"))
    assert type(back) is ALSModel and back.rank == pm.rank
    np.testing.assert_array_equal(back._uf, pm._uf)
    np.testing.assert_array_equal(
        back.transform(pte)._whole()["prediction"],
        pm.transform(pte)._whole()["prediction"])
    in_jax = jload(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(in_jax._if), pm._if)
    assert in_jax.getOrDefault("coldStartStrategy") == "drop"
    jm.save(str(tmp_path / "jax"))
    from_jax = pbase.load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(from_jax._uf, np.asarray(jm._uf))
    np.testing.assert_allclose(
        from_jax.transform(pte)._whole()["prediction"],
        jm.transform(jte).toPandas()["prediction"].to_numpy(), rtol=1e-6)
