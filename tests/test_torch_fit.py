"""The port's tree fits against the JAX package's live fits, on the CPU.

The JAX fits run with `sml.tree.kernel=xla` in the `spark` fixture's
8-device CPU mesh; the port's run with device="cpu", so its kernels'
plain versions build every histogram and split. The comparisons are
with live outputs only, never with GOLDEN.json pins.

- Builder, exact: `fit_tree` and a 1-tree `_fit_ensemble` on labels that
  are multiples of 1/8, so every histogram sum is exact in f32 in any
  order (and across the mesh's psum), with histogram subtraction (the
  port's only build, the JAX package's default). Split features and bins
  are identical; leaf values, gains and covers agree to rtol 1e-6.
- The port sums histograms, leaf statistics and the base margin in
  float64 and rounds each to f32 once, deliberately above the JAX
  package's f32 sums: the card and the CPU then fit the same trees. On
  real-valued labels the two packages' sums differ in their last f32
  bits, which is what the tolerances below allow for.
- Ensembles: DT, GBT and XGBoost fits, squared and logistic, depth <= 4,
  on real-valued labels. Round 1's split tables are identical; held-out
  predictions agree to rtol 1e-4 (histograms differ in the last bits of
  their f32 sums, which compound over boosting rounds).
- Sampled fits draw the JAX package's Threefry streams (Poisson bootstrap
  weights, Bernoulli subsample weights, per-node feature subspaces), so
  on dyadic labels every tree's split table is identical. Unboosted fits
  (random forests, a tree with a feature subspace) sum dyadic gradients
  and agree exactly, leaf values to rtol 1e-6. A boosted fit's gradients
  are not dyadic (the base margin is a mean and every round adds
  step * leaf), so its leaf values and gains differ in the last bits of
  the two packages' sums: within rtol 1e-6 plus 1e-6 of the tree's
  largest value (a leaf near zero is a difference of larger sums).
- Courseware: the ML 06 decision tree and the ML 11 XGBoost model on the
  JAX pipeline's features; held-out rmse agrees within
  max(1e-3, 1e-5*|rmse|), the golden tolerance. These JAX fits run on a
  one-device mesh, the counterpart of the port's one card: the JAX
  package's own boosted fit changes with the mesh width, which only
  reorders its f32 partial histogram sums, by more than the golden
  tolerance (`tests/test_multichip.py::test_fit_goldens_8dev_vs_1dev`).
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import tree_impl as pti
from sml_tpu_torch.xgboost import XgboostClassifier, XgboostRegressor

# The suite runs in several worker processes on one host; torch's default
# of one CPU thread per core in each would oversubscribe it and starve
# the latency-bound serving tests that share the host. Two threads fit
# these tests no slower.
torch.set_num_threads(2)


@pytest.fixture()
def confs(spark):
    """The JAX fits on the XLA path with histogram subtraction, as the
    port builds; both keys restored after each test."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    prev = {k: JCONF.get(k) for k in ("sml.tree.kernel",
                                      "sml.tree.histSubtraction")}
    JCONF.set("sml.tree.kernel", "xla")
    JCONF.set("sml.tree.histSubtraction", True)
    yield JCONF
    for k, v in prev.items():
        JCONF.set(k, v)


def _data(n=3000, f=6, seed=0, dyadic=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[::17, 2] = np.nan
    X[:, 4] = rng.integers(0, 5, n)       # a categorical slot
    y = 2 * X[:, 0] - np.nan_to_num(X[:, 1]) ** 2 + (X[:, 3] > 0) * 1.5 \
        + 0.4 * X[:, 4] + rng.normal(0, 0.3, n)
    if dyadic:
        y = np.round(y * 8) / 8
    return X, y.astype(np.float32), {4: 5}


def _assert_tables(tj, tp, exact_values: bool):
    np.testing.assert_array_equal(tp.split_feature, tj.split_feature)
    np.testing.assert_array_equal(tp.split_bin, tj.split_bin)
    if exact_values:
        for fld in ("leaf_value", "gain", "cover"):
            np.testing.assert_allclose(getattr(tp, fld), getattr(tj, fld),
                                       rtol=1e-6, err_msg=fld)


@pytest.mark.parametrize("max_bins", [32, 300])   # uint8 and uint16 bins
def test_fit_tree_exact_on_dyadic_labels(confs, max_bins):
    from sml_tpu.ml import tree_impl as jti
    from sml_tpu.ml._staging import stage_sharded
    X, y, cat = _data(dyadic=True)
    binned, _ = jti.make_bins(X, y, max_bins, cat)
    assert binned.dtype == (np.uint8 if max_bins < 256 else np.uint16)
    rng = np.random.default_rng(1)
    weight = rng.integers(0, 3, len(y)).astype(np.float32)  # zeros too
    grad, hess = -y, np.ones_like(y)
    kw = dict(max_depth=4, n_bins=max_bins, n_features=X.shape[1],
              feature_k=X.shape[1], min_instances=2, min_info_gain=0.0,
              reg_lambda=0.5, gamma=0.0)
    b_dev, _, _ = stage_sharded(binned)
    n_pad = b_dev.shape[0]
    tj = jti.fit_tree(b_dev, *(jti.stage_aligned(a, n_pad)
                               for a in (grad, hess, weight)),
                      jti.TreeSpec(**kw))
    tp = pti.fit_tree(torch.from_numpy(binned),
                      *(torch.from_numpy(a) for a in (grad, hess, weight)),
                      pti.TreeSpec(**kw))
    _assert_tables(tj, tp, exact_values=True)
    assert (tp.split_feature >= 0).sum() >= 7


@pytest.mark.parametrize("bootstrap", [False, True])
def test_one_tree_ensemble_exact_on_dyadic_labels(confs, bootstrap):
    """A bootstrap of one tree draws nothing in the JAX package (every
    row once), so the port fits it too."""
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    X, y, cat = _data(dyadic=True, seed=4)
    kw = dict(categorical=cat, max_depth=5, max_bins=24, min_instances=1,
              min_info_gain=0.0, n_trees=1, feature_k=None,
              bootstrap=bootstrap, subsample=1.0, seed=3, loss="squared")
    sj = jfit(X, y, **kw)
    sp = ptm._fit_ensemble(X, y, device="cpu", **kw)
    _assert_tables(sj.trees[0], sp.trees[0], exact_values=True)
    np.testing.assert_array_equal(sp.binning.edges, sj.binning.edges)


def _fit_both(X, y, cat, **kw):
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    kw = dict(dict(categorical=cat, max_bins=32, min_instances=1,
                   min_info_gain=0.0, feature_k=None, bootstrap=False,
                   subsample=1.0, seed=5), **kw)
    return jfit(X, y, **kw), ptm._fit_ensemble(X, y, device="cpu", **kw)


ENSEMBLES = {
    "dt_reg": dict(max_depth=4, n_trees=1, loss="squared"),
    "dt_bin": dict(max_depth=4, n_trees=1, loss="logistic"),
    "gbt_reg": dict(max_depth=3, n_trees=6, loss="squared", boosting=True,
                    step_size=0.3),
    "gbt_bin": dict(max_depth=3, n_trees=5, loss="logistic", boosting=True,
                    step_size=0.3),
    "xgb_reg": dict(max_depth=4, n_trees=6, loss="squared", boosting=True,
                    step_size=0.3, reg_lambda=1.0, gamma=0.1),
    "xgb_bin": dict(max_depth=4, n_trees=5, loss="logistic", boosting=True,
                    step_size=0.3, reg_lambda=1.0),
}


@pytest.mark.parametrize("kind", sorted(ENSEMBLES))
def test_ensemble_round_one_tables_and_predictions(confs, kind):
    X, y, cat = _data(n=4000, seed=7)
    if kind.endswith("_bin"):
        y = (y > np.median(y)).astype(np.float32)
    Xtr, ytr, Xte = X[:3000], y[:3000], X[3000:]
    sj, sp = _fit_both(Xtr, ytr, cat, **ENSEMBLES[kind])
    assert len(sp.trees) == len(sj.trees)
    _assert_tables(sj.trees[0], sp.trees[0], exact_values=False)
    assert sp.base == pytest.approx(sj.base, rel=1e-6, abs=1e-7)
    want = sj.predict_margin(Xte)
    got = sp.predict_margin(Xte, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


SAMPLED = {
    "rf_bootstrap": dict(max_depth=4, n_trees=5, bootstrap=True,
                         feature_k=2, loss="squared"),
    "rf_bootstrap_rate": dict(max_depth=4, n_trees=4, bootstrap=True,
                              subsample=0.7, feature_k=3, loss="squared"),
    "rf_classifier": dict(max_depth=4, n_trees=4, bootstrap=True,
                          feature_k=2, loss="logistic"),
    "dt_subspace": dict(max_depth=5, n_trees=1, feature_k=3,
                        loss="squared"),
    "gbt_subsample": dict(max_depth=3, n_trees=5, subsample=0.7,
                          loss="squared", boosting=True, step_size=0.5),
    "xgb_subsample": dict(max_depth=4, n_trees=5, subsample=0.7,
                          loss="squared", boosting=True, step_size=0.3,
                          reg_lambda=1.0, gamma=0.1),
}


@pytest.mark.parametrize("kind", sorted(SAMPLED))
def test_sampled_fits_give_the_jax_split_tables(confs, kind):
    X, y, cat = _data(dyadic=True, seed=4)
    if kind == "rf_classifier":
        y = (y > np.median(y)).astype(np.float32)
    kw = dict(SAMPLED[kind], max_bins=24)
    sj, sp = _fit_both(X, y, cat, **kw)
    assert len(sp.trees) == len(sj.trees) == kw["n_trees"]
    boosted = kw.get("boosting", False)
    for tj, tp in zip(sj.trees, sp.trees):
        _assert_tables(tj, tp, exact_values=not boosted)
        if boosted:
            for fld in ("leaf_value", "gain", "cover"):
                want = getattr(tj, fld)
                np.testing.assert_allclose(
                    getattr(tp, fld), want, rtol=1e-6,
                    atol=1e-6 * np.abs(want).max(), err_msg=fld)
    # the draws matter: trees of one fit differ from each other
    assert len({t.split_feature.tobytes() for t in sp.trees}) \
        == (1 if kw["n_trees"] == 1 else len(sp.trees))


def test_fit_tree_with_a_feature_key_matches_jax(confs):
    from sml_tpu.ml import tree_impl as jti
    from sml_tpu.ml._staging import stage_sharded
    X, y, cat = _data(dyadic=True, seed=6)
    binned, _ = jti.make_bins(X, y, 32, cat)
    weight = np.random.default_rng(2).integers(0, 3, len(y)) \
        .astype(np.float32)
    grad, hess = -y, np.ones_like(y)
    kw = dict(max_depth=4, n_bins=32, n_features=X.shape[1], feature_k=2,
              min_instances=1, min_info_gain=0.0, reg_lambda=0.0,
              gamma=0.0)
    b_dev, _, _ = stage_sharded(binned)
    n_pad = b_dev.shape[0]
    jargs = [jti.stage_aligned(a, n_pad) for a in (grad, hess, weight)]
    pargs = [torch.from_numpy(a) for a in (grad, hess, weight)]
    feat_key = np.asarray(_jax_key_data(11, 3), np.uint32)
    tj = jti.fit_tree(b_dev, *jargs, jti.TreeSpec(**kw), feat_key=feat_key)
    tp = pti.fit_tree(torch.from_numpy(binned), *pargs, pti.TreeSpec(**kw),
                      feat_key=feat_key)
    _assert_tables(tj, tp, exact_values=True)
    # without a key both draw from PRNGKey(rng)
    tj = jti.fit_tree(b_dev, *jargs, jti.TreeSpec(**kw), rng=5)
    tp = pti.fit_tree(torch.from_numpy(binned), *pargs, pti.TreeSpec(**kw),
                      rng=5)
    _assert_tables(tj, tp, exact_values=True)


def _jax_key_data(seed: int, data: int) -> np.ndarray:
    import jax
    return np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_estimators_raise_on_sampling_and_unknown_params():
    """Sampled estimators fit; what still raises is a Poisson rate that
    jax would draw by rejection (10 and above, not ported) and a param
    the estimator does not declare."""
    X, y, _ = _data(n=200)
    assert XgboostRegressor(subsample=0.5, n_estimators=2).fit(
        X, y, device="cpu").getNumTrees() == 2
    assert ptm.GBTRegressor(subsamplingRate=0.7, maxIter=2).fit(
        X, y, device="cpu").getNumTrees() == 2
    with pytest.raises(ValueError, match="Knuth"):
        ptm.RandomForestRegressor(numTrees=2, subsamplingRate=10.0).fit(
            X, y, device="cpu")
    with pytest.raises(TypeError):
        XgboostRegressor(numTrees=2)
    with pytest.raises(TypeError):
        ptm.DecisionTreeRegressor(numTrees=3)


def test_estimator_params_map_like_the_jax_package(confs):
    """The estimators hand `_fit_ensemble` what the JAX ones hand theirs:
    the same trees come out of both surfaces on the same rows, and the
    XGBoost `missing` value is binned as NaN."""
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    X, y, cat = _data(n=1500, seed=9)
    X[::13, 0] = -999.0
    m = XgboostRegressor(n_estimators=3, learning_rate=0.2, max_depth=3,
                         max_bins=20, reg_lambda=2.0, gamma=0.05,
                         min_child_weight=3.0, missing=-999.0).fit(
                             X, y, categorical=cat, device="cpu")
    sj = jfit(X, y, categorical=cat, max_depth=3, max_bins=20,
              min_instances=3, min_info_gain=0.0, n_trees=3, feature_k=None,
              bootstrap=False, subsample=1.0, seed=0, loss="squared",
              step_size=0.2, reg_lambda=2.0, gamma=0.05, boosting=True,
              missing=-999.0)
    _assert_tables(sj.trees[0], m._spec.trees[0], exact_values=False)
    np.testing.assert_array_equal(m._spec.tree_weights, sj.tree_weights)
    assert isinstance(m, XgboostRegressor._model_cls)
    d = ptm.DecisionTreeClassifier(maxDepth=3, maxBins=16).fit(
        X, (y > 0).astype(float), device="cpu")
    assert d.getNumTrees() == 1 and d._spec.mode == "binary"
    assert d.featureImportances.toArray().sum() == pytest.approx(1.0)
    c = XgboostClassifier(n_estimators=2, max_depth=2).fit(
        X, (y > 0).astype(float), device="cpu")
    p = c.predict_probability(X[:50], device="cpu")
    assert ((p > 0) & (p < 1)).all()


def test_random_forest_params_map_like_the_jax_package(confs):
    """The forest estimators hand `_fit_ensemble` what the JAX ones hand
    theirs (numTrees, the strategy's feature count, bootstrap,
    subsamplingRate, seed 17 by default, squared or logistic loss): the
    same trees come out of both surfaces on the same rows."""
    from sml_tpu.ml._tree_models import _feature_k, _fit_ensemble as jfit
    X, y, cat = _data(n=1500, seed=9, dyadic=True)
    label = (y > np.median(y)).astype(float)
    m = ptm.RandomForestClassifier(numTrees=3, maxDepth=3, maxBins=20,
                                   subsamplingRate=0.8).fit(
        X, label, categorical=cat, device="cpu")
    sj = jfit(X, label, categorical=cat, max_depth=3, max_bins=20,
              min_instances=1, min_info_gain=0.0, n_trees=3,
              feature_k=_feature_k("auto", X.shape[1], True),
              bootstrap=True, subsample=0.8, seed=17, loss="logistic")
    assert isinstance(m, ptm.RandomForestClassificationModel)
    assert m._spec.mode == "binary" and m._spec.tree_weights is None
    for tj, tp in zip(sj.trees, m._spec.trees):
        _assert_tables(tj, tp, exact_values=True)
    p = m.predict_probability(X[:50], device="cpu")
    assert ((p >= 0) & (p <= 1)).all()
    r = ptm.RandomForestRegressor(numTrees=2, maxDepth=3, maxBins=20,
                                  featureSubsetStrategy="sqrt",
                                  seed=4).fit(X, y, categorical=cat,
                                              device="cpu")
    sj = jfit(X, y, categorical=cat, max_depth=3, max_bins=20,
              min_instances=1, min_info_gain=0.0, n_trees=2,
              feature_k=_feature_k("sqrt", X.shape[1], False),
              bootstrap=True, subsample=1.0, seed=4, loss="squared")
    assert isinstance(r, ptm.RandomForestRegressionModel)
    assert r.getOrDefault("numTrees") == 2 and \
        r.getOrDefault("subsamplingRate") == 1.0
    for tj, tp in zip(sj.trees, r._spec.trees):
        _assert_tables(tj, tp, exact_values=True)


@pytest.mark.parametrize("strategy", ["auto", "all", "sqrt", "log2",
                                      "onethird", "0.5", "3"])
def test_feature_k_matches_jax(strategy):
    from sml_tpu.ml._tree_models import _feature_k
    for F, cls in ((10, True), (10, False), (7, True)):
        assert ptm._feature_k(strategy, F, cls) == _feature_k(strategy, F,
                                                               cls)


def test_feature_importances_match_jax(confs):
    from sml_tpu.ml.tree_impl import feature_importances
    X, y, cat = _data(n=1500, seed=2)
    sj, sp = _fit_both(X, y, cat, max_depth=3, n_trees=3, loss="squared",
                       boosting=True, step_size=0.3)
    np.testing.assert_allclose(pti.feature_importances(sp.trees, 6),
                               feature_importances(sj.trees, 6), rtol=1e-5)


# ------------------------------------------------------------ courseware
@pytest.fixture(scope="module")
def airbnb(spark):
    """ML 06 / ML 11 features from the JAX pipeline (Imputer,
    StringIndexer, VectorAssembler) on the course's synthetic Airbnb
    rows, split 80/20, as numpy arrays with the categorical map."""
    from sml_tpu import functions as F
    from sml_tpu.courseware import make_airbnb_dataset
    from sml_tpu.ml import Pipeline
    from sml_tpu.ml._staging import extract_xy
    from sml_tpu.ml._tree_models import _categorical_slots
    from sml_tpu.ml.feature import Imputer, StringIndexer, VectorAssembler
    CAT = ["neighbourhood_cleansed", "room_type", "property_type"]
    NUM = ["accommodates", "bathrooms", "bedrooms", "beds",
           "minimum_nights", "number_of_reviews", "review_scores_rating"]
    df = spark.createDataFrame(make_airbnb_dataset(n=20_000, seed=42))
    train, test = df.randomSplit([0.8, 0.2], seed=42)
    train = train.withColumn("label", F.log(F.col("price")))
    test = test.withColumn("label", F.log(F.col("price")))
    idx = [c + "_idx" for c in CAT]
    imp = [c + "_imp" for c in NUM]
    prep = Pipeline(stages=[
        Imputer(strategy="median", inputCols=NUM, outputCols=imp),
        StringIndexer(inputCols=CAT, outputCols=idx, handleInvalid="skip"),
        VectorAssembler(inputCols=idx + imp, outputCol="features")]).fit(train)
    out = {}
    for name, part in (("train", train), ("test", test)):
        feats = prep.transform(part)
        X, price, _ = extract_xy(feats, "features", "price")
        _, logp, _ = extract_xy(feats, "features", "label")
        out[name] = (np.asarray(X, np.float64), price, logp)
    out["cat"] = _categorical_slots(prep.transform(train), "features")
    return out


def _rmse(pred, label):
    return float(np.sqrt(np.mean((np.asarray(pred, np.float64)
                                  - np.asarray(label, np.float64)) ** 2)))


def _close_rmse(got, want):
    assert abs(got - want) <= max(1e-3, 1e-5 * abs(want)), (got, want)


def _one_device_fit(X, y, **kw):
    """The JAX package's `_fit_ensemble` on a one-device mesh."""
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    from sml_tpu.parallel import mesh as meshlib
    with meshlib.use_mesh(meshlib.build_mesh(1)):
        return jfit(X, y, **kw)


def test_ml06_decision_tree_rmse_matches_jax(confs, airbnb):
    (Xtr, ptr, _), (Xte, pte, _) = airbnb["train"], airbnb["test"]
    kw = dict(categorical=airbnb["cat"], max_depth=5, max_bins=40,
              min_instances=1, min_info_gain=0.0, n_trees=1, feature_k=None,
              bootstrap=False, subsample=1.0, seed=17, loss="squared")
    sj = _one_device_fit(Xtr, ptr, **kw)
    model = ptm.DecisionTreeRegressor(maxDepth=5, maxBins=40).fit(
        Xtr, ptr, categorical=airbnb["cat"], device="cpu")
    _assert_tables(sj.trees[0], model._spec.trees[0], exact_values=False)
    _close_rmse(_rmse(model.predict(Xte, device="cpu"), pte),
                _rmse(sj.predict_margin(Xte), pte))


def test_ml11_xgboost_rmse_matches_jax(confs, airbnb):
    (Xtr, _, ltr), (Xte, pte, _) = airbnb["train"], airbnb["test"]
    sj = _one_device_fit(
        Xtr, ltr, categorical=airbnb["cat"], max_depth=6, max_bins=64,
        min_instances=1, min_info_gain=0.0, n_trees=40, feature_k=None,
        bootstrap=False, subsample=1.0, seed=42, loss="squared",
        step_size=0.15, reg_lambda=1.0, gamma=0.0, boosting=True,
        missing=float("nan"))
    model = XgboostRegressor(n_estimators=40, learning_rate=0.15,
                             max_depth=6, max_bins=64, random_state=42).fit(
        Xtr, ltr, categorical=airbnb["cat"], device="cpu")
    got = _rmse(np.exp(model.predict(Xte, device="cpu")), pte)
    want = _rmse(np.exp(sj.predict_margin(Xte)), pte)
    _close_rmse(got, want)
    same = sum(np.array_equal(a.split_feature, b.split_feature)
               and np.array_equal(a.split_bin, b.split_bin)
               for a, b in zip(model._spec.trees, sj.trees))
    assert same >= 20, f"{same} of 40 trees share their split tables"


def test_ml07_random_forest_rmse_matches_jax(confs, airbnb):
    from sml_tpu.ml._tree_models import _feature_k
    (Xtr, ptr, _), (Xte, pte, _) = airbnb["train"], airbnb["test"]
    sj = _one_device_fit(
        Xtr, ptr, categorical=airbnb["cat"], max_depth=6, max_bins=40,
        min_instances=1, min_info_gain=0.0, n_trees=20,
        feature_k=_feature_k("auto", Xtr.shape[1], False), bootstrap=True,
        subsample=1.0, seed=42, loss="squared")
    model = ptm.RandomForestRegressor(maxDepth=6, numTrees=20, maxBins=40,
                                      seed=42).fit(
        Xtr, ptr, categorical=airbnb["cat"], device="cpu")
    got = _rmse(model.predict(Xte, device="cpu"), pte)
    want = _rmse(sj.predict_margin(Xte), pte)
    _close_rmse(got, want)
    same = sum(np.array_equal(a.split_feature, b.split_feature)
               and np.array_equal(a.split_bin, b.split_bin)
               for a, b in zip(model._spec.trees, sj.trees))
    assert same >= 10, f"{same} of 20 trees share their split tables"
