"""The port's scoring path against the JAX package's, on the CPU.

`DeviceScorer(..., device="cpu").score_block` is held against the JAX
`DeviceScorer.score_block` for regression and binary models (sigmoid
finalize for boosted margins, clip for probability-leaf forests); the
five statistics of `forest_eval_fn` (identity and exp links) against the
JAX `forest_eval_fn` run through `run_data_parallel`; the metrics
through both packages' `_reg_metric`.

Tolerances: margins and predictions rtol=1e-5, atol=1e-5*max|margin|
(the f32 sum over trees runs in another order); the five statistics and
the metrics rtol=1e-5 (f32 sums in another order).
"""

import types

import numpy as np
import pytest
import torch

from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import evaluation as pev
from sml_tpu_torch.ml import inference as pinf

RTOL = 1e-5


def _data(n=2000, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[::19, 4] = np.nan
    y = (1.5 + 0.8 * X[:, 0] - 0.5 * np.nan_to_num(X[:, 4]) ** 2
         + 0.3 * X[:, 2] + rng.normal(0, 0.2, n))
    return X, y


def _carry(spec):
    """The JAX spec's saved arrays, carried into the port."""
    sf, sb, lv, w = spec.stacked()
    keys = sorted(spec.binning.cat_remap)
    return ptm.spec_from_arrays(dict(
        split_feature=np.asarray(sf), split_bin=np.asarray(sb),
        leaf_value=np.asarray(lv), gain=np.zeros_like(lv),
        cover=np.zeros_like(lv), edges=spec.binning.edges,
        tree_weights=(spec.tree_weights if spec.tree_weights is not None
                      else np.zeros(0)),
        scalars=np.asarray([spec.depth, spec.base, spec.n_features,
                            1.0 if spec.mode == "binary" else 0.0,
                            len(keys)], dtype=np.float64),
        remap_slots=np.asarray(keys, np.int64),
        **{f"remap_{k}": spec.binning.cat_remap[k] for k in keys}))


@pytest.fixture(scope="module")
def specs(spark):
    from sml_tpu.ml._tree_models import _fit_ensemble
    X, y = _data()
    y32 = y.astype(np.float32)
    yb = (y > np.median(y)).astype(np.float32)
    common = dict(categorical={}, max_bins=32, min_instances=1,
                  min_info_gain=0.0, seed=5)
    out = {
        "rf_reg": _fit_ensemble(X, y32, max_depth=4, n_trees=5, feature_k=3,
                                bootstrap=True, subsample=1.0,
                                loss="squared", **common),
        "xgb_reg": _fit_ensemble(X, y32, max_depth=4, n_trees=6,
                                 feature_k=None, bootstrap=False,
                                 subsample=1.0, loss="squared",
                                 boosting=True, reg_lambda=1.0, **common),
        "xgb_bin": _fit_ensemble(X, yb, max_depth=3, n_trees=5,
                                 feature_k=None, bootstrap=False,
                                 subsample=1.0, loss="logistic",
                                 boosting=True, **common),
        "rf_bin": _fit_ensemble(X, yb, max_depth=4, n_trees=4, feature_k=3,
                                bootstrap=True, subsample=1.0,
                                loss="logistic", **common),
    }
    return out


def _close(got, want, scale=None):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("kind", ["rf_reg", "xgb_reg", "xgb_bin", "rf_bin"])
def test_score_block_matches_jax(specs, kind):
    from sml_tpu.ml.inference import DeviceScorer as JaxScorer
    X, _ = _data(n=1500, seed=11)
    spec = specs[kind]
    want = JaxScorer(types.SimpleNamespace(_spec=spec)).score_block(X)
    port = _carry(spec)
    got = pinf.DeviceScorer(types.SimpleNamespace(_spec=port),
                            device="cpu").score_block(X)
    assert got.shape == want.shape and got.dtype == np.float64
    if spec.mode == "binary":
        assert np.all((got >= 0.0) & (got <= 1.0))
    # the tolerance is stated on the margin's scale
    margin = port.predict_margin(X, device="cpu")
    _close(got, want, scale=np.abs(margin).max())


def test_binary_finalize_kinds(specs):
    """Boosted binary models go through the sigmoid, probability-leaf
    forests clip."""
    assert specs["xgb_bin"].tree_weights is not None
    assert specs["rf_bin"].tree_weights is None
    X, _ = _data(n=300, seed=12)
    for kind, fin in (("xgb_bin", lambda m: 1 / (1 + np.exp(-m))),
                      ("rf_bin", lambda m: np.clip(m, 0, 1))):
        spec = _carry(specs[kind])
        margin = spec.predict_margin(X, device="cpu")
        got = pinf.DeviceScorer(types.SimpleNamespace(_spec=spec),
                                device="cpu").score_block(X)
        np.testing.assert_array_equal(got, fin(margin))


@pytest.mark.parametrize("kind", ["rf_reg", "xgb_reg"])
def test_predict_forest_sharded_matches_jax(specs, kind):
    from sml_tpu.ml.inference import predict_forest_sharded
    from sml_tpu.ml.tree_impl import bin_with
    X, _ = _data(n=1200, seed=13)
    spec = specs[kind]
    binned = bin_with(X, spec.binning)
    sf, sb, lv, w = (np.asarray(a) for a in spec.stacked())
    want = predict_forest_sharded(binned, sf, sb, lv, w, spec.depth,
                                  base=spec.base)
    got = pinf.predict_forest_sharded(binned, sf, sb, lv, w, spec.depth,
                                      base=spec.base, device="cpu")
    _close(got, want)


def _eval_inputs(spec, link):
    from sml_tpu.ml.tree_impl import bin_with
    X, y = _data(n=1800, seed=14)
    lab = np.exp(y) if link == "exp" else y
    lab[::37] = np.nan  # unlabelled rows drop out of every statistic
    finite = np.isfinite(lab)
    l32 = np.where(finite, lab, 0.0).astype(np.float32)
    f32 = finite.astype(np.float32)
    return bin_with(X, spec.binning), l32, f32


@pytest.fixture(scope="module")
def eval_stats(specs):
    """(port stats, JAX stats) per link, for the boosted regressor."""
    from sml_tpu.ml._staging import run_data_parallel
    from sml_tpu.ml.inference import forest_eval_fn as jax_eval_fn
    spec = specs["xgb_reg"]
    sf, sb, lv, w = (np.asarray(a) for a in spec.stacked())
    out = {}
    for link in ("identity", "exp"):
        binned, l32, f32 = _eval_inputs(spec, link)
        want = run_data_parallel(
            jax_eval_fn(spec.depth, link), binned, l32, f32,
            replicated=(sf, sb, np.asarray(lv, np.float32),
                        np.asarray(w, np.float32), np.float32(spec.base)))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        got = pinf.forest_eval_fn(spec.depth, link)(
            t(binned), t(l32), t(f32), t(sf.astype(np.int32)),
            t(sb.astype(np.int32)), t(lv.astype(np.float32)),
            t(w.astype(np.float32)), float(spec.base))
        out[link] = ([float(s) for s in got], [float(s) for s in want])
    return out


@pytest.mark.parametrize("link", ["identity", "exp"])
def test_forest_eval_stats_match_jax(eval_stats, link):
    got, want = eval_stats[link]
    assert got[0] == want[0] == 1800 - len(range(0, 1800, 37))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("link", ["identity", "exp"])
@pytest.mark.parametrize("metric", ["rmse", "mae", "r2"])
def test_reg_metric_matches_jax(eval_stats, link, metric):
    from sml_tpu.ml.evaluation import _reg_metric
    got, want = eval_stats[link]
    np.testing.assert_allclose(pev._reg_metric(metric, *got),
                               _reg_metric(metric, *want), rtol=RTOL)


def test_host_reg_stats_matches_jax():
    from sml_tpu.ml.evaluation import host_reg_stats
    rng = np.random.default_rng(3)
    pred = rng.normal(size=500)
    lab = pred + rng.normal(0, 0.1, 500)
    pred[::7] = np.nan
    lab[::11] = np.inf
    assert pev.host_reg_stats(pred, lab) == host_reg_stats(pred, lab)


def test_forest_eval_stats_match_materialised_predictions(specs):
    """The fused program's statistics equal host statistics of the
    predictions score_block materialises (exp link)."""
    spec = _carry(specs["xgb_reg"])
    binned, l32, f32 = _eval_inputs(specs["xgb_reg"], "exp")
    X, _ = _data(n=1800, seed=14)
    scorer = pinf.DeviceScorer(types.SimpleNamespace(_spec=spec),
                               device="cpu")
    pred = np.exp(scorer.score_block(X))
    lab = np.where(f32 > 0, l32, np.nan).astype(np.float64)
    host = pev.host_reg_stats(pred, lab)
    t = torch.from_numpy
    got = pinf.forest_eval_fn(spec.depth, "exp")(
        t(binned), t(l32), t(f32), *scorer._params, float(spec.base))
    # base and link run in f32 on the device, in f64 on the host
    np.testing.assert_allclose([float(s) for s in got], host, rtol=1e-4)


def test_forest_eval_rejects_unknown_link():
    with pytest.raises(ValueError, match="unknown link"):
        pinf.forest_eval_fn(3, "sqrt")


def test_model_classes_predict(specs):
    reg = ptm.RandomForestRegressionModel(_carry(specs["rf_reg"]))
    clf = ptm.GBTClassificationModel(_carry(specs["xgb_bin"]))
    X, _ = _data(n=200, seed=15)
    np.testing.assert_array_equal(
        reg.predict(X, device="cpu"),
        pinf.DeviceScorer(reg, device="cpu").score_block(X))
    p1 = clf.predict_probability(X, device="cpu")
    np.testing.assert_array_equal(
        p1, pinf.DeviceScorer(clf, device="cpu").score_block(X))
    np.testing.assert_array_equal(clf.predict(X, device="cpu"),
                                  (p1 > 0.5).astype(float))


def test_scorer_refuses_models_without_an_ensemble():
    # a model with neither an ensemble nor coefficients (a KMeans model's
    # centers); a linear model's coefficients are scored
    # (tests/test_torch_linear.py)
    with pytest.raises(TypeError,
                       match="tree ensembles and linear models only"):
        pinf.DeviceScorer(types.SimpleNamespace(_centers=[[1.0]]),
                          device="cpu")


def test_scorer_rejects_rows_of_another_width(specs):
    scorer = pinf.DeviceScorer(
        types.SimpleNamespace(_spec=_carry(specs["rf_reg"])), device="cpu")
    with pytest.raises(ValueError, match="expected rows of 6 features"):
        scorer.score_block(np.zeros((2, 5)))


def test_bin_cache_keeps_compact_dtype_hits_and_evicts_by_bytes():
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.ml import _staging
    rng = np.random.default_rng(0)
    a = rng.integers(0, 300, size=(500, 4)).astype(np.uint16)
    b = rng.integers(0, 200, size=(500, 4)).astype(np.uint8)
    prev = GLOBAL_CONF.get("sml.tree.binCacheBytes")
    try:
        GLOBAL_CONF.set("sml.tree.binCacheBytes", a.nbytes + b.nbytes)
        ta = _staging.stage_bins_cached(a, torch.device("cpu"))
        assert ta.dtype == torch.uint16
        np.testing.assert_array_equal(ta.to(torch.int32).numpy(), a)
        a[0, 0] += 1  # the staged copy does not alias the caller's array
        assert int(ta[0, 0]) == int(a[0, 0]) - 1
        a[0, 0] -= 1
        assert _staging.stage_bins_cached(a.copy(), "cpu") is ta  # hit
        tb = _staging.stage_bins_cached(b, torch.device("cpu"))
        assert tb.dtype == torch.uint8
        assert _staging.stage_bins_cached(a, "cpu") is ta  # touch a
        c = b + 1  # over budget: evicts the eldest, b
        _staging.stage_bins_cached(c, torch.device("cpu"))
        assert _staging.stage_bins_cached(a, "cpu") is ta
        assert _staging.stage_bins_cached(b, "cpu") is not tb
        assert _staging.bin_cache_stats()["bytes"] <= a.nbytes + b.nbytes
    finally:
        GLOBAL_CONF.set("sml.tree.binCacheBytes", prev)


def test_content_key_of_large_arrays_sees_point_edits_and_permutations():
    from sml_tpu_torch.ml._staging import _content_key
    rng = np.random.default_rng(1)
    a = rng.integers(0, 255, size=(1 << 17, 130), dtype=np.uint8)  # 17 MB
    key = _content_key(a)
    assert key[0] == "s"  # the sampled path, above the full-hash bound
    edited = a.copy()
    edited[12345, 7] ^= 1
    swapped = a.copy()
    swapped[[10, 20]] = swapped[[20, 10]]
    assert _content_key(edited) != key
    assert _content_key(swapped) != key
    assert _content_key(a.copy()) == key


def test_spec_from_arrays_rejects_a_feature_past_the_model(specs):
    spec = specs["rf_reg"]
    sf, sb, lv, w = (np.asarray(a).copy() for a in spec.stacked())
    sf[0, 0] = spec.n_features
    arrays = dict(split_feature=sf, split_bin=sb, leaf_value=lv,
                  gain=lv, cover=lv, edges=spec.binning.edges,
                  tree_weights=np.zeros(0),
                  scalars=np.asarray([spec.depth, 0.0, spec.n_features,
                                      0.0, 0.0]),
                  remap_slots=np.zeros(0, np.int64))
    with pytest.raises(ValueError, match="names feature 6 of 6"):
        ptm.spec_from_arrays(arrays)


def test_resident_bytes_counts_the_tables(specs):
    spec = _carry(specs["xgb_reg"])
    scorer = pinf.DeviceScorer(types.SimpleNamespace(_spec=spec),
                               device="cpu")
    T, N = spec.stacked()[0].shape
    assert scorer.resident_bytes() == 12 * T * N + 4 * T
