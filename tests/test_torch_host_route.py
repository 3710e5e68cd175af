"""The port's host routes against its plain versions and the JAX
package's host route, on the CPU.

The C++ host traversal (`native/host_traverse.forest_margin_host`) is
BIT-EQUAL to `forest_margin_plain` (the card's kernel's plain version)
on random tables with uint8, uint16 and int32 bins, depth 1-8, 1-100
trees, 0-5,000 rows, leaves at every level, feature ids past the row,
with and without `init` (an array and a number). `DeviceScorer.
score_block_host` equals the port's `score_block` bit for bit, and the
JAX package's `score_block_host` within rtol 1e-6 plus 1e-6 of the
largest |prediction| (the JAX host route sums the trees with XLA's f32
`tensordot` and `mean`, in another order). The linear host route
(`_linear_forward_host`) is bit-equal to `_linear_forward` on the CPU,
and a linear scorer's `score_block_host` to its `score_block`. A batch
routed to the host by the dispatcher runs the C++ traversal and gives
the same bits. The evaluators' host and device statistics agree within
1e-12, and with the JAX package's host statistics within f32 rounding.
"""

import types

import numpy as np
import pytest
import torch

from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import evaluation as pev
from sml_tpu_torch.ml import inference as pinf
from sml_tpu_torch.native import host_traverse as ht
from sml_tpu_torch.native.traverse_kernel import forest_margin_plain

BIN_CASES = {"uint8": (np.uint8, 256), "uint16": (np.uint16, 3000),
             "int32": (np.int32, 200_000)}


def _tables(rng, n_trees, depth, n_feat, n_bins):
    nodes = 2 ** (depth + 1) - 1
    sf = rng.integers(0, n_feat + 3, size=(n_trees, nodes)).astype(np.int32)
    # leaves at every level (and past the row: feature ids >= n_feat)
    sf[rng.random((n_trees, nodes)) < 0.15] = -1
    sb = rng.integers(0, n_bins, size=(n_trees, nodes)).astype(np.int32)
    lv = rng.normal(size=(n_trees, nodes)).astype(np.float32)
    w = rng.normal(size=n_trees).astype(np.float32)
    return sf, sb, lv, w


@pytest.mark.parametrize("init", ["none", "number", "array"])
@pytest.mark.parametrize("bins", sorted(BIN_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_traversal_is_bit_equal_to_the_plain_version(bins, init, seed):
    dtype, n_bins = BIN_CASES[bins]
    rng = np.random.default_rng([seed, len(bins), len(init)])
    depth = int(rng.integers(1, 9))
    n_trees = int(rng.integers(1, 101))
    n = int(rng.choice([0, 1, 37, int(rng.integers(2, 5001))]))
    n_feat = int(rng.integers(1, 13))
    sf, sb, lv, w = _tables(rng, n_trees, depth, n_feat, n_bins)
    X = rng.integers(0, n_bins, size=(n, n_feat)).astype(dtype)
    start = {"none": None, "number": float(rng.normal()),
             "array": rng.normal(size=n).astype(np.float32)}[init]
    got = ht.forest_margin_host(X, sf, sb, lv, w, depth, start)
    want = forest_margin_plain(
        torch.from_numpy(X), torch.from_numpy(sf), torch.from_numpy(sb),
        torch.from_numpy(lv), torch.from_numpy(w), depth,
        torch.from_numpy(start) if isinstance(start, np.ndarray)
        else start).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_host_traversal_threads_give_the_same_bits():
    rng = np.random.default_rng(5)
    sf, sb, lv, w = _tables(rng, 60, 7, 10, 64)
    X = rng.integers(0, 64, size=(20_000, 10)).astype(np.uint8)
    whole = ht.forest_margin_host(X, sf, sb, lv, w, 7)
    rows = np.concatenate([ht.forest_margin_host(X[i:i + 7], sf, sb, lv,
                                                 w, 7)
                           for i in range(0, 700, 7)])
    np.testing.assert_array_equal(whole[:700], rows)
    with pytest.raises(TypeError):
        ht.forest_margin_host(X.astype(np.float32), sf, sb, lv, w, 7)
    with pytest.raises(ValueError):
        ht.forest_margin_host(X, sf, sb, lv, w, 8)


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
    return {
        "rf_reg": _fit_ensemble(X, y32, max_depth=4, n_trees=5, feature_k=3,
                                bootstrap=True, subsample=1.0,
                                loss="squared", **common),
        "xgb_reg": _fit_ensemble(X, y32, max_depth=5, n_trees=30,
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


@pytest.mark.parametrize("name", ["rf_reg", "xgb_reg", "xgb_bin", "rf_bin"])
def test_score_block_host_against_the_jax_host_route(specs, name):
    from sml_tpu.ml.inference import DeviceScorer as JScorer
    spec = specs[name]
    X, _ = _data(n=700, seed=9)
    jax_host = JScorer(types.SimpleNamespace(_spec=spec)).score_block_host(X)
    scorer = pinf.DeviceScorer(types.SimpleNamespace(_spec=_carry(spec)),
                               device="cpu")
    calls0 = ht.CALLS
    got = scorer.score_block_host(X)
    assert ht.CALLS == calls0 + 1
    np.testing.assert_array_equal(got, scorer.score_block(X))
    scale = float(np.max(np.abs(jax_host)))
    np.testing.assert_allclose(got, jax_host, rtol=1e-6, atol=1e-6 * scale)


def test_a_batch_routed_to_the_host_runs_the_host_traversal(specs,
                                                            monkeypatch):
    scorer = pinf.DeviceScorer(
        types.SimpleNamespace(_spec=_carry(specs["xgb_reg"])), device="cpu")
    X, _ = _data(n=300, seed=4)
    want = scorer.score_block(X)
    routes = []

    def to_host(hint, device=None):
        routes.append((hint.kind, hint.flops, device))
        return "host"
    monkeypatch.setattr(pinf._dispatch, "decide", to_host)
    calls0 = ht.CALLS
    got = scorer.score_block(X)
    assert ht.CALLS == calls0 + 1
    np.testing.assert_array_equal(got, want)
    assert routes == [("traverse", 4.0 * 300 * 30 * 5, torch.device("cpu"))]
    out = list(scorer.score_batches([X[:100], X[100:]], depth=2))
    np.testing.assert_array_equal(np.concatenate(out), want)
    assert ht.CALLS == calls0 + 3


@pytest.mark.parametrize("d", [1, 3, 7, 8, 49])
def test_linear_host_route_is_bit_equal_to_the_linear_forward(d):
    rng = np.random.default_rng(d)
    X32 = (rng.normal(size=(513, d)) * 10 ** rng.uniform(-3, 3, d)
           ).astype(np.float32)
    w = rng.normal(size=d) * 10 ** rng.uniform(-2, 2, d)
    b = float(rng.normal())
    got = pinf._linear_forward_host(X32, w, b)
    want = pinf._linear_forward(torch.from_numpy(X32),
                                torch.from_numpy(w), b).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("logistic", [False, True])
def test_linear_scorer_host_route_gives_its_bits(logistic):
    rng = np.random.default_rng(3)
    model = types.SimpleNamespace(_coefficients=rng.normal(size=5),
                                  intercept=0.25)
    if logistic:
        model.numClasses = 2
    scorer = pinf.DeviceScorer(model, device="cpu")
    X = rng.normal(size=(200, 5))
    np.testing.assert_array_equal(scorer.score_block_host(X),
                                  scorer.score_block(X))
    with pytest.raises(ValueError):
        scorer.score_block_host(X[:, :4])


def _pred_label(seed, n=5000):
    rng = np.random.default_rng(seed)
    lab = rng.gamma(3.0, 50.0, n)
    pred = lab * rng.lognormal(0.0, 0.2, n)
    return pred, lab


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_host_and_device_statistics_agree(seed):
    from sml_tpu.ml.evaluation import host_reg_stats as jax_host_stats
    pred, lab = _pred_label(seed)
    host = pev._reg_stats_host(pred, lab)
    dev = pev._reg_stats_device(pred, lab, torch.device("cpu"))
    assert host[0] == dev[0] == len(pred)
    for a, b in zip(host[1:], dev[1:]):
        assert abs(a - b) <= 1e-12 * abs(a)
    jax = jax_host_stats(pred, lab)
    for a, b in zip(host, jax):
        assert abs(a - b) <= 1e-5 * abs(a)
    for metric in ("rmse", "mse", "mae", "r2", "var"):
        m_host = pev._reg_metric(metric, *host)
        m_dev = pev._reg_metric(metric, *dev)
        assert abs(m_host - m_dev) <= 1e-12 * abs(m_host)


def test_evaluators_follow_the_route(monkeypatch):
    from sml_tpu_torch import GLOBAL_CONF, get_session
    from sml_tpu_torch.ml.evaluation import (
        MulticlassClassificationEvaluator, RegressionEvaluator)
    pred, lab = _pred_label(3, n=3000)
    GLOBAL_CONF.set("sml.device", "cpu")
    try:
        df = get_session().createDataFrame(
            {"prediction": pred, "label": lab,
             "cls": np.round(pred / 100.0), "lcls": np.round(lab / 100.0)})
        routes = []
        real = pev.dispatch.decide

        def spy(hint, device=None):
            routes.append(real(hint, device))
            return routes[-1]
        monkeypatch.setattr(pev.dispatch, "decide", spy)
        ev = RegressionEvaluator(metricName="rmse")
        on_device = ev.evaluate(df)
        acc = MulticlassClassificationEvaluator(
            predictionCol="cls", labelCol="lcls", metricName="accuracy")
        acc_device = acc.evaluate(df)
        assert routes == ["device", "device"]  # a CPU session: no-tunnel
        monkeypatch.setattr(pev.dispatch, "decide",
                            lambda h, device=None: "host")
        on_host = ev.evaluate(df)
        assert abs(on_host - on_device) <= 1e-12 * on_device
        assert acc.evaluate(df) == acc_device
    finally:
        GLOBAL_CONF.unset("sml.device")
