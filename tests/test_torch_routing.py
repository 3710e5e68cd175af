"""The fits' and predicts' routing sites (`parallel.dispatch.routed` /
`device_for`, `ml._staging.routed_for` / `route_for_arrays`,
`device.use_device_local`), on the CPU.

This sandbox has no card, so a stub stands in for one: `torch.cuda`
reports a device, and every site is asked for "cuda:0". Under
`sml.dispatch.mode=host` each site must then decide "host" (reason
"forced-mode" in the dispatch audit), bind the CPU and run there,
touching no CUDA tensor, with the bits of the same call given
device="cpu". A site that ignored the decision would try to copy to
"cuda:0" and raise. The fused routes keep their fixed rules. The
DataFrame action the JAX package routes (`mapInPandas`,
`tests/test_dispatch_economics.py:225-250`) decides once a call: under
the forced mode its UDF body runs with the CPU bound, and otherwise the
binding is left as it was.

The binding is per thread: `routed` on one thread never moves another
thread's work, and it restores the outer binding on exit.
"""

import threading

import numpy as np
import pytest
import torch

from sml_tpu_torch import device as pdevice
from sml_tpu_torch import obs as pobs
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.parallel import dispatch

torch.set_num_threads(2)
CARD = "cuda:0"


@pytest.fixture()
def host_mode(monkeypatch):
    """A stub card, `sml.dispatch.mode=host`, and the recorder on (the
    audit keeps every decision)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    PCONF.set("sml.dispatch.mode", "host")
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    yield
    PCONF.unset("sml.dispatch.mode")
    PCONF.set("sml.obs.enabled", False)
    pobs.reset()


def _decisions():
    return [(r.route, r.reason, r.kind) for r in pobs.audit_records()]


def _assert_routed_host(kinds):
    got = _decisions()
    assert [k for _, _, k in got] == list(kinds), got
    assert all(route == "host" and reason == "forced-mode"
               for route, reason, _ in got), got


def _data(n=1200, f=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] - 0.5 * X[:, 1] + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


TREE_KW = dict(categorical={}, max_depth=3, max_bins=16, min_instances=1,
               min_info_gain=0.0, n_trees=2, feature_k=None,
               bootstrap=False, subsample=1.0, seed=3, loss="squared")


def _same_trees(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.leaf_value, tb.leaf_value)


# --------------------------------------------------------------- tree sites
def _tree_sites():
    from sml_tpu_torch.ml import _tree_models as tm
    X, y = _data()
    Xs, ys = [X[:600], X[600:]], [y[:600], y[600:]]
    grid = [dict(TREE_KW, max_depth=d, feature_k=None) for d in (2, 3)]

    def fit(dev):
        return tm._fit_ensemble(X, y, boosting=True, device=dev, **TREE_KW)

    def resume(dev):
        spec = tm._fit_ensemble(X, y, boosting=True, device="cpu",
                                **TREE_KW)
        pobs.reset()
        return tm.warm_start_ensemble(spec, X, y, n_new_trees=2, seed=3,
                                      device=dev)

    def predict(dev):
        spec = tm._fit_ensemble(X, y, device="cpu", **TREE_KW)
        pobs.reset()
        return spec.predict_margin(X[:100], dev)

    def folds(dev):
        kw = {k: v for k, v in TREE_KW.items() if k != "categorical"}
        return tm._fit_ensemble_folds(Xs, ys, {}, device=dev, **kw)

    def trials(dev):
        return tm._fit_ensembles_grid(Xs, ys, {}, grid, max_fused=4,
                                      device=dev)

    def stats(dev):
        spec = tm._fit_ensemble(X, y, device="cpu", **TREE_KW)
        pobs.reset()
        return tm.fused_reg_stats_from_matrix(spec, X[:200], y[:200],
                                              device=dev)

    return {"fit": (fit, ["scatter"]), "resume": (resume, ["scatter"]),
            "predict": (predict, ["traverse"]),
            "folds": (folds, ["scatter"]),
            "trials": (trials, ["scatter"]),
            "stats": (stats, ["traverse"])}


SITES = ["fit", "resume", "predict", "folds", "trials", "stats"]


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, z in zip(a, b):
            _same(x, z)
    elif hasattr(a, "trees"):
        _same_trees(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("site", SITES)
def test_tree_site_binds_the_cpu_under_host_mode(host_mode, site):
    run, kinds = _tree_sites()[site]
    got = run(CARD)
    _assert_routed_host(kinds)
    PCONF.unset("sml.dispatch.mode")
    _same(got, run("cpu"))


# ------------------------------------------------------------ linear sites
def _parts(n=900, seed=1):
    from sml_tpu_torch.ml.featurizer import CompactParts
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 2)).astype(np.float32)
    codes = rng.integers(0, 3, (n, 1)).astype(np.int32)
    parts = CompactParts(num, codes, (("num", 0), ("num", 1), ("oh", 0, 3)),
                         5, None)
    y = (num[:, 0] > 0).astype(np.float32)
    return parts, y


def _linear_sites():
    from sml_tpu_torch.ml import linear_impl as li
    X, y = _data(seed=2)
    yb = (y > 0).astype(np.float32)
    parts, yp = _parts()
    return {
        "gram": (lambda d: li.gram_stats(X, y, device=d), ["blas"]),
        "logistic": (lambda d: li.fit_logistic(X, yb, device=d).coefficients,
                     ["blas"]),
        "gram_compact": (lambda d: li.gram_stats_compact(parts, yp,
                                                         device=d),
                         ["blas"]),
        "logistic_compact": (
            lambda d: li.fit_logistic_compact(parts, yp, maxIter=5,
                                              device=d).coefficients,
            ["blas"]),
        "predict_linear": (lambda d: li.predict_linear(
            X, np.ones(X.shape[1]), 0.5, device=d), ["blas"]),
    }


@pytest.mark.parametrize("site", ["gram", "logistic", "gram_compact",
                                  "logistic_compact", "predict_linear"])
def test_linear_site_binds_the_cpu_under_host_mode(host_mode, site):
    run, kinds = _linear_sites()[site]
    got = run(CARD)
    _assert_routed_host(kinds)
    PCONF.unset("sml.dispatch.mode")
    _same(got, run("cpu"))


# -------------------------------------------------- KMeans and ALS (frames)
def _frame_fit(kind):
    from sml_tpu_torch.frame.session import get_session
    rng = np.random.default_rng(4)
    if kind == "kmeans":
        from sml_tpu_torch.ml.clustering import KMeans
        from sml_tpu_torch.ml.feature import VectorAssembler
        df = get_session().createDataFrame(
            {"a": rng.normal(size=500), "b": rng.normal(size=500)})
        df = VectorAssembler(inputCols=["a", "b"],
                             outputCol="features").transform(df)
        m = KMeans(k=3, seed=1, maxIter=5).fit(df)
        return np.asarray(m.clusterCenters())
    from sml_tpu_torch.ml.recommendation import ALS
    df = get_session().createDataFrame({
        "user": rng.integers(0, 20, 400), "item": rng.integers(0, 15, 400),
        "rating": rng.integers(1, 6, 400).astype(float)})
    m = ALS(userCol="user", itemCol="item", ratingCol="rating", rank=3,
            maxIter=3, seed=1).fit(df)
    return m._uf


@pytest.mark.parametrize("kind,hint", [("kmeans", "blas"),
                                       ("als", "segment")])
def test_frame_fits_bind_the_cpu_under_host_mode(host_mode, kind, hint):
    PCONF.set("sml.device", CARD)
    try:
        got = _frame_fit(kind)
        _assert_routed_host([hint])
        PCONF.unset("sml.dispatch.mode")
        PCONF.set("sml.device", "cpu")
        np.testing.assert_array_equal(got, _frame_fit(kind))
    finally:
        PCONF.unset("sml.device")


# ------------------------------------------------------------ mapInPandas
def _map_in_pandas_bindings() -> list:
    """The device bound on the UDF's thread at each batch of a
    `mapInPandas` over 200 rows."""
    import pandas as pd
    from sml_tpu_torch.frame.session import get_session
    seen = []

    def fn(batches):
        for b in batches:
            seen.append(pdevice.bound_device())
            yield pd.DataFrame({"y": b["x"] * 2})

    df = get_session().createDataFrame({"x": np.arange(200.0)})
    out = df.mapInPandas(fn, "y double")
    assert out.count() == 200
    np.testing.assert_array_equal(out._whole()["y"], np.arange(200.0) * 2)
    return seen


def test_map_in_pandas_binds_the_cpu_under_host_mode(host_mode):
    seen = _map_in_pandas_bindings()
    assert seen and set(seen) == {torch.device("cpu")}
    _assert_routed_host(["blas"])
    assert pdevice.bound_device() is None


def test_map_in_pandas_on_a_card_leaves_the_binding(monkeypatch):
    """Auto mode on a (stub) card decides "device" ("local-chip") and
    binds nothing: the body sees the caller's binding, here none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    try:
        seen = _map_in_pandas_bindings()
        assert _decisions() == [("device", "local-chip", "blas")]
    finally:
        PCONF.set("sml.obs.enabled", False)
        pobs.reset()
    assert seen and set(seen) == {None}


def test_map_in_pandas_on_the_cpu_session_leaves_the_binding():
    PCONF.set("sml.device", "cpu")
    try:
        assert set(_map_in_pandas_bindings()) == {None}
        with pdevice.use_device_local("meta"):
            assert set(_map_in_pandas_bindings()) == {torch.device("meta")}
    finally:
        PCONF.unset("sml.device")


def test_auto_mode_keeps_the_callers_device():
    """Without a forced mode the decision is the caller's device (a CPU
    session preroutes "no-tunnel" and stays on the CPU)."""
    hint = dispatch.WorkHint(flops=1e6)
    assert dispatch.device_for(hint, "cpu") == torch.device("cpu")
    with dispatch.routed(hint, "cpu") as dev:
        assert dev == torch.device("cpu")
        assert pdevice.resolve_device(None) == torch.device("cpu")


# ------------------------------------------------------------- thread-local
def test_the_binding_does_not_leak_across_threads():
    seen = {}
    inside = threading.Event()
    release = threading.Event()

    def other():
        inside.wait(5)
        seen["other"] = pdevice.bound_device()
        with pdevice.use_device_local("meta"):
            seen["other_bound"] = pdevice.bound_device()
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with dispatch.routed(dispatch.WorkHint(flops=1.0), "cpu") as dev:
        with pdevice.use_device_local("meta"):
            assert pdevice.bound_device() == torch.device("meta")
        assert pdevice.bound_device() == dev
        inside.set()
        release.wait(5)
        assert pdevice.bound_device() == torch.device("cpu")
    t.join()
    assert seen["other"] is None
    assert seen["other_bound"] == torch.device("meta")
    assert pdevice.bound_device() is None


def test_a_host_mode_fit_on_one_thread_leaves_another_threads_binding(
        host_mode):
    """A forced-host fit binds the CPU on its own thread only: a thread
    holding its own binding keeps it throughout."""
    from sml_tpu_torch.ml import _tree_models as tm
    X, y = _data(n=600)
    during = []
    stop = threading.Event()

    def watcher():
        with pdevice.use_device_local("meta"):
            while not stop.is_set():
                during.append(pdevice.bound_device())
            during.append(pdevice.bound_device())

    t = threading.Thread(target=watcher)
    t.start()
    try:
        tm._fit_ensemble(X, y, device=CARD, **TREE_KW)
    finally:
        stop.set()
        t.join()
    assert during and set(during) == {torch.device("meta")}
    assert pdevice.bound_device() is None
