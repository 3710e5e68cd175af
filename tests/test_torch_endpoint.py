"""The port's registry-backed `ServingEndpoint` on the CPU
(`device="cpu"`), modelled on tests/test_serving.py:80-460.

Two versions of a random-forest pipeline are fitted and registered by
the port in a store the JAX package reads too. The endpoint resolves its
stage alias, hot-swaps on a promotion (once), keeps serving through a
promote-while-serving race with no torn response, pins and unpins,
drops an archived version's warm scorer, paces its canary mirror, resets
the canary stats when Staging changes and counts a failed mirror, and
reports its state. Tolerances: the endpoint's responses equal
`DeviceScorer(version).score_block` of the same rows bit for bit; against
the JAX package's `ServingEndpoint` on the same registered versions,
rtol 1e-5 and atol 1e-5 of the largest |prediction| (the rule of
tests/test_torch_inference.py: the f32 sums over trees run in another
order).
"""

import threading
import time

import numpy as np
import pytest

from sml_tpu import tracking as jt
from sml_tpu_torch import tracking as pt
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.ml import base as pbase
from sml_tpu_torch.ml import feature as pfeat
from sml_tpu_torch.ml import regression as preg
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.serving import MODEL_CACHE, ModelCache, ServingEndpoint
from sml_tpu_torch.tracking import _store as pstore
from sml_tpu_torch.utils.profiler import PROFILER

RTOL = 1e-5
NAME = "port-serve-model"


def _counter(name):
    return PROFILER.counters().get(name, 0.0)


@pytest.fixture(scope="module", autouse=True)
def port_device():
    PCONF.set("sml.device", "cpu")
    yield
    PCONF.unset("sml.device")
    PCONF.unset("sml.serve.canaryFraction")


def _fit(seed, slope, kind="forest", cols=("a", "b")):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=600), rng.normal(size=600)
    frame = get_session().createDataFrame(
        {"a": a, "b": b, "y": slope * a - b + 1.0 + rng.normal(0, .1, 600)})
    est = preg.RandomForestRegressor(labelCol="y", numTrees=4, maxDepth=4,
                                     maxBins=16, seed=seed) \
        if kind == "forest" else preg.LinearRegression(labelCol="y")
    return pbase.Pipeline(stages=[
        pfeat.VectorAssembler(inputCols=list(cols), outputCol="features"),
        est]).fit(frame)


@pytest.fixture(scope="module")
def models():
    """v1 and v2 (forests over a and b), and a linear model over a only."""
    return _fit(0, 2.0), _fit(1, -3.0), _fit(2, 1.0, "linear", ("a",))


@pytest.fixture()
def registered(tmp_path, models):
    """v1 and v2 of NAME registered by the port, v1 in Production.
    Returns (m1, m2, X, expected v1 scores, expected v2 scores)."""
    for m in (pt, jt):
        m.set_tracking_uri(str(tmp_path / "runs"))
        m._active_experiment["id"] = None
    m1, m2, _ = models
    for m in (m1, m2):
        with pt.start_run():
            pt.spark.log_model(m, "model", registered_model_name=NAME)
    pt.MlflowClient().transition_model_version_stage(NAME, 1, "Production")
    X = np.random.default_rng(7).normal(size=(9, 2))
    yield (m1, m2, X, DeviceScorer(m1, device="cpu").score_block(X),
           DeviceScorer(m2, device="cpu").score_block(X))
    for m in (pt, jt):
        m._active_experiment["id"] = None
    # the next test registers its own versions under the same name
    MODEL_CACHE.invalidate(NAME)


def _until(done, timeout=30.0):
    end = time.perf_counter() + timeout
    while not done() and time.perf_counter() < end:
        time.sleep(0.005)


def _wait_mirrored(ep, n):
    def done():
        stats = ep.canary_stats()
        return stats["mirrored"] + stats["errors"] >= n
    _until(done)
    return ep.canary_stats()


def test_endpoint_resolves_production_and_hot_swaps_once(registered):
    m1, m2, X, exp1, exp2 = registered
    cache = ModelCache()
    with ServingEndpoint(NAME, "Production", model_cache=cache,
                         flush_micros=500, device="cpu") as ep:
        assert ep.current_version() == 1
        np.testing.assert_array_equal(ep.score(X, timeout=30), exp1)
        swaps0 = _counter("serve.hot_swap")
        pt.MlflowClient().transition_model_version_stage(
            NAME, 2, "Production", archive_existing_versions=True)
        assert ep.current_version() == 2
        assert _counter("serve.hot_swap") == swaps0 + 1
        np.testing.assert_array_equal(ep.score(X, timeout=30), exp2)
        # the archived v1's warm scorer was invalidated, not left to LRU
        assert cache.stats()["entries"] == 1
        # a transition of another model, or to another stage, swaps nothing
        pt.MlflowClient().transition_model_version_stage(NAME, 1, "Staging")
        assert ep.current_version() == 2
        assert _counter("serve.hot_swap") == swaps0 + 1


@pytest.mark.parametrize("version", [1, 2])
def test_scores_match_the_jax_packages_endpoint(registered, version):
    """The same registered version served by both packages' endpoints."""
    from sml_tpu.serving import ModelCache as JModelCache
    from sml_tpu.serving import ServingEndpoint as JEndpoint
    m1, m2, X, exp1, exp2 = registered
    client = jt.MlflowClient()
    client.transition_model_version_stage(NAME, version, "Staging")
    with JEndpoint(NAME, "Staging", model_cache=JModelCache(),
                   flush_micros=200) as jep:
        want = jep.score(X, timeout=60)
    with ServingEndpoint(NAME, "Staging", flush_micros=200,
                         device="cpu") as ep:
        got = ep.score(X, timeout=30)
        assert ep.current_version() == version
    np.testing.assert_array_equal(got, exp1 if version == 1 else exp2)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(want))))


def test_endpoint_requires_a_staged_version(registered):
    with pytest.raises(ValueError, match="Staging"):
        ServingEndpoint(NAME, "Staging", device="cpu")
    with pytest.raises(ValueError, match="Production"):
        ServingEndpoint("no-such-model", device="cpu")


def test_version_without_a_native_payload_raises(registered):
    with pt.start_run():
        pt.sklearn.log_model(object(), "model",
                             registered_model_name="pickled")
    pt.MlflowClient().transition_model_version_stage("pickled", 1,
                                                     "Production")
    with pytest.raises(ValueError, match="native"):
        ServingEndpoint("pickled", device="cpu")


def test_promote_while_serving_race(registered):
    """Clients score while a promotion lands: every response is v1's or
    v2's exact prediction, never a torn mix, and the endpoint converges
    to v2."""
    m1, m2, X, exp1, exp2 = registered
    errors, torn, seen = [], [], set()
    stop = threading.Event()
    with ServingEndpoint(NAME, "Production", flush_micros=200,
                         device="cpu") as ep:
        def client():
            while not stop.is_set():
                try:
                    out = ep.score(X, timeout=30)
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)
                    return
                if np.array_equal(out, exp1):
                    seen.add(1)
                elif np.array_equal(out, exp2):
                    seen.add(2)
                else:
                    torn.append(out)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        _until(lambda: 1 in seen or errors or torn)
        pt.MlflowClient().transition_model_version_stage(
            NAME, 2, "Production", archive_existing_versions=True)
        _until(lambda: 2 in seen or errors or torn)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors and not torn
        assert seen == {1, 2}
        assert ep.current_version() == 2
        np.testing.assert_array_equal(ep.score(X, timeout=30), exp2)


def test_pin_and_unpin(registered):
    m1, m2, X, exp1, exp2 = registered
    with ServingEndpoint(NAME, "Production", flush_micros=200,
                         model_cache=ModelCache(), device="cpu") as ep:
        swaps0 = _counter("serve.hot_swap")
        ep.pin_version(2)
        assert ep.pinned_version() == 2 and ep.current_version() == 2
        np.testing.assert_array_equal(ep.score(X, timeout=30), exp2)
        # a transition while pinned moves the canary target, not the pin
        pt.MlflowClient().transition_model_version_stage(NAME, 2, "Staging")
        assert ep.current_version() == 2
        assert ep.canary_stats()["staging_version"] == 2
        ep.unpin()
        ep.unpin()  # idempotent
        assert ep.pinned_version() is None and ep.current_version() == 1
        np.testing.assert_array_equal(ep.score(X, timeout=30), exp1)
        assert _counter("serve.hot_swap") == swaps0 + 2


def test_auto_update_off_keeps_the_bound_version(registered):
    m1, m2, X, exp1, exp2 = registered
    with ServingEndpoint(NAME, auto_update=False, flush_micros=200,
                         device="cpu") as ep:
        pt.MlflowClient().transition_model_version_stage(
            NAME, 2, "Production", archive_existing_versions=True)
        assert ep.current_version() == 1
        np.testing.assert_array_equal(ep.score(X, timeout=30), exp1)


def test_closed_endpoint_stops_listening(registered):
    m1, m2, X, exp1, exp2 = registered
    ep = ServingEndpoint(NAME, flush_micros=200, device="cpu")
    ep.close()
    assert ep.health_report()["endpoint"]["closed"]
    pt.MlflowClient().transition_model_version_stage(NAME, 2, "Production")
    assert ep.current_version() == 1
    assert ep._on_transition not in pstore._stage_listeners


def test_shared_cache_is_the_process_default(registered):
    m1, m2, X, exp1, exp2 = registered
    with ServingEndpoint(NAME, flush_micros=200, device="cpu") as a, \
            ServingEndpoint(NAME, flush_micros=200, device="cpu") as b:
        assert a._scorer is b._scorer
        assert a._cache is MODEL_CACHE


# ----------------------------------------------------------------- canary
def test_canary_mirrors_to_staging_and_records_divergence(registered):
    m1, m2, X, exp1, exp2 = registered
    pt.MlflowClient().transition_model_version_stage(NAME, 2, "Staging")
    mirrored0 = _counter("serve.canary_mirrored")
    with ServingEndpoint(NAME, "Production", canary_fraction=1.0,
                         flush_micros=200, device="cpu") as ep:
        for i in range(5):
            np.testing.assert_array_equal(ep.score(X[i:i + 2], timeout=30),
                                          exp1[i:i + 2])
        stats = _wait_mirrored(ep, 5)
    assert stats["mirrored"] == 5 and stats["rows"] == 10
    assert stats["errors"] == 0
    assert stats["staging_version"] == 2
    diff = np.abs(exp2[:6] - exp1[:6])
    want = sum(diff[i:i + 2].sum() for i in range(5)) / 10
    assert stats["mean_abs_diff"] == pytest.approx(want, rel=1e-12)
    assert stats["max_abs_diff"] == pytest.approx(diff.max(), rel=1e-12)
    assert _counter("serve.canary_mirrored") == mirrored0 + 5


@pytest.mark.parametrize("fraction, requests, mirrored",
                         [(0.25, 8, 2), (0.5, 7, 3), (1.0, 3, 3),
                          (0.0, 4, 0)])
def test_canary_fraction_paces_mirroring(registered, fraction, requests,
                                         mirrored):
    m1, m2, X, exp1, exp2 = registered
    pt.MlflowClient().transition_model_version_stage(NAME, 2, "Staging")
    PCONF.set("sml.serve.canaryFraction", fraction)
    try:
        with ServingEndpoint(NAME, flush_micros=200, device="cpu") as ep:
            for _ in range(requests):
                ep.score(X[:1], timeout=30)
            stats = _wait_mirrored(ep, mirrored)
    finally:
        PCONF.unset("sml.serve.canaryFraction")
    assert stats["mirrored"] == mirrored


def test_canary_stats_reset_on_staging_change(registered):
    m1, m2, X, exp1, exp2 = registered
    pt.MlflowClient().transition_model_version_stage(NAME, 2, "Staging")
    with ServingEndpoint(NAME, canary_fraction=1.0, flush_micros=200,
                         device="cpu") as ep:
        for _ in range(3):
            ep.score(X[:2], timeout=30)
        assert _wait_mirrored(ep, 3)["max_abs_diff"] > 0
        pstore.set_version_stage(NAME, 2, "Archived")
        stats = ep.canary_stats()
        assert stats["mirrored"] == 0 and stats["max_abs_diff"] == 0.0
        assert stats["staging_version"] is None
        # no Staging version: nothing mirrors
        ep.score(X[:2], timeout=30)
        assert ep.canary_stats()["mirrored"] == 0


def test_failed_mirror_is_counted_and_spares_the_primary(registered,
                                                         models):
    """A Staging version of another width (one feature, not two) cannot
    score the request: the mirror fails, counts as `serve.canary_error`
    and `errors`, and the primary's response is untouched."""
    m1, m2, X, exp1, exp2 = registered
    with pt.start_run():
        pt.spark.log_model(models[2], "model", registered_model_name=NAME)
    pt.MlflowClient().transition_model_version_stage(NAME, 3, "Staging")
    err0 = _counter("serve.canary_error")
    with ServingEndpoint(NAME, canary_fraction=1.0, flush_micros=200,
                         device="cpu") as ep:
        assert ep.canary_stats()["staging_version"] == 3
        for i in range(2):
            np.testing.assert_array_equal(ep.score(X, timeout=30), exp1)
        stats = _wait_mirrored(ep, 2)
    assert stats["errors"] == 2 and stats["mirrored"] == 0
    assert _counter("serve.canary_error") == err0 + 2


def test_an_empty_request_mirrors_once_without_an_error(registered):
    """A request of no rows has nothing to differ: it counts as one
    mirror of 0 rows (the JAX package counts it mirrored and then fails
    on the empty maximum, so it counts as an error too)."""
    m1, m2, X, exp1, exp2 = registered
    pt.MlflowClient().transition_model_version_stage(NAME, 2, "Staging")
    with ServingEndpoint(NAME, canary_fraction=1.0, flush_micros=200,
                         device="cpu") as ep:
        assert ep.score(X[:0], timeout=30).shape == (0,)
        stats = _wait_mirrored(ep, 1)
    assert (stats["mirrored"], stats["rows"], stats["errors"]) == (1, 0, 0)
    assert stats["max_abs_diff"] == 0.0


def test_shadow_backlog_is_bounded(registered):
    """While the primary's batches wait, at most _SHADOW_MAX_INFLIGHT
    mirrors queue; later ones drop instead of pinning their rows."""
    m1, m2, X, exp1, exp2 = registered
    pt.MlflowClient().transition_model_version_stage(NAME, 2, "Staging")
    with ServingEndpoint(NAME, canary_fraction=1.0, flush_micros=200,
                         start=False, timeout_millis=0,
                         device="cpu") as ep:
        futs = [ep.submit(X[:1]) for _ in range(ep._SHADOW_MAX_INFLIGHT + 3)]
        assert ep._shadow_inflight == ep._SHADOW_MAX_INFLIGHT
        ep._batcher.start()
        for f in futs:
            np.testing.assert_array_equal(f.result(30), exp1[:1])
        stats = _wait_mirrored(ep, ep._SHADOW_MAX_INFLIGHT)
    assert stats["mirrored"] == ep._SHADOW_MAX_INFLIGHT
    assert ep._shadow_inflight == 0


# ----------------------------------------------------------------- health
def test_health_report_endpoint_block(registered):
    m1, m2, X, exp1, exp2 = registered
    with ServingEndpoint(NAME, "Production", flush_micros=200,
                         max_batch_rows=512, device="cpu") as ep:
        for i in range(6):
            ep.score(X[i:i + 2], timeout=30)
        health = ep.health_report()
    block = health["endpoint"]
    assert set(health) == {"endpoint"}
    assert block == {"name": NAME, "stage": "Production", "version": 1,
                     "pinned": None, "staging_version": None,
                     "queued_rows": 0, "max_batch_rows": 512,
                     "closed": False, "canary": block["canary"],
                     "kernel": None}
    assert block["canary"]["mirrored"] == 0
    # the CPU scorer launches no kernel: no traversal plan to report
    assert ep._scorer.kernel_spec() is None


def test_mixed_device_endpoints_do_not_share_a_scorer(registered):
    """The cache keys a warm scorer by its device too."""
    m1, m2, X, exp1, exp2 = registered
    cache = ModelCache()
    with ServingEndpoint(NAME, model_cache=cache, flush_micros=200,
                         device="cpu") as ep:
        key = ep._cache_key(1)
    assert key == "1@cpu"
    assert cache.stats()["entries"] == 1


def test_pipeline_frames_score_like_the_endpoint(registered):
    """The pandas-free batch route (`pyfunc.predict` on a mapping) and
    the endpoint give the same bits for the same version."""
    m1, m2, X, exp1, exp2 = registered
    py = pt.pyfunc.load_model(f"models:/{NAME}/Production")
    np.testing.assert_array_equal(py.predict({"a": X[:, 0], "b": X[:, 1]}),
                                  exp1)
