"""The port's serving degradation ladder and flush auto-tuning against the
JAX package's, on the CPU.

With `sml.serve.hostFallback` on (off by default, where the JAX
package's is on), a request that would push the rows
queued or in flight toward the card past `sml.serve.queueRows` is scored
on the host route in the submitting thread (`serve.host_routed`): no
shed, and every response equal to `score_block` of its rows. The queue
saturates deterministically: the scorer of the first batch blocks on an
`Event` until every later request has been admitted or host-routed. With
the fallback off the overflow sheds, tagged `serve.shed.overflow` (and
`serve.shed.closed` on a closed batcher). `_autotune`'s new
`flush_micros` equals the JAX batcher's for the same injected
histograms and arrival log. With the recorder on, each flush's
`serve.batch` span names its requests' traces (`parent_traces`), and the
`serve.batch_ms` / `serve.request_ms` histograms fill. The endpoint's
canary mirrors on the Staging version's host route.
"""

import threading
import types

import numpy as np
import pytest

from sml_tpu.conf import GLOBAL_CONF as JCONF
from sml_tpu.obs import _metrics as jmet
from sml_tpu.serving._batcher import MicroBatcher as JBatcher
from sml_tpu_torch import obs as pobs
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.native import host_traverse as ht
from sml_tpu_torch.obs import _metrics as pmet
from sml_tpu_torch.parallel.dispatch import DEVICE_QUEUE, QueuePressure
from sml_tpu_torch.serving import MicroBatcher, RequestShed
from sml_tpu_torch.utils.profiler import PROFILER, now


def _counter(name):
    return PROFILER.counters().get(name, 0.0)


@pytest.fixture(scope="module")
def scorer(spark):
    import os
    import tempfile
    from sml_tpu.ml._tree_models import _fit_ensemble
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 3))
    y = (2.0 * X[:, 0] - X[:, 1] + rng.normal(0, 0.1, 1500)
         ).astype(np.float32)
    spec = _fit_ensemble(X, y, categorical={}, max_depth=4, max_bins=32,
                         min_instances=1, min_info_gain=0.0, n_trees=6,
                         feature_k=2, bootstrap=True, subsample=1.0, seed=1,
                         loss="squared")
    with tempfile.TemporaryDirectory() as path:
        spec.save(path)
        with np.load(os.path.join(path, "data.npz")) as z:
            arrays = {k: z[k] for k in z.files}
    return DeviceScorer(types.SimpleNamespace(
        _spec=ptm.spec_from_arrays(arrays)), device="cpu")


def _requests(n_req, rows, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(rows, 3)) for _ in range(n_req)]


class _Gated:
    """A score_block that blocks on `gate` once inside (`entered`)."""

    def __init__(self, scorer):
        self.scorer = scorer
        self.entered = threading.Event()
        self.gate = threading.Event()
        self.batches = 0

    def __call__(self, X):
        self.entered.set()
        assert self.gate.wait(30)
        self.batches += 1
        return self.scorer.score_block(X)


@pytest.mark.parametrize("fallback", [True, False])
def test_overflow_takes_the_host_route_or_sheds(scorer, fallback):
    reqs = _requests(7, 4)
    gated = _Gated(scorer)
    routed0, shed0 = _counter("serve.host_routed"), _counter("serve.shed")
    over0 = _counter("serve.shed.overflow")
    calls0 = ht.CALLS
    assert DEVICE_QUEUE.rows() == 0
    b = MicroBatcher(gated, host_score=scorer.score_block_host,
                     host_fallback=fallback, queue_rows=8,
                     max_batch_rows=4, flush_micros=0)
    try:
        first = b.submit(reqs[0])
        assert gated.entered.wait(10)  # batch 1 is in flight, blocked
        second = b.submit(reqs[1])     # 8 rows toward the card: admitted
        assert DEVICE_QUEUE.rows() == 8
        over = [b.submit(r) for r in reqs[2:]]
        # the overflow was answered in this thread, before any flush
        assert all(f.done() for f in over) and not second.done()
        gated.gate.set()
        outs = [f.result(30) for f in (first, second)]
    finally:
        gated.gate.set()
        b.close()
    assert DEVICE_QUEUE.rows() == 0 and gated.batches == 2
    for out, X in zip(outs, reqs[:2]):
        np.testing.assert_array_equal(out, scorer.score_block(X))
    if fallback:
        for f, X in zip(over, reqs[2:]):
            np.testing.assert_array_equal(f.result(1), scorer.score_block(X))
        assert _counter("serve.host_routed") == routed0 + 5
        assert _counter("serve.shed") == shed0
        assert ht.CALLS == calls0 + 5
    else:
        for f in over:
            with pytest.raises(RequestShed, match="saturated"):
                f.result(1)
        assert _counter("serve.shed.overflow") == over0 + 5
        assert _counter("serve.host_routed") == routed0
        assert ht.CALLS == calls0


def test_conf_key_and_closed_batcher(scorer):
    X = _requests(1, 2)[0]
    # off by default (the JAX package's default is on): work leaves the
    # card only when the caller asks
    assert PCONF.get("sml.serve.hostFallback") is False
    assert JCONF.get("sml.serve.hostFallback") is True
    b = MicroBatcher(scorer.score_block, host_score=scorer.score_block_host)
    assert not b._host_fallback
    b.close()
    closed0 = _counter("serve.shed.closed")
    with pytest.raises(RequestShed, match="closed"):
        b.submit(X).result(1)
    assert _counter("serve.shed.closed") == closed0 + 1
    # the JAX package's ladder, asked for: a closed batcher with the
    # fallback on answers on the host route
    PCONF.set("sml.serve.hostFallback", True)
    try:
        b = MicroBatcher(scorer.score_block,
                         host_score=scorer.score_block_host)
        assert b._host_fallback
        b.close()
        np.testing.assert_array_equal(b.submit(X).result(1),
                                      scorer.score_block(X))
    finally:
        PCONF.unset("sml.serve.hostFallback")


def test_a_batcher_queue_chains_to_the_device_queue(scorer):
    own = QueuePressure(parent=DEVICE_QUEUE)
    b = MicroBatcher(scorer.score_block, queue=own, start=False)
    futs = [b.submit(X) for X in _requests(3, 5)]
    assert own.rows() == DEVICE_QUEUE.rows() == 15 == b.queued_rows()
    b.start()
    for f in futs:
        f.result(30)
    b.close()
    assert own.rows() == DEVICE_QUEUE.rows() == 0


@pytest.fixture()
def histograms():
    """Both packages' metrics registries emptied before and after."""
    jmet.METRICS.reset()
    pmet.METRICS.reset()
    try:
        yield
    finally:
        jmet.METRICS.reset()
        pmet.METRICS.reset()


def _inject(name, values):
    for mod in (jmet, pmet):
        h = mod.LogHistogram(window_s=60.0)
        for v in values:
            h.observe(v)
        mod.METRICS._hists[name] = h


@pytest.mark.parametrize("case", ["sparse", "intense", "middle",
                                  "device_ms", "none", "slo"])
def test_autotune_equals_the_jax_batcher(scorer, histograms, case):
    rng = np.random.default_rng(len(case))
    drain = rng.gamma(2.0, 0.6, 200)
    if case == "device_ms":
        _inject("dispatch.device_ms", drain)
    elif case != "none":
        _inject("serve.batch_ms", drain)
    if case == "slo":
        for conf in (JCONF, PCONF):
            conf.set("sml.serve.sloMillis", 3)
    rows = {"sparse": 2, "intense": 4000, "middle": 300, "device_ms": 100,
            "none": 50, "slo": 50}[case]
    try:
        got = []
        for cls in (JBatcher, MicroBatcher):
            b = cls(scorer.score_block, flush_auto=True, flush_micros=2000,
                    max_batch_rows=4096, start=False)
            t = now()
            b._arrivals.extend((t - dt, rows) for dt in
                               np.linspace(0.05, 1.5, 40))
            trail = []
            for _ in range(5):
                b._autotune()
                trail.append(b.flush_micros)
            got.append(trail)
            b.close()
    finally:
        for conf in (JCONF, PCONF):
            conf.unset("sml.serve.sloMillis")
    assert got[0] == got[1], got
    if case == "none":
        assert got[1] == [2000] * 5
    else:
        assert len(set(got[1])) > 1


def test_flush_spans_name_their_requests_traces(scorer):
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    try:
        reqs = _requests(6, 3)
        with MicroBatcher(scorer.score_block, flush_micros=20_000,
                          start=False) as b:
            futs = [b.submit(X) for X in reqs]
            b.start()
            outs = [f.result(30) for f in futs]
        for out, X in zip(outs, reqs):
            np.testing.assert_array_equal(out, scorer.score_block(X))
        events = pobs.RECORDER.events()
        batches = [e for e in events if e.name == "serve.batch"]
        traced = [t for e in batches for t in e.args["parent_traces"]]
        assert sorted(traced) == sorted(f.trace_id for f in futs)
        assert all(f.trace_id is not None for f in futs)
        admitted = [e.args["trace"] for e in events
                    if e.name == "trace.request"]
        assert sorted(admitted) == sorted(traced)
        assert pmet.METRICS.histogram("serve.request_ms").count == 6
        assert pmet.METRICS.histogram("serve.batch_ms").count == \
            len(batches)
        assert pobs.slo_report()["requests"] == 6.0
        assert pobs.WATCHDOG.report()["open"] == 0
    finally:
        PCONF.unset("sml.obs.enabled")
        pobs.reset()
        pobs.WATCHDOG.shutdown()


def test_endpoint_mirrors_on_the_staging_host_route(tmp_path, spark):
    """The canary scores on the Staging scorer's host route (the C++
    traversal), keeps the histogram fields, and the primary's batches
    stay on the batcher; a promote lands a `serve.swap` event."""
    import sml_tpu_torch.tracking as pt
    from sml_tpu_torch import get_session
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import DecisionTreeRegressor
    from sml_tpu_torch.serving import MODEL_CACHE, ServingEndpoint
    NAME = "port-fallback-model"
    pt.set_tracking_uri(str(tmp_path / "runs"))
    rng = np.random.default_rng(1)
    n = 400
    df = get_session().createDataFrame({
        "a": rng.normal(size=n), "b": rng.normal(size=n),
        "y": rng.normal(size=n)})
    PCONF.set("sml.device", "cpu")
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    try:
        for depth in (3, 4):
            model = Pipeline(stages=[
                VectorAssembler(inputCols=["a", "b"], outputCol="features"),
                DecisionTreeRegressor(labelCol="y", maxDepth=depth)]).fit(df)
            with pt.start_run():
                pt.spark.log_model(model, "model", registered_model_name=NAME)
        client = pt.MlflowClient()
        client.transition_model_version_stage(NAME, 1, "Production")
        client.transition_model_version_stage(NAME, 2, "Staging")
        X = rng.normal(size=(5, 2))
        calls0 = ht.CALLS
        with ServingEndpoint(NAME, canary_fraction=1.0, flush_micros=200,
                             device="cpu") as ep:
            futs = [ep.submit(X) for _ in range(4)]
            for f in futs:
                f.result(30)
            ep._shadow_pool.shutdown(wait=True)
            ep._shadow_pool = None
            stats = ep.canary_stats()
            client.transition_model_version_stage(NAME, 2, "Production")
        assert stats["mirrored"] == 4 and stats["errors"] == 0
        assert ht.CALLS == calls0 + 4
        assert stats["abs_diff_p99"] > 0 and stats["worst_abs_diff"] > 0
        assert stats["worst_trace"] in {pobs.trace_hex(f.trace_id)
                                        for f in futs}
        swaps = [e.args for e in pobs.RECORDER.events()
                 if e.name == "serve.swap"]
        assert swaps == [{"name": NAME, "stage": "Production", "from": 1,
                          "to": 2}]
    finally:
        MODEL_CACHE.invalidate(NAME)  # no warm scorer outlives the store
        PCONF.unset("sml.device")
        PCONF.unset("sml.obs.enabled")
        pobs.reset()
        pobs.WATCHDOG.shutdown()
