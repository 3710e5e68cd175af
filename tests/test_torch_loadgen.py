"""The port's open-loop load harness (`sml_tpu_torch/loadgen`), its
`dispatch.bucket_rows` and `prewarm.speculative_prewarm`, on the CPU,
held against the live JAX package (modelled on
tests/test_loadgen.py:66-330; its regress, sidecar and `bench.py` tests
read `obs/regress.py` and `bench.py`, which the port has not yet).

- `TraceSpec.compile()` gives the JAX package's schedule bit for bit
  (every `Request` field, the instants as float64 ==) over several
  specs and seeds; `bucket_rows` equals `mesh.bucket_rows` for every
  row count 1..100,000 and several multiples.
- The omission proof (open- against closed-loop tails on a stalled
  scorer), overrun accounting, the single shot, the per-phase worst
  exemplars in the flight recorder, `engine_health()["load"]` (None
  before a replay), the typed `RequestTimeout`, the flush auto-tune's
  bounds and the router's burn-slope tightening, as in the JAX
  package's tests.
- `speculative_prewarm` keeps the JAX package's stats keys and, unlike
  it, raises a failed call; `prewarm_widths` buckets the declared
  widths; an open-loop replay through a port fleet's router serves
  every request.
"""

import threading
import time

import numpy as np
import pytest

from sml_tpu_torch import obs
from sml_tpu_torch.conf import GLOBAL_CONF
from sml_tpu_torch.loadgen import (OpenLoopDriver, PhaseSpec, TraceSpec,
                                   closed_loop_probe)
from sml_tpu_torch.serving import MicroBatcher, RequestShed, RequestTimeout
from sml_tpu_torch.utils.profiler import PROFILER, now


@pytest.fixture()
def obs_on():
    GLOBAL_CONF.set("sml.obs.enabled", True)
    obs.reset()
    yield
    GLOBAL_CONF.set("sml.obs.enabled", False)
    obs.reset()


def _jax_spec(spec):
    """The same spec built from the JAX package's classes."""
    from sml_tpu import loadgen as jl
    return jl.TraceSpec(
        phases=tuple(jl.PhaseSpec(**vars(p)) for p in spec.phases),
        widths=spec.widths, classes=spec.classes, models=spec.models,
        seed=spec.seed)


SPECS = [
    TraceSpec(phases=(PhaseSpec("steady", 2.0, 40.0),
                      PhaseSpec("burst", 2.0, 40.0, arrival="bursty"),
                      PhaseSpec("ramp", 2.0, 20.0, 60.0)),
              widths=((8, 0.8), (128, 0.2)),
              classes=(("high", 0.3), ("normal", 0.7)),
              models=(("a", 0.5), ("b", 0.5)), seed=7),
    TraceSpec(phases=(PhaseSpec("u", 1.5, 80.0, arrival="uniform"),
                      PhaseSpec("r", 1.0, 10.0, 90.0, arrival="uniform")),
              widths=((1, 0.5), (2, 0.2), (4, 0.1), (16, 0.1),
                      (64, 0.1)), seed=0),
    TraceSpec(phases=(PhaseSpec("steady", 3.0, 150.0),
                      PhaseSpec("burst", 3.0, 150.0, arrival="bursty",
                                burst_factor=4.0, burst_fraction=0.2,
                                burst_cycles=3),
                      PhaseSpec("steady2", 3.0, 150.0)),
              widths=((1, 0.55), (2, 0.15), (4, 0.1), (8, 0.08),
                      (16, 0.06), (32, 0.04), (64, 0.02)),
              classes=(("high", 0.2), ("normal", 0.6), ("low", 0.2)),
              seed=21),
]


# ---------------------------------------------------------------- spec
@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2 ** 31 - 1])
@pytest.mark.parametrize("which", range(len(SPECS)))
def test_schedule_equals_the_jax_package_bit_for_bit(which, seed):
    spec = TraceSpec(phases=SPECS[which].phases, widths=SPECS[which].widths,
                     classes=SPECS[which].classes,
                     models=SPECS[which].models, seed=seed)
    got = spec.compile()
    want = _jax_spec(spec).compile()
    assert len(got) == len(want) > 0
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert np.asarray([r.t for r in got]).tobytes() == \
        np.asarray([r.t for r in want]).tobytes()


def test_trace_compile_deterministic():
    spec = SPECS[0]
    a, b = spec.compile(), spec.compile()
    assert a == b and len(a) > 100
    assert [r.index for r in a] == list(range(len(a)))
    ts = [r.t for r in a]
    assert ts == sorted(ts)
    assert {r.phase for r in a} == {"steady", "burst", "ramp"}
    assert {r.rows for r in a} <= {8, 128}
    assert {r.priority for r in a} <= {"high", "normal"}
    assert {r.model for r in a} <= {"a", "b"}
    bounds = {"steady": (0.0, 2.0), "burst": (2.0, 4.0),
              "ramp": (4.0, 6.0)}
    for r in a:
        lo, hi = bounds[r.phase]
        assert lo <= r.t < hi
    other = TraceSpec(phases=spec.phases, widths=spec.widths,
                      classes=spec.classes, models=spec.models,
                      seed=8).compile()
    assert other != a


def test_bursty_modulation_and_validation():
    ph = PhaseSpec("b", 8.0, 50.0, arrival="bursty")
    grid = np.linspace(0.0, 8.0, 8001)[:-1]
    rates = [ph.rate_at(float(t)) for t in grid]
    assert abs(float(np.mean(rates)) - 50.0) / 50.0 < 0.02
    assert max(rates) == pytest.approx(150.0)
    n = len(TraceSpec(phases=(ph,), seed=3).compile())
    assert 0.7 * 400 < n < 1.3 * 400
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        PhaseSpec("x", 1.0, 10.0, arrival="bursty", burst_factor=6.0,
                  burst_fraction=0.2).arrivals(rng)
    with pytest.raises(ValueError):
        PhaseSpec("x", 1.0, 10.0, arrival="warp").arrivals(rng)
    with pytest.raises(ValueError):
        TraceSpec(phases=(PhaseSpec("dup", 1.0, 1.0),
                          PhaseSpec("dup", 1.0, 1.0))).compile()
    with pytest.raises(ValueError):
        TraceSpec(phases=()).compile()


@pytest.mark.parametrize("multiple", [1, 2, 3, 8, 64])
def test_bucket_rows_equals_mesh_bucket_rows(multiple):
    from sml_tpu.parallel.mesh import bucket_rows as jax_bucket
    from sml_tpu_torch.parallel.dispatch import bucket_rows
    ns = range(0, 100_001)
    assert [bucket_rows(n, multiple) for n in ns] == \
        [jax_bucket(n, multiple) for n in ns]


# -------------------------------------------------------------- driver
def _stall_scorer(stall_at=5, stall_s=0.5):
    lock = threading.Lock()
    calls = {"n": 0}

    def score(X, priority, model):
        with lock:
            calls["n"] += 1
            if calls["n"] == stall_at:
                time.sleep(stall_s)
        return X

    return score


def test_open_vs_closed_loop_divergence_omission_proof():
    reqs = TraceSpec(phases=(PhaseSpec("steady", 1.0, 100.0,
                                       arrival="uniform"),),
                     seed=1).compile()
    open_rep = OpenLoopDriver(_stall_scorer(), reqs, workers=8,
                              overrun_micros=10_000_000).run()
    closed = closed_loop_probe(_stall_scorer(), reqs)
    assert len(closed) == len(reqs)
    closed_p99 = float(np.percentile(np.asarray(closed), 99.0))
    open_p99 = float(open_rep["phases"]["steady"]["p99_ms"])
    assert open_p99 > 100.0
    assert closed_p99 < open_p99 / 5.0


def test_overrun_accounting_never_silent_and_single_shot():
    reqs = TraceSpec(phases=(PhaseSpec("steady", 0.3, 50.0,
                                       arrival="uniform"),),
                     classes=(("high", 0.5), ("normal", 0.5)),
                     seed=2).compile()

    def slow(X, priority, model):
        time.sleep(0.08)
        return X

    driver = OpenLoopDriver(slow, reqs, workers=1, overrun_micros=5000)
    rep = driver.run()
    assert rep["overrun"] > 0
    assert rep["requests"] == len(reqs) == rep["served"]
    assert rep["shed"] == rep["timeout"] == rep["errors"] == 0
    ph = rep["phases"]["steady"]
    assert ph["p50_ms"] <= ph["p99_ms"] <= ph["p999_ms"] \
        <= ph["worst_ms"] + 1e-6
    assert sum(c["count"] for c in ph["classes"].values()) \
        == ph["requests"]
    assert ph["worst_ms"] > 200.0
    with pytest.raises(RuntimeError):
        driver.run()


def test_outcomes_are_accounted_and_the_probe_propagates_errors():
    """Shed, timeout and other errors each land in their slot of the
    driver's report; the closed-loop probe times a shed or a timeout and
    lets any other error through (the JAX package's swallows it)."""
    reqs = TraceSpec(phases=(PhaseSpec("p", 0.2, 50.0, arrival="uniform"),),
                     seed=3).compile()
    kinds = [RequestShed("s"), RequestTimeout("t"), ValueError("e"), None]

    def score(X, priority, model):
        err = kinds[score.n % 4]
        score.n += 1
        if err is not None:
            raise err
        return X
    score.n = 0
    rep = OpenLoopDriver(score, reqs, workers=1,
                         overrun_micros=10_000_000).run()
    n = len(reqs)
    assert (rep["shed"], rep["timeout"], rep["errors"], rep["served"]) == (
        len(range(0, n, 4)), len(range(1, n, 4)), len(range(2, n, 4)),
        len(range(3, n, 4)))
    score.n = 0
    with pytest.raises(ValueError):
        closed_loop_probe(score, reqs)
    assert score.n == 3


def test_load_report_exemplars_and_engine_health(obs_on):
    from sml_tpu_torch import loadgen
    loadgen.reset()
    assert obs.engine_health()["load"] is None
    spec = TraceSpec(phases=(PhaseSpec("a", 0.2, 60.0, arrival="uniform"),
                             PhaseSpec("b", 0.2, 60.0, arrival="uniform")),
                     classes=(("high", 0.5), ("normal", 0.5)), seed=4)
    rep = OpenLoopDriver(lambda X, p, m: X, spec.compile(), workers=4,
                         overrun_micros=10_000_000).run()
    ring = {(e.args or {}).get("trace")
            for e in obs.RECORDER.events() if e.name == "trace.request"}
    assert set(rep["phases"]) == {"a", "b"}
    for ph in rep["phases"].values():
        assert ph["worst_trace"]
        assert int(ph["worst_trace"], 16) in ring
    health = obs.engine_health()
    assert health["load"]["requests"] == rep["requests"]
    assert set(health["load"]["phases"]) == {"a", "b"}
    loadgen.reset()
    assert obs.engine_health()["load"] is None


# ------------------------------------------------- bounded-wait futures
def test_request_timeout_typed_counted_and_future_resolvable():
    mb = MicroBatcher(lambda X: np.asarray(X).sum(axis=1),
                      flush_micros=5_000, start=False)
    try:
        fut = mb.submit(np.ones((2, 3), dtype=np.float32))
        before = PROFILER.counters().get("serve.timeout", 0.0)
        with pytest.raises(RequestTimeout):
            fut.result(timeout=0.05)
        assert isinstance(RequestTimeout("x"), TimeoutError)
        assert PROFILER.counters().get("serve.timeout", 0.0) == before + 1
        mb.start()
        np.testing.assert_allclose(np.asarray(fut.result(timeout=5.0))
                                   .ravel(), [3.0, 3.0])
    finally:
        mb.close()


# ---------------------------------------------------- tail engineering
def test_flush_autotune_within_slo_budget_never_below_drain(obs_on):
    from sml_tpu_torch.obs._metrics import METRICS
    prev_slo = GLOBAL_CONF.get("sml.serve.sloMillis")
    GLOBAL_CONF.set("sml.serve.sloMillis", 50)
    try:
        for _ in range(32):
            METRICS.observe("serve.batch_ms", 5.0)
            METRICS.observe("dispatch.device_ms", 30.0)
        mb = MicroBatcher(lambda X: X, flush_auto=True,
                          flush_micros=40_000, max_batch_rows=64,
                          start=False)
        try:
            for _ in range(20):
                mb._autotune()
            assert mb.flush_micros == pytest.approx(20_000, rel=0.05)
            t = now()
            for _ in range(100):
                mb._arrivals.append((t, 100))
            for _ in range(20):
                mb._autotune()
            assert mb.flush_micros == pytest.approx(12_800, rel=0.10)
            assert mb.flush_micros >= 5_000
        finally:
            mb.close()
    finally:
        GLOBAL_CONF.set("sml.serve.sloMillis", prev_slo)


def test_burn_slope_tightens_admission_before_breach():
    from sml_tpu_torch.fleet import Router
    keys = ("sml.fleet.burstSlopeWindowSec",
            "sml.fleet.burstSlopeHorizonSec",
            "sml.fleet.burstSlopeTighten")
    prev = {k: GLOBAL_CONF.get(k) for k in keys}
    try:
        GLOBAL_CONF.set("sml.fleet.burstSlopeWindowSec", 30.0)
        GLOBAL_CONF.set("sml.fleet.burstSlopeTighten", 0.25)
        router = Router(None, priorities=["high", "normal"])
        t = now()
        router._burn = (0.9, t + 60.0)
        for dt, v in ((-2.0, 0.5), (-1.0, 0.7), (0.0, 0.9)):
            router._burn_hist.append((t + dt, v))
        GLOBAL_CONF.set("sml.fleet.burstSlopeHorizonSec", 0.0)
        assert router._class_fraction(1) == pytest.approx(0.5)
        GLOBAL_CONF.set("sml.fleet.burstSlopeHorizonSec", 1.0)
        before = PROFILER.counters().get("fleet.burst_tighten", 0.0)
        assert router._class_fraction(1) == pytest.approx(0.5 * 0.25)
        assert PROFILER.counters().get("fleet.burst_tighten", 0.0) \
            == before + 1
        assert router._class_fraction(0) == pytest.approx(1.0)
        router._burn = (1.2, now() + 60.0)
        assert router._class_fraction(1) == pytest.approx(0.5 * 0.5)
    finally:
        for k, v in prev.items():
            GLOBAL_CONF.set(k, v)


# ------------------------------------------------- speculative prewarm
def test_speculative_prewarm_stats_match_and_failures_raise():
    from sml_tpu.parallel.prewarm import speculative_prewarm as jax_spec
    from sml_tpu_torch.parallel.prewarm import speculative_prewarm
    shapes = [(8, 3), (8, 3), (16, 3), (1, 3)]
    seen = []
    lock = threading.Lock()

    def fn(X):
        with lock:
            seen.append((X.shape, X.dtype, float(np.abs(X).sum())))
    got = speculative_prewarm(fn, shapes, workers=2)
    want = jax_spec(lambda X: None, shapes, workers=2)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("programs", "warmed", "failed")} == \
        {k: want[k] for k in ("programs", "warmed", "failed")} == \
        {"programs": 3, "warmed": 3, "failed": 0}
    assert sorted(seen) == [((1, 3), np.float32, 0.0),
                            ((8, 3), np.float32, 0.0),
                            ((16, 3), np.float32, 0.0)]
    assert speculative_prewarm(fn, []) == {
        "programs": 0, "warmed": 0, "failed": 0, "wall_s": 0.0,
        "serial_s": 0.0}

    def bad(X):
        if X.shape[0] == 8:
            raise ValueError("no such width")
    failed0 = PROFILER.counters().get("prewarm.failed", 0.0)
    with pytest.raises(ValueError, match="no such width"):
        speculative_prewarm(bad, shapes, workers=2)
    assert PROFILER.counters().get("prewarm.failed", 0.0) == failed0 + 1
    assert jax_spec(bad, shapes, workers=2)["failed"] == 1


def test_prewarm_widths_buckets_the_declared_widths():
    from sml_tpu_torch import loadgen
    spec = TraceSpec(phases=(PhaseSpec("p", 1.0, 1.0),),
                     widths=((1, 1.0), (3, 1.0), (17, 1.0), (100, 1.0)))
    seen = []
    stats = loadgen.prewarm_widths(lambda X: seen.append(X.shape), spec,
                                   feature_dim=5, workers=1)
    from sml_tpu.parallel.mesh import bucket_rows as jax_bucket
    assert stats["programs"] == stats["warmed"] == 4
    assert sorted(seen) == [(1, 5), (3, 5), (18, 5), (104, 5)] == \
        [(jax_bucket(w, 1), 5) for w, _ in spec.widths]


def test_open_loop_through_a_port_fleet(tmp_path):
    """A short three-phase trace through a port fleet's router on the
    CPU: every request served, no overrun or timeout, the phases and
    classes reported, and engine_health's fleet and load blocks filled."""
    from sml_tpu_torch import loadgen
    from sml_tpu_torch import tracking as pt
    from sml_tpu_torch.fleet import ReplicaPool, Router
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import base as pbase
    from sml_tpu_torch.ml import feature as pfeat
    from sml_tpu_torch.ml import regression as preg
    GLOBAL_CONF.set("sml.device", "cpu")
    pt.set_tracking_uri(str(tmp_path / "runs"))
    pt.set_experiment("Default")
    try:
        rng = np.random.default_rng(0)
        cols = {f"c{i}": rng.normal(size=400) for i in range(4)}
        cols["y"] = cols["c0"] - cols["c1"]
        model = pbase.Pipeline(stages=[
            pfeat.VectorAssembler(inputCols=[f"c{i}" for i in range(4)],
                                  outputCol="features"),
            preg.LinearRegression(labelCol="y")]).fit(
            get_session().createDataFrame(cols))
        with pt.start_run():
            pt.spark.log_model(model, "model",
                               registered_model_name="load-fleet")
        pt.MlflowClient().transition_model_version_stage(
            "load-fleet", 1, "Production")
        spec = TraceSpec(phases=(PhaseSpec("steady", 0.3, 60.0),
                                 PhaseSpec("burst", 0.3, 60.0,
                                           arrival="bursty",
                                           burst_factor=4.0),
                                 PhaseSpec("steady2", 0.3, 60.0)),
                         widths=((1, 0.6), (8, 0.3), (64, 0.1)),
                         classes=(("high", 0.2), ("normal", 0.6),
                                  ("low", 0.2)), seed=5)
        with ReplicaPool("load-fleet", replicas=2, flush_micros=500,
                         device="cpu") as pool:
            router = Router(pool)
            assert loadgen.prewarm_widths(
                lambda X: router.score(X, "high", timeout=30), spec,
                feature_dim=4)["warmed"] == 3

            def score(X, priority, model):
                return router.score(X, priority, timeout=30)
            # a shared CPU's scheduling, not the fleet, decides how late
            # a fire leaves the pool here: no overrun within 10 s
            rep = OpenLoopDriver(score, spec.compile(), feature_dim=4,
                                 workers=8, overrun_micros=10_000_000).run()
            health = obs.engine_health()
        assert rep["requests"] == rep["served"] > 0
        assert rep["timeout"] == rep["errors"] == rep["overrun"] == 0
        assert list(rep["phases"]) == ["steady", "burst", "steady2"]
        assert health["load"]["requests"] == rep["requests"]
        assert health["fleet"]["requests"] >= rep["requests"]
    finally:
        GLOBAL_CONF.unset("sml.device")
        loadgen.reset()
