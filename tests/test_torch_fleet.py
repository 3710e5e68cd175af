"""The port's serving fleet (`sml_tpu_torch/fleet`) on the CPU, held
against the live JAX package (modelled on tests/test_fleet.py, less its
`test_regress_guards_fleet_proofs`, which reads `obs/regress.py`: the
port has none yet).

Each scenario runs in both packages on linear pipelines fitted on the
same rows, each registered in a store of its own; the port's replicas
serve with `device="cpu"`. Equal between the packages: each replica's
and the process-wide queue rows, every admission's outcome (served,
shed, re-routed) and the `fleet.*` / `serve.shed.*` counter deltas, the
autoscaler's actions, every rollout's verdict (action, stages, checks,
evictions, the stages left in the registry) and the trainer's promotion
through the fleet. Responses: each replica's equal `DeviceScorer
.score_block` of the same rows bit for bit, and the JAX package's within
2e-5 of the largest |prediction| (tests/test_torch_linear.py's rule).

The top class past every bound: with `hostFallback` on (both packages'
parity) it is host-routed and served; with it off it sheds as
`serve.shed.overflow`. The port's default is off (the JAX package's is
on), so one more test pins what the port's default does.
"""

import os
import threading

import numpy as np
import pandas as pd
import pytest

PRED_TOL = 2e-5


class Pkg:
    def __init__(self, root):
        import importlib
        self.root = root
        m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.fleet = m("fleet")
        self.ct = m("ct")
        self.tracking = m("tracking")
        self.store = m("tracking._store")
        self.serving = m("serving")
        self.obs = m("obs")
        self.dispatch = m("parallel.dispatch")
        self.ml = m("ml")
        self.feature = m("ml.feature")
        self.regression = m("ml.regression")
        self.conf = m("conf").GLOBAL_CONF
        self.prof = m("utils.profiler").PROFILER
        self.port = root == "sml_tpu_torch"
        self.kw = {"device": "cpu"} if self.port else {}

    def counter(self, name):
        return self.prof.counters().get(name, 0.0)

    def frame(self, spark, cols):
        if self.port:
            from sml_tpu_torch.frame.session import get_session
            return get_session().createDataFrame(cols)
        return spark.createDataFrame(pd.DataFrame(cols))

    def scorer(self, model):
        from importlib import import_module
        return import_module(f"{self.root}.ml.inference").DeviceScorer(
            model, **self.kw)


@pytest.fixture(scope="module")
def pkgs():
    return Pkg("sml_tpu"), Pkg("sml_tpu_torch")


@pytest.fixture(autouse=True)
def confs(pkgs, tmp_path):
    """Both profilers counting (the JAX package's counts only while on),
    the port on the CPU, a registry a package in tmp_path."""
    jax_pkg, port = pkgs
    old = jax_pkg.conf.get("sml.profiler.enabled")
    jax_pkg.conf.set("sml.profiler.enabled", True)
    port.conf.set("sml.device", "cpu")
    for p in pkgs:
        p.tracking.set_tracking_uri(str(tmp_path / f"runs-{p.root}"))
        p.tracking.set_experiment("Default")
    yield
    for p in pkgs:
        while p.tracking.active_run():
            p.tracking.end_run()
    jax_pkg.conf.set("sml.profiler.enabled", old)
    port.conf.unset("sml.device")


@pytest.fixture()
def obs_on(pkgs, tmp_path):
    for p in pkgs:
        p.conf.set("sml.obs.enabled", True)
        p.conf.set("sml.obs.blackboxDir", str(tmp_path / f"bb-{p.root}"))
        p.obs.reset()
    yield
    for p in pkgs:
        p.conf.set("sml.obs.enabled", False)
        p.obs.reset()
    pkgs[1].conf.unset("sml.obs.blackboxDir")


def _fit_linear(p, spark, seed=0, slope=2.0):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=500), rng.normal(size=500)
    cols = {"a": a, "b": b,
            "y": slope * a - b + 1.0 + rng.normal(0, 0.1, 500)}
    va = p.feature.VectorAssembler(inputCols=["a", "b"],
                                   outputCol="features")
    return p.ml.Pipeline(stages=[
        va, p.regression.LinearRegression(labelCol="y")]).fit(
        p.frame(spark, cols))


def _register(p, name, *models):
    for m in models:
        with p.tracking.start_run():
            p.tracking.spark.log_model(m, "model",
                                       registered_model_name=name)
    p.store.set_version_stage(name, 1, "Production")


def _probe(seed=7, rows=8):
    return np.random.default_rng(seed).normal(size=(rows, 2)) \
        .astype(np.float32)


def _stage(p, name, v):
    return p.store.get_model_version(name, v)["current_stage"]


def _each(pkgs, fn):
    """fn(package) in each package: {root: result}."""
    return {p.root: fn(p) for p in pkgs}


# --------------------------------------------------------- attribution
def test_per_replica_queue_attribution(pkgs, spark):
    """Each replica's admissions land on ITS QueuePressure; the
    process-wide DEVICE_QUEUE sees the sum."""
    def run(p):
        _register(p, "fleet-attr", _fit_linear(p, spark))
        seen = []
        with p.fleet.ReplicaPool("fleet-attr", replicas=2, start=False,
                                 timeout_millis=0, **p.kw) as pool:
            r0, r1 = pool.replicas()
            base = p.dispatch.DEVICE_QUEUE.rows()
            f = r0.endpoint.submit(_probe(rows=5))
            seen.append((r0.pressure(), r1.pressure(),
                         p.dispatch.DEVICE_QUEUE.rows() - base))
            g = r1.endpoint.submit(_probe(rows=3))
            seen.append((r0.pressure(), r1.pressure(),
                         p.dispatch.DEVICE_QUEUE.rows() - base))
            for r in (r0, r1):
                r.endpoint._batcher.start()
            f.result(30), g.result(30)
            seen.append((r0.pressure(), r1.pressure(),
                         p.dispatch.DEVICE_QUEUE.rows() - base))
        return seen
    got = _each(pkgs, run)
    assert got["sml_tpu_torch"] == got["sml_tpu"] == [(5, 0, 5), (5, 3, 8),
                                                      (0, 0, 0)]


def test_every_replica_scores_like_score_block(pkgs, spark):
    """Three replicas answer the same rows: each equals `score_block` of
    the registered model bit for bit, and the JAX package's fleet within
    PRED_TOL."""
    X = _probe(rows=64)

    def run(p):
        m = _fit_linear(p, spark)
        _register(p, "fleet-same", m)
        with p.fleet.ReplicaPool("fleet-same", replicas=3,
                                 flush_micros=500, **p.kw) as pool:
            got = [r.endpoint.score(X, timeout=30) for r in pool.replicas()]
            router = p.fleet.Router(pool)
            got.append(router.score(X, "high", timeout=30))
        return got, p.scorer(m).score_block(X)
    res = _each(pkgs, run)
    got, want = res["sml_tpu_torch"]
    for g in got:
        np.testing.assert_array_equal(g, want)
    jgot, _ = res["sml_tpu"]
    np.testing.assert_allclose(got[0], jgot[0], rtol=0,
                               atol=PRED_TOL * np.abs(jgot[0]).max())


# ------------------------------------------------------ priority ladder
def _ladder(p, spark, name, **pool_kw):
    """Low admits to 10 rows of a 30-row bound, normal to 20, high to 30;
    then one more high past every bound. Returns the outcomes and the
    counter deltas."""
    _register(p, name, _fit_linear(p, spark))
    keys = ("serve.shed.overflow", "serve.host_routed", "fleet.shed.low",
            "fleet.shed.normal", "fleet.shed.high", "fleet.requests")
    c0 = {k: p.counter(k) for k in keys}
    outcomes = []
    with p.fleet.ReplicaPool(name, replicas=1, start=False, queue_rows=30,
                             timeout_millis=0, **pool_kw, **p.kw) as pool:
        router = p.fleet.Router(pool, priorities=["high", "normal", "low"])
        X = _probe(rows=5)
        futs = [router.submit(X, cls) for cls in
                ("low", "low", "low", "normal", "normal", "normal",
                 "high", "high", "high")]
        pool.replicas()[0].endpoint._batcher.start()
        for f in futs:
            try:
                outcomes.append(("served", f.result(30).shape))
            except p.serving.RequestShed:
                outcomes.append(("shed", None))
    return outcomes, {k: p.counter(k) - c0[k] for k in keys}


@pytest.mark.parametrize("fallback", [True, False])
def test_priority_ladder_low_sheds_first(pkgs, spark, fallback):
    """Class i of n admits to (n-i)/n of the bound; high past every bound
    goes to the endpoint's ladder: host-routed with the fallback on,
    an overflow shed with it off; the same in both packages."""
    got = _each(pkgs, lambda p: _ladder(p, spark, f"ladder-{fallback}",
                                        host_fallback=fallback))
    outcomes, deltas = got["sml_tpu_torch"]
    assert got["sml_tpu"] == got["sml_tpu_torch"]
    last = ("served", (5,)) if fallback else ("shed", None)
    assert [o[0] for o in outcomes] == [
        "served", "served", "shed", "served", "served", "shed",
        "served", "served", last[0]]
    assert deltas["fleet.shed.low"] == deltas["fleet.shed.normal"] == 1
    assert deltas["fleet.shed.high"] == 0
    assert deltas["serve.host_routed"] == (1 if fallback else 0)
    assert deltas["serve.shed.overflow"] == (0 if fallback else 1)


def test_top_class_sheds_under_the_port_default(pkgs, spark):
    """The port's sml.serve.hostFallback is off by default: past every
    bound the top class sheds (serve.shed.overflow), where the JAX
    package's default degrades it to the host route."""
    port = pkgs[1]
    assert port.conf.getBool("sml.serve.hostFallback") is False
    outcomes, deltas = _ladder(port, spark, "ladder-default")
    assert outcomes[-1] == ("shed", None)
    assert deltas["serve.shed.overflow"] == 1
    assert deltas["serve.host_routed"] == 0
    assert deltas["fleet.shed.high"] == 0


# ---------------------------------------------------------------- chaos
def test_kill_replica_mid_load_reroutes_never_hangs(pkgs, spark, obs_on,
                                                    tmp_path):
    """A replica killed with requests queued: every future resolves (its
    requests re-routed to the survivor), its bundle is on disk, and the
    autoscaler backfills to the floor; in both packages alike."""
    def run(p):
        m = _fit_linear(p, spark)
        _register(p, "fleet-kill", m)
        expected = p.scorer(m).score_block(_probe(rows=2))
        bb_dir = str(tmp_path / f"fleet-bb-{p.root}")
        with p.fleet.ReplicaPool("fleet-kill", replicas=2, start=False,
                                 timeout_millis=0, blackbox_dir=bb_dir,
                                 **p.kw) as pool:
            router = p.fleet.Router(pool)
            futs = [router.submit(_probe(rows=2)) for _ in range(6)]
            on_dead = [f for f in futs if f.replica_id == 0]
            r0 = p.counter("fleet.reroutes")
            bundle = pool.kill(0)
            assert os.path.isfile(os.path.join(bundle, "MANIFEST.json"))
            pool.get(1).endpoint._batcher.start()
            for f in futs:
                np.testing.assert_allclose(f.result(30), expected,
                                           rtol=1e-5)
            out = {"on_dead": len(on_dead),
                   "reroutes": p.counter("fleet.reroutes") - r0,
                   "moved": [f.replica_id for f in on_dead],
                   "size": pool.size()}
            asc = p.fleet.Autoscaler(pool, router, min_replicas=2,
                                     max_replicas=3)
            out["step"] = asc.step()["action"]
            out["after"] = pool.size()
        return out
    got = _each(pkgs, run)
    assert got["sml_tpu_torch"] == got["sml_tpu"]
    g = got["sml_tpu_torch"]
    assert g["on_dead"] == g["reroutes"] == 3
    assert g["moved"] == [1, 1, 1]
    assert (g["size"], g["step"], g["after"]) == (1, "backfill", 2)


def test_autoscaler_occupancy_bands(pkgs, spark):
    def run(p):
        _register(p, "fleet-bands", _fit_linear(p, spark))
        acts = []
        with p.fleet.ReplicaPool("fleet-bands", replicas=1, start=False,
                                 queue_rows=20, timeout_millis=0,
                                 **p.kw) as pool:
            router = p.fleet.Router(pool)
            asc = p.fleet.Autoscaler(pool, router, min_replicas=1,
                                     max_replicas=2,
                                     scale_up_occupancy=0.5,
                                     scale_down_occupancy=0.2)
            futs = [router.submit(_probe(rows=4), "high")
                    for _ in range(4)]
            acts.append((asc.step()["action"], pool.size()))
            for r in pool.replicas():
                r.endpoint._batcher.start()
            for f in futs:
                f.result(30)
            acts.append((asc.step()["action"], pool.size()))
            acts.append((asc.step()["action"], pool.size()))
        return acts
    got = _each(pkgs, run)
    assert got["sml_tpu_torch"] == got["sml_tpu"] == [
        ("up", 2), ("down", 1), ("hold", 1)]


def test_autoscaler_background_loop_steps_and_stops(pkgs, spark):
    port = pkgs[1]
    _register(port, "fleet-loop", _fit_linear(port, spark))
    with port.fleet.ReplicaPool("fleet-loop", replicas=1, start=False,
                                device="cpu") as pool:
        asc = port.fleet.Autoscaler(pool, min_replicas=2, max_replicas=2)
        asc.start(poll_s=0.02)
        deadline = __import__("time").monotonic() + 10
        while pool.size() < 2 and __import__("time").monotonic() < deadline:
            __import__("time").sleep(0.01)
        asc.stop()
        assert pool.size() == 2 and asc.last_error is None
        assert not asc._thread.is_alive()


# -------------------------------------------------------- staged rollout
def _rollout(p, spark, name, models, gate_kw, stage=2, gate_cls=None,
             **pool_kw):
    _register(p, name, *models)
    p.store.set_version_stage(name, stage, "Staging")
    gate_cls = gate_cls or p.ct.CanaryGate
    with p.fleet.ReplicaPool(name, replicas=2, canary_fraction=1.0,
                             flush_micros=500, **pool_kw, **p.kw) as pool:
        v = pool.promote(stage, gate=gate_cls(**gate_kw),
                         X=_probe(rows=6))
        served = [(r.rid, r.endpoint.current_version(),
                   r.endpoint.pinned_version()) for r in pool.replicas()]
        report = pool.report()
    return {"action": v["action"], "passed": v["passed"],
            "stages": [(s["rid"], s["passed"]) for s in v["stages"]],
            "checks": v["checks"], "evicted": v["evicted"],
            "aborted": v["aborted_by_transition"],
            "bundle": v["blackbox"] is not None
            and os.path.isdir(v["blackbox"]),
            "served": served,
            "registry": {k: _stage(p, name, k)
                         for k in range(1, len(models) + 1)},
            "last_rollout": report.get("last_rollout")}


def test_staged_rollout_promotes_clean_candidate(pkgs, spark, obs_on):
    got = _each(pkgs, lambda p: _rollout(
        p, spark, "fleet-clean",
        [_fit_linear(p, spark), _fit_linear(p, spark)],
        dict(min_mirrored=2, timeout_s=20.0, max_abs_diff=0.2,
             batch_rows=2)))
    assert got["sml_tpu_torch"] == got["sml_tpu"]
    g = got["sml_tpu_torch"]
    assert g["action"] == "promoted" and g["stages"] == [(0, True),
                                                         (1, True)]
    assert g["served"] == [(0, 2, None), (1, 2, None)]
    assert g["registry"] == {1: "Archived", 2: "Production"}


def test_staged_rollout_rolls_back_on_divergence_and_evicts(
        pkgs, spark, obs_on, tmp_path):
    got = _each(pkgs, lambda p: _rollout(
        p, spark, "fleet-diverge",
        [_fit_linear(p, spark), _fit_linear(p, spark, 1, -3.0)],
        dict(min_mirrored=2, timeout_s=20.0, max_abs_diff=0.05,
             batch_rows=2),
        blackbox_dir=str(tmp_path / f"rollout-bb-{p.root}")))
    assert got["sml_tpu_torch"] == got["sml_tpu"]
    g = got["sml_tpu_torch"]
    assert g["action"] == "rolled_back" and not g["passed"]
    assert g["checks"]["divergence"] is False and not g["aborted"]
    assert g["evicted"] == 0 and g["bundle"]
    assert g["served"] == [(1, 1, None)]
    assert g["registry"] == {1: "Production", 2: "Archived"}


def test_promote_during_rollout_race_aborts_cleanly(pkgs, spark, obs_on):
    def run(p):
        class RaceGate(p.ct.CanaryGate):
            """Passes, then lands a competing v3 promotion."""

            def run(self, endpoint, X, y, cand, inc):
                verdict = super().run(endpoint, X, y, cand, inc)
                p.store.set_version_stage("fleet-race", 3, "Production",
                                          archive_existing_versions=True)
                return verdict
        return _rollout(p, spark, "fleet-race",
                        [_fit_linear(p, spark) for _ in range(3)],
                        dict(min_mirrored=2, timeout_s=20.0, batch_rows=2),
                        gate_cls=RaceGate)
    got = _each(pkgs, run)
    assert got["sml_tpu_torch"] == got["sml_tpu"]
    g = got["sml_tpu_torch"]
    assert g["action"] == "rolled_back" and g["aborted"]
    assert g["evicted"] is None and not g["bundle"]
    assert g["served"] == [(0, 3, None), (1, 3, None)]
    assert g["registry"] == {1: "Archived", 2: "Archived", 3: "Production"}


def test_concurrent_promotes_serialize_on_the_rollout_lock(pkgs, spark,
                                                          obs_on):
    port = pkgs[1]
    _register(port, "fleet-dual",
              *[_fit_linear(port, spark) for _ in range(3)])
    port.store.set_version_stage("fleet-dual", 2, "Staging")
    port.store.set_version_stage("fleet-dual", 3, "Staging")
    results, errors = {}, {}
    with port.fleet.ReplicaPool("fleet-dual", replicas=2,
                                canary_fraction=1.0, flush_micros=500,
                                device="cpu") as pool:
        gate = port.ct.CanaryGate(min_mirrored=1, timeout_s=20.0,
                                  batch_rows=2)

        def promote(version):
            try:
                results[version] = pool.promote(version, gate=gate,
                                                X=_probe(rows=4))
            except ValueError as e:
                errors[version] = e

        threads = [threading.Thread(target=promote, args=(v,))
                   for v in (2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and len(results) == 2
        final = port.store.resolve_stage("fleet-dual",
                                         "Production")["version"]
        assert final in (2, 3)
        assert _stage(port, "fleet-dual", 5 - final) == "Archived"
        assert sorted({_stage(port, "fleet-dual", v) for v in (1, 2, 3)}) \
            == ["Archived", "Production"]
        for r in pool.replicas():
            assert r.endpoint.current_version() == final
            assert r.endpoint.pinned_version() is None


# -------------------------------------------------------- health surface
def test_engine_health_fleet_block_and_shed_reasons(pkgs, spark, obs_on):
    """None before any pool; with one, the per-replica table and the
    shed-by-class counters, equal between the packages; gone after the
    pool closes."""
    def run(p):
        before = p.obs.engine_health()["fleet"]
        _register(p, "fleet-health", _fit_linear(p, spark))
        with p.fleet.ReplicaPool("fleet-health", replicas=2, start=False,
                                 queue_rows=12, host_fallback=False,
                                 timeout_millis=0, **p.kw) as pool:
            router = p.fleet.Router(pool, priorities=["high", "low"])
            router.submit(_probe(rows=5), "low")
            router.submit(_probe(rows=5), "low")
            with pytest.raises(p.serving.RequestShed):
                router.submit(_probe(rows=5), "low").result(1)
            fl = p.obs.engine_health()["fleet"]
            for r in pool.replicas():
                r.endpoint._batcher.start()
        block = [b for b in fl["pools"] if b["name"] == "fleet-health"][0]
        after = p.fleet.fleet_report()
        return {"before": before, "shed_low": fl["shed_by_class"]["low"],
                "size": block["size"],
                "rows": [r["queue_rows"] for r in block["replicas"]],
                "versions": [r["version"] for r in block["replicas"]],
                "after": after is None or all(
                    b["name"] != "fleet-health" for b in after["pools"])}
    got = _each(pkgs, run)
    g = got["sml_tpu_torch"]
    assert g["before"] is None
    assert g["shed_low"] >= 1
    for k in ("size", "rows", "versions", "after"):
        assert g[k] == got["sml_tpu"][k], k
    assert g["rows"] == [5, 5] and g["after"]


def test_replica_start_shares_the_prewarm_replay(pkgs, spark, tmp_path):
    """The first replica claims the per-(manifest, card) prewarm guard;
    the second skips (prewarm.replica_skip)."""
    port = pkgs[1]
    from sml_tpu_torch.parallel import prewarm
    port.conf.set("sml.compile.cacheDir", str(tmp_path / "cache"))
    port.conf.set("sml.prewarm.enabled", True)
    prewarm.reset()
    try:
        _register(port, "fleet-warm", _fit_linear(port, spark))
        skip0 = port.counter("prewarm.replica_skip")
        with port.fleet.ReplicaPool("fleet-warm", replicas=2,
                                    flush_micros=500, device="cpu") as pool:
            assert pool.size() == 2
            t = pool.replicas()[0].endpoint.prewarm_thread
            assert t is not None
            t.join(30)
            assert pool.replicas()[1].endpoint.prewarm_thread is None
            assert port.counter("prewarm.replica_skip") == skip0 + 1
            assert prewarm.status()["state"] == "done"
    finally:
        port.conf.unset("sml.prewarm.enabled")
        port.conf.unset("sml.compile.cacheDir")
        prewarm.reset()


# ------------------------------------------------- continuous training
def test_ct_trainer_promotes_through_fleet(pkgs, spark, tmp_path, obs_on):
    """ContinuousTrainer(fleet=pool): a drifted window's warm refit
    promotes through the staged rollout, every replica gated, pinned and
    then converged on the committed alias, in both packages alike."""
    F = 6
    cols = [f"f{i}" for i in range(F)]

    def data(n, seed, shift=False):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, F))
        if shift:
            X[:, 0] += 1.5
            X[:, 2] *= 2.0
        y = (2.0 * X[:, 0] + 0.5 * X[:, 2] - X[:, 1] ** 2
             + rng.normal(0, 0.2, n)).astype(np.float32)
        return X, y

    from sml_tpu_torch.frame.session import get_session
    dpath = str(tmp_path / "stream")
    Xs, ys = data(900, seed=22, shift=True)
    block = {c: Xs[:, i] for i, c in enumerate(cols)}
    block["y"] = ys.astype(float)
    get_session().createDataFrame(block).write.format("delta") \
        .mode("errorifexists").save(dpath)
    jax_pkg = pkgs[0]
    prev = jax_pkg.conf.get("sml.tree.kernel")
    jax_pkg.conf.set("sml.tree.kernel", "xla")

    def run(p):
        from importlib import import_module
        chunks = import_module(f"{p.root}.frame._chunks")
        chunked = import_module(f"{p.root}.ml._chunked")
        spec = chunked.fit_ensemble_chunked(
            chunks.ArrayChunkSource(*data(2400, seed=11), chunk_rows=700),
            categorical={}, max_depth=3, max_bins=16, n_trees=6, seed=7,
            loss="squared", step_size=0.3, boosting=True, **p.kw)
        with p.tracking.start_run():
            p.tracking.spark.log_model(
                p.regression.GBTRegressionModel(spec), "model",
                registered_model_name="fleet-ct")
        p.store.set_version_stage("fleet-ct", 1, "Production")
        with p.fleet.ReplicaPool("fleet-ct", replicas=2,
                                 canary_fraction=1.0, flush_micros=500,
                                 **p.kw) as pool:
            trainer = p.ct.ContinuousTrainer(
                "fleet-ct", p.ct.DeltaChunkSource(dpath, cols, "y"),
                fleet=pool,
                gate=p.ct.CanaryGate(min_mirrored=3, timeout_s=20.0,
                                     quality_tol=1.2, batch_rows=64),
                fit_params={"seed": 7, "rounds_per_dispatch": 2},
                warm_rounds=3, min_rows=512, full_severity=1e9, **p.kw)
            rep = trainer.step()
            served = [(r.endpoint.current_version(),
                       r.endpoint.pinned_version())
                      for r in pool.replicas()]
        gate = rep["gate"]
        return {"action": rep["action"], "refit": rep["refit"],
                "severity": rep["severity"], "passed": gate["passed"],
                "gate_action": gate["action"],
                "stages": [(s["rid"], s["passed"]) for s in gate["stages"]],
                "checks": gate["checks"], "served": served,
                "registry": {v: _stage(p, "fleet-ct", v) for v in (1, 2)},
                "promotions": trainer.stats()["promotions"]}
    try:
        got = _each(pkgs, run)
    finally:
        jax_pkg.conf.set("sml.tree.kernel", prev)
    assert got["sml_tpu_torch"] == got["sml_tpu"]
    g = got["sml_tpu_torch"]
    assert (g["action"], g["refit"], g["gate_action"]) == (
        "promoted", "warm", "promoted")
    assert g["stages"] == [(0, True), (1, True)]
    assert g["served"] == [(2, None), (2, None)]
    assert g["registry"] == {1: "Archived", 2: "Production"}


def test_deadline_shed_counts_reason(pkgs, spark):
    """The batcher's deadline shed is reason-tagged, in both."""
    import time

    def run(p):
        scorer = p.scorer(_fit_linear(p, spark))
        b = p.serving.MicroBatcher(scorer.score_block, max_batch_rows=16,
                                   timeout_millis=30, flush_micros=1000,
                                   start=False)
        futs = [b.submit(_probe(rows=1)) for _ in range(3)]
        time.sleep(0.1)
        d0 = p.counter("serve.shed.deadline")
        b.start()
        shed = 0
        for f in futs:
            with pytest.raises(p.serving.RequestShed):
                f.result(30)
            shed += 1
        b.close()
        return shed, p.counter("serve.shed.deadline") - d0
    got = _each(pkgs, run)
    assert got["sml_tpu_torch"] == got["sml_tpu"] == (3, 3)
