"""The port's drift layer (`sml_tpu_torch/obs/drift.py`) against the
JAX package's (`sml_tpu/obs/drift.py`), on the CPU; the cases of
tests/test_drift.py but its regress sentry, whose port counterpart is in
tests/test_torch_regress.py.

- Sketches round-trip through JSON bit for bit, exact and compressed,
  and a sketch either package serializes loads in the other.
- On the same sketches `psi_distance`, `quantile_shift`,
  `categorical_psi`, `continuous_floor` and `categorical_floor` equal
  the JAX package's exactly (==): the floors' resamples draw the same
  seeded numpy streams.
- A monitor's report on an iid block flags nothing, on a shifted block
  exactly the moved features, and its per-feature rows equal the JAX
  package's report on the same block.
- A DT fit with the recorder on stamps a baseline: its feature and label
  sketches equal the JAX package's fit's exactly; its prediction sketch
  quantiles agree within 1e-3 of the label span (the port's f64
  histogram sums and the JAX package's f32 ones may pick another split
  near a tie, ROADMAP.md section 3).
- `baseline.json` written by either package loads in the other;
  `log_model` carries it; the chunked fit's baseline is its pass-1 sketch
  (equal to the JAX package's); the per-chunk ingest verdicts equal the
  JAX package's.
- The endpoint's drift block, its exemplars, a close racing a promote,
  an observer that raises, and the disabled-recorder cost of every
  observation site.

Each test that turns a package's recorder on restores it and resets
that package's obs at teardown.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from sml_tpu_torch import obs as pobs
from sml_tpu_torch import tracking as pt
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.frame._chunks import (ArrayChunkSource, DatasetSketch,
                                         FeatureSketch)
from sml_tpu_torch.obs import drift as pdrift

torch.set_num_threads(2)

F = 5
CAT = {4: 4}  # slot 4 is categorical, cardinality 4


@pytest.fixture()
def obs_on():
    """Both packages' recorders on, both reset; restored after."""
    from sml_tpu import obs as jobs
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    prev = {c: c.get("sml.obs.enabled") for c in (PCONF, JCONF)}
    for c in prev:
        c.set("sml.obs.enabled", True)
    pobs.reset()
    jobs.reset()
    yield
    for c, v in prev.items():
        c.set("sml.obs.enabled", bool(v))
    pobs.reset()
    jobs.reset()
    pdrift.DRIFT.unregister("ingest")
    jobs.drift.DRIFT.unregister("ingest")


@pytest.fixture()
def min_rows_64():
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    prev = {c: c.get("sml.obs.driftMinRows") for c in (PCONF, JCONF)}
    for c in prev:
        c.set("sml.obs.driftMinRows", 64)
    yield
    for c, v in prev.items():
        c.set("sml.obs.driftMinRows", v)


def make_xy(n, seed, shift=False):
    """4 continuous features and 1 categorical slot; `shift` moves f0
    (location), f2 (scale) and the categorical frequencies."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float64)
    p = np.asarray([0.4, 0.3, 0.2, 0.1])
    if shift:
        X[:, 0] += 1.5
        X[:, 2] *= 2.0
        p = p[::-1].copy()
    X[:, 4] = rng.choice(4, size=n, p=p)
    y = (2.0 * X[:, 0] - X[:, 1] + rng.normal(0, 0.2, n)).astype(np.float32)
    return X, y


def make_baseline(mod, n=8000, seed=3):
    """A DriftBaseline of `mod` (either package's drift module)."""
    import importlib
    chunks = importlib.import_module(
        mod.__name__.replace(".obs.drift", ".frame._chunks"))
    X, y = make_xy(n, seed)
    ds = chunks.DatasetSketch(F, CAT)
    ds.update(X, y)
    lab = chunks.FeatureSketch()
    lab.update(y)
    return mod.DriftBaseline(ds, label=lab, n_rows=n, sampled_rows=n)


def _jdrift():
    from sml_tpu.obs import drift as jdrift
    return jdrift


def _strip(report):
    """A report without its wall-clock staleness field."""
    return {k: v for k, v in report.items() if k != "idle_s"}


# ------------------------------------------------------------ serialization
def test_feature_sketch_roundtrip_exact_bit_identical():
    from sml_tpu.frame._chunks import FeatureSketch as JSketch
    rng = np.random.default_rng(0)
    sk = FeatureSketch()
    sk.update(rng.normal(size=3000).astype(np.float32))
    sk.update(rng.normal(size=1000).astype(np.float32))
    d = json.loads(json.dumps(sk.to_dict()))
    back = FeatureSketch.from_dict(d)
    assert back.exact and back.n_seen == sk.n_seen
    qs = np.linspace(0, 1, 65)[1:-1]
    assert np.array_equal(sk.quantiles(qs), back.quantiles(qs))
    probes = np.linspace(-3, 3, 41)
    assert np.array_equal(sk.cdf(probes), back.cdf(probes))
    # the JAX package reads the port's sketch to the same quantiles
    assert np.array_equal(JSketch.from_dict(d).quantiles(qs),
                          sk.quantiles(qs))
    # merge-compatible after load
    extra = rng.normal(size=500).astype(np.float32)
    for s in (sk, back):
        more = FeatureSketch()
        more.update(extra)
        s.merge(more)
    assert np.array_equal(sk.quantiles(qs), back.quantiles(qs))


def test_feature_sketch_roundtrip_compressed():
    from sml_tpu.frame._chunks import FeatureSketch as JSketch
    rng = np.random.default_rng(1)
    vals = rng.normal(size=2000), rng.normal(size=100)
    sk = FeatureSketch(buckets=64, exact_cap=500)
    jsk = JSketch(buckets=64, exact_cap=500)
    for v in vals:
        sk.update(v)
        jsk.update(v)
    assert not sk.exact and sk.compressions >= 1
    d = json.loads(json.dumps(sk.to_dict()))
    assert d == json.loads(json.dumps(jsk.to_dict()))
    back = FeatureSketch.from_dict(d)
    assert not back.exact
    qs = np.linspace(0, 1, 33)[1:-1]
    assert np.array_equal(sk.quantiles(qs), back.quantiles(qs))
    more = FeatureSketch(buckets=64, exact_cap=500)
    more.update(rng.normal(size=800))
    back.merge(more)
    assert back.n_seen == sk.n_seen + 800


def test_dataset_sketch_roundtrip_with_categoricals():
    from sml_tpu.frame._chunks import DatasetSketch as JDataset
    X, y = make_xy(4000, seed=5)
    ds = DatasetSketch(F, CAT)
    ds.update(X, y)
    d = json.loads(json.dumps(ds.to_dict()))
    back = DatasetSketch.from_dict(d)
    jback = JDataset.from_dict(d)
    assert back.n_rows == ds.n_rows and back.categorical == CAT
    np.testing.assert_array_equal(ds._cat_cnt[4], back._cat_cnt[4])
    np.testing.assert_array_equal(ds._cat_cnt[4], jback._cat_cnt[4])
    qs = np.linspace(0, 1, 33)[1:-1]
    for f, sk in ds.features.items():
        assert np.array_equal(sk.quantiles(qs),
                              back.features[f].quantiles(qs))
        assert np.array_equal(sk.quantiles(qs),
                              jback.features[f].quantiles(qs))


# ----------------------------------------------------------------- distances
def _pair(chunks, base_v, live_v, exact_cap):
    b = chunks.FeatureSketch(buckets=1024, exact_cap=exact_cap)
    b.update(base_v)
    l = chunks.FeatureSketch(buckets=1024, exact_cap=exact_cap)
    l.update(live_v)
    return b, l


@pytest.mark.parametrize("exact_cap", [10 ** 9, 4096])
@pytest.mark.parametrize("n_live", [300, 8000])
def test_distances_and_floors_equal_the_reference(exact_cap, n_live):
    """Bit for bit on the same sketches, exact and compressed."""
    import sml_tpu.frame._chunks as jchunks
    import sml_tpu_torch.frame._chunks as pchunks
    jdrift = _jdrift()
    rng = np.random.default_rng(7)
    base_v = rng.normal(size=20000)
    live_v = rng.normal(size=n_live) * 1.3 + 0.4
    pb, pl = _pair(pchunks, base_v, live_v, exact_cap)
    jb, jl = _pair(jchunks, base_v, live_v, exact_cap)
    assert pdrift.psi_distance(pb, pl) == jdrift.psi_distance(jb, jl)
    assert pdrift.quantile_shift(pb, pl) == jdrift.quantile_shift(jb, jl)
    np.testing.assert_array_equal(pdrift.baseline_edges(pb),
                                  jdrift.baseline_edges(jb))
    for feature in (0, 3):
        assert pdrift.continuous_floor(pb, n_live, feature, 3, 10) \
            == jdrift.continuous_floor(jb, n_live, feature, 3, 10)
    bc = np.asarray([400.0, 300.0, 200.0, 100.0])
    lc = np.asarray([10.0, 40.0, 90.0, 160.0])
    assert pdrift.categorical_psi(bc, lc) == jdrift.categorical_psi(bc, lc)
    for feature in (1, 4):
        assert pdrift.categorical_floor(bc, n_live, feature, 3) \
            == jdrift.categorical_floor(bc, n_live, feature, 3)


def test_distance_parity_exact_vs_compressed():
    import sml_tpu_torch.frame._chunks as pchunks
    rng = np.random.default_rng(7)
    base_v = rng.normal(size=20000)
    live_v = rng.normal(size=8000) + 0.8
    be, le = _pair(pchunks, base_v, live_v, 10 ** 9)
    bc, lc = _pair(pchunks, base_v, live_v, 4096)
    assert be.exact and le.exact and not bc.exact and not lc.exact
    psi_e, psi_c = pdrift.psi_distance(be, le), pdrift.psi_distance(bc, lc)
    sh_e, sh_c = pdrift.quantile_shift(be, le), pdrift.quantile_shift(bc, lc)
    assert psi_e > 0.25 and psi_c > 0.25
    assert abs(psi_e - psi_c) < 0.1 * max(psi_e, psi_c)
    assert abs(sh_e - sh_c) < 0.1 * max(sh_e, sh_c)
    lv2 = rng.normal(size=8000)
    _, le2 = _pair(pchunks, base_v, lv2, 10 ** 9)
    _, lc2 = _pair(pchunks, base_v, lv2, 4096)
    assert pdrift.psi_distance(be, le2) < 0.02
    assert pdrift.psi_distance(bc, lc2) < 0.02


@pytest.mark.parametrize("shift", [False, True])
def test_block_verdicts_equal_the_reference(obs_on, shift):
    """An iid block flags nothing; a shifted one exactly f0, f2 and the
    categorical f4; every per-feature row equals the JAX package's."""
    jdrift = _jdrift()
    X, _ = make_xy(3000, seed=78 if shift else 77, shift=shift)
    rep = pdrift.evaluate_block(make_baseline(pdrift), X)
    jrep = jdrift.evaluate_block(make_baseline(jdrift), X)
    assert rep["ready"]
    if shift:
        assert set(rep["flagged"]) == {"f0", "f2", "f4"}
        assert set(rep["top"][:3]) == {"f0", "f2", "f4"}
        kinds = {e["feature"]: e["kind"] for e in rep["features"]}
        assert kinds["f4"] == "categorical"
    else:
        assert rep["flagged"] == [] and rep["max_severity"] < 1.0
    assert _strip(rep) == _strip(jrep)


def test_reloaded_baseline_self_distance_exactly_zero():
    base = make_baseline(pdrift)
    back = pdrift.DriftBaseline.from_dict(
        json.loads(json.dumps(base.to_dict())))
    for f, sk in base.features.features.items():
        assert pdrift.psi_distance(sk, back.features.features[f]) == 0.0
        assert pdrift.quantile_shift(sk, back.features.features[f]) == 0.0
    assert pdrift.categorical_psi(base.features._cat_cnt[4],
                                  back.features._cat_cnt[4]) == 0.0


# ----------------------------------------------------- fit-time capture
@pytest.fixture()
def jax_xla(spark):
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    prev = JCONF.get("sml.tree.kernel")
    JCONF.set("sml.tree.kernel", "xla")
    yield
    JCONF.set("sml.tree.kernel", prev)


def _dt_kw():
    return dict(categorical=CAT, max_depth=4, max_bins=16, min_instances=1,
                min_info_gain=0.0, n_trees=1, feature_k=None,
                bootstrap=False, subsample=1.0, seed=3, loss="squared")


def test_dt_fit_baseline_against_the_reference(obs_on, jax_xla):
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    from sml_tpu_torch.ml._tree_models import _fit_ensemble as pfit
    X, y = make_xy(3000, seed=11)
    pspec = pfit(X, y, device="cpu", **_dt_kw())
    jspec = jfit(X, y, **_dt_kw())
    pb, jb = pspec.baseline, jspec.baseline
    assert pb is not None and jb is not None
    assert pb.n_rows == jb.n_rows == 3000
    assert pb.sampled_rows == jb.sampled_rows
    assert pb.features.to_dict() == jb.features.to_dict()
    assert pb.label.to_dict() == jb.label.to_dict()
    qs = np.linspace(0, 1, 33)
    span = float(y.max() - y.min())
    np.testing.assert_allclose(pb.prediction.quantiles(qs),
                               jb.prediction.quantiles(qs),
                               rtol=0, atol=1e-3 * span)


def test_obs_off_fit_stamps_no_baseline():
    from sml_tpu_torch.ml._tree_models import _fit_ensemble as pfit
    X, y = make_xy(500, seed=12)
    assert pfit(X, y, device="cpu", **_dt_kw()).baseline is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_baseline_json_loads_in_either_package(obs_on, jax_xla, tmp_path,
                                               writer):
    from sml_tpu.ml._tree_models import _EnsembleSpec as JSpec
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    from sml_tpu_torch.ml._tree_models import _EnsembleSpec as PSpec
    from sml_tpu_torch.ml._tree_models import _fit_ensemble as pfit
    X, y = make_xy(1500, seed=13)
    path = str(tmp_path / "spec")
    os.makedirs(path)
    if writer == "port":
        spec = pfit(X, y, device="cpu", **_dt_kw())
        spec.save(path)
        back = JSpec.load(path)
    else:
        spec = jfit(X, y, **_dt_kw())
        spec.save(path)
        back = PSpec.load(path)
    assert os.path.exists(os.path.join(path, "baseline.json"))
    assert back.baseline is not None
    assert back.baseline.to_dict() == spec.baseline.to_dict()
    for f, sk in spec.baseline.features.features.items():
        assert pdrift.psi_distance(
            sk, back.baseline.features.features[f]) == 0.0


@pytest.fixture()
def stores(tmp_path):
    from sml_tpu import tracking as jt
    root = str(tmp_path / "runs")
    for m in (pt, jt):
        m.set_tracking_uri(root)
        m._active_experiment["id"] = None
    PCONF.set("sml.device", "cpu")
    yield root
    for m in (pt, jt):
        while m.active_run():
            m.end_run()
        m._active_experiment["id"] = None
    PCONF.unset("sml.device")


def _port_forest_pipeline(n=1200, seed=0):
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.base import Pipeline
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import RandomForestRegressor
    X, y = make_xy(n, seed)
    block = {f"x{i}": X[:, i] for i in range(F)}
    block["y"] = y.astype(np.float64)
    df = get_session().createDataFrame(block)
    va = VectorAssembler(inputCols=[f"x{i}" for i in range(F)],
                         outputCol="features")
    return Pipeline(stages=[va, RandomForestRegressor(
        labelCol="y", numTrees=3, maxDepth=4, seed=11)]).fit(df)


def test_log_model_carries_the_baseline(obs_on, stores, spark):
    from sml_tpu import tracking as jt
    model = _port_forest_pipeline()
    base = model.stages[-1]._spec.baseline
    assert base is not None and base.prediction is not None
    with pt.start_run():
        pt.spark.log_model(model, "model",
                           registered_model_name="drift-model")
    back = pt.spark.load_model("models:/drift-model/1")
    assert back.stages[-1]._spec.baseline.to_dict() == base.to_dict()
    jback = jt.spark.load_model("models:/drift-model/1")
    assert jback.stages[-1]._spec.baseline.to_dict() == base.to_dict()


def test_chunked_fit_reuses_its_ingest_sketch(obs_on, jax_xla):
    from sml_tpu.frame._chunks import ArrayChunkSource as JSource
    from sml_tpu.ml._chunked import fit_ensemble_chunked as jchunked
    from sml_tpu_torch.ml._chunked import fit_ensemble_chunked
    X, y = make_xy(4000, seed=21)
    kw = dict(categorical=CAT, max_depth=3, max_bins=16, n_trees=2,
              bootstrap=True, seed=5)
    spec = fit_ensemble_chunked(ArrayChunkSource(X, y, chunk_rows=1000),
                                device="cpu", **kw)
    base = spec.baseline
    assert base is not None
    assert base.features.n_rows == 4000 and base.n_rows == 4000
    jbase = jchunked(JSource(X, y, chunk_rows=1000), **kw).baseline
    assert base.features.to_dict() == jbase.features.to_dict()
    Xi, _ = make_xy(2000, seed=22)
    assert pdrift.evaluate_block(base, Xi)["n_flagged"] == 0


def test_per_chunk_ingest_drift(obs_on, min_rows_64, spark):
    from sml_tpu import obs as jobs
    from sml_tpu.frame._chunks import ArrayChunkSource as JSource
    from sml_tpu.ml._chunked import ingest_source as jingest
    from sml_tpu_torch.ml._chunked import ingest_source
    base, jbase = make_baseline(pdrift), make_baseline(_jdrift())
    for seed, shift, flagged in ((41, True, 4), (42, False, 0)):
        Xs, ys = make_xy(2000, seed=seed, shift=shift)
        ingest_source(ArrayChunkSource(Xs, ys, chunk_rows=500), 16, CAT,
                      device="cpu", label="drift-test", drift_baseline=base)
        jingest(JSource(Xs, ys, chunk_rows=500), 16, CAT,
                label="drift-test", drift_baseline=jbase)
        rep = pobs.engine_health()["drift"]["ingest"]
        jrep = jobs.engine_health()["drift"]["ingest"]
        assert rep["chunks"]["observed"] == 4
        assert rep["chunks"]["flagged"] == flagged
        assert rep["chunks"] == jrep["chunks"]
        if shift:
            assert "f0" in rep["flagged"]
            assert pobs.RECORDER.counters()["drift.chunk_flagged"] >= 4
    # the ingest's chunks land in the straggler attribution too
    ingest = pobs.engine_health()["ingest"]
    assert ingest["n_devices"] == 4 and ingest["programs"] == 2


# ----------------------------------------------------------------- serving
@pytest.fixture()
def drift_serving(obs_on, min_rows_64, stores):
    model = _port_forest_pipeline()
    with pt.start_run():
        pt.spark.log_model(model, "model",
                           registered_model_name="drift-serve")
    pt.MlflowClient().transition_model_version_stage(
        "drift-serve", 1, stage="Production")
    yield model


KEY = "serve.drift-serve/Production"


def test_serving_drift_block_and_exemplars(drift_serving):
    from sml_tpu_torch.serving import ServingEndpoint
    Xs, _ = make_xy(512, seed=91, shift=True)
    with ServingEndpoint("drift-serve", "Production", flush_micros=500,
                         device="cpu") as ep:
        futs = [ep.submit(Xs[lo:lo + 8]) for lo in range(0, 512, 8)]
        for f in futs:
            f.result(timeout=30)
        health = ep.health_report()
        block = health["drift"][KEY]
        assert block["ready"] and block["rows"] >= 512
        assert "f0" in block["flagged"] and "f2" in block["flagged"]
        by_name = {e["feature"]: e for e in block["features"]}
        worst = by_name["f0"]["worst_trace"]
        assert worst is not None and worst.startswith("0x")
        assert int(worst, 16) in {f.trace_id for f in futs}
        assert pobs.engine_health()["drift"][KEY]["rows"] == block["rows"]
        assert "drift.report" in {e.name for e in pobs.RECORDER.events()}
    # close() unregisters the monitor
    assert pobs.engine_health()["drift"] is None \
        or KEY not in pobs.engine_health()["drift"]


def test_serving_iid_traffic_stays_clean(drift_serving):
    """One request at a time: no deadline pressure, no shed."""
    from sml_tpu_torch.serving import ServingEndpoint
    Xi, _ = make_xy(512, seed=92)
    with ServingEndpoint("drift-serve", "Production", flush_micros=200,
                         device="cpu") as ep:
        for lo in range(0, 512, 8):
            ep.score(Xi[lo:lo + 8], timeout=30)
        block = ep.health_report()["drift"][KEY]
    assert block["ready"] and block["rows"] == 512
    assert block["flagged"] == []


def test_a_raising_observer_is_counted_not_served(drift_serving):
    from sml_tpu_torch.serving import ServingEndpoint
    X, _ = make_xy(16, seed=93)
    with ServingEndpoint("drift-serve", "Production", flush_micros=200,
                         device="cpu") as ep:
        ref = ep.score(X[:8], timeout=30)

        class Boom:
            baseline = None

            def observe_block(self, *a):
                raise RuntimeError("observer died")

        ep._drift = Boom()
        got = ep.score(X[:8], timeout=30)
    np.testing.assert_array_equal(got, ref)
    assert pobs.RECORDER.counters().get("drift.observe_error", 0) >= 1


def test_close_racing_a_promote_leaves_no_monitor(drift_serving):
    """A hot-swap from the stage listener's thread racing close(): the
    registry never keeps a monitor whose endpoint is closed."""
    from sml_tpu_torch.serving import ServingEndpoint
    model = drift_serving
    with pt.start_run():
        pt.spark.log_model(model, "model",
                           registered_model_name="drift-serve")
    client = pt.MlflowClient()
    for _ in range(5):
        ep = ServingEndpoint("drift-serve", "Production", flush_micros=200,
                             device="cpu")
        assert KEY in pobs.DRIFT.report()

        def promote():
            client.transition_model_version_stage("drift-serve", 2,
                                                  stage="Production")

        t = threading.Thread(target=promote)
        t.start()
        ep.close()
        t.join()
        # a straggling listener after close() must not re-register
        ep._install_drift()
        assert pobs.DRIFT.get(KEY) is None
        client.transition_model_version_stage("drift-serve", 2,
                                              stage="Staging")


# ------------------------------------------------- disabled-path overhead
def test_disabled_overhead_drift_observation_sites():
    assert not PCONF.getBool("sml.obs.enabled")
    assert not pobs.RECORDER.enabled
    base = make_baseline(pdrift, n=1000, seed=55)
    mon = pdrift.DriftMonitor(base, name="overhead")
    X, _ = make_xy(8, seed=56)
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        mon.observe_block(X)
    per = (time.perf_counter() - t0) / n
    assert per < 20e-6, f"{per * 1e6:.2f}us per disabled observe_block"
    assert mon._slots == []
    chunk = DatasetSketch(F, CAT)
    t0 = time.perf_counter()
    for _ in range(2000):
        mon.observe_sketch(chunk, 0)
    per = (time.perf_counter() - t0) / 2000
    assert per < 20e-6, f"{per * 1e6:.2f}us per disabled observe_sketch"
    assert mon._chunks == []
    assert pdrift.capture_fit_baseline(
        np.zeros((10, F)), np.zeros(10), None, object()) is None
