"""The port's continuous training (`sml_tpu_torch/ct`: the live chunk
sources, the canary gate and the `ContinuousTrainer`) on the CPU, held
against the live JAX package (modelled on tests/test_ct.py:248-460).

- Sources: a memory-sink query's micro-batches (`StreamChunkSource`) and
  a Delta table's versions past a watermark (`DeltaChunkSource`) give
  the same chunks, bit for bit, as the JAX package's adapters over the
  same files; a snapshot is re-iterable and `advance()` consumes it.
- The closed loop: the same appends (under `minRefitRows`, iid, then a
  drifted window) to one Delta table drive a trainer in each package
  (each with its own registry and endpoint, `device="cpu"` for the
  port). Actions, drift severities (==), refit modes, versions, stages,
  tracked params and the gate's verdict and checks are equal. The
  candidate's and the incumbent's gate RMSEs agree within rtol 1e-6
  (the chunked fits' rule in tests/test_torch_chunked.py): the port sums
  histograms in float64 where the JAX package sums f32, and that can
  flip a near-tied split (ROADMAP.md section 3), but on these windows
  the trees' predictions agree to that tolerance.
- A gate whose mirror quorum cannot be met rolls back in both; a full
  refit (severity over `fullSeverity`) and a checkpointed warm refit
  run; the background loop accumulates, stops and joins its thread, and
  keeps a failed cycle's error; the gate without an endpoint judges
  quality alone, as the JAX package's does.
"""

import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N, F = 1200, 6
COLS = [f"f{i}" for i in range(F)]
RTOL = 1e-6


def _data(n=N, seed=3, shift=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    if shift:
        X[:, 0] += 1.5
        X[:, 2] *= 2.0
    y = (2.0 * X[:, 0] + 0.5 * X[:, 2] - X[:, 1] ** 2
         + rng.normal(0, 0.2, n)).astype(np.float32)
    return X, y


class Pkg:
    """One package's modules, by name."""

    def __init__(self, root):
        import importlib
        self.root = root
        self.ct = importlib.import_module(f"{root}.ct")
        self.tracking = importlib.import_module(f"{root}.tracking")
        self.store = importlib.import_module(f"{root}.tracking._store")
        self.chunks = importlib.import_module(f"{root}.frame._chunks")
        self.chunked = importlib.import_module(f"{root}.ml._chunked")
        self.regression = importlib.import_module(f"{root}.ml.regression")
        self.serving = importlib.import_module(f"{root}.serving")
        self.obs = importlib.import_module(f"{root}.obs")
        self.conf = importlib.import_module(f"{root}.conf").GLOBAL_CONF
        self.prof = importlib.import_module(
            f"{root}.utils.profiler").PROFILER
        self.kw = {"device": "cpu"} if root == "sml_tpu_torch" else {}


@pytest.fixture(scope="module")
def pkgs():
    return Pkg("sml_tpu"), Pkg("sml_tpu_torch")


@pytest.fixture(autouse=True)
def confs(pkgs, tmp_path):
    """The JAX fits on the XLA path with histogram subtraction (as the
    port builds), the port on the CPU, both recorders on (a fit carries
    its drift baseline only then) with their bundles in tmp_path, and
    each package's registry in a directory of its own."""
    jax_pkg, port = pkgs
    keys = ("sml.tree.kernel", "sml.tree.histSubtraction",
            "sml.obs.enabled", "sml.obs.blackboxDir")
    prev = {k: jax_pkg.conf.get(k) for k in keys}
    jax_pkg.conf.set("sml.tree.kernel", "xla")
    jax_pkg.conf.set("sml.tree.histSubtraction", True)
    port.conf.set("sml.device", "cpu")
    for p in pkgs:
        p.conf.set("sml.obs.enabled", True)
        p.conf.set("sml.obs.blackboxDir",
                   str(tmp_path / f"blackbox-{p.root}"))
        p.obs.reset()
        p.tracking.set_tracking_uri(str(tmp_path / f"runs-{p.root}"))
        p.tracking.set_experiment("Default")
    yield
    for p in pkgs:
        while p.tracking.active_run():
            p.tracking.end_run()
        p.obs.reset()
    for k, v in prev.items():
        jax_pkg.conf.set(k, v)
    for k in ("sml.device", "sml.obs.enabled", "sml.obs.blackboxDir"):
        port.conf.unset(k)


def _port_session():
    from sml_tpu_torch.frame.session import get_session
    return get_session()


def _delta_append(path, X, y):
    """Append (X, y) to the Delta table at `path` through the port."""
    block = {c: X[:, i] for i, c in enumerate(COLS)}
    block["y"] = y.astype(float)
    mode = "append" if os.path.exists(path) else "errorifexists"
    _port_session().createDataFrame(block).write.format("delta") \
        .mode(mode).save(path)


def _seed_registry(p, name, X, y):
    spec = p.chunked.fit_ensemble_chunked(
        p.chunks.ArrayChunkSource(X, y, chunk_rows=700), categorical={},
        max_depth=3, max_bins=16, n_trees=6, seed=7, loss="squared",
        step_size=0.3, boosting=True, **p.kw)
    assert spec.baseline is not None
    with p.tracking.start_run():
        p.tracking.spark.log_model(p.regression.GBTRegressionModel(spec),
                                   "model", registered_model_name=name)
    p.store.set_version_stage(name, 1, "Production")
    return spec


def _runs(p, name):
    return [r for e in p.store.list_experiments()
            for r in p.store.list_runs(e["experiment_id"])
            if r["tags"].get("ct.trainer") == name]


def _stages(p, name):
    return {v["version"]: v["current_stage"]
            for v in p.store.list_model_versions(name)}


def _same_report(a, b, what):
    """Actions, rows, severities, refits, versions and the gate's verdict
    equal; the gate's RMSEs within RTOL."""
    for k in ("action", "rows", "refit", "version", "incumbent",
              "need_rows"):
        assert a.get(k) == b.get(k), (what, k, a.get(k), b.get(k))
    assert a.get("severity") == b.get("severity"), what
    if a.get("drift") is not None:
        assert a["drift"]["flagged"] == b["drift"]["flagged"], what
    ga, gb = a.get("gate"), b.get("gate")
    assert (ga is None) == (gb is None), what
    if ga is not None:
        assert ga["passed"] == gb["passed"], what
        assert ga["checks"] == gb["checks"], what
        for k in ("rmse_candidate", "rmse_incumbent"):
            np.testing.assert_allclose(gb[k], ga[k], rtol=RTOL,
                                       err_msg=f"{what} {k}")


# --------------------------------------------------------------- sources
def test_stream_chunk_source_snapshot_advance(pkgs, spark, tmp_path):
    """The same parquet parts through each package's memory-sink query:
    the port's StreamChunkSource gives the JAX package's chunks."""
    from sml_tpu_torch.frame import parquet as ppq
    jax_pkg, port = pkgs
    src_dir = tmp_path / "stream-src"
    src_dir.mkdir()
    X, y = _data(300, seed=9)

    def part(name, lo, hi):
        block = {c: X[lo:hi, i] for i, c in enumerate(COLS)}
        block["y"] = y[lo:hi].astype(float)
        ppq.write_table(block, str(src_dir / name))

    part("p0.parquet", 0, 100)
    part("p1.parquet", 100, 200)
    schema = ", ".join(f"{c} double" for c in COLS) + ", y double"
    queries = {}
    for p, session in ((jax_pkg, spark), (port, _port_session())):
        sdf = session.readStream.schema(schema) \
            .option("maxFilesPerTrigger", 1).parquet(str(src_dir))
        queries[p.root] = sdf.writeStream.format("memory") \
            .queryName(f"ct_src_{p.root}").start()
    try:
        sources = {}
        for p in pkgs:
            queries[p.root].processAllAvailable()
            sources[p.root] = p.ct.StreamChunkSource(
                queries[p.root], COLS, "y", chunk_rows=64)
            assert sources[p.root].snapshot() == 200
        jsrc, psrc = sources["sml_tpu"], sources["sml_tpu_torch"]
        got = [(Xc, yc) for Xc, yc in psrc.chunks()]
        want = [(Xc, yc) for Xc, yc in jsrc.chunks()]
        assert [len(c) for c, _ in got] == [64, 36, 64, 36]
        for (xa, ya), (xb, yb) in zip(got, want):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(np.concatenate([c for c, _ in got]),
                                      X[:200])
        # re-iterable: the two-pass ingest's contract
        np.testing.assert_array_equal(
            np.concatenate([c for c, _ in psrc.chunks()]), X[:200])
        psrc.advance()
        part("p2.parquet", 200, 300)
        queries["sml_tpu_torch"].processAllAvailable()
        assert psrc.snapshot() == 100
        np.testing.assert_array_equal(
            np.concatenate([c for c, _ in psrc.chunks()]), X[200:])
        assert psrc.fingerprint() is None
    finally:
        for q in queries.values():
            q.stop()
    with pytest.raises(ValueError, match="memory-sink"):
        port.ct.StreamChunkSource(object(), COLS, "y")


def test_delta_chunk_source_watermark(pkgs, tmp_path):
    """Two versions of one table: each package's DeltaChunkSource streams
    the same chunks, and only the versions past its watermark."""
    dpath = str(tmp_path / "delta-src")
    X, y = _data(500, seed=13)
    _delta_append(dpath, X[:300], y[:300])
    srcs = [p.ct.DeltaChunkSource(dpath, COLS, "y", chunk_rows=128)
            for p in pkgs]
    jsrc, psrc = srcs
    assert psrc.snapshot() == jsrc.snapshot() == 300
    a = [(Xc, yc) for Xc, yc in psrc.chunks()]
    b = [(Xc, yc) for Xc, yc in jsrc.chunks()]
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in a]),
                                  X[:300])
    np.testing.assert_array_equal(
        np.concatenate([c for c, _ in psrc.chunks()]), X[:300])
    assert psrc.fingerprint() == jsrc.fingerprint()
    psrc.advance()
    assert psrc.snapshot() == 0
    _delta_append(dpath, X[300:], y[300:])
    assert psrc.snapshot() == 200
    got = np.concatenate([c for c, _ in psrc.chunks()])
    np.testing.assert_array_equal(got, X[300:])
    ys = np.concatenate([yy for _, yy in psrc.chunks()])
    np.testing.assert_allclose(ys, y[300:].astype(np.float64))


# ----------------------------------------------------------- closed loop
def _closed_loop(p, dpath, steps, name, **trainer_kw):
    """The seed model registered in `p`, an endpoint on it, and one
    trainer step after each append of `steps` ((rows, seed[, shift]))
    to the Delta table at `dpath`. Returns the reports, the trainer's
    stats, the stages, the tracked runs and the served version."""
    _seed_registry(p, name, *_data(2800, seed=11))
    gate_kw = dict(dict(min_mirrored=3, timeout_s=20.0, quality_tol=1.2,
                        batch_rows=64), **trainer_kw.pop("gate_kw", {}))
    reports = []
    with p.serving.ServingEndpoint(name, "Production",
                                   canary_fraction=1.0, flush_micros=500,
                                   **p.kw) as ep:
        trainer = p.ct.ContinuousTrainer(
            name, p.ct.DeltaChunkSource(dpath, COLS, "y"), endpoint=ep,
            gate=p.ct.CanaryGate(**gate_kw), **trainer_kw, **p.kw)
        for n, seed, *shift in steps:
            _delta_append(dpath, *_data(n, seed=seed, shift=bool(shift)))
            reports.append(trainer.step())
        served = ep.current_version()
    return {"reports": reports, "stats": trainer.stats(),
            "stages": _stages(p, name), "runs": _runs(p, name),
            "served": served}


def _both(pkgs, tmp_path, name, steps, **trainer_kw):
    """`_closed_loop` in each package, each over a table of its own that
    the port's writer fills with the same appends (the same files)."""
    out = {}
    for p in pkgs:
        out[p.root] = _closed_loop(p, str(tmp_path / f"stream-{p.root}"),
                                   steps, name, **dict(trainer_kw))
    return out["sml_tpu"], out["sml_tpu_torch"]


LOOP_KW = dict(fit_params={"seed": 7, "rounds_per_dispatch": 2},
               warm_rounds=3, min_rows=512, full_severity=1e9)


def test_trainer_closed_loop_promotes_on_drift(pkgs, tmp_path):
    """Under minRefitRows → accumulate; iid → clean; drifted → a warm
    refit, Staging, the gate, Production and the hot swap, equal in
    both packages."""
    want, got = _both(pkgs, tmp_path, "ct-loop",
                      [(200, 20), (600, 21), (900, 22, True)], **LOOP_KW)
    actions = [r["action"] for r in got["reports"]]
    assert actions == ["accumulate", "clean", "promoted"]
    for i, (a, b) in enumerate(zip(want["reports"], got["reports"])):
        _same_report(a, b, f"cycle {i}")
    rep = got["reports"][2]
    assert rep["refit"] == "warm" and rep["severity"] >= 1.0
    assert rep["gate"]["passed"] and rep["gate"]["request_errors"] == 0
    assert got["reports"][1]["severity"] < 1.0
    assert got["served"] == want["served"] == 2
    assert got["stages"] == want["stages"] == {1: "Archived",
                                               2: "Production"}
    for k in ("cycles", "clean", "accumulating", "refits", "warm_refits",
              "full_refits", "promotions", "rollbacks", "errors"):
        assert got["stats"][k] == want["stats"][k], k
    assert len(got["runs"]) == len(want["runs"]) == 1
    assert got["runs"][0]["params"] == want["runs"][0]["params"]
    assert got["runs"][0]["metrics"]["ct.gate_passed"] == 1.0
    for k in ("ct.rmse_candidate", "ct.rmse_incumbent"):
        np.testing.assert_allclose(got["runs"][0]["metrics"][k],
                                   want["runs"][0]["metrics"][k], rtol=RTOL)


def test_trainer_gate_failure_rolls_back(pkgs, tmp_path):
    """An unobservable canary (a quorum it cannot reach) fails the gate
    in both: the candidate archived, the incumbent serving, a bundle."""
    want, got = _both(pkgs, tmp_path, "ct-rollback", [(900, 22, True)],
                      gate_kw=dict(min_mirrored=10 ** 6, timeout_s=0.2),
                      fit_params={"seed": 7}, warm_rounds=3, min_rows=512,
                      full_severity=1e9)
    _same_report(want["reports"][0], got["reports"][0], "rollback")
    rep = got["reports"][0]
    assert rep["action"] == "rolled_back"
    assert rep["gate"]["checks"]["mirrored"] is False
    assert got["served"] == want["served"] == 1
    assert got["stages"] == want["stages"] == {1: "Production",
                                               2: "Archived"}
    assert got["stats"]["rollbacks"] == 1
    bb = tmp_path / "blackbox-sml_tpu_torch"
    assert bb.exists() and any(bb.iterdir())


def test_trainer_full_refit_on_severity(pkgs, tmp_path):
    """A severity over fullSeverity refits from scratch (re-sketched,
    re-binned, the trainer's n_trees) in both packages."""
    want, got = _both(pkgs, tmp_path, "ct-full", [(900, 22, True)],
                      fit_params={"seed": 7, "n_trees": 4},
                      warm_rounds=3, min_rows=512, full_severity=1.0)
    _same_report(want["reports"][0], got["reports"][0], "full")
    rep = got["reports"][0]
    assert rep["refit"] == "full" and rep["action"] == "promoted"
    assert got["runs"][0]["params"] == want["runs"][0]["params"]
    assert got["runs"][0]["params"]["ct.n_trees"] in ("4", 4)


def test_trainer_checkpointed_warm_refit_equals_the_plain_one(pkgs,
                                                              tmp_path):
    """With a checkpoint_dir the warm refit goes through
    `checkpointed_warm_start` and registers the same trees."""
    port = pkgs[1]
    specs = []
    for i, ck in enumerate((None, str(tmp_path / "ck"))):
        name = f"ct-ck{i}"
        dpath = str(tmp_path / f"stream{i}")
        _seed_registry(port, name, *_data(2400, seed=11))
        _delta_append(dpath, *_data(900, seed=22, shift=True))
        trainer = port.ct.ContinuousTrainer(
            name, port.ct.DeltaChunkSource(dpath, COLS, "y"),
            gate=port.ct.CanaryGate(quality_tol=10.0),
            checkpoint_dir=ck, device="cpu", **LOOP_KW)
        rep = trainer.step()
        assert rep["action"] == "promoted" and rep["refit"] == "warm"
        from sml_tpu_torch.ml.base import load
        specs.append(load(os.path.join(
            port.store.model_dir(name), "versions", "2", "model",
            "native"))._spec)
    a, b = specs
    assert len(a.trees) == len(b.trees) == 9
    for ta, tb in zip(a.trees, b.trees):
        for fld in ("split_feature", "split_bin", "leaf_value"):
            np.testing.assert_array_equal(getattr(ta, fld),
                                          getattr(tb, fld))


def test_trainer_background_loop_accumulates_and_stops(pkgs, tmp_path):
    """start() runs cycles on its thread and stop() joins it; a source
    under minRefitRows only accumulates."""
    port = pkgs[1]
    _seed_registry(port, "ct-bg", *_data(2400, seed=11))
    dpath = str(tmp_path / "stream")
    _delta_append(dpath, *_data(100, seed=20))
    trainer = port.ct.ContinuousTrainer(
        "ct-bg", port.ct.DeltaChunkSource(dpath, COLS, "y"),
        fit_params={"seed": 7}, min_rows=512, device="cpu")
    trainer.start(poll_s=0.05)
    deadline = time.monotonic() + 10.0
    while trainer.stats()["cycles"] < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    trainer.stop()
    stats = trainer.stats()
    assert stats["cycles"] >= 2
    assert stats["accumulating"] == stats["cycles"]
    assert stats["refits"] == 0 and stats["errors"] == 0
    assert not trainer._thread.is_alive()


def test_trainer_background_loop_keeps_a_failed_cycle(pkgs, tmp_path):
    """A cycle that raises (no version holds Production) is counted and
    kept as `last_error`; the loop goes on until stop()."""
    port = pkgs[1]
    dpath = str(tmp_path / "stream")
    _delta_append(dpath, *_data(600, seed=20))
    trainer = port.ct.ContinuousTrainer(
        "ct-missing", port.ct.DeltaChunkSource(dpath, COLS, "y"),
        min_rows=512, device="cpu")
    e0 = port.prof.counters().get("ct.cycle_error", 0.0)
    trainer.start(poll_s=0.02)
    deadline = time.monotonic() + 10.0
    while trainer.stats()["errors"] < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    trainer.stop()
    assert trainer.stats()["errors"] >= 2
    assert isinstance(trainer.last_error, ValueError)
    assert "holds Production" in str(trainer.last_error)
    assert port.prof.counters().get("ct.cycle_error", 0.0) >= e0 + 2
    with pytest.raises(ValueError, match="holds Production"):
        trainer.step()


def test_gate_without_endpoint_judges_quality_only(pkgs):
    """No endpoint: the verdict rests on the quality bar, in both
    packages alike, on each package's own incumbent and candidate."""
    X, y = _data(900, seed=23, shift=True)
    fit = dict(categorical={}, max_depth=3, max_bins=16, min_instances=1,
               min_info_gain=0.0, feature_k=None, bootstrap=False,
               subsample=1.0, seed=5, loss="squared", step_size=0.3,
               boosting=True)
    verdicts = {}
    for p in pkgs:
        tm = __import__(f"{p.root}.ml._tree_models",
                        fromlist=["_fit_ensemble"])
        inc = tm._fit_ensemble(*_data(1200, seed=3), n_trees=6, **fit,
                               **p.kw)
        cand = tm.warm_start_ensemble(inc, X, y, n_new_trees=3, seed=5,
                                      step_size=0.3, **p.kw)
        gate = p.ct.CanaryGate(quality_tol=1.2)
        verdicts[p.root] = (gate.run(None, X, y, cand, inc),
                            gate.run(None, X, y, inc, cand))
    (jgood, jbad), (good, bad) = verdicts["sml_tpu"], \
        verdicts["sml_tpu_torch"]
    assert good["passed"] is True and "mirrored" not in good
    assert good["checks"] == jgood["checks"] and bad["checks"] == \
        jbad["checks"]
    assert (bad["passed"] is False) == (
        bad["rmse_candidate"] > bad["rmse_incumbent"] * 1.2)
    for a, b in ((good, jgood), (bad, jbad)):
        for k in ("rmse_candidate", "rmse_incumbent"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL)
