"""The port's engine-health layer (`sml_tpu_torch.obs`: `_skew`,
`_trace` / `_tracefmt`, `engine_health`, `annotate_regressions`)
against the JAX package's, on the CPU; the cases of
tests/test_engine_health.py but its `bench_diff` ones, whose port
counterparts (over `obs/regress.py` and `scripts/torch_bench_diff.py`)
are in tests/test_torch_regress.py.

- An injected 8-device skewed profile: the report names the slow device,
  the skew ratio is the injected imbalance, and it equals the JAX
  package's report on the same profile; rebuilt from the exported
  trace's lanes it names the same device; the trace has one lane per
  device, and its events equal the JAX package's but for the host
  process's name ("sml_tpu_torch host").
- `engine_health()` after a serving load carries every block of the
  JAX package's, populated; `ServingEndpoint.health_report()` carries
  them all beside the endpoint's.
- Regression verdicts (the JAX package's `regress.compare` on its
  committed bench record, an injected 1.5x leg) land as
  `regress.verdict` instant markers in a trace the port exports.
"""

import json
import os
import time

import numpy as np
import pytest

from sml_tpu_torch import obs as pobs
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.obs._trace import PID_SKEW, to_trace_events

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

INJECTED = [0.010] * 7 + [0.030]  # device 7 is 3x the others


@pytest.fixture()
def recorders():
    """Both packages' recorders on and reset; restored after."""
    from sml_tpu import obs as jobs
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    prev = {c: c.get("sml.obs.enabled") for c in (PCONF, JCONF)}
    for c in prev:
        c.set("sml.obs.enabled", True)
    pobs.reset()
    jobs.reset()
    yield jobs
    for c, v in prev.items():
        c.set("sml.obs.enabled", bool(v))
    pobs.reset()
    jobs.reset()


def _without_host_name(trace):
    return [e for e in trace if not (e.get("ph") == "M"
                                     and e.get("name") == "process_name"
                                     and e.get("pid") == 1)]


def test_straggler_report_names_slow_device_and_matches_imbalance(
        recorders):
    jobs = recorders
    attr = pobs.SKEW.note("fit_8dev", INJECTED, wall_s=0.040,
                          psum_bytes=123456.0, psum_launches=8)
    assert attr["slowest_device"] == 7
    expected_ratio = max(INJECTED) / (sum(INJECTED) / len(INJECTED))
    assert attr["skew_ratio"] == pytest.approx(expected_ratio, rel=1e-6)
    assert attr["wait_s"] == pytest.approx(7 * 0.020)
    assert attr["collective_overhead_s"] == pytest.approx(0.010)
    rep = pobs.straggler_report()
    assert rep["slowest_device"] == 7 and rep["n_devices"] == 8
    assert rep["psum_bytes"] == 123456.0 and rep["psum_launches"] == 8
    jobs.SKEW.note("fit_8dev", INJECTED, wall_s=0.040,
                   psum_bytes=123456.0, psum_launches=8)
    assert rep == jobs.straggler_report()


@pytest.mark.parametrize("devices", [None, [12, 7, 30, 1, 2, 3, 4, 5]])
def test_straggler_report_stable_across_trace_roundtrip(recorders,
                                                        devices):
    jobs = recorders
    slow = 7 if devices is None else devices[7]
    for tracker in (pobs.SKEW, jobs.SKEW):
        tracker.note("fit_8dev", INJECTED, devices=devices)
        tracker.note("fit_8dev_round2", [c * 2 for c in INJECTED],
                     devices=devices)
    live = pobs.straggler_report()
    assert live["slowest_device"] == slow
    trace = to_trace_events(pobs.RECORDER.events())
    rebuilt = pobs.skew_report_from_trace(trace)
    assert rebuilt["slowest_device"] == slow
    assert rebuilt["n_devices"] == live["n_devices"]
    assert rebuilt["skew_ratio"] == pytest.approx(live["skew_ratio"],
                                                  rel=1e-3)
    assert rebuilt["wait_share"] == pytest.approx(live["wait_share"],
                                                  abs=1e-3)
    from sml_tpu.obs._trace import to_trace_events as jto_trace
    jtrace = jto_trace(jobs.RECORDER.events())
    assert pobs.skew_report_from_trace(jtrace)["slowest_device"] == slow


def test_trace_renders_one_lane_per_device(recorders):
    jobs = recorders
    pobs.SKEW.note("fit_8dev", INJECTED)
    trace = to_trace_events(pobs.RECORDER.events())
    lanes = {e["tid"] for e in trace
             if e.get("ph") == "X" and e["pid"] == PID_SKEW}
    assert lanes == set(range(8))
    names = {e["args"]["name"] for e in trace
             if e.get("ph") == "M" and e["pid"] == PID_SKEW
             and e["name"] == "thread_name"}
    assert "device-7" in names
    for tid in lanes - {7}:
        lane = sorted((e for e in trace if e.get("ph") == "X"
                       and e["pid"] == PID_SKEW and e["tid"] == tid),
                      key=lambda e: e["ts"])
        assert [e["name"] for e in lane] == ["skew.compute", "skew.wait"]
        assert lane[1]["ts"] == pytest.approx(
            lane[0]["ts"] + lane[0]["dur"], abs=1.0)
    host = [e for e in trace if e.get("name") == "process_name"
            and e["pid"] == 1]
    assert host[0]["args"]["name"] == "sml_tpu_torch host"
    # the same records convert to the JAX package's events, the host
    # process's name aside
    from sml_tpu.obs._tracefmt import to_trace_dicts as jconvert
    from sml_tpu_torch.obs._trace import _as_records
    recs = _as_records(pobs.RECORDER.events())
    assert _without_host_name(to_trace_events(pobs.RECORDER.events())) \
        == _without_host_name(jconvert(recs))


def test_skew_note_noop_when_disabled():
    assert not PCONF.getBool("sml.obs.enabled")
    pobs.SKEW.reset()
    assert pobs.SKEW.note("x", [1.0, 2.0]) is None
    assert pobs.SKEW.programs() == []
    assert pobs.straggler_report() is None


# ------------------------------------------------------------ engine health
BLOCKS = {"metrics", "audit", "hbm", "engine", "slo", "skew", "ingest",
          "inflight", "drift", "infer_kernel", "shed", "fleet", "load"}


def _drive_serving_load(batcher_cls, n_requests=64):
    def score(X):
        time.sleep(0.0002)
        return np.asarray(X).sum(axis=1)

    with batcher_cls(score, max_batch_rows=32, flush_micros=200,
                     timeout_millis=0) as mb:
        futs = [mb.submit(np.ones((2, 4), np.float32))
                for _ in range(n_requests)]
        for f in futs:
            f.result(timeout=10)
    return n_requests


def test_engine_health_populated_after_serving_load(recorders):
    from sml_tpu.serving import MicroBatcher as JBatcher
    from sml_tpu_torch.serving import MicroBatcher
    jobs = recorders
    n = _drive_serving_load(MicroBatcher)
    _drive_serving_load(JBatcher)
    health = pobs.engine_health()
    assert set(health) == BLOCKS == set(jobs.engine_health())
    m = health["metrics"]["serve.request_ms"]
    assert m["count"] == n
    assert m["p50"] > 0 and m["p99"] >= m["p50"]
    assert health["slo"]["requests"] == n
    assert health["slo"]["target_ms"] == 250.0
    assert health["slo"]["burn_rate"] == 0.0
    assert "dispatch audit" in health["audit"]["report"]
    assert "_total" in health["hbm"]
    assert set(health["engine"]) == set(jobs.engine_metrics())
    assert set(health["shed"]) == {"total", "by_reason"}
    assert health["fleet"] is None and health["load"] is None
    assert any(e.name == "health.snapshot" and e.kind == "health"
               for e in pobs.RECORDER.events())


def test_infer_kernel_block_reports_the_traversal_plan(recorders):
    from sml_tpu_torch.ml import inference
    rep = pobs.engine_health()["infer_kernel"]
    assert rep["kernel"] == "forest_traverse"
    plan = {"rows": 64, "block_rows": 64}
    before = rep["plan_launches"]
    inference._note_plan(plan)
    rep = pobs.engine_health()["infer_kernel"]
    assert rep["plan"] == plan and rep["plan_launches"] == before + 1
    assert any(e.name == "infer.kernel.spec"
               for e in pobs.RECORDER.events())


def test_slo_burn_rate_counts_breaches(recorders):
    PCONF.set("sml.serve.sloMillis", 1)
    try:
        for _ in range(100):
            pobs.METRICS.observe("serve.request_ms", 50.0)
        slo = pobs.slo_report()
    finally:
        PCONF.unset("sml.serve.sloMillis")
    assert slo["requests"] == 100 and slo["breaches"] == 100
    assert slo["burn_rate"] == pytest.approx(100.0)


def test_health_report_carries_every_block(recorders, tmp_path):
    from sml_tpu_torch import tracking as pt
    from sml_tpu_torch.ml._tree_models import _fit_ensemble
    from sml_tpu_torch.serving import ServingEndpoint
    pt.set_tracking_uri(str(tmp_path / "runs"))
    pt._active_experiment["id"] = None
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 4))
    y = (X[:, 0] - X[:, 1]).astype(np.float32)
    spec = _fit_ensemble(X, y, categorical={}, max_depth=3, max_bins=16,
                         min_instances=1, min_info_gain=0.0, n_trees=2,
                         feature_k=None, bootstrap=False, subsample=1.0,
                         seed=1, loss="squared", device="cpu")
    from sml_tpu_torch.ml.regression import RandomForestRegressionModel
    model = RandomForestRegressionModel(spec)
    with pt.start_run():
        pt.spark.log_model(model, "model", registered_model_name="health")
    pt.MlflowClient().transition_model_version_stage("health", 1,
                                                     "Production")
    try:
        with ServingEndpoint("health", "Production", flush_micros=200,
                             device="cpu") as ep:
            for lo in range(0, 512, 64):
                ep.score(X[lo:lo + 64], timeout=30)
            rep = ep.health_report(window_s=60.0)
    finally:
        while pt.active_run():
            pt.end_run()
        pt._active_experiment["id"] = None
    assert set(rep) == BLOCKS | {"endpoint"}
    assert rep["metrics"]["serve.request_ms"]["count"] == 8
    assert "serve.health/Production" in rep["drift"]
    assert rep["drift"]["serve.health/Production"]["rows"] == 512
    assert rep["endpoint"]["version"] == 1


def test_regress_verdicts_annotate_the_trace(recorders, tmp_path):
    """Verdicts land as `regress.verdict` events and render as instant
    markers in the trace the port exports; the document carries the
    recorder's wall-clock anchor."""
    import copy

    from sml_tpu.obs import regress
    base = regress.load(os.path.join(REPO, "bench_legs.json"))
    cand = copy.deepcopy(base)
    cand["legs"]["ml02_lr"]["seconds"] *= 1.5
    cand["legs"]["ml02_lr"]["passes"] = [
        x * 1.5 for x in cand["legs"]["ml02_lr"]["passes"]]
    res = regress.compare(base, cand)
    assert not res["ok"]
    n = pobs.annotate_regressions(res["regressions"])
    assert n == len(res["regressions"]) >= 1
    path = pobs.export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    marks = [e for e in doc["traceEvents"] if e.get("ph") == "i"
             and e["name"] == "regress.verdict"]
    assert len(marks) == n
    assert marks[0]["args"]["key"] == "ml02_lr"
    assert doc["otherData"]["producer"] == "sml_tpu_torch.obs"
    assert abs(doc["otherData"]["epoch_unix"]
               - pobs.RECORDER.epoch_unix()) < 1e-3


def test_annotate_regressions_is_a_noop_when_disabled():
    assert not pobs.RECORDER.enabled
    assert pobs.annotate_regressions([{"key": "x"}]) == 0
