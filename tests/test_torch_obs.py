"""The port's obs core against the JAX package's, on the CPU.

`LogHistogram` (8 buckets an octave, the rolling window): buckets,
quantiles, counts, sums, extremes, exemplars, `merge_snapshots` and
`worst` EQUAL to the JAX package's on the same seeded values (only the
rates, which read the clock, are left out). The recorder: event kind,
name, duration and args, the ring bound and its drop count, and the
JSONL sink's lines (header and records) equal, ignoring timestamps,
thread lanes, the header's epoch and pid. Trace contexts: the fan-in's
`parent_traces` / `parent_ids` structure, `activate`, `trace_args`, and
the disabled path's None everywhere. The watchdog: a ticket past a 50 ms
`stallMillis` is flagged with all-thread stacks well inside 2 s, resolves
when closed, and the poll thread is joined. The dispatch audit's
`report()` equal to the JAX package's for the same records and measured
walls. `slo_report` and `engine_metrics` read the recorder's own state.
"""

import json
import threading
import time

import numpy as np
import pytest

from sml_tpu.conf import GLOBAL_CONF as JCONF
from sml_tpu.obs import _audit as jaudit
from sml_tpu.obs import _context as jctx
from sml_tpu.obs import _metrics as jmet
from sml_tpu.obs import _recorder as jrec
from sml_tpu_torch import obs as pobs
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.obs import _audit as paudit
from sml_tpu_torch.obs import _context as pctx
from sml_tpu_torch.obs import _metrics as pmet
from sml_tpu_torch.obs import _recorder as prec
from sml_tpu_torch.obs import _watchdog as pwd


@pytest.fixture()
def recorders():
    """Both packages' recorders on, emptied, and off again after."""
    for conf in (JCONF, PCONF):
        conf.set("sml.obs.enabled", True)
    jrec.RECORDER.reset()
    pobs.reset()
    try:
        yield jrec.RECORDER, prec.RECORDER
    finally:
        for conf in (JCONF, PCONF):
            conf.unset("sml.obs.enabled")
        jrec.RECORDER.reconfigure()
        prec.RECORDER.reconfigure()
        jrec.RECORDER.reset()
        pobs.reset()
        pobs.WATCHDOG.shutdown()
        jaudit.reset()
        jmet.METRICS.reset()


def _values(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(0.0, 2.0, n)
    if kind == "latency_ms":
        return np.concatenate([rng.gamma(2.0, 1.5, n - n // 20),
                               rng.uniform(20, 400, n // 20)])
    if kind == "with_zeros":
        v = rng.exponential(3.0, n)
        v[::7] = 0.0
        return v
    return rng.integers(1, 1 << 20, n).astype(np.float64)  # byte sizes


SNAP_KEYS = ("count", "mean", "p50", "p90", "p99", "max", "min", "buckets",
             "exemplars", "max_exemplar")


@pytest.mark.parametrize("kind", ["lognormal", "latency_ms", "with_zeros",
                                  "bytes"])
def test_log_histogram_equals_the_jax_package(kind):
    vals = _values(kind, 3000, seed=len(kind))
    ex = np.arange(len(vals)) * 7 + 1
    hj, hp = jmet.LogHistogram(window_s=60.0), pmet.LogHistogram(
        window_s=60.0)
    for v, e in zip(vals, ex):
        e = int(e) if e % 3 else None
        hj.observe(float(v), e)
        hp.observe(float(v), e)
    sj, sp = hj.snapshot(), hp.snapshot()
    for k in SNAP_KEYS:
        assert sj.get(k) == sp.get(k), k
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert hj.quantile(q) == hp.quantile(q)
        assert hj.quantile(q, 60.0) == hp.quantile(q, 60.0)
    assert hj.worst() == hp.worst()
    for thr in (0.5, 2.0, 10.0, 100.0):
        assert hj.count_above(thr) == hp.count_above(thr)
    assert hj.total_count(60.0) == hp.total_count(60.0) == len(vals)
    # each quantile within one bucket width of the exact sample
    exact = np.sort(vals)[int(np.ceil(0.5 * len(vals))) - 1]
    if exact > pmet.VALUE_FLOOR:
        assert exact / pmet.BUCKET_GROWTH <= hp.quantile(0.5) \
            <= exact * pmet.BUCKET_GROWTH


@pytest.mark.parametrize("split", [1, 500, 2999])
def test_merge_snapshots_and_merge_equal_the_jax_package(split):
    vals = _values("latency_ms", 3000, seed=11)
    parts = []
    for mod in (jmet, pmet):
        a, b = mod.LogHistogram(window_s=60.0), mod.LogHistogram(
            window_s=60.0)
        for i, v in enumerate(vals):
            (a if i < split else b).observe(float(v), i + 1)
        merged = mod.merge_snapshots(a.snapshot(), b.snapshot())
        a.merge(b)
        parts.append((merged, a.snapshot(), a.worst()))
    (mj, aj, wj), (mp, ap, wp) = parts
    assert mj == mp
    for k in SNAP_KEYS:
        assert aj.get(k) == ap.get(k), k
    assert wj == wp


def test_registry_is_a_no_op_with_the_recorder_off():
    assert not prec.RECORDER.enabled
    reg = pmet.MetricsRegistry()
    reg.observe("x_ms", 1.0)
    assert reg.names() == [] and reg.worst("x_ms") == (0.0, None)
    assert pctx.new_trace() is None and pctx.mint_request(3) is None
    assert pctx.fan_in([]) is None and pctx.current() is None
    assert pwd.Watchdog().open("k", "n") is None


def _strip(rec: dict) -> dict:
    rec = dict(rec)
    rec.pop("ts", None)
    rec.pop("tid", None)
    if rec.get("name") == "obs.header":
        rec["args"] = {k: v for k, v in rec["args"].items()
                       if k not in ("epoch_unix", "pid")}
    return rec


def _drive(rec, sink=None):
    if sink is not None:
        rec._sink_path = sink
    rec.counter("serve.requests")
    rec.counter("staging.h2d_bytes", 4096.0)
    rec.counter("serve.requests", 2.0)
    rec.gauge("serve.queue_rows", 17.0)
    rec.span("serve.batch", time.perf_counter(), 0.25, rows=64,
             requests=3, parent_traces=[1, 2, 3], empty=None)
    rec.emit("dispatch", "dispatch.device",
             args={"kind": "traverse", "flops": 1e6, "route": "device"})
    rec.emit("serve", "serve.swap", args={"from": 1, "to": 2})
    for i in range(40):
        rec.emit("infer", "infer.dispatch", args={"batch": i})


def test_recorder_events_ring_and_sink_equal_the_jax_package(tmp_path):
    for conf in (JCONF, PCONF):
        conf.set("sml.obs.ringEvents", 20)
        conf.set("sml.obs.enabled", True)
    try:
        out = []
        for mod, tag in ((jrec, "jax"), (prec, "port")):
            rec = mod.Recorder()
            assert rec.enabled
            sink = str(tmp_path / f"{tag}.jsonl")
            _drive(rec, sink)
            events = [_strip(mod.event_record(e)) for e in rec.events()]
            with open(sink) as f:
                lines = [_strip(json.loads(ln)) for ln in f]
            out.append((events, lines, rec.counters(), rec.dropped,
                        len(rec.events())))
        assert out[0] == out[1]
        assert out[1][4] == 20 and out[1][3] == 27
        assert out[1][1][0]["name"] == "obs.header"
        assert len(out[1][1]) == 1 + 47
    finally:
        for conf in (JCONF, PCONF):
            conf.unset("sml.obs.ringEvents")
            conf.unset("sml.obs.enabled")
        jrec.RECORDER.reconfigure()
        prec.RECORDER.reconfigure()


def test_sink_rotates_once_past_its_bound(tmp_path):
    PCONF.set("sml.obs.sinkMaxBytes", 600)
    PCONF.set("sml.obs.enabled", True)
    try:
        rec = prec.Recorder()
        path = str(tmp_path / "events.jsonl")
        rec._sink_path = path
        for i in range(30):
            rec.emit("infer", "infer.drain", args={"batch": i})
        with open(path) as f:
            live = [json.loads(ln) for ln in f]
        with open(path + ".1") as f:
            rolled = [json.loads(ln) for ln in f]
        assert live[0]["name"] == rolled[0]["name"] == "obs.header"
        assert [r["args"]["batch"] for r in rolled[1:] + live[1:]] \
            == list(range(30))[-(len(rolled) + len(live) - 2):]
    finally:
        PCONF.unset("sml.obs.sinkMaxBytes")
        PCONF.unset("sml.obs.enabled")
        prec.RECORDER.reconfigure()


def test_conf_hooks_keep_the_recorder_current():
    assert not prec.RECORDER.enabled
    PCONF.set("sml.obs.enabled", "true")
    try:
        assert prec.RECORDER.enabled and pobs.enabled()
    finally:
        PCONF.unset("sml.obs.enabled")
    assert not prec.RECORDER.enabled


def test_trace_context_fan_in_structure(recorders):
    jr, pr = recorders
    shapes = []
    for mod, rec in ((jctx, jr), (pctx, pr)):
        reqs = [mod.mint_request(rows=r) for r in (1, 5, 64)]
        batch = mod.fan_in(reqs)
        with mod.activate(batch):
            inner = mod.current()
            tagged = mod.trace_args({"route": "device"})
        assert mod.current() is None
        child = batch.child()
        shapes.append({
            "distinct": len({r.trace_id for r in reqs} | {batch.trace_id}),
            "parents": mod.parent_traces(reqs) == [r.trace_id for r in reqs],
            "spans": mod.parent_ids(reqs) == [r.span_id for r in reqs],
            "roots": [r.parent_id for r in reqs + [batch]],
            "active": inner is batch,
            "tagged": sorted(tagged) == ["route", "span", "trace"]
            and tagged["trace"] == batch.trace_id,
            "child": (child.trace_id == batch.trace_id
                      and child.parent_id == batch.span_id),
            "hex": len(mod.hex_id(batch.trace_id)),
            "admissions": [(e.name, e.args.get("rows"), e.dur)
                           for e in rec.events()],
        })
    assert shapes[0] == shapes[1]
    assert shapes[1]["distinct"] == 4 and shapes[1]["roots"] == [None] * 4


def test_watchdog_flags_a_stall_and_resolves_it(recorders):
    _, rec = recorders
    PCONF.set("sml.obs.stallMillis", 50)
    dog = pwd.Watchdog()
    hooked = []
    dog.on_stall(hooked.append)
    try:
        t0 = time.perf_counter()
        ticket = dog.open("serve.flush", "serve.batch", trace=123)
        assert ticket is not None
        while not dog.report()["stalled"] and time.perf_counter() - t0 < 2:
            time.sleep(0.01)
        waited = time.perf_counter() - t0
        rep = dog.report()
        assert rep["open"] == 1 and rep["stalled"] == 1 \
            and rep["flagged_total"] == 1, rep
        assert 0.05 <= waited < 2.0
        dog.close(ticket)
        assert dog.report()["open"] == 0
        poller = dog._thread
    finally:
        dog.shutdown()
        PCONF.unset("sml.obs.stallMillis")
    assert dog._thread is None and not poller.is_alive()
    names = [e.name for e in rec.events()]
    assert names.count("stall.detected") == 1
    assert names.count("stall.resolved") == 1
    detected = next(e for e in rec.events() if e.name == "stall.detected")
    assert detected.args["trace"] == 123
    assert detected.args["threshold_s"] == 0.05
    assert threading.current_thread().name in detected.args["stacks"]
    assert len(hooked) == 1 and hooked[0]["name"] == "serve.batch"


def test_watchdog_expected_wall_sets_the_threshold():
    PCONF.set("sml.obs.enabled", True)
    try:
        dog = pwd.Watchdog()
        t1 = dog.open("dispatch", "a", expected_s=2.0)
        t2 = dog.open("dispatch", "b", expected_s=1e-4)
        got = {t["name"]: t["threshold_s"] for t in dog.inflight()}
        dog.close(t1)
        dog.close(t2)
        dog.shutdown()
    finally:
        PCONF.unset("sml.obs.enabled")
    # stallFactor 8 x the prediction, floored at stallMillis (5 s)
    assert got == {"a": 16.0, "b": 5.0}


class _Hint:
    def __init__(self, flops, kind, out_bytes=256.0, in_bytes=None):
        self.flops, self.kind = flops, kind
        self.out_bytes, self.in_bytes = out_bytes, in_bytes


def test_audit_report_equals_the_jax_package(recorders):
    jaudit.reset()
    paudit.reset()
    rows = [(_Hint(1e9, "traverse"), "device", 4.0, 0.5, False, "model"),
            (_Hint(1e5, "blas", in_bytes=1e6), "host", 1e-5, 3e-3, False,
             "model"),
            (_Hint(1e7, "blas"), "device", 0.01, 2e-3, True, "local-chip"),
            (_Hint(2e8, "traverse"), "host", 0.8, 0.3, True, "forced-mode")]
    walls = {"device": [0.45, 0.03], "host": [2e-5, 5.0]}
    texts, flags = [], []
    for mod in (jaudit, paudit):
        for hint, route, th, td, forced, reason in rows:
            mod.record(hint, route, th, td, forced, reason)
        w = {k: list(v) for k, v in walls.items()}
        for hint, route, *_ in rows:
            if mod.expected_wall(route) is not None:
                mod.attach(route, "program.score", w[route].pop(0))
        texts.append(mod.report())
        flags.append([(r.measured, r.drift, r.misroute)
                      for r in mod.records()])
    assert texts[0] == texts[1] and flags[0] == flags[1]
    # attach fills the newest unmeasured decision of its route first
    assert [f[0] for f in flags[1]] == [0.03, 5.0, 0.45, 2e-5]
    assert [f[2] for f in flags[1]] == [False, True, True, False]
    assert "2 misroutes" in texts[1]
    assert pmet.METRICS.histogram("dispatch.device_ms").count == 2


def test_slo_report_and_engine_metrics(recorders):
    _, rec = recorders
    PCONF.set("sml.serve.sloMillis", 10)
    try:
        for v in [1.0] * 97 + [50.0, 60.0, 70.0]:
            pmet.METRICS.observe("serve.request_ms", v, exemplar=int(v))
        rep = pobs.slo_report()
        assert rep["requests"] == 100.0 and rep["breaches"] == 3.0
        assert rep["burn_rate"] == 3.0
        assert rep["worst_ms"] == 70.0 and rep["worst_trace"] == \
            pctx.hex_id(70)
        rec.counter("dispatch.route_device", 3.0)
        rec.counter("staging.bin_cache_hit", 3.0)
        rec.counter("staging.bin_cache_miss", 1.0)
        m = pobs.engine_metrics()
        assert m["engine.route_device"] == 3.0
        assert m["engine.bin_cache_hit_rate"] == 0.75
    finally:
        PCONF.unset("sml.serve.sloMillis")
