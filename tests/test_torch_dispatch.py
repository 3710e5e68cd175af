"""The port's dispatcher and prewarm against the JAX package's, on the CPU.

`decide` keeps every hinted program of a grid (every `_HOST_RATES` kind
x flops 1e3-1e12 x in and out bytes) on a card, and its audit row carries
the JAX package's cost model: both sides given the same injected
calibration constants and observed host rates (the JAX side told its
backend is not the CPU, the port side handed a CUDA device it never
touches), `t_host` and `t_device` within 1e-12 relative, and the audit's
"host would have won" exactly where the JAX package's priced `decide`
takes the host. `OBSERVED_HOST`'s window, floors and ageing under an
injected clock (and its rates equal to the JAX package's),
`QueuePressure` parent chaining, `preroute`'s four reasons and their
audit rows. Prewarm: the manifest's round trip with bucketed rows, an
entry of another card skipped, a replay on the CPU making each recorded
call on zero operands of the recorded shapes, two processes' entries
merged in one file, and a failed background replay kept in `status()`.
"""

import json

import numpy as np
import pytest
import torch

from sml_tpu.parallel import dispatch as jd
from sml_tpu_torch import obs as pobs
from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.parallel import dispatch as pd
from sml_tpu_torch.parallel import prewarm as pw

CUDA = torch.device("cuda", 0)  # a device object only: nothing touches it
#: injected calibration: a slow link (rt 5 ms), where the JAX package
#: prices host against device
CONSTS = (5e-3, 2.0e9, 1.5e9)


@pytest.fixture()
def calibrated(monkeypatch):
    """Both dispatchers priced with CONSTS; the JAX one told its
    backend is an accelerator's. Restored after."""
    monkeypatch.setattr(jd, "_default_backend", lambda: "tpu")
    jcal = jd.CALIBRATION
    saved = (jcal._done, jcal.rt_fixed, jcal.h2d_bw, jcal.d2h_bw)
    jcal._done = True
    jcal.rt_fixed, jcal.h2d_bw, jcal.d2h_bw = CONSTS
    pd.CALIBRATION.set_constants(*CONSTS)
    jd.OBSERVED_HOST._recent.clear()
    pd.OBSERVED_HOST.reset()
    try:
        yield
    finally:
        jcal._done, jcal.rt_fixed, jcal.h2d_bw, jcal.d2h_bw = saved
        pd.CALIBRATION.reset()
        jd.OBSERVED_HOST._recent.clear()
        pd.OBSERVED_HOST.reset()


FLOPS = np.logspace(3, 12, 19)
IN_BYTES = (None, 1e3, 1e6, 1e9)
OUT_BYTES = (8.0, 4e5)


@pytest.mark.parametrize("observed", [False, True])
@pytest.mark.parametrize("kind", sorted(pd._HOST_RATES))
def test_decide_equals_the_jax_package_over_a_grid(calibrated, kind,
                                                   observed):
    assert sorted(pd._HOST_RATES) == sorted(jd._HOST_RATES)
    if observed:  # the same measured host runs fed to both routers
        for flops, secs in ((2e9, 0.8), (5e8, 0.3), (1e8, 2e-3)):
            jd.OBSERVED_HOST.observe(kind, flops, secs)
            pd.OBSERVED_HOST.observe(kind, flops, secs)
        assert pd.OBSERVED_HOST.rate(kind) == jd.OBSERVED_HOST.rate(kind)
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    jax_routes = set()
    try:
        for flops in FLOPS:
            for inb in IN_BYTES:
                for outb in OUT_BYTES:
                    hj = jd.WorkHint(float(flops), kind, outb, inb)
                    hp = pd.WorkHint(float(flops), kind, outb, inb)
                    # a card keeps the program, however slow its link
                    assert pd.decide(hp, device=CUDA) == "device"
                    rec = pobs.audit_records()[-1]
                    assert (rec.route, rec.reason, rec.calibrated) == \
                        ("device", "local-chip", True)
                    th_j = jd.host_time(hj)
                    td_j = jd.device_time(hj, jd.CALIBRATION)
                    assert abs(rec.t_host - th_j) <= 1e-12 * abs(th_j)
                    assert abs(rec.t_device - td_j) <= 1e-12 * abs(td_j)
                    # the audit's "the host would have won" is the JAX
                    # package's priced route
                    route, _ = jd.decide(hj)
                    assert (rec.t_host < rec.t_device) == (route == "host")
                    jax_routes.add(route)
    finally:
        PCONF.unset("sml.obs.enabled")
        pobs.reset()
        pobs.WATCHDOG.shutdown()
    # the grid crosses the JAX package's break-even
    assert jax_routes == {"device", "host"}


def test_observed_rates_window_floors_and_ageing():
    clock = [1000.0]
    rates = pd._ObservedRates(clock=lambda: clock[0])
    jrates = jd._ObservedRates()
    assert rates.rate("blas") is None
    for k in range(10):  # the window keeps the newest 8
        for r in (rates, jrates):
            r.observe("blas", 1e9 * (k + 1), 0.5)
        clock[0] += 1.0
    want = sum(1e9 * (k + 1) for k in range(2, 10)) / (8 * 0.5)
    assert rates.rate("blas") == jrates.rate("blas") == want
    # sub-ms timings and small calls are noise: ignored
    rates.observe("blas", 1e12, 5e-4)
    rates.observe("blas", 5e7, 1.0)
    assert rates.rate("blas") == want
    # the oldest observations age out past _MAX_AGE_S, then all of them
    clock[0] = 1000.0 + 2 + pd._ObservedRates._MAX_AGE_S + 0.5
    assert rates.rate("blas") == sum(
        1e9 * (k + 1) for k in range(3, 10)) / (7 * 0.5)
    clock[0] += 100.0
    assert rates.rate("blas") is None
    # an empty window falls back to the bootstrap rate
    assert pd.host_time(pd.WorkHint(6e9, "blas")) == 1.0


def test_queue_pressure_chains_to_its_parent():
    parent = pd.QueuePressure()
    a, b = pd.QueuePressure(parent=parent), pd.QueuePressure(parent=parent)
    a.add(10)
    b.add(5)
    assert (a.rows(), b.rows(), parent.rows()) == (10, 5, 15)
    a.sub(4)
    b.sub(5)
    assert (a.rows(), b.rows(), parent.rows()) == (6, 0, 6)
    # never below zero, each queue on its own (the JAX package's too)
    b.sub(50)
    jparent = jd.QueuePressure()
    jchild = jd.QueuePressure(parent=jparent)
    jchild.add(6)
    jchild.sub(50)
    assert (b.rows(), parent.rows()) == (jchild.rows(), jparent.rows()) \
        == (0, 0)


def _reason_case(mode, hint, device, rt):
    pd.CALIBRATION.set_constants(rt, 1e9, 1e9)
    if mode is None:
        PCONF.unset("sml.dispatch.mode")
    else:
        PCONF.set("sml.dispatch.mode", mode)
    try:
        return pd.preroute(hint, device), pd.preroute_reason(hint, device)
    finally:
        PCONF.unset("sml.dispatch.mode")
        pd.CALIBRATION.reset()


@pytest.mark.parametrize("mode, hinted, device, rt, want", [
    (None, True, "cpu", 5e-3, ("device", "no-tunnel")),
    ("host", True, "cpu", 5e-3, ("device", "no-tunnel")),
    ("host", True, "cuda", 5e-3, ("host", "forced-mode")),
    ("host", False, "cuda", 5e-3, ("host", "forced-mode")),
    ("device", True, "cuda", 5e-3, ("device", "forced-mode")),
    (None, False, "cuda", 5e-3, ("device", "no-hint")),
    (None, True, "cuda", 3e-5, ("device", "local-chip")),
    # a slow round trip does not price a card: the port serves none
    # behind a slow link
    (None, True, "cuda", 5e-3, ("device", "local-chip")),
])
def test_preroute_reasons(mode, hinted, device, rt, want):
    hint = pd.WorkHint(1e6) if hinted else None
    dev = CUDA if device == "cuda" else torch.device("cpu")
    assert _reason_case(mode, hint, dev, rt) == want


def test_preroute_is_audited_with_its_reason():
    PCONF.set("sml.obs.enabled", True)
    pobs.reset()
    try:
        pd.CALIBRATION.set_constants(3e-5, 1e9, 1e9)
        assert pd.decide(pd.WorkHint(1e6, "traverse"), device=CUDA) == \
            "device"
        PCONF.set("sml.dispatch.mode", "host")
        assert pd.decide(pd.WorkHint(1e6), device=CUDA) == "host"
        assert pd.decide(None, device=CUDA) == "host"  # unaudited: no hint
        assert pd.decide(pd.WorkHint(1e6), device="cpu") == "device"
        recs = pobs.audit_records()
        assert [(r.route, r.reason, r.forced) for r in recs] == [
            ("device", "local-chip", True), ("host", "forced-mode", True),
            ("device", "no-tunnel", True)]
        assert pobs.RECORDER.counters()["dispatch.route_device"] == 2.0
        assert "3 decisions" in pobs.audit_report()
    finally:
        PCONF.unset("sml.dispatch.mode")
        PCONF.unset("sml.obs.enabled")
        pd.CALIBRATION.reset()
        pobs.reset()
        pobs.WATCHDOG.shutdown()


def test_calibration_without_a_card_keeps_the_defaults():
    cal = pd._Calibration()
    if torch.cuda.is_available():
        pytest.skip("a card is present: this case is the CPU's")
    assert cal.ensure(torch.device("cpu")) is cal
    c = cal.constants()
    assert c["rt_fixed_s"] == 0.0 and c["calibrated"]
    assert c["h2d_bytes_per_s"] == float("inf")


# ------------------------------------------------------------- prewarm
@pytest.fixture()
def manifest(tmp_path):
    PCONF.set("sml.compile.cacheDir", str(tmp_path))
    pw.reset()
    try:
        yield tmp_path / "prewarm_manifest.json"
    finally:
        pw.reset()
        PCONF.unset("sml.compile.cacheDir")
        PCONF.unset("sml.prewarm.enabled")


def _record_cpu_calls(rows=50, requests=37):
    """Record one launch signature of each kernel and a staging, as the
    wrappers record them on the card, but for the CPU."""
    from sml_tpu_torch.native.traverse_kernel import traverse_plan
    cpu = torch.device("cpu")
    binned = torch.zeros((requests, 10), dtype=torch.uint8)
    tables = [torch.zeros((4, 15), dtype=torch.int32),
              torch.zeros((4, 15), dtype=torch.int32),
              torch.zeros((4, 15), dtype=torch.float32),
              torch.zeros(4, dtype=torch.float32)]
    pw.record_launch(cpu, "forest_traverse",
                     traverse_plan(requests, 10, 1, 4, 15, 3),
                     [binned] + tables,
                     {"depth": 3, "init": torch.zeros(requests)})
    pw.record_launch(cpu, "hist_accumulate", None,
                     [torch.zeros((rows, 3), dtype=torch.uint8),
                      torch.zeros(rows, dtype=torch.int32)]
                     + [torch.zeros(rows)] * 3,
                     {"n_bins": 8, "n_slots": 2})
    pw.record_launch(cpu, "split_scan", None,
                     [torch.zeros((3, 8, 2, 3)), torch.ones((2, 3)),
                      torch.ones(2)], {"reg_lambda": 1.0, "gamma": 0.0})
    pw.record_stage(cpu, (requests, 10), np.uint8)
    pw.flush()


def test_manifest_round_trip_and_replay_on_the_cpu(manifest, monkeypatch):
    from sml_tpu_torch.native import hist_kernel, traverse_kernel
    _record_cpu_calls()
    _record_cpu_calls()  # a signature seen before adds nothing
    _record_cpu_calls(rows=61, requests=33)  # the same row buckets
    doc = json.loads(manifest.read_text())
    assert doc["version"] == 2 and len(doc["entries"]) == 4
    kinds = sorted((e["kind"], e["kernel"] or "") for e in
                   doc["entries"].values())
    assert kinds == [("launch", "forest_traverse"),
                     ("launch", "hist_accumulate"),
                     ("launch", "split_scan"), ("stage", "")]
    ft = next(e for e in doc["entries"].values()
              if e["kernel"] == "forest_traverse")
    assert ft["device"] == ["cpu", 1]
    # 37 rows replay as 64 (the next power of two), the init too
    assert ft["meta"]["operands"][0] == [[64, 10], "uint8"]
    assert ft["meta"]["scalars"]["init"] == {"tensor": [[64], "float32"]}
    assert ft["meta"]["plan"]["path"] == "shared"
    # a fresh process's view: the file alone
    pw.reset()
    assert pw.entries() == doc["entries"]
    calls = []
    for mod, name in ((traverse_kernel, "forest_margin_plain"),
                      (hist_kernel, "hist_accumulate_plain"),
                      (hist_kernel, "split_scan_plain")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            tensors = [t for t in a if isinstance(t, torch.Tensor)]
            # the operands are zeros (split_scan's mask and least child
            # weight too: the recorded ones were ones)
            assert not any(t.any() for t in tensors)
            calls.append((_name, [tuple(t.shape) for t in tensors]))
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    stats = pw.prewarm(device="cpu", workers=2)
    assert stats["programs"] == 4 and stats["replayed"] == 4
    assert stats["failed"] == 0 and stats["skipped"] == 0
    got = sorted(calls)
    assert got == [
        ("forest_margin_plain", [(64, 10), (4, 15), (4, 15), (4, 15), (4,),
                                 (64,)]),
        ("hist_accumulate_plain", [(64, 3), (64,), (64,), (64,), (64,)]),
        ("split_scan_plain", [(3, 8, 2, 3), (2, 3), (2,)])]
    # a replay records nothing of its own
    assert len(json.loads(manifest.read_text())["entries"]) == 4


@pytest.mark.parametrize("n, want", [(0, 0), (1, 1), (2, 2), (3, 4),
                                     (64, 64), (65, 128), (65536, 65536),
                                     (65537, 65536), (4_194_304, 65536)])
def test_replay_rows_are_powers_of_two_up_to_the_cap(n, want):
    assert pw.replay_rows(n) == want


def test_a_server_s_batch_sizes_make_few_entries(manifest):
    """Every batch size from 1 to 4,096 rows, and a 4.2M-row fit chunk,
    record 13 traversal entries and one capped histogram entry."""
    for rows in range(1, 4097):
        pw.record_launch(torch.device("cpu"), "forest_traverse", None,
                         [torch.zeros((rows, 10), dtype=torch.uint8)],
                         {"depth": 3})
    pw.record_launch(torch.device("cpu"), "hist_accumulate", None,
                     [torch.zeros((4_194_304, 1), dtype=torch.uint8)],
                     {"n_bins": 8, "n_slots": 2})
    pw.flush()
    rows = sorted(e["meta"]["operands"][0][0][0]
                  for e in pw.entries().values())
    assert rows == [2 ** k for k in range(13)] + [pw.REPLAY_ROWS]


def test_processes_sharing_a_manifest_merge_their_entries(manifest):
    _record_cpu_calls()
    first = json.loads(manifest.read_text())["entries"]
    pw.reset()  # another process: nothing in memory, the same file
    # it records other row counts (split_scan's entry has no rows: the
    # first already wrote it); its view of the file predates the first's
    # write
    pw._state.update(path=str(manifest), entries={}, dirty=False)
    _record_cpu_calls(rows=200, requests=300)
    _record_cpu_calls()
    merged = json.loads(manifest.read_text())["entries"]
    assert set(first) < set(merged) and len(merged) == 7
    assert {k: merged[k] for k in first} == first


def test_entries_of_another_card_are_skipped(manifest):
    _record_cpu_calls()
    doc = json.loads(manifest.read_text())
    for e in doc["entries"].values():
        e["device"] = ["NVIDIA H100 80GB HBM3", 8]
    manifest.write_text(json.dumps(doc))
    pw.reset()
    stats = pw.prewarm(device="cpu")
    assert stats["programs"] == 0 and stats["skipped"] == 4
    assert stats["replayed"] == 0


def test_maybe_prewarm_is_opt_in_and_runs_once(manifest):
    from sml_tpu_torch.utils.profiler import PROFILER
    _record_cpu_calls()
    assert pw.maybe_prewarm(device="cpu") is None  # off by default
    assert pw.status()["state"] == "idle"
    PCONF.set("sml.prewarm.enabled", True)
    skip0 = PROFILER.counters().get("prewarm.replica_skip", 0.0)
    t = pw.maybe_prewarm(device="cpu")
    t.join(30)
    assert not t.is_alive()
    got = pw.status()
    assert got["state"] == "done" and got["stats"]["replayed"] == 4
    assert pw.maybe_prewarm(device="cpu", block=True) is None
    assert PROFILER.counters()["prewarm.replica_skip"] == skip0 + 1


def _break_split_scan(manifest):
    doc = json.loads(manifest.read_text())
    bad = next(e for e in doc["entries"].values()
               if e["kernel"] == "split_scan")
    bad["meta"]["operands"][1] = [[5, 3], "float32"]  # wrong node count
    manifest.write_text(json.dumps(doc))
    pw.reset()


def test_a_failed_replay_is_counted_and_raised(manifest):
    _record_cpu_calls()
    _break_split_scan(manifest)
    with pytest.raises(ValueError):
        pw.prewarm(device="cpu")


def test_a_failed_background_replay_is_kept_in_the_status(manifest):
    """A background replay cannot raise into its caller: its error stays
    in `status()`, and an endpoint's health report carries it."""
    from sml_tpu_torch.utils.profiler import PROFILER
    _record_cpu_calls()
    _break_split_scan(manifest)
    PCONF.set("sml.prewarm.enabled", True)
    failed0 = PROFILER.counters().get("prewarm.background_failed", 0.0)
    t = pw.maybe_prewarm(device="cpu")
    t.join(30)
    assert not t.is_alive()
    got = pw.status()
    assert got["state"] == "failed" and got["stats"] is None
    assert got["error"].startswith("ValueError")
    assert PROFILER.counters()["prewarm.background_failed"] == failed0 + 1
