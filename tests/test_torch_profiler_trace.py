"""The port's spans on the device trace's clock, on the CPU.

While a `torch.profiler` session collects, every `PROFILER.span` is also
a `record_function` range of its name around the same block, with the
`sml.profiler.enabled` key on or off; with no session the spans are
kept and timed as before. A matrix fit's host stages each have a span:
`estimator.fit` around the whole, `estimator.select_rows`,
`binning.fit` and `staging.fit` (each keying its arrays in
`staging.content_key`), `program.tree_ensemble` and
`estimator.assemble`. `chip_smoke.py`'s busy share counts the device's
own rows and not the device copies of those ranges.
"""

import importlib.util
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sml_tpu_torch.conf import GLOBAL_CONF
from sml_tpu_torch.utils import profiler as profmod
from sml_tpu_torch.utils.profiler import PROFILER

torch.set_num_threads(2)

FIT_STAGES = ("estimator.fit", "estimator.select_rows", "binning.fit",
              "staging.content_key", "staging.fit", "program.tree_ensemble",
              "estimator.assemble")


@pytest.fixture()
def spans_on():
    """`sml.profiler.enabled` on and the kept spans empty; the key
    restored and the spans dropped after."""
    was = GLOBAL_CONF.getBool("sml.profiler.enabled")
    GLOBAL_CONF.set("sml.profiler.enabled", True)
    PROFILER.reset()
    yield
    GLOBAL_CONF.set("sml.profiler.enabled", was)
    PROFILER.reset()


def _ranges(prof, names):
    """(name, start ns, end ns) of the session's host events named in
    `names`, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()) or e.name() not in names:
            continue
        start = int(e.start_ns())
        out.append((e.name(), start, start + int(e.duration_ns())))
    return sorted(out, key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("enabled", [True, False])
def test_a_span_is_a_host_range_of_its_name_under_a_session(enabled):
    was = GLOBAL_CONF.getBool("sml.profiler.enabled")
    GLOBAL_CONF.set("sml.profiler.enabled", enabled)
    PROFILER.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with PROFILER.span("program.outer_probe"):
                torch.ones(16).sum()
                with PROFILER.span("program.inner_probe", rows=4):
                    torch.ones(16).cumsum(0)
        kept = [s.name for s in PROFILER.spans()]
    finally:
        GLOBAL_CONF.set("sml.profiler.enabled", was)
        PROFILER.reset()
    got = _ranges(prof, {"program.outer_probe", "program.inner_probe"})
    assert [r[0] for r in got] == ["program.outer_probe",
                                   "program.inner_probe"]
    assert _inside(got[1], got[0])
    assert got[0][2] > got[0][1]
    # the kept list follows the key alone
    assert kept == (["program.inner_probe", "program.outer_probe"]
                    if enabled else [])


def test_with_no_session_no_range_opens_and_spans_keep_as_before(
        spans_on, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with no session")
    monkeypatch.setattr(profmod._torch_profiler, "record_function", refuse)
    assert not profmod._torch_profiler._is_profiler_enabled
    with PROFILER.span("program.outer_probe"):
        time.sleep(0.02)
        with PROFILER.span("program.inner_probe", rows=7, route="host"):
            time.sleep(0.03)
    inner, outer = PROFILER.spans()
    assert (inner.name, outer.name) == ("program.inner_probe",
                                        "program.outer_probe")
    assert inner.rows == 7 and inner.meta == {"route": "host"}
    assert inner.self_s == inner.wall_s >= 0.03
    assert outer.wall_s >= inner.wall_s + 0.02
    assert outer.self_s == pytest.approx(outer.wall_s - inner.wall_s,
                                         abs=1e-9)
    report = PROFILER.report()
    assert "program.inner_probe" in report and "program.outer_probe" in report


def test_start_device_trace_holds_the_spans_names(tmp_path):
    from sml_tpu_torch.utils import start_device_trace
    with start_device_trace(str(tmp_path)):
        with PROFILER.span("program.trace_probe"):
            with PROFILER.span("staging.fit"):
                torch.ones(64).cumsum(0)
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1, os.listdir(tmp_path)
    with open(tmp_path / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"program.trace_probe", "staging.fit"} <= names


def test_a_matrix_fit_nests_its_host_stages(spans_on):
    from sml_tpu_torch.ml._staging import _FULL_HASH_MAX_BYTES
    from sml_tpu_torch.xgboost import XgboostClassifier
    rng = np.random.default_rng(27)
    n, F = 300_000, 16
    X = rng.normal(size=(n, F)).astype(np.float32)
    assert X.nbytes > _FULL_HASH_MAX_BYTES  # X takes the sampled key
    y = (X[:, 0] + 0.5 * X[:, 3] > 0).astype(np.float64)
    y[::1000] = np.nan  # rows the select drops
    est = XgboostClassifier(n_estimators=2, max_depth=2, max_bins=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        est.fit(X, y, device="cpu")
        wall = time.perf_counter() - t0

    got = _ranges(prof, set(FIT_STAGES))
    by = {}
    for r in got:
        by.setdefault(r[0], []).append(r)
    assert set(by) == set(FIT_STAGES)
    (fit,) = by["estimator.fit"]
    assert all(_inside(r, fit) for r in got)
    (select,), (binning,), (staging,), (program,) = (
        by[k] for k in ("estimator.select_rows", "binning.fit",
                        "staging.fit", "program.tree_ensemble"))
    assert select[2] <= binning[1] <= binning[2] <= staging[1] \
        <= staging[2] <= program[1]
    keys = by["staging.content_key"]
    # X and y keyed inside the binning, the bins inside the staging
    assert sum(_inside(k, binning) for k in keys) == 2
    assert sum(_inside(k, staging) for k in keys) == 1
    assembles = by["estimator.assemble"]
    assert len(assembles) == 2
    assert all(a[1] >= program[2] for a in assembles)

    kept = PROFILER.spans()
    sizes = sorted(s.meta["bytes"] for s in kept
                   if s.name == "staging.content_key")
    assert sizes == sorted([(n - n // 1000) * F * 4, (n - n // 1000) * 4,
                            (n - n // 1000) * F])
    assert {s.name for s in kept} == set(FIT_STAGES)
    (fit_span,) = [s for s in kept if s.name == "estimator.fit"]
    assert fit_span.wall_s <= wall
    assert sum(s.self_s for s in kept) <= fit_span.wall_s + 1e-6
    assert all(s.self_s >= 0 for s in kept)


def test_chip_smoke_busy_leaves_out_the_spans_device_copies():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from torch.autograd import DeviceType

    def row(key, us, device=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(key=key, device_type=device,
                               self_device_time_total=us,
                               is_user_annotation=annotation)
    rows = [row("hist_cluster_kernel", 5000.0),
            row("split_scan_kernel", 20.0),
            row("hist_cluster_kernel", 1000.0),
            # a span's range: on the host, and its copy on the device
            row("program.tree_ensemble", 0.0, device=DeviceType.CPU),
            row("program.tree_ensemble", 9000.0, annotation=True),
            row("staging.content_key", 800.0, annotation=True),
            row("Activity Buffer Request", 50.0),
            row("aten::add", 30.0, device=DeviceType.CPU)]
    assert chip_smoke.device_busy(rows) == {"hist_cluster_kernel": 6.0,
                                            "split_scan_kernel": 0.02}
