"""The program's spans on the device trace, on the CPU: a span's mirrored
range names the idle gap that its host work leaves, and
`fit.untraced_idle_pct.train` reads the idle time that no range names."""

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import run, trace

SEED = 2 ** 31 + 977
CELL = "higgs-xgb-mcw0.fit"


def test_untraced_idle_reads_the_gaps_no_range_names():
    read = run.reader("fit.untraced_idle_pct.train")
    t = {"window_s": 2.0, "busy_s": 1.0, "kernels": {}, "launches": 0,
         "idle_by_host": {trace.OUTSIDE_OPS: 0.25,
                          "staging.content_key": 0.75}}
    assert read({"trace": t}) == pytest.approx(12.5)
    named = dict(t, idle_by_host={"staging.content_key": 1.0})
    assert read({"trace": named}) == 0.0
    assert read({"trace": dict(t, busy_s=0.0)}) is None


def test_a_spans_range_names_the_gap_its_host_work_leaves():
    from sml_tpu_torch.ml._staging import _content_key
    a = np.arange(6_000_000, dtype=np.float32)     # over the full-hash size
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            _content_key(a)
    s = trace.summarize(prof)
    # the CPU has no device activity: the window is one gap, whose
    # middle lies inside the key's numpy work
    assert s["busy_s"] == 0.0
    assert set(s["idle_by_host"]) == {"staging.content_key"}
    assert s["idle_by_host"]["staging.content_key"] == pytest.approx(
        s["window_s"])


def test_a_traced_cpu_run_leaves_out_the_untraced_idle():
    res = run.run(CELL, SEED, 3.0, True, device="cpu",
                  scale=run.load_cell(CELL)["config"]["test_scale"],
                  log=lambda *a: None)
    assert res["correct"] is True
    names = {m["name"] for m in run.load_cell(CELL)["per_layer"]}
    assert "fit.untraced_idle_pct.train" in names
    # no device timeline on the CPU: nothing to read
    assert "fit.untraced_idle_pct.train" not in res["metrics"]
    assert {"fit.outside_program_pct.train", "fit.mfu_pct.train"} \
        <= set(res["metrics"])
