"""The data generator, the roofline arithmetic, the metric readers, the
trace's reduction and the reference's draws and bins, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import data, roofline, run, trace
from portbench.reference import binning, threefry


CONFIG_DIR = os.path.join(run.ROOT, "portbench", "configs")
CONFIGS = sorted(f[:-5] for f in os.listdir(CONFIG_DIR) if f.endswith(".json"))


def _config(name):
    with open(os.path.join(CONFIG_DIR, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_dataset_repeats_bit_for_bit_and_moves_with_the_seed(name):
    cfg = _config(name)
    big = 2 ** 31 + 12345
    X1, y1 = data.make(cfg["data"], big, "cpu", rows=2000)
    X2, y2 = data.make(cfg["data"], big, "cpu", rows=2000)
    X3, _ = data.make(cfg["data"], big + 1, "cpu", rows=2000)
    assert torch.equal(X1, X2) and torch.equal(y1, y2)
    assert not torch.equal(X1, X3)
    assert X1.dtype == torch.float32 and torch.isfinite(X1).all()
    assert X1.shape == (2000, len(data.column_dists(cfg["data"])))


@pytest.mark.parametrize("name", CONFIGS)
def test_label_shares_and_ranges(name):
    spec = _config(name)["data"]
    _, y = data.make(spec, 7, "cpu", rows=20000)
    label = spec["label"]
    if label["kind"] == "binary_share":
        assert abs(float(y.mean()) - label["share"]) < 1e-3
        assert set(torch.unique(y).tolist()) == {0.0, 1.0}
    else:
        assert float(y.min()) >= label["lo"] and float(y.max()) <= label["hi"]
        assert torch.equal(y, torch.round(y))
        assert 1995 <= float(y.median()) <= 2008


def test_roofline_at_known_shapes():
    # 10,500,000 rows x 28 uint8 bins, 256 bins, 16 slots: bytes-bound
    n, F, B, S = 10_500_000, 28, 256, 16
    nbytes = n * (F + 16) + F * B * S * 12
    assert roofline.hist_s(n, F, B, S, 1) == pytest.approx(nbytes / 3.35e12)
    assert roofline.F64_OPS_PER_S == pytest.approx(64 * 132 * 1.98e9)
    # split_scan of (28, 256, 32): operation-bound at the f32 rate
    assert roofline.scan_s(28, 256, 32) == pytest.approx(
        max((12 * 28 * 256 * 32 + 4 * 32 * 28 + 4 * 32 + 24 * 32) / 3.35e12,
            16 * 28 * 256 * 32 / 67e12))
    # Poisson(1) draws of 20 rounds x 463,715 rows: integer-bound
    rows = 20 * 463_715
    assert roofline.row_weights_s(20, 1, 463_715, "poisson", 1.0) == \
        pytest.approx(2 * rows * 82 / roofline.INT32_OPS_PER_S)
    # a whole HIGGS fit: 100 trees of 6 levels, bytes-bound levels
    per_level = [n * (F + 12) + F * B * 2 ** L * 12 for L in range(6)]
    want = 100 * (sum(b / 3.35e12 for b in per_level) + 12 * n / 3.35e12)
    assert roofline.fit_s(n, F, B, 6, 100, True, False) == pytest.approx(want)


def _records():
    return {"setup_s": 12.5, "window_s": 3.0,
            "fits": [{"start": 0.5, "end": 2.5, "wall_s": 2.0,
                      "program_s": 1.5, "rows": 100, "trees": 4,
                      "depth": 5}],
            "trace": {"window_s": 2.0, "busy_s": 0.5, "launches": 600,
                      "kernels": {"hist_cluster_kernel": [0.02, 20],
                                  "hist_reduce_kernel": [0.005, 20],
                                  "split_scan_kernel": [0.001, 20]},
                      "idle_by_host": {}},
            "calls": {"hist_accumulate": [(1000, 10, 40, 1, 1)] * 20,
                      "split_scan": [(10, 40, 2)] * 20, "row_weights": []},
            "shape": {"n": 1000, "F": 10, "B": 40, "D": 5, "T": 4,
                      "boosting": False, "mode": "poisson", "rate": 1.0}}


def test_metric_readers_on_known_records():
    rec = _records()
    get = {m: run.reader(m)(rec) for m in (
        "fit.outside_program_pct.train", "fit.launches_per_level.train",
        "hist_accumulate.roofline_pct.train",
        "split_scan.roofline_pct.train", "row_weights.roofline_pct.train",
        "fit.mfu_pct.train", "device_idle_pct.train")}
    assert get["fit.outside_program_pct.train"] == pytest.approx(25.0)
    assert get["fit.launches_per_level.train"] == pytest.approx(30.0)
    assert get["hist_accumulate.roofline_pct.train"] == pytest.approx(
        100 * 20 * roofline.hist_s(1000, 10, 40, 1, 1) / 0.025)
    assert get["split_scan.roofline_pct.train"] == pytest.approx(
        100 * 20 * roofline.scan_s(10, 40, 2) / 0.001)
    assert get["row_weights.roofline_pct.train"] is None   # nothing to read
    assert get["fit.mfu_pct.train"] == pytest.approx(
        100 * roofline.fit_s(1000, 10, 40, 5, 4, False, True) / 2.0)
    assert get["device_idle_pct.train"] == pytest.approx(75.0)
    assert run.reader("train_row_trees_per_s")(rec) == pytest.approx(
        100 * 4 / 2.5)
    assert run.reader("setup_s")(rec) == 12.5
    assert run.reader("train_row_trees_per_s")(dict(rec, fits=[])) is None


class _Event:
    def __init__(self, name, cuda, start, dur):
        self._v = (name, cuda, start, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda self: events})()})()


def test_trace_union_launches_and_idle_attribution():
    events = [_Event(trace.WINDOW, False, 0, 1000),
              _Event("aten::where", False, 100, 300),
              _Event("cudaLaunchKernel", False, 150, 10),
              _Event("cudaLaunchKernelExC", False, 500, 10),
              _Event("void k1<int>(int)", True, 200, 300),
              _Event("void k2(float)", True, 400, 200),   # overlaps k1
              _Event("Memcpy HtoD", True, 900, 50),
              _Event("late", True, 1500, 10)]             # outside
    s = trace.summarize(_Prof(events))
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(450e-9)
    assert s["launches"] == 2
    assert s["kernels"]["k1"] == [pytest.approx(300e-9), 1]
    # gaps: [0, 200) mid 100 -> aten::where; [600, 900) and [950, 1000)
    assert s["idle_by_host"]["aten::where"] == pytest.approx(200e-9)
    assert s["idle_by_host"][trace.OUTSIDE_OPS] == pytest.approx(350e-9)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "k1"
    assert len(b["idle_gaps"]) == 2


def test_threefry_draws_equal_the_ports():
    from sml_tpu_torch.native import prng_kernel as pk
    from sml_tpu_torch.ml import tree_impl as ti
    keys = ti.fit_keys(np.asarray([[0, 42]], np.uint32), 3, 4)
    for t in range(3):
        want = pk.row_weights_plain(
            torch.from_numpy(keys[t, 0]), torch.tensor([1], dtype=torch.int32),
            torch.tensor([1.0]), torch.tensor([5000], dtype=torch.int32), 5000)
        got = threefry.row_weights(42, t, "poisson", 1.0, 5000, "cpu")
        assert torch.equal(got, want)
        for level in range(4):
            mask = pk.feature_mask_plain(
                torch.from_numpy(keys[t, 1 + level]),
                torch.tensor([30], dtype=torch.int32), 2 ** level, 90)
            assert torch.equal(threefry.feature_mask(
                42, t, level, 2 ** level, 90, 30, "cpu"), mask > 0)


def test_reference_edges_and_bins_equal_the_ports():
    from sml_tpu_torch.ml.tree_impl import make_bins
    cfg = _config("year-rf")
    X, y = data.make(cfg["data"], 5, "cpu", rows=3000)
    Xh, yh = X.numpy(), y.numpy()
    binned, b = make_bins(Xh, yh, 40)
    e = binning.edges(Xh, 40)
    assert np.array_equal(e, b.edges)
    assert np.array_equal(binning.bins(X, e).numpy(), binned.astype(np.int64))
