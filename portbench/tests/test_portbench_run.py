"""Whole runs on the CPU at a small size: the result's line, the
reference's verdict on the port, the control and every fault planted in
the port coming out not correct, and the modules the process loads."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import calibrate, check, faults, program, run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
SEED = 2 ** 31 + 977


def _scale(cell):
    return run.load_cell(cell)["config"]["test_scale"]


def _run(cell, trace=False):
    return run.run(cell, SEED, 3.0, trace, device="cpu", scale=_scale(cell),
                   log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_the_port_is_correct_and_its_line_has_the_contract_keys(cell):
    res = _run(cell)
    spec = run.load_cell(cell)
    assert res["correct"] is True, res["check"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["check"]) == set(check.limits(cell)["limits"])
    for v in res["check"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(res))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics(cell):
    res = _run(cell, trace=True)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device timeline: only the host-side readings remain
    assert "fit.outside_program_pct.train" in res["metrics"]
    assert "device_idle_pct.train" not in res["metrics"]
    names = {m["name"] for m in run.load_cell(cell)["per_layer"]}
    assert set(res["metrics"]) <= names


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_planted_in_the_port_is_not_correct(cell, fault):
    boosting = run.load_cell(cell)["config"]["model"]["boosting"]
    with faults.planted(fault, boosting):
        res = _run(cell)
    assert res["correct"] is False, res["check"]


def _fit_and_judge(cell, config=None, center=False, min_child_of=None):
    """(the reference's numbers, the Judge, its inputs) of one fit of the
    port at the cell's test size, on `config` in place of the cell's."""
    scale = _scale(cell)
    spec = run.prepare(cell, scale)
    cfg = spec["config"]
    if config is not None:
        with open(os.path.join(run.ROOT, "portbench", "configs",
                               f"{config}.json")) as f:
            cfg = json.load(f)
        run.kind(cfg).shrink(cfg, cfg["test_scale"])
        scale = cfg["test_scale"]
    if min_child_of:
        cfg["model"]["min_child_of"] = min_child_of
    dev = torch.device("cpu")
    host = run.make_host_data(cfg, SEED, dev, scale)
    if center:
        host["y"] = host["y"] - np.float32(np.round(host["y"].mean()))
    model = program.call(program.estimator(cfg), "fit", host["X"],
                         host["y"], dev)
    answer = run.kind(cfg).answer(model, cfg, host, dev)
    ref = run.judge(cfg, host, dev, check.limits(cell))
    return ref.numbers(answer, SEED), ref, cfg, host, answer


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    _, ref, cfg, host, answer = _fit_and_judge(cell)
    got = calibrate.control(cfg, host, ref, answer, SEED,
                            torch.device("cpu"))
    correct, shown = check.verdict(got, check.limits(cell)["limits"])
    assert not correct, shown


def test_xgboost_min_child_weight_is_a_hessian_sum():
    """The port holds XGBoost's min_child_weight to a child's row weight:
    at 1 it splits off children whose Hessian sum is under 1, which the
    reference refuses; judged by row weight the same fit is sound."""
    from portbench.reference import trees
    got, ref, _, _, _ = _fit_and_judge(CELLS[0], config="higgs-xgb")
    assert got["split_regret"] == trees.INADMISSIBLE
    assert ref.where["lighter_child"] < 1.0
    witness, _, _, _, _ = _fit_and_judge(CELLS[0], config="higgs-xgb",
                                         min_child_of="weight")
    assert witness["split_regret"] < 1e-9


def test_the_forests_float32_scores_pick_wrong_splits():
    """The port scores a forest's splits in float32 on the raw labels
    (years near 2000): the level regret is far above rounding; with the
    labels centered the same program picks the reference's splits."""
    raw, _, _, _, _ = _fit_and_judge(CELLS[0], config="year-rf")
    assert raw["split_regret"] > 1e-2
    centered, _, _, _, _ = _fit_and_judge(CELLS[0], config="year-rf",
                                          center=True)
    assert centered["split_regret"] < 1e-9


def test_judged_rounds_start_at_zero_and_follow_the_seed():
    from portbench.reference.trees import judged_rounds
    a = judged_rounds(100, 6, 5)
    assert a[0] == 0 and len(set(a)) == 6 and a == sorted(a)
    assert a == judged_rounds(100, 6, 5)
    assert judged_rounds(20, 20, 5) == list(range(20))


_PROBE = """
import sys, json
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(body):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(
        root=run.ROOT, body=body)], capture_output=True, text=True,
        timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax_and_no_jax_package():
    body = ("from portbench import run\n"
            f"run.run({CELLS[0]!r}, 3, 5.0, False, device='cpu', "
            f"scale={_scale(CELLS[0])!r}, log=lambda *a: None)\n"
            "assert not run.forbidden_modules()")
    got = _modules(body)
    assert not got & {"jax", "jaxlib", "flax", "sml_tpu"}
    assert "sml_tpu_torch" in got


def test_the_reference_loads_nothing_of_the_port():
    refs = sorted(f[:-3] for f in os.listdir(os.path.join(
        run.ROOT, "portbench", "reference")) if f.endswith(".py"))
    got = _modules("import portbench.check, portbench.roofline, "
                   "portbench.data, portbench.trace\n"
                   + "".join(f"import portbench.reference.{r}\n"
                             for r in refs))
    assert not got & {"jax", "jaxlib", "flax", "sml_tpu", "sml_tpu_torch"}


def test_the_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["sml_tpu_torch", "sml_tpu_torch.ml",
                                  "jaxtyping", "flaxen.x", "numpy"]) == []
    assert run.forbidden_modules(["sml_tpu.ml", "jax.numpy", "jaxlib",
                                  "flax", "torch"]) == \
        ["flax", "jax", "jaxlib", "sml_tpu"]


def test_a_run_without_a_card_gives_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc = run.main(["--workload", CELLS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    import shutil
    root = tmp_path / "bare"
    shutil.copytree(os.path.join(run.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_the_calibration_rehearses_on_the_cpu(cell, capsys):
    assert calibrate.main(["--workload", cell, "--seeds", str(SEED),
                           "--control", "--faults", "all", "--device", "cpu",
                           "--scale", json.dumps(_scale(cell))]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lim = check.limits(cell)["limits"]
    assert check.verdict(line["program"], lim)[0]
    assert not check.verdict(line["control"], lim)[0]
    assert set(line["faults"]) == set(faults.FAULTS)
    for name, got in line["faults"].items():
        assert not check.verdict(got, lim)[0], name
