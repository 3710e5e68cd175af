#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `portbench/`
and the port (`sml_tpu_torch/`). Everything of a cell is found by name:

- its configuration, `portbench/configs/<config>.json`: the dataset
  (made by `data.py` from the seed), the estimator, and the `kind` of
  model, whose reading of the program's answers is `kinds/<kind>.py`
  and whose plain reference is `reference/<kind>.py`;
- its traffic, `portbench/traffic/<traffic>.json`, which this file's
  one generator reads: the `loop` ("closed": one client, each call
  started when the last returns), the estimator's public `entry` it
  calls on the host matrix, the rounds of the warm-up call, and the
  seconds of the window that a traced run traces;
- its limits, `portbench/checks/<cell>.json`;
- each metric, end-to-end or per-layer, `portbench/metrics/<metric>.py`,
  whose `read(records)` gives the number or None.

The run makes the dataset on the card from the seed, copies it to the
host, warms up with a short call on the same rows (the kernels build,
the bins are cut and cached), then calls the entry in the traffic's loop
for `--seconds`. With `--trace 1` the calls of the first
`trace_seconds` of the window run under `torch.profiler` with the
program's spans on and its kernel wrappers recorded, and the per-layer
metrics are printed instead of the end-to-end ones.

After the window the program's answers are taken, its device state is
freed, and the reference judges every distinct answer (`check.py`). The
last lines on standard error are the numbers compared with their
limits; the last line on standard output is the result.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "sml_tpu")


class BenchError(RuntimeError):
    """The run cannot give a result."""


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among loaded modules (`names`, else
    `sys.modules`), each compared whole: `sml_tpu_torch` is not
    `sml_tpu`."""
    names = list(sys.modules if names is None else names)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell, its configuration, traffic and metrics."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json at {ROOT}")
    bench = _json(path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(m):
        return name in m.get("workloads", [name])
    return {"cell": cell, "config": _json(os.path.join(ROOT, conf["file"])),
            "traffic": _json(os.path.join(HERE, "traffic",
                                          f"{cell['traffic']}.json")),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(records)` of a metric's own file."""
    return _module(os.path.join(HERE, "metrics", f"{metric}.py"),
                   f"portbench_metric_{metric.replace('.', '_')}").read


def kind(cfg: dict):
    """The harness's reading of a configuration's kind of model."""
    return importlib.import_module(f"portbench.kinds.{cfg['kind']}")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def prepare(cell_name: str, scale: dict = None) -> dict:
    """The cell's spec, its configuration shrunk by `scale` for tests
    (the configuration's `test_scale` names one)."""
    spec = load_cell(cell_name)
    if scale:
        spec["config"] = json.loads(json.dumps(spec["config"]))
        kind(spec["config"]).shrink(spec["config"], scale)
    return spec


def make_host_data(cfg: dict, seed: int, dev, scale: dict = None) -> dict:
    """The dataset made on `dev` from the seed, split, on the host:
    float32 X, y, X_test, y_test (`scale` may cut "rows" and
    "train_rows", for tests)."""
    import numpy as np

    from portbench import data
    scale = scale or {}
    X, y = data.make(cfg["data"], seed, dev, rows=scale.get("rows"))
    parts = data.split(cfg["data"], X, y, scale.get("train_rows"))
    return {k: np.ascontiguousarray(v.cpu().numpy()) for k, v in parts.items()}


def judge(cfg: dict, host: dict, dev, settings: dict):
    """The plain reference of this data on `dev`."""
    from portbench import check
    return check.reference(cfg["kind"]).Judge(cfg, host, dev, settings)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device=None, scale: dict = None, log=None) -> dict:
    """One run of a cell; the result's dict. `device` None takes the
    card (and refuses to run without enough of them); tests pass "cpu"
    and a `scale` that shrinks the cell."""
    import torch

    from portbench import check, program, trace as tracing
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec = prepare(cell_name, scale)
    cfg, traffic = spec["config"], spec["traffic"]
    if traffic["loop"] != "closed":
        raise BenchError(f"no generator for a {traffic['loop']!r} loop")
    model_kind = kind(cfg)
    chips = int(spec["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} CUDA device(s); "
                             f"torch sees "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
        call_device = None
    else:
        dev = call_device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lim = check.limits(cell_name)

    # ---- set-up: data from the seed, on the device, then to the host
    host = make_host_data(cfg, seed, dev, scale)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    work = model_kind.work(cfg, host)
    entry = traffic["entry"]
    warm = program.call(program.estimator(cfg, traffic["warmup_rounds"]),
                        entry, host["X"], host["y"], call_device)
    del warm
    est = program.estimator(cfg)
    # the set-up's objects (imports, the warm-up) leave the collector's
    # generations, so a collection in the window scans only the calls' own
    gc.collect()
    gc.freeze()

    # ---- the window: the traffic's closed loop, one client
    calls: dict = {}
    done = []
    failed = 0
    prof = None
    length = min(float(seconds), float(traffic["trace_seconds"])) \
        if trace else float(seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(program.recorded(calls))
            stack.enter_context(record_function(tracing.WINDOW))
        t0 = time.perf_counter()
        setup_s = t0 - PROCESS_START
        while not (done or failed) or time.perf_counter() - t0 < length:
            start = time.perf_counter()
            try:
                model = program.call(est, entry, host["X"], host["y"],
                                     call_device)
            except Exception:  # a failed call is counted and ends the loop
                failed += 1
                log(traceback.format_exc())
                break
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            end = time.perf_counter()
            done.append(dict(work, start=start - t0, end=end - t0,
                             wall_s=end - start, model=model,
                             program_s=program.span_seconds() if trace
                             else 0.0))
    in_window = [c for c in done if c["end"] <= length]
    attempted = len(done) + failed
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise BenchError(f"the run's process holds {found} after the window")
    if not (done if trace else in_window):
        raise BenchError(f"no call completed inside the {length} s window "
                         f"({len(done)} call(s), {failed} failed)")

    # ---- the program's answers, then its state freed
    ref_mod = check.reference(cfg["kind"])
    answers = {}
    for c in done:
        got = model_kind.answer(c.pop("model"), cfg, host, call_device)
        answers.setdefault(ref_mod.digest(got), got)
    traced = tracing.summarize(prof) if trace else None
    del est, prof
    program.free_caches()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference
    ref = judge(cfg, host, dev, lim)
    readings = []
    for got in answers.values():
        readings.append(ref.numbers(got, seed))
        log(f"worst split of a fit: {json.dumps(ref.where)}")
    numbers = check.worst(readings)
    correct, shown = check.verdict(numbers, lim["limits"])
    correct = correct and failed == 0

    # ---- the result
    records = {"setup_s": setup_s, "window_s": length,
               "fits": done if trace else in_window}
    if trace:
        records.update(trace=traced, calls=calls,
                       shape=model_kind.shape(cfg, host))
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = reader(m["name"])(records)
        if v is None and not trace:
            raise BenchError(f"nothing to read for {m['name']}")
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": chips if dev.type == "cuda" else 1,
                   "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
        result["breakdown"] = tracing.breakdown(traced)
    result["check"] = shown
    walls = [round(c["wall_s"], 4) for c in done]
    log(f"card: {card_line() if dev.type == 'cuda' else 'cpu'}")
    log(f"calls: {len(in_window)} in the window of {length} s, walls "
        f"{walls}, distinct answers {len(answers)}")
    for k, v in shown.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
