#!/usr/bin/env python3
"""The readings each limit of `checks/<cell>.json` is set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--faults all]

For each seed, at the cell's own size on the card: the program's fit
judged as a run judges it (the lower readings), with `--control` the
control, and with `--faults` each fault of `faults.py` planted in the
program (the upper readings). One JSON line a seed on standard output.
`--config`, `--also-min-child-of` and `--center-labels` read a program
at fault against a second witness. The benchmark's runs never run this.

The control is the reference put in the program's place one precision
below the configuration's float32: bfloat16 values with float32 sums.
It cuts its own bins from the rows rounded to bfloat16 (its edges
rounded too), starts from the labels' statistic rounded, grows each
judged round's tree in the state of the program's earlier trees (the
margin rounded), and scores the held-out rows through the program's
trees with rows, thresholds, leaves and sums in bfloat16.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import check, faults, program, run  # noqa: E402
from portbench.reference import binning, trees  # noqa: E402

BF16 = torch.bfloat16


def bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).to(torch.float32)


def bf_edges(edges: np.ndarray) -> np.ndarray:
    """Edges rounded to bfloat16, each feature's made unique again."""
    r = bf(torch.from_numpy(edges)).numpy()
    out = np.full_like(r, np.inf)
    for f in range(r.shape[0]):
        u = np.unique(r[f][np.isfinite(r[f])])
        out[f, :len(u)] = u
    return out


def control(cfg: dict, host: dict, ref, answer: dict, seed: int,
            dev) -> dict:
    m = ref.model
    B = int(m["max_bins"])
    Xb = bf(torch.from_numpy(host["X"])).numpy()
    edges = bf_edges(binning.edges(Xb, B))
    y = bf(torch.from_numpy(host["y"]).to(dev))
    frame = trees.Frame(torch.from_numpy(Xb).to(dev), y, edges, B)
    base = float(bf(torch.tensor(trees.base_margin(m, y))))

    def candidate(t, margin, w, masks):
        g, h = trees.gradients(m, frame.y,
                               bf(margin.to(torch.float32)).to(torch.float64))
        return trees.build_tree(frame, m, g, h, w, masks, low=True)
    fit = trees.as_fit(answer)
    got = {"edges_diff": float(trees.edges_diff(edges, ref.edges))}
    if m["boosting"]:
        got["base_gap"] = abs(base - ref.base) / max(abs(ref.base), 1e-3)
    j = trees.judge_fit(ref.frame, m, fit, ref.rounds(seed),
                        candidate=candidate)
    got["split_regret"], got["leaf_gap"] = j["regret"], j["leaf_gap"]
    low = dict(fit, base=base,
               threshold=bf(torch.from_numpy(fit["threshold"]).float())
               .double().numpy())
    out = trees.outputs(bf(ref.X_test), m, low, dtype=BF16)
    exact = trees.outputs(ref.X_test, m, dict(fit, base=ref.base))
    got["heldout_gap"] = float((out.double() - exact).abs().max()) \
        / ref.out_scale
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="",
                   help="comma-separated faults of faults.py, or all")
    p.add_argument("--config", default=None,
                   help="another configuration of configs/ in the cell's")
    p.add_argument("--also-min-child-of", default=None,
                   help="judge the program's fit a second time by this sum")
    p.add_argument("--center-labels", action="store_true",
                   help="fit and judge y less its rounded mean (a witness)")
    p.add_argument("--device", default="cuda",
                   help="cpu, with --scale, rehearses at a small size")
    p.add_argument("--scale", default="{}",
                   help='JSON {"rows", "train_rows", "rounds"}')
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    call_dev = None if dev.type == "cuda" else dev
    scale = json.loads(args.scale)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = run.prepare(args.workload, scale)
    if args.config:
        with open(os.path.join(HERE, "configs", f"{args.config}.json")) as f:
            spec["config"] = json.load(f)
        if scale:
            run.kind(spec["config"]).shrink(spec["config"], scale)
    cfg = spec["config"]
    entry = spec["traffic"]["entry"]
    kind = run.kind(cfg)
    lim = check.limits(args.workload)
    boosting = bool(cfg["model"]["boosting"])
    names = faults.FAULTS if args.faults == "all" else \
        [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        host = run.make_host_data(cfg, seed, dev, scale)
        if args.center_labels:
            host["y"] = host["y"] - np.float32(np.round(host["y"].mean()))
        program.call(program.estimator(cfg, spec["traffic"]["warmup_rounds"]),
                     entry, host["X"], host["y"], call_dev)
        t1 = time.perf_counter()
        model = program.call(program.estimator(cfg), entry, host["X"],
                             host["y"], call_dev)
        fit_s = time.perf_counter() - t1
        answer = kind.answer(model, cfg, host, call_dev)
        ref = run.judge(cfg, host, dev, lim)
        t2 = time.perf_counter()
        line = {"seed": seed, "rounds": ref.rounds(seed),
                "program": ref.numbers(answer, seed),
                "program_worst_split": ref.where}
        judge_s = time.perf_counter() - t2
        if args.also_min_child_of:
            other = json.loads(json.dumps(cfg))
            other["model"]["min_child_of"] = args.also_min_child_of
            witness = run.judge(other, host, dev, lim)
            line["witness"] = witness.numbers(answer, seed)
            line["witness_worst_split"] = witness.where
            del witness
        if args.control:
            line["control"] = control(cfg, host, ref, answer, seed, dev)
        if names:
            line["faults"], line["fault_worst_split"] = {}, {}
            for name in names:
                with faults.planted(name, boosting):
                    bad = program.call(program.estimator(cfg), entry,
                                       host["X"], host["y"], call_dev)
                line["faults"][name] = ref.numbers(
                    kind.answer(bad, cfg, host, call_dev), seed)
                line["fault_worst_split"][name] = ref.where
        line["walls"] = {"setup_s": t1 - t0, "fit_s": fit_s,
                         "judge_s": judge_s,
                         "seed_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del ref, model, host
        program.free_caches()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
