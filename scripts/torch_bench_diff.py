#!/usr/bin/env python
"""torch_bench_diff — the regression gate between two run records.

Compares a candidate record against a base with the noise-aware rules of
`sml_tpu_torch/obs/regress.py`: the port's torch-smoke run record (what
`python3 chip_smoke.py --record PATH` writes) or the JAX package's bench
records (the `bench_legs.json` sidecar, a `BENCH_r0x.json` driver
record). Exit status IS the verdict: 0 = no regressions, 1 = regressed.

Usage:
    python3 scripts/torch_bench_diff.py BASE [CAND] [--json]
                                        [--min-tol FRACTION]
                                        [--trace OUT.json]

With one argument the record is compared against ITSELF (any finding on
a self-compare is a fault of the gate). Walls of two torch-smoke records
are judged only when both name the same card, power limit and host CPU;
otherwise they are listed as not comparable. `--trace` writes the
verdicts as Chrome-trace instant markers; in-process,
`sml_tpu_torch.obs.annotate_regressions()` lands the same verdicts in
the flight recorder.

Loaded standalone: this script imports `regress.py` by file path, so it
imports none of torch, jax, sml_tpu or sml_tpu_torch and runs in
milliseconds on any Python 3.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _load_regress():
    path = os.path.join(REPO, "sml_tpu_torch", "obs", "regress.py")
    spec = importlib.util.spec_from_file_location("_torch_regress", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="noise-aware run-record comparison (exit 1 on "
                    "regression)")
    parser.add_argument("base", help="base record (a torch-smoke record, "
                                     "a sidecar or a BENCH_r0x driver "
                                     "record)")
    parser.add_argument("cand", nargs="?", default=None,
                        help="candidate record (default: the base itself "
                             "— the null self-compare)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full result as JSON instead of the "
                             "table")
    parser.add_argument("--min-tol", type=float, default=None,
                        help="wall-clock tolerance floor as a fraction "
                             "(default 0.05); recorded pass spread widens "
                             "it, capped so >=20%% always flags")
    parser.add_argument("--trace", default=None,
                        help="write verdicts as Chrome-trace instant "
                             "markers to this path")
    args = parser.parse_args(argv)

    regress = _load_regress()
    cand = args.cand or args.base
    min_tol = args.min_tol if args.min_tol is not None else regress.MIN_TOL
    result = regress.diff_paths(args.base, cand, min_tol)

    if args.trace:
        with open(args.trace, "w") as f:
            json.dump({"traceEvents": regress.trace_events(result),
                       "otherData": {"producer": "scripts/torch_bench_diff.py",
                                     "base": args.base, "cand": cand}}, f)
    if args.json:
        print(json.dumps(result, indent=1))
    else:
        print(regress.render(result, args.base, cand))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
