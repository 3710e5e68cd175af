"""The host stages of a benchmark cell's fits, from the program's spans.

A stop-gap, to be deleted once `portbench/run.py`'s fit records carry
their own span table: it wraps `portbench.program.span_seconds`, which
`run.py` calls after each traced fit, and so depends on `run.py` reading
that function through the module at that moment.

    python3 scripts/torch_fit_stages.py --workload <cell> --seed <n>
        [--seconds S] [--device cpu]

Makes one traced run of the cell, as `portbench/run.py --trace 1` does,
and keeps each traced fit's spans by name (calls, wall and self seconds
from `PROFILER`, read just before the harness resets it after the fit).
Prints one JSON line: the run's result (per-layer metrics, the device
trace's breakdown, the device), each fit's span table, and each fit's
host stages (`STAGES`) as self seconds and as a share of its
`estimator.fit` wall, beside the outside-program share the harness
reads. The breakdown's idle gaps name the program's spans where the
port mirrors them into the device trace. Beside each fit's table, the
histogram wrapper's calls and row passes (`hist_kernel.LAUNCHES`,
`ROW_PASSES`) since the table before it: the first counts the warm-up
fit too. `--device cpu` runs the cell at its configuration's
`test_scale`; by default it takes the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import program, run  # noqa: E402

#: the spans of a matrix fit outside `program.tree_ensemble`
STAGES = ("estimator.fit", "estimator.select_rows", "binning.fit",
          "staging.content_key", "staging.fit", "estimator.assemble")


def span_table() -> dict:
    """The program's spans kept so far, by name: [calls, wall_s,
    self_s]."""
    from sml_tpu_torch.utils.profiler import PROFILER
    out: dict = {}
    for s in PROFILER.spans():
        row = out.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += s.wall_s
        row[2] += s.self_s
    return out


def stages(table: dict) -> dict:
    """A fit's host stages: self seconds by stage, their sum, and the
    sum over the `estimator.fit` wall, in percent."""
    selfs = {k: table[k][2] for k in STAGES if k in table}
    wall = table.get("estimator.fit", [0, 0.0, 0.0])[1]
    total = sum(selfs.values())
    return {"self_s": selfs, "sum_s": total, "fit_wall_s": wall,
            "sum_pct": 100.0 * total / wall if wall > 0 else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    from sml_tpu_torch.native import hist_kernel as hk
    tables, counters = [], []
    reset = program.span_seconds
    seen = {"calls": hk.LAUNCHES["hist_accumulate"],
            "row_passes": hk.ROW_PASSES["hist_accumulate"]}

    def kept_then_reset() -> float:
        tables.append(span_table())
        now = {"calls": hk.LAUNCHES["hist_accumulate"],
               "row_passes": hk.ROW_PASSES["hist_accumulate"]}
        counters.append({k: now[k] - seen[k] for k in now})
        seen.update(now)
        return reset()
    program.span_seconds = kept_then_reset
    scale = run.load_cell(args.workload)["config"]["test_scale"] \
        if args.device == "cpu" else None
    result = run.run(args.workload, args.seed, args.seconds, True,
                     device=args.device, scale=scale)
    print(json.dumps({"result": result, "spans": tables,
                      "stages": [stages(t) for t in tables],
                      "hist_accumulate": counters}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
