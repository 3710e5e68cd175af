"""Times the row-weights kernel at each rows-a-thread build, on one card.

    python3 scripts/torch_draw_rows_sweep.py [--windows N]

For each shape below, launches `row_weights_kernel` at 1, 2, 4 and 8
rows a thread (the builds `prng_kernel.draw_plan` chooses among) on the
keys a fit derives (`chip_smoke.case_draws`) and prints, beside the
card's name and power limit, the CUDA-event median of a launch
(`chip_smoke.time_ms`, 100 launches), the median over N `torch.profiler`
windows of 100 launches of its device time (`chip_smoke.device_median_ms`)
with the records each window saw, and the rows a thread `draw_plan`
picks there:

- ML 07's bootstrap, Poisson(1) over 80,000 rows, and ML 11's subsample,
  Bernoulli(0.8) over 80,000 rows, at 1, 2, 4, 7, 14, 20 and 40 rounds
  (a warm start's few rounds up to a whole fit);
- the ML 07 grid fused, Poisson(1) over 12 elements of 53,334 rows, at 1,
  2, 4 and 20 rounds.

The last line is one JSON object of every reading.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = (1, 2, 4, 7, 14, 20, 40)
FUSED_ROUNDS = (1, 2, 4, 20)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch_draw_rows_sweep: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from sml_tpu_torch.native import prng_kernel as pk
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = [(chip_smoke.RF_DRAWS._replace(trees=max(ROUNDS)), ROUNDS),
              (chip_smoke.SUB_DRAWS, ROUNDS),
              (chip_smoke.FUSED_DRAWS, FUSED_ROUNDS)]
    out = {"card": card, "sms": sms, "readings": []}
    for case, rounds in shapes:
        draws, _, n_pad = chip_smoke.case_draws(case, device)
        mode, rate = case.modes[0]
        E = len(case.seeds)
        for R in rounds:
            keys = draws.keys[case.trees - R:, 0]
            chosen = pk.draw_plan(n_pad, R * E, sms).rows
            weights = torch.empty((R, E * n_pad), dtype=torch.float32,
                                  device=device)
            for rows in sorted(pk._DRAW_ROWS):
                plan = pk.DrawPlan(256, rows, -(-n_pad // (256 * rows)))

                def launch(plan=plan, keys=keys):
                    pk._launch_row_weights(weights, keys, draws.modes,
                                           draws.rates, draws.counts,
                                           n_pad, plan)
                what = f"row_weights sweep {case.what} R={R} P={rows}"
                k_ms = chip_smoke.time_ms(launch, 100)
                d_ms = chip_smoke.device_median_ms(
                    launch, ("row_weights_kernel",), what,
                    windows=args.windows)
                seen = chip_smoke.seen_of(what)
                out["readings"].append(dict(
                    shape=case.what, mode=mode, rate=rate, rounds=R,
                    elements=E, rows=n_pad, rows_per_thread=rows,
                    chosen=rows == chosen, ms=k_ms, device_ms=d_ms,
                    device_seen=seen))
                mark = " (draw_plan's)" if rows == chosen else ""
                print(f"sweep  {case.what}: {R} x {E} x {n_pad} rows, "
                      f"{mode} {rate}, {plan}{mark}: "
                      f"kernel {k_ms!r} ms, device "
                      f"{chip_smoke.fmt_ms(d_ms)} ms ({seen}); card {card}")
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
