"""Times one checkout's sampled fits and their draws, on one card.

    python3 scripts/torch_draw_fit_walls.py [ROOT] [--reps N] [--seed S]

Imports `sml_tpu_torch` from ROOT (a checkout of the repository; the
repository itself by default), and on `chip_smoke.py`'s fit-phase rows
(80,000 ML 11-shaped rows, seed S) prints, beside the card's name and
power limit, for ML 07's random forest (20 trees, depth 6, 40 bins),
ML 11's XGBoost at `subsample=0.8`, the ML 07 grid fused (`fit_cv_grid`
over `chip_smoke.tune_grid()` and 3 folds, 12 elements), and the same
forest and XGBoost cut to 2 trees (the few rounds a warm start appends):

- the median host-clock wall of N fits (`torch.cuda.synchronize()` at
  the end of each; the bins are cached after the first), and the median
  of their fit loops (the `program.*` span);
- the launches of the draw kernels (`row_weights`, `feature_mask`) in
  one fit, from the wrappers' `LAUNCHES`;
- the device time of the draw kernels' launches over one fit by
  `torch.profiler` (`chip_smoke.profile_busy`), the median over 3 fits.

Run it on two checkouts in one call to compare them: parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAW_KERNELS = ("row_weights_kernel", "feature_mask_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)   # the sml_tpu_torch under test
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_draw_fit_walls: no CUDA device", file=sys.stderr)
        return 2
    # this repository's chip_smoke, whatever ROOT holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import sml_tpu_torch
    pkg = os.path.dirname(os.path.abspath(sml_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"imported {pkg}, not the package under {root}",
              file=sys.stderr)
        return 2
    from sml_tpu_torch.ml import _tree_models as ptm
    from sml_tpu_torch.native import prng_kernel as pk
    from sml_tpu_torch.utils.profiler import PROFILER, now
    from sml_tpu_torch.xgboost import XgboostRegressor
    X, logy, cats = chip_smoke.fit_rows(args.seed)
    X, logy = X[:80_000], logy[:80_000]
    Xs, ys, _, _ = chip_smoke.tune_folds(args.seed)
    trials = chip_smoke.tune_grid()
    fits = {
        "ml07_rf": (lambda: chip_smoke._fit_rf(X, logy, cats, None),
                    "program.tree_ensemble"),
        "ml11_subsample": (lambda: chip_smoke._fit_xgb_sub(X, logy, cats,
                                                          None),
                           "program.tree_ensemble"),
        "ml07_grid_fused": (lambda: ptm.fit_cv_grid(Xs, ys, cats, trials),
                            "program.tree_ensemble_trials"),
        "ml07_rf_2_trees": (lambda: ptm.RandomForestRegressor(
            numTrees=2, maxDepth=6, maxBins=40, seed=42).fit(
                X, np.exp(logy), categorical=cats),
            "program.tree_ensemble"),
        "ml11_subsample_2_rounds": (lambda: XgboostRegressor(
            n_estimators=2, learning_rate=0.15, max_depth=6, max_bins=64,
            random_state=42, subsample=0.8).fit(X, logy, categorical=cats),
            "program.tree_ensemble"),
    }
    out = {}
    for name, (fit, span) in fits.items():
        fit()                                   # bins cached, kernels built
        torch.cuda.synchronize()
        before = dict(pk.LAUNCHES)
        fit()
        launches = {k: pk.LAUNCHES[k] - before[k] for k in before}
        walls, loops = [], []
        PROFILER.enabled = True
        try:
            for _ in range(args.reps):
                PROFILER.reset()
                t0 = now()
                fit()
                torch.cuda.synchronize()
                walls.append((now() - t0) * 1e3)
                loops.append(sum(sp.wall_s for sp in PROFILER.spans()
                                 if sp.name == span) * 1e3)
        finally:
            PROFILER.enabled = False
        draws = []
        for _ in range(3):
            busy, _ = chip_smoke.profile_busy(fit, span)
            draws.append(sum(v for k, v in busy.items()
                             if any(d in k for d in DRAW_KERNELS)))
        out[name] = {"wall_ms": float(np.median(walls)), "walls_ms": walls,
                     "loop_ms": float(np.median(loops)),
                     "draw_launches": launches,
                     "draw_device_ms": float(np.median(draws))}
    print(json.dumps({"root": root, "fits": out,
                      "card": chip_smoke.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
