"""Where phase 21's open-loop overruns come from: the load harness under
four settings, on one pool, in turns.

    python3 scripts/torch_fleet_load.py [--seed 0]

Runs on the card from the repository root. It fits `chip_smoke.py`'s
ML 11 XGBoost (phase 8's 80,000 rows, the recorder on for its drift
baseline), starts phase 21's pool (3 replicas, a 256-row bound each)
and, for each setting, takes the closed-loop probe's sustained rate and
replays phase 21's three-phase trace at 0.5x / 2x (bursty, factor 4) /
0.5x of it through the router. The settings, in turns: the recorder on
or off (the replicas' drift observers and trace events run only with it
on) and the driver's pool 32 wide (`sml.load.workers`) or 128 (phase
21's), and last the recorder on, 128 workers, with the garbage
collector's objects frozen (`gc.freeze()`) before the replay. For each
replay it records every fire's lag behind its scheduled instant and the
collector's pauses by generation (`gc.callbacks`).

Prints the card line and one JSON line a setting: the rate, the
overruns, the largest fire lag, the collections and their longest pause
by generation, and p50 / p99 / p99.9 by phase.
"""

import argparse
import gc
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: (recorder on, workers, collector frozen), in the order they run
SETTINGS = ((True, 32, False), (False, 32, False), (False, 128, False),
            (True, 128, False), (True, 128, True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fleet_load: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.fleet import ReplicaPool, Router
    from sml_tpu_torch.loadgen import OpenLoopDriver, closed_loop_probe
    from sml_tpu_torch.native import build
    from sml_tpu_torch.utils.profiler import now
    build.build(build.kernel_sources() + build.host_sources())
    card = cs.card_line()
    print(card)
    device = torch.device("cuda", 0)
    mlflow.set_tracking_uri(os.path.join(tempfile.mkdtemp(), "mlruns"))
    X, logy, cats = cs.fit_rows(args.seed)
    cs.obs_recorder(True)
    with mlflow.start_run():
        model = cs._fit_xgb(X[:80_000], logy[:80_000], cats, device)
    cs.flt_register(model, cs.FLT_NAME)
    pool = ReplicaPool(cs.FLT_NAME, replicas=cs.FLT_REPLICAS, device=device,
                       queue_rows=cs.FLT_QUEUE_ROWS)
    router = Router(pool)

    def score(X_, priority, model_):
        return router.score(X_, priority, timeout=30.0)
    pauses, lags, t_gc = [], [], {}

    def on_gc(phase, info):
        if phase == "start":
            t_gc["t"] = now()
        else:
            pauses.append((info["generation"], (now() - t_gc["t"]) * 1e3))
    fire = OpenLoopDriver._fire_one

    def timed_fire(self, r, epoch):
        lags.append((now() - (epoch + r.t)) * 1e3)
        return fire(self, r, epoch)
    gc.callbacks.append(on_gc)
    OpenLoopDriver._fire_one = timed_fire
    try:
        for recorder, workers, frozen in SETTINGS:
            cs.obs_recorder(recorder)
            closed = closed_loop_probe(
                score, cs.flt_spec(100.0).compile()[:cs.FLT_PROBE],
                feature_dim=cs.N_FEAT)
            rate = len(closed) / (sum(closed) / 1e3)
            if frozen:
                gc.collect()
                gc.freeze()
            del pauses[:], lags[:]
            rep = OpenLoopDriver(score, cs.flt_spec(rate).compile(),
                                 feature_dim=cs.N_FEAT,
                                 workers=workers).run()
            if frozen:
                gc.unfreeze()
            print(json.dumps({
                "recorder": recorder, "workers": workers, "frozen": frozen,
                "rate": rate, "requests": rep["requests"],
                "overrun": rep["overrun"], "shed": rep["shed"],
                "timeout": rep["timeout"], "max_lag_ms": max(lags),
                "collections": {g: sum(1 for x, _ in pauses if x == g)
                                for g in (0, 1, 2)},
                "longest_pause_ms": {g: max([d for x, d in pauses if x == g]
                                            or [0.0]) for g in (0, 1, 2)},
                "phases": {k: [v["p50_ms"], v["p99_ms"], v["p999_ms"]]
                           for k, v in rep["phases"].items()},
                "card": card}))
    finally:
        OpenLoopDriver._fire_one = fire
        gc.callbacks.remove(on_gc)
        pool.close()
        cs.obs_recorder(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
