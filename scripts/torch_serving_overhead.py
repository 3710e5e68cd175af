"""Serving latency of one checkout of the port, and what its per-batch
hooks cost.

    python3 scripts/torch_serving_overhead.py ROOT [--reps 10] [--seed 0]

Runs the checkout at ROOT (its `sml_tpu_torch` and its `chip_smoke.py`)
on the card, with the flight recorder off and the dispatcher in its
default mode, at `chip_smoke.py`'s widths (phase 4's random ML 11 model,
its 96 requests of 1-64 rows):

- burst: the 96 requests from 8 clients at once through a `MicroBatcher`
  over `DeviceScorer.score_block` (2 ms flush deadline), `--reps` times;
  each request's latency, submit to result, pooled over the bursts;
- lone: 200 requests of 64 rows one after another (flush deadline 0), so
  each is its own batch: the per-batch host cost with no wait in it;
- score_block: a 64-row `score_block` call's host wall;
- registry: `chip_smoke.phase_registry` (phase 17), whose endpoint burst
  and canary-off waves percentiles it keeps;
- hooks (where the checkout has them): the per-call cost of each hook a
  batch passes through, in microseconds: the dispatcher's `decide`, the
  prewarm manifest's `record_stage` / `record_launch` (a signature seen
  before), the plan note, the device queue's add and sub, and the obs
  hooks a request and a flush pass with the recorder off.

Prints the card line and one JSON line. To compare two checkouts, unpack
the parent with `git archive` into a gitignored directory and run parent,
change, change, parent in one call on the same card.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import threading

import numpy as np


#: the checkout's engine clock (`utils.profiler.now`), bound by `main`
#: once ROOT is on the path
now = None


def percentiles(lat) -> dict:
    lat = np.asarray(lat, dtype=np.float64)
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "n": int(lat.size)}


def burst(submit, reqs, clients: int) -> list:
    """Every request at once from `clients` threads; latencies in ms."""
    futs, t_sub = [None] * len(reqs), [0.0] * len(reqs)
    barrier = threading.Barrier(clients)

    def client(lo):
        barrier.wait()
        for i in range(lo, len(reqs), clients):
            t_sub[i] = now()
            futs[i] = submit(reqs[i])
    threads = [threading.Thread(target=client, args=(lo,))
               for lo in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    lat = []
    for i, f in enumerate(futs):
        f.result(60)
        lat.append((now() - t_sub[i]) * 1e3)
    return lat


def per_call_us(fn, n: int = 20000) -> float:
    """Median over 5 loops of n calls, in microseconds a call."""
    walls = []
    for _ in range(5):
        t0 = now()
        for _ in range(n):
            fn()
        walls.append((now() - t0) / n * 1e6)
    return float(np.median(walls))


def hooks(device, scorer, X) -> dict:
    """The per-call cost of each per-batch hook of a checkout that has
    them (None for a checkout without the dispatcher)."""
    try:
        from sml_tpu_torch.parallel import dispatch, prewarm
    except ImportError:
        return None
    import torch
    from sml_tpu_torch.ml import inference
    from sml_tpu_torch.obs import _context
    from sml_tpu_torch.obs._metrics import METRICS
    from sml_tpu_torch.obs._watchdog import WATCHDOG
    from sml_tpu_torch.utils.profiler import PROFILER
    staged = scorer._host_prep(X[:64])
    hint = scorer._hint(staged)
    prewarm.record_stage(device, staged.shape, staged.dtype)
    binned = torch.zeros(staged.shape, dtype=torch.uint8, device=device)
    record = ("forest_traverse", None, [binned, *scorer._params],
              {"depth": 6, "init": None})
    prewarm.record_launch(device, *record)
    plan = scorer.kernel_spec()

    def queue():
        dispatch.DEVICE_QUEUE.add(64)
        dispatch.DEVICE_QUEUE.sub(64)

    def obs_request():
        _context.mint_request(rows=64, ts=0.0)
        METRICS.observe("serve.request_ms", 1.0, exemplar=None)

    def obs_flush():
        ctx = _context.fan_in([])
        ticket = WATCHDOG.open("serve.flush", "serve.batch", trace=ctx)
        with _context.activate(ctx):
            with PROFILER.span("serve.batch", rows=64, requests=1):
                pass
        METRICS.observe("serve.batch_ms", 1.0, exemplar=None)
        WATCHDOG.close(ticket)

    def bare_span():
        with PROFILER.span("serve.batch", rows=64, requests=1):
            pass

    return {"decide": per_call_us(lambda: dispatch.decide(hint, device)),
            "hint": per_call_us(lambda: scorer._hint(staged)),
            "record_stage": per_call_us(lambda: prewarm.record_stage(
                device, staged.shape, staged.dtype)),
            "record_launch": per_call_us(
                lambda: prewarm.record_launch(device, *record)),
            "note_plan": per_call_us(lambda: inference._note_plan(plan)),
            "device_queue_add_sub": per_call_us(queue),
            "obs_request": per_call_us(obs_request),
            "obs_flush": per_call_us(obs_flush),
            "profiler_span": per_call_us(bare_span)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    global now
    from sml_tpu_torch.utils.profiler import now
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_overhead: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sml_tpu_torch.ml.inference import DeviceScorer
    from sml_tpu_torch.native import build
    from sml_tpu_torch.serving import MicroBatcher
    device = torch.device("cuda", 0)
    card = cs.card_line()
    build.build(build.kernel_sources() + build.host_sources())
    model, cats = cs.ml11_model(args.seed)
    X, _ = cs.ml11_rows(np.random.default_rng([args.seed, 18]), 20_000, cats)
    scorer = DeviceScorer(model, device=device)
    reqs = cs.reg_requests(X)
    for r in reqs:  # warm: every request size once
        scorer.score_block(r)
    out = {"root": args.root, "card": card}

    lat = []
    with MicroBatcher(scorer.score_block, flush_micros=2000,
                      max_batch_rows=4096) as b:
        burst(b.submit, reqs, cs.REG_CLIENTS)  # warm the batcher
        for _ in range(args.reps):
            lat += burst(b.submit, reqs, cs.REG_CLIENTS)
    out["burst"] = percentiles(lat)

    lat = []
    with MicroBatcher(scorer.score_block, flush_micros=0,
                      max_batch_rows=4096) as b:
        for i in range(220):
            t0 = now()
            b.submit(X[64 * (i % 100):64 * (i % 100 + 1)]).result(60)
            if i >= 20:
                lat.append((now() - t0) * 1e3)
    out["lone"] = percentiles(lat)

    walls = []
    for i in range(220):
        t0 = now()
        scorer.score_block(X[64 * (i % 100):64 * (i % 100 + 1)])
        if i >= 20:
            walls.append((now() - t0) * 1e3)
    out["score_block_64"] = percentiles(walls)

    out["hooks_us"] = hooks(device, scorer, X)

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        reg = cs.phase_registry(device, card)
    ep = reg["endpoint"]
    out["registry"] = {"burst": ep["burst"], "waves": ep["canary_off"],
                       "phase_s": reg["phase_s"]}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
