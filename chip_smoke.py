"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. It needs a CUDA card and `nvcc` (it builds
every kernel under `sml_tpu_torch/csrc/` at first use) and exits non-zero
without printing a result when either is missing or any phase fails.

Phases:
1. device: the card's name and power limit (from nvidia-smi);
2. build: every kernel source, with one nvcc process each, in parallel;
3. kernels: `forest_traverse` against its plain PyTorch version on the
   card, bit for bit, on seeded random ensembles with early leaves and
   feature ids past the row, at the widths of the tree models the
   repository fits (ML 11 XGBoost, ML 07 random forest, ML 06 decision
   tree, a uint16 and an int32 bin matrix) at 1, 37, 64, 4,096 and
   100,000 rows, and at shapes that take the kernel's other paths: rows
   too wide to stage their bins (400 features), trees built in chunks
   (300 trees, in many tree groups and in one; depth 13) and trees past
   shared memory (depth 16);
4. main path, serving: an ML 11-shaped model (40 trees, depth 6, 10
   features, 64 bins) built through the port's loader, scored through
   `DeviceScorer.score_block` (100,000 rows), evaluated through the fused
   `forest_eval_fn` (exp link, 20,000 labelled rows) and served through
   `MicroBatcher` (96 concurrent requests of 1-64 rows), with the
   kernel's launch count read around it and split by row count;
5. times: the kernel (CUDA-event median of one call, and device time
   by `torch.profiler`), its plain version and its bound at the ML 11
   shape at 64, 4,096 and 100,000 rows, beside the card's name and
   power limit;
6. breakdown: where one `score_block` call spends its time (binning,
   staging, kernel, copy back), at 4,096 and 100,000 rows;
7. fit kernels: `hist_accumulate` against its plain version at the ML 11
   shape (80,000 rows, 64 bins, uint8) for 1-32 slots, at ML 06 (40
   bins), with uint16 (300 bins) and int32 (70,000 bins) matrices, an
   odd row count, a few rows and rows too wide to stage their bins, with
   ~20% zero weights, each launched twice and required bit-identical;
   `split_scan` against its plain version, exactly, on histograms of
   dyadic values with ties, masked, all-masked and NaN nodes;
8. main path, fit: 100,000 seeded ML 11-shaped rows split 80,000 /
   20,000; `XgboostRegressor` (ML 11: 40 trees, depth 6, 64 bins, step
   0.15) and `DecisionTreeRegressor` (ML 06: depth 5, 40 bins) fit on the
   card, with every kernel launch counted, then scored through
   `DeviceScorer.score_block`; the course's rmse ordering; the same two
   fits at 16,000 rows on the card and on the CPU agree;
9. fit times: each fit kernel (CUDA-event median, and device time of
   the kernel's own launches by `torch.profiler`, "not measured" unless
   the profiler saw each launch), its plain version, its bound and (for
   `hist_accumulate`) one `index_add_` at every shape the ML 11 fit
   launches it at, and their sum over one fit (40 trees x 6 levels);
   beside the float64-summing `hist_accumulate` at 16 and 32 slots, its
   f32-accumulating build (timed only, never used by the port) and the
   cells where each differs from the plain version on the CPU; the
   wrappers' host time per call; and where one ML 11 fit spends its time
   (host binning, staging, kernel device time, the rest), with the
   card's busy share and the fit kernels' device time from
   `torch.profiler`.

The second-to-last line is a JSON object listing each kernel; the last
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

#: H100 SXM published peaks (NVIDIA data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: the tolerance of the card's scores against the CPU's (`score_block`
#: on both): the leaf choice is exact and the two sums over trees are
#: f32 in one order; the kernel itself is held to its plain version bit
#: for bit
RTOL = 1e-5
#: histogram cells: |kernel - plain| <= HIST_RTOL * (the cell summed over
#: |contributions|) + 1e-30; both sum in float64 in another order and
#: round to f32 once
HIST_RTOL = 1e-5
#: held-out rmse of a fit on the card and the same fit on the CPU: the
#: golden tolerance, max(1e-3, 1e-5 * |rmse|)
RMSE_ATOL, RMSE_RTOL = 1e-3, 1e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ ensembles
def random_tables(rng, n_trees: int, depth: int, n_bins: int, n_feat: int,
                  early_leaf: float = 0.15):
    """Heap-layout tables of a random ensemble: every node above `depth`
    splits on a random feature and bin, except a random `early_leaf`
    share of internal nodes below the root, which are leaves."""
    n_nodes = 2 ** (depth + 1) - 1
    level = np.floor(np.log2(np.arange(n_nodes) + 1)).astype(np.int64)
    sf = rng.integers(0, n_feat, size=(n_trees, n_nodes)).astype(np.int32)
    sf[:, level == depth] = -1
    early = (rng.random((n_trees, n_nodes)) < early_leaf) & (level > 0)
    sf[early] = -1
    sb = rng.integers(0, max(n_bins - 1, 1),
                      size=(n_trees, n_nodes)).astype(np.int32)
    lv = rng.normal(0.0, 0.3, size=(n_trees, n_nodes)).astype(np.float32)
    return sf, sb, lv


SHAPES = [
    # name, trees, depth, bins, bin dtype, weights
    ("ML 11 XGBoost", 40, 6, 64, np.uint8, "step"),
    ("ML 07 RF", 20, 6, 40, np.uint8, "mean"),
    ("ML 06 DT", 1, 5, 40, np.uint8, "mean"),
    ("uint16 bins", 40, 6, 300, np.uint16, "step"),
    ("int32 bins", 40, 6, 70_000, np.int32, "step"),
]
N_FEAT = 10
#: row counts of the kernel checks: requests of one row to a full
#: request, a serving batch, the ML 12 batch size
CHECK_ROWS = (1, 37, 64, 4096, 100_000)
#: shapes of the kernel's other paths, each with its row counts, its
#: features and what its plan must hold
PATH_SHAPES = [
    # (shape, rows, features, plan fields)
    (("wide rows", 8, 6, 16, np.int32, "step"), (37, 4096), 400,
     {"path": "shared", "stage_x": 0}),
    (("many trees", 300, 6, 64, np.uint8, "step"), (37, 4096), N_FEAT,
     {"path": "shared", "n_chunks": 2}),
    # one tree group, its running sum carried across chunks in `out`
    (("many trees", 300, 6, 64, np.uint8, "step"), (100_000,), N_FEAT,
     {"path": "shared", "n_chunks": 2, "groups": 1}),
    (("deep, tree chunks", 4, 13, 300, np.uint16, "step"), (37, 4096),
     N_FEAT, {"path": "shared", "n_chunks": 2}),
    (("deep, global memory", 2, 16, 300, np.uint16, "step"), (37, 4096),
     N_FEAT, {"path": "global"}),
]


def shape_operands(rng, shape, n_rows: int, device, n_feat: int = N_FEAT):
    """Seeded operands of one kernel check: a random ensemble of `shape`
    (with ~1% of its split features past the row) and uniform bins."""
    _, T, depth, n_bins, dtype, wkind = shape
    sf, sb, lv = random_tables(rng, T, depth, n_bins, n_feat)
    sf[(sf >= 0) & (rng.random(sf.shape) < 0.01)] = n_feat + 3
    w = np.full(T, 0.15 if wkind == "step" else 1.0 / T, np.float32)
    binned = rng.integers(0, n_bins, size=(n_rows, n_feat)).astype(dtype)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(binned), to(sf), to(sb), to(lv), to(w), depth


def levels_descended(binned, sf, sb, depth: int) -> int:
    """Node visits the traversal makes on these inputs (rows x trees x
    internal levels reached): the data-dependent work of the bound."""
    x = binned.to(torch.int64)
    total = 0
    for t in range(sf.shape[0]):
        node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for _ in range(depth):
            f = sf[t].to(torch.int64)[node]
            internal = f >= 0
            total += int(internal.sum())
            xb = x.gather(1, f.clamp(0, x.shape[1] - 1)[:, None])[:, 0]
            xb = torch.where(f < x.shape[1], xb, 0)
            child = 2 * node + 1 + (xb > sb[t].to(torch.int64)[node]).long()
            node = torch.where(internal, child, node)
    return total


def table_bytes(sf, depth: int) -> int:
    """Bytes of the node tables a traversal must read: sf and sb of each
    internal node a row can reach (sf and lv at an early leaf), lv of
    each reachable last-level node. A node below an early leaf is never
    reached."""
    f = sf[:, :2 ** (depth + 1) - 1].cpu().numpy()
    reach = np.ones(f.shape, bool)
    for lvl in range(1, depth + 1):
        j = np.arange(2 ** lvl - 1, 2 ** (lvl + 1) - 1)
        par = (j - 1) // 2
        reach[:, j] = reach[:, par] & (f[:, par] >= 0)
    nrec = 2 ** depth - 1
    return 8 * int(reach[:, :nrec].sum()) + 4 * int(reach[:, nrec:].sum())


def bound_ms(binned, sf, sb, depth: int):
    """(ms, "bytes" or "operations"): the larger of the bytes the call
    must move over HBM bandwidth (bins read once, the reachable part of
    the tables (`table_bytes`) and the weights read once, margins written
    once) and its operations over the f32 rate outside the tensor cores
    (per node visit a compare and the child index, 3; per row and tree
    the weighted add, 2). The guide's table lists no integer rate, so
    integer work is counted at the f32 rate."""
    n, n_feat = binned.shape
    T = sf.shape[0]
    nbytes = n * n_feat * binned.element_size() + table_bytes(sf, depth) \
        + 4 * T + 4 * n
    ops = 3 * levels_descended(binned, sf, sb, depth) + 2 * n * T
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events around each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int, names, per_call: int = 1):
    """Device time of one call by `torch.profiler`: the device time of
    the kernels whose names contain one of `names`, over `reps` calls,
    divided by `reps` (the CUDA-event median of `time_ms` also holds the
    host's gap before the launch). A window in which the profiler did not
    see exactly reps x `per_call` launches of those kernels is retaken, up
    to three times; then None ("not measured")."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window where the profiler lost events is retaken
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            t = float(getattr(ev, "self_device_time_total", 0.0))
            if t > 0 and any(nm in ev.key for nm in names):
                total += t
                count += int(ev.count)
        if count == reps * per_call and total > 0:
            return total / 1e3 / reps
        print(f"device time of {names}: the profiler saw {count} launches, "
              f"not {reps * per_call}")
    print(f"device time of {names}: not measured")
    return None


def fmt_ms(x) -> str:
    return "not measured" if x is None else repr(x)


def host_us(fn, calls: int = 400) -> float:
    """Median host time of one call in microseconds: perf_counter around
    the call, no synchronise inside (the launch is asynchronous); the
    queue is drained every 50 calls, outside the timed calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def assert_close(got: np.ndarray, want: np.ndarray, what: str) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} "
                             f"or non-finite values")
    atol = RTOL * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = np.abs(got - want)
    if not (err <= atol + RTOL * np.abs(want)).all():
        raise AssertionError(f"{what}: max abs err {err.max()} over "
                             f"atol {atol} + rtol {RTOL}")
    return float(err.max(initial=0.0))


# ------------------------------------------------------------ phases
def phase_kernels(seed: int, device) -> float:
    """Kernel against plain, bit for bit, at every shape and row count,
    each launch's plan printed and the other paths' plans checked;
    returns the largest absolute difference seen (0.0)."""
    from sml_tpu_torch.native import traverse_kernel as tk
    cases = [(s, CHECK_ROWS, N_FEAT, {"path": "shared", "stage_x": 1,
                                      "n_chunks": 1}) for s in SHAPES]
    worst = 0.0
    for i, (shape, rows, n_feat, expect) in enumerate(cases + PATH_SHAPES):
        for n_rows in rows:
            rng = np.random.default_rng([seed, i, n_rows])
            binned, sf, sb, lv, w, depth = shape_operands(
                rng, shape, n_rows, device, n_feat)
            plan = tk.traverse_plan(n_rows, n_feat, binned.element_size(),
                                    *sf.shape, depth)
            if any(getattr(plan, k) != v for k, v in expect.items()):
                raise AssertionError(f"forest_traverse {shape[0]} x {n_rows}"
                                     f": {plan} does not hold {expect}")
            got = tk.forest_traverse(binned, sf, sb, lv, w, depth=depth)
            torch.cuda.synchronize()
            want = tk.forest_margin_plain(binned, sf, sb, lv, w, depth)
            got, want = got.cpu().numpy(), want.cpu().numpy()
            np.testing.assert_array_equal(
                got, want, err_msg=f"forest_traverse {shape[0]} x {n_rows}")
            err = float(np.abs(got - want).max(initial=0.0))
            print(f"kernel-vs-plain  forest_traverse  {shape[0]:<19} "
                  f"rows={n_rows:<7} T={sf.shape[0]} depth={depth} "
                  f"F={n_feat} dtype={binned.dtype}: {plan} "
                  f"max_abs_err={err!r} bit-equal  ok")
            worst = max(worst, err)
    return worst


def ml11_model(seed: int):
    """An ML 11-shaped boosted model: seeded raw rows (3 indexed
    categoricals, 7 numerics with gaps), bin edges from the port's
    `make_bins` at maxBins 64, random trees over those bins, carried
    through `spec_from_arrays` as a saved model would be."""
    from sml_tpu_torch.ml._tree_models import spec_from_arrays
    from sml_tpu_torch.ml.tree_impl import make_bins
    from sml_tpu_torch.xgboost import XgboostRegressorModel
    rng = np.random.default_rng([seed, 11])
    cats = {0: 36, 1: 3, 2: 20}
    X, y = ml11_rows(rng, 50_000, cats)
    _, binning = make_bins(X, y, 64, categorical=cats)
    T, depth = 40, 6
    sf, sb, lv = random_tables(rng, T, depth, 64, N_FEAT)
    lv *= 0.1
    zeros = np.zeros_like(lv)
    keys = sorted(binning.cat_remap)
    arrays = dict(split_feature=sf, split_bin=sb, leaf_value=lv, gain=zeros,
                  cover=zeros, edges=binning.edges,
                  tree_weights=np.full(T, 0.15, np.float32),
                  scalars=np.asarray([depth, 5.0, N_FEAT, 0.0, len(keys)]),
                  remap_slots=np.asarray(keys, np.int64),
                  **{f"remap_{k}": binning.cat_remap[k] for k in keys})
    return XgboostRegressorModel(spec_from_arrays(arrays)), cats


def ml11_rows(rng, n: int, cats):
    """Raw ML 11-shaped rows and log-price labels."""
    X = rng.normal(size=(n, N_FEAT))
    for f, card in cats.items():
        X[:, f] = rng.integers(0, card, size=n)
    X[rng.random(n) < 0.05, 5] = np.nan  # imputed-column gaps
    y = 5.0 + 0.3 * X[:, 3] - 0.2 * np.nan_to_num(X[:, 4]) \
        + rng.normal(0, 0.4, n)
    return X, y


def fit_labels(rng, X):
    """Log-price labels for the fit phases, on ML 11-shaped rows: a
    linear part, per-category offsets of the 36-value categorical, a
    smooth interaction and noise, so that the boosted ensemble has
    structure to find that one depth-5 tree cannot hold."""
    offsets = (np.arange(36) % 7 - 3) * 0.12
    return (4.8 + 0.3 * X[:, 3] - 0.2 * np.nan_to_num(X[:, 4])
            + offsets[X[:, 0].astype(np.int64)]
            + 0.25 * np.tanh(X[:, 6]) * X[:, 7] + 0.2 * (X[:, 1] == 1)
            + rng.normal(0.0, 0.25, X.shape[0]))


def phase_main_path(seed: int, device) -> dict:
    """Score, evaluate and serve through the port's entry points; return
    the launch count of the run and its split by row count."""
    from sml_tpu_torch.ml import inference
    from sml_tpu_torch.ml.evaluation import _reg_metric, host_reg_stats
    from sml_tpu_torch.ml.inference import DeviceScorer, forest_eval_fn
    from sml_tpu_torch.ml.tree_impl import bin_with
    from sml_tpu_torch.ml._staging import stage_bins_cached
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.serving import MicroBatcher
    from sml_tpu_torch.utils.profiler import PROFILER

    model, cats = ml11_model(seed)
    rng = np.random.default_rng([seed, 12])
    X, logy = ml11_rows(rng, 100_000, cats)
    price = np.exp(logy[:20_000])

    plain_on_cuda = [0]
    plain = tk.forest_margin_plain

    def watched_plain(binned, *args):
        if binned.device.type == "cuda":
            plain_on_cuda[0] += 1
        return plain(binned, *args)

    # the row count of every traversal the scoring path asks for
    launch_rows = []
    traverse = inference.forest_traverse

    def counted_traverse(binned, *args, **kw):
        launch_rows.append(binned.shape[0])
        return traverse(binned, *args, **kw)

    tk.forest_margin_plain = watched_plain
    inference.forest_traverse = counted_traverse
    PROFILER.reset()
    tk.LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        scorer = DeviceScorer(model)
        pred = scorer.score_block(X)
        t_score = time.perf_counter() - t0
        if pred.shape != (100_000,) or not np.isfinite(pred).all():
            raise AssertionError(f"score_block gave {pred.shape} "
                                 f"with non-finite values")

        # fused predict+eval, exp link, against host stats of the
        # materialised predictions
        Xe = X[:20_000]
        spec = model._spec
        Bd = stage_bins_cached(bin_with(Xe, spec.binning), scorer.device)
        lab = torch.from_numpy(price.astype(np.float32)).to(scorer.device)
        lmask = torch.ones_like(lab)
        stats = forest_eval_fn(spec.depth, "exp")(
            Bd, lab, lmask, *scorer._params, float(spec.base))
        stats = [float(s) for s in stats]
        host = host_reg_stats(np.exp(pred[:20_000]), price)
        # the device applies base and the link in f32, the host in f64
        np.testing.assert_allclose(stats, host, rtol=1e-4)
        rmse = _reg_metric("rmse", *stats)
        print(f"main-path  forest_eval exp-link 20000 rows: rmse={rmse!r} "
              f"host_rmse={_reg_metric('rmse', *host)!r}")

        # serve: 96 concurrent requests of 1-64 rows
        sizes = rng.integers(1, 65, size=96)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        reqs = [X[offs[i]:offs[i + 1]] for i in range(len(sizes))]
        futs = [None] * len(reqs)
        barrier = threading.Barrier(8)
        with MicroBatcher(scorer.score_block, max_batch_rows=4096,
                          flush_micros=2000) as server:
            def client(lo):
                barrier.wait()
                for i in range(lo, len(reqs), 8):
                    futs[i] = server.submit(reqs[i])
            threads = [threading.Thread(target=client, args=(lo,))
                       for lo in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            got = [f.result(60) for f in futs]
        for i, (g, r) in enumerate(zip(got, reqs)):
            np.testing.assert_array_equal(g, scorer.score_block(r))
            np.testing.assert_array_equal(g, pred[offs[i]:offs[i + 1]])

        # a worker thread on its own stream: the launch goes to that
        # stream and the copy back waits for it
        side = {}

        def on_stream():
            s = torch.cuda.Stream(device=scorer.device)
            with torch.cuda.stream(s):
                side["out"] = scorer.score_block(X[:4096])
                side["done"] = s.query()
        th = threading.Thread(target=on_stream)
        th.start()
        th.join(timeout=60)
        if not side.get("done"):
            raise AssertionError("score_block returned before its stream "
                                 "finished")
        np.testing.assert_array_equal(side["out"], pred[:4096])
        torch.cuda.synchronize()
    finally:
        launches = tk.LAUNCHES
        tk.forest_margin_plain = plain
        inference.forest_traverse = traverse
    counters = PROFILER.counters()
    if launches <= 0:
        raise AssertionError("the main path launched forest_traverse 0 times")
    if plain_on_cuda[0]:
        raise AssertionError(f"the plain traversal ran {plain_on_cuda[0]} "
                             f"times on CUDA tensors")
    if counters.get("serve.shed", 0.0):
        raise AssertionError(f"{counters['serve.shed']} requests shed")
    print(f"main-path  score_block 100000 rows {t_score * 1e3:.1f} ms "
          f"(first call, host clock, binning and staging included); "
          f"served {len(reqs)} requests in "
          f"{int(counters.get('serve.batches', 0))} batches; "
          f"forest_traverse launches={launches}")
    split = {"<=64": sum(r <= 64 for r in launch_rows),
             "65-4096": sum(64 < r <= 4096 for r in launch_rows),
             ">4096": sum(r > 4096 for r in launch_rows)}
    if len(launch_rows) != launches:
        raise AssertionError(f"{len(launch_rows)} traversals asked for, "
                             f"{launches} launches")
    print(f"main-path  forest_traverse launches by rows: {split} "
          f"(rows of the larger ones: "
          f"{sorted(r for r in launch_rows if r > 64)})")

    # agreement with the plain version on the host, on a small input
    cpu = DeviceScorer(model, device="cpu").score_block(X[:2000])
    assert_close(pred[:2000], cpu, "score_block cuda vs cpu")
    return {"launches": launches, "launches_by_rows": split}


#: row counts `forest_traverse` is timed at: a full request, a serving
#: batch, the ML 12 batch size
TIME_ROWS = (64, 4096, 100_000)


def ml11_operands(seed: int, n_rows: int, device):
    """The seeded ML 11-shaped operands (`SHAPES[0]`) the kernel is timed
    on at `n_rows` rows."""
    rng = np.random.default_rng([seed, 0, n_rows])
    return shape_operands(rng, SHAPES[0], n_rows, device)


def traverse_ms(ops, reps: int):
    """(CUDA-event median, profiler device time) of one `forest_traverse`
    call on `ops`; the launches made here are not counted."""
    from sml_tpu_torch.native import traverse_kernel as tk
    binned, sf, sb, lv, w, depth = ops
    launches = tk.LAUNCHES

    def call():
        return tk.forest_traverse(binned, sf, sb, lv, w, depth=depth)
    k_ms = time_ms(call, reps)
    d_ms = device_ms(call, reps, ("forest_traverse",))
    tk.LAUNCHES = launches
    return k_ms, d_ms


def phase_times(seed: int, device, card: str) -> dict:
    """Kernel (CUDA-event median and profiler device time), plain and
    bound at the ML 11 shape at each of `TIME_ROWS`, for the kernels
    line."""
    from sml_tpu_torch.native import traverse_kernel as tk
    out = {}
    for n_rows in TIME_ROWS:
        ops = ml11_operands(seed, n_rows, device)
        binned, sf, sb, lv, w, depth = ops
        k_ms, d_ms = traverse_ms(ops, 100)
        p_ms = time_ms(lambda: tk.forest_margin_plain(binned, sf, sb, lv,
                                                      w, depth), 5)
        b_ms, b_by = bound_ms(binned, sf, sb, depth)
        plan = tk.traverse_plan(n_rows, N_FEAT, 1, *sf.shape, depth)
        print(f"time  forest_traverse  ML 11 T=40 depth=6 F=10 uint8 "
              f"rows={n_rows} {plan}: kernel {k_ms!r} ms (device "
              f"{fmt_ms(d_ms)} ms), plain {p_ms!r} ms, bound {b_ms!r} ms "
              f"({b_by}); card {card}")
        out[n_rows] = (k_ms, d_ms, p_ms, b_ms, b_by)
    return out


def phase_breakdown(seed: int, device, card: str) -> None:
    """Host-clock split of one `score_block` call on fresh rows (a full
    serving batch and the ML 12 batch size): host binning, staging to
    the card, the launch until the card is done, the copy back, and the
    whole call on other fresh rows."""
    from sml_tpu_torch.ml._staging import stage_bins_cached
    from sml_tpu_torch.ml.inference import DeviceScorer
    from sml_tpu_torch.ml.tree_impl import bin_with
    from sml_tpu_torch.native import traverse_kernel as tk
    model, cats = ml11_model(seed)
    spec = model._spec
    scorer = DeviceScorer(model, device=device)
    launches = tk.LAUNCHES
    for n_rows in (4096, 100_000):
        rng = np.random.default_rng([seed, 13, n_rows])
        X, _ = ml11_rows(rng, n_rows, cats)
        X2, _ = ml11_rows(rng, n_rows, cats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        binned = bin_with(X, spec.binning)
        t1 = time.perf_counter()
        Bd = stage_bins_cached(binned, device)
        t2 = time.perf_counter()
        out = tk.forest_traverse(Bd, *scorer._params, depth=spec.depth)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu().numpy()
        t4 = time.perf_counter()
        scorer.score_block(X2)
        t5 = time.perf_counter()
        print(f"breakdown  score_block ML 11 rows={n_rows}: "
              f"bin_with {(t1 - t0) * 1e3!r} ms, stage {(t2 - t1) * 1e3!r} "
              f"ms, launch+kernel {(t3 - t2) * 1e3!r} ms, copy back "
              f"{(t4 - t3) * 1e3!r} ms; whole call on fresh rows "
              f"{(t5 - t4) * 1e3!r} ms (host clock); card {card}")
    tk.LAUNCHES = launches  # not the main path's launches


# ------------------------------------------------------------ fit kernels
HIST_SHAPES = [
    # name, rows, features, bins, bin dtype, slot counts
    ("ML 11", 80_000, N_FEAT, 64, np.uint8, (1, 2, 4, 8, 16, 32)),
    ("ML 06", 80_000, N_FEAT, 40, np.uint8, (1, 2, 4, 8, 16)),
    ("uint16 bins", 80_000, N_FEAT, 300, np.uint16, (8, 32)),
    ("int32 bins", 80_000, N_FEAT, 70_000, np.int32, (2,)),
    # the last rows past a multiple of 16 (plain loads), a chunk of a
    # few rows, and rows too wide to stage their bins
    ("odd rows", 80_001, N_FEAT, 64, np.uint8, (8,)),
    ("few rows", 37, N_FEAT, 64, np.uint8, (4,)),
    ("wide rows", 20_000, 400, 16, np.int32, (4,)),
]
SCAN_SHAPES = [
    # name, bins, node counts
    ("ML 11", 64, (1, 2, 4, 8, 16, 32)),
    ("ML 06", 40, (16,)),
    ("uint16 bins", 300, (32,)),
    ("histogram past 48 KB a node", 5000, (4,)),
]


def hist_operands(rng, n: int, n_bins: int, dtype, n_slots: int, device,
                  n_feat: int = N_FEAT):
    """Seeded rows for one histogram launch: uniform bins and slots,
    normal gradients, Hessians in [0.1, 1], whole weights with ~20%
    zeros."""
    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    binned = rng.integers(0, n_bins, size=(n, n_feat)).astype(dtype)
    lid = rng.integers(0, n_slots, size=n).astype(np.int32)
    grad = rng.normal(0.0, 1.0, n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    weight = rng.integers(1, 3, n).astype(np.float32)
    weight[rng.random(n) < 0.2] = 0.0
    return to(binned), to(lid), to(grad), to(hess), to(weight)


def dyadic_hist(rng, n_bins: int, width: int, device):
    """An (F, B, W, 3) histogram of multiples of 1/8, 1/4 and whole
    counts (every prefix sum exact in f32) with a repeated feature
    (exact ties), an all-in-one-bin node, a zero-Hessian node and a node
    whose squared sums overflow to NaN scores; and a feature mask with
    some features and one whole node masked."""
    h = np.zeros((N_FEAT, n_bins, width, 3), np.float32)
    h[..., 0] = rng.integers(-64, 64, size=h.shape[:3]) / 8.0
    h[..., 2] = rng.integers(0, 6, size=h.shape[:3])
    h[..., 1] = h[..., 2] * rng.integers(1, 5, size=h.shape[:3]) / 4.0
    h[1] = h[0]
    fmask = (rng.random((width, N_FEAT)) > 0.2).astype(np.float32)
    fmask[:, 0] = 1.0
    for w, kind in enumerate(("one bin", "no hessian", "overflow",
                              "masked")[:max(width - 1, 0)], start=1):
        if kind == "one bin":
            h[:, :, w] = 0.0
            h[:, 2, w] = [1.0, 2.0, 4.0]
        elif kind == "no hessian":
            h[:, :, w, 1] = 0.0
        elif kind == "overflow":
            h[:, :, w, 0] = np.where(np.arange(n_bins) % 2 == 0, 2.0 ** 70,
                                     0.0)
            h[:, :, w, 1] = 0.0
        else:
            fmask[w] = 0.0
    return torch.from_numpy(h).to(device), torch.from_numpy(fmask).to(device)


def phase_fit_kernels(seed: int, device) -> dict:
    """Each fit kernel against its plain version at every shape; returns
    the largest absolute differences seen."""
    from sml_tpu_torch.native import hist_kernel as hk
    worst = {"hist_accumulate": 0.0, "split_scan": 0.0}
    for i, (name, n, n_feat, n_bins, dtype, slots) in enumerate(HIST_SHAPES):
        for n_slots in slots:
            rng = np.random.default_rng([seed, 21, i, n_slots])
            b, lid, g, h, w = hist_operands(rng, n, n_bins, dtype, n_slots,
                                            device, n_feat)
            got = hk.hist_accumulate(b, lid, g, h, w, n_bins=n_bins,
                                     n_slots=n_slots)
            again = hk.hist_accumulate(b, lid, g, h, w, n_bins=n_bins,
                                       n_slots=n_slots)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"hist_accumulate {name} S={n_slots}: "
                                     f"two launches differ")
            want = hk.hist_accumulate_plain(b, lid, g, h, w, n_bins, n_slots)
            scale = hk.hist_accumulate_plain(b, lid, g.abs(), h.abs(), w,
                                             n_bins, n_slots)
            err = (got - want).abs()
            if not bool((err <= HIST_RTOL * scale + 1e-30).all()):
                raise AssertionError(f"hist_accumulate {name} S={n_slots}: "
                                     f"max abs err {float(err.max())}")
            if not torch.equal(got[:, 2::3], want[:, 2::3]):
                raise AssertionError(f"hist_accumulate {name} S={n_slots}: "
                                     f"weight sums differ")
            differ = int((got != want).sum())
            plan = hk.hist_plan(n, n_feat, n_bins, n_slots,
                                bin_bytes=b.element_size())
            print(f"kernel-vs-plain  hist_accumulate  {name:<12} "
                  f"rows={n} F={n_feat} bins={n_bins} S={n_slots:<2} "
                  f"dtype={b.dtype} {plan} "
                  f"max_abs_err={float(err.max()):.3e} cells_differing="
                  f"{differ}/{got.numel()}  deterministic  ok")
            worst["hist_accumulate"] = max(worst["hist_accumulate"],
                                           float(err.max()))
    for i, (name, n_bins, widths) in enumerate(SCAN_SHAPES):
        for width in widths:
            err = 0.0
            for lam, gamma, mi in ((1.0, 0.0, 1.0), (0.0, 0.25, 3.0)):
                rng = np.random.default_rng([seed, 22, i, width, int(mi)])
                hist, fmask = dyadic_hist(rng, n_bins, width, device)
                mi_t = torch.full((1, 1), mi, device=device)
                got = hk.split_scan(hist, fmask, mi_t, reg_lambda=lam,
                                    gamma=gamma)
                torch.cuda.synchronize()
                want = hk.split_scan_plain(hist, fmask, mi_t, lam, gamma)
                np.testing.assert_array_equal(
                    got.cpu().numpy(), want.cpu().numpy(),
                    err_msg=f"split_scan {name} W={width} lam={lam}")
                err = max(err, pack_err(got, want))
            worst["split_scan"] = max(worst["split_scan"], err)
            print(f"kernel-vs-plain  split_scan  {name:<28} bins={n_bins} "
                  f"W={width:<2} max_abs_err={err:.3e} exact (ties, masked, "
                  f"NaN nodes)  ok")
    return worst


def pack_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over a pack: 0 where the two are equal or
    both NaN (the overflow nodes' gains), inf where only one is NaN."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    d = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def _rmse(pred, label) -> float:
    d = np.asarray(pred, np.float64) - np.asarray(label, np.float64)
    return float(np.sqrt(np.mean(d * d)))


class KernelWatch:
    """Counts the plain versions' calls on CUDA tensors while it is
    installed, and optionally times every wrapper call with CUDA events."""

    def __init__(self, timed: bool = False):
        from sml_tpu_torch.native import hist_kernel as hk
        self.hk = hk
        self.timed = timed
        self.plain_on_cuda = 0
        self.events = {"hist_accumulate": [], "split_scan": []}
        self.saved = {}

    def __enter__(self):
        hk = self.hk
        for name in ("hist_accumulate_plain", "split_scan_plain"):
            fn = getattr(hk, name)
            self.saved[name] = fn

            def watched(*args, _fn=fn, **kw):
                if args[0].device.type == "cuda":
                    self.plain_on_cuda += 1
                return _fn(*args, **kw)
            setattr(hk, name, watched)
        if self.timed:
            for name in ("hist_accumulate", "split_scan"):
                fn = getattr(hk, name)
                self.saved[name] = fn

                def timed_call(*args, _fn=fn, _name=name, **kw):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = _fn(*args, **kw)
                    b.record()
                    self.events[_name].append((a, b))
                    return out
                setattr(hk, name, timed_call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.hk, name, fn)

    def kernel_ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


def _fit_xgb(X, logy, cats, device):
    """The ML 11 fit of the course: XGBoost on log price."""
    from sml_tpu_torch.xgboost import XgboostRegressor
    return XgboostRegressor(n_estimators=40, learning_rate=0.15, max_depth=6,
                            max_bins=64, random_state=42).fit(
        X, logy, categorical=cats, device=device)


def _fit_dt(X, logy, cats, device):
    """The ML 06 fit of the course: a decision tree on price."""
    from sml_tpu_torch.ml._tree_models import DecisionTreeRegressor
    return DecisionTreeRegressor(maxDepth=5, maxBins=40).fit(
        X, np.exp(logy), categorical=cats, device=device)


def _held_out(xgb, dt, X, logy, device) -> tuple:
    """Held-out rmse of both models on price, through the scorer."""
    from sml_tpu_torch.ml.inference import DeviceScorer
    price = np.exp(logy)
    r_xgb = _rmse(np.exp(DeviceScorer(xgb, device=device).score_block(X)),
                  price)
    r_dt = _rmse(DeviceScorer(dt, device=device).score_block(X), price)
    return r_xgb, r_dt


def phase_fit(seed: int, device) -> dict:
    """The fit slice's main path through the estimators, with every
    kernel's launches counted; the course ordering; and agreement of the
    card with the CPU at 16,000 rows."""
    from sml_tpu_torch.native import hist_kernel as hk
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.utils.profiler import PROFILER
    cats = {0: 36, 1: 3, 2: 20}
    rng = np.random.default_rng([seed, 31])
    X, _ = ml11_rows(rng, 100_000, cats)
    logy = fit_labels(rng, X)
    Xtr, ytr, Xte, yte = X[:80_000], logy[:80_000], X[80_000:], logy[80_000:]

    launches, walls, models = {}, {}, {}
    with KernelWatch() as watch:
        tk.LAUNCHES = 0
        PROFILER.reset()
        for name, fit in (("xgb", _fit_xgb), ("dt", _fit_dt)):
            for k in hk.LAUNCHES:
                hk.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            models[name] = fit(Xtr, ytr, cats, None)
            walls[name] = time.perf_counter() - t0
            launches[name] = dict(hk.LAUNCHES)
        xgb, dt = models["xgb"], models["dt"]
        r_xgb, r_dt = _held_out(xgb, dt, Xte, yte, None)
        traverse = tk.LAUNCHES
    dispatches = PROFILER.counters().get("tree.fit_dispatch", 0.0)
    base = _rmse(np.full(len(yte), np.exp(ytr).mean()), np.exp(yte))
    print(f"main-path fit  XgboostRegressor 80000 rows: "
          f"{walls['xgb'] * 1e3!r} ms, launches {launches['xgb']}; "
          f"DecisionTreeRegressor: {walls['dt'] * 1e3!r} ms, launches "
          f"{launches['dt']}; tree.fit_dispatch="
          f"{dispatches!r}; forest_traverse launches={traverse} (host clock, "
          f"first fits: binning, staging and copies included)")
    print(f"main-path fit  held-out rmse (price, 20000 rows): xgb={r_xgb!r} "
          f"dt={r_dt!r} mean-label baseline={base!r}")
    want = {"xgb": 40 * 6, "dt": 5}
    for model, n in want.items():
        for k, got in launches[model].items():
            if got != n:
                raise AssertionError(f"{model} fit launched {k} {got} "
                                     f"times, not {n}")
    if watch.plain_on_cuda:
        raise AssertionError(f"the plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    if dispatches != 2 or traverse <= 0:
        raise AssertionError(f"{dispatches} fit dispatches, {traverse} "
                             f"traversal launches")
    if xgb.getNumTrees() != 40 or dt.getNumTrees() != 1:
        raise AssertionError("wrong tree counts")
    if not r_xgb < r_dt < base:
        raise AssertionError(f"course ordering broken: xgb {r_xgb}, dt "
                             f"{r_dt}, baseline {base}")

    # the same fits on 16,000 rows, on the card and with the plain
    # versions on the CPU
    small = slice(0, 16_000)
    card = [fit(Xtr[small], ytr[small], cats, None)
            for fit in (_fit_xgb, _fit_dt)]
    host = [fit(Xtr[small], ytr[small], cats, "cpu")
            for fit in (_fit_xgb, _fit_dt)]
    r_card = _held_out(*card, Xte, yte, None)
    r_host = _held_out(*host, Xte, yte, "cpu")
    same = sum(np.array_equal(a.split_feature, b.split_feature)
               and np.array_equal(a.split_bin, b.split_bin)
               for a, b in zip(card[0]._spec.trees + card[1]._spec.trees,
                               host[0]._spec.trees + host[1]._spec.trees))
    print(f"fit card-vs-cpu 16000 rows: rmse xgb {r_card[0]!r} vs "
          f"{r_host[0]!r}, dt {r_card[1]!r} vs {r_host[1]!r}; {same} of 41 "
          f"trees with identical split tables")
    for a, b in zip(r_card, r_host):
        if abs(a - b) > max(RMSE_ATOL, RMSE_RTOL * abs(b)):
            raise AssertionError(f"card rmse {a} vs cpu rmse {b}")
    return {"launches": {k: launches["xgb"][k] + launches["dt"][k]
                         for k in hk.LAUNCHES}}


def hist_bound_ms(binned, weight, n_bins: int, n_slots: int):
    """(ms, by): the bytes `hist_accumulate` must move (bins, slot ids
    and three f32 per row read once; the (F*B, S*3) f32 histogram
    written once) over HBM bandwidth, against its operations (per row
    with w > 0: two products and 3 adds for each of its F cells) over
    the f32 rate. The sums run in float64, whose rate is not among the
    published peaks above; they are counted at the f32 rate."""
    n, n_feat = binned.shape
    nbytes = n * (n_feat * binned.element_size() + 16) \
        + n_feat * n_bins * n_slots * 12
    ops = int((weight > 0).sum()) * (2 + 3 * n_feat)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound_ms(hist):
    """(ms, by): the (F, B, W, 3) histogram, the (W, F) mask and the
    scalar read once and the (6, W) pack written once, against ~16 f32
    operations per (node, feature, bin) candidate (3 prefix adds, 2
    squares, 2 divisions, 7 adds and subtractions, 2 compares)."""
    n_feat, n_bins, width = hist.shape[:3]
    nbytes = hist.numel() * 4 + width * n_feat * 4 + 4 + 6 * width * 4
    ops = 16 * n_feat * n_bins * width
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: ML 11's tree levels: slots histogrammed (with subtraction) and nodes
#: scanned at each of its 6 levels, and its 40 trees
FIT_LEVEL_SLOTS = (1, 1, 2, 4, 8, 16)
FIT_LEVEL_NODES = (1, 2, 4, 8, 16, 32)
FIT_TREES = 40
#: the kernels each wrapper launches, by name in the profiler
HIST_KERNELS = ("hist_cluster_kernel", "hist_reduce_kernel")
SCAN_KERNELS = ("split_scan_kernel",)


def hist_launches(n: int, n_bins: int, n_slots: int, **kw) -> int:
    """Kernels one `hist_accumulate` call launches: the cluster pass, and
    the pass over the clusters' partials when there is more than one."""
    from sml_tpu_torch.native import hist_kernel as hk
    p = hk.hist_plan(n, N_FEAT, n_bins, n_slots, **kw)
    return 1 + int(p.n_chunks // p.cluster > 1)


def hist_f32acc_launcher():
    """A call of the f32-accumulating build of the `hist_accumulate`
    kernel (entry point `sml_hist_accumulate_f32acc` of the same source),
    launched as the port's wrapper launches the float64 one, with its own
    plan: 12-byte cells, so a tile holds up to twice the features. The
    port never calls it; it is timed beside the float64 kernel to price
    the float64 sums."""
    import ctypes
    from sml_tpu_torch.native import build
    from sml_tpu_torch.native import hist_kernel as hk
    fn = build.load("hist_accumulate").sml_hist_accumulate_f32acc
    fn.argtypes = hk.HIST_ARGTYPES
    fn.restype = ctypes.c_int

    def launch(binned, lid, grad, hess, weight, n_bins, n_slots):
        n, n_feat = binned.shape
        plan = hk.hist_plan(n, n_feat, n_bins, n_slots,
                            bin_bytes=binned.element_size(), acc_bytes=4)
        return hk.launch_hist(fn, plan, binned, lid, grad, hess, weight,
                              n_bins, n_slots, torch.float32)
    return launch


def wrapper_host_us(device) -> dict:
    """Median host time of one call of each fit wrapper, in microseconds
    (`host_us`): `hist_accumulate` at ML 11, S=16, and `split_scan` at
    ML 11, W=32. The launch counts are restored after."""
    from sml_tpu_torch.native import hist_kernel as hk
    saved = dict(hk.LAUNCHES)
    rng = np.random.default_rng([0, 43])
    b, lid, g, h, w = hist_operands(rng, 80_000, 64, np.uint8, 16, device)
    hist = torch.rand((N_FEAT, 64, 32, 3), device=device)
    fmask = torch.ones((32, N_FEAT), device=device)
    mi = torch.ones((1, 1), device=device)
    out = {"hist_accumulate": host_us(lambda: hk.hist_accumulate(
               b, lid, g, h, w, n_bins=64, n_slots=16)),
           "split_scan": host_us(lambda: hk.split_scan(
               hist, fmask, mi, reg_lambda=1.0, gamma=0.0))}
    hk.LAUNCHES.update(saved)
    return out


def phase_fit_times(seed: int, device, card: str) -> dict:
    """Kernel, plain, bound and library times of the fit kernels at every
    shape the ML 11 fit launches them at (`hist_accumulate` at 1-16
    slots, and 32; `split_scan` at 1-32 nodes); the per-fit kernel device
    time these give; the wrappers' host time per call. Beside the float64
    `hist_accumulate` at S=16 and 32, times its f32-accumulating build and
    counts the cells where each differs from the plain version on the CPU
    (what a CPU fit computes). Returns the numbers of the kernels line."""
    from sml_tpu_torch.native import hist_kernel as hk
    saved = dict(hk.LAUNCHES)
    f32acc = hist_f32acc_launcher()
    out = {}
    for n_slots in (1, 2, 4, 8, 16, 32):
        rng = np.random.default_rng([seed, 41, n_slots])
        b, lid, g, h, w = hist_operands(rng, 80_000, 64, np.uint8, n_slots,
                                        device)

        def call():
            return hk.hist_accumulate(b, lid, g, h, w, n_bins=64,
                                      n_slots=n_slots)
        k_ms = time_ms(call, 50)
        d_ms = device_ms(call, 50, HIST_KERNELS,
                         hist_launches(80_000, 64, n_slots))
        p_ms = time_ms(lambda: hk.hist_accumulate_plain(
            b, lid, g, h, w, 64, n_slots), 5)
        # the library yardstick: one index_add_ of the (row, feature)
        # contributions on precomputed flat cell indices
        ok = (w > 0)[:, None].expand(-1, N_FEAT)
        cell = ((torch.arange(N_FEAT, device=device)[None, :] * 64
                 + b.to(torch.int64)) * n_slots + lid.to(torch.int64)[:, None])
        src = torch.stack([g * w, h * w, w], 1)[:, None, :] \
            .expand(-1, N_FEAT, 3)[ok].contiguous()
        idx = cell[ok].contiguous()
        acc = torch.zeros((N_FEAT * 64 * n_slots, 3), device=device)
        l_ms = time_ms(lambda: acc.index_add_(0, idx, src), 50)
        b_ms, b_by = hist_bound_ms(b, w, 64, n_slots)
        print(f"time  hist_accumulate  ML 11 80000 rows F=10 B=64 uint8 "
              f"S={n_slots} {hk.hist_plan(80_000, N_FEAT, 64, n_slots)}: "
              f"kernel {k_ms!r} ms (device {fmt_ms(d_ms)} ms), plain "
              f"{p_ms!r} ms, index_add_ {l_ms!r} ms, bound {b_ms!r} ms "
              f"({b_by}); card {card}")
        out[("hist_accumulate", n_slots)] = (k_ms, d_ms, p_ms, b_ms, b_by,
                                             l_ms)
        if n_slots < 16:
            continue
        f_ms = time_ms(lambda: f32acc(b, lid, g, h, w, 64, n_slots), 50)
        fd_ms = device_ms(lambda: f32acc(b, lid, g, h, w, 64, n_slots), 50,
                          HIST_KERNELS, hist_launches(80_000, 64, n_slots,
                                                      acc_bytes=4))
        cpu = hk.hist_accumulate_plain(b.cpu(), lid.cpu(), g.cpu(), h.cpu(),
                                       w.cpu(), 64, n_slots)
        got64 = call().cpu()
        got32 = f32acc(b, lid, g, h, w, 64, n_slots).cpu()
        scale = hk.hist_accumulate_plain(b.cpu(), lid.cpu(), g.cpu().abs(),
                                         h.cpu().abs(), w.cpu(), 64, n_slots)
        if not bool(((got32 - cpu).abs() <= HIST_RTOL * scale + 1e-30)
                    .all()):
            raise AssertionError(f"f32-accumulating hist_accumulate S="
                                 f"{n_slots} disagrees with the plain "
                                 f"version")
        d64, d32 = int((got64 != cpu).sum()), int((got32 != cpu).sum())
        print(f"time  hist_accumulate f32-accumulating build  ML 11 80000 "
              f"rows S={n_slots} "
              f"{hk.hist_plan(80_000, N_FEAT, 64, n_slots, acc_bytes=4)}: "
              f"kernel {f_ms!r} ms (device {fmt_ms(fd_ms)} ms) against "
              f"float64 {k_ms!r} ms (device {fmt_ms(d_ms)} ms); cells "
              f"differing from the CPU plain version: float64 {d64}, f32 "
              f"{d32} of {cpu.numel()}; card {card}")
        out[("hist_f32acc", n_slots)] = (f_ms, fd_ms, d64, d32)
    for width in FIT_LEVEL_NODES:
        rng = np.random.default_rng([seed, 42, width])
        hist = torch.from_numpy(rng.normal(
            size=(N_FEAT, 64, width, 3)).astype(np.float32)).to(device)
        hist[..., 1:] = hist[..., 1:].abs()
        fmask = torch.ones((width, N_FEAT), device=device)
        mi = torch.ones((1, 1), device=device)

        def scan():
            return hk.split_scan(hist, fmask, mi, reg_lambda=1.0, gamma=0.0)
        k_ms = time_ms(scan, 50)
        d_ms = device_ms(scan, 50, SCAN_KERNELS)
        p_ms = time_ms(lambda: hk.split_scan_plain(hist, fmask, mi, 1.0,
                                                   0.0), 5)
        b_ms, b_by = scan_bound_ms(hist)
        print(f"time  split_scan  ML 11 F=10 B=64 W={width} "
              f"{hk.scan_plan(N_FEAT, 64)}: kernel {k_ms!r} ms (device "
              f"{fmt_ms(d_ms)} ms), plain {p_ms!r} ms, bound {b_ms!r} ms "
              f"({b_by}); card {card}")
        out[("split_scan", width)] = (k_ms, d_ms, p_ms, b_ms, b_by, None)
    per_fit = {}
    for name, levels in (("hist_accumulate", FIT_LEVEL_SLOTS),
                         ("split_scan", FIT_LEVEL_NODES)):
        ds = [out[(name, k)][1] for k in levels]
        per_fit[name] = None if None in ds else FIT_TREES * sum(ds)
    out["per_fit"] = per_fit
    print(f"time  per-fit kernel device time, ML 11 (40 trees x levels at "
          f"S={FIT_LEVEL_SLOTS} and W={FIT_LEVEL_NODES}, named-kernel "
          f"profiler time at each shape): hist_accumulate "
          f"{fmt_ms(per_fit['hist_accumulate'])} ms, split_scan "
          f"{fmt_ms(per_fit['split_scan'])} ms; card {card}")
    hk.LAUNCHES.update(saved)  # timing launches are not the main path's
    host = wrapper_host_us(device)
    out["host_us"] = host
    print(f"time  wrapper host time per call (perf_counter median, no "
          f"synchronise): hist_accumulate ML 11 S=16 "
          f"{host['hist_accumulate']!r} us, split_scan ML 11 W=32 "
          f"{host['split_scan']!r} us; card {card}")
    return out


def phase_fit_breakdown(seed: int, card: str, per_fit: dict) -> None:
    """Where one ML 11 XGBoost fit on fresh rows spends its time: host
    binning, staging, the fit loop (its kernels' device time by CUDA
    events around each launch, and the rest: Python glue and small torch
    ops), host clock. Then the same fit under `torch.profiler`: the
    card's busy time over the fit loop's wall time."""
    from sml_tpu_torch.native import hist_kernel as hk
    from sml_tpu_torch.utils.profiler import PROFILER
    from sml_tpu_torch.xgboost import XgboostRegressor
    saved = dict(hk.LAUNCHES)
    cats = {0: 36, 1: 3, 2: 20}
    rng = np.random.default_rng([seed, 51])
    X, _ = ml11_rows(rng, 80_000, cats)
    logy = fit_labels(rng, X)

    def fit():
        return XgboostRegressor(n_estimators=40, learning_rate=0.15,
                                max_depth=6, max_bins=64).fit(
            X, logy, categorical=cats)

    PROFILER.reset()
    PROFILER.enabled = True
    try:
        with KernelWatch(timed=True) as watch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit()
            wall = time.perf_counter() - t0
            kms = watch.kernel_ms()
        spans = {}
        for sp in PROFILER.spans():
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.wall_s * 1e3
    finally:
        PROFILER.enabled = False
    prog = spans.get("program.tree_ensemble", 0.0)
    kern = kms["hist_accumulate"] + kms["split_scan"]
    print(f"breakdown  XgboostRegressor ML 11 80000 rows, fresh rows: "
          f"whole fit {wall * 1e3!r} ms; binning.fit "
          f"{spans.get('binning.fit', 0.0)!r} ms; staging.fit "
          f"{spans.get('staging.fit', 0.0)!r} ms; fit loop {prog!r} ms, of "
          f"which kernel time by events {kern!r} ms (hist_accumulate "
          f"{kms['hist_accumulate']!r}, split_scan {kms['split_scan']!r}) "
          f"and the rest {prog - kern!r} ms (host clock); card {card}")

    from torch.profiler import ProfilerActivity, profile
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fit()
            torch.cuda.synchronize()
        prog = sum(sp.wall_s for sp in PROFILER.spans()
                   if sp.name == "program.tree_ensemble") * 1e3
    finally:
        PROFILER.enabled = False
    busy = {}
    for ev in prof.key_averages():
        t = float(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))) / 1e3
        if t > 0:
            busy[ev.key] = busy.get(ev.key, 0.0) + t
    total = sum(busy.values())
    if total <= 0:
        print("breakdown  torch.profiler saw no device time: busy share "
              "not measured")
    else:
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        print(f"breakdown  torch.profiler over one fit: device busy "
              f"{total!r} ms over a fit loop of {prog!r} ms (busy share "
              f"{total / prog!r}, profiler on); top kernels "
              + "; ".join(f"{k[:60]} {v!r} ms" for k, v in top))
        for name, kern in (("hist_accumulate", HIST_KERNELS),
                           ("split_scan", SCAN_KERNELS)):
            whole = sum(v for k, v in busy.items()
                        if any(nm in k for nm in kern))
            print(f"breakdown  {name} device time over one ML 11 fit: "
                  f"{whole!r} ms by the profiler over the fit, against "
                  f"{fmt_ms(per_fit[name])} ms summed from the per-shape "
                  f"times (40 trees x levels); card {card}")
    hk.LAUNCHES.update(saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from sml_tpu_torch.native import build
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.build(build.kernel_sources())
    print(f"build: {build.kernel_sources()} in "
          f"{time.perf_counter() - t0:.1f} s")

    err = phase_kernels(args.seed, device)
    main_path = phase_main_path(args.seed, device)
    times = phase_times(args.seed, device, card)
    phase_breakdown(args.seed, device, card)
    fit_err = phase_fit_kernels(args.seed, device)
    fit = phase_fit(args.seed, device)
    fit_times = phase_fit_times(args.seed, device, card)
    phase_fit_breakdown(args.seed, card, fit_times["per_fit"])

    k_ms, d_ms, p_ms, b_ms, b_by = times[100_000]
    kernels = [{
        "name": "forest_traverse", "route": "cuda",
        "source": "sml_tpu_torch/csrc/forest_traverse.cu",
        "replaces": "sml_tpu/native/traverse_kernel.py:109",
        "launches": main_path["launches"],
        "launches_by_rows": main_path["launches_by_rows"],
        "max_abs_err": err,
        "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "shape": "ML 11: T=40 depth=6 F=10 uint8, 100000 rows",
        "by_rows": {str(n): dict(zip(("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by"), times[n]))
                    for n in TIME_ROWS}}]
    k_ms, d_ms, p_ms, b_ms, b_by, l_ms = fit_times[("hist_accumulate", 16)]
    kernels.append({
        "name": "hist_accumulate", "route": "cuda",
        "source": "sml_tpu_torch/csrc/hist_accumulate.cu",
        "replaces": "sml_tpu/native/hist_kernel.py:128",
        "launches": fit["launches"]["hist_accumulate"],
        "max_abs_err": fit_err["hist_accumulate"], "ms": k_ms,
        "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": l_ms, "deterministic": True,
        "f32_acc_ms": fit_times[("hist_f32acc", 16)][0],
        "f32_acc_device_ms": fit_times[("hist_f32acc", 16)][1],
        "cells_off_cpu_f64": fit_times[("hist_f32acc", 16)][2],
        "cells_off_cpu_f32": fit_times[("hist_f32acc", 16)][3],
        "per_fit_device_ms": fit_times["per_fit"]["hist_accumulate"],
        "host_us": fit_times["host_us"]["hist_accumulate"],
        "shape": "ML 11: 80000 rows F=10 B=64 uint8, S=16"})
    k_ms, d_ms, p_ms, b_ms, b_by, _ = fit_times[("split_scan", 32)]
    kernels.append({
        "name": "split_scan", "route": "cuda",
        "source": "sml_tpu_torch/csrc/split_scan.cu",
        "replaces": "sml_tpu/native/hist_kernel.py:202",
        "launches": fit["launches"]["split_scan"],
        "max_abs_err": fit_err["split_scan"], "ms": k_ms, "device_ms": d_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "per_fit_device_ms": fit_times["per_fit"]["split_scan"],
        "host_us": fit_times["host_us"]["split_scan"],
        "shape": "ML 11: F=10 B=64 W=32"})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
