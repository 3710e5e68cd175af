"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. It needs a CUDA card and `nvcc` (it builds
every kernel under `sml_tpu_torch/csrc/` at first use) and exits non-zero
without printing a result when either is missing or any phase fails.

Phases:
1. device: the card's name and power limit (from nvidia-smi);
2. build: every kernel source, with one nvcc process each, in parallel;
3. kernels: `forest_traverse` against its plain PyTorch version on the
   card, on seeded random ensembles with early leaves, at the widths of
   the tree models the repository fits (ML 11 XGBoost, ML 07 random
   forest, ML 06 decision tree, a uint16 and an int32 bin matrix), at
   4,096 and 100,000 rows;
4. main path: an ML 11-shaped model (40 trees, depth 6, 10 features, 64
   bins) built through the port's loader, scored through
   `DeviceScorer.score_block` (100,000 rows), evaluated through the fused
   `forest_eval_fn` (exp link, 20,000 labelled rows) and served through
   `MicroBatcher` (96 concurrent requests of 1-64 rows), with the
   kernel's launch count read around it;
5. times: the kernel, its plain version and its bound at the ML 11
   shape, beside the card's name and power limit;
6. breakdown: where one `score_block` call spends its time (binning,
   staging, kernel, copy back), at 4,096 and 100,000 rows.

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

#: the tolerance of kernel against plain: the leaf choice is exact and
#: only the f32 sum over trees may be ordered differently
RTOL = 1e-5


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


def shape_operands(rng, shape, n_rows: int, device):
    _, T, depth, n_bins, dtype, wkind = shape
    sf, sb, lv = random_tables(rng, T, depth, n_bins, N_FEAT)
    w = np.full(T, 0.15 if wkind == "step" else 1.0 / T, np.float32)
    binned = rng.integers(0, n_bins, size=(n_rows, N_FEAT)).astype(dtype)
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
            xb = x.gather(1, f.clamp(min=0)[:, None])[:, 0]
            child = 2 * node + 1 + (xb > sb[t].to(torch.int64)[node]).long()
            node = torch.where(internal, child, node)
    return total


def bound_ms(binned, sf, sb, depth: int):
    """(ms, "bytes" or "operations"): the larger of the bytes the call
    must move over HBM bandwidth (bins read once, tables and weights
    read once, margins written once) and its operations over the f32
    rate outside the tensor cores (per node visit a compare and the
    child index, 3; per row and tree the weighted add, 2). The guide's
    table lists no integer rate, so integer work is counted at the f32
    rate."""
    n, n_feat = binned.shape
    T, N = sf.shape
    nbytes = n * n_feat * binned.element_size() + 12 * T * N + 4 * T + 4 * n
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
    """Kernel against plain at every shape and row count; returns the
    largest absolute difference seen."""
    from sml_tpu_torch.native import traverse_kernel as tk
    worst = 0.0
    for i, shape in enumerate(SHAPES):
        for n_rows in (4096, 100_000):
            rng = np.random.default_rng([seed, i, n_rows])
            ops = shape_operands(rng, shape, n_rows, device)
            binned, sf, sb, lv, w, depth = ops
            got = tk.forest_traverse(binned, sf, sb, lv, w, depth=depth)
            torch.cuda.synchronize()
            want = tk.forest_margin_plain(binned, sf, sb, lv, w, depth)
            err = assert_close(got.cpu().numpy(), want.cpu().numpy(),
                               f"forest_traverse {shape[0]} x {n_rows}")
            print(f"kernel-vs-plain  forest_traverse  {shape[0]:<14} "
                  f"rows={n_rows:<7} dtype={binned.dtype} "
                  f"max_abs_err={err:.3e}  ok")
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


def phase_main_path(seed: int, device) -> dict:
    """Score, evaluate and serve through the port's entry points; return
    the launch count of the run."""
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

    tk.forest_margin_plain = watched_plain
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

    # agreement with the plain version on the host, on a small input
    cpu = DeviceScorer(model, device="cpu").score_block(X[:2000])
    assert_close(pred[:2000], cpu, "score_block cuda vs cpu")
    return {"launches": launches}


def phase_times(seed: int, device, card: str) -> dict:
    """Kernel, plain and bound at the ML 11 shape, 4096 and 100000 rows.
    Returns the 100000-row numbers for the kernels line."""
    from sml_tpu_torch.native import traverse_kernel as tk
    out = {}
    for n_rows in (4096, 100_000):
        rng = np.random.default_rng([seed, 0, n_rows])
        binned, sf, sb, lv, w, depth = shape_operands(rng, SHAPES[0],
                                                      n_rows, device)
        launches = tk.LAUNCHES
        k_ms = time_ms(lambda: tk.forest_traverse(binned, sf, sb, lv, w,
                                                  depth=depth), 50)
        p_ms = time_ms(lambda: tk.forest_margin_plain(binned, sf, sb, lv,
                                                      w, depth), 5)
        tk.LAUNCHES = launches  # timing launches are not the main path's
        b_ms, b_by = bound_ms(binned, sf, sb, depth)
        print(f"time  forest_traverse  ML 11 T=40 depth=6 F=10 uint8 "
              f"rows={n_rows}: kernel {k_ms!r} ms, plain {p_ms!r} ms, "
              f"bound {b_ms!r} ms ({b_by}); card {card}")
        out[n_rows] = (k_ms, p_ms, b_ms, b_by)
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

    k_ms, p_ms, b_ms, b_by = times[100_000]
    kernels = [{
        "name": "forest_traverse", "route": "cuda",
        "source": "sml_tpu_torch/csrc/forest_traverse.cu",
        "replaces": "sml_tpu/native/traverse_kernel.py:109",
        "launches": main_path["launches"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": "ML 11: T=40 depth=6 F=10 uint8, 100000 rows"}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
