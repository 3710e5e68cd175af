"""Data-parallel tree fits over a mesh of ranks, on the CPU.

Each layout is one launch of gloo ranks (subprocesses, each with its own
timeout; `initialize_multihost` on a `file://` store, `device="cpu"`),
made once by a module-scoped fixture: 1 rank (a default group of world
size 1, so the collective path runs with nothing to add), 2 ranks, and
4 ranks, which fit flat and then as 2 host groups
(`sml.mesh.hostGroups=2`, `sml.tree.hierarchicalAllreduce=auto`). Every
rank fits the estimators of `tests/test_multichip.py:121-146` (a
decision tree, a random forest with a 0.9 Poisson bootstrap, XGBoost
with a 0.8 subsample) and a logistic GBT on that file's `xy` (4,096 x 6,
seed 11) and writes its trees to an .npz.

- Every rank of every layout holds the trees of the port's own fit
  outside any mesh: split tables equal and leaf values, gains, covers
  and bases bit-equal. Each rank histograms its own rows in float64,
  the ranks' sums are all-reduced in float64 and rounded to f32 once,
  so an N-rank sum differs from the 1-rank sum only in the order of its
  float64 adds; rounding to f32 hides that unless a sum lies within its
  float64 error (~1e-16 of it) of an f32 rounding boundary, which these
  inputs do not hit. (The JAX package psums f32 partials, so its own
  8-device xgb fit flips near-tied splits: a known failure.)
- Predictions equal the JAX package's one-device fit within
  `test_multichip`'s rtol/atol 1e-4 for the tree and the forest, and
  within the port's tolerance for boosted fits against it
  (`tests/test_torch_fit.py`: rtol 1e-4 plus 1e-4 of the largest
  margin): the port's float64 sums against the JAX package's f32.
- A rank's sliced row weights (`tree_impl.round_weights(..., rows=)`),
  joined over the ranks, are the one-rank draws bit for bit.
- `collective.psum_bytes` of a fit is the histograms' float64 payload,
  summed over its levels (F x B x S x 3 x 8 bytes, S the level's left
  slots), plus each tree's leaf statistics (2^D x 3 x 8) and the base's
  16; on the host mesh the same payload goes to the "ici" hop and half
  of it to the "dcn" hop.
- Ranks given different X raise on every rank; `sml.dispatch.mode=host`
  (asked for a stub card) and placed trials in threads raise under a
  mesh of several ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sml_tpu_torch.ml import tree_impl as pti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240
torch.set_num_threads(2)


def _xy():
    rng = np.random.default_rng(11)
    n = 4096
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] * 3 - X[:, 1] ** 2 + 0.5 * X[:, 2]
         + rng.normal(0, 0.2, n)).astype(np.float32)
    return X, y


#: name -> (estimator class, its params, whether its label is binary)
ESTIMATORS = {
    "dt": ("DecisionTreeRegressor", dict(maxDepth=5, maxBins=16), False),
    "rf": ("RandomForestRegressor", dict(maxDepth=4, numTrees=8, maxBins=16,
                                         subsamplingRate=0.9, seed=7), False),
    "xgb": ("XgboostRegressor", dict(n_estimators=8, max_depth=4,
                                     max_bins=16, learning_rate=0.3,
                                     subsample=0.8, random_state=5), False),
    "gbt": ("GBTClassifier", dict(maxIter=6, maxDepth=3, maxBins=16,
                                  stepSize=0.3, seed=3), True),
}


def _classes() -> dict:
    from sml_tpu_torch.ml._tree_models import (DecisionTreeRegressor,
                                               GBTClassifier,
                                               RandomForestRegressor)
    from sml_tpu_torch.xgboost import XgboostRegressor
    return {c.__name__: c for c in (DecisionTreeRegressor, GBTClassifier,
                                    RandomForestRegressor, XgboostRegressor)}


def _estimator(name: str):
    cls, params, _ = ESTIMATORS[name]
    return _classes()[cls](**params)


def _label(name: str, y: np.ndarray) -> np.ndarray:
    return (y > np.median(y)).astype(np.float32) if ESTIMATORS[name][2] \
        else y


FIELDS = ("split_feature", "split_bin", "leaf_value", "gain", "cover")

WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
from test_torch_multirank import ESTIMATORS, FIELDS, _estimator, _label
torch.set_num_threads(1)
from sml_tpu_torch import GLOBAL_CONF
from sml_tpu_torch.ml import tree_impl
from sml_tpu_torch.ml._tree_models import DecisionTreeRegressor
from sml_tpu_torch.parallel import collectives as coll, mesh as M
from sml_tpu_torch.utils import prng

rank, store, out, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                       int(sys.argv[4]))
if n == 1:   # a default group of one rank: the mesh path, nothing to add
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=1, rank=0)
    M.bind_rank_device("cpu")
else:
    assert coll.initialize_multihost("file://" + store, n, rank,
                                     backend="gloo", device="cpu",
                                     timeout_s=120)
data = np.load(sys.argv[5])
X, y = data["X"], data["y"]
layouts = ["flat"] + (["hosts"] if n == 4 else [])
res = {{}}
for layout in layouts:
    if layout == "hosts":
        GLOBAL_CONF.set("sml.mesh.hostGroups", 2)
        GLOBAL_CONF.set("sml.tree.hierarchicalAllreduce", "auto")
        M.set_mesh(M.host_mesh())
    for name in ESTIMATORS:
        coll.reset_counts()
        spec = _estimator(name).fit(X, _label(name, y), device="cpu")._spec
        key = layout + "_" + name
        for f in FIELDS:
            res[key + "_" + f] = np.stack([getattr(t, f)
                                           for t in spec.trees])
        res[key + "_base"] = np.asarray([spec.base], np.float32)
        res[key + "_pred"] = spec.predict_margin(X, device="cpu")
        for c in ("psum", "psum_bytes", "psum_bytes.ici",
                  "psum_bytes.dcn", "pmin", "pmax"):
            res[key + "_" + c] = np.asarray(
                [coll.COUNTS.get("collective." + c, 0.0)])
# the draws a sampled fit's rank keeps: a slice of the global draws
start, stop = M.row_range(len(y))
for mode, rate, seed in (("poisson", 0.9, 7), ("bernoulli", 0.8, 5)):
    draws = tree_impl.fit_draws(np.asarray([prng.prng_key(seed)]), 3, 2,
                                [mode], [rate], [len(y)], len(y),
                                torch.device("cpu"))
    w = tree_impl.round_weights(draws, 0, 3, len(y), slice(start, stop))
    res["draws_" + mode] = torch.stack([w[t] for t in range(3)]).numpy()
if n == 2:   # ranks given different rows raise, every one of them
    Xr = X.copy()
    if rank == 1:
        Xr[::7, 0] += 1.0
    try:
        DecisionTreeRegressor(maxDepth=2, maxBins=16).fit(Xr, y,
                                                          device="cpu")
        res["mismatch_raised"] = np.asarray([0])
    except ValueError as e:
        assert "different fit inputs" in str(e), e
        res["mismatch_raised"] = np.asarray([1])
    # the host route and placed trials in threads raise under the mesh
    from sml_tpu_torch import device as pdev
    from sml_tpu_torch.parallel import dispatch
    raised = []
    GLOBAL_CONF.set("sml.dispatch.mode", "host")
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True      # a stub card: routes only
    try:
        dispatch.device_for(None, torch.device("cuda", 0))
    except NotImplementedError as e:
        raised.append("ROADMAP item 10" in str(e))
    torch.cuda.is_available = real
    GLOBAL_CONF.set("sml.dispatch.mode", "auto")
    GLOBAL_CONF.set("sml.device", "cpu")
    try:
        pdev.run_placed_trials([1, 2], lambda j: j, 2)
    except NotImplementedError as e:
        raised.append("ROADMAP item 10" in str(e))
    res["guards_raised"] = np.asarray(raised)
np.savez(out, **res)
print("rank", rank, "ok")
"""


def _launch(tmp, n: int) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    script = WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    X, y = _xy()
    np.savez(tmp / "xy.npz", X=X, y=y)
    outs = [str(tmp / f"rank{r}.npz") for r in range(n)]
    store = str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), store, outs[r], str(n),
         str(tmp / "xy.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank count's ranks' results: {n: [rank 0's, rank 1's, ...]}."""
    return {n: _launch(tmp_path_factory.mktemp(f"ranks{n}"), n)
            for n in (1, 2, 4)}


@pytest.fixture(scope="module")
def reference():
    """The port's own fits outside any mesh, on the CPU."""
    X, y = _xy()
    out = {}
    for name in ESTIMATORS:
        est, label = _estimator(name), _label(name, y)
        out[name] = (est, label, est.fit(X, label, device="cpu")._spec)
    return out


LAYOUTS = [(1, "flat"), (2, "flat"), (4, "flat"), (4, "hosts")]


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
@pytest.mark.parametrize("n,layout", LAYOUTS)
def test_every_rank_fits_the_one_device_trees(runs, reference, n, layout,
                                              name):
    spec = reference[name][2]
    key = f"{layout}_{name}"
    for rank, res in enumerate(runs[n]):
        for f in FIELDS:
            want = np.stack([getattr(t, f) for t in spec.trees])
            np.testing.assert_array_equal(
                res[f"{key}_{f}"], want,
                err_msg=f"{f} of rank {rank} of {n} ({layout})")
        assert res[f"{key}_base"][0] == np.float32(spec.base)
        np.testing.assert_array_equal(res[f"{key}_pred"],
                                      spec.predict_margin(_xy()[0],
                                                          device="cpu"))


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_predictions_match_the_jax_one_device_fit(spark, runs, reference,
                                                  name):
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    from sml_tpu.parallel import mesh as jmesh
    est, label, _ = reference[name]
    X, _ = _xy()
    prev = JCONF.get("sml.tree.kernel")
    JCONF.set("sml.tree.kernel", "xla")
    try:
        with jmesh.use_mesh(jmesh.build_mesh(1)):
            sj = jfit(X, label, categorical={},
                      **est._fit_args(X.shape[1]))
    finally:
        JCONF.set("sml.tree.kernel", prev)
    want = sj.predict_margin(X)
    got = runs[4][0][f"hosts_{name}_pred"]
    if name in ("dt", "rf"):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["poisson", "bernoulli"])
def test_sliced_draws_are_the_one_rank_draws(runs, mode):
    from sml_tpu_torch.utils import prng
    rate, seed = {"poisson": (0.9, 7), "bernoulli": (0.8, 5)}[mode]
    n = len(_xy()[1])
    draws = pti.fit_draws(np.asarray([prng.prng_key(seed)]), 3, 2, [mode],
                          [rate], [n], n, torch.device("cpu"))
    w = pti.round_weights(draws, 0, 3, n)
    want = torch.stack([w[t] for t in range(3)]).numpy()
    for k, res in runs.items():
        got = np.concatenate([r[f"draws_{mode}"] for r in res], axis=1)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} ranks")
    assert len(np.unique(want)) > 1


def _payload(es_kw: dict, n_trees: int, F: int) -> tuple:
    """(histogram bytes, leaf bytes) of a fit: each level's left-child
    slots (1 at the root) x F x B x 3 float64 sums, and each tree's
    last-level statistics."""
    D, B = es_kw["max_depth"], es_kw["max_bins"]
    slots = [1] + [2 ** (L - 1) for L in range(1, D)]
    return (n_trees * sum(F * B * s * 3 * 8 for s in slots),
            n_trees * 2 ** D * 3 * 8)


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
@pytest.mark.parametrize("n,layout", LAYOUTS)
def test_psum_bytes_are_the_float64_histograms(runs, reference, n, layout,
                                               name):
    est, _, spec = reference[name]
    F = 6
    hist, leaf = _payload(est._fit_args(F), len(spec.trees), F)
    key = f"{layout}_{name}"
    D = est._fit_args(F)["max_depth"]
    for res in runs[n]:
        assert res[f"{key}_pmin"][0] == res[f"{key}_pmax"][0] == 1
        if layout == "flat":
            assert res[f"{key}_psum_bytes"][0] == hist + leaf + 16
            assert res[f"{key}_psum"][0] == len(spec.trees) * (D + 1) + 1
        else:   # the two-level merge: the full payload on "ici", half on
            #     "dcn"; the base's psum_scalars stays flat
            assert res[f"{key}_psum_bytes.ici"][0] == hist + leaf
            assert res[f"{key}_psum_bytes.dcn"][0] == (hist + leaf) / 2
            assert res[f"{key}_psum_bytes"][0] == 16


def test_ranks_given_different_rows_raise(runs):
    assert [int(r["mismatch_raised"][0]) for r in runs[2]] == [1, 1]


def test_host_route_and_placed_trials_raise_under_a_mesh(runs):
    """`sml.dispatch.mode=host` asked for a card, and placed trials in
    threads, raise under a mesh of 2 ranks, naming ROADMAP item 10."""
    for r in runs[2]:
        assert list(r["guards_raised"]) == [True, True]
