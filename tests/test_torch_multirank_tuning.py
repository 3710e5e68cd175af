"""Fused CV grids, trial lanes and placed trials over a mesh of ranks,
on the CPU.

Each rank count is one launch of gloo ranks (subprocesses, each with its
own timeout; `initialize_multihost` on a `file://` store,
`device="cpu"`), made once by a module-scoped fixture: 2 ranks and 4
ranks. Every rank works on `tests/test_multichip.py`'s `xy` (4,096 x 6,
seed 11) and writes what it got to an .npz.

- `fit_cv_grid` of the two RF grids of `tests/test_multichip.py:149-238`
  (maxBins 16; maxDepth {2, 4} x numTrees {3, 6} over 3 folds, and
  maxDepth {2, 3} x numTrees {2, 4} over 2 folds), grid-fused 6 elements
  a fit and fold-fused, rows split over 2 and 4 ranks, and on 4 ranks as
  trial lanes of width 2 and 4 and the auto width: every rank's split
  tables, leaves, gains, covers and bases are the port's own one-device
  fit's bit for bit. Each rank histograms its block of each element's
  rows in float64 and the sums are all-reduced before one rounding to
  f32 (`tests/test_torch_multirank.py`); a lane of one rank fits its
  elements whole, with no all-reduce, and one all-gather over the
  "trial" ranks shares the lanes' packs.
- The ML 07 CrossValidator on a DataFrame over the ranks (fused, and as
  placed trials at parallelism 2 with `sml.cv.batchFolds` off) gives the
  port's one-device `avgMetrics` exactly, and the JAX package's
  one-device run within `test_multichip`'s rtol/atol 1e-4.
- `_trial_axis_width` answers the JAX package's on every case of
  `tests/test_multichip.py:224-236` (on an 8-rank mesh description; the
  rule reads only the mesh's shape), and picks 4 lanes for the ML 07
  grid's 12 elements on 4 ranks.
- An explicit width that does not divide E pads the element axis by
  repeats of element 0 and returns exactly E (`:241-288`); an element of
  3 rows on 4 ranks leaves rank 3 none of its rows.
- `run_placed_trials` over 4 ranks at parallelism 2, 4 and 16 (cycled)
  runs each trial on a disjoint group of ranks (data-parallel inside
  it), logs every placement on every rank, returns results in job order,
  and re-raises a trial's exception on every rank with no hang, also
  one raised on a single rank of its group
  (`tests/test_trial_placement.py:19-60`, `:132-160`).
- `fmin` with `SparkTrials(parallelism=2)` over 4 ranks finds the one-rank
  best point and history.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240

#: (maxDepth values, numTrees values, folds, RF seed, CV seed)
GRIDS = {"g149": ((2, 4), (3, 6), 3, 7, 13),
         "g193": ((2, 3), (2, 4), 2, 3, 5)}
FIELDS = ("split_feature", "split_bin", "leaf_value", "gain", "cover")
#: (layout name, sml.cv.trialAxisDevices); lanes need 4 ranks
LAYOUTS = {2: (("rows", 1),),
           4: (("rows", 1), ("lanes2", 2), ("lanes4", 4), ("auto", 0))}


def _xy():
    rng = np.random.default_rng(11)
    n = 4096
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] * 3 - X[:, 1] ** 2 + 0.5 * X[:, 2]
         + rng.normal(0, 0.2, n)).astype(np.float32)
    return X, y


def _folds(k: int):
    """k seeded folds of `_xy`: each fold's training rows (numpy)."""
    X, y = _xy()
    parts = np.array_split(np.random.default_rng([11, k]).permutation(len(y)),
                           k)
    train = [np.sort(np.concatenate([parts[j] for j in range(k) if j != i]))
             for i in range(k)]
    return [X[i] for i in train], [y[i] for i in train]


def _trials(name: str) -> list:
    depths, trees, _, seed, _ = GRIDS[name]
    return [dict(max_depth=d, max_bins=16, min_instances=1,
                 min_info_gain=0.0, n_trees=t, feature_k=None,
                 bootstrap=True, subsample=1.0, seed=seed)
            for d in depths for t in trees]


def _stacks(E: int, counts, seed: int = 2):
    """Random (E, n_pad) stacks whose element e holds counts[e] rows."""
    rng = np.random.default_rng(seed)
    n_pad = max(counts)
    bst = rng.integers(0, 8, (E, n_pad, 4)).astype(np.uint8)
    yst = rng.normal(size=(E, n_pad)).astype(np.float32)
    mst = np.zeros((E, n_pad), np.float32)
    for e, c in enumerate(counts):
        mst[e, :c] = 1.0
        bst[e, c:] = 0
        yst[e, c:] = 0.0
    return bst, yst, mst


def _fused_trials(bst, yst, mst):
    """`fit_ensembles_trials` of random stacks: depth 3, 8 bins, 2
    bootstrapped trees, 4 features."""
    from sml_tpu_torch.ml import tree_impl
    from sml_tpu_torch.utils import prng
    E = bst.shape[0]
    spec = tree_impl.TreeSpec(max_depth=3, n_bins=8, n_features=4,
                              feature_k=4, min_instances=1,
                              min_info_gain=0.0, reg_lambda=0.0, gamma=0.0)
    es = tree_impl.EnsembleSpec(tree=spec, n_trees=2, loss="squared",
                                boosting=False, bootstrap=True,
                                subsample=1.0, step_size=0.1)
    return tree_impl.fit_ensembles_trials(
        bst, yst, mst, es, [prng.prng_key(i) for i in range(E)],
        np.full(E, 3), np.full(E, 3), np.ones(E), np.zeros(E),
        np.ones(E, bool), np.ones(E, np.float32), device="cpu")


#: the random stacks of the padding and few-rows cases
STACKS = {"pad5": (5, [300] * 5), "rows3": (1, [3]), "rows3_40": (2, [3, 40])}


def _frame():
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.feature import VectorAssembler
    X, y = _xy()
    cols = {f"f{i}": X[:, i].astype(np.float64) for i in range(6)}
    cols["label"] = y.astype(np.float64)
    df = get_session().createDataFrame(cols)
    return VectorAssembler(inputCols=[f"f{i}" for i in range(6)],
                           outputCol="features").transform(df)


def _cv_metrics(fdf, name: str, parallelism: int = 1):
    """The port's CrossValidator `avgMetrics` of grid `name`."""
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.ml.regression import RandomForestRegressor
    from sml_tpu_torch.ml.tuning import CrossValidator, ParamGridBuilder
    depths, trees, k, seed, cv_seed = GRIDS[name]
    rf = RandomForestRegressor(labelCol="label", maxBins=16, seed=seed)
    grid = (ParamGridBuilder().addGrid(rf.getParam("maxDepth"), list(depths))
            .addGrid(rf.getParam("numTrees"), list(trees)).build())
    cv = CrossValidator(estimator=rf, estimatorParamMaps=grid,
                        evaluator=RegressionEvaluator(labelCol="label"),
                        numFolds=k, parallelism=parallelism, seed=cv_seed)
    return np.asarray(cv.fit(fdf).avgMetrics)


def _fmin_run():
    """`fmin` (tpe, 6 trials, SparkTrials(2)) over a decision tree's
    held-out rmse; returns (best, losses)."""
    from sml_tpu_torch.ml.regression import DecisionTreeRegressor
    from sml_tpu_torch.tune import SparkTrials, fmin, hp, tpe
    X, y = _xy()

    def objective(params):
        m = DecisionTreeRegressor(maxDepth=int(params["depth"]),
                                  maxBins=int(params["bins"])).fit(
            X[:3000], y[:3000], device="cpu")
        d = m._spec.predict_margin(X[3000:], device="cpu") - y[3000:]
        return float(np.sqrt(np.mean(d * d)))

    trials = SparkTrials(parallelism=2)
    best = fmin(objective, {"depth": hp.quniform("depth", 2, 6, 1),
                            "bins": hp.choice("bins", [8, 16, 32])},
                algo=tpe, max_evals=6, trials=trials,
                rstate=np.random.RandomState(42))
    return best, [t["result"]["loss"] for t in trials.trials]


WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import numpy as np
import torch
torch.set_num_threads(1)
import test_torch_multirank_tuning as T
from sml_tpu_torch import GLOBAL_CONF
from sml_tpu_torch.ml import tree_impl
from sml_tpu_torch.ml._tree_models import fit_cv_grid
from sml_tpu_torch.parallel import collectives as coll, mesh as M

rank, store, out, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                       int(sys.argv[4]))
assert coll.initialize_multihost("file://" + store, n, rank,
                                 backend="gloo", device="cpu",
                                 timeout_s=120)
GLOBAL_CONF.set("sml.device", "cpu")
res = {{}}


def save(key, models):
    for (gi, fi), spec in models.items():
        k = f"{{key}}_{{gi}}_{{fi}}"
        for f in T.FIELDS:
            res[k + "_" + f] = np.stack([getattr(t, f) for t in spec.trees])


for layout, knob in T.LAYOUTS[n]:
    GLOBAL_CONF.set("sml.cv.trialAxisDevices", knob)
    for name in T.GRIDS:
        Xs, ys = T._folds(T.GRIDS[name][2])
        for fused in ((6, 1) if layout == "rows" else (6,)):
            GLOBAL_CONF.set("sml.cv.maxFusedTrials", fused)
            coll.reset_counts()
            save(f"{{layout}}_{{name}}_{{fused}}",
                 fit_cv_grid(Xs, ys, {{}}, T._trials(name), device="cpu"))
            for c in ("psum_bytes", "all_gather_bytes", "psum"):
                res[f"{{layout}}_{{name}}_{{fused}}_{{c}}"] = np.asarray(
                    [coll.COUNTS.get("collective." + c, 0.0)])
    for case, (E, counts) in T.STACKS.items():
        if case == "pad5" and knob in (1, 0):
            continue
        if case != "pad5" and knob != 1:
            continue
        packs, bases = T._fused_trials(*T._stacks(E, counts))
        res[f"{{layout}}_{{case}}_packs"] = packs
        res[f"{{layout}}_{{case}}_bases"] = bases
GLOBAL_CONF.set("sml.cv.trialAxisDevices", 0)
res["width_ml07"] = np.asarray([tree_impl._trial_axis_width(12, 53334)])
GLOBAL_CONF.set("sml.cv.maxFusedTrials", 6)
fdf = T._frame()
for name in T.GRIDS:
    res[f"cv_{{name}}"] = T._cv_metrics(fdf, name)
GLOBAL_CONF.set("sml.cv.batchFolds", False)
mark = len(M.PLACEMENT_LOG)
res["cv_placed_g193"] = T._cv_metrics(fdf, "g193", parallelism=2)
res["cv_placed_log"] = np.asarray([r for _, r in M.PLACEMENT_LOG[mark:]])
GLOBAL_CONF.set("sml.cv.batchFolds", True)
if n == 4:
    def job(j):
        # a psum over the trial's group: its rank count
        return j, coll.psum(torch.ones(1), mesh=M.get_mesh()).item()
    for par in (2, 4, 16):
        mark = len(M.PLACEMENT_LOG)
        got = M.run_placed_trials(list(range(8)), job, par)
        res[f"placed{{par}}"] = np.asarray(got)
        res[f"placed{{par}}_log"] = np.asarray(
            [(i,) + r + (-1,) * (4 - len(r))
             for i, r in M.PLACEMENT_LOG[mark:]])

    def bad(j):
        if j in (3, 4):
            raise ValueError(f"trial {{j}} raised")
        return j
    try:
        M.run_placed_trials(list(range(6)), bad, 2)
        res["raised"] = np.asarray(["none"])
    except ValueError as e:
        res["raised"] = np.asarray([str(e)])

    def bad_on_rank3(j):     # trial 3 runs on ranks 2 and 3
        if j == 3 and rank == 3:
            raise ValueError("trial 3 raised on rank 3")
        return j
    try:
        M.run_placed_trials(list(range(6)), bad_on_rank3, 2)
        res["raised_one"] = np.asarray(["none"])
    except ValueError as e:
        res["raised_one"] = np.asarray([str(e)])
    from sml_tpu_torch import device as pdev
    res["device_placed"] = np.asarray(
        pdev.run_placed_trials([1, 2], lambda j: j, 2))
    best, losses = T._fmin_run()
    res["fmin_best"] = np.asarray([best["depth"], best["bins"]])
    res["fmin_losses"] = np.asarray(losses)
np.savez(out, **res)
print("rank", rank, "ok")
"""


def _start(tmp, n: int):
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    script = WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    outs = [str(tmp / f"rank{r}.npz") for r in range(n)]
    store = str(tmp / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), store, outs[r], str(n)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return procs, outs


def _finish(launches: dict) -> dict:
    """Wait for every launch's ranks, each under one timeout; kill what
    is left on the way out. Returns {n: each rank's results}."""
    logs = {}
    try:
        for n, (procs, _) in launches.items():
            logs[n] = [p.communicate(timeout=RANK_TIMEOUT)[0]
                       for p in procs]
    finally:
        for procs, _ in launches.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for n, (procs, outs) in launches.items():
        for r, (p, log) in enumerate(zip(procs, logs[n])):
            assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
    return {n: [dict(np.load(o)) for o in outs]
            for n, (_, outs) in launches.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank count's ranks' results: {n: [rank 0's, rank 1's, ...]};
    the two launches run at once."""
    launches = {}
    try:
        for n in (2, 4):
            launches[n] = _start(tmp_path_factory.mktemp(f"tune{n}"), n)
    finally:
        out = _finish(launches)
    return out


@pytest.fixture(scope="module")
def reference():
    """The port's own one-device fits and CVs, on the CPU."""
    from sml_tpu_torch import GLOBAL_CONF
    from sml_tpu_torch.ml._tree_models import fit_cv_grid
    GLOBAL_CONF.set("sml.device", "cpu")
    out = {}
    try:
        for name in GRIDS:
            Xs, ys = _folds(GRIDS[name][2])
            for fused in (6, 1):
                GLOBAL_CONF.set("sml.cv.maxFusedTrials", fused)
                out[(name, fused)] = fit_cv_grid(Xs, ys, {}, _trials(name),
                                                 device="cpu")
        for case, (E, counts) in STACKS.items():
            out[case] = _fused_trials(*_stacks(E, counts))
        GLOBAL_CONF.set("sml.cv.maxFusedTrials", 6)
        fdf = _frame()
        for name in GRIDS:
            out[f"cv_{name}"] = _cv_metrics(fdf, name)
        out["fmin"] = _fmin_run()
    finally:
        GLOBAL_CONF.unset("sml.cv.maxFusedTrials")
        GLOBAL_CONF.unset("sml.device")
    return out


CELLS = [(n, layout, name, fused) for n in (2, 4)
         for layout, _ in LAYOUTS[n] for name in GRIDS
         for fused in ((6, 1) if layout == "rows" else (6,))]


@pytest.mark.parametrize("n,layout,name,fused", CELLS)
def test_every_rank_fits_the_one_device_grid(runs, reference, n, layout,
                                             name, fused):
    want = reference[(name, fused)]
    for rank, res in enumerate(runs[n]):
        for (gi, fi), spec in want.items():
            key = f"{layout}_{name}_{fused}_{gi}_{fi}"
            for f in FIELDS:
                np.testing.assert_array_equal(
                    res[f"{key}_{f}"],
                    np.stack([getattr(t, f) for t in spec.trees]),
                    err_msg=f"{f} of {key}, rank {rank} of {n}")


def test_lanes_of_one_rank_need_no_histogram_allreduce(runs):
    """Rows split: the histograms ride psums; 4 lanes of 1 rank: no
    psum at all, and one all-gather of the packs and bases a fit."""
    for res in runs[4]:
        assert res["rows_g149_6_psum_bytes"][0] > 0
        assert res["rows_g149_6_all_gather_bytes"][0] == 0
        assert res["lanes4_g149_6_psum_bytes"][0] == 0
        assert res["lanes4_g149_6_all_gather_bytes"][0] > 0
        assert 0 < res["lanes2_g149_6_psum_bytes"][0] \
            < res["rows_g149_6_psum_bytes"][0]


@pytest.mark.parametrize("case,layouts", [("pad5", ("lanes2", "lanes4")),
                                          ("rows3", ("rows",)),
                                          ("rows3_40", ("rows",))])
def test_padded_lanes_and_few_row_elements_fit_the_one_device_packs(
        runs, reference, case, layouts):
    packs, bases = reference[case]
    for n in (2, 4):
        for layout in layouts:
            if f"{layout}_{case}_packs" not in runs[n][0]:
                continue
            for res in runs[n]:
                got = res[f"{layout}_{case}_packs"]
                assert got.shape == packs.shape
                np.testing.assert_array_equal(got, packs)
                np.testing.assert_array_equal(
                    res[f"{layout}_{case}_bases"], bases)


def test_cv_avg_metrics_equal_the_one_device_cv(runs, reference):
    for n, ranks in runs.items():
        for res in ranks:
            for name in GRIDS:
                np.testing.assert_array_equal(res[f"cv_{name}"],
                                              reference[f"cv_{name}"])
            np.testing.assert_array_equal(res["cv_placed_g193"],
                                          reference["cv_g193"])


def test_cv_avg_metrics_match_the_jax_one_device_run(spark, runs):
    import pandas as pd

    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.ml.evaluation import RegressionEvaluator
    from sml_tpu.ml.feature import VectorAssembler
    from sml_tpu.ml.regression import RandomForestRegressor
    from sml_tpu.ml.tuning import CrossValidator, ParamGridBuilder
    from sml_tpu.parallel import mesh as jmesh
    X, y = _xy()
    pdf = pd.DataFrame({f"f{i}": X[:, i].astype(np.float64)
                        for i in range(6)})
    pdf["label"] = y.astype(np.float64)
    fdf = VectorAssembler(inputCols=[f"f{i}" for i in range(6)],
                          outputCol="features") \
        .transform(spark.createDataFrame(pdf))
    keys = ("sml.tree.kernel", "sml.cv.trialAxisDevices",
            "sml.cv.maxFusedTrials")
    prev = {k: JCONF.get(k) for k in keys}
    JCONF.set("sml.tree.kernel", "xla")
    JCONF.set("sml.cv.trialAxisDevices", 1)
    JCONF.set("sml.cv.maxFusedTrials", 6)
    try:
        for name, (depths, trees, k, seed, cv_seed) in GRIDS.items():
            rf = RandomForestRegressor(labelCol="label", maxBins=16,
                                       seed=seed)
            grid = (ParamGridBuilder()
                    .addGrid(rf.getParam("maxDepth"), list(depths))
                    .addGrid(rf.getParam("numTrees"), list(trees)).build())
            cv = CrossValidator(estimator=rf, estimatorParamMaps=grid,
                                evaluator=RegressionEvaluator(
                                    labelCol="label"),
                                numFolds=k, parallelism=1, seed=cv_seed)
            with jmesh.use_mesh(jmesh.build_mesh(1)):
                want = np.asarray(cv.fit(fdf).avgMetrics)
            for n, ranks in runs.items():
                np.testing.assert_allclose(ranks[0][f"cv_{name}"], want,
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=f"{name} on {n} ranks")
    finally:
        for k_, v in prev.items():
            JCONF.set(k_, v)


class _Ranks:
    """The shape the trial-width rule reads of a flat mesh over a whole
    default group of `size` ranks."""
    hierarchical = False
    trials = None
    spans_world = True

    def __init__(self, size: int):
        self.size = size


WIDTH_CASES = [((8, 4096), None), ((12, 4096), None), ((8, 1 << 20), None),
               ((5, 4096), None), ((5, 4096), 8)]


@pytest.mark.parametrize("args,knob", WIDTH_CASES)
def test_trial_axis_width_is_the_jax_rule(args, knob):
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.ml import tree_impl as jti
    from sml_tpu.parallel import mesh as jmesh
    from sml_tpu_torch import GLOBAL_CONF
    from sml_tpu_torch.ml import tree_impl as pti
    for conf in (JCONF, GLOBAL_CONF):
        if knob is None:
            conf.unset("sml.cv.trialAxisDevices")
        else:
            conf.set("sml.cv.trialAxisDevices", knob)
    try:
        for width in (8, 1):
            with jmesh.use_mesh(jmesh.build_mesh(width)):
                want = jti._trial_axis_width(*args)
            assert pti._trial_axis_width(*args, mesh=_Ranks(width)) == want
    finally:
        JCONF.unset("sml.cv.trialAxisDevices")
        GLOBAL_CONF.unset("sml.cv.trialAxisDevices")


def test_auto_width_puts_the_ml07_grid_on_four_lanes(runs):
    assert [int(r["width_ml07"][0]) for r in runs[4]] == [4] * 4
    assert [int(r["width_ml07"][0]) for r in runs[2]] == [2] * 2


@pytest.mark.parametrize("par,groups", [(2, ((0, 1), (2, 3))),
                                        (4, ((0,), (1,), (2,), (3,))),
                                        (16, ((0,), (1,), (2,), (3,)))])
def test_placed_trials_run_on_disjoint_rank_groups(runs, par, groups):
    for res in runs[4]:
        got = res[f"placed{par}"]
        # results in job order; each trial's psum is its group's size
        assert got[:, 0].tolist() == list(range(8))
        assert got[:, 1].tolist() == [len(groups[j % len(groups)])
                                      for j in range(8)]
        log = res[f"placed{par}_log"]
        assert log[:, 0].tolist() == list(range(8))
        placed = [tuple(int(r) for r in row[1:] if r >= 0) for row in log]
        assert placed == [groups[j % len(groups)] for j in range(8)]
        flat = [r for g in set(placed) for r in g]
        assert sorted(flat) == [0, 1, 2, 3]


def test_a_raising_trial_raises_on_every_rank(runs):
    assert [str(r["raised"][0]) for r in runs[4]] == ["trial 3 raised"] * 4


def test_a_trial_raising_on_one_rank_of_its_group_raises_on_every_rank(runs):
    assert [str(r["raised_one"][0]) for r in runs[4]] == \
        ["trial 3 raised on rank 3"] * 4


def test_device_placed_trials_run_over_ranks_under_a_mesh(runs):
    for res in runs[4]:
        assert res["device_placed"].tolist() == [1, 2]


def test_the_placed_cv_logs_both_submeshes(runs):
    for res in runs[4]:
        log = {tuple(r) for r in res["cv_placed_log"]}
        assert log == {(0, 1), (2, 3)}


def test_fmin_spark_trials_find_the_one_rank_best(runs, reference):
    best, losses = reference["fmin"]
    for res in runs[4]:
        assert res["fmin_best"].tolist() == [best["depth"], best["bins"]]
        np.testing.assert_array_equal(res["fmin_losses"], losses)
