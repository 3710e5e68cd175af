"""Tuning's device half in the port (`fit_ensembles_trials`,
`fit_ensembles_folds`, `build_fold_stacks` in `ml/tree_impl.py`;
`_fit_ensemble_folds`, `_fit_ensembles_grid`, `fit_cv_grid`,
`_cached_bins`, `fused_reg_stats_from_matrix` in `ml/_tree_models.py`)
against the JAX package's live fused fits, on the CPU, at small sizes
(3,000 rows, 6 features, 16 to 300 bins).

The JAX fits run with `sml.tree.kernel=xla` and
`sml.cv.trialAxisDevices=1` (the element axis replicated, rows over the
`spark` fixture's 8-device CPU mesh), both restored after each test; the
port's with device="cpu", so its kernels' plain versions run. Labels are
multiples of 1/8, so every histogram sum is exact in f32 in any order:

- split features are identical on every node, split bins on every level
  above an element's own depth; below it the port stores bin 0, as the
  element's own sequential fit does (the JAX fused fit keeps the scan's
  bin on the nodes of that level, which no row routes by);
- leaf values, gains and covers agree to rtol 1e-6, bases too.

Each fused element is also held against the port's sequential fit of its
own parameters (`_fit_ensemble`): every field bit for bit. And a fused
fit launches each level kernel once a level and each draw kernel
(`fit_row_weights`, `fit_feature_masks`) once a fit, whatever its
element count (counted through the wrappers here, where they run their
plain versions).
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch.conf import GLOBAL_CONF as PCONF
from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import tree_impl as pti
from sml_tpu_torch.ml.evaluation import host_reg_stats
from sml_tpu_torch.native import hist_kernel as hk
from sml_tpu_torch.native import prng_kernel as pk
from sml_tpu_torch.utils import prng
from sml_tpu_torch.utils.profiler import PROFILER

torch.set_num_threads(2)

CAT = {4: 5}


@pytest.fixture()
def confs(spark):
    """The JAX fits on the XLA path with histogram subtraction and the
    element axis replicated; every key restored after each test."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    keys = ("sml.tree.kernel", "sml.tree.histSubtraction",
            "sml.cv.trialAxisDevices")
    prev = {k: JCONF.get(k) for k in keys}
    JCONF.set("sml.tree.kernel", "xla")
    JCONF.set("sml.tree.histSubtraction", True)
    JCONF.set("sml.cv.trialAxisDevices", 1)
    yield JCONF
    for k, v in prev.items():
        JCONF.set(k, v)


def _data(n=3000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[::17, 2] = np.nan
    X[:, 4] = rng.integers(0, 5, n)
    y = 2 * X[:, 0] - np.nan_to_num(X[:, 1]) ** 2 + (X[:, 3] > 0) * 1.5 \
        + 0.4 * X[:, 4] + rng.normal(0, 0.3, n)
    return X, (np.round(y * 8) / 8).astype(np.float32)


def _folds(X, y, k=3, seed=1):
    """k seeded folds: (train Xs, train ys, validation pairs); each train
    set is the other k-1 folds, so the sets differ in length."""
    parts = np.array_split(np.random.default_rng(seed).permutation(len(y)),
                           k)
    tr = [np.sort(np.concatenate([parts[j] for j in range(k) if j != i]))
          for i in range(k)]
    return ([X[i] for i in tr], [y[i] for i in tr],
            [(X[p], y[p]) for p in parts])


def _level(n_nodes):
    return np.floor(np.log2(np.arange(n_nodes) + 1)).astype(np.int64)


def _assert_element(pp, pj, depth: int, n_trees: int):
    """An element's (T, 5, n_nodes) port pack against the JAX one: split
    features everywhere, split bins above its depth (0 below in the
    port), values to rtol 1e-6."""
    pp, pj = np.asarray(pp)[:n_trees], np.asarray(pj)[:n_trees]
    np.testing.assert_array_equal(pp[:, 0], pj[:, 0])
    above = _level(pp.shape[2]) < depth
    np.testing.assert_array_equal(pp[:, 1][:, above], pj[:, 1][:, above])
    assert (pp[:, 1][:, ~above] == 0).all()
    for i, fld in ((2, "leaf_value"), (3, "gain"), (4, "cover")):
        np.testing.assert_allclose(pp[:, i], pj[:, i], rtol=1e-6,
                                   err_msg=fld)


def _assert_same_trees(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for fld in a._fields:
            np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                          err_msg=fld)


#: the JAX package's own TrialDyn case (tests/test_hist_kernel.py:122-131)
TRIAL_DYN = dict(depth=[2, 4, 3], feature_k=[3, 5, 2],
                 min_inst=[1.0, 2.0, 1.0], min_gain=[0.0, 0.0, 0.01],
                 bootstrap=[True, False, True], subsample=[0.9, 1.0, 0.7])


def test_fit_ensembles_trials_matches_jax(confs):
    from sml_tpu.ml import tree_impl as jti
    X, y = _data()
    Xs, ys, _ = _folds(X, y)
    binned = [jti.make_bins(Xf, yf, 32, CAT)[0] for Xf, yf in zip(Xs, ys)]
    seeds = (1, 2, 3)
    jes = jti.EnsembleSpec(
        tree=jti.TreeSpec(4, 32, 6, 6, 1, 0.0, 0.0, 0.0), n_trees=6,
        loss="squared", boosting=False, bootstrap=True, subsample=1.0,
        step_size=0.2)
    pes = pti.EnsembleSpec(tree=pti.TreeSpec(*jes.tree), **{
        k: getattr(jes, k) for k in jes._fields if k != "tree"})
    jrngs = np.stack([np.asarray(prng.prng_key(s), np.uint32)
                      for s in seeds])
    jpacks, jbases = jti.fit_ensembles_trials(
        *jti.build_fold_stacks(binned, ys), jes, jrngs,
        *(np.asarray(v) for v in TRIAL_DYN.values()))
    ppacks, pbases = pti.fit_ensembles_trials(
        *pti.build_fold_stacks(binned, ys), pes, jrngs, device="cpu",
        **TRIAL_DYN)
    assert ppacks.shape == np.asarray(jpacks).shape == (3, 6, 5, 31)
    for e, d in enumerate(TRIAL_DYN["depth"]):
        _assert_element(ppacks[e], jpacks[e], d, 6)
        assert (ppacks[e][:, 0] >= 0).sum() >= 6   # real trees
    np.testing.assert_allclose(pbases, np.asarray(jbases), rtol=1e-6)
    # and each element is its own sequential fit's trees
    for e, d in enumerate(TRIAL_DYN["depth"]):
        es1 = pes._replace(
            tree=pes.tree._replace(
                max_depth=d, feature_k=TRIAL_DYN["feature_k"][e],
                min_instances=int(TRIAL_DYN["min_inst"][e]),
                min_info_gain=TRIAL_DYN["min_gain"][e]),
            bootstrap=TRIAL_DYN["bootstrap"][e],
            subsample=TRIAL_DYN["subsample"][e])
        trees, _ = pti.fit_ensemble_on_device(
            torch.from_numpy(binned[e]), torch.from_numpy(ys[e]), es1,
            seeds[e])
        n_nodes = 2 ** (d + 1) - 1
        _assert_same_trees(pti._unpack_trees(ppacks[e][:, :, :n_nodes]),
                           trees)


def test_fit_ensembles_folds_matches_jax(confs):
    from sml_tpu.ml import tree_impl as jti
    X, y = _data(seed=2)
    Xs, ys, _ = _folds(X, y, seed=3)
    binned = [jti.make_bins(Xf, yf, 16, CAT)[0] for Xf, yf in zip(Xs, ys)]
    spec = (4, 16, 6, 2, 2, 0.0, 0.0, 0.0)
    kw = dict(n_trees=3, loss="squared", boosting=False, bootstrap=True,
              subsample=0.8, step_size=0.1)
    jout = jti.fit_ensembles_folds(*jti.build_fold_stacks(binned, ys),
                                   jti.EnsembleSpec(jti.TreeSpec(*spec),
                                                    **kw), seed=9)
    pout = pti.fit_ensembles_folds(*pti.build_fold_stacks(binned, ys),
                                   pti.EnsembleSpec(pti.TreeSpec(*spec),
                                                    **kw), seed=9,
                                   device="cpu")
    for (tp, bp), (tj, bj) in zip(pout, jout):
        assert len(tp) == len(tj) == 3
        for a, b in zip(tp, tj):
            np.testing.assert_array_equal(a.split_feature, b.split_feature)
            np.testing.assert_array_equal(a.split_bin, b.split_bin)
            for fld in ("leaf_value", "gain", "cover"):
                np.testing.assert_allclose(getattr(a, fld), getattr(b, fld),
                                           rtol=1e-6, err_msg=fld)
        assert bp == pytest.approx(bj, rel=1e-6)


def _grid(seed=42):
    """A grid over depth, maxBins (uint8 and uint16 bins), trees and the
    other per-element gates, DT and RF points."""
    rf = dict(min_info_gain=0.0, bootstrap=True, subsample=1.0, seed=seed,
              feature_k=2, min_instances=1)
    return [dict(rf, max_depth=2, max_bins=16, n_trees=2),
            dict(rf, max_depth=4, max_bins=300, n_trees=3),
            dict(rf, max_depth=3, max_bins=16, n_trees=3, subsample=0.7,
                 min_instances=3),
            dict(max_depth=4, max_bins=300, n_trees=1, feature_k=None,
                 min_instances=1, min_info_gain=0.02, bootstrap=False,
                 subsample=1.0, seed=5)]


def test_fit_ensembles_grid_matches_jax(confs):
    """Several chunks (max_fused 5 over 12 elements), uint8 and uint16
    bins in one uint16 stack, elements of fewer bins padded to 300."""
    from sml_tpu.ml._tree_models import _fit_ensembles_grid as jgrid
    X, y = _data(seed=4)
    Xs, ys, _ = _folds(X, y, seed=5)
    trials = _grid()
    jout = jgrid(Xs, ys, CAT, trials, 5)
    pout = ptm._fit_ensembles_grid(Xs, ys, CAT, trials, 5, device="cpu")
    assert sorted(pout) == sorted(jout) == [(g, f) for g in range(4)
                                            for f in range(3)]
    for key, sp in pout.items():
        t, sj = trials[key[0]], jout[key]
        n_nodes = 2 ** (t["max_depth"] + 1) - 1
        assert sp.depth == sj.depth == t["max_depth"]
        assert len(sp.trees) == len(sj.trees) == t["n_trees"]
        _assert_element(
            np.stack([np.stack(tp) for tp in sp.trees]),
            np.stack([np.stack(tj)[:, :n_nodes] for tj in sj.trees]),
            t["max_depth"], t["n_trees"])
        np.testing.assert_array_equal(sp.binning.edges, sj.binning.edges)


@pytest.mark.parametrize("max_fused", [16, 5])
def test_fused_grid_elements_are_their_sequential_fits(max_fused):
    X, y = _data(seed=6)
    Xs, ys, _ = _folds(X, y, seed=7)
    trials = _grid(seed=11)
    fused = ptm._fit_ensembles_grid(Xs, ys, CAT, trials, max_fused,
                                    device="cpu")
    for (gi, fi), sp in fused.items():
        t = trials[gi]
        seq = ptm._fit_ensemble(
            Xs[fi], ys[fi], categorical=CAT, max_depth=t["max_depth"],
            max_bins=t["max_bins"], min_instances=t["min_instances"],
            min_info_gain=t["min_info_gain"], n_trees=t["n_trees"],
            feature_k=t["feature_k"], bootstrap=t["bootstrap"],
            subsample=t["subsample"], seed=t["seed"], loss="squared",
            device="cpu")
        _assert_same_trees(sp.trees, seq.trees)
        np.testing.assert_array_equal(sp.binning.edges, seq.binning.edges)
        assert sp.tree_weights is None and sp.base == 0.0


class _Calls:
    """Counts the calls of the fit's kernel wrappers (the plain versions
    run here; on the card each call is one launch)."""

    NAMES = ((hk, "hist_accumulate", "hist_accumulate"),
             (hk, "split_scan", "split_scan"),
             (pk, "fit_feature_masks", "feature_mask"),
             (pk, "fit_row_weights", "row_weights"))

    def __init__(self, monkeypatch):
        self.counts = {kernel: 0 for _, _, kernel in self.NAMES}
        for mod, name, kernel in self.NAMES:
            def counted(*a, _fn=getattr(mod, name), _name=kernel, **kw):
                self.counts[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, counted)


#: (depth, trees) of each grid point: one point (E = 3 over 3 folds) and
#: the ML 07 grid, maxDepth {2, 5} x numTrees {10, 20} (E = 12)
COUNT_GRIDS = {"one point": [(3, 4)],
               "ML 07": [(d, t) for d in (2, 5) for t in (10, 20)]}


@pytest.mark.parametrize("grid", sorted(COUNT_GRIDS))
def test_a_fused_chunk_launches_each_kernel_once_a_level(monkeypatch, grid):
    """Per chunk: T_max x D_max calls of each level kernel and one of
    each draw kernel, whatever the element count (E = 3 and E = 12),
    against the sum over elements of T x D (and one draw of each a fit)
    when each element fits on its own."""
    n_folds = 3
    X, y = _data(n=900, seed=8)
    Xs, ys, _ = _folds(X, y, k=n_folds, seed=9)
    rf = dict(max_bins=16, min_instances=1, min_info_gain=0.0, feature_k=2,
              bootstrap=True, subsample=1.0, seed=42)
    pairs = COUNT_GRIDS[grid]
    trials = [dict(rf, max_depth=d, n_trees=t) for d, t in pairs]
    D, T = max(d for d, _ in pairs), max(t for _, t in pairs)
    calls = _Calls(monkeypatch)
    PROFILER.reset()
    ptm._fit_ensembles_grid(Xs, ys, CAT, trials, 16, device="cpu")
    assert calls.counts == {"hist_accumulate": T * D, "split_scan": T * D,
                            "feature_mask": 1, "row_weights": 1}
    assert PROFILER.counters()["tree.fit_dispatch"] == 1.0
    for k in calls.counts:
        calls.counts[k] = 0
    for t in trials:
        for fi in range(n_folds):
            ptm._fit_ensemble(
                Xs[fi], ys[fi], categorical=CAT, loss="squared",
                device="cpu", **{k: t[k] for k in (
                    "max_depth", "max_bins", "min_instances",
                    "min_info_gain", "n_trees", "feature_k", "bootstrap",
                    "subsample", "seed")})
    levels = n_folds * sum(d * t for d, t in pairs)
    fits = n_folds * len(pairs)
    assert calls.counts == {"hist_accumulate": levels, "split_scan": levels,
                            "feature_mask": fits, "row_weights": fits}


@pytest.mark.parametrize("max_fused, fits", [(16, 1), (5, 3), (1, 4)])
def test_fit_cv_grid_reads_max_fused_trials(max_fused, fits):
    """`sml.cv.maxFusedTrials` chunks the 12 elements (1 or 3 fused fits)
    or, at 1, fits each grid point's folds together (4 fits); the models
    are the same every way."""
    X, y = _data(seed=10)
    Xs, ys, _ = _folds(X, y, seed=11)
    trials = _grid(seed=3)
    prev = PCONF.get("sml.cv.maxFusedTrials")
    PCONF.set("sml.cv.maxFusedTrials", max_fused)
    try:
        PROFILER.reset()
        got = ptm.fit_cv_grid(Xs, ys, CAT, trials, device="cpu")
        assert PROFILER.counters()["tree.fit_dispatch"] == float(fits)
    finally:
        PCONF.set("sml.cv.maxFusedTrials", prev)
    want = ptm._fit_ensembles_grid(Xs, ys, CAT, trials, 16, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        _assert_same_trees(got[key].trees, want[key].trees)


def test_fused_reg_stats_are_the_predictions_stats():
    X, y = _data(seed=12)
    Xs, ys, val = _folds(X, y, seed=13)
    spec = ptm._fit_ensembles_grid(Xs, ys, CAT, _grid()[1:2], 16,
                                   device="cpu")[(0, 1)]
    Xv, yv = val[1]
    yv = yv.astype(np.float64)
    yv[::50] = np.nan                       # unlabelled rows drop out
    got = ptm.fused_reg_stats_from_matrix(spec, Xv, yv, device="cpu")
    want = host_reg_stats(spec.predict_margin(Xv, device="cpu"), yv)
    assert got[0] == want[0] == float(np.isfinite(yv).sum())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    binary = ptm._EnsembleSpec(spec.trees, spec.depth, spec.binning, None,
                               0.0, spec.n_features, "binary")
    assert ptm.fused_reg_stats_from_matrix(binary, Xv, yv,
                                           device="cpu") is None
    with pytest.raises(ValueError, match="labels"):
        ptm.fused_reg_stats_from_matrix(spec, Xv, yv[:-1], device="cpu")


def test_build_fold_stacks_memo_and_bound_match_jax(confs):
    """Memoized by the sources' identity (the same stacks object again),
    the newest stack always kept, older ones trimmed at two entries or
    past `sml.fit.foldStackBytes`: the port's memo holds what the JAX
    package's holds after the same calls."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    from sml_tpu.ml import tree_impl as jti
    rng = np.random.default_rng(14)
    srcs = [([rng.integers(0, 9, (n, 3)).astype(np.uint8) for n in
              (40, 37)], [rng.normal(size=n).astype(np.float32)
                          for n in (40, 37)]) for _ in range(3)]
    prev = (PCONF.get("sml.fit.foldStackBytes"),
            JCONF.get("sml.fit.foldStackBytes"))
    sizes = {}
    try:
        for pkg, conf, memo in ((pti, PCONF, pti._stack_memo),
                                (jti, JCONF, jti._stack_memo)):
            memo.clear()
            conf.set("sml.fit.foldStackBytes", 1 << 30)
            first = pkg.build_fold_stacks(*srcs[0])
            assert pkg.build_fold_stacks(*srcs[0])[0] is first[0]
            pkg.build_fold_stacks(*srcs[1])
            seen = [len(memo)]
            assert pkg.build_fold_stacks(*srcs[1])[0] is not first[0]
            conf.set("sml.fit.foldStackBytes", 1)   # below one stack
            pkg.build_fold_stacks(*srcs[2])
            seen.append(len(memo))
            again = pkg.build_fold_stacks(*srcs[2])
            assert again[0] is pkg.build_fold_stacks(*srcs[2])[0]
            sizes[pkg.__name__.split(".")[0]] = seen
            memo.clear()
    finally:
        PCONF.set("sml.fit.foldStackBytes", prev[0])
        JCONF.set("sml.fit.foldStackBytes", prev[1])
    assert sizes["sml_tpu_torch"] == sizes["sml_tpu"] == [2, 1]
    bst, yst, mst = pti.build_fold_stacks(*srcs[0])
    assert bst.shape == (2, 40, 3) and mst[1].sum() == 37
    assert (bst[1, 37:] == 0).all() and (yst[1, 37:] == 0).all()
    pti._stack_memo.clear()


def test_cached_bins_are_content_keyed_and_id_stable():
    X, y = _data(n=500, seed=15)
    a = ptm._cached_bins(X, y, 16, CAT)
    assert ptm._cached_bins(X.copy(), y.copy(), 16, CAT) is a
    b = ptm._cached_bins(X, y, 24, CAT)
    assert b is not a and b[0].shape == a[0].shape
    X2 = X.copy()
    X2[0, 0] += 1.0
    assert ptm._cached_bins(X2, y, 16, CAT) is not a
    np.testing.assert_array_equal(a[0], pti.make_bins(X, y, 16, CAT)[0])
