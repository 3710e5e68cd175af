"""The port's warm-start boosting, margin replay and round checkpoints,
on the CPU, against itself and the live JAX package.

- k rounds and a warm start of N - k rounds equal an N-round fit bit for
  bit, monolithic (`warm_start_ensemble`) and chunked
  (`warm_start_ensemble_chunked`), with `rounds_per_dispatch` None and 2;
  a warm start on other rows keeps the saved base; a new step size and a
  spec that is not boosted are refused.
- The replay: `forest_margin_plain` with `init` equals the fit loop's
  carried margin after k rounds bit for bit; against the JAX package's
  `_margin_replay_compiled` on a one-device CPU mesh it differs by XLA's
  fused multiply-add (at most 4.8e-7 here), and each equals a numpy
  replay of its own rounding bit for bit.
- Checkpoints (`ct`): a fit interrupted after its second checkpoint
  resumes and equals the uninterrupted fit; a warm start's checkpoint
  neither leaks into a fresh fit nor is lost to a matching re-run; a
  checkpoint written by either package loads in the other.
- `XgboostRegressor(rounds_per_dispatch=2)` fits the trees it fits
  without the param, in ceil(T/2) segments.
"""

import os

import numpy as np
import pytest
import torch

from sml_tpu_torch.ct import (BoostCheckpoint, checkpointed_fit,
                              checkpointed_warm_start)
from sml_tpu_torch.frame._chunks import ArrayChunkSource
from sml_tpu_torch.ml import _chunked as pch
from sml_tpu_torch.ml import _tree_models as ptm
from sml_tpu_torch.ml import tree_impl as pti
from sml_tpu_torch.native import traverse_kernel as tk
from sml_tpu_torch.utils.profiler import PROFILER

torch.set_num_threads(2)

N, F = 1200, 6
FIT = dict(categorical={}, max_depth=3, max_bins=16, min_instances=1,
           min_info_gain=0.0, feature_k=None, bootstrap=False,
           subsample=1.0, seed=5, loss="squared", step_size=0.3,
           boosting=True, device="cpu")
CHUNKED = dict(categorical={}, max_depth=3, max_bins=16, seed=5,
               loss="squared", step_size=0.3, boosting=True, device="cpu")


def _data(n=N, seed=3, shift=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    if shift:
        X[:, 0] += 1.5
    y = (2.0 * X[:, 0] + 0.5 * X[:, 2] - X[:, 1] ** 2
         + rng.normal(0, 0.2, n)).astype(np.float32)
    return X, y


def _same(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for fld in ("split_feature", "split_bin", "leaf_value"):
            np.testing.assert_array_equal(getattr(ta, fld), getattr(tb, fld),
                                          err_msg=fld)
    assert a.base == b.base
    np.testing.assert_array_equal(a.tree_weights, b.tree_weights)


# ----------------------------------------------------------- warm start
@pytest.mark.parametrize("rounds", [None, 2])
@pytest.mark.parametrize("path", ["monolithic", "chunked"])
def test_warm_start_equals_the_full_fit(path, rounds):
    X, y = _data()
    full = ptm._fit_ensemble(X, y, n_trees=8, **FIT)
    if path == "monolithic":
        part = ptm._fit_ensemble(X, y, n_trees=3, **FIT)
        warm = ptm.warm_start_ensemble(part, X, y, n_new_trees=5, seed=5,
                                       rounds_per_dispatch=rounds,
                                       device="cpu")
    else:
        src = lambda: ArrayChunkSource(X, y, chunk_rows=257)  # noqa: E731
        chunked_full = pch.fit_ensemble_chunked(src(), n_trees=8, **CHUNKED)
        _same(full, chunked_full)
        part = pch.fit_ensemble_chunked(src(), n_trees=3, **CHUNKED)
        warm = pch.warm_start_ensemble_chunked(
            part, src(), n_new_trees=5, seed=5, step_size=0.3,
            rounds_per_dispatch=rounds, device="cpu")
    _same(full, warm)


def test_warm_start_segments_count_dispatches_and_fire_the_hook():
    X, y = _data()
    part = ptm._fit_ensemble(X, y, n_trees=3, **FIT)
    seen = []
    before = PROFILER.counters().get("tree.fit_dispatch", 0.0)
    warm = ptm.warm_start_ensemble(
        part, X, y, n_new_trees=5, seed=5, rounds_per_dispatch=2,
        device="cpu",
        on_rounds=lambda t, trees, base: seen.append((t, len(trees), base)))
    assert PROFILER.counters()["tree.fit_dispatch"] - before == 3
    assert seen == [(5, 2, part.base), (7, 4, part.base)]
    assert len(warm.trees) == 8


def test_warm_start_on_other_rows_keeps_the_saved_base(spark):
    """Appended rounds on new rows start from the saved spec's base, not
    their own labels' mean, and agree with the JAX package's warm start."""
    from sml_tpu.ml._tree_models import (_fit_ensemble as jfit,
                                         warm_start_ensemble as jwarm)
    X, y = _data()
    X2, y2 = _data(n=900, seed=8, shift=True)
    y, y2 = np.round(y * 8) / 8, np.round(y2 * 8) / 8
    part = ptm._fit_ensemble(X, y, n_trees=3, **FIT)
    warm = ptm.warm_start_ensemble(part, X2, y2, n_new_trees=3, seed=5,
                                   device="cpu")
    assert warm.base == part.base != float(np.float32(np.mean(y2)))
    for a, b in zip(warm.trees[:3], part.trees):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    jkw = {k: v for k, v in FIT.items() if k != "device"}
    jpart = jfit(X, y, n_trees=3, **jkw)
    jw = jwarm(jpart, X2, y2, n_new_trees=3, seed=5)
    assert jw.base == jpart.base
    np.testing.assert_allclose(warm.base, jw.base, rtol=1e-6)
    for tj, tp in zip(jw.trees[3:], warm.trees[3:]):
        np.testing.assert_array_equal(tp.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tp.split_bin, tj.split_bin)


def test_warm_start_guards():
    X, y = _data(600)
    part = ptm._fit_ensemble(X, y, n_trees=3, **FIT)
    with pytest.raises(ValueError, match="step_size"):
        ptm.warm_start_ensemble(part, X, y, n_new_trees=2, seed=5,
                                step_size=0.1, device="cpu")
    # the saved step, rounded to f32 or not, passes
    ptm.warm_start_ensemble(part, X, y, n_new_trees=1, seed=5,
                            step_size=float(np.float32(0.3)), device="cpu")
    forest = ptm._fit_ensemble(X, y, n_trees=3,
                               **{**FIT, "boosting": False,
                                  "bootstrap": True})
    with pytest.raises(ValueError, match="boosted"):
        ptm.warm_start_ensemble(forest, X, y, n_new_trees=2, seed=5,
                                device="cpu")
    with pytest.raises(ValueError, match="boosted"):
        pch.warm_start_ensemble_chunked(forest, ArrayChunkSource(X, y),
                                        n_new_trees=2, device="cpu")
    es = pti.EnsembleSpec(tree=pti.TreeSpec(3, 16, F, F, 1, 0.0, 0.0, 0.0),
                          n_trees=4, loss="squared", boosting=False,
                          bootstrap=False, subsample=1.0, step_size=0.3)
    with pytest.raises(ValueError, match="boosting"):
        pti.resume_ensemble_on_device(torch.zeros((4, F), dtype=torch.uint8),
                                      torch.zeros(4), es, 5, [], 0.0)


# ---------------------------------------------------------------- replay
def _stacked(trees):
    return [torch.from_numpy(np.ascontiguousarray(np.stack(
        [getattr(t, f) for t in trees]), dt))
        for f, dt in (("split_feature", np.int32), ("split_bin", np.int32),
                      ("leaf_value", np.float32))]


def test_plain_replay_with_init_equals_the_fit_carry(monkeypatch):
    """On labels of 0 the squared-loss gradient is the carried margin
    itself: round k's gradient, captured from the builder, equals
    `forest_margin_plain` over the first k trees from the starting
    margin, bit for bit (a tensor init here; the warm-start tests take
    the number)."""
    X, _ = _data()
    binned, _ = pti.make_bins(X, np.zeros(N, np.float32), 16)
    b = torch.from_numpy(binned)
    m0 = torch.from_numpy(np.random.default_rng(4).normal(
        size=N).astype(np.float32))
    grads = []
    real = pti._make_tree_builder

    def capturing(spec):
        build = real(spec)

        def wrapped(binned_c, binned, grad, *rest):
            grads.append(grad.clone())
            return build(binned_c, binned, grad, *rest)
        return wrapped

    monkeypatch.setattr(pti, "_make_tree_builder", capturing)
    es = pti.EnsembleSpec(tree=pti.TreeSpec(3, 16, F, F, 1, 0.0, 0.0, 0.0),
                          n_trees=6, loss="squared", boosting=True,
                          bootstrap=False, subsample=1.0, step_size=0.3)
    packs, _ = pti._fit_elements(
        b, torch.zeros(N), N, es, np.asarray([[0, 5]], np.uint32),
        pti._spec_dyn(es.tree, 1), ["ones"], [1.0], [N], False,
        margin=m0.clone(), base=0.0)
    trees = pti._unpack_trees(packs[0])
    for k in range(1, 6):
        replay = tk.forest_margin_plain(
            b, *_stacked(trees[:k]), torch.full((k,), 0.3), 3, init=m0)
        assert torch.equal(replay, grads[k]), k
    # a number starts every row alike
    base = float(np.float32(0.7))
    np.testing.assert_array_equal(
        tk.forest_margin_plain(b, *_stacked(trees[:2]), torch.full((2,), 0.3),
                               3, init=base),
        tk.forest_margin_plain(b, *_stacked(trees[:2]), torch.full((2,), 0.3),
                               3, init=torch.full((N,), base)))


def test_init_operand_is_checked():
    """`init` is an (n,) f32 tensor on the bins' device, or a number."""
    b = torch.zeros((5, 2), dtype=torch.uint8)
    tabs = [torch.zeros((1, 3), dtype=torch.int32)] * 2 \
        + [torch.ones((1, 3))]
    w = torch.ones(1)
    for bad in (torch.zeros(4), torch.zeros(5, dtype=torch.float64),
                torch.zeros((5, 1))):
        with pytest.raises(ValueError, match="init"):
            tk.forest_traverse(b, *tabs, w, depth=1, init=bad)
    np.testing.assert_array_equal(
        tk.forest_traverse(b, *tabs, w, depth=1, init=2.5).numpy(),
        np.full(5, 3.5, np.float32))


def test_plain_replay_matches_the_jax_replay(spark):
    """`forest_traverse(init=base)` on the CPU against the JAX package's
    `_margin_replay_compiled` on a one-device CPU mesh. XLA's CPU fusion
    contracts the JAX replay's `margin + step * leaf` into one fused
    multiply-add, rounded once; the port rounds the product and the sum
    apart, as its fit's carry does (each package's replay is its own
    fit's carry). So each is held bit for bit to a numpy replay of its
    rounding (float64 products rounded once to f32 for the JAX package),
    and the two to 1e-6: on these rows 373 of 1,200 differ, by at most
    4.8e-7 (34 ulps, at margins near 0)."""
    import jax.numpy as jnp
    from sml_tpu.ml import tree_impl as jti
    from sml_tpu.parallel import mesh as meshlib
    X, y = _data()
    spec = ptm._fit_ensemble(X, y, n_trees=6, **FIT)
    binned = pti.bin_with(X, spec.binning)
    b = torch.from_numpy(binned)
    sf, sb, lv = _stacked(spec.trees)
    got = tk.forest_traverse(b, sf, sb, lv, torch.full((6,), 0.3), depth=3,
                             init=spec.base).numpy()
    with meshlib.use_mesh(meshlib.build_mesh(1)):
        want = np.asarray(jti._margin_replay_compiled(3, 6)(
            jnp.asarray(binned), sf.numpy(), sb.numpy(), lv.numpy(),
            np.float32(spec.base), np.float32(0.3)))[:N]
    step = np.float32(0.3)
    apart = np.full(N, np.float32(spec.base))
    fused = apart.copy()
    for t in range(6):
        leaf = tk.forest_margin_plain(b, sf[t:t + 1], sb[t:t + 1],
                                      lv[t:t + 1], torch.ones(1), 3).numpy()
        apart = apart + (step * leaf).astype(np.float32)
        fused = (fused.astype(np.float64) + np.float64(step)
                 * leaf.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, apart)
    np.testing.assert_array_equal(want, fused)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ----------------------------------------------------------- checkpoints
class Interrupt(RuntimeError):
    pass


def _dying_save(monkeypatch, after: int):
    """BoostCheckpoint.save that raises right after its `after`-th save."""
    real = BoostCheckpoint.save
    calls = [0]

    def save(self, spec, t, meta):
        real(self, spec, t, meta)
        calls[0] += 1
        if calls[0] == after:
            raise Interrupt()
    monkeypatch.setattr(BoostCheckpoint, "save", save)
    return real


def test_checkpoint_resume_mid_boost_equivalence(tmp_path, monkeypatch):
    X, y = _data()
    src = lambda: ArrayChunkSource(X, y, chunk_rows=400)  # noqa: E731
    params = dict(n_trees=6, max_depth=3, max_bins=16, seed=5,
                  step_size=0.3, rounds_per_dispatch=2, device="cpu")
    ckdir = str(tmp_path / "ck")
    full = checkpointed_fit(src(), ckdir, **params)
    assert not os.path.exists(ckdir)   # cleared on success
    real = _dying_save(monkeypatch, after=2)
    with pytest.raises(Interrupt):
        checkpointed_fit(src(), ckdir, **params)
    monkeypatch.setattr(BoostCheckpoint, "save", real)
    partial, meta = BoostCheckpoint(ckdir).load()
    assert len(partial.trees) == 4 and meta["t"] == 4
    before = PROFILER.counters().get("ct.resumes", 0.0)
    resumed = checkpointed_fit(src(), ckdir, **params)
    assert PROFILER.counters().get("ct.resumes", 0.0) == before + 1
    _same(full, resumed)
    assert not os.path.exists(ckdir)


def test_checkpointed_warm_start_resume_and_foreign_guard(tmp_path,
                                                          monkeypatch):
    X, y = _data()
    src = lambda: ArrayChunkSource(X, y, chunk_rows=400)  # noqa: E731
    base_spec = ptm._fit_ensemble(X, y, n_trees=2, **FIT)
    ckdir = str(tmp_path / "ck")
    wargs = dict(n_new_trees=4, seed=5, step_size=0.3,
                 rounds_per_dispatch=2, device="cpu")
    uninterrupted = checkpointed_warm_start(base_spec, src(), ckdir, **wargs)
    assert not os.path.exists(ckdir)
    real = _dying_save(monkeypatch, after=1)
    with pytest.raises(Interrupt):
        checkpointed_warm_start(base_spec, src(), ckdir, **wargs)
    monkeypatch.setattr(BoostCheckpoint, "save", real)
    partial, meta = BoostCheckpoint(ckdir).load()
    assert meta["mode"] == "warm" and len(partial.trees) == 4
    # a fresh checkpointed fit clears the warm checkpoint and equals a
    # fit in a clean directory
    fresh = dict(n_trees=6, max_depth=3, max_bins=16, seed=5,
                 step_size=0.3, rounds_per_dispatch=2, device="cpu")
    clean = checkpointed_fit(src(), str(tmp_path / "other"), **fresh)
    guarded = checkpointed_fit(src(), ckdir, **fresh)
    _same(clean, guarded)
    # a matching warm re-run resumes
    _dying_save(monkeypatch, after=1)
    with pytest.raises(Interrupt):
        checkpointed_warm_start(base_spec, src(), ckdir, **wargs)
    monkeypatch.setattr(BoostCheckpoint, "save", real)
    resumed = checkpointed_warm_start(base_spec, src(), ckdir, **wargs)
    _same(uninterrupted, resumed)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_across_packages(spark, tmp_path, monkeypatch,
                                          writer):
    """A checkpoint the JAX package's checkpointed fit leaves behind
    loads and resumes in the port, and the port's loads in the JAX
    package: the same partial trees, base and edges."""
    from sml_tpu.ct import BoostCheckpoint as JCheckpoint
    from sml_tpu.ct import checkpointed_fit as jcheckpointed_fit
    from sml_tpu.frame._chunks import ArrayChunkSource as JSource
    X, y = _data()
    y = np.round(y * 8) / 8
    params = dict(n_trees=6, max_depth=3, max_bins=16, seed=5,
                  step_size=0.3, rounds_per_dispatch=2)
    ckdir = str(tmp_path / "ck")
    if writer == "jax":
        real = JCheckpoint.save

        def save(self, spec, t, meta):
            real(self, spec, t, meta)
            raise Interrupt()
        monkeypatch.setattr(JCheckpoint, "save", save)
        with pytest.raises(Interrupt):
            jcheckpointed_fit(JSource(X, y, chunk_rows=400), ckdir, **params)
        monkeypatch.setattr(JCheckpoint, "save", real)
    else:
        real = _dying_save(monkeypatch, after=1)
        with pytest.raises(Interrupt):
            checkpointed_fit(ArrayChunkSource(X, y, chunk_rows=400), ckdir,
                             device="cpu", **params)
        monkeypatch.setattr(BoostCheckpoint, "save", real)
    partial, meta = BoostCheckpoint(ckdir).load()
    jpartial, jmeta = JCheckpoint(ckdir).load()
    assert meta == jmeta and meta["t"] == 2 and meta["mode"] == "fresh"
    assert len(partial.trees) == len(jpartial.trees) == 2
    for a, b in zip(partial.trees, jpartial.trees):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.split_bin, b.split_bin)
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    assert partial.base == jpartial.base
    np.testing.assert_array_equal(partial.binning.edges,
                                  jpartial.binning.edges)
    if writer == "jax":
        resumed = checkpointed_fit(ArrayChunkSource(X, y, chunk_rows=400),
                                   ckdir, device="cpu", **params)
        assert len(resumed.trees) == 6 and not os.path.exists(ckdir)
        for a, b in zip(resumed.trees[:2], jpartial.trees):
            np.testing.assert_array_equal(a.leaf_value, b.leaf_value)


# ------------------------------------------------------------- estimator
def test_xgboost_rounds_per_dispatch_fits_the_same_trees():
    from sml_tpu_torch.xgboost import XgboostRegressor
    X, y = _data()
    kw = dict(n_estimators=5, max_depth=3, max_bins=16, learning_rate=0.3,
              random_state=3)
    plain = XgboostRegressor(**kw).fit(X, y, device="cpu")
    before = PROFILER.counters().get("tree.fit_dispatch", 0.0)
    staged = XgboostRegressor(rounds_per_dispatch=2, **kw).fit(
        X, y, device="cpu")
    assert PROFILER.counters()["tree.fit_dispatch"] - before == 3
    assert staged.getOrDefault("rounds_per_dispatch") == 2
    _same(plain._spec, staged._spec)
