"""The port's Threefry streams (`sml_tpu_torch.utils.prng`) and its draw
kernels' wrappers (`sml_tpu_torch.native.prng_kernel`) against live
`jax.random` (jax 0.9.0, `jax_threefry_partitionable` on, 64-bit types
off), on the CPU, where the wrappers run their plain versions.

Keys, raw bits, uniforms, Bernoulli draws and feature masks are held
bit for bit. Poisson counts (Knuth's loop) are held equal except at rows
whose jax log-sum came within 2 ulps of -rate: jax adds XLA's f32 log,
the port log in float64 rounded to f32 (on every device, so that the
card and the CPU agree), and only there can the two logs put a row on
different sides of the boundary. The jax log-sums are replayed from the
port's uniforms (held bit-exact above) and `jnp.log`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu_torch.ml import tree_impl as pti
from sml_tpu_torch.native import prng_kernel as pk
from sml_tpu_torch.utils import prng

SHAPES = [(1,), (37,), (4097,), (32, 10)]


def _jkey(seed=17):
    return jax.random.PRNGKey(seed)


def _pair(jkey):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(jkey)))


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", [0, 17, 42, 2 ** 31 - 1, -1, 2 ** 32 + 5])
def test_prng_key_matches_jax(seed):
    assert prng.prng_key(seed) == _pair(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 1, 19, 2 ** 31])
def test_fold_in_matches_jax(data):
    for seed in (0, 42):
        got = prng.fold_in(prng.prng_key(seed), data)
        assert got == _pair(jax.random.fold_in(_jkey(seed), data))


@pytest.mark.parametrize("seed", [0, 17])
def test_split_matches_jax(seed):
    a, b = jax.random.split(_jkey(seed))
    assert prng.split(prng.prng_key(seed)) == (_pair(a), _pair(b))


def test_key_pairs_come_from_any_two_words():
    words = np.asarray(jax.random.key_data(_jkey(3)))
    assert prng.as_key(words) == _pair(_jkey(3))
    assert prng.as_key((-1, 2 ** 32 + 7)) == (0xFFFFFFFF, 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_match_jax(shape):
    want = np.asarray(jax.random.bits(_jkey(), shape, jnp.uint32))
    got = prng.random_bits(prng.prng_key(17), shape, "cpu").numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_jax(shape):
    key = jax.random.fold_in(_jkey(42), 5)
    want = np.asarray(jax.random.uniform(key, shape))
    got = prng.uniform(_pair(key), shape, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("p", [0.3, 0.7, 0.8])
@pytest.mark.parametrize("shape", SHAPES)
def test_bernoulli_matches_jax(shape, p):
    key = jax.random.fold_in(_jkey(0), 3)
    want = np.asarray(jax.random.bernoulli(key, p, shape))
    np.testing.assert_array_equal(prng.bernoulli(_pair(key), p, shape, "cpu")
                                  .numpy(), want)


@pytest.mark.parametrize("n", [1, 37, 4097])
def test_draws_of_n_are_the_prefix_of_longer_draws(n):
    key = prng.fold_in(prng.prng_key(7), 2)
    np.testing.assert_array_equal(prng.uniform(key, n, "cpu").numpy(),
                                  prng.uniform(key, n + 13, "cpu").numpy()[:n])
    np.testing.assert_array_equal(
        prng.poisson_knuth(key, 1.0, n, "cpu").numpy(),
        prng.poisson_knuth(key, 1.0, n + 13, "cpu").numpy()[:n])


def _jax_feature_mask(key, width, n_feat, k):
    """The JAX builder's draw (`sml_tpu/ml/tree_impl.py:551-557`)."""
    u = jax.random.uniform(key, (width, n_feat))
    ranks = jnp.argsort(jnp.argsort(u, axis=1), axis=1)
    return np.asarray(ranks < k)


@pytest.mark.parametrize("width, n_feat, k", [(1, 10, 3), (16, 10, 3),
                                              (32, 6, 2), (4, 400, 20)])
def test_feature_mask_matches_jax(width, n_feat, k):
    key = jax.random.fold_in(jax.random.fold_in(_jkey(42), 1), 3)
    want = _jax_feature_mask(key, width, n_feat, k)
    got = prng.feature_mask(_pair(key), width, n_feat, k, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) == k).all()


def test_feature_ranks_break_ties_by_index_as_jax():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 4, size=(8, 12)).astype(np.float32) / 4
    u[0] = 0.5                         # a row of one value
    u[1, ::2] = u[1, 1::2]             # pairs of equal values
    want = np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(u), axis=1),
                                  axis=1))
    np.testing.assert_array_equal(
        prng.feature_ranks(torch.from_numpy(u)).numpy(), want)
    np.testing.assert_array_equal(want[0], np.arange(12))


def _jax_log_sum_near_boundary(key, lam, n, ulps=2):
    """Rows whose jax log-sum came within `ulps` of -lam at some step of
    Knuth's loop: the loop replayed on the port's uniforms (bit-exact)
    with `jnp.log`, summed in f32 as jax sums it."""
    neg = np.float32(-lam)
    log_prod = np.zeros(n, np.float32)
    near = np.zeros(n, bool)
    rng = key
    while (log_prod > neg).any():
        rng, sub = prng.split(rng)
        u = prng.uniform(sub, n, "cpu").numpy()
        log_prod = log_prod + np.asarray(jnp.log(jnp.asarray(u)))
        gap = np.abs(log_prod.view(np.int32).astype(np.int64)
                     - int(np.asarray(neg).view(np.int32)))
        near |= (log_prod < 0) & (gap <= ulps)
    return near


POISSON_KEYS = [(seed, t) for seed in (0, 17, 42, 7, 1234)
                for t in (0, 19)]


@pytest.mark.parametrize("seed, t", POISSON_KEYS)
def test_poisson_knuth_matches_jax_but_at_the_log_boundary(seed, t):
    """λ=1, 50,000 rows, under the fit's round keys
    `fold_in(fold_in(PRNGKey(seed), 0), t)`."""
    n = 50_000
    key = jax.random.fold_in(jax.random.fold_in(_jkey(seed), 0), t)
    want = np.asarray(jax.random.poisson(key, 1.0, (n,)))
    got = prng.poisson_knuth(_pair(key), 1.0, n, "cpu").numpy()
    differ = np.flatnonzero(got != want)
    near = _jax_log_sum_near_boundary(_pair(key), 1.0, n)
    print(f"seed {seed} round {t}: {differ.size} of {n} counts differ, "
          f"{int(near.sum())} rows within 2 ulps of -1")
    assert near[differ].all(), differ[~near[differ]]
    assert differ.size <= 2
    assert 0.95 < got.mean() < 1.05


def test_poisson_rates_outside_knuths_loop_raise():
    key = prng.prng_key(0)
    assert (prng.poisson_knuth(key, 0.0, 5, "cpu").numpy() == 0).all()
    for lam in (10.0, -0.5, float("nan")):
        with pytest.raises(ValueError, match="Knuth"):
            prng.poisson_knuth(key, lam, 5, "cpu")


# ------------------------------------------------------------ wrappers
def _draws(seeds, modes, rates, counts, n_pad, n_trees=20, depth=3):
    """A fit's draw operands on the CPU for elements keyed by `seeds`."""
    rngs = np.asarray([prng.prng_key(s) for s in seeds], np.uint32)
    return pti.fit_draws(rngs, n_trees, depth, modes, rates, counts, n_pad,
                         "cpu")


@pytest.mark.parametrize("mode, rate", [("bernoulli", 0.7),
                                        ("poisson", 1.0),
                                        ("poisson", 0.7)])
@pytest.mark.parametrize("t", [0, 1, 19])
def test_round_weights_are_the_jax_fit_draws(mode, rate, t):
    """The weights a round of the port's fit draws (round t of
    `tree_impl.round_weights` under the keys of `tree_impl.fit_keys`)
    against the JAX fit's own draw under
    `kt = fold_in(fold_in(PRNGKey(seed), 0), t)`."""
    n = 3001
    seed = 17
    kt = jax.random.fold_in(jax.random.fold_in(_jkey(seed), 0), t)
    if mode == "poisson":
        want = np.asarray(jax.random.poisson(kt, rate, (n,)))
        assert pti.weight_mode(True, 20, rate) == mode
    else:
        want = np.asarray(jax.random.bernoulli(kt, rate, (n,)))
        assert pti.weight_mode(False, 5, rate) == mode
    got = pti.round_weights(_draws([seed], [mode], [rate], [n], n), 0, 20,
                           n)[t].numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_unsampled_rounds_weigh_every_row_once(monkeypatch):
    calls = _count_plain(monkeypatch)
    for kw in (dict(bootstrap=True, n_trees=1), dict(bootstrap=False,
                                                     n_trees=4)):
        mode = pti.weight_mode(subsample=1.0, **kw)
        assert mode == "ones"
        draws = _draws([1], [mode], [1.0], [50], 50)
        assert not draws.sampled
        weights = pti.round_weights(draws, 0, 20, 50)
        assert torch.equal(weights[2], torch.ones(50))
    assert calls["weights"] == []   # nothing sampled, nothing drawn
    # a padded element weighs its padding 0, through the draw
    draws = _draws([1, 2], ["ones", "ones"], [1.0, 1.0], [50, 47], 50)
    got = pti.round_weights(draws, 0, 20, 50)[2]
    assert draws.sampled and got.tolist() == [1.0] * 97 + [0.0] * 3
    assert calls["weights"] == [20]


def test_fit_keys_are_the_jax_fit_keys():
    """Every key of a fit of three elements, derived on the host at once:
    round t's weight key `fold_in(fold_in(rng, 0), t)` and level l's
    mask key `fold_in(fold_in(rng, t), l)` of each element."""
    seeds = (42, 7, 2 ** 31 + 3)
    rngs = np.asarray([prng.prng_key(s) for s in seeds], np.uint32)
    keys = pti.fit_keys(rngs, 4, 3)
    assert keys.shape == (4, 4, 3, 2) and keys.dtype == np.uint32
    for e, seed in enumerate(seeds):
        root = _jkey(seed)
        for t in range(4):
            assert tuple(keys[t, 0, e].tolist()) == _pair(
                jax.random.fold_in(jax.random.fold_in(root, 0), t))
            for level in range(3):
                assert tuple(keys[t, 1 + level, e].tolist()) == _pair(
                    jax.random.fold_in(jax.random.fold_in(root, t), level))


def test_batched_row_weights_match_jax_element_by_element():
    """One round of five elements of mixed mode and rate and of
    different row counts: each element's block equals its own jax draw
    over its rows (a Poisson count off only within 2 ulps of -rate) and
    0 on the padding."""
    n_pad = 4001
    seeds = (0, 17, 42, 7, 1234)
    modes = ["poisson", "bernoulli", "ones", "poisson", "bernoulli"]
    rates = [1.0, 0.7, 1.0, 0.5, 0.3]
    counts = [4001, 3999, 4000, 2500, 4001]
    draws = _draws(seeds, modes, rates, counts, n_pad, n_trees=4)
    t = 3
    before = dict(pk.LAUNCHES)
    got = pti.round_weights(draws, t, 4, n_pad)[t].numpy().reshape(5, n_pad)
    assert pk.LAUNCHES == before   # the plain version is no launch
    for e, (seed, mode, rate, n) in enumerate(zip(seeds, modes, rates,
                                                  counts)):
        kt = jax.random.fold_in(jax.random.fold_in(_jkey(seed), 0), t)
        if mode == "poisson":
            want = np.asarray(jax.random.poisson(kt, rate, (n_pad,)))
        elif mode == "bernoulli":
            want = np.asarray(jax.random.bernoulli(kt, rate, (n_pad,)))
        else:
            want = np.ones(n_pad)
        want = want.astype(np.float32)
        want[n:] = 0.0
        differ = np.flatnonzero(got[e] != want)
        if mode == "poisson":
            near = _jax_log_sum_near_boundary(_pair(kt), rate, n_pad)
            assert near[differ].all(), differ
        else:
            assert differ.size == 0, (mode, differ)


def _level_rows(E, level):
    """Round rows of level `level` in a whole-fit mask (level-major)."""
    return slice(E * (2 ** level - 1), E * (2 ** (level + 1) - 1))


def test_batched_feature_mask_matches_jax_element_by_element():
    """A round's masks of four elements with their own k, side by side:
    element e's nodes of every level are its own jax draw under its
    level key."""
    D, n_feat = 4, 10
    seeds, ks = (42, 1, 17, 3), [3, 10, 1, 5]
    keys = [[jax.random.fold_in(jax.random.fold_in(_jkey(s), 2), level)
             for s in seeds] for level in range(D)]
    kt = torch.tensor([[[_pair(k) for k in row] for row in keys]],
                      dtype=torch.uint32)
    got = pk.fit_feature_masks(kt, torch.tensor(ks, dtype=torch.int32),
                               n_feat)
    assert got.dtype == torch.float32 and got.shape == (1, 4 * 15, n_feat)
    for level in range(D):
        width = 2 ** level
        block = got[0, _level_rows(4, level)]
        for e, k in enumerate(ks):
            want = _jax_feature_mask(keys[level][e], width, n_feat, k)
            np.testing.assert_array_equal(
                block[e * width:(e + 1) * width].numpy(),
                want.astype(np.float32))


@pytest.mark.parametrize("width, n_feat, k", [(2, 10, 3), (32, 10, 3),
                                              (1, 400, 20)])
def test_feature_mask_wrapper_on_cpu_is_the_plain_draw(width, n_feat, k):
    """The whole-fit wrapper on the CPU: a round of levels 0 .. log2(W)
    under one fit's keys, its last level the jax draw, and no launch."""
    D = width.bit_length()
    key = prng.fold_in(prng.prng_key(42), 4)
    keys = torch.tensor([[[prng.fold_in(key, level)] for level in range(D)]],
                        dtype=torch.uint32)
    before = dict(pk.LAUNCHES)
    got = pk.fit_feature_masks(keys, torch.tensor([k], dtype=torch.int32),
                               n_feat)
    assert got.dtype == torch.float32 and got.shape == (1, 2 * width - 1,
                                                        n_feat)
    want = _jax_feature_mask(jax.random.wrap_key_data(
        np.asarray(prng.fold_in(key, D - 1), np.uint32)), width, n_feat, k)
    np.testing.assert_array_equal(got[0, width - 1:].numpy(),
                                  want.astype(np.float32))
    assert pk.LAUNCHES == before   # the plain version is no launch


def test_wrappers_refuse_bad_arguments():
    key = torch.tensor([[prng.prng_key(0)]], dtype=torch.uint32)
    mkey = key[:, None]
    k = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        pk.weight_table(["uniform"], [0.5], [10], "cpu")
    with pytest.raises(ValueError, match="Knuth"):
        pk.weight_table(["poisson"], [12.0], [10], "cpu")
    with pytest.raises(ValueError, match="row count"):
        pk.weight_table(["bernoulli"], [0.5], [-1], "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.weight_table(["bernoulli"], [0.5], [10], "meta")
    table = pk.weight_table(["bernoulli"], [0.5], [10], "cpu")
    with pytest.raises(TypeError, match="uint32"):
        pk.fit_row_weights(key.to(torch.int64), *table, 10)
    with pytest.raises(TypeError, match="uint32"):
        pk.fit_row_weights(key[0], *table, 10)          # no round axis
    with pytest.raises(TypeError, match="per-element"):
        pk.fit_row_weights(torch.cat([key, key], dim=1), *table, 10)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.fit_row_weights(key.to("meta"), *(t.to("meta") for t in table),
                           10)
    with pytest.raises(ValueError, match="contiguous"):  # a round's keys
        pk.fit_row_weights(torch.cat([key, key], dim=2)[:, :, ::2], *table,
                           10)
    with pytest.raises(ValueError, match="65535"):
        pk.fit_row_weights(key.expand(70_000, 1, 2).contiguous(), *table,
                           10)
    with pytest.raises(ValueError, match="oversized"):
        pk.fit_feature_masks(mkey, k, 0)
    with pytest.raises(ValueError, match="oversized"):
        pk.fit_feature_masks(mkey[:, :0], k, 10)        # no level
    with pytest.raises(TypeError, match="uint32"):
        pk.fit_feature_masks(key, k, 10)                # no level axis
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.fit_feature_masks(mkey.to("meta"), k.to("meta"), 10)
    assert pk.fit_row_weights(key, *table, 0).shape == (1, 0)
    assert pk.fit_row_weights(key[:0], *table, 10).shape == (0, 10)
    assert pk.fit_feature_masks(mkey[:0], k, 10).shape == (0, 1, 10)


@pytest.mark.parametrize("n", [1, 255, 256, 80_000, 100_001])
def test_draw_plan_covers_every_row(n):
    for lines in (1, 2, 4, 7, 14, 20, 40, 240, 65_535):
        for sms in (1, 114, 132):
            plan = pk.draw_plan(n, lines, sms)
            assert plan.threads % 32 == 0 and plan.threads <= 256
            assert plan.rows in (1, 2, 4, 8)
            per_block = plan.threads * plan.rows
            assert per_block * plan.blocks >= n > per_block * (plan.blocks
                                                               - 1)
            # the most rows a thread that still leaves 1,024 threads an SM
            if plan.rows > 1:
                assert lines * plan.blocks * plan.threads >= 1024 * sms
            if plan.rows < 8:   # and twice the rows would not
                blocks = -(-n // (plan.threads * 2 * plan.rows))
                assert lines * blocks * plan.threads < 1024 * sms


def test_draw_plan_rows_a_thread_at_the_main_paths_shapes():
    """On an H100's 132 SMs: 8 rows a thread over a whole sampled fit, and
    fewer over a round or a few, where 8 would leave SMs idle."""
    assert pk.draw_plan(80_000, 20, 132).rows == 8         # ML 07 RF
    assert pk.draw_plan(80_000, 40, 132).rows == 8         # ML 11 subsample
    assert pk.draw_plan(53_334, 20 * 12, 132).rows == 8    # the fused grid
    assert pk.draw_plan(53_334, 12, 132).rows == 4         # one fused round
    assert pk.draw_plan(80_000, 4, 132).rows == 2
    assert pk.draw_plan(80_000, 1, 132).rows == 1          # one round
    assert pk.draw_plan(37, 3, 132) == pk.DrawPlan(256, 1, 1)


@pytest.mark.parametrize("n_feat", [1, 10, 32, 33, 400, 12_288])
def test_mask_plan_fits_a_block(n_feat):
    for n_nodes in (1, 63, 20 * 63, 20 * 12 * 31):
        plan = pk.mask_plan(n_nodes, n_feat)
        assert 1 <= plan.warps <= 8 and plan.warps * plan.blocks >= n_nodes
        assert plan.warps * (plan.blocks - 1) < n_nodes
        assert plan.smem == (0 if n_feat <= 32 else 4 * n_feat * plan.warps)
        assert plan.smem <= 48 * 1024


def test_mask_plan_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError, match="12288 features"):
        pk.mask_plan(1, 12_289)


# ------------------------------------------------------------ whole fits
def _count_plain(monkeypatch):
    """Records the round count of every whole-fit draw (the plain
    versions run here; on the card each call is one launch)."""
    calls = {"weights": [], "masks": []}
    for name, what in (("fit_row_weights_plain", "weights"),
                       ("fit_feature_masks_plain", "masks")):
        def counted(keys, *a, _fn=getattr(pk, name), _what=what):
            calls[_what].append(int(keys.shape[0]))
            return _fn(keys, *a)
        monkeypatch.setattr(pk, name, counted)
    return calls


#: three elements of mixed mode and rate, the shorter two padded
FIT_SEEDS = (5, 17, 42)
FIT_MODES = (("poisson", 1.0), ("bernoulli", 0.7), ("poisson", 0.5))
FIT_COUNTS = (601, 580, 333)
FIT_KS = (3, 1, 7)


@pytest.mark.parametrize("t0", [0, 3])
@pytest.mark.parametrize("n_feat", [10, 40])
def test_whole_fit_draws_are_the_per_round_and_per_level_draws(t0, n_feat):
    """Rounds t0 .. T-1 of a fit of E = 3 elements drawn at once (as a
    fresh fit and as a warm start from round 3) equal round t's
    `row_weights_plain` and level L's `feature_mask_plain` under the same
    keys, bit for bit, for masks within a warp (F = 10) and past it
    (F = 40)."""
    T, D, n_pad = 6, 4, 601
    draws = _draws(FIT_SEEDS, [m for m, _ in FIT_MODES],
                   [r for _, r in FIT_MODES], list(FIT_COUNTS), n_pad,
                   n_trees=T, depth=D)
    ks = torch.tensor(FIT_KS, dtype=torch.int32)
    weights = pk.fit_row_weights(draws.keys[t0:, 0], draws.modes,
                                 draws.rates, draws.counts, n_pad)
    masks = pk.fit_feature_masks(draws.keys[t0:, 1:], ks, n_feat)
    assert weights.shape == (T - t0, 3 * n_pad)
    assert masks.shape == (T - t0, 3 * (2 ** D - 1), n_feat)
    rounds = pti.round_weights(draws, t0, T, n_pad)
    levels = pti.round_masks(draws, t0, T, ks, n_feat)
    for t in range(t0, T):
        want = pk.row_weights_plain(draws.keys[t, 0], draws.modes,
                                    draws.rates, draws.counts, n_pad)
        assert torch.equal(weights[t - t0], want)
        assert torch.equal(rounds[t], want)
        assert torch.equal(levels[t], masks[t - t0])
        assert (want.view(3, n_pad)[1, FIT_COUNTS[1]:] == 0).all()
        for level in range(D):
            np.testing.assert_array_equal(
                masks[t - t0, _level_rows(3, level)].numpy(),
                pk.feature_mask_plain(draws.keys[t, 1 + level], ks,
                                      2 ** level, n_feat).numpy())
    assert (masks.sum(2).view(T - t0, -1) > 0).all()


@pytest.mark.parametrize("n_feat", [10, 40])
def test_whole_fit_draws_are_the_jax_fit_draws(n_feat):
    """The same whole-fit draws against jax's own per round and per level:
    `poisson` / `bernoulli` under `fold_in(fold_in(key, 0), t)` (a
    Poisson count off only within 2 ulps of -rate) and the ranks of
    `uniform(fold_in(fold_in(key, t), level), (width, F))`, from a warm
    start at round 2."""
    T, D, n_pad, t0 = 5, 3, 601, 2
    draws = _draws(FIT_SEEDS, [m for m, _ in FIT_MODES],
                   [r for _, r in FIT_MODES], list(FIT_COUNTS), n_pad,
                   n_trees=T, depth=D)
    ks = torch.tensor(FIT_KS, dtype=torch.int32)
    weights = pk.fit_row_weights(draws.keys[t0:, 0], draws.modes,
                                 draws.rates, draws.counts, n_pad).numpy()
    masks = pk.fit_feature_masks(draws.keys[t0:, 1:], ks, n_feat).numpy()
    for e, (seed, (mode, rate), n, k) in enumerate(zip(
            FIT_SEEDS, FIT_MODES, FIT_COUNTS, FIT_KS)):
        root = _jkey(seed)
        for t in range(t0, T):
            kt = jax.random.fold_in(jax.random.fold_in(root, 0), t)
            got = weights[t - t0, e * n_pad:(e + 1) * n_pad]
            draw = jax.random.poisson if mode == "poisson" \
                else jax.random.bernoulli
            want = np.asarray(draw(kt, rate, (n_pad,))).astype(np.float32)
            want[n:] = 0.0
            differ = np.flatnonzero(got != want)
            if mode == "poisson":
                near = _jax_log_sum_near_boundary(_pair(kt), rate, n_pad)
                assert near[differ].all(), differ
            else:
                assert differ.size == 0, differ
            for level in range(D):
                width = 2 ** level
                lk = jax.random.fold_in(jax.random.fold_in(root, t), level)
                block = masks[t - t0, _level_rows(3, level)]
                np.testing.assert_array_equal(
                    block[e * width:(e + 1) * width],
                    _jax_feature_mask(lk, width, n_feat, k)
                    .astype(np.float32))


def test_rounds_past_the_draw_block_draw_in_blocks(monkeypatch):
    """A fit whose weights or masks pass `DRAW_BLOCK_BYTES` draws them in
    blocks of rounds, one call a block, with the same bits."""
    n_pad, T, D, F = 601, 7, 3, 10
    draws = _draws(FIT_SEEDS, [m for m, _ in FIT_MODES],
                   [r for _, r in FIT_MODES], list(FIT_COUNTS), n_pad,
                   n_trees=T, depth=D)
    ks = torch.tensor(FIT_KS, dtype=torch.int32)
    whole = pti.round_weights(draws, 1, T, n_pad)
    whole_masks = pti.round_masks(draws, 1, T, ks, F)
    assert whole.per_block == 65535 // 3 and whole_masks.per_block >= T
    assert pti.block_rounds(10 ** 9) == 1
    assert pti.block_rounds(4, 30_000) == 2   # the kernel's grid rows
    calls = _count_plain(monkeypatch)
    # two rounds of weights a block; two rounds of masks a block
    for block_bytes in (2 * 3 * n_pad * 4, 2 * 4 * 3 * (2 ** D - 1) * F):
        monkeypatch.setattr(pti, "DRAW_BLOCK_BYTES", block_bytes)
        rounds = pti.round_weights(draws, 1, T, n_pad)
        masks = pti.round_masks(draws, 1, T, ks, F)
        for t in range(1, T):
            assert torch.equal(rounds[t], whole[t])
            assert torch.equal(masks[t], whole_masks[t])
    assert calls == {"weights": [2, 2, 2, 1, 1, 1, 1, 1, 1],
                     "masks": [6, 2, 2, 2]}


@pytest.fixture()
def xla_fits(spark):
    """The JAX fits on the XLA path with histogram subtraction, as the
    port builds; both keys restored after each test."""
    from sml_tpu.conf import GLOBAL_CONF as JCONF
    keys = ("sml.tree.kernel", "sml.tree.histSubtraction")
    prev = {k: JCONF.get(k) for k in keys}
    JCONF.set("sml.tree.kernel", "xla")
    JCONF.set("sml.tree.histSubtraction", True)
    yield
    for k, v in prev.items():
        JCONF.set(k, v)


#: an RF (bootstrap and a feature subspace) and a subsampled XGBoost,
#: as `tests/test_torch_fit.py::test_sampled_fits_give_the_jax_split_tables`
#: fits them, and the whole-fit draws each makes
ONE_DRAW_FITS = {
    "rf_bootstrap": (dict(max_depth=4, n_trees=5, bootstrap=True,
                          feature_k=2, loss="squared"), [5], [5]),
    "xgb_subsample": (dict(max_depth=4, n_trees=5, subsample=0.7,
                           loss="squared", boosting=True, step_size=0.3,
                           reg_lambda=1.0, gamma=0.1), [5], []),
}


@pytest.mark.parametrize("kind", sorted(ONE_DRAW_FITS))
def test_a_sampled_fit_draws_once(xla_fits, monkeypatch, kind):
    """A CPU RF fit and a subsampled XGBoost fit make one whole-fit draw
    of each kind they need (weights of all 5 rounds; the forest's masks
    of all 5 rounds), and their split tables are the JAX package's."""
    from sml_tpu.ml._tree_models import _fit_ensemble as jfit
    from sml_tpu_torch.ml import _tree_models as ptm
    rng = np.random.default_rng(4)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    X[:, 4] = rng.integers(0, 5, 3000)
    y = (np.round(8 * (X[:, 0] + 0.5 * X[:, 1] ** 2)) / 8) \
        .astype(np.float32)
    spec, weights, masks = ONE_DRAW_FITS[kind]
    kw = dict(spec, categorical={4: 5}, max_bins=24, min_instances=1,
              min_info_gain=0.0, seed=5,
              **{k: v for k, v in dict(feature_k=None, bootstrap=False,
                                       subsample=1.0).items()
                 if k not in spec})
    sj = jfit(X, y, **kw)
    calls = _count_plain(monkeypatch)
    sp = ptm._fit_ensemble(X, y, device="cpu", **kw)
    assert calls == {"weights": weights, "masks": masks}
    for tj, tp in zip(sj.trees, sp.trees):
        np.testing.assert_array_equal(tp.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tp.split_bin, tj.split_bin)


def test_a_warm_start_draws_only_its_own_rounds(monkeypatch):
    """Appending rounds 3 .. 5 to 3 saved ones draws the weights of those
    three rounds in one call, and grows the trees of a 6-round fit."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(800, 5)).astype(np.float32)
    y = (X[:, 0] - X[:, 2] ** 2).astype(np.float32)
    binned, _ = pti.make_bins(X, y, 16)
    b, yt = torch.from_numpy(binned), torch.from_numpy(y)
    es = pti.EnsembleSpec(tree=pti.TreeSpec(3, 16, 5, 5, 1, 0.0, 1.0, 0.0),
                          n_trees=6, loss="squared", boosting=True,
                          bootstrap=False, subsample=0.8, step_size=0.3)
    full, base = pti.fit_ensemble_on_device(b, yt, es, seed=9)
    head = pti.fit_ensemble_on_device(b, yt, es._replace(n_trees=3),
                                      seed=9)[0]
    calls = _count_plain(monkeypatch)
    tail, _ = pti.resume_ensemble_on_device(b, yt, es, 9, head, base)
    assert calls == {"weights": [3], "masks": []}
    for tf, tp in zip(full[3:], tail):
        np.testing.assert_array_equal(tp.split_feature, tf.split_feature)
        np.testing.assert_array_equal(tp.leaf_value, tf.leaf_value)
