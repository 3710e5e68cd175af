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
@pytest.mark.parametrize("mode, rate", [("bernoulli", 0.7),
                                        ("poisson", 1.0),
                                        ("poisson", 0.7)])
@pytest.mark.parametrize("t", [0, 1, 19])
def test_round_weights_are_the_jax_fit_draws(mode, rate, t):
    """The weights a round of the port's fit draws
    (`tree_impl.round_weights`) against the JAX fit's own draw under
    `kt = fold_in(fold_in(PRNGKey(seed), 0), t)`."""
    n = 3001
    seed = 17
    kt = jax.random.fold_in(jax.random.fold_in(_jkey(seed), 0), t)
    if mode == "poisson":
        want = np.asarray(jax.random.poisson(kt, rate, (n,)))
        es_kw = dict(bootstrap=True, n_trees=20)
    else:
        want = np.asarray(jax.random.bernoulli(kt, rate, (n,)))
        es_kw = dict(bootstrap=False, n_trees=5)
    spec = pti.TreeSpec(3, 16, 4, 4, 1, 0.0, 0.0, 0.0)
    es = pti.EnsembleSpec(tree=spec, loss="squared", boosting=False,
                          subsample=rate, step_size=0.1, **es_kw)
    key = prng.fold_in(prng.prng_key(seed), 0)
    got = pti.round_weights(key, t, n, es, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_unsampled_rounds_weigh_every_row_once():
    spec = pti.TreeSpec(3, 16, 4, 4, 1, 0.0, 0.0, 0.0)
    for kw in (dict(bootstrap=True, n_trees=1), dict(bootstrap=False,
                                                     n_trees=4)):
        es = pti.EnsembleSpec(tree=spec, loss="squared", boosting=False,
                              subsample=1.0, step_size=0.1, **kw)
        got = pti.round_weights(prng.prng_key(1), 2, 50, es, "cpu")
        assert torch.equal(got, torch.ones(50))


@pytest.mark.parametrize("width, n_feat, k", [(2, 10, 3), (32, 10, 3),
                                              (1, 400, 20)])
def test_feature_mask_wrapper_on_cpu_is_the_plain_draw(width, n_feat, k):
    key = prng.fold_in(prng.fold_in(prng.prng_key(42), 4), 2)
    before = dict(pk.LAUNCHES)
    got = pk.feature_mask(key, width, n_feat, k, "cpu")
    assert got.dtype == torch.float32 and got.shape == (width, n_feat)
    want = _jax_feature_mask(jax.random.wrap_key_data(
        np.asarray(key, np.uint32)), width, n_feat, k)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert pk.LAUNCHES == before   # the plain version is no launch


def test_wrappers_refuse_bad_arguments():
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="mode"):
        pk.row_weights(key, 10, "uniform", 0.5, "cpu")
    with pytest.raises(ValueError, match="Knuth"):
        pk.row_weights(key, 10, "poisson", 12.0, "cpu")
    with pytest.raises(ValueError, match="row count"):
        pk.row_weights(key, -1, "bernoulli", 0.5, "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.row_weights(key, 10, "bernoulli", 0.5, "meta")
    with pytest.raises(ValueError, match="oversized"):
        pk.feature_mask(key, 0, 10, 3, "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.feature_mask(key, 2, 10, 3, "meta")
    assert pk.row_weights(key, 0, "poisson", 1.0, "cpu").shape == (0,)


@pytest.mark.parametrize("n", [1, 255, 256, 80_000, 100_001])
def test_draw_plan_covers_every_row(n):
    plan = pk.draw_plan(n)
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads * plan.blocks >= n > plan.threads * (plan.blocks - 1)


@pytest.mark.parametrize("n_feat", [1, 10, 33, 400, 12_288])
def test_mask_plan_fits_a_block(n_feat):
    plan = pk.mask_plan(n_feat)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.smem == 4 * n_feat <= 48 * 1024


def test_mask_plan_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError, match="12288 features"):
        pk.mask_plan(12_289)
