"""Threefry-2x32 random streams that reproduce jax 0.9.0's draws.

Counterpart of the `jax.random` calls of the JAX package's sampled tree
fits (`sml_tpu/ml/tree_impl.py`): `PRNGKey`, `fold_in`, `split`, and
`uniform`, `bernoulli`, `poisson` and the feature-subspace ranks, under
jax's default `jax_threefry_partitionable=True` with 64-bit types off.

- Host key arithmetic: a key is a pair `(k1, k2)` of Python ints in
  [0, 2**32). `prng_key`, `fold_in` and `split` derive each round's and
  each level's key on the host, with no device work; `fold_in_keys` does
  it for a whole array of keys at once (numpy), as a fused fit derives
  every key of its elements, rounds and levels.
- Plain tensor versions on any device (`random_bits`, `uniform`,
  `bernoulli`, `poisson_knuth`, `feature_mask`): uint32 arithmetic
  emulated in int64 and masked after each add and rotate. They are the
  reference that the tests hold against live `jax.random`, and the plain
  versions of the draw kernels (`native/prng_kernel.py`). Nothing on the
  card's main path calls them.

Element i of a draw hashes the counter pair (i >> 32, i & 0xFFFFFFFF) of
its flat index, so it depends on i alone: a draw of n values is the first
n values of any longer draw under the same key.

Poisson draws are Knuth's loop, as jax runs it for a rate below 10. Its
log is `log` in float64 rounded to f32, here and in the kernel: XLA's f32
log on the CPU is not correctly rounded and torch's f32 log differs from
both, so no f32 log would let the card and the CPU agree. A count can
then differ from jax's only where a row's running f32 log-sum lies
within an ulp or two of -rate.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
#: the rotations of Threefry-2x32's even and odd groups of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the key-schedule parity constant
KS_PARITY = 0x1BD11BDA
#: the largest rate Knuth's loop serves (jax samples rates of 10 and
#: above by rejection, which is not ported)
KNUTH_MAX_RATE = 10.0

Key = Tuple[int, int]


def as_key(key: Union[Key, Sequence[int]]) -> Key:
    """A key as a pair of Python ints (from ints, numpy uint32 or a
    jax-style `key_data` array of two)."""
    k1, k2 = key
    return int(k1) & MASK32, int(k2) & MASK32


def _rotl(v, r: int):
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(key: Key, x1, x2):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under `key`
    (20 rounds, a key injection after every four). Works alike on Python
    ints, non-negative integer numpy arrays and int64 tensors holding
    values in [0, 2**32); returns the pair of hashed words."""
    k1, k2 = as_key(key)
    return _threefry(k1, k2, x1, x2)


def _threefry(k1, k2, x1, x2):
    """The hash on keys and counters of any of the types above (the keys
    may be uint64 numpy arrays too)."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ((ks[(i + 2) % 3] + i + 1) & MASK32)) & MASK32
    return x1, x2


def prng_key(seed: int) -> Key:
    """`key_data(PRNGKey(seed))` with 64-bit types off: jax keeps only
    the low 32 bits of the seed, so the high word is always 0."""
    return 0, int(seed) & MASK32


def fold_in(key: Key, data: int) -> Key:
    """`fold_in(key, data)`: the hash of the pair (0, data as uint32)."""
    return threefry2x32(key, 0, int(data) & MASK32)


def fold_in_keys(keys, data) -> np.ndarray:
    """`fold_in` of an array of keys (..., 2) with `data` (an int or an
    array broadcasting against keys[..., 0]): (..., 2) uint32."""
    k = np.asarray(keys, np.uint64) & MASK32
    x2 = np.asarray(data, np.int64).astype(np.uint64) & MASK32
    h1, h2 = _threefry(k[..., 0], k[..., 1], np.zeros_like(x2), x2)
    return np.stack(np.broadcast_arrays(h1, h2), axis=-1).astype(np.uint32)


def split(key: Key) -> Tuple[Key, Key]:
    """`split(key)` into two keys: the hashes of the counters (0, 0) and
    (0, 1)."""
    return threefry2x32(key, 0, 0), threefry2x32(key, 0, 1)


def random_bits(key: Key, shape, device) -> torch.Tensor:
    """32 random bits per element of `shape` (an int or a tuple), as
    int64 in [0, 2**32): the two hashed words of each flat index, XORed."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, idx >> 32, idx & MASK32)
    return (b1 ^ b2).reshape(shape)


def uniform(key: Key, shape, device) -> torch.Tensor:
    """f32 uniforms in [0, 1): the high 23 bits of each element's random
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """Bernoulli(p) draws (bool) of `shape`: a uniform below p, compared
    in f32."""
    p32 = torch.tensor(p, dtype=torch.float32)
    return uniform(key, shape, device) < p32.to(device)


def log_f32(u: torch.Tensor) -> torch.Tensor:
    """log of f32 values, taken in float64 and rounded to f32 once (the
    log both the plain Poisson draw and the kernel use)."""
    return torch.log(u.to(torch.float64)).to(torch.float32)


def poisson_knuth(key: Key, lam: float, n: int, device) -> torch.Tensor:
    """n Poisson(lam) counts (int32) by Knuth's loop, as jax's `poisson`
    draws a rate below 10: each pass splits the running key (the second
    half feeds this pass's uniforms), counts every row whose f32 log-sum
    is still above -lam, and adds that row's `log_f32(uniform)`; a row
    ends with its count minus 1. Loops until no row is above -lam."""
    lam32 = torch.tensor(lam, dtype=torch.float32)
    if not 0.0 <= float(lam32) < KNUTH_MAX_RATE:
        raise ValueError(f"Poisson rates are drawn by Knuth's loop only "
                         f"in [0, {KNUTH_MAX_RATE}), got {lam}")
    k = torch.zeros(n, dtype=torch.int32, device=device)
    if float(lam32) == 0.0:
        return k
    neg = (-lam32).to(device)
    log_prod = torch.zeros(n, dtype=torch.float32, device=device)
    rng = as_key(key)
    while True:
        alive = log_prod > neg
        if not bool(alive.any()):
            return k - 1
        rng, sub = split(rng)
        k += alive.to(torch.int32)
        log_prod = log_prod + log_f32(uniform(sub, n, device))


def feature_ranks(u: torch.Tensor) -> torch.Tensor:
    """Each element's rank within its row, ties broken by index:
    `argsort(argsort(u))` with a stable sort."""
    order = torch.argsort(u, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def feature_mask(key: Key, width: int, n_features: int, k: int,
                 device) -> torch.Tensor:
    """The (width, n_features) bool mask of the features each node may
    split on: (width, F) uniforms, and a feature is a candidate where its
    rank in its node's row is below k."""
    u = uniform(key, (width, n_features), device)
    return feature_ranks(u) < int(k)
