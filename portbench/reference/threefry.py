"""The sampled fits' random draws: JAX's Threefry-2x32 streams.

A frozen copy of the published algorithm (Salmon et al., Random123, SC
2011) as `jax.random` 0.9 applies it with `jax_threefry_partitionable`
on and 64-bit types off: keys are pairs of uint32, `fold_in(key, d)`
hashes the counter pair (0, d), element i of a draw hashes (i >> 32,
i & 0xFFFFFFFF) and XORs the two words, a uniform takes the high 23
bits as the mantissa of a float in [1, 2) minus 1, a Poisson count
below rate 10 is Knuth's loop (each pass splits the key and feeds the
second half's uniforms; the log of each uniform is taken in float64 and
rounded to float32), and a node's feature subspace is the k features of
smallest uniform (ties to the lower index).

The forest's keys: round t's row weights draw under
fold_in(fold_in(key, 0), t), and level L's feature masks of round t
under fold_in(fold_in(key, t), L), with key = (0, seed mod 2^32).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r):
    return ((v << r) & MASK) | (v >> (32 - r))


def hash2(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of counters (x1, x2) under key (k1, k2);
    Python ints or int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ((ks[(i + 2) % 3] + i + 1) & MASK)) & MASK
    return x1, x2


def seed_key(seed: int):
    return (0, int(seed) & MASK)


def fold_in(key, data: int):
    return hash2(key[0], key[1], 0, int(data) & MASK)


def split(key):
    return hash2(key[0], key[1], 0, 0), hash2(key[0], key[1], 0, 1)


def uniform(key, n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = hash2(key[0], key[1], i >> 32, i & MASK)
    bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def poisson(key, rate: float, n: int, device) -> torch.Tensor:
    """n Poisson(rate) counts (float32), rate in [0, 10)."""
    lam = torch.tensor(rate, dtype=torch.float32)
    k = torch.zeros(n, dtype=torch.float32, device=device)
    if float(lam) == 0.0:
        return k
    neg = (-lam).to(device)
    log_prod = torch.zeros(n, dtype=torch.float32, device=device)
    while True:
        alive = log_prod > neg
        if not bool(alive.any()):
            return k - 1
        key, sub = split(key)
        k += alive.to(torch.float32)
        u = uniform(sub, n, device)
        log_prod = log_prod + torch.log(u.to(torch.float64)).to(torch.float32)


def row_weights(seed: int, t: int, mode: str, rate: float, n: int,
                device) -> torch.Tensor:
    """Round t's (n,) float32 row weights: ones, or Poisson(rate) counts,
    or Bernoulli(rate) as 0/1."""
    if mode == "ones":
        return torch.ones(n, dtype=torch.float32, device=device)
    key = fold_in(fold_in(seed_key(seed), 0), t)
    if mode == "poisson":
        return poisson(key, rate, n, device)
    if mode == "bernoulli":
        return (uniform(key, n, device)
                < torch.tensor(rate, dtype=torch.float32)).to(torch.float32)
    raise ValueError(f"unknown row-weight mode {mode!r}")


def feature_mask(seed: int, t: int, level: int, width: int, n_features: int,
                 k: int, device) -> torch.Tensor:
    """Round t's level-`level` (width, F) bool mask: a node's k features
    of smallest uniform."""
    key = fold_in(fold_in(seed_key(seed), t), level)
    u = uniform(key, width * n_features, device).view(width, n_features)
    order = torch.argsort(u, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return rank < int(k)
