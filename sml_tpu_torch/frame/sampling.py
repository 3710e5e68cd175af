"""Spark's randomSplit sampler, draw for draw.

The port's copy of `sml_tpu/frame/sampling.py`:

- `Dataset.randomSplit` first sorts each partition locally by every
  sortable column ascending (to make per-partition row order
  deterministic), then samples each weight cell (`presplit_sort`).
- Each cell is a `BernoulliCellSampler(lb, ub)`: one uniform draw per
  row, the row kept iff `lb <= x < ub`.
- The per-partition RNG is `XORShiftRandom` seeded with
  `seed + partitionIndex`, whose init scrambles the seed through
  MurmurHash3 of a 64-BYTE buffer (`ByteBuffer.allocate(java.lang.
  Long.SIZE)`, where `Long.SIZE` is 64 bits: the 8 big-endian seed bytes
  followed by 56 zeros, with length-64 finalization), and whose
  `nextDouble` is java.util.Random's two-word construction over the
  XORShift `next(bits)` (`hash_seed`, `XORShiftRandom`).

`row_uniforms` is not Spark's sampler: it is the chunked data plane's
random-access draw (`frame/_chunks.py`), one uniform per global row
index, so split and fold membership do not depend on how a source is
chunked.

`partition_uniforms` draws the stream in the C++ library
`csrc/xorshift.cc`, built with g++ at first use; a build that fails
raises. `XORShiftRandom` is its pure-Python reference, for the tests.

Frames store SQL NULL as NaN (float columns) or None (object columns),
and the pre-split sort places them first, as the JAX package's pandas
sort (`na_position="first"`) does; Spark places a true NaN last. String
columns sort by code point, which is Spark's UTF-8 binary order.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np

from ..native import build
from ..native.hashing import null_mask

# scala.util.hashing.MurmurHash3.bytesHash over the buffer Spark builds in
# XORShiftRandom.hashSeed. Words are read little-endian (scala bytesHash);
# 64 bytes = 16 full words, no tail. The 56 zero words are NOT no-ops:
# each word still rotates and remixes h, and finalization xors the length.
_ARRAY_SEED = 0x3C074A61  # scala.util.hashing.MurmurHash3.arraySeed

_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _mm3_bytes(data: bytes, seed: int) -> int:
    """murmur3_x86_32 over a word-aligned buffer (scala bytesHash
    semantics: little-endian words, length-xor finalization)."""
    h = seed & _M
    for i in range(0, len(data), 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * 0xCC9E2D51) & _M
        k = _rotl(k, 15)
        k = (k * 0x1B873593) & _M
        h ^= k
        h = _rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & _M
    h ^= len(data)  # finalize with length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M
    h ^= h >> 16
    return h


def hash_seed(seed: int) -> int:
    """XORShiftRandom.hashSeed: two chained MurmurHash3 passes over the
    64-byte buffer Spark hashes (the seed's 8 big-endian bytes plus 56
    zeros, finalized with length 64) -> the 64-bit initial state."""
    data = (seed & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big") + b"\x00" * 56
    low = _mm3_bytes(data, _ARRAY_SEED)
    high = _mm3_bytes(data, low)
    return ((high << 32) | low) & 0xFFFFFFFFFFFFFFFF


class XORShiftRandom:
    """Pure-Python reference of the C++ draw (`partition_uniforms`)."""

    def __init__(self, seed: int):
        self._s = hash_seed(seed)

    def _next(self, bits: int) -> int:
        s = self._s
        x = (s ^ (s << 21)) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 35
        x = (x ^ (x << 4)) & 0xFFFFFFFFFFFFFFFF
        self._s = x
        return x & ((1 << bits) - 1)

    def next_double(self) -> float:
        return ((self._next(26) << 27) + self._next(27)) * (2.0 ** -53)


_fill: list = []
_lock = threading.Lock()


def _fill_doubles():
    with _lock:
        if not _fill:
            fn = build.load("xorshift").xorshift_fill_doubles
            fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.POINTER(ctypes.c_double)]
            fn.restype = None
            _fill.append(fn)
        return _fill[0]


def partition_uniforms(seed: int, partition_index: int, n: int) -> np.ndarray:
    """The n sequential nextDouble draws Spark's sampler makes for one
    partition: XORShiftRandom(seed + partitionIndex). Every weight cell
    of one randomSplit re-draws this same sequence (Spark seeds each
    cell's sampler identically), which makes the splits disjoint and
    exhaustive."""
    out = np.empty(n, dtype=np.float64)
    if n == 0:
        return out
    hashed = hash_seed(seed + partition_index)
    _fill_doubles()(
        ctypes.c_longlong(hashed - (1 << 64) if hashed >= (1 << 63)
                          else hashed),
        ctypes.c_longlong(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def partition_uniforms_plain(seed: int, partition_index: int,
                             n: int) -> np.ndarray:
    """`partition_uniforms` through `XORShiftRandom`, in Python."""
    rng = XORShiftRandom(seed + partition_index)
    return np.fromiter((rng.next_double() for _ in range(n)),
                       dtype=np.float64, count=n)


def stable_order(values: np.ndarray, descending: bool = False,
                 nulls_first: bool = True) -> np.ndarray:
    """The stable ascending (or descending) order of one column with its
    nulls (NaN, None) together first or last: ties keep their row order.
    Raises TypeError for an object column whose values do not compare."""
    nulls = null_mask(values)
    idx_null = np.flatnonzero(nulls)
    idx_ok = np.flatnonzero(~nulls)
    vals = values[idx_ok]
    if vals.dtype.kind == "O":
        # text compares by code point in C; other objects as they are
        text = vals.astype(str)
        if np.equal(text, vals).all():
            vals = text
    if descending:
        # ranks of the distinct values, negated: ties stay in row order
        _, inv = np.unique(vals, return_inverse=True)
        vals = -inv.reshape(-1)
    idx_ok = idx_ok[np.argsort(vals, kind="stable")]
    parts = (idx_null, idx_ok) if nulls_first else (idx_ok, idx_null)
    return np.concatenate(parts)


def sort_keys(block: Dict[str, np.ndarray], keys, descending=None,
              nulls_first: bool = True) -> np.ndarray:
    """The row order of a stable multi-key sort: a stable sort by the
    last key, then the one before it, and so on (the order pandas'
    `sort_values(keys, kind="stable")` gives)."""
    n = len(block[keys[0]]) if keys else 0
    order = np.arange(n)
    desc = list(descending) if descending is not None else [False] * len(keys)
    for key, d in reversed(list(zip(keys, desc))):
        order = order[stable_order(block[key][order], d, nulls_first)]
    return order


def presplit_sort(block: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Dataset.randomSplit's per-partition local sort: every sortable
    column ascending, in schema order, nulls first, making the row order
    deterministic whatever the upstream partition layout. Vector (2-D)
    columns are pruned from the sort order, as Spark prunes unsortable
    types; an object column whose values do not compare is dropped from
    the end of the keys, one at a time, as the JAX package does."""
    keys = [c for c, v in block.items()
            if v.ndim == 1 and v.dtype.kind in "ifubMmOU"]
    while keys:
        try:
            order = sort_keys(block, keys)
        except TypeError:
            keys.pop()
            continue
        return {c: v[order] for c, v in block.items()}
    return block


# ----------------------------------------------------- stateless per-row draws
_U64 = np.uint64
_SPLITMIX_GAMMA = 0x9E3779B97F4A7C15  # splitmix64's golden-gamma increment


def row_uniforms(seed: int, start: int, n: int) -> np.ndarray:
    """A uniform [0, 1) float64 per global row index in [start, start +
    n): the splitmix64 finalizer over a (seed, index) counter, so any
    chunk draws its own rows with no sequential state and every row's
    value is the same whatever chunking asked."""
    if n == 0:
        return np.empty(0, dtype=np.float64)
    idx = np.arange(start, start + n, dtype=np.uint64)
    z = (_U64((int(seed) * 0xD1B54A32D192ED03) & 0xFFFFFFFFFFFFFFFF)
         + (idx + _U64(1)) * _U64(_SPLITMIX_GAMMA))
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    z = z ^ (z >> _U64(31))
    # the top 53 bits as a double in [0, 1)
    return (z >> _U64(11)).astype(np.float64) * (2.0 ** -53)
