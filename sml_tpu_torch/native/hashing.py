"""Spark-semantics Murmur3 hashing over numpy columns, through the C++
library `csrc/murmur3.cc`.

The port's copy of `sml_tpu/native/hashing.py`. It drives the `hash()`
column function, hash-partitioned shuffles (`repartition` by columns,
`dropDuplicates`). Multi-column hashing chains: the running hash starts
at seed 42 and each column's hash uses the previous one as its seed; a
null leaves the running hash unchanged. Integers of 4 bytes or fewer
hash as Spark ints, wider ones as longs; floats hash their bits (f32 as
an int, f64 as a long, -0.0 as 0.0); booleans as ints; anything else as
the UTF-8 bytes of `str(value)`.

The library is built with g++ at first use (`native/build.py`); a build
that fails raises. The NumPy and pure-Python versions below
(`hash_column_plain`) are the reference the tests hold the library to;
nothing falls back to them.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterable, Optional

import numpy as np

from . import build

SEED = 42

_fns: dict = {}
_lock = threading.Lock()


def _lib() -> dict:
    with _lock:
        if not _fns:
            lib = build.load("murmur3")
            arr = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p]
            for name in ("mm3_hash_i32", "mm3_hash_i64", "mm3_hash_f64"):
                fn = getattr(lib, name)
                fn.argtypes = arr
                fn.restype = None
                _fns[name] = fn
            fn = lib.mm3_hash_bytes_arr
            fn.argtypes = [ctypes.c_void_p] + arr
            fn.restype = None
            _fns["mm3_hash_bytes_arr"] = fn
        return _fns


def null_mask(values: np.ndarray) -> np.ndarray:
    """SQL NULL per row: NaN in a float column, NaT in a datetime column,
    None or NaN in an object column; integer and boolean columns hold
    none."""
    kind = values.dtype.kind
    if kind == "f":
        return np.isnan(values)
    if kind in "Mm":
        return np.isnat(values)
    if kind == "O":
        # None, or a value unequal to itself (NaN), one C loop each
        return np.equal(values, None) | np.not_equal(values, values)
    return np.zeros(len(values), dtype=bool)


def _utf8(values: np.ndarray, nulls: np.ndarray):
    """(concatenated bytes, int64 offsets[n+1]) of `str(v)` per row; a
    null row is empty."""
    bufs = [b"" if nulls[i] else str(v).encode("utf-8")
            for i, v in enumerate(values)]
    offsets = np.zeros(len(bufs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    return b"".join(bufs), offsets


def hash_column(values, seeds: np.ndarray) -> np.ndarray:
    """Chain one column into running int32 hashes (`seeds`), Spark-style,
    in the C++ library."""
    values = np.asarray(values)
    n = len(seeds)
    out = np.ascontiguousarray(seeds, dtype=np.int32).copy()
    if n == 0:
        return out
    nulls = null_mask(values)
    nm = np.ascontiguousarray(nulls, dtype=np.uint8)
    fns = _lib()
    kind = values.dtype.kind
    if kind in "iub" or (kind == "f" and values.dtype.itemsize <= 4):
        if kind == "f":
            v32 = np.where(nulls, 0.0, values).astype(np.float32)
            v32[v32 == 0.0] = 0.0  # normalize -0.0
            vals, fn = v32.view(np.int32), fns["mm3_hash_i32"]
        elif kind != "b" and values.dtype.itemsize > 4:
            vals, fn = values.astype(np.int64), fns["mm3_hash_i64"]
        else:
            vals, fn = values.astype(np.int32), fns["mm3_hash_i32"]
        vals = np.ascontiguousarray(vals)
        fn(vals.ctypes.data, nm.ctypes.data, n, out.ctypes.data)
        return out
    if kind == "f":
        vals = np.ascontiguousarray(np.where(nulls, 0.0, values),
                                    dtype=np.float64)
        fns["mm3_hash_f64"](vals.ctypes.data, nm.ctypes.data, n,
                            out.ctypes.data)
        return out
    blob, offsets = _utf8(values, nulls)
    buf = np.frombuffer(blob or b"\x00", dtype=np.uint8)
    fns["mm3_hash_bytes_arr"](buf.ctypes.data, offsets.ctypes.data,
                              nm.ctypes.data, n, out.ctypes.data)
    return out


def hash_columns(columns: Iterable, n: Optional[int] = None,
                 seed: int = SEED) -> np.ndarray:
    """Hash rows across columns with seed chaining (the `hash(*cols)`
    op)."""
    cols = [np.asarray(c) for c in columns]
    if n is None:
        n = len(cols[0])
    out = np.full(n, seed, dtype=np.int32)
    for c in cols:
        out = hash_column(c, out)
    return out


def hash_partition_ids(hashes: np.ndarray, num_parts: int) -> np.ndarray:
    """pmod(hash, num_parts): shuffle placement."""
    return (hashes.astype(np.int64) % num_parts).astype(np.int32)


def hash_scalar(value, seed: int = SEED) -> int:
    """Hash one Python scalar (the course harness's `toHash`): a bool,
    int or float as its numpy type, anything else as text."""
    if isinstance(value, (bool, int, float)):
        col = np.asarray([value])
    else:
        col = np.empty(1, dtype=object)
        col[0] = value
    return int(hash_columns([col], n=1, seed=seed)[0])


# ------------------------------------------------ plain versions (tests)
def _modular(fn):
    """uint32 arithmetic is modular on purpose: silence numpy's overflow
    warnings locally."""
    def wrapped(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)
    wrapped.__name__ = fn.__name__
    return wrapped


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def _mix_k1(k1: np.ndarray) -> np.ndarray:
    k1 = (k1 * np.uint32(0xCC9E2D51)).astype(np.uint32)
    k1 = _rotl32(k1, 15)
    return (k1 * np.uint32(0x1B873593)).astype(np.uint32)


def _mix_h1(h1: np.ndarray, k1: np.ndarray) -> np.ndarray:
    h1 = (h1 ^ k1).astype(np.uint32)
    h1 = _rotl32(h1, 13)
    return (h1 * np.uint32(5) + np.uint32(0xE6546B64)).astype(np.uint32)


def _fmix(h1: np.ndarray, length) -> np.ndarray:
    h1 = (h1 ^ np.uint32(length)).astype(np.uint32)
    h1 ^= h1 >> np.uint32(16)
    h1 = (h1 * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h1 ^= h1 >> np.uint32(13)
    h1 = (h1 * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h1 ^= h1 >> np.uint32(16)
    return h1


def _np_hash_int(vals: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    k1 = _mix_k1(vals.astype(np.int32).view(np.uint32))
    h1 = _mix_h1(seeds.view(np.uint32), k1)
    return _fmix(h1, 4).view(np.int32)


def _np_hash_long(vals: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    v = vals.astype(np.int64).view(np.uint64)
    low = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    high = (v >> np.uint64(32)).astype(np.uint32)
    h1 = _mix_h1(seeds.view(np.uint32), _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _fmix(h1, 8).view(np.int32)


def _np_hash_double(vals: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    d = vals.astype(np.float64).copy()
    d[d == 0.0] = 0.0  # normalize -0.0
    return _np_hash_long(d.view(np.int64), seeds)


@_modular
def _py_hash_bytes(data: bytes, seed: int) -> int:
    h1 = np.uint32(seed & 0xFFFFFFFF)
    n = len(data)
    aligned = n - (n & 3)
    for i in range(0, aligned, 4):
        word = np.uint32(int.from_bytes(data[i:i + 4], "little"))
        h1 = _mix_h1(h1, _mix_k1(word))
    for i in range(aligned, n):
        b = data[i]
        if b >= 128:
            b -= 256  # sign-extend
        h1 = _mix_h1(h1, _mix_k1(np.uint32(b & 0xFFFFFFFF)))
    return int(_fmix(h1, n).view(np.int32))


@_modular
def hash_column_plain(values, seeds: np.ndarray) -> np.ndarray:
    """`hash_column` in NumPy and pure Python, the library's reference."""
    values = np.asarray(values)
    out = seeds.astype(np.int32).copy()
    nulls = null_mask(values)
    kind = values.dtype.kind
    if kind in "iub":
        if kind != "b" and values.dtype.itemsize > 4:
            res = _np_hash_long(values.astype(np.int64), out)
        else:
            res = _np_hash_int(values.astype(np.int32), out)
    elif kind == "f":
        vals = np.where(nulls, 0.0, values)
        if values.dtype.itemsize <= 4:
            v32 = vals.astype(np.float32)
            v32[v32 == 0.0] = 0.0
            res = _np_hash_int(v32.view(np.int32), out)
        else:
            res = _np_hash_double(vals, out)
    else:
        for i, v in enumerate(values):
            if not nulls[i]:
                out[i] = _py_hash_bytes(str(v).encode("utf-8"), int(out[i]))
        return out
    out[~nulls] = res[~nulls]
    return out
