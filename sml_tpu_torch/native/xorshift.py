"""Spark's XORShiftRandom stream, through the C++ library
`csrc/xorshift.cc`: the per-partition uniforms of `randomSplit`
(`frame/sampling.py`). Host code, not a card kernel; the library is
built with g++ at first use (`native/build.py`), and a build that fails
raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build

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


def fill_doubles(hashed_seed: int, n: int) -> np.ndarray:
    """The first n `nextDouble` draws of an XORShiftRandom whose seed is
    already scrambled (`sampling.hash_seed`), as float64."""
    out = np.empty(n, dtype=np.float64)
    if n == 0:
        return out
    _fill_doubles()(
        ctypes.c_longlong(hashed_seed - (1 << 64)
                          if hashed_seed >= (1 << 63) else hashed_seed),
        ctypes.c_longlong(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
