"""Snappy compression for the parquet codec, through the C++ library
`csrc/snappy.cc`.

The JAX package reads and writes parquet through pyarrow, whose SNAPPY
pages come from the snappy library; the port has neither, so it keeps a
codec of its own: a greedy matcher over a hash table of 4-byte windows
(a real compressor: repeated text shrinks) and a bounds-checked
decompressor. It is host code, not a card kernel. The library is built
with g++ at first use (`native/build.py`); a build that fails raises.
The tests hold both directions against pyarrow's own codec.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build

_fns: dict = {}
_lock = threading.Lock()


def _lib() -> dict:
    with _lock:
        if not _fns:
            lib = build.load("snappy")
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            for name, args in (
                    ("snappy_max_compressed_length", [i64]),
                    ("snappy_compress", [ptr, i64, ptr]),
                    ("snappy_uncompressed_length", [ptr, i64]),
                    ("snappy_decompress", [ptr, i64, ptr, i64])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = i64
                _fns[name] = fn
        return _fns


def _view(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if len(data) \
        else np.zeros(1, np.uint8)


def compress(data: bytes) -> bytes:
    """`data` as one raw snappy stream."""
    fns = _lib()
    src = _view(data)
    out = np.empty(fns["snappy_max_compressed_length"](len(data)), np.uint8)
    n = fns["snappy_compress"](src.ctypes.data, len(data), out.ctypes.data)
    if n < 0:
        raise ValueError("snappy: compression failed")
    return out[:n].tobytes()


def decompress(data: bytes) -> bytes:
    """The bytes of one raw snappy stream; ValueError when it is
    corrupt."""
    fns = _lib()
    src = _view(data)
    want = fns["snappy_uncompressed_length"](src.ctypes.data, len(data))
    if want < 0:
        raise ValueError("snappy: corrupt stream (bad length)")
    out = np.empty(max(want, 1), np.uint8)
    got = fns["snappy_decompress"](src.ctypes.data, len(data),
                                   out.ctypes.data, want)
    if got != want:
        raise ValueError("snappy: corrupt stream")
    return out[:want].tobytes()
