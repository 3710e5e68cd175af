"""The host binning's C++ kernel (`csrc/binning.cc`), through ctypes.

The port's copy of `sml_tpu/native/binning.py`. `bin_continuous(X,
edge_list, categorical)` gives the (n, F) int32 bins of the continuous
features (categorical slots stay 0 for the caller's remap), with the
semantics of the NumPy expression

    np.searchsorted(edges_f, X[:, f], side="left")  # then non-finite -> 0

(`ml.tree_impl._bin_columns_plain`). The library is built with g++ at
first use (`native/build.py`); a build that fails raises, and nothing
falls back to NumPy.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List

import numpy as np

from . import build

_fns: dict = {}
_lock = threading.Lock()


def _kernels():
    with _lock:
        if not _fns:
            lib = build.load("binning")
            tail = [ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                    ctypes.c_void_p]
            for name in ("sml_bin_matrix", "sml_bin_matrix_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] + tail
                fn.restype = None
                _fns[name] = fn
        return _fns


def bin_continuous(X: np.ndarray, edge_list: List[np.ndarray],
                   categorical: Dict[int, object]) -> np.ndarray:
    """(n, F) int32 bins of the continuous slots of X (f32 stays f32,
    anything else is read as f64), each against its ascending edges."""
    n, F = X.shape
    out = np.zeros((n, F), dtype=np.int32)
    max_edges = max((len(e) for e in edge_list), default=0)
    if n == 0 or F == 0 or max_edges == 0:
        return out
    fns = _kernels()
    if X.dtype == np.float32:
        Xc, fn = np.ascontiguousarray(X), fns["sml_bin_matrix_f32"]
    else:
        Xc = np.ascontiguousarray(X, dtype=np.float64)
        fn = fns["sml_bin_matrix"]
    edges = np.zeros((F, max_edges), dtype=np.float32)
    n_edges = np.zeros(F, dtype=np.int32)
    for f, e in enumerate(edge_list):
        edges[f, :len(e)] = e
        n_edges[f] = len(e)
    is_cat = np.zeros(F, dtype=np.uint8)
    for f in categorical:
        if 0 <= int(f) < F:
            is_cat[int(f)] = 1
    fn(Xc.ctypes.data, n, F, edges.ctypes.data, n_edges.ctypes.data,
       max_edges, is_cat.ctypes.data, out.ctypes.data)
    return out
