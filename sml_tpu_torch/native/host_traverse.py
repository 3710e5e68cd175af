"""The host traversal's C++ kernel (`csrc/forest_host.cc`), through
ctypes: the dispatcher's host route for scoring a tree ensemble.

`forest_margin_host(binned, sf, sb, lv, weights, depth, init=None)` is
`native.traverse_kernel.forest_margin_plain`'s function on numpy arrays
on the host (and so the card's `forest_traverse`'s, bit for bit): per
tree, in tree order, the weighted leaf value added to each row's f32
sum, each product and sum rounded to f32; a row at a leaf stays there;
a feature id past the row reads bin 0; uint8, uint16 and int32 bins; the
sum starts at `init` (an (n,) f32 array or one number; 0 when None).

The JAX package's host route traverses with XLA on its host mesh
(`sml_tpu/ml/inference.py` `score_block_host`); the port's plain PyTorch
version stays for the tests and runs on no path while a card is
present. The library is built with g++ at first use
(`native/build.py`); a build that fails raises. ctypes releases the GIL
for the call, so the serving path's overflow can run it in the
submitting thread while the flush worker launches on the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import build

#: calls of the host traversal in this process (the host route's count)
CALLS = 0
_count_lock = threading.Lock()

_BIN_BYTES = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 2,
              np.dtype(np.int32): 4}
_fn = None
_fn_lock = threading.Lock()


def _kernel():
    global _fn
    with _fn_lock:
        if _fn is None:
            fn = build.load("forest_host").sml_forest_host
            fn.argtypes = [ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int32] + [ctypes.c_void_p] * 4 + \
                [ctypes.c_int32] * 3 + [ctypes.c_void_p, ctypes.c_float,
                                        ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def forest_margin_host(binned: np.ndarray, sf: np.ndarray, sb: np.ndarray,
                       lv: np.ndarray, weights: np.ndarray, depth: int,
                       init=None) -> np.ndarray:
    """Weighted ensemble margin of a host bin matrix, (n,) f32 (see the
    module docstring)."""
    global CALLS
    binned = np.ascontiguousarray(binned)
    if binned.ndim != 2 or binned.dtype not in _BIN_BYTES:
        raise TypeError(f"binned must be a 2-D uint8/uint16/int32 array, "
                        f"got {binned.shape} {binned.dtype}")
    sf = np.ascontiguousarray(sf, dtype=np.int32)
    sb = np.ascontiguousarray(sb, dtype=np.int32)
    lv = np.ascontiguousarray(lv, dtype=np.float32)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    if sf.ndim != 2 or sf.shape != sb.shape or sf.shape != lv.shape:
        raise ValueError(f"node tables must share one (T, N) shape, got "
                         f"sf {sf.shape}, sb {sb.shape}, lv {lv.shape}")
    n_trees, n_nodes = sf.shape
    if weights.shape != (n_trees,):
        raise ValueError(f"weights must be ({n_trees},), got "
                         f"{weights.shape}")
    if depth < 0 or n_nodes < 2 ** (depth + 1) - 1:
        raise ValueError(f"depth {depth} needs {2 ** (depth + 1) - 1} "
                         f"nodes per tree, the tables have {n_nodes}")
    n, n_feat = binned.shape
    init_rows: Optional[np.ndarray] = None
    init_value = 0.0
    if isinstance(init, np.ndarray):
        init_rows = np.ascontiguousarray(init, dtype=np.float32)
        if init_rows.shape != (n,):
            raise ValueError(f"init must be ({n},), got {init_rows.shape}")
    elif init is not None:
        init_value = float(init)
    out = np.empty(n, dtype=np.float32)
    if n:
        err = _kernel()(_BIN_BYTES[binned.dtype], binned.ctypes.data, n,
                        n_feat, sf.ctypes.data, sb.ctypes.data,
                        lv.ctypes.data, weights.ctypes.data, n_trees,
                        n_nodes, depth,
                        None if init_rows is None else init_rows.ctypes.data,
                        init_value, out.ctypes.data)
        if err != 0:
            raise RuntimeError(f"forest_host failed with code {err}")
    with _count_lock:
        CALLS += 1
    return out
