"""Staging of compact bin matrices and per-row arrays onto the device.

Counterpart of the bin cache of `sml_tpu/ml/_staging.py`
(`stage_bins_cached`): a quantized bin matrix is copied to the device
once per content and kept, in its compact dtype (uint8/uint16/int32),
in an LRU bounded by `sml.tree.binCacheBytes`. Per-row fit arrays
(the labels) are copied as f32 by `stage_rows`, uncached.
Rows are not padded: in eager PyTorch nothing compiles per shape, so
kernels run on the true rows and need no padding mask.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

_FULL_HASH_MAX_BYTES = 1 << 24    # 16 MB
_SAMPLE_WINDOW = 1 << 16
_SAMPLE_COUNT = 16
_CKSUM_CHUNK = 1 << 20  # words per block (8MB) — bounds the arange temp

_bin_stage_cache: Dict[tuple, torch.Tensor] = {}
_bin_stage_bytes = [0]
_stage_lock = threading.Lock()


def _normalize(a) -> np.ndarray:
    """The staging boundary: a C-contiguous ndarray (no copy when the
    caller already complies)."""
    return np.ascontiguousarray(np.asarray(a))


def _word_checksum(u8: np.ndarray) -> int:
    """Position-weighted wraparound uint64 checksum over every byte:
    sum(w_i) and sum(w_i * (i+1)) mod 2^64, blockwise. Point edits and
    row permutations both perturb it."""
    n8 = u8.size & ~7
    w = u8[:n8].view(np.uint64)
    idx = np.arange(1, min(_CKSUM_CHUNK, max(w.size, 1)) + 1,
                    dtype=np.uint64)
    s1 = 0
    s2 = 0
    for start in range(0, w.size, _CKSUM_CHUNK):
        blk = w[start:start + _CKSUM_CHUNK]
        b1 = int(blk.sum(dtype=np.uint64))
        b2 = int((blk * idx[:blk.size]).sum(dtype=np.uint64)) + start * b1
        s1 += b1
        s2 += b2
    if n8 != u8.size:  # tail bytes fold in with their own positions
        tail = u8[n8:].astype(np.uint64)
        s1 += int(tail.sum(dtype=np.uint64))
        s2 += int((tail * np.arange(w.size + 1, w.size + 1 + tail.size,
                                    dtype=np.uint64)).sum(dtype=np.uint64))
    return ((s1 & 0xFFFFFFFFFFFFFFFF) << 64) | (s2 & 0xFFFFFFFFFFFFFFFF)


def _content_key(a: np.ndarray) -> tuple:
    """Cache fingerprint of a normalized array: the full bytes' hash up
    to 16 MB; above, 16 evenly spaced 64 KB window hashes plus a
    whole-array word checksum, with length, shape and dtype."""
    if not a.flags.c_contiguous:
        raise ValueError("_content_key needs a C-contiguous array")
    if a.nbytes <= _FULL_HASH_MAX_BYTES:
        return ("h", a.shape, str(a.dtype), hash(a.tobytes()))
    u8 = a.reshape(-1).view(np.uint8)
    n = u8.size
    starts = np.linspace(0, n - _SAMPLE_WINDOW, _SAMPLE_COUNT).astype(np.int64)
    parts = tuple(hash(u8[s:s + _SAMPLE_WINDOW].tobytes()) for s in starts)
    return ("s", a.shape, str(a.dtype), hash((n, _word_checksum(u8)) + parts))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def stage_bins_cached(binned: np.ndarray, device: torch.device) -> torch.Tensor:
    """The device copy of a quantized bin matrix, through the bin cache.

    A copy made here is complete before it is returned (the staging
    stream is synchronised), so a tensor cached by one thread can be
    read on another thread's stream."""
    from ..conf import GLOBAL_CONF
    from ..utils.profiler import PROFILER
    a = _normalize(binned)
    key = (_content_key(a), str(device))
    with _stage_lock:
        hit = _bin_stage_cache.pop(key, None)
        if hit is not None:
            _bin_stage_cache[key] = hit  # move-to-end LRU touch
    if hit is not None:
        PROFILER.count("staging.bin_cache_hit")
        return hit
    dev = torch.from_numpy(a).to(device, copy=True)
    if dev.device.type == "cuda":
        torch.cuda.current_stream(dev.device).synchronize()
    PROFILER.count("staging.bin_cache_miss")
    PROFILER.count("staging.h2d_bytes", float(a.nbytes))
    budget = GLOBAL_CONF.getInt("sml.tree.binCacheBytes")
    with _stage_lock:
        if key not in _bin_stage_cache:
            _bin_stage_cache[key] = dev
            _bin_stage_bytes[0] += _nbytes(dev)
            while _bin_stage_bytes[0] > budget and len(_bin_stage_cache) > 1:
                old = next(iter(_bin_stage_cache))
                _bin_stage_bytes[0] -= _nbytes(_bin_stage_cache.pop(old))
    return dev


def stage_rows(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A per-row host array as a contiguous f32 tensor on `device`,
    complete before it is returned (like `stage_bins_cached`)."""
    from ..utils.profiler import PROFILER
    a = np.ascontiguousarray(a, dtype=np.float32)
    dev = torch.from_numpy(a).to(device, copy=True)
    if dev.device.type == "cuda":
        torch.cuda.current_stream(dev.device).synchronize()
    PROFILER.count("staging.h2d_bytes", float(a.nbytes))
    return dev


def bin_cache_stats() -> dict:
    """(entries, bytes) snapshot of the bin cache."""
    with _stage_lock:
        return {"entries": len(_bin_stage_cache),
                "bytes": _bin_stage_bytes[0]}
