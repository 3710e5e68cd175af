"""Staging of compact bin matrices and per-row arrays onto the device.

Counterpart of the bin cache of `sml_tpu/ml/_staging.py`
(`stage_bins_cached`, `stage_stacked_cached`): a quantized bin matrix,
or a stack of fold matrices or labels, is copied to the device once per
content and kept, in its compact dtype (uint8/uint16/int32), in an LRU
bounded by `sml.tree.binCacheBytes`. Per-row fit arrays
(the labels) are copied as f32 by `stage_rows`, uncached. The chunked
ingest assembles a bin matrix on the device chunk by chunk
(`ChunkAssembler`) and adopts it into the cache (`insert_bins_cached`).
Rows are not padded: in eager PyTorch nothing compiles per shape, so
kernels run on the true rows and need no padding mask.

`routed_for(hint, *arrays)` and `route_for_arrays(hint, *arrays)` are
the fit and predict sites' dispatch decisions (the JAX package's, over
`parallel.dispatch.routed` / `device_for`): the arrays' bytes ride the
hint as its host -> device bytes for the audit; a card is never priced,
so the cache is not probed.

Every device byte the caches hold is charged to the memory ledger
(`obs/_ledger.py`): a bin matrix to the `bin_cache` pool, a fold or
element stack to `stage_cache`, freed on eviction; the chunked ingest's
matrix is `chunk_stage` while it assembles.

Under a mesh of ranks every rank calls a fit with the same rows:
`same_on_every_rank` checks that they do (one MIN and one MAX
all-reduce of a hash of the inputs), and `mesh_rows` gives a non-tree
program its mesh and this rank's block of the rows (`take_rows` cuts a
numpy array or a `CompactParts` block to it).

`extract_features` and `extract_xy` hand a frame's feature block and
label column to the fits and models, as the JAX package's do: the
features as a C-contiguous f32 matrix, the labels as f32; a fused block
that the pipeline's fit attached (`featurizer.py`) is handed over as it
is, and `extract_compact` hands over its compact form.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_FULL_HASH_MAX_BYTES = 1 << 24    # 16 MB
_SAMPLE_WINDOW = 1 << 16
_SAMPLE_COUNT = 16
_CKSUM_CHUNK = 1 << 20  # words per block (8MB) — bounds the arange temp

_bin_stage_cache: Dict[tuple, torch.Tensor] = {}
_bin_stage_pool: Dict[tuple, str] = {}   # key -> its ledger pool
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


def _hint_with_bytes(hint, arrays):
    from ..parallel.dispatch import WorkHint
    if hint is None or hint.in_bytes is not None:
        return hint
    nbytes = float(sum(np.asarray(a).nbytes for a in arrays))
    return WorkHint(hint.flops, hint.kind, hint.out_bytes, nbytes)


@contextlib.contextmanager
def routed_for(hint, *arrays, stacked: bool = False, device=None):
    """Bind the dispatch decision for a fit over `arrays` as this
    thread's device (`dispatch.routed`) and yield it: the CPU under
    `sml.dispatch.mode=host`, else `device` (the thread's bound device
    or the card). `stacked` marks fold- or element-stacked arrays (the
    JAX package prices those in their sharded layout; one card has
    one)."""
    from ..parallel import dispatch
    with dispatch.routed(_hint_with_bytes(hint, arrays), device) as dev:
        yield dev


def device_get(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """The blessed device-to-host transfer of the port's programs: every
    tensor's host copy as a numpy array, in order, counting the card's
    bytes as `staging.d2h_bytes`. The first copy waits for the card's
    queue and the rest find it drained, so a program that fetches all
    its outputs here pays one wait. The lint's host-sync rule flags any
    other sync on a dispatch-hot path."""
    from ..utils.profiler import PROFILER
    out = tuple(t.cpu().numpy() for t in tensors)
    nbytes = sum(a.nbytes for a, t in zip(out, tensors) if t.is_cuda)
    if nbytes:
        PROFILER.count("staging.d2h_bytes", float(nbytes))
    return out


def route_for_arrays(hint, *arrays, device=None
                     ) -> Tuple[torch.device, str]:
    """The one-shot decision of a predict site: (device, route), route
    "host" (the CPU, under `sml.dispatch.mode=host`) or "device"."""
    from ..device import resolve_device
    from ..parallel import dispatch
    dev = resolve_device(device)
    if dispatch.decide(_hint_with_bytes(hint, arrays), dev) == "host":
        return torch.device("cpu"), "host"
    return dev, "device"


def stage_bins_cached(binned: np.ndarray, device: torch.device,
                      pool: str = "bin_cache") -> torch.Tensor:
    """The device copy of a quantized bin matrix, through the bin cache;
    a copy it makes is charged to the ledger's `pool`.

    A copy made here is complete before it is returned (the staging
    stream is synchronised), so a tensor cached by one thread can be
    read on another thread's stream."""
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
    _bin_cache_store(key, dev, pool)
    return dev


def _bin_cache_store(key, dev: torch.Tensor, pool: str = "bin_cache"
                     ) -> None:
    """Keep `dev` under `key` (a first store wins), evicting the oldest
    entries past `sml.tree.binCacheBytes` (the newest always stays);
    the ledger's pools follow every store and eviction."""
    from ..conf import GLOBAL_CONF
    from ..obs import LEDGER, RECORDER
    from ..utils.profiler import PROFILER
    budget = GLOBAL_CONF.getInt("sml.tree.binCacheBytes")
    stored = 0
    evicted: list = []
    with _stage_lock:
        if key not in _bin_stage_cache:
            _bin_stage_cache[key] = dev
            _bin_stage_pool[key] = pool
            stored = _nbytes(dev)
            _bin_stage_bytes[0] += stored
            while _bin_stage_bytes[0] > budget and len(_bin_stage_cache) > 1:
                old = next(iter(_bin_stage_cache))
                old_bytes = _nbytes(_bin_stage_cache.pop(old))
                _bin_stage_bytes[0] -= old_bytes
                evicted.append((_bin_stage_pool.pop(old), old_bytes))
    if stored:
        LEDGER.alloc(pool, stored)
    for old_pool, old_bytes in evicted:
        LEDGER.free(old_pool, old_bytes)
        PROFILER.count("staging.bin_evict_bytes", float(old_bytes))
        if RECORDER.enabled:
            RECORDER.emit("cache", "cache.evict",
                          args={"pool": old_pool, "bytes": old_bytes})


def insert_bins_cached(binned_host: np.ndarray,
                       dev: torch.Tensor) -> torch.Tensor:
    """Adopt a device bin matrix assembled elsewhere (the chunked
    ingest's, `ChunkAssembler`) into the bin cache under its host
    mirror's content key, so that a later `stage_bins_cached` of the same
    rows on the same device hits it with no second copy. The tensor must
    be complete (the assembler's `finish`)."""
    key = (_content_key(_normalize(binned_host)), str(dev.device))
    _bin_cache_store(key, dev)
    return dev


class ChunkAssembler:
    """The resident (n, F) compact bin matrix on `device`, assembled
    chunk by chunk: the out-of-core ingest's device half (the JAX
    package's donated `dynamic_update_slice` program,
    `sml_tpu/ml/_staging.py:308-365`).

    On the card the matrix is one `torch.empty((n, F))` in the bin dtype;
    each chunk's block is copied into its own rows (no fixed window, no
    padding) from one of `depth` pinned host buffers, reused in turn, on
    a copy stream of its own. A copy from pageable memory would not be
    asynchronous, so the overlap with the next chunk's quantization
    needs the pinned buffers. A CUDA event records each copy: `put`
    waits on a buffer's previous event before refilling it, and the
    caller's drain waits on each in order. On the CPU the block is
    copied in place and there is nothing to wait for.

    Counts `ingest.h2d_bytes`."""

    def __init__(self, n: int, n_feat: int, dtype: np.dtype,
                 device: torch.device, depth: int):
        self.device = device
        self.matrix = torch.empty((n, n_feat),
                                  dtype=torch.from_numpy(
                                      np.zeros(0, dtype)).dtype,
                                  device=device)
        self._row_bytes = n_feat * np.dtype(dtype).itemsize
        self._cuda = device.type == "cuda"
        depth = max(int(depth), 1)
        self._pinned = [None] * depth
        self._events = [None] * depth
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._k = 0

    def put(self, start: int, block: np.ndarray):
        """Copy `block` (rows, F) into rows [start, start + rows); returns
        the copy's event (None on the CPU), for the caller's drain."""
        from ..utils.profiler import PROFILER
        rows = block.shape[0]
        PROFILER.count("ingest.h2d_bytes", float(block.nbytes))
        if not self._cuda:
            self.matrix[start:start + rows] = torch.from_numpy(
                np.ascontiguousarray(block))
            return None
        slot = self._k % len(self._pinned)
        self._k += 1
        if self._events[slot] is not None:
            self._events[slot].synchronize()   # the buffer is free again
        buf = self._pinned[slot]
        if buf is None or buf.shape[0] < rows:
            buf = torch.empty((rows, self._row_bytes), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[slot] = buf
        buf.numpy()[:rows] = np.ascontiguousarray(block).view(
            np.uint8).reshape(rows, self._row_bytes)
        dst = self.matrix.view(torch.uint8)[start:start + rows]
        # the matrix was allocated on the caller's stream
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            dst.copy_(buf[:rows], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._events[slot] = ev
        return ev

    def finish(self) -> torch.Tensor:
        """The assembled matrix, every copy complete."""
        if self._cuda:
            self._stream.synchronize()
        return self.matrix


def stage_stacked_cached(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The device copy of a fold- or element-stacked array (elements,
    rows, ...) through the same cache as `stage_bins_cached`, charged to
    the ledger's `stage_cache` pool: a tuning grid stages its fold
    stacks once, not once per fit."""
    return stage_bins_cached(a, device, pool="stage_cache")


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


def clear_bin_cache() -> None:
    """Drop every cached device copy (bin matrices and stacks), freeing
    their ledger bytes."""
    from ..obs import LEDGER
    with _stage_lock:
        freed = [(_bin_stage_pool.pop(k), _nbytes(t))
                 for k, t in _bin_stage_cache.items()]
        _bin_stage_cache.clear()
        _bin_stage_bytes[0] = 0
    for pool, nbytes in freed:
        LEDGER.free(pool, nbytes)


def bin_cache_stats() -> dict:
    """(entries, bytes) snapshot of the bin cache."""
    with _stage_lock:
        return {"entries": len(_bin_stage_cache),
                "bytes": _bin_stage_bytes[0]}


def extract_features(df, featuresCol: str) -> np.ndarray:
    """The (n, d) f32 matrix of a frame's features column
    (`features_of` over all its rows). A frame carrying a fused block of
    that column (`_featurized`, attached by the pipeline's fused fit)
    hands it over without materializing its transform chain."""
    feat = getattr(df, "_featurized", None)
    if feat is not None and featuresCol in feat:
        return feat[featuresCol][0]
    return features_of(df._whole(), featuresCol)


def features_of(block, featuresCol: str) -> np.ndarray:
    """The (n, d) f32 matrix of a block's vector column (a 2-D block), of
    a column of vectors or lists, or of one numeric column as a
    1-feature matrix."""
    from .linalg import to_matrix
    col = block[featuresCol]
    if col.ndim == 2:
        X = col
    elif col.dtype.kind == "O":
        X = to_matrix(col)
    else:
        X = np.asarray(col, dtype=np.float64)[:, None]
    return np.ascontiguousarray(X, dtype=np.float32)


def extract_xy(df, featuresCol: str, labelCol: str,
               weightCol: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(features, labels, weights) of a frame: `extract_features`, and
    the label (and weight) column as f32. With a fused block
    (`_featurized`) the labels come from the raw block it was built
    from, under its row-keep mask."""
    feat = getattr(df, "_featurized", None)
    if feat is not None and featuresCol in feat:
        X, keep, raw = feat[featuresCol]
        whole = raw if keep is None else {
            c: raw[c][keep] for c in (labelCol, weightCol) if c}
    else:
        whole = df._whole()
        X = features_of(whole, featuresCol)
    y = np.asarray(whole[labelCol], dtype=np.float32)
    w = np.asarray(whole[weightCol], dtype=np.float32) if weightCol else None
    return X, y, w


def extract_compact(df, featuresCol: str, labelCol: str):
    """(CompactParts, labels) when the frame carries a compact block of
    `featuresCol` (`_featurized_compact`, attached by the pipeline's
    fused fit for a large linear or logistic fit), else None. The labels
    come from the raw block under the parts' row-keep mask; a row whose
    label is not finite leaves both sides, and `keep` goes on describing
    the kept rows of the raw block."""
    feat = getattr(df, "_featurized_compact", None)
    if feat is None or featuresCol not in feat:
        return None
    parts, raw = feat[featuresCol]
    y = np.asarray(raw[labelCol], dtype=np.float32)
    if parts.keep is not None:
        y = y[parts.keep]
    ok = np.isfinite(y)
    if not ok.all():
        if parts.keep is not None:
            keep = parts.keep.copy()
            keep[keep] = ok
        else:
            keep = ok
        parts = parts._replace(num=parts.num[ok], codes=parts.codes[ok],
                               keep=keep)
        y = y[ok]
    return parts, y


def same_on_every_rank(mesh, binnings=(), ys=(), grid=None,
                       rows: Optional[int] = None, arrays=()) -> None:
    """Raise unless every rank of `mesh` holds the same fit inputs: one
    MIN and one MAX all-reduce of [a hash of the bin edges and category
    ranks of each of `binnings`, the labels `ys`, the raw bytes (with
    shape and dtype) of `arrays` and the `grid` (a fit's
    hyperparameters), the row count]. The row count is `rows`, or the
    labels' when None. Ranks that hold different rows would otherwise
    fit a wrong model without a word."""
    import hashlib

    from ..parallel import collectives as coll
    h = hashlib.blake2b(digest_size=7)   # below 2^56: an int64
    for binning in binnings:
        h.update(np.ascontiguousarray(binning.edges).tobytes())
        for f, rank in sorted(binning.cat_remap.items()):
            h.update(np.int64(f).tobytes()
                     + np.ascontiguousarray(rank).tobytes())
    for y in ys:
        h.update(np.ascontiguousarray(y, np.float32).tobytes())
    for a in arrays:
        a = _normalize(a)
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.reshape(-1).view(np.uint8).data)
    if grid is not None:
        h.update(repr(grid).encode())
    n = sum(len(y) for y in ys) if rows is None else int(rows)
    mine = torch.tensor([int.from_bytes(h.digest(), "little"), n],
                        dtype=torch.int64, device=mesh.device)
    lo, hi = coll.pmin(mine, mesh=mesh), coll.pmax(mine, mesh=mesh)
    if not torch.equal(lo, hi):
        raise ValueError(
            f"the {mesh.size} ranks of the mesh hold different fit inputs "
            f"(bin edges, category ranks, labels, arrays and grid hashed, "
            f"row counts {int(lo[1])}..{int(hi[1])}): every rank must fit "
            f"the same rows")


def mesh_rows(dev: torch.device, n_rows: int, arrays=(), grid=None):
    """(mesh, rows) of a non-tree program over `n_rows` rows on `dev`:
    (None, slice(None)) outside a mesh (`dispatch.mesh_for`); under one,
    after `same_on_every_rank` over `arrays` and `grid`, the mesh and
    this rank's block (`mesh.row_range`). Every rank holds all the
    rows; the program stages only its block and all-reduces its
    partial sums."""
    from ..parallel.dispatch import mesh_for
    from ..parallel.mesh import row_range
    mesh = mesh_for(dev)
    if mesh is None:
        return None, slice(None)
    same_on_every_rank(mesh, arrays=arrays, grid=grid, rows=n_rows)
    start, stop = row_range(n_rows, mesh)
    return mesh, slice(start, stop)


def take_rows(a, rows: slice):
    """Rows `rows` of a numpy array, or of a `featurizer.CompactParts`
    block (its numeric slots and codes; `keep` describes the raw block
    and stays as it is)."""
    if hasattr(a, "codes") and hasattr(a, "layout"):
        return a._replace(num=a.num[rows], codes=a.codes[rows])
    return a[rows]
