"""Batched tree-ensemble traversal: the serving path's one kernel.

`forest_traverse` is the wrapper of the CUDA kernel in
`sml_tpu_torch/csrc/forest_traverse.cu`, which replaces the TPU kernel
`sml_tpu/native/traverse_kernel.py::forest_traverse`. It is also the
device switch of the scoring path (the role of
`sml_tpu/ml/inference._forest_margin_path`): a CUDA tensor launches the
kernel, or raises; a CPU tensor runs `forest_margin_plain`, the plain
PyTorch version of the same function (the counterpart of
`sml_tpu/ml/inference._forest_margin`). Nothing falls back.

The ensemble is the level-order heap of `_EnsembleSpec.stacked()`:
`sf` (feature id, negative at a leaf) and `sb` (split bin) int32 and
`lv` (node value) f32, each (T, N) with N >= 2^(depth+1) - 1, and the
per-tree weights `w` f32 (T,). A row goes right at a node iff its bin
is greater than the split bin.

The launch comes from the shapes alone (`traverse_plan`, cached per
shape). The kernel builds compact tables in shared memory, with early
leaves completed so that every descent takes exactly `depth` steps.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from . import build

#: kernel launches made by `forest_traverse` in this process
LAUNCHES = 0
_count_lock = threading.Lock()

_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
_fn = None

#: the card the plan is sized for: an H100 SXM (the plan never asks the
#: device). SMs; shared memory one block may use and one SM holds, with
#: 1 KB of the SM's taken by each resident block; threads, registers and
#: blocks an SM holds; the registers a thread of the tiled kernel may use
#: (its launch bounds: one block of 1,024 threads per SM)
_SMS = 132
_SMEM_BLOCK = 227 * 1024
_SMEM_SM = 228 * 1024
_SMEM_RESERVED = 1024
_SM_THREADS = 2048
_SM_REGS = 65536
_SM_BLOCKS = 32
_REGS = 64
#: threads of a tiled block, at most
_THREADS = 1024
#: rows of a tile (the sizes the plan may take: multiples of 32), and
#: the most bytes of a tile's bins staged in shared memory ((F + 1) x
#: rows int32)
_TILE_ROWS = tuple(range(32, _THREADS + 1, 32))
_STAGE_X_BYTES = 48 * 1024
#: the deepest tree the tiled kernel takes (`kMaxSharedDepth`)
_MAX_SHARED_DEPTH = 14
#: threads of a block of the global-memory kernel, one row each
_GLOBAL_THREADS = 256


class TraversePlan(NamedTuple):
    path: str         # "shared": the tiled kernel; "global": one thread a row
    tile_rows: int    # rows of a tile, a multiple of 32
    groups: int       # tree groups: warps per 32 rows of a tile
    threads: int      # per block (tile_rows * groups on the shared path)
    chunk: int        # trees whose compact tables a block holds at a time
    n_chunks: int     # chunks of trees (the running sum is kept in `out`)
    grid: int         # blocks (each walks tiles grid apart)
    stage_x: int      # 1: a tile's bins are staged; 0: read through L1
    smem: int         # dynamic shared memory of a block, in bytes
    per_sm: int       # blocks resident on one SM


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def traverse_layout(chunk: int, depth: int, tile_rows: int, n_feat: int,
                    stage_x: bool, groups: int) -> dict:
    """Byte offsets of the dynamic shared memory of one tiled block, as
    the kernel lays it out (`Layout` in `csrc/forest_traverse.cu`):
    8-byte records of the 2^D - 1 internal nodes and the 2^D weighted
    last-level values of `chunk` trees, two bin tiles [F + 1][R] int32
    when staged, and, with more than one tree group, two tiles' leaf
    values [chunk][R] f32; "total" is the block's bytes."""
    nleaf = 1 << depth
    leaf = _up16(8 * chunk * (nleaf - 1))
    x = leaf + _up16(4 * chunk * nleaf)
    x_bytes = _up16(4 * (n_feat + 1) * tile_rows) if stage_x else 0
    vals = x + 2 * x_bytes
    vals_bytes = _up16(4 * chunk * tile_rows) if groups > 1 else 0
    return {"rec": 0, "leaf": leaf, "x": (x, x + x_bytes),
            "vals": (vals, vals + vals_bytes), "total": vals + 2 * vals_bytes}


def traverse_smem(chunk: int, depth: int, tile_rows: int, n_feat: int,
                  stage_x: bool, groups: int) -> int:
    """Dynamic shared memory of one tiled block (`traverse_layout`)."""
    return traverse_layout(chunk, depth, tile_rows, n_feat, stage_x,
                           groups)["total"]


@functools.lru_cache(maxsize=512)
def traverse_plan(n: int, n_feat: int, bin_bytes: int, n_trees: int,
                  n_nodes: int, depth: int) -> TraversePlan:
    """The launch of `forest_traverse`, from the shapes alone.

    A block holds the compact tables of `chunk` trees, as many as fit
    `_SMEM_BLOCK` beside its tiles, and has up to 1,024 threads: groups =
    1,024 / R warps per 32 rows of its tile (at most the chunk), so a
    small request runs many trees at once. Of the tile sizes R that fit,
    the plan takes the
    one whose blocks walk the fewest rows (rounds of tiles x R; then the
    fewer rounds): a grid of one tile per block while the tiles fit,
    else a persistent one. A tree too deep for shared memory on its own,
    or tables of fewer than 4 nodes a tree, go to the global-memory
    kernel. The bins of a tile are staged when they take at most
    `_STAGE_X_BYTES`. `bin_bytes` does not change the plan (bins are
    staged as int32); it is part of the shape."""
    del bin_bytes
    n = max(int(n), 1)
    tree_bytes = 8 * ((1 << depth) - 1) + 4 * (1 << depth)
    global_plan = TraversePlan("global", 0, 0, _GLOBAL_THREADS, n_trees, 1,
                               -(-n // _GLOBAL_THREADS), 0, 0,
                               _SM_THREADS // _GLOBAL_THREADS)
    if depth > _MAX_SHARED_DEPTH or tree_bytes > _SMEM_BLOCK or n_nodes < 4:
        return global_plan
    best = None
    for rows in _TILE_ROWS:
        stage_x = 4 * (n_feat + 1) * rows <= _STAGE_X_BYTES
        groups = max(1, min(n_trees, _THREADS // rows))
        fixed = traverse_smem(0, depth, rows, n_feat, stage_x, groups)
        per_tree = traverse_smem(1, depth, rows, n_feat, stage_x,
                                 groups) - fixed
        # rounding makes per_tree an upper bound: the chunk fits
        chunk = min(n_trees, (_SMEM_BLOCK - fixed) // per_tree)
        if chunk < 1:
            continue
        groups = min(groups, chunk)
        threads = rows * groups
        smem = traverse_smem(chunk, depth, rows, n_feat, stage_x, groups)
        per_sm = min(_SMEM_SM // (smem + _SMEM_RESERVED),
                     _SM_THREADS // threads, _SM_REGS // (threads * _REGS),
                     _SM_BLOCKS)
        tiles = -(-n // rows)
        grid = min(tiles, _SMS * per_sm)
        rounds = -(-tiles // grid)
        key = (rounds * rows, rounds)
        if best is None or key < best[0]:
            best = (key, TraversePlan("shared", rows, groups, threads, chunk,
                                      -(-n_trees // chunk), grid,
                                      int(stage_x), smem, per_sm))
    return global_plan if best is None else best[1]


def forest_margin_plain(binned: torch.Tensor, sf: torch.Tensor,
                        sb: torch.Tensor, lv: torch.Tensor,
                        weights: torch.Tensor, depth: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops: per tree, `depth`
    gather-and-compare steps over all rows, then the weighted leaf value
    added in tree order in f32 (each multiply and add rounded, like the
    kernel). Bins widen to int64 before any indexing (uint16 has little
    operator support). A row at a leaf stays there for the remaining
    levels; a feature id past the row reads as bin 0."""
    x = binned.to(torch.int64)
    n, n_feat = x.shape
    sf64 = sf.to(torch.int64)
    sb64 = sb.to(torch.int64)
    lv32 = lv.to(torch.float32)
    w32 = weights.to(torch.float32)
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    for t in range(sf64.shape[0]):
        node = torch.zeros(n, dtype=torch.int64, device=x.device)
        for _ in range(depth):
            f = sf64[t][node]
            xb = x.gather(1, f.clamp(0, n_feat - 1)[:, None])[:, 0]
            xb = torch.where(f < n_feat, xb, 0)
            child = 2 * node + 1 + (xb > sb64[t][node]).to(torch.int64)
            node = torch.where(f >= 0, child, node)
        acc = acc + w32[t] * lv32[t][node]
    return acc


def _check(binned, sf, sb, lv, weights, depth: int) -> None:
    if binned.dim() != 2 or binned.dtype not in _BIN_BYTES:
        raise TypeError(f"binned must be a 2-D uint8/uint16/int32 tensor, "
                        f"got {tuple(binned.shape)} {binned.dtype}")
    if sf.dim() != 2 or sf.shape != sb.shape or sf.shape != lv.shape:
        raise ValueError(f"node tables must share one (T, N) shape, got "
                         f"sf {tuple(sf.shape)}, sb {tuple(sb.shape)}, "
                         f"lv {tuple(lv.shape)}")
    if sf.dtype != torch.int32 or sb.dtype != torch.int32 \
            or lv.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("sf and sb must be int32, lv and weights float32")
    n_trees, n_nodes = sf.shape
    if weights.shape != (n_trees,):
        raise ValueError(f"weights must be ({n_trees},), got "
                         f"{tuple(weights.shape)}")
    if depth < 0 or n_nodes < 2 ** (depth + 1) - 1:
        raise ValueError(f"depth {depth} needs {2 ** (depth + 1) - 1} "
                         f"nodes per tree, the tables have {n_nodes}")
    devices = {t.device for t in (binned, sf, sb, lv, weights)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {devices}")
    if not all(t.is_contiguous() for t in (binned, sf, sb, lv, weights)):
        raise ValueError("operands must be contiguous")
    if binned.shape[0] >= 2 ** 31 or n_trees * n_nodes >= 2 ** 31:
        raise ValueError("row count and T*N must be below 2^31")


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("forest_traverse").sml_forest_traverse
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def forest_traverse(binned: torch.Tensor, sf: torch.Tensor,
                    sb: torch.Tensor, lv: torch.Tensor,
                    weights: torch.Tensor, *, depth: int) -> torch.Tensor:
    """Weighted ensemble margin, (n,) f32, on the operands' device.

    CUDA operands launch the kernel on the current stream of their
    device (no synchronisation; the caller's copy back to the host
    orders after it). CPU operands run `forest_margin_plain`."""
    global LAUNCHES
    _check(binned, sf, sb, lv, weights, depth)
    dev = binned.device
    if dev.type == "cpu":
        return forest_margin_plain(binned, sf, sb, lv, weights, depth)
    if dev.type != "cuda":
        raise ValueError(f"forest_traverse runs on cuda or cpu, not {dev}")
    n, n_feat = binned.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = _kernel()
    n_trees, n_nodes = sf.shape
    bin_bytes = _BIN_BYTES[binned.dtype]
    p = traverse_plan(n, n_feat, bin_bytes, n_trees, n_nodes, depth)
    args = (bin_bytes, binned.data_ptr(), sf.data_ptr(), sb.data_ptr(),
            lv.data_ptr(), weights.data_ptr(), out.data_ptr(), n, n_feat,
            n_trees, n_nodes, depth, int(p.path == "shared"), p.tile_rows,
            p.groups, p.threads, p.chunk, p.grid, p.stage_x)
    err = build.launch_on_stream(dev, fn, *args)
    if err != 0:
        raise RuntimeError(f"forest_traverse launch failed: CUDA error "
                           f"{err} (n={n}, F={n_feat}, T={n_trees}, "
                           f"N={n_nodes}, depth={depth}, {p})")
    with _count_lock:
        LAUNCHES += 1
    return out
