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
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: kernel launches made by `forest_traverse` in this process
LAUNCHES = 0
_count_lock = threading.Lock()

_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
_fn = None


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
        from . import build
        fn = build.load("forest_traverse").sml_forest_traverse
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_BIN_BYTES[binned.dtype], binned.data_ptr(), sf.data_ptr(),
                 sb.data_ptr(), lv.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), n, n_feat, n_trees, n_nodes, depth, stream)
    if err != 0:
        raise RuntimeError(f"forest_traverse launch failed: CUDA error "
                           f"{err} (n={n}, F={n_feat}, T={n_trees}, "
                           f"N={n_nodes}, depth={depth})")
    with _count_lock:
        LAUNCHES += 1
    return out
