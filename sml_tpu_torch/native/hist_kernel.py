"""The tree build's two kernels: per-level histogram and split scan.

`hist_accumulate` and `split_scan` wrap the CUDA kernels in
`sml_tpu_torch/csrc/hist_accumulate.cu` and `csrc/split_scan.cu`, which
replace the TPU kernels of the same names in
`sml_tpu/native/hist_kernel.py`. Their signatures are the JAX ones
without `interpret`, `block_rows` and `hist_dtype`: operands and results
are f32, as the JAX package computes off the TPU, and the row chunks and
tiles come from the shapes (`hist_plan`), never from configuration.

`hist_accumulate` sums in float64 and rounds each cell to f32 once,
deliberately above the Pallas body's f32 sums: the result then hardly
depends on the order of the sums, so the kernel and its plain version
give the same bits and a fit on the card grows the same trees as one on
the CPU. `chip_smoke.py` prices that against an f32-accumulating build
of the same kernel (`PERF.md`).

A CUDA tensor launches the kernel or raises. A CPU tensor runs the plain
PyTorch version (`hist_accumulate_plain`, `split_scan_plain`). Nothing
falls back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

#: kernel launches made by each wrapper in this process
LAUNCHES = {"hist_accumulate": 0, "split_scan": 0}
_count_lock = threading.Lock()

_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
_fns = {}

#: shared-memory bytes of one block's histogram tile: two blocks per SM
_TILE_BYTES = 100 * 1024
#: warps (one feature each) per block
_MAX_WARPS = 8
#: rows of one chunk, before the scratch bound
_CHUNK_ROWS = 2048
#: bound on the chunk-partials scratch
_SCRATCH_BYTES = 64 << 20


class HistPlan(NamedTuple):
    chunk_rows: int
    n_chunks: int
    ft: int   # features per tile (one warp each)
    bt: int   # bins per tile
    st: int   # slots per tile


def _even(total: int, most: int) -> int:
    """The tile size that cuts `total` into the fewest tiles of at most
    `most`, as evenly as possible."""
    tiles = -(-total // max(1, most))
    return -(-total // tiles)


def hist_plan(n: int, n_feat: int, n_bins: int, n_slots: int,
              acc_bytes: int = 8) -> HistPlan:
    """Row chunks and shared-memory tiles of `hist_accumulate`, from the
    shapes alone. A tile of ft features x bt bins x st slots holds three
    sums of `acc_bytes` (8: the port's float64; 4: the f32-accumulating
    build that `chip_smoke.py` times) a cell within `_TILE_BYTES`:
    features are tiled first, then slots, then bins. Chunks are
    `_CHUNK_ROWS` rows (a multiple of 32) unless the (chunks, F*B*S*3)
    scratch would pass `_SCRATCH_BYTES`; then they grow."""
    cell = 3 * acc_bytes
    if n_bins * n_slots * cell <= _TILE_BYTES:
        bt, st = n_bins, n_slots
        ft = _even(n_feat, min(_MAX_WARPS,
                               _TILE_BYTES // (n_bins * n_slots * cell)))
    elif n_bins * cell <= _TILE_BYTES:
        ft, bt = 1, n_bins
        st = _even(n_slots, _TILE_BYTES // (n_bins * cell))
    else:
        ft, st = 1, 1
        bt = _even(n_bins, _TILE_BYTES // cell)
    per_chunk = n_feat * n_bins * n_slots * cell
    chunks = min(-(-n // _CHUNK_ROWS), max(1, _SCRATCH_BYTES // per_chunk))
    chunk_rows = -(-max(n, 1) // max(chunks, 1))
    chunk_rows = -(-chunk_rows // 32) * 32
    return HistPlan(chunk_rows, max(1, -(-n // chunk_rows)), ft, bt, st)


# ------------------------------------------------------------ plain versions
def hist_accumulate_plain(binned: torch.Tensor, lid: torch.Tensor,
                          grad: torch.Tensor, hess: torch.Tensor,
                          weight: torch.Tensor, n_bins: int,
                          n_slots: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops: (F*B, S*3) f32, cell
    ((f*B + b)*S + s)*3 + k. Each row with w > 0, a slot in [0, S) and
    bin b in [0, B) adds (g*w, h*w, w) to cell (f, b, lid) of every
    feature f; the products are f32, as in the kernel. The sums run in
    float64 (`index_add_`, in row order on the CPU) and are rounded to
    f32 once, as in the kernel, which sums in another order. (The JAX
    body's one-hot product spreads a non-finite product to every cell;
    here, as in the kernel, a row adds only to its own cells.)"""
    n, n_feat = binned.shape
    B, S = int(n_bins), int(n_slots)
    dev = binned.device
    x = binned.to(torch.int64)
    slot = lid.to(torch.int64)
    keep = (weight > 0) & (slot >= 0) & (slot < S)
    ok = keep[:, None] & (x >= 0) & (x < B)                       # (n, F)
    feat = torch.arange(n_feat, device=dev, dtype=torch.int64)[None, :]
    cell = (feat * B + x) * S + slot[:, None]                      # (n, F)
    stats = torch.stack([grad * weight, hess * weight, weight], dim=1)
    src = stats[:, None, :].expand(n, n_feat, 3)[ok].to(torch.float64)
    out = torch.zeros((n_feat * B * S, 3), dtype=torch.float64, device=dev)
    out.index_add_(0, cell[ok], src)
    return out.to(torch.float32).reshape(n_feat * B, S * 3)


def split_scan_plain(hist: torch.Tensor, feat_mask: torch.Tensor,
                     min_inst: torch.Tensor, reg_lambda: float,
                     gamma: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops: the (6, W) f32 pack
    [best feature, best bin, 0.5*best - gamma, G, H, W] of every node of
    an (F, B, W, 3) histogram. The prefix over bins is a sequential f32
    sum from 0 (one add per bin), every operation is rounded on its own
    in the kernel's association, and the argmax keeps the lowest flat
    index f*B + b on ties, ranks a NaN above every number (the first
    NaN wins) and gives index 0 when every candidate is masked, as
    jnp.argmax does."""
    n_feat, n_bins, width = hist.shape[0], hist.shape[1], hist.shape[2]
    lam, gam = float(reg_lambda), float(gamma)
    h = hist.permute(2, 0, 1, 3)                                 # (W, F, B, 3)
    pref = torch.empty_like(h)
    acc = torch.zeros_like(h[:, :, 0])
    for b in range(n_bins):
        acc = acc + h[:, :, b]
        pref[:, :, b] = acc
    GL, HL, WL = pref[..., 0], pref[..., 1], pref[..., 2]
    G, H, W = GL[:, :, -1:], HL[:, :, -1:], WL[:, :, -1:]

    def term(g, hh):
        return (g * g) / ((hh + lam) + 1e-12)

    score = (term(GL, HL) + term(G - GL, H - HL)) - term(G, H)
    mi = min_inst.reshape(())
    ok = (WL >= mi) & ((W - WL) >= mi)
    ok = ok & (torch.arange(n_bins, device=hist.device) < n_bins - 1)
    ok = ok & (feat_mask > 0)[:, :, None]
    sc = torch.where(ok, score, float("-inf")).reshape(width, n_feat * n_bins)
    nan = torch.isnan(sc)
    first_nan = nan.to(torch.uint8).argmax(dim=1)
    first_max = torch.where(nan, float("-inf"), sc).argmax(dim=1)
    flat = torch.where(nan.any(dim=1), first_nan, first_max)
    best = sc.gather(1, flat[:, None])[:, 0]
    return torch.stack([(flat // n_bins).to(torch.float32),
                        (flat % n_bins).to(torch.float32),
                        0.5 * best - gam, G[:, 0, 0], H[:, 0, 0], W[:, 0, 0]])


# ------------------------------------------------------------ guards
def _same_device_contiguous(*ts) -> None:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {devices}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("operands must be contiguous")


def _check_hist(binned, lid, grad, hess, weight, n_bins: int,
                n_slots: int) -> None:
    if binned.dim() != 2 or binned.dtype not in _BIN_BYTES:
        raise TypeError(f"binned must be a 2-D uint8/uint16/int32 tensor, "
                        f"got {tuple(binned.shape)} {binned.dtype}")
    n = binned.shape[0]
    if lid.dtype != torch.int32:
        raise TypeError(f"lid must be int32, got {lid.dtype}")
    for name, t in (("grad", grad), ("hess", hess), ("weight", weight)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("lid", lid), ("grad", grad), ("hess", hess),
                    ("weight", weight)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    if n_bins < 1 or n_slots < 1:
        raise ValueError(f"n_bins and n_slots must be positive, got "
                         f"{n_bins} and {n_slots}")
    _same_device_contiguous(binned, lid, grad, hess, weight)
    if n >= 2 ** 31 or binned.shape[1] * n_bins * n_slots * 3 >= 2 ** 31:
        raise ValueError("rows and F*B*S*3 must be below 2^31")


def _check_scan(hist, feat_mask, min_inst) -> None:
    if hist.dim() != 4 or hist.shape[3] != 3 or hist.dtype != torch.float32:
        raise TypeError(f"hist must be an (F, B, W, 3) float32 tensor, got "
                        f"{tuple(hist.shape)} {hist.dtype}")
    n_feat, n_bins, width = hist.shape[:3]
    if feat_mask.dtype != torch.float32 or min_inst.dtype != torch.float32:
        raise TypeError("feat_mask and min_inst must be float32")
    if tuple(feat_mask.shape) != (width, n_feat):
        raise ValueError(f"feat_mask must be ({width}, {n_feat}), got "
                         f"{tuple(feat_mask.shape)}")
    if tuple(min_inst.shape) != (1, 1):
        raise ValueError(f"min_inst must be (1, 1), got "
                         f"{tuple(min_inst.shape)}")
    if min(n_feat, n_bins, width) < 1 or 3 * n_feat * n_bins >= 2 ** 31:
        raise ValueError(f"empty or oversized histogram "
                         f"{tuple(hist.shape)}")
    _same_device_contiguous(hist, feat_mask, min_inst)


# ------------------------------------------------------------ launches
def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import build
        fn = getattr(build.load(name), f"sml_{name}")
        if name == "hist_accumulate":
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
                + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
                + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def hist_accumulate(binned: torch.Tensor, lid: torch.Tensor,
                    grad: torch.Tensor, hess: torch.Tensor,
                    weight: torch.Tensor, *, n_bins: int,
                    n_slots: int) -> torch.Tensor:
    """Partial histogram of one tree level, (F*n_bins, n_slots*3) f32,
    on the operands' device (see `hist_accumulate_plain` for the cell
    layout). `binned` is the compact bin matrix, `lid` each row's slot,
    `weight` its weight (0 leaves the row out).

    CUDA operands launch the kernel on the current stream: a pass that
    sums each chunk of rows in float64 into a scratch array, then a sum
    over chunks in chunk order, rounded to f32. The result is
    bit-identical from run to run. CPU operands run
    `hist_accumulate_plain`."""
    B, S = int(n_bins), int(n_slots)
    _check_hist(binned, lid, grad, hess, weight, B, S)
    dev = binned.device
    if dev.type == "cpu":
        return hist_accumulate_plain(binned, lid, grad, hess, weight, B, S)
    if dev.type != "cuda":
        raise ValueError(f"hist_accumulate runs on cuda or cpu, not {dev}")
    n, n_feat = binned.shape
    out = torch.empty((n_feat * B, S * 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    plan = hist_plan(n, n_feat, B, S)
    scratch = torch.empty((plan.n_chunks, n_feat * B * S * 3),
                          dtype=torch.float64, device=dev)
    fn = _kernel("hist_accumulate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_BIN_BYTES[binned.dtype], binned.data_ptr(), lid.data_ptr(),
                 grad.data_ptr(), hess.data_ptr(), weight.data_ptr(),
                 scratch.data_ptr(), out.data_ptr(), n, n_feat, B, S,
                 plan.chunk_rows, plan.n_chunks, plan.ft, plan.bt, plan.st,
                 stream)
    if err != 0:
        raise RuntimeError(f"hist_accumulate launch failed: CUDA error {err} "
                           f"(n={n}, F={n_feat}, B={B}, S={S}, {plan})")
    _count("hist_accumulate")
    return out


def split_scan(hist: torch.Tensor, feat_mask: torch.Tensor,
               min_inst: torch.Tensor, *, reg_lambda: float,
               gamma: float) -> torch.Tensor:
    """The (6, W) f32 best-split pack of every node of an (F, B, W, 3)
    histogram (see `split_scan_plain`). `feat_mask` is (W, F) f32 (a
    feature is a candidate where it is > 0), `min_inst` a (1, 1) f32.

    CUDA operands launch the kernel on the current stream; CPU operands
    run `split_scan_plain`."""
    _check_scan(hist, feat_mask, min_inst)
    dev = hist.device
    if dev.type == "cpu":
        return split_scan_plain(hist, feat_mask, min_inst, reg_lambda, gamma)
    if dev.type != "cuda":
        raise ValueError(f"split_scan runs on cuda or cpu, not {dev}")
    n_feat, n_bins, width = hist.shape[:3]
    out = torch.empty((6, width), dtype=torch.float32, device=dev)
    fn = _kernel("split_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(hist.data_ptr(), feat_mask.data_ptr(), min_inst.data_ptr(),
                 out.data_ptr(), n_feat, n_bins, width, float(reg_lambda),
                 float(gamma), stream)
    if err != 0:
        raise RuntimeError(f"split_scan launch failed: CUDA error {err} "
                           f"(F={n_feat}, B={n_bins}, W={width})")
    _count("split_scan")
    return out
