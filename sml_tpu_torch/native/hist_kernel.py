"""The tree build's two kernels: per-level histogram and split scan.

`hist_accumulate` and `split_scan` wrap the CUDA kernels in
`sml_tpu_torch/csrc/hist_accumulate.cu` and `csrc/split_scan.cu`, which
replace the TPU kernels of the same names in
`sml_tpu/native/hist_kernel.py`. Their signatures are the JAX ones
without `interpret`, `block_rows` and `hist_dtype`: operands and results
are f32, as the JAX package computes off the TPU, and the launches
(row chunks, tiles, clusters, staging; warps and bin segments) come from
the shapes (`hist_plan`, `scan_plan`, cached per shape), never from
configuration or from the device.

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
import functools
import threading
from typing import NamedTuple

import torch

from . import build

#: kernel launches made by each wrapper in this process
LAUNCHES = {"hist_accumulate": 0, "split_scan": 0}
_count_lock = threading.Lock()

_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
_fns = {}

#: the card the plans are sized for: an H100 SXM (the plan never asks the
#: device, so the order of the sums depends on the shapes alone)
_SMS = 132
#: shared memory one block may use, and one SM holds, in bytes; each
#: resident block also takes 1 KB of the SM's for the system
_SMEM_BLOCK = 227 * 1024
_SMEM_SM = 228 * 1024
_SMEM_RESERVED = 1024
#: threads and 32-bit registers an SM holds, and the registers a thread
#: of `hist_accumulate` may use (its launch bounds)
_SM_THREADS = 2048
_SM_REGS = 65536
_REGS = 64
#: shared-memory bytes of one block's histogram tile and its lane tags:
#: four or more blocks per SM
_TILE_BYTES = 52 * 1024
#: warps that own a feature each, and threads, per block
_MAX_WARPS = 16
_MIN_THREADS = 256
#: rows a feature warp takes in one round (one to a lane); chunks and
#: staged sub-chunks are multiples of it
_ROUND = 32
#: row buffers in a block's ring (`kStages` in the kernel), the rows of
#: one (the sizes the plan may take), and the most bytes of bins one holds
_STAGES = 3
_SUB_ROWS = (64, 128, 256)
_STAGE_BIN_BYTES = 8 * 1024
#: owning warps an SM is given before other choices count
_SM_WARPS = 12
#: rows of one chunk: the least, and the most before the scratch bound
_MIN_CHUNK_ROWS = 256
_MAX_CHUNK_ROWS = 4096
#: blocks of a thread block cluster (the portable limit)
_MAX_CLUSTER = 8
#: the share of the card's block slots one wave of clusters is sized to
#: fill: a cluster's blocks share one GPC (16-18 SMs), which leaves some
#: slots of each GPC to no whole cluster
_WAVE_SHARE = (7, 8)
#: bound on the cluster-partials scratch
_SCRATCH_BYTES = 64 << 20
#: split_scan: dynamic shared memory of one block (48 KB without opting
#: in, less the block's 256 static bytes), and warps (features) per block
_SCAN_SMEM = 47 * 1024
_SCAN_MAX_WARPS = 16


class HistPlan(NamedTuple):
    chunk_rows: int   # rows of a chunk, a multiple of 32
    n_chunks: int     # a multiple of `cluster`; trailing chunks may be empty
    ft: int           # features per tile (one warp each)
    bt: int           # bins per tile
    st: int           # slots per tile
    groups: int       # slot groups of a tile (one warp each per feature)
    cluster: int      # chunks (blocks) per thread block cluster
    sub_rows: int     # rows staged at a time, a multiple of 32
    stage_bins: int   # 1: bins are staged too; 0: read from global memory
    threads: int      # per block
    smem: int         # dynamic shared memory of a block, in bytes


class ScanPlan(NamedTuple):
    warps: int        # per block (node), one feature each at a time
    seg: int          # bins a warp stages at a time
    smem: int         # dynamic shared memory of a block, in bytes


def _even(total: int, most: int) -> int:
    """The tile size that cuts `total` into the fewest tiles of at most
    `most`, as evenly as possible."""
    tiles = -(-total // max(1, most))
    return -(-total // tiles)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def hist_smem(acc_bytes: int, ft: int, bt: int, st: int, groups: int,
              sub_rows: int, row_bin_bytes: int) -> int:
    """Dynamic shared memory of one `hist_accumulate` block, as the
    kernel lays it out (`Layout` in `csrc/hist_accumulate.cu`): an
    mbarrier per stage, the tile, a one-byte lane tag per cell, two lists
    of rows (uint16) of each slot group and their counts, and a ring of
    `_STAGES` row buffers of [bins][lid][g][h][w]."""
    keys = ft * bt * st
    buf = _up(sub_rows * row_bin_bytes, 16) + 16 * sub_rows
    return (_up(8 * _STAGES, 16) + _up(3 * acc_bytes * keys, 16)
            + _up(keys, 16) + _up(4 * groups * sub_rows, 16)
            + _up(8 * groups, 16) + _STAGES * buf)


@functools.lru_cache(maxsize=512)
def hist_plan(n: int, n_feat: int, n_bins: int, n_slots: int, *,
              bin_bytes: int = 1, acc_bytes: int = 8) -> HistPlan:
    """The launch of `hist_accumulate`, from the shapes alone.

    A tile of ft features x bt bins x st slots holds three sums of
    `acc_bytes` (8: the port's float64; 4: the f32-accumulating build
    that `chip_smoke.py` times) a cell, and its lane tag, within
    `_TILE_BYTES`: features are tiled first, then slots, then bins. A
    warp owns one feature's cells of one of `groups` slot groups and
    walks only the rows of its group, which a listing warp per group
    lists a sub-chunk ahead. Rows are staged `sub_rows` at a
    time into a ring of `_STAGES` buffers (their bins too, when they fit
    `_STAGE_BIN_BYTES`). Of the feature tiles, group counts and sub-chunk
    sizes that fit, the plan takes the one that keeps the most owning
    warps resident on an SM (up to `_SM_WARPS`; then fewer groups, wider
    feature tiles, staged bins, longer sub-chunks), as many blocks to an
    SM as its shared memory, threads and registers hold. Chunks are sized so that about one
    wave of blocks covers the rows (about `_MIN_CHUNK_ROWS` to
    `_MAX_CHUNK_ROWS` rows), then grouped in whole clusters of up to
    `_MAX_CLUSTER`; the clusters' float64 partials stay within
    `_SCRATCH_BYTES`, else chunks grow."""
    cell = 3 * acc_bytes + 1   # three sums and the cell's lane tag
    if n_bins * n_slots * cell <= _TILE_BYTES:
        bt, st = n_bins, n_slots
        ft_most = min(_MAX_WARPS, _TILE_BYTES // (n_bins * n_slots * cell))
    elif n_bins * cell <= _TILE_BYTES:
        ft_most, bt = 1, n_bins
        st = _even(n_slots, _TILE_BYTES // (n_bins * cell))
    else:
        ft_most, st = 1, 1
        bt = _even(n_bins, _TILE_BYTES // cell)
    best = None
    for ft in sorted({_even(n_feat, k) for k in range(1, ft_most + 1)}):
        for groups in (1, 2, 4, 8, 16):
            if groups > st or (ft + 1) * groups > _MAX_WARPS \
                    or (groups - 1) * -(-st // groups) >= st:
                continue   # too many warps, or a group with no slot
            for sub in _SUB_ROWS:
                if sub < _ROUND * groups:
                    continue
                stage_bins = sub * n_feat * bin_bytes <= _STAGE_BIN_BYTES
                row_bins = n_feat * bin_bytes if stage_bins else 0
                # owners, then one listing warp per group
                threads = 32 * max((ft + 1) * groups, _MIN_THREADS // 32)
                smem = hist_smem(acc_bytes, ft, bt, st, groups, sub,
                                 row_bins)
                per_sm = min(_SMEM_SM // (smem + _SMEM_RESERVED),
                             _SM_THREADS // threads,
                             _SM_REGS // (threads * _REGS))
                if smem > _SMEM_BLOCK or per_sm < 1:
                    continue
                score = (min(per_sm * ft * groups, _SM_WARPS), -groups, ft,
                         stage_bins, sub)
                if best is None or score > best[0]:
                    best = (score, ft, groups, sub, int(stage_bins), threads,
                            smem, per_sm)
    _, ft, groups, sub, stage_bins, threads, smem, per_sm = best
    tiles = -(-n_feat // ft) * -(-n_bins // bt) * -(-n_slots // st)
    want = max(1, _SMS * per_sm * _WAVE_SHARE[0] // _WAVE_SHARE[1] // tiles)
    chunk_rows = min(_MAX_CHUNK_ROWS,
                     max(_MIN_CHUNK_ROWS, _up(-(-max(n, 1) // want), _ROUND)))
    chunks = -(-max(n, 1) // chunk_rows)
    cluster = min(_MAX_CLUSTER, chunks)
    clusters = max(1, chunks // cluster)   # whole clusters within the wave
    if clusters > 1:
        per_part = n_feat * n_bins * n_slots * 3 * acc_bytes
        clusters = min(clusters, max(1, _SCRATCH_BYTES // per_part))
    n_chunks = clusters * cluster
    chunk_rows = _up(-(-max(n, 1) // n_chunks), _ROUND)
    if sub > chunk_rows:
        sub = chunk_rows
        smem = hist_smem(acc_bytes, ft, bt, st, groups, sub,
                         n_feat * bin_bytes if stage_bins else 0)
    return HistPlan(chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub,
                    stage_bins, threads, smem)


@functools.lru_cache(maxsize=512)
def scan_plan(n_feat: int, n_bins: int) -> ScanPlan:
    """The launch of `split_scan`: one block per node, one warp per
    feature (at most `_SCAN_MAX_WARPS`), each staging up to `seg` bins of
    12 bytes at a time within `_SCAN_SMEM` for the block."""
    warps = min(n_feat, _SCAN_MAX_WARPS)
    seg = min(n_bins, _SCAN_SMEM // (12 * warps))
    return ScanPlan(warps, seg, 12 * seg * warps)


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
    an (F, B, W, 3) histogram, each node's candidates held to its own
    least child weight `min_inst[w]`. The prefix over bins is a sequential f32
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
    mi = min_inst[:, None, None]
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
    if tuple(min_inst.shape) != (width,):
        raise ValueError(f"min_inst must be ({width},), one a node, got "
                         f"{tuple(min_inst.shape)}")
    if min(n_feat, n_bins, width) < 1 or 3 * n_feat * n_bins >= 2 ** 31:
        raise ValueError(f"empty or oversized histogram "
                         f"{tuple(hist.shape)}")
    _same_device_contiguous(hist, feat_mask, min_inst)


# ------------------------------------------------------------ launches
#: ctypes argument types of each entry point
HIST_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
    + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_SCAN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(name), f"sml_{name}")
        fn.argtypes = HIST_ARGTYPES if name == "hist_accumulate" \
            else _SCAN_ARGTYPES
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check_aligned(*ts) -> None:
    """The histogram kernel stages rows with bulk copies, which need
    16-byte-aligned addresses: raise for an operand that is not (a view
    at an odd offset), rather than copy it."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"hist_accumulate needs 16-byte-aligned "
                             f"operands; a {t.dtype} operand lies at "
                             f"{t.data_ptr():#x} (pass a fresh tensor)")


def launch_hist(fn, plan: HistPlan, binned, lid, grad, hess, weight,
                n_bins: int, n_slots: int, acc_dtype,
                record: bool = False) -> torch.Tensor:
    """Launch a `hist_accumulate` entry point (`fn`) with `plan` on the
    current stream; allocates the output and, with more than one
    cluster, the (clusters, F*B*S*3) `acc_dtype` scratch. `record` puts
    the launch into the prewarm manifest (`hist_accumulate`'s own)."""
    n, n_feat = binned.shape
    dev = binned.device
    out = torch.empty((n_feat * n_bins, n_slots * 3), dtype=torch.float32,
                      device=dev)
    parts = plan.n_chunks // plan.cluster
    scratch = None if parts == 1 else torch.empty(
        (parts, n_feat * n_bins * n_slots * 3), dtype=acc_dtype, device=dev)
    err = build.launch_on_stream(
        dev, fn, _BIN_BYTES[binned.dtype], binned.data_ptr(),
        lid.data_ptr(), grad.data_ptr(), hess.data_ptr(), weight.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), n,
        n_feat, n_bins, n_slots, plan.chunk_rows, plan.n_chunks, plan.ft,
        plan.bt, plan.st, plan.groups, plan.cluster, plan.sub_rows,
        plan.stage_bins, plan.threads,
        record=("hist_accumulate", plan, [binned, lid, grad, hess, weight],
                {"n_bins": n_bins, "n_slots": n_slots}) if record else None)
    if err != 0:
        raise RuntimeError(f"hist_accumulate launch failed: CUDA error {err} "
                           f"(n={n}, F={n_feat}, B={n_bins}, S={n_slots}, "
                           f"{plan})")
    return out


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

    CUDA operands (16-byte aligned) launch the kernel on the current
    stream: blocks of row chunks sum their cells in float64, clusters of
    them add their tiles in rank order, and (with more than one cluster)
    a second pass sums the clusters' partials in order, rounded to f32.
    The result is bit-identical from run to run. CPU operands run
    `hist_accumulate_plain`."""
    B, S = int(n_bins), int(n_slots)
    _check_hist(binned, lid, grad, hess, weight, B, S)
    dev = binned.device
    if dev.type == "cpu":
        return hist_accumulate_plain(binned, lid, grad, hess, weight, B, S)
    if dev.type != "cuda":
        raise ValueError(f"hist_accumulate runs on cuda or cpu, not {dev}")
    n, n_feat = binned.shape
    if n == 0:
        return torch.zeros((n_feat * B, S * 3), dtype=torch.float32,
                           device=dev)
    check_aligned(binned, lid, grad, hess, weight)
    plan = hist_plan(n, n_feat, B, S, bin_bytes=_BIN_BYTES[binned.dtype])
    out = launch_hist(_kernel("hist_accumulate"), plan, binned, lid, grad,
                      hess, weight, B, S, torch.float64, record=True)
    _count("hist_accumulate")
    return out


def split_scan(hist: torch.Tensor, feat_mask: torch.Tensor,
               min_inst: torch.Tensor, *, reg_lambda: float,
               gamma: float) -> torch.Tensor:
    """The (6, W) f32 best-split pack of every node of an (F, B, W, 3)
    histogram (see `split_scan_plain`). `feat_mask` is (W, F) f32 (a
    feature is a candidate where it is > 0), `min_inst` a (W,) f32: each
    node's least child weight.

    CUDA operands launch the kernel on the current stream; CPU operands
    run `split_scan_plain`."""
    _check_scan(hist, feat_mask, min_inst)
    dev = hist.device
    if dev.type == "cpu":
        return split_scan_plain(hist, feat_mask, min_inst, reg_lambda, gamma)
    if dev.type != "cuda":
        raise ValueError(f"split_scan runs on cuda or cpu, not {dev}")
    n_feat, n_bins, width = hist.shape[:3]
    plan = scan_plan(n_feat, n_bins)
    out = torch.empty((6, width), dtype=torch.float32, device=dev)
    err = build.launch_on_stream(
        dev, _kernel("split_scan"), hist.data_ptr(), feat_mask.data_ptr(),
        min_inst.data_ptr(), out.data_ptr(), n_feat, n_bins, width,
        plan.warps, plan.seg, float(reg_lambda), float(gamma),
        record=("split_scan", plan, [hist, feat_mask, min_inst],
                {"reg_lambda": float(reg_lambda), "gamma": float(gamma)}))
    if err != 0:
        raise RuntimeError(f"split_scan launch failed: CUDA error {err} "
                           f"(F={n_feat}, B={n_bins}, W={width}, {plan})")
    _count("split_scan")
    return out
