"""The tree build's two kernels: per-level histogram and split scan.

`hist_accumulate` and `split_scan` wrap the CUDA kernels in
`sml_tpu_torch/csrc/hist_accumulate.cu` and `csrc/split_scan.cu`, which
replace the TPU kernels of the same names in
`sml_tpu/native/hist_kernel.py`. Their signatures are the JAX ones
without `interpret`, `block_rows` and `hist_dtype`: operands and results
are f32, as the JAX package computes off the TPU, and the launches
(row ranges, tiles, clusters, staging; warps and bin segments) come from
the shapes (`hist_plan`, `scan_plan`, cached per shape), never from
configuration or from the device.

`hist_accumulate` sums in float64 and rounds each cell to f32 once,
deliberately above the Pallas body's f32 sums: the result then hardly
depends on the order of the sums, so the kernel and its plain version
give the same bits and a fit on the card grows the same trees as one on
the CPU. `chip_smoke.py` prices that against an f32-accumulating build
of the same kernel (`PERF.md`). With `out_dtype=torch.float64` it
returns the float64 sums unrounded, for a mesh of ranks to add before
the one rounding.

A CUDA tensor launches the kernel or raises. A CPU tensor runs the plain
PyTorch version (`hist_accumulate_plain`, `split_scan_plain`). Nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from . import build

#: kernel launches made by each wrapper in this process
LAUNCHES = {"hist_accumulate": 0, "split_scan": 0}
#: reads of the call's rows from device memory by `hist_accumulate`'s
#: kernel launches (its plans' `passes`, summed over the calls)
ROW_PASSES = {"hist_accumulate": 0}
_count_lock = threading.Lock()

_BIN_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
#: the histogram's output types, by the name the prewarm manifest keeps
_OUT_DTYPES = {torch.float32: "float32", torch.float64: "float64"}
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
#: warps of a block: owners, listers and the producer's
_MAX_WARPS = 32
#: rows a feature warp takes in one round (one to a lane); row ranges and
#: staged sub-chunks are multiples of it
_ROUND = 32
#: row buffers in a block's ring of a tile-split and of a row-split
#: cluster (`kTileSplitStages`, `kRowSplitStages` in the kernel), the rows
#: of one (the sizes the plan may take), and the most bytes of bins one holds
_STAGES = 4
_RS_STAGES = 3
_SUB_ROWS = (64, 128, 256, 512)
_STAGE_BIN_BYTES = 16 * 1024
#: blocks of a thread block cluster (the portable limit), and the clusters
#: of each size 1-8 that an H100 SXM runs at once at one block an SM
#: (`cudaOccupancyMaxActiveClusters` on the card: a cluster's blocks share
#: one GPC of 16-18 SMs); k blocks an SM hold about k times as many
_MAX_CLUSTER = 8
_CLUSTER_SLOTS = (132, 66, 39, 30, 22, 17, 15, 15)
#: bound on the row ranges' float64 partials
_SCRATCH_BYTES = 64 << 20
#: where a cluster splits the tiles of a row range: tiles of at most this
#: many slots, row ranges of at least this many rows. Else its blocks
#: split the rows of one tile: a slot that holds most of a level's rows
#: (as deep levels of a boosted fit do) then spreads over many blocks, and
#: a small call over many short blocks
_TILE_SPLIT_SLOTS = 4
_TILE_SPLIT_ROWS = 65536
#: row-split clusters: a tile's bytes (four blocks an SM), owning warps an
#: SM is given before other choices count, the sub-chunk sizes and staged
#: bins, the rows of one block, and the share of the card's block slots
#: one wave of clusters is sized to fill (a cluster's blocks share one GPC)
_RS_TILE_BYTES = 52 * 1024
_RS_MAX_WARPS = 16
_RS_MIN_THREADS = 256
_RS_SM_WARPS = 12
_RS_SUB_ROWS = (64, 128, 256)
_RS_STAGE_BIN_BYTES = 8 * 1024
_RS_MIN_CHUNK_ROWS = 256
_RS_MAX_CHUNK_ROWS = 4096
_RS_WAVE_SHARE = (7, 8)
#: the plan's cost model, fitted to the kernel's times on an H100 at
#: HIGGS's level shapes (PERF.md): an owner round (up to 32 rows of one
#: feature) takes about `_ROUND_LATENCY` cycles from one to the warp's
#: next, and an SM retires at most one every `_ROUND_CYCLES` cycles over
#: all its warps; below the root about half the rows weigh 0; the boost
#: clock, the bandwidth, and the cost of the second launch
_ROUND_CYCLES = 110
_ROUND_LATENCY = 1500
_CLOCK_HZ = 1.98e9
_HBM_BYTES_PER_S = 3.35e12
_LAUNCH_S = 3e-6
#: split_scan: dynamic shared memory of one block (48 KB without opting
#: in, less the block's 256 static bytes), and warps (features) per block
_SCAN_SMEM = 47 * 1024
_SCAN_MAX_WARPS = 16


class HistPlan(NamedTuple):
    chunk_rows: int   # rows of a row range, a multiple of 32
    n_chunks: int     # row ranges (with split_rows, a multiple of cluster)
    ft: int           # features per tile
    bt: int           # bins per tile
    st: int           # slots per tile
    groups: int       # slot groups of a tile (one warp each per feature)
    cluster: int      # blocks per thread block cluster
    passes: int       # reads of the rows: tiles / cluster, or tiles
    sub_rows: int     # rows staged at a time, a multiple of 32
    stage_bins: int   # 1: bins are staged too; 0: read from global memory
    threads: int      # per block: owners, listers and the producer
    smem: int         # dynamic shared memory of a block, in bytes
    split_rows: int   # 0: a cluster's blocks hold `cluster` tiles of one
                      # row range; 1: they hold one tile, a range each


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
              sub_rows: int, row_bin_bytes: int, stages: int) -> int:
    """Dynamic shared memory of one `hist_accumulate` block, as the
    kernel lays it out (`Layout` in `csrc/hist_accumulate.cu`): a full
    and an empty mbarrier per stage, the tile, a one-byte lane tag per
    cell, two lists of rows (uint16) of each slot group and their counts,
    and a ring of `stages` row buffers of [bins][lid][g][h][w]."""
    keys = ft * bt * st
    buf = _up(sub_rows * row_bin_bytes, 16) + 16 * sub_rows
    return (_up(16 * stages, 16) + _up(3 * acc_bytes * keys, 16)
            + _up(keys, 16) + _up(4 * groups * sub_rows, 16)
            + _up(8 * groups, 16) + stages * buf)


def _tiles(n_feat: int, n_bins: int, n_slots: int, cell: int,
           row_bin_bytes: int):
    """Candidate tiles (ft, bt, st) that fit a block beside the least
    ring: whole features (every bin and slot) where one fits, else one
    feature's slots in tiles, else one slot's bins."""
    sub = _SUB_ROWS[0]
    staged = row_bin_bytes if sub * row_bin_bytes <= _STAGE_BIN_BYTES else 0
    room = _SMEM_BLOCK - hist_smem(0, 0, 0, 0, 1, sub, staged, _STAGES)
    if n_bins * n_slots * cell <= room:
        return [(ft, n_bins, n_slots)
                for ft in sorted({_even(n_feat, k)
                                  for k in range(1, n_feat + 1)})
                if ft * n_bins * n_slots * cell <= room]
    if n_bins * cell <= room:
        return [(1, n_bins, st)
                for st in sorted({_even(n_slots, k)
                                  for k in range(1, n_slots + 1)})
                if n_bins * st * cell <= room]
    return [(1, _even(n_bins, room // cell), 1)]


def _cost_s(n: int, n_feat: int, cells: int, row_bytes: int, acc_bytes: int,
            ft: int, groups: int, sub: int, per_sm: int, passes: int,
            chunks: int) -> float:
    """The cost model's seconds of one launch: the owners' rounds on the
    busiest SM (at the shared-memory pipe's rate, or at the round's
    latency over the SM's owning warps, whichever is slower, with each
    round's lanes filled by a group's rows of a sub-chunk), or the rows'
    reads from device memory, whichever is longer; then the row ranges'
    partials written and read, and the second launch."""
    chunk = _up(-(-n // chunks), _ROUND)
    per_group = max(1.0, min(sub, chunk) / (2 * groups))
    fill = per_group / (_ROUND * -(-per_group // _ROUND))
    rounds = per_sm * ft * chunk / (2 * _ROUND * fill)
    cycles = max(_ROUND_CYCLES, _ROUND_LATENCY / (per_sm * ft * groups))
    compute = rounds * cycles / _CLOCK_HZ
    reads = passes * n * row_bytes / _HBM_BYTES_PER_S
    parts = 0.0 if chunks == 1 else \
        2 * chunks * cells * 3 * acc_bytes / _HBM_BYTES_PER_S + _LAUNCH_S
    return max(compute, reads) + parts


@functools.lru_cache(maxsize=512)
def hist_plan(n: int, n_feat: int, n_bins: int, n_slots: int, *,
              bin_bytes: int = 1, acc_bytes: int = 8) -> HistPlan:
    """The launch of `hist_accumulate`, from the shapes alone: clusters
    that split the tiles of a row range (`_tile_split_plan`) where its
    tiles hold at most `_TILE_SPLIT_SLOTS` slots and its row ranges at
    least `_TILE_SPLIT_ROWS` rows, else clusters that split the rows of a
    tile (`_row_split_plan`). The first reads a level's rows once for up
    to 8 tiles; the second reads them once a tile, but spreads each
    tile's rows over many short blocks, which a level whose rows crowd
    into a few slots, or a small call, needs (PERF.md: at HIGGS's deep
    levels one slot held 43-54% of the weighted rows)."""
    plan = _tile_split_plan(n, n_feat, n_bins, n_slots, bin_bytes,
                            acc_bytes)
    if plan.st <= _TILE_SPLIT_SLOTS \
            and max(n, 1) >= _TILE_SPLIT_ROWS * plan.n_chunks:
        return plan
    return _row_split_plan(n, n_feat, n_bins, n_slots, bin_bytes, acc_bytes)


def _tile_split_plan(n: int, n_feat: int, n_bins: int, n_slots: int,
                     bin_bytes: int, acc_bytes: int) -> HistPlan:
    """The launch of `hist_accumulate` with clusters that split tiles.

    The level's histogram (F x B x S cells of three sums of `acc_bytes`,
    8: the port's float64; 4: the f32-accumulating build that
    `chip_smoke.py` times, and a one-byte lane tag) is cut into tiles of
    ft features x bt bins x st slots, each held by one block in its own
    shared memory: whole features where one fits a block (up to
    `_SMEM_BLOCK` with its ring), else one feature's slots, else one
    slot's bins. A thread block cluster of up to `_MAX_CLUSTER` blocks
    holds as many tiles and reads a row range once for all of them, so
    the rows cross device memory `passes` = ceil(tiles / cluster) times.
    A warp owns one feature's cells of one of `groups` slot groups and
    walks only the rows of its group, which a listing warp per group
    lists a sub-chunk ahead; block 0's producer warp stages `sub_rows`
    rows at a time into every block's ring of `_STAGES` buffers (their
    bins too, when they fit `_STAGE_BIN_BYTES`).

    Of the tiles, group counts and sub-chunk sizes that fit a block, the
    plan takes those with the fewest passes, then the least time by its
    cost model (`_cost_s`: the owners' rounds at the SM's rate or at
    their own latency, with lanes filled by a group's rows of a
    sub-chunk, against the rows' reads and the partials' traffic; costs
    within 5% count as equal), then fewer tiles and groups. The adds,
    not the reads, set the pace at every shape the port runs: a round
    costs about 1,500 cycles of one warp's time, so the plan wants many
    owning warps with full rounds, and tiles sized to the SM serve that
    too. Row ranges: as many clusters a pass as the card
    runs at once (`_CLUSTER_SLOTS`, times the blocks an SM holds), or
    fewer where the partials' traffic costs more than the rows' spread
    saves, within `_SCRATCH_BYTES` of partials."""
    cell = 3 * acc_bytes + 1   # three sums and the cell's lane tag
    cells = n_feat * n_bins * n_slots
    row_bytes = n_feat * bin_bytes + 16
    n = max(n, 1)
    best = None
    for ft, bt, st in _tiles(n_feat, n_bins, n_slots, cell,
                             n_feat * bin_bytes):
        tiles = -(-n_feat // ft) * -(-n_bins // bt) * -(-n_slots // st)
        passes = -(-tiles // _MAX_CLUSTER)
        cluster = -(-tiles // passes)
        for groups in range(1, min(st, 16) + 1):
            if (groups - 1) * -(-st // groups) >= st \
                    or (ft + 1) * groups + 1 > _MAX_WARPS:
                continue   # a group with no slot, or too many warps
            threads = 32 * ((ft + 1) * groups + 1)
            for sub in _SUB_ROWS:
                stage_bins = sub * n_feat * bin_bytes <= _STAGE_BIN_BYTES
                smem = hist_smem(acc_bytes, ft, bt, st, groups, sub,
                                 n_feat * bin_bytes if stage_bins else 0,
                                 _STAGES)
                per_sm = min(_SMEM_SM // (smem + _SMEM_RESERVED),
                             _SM_THREADS // threads,
                             _SM_REGS // (threads * _REGS))
                if smem > _SMEM_BLOCK or per_sm < 1:
                    continue
                most = max(1, min(_CLUSTER_SLOTS[cluster - 1] * per_sm
                                  // passes, -(-n // _ROUND),
                                  _SCRATCH_BYTES // (cells * 3 * acc_bytes)))
                for chunks in {most} | {1 << k for k in range(20)
                                        if 1 << k < most}:
                    cost = _cost_s(n, n_feat, cells, row_bytes, acc_bytes,
                                   ft, groups, sub, per_sm, passes, chunks)
                    # costs within 5% count as equal: the model is no
                    # closer than that to the card
                    key = (passes, round(math.log(cost) / math.log(1.05)),
                           tiles, groups, -stage_bins, -sub, cost)
                    if best is None or key < best[0]:
                        best = (key, ft, bt, st, groups, cluster, passes,
                                sub, int(stage_bins), threads, chunks)
    _, ft, bt, st, groups, cluster, passes, sub, stage_bins, threads, \
        chunks = best
    chunk_rows = _up(-(-n // chunks), _ROUND)
    n_chunks = -(-n // chunk_rows)
    sub = min(sub, chunk_rows)
    smem = hist_smem(acc_bytes, ft, bt, st, groups, sub,
                     n_feat * bin_bytes if stage_bins else 0,
                     _STAGES)
    return HistPlan(chunk_rows, n_chunks, ft, bt, st, groups, cluster,
                    passes, sub, stage_bins, threads, smem, 0)


def _row_split_plan(n: int, n_feat: int, n_bins: int, n_slots: int,
                    bin_bytes: int, acc_bytes: int) -> HistPlan:
    """The launch of `hist_accumulate` with clusters that split rows.

    A tile of ft features x bt bins x st slots and its lane tags fit
    `_RS_TILE_BYTES` (features are tiled first, then slots, then bins);
    each block adds one range of rows into it, staged by itself into a
    ring of `_RS_STAGES` sub-chunks (one fewer than a tile-split block's:
    the room goes to a third or fourth block an SM), and the
    blocks of a cluster (consecutive ranges of one tile) sum their tiles
    through distributed shared memory into one partial. Of the feature
    tiles, group counts and sub-chunk sizes that fit, the plan takes the
    one that keeps the most owning warps resident on an SM (up to
    `_RS_SM_WARPS`; then fewer groups, wider feature tiles, staged bins,
    longer sub-chunks). Row ranges are sized so that about one wave of
    blocks covers the rows (`_RS_MIN_CHUNK_ROWS` to `_RS_MAX_CHUNK_ROWS`
    rows), grouped in whole clusters of up to `_MAX_CLUSTER`, whose
    float64 partials stay within `_SCRATCH_BYTES`, else ranges grow."""
    cell = 3 * acc_bytes + 1
    if n_bins * n_slots * cell <= _RS_TILE_BYTES:
        bt, st = n_bins, n_slots
        ft_most = min(_RS_MAX_WARPS,
                      _RS_TILE_BYTES // (n_bins * n_slots * cell))
    elif n_bins * cell <= _RS_TILE_BYTES:
        ft_most, bt = 1, n_bins
        st = _even(n_slots, _RS_TILE_BYTES // (n_bins * cell))
    else:
        ft_most, st = 1, 1
        bt = _even(n_bins, _RS_TILE_BYTES // cell)
    best = None
    for ft in sorted({_even(n_feat, k) for k in range(1, ft_most + 1)}):
        for groups in (1, 2, 4, 8, 16):
            if groups > st or (ft + 1) * groups + 1 > _RS_MAX_WARPS \
                    or (groups - 1) * -(-st // groups) >= st:
                continue   # too many warps, or a group with no slot
            for sub in _RS_SUB_ROWS:
                if sub < _ROUND * groups:
                    continue
                stage_bins = sub * n_feat * bin_bytes <= _RS_STAGE_BIN_BYTES
                threads = 32 * max((ft + 1) * groups + 1,
                                   _RS_MIN_THREADS // 32)
                smem = hist_smem(acc_bytes, ft, bt, st, groups, sub,
                                 n_feat * bin_bytes if stage_bins else 0,
                                 _RS_STAGES)
                per_sm = min(_SMEM_SM // (smem + _SMEM_RESERVED),
                             _SM_THREADS // threads,
                             _SM_REGS // (threads * _REGS))
                if smem > _SMEM_BLOCK or per_sm < 1:
                    continue
                score = (min(per_sm * ft * groups, _RS_SM_WARPS), -groups,
                         ft, stage_bins, sub)
                if best is None or score > best[0]:
                    best = (score, ft, groups, sub, int(stage_bins), threads,
                            per_sm)
    _, ft, groups, sub, stage_bins, threads, per_sm = best
    tiles = -(-n_feat // ft) * -(-n_bins // bt) * -(-n_slots // st)
    n = max(n, 1)
    want = max(1, _SMS * per_sm * _RS_WAVE_SHARE[0] // _RS_WAVE_SHARE[1]
               // tiles)
    chunk_rows = min(_RS_MAX_CHUNK_ROWS,
                     max(_RS_MIN_CHUNK_ROWS, _up(-(-n // want), _ROUND)))
    chunks = -(-n // chunk_rows)
    cluster = min(_MAX_CLUSTER, chunks)
    clusters = max(1, chunks // cluster)   # whole clusters within the wave
    if clusters > 1:
        per_part = n_feat * n_bins * n_slots * 3 * acc_bytes
        clusters = min(clusters, max(1, _SCRATCH_BYTES // per_part))
    n_chunks = clusters * cluster
    chunk_rows = _up(-(-n // n_chunks), _ROUND)
    sub = min(sub, chunk_rows)
    smem = hist_smem(acc_bytes, ft, bt, st, groups, sub,
                     n_feat * bin_bytes if stage_bins else 0,
                     _RS_STAGES)
    return HistPlan(chunk_rows, n_chunks, ft, bt, st, groups, cluster,
                    tiles, sub, stage_bins, threads, smem, 1)


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
                          n_slots: int,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops: (F*B, S*3) f32, cell
    ((f*B + b)*S + s)*3 + k. Each row with w > 0, a slot in [0, S) and
    bin b in [0, B) adds (g*w, h*w, w) to cell (f, b, lid) of every
    feature f; the products are f32, as in the kernel. The sums run in
    float64 (`index_add_`, in row order on the CPU) and are rounded to
    f32 once, as in the kernel, which sums in another order; with
    `out_dtype=torch.float64` they come back unrounded. (The JAX body's
    one-hot product spreads a non-finite product to every cell; here,
    as in the kernel, a row adds only to its own cells.)"""
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
    return out.to(out_dtype).reshape(n_feat * B, S * 3)


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
    + [ctypes.c_int] * 15 + [ctypes.c_void_p]
_SCAN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def _kernel(name: str, entry: str = ""):
    """Entry point `sml_<name><entry>` of kernel library `name`."""
    fn = _fns.get(name + entry)
    if fn is None:
        fn = getattr(build.load(name), f"sml_{name}{entry}")
        fn.argtypes = HIST_ARGTYPES if name == "hist_accumulate" \
            else _SCAN_ARGTYPES
        fn.restype = ctypes.c_int
        _fns[name + entry] = fn
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
                record: bool = False,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch a `hist_accumulate` entry point (`fn`) with `plan` on the
    current stream; allocates the `out_dtype` output and, with more than
    one row range, the (row ranges, F*B*S*3) `acc_dtype` scratch.
    `record` puts the launch into the prewarm manifest
    (`hist_accumulate`'s own)."""
    n, n_feat = binned.shape
    dev = binned.device
    out = torch.empty((n_feat * n_bins, n_slots * 3), dtype=out_dtype,
                      device=dev)
    scalars = {"n_bins": n_bins, "n_slots": n_slots}
    if out_dtype != torch.float32:
        scalars["out_dtype"] = _OUT_DTYPES[out_dtype]
    parts = plan.n_chunks // plan.cluster if plan.split_rows \
        else plan.n_chunks
    scratch = None if parts == 1 else torch.empty(
        (parts, n_feat * n_bins * n_slots * 3), dtype=acc_dtype, device=dev)
    err = build.launch_on_stream(
        dev, fn, _BIN_BYTES[binned.dtype], binned.data_ptr(),
        lid.data_ptr(), grad.data_ptr(), hess.data_ptr(), weight.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), n,
        n_feat, n_bins, n_slots, plan.chunk_rows, plan.n_chunks, plan.ft,
        plan.bt, plan.st, plan.groups, plan.cluster, plan.sub_rows,
        plan.stage_bins, plan.threads, plan.split_rows,
        record=("hist_accumulate", plan, [binned, lid, grad, hess, weight],
                scalars) if record else None)
    if err != 0:
        raise RuntimeError(f"hist_accumulate launch failed: CUDA error {err} "
                           f"(n={n}, F={n_feat}, B={n_bins}, S={n_slots}, "
                           f"{plan})")
    return out


def _count(name: str, passes: int = 0) -> None:
    with _count_lock:
        LAUNCHES[name] += 1
        if passes:
            ROW_PASSES[name] += passes


def hist_accumulate(binned: torch.Tensor, lid: torch.Tensor,
                    grad: torch.Tensor, hess: torch.Tensor,
                    weight: torch.Tensor, *, n_bins: int, n_slots: int,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Partial histogram of one tree level, (F*n_bins, n_slots*3) f32,
    on the operands' device (see `hist_accumulate_plain` for the cell
    layout). `binned` is the compact bin matrix, `lid` each row's slot,
    `weight` its weight (0 leaves the row out). `out_dtype=torch.float64`
    (or "float64") returns the float64 sums unrounded: their f32
    rounding is the f32 output bit for bit (a mesh of ranks adds its
    ranks' sums before it rounds).

    CUDA operands (16-byte aligned) launch the kernel on the current
    stream: thread block clusters that read a row range once for the
    tiles of all their blocks, or that split a tile's rows over their
    blocks (`hist_plan`), sum the cells in float64, and (with more than
    one cluster) a second kernel sums the clusters' partials in order,
    rounded to f32 (or not). The result is bit-identical from run to
    run. CPU operands run `hist_accumulate_plain`."""
    B, S = int(n_bins), int(n_slots)
    if isinstance(out_dtype, str):
        out_dtype = getattr(torch, out_dtype)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or float64, got "
                        f"{out_dtype}")
    _check_hist(binned, lid, grad, hess, weight, B, S)
    dev = binned.device
    if dev.type == "cpu":
        return hist_accumulate_plain(binned, lid, grad, hess, weight, B, S,
                                     out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"hist_accumulate runs on cuda or cpu, not {dev}")
    n, n_feat = binned.shape
    if n == 0:
        return torch.zeros((n_feat * B, S * 3), dtype=out_dtype, device=dev)
    check_aligned(binned, lid, grad, hess, weight)
    return _launch_level(binned, lid, grad, hess, weight, B, S, out_dtype)


def _launch_level(binned, lid, grad, hess, weight, n_bins: int,
                  n_slots: int, out_dtype) -> torch.Tensor:
    """One checked `hist_accumulate` call's launch with its shapes' plan,
    counted in `LAUNCHES` and `ROW_PASSES`."""
    n, n_feat = binned.shape
    plan = hist_plan(n, n_feat, n_bins, n_slots,
                     bin_bytes=_BIN_BYTES[binned.dtype])
    entry = "" if out_dtype == torch.float32 else "_f64out"
    out = launch_hist(_kernel("hist_accumulate", entry), plan, binned, lid,
                      grad, hess, weight, n_bins, n_slots, torch.float64,
                      record=True, out_dtype=out_dtype)
    _count("hist_accumulate", plan.passes)
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
