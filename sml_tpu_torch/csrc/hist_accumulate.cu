// Per-level partial histogram of the tree build, from the compact bin matrix.
//
// Replaces the TPU kernel `hist_accumulate` in sml_tpu/native/hist_kernel.py
// (the Pallas body at :156, launched at :185). It computes the same
// function: for each (feature f, bin b, slot s) cell, the sums of
// g[r]*w[r], h[r]*w[r] and w[r] over the rows r with w[r] > 0,
// lid[r] == s and binned[r][f] == b, into an (F*B, S*3) f32 array
// (cell ((f*B + b)*S + s)*3 + k). A row whose slot or bin lies outside
// [0, S) or [0, B) adds nothing, as its one-hot row is zero in the
// Pallas body.
//
// What bounds it on an H100. Per level it reads n*(F*binbytes + 16)
// bytes of rows and writes F*B*S*12 bytes of histogram: at HIGGS's shape
// (10.5M rows x 28 uint8 features, 256 bins) 462 MB, 0.14 ms at 3.35
// TB/s, against three float64 adds for each of a row's F cells. What
// holds it above that is latency: a warp adds its rows 32 at a time, and
// each round is a chain of shared-memory reads, a vote, and
// read-add-writes of float64 cells (about 1,500 cycles of the warp's time
// on the card, PERF.md), so the adds, not the reads, set the pace at
// every shape the port runs. Only warps that own cells do that
// work, and the float64 cells they own take the shared memory (256 bins
// x 16 slots of one feature is 96 KB). The Pallas body builds two
// one-hot tiles and contracts them on the MXU because that was the TPU's
// fast path; here that would be O(n*F*B) wasted work, so rows are added
// straight into their cells.
//
// The design before this one gave each tile of 52 KB (a few features x
// bins x slots) its own blocks, each staging every row: at 16 slots and
// 256 bins that is 56 tiles, so a level's rows crossed device memory 56
// times, 13.6 ms a call against a bound of 0.14 ms. Reading them once
// (below) measured that the passes cost less than thought: the adds set
// the pace, and where one slot holds most rows, the spread of its work
// over many blocks matters more than the passes (PERF.md). (The design
// before that, a block per 2,048-row chunk whose warps walked it through
// dependent loads from L2, ran some 100x its bound.)
//
// Design. A thread block cluster of up to 8 blocks splits either the
// tiles of a row range or the rows of a tile; the plan picks by shape.
// - Tile-split clusters (one read of the rows for many tiles): a cluster
//   reads a contiguous range of rows once. Each block of it owns a
//   different tile of the
//   level's histogram (ft features x bt bins x st slots, features tiled
//   first, then slots, then bins), held in its own shared memory, which
//   is sized to the SM (one block an SM at HIGGS's shape), not to a
//   budget that leaves room for other blocks. A pass is the grid's
//   clusters over all rows for the tiles of one cluster; gridDim.y counts
//   the passes, so a histogram of at most 8 tiles takes one read of the
//   rows. The blocks are persistent, one wave over long row ranges, so a
//   slot that holds most of a level's rows lands on few warps: the plan
//   takes them for levels of a few slots and many rows (HIGGS's levels
//   0-3, 1.3-1.5x faster than the design before).
// - Row-split clusters (the design before, kept for the rest): a tile of
//   at most 52 KB a block, consecutive short row ranges of one tile a
//   cluster, each block staging its own rows into a ring one sub-chunk
//   shorter (a deeper one cost the course's shapes a block an SM, or
//   half their sub-chunk, 5-40%), many waves of blocks; after
//   the adds the cluster sums its blocks' tiles cell by cell in rank
//   order through distributed shared memory into one partial. A skewed
//   level spreads over many blocks, and a small call over short ones.
// - The launch plan (hist_plan in native/hist_kernel.py) picks the kind,
//   the tile, the slot groups, the staging size and the clusters, from
//   the shapes alone.
// - The rows are staged once for the whole cluster: a producer thread of
//   block 0 copies each sub-chunk of `sub_rows` rows (the bins of all F
//   features, lid, g, h and w) from device memory into the same offset of
//   every block's ring with one multicast bulk copy a column
//   (cp.async.bulk ... .multicast::cluster), completing on each block's
//   own mbarrier. Multicast rather than peers reading block 0's copy
//   through distributed shared memory: the owners read their rows in a
//   data-dependent order, a round at a time, and a remote read costs
//   them several times a local one; multicast also reads L2 once for
//   the cluster. Each block arms its own "full" barrier for a sub-chunk
//   and, once it is done with a ring slot, arrives on block 0's "empty"
//   barrier for it; the producer refills a slot when every block has
//   released it. The ring holds 4 sub-chunks (kTileSplitStages), 3 in
//   row-split clusters (kRowSplitStages).
// - A tile's slots fall into `groups` slot groups; warp (fi, g) owns
//   feature fi's cells of group g outright and walks only the rows whose
//   slot lies in group g. One listing warp per group waits for a
//   sub-chunk one step ahead of the owners and lists, in row order, its
//   weighted rows whose slot lies in the group (ballots), into one of two
//   lists.
// - An owner takes its group's rows 32 at a time, a row to a lane, loading
//   the next round's rows ahead of this round's adds. To find out whether
//   two lanes hit one (bin, slot) cell, each writes its lane number to the
//   cell's one-byte tag and reads it back: the lanes of one cell all read
//   the one lane whose write stayed, and five ballots over its bits group
//   them (the groups __match_any_sync would give; it serialises over the
//   distinct cells of a warp, and cost a fifth of the kernel's time at
//   one slot). The lowest lane of each group sums the group's products
//   in lane order, taking its members' by shuffles while all lanes step
//   through the largest group together (reloading them from the ring
//   made a feature with three distinct bins, as HIGGS's b-tags are, the
//   straggler of its block), and adds the sum to the cell; a lane alone
//   adds its own row. (The tags need no clearing, as only this round's
//   writes are read.)
// - Bulk copies need 16-byte-aligned addresses and sizes: the wrapper
//   checks the operands' alignment, row ranges and sub-chunks are
//   multiples of 32 rows, and the last (n mod 16) rows of the matrix are
//   loaded by plain loads.
// - Each cluster writes its float64 partial, and a second kernel sums the
//   partials in order and rounds to f32. With one partial the blocks
//   round and write the output themselves: one launch, no scratch.
//
// Numerics. The products g*w and h*w are rounded to f32, as in the
// Pallas body; the sums run in float64 and each cell is rounded to f32
// once at the end. This is deliberately above the Pallas body's f32
// sums. The result is the f32 rounding of a float64 sum whose order
// barely matters: the plain PyTorch version, which sums in float64 in
// another order, gives the same bits except where a sum lies within its
// float64 error of an f32 rounding boundary (then 1 ulp apart). That
// keeps a fit on the card and one on the CPU on the same trees, where
// f32 sums in two orders would flip near-tied splits. The entry point
// sml_hist_accumulate_f32acc is the same kernel with f32 sums; the
// port does not call it, and chip_smoke.py times it beside this one to
// price the float64 sums. sml_hist_accumulate_f64out writes the float64
// sums themselves, unrounded: a fit over a mesh of ranks all-reduces
// them and rounds once, so that N ranks round where one rank does.
//
// Determinism. The fit needs bit-stable histograms from run to run (the
// warm-start contract), so there are no float atomics: the order of every
// add follows from the inputs and the plan (row ranges, tiles, slot
// groups, sub-chunks), which the wrapper derives from the shapes alone.
// A cell is owned by one warp of one block in each row range, which adds
// its rows in row order; the partials are summed in row-range order.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing (the wrapper allocates the output and the scratch).
// Returns the first CUDA error of the launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kReduceThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxThreads = 1024;
// one block of kMaxThreads an SM: caps a thread at 64 registers, which
// hist_plan counts on (_REGS)
constexpr int kMinBlocks = 1;
// row buffers in a block's ring: the tile-split clusters' producer
// serves up to 8 blocks and keeps more sub-chunks in flight; a
// row-split block's smaller ring leaves room for one more block an SM
constexpr int kTileSplitStages = 4;
constexpr int kRowSplitStages = 3;

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
// a cell's sum into the output: rounded to f32 once, or kept in float64
// (the f64 output, for a caller that adds the sums of several devices
// before it rounds)
__device__ __forceinline__ void store(float* p, double a) {
  *p = __double2float_rn(a);
}
__device__ __forceinline__ void store(float* p, float a) { *p = a; }
__device__ __forceinline__ void store(double* p, double a) { *p = a; }

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the dynamic shared memory of one block (mirrored by
// hist_plan's `smem`): a "full" and an "empty" mbarrier per stage, the
// tile, a one-byte lane tag per cell of the tile, two lists of rows of
// each slot group and their counts, then a ring of `stages` row buffers,
// each [bins][lid][g][h][w]. Every block of a cluster has the same
// layout, so a multicast copy lands at one offset in all of them.
struct Layout {
  size_t tile_off, tag_off, list_off, count_off, buf_off, buf_bytes, lid_off,
      g_off, h_off, w_off, total;
  __host__ __device__ Layout(int acc_bytes, int ft, int bt, int st,
                             int groups, int sub_rows, int row_bin_bytes,
                             int stages) {
    const size_t keys = static_cast<size_t>(ft) * bt * st;
    tile_off = round16(16 * static_cast<size_t>(stages));
    tag_off = tile_off + round16(static_cast<size_t>(acc_bytes) * 3 * keys);
    list_off = tag_off + round16(keys);
    count_off = list_off + round16(4 * static_cast<size_t>(groups) * sub_rows);
    buf_off = count_off + round16(8 * static_cast<size_t>(groups));
    lid_off = round16(static_cast<size_t>(sub_rows) * row_bin_bytes);
    g_off = lid_off + 4 * static_cast<size_t>(sub_rows);
    h_off = g_off + 4 * static_cast<size_t>(sub_rows);
    w_off = h_off + 4 * static_cast<size_t>(sub_rows);
    buf_bytes = w_off + 4 * static_cast<size_t>(sub_rows);
    total = buf_off + stages * buf_bytes;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Arrives on the mbarrier at `bar`'s offset in block `rank` of the
// cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A copy that
// never lands traps (the launch fails with an error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned)
// from global memory to shared memory at `dst`'s offset: into this block
// alone (mask 0), or into each block of the cluster in `mask`, each
// completing on the mbarrier at `bar`'s offset in that block.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar,
                                         uint16_t mask) {
  if (mask == 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
  }
}

// Consumers' barrier (id 2): every warp of the block but the producer's.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 2, %0;\n" ::"r"(threads) : "memory");
}

template <typename BinT>
struct Rows {
  const BinT* binned;
  const int32_t* lid;
  const float* grad;
  const float* hess;
  const float* weight;
};

// The bulk part of a sub-chunk of cnt rows: a multiple of 16 rows.
__device__ __forceinline__ uint32_t bulk_rows(int cnt) {
  return static_cast<uint32_t>(cnt) & ~15u;
}

// Bytes a block's copy of a sub-chunk of cnt rows brings.
__device__ __forceinline__ uint32_t fill_bytes(int cnt, int row_bin_bytes) {
  return bulk_rows(cnt) * (static_cast<uint32_t>(row_bin_bytes) + 16u);
}

// The producer: copy rows [r, r + cnt) (the bulk part) into buffer `buf`
// of the blocks in `mask` (this block alone for 0), completing on `bar`.
template <typename BinT>
__device__ __forceinline__ void issue_rows(const Rows<BinT>& in,
                                           unsigned char* buf,
                                           const Layout& L, uint64_t* bar,
                                           int64_t r, int cnt, int n_feat,
                                           bool stage_bins, uint16_t mask) {
  const uint32_t bulk = bulk_rows(cnt);
  if (bulk == 0) return;
  if (stage_bins) {
    bulk_g2s(buf, in.binned + r * n_feat,
             bulk * n_feat * static_cast<uint32_t>(sizeof(BinT)), bar, mask);
  }
  bulk_g2s(buf + L.lid_off, in.lid + r, 4u * bulk, bar, mask);
  bulk_g2s(buf + L.g_off, in.grad + r, 4u * bulk, bar, mask);
  bulk_g2s(buf + L.h_off, in.hess + r, 4u * bulk, bar, mask);
  bulk_g2s(buf + L.w_off, in.weight + r, 4u * bulk, bar, mask);
}

// AccT is the type of the sums: double in the port, float in the
// f32-accumulating build that is only timed. OutT is the output's: f32,
// or double for the unrounded sums. `partial` is null when the grid
// holds one row range (the blocks then write `out`).
//
// A cluster splits either the tiles or the rows, one instantiation
// each, so that each compiles with its own ring depth and no branch on
// the kind. Tiles (SplitRows false):
// grid (cluster x row ranges, passes); block `rank` of cluster c of pass
// p owns tile p * cluster + rank of the histogram (none past the last)
// and adds the rows of range c, [c * chunk_rows, (c + 1) * chunk_rows),
// staged for the whole cluster by block 0. Rows (SplitRows true): grid
// (row ranges, tiles); the blocks of a cluster own one tile, each adds
// its own range of rows, staged by itself, and the cluster sums its
// blocks' tiles through distributed shared memory into one partial.
template <typename BinT, typename AccT, typename OutT, bool SplitRows>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
hist_cluster_kernel(Rows<BinT> in, AccT* __restrict__ partial,
                    OutT* __restrict__ out, int n, int n_feat, int n_bins,
                    int n_slots, int chunk_rows, int sub_rows, int ft,
                    int bt, int st, int groups, int stage_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bin_bytes =
      stage_bins ? n_feat * static_cast<int>(sizeof(BinT)) : 0;
  constexpr bool split_rows = SplitRows;
  constexpr int stages = SplitRows ? kRowSplitStages : kTileSplitStages;
  const Layout L(sizeof(AccT), ft, bt, st, groups, sub_rows, row_bin_bytes,
                 stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);       // [stages]
  uint64_t* empty = full + stages;                          // [stages]
  AccT* hist = reinterpret_cast<AccT*>(smem + L.tile_off);  // [ft][bt][st][3]
  uint8_t* tag = smem + L.tag_off;                          // [ft][bt][st]
  uint16_t* list =
      reinterpret_cast<uint16_t*>(smem + L.list_off);  // [2][groups][sub_rows]
  int* count = reinterpret_cast<int*>(smem + L.count_off);  // [2][groups]
  unsigned char* bufs = smem + L.buf_off;                   // [stages]

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_btiles = (n_bins + bt - 1) / bt;
  const int n_stiles = (n_slots + st - 1) / st;
  const int n_tiles = (n_feat + ft - 1) / ft * n_btiles * n_stiles;
  // the cluster's first tile, and its blocks that own one
  const int first = static_cast<int>(blockIdx.y) * (split_rows ? 1 : csize);
  const int n_live = split_rows ? csize : min(csize, n_tiles - first);
  if (rank >= n_live) {  // no tile: no row of the pass comes here
    cluster.sync();
    cluster.sync();
    return;
  }
  const int tile = split_rows ? first : first + rank;
  const int f0 = tile / (n_btiles * n_stiles) * ft;
  const int b0 = tile / n_stiles % n_btiles * bt;
  const int s0 = tile % n_stiles * st;
  const int64_t begin =
      static_cast<int64_t>(split_rows ? blockIdx.x : blockIdx.x / csize) *
      chunk_rows;
  // the block whose producer stages this block's rows
  const int stager = split_rows ? rank : 0;
  const int64_t end = begin + chunk_rows < n ? begin + chunk_rows
                                             : static_cast<int64_t>(n);
  const int rows = end > begin ? static_cast<int>(end - begin) : 0;
  const int n_sub = (rows + sub_rows - 1) / sub_rows;
  const int tile_cells = ft * bt * st * 3;
  const int b_hi = min(bt, n_bins - b0);   // bins of this tile
  const int s_hi = min(st, n_slots - s0);  // slots of this tile
  const int gs = (st + groups - 1) / groups;  // slots of a group
  const int consumers = static_cast<int>(blockDim.x) - kWarp;
  // rows of sub-chunk j
  auto sub_cnt = [&](int j) {
    return min(sub_rows,
               static_cast<int>(end - begin - static_cast<int64_t>(j) *
                                                  sub_rows));
  };

  // warp (fi, g) of the first ft x groups owns feature f0 + fi's cells of
  // the slots of group g; the next `groups` warps list the rows of each
  // group one sub-chunk ahead of the owners; the last warp is the
  // producer's
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const bool producer = static_cast<int>(threadIdx.x) >= consumers;
  const int fi = warp / groups;
  const int g = warp % groups;
  const int f = f0 + fi;
  const int g_lo = g * gs;                  // the group's slots in the tile
  const int g_hi = min(s_hi, g_lo + gs);
  const bool owner = fi < ft && f < n_feat && g_lo < g_hi;
  const int lister = producer ? -1 : warp - ft * groups;  // its group
  const bool lists = lister >= 0 && lister < groups;
  AccT* own = hist + fi * bt * st * 3;
  uint8_t* own_tag = tag + fi * bt * st;

  // the listers: wait for sub-chunk j, load its last rows if the matrix
  // ends there, and list the weighted rows of group `lister` whose slot
  // lies in the tile, in row order
  auto list_rows = [&](int j) {
    mbar_wait(&full[j % stages], (j / stages) & 1);
    unsigned char* buf = bufs + (j % stages) * L.buf_bytes;
    const int64_t r_lo = begin + static_cast<int64_t>(j) * sub_rows;
    const int cnt = sub_cnt(j);
    BinT* sb = reinterpret_cast<BinT*>(buf);
    int32_t* sl = reinterpret_cast<int32_t*>(buf + L.lid_off);
    float* sg = reinterpret_cast<float*>(buf + L.g_off);
    float* sh = reinterpret_cast<float*>(buf + L.h_off);
    float* sw = reinterpret_cast<float*>(buf + L.w_off);
    const int bulk = static_cast<int>(bulk_rows(cnt));
    if (bulk != cnt) {  // the matrix's last rows: plain loads
      const int tail = cnt - bulk;
      const int t0 = lister * kWarp + lane, step = groups * kWarp;
      for (int t = t0; t < tail; t += step) {
        sl[bulk + t] = in.lid[r_lo + bulk + t];
        sg[bulk + t] = in.grad[r_lo + bulk + t];
        sh[bulk + t] = in.hess[r_lo + bulk + t];
        sw[bulk + t] = in.weight[r_lo + bulk + t];
      }
      if (stage_bins) {
        for (int t = t0; t < tail * n_feat; t += step) {
          sb[bulk * n_feat + t] = in.binned[(r_lo + bulk) * n_feat + t];
        }
      }
      // the listers' barrier (id 1): every lister sees the loaded rows
      asm volatile("bar.sync 1, %0;\n" ::"r"(groups * kWarp) : "memory");
    }
    const int k_lo = lister * gs, k_hi = min(s_hi, k_lo + gs);
    uint16_t* mine_list = list + ((j & 1) * groups + lister) * sub_rows;
    int total = 0;
    for (int r0 = 0; r0 < cnt; r0 += kWarp) {
      const int r = r0 + lane;
      bool mine = false;
      if (r < cnt) {
        const int s = sl[r] - s0;
        mine = sw[r] > 0.0f && s >= k_lo && s < k_hi;
      }
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) {
        mine_list[total + __popc(m & ((1u << lane) - 1))] =
            static_cast<uint16_t>(r);
      }
      total += __popc(m);
    }
    if (lane == 0) count[(j & 1) * groups + lister] = total;
  };

  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(&full[k], 1);
      // the stager's: every block it stages for frees a slot
      mbar_init(&empty[k], split_rows ? 1 : n_live);
    }
    // the first sub-chunks' bytes, before the producer may issue them
    for (int j = 0; j < stages && j < n_sub; ++j) {
      mbar_expect_tx(&full[j], fill_bytes(sub_cnt(j), row_bin_bytes));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) {
    hist[i] = AccT(0);
  }
  // every block's barriers are initialised and armed before any copy or
  // arrival reaches them: a row-split block's come only from itself
  if constexpr (SplitRows) {
    __syncthreads();
  } else {
    cluster.sync();
  }

  if (producer) {
    // the stager's producer stages every sub-chunk into every block it
    // serves, refilling a ring slot once each of them has released it
    if (rank == stager && lane == 0) {
      const uint16_t mask = split_rows || n_live == 1
                                ? 0
                                : static_cast<uint16_t>((1u << n_live) - 1);
      for (int j = 0; j < n_sub; ++j) {
        if (j >= stages) {
          mbar_wait(&empty[j % stages], (j / stages - 1) & 1);
        }
        issue_rows(in, bufs + (j % stages) * L.buf_bytes, L,
                   &full[j % stages],
                   begin + static_cast<int64_t>(j) * sub_rows, sub_cnt(j),
                   n_feat, stage_bins != 0, mask);
      }
    }
  } else {
    if (lists && n_sub > 0) list_rows(0);
    consumers_sync(consumers);
    for (int i = 0; i < n_sub; ++i) {
      if (lists && i + 1 < n_sub) list_rows(i + 1);
      if (owner) {
        mbar_wait(&full[i % stages], (i / stages) & 1);
      }
      unsigned char* buf = bufs + (i % stages) * L.buf_bytes;
      const int64_t r_lo = begin + static_cast<int64_t>(i) * sub_rows;
      BinT* sb = reinterpret_cast<BinT*>(buf);
      int32_t* sl = reinterpret_cast<int32_t*>(buf + L.lid_off);
      float* sg = reinterpret_cast<float*>(buf + L.g_off);
      float* sh = reinterpret_cast<float*>(buf + L.h_off);
      float* sw = reinterpret_cast<float*>(buf + L.w_off);

      if (owner) {
        const uint16_t* rows_g = list + ((i & 1) * groups + g) * sub_rows;
        const int n_g = count[(i & 1) * groups + g];
        // a lane's row of the round: its cell (-1 for none) and its
        // products g*w, h*w rounded to f32, loaded a round ahead
        auto load = [&](int j, int& key, float& gw, float& hw, float& w) {
          key = -1;
          gw = hw = w = 0.0f;
          if (j >= n_g) return;
          const int r = rows_g[j];
          const int b =
              static_cast<int>(stage_bins
                                   ? sb[r * n_feat + f]
                                   : in.binned[(r_lo + r) * n_feat + f]) -
              b0;
          if (b >= 0 && b < b_hi) {
            const float wr = sw[r];
            key = b * st + (sl[r] - s0);
            gw = __fmul_rn(sg[r], wr);
            hw = __fmul_rn(sh[r], wr);
            w = wr;
          }
        };
        int key;
        float gw, hw, w;
        load(lane, key, gw, hw, w);
        for (int j0 = 0; j0 < n_g; j0 += kWarp) {
          int key_n;
          float gw_n, hw_n, w_n;
          load(j0 + kWarp + lane, key_n, gw_n, hw_n, w_n);
          // do two lanes hit one cell? each writes its lane to the cell's
          // tag and reads it back: a lane that reads another's has company
          if (key >= 0) own_tag[key] = static_cast<uint8_t>(lane);
          __syncwarp();
          // the lanes of one cell all read the lane whose write stayed:
          // five ballots over its bits group the lanes by cell (the
          // groups __match_any_sync would give, at a fraction of its
          // cost); a lane alone is a group of one
          const int won = key >= 0 ? own_tag[key] : lane;
          unsigned group = 0xffffffffu;
#pragma unroll
          for (int bit = 0; bit < 5; ++bit) {
            const unsigned m = __ballot_sync(0xffffffffu, (won >> bit) & 1);
            group &= ((won >> bit) & 1) ? m : ~m;
          }
          // the leader (lowest lane) of each group sums the group's
          // products in lane order; its members' come to it by shuffles,
          // all lanes stepping together through the largest group
          const bool lead = key >= 0 && lane == __ffs(group) - 1;
          unsigned rest = lead ? group & (group - 1) : 0u;
          const int steps = static_cast<int>(
              __reduce_max_sync(0xffffffffu, __popc(rest)));
          AccT a0 = gw, a1 = hw, a2 = w;
          for (int k = 0; k < steps; ++k) {
            const int src = rest ? __ffs(rest) - 1 : lane;
            rest &= rest - 1;
            const float g_k = __shfl_sync(0xffffffffu, gw, src);
            const float h_k = __shfl_sync(0xffffffffu, hw, src);
            const float w_k = __shfl_sync(0xffffffffu, w, src);
            if (src != lane) {
              a0 = add_rn(a0, AccT(g_k));
              a1 = add_rn(a1, AccT(h_k));
              a2 = add_rn(a2, AccT(w_k));
            }
          }
          if (lead) {
            AccT* cell = own + key * 3;
            cell[0] = add_rn(cell[0], a0);
            cell[1] = add_rn(cell[1], a1);
            cell[2] = add_rn(cell[2], a2);
          }
          __syncwarp();  // the cells and tags are read again next round
          key = key_n;
          gw = gw_n;
          hw = hw_n;
          w = w_n;
        }
      }
      // the owners are done with sub-chunk i and the listers with i + 1
      consumers_sync(consumers);
      if (threadIdx.x == 0 && i + stages < n_sub) {
        // arm this block's slot for sub-chunk i + stages (its phase for
        // sub-chunk i is complete), then free the slot at the stager,
        // whose producer copies into it only after every block it serves
        // has
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&full[i % stages],
                       fill_bytes(sub_cnt(i + stages), row_bin_bytes));
        mbar_arrive_cluster(&empty[i % stages], stager);
      }
    }
  }

  // cell i of the tile, summed, into the cluster's partial or rounded
  // into the output
  const int64_t n_cells =
      static_cast<int64_t>(n_feat) * n_bins * n_slots * 3;
  AccT* dst = partial == nullptr
                  ? nullptr
                  : partial + static_cast<int64_t>(blockIdx.x / csize) *
                                  n_cells;
  auto put = [&](int i, AccT v) {
    const int k = i % 3;
    int rest = i / 3;
    const int s = rest % st;
    rest /= st;
    const int b = rest % bt;
    const int cf = f0 + rest / bt, cb = b0 + b, cs = s0 + s;
    if (cf < n_feat && cb < n_bins && cs < n_slots) {
      const int64_t at =
          ((static_cast<int64_t>(cf) * n_bins + cb) * n_slots + cs) * 3 + k;
      if (dst != nullptr) {
        dst[at] = v;
      } else {
        store(out + at, v);
      }
    }
  };
  if constexpr (!SplitRows) {
    if (!producer) {
      for (int i = threadIdx.x; i < tile_cells; i += consumers) {
        put(i, hist[i]);
      }
    }
  } else {
    // sum the cluster's tiles cell by cell in rank order, each block a
    // slice of the cells, two cells a thread at a time so that their
    // remote loads are in flight together
    cluster.sync();
    const AccT* peer[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      peer[q] = cluster.map_shared_rank(hist, q < csize ? q : 0);
    }
    const int per = (tile_cells + csize - 1) / csize;
    const int lo = rank * per;
    const int hi = min(tile_cells, lo + per);
    for (int i0 = lo + threadIdx.x; i0 < hi; i0 += 2 * blockDim.x) {
      AccT acc[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * blockDim.x;
        AccT v[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          v[q] = q < csize && i < hi ? peer[q][i] : AccT(0);
        }
        acc[u] = v[0];
#pragma unroll
        for (int q = 1; q < kMaxCluster; ++q) {
          if (q < csize) acc[u] = add_rn(acc[u], v[q]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < hi) put(i, acc[u]);
      }
    }
  }
  // no block leaves while a copy, an arrival or a peer's read may still
  // reach it
  cluster.sync();
}

template <typename AccT, typename OutT>
__global__ void hist_reduce_kernel(const AccT* __restrict__ partial,
                                   OutT* __restrict__ out, int64_t n_cells,
                                   int n_parts) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  AccT acc = partial[i];
  int c = 1;
  for (; c + 8 <= n_parts; c += 8) {  // loads in flight together
    AccT v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = partial[static_cast<int64_t>(c + j) * n_cells + i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = add_rn(acc, v[j]);
  }
  for (; c < n_parts; ++c) {
    acc = add_rn(acc, partial[static_cast<int64_t>(c) * n_cells + i]);
  }
  store(out + i, acc);
}

struct Plan {
  int chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
      stage_bins, threads, split_rows;
};

template <typename BinT, typename AccT, typename OutT, bool SplitRows>
cudaError_t launch(const void* binned, const void* lid, const void* grad,
                   const void* hess, const void* weight, void* partial,
                   void* out, int n, int n_feat, int n_bins, int n_slots,
                   const Plan& p, cudaStream_t stream) {
  const int64_t n_tiles = static_cast<int64_t>((n_feat + p.ft - 1) / p.ft) *
                          ((n_bins + p.bt - 1) / p.bt) *
                          ((n_slots + p.st - 1) / p.st);
  // grid: (blocks of the row ranges, passes or tiles), and the partials
  const int64_t grid_x =
      p.split_rows ? p.n_chunks : static_cast<int64_t>(p.n_chunks) * p.cluster;
  const int64_t grid_y =
      p.split_rows ? n_tiles : (n_tiles + p.cluster - 1) / p.cluster;
  const int n_parts = p.split_rows ? p.n_chunks / p.cluster : p.n_chunks;
  if (grid_y > 65535 || grid_x >= (int64_t{1} << 31)) {
    return cudaErrorInvalidConfiguration;
  }
  if ((n_parts > 1) != (partial != nullptr)) return cudaErrorInvalidValue;
  const Layout L(sizeof(AccT), p.ft, p.bt, p.st, p.groups, p.sub_rows,
                 p.stage_bins ? n_feat * static_cast<int>(sizeof(BinT)) : 0,
                 SplitRows ? kRowSplitStages : kTileSplitStages);
  auto kernel = hist_cluster_kernel<BinT, AccT, OutT, SplitRows>;
  // the opt-in above 48 KB, made on each device when a launch needs more
  // than any before it there; under a lock, so that launches from two
  // threads cannot leave the attribute below what the larger one needs
  constexpr int kDevices = 64;
  static int smem_set[kDevices] = {};
  static std::mutex smem_lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int want = static_cast<int>(L.total);
  {
    std::lock_guard<std::mutex> guard(smem_lock);
    if (dev >= kDevices || want > smem_set[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
      if (err != cudaSuccess) return err;
      if (dev < kDevices) smem_set[dev] = want;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid_x),
                     static_cast<unsigned>(grid_y));
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Rows<BinT> rows{static_cast<const BinT*>(binned),
                        static_cast<const int32_t*>(lid),
                        static_cast<const float*>(grad),
                        static_cast<const float*>(hess),
                        static_cast<const float*>(weight)};
  err = cudaLaunchKernelEx(&cfg, kernel, rows, static_cast<AccT*>(partial),
                           static_cast<OutT*>(out), n, n_feat, n_bins,
                           n_slots, p.chunk_rows, p.sub_rows, p.ft, p.bt,
                           p.st, p.groups, p.stage_bins);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return err;
  const int64_t n_cells = static_cast<int64_t>(n_feat) * n_bins * n_slots * 3;
  const int64_t blocks = (n_cells + kReduceThreads - 1) / kReduceThreads;
  hist_reduce_kernel<AccT, OutT>
      <<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
          static_cast<const AccT*>(partial), static_cast<OutT*>(out),
          n_cells, n_parts);
  return cudaGetLastError();
}

// The launch of the plan's kind of cluster.
template <typename BinT, typename AccT, typename OutT>
cudaError_t launch_plan(const void* binned, const void* lid, const void* grad,
                        const void* hess, const void* weight, void* partial,
                        void* out, int n, int n_feat, int n_bins, int n_slots,
                        const Plan& p, cudaStream_t stream) {
  return p.split_rows
             ? launch<BinT, AccT, OutT, true>(binned, lid, grad, hess, weight,
                                              partial, out, n, n_feat, n_bins,
                                              n_slots, p, stream)
             : launch<BinT, AccT, OutT, false>(binned, lid, grad, hess,
                                               weight, partial, out, n,
                                               n_feat, n_bins, n_slots, p,
                                               stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename AccT, typename OutT>
int dispatch(int bin_bytes, const void* binned, const void* lid,
             const void* grad, const void* hess, const void* weight,
             void* partial, void* out, int n, int n_feat, int n_bins,
             int n_slots, const Plan& p, void* stream) {
  if (n <= 0 || n_feat <= 0 || n_bins <= 0 || n_slots <= 0 ||
      p.chunk_rows <= 0 || p.chunk_rows % kWarp != 0 || p.n_chunks <= 0 ||
      p.ft <= 0 || p.bt <= 0 || p.st <= 0 || p.cluster <= 0 ||
      p.cluster > kMaxCluster || p.sub_rows <= 0 ||
      (p.split_rows != 0 && p.n_chunks % p.cluster != 0) ||
      p.sub_rows % kWarp != 0 || p.groups <= 0 || p.groups > p.st ||
      p.sub_rows > 65536 ||
      p.threads < ((p.ft + 1) * p.groups + 1) * kWarp ||
      p.threads > kMaxThreads || p.threads % kWarp != 0 ||
      static_cast<int64_t>(p.chunk_rows) * p.n_chunks <
          static_cast<int64_t>(n) ||
      !aligned16(binned) || !aligned16(lid) || !aligned16(grad) ||
      !aligned16(hess) || !aligned16(weight)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return static_cast<int>(launch_plan<uint8_t, AccT, OutT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, p, s));
    case 2:
      return static_cast<int>(launch_plan<uint16_t, AccT, OutT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, p, s));
    case 4:
      return static_cast<int>(launch_plan<int32_t, AccT, OutT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bin_bytes: 1 = uint8, 2 = uint16, 4 = int32 bin matrix (n, n_feat),
// row-major. lid: int32 (n,); grad, hess, weight: f32 (n,); every operand
// 16-byte aligned. out: f32 (n_feat*n_bins, n_slots*3). Rows
// [c*chunk_rows, (c+1)*chunk_rows) form row range c; tiles are ft
// features x bt bins x st slots in `groups` slot groups. split_rows 0:
// one cluster of `cluster` blocks reads each row range once for
// `cluster` tiles (a pass); split_rows 1: each row range is one block's,
// and `cluster` consecutive ones share a tile (n_chunks a multiple of
// cluster). partial: float64 (partials, n_feat*n_bins*n_slots*3)
// scratch, one a cluster of a pass (n_chunks, or n_chunks / cluster with
// split_rows), null when that is 1. Rows are staged sub_rows at a time
// (bins too when stage_bins); `threads` per block, at least
// ((ft + 1) * groups + 1) warps. Returns a cudaError_t.
extern "C" int sml_hist_accumulate(int bin_bytes, const void* binned,
                                   const void* lid, const void* grad,
                                   const void* hess, const void* weight,
                                   void* partial, void* out, int n,
                                   int n_feat, int n_bins, int n_slots,
                                   int chunk_rows, int n_chunks, int ft,
                                   int bt, int st, int groups, int cluster,
                                   int sub_rows, int stage_bins, int threads,
                                   int split_rows, void* stream) {
  const Plan p{chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
               stage_bins, threads, split_rows};
  return dispatch<double, float>(bin_bytes, binned, lid, grad, hess,
                                 weight, partial, out, n, n_feat, n_bins,
                                 n_slots, p, stream);
}

// The same sums with a float64 `out` (n_feat*n_bins, n_slots*3), not
// rounded: the cells of sml_hist_accumulate before their one rounding
// to f32, bit for bit (the same plan sums in the same order). A mesh
// of ranks adds its ranks' sums in float64 and rounds once after.
extern "C" int sml_hist_accumulate_f64out(
    int bin_bytes, const void* binned, const void* lid, const void* grad,
    const void* hess, const void* weight, void* partial, void* out, int n,
    int n_feat, int n_bins, int n_slots, int chunk_rows, int n_chunks,
    int ft, int bt, int st, int groups, int cluster, int sub_rows,
    int stage_bins, int threads, int split_rows, void* stream) {
  const Plan p{chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
               stage_bins, threads, split_rows};
  return dispatch<double, double>(bin_bytes, binned, lid, grad, hess,
                                  weight, partial, out, n, n_feat, n_bins,
                                  n_slots, p, stream);
}

// The same with f32 sums and an f32 `partial` scratch: a measurement
// build, to price the float64 sums above. Not called by the port.
extern "C" int sml_hist_accumulate_f32acc(
    int bin_bytes, const void* binned, const void* lid, const void* grad,
    const void* hess, const void* weight, void* partial, void* out, int n,
    int n_feat, int n_bins, int n_slots, int chunk_rows, int n_chunks,
    int ft, int bt, int st, int groups, int cluster, int sub_rows,
    int stage_bins, int threads, int split_rows, void* stream) {
  const Plan p{chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
               stage_bins, threads, split_rows};
  return dispatch<float, float>(bin_bytes, binned, lid, grad, hess, weight,
                                partial, out, n, n_feat, n_bins, n_slots, p,
                                stream);
}
