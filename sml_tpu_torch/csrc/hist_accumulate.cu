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
// bytes of rows and writes F*B*S*12 bytes of histogram: a few MB at the
// course widths, against three adds for each of a row's F cells, so its
// bound is bytes, well under a microsecond. What holds it above that is
// latency: a warp adds its rows 32 at a time, and each round is a chain
// of shared-memory reads, a vote, and read-add-writes of float64 cells.
// Only warps that own cells do that work, and the float64 tile they own
// takes the shared memory (64 bins x 16 slots of one feature is 24 KB), so
// an SM holds a dozen of them. The design therefore gives each warp few
// rows, keeps its rounds short, and keeps every other step off their path.
// (The first design, one block per 2,048-row chunk with each warp walking
// its chunk through dependent loads from L2, with __match_any_sync in every
// round and a float64 partial of every chunk summed by a second pass, ran
// some 100x its bound.) The Pallas body builds two one-hot tiles and
// contracts them on the MXU because that was the TPU's fast path; here
// that would be O(n*F*B) wasted work, so rows are added straight into
// their cells.
//
// Design:
// - A block takes one chunk of rows and a tile of ft features x bt bins x
//   st slots, held in shared memory. The tile's slots fall into `groups`
//   slot groups; warp (fi, g) owns feature fi's cells of group g outright
//   and walks only the rows whose slot lies in group g, so a level with
//   many slots spreads one feature's rows over several warps. The launch
//   plan (hist_plan in native/hist_kernel.py) picks ft, groups and the
//   staging size that keep the most owning warps on an SM, and sizes
//   chunks so that one wave of blocks covers the rows.
// - Thread 0 stages the chunk's rows into shared memory with 1-D bulk
//   copies (cp.async.bulk into an mbarrier), `sub_rows` rows at a time
//   into a ring of kStages buffers, kStages - 1 copies ahead: the
//   contiguous sub_rows x F bins (when they fit the staging budget;
//   otherwise the owners read bins from global memory), lid, g, h and w.
//   Bulk copies need 16-byte-aligned addresses and sizes: the wrapper
//   checks the operands' alignment, chunks and sub-chunks are multiples
//   of 32 rows, and the last (n mod 16) rows of the matrix are loaded by
//   plain loads.
// - One listing warp per slot group waits for a sub-chunk one step ahead
//   of the owners and lists, in row order, its weighted rows whose slot
//   lies in the group (ballots), into one of two lists.
// - An owner takes its group's rows 32 at a time, a row to a lane, loading
//   the next round's rows ahead of this round's adds. To find out whether
//   two lanes hit one (bin, slot) cell, each writes its lane number to the
//   cell's one-byte tag and reads it back; a lane that reads another
//   lane's has company. A round where no lane has company adds each lane's
//   row to its own cell. A round with company groups the lanes by cell
//   with __match_any_sync, and the lowest lane of each group sums the
//   group's contributions in lane order and adds the result to the cell.
//   (__match_any_sync serialises over the distinct cells of a warp, so it
//   is kept off the rounds that do not need it; the tags need no
//   clearing, as only this round's writes are read.)
// - The blocks of consecutive chunks (the same tile) form a thread block
//   cluster of up to 8. After cluster.sync() each block sums a slice of
//   the tile's cells over the cluster's blocks in rank order through
//   distributed shared memory, so one partial per cluster, not per chunk,
//   leaves the SMs. With one cluster per tile the block rounds to f32 and
//   writes the output: one launch, no scratch. Otherwise it writes a
//   float64 partial, and a second kernel sums the clusters' partials in
//   cluster order and rounds to f32.
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
// price the float64 sums.
//
// Determinism. The fit needs bit-stable histograms from run to run (the
// warm-start contract), so there are no float atomics: the order of every
// add follows from the inputs and the plan (chunk rows, tiles, cluster
// size), which the wrapper derives from the shapes alone.
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
constexpr int kMaxThreads = 512;
// blocks of kMaxThreads an SM must hold: caps a thread at 64 registers,
// which hist_plan counts on (_REGS)
constexpr int kMinBlocks = 2;
constexpr int kStages = 3;  // row buffers in the ring

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float to_f32(double a) {
  return __double2float_rn(a);
}
__device__ __forceinline__ float to_f32(float a) { return a; }

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the dynamic shared memory of one block (mirrored by
// hist_plan's `smem`): an mbarrier per stage, the tile, a one-byte lane
// tag per cell of the tile, two lists of rows of each slot group and
// their counts,
// then a ring of kStages row buffers, each [bins][lid][g][h][w].
struct Layout {
  size_t tile_off, tag_off, list_off, count_off, buf_off, buf_bytes, lid_off,
      g_off, h_off, w_off, total;
  __host__ __device__ Layout(int acc_bytes, int ft, int bt, int st,
                             int groups, int sub_rows, int row_bin_bytes) {
    const size_t keys = static_cast<size_t>(ft) * bt * st;
    tile_off = round16(8 * kStages);
    tag_off = tile_off + round16(static_cast<size_t>(acc_bytes) * 3 * keys);
    list_off = tag_off + round16(keys);
    count_off = list_off + round16(4 * static_cast<size_t>(groups) * sub_rows);
    buf_off = count_off + round16(8 * static_cast<size_t>(groups));
    lid_off = round16(static_cast<size_t>(sub_rows) * row_bin_bytes);
    g_off = lid_off + 4 * static_cast<size_t>(sub_rows);
    h_off = g_off + 4 * static_cast<size_t>(sub_rows);
    w_off = h_off + 4 * static_cast<size_t>(sub_rows);
    buf_bytes = w_off + 4 * static_cast<size_t>(sub_rows);
    total = buf_off + kStages * buf_bytes;
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
// from global to this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename BinT>
struct Rows {
  const BinT* binned;
  const int32_t* lid;
  const float* grad;
  const float* hess;
  const float* weight;
};

// Thread 0: stage rows [r, r + cnt) into buffer `buf` (the bulk part: a
// multiple of 16 rows) and arm `bar` with its bytes.
template <typename BinT>
__device__ __forceinline__ void issue_rows(const Rows<BinT>& in,
                                           unsigned char* buf,
                                           const Layout& L, uint64_t* bar,
                                           int64_t r, int cnt, int n_feat,
                                           bool stage_bins) {
  const uint32_t bulk = static_cast<uint32_t>(cnt) & ~15u;
  const uint32_t bin_bytes =
      stage_bins ? bulk * n_feat * static_cast<uint32_t>(sizeof(BinT)) : 0u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, bin_bytes + 16u * bulk);
  if (bulk == 0) return;
  if (bin_bytes) bulk_g2s(buf, in.binned + r * n_feat, bin_bytes, bar);
  bulk_g2s(buf + L.lid_off, in.lid + r, 4u * bulk, bar);
  bulk_g2s(buf + L.g_off, in.grad + r, 4u * bulk, bar);
  bulk_g2s(buf + L.h_off, in.hess + r, 4u * bulk, bar);
  bulk_g2s(buf + L.w_off, in.weight + r, 4u * bulk, bar);
}

// AccT is the type of the sums: double in the port, float in the
// f32-accumulating build that is only timed. `partial` is null when the
// grid holds one cluster per tile (the block then writes `out`).
template <typename BinT, typename AccT>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
hist_cluster_kernel(Rows<BinT> in, AccT* __restrict__ partial,
                    float* __restrict__ out, int n, int n_feat, int n_bins,
                    int n_slots, int chunk_rows, int sub_rows, int ft,
                    int bt, int st, int groups, int n_stiles,
                    int stage_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(sizeof(AccT), ft, bt, st, groups, sub_rows,
                 stage_bins ? n_feat * static_cast<int>(sizeof(BinT)) : 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);       // [kStages]
  AccT* hist = reinterpret_cast<AccT*>(smem + L.tile_off);  // [ft][bt][st][3]
  uint8_t* tag = smem + L.tag_off;                          // [ft][bt][st]
  uint16_t* list =
      reinterpret_cast<uint16_t*>(smem + L.list_off);  // [2][groups][sub_rows]
  int* count = reinterpret_cast<int*>(smem + L.count_off);  // [2][groups]
  unsigned char* bufs = smem + L.buf_off;                   // [kStages]

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int f0 = blockIdx.y * ft;
  const int b0 = (blockIdx.z / n_stiles) * bt;
  const int s0 = (blockIdx.z % n_stiles) * st;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t end = begin + chunk_rows < n ? begin + chunk_rows
                                             : static_cast<int64_t>(n);
  const int rows = end > begin ? static_cast<int>(end - begin) : 0;
  const int n_sub = (rows + sub_rows - 1) / sub_rows;
  const int tile_cells = ft * bt * st * 3;
  const int b_hi = min(bt, n_bins - b0);   // bins of this tile
  const int s_hi = min(st, n_slots - s0);  // slots of this tile
  const int gs = (st + groups - 1) / groups;  // slots of a group
  // thread 0: stage sub-chunk j into its ring slot
  auto issue = [&](int j) {
    const int64_t r = begin + static_cast<int64_t>(j) * sub_rows;
    issue_rows(in, bufs + (j % kStages) * L.buf_bytes, L, &bar[j % kStages],
               r, min(sub_rows, static_cast<int>(end - r)), n_feat,
               stage_bins != 0);
  };

  // warp (fi, g) of the first ft x groups owns feature f0 + fi's cells of
  // the slots of group g; the next `groups` warps list the rows of each
  // group one sub-chunk ahead of the owners
  const int fi = warp / groups;
  const int g = warp % groups;
  const int f = f0 + fi;
  const int g_lo = g * gs;                  // the group's slots in the tile
  const int g_hi = min(s_hi, g_lo + gs);
  const bool owner = fi < ft && f < n_feat && g_lo < g_hi;
  const int lister = warp - ft * groups;    // the group it lists, if any
  AccT* own = hist + fi * bt * st * 3;
  uint8_t* own_tag = tag + fi * bt * st;

  // the listers: wait for sub-chunk j, load its last rows if the matrix
  // ends there, and list the weighted rows of group `lister` whose slot
  // lies in the tile, in row order
  auto list_rows = [&](int j) {
    mbar_wait(&bar[j % kStages], (j / kStages) & 1);
    unsigned char* buf = bufs + (j % kStages) * L.buf_bytes;
    const int64_t r_lo = begin + static_cast<int64_t>(j) * sub_rows;
    const int cnt = min(sub_rows, static_cast<int>(end - r_lo));
    BinT* sb = reinterpret_cast<BinT*>(buf);
    int32_t* sl = reinterpret_cast<int32_t*>(buf + L.lid_off);
    float* sg = reinterpret_cast<float*>(buf + L.g_off);
    float* sh = reinterpret_cast<float*>(buf + L.h_off);
    float* sw = reinterpret_cast<float*>(buf + L.w_off);
    const int bulk = cnt & ~15;
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
    for (int k = 0; k < kStages; ++k) mbar_init(&bar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < kStages - 1 && j < n_sub; ++j) issue(j);
  }
  for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) {
    hist[i] = AccT(0);
  }
  __syncthreads();  // the barriers are initialised
  if (lister >= 0 && lister < groups && n_sub > 0) list_rows(0);
  __syncthreads();

  for (int i = 0; i < n_sub; ++i) {
    // the slot refilled here was last read in round i - 1 by the owners
    // and i - 2 by the listers (the __syncthreads at the end of the loop)
    if (threadIdx.x == 0 && i + kStages - 1 < n_sub) issue(i + kStages - 1);
    if (lister >= 0 && lister < groups && i + 1 < n_sub) list_rows(i + 1);
    if (owner) {
      mbar_wait(&bar[i % kStages], (i / kStages) & 1);
    }
    unsigned char* buf = bufs + (i % kStages) * L.buf_bytes;
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
            static_cast<int>(stage_bins ? sb[r * n_feat + f]
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
        const bool company = key >= 0 && own_tag[key] != lane;
        // a round with company groups the lanes by cell (the ballot is the
        // same whichever lane's tag stayed); the others add alone
        const unsigned group = __ballot_sync(0xffffffffu, company)
                                   ? __match_any_sync(0xffffffffu, key)
                                   : 1u << lane;
        if (key >= 0 && lane == __ffs(group) - 1) {
          // the leader (lowest lane) sums its group in lane order, each
          // member's products recomputed from the row buffer
          AccT a0 = gw, a1 = hw, a2 = w;
          unsigned rest = group & (group - 1);
          while (rest) {
            const int r = rows_g[j0 + __ffs(rest) - 1];
            rest &= rest - 1;
            const float wr = sw[r];
            a0 = add_rn(a0, AccT(__fmul_rn(sg[r], wr)));
            a1 = add_rn(a1, AccT(__fmul_rn(sh[r], wr)));
            a2 = add_rn(a2, AccT(wr));
          }
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
    __syncthreads();  // the slot and the lists are refilled
  }

  // sum the cluster's tiles cell by cell in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const AccT* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    peer[q] = cluster.map_shared_rank(hist, q < csize ? q : 0);
  }
  const int per = (tile_cells + csize - 1) / csize;
  const int lo = rank * per;
  const int hi = min(tile_cells, lo + per);
  const int64_t n_cells = static_cast<int64_t>(n_feat) * n_bins * n_slots * 3;
  AccT* dst = partial == nullptr
                  ? nullptr
                  : partial + static_cast<int64_t>(blockIdx.x / csize) *
                                  n_cells;
  // two cells a thread at a time, so that their remote loads are in
  // flight together
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
      if (i >= hi) break;
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
          dst[at] = acc[u];
        } else {
          out[at] = to_f32(acc[u]);
        }
      }
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

template <typename AccT>
__global__ void hist_reduce_kernel(const AccT* __restrict__ partial,
                                   float* __restrict__ out, int64_t n_cells,
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
  out[i] = to_f32(acc);
}

struct Plan {
  int chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
      stage_bins, threads;
};

template <typename BinT, typename AccT>
cudaError_t launch(const void* binned, const void* lid, const void* grad,
                   const void* hess, const void* weight, void* partial,
                   void* out, int n, int n_feat, int n_bins, int n_slots,
                   const Plan& p, cudaStream_t stream) {
  const int n_ftiles = (n_feat + p.ft - 1) / p.ft;
  const int n_btiles = (n_bins + p.bt - 1) / p.bt;
  const int n_stiles = (n_slots + p.st - 1) / p.st;
  if (n_ftiles > 65535 || static_cast<int64_t>(n_btiles) * n_stiles > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const int n_clusters = p.n_chunks / p.cluster;
  if ((n_clusters > 1) != (partial != nullptr)) return cudaErrorInvalidValue;
  const Layout L(sizeof(AccT), p.ft, p.bt, p.st, p.groups, p.sub_rows,
                 p.stage_bins ? n_feat * static_cast<int>(sizeof(BinT)) : 0);
  auto kernel = hist_cluster_kernel<BinT, AccT>;
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
  cfg.gridDim = dim3(p.n_chunks, n_ftiles, n_btiles * n_stiles);
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
                           static_cast<float*>(out), n, n_feat, n_bins,
                           n_slots, p.chunk_rows, p.sub_rows, p.ft, p.bt,
                           p.st, p.groups, n_stiles, p.stage_bins);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || n_clusters == 1) return err;
  const int64_t n_cells = static_cast<int64_t>(n_feat) * n_bins * n_slots * 3;
  const int64_t blocks = (n_cells + kReduceThreads - 1) / kReduceThreads;
  hist_reduce_kernel<AccT><<<static_cast<unsigned>(blocks), kReduceThreads,
                             0, stream>>>(static_cast<const AccT*>(partial),
                                          static_cast<float*>(out), n_cells,
                                          n_clusters);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename AccT>
int dispatch(int bin_bytes, const void* binned, const void* lid,
             const void* grad, const void* hess, const void* weight,
             void* partial, void* out, int n, int n_feat, int n_bins,
             int n_slots, const Plan& p, void* stream) {
  if (n <= 0 || n_feat <= 0 || n_bins <= 0 || n_slots <= 0 ||
      p.chunk_rows <= 0 || p.chunk_rows % kWarp != 0 || p.n_chunks <= 0 ||
      p.ft <= 0 || p.bt <= 0 || p.st <= 0 || p.cluster <= 0 ||
      p.cluster > kMaxCluster || p.n_chunks % p.cluster != 0 ||
      p.sub_rows <= 0 || p.sub_rows % kWarp != 0 ||
      p.groups <= 0 || p.groups > p.st || p.sub_rows > 65536 ||
      p.threads < (p.ft + 1) * p.groups * kWarp ||
      p.threads > kMaxThreads ||
      p.threads % kWarp != 0 ||
      static_cast<int64_t>(p.chunk_rows) * p.n_chunks <
          static_cast<int64_t>(n) ||
      !aligned16(binned) || !aligned16(lid) || !aligned16(grad) ||
      !aligned16(hess) || !aligned16(weight)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return static_cast<int>(launch<uint8_t, AccT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, p, s));
    case 2:
      return static_cast<int>(launch<uint16_t, AccT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, p, s));
    case 4:
      return static_cast<int>(launch<int32_t, AccT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bin_bytes: 1 = uint8, 2 = uint16, 4 = int32 bin matrix (n, n_feat),
// row-major. lid: int32 (n,); grad, hess, weight: f32 (n,); every operand
// 16-byte aligned. out: f32 (n_feat*n_bins, n_slots*3). partial: float64
// (n_chunks/cluster, n_feat*n_bins*n_slots*3) scratch, null when
// n_chunks == cluster. Rows [c*chunk_rows, (c+1)*chunk_rows) form chunk c;
// tiles are ft features x bt bins x st slots in `groups` slot groups;
// `cluster` consecutive chunks form a cluster; rows are staged sub_rows at
// a time (bins too when stage_bins); `threads` per block, at least
// (ft + 1) * groups warps. Returns a cudaError_t.
extern "C" int sml_hist_accumulate(int bin_bytes, const void* binned,
                                   const void* lid, const void* grad,
                                   const void* hess, const void* weight,
                                   void* partial, void* out, int n,
                                   int n_feat, int n_bins, int n_slots,
                                   int chunk_rows, int n_chunks, int ft,
                                   int bt, int st, int groups, int cluster,
                                   int sub_rows, int stage_bins, int threads,
                                   void* stream) {
  const Plan p{chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
               stage_bins, threads};
  return dispatch<double>(bin_bytes, binned, lid, grad, hess, weight,
                          partial, out, n, n_feat, n_bins, n_slots, p,
                          stream);
}

// The same with f32 sums and an f32 `partial` scratch: a measurement
// build, to price the float64 sums above. Not called by the port.
extern "C" int sml_hist_accumulate_f32acc(
    int bin_bytes, const void* binned, const void* lid, const void* grad,
    const void* hess, const void* weight, void* partial, void* out, int n,
    int n_feat, int n_bins, int n_slots, int chunk_rows, int n_chunks,
    int ft, int bt, int st, int groups, int cluster, int sub_rows,
    int stage_bins, int threads, void* stream) {
  const Plan p{chunk_rows, n_chunks, ft, bt, st, groups, cluster, sub_rows,
               stage_bins, threads};
  return dispatch<float>(bin_bytes, binned, lid, grad, hess, weight, partial,
                         out, n, n_feat, n_bins, n_slots, p, stream);
}
