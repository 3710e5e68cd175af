// Weighted margin of a stacked tree ensemble over rows of compact bins.
//
// Replaces the TPU kernel `forest_traverse` in
// sml_tpu/native/traverse_kernel.py (the Pallas body at :134, launched at
// :175). It computes the same function: for each row, the sum over trees
// in order of w[t] * lv[t][leaf], where the leaf is reached from node 0
// of the level-order heap (children of node i at 2i+1 and 2i+2) by at
// most `depth` steps right iff x[sf[node]] > sb[node], stopping early at
// a node whose sf is negative; a feature id past the row reads as bin 0.
// The Pallas body selects each node and feature with one-hot masked sums,
// because gathers were slow on the TPU; Hopper indexes directly.
//
// What bounds it on an H100. Per row it reads F bin bytes and writes 4;
// the node tables (at most 12 * T * N bytes: only the nodes a row can
// reach must be read) are shared by every row. Its bound
// is a fraction of a microsecond at the course widths (ML 11: 40 trees of
// depth 6). What holds it above that is latency. A descent is a chain of
// dependent loads (record, bin, compare, child). The first design (one
// thread per row walking all T trees, tables copied element by element
// into every block of 256 rows) ran a 240-step chain per row, used one SM
// for a 64-row request and took as long for 64 rows as for 100,000. Now
// the fixed cost of a block dominates small batches: one round of loads
// that brings a model's raw tables from L2 into the SM (about 4,700 SM
// cycles for ML 11's 61 KB, run alone or twice over, so it is the L2
// path and not cold code) and the completion of early leaves; the
// descent's shared-memory loads dominate large batches
// (scripts/torch_traverse_phases.py times each phase).
//
// Design:
// - Trees in parallel. A block takes a tile of R rows (a multiple of 32)
//   and splits the trees over `groups` warps per 32 rows: the thread of
//   row r in group g descends trees g, g + groups, ... for row r, four at
//   a time as independent chains, and writes each weighted leaf value to
//   shared memory; in the next tile's round (bins and values double
//   buffered, one barrier a tile) one thread per row adds them in tree
//   order from 0.0f. With one group a thread runs its row's trees in order
//   and adds as it goes. At ML 11 a 64-row request runs 32 groups: a
//   row's chain falls from 240 steps to 12.
// - A grid sized from n (traverse_plan in native/traverse_kernel.py, from
//   the shapes alone): blocks of up to 1,024 threads; the tile size whose
//   blocks walk the fewest rows, so 32-row tiles while they fit one per SM
//   (4,096 rows reach 128 SMs) and, at 100,000 rows, one 768-row tile per
//   SM in one group. Each block builds its tables once.
// - Compact tables, built in shared memory by the whole block: coalesced
//   loads of the raw tables, kNodes slots a thread all in flight before
//   the first store, each internal node one 8-byte record (the byte
//   offset of its feature's row in the bin tile, its split bin) read by
//   one load, each tree only its 2^D last-level values, already
//   multiplied by w[t] (__fmul_rn, the product the sequential loop rounds
//   for every row). Early leaves are completed so that every descent
//   runs exactly D steps with no branch: a node at or below an early leaf
//   goes always left (feature row F, which holds zeros, and split bin
//   INT_MAX), and a last-level node below one takes the topmost one's
//   value: level by level from the root, every node of a level at once
//   (a warp per tree measured slower), skipped when the trees have no
//   early leaf. A feature id >= F also reads row F.
// - Bins staged per tile, transposed: the tile's rows are copied by
//   coalesced loads (issued a tile ahead) into [F + 1][R] int32 in shared
//   memory, so the 32 rows of a warp read 32 different banks whatever
//   their features, and every tree group of a row shares them. Rows too
//   wide to stage (more than 48 KB a tile) read their bins through L1.
// - A descent step is two shared-memory loads and four integer operations:
//   each chain keeps its node's shared-memory address (inline PTX loads,
//   so the compiler cannot fall back to generic addressing).
// - Tables past shared memory: trees are built in chunks that fit 227 KB
//   (with the opt-in above 48 KB), the running sum kept in `out` between
//   chunks; a tree whose compact table alone passes that (depth >= 15) is
//   traversed by the global-memory kernel, one thread per row.
//
// Numerics. Leaf choice is exact (integer compares). The tree sum is f32
// in tree order from each row's starting value, each multiply and add
// rounded on its own (no FMA contraction), so it is bit-equal to the
// sequential f32 loop and to forest_margin_plain.
//
// The starting value. Prediction starts every row from 0.0f (the wrapper
// adds the base margin afterwards, in float64). A warm start's margin
// replay (sml_tpu_torch/ml/tree_impl.py, resume_ensemble_on_device)
// starts from the base margin: the fit's carry is ((base + s*l0) + s*l1)
// + ..., every operation rounded in f32, and adding the base at the end
// would round differently. So the first chunk of trees reads `init[row]`
// (an (n,) f32 operand) or, with init null, `init_value` (0.0f for
// prediction, whose bits do not change); later chunks read `out[row]`,
// as they always did. It is the JAX package's plain-jnp replay
// (sml_tpu/ml/tree_impl.py:985-1011) as one launch.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;   // one block of 1024 caps a thread at
                                    // 64 registers (traverse_plan's _REGS)
constexpr int kGlobalThreads = 256;
constexpr int kBatch = 4;           // trees a thread descends together
constexpr int kPrefetch = 4;        // bins a thread loads ahead
constexpr int kNodes = 5;           // table slots a thread loads at once:
                                    // one round for 40 trees of depth 6 at
                                    // 1,024 threads; 8 spill at 64 registers
constexpr int kSumAhead = 8;        // leaf values loaded ahead of the adds
constexpr int kMaxSharedDepth = 14;
constexpr size_t kSmemBlock = 227 * 1024;

// Phase stamps, compiled in only with -DSML_TRAVERSE_STAMPS (by
// scripts/torch_traverse_phases.py): thread 0 of each of the first
// kStampBlocks blocks records clock64() at the end of phase K.
constexpr int kStampBlocks = 256;
constexpr int kStamps = 8;
#ifdef SML_TRAVERSE_STAMPS
__device__ long long g_stamps[kStampBlocks * kStamps];
#define STAMP(K)                                                \
  do {                                                          \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {        \
      g_stamps[blockIdx.x * kStamps + (K)] = clock64();         \
    }                                                           \
  } while (0)
#else
#define STAMP(K) \
  do {           \
  } while (0)
#endif

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the dynamic shared memory of one block (mirrored by
// traverse_smem in native/traverse_kernel.py): the records of a chunk of
// trees [chunk][2^D - 1] and their weighted last-level values
// [chunk][2^D]; two bin tiles [F + 1][R] int32 (when staged) and, with
// more than one tree group, two buffers of a tile's leaf values
// [chunk][R].
struct Layout {
  size_t leaf_off, x_off, x_bytes, vals_off, vals_bytes, total;
  __host__ __device__ Layout(int chunk, int depth, int tile_rows, int n_feat,
                             bool stage_x, bool vals) {
    const size_t nleaf = static_cast<size_t>(1) << depth;
    leaf_off = round16(8 * static_cast<size_t>(chunk) * (nleaf - 1));
    x_off = leaf_off + round16(4 * static_cast<size_t>(chunk) * nleaf);
    x_bytes = stage_x ? round16(4 * static_cast<size_t>(n_feat + 1) *
                                tile_rows)
                      : 0;
    vals_off = x_off + 2 * x_bytes;
    vals_bytes =
        vals ? round16(4 * static_cast<size_t>(chunk) * tile_rows) : 0;
    total = vals_off + 2 * vals_bytes;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int2 lds64(uint32_t a) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ int lds32(uint32_t a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// K trees t, t + stride, ... descended together for the tile row r: D
// steps each, no branch, the K records loaded first and then the K bins.
// With staged bins a record is (byte offset of its feature's row in the
// tile, split bin), and each chain keeps the shared-memory address of its
// node: child = 2 * node + 1 (+ 1 if right) is address 2 * a + 8 - base
// (+ 8), so a step is two loads, an add, a compare and two adds.
//
// With kAcc (one tree group: stride 1, the trees in order) the weighted
// leaf values are added to `acc` in tree order instead, which is returned.
template <int K, typename BinT, bool kStageX, bool kAcc = false>
__device__ __forceinline__ float descend(const int2* s_rec,
                                         const float* s_leaf,
                                         const int32_t* s_x, float* s_vals,
                                         const BinT* __restrict__ xrow,
                                         int n_feat, int depth, int nrec,
                                         int tile_rows, int r, int t,
                                         int stride, float acc = 0.0f) {
  uint32_t base[K], a[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    base[q] = smem_u32(s_rec + (t + q * stride) * nrec);
    a[q] = base[q];
  }
  const uint32_t xr = smem_u32(s_x + r);
  for (int l = 0; l < depth; ++l) {
    int2 rec[K];
    int x[K];
#pragma unroll
    for (int q = 0; q < K; ++q) rec[q] = lds64(a[q]);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (kStageX) {
        x[q] = lds32(xr + static_cast<uint32_t>(rec[q].x));
      } else {
        x[q] = rec[q].x < n_feat ? static_cast<int>(__ldg(xrow + rec[q].x))
                                 : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      a[q] = 2u * a[q] + (8u - base[q]) + (x[q] > rec[q].y ? 8u : 0u);
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int tt = t + q * stride;
    const int node = static_cast<int>((a[q] - base[q]) / 8u);
    const float v = s_leaf[tt * (nrec + 1) + node - nrec];
    if (kAcc) {
      acc = __fadd_rn(acc, v);
    } else {
      s_vals[tt * tile_rows + r] = v;
    }
  }
  return acc;
}

// The bins of a tile, transposed into [F][R] int32 (zeros past the last
// row): a thread's first kPrefetch elements are loaded into registers
// (issued early, so that their latency passes under other work) and
// stored later; the rest of the tile, if any, is staged at the store.
template <typename BinT>
struct TileBins {
  int v[kPrefetch];
  __device__ __forceinline__ void load(const BinT* __restrict__ binned, int n,
                                       int n_feat, int tile_rows, int tile) {
    const int64_t row0 = static_cast<int64_t>(tile) * tile_rows;
    const int64_t lim = (static_cast<int64_t>(n) - row0) * n_feat;
    const BinT* src = binned + row0 * n_feat;
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int i = threadIdx.x + q * blockDim.x;
      v[q] = i < lim ? static_cast<int>(__ldg(src + i)) : 0;
    }
  }
  __device__ __forceinline__ void store(const BinT* __restrict__ binned, int n,
                                        int n_feat, int tile_rows, int tile,
                                        int32_t* s_x) {
    const int count = tile_rows * n_feat;
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int i = threadIdx.x + q * blockDim.x;
      if (i < count) {
        const int rr = i / n_feat;
        s_x[(i - rr * n_feat) * tile_rows + rr] = v[q];
      }
    }
    const int64_t row0 = static_cast<int64_t>(tile) * tile_rows;
    const int64_t lim = (static_cast<int64_t>(n) - row0) * n_feat;
    const BinT* src = binned + row0 * n_feat;
    for (int i = threadIdx.x + kPrefetch * blockDim.x; i < count;
         i += blockDim.x) {
      const int rr = i / n_feat;
      s_x[(i - rr * n_feat) * tile_rows + rr] =
          i < lim ? static_cast<int>(__ldg(src + i)) : 0;
    }
  }
};

// A row's starting value: init[row], or init_value when init is null.
__device__ __forceinline__ float start_value(const float* __restrict__ init,
                                             float init_value, int64_t row) {
  return init != nullptr ? init[row] : init_value;
}

// Row r's sum of a tile's leaf values in tree order (adding to its
// starting value on the first chunk of trees, else to what earlier chunks
// left in `out`), loads ahead of the adds.
__device__ __forceinline__ void sum_row(const float* __restrict__ vals,
                                        float* __restrict__ out,
                                        const float* __restrict__ init,
                                        float init_value, int64_t row, int r,
                                        int tile_rows, int tc,
                                        bool first_chunk) {
  float acc = first_chunk ? start_value(init, init_value, row) : out[row];
  int t = 0;
  for (; t + kSumAhead <= tc; t += kSumAhead) {
    float v[kSumAhead];
#pragma unroll
    for (int q = 0; q < kSumAhead; ++q) v[q] = vals[(t + q) * tile_rows + r];
#pragma unroll
    for (int q = 0; q < kSumAhead; ++q) acc = __fadd_rn(acc, v[q]);
  }
  for (; t < tc; ++t) acc = __fadd_rn(acc, vals[t * tile_rows + r]);
  out[row] = acc;
}

template <typename BinT, bool kStageX>
__global__ void __launch_bounds__(kMaxThreads, 1)
forest_traverse_tiles(const BinT* __restrict__ binned,
                      const int32_t* __restrict__ sf,
                      const int32_t* __restrict__ sb,
                      const float* __restrict__ lv,
                      const float* __restrict__ w, float* __restrict__ out,
                      const float* __restrict__ init, float init_value,
                      int n, int n_feat, int n_trees, int n_nodes, int depth,
                      int tile_rows, int groups, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(chunk, depth, tile_rows, n_feat, kStageX, groups > 1);
  int2* s_rec = reinterpret_cast<int2*>(smem);  // [chunk][nrec]
  float* s_leaf = reinterpret_cast<float*>(smem + L.leaf_off);
  // buffer b of the bin tiles and of the leaf values (pointers computed
  // from `smem`, so that their accesses compile to shared-memory ones)
  auto s_x = [&](int b) {
    return reinterpret_cast<int32_t*>(smem + L.x_off + b * L.x_bytes);
  };
  auto s_vals = [&](int b) {
    return reinterpret_cast<float*>(smem + L.vals_off + b * L.vals_bytes);
  };

  const int nleaf = 1 << depth;
  const int nrec = nleaf - 1;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int row_warps = tile_rows / kWarp;
  const int r = (warp % row_warps) * kWarp + lane;  // row in a tile
  const int g = warp / row_warps;                   // tree group
  const int n_tiles = (n + tile_rows - 1) / tile_rows;
  // an early leaf, and each node below it: always left (feature row F,
  // which holds zeros; split bin INT_MAX)
  const int2 kLeft =
      make_int2(kStageX ? 4 * n_feat * tile_rows : n_feat, INT_MAX);
  TileBins<BinT> bins;

  if (kStageX) {  // feature row F of both tiles: zeros
    for (int i = tid; i < 2 * tile_rows; i += blockDim.x) {
      s_x(i / tile_rows)[n_feat * tile_rows + i % tile_rows] = 0;
    }
  }
  STAMP(0);
  for (int t0 = 0; t0 < n_trees; t0 += chunk) {
    const int tc = min(chunk, n_trees - t0);
    __syncthreads();  // the previous chunk's readers and sums are done
    if (kStageX && blockIdx.x < n_tiles) {
      bins.load(binned, n, n_feat, tile_rows, blockIdx.x);
    }
    // compact tables of trees [t0, t0 + tc), by the whole block: slot i
    // is node i & (2^(D+1) - 1) of tree i >> (D + 1) (the last slot of a
    // tree holds no node). 1: kNodes slots a thread by coalesced loads,
    // all in flight before the first store: an internal node takes its
    // record, or (-1, its weighted value) if it is an early leaf (sf < 0);
    // a last-level node takes its weighted value.
    const int shift = depth + 1;
    const int slot_mask = (1 << shift) - 1;
    const int slots = tc << shift;
    int early = 0;
    for (int i0 = tid; i0 < slots; i0 += kNodes * blockDim.x) {
      int f[kNodes], b[kNodes];
      float v[kNodes], wt[kNodes];
#pragma unroll
      for (int q = 0; q < kNodes; ++q) {
        const int i = i0 + q * blockDim.x;
        const int j = i & slot_mask;
        f[q] = 0;
        b[q] = 0;
        if (i < slots && j < slot_mask) {
          const int t = t0 + (i >> shift);
          const uint32_t at = static_cast<uint32_t>(t) * n_nodes + j;
          if (j < nrec) {
            f[q] = __ldg(sf + at);
            b[q] = __ldg(sb + at);
          }
          v[q] = __ldg(lv + at);
          wt[q] = __ldg(w + t);
        }
      }
#pragma unroll
      for (int q = 0; q < kNodes; ++q) {
        const int i = i0 + q * blockDim.x;
        const int j = i & slot_mask;
        if (i >= slots) break;
        if (j == slot_mask) continue;
        const int t = i >> shift;
        const float val = __fmul_rn(wt[q], v[q]);
        int2* rec = s_rec + t * nrec + j;
        if (j >= nrec) {
          s_leaf[t * nleaf + j - nrec] = val;
        } else if (f[q] < 0) {
          *rec = make_int2(-1, __float_as_int(val));
          early = 1;
        } else if (f[q] < n_feat) {
          *rec = make_int2(kStageX ? 4 * f[q] * tile_rows : f[q], b[q]);
        } else {
          *rec = make_int2(kLeft.x, b[q] < 0 ? -1 : 0);  // bin 0 > sb
        }
      }
    }
    if (__syncthreads_or(early)) {
      if (t0 == 0) STAMP(1);
      // 2: level by level from the root, a node whose parent is marked
      // (-1, value) takes that mark, or on the last level that value; one
      // barrier a level
      for (int l = 1; l <= depth; ++l) {
        const int lmask = (1 << l) - 1;
        for (int i = tid; i < (tc << l); i += blockDim.x) {
          const int t = i >> l;
          const int j = lmask + (i & lmask);
          const int2 par = s_rec[t * nrec + ((j - 1) >> 1)];
          if (par.x != -1) continue;
          if (l < depth) {
            s_rec[t * nrec + j] = par;
          } else {
            s_leaf[t * nleaf + (i & lmask)] = __int_as_float(par.y);
          }
        }
        __syncthreads();
      }
      // 3: marked nodes go always left
      for (int i = tid; i < tc * nrec; i += blockDim.x) {
        if (s_rec[i].x == -1) s_rec[i] = kLeft;
      }
    } else if (t0 == 0) {
      STAMP(1);
    }
    if (t0 == 0) STAMP(2);
    if (kStageX && blockIdx.x < n_tiles) {
      bins.store(binned, n, n_feat, tile_rows, blockIdx.x, s_x(0));
    }
    // the tiles: descend tile k while the sum of tile k - 1 follows, with
    // double-buffered bins and leaf values and one barrier a tile
    const int cnt = g < tc ? (tc - 1 - g) / groups + 1 : 0;
    int k = 0;
    int64_t prev0 = 0;
    int prev_rows = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
      const int64_t row0 = static_cast<int64_t>(tile) * tile_rows;
      const int rows = static_cast<int>(min(static_cast<int64_t>(tile_rows),
                                            static_cast<int64_t>(n) - row0));
      const int next = tile + gridDim.x;
      __syncthreads();  // tables and this tile's bins are in; the buffers
                        // written below are no longer read
      if (t0 == 0 && k == 0) STAMP(3);
      if (kStageX && next < n_tiles) {
        bins.load(binned, n, n_feat, tile_rows, next);
      }
      const BinT* xrow =
          binned + (row0 + min(r, rows - 1)) * static_cast<int64_t>(n_feat);
      const int32_t* x = s_x(k & 1);
      float* vals = s_vals(k & 1);
      int q = 0;
      if (groups == 1) {
        // one group: a thread runs every tree of its row in order and adds
        // the values as it goes (no leaf-value buffer, no separate sum)
        float acc = 0.0f;
        if (r < rows) {
          acc = t0 == 0 ? start_value(init, init_value, row0 + r)
                        : out[row0 + r];
        }
        for (; q + kBatch <= tc; q += kBatch) {
          acc = descend<kBatch, BinT, kStageX, true>(
              s_rec, s_leaf, x, vals, xrow, n_feat, depth, nrec, tile_rows, r,
              q, 1, acc);
        }
        for (; q < tc; ++q) {
          acc = descend<1, BinT, kStageX, true>(s_rec, s_leaf, x, vals, xrow,
                                                n_feat, depth, nrec, tile_rows,
                                                r, q, 1, acc);
        }
        if (r < rows) out[row0 + r] = acc;
      } else {
        for (; q + kBatch <= cnt; q += kBatch) {
          descend<kBatch, BinT, kStageX>(s_rec, s_leaf, x, vals, xrow, n_feat,
                                         depth, nrec, tile_rows, r,
                                         g + q * groups, groups);
        }
        if (q + 2 <= cnt) {
          descend<2, BinT, kStageX>(s_rec, s_leaf, x, vals, xrow, n_feat,
                                    depth, nrec, tile_rows, r, g + q * groups,
                                    groups);
          q += 2;
        }
        if (q < cnt) {
          descend<1, BinT, kStageX>(s_rec, s_leaf, x, vals, xrow, n_feat,
                                    depth, nrec, tile_rows, r, g + q * groups,
                                    groups);
        }
      }
      if (t0 == 0 && k == 0) STAMP(4);
      if (kStageX && next < n_tiles) {
        bins.store(binned, n, n_feat, tile_rows, next, s_x((k + 1) & 1));
      }
      if (groups > 1 && k > 0 && tid < prev_rows) {
        sum_row(s_vals((k - 1) & 1), out, init, init_value, prev0 + tid, tid,
                tile_rows, tc, t0 == 0);
      }
      prev0 = row0;
      prev_rows = rows;
    }
    __syncthreads();  // the last tile's leaf values are written
    if (groups > 1 && k > 0 && tid < prev_rows) {
      sum_row(s_vals((k - 1) & 1), out, init, init_value, prev0 + tid, tid,
              tile_rows, tc, t0 == 0);
    }
  }
  STAMP(5);
}

template <typename BinT>
__global__ void __launch_bounds__(kGlobalThreads)
forest_traverse_global(const BinT* __restrict__ binned,
                       const int32_t* __restrict__ sf,
                       const int32_t* __restrict__ sb,
                       const float* __restrict__ lv,
                       const float* __restrict__ w, float* __restrict__ out,
                       const float* __restrict__ init, float init_value,
                       int n, int n_feat, int n_trees, int n_nodes,
                       int depth) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const BinT* x = binned + static_cast<size_t>(row) * n_feat;
  float acc = start_value(init, init_value, row);
  for (int t = 0; t < n_trees; ++t) {
    const size_t base = static_cast<size_t>(t) * n_nodes;
    int node = 0;
    for (int lvl = 0; lvl < depth; ++lvl) {
      const int f = __ldg(sf + base + node);
      if (f < 0) break;  // an early leaf: the row stays here
      const int xb = f < n_feat ? static_cast<int>(x[f]) : 0;
      node = 2 * node + 1 + (xb > __ldg(sb + base + node) ? 1 : 0);
    }
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + t), __ldg(lv + base + node)));
  }
  out[row] = acc;
}

struct Plan {
  int shared, tile_rows, groups, threads, chunk, grid, stage_x;
};

// The opt-in above 48 KB of dynamic shared memory, made on each device
// when a launch needs more than any before it there (one table per
// kernel instantiation), under a lock: launches from two threads must
// not leave the attribute below what the larger one needs.
template <typename BinT, bool kStageX>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kDevices = 64;
  static int set[kDevices] = {};
  static std::mutex set_lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int want = static_cast<int>(bytes);
  if (want <= 48 * 1024) return cudaSuccess;
  std::lock_guard<std::mutex> guard(set_lock);
  if (dev < kDevices && want <= set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(forest_traverse_tiles<BinT, kStageX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, want);
  if (err == cudaSuccess && dev < kDevices) set[dev] = want;
  return err;
}

template <typename BinT, bool kStageX>
cudaError_t launch_tiles(const BinT* b, const int32_t* f, const int32_t* s,
                         const float* v, const float* wt, float* o,
                         const float* in, float in_value, int n, int n_feat,
                         int n_trees, int n_nodes, int depth, const Plan& p,
                         cudaStream_t stream) {
  const Layout L(p.chunk, depth, p.tile_rows, n_feat, kStageX, p.groups > 1);
  if (L.total > kSmemBlock) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<BinT, kStageX>(L.total);
  if (err != cudaSuccess) return err;
  forest_traverse_tiles<BinT, kStageX><<<p.grid, p.threads, L.total, stream>>>(
      b, f, s, v, wt, o, in, in_value, n, n_feat, n_trees, n_nodes, depth,
      p.tile_rows, p.groups, p.chunk);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch(const void* binned, const void* sf, const void* sb,
                   const void* lv, const void* w, void* out, const void* init,
                   float init_value, int n, int n_feat, int n_trees,
                   int n_nodes, int depth, const Plan& p,
                   cudaStream_t stream) {
  const BinT* b = static_cast<const BinT*>(binned);
  const int32_t* f = static_cast<const int32_t*>(sf);
  const int32_t* s = static_cast<const int32_t*>(sb);
  const float* v = static_cast<const float*>(lv);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  const float* in = static_cast<const float*>(init);
  if (!p.shared) {
    const dim3 grid((n + kGlobalThreads - 1) / kGlobalThreads);
    forest_traverse_global<BinT><<<grid, kGlobalThreads, 0, stream>>>(
        b, f, s, v, wt, o, in, init_value, n, n_feat, n_trees, n_nodes, depth);
    return cudaGetLastError();
  }
  if (p.stage_x) {
    return launch_tiles<BinT, true>(b, f, s, v, wt, o, in, init_value, n,
                                    n_feat, n_trees, n_nodes, depth, p,
                                    stream);
  }
  return launch_tiles<BinT, false>(b, f, s, v, wt, o, in, init_value, n,
                                   n_feat, n_trees, n_nodes, depth, p,
                                   stream);
}

}  // namespace

// bin_bytes: 1 = uint8, 2 = uint16, 4 = int32 bin matrix (n, n_feat),
// row-major. sf, sb: int32 (n_trees, n_nodes); lv: f32 (n_trees,
// n_nodes); w: f32 (n_trees,); out: f32 (n,); init: f32 (n,), each row's
// starting value, or null for init_value in every row. The launch
// (traverse_plan):
// shared = 0 runs the global-memory kernel (256 threads a block, one row
// each); shared = 1 runs the tiled kernel with `grid` blocks of `threads`
// = tile_rows * groups threads, tile_rows a multiple of 32, trees staged
// `chunk` at a time, bins staged when stage_x. Returns a cudaError_t.
extern "C" int sml_forest_traverse(int bin_bytes, const void* binned,
                                   const void* sf, const void* sb,
                                   const void* lv, const void* w, void* out,
                                   int n, int n_feat, int n_trees,
                                   int n_nodes, int depth, int shared,
                                   int tile_rows, int groups, int threads,
                                   int chunk, int grid, int stage_x,
                                   const void* init, float init_value,
                                   void* stream) {
  if (n <= 0 || n_feat <= 0 || n_trees <= 0 || n_nodes <= 0 || depth < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shared &&
      (depth > kMaxSharedDepth || n_nodes < (2 << depth) - 1 || n_nodes < 4 ||
       tile_rows <= 0 || tile_rows % kWarp != 0 || groups <= 0 ||
       threads != tile_rows * groups || threads > kMaxThreads || chunk <= 0 ||
       grid <= 0 || static_cast<int64_t>(n_feat + 1) * tile_rows >= INT_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p{shared, tile_rows, groups, threads, chunk, grid, stage_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return static_cast<int>(launch<uint8_t>(binned, sf, sb, lv, w, out,
                                              init, init_value, n,
                                              n_feat, n_trees, n_nodes, depth,
                                              p, s));
    case 2:
      return static_cast<int>(launch<uint16_t>(binned, sf, sb, lv, w, out,
                                               init, init_value, n,
                                               n_feat, n_trees, n_nodes, depth,
                                               p, s));
    case 4:
      return static_cast<int>(launch<int32_t>(binned, sf, sb, lv, w, out,
                                              init, init_value, n,
                                              n_feat, n_trees, n_nodes, depth,
                                              p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef SML_TRAVERSE_STAMPS
// Copies the phase stamps (kStampBlocks x kStamps int64) to `host`.
extern "C" int sml_forest_traverse_stamps(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps)));
}
#endif
