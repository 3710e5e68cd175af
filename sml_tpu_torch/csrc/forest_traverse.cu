// Weighted margin of a stacked tree ensemble over rows of compact bins.
//
// Replaces the TPU kernel `forest_traverse` in
// sml_tpu/native/traverse_kernel.py (the Pallas body at :134, launched at
// :175). It computes the same function: for each row, the sum over trees
// in order of w[t] * lv[t][leaf], where the leaf is reached from node 0
// of the level-order heap (children of node i at 2i+1 and 2i+2) by at
// most `depth` steps right iff x[sf[node]] > sb[node], stopping early at
// a node whose sf is negative.
//
// Design. The Pallas body selects each node and each feature with
// one-hot masked sums, because gathers were slow on the TPU. Hopper
// indexes directly: one thread per row walks each tree with
// `node = 2*node + 1 + (x[f] > sb[node])`, so the work per row is the
// levels it actually descends, not every node of every level.
//
// What bounds it. Per row it reads F bin bytes and writes 4; the node
// tables (12 * T * N bytes) are shared by every row. Each level is a
// dependent chain of two table loads and one bin load, so the kernel is
// bound by load latency and shared-memory throughput, far from the
// card's HBM or ALU limits. The tables are therefore staged into shared
// memory, in chunks of trees that fit the default 48 KB a block may use
// without opting in; trees too large for one chunk (depth >= 11) are
// read through the L1/L2 caches from device memory instead.
//
// Numerics. Leaf choice is exact (integer compares). The tree sum is
// f32 with every multiply and add rounded separately (no FMA
// contraction), in tree order, so it equals a sequential f32 loop.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSharedBudget = 48 * 1024;

template <typename BinT, bool kShared>
__global__ void __launch_bounds__(kThreads)
forest_traverse_kernel(const BinT* __restrict__ binned,
                       const int32_t* __restrict__ sf,
                       const int32_t* __restrict__ sb,
                       const float* __restrict__ lv,
                       const float* __restrict__ w,
                       float* __restrict__ out,
                       int n, int n_feat, int n_trees, int n_nodes,
                       int depth, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_sf = reinterpret_cast<int32_t*>(smem);
  int32_t* s_sb = s_sf + static_cast<size_t>(chunk) * n_nodes;
  float* s_lv = reinterpret_cast<float*>(s_sb + static_cast<size_t>(chunk) * n_nodes);

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = row < n;
  const BinT* x = binned + static_cast<size_t>(active ? row : 0) * n_feat;
  float acc = 0.0f;

  for (int t0 = 0; t0 < n_trees; t0 += chunk) {
    const int tc = min(chunk, n_trees - t0);
    const size_t base = static_cast<size_t>(t0) * n_nodes;
    if (kShared) {
      __syncthreads();  // every reader of the previous chunk is done
      const int count = tc * n_nodes;
      for (int i = threadIdx.x; i < count; i += blockDim.x) {
        s_sf[i] = sf[base + i];
        s_sb[i] = sb[base + i];
        s_lv[i] = lv[base + i];
      }
      __syncthreads();
    }
    if (active) {
      for (int t = 0; t < tc; ++t) {
        const size_t off = static_cast<size_t>(t) * n_nodes;
        const int32_t* tsf = kShared ? s_sf + off : sf + base + off;
        const int32_t* tsb = kShared ? s_sb + off : sb + base + off;
        const float* tlv = kShared ? s_lv + off : lv + base + off;
        int node = 0;
        for (int lvl = 0; lvl < depth; ++lvl) {
          const int f = tsf[node];
          if (f < 0) break;  // an early leaf: the row stays here
          // a feature id past the row reads as bin 0, as the one-hot
          // select of the JAX version does
          const int xb = f < n_feat ? static_cast<int>(x[f]) : 0;
          node = 2 * node + 1 + (xb > tsb[node] ? 1 : 0);
        }
        acc = __fadd_rn(acc, __fmul_rn(w[t0 + t], tlv[node]));
      }
    }
  }
  if (active) out[row] = acc;
}

template <typename BinT>
cudaError_t launch(const void* binned, const void* sf, const void* sb,
                   const void* lv, const void* w, void* out, int n,
                   int n_feat, int n_trees, int n_nodes, int depth,
                   cudaStream_t stream) {
  const size_t per_tree = 3 * sizeof(int32_t) * static_cast<size_t>(n_nodes);
  const dim3 grid((n + kThreads - 1) / kThreads);
  const BinT* b = static_cast<const BinT*>(binned);
  const int32_t* f = static_cast<const int32_t*>(sf);
  const int32_t* s = static_cast<const int32_t*>(sb);
  const float* v = static_cast<const float*>(lv);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (per_tree <= kSharedBudget) {
    int chunk = static_cast<int>(kSharedBudget / per_tree);
    if (chunk > n_trees) chunk = n_trees;
    const size_t smem = per_tree * chunk;
    forest_traverse_kernel<BinT, true><<<grid, kThreads, smem, stream>>>(
        b, f, s, v, wt, o, n, n_feat, n_trees, n_nodes, depth, chunk);
  } else {
    forest_traverse_kernel<BinT, false><<<grid, kThreads, 0, stream>>>(
        b, f, s, v, wt, o, n, n_feat, n_trees, n_nodes, depth, n_trees);
  }
  return cudaGetLastError();
}

}  // namespace

// bin_bytes: 1 = uint8, 2 = uint16, 4 = int32 bin matrix (n, n_feat),
// row-major. sf, sb: int32 (n_trees, n_nodes); lv: f32 (n_trees,
// n_nodes); w: f32 (n_trees,); out: f32 (n,). Returns a cudaError_t.
extern "C" int sml_forest_traverse(int bin_bytes, const void* binned,
                                   const void* sf, const void* sb,
                                   const void* lv, const void* w, void* out,
                                   int n, int n_feat, int n_trees,
                                   int n_nodes, int depth, void* stream) {
  if (n <= 0 || n_feat <= 0 || n_trees <= 0 || n_nodes <= 0 || depth < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return static_cast<int>(launch<uint8_t>(binned, sf, sb, lv, w, out, n,
                                              n_feat, n_trees, n_nodes, depth, s));
    case 2:
      return static_cast<int>(launch<uint16_t>(binned, sf, sb, lv, w, out, n,
                                               n_feat, n_trees, n_nodes, depth, s));
    case 4:
      return static_cast<int>(launch<int32_t>(binned, sf, sb, lv, w, out, n,
                                              n_feat, n_trees, n_nodes, depth, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
