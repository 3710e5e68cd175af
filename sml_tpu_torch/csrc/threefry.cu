// The sampled tree fits' random draws, a whole fit in one launch each:
// the row weights of every round and the feature subspace of every node
// of every level of every round.
//
// Replaces the jax.random calls that XLA compiles into the JAX package's
// fit program (sml_tpu/ml/tree_impl.py:551-553, the level's feature
// uniforms and their ranks, and :785-796, a round's Poisson or Bernoulli
// row weights); jax.random has no Pallas kernel. Both entry points
// reproduce jax 0.9.0's bits under jax_threefry_partitionable=True:
// element i of a draw hashes the counter pair (i >> 32, i & 0xFFFFFFFF)
// of its flat index with Threefry-2x32 (20 rounds, rotations
// 13,15,26,6 / 17,29,16,24, a key injection after every four rounds) and
// takes the XOR of the two hashed words; a uniform is those bits >> 9
// with the exponent of 1.0, read as an f32, minus 1.
//
// A fit of E elements (the (grid point x fold) fits of a fused tuning
// fit; a sequential fit is E = 1) draws R rounds at once. The host
// derives every key once and copies them in one go (tree_impl.fit_keys):
// round r's weight key of element e, and its level keys, one a level.
// The kernels read them in place, through a stride between rounds, so a
// fit's rounds t0..T-1 are a view of its key tensor. Element e draws
// over its own flat indices, so its values are those of its own draw.
//
// - row_weights: a block row per (round, element), each thread over
//   `P` rows of it, strided by the block's width so that a warp's stores
//   are contiguous. Per element a mode: ones (1 a row), Bernoulli (1
//   where the row's uniform is below p, in f32), Poisson (Knuth's loop,
//   as jax draws a rate below 10): every row walks the same key chain
//   (key, sub) = split(key), the hashes of the counters (0, 0) and
//   (0, 1); while its f32 log-sum is above -rate a row counts one and
//   adds the log of its uniform under `sub`; it writes its count minus
//   1. The chain's two hashes a step are the same on every row, so a
//   thread walks the chain once for its P rows: each step costs two
//   chain hashes and one uniform hash for each of its rows still
//   counting. The host picks P, 1, 2, 4 or 8: the most that still gives
//   the grid 1,024 threads an SM, since a small grid (a round or two) at
//   8 rows a thread leaves SMs idle.
//   The log is log in float64 rounded to f32, as in the plain version
//   (sml_tpu_torch/utils/prng.py): the card and the CPU then agree, and
//   a count differs from jax's (whose f32 log on the CPU is not
//   correctly rounded) only where the log-sum lies within an ulp or two
//   of -rate. Rows past an element's row count (the padding up to the
//   longest element) weigh 0; a Poisson rate outside [0, 10) writes NaN
//   (the wrapper refuses it on the host).
// - feature_mask: a warp per node, eight nodes a block, over every
//   (round, level, element, node) of the fit. Within a round the rows are
//   level-major: level L's E * 2^L nodes start at row E * (2^L - 1),
//   element-major, then node, so a round's level is the contiguous block
//   the split scan reads. Node j of level L draws the uniforms at flat
//   indices j * F + f under its element's level key, and a feature is a
//   candidate where its rank (smaller values, and equal values at lower
//   indices: the rank a stable argsort gives) is below the element's k.
//   For F <= 32 lane f holds feature f's uniform in a register and counts
//   its rank over the warp's shuffles; past 32 the lanes loop over the
//   features with the node's row in shared memory (F floats a warp,
//   within the 48 KB a block has without opting in).
//
// What bounds them on an H100: integer work, about 80 operations a hash,
// at 64 INT32 lanes an SM a clock, and for Poisson the float64 log at the
// f64 rate. A fit's masks are a few thousand hashes, far below a launch's
// fixed cost: one launch a fit is what the design buys there. A fit's
// Poisson weights (20 rounds of 80,000 rows at ML 07) are a few million
// hashes and logs; rows a thread trade the chain's cost against the
// warp waiting on its slowest row and against the threads the SMs need.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kMaxThreads = 256;

// Rotation j of the four rounds of group i: 13,15,26,6 on even groups,
// 17,29,16,24 on odd ones (constants once the loops are unrolled).
__device__ __forceinline__ int rotation(int i, int j) {
  return (i & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                 : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k1, uint32_t k2,
                                              uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ kParity};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = __funnelshift_l(x2, x2, rotation(i, j)) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x1, x2);
}

// The f32 uniform in [0, 1) of flat index `idx` under key (k1, k2).
__device__ __forceinline__ float uniform_at(uint32_t k1, uint32_t k2,
                                            int64_t idx) {
  const uint2 b = threefry2x32(k1, k2, static_cast<uint32_t>(idx >> 32),
                               static_cast<uint32_t>(idx));
  const uint32_t bits = ((b.x ^ b.y) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

// out: (R * E, n_pad), row r * E + e; keys: round r's pairs at
// keys + r * key_stride; blockIdx.y = r * E + e.
template <int P>
__global__ void __launch_bounds__(kMaxThreads)
row_weights_kernel(float* __restrict__ out, const uint32_t* __restrict__ keys,
                   int64_t key_stride, const int* __restrict__ modes,
                   const float* __restrict__ rates,
                   const int* __restrict__ counts, int n_elems, int n_pad) {
  const int re = blockIdx.y;
  const int e = re % n_elems;
  const uint32_t* key = keys + (re / n_elems) * key_stride + 2 * e;
  const uint32_t k1 = key[0], k2 = key[1];
  const int mode = modes[e];
  const float rate = rates[e];
  const int64_t n = min(counts[e], n_pad);
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x * P + threadIdx.x;
  float* dst = out + static_cast<int64_t>(re) * n_pad;
  if (mode != 1 || !(rate >= 0.0f && rate < 10.0f)) {
    // one store or one uniform a row; NaN for a rate Knuth's loop refuses
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int64_t i = first + static_cast<int64_t>(j) * blockDim.x;
      if (i < n_pad) {
        float w = 0.0f;
        if (i < n) {
          w = mode == 2   ? 1.0f
              : mode == 0 ? (uniform_at(k1, k2, i) < rate ? 1.0f : 0.0f)
                          : NAN;
        }
        dst[i] = w;
      }
    }
    return;
  }
  const float neg = -rate;
  float log_prod[P];
  int count[P];
  unsigned counting = 0;  // bit j: row j's log-sum is still above -rate
#pragma unroll
  for (int j = 0; j < P; ++j) {
    log_prod[j] = 0.0f;
    count[j] = 0;
    // a rate of 0 never enters the loop: its count is 0, as jax gives
    if (first + static_cast<int64_t>(j) * blockDim.x < n && 0.0f > neg) {
      counting |= 1u << j;
    }
  }
  uint32_t r1 = k1, r2 = k2;
  while (counting) {
    const uint2 next = threefry2x32(r1, r2, 0u, 0u);
    const uint2 sub = threefry2x32(r1, r2, 0u, 1u);
    r1 = next.x;
    r2 = next.y;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (counting & (1u << j)) {
        const int64_t i = first + static_cast<int64_t>(j) * blockDim.x;
        ++count[j];
        const float u = uniform_at(sub.x, sub.y, i);
        log_prod[j] = __fadd_rn(
            log_prod[j], __double2float_rn(log(static_cast<double>(u))));
        if (!(log_prod[j] > neg)) counting &= ~(1u << j);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int64_t i = first + static_cast<int64_t>(j) * blockDim.x;
    if (i < n_pad) {
      dst[i] = i < n ? static_cast<float>(count[j] > 0 ? count[j] - 1 : 0)
                     : 0.0f;
    }
  }
}

// out: (R, E * (2^D - 1), F); keys: round r's (D, E) pairs at
// keys + r * key_stride; a warp per node of `n_nodes` = R * E * (2^D - 1).
__global__ void __launch_bounds__(kMaxThreads)
feature_mask_kernel(float* __restrict__ out, const uint32_t* __restrict__ keys,
                    int64_t key_stride, const int* __restrict__ ks,
                    int n_elems, int depth, int n_feat, int64_t n_nodes) {
  extern __shared__ float s_u[];  // F uniforms a warp, past 32 features
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (g >= n_nodes) return;  // the whole warp
  const int64_t per_round = static_cast<int64_t>(n_elems) * ((1 << depth) - 1);
  const int64_t r = g / per_round;
  const int row = static_cast<int>(g - r * per_round);
  // level L's rows start at E * (2^L - 1): L = floor(log2(row / E + 1))
  const int level = 31 - __clz(row / n_elems + 1);
  const int within = row - n_elems * ((1 << level) - 1);
  const int e = within >> level;
  const int node = within & ((1 << level) - 1);
  const uint32_t* key =
      keys + r * key_stride + 2 * (static_cast<int64_t>(level) * n_elems + e);
  const uint32_t k1 = key[0], k2 = key[1];
  const int k = ks[e];
  const int64_t base = static_cast<int64_t>(node) * n_feat;
  float* dst = out + g * n_feat;
  if (n_feat <= 32) {
    const float u = lane < n_feat ? uniform_at(k1, k2, base + lane) : 0.0f;
    int rank = 0;
    for (int f = 0; f < n_feat; ++f) {
      const float uf = __shfl_sync(0xFFFFFFFFu, u, f);
      rank += (uf < u) | ((uf == u) & (f < lane));
    }
    if (lane < n_feat) dst[lane] = rank < k ? 1.0f : 0.0f;
    return;
  }
  float* s = s_u + static_cast<int64_t>(warp) * n_feat;
  for (int f = lane; f < n_feat; f += 32) s[f] = uniform_at(k1, k2, base + f);
  __syncwarp();
  for (int f = lane; f < n_feat; f += 32) {
    const float uf = s[f];
    int rank = 0;
    for (int h = 0; h < n_feat; ++h) {
      const float uh = s[h];
      rank += (uh < uf) | ((uh == uf) & (h < f));
    }
    dst[f] = rank < k ? 1.0f : 0.0f;
  }
}

template <int P>
void launch_row_weights(dim3 grid, int threads, cudaStream_t stream,
                        float* out, const uint32_t* keys, int64_t key_stride,
                        const int* modes, const float* rates,
                        const int* counts, int n_elems, int n_pad) {
  row_weights_kernel<P><<<grid, threads, 0, stream>>>(
      out, keys, key_stride, modes, rates, counts, n_elems, n_pad);
}

}  // namespace

// out: f32 (n_rounds * n_elems, n_pad); keys: uint32, round r's (n_elems,
// 2) pairs at keys + r * key_stride; modes: int32 (n_elems,), 0
// Bernoulli(rate), 1 Poisson(rate) with rate in [0, 10), 2 ones; rates:
// f32 (n_elems,); counts: int32 (n_elems,), an element's rows at or past
// its count weigh 0. A grid of `blocks` x (n_rounds * n_elems) blocks of
// `threads` threads, each over `rows_per_thread` rows (1, 2, 4 or 8),
// covers every row. Returns a cudaError_t.
extern "C" int sml_row_weights(void* out, const void* keys,
                               long long key_stride, const void* modes,
                               const void* rates, const void* counts,
                               int n_rounds, int n_elems, int n_pad,
                               int threads, int rows_per_thread, int blocks,
                               void* stream) {
  if (n_rounds <= 0 || n_elems <= 0 || n_pad <= 0 ||
      static_cast<int64_t>(n_rounds) * n_elems > 65535 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || blocks <= 0 ||
      key_stride < 2LL * n_elems ||
      static_cast<int64_t>(threads) * rows_per_thread * blocks < n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(blocks, n_rounds * n_elems);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* m = static_cast<const int*>(modes);
  const auto* r = static_cast<const float*>(rates);
  const auto* c = static_cast<const int*>(counts);
  switch (rows_per_thread) {
    case 1: launch_row_weights<1>(grid, threads, s, o, k, key_stride, m, r, c,
                                  n_elems, n_pad); break;
    case 2: launch_row_weights<2>(grid, threads, s, o, k, key_stride, m, r, c,
                                  n_elems, n_pad); break;
    case 4: launch_row_weights<4>(grid, threads, s, o, k, key_stride, m, r, c,
                                  n_elems, n_pad); break;
    case 8: launch_row_weights<8>(grid, threads, s, o, k, key_stride, m, r, c,
                                  n_elems, n_pad); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: f32 (n_rounds, n_elems * (2^depth - 1), n_feat); keys: uint32,
// round r's (depth, n_elems, 2) pairs at keys + r * key_stride; ks: int32
// (n_elems,). `blocks` blocks of `warps` warps, a warp a node, with
// 4 * n_feat bytes of dynamic shared memory a warp past 32 features (at
// most 48 KB a block). Returns a cudaError_t.
extern "C" int sml_feature_mask(void* out, const void* keys,
                                long long key_stride, const void* ks,
                                int n_rounds, int n_elems, int depth,
                                int n_feat, int warps, int blocks,
                                void* stream) {
  if (n_rounds <= 0 || n_elems <= 0 || depth <= 0 || depth > 30 ||
      n_feat <= 0 || warps <= 0 || warps * 32 > kMaxThreads || blocks <= 0 ||
      key_stride < 2LL * depth * n_elems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_nodes =
      static_cast<int64_t>(n_rounds) * n_elems * ((1LL << depth) - 1);
  const size_t smem =
      n_feat > 32 ? sizeof(float) * static_cast<size_t>(warps) * n_feat : 0;
  if (smem > 48 * 1024 || static_cast<int64_t>(blocks) * warps < n_nodes ||
      static_cast<int64_t>(n_elems) * ((1LL << depth) - 1) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  feature_mask_kernel<<<blocks, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const uint32_t*>(keys),
      key_stride, static_cast<const int*>(ks), n_elems, depth, n_feat,
      n_nodes);
  return static_cast<int>(cudaGetLastError());
}
