// The sampled tree fits' random draws: per-row weights of a round and the
// per-node feature subspace of a tree level.
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
// - row_weights, one thread per row. Bernoulli: 1 where the row's uniform
//   is below p (in f32), else 0. Poisson (Knuth's loop, as jax draws a
//   rate below 10): the row walks the key chain (key, sub) = split(key),
//   the hashes of the counters (0, 0) and (0, 1); while its f32 log-sum is
//   above -rate it counts one and adds the log of its uniform under
//   `sub`; it writes its count minus 1. The log is log in float64 rounded
//   to f32, as in the plain version (sml_tpu_torch/utils/prng.py): the
//   card and the CPU then agree, and a count differs from jax's (whose f32
//   log on the CPU is not correctly rounded) only where the log-sum lies
//   within an ulp or two of -rate. Every row walks the same key chain; it
//   is two hashes a step and costs less than a launch.
// - feature_mask, one block per node: the node's F uniforms into shared
//   memory, then each feature's rank counted over the row (smaller values,
//   and equal values at lower indices: the rank a stable argsort gives),
//   and 1 where the rank is below k.
//
// What bounds it on an H100: integer work, about 80 operations a hash.
// Bernoulli weights at 80,000 rows are 80,000 hashes and 320 KB written,
// a few microseconds at most; a level's mask is at most a few thousand
// hashes. Both are far below a launch's fixed cost, so the design is the
// simplest that is right: no tiling, the launch plan (threads, blocks,
// shared memory) resolved on the host from the shapes.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;

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

__global__ void row_weights_kernel(float* __restrict__ out, int n, int mode,
                                   uint32_t k1, uint32_t k2, float rate) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mode == 0) {  // Bernoulli
    out[i] = uniform_at(k1, k2, i) < rate ? 1.0f : 0.0f;
    return;
  }
  const float neg = -rate;
  float log_prod = 0.0f;
  int count = 0;
  uint32_t r1 = k1, r2 = k2;
  while (log_prod > neg) {
    const uint2 next = threefry2x32(r1, r2, 0u, 0u);
    const uint2 sub = threefry2x32(r1, r2, 0u, 1u);
    r1 = next.x;
    r2 = next.y;
    ++count;
    const float u = uniform_at(sub.x, sub.y, i);
    log_prod = __fadd_rn(log_prod,
                         __double2float_rn(log(static_cast<double>(u))));
  }
  // a rate of 0 never enters the loop: its count is 0, as jax gives
  out[i] = static_cast<float>(count > 0 ? count - 1 : 0);
}

__global__ void feature_mask_kernel(float* __restrict__ out, int n_feat,
                                    int k, uint32_t k1, uint32_t k2) {
  extern __shared__ float s_u[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_feat;
  for (int f = threadIdx.x; f < n_feat; f += blockDim.x) {
    s_u[f] = uniform_at(k1, k2, base + f);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < n_feat; f += blockDim.x) {
    const float uf = s_u[f];
    int rank = 0;
    for (int g = 0; g < n_feat; ++g) {
      const float ug = s_u[g];
      rank += (ug < uf) | ((ug == uf) & (g < f));
    }
    out[base + f] = rank < k ? 1.0f : 0.0f;
  }
}

}  // namespace

// out: f32 (n,); mode 0 Bernoulli(rate), 1 Poisson(rate) with rate in
// [0, 10); `blocks` blocks of `threads` threads cover the rows. Returns a
// cudaError_t.
extern "C" int sml_row_weights(void* out, int n, int mode, uint32_t k1,
                               uint32_t k2, float rate, int threads,
                               int blocks, void* stream) {
  if (n <= 0 || (mode != 0 && mode != 1) || threads <= 0 ||
      threads > 1024 || blocks <= 0 ||
      static_cast<int64_t>(threads) * blocks < n ||
      (mode == 1 && !(rate >= 0.0f && rate < 10.0f))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_weights_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, mode, k1, k2, rate);
  return static_cast<int>(cudaGetLastError());
}

// out: f32 (width, n_feat); one block of `threads` threads per node, with
// 4 * n_feat bytes of dynamic shared memory (at most 48 KB). Returns a
// cudaError_t.
extern "C" int sml_feature_mask(void* out, int width, int n_feat, int k,
                                uint32_t k1, uint32_t k2, int threads,
                                void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_feat);
  if (width <= 0 || n_feat <= 0 || threads <= 0 || threads > 1024 ||
      smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  feature_mask_kernel<<<width, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n_feat, k, k1, k2);
  return static_cast<int>(cudaGetLastError());
}
