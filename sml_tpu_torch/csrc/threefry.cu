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
// Both draw for E elements at once (the (grid point x fold) fits of a fused
// tuning fit; a sequential fit is E = 1): each element has its own key,
// read from device memory (the host derives every key of a fit once and
// copies them in one go), and draws over its own flat indices, so element
// e's values are those of its own one-element draw.
//
// - row_weights, one thread per (element, row). Per element a mode: ones
//   (1 a row), Bernoulli: 1 where the row's uniform
//   is below p (in f32), else 0. Poisson (Knuth's loop, as jax draws a
//   rate below 10): the row walks the key chain (key, sub) = split(key),
//   the hashes of the counters (0, 0) and (0, 1); while its f32 log-sum is
//   above -rate it counts one and adds the log of its uniform under
//   `sub`; it writes its count minus 1. The log is log in float64 rounded
//   to f32, as in the plain version (sml_tpu_torch/utils/prng.py): the
//   card and the CPU then agree, and a count differs from jax's (whose f32
//   log on the CPU is not correctly rounded) only where the log-sum lies
//   within an ulp or two of -rate. Every row walks the same key chain; it
//   is two hashes a step and costs less than a launch. Rows past an
//   element's row count (the padding up to the longest element) weigh 0.
// - feature_mask, one block per (element, node): the node's F uniforms
//   under its element's key into shared
//   memory, then each feature's rank counted over the row (smaller values,
//   and equal values at lower indices: the rank a stable argsort gives),
//   and 1 where the rank is below the element's k.
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

__global__ void row_weights_kernel(float* __restrict__ out,
                                   const uint32_t* __restrict__ keys,
                                   const int* __restrict__ modes,
                                   const float* __restrict__ rates,
                                   const int* __restrict__ counts,
                                   int n_pad) {
  const int e = blockIdx.y;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  float* dst = out + static_cast<int64_t>(e) * n_pad + i;
  const int mode = modes[e];
  if (i >= counts[e]) {  // a padded row of a shorter element
    *dst = 0.0f;
    return;
  }
  if (mode == 2) {  // every row once
    *dst = 1.0f;
    return;
  }
  const uint32_t k1 = keys[2 * e], k2 = keys[2 * e + 1];
  const float rate = rates[e];
  if (mode == 0) {  // Bernoulli
    *dst = uniform_at(k1, k2, i) < rate ? 1.0f : 0.0f;
    return;
  }
  if (!(rate >= 0.0f && rate < 10.0f)) {  // not Knuth's range: the wrapper
    *dst = NAN;                            // refuses it on the host
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
  *dst = static_cast<float>(count > 0 ? count - 1 : 0);
}

__global__ void feature_mask_kernel(float* __restrict__ out,
                                    const uint32_t* __restrict__ keys,
                                    const int* __restrict__ ks, int width,
                                    int n_feat) {
  extern __shared__ float s_u[];
  const int e = blockIdx.x / width;
  const int node = blockIdx.x % width;
  const uint32_t k1 = keys[2 * e], k2 = keys[2 * e + 1];
  const int k = ks[e];
  // the element's own draw of (width, n_feat) uniforms: flat index
  // node * n_feat + f under its key
  const int64_t base = static_cast<int64_t>(node) * n_feat;
  float* dst = out + static_cast<int64_t>(blockIdx.x) * n_feat;
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
    dst[f] = rank < k ? 1.0f : 0.0f;
  }
}

}  // namespace

// out: f32 (n_elems * n_pad,); keys: uint32 (n_elems, 2); modes: int32
// (n_elems,), 0 Bernoulli(rate), 1 Poisson(rate) with rate in [0, 10), 2
// ones; rates: f32 (n_elems,); counts: int32 (n_elems,), an element's rows
// at or past its count weigh 0. A grid of `blocks` x n_elems blocks of
// `threads` threads covers every element's rows. Returns a cudaError_t.
extern "C" int sml_row_weights(void* out, const void* keys, const void* modes,
                               const void* rates, const void* counts,
                               int n_elems, int n_pad, int threads,
                               int blocks, void* stream) {
  if (n_pad <= 0 || n_elems <= 0 || n_elems > 65535 || threads <= 0 ||
      threads > 1024 || blocks <= 0 ||
      static_cast<int64_t>(threads) * blocks < n_pad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_weights_kernel<<<dim3(blocks, n_elems), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const uint32_t*>(keys),
      static_cast<const int*>(modes), static_cast<const float*>(rates),
      static_cast<const int*>(counts), n_pad);
  return static_cast<int>(cudaGetLastError());
}

// out: f32 (n_elems * width, n_feat); keys: uint32 (n_elems, 2); ks: int32
// (n_elems,). One block of `threads` threads per (element, node), with
// 4 * n_feat bytes of dynamic shared memory (at most 48 KB). Returns a
// cudaError_t.
extern "C" int sml_feature_mask(void* out, const void* keys, const void* ks,
                                int n_elems, int width, int n_feat,
                                int threads, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_feat);
  if (n_elems <= 0 || width <= 0 || n_feat <= 0 || threads <= 0 ||
      threads > 1024 || smem > 48 * 1024 ||
      static_cast<int64_t>(n_elems) * width >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  feature_mask_kernel<<<n_elems * width, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const uint32_t*>(keys),
      static_cast<const int*>(ks), width, n_feat);
  return static_cast<int>(cudaGetLastError());
}
