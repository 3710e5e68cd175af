// Per-level best split of every node from its post-merge histogram.
//
// Replaces the TPU kernel `split_scan` in sml_tpu/native/hist_kernel.py
// (the Pallas body at :225, launched at :259). It computes the same
// function: for each node w, prefix sums GL, HL, WL over the bins of each
// feature, the second-order gain
//   GL^2/((HL+lam)+1e-12) + (G-GL)^2/(((H-HL)+lam)+1e-12)
//     - G^2/((H+lam)+1e-12)
// with G, H, W each feature's OWN totals, the candidate masks (WL >= mi,
// W-WL >= mi, not the last bin, feature allowed for the node), and the
// argmax over the flat index f*B + b, emitting a (6, W) f32 pack
//   [best feature, best bin, 0.5*best - gamma, G, H, W of feature 0].
//
// The argmax follows jnp.argmax: the lowest flat index wins a tie, a NaN
// counts as larger than any number and the first NaN wins, and a node
// whose candidates are all masked to -inf gets index 0 (its bin is still
// written: the builder stores it in split_bin even when the node does not
// split).
//
// Numerics. The prefix is a sequential f32 sum from 0 in bin order, and
// every operation is rounded on its own (__fadd_rn and friends, no FMA),
// in the association written above, so the kernel equals its plain
// PyTorch version bit for bit.
//
// What bounds it on an H100. Its input is the level's histogram (F*B*W*12
// bytes, a few hundred KB at most on the course widths) and it writes
// 24*W bytes: it is bound by latency, not by bytes or flops. One block
// takes one node; it first copies the node's F*B*3 values into shared
// memory (when they fit in 48 KB) so that the sequential scans read
// shared memory instead of waiting on L2, then one thread scans each
// feature and the block reduces the per-feature bests.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr size_t kSharedBudget = 48 * 1024;

// Whether candidate (vb, ib) beats (va, ia) under jnp.argmax's rule; an
// index below 0 is no candidate.
__device__ __forceinline__ bool beats(float vb, int ib, float va, int ia) {
  if (ib < 0) return false;
  if (ia < 0) return true;
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return nb;
  if (!na && va != vb) return vb > va;
  return ib < ia;
}

__device__ __forceinline__ float gain_term(float g, float h, float lam) {
  return __fdiv_rn(__fmul_rn(g, g), __fadd_rn(__fadd_rn(h, lam), 1e-12f));
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
split_scan_kernel(const float* __restrict__ hist,
                  const float* __restrict__ feat_mask,
                  const float* __restrict__ min_inst, float* __restrict__ out,
                  int n_feat, int n_bins, int width, float lam, float gamma) {
  extern __shared__ __align__(16) float s_hist[];  // [F][B][3] of this node
  __shared__ float s_val[kThreads];
  __shared__ int s_idx[kThreads];
  const int w = blockIdx.x;
  const float mi = min_inst[0];
  const int64_t col = static_cast<int64_t>(width) * 3;  // stride of one bin

  if (kShared) {
    const int count = n_feat * n_bins * 3;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int k = i % 3, fb = i / 3;
      s_hist[i] = hist[fb * col + static_cast<int64_t>(w) * 3 + k];
    }
    __syncthreads();
  }

  float best = 0.0f;
  int best_i = -1;
  for (int f = threadIdx.x; f < n_feat; f += blockDim.x) {
    const float* h = kShared
        ? s_hist + static_cast<int64_t>(f) * n_bins * 3
        : hist + static_cast<int64_t>(f) * n_bins * col +
              static_cast<int64_t>(w) * 3;
    const int64_t step = kShared ? 3 : col;
    float G = 0.0f, H = 0.0f, Wt = 0.0f;
    for (int b = 0; b < n_bins; ++b) {
      G = __fadd_rn(G, h[b * step + 0]);
      H = __fadd_rn(H, h[b * step + 1]);
      Wt = __fadd_rn(Wt, h[b * step + 2]);
    }
    if (f == 0) {
      out[3 * width + w] = G;
      out[4 * width + w] = H;
      out[5 * width + w] = Wt;
    }
    const bool allowed =
        feat_mask[static_cast<int64_t>(w) * n_feat + f] > 0.0f;
    const float parent = gain_term(G, H, lam);
    float GL = 0.0f, HL = 0.0f, WL = 0.0f;
    for (int b = 0; b < n_bins; ++b) {
      GL = __fadd_rn(GL, h[b * step + 0]);
      HL = __fadd_rn(HL, h[b * step + 1]);
      WL = __fadd_rn(WL, h[b * step + 2]);
      const float score = __fsub_rn(
          __fadd_rn(gain_term(GL, HL, lam),
                    gain_term(__fsub_rn(G, GL), __fsub_rn(H, HL), lam)),
          parent);
      const bool ok = WL >= mi && __fsub_rn(Wt, WL) >= mi &&
                      b < n_bins - 1 && allowed;
      const float sc = ok ? score : -INFINITY;
      const int idx = f * n_bins + b;
      if (beats(sc, idx, best, best_i)) {
        best = sc;
        best_i = idx;
      }
    }
  }

  s_val[threadIdx.x] = best;
  s_idx[threadIdx.x] = best_i;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half &&
        beats(s_val[threadIdx.x + half], s_idx[threadIdx.x + half],
              s_val[threadIdx.x], s_idx[threadIdx.x])) {
      s_val[threadIdx.x] = s_val[threadIdx.x + half];
      s_idx[threadIdx.x] = s_idx[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int i = s_idx[0];
    out[0 * width + w] = static_cast<float>(i / n_bins);
    out[1 * width + w] = static_cast<float>(i % n_bins);
    out[2 * width + w] = __fsub_rn(__fmul_rn(0.5f, s_val[0]), gamma);
  }
}

}  // namespace

// hist: f32 (n_feat, n_bins, width, 3); feat_mask: f32 (width, n_feat);
// min_inst: f32 (1, 1); out: f32 (6, width). Returns a cudaError_t.
extern "C" int sml_split_scan(const void* hist, const void* feat_mask,
                              const void* min_inst, void* out, int n_feat,
                              int n_bins, int width, float lam, float gamma,
                              void* stream) {
  if (n_feat <= 0 || n_bins <= 0 || width <= 0 ||
      static_cast<int64_t>(n_feat) * n_bins >= (1LL << 31) / 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t node_bytes =
      sizeof(float) * 3 * static_cast<size_t>(n_feat) * n_bins;
  const float* h = static_cast<const float*>(hist);
  const float* fm = static_cast<const float*>(feat_mask);
  const float* mi = static_cast<const float*>(min_inst);
  float* o = static_cast<float*>(out);
  if (node_bytes <= kSharedBudget) {
    split_scan_kernel<true><<<width, kThreads, node_bytes, s>>>(
        h, fm, mi, o, n_feat, n_bins, width, lam, gamma);
  } else {
    split_scan_kernel<false><<<width, kThreads, 0, s>>>(
        h, fm, mi, o, n_feat, n_bins, width, lam, gamma);
  }
  return static_cast<int>(cudaGetLastError());
}
