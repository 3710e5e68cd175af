// Per-level best split of every node from its post-merge histogram.
//
// Replaces the TPU kernel `split_scan` in sml_tpu/native/hist_kernel.py
// (the Pallas body at :225, launched at :259). It computes the same
// function: for each node w, prefix sums GL, HL, WL over the bins of each
// feature, the second-order gain
//   GL^2/((HL+lam)+1e-12) + (G-GL)^2/(((H-HL)+lam)+1e-12)
//     - G^2/((H+lam)+1e-12)
// with G, H, W each feature's OWN totals, the candidate masks (WL >= mi,
// W-WL >= mi with mi the node's own minimum, not the last bin, feature
// allowed for the node), and the
// argmax over the flat index f*B + b, emitting a (6, W) f32 pack
//   [best feature, best bin, 0.5*best - gamma, G, H, W of feature 0].
// The Pallas kernel takes one (1, 1) minimum; the JAX package's grid-fused
// fit vmaps it over its trials, each with its own. Here the nodes of every
// element of a fused fit share one launch, so each node carries its own
// minimum (a sequential fit passes the same value for every node).
//
// The argmax follows jnp.argmax: the lowest flat index wins a tie, a NaN
// counts as larger than any number and the first NaN wins, and a node
// whose candidates are all masked to -inf gets index 0 (its bin is still
// written: the builder stores it in split_bin even when the node does not
// split). That rule is a strict total order on (value, index), so the best
// candidate does not depend on the order in which candidates are compared.
//
// Numerics. The prefix at bin b is the sequential f32 sum from 0 over
// bins 0..b, and every operation is rounded on its own (__fadd_rn and
// friends, no FMA), in the association written above, so the kernel
// equals its plain PyTorch version bit for bit.
//
// What bounds it on an H100. Its input is the level's histogram (F*B*W*12
// bytes, a few hundred KB at most on the course widths) and it writes
// 24*W bytes: it is bound by latency, not by bytes or flops. Design:
// - one block per node, one warp per feature (features warp, warp +
//   n_warps, ... when F passes the block's warps);
// - the warp copies a segment of its feature's bins (all of them when they
//   fit: `seg` bins of 12 bytes, from the launch plan) into its own slice of
//   shared memory, with the lanes over the bins;
// - lanes 0, 1 and 2 run the sequential prefix of G, H and W over the
//   segment in place, carrying the running sum into the next segment;
// - the lanes then score the segment's bins in parallel (the three
//   divisions of a bin on one lane), keep their best under the argmax rule,
//   and a warp-shuffle reduction and one pass over the warps' bests in
//   warp order give the node's best.
// A feature of more than `seg` bins is read twice: a first pass of the
// same sequential sums gives its totals (bit-equal to the last prefix),
// the second scores.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;

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

// Copies bins [b0, b0 + cnt) of feature f of node w into s[b][3] (lanes
// over the values), then lanes 0-2 replace stat k with its running sum,
// starting from carry (the sum over bins before b0). Returns the lane's
// carry after the segment (lanes 0-2 only).
__device__ __forceinline__ float stage_and_scan(
    const float* __restrict__ hist, float* s, int f, int n_bins, int width,
    int w, int b0, int cnt, int lane, float carry) {
  const int64_t col = static_cast<int64_t>(width) * 3;  // stride of one bin
  const float* src = hist + (static_cast<int64_t>(f) * n_bins + b0) * col +
                     static_cast<int64_t>(w) * 3;
  for (int i = lane; i < cnt * 3; i += kWarp) {
    s[i] = src[(i / 3) * col + i % 3];
  }
  __syncwarp();
  if (lane < 3) {
    float acc = carry;
    int b = 0;
    for (; b + 8 <= cnt; b += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = s[(b + j) * 3 + lane];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc = __fadd_rn(acc, v[j]);
        s[(b + j) * 3 + lane] = acc;
      }
    }
    for (; b < cnt; ++b) {
      acc = __fadd_rn(acc, s[b * 3 + lane]);
      s[b * 3 + lane] = acc;
    }
    carry = acc;
  }
  __syncwarp();
  return carry;
}

__global__ void split_scan_kernel(const float* __restrict__ hist,
                                  const float* __restrict__ feat_mask,
                                  const float* __restrict__ min_inst,
                                  float* __restrict__ out, int n_feat,
                                  int n_bins, int width, int seg, float lam,
                                  float gamma) {
  extern __shared__ __align__(16) float smem[];  // [warps][seg][3]
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_idx[kMaxWarps];
  const int w = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  float* s = smem + static_cast<int64_t>(warp) * seg * 3;
  const float mi = min_inst[w];

  float best = 0.0f;
  int best_i = -1;
  for (int f = warp; f < n_feat; f += n_warps) {
    // the feature's totals: the sequential sums over all its bins, which
    // the prefix at the last bin equals bit for bit
    float tot = 0.0f;
    if (n_bins > seg) {
      for (int b0 = 0; b0 < n_bins; b0 += seg) {
        tot = stage_and_scan(hist, s, f, n_bins, width, w, b0,
                             min(seg, n_bins - b0), lane, tot);
      }
    }
    const bool allowed =
        feat_mask[static_cast<int64_t>(w) * n_feat + f] > 0.0f;
    float carry = 0.0f, G = 0.0f, H = 0.0f, Wt = 0.0f, parent = 0.0f;
    for (int b0 = 0; b0 < n_bins; b0 += seg) {
      const int cnt = min(seg, n_bins - b0);
      carry = stage_and_scan(hist, s, f, n_bins, width, w, b0, cnt, lane,
                             carry);
      if (b0 == 0) {
        // lanes 0-2 hold the totals (last segment's carry or this one's)
        const float t = n_bins > seg ? tot : carry;
        G = __shfl_sync(0xffffffffu, t, 0);
        H = __shfl_sync(0xffffffffu, t, 1);
        Wt = __shfl_sync(0xffffffffu, t, 2);
        parent = gain_term(G, H, lam);
        if (f == 0 && lane == 0) {
          out[3 * width + w] = G;
          out[4 * width + w] = H;
          out[5 * width + w] = Wt;
        }
      }
      for (int j = lane; j < cnt; j += kWarp) {
        const int b = b0 + j;
        const float GL = s[j * 3 + 0], HL = s[j * 3 + 1], WL = s[j * 3 + 2];
        const bool ok = WL >= mi && __fsub_rn(Wt, WL) >= mi &&
                        b < n_bins - 1 && allowed;
        float sc = -INFINITY;
        if (ok) {
          sc = __fsub_rn(
              __fadd_rn(gain_term(GL, HL, lam),
                        gain_term(__fsub_rn(G, GL), __fsub_rn(H, HL), lam)),
              parent);
        }
        const int idx = f * n_bins + b;
        if (beats(sc, idx, best, best_i)) {
          best = sc;
          best_i = idx;
        }
      }
      __syncwarp();  // the segment is rewritten next round
    }
  }

  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float v = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, best_i, off);
    if (beats(v, i, best, best_i)) {
      best = v;
      best_i = i;
    }
  }
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = s_val[0];
    int i = s_idx[0];
    for (int k = 1; k < n_warps; ++k) {
      if (beats(s_val[k], s_idx[k], v, i)) {
        v = s_val[k];
        i = s_idx[k];
      }
    }
    out[0 * width + w] = static_cast<float>(i / n_bins);
    out[1 * width + w] = static_cast<float>(i % n_bins);
    out[2 * width + w] = __fsub_rn(__fmul_rn(0.5f, v), gamma);
  }
}

}  // namespace

// hist: f32 (n_feat, n_bins, width, 3); feat_mask: f32 (width, n_feat);
// min_inst: f32 (width,), each node's least child weight; out: f32
// (6, width). One block of n_warps warps
// per node; each warp stages `seg` bins at a time (seg*n_warps*12 bytes of
// dynamic shared memory, at most 47 KB: with the static 256 bytes the
// block stays within 48 KB without opting in). Returns a cudaError_t.
extern "C" int sml_split_scan(const void* hist, const void* feat_mask,
                              const void* min_inst, void* out, int n_feat,
                              int n_bins, int width, int n_warps, int seg,
                              float lam, float gamma, void* stream) {
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(seg) * n_warps;
  if (n_feat <= 0 || n_bins <= 0 || width <= 0 || n_warps <= 0 ||
      n_warps > kMaxWarps || seg <= 0 || smem > 47 * 1024 ||
      static_cast<int64_t>(n_feat) * n_bins >= (1LL << 31) / 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_scan_kernel<<<width, n_warps * kWarp, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hist), static_cast<const float*>(feat_mask),
      static_cast<const float*>(min_inst), static_cast<float*>(out), n_feat,
      n_bins, width, seg, lam, gamma);
  return static_cast<int>(cudaGetLastError());
}
