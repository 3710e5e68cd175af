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
// course widths, against three adds for each of a row's F cells, so it
// is bound by bytes. (This design adds a float64 scratch of
// chunks*F*B*S*24 bytes, written once and read once.) The Pallas body
// builds two one-hot tiles and contracts them on the MXU because that
// was the TPU's fast path; here that would be O(n*F*B) wasted work, so
// rows are added straight into their cells.
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
// warm-start contract), so there are no float atomics:
// - A block takes one chunk of rows and a tile of features x bins x
//   slots, held in shared memory. Each warp owns one feature's cells of
//   the tile outright and walks the chunk's rows in order, 32 at a time.
// - Lanes that hit the same (bin, slot) cell find each other with
//   __match_any_sync. The lowest lane of each group sums the group's
//   contributions in lane order and adds the result to the cell.
// - Each block writes its tile of its chunk's float64 partial histogram
//   to a scratch array (every cell, zeros included). A second kernel sums
//   the chunk partials of each cell in chunk order and rounds to f32.
// The order of every add depends only on the inputs and the plan (chunk
// rows and tiles), which the wrapper derives from the shapes alone.
//
// Shared memory. The tile is ft*bt*st*24 bytes plus 384 bytes of lane
// staging per warp. The wrapper sizes the tile to ~100 KB so that two
// blocks fit one SM, tiling over features first, then slots (one
// feature's B*S*24 bytes may not fit: 300 bins x 32 slots is 230 KB),
// then bins (above ~4,200 bins one slot of one feature does not fit).
// Above 48 KB the launch opts in with cudaFuncSetAttribute.
//
// Contract. Launches on the caller's stream, does not synchronise,
// allocates nothing (the wrapper allocates the output and the scratch).
// Returns the first CUDA error of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kReduceThreads = 256;

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

// AccT is the type of the sums: double in the port, float in the
// f32-accumulating build that is only timed.
template <typename BinT, typename AccT>
__global__ void hist_partial_kernel(const BinT* __restrict__ binned,
                                    const int32_t* __restrict__ lid,
                                    const float* __restrict__ grad,
                                    const float* __restrict__ hess,
                                    const float* __restrict__ weight,
                                    AccT* __restrict__ partial, int n,
                                    int n_feat, int n_bins, int n_slots,
                                    int chunk_rows, int ft, int bt, int st,
                                    int n_stiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_cells = ft * bt * st * 3;
  AccT* hist = reinterpret_cast<AccT*>(smem);            // [ft][bt][st][3]
  float* stage = reinterpret_cast<float*>(hist + tile_cells);  // [ft][32][3]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int f0 = blockIdx.y * ft;
  const int b0 = (blockIdx.z / n_stiles) * bt;
  const int s0 = (blockIdx.z % n_stiles) * st;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk_rows;
  const int64_t end = begin + chunk_rows < n ? begin + chunk_rows
                                             : static_cast<int64_t>(n);

  for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) {
    hist[i] = AccT(0);
  }
  __syncthreads();

  const int f = f0 + warp;
  if (f < n_feat) {
    AccT* own = hist + warp * bt * st * 3;
    float* stg = stage + warp * kWarp * 3;
    const int b_hi = min(bt, n_bins - b0);   // bins of this tile
    const int s_hi = min(st, n_slots - s0);  // slots of this tile
    for (int64_t r0 = begin; r0 < end; r0 += kWarp) {
      const int64_t r = r0 + lane;
      int key = -1;
      float gw = 0.0f, hw = 0.0f, w = 0.0f;
      if (r < end) {
        w = weight[r];
        const int s = lid[r] - s0;
        const int b = static_cast<int>(binned[r * n_feat + f]) - b0;
        if (w > 0.0f && s >= 0 && s < s_hi && b >= 0 && b < b_hi) {
          key = b * st + s;
          gw = __fmul_rn(grad[r], w);
          hw = __fmul_rn(hess[r], w);
        }
      }
      const unsigned group = __match_any_sync(0xffffffffu, key);
      stg[lane * 3 + 0] = gw;
      stg[lane * 3 + 1] = hw;
      stg[lane * 3 + 2] = w;
      __syncwarp();
      if (key >= 0 && lane == __ffs(group) - 1) {
        AccT a0 = gw, a1 = hw, a2 = w;
        unsigned rest = group & (group - 1);  // the group without its leader
        while (rest) {
          const int l = __ffs(rest) - 1;
          rest &= rest - 1;
          a0 = add_rn(a0, AccT(stg[l * 3 + 0]));
          a1 = add_rn(a1, AccT(stg[l * 3 + 1]));
          a2 = add_rn(a2, AccT(stg[l * 3 + 2]));
        }
        AccT* cell = own + key * 3;
        cell[0] = add_rn(cell[0], a0);
        cell[1] = add_rn(cell[1], a1);
        cell[2] = add_rn(cell[2], a2);
      }
      __syncwarp();  // the staging slots are rewritten next round
    }
  }
  __syncthreads();

  const int64_t n_cells = static_cast<int64_t>(n_feat) * n_bins * n_slots * 3;
  AccT* dst = partial + static_cast<int64_t>(blockIdx.x) * n_cells;
  for (int i = threadIdx.x; i < tile_cells; i += blockDim.x) {
    const int k = i % 3;
    int rest = i / 3;
    const int s = rest % st;
    rest /= st;
    const int b = rest % bt;
    const int fi = rest / bt;
    const int gf = f0 + fi, gb = b0 + b, gs = s0 + s;
    if (gf < n_feat && gb < n_bins && gs < n_slots) {
      dst[((static_cast<int64_t>(gf) * n_bins + gb) * n_slots + gs) * 3 + k] =
          hist[i];
    }
  }
}

template <typename AccT>
__global__ void hist_reduce_kernel(const AccT* __restrict__ partial,
                                   float* __restrict__ out, int64_t n_cells,
                                   int n_chunks) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  AccT acc = partial[i];
  for (int c = 1; c < n_chunks; ++c) {
    acc = add_rn(acc, partial[static_cast<int64_t>(c) * n_cells + i]);
  }
  out[i] = to_f32(acc);
}

template <typename BinT, typename AccT>
cudaError_t launch(const void* binned, const void* lid, const void* grad,
                   const void* hess, const void* weight, void* partial,
                   void* out, int n, int n_feat, int n_bins, int n_slots,
                   int chunk_rows, int n_chunks, int ft, int bt, int st,
                   cudaStream_t stream) {
  const int n_ftiles = (n_feat + ft - 1) / ft;
  const int n_btiles = (n_bins + bt - 1) / bt;
  const int n_stiles = (n_slots + st - 1) / st;
  if (n_ftiles > 65535 || static_cast<int64_t>(n_btiles) * n_stiles > 65535) {
    return cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(AccT) * 3 * static_cast<size_t>(ft) * bt * st +
                      sizeof(float) * 3 * ft * kWarp;
  auto kernel = hist_partial_kernel<BinT, AccT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_chunks, n_ftiles, n_btiles * n_stiles);
  kernel<<<grid, ft * kWarp, smem, stream>>>(
      static_cast<const BinT*>(binned), static_cast<const int32_t*>(lid),
      static_cast<const float*>(grad), static_cast<const float*>(hess),
      static_cast<const float*>(weight), static_cast<AccT*>(partial), n,
      n_feat, n_bins, n_slots, chunk_rows, ft, bt, st, n_stiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_cells = static_cast<int64_t>(n_feat) * n_bins * n_slots * 3;
  const int64_t blocks = (n_cells + kReduceThreads - 1) / kReduceThreads;
  hist_reduce_kernel<AccT><<<static_cast<unsigned>(blocks), kReduceThreads,
                             0, stream>>>(static_cast<const AccT*>(partial),
                                          static_cast<float*>(out), n_cells,
                                          n_chunks);
  return cudaGetLastError();
}

template <typename AccT>
int dispatch(int bin_bytes, const void* binned, const void* lid,
             const void* grad, const void* hess, const void* weight,
             void* partial, void* out, int n, int n_feat, int n_bins,
             int n_slots, int chunk_rows, int n_chunks, int ft, int bt,
             int st, void* stream) {
  if (n <= 0 || n_feat <= 0 || n_bins <= 0 || n_slots <= 0 ||
      chunk_rows <= 0 || n_chunks <= 0 || ft <= 0 || ft > 32 || bt <= 0 ||
      st <= 0 ||
      static_cast<int64_t>(chunk_rows) * n_chunks < static_cast<int64_t>(n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bin_bytes) {
    case 1:
      return static_cast<int>(launch<uint8_t, AccT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, chunk_rows, n_chunks, ft, bt, st, s));
    case 2:
      return static_cast<int>(launch<uint16_t, AccT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, chunk_rows, n_chunks, ft, bt, st, s));
    case 4:
      return static_cast<int>(launch<int32_t, AccT>(
          binned, lid, grad, hess, weight, partial, out, n, n_feat, n_bins,
          n_slots, chunk_rows, n_chunks, ft, bt, st, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bin_bytes: 1 = uint8, 2 = uint16, 4 = int32 bin matrix (n, n_feat),
// row-major. lid: int32 (n,); grad, hess, weight: f32 (n,). out: f32
// (n_feat*n_bins, n_slots*3). partial: float64 (n_chunks, n_feat*n_bins*
// n_slots*3) scratch. Rows [c*chunk_rows,
// (c+1)*chunk_rows) form chunk c; tiles are ft features x bt bins x st
// slots. Returns a cudaError_t.
extern "C" int sml_hist_accumulate(int bin_bytes, const void* binned,
                                   const void* lid, const void* grad,
                                   const void* hess, const void* weight,
                                   void* partial, void* out, int n,
                                   int n_feat, int n_bins, int n_slots,
                                   int chunk_rows, int n_chunks, int ft,
                                   int bt, int st, void* stream) {
  return dispatch<double>(bin_bytes, binned, lid, grad, hess, weight,
                          partial, out, n, n_feat, n_bins, n_slots,
                          chunk_rows, n_chunks, ft, bt, st, stream);
}

// The same with f32 sums and an f32 `partial` scratch: a measurement
// build, to price the float64 sums above. Not called by the port.
extern "C" int sml_hist_accumulate_f32acc(
    int bin_bytes, const void* binned, const void* lid, const void* grad,
    const void* hess, const void* weight, void* partial, void* out, int n,
    int n_feat, int n_bins, int n_slots, int chunk_rows, int n_chunks,
    int ft, int bt, int st, void* stream) {
  return dispatch<float>(bin_bytes, binned, lid, grad, hess, weight, partial,
                         out, n, n_feat, n_bins, n_slots, chunk_rows,
                         n_chunks, ft, bt, st, stream);
}
