// Host binning of the tree fits and of scoring: each continuous feature's
// values searched against its quantile edges, threaded over blocks of rows.
//
// The port's counterpart of sml_tpu/native/binning.cc, the JAX package's
// C++ binning (a host kernel: it runs on the CPU of the machine that holds
// the card, before anything is staged). That one gives each thread whole
// features, packing each strided column first, and starts its threads on
// every call; this one gives each thread a block of rows (X read once, in
// order) and binning a serving batch starts none. Semantics are those of
// the NumPy
// version (sml_tpu_torch/ml/tree_impl.py `_bin_columns_plain`): for a
// finite value, the count of edges strictly below it (searchsorted
// 'left'); bin 0 for NaN and +-inf. Categorical slots are left 0 for the
// caller's remap. Built with g++ at first use by native/build.py; a build
// that fails raises, there is no NumPy fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Cells a worker thread takes at the least: below this many a call runs
// on the caller's thread alone (starting a thread costs more than binning
// a few requests). 8,192 was the fastest grain at 4,096 rows on the H100's
// host; scripts/torch_binning_grain.py builds the kernel under others.
#ifndef SML_BIN_CELLS_PER_WORKER
#define SML_BIN_CELLS_PER_WORKER (1 << 13)
#endif
constexpr int64_t kCellsPerWorker = SML_BIN_CELLS_PER_WORKER;

// The number of edges strictly below x (a lower bound over the short,
// ascending edge row, without data-dependent branches); 0 for NaN and
// +-inf.
inline int32_t count_below(const float* edges, int32_t n, double x) {
  if (!std::isfinite(x)) return 0;
  int32_t lo = 0;
  while (n > 0) {  // the answer lies in [lo, lo + n]
    const int32_t half = n >> 1;
    const bool below = static_cast<double>(edges[lo + half]) < x;
    lo = below ? lo + half + 1 : lo;
    n = below ? n - half - 1 : half;
  }
  return lo;
}

// Rows [r0, r1) of a row-major (n, F) matrix: every continuous feature
// of a row against its own edges (row f of an (F, max_edges) block).
template <typename T>
void bin_rows(const T* X, int64_t r0, int64_t r1, int32_t F,
              const float* edges, const int32_t* n_edges, int32_t max_edges,
              const uint8_t* is_categorical, int32_t* out) {
  for (int64_t i = r0; i < r1; ++i) {
    const T* row = X + i * F;
    int32_t* o = out + i * F;
    for (int32_t f = 0; f < F; ++f) {
      if (is_categorical[f]) continue;  // the caller remaps those
      o[f] = count_below(edges + static_cast<int64_t>(f) * max_edges,
                         n_edges[f], static_cast<double>(row[f]));
    }
  }
}

// Contiguous blocks of rows go to the workers, the first to the calling
// thread; X is read once, in order, whatever F is. Templated over the
// input type so that an f32 matrix is not widened whole.
template <typename T>
void bin_matrix_impl(const T* X, int64_t n, int32_t F, const float* edges,
                     const int32_t* n_edges, int32_t max_edges,
                     const uint8_t* is_categorical, int32_t* out) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw < 1) hw = 1;
  const int64_t by_work = n * F / kCellsPerWorker;
  const int64_t workers = std::max<int64_t>(1, std::min(hw, by_work));
  const int64_t step = (n + workers - 1) / workers;
  std::vector<std::thread> pool;
  pool.reserve(workers - 1);
  for (int64_t w = 1; w < workers; ++w) {
    const int64_t r0 = std::min(n, w * step), r1 = std::min(n, r0 + step);
    pool.emplace_back(bin_rows<T>, X, r0, r1, F, edges, n_edges, max_edges,
                      is_categorical, out);
  }
  bin_rows<T>(X, 0, std::min(n, step), F, edges, n_edges, max_edges,
              is_categorical, out);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// X: f64 (n, F); out: int32 (n, F), zero-filled by the caller.
void sml_bin_matrix(const double* X, int64_t n, int32_t F, const float* edges,
                    const int32_t* n_edges, int32_t max_edges,
                    const uint8_t* is_categorical, int32_t* out) {
  bin_matrix_impl<double>(X, n, F, edges, n_edges, max_edges, is_categorical,
                          out);
}

// X: f32 (n, F); as above.
void sml_bin_matrix_f32(const float* X, int64_t n, int32_t F,
                        const float* edges, const int32_t* n_edges,
                        int32_t max_edges, const uint8_t* is_categorical,
                        int32_t* out) {
  bin_matrix_impl<float>(X, n, F, edges, n_edges, max_edges, is_categorical,
                         out);
}

}  // extern "C"
