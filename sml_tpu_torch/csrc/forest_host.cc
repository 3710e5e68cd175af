// Host traversal of a stacked binned tree ensemble: the dispatcher's host
// route for scoring (the serving queue's overflow, the canary's mirror,
// sml.dispatch.mode=host), threaded over blocks of rows.
//
// The JAX package's host route traverses with XLA on its host mesh
// (sml_tpu/ml/tree_impl.py predict_forest). This one computes the port's
// plain version's function (sml_tpu_torch/native/traverse_kernel.py
// forest_margin_plain), which the card's kernel equals bit for bit, so a
// response's bits do not depend on its route:
// - per tree, in tree order, acc = acc + w[t] * lv[t][leaf], the product
//   and the sum each rounded to f32 (no contraction into a fused
//   multiply-add: the pragma below, and -ffp-contract=off in
//   native/build.py's g++ flags);
// - a row descends `depth` levels from the root, right where its bin is
//   greater than the split bin; at a leaf (a negative feature id) it
//   stays;
// - a feature id at or past the row's width reads bin 0;
// - bins are uint8, uint16 or int32; the sum starts at `init` (a value a
//   row, or one number for every row).
// Built with g++ at first use by native/build.py; a build that fails
// raises. ctypes releases the GIL for the call.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Row-tree-levels a worker thread takes at the least: below this a call
// runs on the caller's thread alone (a serving request of 64 rows against
// 40 trees of depth 6 is 15,360 of them).
constexpr int64_t kStepsPerWorker = 1 << 18;

struct Forest {
  const int32_t* sf;  // (T, N) feature ids, negative at a leaf
  const int32_t* sb;  // (T, N) split bins
  const float* lv;    // (T, N) node values
  const float* w;     // (T,) tree weights
  int32_t T, N, depth;
};

template <typename B>
void traverse_rows(const B* X, int64_t r0, int64_t r1, int32_t F,
                   const Forest& fo, const float* init_rows,
                   float init_value, float* out) {
  for (int64_t i = r0; i < r1; ++i) {
    const B* row = X + i * F;
    float acc = init_rows ? init_rows[i] : init_value;
    for (int32_t t = 0; t < fo.T; ++t) {
      const int64_t base = static_cast<int64_t>(t) * fo.N;
      const int32_t* sf = fo.sf + base;
      const int32_t* sb = fo.sb + base;
      int64_t node = 0;
      for (int32_t d = 0; d < fo.depth; ++d) {
        const int32_t f = sf[node];
        if (f < 0) break;  // a leaf: the row stays for the levels left
        const int64_t bin = f < F ? static_cast<int64_t>(row[f]) : 0;
        node = 2 * node + 1 + (bin > static_cast<int64_t>(sb[node]) ? 1 : 0);
      }
      const float contrib = fo.w[t] * fo.lv[base + node];
      acc = acc + contrib;
    }
    out[i] = acc;
  }
}

template <typename B>
void traverse_impl(const B* X, int64_t n, int32_t F, const Forest& fo,
                   const float* init_rows, float init_value, float* out) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw < 1) hw = 1;
  const int64_t steps = n * std::max<int64_t>(fo.T, 1) *
                        std::max<int64_t>(fo.depth, 1);
  const int64_t workers =
      std::max<int64_t>(1, std::min(hw, steps / kStepsPerWorker));
  const int64_t step = (n + workers - 1) / workers;
  std::vector<std::thread> pool;
  pool.reserve(workers - 1);
  for (int64_t k = 1; k < workers; ++k) {
    const int64_t r0 = std::min(n, k * step), r1 = std::min(n, r0 + step);
    pool.emplace_back(traverse_rows<B>, X, r0, r1, F, std::cref(fo),
                      init_rows, init_value, out);
  }
  traverse_rows<B>(X, 0, std::min(n, step), F, fo, init_rows, init_value,
                   out);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// bin_bytes: 1 (uint8), 2 (uint16) or 4 (int32) bins in X, row-major
// (n, F). init_rows: n f32 start values, or null for init_value in every
// row. out: n f32. Returns 0, or 1 for an unknown bin width.
int sml_forest_host(int32_t bin_bytes, const void* X, int64_t n, int32_t F,
                    const int32_t* sf, const int32_t* sb, const float* lv,
                    const float* w, int32_t T, int32_t N, int32_t depth,
                    const float* init_rows, float init_value, float* out) {
  const Forest fo{sf, sb, lv, w, T, N, depth};
  switch (bin_bytes) {
    case 1:
      traverse_impl(static_cast<const uint8_t*>(X), n, F, fo, init_rows,
                    init_value, out);
      return 0;
    case 2:
      traverse_impl(static_cast<const uint16_t*>(X), n, F, fo, init_rows,
                    init_value, out);
      return 0;
    case 4:
      traverse_impl(static_cast<const int32_t*>(X), n, F, fo, init_rows,
                    init_value, out);
      return 0;
    default:
      return 1;
  }
}

}  // extern "C"
