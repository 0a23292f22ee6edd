// nvcuda::wmma on the host (cuda_emu.h), for score_tile.cuh's bf16 tiles:
// every lane of a warp holds the whole 16 x 16 fragment (row-major in
// x[num_elements], so two accumulators add element by element as on the
// card) and computes the whole product (fp32 sums of exact bf16 products);
// lane 0 stores it.
#pragma once

#include "cuda_emu.h"

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
struct col_major {};
enum layout_t { mem_row_major, mem_col_major };

template <typename Use, int M, int N, int K, typename T, typename Layout = void>
struct fragment {
  static constexpr int num_elements = 256;
  float x[num_elements];  // (row, column) of the fragment's matrix at row * 16 + column
};

template <typename Use, typename T, typename Layout>
inline void load_matrix_sync(fragment<Use, 16, 16, 16, T, Layout>& f, const __nv_bfloat16* p,
                             unsigned ld) {
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c)
      f.x[r * 16 + c] = __bfloat162float(std::is_same<Layout, col_major>::value ? p[c * ld + r]
                                                                                : p[r * ld + c]);
}

inline void fill_fragment(fragment<accumulator, 16, 16, 16, float>& f, float v) {
  for (float& e : f.x) e = v;
}

template <typename LA, typename LB>
inline void mma_sync(fragment<accumulator, 16, 16, 16, float>& d,
                     const fragment<matrix_a, 16, 16, 16, __nv_bfloat16, LA>& a,
                     const fragment<matrix_b, 16, 16, 16, __nv_bfloat16, LB>& b,
                     const fragment<accumulator, 16, 16, 16, float>& c) {
  fragment<accumulator, 16, 16, 16, float> out;
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 16; ++n) {
      double acc = 0.0;
      for (int k = 0; k < 16; ++k) acc += (double)a.x[r * 16 + k] * b.x[k * 16 + n];
      out.x[r * 16 + n] = c.x[r * 16 + n] + (float)acc;
    }
  d = out;
}

inline void store_matrix_sync(float* p, const fragment<accumulator, 16, 16, 16, float>& f,
                              unsigned ld, layout_t) {
  if (emu_lane() == 0)
    for (int r = 0; r < 16; ++r)
      for (int c = 0; c < 16; ++c) p[r * ld + c] = f.x[r * 16 + c];
  __syncwarp();
}

}  // namespace wmma
}  // namespace nvcuda
