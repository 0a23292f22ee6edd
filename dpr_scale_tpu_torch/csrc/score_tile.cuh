// One (128 corpus rows x 64 queries) fp32 inner-product score tile in shared
// memory: the common core of the MIPS sweep kernels (count_groups.cu,
// mips_scan.cu).  Each kernel walks its rows in ROWS-row tiles, calls
// score_tile() once per tile and reduces the tile in its own epilogue, so the
// (B, N) scores never reach device memory.
//
// bf16 inputs go through the tensor cores (wmma 16x16x16, fp32 accumulators);
// fp32 inputs through scalar fmaf on the CUDA cores, never TF32, so an fp32
// corpus scores as an fp32 matmul does.  Corpus and query slices of KC
// columns are staged through shared memory; no cp.async/TMA pipelining yet:
// loads and MMAs alternate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace mips_tile {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int ROWS = 128;  // corpus rows per tile (8 warps x 16 rows)
constexpr int QT = 64;     // queries per block
constexpr int KC = 64;     // embedding columns per shared-memory stage
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = QT + 4;  // fp32 score tile row stride

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int LD = KC + VEC;         // staged row stride, 16-byte aligned
  // staged corpus and query slices plus the score tile; a kernel's own
  // scratch follows at Smem::extra
  static size_t smem_bytes() {
    return (size_t)(ROWS + QT) * LD * sizeof(T) + (size_t)ROWS * LDS * 4;
  }
};

// The block's dynamic shared memory, carved as Tile<T>::smem_bytes() says.
template <typename T>
struct Smem {
  T* c;      // (ROWS, LD) corpus slice
  T* q;      // (QT, LD) query slice
  float* s;  // (ROWS, LDS) scores: s[r * LDS + j] = corpus row r . query j
  unsigned char* extra;
  __device__ explicit Smem(unsigned char* base)
      : c(reinterpret_cast<T*>(base)),
        q(c + ROWS * Tile<T>::LD),
        s(reinterpret_cast<float*>(q + QT * Tile<T>::LD)),
        extra(reinterpret_cast<unsigned char*>(s + ROWS * LDS)) {}
};

// 16-byte vector loads need D % VEC == 0 and 16-byte aligned base pointers.
template <typename T>
inline bool vectorizable(const void* q, const void* corpus, int D) {
  return D % Tile<T>::VEC == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)corpus % 16 == 0;
}

// rows [0, rows) x columns [d0, d0 + KC) of a row-major (*, D) matrix;
// rows >= valid and columns >= D are zero
template <typename T>
__device__ inline void stage(T* dst, const T* src, int valid, int rows, int D, int d0,
                             bool vec_ok) {
  constexpr int VEC = Tile<T>::VEC, LD = Tile<T>::LD;
  if (vec_ok) {
    constexpr int per_row = KC / VEC;
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int r = i / per_row, c = (i % per_row) * VEC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && d0 + c < D)
        val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + d0 + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * KC; i += THREADS) {
      const int r = i / KC, c = i % KC;
      T val = T(0.0f);
      if (r < valid && d0 + c < D) val = src[(size_t)r * D + d0 + c];
      dst[r * LD + c] = val;
    }
  }
}

// sm.s <- scores of corpus rows cbase[0, r_valid) against queries
// qbase[0, q_valid) (rows and queries past those edges score 0).  Called by
// every thread of the block; on return the tile is visible to all of them,
// and the previous tile's readers have passed a barrier before it is
// overwritten.
template <typename T>
__device__ inline void score_tile(const Smem<T>& sm, const T* cbase, const T* qbase,
                                  int r_valid, int q_valid, int D, bool vec_ok) {
  constexpr int LD = Tile<T>::LD;
  const int tid = threadIdx.x, warp = tid / 32;
  if constexpr (std::is_same<T, bf16>::value) {
    // warp w: rows [16w, 16w + 16) x all QT queries, 4 accumulator tiles
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[QT / 16];
    for (int j = 0; j < QT / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int d0 = 0; d0 < D; d0 += KC) {
      __syncthreads();
      stage(sm.c, cbase, r_valid, ROWS, D, d0, vec_ok);
      stage(sm.q, qbase, q_valid, QT, D, d0, vec_ok);
      __syncthreads();
      for (int kk = 0; kk < KC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sm.c + warp * 16 * LD + kk * 16, LD);
        for (int j = 0; j < QT / 16; ++j) {
          // queries row-major (QT, KC) are the column-major (KC, QT) B operand
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, sm.q + j * 16 * LD + kk * 16, LD);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    for (int j = 0; j < QT / 16; ++j)
      wmma::store_matrix_sync(sm.s + warp * 16 * LDS + j * 16, acc[j], LDS,
                              wmma::mem_row_major);
  } else {
    // thread: query tid % QT x rows tid / QT + 4i, 32 fp32 accumulators
    const int my_q = tid % QT, my_r0 = tid / QT;
    float acc[ROWS / 4];
    for (int i = 0; i < ROWS / 4; ++i) acc[i] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += KC) {
      __syncthreads();
      stage(sm.c, cbase, r_valid, ROWS, D, d0, vec_ok);
      stage(sm.q, qbase, q_valid, QT, D, d0, vec_ok);
      __syncthreads();
      for (int kk = 0; kk < KC; ++kk) {
        const float qv = sm.q[my_q * LD + kk];
        for (int i = 0; i < ROWS / 4; ++i)
          acc[i] = fmaf(sm.c[(my_r0 + 4 * i) * LD + kk], qv, acc[i]);
      }
    }
    for (int i = 0; i < ROWS / 4; ++i) sm.s[(my_r0 + 4 * i) * LDS + my_q] = acc[i];
  }
  __syncthreads();
}

}  // namespace mips_tile
