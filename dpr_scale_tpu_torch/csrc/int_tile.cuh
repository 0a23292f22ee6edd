// One (128 corpus rows x 64 queries) int32 inner-product tile in shared
// memory, per query plane: the common core of the integer MIPS sweeps
// (int_scan.cu).  Each kernel walks its rows in ROWS-row tiles, calls
// score_tile() once per tile and reduces the tile in its own epilogue, so the
// (B, N) scores never reach device memory.  The integer counterpart of
// score_tile.cuh, kept apart so that the float kernels keep their bits.
//
// int8 x int8 -> int32 on the tensor cores with mma.sync m16n8k32 (the
// wrapper is in hopper_ptx.cuh): exact, so
// the tile equals any other order of the same integer sums.  The corpus is
// int8 (N, D) or, PACKED, int4 nibbles (N, D / 2) in the column-block layout
// (byte j holds dim j in its low nibble, dim j + D / 2 in its high one).  A
// packed stage loads a (ROWS x KC) byte slice once and sign-extends it in
// shared memory into a low and a high tile; the low tile meets query columns
// [c0, c0 + KC), the high tile [D / 2 + c0, ...): two MMAs per packed load,
// one read of the packed bytes.  Each block holds QT queries of each of its
// PLANES query planes (two accumulator sets), so the planes of a query meet
// in one epilogue.  No cp.async/TMA pipelining yet: loads and MMAs alternate.
#pragma once

#include "gmax_sweep.cuh"  // unpack4; hopper_ptx.cuh's mma.sync m16n8k32 s8, first

#include <cuda_runtime.h>
#include <stdint.h>

namespace int_tile {

using gmax_sweep::unpack4;

constexpr int ROWS = 128;   // corpus rows per tile (8 warps x 16 rows)
constexpr int QT = 64;      // queries per block, each plane
constexpr int KC = 64;      // bytes of a row per shared-memory stage (two k32 steps)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LD = KC + 16;  // staged row stride in bytes: 16-byte aligned; the
                             // fragment loads of 8 rows x 4 words hit 32 banks
constexpr int LDS = QT + 4;  // int32 score tile row stride
constexpr int NT = QT / 8;   // n8 MMA tiles across the queries

template <bool PACKED, int PLANES>
struct Tile {
  static constexpr int NSUB = PACKED ? 2 : 1;  // corpus tiles per stage
  // staged corpus tiles, staged query tiles and the score tiles; a kernel's
  // own scratch follows at Smem::extra
  static constexpr size_t smem_bytes() {
    return (size_t)NSUB * ROWS * LD + (size_t)PLANES * NSUB * QT * LD +
           (size_t)PLANES * ROWS * LDS * 4;
  }
};

// The block's dynamic shared memory, carved as Tile::smem_bytes() says.
template <bool PACKED, int PLANES>
struct Smem {
  int8_t* a;  // (NSUB, ROWS, LD) corpus tiles: low, then high nibbles
  int8_t* q;  // (PLANES, NSUB, QT, LD) query tiles
  int* s;     // (PLANES, ROWS, LDS): s[(p * ROWS + r) * LDS + j] = row r . query j, plane p
  unsigned char* extra;
  __device__ explicit Smem(unsigned char* base)
      : a(reinterpret_cast<int8_t*>(base)),
        q(a + Tile<PACKED, PLANES>::NSUB * ROWS * LD),
        s(reinterpret_cast<int*>(q + PLANES * Tile<PACKED, PLANES>::NSUB * QT * LD)),
        extra(reinterpret_cast<unsigned char*>(s + PLANES * ROWS * LDS)) {}
};

// What a sweep reads: queries q (PLANES * B, D), plane p of query b at row
// p * B + b; corpus rows of W = D (int8) or D / 2 (packed) bytes.
struct Operands {
  const int8_t* q;
  const int8_t* corpus;
  int B, D, W;
  bool vec_ok;  // 16-byte loads: W, D % 16 == 0 and 16-byte aligned bases
};

inline bool vectorizable(const void* q, const void* corpus, int D, int W) {
  return W % 16 == 0 && D % 16 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)corpus % 16 == 0;
}

// dst[r * LD + c] = src[r * stride + col0 + c] for r < valid and col0 + c <
// ncols, else 0; rows [0, rows), columns [0, KC)
__device__ inline void stage(int8_t* dst, const int8_t* src, int valid, int rows, long long stride,
                             int col0, int ncols, bool vec_ok) {
  if (vec_ok) {
    constexpr int per_row = KC / 16;
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int r = i / per_row, c = (i % per_row) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && col0 + c < ncols)
        v = *reinterpret_cast<const uint4*>(src + r * stride + col0 + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * KC; i += THREADS) {
      const int r = i / KC, c = i % KC;
      dst[r * LD + c] = (r < valid && col0 + c < ncols) ? src[r * stride + col0 + c] : 0;
    }
  }
}

// the packed slice [col0, col0 + KC) of rows [0, ROWS) into the low tile lo
// and the high tile hi; bytes past valid rows or W columns are 0 (both
// nibbles 0)
__device__ inline void stage_unpack(int8_t* lo, int8_t* hi, const int8_t* src, int valid, int W,
                                    int col0, bool vec_ok) {
  if (vec_ok) {
    constexpr int per_row = KC / 16;
    for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
      const int r = i / per_row, c = (i % per_row) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && col0 + c < W)
        v = *reinterpret_cast<const uint4*>(src + (long long)r * W + col0 + c);
      uint4 l, h;
      unpack4(v.x, l.x, h.x);
      unpack4(v.y, l.y, h.y);
      unpack4(v.z, l.z, h.z);
      unpack4(v.w, l.w, h.w);
      *reinterpret_cast<uint4*>(lo + r * LD + c) = l;
      *reinterpret_cast<uint4*>(hi + r * LD + c) = h;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * KC; i += THREADS) {
      const int r = i / KC, c = i % KC;
      const int p = (r < valid && col0 + c < W) ? (int)src[(long long)r * W + col0 + c] : 0;
      lo[r * LD + c] = (int8_t)(((p & 0xF) ^ 8) - 8);
      hi[r * LD + c] = (int8_t)(p >> 4);
    }
  }
}

__device__ inline uint32_t ld32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// sm.s <- the integer dots of corpus rows [rbase, rbase + r_valid) with
// queries [q0, q0 + q_valid) of each plane (rows and queries past those
// edges score 0).  Called by every thread of the block; on return the tile is
// visible to all of them, and the previous tile's readers have passed a
// barrier before it is overwritten.
template <bool PACKED, int PLANES>
__device__ inline void score_tile(const Smem<PACKED, PLANES>& sm, const Operands& op,
                                  long long rbase, int r_valid, int q0, int q_valid) {
  constexpr int NSUB = Tile<PACKED, PLANES>::NSUB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;  // the MMA fragments' group and thread
  int acc[PLANES][NT][4];
  for (int p = 0; p < PLANES; ++p)
    for (int j = 0; j < NT; ++j)
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0;
  const int8_t* crow = op.corpus + rbase * op.W;
  for (int c0 = 0; c0 < op.W; c0 += KC) {
    __syncthreads();
    if constexpr (PACKED)
      stage_unpack(sm.a, sm.a + ROWS * LD, crow, r_valid, op.W, c0, op.vec_ok);
    else
      stage(sm.a, crow, r_valid, ROWS, op.W, c0, op.W, op.vec_ok);
    for (int p = 0; p < PLANES; ++p)
      for (int s = 0; s < NSUB; ++s)  // query columns [s * W + c0, ...), valid below (s + 1) * W
        stage(sm.q + (p * NSUB + s) * QT * LD, op.q + ((long long)p * op.B + q0) * op.D + s * op.W,
              q_valid, QT, op.D, c0, op.W, op.vec_ok);
    __syncthreads();
    for (int s = 0; s < NSUB; ++s) {
      const int8_t* a_base = sm.a + s * ROWS * LD + (warp * 16 + g) * LD + t * 4;
      for (int kk = 0; kk < KC; kk += 32) {
        const uint32_t a[4] = {ld32(a_base + kk), ld32(a_base + 8 * LD + kk),
                               ld32(a_base + kk + 16), ld32(a_base + 8 * LD + kk + 16)};
        for (int p = 0; p < PLANES; ++p) {
          const int8_t* b_base = sm.q + (p * NSUB + s) * QT * LD + g * LD + t * 4 + kk;
          for (int j = 0; j < NT; ++j)
            dst_hopper::mma_s8_m16n8k32(acc[p][j], a, ld32(b_base + j * 8 * LD),
                                        ld32(b_base + j * 8 * LD + 16));
        }
      }
    }
  }
  // fragment (row g / g + 8, query columns 2t, 2t + 1) of each n8 tile
  for (int p = 0; p < PLANES; ++p) {
    int* s0 = sm.s + (p * ROWS + warp * 16 + g) * LDS + 2 * t;
    for (int j = 0; j < NT; ++j) {
      s0[j * 8] = acc[p][j][0];
      s0[j * 8 + 1] = acc[p][j][1];
      s0[8 * LDS + j * 8] = acc[p][j][2];
      s0[8 * LDS + j * 8 + 1] = acc[p][j][3];
    }
  }
  __syncthreads();
}

}  // namespace int_tile
