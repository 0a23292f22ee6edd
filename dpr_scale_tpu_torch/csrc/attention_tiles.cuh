// Register-resident tile operations of the attention kernels
// (attention_fwd.cu, attention_bwd.cu), on the instructions of
// attention_ptx.cuh.
//
// A block has 4 warps and works on TILE = 64 rows of one (sequence, head);
// each warp owns 16 of them.  The other operand streams through shared memory
// in 64-row tiles, two buffers deep: the next tile's cp.async copies are in
// flight while the warps multiply the current one.  Products run on
// mma.sync m16n8k16; for lane = 4 gid + tig the fragments hold
//
//   A (16 x 16 bf16): a0 = (row gid, cols 2 tig, +1), a1 = (row gid + 8, same
//                     cols), a2 = (row gid, cols 2 tig + 8, +9), a3 = (row
//                     gid + 8, cols 2 tig + 8, +9)
//   B (16 x 8 bf16):  b0 = (rows 2 tig, +1, col gid), b1 = (rows 2 tig + 8,
//                     +9, col gid)
//   C (16 x 8 fp32):  c0, c1 = (row gid, cols 2 tig, +1), c2, c3 = (row
//                     gid + 8, cols 2 tig, +1)
//
// so two C tiles side by side, rounded to bf16 and packed in pairs, are the A
// fragment of the next product (a_fragment()): probabilities and score
// gradients never leave registers.  Each thread owns two rows of its warp's
// 16 (gid and gid + 8); a row's four owners are one quad of lanes, so row
// reductions are two xor shuffles.
//
// The tile operations take the head dim hd at run time (a multiple of 16, at
// most HDT, the compile-time width that sizes the register arrays); k-steps
// and output columns past hd are skipped, and shared-memory columns past hd
// are never read.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_ptx.cuh"

namespace dst_attn {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 64;  // rows per block and per streamed tile
constexpr int PAD = 8;    // bf16 row padding: a row is 16 * odd bytes past a
                          // multiple of 128, so ldmatrix's 8 rows hit 8
                          // distinct 16-byte bank groups
constexpr int MAX_L = 512;
constexpr int MAX_HD = 128;

__host__ __device__ inline int n_tiles(int L) { return (L + TILE - 1) / TILE; }

// rows [r0, r0 + TILE) of a row-major (L, hd) bf16 matrix into a (TILE, ld)
// shared-memory tile, asynchronously; rows >= L become zeros
__device__ inline void load_tile(bf16* dst, int ld, const bf16* src, int r0, int L, int hd) {
  const int vec = hd / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < TILE * vec; i += THREADS) {
    const int r = i / vec, c = (i % vec) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * ld + c, src + (size_t)(ok ? r0 + r : 0) * hd + c, ok);
  }
}

// A fragments of tile rows [row0, row0 + 16) over the hd columns, one per
// 16-column k-step
template <int HDT>
__device__ inline void load_a(uint32_t (&a)[HDT / 16][4], const bf16* tile, int ld, int row0,
                              int hd, int lane) {
  const bf16* p = tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < HDT / 16; ++kk)
    if (kk * 16 < hd) ldsm_x4(a[kk], p + kk * 16);
}

// s (16 x 8 NT, zeroed first) = A . tile[row0 : row0 + 8 NT, :hd]^T: the
// warp's 16 rows against NT * 8 rows of the tile (NT even)
template <int HDT, int NT>
__device__ inline void scores(float (&s)[NT][4], const uint32_t (&a)[HDT / 16][4],
                              const bf16* tile, int ld, int row0, int hd, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  const bf16* p = tile + (row0 + (lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HDT / 16; ++kk) {
    if (kk * 16 >= hd) continue;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, p + n * 8 * ld + kk * 16);
      mma_bf16(s[n], a[kk], b[0], b[1]);
      mma_bf16(s[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x hd) += A (16 x 16) . tile[row0 : row0 + 16, :hd]: the A
// fragment's 16 columns meet 16 rows of the tile
template <int HDT>
__device__ inline void accumulate(float (&acc)[HDT / 8][4], const uint32_t (&a)[4],
                                  const bf16* tile, int ld, int row0, int hd, int lane) {
  const bf16* p = tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < HDT / 8; n += 2) {
    if (n * 8 >= hd) continue;
    uint32_t b[4];
    ldsm_x4_trans(b, p + n * 8);
    mma_bf16(acc[n], a, b[0], b[1]);
    mma_bf16(acc[n + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (16 x 16, bf16) of two 16 x 8 fp32 C tiles side by side
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// s = s * scale + bias[col] over a warp's 16 x 8 NT score tile whose
// columns are keys [c0, c0 + 8 NT): a rounded product, then a rounded sum
// (no fused multiply-add), as the TPU kernel and the plain version order
// them; in the tile that crosses L the key columns >= L are masked to -inf,
// so that their exp is exactly 0
template <int NT>
__device__ __forceinline__ void scale_bias_mask(float (&s)[NT][4], const float* bias, int c0,
                                                int L, float scale, int tig) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b = *reinterpret_cast<const float2*>(bias + c0 + n * 8 + 2 * tig);
    s[n][0] = __fadd_rn(__fmul_rn(s[n][0], scale), b.x);
    s[n][1] = __fadd_rn(__fmul_rn(s[n][1], scale), b.y);
    s[n][2] = __fadd_rn(__fmul_rn(s[n][2], scale), b.x);
    s[n][3] = __fadd_rn(__fmul_rn(s[n][3], scale), b.y);
  }
  if (c0 + NT * 8 > L) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = c0 + n * 8 + 2 * tig;
      if (col >= L) s[n][0] = s[n][2] = -INFINITY;
      if (col + 1 >= L) s[n][1] = s[n][3] = -INFINITY;
    }
  }
}

// e / l, bit for bit the IEEE quotient whenever e >= 2^-100 (every p that
// can reach a bf16 rounding of the output), from rl = 1 / l: the quotient
// q = e rl is within an ulp and the exact residual e - q l corrects it
// (Markstein's theorem); three instructions where a division takes a
// dozen and a branch
__device__ __forceinline__ float div_by(float e, float l, float rl) {
  const float q = __fmul_rn(e, rl);
  return __fmaf_rn(__fmaf_rn(-q, l, e), rl, q);
}

// max and sum over the four lanes of a quad (one row's owners)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the warp's 16 x hd fp32 accumulator rounded to bf16 into rows [0, 16) of
// stage (its own rows of a shared tile no other warp reads any more), then
// rows [r0, r0 + 16) of the row-major (L, hd) dst with 16-byte stores; rows
// >= L are not written
template <int HDT>
__device__ inline void store_rows(bf16* dst, int r0, int L, int hd, bf16* stage, int ld,
                                  const float (&acc)[HDT / 8][4], int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < HDT / 8; ++n) {
    if (n * 8 >= hd) continue;
    const int c = n * 8 + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(stage + gid * ld + c) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (gid + 8) * ld + c) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  const int vec = hd / 8;
  for (int i = lane; i < 16 * vec; i += 32) {
    const int r = i / vec, c = (i % vec) * 8;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * hd + c) =
          *reinterpret_cast<const uint4*>(stage + r * ld + c);
  }
}

}  // namespace dst_attn
