// Shared-memory tile helpers of the attention kernels (attention_fwd.cu,
// attention_bwd.cu): row padding, the 16-byte row loader and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace dst_attn {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD_H = 8;         // bf16 row padding: rows stay 16-byte aligned
constexpr int PAD_F = 4;         // fp32 row padding
constexpr int MAX_L = 512;
constexpr int MAX_HD = 128;
constexpr size_t MAX_SMEM = 232448;

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// rows [0, rows) of a (rows, hd) tile; source rows >= valid are zero
__device__ inline void load_rows(bf16* dst, const bf16* src, int valid, int rows,
                                 int hd, int ld) {
  const int vec = hd / 8;  // 16-byte vectors per row (hd % 16 == 0)
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * hd + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ inline float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace dst_attn
