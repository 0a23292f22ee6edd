// A host emulation of the CUDA features the attention kernels
// (dpr_scale_tpu_torch/csrc/attention_*.cu) use, so that their sources run
// on a CPU under g++: one block at a time, one std::thread per CUDA thread,
// std::barrier for __syncthreads and for the warp's collective instructions.
// tests/test_torch_attention_emulated.py builds the kernels with it, beside
// attention_ptx.cuh here in place of the PTX wrappers.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };

struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
using std::max;
using std::min;

// the running block: its index, its threads' barrier and its warps' state
struct EmuWarp {
  std::barrier<> bar{32};
  const void* ptr[32];
  uint32_t a[32][4], b[32][2];
  float f[32];
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, gridDim, blockDim;
extern EmuWarp* emu_warps;
extern std::barrier<>* emu_block_bar;
extern unsigned char emu_smem[];

inline int emu_lane() { return threadIdx.x % 32; }
inline EmuWarp& emu_warp() { return emu_warps[threadIdx.x / 32]; }
inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu_warp().bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float x, int mask) {
  EmuWarp& w = emu_warp();
  w.f[emu_lane()] = x;
  w.bar.arrive_and_wait();
  const float r = w.f[emu_lane() ^ mask];
  w.bar.arrive_and_wait();
  return r;
}
