// A host emulation of the CUDA features the attention, FFN, MIPS sweep and
// gather-score kernels (dpr_scale_tpu_torch/csrc/attention_*.cu,
// ffn_fwd.cu, mips_scan.cu, count_groups.cu, int_scan.cu, gather_score.cu)
// use, so that their sources run on a CPU under g++: one block at a time,
// one std::thread per CUDA thread, std::barrier for __syncthreads, named
// barriers, the warp's collective instructions, the device queries of a
// persistent grid and the few intrinsics they call.
// tests/test_torch_{attention,ffn,mips,gather}_emulated.py build the
// kernels with it, beside attention_ptx.cuh / hopper_ptx.cuh / mma.h here in
// place of the PTX wrappers and wmma.
#pragma once

#include <algorithm>
#include <atomic>
#include <cassert>
#include <barrier>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
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
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct alignas(8) int2 {
  int x, y;
};
inline int2 make_int2(int x, int y) { return {x, y}; }
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
// four byte lanes, each a - b modulo 256
inline unsigned __vsub4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int k = 0; k < 32; k += 8) r |= (((a >> k) - (b >> k)) & 0xffu) << k;
  return r;
}
template <typename T>
inline T __ldg(const T* p) { return *p; }
template <typename T>
inline T __ldcg(const T* p) { return std::atomic_ref<T>(*const_cast<T*>(p)).load(); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline int __float_as_int(float f) {
  int x;
  std::memcpy(&x, &f, 4);
  return x;
}
// a device-side stop: the emulated launch, and its process, end
[[noreturn]] inline void __trap() { std::abort(); }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
using std::max;
using std::min;

// the device's queries, for the persistent grids: an emulated card of
// EMU_SMS multiprocessors (few, so that each block walks several items)
// holding one block of any kernel each
constexpr int EMU_SMS = 2;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  assert(attr == cudaDevAttrMultiProcessorCount);
  *value = EMU_SMS;
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, Kernel, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

// the running block: its index, its threads' barrier and its warps' state
struct EmuWarp {
  std::barrier<> bar{32};
  const void* ptr[32];
  uint32_t a[32][4], b[32][2];
  float f[32];
  int i[32];
  long long ll[32];
};
// bar.sync id, count: one barrier per id, made by its first caller
struct EmuNamedBars {
  std::mutex mu;
  std::map<int, std::pair<int, std::unique_ptr<std::barrier<>>>> bars;
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, gridDim, blockDim;
extern EmuWarp* emu_warps;
extern std::barrier<>* emu_block_bar;
extern EmuNamedBars* emu_named_bars;
extern std::deque<std::barrier<>>* emu_warpgroup_bars;  // one per 128 threads
extern unsigned char emu_smem[];
constexpr size_t EMU_SMEM_BYTES = 232448;  // an H100 block's shared memory

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

// lane src's x, in every lane
inline float __shfl_sync(unsigned, float x, int src) {
  EmuWarp& w = emu_warp();
  w.f[emu_lane()] = x;
  w.bar.arrive_and_wait();
  const float r = w.f[src % 32];
  w.bar.arrive_and_wait();
  return r;
}

inline int __shfl_sync(unsigned, int x, int src) {
  EmuWarp& w = emu_warp();
  w.i[emu_lane()] = x;
  w.bar.arrive_and_wait();
  const int r = w.i[src % 32];
  w.bar.arrive_and_wait();
  return r;
}

inline int __shfl_xor_sync(unsigned, int x, int mask) {
  EmuWarp& w = emu_warp();
  w.i[emu_lane()] = x;
  w.bar.arrive_and_wait();
  const int r = w.i[emu_lane() ^ mask];
  w.bar.arrive_and_wait();
  return r;
}

inline long long __shfl_xor_sync(unsigned, long long x, int mask) {
  EmuWarp& w = emu_warp();
  w.ll[emu_lane()] = x;
  w.bar.arrive_and_wait();
  const long long r = w.ll[emu_lane() ^ mask];
  w.bar.arrive_and_wait();
  return r;
}

// nonzero in every lane where some lane's pred is
inline int __any_sync(unsigned, int pred) {
  EmuWarp& w = emu_warp();
  w.i[emu_lane()] = pred != 0;
  w.bar.arrive_and_wait();
  int r = 0;
  for (int l = 0; l < 32; ++l) r |= w.i[l];
  w.bar.arrive_and_wait();
  return r;
}

inline void emu_bar_sync(int id, int count) {
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(emu_named_bars->mu);
    auto& slot = emu_named_bars->bars[id];
    if (!slot.second) slot = {count, std::make_unique<std::barrier<>>(count)};
    assert(slot.first == count);
    bar = slot.second.get();
  }
  bar->arrive_and_wait();
}

// the convergence of a warpgroup-wide .sync.aligned instruction
inline void emu_warpgroup_sync() { (*emu_warpgroup_bars)[threadIdx.x / 128].arrive_and_wait(); }

// grid x threads blocks of kernel(args...) with smem bytes of shared memory,
// one block after another, on one std::thread per CUDA thread made once per
// launch; each thread calls start() (resetting its own emulated state)
// before each block, and the last thread to finish a block sets up the next
template <typename Start, typename Kernel, typename... Args>
cudaError_t emu_run(Start start, Kernel kernel, dim3 grid, int threads, size_t smem,
                    Args... args) {
  if (smem > EMU_SMEM_BYTES || threads % 32 || threads > 1024) return cudaErrorInvalidConfiguration;
  gridDim = grid;
  blockDim = dim3(threads);
  const unsigned blocks = grid.x * grid.y * grid.z;
  std::vector<EmuWarp> warps(threads / 32);
  std::barrier<> bar(threads);
  EmuNamedBars named;
  std::deque<std::barrier<>> groups;
  for (int g = 0; g < threads; g += 128) groups.emplace_back(std::min(128, threads - g));
  emu_warps = warps.data();
  emu_block_bar = &bar;
  emu_named_bars = &named;
  emu_warpgroup_bars = &groups;
  unsigned block = 0;
  auto enter = [&]() noexcept {  // block's index, fresh named barriers, NaN shared memory
    blockIdx = dim3(block % grid.x, block / grid.x % grid.y, block / (grid.x * grid.y));
    named.bars.clear();
    std::memset(emu_smem, 0xff, smem);
  };
  enter();
  auto next = [&]() noexcept {
    ++block;
    if (block < blocks) enter();
  };
  std::barrier<decltype(next)> between(threads, next);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned b = 0; b < blocks; ++b) {
        start();
        kernel(args...);
        between.arrive_and_wait();
      }
    });
  for (std::thread& th : pool) th.join();
  return cudaSuccess;
}
