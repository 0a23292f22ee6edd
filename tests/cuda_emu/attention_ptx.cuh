// The functions of dpr_scale_tpu_torch/csrc/attention_ptx.cuh on the host
// (cuda_emu.h), by the PTX ISA's definitions: cp.async copies land when
// their group is waited for, ldmatrix and mma.sync exchange the warp's
// fragments through shared state, and launch() runs the grid's blocks one
// after another.
#pragma once

#include <cassert>
#include <thread>

typedef __nv_bfloat16 bf16;

namespace dst_attn {

struct EmuCopy {
  void* dst;
  const void* src;
  bool valid;
};
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline thread_local std::vector<EmuCopy> emu_pending;

inline void cp_async16(void* smem, const void* gmem, bool valid) {
  assert((uintptr_t)smem % 16 == 0 && (uintptr_t)gmem % 16 == 0);
  emu_pending.push_back({smem, gmem, valid});
}

inline void cp_async_commit() {
  emu_groups.push_back(emu_pending);
  emu_pending.clear();
}

template <int N>
inline void cp_async_wait() {
  while ((int)emu_groups.size() > N) {
    for (const EmuCopy& c : emu_groups.front()) {
      if (c.valid)
        std::memcpy(c.dst, c.src, 16);
      else
        std::memset(c.dst, 0, 16);
    }
    emu_groups.erase(emu_groups.begin());
  }
}

inline uint32_t emu_pack(uint16_t lo, uint16_t hi) { return uint32_t(lo) | (uint32_t(hi) << 16); }

// lanes 8j .. 8j + 7 give the rows of matrix j; lane l receives row l / 4,
// columns 2 (l % 4) and + 1 (transposed: rows 2 (l % 4) and + 1 of column l / 4)
template <bool TRANS>
inline void emu_ldmatrix(uint32_t (&r)[4], const bf16* p) {
  assert((uintptr_t)p % 16 == 0);
  EmuWarp& w = emu_warp();
  const int lane = emu_lane(), gid = lane >> 2, tig = lane & 3;
  w.ptr[lane] = p;
  w.bar.arrive_and_wait();
  for (int j = 0; j < 4; ++j) {
    auto row = [&](int i) { return static_cast<const bf16*>(w.ptr[8 * j + i]); };
    r[j] = TRANS ? emu_pack(row(2 * tig)[gid].bits, row(2 * tig + 1)[gid].bits)
                 : emu_pack(row(gid)[2 * tig].bits, row(gid)[2 * tig + 1].bits);
  }
  w.bar.arrive_and_wait();
}

inline void ldsm_x4(uint32_t (&r)[4], const bf16* p) { emu_ldmatrix<false>(r, p); }
inline void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) { emu_ldmatrix<true>(r, p); }

inline float emu_half(uint32_t x, int hi) { return __bfloat162float({uint16_t(hi ? x >> 16 : x)}); }

inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int lane = emu_lane();
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = emu_half(w.a[l][0], h);
      A[g + 8][2 * t + h] = emu_half(w.a[l][1], h);
      A[g][2 * t + 8 + h] = emu_half(w.a[l][2], h);
      A[g + 8][2 * t + 8 + h] = emu_half(w.a[l][3], h);
      B[2 * t + h][g] = emu_half(w.b[l][0], h);
      B[2 * t + 8 + h][g] = emu_half(w.b[l][1], h);
    }
  }
  w.bar.arrive_and_wait();
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = gid + (i >= 2 ? 8 : 0), col = 2 * tig + (i & 1);
    double acc = 0.0;  // bf16 products are exact; the sum's order is the card's own
    for (int k = 0; k < 16; ++k) acc += (double)A[row][k] * B[k][col];
    c[i] += (float)acc;
  }
}

inline unsigned char* dynamic_smem() { return emu_smem; }

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t,
                   Args... args) {
  if (smem > 232448 || threads % 32) return cudaErrorInvalidConfiguration;
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        std::memset(emu_smem, 0xff, smem);  // NaN until written
        std::vector<EmuWarp> warps(threads / 32);
        std::barrier<> bar(threads);
        emu_warps = warps.data();
        emu_block_bar = &bar;
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, t] {
            threadIdx = dim3(t);
            emu_groups.clear();
            emu_pending.clear();
            kernel(args...);
          });
        for (std::thread& th : pool) th.join();
      }
  return cudaSuccess;
}

}  // namespace dst_attn
