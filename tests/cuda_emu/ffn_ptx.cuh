// The functions of dpr_scale_tpu_torch/csrc/ffn_ptx.cuh on the host
// (cuda_emu.h), by the PTX ISA's definitions:
//
// * a tensor map is (base, rows, cols, box); a TMA load copies its box into
//   shared memory with the 128-byte swizzle (the 16-byte chunk bits [4, 7)
//   of each shared-memory address XOR its bits [7, 10)), zero-fills the
//   part past the matrix and completes its bytes on the mbarrier;
// * an mbarrier counts pending arrivals and transaction bytes and flips its
//   phase when both reach zero; try_wait.parity(P) is true once the phase of
//   parity P has completed;
// * wgmma.fence, commit_group and wait_group converge the warpgroup, as
//   their .sync.aligned asks; wgmma.mma_async is recorded, and runs when
//   wgmma.wait_group retires its group (every thread of the warpgroup has
//   run its share before any leaves the wait), reading shared memory
//   through the descriptors then: A K-major
//   (row r, column k at start + (r / 8) SBO + (r % 8) 128 + 2 k), B
//   MN-major (row k, column n at start + (n / 64) LBO + 2 (n % 64) +
//   (k / 8) SBO + (k % 8) 128), each address swizzled; thread t of the
//   warpgroup holds D[4 j + 2 h + e] = (row 16 (t / 32) + (t % 32) / 4 + 8 h,
//   column 8 j + 2 (t % 4) + e);
// * fence.proxy.async, the barrier-init fence and setmaxnreg do nothing;
//   bar.sync is emu_bar_sync.
#pragma once

#include <chrono>
#include <condition_variable>

#include "cuda_emu.h"

#define __grid_constant__

struct CUtensorMap {
  const __nv_bfloat16* base;
  int rows, cols, box_rows, box_cols;
};

namespace dst_ffn {

inline cudaError_t make_tmap(CUtensorMap* map, const void* base, int rows, int cols,
                             int box_rows, int box_cols) {
  if (box_cols * 2 != 128 || box_rows > 256 || (uintptr_t)base % 16 || cols % 8)
    return cudaErrorInvalidValue;
  *map = {static_cast<const __nv_bfloat16*>(base), rows, cols, box_rows, box_cols};
  return cudaSuccess;
}

inline uint32_t smem_addr(const void* p) {
  const ptrdiff_t off = static_cast<const unsigned char*>(p) - emu_smem;
  assert(off >= 0 && (size_t)off < EMU_SMEM_BYTES);
  return (uint32_t)off;
}

inline uint32_t swizzle128(uint32_t a) { return a ^ (((a >> 7) & 7u) << 4); }

// ---- mbarriers ----

struct EmuMbar {
  uint8_t expected, pending, phase, unused;
  int32_t tx;
};
static_assert(sizeof(EmuMbar) == 8, "an mbarrier is 8 bytes");
inline std::mutex emu_mbar_mu;
inline std::condition_variable emu_mbar_cv;

inline EmuMbar& emu_mbar(uint64_t* bar) {
  assert(smem_addr(bar) % 8 == 0);
  return *reinterpret_cast<EmuMbar*>(bar);
}

// under emu_mbar_mu: the phase completes with its last arrival and byte
inline void emu_mbar_step(EmuMbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.expected;
    emu_mbar_cv.notify_all();
  }
}

inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  assert(count > 0 && count < 256);
  emu_mbar(bar) = {(uint8_t)count, (uint8_t)count, 0, 0, 0};
}

inline void fence_barrier_init() {}
inline void fence_proxy_async() {}

inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  EmuMbar& m = emu_mbar(bar);
  assert(m.pending > 0);
  --m.pending;
  emu_mbar_step(m);
}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  EmuMbar& m = emu_mbar(bar);
  assert(m.pending > 0);
  m.tx += (int32_t)bytes;
  --m.pending;
  emu_mbar_step(m);
}

inline void emu_complete_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  EmuMbar& m = emu_mbar(bar);
  m.tx -= (int32_t)bytes;
  emu_mbar_step(m);
}

inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(emu_mbar_mu);
  auto done = [&] { return emu_mbar(bar).phase != parity; };
  emu_mbar_cv.wait_for(lock, std::chrono::milliseconds(1), done);  // try_wait's time limit
  return done();
}

inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- TMA ----

inline void tma_load(void* dst, const CUtensorMap* map, int row, int col, uint64_t* bar) {
  const uint32_t d = smem_addr(dst);
  assert(d % 1024 == 0);
  for (int r = 0; r < map->box_rows; ++r)
    for (int c = 0; c < map->box_cols; ++c) {
      const int gr = row + r, gc = col + c;
      const bool in = gr >= 0 && gr < map->rows && gc >= 0 && gc < map->cols;
      const __nv_bfloat16 v = in ? map->base[(size_t)gr * map->cols + gc] : __nv_bfloat16{0};
      const uint32_t a = swizzle128(d + (uint32_t)(r * map->box_cols + c) * 2);
      std::memcpy(emu_smem + a, &v, 2);
    }
  emu_complete_tx(bar, (uint32_t)(map->box_rows * map->box_cols * 2));
}

// ---- warpgroups ----

template <int R>
inline void setmaxnreg_inc() {
  static_assert(R >= 24 && R <= 256 && R % 8 == 0, "setmaxnreg's range");
}

template <int R>
inline void setmaxnreg_dec() {
  static_assert(R >= 24 && R <= 256 && R % 8 == 0, "setmaxnreg's range");
}

inline void named_bar_sync(int id, int count) {
  assert(id > 0 && id < 16 && count % 32 == 0);
  emu_bar_sync(id, count);
}

inline uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

struct EmuWgmma {
  uint64_t da, db;
  float* d;
  int n;
};
inline thread_local std::vector<EmuWgmma> emu_wgmma_pending;
inline thread_local std::vector<std::vector<EmuWgmma>> emu_wgmma_groups;

inline float emu_smem_bf16(uint32_t addr) {
  __nv_bfloat16 v;
  std::memcpy(&v, emu_smem + swizzle128(addr), 2);
  return __bfloat162float(v);
}

// the descriptor's fields: start address, leading and stride byte offsets
struct EmuDesc {
  uint32_t start, lbo, sbo;
  explicit EmuDesc(uint64_t desc)
      : start((uint32_t)(desc & 0x3FFF) << 4),
        lbo((uint32_t)((desc >> 16) & 0x3FFF) << 4),
        sbo((uint32_t)((desc >> 32) & 0x3FFF) << 4) {
    assert(desc >> 62 == 1);  // the 128-byte swizzle
  }
};

inline void emu_wgmma_run(const EmuWgmma& op) {
  const EmuDesc a(op.da), b(op.db);
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  for (int j = 0; j < op.n / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + lane / 4 + 8 * (i >> 1), col = 8 * j + 2 * (lane % 4) + (i & 1);
      double acc = 0.0;  // bf16 products are exact; the sum's order is the card's own
      for (int k = 0; k < 16; ++k) {
        const float av = emu_smem_bf16(a.start + (row / 8) * a.sbo + (row % 8) * 128 + 2 * k);
        const float bv = emu_smem_bf16(b.start + (col / 64) * b.lbo + 2 * (col % 64) +
                                       (k / 8) * b.sbo + (k % 8) * 128);
        acc += (double)av * bv;
      }
      op.d[4 * j + i] += (float)acc;
    }
}

inline void wgmma_fence() { emu_warpgroup_sync(); }

inline void wgmma_commit() {
  emu_warpgroup_sync();
  emu_wgmma_groups.push_back(emu_wgmma_pending);
  emu_wgmma_pending.clear();
}

template <int N>
inline void wgmma_wait() {
  while ((int)emu_wgmma_groups.size() > N) {
    for (const EmuWgmma& op : emu_wgmma_groups.front()) emu_wgmma_run(op);
    emu_wgmma_groups.erase(emu_wgmma_groups.begin());
  }
  emu_warpgroup_sync();
}

template <int R>
inline void fence_operands(float (&)[R]) {}

template <int N>
inline void wgmma_m64k16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma's widths");
  emu_wgmma_pending.push_back({da, db, d, N});
}

inline unsigned char* dynamic_smem() { return emu_smem; }

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t,
                   Args... args) {
  auto start = [] {
    emu_wgmma_pending.clear();
    emu_wgmma_groups.clear();
  };
  return emu_run(start, kernel, grid, threads, smem, args...);
}

}  // namespace dst_ffn
