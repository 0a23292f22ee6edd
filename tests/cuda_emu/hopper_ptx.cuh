// The functions of dpr_scale_tpu_torch/csrc/hopper_ptx.cuh on the host
// (cuda_emu.h), by the PTX ISA's definitions:
//
// * a tensor map is (base, element size, rows, cols, box); a TMA load copies
//   its box into shared memory with the 128-byte swizzle (the 16-byte chunk
//   bits [4, 7) of each shared-memory address XOR its bits [7, 10)),
//   zero-fills the part past the matrix and completes its bytes on the
//   mbarrier;
// * a 1-D bulk copy (cp.async.bulk) copies its bytes, a multiple of 16
//   between 16-byte aligned addresses, and completes them on the mbarrier,
//   late: a copy lands when a thread waits on its mbarrier and finds the
//   phase still open (one copy a wait);
// * a 4-byte cp.async copies its first src-size bytes and zero-fills
//   the rest, into the shared address it is given (the kernel swizzles it;
//   the emulated wgmma reads through the swizzle, so a slip there fails);
//   a thread's copies wait in the thread until its
//   cp.async.mbarrier.arrive.noinc, which hands them on as one batch with
//   one arrival counted against the mbarrier's expected count; a batch
//   lands, copies then arrival, late, as a bulk copy does;
// * an mbarrier counts pending arrivals and transaction bytes and flips its
//   phase when both reach zero; try_wait.parity(P) is true once the phase of
//   parity P has completed;
// * wgmma.fence, commit_group and wait_group converge the warpgroup, as
//   their .sync.aligned asks; wgmma.mma_async is recorded, and runs when
//   wgmma.wait_group retires its group (every thread of the warpgroup has
//   run its share before any leaves the wait), reading shared memory
//   through the descriptors then: A K-major (row r, byte b of its K slice
//   at start + (r / 8) SBO + (r % 8) 128 + b); B MN-major (bf16 row k,
//   column n at start + (n / 64) LBO + 2 (n % 64) + (k / 8) SBO + (k % 8)
//   128) or K-major (column n, byte b at start + (n / 8) SBO + (n % 8) 128
//   + b), each address swizzled; bf16 products sum in fp32 over k16, s8
//   products exactly in int32 over k32; thread t of the warpgroup holds
//   D[4 j + 2 h + e] = (row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j +
//   2 (t % 4) + e);
// * mma.sync m16n8k32 s8 exchanges the warp's fragments through shared
//   state (the layout of hopper_ptx.cuh's comment);
// * fence.proxy.async, the barrier-init fence and setmaxnreg do nothing;
//   bar.sync is emu_bar_sync.
#pragma once

#include <chrono>
#include <condition_variable>

#include "cuda_emu.h"

#define __grid_constant__

struct CUtensorMap {
  const unsigned char* base;
  int elem;  // bytes an element
  long long rows, cols;
  int box_rows, box_cols;
};

namespace dst_hopper {

inline cudaError_t emu_make_tmap(CUtensorMap* map, const void* base, int elem, long long rows,
                                 long long cols, int box_rows, int box_cols) {
  if (box_cols * elem != 128 || box_rows > 256 || (uintptr_t)base % 16 || (cols * elem) % 16)
    return cudaErrorInvalidValue;
  *map = {static_cast<const unsigned char*>(base), elem, rows, cols, box_rows, box_cols};
  return cudaSuccess;
}

inline cudaError_t make_tmap(CUtensorMap* map, const void* base, long long rows, long long cols,
                             int box_rows, int box_cols) {
  return emu_make_tmap(map, base, 2, rows, cols, box_rows, box_cols);
}

inline cudaError_t make_tmap_bytes(CUtensorMap* map, const void* base, long long rows,
                                   long long cols, int box_rows) {
  return emu_make_tmap(map, base, 1, rows, cols, box_rows, 128);
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

// ---- cp.async (non-bulk) ----

struct EmuCp {
  unsigned char* dst;
  const void* src;
  uint32_t size, bytes;
};
inline thread_local std::vector<EmuCp> emu_cp_issued;  // since the thread's last arrival
struct EmuCpBatch {
  uint64_t* bar;
  std::vector<EmuCp> copies;
};
inline std::vector<EmuCpBatch> emu_cp_in_flight;  // under emu_mbar_mu

// under emu_mbar_mu: a batch of bar's lands, if one is in flight
inline bool emu_cp_land(uint64_t* bar) {
  for (size_t i = 0; i < emu_cp_in_flight.size(); ++i) {
    if (emu_cp_in_flight[i].bar != bar) continue;
    const EmuCpBatch b = std::move(emu_cp_in_flight[i]);
    emu_cp_in_flight.erase(emu_cp_in_flight.begin() + i);
    for (const EmuCp& c : b.copies) {
      if (c.size) std::memcpy(c.dst, c.src, c.size);
      std::memset(c.dst + c.size, 0, c.bytes - c.size);
    }
    EmuMbar& m = emu_mbar(bar);
    assert(m.pending > 0);
    --m.pending;
    emu_mbar_step(m);
    return true;
  }
  return false;
}

inline void cp_async4(uint32_t dst, const void* src, uint32_t src_size) {
  assert(dst % 4 == 0 && dst + 4 <= EMU_SMEM_BYTES && src_size <= 4u);
  assert(src != nullptr && (uintptr_t)src % 4 == 0);
  emu_cp_issued.push_back({emu_smem + dst, src, src_size, 4u});
}

inline void cp_async_arrive_noinc(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  emu_cp_in_flight.push_back({bar, std::move(emu_cp_issued)});
  emu_cp_issued.clear();
}

// 1-D bulk copies in flight (under emu_mbar_mu): a copy lands only when a
// thread waits on its own mbarrier and finds the phase open, so copies land
// in the order their waiters come, not the order they were issued, and a
// wait that passes before its copy has landed shows, as on the card
struct EmuBulk {
  unsigned char* dst;
  const void* src;
  uint32_t bytes;
  uint64_t* bar;
};
inline std::vector<EmuBulk> emu_bulk_in_flight;

inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(emu_mbar_mu);
  auto done = [&] { return emu_mbar(bar).phase != parity; };
  if (done()) return true;
  for (size_t i = 0; i < emu_bulk_in_flight.size(); ++i) {  // a copy of bar's lands, after the check
    const EmuBulk c = emu_bulk_in_flight[i];
    if (c.bar != bar) continue;
    emu_bulk_in_flight.erase(emu_bulk_in_flight.begin() + i);
    std::memcpy(c.dst, c.src, c.bytes);
    EmuMbar& m = emu_mbar(c.bar);
    m.tx -= (int32_t)c.bytes;
    emu_mbar_step(m);
    return false;
  }
  if (emu_cp_land(bar)) return false;
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
  const int e = map->elem;
  for (int r = 0; r < map->box_rows; ++r)
    for (int c = 0; c < map->box_cols; ++c) {
      const long long gr = (long long)row + r, gc = (long long)col + c;
      const bool in = gr >= 0 && gr < map->rows && gc >= 0 && gc < map->cols;
      const uint32_t a = swizzle128(d + (uint32_t)(r * map->box_cols + c) * e);
      if (in)
        std::memcpy(emu_smem + a, map->base + (gr * map->cols + gc) * e, e);
      else
        std::memset(emu_smem + a, 0, e);
    }
  emu_complete_tx(bar, (uint32_t)(map->box_rows * map->box_cols * e));
}

// ---- bulk copies ----

inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  const uint32_t d = smem_addr(dst);
  assert(d % 16 == 0 && (uintptr_t)src % 16 == 0 && bytes % 16 == 0 && bytes > 0);
  assert(d + bytes <= EMU_SMEM_BYTES);
  std::lock_guard<std::mutex> lock(emu_mbar_mu);
  emu_bulk_in_flight.push_back({emu_smem + d, src, bytes, bar});
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

enum EmuWgmmaKind { EMU_BF16_MN, EMU_BF16_K, EMU_S8 };

struct EmuWgmma {
  uint64_t da, db;
  void* d;
  int n;
  EmuWgmmaKind kind;
};
inline thread_local std::vector<EmuWgmma> emu_wgmma_pending;
inline thread_local std::vector<std::vector<EmuWgmma>> emu_wgmma_groups;

inline float emu_smem_bf16(uint32_t addr) {
  __nv_bfloat16 v;
  std::memcpy(&v, emu_smem + swizzle128(addr), 2);
  return __bfloat162float(v);
}

inline int emu_smem_s8(uint32_t addr) { return (int)(int8_t)emu_smem[swizzle128(addr)]; }

// the descriptor's fields: start address, leading and stride byte offsets
struct EmuDesc {
  uint32_t start, lbo, sbo;
  explicit EmuDesc(uint64_t desc)
      : start((uint32_t)(desc & 0x3FFF) << 4),
        lbo((uint32_t)((desc >> 16) & 0x3FFF) << 4),
        sbo((uint32_t)((desc >> 32) & 0x3FFF) << 4) {
    assert(desc >> 62 == 1);  // the 128-byte swizzle
  }
  // byte b of the K slice of K-major row r
  uint32_t kmajor(int r, int b) const { return start + (r / 8) * sbo + (r % 8) * 128 + b; }
};

inline void emu_wgmma_run(const EmuWgmma& op) {
  const EmuDesc a(op.da), b(op.db);
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  for (int j = 0; j < op.n / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * w + lane / 4 + 8 * (i >> 1), col = 8 * j + 2 * (lane % 4) + (i & 1);
      if (op.kind == EMU_S8) {
        int64_t acc = 0;
        for (int k = 0; k < 32; ++k)
          acc += (int64_t)emu_smem_s8(a.kmajor(row, k)) * emu_smem_s8(b.kmajor(col, k));
        static_cast<int*>(op.d)[4 * j + i] += (int)acc;
        continue;
      }
      double acc = 0.0;  // bf16 products are exact; the sum's order is the card's own
      for (int k = 0; k < 16; ++k) {
        const float av = emu_smem_bf16(a.kmajor(row, 2 * k));
        const float bv = op.kind == EMU_BF16_K
                             ? emu_smem_bf16(b.kmajor(col, 2 * k))
                             : emu_smem_bf16(b.start + (col / 64) * b.lbo + 2 * (col % 64) +
                                             (k / 8) * b.sbo + (k % 8) * 128);
        acc += (double)av * bv;
      }
      static_cast<float*>(op.d)[4 * j + i] += (float)acc;
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

template <int R>
inline void fence_operands(int (&)[R]) {}

template <int N>
inline void wgmma_m64k16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma's widths");
  emu_wgmma_pending.push_back({da, db, d, N, EMU_BF16_MN});
}

template <int N>
inline void wgmma_tn_bf16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma's widths");
  emu_wgmma_pending.push_back({da, db, d, N, EMU_BF16_K});
}

template <int N>
inline void wgmma_tn_s8(int (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "wgmma's widths");
  emu_wgmma_pending.push_back({da, db, d, N, EMU_S8});
}

// ---- warps ----

inline void mma_s8_m16n8k32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int lane = emu_lane();
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  w.bar.arrive_and_wait();
  auto byte = [](uint32_t x, int k) { return (int)(int8_t)(x >> (8 * k)); };
  int A[16][32], B[32][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, t = l & 3;
    for (int k = 0; k < 4; ++k) {
      A[g][4 * t + k] = byte(w.a[l][0], k);
      A[g + 8][4 * t + k] = byte(w.a[l][1], k);
      A[g][16 + 4 * t + k] = byte(w.a[l][2], k);
      A[g + 8][16 + 4 * t + k] = byte(w.a[l][3], k);
      B[4 * t + k][g] = byte(w.b[l][0], k);
      B[16 + 4 * t + k][g] = byte(w.b[l][1], k);
    }
  }
  w.bar.arrive_and_wait();
  const int gid = lane >> 2, tig = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = gid + (i >= 2 ? 8 : 0), col = 2 * tig + (i & 1);
    int acc = 0;
    for (int k = 0; k < 32; ++k) acc += A[row][k] * B[k][col];
    c[i] += acc;
  }
}

inline unsigned char* dynamic_smem() { return emu_smem; }

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t,
                   Args... args) {
  auto start = [] {
    emu_wgmma_pending.clear();
    emu_wgmma_groups.clear();
    emu_cp_issued.clear();
  };
  return emu_run(start, kernel, grid, threads, smem, args...);
}

}  // namespace dst_hopper
