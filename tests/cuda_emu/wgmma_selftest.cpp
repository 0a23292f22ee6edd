// Lone wgmmas through the emulation (hopper_ptx.cuh), for the emulated
// tests to hold against torch.mm / an exact integer product.
//
// emu_wgmma_selftest (tests/test_torch_ffn_emulated.py): A (64 x 64,
// K-major) and B (64 x N, MN-major, N = 128 or 256) land in shared memory
// either by the 128-byte swizzle written out by hand (A's element (r, k) at
// 128 r + 16 ((k / 8) ^ (r % 8)) + 2 (k % 8); B's (k, n) in 64-column boxes
// of 8192 bytes, at 128 k + 16 (((n % 64) / 8) ^ (k % 8)) + 2 (n % 8)) or by
// the emulated TMA; one warpgroup then runs four k-steps of wgmma m64nNk16
// from the descriptors the FFN kernel builds, and writes D (64 x N, fp32)
// from the fragment layout.  A slip in the emulated descriptors, swizzle,
// TMA or fragment layout shows here on its own.
//
// emu_wgmma_tn_selftest (tests/test_torch_mips_emulated.py): the sweeps'
// form, both operands K-major: A (64 rows) and B (N rows, N = 128 or 256),
// each row 128 bytes of K (64 bf16 or 128 int8), land either by the swizzle
// written out by hand (byte b of row r at 128 r + 16 ((b / 16) ^ (r % 8)) +
// b % 16) or by the emulated TMA (bf16 or byte tensor maps); one warpgroup
// runs four k-steps of wgmma m64nNk16 bf16 (or m64nNk32 s8) and writes
// D = A . B^T (64 x N, fp32 or int32).
#include "hopper_ptx.cuh"

using namespace dst_hopper;
typedef __nv_bfloat16 bf16;

namespace {

template <int N>
void selftest_kernel(const bf16* A, const bf16* B, float* D, CUtensorMap ta, CUtensorMap tb,
                     int by_tma) {
  unsigned char* smem = dynamic_smem();
  unsigned char* sb = smem + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + N / 64 * 8192);
  const int t = threadIdx.x;
  if (by_tma) {
    if (t == 0) {
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, 64 * 128 + N / 64 * 8192);
      tma_load(smem, &ta, 0, 0, bar);
      for (int j = 0; j < N / 64; ++j) tma_load(sb + j * 8192, &tb, 0, 64 * j, bar);
    }
    __syncthreads();
    mbar_wait(bar, 0);
  } else {
    for (int i = t; i < 64 * 64; i += 128) {
      const int r = i / 64, k = i % 64;
      std::memcpy(smem + 128 * r + 16 * ((k / 8) ^ (r % 8)) + 2 * (k % 8), A + i, 2);
    }
    for (int i = t; i < 64 * N; i += 128) {
      const int k = i / N, n = i % N;
      std::memcpy(sb + (n / 64) * 8192 + 128 * k + 16 * (((n % 64) / 8) ^ (k % 8)) + 2 * (n % 8),
                  B + i, 2);
    }
    __syncthreads();
  }
  float acc[N / 2] = {};
  wgmma_fence();
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64k16<N>(acc, smem_desc(smem + kk * 32, 16, 1024), smem_desc(sb + kk * 2048, 8192, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  const int w = t / 32, lane = t % 32;
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i)
      D[(16 * w + lane / 4 + 8 * (i >> 1)) * N + 8 * j + 2 * (lane % 4) + (i & 1)] = acc[4 * j + i];
}

}  // namespace

// D = A . B for A (64, 64) and B (64, n) bf16, n = 128 or 256; 0 on success
extern "C" int emu_wgmma_selftest(const void* A, const void* B, void* D, int n, int by_tma) {
  CUtensorMap ta, tb;
  if (make_tmap(&ta, A, 64, 64, 64, 64) || make_tmap(&tb, B, 64, n, 64, 64)) return 1;
  const size_t smem = 64 * 128 + n / 64 * 8192 + 8;
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  float* d = static_cast<float*>(D);
  if (n == 128) return launch(selftest_kernel<128>, dim3(1), 128, smem, nullptr, a, b, d, ta, tb, by_tma);
  if (n == 256) return launch(selftest_kernel<256>, dim3(1), 128, smem, nullptr, a, b, d, ta, tb, by_tma);
  return 1;
}

namespace {

template <int N, bool S8>
void tn_selftest_kernel(const unsigned char* A, const unsigned char* B, void* D, CUtensorMap ta,
                        CUtensorMap tb, int by_tma) {
  unsigned char* smem = dynamic_smem();
  unsigned char* sb = smem + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + N * 128);
  const int t = threadIdx.x;
  if (by_tma) {
    if (t == 0) {
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, 64 * 128 + N * 128);
      tma_load(smem, &ta, 0, 0, bar);
      tma_load(sb, &tb, 0, 0, bar);
    }
    __syncthreads();
    mbar_wait(bar, 0);
  } else {
    auto put = [](unsigned char* dst, const unsigned char* src, int rows) {
      for (int i = threadIdx.x; i < rows * 128; i += 128) {
        const int r = i / 128, b = i % 128;
        dst[128 * r + 16 * ((b / 16) ^ (r % 8)) + b % 16] = src[i];
      }
    };
    put(smem, A, 64);
    put(sb, B, N);
    __syncthreads();
  }
  typedef typename std::conditional<S8, int, float>::type Acc;
  Acc acc[N / 2] = {};
  wgmma_fence();
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = smem_desc(smem + kk * 32, 16, 1024), db = smem_desc(sb + kk * 32, 16, 1024);
    if constexpr (S8)
      wgmma_tn_s8<N>(acc, da, db);
    else
      wgmma_tn_bf16<N>(acc, da, db);
  }
  wgmma_commit();
  wgmma_wait<0>();
  const int w = t / 32, lane = t % 32;
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i)
      static_cast<Acc*>(D)[(16 * w + lane / 4 + 8 * (i >> 1)) * N + 8 * j + 2 * (lane % 4) +
                           (i & 1)] = acc[4 * j + i];
}

template <int N, bool S8>
int tn_selftest(const void* A, const void* B, void* D, int by_tma) {
  CUtensorMap ta, tb;
  const int bad = S8 ? make_tmap_bytes(&ta, A, 64, 128, 64) || make_tmap_bytes(&tb, B, N, 128, N)
                     : make_tmap(&ta, A, 64, 64, 64, 64) || make_tmap(&tb, B, N, 64, N, 64);
  if (bad) return 1;
  return launch(tn_selftest_kernel<N, S8>, dim3(1), 128, 64 * 128 + N * 128 + 8, nullptr,
                static_cast<const unsigned char*>(A), static_cast<const unsigned char*>(B), D, ta,
                tb, by_tma);
}

}  // namespace

// D = A . B^T for A (64, K) and B (n, K), K = 64 bf16 (s8 = 0, D fp32) or
// 128 int8 (s8 = 1, D int32), n = 128 or 256; 0 on success
extern "C" int emu_wgmma_tn_selftest(const void* A, const void* B, void* D, int n, int s8,
                                     int by_tma) {
  if (n == 128) return s8 ? tn_selftest<128, true>(A, B, D, by_tma) : tn_selftest<128, false>(A, B, D, by_tma);
  if (n == 256) return s8 ? tn_selftest<256, true>(A, B, D, by_tma) : tn_selftest<256, false>(A, B, D, by_tma);
  return 1;
}
