// Fused transformer FFN forward, and its LayerNorm-fused half-layer, for Hopper.
//
// Replaces the TPU kernels dpr_scale_tpu/ops/ffn.py::_fwd_kernel (the
// pallas_call in _fwd_impl, ffn.py:169, fused_ffn) and ::_fwd_ln_kernel (the
// pallas_call in _fwd_ln_impl, ffn.py:387, fused_ffn_ln):
//
//     pre = x . w1 + b1                     (fp32 sums; saved as bf16)
//     h   = bf16(gelu(pre))                 (from the fp32 pre, exact erf GELU)
//     y   = h . w2 + b2                     (fp32 sums over all of F)
//     y   = keep ? y / (1 - rate) : 0       (rate > 0 only), then bf16
//
// and for the LN variant x1 = bf16(LN1(r)) in front (x1 is both the GEMM
// input and the residual), z = y, out = bf16(LN2(x1 + z)) behind, LayerNorm
// in fp32 with the fast variance E[v^2] - E[v]^2 (clamped at 0).  Shapes:
// x, r, y, z, x1, out (N, H); w1 (H, F); w2 (F, H); pre, h (N, F); all bf16
// row-major; b1 (F,), b2 (H,) bf16; the LN scales and biases (H,) fp32.
// H and F are multiples of 128, N >= 1.  The keep bits of entry (i, j) are
// dst_bits(dst_row_key(seed, 0, i), j) (dropout_bits.cuh), the bits
// ops/attention.py::dropout_keep_mask gives a (1, 1, N, H) matrix.
//
// What bounds it on an H100: the two products, 4 N H F operations (309.2
// GFLOP at N = 32,768, H = 768, F = 3072: 0.313 ms at 989 TFLOP/s bf16)
// against the function's own inputs and outputs (~0.3 GB, 0.09 ms at
// 3.35 TB/s): compute.  The TPU kernel keeps a (rows, H) fp32 accumulator
// in VMEM while it walks F; for a 128-row tile at H = 768 that is 384 KB,
// more than a Hopper block's 227 KB of shared memory, so h makes one round
// trip through device memory (2 N F bytes each way, 0.2 GB at N = 32,768:
// 0.12 ms), written by GEMM1 and read by GEMM2.
//
// Design: two GEMMs, one template, each with its epilogue in registers.
// GEMM1 = x . w1 with bias + GELU, writing pre and h; GEMM2 = h . w2 with
// bias (+ dropout), writing y.  A block of 384 threads computes a
// 128 x BN output tile (BN = 256 where the output width divides by it,
// else 128): one producer warp issues TMA loads (2-D boxes, 128-byte
// swizzle, zero fill past the last row) of the A tile (128 x 64) and of
// the B tile (64 x BN, as BN / 64 boxes of 64 x 64) into a 4-stage ring,
// each stage with a full and an empty mbarrier; two consumer warpgroups
// each run wgmma m64nBNk16 (bf16 in, fp32 accumulate in registers) on 64
// of the tile's rows, four k-steps a stage, and release a stage once the
// products that read it have retired (wgmma.wait_group 1 one stage
// later).  The weights are read as stored, row-major (K, N): B is
// MN-major, the descriptor's transpose bit set.  Shared memory: 4 x 48 KB
// at BN = 256, 4 x 32 KB at BN = 128.  After the main loop each thread
// adds the bias to the accumulators it holds (their row and column follow
// from the wgmma fragment layout), applies GELU or the dropout, packs to
// bf16 into the freed ring, and the warpgroup writes its 64 rows as
// 16-byte vectors, rows >= N masked.  The LayerNorms need whole rows of H,
// which a BN-column tile does not have, so LN1 and LN2 (with the residual
// add) stay row kernels, one warp per row, before and after the GEMMs.
// The instructions' wrappers are in hopper_ptx.cuh.
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"  // first: the emulation defines the CUDA keywords there
#include "dropout_bits.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace dst_hopper;

constexpr int BM = 128, BK = 64, STAGES = 4;  // BK * 2 bytes = the 128-byte swizzle span
constexpr int THREADS = 384;                  // two consumer warpgroups, one producer
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK * 2;  // a stage's A tile, 128 rows of 128 bytes
constexpr int SUB_B = BK * 64 * 2;    // one 64 x 64 box of the B tile
constexpr int LN_WARPS = 8;

template <int BN>
constexpr int STAGE_BYTES = A_BYTES + BN / 64 * SUB_B;

// the ring, its 2 x STAGES barriers and the slack to align it to 1024 bytes
template <int BN>
constexpr size_t smem_bytes() {
  return 1024 + STAGES * STAGE_BYTES<BN> + 2 * STAGES * sizeof(uint64_t);
}

enum Epilogue { BIAS_GELU = 0, BIAS = 1, BIAS_DROPOUT = 2 };

__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// C = A (M, K) . B (K, Ncols) for the (BM, BN) tile of this block, and the
// epilogue: BIAS_GELU writes out0 = bf16(C + bias) and out1 =
// bf16(gelu(C + bias)); BIAS writes out0 = bf16(C + bias); BIAS_DROPOUT
// writes out0 = bf16(keep ? (C + bias) * inv_keep : 0).  tmA reads A in
// (BM, BK) boxes, tmB reads B in (BK, 64) boxes.
template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                const bf16* __restrict__ bias, bf16* __restrict__ out0,
                bf16* __restrict__ out1, int M, int Ncols, int K, uint32_t seed,
                uint32_t thr, float inv_keep) {
  constexpr int STAGE = STAGE_BYTES<BN>;
  unsigned char* smem = dynamic_smem();
  smem += (1024 - (smem_addr(smem) & 1023)) & 1023;  // the swizzle repeats every 1024 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, KT = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring's loads in flight ----
    setmaxnreg_dec<40>();
    if (t == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        const uint32_t use = kt / STAGES;
        mbar_wait(&empty[s], (use & 1) ^ 1);  // the first use of a stage passes at once
        unsigned char* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load(st, &tmA, m0, kt * BK, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(st + A_BYTES + j * SUB_B, &tmB, kt * BK, n0 + j * 64, &full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
    setmaxnreg_inc<232>();
    const int warp = t / 32, lane = t % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* st = smem + s * STAGE;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart, k-step
        // 32 bytes; B: MN-major, 64-column boxes SUB_B apart, 8-row groups
        // (of K) 1024 bytes apart, k-step 16 rows
        const uint64_t da = smem_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = smem_desc(st + A_BYTES + kk * 16 * 128, SUB_B, 1024);
        wgmma_m64k16<BN>(acc, da, db);
      }
      wgmma_commit();
      fence_operands(acc);
      wgmma_wait<1>();  // the previous stage's products have retired
      fence_operands(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    named_bar_sync(1, 256);  // both warpgroups are done with the ring
    fence_proxy_async();

    // ---- epilogue: bias, GELU or dropout, bf16, staged in the ring ----
    constexpr int PITCH = BN + 8;  // bf16; rows 16 bytes apart in bank terms
    constexpr int OUTS = EPI == BIAS_GELU ? 2 : 1;
    bf16* st0 = reinterpret_cast<bf16*>(smem) + wg * OUTS * 64 * PITCH;
    bf16* st1 = st0 + 64 * PITCH;
    const int r0 = warp * 16 + lane / 4;  // this thread's rows r0 and r0 + 8 of the 64
    const int rows = m0 + wg * 64;
    uint32_t rk[2] = {0u, 0u};
    if (EPI == BIAS_DROPOUT) {
      rk[0] = dst_row_key(seed, 0u, (uint32_t)(rows + r0));
      rk[1] = dst_row_key(seed, 0u, (uint32_t)(rows + r0 + 8));
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      // acc[4 j + 2 h + e] is (row r0 + 8 h, column 8 j + 2 (lane % 4) + e)
      const int c = 8 * j + 2 * (lane & 3);
      const float b0 = __bfloat162float(bias[n0 + c]);
      const float b1 = __bfloat162float(bias[n0 + c + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        const int off = (r0 + 8 * h) * PITCH + c;
        if (EPI == BIAS_GELU) {
          *reinterpret_cast<__nv_bfloat162*>(st1 + off) = __floats2bfloat162_rn(gelu(v0), gelu(v1));
        } else if (EPI == BIAS_DROPOUT) {
          v0 = dst_bits(rk[h], (uint32_t)(n0 + c)) >= thr ? v0 * inv_keep : 0.0f;
          v1 = dst_bits(rk[h], (uint32_t)(n0 + c + 1)) >= thr ? v1 * inv_keep : 0.0f;
        }
        *reinterpret_cast<__nv_bfloat162*>(st0 + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
    named_bar_sync(2 + wg, 128);
    constexpr int VPR = BN / 8;  // 16-byte vectors a row
    for (int v = t; v < 64 * VPR; v += 128) {
      const int r = v / VPR, c = (v % VPR) * 8, row = rows + r;
      if (row >= M) break;  // v only grows
      const size_t off = (size_t)row * Ncols + n0 + c;
      *reinterpret_cast<uint4*>(out0 + off) = *reinterpret_cast<const uint4*>(st0 + r * PITCH + c);
      if (EPI == BIAS_GELU)
        *reinterpret_cast<uint4*>(out1 + off) = *reinterpret_cast<const uint4*>(st1 + r * PITCH + c);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// out = bf16(LN(a + b)) over rows of H (b may be null), one warp per row,
// fp32 statistics with the fast variance; the second pass re-reads the row
// (from L1/L2) instead of holding H / 32 values a lane.
__global__ void __launch_bounds__(32 * LN_WARPS)
ln_rows_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
               const float* __restrict__ g, const float* __restrict__ beta,
               bf16* __restrict__ out, int N, int H, float eps) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= N) return;
  const bf16* ar = a + (size_t)row * H;
  const bf16* br = b ? b + (size_t)row * H : nullptr;
  auto load8 = [&](int c, float* v) {
    const uint4 ua = *reinterpret_cast<const uint4*>(ar + c);
    const bf16* ea = reinterpret_cast<const bf16*>(&ua);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(ea[e]);
    if (br) {
      const uint4 ub = *reinterpret_cast<const uint4*>(br + c);
      const bf16* eb = reinterpret_cast<const bf16*>(&ub);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(eb[e]);
    }
  };
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane * 8; c < H; c += 256) {
    float v[8];
    load8(c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sum += v[e];
      sq += v[e] * v[e];
    }
  }
  const float mu = warp_sum(sum) / H;
  const float var = fmaxf(warp_sum(sq) / H - mu * mu, 0.0f);
  const float inv = rsqrtf(var + eps);
  for (int c = lane * 8; c < H; c += 256) {
    float v[8];
    load8(c, v);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16((v[e] - mu) * inv * g[c + e] + beta[c + e]);
    *reinterpret_cast<uint4*>(out + (size_t)row * H + c) = *reinterpret_cast<const uint4*>(o);
  }
}

template <int BN, int EPI>
cudaError_t launch_gemm(const void* A, const void* B, const void* bias, void* out0, void* out1,
                        int M, int Ncols, int K, uint32_t seed, uint32_t thr, float inv_keep,
                        cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = make_tmap(&ta, A, M, K, BM, BK);
  if (err == cudaSuccess) err = make_tmap(&tb, B, K, Ncols, BK, 64);
  if (err != cudaSuccess) return err;
  return launch(ffn_gemm_kernel<BN, EPI>, dim3(Ncols / BN, (M + BM - 1) / BM), THREADS,
                smem_bytes<BN>(), stream, ta, tb, (const bf16*)bias, (bf16*)out0, (bf16*)out1,
                M, Ncols, K, seed, thr, inv_keep);
}

// the 256-column tile where the output width divides by it
template <int EPI>
cudaError_t gemm(const void* A, const void* B, const void* bias, void* out0, void* out1, int M,
                 int Ncols, int K, uint32_t seed, uint32_t thr, float inv_keep, cudaStream_t s) {
  return Ncols % 256 == 0
             ? launch_gemm<256, EPI>(A, B, bias, out0, out1, M, Ncols, K, seed, thr, inv_keep, s)
             : launch_gemm<128, EPI>(A, B, bias, out0, out1, M, Ncols, K, seed, thr, inv_keep, s);
}

cudaError_t ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                void* y, void* pre, void* h, int N, int H, int F, uint32_t seed, uint32_t thr,
                float inv_keep, cudaStream_t s) {
  cudaError_t err = gemm<BIAS_GELU>(x, w1, b1, pre, h, N, F, H, 0u, 0u, 1.0f, s);
  if (err != cudaSuccess) return err;
  return thr == 0u ? gemm<BIAS>(h, w2, b2, y, nullptr, N, H, F, 0u, 0u, 1.0f, s)
                   : gemm<BIAS_DROPOUT>(h, w2, b2, y, nullptr, N, H, F, seed, thr, inv_keep, s);
}

cudaError_t ln_rows(const void* a, const void* b, const void* g, const void* beta, void* out,
                    int N, int H, float eps, cudaStream_t s) {
  return launch(ln_rows_kernel, dim3((N + LN_WARPS - 1) / LN_WARPS), 32 * LN_WARPS, 0, s,
                (const bf16*)a, (const bf16*)b, (const float*)g, (const float*)beta, (bf16*)out,
                N, H, eps);
}

bool bad_shape(int N, int H, int F) {
  return N < 1 || H < 128 || F < 128 || H % 128 != 0 || F % 128 != 0 ||
         (N + BM - 1) / BM > 65535;
}

}  // namespace

// Returns a cudaError_t code: 0 on launches that were accepted.  thr == 0
// (rate 0) compiles out the dropout; otherwise an entry is kept when its
// bits are >= thr and scaled by inv_keep = 1 / (1 - rate).  h is (N, F)
// scratch for gelu(pre).
extern "C" int dst_ffn_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* y, void* pre, void* h, int N, int H, int F,
                           unsigned int seed, unsigned int thr, float inv_keep, void* stream) {
  if (bad_shape(N, H, F)) return (int)cudaErrorInvalidValue;
  return (int)ffn(x, w1, b1, w2, b2, y, pre, h, N, H, F, seed, thr, inv_keep,
                  (cudaStream_t)stream);
}

// The LN-fused half-layer: x1 = LN1(r); z = ffn(x1) (pre, h as above);
// out = LN2(x1 + z).
extern "C" int dst_ffn_ln_fwd(const void* r, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* g1, const void* be1, const void* g2,
                              const void* be2, void* out, void* x1, void* pre, void* z,
                              void* h, int N, int H, int F, float eps, unsigned int seed,
                              unsigned int thr, float inv_keep, void* stream) {
  if (bad_shape(N, H, F)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = ln_rows(r, nullptr, g1, be1, x1, N, H, eps, s);
  if (err == cudaSuccess) err = ffn(x1, w1, b1, w2, b2, z, pre, h, N, H, F, seed, thr, inv_keep, s);
  if (err == cudaSuccess) err = ln_rows(x1, z, g2, be2, out, N, H, eps, s);
  return (int)err;
}

// The pieces of the two entry points above, one launch each, for timing
// them apart: one GEMM of the pair (epi 0: bias + GELU, out0 = pre and
// out1 = h; 1: bias; 2: bias + dropout), C = A (M, K) . B (K, Ncols), and
// one LayerNorm row pass, out = LN(a + b) (b may be null).
extern "C" int dst_ffn_gemm(const void* A, const void* B, const void* bias, void* out0,
                            void* out1, int M, int Ncols, int K, int epi, unsigned int seed,
                            unsigned int thr, float inv_keep, void* stream) {
  if (bad_shape(M, K, Ncols) || epi < BIAS_GELU || epi > BIAS_DROPOUT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (epi == BIAS_GELU)
    return (int)gemm<BIAS_GELU>(A, B, bias, out0, out1, M, Ncols, K, 0u, 0u, 1.0f, s);
  if (epi == BIAS)
    return (int)gemm<BIAS>(A, B, bias, out0, nullptr, M, Ncols, K, 0u, 0u, 1.0f, s);
  return (int)gemm<BIAS_DROPOUT>(A, B, bias, out0, nullptr, M, Ncols, K, seed, thr, inv_keep, s);
}

// Dynamic shared memory of a GEMM block whose output is ncols wide.
extern "C" long long dst_ffn_gemm_smem(int ncols) {
  return ncols % 256 == 0 ? (long long)smem_bytes<256>() : (long long)smem_bytes<128>();
}

extern "C" int dst_ffn_ln_rows(const void* a, const void* b, const void* g, const void* beta,
                               void* out, int N, int H, float eps, void* stream) {
  if (bad_shape(N, H, 128)) return (int)cudaErrorInvalidValue;
  return (int)ln_rows(a, b, g, beta, out, N, H, eps, (cudaStream_t)stream);
}
