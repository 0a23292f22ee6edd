// Fused multi-head attention backward, with optional dropout, for Hopper.
//
// Replaces the TPU kernel dpr_scale_tpu/ops/attention.py::_bwd_kernel (the
// pallas_call in _fused_attention_bwd).  From q, k, v (B, nh, L, hd) bf16,
// the key bias (B, 1, L) fp32, the output cotangent g (B, nh, L, hd) bf16 and
// the forward's dropout seed it recomputes the softmax and regenerates the
// keep bits (dropout_bits.cuh), then computes what _bwd_kernel computes:
//
//     p    = softmax(q . k^T * scale + bias)                   fp32, full
//     pd   = keep ? p / (1 - rate) : 0                         (p at rate 0)
//     dv   = bf16(pd)^T . g
//     dp   = keep ? (g . v^T) / (1 - rate) : 0                 (g . v^T at rate 0)
//     dsum = sum_j dp * p          (the full p: dropped entries keep -p * dsum)
//     ds   = bf16((p * (dp - dsum)) * scale)
//     dq   = ds . k,   dk = ds^T . q
//
// dq, dk, dv are bf16, every product accumulates in fp32 on the tensor cores
// (wmma).  What bounds it on an H100: like the forward, small per-(sequence,
// head) GEMMs, so latency and shared memory.  The TPU kernel holds a whole
// (L, L) problem per grid step; a Hopper block has 227 KB, and blocks run in
// no order, so the work is split in two deterministic passes with no
// atomics:
//
//   (a) dq pass, one block per (query tile, head, sequence): the (TQ, L)
//       fp32 P row block, dp, dsum and ds stay in shared memory; it writes
//       dq and, per query row, the softmax max and sum and dsum (fp32
//       (B, nh, L) each).  TQ is 32, or 16 when 32 rows would not fit
//       (L > 256 at hd = 64), so L = 512 fits.
//   (b) dk/dv pass, one block per (32-key tile, head, sequence): it walks the
//       query tiles of 64 rows, recomputes the P^T tile from those
//       statistics, regenerates the keep bits by counter and accumulates dk
//       and dv in fp32 in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

using namespace nvcuda;
using namespace dst_attn;

namespace {

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

// C (rows, cols) = A (rows, depth) . B^T with A, B row-major bf16 tiles;
// every 16 x 16 output tile is one warp's, at the given fp32 stride
__device__ inline void gemm_abt(float* C, int ldc, const bf16* A, int lda,
                                const bf16* Bm, int ldb, int rows, int cols, int depth,
                                int warp) {
  const int n_ct = cols / 16;
  for (int t = warp; t < (rows / 16) * n_ct; t += WARPS) {
    const int rt = t / n_ct, ct = t % n_ct;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < depth / 16; ++kk) {
      ARow fa;
      BCol fb;
      wmma::load_matrix_sync(fa, A + rt * 16 * lda + kk * 16, lda);
      wmma::load_matrix_sync(fb, Bm + ct * 16 * ldb + kk * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(C + rt * 16 * ldc + ct * 16, acc, ldc, wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------- pass (a)

__host__ __device__ inline int ld_region(int Lp, int hd) {
  return (Lp > hd ? Lp : hd) + PAD_F;
}

__host__ __device__ inline size_t dq_smem_bytes(int tq, int Lp, int hd) {
  const size_t ldh = hd + PAD_H;
  return 2 * (size_t)tq * ldh * 2               // Q, G
         + (size_t)Lp * ldh * 2                 // K / V / K
         + (size_t)tq * ld_region(Lp, hd) * 4   // S -> P; later dQ
         + (size_t)tq * (Lp + PAD_F) * 4        // g . v^T -> dp
         + (size_t)tq * (Lp + PAD_H) * 2;       // ds (bf16)
}

template <int TQ, bool DROP>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ g, bf16* __restrict__ dq,
                        float* __restrict__ row_max, float* __restrict__ row_sum,
                        float* __restrict__ row_dsum, int L, int hd, float scale,
                        uint32_t seed, uint32_t thr, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Lp = round16(L);
  const int ldh = hd + PAD_H, ldr = ld_region(Lp, hd), ldd = Lp + PAD_F;
  const int ldb = Lp + PAD_H, ldo = hd + PAD_F;
  bf16* sQ = reinterpret_cast<bf16*>(smem);               // (TQ, ldh)
  bf16* sG = sQ + TQ * ldh;                               // (TQ, ldh)
  bf16* sKV = sG + TQ * ldh;                              // (Lp, ldh)
  float* sS = reinterpret_cast<float*>(sKV + Lp * ldh);   // (TQ, ldr): S, P; dQ (TQ, ldo)
  float* sD = sS + TQ * ldr;                              // (TQ, ldd)
  bf16* sDS = reinterpret_cast<bf16*>(sD + TQ * ldd);     // (TQ, ldb)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int bh = b * gridDim.y + h;
  const size_t head = (size_t)bh * (size_t)L * hd;
  const float* bb = bias + (size_t)b * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_rows = min(TQ, L - q0);

  load_rows(sQ, q + head + (size_t)q0 * hd, q_rows, TQ, hd, ldh);
  load_rows(sG, g + head + (size_t)q0 * hd, q_rows, TQ, hd, ldh);
  load_rows(sKV, k + head, L, Lp, hd, ldh);
  __syncthreads();

  gemm_abt(sS, ldr, sQ, ldh, sKV, ldh, TQ, Lp, hd, warp);  // S = Q K^T
  __syncthreads();

  load_rows(sKV, v + head, L, Lp, hd, ldh);  // V replaces K
  // fp32 softmax in place, one warp per row; the statistics go to (B, nh, L)
  for (int r = warp; r < TQ; r += WARPS) {
    float* srow = sS + r * ldr;
    float m = -INFINITY;
    for (int c = lane; c < L; c += 32) {
      const float s = srow[c] * scale + bb[c];
      srow[c] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < Lp; c += 32) srow[c] = c < L ? srow[c] / sum : 0.0f;
    if (lane == 0 && r < q_rows) {
      row_max[(size_t)bh * L + q0 + r] = m;
      row_sum[(size_t)bh * L + q0 + r] = sum;
    }
  }
  __syncthreads();

  gemm_abt(sD, ldd, sG, ldh, sKV, ldh, TQ, Lp, hd, warp);  // g . v^T
  __syncthreads();

  load_rows(sKV, k + head, L, Lp, hd, ldh);  // K again, for dq = ds . k
  for (int r = warp; r < TQ; r += WARPS) {
    const float* prow = sS + r * ldr;
    float* drow = sD + r * ldd;
    float dsum = 0.0f;
    if (DROP) {
      const uint32_t rk = dst_row_key(seed, bh, q0 + r);
      for (int c = lane; c < L; c += 32) {
        const float dp = dst_bits(rk, c) >= thr ? drow[c] * inv_keep : 0.0f;
        drow[c] = dp;
        dsum += dp * prow[c];
      }
    } else {
      for (int c = lane; c < L; c += 32) dsum += drow[c] * prow[c];
    }
    dsum = warp_sum(dsum);
    bf16* dsrow = sDS + r * ldb;
    for (int c = lane; c < Lp; c += 32)
      dsrow[c] = __float2bfloat16(c < L ? (prow[c] * (drow[c] - dsum)) * scale : 0.0f);
    if (lane == 0 && r < q_rows) row_dsum[(size_t)bh * L + q0 + r] = dsum;
  }
  __syncthreads();

  // dQ = dS K: K row-major (Lp, hd); dQ reuses the S region (sized for it)
  float* sO = sS;
  const int n_ht = hd / 16;
  for (int t = warp; t < (TQ / 16) * n_ht; t += WARPS) {
    const int rt = t / n_ht, nt = t % n_ht;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Lp / 16; ++kk) {
      ARow fa;
      BRow fb;
      wmma::load_matrix_sync(fa, sDS + rt * 16 * ldb + kk * 16, ldb);
      wmma::load_matrix_sync(fb, sKV + kk * 16 * ldh + nt * 16, ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sO + rt * 16 * ldo + nt * 16, acc, ldo, wmma::mem_row_major);
  }
  __syncthreads();

  bf16* o = dq + head + (size_t)q0 * hd;
  for (int i = threadIdx.x; i < q_rows * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    o[(size_t)r * hd + c] = __float2bfloat16(sO[r * ldo + c]);
  }
}

// ---------------------------------------------------------------- pass (b)

constexpr int TK = 32;   // key rows per block
constexpr int TQB = 64;  // query rows per step of the block's loop

__host__ __device__ inline size_t dkdv_smem_bytes(int hd) {
  const size_t ldh = hd + PAD_H;
  return 2 * (size_t)TK * ldh * 2               // K, V
         + 2 * (size_t)TQB * ldh * 2            // Q, G
         + 2 * (size_t)TQB * (TK + PAD_F) * 4   // S, g . v^T
         + 2 * (size_t)TQB * (TK + PAD_H) * 2   // pd, ds (bf16)
         + 2 * (size_t)TK * (hd + PAD_F) * 4    // dK, dV accumulators
         + 4 * (size_t)TQB * 4;                 // max, sum, dsum, row keys
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ g, const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ row_dsum, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int L, int hd, float scale,
                          uint32_t seed, uint32_t thr, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = hd + PAD_H, ldt = TK + PAD_F, ldtb = TK + PAD_H, ldo = hd + PAD_F;
  bf16* sK = reinterpret_cast<bf16*>(smem);             // (TK, ldh)
  bf16* sV = sK + TK * ldh;                             // (TK, ldh)
  bf16* sQ = sV + TK * ldh;                             // (TQB, ldh)
  bf16* sG = sQ + TQB * ldh;                            // (TQB, ldh)
  float* sS = reinterpret_cast<float*>(sG + TQB * ldh); // (TQB, ldt)
  float* sDP = sS + TQB * ldt;                          // (TQB, ldt)
  bf16* sPD = reinterpret_cast<bf16*>(sDP + TQB * ldt); // (TQB, ldtb)
  bf16* sDS = sPD + TQB * ldtb;                         // (TQB, ldtb)
  float* sdK = reinterpret_cast<float*>(sDS + TQB * ldtb);  // (TK, ldo)
  float* sdV = sdK + TK * ldo;                          // (TK, ldo)
  float* sM = sdV + TK * ldo;                           // (TQB)
  float* sL = sM + TQB;
  float* sDsum = sL + TQB;
  uint32_t* sRK = reinterpret_cast<uint32_t*>(sDsum + TQB);

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * TK;
  const int bh = b * gridDim.y + h;
  const size_t head = (size_t)bh * (size_t)L * hd;
  const float* bb = bias + (size_t)b * L;
  const int warp = threadIdx.x / 32;
  const int k_rows = min(TK, L - k0);

  load_rows(sK, k + head + (size_t)k0 * hd, k_rows, TK, hd, ldh);
  load_rows(sV, v + head + (size_t)k0 * hd, k_rows, TK, hd, ldh);
  for (int i = threadIdx.x; i < 2 * TK * ldo; i += THREADS) sdK[i] = 0.0f;  // dK, dV

  const int n_ot = (TK / 16) * (hd / 16);  // output tiles of dK (and of dV)
  for (int q0 = 0; q0 < L; q0 += TQB) {
    const int q_rows = min(TQB, L - q0);
    load_rows(sQ, q + head + (size_t)q0 * hd, q_rows, TQB, hd, ldh);
    load_rows(sG, g + head + (size_t)q0 * hd, q_rows, TQB, hd, ldh);
    for (int r = threadIdx.x; r < TQB; r += THREADS) {
      const bool ok = r < q_rows;
      const size_t at = (size_t)bh * L + q0 + r;
      sM[r] = ok ? row_max[at] : 0.0f;
      sL[r] = ok ? row_sum[at] : 1.0f;
      sDsum[r] = ok ? row_dsum[at] : 0.0f;
      if (DROP) sRK[r] = dst_row_key(seed, bh, q0 + r);
    }
    __syncthreads();

    // S = Q K^T and g . v^T for this (query tile, key tile)
    gemm_abt(sS, ldt, sQ, ldh, sK, ldh, TQB, TK, hd, warp);
    gemm_abt(sDP, ldt, sG, ldh, sV, ldh, TQB, TK, hd, warp);
    __syncthreads();

    for (int i = threadIdx.x; i < TQB * TK; i += THREADS) {
      const int r = i / TK, c = i % TK, j = k0 + c;
      float pd = 0.0f, ds = 0.0f;
      if (r < q_rows && j < L) {
        const float p = expf(sS[r * ldt + c] * scale + bb[j] - sM[r]) / sL[r];
        float dp = sDP[r * ldt + c];
        pd = p;
        if (DROP) {
          const bool keep = dst_bits(sRK[r], j) >= thr;
          pd = keep ? p * inv_keep : 0.0f;
          dp = keep ? dp * inv_keep : 0.0f;
        }
        ds = (p * (dp - sDsum[r])) * scale;
      }
      sPD[r * ldtb + c] = __float2bfloat16(pd);
      sDS[r * ldtb + c] = __float2bfloat16(ds);
    }
    __syncthreads();

    // dV += pd^T g and dK += ds^T q; pd, ds (TQB, TK) row-major are their
    // transposes column-major; each accumulator tile stays with one warp
    for (int t = warp; t < 2 * n_ot; t += WARPS) {
      const bool is_v = t < n_ot;
      const int u = is_v ? t : t - n_ot;
      const int rt = u / (hd / 16), nt = u % (hd / 16);
      float* C = (is_v ? sdV : sdK) + rt * 16 * ldo + nt * 16;
      const bf16* A = is_v ? sPD : sDS;
      const bf16* Bm = is_v ? sG : sQ;
      Acc acc;
      wmma::load_matrix_sync(acc, C, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < TQB / 16; ++kk) {
        ACol fa;
        BRow fb;
        wmma::load_matrix_sync(fa, A + kk * 16 * ldtb + rt * 16, ldtb);
        wmma::load_matrix_sync(fb, Bm + kk * 16 * ldh + nt * 16, ldh);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(C, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  bf16* odk = dk + head + (size_t)k0 * hd;
  bf16* odv = dv + head + (size_t)k0 * hd;
  for (int i = threadIdx.x; i < k_rows * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    odk[(size_t)r * hd + c] = __float2bfloat16(sdK[r * ldo + c]);
    odv[(size_t)r * hd + c] = __float2bfloat16(sdV[r * ldo + c]);
  }
}

template <int TQ, bool DROP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* g, void* dq, void* dk, void* dv, void* stats, int B,
                       int nh, int L, int hd, uint32_t seed, uint32_t thr,
                       float inv_keep, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)hd));
  float* row_max = (float*)stats;
  float* row_sum = row_max + (size_t)B * nh * L;
  float* row_dsum = row_sum + (size_t)B * nh * L;

  const size_t smem_a = dq_smem_bytes(TQ, round16(L), hd);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<TQ, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<TQ, DROP><<<dim3((L + TQ - 1) / TQ, nh, B), THREADS, smem_a, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias, (const bf16*)g,
      (bf16*)dq, row_max, row_sum, row_dsum, L, hd, scale, seed, thr, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_b = dkdv_smem_bytes(hd);
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<DROP><<<dim3((L + TK - 1) / TK, nh, B), THREADS, smem_b, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias, (const bf16*)g,
      row_max, row_sum, row_dsum, (bf16*)dk, (bf16*)dv, L, hd, scale, seed, thr, inv_keep);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch_tq(const void* q, const void* k, const void* v, const void* bias,
                        const void* g, void* dq, void* dk, void* dv, void* stats, int B,
                        int nh, int L, int hd, uint32_t seed, uint32_t thr,
                        float inv_keep, cudaStream_t s) {
  if (dq_smem_bytes(32, round16(L), hd) <= MAX_SMEM)
    return launch_bwd<32, DROP>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd, seed,
                                thr, inv_keep, s);
  if (dq_smem_bytes(16, round16(L), hd) <= MAX_SMEM)
    return launch_bwd<16, DROP>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd, seed,
                                thr, inv_keep, s);
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// dq, dk, dv (B, nh, L, hd) bf16 from q, k, v, bias, g; stats is fp32
// scratch of 3 * B * nh * L floats (softmax max, sum and dsum per query row).
// Returns a cudaError_t code: 0 when both passes' launches were accepted.
extern "C" int dst_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* g, void* dq, void* dk,
                                 void* dv, void* stats, int B, int nh, int L, int hd,
                                 unsigned int seed, unsigned int thr, float inv_keep,
                                 void* stream) {
  if (B < 1 || nh < 1 || L < 1 || L > MAX_L || hd < 16 || hd > MAX_HD || hd % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(thr == 0u
                   ? dispatch_tq<false>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd,
                                        0u, 0u, 1.0f, s)
                   : dispatch_tq<true>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd,
                                       seed, thr, inv_keep, s));
}
