// Fused multi-head attention forward, with optional dropout, for Hopper.
//
// Replaces the TPU kernel dpr_scale_tpu/ops/attention.py::_fwd_kernel (the
// pallas_call in _fused_attention_fwd_impl):
//
//     p   = softmax(q . k^T / sqrt(hd) + bias)               (fp32)
//     p   = keep ? p / (1 - rate) : 0                        (rate > 0 only)
//     out = bf16( bf16(p) . v )
//
// with q . k^T accumulated in fp32, an fp32 softmax, the dropout applied to
// the fp32 probabilities and the result rounded to bf16 before the P . V
// product, as the TPU kernel does.  Shapes: q, k, v, out (B, nh, L, hd) bf16,
// contiguous; bias (B, 1, L) fp32 additive key mask (0 keep / -1e9 drop).
// The keep bits are counter-based (dropout_bits.cuh), so the backward
// (attention_bwd.cu) regenerates them in its own tiling.
//
// What bounds it on an H100: at BERT shapes (L <= 512, hd = 64) each
// (sequence, head) is two small GEMMs (L x hd x L), so the kernel is bound by
// latency and shared memory, not by the tensor cores.  Design: one block per
// (32-query tile, head, sequence) keeps the whole (32, L) fp32 score tile and
// its bf16 probabilities in shared memory, so nothing bigger than (L, hd)
// touches device memory; K and then V share one shared-memory buffer, which
// keeps L = 512 inside the 227 KB a block may use (with 16-query tiles when
// 32 rows would not fit, as at L = 512, hd = 128).  Both products run on the
// tensor cores through wmma (bf16 in, fp32 accumulate).  No TMA/wgmma yet.
// At rate 0 the dropout branch is compiled out (DROP = false).
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

// fp32 floats per row of the score region, which holds S (TQ, Lp + PAD_F)
// and later O (TQ, hd + PAD_F): wide enough for both, whichever is larger
__host__ __device__ inline int ld_region(int Lp, int hd) {
  return (Lp > hd ? Lp : hd) + PAD_F;
}

__host__ __device__ inline size_t smem_bytes(int tq, int Lp, int hd) {
  const size_t ldh = hd + PAD_H, ldr = ld_region(Lp, hd), ldp = Lp + PAD_H;
  return tq * ldh * 2 + (size_t)Lp * ldh * 2 + tq * ldr * 4 + tq * ldp * 2;
}

// TQ query rows per block
template <int TQ, bool DROP>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, int L, int hd, float scale,
                     uint32_t seed, uint32_t thr, float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Lp = round16(L);
  const int ldh = hd + PAD_H, lds = Lp + PAD_F, ldp = Lp + PAD_H, ldo = hd + PAD_F;
  bf16* sQ = reinterpret_cast<bf16*>(smem);             // (TQ, ldh)
  bf16* sKV = sQ + TQ * ldh;                            // (Lp, ldh): K, then V
  float* sS = reinterpret_cast<float*>(sKV + Lp * ldh); // (TQ, lds); later O (TQ, ldo)
  bf16* sP = reinterpret_cast<bf16*>(sS + TQ * ld_region(Lp, hd));  // (TQ, ldp)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TQ;
  const int bh = b * gridDim.y + h;
  const size_t head = (size_t)bh * (size_t)L * hd;
  const float* bb = bias + (size_t)b * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_rows = min(TQ, L - q0);

  load_rows(sQ, q + head + (size_t)q0 * hd, q_rows, TQ, hd, ldh);
  load_rows(sKV, k + head, L, Lp, hd, ldh);
  __syncthreads();

  // S = Q K^T: K row-major (Lp, hd) is K^T column-major (hd, Lp)
  const int n_ct = Lp / 16, n_kt = hd / 16;
  for (int t = warp; t < (TQ / 16) * n_ct; t += WARPS) {
    const int rt = t / n_ct, ct = t % n_ct;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < n_kt; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, sQ + rt * 16 * ldh + kk * 16, ldh);
      wmma::load_matrix_sync(fb, sKV + ct * 16 * ldh + kk * 16, ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sS + rt * 16 * lds + ct * 16, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();

  // V replaces K; the softmax below touches only sS and sP
  load_rows(sKV, v + head, L, Lp, hd, ldh);

  // fp32 softmax over the L real keys, one warp per row; pad keys get p = 0
  for (int r = warp; r < TQ; r += WARPS) {
    float* srow = sS + r * lds;
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
    bf16* prow = sP + r * ldp;
    if (DROP) {
      const uint32_t rk = dst_row_key(seed, bh, q0 + r);
      for (int c = lane; c < Lp; c += 32) {
        float p = 0.0f;
        if (c < L && dst_bits(rk, c) >= thr) p = (srow[c] / sum) * inv_keep;
        prow[c] = __float2bfloat16(p);
      }
    } else {
      for (int c = lane; c < Lp; c += 32)
        prow[c] = __float2bfloat16(c < L ? srow[c] / sum : 0.0f);
    }
  }
  __syncthreads();

  // O = P V: V row-major (Lp, hd); O reuses the score region, which is
  // sized for it, so the stores never reach sP while other warps read it
  float* sO = sS;
  const int n_ht = hd / 16, n_lk = Lp / 16;
  for (int t = warp; t < (TQ / 16) * n_ht; t += WARPS) {
    const int rt = t / n_ht, nt = t % n_ht;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < n_lk; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sP + rt * 16 * ldp + kk * 16, ldp);
      wmma::load_matrix_sync(fb, sKV + kk * 16 * ldh + nt * 16, ldh);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sO + rt * 16 * ldo + nt * 16, acc, ldo, wmma::mem_row_major);
  }
  __syncthreads();

  bf16* o = out + head + (size_t)q0 * hd;
  for (int i = threadIdx.x; i < q_rows * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    o[(size_t)r * hd + c] = __float2bfloat16(sO[r * ldo + c]);
  }
}

template <int TQ, bool DROP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias,
                       void* out, int B, int nh, int L, int hd, uint32_t seed,
                       uint32_t thr, float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_bytes(TQ, round16(L), hd);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<TQ, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TQ - 1) / TQ, nh, B);
  attention_fwd_kernel<TQ, DROP><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias, (bf16*)out,
      L, hd, (float)(1.0 / sqrt((double)hd)), seed, thr, inv_keep);
  return cudaGetLastError();
}

// 32-query tiles where they fit in shared memory, else 16
template <bool DROP>
cudaError_t dispatch_tq(const void* q, const void* k, const void* v, const void* bias,
                        void* out, int B, int nh, int L, int hd, uint32_t seed,
                        uint32_t thr, float inv_keep, cudaStream_t s) {
  if (smem_bytes(32, round16(L), hd) <= MAX_SMEM)
    return launch_fwd<32, DROP>(q, k, v, bias, out, B, nh, L, hd, seed, thr, inv_keep, s);
  if (smem_bytes(16, round16(L), hd) <= MAX_SMEM)
    return launch_fwd<16, DROP>(q, k, v, bias, out, B, nh, L, hd, seed, thr, inv_keep, s);
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// Returns a cudaError_t code: 0 on a launch that was accepted.  thr == 0
// (rate 0) runs the kernel without dropout; otherwise an entry is kept when
// its bits are >= thr and scaled by inv_keep = 1 / (1 - rate).
extern "C" int dst_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* out, int B, int nh, int L,
                                 int hd, unsigned int seed, unsigned int thr,
                                 float inv_keep, void* stream) {
  if (B < 1 || nh < 1 || L < 1 || L > MAX_L || hd < 16 || hd > MAX_HD || hd % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(thr == 0u
                   ? dispatch_tq<false>(q, k, v, bias, out, B, nh, L, hd, 0u, 0u, 1.0f, s)
                   : dispatch_tq<true>(q, k, v, bias, out, B, nh, L, hd, seed, thr, inv_keep, s));
}
