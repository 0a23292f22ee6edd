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
// dq, dk, dv are bf16; every product accumulates in fp32 on the tensor cores
// (mma.sync m16n8k16).  What bounds it on an H100: five L x L x hd products
// on 8 (L, hd) tensors per head, below the bf16 ridge at BERT shapes, so
// device-memory bytes if each input is read once.  Design: the register
// tiles of attention_tiles.cuh in two deterministic kernels, no atomics, so
// every call gives the same bits:
//
//   (a) dq + statistics, one block per (64 query rows, head, sequence), each
//       warp 16 rows, K and V streaming in 64-key tiles (cp.async, two
//       buffers).  Sweep 1: S = Q K^T and dP = G V^T give the rows' max m,
//       sum l and the dsum numerator sum_j dp e^(s - m), both rescaled
//       online as m grows; the dropout keep bits it hashes wait in shared
//       memory, a word per thread and key tile.  Sweep 2 recomputes S and dP
//       sixteen keys at a time, forms ds in registers and accumulates
//       dq += ds K with ds as the A fragment.  Writes dq and (m, l, dsum) as
//       fp32 (B, nh, L) each.
//   (b) dk / dv, one block per (64 key rows, head, sequence), each warp 16
//       keys with their K and V fragments in registers (hd <= 64), Q and G
//       streaming in 64-query tiles with their rows' (m, l, dsum) and
//       dropout keys.  It recomputes the transposed tiles S^T = K Q^T and
//       dP^T = V G^T, and accumulates dv += bf16(pd)^T G and dk += ds^T Q in
//       registers.
//
// No pass holds a (rows, L) tile, so L = 512 runs with the same tiles.  As
// in the forward, p = expf(s - m) / l with s's product and sum rounded
// apart, the plain version's arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

using namespace dst_attn;

namespace {

template <int HDT>
__host__ __device__ inline size_t dq_smem_bytes(int L) {
  // Q, G (Q later dQ), two K and two V tiles, the key bias, each thread's
  // dropout keep bits (a word per key tile)
  return (size_t)6 * TILE * (HDT + PAD) * sizeof(bf16) + (size_t)n_tiles(L) * TILE * sizeof(float) +
         (size_t)n_tiles(L) * THREADS * sizeof(uint32_t);
}

template <int HDT>
__host__ __device__ inline size_t dkdv_smem_bytes() {
  // K, V (later dK, dV), two Q and two G tiles, two tiles' row statistics
  return (size_t)6 * TILE * (HDT + PAD) * sizeof(bf16) + (size_t)2 * 5 * TILE * sizeof(float);
}

// ---------------------------------------------------------------- pass (a)

template <int HDT, bool DROP>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ g, bf16* __restrict__ dq,
                        float* __restrict__ row_max, float* __restrict__ row_sum,
                        float* __restrict__ row_dsum, int L, int hd, float scale,
                        uint32_t seed, uint32_t thr, float inv_keep) {
  constexpr int LD = HDT + PAD, KT = HDT / 16, NT = HDT / 8, STEP = TILE * LD;
  unsigned char* smem = dynamic_smem();
  bf16* sQ = reinterpret_cast<bf16*>(smem);                // (TILE, LD); dQ on the way out
  bf16* sG = sQ + STEP;                                    // (TILE, LD)
  bf16* sK = sG + STEP;                                    // 2 x (TILE, LD)
  bf16* sV = sK + 2 * STEP;                                // 2 x (TILE, LD)
  float* sBias = reinterpret_cast<float*>(sV + 2 * STEP);  // (n_tiles * TILE)
  const int nt = n_tiles(L);
  // keep bits of the thread's 32 entries of key tile t (bit 16 h + 2 n + w
  // for row gid + 8 h, key t TILE + 8 n + 2 tig + w): hashed in sweep 1,
  // read back in sweep 2; only the thread itself touches its words
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sBias + nt * TILE) + threadIdx.x;

  const int b = blockIdx.z, q0 = blockIdx.x * TILE;
  const int bh = b * gridDim.y + blockIdx.y;
  const size_t head = (size_t)bh * L * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16;

  for (int c = threadIdx.x; c < nt * TILE; c += THREADS)
    sBias[c] = c < L ? bias[(size_t)b * L + c] : 0.0f;
  load_tile(sQ, LD, q + head, q0, L, hd);
  load_tile(sG, LD, g + head, q0, L, hd);
  load_tile(sK, LD, k + head, 0, L, hd);
  load_tile(sV, LD, v + head, 0, L, hd);
  cp_async_commit();

  uint32_t rk[2] = {0u, 0u};  // dropout keys of the thread's rows gid, gid + 8
  if (DROP) {
    rk[0] = dst_row_key(seed, bh, q0 + row0 + gid);
    rk[1] = dst_row_key(seed, bh, q0 + row0 + gid + 8);
  }
  uint32_t qa[KT][4], ga[KT][4];
  // m, l and dn = sum_j dp e^(s - m), which ends as dsum = dn / l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, dn[2] = {0.0f, 0.0f};

  // sweep 1 (items 0 .. nt - 1): the statistics, rescaled online
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    const int next = (t + 1) % nt;  // the last item prefetches sweep 2's first
    load_tile(sK + (buf ^ 1) * STEP, LD, k + head, next * TILE, L, hd);
    load_tile(sV + (buf ^ 1) * STEP, LD, v + head, next * TILE, L, hd);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_a<HDT>(qa, sQ, LD, row0, hd, lane);
      load_a<HDT>(ga, sG, LD, row0, hd, lane);
    }
    float s[8][4], d[8][4];
    scores<HDT, 8>(s, qa, sK + buf * STEP, LD, 0, hd, lane);
    scores<HDT, 8>(d, ga, sV + buf * STEP, LD, 0, hd, lane);
    scale_bias_mask(s, sBias, t * TILE, L, scale, tig);
    float mx[2] = {-INFINITY, -INFINITY};
    uint32_t bits = 0u;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (DROP) {
          const int col = t * TILE + n * 8 + 2 * tig + (r & 1);
          const bool keep = dst_bits(rk[r >> 1], col) >= thr;
          d[n][r] = keep ? d[n][r] * inv_keep : 0.0f;
          bits |= (uint32_t)keep << ((r >> 1) * 16 + 2 * n + (r & 1));
        }
        mx[r >> 1] = fmaxf(mx[r >> 1], s[n][r]);
      }
    if (DROP) sKeep[t * THREADS] = bits;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      float sum = 0.0f, num = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 2 * h; r < 2 * h + 2; ++r) {
          const float e = expf(s[n][r] - m_new);  // 0 at masked keys
          sum += e;
          num += d[n][r] * e;
        }
      const float alpha = expf(m[h] - m_new);
      l[h] = l[h] * alpha + quad_sum(sum);
      dn[h] = dn[h] * alpha + quad_sum(num);
      m[h] = m_new;
    }
    __syncthreads();
  }
  const float dsum[2] = {dn[0] / l[0], dn[1] / l[1]};
  const float rl[2] = {1.0f / l[0], 1.0f / l[1]};

  // sweep 2 (items nt .. 2 nt - 1): ds = bf16((p (dp - dsum)) scale) in
  // registers, dq += ds K sixteen keys at a time
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int t = 0; t < nt; ++t) {
    const int buf = (nt + t) & 1;
    if (t + 1 < nt) {
      load_tile(sK + (buf ^ 1) * STEP, LD, k + head, (t + 1) * TILE, L, hd);
      load_tile(sV + (buf ^ 1) * STEP, LD, v + head, (t + 1) * TILE, L, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t bits = DROP ? sKeep[t * THREADS] : 0u;
#pragma unroll
    for (int kc = 0; kc < TILE; kc += 16) {
      float s[2][4], d[2][4];
      scores<HDT, 2>(s, qa, sK + buf * STEP, LD, kc, hd, lane);
      scores<HDT, 2>(d, ga, sV + buf * STEP, LD, kc, hd, lane);
      scale_bias_mask(s, sBias, t * TILE + kc, L, scale, tig);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r >> 1;
          const float p = div_by(expf(s[n][r] - m[h]), l[h], rl[h]);  // 0 at masked keys
          float dp = d[n][r];
          if (DROP) dp = (bits >> (h * 16 + 2 * (kc / 8 + n) + (r & 1))) & 1u ? dp * inv_keep : 0.0f;
          s[n][r] = (p * (dp - dsum[h])) * scale;
        }
      uint32_t dsa[4];
      a_fragment(dsa, s[0], s[1]);
      accumulate<HDT>(acc, dsa, sK + buf * STEP, LD, kc, hd, lane);
    }
    __syncthreads();
  }

  store_rows<HDT>(dq + head, q0 + row0, L, hd, sQ + row0 * LD, LD, acc, lane);
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + row0 + gid + 8 * h;
      if (row < L) {
        row_max[(size_t)bh * L + row] = m[h];
        row_sum[(size_t)bh * L + row] = l[h];
        row_dsum[(size_t)bh * L + row] = dsum[h];
      }
    }
  }
}

// ---------------------------------------------------------------- pass (b)

// the row statistics of query rows [q0, q0 + TILE) into st (m, l, 1 / l,
// dsum, dropout key; TILE each); rows >= L get m = +inf, so their p is 0
template <bool DROP>
__device__ inline void load_stats(float* st, const float* row_max, const float* row_sum,
                                  const float* row_dsum, int bh, int q0, int L, uint32_t seed) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const int i = q0 + r;
    const bool ok = i < L;
    const size_t at = (size_t)bh * L + i;
    st[r] = ok ? row_max[at] : INFINITY;
    const float l = ok ? row_sum[at] : 1.0f;
    st[TILE + r] = l;
    st[2 * TILE + r] = 1.0f / l;
    st[3 * TILE + r] = ok ? row_dsum[at] : 0.0f;
    reinterpret_cast<uint32_t*>(st)[4 * TILE + r] = DROP ? dst_row_key(seed, bh, i) : 0u;
  }
}

template <int HDT, bool DROP>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ g, const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ row_dsum, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int L, int hd, float scale, uint32_t seed,
                          uint32_t thr, float inv_keep) {
  constexpr int LD = HDT + PAD, KT = HDT / 16, NT = HDT / 8, STEP = TILE * LD;
  // the warp's K and V fragments stay in registers where they leave room
  // for the two accumulators; at hd = 128 they are reloaded per chunk
  constexpr bool KV_REGS = HDT <= 64;
  unsigned char* smem = dynamic_smem();
  bf16* sK = reinterpret_cast<bf16*>(smem);                // (TILE, LD); dK on the way out
  bf16* sV = sK + STEP;                                    // (TILE, LD); dV on the way out
  bf16* sQ = sV + STEP;                                    // 2 x (TILE, LD)
  bf16* sG = sQ + 2 * STEP;                                // 2 x (TILE, LD)
  float* sStat = reinterpret_cast<float*>(sG + 2 * STEP);  // 2 x (5, TILE)

  const int b = blockIdx.z, k0 = blockIdx.x * TILE;
  const int bh = b * gridDim.y + blockIdx.y;
  const size_t head = (size_t)bh * L * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16;  // the warp's keys in the block's tile
  const int nt = n_tiles(L);

  load_tile(sK, LD, k + head, k0, L, hd);
  load_tile(sV, LD, v + head, k0, L, hd);
  load_tile(sQ, LD, q + head, 0, L, hd);
  load_tile(sG, LD, g + head, 0, L, hd);
  cp_async_commit();
  load_stats<DROP>(sStat, row_max, row_sum, row_dsum, bh, 0, L, seed);

  // the thread's keys are j = k0 + row0 + gid (+ 8): their bias and index
  int key[2];
  float kb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = k0 + row0 + gid + 8 * h;
    kb[h] = key[h] < L ? bias[(size_t)b * L + key[h]] : 0.0f;
  }
  uint32_t ka[KT][4], va[KT][4];
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dka[n][r] = dva[n][r] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) {
      load_tile(sQ + (buf ^ 1) * STEP, LD, q + head, (t + 1) * TILE, L, hd);
      load_tile(sG + (buf ^ 1) * STEP, LD, g + head, (t + 1) * TILE, L, hd);
    }
    cp_async_commit();
    if (t + 1 < nt)
      load_stats<DROP>(sStat + (buf ^ 1) * 5 * TILE, row_max, row_sum, row_dsum, bh,
                       (t + 1) * TILE, L, seed);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tQ = sQ + buf * STEP;
    const bf16* tG = sG + buf * STEP;
    const float* st = sStat + buf * 5 * TILE;
#pragma unroll
    for (int qc = 0; qc < TILE; qc += 16) {
      if (KV_REGS ? t == 0 && qc == 0 : true) {
        load_a<HDT>(ka, sK, LD, row0, hd, lane);
        load_a<HDT>(va, sV, LD, row0, hd, lane);
      }
      // S^T and dP^T: the warp's 16 keys (rows) x 16 queries (columns)
      float s[2][4], d[2][4];
      scores<HDT, 2>(s, ka, tQ, LD, qc, hd, lane);
      scores<HDT, 2>(d, va, tG, LD, qc, hd, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = qc + n * 8 + 2 * tig;  // the thread's queries c, c + 1 of the tile
        const float2 qm = *reinterpret_cast<const float2*>(st + c);
        const float2 ql = *reinterpret_cast<const float2*>(st + TILE + c);
        const float2 qr = *reinterpret_cast<const float2*>(st + 2 * TILE + c);
        const float2 qd = *reinterpret_cast<const float2*>(st + 3 * TILE + c);
        const uint2 qk = *reinterpret_cast<const uint2*>(st + 4 * TILE + c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r >> 1, w = r & 1;
          const float x = __fadd_rn(__fmul_rn(s[n][r], scale), kb[h]);
          const float p = div_by(expf(x - (w ? qm.y : qm.x)), w ? ql.y : ql.x, w ? qr.y : qr.x);
          float pd = p, dp = d[n][r];
          if (DROP) {
            const bool keep = dst_bits(w ? qk.y : qk.x, key[h]) >= thr;
            pd = keep ? p * inv_keep : 0.0f;
            dp = keep ? dp * inv_keep : 0.0f;
          }
          s[n][r] = pd;
          d[n][r] = (p * (dp - (w ? qd.y : qd.x))) * scale;
        }
      }
      uint32_t pa[4], dsa[4];
      a_fragment(pa, s[0], s[1]);
      a_fragment(dsa, d[0], d[1]);
      accumulate<HDT>(dva, pa, tG, LD, qc, hd, lane);
      accumulate<HDT>(dka, dsa, tQ, LD, qc, hd, lane);
    }
    __syncthreads();
  }

  // the warp read only its own rows of sK and sV
  store_rows<HDT>(dk + head, k0 + row0, L, hd, sK + row0 * LD, LD, dka, lane);
  store_rows<HDT>(dv + head, k0 + row0, L, hd, sV + row0 * LD, LD, dva, lane);
}

template <int HDT, bool DROP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* g, void* dq, void* dk, void* dv, void* stats, int B, int nh,
                       int L, int hd, uint32_t seed, uint32_t thr, float inv_keep,
                       cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)hd));
  float* row_max = (float*)stats;
  float* row_sum = row_max + (size_t)B * nh * L;
  float* row_dsum = row_sum + (size_t)B * nh * L;
  const dim3 grid(n_tiles(L), nh, B);
  cudaError_t err = launch(attention_bwd_dq_kernel<HDT, DROP>, grid, THREADS,
                           dq_smem_bytes<HDT>(L), stream, (const bf16*)q, (const bf16*)k,
                           (const bf16*)v, (const float*)bias, (const bf16*)g, (bf16*)dq,
                           row_max, row_sum, row_dsum, L, hd, scale, seed, thr, inv_keep);
  if (err != cudaSuccess) return err;
  return launch(attention_bwd_dkdv_kernel<HDT, DROP>, grid, THREADS, dkdv_smem_bytes<HDT>(),
                stream, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                (const bf16*)g, (const float*)row_max, (const float*)row_sum,
                (const float*)row_dsum, (bf16*)dk, (bf16*)dv, L, hd, scale, seed, thr,
                inv_keep);
}

// the narrowest register width that holds hd
template <bool DROP>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const void* bias,
                        const void* g, void* dq, void* dk, void* dv, void* stats, int B, int nh,
                        int L, int hd, uint32_t seed, uint32_t thr, float inv_keep,
                        cudaStream_t s) {
  if (hd <= 32)
    return launch_bwd<32, DROP>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd, seed, thr,
                                inv_keep, s);
  if (hd <= 64)
    return launch_bwd<64, DROP>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd, seed, thr,
                                inv_keep, s);
  return launch_bwd<128, DROP>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd, seed, thr,
                               inv_keep, s);
}

}  // namespace

// dq, dk, dv (B, nh, L, hd) bf16 from q, k, v, bias, g; stats is fp32
// scratch of 3 * B * nh * L floats (softmax max, sum and dsum per query row).
// Returns a cudaError_t code: 0 when both kernels' launches were accepted.
extern "C" int dst_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* g, void* dq, void* dk,
                                 void* dv, void* stats, int B, int nh, int L, int hd,
                                 unsigned int seed, unsigned int thr, float inv_keep,
                                 void* stream) {
  if (B < 1 || nh < 1 || L < 1 || L > MAX_L || hd < 16 || hd > MAX_HD || hd % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(thr == 0u
                   ? dispatch_hd<false>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd, 0u,
                                        0u, 1.0f, s)
                   : dispatch_hd<true>(q, k, v, bias, g, dq, dk, dv, stats, B, nh, L, hd, seed,
                                       thr, inv_keep, s));
}

// bytes of dynamic shared memory a block of the dq kernel (pass 0) or of the
// dk / dv kernel (pass 1) takes at (L, hd), for reports
extern "C" long long dst_attention_bwd_smem(int L, int hd, int pass) {
  if (pass == 0)
    return (long long)(hd <= 32   ? dq_smem_bytes<32>(L)
                       : hd <= 64 ? dq_smem_bytes<64>(L)
                                  : dq_smem_bytes<128>(L));
  return (long long)(hd <= 32 ? dkdv_smem_bytes<32>() : hd <= 64 ? dkdv_smem_bytes<64>()
                                                                 : dkdv_smem_bytes<128>());
}
