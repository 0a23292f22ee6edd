// Fused multi-head attention forward, with optional dropout, for Hopper.
//
// Replaces the TPU kernel dpr_scale_tpu/ops/attention.py::_fwd_kernel (the
// pallas_call in _fused_attention_fwd_impl):
//
//     p   = softmax(q . k^T / sqrt(hd) + bias)               (fp32)
//     p   = keep ? p / (1 - rate) : 0                        (rate > 0 only)
//     out = bf16( bf16(p) . v )
//
// with q . k^T accumulated in fp32, an fp32 softmax normalised (e / sum)
// before the dropout and before the bf16 rounding that feeds P . V, as the
// TPU kernel does.  Shapes: q, k, v, out (B, nh, L, hd) bf16, contiguous;
// bias (B, 1, L) fp32 additive key mask (0 keep / -1e9 drop).  The keep bits
// are counter-based (dropout_bits.cuh), so the backward (attention_bwd.cu)
// regenerates them in its own tiling.
//
// What bounds it on an H100: at BERT shapes (L <= 512, hd = 64) the work is
// 4 L^2 hd operations on 8 L hd bytes per head, L / 2 operations a byte,
// below the card's bf16 ridge (~295): device-memory bytes, if q, k, v and
// the bias are read once and out written once.  Design (attention_tiles.cuh):
// one block of 4 warps per (64 query rows, head, sequence), each warp 16
// rows with their Q fragments in registers.  K and V stream through shared
// memory in 64-key tiles, two buffers deep (cp.async), so K and V are read
// once per 64 query rows.  Two sweeps over the key tiles keep the TPU's
// rounding point without holding a score row: the first computes S = Q K^T
// (mma.sync) and the rows' max and sum online; the second recomputes S,
// normalises, drops and rounds p in registers, and feeds the bf16 P
// fragments straight into O += P V.  O stays in registers until one 16-byte
// store per vector.  Key columns >= L inside a tile get p = 0 by a mask.
// The arithmetic of p is the plain version's (expf, the quotient by the sum
// correctly rounded), so p rounds to bf16 where the plain version's does;
// their fp32 bits differ only through the order of the sums.  At rate 0 the
// dropout code is compiled out (DROP = false).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "dropout_bits.cuh"

using namespace dst_attn;

namespace {

template <int HDT>
__host__ __device__ inline size_t smem_bytes(int L) {
  // Q (later O), two K and two V tiles, the key bias
  return (size_t)5 * TILE * (HDT + PAD) * sizeof(bf16) + (size_t)n_tiles(L) * TILE * sizeof(float);
}

template <int HDT, bool DROP>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, int L, int hd, float scale, uint32_t seed,
                     uint32_t thr, float inv_keep) {
  constexpr int LD = HDT + PAD, KT = HDT / 16, NT = HDT / 8, STEP = TILE * LD;
  unsigned char* smem = dynamic_smem();
  bf16* sQ = reinterpret_cast<bf16*>(smem);                // (TILE, LD); O on the way out
  bf16* sK = sQ + STEP;                                    // 2 x (TILE, LD)
  bf16* sV = sK + 2 * STEP;                                // 2 x (TILE, LD)
  float* sBias = reinterpret_cast<float*>(sV + 2 * STEP);  // (n_tiles * TILE)

  const int b = blockIdx.z, q0 = blockIdx.x * TILE;
  const int bh = b * gridDim.y + blockIdx.y;
  const size_t head = (size_t)bh * L * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16;  // the warp's rows in the block's tile
  const int nt = n_tiles(L);

  for (int c = threadIdx.x; c < nt * TILE; c += THREADS)
    sBias[c] = c < L ? bias[(size_t)b * L + c] : 0.0f;
  load_tile(sQ, LD, q + head, q0, L, hd);
  load_tile(sK, LD, k + head, 0, L, hd);
  cp_async_commit();

  uint32_t rk[2] = {0u, 0u};  // dropout keys of the thread's rows gid, gid + 8
  if (DROP) {
    rk[0] = dst_row_key(seed, bh, q0 + row0 + gid);
    rk[1] = dst_row_key(seed, bh, q0 + row0 + gid + 8);
  }
  uint32_t qa[KT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  // sweep 1 (items 0 .. nt - 1: K tiles): the rows' max m and sum l of
  // exp(s - m), rescaled online as m grows
  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) {
      load_tile(sK + (buf ^ 1) * STEP, LD, k + head, (t + 1) * TILE, L, hd);
    } else {  // the second sweep's first tile
      load_tile(sK + (buf ^ 1) * STEP, LD, k + head, 0, L, hd);
      load_tile(sV + (buf ^ 1) * STEP, LD, v + head, 0, L, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) load_a<HDT>(qa, sQ, LD, row0, hd, lane);
    float s[8][4];
    scores<HDT, 8>(s, qa, sK + buf * STEP, LD, 0, hd, lane);
    scale_bias_mask(s, sBias, t * TILE, L, scale, tig);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) sum += expf(s[n][2 * i] - m_new) + expf(s[n][2 * i + 1] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + quad_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();
  }
  const float rl[2] = {1.0f / l[0], 1.0f / l[1]};

  // sweep 2 (items nt .. 2 nt - 1: K and V tiles): p = exp(s - m) / l,
  // dropped and rounded, fed from registers into O += P V
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  for (int t = 0; t < nt; ++t) {
    const int buf = (nt + t) & 1;
    if (t + 1 < nt) {
      load_tile(sK + (buf ^ 1) * STEP, LD, k + head, (t + 1) * TILE, L, hd);
      load_tile(sV + (buf ^ 1) * STEP, LD, v + head, (t + 1) * TILE, L, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    scores<HDT, 8>(s, qa, sK + buf * STEP, LD, 0, hd, lane);
    scale_bias_mask(s, sBias, t * TILE, L, scale, tig);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r >> 1;
        float p = div_by(expf(s[n][r] - m[i]), l[i], rl[i]);  // 0 at masked keys: s = -inf
        if (DROP) {
          const int col = t * TILE + n * 8 + 2 * tig + (r & 1);
          p = dst_bits(rk[i], col) >= thr ? p * inv_keep : 0.0f;
        }
        s[n][r] = p;
      }
#pragma unroll
    for (int kc = 0; kc < TILE / 16; ++kc) {
      uint32_t pa[4];
      a_fragment(pa, s[2 * kc], s[2 * kc + 1]);
      accumulate<HDT>(o, pa, sV + buf * STEP, LD, kc * 16, hd, lane);
    }
    __syncthreads();
  }

  // the warp read only its own rows of sQ, in the first item
  store_rows<HDT>(out + head, q0 + row0, L, hd, sQ + row0 * LD, LD, o, lane);
}

template <int HDT, bool DROP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                       int B, int nh, int L, int hd, uint32_t seed, uint32_t thr, float inv_keep,
                       cudaStream_t stream) {
  return launch(attention_fwd_kernel<HDT, DROP>, dim3(n_tiles(L), nh, B), THREADS,
                smem_bytes<HDT>(L), stream, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                (const float*)bias, (bf16*)out, L, hd, (float)(1.0 / sqrt((double)hd)), seed,
                thr, inv_keep);
}

// the narrowest register width that holds hd
template <bool DROP>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const void* bias, void* out,
                        int B, int nh, int L, int hd, uint32_t seed, uint32_t thr,
                        float inv_keep, cudaStream_t s) {
  if (hd <= 32)
    return launch_fwd<32, DROP>(q, k, v, bias, out, B, nh, L, hd, seed, thr, inv_keep, s);
  if (hd <= 64)
    return launch_fwd<64, DROP>(q, k, v, bias, out, B, nh, L, hd, seed, thr, inv_keep, s);
  return launch_fwd<128, DROP>(q, k, v, bias, out, B, nh, L, hd, seed, thr, inv_keep, s);
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
                   ? dispatch_hd<false>(q, k, v, bias, out, B, nh, L, hd, 0u, 0u, 1.0f, s)
                   : dispatch_hd<true>(q, k, v, bias, out, B, nh, L, hd, seed, thr, inv_keep, s));
}

// bytes of dynamic shared memory a forward block takes at (L, hd), for reports
extern "C" long long dst_attention_fwd_smem(int L, int hd) {
  return (long long)(hd <= 32 ? smem_bytes<32>(L) : hd <= 64 ? smem_bytes<64>(L) : smem_bytes<128>(L));
}
