// Three one-sweep reductions of the inner-product scores of queries q (B, D)
// against corpus rows c (N, D), each an epilogue on the score tiles of
// score_tile.cuh (bf16 on the tensor cores or fp32 on the CUDA cores, fp32
// sums either way).  The (B, N) scores never reach device memory.
//
// Replaces three TPU kernels of dpr_scale_tpu/ops/mips_kernels.py:
//   * count_above_kernel (_count_kernel): out[b] = #{ r : q[b] . c[r] > tau[b] },
//     (B,) int32, any N: the verification pass of MipsIndex method="auto";
//   * groupmax_kernel (_groupmax_kernel): t1[g, b] = max of the scores of rows
//     [8g, 8g + 8), t2[h, b] = max of t1[16h .. 16h + 16), in the JAX layout
//     (groups x queries), N % 128 == 0: the sweep of method="groupmax";
//   * tile_max_scores (_tile_max_kernel): out[b, t] = max of the scores of
//     rows [t * tile, (t + 1) * tile), (B, N / tile), N % tile == 0.
//
// What bounds them on an H100: the B x N x D product at the CLI's query batch
// (B = 512: 1.65 TFLOP over 2M x 768 rows, 1.67 ms of tensor-core time), the
// single read of the corpus at serving batches (B = 64: 3.2 GB, 0.96 ms).
// Design: the TPU grid walked its corpus tiles in order on one core and
// carried the reduction in its output block; here blocks run in parallel.
// A block owns (queries, a span of rows): count_above and groupmax take
// SPAN-row spans, tile_max one whole tile, so its running max is written
// once.  count_above reduces its span's counts in shared memory and makes one
// integer atomicAdd per query (exact and order-free, so the result is
// deterministic).  The query tiles of one span are neighbouring block
// indices, so they run together and read the span's corpus rows from L2.
//
// groupmax on a bf16 corpus whose rows TMA can address (D % 8 == 0, 16-byte
// aligned bases) runs groupmax_wgmma_kernel, on gmax_sweep.cuh's frame: a
// ring of TMA loads (4 stages of a 256-row corpus slice and the block's
// query slice, 64 columns each) feeding two consumer warpgroups on wgmma
// m64nNk16 (queries on M, corpus rows on N, both K-major, fp32 sums in
// registers); per tile each thread takes the max of its two columns of
// every n8 slice, the quad's lanes reduce-scatter the 8-row group maxima
// with shuffles, a 128-row tier-2 maximum is the max of 16 of them and two
// more shuffles, and t1 / t2 are stored from registers, coalesced along the
// query axis of the (groups, B) layout.  B > 64 takes 128-query blocks
// (m64n256 a warpgroup); B <= 64 64-query blocks (m64n128, the warpgroups
// on the two halves of a tile), so the corpus is read once.  Every other
// case (fp32, D % 8 != 0, unaligned) and count_above / tile_max run on
// score_tile.cuh's tile (wmma, synchronous staging): groupmax_kernel
// writes 16 tier-1 maxima and one tier-2 maximum per query and 128-row
// tile through shared memory.  dst_groupmax_route says which one a call
// takes.
#include "gmax_sweep.cuh"  // first: the emulation defines the CUDA keywords there
#include "score_tile.cuh"

#include <limits.h>

using namespace mips_tile;
namespace gs = gmax_sweep;

namespace {

constexpr int SPAN = 2048;       // corpus rows per block of count_above / groupmax
constexpr int GMAX_ROWS = 8;     // rows per tier-1 group
constexpr int GMAX_TIER2 = 16;   // tier-1 groups per tier-2 group
constexpr int T1_PER_TILE = ROWS / GMAX_ROWS;
constexpr int STRIDES = THREADS / QT;  // threads per query in an epilogue
static_assert(ROWS == GMAX_ROWS * GMAX_TIER2, "one tier-2 group per score tile");

template <typename T>
__global__ void __launch_bounds__(THREADS)
count_above_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                   const float* __restrict__ tau, int* __restrict__ out, int B, int D,
                   long long N, int nqt, bool vec_ok) {
  unsigned char* smem = dst_hopper::dynamic_smem();
  const Smem<T> sm(smem);
  int* sCnt = reinterpret_cast<int*>(sm.extra);  // (QT,)
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const long long row0 = (long long)(blockIdx.x / nqt) * SPAN;
  const long long row_end = min(row0 + SPAN, N);
  const int q_valid = min(QT, B - q0);
  const int tid = threadIdx.x, my_q = tid % QT, my_r0 = tid / QT;
  const float my_tau = my_q < q_valid ? tau[q0 + my_q] : 0.0f;
  int my_count = 0;
  if (tid < QT) sCnt[tid] = 0;
  for (long long rbase = row0; rbase < row_end; rbase += ROWS) {
    const int r_valid = (int)min((long long)ROWS, row_end - rbase);
    score_tile(sm, corpus + (size_t)rbase * D, q + (size_t)q0 * D, r_valid, q_valid, D,
               vec_ok);
    for (int r = my_r0; r < r_valid; r += STRIDES) my_count += sm.s[r * LDS + my_q] > my_tau;
  }
  atomicAdd(&sCnt[my_q], my_count);
  __syncthreads();
  if (tid < q_valid) atomicAdd(&out[q0 + tid], sCnt[tid]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
groupmax_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                float* __restrict__ t1, float* __restrict__ t2, int B, int D, long long N,
                int nqt, bool vec_ok) {
  unsigned char* smem = dst_hopper::dynamic_smem();
  const Smem<T> sm(smem);
  float* sT1 = reinterpret_cast<float*>(sm.extra);  // (T1_PER_TILE, QT)
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const long long row0 = (long long)(blockIdx.x / nqt) * SPAN;
  const long long row_end = min(row0 + SPAN, N);
  const int q_valid = min(QT, B - q0);
  const int tid = threadIdx.x, my_q = tid % QT, my_r0 = tid / QT;
  for (long long rbase = row0; rbase < row_end; rbase += ROWS) {
    score_tile(sm, corpus + (size_t)rbase * D, q + (size_t)q0 * D, ROWS, q_valid, D, vec_ok);
    for (int g = my_r0; g < T1_PER_TILE; g += STRIDES) {
      const float* col = sm.s + g * GMAX_ROWS * LDS + my_q;
      float m = col[0];
      for (int r = 1; r < GMAX_ROWS; ++r) m = fmaxf(m, col[r * LDS]);
      sT1[g * QT + my_q] = m;
      if (my_q < q_valid) t1[(size_t)(rbase / GMAX_ROWS + g) * B + q0 + my_q] = m;
    }
    __syncthreads();
    if (tid < q_valid) {
      float m = sT1[tid];
      for (int g = 1; g < T1_PER_TILE; ++g) m = fmaxf(m, sT1[g * QT + tid]);
      t2[(size_t)(rbase / ROWS) * B + q0 + tid] = m;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_max_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                float* __restrict__ out, int B, int D, long long tile, long long ntiles,
                int nqt, bool vec_ok) {
  unsigned char* smem = dst_hopper::dynamic_smem();
  const Smem<T> sm(smem);
  float* sMax = reinterpret_cast<float*>(sm.extra);  // (STRIDES, QT)
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const long long t = blockIdx.x / nqt;
  const long long row_end = (t + 1) * tile;
  const int q_valid = min(QT, B - q0);
  const int tid = threadIdx.x, my_q = tid % QT, my_r0 = tid / QT;
  float my_max = -__int_as_float(0x7f800000);  // -inf
  for (long long rbase = t * tile; rbase < row_end; rbase += ROWS) {
    const int r_valid = (int)min((long long)ROWS, row_end - rbase);
    score_tile(sm, corpus + (size_t)rbase * D, q + (size_t)q0 * D, r_valid, q_valid, D,
               vec_ok);
    for (int r = my_r0; r < r_valid; r += STRIDES) my_max = fmaxf(my_max, sm.s[r * LDS + my_q]);
  }
  sMax[my_r0 * QT + my_q] = my_max;
  __syncthreads();
  if (tid < q_valid) {
    float m = sMax[tid];
    for (int i = 1; i < STRIDES; ++i) m = fmaxf(m, sMax[i * QT + tid]);
    out[(size_t)(q0 + tid) * ntiles + t] = m;
  }
}

// groupmax over a TMA-addressable bf16 corpus (gmax_sweep.cuh); tmQ reads
// the queries (B, D) in (QM, 64) boxes, tmC the corpus (N, D) in (256, 64)
template <int QM>
__global__ void __launch_bounds__(gs::THREADS, 1)
groupmax_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                      const __grid_constant__ CUtensorMap tmC, float* __restrict__ t1,
                      float* __restrict__ t2, int B, int D, long long N, int nqt) {
  using L = gs::Layout<QM>;
  constexpr int STAGE = gs::C_BYTES + L::Q_BYTES;
  constexpr int STAGES = gs::RING_STAGES<STAGE, 0>;
  unsigned char* smem = gs::aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int q0 = (int)(blockIdx.x % nqt) * QM;
  const long long row0 = (long long)(blockIdx.x / nqt) * gs::SPAN;
  const int tiles = gs::span_tiles(row0, N), KT = (D + 63) / 64;
  gs::ring_init(full, empty, STAGES);

  if (wg == 2) {
    // ---- producer: one thread keeps the ring's loads in flight ----
    dst_hopper::setmaxnreg_dec<40>();
    if (t == 0) {
      for (int it = 0; it < tiles * KT; ++it) {
        const int s = it % STAGES, tile = it / KT, col = (it % KT) * 64;
        dst_hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // first use passes
        unsigned char* st = smem + s * STAGE;
        dst_hopper::mbar_arrive_expect_tx(&full[s], STAGE);
        dst_hopper::tma_load(st, &tmC, (int)(row0 + tile * gs::TILE), col, &full[s]);
        dst_hopper::tma_load(st + gs::C_BYTES, &tmQ, q0, col, &full[s]);
      }
    }
    return;
  }
  // ---- consumers: warpgroup wg's queries against its rows of each tile ----
  dst_hopper::setmaxnreg_inc<232>();
  const int warp = t / 32, lane = t % 32;
  const int qa = q0 + L::q_off(wg) + 16 * warp + lane / 4;  // this thread's rows qa, qa + 8
  float acc[L::N / 2];
  int it = 0;
  for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
    for (int i = 0; i < L::N / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      dst_hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * STAGE;
      dst_hopper::fence_operands(acc);
      dst_hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // both K-major: 128-byte rows, 8-row groups 1024 bytes apart, a
        // k-step of 16 columns 32 bytes on
        const uint64_t da =
            dst_hopper::smem_desc(st + gs::C_BYTES + L::q_off(wg) * gs::SLICE + kk * 32, 16, 1024);
        const uint64_t db = dst_hopper::smem_desc(st + L::r_off(wg) * gs::SLICE + kk * 32, 16, 1024);
        dst_hopper::wgmma_tn_bf16<L::N>(acc, da, db);
      }
      dst_hopper::wgmma_commit();
      dst_hopper::fence_operands(acc);
      dst_hopper::wgmma_wait<1>();  // the previous stage's products have retired
      dst_hopper::fence_operands(acc);
      if (kt > 0 && lane == 0) dst_hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    dst_hopper::wgmma_wait<0>();
    dst_hopper::fence_operands(acc);
    if (lane == 0) dst_hopper::mbar_arrive(&empty[(it - 1) % STAGES]);

    // ---- epilogue: group maxima in registers, stored from them ----
    const long long rbase = row0 + (long long)tile * gs::TILE + L::r_off(wg);
    float m[L::NJ][2], r[L::NJ / 4][2];
#pragma unroll
    for (int j = 0; j < L::NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) m[j][h] = fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    gs::quad_max_scatter<L::NJ>(m, r, lane);
#pragma unroll
    for (int k = 0; k < L::NJ / 4; ++k) {
      const long long g = rbase / GMAX_ROWS + 4 * k + (lane & 3);
      if (g * GMAX_ROWS < N) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (qa + 8 * h < B) t1[g * B + qa + 8 * h] = r[k][h];
      }
    }
#pragma unroll
    for (int H = 0; H < L::N / ROWS; ++H) {  // the 128-row tier-2 groups: k in [4 H, 4 H + 4)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaxf(fmaxf(r[4 * H][h], r[4 * H + 1][h]), fmaxf(r[4 * H + 2][h], r[4 * H + 3][h]));
        x = fmaxf(x, __shfl_xor_sync(gs::FULL_MASK, x, 1));
        x = fmaxf(x, __shfl_xor_sync(gs::FULL_MASK, x, 2));
        const long long g2 = rbase / ROWS + H;
        if ((lane & 3) == h && g2 * ROWS < N && qa + 8 * h < B) t2[g2 * B + qa + 8 * h] = x;
      }
    }
  }
}

template <typename T>
int launch_count(const void* q, const void* corpus, const void* tau, void* out, int B,
                 long long N, int D, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + QT * 4;
  const int nqt = (B + QT - 1) / QT;
  const long long blocks = (N + SPAN - 1) / SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(count_above_kernel<T>, dim3((unsigned)blocks), THREADS, smem,
                                 stream, (const T*)q, (const T*)corpus, (const float*)tau,
                                 (int*)out, B, D, N, nqt, vectorizable<T>(q, corpus, D));
}

template <typename T>
int launch_groupmax(const void* q, const void* corpus, void* t1, void* t2, int B, long long N,
                    int D, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + T1_PER_TILE * QT * 4;
  const int nqt = (B + QT - 1) / QT;
  const long long blocks = (N + SPAN - 1) / SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(groupmax_kernel<T>, dim3((unsigned)blocks), THREADS, smem, stream,
                                 (const T*)q, (const T*)corpus, (float*)t1, (float*)t2, B, D, N,
                                 nqt, vectorizable<T>(q, corpus, D));
}

template <int QM>
constexpr size_t wgmma_smem() {
  constexpr int STAGE = gs::C_BYTES + gs::Layout<QM>::Q_BYTES;
  return gs::smem_bytes(gs::RING_STAGES<STAGE, 0>, STAGE, 0);
}

template <int QM>
int launch_groupmax_wgmma(const void* q, const void* corpus, void* t1, void* t2, int B,
                          long long N, int D, cudaStream_t stream) {
  const int nqt = (B + QM - 1) / QM;
  const long long blocks = (N + gs::SPAN - 1) / gs::SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tc;
  cudaError_t err = dst_hopper::make_tmap(&tq, q, B, D, QM, 64);
  if (err == cudaSuccess) err = dst_hopper::make_tmap(&tc, corpus, N, D, gs::TILE, 64);
  if (err != cudaSuccess) return (int)err;
  return (int)dst_hopper::launch(groupmax_wgmma_kernel<QM>, dim3((unsigned)blocks), gs::THREADS,
                                 wgmma_smem<QM>(), stream, tq, tc, (float*)t1, (float*)t2, B, D,
                                 N, nqt);
}

// 1 where dst_groupmax runs groupmax_wgmma_kernel: a bf16 corpus whose row
// stride TMA can address; 0 for groupmax_kernel (score_tile.cuh)
int wgmma_route(const void* q, const void* corpus, long long N, int D, int dtype) {
  return dtype == 0 && D % 8 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)corpus % 16 == 0 &&
         N <= INT_MAX;
}

template <typename T>
int launch_tile_max(const void* q, const void* corpus, void* out, int B, long long N, int D,
                    long long tile, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + STRIDES * QT * 4;
  const int nqt = (B + QT - 1) / QT;
  const long long ntiles = N / tile;
  if (ntiles * nqt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(tile_max_kernel<T>, dim3((unsigned)(ntiles * nqt)), THREADS,
                                 smem, stream, (const T*)q, (const T*)corpus, (float*)out, B, D,
                                 tile, ntiles, nqt, vectorizable<T>(q, corpus, D));
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (queries and corpus alike).  Each returns a
// cudaError_t code: 0 on a launch that was accepted.

// out (B,) int32 must hold zeros: the blocks add their counts into it.
extern "C" int dst_count_above(const void* q, const void* corpus, const void* tau, void* out,
                               int B, long long N, int D, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_count<bf16>(q, corpus, tau, out, B, N, D, (cudaStream_t)stream);
  if (dtype == 1) return launch_count<float>(q, corpus, tau, out, B, N, D, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// t1 (N / 8, B) and t2 (N / 128, B) fp32.  The route is chosen by shape
// alone (dst_groupmax_route); a failed tensor-map encode returns its code.
extern "C" int dst_groupmax(const void* q, const void* corpus, void* t1, void* t2, int B,
                            long long N, int D, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1 || N % ROWS != 0) return (int)cudaErrorInvalidValue;
  if (wgmma_route(q, corpus, N, D, dtype))
    return B > 64 ? launch_groupmax_wgmma<128>(q, corpus, t1, t2, B, N, D, (cudaStream_t)stream)
                  : launch_groupmax_wgmma<64>(q, corpus, t1, t2, B, N, D, (cudaStream_t)stream);
  if (dtype == 0) return launch_groupmax<bf16>(q, corpus, t1, t2, B, N, D, (cudaStream_t)stream);
  if (dtype == 1) return launch_groupmax<float>(q, corpus, t1, t2, B, N, D, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// 1: dst_groupmax takes the wgmma kernel on these arguments; 0: score_tile.
extern "C" int dst_groupmax_route(const void* q, const void* corpus, long long N, int D,
                                  int dtype) {
  return wgmma_route(q, corpus, N, D, dtype);
}

// Dynamic shared memory of a wgmma groupmax block at batch B.
extern "C" long long dst_groupmax_smem(int B) {
  return (long long)(B > 64 ? wgmma_smem<128>() : wgmma_smem<64>());
}

// out (B, N / tile) fp32.
extern "C" int dst_tile_max(const void* q, const void* corpus, void* out, int B, long long N,
                            int D, long long tile, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1 || tile < 1 || N % tile != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_tile_max<bf16>(q, corpus, out, B, N, D, tile, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_tile_max<float>(q, corpus, out, B, N, D, tile, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
