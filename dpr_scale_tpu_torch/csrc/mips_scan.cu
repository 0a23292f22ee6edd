// Three one-sweep reductions of the inner-product scores of queries q (B, D)
// against corpus rows c (N, D), each an epilogue on the wgmma accumulators
// of gmax_sweep.cuh's frame (bf16 rows TMA can address) or on the score
// tiles of score_tile.cuh (bf16 on the tensor cores or fp32 on the CUDA
// cores), fp32 sums either way.  The (B, N) scores never reach device
// memory.
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
// spans of up to SPAN rows, tile_max whole tiles, so a tile's running max
// is written once.  count_above adds its counts into the output with integer atomics,
// one per query and block (and warpgroup in the 64-query layout below):
// exact and order-free, so the result is deterministic.  The query tiles
// of one span are neighbouring block indices, so they run together and
// read the span's corpus rows from L2.
//
// Three routes, chosen by shape in each entry point (dst_groupmax_route /
// dst_count_above_route / dst_tile_max_route say which a call takes):
//   1  a bf16 corpus whose rows TMA can address (D % 8 == 0, 16-byte
//      aligned bases; tile_max: tiles of a multiple of 256 rows):
//      groupmax_wgmma_kernel, count_above_wgmma_kernel and
//      tile_max_wgmma_kernel on gmax_sweep.cuh's frame, a ring of TMA loads
//      (4 stages of a 256-row corpus slice and the block's query slice, 64
//      columns each) feeding two consumer warpgroups on wgmma m64nNk16
//      (queries on M, corpus rows on N, both K-major, fp32 sums in
//      registers): the `groupmax` and `auto` searches over bert_base /
//      bert_large / SPAR rows;
//   2  the same kernels over rows TMA cannot address, D even and 4-byte
//      aligned bases, the ring fed by the producer warpgroup's 4-byte
//      cp.async copies in TMA's swizzled layout: SPLADE's D = 30,522
//      (task.model.family=splade with mips_method groupmax or auto);
//   0  everything else (fp32, odd D, unaligned bases, tile_max's other
//      tiles): score_tile.cuh's tile (wmma, synchronous staging; a 128 x 64
//      fp32 score tile in shared memory, reduced by strided columns).  No
//      CLI builds an fp32 MipsIndex and no configuration has an odd D.
// On the wgmma frame, groupmax: per tile each thread takes the max of its
// two columns of every n8 slice, the quad's lanes reduce-scatter the 8-row
// group maxima with shuffles, a 128-row tier-2 maximum is the max of 16 of
// them and two more shuffles, and t1 / t2 are stored from registers,
// coalesced along the query axis of the (groups, B) layout.  count_above:
// each thread counts its scores above its two queries' thresholds in
// registers over the whole span (rows past N masked), then two shuffles
// sum the quad and one atomicAdd a query adds it (gmax_sweep.cuh's
// count_sweep, one group of all N rows).  Both take 2,048-row spans, cut in
// whole 256-row tiles while the grid is smaller than the card (fill_span:
// 256 x 1,280 SPLADE rows make 20 blocks, not 4).  tile_max: a block's
// span is whole tiles (one tile of 4,096 rows; tiles of at most 2,048 rows
// as many as fit in 2,048), each thread carries the running max of its two
// query rows' scores over a tile's 256-row units in registers, and at the
// tile's end two quad shuffles give the tile's maxima, stored once (no
// atomics: deterministic).  B > 64 takes 128-query blocks (m64n256 a
// warpgroup) up to D = 1,536; B <= 64, and any B past it (the promoted
// sums), 64-query blocks (m64n128, the warpgroups on the two halves of a
// tile, whose tile_max maxima meet in shared memory), so the corpus is read
// once per 64 or 128 queries.  What bounds routes 1 and 2 on an H100: the
// product or the corpus read above (at SPLADE's width, B = 256 over 65,536
// rows, the 4.0 GB read: 1.19 ms); route 2 also issues 32 copies a
// 128-byte row slice from its producer warpgroup, where TMA issues one box
// a stage.  Route 0 alternates loads and MMAs and is bound by that, not by
// the card.
#include "gmax_sweep.cuh"  // first: the emulation defines the CUDA keywords there
#include "score_tile.cuh"

using namespace mips_tile;
namespace gs = gmax_sweep;

namespace {

constexpr int SPAN = gs::SPAN;   // corpus rows per block of count_above / groupmax
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

// groupmax over a bf16 corpus on gmax_sweep.cuh's frame, fed by TMA (CP
// false) or cp.async (CP true; gs::Ring<CP>)
template <int QM, bool CP>
__global__ void __launch_bounds__(gs::THREADS, 1)
groupmax_wgmma_kernel(const __grid_constant__ gs::Ring<CP> ring, float* __restrict__ t1,
                      float* __restrict__ t2, int B, int D, long long N, int nqt, long long span) {
  using L = gs::Layout<QM>;
  const int lane = threadIdx.x % 32, qa = gs::query_row<QM>(nqt);  // rows qa, qa + 8
  gs::bf16_sweep<QM, CP>(ring, B, D, N, nqt, span, [&](const float (&acc)[L::N / 2],
                                                       long long rbase) {
    // ---- epilogue: group maxima in registers, stored from them ----
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
        float x = fmaxf(fmaxf(r[4 * H][h], r[4 * H + 1][h]),
                        fmaxf(r[4 * H + 2][h], r[4 * H + 3][h]));
        x = fmaxf(x, __shfl_xor_sync(gs::FULL_MASK, x, 1));
        x = fmaxf(x, __shfl_xor_sync(gs::FULL_MASK, x, 2));
        const long long g2 = rbase / ROWS + H;
        if ((lane & 3) == h && g2 * ROWS < N && qa + 8 * h < B) t2[g2 * B + qa + 8 * h] = x;
      }
    }
  });
}

// count_above over a bf16 corpus on gmax_sweep.cuh's frame (either
// producer): the count epilogue with one group of all N rows (any N; out
// (B,) zeroed)
template <int QM, bool CP>
__global__ void __launch_bounds__(gs::THREADS, 1)
count_above_wgmma_kernel(const __grid_constant__ gs::Ring<CP> ring, const float* __restrict__ tau,
                         int* __restrict__ out, int B, int D, long long N, int nqt,
                         long long span) {
  gs::count_sweep<QM, CP>(ring, tau, out, B, D, N, nqt, span, N, 1);
}

// 64 floats past the ring: the maxima the QM = 64 layout's second
// warpgroup hands to the first
constexpr int TILE_MAX_EXTRA = 64 * 4;
static_assert(gs::bf16_smem<64>(TILE_MAX_EXTRA) <= gs::SMEM_LIMIT &&
                  gs::bf16_smem<128>(TILE_MAX_EXTRA) <= gs::SMEM_LIMIT,
              "the exchange fits beside the ring");

// tile_max over a bf16 corpus on gmax_sweep.cuh's frame (either producer),
// tiles of a multiple of 256 rows (N % tile == 0), spans of whole tiles:
// out[b * ntiles + t] = max of tile t's scores.  The block derives its span
// from the tile (gs::tile_max_span, the launch's span): taken from the
// last argument instead, the kernel's loops compile to the same
// instructions at other addresses and ran 14% slower over 256 x 1,280 rows
// of 30,528 (4 blocks) on an H100.
template <int QM, bool CP>
__global__ void __launch_bounds__(gs::THREADS, 1)
tile_max_wgmma_kernel(const __grid_constant__ gs::Ring<CP> ring, float* __restrict__ out,
                      long long tile, int B, int D, long long N, int nqt, long long) {
  using L = gs::Layout<QM>;
  const int lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  const int qa = gs::query_row<QM>(nqt);  // this thread's rows qa, qa + 8
  const long long ntiles = N / tile;
  float* handed = reinterpret_cast<float*>(gs::bf16_extra<QM>());  // (64,), QM = 64
  const float neg_inf = -__int_as_float(0x7f800000);
  float m[2] = {neg_inf, neg_inf};  // this thread's running maxima of rows qa, qa + 8
  gs::bf16_sweep<QM, CP>(ring, B, D, N, nqt, gs::tile_max_span(tile),
                         [&](const float (&acc)[L::N / 2], long long rbase) {
    if (!gs::tile_max_unit<QM>(m, acc, rbase, tile, handed)) return;
    const long long t = (rbase / gs::TILE + 1) * gs::TILE / tile - 1;
    if ((QM == 128 || wg == 0) && (lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (qa + 8 * h < B) out[(size_t)(qa + 8 * h) * ntiles + t] = m[h];
    }
    m[0] = m[1] = neg_inf;
  });
}

// the route of dst_tile_max: a bf16 sweep's (gs::bf16_route) where the
// tiles are whole 256-row units, else 0
inline int tile_max_route(const void* q, const void* corpus, long long N, int D, long long tile,
                          int dtype) {
  return tile % gs::TILE == 0 ? gs::bf16_route(q, corpus, N, D, dtype) : 0;
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
// The route is chosen by shape alone (dst_count_above_route).
extern "C" int dst_count_above(const void* q, const void* corpus, const void* tau, void* out,
                               int B, long long N, int D, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (const int route = gs::bf16_route(q, corpus, N, D, dtype))
    return gs::by_route(route, B, D, [&](auto qm, auto cp) {
      constexpr int QM = decltype(qm)::value;
      constexpr bool CP = decltype(cp)::value;
      return gs::launch_bf16_sweep<QM, CP>(count_above_wgmma_kernel<QM, CP>, q, corpus, B, N, D,
                                           s, (const float*)tau, (int*)out);
    });
  if (dtype == 0) return launch_count<bf16>(q, corpus, tau, out, B, N, D, s);
  if (dtype == 1) return launch_count<float>(q, corpus, tau, out, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}

// t1 (N / 8, B) and t2 (N / 128, B) fp32.  The route is chosen by shape
// alone (dst_groupmax_route); a failed tensor-map encode returns its code.
extern "C" int dst_groupmax(const void* q, const void* corpus, void* t1, void* t2, int B,
                            long long N, int D, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1 || N % ROWS != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (const int route = gs::bf16_route(q, corpus, N, D, dtype))
    return gs::by_route(route, B, D, [&](auto qm, auto cp) {
      constexpr int QM = decltype(qm)::value;
      constexpr bool CP = decltype(cp)::value;
      return gs::launch_bf16_sweep<QM, CP>(groupmax_wgmma_kernel<QM, CP>, q, corpus, B, N, D, s,
                                           (float*)t1, (float*)t2);
    });
  if (dtype == 0) return launch_groupmax<bf16>(q, corpus, t1, t2, B, N, D, s);
  if (dtype == 1) return launch_groupmax<float>(q, corpus, t1, t2, B, N, D, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel dst_count_above takes on these arguments: 1 the wgmma kernel
// fed by TMA, 2 the same fed by cp.async, 0 score_tile.
extern "C" int dst_count_above_route(const void* q, const void* corpus, long long N, int D,
                                     int dtype) {
  return gs::bf16_route(q, corpus, N, D, dtype);
}

// The kernel dst_groupmax takes on these arguments: 1 the wgmma kernel fed
// by TMA, 2 the same fed by cp.async, 0 score_tile.
extern "C" int dst_groupmax_route(const void* q, const void* corpus, long long N, int D,
                                  int dtype) {
  return gs::bf16_route(q, corpus, N, D, dtype);
}

// The kernel dst_tile_max takes on these arguments: 1 the wgmma kernel fed
// by TMA, 2 the same fed by cp.async, 0 score_tile.
extern "C" int dst_tile_max_route(const void* q, const void* corpus, long long N, int D,
                                  long long tile, int dtype) {
  return tile_max_route(q, corpus, N, D, tile, dtype);
}

// Dynamic shared memory of a block of the bf16 wgmma sweeps (groupmax,
// count_above, count_above_groups: one frame) at batch B, D <= PROMOTE_D.
extern "C" long long dst_bf16_sweep_smem(int B) {
  return (long long)(B > 64 ? gs::bf16_smem<128>() : gs::bf16_smem<64>());
}

// The rows of a groupmax or count block (gmax_sweep.cuh's fill_span) at
// batch B and width D over N rows, or minus the failed device query's code.
extern "C" long long dst_bf16_sweep_span(long long N, int B, int D) {
  const int qm = gs::bf16_qm128(B, D) ? 128 : 64;
  long long span;
  const cudaError_t err = gs::fill_span(N, (B + qm - 1) / qm, &span);
  return err == cudaSuccess ? span : -(long long)err;
}

// Dynamic shared memory of a tile_max_wgmma_kernel block at batch B, D <=
// PROMOTE_D.
extern "C" long long dst_tile_max_smem(int B) {
  return (long long)(B > 64 ? gs::bf16_smem<128>(TILE_MAX_EXTRA)
                            : gs::bf16_smem<64>(TILE_MAX_EXTRA));
}

// out (B, N / tile) fp32.  The route is chosen by shape alone
// (dst_tile_max_route).
extern "C" int dst_tile_max(const void* q, const void* corpus, void* out, int B, long long N,
                            int D, long long tile, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1 || tile < 1 || N % tile != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (const int route = tile_max_route(q, corpus, N, D, tile, dtype))
    return gs::by_route(route, B, D, [&](auto qm, auto cp) {
      constexpr int QM = decltype(qm)::value;
      constexpr bool CP = decltype(cp)::value;
      return gs::launch_bf16_spans<QM, CP>(tile_max_wgmma_kernel<QM, CP>,
                                           gs::tile_max_span(tile), TILE_MAX_EXTRA, q, corpus, B,
                                           N, D, s, (float*)out, tile);
    });
  if (dtype == 0) return launch_tile_max<bf16>(q, corpus, out, B, N, D, tile, s);
  if (dtype == 1) return launch_tile_max<float>(q, corpus, out, B, N, D, tile, s);
  return (int)cudaErrorInvalidValue;
}
