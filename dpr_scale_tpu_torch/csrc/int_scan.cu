// Two one-sweep reductions of the integer inner products of quantised
// queries q (PLANES * B, D) int8 against corpus rows, each an epilogue on the
// int32 sums of gmax_sweep.cuh's s8 wgmma loop (widths TMA can address) or
// on the int32 tiles of int_tile.cuh.  The (B, N) scores never reach device
// memory.
//
// Replaces the two TPU kernels of tools/microbench_int4_kernel.py:
//   * i4_groupmax (_i4_kernel, :160): per 8-row group g and query b, the max
//     of the dequantised scores s = float(dot) * sc[r] * qsc[b] and its row
//     (the first on ties, as jnp.argmax): vals (N / 8, B) fp32, rows
//     (N / 8, B) int32, N % 128 == 0.  Here for the int4 (packed) corpus as
//     the tool has it and for an int8 one, with one or two query planes:
//     s = (float(dot_hi) + float(dot_lo) * lo_weight) * sc[r] * qsc[b], each
//     product and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc
//     contracts nothing into an FMA), so the kernel equals the plain PyTorch
//     version bit for bit.  The sweep of MipsIndex method="int8" / "int4";
//   * pallas_dot (_dot_kernel, :111): out[t, b] = max over the rows of tile
//     t of the int32 dot, (N / tile, B), N % tile == 0; the tool's baseline.
//
// What bounds them on an H100: the B x N x D integer product at the CLI's
// query batch (B = 256 over 4,194,304 x 768: 1.65e12 operations, 0.83 ms at
// 1,979 dense int8 TOPS); the single read of the corpus at serving batches
// (2,097,152 x 768 int8 at B = 64: 1.6 GB, 0.48 ms; packed int4 half that).
// Design: on widths TMA can address (int8: D % 16 == 0; packed: D / 2 % 16
// == 0; 16-byte aligned bases) both run on gmax_sweep.cuh's s8_sweep: a ring
// of TMA loads (a 256-row corpus slice of 128 bytes and the block's query
// slices of each plane a stage) feeding two consumer warpgroups on wgmma
// m64nNk32 s8 (queries on M, corpus rows on N, both K-major, int32 sums in
// registers; packed int4 sign-extended into int8 tiles in shared memory).
// int_groupmax_wgmma_kernel's epilogue dequantises in registers (the exact
// integer dot as fp32, the planes' rounded sum, the two rounded scalings)
// and the quad's lanes reduce-scatter each 8-row group's (value, row) with
// shuffles, the smaller row winning ties; stores run along the query axis.
// One plane of int8 over more than 64 queries takes 128-query blocks
// (m64n256 a warpgroup); two planes, packed rows and B <= 64 take 64-query
// blocks (m64n128, the warpgroups on the two halves of a tile).
// int8_tile_max_wgmma_kernel (tiles of a multiple of 256 rows): a block's
// span is whole tiles (gmax_sweep.cuh's tile_max_span), each thread carries
// the running integer max of its two query rows over a tile's 256-row
// units, at the tile's end two quad shuffles give the tile's maxima (the
// QM = 64 halves meet in 256 bytes past the ring), stored once along the
// query axis, no atomics: B > 64 takes 128-query blocks, B <= 64 64-query
// blocks, so the corpus is read once.  Other widths and tiles run on
// int_tile.cuh's tile (mma.sync, synchronous staging): a block owns (64
// queries of every plane, a span of rows), i4_groupmax writes per 128-row
// tile the 16 group maxima (and rows) of each query through shared memory;
// tile_max reduces one whole tile in shared memory and writes it once.  The
// query tiles of one span are neighbouring block indices, so they run
// together and read the span's corpus bytes from L2.
// dst_int_groupmax_route / dst_int8_tile_max_route say which route a call
// takes.
#include "gmax_sweep.cuh"  // first: the emulation defines the CUDA keywords there
#include "int_tile.cuh"

#include <limits.h>

using namespace int_tile;
namespace gs = gmax_sweep;

namespace {

constexpr int SPAN = 2048;      // corpus rows per block of int_groupmax
constexpr int GMAX_ROWS = 8;    // rows per group
constexpr int GROUPS_PER_TILE = ROWS / GMAX_ROWS;
constexpr int STRIDES = THREADS / QT;  // threads per query in an epilogue

template <bool PACKED, int PLANES>
__global__ void __launch_bounds__(THREADS)
int_groupmax_kernel(Operands op, const float* __restrict__ row_sc, const float* __restrict__ q_sc,
                    float* __restrict__ vals, int* __restrict__ rows, long long N, int nqt,
                    float lo_weight) {
  unsigned char* smem = dst_hopper::dynamic_smem();
  const Smem<PACKED, PLANES> sm(smem);
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const long long row0 = (long long)(blockIdx.x / nqt) * SPAN;
  const long long row_end = min(row0 + SPAN, N);
  const int q_valid = min(QT, op.B - q0);
  const int tid = threadIdx.x, my_q = tid % QT, my_r0 = tid / QT;
  const float my_qsc = my_q < q_valid ? q_sc[q0 + my_q] : 1.0f;
  for (long long rbase = row0; rbase < row_end; rbase += ROWS) {
    score_tile<PACKED, PLANES>(sm, op, rbase, ROWS, q0, q_valid);
    for (int g = my_r0; g < GROUPS_PER_TILE; g += STRIDES) {
      float best = 0.0f;
      int arg = 0;
      for (int r = 0; r < GMAX_ROWS; ++r) {
        const int row = g * GMAX_ROWS + r;
        float sf = (float)sm.s[row * LDS + my_q];
        if constexpr (PLANES == 2)
          sf = __fadd_rn(sf, __fmul_rn((float)sm.s[(ROWS + row) * LDS + my_q], lo_weight));
        const float s = __fmul_rn(__fmul_rn(sf, __ldg(row_sc + rbase + row)), my_qsc);
        if (r == 0 || s > best) {  // strict: the first row holding the max
          best = s;
          arg = r;
        }
      }
      if (my_q < q_valid) {
        const size_t at = (size_t)(rbase / GMAX_ROWS + g) * op.B + q0 + my_q;
        vals[at] = best;
        if (rows) rows[at] = (int)(rbase + g * GMAX_ROWS + arg);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
int8_tile_max_kernel(Operands op, int* __restrict__ out, long long tile, long long ntiles,
                     int nqt) {
  unsigned char* smem = dst_hopper::dynamic_smem();
  const Smem<false, 1> sm(smem);
  int* sMax = reinterpret_cast<int*>(sm.extra);  // (STRIDES, QT)
  const int q0 = (int)(blockIdx.x % nqt) * QT;
  const long long t = blockIdx.x / nqt;
  const long long row_end = (t + 1) * tile;
  const int q_valid = min(QT, op.B - q0);
  const int tid = threadIdx.x, my_q = tid % QT, my_r0 = tid / QT;
  int my_max = INT_MIN;
  for (long long rbase = t * tile; rbase < row_end; rbase += ROWS) {
    const int r_valid = (int)min((long long)ROWS, row_end - rbase);
    score_tile<false, 1>(sm, op, rbase, r_valid, q0, q_valid);
    for (int r = my_r0; r < r_valid; r += STRIDES) my_max = max(my_max, sm.s[r * LDS + my_q]);
  }
  sMax[my_r0 * QT + my_q] = my_max;
  __syncthreads();
  if (tid < q_valid) {
    int m = sMax[tid];
    for (int i = 1; i < STRIDES; ++i) m = max(m, sMax[i * QT + tid]);
    out[(size_t)t * op.B + q0 + tid] = m;
  }
}

// int_groupmax over TMA-addressable widths: the dequantising group-max
// epilogue on gmax_sweep.cuh's s8 loop.  ROWS: store the argmax rows too.
template <bool PACKED, int PLANES, int QM, bool ROWS>
__global__ void __launch_bounds__(gs::THREADS, 1)
int_groupmax_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmC, const float* __restrict__ row_sc,
                          const float* __restrict__ q_sc, float* __restrict__ vals,
                          int* __restrict__ rows, float lo_weight, int B, int W, long long N,
                          int nqt) {
  using L = gs::Layout<QM>;
  const int lane = threadIdx.x % 32;
  const int qa = gs::query_row<QM>(nqt);  // this thread's rows qa, qa + 8
  const float qs[2] = {qa < B ? q_sc[qa] : 1.0f, qa + 8 < B ? q_sc[qa + 8] : 1.0f};
  gs::s8_sweep<QM, PACKED, PLANES>(tmQ, tmC, B, W, N, nqt, [&](const int (&acc)[PLANES][L::N / 2],
                                                                long long rbase) {
    // dequantised group maxima (and rows) in registers
    float m[L::NJ][2], r[L::NJ / 4][2];
    int mr[L::NJ][2], rr[L::NJ / 4][2];
#pragma unroll
    for (int j = 0; j < L::NJ; ++j) {
      const long long rj = rbase + 8 * j + 2 * (lane & 3);  // this thread's rows rj, rj + 1
      const bool in = rbase + 8 * j < N;
      const float sc[2] = {in ? __ldg(row_sc + rj) : 1.0f, in ? __ldg(row_sc + rj + 1) : 1.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sf = (float)acc[0][4 * j + 2 * h + e];
          if constexpr (PLANES == 2)
            sf = __fadd_rn(sf, __fmul_rn((float)acc[PLANES - 1][4 * j + 2 * h + e], lo_weight));
          s[e] = __fmul_rn(__fmul_rn(sf, sc[e]), qs[h]);
        }
        m[j][h] = s[1] > s[0] ? s[1] : s[0];  // strict: the first row holding the max
        mr[j][h] = (int)rj + (s[1] > s[0] ? 1 : 0);
      }
    }
    if constexpr (ROWS)
      gs::quad_argmax_scatter<L::NJ>(m, mr, r, rr, lane);
    else
      gs::quad_max_scatter<L::NJ>(m, r, lane);
#pragma unroll
    for (int k = 0; k < L::NJ / 4; ++k) {
      const long long g = rbase / GMAX_ROWS + 4 * k + (lane & 3);
      if (g * GMAX_ROWS < N) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (qa + 8 * h < B) {
            vals[g * B + qa + 8 * h] = r[k][h];
            if constexpr (ROWS) rows[g * B + qa + 8 * h] = rr[k][h];
          }
      }
    }
  });
}

// 64 ints past the barriers: the maxima the QM = 64 layout's second
// warpgroup hands to the first
constexpr int TILE_MAX_EXTRA = 64 * 4;
static_assert(gs::S8Frame<64, false, 1>::smem(TILE_MAX_EXTRA) <= gs::SMEM_LIMIT &&
                  gs::S8Frame<128, false, 1>::smem(TILE_MAX_EXTRA) <= gs::SMEM_LIMIT,
              "the exchange fits beside the ring");

// int8_tile_max over a TMA-addressable int8 corpus, tiles of a multiple of
// 256 rows (N % tile == 0): out[t * B + b] = max of tile t's integer dots,
// on gmax_sweep.cuh's s8 loop over spans of whole tiles (tile_max_span)
template <int QM>
__global__ void __launch_bounds__(gs::THREADS, 1)
int8_tile_max_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                           const __grid_constant__ CUtensorMap tmC, int* __restrict__ out,
                           long long tile, int B, int W, long long N, int nqt) {
  using L = gs::Layout<QM>;
  const int lane = threadIdx.x % 32, wg = threadIdx.x / 128;
  const int qa = gs::query_row<QM>(nqt);  // this thread's rows qa, qa + 8
  int* handed = reinterpret_cast<int*>(gs::s8_extra<QM, false, 1>());  // (64,), QM = 64
  // trap: the dots can be negative, so INT_MIN (not 0) is the identity
  int m[2] = {INT_MIN, INT_MIN};  // this thread's running maxima of rows qa, qa + 8
  gs::s8_sweep<QM, false, 1>(tmQ, tmC, B, W, N, nqt, [&](const int (&acc)[1][L::N / 2],
                                                         long long rbase) {
    if (!gs::tile_max_unit<QM>(m, acc[0], rbase, tile, handed)) return;
    // trap: query rows past B are the query box's zero fill (they score 0)
    // and are never stored
    const long long t = (rbase / gs::TILE + 1) * gs::TILE / tile - 1;
    if ((QM == 128 || wg == 0) && (lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (qa + 8 * h < B) out[(size_t)t * B + qa + 8 * h] = m[h];
    }
    m[0] = m[1] = INT_MIN;
  }, gs::tile_max_span(tile));
}

template <bool PACKED, int PLANES>
int launch_groupmax(const Operands& op, const void* row_sc, const void* q_sc, void* vals,
                    void* rows, long long N, float lo_weight, cudaStream_t stream) {
  const size_t smem = Tile<PACKED, PLANES>::smem_bytes();
  const int nqt = (op.B + QT - 1) / QT;
  const long long blocks = (N + SPAN - 1) / SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(int_groupmax_kernel<PACKED, PLANES>, dim3((unsigned)blocks),
                                 THREADS, smem, stream, op, (const float*)row_sc,
                                 (const float*)q_sc, (float*)vals, (int*)rows, N, nqt, lo_weight);
}

// the wgmma route: 128-query blocks for one int8 plane over more than 64
// queries, else 64-query blocks
template <bool PACKED, int PLANES, bool ROWS>
int launch_groupmax_wgmma(const Operands& op, const void* row_sc, const void* q_sc, void* vals,
                          void* rows, long long N, float lo_weight, cudaStream_t stream) {
  constexpr int QM = !PACKED && PLANES == 1 ? 128 : 64;
  if (QM == 128 && op.B > 64)
    return gs::launch_s8_spans<QM, PACKED, PLANES>(
        int_groupmax_wgmma_kernel<PACKED, PLANES, QM, ROWS>, gs::SPAN, 0, op.q, op.corpus, op.B,
        N, op.D, op.W, stream, (const float*)row_sc, (const float*)q_sc, (float*)vals,
        (int*)rows, lo_weight);
  return gs::launch_s8_spans<64, PACKED, PLANES>(
      int_groupmax_wgmma_kernel<PACKED, PLANES, 64, ROWS>, gs::SPAN, 0, op.q, op.corpus, op.B, N,
      op.D, op.W, stream, (const float*)row_sc, (const float*)q_sc, (float*)vals, (int*)rows,
      lo_weight);
}

template <bool PACKED, int PLANES>
int launch_groupmax_wgmma(const Operands& op, const void* row_sc, const void* q_sc, void* vals,
                          void* rows, long long N, float lo_weight, cudaStream_t stream) {
  return rows ? launch_groupmax_wgmma<PACKED, PLANES, true>(op, row_sc, q_sc, vals, rows, N,
                                                             lo_weight, stream)
              : launch_groupmax_wgmma<PACKED, PLANES, false>(op, row_sc, q_sc, vals, rows, N,
                                                              lo_weight, stream);
}

// 1 where dst_int_groupmax runs int_groupmax_wgmma_kernel: rows of W bytes
// and queries of D bytes that TMA can address; 0 for int_groupmax_kernel
int wgmma_route(const void* q8, const void* corpus, int D, int W) {
  return W % 16 == 0 && D % 16 == 0 && (uintptr_t)q8 % 16 == 0 && (uintptr_t)corpus % 16 == 0;
}

// 1 where dst_int8_tile_max runs int8_tile_max_wgmma_kernel: an int8
// corpus and queries TMA can address, tiles of whole 256-row units, rows an
// int coordinate reaches
int int8_tile_max_route(const void* q8, const void* corpus, long long N, int D, long long tile) {
  return wgmma_route(q8, corpus, D, D) && tile % gs::TILE == 0 && N <= INT_MAX;
}

}  // namespace

// Each returns a cudaError_t code: 0 on a launch that was accepted.

// q8 (planes * B, D) int8; corpus (N, D) int8 or, packed, (N, D / 2); row_sc
// (N,) and q_sc (B,) fp32; vals (N / 8, B) fp32; rows (N / 8, B) int32 or
// NULL (no argmax stored).  N % 128 == 0; D even when packed.
extern "C" int dst_int_groupmax(const void* q8, const void* corpus, const void* row_sc,
                                const void* q_sc, void* vals, void* rows, int B, long long N,
                                int D, int packed, int planes, float lo_weight, void* stream) {
  if (B < 1 || D < 1 || N < 1 || N % ROWS != 0 || N > INT_MAX || (packed && D % 2))
    return (int)cudaErrorInvalidValue;
  const int W = packed ? D / 2 : D;
  const Operands op{(const int8_t*)q8, (const int8_t*)corpus, B, D, W,
                    vectorizable(q8, corpus, D, W)};
  cudaStream_t s = (cudaStream_t)stream;
  if (wgmma_route(q8, corpus, D, W)) {
    if (packed && planes == 1) return launch_groupmax_wgmma<true, 1>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
    if (packed && planes == 2) return launch_groupmax_wgmma<true, 2>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
    if (!packed && planes == 1) return launch_groupmax_wgmma<false, 1>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
    if (!packed && planes == 2) return launch_groupmax_wgmma<false, 2>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
    return (int)cudaErrorInvalidValue;
  }
  if (packed && planes == 1) return launch_groupmax<true, 1>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  if (packed && planes == 2) return launch_groupmax<true, 2>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  if (!packed && planes == 1) return launch_groupmax<false, 1>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  if (!packed && planes == 2) return launch_groupmax<false, 2>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  return (int)cudaErrorInvalidValue;
}

// 1: dst_int_groupmax takes the wgmma kernel on these arguments; 0: int_tile.
extern "C" int dst_int_groupmax_route(const void* q8, const void* corpus, int D, int packed) {
  return wgmma_route(q8, corpus, D, packed ? D / 2 : D);
}

// Dynamic shared memory of a wgmma int_groupmax block at batch B.
extern "C" long long dst_int_groupmax_smem(int B, int packed, int planes) {
  if (packed)
    return (long long)(planes == 2 ? gs::S8Frame<64, true, 2>::smem()
                                   : gs::S8Frame<64, true, 1>::smem());
  if (planes == 2) return (long long)gs::S8Frame<64, false, 2>::smem();
  return (long long)(B > 64 ? gs::S8Frame<128, false, 1>::smem()
                            : gs::S8Frame<64, false, 1>::smem());
}

// 1: dst_int8_tile_max takes the wgmma kernel on these arguments; 0: int_tile.
extern "C" int dst_int8_tile_max_route(const void* q8, const void* corpus, long long N, int D,
                                       long long tile) {
  return int8_tile_max_route(q8, corpus, N, D, tile);
}

// Dynamic shared memory of an int8_tile_max_wgmma_kernel block at batch B.
extern "C" long long dst_int8_tile_max_smem(int B) {
  return (long long)(B > 64 ? gs::S8Frame<128, false, 1>::smem(TILE_MAX_EXTRA)
                            : gs::S8Frame<64, false, 1>::smem(TILE_MAX_EXTRA));
}

// q8 (B, D) int8, corpus (N, D) int8; out (N / tile, B) int32.  The route
// is chosen by shape alone (dst_int8_tile_max_route); a failed tensor-map
// encode returns its code.
extern "C" int dst_int8_tile_max(const void* q8, const void* corpus, void* out, int B,
                                 long long N, int D, long long tile, void* stream) {
  if (B < 1 || D < 1 || N < 1 || tile < 1 || N % tile != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (int8_tile_max_route(q8, corpus, N, D, tile))
    return B > 64 ? gs::launch_s8_spans<128, false, 1>(int8_tile_max_wgmma_kernel<128>,
                                                       gs::tile_max_span(tile), TILE_MAX_EXTRA,
                                                       q8, corpus, B, N, D, D, s, (int*)out, tile)
                  : gs::launch_s8_spans<64, false, 1>(int8_tile_max_wgmma_kernel<64>,
                                                      gs::tile_max_span(tile), TILE_MAX_EXTRA, q8,
                                                      corpus, B, N, D, D, s, (int*)out, tile);
  const Operands op{(const int8_t*)q8, (const int8_t*)corpus, B, D, D,
                    vectorizable(q8, corpus, D, D)};
  const size_t smem = Tile<false, 1>::smem_bytes() + STRIDES * QT * 4;
  const int nqt = (B + QT - 1) / QT;
  const long long ntiles = N / tile;
  if (ntiles * nqt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(int8_tile_max_kernel, dim3((unsigned)(ntiles * nqt)), THREADS,
                                 smem, s, op, (int*)out, tile, ntiles, nqt);
}
