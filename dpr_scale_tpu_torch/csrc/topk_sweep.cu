// Pass 1 of the exact search: every row of a corpus whose score reaches a
// per-query threshold, as (score, row) candidates, with the products summed
// in fp32 on the arithmetic of the count kernels of the same shape.
//
// Replaces the TPU's fused dot -> lax.approx_max_k of
// dpr_scale_tpu/index/mips.py (`local_approx`, :799-803; also the `approx`
// and `auto` passes, :740-744 and :615), an XLA TPU primitive with no
// pallas_call: XLA fuses the dot into the TPU-KNN partial reduce, so the
// B x N scores never reach HBM.  That pass is approximate; this one is
// exact.  ops/mips_kernels.py::topk_candidates drives it in three steps:
//   1. the threshold: the tile-max sweep (mips_scan.cu, dst_tile_max) takes
//      the maximum of every T-row tile of the wholly valid rows, and
//      theta[b] is the kc-th largest of query b's maxima (torch.topk).  Each
//      maximum is one row's score, so at least kc rows score >= theta[b];
//   2. this sweep: every score >= theta[b] of a row below n_valid takes a
//      slot from an atomicAdd on count[b] and, while the slot is below
//      `cap`, writes the pair into keys[b * cap + slot] as one int64 key
//      (topk_key); a query whose count passes cap is swept again with a
//      buffer of its count (the caller).  Where fewer than kc tiles are
//      whole, theta is -inf and cap >= n_valid: every row takes its own
//      slot, the row itself, with no atomic and no count;
//   3. the aggregation: torch.topk over the keys, the counterpart of the
//      JAX program's own lax.top_k over its candidate pool (:812).
//
// Two kernels, the routes of the count and tile-max sweeps, chosen by shape
// in dst_topk_emit (dst_topk_route says which):
//   1, 2  topk_emit_wgmma_kernel, bf16 rows of even D: bf16_sweep's frame at
//      the layout bf16_qm128 gives the caller's whole batch (layout_b), as
//      count_above_groups takes for the same (B, D), and its PROMOTE_D
//      handling.  A row sits at the same place of a 256-row tile and a
//      query of a QM-query tile in all three sweeps, so the tile maxima, the
//      candidates and pass 2's counts are the same fp32 bits, and a rerun of
//      some of the batch's queries sums as the first sweep did.  The
//      producer is TMA where TMA can address the rows (route 1) or the
//      producer warpgroup's cp.async copies for other even D (route 2:
//      SPLADE's D = 30,522).  A tile that ends past the sweep's rows is the
//      ring's ragged case, which route 2 fills row by row at every stage: on
//      an H100, over SPLADE's 1,280 rows at B = 256, an emit of 1,203 rows
//      took 1.06 ms and one of all 1,280 0.48 ms (PERF.md row 14);
//   0  topk_emit_tile_kernel, everything else (fp32 rows, odd D, bases
//      neither route can address): score_tile.cuh's 128 x 64 score tile in
//      shared memory, the tile-max and count kernels' route 0, each thread
//      comparing its query's scores of strided rows.  A score's sum does not
//      depend on where its row or query sits in the tile (scalar fmaf in
//      column order for fp32, the same wmma steps for every element for
//      bf16), so here too the candidates are the tile maxima's and the
//      counts' bits.  No CLI builds an fp32 index and no configuration has
//      an odd D.
// Both sweeps take the corpus rows up to n_valid rounded up to whole
// 256-row tiles (where the corpus has them: an index block's pad rows) and
// mask the rows past n_valid in the epilogue: a pad row is never a
// candidate.
//
// What bounds it on an H100: like the counts, the B x N x D product at the
// retrieval batch (B = 512 over 2M x 768: 1.67 ms at 989 TFLOP/s), the
// corpus read at small B; the two sweeps read the corpus twice.  A key
// costs one atomicAdd and one 8-byte store, ~1.2 kc of them a query, so
// the epilogue is a compare a score, as the counts' is.  Route 0 alternates
// loads and MMAs and is bound by that, as the other score-tile kernels are.
#include "gmax_sweep.cuh"  // first: the emulation defines the CUDA keywords there
#include "score_tile.cuh"

namespace gs = gmax_sweep;
namespace mt = mips_tile;

namespace {

// (score, row) as one int64 whose order is the pairs' order: by score,
// then the smaller row first.  The high word is the score's bits made
// monotone as a signed integer (negative floats flip their magnitude
// bits), the low word ~row; every finite score's key lies above INT64_MIN,
// the caller's empty slot.
__device__ __forceinline__ long long topk_key(float s, int row) {
  int b = __float_as_int(s);
  b = b >= 0 ? b : b ^ 0x7fffffff;
  return (long long)(((unsigned long long)(unsigned)b << 32) | (unsigned)~row);
}

// The emit sweep on bf16_sweep: count[b] (zeroed) counts the rows r <
// valid with q[b] . c[r] >= theta[b], and the first `cap` of them land in
// keys[b * cap ..] in the order their atomicAdds ran (the aggregation sorts
// them); with cap >= valid row r lands in slot r and count[b] stays 0.
template <int QM, bool CP>
__global__ void __launch_bounds__(gs::THREADS, 1)
topk_emit_wgmma_kernel(const __grid_constant__ gs::Ring<CP> ring, const float* __restrict__ theta,
                       int* __restrict__ count, long long* __restrict__ keys, int cap,
                       long long valid, int B, int D, long long N, int nqt, long long span) {
  using L = gs::Layout<QM>;
  const int lane = threadIdx.x % 32, qa = gs::query_row<QM>(nqt);  // rows qa, qa + 8
  // trap: queries past B are the producer's zero fill; a threshold of +inf
  // keeps their zero scores out
  const float pos_inf = __int_as_float(0x7f800000);
  float th[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) th[h] = qa + 8 * h < B ? theta[qa + 8 * h] : pos_inf;

  // one candidate of query qa + 8 h: a slot (the row where cap >= valid,
  // else one from its count) and, below cap, its key
  auto emit = [&](float s, int h, long long row) {
    const int b = qa + 8 * h;
    const int slot = cap >= valid ? (int)row : atomicAdd(&count[b], 1);
    if (slot < cap) keys[(size_t)b * cap + slot] = topk_key(s, (int)row);
  };

  gs::bf16_sweep<QM, CP>(ring, B, D, N, nqt, span, [&](const float (&acc)[L::N / 2],
                                                       long long rbase) {
    // nearly every thread's part of a tile holds no candidate: its maxima
    // decide that first
    float m[2] = {acc[0], acc[2]};
#pragma unroll
    for (int j = 0; j < L::NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        m[h] = fmaxf(m[h], fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    if (m[0] < th[0] && m[1] < th[1]) return;
    const int c0 = 2 * (lane & 3);  // acc[4 j + 2 h + e] is row rbase + 8 j + c0 + e
    // trap: rows at or past `valid` are pad rows or the producer's zero
    // fill and score 0, at or above a negative theta: masked by row
    if (rbase + L::N <= valid) {
#pragma unroll
      for (int j = 0; j < L::NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[4 * j + 2 * h + e];
            if (v >= th[h]) emit(v, h, rbase + 8 * j + c0 + e);
          }
    } else {
#pragma unroll
      for (int j = 0; j < L::NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[4 * j + 2 * h + e];
            const long long row = rbase + 8 * j + c0 + e;
            if (row < valid && v >= th[h]) emit(v, h, row);
          }
    }
  });
}

// The emit sweep on score_tile.cuh's tile (route 0), on the same slots and
// keys: a block scores its query tile against gs::SPAN rows of [0, rows),
// 128 at a time, and each thread compares its query's scores of every
// mt::THREADS / mt::QT-th row of a tile.
template <typename T>
__global__ void __launch_bounds__(mt::THREADS)
topk_emit_tile_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                      const float* __restrict__ theta, int* __restrict__ count,
                      long long* __restrict__ keys, int cap, long long valid, int B, int D,
                      long long rows, int nqt, bool vec_ok) {
  unsigned char* smem = dst_hopper::dynamic_smem();
  const mt::Smem<T> sm(smem);
  const int q0 = (int)(blockIdx.x % nqt) * mt::QT;
  const long long row0 = (long long)(blockIdx.x / nqt) * gs::SPAN;
  const long long row_end = min(row0 + gs::SPAN, rows);
  const int q_valid = min(mt::QT, B - q0);
  const int tid = threadIdx.x, my_q = tid % mt::QT, my_r0 = tid / mt::QT;
  // queries past B score 0 against every row: a threshold of +inf
  const float th = my_q < q_valid ? theta[q0 + my_q] : __int_as_float(0x7f800000);
  for (long long rbase = row0; rbase < row_end; rbase += mt::ROWS) {
    const int r_valid = (int)min((long long)mt::ROWS, row_end - rbase);
    mt::score_tile(sm, corpus + (size_t)rbase * D, q + (size_t)q0 * D, r_valid, q_valid, D,
                   vec_ok);
    for (int r = my_r0; r < r_valid; r += mt::THREADS / mt::QT) {
      const float v = sm.s[r * mt::LDS + my_q];
      const long long row = rbase + r;
      if (row < valid && v >= th) {
        const int b = q0 + my_q;
        const int slot = cap >= valid ? (int)row : atomicAdd(&count[b], 1);
        if (slot < cap) keys[(size_t)b * cap + slot] = topk_key(v, (int)row);
      }
    }
  }
}

template <typename T>
int launch_emit_tile(const void* q, const void* corpus, const void* theta, void* count,
                     void* keys, int B, long long rows, long long n_valid, int D, int cap,
                     cudaStream_t stream) {
  const int nqt = (B + mt::QT - 1) / mt::QT;
  const long long blocks = (rows + gs::SPAN - 1) / gs::SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(topk_emit_tile_kernel<T>, dim3((unsigned)blocks), mt::THREADS,
                                 mt::Tile<T>::smem_bytes(), stream, (const T*)q, (const T*)corpus,
                                 (const float*)theta, (int*)count, (long long*)keys, cap, n_valid,
                                 B, D, rows, nqt, mt::vectorizable<T>(q, corpus, D));
}

}  // namespace

// The route dst_topk_emit takes on these arguments (dtype 0 bf16, 1 fp32):
// 1 the wgmma sweep fed by TMA, 2 fed by cp.async, 0 the score tile.
extern "C" int dst_topk_route(const void* q, const void* corpus, long long N, int D, int dtype) {
  return gs::bf16_route(q, corpus, N, D, dtype);
}

// q (B, D) and corpus (N, D) of one dtype (0 bf16, 1 fp32), the rows past
// n_valid (<= N, <= INT_MAX) never candidates, theta (B,) fp32, count (B,)
// int32 (zeroed here; it stays 0 where cap >= n_valid, each row in its own
// slot), keys (B, cap) int64 (the caller fills them with INT64_MIN; slots
// no candidate took keep it).  layout_b >= B: the batch whose block layout
// the wgmma sweep takes (bf16_qm128(layout_b, D)), the caller's whole
// batch, so that a rerun of some of its queries gives the first sweep's
// bits.  Returns a cudaError_t code: 0 on a launch that was accepted,
// cudaErrorInvalidValue on arguments out of range.
extern "C" int dst_topk_emit(const void* q, const void* corpus, const void* theta, void* count,
                             void* keys, int B, long long N, long long n_valid, int D, int cap,
                             int layout_b, int dtype, void* stream) {
  if (B < 1 || D < 1 || n_valid < 1 || n_valid > N || n_valid > INT_MAX || cap < 1 ||
      layout_b < B || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long whole = (n_valid + gs::TILE - 1) / gs::TILE * gs::TILE;
  const long long rows = whole < N ? whole : N;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(count, 0, (size_t)B * 4, s);
  if (err != cudaSuccess) return (int)err;
  if (const int route = gs::bf16_route(q, corpus, rows, D, dtype))
    return gs::by_route(route, layout_b, D, [&](auto qm, auto cp) {
      constexpr int QM = decltype(qm)::value;
      constexpr bool CP = decltype(cp)::value;
      return gs::launch_bf16_sweep<QM, CP>(topk_emit_wgmma_kernel<QM, CP>, q, corpus, B, rows, D,
                                           s, (const float*)theta, (int*)count,
                                           (long long*)keys, cap, n_valid);
    });
  if (dtype == 0)
    return launch_emit_tile<mt::bf16>(q, corpus, theta, count, keys, B, rows, n_valid, D, cap, s);
  return launch_emit_tile<float>(q, corpus, theta, count, keys, B, rows, n_valid, D, cap, s);
}
