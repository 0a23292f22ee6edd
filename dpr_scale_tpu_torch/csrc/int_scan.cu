// Two one-sweep reductions of the integer inner products of quantised
// queries q (PLANES * B, D) int8 against corpus rows, each an epilogue on the
// int32 tiles of int_tile.cuh.  The (B, N) scores never reach device memory.
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
// Design: i4_groupmax on widths TMA can address (int8: D % 16 == 0; packed:
// D / 2 % 16 == 0; 16-byte aligned bases) runs int_groupmax_wgmma_kernel on
// gmax_sweep.cuh's frame: a ring of TMA loads (a 256-row corpus slice of 128
// bytes and the block's query slices of each plane a stage) feeding two
// consumer warpgroups on wgmma m64nNk32 s8 (queries on M, corpus rows on N,
// both K-major, int32 sums in registers, one accumulator set per plane, so
// the two planes of a query meet in one thread).  sm_90's wgmma has no s4
// type: a packed stage's bytes (low nibble dim j, high nibble dim j + D / 2)
// are sign-extended by the consumers into an int8 low and high tile in
// shared memory (each warpgroup its own 128 rows, behind a fence and a
// warpgroup barrier), which meet the query columns [c0, c0 + 128) and
// [D / 2 + c0, ...): two products per packed load.  The epilogue
// dequantises in registers (the exact integer dot as fp32, the planes'
// rounded sum, the two rounded scalings) and the quad's lanes
// reduce-scatter each 8-row group's (value, row) with shuffles, the
// smaller row winning ties; stores run along the query axis.  One plane of
// int8 over more than 64 queries takes 128-query blocks (m64n256 a
// warpgroup); two planes, packed rows and B <= 64 take 64-query blocks
// (m64n128, the warpgroups on the two halves of a tile).  Other widths,
// and tile_max, run on int_tile.cuh's tile: a block owns (64 queries of
// every plane, a span of rows), i4_groupmax writes per 128-row tile the 16
// group maxima (and rows) of each query through shared memory; tile_max
// reduces one whole tile in shared memory and writes it once.  The query
// tiles of one span are neighbouring block indices, so they run together
// and read the span's corpus bytes from L2.  dst_int_groupmax_route says
// which route a call takes.
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

// int_groupmax over TMA-addressable widths (gmax_sweep.cuh); tmQ reads the
// query planes (PLANES * B, D) in (QM, 128-byte) boxes, tmC the corpus (N,
// W) bytes in (256, 128-byte) boxes.  ROWS: store the argmax rows too.
template <bool PACKED, int PLANES, int QM, bool ROWS>
__global__ void __launch_bounds__(gs::THREADS, 1)
int_groupmax_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmC, const float* __restrict__ row_sc,
                          const float* __restrict__ q_sc, float* __restrict__ vals,
                          int* __restrict__ rows, int B, int W, long long N, int nqt,
                          float lo_weight) {
  using L = gs::Layout<QM>;
  static_assert(!PACKED || QM == 64, "a warpgroup unpacks its own 128 rows");
  static_assert(PLANES == 1 || QM == 64, "two accumulator sets: m64n128 each");
  constexpr int NSUB = PACKED ? 2 : 1;  // query slices a plane and stage: low, high dims
  constexpr int STAGE = gs::C_BYTES + PLANES * NSUB * L::Q_BYTES;
  constexpr int UNPACKED = 128 * gs::SLICE;  // a warpgroup's low (or high) tile
  constexpr int EXTRA = PACKED ? 2 * 2 * UNPACKED : 0;
  constexpr int STAGES = gs::RING_STAGES<STAGE, EXTRA>;
  unsigned char* smem = gs::aligned_smem();
  unsigned char* unpacked = smem + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(unpacked + EXTRA);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int q0 = (int)(blockIdx.x % nqt) * QM;
  const long long row0 = (long long)(blockIdx.x / nqt) * gs::SPAN;
  const int tiles = gs::span_tiles(row0, N), KT = (W + gs::SLICE - 1) / gs::SLICE;
  gs::ring_init(full, empty, STAGES);

  if (wg == 2) {
    // ---- producer: one thread keeps the ring's loads in flight ----
    dst_hopper::setmaxnreg_dec<40>();
    if (t == 0) {
      for (int it = 0; it < tiles * KT; ++it) {
        const int s = it % STAGES, tile = it / KT, col = (it % KT) * gs::SLICE;
        dst_hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // first use passes
        unsigned char* st = smem + s * STAGE;
        dst_hopper::mbar_arrive_expect_tx(&full[s], STAGE);
        dst_hopper::tma_load(st, &tmC, (int)(row0 + tile * gs::TILE), col, &full[s]);
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
#pragma unroll
          for (int sub = 0; sub < NSUB; ++sub)
            dst_hopper::tma_load(st + gs::C_BYTES + (p * NSUB + sub) * L::Q_BYTES, &tmQ,
                                 p * B + q0, sub * W + col, &full[s]);
      }
    }
    return;
  }
  // ---- consumers: warpgroup wg's queries against its rows of each tile ----
  dst_hopper::setmaxnreg_inc<232>();
  const int warp = t / 32, lane = t % 32;
  const int qa = q0 + L::q_off(wg) + 16 * warp + lane / 4;  // this thread's rows qa, qa + 8
  const float qs[2] = {qa < B ? q_sc[qa] : 1.0f, qa + 8 < B ? q_sc[qa + 8] : 1.0f};
  unsigned char* lo_tile = unpacked + wg * 2 * UNPACKED;
  int acc[PLANES][L::N / 2];
  int it = 0;
  for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int i = 0; i < L::N / 2; ++i) acc[p][i] = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      dst_hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * STAGE;
      if constexpr (PACKED) {
        // the previous products, the last readers of this warpgroup's
        // unpacked tiles and of the previous stage, have retired
        dst_hopper::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < PLANES; ++p) dst_hopper::fence_operands(acc[p]);
        if (kt > 0 && lane == 0) dst_hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
        dst_hopper::named_bar_sync(2 + wg, 128);
        const uint4* src = reinterpret_cast<const uint4*>(st + L::r_off(wg) * gs::SLICE);
        uint4* lo = reinterpret_cast<uint4*>(lo_tile);
        uint4* hi = reinterpret_cast<uint4*>(lo_tile + UNPACKED);
        // the swizzle moves 16-byte chunks within 1024-byte periods, and the
        // three tiles share it: unpacking keeps each byte's place
        for (int i = t; i < UNPACKED / 16; i += 128) {
          const uint4 v = src[i];
          uint4 l, h;
          unpack4(v.x, l.x, h.x);
          unpack4(v.y, l.y, h.y);
          unpack4(v.z, l.z, h.z);
          unpack4(v.w, l.w, h.w);
          lo[i] = l;
          hi[i] = h;
        }
        dst_hopper::fence_proxy_async();  // the generic writes, visible to wgmma
        dst_hopper::named_bar_sync(2 + wg, 128);
      }
#pragma unroll
      for (int p = 0; p < PLANES; ++p) dst_hopper::fence_operands(acc[p]);
      dst_hopper::wgmma_fence();
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
#pragma unroll
        for (int sub = 0; sub < NSUB; ++sub) {
          const unsigned char* a = st + gs::C_BYTES + (p * NSUB + sub) * L::Q_BYTES +
                                   L::q_off(wg) * gs::SLICE;
          const unsigned char* b =
              PACKED ? lo_tile + sub * UNPACKED : st + L::r_off(wg) * gs::SLICE;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // 32-byte k-steps through the 128-byte slice
            dst_hopper::wgmma_tn_s8<L::N>(acc[p], dst_hopper::smem_desc(a + kk * 32, 16, 1024),
                                          dst_hopper::smem_desc(b + kk * 32, 16, 1024));
        }
      dst_hopper::wgmma_commit();
#pragma unroll
      for (int p = 0; p < PLANES; ++p) dst_hopper::fence_operands(acc[p]);
      if constexpr (!PACKED) {
        dst_hopper::wgmma_wait<1>();  // the previous stage's products have retired
#pragma unroll
        for (int p = 0; p < PLANES; ++p) dst_hopper::fence_operands(acc[p]);
        if (kt > 0 && lane == 0) dst_hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    dst_hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < PLANES; ++p) dst_hopper::fence_operands(acc[p]);
    if (lane == 0) dst_hopper::mbar_arrive(&empty[(it - 1) % STAGES]);

    // ---- epilogue: dequantised group maxima (and rows) in registers ----
    const long long rbase = row0 + (long long)tile * gs::TILE + L::r_off(wg);
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
  }
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

template <bool PACKED, int PLANES, int QM>
constexpr size_t wgmma_smem() {
  constexpr int STAGE = gs::C_BYTES + PLANES * (PACKED ? 2 : 1) * QM * gs::SLICE;
  constexpr int EXTRA = PACKED ? 4 * 128 * gs::SLICE : 0;
  return gs::smem_bytes(gs::RING_STAGES<STAGE, EXTRA>, STAGE, EXTRA);
}

template <bool PACKED, int PLANES, int QM, bool ROWS>
int launch_wgmma(const Operands& op, const CUtensorMap& tq, const CUtensorMap& tc,
                 const void* row_sc, const void* q_sc, void* vals, void* rows, long long N,
                 float lo_weight, cudaStream_t stream) {
  const int nqt = (op.B + QM - 1) / QM;
  const long long blocks = (N + gs::SPAN - 1) / gs::SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(int_groupmax_wgmma_kernel<PACKED, PLANES, QM, ROWS>,
                                 dim3((unsigned)blocks), gs::THREADS,
                                 wgmma_smem<PACKED, PLANES, QM>(), stream, tq, tc, (const float*)row_sc, (const float*)q_sc,
                                 (float*)vals, (int*)rows, op.B, op.W, N, nqt, lo_weight);
}

// the wgmma route: 128-query blocks for one int8 plane over more than 64
// queries, else 64-query blocks
template <bool PACKED, int PLANES, bool ROWS>
int launch_groupmax_wgmma(const Operands& op, const void* row_sc, const void* q_sc, void* vals,
                          void* rows, long long N, float lo_weight, cudaStream_t stream) {
  constexpr int QM = !PACKED && PLANES == 1 ? 128 : 64;
  const int qm = QM == 128 && op.B > 64 ? 128 : 64;
  CUtensorMap tq, tc;
  cudaError_t err = dst_hopper::make_tmap_bytes(&tq, op.q, (long long)PLANES * op.B, op.D, qm);
  if (err == cudaSuccess) err = dst_hopper::make_tmap_bytes(&tc, op.corpus, N, op.W, gs::TILE);
  if (err != cudaSuccess) return (int)err;
  if (qm == 128)
    return launch_wgmma<PACKED, PLANES, QM, ROWS>(op, tq, tc, row_sc, q_sc, vals, rows, N,
                                                  lo_weight, stream);
  return launch_wgmma<PACKED, PLANES, 64, ROWS>(op, tq, tc, row_sc, q_sc, vals, rows, N,
                                                lo_weight, stream);
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
  if (packed) return (long long)(planes == 2 ? wgmma_smem<true, 2, 64>() : wgmma_smem<true, 1, 64>());
  if (planes == 2) return (long long)wgmma_smem<false, 2, 64>();
  return (long long)(B > 64 ? wgmma_smem<false, 1, 128>() : wgmma_smem<false, 1, 64>());
}

// q8 (B, D) int8, corpus (N, D) int8; out (N / tile, B) int32.
extern "C" int dst_int8_tile_max(const void* q8, const void* corpus, void* out, int B,
                                 long long N, int D, long long tile, void* stream) {
  if (B < 1 || D < 1 || N < 1 || tile < 1 || N % tile != 0) return (int)cudaErrorInvalidValue;
  const Operands op{(const int8_t*)q8, (const int8_t*)corpus, B, D, D,
                    vectorizable(q8, corpus, D, D)};
  const size_t smem = Tile<false, 1>::smem_bytes() + STRIDES * QT * 4;
  const int nqt = (B + QT - 1) / QT;
  const long long ntiles = N / tile;
  if (ntiles * nqt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)dst_hopper::launch(int8_tile_max_kernel, dim3((unsigned)(ntiles * nqt)), THREADS,
                                 smem, (cudaStream_t)stream, op, (int*)out, tile, ntiles, nqt);
}
