// The common frame of the wgmma sweeps over a corpus: mips_scan.cu's bf16
// groupmax, count_above and tile_max, count_groups.cu's bf16
// count_above_groups, topk_sweep.cu's pass-1 select and int_scan.cu's int8
// / int4 int_groupmax and int8_tile_max.  A block of 384 threads owns QM queries and a span of
// corpus rows, walked in TILE-row tiles.  A producer fills a ring of full /
// empty mbarriers, which runs on across the span's tiles, with a tile's
// corpus rows and the block's query rows, one 128-byte slice of each row a
// stage, in the 128-byte swizzle, zero past the matrix: one thread issuing
// 2-D TMA loads where TMA can address the rows (route 1), or, for the bf16
// sweeps over rows it cannot (even D, 4-byte aligned bases: route 2), the
// producer warpgroup's 128 threads issuing 4-byte cp.async copies that
// land where the TMA box would put them.  Two consumer warpgroups run
// wgmma with queries on M and corpus rows on N, both operands K-major, the
// accumulators in registers.  Thread t of a warpgroup then holds, for its
// query rows 16 (t / 32) + (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t % 4)
// + {0, 1} of each n8 slice j: an 8-row corpus group is one slice, held by
// the four lanes of a quad, so its maximum is an in-thread max and two
// shuffles, a count over any rows an in-thread sum and two shuffles, and
// no score reaches shared or device memory.  bf16_sweep() is the bf16 loop
// with either producer (groupmax and the counts over SPAN-row spans, cut
// in whole tiles while the grid is smaller than the card: fill_span;
// tile_max over whole tiles), count_sweep() the counts' epilogue on it;
// s8_sweep() the int8 / packed int4 loop of one or two query planes
// (int_groupmax and int8_tile_max, TMA only), int32 sums.
//
// Two layouts of a block's work, by query tile:
//   QM = 128: warpgroup w owns queries [64 w, 64 w + 64) against all TILE =
//             256 rows of the tile (wgmma m64n256), the corpus slice read
//             once for 128 queries;
//   QM = 64:  warpgroup w owns all 64 queries against rows [128 w, 128 w +
//             128) (m64n128), so that a batch of at most 64 queries reads
//             the corpus once.
#pragma once

#include "hopper_ptx.cuh"  // first: the emulation defines the CUDA keywords there

#include <limits.h>

#include <type_traits>

namespace gmax_sweep {

using namespace dst_hopper;

constexpr int TILE = 256;      // corpus rows of a block's tile
constexpr int SPAN = 2048;     // corpus rows of a block
constexpr int SLICE = 128;     // bytes of a row a stage (the swizzle's span)
constexpr int THREADS = 384;   // two consumer warpgroups, one producer warp(group)
constexpr int CONSUMER_WARPS = 8;
constexpr int C_BYTES = TILE * SLICE;  // a stage's corpus box
constexpr int SMEM_LIMIT = 232448;     // an H100 block's shared memory
constexpr int MAX_STAGES = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int QM>
struct Layout {
  static_assert(QM == 64 || QM == 128, "a block holds 64 or 128 queries");
  static constexpr int N = QM == 128 ? 256 : 128;  // the wgmma's width
  static constexpr int NJ = N / 8;                 // n8 slices = 8-row groups
  static constexpr int Q_BYTES = QM * SLICE;       // one query box of a stage
  // the warpgroup's first query of the block and first row of the tile
  __device__ static int q_off(int wg) { return QM == 128 ? 64 * wg : 0; }
  __device__ static int r_off(int wg) { return QM == 128 ? 0 : 128 * wg; }
};

// stages of STAGE bytes that fit beside EXTRA bytes, the 1024-byte
// alignment slack and the barriers (a variable, which device code may read)
template <int STAGE, int EXTRA>
constexpr int RING_STAGES = (SMEM_LIMIT - 1024 - EXTRA - 2 * MAX_STAGES * 8) / STAGE < MAX_STAGES
                                ? (SMEM_LIMIT - 1024 - EXTRA - 2 * MAX_STAGES * 8) / STAGE
                                : MAX_STAGES;

// the block's dynamic shared memory: slack, ring, EXTRA bytes, barriers
constexpr size_t smem_bytes(int stages, int stage_bytes, int extra) {
  return 1024 + (size_t)stages * stage_bytes + extra + 2 * stages * 8;
}

// the block's dynamic shared memory, aligned to the swizzle's 1024-byte period
__device__ __forceinline__ unsigned char* aligned_smem() {
  unsigned char* smem = dynamic_smem();
  return smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
}

// full[s] waits for the producer's `producers` arrivals (TMA: one, and the
// stage's bytes; cp.async: one a producer thread), empty[s] for one
// arrival of each consumer warp
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages,
                                          int producers = 1) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], producers);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// corpus rows [row0, row0 + span) of this block, cut at N: its TILE-row tiles
__device__ __forceinline__ int span_tiles(long long row0, long long N, long long span = SPAN) {
  const long long rows = N - row0 < span ? N - row0 : span;
  return (int)((rows + TILE - 1) / TILE);
}

// the rows of a tile-max block (tile a multiple of TILE): one tile of at
// least SPAN rows, else as many whole tiles as fit in SPAN, so that each
// tile's maximum is stored once
__host__ __device__ inline long long tile_max_span(long long tile) {
  return tile >= SPAN ? tile : SPAN / tile * tile;
}

// m[j][h] is a quad lane's partial maximum of group j for its query row h;
// on return r[k][h] is the quad's maximum of group 4 k + lane % 4: each
// shuffle round halves the groups a lane keeps (reduce-scatter), 3 NJ / 4
// shuffles in all instead of 2 NJ
template <int NJ>
__device__ __forceinline__ void quad_max_scatter(const float (&m)[NJ][2], float (&r)[NJ / 4][2],
                                                 int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
  float h1[NJ / 2][2];
#pragma unroll
  for (int i = 0; i < NJ / 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float keep = b0 ? m[2 * i + 1][h] : m[2 * i][h];
      const float send = b0 ? m[2 * i][h] : m[2 * i + 1][h];
      h1[i][h] = fmaxf(keep, __shfl_xor_sync(FULL_MASK, send, 1));
    }
#pragma unroll
  for (int k = 0; k < NJ / 4; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float keep = b1 ? h1[2 * k + 1][h] : h1[2 * k][h];
      const float send = b1 ? h1[2 * k][h] : h1[2 * k + 1][h];
      r[k][h] = fmaxf(keep, __shfl_xor_sync(FULL_MASK, send, 2));
    }
}

// (v, row) takes (ov, orow) where that is larger, or equal at a smaller row:
// the first row holding the maximum, in any order of merging
__device__ __forceinline__ void merge_first_max(float& v, int& row, float ov, int orow) {
  if (ov > v || (ov == v && orow < row)) {
    v = ov;
    row = orow;
  }
}

// quad_max_scatter for (value, row) pairs under merge_first_max
template <int NJ>
__device__ __forceinline__ void quad_argmax_scatter(const float (&m)[NJ][2], const int (&mr)[NJ][2],
                                                    float (&r)[NJ / 4][2], int (&rr)[NJ / 4][2],
                                                    int lane) {
  const bool b0 = lane & 1, b1 = lane & 2;
  float h1[NJ / 2][2];
  int hr[NJ / 2][2];
#pragma unroll
  for (int i = 0; i < NJ / 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = b0 ? m[2 * i + 1][h] : m[2 * i][h];
      int row = b0 ? mr[2 * i + 1][h] : mr[2 * i][h];
      const float sv = b0 ? m[2 * i][h] : m[2 * i + 1][h];
      const int sr = b0 ? mr[2 * i][h] : mr[2 * i + 1][h];
      merge_first_max(v, row, __shfl_xor_sync(FULL_MASK, sv, 1),
                      __shfl_xor_sync(FULL_MASK, sr, 1));
      h1[i][h] = v;
      hr[i][h] = row;
    }
#pragma unroll
  for (int k = 0; k < NJ / 4; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = b1 ? h1[2 * k + 1][h] : h1[2 * k][h];
      int row = b1 ? hr[2 * k + 1][h] : hr[2 * k][h];
      const float sv = b1 ? h1[2 * k][h] : h1[2 * k + 1][h];
      const int sr = b1 ? hr[2 * k][h] : hr[2 * k + 1][h];
      merge_first_max(v, row, __shfl_xor_sync(FULL_MASK, sv, 2),
                      __shfl_xor_sync(FULL_MASK, sr, 2));
      r[k][h] = v;
      rr[k][h] = row;
    }
}

// ---- the bf16 sweep: groupmax, count_above, count_above_groups ----

// The route of a bf16 sweep, for a bf16 corpus (dtype 0) whose rows an int
// coordinate reaches: 1 (TMA) where TMA can address the rows (D % 8 == 0
// makes 16-byte rows; 16-byte aligned bases), 2 (cp.async) where D is even
// and both bases are 4-byte aligned; 0 (score_tile.cuh) for fp32, odd D
// and the rest
inline int bf16_route(const void* q, const void* corpus, long long N, int D, int dtype) {
  if (dtype != 0 || N > INT_MAX) return 0;
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)corpus;
  if (D % 8 == 0 && bases % 16 == 0) return 1;
  return D % 2 == 0 && bases % 4 == 0 ? 2 : 0;
}

// The ring's producer, a sweep kernel's first argument: tensor maps of the
// queries (B, D) in (QM, 64) boxes and of the corpus (N, D) in (TILE, 64)
// boxes (route 1), or the rows themselves (route 2)
struct TmaRing {
  CUtensorMap q, c;
};
struct CpRing {
  const unsigned char* q;
  const unsigned char* c;
};
template <bool CP>
using Ring = typename std::conditional<CP, CpRing, TmaRing>::type;

// The tensor cores' fp32 accumulation truncates each addend to the
// accumulator's exponent, so a score carried through them over all D
// columns drifts about (D / 16) x 2^-24 of its size, one-sided.  Up to
// PROMOTE_D columns that stays well inside the counts' COUNT_MARGIN_REL
// (index/mips.py); past it bf16_sweep sums each 64-column stage from zero
// on the tensor cores and adds it into a running fp32 score with ordinary
// adds (two accumulator sets, which fit only in the QM = 64 layout).
constexpr int PROMOTE_D = 1536;

// the layout a bf16 sweep of B queries at width D takes: 128 queries a
// block for large batches, unless D needs the promoted sums
__host__ __device__ inline bool bf16_qm128(int B, int D) { return B > 64 && D <= PROMOTE_D; }

template <int QM>
constexpr int BF16_STAGE = C_BYTES + Layout<QM>::Q_BYTES;  // a 256-row corpus and a query slice
template <int QM>
constexpr int BF16_STAGES = RING_STAGES<BF16_STAGE<QM>, 0>;

// the dynamic shared memory of a bf16 sweep block: its ring and barriers,
// and `extra` bytes past them (bf16_extra)
template <int QM>
constexpr size_t bf16_smem(int extra = 0) {
  return smem_bytes(BF16_STAGES<QM>, BF16_STAGE<QM>, extra);
}

// the extra bytes of a bf16 sweep block launched with them (on a ring of
// STAGES stages)
template <int QM, int STAGES = BF16_STAGES<QM>>
__device__ __forceinline__ unsigned char* bf16_extra() {
  return aligned_smem() + STAGES * BF16_STAGE<QM> + 2 * STAGES * 8;
}

// The span of a groupmax or count block: SPAN rows where the grid of
// ceil(N / SPAN) x nqt blocks fills the card's SMs, else the span of whole
// TILEs (down to TILE) that takes the fewest waves x tiles a block (one
// block an SM), ties to the larger span: a small corpus still fills the
// card (256 queries x 1,280 rows: 20 blocks, not 4), and a grid just short
// of the SMs keeps one wave (65,536 rows: 128 blocks of 2,048, not 148 of
// 1,792 in two).  Their outputs carry nothing across spans (the counts add
// with atomics into zeros, t1 / t2 are per 8 and per 128 rows), so any span
// of whole tiles gives the same result.  Returns the failed query's code.
inline cudaError_t fill_span(long long N, int nqt, long long* span) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *span = SPAN;
  if (err != cudaSuccess || (N + SPAN - 1) / SPAN * nqt >= sms) return err;
  long long best = -1;
  for (long long s = SPAN; s >= TILE; s -= TILE) {
    const long long waves = ((N + s - 1) / s * nqt + sms - 1) / sms;
    const long long cost = waves * (((s < N ? s : N) + TILE - 1) / TILE);
    if (best < 0 || cost < best) {
      best = cost;
      *span = s;
    }
  }
  return err;
}

// Launches kernel(ring, args..., B, D, N, nqt, span), a bf16 sweep of QM
// queries a block over spans of `span` rows (a multiple of TILE) fed by
// the producer CP selects (Ring<CP>), with `extra` bytes of shared memory
// past a ring of STAGES stages; block b takes query tile b % nqt and span
// b / nqt, so the query tiles of one span run together and read its rows
// from L2.  Returns the failed encode's or the launch's code.
template <int QM, bool CP, int STAGES = BF16_STAGES<QM>, typename Kernel, typename... Args>
int launch_bf16_spans(Kernel kernel, long long span, int extra, const void* q,
                      const void* corpus, int B, long long N, int D, cudaStream_t stream,
                      Args... args) {
  const int nqt = (B + QM - 1) / QM;
  const long long blocks = (N + span - 1) / span * nqt;
  if (blocks > 0x7fffffffLL || span % TILE != 0) return (int)cudaErrorInvalidValue;
  Ring<CP> ring;
  if constexpr (CP) {
    ring.q = static_cast<const unsigned char*>(q);
    ring.c = static_cast<const unsigned char*>(corpus);
  } else {
    cudaError_t err = make_tmap(&ring.q, q, B, D, QM, 64);
    if (err == cudaSuccess) err = make_tmap(&ring.c, corpus, N, D, TILE, 64);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch(kernel, dim3((unsigned)blocks), THREADS,
                     smem_bytes(STAGES, BF16_STAGE<QM>, extra), stream, ring, args..., B, D, N,
                     nqt, span);
}

// the same over fill_span's spans with no extra bytes (groupmax and the counts)
template <int QM, bool CP, typename Kernel, typename... Args>
int launch_bf16_sweep(Kernel kernel, const void* q, const void* corpus, int B, long long N, int D,
                      cudaStream_t stream, Args... args) {
  long long span;
  const cudaError_t err = fill_span(N, (B + QM - 1) / QM, &span);
  if (err != cudaSuccess) return (int)err;
  return launch_bf16_spans<QM, CP>(kernel, span, 0, q, corpus, B, N, D, stream, args...);
}

// f(QM, CP), each a std::integral_constant: the layout a bf16 sweep of B
// queries at width D takes and the producer of `route` (1 TMA, 2 cp.async)
template <typename F>
int by_route(int route, int B, int D, F&& f) {
  using Q64 = std::integral_constant<int, 64>;
  using Q128 = std::integral_constant<int, 128>;
  if (bf16_qm128(B, D))
    return route == 2 ? f(Q128(), std::true_type()) : f(Q128(), std::false_type());
  return route == 2 ? f(Q64(), std::true_type()) : f(Q64(), std::false_type());
}

// the first of the two query rows (qa, qa + 8) a consumer thread holds
template <int QM>
__device__ __forceinline__ int query_row(int nqt) {
  const int t = threadIdx.x % 128;
  return (int)(blockIdx.x % nqt) * QM + Layout<QM>::q_off(threadIdx.x / 128) + 16 * (t / 32) +
         (t % 32) / 4;
}

// Copies ROWS rows of one 128-byte slice into a ring stage's segment at the
// shared address seg (1024-byte aligned), row r from src + r * pitch (src:
// the slice's first byte), where a TMA box would put it: the 128-byte
// swizzle moves row r's 16-byte chunk c to chunk c ^ (r % 8).  Rows [0,
// valid) are read, the rest zero-filled (src-size 0 reads nothing; `any`,
// a readable address, stands in).  Thread t of the producer warpgroup's
// 128 copies bytes [ub, ub + 4) of rows r0 + 4 k, r0 = t / 32, so that a
// warp's copy covers one row slice and odd k flip chunk bit 2 (address bit
// 6).  A whole segment's copies are unrolled, each address its own product
// of k, so that the producer issues little besides them.
template <int ROWS>
__device__ __forceinline__ void cp_rows(uint32_t seg, const unsigned char* src, long long pitch,
                                        int valid, int t, const void* any) {
  constexpr int U = SLICE / 4, STEP = 128 / U, K = ROWS / STEP;  // copies a row slice; rows apart
  static_assert(ROWS % STEP == 0, "whole rounds of the warpgroup");
  const int r0 = t / U, ub = t % U * 4;
  const uint32_t d0 = (seg + r0 * SLICE + ub) ^ ((r0 & 7) << 4);
  const uint32_t d1 = d0 ^ 64;  // odd k
  const unsigned char* from = src + r0 * pitch + ub;
  const unsigned step = (unsigned)(STEP * pitch);
  if (valid >= ROWS) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      cp_async4((k & 1 ? d1 : d0) + k * STEP * SLICE, from + (size_t)k * step, 4);
    return;
  }
  const int kv = valid > r0 ? (valid - r0 + STEP - 1) / STEP : 0;  // rows r0 + STEP k < valid
#pragma unroll 4
  for (int k = 0; k < K; ++k)
    cp_async4((k & 1 ? d1 : d0) + k * STEP * SLICE, k < kv ? from + (size_t)k * step : any,
              k < kv ? 4 : 0);
}

// The cp.async producer of a bf16 sweep's ring (route 2), run by all 128
// threads of the producer warpgroup: each stage copies the tile's TILE
// corpus rows and the block's QM query rows, one 64-column slice of each,
// 4 bytes a copy (zero past D, N and B), and each thread ends it with a
// .noinc arrival on full[s], which lands once its copies have (full[s]
// counts 128 arrivals and no transaction bytes).
template <int QM, int STAGES = BF16_STAGES<QM>>
__device__ __forceinline__ void cp_produce(const CpRing& ring, unsigned char* smem,
                                           uint64_t* full, uint64_t* empty, int B, int D,
                                           long long N, int q0, long long row0, int tiles, int KT,
                                           int t) {
  constexpr int STAGE = BF16_STAGE<QM>;
  const long long pitch = 2LL * D;
  const int ub = t % (SLICE / 4) * 4;  // this thread's byte of each row slice
  const uint32_t base = smem_addr(smem);
  for (int it = 0; it < tiles * KT; ++it) {
    const int s = it % STAGES, tile = it / KT, colb = it % KT * SLICE;
    mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // first use passes
    // 4 divides 2 D and the copies start at multiples of 4: each lies
    // wholly before D or past it
    const bool in_d = colb + ub < pitch;
    const long long r = row0 + (long long)tile * TILE;
    const uint32_t st = base + s * STAGE;
    cp_rows<TILE>(st, ring.c + r * pitch + colb, pitch, in_d ? (int)min((long long)TILE, N - r) : 0,
                  t, ring.c);
    cp_rows<QM>(st + C_BYTES, ring.q + q0 * pitch + colb, pitch, in_d ? min(QM, B - q0) : 0, t,
                ring.c);
    cp_async_arrive_noinc(&full[s]);
  }
}

// The block's walk over its span of `span` rows (block b: query tile b %
// nqt, span b / nqt): the producer streams each tile's k-slices through
// the ring (TMA: one thread; cp.async: the warpgroup, cp_produce); each
// consumer warpgroup runs its products and, once a tile's have retired,
// calls epilogue(acc, rbase), rbase the first corpus row of its part of
// the tile.  Past PROMOTE_D (QM = 64 only) each stage's products start
// from zero and retire before their sums join the running scores: the ring
// still prefetches, but a warpgroup no longer issues the next stage while
// the last one runs.  The ring holds STAGES stages (fewer than
// BF16_STAGES<QM> where a kernel keeps more past it).  Returns false in the
// producer warpgroup, true in the consumers after the span.
template <int QM, bool CP, int STAGES = BF16_STAGES<QM>, typename Epilogue>
__device__ __forceinline__ bool bf16_sweep(const Ring<CP>& ring, int B, int D, long long N,
                                           int nqt, long long span, Epilogue&& epilogue) {
  using L = Layout<QM>;
  constexpr int STAGE = BF16_STAGE<QM>;
  unsigned char* smem = aligned_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int q0 = (int)(blockIdx.x % nqt) * QM;
  const long long row0 = (long long)(blockIdx.x / nqt) * span;
  const int tiles = span_tiles(row0, N, span), KT = (D + 63) / 64;
  ring_init(full, empty, STAGES, CP ? 128 : 1);

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if constexpr (CP) {
      // ---- producer: the warpgroup's 128 threads copy each stage ----
      cp_produce<QM, STAGES>(ring, smem, full, empty, B, D, N, q0, row0, tiles, KT, t);
    } else if (t == 0) {
      // ---- producer: one thread keeps the ring's loads in flight ----
      for (int it = 0; it < tiles * KT; ++it) {
        const int s = it % STAGES, tile = it / KT, col = (it % KT) * 64;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // first use passes
        unsigned char* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load(st, &ring.c, (int)(row0 + tile * TILE), col, &full[s]);
        tma_load(st + C_BYTES, &ring.q, q0, col, &full[s]);
      }
    }
    return false;
  }
  // ---- consumers: warpgroup wg's queries against its rows of each tile ----
  setmaxnreg_inc<232>();
  const int lane = t % 32;
  float acc[L::N / 2];
  int it = 0;
  if constexpr (QM == 64) {
    if (D > PROMOTE_D) {
      float run[L::N / 2];  // the running scores, fp32 adds of the stages' sums
      for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
        for (int i = 0; i < L::N / 2; ++i) run[i] = 0.0f;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          if constexpr (CP) fence_proxy_async();  // the copies, visible to wgmma
          const unsigned char* st = smem + s * STAGE;
#pragma unroll
          for (int i = 0; i < L::N / 2; ++i) acc[i] = 0.0f;
          fence_operands(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = smem_desc(st + C_BYTES + L::q_off(wg) * SLICE + kk * 32, 16, 1024);
            const uint64_t db = smem_desc(st + L::r_off(wg) * SLICE + kk * 32, 16, 1024);
            wgmma_tn_bf16<L::N>(acc, da, db);
          }
          wgmma_commit();
          fence_operands(acc);
          wgmma_wait<0>();  // this stage's products have retired
          fence_operands(acc);
          if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
          for (int i = 0; i < L::N / 2; ++i) run[i] += acc[i];
        }
#pragma unroll
        for (int i = 0; i < L::N / 2; ++i) acc[i] = run[i];
        epilogue(acc, row0 + (long long)tile * TILE + L::r_off(wg));
      }
      return true;
    }
  }
  for (int tile = 0; tile < tiles; ++tile) {
#pragma unroll
    for (int i = 0; i < L::N / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      if constexpr (CP) fence_proxy_async();  // the copies, visible to wgmma
      const unsigned char* st = smem + s * STAGE;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // both K-major: 128-byte rows, 8-row groups 1024 bytes apart, a
        // k-step of 16 columns 32 bytes on
        const uint64_t da = smem_desc(st + C_BYTES + L::q_off(wg) * SLICE + kk * 32, 16, 1024);
        const uint64_t db = smem_desc(st + L::r_off(wg) * SLICE + kk * 32, 16, 1024);
        wgmma_tn_bf16<L::N>(acc, da, db);
      }
      wgmma_commit();
      fence_operands(acc);
      wgmma_wait<1>();  // the previous stage's products have retired
      fence_operands(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    epilogue(acc, row0 + (long long)tile * TILE + L::r_off(wg));
  }
  return true;
}

// ---- the tile-max epilogue: tile_max (bf16) and int8_tile_max (s8) ----

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

// One 256-row unit of a tile-max sweep whose spans are whole tiles
// (tile_max_span): m[h], this thread's running maxima of its query rows qa +
// 8 h, takes the unit's scores in acc.  At a tile's last unit the quad's
// lanes combine them with two shuffles and, in the QM = 64 layout, where
// each warpgroup saw half of the tile's rows, the second warpgroup hands its
// maxima to the first through `handed` (64 values past the ring, between two
// named barriers, so that the next tile's hand-over cannot race this one's
// reads); then it returns true, with the tile's maxima in m in every lane of
// the first warpgroup (of both with QM = 128): the caller stores them and
// restarts m.  The same in both warpgroups: a tile holds whole units.
template <int QM, typename T>
__device__ __forceinline__ bool tile_max_unit(T (&m)[2], const T (&acc)[Layout<QM>::N / 2],
                                              long long rbase, long long tile, T* handed) {
  const int lane = threadIdx.x % 32, wg = threadIdx.x / 128;
#pragma unroll
  for (int j = 0; j < Layout<QM>::NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = vmax(m[h], vmax(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
  if ((rbase / TILE + 1) * TILE % tile != 0) return false;  // not the tile's last unit
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = vmax(m[h], __shfl_xor_sync(FULL_MASK, m[h], 1));
    m[h] = vmax(m[h], __shfl_xor_sync(FULL_MASK, m[h], 2));
  }
  if (QM == 64) {
    const int qb = 16 * (threadIdx.x % 128 / 32) + lane / 4;  // the block's query row qa - q0
    if (wg == 1 && (lane & 3) == 0) {
      handed[qb] = m[0];
      handed[qb + 8] = m[1];
    }
    named_bar_sync(1, 256);
    if (wg == 0) {
      m[0] = vmax(m[0], handed[qb]);
      m[1] = vmax(m[1], handed[qb + 8]);
    }
    named_bar_sync(1, 256);  // read before the next tile's hand-over
  }
  return true;
}

constexpr int UNIT = 128;  // rows of a count's unit: half a 256-row tile

// A count sweep block on bf16_sweep: for each query b of the block and
// each group g its span meets,
//
//     out[b * ngroups + g] += #{ r in group g, r < N : q[b] . c[r] > tau[b] }
//
// with groups of `group` rows, a multiple of UNIT (count_above_groups), or
// one group holding all N rows (count_above: group = N, ngroups = 1); out
// holds zeros before the launch.  Each thread counts, in registers, the
// scores of its two query rows above their thresholds, one UNIT-row unit
// of its accumulators at a time (8 n8 slices of one warpgroup's part of a
// tile), into run[], and flushes run[] at the end of each group it walks:
// two shuffles sum it over the quad and one integer atomicAdd adds the
// total into out, skipped where it is 0.  A group that several warpgroups
// or blocks meet (the two halves of a 256-row group in the QM = 64 layout,
// a group wider than a span, count_above's one group) gets one addition
// from each; integer sums are exact and order-free, so the counts are the
// same bits on every run.  The span is the launch's (fill_span), read at
// run time: with SPAN fixed at compile time the same loops sit 32 bytes
// earlier and the TMA route past PROMOTE_D ran 4-6% faster at D = 30,528
// on an H100 (no configuration has such a width; 768 and 1,536 did not
// move).
template <int QM, bool CP>
__device__ __forceinline__ void count_sweep(const Ring<CP>& ring, const float* __restrict__ tau,
                                            int* __restrict__ out, int B, int D, long long N,
                                            int nqt, long long span, long long group,
                                            long long ngroups) {
  using L = Layout<QM>;
  const int lane = threadIdx.x % 32, qa = query_row<QM>(nqt);
  // trap: queries past B are the producer's zero fill; they get a
  // threshold of 0 here and their counts are never added
  float th[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) th[h] = qa + 8 * h < B ? tau[qa + 8 * h] : 0.0f;
  int run[2] = {0, 0};           // this lane's counts in group g, not yet summed over the quad
  long long g = -1, g_end = -1;  // the group being counted, and the row it ends before

  auto flush = [&] {
    // the quad's sums, reduce-scattered: lane bit 0 picks the query row,
    // and lanes 0 and 1 of the quad end with the totals of qa and qa + 8
    const int h = lane & 1;
    int r = (h ? run[1] : run[0]) + __shfl_xor_sync(FULL_MASK, h ? run[0] : run[1], 1);
    r += __shfl_xor_sync(FULL_MASK, r, 2);
    if (!(lane & 2) && r != 0 && qa + 8 * h < B) atomicAdd(&out[(qa + 8 * h) * ngroups + g], r);
    run[0] = run[1] = 0;
  };

  const bool consumer = bf16_sweep<QM, CP>(
      ring, B, D, N, nqt, span, [&](const float (&acc)[L::N / 2], long long rbase) {
        const int c0 = 2 * (lane & 3);  // acc[4 j + 2 h + e] is column 8 j + c0 + e
#pragma unroll
        for (int v = 0; v < L::N / UNIT; ++v) {
          const long long u0 = rbase + UNIT * v;  // the unit's first row
          // trap: rows at or past N are the producer's zero fill and
          // score exactly 0, above every tau < 0 (the callers subtract
          // only their pad rows, which lie before N): a unit past N is
          // skipped, a ragged one masked by row
          if (u0 >= N) break;
          if (u0 >= g_end) {  // the same for the whole warpgroup: the shuffles converge
            if (g >= 0) flush();
            g = u0 / group;
            g_end = (g + 1) * group;
          }
          // trap: the comparison is strict, in fp32, as the plain version's
          if (N - u0 >= UNIT) {
#pragma unroll
            for (int j = UNIT / 8 * v; j < UNIT / 8 * (v + 1); ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                run[h] += (acc[4 * j + 2 * h] > th[h]) + (acc[4 * j + 2 * h + 1] > th[h]);
          } else {
            const int valid = (int)(N - u0);
#pragma unroll
            for (int j = UNIT / 8 * v; j < UNIT / 8 * (v + 1); ++j) {
              const int col = 8 * (j - UNIT / 8 * v) + c0;
#pragma unroll
              for (int h = 0; h < 2; ++h)
                run[h] += (col < valid && acc[4 * j + 2 * h] > th[h]) +
                          (col + 1 < valid && acc[4 * j + 2 * h + 1] > th[h]);
            }
          }
        }
      });
  if (consumer && g >= 0) flush();
}

// ---- the s8 sweep: int_groupmax, int8_tile_max ----

// four packed bytes -> their low and their high nibbles, each sign-extended
// to a byte: ((p & 0xF) ^ 8) - 8 and the arithmetic p >> 4
__device__ inline void unpack4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  hi = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

constexpr int UNPACKED = 128 * SLICE;  // a warpgroup's low (or high) sign-extended int4 tile

// The shared memory of an s8 sweep block: STAGES ring stages of a 256-row
// corpus slice of 128 bytes and the block's query slices of each plane (a
// packed stage: the low and the high dims' slices), then, for packed rows,
// each warpgroup's unpacked low and high tiles, then the barriers and any
// extra bytes a kernel asks for (s8_extra)
template <int QM, bool PACKED, int PLANES>
struct S8Frame {
  static_assert(!PACKED || QM == 64, "a warpgroup unpacks its own 128 rows");
  static_assert(PLANES == 1 || QM == 64, "two accumulator sets: m64n128 each");
  static constexpr int NSUB = PACKED ? 2 : 1;  // query slices a plane and stage: low, high dims
  static constexpr int STAGE = C_BYTES + PLANES * NSUB * Layout<QM>::Q_BYTES;
  static constexpr int UNPACK = PACKED ? 2 * 2 * UNPACKED : 0;
  static constexpr int STAGES = RING_STAGES<STAGE, UNPACK>;
  static constexpr size_t smem(int extra = 0) { return smem_bytes(STAGES, STAGE, UNPACK + extra); }
};

// the extra bytes of an s8 sweep block launched with them
template <int QM, bool PACKED, int PLANES>
__device__ __forceinline__ unsigned char* s8_extra() {
  using F = S8Frame<QM, PACKED, PLANES>;
  return aligned_smem() + F::STAGES * F::STAGE + F::UNPACK + 2 * F::STAGES * 8;
}

// Launches kernel(tmQ, tmC, args..., B, W, N, nqt), an s8 sweep of QM
// queries a block over spans of `span` rows (a multiple of TILE), with tmQ
// the query planes (PLANES * B, D) bytes in (QM, 128-byte) boxes and tmC the
// corpus (N, W) bytes in (TILE, 128-byte) boxes, and `extra` bytes of
// shared memory past the barriers; block b takes query tile b % nqt and
// span b / nqt.  Returns the failed encode's or the launch's code.
template <int QM, bool PACKED, int PLANES, typename Kernel, typename... Args>
int launch_s8_spans(Kernel kernel, long long span, int extra, const void* q8, const void* corpus,
                    int B, long long N, int D, int W, cudaStream_t stream, Args... args) {
  const int nqt = (B + QM - 1) / QM;
  const long long blocks = (N + span - 1) / span * nqt;
  if (blocks > 0x7fffffffLL || span % TILE != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tc;
  cudaError_t err = make_tmap_bytes(&tq, q8, (long long)PLANES * B, D, QM);
  if (err == cudaSuccess) err = make_tmap_bytes(&tc, corpus, N, W, TILE);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(kernel, dim3((unsigned)blocks), THREADS,
                     S8Frame<QM, PACKED, PLANES>::smem(extra), stream, tq, tc, args..., B, W, N,
                     nqt);
}

// The block's walk over its span of `span` rows (block b: query tile b %
// nqt, span b / nqt), as bf16_sweep, on wgmma m64nNk32 s8 with one int32
// accumulator set a query plane (plane p's queries are rows p * B .. of
// tmQ, so the planes of a query meet in one thread).  sm_90's wgmma has no
// s4 type: a packed stage's bytes (low nibble dim j, high nibble dim j + W)
// are sign-extended by the consumers into an int8 low and high tile in
// shared memory (each warpgroup its own 128 rows, behind a fence and a
// warpgroup barrier), which meet the query columns [c0, c0 + 128) and [W +
// c0, ...): two products a packed load.  Once a tile's products have
// retired each consumer warpgroup calls epilogue(acc, rbase), rbase the
// first corpus row of its part of the tile.  Returns false in the producer
// warpgroup, true in the consumers after the span.
template <int QM, bool PACKED, int PLANES, typename Epilogue>
__device__ __forceinline__ bool s8_sweep(const CUtensorMap& tmQ, const CUtensorMap& tmC, int B,
                                         int W, long long N, int nqt, Epilogue&& epilogue,
                                         long long span = SPAN) {
  using L = Layout<QM>;
  using F = S8Frame<QM, PACKED, PLANES>;
  constexpr int STAGE = F::STAGE, STAGES = F::STAGES, NSUB = F::NSUB;
  unsigned char* smem = aligned_smem();
  unsigned char* unpacked = smem + STAGES * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(unpacked + F::UNPACK);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int q0 = (int)(blockIdx.x % nqt) * QM;
  const long long row0 = (long long)(blockIdx.x / nqt) * span;
  const int tiles = span_tiles(row0, N, span), KT = (W + SLICE - 1) / SLICE;
  ring_init(full, empty, STAGES);

  if (wg == 2) {
    // ---- producer: one thread keeps the ring's loads in flight ----
    setmaxnreg_dec<40>();
    if (t == 0) {
      for (int it = 0; it < tiles * KT; ++it) {
        const int s = it % STAGES, tile = it / KT, col = (it % KT) * SLICE;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);  // first use passes
        unsigned char* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load(st, &tmC, (int)(row0 + tile * TILE), col, &full[s]);
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
#pragma unroll
          for (int sub = 0; sub < NSUB; ++sub)
            tma_load(st + C_BYTES + (p * NSUB + sub) * L::Q_BYTES, &tmQ, p * B + q0,
                     sub * W + col, &full[s]);
      }
    }
    return false;
  }
  // ---- consumers: warpgroup wg's queries against its rows of each tile ----
  setmaxnreg_inc<232>();
  const int lane = t % 32;
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
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + s * STAGE;
      if constexpr (PACKED) {
        // the previous products, the last readers of this warpgroup's
        // unpacked tiles and of the previous stage, have retired
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < PLANES; ++p) fence_operands(acc[p]);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        named_bar_sync(2 + wg, 128);
        const uint4* src = reinterpret_cast<const uint4*>(st + L::r_off(wg) * SLICE);
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
        fence_proxy_async();  // the generic writes, visible to wgmma
        named_bar_sync(2 + wg, 128);
      }
#pragma unroll
      for (int p = 0; p < PLANES; ++p) fence_operands(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
#pragma unroll
        for (int sub = 0; sub < NSUB; ++sub) {
          const unsigned char* a =
              st + C_BYTES + (p * NSUB + sub) * L::Q_BYTES + L::q_off(wg) * SLICE;
          const unsigned char* b = PACKED ? lo_tile + sub * UNPACKED : st + L::r_off(wg) * SLICE;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // 32-byte k-steps through the 128-byte slice
            wgmma_tn_s8<L::N>(acc[p], smem_desc(a + kk * 32, 16, 1024),
                              smem_desc(b + kk * 32, 16, 1024));
        }
      wgmma_commit();
#pragma unroll
      for (int p = 0; p < PLANES; ++p) fence_operands(acc[p]);
      if constexpr (!PACKED) {
        wgmma_wait<1>();  // the previous stage's products have retired
#pragma unroll
        for (int p = 0; p < PLANES; ++p) fence_operands(acc[p]);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < PLANES; ++p) fence_operands(acc[p]);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    epilogue(acc, row0 + (long long)tile * TILE + L::r_off(wg));
  }
  return true;
}

}  // namespace gmax_sweep
