// The common frame of the two wgmma group-max sweeps (mips_scan.cu's bf16
// groupmax, int_scan.cu's int8 / int4 int_groupmax): a block of 384 threads
// owns QM queries and a SPAN-row span of corpus rows, walked in TILE-row
// tiles.  One producer warp issues 2-D TMA loads (128-byte swizzle, zero
// fill past the matrix) of a tile's corpus rows and the block's query rows,
// one 128-byte slice of each row a stage, into a ring of full / empty
// mbarriers that runs on across the span's tiles; two consumer warpgroups
// run wgmma with queries on M and corpus rows on N, both operands K-major,
// the accumulators in registers.  Thread t of a warpgroup then holds, for
// its query rows 16 (t / 32) + (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t %
// 4) + {0, 1} of each n8 slice j: an 8-row corpus group is one slice, held
// by the four lanes of a quad, so its maximum is an in-thread max and two
// shuffles, and no score reaches shared or device memory.
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

// full[s] waits for the producer's one arrival and the stage's bytes,
// empty[s] for one arrival of each consumer warp
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// corpus rows [row0, row0 + SPAN) of this block, cut at N: its TILE-row tiles
__device__ __forceinline__ int span_tiles(long long row0, long long N) {
  const long long rows = N - row0 < SPAN ? N - row0 : SPAN;
  return (int)((rows + TILE - 1) / TILE);
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

}  // namespace gmax_sweep
