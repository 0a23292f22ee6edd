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
// Design: as mips_scan.cu, a block owns (64 queries of every plane, a span of
// rows): i4_groupmax a SPAN-row span, writing per 128-row tile the 16 group
// maxima (and rows) of each query, coalesced along the query axis of the
// (groups, B) layout; tile_max one whole tile, reduced in shared memory and
// written once.  The query tiles of one span are neighbouring block indices,
// so they run together and read the span's corpus bytes from L2.  Simple
// first: no cp.async/TMA pipelining, no resident query tile, no wgmma.
#include "int_tile.cuh"

#include <limits.h>

using namespace int_tile;

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
  extern __shared__ __align__(128) unsigned char smem[];
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
  extern __shared__ __align__(128) unsigned char smem[];
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

// Opt the kernel into its dynamic shared memory; 0 or a cudaError_t code.
template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <bool PACKED, int PLANES>
int launch_groupmax(const Operands& op, const void* row_sc, const void* q_sc, void* vals,
                    void* rows, long long N, float lo_weight, cudaStream_t stream) {
  const size_t smem = Tile<PACKED, PLANES>::smem_bytes();
  if (int err = prepare(int_groupmax_kernel<PACKED, PLANES>, smem)) return err;
  const int nqt = (op.B + QT - 1) / QT;
  const long long blocks = (N + SPAN - 1) / SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int_groupmax_kernel<PACKED, PLANES><<<(unsigned)blocks, THREADS, smem, stream>>>(
      op, (const float*)row_sc, (const float*)q_sc, (float*)vals, (int*)rows, N, nqt, lo_weight);
  return (int)cudaGetLastError();
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
  if (packed && planes == 1) return launch_groupmax<true, 1>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  if (packed && planes == 2) return launch_groupmax<true, 2>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  if (!packed && planes == 1) return launch_groupmax<false, 1>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  if (!packed && planes == 2) return launch_groupmax<false, 2>(op, row_sc, q_sc, vals, rows, N, lo_weight, s);
  return (int)cudaErrorInvalidValue;
}

// q8 (B, D) int8, corpus (N, D) int8; out (N / tile, B) int32.
extern "C" int dst_int8_tile_max(const void* q8, const void* corpus, void* out, int B,
                                 long long N, int D, long long tile, void* stream) {
  if (B < 1 || D < 1 || N < 1 || tile < 1 || N % tile != 0) return (int)cudaErrorInvalidValue;
  const Operands op{(const int8_t*)q8, (const int8_t*)corpus, B, D, D,
                    vectorizable(q8, corpus, D, D)};
  const size_t smem = Tile<false, 1>::smem_bytes() + STRIDES * QT * 4;
  if (int err = prepare(int8_tile_max_kernel, smem)) return err;
  const int nqt = (B + QT - 1) / QT;
  const long long ntiles = N / tile;
  if (ntiles * nqt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int8_tile_max_kernel<<<(unsigned)(ntiles * nqt), THREADS, smem, (cudaStream_t)stream>>>(
      op, (int*)out, tile, ntiles, nqt);
  return (int)cudaGetLastError();
}
