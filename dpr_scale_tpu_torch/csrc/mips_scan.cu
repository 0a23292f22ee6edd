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
// A block owns (64 queries, a span of rows): count_above and groupmax take
// SPAN-row spans, tile_max one whole tile, so its running max is written
// once.  count_above reduces its span's counts in shared memory and makes one
// integer atomicAdd per query (exact and order-free, so the result is
// deterministic); groupmax writes 16 tier-1 maxima and one tier-2 maximum
// per query and 128-row tile, stores coalesced along the query axis of the
// (groups, B) layout.  The query tiles of one span are neighbouring block
// indices, so they run together and read the span's corpus rows from L2.
// Simple first: no cp.async/TMA pipelining, no resident query tile.
#include "score_tile.cuh"

using namespace mips_tile;

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
  extern __shared__ __align__(128) unsigned char smem[];
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
  extern __shared__ __align__(128) unsigned char smem[];
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
  extern __shared__ __align__(128) unsigned char smem[];
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

// Opt the kernel into its dynamic shared memory; 0 or a cudaError_t code.
template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int launch_count(const void* q, const void* corpus, const void* tau, void* out, int B,
                 long long N, int D, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + QT * 4;
  if (int err = prepare(count_above_kernel<T>, smem)) return err;
  const int nqt = (B + QT - 1) / QT;
  const long long blocks = (N + SPAN - 1) / SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  count_above_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)corpus, (const float*)tau, (int*)out, B, D, N, nqt,
      vectorizable<T>(q, corpus, D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_groupmax(const void* q, const void* corpus, void* t1, void* t2, int B, long long N,
                    int D, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + T1_PER_TILE * QT * 4;
  if (int err = prepare(groupmax_kernel<T>, smem)) return err;
  const int nqt = (B + QT - 1) / QT;
  const long long blocks = (N + SPAN - 1) / SPAN * nqt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  groupmax_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)q, (const T*)corpus, (float*)t1, (float*)t2, B, D, N, nqt,
      vectorizable<T>(q, corpus, D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile_max(const void* q, const void* corpus, void* out, int B, long long N, int D,
                    long long tile, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + STRIDES * QT * 4;
  if (int err = prepare(tile_max_kernel<T>, smem)) return err;
  const int nqt = (B + QT - 1) / QT;
  const long long ntiles = N / tile;
  if (ntiles * nqt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_max_kernel<T><<<(unsigned)(ntiles * nqt), THREADS, smem, stream>>>(
      (const T*)q, (const T*)corpus, (float*)out, B, D, tile, ntiles, nqt,
      vectorizable<T>(q, corpus, D));
  return (int)cudaGetLastError();
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

// t1 (N / 8, B) and t2 (N / 128, B) fp32.
extern "C" int dst_groupmax(const void* q, const void* corpus, void* t1, void* t2, int B,
                            long long N, int D, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1 || N % ROWS != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_groupmax<bf16>(q, corpus, t1, t2, B, N, D, (cudaStream_t)stream);
  if (dtype == 1) return launch_groupmax<float>(q, corpus, t1, t2, B, N, D, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
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
