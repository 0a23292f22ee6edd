// Per-query, per-row-group count of inner-product scores above a threshold.
//
// Replaces the TPU kernel dpr_scale_tpu/ops/mips_kernels.py::
// _count_groups_kernel (the pallas_call in count_above_groups_kernel): pass 2
// of the verified-exact fused MIPS pipeline (dpr_scale_tpu/index/mips.py
// _fused_search_impl).  For queries q (B, D), corpus rows c (N, D) and
// thresholds tau (B,) fp32 it writes
//
//     out[b, g] = #{ r in group g : q[b] . c[r] > tau[b] }     (B, N / group) int32
//
// with fp32 accumulation of bf16 (tensor cores, wmma) or fp32 (scalar FMA)
// inputs (score_tile.cuh).  The (B, N) scores never reach device memory.
//
// What bounds it on an H100: at large B the B x N x D product, so the
// tensor-core rate; at small B (serving batches of 8-64 queries) the single
// read of the N x D corpus, so HBM bandwidth.  Design: one block owns one
// (64-query tile, row group) pair whole and walks the group in 128-row score
// tiles; each fp32 tile is compared with tau in shared memory and reduced to
// one count per query.  A block owns its group, so there are no atomics in device
// memory and no second pass, and any group size that divides N works (a
// single group spanning the corpus included).
#include "score_tile.cuh"

using namespace mips_tile;

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
count_groups_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                    const float* __restrict__ tau, int* __restrict__ out, int B, int D,
                    long long group, long long ngroups, bool vec_ok) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> sm(smem);
  int* sCnt = reinterpret_cast<int*>(sm.extra);  // (QT,)

  const long long g = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int q_valid = min(QT, B - q0);
  const T* qbase = q + (size_t)q0 * D;
  const int tid = threadIdx.x;
  const int my_q = tid % QT, my_r0 = tid / QT;  // count phase: one query, every 4th row
  const float my_tau = my_q < q_valid ? tau[q0 + my_q] : 0.0f;
  int my_count = 0;
  if (tid < QT) sCnt[tid] = 0;

  for (long long rbase = 0; rbase < group; rbase += ROWS) {
    const int r_valid = (int)min((long long)ROWS, group - rbase);
    score_tile(sm, corpus + ((size_t)g * group + rbase) * D, qbase, r_valid, q_valid, D,
               vec_ok);
    for (int r = my_r0; r < r_valid; r += THREADS / QT)
      my_count += sm.s[r * LDS + my_q] > my_tau;
  }
  atomicAdd(&sCnt[my_q], my_count);  // shared-memory reduction of the 4 row strides
  __syncthreads();
  if (tid < q_valid) out[(size_t)(q0 + tid) * ngroups + g] = sCnt[tid];
}

template <typename T>
int launch(const void* q, const void* corpus, const void* tau, void* out, int B,
           long long N, int D, long long group, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + QT * 4;
  cudaError_t err = cudaFuncSetAttribute(
      count_groups_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ngroups = N / group;
  const bool vec_ok = vectorizable<T>(q, corpus, D);
  const dim3 grid((unsigned)ngroups, (B + QT - 1) / QT);
  count_groups_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)corpus, (const float*)tau, (int*)out, B, D, group, ngroups, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (queries and corpus alike).  Returns a
// cudaError_t code: 0 on a launch that was accepted.
extern "C" int dst_count_above_groups(const void* q, const void* corpus,
                                      const void* tau, void* out, int B, long long N,
                                      int D, long long group, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1 || group < 1 || N % group != 0 || N / group > 0x7fffffffLL ||
      (B + QT - 1) / QT > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<bf16>(q, corpus, tau, out, B, N, D, group, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<float>(q, corpus, tau, out, B, N, D, group, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
