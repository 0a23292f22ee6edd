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
// with fp32 sums of bf16 or fp32 products.  The (B, N) scores never reach
// device memory.
//
// What bounds it on an H100: at large B the B x N x D product, so the
// tensor-core rate (B = 512 over 2M x 768 rows: 1.67 ms); at small B
// (serving batches of 8-64 queries) the single read of the N x D corpus, so
// HBM bandwidth (B = 64: 0.96 ms).
//
// A bf16 corpus whose rows TMA can address (D % 8 == 0, 16-byte aligned
// bases), cut in groups of a multiple of 128 rows, runs
// count_groups_wgmma_kernel on gmax_sweep.cuh's frame: a block owns 128
// queries (B > 64) or 64 and a 2,048-row span (eight of the fused search's
// 256-row groups); a ring of TMA loads feeds two consumer warpgroups on
// wgmma (queries on M, corpus rows on N, fp32 sums in registers); per
// 128-row unit of its accumulators each thread counts the scores of its
// two query rows above their thresholds, and at the end of each group two
// shuffles sum the quad and one integer atomicAdd adds the total into the
// output (zeroed first by the entry point), skipped where it is 0: a
// 256-row group is one warpgroup's tile (one addition) with 128 queries,
// two halves (two additions) with 64.  Counts go straight from registers
// to the (B, N / group) layout; no shared-memory staging, since at the
// fused search's thresholds nearly every count is 0 and makes no store at
// all.
//
// Every other call (an fp32 corpus, D % 8 != 0, a group that is not a
// multiple of 128) runs count_groups_kernel on score_tile.cuh's tile: one
// block owns one (64-query tile, row group) pair whole and walks the group
// in 128-row score tiles (wmma, synchronous staging); each fp32 tile is
// compared with tau in shared memory and reduced to one count per query,
// stored once, so any group size that divides N works (a single group
// spanning the corpus included).  dst_count_above_groups_route says which
// kernel a call takes.
#include "gmax_sweep.cuh"  // first: the emulation defines the CUDA keywords there
#include "score_tile.cuh"

using namespace mips_tile;
namespace gs = gmax_sweep;

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
count_groups_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
                    const float* __restrict__ tau, int* __restrict__ out, int B, int D,
                    long long group, long long ngroups, bool vec_ok) {
  unsigned char* smem = dst_hopper::dynamic_smem();
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

// count_above_groups over a TMA-addressable bf16 corpus, groups a multiple
// of gs::UNIT rows (gmax_sweep.cuh's count_sweep); out zeroed
template <int QM>
__global__ void __launch_bounds__(gs::THREADS, 1)
count_groups_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmC, const float* __restrict__ tau,
                          int* __restrict__ out, long long group, long long ngroups, int B, int D,
                          long long N, int nqt) {
  gs::count_sweep<QM>(tmQ, tmC, tau, out, B, D, N, nqt, group, ngroups);
}

template <typename T>
int launch_count_groups(const void* q, const void* corpus, const void* tau, void* out, int B,
                        long long N, int D, long long group, cudaStream_t stream) {
  const size_t smem = Tile<T>::smem_bytes() + QT * 4;
  const long long ngroups = N / group;
  const dim3 grid((unsigned)ngroups, (B + QT - 1) / QT);
  return (int)dst_hopper::launch(count_groups_kernel<T>, grid, THREADS, smem, stream,
                                 (const T*)q, (const T*)corpus, (const float*)tau, (int*)out, B,
                                 D, group, ngroups, vectorizable<T>(q, corpus, D));
}

// out zeroed first: the blocks add their counts into it
template <int QM>
int launch_count_groups_wgmma(const void* q, const void* corpus, const void* tau, void* out,
                              int B, long long N, int D, long long group, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)B * (N / group) * 4, stream);
  if (err != cudaSuccess) return (int)err;
  return gs::launch_bf16_sweep<QM>(count_groups_wgmma_kernel<QM>, q, corpus, B, N, D, stream,
                                   (const float*)tau, (int*)out, group, N / group);
}

int wgmma_route(const void* q, const void* corpus, long long N, int D, long long group,
                int dtype) {
  return gs::bf16_route(q, corpus, N, D, dtype) && group % gs::UNIT == 0;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (queries and corpus alike).  Returns a
// cudaError_t code: 0 on a launch that was accepted.  The route is chosen
// by shape alone (dst_count_above_groups_route); a failed tensor-map encode
// returns its code.
extern "C" int dst_count_above_groups(const void* q, const void* corpus,
                                      const void* tau, void* out, int B, long long N,
                                      int D, long long group, int dtype, void* stream) {
  if (B < 1 || D < 1 || N < 1 || group < 1 || N % group != 0 || N / group > 0x7fffffffLL ||
      (B + QT - 1) / QT > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool qm128 = gs::bf16_qm128(B, D);
  if (wgmma_route(q, corpus, N, D, group, dtype))
    return qm128 ? launch_count_groups_wgmma<128>(q, corpus, tau, out, B, N, D, group, s)
                 : launch_count_groups_wgmma<64>(q, corpus, tau, out, B, N, D, group, s);
  if (dtype == 0) return launch_count_groups<bf16>(q, corpus, tau, out, B, N, D, group, s);
  if (dtype == 1) return launch_count_groups<float>(q, corpus, tau, out, B, N, D, group, s);
  return (int)cudaErrorInvalidValue;
}

// 1: dst_count_above_groups takes the wgmma kernel on these arguments; 0:
// score_tile.
extern "C" int dst_count_above_groups_route(const void* q, const void* corpus, long long N,
                                            int D, long long group, int dtype) {
  return wgmma_route(q, corpus, N, D, group, dtype);
}
