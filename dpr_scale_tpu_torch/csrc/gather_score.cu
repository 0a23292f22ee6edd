// Posting gather-score for the CITADEL / COIL device search.
//
// For posting blocks vecs (n_exp, L, D) (bf16 or fp32), per-entry slots (E,)
// int32 and entry query vectors q (E, D) already rounded to the postings'
// dtype, all three kernels write
//
//     out[e, l] = sum_d vecs[slots[e], l, d] * q[e, d]          (E, L) fp32
//
// with the products and the sum in fp32 (fp32 FMAs on CUDA cores: no TF32,
// no tensor cores, so fp32 postings reproduce the host search, the port's
// side of the Precision.HIGHEST note at dpr_scale_tpu/index/inverted_device.py
// :586-595).  An entry whose slot lies outside [0, n_exp) scores 0 (the pad
// slot n_exp of the streamed layout).  They replace the three Pallas
// scorers of dpr_scale_tpu/index/inverted_device.py:
//
//   * gather_serial_kernel    <- _scores_pallas_serial (pallas_call at :431);
//   * gather_pipelined_kernel <- _scores_pallas        (pallas_call at :550);
//   * gather_streamed_kernel  <- _scores_streamed      (pallas_call at :648).
//
// What bounds them on an H100: bytes.  At D = 32 bf16 a posting row is 64
// bytes and yields 32 multiply-adds and one 4-byte score, about one operation
// per byte, far below the card's ~295 operations per byte of bf16 tensor rate
// (and still below its fp32 CUDA-core rate).  So the design only has to read
// each posting row once with wide coalesced loads and write each score once:
//
//   * serial: a block scores one entry over one L-tile.  Each warp takes 32
//     consecutive rows; a row is read by TPR lanes with 16-byte loads (at
//     D = 32 bf16, 4 lanes per row, 8 rows per load instruction, 512 bytes
//     contiguous), the lanes' fp32 partial sums meet in a shuffle reduction,
//     and a second shuffle hands row i's score to lane i, so each warp stores
//     32 consecutive floats (128 bytes).  q sits in registers.  No shared
//     memory: a posting row is used by one entry only.
//   * pipelined: the same arithmetic, with the TPU kernel's idea of a
//     two-stage ring: a persistent block walks (G entries x TL rows) work
//     items, and cp.async stages the next item's (G, TL, D) posting tiles in
//     shared memory while the current one is scored from shared memory.
//   * streamed: entries arrive sorted by slot, cut on the host into pieces of
//     equal slot (at most 64 entries each).  A block owns one piece and one
//     L-tile: it loads the (TL, D) posting tile into shared memory once and
//     scores every entry of the piece against it, so an expert hit by many
//     entries (a "stopword" expert) is read from device memory once per piece
//     rather than once per entry.  The TPU's step table is a TPU schedule; the
//     piece offsets replace it.
//
// Any D works: rows whose byte width is a multiple of 16 (and 16-byte aligned
// bases) take 16-byte loads, other widths element loads.  A lane holds up to
// CPL chunks of q, so D <= 32 * 8 * (16 / sizeof(T)) with 16-byte loads and
// D <= 256 with element loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// VEC consecutive elements at p as floats: one 16-byte load when VEC spans
// 16 bytes, else one element
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = src[i];
  }
}

// Per-launch geometry: C chunks of VEC elements per row, TPR lanes per row
// (a power of two <= 32), each lane owning chunks lane % TPR + k * TPR.
struct Geometry {
  int L, D, C, TPR;
  long long n_exp;
};

// this lane's chunks of the query row q (zeros past the row)
template <typename T, int VEC, int CPL>
__device__ __forceinline__ void load_query(const T* q, const Geometry& g, int lane,
                                           float (&qr)[CPL][VEC]) {
  const int t = lane % g.TPR;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = t + k * g.TPR;
    if (c < g.C) {
      load_chunk<T, VEC>(q + c * VEC, qr[k]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[k][i] = 0.0f;
    }
  }
}

// Scores of up to 32 consecutive rows starting at `rows` (row stride D; only
// the first `valid` rows are read).  Returns row `lane`'s score in lane
// `lane`.  Rows go TPR lanes each, RPW = 32 / TPR rows per pass, TPR passes.
template <typename T, int VEC, int CPL>
__device__ __forceinline__ float score_rows32(const T* rows, int valid, const Geometry& g,
                                              int lane, const float (&qr)[CPL][VEC]) {
  const int TPR = g.TPR, RPW = 32 / TPR;
  const int t = lane % TPR, r = lane / TPR;
  float mine = 0.0f;
#pragma unroll 4
  for (int s = 0; s < TPR; ++s) {
    const int row = s * RPW + r;
    float acc = 0.0f;
    if (row < valid) {
      const T* p = rows + (size_t)row * g.D;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = t + k * TPR;
        if (c < g.C) {
          float v[VEC];
          load_chunk<T, VEC>(p + c * VEC, v);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc = fmaf(v[i], qr[k][i], acc);
        }
      }
    }
    for (int o = TPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    const float v = __shfl_sync(FULL, acc, (lane % RPW) * TPR);
    if (lane / RPW == s) mine = v;
  }
  return mine;
}

// out[0, nrows) = the scores of the (nrows, D) block at `block` against q
// in registers; warps take 32-row chunks in turn
template <typename T, int VEC, int CPL>
__device__ __forceinline__ void score_block(const T* block, float* out, int nrows,
                                            const Geometry& g, const float (&qr)[CPL][VEC]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = warp * 32; r0 < nrows; r0 += WARPS * 32) {
    const int valid = nrows - r0;
    const float s = score_rows32<T, VEC, CPL>(block + (size_t)r0 * g.D, valid, g, lane, qr);
    if (lane < valid) out[r0 + lane] = s;
  }
}

__device__ __forceinline__ void zero_rows(float* orow, int l0, int l1) {
  for (int l = l0 + threadIdx.x; l < l1; l += THREADS) orow[l] = 0.0f;
}

// ---------------------------------------------------------------- serial

// grid (E, ceil(L / TL)): block (e, j) scores entry e over rows [j TL, ...)
template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(THREADS)
gather_serial_kernel(const T* __restrict__ vecs, const int* __restrict__ slots,
                     const T* __restrict__ q, float* __restrict__ out, Geometry g, int TL) {
  const int e = blockIdx.x;
  const int l0 = blockIdx.y * TL, l1 = min(g.L, l0 + TL);
  const int slot = slots[e];
  float* orow = out + (size_t)e * g.L;
  if (slot < 0 || slot >= g.n_exp) {
    zero_rows(orow, l0, l1);
    return;
  }
  float qr[CPL][VEC];
  load_query<T, VEC, CPL>(q + (size_t)e * g.D, g, threadIdx.x % 32, qr);
  const T* block = vecs + ((size_t)slot * g.L + l0) * g.D;
  score_block<T, VEC, CPL>(block, orow + l0, l1 - l0, g, qr);
}

// ---------------------------------------------------------------- pipelined

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Items {
  int E, G, TL, J;  // entries, entries per item, rows per item, L-tiles
  long long n;      // work items: ceil(E / G) * J
};

// stage item t's (G, TL, D) posting tiles into dst (asynchronously when a
// chunk is 16 bytes)
template <typename T, int VEC>
__device__ __forceinline__ void stage_item(T* dst, const T* __restrict__ vecs,
                                           const int* __restrict__ slots, long long t,
                                           const Items& it, const Geometry& g) {
  const int i = (int)(t / it.J), j = (int)(t % it.J);
  const int l0 = j * it.TL, nrows = min(it.TL, g.L - l0);
  const int per_entry = nrows * g.C;
  for (int idx = threadIdx.x; idx < it.G * per_entry; idx += THREADS) {
    const int gi = idx / per_entry, rem = idx % per_entry;
    const int e = i * it.G + gi;
    if (e >= it.E) break;  // idx grows with gi, so every later idx is past E too
    const int slot = slots[e];
    if (slot < 0 || slot >= g.n_exp) continue;
    const int l = rem / g.C, c = rem % g.C;
    const T* src = vecs + ((size_t)slot * g.L + l0 + l) * g.D + c * VEC;
    T* d = dst + ((size_t)gi * it.TL + l) * g.D + c * VEC;
    if constexpr (VEC * sizeof(T) == 16) {
      cp_async16(d, src);
    } else {
      copy_chunk<T, VEC>(d, src);
    }
  }
}

// persistent blocks: block b takes items b, b + gridDim.x, ...
template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(THREADS)
gather_pipelined_kernel(const T* __restrict__ vecs, const int* __restrict__ slots,
                        const T* __restrict__ q, float* __restrict__ out, Geometry g,
                        Items it) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const size_t stage_elems = (size_t)it.G * it.TL * g.D;
  long long t = blockIdx.x;
  if (t >= it.n) return;
  stage_item<T, VEC>(ring, vecs, slots, t, it, g);
  cp_async_commit();
  int buf = 0;
  for (; t < it.n; t += gridDim.x) {
    const long long next = t + gridDim.x;
    if (next < it.n) stage_item<T, VEC>(ring + (buf ^ 1) * stage_elems, vecs, slots, next, it, g);
    cp_async_commit();
    cp_async_wait<1>();  // item t's copies have landed
    __syncthreads();
    const int i = (int)(t / it.J), j = (int)(t % it.J);
    const int l0 = j * it.TL, l1 = min(g.L, l0 + it.TL);
    for (int gi = 0; gi < it.G; ++gi) {
      const int e = i * it.G + gi;
      if (e >= it.E) break;
      float* orow = out + (size_t)e * g.L + l0;
      const int slot = slots[e];
      if (slot < 0 || slot >= g.n_exp) {
        zero_rows(orow, 0, l1 - l0);
        continue;
      }
      float qr[CPL][VEC];
      load_query<T, VEC, CPL>(q + (size_t)e * g.D, g, threadIdx.x % 32, qr);
      score_block<T, VEC, CPL>(ring + buf * stage_elems + (size_t)gi * it.TL * g.D, orow,
                               l1 - l0, g, qr);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- streamed

// grid (pieces, ceil(L / TL)): block (p, j) scores the entries
// [pieces[p], pieces[p + 1]), which share one slot, over rows [j TL, ...)
template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(THREADS)
gather_streamed_kernel(const T* __restrict__ vecs, const int* __restrict__ slots,
                       const T* __restrict__ q, float* __restrict__ out,
                       const int* __restrict__ pieces, Geometry g, int TL) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int e0 = pieces[blockIdx.x], e1 = pieces[blockIdx.x + 1];
  const int l0 = blockIdx.y * TL, nrows = min(TL, g.L - l0);
  const int slot = slots[e0];
  if (slot < 0 || slot >= g.n_exp) {
    for (int e = e0; e < e1; ++e) zero_rows(out + (size_t)e * g.L + l0, 0, nrows);
    return;
  }
  const T* src = vecs + ((size_t)slot * g.L + l0) * g.D;
  for (int idx = threadIdx.x; idx < nrows * g.C; idx += THREADS) {
    const int l = idx / g.C, c = idx % g.C;
    copy_chunk<T, VEC>(tile + (size_t)l * g.D + c * VEC, src + (size_t)l * g.D + c * VEC);
  }
  __syncthreads();
  for (int e = e0; e < e1; ++e) {
    float qr[CPL][VEC];
    load_query<T, VEC, CPL>(q + (size_t)e * g.D, g, threadIdx.x % 32, qr);
    score_block<T, VEC, CPL>(tile, out + (size_t)e * g.L + l0, nrows, g, qr);
  }
}

// ---------------------------------------------------------------- launch

enum Kind { SERIAL = 0, PIPELINED = 1, STREAMED = 2 };

struct Launch {
  const void *vecs, *slots, *q, *pieces;
  void* out;
  int kind, rows;  // rows: entries (serial, pipelined) or pieces (streamed)
  int tile, group;
  cudaStream_t stream;
};

template <typename T, int VEC, int CPL>
int launch(const Launch& a, Geometry g) {
  const T* vecs = (const T*)a.vecs;
  const T* q = (const T*)a.q;
  const int* slots = (const int*)a.slots;
  float* out = (float*)a.out;
  const int J = (g.L + a.tile - 1) / a.tile;
  if (J > 65535) return (int)cudaErrorInvalidValue;
  if (a.kind == SERIAL) {
    gather_serial_kernel<T, VEC, CPL><<<dim3(a.rows, J), THREADS, 0, a.stream>>>(
        vecs, slots, q, out, g, a.tile);
  } else if (a.kind == PIPELINED) {
    Items it{a.rows, a.group, a.tile, J, (long long)((a.rows + a.group - 1) / a.group) * J};
    const size_t smem = 2 * (size_t)a.group * a.tile * g.D * sizeof(T);
    auto kern = gather_pipelined_kernel<T, VEC, CPL>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long blocks = it.n < (long long)per_sm * sms ? it.n : (long long)per_sm * sms;
    kern<<<(unsigned)blocks, THREADS, smem, a.stream>>>(vecs, slots, q, out, g, it);
  } else {
    const size_t smem = (size_t)a.tile * g.D * sizeof(T);
    auto kern = gather_streamed_kernel<T, VEC, CPL>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(a.rows, J), THREADS, smem, a.stream>>>(vecs, slots, q, out,
                                                       (const int*)a.pieces, g, a.tile);
  }
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int by_cpl(const Launch& a, Geometry g) {
  // TPR lanes per row, a power of two <= 32; CPL = ceil(C / TPR) chunks a lane
  int tpr = 1;
  while (tpr < g.C && tpr < 32) tpr *= 2;
  g.TPR = tpr;
  const int cpl = (g.C + tpr - 1) / tpr;
  if (cpl <= 1) return launch<T, VEC, 1>(a, g);
  if (cpl <= 2) return launch<T, VEC, 2>(a, g);
  if (cpl <= 4) return launch<T, VEC, 4>(a, g);
  if (cpl <= 8) return launch<T, VEC, 8>(a, g);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_width(const Launch& a, Geometry g) {
  constexpr int VEC = 16 / sizeof(T);
  const bool wide = g.D % VEC == 0 && (uintptr_t)a.vecs % 16 == 0 && (uintptr_t)a.q % 16 == 0;
  if (wide) {
    g.C = g.D / VEC;
    return by_cpl<T, VEC>(a, g);
  }
  g.C = g.D;
  return by_cpl<T, 1>(a, g);
}

int dispatch(const Launch& a, long long n_exp, int L, int D, int dtype) {
  if (a.rows < 1 || L < 1 || D < 1 || n_exp < 1 || a.tile < 1 || a.group < 1)
    return (int)cudaErrorInvalidValue;
  Geometry g{L, D, 0, 0, n_exp};
  if (dtype == 0) return by_width<bf16>(a, g);
  if (dtype == 1) return by_width<float>(a, g);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (postings and queries alike).  Each returns a
// cudaError_t code: 0 on a launch that was accepted.
extern "C" int dst_gather_serial(const void* vecs, const void* slots, const void* q, void* out,
                                 int E, long long n_exp, int L, int D, int tile, int dtype,
                                 void* stream) {
  Launch a{vecs, slots, q, nullptr, out, SERIAL, E, tile, 1, (cudaStream_t)stream};
  return dispatch(a, n_exp, L, D, dtype);
}

extern "C" int dst_gather_pipelined(const void* vecs, const void* slots, const void* q,
                                    void* out, int E, long long n_exp, int L, int D, int tile,
                                    int group, int dtype, void* stream) {
  Launch a{vecs, slots, q, nullptr, out, PIPELINED, E, tile, group, (cudaStream_t)stream};
  return dispatch(a, n_exp, L, D, dtype);
}

extern "C" int dst_gather_streamed(const void* vecs, const void* slots, const void* q,
                                   void* out, const void* pieces, int n_pieces,
                                   long long n_exp, int L, int D, int tile, int dtype,
                                   void* stream) {
  Launch a{vecs, slots, q, pieces, out, STREAMED, n_pieces, tile, 1, (cudaStream_t)stream};
  return dispatch(a, n_exp, L, D, dtype);
}
