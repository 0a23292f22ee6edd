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
//   * gather_bulk_kernel and gather_pipelined_kernel
//                             <- _scores_pallas        (pallas_call at :550);
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
//   * pipelined: the same arithmetic (the same bits as serial), with the
//     TPU kernel's idea of a ring of posting tiles in flight.  On rows of
//     16-byte multiples, gather_bulk_kernel: persistent blocks, one producer
//     warp fetching each entry's (TL, D) tile with one bulk copy into one of
//     three rings of up to 3 stages on full / empty mbarriers, one for each
//     group of 8 consumer warps, the groups scoring the landed tiles in
//     turn from shared memory (below, and hopper_ptx.cuh's bulk_load).  Other rows keep the first design, gather_pipelined_kernel:
//     a two-stage buffer the block fills with element copies.
//     dst_gather_pipelined_route says which a call takes.
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
#include "hopper_ptx.cuh"  // first: the emulation defines the CUDA keywords there

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

struct Items {
  int E, G, TL, J;  // entries, entries per item, rows per item, L-tiles
  long long n;      // work items: ceil(E / G) * J
};

// Rows whose byte width is a multiple of 16 (with 16-byte aligned bases):
// gather_bulk_kernel.  A persistent block of CONSUMERS consumer warps and
// one producer warp walks the work items t = blockIdx.x, + gridDim.x, ...,
// item t being entry t / J's rows [l0, l0 + TL), l0 = (t % J) TL.  That
// posting tile, vecs[slot, l0 : l0 + TL, :], is contiguous in device
// memory, so the producer fetches it with one 1-D bulk copy (cp.async.bulk,
// its bytes counted on the stage's full mbarrier), and the entry's query
// row with a second, into the next stage of a ring of stages that runs
// across the items; no tensor map, since 2-D TMA boxes need 128-byte rows and a D = 32
// bf16 row is 64 bytes.  The producer warp reads the slots of 32 items at
// once and writes each stage's entry and first row into the stage's
// header, so no load of device memory and no division lies on the
// consumers' path.  An entry on a pad slot takes no stage and no copy: the
// producer warp writes its zeros.  The consumer warps form GROUPS groups
// that take the live items in turn (group g the k-th where k % GROUPS ==
// g), so that one group's per-item latency overlaps another's; each group
// has a ring of its own (spg stages), so that a group only ever waits on a
// stage whose previous use it consumed itself (on a shared ring, a group
// could wait on a stage whose earlier item, another group's, had not
// landed yet, and the mbarrier's phase parity would pass it at once).  A
// group's warps take the tile's 32-row chunks in turn, rotating over its
// items so that small tiles spread over them too, score each chunk with q
// in registers (score_rows32: the serial kernel's lane split and shuffle
// order, so the two kernels give the same bits), store its 32 scores as
// one 128-byte run, and release the stage on its empty mbarrier, one
// arrival a warp.  An entry of -1 in a header ends a group's walk.  No
// block-wide barrier after the start.  Three groups of 8 warps and 16 KB
// stages timed best of the shapes tried on an H100 (tools/bench_sweeps.py's
// buckets).
constexpr int GROUPS = 3;
constexpr int GROUP_WARPS = 8;
constexpr int CONSUMERS = GROUPS * GROUP_WARPS;
constexpr int BULK_THREADS = 32 * (CONSUMERS + 1);
constexpr int MAX_SPG = 3;  // stages a group's ring holds at most
constexpr int HEADER = 16;  // bytes of a stage's header: entry and first row
constexpr size_t SMEM_LIMIT = 232448;  // an H100 block's shared memory

// a stage of the ring: its header, the entry's query row, TL posting rows
__host__ __device__ inline size_t bulk_stage_bytes(int TL, int D, int elem_bytes) {
  return HEADER + (size_t)(TL + 1) * D * elem_bytes;
}

// stages a group's ring holds: as many of stage_bytes, with their two
// 8-byte mbarriers each, as fit GROUPS times in a block's shared memory
inline int bulk_spg(size_t stage_bytes) {
  const size_t n = SMEM_LIMIT / (GROUPS * (stage_bytes + 16));
  return n < MAX_SPG ? (int)n : MAX_SPG;
}

// the stage of the k-th live item (group k % GROUPS, its (k / GROUPS)-th),
// and the parity of that use of the stage
__device__ __forceinline__ int item_stage(int k, int spg) {
  return k % GROUPS + GROUPS * (k / GROUPS % spg);
}
__device__ __forceinline__ uint32_t item_parity(int k, int spg) {
  return (uint32_t)(k / GROUPS / spg) & 1;
}

template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(BULK_THREADS, 1)
gather_bulk_kernel(const T* __restrict__ vecs, const int* __restrict__ slots,
                   const T* __restrict__ q, float* __restrict__ out, Geometry g, Items it,
                   int spg) {
  using namespace dst_hopper;
  unsigned char* smem = dynamic_smem();
  const size_t row = (size_t)g.D * sizeof(T);
  const size_t stage_bytes = bulk_stage_bytes(it.TL, g.D, sizeof(T));
  const int stages = GROUPS * spg;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GROUP_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp == CONSUMERS) {
    // ---- producer: the k-th live item takes stage item_stage(k) ----
    int k = 0;
    for (long long t0 = blockIdx.x; t0 < it.n; t0 += 32LL * gridDim.x) {
      const long long mine = t0 + (long long)lane * gridDim.x;
      const int my_slot = mine < it.n ? __ldg(slots + mine / it.J) : -1;
      for (int j = 0; j < 32; ++j) {
        const long long t = t0 + (long long)j * gridDim.x;
        if (t >= it.n) break;  // the same in every lane
        const int slot = __shfl_sync(FULL, my_slot, j);
        const int e = (int)(t / it.J), l0 = (int)(t % it.J) * it.TL;
        const int nrows = min(it.TL, g.L - l0);
        if (slot < 0 || slot >= g.n_exp) {  // a pad slot: zeros, no stage
          for (int r = lane; r < nrows; r += 32) out[(size_t)e * g.L + l0 + r] = 0.0f;
          continue;
        }
        if (lane == 0) {
          const int s = item_stage(k, spg);
          unsigned char* st = smem + s * stage_bytes;
          mbar_wait(&empty[s], item_parity(k, spg) ^ 1);  // the first use passes
          reinterpret_cast<int*>(st)[0] = e;
          reinterpret_cast<int*>(st)[1] = l0;
          const uint32_t bytes = (uint32_t)(nrows * row);
          mbar_arrive_expect_tx(&full[s], bytes + (uint32_t)row);
          bulk_load(st + HEADER, q + (size_t)e * g.D, (uint32_t)row, &full[s]);
          bulk_load(st + HEADER + row, vecs + ((size_t)slot * g.L + l0) * g.D, bytes, &full[s]);
        }
        ++k;
        __syncwarp();
      }
    }
    if (lane == 0) {  // the end: an entry of -1 for each group, no bytes
      for (int end = k; end < k + GROUPS; ++end) {
        const int s = item_stage(end, spg);
        mbar_wait(&empty[s], item_parity(end, spg) ^ 1);
        reinterpret_cast<int*>(smem + s * stage_bytes)[0] = -1;
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  // ---- consumers: group warp / GROUP_WARPS takes live items group, + GROUPS, ... ----
  const int group = warp / GROUP_WARPS, gw = warp % GROUP_WARPS;
  int rot = 0;
  for (int k = group;; k += GROUPS) {
    const int s = item_stage(k, spg);
    const unsigned char* st = smem + s * stage_bytes;
    mbar_wait(&full[s], item_parity(k, spg));
    const int e = reinterpret_cast<const int*>(st)[0], l0 = reinterpret_cast<const int*>(st)[1];
    if (e < 0) break;
    const int nrows = min(it.TL, g.L - l0), chunks = (nrows + 31) / 32;
    const int first = (gw - rot + GROUP_WARPS) % GROUP_WARPS;  // chunk c: (rot + c) % GROUP_WARPS
    rot = (rot + chunks) % GROUP_WARPS;
    float qr[CPL][VEC];
    load_query<T, VEC, CPL>(reinterpret_cast<const T*>(st + HEADER), g, lane, qr);
    const T* tile = reinterpret_cast<const T*>(st + HEADER + row);
    float* orow = out + (size_t)e * g.L + l0;
    for (int c = first; c < chunks; c += GROUP_WARPS) {
      const int valid = nrows - 32 * c;
      const float v = score_rows32<T, VEC, CPL>(tile + (size_t)32 * c * g.D, valid, g, lane, qr);
      if (lane < valid) orow[32 * c + lane] = v;
    }
    __syncwarp();  // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// Other rows (element loads): gather_pipelined_kernel, the first design,
// kept for them.  A persistent block walks (G entries x TL rows) work
// items and copies the next item's (G, TL, D) posting tiles into one half
// of a two-stage buffer while the current one is scored from the other.

// item t's (G, TL, D) posting tiles into dst
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
    copy_chunk<T, VEC>(dst + ((size_t)gi * it.TL + l) * g.D + c * VEC,
                       vecs + ((size_t)slot * g.L + l0 + l) * g.D + c * VEC);
  }
}

// persistent blocks: block b takes items b, b + gridDim.x, ...
template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(THREADS)
gather_pipelined_kernel(const T* __restrict__ vecs, const int* __restrict__ slots,
                        const T* __restrict__ q, float* __restrict__ out, Geometry g,
                        Items it) {
  T* ring = reinterpret_cast<T*>(dst_hopper::dynamic_smem());
  const size_t stage_elems = (size_t)it.G * it.TL * g.D;
  long long t = blockIdx.x;
  if (t >= it.n) return;
  stage_item<T, VEC>(ring, vecs, slots, t, it, g);
  int buf = 0;
  for (; t < it.n; t += gridDim.x) {
    const long long next = t + gridDim.x;
    if (next < it.n) stage_item<T, VEC>(ring + (buf ^ 1) * stage_elems, vecs, slots, next, it, g);
    __syncthreads();  // item t's tiles are in place
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
}

// ---------------------------------------------------------------- streamed

// grid (pieces, ceil(L / TL)): block (p, j) scores the entries
// [pieces[p], pieces[p + 1]), which share one slot, over rows [j TL, ...)
template <typename T, int VEC, int CPL>
__global__ void __launch_bounds__(THREADS)
gather_streamed_kernel(const T* __restrict__ vecs, const int* __restrict__ slots,
                       const T* __restrict__ q, float* __restrict__ out,
                       const int* __restrict__ pieces, Geometry g, int TL) {
  T* tile = reinterpret_cast<T*>(dst_hopper::dynamic_smem());
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

// the SMs of the current device: a persistent grid's size
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <typename T, int VEC, int CPL>
int launch_kind(const Launch& a, Geometry g) {
  using dst_hopper::launch;
  const T* vecs = (const T*)a.vecs;
  const T* q = (const T*)a.q;
  const int* slots = (const int*)a.slots;
  float* out = (float*)a.out;
  const int J = (g.L + a.tile - 1) / a.tile;
  if (J > 65535) return (int)cudaErrorInvalidValue;
  if (a.kind == SERIAL)
    return (int)launch(gather_serial_kernel<T, VEC, CPL>, dim3(a.rows, J), THREADS, 0, a.stream,
                       vecs, slots, q, out, g, a.tile);
  if (a.kind == STREAMED)
    return (int)launch(gather_streamed_kernel<T, VEC, CPL>, dim3(a.rows, J), THREADS,
                       (size_t)a.tile * g.D * sizeof(T), a.stream, vecs, slots, q, out,
                       (const int*)a.pieces, g, a.tile);
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidConfiguration;
  if constexpr (VEC * sizeof(T) == 16) {  // dst_gather_pipelined_route: 1
    Items it{a.rows, 1, a.tile, J, (long long)a.rows * J};
    const size_t stage = bulk_stage_bytes(a.tile, g.D, sizeof(T));
    const int spg = bulk_spg(stage);
    if (spg < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = it.n < sms ? it.n : sms;
    return (int)launch(gather_bulk_kernel<T, VEC, CPL>, dim3((unsigned)blocks), BULK_THREADS,
                       GROUPS * spg * (stage + 16), a.stream, vecs, slots, q, out, g, it, spg);
  } else {
    Items it{a.rows, a.group, a.tile, J, (long long)((a.rows + a.group - 1) / a.group) * J};
    const size_t smem = 2 * (size_t)a.group * a.tile * g.D * sizeof(T);
    auto kern = gather_pipelined_kernel<T, VEC, CPL>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long blocks = it.n < (long long)per_sm * sms ? it.n : (long long)per_sm * sms;
    return (int)launch(kern, dim3((unsigned)blocks), THREADS, smem, a.stream, vecs, slots, q, out,
                       g, it);
  }
}

template <typename T, int VEC>
int by_cpl(const Launch& a, Geometry g) {
  // TPR lanes per row, a power of two <= 32; CPL = ceil(C / TPR) chunks a lane
  int tpr = 1;
  while (tpr < g.C && tpr < 32) tpr *= 2;
  g.TPR = tpr;
  const int cpl = (g.C + tpr - 1) / tpr;
  if (cpl <= 1) return launch_kind<T, VEC, 1>(a, g);
  if (cpl <= 2) return launch_kind<T, VEC, 2>(a, g);
  if (cpl <= 4) return launch_kind<T, VEC, 4>(a, g);
  if (cpl <= 8) return launch_kind<T, VEC, 8>(a, g);
  return (int)cudaErrorInvalidValue;
}

// rows of 16-byte multiples at 16-byte aligned bases: 16-byte loads, and
// the pipelined kernel's bulk copies
inline bool wide_rows(const void* vecs, const void* q, int D, int elem_bytes) {
  return (D * elem_bytes) % 16 == 0 && (uintptr_t)vecs % 16 == 0 && (uintptr_t)q % 16 == 0;
}

template <typename T>
int by_width(const Launch& a, Geometry g) {
  constexpr int VEC = 16 / sizeof(T);
  if (wide_rows(a.vecs, a.q, g.D, sizeof(T))) {
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

// 1: dst_gather_pipelined takes gather_bulk_kernel on these arguments (rows
// of 16-byte multiples, 16-byte aligned bases); 0: gather_pipelined_kernel
extern "C" int dst_gather_pipelined_route(const void* vecs, const void* q, int D, int dtype) {
  return (dtype == 0 || dtype == 1) && wide_rows(vecs, q, D, dtype == 0 ? 2 : 4);
}

// The dynamic shared memory of a pipelined block over tiles of `tile` rows
// of D elements (dtype as below) on the bulk-copy route: its stages and
// their barriers.
extern "C" long long dst_gather_pipelined_smem(int tile, int D, int dtype) {
  const size_t stage = bulk_stage_bytes(tile, D, dtype == 0 ? 2 : 4);
  return (long long)(GROUPS * bulk_spg(stage) * (stage + 16));
}

extern "C" int dst_gather_streamed(const void* vecs, const void* slots, const void* q,
                                   void* out, const void* pieces, int n_pieces,
                                   long long n_exp, int L, int D, int tile, int dtype,
                                   void* stream) {
  Launch a{vecs, slots, q, pieces, out, STREAMED, n_pieces, tile, 1, (cudaStream_t)stream};
  return dispatch(a, n_exp, L, D, dtype);
}
