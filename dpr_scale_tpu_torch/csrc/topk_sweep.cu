// Pass 1 of the exact search: the best kc (score, row) pairs of every query
// over a corpus, with the products summed in fp32 on the arithmetic of the
// count kernels of the same shape.
//
// Replaces the TPU's fused dot -> lax.approx_max_k of
// dpr_scale_tpu/index/mips.py (`local_approx`, :799-803; also the `approx`
// and `auto` passes, :740-744 and :615), an XLA TPU primitive with no
// pallas_call: XLA fuses the dot into the TPU-KNN partial reduce, so the
// B x N scores never reach HBM.  That pass is approximate; this one is
// exact.  A pair is one int64 key (topk_key) whose order is the pairs'
// order: by score, then the smaller row.
//
// Two designs, chosen by shape (dst_topk_route says which):
//   1, 2  topk_select_wgmma_kernel (dst_topk_select), bf16 rows of even D:
//      one sweep of the corpus on gmax_sweep.cuh's bf16_sweep, fed by TMA
//      (route 1) or by the producer warpgroup's cp.async copies (route 2:
//      SPLADE's D = 30,522), at the layout bf16_qm128 gives the whole batch,
//      as count_above_groups takes for the same (B, D), and its PROMOTE_D
//      handling: a row sits at the same place of a 256-row tile and a
//      query of a QM-query tile in both sweeps, so each candidate's score is
//      pass 2's count bits.  A persistent grid: each query tile's blocks
//      split the rows in spans of whole tiles, about one block an SM
//      (select_span).  Each consumer warp owns the running selection of 16
//      queries over its rows (a "part": the block's span, and in the QM = 64
//      layout, where each warpgroup sees half of every tile, the
//      warpgroup's half of it):
//        - a sorted list of the best kc keys it has admitted, in device
//          memory: the part's own slice of `keys`, the output;
//        - a filter key in shared memory, the larger of the list's kc-th
//          key (once it holds kc) and a bound the query's parts publish:
//          each of its first npub = min(parts, 32) parts stores its list's
//          rank-th key, rank = ceil(kc / npub), into its own slot of `pub`
//          after each merge, and the least of those npub keys (read every
//          REREAD tiles and after each merge) has rank npub >= kc keys at
//          or above it.  Both are at or below the query's true kc-th key,
//          so no row of the true top kc ever fails the filter, and the
//          bound rises as fast as the parts' rank-th keys do, not their
//          kc-th (the largest of the parts' kc-th keys, tried first, rose
//          no faster than one part's: the parts keep the same pace);
//        - a queue of SLOTS (row, score) pairs in shared memory.  Each tile,
//          each thread counts its scores at or above its queries' filter
//          scores, as the count kernels count; where every queue of the
//          block can take its tile's counts, one atomicAdd a thread and
//          query reserves the slots and predicated stores fill them (a
//          superset: a key at the filter's score may not pass it).  Else (a
//          part's first tiles, and the tile that holds rows past `valid`,
//          which are masked) every warp admits slice by slice, each key
//          tested in full, merging wherever a queue could not take the
//          next slice's 8 rows.  A merge sorts the queue's keys across the
//          warp's lanes (bitonic), moves each list entry down by the queued
//          keys above it (a binary search in the sorted queue) and drops
//          each queued key between its list neighbours, from the list's
//          tail up, stopping at the first 32 entries nothing passes; the
//          new kc-th key raises the filter.  The queue never overflows,
//          whatever the data (ties, rows sorted by score), and the list
//          ends as the best kc keys of the rows the part admitted: every
//          row of the part in the query's top kc among them.
//      Merges run block-wide: every consumer warp waits for the others each
//      tile (the ring's stages, the warpgroup's products), so one warp's
//      merge stalls all eight, and merged apart they cost the block the sum
//      of its warps' merges (6.0 ms at B = 512 over 2M x 768 on an H100,
//      against 4.1 merged together).  The warps vote at a named barrier
//      (at each tile's end, and at each slice of a tile that does not fit)
//      and on any vote merge side by side.
//      The caller's torch.topk over all parts' lists keeps each query's best
//      kc, the counterpart of the JAX program's own lax.top_k over its
//      candidate pool (:812).  Nothing returns to the host.  Fewer than kc
//      rows (SPLADE's 1,280 at kc = 128) need nothing else: lists that never
//      fill keep every row they saw;
//   0  the two steps of score_tile.cuh's route (fp32 rows, odd D, bases
//      neither wgmma route can address): mips_scan.cu's tile_max_kernel
//      gives a threshold, theta[b], the kc-th largest of query b's tile
//      maxima (each a row's score: at least kc rows reach it), and
//      topk_emit_tile_kernel (dst_topk_emit) writes every score >= theta[b]
//      of a row below n_valid into keys[b * cap + slot], its slot from an
//      atomicAdd on count[b]; the caller sweeps a query whose count passes
//      cap again with a buffer of its count, and where fewer than kc tiles
//      are whole, theta is -inf and every row takes its own slot.  A score's
//      sum does not depend on where its row or query sits in the score tile
//      (scalar fmaf in column order for fp32, the same wmma steps for every
//      element for bf16), so the candidates are the tile maxima's and the
//      counts' bits.  No CLI builds an fp32 index and no configuration has
//      an odd D.
//
// What bounds it on an H100: like the counts, the B x N x D product at the
// retrieval batch (B = 512 over 2M x 768: 1.67 ms at 989 TFLOP/s), the
// corpus read once at small B.  What holds it back (PERF.md row 14): the
// admissions and merges, about 200 admitted rows a query and part at B =
// 512, most in a part's first tiles, and some candidate in most tiles of a
// warp's 16 queries; the sweep with the count alone and no admission ran
// at 2.4-2.6 ms.
#include "gmax_sweep.cuh"  // first: the emulation defines the CUDA keywords there
#include "score_tile.cuh"

namespace gs = gmax_sweep;
namespace mt = mips_tile;

namespace {

constexpr long long KEY_EMPTY = LLONG_MIN;  // a slot no candidate took, below every key
constexpr long long KEY_TOP = LLONG_MAX;    // above every key
// a key as the unsigned integer `pub` holds (0: nothing published yet), in
// the same order
constexpr unsigned long long KEY_SIGN = 1ull << 63;

// (score, row) as one int64 whose order is the pairs' order: by score,
// then the smaller row first.  The high word is the score's bits made
// monotone as a signed integer (negative floats flip their magnitude
// bits), the low word ~row; every finite score's key lies above
// KEY_EMPTY, the caller's empty slot.
__device__ __forceinline__ long long topk_key(float s, int row) {
  int b = __float_as_int(s);
  b = b >= 0 ? b : b ^ 0x7fffffff;
  return (long long)(((unsigned long long)(unsigned)b << 32) | (unsigned)~row);
}

// the score of a key (-inf for KEY_EMPTY): no larger score has a smaller
// key, so a score below it cannot pass the key
__device__ __forceinline__ float key_score(long long key) {
  if (key == KEY_EMPTY) return -__int_as_float(0x7f800000);
  const int hi = (int)(key >> 32);
  return __int_as_float(hi >= 0 ? hi : hi ^ 0x7fffffff);
}

// ---- routes 1 and 2: one sweep, a top kc kept by each part ----

// The shared memory past the ring of a select block: the 128 queues (a
// consumer warp's 16 queries each) of SLOTS pairs, their filter keys, their
// counts and the consumer warps' votes (two rows); the ring keeps the
// stages that fit beside them (QM = 128: 4 of 48 KB beside 32-pair queues;
// QM = 64: 4 of 40 KB beside 64-pair ones)
template <int QM>
struct Select {
  static constexpr int SLOTS = QM == 64 ? 64 : 32;  // a queue's candidate slots
  static constexpr int QUEUES = 128;                 // 16 a consumer warp
  static constexpr int PARTS = QM == 64 ? 2 : 1;     // parts a block: its warpgroups' halves
  static constexpr int EXTRA = QUEUES * (SLOTS * 8 + 8 + 4) + 2 * 8 * 4;  // + the votes
  static constexpr int STAGES = gs::RING_STAGES<gs::BF16_STAGE<QM>, EXTRA>;
  static_assert(SLOTS % 32 == 0 && SLOTS >= 16, "whole lanes of slots, room for a slice");
  static_assert(STAGES >= 2, "a ring beside the queues");
};

// a queue past MERGE_AT pairs calls the block's warps to merge, and each
// then merges its queues past MERGE_ABOVE
template <int SLOTS>
constexpr int MERGE_AT = SLOTS / 2;
template <int SLOTS>
constexpr int MERGE_ABOVE = SLOTS / 4;
constexpr int PUB = 32;    // the parts of a query that publish a bound
constexpr int REREAD = 4;  // tiles between two reads of the published bounds

// #{ j < n : s[j] > y } of keys s sorted descending
__device__ __forceinline__ int keys_above(const long long* s, int n, long long y) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s[mid] > y)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// A bitonic sort, descending, of the warp's 32 R keys: element 32 r + lane
// in e[r]
template <int R>
__device__ __forceinline__ void warp_sort_desc(long long (&e)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size *= 2)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2) {
      if (stride >= 32) {  // partners in one lane: e[r], e[r ^ stride / 32]
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int p = r ^ (stride / 32);
          if (p > r) {
            const bool desc = ((32 * r + lane) & size) == 0;
            const long long hi = e[r] > e[p] ? e[r] : e[p], lo = e[r] > e[p] ? e[p] : e[r];
            e[r] = desc ? hi : lo;
            e[p] = desc ? lo : hi;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = 32 * r + lane;
          const long long o = __shfl_xor_sync(gs::FULL_MASK, e[r], stride);
          const bool keep_max = ((i & stride) == 0) == ((i & size) == 0);
          e[r] = keep_max ? (e[r] > o ? e[r] : o) : (e[r] > o ? o : e[r]);
        }
      }
    }
}

// The warp merges the queue q (n (row, score bits) pairs, unsorted, SLOTS
// slots; its keys, sorted, on return) into the sorted list `list` of kc
// keys in device memory, in place, the new list visible to every lane on
// return.  From the list's tail up, 32 entries a
// round: entry i moves to i + s_i, s_i the queued keys above it, and the
// queued keys j in [s_{i-1}, s_i) land at i + j; positions past kc drop.
// A round writes only at or past its first entry, so the rounds above it
// read the list as it was; the next round's entries are loaded before this
// round's writes.  A round whose entries all have s_i = 0 ends the merge:
// nothing above it moves.
template <int SLOTS>
__device__ __forceinline__ void merge_queue(long long* q, int n, long long* list, int kc,
                                            int lane) {
  constexpr int R = SLOTS / 32;
  long long e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int2 pair = reinterpret_cast<const int2*>(q)[32 * r + lane];
    e[r] = 32 * r + lane < n ? topk_key(__int_as_float(pair.y), pair.x) : KEY_EMPTY;
  }
  warp_sort_desc<R>(e, lane);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) q[32 * r + lane] = e[r];
  __syncwarp();
  int c = (kc - 1) / 32;
  int i = 32 * c + lane;
  long long y = i < kc ? list[i] : KEY_EMPTY, yp = i > 0 && i < kc ? list[i - 1] : KEY_TOP;
  while (true) {
    const bool in = i < kc;
    const int s = in ? keys_above(q, n, y) : 0;
    if (!__any_sync(gs::FULL_MASK, s > 0)) break;
    const int sp = in ? keys_above(q, n, yp) : 0;
    const long long y_here = y;
    if (c > 0) {  // the next round's entries, read before this round writes
      const int i_next = i - 32;
      y = list[i_next];
      yp = i_next > 0 ? list[i_next - 1] : KEY_TOP;
    }
    __syncwarp();
    if (in) {
      if (i + s < kc) list[i + s] = y_here;
      for (int j = sp; j < s && i + j < kc; ++j) list[i + j] = q[j];
    }
    __syncwarp();
    if (c == 0) break;
    --c;
    i -= 32;
  }
  __syncwarp();
}

// What a select warp's steps need: its 16 queues (shared memory), their
// lists (device memory) and the published bounds
struct SelectWarp {
  long long* keys;          // the output: each part's lists
  unsigned long long* pub;  // (B, PUB) published bounds
  long long* queues;        // this block's queues, SLOTS (row, score) pairs each
  long long* filter;        // their filter keys
  int* count;               // their fill
  long long width, part;
  int kc, npub, rank, B, wq0, warp, lane;
  // query wq0 + k's list
  __device__ long long* list(int k) const { return keys + (size_t)(wq0 + k) * width + part * kc; }
};

// The warp merges every queue of its 16 past `limit` pairs into its list,
// then raises the queue's filter to the list's kc-th key and publishes its
// rank-th; out of line, so that the sweep's loop stays small.  trap: lane
// 0's count is every lane's, and no lane leaves before all have read
// theirs: a lane already admitting the next slices would raise a count
// another lane has yet to read, and the lanes would part ways
template <int SLOTS>
__device__ __noinline__ void merge_warp(const SelectWarp w, int limit) {
  __syncwarp();
  for (int k = 0; k < 16; ++k) {
    const int qi = 16 * w.warp + k, n = __shfl_sync(gs::FULL_MASK, w.count[qi], 0);
    if (n <= limit) continue;
    long long* list = w.list(k);
    merge_queue<SLOTS>(w.queues + qi * SLOTS, n, list, w.kc, w.lane);
    if (w.lane == 0) {
      w.count[qi] = 0;
      const long long kth = list[w.kc - 1], rth = list[w.rank - 1];
      w.filter[qi] = kth > w.filter[qi] ? kth : w.filter[qi];
      if (w.part < w.npub && rth != KEY_EMPTY)  // rises only: one writer a slot
        *(volatile unsigned long long*)(w.pub + (size_t)(w.wq0 + k) * PUB + w.part) =
            (unsigned long long)rth ^ KEY_SIGN;
    }
    __syncwarp();
  }
  __syncwarp();
}

// The published bound of the warp's queries, the least rank-th key of the
// npub parts (0, KEY_EMPTY's image, until every one has published), into
// their filters; lane l reads half of query l / 2's slots, 8 loads in
// flight at a time
__device__ __forceinline__ void read_published(const SelectWarp& w) {
  const int k = w.lane / 2;
  const unsigned long long* slots = w.pub + (size_t)(w.wq0 + k) * PUB + w.lane % 2;
  unsigned long long least = ~0ull;
#pragma unroll
  for (int i0 = 0; i0 < PUB / 2; i0 += 8) {
    unsigned long long v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = 2 * (i0 + i) + w.lane % 2 < w.npub && w.wq0 + k < w.B ? __ldcg(slots + 2 * (i0 + i))
                                                                  : ~0ull;
#pragma unroll
    for (int i = 0; i < 8; ++i) least = v[i] < least ? v[i] : least;
  }
  const long long other = __shfl_xor_sync(gs::FULL_MASK, (long long)least, 1);
  least = (unsigned long long)other < least ? (unsigned long long)other : least;
  const long long bound = (long long)(least ^ KEY_SIGN);
  if (w.lane % 2 == 0 && bound > w.filter[16 * w.warp + k]) w.filter[16 * w.warp + k] = bound;
  __syncwarp();
}

// The select sweep on bf16_sweep: keys[b * width + part * kc ..] ends as
// the best kc keys of query b over the rows below `valid` its part
// admitted (sorted, KEY_EMPTY past them), for b < B; pub (B, PUB) zeroed.
template <int QM, bool CP>
__global__ void __launch_bounds__(gs::THREADS, 1)
topk_select_wgmma_kernel(const __grid_constant__ gs::Ring<CP> ring, long long* __restrict__ keys,
                         unsigned long long* __restrict__ pub, int kc, long long width,
                         long long valid, int B, int D, long long N, int nqt, long long span) {
  using L = gs::Layout<QM>;
  using S = Select<QM>;
  SelectWarp w;
  w.keys = keys;
  w.pub = pub;
  w.queues = reinterpret_cast<long long*>(gs::bf16_extra<QM, S::STAGES>());
  w.filter = w.queues + S::QUEUES * S::SLOTS;
  w.count = reinterpret_cast<int*>(w.filter + S::QUEUES);
  w.width = width;
  w.kc = kc;
  w.B = B;
  w.lane = threadIdx.x % 32;
  w.warp = threadIdx.x / 32;
  const int wg = threadIdx.x / 128;
  // this warp's queues 16 warp + k hold the queries wq0 + k
  w.wq0 = (int)(blockIdx.x % nqt) * QM + (QM == 128 ? 16 * w.warp : 16 * (w.warp % 4));
  w.part = (long long)(blockIdx.x / nqt) * S::PARTS + (QM == 64 ? wg : 0);
  // the parts that publish their rank-th key: together they hold rank *
  // npub >= kc keys at or above the least of them
  w.npub = (int)min(width / kc, (long long)PUB);
  w.rank = (kc + w.npub - 1) / w.npub;
  if (wg < 2) {
    if (w.lane < 16) {
      w.count[16 * w.warp + w.lane] = 0;
      w.filter[16 * w.warp + w.lane] = KEY_EMPTY;
    }
    for (int k = 0; k < 16; ++k)
      if (w.wq0 + k < B)
        for (int i = w.lane; i < kc; i += 32) w.list(k)[i] = KEY_EMPTY;
    __syncwarp();
  }
  const int qi0 = 16 * w.warp + w.lane / 4;  // this thread's queues qi0, qi0 + 8
  int* votes = w.count + S::QUEUES;          // [tile parity][consumer warp]
  int epilogues = 0;
  // one tile's admission (the loop's epilogue, then the block's vote)
  // Merges wait for every consumer warp (the ring and the warpgroup's
  // products join them each tile), so the warps merge together: `vote`
  // ORs the consumer warps' flags (a named barrier; votes alternate
  // between two rows, so that a warp already voting again cannot overwrite
  // a row another has yet to read) and on any flag each warp merges its
  // queues past `limit`, side by side
  int rounds = 0;
  auto vote = [&](bool flag) {
    const int row = 8 * (rounds++ & 1);
    flag = __any_sync(gs::FULL_MASK, flag);
    if (w.lane == 0) votes[row + w.warp] = flag;
    gs::named_bar_sync(1, 256);
    int any = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) any |= votes[row + v];
    return any != 0;
  };
  auto merge_together = [&](int limit) {
    merge_warp<S::SLOTS>(w, limit);
    read_published(w);
  };
  // one tile's admission, every consumer warp alike
  auto admit = [&](const float (&acc)[L::N / 2], long long rbase) {
    // the filter keys of the thread's queries qa, qa + 8 (both of their
    // sources only rise, so the larger of their latest is the larger of
    // the two) and their scores; a query past B (the producer's zero
    // fill) admits nothing
    const int qa = gs::query_row<QM>(nqt);
    long long thk[2];
    float thf[2];
    auto load_filters = [&] {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        thk[h] = qa + 8 * h < B ? w.filter[qi0 + 8 * h] : KEY_TOP;
        thf[h] = qa + 8 * h < B ? key_score(thk[h]) : __int_as_float(0x7f800000);
      }
    };
    load_filters();
    // the thread's scores at or above each filter's score, counted as the
    // count kernels count; nearly every tile holds none for the warp
    int n[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < L::NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        n[h] += (acc[4 * j + 2 * h] >= thf[h]) + (acc[4 * j + 2 * h + 1] >= thf[h]);
    const int r0 = (int)rbase + 2 * (w.lane & 3);  // acc[4 j + 2 h + e] is row r0 + 8 j + e
    int total[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      total[h] = n[h] + __shfl_xor_sync(gs::FULL_MASK, n[h], 1);
      total[h] += __shfl_xor_sync(gs::FULL_MASK, total[h], 2);
    }
    __syncwarp();
    const bool fits = rbase + L::N <= valid && w.count[qi0] + total[0] <= S::SLOTS &&
                      w.count[qi0 + 8] + total[1] <= S::SLOTS;
    if (!vote(!fits)) {
      // every queue takes the tile's scores at or above its filter's (a
      // superset of its candidates: a key at the filter's score may not
      // pass it, and merges only keep the best kc): one atomicAdd a thread
      // and query reserves n slots, its (row, score) pairs fill them, each
      // a predicated store
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!n[h]) continue;
        int2* slot = reinterpret_cast<int2*>(w.queues) + (qi0 + 8 * h) * S::SLOTS +
                     atomicAdd(&w.count[qi0 + 8 * h], n[h]);
#pragma unroll
        for (int j = 0; j < L::NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (acc[4 * j + 2 * h + e] >= thf[h])
              *slot++ = make_int2(r0 + 8 * j + e, __float_as_int(acc[4 * j + 2 * h + e]));
      }
      __syncwarp();
      return;
    }
    // a queue would overflow (the parts' first tiles) or the tile holds
    // rows past `valid`: every warp goes slice by slice, the candidates'
    // keys tested in full, from queues with room for a slice; where a
    // queue could not take the next slice's 8 rows, the warps merge first.
    // trap: rows at or past `valid` are pad rows or the producer's zero
    // fill: masked by row
    merge_together(S::SLOTS - 8);
    load_filters();
#pragma unroll
    for (int j = 0; j < L::NJ; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[4 * j + 2 * h + e];
          const int row = r0 + 8 * j + e;
          if (v >= thf[h] && row < valid && topk_key(v, row) > thk[h]) {
            const int qi = qi0 + 8 * h;
            reinterpret_cast<int2*>(w.queues)[qi * S::SLOTS + atomicAdd(&w.count[qi], 1)] =
                make_int2(row, __float_as_int(v));
          }
        }
      __syncwarp();
      if (j + 1 < L::NJ &&
          vote(w.count[qi0] > S::SLOTS - 8 || w.count[qi0 + 8] > S::SLOTS - 8)) {
        merge_together(S::SLOTS - 8);
        load_filters();
      }
    }
    __syncwarp();
  };
  const bool consumer = gs::bf16_sweep<QM, CP, S::STAGES>(
      ring, B, D, N, nqt, span, [&](const float (&acc)[L::N / 2], long long rbase) {
        if (epilogues++ % REREAD == 0) read_published(w);
        admit(acc, rbase);
        // a queue past MERGE_AT calls the warps to merge their queues past
        // MERGE_ABOVE
        if (vote(w.count[qi0] > MERGE_AT<S::SLOTS> || w.count[qi0 + 8] > MERGE_AT<S::SLOTS>))
          merge_together(MERGE_ABOVE<S::SLOTS>);
      });
  if (consumer) merge_warp<S::SLOTS>(w, 0);  // the queues' last pairs into the lists
}

// The parts' span: whole tiles, so that the grid of spans x nqt blocks is
// about one block an SM
inline cudaError_t select_span(long long rows, int nqt, long long* span) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + gs::TILE - 1) / gs::TILE;
  const long long per = sms / nqt > 1 ? sms / nqt : 1;  // spans a query tile
  *span = (tiles + per - 1) / per * gs::TILE;
  return cudaSuccess;
}

// the rows a select sweep takes: n_valid up to whole tiles, where the
// corpus has them (an index block's pad rows)
inline long long select_rows(long long N, long long n_valid) {
  const long long whole = (n_valid + gs::TILE - 1) / gs::TILE * gs::TILE;
  return whole < N ? whole : N;
}

// the key slots a query of a select launch: kc a part
inline cudaError_t select_width(long long N, long long n_valid, int B, int D, int kc,
                                long long* span, long long* width) {
  const int qm = gs::bf16_qm128(B, D) ? 128 : 64;
  const long long rows = select_rows(N, n_valid);
  const cudaError_t err = select_span(rows, (B + qm - 1) / qm, span);
  if (err != cudaSuccess) return err;
  *width = (rows + *span - 1) / *span * (qm == 64 ? 2 : 1) * kc;
  return cudaSuccess;
}

// ---- route 0: the emit sweep on score_tile.cuh's tile ----

// The emit sweep on score_tile.cuh's tile: a block scores its query tile
// against gs::SPAN rows of [0, rows), 128 at a time, and each thread
// compares its query's scores of every mt::THREADS / mt::QT-th row of a
// tile; count[b] (zeroed) counts the rows r < valid with q[b] . c[r] >=
// theta[b], and the first `cap` of them land in keys[b * cap ..] in the
// order their atomicAdds ran (the aggregation sorts them); with cap >=
// valid row r lands in slot r and count[b] stays 0.
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

// The design pass 1 takes on these arguments (dtype 0 bf16, 1 fp32): 1 the
// select sweep fed by TMA, 2 fed by cp.async (dst_topk_select), 0 the
// score tile's two steps (dst_topk_emit).
extern "C" int dst_topk_route(const void* q, const void* corpus, long long N, int D, int dtype) {
  return gs::bf16_route(q, corpus, N, D, dtype);
}

// The key slots a query of dst_topk_select at these arguments writes (the
// width of its `keys`), or minus the failed device query's code.
extern "C" long long dst_topk_select_width(long long N, long long n_valid, int B, int D, int kc) {
  long long span, width;
  const cudaError_t err = select_width(N, n_valid, B, D, kc, &span, &width);
  return err == cudaSuccess ? width : -(long long)err;
}

// Dynamic shared memory of a topk_select_wgmma_kernel block at batch B and
// width D.
extern "C" long long dst_topk_select_smem(int B, int D) {
  using S128 = Select<128>;
  using S64 = Select<64>;
  return (long long)(gs::bf16_qm128(B, D)
                         ? gs::smem_bytes(S128::STAGES, gs::BF16_STAGE<128>, S128::EXTRA)
                         : gs::smem_bytes(S64::STAGES, gs::BF16_STAGE<64>, S64::EXTRA));
}

// q (B, D) and corpus (N, D) bf16 (dtype 0) on route 1 or 2
// (dst_topk_route), the rows past n_valid (<= N, <= INT_MAX) never
// candidates; keys (B, width)
// int64, width = dst_topk_select_width(N, n_valid, B, D, kc): each part's
// sorted best kc keys of the rows it admitted (topk_key; KEY_EMPTY in
// slots past them); pub (B, 32) int64 scratch (zeroed here).  Returns a
// cudaError_t code: 0 on a launch that was accepted, cudaErrorInvalidValue
// on arguments out of range or a shape of route 0.
extern "C" int dst_topk_select(const void* q, const void* corpus, void* keys, void* pub, int B,
                               long long N, long long n_valid, int D, int kc, int dtype,
                               void* stream) {
  if (B < 1 || D < 1 || n_valid < 1 || n_valid > N || n_valid > INT_MAX || kc < 1)
    return (int)cudaErrorInvalidValue;
  const long long rows = select_rows(N, n_valid);
  const int route = gs::bf16_route(q, corpus, rows, D, dtype);
  if (route == 0 || rows > INT_MAX) return (int)cudaErrorInvalidValue;  // rows as int
  long long span, width;
  cudaError_t err = select_width(N, n_valid, B, D, kc, &span, &width);
  const cudaStream_t s = (cudaStream_t)stream;
  if (err == cudaSuccess) err = cudaMemsetAsync(pub, 0, (size_t)B * PUB * 8, s);
  if (err != cudaSuccess) return (int)err;
  return gs::by_route(route, B, D, [&](auto qm, auto cp) {
    constexpr int QM = decltype(qm)::value;
    constexpr bool CP = decltype(cp)::value;
    using S = Select<QM>;
    return gs::launch_bf16_spans<QM, CP, S::STAGES>(
        topk_select_wgmma_kernel<QM, CP>, span, S::EXTRA, q, corpus, B, rows, D, s,
        (long long*)keys, (unsigned long long*)pub, kc, width, n_valid);
  });
}

// Route 0.  q (B, D) and corpus (N, D) of one dtype (0 bf16, 1 fp32) that
// neither wgmma route can address (dst_topk_route 0), the rows past
// n_valid (<= N, <= INT_MAX) never candidates, theta (B,) fp32, count (B,)
// int32 (zeroed here; it stays 0 where cap >= n_valid, each row in its own
// slot), keys (B, cap) int64 (the caller fills them with INT64_MIN; slots
// no candidate took keep it).  Returns a cudaError_t code: 0 on a launch
// that was accepted, cudaErrorInvalidValue on arguments out of range or a
// shape of routes 1 and 2.
extern "C" int dst_topk_emit(const void* q, const void* corpus, const void* theta, void* count,
                             void* keys, int B, long long N, long long n_valid, int D, int cap,
                             int dtype, void* stream) {
  if (B < 1 || D < 1 || n_valid < 1 || n_valid > N || n_valid > INT_MAX || cap < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = select_rows(N, n_valid);
  if (gs::bf16_route(q, corpus, rows, D, dtype) != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(count, 0, (size_t)B * 4, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return launch_emit_tile<mt::bf16>(q, corpus, theta, count, keys, B, rows, n_valid, D, cap, s);
  return launch_emit_tile<float>(q, corpus, theta, count, keys, B, rows, n_valid, D, cap, s);
}
