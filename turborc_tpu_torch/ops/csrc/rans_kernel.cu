// Flagship rANS kernels (codec rans-cdf-o0-p) for Hopper, sm_90a.
//
// Replaces the five Pallas TPU kernels of
// turborc_tpu/ops/pallas/rans_kernel.py:
//   model_kernel   <- _make_model_kernel  (:807)  forward model pass
//   coder_kernel   <- _make_coder_kernel  (:883)  backward rANS pass
//   place_kernel   <- _make_place_kernel  (:1017) stream compaction
//   decode_kernel  <- _make_decode_kernel (:407)  o0 share-span decode (K1)
//   decode_x2_kernel <- _make_decode_kernel_x2 (:569)  split-state decode (K5)
//
// Design of K2, K3 and K4: one CTA = one 128-lane group = 4 warps, one
// thread per lane, and a loop over byte steps inside the CTA (the TPU
// grid's sequential dimension).  Each lane is a serial state machine;
// lanes of a group are coupled only by (a) the lane-order rank of the lanes
// that read or write a stream word at a step (warp ballot + popc, plus a
// 4-entry shared-memory prefix over the warps) and (b) the re-join of
// `share`-lane model copies (XOR-partner sums: warp shuffles for share <=
// 32, shared memory above).  The TPU's barrel gather, register queue, VMEM
// window, packed-pair lo rows and f32 long division are not reproduced: the
// card has gathers, ballots and integer division.  K2's per-lane lo tables
// (16 rows x 16 entries, u16) and their re-join start copies live in
// dynamic shared memory: 2 x 64 KB per CTA.
//
// What bounds them on this card: not bytes and not operations.  Each lane is
// a chain of dependent steps (search -> state -> fetch -> update) and one
// block holds only 64 groups = 8192 threads, fewer than half of the 132 SMs
// get a CTA, so the time is the per-step latency times K.  Batching container
// blocks into one launch is the first lever; it is not done here.
//
// The decoders K1 and K5 share one byte step (decode_lanes) of another
// design, measured against the one above (PERF.md sections 6 and 7):
// - Tables in registers.  The design above keeps a lane's 16-entry hi
//   table and lo row in arrays that ptxas put on the stack (the select
//   chains of cdf_lookup became an indexed access: 128 B of stack, a
//   local-memory access per entry), about a third of its byte step.  Here
//   every per-thread table is indexed by unrolled constants only, and the
//   lookup picks entries with a tree of selects.
// - The stream staged in shared memory: a ring of kRingWords words per
//   stream set, filled by cp.async and topped up by the CTA after every
//   kRingEvery-th fetch's barrier, at least that many fetches before its
//   words are read.  It replaces a device-memory load per fetch that
//   waited on the rank and the barrier.  The TPU kernel stages the same
//   words in a VMEM window and a register queue
//   (turborc_tpu/ops/pallas/rans_kernel.py:377-440).
// - A fetch's barrier follows the ballot; the model's updates, the row
//   store and the re-joins run between it and the rank's read, whose
//   prefix over the warps is two warp reductions.
// - Re-joins sum the hi table and kBatch lo rows at once, so their
//   shuffles and loads overlap.
// - Shared memory holds only what adapts: per-lane lo rows below arows
//   and their re-join start copies; the static rows, which are the same
//   for all lanes of a group, once.  At a4 that is 16 + 16 KB, plus the
//   ring's 16 KB a stream set.
// - One thread per lane, as above.  Teams of 2, 4 and 8 threads a lane,
//   each thread with a share of every table's entries, were timed
//   (PERF.md section 6) and were up to 9%, 15% and 60% slower: once the
//   tables are in registers, more warps a group only repeat the lane's
//   state step, ballot and fetch in every thread of a team and add the
//   team's shuffles.
// What bounds them now: neither bytes nor operations at the card's peak,
// but the chain of dependent steps of a byte (search, lookup, state,
// ballot, barrier, rank, word) on 4 warps an SM, of which the re-joins and
// the table updates take the largest shares, and 68 of the 132 SMs hold
// no group.
//
// Rules kept by every kernel: __syncthreads() only where all threads of the
// CTA arrive (every condition around one depends on the byte index and the
// geometry, never on data); no loop bound taken from data; every stream read
// is bounds-checked, so a corrupt stream decodes to wrong bytes, never to an
// out-of-bounds access or a hang.  Each C entry point returns
// cudaGetLastError() after its launch.

#include <climits>

#include "rans_common.cuh"

namespace {

// Shared-memory layout of the model kernel.
constexpr int kRedInts = kWarps * 16;   // set_sum16 cross-warp partials
constexpr int kRankInts = 4 * kWarps;   // rank double buffer, 2 stream sets
constexpr int kTableU16 = 16 * 16 * kLanes;  // one lo table set, u16

struct Geo {
  int share, sync, lsync, arows, srows, hrows, rate;
};

size_t model_smem_bytes(int share) {
  return (kRedInts + kRankInts) * sizeof(int) +
         (share > 1 ? 2 : 1) * kTableU16 * sizeof(uint16_t);
}

__device__ __forceinline__ void repair16(int (&c)[16]) {
  int m = c[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    m = max(m, c[i] - i);
    c[i] = m + i;
  }
}

__device__ __forceinline__ void clamp16(int (&c)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = min(c[i], kTotal - 16 + i);
}

// Sum of x over each aligned `share`-lane set, for all 16 entries at once.
// Uniform in `share`: every thread of the CTA takes the same branches.
__device__ __forceinline__ void set_sum16(int (&x)[16], int share, int* red) {
  const int lim = share < 32 ? share : 32;
  for (int k = 1; k < lim; k <<= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] += __shfl_xor_sync(kFull, x[i], k);
  }
  if (share > 32) {
    const int warp = threadIdx.x >> 5;
    const int per = share >> 5;  // warps per set: 2 or 4
    const int first = warp & ~(per - 1);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) red[warp * 16 + i] = x[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int s = 0;
      for (int w = first; w < first + per; ++w) s += red[w * 16 + i];
      x[i] = s;
    }
    __syncthreads();
  }
}

// Lo tables: [row 16][entry 16][lane 128] u16, one column per thread.
__device__ __forceinline__ int lo_at(int h, int i) {
  return (h * 16 + i) * kLanes + threadIdx.x;
}

__device__ __forceinline__ void rejoin_row(uint16_t* lo_s, uint16_t* st_s,
                                           int h, int share, int* red) {
  int d[16], st[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    st[i] = st_s[lo_at(h, i)];
    d[i] = int(lo_s[lo_at(h, i)]) - st[i];
  }
  set_sum16(d, share, red);
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] += st[i];
  repair16(d);
  clamp16(d);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo_s[lo_at(h, i)] = uint16_t(d[i]);
    st_s[lo_at(h, i)] = uint16_t(d[i]);
  }
}

// Re-joins after byte t, counted in byte index: hot (hi table and lo rows
// < hrows) when t % sync == sync-1, cold (rows srows..arows-1) when
// (t+1) % lsync == 0.  Repair + clamp at the re-join are load-bearing
// (rans_kernel.py:515-524).
__device__ __forceinline__ void rejoin_after(int t, const Geo& m,
                                             int (&hi)[16],
                                             int (&start_hi)[16],
                                             uint16_t* lo_s, uint16_t* st_s,
                                             int* red) {
  if (m.share == 1) return;
  if (t % m.sync == m.sync - 1) {
    int d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = hi[i] - start_hi[i];
    set_sum16(d, m.share, red);
#pragma unroll
    for (int i = 0; i < 16; ++i) hi[i] = start_hi[i] + d[i];
    repair16(hi);
    clamp16(hi);
#pragma unroll
    for (int i = 0; i < 16; ++i) start_hi[i] = hi[i];
    for (int h = 0; h < m.hrows; ++h) rejoin_row(lo_s, st_s, h, m.share, red);
  }
  if (m.arows > m.srows && (t + 1) % m.lsync == 0) {
    for (int h = m.srows; h < m.arows; ++h)
      rejoin_row(lo_s, st_s, h, m.share, red);
  }
}

// Warm tables hi [16, G], lo [16, 16, G] int32 -> registers / shared memory.
__device__ __forceinline__ void init_tables(const int* hi_tbl,
                                            const int* lo_tbl, int G, int g,
                                            int share, int (&hi)[16],
                                            int (&start_hi)[16],
                                            uint16_t* lo_s, uint16_t* st_s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    hi[i] = hi_tbl[i * G + g];
    start_hi[i] = hi[i];
  }
  for (int h = 0; h < 16; ++h) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint16_t v = uint16_t(lo_tbl[(h * 16 + i) * G + g]);
      lo_s[lo_at(h, i)] = v;
      if (share > 1) st_s[lo_at(h, i)] = v;
    }
  }
}

struct Smem {
  int* red;
  int* wsum;
  uint16_t* lo_s;
  uint16_t* st_s;
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem s;
  s.red = reinterpret_cast<int*>(raw);
  s.wsum = s.red + kRedInts;
  s.lo_s = reinterpret_cast<uint16_t*>(s.wsum + kRankInts);
  s.st_s = s.lo_s + kTableU16;
  return s;
}

// ---- K2: forward model pass.  cols [K, G, 128] u8 -> probs [2K, G, 128]
// int32 = (low << 16) | freq per nibble slot (hi slot 2t, lo slot 2t+1).
__global__ void __launch_bounds__(kLanes)
model_kernel(const uint8_t* __restrict__ cols, const int* __restrict__ hi_tbl,
             const int* __restrict__ lo_tbl, int* __restrict__ probs, int K,
             int G, Geo m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int g = blockIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + threadIdx.x;
  int hi[16], start_hi[16];
  init_tables(hi_tbl, lo_tbl, G, g, m.share, hi, start_hi, sm.lo_s, sm.st_s);

  for (int t = 0; t < K; ++t) {
    const int b = cols[size_t(t) * plane + col];
    const int hs = b >> 4, ls = b & 15;
    int low_h, fr_h;
    cdf_lookup(hi, hs, low_h, fr_h);
    cdf_update(hi, low_h, m.rate);
    int row[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) row[i] = sm.lo_s[lo_at(hs, i)];
    int low_l, fr_l;
    cdf_lookup(row, ls, low_l, fr_l);
    cdf_update(row, low_l, m.rate);
    if (hs < m.arows) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sm.lo_s[lo_at(hs, i)] = uint16_t(row[i]);
    }
    probs[size_t(2 * t) * plane + col] = (low_h << 16) | fr_h;
    probs[size_t(2 * t + 1) * plane + col] = (low_l << 16) | fr_l;
    rejoin_after(t, m, hi, start_hi, sm.lo_s, sm.st_s, sm.red);
  }
}

// ---- K1 and K5: the decoders, one thread per lane.
//
// Every per-thread table is indexed by unrolled constants only (a
// data-dependent index would move it to the stack): the search sums flags
// as a tree, the lookup picks entries with a tree of selects.

constexpr int kRingWords = 4096;              // ring of one stream set
constexpr int kRingEvery = 8;                 // fetches between top-ups
constexpr int kRingLag = 1;                   // top-ups allowed in flight
constexpr int kSmemMax = 232448;              // shared memory a CTA may have
// A fetch takes at most 128 words, and the word read at fetch f was
// requested by a top-up at most (kRingLag + 2) * kRingEvery - 1 fetches
// earlier, which filled the ring to (base + kRingWords) & ~3
// (ops/rans_kernel.py ring_check mirrors this).
static_assert(kRingWords >= kLanes * (kRingLag + 2) * kRingEvery + 3,
              "ring too shallow");
static_assert((kRingEvery & (kRingEvery - 1)) == 0, "kRingEvery: 2^n");

// Dynamic shared memory of the decoders, as byte offsets that the wrapper
// computes (ops/rans_kernel.py decode_launch) and the C entry checks.
struct DecCarve {
  int ring, lo, st, fixed, red, rank;
};

struct DecBufs {
  int* ring;        // [nstates][kRingWords] stream words
  uint16_t* lo;     // [arows][128 lanes][16] adaptive lo rows
  uint16_t* st;     // [arows][128][16] their re-join start copies
  uint16_t* fixed;  // [16 - arows][16] static lo rows, one copy per group
  int* red;         // [kWarps][16] set sums across warps
  uint8_t* rank;    // [2][nstates][kWarps] lanes needing a word, a warp
};

// A lane's 16 u16 entries of a row at p (32-byte aligned) <-> registers.
__device__ __forceinline__ void ld_row(const uint16_t* p, int (&r)[16]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[q];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[8 * q + 2 * k] = int(w[k] & 0xFFFFu);
      r[8 * q + 2 * k + 1] = int(w[k] >> 16);
    }
  }
}

__device__ __forceinline__ void st_row(uint16_t* p, const int (&r)[16]) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = (uint32_t(r[2 * k]) & 0xFFFFu) | (uint32_t(r[2 * k + 1]) << 16);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    reinterpret_cast<uint4*>(p)[q] =
        make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

// cdf_search with the flags summed as a tree (no chain of 15 adds).
__device__ __forceinline__ int search_tree(const int (&c)[16], int value) {
  int n[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) n[e] = (e > 0 && c[e] <= value) ? 1 : 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < (8 >> b)) n[i] = n[2 * i] + n[2 * i + 1];
    }
  }
  return n[0];
}

// c[e] by a tree of selects on the bits of e: no index into the array, so
// the table stays in registers.
__device__ __forceinline__ int pick(const int (&c)[16], unsigned e) {
  int v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = c[i];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < (8 >> b)) v[i] = (e >> b) & 1u ? v[2 * i + 1] : v[2 * i];
    }
  }
  return v[0];
}

// cdf_lookup by picks: entry sym and entry sym + 1 (2^15 past 15).  Both
// picks are taken unconditionally: the second under the condition became
// a branch, and K1 slower.
__device__ __forceinline__ void lookup_pick(const int (&c)[16], int sym,
                                            int& low, int& freq) {
  const unsigned s = unsigned(sym), s1 = s + 1;
  const int lo = pick(c, s), nx = pick(c, s1 & 15u);
  low = lo;
  freq = (s1 == 16 ? kTotal : nx) - lo;
}

// set_sum16 on NT tables at once (their shuffles and loads pipeline).
// Uniform in `share`.
template <int NT>
__device__ __forceinline__ void set_sum_n(int (&x)[NT][16], int share,
                                          int* red) {
  const int lim = share < 32 ? share : 32;
  for (int k = 1; k < lim; k <<= 1) {
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        x[q][e] += __shfl_xor_sync(kFull, x[q][e], k);
    }
  }
  if (share > 32) {
    const int warp = threadIdx.x >> 5;
    const int per = share >> 5;  // warps per set: 2 or 4
    const int first = warp & ~(per - 1);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) red[warp * 16 + e] = x[q][e];
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        int s = 0;
        for (int w = first; w < first + per; ++w) s += red[w * 16 + e];
        x[q][e] = s;
      }
      __syncthreads();
    }
  }
}

// Re-join lo rows h .. h + kBatch - 1 (those below h1) and, with kHi, the
// hi table, all at once: start + the sum over the set of (table - start),
// repaired and clamped, stored to the row and its start copy.  The start
// copy is the same in every lane of a set (it is the last re-join's
// result, or the group's warm table), so the sum is taken as
// sum(table) - (share - 1) * start: one add fewer a value.
constexpr int kBatch = 4;  // lo rows a batch, beside the hi table
template <bool kHi>
__device__ __forceinline__ void rejoin_batch(const DecBufs& b, int h, int h1,
                                             int share, int (&hi)[16],
                                             int (&start_hi)[16]) {
  constexpr int NT = kBatch + (kHi ? 1 : 0), R0 = kHi ? 1 : 0;
  const int at = threadIdx.x * 16;
  int d[NT][16], s[NT][16];
  if constexpr (kHi) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      s[0][e] = start_hi[e];
      d[0][e] = hi[e];
    }
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (h + q < h1) {
      ld_row(b.lo + (h + q) * kLanes * 16 + at, d[R0 + q]);
      ld_row(b.st + (h + q) * kLanes * 16 + at, s[R0 + q]);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) d[R0 + q][e] = s[R0 + q][e] = 0;
    }
  }
  set_sum_n(d, share, b.red);
#pragma unroll
  for (int q = 0; q < NT; ++q) {
#pragma unroll
    for (int e = 0; e < 16; ++e) d[q][e] += (1 - share) * s[q][e];
    repair16(d[q]);
    clamp16(d[q]);
  }
  if constexpr (kHi) {
#pragma unroll
    for (int e = 0; e < 16; ++e) hi[e] = start_hi[e] = d[0][e];
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (h + q < h1) {
      st_row(b.lo + (h + q) * kLanes * 16 + at, d[R0 + q]);
      st_row(b.st + (h + q) * kLanes * 16 + at, d[R0 + q]);
    }
  }
}

// rejoin_after for the decoders: same cadences (sync and lsync are powers
// of two), same rows, in batches.
__device__ __forceinline__ void rejoin_batches_after(int t, const Geo& m,
                                                     const DecBufs& b,
                                                     int (&hi)[16],
                                                     int (&start_hi)[16]) {
  if (m.share == 1) return;
  if ((t & (m.sync - 1)) == m.sync - 1) {
    rejoin_batch<true>(b, 0, m.hrows, m.share, hi, start_hi);
    for (int h = kBatch; h < m.hrows; h += kBatch)
      rejoin_batch<false>(b, h, m.hrows, m.share, hi, start_hi);
  }
  if (m.arows > m.srows && ((t + 1) & (m.lsync - 1)) == 0) {
    for (int h = m.srows; h < m.arows; h += kBatch)
      rejoin_batch<false>(b, h, m.arows, m.share, hi, start_hi);
  }
}

// ---- The ring: one stream set's words staged in shared memory.
//
// Stream position p sits in slot p % kRingWords.  Positions below `hi`
// have been requested with cp.async.  Every kRingEvery-th fetch is a
// top-up fetch: before its barrier every thread waits until at most
// kRingLag of its copy groups are in flight, so the words of all earlier
// top-ups but the last kRingLag are visible after that barrier; after the
// barrier the CTA requests [hi, (base + kRingWords) & ~3) as one more
// group.  That overwrites only slots of positions below base, which every
// thread read before the barrier.
struct Ring {
  const int* src;  // the group's stream in device memory
  int* buf;        // kRingWords words in shared memory
  int base;        // next stream position to hand out (CTA-uniform)
  int hi;          // positions below hi are requested
};

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The CTA requests [hi, min((base + kRingWords) & ~3, limit)): at most
// 128 * kRingEvery words (the last kRingEvery fetches'), 16 bytes a copy.
// The stream length limit = R * 128 is a multiple of 4, so no copy
// crosses it.
__device__ __forceinline__ void ring_top_up(Ring& r, int limit) {
  const int to = min((r.base + kRingWords) & ~3, limit);
  for (int q = threadIdx.x; q < kLanes * kRingEvery / 4; q += kLanes) {
    const int p = r.hi + 4 * q;
    if (p < to) cp_async16(r.buf + (p & (kRingWords - 1)), r.src + p);
  }
  r.hi = max(r.hi, to);
}

// Offset (lanes needing a word in the warps before this one) and total,
// from the per-warp counts, one byte a warp: lane i of every warp reads
// warp i's count, and two warp reductions add them up.
__device__ __forceinline__ void warp_prefix(const uint8_t* counts, int& off,
                                            int& tot) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const unsigned c = counts[wl & (kWarps - 1)];
  off = int(__reduce_add_sync(kFull, wl < warp ? c : 0u));
  tot = int(__reduce_add_sync(kFull, wl < kWarps ? c : 0u));
}

// The decoders' renormalisation (fetch in rans_common.cuh) for NS stream
// sets at once, in two halves.  fetch_post: one ballot per set, masked to
// one bit a lane, the per-warp counts to shared memory, the barrier.
// fetch_take, after work that needs no word: each lane that needs a word
// takes the next one of its set in lane order, from the ring; reads at or
// past `limit` give 0.  Counts are double-buffered: buffer f % 2 is
// written again at fetch f + 2, after the barrier of fetch f + 1, which
// every thread reaches only after its reads of fetch f.
template <int NS>
__device__ __forceinline__ void fetch_post(const uint32_t (&state)[NS],
                                           unsigned (&bal)[NS],
                                           const DecBufs& b, int buf,
                                           int nfetch) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    bal[k] = __ballot_sync(kFull, state[k] < kAnsLow);
    if (wl == 0) b.rank[(buf * NS + k) * kWarps + warp] = __popc(bal[k]);
  }
  // a top-up fetch: this thread's copies of all but the last kRingLag
  // top-ups are complete, and the barrier publishes them
  if ((nfetch & (kRingEvery - 1)) == 0) cp_async_wait<kRingLag>();
  __syncthreads();
}

template <int NS>
__device__ __forceinline__ void fetch_take(uint32_t (&state)[NS],
                                           const unsigned (&bal)[NS],
                                           Ring (&r)[NS], int limit,
                                           const DecBufs& b, int& buf,
                                           int& nfetch) {
  const bool top = (nfetch & (kRingEvery - 1)) == 0;
  const unsigned before = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    int off, tot;
    warp_prefix(b.rank + (buf * NS + k) * kWarps, off, tot);
    if (state[k] < kAnsLow) {
      const int p = r[k].base + off + __popc(bal[k] & before);
      const uint32_t word =
          p < limit ? uint32_t(r[k].buf[p & (kRingWords - 1)]) : 0u;
      state[k] = (state[k] << 16) | word;
    }
    if (top) ring_top_up(r[k], limit);
    r[k].base = min(r[k].base + tot, limit);
  }
  if (top) cp_async_commit();
  buf ^= 1;
  ++nfetch;
}

// The byte step shared by K1 (NS = 1: one state, hi then lo nibble, a
// fetch after each) and K5 (NS = 2: state 0 / set 0 carry the hi nibble,
// state 1 / set 1 the lo nibble, one fetch of both after the two steps).
// streams [NS, G, R, 128] int32 -> bytes [K, G, 128] u8, final states
// [NS, G, 128].
template <int NS>
__device__ __forceinline__ void decode_lanes(
    const int* __restrict__ streams, const int* __restrict__ hi_tbl,
    const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
    int* __restrict__ fstate, int K, int G, int R, Geo m, DecCarve c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DecBufs b;
  b.ring = reinterpret_cast<int*>(smem_raw + c.ring);
  b.lo = reinterpret_cast<uint16_t*>(smem_raw + c.lo);
  b.st = reinterpret_cast<uint16_t*>(smem_raw + c.st);
  b.fixed = reinterpret_cast<uint16_t*>(smem_raw + c.fixed);
  b.red = reinterpret_cast<int*>(smem_raw + c.red);
  b.rank = smem_raw + c.rank;
  const int g = blockIdx.x, lane = threadIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + lane;
  const int limit = R * kLanes;

  // Ring prefill: positions [256, 256 + kRingWords) by every thread.
  Ring r[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    r[k].src = streams + (size_t(k) * G + g) * R * kLanes;
    r[k].buf = b.ring + k * kRingWords;
    r[k].base = 2 * kLanes;
    r[k].hi = min(2 * kLanes + kRingWords, limit);
    for (int q = lane; q < kRingWords / 4; q += kLanes) {
      const int p = 2 * kLanes + 4 * q;
      if (p < limit) cp_async16(r[k].buf + (p & (kRingWords - 1)),
                                r[k].src + p);
    }
  }
  cp_async_commit();
  uint32_t state[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k)
    state[k] = (uint32_t(r[k].src[lane]) << 16) |
               uint32_t(r[k].src[kLanes + lane]);

  // Tables: hi in registers; adaptive lo rows per lane (and their start
  // copies); static rows once.
  int hi[16], start_hi[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    hi[e] = hi_tbl[e * G + g];
    start_hi[e] = hi[e];
  }
  for (int h = 0; h < m.arows; ++h) {
    int v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = lo_tbl[(h * 16 + e) * G + g];
    const int at = (h * kLanes + lane) * 16;
    st_row(b.lo + at, v);
    if (m.share > 1) st_row(b.st + at, v);
  }
  for (int q = lane; q < (16 - m.arows) * 16; q += kLanes)
    b.fixed[q] = uint16_t(lo_tbl[(m.arows * 16 + q) * G + g]);
  cp_async_wait<0>();
  __syncthreads();

  uint8_t* out_t = out + col;  // byte t of this lane
  int buf = 0, nfetch = 0;
  for (int t = 0; t < K; ++t) {
    uint32_t value = state[0] & (kTotal - 1);
    const int hs = search_tree(hi, int(value));
    int low_h, fr_h;
    lookup_pick(hi, hs, low_h, fr_h);
    state[0] = uint32_t(fr_h) * (state[0] >> 15) + value - uint32_t(low_h);
    const bool adapt = hs < m.arows;
    uint16_t* rp = adapt ? b.lo + (hs * kLanes + lane) * 16
                         : b.fixed + (hs - m.arows) * 16;
    int row[16];
    unsigned bal[NS];
    if constexpr (NS == 1) {
      fetch_post(state, bal, b, buf, nfetch);
      ld_row(rp, row);
      cdf_update(hi, low_h, m.rate);
      fetch_take(state, bal, r, limit, b, buf, nfetch);
    } else {
      ld_row(rp, row);
    }
    value = state[NS - 1] & (kTotal - 1);
    const int ls = search_tree(row, int(value));
    int low_l, fr_l;
    lookup_pick(row, ls, low_l, fr_l);
    state[NS - 1] = uint32_t(fr_l) * (state[NS - 1] >> 15) + value -
                    uint32_t(low_l);
    fetch_post(state, bal, b, buf, nfetch);
    // what needs no word of this fetch: the model's updates and re-joins
    if constexpr (NS == 2) cdf_update(hi, low_h, m.rate);
    cdf_update(row, low_l, m.rate);
    if (adapt) st_row(rp, row);
    *out_t = uint8_t((hs << 4) | ls);
    out_t += plane;
    rejoin_batches_after(t, m, b, hi, start_hi);
    fetch_take(state, bal, r, limit, b, buf, nfetch);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < NS; ++k) fstate[k * plane + col] = int(state[k]);
}

// ---- K1: decode.  streams [G, R, 128] int32 (rows 0/1 = initial state
// hi16/lo16, words from 256 in consumption order) -> bytes [K, G, 128] u8,
// final states [G, 128].
__global__ void __launch_bounds__(kLanes, 1)
decode_kernel(const int* __restrict__ streams, const int* __restrict__ hi_tbl,
              const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
              int* __restrict__ fstate, int K, int G, int R, Geo m,
              DecCarve c) {
  decode_lanes<1>(streams, hi_tbl, lo_tbl, out, fstate, K, G, R, m, c);
}

// ---- K5: split-state decode.  streams [2, G, R, 128] int32 (set 0 feeds
// state 0, which decodes hi nibbles; set 1 feeds state 1, lo nibbles; each
// set is laid out as K1's) -> bytes [K, G, 128] u8, final states
// [2, G, 128].  One shared model and re-join, as K1's.  The lo search on
// state 1 needs only the hi symbol, not state 0's fetch, so both states
// step before one fetch of both sets.
__global__ void __launch_bounds__(kLanes, 1)
decode_x2_kernel(const int* __restrict__ streams,
                 const int* __restrict__ hi_tbl,
                 const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
                 int* __restrict__ fstate, int K, int G, int R, Geo m,
                 DecCarve c) {
  decode_lanes<2>(streams, hi_tbl, lo_tbl, out, fstate, K, G, R, m, c);
}

// ---- K3: backward rANS pass.  probs [S, L] -> words [S, L] int32 (the low
// 16 bits of the state at every slot), emit [S, L] u8, flush states [L].
// Lanes are independent: one thread per lane, no shared memory.
__global__ void __launch_bounds__(kLanes)
coder_kernel(const int* __restrict__ probs, const int* __restrict__ init,
             int* __restrict__ words, uint8_t* __restrict__ emit,
             int* __restrict__ fstate, int S, int L) {
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  if (lane >= L) return;
  uint32_t state = uint32_t(init[lane]);
  for (int t = S - 1; t >= 0; --t) {
    const size_t at = size_t(t) * L + lane;
    const uint32_t pr = uint32_t(probs[at]);
    const uint32_t low = pr >> 16, freq = pr & 0xFFFFu;
    const bool e = state >= (freq << 16);
    words[at] = int(state & 0xFFFFu);
    emit[at] = e ? 1 : 0;
    if (e) state >>= 16;
    const uint32_t q = state / freq;
    state = (q << 15) + (state - q * freq) + low;
  }
  fstate[lane] = int(state);
}

// ---- K4: placement.  Per slot, the emitting lanes' words go to the next
// consecutive positions of the group stream in lane order, data from word
// 256; rows 0/1 = flush state hi16/lo16; the tail is zeroed; glens = 256 +
// emitted words.
__global__ void __launch_bounds__(kLanes)
place_kernel(const int* __restrict__ words, const uint8_t* __restrict__ emit,
             const int* __restrict__ state, int* __restrict__ gstreams,
             int* __restrict__ glens, int S, int G, int R) {
  __shared__ int wsum[2 * kWarps];
  const int g = blockIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + threadIdx.x;
  int* out = gstreams + size_t(g) * R * kLanes;
  const long long limit = (long long)R * kLanes;
  long long base = 2 * kLanes;
  int buf = 0;
  for (int t = 0; t < S; ++t) {
    const size_t at = size_t(t) * plane + col;
    const bool e = emit[at] != 0;
    int rank, total;
    block_rank(e, wsum, buf, rank, total);
    if (e && base + rank < limit) out[base + rank] = words[at];
    base += total;
  }
  const uint32_t st = uint32_t(state[col]);
  out[threadIdx.x] = int(st >> 16);
  out[kLanes + threadIdx.x] = int(st & 0xFFFFu);
  for (long long p = base + threadIdx.x; p < limit; p += kLanes) out[p] = 0;
  if (threadIdx.x == 0) glens[g] = int(base);
}

Geo make_geo(int share, int sync, int lsync, int arows, int srows, int rate) {
  Geo m;
  m.share = share;
  m.sync = sync;
  m.lsync = lsync;
  m.arows = arows;
  m.srows = srows;
  m.hrows = srows < arows ? srows : arows;
  m.rate = rate;
  return m;
}

// K1 (ns = 1) or K5 (ns = 2): check the launch the wrapper computed
// (ops/rans_kernel.py decode_launch) against what the kernel carves, then
// launch.  A launch that does not fit returns cudaErrorInvalidValue.
int decode_launch(int ns, const void* streams, const void* hi_tbl,
                  const void* lo_tbl, void* out, void* fstate, int K, int G,
                  int R, Geo m, int threads, int smem, DecCarve c,
                  void* stream) {
  const int off[6] = {c.ring, c.lo, c.st, c.fixed, c.red, c.rank};
  const int size[6] = {ns * kRingWords * 4,
                       m.arows * kLanes * 32,
                       (m.share > 1 ? m.arows : 0) * kLanes * 32,
                       (16 - m.arows) * 32,
                       m.share > 32 ? kWarps * 16 * 4 : 0,
                       2 * ns * kWarps};
  bool ok = threads == kLanes && smem <= kSmemMax && m.arows >= 0 &&
            m.arows <= 16 && m.sync > 0 && (m.sync & (m.sync - 1)) == 0 &&
            m.lsync > 0 && (m.lsync & (m.lsync - 1)) == 0 && R >= 2 &&
            R <= (INT_MAX - 2 * kRingWords) / kLanes &&
            (reinterpret_cast<uintptr_t>(streams) & 15) == 0;
  int end = 0;
  for (int i = 0; i < 6; ++i) {
    ok = ok && off[i] % 16 == 0 && off[i] >= end;
    end = off[i] + size[i];
  }
  if (!ok || end > smem) return int(cudaErrorInvalidValue);
  auto kernel = ns == 1 ? decode_kernel : decode_x2_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<G, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<uint8_t*>(out),
      static_cast<int*>(fstate), K, G, R, m, c);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int trc_model(const void* cols, const void* hi_tbl, const void* lo_tbl,
              void* probs, int K, int G, int share, int sync, int lsync,
              int arows, int srows, int rate, void* stream) {
  const size_t smem = model_smem_bytes(share);
  cudaError_t e = cudaFuncSetAttribute(
      model_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  model_kernel<<<G, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<int*>(probs), K, G,
      make_geo(share, sync, lsync, arows, srows, rate));
  return int(cudaGetLastError());
}

int trc_decode(const void* streams, const void* hi_tbl, const void* lo_tbl,
               void* out, void* fstate, int K, int G, int R, int share,
               int sync, int lsync, int arows, int srows, int rate,
               int threads, int smem, int c_ring, int c_lo, int c_st,
               int c_fixed, int c_red, int c_rank, void* stream) {
  return decode_launch(1, streams, hi_tbl, lo_tbl, out, fstate, K, G, R,
                       make_geo(share, sync, lsync, arows, srows, rate),
                       threads, smem,
                       DecCarve{c_ring, c_lo, c_st, c_fixed, c_red, c_rank},
                       stream);
}

int trc_decode_x2(const void* streams, const void* hi_tbl,
                  const void* lo_tbl, void* out, void* fstate, int K, int G,
                  int R, int share, int sync, int lsync, int arows, int srows,
                  int rate, int threads, int smem, int c_ring, int c_lo,
                  int c_st, int c_fixed, int c_red, int c_rank,
                  void* stream) {
  return decode_launch(2, streams, hi_tbl, lo_tbl, out, fstate, K, G, R,
                       make_geo(share, sync, lsync, arows, srows, rate),
                       threads, smem,
                       DecCarve{c_ring, c_lo, c_st, c_fixed, c_red, c_rank},
                       stream);
}

int trc_coder(const void* probs, const void* init, void* words, void* emit,
              void* fstate, int S, int G, void* stream) {
  coder_kernel<<<G, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(probs), static_cast<const int*>(init),
      static_cast<int*>(words), static_cast<uint8_t*>(emit),
      static_cast<int*>(fstate), S, G * kLanes);
  return int(cudaGetLastError());
}

int trc_place(const void* words, const void* emit, const void* state,
              void* gstreams, void* glens, int S, int G, int R,
              void* stream) {
  place_kernel<<<G, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), static_cast<const uint8_t*>(emit),
      static_cast<const int*>(state), static_cast<int*>(gstreams),
      static_cast<int*>(glens), S, G, R);
  return int(cudaGetLastError());
}

}  // extern "C"
