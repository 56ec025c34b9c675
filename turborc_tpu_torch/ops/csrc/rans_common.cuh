// Device functions shared by the rANS kernels of rans_kernel.cu (order 0)
// and rans_o1_kernel.cu (order 1), the bit-tree kernels of
// bittree_kernel.cu and the lane kernels of rans_lane_kernel.cu: the CDF16
// table math, the coders' division by a reciprocal (div_magic), the
// per-lane row layout in shared memory, the o0 share-span re-join, the
// decoders' group-ordered word fetch from a ring of stream words staged in
// shared memory (Ring, fetch_post, fetch_take), the model passes' ring
// of input bytes (model_stage) and a predicated u32 read (ld_u32_if, L9
// and L11).
// Header-only; each source includes it into its own anonymous namespace.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kTotal = 1 << 15;
constexpr uint32_t kAnsLow = 1u << 15;
constexpr int kIC = 10;
constexpr int kMixd = 32736;  // (kTotal - 1) & ~31
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;  // shared memory a CTA may have
// Shared memory of an SM, and what the system keeps of it for each CTA:
// n CTAs of c bytes each fit an SM when n (c + kSmemCta) <= kSmemSm.
constexpr int kSmemSm = 233472;
constexpr int kSmemCta = 1024;

// ---- CDF16 table math (models/cdf16.py); a table is 16 ints in registers

// Single-symbol staircase update.  No repair or clamp: for rate >= 7 and a
// strictly increasing table they are the identity
// (turborc_tpu/ops/pallas/rans_kernel.py:194-204), and every entry stays in
// [0, 2^15): an entry stops short of its target 32886 by at least
// 2^rate - 1 >= 127.  The o0 re-join repairs its own summed diffs
// (rans_kernel.cu).
__device__ __forceinline__ void cdf_update(int (&c)[16], int low, int rate) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    c[i] += (i * kIC - c[i] + (c[i] > low ? kMixd : 0)) >> rate;
}

// The search and lookup of a decoder.  Every per-thread table is indexed by
// unrolled constants only (a data-dependent index would move it to the
// stack, a local-memory access per entry): the search sums flags as a
// tree, the lookup picks entries with a tree of selects.

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

// The lookup of a symbol by picks: its low is entry sym, its freq entry
// sym + 1 (2^15 past 15) less low.  Both picks are taken
// unconditionally: the second under the condition became a branch, and
// K1 slower.
__device__ __forceinline__ void lookup_pick(const int (&c)[16], int sym,
                                            int& low, int& freq) {
  const unsigned s = unsigned(sym), s1 = s + 1;
  const int lo = pick(c, s), nx = pick(c, s1 & 15u);
  low = lo;
  freq = (s1 == 16 ? kTotal : nx) - lo;
}

// ---- The division of the coders' state step (K3, L2)

// x / freq for every x < 2^31 and freq in [1, 2^15] as umulhi(2x, m) >> l
// (Granlund and Montgomery, "Division by invariant integers using
// multiplication", 1994, theorem 4.2 with N = 31): l = ceil(log2 freq),
// m = floor(2^(31+l) / freq) + 1 < 2^32, so that 2^(31+l) < m freq <=
// 2^(31+l) + 2^l.  m is worked out from the normalised divisor dn = freq
// << (16 - l) in (2^15, 2^16] as floor(2^47 / dn) + 1, by two 32-bit
// divisions.  The state after the emit shift is below 2^31.
// K3 (rans_kernel.cu) and L2 (rans_lane_kernel.cu) divide by it; ops/
// rans_kernel.py div_magic mirrors it.
__device__ __forceinline__ void div_magic(uint32_t freq, uint32_t& m,
                                          uint32_t& l) {
  l = 32 - __clz(freq - 1);
  const uint32_t dn = freq << (16 - l);
  const uint32_t q1 = 0x80000000u / dn;
  m = (q1 << 16) + (((0x80000000u - q1 * dn) << 16) / dn) + 1;
}

// ---- Per-lane rows in shared memory.  Row h of a region holds two
// 16-byte halves, each half of the row stored for all N lanes of the CTA
// side by side (N = 128 for a group's CTA), so the 16-byte loads and
// stores of a warp meet no bank conflict.

// This lane's row h of a region of N lanes: its first half; the second is
// N * 8 entries (kHalf at N = 128) further.
constexpr int kHalf = kLanes * 8;
template <int N = kLanes>
__device__ __forceinline__ uint16_t* lane_row(uint16_t* rows, int h) {
  return rows + h * 2 * (N * 8) + threadIdx.x * 8;
}

// The 16 u16 entries of a row <-> registers: entries 0-7 at p, 8-15 at
// p + half (kHalf for a lane's row, 8 for a row stored whole), 16-byte
// aligned.
__device__ __forceinline__ void ld_row(const uint16_t* p, int half,
                                       int (&r)[16]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + q * half);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[8 * q + 2 * k] = int(w[k] & 0xFFFFu);
      r[8 * q + 2 * k + 1] = int(w[k] >> 16);
    }
  }
}

__device__ __forceinline__ void st_row(uint16_t* p, int half,
                                       const int (&r)[16]) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = (uint32_t(r[2 * k]) & 0xFFFFu) | (uint32_t(r[2 * k + 1]) << 16);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    *reinterpret_cast<uint4*>(p + q * half) =
        make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

// ---- The ring: one stream set's words staged in shared memory (K1, K5,
// K6, K8).
//
// Stream position p sits in slot p % kRingWords.  Positions below `hi`
// have been requested with cp.async.  Every kRingEvery-th fetch is a
// top-up fetch: before its barrier every thread waits until at most
// kRingLag of its copy groups are in flight, so the words of all earlier
// top-ups but the last kRingLag are visible after that barrier; after the
// barrier the CTA requests [hi, (base + kRingWords) & ~3) as one more
// group.  That overwrites only slots of positions below base, which every
// thread read before the barrier.  The TPU kernels stage the same words in
// a VMEM window and a register queue
// (turborc_tpu/ops/pallas/rans_kernel.py:377-440).
constexpr int kRingWords = 4096;              // ring of one stream set
constexpr int kRingEvery = 8;                 // fetches between top-ups
constexpr int kRingLag = 1;                   // top-ups allowed in flight
// A fetch takes at most 128 words, and the word read at fetch f was
// requested by a top-up at most (kRingLag + 2) * kRingEvery - 1 fetches
// earlier, which filled the ring to (base + kRingWords) & ~3
// (ops/rans_kernel.py ring_check mirrors this).
static_assert(kRingWords >= kLanes * (kRingLag + 2) * kRingEvery + 3,
              "ring too shallow");
static_assert((kRingEvery & (kRingEvery - 1)) == 0, "kRingEvery: 2^n");

struct Ring {
  const int* src;  // the group's stream in device memory
  int* buf;        // kRingWords words in shared memory
  int base;        // next stream position to hand out (CTA-uniform)
  int hi;          // positions below hi are requested
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// Ring prefill of one stream set by every thread of the CTA: positions
// [256, 256 + kRingWords) of the group's stream src, below limit; the
// caller commits the group.
__device__ __forceinline__ void ring_init(Ring& r, const int* src, int* buf,
                                          int limit) {
  r.src = src;
  r.buf = buf;
  r.base = 2 * kLanes;
  r.hi = min(2 * kLanes + kRingWords, limit);
  for (int q = threadIdx.x; q < kRingWords / 4; q += kLanes) {
    const int p = 2 * kLanes + 4 * q;
    if (p < limit) cp_async16(buf + (p & (kRingWords - 1)), src + p);
  }
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

// The decoders' renormalisation for NS stream sets at once, in two
// halves: lanes with state < 2^15 take the next word of their set's
// stream in lane order across the CTA's 128 lanes.  fetch_post: one
// ballot per set, masked to one bit a lane, the per-warp counts to `rank`
// ([2][NS][kWarps] bytes in shared memory), the barrier.  fetch_take,
// after work that needs no word: each lane that needs a word takes the
// next one of its set in lane order, from the ring; reads at or past
// `limit` give 0, so a corrupt stream never reads out of bounds.  Counts
// are double-buffered: buffer f % 2 is written again at fetch f + 2,
// after the barrier of fetch f + 1, which every thread reaches only
// after its reads of fetch f.
template <int NS>
__device__ __forceinline__ void fetch_post(const uint32_t (&state)[NS],
                                           unsigned (&bal)[NS],
                                           uint8_t* rank, int buf,
                                           int nfetch) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    bal[k] = __ballot_sync(kFull, state[k] < kAnsLow);
    if (wl == 0) rank[(buf * NS + k) * kWarps + warp] = __popc(bal[k]);
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
                                           const uint8_t* rank, int& buf,
                                           int& nfetch) {
  const bool top = (nfetch & (kRingEvery - 1)) == 0;
  const unsigned before = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    int off, tot;
    warp_prefix(rank + (buf * NS + k) * kWarps, off, tot);
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

// ---- The input ring of the model passes (K7, K9): the bytes of a CTA's N
// lanes, D byte steps a stage, two stages; byte step t sits in slot
// t % 2D (N bytes).  The CTA requests byte steps [t0, t0 + D) below K
// (its lanes' bytes start at src, a step every L bytes), 16 lanes a copy:
// the first D N / 16 of its T threads make one copy each.
template <int N, int D, int T>
__device__ __forceinline__ void model_stage(uint8_t* ring, const uint8_t* src,
                                            int t0, int K, size_t L) {
  constexpr int kPer = N / 16;  // copies a byte step
  constexpr int kCopies = D * kPer;
  static_assert(N % 16 == 0 && (D & (D - 1)) == 0 && kCopies <= T,
                "a stage is at most one 16-byte copy a thread");
  const unsigned i = threadIdx.x;
  if (kCopies < T && i >= unsigned(kCopies)) return;
  const int t = t0 + int(i / kPer), part = int(i % kPer) * 16;
  if (t < K)
    cp_async16(ring + (t & (2 * D - 1)) * N + part, src + size_t(t) * L + part);
}

// ---- The o0 share-span re-join (K1, K2 and K5 in rans_kernel.cu, one
// thread a lane; the lane kernels L1 and L3 of rans_lane_kernel.cu run
// their team port of it).  A kernel passes its
// geometry (share, sync, lsync, arows, srows, hrows = min(srows, arows))
// as G and its shared memory as B: `lo` and `st`, the lane rows of its
// adaptive lo tables and of their start copies (lane_row layout), and
// `red`, kWarps x 16 ints for sets wider than a warp.  Lanes of a set are
// `share` adjacent threads of one CTA.

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

// The sum of each of NT tables over every aligned `share`-lane set, all at
// once (their shuffles and loads pipeline).  Uniform in `share`: every
// thread of the CTA takes the same branches.
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
// result, or the span's warm table), so the sum is taken as
// sum(table) - (share - 1) * start: one add fewer a value.  Repair + clamp
// at the re-join are load-bearing (turborc_tpu/ops/pallas/rans_kernel.py
// :515-524).
constexpr int kBatch = 4;  // lo rows a batch, beside the hi table
template <bool kHi, class B>
__device__ __forceinline__ void rejoin_batch(const B& b, int h, int h1,
                                             int share, int (&hi)[16],
                                             int (&start_hi)[16]) {
  constexpr int NT = kBatch + (kHi ? 1 : 0), R0 = kHi ? 1 : 0;
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
      ld_row(lane_row(b.lo, h + q), kHalf, d[R0 + q]);
      ld_row(lane_row(b.st, h + q), kHalf, s[R0 + q]);
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
      st_row(lane_row(b.lo, h + q), kHalf, d[R0 + q]);
      st_row(lane_row(b.st, h + q), kHalf, d[R0 + q]);
    }
  }
}

// The re-joins after byte t, counted in byte index (sync and lsync are
// powers of two): hot (hi table and lo rows < hrows) when t % sync ==
// sync-1, cold (rows srows..arows-1) when (t+1) % lsync == 0, in batches.
template <class G, class B>
__device__ __forceinline__ void rejoin_batches_after(int t, const G& m,
                                                     const B& b,
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

// A u32 read from device memory (read-only data) where `ok`, else 0, with
// no branch: the loaded register is not touched until its first use, so
// the read's latency waits there and not right after it.
__device__ __forceinline__ uint32_t ld_u32_if(bool ok, const void* p) {
  uint32_t v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %1, 0;\n mov.u32 %0, 0;\n"
      " @q ld.global.nc.u32 %0, [%2];\n}\n"
      : "=r"(v)
      : "r"(uint32_t(ok)), "l"(p));
  return v;
}

}  // namespace
