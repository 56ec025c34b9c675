// Device functions shared by the rANS kernels of rans_kernel.cu (order 0)
// and rans_o1_kernel.cu (order 1) and the bit-tree kernels of
// bittree_kernel.cu: the CDF16 table math, the per-lane row layout in
// shared memory, the decoders' group-ordered word fetch from a ring of
// stream words staged in shared memory (Ring, fetch_post, fetch_take), and
// the model passes' ring of input bytes (model_stage).
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

}  // namespace
