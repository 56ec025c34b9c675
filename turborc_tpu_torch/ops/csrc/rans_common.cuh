// Device functions shared by the rANS kernels of rans_kernel.cu (order 0)
// and rans_o1_kernel.cu (order 1): the CDF16 table math and the decoders'
// group-ordered word fetch.  Header-only; each source includes it into its
// own anonymous namespace.
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

// ---- CDF16 table math (models/cdf16.py); a table is 16 ints in registers

__device__ __forceinline__ int cdf_search(const int (&c)[16], int value) {
  int sym = 0;
#pragma unroll
  for (int i = 1; i < 16; ++i) sym += (c[i] <= value) ? 1 : 0;
  return sym;
}

__device__ __forceinline__ void cdf_lookup(const int (&c)[16], int sym,
                                           int& low, int& freq) {
  int lo = 0, nx = kTotal;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo = (i == sym) ? c[i] : lo;
    nx = (i == sym + 1) ? c[i] : nx;
  }
  low = lo;
  freq = nx - lo;
}

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

// Lane-order rank of the flagged lanes of the CTA: rank = flagged lanes
// before this one, total = flagged lanes in the CTA.  One __syncthreads; the
// partials are double-buffered so the next call cannot overwrite them while
// a slow warp still reads.
__device__ __forceinline__ void block_rank(bool flag, int* wsum, int& buf,
                                           int& rank, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(kFull, flag);
  int* ws = wsum + buf * kWarps;
  if (lane == 0) ws[warp] = __popc(bal);
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = ws[w];
    off += (w < warp) ? c : 0;
    tot += c;
  }
  rank = off + __popc(bal & ((1u << lane) - 1u));
  total = tot;
  buf ^= 1;
}

// Decoders' renormalisation: lanes with state < 2^15 take the next word of
// their group's stream in lane order across the CTA's 128 lanes; reads at or
// past `limit` give 0, so a corrupt stream never reads out of bounds.
__device__ __forceinline__ void fetch(uint32_t& state, const int* s,
                                      long long limit, long long& base,
                                      int* wsum, int& buf) {
  const bool need = state < kAnsLow;
  int rank, total;
  block_rank(need, wsum, buf, rank, total);
  if (need) {
    const long long p = base + rank;
    const uint32_t word = p < limit ? uint32_t(s[p]) : 0u;
    state = (state << 16) | word;
  }
  base += total;
}

}  // namespace
