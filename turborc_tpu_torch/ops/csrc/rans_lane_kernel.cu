// Per-lane scan codecs (rans-cdf-o0 id 56, rans-cdf-s8 id 58, rans-static
// id 42) for Hopper, sm_90a.
//
// The JAX package runs these passes as lax.scans compiled by XLA
// (turborc_tpu/codecs/rans_cdf_o0.py, rans_cdf_s8.py, rans_static.py); they
// have no Pallas kernel.  One compiled device loop becomes one kernel:
//   lane_model_kernel          L1  bytes -> slot probs (ids 56, 58)
//   lane_coder_kernel          L2  backward rANS + per-lane compaction
//                                  (ids 56, 58, 42)
//   lane_decode_kernel         L3  per-lane streams -> bytes (ids 56, 58)
//   lane_static_decode_kernel  L4  per-lane streams -> bytes (id 42)
//
// Layout (ops/rans_lane_kernel.py): L lanes, any power of two; byte t of
// lane l at cols/out[t * L + l]; slot s of lane l at probs[s * L + l],
// (low << 16) | freq, the hi nibble of byte t at slot 2t, the lo nibble at
// 2t + 1.  L2 writes lane l's stream at streams[l * M + p], M = S + 2
// words: the flush state (hi16, lo16), then its words in decode order,
// zero past its length (the JAX package's rans.stitch layout).  The
// decoders read the payload's own form: every lane's words, u16, one lane
// after another, lane l's `len[l]` words from offset off[l]; word p of a
// lane reads 0 at or past min(len, M) or past the W words (the JAX
// package's zero-padded [L, M] matrix, for the lengths it accepts).
//
// Every kernel runs one thread a lane on CTAs of kLanes = 128 threads; a
// CTA's threads past L run the loop on dummy data and write nothing, so
// every barrier and shuffle has all its threads.  A lane is a serial state
// machine; lanes are coupled only by the re-join of `share`-lane model
// copies (ids 58; rans_common.cuh's rejoin_batches_after, as K1 and K2 do):
// lane l's model belongs to span l / share, whose warm tables are those of
// segment (l / share) * n_seg / (L / share).
//
// L1 and L3 keep a lane's hi table in registers and its 16 lo rows in
// shared memory (lane_row layout, 64 KB a CTA), beside the start copies of
// the adaptive rows when share > 1.  Rows >= arows are the lane's copy of
// its segment's static row and are never stored.  L1 loads its input
// bytes kPre byte steps ahead in registers, L2 its probs kPre slots ahead;
// L3 and L4 load the next stream word of their lane right after taking
// one, so the load has a step to land.  Reading the payload's u16 words
// at per-lane offsets, not [L, M] int32 rows, keeps a lane's next words
// in a line it has read and rows 64 KB apart out of the same cache sets.
// L2 walks the slots backwards, writes the k-th emitted word at the row's
// end, position M - 1 - k, then moves the E words to positions 2 .. E + 1
// and zeroes what is left of them past E + 1 (the wrapper hands it zeroed
// rows): rans.stitch without a words/emit round trip.  L4 builds the value -> symbol table of the block's static
// CDF in shared memory (32 KB) by binary search, the JAX package's
// searchsorted(cdf, value, side="right") - 1.
//
// Rules kept: __syncthreads() only where all threads of the CTA arrive
// (conditions depend on the byte index and the geometry, never on data);
// no loop bound taken from data; every stream read is bounds-checked (see
// Words), so a corrupt stream or length table decodes to wrong bytes,
// never to an out-of-bounds access or a hang.  Each C entry point checks
// its arguments, returns cudaErrorInvalidValue without a launch when they
// do not fit, and otherwise cudaGetLastError() after its launch.

#include <climits>

#include "rans_common.cuh"

namespace {

// The span model's geometry (rejoin_batches_after reads share, sync,
// lsync, arows, srows, hrows).
struct Span {
  int share, sync, lsync, arows, srows, hrows, rate;
};

// Shared memory of L1 and L3.
struct SpanRows {
  uint16_t* lo;  // [16][2 halves][128 lanes][8] lo rows
  uint16_t* st;  // [arows][2][128][8] start copies (share > 1)
  int* red;      // [kWarps][16] set sums across warps (share > 32)
};

constexpr int kRowBytes = 2 * kLanes * 8 * 2;  // one row of the CTA's lanes
constexpr int kPre = 8;  // byte steps (L1) or slots (L2) loaded ahead

int span_smem(const Span& m) {
  return 16 * kRowBytes + (m.share > 1 ? m.arows * kRowBytes : 0) +
         (m.share > 32 ? kWarps * 16 * 4 : 0);
}

__device__ __forceinline__ SpanRows span_rows(const Span& m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SpanRows b;
  b.lo = reinterpret_cast<uint16_t*>(smem_raw);
  b.st = b.lo + 16 * kRowBytes / 2;
  b.red = reinterpret_cast<int*>(
      smem_raw + 16 * kRowBytes + (m.share > 1 ? m.arows * kRowBytes : 0));
  return b;
}

// Lane l's warm tables (those of its span's segment) to the hi table in
// registers and the lo rows in shared memory.  A dummy lane takes
// segment 0.  Each thread touches only its own rows: no barrier.
__device__ __forceinline__ void span_tables(const int* __restrict__ hi_tbl,
                                            const int* __restrict__ lo_tbl,
                                            int L, int n_seg, int l,
                                            const Span& m, const SpanRows& b,
                                            int (&hi)[16],
                                            int (&start_hi)[16]) {
  const int spans = L / m.share;
  const int seg = l < L ? int((long long)(l / m.share) * n_seg / spans) : 0;
#pragma unroll
  for (int e = 0; e < 16; ++e) hi[e] = start_hi[e] = hi_tbl[seg * 16 + e];
  for (int h = 0; h < 16; ++h) {
    int v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = lo_tbl[(seg * 16 + h) * 16 + e];
    st_row(lane_row(b.lo, h), kHalf, v);
    if (m.share > 1 && h < m.arows) st_row(lane_row(b.st, h), kHalf, v);
  }
}

// ---- L1: the o0 nibble-pair model over known bytes.  cols [K, L] u8 ->
// probs [2K, L] int32.  The JAX package's rans_cdf_s8.encode_device model
// pass (rans_cdf_o0.encode_device's at share 1 and one segment).
__global__ void __launch_bounds__(kLanes)
lane_model_kernel(const uint8_t* __restrict__ cols,
                  const int* __restrict__ hi_tbl,
                  const int* __restrict__ lo_tbl, int* __restrict__ probs,
                  int K, int L, int n_seg, Span m) {
  const SpanRows b = span_rows(m);
  const int l = blockIdx.x * kLanes + threadIdx.x;
  const bool real = l < L;
  int hi[16], start_hi[16];
  span_tables(hi_tbl, lo_tbl, L, n_seg, l, m, b, hi, start_hi);

  // byte steps t .. t + kPre - 1 in q[0 .. kPre - 1]; byte t + kPre is
  // requested as byte t is taken
  const uint8_t* src = cols + (real ? l : 0);
  int* out = probs + (real ? l : 0);
  int q[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u)
    q[u] = real && u < K ? src[size_t(u) * L] : 0;
  for (int t = 0; t < K; ++t) {
    const int sym = q[0];
#pragma unroll
    for (int u = 0; u + 1 < kPre; ++u) q[u] = q[u + 1];
    q[kPre - 1] = real && t + kPre < K ? src[size_t(t + kPre) * L] : 0;
    const int hs = sym >> 4, ls = sym & 15;
    int low_h, fr_h;
    lookup_pick(hi, hs, low_h, fr_h);
    uint16_t* rp = lane_row(b.lo, hs);
    int row[16];
    ld_row(rp, kHalf, row);
    cdf_update(hi, low_h, m.rate);
    int low_l, fr_l;
    lookup_pick(row, ls, low_l, fr_l);
    if (hs < m.arows) {
      cdf_update(row, low_l, m.rate);
      st_row(rp, kHalf, row);
    }
    if (real) {
      out[size_t(2 * t) * L] = (low_h << 16) | fr_h;
      out[size_t(2 * t + 1) * L] = (low_l << 16) | fr_l;
    }
    rejoin_batches_after(t, m, b, hi, start_hi);
  }
}

// ---- L2: backward rANS over a lane's slots and the compaction of its
// stream.  probs [S, L] int32, init [L] (states >= 2^15), streams [L,
// S + 2] int32 zeroed -> streams, lengths [L]
// (rans.stitch(*rans.encode_backward(...))).
__global__ void __launch_bounds__(kLanes)
lane_coder_kernel(const int* __restrict__ probs, const int* __restrict__ init,
                  int* __restrict__ streams, int* __restrict__ lengths, int S,
                  int L) {
  const int l = blockIdx.x * kLanes + threadIdx.x;
  if (l >= L) return;  // no barrier below
  const size_t M = size_t(S) + 2;
  int* row = streams + size_t(l) * M;
  uint32_t state = uint32_t(init[l]);
  int k = 0;  // words emitted so far; word k sits at M - 1 - k
  // slots s .. s - kPre + 1 in q[0 .. kPre - 1]; slot s - kPre is
  // requested as slot s is taken (a slot below 0 reads freq 1, unused)
  const int* src = probs + l;
  uint32_t q[kPre];
#pragma unroll
  for (int u = 0; u < kPre; ++u)
    q[u] = S - 1 - u >= 0 ? uint32_t(src[size_t(S - 1 - u) * L]) : 1u;
  for (int s = S - 1; s >= 0; --s) {
    const uint32_t p = q[0];
#pragma unroll
    for (int u = 0; u + 1 < kPre; ++u) q[u] = q[u + 1];
    q[kPre - 1] = s - kPre >= 0 ? uint32_t(src[size_t(s - kPre) * L]) : 1u;
    const uint32_t low = p >> 16, freq = p & 0xFFFFu;
    if (state >= (freq << 16)) {
      row[M - 1 - k] = int(state & 0xFFFFu);
      ++k;
      state >>= 16;
    }
    const uint32_t quo = state / freq;
    state = (quo << 15) + (state - quo * freq) + low;
  }
  // words M-k .. M-1 (decode order) to 2 .. k+1; the move reads ahead of
  // what it writes (M - k >= 2).  The row came zeroed: only the words
  // left past k + 1 are cleared.
  for (int i = 0; i < k; ++i) row[2 + i] = row[M - k + i];
  for (size_t p = max(size_t(k) + 2, M - k); p < M; ++p) row[p] = 0;
  row[0] = int(state >> 16);
  row[1] = int(state & 0xFFFFu);
  lengths[l] = k + 2;
}

// A lane's stream reader over the payload's u16 words: word p of the lane
// is words[off + p] for p < n, else 0; the next word is loaded as soon as
// the last one is taken.
struct Words {
  const uint16_t* src;  // the lane's first word
  int n, pos;           // words readable; next position
  uint32_t next;        // the word at pos
};

// Lane l's reader: n = min(len, M, W - off), none for a dummy lane or an
// offset outside the W words.
__device__ __forceinline__ void words_init(Words& w, const uint16_t* words,
                                           const long long* off,
                                           const int* len, long long W, int M,
                                           int l, bool real,
                                           uint32_t& state) {
  const long long o = real ? off[l] : -1;
  long long n = o >= 0 && o < W ? min((long long)min(len[l], M), W - o) : 0;
  w.n = int(max(n, 0LL));
  w.src = words + (w.n ? o : 0);
  const uint32_t hi = w.n > 0 ? w.src[0] : 0u, lo = w.n > 1 ? w.src[1] : 0u;
  state = real ? (hi << 16) | lo : kAnsLow;
  w.pos = 2;
  w.next = 2 < w.n ? uint32_t(w.src[2]) : 0u;
}

__device__ __forceinline__ void words_renorm(Words& w, uint32_t& state) {
  if (state < kAnsLow) {
    state = (state << 16) | w.next;
    ++w.pos;
    w.next = w.pos < w.n ? uint32_t(w.src[w.pos]) : 0u;
  }
}

// ---- L3: the decode of L1's model.  Lane streams (words, off, len; M =
// 2K + 2) -> bytes [K, L] u8 (rans_cdf_s8.decode_device;
// rans_cdf_o0.decode_device at share 1 and one segment).
__global__ void __launch_bounds__(kLanes)
lane_decode_kernel(const uint16_t* __restrict__ words,
                   const long long* __restrict__ off,
                   const int* __restrict__ len,
                   const int* __restrict__ hi_tbl,
                   const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
                   int K, int L, long long W, int n_seg, Span m) {
  const SpanRows b = span_rows(m);
  const int l = blockIdx.x * kLanes + threadIdx.x;
  const bool real = l < L;
  int hi[16], start_hi[16];
  span_tables(hi_tbl, lo_tbl, L, n_seg, l, m, b, hi, start_hi);
  Words w;
  uint32_t state;
  words_init(w, words, off, len, W, 2 * K + 2, l, real, state);
  uint8_t* dst = out + (real ? l : 0);
  for (int t = 0; t < K; ++t) {
    uint32_t value = state & (kTotal - 1);
    const int hs = search_tree(hi, int(value));
    int low_h, fr_h;
    lookup_pick(hi, hs, low_h, fr_h);
    state = uint32_t(fr_h) * (state >> 15) + value - uint32_t(low_h);
    words_renorm(w, state);
    cdf_update(hi, low_h, m.rate);
    uint16_t* rp = lane_row(b.lo, hs);
    int row[16];
    ld_row(rp, kHalf, row);
    value = state & (kTotal - 1);
    const int ls = search_tree(row, int(value));
    int low_l, fr_l;
    lookup_pick(row, ls, low_l, fr_l);
    state = uint32_t(fr_l) * (state >> 15) + value - uint32_t(low_l);
    words_renorm(w, state);
    if (hs < m.arows) {
      cdf_update(row, low_l, m.rate);
      st_row(rp, kHalf, row);
    }
    if (real) dst[size_t(t) * L] = uint8_t((hs << 4) | ls);
    rejoin_batches_after(t, m, b, hi, start_hi);
  }
}

// ---- L4: static-CDF byte decode.  Lane streams (words, off, len; M =
// 2K + 2), cdf [257] int32 (non-decreasing, cdf[0] = 0, cdf[256] = 2^15)
// -> bytes [K, L] u8 (rans_static.decode_device).
__global__ void __launch_bounds__(kLanes)
lane_static_decode_kernel(const uint16_t* __restrict__ words,
                          const long long* __restrict__ off,
                          const int* __restrict__ len,
                          const int* __restrict__ cdf,
                          uint8_t* __restrict__ out, int K, int L,
                          long long W) {
  __shared__ int c[257];
  __shared__ uint8_t sym_of[kTotal];
  for (int i = threadIdx.x; i < 257; i += kLanes) c[i] = cdf[i];
  __syncthreads();
  // sym_of[v] = the last i with c[i] <= v (c[256] = 2^15 > v)
  for (int v = threadIdx.x; v < kTotal; v += kLanes) {
    int lo = 0, hi = 256;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int mid = (lo + hi) >> 1;
      if (c[mid] <= v) lo = mid; else hi = mid;
    }
    sym_of[v] = uint8_t(lo);
  }
  __syncthreads();
  const int l = blockIdx.x * kLanes + threadIdx.x;
  if (l >= L) return;  // no barrier below
  Words w;
  uint32_t state;
  words_init(w, words, off, len, W, 2 * K + 2, l, true, state);
  uint8_t* dst = out + l;
  for (int t = 0; t < K; ++t) {
    const uint32_t value = state & (kTotal - 1);
    const int sym = sym_of[value];
    const int low = c[sym], freq = c[sym + 1] - low;
    state = uint32_t(freq) * (state >> 15) + value - uint32_t(low);
    words_renorm(w, state);
    dst[size_t(t) * L] = uint8_t(sym);
  }
}

bool pow2(int v, int cap) { return v >= 1 && v <= cap && !(v & (v - 1)); }

// The span geometry of L1 / L3, or false where it does not fit L lanes,
// n_seg segments and K byte steps.
bool make_span(int K, int L, int n_seg, int share, int sync, int lsync,
               int arows, int srows, int rate, Span& m) {
  if (K < 0 || !pow2(L, 1 << 30) || !pow2(share, 128) || L % share ||
      n_seg < 1 || n_seg > L / share || !pow2(sync, 128) ||
      !pow2(lsync, 128) || lsync % sync || arows < 0 || arows > 16 ||
      srows < 0 || srows > 31 || rate < 7 || rate > 10)
    return false;
  if (share > 1 && K % lsync) return false;  // the cold re-join's cadence
  if (size_t(2) * size_t(K) * size_t(L) > size_t(1) << 40) return false;
  m.share = share;
  m.sync = sync;
  m.lsync = lsync;
  m.arows = arows;
  m.srows = srows;
  m.hrows = srows < arows ? srows : arows;
  m.rate = rate;
  return true;
}

int grid_of(int L) { return (L + kLanes - 1) / kLanes; }

// Lets `kernel` take `smem` bytes of dynamic shared memory (past 48 KB).
template <class F>
int allow_smem(F kernel, int smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

extern "C" {

// L1.  The tensors are checked by the wrapper (ops/rans_lane_kernel.py);
// the geometry here.
int trc_lane_model(const uint8_t* cols, const int* hi_tbl, const int* lo_tbl,
                   int* probs, int K, int L, int n_seg, int share, int sync,
                   int lsync, int arows, int srows, int rate,
                   cudaStream_t stream) {
  Span m;
  if (!make_span(K, L, n_seg, share, sync, lsync, arows, srows, rate, m))
    return int(cudaErrorInvalidValue);
  const int smem = span_smem(m);
  if (const int e = allow_smem(lane_model_kernel, smem)) return e;
  lane_model_kernel<<<grid_of(L), kLanes, smem, stream>>>(
      cols, hi_tbl, lo_tbl, probs, K, L, n_seg, m);
  return int(cudaGetLastError());
}

// L2.
int trc_lane_coder(const int* probs, const int* init, int* streams,
                   int* lengths, int S, int L, cudaStream_t stream) {
  if (S < 0 || S > INT_MAX - 2 || !pow2(L, 1 << 30))
    return int(cudaErrorInvalidValue);
  lane_coder_kernel<<<grid_of(L), kLanes, 0, stream>>>(probs, init, streams,
                                                       lengths, S, L);
  return int(cudaGetLastError());
}

// L3.
int trc_lane_decode(const uint16_t* words, const long long* off,
                    const int* len, const int* hi_tbl, const int* lo_tbl,
                    uint8_t* out, int K, int L, int W, int n_seg, int share,
                    int sync, int lsync, int arows, int srows, int rate,
                    cudaStream_t stream) {
  Span m;
  if (!make_span(K, L, n_seg, share, sync, lsync, arows, srows, rate, m) ||
      K > (INT_MAX - 2) / 2 || W < 0)
    return int(cudaErrorInvalidValue);
  const int smem = span_smem(m);
  if (const int e = allow_smem(lane_decode_kernel, smem)) return e;
  lane_decode_kernel<<<grid_of(L), kLanes, smem, stream>>>(
      words, off, len, hi_tbl, lo_tbl, out, K, L, W, n_seg, m);
  return int(cudaGetLastError());
}

// L4.
int trc_lane_static_decode(const uint16_t* words, const long long* off,
                           const int* len, const int* cdf, uint8_t* out,
                           int K, int L, int W, cudaStream_t stream) {
  if (K < 0 || K > (INT_MAX - 2) / 2 || W < 0 || !pow2(L, 1 << 30))
    return int(cudaErrorInvalidValue);
  lane_static_decode_kernel<<<grid_of(L), kLanes, 0, stream>>>(
      words, off, len, cdf, out, K, L, W);
  return int(cudaGetLastError());
}

}  // extern "C"
