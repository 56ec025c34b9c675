// Per-lane scan codecs (rans-cdf-o0 id 56, rans-cdf-s8 id 58, rans-static
// id 42, rans-cdf-r1 id 59, rans-cdf-o1 id 64) for Hopper, sm_90a.
//
// The JAX package runs these passes as lax.scans compiled by XLA
// (turborc_tpu/codecs/rans_cdf_o0.py, rans_cdf_s8.py, rans_static.py,
// rans_cdf_r1.py, rans_cdf_o1.py); they have no Pallas kernel.  One
// compiled device loop becomes one kernel:
//   lane_model_kernel          L1  bytes -> slot probs (ids 56, 58)
//   lane_coder_kernel          L2  backward rANS + per-lane compaction
//                                  (ids 56, 58, 42, 59, 64)
//   lane_decode_kernel         L3  per-lane streams -> bytes (ids 56, 58)
//   lane_static_decode_kernel  L4  per-lane streams -> bytes (id 42)
//   lane_o1_model_kernel       L5  bytes -> slot probs (id 59, O1Rank)
//                              L7  (id 64, O1Byte)
//   lane_o1_decode_kernel      L6  per-lane streams -> bytes (id 59)
//                              L8  (id 64)
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
// L1, L3-L8 run a team of T threads a lane, L2 one thread a lane on
// CTAs of kCoderN lanes (below).  A CTA's threads past L run the loop on
// dummy data and write nothing, so every barrier and shuffle has all its
// threads.  A lane is a serial state machine; lanes are coupled only by the
// re-join of `share`-lane model copies (id 58; the team port of
// rans_common.cuh's rejoin_batches_after, which K1, K2 and K5 run): lane
// l's model belongs to span l / share, whose warm tables are those of
// segment (l / share) * n_seg / (L / share).
//
// L1 and L3: a team of T consecutive threads of a warp a lane (kTeam, or
// half of it where a span's teams would pass kMaxThreads), thread j of the
// team holding entries j E .. j E + E - 1 (E = 16 / T) of each of the
// lane's tables.  One thread a lane left 512 lanes on 4 CTAs, one warp a
// scheduler, with a byte step of about 1,000 cycles of serial table work;
// a CDF16 operation is entry-wise, so a team shortens the chain: the
// search is a ballot and a popc, a lookup a shuffle, the update one line
// a thread, the re-join's repair a shuffle scan, its set sums one value a
// thread.  At 512 lanes and T = 16 that is 64 CTAs of 128 threads.  The
// hi table lives in registers, the 16 lo rows (and, at share > 1, the
// start copies of the adaptive rows) in shared memory, each thread's own
// entries of them; no thread reads another's entries from memory, so only
// the re-join's set sums across warps need a barrier.  Rows >= arows are
// the lane's copy of its segment's static row and are never stored.
// Every thread of a team carries the lane's rANS state (L3); the lane's
// stream words (L3), input bytes (L1) and outputs are spread over the
// team, a word or a step a thread, loaded or stored a chunk of T at a
// time and shuffled to the team a step ahead of their use.  Reading the
// payload's u16 words at per-lane offsets, not [L, M] int32 rows, keeps a
// lane's next words in a line it has read.  L2 (K3's coder chain over a
// lane's row) and L4 (one table load a byte on L3's word reader) are
// described at their kernels.
//
// Rules kept: __syncthreads() only where all threads of the CTA arrive
// (conditions depend on the byte index and the geometry, never on data);
// no loop bound taken from data beyond counts the kernel bounds itself
// (L2's k <= S words a lane, L4's at most 255 symbol moves a thread); every
// stream read is bounds-checked (see
// TeamWords), so a corrupt stream or length table decodes to wrong
// bytes, never to an out-of-bounds access or a hang.  Each C entry point
// checks its arguments, returns cudaErrorInvalidValue without a launch
// when they do not fit, and otherwise cudaGetLastError() after its launch.

#include <climits>
#include <type_traits>

#include "rans_common.cuh"

namespace {

// The span model's geometry (rejoin_batches_after reads share, sync,
// lsync, arows, srows, hrows).
struct Span {
  int share, sync, lsync, arows, srows, hrows, rate;
};

// ---- The team of a lane (L1, L3).  Thread j of lane l's team is thread
// l T + j of the grid and holds entries j E .. j E + E - 1 of the lane's
// tables, E = 16 / T.  A CTA has max(kCtaMin, share T) threads, so it
// holds whole spans and its re-join needs no other CTA; where kTeam share
// would pass kMaxThreads (share 128 at kTeam 16), T is kTeam / 2.
constexpr int kTeam = 16;         // threads a lane
constexpr int kCtaMin = 128;      // threads a CTA has at least
constexpr int kMaxThreads = 1024;  // threads a CTA may have
static_assert(kTeam == 4 || kTeam == 8 || kTeam == 16, "kTeam: 4, 8, 16");
static_assert(kTeam / 2 * 128 <= kMaxThreads, "a span of 128 lanes fits");

// Shared memory of a CTA of N = threads / T lanes: lo [16][N][16] u16 (row
// h of its lane n at (h N + n) 16), st [arows][N][16] u16, the start
// copies (share > 1), red [2][warps][kBatch + 1][16] int, the set sums
// across warps (share T > 32), in two buffers taken in turns.
struct TeamRows {
  uint16_t* lo;
  uint16_t* st;
  int* red;
  int lanes;  // N
};

int team_smem(const Span& m, int threads, int T) {
  return (16 + (m.share > 1 ? m.arows : 0)) * (threads / T) * 32 +
         (m.share * T > 32 ? 2 * (kBatch + 1) * (threads / 32) * 16 * 4 : 0);
}

template <int T>
__device__ __forceinline__ TeamRows team_rows(const Span& m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TeamRows b;
  b.lanes = blockDim.x / T;
  b.lo = reinterpret_cast<uint16_t*>(smem_raw);
  b.st = b.lo + 16 * b.lanes * 16;
  b.red = reinterpret_cast<int*>(
      smem_raw + (16 + (m.share > 1 ? m.arows : 0)) * b.lanes * 32);
  return b;
}

// This thread's entries of row h of its lane n.
template <int T>
__device__ __forceinline__ uint16_t* team_row(uint16_t* rows, int lanes,
                                              int h, int n, int j) {
  return rows + (h * lanes + n) * 16 + j * (16 / T);
}

// E u16 entries <-> registers, one 2-, 4- or 8-byte access.
template <int E>
__device__ __forceinline__ void ld_part(const uint16_t* p, int (&v)[E]) {
  if constexpr (E == 1) {
    v[0] = *p;
  } else if constexpr (E == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    v[0] = int(w & 0xFFFFu);
    v[1] = int(w >> 16);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = int(w.x & 0xFFFFu);
    v[1] = int(w.x >> 16);
    v[2] = int(w.y & 0xFFFFu);
    v[3] = int(w.y >> 16);
  }
}

template <int E>
__device__ __forceinline__ void st_part(uint16_t* p, const int (&v)[E]) {
  if constexpr (E == 1) {
    *p = uint16_t(v[0]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<uint32_t*>(p) =
        (uint32_t(v[0]) & 0xFFFFu) | (uint32_t(v[1]) << 16);
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2((uint32_t(v[0]) & 0xFFFFu) | (uint32_t(v[1]) << 16),
                   (uint32_t(v[2]) & 0xFFFFu) | (uint32_t(v[3]) << 16));
  }
}

// cdf_search over the team's table: the count of entries i = 1..15 with
// c_i <= value, one ballot an entry a thread, popc of the team's bits.
template <int T>
__device__ __forceinline__ int team_search(const int (&c)[16 / T], int value,
                                           int j, unsigned mask) {
  constexpr int E = 16 / T;
  int n = 0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    n += __popc(__ballot_sync(kFull, j * E + e > 0 && c[e] <= value) & mask);
  return n;
}

// Entry s of the team's table in every thread of the team: the holder's
// entry s % E (a select by the team-uniform s), then one shuffle.
template <int T>
__device__ __forceinline__ int team_pick(const int (&c)[16 / T], int s) {
  int mine = c[0];
  if constexpr (T == 8) mine = s & 1 ? c[1] : c[0];
  if constexpr (T == 4) {
    const int a = s & 1 ? c[1] : c[0], b = s & 1 ? c[3] : c[2];
    mine = s & 2 ? b : a;
  }
  return __shfl_sync(kFull, mine, s / (16 / T), T);
}

// lookup_pick's low and freq (entry sym + 1 is 2^15 past 15).
template <int T>
__device__ __forceinline__ void team_lookup(const int (&c)[16 / T], int sym,
                                            int& low, int& freq) {
  low = team_pick<T>(c, sym);
  const int nx = team_pick<T>(c, (sym + 1) & 15);
  freq = (sym == 15 ? kTotal : nx) - low;
}

// cdf_update entry-wise, low broadcast (the same predicate c_i > low).
template <int T>
__device__ __forceinline__ void team_update(int (&c)[16 / T], int low,
                                            int rate, int j) {
  constexpr int E = 16 / T;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = j * E + e;
    c[e] += (i * kIC - c[e] + (c[e] > low ? kMixd : 0)) >> rate;
  }
}

// Whether the team's table is strictly increasing (c_i > c_{i-1}), where
// repair16 is the identity.
template <int T>
__device__ __forceinline__ bool team_increasing(const int (&c)[16 / T],
                                                int j) {
  constexpr int E = 16 / T;
  bool inc = true;
#pragma unroll
  for (int e = 1; e < E; ++e) inc = inc && c[e] > c[e - 1];
  const int before = __shfl_up_sync(kFull, c[E - 1], 1, T);
  return inc && (j == 0 || c[0] > before);
}

// repair16: c_i = max_{k <= i}(c_k - k) + i, the prefix max by a shuffle
// scan across the team (log2 T steps) after the thread's own E entries.
template <int T>
__device__ __forceinline__ void team_repair(int (&c)[16 / T], int j) {
  constexpr int E = 16 / T;
  int p[E];
  int m = c[0] - j * E;
  p[0] = m;
#pragma unroll
  for (int e = 1; e < E; ++e) {
    m = max(m, c[e] - (j * E + e));
    p[e] = m;
  }
#pragma unroll
  for (int k = 1; k < T; k <<= 1) {
    const int o = __shfl_up_sync(kFull, m, k, T);
    if (j >= k) m = max(m, o);
  }
  if constexpr (E == 1) {
    c[0] = m + j;
  } else {
    // the max over the threads before this one, then its own entries
    const int before = __shfl_up_sync(kFull, m, 1, T);
#pragma unroll
    for (int e = 0; e < E; ++e)
      c[e] = (j > 0 ? max(before, p[e]) : p[e]) + j * E + e;
  }
}

// set_sum_n in the team layout: each of NT tables summed over every
// aligned span of `share` lanes, entry by entry: a butterfly over the
// lanes of a warp (offsets T, 2T, ...), then, for a span wider than a
// warp, each warp's sums through buffer `buf` of `red` (one barrier for
// all NT).  The buffers alternate from one call to the next: a thread
// writes a buffer again only after the next call's barrier, which every
// thread reaches after its reads of this one.
template <int T, int NT>
__device__ __forceinline__ void team_set_sum(int (&x)[NT][16 / T], int share,
                                             int* red, int j, int& buf) {
  constexpr int E = 16 / T;
  const int span = share * T;  // threads of a span
  const int lim = span < 32 ? span : 32;
  for (int k = T; k < lim; k <<= 1) {
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        x[q][e] += __shfl_xor_sync(kFull, x[q][e], k);
    }
  }
  if (span > 32) {
    const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int per = span >> 5;  // warps of a span
    const int first = warp & ~(per - 1);
    // this thread's entries of warp w's sums at red[w NT 16 + q 16] of
    // its buffer
    red += buf * warps * NT * 16 + j * E;
    buf ^= 1;
    if ((threadIdx.x & 31) < T) {
#pragma unroll
      for (int q = 0; q < NT; ++q) {
#pragma unroll
        for (int e = 0; e < E; ++e) red[(warp * NT + q) * 16 + e] = x[q][e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NT; ++q) {
#pragma unroll
      for (int e = 0; e < E; ++e) x[q][e] = 0;
    }
#pragma unroll 2
    for (int w = first; w < first + per; ++w) {
      const int* r = red + w * NT * 16;
#pragma unroll
      for (int q = 0; q < NT; ++q) {
#pragma unroll
        for (int e = 0; e < E; ++e) x[q][e] += r[q * 16 + e];
      }
    }
  }
}

// rejoin_batch in the team layout: lo rows h .. h + kBatch - 1 (those
// below h1) and, where with_hi, the hi table: start + the set's sum of
// (table - start), repaired and clamped, to the row and its start copy.
// Without the hi table its slot sums zeros: one body serves every batch,
// which keeps the byte loop's code small.
template <int T>
__device__ __forceinline__ void team_rejoin_batch(const TeamRows& b, int n,
                                                  int j, int h, int h1,
                                                  bool with_hi, int share,
                                                  int& buf, int (&hi)[16 / T],
                                                  int (&start_hi)[16 / T]) {
  constexpr int E = 16 / T, NT = kBatch + 1;
  int d[NT][E], s[NT][E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    s[0][e] = with_hi ? start_hi[e] : 0;
    d[0][e] = with_hi ? hi[e] : 0;
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (h + q < h1) {
      ld_part<E>(team_row<T>(b.lo, b.lanes, h + q, n, j), d[1 + q]);
      ld_part<E>(team_row<T>(b.st, b.lanes, h + q, n, j), s[1 + q]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[1 + q][e] = s[1 + q][e] = 0;
    }
  }
  team_set_sum<T>(d, share, b.red, j, buf);
  // repair16 is the identity on strictly increasing tables: the scans run
  // only where a table of the warp needs them
  bool inc = true;
#pragma unroll
  for (int q = 0; q < NT; ++q) {
#pragma unroll
    for (int e = 0; e < E; ++e) d[q][e] += (1 - share) * s[q][e];
    inc = team_increasing<T>(d[q], j) && inc;
  }
  if (!__all_sync(kFull, inc)) {
#pragma unroll
    for (int q = 0; q < NT; ++q) team_repair<T>(d[q], j);
  }
#pragma unroll
  for (int q = 0; q < NT; ++q) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      d[q][e] = min(d[q][e], kTotal - 16 + j * E + e);  // clamp16
  }
  if (with_hi) {
#pragma unroll
    for (int e = 0; e < E; ++e) hi[e] = start_hi[e] = d[0][e];
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (h + q < h1) {
      st_part<E>(team_row<T>(b.lo, b.lanes, h + q, n, j), d[1 + q]);
      st_part<E>(team_row<T>(b.st, b.lanes, h + q, n, j), d[1 + q]);
    }
  }
}

// rejoin_batches_after's cadences, counted in byte index: hot (hi table
// and lo rows < hrows) when t % sync == sync - 1, cold (rows srows ..
// arows - 1) when (t + 1) % lsync == 0.  The hot batches (the first with
// the hi table, even where hrows is 0) come first, then the cold ones.
template <int T>
__device__ __forceinline__ void team_rejoins_after(int t, const Span& m,
                                                   const TeamRows& b, int n,
                                                   int j, int& buf,
                                                   int (&hi)[16 / T],
                                                   int (&start_hi)[16 / T]) {
  if (m.share == 1) return;
  const bool hot = (t & (m.sync - 1)) == m.sync - 1;
  const bool cold = m.arows > m.srows && ((t + 1) & (m.lsync - 1)) == 0;
  for (int pass = hot ? 0 : 1; pass < (cold ? 2 : 1); ++pass) {
    const int h1 = pass ? m.arows : m.hrows;
    for (int h = pass ? m.srows : 0; h < h1 || (pass == 0 && h == 0);
         h += kBatch)
      team_rejoin_batch<T>(b, n, j, h, h1, pass == 0 && h == 0, m.share, buf,
                           hi, start_hi);
  }
}

// Lane l's warm tables (those of its span's segment): this thread's hi
// entries to registers, its entries of the lo rows (and their start
// copies) to shared memory.  A dummy lane takes segment 0.
template <int T>
__device__ __forceinline__ void team_tables(const int* __restrict__ hi_tbl,
                                            const int* __restrict__ lo_tbl,
                                            int L, int n_seg, int l, int n,
                                            int j, const Span& m,
                                            const TeamRows& b,
                                            int (&hi)[16 / T],
                                            int (&start_hi)[16 / T]) {
  constexpr int E = 16 / T;
  const int spans = L / m.share;
  const int seg = l < L ? int((long long)(l / m.share) * n_seg / spans) : 0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    hi[e] = start_hi[e] = hi_tbl[seg * 16 + j * E + e];
  for (int h = 0; h < 16; ++h) {
    int v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = lo_tbl[(seg * 16 + h) * 16 + j * E + e];
    st_part<E>(team_row<T>(b.lo, b.lanes, h, n, j), v);
    if (m.share > 1 && h < m.arows)
      st_part<E>(team_row<T>(b.st, b.lanes, h, n, j), v);
  }
}

// The team's bits of its warp.
template <int T>
__device__ __forceinline__ unsigned team_mask() {
  return ((1u << T) - 1u) << (threadIdx.x & 31 & ~(T - 1));
}

// ---- L1: the o0 nibble-pair model over known bytes.  cols [K, L] u8 ->
// probs [2K, L] int32.  The JAX package's rans_cdf_s8.encode_device model
// pass (rans_cdf_o0.encode_device's at share 1 and one segment).  A CTA
// has at most the teams of a span of 128 lanes (or kCtaMin threads).
// kShared: share > 1 (the re-joins).
template <int T, bool kShared>
__global__ void __launch_bounds__(T * 128 < kMaxThreads ? T * 128
                                                     : kMaxThreads, 1)
lane_model_kernel(const uint8_t* __restrict__ cols,
                  const int* __restrict__ hi_tbl,
                  const int* __restrict__ lo_tbl, int* __restrict__ probs,
                  int K, int L, int n_seg, Span m) {
  constexpr int E = 16 / T;
  const TeamRows b = team_rows<T>(m);
  const int n = threadIdx.x / T, j = threadIdx.x % T;
  const int l = blockIdx.x * b.lanes + n;
  const bool real = l < L;
  int hi[E], start_hi[E];
  team_tables<T>(hi_tbl, lo_tbl, L, n_seg, l, n, j, m, b, hi, start_hi);

  // The lane's bytes in chunks of T steps, team thread j holding step
  // t0 + j of chunk t0 (cur) and of the next one (nxt, loaded a chunk
  // ahead); byte t + 1 is shuffled out of cur during step t.  Its probs
  // likewise: thread j keeps the two slots of step t0 + j, and the team
  // stores a chunk's slots at its last step.
  const uint8_t* src = cols + (real ? l : 0) + size_t(j) * L;
  int* out = probs + (real ? l : 0);
  int buf = 0;  // red's buffer for the next set sum across warps
  int cur = real && j < K ? src[0] : 0;
  int nxt = real && T + j < K ? src[size_t(T) * L] : 0;
  int sym_next = __shfl_sync(kFull, cur, 0, T);
  int slot_h = 0, slot_l = 0;
  for (int t = 0; t < K; ++t) {
    const int sym = sym_next;
    if ((t & (T - 1)) == T - 1) {
      cur = nxt;
      nxt = real && t + 1 + T + j < K ? src[size_t(t + 1 + T) * L] : 0;
    }
    sym_next = __shfl_sync(kFull, cur, (t + 1) & (T - 1), T);
    const int hs = sym >> 4, ls = sym & 15;
    uint16_t* rp = team_row<T>(b.lo, b.lanes, hs, n, j);
    int row[E];
    ld_part<E>(rp, row);
    int low_h, fr_h;
    team_lookup<T>(hi, hs, low_h, fr_h);
    team_update<T>(hi, low_h, m.rate, j);
    int low_l, fr_l;
    team_lookup<T>(row, ls, low_l, fr_l);
    if (hs < m.arows) {
      team_update<T>(row, low_l, m.rate, j);
      st_part<E>(rp, row);
    }
    const bool take = j == (t & (T - 1));
    slot_h = take ? (low_h << 16) | fr_h : slot_h;
    slot_l = take ? (low_l << 16) | fr_l : slot_l;
    if ((t & (T - 1)) == T - 1 || t == K - 1) {
      const int tj = (t & ~(T - 1)) + j;
      if (real && tj <= t) {
        out[size_t(2 * tj) * L] = slot_h;
        out[size_t(2 * tj + 1) * L] = slot_l;
      }
    }
    if constexpr (kShared)
      team_rejoins_after<T>(t, m, b, n, j, buf, hi, start_hi);
  }
}

// ---- L2: backward rANS over a lane's slots and the compaction of its
// stream.  probs [S, L] int32, init [L] (states >= 2^15), streams [L,
// S + 2] int32 zeroed -> streams, lengths [L]
// (rans.stitch(*rans.encode_backward(...))).  K3's chain over a lane's
// row: a CTA holds kCoderN lanes, one chain thread each (its first
// kCoderN threads, warps of their own); the other warps, the helpers,
// flush the chains' words, and every thread stages probs, fills the table
// of reciprocals and moves the streams.  A lane walks its slots
// backwards; slot i of the walk is slot s = S - 1 - i, and the walk runs
// in stages of kCoderD slots, i = j D .. j D + D - 1 in stage j, staged
// by cp.async into a ring of kCoderRing buffers: stage j's barrier
// publishes stages j and j + 1, after it the CTA requests stage j +
// kCoderRing - 1.  A slot below 0 (i >= S, in the last stage) and a dummy
// lane read kIdentity.  The chain takes blocks of kCoderU slots: while
// block b is coded, block b + 2's probs are loaded and block b + 1's
// reciprocals and shifts looked up, so no step waits on shared memory.
// The division by freq is div_magic's reciprocal from a table of all 2^15
// of them, filled while the first stages land, each held as 2m - 2^32
// (m << 1; m >= 2^31), so that umulhi(2x, m) = x + umulhi(x, 2m - 2^32)
// is one multiply-add with no shift before it.  Every slot stores the low
// half of the state at the lane's word count k in a ring of kCoderWords
// words in shared memory, and an emit moves k on: no branch, no device
// store on the chain (a branch around a device store a slot took half of
// the time).  At stage j's barrier the chains publish k (three buffers,
// kpub[j % 3]); until the next barrier the helpers write the words of
// stage j - 1 to the row's end, word k at position M - 1 - k.  After the
// walk, the CTA's warps move each lane's words to positions 2 .. k + 1, a
// warp a lane, kCoderMoveU coalesced batches of 32 words in flight, and
// clear what is left of them past k + 1 (the wrapper hands the rows
// zeroed).
constexpr int kCoderN = 32;         // lanes a CTA (chain threads)
constexpr int kCoderThreads = 256;  // threads a CTA
constexpr int kCoderD = 64;         // slots a stage
constexpr int kCoderRing = 4;       // stage buffers
constexpr int kCoderU = 8;          // slots a block of the chain
constexpr int kCoderMoveU = 16;     // words a thread moves in a batch
// a stage emits at most kCoderD words a lane: the helpers read the last
// stage's while the chain writes the next one's
constexpr int kCoderWords = 128;
// low 0, freq 2^15: a step that changes no state and emits nothing (the
// state stays below 2^31 = 2^15 << 16)
constexpr uint32_t kIdentity = kAnsLow;
constexpr int kCoderRingBytes = kCoderRing * kCoderD * kCoderN * 4;
constexpr int kCoderSmem =
    kCoderRingBytes + kTotal * 4 + (kCoderWords + 3) * kCoderN * 4;
static_assert(kCoderN % 32 == 0 && kCoderN < kCoderThreads,
              "the chains are whole warps, and helpers remain");
static_assert(kCoderD % kCoderU == 0 && kCoderD >= 2 * kCoderU,
              "a block's loads two blocks ahead stay within the next stage");
static_assert(kCoderRing == 4, "two stages published, two in flight");
static_assert((kCoderWords & (kCoderWords - 1)) == 0 &&
                  kCoderWords >= 2 * kCoderD,
              "kCoderWords: 2^n, two stages' words");
static_assert(kCoderSmem <= kSmemMax, "L2's ring and table fit a CTA");

// The CTA requests stage j of its lanes (from lane0) into its ring buffer:
// where the CTA's kCoderN lanes are all real (L >= kCoderN), 16-byte
// copies of a slot's contiguous probs; else (one CTA, rows under
// kCoderN x 4 bytes) one int a thread.
__device__ __forceinline__ void lane_coder_stage(int* ring,
                                                 const int* __restrict__ probs,
                                                 int j, int S, int L,
                                                 int lane0) {
  constexpr int N = kCoderN;
  int* buf = ring + (j % kCoderRing) * kCoderD * N;
  const long long top = (long long)S - 1 - (long long)j * kCoderD;
  if (L >= N) {
    constexpr int kPer = N / 4;  // copies a slot
    for (int q = threadIdx.x; q < kCoderD * kPer; q += kCoderThreads) {
      const int i = q / kPer, part = (q % kPer) * 4;
      const long long s = top - i;
      int* dst = buf + i * N + part;
      if (s >= 0)
        cp_async16(dst, probs + size_t(s) * L + lane0 + part);
      else
        *reinterpret_cast<int4*>(dst) =
            make_int4(kIdentity, kIdentity, kIdentity, kIdentity);
    }
  } else {
    for (int q = threadIdx.x; q < kCoderD * N; q += kCoderThreads) {
      const int i = q / N, n = q % N;
      const long long s = top - i;
      buf[q] = s >= 0 && n < L ? probs[size_t(s) * L + n] : int(kIdentity);
    }
  }
}

// Block b's probs of this lane (slot i = b U + u at ring slot i mod the
// ring's kCoderRing D slots).
__device__ __forceinline__ void coder_block(const int* rp, int b,
                                            uint32_t (&p)[kCoderU]) {
#pragma unroll
  for (int u = 0; u < kCoderU; ++u)
    p[u] = uint32_t(
        rp[((b * kCoderU + u) & (kCoderRing * kCoderD - 1)) * kCoderN]);
}

// Their reciprocals and shifts (div_magic of freq, the table at
// (freq - 1) mod 2^15: a freq outside [1, 2^15] gives a wrong word, never
// a read outside the table).
__device__ __forceinline__ void coder_recip(const uint32_t* mtab,
                                            const uint32_t (&p)[kCoderU],
                                            uint32_t (&m)[kCoderU],
                                            uint32_t (&sh)[kCoderU]) {
#pragma unroll
  for (int u = 0; u < kCoderU; ++u) {
    m[u] = mtab[(p[u] - 1) & (kTotal - 1)];
    sh[u] = 32 - __clz((p[u] & 0xFFFFu) - 1);
  }
}

// The helpers (warps from kCoderN / 32 on) write each real lane's words
// from .. to - 1 of the word ring to the row's end, a warp a lane.
__device__ __forceinline__ void coder_flush(const int* words,
                                            const int* from, const int* to,
                                            int* __restrict__ streams,
                                            size_t M, int lane0, int L) {
  constexpr int kHelpers = (kCoderThreads - kCoderN) / 32;
  const int h = (threadIdx.x - kCoderN) >> 5, wl = threadIdx.x & 31;
  for (int c = h; c < kCoderN && lane0 + c < L; c += kHelpers) {
    int* end = streams + size_t(lane0 + c) * M + M - 1;
    for (int i = from[c] + wl; i < to[c]; i += 32)
      end[-i] = words[(i & (kCoderWords - 1)) * kCoderN + c];
  }
}

__global__ void __launch_bounds__(kCoderThreads, 1)
lane_coder_kernel(const int* __restrict__ probs, const int* __restrict__ init,
                  int* __restrict__ streams, int* __restrict__ lengths, int S,
                  int L) {
  constexpr int N = kCoderN, U = kCoderU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* ring = reinterpret_cast<int*>(smem_raw);  // [kCoderRing][D][N]
  // 2m - 2^32 of div_magic's m for freq = 1 .. 2^15, at freq - 1
  uint32_t* mtab = reinterpret_cast<uint32_t*>(smem_raw + kCoderRingBytes);
  int* words = reinterpret_cast<int*>(mtab + kTotal);  // [kCoderWords][N]
  int* kpub = words + kCoderWords * N;  // [3][N]: k at stage j's barrier
  const int lane0 = blockIdx.x * N, n = threadIdx.x;
  const bool chain = n < N;
  const int l = lane0 + n;
  const bool real = chain && l < L;
  const int stages = (S + kCoderD - 1) / kCoderD;
  const int blocks = (S + U - 1) / U;
  const size_t M = size_t(S) + 2;
#pragma unroll
  for (int k = 0; k < kCoderRing - 1; ++k) {
    if (k < stages) lane_coder_stage(ring, probs, k, S, L, lane0);
    cp_async_commit();
  }
  for (int f = threadIdx.x; f < kTotal; f += kCoderThreads) {
    uint32_t m, sh;
    div_magic(uint32_t(f + 1), m, sh);
    mtab[f] = m << 1;
  }
  uint32_t state = real ? uint32_t(init[l]) : kAnsLow;
  int k = 0;  // words emitted so far; the next one goes to word k
  if (chain) kpub[2 * N + n] = 0;  // "stage -1"
  int* wr = words + (chain ? n : 0);
  const int* rp = ring + (chain ? n : 0);
  // blocks b (p0, m0, sh0), b + 1 (p1, m1, sh1) and b + 2 (p2)
  uint32_t p0[U], p1[U], p2[U], m0[U], m1[U], sh0[U], sh1[U];
  for (int j = 0; j < stages; ++j) {
    if (chain) kpub[(j % 3) * N + n] = k;
    // this thread's copies of stages j and j + 1 are complete, the barrier
    // publishes everyone's (and the table, at the first) and frees the
    // buffer of stage j - 1 for stage j + kCoderRing - 1
    cp_async_wait<kCoderRing - 3>();
    __syncthreads();
    if (j + kCoderRing - 1 < stages)
      lane_coder_stage(ring, probs, j + kCoderRing - 1, S, L, lane0);
    cp_async_commit();
    if (!chain) {  // stage j - 1's words
      coder_flush(words, kpub + ((j + 2) % 3) * N, kpub + (j % 3) * N,
                  streams, M, lane0, L);
      continue;
    }
    const int b0 = j * (kCoderD / U);
    if (j == 0) {
      coder_block(rp, 0, p0);
      coder_block(rp, 1, p1);
      coder_recip(mtab, p0, m0, sh0);
    }
    const int b1 = min(b0 + kCoderD / U, blocks);
    for (int b = b0; b < b1; ++b) {
      coder_block(rp, b + 2, p2);
      coder_recip(mtab, p1, m1, sh1);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t pr = p0[u], freq = pr & 0xFFFFu;
        const bool e = state >= (pr << 16);  // freq << 16
        wr[(k & (kCoderWords - 1)) * N] = int(state & 0xFFFFu);
        k += e ? 1 : 0;
        const uint32_t x = e ? state >> 16 : state;
        const uint32_t q = (__umulhi(x, m0[u]) + x) >> sh0[u];  // x / freq
        // (q << 15) + (x - q * freq) + low
        state = x + (pr >> 16) + q * (kTotal - freq);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p0[u] = p1[u];
        p1[u] = p2[u];
        m0[u] = m1[u];
        sh0[u] = sh1[u];
      }
    }
  }
  const int* kept = kpub + (stages % 3) * N;  // words of each lane
  if (chain) kpub[(stages % 3) * N + n] = k;
  cp_async_wait<0>();
  __syncthreads();
  if (!chain)  // the last stage's words
    coder_flush(words, kpub + ((stages + 2) % 3) * N, kept, streams, M,
                lane0, L);
  if (real) {
    int* row = streams + size_t(l) * M;
    row[0] = int(state >> 16);
    row[1] = int(state & 0xFFFFu);
    lengths[l] = k + 2;
  }
  __syncthreads();  // every word at its row's end
  // words M - k .. M - 1 (decode order) to 2 .. k + 1, a batch of
  // kCoderMoveU x 32 at a time, each batch read whole before it is
  // written: the move reads ahead of what it writes (M - k >= 2), so a
  // batch writes no word a later batch reads
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int c = warp; c < N; c += kCoderThreads / 32) {
    const int kc = kept[c];
    if (kc == 0) continue;  // also a dummy lane
    int* row = streams + size_t(lane0 + c) * M;
    const int* src = row + (M - kc);
    for (int i0 = 0; i0 < kc; i0 += 32 * kCoderMoveU) {
      int v[kCoderMoveU];
#pragma unroll
      for (int u = 0; u < kCoderMoveU; ++u) {
        const int i = i0 + u * 32 + wl;
        v[u] = i < kc ? src[i] : 0;
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kCoderMoveU; ++u) {
        const int i = i0 + u * 32 + wl;
        if (i < kc) row[2 + i] = v[u];
      }
    }
    __syncwarp();  // every word read before the clear
    for (size_t p = max(size_t(kc) + 2, M - kc) + wl; p < M; p += 32)
      row[p] = 0;
  }
}

// L3's reader, the same words spread over the team: word p of the lane
// sits in team thread p % T, in `cur` for the chunk of T words that holds
// pos and in `nxt` for the chunk after it, which the team loads (one
// 2T-byte span) a chunk ahead; the word at pos is shuffled out of cur
// after every renorm step, so a renorm takes it from a register.
struct TeamWords {
  const uint16_t* src;  // the lane's first word
  int n, pos;           // words readable; next position
  uint32_t cur, nxt;    // this thread's word of pos's chunk and the next
  uint32_t next;        // the word at pos
};

template <int T>
__device__ __forceinline__ void team_words_init(
    TeamWords& w, const uint16_t* words, const long long* off, const int* len,
    long long W, int M, int l, bool real, int j, uint32_t& state) {
  const long long o = real ? off[l] : -1;
  long long n = o >= 0 && o < W ? min((long long)min(len[l], M), W - o) : 0;
  w.n = int(max(n, 0LL));
  w.src = words + (w.n ? o : 0);
  w.cur = j < w.n ? uint32_t(w.src[j]) : 0u;
  w.nxt = T + j < w.n ? uint32_t(w.src[T + j]) : 0u;
  const uint32_t hi = __shfl_sync(kFull, w.cur, 0, T);
  const uint32_t lo = __shfl_sync(kFull, w.cur, 1, T);
  state = real ? (hi << 16) | lo : kAnsLow;
  w.pos = 2;
  w.next = __shfl_sync(kFull, w.cur, 2, T);
}

template <int T>
__device__ __forceinline__ void team_words_renorm(TeamWords& w,
                                                  uint32_t& state, int j) {
  const bool take = state < kAnsLow;
  state = take ? (state << 16) | w.next : state;
  w.pos += take ? 1 : 0;
  if (take && (w.pos & (T - 1)) == 0) {  // into the next chunk
    w.cur = w.nxt;
    const int p = w.pos + T + j;
    w.nxt = p < w.n ? uint32_t(w.src[p]) : 0u;
  }
  w.next = __shfl_sync(kFull, w.cur, w.pos & (T - 1), T);
}

// ---- L3: the decode of L1's model.  Lane streams (words, off, len; M =
// 2K + 2) -> bytes [K, L] u8 (rans_cdf_s8.decode_device;
// rans_cdf_o0.decode_device at share 1 and one segment).  The lo row of
// the hi symbol is read as soon as the hi search gives it, beside the
// lookup's shuffles; the stream words come from TeamWords.  Thread j keeps
// the byte of step t0 + j of each chunk of T steps, and the team stores a
// chunk's bytes at its last step.  kShared: share > 1 (the re-joins).
template <int T, bool kShared>
__global__ void __launch_bounds__(T * 128 < kMaxThreads ? T * 128
                                                     : kMaxThreads, 1)
lane_decode_kernel(const uint16_t* __restrict__ words,
                   const long long* __restrict__ off,
                   const int* __restrict__ len,
                   const int* __restrict__ hi_tbl,
                   const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
                   int K, int L, long long W, int n_seg, Span m) {
  constexpr int E = 16 / T;
  const TeamRows b = team_rows<T>(m);
  const int n = threadIdx.x / T, j = threadIdx.x % T;
  const int l = blockIdx.x * b.lanes + n;
  const bool real = l < L;
  const unsigned mask = team_mask<T>();
  int hi[E], start_hi[E];
  team_tables<T>(hi_tbl, lo_tbl, L, n_seg, l, n, j, m, b, hi, start_hi);
  TeamWords w;
  uint32_t state;
  team_words_init<T>(w, words, off, len, W, 2 * K + 2, l, real, j, state);
  uint8_t* dst = out + (real ? l : 0);
  uint8_t mine = 0;  // the byte of step t0 + j of the chunk t0
  int buf = 0;       // red's buffer for the next set sum across warps
  for (int t = 0; t < K; ++t) {
    uint32_t value = state & (kTotal - 1);
    const int hs = team_search<T>(hi, int(value), j, mask);
    uint16_t* rp = team_row<T>(b.lo, b.lanes, hs, n, j);
    int row[E];
    ld_part<E>(rp, row);
    int low_h, fr_h;
    team_lookup<T>(hi, hs, low_h, fr_h);
    state = uint32_t(fr_h) * (state >> 15) + value - uint32_t(low_h);
    team_words_renorm<T>(w, state, j);
    team_update<T>(hi, low_h, m.rate, j);
    value = state & (kTotal - 1);
    const int ls = team_search<T>(row, int(value), j, mask);
    int low_l, fr_l;
    team_lookup<T>(row, ls, low_l, fr_l);
    state = uint32_t(fr_l) * (state >> 15) + value - uint32_t(low_l);
    team_words_renorm<T>(w, state, j);
    if (hs < m.arows) {
      team_update<T>(row, low_l, m.rate, j);
      st_part<E>(rp, row);
    }
    if (j == (t & (T - 1))) mine = uint8_t((hs << 4) | ls);
    if ((t & (T - 1)) == T - 1 || t == K - 1) {
      const int tj = (t & ~(T - 1)) + j;
      if (real && tj <= t) dst[size_t(tj) * L] = mine;
    }
    if constexpr (kShared)
      team_rejoins_after<T>(t, m, b, n, j, buf, hi, start_hi);
  }
}

// ---- L4: static-CDF byte decode.  Lane streams (words, off, len; M =
// 2K + 2), cdf [257] int32 (non-decreasing, cdf[0] = 0, cdf[256] = 2^15)
// -> bytes [K, L] u8 (rans_static.decode_device).  A team of kStaticTeam
// threads a lane, kStaticThreads a CTA, each thread carrying the lane's
// state.  A byte's step reads one entry by its value v = state mod 2^15,
// ent[v] = (freq << 16) | (v - low) of v's symbol, so that state' = freq
// (state >> 15) + (v - low) is one multiply-add after the load; sym_of[v],
// the symbol, is read beside it.  The steps run in chunks of T: team
// thread j keeps the byte of step j of a chunk and the team stores the
// chunk's T bytes at its end, and the lane's words (StaticWords, L3's
// layout held three chunks deep) move along once a chunk, so the steps
// hold no branch.  Both tables are built in shared memory by every CTA
// (160 KB): warp w walks its run of values 32 at a time, lane j from
// value w R + j after one search of the CDF, moving its symbol up to the
// last i with cdf[i] <= v (at most 255 moves a thread), so the entries
// equal searchsorted(cdf, v, side="right") - 1 for a non-decreasing CDF
// and, for any other [257] ints, stay a symbol in [0, 255]: every read of
// cdf, of the tables and of the streams stays inside them.
constexpr int kStaticTeam = 16;      // threads a lane
constexpr int kStaticThreads = 128;  // threads a CTA
constexpr int kStaticLanes = kStaticThreads / kStaticTeam;
constexpr int kStaticRun = kTotal / (kStaticThreads / 32);  // values a warp
constexpr int kStaticSmem = kTotal * 4 + kTotal + 257 * 4;
static_assert(kStaticTeam == 4 || kStaticTeam == 8 || kStaticTeam == 16,
              "kStaticTeam: 4, 8, 16");
static_assert(kStaticSmem <= kSmemMax, "L4's tables fit a CTA");

// The value-indexed tables of cdf c (in shared memory).
__device__ __forceinline__ void static_tables(const int* c, uint32_t* ent,
                                              uint8_t* sym_of) {
  const int warp = threadIdx.x >> 5;
  int v = warp * kStaticRun + (threadIdx.x & 31);
  // the last i in [0, 256) with c[i] <= v, by 8 halvings
  int lo = 0, hi = 256;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int mid = (lo + hi) >> 1;
    if (c[mid] <= v) lo = mid; else hi = mid;
  }
  int sym = lo, low = c[lo], nx = c[lo + 1];
  for (int i = 0; i < kStaticRun / 32; ++i, v += 32) {
    while (sym < 255 && nx <= v) {
      ++sym;
      low = nx;
      nx = c[sym + 1];
    }
    ent[v] = (uint32_t(nx - low) << 16) | uint32_t(v - low);
    sym_of[v] = uint8_t(sym);
  }
}

// L4's reader: TeamWords' layout (word p of the lane in team thread p %
// T, 0 at or past n), three chunks held: cur (chunk c, which holds pos at
// a chunk of steps' start), nxt (c + 1) and far (c + 2, requested a chunk
// of steps before it is needed).  In a chunk of T steps pos moves at most
// T, so it stays below edge + T (edge = (c + 1) T): the word at pos is
// shuffled out of cur or nxt after every step, and at the chunk's end the
// chunks move along where pos passed edge, by selects.
struct StaticWords {
  const uint16_t* src;  // the lane's first word
  int n, pos, edge;     // words readable; next position; (c + 1) T
  uint32_t cur, nxt, far, next;
};

template <int T>
__device__ __forceinline__ void static_words_init(
    StaticWords& w, const uint16_t* words, const long long* off,
    const int* len, long long W, int M, int l, bool real, int j,
    uint32_t& state) {
  const long long o = real ? off[l] : -1;
  long long n = o >= 0 && o < W ? min((long long)min(len[l], M), W - o) : 0;
  w.n = int(max(n, 0LL));
  w.src = words + (w.n ? o : 0);
  w.cur = j < w.n ? uint32_t(w.src[j]) : 0u;
  w.nxt = T + j < w.n ? uint32_t(w.src[T + j]) : 0u;
  w.far = 2 * T + j < w.n ? uint32_t(w.src[2 * T + j]) : 0u;
  const uint32_t hi = __shfl_sync(kFull, w.cur, 0, T);
  const uint32_t lo = __shfl_sync(kFull, w.cur, 1, T);
  state = real ? (hi << 16) | lo : kAnsLow;
  w.pos = 2;
  w.edge = T;
  w.next = __shfl_sync(kFull, w.cur, 2, T);
}

// One byte: its symbol, the state step and the renorm.
template <int T>
__device__ __forceinline__ uint8_t static_step(uint32_t& state,
                                               StaticWords& w,
                                               const uint32_t* ent,
                                               const uint8_t* sym_of) {
  const uint32_t value = state & (kTotal - 1);
  const uint32_t e = ent[value];
  const uint8_t sym = sym_of[value];
  state = (e >> 16) * (state >> 15) + (e & 0xFFFFu);
  const bool take = state < kAnsLow;
  state = take ? (state << 16) | w.next : state;
  w.pos += take ? 1 : 0;
  w.next = __shfl_sync(kFull, w.pos < w.edge ? w.cur : w.nxt,
                       w.pos & (T - 1), T);
  return sym;
}

template <int T>
__device__ __forceinline__ void static_words_chunk(StaticWords& w, int j) {
  const bool past = w.pos >= w.edge;
  w.cur = past ? w.nxt : w.cur;
  w.nxt = past ? w.far : w.nxt;
  w.edge += past ? T : 0;
  const int p = w.edge + T + j;  // this thread's word of chunk c + 2
  w.far = p < w.n ? uint32_t(w.src[p]) : 0u;
}

__global__ void __launch_bounds__(kStaticThreads, 1)
lane_static_decode_kernel(const uint16_t* __restrict__ words,
                          const long long* __restrict__ off,
                          const int* __restrict__ len,
                          const int* __restrict__ cdf,
                          uint8_t* __restrict__ out, int K, int L,
                          long long W) {
  constexpr int T = kStaticTeam;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* ent = reinterpret_cast<uint32_t*>(smem_raw);
  uint8_t* sym_of = smem_raw + kTotal * 4;
  int* c = reinterpret_cast<int*>(smem_raw + kTotal * 5);
  const int n = threadIdx.x / T, j = threadIdx.x % T;
  const int l = blockIdx.x * kStaticLanes + n;
  const bool real = l < L;
  for (int i = threadIdx.x; i < 257; i += kStaticThreads) c[i] = cdf[i];
  __syncthreads();
  static_tables(c, ent, sym_of);
  StaticWords w;
  uint32_t state;
  static_words_init<T>(w, words, off, len, W, 2 * K + 2, l, real, j, state);
  __syncthreads();
  uint8_t* dst = out + (real ? l : 0) + size_t(j) * L;
  const int full = K - K % T;
  for (int t0 = 0; t0 < full; t0 += T) {
    uint8_t mine = 0;  // the byte of step t0 + j
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const uint8_t sym = static_step<T>(state, w, ent, sym_of);
      mine = j == u ? sym : mine;
    }
    static_words_chunk<T>(w, j);
    if (real) dst[size_t(t0) * L] = mine;
  }
  uint8_t mine = 0;  // the last K % T steps
  for (int t = full; t < K; ++t) {
    const uint8_t sym = static_step<T>(state, w, ent, sym_of);
    mine = j == t - full ? sym : mine;
  }
  if (real && full + j < K) dst[size_t(full) * L] = mine;
}

// ---- L5-L8: the order-1 per-lane scan codecs, rans-cdf-r1 (id 59) and
// rans-cdf-o1 (id 64).  A lane codes a contiguous span of K bytes, each
// byte's hi nibble from the hi row of its context and its lo nibble from
// the lo row of (context, hi nibble), both CDF16 rows adapted at rate 7;
// the context is the lane's previous byte, 0 before its first.  The JAX
// package runs both as lax.scans (turborc_tpu/codecs/rans_cdf_r1.py,
// rans_cdf_o1.py).  Their model passes L5 / L7 (bytes -> slot probs, which
// L2 codes) and their decodes L6 / L8 are one kernel template each over
// the context C:
//   O1Rank  id 59: 64 hi rows hictx(prev) and 48 lo rows locx(prev, hi) of
//           the rank-remapped bytes, started from the warm tables of the
//           lane's segment l n_seg / L (any n_seg in [1, L]: a segment's
//           lanes need not fill whole CTAs)
//   O1Byte  id 64: 256 hi rows prev and 4,096 lo rows prev 16 + hi,
//           started from cdf16.init
// L1's team of T = kTeam threads a lane, one entry a thread, with every
// row of the lane in shared memory as u16 (entries stay in [0, 2^15), see
// cdf_update): id 59's 112 rows are 3,584 B a lane, C::kLanes = 8 lanes a
// CTA of 128 threads; id 64's 4,352 rows are 139,264 B, so a CTA holds one
// lane and, to keep its warp whole for the team's shuffles and ballots,
// a team on dummy data whose every row is a 16-entry scratch row of its
// own (stride 0).  Row r of lane n lies at (r N + n) 16, N = C::kLanes,
// the hi rows first.  A step reads the lane's hi row, then its lo row (as
// soon as the hi nibble is known), and writes each back after its update;
// a thread touches only its own entries, so a step needs no barrier.  The
// bytes and probs (L5, L7) and the stream words (L6, L8) move as in L1
// and L3.
constexpr int kO1Rate = 7;  // cdf16.CDFRATE: ids 59 and 64 take no rate

struct O1Rank {
  static constexpr int kHiRows = 64, kLoRows = 48, kLanes = 8;
  static constexpr bool kWarm = true;  // warm tables per segment
  static constexpr int kLin = kHiRows - 8;  // exact ranks below it
  // ranks < kLin exact, log2 buckets above
  __device__ static int hi_row(int prev) {
    return prev < kLin ? prev
                       : kLin + min(32 - __clz(prev - (kLin - 1)), 7);
  }
  // the match plane where prev's hi nibble is hs, else prev's rank or hs
  __device__ static int lo_row(int prev, int hs) {
    return (prev >> 4) == hs ? 32 + (prev & 15)
                             : (hs == 0 ? min(prev, 15) : 16 + hs);
  }
};

struct O1Byte {
  static constexpr int kHiRows = 256, kLoRows = 4096, kLanes = 1;
  static constexpr bool kWarm = false;  // cdf16.init
  __device__ static int hi_row(int prev) { return prev; }
  __device__ static int lo_row(int prev, int hs) { return prev * 16 + hs; }
};

// Threads of a CTA (whole warps), its dummy teams and its shared memory:
// the lanes' rows, then a scratch row a dummy team.
template <class C>
__host__ __device__ constexpr int o1_threads() {
  return C::kLanes * kTeam > 32 ? C::kLanes * kTeam : 32;
}
template <class C>
__host__ __device__ constexpr int o1_dummies() {
  return o1_threads<C>() / kTeam - C::kLanes;
}
template <class C>
__host__ __device__ constexpr int o1_smem() {
  return ((C::kHiRows + C::kLoRows) * C::kLanes + o1_dummies<C>()) * 32;
}
static_assert(o1_smem<O1Byte>() <= kSmemMax, "a lane of id 64 fits a CTA");
static_assert(o1_smem<O1Rank>() <= kSmemMax, "8 lanes of id 59 fit a CTA");

// This team thread's entries of its lane's rows: row r at base + r stride.
struct O1Rows {
  uint16_t* base;
  int stride;
};

template <int T, class C>
__device__ __forceinline__ O1Rows o1_rows(int n, int j) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* rows = reinterpret_cast<uint16_t*>(smem_raw);
  constexpr int kScratch = (C::kHiRows + C::kLoRows) * C::kLanes * 16;
  O1Rows r;
  r.base = (n < C::kLanes ? rows + n * 16
                          : rows + kScratch + (n - C::kLanes) * 16) +
           j * (16 / T);
  r.stride = n < C::kLanes ? C::kLanes * 16 : 0;
  return r;
}

// The lanes' start rows.  id 59: its segment's warm tables (a dummy lane
// takes segment 0), each thread its own entries.  id 64: cdf16.init,
// entry i = i << 11, filled by the CTA.  Then a barrier.
template <int T, class C>
__device__ __forceinline__ void o1_start(const int* __restrict__ hi_tbl,
                                         const int* __restrict__ lo_tbl,
                                         int L, int n_seg, int l, bool real,
                                         const O1Rows& r, int j) {
  constexpr int E = 16 / T;
  if constexpr (C::kWarm) {
    const int seg = real ? int((long long)l * n_seg / L) : 0;
    for (int h = 0; h < C::kHiRows + C::kLoRows; ++h) {
      const int* src =
          h < C::kHiRows ? hi_tbl + (seg * C::kHiRows + h) * 16
                         : lo_tbl + (seg * C::kLoRows + h - C::kHiRows) * 16;
      int v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = src[j * E + e];
      st_part<E>(r.base + h * r.stride, v);
    }
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint32_t* w = reinterpret_cast<uint32_t*>(smem_raw);
    for (int i = threadIdx.x; i < o1_smem<C>() / 4; i += blockDim.x) {
      const uint32_t e = (2u * i) & 15u;  // entry of the low half
      w[i] = e * (kTotal / 16) | (e + 1u) * (kTotal / 16) << 16;
    }
  }
  __syncthreads();
}

// ---- L5 (C = O1Rank) and L7 (O1Byte): the model over known bytes.
// cols [K, L] u8 -> probs [2K, L] int32 (rans_cdf_r1.model_pass; the model
// half of rans_cdf_o1.encode_device).  Both rows of a byte are read at
// once: its hi nibble is known.
template <int T, class C>
__global__ void __launch_bounds__(o1_threads<C>(), 1)
lane_o1_model_kernel(const uint8_t* __restrict__ cols,
                     const int* __restrict__ hi_tbl,
                     const int* __restrict__ lo_tbl,
                     int* __restrict__ probs, int K, int L, int n_seg) {
  constexpr int E = 16 / T;
  const int n = threadIdx.x / T, j = threadIdx.x % T;
  const int l = blockIdx.x * C::kLanes + n;
  const bool real = n < C::kLanes && l < L;
  const O1Rows r = o1_rows<T, C>(n, j);
  o1_start<T, C>(hi_tbl, lo_tbl, L, n_seg, l, real, r, j);
  // L1's chunks of T bytes and of their probs
  const uint8_t* src = cols + (real ? l : 0) + size_t(j) * L;
  int* out = probs + (real ? l : 0);
  int cur = real && j < K ? src[0] : 0;
  int nxt = real && T + j < K ? src[size_t(T) * L] : 0;
  int sym_next = __shfl_sync(kFull, cur, 0, T);
  int prev = 0, slot_h = 0, slot_l = 0;
  for (int t = 0; t < K; ++t) {
    const int sym = sym_next;
    if ((t & (T - 1)) == T - 1) {
      cur = nxt;
      nxt = real && t + 1 + T + j < K ? src[size_t(t + 1 + T) * L] : 0;
    }
    sym_next = __shfl_sync(kFull, cur, (t + 1) & (T - 1), T);
    const int hs = sym >> 4, ls = sym & 15;
    uint16_t* hp = r.base + C::hi_row(prev) * r.stride;
    uint16_t* lp = r.base + (C::kHiRows + C::lo_row(prev, hs)) * r.stride;
    int hrow[E], lrow[E];
    ld_part<E>(hp, hrow);
    ld_part<E>(lp, lrow);
    int low_h, fr_h, low_l, fr_l;
    team_lookup<T>(hrow, hs, low_h, fr_h);
    team_lookup<T>(lrow, ls, low_l, fr_l);
    team_update<T>(hrow, low_h, kO1Rate, j);
    team_update<T>(lrow, low_l, kO1Rate, j);
    st_part<E>(hp, hrow);
    st_part<E>(lp, lrow);
    prev = sym;
    const bool take = j == (t & (T - 1));
    slot_h = take ? (low_h << 16) | fr_h : slot_h;
    slot_l = take ? (low_l << 16) | fr_l : slot_l;
    if ((t & (T - 1)) == T - 1 || t == K - 1) {
      const int tj = (t & ~(T - 1)) + j;
      if (real && tj <= t) {
        out[(size_t(2) * tj) * L] = slot_h;
        out[(size_t(2) * tj + 1) * L] = slot_l;
      }
    }
  }
}

// ---- L6 (C = O1Rank) and L8 (O1Byte): the decode.  Lane streams (words,
// off, len; M = 2K + 2) -> bytes [K, L] u8 (rans_cdf_r1.decode_device,
// rans_cdf_o1.decode_device).  The lo row is read as soon as the hi
// search gives it, beside the hi lookup; the stream words come from
// TeamWords, and the bytes are stored as L3 stores them.
template <int T, class C>
__global__ void __launch_bounds__(o1_threads<C>(), 1)
lane_o1_decode_kernel(const uint16_t* __restrict__ words,
                      const long long* __restrict__ off,
                      const int* __restrict__ len,
                      const int* __restrict__ hi_tbl,
                      const int* __restrict__ lo_tbl,
                      uint8_t* __restrict__ out, int K, int L, long long W,
                      int n_seg) {
  constexpr int E = 16 / T;
  const int n = threadIdx.x / T, j = threadIdx.x % T;
  const int l = blockIdx.x * C::kLanes + n;
  const bool real = n < C::kLanes && l < L;
  const unsigned mask = team_mask<T>();
  const O1Rows r = o1_rows<T, C>(n, j);
  o1_start<T, C>(hi_tbl, lo_tbl, L, n_seg, l, real, r, j);
  TeamWords w;
  uint32_t state;
  team_words_init<T>(w, words, off, len, W, 2 * K + 2, l, real, j, state);
  uint8_t* dst = out + (real ? l : 0);
  uint8_t mine = 0;  // the byte of step t0 + j of the chunk t0
  int prev = 0;
  for (int t = 0; t < K; ++t) {
    uint16_t* hp = r.base + C::hi_row(prev) * r.stride;
    int hrow[E], lrow[E];
    ld_part<E>(hp, hrow);
    uint32_t value = state & (kTotal - 1);
    const int hs = team_search<T>(hrow, int(value), j, mask);
    uint16_t* lp = r.base + (C::kHiRows + C::lo_row(prev, hs)) * r.stride;
    ld_part<E>(lp, lrow);
    int low_h, fr_h;
    team_lookup<T>(hrow, hs, low_h, fr_h);
    state = uint32_t(fr_h) * (state >> 15) + value - uint32_t(low_h);
    team_words_renorm<T>(w, state, j);
    team_update<T>(hrow, low_h, kO1Rate, j);
    st_part<E>(hp, hrow);
    value = state & (kTotal - 1);
    const int ls = team_search<T>(lrow, int(value), j, mask);
    int low_l, fr_l;
    team_lookup<T>(lrow, ls, low_l, fr_l);
    state = uint32_t(fr_l) * (state >> 15) + value - uint32_t(low_l);
    team_words_renorm<T>(w, state, j);
    team_update<T>(lrow, low_l, kO1Rate, j);
    st_part<E>(lp, lrow);
    prev = (hs << 4) | ls;
    if (j == (t & (T - 1))) mine = uint8_t(prev);
    if ((t & (T - 1)) == T - 1 || t == K - 1) {
      const int tj = (t & ~(T - 1)) + j;
      if (real && tj <= t) dst[size_t(tj) * L] = mine;
    }
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

// Lets `kernel` take `smem` bytes of dynamic shared memory (past 48 KB).
template <class F>
int allow_smem(F kernel, int smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The launch of a team kernel: threads, shared memory and CTAs for L
// lanes at T threads a lane.
struct TeamLaunch {
  int threads, smem, grid;
};

TeamLaunch team_launch(const Span& m, int L, int T) {
  TeamLaunch g;
  g.threads = m.share * T > kCtaMin ? m.share * T : kCtaMin;
  g.smem = team_smem(m, g.threads, T);
  const int lanes = g.threads / T;
  g.grid = (L + lanes - 1) / lanes;
  return g;
}

// Calls launch(std::integral_constant<int, T>, std::bool_constant<share >
// 1>) with the team size T of span m: kTeam, or kTeam / 2 where kTeam *
// share > kMaxThreads.  At share 1 the kernels hold no re-join code.
template <class F>
int team_dispatch(const Span& m, F launch) {
  if constexpr (kTeam * 128 > kMaxThreads) {
    if (kTeam * m.share > kMaxThreads)
      return launch(std::integral_constant<int, kTeam / 2>(),
                    std::true_type());
  }
  if (m.share == 1)
    return launch(std::integral_constant<int, kTeam>(), std::false_type());
  return launch(std::integral_constant<int, kTeam>(), std::true_type());
}

// The launches of L5-L8: C::kLanes lanes a CTA of o1_threads<C>() threads,
// the rows in o1_smem<C>() bytes of shared memory.  id 59 takes n_seg
// warm-table segments, 1 to L; id 64 none.
template <class C>
bool o1_fits(int K, int L, int n_seg) {
  return K >= 0 && pow2(L, 1 << 30) &&
         (!C::kWarm || (n_seg >= 1 && n_seg <= L)) &&
         size_t(2) * size_t(K) * size_t(L) <= size_t(1) << 40;
}

template <class C>
int o1_model_launch(const uint8_t* cols, const int* hi_tbl, const int* lo_tbl,
                    int* probs, int K, int L, int n_seg,
                    cudaStream_t stream) {
  if (!o1_fits<C>(K, L, n_seg)) return int(cudaErrorInvalidValue);
  if (const int e = allow_smem(lane_o1_model_kernel<kTeam, C>, o1_smem<C>()))
    return e;
  lane_o1_model_kernel<kTeam, C>
      <<<(L + C::kLanes - 1) / C::kLanes, o1_threads<C>(), o1_smem<C>(),
         stream>>>(cols, hi_tbl, lo_tbl, probs, K, L, n_seg);
  return int(cudaGetLastError());
}

template <class C>
int o1_decode_launch(const uint16_t* words, const long long* off,
                     const int* len, const int* hi_tbl, const int* lo_tbl,
                     uint8_t* out, int K, int L, int W, int n_seg,
                     cudaStream_t stream) {
  if (!o1_fits<C>(K, L, n_seg) || K > (INT_MAX - 2) / 2 || W < 0)
    return int(cudaErrorInvalidValue);
  if (const int e = allow_smem(lane_o1_decode_kernel<kTeam, C>, o1_smem<C>()))
    return e;
  lane_o1_decode_kernel<kTeam, C>
      <<<(L + C::kLanes - 1) / C::kLanes, o1_threads<C>(), o1_smem<C>(),
         stream>>>(words, off, len, hi_tbl, lo_tbl, out, K, L, W, n_seg);
  return int(cudaGetLastError());
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
  return team_dispatch(m, [&](auto team, auto shared) {
    constexpr int T = decltype(team)::value;
    constexpr bool S = decltype(shared)::value;
    const TeamLaunch g = team_launch(m, L, T);
    if (const int e = allow_smem(lane_model_kernel<T, S>, g.smem)) return e;
    lane_model_kernel<T, S><<<g.grid, g.threads, g.smem, stream>>>(
        cols, hi_tbl, lo_tbl, probs, K, L, n_seg, m);
    return int(cudaGetLastError());
  });
}

// L2.
int trc_lane_coder(const int* probs, const int* init, int* streams,
                   int* lengths, int S, int L, cudaStream_t stream) {
  if (S < 0 || S > INT_MAX - 2 * kCoderD || !pow2(L, 1 << 30))
    return int(cudaErrorInvalidValue);
  if (const int e = allow_smem(lane_coder_kernel, kCoderSmem)) return e;
  lane_coder_kernel<<<(L + kCoderN - 1) / kCoderN, kCoderThreads, kCoderSmem,
                      stream>>>(probs, init, streams, lengths, S, L);
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
  return team_dispatch(m, [&](auto team, auto shared) {
    constexpr int T = decltype(team)::value;
    constexpr bool S = decltype(shared)::value;
    const TeamLaunch g = team_launch(m, L, T);
    if (const int e = allow_smem(lane_decode_kernel<T, S>, g.smem)) return e;
    lane_decode_kernel<T, S><<<g.grid, g.threads, g.smem, stream>>>(
        words, off, len, hi_tbl, lo_tbl, out, K, L, W, n_seg, m);
    return int(cudaGetLastError());
  });
}

// L4.
int trc_lane_static_decode(const uint16_t* words, const long long* off,
                           const int* len, const int* cdf, uint8_t* out,
                           int K, int L, int W, cudaStream_t stream) {
  if (K < 0 || K > (INT_MAX - 2) / 2 || W < 0 || !pow2(L, 1 << 30))
    return int(cudaErrorInvalidValue);
  if (const int e = allow_smem(lane_static_decode_kernel, kStaticSmem))
    return e;
  lane_static_decode_kernel<<<(L + kStaticLanes - 1) / kStaticLanes,
                              kStaticThreads, kStaticSmem, stream>>>(
      words, off, len, cdf, out, K, L, W);
  return int(cudaGetLastError());
}

// L5: id 59's model; hi_tbl [n_seg, 64, 16], lo_tbl [n_seg, 48, 16].
int trc_lane_o1r_model(const uint8_t* cols, const int* hi_tbl,
                       const int* lo_tbl, int* probs, int K, int L, int n_seg,
                       cudaStream_t stream) {
  return o1_model_launch<O1Rank>(cols, hi_tbl, lo_tbl, probs, K, L, n_seg,
                                 stream);
}

// L6: id 59's decode, L3's stream arguments and L5's tables.
int trc_lane_o1r_decode(const uint16_t* words, const long long* off,
                        const int* len, const int* hi_tbl, const int* lo_tbl,
                        uint8_t* out, int K, int L, int W, int n_seg,
                        cudaStream_t stream) {
  return o1_decode_launch<O1Rank>(words, off, len, hi_tbl, lo_tbl, out, K, L,
                                  W, n_seg, stream);
}

// L7: id 64's model.
int trc_lane_o1_model(const uint8_t* cols, int* probs, int K, int L,
                      cudaStream_t stream) {
  return o1_model_launch<O1Byte>(cols, nullptr, nullptr, probs, K, L, 1,
                                 stream);
}

// L8: id 64's decode.
int trc_lane_o1_decode(const uint16_t* words, const long long* off,
                       const int* len, uint8_t* out, int K, int L, int W,
                       cudaStream_t stream) {
  return o1_decode_launch<O1Byte>(words, off, len, nullptr, nullptr, out, K,
                                  L, W, 1, stream);
}

}  // extern "C"
