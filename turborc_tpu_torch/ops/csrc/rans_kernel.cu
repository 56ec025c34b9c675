// Flagship rANS kernels (codec rans-cdf-o0-p) for Hopper, sm_90a.
//
// Replaces the five Pallas TPU kernels of
// turborc_tpu/ops/pallas/rans_kernel.py:
//   model_kernel   <- _make_model_kernel  (:807)  forward model pass
//   coder_kernel   <- _make_coder_kernel  (:883)  backward rANS pass
//   place_kernel   <- _make_place_kernel  (:1017) stream compaction
//   decode_kernel  <- _make_decode_kernel (:407)  o0 share-span decode
//   decode_x2_kernel <- _make_decode_kernel_x2 (:569)  split-state decode
//
// Design: one CTA = one 128-lane group = 4 warps, one thread per lane, and a
// loop over byte steps inside the CTA (the TPU grid's sequential dimension).
// Each lane is a serial state machine; lanes of a group are coupled only by
// (a) the lane-order rank of the lanes that read or write a stream word at a
// step (warp ballot + popc, plus a 4-entry shared-memory prefix over the
// warps) and (b) the re-join of `share`-lane model copies (XOR-partner sums:
// warp shuffles for share <= 32, shared memory above).  The TPU's barrel
// gather, register queue, VMEM window, packed-pair lo rows and f32 long
// division are not reproduced: the card has gathers, ballots and integer
// division.  Per-lane lo tables (16 rows x 16 entries, u16) and their re-join
// start copies live in dynamic shared memory: 2 x 64 KB per CTA.
//
// What bounds them on this card: not bytes and not operations.  Each lane is
// a chain of dependent steps (search -> state -> fetch -> update) and one
// block holds only 64 groups = 8192 threads, fewer than half of the 132 SMs
// get a CTA, so the time is the per-step latency times K.  Batching container
// blocks into one launch is the first lever; it is not done here.
//
// Rules kept by every kernel: __syncthreads() only where all 128 threads
// arrive (every condition around one depends on the byte index and the
// geometry, never on data); no loop bound taken from data; every stream read
// is bounds-checked, so a corrupt stream decodes to wrong bytes, never to an
// out-of-bounds access or a hang.  Each C entry point returns
// cudaGetLastError() after its launch.

#include "rans_common.cuh"

namespace {

// Shared-memory layout of the model and decode kernels.
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

// ---- K1: decode.  streams [G, R, 128] int32 (rows 0/1 = initial state
// hi16/lo16, words from 256 in consumption order) -> bytes [K, G, 128] u8,
// final states [G, 128].
__global__ void __launch_bounds__(kLanes)
decode_kernel(const int* __restrict__ streams, const int* __restrict__ hi_tbl,
              const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
              int* __restrict__ fstate, int K, int G, int R, Geo m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int g = blockIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + threadIdx.x;
  const int* s = streams + size_t(g) * R * kLanes;
  const long long limit = (long long)R * kLanes;
  int hi[16], start_hi[16];
  init_tables(hi_tbl, lo_tbl, G, g, m.share, hi, start_hi, sm.lo_s, sm.st_s);
  uint32_t state = (uint32_t(s[threadIdx.x]) << 16) |
                   uint32_t(s[kLanes + threadIdx.x]);
  long long base = 2 * kLanes;
  int buf = 0;

  for (int t = 0; t < K; ++t) {
    uint32_t value = state & (kTotal - 1);
    const int hs = cdf_search(hi, int(value));
    int low_h, fr_h;
    cdf_lookup(hi, hs, low_h, fr_h);
    state = uint32_t(fr_h) * (state >> 15) + value - uint32_t(low_h);
    fetch(state, s, limit, base, sm.wsum, buf);
    cdf_update(hi, low_h, m.rate);

    int row[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) row[i] = sm.lo_s[lo_at(hs, i)];
    value = state & (kTotal - 1);
    const int ls = cdf_search(row, int(value));
    int low_l, fr_l;
    cdf_lookup(row, ls, low_l, fr_l);
    state = uint32_t(fr_l) * (state >> 15) + value - uint32_t(low_l);
    fetch(state, s, limit, base, sm.wsum, buf);
    cdf_update(row, low_l, m.rate);
    if (hs < m.arows) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sm.lo_s[lo_at(hs, i)] = uint16_t(row[i]);
    }
    out[size_t(t) * plane + col] = uint8_t((hs << 4) | ls);
    rejoin_after(t, m, hi, start_hi, sm.lo_s, sm.st_s, sm.red);
  }
  fstate[col] = int(state);
}

// K5's renormalisation of both states: the lanes that need a word in each
// stream set are ranked with one barrier (two ballots, one exchange of the
// per-warp counts), then each takes the next word of its set in lane order,
// as fetch does for one set (rans_common.cuh).  Double-buffered like
// block_rank.
__device__ __forceinline__ void fetch_pair(uint32_t (&state)[2],
                                           const int* const (&s)[2],
                                           long long limit,
                                           long long (&base)[2], int* wsum,
                                           int& buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* ws = wsum + buf * 2 * kWarps;
  unsigned bal[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    bal[k] = __ballot_sync(kFull, state[k] < kAnsLow);
    if (lane == 0) ws[k * kWarps + warp] = __popc(bal[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = ws[k * kWarps + w];
      off += (w < warp) ? c : 0;
      tot += c;
    }
    if (state[k] < kAnsLow) {
      const long long p = base[k] + off + __popc(bal[k] & ((1u << lane) - 1u));
      const uint32_t word = p < limit ? uint32_t(s[k][p]) : 0u;
      state[k] = (state[k] << 16) | word;
    }
    base[k] += tot;
  }
  buf ^= 1;
}

// ---- K5: split-state decode.  streams [2, G, R, 128] int32 (set 0 feeds
// state 0, which decodes hi nibbles; set 1 feeds state 1, lo nibbles; each
// set is laid out as K1's) -> bytes [K, G, 128] u8, final states
// [2, G, 128].  One shared model and re-join, as K1's.  The lo search on
// state 1 needs only the hi symbol, not state 0's fetch, so both states step
// before one fetch_pair.
__global__ void __launch_bounds__(kLanes)
decode_x2_kernel(const int* __restrict__ streams,
                 const int* __restrict__ hi_tbl,
                 const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
                 int* __restrict__ fstate, int K, int G, int R, Geo m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int g = blockIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + threadIdx.x;
  const int* const s[2] = {streams + size_t(g) * R * kLanes,
                           streams + (size_t(G) + g) * R * kLanes};
  const long long limit = (long long)R * kLanes;
  int hi[16], start_hi[16];
  init_tables(hi_tbl, lo_tbl, G, g, m.share, hi, start_hi, sm.lo_s, sm.st_s);
  uint32_t state[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    state[k] = (uint32_t(s[k][threadIdx.x]) << 16) |
               uint32_t(s[k][kLanes + threadIdx.x]);
  long long base[2] = {2 * kLanes, 2 * kLanes};
  int buf = 0;

  for (int t = 0; t < K; ++t) {
    uint32_t value = state[0] & (kTotal - 1);
    const int hs = cdf_search(hi, int(value));
    int low_h, fr_h;
    cdf_lookup(hi, hs, low_h, fr_h);
    state[0] = uint32_t(fr_h) * (state[0] >> 15) + value - uint32_t(low_h);

    int row[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) row[i] = sm.lo_s[lo_at(hs, i)];
    value = state[1] & (kTotal - 1);
    const int ls = cdf_search(row, int(value));
    int low_l, fr_l;
    cdf_lookup(row, ls, low_l, fr_l);
    state[1] = uint32_t(fr_l) * (state[1] >> 15) + value - uint32_t(low_l);
    fetch_pair(state, s, limit, base, sm.wsum, buf);

    cdf_update(hi, low_h, m.rate);
    cdf_update(row, low_l, m.rate);
    if (hs < m.arows) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sm.lo_s[lo_at(hs, i)] = uint16_t(row[i]);
    }
    out[size_t(t) * plane + col] = uint8_t((hs << 4) | ls);
    rejoin_after(t, m, hi, start_hi, sm.lo_s, sm.st_s, sm.red);
  }
  fstate[col] = int(state[0]);
  fstate[plane + col] = int(state[1]);
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
               void* stream) {
  const size_t smem = model_smem_bytes(share);
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  decode_kernel<<<G, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<uint8_t*>(out),
      static_cast<int*>(fstate), K, G, R,
      make_geo(share, sync, lsync, arows, srows, rate));
  return int(cudaGetLastError());
}

int trc_decode_x2(const void* streams, const void* hi_tbl,
                  const void* lo_tbl, void* out, void* fstate, int K, int G,
                  int R, int share, int sync, int lsync, int arows, int srows,
                  int rate, void* stream) {
  const size_t smem = model_smem_bytes(share);
  cudaError_t e = cudaFuncSetAttribute(
      decode_x2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  decode_x2_kernel<<<G, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<uint8_t*>(out),
      static_cast<int*>(fstate), K, G, R,
      make_geo(share, sync, lsync, arows, srows, rate));
  return int(cudaGetLastError());
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
