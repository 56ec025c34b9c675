// Order-1 flagship rANS kernels (codec rans-cdf-r1-p) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of
// turborc_tpu/ops/pallas/rans_o1_kernel.py:
//   o1_model_kernel   <- _make_model_kernel  (:266)  forward model pass
//   o1_decode_kernel  <- _make_decode_kernel (:124)  order-1 decode
// The encode side's backward coder and placement are coder_kernel and
// place_kernel of rans_kernel.cu, unchanged: the stream format is the o0 one.
//
// Model: every lane has its own tables, 64 hi rows keyed by the context of
// the previous byte and 48 lo rows keyed by (previous byte, decoded hi), 16
// CDF16 entries a row; `prev` starts at 0.  There is no cross-lane model
// sharing and no re-join.
//
// Design: the tables are 112 rows x 16 entries per lane, 3.5 KB as u16 and
// 448 KB per 128-lane group, more than a CTA's shared memory.  They live in a
// device scratch buffer that the wrapper allocates, [lane][row][16] u16, and
// each kernel fills it from the warm tables at its start.  A row is one
// 32-byte sector, read and written as two 16-byte vectors by its own lane;
// lanes select different rows, so a lane-contiguous row keeps every sector
// fetched fully used.  At the default 8192 lanes the scratch is 29.4 MB,
// which stays in the 50 MB L2.  Entries fit u16: they stay in [0, 2^15)
// (cdf_update in rans_common.cuh).  The TPU's row-select ladders, write-back
// mask loops, register queue and sliding window are not reproduced: a row is
// indexed, a word is fetched from the stream in device memory.
//
// The model kernel has no cross-lane step, so its CTAs are one warp each and
// spread over all SMs.  The decode kernel keeps one 128-lane group per CTA:
// its fetch ranks the lanes that need a word across the whole group, as K1
// does (rans_common.cuh).
//
// What bounds them on this card: not bytes and not operations.  Each lane is
// a chain of dependent steps (row load -> search -> state -> fetch -> update
// -> row store) whose row loads wait on the L2, so the time is the per-step
// latency times K.  Rules kept: __syncthreads() only inside fetch, reached by
// all 128 threads every step; no loop bound taken from data; every stream
// read is bounds-checked.  Each C entry point returns cudaGetLastError()
// after its launch.

#include "rans_common.cuh"

namespace {

constexpr int kNctx = 64;                 // hi rows
constexpr int kLrows = 48;                // lo rows
constexpr int kLin = kNctx - 8;           // exact-rank hi rows
constexpr int kRows = kNctx + kLrows;     // rows per lane
constexpr int kModelThreads = 32;

// hi context row: prev < 56 exact, else 56 + min(bitlen(prev - 55), 7).
__device__ __forceinline__ int ctx_of(int prev) {
  const int v = max(prev - (kLin - 1), 1);
  const int bl = 32 - __clz(v);
  return prev < kLin ? prev : kLin + min(bl, 7);
}

// lo context row: match plane when prev's hi nibble equals hi.
__device__ __forceinline__ int locx_of(int prev, int hi) {
  if ((prev >> 4) == hi) return 32 + (prev & 15);
  return hi == 0 ? min(prev, 15) : 16 + hi;
}

__device__ __forceinline__ void row_load(const uint16_t* p, int (&c)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 a = q[0], b = q[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[2 * k] = int(w[k] & 0xFFFFu);
    c[2 * k + 1] = int(w[k] >> 16);
  }
}

__device__ __forceinline__ void row_store(uint16_t* p, const int (&c)[16]) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = uint32_t(c[2 * k]) | (uint32_t(c[2 * k + 1]) << 16);
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(w[0], w[1], w[2], w[3]);
  q[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Group g's warm tables hi [64, 16, G], lo [48, 16, G] int32 -> the lane's
// rows (hi rows 0..63, lo rows 64..111).
__device__ __forceinline__ void init_tables(const int* hi_tbl,
                                            const int* lo_tbl, int G, int g,
                                            uint16_t* tab) {
  for (int r = 0; r < kRows; ++r) {
    const int* src = r < kNctx ? hi_tbl + size_t(r) * 16 * G
                               : lo_tbl + size_t(r - kNctx) * 16 * G;
    int c[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = src[size_t(i) * G + g];
    row_store(tab + r * 16, c);
  }
}

// ---- K7: forward model pass.  cols [K, G, 128] u8 -> probs [2K, G, 128]
// int32 = (low << 16) | freq per nibble slot (hi slot 2t, lo slot 2t+1).
__global__ void __launch_bounds__(kModelThreads)
o1_model_kernel(const uint8_t* __restrict__ cols,
                const int* __restrict__ hi_tbl, const int* __restrict__ lo_tbl,
                uint16_t* __restrict__ tables, int* __restrict__ probs, int K,
                int G, int rate) {
  const size_t L = size_t(G) * kLanes;
  const size_t lane = size_t(blockIdx.x) * kModelThreads + threadIdx.x;
  if (lane >= L) return;
  uint16_t* tab = tables + lane * kRows * 16;
  init_tables(hi_tbl, lo_tbl, G, int(lane / kLanes), tab);
  int prev = 0;
  for (int t = 0; t < K; ++t) {
    const int b = cols[size_t(t) * L + lane];
    const int hs = b >> 4, ls = b & 15;
    int c[16];
    uint16_t* hp = tab + ctx_of(prev) * 16;
    row_load(hp, c);
    int low_h, fr_h;
    cdf_lookup(c, hs, low_h, fr_h);
    cdf_update(c, low_h, rate);
    row_store(hp, c);
    uint16_t* lp = tab + (kNctx + locx_of(prev, hs)) * 16;
    row_load(lp, c);
    int low_l, fr_l;
    cdf_lookup(c, ls, low_l, fr_l);
    cdf_update(c, low_l, rate);
    row_store(lp, c);
    probs[size_t(2 * t) * L + lane] = (low_h << 16) | fr_h;
    probs[size_t(2 * t + 1) * L + lane] = (low_l << 16) | fr_l;
    prev = b;
  }
}

// ---- K6: decode.  streams [G, R, 128] int32 (rows 0/1 = initial state
// hi16/lo16, words from 256 in consumption order) -> bytes [K, G, 128] u8,
// final states [G, 128].  One CTA = one group.
__global__ void __launch_bounds__(kLanes)
o1_decode_kernel(const int* __restrict__ streams,
                 const int* __restrict__ hi_tbl,
                 const int* __restrict__ lo_tbl, uint16_t* __restrict__ tables,
                 uint8_t* __restrict__ out, int* __restrict__ fstate, int K,
                 int G, int R, int rate) {
  __shared__ int wsum[2 * kWarps];
  const int g = blockIdx.x;
  const size_t L = size_t(G) * kLanes;
  const size_t lane = size_t(g) * kLanes + threadIdx.x;
  const int* s = streams + size_t(g) * R * kLanes;
  const long long limit = (long long)R * kLanes;
  uint16_t* tab = tables + lane * kRows * 16;
  init_tables(hi_tbl, lo_tbl, G, g, tab);
  uint32_t state = (uint32_t(s[threadIdx.x]) << 16) |
                   uint32_t(s[kLanes + threadIdx.x]);
  long long base = 2 * kLanes;
  int buf = 0, prev = 0;

  for (int t = 0; t < K; ++t) {
    int c[16];
    uint16_t* hp = tab + ctx_of(prev) * 16;
    row_load(hp, c);
    uint32_t value = state & (kTotal - 1);
    const int hs = cdf_search(c, int(value));
    int low_h, fr_h;
    cdf_lookup(c, hs, low_h, fr_h);
    state = uint32_t(fr_h) * (state >> 15) + value - uint32_t(low_h);
    fetch(state, s, limit, base, wsum, buf);
    cdf_update(c, low_h, rate);
    row_store(hp, c);

    uint16_t* lp = tab + (kNctx + locx_of(prev, hs)) * 16;
    row_load(lp, c);
    value = state & (kTotal - 1);
    const int ls = cdf_search(c, int(value));
    int low_l, fr_l;
    cdf_lookup(c, ls, low_l, fr_l);
    state = uint32_t(fr_l) * (state >> 15) + value - uint32_t(low_l);
    fetch(state, s, limit, base, wsum, buf);
    cdf_update(c, low_l, rate);
    row_store(lp, c);

    prev = (hs << 4) | ls;
    out[size_t(t) * L + lane] = uint8_t(prev);
  }
  fstate[lane] = int(state);
}

}  // namespace

extern "C" {

int trc_o1_model(const void* cols, const void* hi_tbl, const void* lo_tbl,
                 void* tables, void* probs, int K, int G, int rate,
                 void* stream) {
  const int blocks = G * (kLanes / kModelThreads);
  o1_model_kernel<<<blocks, kModelThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<uint16_t*>(tables),
      static_cast<int*>(probs), K, G, rate);
  return int(cudaGetLastError());
}

int trc_o1_decode(const void* streams, const void* hi_tbl, const void* lo_tbl,
                  void* tables, void* out, void* fstate, int K, int G, int R,
                  int rate, void* stream) {
  o1_decode_kernel<<<G, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<uint16_t*>(tables),
      static_cast<uint8_t*>(out), static_cast<int*>(fstate), K, G, R, rate);
  return int(cudaGetLastError());
}

}  // extern "C"
