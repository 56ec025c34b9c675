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
// Entries fit u16: they stay in [0, 2^15) (cdf_update in rans_common.cuh).
// The TPU's row-select ladders, write-back mask loops, register queue and
// sliding window are not reproduced: a row is indexed.
//
// K7: the tables are 112 rows x 16 entries per lane, 3.5 KB as u16 and
// 448 KB per 128-lane group, more than a CTA's shared memory.  They live in
// a device scratch buffer that the wrapper allocates, [lane][row][16] u16,
// filled from the warm tables at the kernel's start.  A row is one 32-byte
// sector, read and written as two 16-byte vectors by its own lane; lanes
// select different rows, so a lane-contiguous row keeps every sector
// fetched fully used.  At the default 8192 lanes the scratch is 29.4 MB,
// which stays in the 50 MB L2.  K7 has no cross-lane step, so its CTAs are
// one warp each and spread over all SMs.  What bounds it: not bytes and not
// operations, but a chain of dependent steps a byte (row load -> lookup ->
// update -> row store) whose row loads wait on the L2: the time is that
// latency times K.
//
// K6 keeps one 128-lane group per CTA: its fetch ranks the lanes that need
// a word across the whole group.  It runs on the o0 decoders' byte step
// (rans_common.cuh): the search and lookup by select trees on tables in
// registers, the stream staged in a shared-memory ring, the fetch in two
// halves with the work that needs no word between them.  Its lo rows are
// in shared memory (the decoders' conflict-free row layout), its hi rows
// in L2, the current one in registers (see o1_decode_kernel).  What bounds
// it now: the same chain as K1's (search, lookup, state, ballot, barrier,
// rank, word) on 4 warps an SM, 68 of the 132 SMs holding no group, plus
// the hi rows' traffic to L2 (tools/decode_probe.py --kernel o1_decode,
// PERF.md sections 6 and 7).
//
// Rules kept: __syncthreads() only inside a fetch, reached by all 128
// threads every step; no loop bound taken from data; every stream read is
// bounds-checked, so a corrupt stream decodes to wrong bytes, never to an
// out-of-bounds access or a hang; row indices are contexts, ctx_of <= 63
// and locx_of <= 47 by construction.  Each C entry point returns
// cudaGetLastError() after its launch.

#include <climits>

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

// A row's 16 u16 entries, two a word, <-> 16 ints.
__device__ __forceinline__ void unpack_row(const uint4 (&w)[2], int (&c)[16]) {
  const uint32_t v[8] = {w[0].x, w[0].y, w[0].z, w[0].w,
                         w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[2 * k] = int(v[k] & 0xFFFFu);
    c[2 * k + 1] = int(v[k] >> 16);
  }
}

__device__ __forceinline__ void pack_row(const int (&c)[16], uint4 (&w)[2]) {
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = uint32_t(c[2 * k]) | (uint32_t(c[2 * k + 1]) << 16);
  w[0] = make_uint4(v[0], v[1], v[2], v[3]);
  w[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void row_load(const uint16_t* p, int (&c)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 w[2] = {q[0], q[1]};
  unpack_row(w, c);
}

__device__ __forceinline__ void row_store(uint16_t* p, const int (&c)[16]) {
  uint4 w[2];
  pack_row(c, w);
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = w[0];
  q[1] = w[1];
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
// final states [G, 128].  One CTA = one group, one thread a lane, on the
// o0 decoders' byte step (rans_common.cuh): the search, lookup and tables
// in registers, the stream in a shared-memory ring, the fetch in two
// halves.  The lo rows of every lane are in shared memory ([48][2 halves]
// [128 lanes][8] u16, 196,608 B); the 64 hi rows a lane (256 KB a group)
// do not fit beside them and stay in a device scratch, [L][64][16] u16
// (16.8 MB at 8192 lanes, in L2).  The hi row of the next byte is known
// once its lo nibble is: when it is this byte's row it stays in registers,
// else this one is written back and the next one requested at once, so
// its L2 latency overlaps the second fetch, the lo update and the store.
// The row rides in registers packed (hw, as it lies in memory) and is
// unpacked at the top of the byte step: unpacked, both sides of the branch
// would have to define the 16 entries, and the loaded side waited for the
// L2 there (a 730-cycle stall a byte).  The store comes before the load in
// the thread's program order, so a row read again later sees its update.
// Its dynamic shared memory: the ring of stream words, every lane's lo
// rows, the per-warp rank counts (one byte a warp, double-buffered).
constexpr int kO1Ring = 0;
constexpr int kO1Lo = kO1Ring + kRingWords * 4;
constexpr int kO1Rank = kO1Lo + kLrows * kLanes * 32;
constexpr int kO1Smem = (kO1Rank + 2 * kWarps + 15) / 16 * 16;
static_assert(kO1Lo % 16 == 0 && kO1Rank % 16 == 0, "16-byte regions");
static_assert(kO1Smem <= kSmemMax, "K6's carve fits a CTA");

__global__ void __launch_bounds__(kLanes, 1)
o1_decode_kernel(const int* __restrict__ streams,
                 const int* __restrict__ hi_tbl,
                 const int* __restrict__ lo_tbl, uint16_t* __restrict__ hi_rows,
                 uint8_t* __restrict__ out, int* __restrict__ fstate, int K,
                 int G, int R, int rate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* lo = reinterpret_cast<uint16_t*>(smem_raw + kO1Lo);
  uint8_t* rank = smem_raw + kO1Rank;
  const int g = blockIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + threadIdx.x;
  const int limit = R * kLanes;
  Ring r[1];
  ring_init(r[0], streams + size_t(g) * R * kLanes,
            reinterpret_cast<int*>(smem_raw + kO1Ring), limit);
  cp_async_commit();
  uint32_t state[1] = {(uint32_t(r[0].src[threadIdx.x]) << 16) |
                       uint32_t(r[0].src[kLanes + threadIdx.x])};

  // Group g's warm tables hi [64, 16, G], lo [48, 16, G] int32 -> this
  // lane's hi rows in the scratch and lo rows in shared memory; hi row 0
  // (the context of prev = 0) also in registers.
  uint16_t* tab = hi_rows + col * kNctx * 16;
  uint4 hw[2];  // the current hi row, packed
  for (int h = 0; h < kRows; ++h) {
    const int* src = h < kNctx ? hi_tbl + size_t(h) * 16 * G
                               : lo_tbl + size_t(h - kNctx) * 16 * G;
    int v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = src[size_t(i) * G + g];
    if (h >= kNctx) {
      st_row(lane_row(lo, h - kNctx), kHalf, v);
    } else {
      row_store(tab + h * 16, v);
      if (h == 0) pack_row(v, hw);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  int ctx = 0, prev = 0, buf = 0, nfetch = 0;
  uint8_t* out_t = out + col;  // byte t of this lane
  for (int t = 0; t < K; ++t) {
    int hrow[16];
    unpack_row(hw, hrow);
    uint32_t value = state[0] & (kTotal - 1);
    const int hs = search_tree(hrow, int(value));
    int low_h, fr_h;
    lookup_pick(hrow, hs, low_h, fr_h);
    state[0] = uint32_t(fr_h) * (state[0] >> 15) + value - uint32_t(low_h);
    unsigned bal[1];
    fetch_post(state, bal, rank, buf, nfetch);
    // what needs no word of this fetch: the lo row, the hi update
    uint16_t* lp = lane_row(lo, locx_of(prev, hs));
    int lrow[16];
    ld_row(lp, kHalf, lrow);
    cdf_update(hrow, low_h, rate);
    pack_row(hrow, hw);
    fetch_take(state, bal, r, limit, rank, buf, nfetch);

    value = state[0] & (kTotal - 1);
    const int ls = search_tree(lrow, int(value));
    int low_l, fr_l;
    lookup_pick(lrow, ls, low_l, fr_l);
    state[0] = uint32_t(fr_l) * (state[0] >> 15) + value - uint32_t(low_l);
    const int b = (hs << 4) | ls;
    const int nctx = ctx_of(b);
    if (nctx != ctx) {
      uint4* q = reinterpret_cast<uint4*>(tab + ctx * 16);
      q[0] = hw[0];
      q[1] = hw[1];
      q = reinterpret_cast<uint4*>(tab + nctx * 16);
      hw[0] = q[0];
      hw[1] = q[1];
      ctx = nctx;
    }
    fetch_post(state, bal, rank, buf, nfetch);
    cdf_update(lrow, low_l, rate);
    st_row(lp, kHalf, lrow);
    *out_t = uint8_t(b);
    out_t += plane;
    fetch_take(state, bal, r, limit, rank, buf, nfetch);
    prev = b;
  }
  cp_async_wait<0>();
  fstate[col] = int(state[0]);
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

// K6: tile and rate; the launch is fixed (kLanes threads, kO1Smem bytes).
// A tile it cannot decode returns cudaErrorInvalidValue.
int trc_o1_decode(const void* streams, const void* hi_tbl, const void* lo_tbl,
                  void* hi_rows, void* out, void* fstate, int K, int G, int R,
                  int rate, void* stream) {
  const bool ok = rate >= 7 && rate <= 10 && K >= 0 && G >= 1 && R >= 2 &&
                  R <= (INT_MAX - 2 * kRingWords) / kLanes &&
                  (reinterpret_cast<uintptr_t>(streams) & 15) == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      o1_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kO1Smem);
  if (e != cudaSuccess) return int(e);
  o1_decode_kernel<<<G, kLanes, kO1Smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<uint16_t*>(hi_rows),
      static_cast<uint8_t*>(out), static_cast<int*>(fstate), K, G, R, rate);
  return int(cudaGetLastError());
}

}  // extern "C"
