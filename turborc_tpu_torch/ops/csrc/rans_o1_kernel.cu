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
// K7 knows every byte in advance (it is the input), so it has no search and
// no fetch, and its lanes are independent: CTAs of kModelLanes = 32 lanes,
// four a group, which spread over every SM.  Each CTA holds every row of
// its lanes in shared memory, 112 rows x 32 B x 32 lanes = 114,688 B in
// the decoders' conflict-free row layout, beside a two-stage ring of its
// input bytes that cp.async fills; two CTAs fit an SM.  The tables of a
// byte step are in registers, looked up by select trees (lookup_pick).
// Both rows of byte t + 1 (ctx_of(b_t), locx_of(b_t, hi of b_t+1)) are
// known before byte t's updates are done, so they are read from shared
// memory before byte t's rows are stored, and where a row repeats its
// updated registers are forwarded instead: that is the one dependence
// between bytes.  The hi and lo chains of a byte are independent of each
// other.  What bounds it: not bytes and not operations, but the chain of
// a byte step (lookup, update, forward select) on 2 warps an SM
// (tools/decode_probe.py --kernel o1_model, PERF.md sections 6 and 7).
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
// Rules kept: __syncthreads() only inside a fetch (K6) or at a stage of
// input bytes (K7), where every thread of the CTA arrives, under
// conditions on the byte index alone; no loop bound taken from data;
// every stream read is bounds-checked, so a corrupt stream decodes to
// wrong bytes, never to an out-of-bounds access or a hang; row indices
// are contexts, ctx_of <= 63 and locx_of <= 47 by construction.  Each C
// entry point returns cudaGetLastError() after its launch.

#include <climits>

#include "rans_common.cuh"

namespace {

constexpr int kNctx = 64;                 // hi rows
constexpr int kLrows = 48;                // lo rows
constexpr int kLin = kNctx - 8;           // exact-rank hi rows
constexpr int kRows = kNctx + kLrows;     // rows per lane

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

__device__ __forceinline__ void row_store(uint16_t* p, const int (&c)[16]) {
  uint4 w[2];
  pack_row(c, w);
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = w[0];
  q[1] = w[1];
}

// ---- K7: forward model pass.  cols [K, G, 128] u8 -> probs [2K, G, 128]
// int32 = (low << 16) | freq per nibble slot (hi slot 2t, lo slot 2t+1).
// A CTA is kModelLanes lanes of one group, one thread a lane.  Its dynamic
// shared memory: every lane's 112 rows ([112][2 halves][32 lanes][8] u16;
// hi rows 0..63, lo rows 64..111), then the ring of input bytes, two
// stages of kModelSteps byte steps x 32 lanes.  At byte t + 1 = 0 mod
// kModelSteps the warp waits for the stage that starts there (requested a
// stage earlier), the barrier frees the stage before it, and the CTA
// requests the next stage into that one.
constexpr int kModelLanes = 32;                       // lanes (threads) a CTA
constexpr int kModelSteps = 16;                       // byte steps a stage
constexpr int kModelHalf = kModelLanes * 8;
constexpr int kO1MRows = 0;
constexpr int kO1MCols = kO1MRows + kRows * kModelLanes * 32;
constexpr int kO1MSmem = kO1MCols + 2 * kModelSteps * kModelLanes;
static_assert(kLanes % kModelLanes == 0, "a group is whole CTAs");
static_assert(kO1MCols % 16 == 0 && kO1MSmem % 16 == 0, "16-byte regions");
static_assert(kModelSteps * kModelLanes / 16 == kModelLanes,
              "a stage is one 16-byte copy a thread");
static_assert(2 * (kO1MSmem + kSmemCta) <= kSmemSm,
              "two of K7's CTAs fit an SM");

__device__ __forceinline__ uint16_t* model_row(uint16_t* rows, int h) {
  return lane_row<kModelLanes>(rows, h);
}

// The CTA requests byte steps [t0, t0 + kModelSteps) below K of its lanes
// (their bytes start at src, a step every L bytes) into the ring, 16 lanes
// a copy.
__device__ __forceinline__ void model_stage(uint8_t* ring,
                                            const uint8_t* src, int t0,
                                            int K, size_t L) {
  const int t = t0 + (threadIdx.x >> 1), part = (threadIdx.x & 1) * 16;
  if (t < K)
    cp_async16(ring + (t & (2 * kModelSteps - 1)) * kModelLanes + part,
               src + size_t(t) * L + part);
}

__global__ void __launch_bounds__(kModelLanes, 2)
o1_model_kernel(const uint8_t* __restrict__ cols,
                const int* __restrict__ hi_tbl, const int* __restrict__ lo_tbl,
                int* __restrict__ probs, int K, int G, int rate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* rows = reinterpret_cast<uint16_t*>(smem_raw + kO1MRows);
  uint8_t* ring = smem_raw + kO1MCols;
  const size_t L = size_t(G) * kLanes;
  const size_t lane0 = size_t(blockIdx.x) * kModelLanes;
  const uint8_t* src = cols + lane0;
  model_stage(ring, src, 0, K, L);
  cp_async_commit();
  model_stage(ring, src, kModelSteps, K, L);
  cp_async_commit();

  // Group g's warm tables hi [64, 16, G], lo [48, 16, G] int32 -> every
  // lane's rows.  The CTA reads each of the 1,792 entries once: entry k =
  // 16 h + e (rows 2c and 2c + 1 at chunk c) is read by thread k % 32 and
  // handed to every lane by shuffles.
  const int g = int(lane0 / kLanes);
  for (int c = 0; c < kRows / 2; ++c) {
    const int k = 32 * c + threadIdx.x, h = k >> 4, e = k & 15;
    const int v = h < kNctx ? hi_tbl[(size_t(h) * 16 + e) * G + g]
                            : lo_tbl[(size_t(h - kNctx) * 16 + e) * G + g];
    int r0[16], r1[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      r0[i] = __shfl_sync(kFull, v, i);
      r1[i] = __shfl_sync(kFull, v, 16 + i);
    }
    st_row(model_row(rows, 2 * c), kModelHalf, r0);
    st_row(model_row(rows, 2 * c + 1), kModelHalf, r1);
  }
  cp_async_wait<1>();
  __syncthreads();

  // the rows of byte 0 (prev = 0: hi context 0)
  int b = K > 0 ? ring[threadIdx.x] : 0;
  int hc = 0, lc = kNctx + locx_of(0, b >> 4);
  int hrow[16], lrow[16];
  ld_row(model_row(rows, hc), kModelHalf, hrow);
  ld_row(model_row(rows, lc), kModelHalf, lrow);
  int* out = probs + lane0 + threadIdx.x;  // slot 2t of this lane
  for (int t = 0; t < K; ++t) {
    const int u = t + 1;
    if ((u & (kModelSteps - 1)) == 0) {
      cp_async_wait<0>();
      __syncthreads();
      model_stage(ring, src, u + kModelSteps, K, L);
      cp_async_commit();
    }
    const int bn =
        u < K ? ring[(u & (2 * kModelSteps - 1)) * kModelLanes + threadIdx.x]
              : 0;
    int low_h, fr_h, low_l, fr_l;
    lookup_pick(hrow, b >> 4, low_h, fr_h);
    lookup_pick(lrow, b & 15, low_l, fr_l);
    // the rows of byte t + 1, read before this byte's stores
    const int hn = ctx_of(b), ln = kNctx + locx_of(b, bn >> 4);
    int hnext[16], lnext[16];
    ld_row(model_row(rows, hn), kModelHalf, hnext);
    ld_row(model_row(rows, ln), kModelHalf, lnext);
    cdf_update(hrow, low_h, rate);
    cdf_update(lrow, low_l, rate);
    st_row(model_row(rows, hc), kModelHalf, hrow);
    st_row(model_row(rows, lc), kModelHalf, lrow);
    out[0] = (low_h << 16) | fr_h;
    out[L] = (low_l << 16) | fr_l;
    out += 2 * L;
    // a row that repeats keeps its updated registers
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      hrow[i] = hn == hc ? hrow[i] : hnext[i];
      lrow[i] = ln == lc ? lrow[i] : lnext[i];
    }
    hc = hn;
    lc = ln;
    b = bn;
  }
  cp_async_wait<0>();
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

// K7: tile and rate; the launch is fixed (4 CTAs a group of kModelLanes
// threads, kO1MSmem bytes).  A tile it cannot take returns
// cudaErrorInvalidValue.
int trc_o1_model(const void* cols, const void* hi_tbl, const void* lo_tbl,
                 void* probs, int K, int G, int rate, void* stream) {
  const bool ok = rate >= 7 && rate <= 10 && K >= 0 && G >= 1 &&
                  G <= INT_MAX / kLanes &&
                  (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      o1_model_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kO1MSmem);
  if (e == cudaSuccess)  // the most shared memory, for two CTAs an SM
    e = cudaFuncSetAttribute(o1_model_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (e != cudaSuccess) return int(e);
  o1_model_kernel<<<G * (kLanes / kModelLanes), kModelLanes, kO1MSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<int*>(probs), K, G, rate);
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
