// Bitwise byte-tree codecs (rc-o0 id 1, rcc-o1 id 2, rc-o0-ss id 101,
// rcc-o1-ss id 102, rc-o0-sf id 103, rcc-o1-sf id 104) for Hopper, sm_90a.
//
// The JAX package runs them as lax.scans compiled by XLA
// (turborc_tpu/codecs/rc_bit.py encode_device and decode_device); they
// have no Pallas kernel.  One compiled device loop becomes one kernel:
//   lane_bit_model_kernel   L11  bytes -> slot probs (encode_device's scan,
//                                _fwd_byte)
//   lane_bit_decode_kernel  L12  per-lane streams -> bytes (decode_device,
//                                _dec_byte)
// templates on the predictor (PredS, PredSS, PredSF) and the order (0 or
// 1).  The encode side's backward coder is L2 of rans_lane_kernel.cu,
// unchanged, over 8K slots a lane.
//
// Layout (ops/rans_bit_kernel.py): L lanes, any power of two; byte t of
// lane l at cols/out[t * L + l]; decision d of byte t at probs[(8 t + d) L
// + l], (low << 16) | freq.  The decoder reads the lanes' u16 words as L3
// does: lane l's len[l] words from offset off[l], word p reading 0 at or
// past min(len, 8K + 2) or past the W words.
//
// A byte b is 8 binary decisions, most significant bit first.  Decision d
// reads slot ctx * 256 + node, node = (256 | b) >> (8 - d) (a leading 1,
// then the top d bits of b), ctx the lane's previous byte at order 1 (0
// before its first, padding bytes included) and 0 at order 0.  Its
// probability of a 1 is p = clamp(predict(slot), 1, 2^15 - 1); bit 1 codes
// (low 0, freq p), bit 0 (low p, freq 2^15 - p), and the slot then takes
// the predictor's update with the clamped p.  A slot is one u32:
//   PredS   the counter; update p - (((p - (bit << 15)) >> 5) + bit), an
//           arithmetic shift (the stored value may pass 2^15; the
//           prediction clamps it)
//   PredSS  two 16-bit counters c0 | c1 << 16, predict (c0 + c1) >> 2,
//           update c += (c ^ 0xFFFF) >> rate on a 1, c -= c >> rate on a
//           0, at rates r0, r1 (a shift of 16 or more gives 0: the entry
//           clamps the rates to 16)
//   PredSF  a state of the FSM table fsm [3][S] (prob, next0, next1),
//           predict prob[state], update next{bit}[state]; a next state
//           past S - 1 reads as S - 1, so no table read leaves the table
//           (the identity on the port's tables, whose states are < S)
//
// L11: the 8 decisions of a byte touch one node at each tree depth, so a
// lane's model pass is 8 independent chains, one a depth, which share only
// the input bytes (and, at order 1, the context, also an input byte).  A
// CTA holds kBitLanes = 32 lanes and 8 warps: warp d runs depth d of the
// 32 lanes, a thread a lane, so a warp's stores of its slots fill whole
// 128-byte rows of probs; no thread reads another's slots, so there is no
// barrier.  At order 0 a lane's 256 slots lie in shared memory, a stride
// of kBitStride = 257 words a lane, so that the 32 lanes of a warp at one
// node fall in 32 banks; at order 1 its 65,536 slots lie in `tables`
// [L][65536] in device memory, set to the predictor's initial value by
// bit_fill_kernel first.
//
// L12: decision d + 1's node and the rANS state both wait on decision d,
// so a lane is one chain: one thread a lane, kBitDLanes lanes a CTA, the
// slots laid out as L11's.  While a decision resolves, the values (and
// predictions) of both children of its node are read, so the next
// decision's slot read is off the chain; the lane's next stream word is
// read as soon as the last one is taken.
//
// Rules kept: every stream read is bounds-checked, a loop's bound is K or
// a constant, a slot index is below 256 (order 0) or 65,536 (order 1) by
// construction, so a corrupt stream or length table decodes to wrong
// bytes, never to an out-of-bounds access or a hang.  Each C entry point
// checks its arguments, returns cudaErrorInvalidValue without a launch
// when they do not fit, and otherwise cudaGetLastError() after its
// launches.

#include <climits>
#include <type_traits>

#include "rans_common.cuh"

namespace {

constexpr int kBitLanes = 32;    // L11: lanes a CTA (8 warps, one a depth)
constexpr int kBitDLanes = 8;    // L12: lanes (threads) a CTA
constexpr int kBitStride = 257;  // order 0: u32 slots a lane in smem
constexpr int kCtxSlots = 65536;  // order 1: u32 slots a lane
constexpr int kMaxRate = 16;
constexpr int kFillThreads = 256;
constexpr int kFillCtas = 132 * 8;

struct PredS {
  __host__ __device__ __forceinline__ uint32_t init() const {
    return kTotal / 2;
  }
  __device__ __forceinline__ int prob(uint32_t v) const { return int(v); }
  __device__ __forceinline__ uint32_t next(uint32_t, int p, int bit) const {
    return uint32_t(p - (((p - (bit << 15)) >> 5) + bit));
  }
};

struct PredSS {
  int r0, r1;
  __host__ __device__ __forceinline__ uint32_t init() const {
    return 0x80008000u;
  }
  __device__ __forceinline__ int prob(uint32_t v) const {
    return int(((v & 0xFFFFu) + (v >> 16)) >> 2);
  }
  __device__ __forceinline__ uint32_t next(uint32_t v, int, int bit) const {
    uint32_t c0 = v & 0xFFFFu, c1 = v >> 16;
    c0 = bit ? c0 + ((c0 ^ 0xFFFFu) >> r0) : c0 - (c0 >> r0);
    c1 = bit ? c1 + ((c1 ^ 0xFFFFu) >> r1) : c1 - (c1 >> r1);
    return c0 | (c1 << 16);
  }
};

struct PredSF {
  const int* tab;  // [3][S]: prob, next0, next1
  int S;
  uint32_t start;
  __host__ __device__ __forceinline__ uint32_t init() const {
    return start;
  }
  __device__ __forceinline__ int prob(uint32_t v) const {
    return __ldg(tab + v);
  }
  __device__ __forceinline__ uint32_t next(uint32_t v, int, int bit) const {
    const uint32_t s = uint32_t(__ldg(tab + size_t(bit ? 2 : 1) * S + v));
    return s < uint32_t(S) ? s : uint32_t(S - 1);
  }
};

__device__ __forceinline__ int clamp_p(int p) {
  return p < 1 ? 1 : p > kTotal - 1 ? kTotal - 1 : p;
}

// `tables` [n4 x 4] u32 <- v.
__global__ void bit_fill_kernel(uint4* __restrict__ tables, size_t n4,
                                uint32_t v) {
  const uint4 q = make_uint4(v, v, v, v);
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * blockDim.x)
    tables[i] = q;
}

// ---- L11: cols [K, L] u8 -> probs [8K, L] int32.
template <class P, int kOrder>
__global__ void __launch_bounds__(kBitLanes * 8)
lane_bit_model_kernel(const uint8_t* __restrict__ cols,
                      int* __restrict__ probs, uint32_t* __restrict__ tables,
                      P pred, int K, int L) {
  __shared__ uint32_t s_tab[kOrder == 0 ? kBitLanes * kBitStride : 1];
  const int d = threadIdx.x >> 5, n = threadIdx.x & 31;
  const int l = blockIdx.x * kBitLanes + n;
  if (l >= L) return;  // no barrier or shuffle below
  uint32_t* tab = kOrder == 0 ? s_tab + n * kBitStride
                              : tables + size_t(l) * kCtxSlots;
  if (kOrder == 0) {  // depth d's nodes, this thread's own
    for (int k = 1 << d; k < 2 << d; ++k) tab[k] = pred.init();
  }
  const uint8_t* src = cols + l;
  int* out = probs + size_t(d) * L + l;
  const int shift = 8 - d, bitpos = 7 - d;
  int ctx = 0;
#pragma unroll 4
  for (int t = 0; t < K; ++t) {
    const int b = src[size_t(t) * L];
    const int slot = (kOrder ? ctx << 8 : 0) | ((256 | b) >> shift);
    const uint32_t v = tab[slot];
    const int p = clamp_p(pred.prob(v));
    const int bit = (b >> bitpos) & 1;
    tab[slot] = pred.next(v, p, bit);
    out[size_t(8) * t * L] = bit ? p : (p << 16) | (kTotal - p);
    if (kOrder) ctx = b;
  }
}

// ---- L12: lane streams (words, off, len; M = 8K + 2) -> bytes [K, L] u8.
template <class P, int kOrder>
__global__ void __launch_bounds__(kBitDLanes)
lane_bit_decode_kernel(const uint16_t* __restrict__ words,
                       const long long* __restrict__ off,
                       const int* __restrict__ len, uint8_t* __restrict__ out,
                       uint32_t* __restrict__ tables, P pred, int K, int L,
                       long long W) {
  __shared__ uint32_t s_tab[kOrder == 0 ? kBitDLanes * kBitStride : 1];
  const int n = threadIdx.x, l = blockIdx.x * kBitDLanes + n;
  if (l >= L) return;
  uint32_t* tab = kOrder == 0 ? s_tab + n * kBitStride
                              : tables + size_t(l) * kCtxSlots;
  if (kOrder == 0) {
    for (int k = 1; k < 256; ++k) tab[k] = pred.init();
  }
  const long long o = off[l], M = 8LL * K + 2;
  const long long a = o >= 0 && o < W ? min(min((long long)len[l], M), W - o)
                                      : 0;
  const int nw = int(a > 0 ? a : 0);
  const uint16_t* src = words + (nw ? o : 0);
  uint32_t state = (nw > 0 ? uint32_t(src[0]) << 16 : 0u) |
                   (nw > 1 ? uint32_t(src[1]) : 0u);
  int pos = 2;
  uint32_t next = nw > 2 ? uint32_t(src[2]) : 0u;
  uint8_t* dst = out + l;
  int ctx = 0;
  for (int t = 0; t < K; ++t) {
    uint32_t* row = tab + (kOrder ? ctx << 8 : 0);
    uint32_t v = row[1];
    int p = clamp_p(pred.prob(v));
    int node = 1;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      uint32_t v0 = 0, v1 = 0;
      int p0 = 0, p1 = 0;
      if (d < 7) {  // both children, read while the bit resolves
        v0 = row[2 * node];
        v1 = row[2 * node + 1];
        p0 = clamp_p(pred.prob(v0));
        p1 = clamp_p(pred.prob(v1));
      }
      const uint32_t value = state & (kTotal - 1);
      const int bit = value < uint32_t(p) ? 1 : 0;
      state = bit ? uint32_t(p) * (state >> 15) + value
                  : uint32_t(kTotal - p) * (state >> 15) + value - uint32_t(p);
      row[node] = pred.next(v, p, bit);
      if (state < kAnsLow) {
        state = (state << 16) | next;
        ++pos;
        next = pos < nw ? uint32_t(src[pos]) : 0u;
      }
      node = 2 * node + bit;
      v = bit ? v1 : v0;
      p = bit ? p1 : p0;
    }
    const int byte = node & 255;
    dst[size_t(t) * L] = uint8_t(byte);
    if (kOrder) ctx = byte;
  }
}

bool pow2(int v, int cap) { return v >= 1 && v <= cap && !(v & (v - 1)); }

// The arguments both kernels share, or false where they do not fit.
bool bit_fits(int K, int L, int order, int kind, const uint32_t* tables,
              const int* fsm, int r0, int r1, int S, int start) {
  if (K < 0 || K > (INT_MAX - 2) / 8 || !pow2(L, 1 << 30) ||
      size_t(8) * size_t(K) * size_t(L) > size_t(1) << 40)
    return false;
  if (order != 0 && order != 1) return false;
  if (order == 1 && (!tables || reinterpret_cast<uintptr_t>(tables) % 16))
    return false;
  if (kind == 1 && (r0 < 0 || r1 < 0)) return false;
  if (kind == 2 && (!fsm || S < 1 || start < 0 || start >= S)) return false;
  return kind >= 0 && kind <= 2;
}

// Calls f(pred, order) with the predictor of `kind` and the order as
// compile-time constants; order 1 first fills the tables.
template <class F>
int bit_dispatch(int kind, int order, int r0, int r1, const int* fsm, int S,
                 int start, uint32_t* tables, int L, cudaStream_t stream,
                 F&& f) {
  auto run = [&](auto pred) {
    if (order == 0) return f(pred, std::integral_constant<int, 0>());
    const size_t n4 = size_t(L) * kCtxSlots / 4;
    const size_t ctas = (n4 + kFillThreads - 1) / kFillThreads;
    bit_fill_kernel<<<int(ctas < kFillCtas ? ctas : kFillCtas), kFillThreads,
                      0, stream>>>(reinterpret_cast<uint4*>(tables), n4,
                                   pred.init());
    return f(pred, std::integral_constant<int, 1>());
  };
  if (kind == 0) return run(PredS{});
  if (kind == 1)
    return run(PredSS{r0 < kMaxRate ? r0 : kMaxRate,
                      r1 < kMaxRate ? r1 : kMaxRate});
  return run(PredSF{fsm, S, uint32_t(start)});
}

}  // namespace

extern "C" {

// L11.  kind: 0 s, 1 ss (rates r0, r1), 2 sf (fsm [3][S], start state).
// tables: order 1's [L][65536] u32 scratch (16-byte aligned), else null.
int trc_lane_bit_model(const uint8_t* cols, int* probs, uint32_t* tables,
                       const int* fsm, int K, int L, int order, int kind,
                       int r0, int r1, int S, int start,
                       cudaStream_t stream) {
  if (!bit_fits(K, L, order, kind, tables, fsm, r0, r1, S, start))
    return int(cudaErrorInvalidValue);
  return bit_dispatch(kind, order, r0, r1, fsm, S, start, tables, L, stream,
                      [&](auto pred, auto ord) {
    constexpr int O = decltype(ord)::value;
    lane_bit_model_kernel<decltype(pred), O>
        <<<(L + kBitLanes - 1) / kBitLanes, kBitLanes * 8, 0, stream>>>(
            cols, probs, tables, pred, K, L);
    return int(cudaGetLastError());
  });
}

// L12: L3's stream arguments, then L11's.
int trc_lane_bit_decode(const uint16_t* words, const long long* off,
                        const int* len, uint8_t* out, uint32_t* tables,
                        const int* fsm, int K, int L, int W, int order,
                        int kind, int r0, int r1, int S, int start,
                        cudaStream_t stream) {
  if (W < 0 || !bit_fits(K, L, order, kind, tables, fsm, r0, r1, S, start))
    return int(cudaErrorInvalidValue);
  return bit_dispatch(kind, order, r0, r1, fsm, S, start, tables, L, stream,
                      [&](auto pred, auto ord) {
    constexpr int O = decltype(ord)::value;
    lane_bit_decode_kernel<decltype(pred), O>
        <<<(L + kBitDLanes - 1) / kBitDLanes, kBitDLanes, 0, stream>>>(
            words, off, len, out, tables, pred, K, L, W);
    return int(cudaGetLastError());
  });
}

}  // extern "C"
