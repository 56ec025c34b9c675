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
// reads slot (ctx, node), node = (256 | b) >> (8 - d) (a leading 1, then
// the top d bits of b), ctx the lane's previous byte at order 1 (0 before
// its first, padding bytes included) and 0 at order 0.  Its probability
// of a 1 is p = clamp(predict(slot), 1, 2^15 - 1); bit 1 codes (low 0,
// freq p), bit 0 (low p, freq 2^15 - p), and the slot then takes the
// predictor's update with the clamped p:
//   PredS   one counter; update p - (((p - (bit << 15)) >> 5) + bit), an
//           arithmetic shift (the counter never leaves [1, 2^15 - 1], so
//           the clamp of its prediction is the identity)
//   PredSS  two 16-bit counters c0 | c1 << 16, predict (c0 + c1) >> 2,
//           update c += (c ^ 0xFFFF) >> rate on a 1, c -= c >> rate on a
//           0, at rates r0, r1 (a shift of 16 or more gives 0: the entry
//           clamps the rates to 16)
//   PredSF  a state of the FSM table fsm [3][S] (prob, next0, next1),
//           predict prob[state], update next{bit}[state]; a next state
//           past S - 1 reads as S - 1 (the identity on the port's tables,
//           whose states are < S).  A CTA first copies the machine into
//           shared memory as u16: nx[2 s + bit] (the next states, 4 S
//           bytes) and pq[s] (the clamped probabilities, 2 S bytes), so S
//           is at most kMaxStates = 32,768 (192 KB); a larger table is
//           refused.
// Each kernel keeps the slots in a layout of its own; what both keep is
// each slot's sequence of values.  A CTA has kBitSetup threads: all of
// them load the FSM table and set the shared slots, then the lane threads
// run and the others leave (no barrier after that).
//
// L11 knows every byte: the 8 decisions of a byte touch one node at each
// tree depth, so a lane's model pass is 8 independent chains, one a depth,
// which share only the input bytes.  Its CTAs hold kBitLanes = 4 lanes,
// one warp: thread 4 d + n runs depth d of lane n (128 CTAs at 512 lanes,
// a warp alone on its SM).  Lane i of the warp reads byte step c + i of
// the 4 lanes a chunk of 32 steps ahead, and a step's bytes come by one
// shuffle.  A thread reads the slot of step t + A right after step t's
// store (A = kAhead0 = 2 at order 0, kAhead1 = 8 at order 1) and takes
// the value from the updates of steps t + 1 .. t + A - 1 where one of them
// wrote the same slot, so a slot read is never on the chain: only a slot
// that repeats is, through registers (the root at order 0 on every byte).
// Order 0 keeps a lane's 256 slots in shared memory (kBitStride = 257
// words a lane, so the 4 lanes' same node lie in 4 banks); order 1 its
// 65,536 in `tables` [L][65536] (slot ctx * 256 + node), set to the
// predictor's initial value by bit_fill_kernel first.  An FSM slot holds
// the state.
//
// L12: decision d + 1's node and the rANS state both wait on decision d,
// so a lane is one chain: a thread a lane, alone in its warp (thread 0 of
// warp n runs lane n), kBitDLanes = 4 lanes a CTA (128 CTAs, a lane on
// each scheduler of an SM: the step is bound by the issue of its integer
// instructions, so the fewer a decision the better).  A decision computes
// both next states, the bit picks one, then the renorm; the chosen child's
// value, read earlier, is picked and predicted.  An FSM slot holds its
// clamped probability beside its state, (p << 16) | state, so no table read
// is on the chain; a slot's update is stored two decisions later (the
// FSM's two shared-memory reads in between).  The lane's words come from a
// ring of kRingW words in shared memory that cp.async fills a 16-byte unit
// a byte step, kRingAhead words ahead, zeros past the lane's end: no branch
// and no bounds test at a take, the next word read at every decision.
// Order 0 (decode_o0): the lane's one row in shared memory, node k at slot
// k; a decision reads the four grandchildren of its chosen child (16 bytes)
// a decision before they are needed.  Order 1: a row is read a line at a
// time: its head, nodes 1-7 (depths 0-2), in shared memory (the heads of a
// lane's 256 rows, 8 KB); its line A, nodes 8-31 (depths 3-4), read whole
// from `tables` when the byte starts; and the pair region of its depth-3
// node (the depth 5-7 subtrees of that node's two children, 28 slots), read
// whole as soon as decision 2 is known (a row's body: line A and the 8 pair
// regions, 248 of its 256 slots in `tables`).
//
// Rules kept: every stream read is bounds-checked, a loop's bound is K or
// a constant, a slot index is inside its lane's slots by construction, so
// a corrupt stream or length table decodes to wrong bytes, never to an
// out-of-bounds access or a hang.  Each C entry point checks its
// arguments, returns cudaErrorInvalidValue without a launch when they do
// not fit, and otherwise cudaGetLastError() after its launches.

#include <climits>
#include <type_traits>

#include "rans_common.cuh"

namespace {

constexpr int kBitLanes = 4;      // L11: lanes a CTA (4 x 8 depths, a warp)
constexpr int kBitDLanes = 4;     // L12: lanes a CTA, a warp each
constexpr int kBitSetup = 256;    // threads a CTA of either
constexpr int kAhead0 = 2;        // L11: steps a slot is read ahead, order 0
constexpr int kAhead1 = 8;        // and order 1
constexpr int kBitStride = 257;   // L11 order 0: u32 slots a lane in smem
constexpr int kCtxSlots = 65536;  // order 1: u32 slots a lane
constexpr int kMaxRate = 16;
constexpr int kMaxStates = 32768;  // FSM states a u16 holds
constexpr int kFillThreads = 256;
constexpr int kFillCtas = 132 * 8;
// L12's order-1 row: head slots (nodes 1-7 at 1-7), body slots (line A:
// node 8 + i at i; the pair region of depth-3 node 8 + j at kPairAt +
// kPair j, the subtree of its child 16 + 2 j + h at + 14 h: nodes 2m + i
// at i, 4m + i at 2 + i, 8m + i at 6 + i for that child m)
constexpr int kHeadSlots = 8;
constexpr int kBodySlots = 256;
constexpr int kRowSlots = 256;  // order 0: a lane's one row, node k at k
constexpr int kPairAt = 24;
constexpr int kPair = 28;
// L12: a lane's ring of stream words in shared memory, filled kRingAhead
// words ahead by cp.async a 16-byte unit a byte step
constexpr int kRingW = 128;
constexpr int kRingAhead = 64;

__host__ __device__ __forceinline__ int clamp_p(int p) {
  return p < 1 ? 1 : p > kTotal - 1 ? kTotal - 1 : p;
}

// Shared memory of the FSM table, 16-byte units: nx[2 S] and pq[S], u16.
__host__ __device__ constexpr int fsm_units(int S) {
  return (6 * S + 15) / 16;
}

// The predictors.  L11 reads a slot with prob (clamped) and writes
// next(v, p, bit); L12 with dprob and dnext2(dnext1(v, p, bit)), the FSM's
// two table reads split between the two.  bind() sets up a CTA's shared
// memory (the FSM table) and returns the first u32 after it.
struct PredS {
  static constexpr bool kTable = false;
  __device__ __forceinline__ uint32_t* bind(uint4* smem) {
    return reinterpret_cast<uint32_t*>(smem);
  }
  __host__ __device__ __forceinline__ uint32_t init() const {
    return kTotal / 2;
  }
  // A counter stays in [1, 2^15 - 1]: the start value is, and the update
  // of a p in that range is (tests/test_torch_bit_step.py holds it for
  // every p), so the clamp of the prediction is the identity.
  __device__ __forceinline__ int prob(uint32_t v) const { return int(v); }
  __device__ __forceinline__ uint32_t next(uint32_t, int p, int bit) const {
    return uint32_t(p - (((p - (bit << 15)) >> 5) + bit));
  }
  __device__ __forceinline__ uint32_t dinit() const { return init(); }
  __device__ __forceinline__ int dprob(uint32_t v) const { return prob(v); }
  __device__ __forceinline__ uint32_t dnext1(uint32_t v, int p,
                                             int bit) const {
    return next(v, p, bit);
  }
  __device__ __forceinline__ uint32_t dnext2(uint32_t v) const { return v; }
};

struct PredSS {
  static constexpr bool kTable = false;
  int r0, r1;
  __device__ __forceinline__ uint32_t* bind(uint4* smem) {
    return reinterpret_cast<uint32_t*>(smem);
  }
  __host__ __device__ __forceinline__ uint32_t init() const {
    return 0x80008000u;
  }
  // (c0 + c1) >> 2 <= 2^15 - 1 for 16-bit counters: only the clamp below
  __device__ __forceinline__ int prob(uint32_t v) const {
    return max(int(((v & 0xFFFFu) + (v >> 16)) >> 2), 1);
  }
  __device__ __forceinline__ uint32_t next(uint32_t v, int, int bit) const {
    uint32_t c0 = v & 0xFFFFu, c1 = v >> 16;
    c0 = bit ? c0 + ((c0 ^ 0xFFFFu) >> r0) : c0 - (c0 >> r0);
    c1 = bit ? c1 + ((c1 ^ 0xFFFFu) >> r1) : c1 - (c1 >> r1);
    return c0 | (c1 << 16);
  }
  __device__ __forceinline__ uint32_t dinit() const { return init(); }
  __device__ __forceinline__ int dprob(uint32_t v) const { return prob(v); }
  __device__ __forceinline__ uint32_t dnext1(uint32_t v, int p,
                                             int bit) const {
    return next(v, p, bit);
  }
  __device__ __forceinline__ uint32_t dnext2(uint32_t v) const { return v; }
};

struct PredSF {
  static constexpr bool kTable = true;
  const int* tab;  // [3][S]: prob, next0, next1 (device memory)
  int S;
  uint32_t start;
  const uint16_t* nx = nullptr;  // shared memory, after bind()
  const uint16_t* pq = nullptr;
  // The CTA's copy of the table, every thread taking part.
  __device__ __forceinline__ uint32_t* bind(uint4* smem) {
    uint16_t* n = reinterpret_cast<uint16_t*>(smem);
    uint16_t* q = n + 2 * S;
    const uint32_t last = uint32_t(S - 1);
    auto st = [&](int x) {
      return uint32_t(x) < uint32_t(S) ? uint32_t(x) : last;
    };
    const bool vec =
        (S & 3) == 0 && (reinterpret_cast<uintptr_t>(tab) & 15) == 0;
    const int g4 = vec ? S >> 2 : 0;
#pragma unroll 4
    for (int g = threadIdx.x; g < g4; g += blockDim.x) {
      const int4 pr = __ldg(reinterpret_cast<const int4*>(tab) + g);
      const int4 a = __ldg(reinterpret_cast<const int4*>(tab + S) + g);
      const int4 b = __ldg(reinterpret_cast<const int4*>(tab + 2 * S) + g);
      reinterpret_cast<uint2*>(q)[g] =
          make_uint2(uint32_t(clamp_p(pr.x)) | uint32_t(clamp_p(pr.y)) << 16,
                     uint32_t(clamp_p(pr.z)) | uint32_t(clamp_p(pr.w)) << 16);
      reinterpret_cast<uint4*>(n)[g] =
          make_uint4(st(a.x) | st(b.x) << 16, st(a.y) | st(b.y) << 16,
                     st(a.z) | st(b.z) << 16, st(a.w) | st(b.w) << 16);
    }
    for (int s = 4 * g4 + threadIdx.x; s < S; s += blockDim.x) {
      q[s] = uint16_t(clamp_p(__ldg(tab + s)));
      n[2 * s] = uint16_t(st(__ldg(tab + S + s)));
      n[2 * s + 1] = uint16_t(st(__ldg(tab + 2 * S + s)));
    }
    nx = n;
    pq = q;
    return reinterpret_cast<uint32_t*>(smem + fsm_units(S));
  }
  __host__ __device__ __forceinline__ uint32_t init() const { return start; }
  __device__ __forceinline__ int prob(uint32_t v) const { return pq[v]; }
  __device__ __forceinline__ uint32_t next(uint32_t v, int, int bit) const {
    return nx[2 * v + bit];
  }
  // L12's slot: (p << 16) | state.  dinit reads the table in device
  // memory (bind's copy is not there yet).
  __device__ __forceinline__ uint32_t dinit() const {
    return uint32_t(clamp_p(__ldg(tab + start))) << 16 | start;
  }
  __device__ __forceinline__ int dprob(uint32_t v) const {
    return int(v >> 16);
  }
  __device__ __forceinline__ uint32_t dnext1(uint32_t v, int, int bit) const {
    return nx[2 * (v & 0xFFFFu) + bit];
  }
  __device__ __forceinline__ uint32_t dnext2(uint32_t s) const {
    return uint32_t(pq[s]) << 16 | s;
  }
};

// `tables` [n4 x 4] u32 <- the initial slot value, L11's (init) or, with
// kDecode, L12's (dinit).
template <class P, bool kDecode>
__global__ void bit_fill_kernel(uint4* __restrict__ tables, size_t n4,
                                P pred) {
  const uint32_t v = kDecode ? pred.dinit() : pred.init();
  const uint4 q = make_uint4(v, v, v, v);
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * blockDim.x)
    tables[i] = q;
}

// ---- L11: cols [K, L] u8 -> probs [8K, L] int32.
template <class P, int kOrder>
__global__ void __launch_bounds__(kBitSetup, 1)
lane_bit_model_kernel(const uint8_t* __restrict__ cols,
                      int* __restrict__ probs, uint32_t* __restrict__ tables,
                      P pred, int K, int L) {
  constexpr int kA = kOrder ? kAhead1 : kAhead0;
  static_assert(16 % kA == 0, "a ring entry a step, 16 steps a half chunk");
  extern __shared__ uint4 bit_smem[];
  P pr = pred;
  uint32_t* slots = pr.bind(bit_smem);
  if (kOrder == 0) {
    const uint32_t v0 = pr.init();
    for (int i = threadIdx.x; i < kBitLanes * kBitStride; i += kBitSetup)
      slots[i] = v0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;  // one warp runs; no barrier below
  const int d = threadIdx.x >> 2, n = threadIdx.x & 3;
  const int l0 = blockIdx.x * kBitLanes, l = l0 + n;
  const bool real = l < L;  // the others stay for the shuffles
  const bool full = l0 + kBitLanes <= L;  // every lane of the CTA real
  uint32_t* tab = kOrder ? tables + size_t(real ? l : l0) * kCtxSlots
                         : slots + n * kBitStride;
  const size_t row8 = size_t(8) * L;  // probs of one step, a depth apart
  int* dst = probs + size_t(d) * L + l;
  const int shift = 8 - d, bitpos = 7 - d;
  // Lane i of the warp holds byte step c + i of the CTA's lanes (lane k's
  // byte in bits 8k..8k+7): `cur` for the chunk of 32 steps running,
  // `nxt` for the next, read a chunk ahead.
  const bool vec =
      full && (reinterpret_cast<uintptr_t>(cols) & (kBitLanes - 1)) == 0;
  auto chunk = [&](int c) {
    const int t = c + int(threadIdx.x);
    const uint8_t* p = cols + size_t(t < K ? t : 0) * L + l0;
    if (vec) return ld_u32_if(t < K, p);
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < kBitLanes; ++k)
      if (t < K && l0 + k < L) w |= uint32_t(p[k]) << (8 * k);
    return w;
  };
  uint32_t cur = chunk(0), nxt = chunk(32);
  int prev = 0;
  // Step u's slot and bit from the bytes in `src` (its lane u mod 32).
  auto plan = [&](uint32_t src, int lane, int& slot, int& bit) {
    const int b = int(__shfl_sync(kFull, src, lane) >> (8 * n)) & 255;
    slot = (kOrder ? prev << 8 : 0) | ((256 | b) >> shift);
    bit = (b >> bitpos) & 1;
    prev = b;
  };
  // Step t's slot, bit and value read at ring entry t mod kA; the slot and
  // new value of a step done (fs, fv at its entry).
  int sl[kA], bt[kA], fs[kA];
  uint32_t rv[kA], fv[kA];
#pragma unroll
  for (int j = 0; j < kA; ++j) {
    plan(cur, j, sl[j], bt[j]);
    rv[j] = tab[sl[j]];
    fs[j] = -1;
    fv[j] = 0;
  }
  // Steps t0 .. t0 + 15 of the chunk at c0 = t0 & ~31 (kHi: the second
  // half); `guard`: a step past K or a lane past L stores nothing.
  auto half = [&](int t0, auto hi, auto guard) {
    constexpr int kH = decltype(hi)::value ? 16 : 0;
    int* out = dst + size_t(t0) * row8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = t0 + j, r = j % kA;
      uint32_t v = rv[r];
#pragma unroll
      for (int k = kA - 1; k >= 1; --k) {  // the latest writer wins
        const int i = (r - k + kA) % kA;
        v = sl[r] == fs[i] ? fv[i] : v;
      }
      const int p = pr.prob(v);
      const int bit = bt[r];
      const uint32_t nv = pr.next(v, p, bit);
      if (!decltype(guard)::value || (real && t < K)) {
        *out = bit ? p : (p << 16) | (kTotal - p);
        tab[sl[r]] = nv;
      }
      out += row8;
      fs[r] = sl[r];
      fv[r] = nv;
      // step t + kA: in this chunk's bytes or, past it, the next's
      plan(kH + j + kA < 32 ? cur : nxt, (kH + j + kA) & 31, sl[r], bt[r]);
      rv[r] = tab[sl[r]];  // after this step's store
    }
  };
  using No = std::false_type;
  using Yes = std::true_type;
  for (int c0 = 0; c0 < K; c0 += 32) {
    const uint32_t nn = chunk(c0 + 64);  // not read before the chunk's end
    if (full && c0 + 32 <= K) {
      half(c0, No(), No());
      half(c0 + 16, Yes(), No());
    } else {
      half(c0, No(), Yes());
      half(c0 + 16, Yes(), Yes());
    }
    cur = nxt;
    nxt = nn;
  }
}

// ---- L12: lane streams (words, off, len; M = 8K + 2) -> bytes [K, L] u8.

// A lane's stream: state s and its next words w (word pos) and w2 (word
// pos + 1), 0 at or past nw, read from the lane's ring of words in shared
// memory (ring slot (o + i) mod kRingW for word i, o the lane's first;
// the fills write 0 for the words at or past nw).
struct BitStream {
  uint16_t* ring;
  long long o;
  int nw, pos;
  uint32_t s, w, w2;
  // word i: the ring holds 0 for a word at or past nw
  __device__ __forceinline__ uint32_t word(int i) const {
    return uint32_t(ring[(o + i) & (kRingW - 1)]);
  }
  // Decodes one decision at probability p: both next states are computed
  // and the bit picks one, then the renorm takes w.  No branch: w2 is read
  // at every decision and taken at the next.
  __device__ __forceinline__ int bit(int p) {
    const uint32_t x = s & (kTotal - 1), q = s >> 15;
    const int b = x < uint32_t(p) ? 1 : 0;
    const uint32_t one = uint32_t(p) * q + x;
    const uint32_t zero = s - uint32_t(p) * (q + 1);
    const uint32_t t = b ? one : zero;
    const bool take = t < kAnsLow;
    s = take ? (t << 16) | w : t;
    pos += take;
    w = take ? w2 : w;
    w2 = word(pos + 1);
    return b;
  }
};

// The words [8 u, 8 u + 8) of `words` (16-byte aligned) into ring slots
// 8 u mod kRingW by cp.async, zeros before word 0 and at or past word
// `end` (a lane's end, inside the words; 0 for a lane with none): a fill
// reads nothing outside the words, and every ring slot a lane reads was
// written by a fill.
__device__ __forceinline__ void ring_fetch(uint16_t* ring,
                                           const uint16_t* words,
                                           long long end, long long u) {
  const long long w0 = 8 * u;
  const long long left = 2 * (end - w0);
  const int bytes = w0 < 0 || left <= 0 ? 0 : left >= 16 ? 16 : int(left);
  const unsigned d = static_cast<unsigned>(
      __cvta_generic_to_shared(ring + (w0 & (kRingW - 1))));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(bytes ? words + w0 : words), "r"(bytes)
               : "memory");
}

// A slot update on its way: the slot and its value so far.
struct Upd {
  uint32_t* at;
  uint32_t v;
};

__device__ __forceinline__ uint4 ld4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// L12 at order 0: the lane's one row in shared memory, node k at slot k.
// A decision reads the four grandchildren of its node's chosen child (16
// bytes) as soon as its bit is known, a decision before they are needed;
// the row's first 8 slots for the next byte are read at decision 5, after
// the stores of decisions 0-2.  F and U: the updates on their way (F
// final, stored at the next decision; U after dnext1), dummies on slot 0
// first.
template <class P>
__device__ __forceinline__ void decode_o0(const P& pr, BitStream& st,
                                          uint32_t* row, uint8_t* dst,
                                          const uint16_t* words,
                                          long long end, long long& fu,
                                          int K, int L) {
  uint4 h0 = ld4(row), h1 = ld4(row + 4);
  Upd F{row, 0u}, U{row, 0u};
  for (int t = 0; t < K; ++t) {
    if (8 * fu < st.o + st.pos + kRingAhead)
      ring_fetch(st.ring, words, end, fu++);
    cp_async_commit();
    cp_async_wait<6>();
    int node = 1;
    uint32_t v = h0.y, c0 = h0.z, c1 = h0.w;
    int p = pr.dprob(v);
    uint4 gc = h1;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int b = st.bit(p);
      *F.at = F.v;
      F = Upd{U.at, pr.dnext2(U.v)};
      U = Upd{row + node, pr.dnext1(v, p, b)};
      node = 2 * node + b;
      v = b ? c1 : c0;
      p = pr.dprob(v);
      if (d < 6) {
        c0 = b ? gc.z : gc.x;
        c1 = b ? gc.w : gc.y;
      }
      if (d < 5) gc = ld4(row + 4 * node);
      if (d == 5) {
        h0 = ld4(row);
        h1 = ld4(row + 4);
      }
    }
    dst[size_t(t) * L] = uint8_t(node & 255);
  }
}

template <class P, int kOrder>
__global__ void __launch_bounds__(kBitSetup, 1)
lane_bit_decode_kernel(const uint16_t* __restrict__ words,
                       const long long* __restrict__ off,
                       const int* __restrict__ len, uint8_t* __restrict__ out,
                       uint32_t* __restrict__ tables, P pred, int K, int L,
                       long long W) {
  // a lane's shared slots: order 0 its row, order 1 its rows' heads
  constexpr int kLaneSlots = kOrder ? 256 * kHeadSlots : kRowSlots;
  static_assert(kBitDLanes * 32 <= kBitSetup, "a warp a lane");
  static_assert(kRingAhead + 16 <= kRingW, "a unit never overwrites a word "
                "not yet taken");
  extern __shared__ uint4 bit_smem[];
  P pr = pred;
  uint32_t* heads = pr.bind(bit_smem);
  const uint32_t v0 = pr.dinit();
  for (int i = threadIdx.x; i < kBitDLanes * kLaneSlots; i += kBitSetup)
    heads[i] = v0;
  __syncthreads();
  // lane n on thread 0 of warp n, alone in its warp
  const int n = threadIdx.x >> 5, l = blockIdx.x * kBitDLanes + n;
  if ((threadIdx.x & 31) || n >= kBitDLanes || l >= L) return;
  uint32_t* head = heads + n * kLaneSlots;
  const long long o = off[l], M = 8LL * K + 2;
  const long long a = o >= 0 && o < W ? min(min((long long)len[l], M), W - o)
                                      : 0;
  BitStream st;
  st.nw = int(a > 0 ? a : 0);
  uint16_t* ring = reinterpret_cast<uint16_t*>(heads + kBitDLanes *
                                               kLaneSlots) + n * kRingW;
  st.ring = ring;
  st.o = o;
  // the ring: the units holding words o .. o + kRingAhead first, then a
  // unit a byte step while fewer than kRingAhead words lie ahead; one
  // group a byte step, and the groups of the last 6 steps may be in
  // flight (they hold words past pos + 16, and a step reads up to pos + 9)
  long long fu = o >> 3;
  const long long end = st.nw ? o + st.nw : 0;
  for (; 8 * fu < o + kRingAhead; ++fu) ring_fetch(ring, words, end, fu);
  cp_async_commit();
  cp_async_wait<0>();
  const uint16_t* src = words + (st.nw ? o : 0);
  st.s = (st.nw > 0 ? uint32_t(src[0]) << 16 : 0u) |
         (st.nw > 1 ? uint32_t(src[1]) : 0u);
  st.w = st.nw > 2 ? uint32_t(src[2]) : 0u;
  st.w2 = st.word(3);
  st.pos = 2;
  uint8_t* dst = out + l;
  if constexpr (kOrder == 0) {
    decode_o0(pr, st, head, dst, words, end, fu, K, L);
    return;
  }
  uint32_t* body = tables + size_t(l) * kCtxSlots;
  int ctx = 0;
  // The last byte's updates of decisions 6 (its value final) and 7 (after
  // dnext1); the first byte's are dummies on head slot 0, never read.
  Upd f6{head, 0u}, u7{head, 0u};
  for (int t = 0; t < K; ++t) {
    if (8 * fu < o + st.pos + kRingAhead) ring_fetch(ring, words, end, fu++);
    cp_async_commit();
    cp_async_wait<6>();
    uint32_t* hrow = head + ctx * kHeadSlots;
    uint32_t* brow = body + ctx * kBodySlots;
    const uint4 h0 = ld4(hrow), h1 = ld4(hrow + 4);
    const uint4 a0 = ld4(brow), a1 = ld4(brow + 4), a2 = ld4(brow + 8),
                a3 = ld4(brow + 12), a4 = ld4(brow + 16), a5 = ld4(brow + 20);
    uint32_t v, c0, c1;
    int p;
    auto kids = [&](uint32_t x0, uint32_t x1) {
      c0 = x0;
      c1 = x1;
    };
    auto down = [&](int b) {  // the child, then its prediction
      v = b ? c1 : c0;
      p = pr.dprob(v);
    };
    // d0: node 1
    v = h0.y;
    p = pr.dprob(v);
    kids(h0.z, h0.w);
    const int b0 = st.bit(p);
    const Upd f7{u7.at, pr.dnext2(u7.v)};
    *f6.at = f6.v;
    const Upd u0{hrow + 1, pr.dnext1(v, p, b0)};
    down(b0);
    // d1: node 2 + b0
    kids(b0 ? h1.z : h1.x, b0 ? h1.w : h1.y);
    const int b1 = st.bit(p);
    *f7.at = f7.v;
    const Upd f0{u0.at, pr.dnext2(u0.v)};
    const Upd u1{hrow + 2 + b0, pr.dnext1(v, p, b1)};
    down(b1);
    // d2: node 4 + 2 b0 + b1; its children are in line A
    const int b2 = st.bit(p);
    *f0.at = f0.v;
    const Upd f1{u1.at, pr.dnext2(u1.v)};
    const Upd u2{hrow + 4 + 2 * b0 + b1, pr.dnext1(v, p, b2)};
    const int j3 = 4 * b0 + 2 * b1 + b2;  // depth-3 node 8 + j3
    const uint32_t* pair = brow + kPairAt + kPair * j3;
    const uint4 q0 = ld4(pair), q1 = ld4(pair + 4), q2 = ld4(pair + 8),
                q3 = ld4(pair + 12), q4 = ld4(pair + 16), q5 = ld4(pair + 20),
                q6 = ld4(pair + 24);
    {
      const uint4 x = b0 ? a1 : a0;  // nodes 8 + 4 b0 ..
      const uint32_t y0 = b1 ? x.z : x.x, y1 = b1 ? x.w : x.y;
      v = b2 ? y1 : y0;
      p = pr.dprob(v);
      const uint4 z = b0 ? (b1 ? a5 : a4) : (b1 ? a3 : a2);  // its children
      kids(b2 ? z.z : z.x, b2 ? z.w : z.y);
    }
    // d3: node 8 + j3
    const int b3 = st.bit(p);
    *f1.at = f1.v;
    const Upd f2{u2.at, pr.dnext2(u2.v)};
    const Upd u3{brow + j3, pr.dnext1(v, p, b3)};
    down(b3);
    // the subtree of node m = 16 + 2 j3 + b3: half b3 of the pair region
    const uint32_t Q[28] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z,
                            q1.w, q2.x, q2.y, q2.z, q2.w, q3.x, q3.y,
                            q3.z, q3.w, q4.x, q4.y, q4.z, q4.w, q5.x,
                            q5.y, q5.z, q5.w, q6.x, q6.y, q6.z, q6.w};
    uint32_t H[14];
#pragma unroll
    for (int i = 0; i < 14; ++i) H[i] = b3 ? Q[14 + i] : Q[i];
    kids(H[0], H[1]);
    // d4: node m
    const int b4 = st.bit(p);
    *f2.at = f2.v;
    const Upd f3{u3.at, pr.dnext2(u3.v)};
    const Upd u4{brow + 8 + 2 * j3 + b3, pr.dnext1(v, p, b4)};
    down(b4);
    uint32_t* half = brow + kPairAt + kPair * j3 + 14 * b3;
    kids(b4 ? H[4] : H[2], b4 ? H[5] : H[3]);
    uint32_t D[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) D[i] = b4 ? H[10 + i] : H[6 + i];
    // d5: node 2m + b4
    const int b5 = st.bit(p);
    *f3.at = f3.v;
    const Upd f4{u4.at, pr.dnext2(u4.v)};
    const Upd u5{half + b4, pr.dnext1(v, p, b5)};
    down(b5);
    kids(b5 ? D[2] : D[0], b5 ? D[3] : D[1]);
    // d6: node 4m + 2 b4 + b5
    const int b6 = st.bit(p);
    *f4.at = f4.v;
    const Upd f5{u5.at, pr.dnext2(u5.v)};
    const Upd u6{half + 2 + 2 * b4 + b5, pr.dnext1(v, p, b6)};
    down(b6);
    // d7: node 8m + 4 b4 + 2 b5 + b6
    const int b7 = st.bit(p);
    *f5.at = f5.v;
    f6 = Upd{u6.at, pr.dnext2(u6.v)};
    u7 = Upd{half + 6 + 4 * b4 + 2 * b5 + b6, pr.dnext1(v, p, b7)};
    const int byte = b0 << 7 | b1 << 6 | b2 << 5 | b3 << 4 | b4 << 3 |
                     b5 << 2 | b6 << 1 | b7;
    dst[size_t(t) * L] = uint8_t(byte);
    ctx = byte;
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
  if (kind == 2 &&
      (!fsm || S < 1 || S > kMaxStates || start < 0 || start >= S))
    return false;
  return kind >= 0 && kind <= 2;
}

// Calls f(pred, order, smem) with the predictor of `kind` and the order as
// compile-time constants and the shared memory of its FSM table (bytes);
// order 1 first fills the tables with the kernel's (kDecode) initial slot.
template <bool kDecode, class F>
int bit_dispatch(int kind, int order, int r0, int r1, const int* fsm, int S,
                 int start, uint32_t* tables, int L, cudaStream_t stream,
                 F&& f) {
  auto run = [&](auto pred) {
    using P = decltype(pred);
    const int smem = P::kTable ? 16 * fsm_units(S) : 0;
    if (order == 0) return f(pred, std::integral_constant<int, 0>(), smem);
    const size_t n4 = size_t(L) * kCtxSlots / 4;
    const size_t ctas = (n4 + kFillThreads - 1) / kFillThreads;
    bit_fill_kernel<P, kDecode>
        <<<int(ctas < kFillCtas ? ctas : kFillCtas), kFillThreads, 0,
           stream>>>(reinterpret_cast<uint4*>(tables), n4, pred);
    return f(pred, std::integral_constant<int, 1>(), smem);
  };
  if (kind == 0) return run(PredS{});
  if (kind == 1)
    return run(PredSS{r0 < kMaxRate ? r0 : kMaxRate,
                      r1 < kMaxRate ? r1 : kMaxRate});
  return run(PredSF{fsm, S, uint32_t(start)});
}

// Launches `kernel` with `smem` bytes of dynamic shared memory.
template <class Kern, class... Args>
int bit_launch(Kern kernel, int ctas, int smem, cudaStream_t stream,
               Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<ctas, kBitSetup, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// L11.  kind: 0 s, 1 ss (rates r0, r1), 2 sf (fsm [3][S], S <= 32,768,
// start state).  tables: order 1's [L][65536] u32 scratch (16-byte
// aligned), else null.
int trc_lane_bit_model(const uint8_t* cols, int* probs, uint32_t* tables,
                       const int* fsm, int K, int L, int order, int kind,
                       int r0, int r1, int S, int start,
                       cudaStream_t stream) {
  if (!bit_fits(K, L, order, kind, tables, fsm, r0, r1, S, start))
    return int(cudaErrorInvalidValue);
  return bit_dispatch<false>(
      kind, order, r0, r1, fsm, S, start, tables, L, stream,
      [&](auto pred, auto ord, int smem) {
        constexpr int O = decltype(ord)::value;
        return bit_launch(lane_bit_model_kernel<decltype(pred), O>,
                          (L + kBitLanes - 1) / kBitLanes,
                          smem + (O ? 0 : kBitLanes * kBitStride * 4),
                          stream, cols, probs, tables, pred, K, L);
      });
}

// L12: L3's stream arguments (words 16-byte aligned), then L11's.
int trc_lane_bit_decode(const uint16_t* words, const long long* off,
                        const int* len, uint8_t* out, uint32_t* tables,
                        const int* fsm, int K, int L, int W, int order,
                        int kind, int r0, int r1, int S, int start,
                        cudaStream_t stream) {
  if (W < 0 || reinterpret_cast<uintptr_t>(words) % 16 ||
      !bit_fits(K, L, order, kind, tables, fsm, r0, r1, S, start))
    return int(cudaErrorInvalidValue);
  return bit_dispatch<true>(
      kind, order, r0, r1, fsm, S, start, tables, L, stream,
      [&](auto pred, auto ord, int smem) {
        constexpr int O = decltype(ord)::value;
        const int slots = O ? 256 * kHeadSlots : kRowSlots;
        return bit_launch(lane_bit_decode_kernel<decltype(pred), O>,
                          (L + kBitDLanes - 1) / kBitDLanes,
                          smem + kBitDLanes * (slots * 4 + kRingW * 2),
                          stream, words, off,
                          len, out, tables, pred, K, L, (long long)W);
      });
}

}  // extern "C"
