// Flagship rANS kernels (codec rans-cdf-o0-p) for Hopper, sm_90a.
//
// Replaces the five Pallas TPU kernels of
// turborc_tpu/ops/pallas/rans_kernel.py:
//   model_kernel   <- _make_model_kernel  (:807)  forward model pass (K2)
//   coder_kernel   <- _make_coder_kernel  (:883)  backward rANS pass (K3)
//   place_count_kernel + place_kernel
//                  <- _make_place_kernel  (:1017) stream compaction (K4)
//   decode_kernel  <- _make_decode_kernel (:407)  o0 share-span decode (K1)
//   decode_x2_kernel <- _make_decode_kernel_x2 (:569)  split-state decode (K5)
//
// K1, K2 and K5: one CTA = one 128-lane group = 4 warps, one thread per
// lane, and a loop over byte steps inside the CTA (the TPU grid's
// sequential dimension).  Each lane is a serial state machine; lanes of a
// group are coupled only by (a) the lane-order rank of the lanes that read
// a stream word at a step (the decoders: warp ballot + popc and a prefix
// over the 4 warps) and (b) the re-join of `share`-lane model copies
// (XOR-partner sums: warp shuffles for share <= 32, shared memory above).
// The TPU's barrel gather, register queue, VMEM window, packed-pair lo
// rows and f32 long division are not reproduced: the card has gathers,
// ballots and integer division.  The three share one byte step of the
// model (the search, lookup, row layout and ring of rans_common.cuh, which
// the o1 decoder K6 shares too), measured against an older design
// (PERF.md sections 6 and 7):
// - Tables in registers.  A lane's 16-entry hi table and lo row are
//   indexed by unrolled constants only: a data-dependent index moves an
//   array to the stack (128 B, a local-memory access per entry, about a
//   third of the old byte step), so the lookup picks entries with a tree
//   of selects and the decoders' search sums flags as a tree.
// - Shared memory holds only what adapts: per-lane lo rows below arows
//   and their re-join start copies; the static rows, which are the same
//   for all lanes of a group, once.  At a4 that is 16 + 16 KB.  A lane's
//   row is two 16-byte halves, each half of a row stored for all 128
//   lanes in a row, so the 16-byte loads and stores of a warp meet no
//   bank conflict.
// - Re-joins sum the hi table and kBatch lo rows at once, so their
//   shuffles and loads overlap.
// - No device-memory load on a byte's chain.  The decoders stage the
//   stream in a ring of kRingWords words per stream set, filled by
//   cp.async and topped up by the CTA after every kRingEvery-th fetch's
//   barrier, at least that many fetches before its words are read (the
//   TPU kernel stages the same words in a VMEM window and a register
//   queue, turborc_tpu/ops/pallas/rans_kernel.py:377-440).  K2 stages its
//   input bytes the same way: kColSteps byte steps at a time, requested
//   one stage ahead.
// - One thread per lane.  Teams of 2, 4 and 8 threads a lane, each thread
//   with a share of every table's entries, were timed on the decoders
//   (PERF.md section 6) and were up to 9%, 15% and 60% slower: once the
//   tables are in registers, more warps a group only repeat the lane's
//   state step, ballot and fetch in every thread of a team and add the
//   team's shuffles.
// K2 knows every symbol in advance, so it has no search, no fetch and, for
// share <= 32, no barrier but the stage's one every kColSteps bytes.  A
// decoder's fetch adds a ballot, a barrier, a rank prefix and a ring load
// to each nibble.
// What bounds K1, K2 and K5 now: neither bytes nor operations at the
// card's peak, but the chain of dependent steps of a byte on 4 warps an SM
// (the decoders: search, lookup, state, ballot, barrier, rank, word; K2:
// lookup, row load, update, row store), and 68 of the 132 SMs hold no
// group.  In K2 at share 8 the re-joins take about 45% of the time, the
// table updates and the row loads and stores about 22% each
// (tools/decode_probe.py --kernel model, PERF.md section 7); halving the
// re-join's shuffles saved 2%, so they are not its limit.
//
// K3: one thread per lane, lanes independent, the dependent state chain
// over every slot, on CTAs of kCoderLanes lanes that spread over every SM.
// Each CTA stages its lanes' probs in shared memory by cp.async, stages
// requested two ahead, divides by a reciprocal from a table in shared
// memory, and loads a slot's probs and reciprocal a slot ahead of the
// state chain (see coder_kernel).  Measured against the one-CTA-a-group
// design that loaded probs from device memory at every slot (PERF.md
// section 6): that load set the pace (5.6 ms, 1.0 ms without it); once it
// was staged, the hardware division took half of what was left, and then
// the two dependent shared loads of a slot.  What bounds it now: neither
// bytes (0.36 ms at id 57's shape) nor operations, but the chain a slot on
// 2 warps an SM (about 86 cycles a slot).
//
// K4 is a stream compaction: a word's position is 256 + the emits before
// it in slot-major, lane-minor order within its group.  The TPU kernel
// walks the slots in order because its grid runs in order; here every SM
// takes chunks of kPlaceChunk slots of one group.  place_count_kernel
// counts each chunk's emits (16-byte loads of emit); place_kernel sums the
// counts of its group's earlier chunks (its base) and of all of them (the
// group's length), scans its chunk's emit masks once across the CTA, and
// writes each emitting lane's word at 256 + base + its rank.  It reads
// words only where a lane emits, and zero-fills its share of the group's
// tail with 16-byte stores, so the tail (most of the bytes) is spread over
// the whole grid.  Two launches and two barriers a CTA, none per slot.
// What bounds it: bytes (emit read twice, the emitting words, the
// streams written once); at id 57's shape it moves them at about 37% of
// the card's memory rate.
//
// Rules kept by every kernel: __syncthreads() only where all threads of the
// CTA arrive (every condition around one depends on the byte index and the
// geometry, never on data); no loop bound taken from data; every stream read
// is bounds-checked, so a corrupt stream decodes to wrong bytes, never to an
// out-of-bounds access or a hang.  Each C entry point returns
// cudaGetLastError() after its launch.

#include <climits>

#include "rans_common.cuh"

namespace {

struct Geo {
  int share, sync, lsync, arows, srows, hrows, rate;
};

constexpr int kColSteps = 64;                 // K2: byte steps a cols stage
static_assert((kColSteps & (kColSteps - 1)) == 0, "kColSteps: 2^n");

// Dynamic shared memory of K1, K2 and K5, as byte offsets that the wrapper
// computes (ops/rans_kernel.py decode_launch, model_launch) and the C
// entry checks.  `stage` holds the decoders' rings or K2's cols stage; K2
// has no rank counts.
struct Carve {
  int stage, lo, st, fixed, red, rank;
};

struct Bufs {
  unsigned char* stage;  // [nstates][kRingWords] words, or [2 kColSteps][128]
  uint16_t* lo;     // [arows][2 halves][128 lanes][8] adaptive lo rows
  uint16_t* st;     // [arows][2][128][8] their re-join start copies
  uint16_t* fixed;  // [16 - arows][16] static lo rows, one copy per group
  int* red;         // [kWarps][16] set sums across warps
  uint8_t* rank;    // [2][nstates][kWarps] lanes needing a word, a warp
};

__device__ __forceinline__ Bufs carve(const Carve& c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Bufs b;
  b.stage = smem_raw + c.stage;
  b.lo = reinterpret_cast<uint16_t*>(smem_raw + c.lo);
  b.st = reinterpret_cast<uint16_t*>(smem_raw + c.st);
  b.fixed = reinterpret_cast<uint16_t*>(smem_raw + c.fixed);
  b.red = reinterpret_cast<int*>(smem_raw + c.red);
  b.rank = smem_raw + c.rank;
  return b;
}

// The warm tables hi [16, G], lo [16, 16, G] int32 of group g: hi in
// registers; adaptive lo rows per lane (and their start copies); static
// rows once.  The caller's barrier publishes the rows.
__device__ __forceinline__ void load_tables(const int* __restrict__ hi_tbl,
                                            const int* __restrict__ lo_tbl,
                                            int G, int g, const Geo& m,
                                            const Bufs& b, int (&hi)[16],
                                            int (&start_hi)[16]) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    hi[e] = hi_tbl[e * G + g];
    start_hi[e] = hi[e];
  }
  for (int h = 0; h < m.arows; ++h) {
    int v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = lo_tbl[(h * 16 + e) * G + g];
    st_row(lane_row(b.lo, h), kHalf, v);
    if (m.share > 1) st_row(lane_row(b.st, h), kHalf, v);
  }
  for (int q = lane; q < (16 - m.arows) * 16; q += kLanes)
    b.fixed[q] = uint16_t(lo_tbl[(m.arows * 16 + q) * G + g]);
}

// ---- K1 and K5: the decoders, one thread per lane, on the search, lookup,
// row layout and ring of rans_common.cuh.
//
// The byte step shared by K1 (NS = 1: one state, hi then lo nibble, a
// fetch after each) and K5 (NS = 2: state 0 / set 0 carry the hi nibble,
// state 1 / set 1 the lo nibble, one fetch of both after the two steps).
// streams [NS, G, R, 128] int32 -> bytes [K, G, 128] u8, final states
// [NS, G, 128].
template <int NS>
__device__ __forceinline__ void decode_lanes(
    const int* __restrict__ streams, const int* __restrict__ hi_tbl,
    const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
    int* __restrict__ fstate, int K, int G, int R, Geo m, Carve c) {
  const Bufs b = carve(c);
  const int g = blockIdx.x, lane = threadIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + lane;
  const int limit = R * kLanes;

  Ring r[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k)
    ring_init(r[k], streams + (size_t(k) * G + g) * R * kLanes,
              reinterpret_cast<int*>(b.stage) + k * kRingWords, limit);
  cp_async_commit();
  uint32_t state[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k)
    state[k] = (uint32_t(r[k].src[lane]) << 16) |
               uint32_t(r[k].src[kLanes + lane]);

  int hi[16], start_hi[16];
  load_tables(hi_tbl, lo_tbl, G, g, m, b, hi, start_hi);
  cp_async_wait<0>();
  __syncthreads();

  uint8_t* out_t = out + col;  // byte t of this lane
  int buf = 0, nfetch = 0;
  for (int t = 0; t < K; ++t) {
    uint32_t value = state[0] & (kTotal - 1);
    const int hs = search_tree(hi, int(value));
    int low_h, fr_h;
    lookup_pick(hi, hs, low_h, fr_h);
    state[0] = uint32_t(fr_h) * (state[0] >> 15) + value - uint32_t(low_h);
    const bool adapt = hs < m.arows;
    uint16_t* rp = adapt ? lane_row(b.lo, hs) : b.fixed + (hs - m.arows) * 16;
    const int half = adapt ? kHalf : 8;
    int row[16];
    unsigned bal[NS];
    if constexpr (NS == 1) {
      fetch_post(state, bal, b.rank, buf, nfetch);
      ld_row(rp, half, row);
      cdf_update(hi, low_h, m.rate);
      fetch_take(state, bal, r, limit, b.rank, buf, nfetch);
    } else {
      ld_row(rp, half, row);
    }
    value = state[NS - 1] & (kTotal - 1);
    const int ls = search_tree(row, int(value));
    int low_l, fr_l;
    lookup_pick(row, ls, low_l, fr_l);
    state[NS - 1] = uint32_t(fr_l) * (state[NS - 1] >> 15) + value -
                    uint32_t(low_l);
    fetch_post(state, bal, b.rank, buf, nfetch);
    // what needs no word of this fetch: the model's updates and re-joins
    if constexpr (NS == 2) cdf_update(hi, low_h, m.rate);
    cdf_update(row, low_l, m.rate);
    if (adapt) st_row(rp, kHalf, row);
    *out_t = uint8_t((hs << 4) | ls);
    out_t += plane;
    rejoin_batches_after(t, m, b, hi, start_hi);
    fetch_take(state, bal, r, limit, b.rank, buf, nfetch);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < NS; ++k) fstate[k * plane + col] = int(state[k]);
}

// ---- K1: decode.  streams [G, R, 128] int32 (rows 0/1 = initial state
// hi16/lo16, words from 256 in consumption order) -> bytes [K, G, 128] u8,
// final states [G, 128].
__global__ void __launch_bounds__(kLanes, 1)
decode_kernel(const int* __restrict__ streams, const int* __restrict__ hi_tbl,
              const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
              int* __restrict__ fstate, int K, int G, int R, Geo m,
              Carve c) {
  decode_lanes<1>(streams, hi_tbl, lo_tbl, out, fstate, K, G, R, m, c);
}

// ---- K5: split-state decode.  streams [2, G, R, 128] int32 (set 0 feeds
// state 0, which decodes hi nibbles; set 1 feeds state 1, lo nibbles; each
// set is laid out as K1's) -> bytes [K, G, 128] u8, final states
// [2, G, 128].  One shared model and re-join, as K1's.  The lo search on
// state 1 needs only the hi symbol, not state 0's fetch, so both states
// step before one fetch of both sets.
__global__ void __launch_bounds__(kLanes, 1)
decode_x2_kernel(const int* __restrict__ streams,
                 const int* __restrict__ hi_tbl,
                 const int* __restrict__ lo_tbl, uint8_t* __restrict__ out,
                 int* __restrict__ fstate, int K, int G, int R, Geo m,
                 Carve c) {
  decode_lanes<2>(streams, hi_tbl, lo_tbl, out, fstate, K, G, R, m, c);
}

// ---- K2: forward model pass on the decoders' byte step.  cols [K, G, 128]
// u8 -> probs [2K, G, 128] int32 = (low << 16) | freq per nibble slot (hi
// slot 2t, lo slot 2t+1).  One model for one or two stream sets.
//
// The group's bytes are staged in a ring of 2 kColSteps byte steps x 128
// lanes: at byte t % kColSteps == 0 every thread waits for its copies of
// the stage that starts at t (requested kColSteps bytes earlier), the
// barrier publishes them and frees the stage before, and the CTA requests
// the stage that starts at t + kColSteps into it.

// The CTA requests byte steps [t0, min(t0 + kColSteps, K)) of the group
// whose bytes start at src, 16 bytes (16 lanes) a copy.
__device__ __forceinline__ void cols_stage(unsigned char* ring,
                                           const uint8_t* src, int t0, int K,
                                           size_t plane) {
  constexpr int kCopies = kLanes / 16;  // copies a byte step
  for (int q = threadIdx.x; q < kColSteps * kCopies; q += kLanes) {
    const int t = t0 + q / kCopies, part = (q % kCopies) * 16;
    if (t < K)
      cp_async16(ring + (t & (2 * kColSteps - 1)) * kLanes + part,
                 src + size_t(t) * plane + part);
  }
}

__global__ void __launch_bounds__(kLanes, 1)
model_kernel(const uint8_t* __restrict__ cols, const int* __restrict__ hi_tbl,
             const int* __restrict__ lo_tbl, int* __restrict__ probs, int K,
             int G, Geo m, Carve c) {
  const Bufs b = carve(c);
  const int g = blockIdx.x, lane = threadIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const uint8_t* src = cols + size_t(g) * kLanes;
  cols_stage(b.stage, src, 0, K, plane);
  cp_async_commit();
  int hi[16], start_hi[16];
  load_tables(hi_tbl, lo_tbl, G, g, m, b, hi, start_hi);

  int* out = probs + size_t(g) * kLanes + lane;  // slot 2t of this lane
  for (int t = 0; t < K; ++t) {
    if ((t & (kColSteps - 1)) == 0) {  // also publishes the tables at t = 0
      cp_async_wait<0>();
      __syncthreads();
      cols_stage(b.stage, src, t + kColSteps, K, plane);
      cp_async_commit();
    }
    const int sym = b.stage[(t & (2 * kColSteps - 1)) * kLanes + lane];
    const int hs = sym >> 4, ls = sym & 15;
    int low_h, fr_h;
    lookup_pick(hi, hs, low_h, fr_h);
    const bool adapt = hs < m.arows;
    uint16_t* rp = adapt ? lane_row(b.lo, hs) : b.fixed + (hs - m.arows) * 16;
    int row[16];
    ld_row(rp, adapt ? kHalf : 8, row);
    cdf_update(hi, low_h, m.rate);
    int low_l, fr_l;
    lookup_pick(row, ls, low_l, fr_l);
    cdf_update(row, low_l, m.rate);
    if (adapt) st_row(rp, kHalf, row);
    out[0] = (low_h << 16) | fr_h;
    out[plane] = (low_l << 16) | fr_l;
    out += 2 * plane;
    rejoin_batches_after(t, m, b, hi, start_hi);
  }
  cp_async_wait<0>();
}

// ---- K3: backward rANS pass.  probs [S, L] -> words [S, L] int32 (the low
// 16 bits of the state at every slot), emit [S, L] u8, flush states [L].
// Lanes are independent, so a CTA takes kCoderLanes of them, one thread a
// lane, and a block's CTAs spread over every SM (128 at 64 groups).  The
// CTA stages its lanes' probs in shared memory, kCoderSlots slots a stage,
// walking backward: stage j is slots [j D, min((j + 1) D, S)) (the top one
// may be partial), in buffer j % kCoderBufs, and stage j - kCoderBufs + 1 is
// requested while stage j is coded.  So the state chain waits on device
// memory only at a stage boundary, never for a slot's load.  A slot's probs
// for the CTA's lanes are contiguous (kCoderLanes * 4 bytes, slots L * 4
// bytes apart): 16-byte cp.async copies, one group a stage.  The division
// by freq is a multiply by its reciprocal from a table of all 2^15 of them
// in shared memory (div_magic), which the CTA fills while its first stages
// arrive: the hardware `/` (a reciprocal and two corrections on the state
// chain) took half of the kernel's time, and working the reciprocal out
// at every slot (two divisions, off the chain) twice as much as `/`.
constexpr int kCoderLanes = 64;  // lanes (threads) a CTA
constexpr int kCoderSlots = 64;  // slots a stage
constexpr int kCoderBufs = 3;    // stage buffers
constexpr int kCoderCopies = kCoderLanes / 4;  // 16-byte copies a slot
constexpr int kCoderStageBytes = kCoderBufs * kCoderSlots * kCoderLanes * 4;
constexpr int kCoderSmem = kCoderStageBytes + kTotal * 4;  // + the table
static_assert(kLanes % kCoderLanes == 0, "a group is whole CTAs");
static_assert(kCoderBufs >= 2, "one stage in flight at least");
static_assert(kCoderSmem <= kSmemMax, "K3's stages and table fit a CTA");

// The CTA requests stage j of its lanes (from lane0) into buf.
__device__ __forceinline__ void coder_stage(int* buf,
                                            const int* __restrict__ probs,
                                            int j, int S, size_t L,
                                            size_t lane0) {
  const int t0 = j * kCoderSlots, n = min(kCoderSlots, S - t0);
  for (int q = threadIdx.x; q < n * kCoderCopies; q += kCoderLanes) {
    const int s = q / kCoderCopies, part = (q % kCoderCopies) * 4;
    cp_async16(buf + s * kCoderLanes + part,
               probs + size_t(t0 + s) * L + lane0 + part);
  }
}

__global__ void __launch_bounds__(kCoderLanes)
coder_kernel(const int* __restrict__ probs, const int* __restrict__ init,
             int* __restrict__ words, uint8_t* __restrict__ emit,
             int* __restrict__ fstate, int S, int L, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* stage = reinterpret_cast<int*>(smem_raw);  // [bufs][slots][lanes]
  // m of div_magic for freq = 1 .. 2^15, at freq - 1
  uint32_t* mtab = reinterpret_cast<uint32_t*>(smem_raw + kCoderStageBytes);
  constexpr int kStage = kCoderSlots * kCoderLanes;
  const size_t lane0 = size_t(blockIdx.x) * kCoderLanes;
  const size_t lane = lane0 + threadIdx.x;
  // the top kCoderBufs - 1 stages, one copy group each (empty below 0)
#pragma unroll
  for (int k = 0; k < kCoderBufs - 1; ++k) {
    const int j = stages - 1 - k;
    if (j >= 0)
      coder_stage(stage + (j % kCoderBufs) * kStage, probs, j, S, L, lane0);
    cp_async_commit();
  }
  for (int f = threadIdx.x; f < kTotal; f += kCoderLanes) {
    uint32_t m, l;
    div_magic(uint32_t(f + 1), m, l);
    mtab[f] = m;
  }
  uint32_t state = uint32_t(init[lane]);
  for (int j = stages - 1; j >= 0; --j) {
    // this thread's copies of stage j are complete, the barrier publishes
    // everyone's (and the table, at the first) and frees the buffer of
    // stage j + 1 for stage jn
    cp_async_wait<kCoderBufs - 2>();
    __syncthreads();
    const int jn = j - (kCoderBufs - 1);
    if (jn >= 0)
      coder_stage(stage + (jn % kCoderBufs) * kStage, probs, jn, S, L,
                  lane0);
    cp_async_commit();
    const int t0 = j * kCoderSlots;
    const int* ps = stage + (j % kCoderBufs) * kStage + threadIdx.x;
    int s = min(kCoderSlots, S - t0) - 1;
    int* wp = words + size_t(t0 + s) * L + lane;  // slot s of this lane
    uint8_t* ep = emit + size_t(t0 + s) * L + lane;
    // The loads run ahead of the state chain: slot s's probs and
    // reciprocal are in registers, slot s - 1's probs too, and the loop
    // requests slot s - 1's reciprocal and slot s - 2's probs (1 = freq 1
    // past the stage's first slot).  The table index is (freq - 1) mod
    // 2^15, so a freq outside [1, 2^15] gives a wrong word, never a read
    // outside the table.
    uint32_t pr1 = uint32_t(ps[s * kCoderLanes]);
    uint32_t pr2 = s > 0 ? uint32_t(ps[(s - 1) * kCoderLanes]) : 1u;
    uint32_t m1 = mtab[(pr1 - 1) & (kTotal - 1)];
#pragma unroll 4
    for (; s >= 0; --s) {
      const uint32_t pr = pr1, m = m1, freq = pr & 0xFFFFu;
      const uint32_t l = 32 - __clz(freq - 1);
      pr1 = pr2;
      m1 = mtab[(pr2 - 1) & (kTotal - 1)];
      pr2 = s > 1 ? uint32_t(ps[(s - 2) * kCoderLanes]) : 1u;
      const bool e = state >= (pr << 16);  // freq << 16
      *wp = int(state & 0xFFFFu);
      *ep = e ? 1 : 0;
      wp -= L;
      ep -= L;
      const uint32_t x = e ? state >> 16 : state;
      const uint32_t q = __umulhi(x << 1, m) >> l;  // x / freq
      // (q << 15) + (x - q * freq) + low
      state = x + (pr >> 16) + q * (kTotal - freq);
    }
  }
  fstate[lane] = int(state);
}

// ---- K4: placement.  words/emit [S, G, 128], flush states [G, 128] ->
// gstreams [G, R, 128] int32: rows 0/1 = flush state hi16/lo16, the
// emitting lanes' words from position 256 in slot-major, lane-minor order,
// zeros after; glens [G] = 256 + emitted words.  Chunk c of group g is
// slots [c kPlaceChunk, (c + 1) kPlaceChunk) and CTA c * G + g of both
// launches (neighbouring CTAs read neighbouring rows of emit).  A slot's
// 128 emit bytes are kSegs segments of 16 lanes, one 16-byte load each.
constexpr int kPlaceChunk = 64;                 // slots a CTA
constexpr int kPlaceThreads = 256;              // threads a CTA
constexpr int kSegs = kLanes / 16;              // segments a slot
constexpr int kChunkSegs = kPlaceChunk * kSegs;
constexpr int kPlaceWarps = kPlaceThreads / 32;
static_assert(kChunkSegs == 2 * kPlaceThreads, "two segments a thread");

// The emit flags of 16 lanes (16 bytes at p, 16-byte aligned) as a mask,
// bit j = lane j emits.
__device__ __forceinline__ unsigned emit_mask(const uint8_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t f = __vcmpne4(w[k], 0u);  // 0xff a nonzero byte
    m |= ((f >> 7 & 1u) | (f >> 14 & 2u) | (f >> 21 & 4u) | (f >> 28 & 8u))
         << (4 * k);
  }
  return m;
}

// The masks of the two segments of this thread in chunk c (segment k of
// the chunk is slot k / kSegs, lanes 16 (k % kSegs) ...; slots at or past
// S emit nothing).
__device__ __forceinline__ void chunk_masks(const uint8_t* __restrict__ emit,
                                            int c, int g, int S, int G,
                                            unsigned (&m)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = threadIdx.x + h * kPlaceThreads;
    const int t = c * kPlaceChunk + k / kSegs;
    m[h] = t < S ? emit_mask(emit + (size_t(t) * G + g) * kLanes +
                             (k % kSegs) * 16)
                 : 0u;
  }
}

// Count: counts[g * C + c] = the emits of chunk c of group g.
__global__ void __launch_bounds__(kPlaceThreads)
place_count_kernel(const uint8_t* __restrict__ emit, int* __restrict__ counts,
                   int S, int G, int C) {
  __shared__ int part[kPlaceWarps];
  const int g = blockIdx.x % G, c = blockIdx.x / G;
  unsigned m[2];
  chunk_masks(emit, c, g, S, G, m);
  const unsigned n = __reduce_add_sync(kFull, __popc(m[0]) + __popc(m[1]));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = int(n);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kPlaceWarps; ++w) s += part[w];
    counts[size_t(g) * C + c] = s;
  }
}

// Place: the chunk's base and the group's length from the counts, one
// CTA-wide scan of the chunk's masks, the words of the emitting lanes,
// and the CTA's share of the zero tail.
__global__ void __launch_bounds__(kPlaceThreads)
place_kernel(const int* __restrict__ words, const uint8_t* __restrict__ emit,
             const int* __restrict__ state, const int* __restrict__ counts,
             int* __restrict__ gstreams, int* __restrict__ glens, int S,
             int G, int R, int C) {
  __shared__ int wscan[kPlaceWarps], wbase[kPlaceWarps], wlen[kPlaceWarps];
  __shared__ uint16_t mask[kChunkSegs];
  __shared__ uint16_t pre[kChunkSegs];  // emits before the segment, < 8192
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int g = blockIdx.x % G, c = blockIdx.x / G;
  int* out = gstreams + size_t(g) * R * kLanes;

  // Emits of the group before this chunk, and in all (sum over C counts).
  int before = 0, len = 0;
  for (int q = tid; q < C; q += kPlaceThreads) {
    const int n = counts[size_t(g) * C + q];
    len += n;
    before += q < c ? n : 0;
  }
  before = int(__reduce_add_sync(kFull, unsigned(before)));
  len = int(__reduce_add_sync(kFull, unsigned(len)));
  // The chunk's segments in order: this thread's first segment is segment
  // tid, its second tid + kPlaceThreads.  Both counts scan at once, packed
  // in 16 bits each (a half-chunk holds at most 4096 emits).
  unsigned m[2];
  chunk_masks(emit, c, g, S, G, m);
  const int own = __popc(m[0]) | (__popc(m[1]) << 16);
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (wl >= d) incl += v;
  }
  if (wl == 31) wscan[warp] = incl;
  if (wl == 0) {
    wbase[warp] = before;
    wlen[warp] = len;
  }
  __syncthreads();
  int off = 0, all = 0, base = 0;
  len = 0;
#pragma unroll
  for (int w = 0; w < kPlaceWarps; ++w) {
    off += w < warp ? wscan[w] : 0;
    all += wscan[w];
    base += wbase[w];
    len += wlen[w];
  }
  const int excl = off + incl - own;
  mask[tid] = uint16_t(m[0]);
  mask[tid + kPlaceThreads] = uint16_t(m[1]);
  pre[tid] = uint16_t(excl & 0xFFFF);
  pre[tid + kPlaceThreads] = uint16_t((all & 0xFFFF) + (excl >> 16));
  __syncthreads();

  // Scatter: thread = lane tid % 128 of the slots of parity tid / 128, so
  // a warp reads one slot's 32 neighbouring words, and only where a lane
  // emits.  Positions stay below 256 + S * 128 <= R * 128.
  const int lane = tid & (kLanes - 1), j = lane & 15;
  const int pos0 = 2 * kLanes + base;
  for (int s = tid / kLanes; s < kPlaceChunk; s += kPlaceThreads / kLanes) {
    const int k = s * kSegs + lane / 16;
    const unsigned mk = mask[k];
    if ((mk >> j) & 1u) {
      const size_t at = (size_t(c * kPlaceChunk + s) * G + g) * kLanes + lane;
      out[pos0 + pre[k] + __popc(mk & ((1u << j) - 1u))] = words[at];
    }
  }

  // The tail [z0, R * 128): ints up to the next 16-byte boundary by chunk
  // 0, the quads after it split evenly over the group's C chunks.
  const int z0 = 2 * kLanes + len, lim = R * kLanes;
  const int q0 = (z0 + 3) >> 2, q1 = lim >> 2;
  if (c == 0) {
    if (tid < kLanes) {
      const uint32_t st = uint32_t(state[size_t(g) * kLanes + tid]);
      out[tid] = int(st >> 16);
      out[kLanes + tid] = int(st & 0xFFFFu);
    }
    if (tid < 3 && z0 + tid < 4 * q0 && z0 + tid < lim) out[z0 + tid] = 0;
    if (tid == 0) glens[g] = z0;
  }
  const long long nq = q1 > q0 ? q1 - q0 : 0;
  const int a = q0 + int(nq * c / C), e = q0 + int(nq * (c + 1) / C);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int q = a + tid; q < e; q += kPlaceThreads)
    out4[q] = make_int4(0, 0, 0, 0);
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

// The checks K1, K2 and K5 share: one thread a lane, the geometry's
// cadences, and the carve the wrapper computed (ops/rans_kernel.py
// decode_launch / model_launch) against the region sizes the kernel
// needs: ordered, 16-byte aligned, within smem <= kSmemMax.  A stage of
// `stage` bytes, then the tables, then `rank` bytes.
bool carve_ok(const Geo& m, int threads, int smem, const Carve& c,
              int stage, int rank) {
  const int off[6] = {c.stage, c.lo, c.st, c.fixed, c.red, c.rank};
  const int size[6] = {stage,
                       m.arows * kLanes * 32,
                       (m.share > 1 ? m.arows : 0) * kLanes * 32,
                       (16 - m.arows) * 32,
                       m.share > 32 ? kWarps * 16 * 4 : 0,
                       rank};
  bool ok = threads == kLanes && smem <= kSmemMax && m.rate >= 7 &&
            m.rate <= 10 && m.arows >= 0 &&
            m.arows <= 16 && m.share >= 1 && m.share <= 128 &&
            (m.share & (m.share - 1)) == 0 && m.sync > 0 &&
            (m.sync & (m.sync - 1)) == 0 && m.lsync > 0 &&
            (m.lsync & (m.lsync - 1)) == 0;
  int end = 0;
  for (int i = 0; i < 6; ++i) {
    ok = ok && off[i] % 16 == 0 && off[i] >= end;
    end = off[i] + size[i];
  }
  return ok && end <= smem;
}

// K1 (ns = 1) or K5 (ns = 2): check the launch, then launch.  A launch
// that does not fit returns cudaErrorInvalidValue.
int decode_launch(int ns, const void* streams, const void* hi_tbl,
                  const void* lo_tbl, void* out, void* fstate, int K, int G,
                  int R, Geo m, int threads, int smem, Carve c,
                  void* stream) {
  const bool ok = carve_ok(m, threads, smem, c, ns * kRingWords * 4,
                           2 * ns * kWarps) &&
                  R >= 2 && R <= (INT_MAX - 2 * kRingWords) / kLanes &&
                  (reinterpret_cast<uintptr_t>(streams) & 15) == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  auto kernel = ns == 1 ? decode_kernel : decode_x2_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  kernel<<<G, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<uint8_t*>(out),
      static_cast<int*>(fstate), K, G, R, m, c);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2: tile and geometry, then rans_kernel.model_launch's threads,
// shared-memory bytes and five region offsets (no rank counts).
int trc_model(const void* cols, const void* hi_tbl, const void* lo_tbl,
              void* probs, int K, int G, int share, int sync, int lsync,
              int arows, int srows, int rate, int threads, int smem,
              int c_cols, int c_lo, int c_st, int c_fixed, int c_red,
              void* stream) {
  const Geo m = make_geo(share, sync, lsync, arows, srows, rate);
  const Carve c{c_cols, c_lo, c_st, c_fixed, c_red, smem};
  if (!carve_ok(m, threads, smem, c, 2 * kColSteps * kLanes, 0) || K < 0 ||
      (reinterpret_cast<uintptr_t>(cols) & 15) != 0)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      model_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  model_kernel<<<G, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int*>(hi_tbl),
      static_cast<const int*>(lo_tbl), static_cast<int*>(probs), K, G, m, c);
  return int(cudaGetLastError());
}

int trc_decode(const void* streams, const void* hi_tbl, const void* lo_tbl,
               void* out, void* fstate, int K, int G, int R, int share,
               int sync, int lsync, int arows, int srows, int rate,
               int threads, int smem, int c_ring, int c_lo, int c_st,
               int c_fixed, int c_red, int c_rank, void* stream) {
  return decode_launch(1, streams, hi_tbl, lo_tbl, out, fstate, K, G, R,
                       make_geo(share, sync, lsync, arows, srows, rate),
                       threads, smem,
                       Carve{c_ring, c_lo, c_st, c_fixed, c_red, c_rank},
                       stream);
}

int trc_decode_x2(const void* streams, const void* hi_tbl,
                  const void* lo_tbl, void* out, void* fstate, int K, int G,
                  int R, int share, int sync, int lsync, int arows, int srows,
                  int rate, int threads, int smem, int c_ring, int c_lo,
                  int c_st, int c_fixed, int c_red, int c_rank,
                  void* stream) {
  return decode_launch(2, streams, hi_tbl, lo_tbl, out, fstate, K, G, R,
                       make_geo(share, sync, lsync, arows, srows, rate),
                       threads, smem,
                       Carve{c_ring, c_lo, c_st, c_fixed, c_red, c_rank},
                       stream);
}

// K3: tile; the launch follows from S and G (L / kCoderLanes CTAs,
// ceil(S / kCoderSlots) stages, kCoderSmem bytes).  A tile it cannot code
// returns cudaErrorInvalidValue.
int trc_coder(const void* probs, const void* init, void* words, void* emit,
              void* fstate, int S, int G, void* stream) {
  const long long L = (long long)G * kLanes;
  const bool ok = S >= 0 && S <= INT_MAX - kCoderSlots && G >= 1 &&
                  L <= INT_MAX &&
                  (reinterpret_cast<uintptr_t>(probs) & 15) == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      coder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCoderSmem);
  if (e != cudaSuccess) return int(e);
  const int ctas = int(L / kCoderLanes);
  const int stages = (S + kCoderSlots - 1) / kCoderSlots;
  coder_kernel<<<ctas, kCoderLanes, kCoderSmem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(probs), static_cast<const int*>(init),
      static_cast<int*>(words), static_cast<uint8_t*>(emit),
      static_cast<int*>(fstate), S, int(L), stages);
  return int(cudaGetLastError());
}

// K4: tile, then rans_kernel.place_launch's slots a chunk, chunks a group,
// threads a CTA and scratch ints (counts); two launches, count then place.
int trc_place(const void* words, const void* emit, const void* state,
              void* gstreams, void* glens, void* counts, int S, int G, int R,
              int chunk, int chunks, int threads, int scratch,
              void* stream) {
  const long long grid = (long long)G * chunks;
  const bool ok = chunk == kPlaceChunk && threads == kPlaceThreads &&
                  S >= 0 && G >= 1 &&
                  chunks == (S > 0 ? (S + kPlaceChunk - 1) / kPlaceChunk
                                   : 1) &&
                  grid <= INT_MAX && scratch >= grid &&
                  (long long)R >= (long long)S + 2 &&
                  (long long)R * kLanes <= INT_MAX &&
                  (reinterpret_cast<uintptr_t>(emit) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(gstreams) & 15) == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  place_count_kernel<<<int(grid), kPlaceThreads, 0, s>>>(
      static_cast<const uint8_t*>(emit), static_cast<int*>(counts), S, G,
      chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  place_kernel<<<int(grid), kPlaceThreads, 0, s>>>(
      static_cast<const int*>(words), static_cast<const uint8_t*>(emit),
      static_cast<const int*>(state), static_cast<const int*>(counts),
      static_cast<int*>(gstreams), static_cast<int*>(glens), S, G, R,
      chunks);
  return int(cudaGetLastError());
}

}  // extern "C"
