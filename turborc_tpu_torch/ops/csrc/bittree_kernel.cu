// Bit-tree codec kernels (codec rc-p) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of
// turborc_tpu/ops/pallas/bittree_kernel.py:
//   tree_model_kernel   <- _make_tree_model_kernel  (:333)  forward model pass
//   tree_decode_kernel  <- _make_tree_decode_kernel (:203)  bit-tree decode
// The encode side's backward coder and placement are coder_kernel and
// place_kernel of rans_kernel.cu, unchanged: the stream format is the o0 one.
//
// Model: every lane has its own 255-node tree of p15(bit = 1 | node), warm
// started from the block's one tree.  A nibble is four binary decisions down
// the tree (hi nibble from node 1, lo nibble from node 16 + hi; the bit-1
// child of node n is 2n+1); each level splits the interval exactly,
//   s = clip((w * p) >> 15, 8 >> level, w - (8 >> level)),
// bit 1 keeping [low, low + s) and bit 0 [low + s, low + w), with p the node
// clamped to [1, 32767].  The four path nodes then take the simple-counter
// update p - (((p - (bit << 15)) >> 5) + bit) of the clamped p: a signed,
// arithmetic shift.  The nibble's (low, w) is one rANS symbol.
//
// Entries are clamped to [1, 32767] when the tree is loaded (every read
// clamps, so this changes nothing) and the update keeps them there, so u16
// is exact.  The TPU's binary-tree select ladders (11 + 236 wheres a
// nibble) and per-row masked write-backs are not reproduced.
//
// K9 knows every byte in advance (it is the input), so the path of each
// nibble is known before any arithmetic: its four path nodes are read from
// shared memory at addresses the byte gives (no select tree, no
// register-indexed tree), and the counter updates need only the nodes and
// the bits.  The true chains are the width w through a nibble's four
// splits and the counter updates of a node that the next byte passes
// again (the hi subtree's root on every byte).  It holds the tree in
// K8's 16-entry subtree rows, the hi subtree as a 17th row, one int a node
// with the lanes minor.  Its lanes are independent, so its CTAs are
// kTreeLanes = 32 lanes, four a group, spread over every SM; the lo chain
// of a lane runs on warp 0 and its hi chain on warp 1 (kTreeSplit = 2; the
// two share only the input byte and run the same code), so 8,192 lanes
// are 512 warps, about one for each of the card's 528 schedulers.  Its
// input bytes are staged by cp.async in K7's two-stage ring (model_stage
// in rans_common.cuh); the path nodes of byte t + 1 are read a byte step
// ahead and take byte t's updates from registers where the paths meet.
// What bounds it: not bytes and not operations, but a byte step's
// instructions (about 134: splits, updates, node addresses, loads and
// stores, forward selects) on one warp a scheduler
// (tools/decode_probe.py --kernel tree_model, PERF.md sections 6 and 7).
//
// K8 keeps one 128-lane group per CTA, as the other decoders do, because
// its fetch ranks the lanes that need a word across the whole group.  It
// runs on their ring of stream words and two-half fetch (rans_common.cuh)
// and holds the tree as 16-entry subtree rows (see tree_decode_kernel):
// the hi nibble's subtree in registers, the 16 lo subtrees of every lane
// in shared memory, a nibble's descent and updates by select trees.  What
// bounds it: the chain of a byte step (descent, state, ballot, barrier,
// rank, word, twice) on 4 warps an SM, 68 of the 132 SMs holding no group
// at 64 groups (tools/decode_probe.py --kernel tree_decode, PERF.md
// sections 6 and 7).
//
// Rules kept: __syncthreads() only inside a fetch (K8) or at a stage of
// input bytes (K9), where every thread of the CTA arrives, under
// conditions on the byte index alone; no loop bound taken from data;
// every stream read is bounds-checked, so a corrupt stream decodes to
// wrong bytes, never to an out-of-bounds access or a hang.  Each C entry
// point refuses a tile it cannot take with cudaErrorInvalidValue and
// returns cudaGetLastError() after its launch.

#include <climits>

#include "rans_common.cuh"

namespace {

constexpr int kPMax = kTotal - 1;

__device__ __forceinline__ int clamp_p(int p) { return min(max(p, 1), kPMax); }

// ---- The tree as 16-entry subtree rows (K8, K9).  A nibble walks a
// 15-node subtree: the hi nibble nodes 1-15, the lo nibble the subtree
// rooted at node 16 + hi, whose level-l nodes are (16 + hi) 2^l + j.  The
// node of level l on path j (the l bits decided above it, first bit
// highest) is heap slot 2^l - 1 + j of its subtree, so the children of slot
// i are slots 2i + 1 (bit 0) and 2i + 2 (bit 1), and nodes 16-255 are 16
// rows of 15 slots (slot 15 unused).  K8 keeps the hi subtree in
// registers and the lo rows of every lane in shared memory in the row
// layout of rans_common.cuh (lane_row): level l picks its node among 2^l
// candidates by a select tree on the path, and the four path nodes are
// updated by 1 + 2 + 4 + 8 conditional selects, so no register array is
// indexed by data.  K9 keeps every row in shared memory and addresses a
// node directly (tree_node).

// The level of heap slot i < 15: slots 2^l - 1 .. 2^(l+1) - 2.
__host__ __device__ constexpr int slot_level(int i) {
  return i < 1 ? 0 : i < 3 ? 1 : i < 7 ? 2 : 3;
}

// The block's tree [256] int32, clamped, as subtree rows (K8, K9): the hi
// subtree (slot i at node i + 1), or the lo subtree of hi nibble h (slot i
// at node (16 + h) 2^l + i + 1 - 2^l, l its level).
__device__ __forceinline__ void load_hi(const int* tree_tbl, int (&n)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) n[i] = i < 15 ? clamp_p(tree_tbl[i + 1]) : 0;
}

__device__ __forceinline__ void load_lo(const int* tree_tbl, int h,
                                        int (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int l = slot_level(i);
    v[i] = i < 15 ? clamp_p(tree_tbl[((16 + h) << l) + i + 1 - (1 << l)])
                  : 0;
  }
}

// Slot 2^L - 1 + j of subtree row n: the node of level L on path j, by a
// select tree of depth L on the bits of j.
template <int L>
__device__ __forceinline__ int pick_level(const int (&n)[16], int j) {
  int v[1 << L];
#pragma unroll
  for (int i = 0; i < (1 << L); ++i) v[i] = n[(1 << L) - 1 + i];
#pragma unroll
  for (int b = 0; b < L; ++b) {
#pragma unroll
    for (int i = 0; i < (1 << (L - 1 - b)); ++i)
      v[i] = (j >> b) & 1 ? v[2 * i + 1] : v[2 * i];
  }
  return v[0];
}

// Level L of a nibble's descent in subtree row n, on path j so far: the
// node's p (kept in p[L] for its update), its split of [low, low + w), the
// bit decided against `value` (bit 1 keeps [low, low + s)).
template <int L>
__device__ __forceinline__ void descend_level(const int (&n)[16], int value,
                                              int& j, int& low, int& w,
                                              int (&p)[4]) {
  const int pl = pick_level<L>(n, j);
  constexpr int m = 8 >> L;
  const int s = min(max((w * pl) >> 15, m), w - m);
  const int bit = value - low < s ? 1 : 0;
  low = bit ? low : low + s;
  w = bit ? s : w - s;
  p[L] = pl;
  j = 2 * j + bit;
}

// A nibble down subtree row n against `value` (K8): returns the nibble (the
// path), the symbol's low in `low` and its width in `w`.
__device__ __forceinline__ int descend_row(const int (&n)[16], int value,
                                           int& low, int& w, int (&p)[4]) {
  int j = 0;
  low = 0;
  w = kTotal;
  descend_level<0>(n, value, j, low, w, p);
  descend_level<1>(n, value, j, low, w, p);
  descend_level<2>(n, value, j, low, w, p);
  descend_level<3>(n, value, j, low, w, p);
  return j;
}

// The simple-counter update of path node L of nibble nib (its p was
// p[L]): 2^L conditional selects.
template <int L>
__device__ __forceinline__ void update_level(int (&n)[16], int nib, int pl) {
  const int j = nib >> (4 - L), bit = (nib >> (3 - L)) & 1;
  const int np = pl - (((pl - (bit << 15)) >> 5) + bit);
#pragma unroll
  for (int i = 0; i < (1 << L); ++i)
    n[(1 << L) - 1 + i] = j == i ? np : n[(1 << L) - 1 + i];
}

__device__ __forceinline__ void update_path(int (&n)[16], int nib,
                                            const int (&p)[4]) {
  update_level<0>(n, nib, p[0]);
  update_level<1>(n, nib, p[1]);
  update_level<2>(n, nib, p[2]);
  update_level<3>(n, nib, p[3]);
}

// ---- K9: forward model pass.  cols [K, G, 128] u8 -> probs [2K, G, 128]
// int32 = (low << 16) | w per nibble slot (hi slot 2t, lo slot 2t + 1).
// A CTA is kTreeLanes lanes of one group.  A lane has two chains: the lo
// chain walks subtree row h (the byte's hi nibble) along the lo nibble and
// writes slot 2t + 1, the hi chain walks row 16 (the hi subtree) along the
// hi nibble and writes slot 2t.  With kTreeSplit = 2 thread i <
// kTreeLanes runs lane i's lo chain and thread kTreeLanes + i its hi
// chain; with kTreeSplit = 1 one thread runs both.  Its dynamic shared
// memory: the nodes, int [17 rows][16 slots][kTreeLanes] (slot 15
// unused), then the ring of input bytes, two stages of kTreeSteps byte
// steps x kTreeLanes.
//
// A byte step of a chain: the nibble's four splits from the p of its
// path nodes (held in registers), the nodes' counter updates stored back
// to their slots, then the path nodes of byte t + 2 read (the byte is in
// the ring two steps ahead), so each load has a byte step to land.  Byte
// t + 1's path nodes were read a step earlier, before byte t's updates
// were stored: where such a node is one of byte t's (the same row and the
// same leading bits of the nibble; the root of the hi chain always) it
// takes byte t's updated p instead.  At t + 2 = 0 mod kTreeSteps every
// thread waits for the stage that starts there (requested a stage
// earlier), the barrier frees the stage before it, and the CTA requests
// the next stage into that one.  The byte loop is unrolled kTreeUnroll
// times: the split chains of consecutive bytes depend on each other only
// through the forwarded p, so the compiler interleaves them, where one
// byte's chain of about 20 dependent instructions would hold the warp.
constexpr int kTreeLanes = 32;   // lanes a CTA
constexpr int kTreeSplit = 2;    // threads a lane: the lo and the hi chain
constexpr int kTreeChains = 3 - kTreeSplit;  // chains a thread
constexpr int kTreeThreads = kTreeLanes * kTreeSplit;
constexpr int kTreeSteps = 16;   // byte steps a stage
constexpr int kTreeUnroll = 4;   // byte steps the compiler interleaves
constexpr int kTreeMNodes = 0;
constexpr int kTreeMCols = kTreeMNodes + 17 * 16 * kTreeLanes * 4;
constexpr int kTreeMSmem = kTreeMCols + 2 * kTreeSteps * kTreeLanes;
static_assert(kLanes % kTreeLanes == 0, "a group is whole CTAs");
static_assert(kTreeSplit == 1 || kTreeSplit == 2, "one or two chains a lane");
static_assert(kTreeMCols % 16 == 0 && kTreeMSmem % 16 == 0, "16-byte regions");
static_assert(kTreeMSmem <= 48 * 1024, "K9's carve needs no opt-in");
static_assert(2 * (kTreeMSmem + kSmemCta) <= kSmemSm,
              "two of K9's CTAs fit an SM: id 8's 256 CTAs all resident");

// The node of level l on the path of nibble n in subtree row r: heap slot
// 2^l - 1 + (n >> (4 - l)), as an offset into the nodes of one lane (a
// warp's accesses of one level meet no bank conflict).
__device__ __forceinline__ int tree_node(int r, int n, int l) {
  return ((r << 4) + (1 << l) - 1 + (n >> (4 - l))) * kTreeLanes;
}

// Nibble n's four splits of [0, 2^15) by the p of its path nodes, bit 1
// keeping [low, low + s): (low << 16) | w.
__device__ __forceinline__ int tree_splits(const int (&p)[4], int n) {
  int low = 0, w = kTotal;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int m = 8 >> l, bit = (n >> (3 - l)) & 1;
    const int s = min(max((w * p[l]) >> 15, m), w - m);
    low = bit ? low : low + s;
    w = bit ? s : w - s;
  }
  return (low << 16) | w;
}

// The simple-counter updates of nibble n's path nodes.
__device__ __forceinline__ void tree_updates(const int (&p)[4], int n,
                                             int (&np)[4]) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int bit = (n >> (3 - l)) & 1;
    np[l] = p[l] - (((p[l] - (bit << 15)) >> 5) + bit);
  }
}

__global__ void __launch_bounds__(kTreeThreads)
tree_model_kernel(const uint8_t* __restrict__ cols,
                  const int* __restrict__ tree_tbl, int* __restrict__ probs,
                  int K, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring = smem_raw + kTreeMCols;
  const size_t L = size_t(G) * kLanes;
  const size_t lane0 = size_t(blockIdx.x) * kTreeLanes;
  const int lane = int(threadIdx.x % kTreeLanes);
  int* nodes = reinterpret_cast<int*>(smem_raw + kTreeMNodes) + lane;
  const bool hi_thread = kTreeSplit == 2 && threadIdx.x >= kTreeLanes;
  const uint8_t* src = cols + lane0;
  model_stage<kTreeLanes, kTreeSteps, kTreeThreads>(ring, src, 0, K, L);
  cp_async_commit();
  model_stage<kTreeLanes, kTreeSteps, kTreeThreads>(ring, src, kTreeSteps, K,
                                                    L);
  cp_async_commit();

  // The block's tree as this lane's subtree rows: the lo subtrees 0-15
  // (lo chain), the hi subtree as row 16 (hi chain).  A thread reads only
  // the rows it writes here.
  int v[16];
  if (!hi_thread) {
    for (int h = 0; h < 16; ++h) {
      load_lo(tree_tbl, h, v);
#pragma unroll
      for (int i = 0; i < 15; ++i) nodes[((h << 4) + i) * kTreeLanes] = v[i];
    }
  }
  if (kTreeSplit == 1 || hi_thread) {
    load_hi(tree_tbl, v);
#pragma unroll
    for (int i = 0; i < 15; ++i) nodes[((16 << 4) + i) * kTreeLanes] = v[i];
  }
  cp_async_wait<1>();
  __syncthreads();

  // Chain k of this thread is the hi chain on a hi thread and for k = 1:
  // its subtree row and nibble of a byte.
  auto row = [&](int k, int x) { return k == 1 || hi_thread ? 16 : x >> 4; };
  auto nib = [&](int k, int x) {
    return k == 1 || hi_thread ? x >> 4 : x & 15;
  };
  // bytes t, t + 1 of this lane; the p of each chain's path nodes of byte
  // t (cur) and of byte t + 1 as read (nxt)
  int b = K > 0 ? ring[lane] : 0, b1 = K > 1 ? ring[kTreeLanes + lane] : 0;
  int cur[kTreeChains][4], nxt[kTreeChains][4];
  int* out[kTreeChains];  // slot 2t (hi) or 2t + 1 (lo) of this lane
#pragma unroll
  for (int k = 0; k < kTreeChains; ++k) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      cur[k][l] = nodes[tree_node(row(k, b), nib(k, b), l)];
      nxt[k][l] = nodes[tree_node(row(k, b1), nib(k, b1), l)];
    }
    out[k] = probs + lane0 + lane + (k == 1 || hi_thread ? 0 : L);
  }
#pragma unroll kTreeUnroll
  for (int t = 0; t < K; ++t) {
    const int u = t + 2;
    if ((u & (kTreeSteps - 1)) == 0) {
      cp_async_wait<0>();
      __syncthreads();
      model_stage<kTreeLanes, kTreeSteps, kTreeThreads>(
          ring, src, u + kTreeSteps, K, L);
      cp_async_commit();
    }
    const int b2 =
        u < K ? ring[(u & (2 * kTreeSteps - 1)) * kTreeLanes + lane] : 0;
#pragma unroll
    for (int k = 0; k < kTreeChains; ++k) {
      const int r = row(k, b), n = nib(k, b);
      const int sym = tree_splits(cur[k], n);
      int np[4];
      tree_updates(cur[k], n, np);
#pragma unroll
      for (int l = 0; l < 4; ++l) nodes[tree_node(r, n, l)] = np[l];
      *out[k] = sym;
      out[k] += 2 * L;
      // byte t + 2's path nodes, read after byte t's are stored
      const int r2 = row(k, b2), n2 = nib(k, b2);
      int ld[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) ld[l] = nodes[tree_node(r2, n2, l)];
      // byte t + 1's: byte t's updated p where the node is the same
      const bool same = row(k, b1) == r;
      const int x = nib(k, b1) ^ n;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        cur[k][l] = same && (x >> (4 - l)) == 0 ? np[l] : nxt[k][l];
#pragma unroll
      for (int l = 0; l < 4; ++l) nxt[k][l] = ld[l];
    }
    b = b1;
    b1 = b2;
  }
  cp_async_wait<0>();
}

// ---- K8: decode.  streams [G, R, 128] int32 (rows 0/1 = initial state
// hi16/lo16, words from 256 in consumption order) -> bytes [K, G, 128] u8,
// final states [G, 128].  One CTA = one group, one thread a lane, on the
// decoders' ring of stream words, the tree as subtree rows: the hi subtree
// in registers for the whole decode, the lo rows of every lane in shared
// memory in the decoders' row layout ([16][2 halves][128 lanes][8] u16,
// 65,536 B); row hi is read while the hi nibble's word is fetched.  Its
// dynamic shared memory: the ring of stream words, the lo rows, the
// per-warp rank counts (one byte a warp, double-buffered).
constexpr int kTreeRing = 0;
constexpr int kTreeRows = kTreeRing + kRingWords * 4;
constexpr int kTreeRank = kTreeRows + 16 * kLanes * 32;
constexpr int kTreeSmem = (kTreeRank + 2 * kWarps + 15) / 16 * 16;
static_assert(kTreeRows % 16 == 0 && kTreeRank % 16 == 0, "16-byte regions");
static_assert(kTreeSmem <= kSmemMax, "K8's carve fits a CTA");

__global__ void __launch_bounds__(kLanes, 1)
tree_decode_kernel(const int* __restrict__ streams,
                   const int* __restrict__ tree_tbl, uint8_t* __restrict__ out,
                   int* __restrict__ fstate, int K, int G, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* rows = reinterpret_cast<uint16_t*>(smem_raw + kTreeRows);
  uint8_t* rank = smem_raw + kTreeRank;
  const int g = blockIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + threadIdx.x;
  const int limit = R * kLanes;
  Ring r[1];
  ring_init(r[0], streams + size_t(g) * R * kLanes,
            reinterpret_cast<int*>(smem_raw + kTreeRing), limit);
  cp_async_commit();
  uint32_t state[1] = {(uint32_t(r[0].src[threadIdx.x]) << 16) |
                       uint32_t(r[0].src[kLanes + threadIdx.x])};

  // The block's tree: the hi subtree in registers, the lo subtree of hi
  // nibble h in this lane's row h.
  int hi[16];
  load_hi(tree_tbl, hi);
  for (int h = 0; h < 16; ++h) {
    int v[16];
    load_lo(tree_tbl, h, v);
    st_row(lane_row(rows, h), kHalf, v);
  }
  cp_async_wait<0>();
  __syncthreads();

  int buf = 0, nfetch = 0;
  uint8_t* out_t = out + col;  // byte t of this lane
  for (int t = 0; t < K; ++t) {
    int p[4], low, w;
    uint32_t value = state[0] & (kTotal - 1);
    const int hs = descend_row(hi, int(value), low, w, p);
    state[0] = uint32_t(w) * (state[0] >> 15) + value - uint32_t(low);
    unsigned bal[1];
    fetch_post(state, bal, rank, buf, nfetch);
    // what needs no word of this fetch: the lo row, the hi path's updates
    uint16_t* lp = lane_row(rows, hs);
    int lrow[16];
    ld_row(lp, kHalf, lrow);
    update_path(hi, hs, p);
    fetch_take(state, bal, r, limit, rank, buf, nfetch);

    value = state[0] & (kTotal - 1);
    const int ls = descend_row(lrow, int(value), low, w, p);
    state[0] = uint32_t(w) * (state[0] >> 15) + value - uint32_t(low);
    fetch_post(state, bal, rank, buf, nfetch);
    update_path(lrow, ls, p);
    st_row(lp, kHalf, lrow);
    *out_t = uint8_t((hs << 4) | ls);
    out_t += plane;
    fetch_take(state, bal, r, limit, rank, buf, nfetch);
  }
  cp_async_wait<0>();
  fstate[col] = int(state[0]);
}

}  // namespace

extern "C" {

// K9: tile; the launch is fixed (four CTAs a group of kTreeThreads
// threads, kTreeMSmem bytes).  A tile it cannot take returns
// cudaErrorInvalidValue: the stage copies 16 bytes at a time from cols,
// and a plane of probs, 2K x G x 128 int32, must fit the kernel's size_t
// offsets.
int trc_tree_model(const void* cols, const void* tree_tbl, void* probs, int K,
                   int G, void* stream) {
  const bool ok = K >= 0 && G >= 1 && G <= INT_MAX / kLanes &&
                  size_t(K) <= SIZE_MAX / 8 / (size_t(G) * kLanes) &&
                  (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  tree_model_kernel<<<G * (kLanes / kTreeLanes), kTreeThreads, kTreeMSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cols), static_cast<const int*>(tree_tbl),
      static_cast<int*>(probs), K, G);
  return int(cudaGetLastError());
}

// K8: tile; the launch is fixed (kLanes threads, kTreeSmem bytes).  A
// tile it cannot decode returns cudaErrorInvalidValue.
int trc_tree_decode(const void* streams, const void* tree_tbl, void* out,
                    void* fstate, int K, int G, int R, void* stream) {
  const bool ok = K >= 0 && G >= 1 && R >= 2 &&
                  R <= (INT_MAX - 2 * kRingWords) / kLanes &&
                  (reinterpret_cast<uintptr_t>(streams) & 15) == 0;
  if (!ok) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      tree_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTreeSmem);
  if (e != cudaSuccess) return int(e);
  tree_decode_kernel<<<G, kLanes, kTreeSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(tree_tbl),
      static_cast<uint8_t*>(out), static_cast<int*>(fstate), K, G, R);
  return int(cudaGetLastError());
}

}  // extern "C"
