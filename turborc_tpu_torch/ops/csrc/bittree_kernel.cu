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
// K9: a lane's tree lives in shared memory as u16, node-major and
// lane-minor ([node][lane]), so a level's loads are one 2-byte word per
// thread from one row: one indexed load and one store a level.  It has no
// cross-lane step, so its CTAs are one warp each (16 KB of trees) and
// spread over all SMs.  What bounds it: not bytes and not operations, but
// four dependent shared-memory loads a nibble (the next node depends on
// the bit), so the time is that chain times K.
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
// Rules kept: __syncthreads() only inside a fetch, reached by all 128
// threads every step; no loop bound taken from data; every stream read is
// bounds-checked, so a corrupt stream decodes to wrong bytes, never to an
// out-of-bounds access or a hang.  Each C entry point returns
// cudaGetLastError() after its launch.

#include <climits>

#include "rans_common.cuh"

namespace {

constexpr int kNodes = 256;   // row 0 unused
constexpr int kModelThreads = 32;
constexpr int kPMax = kTotal - 1;

__device__ __forceinline__ int clamp_p(int p) { return min(max(p, 1), kPMax); }

// One nibble of K9 down this thread's tree column (kModelThreads lanes
// per node row), from `node`, its bits the four of `nib`, highest first.
// Leaves `node` below the nibble and returns the symbol's low, its width
// in `w`.  The path nodes are distinct, so each is updated as it is
// passed.
__device__ __forceinline__ int descend(uint16_t* tree, int& node, int& w,
                                       int nib) {
  int low = 0;
  w = kTotal;
#pragma unroll
  for (int lvl = 0; lvl < 4; ++lvl) {
    uint16_t* at = tree + node * kModelThreads + threadIdx.x;
    const int p = *at;  // in [1, 32767]
    const int m = 8 >> lvl;
    const int s = min(max((w * p) >> 15, m), w - m);
    const int bit = (nib >> (3 - lvl)) & 1;
    low = bit ? low : low + s;
    w = bit ? s : w - s;
    *at = uint16_t(p - (((p - (bit << 15)) >> 5) + bit));
    node = 2 * node + bit;
  }
  return low;
}

// ---- K9: forward model pass.  cols [K, G, 128] u8 -> probs [2K, G, 128]
// int32 = (low << 16) | w per nibble slot (hi slot 2t, lo slot 2t+1).
__global__ void __launch_bounds__(kModelThreads)
tree_model_kernel(const uint8_t* __restrict__ cols,
                  const int* __restrict__ tree_tbl, int* __restrict__ probs,
                  int K, int G) {
  __shared__ uint16_t tree[kNodes * kModelThreads];
  const size_t L = size_t(G) * kLanes;
  const size_t lane = size_t(blockIdx.x) * kModelThreads + threadIdx.x;
  for (int n = 1; n < kNodes; ++n)  // own column: no barrier
    tree[n * kModelThreads + threadIdx.x] = uint16_t(clamp_p(tree_tbl[n]));
  for (int t = 0; t < K; ++t) {
    const int b = cols[size_t(t) * L + lane];
    int node = 1, w;
    int low = descend(tree, node, w, b >> 4);
    probs[size_t(2 * t) * L + lane] = (low << 16) | w;
    low = descend(tree, node, w, b & 15);
    probs[size_t(2 * t + 1) * L + lane] = (low << 16) | w;
  }
}

// ---- K8: decode.  streams [G, R, 128] int32 (rows 0/1 = initial state
// hi16/lo16, words from 256 in consumption order) -> bytes [K, G, 128] u8,
// final states [G, 128].  One CTA = one group, one thread a lane.
//
// The tree as 16-entry subtree rows.  A nibble walks a 15-node subtree:
// the hi nibble nodes 1-15, the lo nibble the subtree rooted at node
// 16 + hi, whose level-l nodes are (16 + hi) 2^l + j.  The node of level l
// on path j (the l bits decided above it, first bit highest) is heap slot
// 2^l - 1 + j of its subtree, so the children of slot i are slots 2i + 1
// (bit 0) and 2i + 2 (bit 1), and nodes 16-255 are 16 rows of 15 slots
// (slot 15 unused).  The hi subtree stays in registers for the whole
// decode; the lo rows of every lane are in shared memory, in the
// decoders' row layout ([16][2 halves][128 lanes][8] u16, 65,536 B), and
// row hi is read while the hi nibble's word is fetched.  Level l picks its
// node among 2^l candidates by a select tree on the path, and the four
// path nodes are updated by 1 + 2 + 4 + 8 conditional selects, so no
// register array is indexed by data.  Its dynamic shared memory: the ring
// of stream words, the lo rows, the per-warp rank counts (one byte a warp,
// double-buffered).
constexpr int kTreeRing = 0;
constexpr int kTreeRows = kTreeRing + kRingWords * 4;
constexpr int kTreeRank = kTreeRows + 16 * kLanes * 32;
constexpr int kTreeSmem = (kTreeRank + 2 * kWarps + 15) / 16 * 16;
static_assert(kTreeRows % 16 == 0 && kTreeRank % 16 == 0, "16-byte regions");
static_assert(kTreeSmem <= kSmemMax, "K8's carve fits a CTA");

// The level of heap slot i < 15: slots 2^l - 1 .. 2^(l+1) - 2.
__host__ __device__ constexpr int slot_level(int i) {
  return i < 1 ? 0 : i < 3 ? 1 : i < 7 ? 2 : 3;
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

// A nibble down subtree row n against `value`: returns the nibble (the
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

  // The block's tree [256] int32, clamped: nodes 1-15 (the hi subtree) in
  // registers, slot i at node i + 1; the lo subtree of hi nibble h in this
  // lane's row h, slot i at node (16 + h) 2^l + i + 1 - 2^l, l its level.
  int hi[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) hi[i] = i < 15 ? clamp_p(tree_tbl[i + 1]) : 0;
  for (int h = 0; h < 16; ++h) {
    int v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int l = slot_level(i);
      v[i] = i < 15 ? clamp_p(tree_tbl[((16 + h) << l) + i + 1 - (1 << l)])
                    : 0;
    }
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

int trc_tree_model(const void* cols, const void* tree_tbl, void* probs, int K,
                   int G, void* stream) {
  const int blocks = G * (kLanes / kModelThreads);
  tree_model_kernel<<<blocks, kModelThreads, 0,
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
