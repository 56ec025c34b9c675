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
// Design: a lane's tree lives in shared memory as u16, node-major and
// lane-minor ([node][lane]), so a level's loads are one 2-byte word per
// thread from one row.  Entries are clamped to [1, 32767] when the tree is
// loaded (every read clamps, so this changes nothing) and the update keeps
// them there, so u16 is exact.  The TPU's binary-tree select ladders
// (11 + 236 wheres a nibble) and per-row masked write-backs become one
// indexed load and one store a level.
//
// The model kernel has no cross-lane step, so its CTAs are one warp each
// (16 KB of trees) and spread over all SMs.  The decode kernel keeps one
// 128-lane group per CTA, as K1 does, because its fetch ranks the lanes that
// need a word across the whole group (rans_common.cuh); its trees take 64 KB
// of dynamic shared memory.
//
// What bounds them on this card: not bytes and not operations.  Each lane is
// a chain of dependent steps: four dependent shared-memory loads a nibble
// (the next node depends on the bit), and in the decoder a state step and a
// block-wide fetch after each nibble, so the time is the per-step latency
// times K.  Rules kept: __syncthreads() only inside fetch, reached by all 128
// threads every step; no loop bound taken from data; every stream read is
// bounds-checked.  Each C entry point returns cudaGetLastError() after its
// launch.

#include "rans_common.cuh"

namespace {

constexpr int kNodes = 256;   // row 0 unused
constexpr int kModelThreads = 32;
constexpr int kPMax = kTotal - 1;

// One nibble down this thread's tree column (kStride lanes per node row),
// from `node`; bit_of(level, low, s) gives the bit.  Leaves `node` below the
// nibble and returns the symbol's low, its width in `w`.  The path nodes are
// distinct, so each is updated as it is passed.
template <int kStride, class BitOf>
__device__ __forceinline__ int descend(uint16_t* tree, int& node, int& w,
                                       BitOf bit_of) {
  int low = 0;
  w = kTotal;
#pragma unroll
  for (int lvl = 0; lvl < 4; ++lvl) {
    uint16_t* at = tree + node * kStride + threadIdx.x;
    const int p = *at;  // in [1, 32767]
    const int m = 8 >> lvl;
    const int s = min(max((w * p) >> 15, m), w - m);
    const int bit = bit_of(lvl, low, s);
    low = bit ? low : low + s;
    w = bit ? s : w - s;
    *at = uint16_t(p - (((p - (bit << 15)) >> 5) + bit));
    node = 2 * node + bit;
  }
  return low;
}

template <int kStride>
__device__ __forceinline__ void load_tree(const int* tree_tbl,
                                          uint16_t* tree) {
  for (int n = 1; n < kNodes; ++n)
    tree[n * kStride + threadIdx.x] =
        uint16_t(min(max(tree_tbl[n], 1), kPMax));
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
  load_tree<kModelThreads>(tree_tbl, tree);  // own column: no barrier
  for (int t = 0; t < K; ++t) {
    const int b = cols[size_t(t) * L + lane];
    int node = 1, w;
    auto hi_bit = [&](int lvl, int, int) { return (b >> (7 - lvl)) & 1; };
    auto lo_bit = [&](int lvl, int, int) { return (b >> (3 - lvl)) & 1; };
    int low = descend<kModelThreads>(tree, node, w, hi_bit);
    probs[size_t(2 * t) * L + lane] = (low << 16) | w;
    low = descend<kModelThreads>(tree, node, w, lo_bit);
    probs[size_t(2 * t + 1) * L + lane] = (low << 16) | w;
  }
}

// ---- K8: decode.  streams [G, R, 128] int32 (rows 0/1 = initial state
// hi16/lo16, words from 256 in consumption order) -> bytes [K, G, 128] u8,
// final states [G, 128].  One CTA = one group.
__global__ void __launch_bounds__(kLanes)
tree_decode_kernel(const int* __restrict__ streams,
                   const int* __restrict__ tree_tbl, uint8_t* __restrict__ out,
                   int* __restrict__ fstate, int K, int G, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* wsum = reinterpret_cast<int*>(smem_raw);  // block_rank double buffer
  uint16_t* tree = reinterpret_cast<uint16_t*>(wsum + 2 * kWarps);
  const int g = blockIdx.x;
  const size_t plane = size_t(G) * kLanes;
  const size_t col = size_t(g) * kLanes + threadIdx.x;
  const int* s = streams + size_t(g) * R * kLanes;
  const long long limit = (long long)R * kLanes;
  load_tree<kLanes>(tree_tbl, tree);
  uint32_t state = (uint32_t(s[threadIdx.x]) << 16) |
                   uint32_t(s[kLanes + threadIdx.x]);
  long long base = 2 * kLanes;
  int buf = 0;

  for (int t = 0; t < K; ++t) {
    int node = 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // hi nibble, then lo below it
      const int value = int(state & (kTotal - 1));
      int w;
      auto bit = [&](int, int lo, int sp) { return value - lo < sp ? 1 : 0; };
      const int low = descend<kLanes>(tree, node, w, bit);
      state = uint32_t(w) * (state >> 15) + uint32_t(value - low);
      fetch(state, s, limit, base, wsum, buf);
    }
    out[size_t(t) * plane + col] = uint8_t(node - 256);
  }
  fstate[col] = int(state);
}

size_t decode_smem_bytes() {
  return 2 * kWarps * sizeof(int) + kNodes * kLanes * sizeof(uint16_t);
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

int trc_tree_decode(const void* streams, const void* tree_tbl, void* out,
                    void* fstate, int K, int G, int R, void* stream) {
  const size_t smem = decode_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      tree_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  tree_decode_kernel<<<G, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(streams), static_cast<const int*>(tree_tbl),
      static_cast<uint8_t*>(out), static_cast<int*>(fstate), K, G, R);
  return int(cudaGetLastError());
}

}  // extern "C"
