"""The bit-tree codec's kernels: wrappers, launch counts, plain versions.

Counterpart of ``turborc_tpu/ops/pallas/bittree_kernel.py``.  The model
is a 255-node binary tree of adaptive probabilities p15(bit = 1 | node)
(node 1 is the root, the bit-1 child of node n is 2n+1, row 0 unused).
A byte is coded as two rANS symbols, one per nibble: the four binary
decisions of a nibble subdivide [0, 2^15) exactly,

    s = clip((w * p) >> 15, m, w - m),  m = 8 >> level
    bit 1 keeps [low, low + s), bit 0 keeps [low + s, low + w),

with p the node's prediction clamped to [1, 32767].  The hi nibble
descends from node 1, the lo nibble from node 16 + hi.  After a nibble
the four path nodes take the simple-counter update on the clamped p,
``p - (((p - (bit << 15)) >> 5) + bit)`` (an arithmetic shift).  The
stream format is the flagship's (``ops/rans_kernel.py``): the encode side
feeds the slot probabilities to its coder and placement kernels.

Kernel (CUDA, ``csrc/bittree_kernel.cu``)  replaces (TPU)
                                           plain version
  tree_model   K9: bytes -> slot probs     _make_tree_model_kernel
                                           tree_model_plain
  tree_decode  K8: group streams -> bytes  _make_tree_decode_kernel
                                           tree_decode_plain

A wrapper validates its inputs, then runs the plain version when they lie
on the CPU and launches the kernel when they lie on a CUDA device; there
is no fallback.  ``launches[name]`` counts kernel launches only.  Tree
entries stay in [1, 32767] under the update, so the kernels keep them as
u16.  K8 runs on the o0 decoders' ring of stream words
(``rans_kernel.ring_check`` mirrors it, two fetches a byte) and holds the
tree as 16 subtree rows of 15 heap slots: the hi nibble's subtree (nodes
1-15) in registers, the lo subtree under node 16 + hi in shared memory,
the node of level l on path j of a subtree at slot 2^l - 1 + j.
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_kernel as K_
from turborc_tpu_torch.ops.geom import DEFAULT, Geom

RC_BITS = 15
TOTAL = 1 << RC_BITS
RATE = 5
GLANES = K_.GLANES

launches = dict.fromkeys(("tree_model", "tree_decode"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def require_tree_format(geom: Geom) -> None:
    """Raise ValueError for a geometry the bit-tree format does not have
    (the JAX package's messages)."""
    if geom.nstates != 1:
        raise ValueError(
            "the bittree pipeline has no split-state (x2) format: "
            f"geometry {geom.spec} requires nstates=1")
    if geom.rate != 7:
        raise ValueError(
            "the bittree XLA twin runs the fixed CDFRATE=7 update: "
            f"geometry {geom.spec} requires rate=7")


def warm_tree(data: np.ndarray) -> np.ndarray:
    """[256] int32 node probabilities p15(bit=1 | node) from the byte
    counts of ``data`` (row 0 unused, rows 1..255 in [1, 32767])."""
    counts = np.zeros(512, np.int64)
    if data.size:
        counts[256:] = np.bincount(data, minlength=256)
    for n in range(255, 0, -1):
        counts[n] = counts[2 * n] + counts[2 * n + 1]
    tot = np.maximum(counts[1:256], 1)
    p = (counts[2 * np.arange(1, 256) + 1] * TOTAL + tot // 2) // tot
    out = np.zeros(256, np.int32)
    out[1:] = np.clip(p, 1, TOTAL - 1)
    return out


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def _descend(tree: torch.Tensor, node: torch.Tensor, bit_of):
    """One nibble down the lanes' trees [L, 256] from ``node`` [L]:
    ``bit_of(level, low, s)`` gives each lane's bit.  Updates the path
    nodes in place (they are distinct, so updating each as it is passed
    equals updating all four after the nibble).  Returns (low, w, the
    node below the nibble's last level)."""
    low = torch.zeros_like(node)
    w = torch.full_like(node, TOTAL)
    for lvl in range(4):
        p = tree.gather(1, node[:, None])[:, 0].clamp(1, TOTAL - 1)
        m = 8 >> lvl
        s = torch.minimum(torch.clamp((w * p) >> RC_BITS, min=m), w - m)
        bit = bit_of(lvl, low, s).to(torch.int64)
        low = torch.where(bit != 0, low, low + s)
        w = torch.where(bit != 0, s, w - s)
        tree.scatter_(1, node[:, None],
                      (p - (((p - (bit << RC_BITS)) >> RATE) + bit))[:, None])
        node = 2 * node + bit
    return low, w, node


def _lane_trees(tree_tbl: torch.Tensor, L: int) -> torch.Tensor:
    return tree_tbl.to(torch.int64)[None, :].repeat(L, 1)


def tree_model_plain(cols: torch.Tensor, tree_tbl: torch.Tensor
                     ) -> torch.Tensor:
    """cols [K, G, 128] bytes -> probs [2K, G, 128] int32 ((low<<16)|w;
    hi nibble at slot 2t, lo nibble at 2t+1), as the JAX package's XLA
    twin ``encode_tile`` computes them."""
    K, G, _ = cols.shape
    L = G * GLANES
    tree = _lane_trees(tree_tbl, L)
    root = torch.ones(L, dtype=torch.int64, device=cols.device)
    probs = torch.empty((2 * K, L), dtype=torch.int64, device=cols.device)
    for t in range(K):
        b = cols[t].reshape(L).to(torch.int64)
        low, w, node = _descend(tree, root,
                                lambda lvl, lo, s: (b >> (7 - lvl)) & 1)
        probs[2 * t] = (low << 16) | w
        low, w, _ = _descend(tree, node,
                             lambda lvl, lo, s: (b >> (3 - lvl)) & 1)
        probs[2 * t + 1] = (low << 16) | w
    return probs.reshape(2 * K, G, GLANES).to(torch.int32)


def tree_decode_plain(gstreams: torch.Tensor, K: int,
                      tree_tbl: torch.Tensor):
    """gstreams [G, R, 128] -> (bytes [K, G, 128] uint8, final states
    [G, 128] int32).  Per nibble: the descent driven by the coder value
    (bit = value - low < s), the state step, then the group-ordered word
    fetch of ``rans_kernel.stream_reader``."""
    G = gstreams.shape[0]
    L = G * GLANES
    state, fetch = K_.stream_reader(gstreams)
    tree = _lane_trees(tree_tbl, L)
    root = torch.ones(L, dtype=torch.int64, device=gstreams.device)
    out = torch.empty((K, L), dtype=torch.uint8, device=gstreams.device)

    def nibble(state, node):
        value = state & rans.MASK15
        low, w, node = _descend(tree, node,
                                lambda lvl, lo, s: value - lo < s)
        state = (w * (state >> RC_BITS) + value - low) & rans.MASK32
        return fetch(state), node

    for t in range(K):
        state, node = nibble(state, root)   # hi: node 16 + hi below it
        state, node = nibble(state, node)   # lo: node 256 + byte below it
        out[t] = (node - 256).to(torch.uint8)
    return (out.reshape(K, G, GLANES),
            state.reshape(G, GLANES).to(torch.int32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_geom(geom: Geom, G: int) -> None:
    if geom.groups != G:
        raise ValueError(f"tile has {G} groups, geometry {geom.spec} "
                         f"has {geom.groups}")
    require_tree_format(geom)


def tree_model(cols: torch.Tensor, tree_tbl: torch.Tensor,
               geom: Geom = DEFAULT) -> torch.Tensor:
    """K9: cols [K, G, 128] uint8, tree [256] int32 -> probs [2K, G, 128]
    int32."""
    K, G = cols.shape[0], geom.groups
    _check_geom(geom, G)
    K_._check("cols", cols, torch.uint8, (K, G, GLANES), cols.device)
    K_._check("tree_tbl", tree_tbl, torch.int32, (256,), cols.device)
    if not cols.is_cuda:
        return tree_model_plain(cols, tree_tbl)
    probs = torch.empty((2 * K, G, GLANES), dtype=torch.int32,
                        device=cols.device)
    K_.launch("tree_model", "trc_tree_model", cols, tree_tbl, probs, K, G,
              counts=launches)
    return probs


def tree_decode_tile(gstreams: torch.Tensor, K: int, tree_tbl: torch.Tensor,
                     geom: Geom = DEFAULT):
    """K8: gstreams [G, R, 128] int32, tree [256] int32 -> (bytes
    [K, G, 128] uint8, final states [G, 128] int32; the final states carry
    the 15-bit seeds)."""
    G, R = geom.groups, gstreams.shape[1]
    dev = gstreams.device
    _check_geom(geom, G)
    K_._check("gstreams", gstreams, torch.int32, (G, R, GLANES), dev)
    K_._check("tree_tbl", tree_tbl, torch.int32, (256,), dev)
    if R < 2:
        raise ValueError("gstreams: needs the two flush-state rows")
    K_.check_ring_stream(gstreams)
    if not gstreams.is_cuda:
        return tree_decode_plain(gstreams, K, tree_tbl)
    out = torch.empty((K, G, GLANES), dtype=torch.uint8, device=dev)
    fstates = torch.empty((G, GLANES), dtype=torch.int32, device=dev)
    K_.launch("tree_decode", "trc_tree_decode",
              *tree_decode_cargs(gstreams, K, tree_tbl, out, fstates),
              counts=launches)
    return out, fstates


def tree_decode_cargs(gstreams, K: int, tree_tbl, out, fstates) -> list:
    """The arguments of ``trc_tree_decode`` (without the stream): the
    tile (the launch is the source's own: 128 threads, the ring, every
    lane's 16 lo subtree rows and the rank counts in shared memory)."""
    return [gstreams, tree_tbl, out, fstates, K, gstreams.shape[0],
            gstreams.shape[1]]


def encode_tile(block: torch.Tensor, K: int, tree_tbl: torch.Tensor,
                init_states: torch.Tensor, geom: Geom = DEFAULT):
    """block [L, K] bytes, lane l = contiguous span l -> (gstreams
    [G, R, 128], glens [G]): the tree model, then the flagship's coder and
    placement (JAX ``encode_tile_pallas``)."""
    cols = block.to(torch.uint8).T.contiguous().reshape(K, geom.groups,
                                                        GLANES)
    probs = tree_model(cols, tree_tbl, geom)
    words, emit, state = K_.coder(probs, init_states)
    return K_.place(words, emit, state, geom)
