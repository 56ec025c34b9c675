"""The bit-tree decoder K8 (``csrc/bittree_kernel.cu``) on the CPU,
without JAX.

No card is needed.  K8 holds the 255-node tree as 16-entry subtree rows:
the hi nibble's subtree (nodes 1-15) in registers, the lo subtree under
node 16 + hi in shared-memory row hi, a node of level l on path j at heap
slot 2^l - 1 + j (``_subtree_slot``).  It runs on the o0
decoders' ring of stream words, two fetches a byte, with a fixed carve of
dynamic shared memory (ring, every lane's 16 lo rows, rank counts), which
``_carve`` mirrors from the source's numbers.  These tests hold the slot
map to a bijection that keeps every parent's children, a numpy mirror of
the kernel's register descent and select-tree updates to
``tree_decode_plain`` on streams that the plain encode path wrote (a
mirror without the updates is caught), the ring to its two promises on
the mirror's own fetches, the carve to the card's limits, and the wrapper
to refusing streams the ring cannot take.  The kernel itself is held to
``tree_decode_plain`` only on the card.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from turborc_tpu_torch.codecs import rc_tree as CT
from turborc_tpu_torch.ops import bittree_kernel as B
from turborc_tpu_torch.ops import build
from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops.geom import Geom

CSRC = Path(B.__file__).parent / "csrc"
SOURCE = "".join((CSRC / name).read_text()
                 for name in ("bittree_kernel.cu", "rans_common.cuh"))
MAX_THREADS = 1024
MASK32 = (1 << 32) - 1


def test_source_constants_match():
    for name, value in (("kLanes", B.GLANES), ("kRingWords", TK.RING_WORDS),
                        ("kSmemMax", TK.SMEM_MAX)):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m and int(m.group(1)) == value, name


def _carve() -> TK.TableLaunch:
    """K8's launch as the source carves it (kTreeRing, kTreeRows,
    kTreeRank, kTreeSmem): the ring of stream words, 16 lo rows x 32 B x
    128 lanes, a rank byte a warp in two buffers."""
    return TK.table_launch((TK.RING_WORDS * 4, 16 * B.GLANES * 32,
                            2 * (B.GLANES // 32)))


def test_carve_fits():
    """One thread a lane, ordered 16-byte-aligned regions within the
    232,448 B a CTA may have."""
    for line in ("constexpr int kTreeRing = 0;",
                 "constexpr int kTreeRows = kTreeRing + kRingWords * 4;",
                 "constexpr int kTreeRank = kTreeRows + 16 * kLanes * 32;",
                 "constexpr int kTreeSmem = (kTreeRank + 2 * kWarps + 15) / "
                 "16 * 16;",
                 "tree_decode_kernel<<<G, kLanes, kTreeSmem,"):
        assert line in SOURCE, line
    ln = _carve()
    assert ln.offsets == (0, 16_384, 16_384 + 65_536)
    assert ln.smem == 16_384 + 65_536 + 16 <= TK.SMEM_MAX
    assert ln.threads == B.GLANES <= MAX_THREADS
    ends = [o + s for o, s in zip(ln.offsets, ln.sizes)]
    assert all(o % 16 == 0 for o in ln.offsets)
    assert all(e <= o for e, o in zip(ends, ln.offsets[1:]))
    assert ends[-1] <= ln.smem


def test_c_arguments_match_the_entry_point():
    G, R, K = 2, 40, 16
    gs = torch.zeros((G, R, 128), dtype=torch.int32)
    args = B.tree_decode_cargs(gs, K, None, None, None)
    assert len(args) + 1 == len(
        build.SIGNATURES["bittree_kernel.cu"]["trc_tree_decode"])
    assert args[4:] == [K, G, R]


# ---------------------------------------------------------------------------
# the subtree rows
# ---------------------------------------------------------------------------

def _subtree_slot(node: int) -> tuple[int, int]:
    """Where K8 keeps tree node ``node`` (1-255): (row, heap slot), row
    -1 for the hi nibble's subtree (nodes 1-15, in registers), else the
    lo subtree row 0-15 rooted at node 16 + row; the node of level l on
    path j of a subtree is at slot 2^l - 1 + j."""
    if not 1 <= node < 256:
        raise ValueError(f"node {node} is not in the tree")
    level = node.bit_length() - (1 if node < 16 else 5)
    root = node >> level
    return (-1 if node < 16 else root - 16), (1 << level) - 1 + node - (
        root << level)


def _slot_node(row: int, slot: int) -> int:
    """The node the kernel loads into slot ``slot`` of lo row ``row``:
    ((16 + row) << l) + slot + 1 - 2^l, l the slot's level."""
    level = (slot + 1).bit_length() - 1
    return ((16 + row) << level) + slot + 1 - (1 << level)


def test_subtree_slots_are_a_bijection_that_keeps_children():
    """Nodes 1-15 fill slots 0-14 of the hi subtree, nodes 16-255 slots
    0-14 of the 16 lo rows, each (row, slot) once; the bit-b child 2n + b
    of a node at slot i of a row is at slot 2i + 1 + b of the same row,
    and the children of the hi subtree's last level are the lo rows'
    roots."""
    where = {n: _subtree_slot(n) for n in range(1, 256)}
    assert len(set(where.values())) == 255
    assert {where[n] for n in range(1, 16)} == {(-1, i) for i in range(15)}
    assert {where[n] for n in range(16, 256)} == {
        (r, i) for r in range(16) for i in range(15)}
    for n in range(1, 128):
        row, i = where[n]
        for b in (0, 1):
            child = where[2 * n + b]
            if 8 <= n < 16:  # the hi nibble's last level: node 16 + hi
                assert child == (2 * n + b - 16, 0)
            else:
                assert child == (row, 2 * i + 1 + b)
    for r in range(16):  # the kernel's load of each lo row
        for i in range(15):
            assert _subtree_slot(_slot_node(r, i)) == (r, i)
    assert ("v[i] = i < 15 ? clamp_p(tree_tbl[((16 + h) << l) + i + 1 - "
            "(1 << l)])" in SOURCE)
    with pytest.raises(ValueError):
        _subtree_slot(256)


# ---------------------------------------------------------------------------
# a numpy mirror of K8's byte step
# ---------------------------------------------------------------------------

def _pick(n: np.ndarray, level: int, j: np.ndarray) -> np.ndarray:
    """pick_level: slot 2^level - 1 + j of rows n [L, 16], by a select
    tree on the bits of j, lowest first."""
    v = n[:, (1 << level) - 1:(2 << level) - 1]
    for b in range(level):
        v = np.where(((j >> b) & 1)[:, None] != 0, v[:, 1::2], v[:, 0::2])
    return v[:, 0]


def _descend(n: np.ndarray, value: np.ndarray):
    """descend_row: (nibble, low, w, the p of the four path nodes)."""
    L = n.shape[0]
    j = np.zeros(L, np.int64)
    low = np.zeros(L, np.int64)
    w = np.full(L, 1 << 15, np.int64)
    ps = []
    for level in range(4):
        p = _pick(n, level, j)
        m = 8 >> level
        s = np.minimum(np.maximum((w * p) >> 15, m), w - m)
        bit = (value - low < s).astype(np.int64)
        low = np.where(bit != 0, low, low + s)
        w = np.where(bit != 0, s, w - s)
        ps.append(p)
        j = 2 * j + bit
    return j, low, w, ps


def _update_path(n: np.ndarray, nib: np.ndarray, ps: list) -> np.ndarray:
    """update_path: each path node's counter update by 2^level
    conditional selects."""
    n = n.copy()
    for level, p in enumerate(ps):
        j = nib >> (4 - level)
        bit = (nib >> (3 - level)) & 1
        newp = p - (((p - (bit << 15)) >> 5) + bit)
        for i in range(1 << level):
            at = (1 << level) - 1 + i
            n[:, at] = np.where(j == i, newp, n[:, at])
    return n


def _mirror(gstreams: np.ndarray, K: int, tree: np.ndarray,
            update: bool = True):
    """K8's byte step in numpy: gstreams [G, R, 128], tree [256] ->
    (bytes [K, G, 128], final states [G, 128], the words each fetch took
    per group [G][2K])."""
    G, R, _ = gstreams.shape
    L = G * B.GLANES
    flat = gstreams.reshape(G, R * B.GLANES).astype(np.int64)
    limit = R * B.GLANES
    state = (((flat[:, :128] << 16) | flat[:, 128:256]) & MASK32).reshape(L)
    pos = np.full(G, 256, np.int64)
    takes = [[] for _ in range(G)]
    p = np.clip(tree.astype(np.int64), 1, (1 << 15) - 1)
    hi = np.zeros((L, 16), np.int64)
    hi[:, :15] = p[1:16]
    rows = np.zeros((L, 16, 16), np.int64)
    for r in range(16):
        for i in range(15):
            rows[:, r, i] = p[_slot_node(r, i)]

    def fetch(state):
        need = (state < (1 << 15)).reshape(G, B.GLANES)
        rank = np.cumsum(need, 1) - need
        at = pos[:, None] + rank
        word = np.where(at < limit,
                        np.take_along_axis(flat, np.minimum(at, limit - 1),
                                           1), 0)
        for g in range(G):
            takes[g].append(int(need[g].sum()))
        pos[:] = np.minimum(pos + need.sum(1), limit)
        new = ((state.reshape(G, -1) << 16) | word) & MASK32
        return np.where(need, new, state.reshape(G, -1)).reshape(L)

    def nibble(n, state):
        value = state & ((1 << 15) - 1)
        nib, low, w, ps = _descend(n, value)
        state = (w * (state >> 15) + value - low) & MASK32
        return nib, ps, fetch(state)

    ar = np.arange(L)
    out = np.empty((K, L), np.uint8)
    for t in range(K):
        hs, ps, state = nibble(hi, state)
        lrow = rows[ar, hs]
        if update:
            hi = _update_path(hi, hs, ps)
        ls, ps, state = nibble(lrow, state)
        if update:
            rows[ar, hs] = _update_path(lrow, ls, ps)
        out[t] = (hs << 4) | ls
    return (out.reshape(K, G, B.GLANES),
            state.reshape(G, B.GLANES).astype(np.int64), takes)


def _encoded(seed: int, spec: str, n: int, skew: float):
    """A block of n bytes (a geometric byte distribution of ratio
    ``skew``) through the plain encode path: tree_model_plain, coder_plain,
    place_plain (the wrappers on the CPU)."""
    rng = np.random.default_rng(seed)
    data = np.minimum(rng.geometric(1 - skew, n) - 1, 255).astype(np.uint8)
    geom = Geom.parse(spec)
    a = CT.encode_args(data, geom, "cpu")
    gs, _ = B.encode_tile(a.block, a.K, a.tree, a.init_states, geom)
    return a, gs, geom


CASES = (("g1c2s8y2l4a16r4", 20_000, 0.9), ("g1c2s8y2l4a16r4", 9_000, 0.99),
         ("g2c8s8y4l32a16r4", 40_000, 0.95))


@pytest.mark.parametrize("spec,n,skew", CASES)
def test_mirror_decodes_like_tree_decode_plain(spec, n, skew):
    """The register descent and its select-tree updates decode what the
    plain encode path wrote to tree_decode_plain's bytes and final states
    (and to the block and the seeded states); a mirror without the
    updates is caught."""
    a, gs, geom = _encoded(1, spec, n, skew)
    out, fs, takes = _mirror(gs.numpy(), a.K, a.tree.numpy())
    p_out, p_fs = B.tree_decode_plain(gs, a.K, a.tree)
    assert np.array_equal(out, p_out.numpy())
    assert np.array_equal(fs, p_fs.numpy().astype(np.int64) & MASK32)
    assert np.array_equal(out.reshape(a.K, -1).T, a.block.numpy())
    assert all(len(x) == 2 * a.K for x in takes)
    stale, _, _ = _mirror(gs.numpy(), a.K, a.tree.numpy(), update=False)
    assert not np.array_equal(stale, p_out.numpy())


@pytest.mark.parametrize("spec,n,skew", CASES)
def test_ring_holds_on_the_decoders_fetches(spec, n, skew):
    """The ring at two fetches a byte, on the words each fetch of the
    mirror's decode took from each group's stream."""
    a, gs, _ = _encoded(2, spec, n, skew)
    _, _, takes = _mirror(gs.numpy(), a.K, a.tree.numpy())
    for g, seq in enumerate(takes):
        TK.ring_check(seq, gs.shape[1] * 128)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 128), st.integers(0, 128)),
                max_size=100),
       st.integers(2, 400))
def test_ring_two_fetches_a_byte(takes, rows):
    """Fetches of 0-128 words, two a byte, on streams of random length:
    every word read has arrived, no unread word is overwritten."""
    TK.ring_check([n for pair in takes for n in pair], rows * 128)


# ---------------------------------------------------------------------------
# the wrapper's refusals
# ---------------------------------------------------------------------------

def test_wrapper_refuses_a_misaligned_stream():
    G, R, K = 1, 8, 4
    tree = torch.from_numpy(B.warm_tree(np.arange(64, dtype=np.uint8)))
    buf = torch.zeros(G * R * 128 + 1, dtype=torch.int32)
    gs = buf[1:].view(G, R, 128)  # 4 bytes past a 16-byte boundary
    assert gs.is_contiguous() and gs.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        B.tree_decode_tile(gs, K, tree, Geom(groups=G))
    B.tree_decode_tile(buf[:-1].view(G, R, 128), K, tree, Geom(groups=G))


def test_wrapper_refuses_an_oversized_stream():
    """R * 128 plus two rings must stay an int32 stream position; the
    tiles live on the meta device, so nothing is allocated."""
    top = (TK.INT32_MAX - 2 * TK.RING_WORDS) // 128
    tree = torch.empty(256, dtype=torch.int32, device="meta")
    gs = torch.empty((1, top + 1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="int32 positions"):
        B.tree_decode_tile(gs, 4, tree, Geom(groups=1))
    TK.check_ring_stream(torch.empty((1, top, 128), dtype=torch.int32,
                                     device="meta"))
    assert "R <= (INT_MAX - 2 * kRingWords) / kLanes" in SOURCE
