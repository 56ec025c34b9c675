"""The launch of the bit-tree model K9 (``csrc/bittree_kernel.cu``) on the
CPU, without JAX.

No card is needed.  K9's launch is the source's own: CTAs of kTreeLanes
lanes, four a group, two threads a lane (the lo chain on warp 0, the hi
chain on warp 1), each CTA with a fixed carve of dynamic shared memory
(every lane's 17 subtree rows of 16 int nodes, then a ring of two stages
of kTreeSteps input byte steps), which ``_carve`` mirrors from the
source's numbers.  These tests hold the carve to the card's limits, the C
arguments to the entry point, the nodes the kernel addresses to the tree
walk, and a numpy mirror of the kernel's byte step to
``tree_model_plain``: the bytes come through the staged ring two steps
ahead, each chain reads the four path nodes of byte t + 2 right after it
stores byte t's updates, and byte t + 1's nodes take byte t's updated p
where the paths meet.  A mirror without that forwarding, or with a stage
requested into the buffer still being read, is caught.  The kernel
itself is held to ``tree_model_plain`` only on the card.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_tree_decode_launch import _slot_node, _subtree_slot
from turborc_tpu_torch.ops import bittree_kernel as B
from turborc_tpu_torch.ops import build
from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops.geom import Geom

CSRC = Path(B.__file__).parent / "csrc"
SOURCE = "".join((CSRC / name).read_text()
                 for name in ("bittree_kernel.cu", "rans_common.cuh"))
TREE_LANES = 32      # kTreeLanes: lanes a CTA
TREE_SPLIT = 2       # kTreeSplit: threads a lane (the lo and the hi chain)
TREE_STEPS = 16      # kTreeSteps: byte steps a stage of the input ring
SMEM_SM = 233_472    # kSmemSm: shared memory of an SM
SMEM_CTA = 1024      # kSmemCta: what the system keeps of it for each CTA
SMEM_DEFAULT = 48 * 1024  # dynamic shared memory a CTA has without opt-in
MAX_THREADS = 1024


def test_source_constants_match():
    """The kernel is compiled with the numbers the mirror uses."""
    for name, value in (("kLanes", B.GLANES), ("kTreeLanes", TREE_LANES),
                        ("kTreeSplit", TREE_SPLIT),
                        ("kTreeSteps", TREE_STEPS),
                        ("kSmemMax", TK.SMEM_MAX), ("kSmemSm", SMEM_SM),
                        ("kSmemCta", SMEM_CTA)):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m and int(m.group(1)) == value, name


def _carve() -> TK.TableLaunch:
    """K9's carve as the source lays it out (kTreeMNodes, kTreeMCols,
    kTreeMSmem): 17 rows x 16 slots x 32 lanes of int nodes, then two
    stages of 16 byte steps x 32 lanes; two threads a lane."""
    ln = TK.table_launch((17 * 16 * TREE_LANES * 4,
                          2 * TREE_STEPS * TREE_LANES))
    return TK.TableLaunch(TREE_LANES * TREE_SPLIT, ln.smem, ln.offsets,
                          ln.sizes)


def test_carve_sizes():
    for line in ("constexpr int kTreeMNodes = 0;",
                 "constexpr int kTreeMCols = kTreeMNodes + 17 * 16 * "
                 "kTreeLanes * 4;",
                 "constexpr int kTreeMSmem = kTreeMCols + 2 * kTreeSteps * "
                 "kTreeLanes;",
                 "constexpr int kTreeThreads = kTreeLanes * kTreeSplit;",
                 "static_assert(kTreeMSmem <= 48 * 1024,",
                 "static_assert(2 * (kTreeMSmem + kSmemCta) <= kSmemSm,",
                 "tree_model_kernel<<<G * (kLanes / kTreeLanes), "
                 "kTreeThreads, kTreeMSmem,"):
        assert line in SOURCE, line
    ln = _carve()
    assert ln.offsets == (0, 34_816)
    assert ln.smem == 35_840
    assert ln.threads == 64


@pytest.mark.parametrize("groups", (1, 2, 4, 8, 16, 64, 512, 32768))
def test_carve_fits_every_tree_geometry(groups):
    """Ordered 16-byte-aligned regions within the 48 KB a CTA has without
    opt-in, two CTAs an SM (1 KB of each kept by the system), a group in
    whole CTAs of whole warps, the grid within int32; a stage is at most
    one 16-byte copy a thread; the C arguments carry K and the groups."""
    ln = _carve()
    assert ln.threads == TREE_LANES * TREE_SPLIT <= MAX_THREADS
    assert ln.threads % 32 == 0 and TREE_LANES % 32 == 0
    assert B.GLANES % TREE_LANES == 0
    assert ln.smem <= SMEM_DEFAULT <= TK.SMEM_MAX
    assert 2 * (ln.smem + SMEM_CTA) <= SMEM_SM
    ends = [o + s for o, s in zip(ln.offsets, ln.sizes)]
    assert all(o % 16 == 0 for o in ln.offsets)
    assert all(e <= o for e, o in zip(ends, ln.offsets[1:]))
    assert ends[-1] <= ln.smem and ln.smem % 16 == 0
    assert TREE_STEPS * TREE_LANES // 16 <= ln.threads
    assert groups * (B.GLANES // TREE_LANES) <= TK.INT32_MAX
    K = 48
    cols = torch.zeros((K, groups, B.GLANES), dtype=torch.uint8)
    assert B.tree_model_cargs(cols, None, None)[3:] == [K, groups]


def test_c_arguments_match_the_entry_point():
    cols = torch.zeros((16, 2, 128), dtype=torch.uint8)
    args = B.tree_model_cargs(cols, None, None)
    assert len(args) + 1 == len(
        build.SIGNATURES["bittree_kernel.cu"]["trc_tree_model"])


def test_c_entry_refuses_what_it_cannot_take():
    """The checks of ``trc_tree_model`` are in its source: K and G, G
    within int32 lanes, the probs plane within size_t offsets, 16-byte
    aligned cols."""
    for line in ("const bool ok = K >= 0 && G >= 1 && G <= INT_MAX / kLanes &&",
                 "size_t(K) <= SIZE_MAX / 8 / (size_t(G) * kLanes) &&",
                 "(reinterpret_cast<uintptr_t>(cols) & 15) == 0;"):
        assert line in SOURCE, line


# ---------------------------------------------------------------------------
# the path nodes' slots
# ---------------------------------------------------------------------------

def _path_slot(n: int, level: int) -> int:
    """tree_node's slot: the node of ``level`` on the path of nibble n is
    heap slot 2^level - 1 + (n >> (4 - level)) of its subtree row."""
    return (1 << level) - 1 + (n >> (4 - level))


def test_path_slots_are_the_tree_walk():
    """For every byte, the four nodes the kernel addresses in row 16 (hi
    nibble) and in row hi (lo nibble) are the nodes the walk from node 1
    passes, at the slots K8's map gives them."""
    for byte in range(256):
        hi, lo = byte >> 4, byte & 15
        for level in range(4):
            node = (1 << level) + (hi >> (4 - level))  # hi: from node 1
            assert _subtree_slot(node) == (-1, _path_slot(hi, level))
            node = ((16 + hi) << level) + (lo >> (4 - level))
            assert _subtree_slot(node) == (hi, _path_slot(lo, level))
    assert "return ((r << 4) + (1 << l) - 1 + (n >> (4 - l))) * kTreeLanes;" \
        in SOURCE
    assert "nodes[((16 << 4) + i) * kTreeLanes] = v[i];" in SOURCE


# ---------------------------------------------------------------------------
# a numpy mirror of K9's byte step
# ---------------------------------------------------------------------------

HI_ROW = 16
# (row of a byte, nibble of a byte, probs slot offset) of the lo and the
# hi chain
CHAINS = ((lambda x: x >> 4, lambda x: x & 15, 1),
          (lambda x: np.full_like(x, HI_ROW), lambda x: x >> 4, 0))


def _mirror(cols: np.ndarray, tree: np.ndarray, forward: bool = True,
            stage_ahead: int = 1) -> np.ndarray:
    """K9's byte step in numpy on cols [K, G, 128] u8 and a tree [256] ->
    probs [2K, G, 128].

    The nodes are [L, 17 rows, 16 slots] (shared memory): the lo subtree
    of hi nibble h in row h, the hi subtree in row 16.  Each chain holds
    the p of the four path nodes of byte t (registers) and those of byte
    t + 1 as read.  The bytes come through a ring of two stages of
    TREE_STEPS steps, and byte step t reads byte t + 2: the first two
    stages are requested at the start, and at u = t + 2 = 0 mod
    TREE_STEPS the stage that starts at u is waited for and the stage
    ``stage_ahead`` stages later is requested into its buffer; a read of a
    slot that does not hold the byte raises AssertionError.  A chain's
    byte step: the splits, the updated nodes stored, byte t + 2's path
    nodes read; then byte t + 1's nodes are, with ``forward``, byte t's
    updated p where the node is the same (same row, same leading bits),
    else those read a step earlier (after byte t - 1's stores)."""
    K, G, _ = cols.shape
    L = G * B.GLANES
    flat = cols.reshape(K, L).astype(np.int64)
    p = np.clip(tree.astype(np.int64), 1, (1 << 15) - 1)
    nodes = np.zeros((L, 17, 16), np.int64)
    for r in range(16):
        for i in range(15):
            nodes[:, r, i] = p[_slot_node(r, i)]
    nodes[:, HI_ROW, :15] = p[1:16]
    D = TREE_STEPS
    ring = {}  # slot (t % 2D) -> byte step it holds

    def request(t0):
        for t in range(t0, min(t0 + D, K)):
            ring[t % (2 * D)] = t

    def read(t):
        assert ring.get(t % (2 * D)) == t, f"byte step {t} not in the ring"
        return flat[t]

    ar = np.arange(L)

    def path(row, nib, x):
        """The p of the four path nodes of byte x of a chain."""
        return [nodes[ar, row(x), _path_slot(nib(x), lv)] for lv in range(4)]

    request(0)
    request(D)
    zero = np.zeros(L, np.int64)
    b = read(0) if K > 0 else zero
    b1 = read(1) if K > 1 else zero
    cur = [path(row, nib, b) for row, nib, _ in CHAINS]
    nxt = [path(row, nib, b1) for row, nib, _ in CHAINS]
    probs = np.empty((2 * K, L), np.int64)
    for t in range(K):
        u = t + 2
        if u % D == 0:
            request(u + stage_ahead * D)
        b2 = read(u) if u < K else zero
        for k, (row, nib, slot) in enumerate(CHAINS):
            r, n = row(b), nib(b)
            low = np.zeros(L, np.int64)
            w = np.full(L, 1 << 15, np.int64)
            new = []
            for lv in range(4):
                m, bit = 8 >> lv, (n >> (3 - lv)) & 1
                s = np.minimum(np.maximum((w * cur[k][lv]) >> 15, m), w - m)
                low = np.where(bit != 0, low, low + s)
                w = np.where(bit != 0, s, w - s)
                pl = cur[k][lv]
                new.append(pl - (((pl - (bit << 15)) >> 5) + bit))
                nodes[ar, r, _path_slot(n, lv)] = new[lv]
            probs[2 * t + slot] = (low << 16) | w
            ahead = path(row, nib, b2)
            same = row(b1) == r
            x = nib(b1) ^ n
            cur[k] = [np.where(forward & same & (x >> (4 - lv) == 0),
                               new[lv], nxt[k][lv]) for lv in range(4)]
            nxt[k] = ahead
        b, b1 = b1, b2
    return probs.reshape(2 * K, G, B.GLANES)


KINDS = ("random", "runs", "one", "same-hi")


def _case(seed: int, K: int, G: int, kind: str):
    """cols [K, G, 128] of one kind and a tree with entries past both
    clamps: random bytes; runs of one byte; one byte a lane; bytes whose hi
    nibble repeats for stretches while the lo nibble changes."""
    rng = np.random.default_rng(seed)
    L = G * B.GLANES
    if kind == "random":
        x = rng.integers(0, 256, (K, L))
    elif kind == "runs":
        x = np.repeat(rng.integers(0, 256, (K // 4 + 1, L)), 4, 0)[:K]
    elif kind == "one":
        x = np.broadcast_to(rng.integers(0, 256, (1, L)), (K, L))
    else:
        hi = np.repeat(rng.integers(0, 3, (K // 8 + 1, L)), 8, 0)[:K]
        x = (hi << 4) | rng.integers(0, 16, (K, L))
    tree = rng.integers(-5, 32_800, 256).astype(np.int32)
    tree[rng.integers(1, 256, 8)] = 32_767
    tree[rng.integers(1, 256, 8)] = 1
    return x.astype(np.uint8).reshape(K, G, B.GLANES), tree


def _plain(cols: np.ndarray, tree: np.ndarray) -> np.ndarray:
    return B.tree_model_plain(torch.from_numpy(cols),
                              torch.from_numpy(tree)).numpy()


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 70), st.sampled_from(KINDS))
def test_mirror_equals_tree_model_plain(seed, K, kind):
    """The staged, split byte step (picks before splits, the next lo row
    read a step ahead, forwarded where the hi nibble repeats) gives
    tree_model_plain's probs at K below, at and past a stage of 16."""
    cols, tree = _case(seed, K, 1, kind)
    assert np.array_equal(_mirror(cols, tree), _plain(cols, tree))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", (0, 5, 16, 37), ids=lambda k: f"K{k}")
def test_mirror_equals_tree_model_plain_two_groups(K, kind):
    """G = 2, at K = 0, K below one stage (5), one stage (16) and a K that
    is not a multiple of it (37), every kind of bytes."""
    cols, tree = _case(11 + K, K, 2, kind)
    assert np.array_equal(_mirror(cols, tree), _plain(cols, tree))


@pytest.mark.parametrize("kind", KINDS)
def test_mirror_without_forwarding_is_caught(kind):
    """Without forwarding, byte t + 1's nodes miss byte t's updates where
    the paths meet (the hi root on every byte): the probs differ from
    tree_model_plain."""
    cols, tree = _case(3, 40, 1, kind)
    assert not np.array_equal(_mirror(cols, tree, forward=False),
                              _plain(cols, tree))


def test_stage_into_the_buffer_being_read_is_caught():
    """A stage requested two stages ahead lands in the buffer whose bytes
    are still to be read."""
    cols, tree = _case(5, 64, 1, "random")
    with pytest.raises(AssertionError, match="not in the ring"):
        _mirror(cols, tree, stage_ahead=2)


# ---------------------------------------------------------------------------
# the wrapper's refusals
# ---------------------------------------------------------------------------

def test_wrapper_refuses_misaligned_cols():
    """The input ring copies 16 bytes at a time: a cols view 1 byte past
    a 16-byte boundary is refused on every device, with no launch."""
    G, K = 1, 16
    tree = torch.from_numpy(B.warm_tree(np.arange(64, dtype=np.uint8)))
    buf = torch.zeros(K * G * 128 + 16, dtype=torch.uint8)
    at = -buf.data_ptr() % 16  # the first 16-byte boundary in buf
    cols = buf[at + 1:at + 1 + K * G * 128].view(K, G, 128)
    assert cols.is_contiguous() and cols.data_ptr() % 16 == 1
    B.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        B.tree_model(cols, tree, Geom(groups=G))
    good = buf[at:at + K * G * 128].view(K, G, 128)
    assert B.tree_model(good, tree, Geom(groups=G)).shape == (2 * K, G, 128)
    assert B.launches["tree_model"] == 0
