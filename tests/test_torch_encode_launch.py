"""The launches of the o0 encode kernels K2 and K4 (``csrc/rans_kernel.cu``)
on the CPU, without JAX.

No card is needed: ``rans_kernel.model_launch`` computes the threads,
shared-memory bytes and carve-up that K2's wrapper hands its C entry, and
``rans_kernel.place_launch`` the plan of K4's two launches (count, then
place) that its C entry re-checks.  These tests hold
both to the card's limits and to int32 indices, and hold a numpy mirror of
K4's decomposition (chunk counts -> each chunk's base -> a scan of the
chunk's 16-lane emit masks -> scatter, and the zero tail split over the
chunks) to ``place_plain``, the kernel's oracle.
"""
from __future__ import annotations

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from turborc_tpu_torch.ops import build
from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops.geom import Geom

# rans_kernel.cu and the header it includes (the ring and the card's
# shared-memory limit live there)
SOURCE = "".join((Path(TK.__file__).parent / "csrc" / name).read_text()
                 for name in ("rans_kernel.cu", "rans_common.cuh"))
MAX_THREADS = 1024
SEGS = TK.GLANES // 16  # 16-lane segments a slot (16 bytes of emit)


# ---------------------------------------------------------------------------
# K2's launch
# ---------------------------------------------------------------------------

def test_source_constants_match():
    """The kernels are compiled with the numbers the wrappers launch with."""
    for name, value in (("kColSteps", TK.COL_STEPS),
                        ("kPlaceChunk", TK.PLACE_CHUNK),
                        ("kPlaceThreads", TK.PLACE_THREADS),
                        ("kSmemMax", TK.SMEM_MAX)):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m and int(m.group(1)) == value, name


def _header_geoms():
    """Every (share, arows, nstates) the header can carry; the other
    fields size nothing in K2's carve (test_model_launch_reads_only_share_
    and_arows checks that)."""
    for share, arows, ns in itertools.product(
            (1, 2, 4, 8, 16, 32, 64, 128), range(17), (1, 2)):
        yield Geom(groups=64, chunk=8, share=share, sync=8, lsync=32,
                   arows=arows, srows=4, nstates=ns)


def test_model_carve_fits_every_header_geometry():
    for g in _header_geoms():
        ln = TK.model_launch(g)
        assert ln.threads == TK.GLANES <= MAX_THREADS
        assert ln.smem <= TK.SMEM_MAX, g.spec
        assert len(ln.offsets) == len(ln.sizes) == len(TK.MODEL_REGIONS)
        ends = [o + s for o, s in zip(ln.offsets, ln.sizes)]
        assert all(o % 16 == 0 for o in ln.offsets), g.spec
        assert all(e <= o for e, o in zip(ends, ln.offsets[1:])), g.spec
        assert ends[-1] <= ln.smem and ln.smem % 16 == 0
        size = dict(zip(TK.MODEL_REGIONS, ln.sizes))
        assert size["cols"] == 2 * TK.COL_STEPS * TK.GLANES
        # per-lane rows only below arows, start copies only when shared,
        # the cross-warp sums only when a set spans warps
        assert size["lo"] == g.arows * TK.GLANES * 32
        assert size["st"] == (size["lo"] if g.share > 1 else 0)
        assert size["fixed"] == (16 - g.arows) * 32
        assert (size["red"] > 0) == (g.share > 32)


def test_model_launch_reads_only_share_and_arows():
    base = TK.model_launch(Geom.parse("g64c8s8y8l32a4r4"))
    for spec in ("g1c8s8y8l32a4r4", "g64c2s8y2l4a4r4", "g64c8s8y8l32a4r20",
                 "g64c8s8y8l32a4r4u10", "g64c8s8y8l32a4r4x2",
                 "g32768c128s8y128l128a4r31"):
        assert TK.model_launch(Geom.parse(spec)) == base, spec


@pytest.mark.parametrize("spec, sizes", [
    # the bench geometry: 4 adaptive rows a lane, their start copies, the
    # 12 static rows once, the 16 KB stage
    ("g64c8s8y8l32a4r4", (16384, 16384, 16384, 12 * 32, 0)),
    # the default geometry: all 16 rows adapt
    ("g64c8s8y4l32a16r4", (16384, 65536, 65536, 0, 0)),
    # share 1: no re-join, no start copies
    ("g2c2s1y2l4a16r4", (16384, 65536, 0, 0, 0)),
    # share 128 spans four warps; arows 0 keeps every row static
    ("g1c8s128y8l32a0r2u9", (16384, 0, 0, 512, 4 * 16 * 4)),
])
def test_model_carve_at_named_geometries(spec, sizes):
    ln = TK.model_launch(Geom.parse(spec))
    assert dict(zip(TK.MODEL_REGIONS, ln.sizes)) == \
        dict(zip(TK.MODEL_REGIONS, sizes))
    assert ln.smem == sum(-(-n // 16) * 16 for n in sizes)


def test_model_arguments_match_the_entry_point():
    g = Geom.parse("g2c8s64y8l32a4r4")
    cols = torch.zeros((32, 2, 128), dtype=torch.uint8)
    probs = torch.empty((64, 2, 128), dtype=torch.int32)
    hi = torch.zeros((16, 2), dtype=torch.int32)
    lo = torch.zeros((16, 16, 2), dtype=torch.int32)
    args = TK.model_cargs(cols, hi, lo, probs, g)
    assert len(args) + 1 == len(build.SIGNATURES["rans_kernel.cu"]
                                ["trc_model"])
    ln = TK.model_launch(g)
    assert args[4:12] == [32, 2, 64, 8, 32, 4, 4, 7]
    assert args[12:] == [ln.threads, ln.smem, *ln.offsets]


# ---------------------------------------------------------------------------
# K4's plan
# ---------------------------------------------------------------------------

def _rows(S: int) -> int:
    return S + 2 + Geom().wrows


@pytest.mark.parametrize("S", (4096, 8192, 16384, 4133, 100, 64, 65, 1))
@pytest.mark.parametrize("G", (1, 2, 3, 64))
def test_place_plan_holds(S, G):
    R = _rows(S)
    ln = TK.place_launch(S, G, R)
    assert (ln.S, ln.G, ln.R) == (S, G, R)
    assert ln.chunk == TK.PLACE_CHUNK and ln.threads == TK.PLACE_THREADS
    assert ln.threads <= MAX_THREADS
    # every slot in exactly one chunk, the last chunk not empty
    assert (ln.chunks - 1) * ln.chunk < S <= ln.chunks * ln.chunk
    assert ln.grid == G * ln.chunks >= G  # more CTAs than groups once S > 64
    assert ln.scratch >= ln.grid
    # int32 indices: the last position, count and CTA
    assert R * TK.GLANES - 1 <= TK.INT32_MAX
    assert ln.grid - 1 <= TK.INT32_MAX
    # every data position fits the stream: 256 + S * 128 <= R * 128
    assert 2 * TK.GLANES + S * TK.GLANES <= R * TK.GLANES


def test_place_plan_at_the_main_shapes():
    """id 57 (S = 16384, G = 64), x2 (8192 a set), ids 60 and 8 (4096):
    thousands of CTAs on 132 SMs, not one a group."""
    for S, chunks in ((16384, 256), (8192, 128), (4096, 64)):
        ln = TK.place_launch(S, 64, _rows(S))
        assert (ln.chunks, ln.grid) == (chunks, 64 * chunks)


def test_place_plan_empty_and_largest():
    ln = TK.place_launch(0, 4, _rows(0))
    assert ln.chunks == 1  # one CTA a group still writes rows 0/1 and glens
    assert ln.grid == ln.scratch == 4
    # the most slots whose stream positions stay inside int32 (the wrapper
    # refuses one more): R * 128 = 2^31 - 128
    S = (TK.INT32_MAX + 1) // TK.GLANES - 3 - Geom().wrows
    ln = TK.place_launch(S, 64, _rows(S))
    assert _rows(S) * TK.GLANES - 1 <= TK.INT32_MAX
    assert (_rows(S) + 1) * TK.GLANES > TK.INT32_MAX
    assert (ln.chunks - 1) * ln.chunk < S <= ln.chunks * ln.chunk
    assert ln.grid == ln.scratch == 64 * ln.chunks <= TK.INT32_MAX


def test_place_arguments_match_the_entry_point():
    ln = TK.place_launch(100, 2, _rows(100))
    args = TK.place_cargs(*[None] * 6, ln)
    assert len(args) + 1 == len(build.SIGNATURES["rans_kernel.cu"]
                                ["trc_place"])
    assert args[6:] == [100, 2, _rows(100), ln.chunk, ln.chunks, ln.threads,
                        ln.scratch]


# ---------------------------------------------------------------------------
# A numpy mirror of K4's decomposition, against place_plain
# ---------------------------------------------------------------------------

def mirror_place(words, emit, state, R, ln, base_bias=0):
    """K4 as its kernels compute it: place_count_kernel's chunk counts,
    each chunk's base (the counts of the group's earlier chunks; biased by
    ``base_bias`` for the negative control), place_kernel's exclusive scan
    of the chunk's 16-lane segment masks, the scatter, rows 0/1, and the
    zero tail split over the group's chunks in 16-byte quads."""
    S, G, L = emit.shape
    C, CH = ln.chunks, ln.chunk
    flag = np.zeros((C * CH, G, L), bool)
    flag[:S] = emit != 0
    # count pass: counts[g, c] (the kernel's scratch, G x C int32)
    seg = flag.reshape(C, CH, G, SEGS, 16)
    masks = (seg * (1 << np.arange(16))).sum(-1)       # [C, CH, G, SEGS]
    pop = seg.sum(-1)
    counts = pop.sum((1, 3)).T                          # [G, C]
    assert counts.size <= ln.scratch
    out = np.full((G, R * L), -1, np.int64)             # -1: never written
    for g, c in itertools.product(range(G), range(C)):
        base = int(counts[g, :c].sum()) + base_bias
        length = int(counts[g].sum())
        n = pop[c, :, g].reshape(-1)                    # segments in order
        pre = np.cumsum(n) - n
        m = masks[c, :, g].reshape(-1)
        for k in np.flatnonzero(n):
            s, part = divmod(k, SEGS)
            for j in range(16):
                if m[k] >> j & 1:
                    rank = bin(int(m[k]) & ((1 << j) - 1)).count("1")
                    out[g, 256 + base + pre[k] + rank] = \
                        words[c * CH + s, g, part * 16 + j]
        z0, lim = 256 + length, R * L
        q0, q1 = -(-z0 // 4), lim // 4
        nq = max(q1 - q0, 0)
        a, e = q0 + nq * c // C, q0 + nq * (c + 1) // C
        out[g, 4 * a:4 * e] = 0
        if c == 0:
            st_ = state[g].astype(np.int64) & 0xFFFFFFFF
            out[g, :L] = st_ >> 16
            out[g, L:2 * L] = st_ & 0xFFFF
            out[g, z0:min(4 * q0, lim)] = 0
    glens = 256 + counts.sum(1)
    return out.reshape(G, R, L), glens


def _tile(S, G, density, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 16, (S, G, 128), dtype=np.int32)
    if density in (0.0, 1.0):
        emit = np.full((S, G, 128), density, np.uint8)
    else:
        emit = (rng.random((S, G, 128)) < density).astype(np.uint8)
    state = rng.integers(-(1 << 31), 1 << 31, (G, 128), dtype=np.int64)
    return words, emit, state.astype(np.int32)


def _plain(words, emit, state, G):
    gs, gl = TK.place_plain(torch.from_numpy(words), torch.from_numpy(emit),
                            torch.from_numpy(state), Geom(groups=G))
    return gs.numpy(), gl.numpy()


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.sampled_from((1, 2, 4)),
       st.sampled_from((0.0, 1.0, 0.02, 0.3, 0.9)), st.integers(0, 2**31))
def test_mirror_equals_place_plain(S, G, density, seed):
    words, emit, state = _tile(S, G, density, seed)
    R = _rows(S)
    ln = TK.place_launch(S, G, R)
    got, glens = mirror_place(words, emit, state, R, ln)
    want, want_len = _plain(words, emit, state, G)
    assert (got >= 0).all(), "a stream position was never written"
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(glens, want_len)


@pytest.mark.parametrize("case", ("one-last", "all", "none", "ragged"))
def test_mirror_edge_cases(case):
    S, G = {"one-last": (200, 2), "all": (130, 1), "none": (64, 4),
            "ragged": (129, 2)}[case]
    density = {"all": 1.0, "none": 0.0}.get(case, 0.4)
    words, emit, state = _tile(S, G, density, 7)
    if case == "one-last":
        emit[:] = 0
        emit[S - 1, G - 1, 127] = 1
    R = _rows(S)
    got, glens = mirror_place(words, emit, state, R, TK.place_launch(S, G, R))
    want, want_len = _plain(words, emit, state, G)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(glens, want_len)


@pytest.mark.parametrize("bias", (1, -1))
def test_mirror_catches_an_off_by_one_base(bias):
    """Negative control: a chunk base one off moves the words of every
    chunk but the first, and the mirror no longer equals the oracle."""
    S, G = 150, 2
    words, emit, state = _tile(S, G, 0.3, 11)
    R = _rows(S)
    ln = TK.place_launch(S, G, R)
    want, _ = _plain(words, emit, state, G)
    got, _ = mirror_place(words, emit, state, R, ln, base_bias=bias)
    assert not np.array_equal(got, want)


def test_mirror_catches_too_little_scratch():
    import dataclasses
    S, G = 150, 2
    words, emit, state = _tile(S, G, 0.3, 12)
    R = _rows(S)
    ln = dataclasses.replace(TK.place_launch(S, G, R), scratch=5)
    with pytest.raises(AssertionError):
        mirror_place(words, emit, state, R, ln)
