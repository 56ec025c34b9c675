"""The o0 decoders' launch (K1 and K5, ``csrc/rans_kernel.cu``) on the CPU.

No card is needed: ``rans_kernel.decode_launch`` computes the threads, the
shared-memory bytes and the carve-up that the wrapper hands the C entry,
and ``rans_kernel.ring_check`` mirrors the rule by which the kernel tops up
its ring of stream words.  These tests hold both to the card's limits for
every geometry the 4-byte container header can carry, and the ring to its
two promises: no word is read before it arrived, and no word is
overwritten before it was read.
"""
from __future__ import annotations

import itertools
import re
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops.geom import Geom

# rans_kernel.cu and the header it includes (the ring and the card's
# shared-memory limit live there)
SOURCE = "".join((Path(TK.__file__).parent / "csrc" / name).read_text()
                 for name in ("rans_kernel.cu", "rans_common.cuh"))
MAX_THREADS = 1024


def _header_geoms(nstates):
    """Every geometry the header can carry at ``nstates``, up to the fields
    the launch does not read: groups, chunk, sync, lsync, srows and rate
    size nothing in it (test_launch_reads_only_share_arows_nstates checks
    that)."""
    for share, arows in itertools.product((1, 2, 4, 8, 16, 32, 64, 128),
                                          range(17)):
        yield Geom(groups=64, chunk=8, share=share, sync=8, lsync=32,
                   arows=arows, srows=4, nstates=nstates)


def test_source_constants_match():
    """The kernel is compiled with the numbers the wrapper launches with."""
    for name, value in (("kRingWords", TK.RING_WORDS),
                        ("kRingEvery", TK.RING_EVERY),
                        ("kRingLag", TK.RING_LAG),
                        ("kSmemMax", TK.SMEM_MAX)):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m and int(m.group(1)) == value, name


@pytest.mark.parametrize("nstates", (1, 2))
def test_every_header_geometry_fits(nstates):
    for g in _header_geoms(nstates):
        ln = TK.decode_launch(g)
        assert ln.threads == 128 <= MAX_THREADS
        assert ln.smem <= TK.SMEM_MAX, g.spec
        ends = [o + s for o, s in zip(ln.offsets, ln.sizes)]
        assert all(o % 16 == 0 for o in ln.offsets)
        assert all(e <= o for e, o in zip(ends, ln.offsets[1:])), g.spec
        assert ends[-1] <= ln.smem
        ring = dict(zip(TK.REGIONS, ln.sizes))["ring"]
        assert ring == g.nstates * TK.RING_WORDS * 4


def test_launch_reads_only_share_arows_nstates():
    base = TK.decode_launch(Geom.parse("g64c8s8y8l32a4r4"))
    for spec in ("g1c8s8y8l32a4r4", "g64c2s8y2l4a4r4", "g64c8s8y8l32a4r20",
                 "g64c8s8y8l32a4r4u10", "g32768c128s8y128l128a4r31"):
        assert TK.decode_launch(Geom.parse(spec)) == base, spec


@pytest.mark.parametrize("spec, sizes", [
    # the bench geometry: only the 4 adaptive rows are per lane (16 KB,
    # 16 KB of start copies) beside the 16 KB ring
    ("g64c8s8y8l32a4r4", (16384, 16384, 16384, 12 * 32, 0, 8)),
    # share 1: no re-join, so no start copies
    ("g64c8s1y8l32a4r4", (16384, 16384, 0, 12 * 32, 0, 8)),
    # x2: two rings, two sets of rank counts
    ("g64c8s8y8l32a4r4x2", (32768, 16384, 16384, 12 * 32, 0, 16)),
    # the default geometry: all 16 rows adapt, no static rows
    ("g64c8s8y4l32a16r4", (16384, 65536, 65536, 0, 0, 8)),
    # share 128 spans four warps: set sums go through shared memory
    ("g1c8s128y8l32a8r2u9", (16384, 32768, 32768, 8 * 32, 4 * 16 * 4, 8)),
])
def test_carve_at_named_geometries(spec, sizes):
    ln = TK.decode_launch(Geom.parse(spec))
    assert ln.threads == 128
    assert dict(zip(TK.REGIONS, ln.sizes)) == dict(zip(TK.REGIONS, sizes))
    assert ln.smem == sum(-(-n // 16) * 16 for n in sizes)


def test_ring_depth():
    """Two worst-case byte steps fit the ring (K1: two fetches of 128
    words a byte; K5: one of 128 a set), and so does what the top-ups
    keep in flight: a word read at fetch f was requested by a top-up at
    most (lag + 2) * every - 1 fetches earlier."""
    assert TK.RING_WORDS >= 2 * 2 * TK.FETCH_WORDS
    assert TK.RING_WORDS >= (TK.FETCH_WORDS * (TK.RING_LAG + 2)
                             * TK.RING_EVERY + 3)


def test_ring_worst_cases():
    TK.ring_check([128] * 400, 256 + 128 * 400)   # every lane, every fetch
    TK.ring_check([128] * 400, 256 + 128 * 100)   # stream cut short
    TK.ring_check([0] * 50 + [128] * 50 + [3] * 50, 256 + 7 * 128)
    TK.ring_check([128] * 40, 256)                # no data words at all


def test_ring_check_catches_a_shallow_ring(monkeypatch):
    """The mirror is not vacuous: a ring too shallow for the top-ups in
    flight fails, and so does a top-up that reaches past base + ring."""
    with pytest.raises(AssertionError, match="before it arrived"):
        TK.ring_check([128] * 100, 1 << 20, ring=2048)
    with pytest.raises(AssertionError, match="before it arrived"):
        TK.ring_check([128] * 100, 1 << 20, lag=3)
    with pytest.raises(AssertionError, match="before it arrived"):
        TK.ring_check([128] * 100, 1 << 20, every=64)
    monkeypatch.setattr(TK, "ring_top_up",
                        lambda base, limit, ring: min(base + ring + 4, limit))
    with pytest.raises(AssertionError, match="overwrites unread"):
        TK.ring_check([1] * 20, 1 << 20)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.integers(0, 128), max_size=160),
       st.integers(2, 400))
def test_ring_random_consumption(takes, rows):
    """Random fetch sizes on streams of random length (R * 128 words):
    every word read has arrived, no unread word is overwritten."""
    TK.ring_check(takes, rows * 128)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.sampled_from((0, 1, 64, 127, 128)), min_size=40,
                max_size=120))
def test_ring_bursts(takes):
    TK.ring_check(takes, 1 << 20)


def test_c_arguments_match_the_entry_points():
    """decode_cargs hands the C entries as many arguments as they take,
    ending in decode_launch's threads, bytes and region offsets."""
    from turborc_tpu_torch.ops import build
    g = Geom.parse("g2c8s8y8l32a4r4x2")
    gs = torch.zeros((2, 2, 40, 128), dtype=torch.int32)
    out = torch.empty((16, 2, 128), dtype=torch.uint8)
    fs = torch.empty((2, 2, 128), dtype=torch.int32)
    hi = torch.zeros((16, 2), dtype=torch.int32)
    lo = torch.zeros((16, 16, 2), dtype=torch.int32)
    args = TK.decode_cargs(gs, 16, hi, lo, g, out, fs)
    for fn in ("trc_decode", "trc_decode_x2"):
        assert len(args) + 1 == len(build.SIGNATURES["rans_kernel.cu"][fn])
    ln = TK.decode_launch(g)
    assert args[5:8] == [16, 2, 40]
    assert args[-2 - len(TK.REGIONS):] == [ln.threads, ln.smem,
                                            *ln.offsets]
