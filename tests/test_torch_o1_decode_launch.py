"""The launch of the o1 decoder K6 (``csrc/rans_o1_kernel.cu``) on the CPU,
without JAX.

No card is needed.  K6's launch is the source's own: 128 threads and a
fixed carve of dynamic shared memory (stream ring, every lane's 48 lo
rows, rank counts), which ``_carve`` mirrors from the source's numbers;
``hi_scratch`` is the device scratch of the 64 hi rows a lane, and
``rans_kernel.ring_check`` mirrors the ring, here with two fetches a byte.
These tests hold the carve to the card's limits, the C arguments to every
geometry the o1 format can carry, the ring to its two promises, and a
numpy model of the hi-row caching rule (a row is written back when the
context changes, and kept in registers when it does not) to a table
indexed directly.  The kernel itself is held to ``decode_plain`` only on
the card.
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

from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.ops import build
from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops import rans_o1_kernel as O1
from turborc_tpu_torch.ops.geom import Geom

CSRC = Path(O1.__file__).parent / "csrc"
SOURCE = "".join((CSRC / name).read_text()
                 for name in ("rans_o1_kernel.cu", "rans_common.cuh"))
MAX_THREADS = 1024


def _o1_geoms():
    """Every groups / rate the o1 format carries (the other fields of the
    header are o0 knobs), x1 only: the o1 pipeline has no x2."""
    for groups, rate in itertools.product((1, 2, 4, 8, 16, 64, 512, 32768),
                                          range(7, 11)):
        yield Geom(groups=groups, rate=rate)


def test_source_constants_match():
    """The kernel is compiled with the numbers the wrapper carves with."""
    for name, value in (("kNctx", R1.NCTX), ("kLrows", R1.LROWS),
                        ("kLanes", O1.GLANES),
                        ("kRingWords", TK.RING_WORDS),
                        ("kSmemMax", TK.SMEM_MAX)):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m and int(m.group(1)) == value, name


def _carve() -> TK.TableLaunch:
    """K6's launch as the source carves it (kO1Ring, kO1Lo, kO1Rank,
    kO1Smem): the ring of stream words, 48 lo rows x 32 B x 128 lanes, a
    rank byte a warp in two buffers, each region 16-byte aligned."""
    return TK.table_launch((TK.RING_WORDS * 4, R1.LROWS * O1.GLANES * 32,
                            2 * (O1.GLANES // 32)))


def test_carve_sizes():
    for line in ("constexpr int kO1Ring = 0;",
                 "constexpr int kO1Lo = kO1Ring + kRingWords * 4;",
                 "constexpr int kO1Rank = kO1Lo + kLrows * kLanes * 32;",
                 "constexpr int kO1Smem = (kO1Rank + 2 * kWarps + 15) / 16 "
                 "* 16;",
                 "o1_decode_kernel<<<G, kLanes, kO1Smem,"):
        assert line in SOURCE, line
    ln = _carve()
    assert ln.offsets == (0, 16384, 16384 + 196608)
    assert ln.smem == 16384 + 196608 + 16


@pytest.mark.parametrize("geom", list(_o1_geoms()), ids=lambda g: g.spec)
def test_carve_fits_every_o1_geometry(geom):
    """One thread a lane, ordered 16-byte-aligned regions within the
    232,448 B a CTA may have; the C arguments carry the geometry's groups
    and rate."""
    ln = _carve()
    assert ln.threads == O1.GLANES <= MAX_THREADS
    assert ln.smem <= TK.SMEM_MAX
    ends = [o + s for o, s in zip(ln.offsets, ln.sizes)]
    assert all(o % 16 == 0 for o in ln.offsets)
    assert all(e <= o for e, o in zip(ends, ln.offsets[1:]))
    assert ends[-1] <= ln.smem and ln.smem % 16 == 0
    G, K, R = geom.groups, 16, 40
    gs = torch.zeros((G, R, O1.GLANES), dtype=torch.int32)
    args = O1.decode_cargs(gs, K, None, None, geom, None, None, None)
    assert args[6:] == [K, G, R, geom.rate]


def test_c_arguments_match_the_entry_point():
    g = Geom(groups=2)
    args = O1.decode_cargs(torch.zeros((2, 40, 128), dtype=torch.int32), 16,
                           None, None, g, None, None, None)
    assert len(args) + 1 == len(
        build.SIGNATURES["rans_o1_kernel.cu"]["trc_o1_decode"])


@pytest.mark.parametrize("groups", (1, 64))
def test_hi_scratch_holds_the_hi_rows_only(groups):
    s = O1.hi_scratch(groups, "cpu")
    assert s.shape == (groups * 128, R1.NCTX, 16) and s.dtype == torch.int16
    if groups == 64:  # 8192 lanes: 16.8 MB, was 29.4 MB with the lo rows
        assert s.numel() * 2 == 16_777_216


def _ctx_of(prev):
    """The kernel's ctx_of, in numpy."""
    v = np.maximum(prev - 55, 1)
    bl = np.floor(np.log2(v)).astype(np.int64) + 1
    return np.where(prev < 56, prev, 56 + np.minimum(bl, 7))


def _locx_of(prev, hi):
    """The kernel's locx_of, in numpy."""
    return np.where(prev >> 4 == hi, 32 + (prev & 15),
                    np.where(hi == 0, np.minimum(prev, 15), 16 + hi))


def test_context_rows_stay_in_their_tables():
    """Row indices are data: ctx_of <= 63 and locx_of <= 47 for every byte
    and hi nibble, equal to the plain version's contexts."""
    prev = np.arange(256)
    ctx = _ctx_of(prev)
    assert ctx.min() == 0 and ctx.max() == R1.NCTX - 1
    assert np.array_equal(ctx, R1.hictx(torch.arange(256)).numpy())
    p, h = np.meshgrid(prev, np.arange(16))
    loc = _locx_of(p.ravel(), h.ravel())
    assert loc.min() >= 0 and loc.max() == R1.LROWS - 1
    assert np.array_equal(
        loc, R1.locx_of(torch.from_numpy(p.ravel()),
                        torch.from_numpy(h.ravel())).numpy())


@settings(max_examples=120, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 128), st.integers(0, 128)),
                max_size=100),
       st.integers(2, 400))
def test_ring_two_fetches_a_byte(takes, rows):
    """K6 fetches twice a byte (hi nibble, lo nibble), 0-128 words each,
    on streams of random length (R * 128 words): every word read has
    arrived, no unread word is overwritten."""
    TK.ring_check([n for pair in takes for n in pair], rows * 128)


def test_ring_two_fetches_worst_case():
    TK.ring_check([128, 128] * 200, 256 + 128 * 400)
    TK.ring_check([128, 128] * 200, 256 + 128 * 150)  # stream cut short


def _hi_rows_seen(bytes_, rows0, cached: bool, store: bool = True):
    """The hi row each byte of one lane reads, under the caching rule that
    K6 follows (``cached``: the current row in registers, written back to the
    scratch when the next byte's context differs, then the next one loaded)
    or a table indexed directly; an update adds the byte to every entry."""
    table = rows0.copy()
    seen = []
    ctx, reg, prev = 0, table[0].copy(), 0
    for b in bytes_:
        if cached:
            seen.append(reg.copy())
            reg = reg + b
            nctx = int(_ctx_of(np.array([b]))[0])
            if nctx != ctx:
                if store:
                    table[ctx] = reg
                reg = table[nctx].copy()
                ctx = nctx
        else:
            c = int(_ctx_of(np.array([prev]))[0])
            seen.append(table[c].copy())
            table[c] = table[c] + b
        prev = b
    return np.array(seen)


@pytest.mark.parametrize("seed", range(4))
def test_hi_row_register_cache(seed):
    """The caching rule reads the same rows as direct indexing on runs
    (the same context again), switches and returns to earlier rows; a rule
    that skips the write-back is caught.  This checks the rule, not the
    kernel: chip_smoke.py holds K6 to decode_plain on the card."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, 256, 40).repeat(rng.integers(1, 9, 40))
    data = np.concatenate([runs, rng.integers(0, 70, 300)])
    rows0 = rng.integers(0, 1000, (R1.NCTX, 16))
    want = _hi_rows_seen(data, rows0, cached=False)
    assert np.array_equal(_hi_rows_seen(data, rows0, cached=True), want)
    assert not np.array_equal(
        _hi_rows_seen(data, rows0, cached=True, store=False), want)
