"""The launch of the o1 model K7 (``csrc/rans_o1_kernel.cu``) on the CPU,
without JAX.

No card is needed.  K7's launch is the source's own: CTAs of kModelLanes
lanes, four a group, each with a fixed carve of dynamic shared memory
(every lane's 112 table rows, then a ring of two stages of kModelSteps
input byte steps), which ``_carve`` mirrors from the source's numbers.
These tests hold the carve to the card's limits (two CTAs an SM), the C
arguments to every geometry the o1 format can carry, and a numpy mirror
of the kernel's pipelined byte step to ``model_plain``: the bytes come
through the staged ring, both rows of byte t + 1 are read before byte t's
rows are stored, and a row that repeats is forwarded from registers.  A
mirror without the forwarding, or with a stage requested into the buffer
still being read, is caught.  The kernel itself is held to
``model_plain`` only on the card.
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
MODEL_LANES = 32     # kModelLanes: lanes (threads) a CTA
MODEL_STEPS = 16     # kModelSteps: byte steps a stage of the input ring
SMEM_SM = 233_472    # kSmemSm: shared memory of an SM
SMEM_CTA = 1024      # kSmemCta: what the system keeps of it for each CTA
ROWS = R1.NCTX + R1.LROWS
MAX_THREADS = 1024


def _o1_geoms():
    """Every groups / rate the o1 format carries, x1 only."""
    for groups, rate in itertools.product((1, 2, 4, 8, 16, 64, 512, 32768),
                                          range(7, 11)):
        yield Geom(groups=groups, rate=rate)


def test_source_constants_match():
    """The kernel is compiled with the numbers the mirror uses."""
    for name, value in (("kNctx", R1.NCTX), ("kLrows", R1.LROWS),
                        ("kLanes", O1.GLANES), ("kModelLanes", MODEL_LANES),
                        ("kModelSteps", MODEL_STEPS),
                        ("kSmemMax", TK.SMEM_MAX), ("kSmemSm", SMEM_SM),
                        ("kSmemCta", SMEM_CTA)):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m and int(m.group(1)) == value, name


def _carve() -> TK.TableLaunch:
    """K7's carve as the source lays it out (kO1MRows, kO1MCols,
    kO1MSmem): 112 rows x 32 B x 32 lanes, then two stages of 16 byte
    steps x 32 lanes."""
    ln = TK.table_launch((ROWS * MODEL_LANES * 32,
                          2 * MODEL_STEPS * MODEL_LANES))
    return TK.TableLaunch(MODEL_LANES, ln.smem, ln.offsets, ln.sizes)


def test_carve_sizes():
    for line in ("constexpr int kO1MRows = 0;",
                 "constexpr int kO1MCols = kO1MRows + kRows * kModelLanes "
                 "* 32;",
                 "constexpr int kO1MSmem = kO1MCols + 2 * kModelSteps * "
                 "kModelLanes;",
                 "static_assert(2 * (kO1MSmem + kSmemCta) <= kSmemSm,",
                 "o1_model_kernel<<<G * (kLanes / kModelLanes), kModelLanes, "
                 "kO1MSmem,"):
        assert line in SOURCE, line
    ln = _carve()
    assert ln.offsets == (0, 114_688)
    assert ln.smem == 115_712


@pytest.mark.parametrize("geom", list(_o1_geoms()), ids=lambda g: g.spec)
def test_carve_fits_every_o1_geometry(geom):
    """Ordered 16-byte-aligned regions within the 232,448 B a CTA may
    have, two CTAs an SM (1 KB of each kept by the system), a group in
    whole CTAs, the grid within int32; the C arguments carry the
    geometry's groups and rate."""
    ln = _carve()
    assert ln.threads == MODEL_LANES <= MAX_THREADS
    assert O1.GLANES % MODEL_LANES == 0
    assert ln.smem <= TK.SMEM_MAX
    assert 2 * (ln.smem + SMEM_CTA) <= SMEM_SM
    ends = [o + s for o, s in zip(ln.offsets, ln.sizes)]
    assert all(o % 16 == 0 for o in ln.offsets)
    assert all(e <= o for e, o in zip(ends, ln.offsets[1:]))
    assert ends[-1] <= ln.smem and ln.smem % 16 == 0
    # one 16-byte copy a thread fills a stage
    assert MODEL_STEPS * MODEL_LANES // 16 == MODEL_LANES
    G, K = geom.groups, 48
    assert G * (O1.GLANES // MODEL_LANES) <= TK.INT32_MAX
    cols = torch.zeros((K, G, O1.GLANES), dtype=torch.uint8)
    args = O1.model_cargs(cols, None, None, None, geom)
    assert args[4:] == [K, G, geom.rate]


def test_c_arguments_match_the_entry_point():
    g = Geom(groups=2)
    args = O1.model_cargs(torch.zeros((16, 2, 128), dtype=torch.uint8),
                          None, None, None, g)
    assert len(args) + 1 == len(
        build.SIGNATURES["rans_o1_kernel.cu"]["trc_o1_model"])


# ---------------------------------------------------------------------------
# a numpy mirror of K7's byte step
# ---------------------------------------------------------------------------

def _ctx_of(prev):
    """The kernel's ctx_of, in numpy."""
    v = np.maximum(prev - 55, 1)
    bl = np.floor(np.log2(v)).astype(np.int64) + 1
    return np.where(prev < 56, prev, 56 + np.minimum(bl, 7))


def _locx_of(prev, hi):
    """The kernel's locx_of, in numpy."""
    return np.where(prev >> 4 == hi, 32 + (prev & 15),
                    np.where(hi == 0, np.minimum(prev, 15), 16 + hi))


def _lookup(row, sym):
    """lookup_pick: low = entry sym, freq = entry sym + 1 (2^15 past 15)
    less low."""
    ar = np.arange(row.shape[0])
    low = row[ar, sym]
    nx = np.where(sym == 15, 1 << 15, row[ar, np.minimum(sym + 1, 15)])
    return low, nx - low


def _update(row, low, rate):
    """cdf_update: row [L, 16] int64, arithmetic shift."""
    i = np.arange(16) * 10
    return row + ((i - row + np.where(row > low[:, None], 32736, 0))
                  >> rate)


def _mirror(cols: np.ndarray, hi_tbl: np.ndarray, lo_tbl: np.ndarray,
            rate: int, forward: bool = True, ahead: int = 1) -> np.ndarray:
    """K7's pipelined byte step in numpy on cols [K, G, 128] u8 and warm
    tables [64 | 48, 16, G] -> probs [2K, G, 128].

    Every lane's rows are one table [L, 112, 16] (hi 0..63, lo 64..111).
    The bytes come through a ring of two stages of MODEL_STEPS steps: the
    first two stages are requested at the start, and at byte u = t + 1 =
    0 mod MODEL_STEPS the stage that starts at u is waited for and the
    stage ``ahead`` stages later is requested into its buffer; a read of
    a slot that does not hold the byte raises AssertionError.  At byte t
    both rows of byte t + 1 are read before t's updated rows are stored;
    with ``forward`` a row that repeats takes t's updated registers."""
    K, G, _ = cols.shape
    L = G * O1.GLANES
    flat = cols.reshape(K, L).astype(np.int64)
    tables = np.empty((L, ROWS, 16), np.int64)
    lane_g = np.arange(L) // O1.GLANES
    tables[:, :R1.NCTX] = hi_tbl.transpose(2, 0, 1)[lane_g]
    tables[:, R1.NCTX:] = lo_tbl.transpose(2, 0, 1)[lane_g]
    D = MODEL_STEPS
    ring = {}  # slot (t % 2D) -> byte step it holds

    def request(t0):
        for t in range(t0, min(t0 + D, K)):
            ring[t % (2 * D)] = t

    def read(t):
        assert ring.get(t % (2 * D)) == t, f"byte step {t} not in the ring"
        return flat[t]

    request(0)
    request(D)
    ar = np.arange(L)
    b = read(0) if K else np.zeros(L, np.int64)
    hc = np.zeros(L, np.int64)
    lc = R1.NCTX + _locx_of(np.zeros(L, np.int64), b >> 4)
    hrow, lrow = tables[ar, hc].copy(), tables[ar, lc].copy()
    probs = np.empty((2 * K, L), np.int64)
    for t in range(K):
        u = t + 1
        if u % D == 0:
            request(u + ahead * D)
        bn = read(u) if u < K else np.zeros(L, np.int64)
        low_h, fr_h = _lookup(hrow, b >> 4)
        low_l, fr_l = _lookup(lrow, b & 15)
        hn = _ctx_of(b)
        ln = R1.NCTX + _locx_of(b, bn >> 4)
        hnext, lnext = tables[ar, hn].copy(), tables[ar, ln].copy()
        hrow, lrow = _update(hrow, low_h, rate), _update(lrow, low_l, rate)
        tables[ar, hc], tables[ar, lc] = hrow, lrow
        probs[2 * t] = (low_h << 16) | fr_h
        probs[2 * t + 1] = (low_l << 16) | fr_l
        if forward:
            hrow = np.where((hn == hc)[:, None], hrow, hnext)
            lrow = np.where((ln == lc)[:, None], lrow, lnext)
        else:
            hrow, lrow = hnext, lnext
        hc, lc, b = hn, ln, bn
    return probs.reshape(2 * K, G, O1.GLANES)


def _warm(rng, rows: int, G: int) -> np.ndarray:
    """Strictly increasing cumulative rows from 0, [rows, 16, G] int32."""
    f = rng.integers(1, 2000, (rows, 15, G))
    c = np.concatenate([np.zeros((rows, 1, G), np.int64),
                        np.cumsum(f, 1)], 1)
    return c.astype(np.int32)


def _cols(rng, K: int, G: int, kind: str) -> np.ndarray:
    L = G * O1.GLANES
    if kind == "random":
        x = rng.integers(0, 256, (K, L))
    elif kind == "runs":  # the same byte again and again: rows repeat
        x = np.repeat(rng.integers(0, 256, (K // 4 + 1, L)), 4, 0)[:K]
    else:  # few symbols: hi and lo contexts both repeat and switch
        x = rng.choice(np.array([0, 1, 17, 18, 60, 61, 250]), (K, L))
    return x.astype(np.uint8).reshape(K, G, O1.GLANES)


def _case(seed: int, K: int, G: int, kind: str, rate: int):
    rng = np.random.default_rng(seed)
    cols = _cols(rng, K, G, kind)
    return (cols, _warm(rng, R1.NCTX, G), _warm(rng, R1.LROWS, G),
            Geom(groups=G, rate=rate))


def _plain(cols, hi, lo, geom) -> np.ndarray:
    return O1.model_plain(torch.from_numpy(cols), torch.from_numpy(hi),
                          torch.from_numpy(lo), geom).numpy()


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 70),
       st.sampled_from(("random", "runs", "few")), st.integers(7, 10))
def test_mirror_equals_model_plain(seed, K, kind, rate):
    """The pipelined step (next rows read before the stores, forwarded
    where they repeat) gives model_plain's probs, on random, run-heavy and
    few-symbol bytes, at K below, at and past a stage of 16 steps."""
    cols, hi, lo, geom = _case(seed, K, 1, kind, rate)
    assert np.array_equal(_mirror(cols, hi, lo, rate),
                          _plain(cols, hi, lo, geom))


def test_mirror_equals_model_plain_two_groups():
    cols, hi, lo, geom = _case(7, 67, 2, "few", 8)
    assert np.array_equal(_mirror(cols, hi, lo, 8),
                          _plain(cols, hi, lo, geom))


@pytest.mark.parametrize("kind", ("runs", "few"))
def test_mirror_without_forwarding_is_caught(kind):
    """Without forwarding a repeated row is read before its update is
    stored: the probs differ from model_plain."""
    cols, hi, lo, geom = _case(3, 40, 1, kind, 7)
    assert not np.array_equal(_mirror(cols, hi, lo, 7, forward=False),
                              _plain(cols, hi, lo, geom))


def test_stage_into_the_buffer_being_read_is_caught():
    """A stage requested two stages ahead lands in the buffer whose bytes
    are still to be read."""
    cols, hi, lo, _ = _case(5, 64, 1, "random", 7)
    with pytest.raises(AssertionError, match="not in the ring"):
        _mirror(cols, hi, lo, 7, ahead=2)
