"""The launch of the coder K3 (``csrc/rans_kernel.cu``) on the CPU, without
JAX.

No card is needed.  K3's C entry plans its launch from S and G: CTAs of
kCoderLanes lanes, each walking its lanes' probs backward in stages of
kCoderSlots slots staged in kCoderBufs shared-memory buffers, the top
stage partial when S is not a multiple.  ``_plan`` mirrors that plan from
the source's numbers (``rans_kernel.CODER_*``, checked against the
source).  These tests hold the plan to the card's limits and to int32,
and a numpy mirror of the staged walk (which stage is requested into
which buffer, and when it is read) to ``coder_plain``, the kernel's
oracle.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from turborc_tpu_torch.ops import build
from turborc_tpu_torch.ops import rans_kernel as TK

CSRC = Path(TK.__file__).parent / "csrc"
SOURCE = "".join((CSRC / name).read_text()
                 for name in ("rans_kernel.cu", "rans_common.cuh"))
MAX_THREADS = 1024
D = TK.CODER_SLOTS


@dataclasses.dataclass(frozen=True)
class _Plan:
    lanes: int
    ctas: int
    stages: int
    bufs: int
    smem: int


def _plan(S: int, G: int) -> _Plan:
    """The launch ``trc_coder`` derives from S and G: L / kCoderLanes
    CTAs, ceil(S / kCoderSlots) stages, kCoderSmem bytes (the stage
    buffers and the table of the m of every freq in [1, 2^15], u32)."""
    return _Plan(TK.CODER_LANES, G * TK.GLANES // TK.CODER_LANES, -(-S // D),
                 TK.CODER_BUFS,
                 TK.CODER_BUFS * D * TK.CODER_LANES * 4 + (1 << 15) * 4)


def test_source_constants_match():
    """The kernel is compiled with the numbers the wrapper plans with."""
    for name, value in (("kCoderLanes", TK.CODER_LANES),
                        ("kCoderSlots", TK.CODER_SLOTS),
                        ("kCoderBufs", TK.CODER_BUFS),
                        ("kSmemMax", TK.SMEM_MAX)):
        m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
        assert m and int(m.group(1)) == value, name
    # the launch that _plan mirrors
    for line in (
            "constexpr int kCoderStageBytes = kCoderBufs * kCoderSlots * "
            "kCoderLanes * 4;",
            "constexpr int kCoderSmem = kCoderStageBytes + kTotal * 4;",
            "const int ctas = int(L / kCoderLanes);",
            "const int stages = (S + kCoderSlots - 1) / kCoderSlots;"):
        assert line in SOURCE, line


@pytest.mark.parametrize("L", (128, 8192, 16384))
@pytest.mark.parametrize("S", (1, 2, D - 1, D, D + 1, 4096, 16384))
def test_launch_plan(S, L):
    G = L // TK.GLANES
    ln = _plan(S, G)
    assert ln.lanes == TK.CODER_LANES <= MAX_THREADS
    assert TK.GLANES % ln.lanes == 0 and ln.ctas * ln.lanes == L
    assert ln.ctas >= 2 * G  # a group is two CTAs or more: every SM at g64
    assert ln.bufs == TK.CODER_BUFS >= 2
    assert (ln.stages - 1) * D < S <= ln.stages * D
    top = S - (ln.stages - 1) * D  # slots of the top (first) stage
    assert 1 <= top <= D and (top == D) == (S % D == 0)
    # the stage buffers and the table of 2^15 reciprocals (u32)
    assert ln.smem <= TK.SMEM_MAX
    # every index the kernel keeps in an int, and its grid
    assert max(ln.ctas, ln.stages, L, S + D) <= TK.INT32_MAX


def test_c_arguments_match_the_entry_point():
    S, G = 100, 2
    probs = torch.zeros((S, G, 128), dtype=torch.int32)
    init = torch.zeros((G, 128), dtype=torch.int32)
    args = TK.coder_cargs(probs, init, None, None, None)
    assert len(args) + 1 == len(build.SIGNATURES["rans_kernel.cu"]
                                ["trc_coder"])
    assert args[5:] == [S, G]


def _magic_div(x, freq, off: int = 0):
    """x // freq by K3's reciprocal (``div_magic``; ``off`` is added to m,
    for the negative control): umulhi(2x, m) >> l in uint64."""
    m, l = TK.div_magic(np.asarray(freq, np.int64))
    prod = (2 * np.asarray(x, np.uint64)) * (m + off).astype(np.uint64)
    return ((prod >> np.uint64(32)) >> l.astype(np.uint64)).astype(np.int64)


def _mirror(probs: np.ndarray, init: np.ndarray, ahead: int | None = None):
    """K3's staged walk in numpy, with its reciprocal in place of the
    division: probs [S, L] (low << 16 | freq), init [L] -> (words, emit,
    flush states).  Every CTA's stages go through
    ``bufs`` buffers: the top bufs - 1 stages are requested first, stage
    j - ahead while stage j is coded (``ahead`` = bufs - 1 in the kernel).
    Raises AssertionError where a stage is read from a buffer that does
    not hold it, or a request overwrites a stage not yet coded."""
    S, L = probs.shape
    ln = _plan(S, L // TK.GLANES)
    bufs = ln.bufs
    ahead = bufs - 1 if ahead is None else ahead
    words = np.zeros((S, L), np.int64)
    emit = np.zeros((S, L), np.uint8)
    state = init.astype(np.int64) & 0xFFFFFFFF
    for c in range(ln.ctas):
        lanes = slice(c * ln.lanes, (c + 1) * ln.lanes)
        held = [None] * bufs  # stage held by each buffer
        done = set()

        def request(j):
            if j < 0:
                return
            old = held[j % bufs]
            assert old is None or old[0] in done, \
                f"stage {j} overwrites stage {old[0]} before it was coded"
            t0 = j * D
            held[j % bufs] = (j, probs[t0:min(t0 + D, S), lanes].copy())

        for k in range(ahead):
            request(ln.stages - 1 - k)
        st = state[lanes]
        for j in range(ln.stages - 1, -1, -1):
            got = held[j % bufs]
            assert got is not None and got[0] == j, f"stage {j} not staged"
            request(j - ahead)
            stage = got[1]
            for s in range(stage.shape[0] - 1, -1, -1):
                pr = stage[s].astype(np.int64)
                low, freq = pr >> 16, pr & 0xFFFF
                t = j * D + s
                e = st >= (freq << 16)
                words[t, lanes] = st & 0xFFFF
                emit[t, lanes] = e
                x = np.where(e, st >> 16, st)
                q = _magic_div(x, freq)
                st = x + low + q * ((1 << 15) - freq)
            done.add(j)
        state[lanes] = st
    return words, emit, state


def _random_tile(rng, S: int, G: int):
    """probs with a quarter of the frequencies at the extremes 1 and 2^15
    (each with a low that keeps low + freq <= 2^15), the rest drawn; init
    states in [2^15, 2^31), some at either end."""
    L = G * TK.GLANES
    freq = rng.integers(1, (1 << 15) + 1, (S, L))
    edge = rng.random((S, L))
    freq = np.where(edge < 0.125, 1, np.where(edge < 0.25, 1 << 15, freq))
    low = (rng.random((S, L)) * ((1 << 15) - freq + 1)).astype(np.int64)
    low = np.minimum(low, (1 << 15) - freq)
    probs = ((low << 16) | freq).astype(np.int32)
    init = rng.integers(1 << 15, 1 << 31, L)
    init[:4] = [1 << 15, (1 << 31) - 1, 1 << 15, (1 << 31) - 1]
    return probs, init.astype(np.int32)


def _plain(probs: np.ndarray, init: np.ndarray):
    S, L = probs.shape
    G = L // TK.GLANES
    w, e, s = TK.coder_plain(torch.from_numpy(probs).reshape(S, G, 128),
                             torch.from_numpy(init).reshape(G, 128))
    return (w.reshape(S, L).numpy(), e.reshape(S, L).numpy(),
            s.reshape(L).numpy())


@pytest.mark.parametrize("S, G", [(1, 1), (2, 1), (D - 1, 1), (D, 2),
                                  (D + 1, 1), (3 * D + 17, 2), (4 * D, 1)])
def test_mirror_equals_coder_plain(S, G):
    rng = np.random.default_rng(S * 7 + G)
    probs, init = _random_tile(rng, S, G)
    words, emit, state = _mirror(probs, init)
    want = _plain(probs, init)
    assert np.array_equal(words, want[0])
    assert np.array_equal(emit, want[1])
    assert np.array_equal(state.astype(np.uint32).astype(np.int32), want[2])


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 6 * D), st.integers(0, 2**32 - 1))
def test_mirror_random_lengths(S, seed):
    probs, init = _random_tile(np.random.default_rng(seed), S, 1)
    got = _mirror(probs, init)
    want = _plain(probs, init)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])


def test_mirror_catches_a_request_too_far_ahead():
    """The mirror is not vacuous: requesting as many stages ahead as there
    are buffers overwrites the stage being coded."""
    probs, init = _random_tile(np.random.default_rng(1), 5 * D, 1)
    with pytest.raises(AssertionError, match="before it was coded"):
        _mirror(probs, init, ahead=TK.CODER_BUFS)
    with pytest.raises(AssertionError, match="not staged"):
        _mirror(probs, init, ahead=0)


# ---------------------------------------------------------------------------
# K3's reciprocal (div_magic): exact for every freq in [1, 2^15] and every
# state below 2^31 (the state after the emit shift)
# ---------------------------------------------------------------------------

FREQS = np.arange(1, (1 << 15) + 1, dtype=np.int64)


def test_div_magic_bound_holds_for_every_freq():
    """Granlund-Montgomery (1994), theorem 4.2 with N = 31: 2^(31+l) <=
    m freq <= 2^(31+l) + 2^l makes umulhi(2x, m) >> l = x // freq for every
    0 <= x < 2^31; m fits 32 bits; l = ceil(log2 freq)."""
    m, l = TK.div_magic(FREQS)
    assert m.max() < 1 << 32 and m.min() >= 1 << 31
    assert np.array_equal(1 << l, [1 << (int(f) - 1).bit_length()
                                   for f in FREQS])
    lo = np.left_shift(np.int64(1), 31 + l)
    assert ((lo <= m * FREQS) & (m * FREQS <= lo + (1 << l))).all()


def _states(rng, freq):
    """The extremes (0, 1, 2^15, freq << 16 - 1 where below 2^31, 2^31 - 1,
    multiples of freq and their neighbours) and random states below 2^31."""
    top = np.minimum((freq << 16) - 1, (1 << 31) - 1)
    k = (np.int64(1 << 31) - 1) // freq
    fixed = np.stack([0 * freq, 0 * freq + 1, 0 * freq + (1 << 15), top,
                      0 * freq + (1 << 31) - 1, freq, freq - 1, freq + 1,
                      k * freq, k * freq - 1], axis=1)
    return np.concatenate([fixed, rng.integers(0, 1 << 31, (freq.size, 24))],
                          axis=1)


def test_div_magic_equals_floor_division():
    x = _states(np.random.default_rng(9), FREQS)
    f = FREQS[:, None]
    assert np.array_equal(_magic_div(x, np.broadcast_to(f, x.shape)), x // f)


def test_div_magic_off_by_one_is_caught():
    """A reciprocal one too small fails at x = freq (a quotient of 1
    computed as 0) for every freq that is not a power of two, and one too
    large fails at the top of the range for some."""
    x = _states(np.random.default_rng(10), FREQS)
    f = np.broadcast_to(FREQS[:, None], x.shape)
    low_bad = (_magic_div(x, f, off=-1) != x // f).any(axis=1)
    assert low_bad[(FREQS & (FREQS - 1)) != 0].all()
    assert (_magic_div(x, f, off=1) != x // f).any()
