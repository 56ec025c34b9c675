"""The lane kernels L1-L4 (``ops/csrc/rans_lane_kernel.cu``) on the CPU,
without the card: their constants and C entries against the source and
``build.SIGNATURES``, numpy mirrors of each design choice that the plain
versions do not make, held against the plain versions (each with a
negative control that must fail), the plain versions' round trips at
the geometries the kernels branch on, and the wrappers' refusals.  No
JAX.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.models import span as SM
from turborc_tpu_torch.ops import build, rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops.geom import Geom

CSRC = Path(build.__file__).resolve().parent / "csrc"
SRC = (CSRC / "rans_lane_kernel.cu").read_text()


def _const(text: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1)


def test_constants_match_source():
    """The numbers the wrapper and the tests plan with are the source's:
    L2's CTA, stage ring, chain block and move batch, L4's team."""
    for name, value in (("kCoderN", LK.CODER_LANES),
                        ("kCoderD", LK.CODER_SLOTS),
                        ("kCoderRing", LK.CODER_RING),
                        ("kCoderU", LK.CODER_BLOCK),
                        ("kCoderMoveU", LK.CODER_MOVE),
                        ("kCoderWords", LK.CODER_WORDS),
                        ("kStaticTeam", LK.STATIC_TEAM),
                        ("kStaticThreads", LK.STATIC_THREADS)):
        assert int(_const(SRC, name)) == value, name
    assert "kPre" not in SRC  # the register queue is gone


def _c_params(name: str) -> list[str]:
    m = re.search(rf"int {name}\(([^)]*)\)", SRC)
    assert m, name
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(build.SIGNATURES[
    "rans_lane_kernel.cu"]))
def test_c_signatures_match_build(name):
    """Every parameter of the C entry is a pointer (c_void_p), an int
    (c_int) or, last, the stream (c_void_p), as build.SIGNATURES says."""
    want = build.SIGNATURES["rans_lane_kernel.cu"][name]
    params = _c_params(name)
    assert params[-1].startswith("cudaStream_t")
    kinds = ["P" if "*" in p else "I" for p in params[:-1]] + ["P"]
    assert all(k == "P" or p.startswith("int ") for k, p in
               zip(kinds, params))
    got = ["P" if t is build._P else "I" for t in want]
    assert kinds == got


def test_cargs_fit_the_signatures():
    """Each ``*_cargs`` helper gives a tensor where the C entry takes a
    pointer and an int where it takes an int."""
    K, L = 32, 16
    geom = Geom(share=8)
    cols = torch.zeros((K, L), dtype=torch.uint8)
    hi = torch.zeros((2, 16), dtype=torch.int32)
    lo = torch.zeros((2, 16, 16), dtype=torch.int32)
    probs = torch.zeros((2 * K, L), dtype=torch.int32)
    streams = torch.zeros((L, 2 * K + 2), dtype=torch.int32)
    out = torch.zeros((K, L), dtype=torch.uint8)
    lens = torch.zeros((L,), dtype=torch.int32)
    words = torch.zeros((100,), dtype=torch.int16)
    offs = torch.zeros((L,), dtype=torch.int64)
    cdf = torch.zeros((257,), dtype=torch.int32)
    cases = {
        "trc_lane_model": LK.lane_model_cargs(cols, hi, lo, probs, geom),
        "trc_lane_coder": LK.lane_coder_cargs(probs, lens, streams, lens),
        "trc_lane_decode": LK.lane_decode_cargs(words, offs, lens, K, hi,
                                                lo, out, geom),
        "trc_lane_static_decode": LK.lane_static_decode_cargs(
            words, offs, lens, K, cdf, out),
    }
    for name, args in cases.items():
        want = build.SIGNATURES["rans_lane_kernel.cu"][name][:-1]
        assert len(args) == len(want), name
        for a, t in zip(args, want):
            assert isinstance(a, torch.Tensor) == (t is build._P), name


# ---------------------------------------------------------------------------
# L2: the backward pass writes word k at M - 1 - k, then moves the words
# ---------------------------------------------------------------------------

def _random_probs(S: int, L: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    edge = np.array([1, 2, 3, 32767, 32768])
    freq = np.where(rng.random((S, L)) < 0.3,
                    edge[rng.integers(0, 5, (S, L))],
                    rng.integers(1, 1 << 15, (S, L)))
    low = (rng.random((S, L)) * ((1 << 15) - freq + 1)).astype(np.int64)
    low = np.minimum(low, (1 << 15) - freq)
    init = rng.integers(1 << 15, 1 << 31, L)
    init[::3] = 1 << 15
    return ((low << 16) | freq).astype(np.int32), init.astype(np.int32)


def coder_mirror(probs: np.ndarray, init: np.ndarray, move="forward",
                 zero=True):
    """lane_coder_kernel, one lane at a time, as the source does it."""
    S, L = probs.shape
    M = S + 2
    streams = np.zeros((L, M), np.int64)  # the wrapper's zeroed rows
    lengths = np.zeros(L, np.int64)
    for lane in range(L):
        row = streams[lane]
        state, k = int(init[lane]) & 0xFFFFFFFF, 0
        for s in range(S - 1, -1, -1):
            p = int(probs[s, lane]) & 0xFFFFFFFF
            low, freq = p >> 16, p & 0xFFFF
            if state >= freq << 16:
                row[M - 1 - k] = state & 0xFFFF
                k += 1
                state >>= 16
            q = state // freq
            state = ((q << 15) + state - q * freq + low) & 0xFFFFFFFF
        order = range(k) if move == "forward" else range(k - 1, -1, -1)
        for i in order:
            row[2 + i] = row[M - k + i]
        if zero:
            row[max(2 + k, M - k):] = 0
        row[0], row[1] = state >> 16, state & 0xFFFF
        lengths[lane] = k + 2
    return streams, lengths


@pytest.mark.parametrize("S,L", [(0, 4), (1, 4), (37, 16), (200, 8)])
def test_coder_compaction_mirror(S, L):
    probs, init = _random_probs(S, L, S + L)
    want_s, want_l = LK.lane_coder_plain(torch.from_numpy(probs),
                                         torch.from_numpy(init))
    got_s, got_l = coder_mirror(probs, init)
    assert np.array_equal(got_s, want_s.numpy())
    assert np.array_equal(got_l, want_l.numpy())


def test_coder_compaction_negative_controls():
    """Moving the words last-first overwrites words it has not moved once
    a lane emits more than half its slots; not clearing the moved words
    left past the length leaves them there.  Both differ."""
    probs, init = _random_probs(64, 8, 7)
    probs = (probs & ~0xFFFF) | 3   # freq 3: a word nearly every slot
    want = LK.lane_coder_plain(torch.from_numpy(probs),
                               torch.from_numpy(init))[0].numpy()
    assert np.array_equal(coder_mirror(probs, init)[0], want)
    assert not np.array_equal(coder_mirror(probs, init, move="backward")[0],
                              want)
    probs, init = _random_probs(64, 8, 8)
    want = LK.lane_coder_plain(torch.from_numpy(probs),
                               torch.from_numpy(init))[0].numpy()
    assert not np.array_equal(coder_mirror(probs, init, zero=False)[0], want)


# ---------------------------------------------------------------------------
# L3 / L4: the lane's words read from the payload at its offset, the next
# one loaded as soon as one is taken; reads at or past the lane's length
# give 0
# ---------------------------------------------------------------------------

class WordsMirror:
    """A lane's reader of the payload's words, a word at a time (the rule
    L3's and L4's team readers keep, spread over a team): lane l reads
    words[off + p] while p < n = min(len, M, W - off), else 0; the word
    at pos is held before it is needed.  ``bounded=False`` drops the
    lane's length (reads run into the next lane's words); ``stale`` never
    reloads."""

    def __init__(self, words, off, ln, M, bounded=True, stale=False):
        W = words.shape[0]
        n = min(ln, M, W - off) if bounded else W - off
        self.src, self.n, self.pos, self.stale = words[off:], max(n, 0), 2, \
            stale
        hi = int(self.src[0]) if self.n > 0 else 0
        lo = int(self.src[1]) if self.n > 1 else 0
        self.state = (hi << 16) | lo
        self.next = int(self.src[2]) if 2 < self.n else 0

    def renorm(self):
        if self.state < 1 << 15:
            self.state = ((self.state << 16) | self.next) & 0xFFFFFFFF
            self.pos += 1
            if not self.stale:
                self.next = int(self.src[self.pos]) if self.pos < self.n \
                    else 0


def static_decode_mirror(words: np.ndarray, lengths: np.ndarray, K: int,
                         cdf: np.ndarray, **kw) -> np.ndarray:
    sym_of = table_search(cdf, np.arange(1 << 15))
    L = lengths.shape[0]
    words = words.astype(np.int64) & 0xFFFF
    off = np.cumsum(lengths) - lengths
    out = np.zeros((K, L), np.uint8)
    for lane in range(L):
        w = WordsMirror(words, int(off[lane]), int(lengths[lane]),
                        2 * K + 2, **kw)
        for t in range(K):
            value = w.state & 0x7FFF
            sym = int(sym_of[value])
            low, freq = int(cdf[sym]), int(cdf[sym + 1] - cdf[sym])
            w.state = (freq * (w.state >> 15) + value - low) & 0xFFFFFFFF
            w.renorm()
            out[t, lane] = sym
    return out


def table_search(cdf: np.ndarray, v, steps: int = 8):
    """The last i with cdf[i] <= v for the values ``v``, by ``steps``
    halvings of [0, 256): the search that starts each thread's walk of
    lane_static_decode_kernel's table build."""
    v = np.asarray(v)
    lo, hi = np.zeros_like(v), np.full_like(v, 256)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        le = cdf[mid] <= v
        lo, hi = np.where(le, mid, lo), np.where(le, hi, mid)
    return lo


def _static_cdf(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 400, 256) * (rng.random(256) < 0.5)
    f[rng.integers(0, 256)] += 1
    f = f * (1 << 15) // f.sum()
    f[np.argmax(f)] += (1 << 15) - f.sum()
    cdf = np.zeros(257, np.int64)
    np.cumsum(f, out=cdf[1:])
    return cdf


def test_static_table_search_mirror():
    """The table equals searchsorted(cdf, v, "right") - 1 for every v, on
    CDFs with zero-frequency symbols and on one symbol holding all; with
    7 halvings it does not."""
    v = np.arange(1 << 15)
    for cdf in (_static_cdf(1), _static_cdf(2),
                np.concatenate([np.zeros(200, np.int64),
                                np.full(57, 1 << 15)])):
        want = np.searchsorted(cdf, v, side="right") - 1
        got = table_search(cdf, v)
        assert np.array_equal(got, want)
    cdf = _static_cdf(3)
    short = table_search(cdf, v, steps=7)
    assert not np.array_equal(short, np.searchsorted(cdf, v, "right") - 1)


def _static_streams(K: int, L: int, seed: int):
    """(words, lengths) of K static-CDF bytes a lane, the CDF and the
    bytes."""
    cdf = _static_cdf(seed)
    rng = np.random.default_rng(seed)
    f = np.diff(cdf)
    sym = rng.choice(256, size=(K, L), p=f / f.sum())
    c = torch.from_numpy(cdf)
    probs = ((c[sym] << 16) | (c[sym + 1] - c[sym])).to(torch.int32)
    streams, lengths = LK.lane_coder_plain(probs, torch.full(
        (L,), 1 << 15, dtype=torch.int32))
    return blockio.device_words(streams, lengths), lengths, cdf, sym


def test_words_from_payload_mirror():
    """A static-CDF decode from the payload's words, each lane bounded by
    its length, the word loaded a step ahead, equals the plain version: on
    sound streams (which it decodes) and on corrupt ones (flipped words
    and states; a length table cut short, lengthened past 2K + 2 and past
    the words), where lanes read past their stored words.  Dropping the
    length bound (reading the next lane's words) or the reload of the
    word ahead differs."""
    K, L = 48, 8
    words, lengths, cdf, sym = _static_streams(K, L, 4)
    c32 = torch.from_numpy(cdf.astype(np.int32))

    def both(w, ln, **kw):
        want = LK.lane_static_decode_plain(w, ln, K, c32).numpy()
        return static_decode_mirror(w.numpy(), ln.numpy(), K, cdf,
                                    **kw), want

    got, want = both(words, lengths)
    assert np.array_equal(want, sym) and np.array_equal(got, want)
    rng = np.random.default_rng(5)
    bad = words.numpy().copy()
    at = rng.integers(0, bad.size, 40)
    bad[at] ^= rng.integers(1, 1 << 15, 40).astype(np.int16)
    bad = torch.from_numpy(bad)
    cut = lengths.clone()
    cut[1] = 2
    cut[5] = 3
    long = lengths.clone()
    long[0] = 2 * K + 40     # past 2K + 2 (the matrix's row)
    long[-1] = 5000          # past the words
    for w, ln in ((bad, lengths), (words, cut), (words, long)):
        got, want = both(w, ln)
        assert np.array_equal(got, want)
    got, want = both(bad, cut, bounded=False)
    assert not np.array_equal(got, want)
    got, want = both(bad, lengths, stale=True)
    assert not np.array_equal(got, want)


def test_words_equal_the_zero_padded_matrix():
    """For the lengths the payload check accepts, the decoders' reader
    gives the words of blockio.unpack's zero-padded matrix."""
    K, L = 30, 16
    words, lengths, _, _ = _static_streams(K, L, 6)
    M = 2 * K + 2
    payload = (lengths.numpy().astype("<u2").tobytes()
               + words.numpy().view("<u2").tobytes())
    mat = torch.from_numpy(blockio.unpack(payload, L, M)).to(torch.int64)
    assert torch.equal(blockio.unpack_device(payload, L, M, "cpu"),
                       mat.to(torch.int32))
    state, fetch = LK.stream_reader(words, lengths, M)
    assert torch.equal(state, (mat[:, 0] << 16) | mat[:, 1])
    for p in range(2, M + 2):  # every lane takes a word at each fetch
        state = fetch(torch.zeros_like(state))
        assert torch.equal(state, mat[:, p] if p < M else state * 0)


# ---------------------------------------------------------------------------
# The one-thread-a-lane re-join of `share` lanes (rans_common.cuh, which K1,
# K2 and K5 run): warp butterflies and, past a warp, per-warp sums in
# shared memory.  L1 and L3's team port: tests/test_torch_lane_team.py.
# ---------------------------------------------------------------------------

def set_sum_mirror(x: np.ndarray, share: int, cross_warp: bool = True):
    """rans_common.cuh's set_sum_n over a CTA's 128 threads: x [128, 16]
    -> every thread's sum over its aligned set of ``share`` threads."""
    x = x.copy()
    lim = min(share, 32)
    k = 1
    while k < lim:
        x = x + x[np.arange(128) ^ k]       # __shfl_xor_sync
        k <<= 1
    if share > 32 and cross_warp:
        red = x[::32]                       # lane 0 of each warp
        per = share >> 5
        first = (np.arange(128) >> 5) & ~(per - 1)
        x = np.stack([red[f:f + per].sum(0) for f in first])
    return x


def rejoin_mirror(cdf: np.ndarray, start: np.ndarray, share: int,
                  cross_warp: bool = True) -> np.ndarray:
    """rejoin_batch on one table a lane: sum(table) - (share - 1) * start,
    repaired and clamped."""
    d = set_sum_mirror(cdf, share, cross_warp) + (1 - share) * start
    d = torch.from_numpy(d)
    return cdf16.clamp_top(cdf16._repair(d)).numpy()


def _diverged_copies(share: int, seed: int):
    """128 lanes' tables, equal within each set at the start (a warm
    table of the set's own), each then updated by 6 symbols of its own."""
    rng = np.random.default_rng(seed)
    start = _warm(128 // share, seed)[0].to(torch.int64).repeat_interleave(
        share, 0)
    cdf = start.clone()
    for _ in range(6):
        sym = torch.from_numpy(rng.integers(0, 16, 128))
        low, _ = cdf16.lookup(cdf, sym)
        cdf = cdf16.update_rate(cdf, low, 7)
    return cdf, start


@pytest.mark.parametrize("share", [2, 8, 32, 64, 128])
def test_rejoin_mirror_equals_plain(share):
    cdf, start = _diverged_copies(share, share)
    want = SM._sync(cdf, start, share).numpy()
    assert np.array_equal(rejoin_mirror(cdf.numpy(), start.numpy(), share),
                          want)


@pytest.mark.parametrize("share", [64, 128])
def test_rejoin_mirror_negative_control(share):
    """Without the per-warp sums a set wider than a warp re-joins only
    its warp's copies: the tables differ."""
    cdf, start = _diverged_copies(share, share + 1)
    want = SM._sync(cdf, start, share).numpy()
    assert not np.array_equal(rejoin_mirror(cdf.numpy(), start.numpy(),
                                            share, cross_warp=False), want)


def test_prefetch_queue_order():
    """L2's loads ahead of its chain: while block b of CODER_BLOCK slots is
    coded, block b + 2's probs are loaded and block b + 1's reciprocals
    looked up (from probs loaded a block before), and the registers only
    rotate: every slot i < S is coded once, in order, from probs loaded
    two blocks and reciprocals one block before its block, and every slot
    a block reads lies in the stages published at its stage's barrier
    (stages j and j + 1)."""
    U, D = LK.CODER_BLOCK, LK.CODER_SLOTS
    for S in (0, 1, U - 1, U, U + 1, D - 1, D, D + 1, 3 * D + 5, 640):
        blocks = -(-S // U)
        loaded, recip, coded = {}, {}, []
        p = [None, None, None]  # probs of blocks b, b + 1, b + 2
        m = [None, None]        # reciprocals of blocks b, b + 1
        for j in range(-(-S // D)):
            published = range(j * D, (j + 2) * D)
            b0 = j * (D // U)
            if j == 0:
                p[0], p[1] = 0, 1
                loaded[0] = loaded[1] = -1
                m[0] = p[0]
                recip[0] = -1
            for b in range(b0, min(b0 + D // U, blocks)):
                p[2] = b + 2
                loaded[b + 2] = b
                assert all(i in published
                           for i in range((b + 2) * U, (b + 3) * U))
                assert loaded[p[1]] < b  # block b + 1's probs landed
                m[1] = p[1]
                recip[b + 1] = b
                assert m[0] == p[0] == b and recip[b] < b
                assert loaded[b] <= b - 2 or b < 2
                coded += [i for i in range(b * U, (b + 1) * U) if i < S]
                p = [p[1], p[2], None]
                m = [m[1], None]
        assert coded == list(range(S))


# ---------------------------------------------------------------------------
# plain versions: round trips where the kernels branch
# ---------------------------------------------------------------------------

def _warm(n_seg: int, seed: int):
    rng = np.random.default_rng(seed)
    f = rng.integers(1, 3000, (n_seg, 17, 16))
    f = f * (1 << 15) // f.sum(-1, keepdims=True)
    f = np.maximum(f, 1)
    f[..., 0] += (1 << 15) - f.sum(-1)
    cdf = np.zeros_like(f)
    cdf[..., 1:] = np.cumsum(f, -1)[..., :-1]
    cdf = torch.from_numpy(cdf.astype(np.int32))
    return cdf[:, 0].contiguous(), cdf[:, 1:].contiguous()


@pytest.mark.parametrize("L,K,n_seg,geom", [
    (4, 0, 1, LK.PER_LANE),
    (4, 5, 1, LK.PER_LANE),
    (16, 32, 2, Geom(share=8)),
    (64, 32, 1, Geom(share=64, sync=8, lsync=32, arows=8, srows=2)),
    (128, 32, 1, Geom(share=128, arows=0, srows=0, rate=10)),
    (32, 64, 4, Geom(share=4, sync=2, lsync=16, arows=16, srows=20,
                     rate=8)),
])
def test_plain_round_trip(L, K, n_seg, geom):
    """lane_model -> lane_coder -> lane_decode gives the bytes back."""
    rng = np.random.default_rng(L + K)
    cols = torch.from_numpy(rng.integers(0, 256, (K, L)).astype(np.uint8)
                            * (rng.random((K, L)) < 0.6))
    hi, lo = _warm(n_seg, K)
    probs = LK.lane_model(cols, hi, lo, geom)
    assert probs.shape == (2 * K, L) and probs.dtype == torch.int32
    assert ((probs & 0xFFFF) >= 1).all()
    streams, lengths = LK.lane_coder(probs, torch.full(
        (L,), rans.ANS_LOW, dtype=torch.int32))
    words = blockio.device_words(streams, lengths)
    assert torch.equal(LK.lane_decode(words, lengths, K, hi, lo, geom), cols)


def test_static_round_trip():
    K, L = 40, 4
    words, lengths, cdf, sym = _static_streams(K, L, 9)
    out = LK.lane_static_decode(words, lengths, K,
                                torch.from_numpy(cdf.astype(np.int32)))
    assert np.array_equal(out.numpy(), sym)


# ---------------------------------------------------------------------------
# wrappers' refusals
# ---------------------------------------------------------------------------

def _tables(n_seg=1):
    return _warm(n_seg, 0)


@pytest.mark.parametrize("what,call", [
    ("cols dtype", lambda: LK.lane_model(
        torch.zeros((32, 8), dtype=torch.int32), *_tables())),
    ("cols rank", lambda: LK.lane_model(
        torch.zeros((32, 8, 1), dtype=torch.uint8), *_tables())),
    ("lanes not 2^n", lambda: LK.lane_model(
        torch.zeros((32, 12), dtype=torch.uint8), *_tables())),
    ("more segments than spans", lambda: LK.lane_model(
        torch.zeros((32, 16), dtype=torch.uint8), *_tables(3),
        Geom(share=8))),
    ("lanes not a multiple of share", lambda: LK.lane_model(
        torch.zeros((32, 4), dtype=torch.uint8), *_tables(),
        Geom(share=8))),
    ("K not a multiple of lsync", lambda: LK.lane_model(
        torch.zeros((40, 16), dtype=torch.uint8), *_tables(),
        Geom(share=8))),
    ("lo table shape", lambda: LK.lane_model(
        torch.zeros((32, 8), dtype=torch.uint8), _tables()[0],
        torch.zeros((1, 16, 15), dtype=torch.int32))),
    ("probs dtype", lambda: LK.lane_coder(
        torch.ones((8, 4), dtype=torch.int64),
        torch.full((4,), 1 << 15, dtype=torch.int32))),
    ("init shape", lambda: LK.lane_coder(
        torch.ones((8, 4), dtype=torch.int32),
        torch.full((8,), 1 << 15, dtype=torch.int32))),
    ("words dtype", lambda: LK.lane_decode(
        torch.zeros((40,), dtype=torch.int32),
        torch.full((4,), 10, dtype=torch.int32), 4, *_tables())),
    ("lengths dtype", lambda: LK.lane_decode(
        torch.zeros((40,), dtype=torch.int16),
        torch.full((4,), 10, dtype=torch.int64), 4, *_tables())),
    ("words rank", lambda: LK.lane_static_decode(
        torch.zeros((4, 10), dtype=torch.int16),
        torch.full((4,), 10, dtype=torch.int32), 4,
        torch.zeros((257,), dtype=torch.int32))),
    ("static cdf shape", lambda: LK.lane_static_decode(
        torch.zeros((40,), dtype=torch.int16),
        torch.full((4,), 10, dtype=torch.int32), 4,
        torch.zeros((256,), dtype=torch.int32))),
    ("geom share 3", lambda: Geom(share=3)),
    ("geom rate 6", lambda: Geom(rate=6)),
    ("geom arows 17", lambda: Geom(arows=17)),
    ("geom lsync below sync", lambda: Geom(sync=8, lsync=4)),
])
def test_wrappers_refuse(what, call):
    with pytest.raises(ValueError):
        call()
