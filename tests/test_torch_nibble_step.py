"""The steps of the nibble kernels L9 and L10 (``ops/csrc/rans_lane_kernel.cu``)
as numpy mirrors, thread by thread on the kernels' layouts, held exactly
against ``lane_nibble_model_plain``, ``lane_nibble_decode_plain`` and
``lane_nibble_static_decode_plain``.  No JAX.

- L9 (``model_mirror``): 4 lanes a CTA, thread j of a lane's team of 16
  holding entry j of its CDF16; lane i of a warp holds the CTA's 4 bytes
  of step c + i of a chunk of 32 (zero past K or past L), a step's by a
  shuffle; before each nibble every thread stores its entry to the lane's
  rows (a row a nibble of a half's 16 steps, entry 16 = 2^15), then
  updates by the predicate j > s; after the half, thread j reads the
  slots of step t0 + j from the rows and stores them where the step and
  the lane are real;
- L10 (``decode_mirror``): a warp a lane (its two halves alike, so one
  half stands for it); adaptive: thread j holds (c_j, c_{j-1}), thread 0
  (2^15, c_15), a search is the min of (hi << 16 | lo) over hi > value and
  the symbol a count beside it, both update candidates computed before the
  symbol picks one by i > s; static: the value-indexed tables
  (``static_tables``: warp w walks values w R + i, i + 32, ... from a
  search of 4 halvings); the lane's words in O1Words' registers (cur, nxt,
  far a thread, moved every 8 bytes; far read past the lane's words is
  garbage and never used), runs of 8 bytes, bytes stored every 16.

Also: the adaptive table stays strictly increasing after every update
(the ground for j > s and i > s); the static tables equal the plain rule
for cdfs with zero-frequency symbols and one-symbol cdfs, and stay in
range for any [17] ints.  Negative controls: the update's predicate
swapped (j >= s); the lo nibble's row stored before the hi update; the
adaptive key taken before the update it must follow.  The constants the mirrors copy are
read from the source.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_nibble as N
from turborc_tpu_torch.codecs.rans_static import slot_probs
from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.ops import build, rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops import rans_nibble_kernel as NK

ROOT = Path(__file__).resolve().parents[1]
TEXT = np.fromfile(ROOT / "turborc_tpu" / "bench" / "_data" /
                   "textbwt_65536.bin", np.uint8)
CSRC = Path(build.__file__).resolve().parent / "csrc"
SRC = (CSRC / "rans_lane_kernel.cu").read_text()
COMMON = (CSRC / "rans_common.cuh").read_text()
U32 = 0xFFFFFFFF

# the kernels' constants (held against the source below)
LANES = 4         # kNibLanes
TEAM = 16         # kNibTeam (L9), and O1Words' kTeam (L10)
RATE = 7          # kNibRate
IC, MIXD = 10, 32736  # kIC, kMixd
TOTAL = 1 << 15
WARPS = 4         # kNibDecodeThreads / 32: L10's warps a CTA
RUN = TOTAL // WARPS  # kNibRun
ANS_LOW = 1 << 15


def _const(src: str, name: str) -> str:
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", src)
    assert m, name
    return m.group(1)


def test_constants_match_source():
    for name, want in (("kNibLanes", LANES), ("kNibTeam", TEAM),
                       ("kNibRate", RATE)):
        assert int(_const(SRC, name)) == want, name
    assert _const(SRC, "kNibModelThreads") == "kNibLanes * kNibTeam"
    assert int(_const(SRC, "kNibRows")) >= 16 * 2 * 17
    assert _const(SRC, "kNibDecodeThreads") == "kNibLanes * 32"
    assert int(_const(SRC, "kTeam")) == TEAM
    assert int(_const(COMMON, "kIC")) == IC
    assert int(_const(COMMON, "kMixd")) == MIXD == cdf16.MIXD
    assert RATE == cdf16.CDFRATE and IC == cdf16.IC
    assert NK.NIB_LANES == LANES and NK.NIB_TEAM == TEAM
    # the mirrors' predicates, searches and table build
    for line in ("c += (ic + (j > s ? kMixd : 0) - c) >> kNibRate;",
                 "rows[2 * u * 17 + j] = c;",
                 "rows[(2 * u + 1) * 17 + j] = c;",
                 "rows[j * 17 + 16] = kTotal;",
                 "const int sh = (r[hs] << 16) | (r[hs + 1] - r[hs]);",
                 "const int sl = (r[ls] << 16) | (r[ls + 1] - r[ls]);",
                 "hi = j == 0 ? kTotal : ih > s ? ha : hb;",
                 "lo = il > s ? la : lb;",
                 "__reduce_min_sync(kFull, uint32_t(hi) > value ? key : ~0u);",
                 "s = __popc(__ballot_sync(kFull, uint32_t(hi) <= value) & "
                 "0xFFFEu);",
                 "for (int it = 0; it < 4; ++it) {",
                 "while (sym < 15 && nx <= v) {",
                 "if (real && i < 16 && tj < t1) dst[size_t(tj) * L] = mine;"):
        assert line in SRC, line


# ---------------------------------------------------------------------------
# L9
# ---------------------------------------------------------------------------

def model_mirror(cols: np.ndarray, pred=">", pick_first=False) -> np.ndarray:
    """L9 on cols [K, L] u8 -> probs [2K, L] int32.  ``pred`` ">=" swaps
    the update's predicate; ``pick_first`` stores the lo nibble's row
    before the hi update (negative controls)."""
    K, L = cols.shape
    ctas = -(-L // LANES)
    Lp = ctas * LANES
    j = np.arange(TEAM)
    c = np.broadcast_to(j << 11, (Lp, TEAM)).astype(np.int64).copy()
    # a CTA's 4 bytes of a step in one u32, zero past K or past L
    padded = np.zeros((K + 96, Lp), np.int64)
    padded[:K, :L] = cols
    u32 = sum(padded[:, k::LANES] << (8 * k) for k in range(LANES))
    out = np.full((2 * K, L), -1, np.int64)
    n = np.arange(Lp) % LANES  # a lane's place in its CTA
    cta = np.arange(Lp) // LANES

    # the lane's rows: [16 steps x 2 nibbles, 17 entries], entry 16 = 2^15
    rows = np.full((Lp, 32, 17), -1, np.int64)
    rows[:, :, 16] = TOTAL

    def update(s):
        more = (j[None] >= s[:, None]) if pred == ">=" else \
            (j[None] > s[:, None])
        return c + ((j * IC + np.where(more, MIXD, 0) - c) >> RATE)

    for c0 in range(0, K, 32):
        for base in (0, 16):
            t0 = c0 + base
            for u in range(16):
                src = u32[t0 + u, cta]  # lane base + u of the chunk
                b = (src >> (8 * n)) & 255
                rows[:, 2 * u, :16] = c  # thread j's store of entry j
                before = c.copy()
                c = update(b >> 4)
                rows[:, 2 * u + 1, :16] = before if pick_first else c
                c = update(b & 15)
            # thread j: the slots of step t0 + j from the rows
            b = (u32[t0:t0 + 16][:, cta].T >> (8 * n[:, None])) & 255
            row = np.arange(Lp)[:, None]
            r = rows[row, 2 * np.arange(TEAM)[None, :]]     # [Lp, 16, 17]
            q = rows[row, 2 * np.arange(TEAM)[None, :] + 1]
            hs, ls = b >> 4, b & 15
            pick = lambda t, s: np.take_along_axis(  # noqa: E731
                t, s[..., None], -1)[..., 0]
            sh = (pick(r, hs) << 16) | (pick(r, hs + 1) - pick(r, hs))
            sl = (pick(q, ls) << 16) | (pick(q, ls + 1) - pick(q, ls))
            for jj in range(TEAM):
                t = t0 + jj
                if t < K:
                    out[2 * t] = sh[:L, jj]
                    out[2 * t + 1] = sl[:L, jj]
    return out.astype(np.int32)


def _cols(what: str, K: int, L: int, rng) -> np.ndarray:
    if what == "random":
        return rng.integers(0, 256, (K, L), dtype=np.uint8)
    if what == "run":
        return np.broadcast_to((np.arange(L) % 2 * 255).astype(np.uint8),
                               (K, L)).copy()
    if what == "alternate":
        return rng.integers(0, 256, (2, L), dtype=np.uint8)[np.arange(K) % 2]
    if what == "every byte":
        return ((np.arange(K)[:, None] + 37 * np.arange(L)) % 256).astype(
            np.uint8)
    off = int(rng.integers(0, TEXT.size - K * L))  # textbwt
    return TEXT[off:off + K * L].reshape(K, L).copy()


# (bytes, K, L): K of 1 to 64, 37 and a chunk of 16 (L10) or 32 (L9) +- 1
# among them; L from 1 (a CTA of one real lane) to 32; 2 KB of textbwt
CASES = (("random", 37, 8), ("random", 1, 4), ("run", 33, 4),
         ("alternate", 31, 2), ("every byte", 64, 4), ("textbwt", 17, 1),
         ("textbwt", 15, 16), ("textbwt", 16, 8), ("textbwt", 32, 32),
         ("textbwt", 128, 16))
IDS = [f"{w}-K{K}-L{L}" for w, K, L in CASES]


@pytest.mark.parametrize("what,K,L", CASES, ids=IDS)
def test_model_mirror_equals_plain(what, K, L):
    cols = _cols(what, K, L, np.random.default_rng(K * 131 + L))
    want = NK.lane_nibble_model_plain(torch.from_numpy(cols)).numpy()
    assert np.array_equal(model_mirror(cols), want)


def test_model_negative_controls():
    cols = _cols("textbwt", 37, 8, np.random.default_rng(5))
    want = NK.lane_nibble_model_plain(torch.from_numpy(cols)).numpy()
    assert not np.array_equal(model_mirror(cols, pred=">="), want)
    assert not np.array_equal(model_mirror(cols, pick_first=True), want)


def test_adaptive_table_strictly_increasing():
    """cdf16.update at rate 7 keeps every table strictly increasing on any
    nibble stream, so c_i > low is i > s (L9's and L10's predicate)."""
    rng = np.random.default_rng(20261019)
    streams = [rng.integers(0, 16, (4096, 64)),                  # uniform
               np.minimum(rng.geometric(0.5, (4096, 64)) - 1, 15),  # skewed
               np.broadcast_to(np.arange(64) % 16, (4096, 64)),  # runs
               np.where(np.arange(4096)[:, None] % 2, 0, 15)
               + np.zeros((1, 64), np.int64)]                    # 0, 15
    for nibs in streams:
        c = cdf16.init((nibs.shape[1],)).to(torch.int64)
        for s in torch.from_numpy(np.ascontiguousarray(nibs)):
            low, _ = cdf16.lookup(c, s)
            c = cdf16.update(c, low)
            assert bool((c[:, 1:] > c[:, :-1]).all())
            assert bool((c[:, 15] < TOTAL).all())


# ---------------------------------------------------------------------------
# L10
# ---------------------------------------------------------------------------

def static_tables(c: np.ndarray):
    """nib_static_tables: (ent [2^15] u32, sym_of [2^15]) of cdf c [17]."""
    return _static_tables(tuple(int(x) for x in c))


@functools.lru_cache(maxsize=None)
def _static_tables(c: tuple):
    c = np.asarray(c, np.int64)
    ent = np.zeros(TOTAL, np.int64)
    sym_of = np.zeros(TOTAL, np.int64)
    for warp in range(WARPS):
        for i in range(32):
            v = warp * RUN + i
            lo, hi = 0, 16
            for _ in range(4):
                mid = (lo + hi) >> 1
                if c[mid] <= v:
                    lo = mid
                else:
                    hi = mid
            sym, low, nx = lo, c[lo], c[lo + 1]
            for _ in range(RUN // 32):
                while sym < 15 and nx <= v:
                    sym += 1
                    low, nx = nx, c[sym + 1]
                ent[v] = (((nx - low) << 16) | ((v - low) & 0xFFFF)) & U32
                sym_of[v] = sym
                v += 32
    return ent, sym_of


class Words:
    """O1Words for every lane at once: thread j of a lane holds word p of
    the lane at p % 16 in cur (the chunk at base), nxt and far; `far` read
    past the lane's words is garbage (the kernel's read of an in-bounds
    address), replaced by 0 when it moves into nxt."""

    def __init__(self, words, lengths, M, real, rng):
        W, Lp = words.shape[0], real.shape[0]
        self.rng = rng
        self.flat = words.astype(np.int64) & 0xFFFF
        ln = np.zeros(Lp, np.int64)
        ln[:lengths.shape[0]] = lengths
        off = np.cumsum(ln) - ln
        o = np.where(real, off, -1)
        n = np.where((o >= 0) & (o < W), np.minimum(np.minimum(ln, M), W - o),
                     0)
        self.n, self.o = np.maximum(n, 0), np.where(real, o, 0)
        self.j = np.arange(TEAM)
        self.cur = self._word(self.j[None, :])
        self.nxt = self._word(TEAM + self.j[None, :])
        self.far_ok, self.far = self._far(2 * TEAM + self.j[None, :])
        hi, lo = self.cur[:, 0], self.cur[:, 1]
        self.state0 = np.where(real, (hi << 16) | lo, ANS_LOW)
        self.pos = np.full(Lp, 2)
        self.base = np.zeros(Lp, np.int64)
        self.next = self.cur[:, 2].copy()

    def _word(self, p):
        ok = p < self.n[:, None]
        idx = np.where(ok, self.o[:, None] + p, 0)
        return np.where(ok, self.flat[np.minimum(idx, self.flat.size - 1)],
                        0)

    def _far(self, p):
        ok = p < self.n[:, None]
        junk = self.rng.integers(0, 1 << 16, ok.shape)
        return ok, np.where(ok, self._word(p), junk)

    def renorm(self, state):
        take = state < ANS_LOW
        value = np.where(take, self.next & (TOTAL - 1), state & (TOTAL - 1))
        state = np.where(take, ((state << 16) | self.next) & U32, state)
        self.pos = self.pos + take
        row = np.arange(state.shape[0])
        src = np.where((self.pos - self.base < TEAM)[:, None], self.cur,
                       self.nxt)
        self.next = src[row, self.pos & (TEAM - 1)]
        return value, state

    def move(self):
        left = (self.pos - self.base >= TEAM)[:, None]
        self.cur = np.where(left, self.nxt, self.cur)
        self.nxt = np.where(left, np.where(self.far_ok, self.far, 0),
                            self.nxt)
        self.base = self.base + TEAM * left[:, 0]
        self.far_ok, self.far = self._far(self.base[:, None] + 2 * TEAM
                                          + self.j[None, :])


def decode_mirror(words: np.ndarray, lengths: np.ndarray, K: int,
                  cdf=None, pred=">", stale_key=False, seed=0) -> np.ndarray:
    """L10 (static where ``cdf`` is given) -> bytes [K, L] u8.  ``pred``
    ">=" swaps the update's predicate; ``stale_key`` keeps the search key
    of the table before the update (negative controls)."""
    L = lengths.shape[0]
    Lp = -(-L // LANES) * LANES
    real = np.arange(Lp) < L
    rng = np.random.default_rng(seed)
    w = Words(words, lengths, 2 * K + 2, real, rng)
    state = w.state0
    value = state & (TOTAL - 1)
    j = np.arange(TEAM)
    ih, il = j, (j - 1) & 15
    hi = np.broadcast_to(np.where(j > 0, j << 11, TOTAL), (Lp, TEAM)).copy()
    lo = np.broadcast_to(il << 11, (Lp, TEAM)).copy()
    key = (hi << 16) | lo
    if cdf is not None:
        ent, sym_of = static_tables(cdf)
    out = np.zeros((K, L), np.uint8)
    mine = np.zeros((Lp, TEAM), np.int64)

    def nibble():
        nonlocal state, value, hi, lo, key
        if cdf is not None:
            e = ent[value]
            s = sym_of[value]
            state = ((e >> 16) * (state >> 15) + (e & 0xFFFF)) & U32
        else:
            th, tl = ih * IC - hi, il * IC - lo
            ha, hb = hi + ((th + MIXD) >> RATE), hi + (th >> RATE)
            la, lb = lo + ((tl + MIXD) >> RATE), lo + (tl >> RATE)
            kmin = np.where(hi > value[:, None], key, U32).min(1)
            s = ((hi <= value[:, None]) & (j > 0)).sum(1)
            low = kmin & 0xFFFF
            state = (((kmin >> 16) - low) * (state >> 15) + value - low) & U32
            more = lambda i: (i[None] >= s[:, None]) if pred == ">=" else \
                (i[None] > s[:, None])  # noqa: E731
            old = key
            hi = np.where(j[None] == 0, TOTAL, np.where(more(ih), ha, hb))
            lo = np.where(more(il), la, lb)
            key = old if stale_key else (hi << 16) | lo
        value, state = w.renorm(state)
        return s

    for t0 in range(0, K, 8):
        t1 = min(t0 + 8, K)
        for t in range(t0, t1):
            h = nibble()
            b = (h << 4) | nibble()
            mine[:, t & 15] = b  # thread t mod 16 keeps it
        w.move()
        if t1 % 16 == 0 or t1 == K:
            for jj in range(TEAM):
                tj = ((t1 - 1) & ~15) + jj
                if tj < t1:
                    out[tj] = mine[:L, jj]
    return out


def _streams(cols: np.ndarray, static: bool):
    """The lane streams of cols under id 41's model or id 40's table:
    (words [W] int16, lengths [L] int32, cdf [17] or None)."""
    x = torch.from_numpy(cols)
    init = torch.full((cols.shape[1],), rans.ANS_LOW, dtype=torch.int32)
    cdf = None
    if static:
        cdf = torch.from_numpy(N._cdf(N.build_nibble_freqs(cols.reshape(-1))))
        probs = slot_probs(NK.nibbles(x), cdf)
    else:
        probs = NK.lane_nibble_model_plain(x)
    st, ln = LK.lane_coder(probs, init)
    return blockio.device_words(st, ln), ln, cdf


def _corrupt(words, lengths, rng) -> dict:
    """Every 16th word flipped; a quarter of the lengths cut to 2, a
    quarter raised past 2K + 2 and past the words; every lane's length 0."""
    flip = words.clone()
    flip[::16] ^= torch.from_numpy(
        rng.integers(1, 1 << 15, flip[::16].shape).astype(np.int16))
    cut, long = lengths.clone(), lengths.clone()
    cut[::4] = 2
    long[1::4] = 1 << 20
    return {"sound": (words, lengths), "flipped": (flip, lengths),
            "cut": (words, cut), "long": (words, long),
            "none": (words, torch.zeros_like(lengths))}


def _plain(words, lengths, K, cdf):
    if cdf is None:
        return NK.lane_nibble_decode_plain(words, lengths, K).numpy()
    return NK.lane_nibble_static_decode_plain(words, lengths, K, cdf).numpy()


@pytest.mark.parametrize("static", [False, True], ids=["adaptive", "static"])
@pytest.mark.parametrize("what,K,L", CASES, ids=IDS)
def test_decode_mirror_equals_plain(what, K, L, static):
    rng = np.random.default_rng(K * 7 + L)
    cols = _cols(what, K, L, rng)
    words, lens, cdf = _streams(cols, static)
    c = None if cdf is None else cdf.numpy()
    for name, (wd, ln) in _corrupt(words, lens, rng).items():
        got = decode_mirror(wd.numpy(), ln.numpy(), K, c, seed=K)
        want = _plain(wd, ln, K, cdf)
        assert np.array_equal(got, want), name
        if name == "sound":
            assert np.array_equal(got, cols)


def test_decode_negative_controls():
    cols = _cols("textbwt", 37, 8, np.random.default_rng(9))
    words, lens, _ = _streams(cols, False)
    w, ln = words.numpy(), lens.numpy()
    assert np.array_equal(decode_mirror(w, ln, 37), cols)
    assert not np.array_equal(decode_mirror(w, ln, 37, pred=">="), cols)
    assert not np.array_equal(decode_mirror(w, ln, 37, stale_key=True), cols)


def _plain_rule(c: np.ndarray):
    """decode_static's symbol, low and freq of every value."""
    v = np.arange(TOTAL)
    s = np.maximum(15 - (c[None, :16] > v[:, None]).sum(1), 0)
    return s, c[s], c[s + 1] - c[s]


def _cdf(freqs) -> np.ndarray:
    f = np.asarray(freqs, np.int64)
    assert f.sum() == TOTAL and f.size == 16
    return np.concatenate([[0], np.cumsum(f)])


STATIC_CDFS = {
    "symbol 0 zero": [0] + [2048] * 14 + [TOTAL - 14 * 2048],
    "symbol 15 zero": [2048] * 14 + [TOTAL - 14 * 2048, 0],
    "inner zeros": [0, 9000, 0, 0, 7000, 1] + [0] * 9 + [TOTAL - 16001],
    "only symbol 0": [TOTAL] + [0] * 15,
    "only symbol 7": [0] * 7 + [TOTAL] + [0] * 8,
    "only symbol 15": [0] * 15 + [TOTAL],
    "all but 15 to symbol 0": [TOTAL - 15] + [1] * 15,
}


@pytest.mark.parametrize("name", STATIC_CDFS)
def test_static_tables_equal_plain_rule(name):
    c = _cdf(STATIC_CDFS[name])
    ent, sym_of = static_tables(c)
    s, low, freq = _plain_rule(c)
    assert np.array_equal(sym_of, s)
    assert np.array_equal(ent >> 16, freq)
    assert np.array_equal(ent & 0xFFFF, np.arange(TOTAL) - low)
    assert (freq >= 1).all()


def test_static_tables_stay_in_range_on_any_cdf():
    """For [17] ints that are no cdf, the walk's symbol stays in [0, 15]
    (every read of the cdf inside it); the wrapper refuses these."""
    rng = np.random.default_rng(3)
    for c in (rng.integers(-(1 << 20), 1 << 20, 17),
              np.arange(17)[::-1] * 2048, np.full(17, TOTAL)):
        _, sym_of = static_tables(c)
        assert sym_of.min() >= 0 and sym_of.max() <= 15
        with pytest.raises(ValueError):
            NK.lane_nibble_static_decode(
                torch.zeros(8, dtype=torch.int16),
                torch.zeros(4, dtype=torch.int32), 2,
                torch.from_numpy(c.astype(np.int32)))


@pytest.mark.parametrize("name", ["inner zeros", "only symbol 7",
                                  "only symbol 15"])
def test_static_decode_mirror_on_extreme_cdfs(name):
    """Streams coded on the block's cdf, decoded on an extreme one (sound
    and corrupt): the mirror equals the plain decode."""
    f = STATIC_CDFS[name]
    rng = np.random.default_rng(len(name))
    cols = _cols("textbwt", 37, 8, rng)
    words, lens, _ = _streams(cols, True)
    c = torch.from_numpy(_cdf(f).astype(np.int32))
    for key, (wd, ln) in _corrupt(words, lens, rng).items():
        got = decode_mirror(wd.numpy(), ln.numpy(), 37, c.numpy())
        assert np.array_equal(got, _plain(wd, ln, 37, c)), key
