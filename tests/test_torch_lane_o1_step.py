"""The byte step of the order-1 lane decodes L6 (id 59, ``O1Rank``) and
L8 (id 64, ``O1Byte``), ``lane_o1_decode_kernel`` in
``ops/csrc/rans_lane_kernel.cu``, on the CPU without the card: a numpy
mirror of the step thread by thread on the team layout (team thread j
holds entry j of every row of its lane), with the one-round search and
lookup (the team's min of (c_j << 16 | c_{j-1}) over c_j > value, the
symbol from a ballot), the rows read as soon as their index is known and
after the step's own stores to them, and the word reader that moves three
chunks of 16 words along every 8 steps.  The mirror is held exactly against the
plain versions ``lane_o1_decode_plain`` / ``lane_o1r_decode_plain``
(which ``test_torch_lane_o1.py`` and the goldens hold against the JAX
package) on random bytes, runs of one byte, bytes that share one id-59
bucket row from many contexts, a few KB of realsrcbwt and corrupt
streams.  Negative controls that must fail: the next hi row read before
the step's hi store, on a run, and the one-round search on a row that is
not non-decreasing.  Source checks hold the constants and expressions the
mirror copies.  No JAX.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.codecs import rans_cdf_r1_lane as R59
from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.ops import build, rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO

SRC = (Path(build.__file__).resolve().parent / "csrc"
       / "rans_lane_kernel.cu").read_text()
REAL = (Path(R1.__file__).resolve().parents[2] / "turborc_tpu" / "bench"
        / "_data" / "realsrcbwt_16777216.bin")
TEAM = 16
TOTAL = cdf16.TOTAL
LOW = rans.ANS_LOW
J = np.arange(TEAM)


# ---------------------------------------------------------------------------
# the contexts, as the source's O1Rank and O1Byte
# ---------------------------------------------------------------------------

class Rank:
    """id 59: 64 hi rows by the rank context, 48 lo rows."""
    name, hi_rows, lo_rows = "O1Rank", 64, 48

    @staticmethod
    def hi_row(prev):
        return R1.np_hictx(prev)

    @staticmethod
    def lo_row(prev, hs):
        return R1.np_locx(prev, hs)


class Byte:
    """id 64: 256 hi rows by prev, 4,096 lo rows by (prev, hs)."""
    name, hi_rows, lo_rows = "O1Byte", 256, 4096

    @staticmethod
    def hi_row(prev):
        return prev

    @staticmethod
    def lo_row(prev, hs):
        return prev * 16 + hs


# ---------------------------------------------------------------------------
# the team's operations; arrays are [L, 16]: lane, team thread
# ---------------------------------------------------------------------------

def entry(mem, row):
    """Thread j's entry of its lane's row ``row`` (team-uniform)."""
    L = mem.shape[0]
    return mem[np.arange(L)[:, None], row, J[None, :]]


def store(mem, row, v):
    L = mem.shape[0]
    mem[np.arange(L)[:, None], row, J[None, :]] = v


def search(c, value):
    """o1_search of every team: (sym, low, freq), team-uniform: the min of
    (c_j << 16 | c_{j-1}) over c_j > value (thread 0 stands for the entry
    16 = 2^15, before which c_15 lies), low and next in its halves; the
    symbol a popc of the ballot c_j <= value over j >= 1."""
    v = np.broadcast_to(value, c.shape)[:, :1]
    hi = np.where(J == 0, TOTAL, c)
    before = np.roll(c, 1, axis=1)  # c_{(j - 1) & 15}
    key = np.where(hi > v, hi << 16 | before, (1 << 32) - 1)
    kmin = key.min(1, keepdims=True)
    sym = (c[:, 1:] <= v).sum(1, keepdims=True)
    low, nx = kmin & 0xFFFF, kmin >> 16
    sym, low = (np.broadcast_to(x, c.shape) for x in (sym, low))
    return sym, low, np.broadcast_to(nx, c.shape) - low


def update(c, low):
    """o1_update: cdf_update of entry j."""
    return c + ((J * cdf16.IC - c + np.where(c > low, cdf16.MIXD, 0))
                >> cdf16.CDFRATE)


# ---------------------------------------------------------------------------
# the word reader (O1Words)
# ---------------------------------------------------------------------------

class Words:
    """TeamWords' layout three chunks deep: cur (base), nxt, far, moved
    along every 8 steps; far loaded at every move, used at the next."""

    def __init__(self, words, lengths, K):
        W, L = words.shape[0], lengths.shape[0]
        flat = words.astype(np.int64) & 0xFFFF
        ln = lengths.astype(np.int64)
        off = np.cumsum(ln) - ln
        M = 2 * K + 2
        self.n = np.where((off >= 0) & (off < W),
                          np.minimum(np.minimum(ln, M), W - off), 0)[:, None]
        self.n = np.maximum(self.n, 0)
        self.flat, self.off = flat, off[:, None]

        def word(p):
            ok = p < self.n
            return np.where(ok, flat[np.where(ok, self.off + p, 0)], 0), ok
        self.word = word
        self.cur = word(J[None, :] + 0 * self.n)[0]
        self.nxt = word(TEAM + J[None, :] + 0 * self.n)[0]
        self.far, self.far_ok = word(2 * TEAM + J[None, :] + 0 * self.n)
        self.state = np.broadcast_to(self.cur[:, :1] << 16 | self.cur[:, 1:2],
                                     (L, TEAM)).copy()
        self.pos = np.full((L, TEAM), 2)
        self.base = np.zeros((L, TEAM), np.int64)
        self.next = self._shfl()

    def _shfl(self):
        src = np.where(self.pos - self.base < TEAM, self.cur, self.nxt)
        return np.take_along_axis(src, self.pos & (TEAM - 1), 1)

    def renorm(self, state):
        """(state, value): the value is the taken word's low 15 bits where
        it takes one, beside the state's."""
        take = state < LOW
        value = np.where(take, self.next, state) & (TOTAL - 1)
        state = np.where(take, state << 16 | self.next, state)
        self.pos = self.pos + take
        assert ((self.pos - self.base) < 2 * TEAM).all()
        self.next = self._shfl()
        return state, value

    def move(self):
        left = self.pos - self.base >= TEAM
        self.cur = np.where(left, self.nxt, self.cur)
        self.nxt = np.where(left, np.where(self.far_ok, self.far, 0),
                            self.nxt)
        self.base = self.base + TEAM * left
        self.far, self.far_ok = self.word(self.base + 2 * TEAM + J)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def start(ctx, L, hi_tbl=None, lo_tbl=None):
    """o1_start: every lane's rows, [L, rows, 16] (entry j at thread j)."""
    rows = ctx.hi_rows + ctx.lo_rows
    if hi_tbl is None:  # cdf16.init
        return np.broadcast_to(J << 11, (L, rows, TEAM)).astype(np.int64)
    seg = np.arange(L) * hi_tbl.shape[0] // L
    return np.concatenate([hi_tbl[seg], lo_tbl[seg]], 1).astype(np.int64)


def mirror_decode(ctx, words, lengths, K, hi_tbl=None, lo_tbl=None,
                  early_hi=False):
    """The step of lane_o1_decode_kernel<ctx> on every lane -> bytes
    [K, L] uint8.  ``early_hi`` reads the next hi row before the step's
    hi store (a negative control)."""
    words, lengths = np.asarray(words), np.asarray(lengths)
    L = lengths.shape[0]
    mem = start(ctx, L, hi_tbl, lo_tbl).copy()
    w = Words(words, lengths, K)
    state = w.state
    z = np.zeros((L, TEAM), np.int64)
    prev = z.copy()
    H = ctx.hi_row(prev)
    hrow = entry(mem, H)
    out = np.zeros((K, L), np.uint8)
    mine = z.copy()
    value = state & (TOTAL - 1)
    for t in range(K):
        hs, low_h, fr_h = search(hrow, value)
        lr = ctx.hi_rows + ctx.lo_row(prev, hs)
        lrow = entry(mem, lr)
        state = fr_h * (state >> 15) + value - low_h
        state, value = w.renorm(state)
        hnew = update(hrow, low_h)
        if not early_hi:
            store(mem, H, hnew)
        ls, low_l, fr_l = search(lrow, value)
        Hn = ctx.hi_row(hs << 4 | ls)
        hrow = entry(mem, Hn)
        if early_hi:
            store(mem, H, hnew)
        H = Hn
        state = fr_l * (state >> 15) + value - low_l
        state, value = w.renorm(state)
        store(mem, lr, update(lrow, low_l))
        prev = hs << 4 | ls
        mine = np.where(J == (t & (TEAM - 1)), prev, mine)
        if (t & 7) == 7:
            w.move()
        if (t & (TEAM - 1)) == TEAM - 1 or t == K - 1:
            t0 = t & ~(TEAM - 1)
            for jj in range(t - t0 + 1):
                out[t0 + jj] = mine[:, jj]
    return out


# ---------------------------------------------------------------------------
# inputs: bytes -> (words, lengths, K, tables) through the plain L5 / L7
# and L2
# ---------------------------------------------------------------------------

def _streams(probs, L):
    st, lens = LK.lane_coder_plain(probs, torch.full(
        (L,), LOW, dtype=torch.int32))
    return blockio.device_words(st, lens), lens


def encode(codec: str, cols: np.ndarray, n_seg: int = 1):
    """cols [K, L] u8 (id 59: ranks) -> (ctx, words, lengths, K,
    tables)."""
    t = torch.from_numpy(np.ascontiguousarray(cols))
    K, L = cols.shape
    if codec == "64":
        words, lens = _streams(LO.lane_o1_model_plain(t), L)
        return Byte, words, lens, K, ()
    padded = cols.T.reshape(-1)
    _, (hq, lq) = R1.quantize_tables(*R1.group_tables(padded, n_seg))
    tabs = R59.segment_cdfs(hq, lq, "cpu")
    words, lens = _streams(LO.lane_o1r_model_plain(t, *tabs), L)
    return Rank, words, lens, K, tabs


def plain(codec, words, lens, K, tabs):
    if codec == "64":
        return LO.lane_o1_decode_plain(words, lens, K).numpy()
    return LO.lane_o1r_decode_plain(words, lens, K, *tabs).numpy()


def mirror(ctx, words, lens, K, tabs, **kw):
    return mirror_decode(ctx, words.numpy(), lens.numpy(), K,
                         *(x.numpy() for x in tabs), **kw)


def _bytes(what: str, K: int, L: int) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, what)) + K * L)
    if what == "random":
        return rng.integers(0, 256, (K, L), dtype=np.uint8)
    if what == "runs":  # long runs of one byte, a few bytes between
        x = np.repeat(rng.integers(0, 256, K * L // 40 + 1), 40)[:K * L]
        x[rng.integers(0, K * L, K * L // 50)] ^= 0x11
        return x.astype(np.uint8).reshape(L, K).T.copy()
    if what == "one bucket":  # ranks 128-255: id 59's hi row 63 for all
        return rng.integers(128, 256, (K, L), dtype=np.uint8)
    if what == "realsrcbwt":
        x = np.fromfile(REAL, np.uint8, count=K * L, offset=1 << 20)
        return x.reshape(L, K).T.copy()
    raise ValueError(what)


CASES = [(codec, what, K, L)
         for codec in ("59", "64")
         for what, K, L in (("random", 96, 4), ("runs", 200, 2),
                            ("one bucket", 120, 8), ("realsrcbwt", 512, 8))]


@pytest.mark.parametrize("codec,what,K,L", CASES,
                         ids=[f"id{c}-{w}-K{K}-L{L}" for c, w, K, L in CASES])
def test_mirror_equals_plain(codec, what, K, L):
    """Exact: the mirror's bytes equal the plain decode's, which are the
    input (id 59 at two segments where the lanes allow)."""
    cols = _bytes(what, K, L)
    ctx, words, lens, K, tabs = encode(codec, cols, 2 if L >= 4 else 1)
    want = plain(codec, words, lens, K, tabs)
    assert np.array_equal(want, cols)
    assert np.array_equal(mirror(ctx, words, lens, K, tabs), want)


CORRUPT = ("flipped words", "lengths cut", "lengths past the words")


@pytest.mark.parametrize("codec", ["59", "64"])
@pytest.mark.parametrize("how", CORRUPT)
def test_mirror_corrupt_streams(codec, how):
    """Exact on corrupt streams: every 16th word flipped, a quarter of
    the lengths cut to 2, or raised past 2K + 2 and the words; the
    mirror gives the plain version's wrong bytes."""
    K, L = 160, 8
    cols = _bytes("realsrcbwt", K, L)
    ctx, words, lens, K, tabs = encode(codec, cols, 2)
    rng = np.random.default_rng(7)
    if how == "flipped words":
        words = words.clone()
        words[::16] ^= torch.from_numpy(
            rng.integers(1, 1 << 15, words[::16].shape).astype(np.int16))
    elif how == "lengths cut":
        lens = lens.clone()
        lens[::4] = 2
    else:
        lens = lens.clone()
        lens[1::4] = 1 << 20
    want = plain(codec, words, lens, K, tabs)
    assert not np.array_equal(want, cols)
    assert np.array_equal(mirror(ctx, words, lens, K, tabs), want)


@pytest.mark.parametrize("codec", ["59", "64"])
def test_next_hi_row_before_the_hi_store_fails_on_a_run(codec):
    """Negative control: the next hi row read before this step's hi store
    is the row as it was, wrong where the two rows are one (a run of one
    byte, or one id-59 bucket)."""
    cols = _bytes("runs" if codec == "64" else "one bucket", 200, 2)
    ctx, words, lens, K, tabs = encode(codec, cols)
    want = plain(codec, words, lens, K, tabs)
    assert not np.array_equal(
        mirror(ctx, words, lens, K, tabs, early_hi=True), want)


# ---------------------------------------------------------------------------
# the one-round search, the start rows and the word reader, alone
# ---------------------------------------------------------------------------

def _rows(n: int, seed: int, ties: bool) -> np.ndarray:
    """Non-decreasing rows from 0 below 2^15; with ``ties``, runs of
    equal entries."""
    rng = np.random.default_rng(seed)
    c = np.sort(rng.integers(1, TOTAL, (n, 16)), 1)
    c[:, 0] = 0
    if ties:
        c[:, 5:9] = c[:, 5:6]
        c[:, 12:] = c[:, 12:13]
    return c


@pytest.mark.parametrize("ties", [False, True])
def test_one_round_search_equals_cdf16(ties):
    """Exact on non-decreasing rows, with ties or without: the team's
    reduction and ballot give cdf16.search's symbol, low and freq for
    every value."""
    c = _rows(64, 11 + ties, ties)
    for value in np.random.default_rng(3).integers(0, TOTAL, 40):
        sym, low, fr = search(c, value)
        ws, wl, wf = cdf16.search(torch.from_numpy(c),
                                  torch.full((64,), int(value)))
        assert np.array_equal(sym[:, 0], ws.numpy())
        assert np.array_equal(low[:, 0], wl.numpy())
        assert np.array_equal(fr[:, 0], wf.numpy())


def test_one_round_search_fails_on_a_non_monotone_row():
    """Negative control: on a row that falls somewhere, the reduction need
    not give the entries at the counted symbol."""
    c = np.array([[0, 12000, 3000, 14000, *range(15000, 27000, 1000)]])
    value = 10000
    sym, low, fr = search(c, value)
    ws, wl, wf = cdf16.search(torch.from_numpy(c), torch.tensor([value]))
    assert (sym[0, 0], low[0, 0], fr[0, 0]) != (int(ws[0]), int(wl[0]),
                                                 int(wf[0]))


@pytest.mark.parametrize("seed", range(3))
def test_id59_start_rows_strictly_increasing(seed):
    """Whatever u8 codes a payload holds, codes_to_tables and
    segment_cdfs give id 59 rows strictly increasing from 0 below 2^15,
    where the one-round search holds."""
    codes = np.random.default_rng(seed).integers(
        0, 256, (3, R1.N_ENTRIES)).astype(np.uint8)
    if seed == 0:
        codes[0] = 255  # every freq at the code's maximum
        codes[1] = 0    # every freq 0
    for t in R59.segment_cdfs(*R1.codes_to_tables(codes), "cpu"):
        t = t.numpy()
        assert (t[..., 0] == 0).all() and (np.diff(t, axis=-1) > 0).all()
        assert (t < TOTAL).all()


def test_words_hold_two_takes_a_step():
    """At most two words a step: between moves (8 steps) pos stays within
    cur and nxt, on a stream that takes a word at every renorm (word p is
    p)."""
    w = Words(np.arange(400, dtype=np.int16), np.array([400]), 199)
    state = np.zeros((1, TEAM), np.int64)
    for t in range(150):
        for _ in range(2):
            assert (w.next == (w.pos & 0xFFFF)).all()
            state, _ = w.renorm(np.zeros_like(state))
        if (t & 7) == 7:
            w.move()


def test_words_past_the_lane_read_zero():
    """Words past the lane's n read as 0 when they move into nxt (word p
    of this stream is p + 1, the lane holds 20); the stream's own words
    would not."""
    w = Words(np.arange(1, 101, dtype=np.int16), np.array([20]), 49)
    seen = []
    for t in range(32):
        seen.append(int(w.next[0, 0]))
        w.renorm(np.zeros((1, TEAM), np.int64))
        if (t & 7) == 7:
            w.move()
    assert seen == [p + 1 if p < 20 else 0 for p in range(2, 34)]
    assert seen != list(range(3, 35))


# ---------------------------------------------------------------------------
# what the mirror copies, against the source
# ---------------------------------------------------------------------------

SOURCE_FORMS = [
    ("O1Rank decode lanes", "static constexpr int kDLanes = 4;"),
    ("O1Byte decode lanes", "static constexpr int kDLanes = 1;"),
    ("a warp a lane", "const bool dummy = n & 1;\n  const int ln = n >> 1;"),
    ("pair key", "return {c, hi, dummy ? ~0u : hi << 16 | before};"),
    ("pair neighbour", "const uint32_t before = p[((j - 1) & 15) - j];"),
    ("pair entry 16", "const uint32_t hi = j ? uint32_t(c) : "
     "uint32_t(kTotal);"),
    ("pair min", "__reduce_min_sync(kFull, e.hi > value ? e.key : ~0u);"),
    ("pair symbol", "__popc(__ballot_sync(kFull, uint32_t(e.c) <= value) & "
     "0xFFFEu);"),
    ("lo row read after hs", "const O1Entry lrow = o1_entry(lp, j, dummy);"),
    ("the step's order", "*hp = uint16_t(o1_update(hrow.c, low_h, j));\n"
     "      int low_l, fr_l;\n"
     "      const int ls = o1_search(lrow, value, low_l, fr_l);\n"
     "      prev = hs << 4 | ls;\n"
     "      hp = r.base + C::hi_row(prev) * r.stride;\n"
     "      hrow = o1_entry(hp, j, dummy);"),
    ("value beside the renorm", "const uint32_t value = take ? w.t.next & "
     "(kTotal - 1) : state & (kTotal - 1);"),
    ("update", "return c + ((j * kIC - c + (c > low ? kMixd : 0)) >> "
     "kO1Rate);"),
    ("words read", "w.t.next = __shfl_sync(kFull, w.t.pos - w.base < kTeam "
     "? w.t.cur : w.t.nxt,"),
    ("steps in runs of 8", "for (int t0 = 0; t0 < K; t0 += 8) {\n"
     "    auto step = [&](int t) {"),
    ("a run unrolled", "#pragma unroll\n"
     "      for (int u = 0; u < 8; ++u) step(t0 + u);"),
    ("words moved after a run", "    o1_words_move(w, j);\n"
     "    if ((t1 & (kTeam - 1)) == 0 || t1 == K) {"),
    ("far load", "const int p = w.base + 2 * kTeam + j;"),
    ("far into nxt", "w.t.nxt = left ? (w.far_ok ? w.far : 0u) : w.t.nxt;"),
]


@pytest.mark.parametrize("what,form", SOURCE_FORMS,
                         ids=[w for w, _ in SOURCE_FORMS])
def test_source_holds_what_the_mirror_copies(what, form):
    assert form in SRC, what


def test_decode_launch_matches_source():
    """The decode's CTA as the wrapper reports it: a warp a lane, the
    lanes' rows and a scratch row a dummy team."""
    assert "return C::kDLanes * 32;" in SRC
    assert "return ((C::kHiRows + C::kLoRows) + 1) * C::kDLanes * 32;" in SRC
    assert LO.O1_DECODE_LANES == {"rans-cdf-r1": 4, "rans-cdf-o1": 1}
    assert LO.o1_launch(512, "rans-cdf-r1", decode=True) == (
        4, 128, (112 + 1) * 4 * 32, 128)
    assert LO.o1_launch(128, "rans-cdf-o1", decode=True) == (
        1, 32, (4352 + 1) * 32, 128)
