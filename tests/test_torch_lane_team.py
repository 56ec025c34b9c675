"""The team layout of the lane kernels L1 and L3
(``ops/csrc/rans_lane_kernel.cu``) on the CPU, without the card: numpy
mirrors of each team operation, thread by thread on the layout the
kernels use (thread j of lane l's team holds entries j E .. j E + E - 1
of the lane's tables, E = 16 / T; a warp holds 32 / T teams), held
against the plain versions (``models/cdf16.py``, ``models/span.py``'s
re-join) for every T the kernels build, each with a negative control
that must fail; and the team size's dispatch against the source.  No
JAX.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_cdf_s8 as S58
from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.models import span as SM
from turborc_tpu_torch.ops import build
from turborc_tpu_torch.ops import rans_lane_kernel as LK

SRC = (Path(build.__file__).resolve().parent / "csrc"
       / "rans_lane_kernel.cu").read_text()
TEAMS = (4, 8, 16)  # the T the probe's sweep builds; the dispatch 16, 8
TOTAL = cdf16.TOTAL


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


def test_team_constants_match_source():
    """kTeam, kMaxThreads, kCtaMin and the dispatch (kTeam / 2 where kTeam
    * share > kMaxThreads), E = 16 / T, as the wrapper mirrors them."""
    assert _const("kTeam") == LK.LANE_TEAM
    assert _const("kMaxThreads") == LK.LANE_MAX_THREADS
    assert _const("kCtaMin") == LK.LANE_CTA_MIN
    assert "if (kTeam * m.share > kMaxThreads)" in SRC
    assert "std::integral_constant<int, kTeam / 2>()" in SRC
    assert SRC.count("constexpr int E = 16 / T") >= 4
    assert "g.threads = m.share * T > kCtaMin ? m.share * T : kCtaMin;" in SRC


@pytest.mark.parametrize("share", [1, 2, 4, 8, 16, 32, 64, 128])
def test_team_dispatch(share):
    """T is 16 up to share 64 and 8 at share 128; a CTA holds whole spans
    and at most 1024 threads; 512 lanes (the default) run 64 CTAs at
    shares up to 8, 16 times the first design's 4."""
    T, threads, ctas = LK.lane_launch(512, share)
    assert T == (8 if share == 128 else 16)
    assert threads <= 1024 and threads % (share * T) == 0
    assert ctas * (threads // T) >= 512
    if share <= 8:
        assert ctas == 64


# ---------------------------------------------------------------------------
# the layout and the warp's collectives
# ---------------------------------------------------------------------------

def spread(tables: np.ndarray, T: int) -> np.ndarray:
    """[lanes, 16] tables -> [lanes * T, E]: thread l T + j holds entries
    j E .. j E + E - 1 of lane l's table."""
    return tables.reshape(-1, T, 16 // T).reshape(-1, 16 // T)


def gather(parts: np.ndarray, T: int) -> np.ndarray:
    return parts.reshape(-1, T * (16 // T)).reshape(-1, 16)


def ballot(pred: np.ndarray) -> np.ndarray:
    """__ballot_sync(kFull): every thread gets its warp's 32 bits."""
    bits = pred.reshape(-1, 32).astype(np.int64) << np.arange(32)
    return np.repeat(bits.sum(1), 32)


def lane_in_warp(n: int) -> np.ndarray:
    return np.arange(n) & 31


def team_mask(n: int, T: int) -> np.ndarray:
    """team_mask<T>(): the team's bits of its warp."""
    return ((1 << T) - 1) << (lane_in_warp(n) & ~(T - 1))


def shfl(v: np.ndarray, src: np.ndarray, width: int) -> np.ndarray:
    """__shfl_sync(kFull, v, src, width)."""
    lane = lane_in_warp(v.shape[0])
    base = np.arange(v.shape[0]) - lane + (lane & ~(width - 1))
    return v[base + (src & (width - 1))]


def shfl_up(v: np.ndarray, d: int, width: int) -> np.ndarray:
    lane = lane_in_warp(v.shape[0])
    ok = (lane & (width - 1)) >= d
    return np.where(ok, v[np.maximum(np.arange(v.shape[0]) - d, 0)], v)


def shfl_xor(v: np.ndarray, k: int) -> np.ndarray:
    return v[np.arange(v.shape[0]) ^ k]


def popc(x: np.ndarray) -> np.ndarray:
    return np.array([bin(int(v)).count("1") for v in x])


def _tables(lanes: int, seed: int, ties: bool = False) -> np.ndarray:
    """Strictly increasing CDF16 tables (cdf[0] = 0, the 15 others distinct
    in [1, 2^15)); with ``ties``, one entry of each equals the one before
    it."""
    rng = np.random.default_rng(seed)
    cdf = np.zeros((lanes, 16), np.int64)
    for lane in range(lanes):
        top = int(rng.choice([64, 4096, TOTAL]))  # crowded and spread out
        cdf[lane, 1:] = np.sort(rng.choice(np.arange(1, top), 15,
                                           replace=False))
    if ties:
        i = rng.integers(1, 15, lanes)
        cdf[np.arange(lanes), i + 1] = cdf[np.arange(lanes), i]
    return cdf


def _values(lanes: int, seed: int) -> np.ndarray:
    v = np.random.default_rng(seed).integers(0, TOTAL, lanes)
    v[:4] = [0, TOTAL - 1, 1, TOTAL // 2]
    return v


# ---------------------------------------------------------------------------
# search and lookup
# ---------------------------------------------------------------------------

def search_mirror(tables, value, T, skip_zero=True):
    """team_search: one ballot an entry a thread (entry i > 0 with c_i <=
    value), popc of the team's bits."""
    E, n = 16 // T, tables.shape[0] * T
    c = spread(tables, T)
    j = np.arange(n) % T
    v = np.repeat(value, T)
    count = np.zeros(n, np.int64)
    for e in range(E):
        flag = (c[:, e] <= v) & ((j * E + e > 0) | (not skip_zero))
        count += popc(ballot(flag) & team_mask(n, T))
    return count[::T]


def pick_mirror(tables, s, T):
    """team_pick: the holder's entry s % E, then a shuffle from team thread
    s / E."""
    E = 16 // T
    c = spread(tables, T)
    s = np.repeat(s, T)
    mine = c[np.arange(c.shape[0]), s % E]
    return shfl(mine, s // E, T)[::T]


def lookup_mirror(tables, sym, T):
    low = pick_mirror(tables, sym, T)
    nx = pick_mirror(tables, (sym + 1) & 15, T)
    return low, np.where(sym == 15, TOTAL, nx) - low


@pytest.mark.parametrize("T", TEAMS)
def test_search_mirror(T):
    """The ballot/popc search equals cdf16.search's symbol."""
    tables, value = _tables(64, T), _values(64, T)
    want = cdf16.search(torch.from_numpy(tables), torch.from_numpy(value))[0]
    assert np.array_equal(search_mirror(tables, value, T), want.numpy())
    # negative control: counting entry 0 (always <= value) is one too many
    assert np.array_equal(search_mirror(tables, value, T, skip_zero=False),
                          want.numpy() + 1)


@pytest.mark.parametrize("T", TEAMS)
def test_lookup_mirror(T):
    """The shuffle lookup equals cdf16.lookup for every symbol, 15 (whose
    freq ends at 2^15, past the last entry) included."""
    tables = _tables(64, T + 1)
    sym = np.arange(64) % 16
    low, freq = lookup_mirror(tables, sym, T)
    w_low, w_freq = cdf16.lookup(torch.from_numpy(tables),
                                 torch.from_numpy(sym))
    assert np.array_equal(low, w_low.numpy())
    assert np.array_equal(freq, w_freq.numpy())
    assert (freq[sym == 15] == TOTAL - tables[sym == 15, 15]).all()
    # negative control: the next entry shuffled from thread (s + 1) / E
    # without the 2^15 past 15 wraps to entry 0
    nx = pick_mirror(tables, (sym + 1) & 15, T)
    assert not np.array_equal(nx - low, w_freq.numpy())


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------

def update_mirror(tables, low, T, rate, by_index=None):
    """team_update: entry i of each thread, low broadcast to the team,
    c_i += (i IC - c_i + (c_i > low ? MIXD : 0)) >> rate; ``by_index``
    (the symbol) puts i > sym in place of c_i > low."""
    E, n = 16 // T, tables.shape[0] * T
    c = spread(tables, T).copy()
    j = np.arange(n) % T
    lo = np.repeat(low, T)
    for e in range(E):
        i = j * E + e
        up = (i > np.repeat(by_index, T)) if by_index is not None \
            else c[:, e] > lo
        c[:, e] += (i * cdf16.IC - c[:, e] + np.where(up, cdf16.MIXD, 0)) \
            >> rate
    return gather(c, T)


@pytest.mark.parametrize("T", TEAMS)
@pytest.mark.parametrize("rate", [7, 10])
def test_update_mirror(T, rate):
    """The entry-wise update with low broadcast equals cdf16.update_rate
    (whose repair and clamp are the identity here) on strictly increasing
    tables, for every symbol."""
    tables = _tables(64, T + rate)
    sym = np.arange(64) % 16
    low = tables[np.arange(64), sym]
    want = cdf16.update_rate(torch.from_numpy(tables),
                             torch.from_numpy(low), rate).numpy()
    assert np.array_equal(update_mirror(tables, low, T, rate), want)


@pytest.mark.parametrize("T", TEAMS)
def test_update_predicate_on_a_tie(T):
    """Negative control: on a table with a tie (c_{s+1} = c_s = low) the
    update on i > sym differs from the plain delta's c_i > low, which the
    kernel keeps."""
    tables = _tables(32, T + 3, ties=True)
    tie = np.argmax(np.diff(tables, axis=1) == 0, axis=1)  # c[t] = c[t+1]
    low = tables[np.arange(32), tie]
    want = (torch.from_numpy(tables) + cdf16.delta(
        torch.from_numpy(tables), torch.from_numpy(low), 7)).numpy()
    assert np.array_equal(update_mirror(tables, low, T, 7), want)
    assert not np.array_equal(update_mirror(tables, low, T, 7, by_index=tie),
                              want)


def test_tables_met_stay_strictly_increasing():
    """Every table the kernels meet is strictly increasing, so their
    update needs no repair and the predicate choice above never decides:
    warm tables of real data, updated by its bytes, re-joined across
    spans of 8 lanes every 4 bytes."""
    data = np.fromfile(Path(__file__).resolve().parents[1] / "turborc_tpu"
                       / "bench" / "_data" / "textbwt_16777216.bin",
                       np.uint8, count=1 << 14)
    hi_t, lo_t = S58.tables_on(*S58.segment_tables(data, 4), "cpu")
    L, share = 32, 8
    hi, lo = LK._span_tables(hi_t, lo_t, L, share)
    start_hi = hi
    cols = torch.from_numpy(data[:L * 256].reshape(256, L).astype(np.int64))
    for t in range(256):
        hi, lo, *_ = SM._code_byte(hi, lo, cols[t], 16, 7)
        if t % 4 == 3:
            hi = start_hi = SM._sync(hi, start_hi, share)
        for tab in (hi, lo.reshape(-1, 16)):
            assert (tab[:, 1:] > tab[:, :-1]).all() and (tab[:, 0] == 0).all()


# ---------------------------------------------------------------------------
# the re-join: repair scan and set sums
# ---------------------------------------------------------------------------

def repair_mirror(tables, T, steps=None):
    """team_repair: the thread's prefix max of c_i - i over its E entries,
    an inclusive max scan across the team by shuffles up (offsets 1, 2,
    ... < T, or the first ``steps`` of them), then for E > 1 the max of
    the threads before, entry by entry."""
    E, n = 16 // T, tables.shape[0] * T
    c = spread(tables, T)
    j = np.arange(n) % T
    p = np.maximum.accumulate(c - (j[:, None] * E + np.arange(E)), axis=1)
    m = p[:, -1].copy()
    k, done = 1, 0
    while k < T and (steps is None or done < steps):
        o = shfl_up(m, k, T)
        m = np.where(j >= k, np.maximum(m, o), m)
        k, done = k << 1, done + 1
    if E == 1:
        out = (m + j)[:, None]
    else:
        before = shfl_up(m, 1, T)
        out = np.where(j[:, None] > 0, np.maximum(before[:, None], p), p) \
            + j[:, None] * E + np.arange(E)
    return gather(out, T)


def increasing_mirror(tables, T):
    """team_increasing: every entry above the one before it, the thread's
    first against the shuffled last of the thread before."""
    E, n = 16 // T, tables.shape[0] * T
    c = spread(tables, T)
    j = np.arange(n) % T
    inc = (np.diff(c, axis=1) > 0).all(1) if E > 1 else np.ones(n, bool)
    before = shfl_up(c[:, -1], 1, T)
    return (inc & ((j == 0) | (c[:, 0] > before))).reshape(-1, T).all(1)


@pytest.mark.parametrize("T", TEAMS)
def test_repair_scan_mirror(T):
    """The shuffle scan equals cdf16._repair on tables that need it; one
    step short it does not; the increasing check is exact and the repair
    is the identity where it holds."""
    rng = np.random.default_rng(T)
    tables = rng.integers(-40000, 70000, (64, 16))
    tables[::4] = _tables(16, T + 9)
    want = cdf16._repair(torch.from_numpy(tables)).numpy()
    assert np.array_equal(repair_mirror(tables, T), want)
    short = repair_mirror(tables, T, steps=int(np.log2(T)) - 1)
    assert not np.array_equal(short, want)
    inc = increasing_mirror(tables, T)
    assert np.array_equal(inc, (np.diff(tables, axis=1) > 0).all(1))
    assert inc[::4].all()
    assert np.array_equal(want[inc], tables[inc])


def set_sum_mirror(x, share, T, cross_warp=True):
    """team_set_sum over a CTA of max(128, share T) threads (x [threads,
    E]): a butterfly over offsets T, 2T, ... below min(share T, 32), then
    for spans wider than a warp each warp's sums from its first team,
    summed over the span's warps."""
    n = x.shape[0]
    span = share * T
    k = T
    while k < min(span, 32):
        x = x + shfl_xor(x, k)
        k <<= 1
    if span > 32 and cross_warp:
        red = x.reshape(-1, 32, x.shape[1])[:, :T]  # each warp's first team
        per = span >> 5
        i = np.arange(n)
        first, j = (i >> 5) & ~(per - 1), i % T
        x = np.stack([red[f:f + per, jj].sum(0) for f, jj in zip(first, j)])
    return x


def _diverged(lanes, share, seed):
    """Span copies equal at the start, then each updated by 6 symbols of
    its own lane."""
    rng = np.random.default_rng(seed)
    start = np.repeat(_tables(lanes // share, seed), share, axis=0)
    cdf = torch.from_numpy(start)
    for _ in range(6):
        low, _ = cdf16.lookup(cdf, torch.from_numpy(rng.integers(0, 16,
                                                                 lanes)))
        cdf = cdf16.update_rate(cdf, low, 7)
    return cdf.numpy(), start


def rejoin_mirror(cdf, start, share, T, cross_warp=True):
    """team_rejoin_batch on one table: the set sum of the copies less
    (share - 1) starts, repaired, clamped."""
    threads = max(LK.LANE_CTA_MIN, share * T)
    lanes = threads // T
    out = []
    for c0 in range(0, cdf.shape[0], lanes):
        d = set_sum_mirror(spread(cdf[c0:c0 + lanes], T), share, T,
                           cross_warp)
        d = gather(d, T) + (1 - share) * start[c0:c0 + lanes]
        d = repair_mirror(d, T)
        out.append(np.minimum(d, TOTAL - 16 + np.arange(16)))
    return np.concatenate(out)


CASES = [(s, T) for s in (1, 2, 8, 64, 128) for T in TEAMS
         if s * T <= LK.LANE_MAX_THREADS]


@pytest.mark.parametrize("share,T", CASES)
def test_set_sum_mirror(share, T):
    """The team set sums equal each span's sum of its lanes' tables, at
    spans inside a warp and across warps (the dispatch's T at share 128
    is 8)."""
    threads = max(LK.LANE_CTA_MIN, share * T)
    lanes = threads // T
    x = np.random.default_rng(share + T).integers(-5000, 40000, (lanes, 16))
    want = np.repeat(x.reshape(-1, share, 16).sum(1), share, axis=0)
    got = gather(set_sum_mirror(spread(x, T), share, T), T)
    assert np.array_equal(got, want)
    if share * T > 32:  # negative control: no sums across warps
        assert not np.array_equal(
            gather(set_sum_mirror(spread(x, T), share, T, cross_warp=False),
                   T), want)


@pytest.mark.parametrize("share,T", [c for c in CASES if c[0] > 1])
def test_rejoin_mirror_equals_plain(share, T):
    """The team re-join of diverged span copies equals span.py's _sync
    (which the plain versions' re-join runs)."""
    lanes = max(LK.LANE_CTA_MIN, share * T) // T * 2
    cdf, start = _diverged(lanes, share, share * T)
    want = SM._sync(torch.from_numpy(cdf), torch.from_numpy(start),
                    share).numpy()
    assert np.array_equal(rejoin_mirror(cdf, start, share, T), want)


# ---------------------------------------------------------------------------
# words, input bytes and outputs spread over the team
# ---------------------------------------------------------------------------

class TeamWordsMirror:
    """TeamWords: word p of the lane (0 at or past n) in team thread p % T,
    cur the chunk of T words holding pos, nxt the next chunk (loaded when
    pos enters cur's chunk); the word at pos shuffled out of cur after
    each step."""

    def __init__(self, words, n, T):
        self.w, self.n, self.T = words, n, T
        self.cur, self.nxt = self.chunk(0), self.chunk(T)
        self.state = (self.cur[0] << 16) | self.cur[1]
        self.pos, self.next = 2, self.cur[2]

    def chunk(self, p0):
        return [int(self.w[p]) if p < self.n else 0
                for p in range(p0, p0 + self.T)]

    def renorm(self):
        take = self.state < 1 << 15
        if take:
            self.state = ((self.state << 16) | self.next) & 0xFFFFFFFF
            self.pos += 1
            if self.pos % self.T == 0:
                self.cur, self.nxt = self.nxt, self.chunk(self.pos + self.T)
        self.next = self.cur[self.pos % self.T]


@pytest.mark.parametrize("T", TEAMS)
def test_team_words_mirror(T):
    """The team's chunked reader hands out the lane's words in order, 0 at
    or past the readable count, as a reader of one word at a time."""
    rng = np.random.default_rng(T)
    for n in (0, 1, 2, 3, T - 1, T, T + 1, 3 * T + 5, 200):
        words = rng.integers(0, 1 << 16, 256)
        m = TeamWordsMirror(words, n, T)
        want = [int(words[p]) if p < n else 0 for p in range(256)]
        assert m.state == (want[0] << 16) | want[1]
        got = []
        for _ in range(250):
            before = m.pos
            m.state = int(rng.integers(0, 1 << 15))  # a renorm
            m.renorm()
            got.append(m.state & 0xFFFF)
            assert m.pos == before + 1
        assert got == want[2:252]


@pytest.mark.parametrize("T", TEAMS)
@pytest.mark.parametrize("K", [0, 1, 5, 16, 37, 64])
def test_chunked_inputs_and_outputs(T, K):
    """L1's input bytes (team thread j holds step t0 + j of chunk t0, the
    next chunk loaded a chunk ahead, byte t + 1 shuffled out during step
    t) reach every step in order; the outputs kept a step a thread and
    stored at a chunk's last step (or the last step) land once each."""
    rng = np.random.default_rng(K + T)
    col = rng.integers(0, 256, K)

    def load(t):
        return [int(col[t + j]) if t + j < K else 0 for j in range(T)]
    cur, nxt = load(0), load(T)
    sym_next = cur[0]
    seen, stored, mine = [], {}, [None] * T
    for t in range(K):
        sym = sym_next
        if t % T == T - 1:
            cur, nxt = nxt, load(t + 1 + T)
        sym_next = cur[(t + 1) % T]
        seen.append(sym)
        mine[t % T] = sym
        if t % T == T - 1 or t == K - 1:
            for j in range(T):
                tj = t - t % T + j
                if tj <= t:
                    assert tj not in stored
                    stored[tj] = mine[j]
    assert seen == list(col)
    assert [stored[t] for t in range(K)] == list(col) and len(stored) == K
