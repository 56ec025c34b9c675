"""The coder L2 and the static-CDF decoder L4
(``ops/csrc/rans_lane_kernel.cu``) on the CPU, without the card: numpy
mirrors of their designs, held against the plain versions
(``lane_coder_plain``, ``lane_static_decode_plain``), each with a negative
control that must fail.

- L2: the stage ring (which stage is requested into which buffer, what a
  barrier publishes, the chain's loads two blocks ahead, slots past S read
  as the identity step), the division by ``div_magic``'s reciprocal at
  every dividend edge of every freq, and the cooperative move and clear of
  a lane's words.
- L4: the value-indexed tables walked a run of values a thread against
  ``searchsorted``, and the byte step on the team word reader held three
  chunks deep, in chunks of T steps (T = 4, 8, 16), on sound and corrupt
  streams.

No JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops import rans_lane_kernel as LK

N = LK.CODER_LANES
D, RING, U, MOVE = (LK.CODER_SLOTS, LK.CODER_RING, LK.CODER_BLOCK,
                    LK.CODER_MOVE)
WORDS = LK.CODER_WORDS  # the word ring of a lane (kCoderWords)
IDENTITY = 1 << 15  # low 0, freq 2^15: kIdentity
TOTAL = 1 << 15
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# L2: the reciprocal
# ---------------------------------------------------------------------------

def recip_table() -> np.ndarray:
    """mtab: 2m - 2^32 (m << 1 in 32 bits) of div_magic's m of freq f, at
    f - 1, f = 1 .. 2^15."""
    m = TK.div_magic(np.arange(1, TOTAL + 1, dtype=np.int64))[0]
    assert (m >= 1 << 31).all() and (m < 1 << 32).all()
    return (m << 1) & M32


MTAB = recip_table()


def shift_of(p):
    """The step's shift: 32 - clz(freq - 1), freq = p's low 16 bits."""
    f = (np.asarray(p, np.int64) & 0xFFFF) - 1
    return np.where(f > 0, np.floor(np.log2(np.maximum(f, 1))).astype(
        np.int64) + 1, 0)


def div_step(x, p, index_off: int = 1, shift_off: int = 0,
             add: bool = True):
    """x // freq as the chain takes it: (umulhi(x, mtab[(p - index_off) &
    0x7FFF]) + x) >> shift, umulhi(2x, m) as one multiply-add
    (``index_off``, ``shift_off``, ``add``: negative controls)."""
    p = np.asarray(p, np.int64)
    x = np.asarray(x, np.int64)
    m = MTAB[(p - index_off) & (TOTAL - 1)]
    hi = (x.astype(np.uint64) * m.astype(np.uint64)) >> np.uint64(32)
    t = hi.astype(np.int64) + (x if add else 0)
    assert (t < 1 << 32).all()
    return t >> (shift_of(p) + shift_off)


def _edges(freq: np.ndarray) -> np.ndarray:
    """The dividends the chain can hand freq: 0, 1, freq - 1, freq,
    freq << 16 - 1 (the largest with no emit, below 2^31), 2^15 (the least
    state), 2^31 - 1 (the largest init, taken whole when freq = 2^15),
    32767 (2^31 - 1 after its emit shift) and the multiples of freq
    around the top."""
    top = np.minimum((freq << 16) - 1, (1 << 31) - 1)
    k = top // freq
    return np.stack([0 * freq, 0 * freq + 1, freq - 1, freq, top,
                     0 * freq + (1 << 15), 0 * freq + (1 << 31) - 1,
                     0 * freq + 32767, k * freq, k * freq - 1], axis=1)


def test_reciprocal_exact_at_every_freq_and_edge():
    """For every freq 1 .. 2^15 and every edge dividend below 2^31, with
    any low in p's high half, the table index (p - 1) mod 2^15 and the
    shift from p's freq give x // freq exactly."""
    freq = np.arange(1, TOTAL + 1, dtype=np.int64)
    x = _edges(freq)
    rng = np.random.default_rng(3)
    low = rng.integers(0, TOTAL - freq + 1)
    p = np.broadcast_to(((low << 16) | freq)[:, None], x.shape)
    f = freq[:, None]
    assert (x < 1 << 31).all()
    assert np.array_equal(div_step(x, p), x // f)


def test_reciprocal_negative_controls():
    """Indexing the table by p mod 2^15 (no - 1), shifting one bit less
    or leaving out the + x gives wrong quotients."""
    freq = np.arange(2, TOTAL + 1, dtype=np.int64)
    x = _edges(freq)
    p = np.broadcast_to(freq[:, None], x.shape)
    want = x // freq[:, None]
    assert not np.array_equal(div_step(x, p, index_off=0), want)
    assert not np.array_equal(div_step(x, p, shift_off=-1), want)
    assert not np.array_equal(div_step(x, p, add=False), want)


def test_identity_slot():
    """kIdentity (low 0, freq 2^15) leaves every state below 2^31 as it
    is and emits nothing: L2 reads it past S and for dummy lanes."""
    rng = np.random.default_rng(4)
    state = np.concatenate([rng.integers(1 << 15, 1 << 31, 4096),
                            [1 << 15, (1 << 31) - 1]])
    assert not (state >= IDENTITY << 16).any()
    q = div_step(state, np.full_like(state, IDENTITY))
    assert np.array_equal(state + 0 + q * (TOTAL - IDENTITY), state)


# ---------------------------------------------------------------------------
# L2: the stage ring, the chain and the move
# ---------------------------------------------------------------------------

class Ring:
    """The ring of RING stage buffers of one CTA, with what each holds:
    a read checks the buffer holds the slot's stage and that the stage
    was published; a request checks it overwrites no stage still to be
    read."""

    def __init__(self, probs, S, L, lane0, ring, publish):
        self.probs, self.S, self.L, self.lane0 = probs, S, L, lane0
        self.ring, self.publish = ring, publish
        self.buf = np.zeros((ring, D, N), np.int64)
        self.held = [None] * ring
        self.published = -1   # stages <= published are visible
        self.done = -1        # stages < done were coded

    def request(self, j):
        old = self.held[j % self.ring]
        assert old is None or old < self.done, \
            f"stage {j} overwrites stage {old} before it was coded"
        for i in range(D):
            s = self.S - 1 - (j * D + i)
            for n in range(N):
                lane = self.lane0 + n
                self.buf[j % self.ring, i, n] = (
                    int(self.probs[s, lane]) & M32
                    if s >= 0 and lane < self.L else IDENTITY)
        self.held[j % self.ring] = j

    def read(self, i):
        j = i // D
        assert j <= self.published, f"slot {i}: stage {j} not published"
        assert self.held[j % self.ring] == j, f"slot {i}: stage {j} gone"
        return self.buf[j % self.ring, i % D].copy()


def coder_mirror(probs: np.ndarray, init: np.ndarray, ring: int = RING,
                 publish: int = 2, ahead: int | None = None,
                 words: int = WORDS, kbufs: int = 3, move=None,
                 clear: bool = True):
    """lane_coder_kernel in numpy, a CTA of N lanes at a time (the chain
    vectorised over the CTA's lanes): stages 0 .. ahead - 1 requested
    first (``ahead`` = ring - 1); at stage j's barrier stages j .. j +
    publish - 1 are published and stage j + ahead requested; the chain
    codes the blocks of stage j from probs loaded two blocks ahead and
    reciprocals one block ahead, storing the state's low half at word k
    of a ring of ``words`` words every slot (k moves on at an emit), and
    publishes k in buffer j + 1 of ``kbufs`` before the next barrier; the
    helpers then (at the latest, after all of the chain's stage) write
    stage j - 1's words, from buffer j - 1's k to buffer j's, to the
    row's end.  Then the words are moved (``move``, coop_move by
    default) and cleared.  Returns (streams [L, S + 2], lengths [L])."""
    move = coop_move if move is None else move
    ahead = ring - 1 if ahead is None else ahead
    S, L = probs.shape
    M = S + 2
    streams = np.zeros((L, M), np.int64)  # the wrapper's zeroed rows
    lengths = np.zeros(L, np.int64)
    stages, blocks = -(-S // D), -(-S // U)
    for lane0 in range(0, L, N):
        rg = Ring(probs, S, L, lane0, ring, publish)
        real = lane0 + np.arange(N) < L
        state = np.where(real, np.resize(init.astype(np.int64) & M32,
                                         lane0 + N)[lane0:lane0 + N],
                         1 << 15)
        k = np.zeros(N, np.int64)
        wring = np.zeros((words, N), np.int64)
        kpub = np.zeros((kbufs, N), np.int64)  # buffer -1 holds 0

        def flush(lo, hi):
            for n in np.nonzero(real)[0]:
                for i in range(lo[n], hi[n]):
                    streams[lane0 + n, M - 1 - i] = wring[i % words, n]

        for j in range(min(ahead, stages)):
            rg.request(j)
        p = [None] * 3
        m = [None] * 2

        def load(b):
            return [rg.read(b * U + u) for u in range(U)]

        kpub[0] = k
        for j in range(stages):
            rg.published = j + publish - 1
            rg.done = j  # stages before j were coded
            if j + ahead < stages:
                rg.request(j + ahead)
            b0 = j * (D // U)
            if j == 0:
                p[0], p[1] = load(0), load(1)
                m[0] = p[0]
            for b in range(b0, min(b0 + D // U, blocks)):
                p[2] = load(b + 2) if b + 2 < blocks else None
                m[1] = p[1]
                for u in range(U):
                    pr = p[0][u]
                    freq = pr & 0xFFFF
                    e = state >= ((pr << 16) & M32)
                    wring[k % words, np.arange(N)] = state & 0xFFFF
                    k += e
                    x = np.where(e, state >> 16, state)
                    q = div_step(x, m[0][u])
                    state = (x + (pr >> 16) + q * (TOTAL - freq)) & M32
                p = [p[1], p[2], None]
                m = [m[1], None]
            kpub[(j + 1) % kbufs] = k  # before barrier j + 1
            flush(kpub[(j - 1) % kbufs], kpub[j % kbufs])
        flush(kpub[(stages - 1) % kbufs], kpub[stages % kbufs])
        for n in np.nonzero(real)[0]:
            row = streams[lane0 + n]
            row[0], row[1] = state[n] >> 16, state[n] & 0xFFFF
            lengths[lane0 + n] = k[n] + 2
            move(row, int(k[n]), clear)
    return streams, lengths


def coop_move(row: np.ndarray, k: int, clear: bool = True,
              order: str = "forward"):
    """The move of one lane by its warp: words M - k .. M - 1 to 2 .. k +
    1 in batches of MOVE chunks of 32, each batch read whole (every
    thread's loads, the warp barrier) before it is written, batches in
    order; then the words left past k + 1 cleared.  ``order="backward"``
    (negative control) takes the batches last first."""
    M = row.shape[0]
    batches = list(range(0, k, 32 * MOVE))
    if order == "backward":
        batches = batches[::-1]
    for i0 in batches:
        i = np.arange(i0, min(i0 + 32 * MOVE, k))
        v = row[M - k + i].copy()   # every load of the batch
        row[2 + i] = v              # then its stores
    if clear:
        row[max(k + 2, M - k):] = 0


def _probs(S, L, seed, mode="mixed"):
    """Probs [S, L] int32 (low << 16 | freq, low + freq <= 2^15) and init
    states [L]: "mixed" draws freq among the extremes (1, 2, 3, 32767,
    32768) and at random, "freq1" is 1 everywhere (a word nearly every
    slot: k > S/2, so the move overlaps itself), "freq32768" 2^15."""
    rng = np.random.default_rng(seed)
    if mode == "freq1":
        freq = np.ones((S, L), np.int64)
    elif mode == "freq32768":
        freq = np.full((S, L), TOTAL, np.int64)
    else:
        edge = np.array([1, 2, 3, 32767, 32768])
        freq = np.where(rng.random((S, L)) < 0.3,
                        edge[rng.integers(0, 5, (S, L))],
                        rng.integers(1, TOTAL, (S, L)))
    low = np.minimum((rng.random((S, L)) * (TOTAL - freq + 1)).astype(
        np.int64), TOTAL - freq)
    init = rng.integers(1 << 15, 1 << 31, L)
    init[::3] = (1 << 31) - 1
    init[1::3] = 1 << 15
    return ((low << 16) | freq).astype(np.int32), init.astype(np.int32)


def _plain(probs, init):
    st, ln = LK.lane_coder_plain(torch.from_numpy(probs),
                                 torch.from_numpy(init))
    return st.numpy(), ln.numpy()


@pytest.mark.parametrize("S,L,mode", [
    (0, 4, "mixed"),                  # S = 0: the flush state alone
    (1, 1, "mixed"),                  # a row under 16 B, one lane
    (37, 2, "mixed"),                 # S below a stage, not a block multiple
    (D + 1, 4, "mixed"),              # one slot into the second stage
    (3 * D, 64, "mixed"),             # two CTAs, whole stages
    (5 * D + 13, 32, "freq1"),        # k > S / 2: the move overlaps itself
    (2 * D + 3, 8, "freq32768"),      # every freq 2^15
])
def test_coder_mirror_equals_plain(S, L, mode):
    """The staged chain, the reciprocal and the cooperative move give
    lane_coder_plain's streams and lengths."""
    probs, init = _probs(S, L, S + L, mode)
    got = coder_mirror(probs, init)
    want = _plain(probs, init)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_coder_mirror_negative_controls():
    """Requests a stage further ahead (stage j + 4 at stage j's barrier)
    overwrite the stage being coded; publishing one stage at a barrier
    leaves the loads two blocks ahead reading an unpublished stage at a
    stage's end; a word ring of one stage's words lets the chain overwrite
    words the helpers have not written out; two buffers of published
    counts let the chain overwrite the count the helpers start from."""
    probs, init = _probs(5 * D, 8, 1, "freq1")
    want = _plain(probs, init)[0]
    assert np.array_equal(coder_mirror(probs, init)[0], want)
    with pytest.raises(AssertionError, match="before it was coded"):
        coder_mirror(probs, init, ahead=RING)
    with pytest.raises(AssertionError, match="not published"):
        coder_mirror(probs, init, publish=1)
    assert not np.array_equal(coder_mirror(probs, init, words=D)[0], want)
    assert not np.array_equal(coder_mirror(probs, init, kbufs=2)[0], want)


def _moved(S, k, seed, **kw):
    """A row whose k words sit at its end, moved; and the row
    lane_coder_plain's layout wants."""
    rng = np.random.default_rng(seed)
    M = S + 2
    row = np.zeros(M, np.int64)
    words = rng.integers(1, 1 << 16, k)
    row[M - k:] = words
    row[:2] = 7, 9
    coop_move(row, k, **kw)
    want = np.zeros(M, np.int64)
    want[:2] = 7, 9
    want[2:2 + k] = words
    return row, want


@pytest.mark.parametrize("S", [1, 40, 32 * MOVE + 5, 3 * 32 * MOVE])
def test_coop_move_and_clear(S):
    """Every count of words from none to S (all slots emit: the move is
    in place) lands at 2 .. k + 1 with zeros after, whether the batches
    overlap (k > S / 2) or not."""
    for k in sorted({0, 1, S // 2, S // 2 + 1, S - 1, S, 31, 32, 33,
                     32 * MOVE, 32 * MOVE + 1} & set(range(S + 1))):
        row, want = _moved(S, k, k)
        assert np.array_equal(row, want), k


def test_coop_move_negative_controls():
    """Batches taken last first overwrite words not yet moved once they
    overlap; leaving out the clear leaves moved words past the length."""
    S = 3 * 32 * MOVE
    row, want = _moved(S, S - 40, 1, order="backward")
    assert not np.array_equal(row, want)
    row, want = _moved(S, 100, 2, clear=False)
    assert not np.array_equal(row, want)


# ---------------------------------------------------------------------------
# L4: the value-indexed tables
# ---------------------------------------------------------------------------

WARPS = LK.STATIC_THREADS // 32
RUN = TOTAL // WARPS


def static_tables_mirror(cdf: np.ndarray, walk: bool = True):
    """static_tables: warp w's lane j takes values w RUN + j + 32 i, its
    first symbol by 8 halvings, then moves it up while cdf[sym + 1] <= v
    (``walk=False``: at most one move a value, a negative control).
    Returns (ent [2^15] u32, sym_of [2^15], every cdf index read)."""
    c = np.asarray(cdf, np.int64)
    ent = np.zeros(TOTAL, np.int64)
    sym_of = np.zeros(TOTAL, np.int64)
    read = set()
    for t in range(LK.STATIC_THREADS):
        v = (t // 32) * RUN + t % 32
        lo, hi = 0, 256
        for _ in range(8):
            mid = (lo + hi) >> 1
            read.add(mid)
            if c[mid] <= v:
                lo = mid
            else:
                hi = mid
        sym = lo
        nx = c[sym + 1]
        read.add(sym + 1)
        for _ in range(RUN // 32):
            moves = 0
            while sym < 255 and nx <= v and (walk or moves == 0):
                sym += 1
                moves += 1
                nx = c[sym + 1]
                read.add(sym + 1)
            low = c[sym]
            read.add(sym)
            ent[v] = (((nx - low) << 16) | (v - low)) & M32
            sym_of[v] = sym
            v += 32
    return ent, sym_of, read


def _cdf(freqs: np.ndarray) -> np.ndarray:
    c = np.zeros(257, np.int64)
    np.cumsum(freqs, out=c[1:])
    assert c[-1] == TOTAL
    return c


def _cdfs():
    rng = np.random.default_rng(11)
    out = {}
    f = rng.integers(0, 400, 256) * (rng.random(256) < 0.5)  # zero freqs
    f[rng.integers(0, 256)] += 1
    f = f * TOTAL // f.sum()
    f[np.argmax(f)] += TOTAL - f.sum()
    out["zero-frequency symbols"] = _cdf(f)
    for s in (0, 97, 255):
        f = np.zeros(256, np.int64)
        f[s] = TOTAL
        out[f"symbol {s} holds all"] = _cdf(f)
    out["uniform"] = _cdf(np.full(256, TOTAL // 256))
    f = np.zeros(256, np.int64)
    f[[3, 200]] = [1, TOTAL - 1]                # a freq-1 symbol
    out["freq 1 and 2^15 - 1"] = _cdf(f)
    return out


@pytest.mark.parametrize("name", list(_cdfs()))
def test_static_tables_equal_searchsorted(name):
    """For every value v: sym_of[v] = searchsorted(cdf, v, "right") - 1,
    and ent[v] holds that symbol's freq (high half) and v - low (low
    half)."""
    cdf = _cdfs()[name]
    v = np.arange(TOTAL)
    want = np.searchsorted(cdf, v, side="right") - 1
    ent, sym_of, _ = static_tables_mirror(cdf)
    assert np.array_equal(sym_of, want)
    assert np.array_equal(ent >> 16, cdf[want + 1] - cdf[want])
    assert np.array_equal(ent & 0xFFFF, v - cdf[want])


def test_static_tables_negative_control():
    """A symbol moved at most once a value lags behind wherever values
    skip over zero-frequency symbols."""
    cdf = _cdfs()["zero-frequency symbols"]
    want = np.searchsorted(cdf, np.arange(TOTAL), side="right") - 1
    assert not np.array_equal(static_tables_mirror(cdf, walk=False)[1],
                              want)


def test_static_tables_stay_inside_on_any_cdf():
    """For any [257] int32 the wrapper accepts (not a CDF at all), every
    symbol stays in [0, 255] and every read of cdf in [0, 256]."""
    rng = np.random.default_rng(12)
    for _ in range(3):
        g = rng.integers(-2**31, 2**31, 257)
        _, sym_of, read = static_tables_mirror(g)
        assert sym_of.min() >= 0 and sym_of.max() <= 255
        assert min(read) >= 0 and max(read) <= 256


# ---------------------------------------------------------------------------
# L4: the byte step on the team word reader
# ---------------------------------------------------------------------------

class StaticReader:
    """StaticWords over one lane: word p (0 at or past n) in team thread p
    % T; cur, nxt and far the chunks c, c + 1, c + 2 (far requested at a
    chunk of steps' end); after each step the word at pos is shuffled out
    of cur (pos < edge = (c + 1) T) or nxt; at a chunk's end the chunks
    move along where pos passed edge.  Negative controls: ``stale``
    shuffles the next word only at a chunk's end, ``still`` never moves
    the chunks along."""

    def __init__(self, words, n, T, stale=False, still=False):
        self.w, self.n, self.T = words, n, T
        self.stale, self.still = stale, still
        self.cur, self.nxt, self.far = (self.chunk(0), self.chunk(T),
                                        self.chunk(2 * T))
        self.state = (self.cur[0] << 16) | self.cur[1]
        self.pos, self.edge = 2, T
        self.next = self.cur[2]

    def chunk(self, p0):
        return [int(self.w[p]) if p < self.n else 0
                for p in range(p0, p0 + self.T)]

    def shuffle(self):
        src = self.cur if self.pos < self.edge else self.nxt
        self.next = src[self.pos % self.T]

    def step(self):
        take = self.state < 1 << 15
        if take:
            self.state = ((self.state << 16) | self.next) & M32
            self.pos += 1
        if not self.stale:
            self.shuffle()

    def chunk_end(self):
        assert self.pos < self.edge + self.T  # inside cur and nxt
        if self.pos >= self.edge and not self.still:
            self.cur, self.nxt = self.nxt, self.far
            self.edge += self.T
        self.far = self.chunk(self.edge + self.T)
        if self.stale:
            self.shuffle()


def static_decode_mirror(words, lengths, K, cdf, T, **kw):
    """lane_static_decode_kernel lane by lane: value v = state mod 2^15,
    state' = (ent[v] >> 16) (state >> 15) + (ent[v] & 0xFFFF), the
    reader's renorm; chunks of T steps, team thread j keeping the byte of
    step j and the team storing the chunk at its end; then the last K % T
    steps, stored the same way."""
    ent, sym_of, _ = static_tables_mirror(cdf)
    W, L = words.shape[0], lengths.shape[0]
    w16 = words.astype(np.int64) & 0xFFFF
    off = np.cumsum(lengths.astype(np.int64)) - lengths
    out = np.full((K, L), 0xEE, np.uint8)
    full = K - K % T
    for lane in range(L):
        o = int(off[lane])
        n = (min(int(lengths[lane]), 2 * K + 2, W - o)
             if 0 <= o < W else 0)
        r = StaticReader(w16[o:] if n > 0 else w16[:0], max(n, 0), T, **kw)
        for t0 in range(0, K, T):
            mine = [0] * T
            for u in range(min(T, K - t0)):
                v = r.state & (TOTAL - 1)
                e = int(ent[v])
                r.state = ((e >> 16) * (r.state >> 15) + (e & 0xFFFF)) & M32
                r.step()
                mine[u] = int(sym_of[v])
            if t0 < full:
                r.chunk_end()
            for j in range(T):
                if t0 + j < K:
                    out[t0 + j, lane] = mine[j]
    return out


def _static_streams(K, L, cdf, seed):
    rng = np.random.default_rng(seed)
    f = np.diff(cdf)
    sym = rng.choice(256, size=(K, L), p=f / f.sum())
    c = torch.from_numpy(cdf)
    probs = ((c[sym] << 16) | (c[sym + 1] - c[sym])).to(torch.int32)
    st, ln = LK.lane_coder_plain(probs, torch.full((L,), 1 << 15,
                                                   dtype=torch.int32))
    return blockio.device_words(st, ln), ln, sym


def _corrupt(words, lengths, K):
    rng = np.random.default_rng(13)
    bad = words.clone()
    bad[::9] ^= torch.from_numpy(rng.integers(1, 1 << 15, bad[::9].shape)
                                 .astype(np.int16))
    cut, long = lengths.clone(), lengths.clone()
    cut[::3] = 2
    long[0] = 2 * K + 40   # past 2K + 2
    long[-1] = 5000        # past the words
    return {"flipped words": (bad, lengths), "lengths cut": (words, cut),
            "lengths past 2K + 2 and the words": (words, long)}


@pytest.mark.parametrize("T", [4, 8, 16])
@pytest.mark.parametrize("cdf_name", ["zero-frequency symbols",
                                      "symbol 97 holds all"])
def test_static_step_on_team_reader(T, cdf_name):
    """The byte step on the team reader, in chunks of T steps and the last
    K % T, equals lane_static_decode_plain on sound streams (which it
    decodes) and on corrupt ones."""
    K, L = 37, 4
    cdf = _cdfs()[cdf_name]
    words, lengths, sym = _static_streams(K, L, cdf, T)
    c32 = torch.from_numpy(cdf.astype(np.int32))
    got = static_decode_mirror(words.numpy(), lengths.numpy(), K, cdf, T)
    want = LK.lane_static_decode_plain(words, lengths, K, c32).numpy()
    assert np.array_equal(want, sym) and np.array_equal(got, want)
    for what, (w, ln) in _corrupt(words, lengths, K).items():
        got = static_decode_mirror(w.numpy(), ln.numpy(), K, cdf, T)
        want = LK.lane_static_decode_plain(w, ln, K, c32).numpy()
        assert np.array_equal(got, want), what


def test_static_step_negative_control():
    """A reader that shuffles out the next word only at a chunk's end
    renormalises with stale words, and one that never moves its chunks
    along runs out of them: the bytes differ, and the second leaves cur
    and nxt."""
    K, L, T = 37, 4, 8
    cdf = _cdfs()["zero-frequency symbols"]
    words, lengths, sym = _static_streams(K, L, cdf, 5)
    got = static_decode_mirror(words.numpy(), lengths.numpy(), K, cdf, T,
                               stale=True)
    assert not np.array_equal(got, sym)
    K = 160
    words, lengths, sym = _static_streams(K, L, cdf, 6)
    with pytest.raises(AssertionError):
        static_decode_mirror(words.numpy(), lengths.numpy(), K, cdf, T,
                             still=True)
