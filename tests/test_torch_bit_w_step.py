"""The steps of L11 and L12 at W bits and at order 2
(``ops/csrc/rans_bit_kernel.cu``) as numpy mirrors, thread by thread on
the kernels' layouts, held exactly against the plain versions.  No JAX.

- L11 at W bits (``model_w_mirror``): a warp of N lanes x W depths, N = 4
  for u8 elements and 2 for u16 (a u32 holds a step's elements of the
  CTA's lanes, read a chunk of 32 steps ahead and shuffled out), the
  threads past N W idle, the guarded path wherever N W < 32; a slot read
  A steps ahead and forwarded (A = 2 in shared memory up to W = 12, 8 in
  the table above); order 2's slot (ctx << 8) | node with ctx (previous
  << 8) | the one before;
- L12 at W bits, W not 8 or 16 (``decode_w_mirror``): the row of 2^W
  slots, each update stored at its decision, a decision's grandchildren
  read a decision ahead, the next element's head read after decision
  min(2, W - 1); the ring filled up to (W + 7) / 8 units an element with
  the fewer groups in flight (``StreamW`` checks no word a step reads is
  in flight);
- L12's row path (``rows_mirror``) at order 2 (a row by the two previous
  bytes, its head in its body's slots 248-255) and at W = 16 (two byte
  steps an element: the hi byte on the top row, the lo byte on row hi);
  the W = 16 row map is a bijection onto 257 rows of 255 nodes.

Negative controls: elements packed at the wrong width; the byte tree's
stores two decisions later at W = 2; the head read before the root's
store; order 1's context at order 2; the lo byte's row keyed by the
previous byte at W = 16.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_bit_step import (AHEAD, PAIR, PAIR_AT, RING_AHEAD, Pred,
                                 Stream, _cols)
from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.models import bitpred
from turborc_tpu_torch.ops import build, rans
from turborc_tpu_torch.ops import rans_bit_kernel as BK
from turborc_tpu_torch.ops import rans_lane_kernel as LK

SRC = (Path(build.__file__).resolve().parent / "csrc" /
       "rans_bit_kernel.cu").read_text()
MAX_SHARED_W = 12  # kMaxSharedW
HEAD_AT = 248      # kHeadAt: order 2's head in its row's body
TOP = 256          # kTopRow: W = 16's hi-byte row
S = Pred("s")
ST = bitpred.Simple()


def test_constants_and_lines_match_source():
    for name, want in (("kMaxSharedW", MAX_SHARED_W), ("kHeadAt", HEAD_AT),
                       ("kTopRow", TOP)):
        m = re.search(rf"constexpr int {name} = (\d+);", SRC)
        assert m and int(m.group(1)) == want, name
    assert "constexpr int kCtx2Slots = 1 << 24;" in SRC
    assert (BK.BIT_MAX_SHARED_W, BK.BIT_TOP_ROW, BK.BIT_CTX2_SLOTS) == (
        MAX_SHARED_W, TOP, 1 << 24)
    # the pair regions end where order 2's head starts
    assert PAIR_AT + 8 * PAIR == HEAD_AT and HEAD_AT + 8 <= 256
    for line in ("constexpr int kN = 4 / int(sizeof(Elem<kW>));",
                 "const bool full = lanes && kN * kW == 32;",
                 "int(__shfl_sync(kFull, src, lane) >> (kEB * n)) & ((1 << kW)"
                 " - 1);",
                 "slot = (kOrder ? prev << 8 : 0) | (((1 << kW) | b) >> shift);",
                 "prev = kOrder == 2 ? (b << 8) | (prev >> 8) : b;",
                 "constexpr int kF = (kW + 7) / 8;",
                 "constexpr int kWait = (kRingAhead - kW - 2) / (8 * kF);",
                 "constexpr int kHeadRead = kW > 3 ? 2 : kW - 1;",
                 "row[node] = pr.dnext2(pr.dnext1(v, p, b));",
                 "if (d + 3 < kW) gc = ld4(row + 4 * node);",
                 "uint32_t* hrow = kOrder == 2 ? brow + kHeadAt : head + ctx * "
                 "kHeadSlots;",
                 "ctx = kOrder == 2 ? (byte << 8) | (ctx >> 8) : byte;",
                 "ctx = t & 1 ? kTopRow : byte;",
                 "if (t & 1) dst[size_t(t >> 1) * L] = Elem<kW>(hi << 8 | "
                 "byte);"):
        assert line in SRC, line


# ---------------------------------------------------------------------------
# inputs and streams
# ---------------------------------------------------------------------------

def _elems(what: str, W: int, K: int, L: int, seed: int) -> np.ndarray:
    """[K, L] elements as the kernels take them: uint8 up to W = 8, else
    int16 holding u16.  "mixed": lane 0 all 0, lane 1 all 2^W - 1, lane 2
    cycling, the rest random; "run": one value a lane; "hi alternate"
    (W = 16): the hi byte alternating between two values."""
    rng = np.random.default_rng(seed)
    top = 1 << W
    if what == "run":
        v = np.broadcast_to(rng.integers(0, top, L), (K, L))
    elif what == "hi alternate":
        v = (0x9A + 0x17 * (np.arange(K)[:, None] % 2)) << 8 | rng.integers(
            0, 256, (K, L))
    else:
        v = rng.integers(0, top, (K, L))
        v[:, 0] = 0
        v[:, 1 % L] = top - 1
        v[:, 2 % L] = np.arange(K) % top
    v = np.ascontiguousarray(v).astype(np.uint8 if W <= 8 else np.uint16)
    return v if W <= 8 else v.view(np.int16)


def _model(cols: np.ndarray, order: int, W: int) -> torch.Tensor:
    """The plain model (any number of lanes: a CTA's lanes partly real)."""
    c = torch.from_numpy(cols)
    return (BK.lane_bit_model_plain(c, order, ST) if W == 8
            else BK.lane_bitw_model_plain(c, W, ST))


def _streams(cols: np.ndarray, order: int, W: int):
    """The lanes' streams of ``cols`` (plain model and coder): (words,
    lengths) as numpy."""
    init = torch.full((cols.shape[1],), rans.ANS_LOW, dtype=torch.int32)
    st, ln = LK.lane_coder_plain(_model(cols, order, W), init)
    return blockio.device_words(st, ln).numpy(), ln.numpy().astype(np.int64)


def _corrupt(words: np.ndarray, lens: np.ndarray, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    flipped = words.copy()
    flipped[rng.integers(0, words.size, 6)] ^= 0x5A5A
    short = lens.copy()
    short[0] = 1
    past = lens.copy()  # the lanes after the first start past the words
    past[0] += words.size
    return {"sound": (words, lens), "flipped words": (flipped, lens),
            "a length cut": (words, short), "lanes past the words":
            (words, past)}


def _plain_decode(words, lens, K: int, order: int, W: int) -> np.ndarray:
    w = torch.from_numpy(words.astype(np.int16))
    n = torch.from_numpy(lens.astype(np.int32))
    return (BK.lane_bit_decode_plain(w, n, K, order, ST) if W == 8
            else BK.lane_bitw_decode_plain(w, n, K, W, ST)).numpy()


# ---------------------------------------------------------------------------
# L11 at W bits and order 2
# ---------------------------------------------------------------------------

def model_w_mirror(cols: np.ndarray, W: int, order: int, pred: Pred,
                   elem_bytes: int | None = None) -> np.ndarray:
    """L11, thread by thread: probs [W K, L] int64.  ``elem_bytes``
    replaces the bytes an element takes in a step's u32 (a negative
    control)."""
    E = elem_bytes or (1 if W <= 8 else 2)
    N = 4 // (1 if W <= 8 else 2)  # lanes a CTA
    kA = AHEAD[1] if order or W > MAX_SHARED_W else AHEAD[0]
    K, L = cols.shape
    vals = cols.astype(np.int64) & 0xFFFF
    probs = np.zeros((W * K, L), np.int64)

    def chunk(l0: int, c: int) -> list:
        """Lane i of the warp: step c + i's elements of lanes l0.. (0 past
        K), lane k's in bits 8 E k.."""
        w = []
        for i in range(32):
            t, x = c + i, 0
            if t < K:
                for k in range(N):
                    if l0 + k < L:
                        x |= int(vals[t, l0 + k]) << (8 * E * k)
            w.append(x & 0xFFFFFFFF)
        return w

    for l0 in range(0, L, N):
        full = l0 + N <= L and N * W == 32
        for n in range(min(N, L - l0)):
            for d in range(W):
                tab = {}
                g = dict(cur=chunk(l0, 0), nxt=chunk(l0, 32), prev=0)

                def plan(src, lane):
                    b = (g[src][lane] >> (8 * E * n)) & ((1 << W) - 1)
                    slot = (g["prev"] << 8 if order else 0) | (
                        ((1 << W) | b) >> (W - d))
                    g["prev"] = ((b << 8) | (g["prev"] >> 8) if order == 2
                                 else b)
                    return slot, (b >> (W - 1 - d)) & 1

                sl, bt, rv = [0] * kA, [0] * kA, [0] * kA
                fs, fv = [-1] * kA, [0] * kA
                for j in range(kA):
                    sl[j], bt[j] = plan("cur", j)
                    rv[j] = tab.get(sl[j], pred.init())
                for c0 in range(0, K, 32):
                    nn = chunk(l0, c0 + 64)
                    guard = not (full and c0 + 32 <= K)
                    for h in (0, 16):
                        for j in range(16):
                            t, r = c0 + h + j, j % kA
                            v = rv[r]
                            for k in range(kA - 1, 0, -1):
                                i = (r - k) % kA
                                if sl[r] == fs[i]:
                                    v = fv[i]
                            p = pred.prob(v)
                            bit = bt[r]
                            nv = pred.next(v, p, bit)
                            if not guard or t < K:
                                probs[W * t + d, l0 + n] = (
                                    p if bit else (p << 16) | (32768 - p))
                                tab[sl[r]] = nv
                            fs[r], fv[r] = sl[r], nv
                            u = h + j + kA
                            sl[r], bt[r] = plan("cur" if u < 32 else "nxt",
                                                u & 31)
                            rv[r] = tab.get(sl[r], pred.init())
                    g["cur"], g["nxt"] = g["nxt"], nn
    return probs


MODEL_W_CASES = [("mixed", 33, 5), ("run", 40, 4), ("mixed", 1, 3)]


@pytest.mark.parametrize("W", BK.WIDTHS)
def test_model_w_equals_plain(W):
    """L11's warp of N lanes x W depths gives the plain model's probs at
    every W: u8 and u16 elements, the idle threads, the guarded path,
    slots in shared memory and in the table."""
    for what, K, L in MODEL_W_CASES:
        cols = _elems(what, W, K, L, W + K)
        want = _model(cols, 0, W).numpy().astype(np.int64)
        assert np.array_equal(model_w_mirror(cols, W, 0, S), want), what


def test_model_w16_full_warp_and_hi_alternate():
    """W = 16 on full CTAs (2 lanes x 16 depths, the unguarded path, K a
    multiple of 32) and hi bytes in turn."""
    cols = _elems("hi alternate", 16, 64, 4, 3)
    want = _model(cols, 0, 16).numpy().astype(np.int64)
    assert np.array_equal(model_w_mirror(cols, 16, 0, S), want)


@pytest.mark.parametrize("what,K,L", [("run", 40, 4), ("every byte", 33, 3),
                                      ("textbwt", 64, 4)])
def test_model_order2_equals_plain(what, K, L):
    cols = _cols(what, K, L, K + L)
    want = _model(cols, 2, 8).numpy().astype(np.int64)
    assert np.array_equal(model_w_mirror(cols, 8, 2, S), want)


def test_model_w_wrong_packing_fails():
    """Negative control: u16 elements read as bytes from the step's u32
    (the u8 packing) are not the plain probs."""
    cols = _elems("mixed", 10, 24, 4, 1)
    want = _model(cols, 0, 10).numpy().astype(np.int64)
    assert not np.array_equal(model_w_mirror(cols, 10, 0, S, elem_bytes=1),
                              want)


# ---------------------------------------------------------------------------
# L12 at W bits (decode_w)
# ---------------------------------------------------------------------------

class StreamW(Stream):
    """``Stream`` with decode_w's fill: up to (W + 7) / 8 units an
    element, and at most (RING_AHEAD - W - 2) / (8 (W + 7) / 8) of the
    latest groups (one a step) in flight, none of them holding a word
    the step reads (up to pos + W + 1)."""

    def __init__(self, words, o: int, nw: int, W: int):
        super().__init__(words, o, nw)
        self.W, self.kF = W, (W + 7) // 8
        self.wait = (RING_AHEAD - W - 2) // (8 * self.kF)
        self.groups = []

    def step(self):
        group = []
        for _ in range(self.kF):
            if 8 * self.fu < self.o + self.pos + RING_AHEAD:
                group.append(self.fu)
                self.fetch()
        self.groups.append(group)
        flight = [u for g in self.groups[-self.wait:] for u in g]
        assert not flight or 8 * min(flight) >= self.o + self.pos + self.W + 2


def decode_w_mirror(st: StreamW, K: int, W: int, pred: Pred,
                    delayed: bool = False, head_early: bool = False) -> list:
    """L12 at W bits, one lane: the row of max(2^W, 8) slots; each update
    stored at its decision (``delayed``: two decisions later, the byte
    tree's pipeline, a negative control); the next head read after
    decision min(2, W - 1)'s store (``head_early``: at decision 0 before
    its store, a negative control)."""
    row = [pred.dinit()] * max(1 << W, 8)
    h = row[0:8]
    F = U = (0, 0)
    head_at = 0 if head_early else min(2, W - 1)
    out = []
    for _ in range(K):
        st.step()
        node, v, c0, c1 = 1, h[1], h[2], h[3]
        p, gc = pred.dprob(v), h[4:8]
        for d in range(W):
            b = st.bit(p)
            if head_early and d == head_at:
                h = row[0:8]
            if delayed:
                row[F[0]] = F[1]
                F = (U[0], pred.dnext2(U[1]))
                U = (node, pred.dnext1(v, p, b))
            else:
                row[node] = pred.dnext2(pred.dnext1(v, p, b))
            node = 2 * node + b
            if d + 1 < W:
                v = c1 if b else c0
                p = pred.dprob(v)
            if d + 2 < W:
                c0, c1 = (gc[2], gc[3]) if b else (gc[0], gc[1])
            if d + 3 < W:
                gc = row[4 * node:4 * node + 4]
            if not head_early and d == head_at:
                h = row[0:8]
        out.append(node & ((1 << W) - 1))
    return out


def _lanes(words: np.ndarray, lens: np.ndarray, K: int, W: int,
           rows: bool = False):
    """(lane, stream) of each lane, as the kernel bounds its words: a
    ``StreamW`` for decode_w, a ``Stream`` (a unit a byte step) for the
    row path (``rows``)."""
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    for l in range(lens.size):
        o = int(off[l])
        nw = (max(0, min(int(lens[l]), W * K + 2, words.size - o))
              if 0 <= o < words.size else 0)
        w = words.astype(np.int64)
        yield l, Stream(w, o, nw) if rows else StreamW(w, o, nw, W)


def _as_elems(out: np.ndarray, W: int) -> np.ndarray:
    out = out.astype(np.uint8 if W <= 8 else np.uint16)
    return out if W <= 8 else out.view(np.int16)


def decode_w(words, lens, K: int, W: int, **kw) -> np.ndarray:
    out = np.zeros((K, lens.size), np.int64)
    for l, st in _lanes(words, lens, K, W):
        out[:, l] = decode_w_mirror(st, K, W, S, **kw)
    return _as_elems(out, W)


@pytest.mark.parametrize("W", [w for w in BK.WIDTHS if w not in (8, 16)])
def test_decode_w_equals_plain(W):
    """decode_w's step decodes the plain decode's elements at every W,
    the row in shared memory up to W = 12 and in the table above, on sound
    and corrupt streams."""
    K, L = 24, 4
    cols = _elems("mixed", W, K, L, 50 + W)
    words, lens = _streams(cols, 0, W)
    for bad, (w, n) in _corrupt(words, lens, W).items():
        want = _plain_decode(w, n, K, 0, W)
        if bad == "sound":
            assert np.array_equal(want, cols)
        assert np.array_equal(decode_w(w, n, K, W), want), bad


def test_decode_w_runs_and_one_step():
    for W, what, K, L in ((2, "run", 64, 2), (3, "run", 40, 2),
                          (13, "run", 20, 2), (5, "mixed", 1, 3)):
        cols = _elems(what, W, K, L, W)
        words, lens = _streams(cols, 0, W)
        assert np.array_equal(decode_w(words, lens, K, W), cols), (W, what)


@pytest.mark.parametrize("W,kw", [(2, dict(delayed=True)),
                                  (5, dict(head_early=True))],
                         ids=["stores two decisions later",
                              "head read before the root's store"])
def test_decode_w_reads_before_stores_fail(W, kw):
    """Negative controls, on runs (a slot read again an element later): the
    byte tree's pipeline of stores two decisions later leaves the next
    element's root and children stale at W = 2; the head read before the
    root's update misses it."""
    cols = _elems("run", W, 48, 2, 9)
    words, lens = _streams(cols, 0, W)
    assert np.array_equal(decode_w(words, lens, 48, W), cols)
    assert not np.array_equal(decode_w(words, lens, 48, W, **kw), cols)


# ---------------------------------------------------------------------------
# L12's row path at order 2 and at W = 16
# ---------------------------------------------------------------------------

def rows_mirror(st: Stream, steps: int, pred: Pred, mode: str,
                early: bool = False) -> list:
    """L12's row path, one lane: order 1's reads and deferred stores (a
    row's head, line A when the step starts, the pair region of its
    depth-3 node when decision 2 is known, each update stored two
    decisions later).  ``mode`` "o2": a step's row is (previous << 8) |
    the one before, its head at body slots HEAD_AT..; "o2 as o1" (a
    negative control): the row is the previous byte; "w16": two steps an
    element, the top row for the hi byte, then row hi; "w16 as o1" (a
    negative control): every row the previous byte.  ``early`` reads the
    pair region when the step starts (a negative control)."""
    d0 = pred.dinit()
    mem = {}

    def head(r, k):
        return ("b", r, HEAD_AT + k) if mode.startswith("o2") else ("h", r, k)

    def bod(r, i):
        return ("b", r, i)

    def get(key):
        return mem.get(key, d0)

    def store(f):
        mem[f[0]] = f[1]

    def fin(u):
        return u[0], pred.dnext2(u[1])

    f6 = u7 = (head(0, 0), 0)
    ctx = TOP if mode == "w16" else 0
    hi, out = 0, []
    for t in range(steps):
        st.step()
        r = ctx
        h = [get(head(r, k)) for k in range(8)]
        A = [get(bod(r, i)) for i in range(PAIR_AT)]
        pre = [get(bod(r, PAIR_AT + i)) for i in range(8 * PAIR)]
        # d0
        v, k0, k1 = h[1], h[2], h[3]
        p = pred.dprob(v)
        b0 = st.bit(p)
        f7 = fin(u7)
        store(f6)
        u0 = (head(r, 1), pred.dnext1(v, p, b0))
        v = k1 if b0 else k0
        p = pred.dprob(v)
        # d1
        k0, k1 = (h[6], h[7]) if b0 else (h[4], h[5])
        b1 = st.bit(p)
        store(f7)
        f0 = fin(u0)
        u1 = (head(r, 2 + b0), pred.dnext1(v, p, b1))
        v = k1 if b1 else k0
        p = pred.dprob(v)
        # d2
        b2 = st.bit(p)
        store(f0)
        f1 = fin(u1)
        u2 = (head(r, 4 + 2 * b0 + b1), pred.dnext1(v, p, b2))
        j3 = 4 * b0 + 2 * b1 + b2
        at = PAIR_AT + PAIR * j3
        Q = (pre[PAIR * j3:PAIR * j3 + PAIR] if early
             else [get(bod(r, at + i)) for i in range(PAIR)])
        v, k0, k1 = A[j3], A[8 + 2 * j3], A[9 + 2 * j3]
        p = pred.dprob(v)
        # d3
        b3 = st.bit(p)
        store(f1)
        f2 = fin(u2)
        u3 = (bod(r, j3), pred.dnext1(v, p, b3))
        v = k1 if b3 else k0
        p = pred.dprob(v)
        H = [Q[14 + i] if b3 else Q[i] for i in range(14)]
        k0, k1 = H[0], H[1]
        # d4
        b4 = st.bit(p)
        store(f2)
        f3 = fin(u3)
        u4 = (bod(r, 8 + 2 * j3 + b3), pred.dnext1(v, p, b4))
        v = k1 if b4 else k0
        p = pred.dprob(v)
        half = at + 14 * b3
        k0, k1 = H[2 + 2 * b4], H[3 + 2 * b4]
        D = [H[10 + i] if b4 else H[6 + i] for i in range(4)]
        # d5
        b5 = st.bit(p)
        store(f3)
        f4 = fin(u4)
        u5 = (bod(r, half + b4), pred.dnext1(v, p, b5))
        v = k1 if b5 else k0
        p = pred.dprob(v)
        k0, k1 = (D[2], D[3]) if b5 else (D[0], D[1])
        # d6
        b6 = st.bit(p)
        store(f4)
        f5 = fin(u5)
        u6 = (bod(r, half + 2 + 2 * b4 + b5), pred.dnext1(v, p, b6))
        v = k1 if b6 else k0
        p = pred.dprob(v)
        # d7
        b7 = st.bit(p)
        store(f5)
        f6 = fin(u6)
        u7 = (bod(r, half + 6 + 4 * b4 + 2 * b5 + b6), pred.dnext1(v, p, b7))
        byte = (b0 << 7 | b1 << 6 | b2 << 5 | b3 << 4 | b4 << 3 | b5 << 2
                | b6 << 1 | b7)
        if mode == "w16":
            if t & 1:
                out.append(hi << 8 | byte)
            hi = byte
            ctx = TOP if t & 1 else byte
        elif mode == "w16 as o1":
            if t & 1:
                out.append(hi << 8 | byte)
            hi = ctx = byte
        else:
            out.append(byte)
            ctx = (byte << 8) | (ctx >> 8) if mode == "o2" else byte
    return out


def decode_rows(words, lens, K: int, W: int, mode: str,
                **kw) -> np.ndarray:
    out = np.zeros((K, lens.size), np.int64)
    steps = 2 * K if W == 16 else K
    for l, st in _lanes(words, lens, K, W, rows=True):
        out[:, l] = rows_mirror(st, steps, S, mode, **kw)
    return _as_elems(out, W)


@pytest.mark.parametrize("what,K,L", [("run", 40, 2), ("every byte", 33, 2),
                                      ("alternate", 24, 2),
                                      ("textbwt", 48, 4)])
def test_decode_order2_equals_plain(what, K, L):
    """Order 2's rows (heads in the table) decode the plain decode's bytes,
    on sound streams and, for textbwt, corrupt ones."""
    cols = _cols(what, K, L, 3 * K + L)
    words, lens = _streams(cols, 2, 8)
    cases = (_corrupt(words, lens, K) if what == "textbwt"
             else {"sound": (words, lens)})
    for bad, (w, n) in cases.items():
        want = _plain_decode(w, n, K, 2, 8)
        if bad == "sound":
            assert np.array_equal(want, cols)
        assert np.array_equal(decode_rows(w, n, K, 8, "o2"), want), bad


@pytest.mark.parametrize("what", ["mixed", "hi alternate", "run"])
def test_decode_w16_rows_equal_plain(what):
    """W = 16 on order 1's rows (the top row, then row hi) decodes the
    plain decode's u16 elements, sound and corrupt."""
    K, L = 20, 4
    cols = _elems(what, 16, K, L, 7)
    words, lens = _streams(cols, 0, 16)
    cases = (_corrupt(words, lens, 3) if what == "mixed"
             else {"sound": (words, lens)})
    for bad, (w, n) in cases.items():
        want = _plain_decode(w, n, K, 0, 16)
        if bad == "sound":
            assert np.array_equal(want, cols)
        assert np.array_equal(decode_rows(w, n, K, 16, "w16"), want), bad


def test_w16_row_map_is_a_bijection():
    """Node (1 << (8 + j)) | (hi << j) | (lo >> (8 - j)) of the 16-bit tree
    is row hi's byte node (256 | lo) >> (8 - j), node (1 << j) | (hi >>
    (8 - j)) the top row's (256 | hi) >> (8 - j): the 65,535 nodes map one
    to one onto 257 rows of byte nodes 1-255."""
    seen = {}
    for v in range(1 << 16):
        hi, lo = v >> 8, v & 255
        for j in range(16):
            node = ((1 << 16) | v) >> (16 - j)
            key = ((TOP, (256 | hi) >> (8 - j)) if j < 8
                   else (hi, (256 | lo) >> (16 - j)))
            assert seen.setdefault(node, key) == key
    assert len(seen) == (1 << 16) - 1
    assert len(set(seen.values())) == len(seen)
    assert {r for r, _ in seen.values()} == set(range(257))
    assert {x for _, x in seen.values()} == set(range(1, 256))


@pytest.mark.parametrize("W,mode,kw", [
    (8, "o2 as o1", {}), (8, "o2", dict(early=True)), (16, "w16 as o1", {})],
    ids=["order 1's row at order 2", "pair region read early",
         "W = 16's lo row by the previous byte"])
def test_rows_wrong_row_or_early_read_fails(W, mode, kw):
    """Negative controls: order 1's row rule at order 2; order 2's pair
    region read when the step starts, before the last byte's deferred
    stores (on a run, where the row repeats); at W = 16 the lo byte keyed
    by the previous byte, as order 1 would."""
    K, L = 32, 2
    if W == 8:
        cols = _cols("run" if kw else "textbwt", K, L, 5)
    else:
        cols = _elems("mixed", 16, K, L, 5)
    order = 2 if W == 8 else 0
    words, lens = _streams(cols, order, W)
    good = "o2" if W == 8 else "w16"
    assert np.array_equal(decode_rows(words, lens, K, W, good), cols)
    assert not np.array_equal(decode_rows(words, lens, K, W, mode, **kw),
                              cols)
