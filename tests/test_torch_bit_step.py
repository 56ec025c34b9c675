"""The steps of the bitwise byte-tree kernels L11 and L12
(``ops/csrc/rans_bit_kernel.cu``) as numpy mirrors, thread by thread on
the kernels' layouts, held exactly against ``lane_bit_model_plain`` and
``lane_bit_decode_plain``.  No JAX.

- L11 (``model_mirror``): a thread a (lane, depth); a lane's bytes come a
  chunk of 32 steps ahead, a step's by one shuffle of the CTA's 4 lanes'
  packed bytes, the steps in two halves of 16 a chunk (a step's ring
  entry t mod A); the slot of step t + A is read right after step t's store
  and takes the value of the latest of steps t + 1 .. t + A - 1 that wrote
  the same slot (A = 2 at order 0, 8 at order 1); an FSM slot holds the
  state;
- L12 (``decode_mirror``): a row's head (nodes 1-7) and line A (nodes
  8-31) read when the byte starts, the pair region of its depth-3 node
  read when decision 2 is known (order 1), or the grandchildren of a
  decision's chosen child read when its bit is known, in a row of 256
  slots (order 0); an FSM slot holds (p << 16) | state; a
  slot's update is stored two decisions later; the lane's words from a
  ring in shared memory that cp.async fills a 16-byte unit a byte step;
- the row layout (``body_slot``) is a bijection onto a row's 248 body
  slots, and the kernel's store addresses follow it;
- the FSM's u16 form in shared memory (``fsm_u16``) and the refusal of
  tables past 32,768 states.

Negative controls: reads ahead with no forwarding, on a run; a layout
map that sends two nodes to one slot; the pair region read when the byte
starts, before the last byte's deferred stores.  The constants the
mirrors copy are read from the source.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.models import bitpred, fsm
from turborc_tpu_torch.ops import build, rans
from turborc_tpu_torch.ops import rans_bit_kernel as BK
from turborc_tpu_torch.ops import rans_lane_kernel as LK

ROOT = Path(__file__).resolve().parents[1]
TEXT = np.fromfile(ROOT / "turborc_tpu" / "bench" / "_data" /
                   "textbwt_65536.bin", np.uint8)
SRC = (Path(build.__file__).resolve().parent / "csrc" /
       "rans_bit_kernel.cu").read_text()
U32 = 0xFFFFFFFF

# the kernels' constants (held against the source below)
LANES = 4        # kBitLanes: L11's lanes a CTA, 8 depths each
DLANES = 4       # kBitDLanes: L12's lanes a CTA
SETUP = 256      # kBitSetup
AHEAD = (2, 8)   # kAhead0, kAhead1: L11's read-ahead at order 0, 1
STRIDE = 257     # kBitStride
HEAD = 8         # kHeadSlots
ROW = 256        # kRowSlots: order 0's row
BODY = 256       # kBodySlots
PAIR_AT = 24     # kPairAt
PAIR = 28        # kPair
RING = 128       # kRingW: L12's ring of words a lane
RING_AHEAD = 64  # kRingAhead
MAX_STATES = 32768  # kMaxStates


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, name
    return int(m.group(1))


def test_constants_match_source():
    for name, want in (("kBitLanes", LANES), ("kBitDLanes", DLANES),
                       ("kBitSetup", SETUP), ("kAhead0", AHEAD[0]),
                       ("kAhead1", AHEAD[1]), ("kBitStride", STRIDE),
                       ("kHeadSlots", HEAD), ("kBodySlots", BODY),
                       ("kRowSlots", ROW),
                       ("kPairAt", PAIR_AT), ("kPair", PAIR),
                       ("kRingW", RING), ("kRingAhead", RING_AHEAD),
                       ("kMaxStates", MAX_STATES)):
        assert _const(name) == want, name
    assert (BK.BIT_LANES, BK.BIT_DECODE_LANES, BK.BIT_SETUP,
            BK.BIT_MAX_STATES) == (LANES, DLANES, SETUP, MAX_STATES)
    # a warp of 4 lanes x 8 depths, and the two kernels' launches
    assert LANES * 8 == 32
    assert BK.bit_launch(512) == (SETUP, 128)
    assert BK.bit_launch(512, decode=True) == (SETUP, 128)
    assert BK.bit_launch(2) == (SETUP, 1)
    # the kernels' index math as the mirrors copy it
    for line in ("const int dt = int(threadIdx.x) / kN, n = int(threadIdx.x) "
                 "% kN;",
                 "constexpr int kN = 4 / int(sizeof(Elem<kW>));",
                 "const uint32_t* pair = brow + kPairAt + kPair * j3;",
                 "const Upd u3{brow + j3, pr.dnext1(v, p, b3)};",
                 "const Upd u4{brow + 8 + 2 * j3 + b3, pr.dnext1(v, p, b4)};",
                 "uint32_t* half = brow + kPairAt + kPair * j3 + 14 * b3;",
                 "const Upd u5{half + b4, pr.dnext1(v, p, b5)};",
                 "const Upd u6{half + 2 + 2 * b4 + b5, pr.dnext1(v, p, b6)};",
                 "u7 = Upd{half + 6 + 4 * b4 + 2 * b5 + b6, "
                 "pr.dnext1(v, p, b7)};",
                 "for (int i = 0; i < 14; ++i) H[i] = b3 ? Q[14 + i] : Q[i];",
                 "for (int i = 0; i < 4; ++i) D[i] = b4 ? H[10 + i] : "
                 "H[6 + i];",
                 "v = sl[r] == fs[i] ? fv[i] : v;",
                 "rv[r] = tab[sl[r]];  // after this step's store",
                 "const int t = t0 + j, r = j % kA;",
                 "plan(kH + j + kA < 32 ? cur : nxt, (kH + j + kA) & 31, "
                 "sl[r], bt[r]);",
                 "const int n = threadIdx.x >> 5, l = blockIdx.x * kBitDLanes"
                 " + n;",
                 "return uint32_t(ring[(o + i) & (kRingW - 1)]);",
                 "if (8 * fu < o + st.pos + kRingAhead) ring_fetch(ring, "
                 "words, end, fu++);",
                 "const long long end = st.nw ? o + st.nw : 0;",
                 "const int bytes = w0 < 0 || left <= 0 ? 0 : left >= 16 ? "
                 "16 : int(left);",
                 "__device__ __forceinline__ int prob(uint32_t v) const { "
                 "return int(v); }",
                 "return max(int(((v & 0xFFFFu) + (v >> 16)) >> 2), 1);",
                 "w = take ? w2 : w;",
                 "w2 = word(pos + 1);",
                 "cp_async_wait<6>();",
                 "S > kMaxStates"):
        assert line in SRC, line


# ---------------------------------------------------------------------------
# predictors on one u32 slot, as the kernels hold it
# ---------------------------------------------------------------------------

def _clamp(p: int) -> int:
    return min(max(p, 1), 32767)


def fsm_u16(table: np.ndarray):
    """The FSM table [3, S] as a CTA holds it in shared memory: nx[2 s +
    bit] (a next state past S - 1, or negative, reads as S - 1) and pq[s]
    (the clamped probability), both u16."""
    S = table.shape[1]
    nxt = table[1:].astype(np.int64).T.reshape(-1) & U32
    nx = np.where(nxt < S, nxt, S - 1).astype(np.uint16)
    pq = np.clip(table[0], 1, 32767).astype(np.uint16)
    return nx, pq


class Pred:
    """(init, prob, next) of L11's slot and (dinit, dprob, dnext1,
    dnext2) of L12's, for predictor ``name`` ('s', 'ss' at rates r0, r1,
    'sf' over ``table`` from ``start``)."""

    def __init__(self, name: str, r0: int = 5, r1: int = 8, table=None,
                 start: int | None = None):
        self.name = name
        if name == "sf":
            if table is None:
                table = np.stack(fsm.build_table())
                start = fsm.initial_state()
            self.nx, self.pq = fsm_u16(np.asarray(table))
            self.start = start
        self.r = (min(r0, 16), min(r1, 16))

    def torch(self, device="cpu"):
        if self.name == "s":
            return bitpred.Simple()
        if self.name == "ss":
            return bitpred.DualSpeed(*self.r)
        return None

    def init(self) -> int:
        return {"s": 16384, "ss": 0x80008000}.get(self.name, getattr(
            self, "start", 0))

    def prob(self, v: int) -> int:
        if self.name == "s":
            return v  # a counter stays in [1, 2^15 - 1]
        if self.name == "ss":
            return max(((v & 0xFFFF) + (v >> 16)) >> 2, 1)
        return int(self.pq[v])

    def next(self, v: int, p: int, b: int) -> int:
        if self.name == "s":
            return (p - (((p - (b << 15)) >> 5) + b)) & U32
        if self.name == "ss":
            c = [v & 0xFFFF, v >> 16]
            c = [x + ((x ^ 0xFFFF) >> k) if b else x - (x >> k)
                 for x, k in zip(c, self.r)]
            return c[0] | c[1] << 16
        return int(self.nx[2 * v + b])

    # L12's slot: an FSM slot is (p << 16) | state
    def dinit(self) -> int:
        if self.name != "sf":
            return self.init()
        return int(self.pq[self.start]) << 16 | self.start

    def dprob(self, v: int) -> int:
        return v >> 16 if self.name == "sf" else self.prob(v)

    def dnext1(self, v: int, p: int, b: int) -> int:
        return (int(self.nx[2 * (v & 0xFFFF) + b]) if self.name == "sf"
                else self.next(v, p, b))

    def dnext2(self, s: int) -> int:
        return int(self.pq[s]) << 16 | s if self.name == "sf" else s


def _random_fsm(S: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 1 << 15, S), rng.integers(0, S, S),
                     rng.integers(0, S, S)]).astype(np.int32)


def _preds():
    """(tag, mirror predictor, torch predictor) of every case."""
    table = _random_fsm(100, 7)
    out = [("s", Pred("s"), bitpred.Simple()),
           ("ss", Pred("ss"), bitpred.DualSpeed(5, 8)),
           ("ss 40/3", Pred("ss", 40, 3), bitpred.DualSpeed(40, 3)),
           ("sf", Pred("sf"), bitpred.Fsm(device="cpu")),
           ("sf random 100", Pred("sf", table=table, start=3),
            bitpred.Fsm(torch.from_numpy(table), start=3))]
    return out


PREDS = _preds()


def test_counter_ranges_make_clamps_identities():
    """PredS reads a slot unclamped: from the start value 2^14, the update
    of any p in [1, 2^15 - 1] stays there, so every counter does.  PredSS
    clamps only from below: (c0 + c1) >> 2 of 16-bit counters is at most
    2^15 - 1, and 0 where both reach 0 (a rate of 0)."""
    p = np.arange(1, 1 << 15, dtype=np.int64)
    for b in (0, 1):
        nxt = p - (((p - (b << 15)) >> 5) + b)
        assert nxt.min() >= 1 and nxt.max() <= (1 << 15) - 1
    assert ((0xFFFF + 0xFFFF) >> 2) == (1 << 15) - 1
    ss = Pred("ss", 0, 0)
    assert ss.next(0x80008000, 0, 0) == 0 and ss.prob(0) == 1


# ---------------------------------------------------------------------------
# L11: the model
# ---------------------------------------------------------------------------

def model_mirror(cols: np.ndarray, order: int, pred: Pred,
                 ahead: int | None = None, forward: bool = True
                 ) -> np.ndarray:
    """L11, thread by thread: probs [8K, L] int64.  ``ahead`` replaces the
    kernel's read-ahead; ``forward=False`` drops the forwarding (a
    negative control)."""
    kA = ahead or AHEAD[order]
    K, L = cols.shape
    probs = np.zeros((8 * K, L), np.int64)

    def chunk(l0: int, c: int) -> list:
        """Lane i of the warp: step c + i's bytes of lanes l0..l0+3 (0
        past K)."""
        w = []
        for i in range(32):
            t, x = c + i, 0
            if t < K:
                for k in range(LANES):
                    if l0 + k < L:
                        x |= int(cols[t, l0 + k]) << (8 * k)
            w.append(x)
        return w

    for l0 in range(0, L, LANES):
        full = l0 + LANES <= L
        for n in range(min(LANES, L - l0)):
            for d in range(8):
                tab = {}
                g = dict(cur=chunk(l0, 0), nxt=chunk(l0, 32), prev=0)

                def plan(src, lane):
                    b = (g[src][lane] >> (8 * n)) & 255
                    slot = (g["prev"] << 8 if order else 0) | (
                        (256 | b) >> (8 - d))
                    g["prev"] = b
                    return slot, (b >> (7 - d)) & 1

                sl, bt, rv = [0] * kA, [0] * kA, [0] * kA
                fs, fv = [-1] * kA, [0] * kA
                for j in range(kA):
                    sl[j], bt[j] = plan("cur", j)
                    rv[j] = tab.get(sl[j], pred.init())
                for c0 in range(0, K, 32):
                    nn = chunk(l0, c0 + 64)
                    guard = not (full and c0 + 32 <= K)
                    for h in (0, 16):  # the two halves of the chunk
                        for j in range(16):
                            t, r = c0 + h + j, j % kA
                            v = rv[r]
                            for k in range(kA - 1, 0, -1):
                                i = (r - k) % kA
                                if forward and sl[r] == fs[i]:
                                    v = fv[i]
                            p = pred.prob(v)
                            bit = bt[r]
                            nv = pred.next(v, p, bit)
                            if not guard or t < K:
                                probs[8 * t + d, l0 + n] = (
                                    p if bit else (p << 16) | (32768 - p))
                                tab[sl[r]] = nv
                            fs[r], fv[r] = sl[r], nv
                            u = h + j + kA
                            sl[r], bt[r] = plan("cur" if u < 32 else "nxt",
                                                u & 31)
                            rv[r] = tab.get(sl[r], pred.init())
                    g["cur"], g["nxt"] = g["nxt"], nn
    return probs


def _cols(what: str, K: int, L: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if what == "textbwt":
        off = 997 * seed % (TEXT.size - K * L)
        return TEXT[off:off + K * L].reshape(L, K).T.copy()
    if what == "random":
        return rng.integers(0, 256, (K, L), dtype=np.uint8)
    if what == "run":
        x = np.full((K, L), 0x41, np.uint8)
        x[:, 1::2] = 0xFF
        return x
    if what == "alternate":
        return rng.integers(0, 256, (2, L), dtype=np.uint8)[np.arange(K) % 2]
    if what == "siblings":  # bytes whose depth-4 nodes are siblings
        base = rng.integers(0, 8, (K, L)) * 32 + rng.integers(0, 2, (K, L))
        return (base + 16 * (np.arange(K)[:, None] % 2)).astype(np.uint8)
    return ((np.arange(K)[:, None] + 37 * np.arange(L)) % 256).astype(
        np.uint8)


MODEL_CASES = [("textbwt", 64, 32), ("random", 33, 6), ("run", 64, 4),
               ("alternate", 40, 5), ("siblings", 24, 4),
               ("every byte", 9, 3), ("textbwt", 1, 2), ("textbwt", 7, 1)]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("what,K,L", MODEL_CASES)
def test_model_step_equals_plain(what, K, L, order):
    """L11's step on every predictor equals the plain model exactly: the
    bytes a chunk ahead by shuffle, the slots read ahead and forwarded."""
    cols = _cols(what, K, L, K + L)
    for tag, pm, pt in PREDS:
        want = BK.lane_bit_model_plain(torch.from_numpy(cols), order, pt)
        got = model_mirror(cols, order, pm)
        assert np.array_equal(got, want.numpy().astype(np.int64)), tag


@pytest.mark.parametrize("ahead", [1, 2, 4, 16])
def test_model_read_ahead_depths(ahead):
    """Any read-ahead A that divides 16 (the kernel's static_assert: a
    half chunk holds whole rings) gives the plain probs (the ring and
    forwarding over A - 1 steps, the chunk boundary at 32 crossed)."""
    assert "static_assert(16 % kA == 0" in SRC
    cols = _cols("textbwt", 40, 4, 5)
    for order in (0, 1):
        want = BK.lane_bit_model_plain(torch.from_numpy(cols), order,
                                       bitpred.DualSpeed(5, 8))
        got = model_mirror(cols, order, Pred("ss"), ahead=ahead)
        assert np.array_equal(got, want.numpy().astype(np.int64))


@pytest.mark.parametrize("order", [0, 1])
def test_model_without_forwarding_fails(order):
    """Negative control: reads ahead with no forwarding, on a run, read a
    slot before the steps between wrote it."""
    cols = _cols("run", 16, 4, 1)
    want = BK.lane_bit_model_plain(torch.from_numpy(cols), order,
                                   bitpred.Simple()).numpy()
    bad = model_mirror(cols, order, Pred("s"), forward=False)
    assert not np.array_equal(bad, want.astype(np.int64))


# ---------------------------------------------------------------------------
# L12: the row layout
# ---------------------------------------------------------------------------

def body_slot(node: int, pair: int = PAIR) -> int:
    """L12's body slot of node 8..255 in its row: line A holds nodes 8-31
    at 0-23; the pair region of depth-3 node 8 + j at PAIR_AT + pair j
    holds the depth 5-7 subtrees of its children m = 16 + 2 j + h, each
    14 slots: nodes 2m + i at i, 4m + i at 2 + i, 8m + i at 6 + i."""
    d = node.bit_length() - 1
    assert 3 <= d <= 7, node
    if d <= 4:
        return node - 8
    m = node >> (d - 4)
    j, h = (m >> 1) - 8, m & 1
    return (PAIR_AT + pair * j + 14 * h + (1 << (d - 4)) - 2
            + node - (m << (d - 4)))


def _is_bijection(pair: int) -> bool:
    slots = [body_slot(x, pair) for x in range(8, 256)]
    return sorted(slots) == list(range(248))


def test_row_layout_is_a_bijection():
    assert _is_bijection(PAIR)
    assert PAIR_AT + 8 * PAIR == 248 <= BODY
    # a byte's path: depths 3-4 in line A, depths 5-7 in the pair region
    # of its depth-3 node, read whole (7 loads of 16 bytes, aligned)
    for b in range(256):
        nodes = [(256 | b) >> (8 - d) for d in range(8)]
        j = nodes[3] - 8
        for d in (3, 4):
            assert 0 <= body_slot(nodes[d]) < PAIR_AT
        for d in (5, 6, 7):
            assert 0 <= body_slot(nodes[d]) - (PAIR_AT + PAIR * j) < PAIR
    assert (PAIR_AT * 4) % 16 == 0 and (PAIR * 4) % 16 == 0
    assert PAIR % 4 == 0 and PAIR_AT % 4 == 0


def test_layout_map_two_nodes_one_slot_fails():
    """Negative control: a pair stride of 27 sends two nodes to one slot;
    the map is no bijection and the decode goes wrong."""
    assert not _is_bijection(27)
    # 0x1F's depth-7 node (8 * 17 + 7) and 0x20's depth-5 node (2 * 18)
    # then share a slot
    assert body_slot(8 * 17 + 7, 27) == body_slot(2 * 18, 27)
    K, L = 32, 2
    # at order 1 (the pair regions are its rows'): 0x1F and 0x20 each
    # after a 0, so both in row 0
    cols = np.tile(np.array([[0], [0x1F], [0], [0x20]], np.uint8),
                   (K // 4, L))
    words, lens = _streams(cols, 1, bitpred.Simple())
    assert np.array_equal(decode_mirror(words, lens, K, 1, Pred("s")), cols)
    got = decode_mirror(words, lens, K, 1, Pred("s"), pair=27)
    assert not np.array_equal(got, cols)


# ---------------------------------------------------------------------------
# L12: the decode
# ---------------------------------------------------------------------------

class Stream:
    """A lane's stream as L12 reads it: the state and the next word, word
    ``pos`` of the lane, from its ring of ``RING`` words that a unit of 8
    words (16 bytes, aligned in the words array) a byte step fills up to
    ``RING_AHEAD`` words ahead; ``ring`` holds what the fills wrote."""

    def __init__(self, words: np.ndarray, o: int, nw: int):
        self.words, self.o, self.nw = words, o, nw
        self.end = o + nw if nw else 0  # the fills write 0 from here
        # shared memory holds no zeros to start with: every slot read must
        # have been written by a fill
        self.ring = np.full(RING, 0xBEEF, np.int64)
        self.fu = o >> 3
        while 8 * self.fu < o + RING_AHEAD:
            self.fetch()
        self.s = self.gword(o) << 16 | self.gword(o + 1) if nw > 1 else (
            self.gword(o) << 16 if nw else 0)
        self.w, self.pos = (self.gword(o + 2) if nw > 2 else 0), 2
        self.w2 = self.word(3)

    def gword(self, i: int) -> int:
        return int(self.words[i]) & 0xFFFF if i < self.words.size else 0

    def fetch(self):
        """One unit into the ring: words 8 fu .. 8 fu + 7, zeros at or past
        the lane's end."""
        for i in range(8 * self.fu, 8 * self.fu + 8):
            self.ring[i % RING] = self.gword(i) if 0 <= i < self.end else 0
        self.fu += 1

    def step(self):
        """A byte step's fill: a unit while fewer than RING_AHEAD words lie
        ahead; every word of this step is then in the ring."""
        if 8 * self.fu < self.o + self.pos + RING_AHEAD:
            self.fetch()
        assert 8 * self.fu >= self.o + self.pos + 16 > self.o + self.pos + 9

    def bit(self, p: int) -> int:
        s = self.s
        x, q = s & 0x7FFF, s >> 15
        b = int(x < p)
        t = (p * q + x) & U32 if b else (s - p * (q + 1)) & U32
        take = t < 1 << 15
        self.s = (t << 16 | self.w) & U32 if take else t
        self.pos += take
        self.w = self.w2 if take else self.w
        self.w2 = self.word(self.pos + 1)
        return b

    def word(self, i: int) -> int:
        """Word i of the lane from the ring (0 at or past nw: the fills
        wrote 0 there)."""
        return int(self.ring[(self.o + i) % RING])


def decode_o0_mirror(st: "Stream", K: int, pred: Pred,
                     early: bool = False) -> list:
    """L12 at order 0, one lane (``decode_o0``): the row in shared memory,
    node k at slot k; a decision reads the grandchildren of its chosen
    child when its bit is known; the next byte's first 8 slots are read at
    decision 5 (``early``: at decision 3, before decision 2's update is
    stored, a negative control); each update stored two decisions later."""
    row = [pred.dinit()] * ROW
    h = row[0:8]
    F = U = (0, 0)  # (slot, value): dummies on slot 0
    out = []
    for _ in range(K):
        st.step()
        node, v, c0, c1 = 1, h[1], h[2], h[3]
        p, gc = pred.dprob(v), h[4:8]
        for d in range(8):
            p0, p1 = pred.dprob(c0), pred.dprob(c1)
            b = st.bit(p)
            row[F[0]] = F[1]
            F = (U[0], pred.dnext2(U[1]))
            U = (node, pred.dnext1(v, p, b))
            node = 2 * node + b
            v, p = (c1, p1) if b else (c0, p0)
            if d < 6:
                c0, c1 = (gc[2], gc[3]) if b else (gc[0], gc[1])
            if d < 5:
                gc = row[4 * node:4 * node + 4]
            if d == (3 if early else 5):
                h = row[0:8]
        out.append(node & 255)
    return out


def decode_mirror(words: np.ndarray, lengths: np.ndarray, K: int,
                  order: int, pred: Pred, pair: int = PAIR,
                  early: bool = False) -> np.ndarray:
    """L12, lane by lane, on the kernel's rows and pipeline: bytes [K, L].
    Order 0 as ``decode_o0_mirror``; order 1 on the rows' heads, lines A
    and pair regions.  ``pair`` replaces the pair regions' stride;
    ``early`` reads too early (a negative control): at order 1 the pair
    region when the byte starts, before the last byte's deferred stores of
    decisions 6 and 7; at order 0 the next byte's head at decision 3."""
    L = lengths.size
    off = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    out = np.zeros((K, L), np.uint8)
    for l in range(L):
        nw = int(max(0, min(lengths[l], 8 * K + 2, words.size - off[l])))
        st = Stream(words.astype(np.int64), int(off[l]), nw)
        if order == 0:
            out[:, l] = decode_o0_mirror(st, K, pred, early)
            continue
        heads = [pred.dinit()] * (256 * HEAD)
        body = [pred.dinit()] * (256 * BODY)
        ctx = 0
        f6, u7 = (heads, 0, 0), (heads, 0, 0)  # (memory, slot, value)

        def store(f):
            f[0][f[1]] = f[2]

        def fin(u):
            return u[0], u[1], pred.dnext2(u[2])

        for t in range(K):
            st.step()
            hb, bb = ctx * HEAD, ctx * BODY
            h = heads[hb:hb + HEAD]
            A = body[bb:bb + PAIR_AT]
            pre = body[bb + PAIR_AT:bb + PAIR_AT + 8 * pair]
            # d0
            v, (k0, k1) = h[1], (h[2], h[3])
            p = pred.dprob(v)
            b0 = st.bit(p)
            f7 = fin(u7)
            store(f6)
            u0 = (heads, hb + 1, pred.dnext1(v, p, b0))
            v = k1 if b0 else k0
            p = pred.dprob(v)
            # d1
            k0, k1 = (h[6], h[7]) if b0 else (h[4], h[5])
            b1 = st.bit(p)
            store(f7)
            f0 = fin(u0)
            u1 = (heads, hb + 2 + b0, pred.dnext1(v, p, b1))
            v = k1 if b1 else k0
            p = pred.dprob(v)
            # d2
            b2 = st.bit(p)
            store(f0)
            f1 = fin(u1)
            u2 = (heads, hb + 4 + 2 * b0 + b1, pred.dnext1(v, p, b2))
            j3 = 4 * b0 + 2 * b1 + b2
            at = bb + PAIR_AT + pair * j3
            Q = (pre[pair * j3:pair * j3 + PAIR] if early
                 else body[at:at + PAIR])
            v, k0, k1 = A[j3], A[8 + 2 * j3], A[9 + 2 * j3]
            p = pred.dprob(v)
            # d3
            b3 = st.bit(p)
            store(f1)
            f2 = fin(u2)
            u3 = (body, bb + j3, pred.dnext1(v, p, b3))
            v = k1 if b3 else k0
            p = pred.dprob(v)
            H = [Q[14 + i] if b3 else Q[i] for i in range(14)]
            k0, k1 = H[0], H[1]
            # d4
            b4 = st.bit(p)
            store(f2)
            f3 = fin(u3)
            u4 = (body, bb + 8 + 2 * j3 + b3, pred.dnext1(v, p, b4))
            v = k1 if b4 else k0
            p = pred.dprob(v)
            half = at + 14 * b3
            k0, k1 = H[2 + 2 * b4], H[3 + 2 * b4]
            D = [H[10 + i] if b4 else H[6 + i] for i in range(4)]
            # d5
            b5 = st.bit(p)
            store(f3)
            f4 = fin(u4)
            u5 = (body, half + b4, pred.dnext1(v, p, b5))
            v = k1 if b5 else k0
            p = pred.dprob(v)
            k0, k1 = (D[2], D[3]) if b5 else (D[0], D[1])
            # d6
            b6 = st.bit(p)
            store(f4)
            f5 = fin(u5)
            u6 = (body, half + 2 + 2 * b4 + b5, pred.dnext1(v, p, b6))
            v = k1 if b6 else k0
            p = pred.dprob(v)
            # d7
            b7 = st.bit(p)
            store(f5)
            f6 = fin(u6)
            u7 = (body, half + 6 + 4 * b4 + 2 * b5 + b6,
                  pred.dnext1(v, p, b7))
            byte = (b0 << 7 | b1 << 6 | b2 << 5 | b3 << 4 | b4 << 3
                    | b5 << 2 | b6 << 1 | b7)
            out[t, l] = byte
            ctx = byte
    return out


def _streams(cols: np.ndarray, order: int, pt):
    """The lanes' streams of ``cols`` (plain model and coder)."""
    L = cols.shape[1]
    probs = BK.lane_bit_model_plain(torch.from_numpy(cols), order, pt)
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32)
    st, ln = LK.lane_coder_plain(probs, init)
    return blockio.device_words(st, ln).numpy(), ln.numpy().astype(np.int64)


def _corrupt(words: np.ndarray, lens: np.ndarray, seed: int):
    rng = np.random.default_rng(seed)
    flipped = words.copy()
    flipped[rng.integers(0, words.size, 6)] ^= 0x5A5A
    short = lens.copy()
    short[0] = 1
    longer = lens.copy()
    longer[-1] += 9
    past = lens.copy()  # the lanes after the first start past the words
    past[0] += words.size
    return {"flipped words": (flipped, lens), "a length cut": (words, short),
            "a length past the words": (words, longer),
            "lanes past the words": (words, past)}


DECODE_CASES = [("textbwt", 64, 16), ("random", 33, 4), ("run", 64, 2),
                ("alternate", 40, 3), ("siblings", 24, 4),
                ("every byte", 9, 4), ("textbwt", 1, 2), ("textbwt", 7, 1)]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("what,K,L", DECODE_CASES)
def test_decode_step_equals_plain(what, K, L, order):
    """L12's step decodes the plain decode's bytes on every predictor, on
    sound streams (the bytes themselves) and corrupt ones."""
    cols = _cols(what, K, L, 2 * K + L)
    for tag, pm, pt in PREDS:
        words, lens = _streams(cols, order, pt)
        got = decode_mirror(words, lens, K, order, pm)
        assert np.array_equal(got, cols), tag
        if what != "textbwt" or K < 64:
            continue
        for bad, (w, n) in _corrupt(words, lens, K).items():
            want = BK.lane_bit_decode_plain(
                torch.from_numpy(w.astype(np.int16)),
                torch.from_numpy(n.astype(np.int32)), K, order, pt)
            got = decode_mirror(w, n, K, order, pm)
            assert np.array_equal(got, want.numpy()), (tag, bad)


@pytest.mark.parametrize("order", [0, 1])
def test_reads_before_their_stores_fail(order):
    """Negative controls: at order 1, the pair region read when the byte
    starts misses the last byte's updates of decisions 6 and 7, stored at
    decisions 0 and 1 (read at decision 2, the kernel's, it sees them); at
    order 0, the next byte's head read at decision 3 misses decision 2's
    update, stored at decision 4 (read at decision 5, it sees it)."""
    K, L = 48, 2
    cols = _cols("run", K, L, 4)
    words, lens = _streams(cols, order, bitpred.Simple())
    assert np.array_equal(decode_mirror(words, lens, K, order, Pred("s")),
                          cols)
    bad = decode_mirror(words, lens, K, order, Pred("s"), early=True)
    assert not np.array_equal(bad, cols)


# ---------------------------------------------------------------------------
# the FSM's form in shared memory and in L12's slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["codecs", "random 100", "out of range"])
def test_fsm_slot_form(which):
    """nx / pq (u16) and L12's slot (p << 16) | state step as the plain
    Fsm does, from every state and bit: the probability read off the slot
    is the plain prediction, clamped; a next state past S - 1 (or
    negative) reads as S - 1."""
    if which == "codecs":
        table = np.stack(fsm.build_table()).astype(np.int32)
    elif which == "random 100":
        table = _random_fsm(100, 11)
    else:
        table = _random_fsm(50, 12)
        table[1, :5] = [-1, 50, 49, 1 << 20, -(1 << 30)]
        table[0, :3] = [0, 40000, -5]
    S = table.shape[1]
    nx, pq = fsm_u16(table)
    assert nx.dtype == np.uint16 and pq.dtype == np.uint16
    assert S <= MAX_STATES
    s = np.arange(S)
    nxt = table[1:].astype(np.int64) & U32
    for b in (0, 1):
        want = np.where(nxt[b] < S, nxt[b], S - 1)
        assert np.array_equal(nx[2 * s + b], want)
    assert np.array_equal(pq, np.clip(table[0], 1, 32767))
    if which == "out of range":
        return
    pm = Pred("sf", table=table, start=3)
    pt = bitpred.Fsm(torch.from_numpy(table), start=3)
    idx = torch.arange(S)[None]
    for b in (0, 1):
        # the plain step from state x, every state at once
        want = pt.update(torch.arange(S, dtype=torch.int32)[None], idx,
                         None, torch.full((1, S), bool(b)))[0].numpy()
        for x in range(S):
            v = int(pq[x]) << 16 | x
            assert pm.dprob(v) == _clamp(int(table[0, x]))
            nv = pm.dnext2(pm.dnext1(v, pm.dprob(v), b))
            assert nv & 0xFFFF == want[x]
            assert nv >> 16 == _clamp(int(table[0, want[x]]))
    assert pm.dinit() == _clamp(int(table[0, 3])) << 16 | 3


def test_fsm_past_32768_states_refused():
    big = bitpred.Fsm(torch.zeros((3, MAX_STATES + 1), dtype=torch.int32))
    cols = torch.zeros((4, 4), dtype=torch.uint8)
    words = torch.zeros((40,), dtype=torch.int16)
    lens = torch.full((4,), 10, dtype=torch.int32)
    for order in (0, 1):
        with pytest.raises(ValueError, match="32768"):
            BK.lane_bit_model(cols, order, big)
        with pytest.raises(ValueError, match="32768"):
            BK.lane_bit_decode(words, lens, 4, order, big)
    # exactly 32,768 states is taken
    ok = bitpred.Fsm(torch.zeros((3, MAX_STATES), dtype=torch.int32))
    BK.lane_bit_model(cols, 0, ok)
