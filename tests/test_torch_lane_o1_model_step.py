"""The byte step of the order-1 lane models L5 (id 59, ``O1Rank``) and L7
(id 64, ``O1Byte``), ``lane_o1_model_kernel`` in
``ops/csrc/rans_lane_kernel.cu``, on the CPU without the card: a numpy
mirror of the step thread by thread on the kernel's layout.  A lane is a
warp of two teams of 16 threads (team 0 the hi rows, team 1 the lo rows,
thread j entry j of every row), its rows in slots grouped by bank.  The
mirror plans a chunk of 16 steps ahead (row offset, nibble, next nibble,
and whether the row is that of one of the steps before), reads a step's
row ``kO1Ahead`` steps ahead right after the store of the step before it,
takes the entry of a repeated row from registers, updates with the mask
by index (entry i moves up where i > sym) and makes the slot from two
shuffles.  It is held exactly against ``lane_o1_model_plain`` /
``lane_o1r_model_plain`` (which ``test_torch_lane_o1.py`` and the goldens
hold against the JAX package) on random bytes, runs, alternations, bytes
that share one id-59 bucket row from many contexts, a few KB of
realsrcbwt, and K from 1 to 256.  A hypothesis property pins the mask by
index: on any strictly increasing row in [0, 2^15) it is ``cdf16.update``
(the mask by value, with its repair and clamp), and the row stays
strictly increasing.  Negative controls that must fail: rows read before
the last step's store with no forwarding, on a run; the mask by index on
a row that is not strictly increasing.  Source checks hold the constants
and expressions the mirror copies.  No JAX.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.ops import build
from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO

SRC = (Path(build.__file__).resolve().parent / "csrc"
       / "rans_lane_kernel.cu").read_text()
REAL = (Path(R1.__file__).resolve().parents[2] / "turborc_tpu" / "bench"
        / "_data" / "realsrcbwt_16777216.bin")
TEAM = 16
TOTAL = cdf16.TOTAL
J = np.arange(TEAM)
AHEAD = 3  # kO1Ahead
NEXT, FWD, ROW = 4, 8, 14  # kPlanNext, kPlanFwd, kPlanRow
LO_T, HI_T = J * cdf16.IC, J * cdf16.IC + cdf16.MIXD  # lo_t, hi_t


# ---------------------------------------------------------------------------
# the contexts, as the source's O1Rank and O1Byte
# ---------------------------------------------------------------------------

class Rank:
    """id 59: 64 hi rows by the rank context, 48 lo rows."""
    codec, hi_rows, lo_rows = "rans-cdf-r1", 64, 48

    @staticmethod
    def hi_row(prev):
        return R1.np_hictx(prev)

    @staticmethod
    def lo_row(prev, hs):
        return R1.np_locx(prev, hs)


class Byte:
    """id 64: 256 hi rows by prev, 4,096 lo rows by (prev, hs)."""
    codec, hi_rows, lo_rows = "rans-cdf-o1", 256, 4096

    @staticmethod
    def hi_row(prev):
        return prev

    @staticmethod
    def lo_row(prev, hs):
        return prev * 16 + hs


def slot(ctx, lo: bool, r):
    """o1m_hi_slot / o1m_lo_slot, on arrays."""
    g = LO.O1M_HI_GROUPS[ctx.codec]
    r = np.asarray(r)
    return 4 * (r // (4 - g)) + g + r % (4 - g) if lo else 4 * (r // g) + r % g


# ---------------------------------------------------------------------------
# the mirror; arrays are [L, 16]: lane, team thread
# ---------------------------------------------------------------------------

def start(ctx, L, hi_tbl=None, lo_tbl=None):
    """o1m_start: every lane's slots, [L, slots, 16] (entry j at thread
    j); id 64 fills every slot with cdf16.init."""
    S = LO.o1m_slots(ctx.codec)
    if hi_tbl is None:
        return np.broadcast_to(J << 11, (L, S, TEAM)).astype(np.int64)
    mem = np.zeros((L, S, TEAM), np.int64)
    seg = np.arange(L) * hi_tbl.shape[0] // L
    mem[:, slot(ctx, False, np.arange(ctx.hi_rows))] = hi_tbl[seg]
    mem[:, slot(ctx, True, np.arange(ctx.lo_rows))] = lo_tbl[seg]
    return mem


def plan(ctx, g, b, pb, ps, ahead):
    """o1m_plan of team g for a chunk: (plans, slots), [L, 16]; b, pb, ps
    the chunk's bytes and the chunk before's bytes and slots."""
    prev = np.where(J == 0, pb[:, 15:16], np.roll(b, 1, 1))
    hs = b >> 4
    r = (slot(ctx, True, ctx.lo_row(prev, hs)) if g
         else slot(ctx, False, ctx.hi_row(prev)))
    sym = b & 15 if g else hs
    p = r << (ROW + 5) | sym | ((sym + 1) & 15) << NEXT
    for k in range(1, ahead):
        before = np.where(J >= k, np.roll(r, k, 1), np.roll(ps, k, 1))
        p = p | np.where(before == r, 1 << (FWD + k - 1), 0)
    return p, r


def mirror_model(ctx, cols, hi_tbl=None, lo_tbl=None, ahead=AHEAD,
                 forward=True):
    """The step of lane_o1_model_kernel<ctx> on every lane -> probs [2K,
    L] int32.  ``ahead`` is kO1Ahead; ``forward`` False reads every row
    from memory though a step between wrote it (a negative control)."""
    K, L = cols.shape
    mem = start(ctx, L, hi_tbl, lo_tbl)
    out = np.zeros((2 * K, L), np.int64)
    lanes = np.arange(L)

    def chunk_bytes(c):
        t = c * TEAM + J
        return np.where(t < K, cols[np.minimum(t, max(K - 1, 0))].T
                        if K else 0, 0).astype(np.int64)

    def at(p):  # the slot of the row a plan names (its byte offset / 32)
        return (p >> ROW) // 32

    def read(p):
        return mem[lanes, at(p)]

    for g in (0, 1):  # the two teams share no row
        b_cur, b_nxt = chunk_bytes(0), chunk_bytes(1)
        p_cur, sl = plan(ctx, g, b_cur, 0 * b_cur, 0 * b_cur - 1, ahead)
        p_nxt, sl_nxt = plan(ctx, g, b_nxt, b_cur, sl, ahead)
        b_far = chunk_bytes(2)
        pl = [p_cur[:, d] for d in range(ahead)]
        ld = [read(p) for p in pl]
        fw = [np.zeros((L, TEAM), np.int64)] * max(ahead - 1, 1)
        slots = np.zeros((L, TEAM), np.int64)
        for t0 in range(0, K, TEAM):
            for u in range(TEAM):
                p, c = pl[0], ld[0]
                sym = p & 15
                for k in range(ahead - 1, 0, -1):
                    if forward:
                        c = np.where((p[:, None] >> (FWD + k - 1)) & 1,
                                     fw[k - 1], c)
                cn = c + ((np.where(J > sym[:, None], HI_T, LO_T) - c) >> 7)
                mem[lanes, at(p)] = cn
                # a team's shuffle takes the low 4 bits of its index
                low = c[lanes, p & 15]
                nx = np.where(J == 0, TOTAL, c)[lanes, (p >> NEXT) & 15]
                slots[:, u] = low * 65535 + nx
                fw = [cn] + fw[:-1]
                src = p_cur if u + ahead < TEAM else p_nxt
                pl = pl[1:] + [src[:, (u + ahead) & (TEAM - 1)]]
                ld = ld[1:] + [read(pl[-1])]
            t = t0 + J
            ok = t < K
            out[2 * t[ok] + g] = slots[:, ok].T
            b_new = chunk_bytes(t0 // TEAM + 3)
            p_cur = p_nxt
            p_nxt, sl_nxt = plan(ctx, g, b_far, b_nxt, sl_nxt, ahead)
            b_nxt, b_far = b_far, b_new
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def rank_tables(n_seg: int, rng):
    """Warm tables as segment_cdfs makes them: cumulative rows from 0,
    freq >= 1, summing to 2^15 ([n_seg, 64, 16], [n_seg, 48, 16])."""
    def rows(n):
        cuts = np.sort(np.stack([rng.choice(np.arange(1, TOTAL), 15, False)
                                 for _ in range(n_seg * n)]), 1)
        return np.concatenate([np.zeros((n_seg * n, 1), np.int64), cuts],
                              1).reshape(n_seg, n, 16).astype(np.int32)
    return rows(64), rows(48)


def _bytes(what: str, K: int, L: int) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, what)) + K * L)
    if what == "random":
        return rng.integers(0, 256, (K, L), dtype=np.uint8)
    if what == "runs":  # a lane one byte all the way, or long runs
        x = np.repeat(rng.integers(0, 256, K * L // 40 + 1), 40)[:K * L]
        x[rng.integers(0, K * L, K * L // 50)] ^= 0x11
        x = x.astype(np.uint8).reshape(L, K).T.copy()
        x[:, 0] = x[0, 0]
        return x
    if what == "alternate":  # two bytes: a row repeats at distance 2
        pair = rng.integers(0, 256, (2, L), dtype=np.uint8)
        return pair[np.arange(K) % 2]
    if what == "cycle":  # all 256 bytes in turn: no row repeats soon
        return ((np.arange(K)[:, None] + 37 * np.arange(L)) % 256
                ).astype(np.uint8)
    if what == "one bucket":  # ranks 128-255: id 59's hi row 63 for all
        return rng.integers(128, 256, (K, L), dtype=np.uint8)
    if what == "realsrcbwt":
        x = np.fromfile(REAL, np.uint8, count=K * L, offset=1 << 20)
        return x.reshape(L, K).T.copy()
    raise ValueError(what)


def run(codec: str, cols: np.ndarray, n_seg: int = 1, **kw):
    """(mirror's probs, plain's probs) of cols [K, L] u8."""
    t = torch.from_numpy(np.ascontiguousarray(cols))
    if codec == "64":
        return (mirror_model(Byte, cols, **kw),
                LO.lane_o1_model_plain(t).numpy())
    hi, lo = rank_tables(n_seg, np.random.default_rng(cols.size + n_seg))
    want = LO.lane_o1r_model_plain(t, torch.from_numpy(hi),
                                   torch.from_numpy(lo)).numpy()
    return mirror_model(Rank, cols, hi, lo, **kw), want


CASES = [(codec, what, K, L)
         for codec in ("59", "64")
         for what, K, L in (("random", 96, 4), ("runs", 200, 2),
                            ("alternate", 64, 4), ("cycle", 300, 2),
                            ("one bucket", 120, 8), ("realsrcbwt", 512, 8),
                            ("random", 1, 4), ("random", 7, 4),
                            ("random", 9, 2), ("random", 256, 2))]


@pytest.mark.parametrize("codec,what,K,L", CASES,
                         ids=[f"id{c}-{w}-K{K}-L{L}" for c, w, K, L in CASES])
def test_mirror_equals_plain(codec, what, K, L):
    """Exact: the mirror's probs equal the plain model's (id 59 at three
    warm-table segments where the lanes allow, so segments start inside
    a CTA of 4 lanes)."""
    got, want = run(codec, _bytes(what, K, L), 3 if L >= 4 else 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ahead", (1, 2, 4))
@pytest.mark.parametrize("codec", ("59", "64"))
def test_mirror_equals_plain_at_other_depths(codec, ahead):
    """Exact at the read-ahead depths the probe's variants build (1: the
    row read after the last step's store, no forwarding needed)."""
    got, want = run(codec, _bytes("runs", 100, 4), 2, ahead=ahead)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("codec", ("59", "64"))
def test_rows_read_ahead_without_forwarding_fail_on_a_run(codec):
    """Negative control: a row read kO1Ahead steps ahead but not taken from
    the steps between where they wrote it gives other probs on a run."""
    got, want = run(codec, _bytes("runs", 200, 2), forward=False)
    assert not np.array_equal(got, want)


def by_index(row, sym):
    """The kernel's update: entry i moves toward i IC + (i > sym ? MIXD :
    0) at rate 7."""
    return row + ((np.where(J > sym, HI_T, LO_T) - row) >> cdf16.CDFRATE)


def by_value(row, sym):
    """The port's cdf16.update: the mask c_i > c_sym, repair and clamp."""
    t = torch.from_numpy(np.asarray(row, np.int64))[None]
    return cdf16.update(t, t[:, sym]).numpy()[0]


def _row(cuts):
    return np.array([0, *sorted(cuts)], np.int64)


@settings(max_examples=400, deadline=None)
@given(cuts=st.lists(st.integers(1, TOTAL - 1), min_size=15, max_size=15,
                     unique=True),
       sym=st.integers(0, 15))
@example(cuts=list(range(1, 16)), sym=0)
@example(cuts=list(range(1, 16)), sym=15)
@example(cuts=list(range(TOTAL - 15, TOTAL)), sym=0)
@example(cuts=list(range(TOTAL - 15, TOTAL)), sym=15)
@example(cuts=list(range(TOTAL - 15, TOTAL)), sym=7)
@example(cuts=list(range(16000, 16015)), sym=8)
@example(cuts=[1, *range(TOTAL - 14, TOTAL)], sym=0)
def test_mask_by_index_is_cdf16_update(cuts, sym):
    """On any strictly increasing row in [0, 2^15) from 0 and any sym, the
    mask by index equals cdf16.update, and the row stays strictly
    increasing in [0, 2^15)."""
    row = _row(cuts)
    got = by_index(row, sym)
    assert np.array_equal(got, by_value(row, sym))
    assert got[0] == 0 and (np.diff(got) > 0).all() and got[-1] < TOTAL


def test_mask_by_index_holds_along_updates():
    """Exact along 2,000 updates of 64 rows (random, packed at the bottom
    and at the top), each by random symbols: the mask by index is
    cdf16.update at every step."""
    rng = np.random.default_rng(17)
    rows = [_row(rng.choice(np.arange(1, TOTAL), 15, False))
            for _ in range(62)]
    rows += [_row(range(1, 16)), _row(range(TOTAL - 15, TOTAL))]
    c = np.stack(rows)
    for _ in range(2000):
        sym = rng.integers(0, 16, len(c))
        got = c + ((np.where(J > sym[:, None], HI_T, LO_T) - c) >> 7)
        t = torch.from_numpy(c)
        want = cdf16.update(t, t[torch.arange(len(c)), sym]).numpy()
        assert np.array_equal(got, want)
        c = got


def test_mask_by_index_fails_on_a_row_that_is_not_increasing():
    """Negative control: where two entries are equal the masks differ."""
    row = _row([5, 5, *range(100, 1400, 100)])
    row[2] = row[1]
    assert not np.array_equal(by_index(row, 1), by_value(row, 1))


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------

FORMS = {
    "ahead": "constexpr int kO1Ahead = 3;",
    "plan bits": "constexpr int kPlanNext = 4, kPlanFwd = 8, kPlanRow = 14;",
    "row": "        reinterpret_cast<unsigned char*>(rows) + (p >> kPlanRow));",
    "targets": "const int lo_t = j * kIC, hi_t = j * kIC + kMixd;",
    "forward": "c = (p >> (kPlanFwd + k - 1)) & 1 ? fw[k - 1] : c;",
    "update": "const int cn = c + (((j > int(p & 15) ? hi_t : lo_t) - c) >> "
              "kO1Rate);",
    "store": "row(p) = uint16_t(cn);",
    "low": "const int low = __shfl_sync(kFull, c, p, kTeam);",
    "next": "const int nx = __shfl_sync(kFull, j ? c : kTotal, p >> kPlanNext, "
            "kTeam);",
    "slot": "slot = j == u ? low * 65535 + nx : slot;",
    "read ahead": "      pl[D - 1] = __shfl_sync(kFull, u + D < kTeam ? p_cur : "
                  "p_nxt,\n                              (u + D) & (kTeam - "
                  "1), kTeam);\n      ld[D - 1] = row(pl[D - 1]);",
    "plan": "  unsigned plan = unsigned(r) << (kPlanRow + 5) | sym |\n"
            "                  ((sym + 1) & 15) << kPlanNext;",
    "plan prev": "  const int prev = j ? up : last;",
    "plan before": "    plan |= (j >= k ? a : z) == r ? 1u << (kPlanFwd + k - 1)"
                   " : 0u;",
    "teams": "  const int n = threadIdx.x >> 5, g = (threadIdx.x >> 4) & 1;",
    "hi slot": "  return 4 * (r / C::kHiGroups) + r % C::kHiGroups;",
    "lo slot": "  return 4 * (q / (4 - C::kHiGroups)) + C::kHiGroups + "
               "q % (4 - C::kHiGroups);",
    "rank": "  static constexpr int kHiRows = 64, kLoRows = 48, kLanes = 4;\n"
            "  static constexpr int kDLanes = 4;  // the decode's lanes a "
            "CTA, a warp each\n  static constexpr int kHiGroups = 2;",
    "byte": "  static constexpr int kHiRows = 256, kLoRows = 4096, kLanes = 1;\n"
            "  static constexpr int kDLanes = 1;\n"
            "  static constexpr int kHiGroups = 1;",
}


@pytest.mark.parametrize("what", FORMS)
def test_source_holds_what_the_mirror_copies(what):
    assert FORMS[what] in SRC, what


def test_model_launch_matches_source():
    """The models' CTA: a warp a lane (id 59: 4 lanes, 128 CTAs at 512
    lanes; id 64: one lane), every lane's slots in shared memory."""
    assert LO.O1R_LANES == 4 and LO.O1_LANES == 1
    assert LO.O1M_HI_GROUPS == {"rans-cdf-r1": 2, "rans-cdf-o1": 1}
    assert LO.o1m_slots("rans-cdf-r1") == 128
    assert LO.o1m_slots("rans-cdf-o1") == 5464
    assert LO.o1_launch(512, "rans-cdf-r1") == (4, 128, 16_384, 128)
    assert LO.o1_launch(128, "rans-cdf-o1") == (1, 32, 174_848, 128)
    assert LO.o1_launch(2, "rans-cdf-r1")[3] == 1
    assert "return C::kLanes * 32;" in SRC
    assert "return C::kLanes * o1m_slots<C>() * 32;" in SRC
    assert 174_848 <= 232_448  # kSmemMax


@pytest.mark.parametrize("ctx", (Rank, Byte), ids=("id59", "id64"))
def test_slots_never_share_a_bank_group(ctx):
    """Every hi slot lies in the first kHiGroups of its group of 4 and
    every lo slot in the rest, so a warp's two teams meet on no bank; no
    two rows share a slot."""
    g = LO.O1M_HI_GROUPS[ctx.codec]
    hi = slot(ctx, False, np.arange(ctx.hi_rows))
    lo = slot(ctx, True, np.arange(ctx.lo_rows))
    assert (hi % 4 < g).all() and (lo % 4 >= g).all()
    both = np.concatenate([hi, lo])
    assert np.unique(both).size == both.size
    assert both.max() < LO.o1m_slots(ctx.codec)
    assert LO.o1m_slots(ctx.codec) * 32 <= 1 << (32 - ROW)
