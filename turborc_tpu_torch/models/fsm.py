"""FSM bit predictor tables ('sf'), numpy.

The port's own copy of ``turborc_tpu/models/fsm.py``: the same generated
32,768-state machine, state for state.  A state is a (quantized
probability pq, observation count n) pair; its probability of bit 1 is
pq's bucket centre and its next states move the probability toward the
observed bit with divisor min(n + 2, rate_cap), rounded up (Python's
``-(-p // d)``), then requantize.  The layout is the reference's fsm_t
{u16 p; u16 s[2]}: per state a 15-bit probability of bit 1 and the next
state for bit 0 and for bit 1.

Users with their own TurboRC-format table (text lines ``s1,s0,p``) load
it with ``load_reference_table``, which keeps the reference loader's
zero fill and clamps.
"""
from __future__ import annotations

import functools

import numpy as np

RC_BITS = 15
TOTAL = 1 << RC_BITS

_PQ = 1024       # probability quantization levels (10 bits)
_NMAX = 31       # observation-count cap
_RATE_CAP = 32   # final divisor = the simple counter's 1/32 rate
N_STATES = 32768


@functools.lru_cache(maxsize=4)
def build_table(pq_levels: int = _PQ, nmax: int = _NMAX,
                rate_cap: int = _RATE_CAP):
    """The generated machine: (prob [S], next0 [S], next1 [S]) int32,
    S = (nmax + 1) * pq_levels (32,768 at the defaults).  The arrays are
    cached: do not write to them."""
    S = (nmax + 1) * pq_levels
    shift = 15 - pq_levels.bit_length() + 1  # 15 -> 10 bits: >> 5
    prob = np.empty(S, np.int32)
    nxt0 = np.empty(S, np.int32)
    nxt1 = np.empty(S, np.int32)
    for n in range(nmax + 1):
        d = min(n + 2, rate_cap)
        n2 = min(n + 1, nmax)
        for pq in range(pq_levels):
            sid = n * pq_levels + pq
            p15 = (pq << shift) + (1 << (shift - 1))
            prob[sid] = min(TOTAL - 1, max(1, p15))
            p0 = p15 - -(-p15 // d)                 # toward 0, move >= 1
            p1 = p15 + -(-(TOTAL - p15) // d)       # toward 1, move >= 1
            pq0 = min(pq_levels - 1, max(0, p0 >> shift))
            pq1 = min(pq_levels - 1, max(0, p1 >> shift))
            nxt0[sid] = n2 * pq_levels + pq0
            nxt1[sid] = n2 * pq_levels + pq1
    return prob, nxt0, nxt1


def initial_state() -> int:
    """The state every node of a fresh table starts in: n = 0, p = 1/2."""
    return _PQ // 2


def parse_reference_format(text: str):
    """Parse TurboRC's FSM text format (lines of ``s1,s0,p``; shorter
    lines skipped) -> (prob, next0, next1) int32, as parsed."""
    s1s, s0s, ps = [], [], []
    for line in text.strip().splitlines():
        parts = line.replace(",", " ").split()
        if len(parts) < 3:
            continue
        s1, s0, p = (int(x) for x in parts[:3])
        s1s.append(s1)
        s0s.append(s0)
        ps.append(p)
    return (np.asarray(ps, np.int32), np.asarray(s0s, np.int32),
            np.asarray(s1s, np.int32))


def load_reference_table(text: str):
    """A TurboRC-format table with the reference loader's semantics: zero
    filled to N_STATES states, next states clamped to [0, N_STATES - 1],
    probabilities to [1, 2^15 - 1] -> (prob, next0, next1) int32
    [N_STATES], ``build_table``'s layout."""
    ps, s0s, s1s = parse_reference_format(text)
    k = min(ps.shape[0], N_STATES)
    prob = np.zeros(N_STATES, np.int32)
    nxt0 = np.zeros(N_STATES, np.int32)
    nxt1 = np.zeros(N_STATES, np.int32)
    prob[:k] = np.clip(ps[:k], 1, TOTAL - 1)
    nxt0[:k] = np.clip(s0s[:k], 0, N_STATES - 1)
    nxt1[:k] = np.clip(s1s[:k], 0, N_STATES - 1)
    return prob, nxt0, nxt1


def reference_initial_state() -> int:
    """The state every node starts in under a loaded reference table: 0."""
    return 0
