"""Lane-parallel rANS core, plain torch.

Counterpart of ``turborc_tpu/ops/rans.py``: 32-bit state, 16-bit renorm
words, 15-bit probabilities, state lower bound ``ANS_LOW = 2^15``.

  encode step: if state >= freq << 16: emit state & 0xFFFF, state >>= 16
               state = (state / freq) << 15 + state % freq + low
  decode step: value = state & 0x7FFF
               state = freq * (state >> 15) + value - low
               if state < ANS_LOW: state = state << 16 | next word

torch has no usable uint32 arithmetic, so the state rides in int64 and
every result is cut to 32 bits: the values, and what a corrupt stream
does to them, are those of the uint32 reference.
"""
from __future__ import annotations

import torch

ANS_BITS = 15
ANS_LOW = 1 << 15
MASK15 = (1 << 15) - 1
MASK16 = (1 << 16) - 1
MASK32 = (1 << 32) - 1


def enc_step(state: torch.Tensor, low: torch.Tensor, freq: torch.Tensor):
    """One encode step over all lanes -> (state', word, emit)."""
    emit = state >= (freq << 16)
    word = state & MASK16
    state = torch.where(emit, state >> 16, state)
    q = torch.div(state, freq, rounding_mode="floor")
    state = ((q << ANS_BITS) + (state - q * freq) + low) & MASK32
    return state, word, emit


def encode_backward(lows: torch.Tensor, freqs: torch.Tensor,
                    init_state: torch.Tensor | None = None):
    """Backward coding pass over per-symbol probabilities.

    lows/freqs [S, L] (s ascending = decode order); init_state [L]
    (>= ANS_LOW, the state seeds) or None for ANS_LOW.  Returns
    (words [S, L], emit [S, L] bool, state [L]) as int64/bool."""
    S, L = lows.shape
    lows = lows.to(torch.int64)
    freqs = freqs.to(torch.int64)
    if init_state is None:
        state = torch.full((L,), ANS_LOW, dtype=torch.int64,
                           device=lows.device)
    else:
        state = init_state.to(torch.int64).reshape(L) & MASK32
    words = torch.empty((S, L), dtype=torch.int64, device=lows.device)
    emit = torch.empty((S, L), dtype=torch.bool, device=lows.device)
    for t in range(S - 1, -1, -1):
        state, words[t], emit[t] = enc_step(state, lows[t], freqs[t])
    return words, emit, state


def dec_update(state: torch.Tensor, low: torch.Tensor, freq: torch.Tensor):
    """State transition after the symbol search (no renorm)."""
    value = state & MASK15
    return (freq * (state >> ANS_BITS) + value - low) & MASK32


def dec_renorm(state: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """Lanes with state < ANS_LOW take ``word`` (state << 16 | word)."""
    return torch.where(state < ANS_LOW, ((state << 16) | word) & MASK32,
                       state)


def stitch(words: torch.Tensor, emit: torch.Tensor, state: torch.Tensor):
    """Compact per-step emissions into per-lane streams.

    words/emit [S, L] (symbol-time major), state [L] (the final states,
    flushed as 2 words).  Returns (streams [L, S+2] int32, lengths [L]
    int32): a lane's stream is [state hi16, state lo16, its words in
    forward-decode order], zero past its length (in u16 words)."""
    S, L = words.shape
    e = emit.to(torch.int64)
    pos = 2 + torch.cumsum(e, 0) - e
    lane = torch.arange(L, device=words.device).expand(S, L)
    m = emit.to(torch.bool)
    out = torch.zeros((L, S + 2), dtype=torch.int32, device=words.device)
    out[lane[m], pos[m]] = words[m].to(torch.int32)
    st = state.to(torch.int64) & MASK32
    out[:, 0] = (st >> 16).to(torch.int32)
    out[:, 1] = (st & MASK16).to(torch.int32)
    return out, (2 + e.sum(0)).to(torch.int32)


def dec_init(streams: torch.Tensor):
    """Read the 2 flush words per lane -> (state [L] int64, pos [L])."""
    s = streams.to(torch.int64)
    state = ((s[:, 0] << 16) | s[:, 1]) & MASK32
    return state, torch.full_like(state, 2)


# ----------------------------------------------------------------------------
# Scalar executable spec (single lane, python ints) - golden model for tests
# ----------------------------------------------------------------------------

class ScalarEncoder:
    """Single-lane rANS encoder mirroring the vectorized semantics."""

    def __init__(self):
        self.pending = []  # (low, freq) in forward symbol order

    def put(self, low: int, freq: int):
        self.pending.append((low, freq))

    def flush(self) -> list[int]:
        """Run the backward pass; return u16 words in forward-decode order."""
        state = ANS_LOW
        words_rev = []  # emission order (= reverse decode order)
        for low, freq in reversed(self.pending):
            if state >= (freq << 16):
                words_rev.append(state & MASK16)
                state >>= 16
            q, r = divmod(state, freq)
            state = (q << ANS_BITS) + r + low
        words = [state >> 16, state & MASK16]
        words.extend(reversed(words_rev))
        return words


class ScalarDecoder:
    """Single-lane rANS decoder over a u16 word list."""

    def __init__(self, words):
        self.words = list(words)
        self.state = (self.words[0] << 16) | self.words[1]
        self.pos = 2

    def value(self) -> int:
        return self.state & MASK15

    def advance(self, low: int, freq: int):
        value = self.state & MASK15
        self.state = freq * (self.state >> ANS_BITS) + value - low
        if self.state < ANS_LOW:
            self.state = (self.state << 16) | self.words[self.pos]
            self.pos += 1
