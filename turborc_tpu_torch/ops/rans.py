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
