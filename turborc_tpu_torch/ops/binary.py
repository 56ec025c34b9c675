"""Binary (bitwise) coding on the lane-parallel rANS core, plain torch.

Counterpart of ``turborc_tpu/ops/binary.py``.  A bit is coded with a
15-bit probability p = P(bit = 1), bit 1 owning the low interval:

    bit 1 -> (low 0, freq p),  bit 0 -> (low p, freq 2^15 - p)

and decoded as ``bit = (state & MASK15) < p``.
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.ops import rans

TOTAL = 1 << 15


def to_low_freq(p15: torch.Tensor, bit: torch.Tensor):
    """(low, freq) of coding ``bit`` with probability p15 of bit 1."""
    low = torch.where(bit, 0, p15)
    freq = torch.where(bit, p15, TOTAL - p15)
    return low, freq


def dec_bit(state: torch.Tensor, p15: torch.Tensor):
    """Decode one bit on every lane (no renorm) -> (bit, state')."""
    value = state & rans.MASK15
    bit = value < p15
    low, freq = to_low_freq(p15.to(state.dtype), bit)
    return bit, rans.dec_update(state, low, freq)


def clamp_p(p15: torch.Tensor) -> torch.Tensor:
    """Keep a probability codeable: freq >= 1 on both branches."""
    return torch.clamp(p15, 1, TOTAL - 1)
