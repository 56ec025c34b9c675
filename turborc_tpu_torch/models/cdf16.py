"""Adaptive CDF16 probability model, plain torch.

Counterpart of ``turborc_tpu/models/cdf16.py``.  A table is 16 cumulative
entries ``cdf[0..15]`` (``cdf[0]`` stays 0; the implicit ``cdf[16]`` is
``TOTAL``), ``freq(x) = cdf[x+1] - cdf[x]``.  After coding a symbol whose
cumulative value is ``low``, every entry moves toward a staircase:

    cdf_i += (i*IC - cdf_i + (cdf_i > low ? MIXD : 0)) >> rate

where ``>>`` is an arithmetic shift of a possibly negative value (torch's
``>>`` on signed integers is arithmetic).  The update is followed by a
strict-monotone repair and an upper clamp, both the identity on healthy
tables at rate >= 7.  All values stay in [0, 32767].
"""
from __future__ import annotations

import numpy as np
import torch

RC_BITS = 15
TOTAL = 1 << RC_BITS  # 32768
CDFRATE = 7
IC = 10
MIXD = (TOTAL - 1) & ~((1 << 5) - 1)  # 32736


def init(shape=(), device=None) -> torch.Tensor:
    """Fresh table(s): cdf[j] = j << (RC_BITS-4), shape [..., 16] int32."""
    base = torch.arange(16, dtype=torch.int32, device=device) << (RC_BITS - 4)
    return base.expand(*tuple(shape), 16)


def init_np(shape=()) -> np.ndarray:
    base = np.arange(16, dtype=np.int32) << (RC_BITS - 4)
    return np.broadcast_to(base, tuple(shape) + (16,)).copy()


def _iota(cdf: torch.Tensor) -> torch.Tensor:
    return torch.arange(16, dtype=cdf.dtype, device=cdf.device)


def _repair(cdf: torch.Tensor) -> torch.Tensor:
    """Strictly-increasing projection: cdf_i = max_{j<=i}(cdf_j - j) + i."""
    i16 = _iota(cdf)
    return torch.cummax(cdf - i16, dim=-1).values + i16


def clamp_top(cdf: torch.Tensor) -> torch.Tensor:
    """Upper strict-monotone clamp: cdf_i <= TOTAL-16+i (freq >= 1 at the
    top of the table)."""
    return torch.minimum(cdf, _iota(cdf) + (TOTAL - 16))


def lookup(cdf: torch.Tensor, sym: torch.Tensor):
    """(low, freq) of symbol ``sym``; cdf [..., 16], sym [...]."""
    nxt = torch.cat([cdf[..., 1:], torch.full_like(cdf[..., :1], TOTAL)], -1)
    idx = sym.unsqueeze(-1).to(torch.int64)
    low = torch.gather(cdf, -1, idx).squeeze(-1)
    return low, torch.gather(nxt, -1, idx).squeeze(-1) - low


def search(cdf: torch.Tensor, value: torch.Tensor):
    """Decode-side symbol search: sym = count of cdf[i] <= value over
    i = 1..15.  Returns (sym, low, freq)."""
    sym = (cdf[..., 1:] <= value.unsqueeze(-1)).sum(-1)
    low, freq = lookup(cdf, sym)
    return sym, low, freq


def delta(cdf: torch.Tensor, low: torch.Tensor,
          rate: int = CDFRATE) -> torch.Tensor:
    """Single-symbol update delta: (staircase target - cdf) >> rate."""
    mask = cdf > low.unsqueeze(-1)
    tgt = _iota(cdf) * IC - cdf + torch.where(mask, MIXD, 0)
    return tgt >> rate


def update_rate(cdf: torch.Tensor, low: torch.Tensor,
                rate: int = CDFRATE) -> torch.Tensor:
    """Adapt after coding a symbol whose cumulative value is ``low``."""
    return clamp_top(_repair(cdf + delta(cdf, low, rate)))


def update(cdf: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """``update_rate`` at the default rate 7."""
    return update_rate(cdf, low, CDFRATE)
