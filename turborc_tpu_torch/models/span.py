"""Span-shared adaptive CDF16 model pieces, plain torch.

Counterpart of the model half of ``turborc_tpu/codecs/rans_cdf_s8.py``,
shared by the plain versions of the o0 kernels (``ops/rans_kernel.py``,
``ops/rans_lane_kernel.py``).
``share`` adjacent lanes share one adaptive model pair over a contiguous
span: each lane updates its own table copy at once with its own symbols,
and every ``sync`` bytes the copies re-join as start + the sum of every
copy's diff since the last re-join.  Per-lane tables: hi [L, 16],
lo [L, 16, 16] (row = the hi nibble).
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.models import cdf16


def _lo_row(cdf_lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    idx = hi.to(torch.int64)[:, None, None].expand(-1, 1, 16)
    return torch.gather(cdf_lo, 1, idx).squeeze(1)


def _lo_put(cdf_lo: torch.Tensor, hi: torch.Tensor,
            row_new: torch.Tensor) -> torch.Tensor:
    idx = hi.to(torch.int64)[:, None, None].expand(-1, 1, 16)
    return cdf_lo.scatter(1, idx, row_new.unsqueeze(1))


def _sync(cdf: torch.Tensor, start: torch.Tensor, share: int) -> torch.Tensor:
    """Re-join share table copies: start + sum of per-copy diffs.

    The result is repaired and clamped.  That is load-bearing: rows left
    unrepaired feed the repair lift back into the next diff sum, a
    positive feedback of factor ``share`` that balloons the tables (the
    TPU kernel's note at rans_kernel.py:515-524 measured 27.4% -> 40.7%).
    """
    L = cdf.shape[0]
    M = L // share
    tail = cdf.shape[1:]
    d = (cdf - start).reshape(M, share, *tail).sum(dim=1, keepdim=True)
    new = cdf16.clamp_top(cdf16._repair(start.reshape(M, share, *tail) + d))
    return new.expand(M, share, *tail).reshape(L, *tail)


def _hot_mask(srows: int, device) -> torch.Tensor:
    """[1, 16, 1] bool: lo rows < srows (re-join at the fast cadence)."""
    return (torch.arange(16, device=device) < srows)[None, :, None]


def _sync_lo_hot(cdf_lo, start_lo, share: int, srows: int):
    """Hot-row re-join: rows < srows; cold rows keep their copies."""
    joined = _sync(cdf_lo, start_lo, share)
    hot = _hot_mask(srows, cdf_lo.device)
    return (torch.where(hot, joined, cdf_lo),
            torch.where(hot, joined, start_lo))


def _sync_lo_cold(cdf_lo, start_lo, share: int, srows: int):
    """Cold-row re-join at the lsync boundary (rows >= srows)."""
    joined = _sync(cdf_lo, start_lo, share)
    return torch.where(_hot_mask(srows, cdf_lo.device), cdf_lo, joined)


def _code_byte(cdf_hi, cdf_lo, b, arows: int, rate: int = cdf16.CDFRATE):
    """One per-lane nibble-pair step for known bytes ``b`` [L] (immediate
    own update).  Returns (cdf_hi, cdf_lo, low_h, fr_h, low_l, fr_l)."""
    hi, lo = b >> 4, b & 15
    low_h, fr_h = cdf16.lookup(cdf_hi, hi)
    cdf_hi = cdf16.update_rate(cdf_hi, low_h, rate)
    row = _lo_row(cdf_lo, hi)
    low_l, fr_l = cdf16.lookup(row, lo)
    new_row = cdf16.update_rate(row, low_l, rate)
    if arows < 16:  # static cold rows: no update when hi >= arows
        new_row = torch.where((hi < arows)[:, None], new_row, row)
    cdf_lo = _lo_put(cdf_lo, hi, new_row)
    return cdf_hi, cdf_lo, low_h, fr_h, low_l, fr_l
