"""Adaptive bit predictors, plain torch.

Counterpart of ``turborc_tpu/models/bitpred.py``.  A predictor keeps a
table of per-context counter state for each lane: ``[L, N]`` int32
(``DualSpeed``: ``[L, N, 2]``), N context slots.  ``predict(state, idx)``
reads slot ``idx[l]`` of lane l, ``update(state, idx, p, bit)`` writes
it after a bit is coded with the clamped probability ``p``.  ``idx`` is
``[L]`` or ``[L, M]``: M slots a lane at once, which must be distinct
within a lane (the decisions of a byte, one a tree depth); torch's
``>>`` on signed integers is arithmetic, as in the reference.  ``update``
writes the table in place and returns it.

- Simple ('s'): one 16-bit counter at rate 5;
    predict p, update p -= ((p - (bit ? 32768 : 0)) >> 5) + bit
  (p is the clamped prediction, not the stored counter).
- DualSpeed ('ss'): two 16-bit counters at rates (prm0, prm1);
    predict (c0 + c1) >> 2,
    update bit 1: c += (c ^ 0xFFFF) >> rate; bit 0: c -= c >> rate.
- Fsm ('sf'): a state id a slot over a shared state machine
  (``models/fsm.py``), as one int32 table ``[3, S]``: the probability of
  bit 1, the next state after a 0, the next state after a 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from turborc_tpu_torch.models import fsm

RC_BITS = 15
TOTAL = 1 << RC_BITS
MAX_RATE = 16  # a shift of a 16-bit counter by 16 or more gives 0


def _lanes(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The lane index of each entry of idx [L] or [L, M]."""
    lanes = torch.arange(table.shape[0], device=table.device)
    return lanes.view(-1, *[1] * (idx.dim() - 1))


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [L, N, ...], idx [L, ...] -> [L, ..., ...]."""
    return table[_lanes(table, idx), idx.to(torch.int64)]


def _scatter(table: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    table[_lanes(table, idx), idx.to(torch.int64)] = val.to(table.dtype)
    return table


@dataclasses.dataclass(frozen=True)
class Simple:
    """One counter a slot, rate 5."""
    rate: int = 5

    def init(self, L: int, N: int, device=None) -> torch.Tensor:
        return torch.full((L, N), TOTAL // 2, dtype=torch.int32,
                          device=device)

    def predict(self, state, idx):
        return _gather(state, idx)

    def update(self, state, idx, p, bit):
        b = bit.to(torch.int32)
        newp = p - (((p - (b << RC_BITS)) >> self.rate) + b)
        return _scatter(state, idx, newp)


@dataclasses.dataclass(frozen=True)
class DualSpeed:
    """Two counters a slot at rates rate0 and rate1 (the header's prm0 and
    prm1; the reference's defaults 5 and 8)."""
    rate0: int = 5
    rate1: int = 8

    def init(self, L: int, N: int, device=None) -> torch.Tensor:
        return torch.full((L, N, 2), 1 << 15, dtype=torch.int32,
                          device=device)

    def predict(self, state, idx):
        pq = _gather(state, idx)
        return (pq[..., 0] + pq[..., 1]) >> 2

    def update(self, state, idx, p, bit):
        pq = _gather(state, idx)
        rates = torch.tensor([min(self.rate0, MAX_RATE),
                              min(self.rate1, MAX_RATE)],
                             dtype=torch.int32, device=state.device)
        up = pq + ((pq ^ 0xFFFF) >> rates)
        down = pq - (pq >> rates)
        return _scatter(state, idx, torch.where(bit[..., None], up, down))


def fsm_table(device=None) -> torch.Tensor:
    """The generated machine (``fsm.build_table``) as int32 [3, S] on
    ``device``: rows prob, next0, next1."""
    return torch.from_numpy(np.stack(fsm.build_table())).to(device)


class Fsm:
    """A state id a slot over ``table`` [3, S] int32 (``fsm_table``'s
    rows); every slot starts in ``start`` (``fsm.initial_state()``, or
    ``fsm.reference_initial_state()`` for a loaded reference table)."""

    def __init__(self, table: torch.Tensor | None = None, device=None,
                 start: int | None = None):
        self.table = fsm_table(device) if table is None else table
        self.start = fsm.initial_state() if start is None else start

    def init(self, L: int, N: int, device=None) -> torch.Tensor:
        return torch.full((L, N), self.start, dtype=torch.int32,
                          device=device)

    def predict(self, state, idx):
        return self.table[0][_gather(state, idx).to(torch.int64)]

    def update(self, state, idx, p, bit):
        sid = _gather(state, idx).to(torch.int64)
        nxt = torch.where(bit, self.table[2][sid], self.table[1][sid])
        return _scatter(state, idx, nxt)


def make(name: str, prm0: int | None = None, prm1: int | None = None,
         device=None):
    """The predictor of ``name`` ('s', 'ss' at rates prm0 / prm1, default
    5 / 8, 'sf' over the generated machine on ``device``)."""
    if name == "s":
        return Simple()
    if name == "ss":
        return DualSpeed(5 if prm0 is None else prm0,
                         8 if prm1 is None else prm1)
    if name == "sf":
        return Fsm(device=device)
    raise ValueError(f"unknown predictor {name!r}")
