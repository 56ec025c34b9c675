"""Adaptive-CDF rANS with span-shared models, order 0: rans-cdf-s8
(registry id 58).

Counterpart of ``turborc_tpu/codecs/rans_cdf_s8.py``; the payload is the
same bytes:

    hi freqs [n_seg, 16] <u2       per-segment warm-start tables
    lo freqs [n_seg, 16, 16] <u2
    lengths [lanes] <u2            u16 words per lane stream
    words <u2                      the lane streams, each cut to its length

``share`` adjacent lanes model one contiguous ``share*K``-byte span, lane j
of the span taking bytes t*share + j; each lane updates its own table copy
at once, and the copies re-join every ``sync`` bytes (hi table, lo rows
< ``srows``) and every ``lsync`` bytes (rows ``srows .. arows-1``); rows
>= ``arows`` stay static.  The model's pieces are ``models/span.py``;
the passes are the lane kernels L1 + L2 (encode) and L3 (decode) of
``ops/rans_lane_kernel.py``.  As in the reference, the block API takes
``share``, ``sync``, ``lsync``, ``arows`` and ``rate`` from the geometry
and keeps ``srows`` at 4.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops.geom import Geom
from turborc_tpu_torch.utils.config import resolve_device

SHARE, SYNC, SROWS, LSYNC, AROWS = 8, 4, 4, 32, 16
N_SEG = 64     # warm-start table segments per block


def encode_device(block: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                  lo_tbl: torch.Tensor, geom: Geom):
    """block [M, K, share] uint8 -> (streams [L, 2K+2] int32, lengths
    [L] int32): L1 then L2.  Warm tables hi [n_seg, 16], lo [n_seg, 16,
    16] int32 cumulative."""
    M, _, share = block.shape
    L = M * share
    cols = block.permute(1, 0, 2).reshape(K, L).contiguous()
    probs = LK.lane_model(cols, hi_tbl, lo_tbl, geom)
    init = torch.full((L,), rans.ANS_LOW, dtype=torch.int32,
                      device=block.device)
    return LK.lane_coder(probs, init)


def decode_device(words: torch.Tensor, lengths: torch.Tensor, K: int,
                  hi_tbl: torch.Tensor, lo_tbl: torch.Tensor,
                  geom: Geom) -> torch.Tensor:
    """Lane streams (words [W] int16, lengths [L] int32, as the payload
    holds them) -> block [M, K, share] uint8 (L3)."""
    L = lengths.shape[0]
    out = LK.lane_decode(words, lengths, K, hi_tbl, lo_tbl, geom)
    return out.reshape(K, L // geom.share, geom.share).permute(1, 0, 2)


# ----------------------------------------------------------------------------
# Host block API
# ----------------------------------------------------------------------------

def segment_tables(data: np.ndarray, n_seg: int):
    """Per-segment warm-start nibble tables: ([n_seg,16], [n_seg,16,16])."""
    n = data.shape[0]
    his, los = [], []
    for g in range(n_seg):
        seg = data[g * n // n_seg:(g + 1) * n // n_seg]
        if seg.size == 0:
            seg = data
        hi_f, lo_f = blockio.nibble_tables(seg)
        his.append(hi_f)
        los.append(lo_f)
    return np.stack(his), np.stack(los)


def shape_spans(data: np.ndarray, lanes: int, step_quant: int,
                share: int = SHARE, lsync: int = LSYNC):
    """Pad + reshape flat bytes into [M, K, share] strided spans (uint8)."""
    M = lanes // share
    n = data.shape[0]
    K = blockio.K_for(-(-n // share), M, max(step_quant, lsync))
    padded = np.zeros(M * K * share, np.uint8)
    padded[:n] = data
    return padded.reshape(M, K, share), K


def _n_seg(lanes: int, share: int) -> int:
    return min(N_SEG, lanes // share)


def _geom(geom: Geom | None, share, sync, lsync, arows) -> Geom:
    """The model's geometry as the reference's block API takes it: all
    of it from ``geom`` when given, else the arguments or the defaults;
    ``srows`` always SROWS.  ``chunk`` plays no part in the lane model:
    ``chunk = sync`` admits every sync / lsync pair the arguments may
    give."""
    if geom is not None:
        return dataclasses.replace(geom, srows=SROWS)
    sync = SYNC if sync is None else sync
    return Geom(share=SHARE if share is None else share, chunk=sync,
                sync=sync, lsync=LSYNC if lsync is None else lsync,
                arows=AROWS if arows is None else arows, srows=SROWS)


def tables_on(hi_f: np.ndarray, lo_f: np.ndarray, dev):
    """Freq tables -> cumulative int32 tables on ``dev``."""
    return (torch.from_numpy(blockio.cumulative(hi_f)).to(dev),
            torch.from_numpy(blockio.cumulative(lo_f)).to(dev))


def check_tables(hi_f: np.ndarray, lo_f: np.ndarray) -> None:
    """Warm tables read from a payload: every row sums to 2^15 with no
    zero freq (the tables the encoder writes; the kernels' update needs
    a strictly increasing table)."""
    if (hi_f.sum(-1) != blockio.TOTAL).any() or \
            (lo_f.sum(-1) != blockio.TOTAL).any() or \
            (hi_f == 0).any() or (lo_f == 0).any():
        raise ValueError("corrupt payload: bad warm-start tables")


def encode_block(data: np.ndarray, lanes: int = 8192,
                 step_quant: int = 256, share: int | None = None,
                 sync: int | None = None, lsync: int | None = None,
                 arows: int | None = None, geom: Geom | None = None,
                 device=None, **_unused) -> bytes:
    dev = resolve_device(device)
    geom = _geom(geom, share, sync, lsync, arows)
    hi_f, lo_f = segment_tables(data, _n_seg(lanes, geom.share))
    block, K = shape_spans(data, lanes, step_quant, geom.share, geom.lsync)
    streams, lengths = encode_device(torch.from_numpy(block).to(dev), K,
                                     *tables_on(hi_f, lo_f, dev), geom)
    return (hi_f.astype("<u2").tobytes() + lo_f.astype("<u2").tobytes()
            + blockio.pack_device(streams, lengths))


def decode_block(payload: bytes, n: int, lanes: int = 8192,
                 step_quant: int = 256, share: int | None = None,
                 sync: int | None = None, lsync: int | None = None,
                 arows: int | None = None, geom: Geom | None = None,
                 device=None, **_unused) -> np.ndarray:
    dev = resolve_device(device)
    geom = _geom(geom, share, sync, lsync, arows)
    n_seg = _n_seg(lanes, geom.share)
    tbl = 2 * n_seg * (16 + 256)
    if len(payload) < tbl:
        raise ValueError("corrupt payload: truncated warm-start tables")
    hi_f = np.frombuffer(payload[:n_seg * 32], "<u2").astype(
        np.int64).reshape(n_seg, 16)
    lo_f = np.frombuffer(payload[n_seg * 32:tbl], "<u2").astype(
        np.int64).reshape(n_seg, 16, 16)
    check_tables(hi_f, lo_f)
    M = lanes // geom.share
    K = blockio.K_for(-(-n // geom.share), M, max(step_quant, geom.lsync))
    words = blockio.push_words(payload[tbl:], lanes, 2 * K + 2, dev)
    block = decode_device(*words, K, *tables_on(hi_f, lo_f, dev), geom)
    return block.contiguous().cpu().numpy().reshape(-1)[:n]
