"""Adaptive-CDF rANS, order 0, nibble-pair byte model: rans-cdf-o0
(registry id 56, ``CodecConfig``'s default codec).

Counterpart of ``turborc_tpu/codecs/rans_cdf_o0.py``; the payload is the
same bytes:

    hi freqs [16] <u2, lo freqs [16, 16] <u2   warm-start tables (544 B)
    lengths [lanes] <u2                        u16 words per lane stream
    words <u2                                  the lane streams

A block of n bytes is ``lanes`` contiguous chunks of K bytes; every lane
codes its chunk with its own adaptive model pair (hi nibble from one
CDF16, lo nibble from the CDF16 of its hi nibble), started from the
block's warm tables, and its own rANS state.  That is the span model of
``rans-cdf-s8`` at ``share = 1`` with one segment, so it runs on the same
lane kernels: L1 + L2 encode, L3 decode (``ops/rans_lane_kernel.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs.rans_cdf_s8 import check_tables, tables_on
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.utils.config import resolve_device

_TBL_BYTES = 2 * (16 + 256)


def encode_block(data: np.ndarray, lanes: int = 512,
                 step_quant: int = 256, device=None, **_unused) -> bytes:
    """Encode one block -> payload: warm-start tables (544 B) + lane
    lengths + stitched streams."""
    dev = resolve_device(device)
    hi_f, lo_f = blockio.nibble_tables(data)
    block, K = blockio.shape_block(data, lanes, step_quant)
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    hi, lo = tables_on(hi_f[None], lo_f[None], dev)
    probs = LK.lane_model(cols, hi, lo, LK.PER_LANE)
    init = torch.full((lanes,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    streams, lengths = LK.lane_coder(probs, init)
    return (hi_f.astype("<u2").tobytes() + lo_f.astype("<u2").tobytes()
            + blockio.pack_device(streams, lengths))


def decode_block(payload: bytes, n: int, lanes: int = 512,
                 step_quant: int = 256, device=None,
                 **_unused) -> np.ndarray:
    """Decode one block payload back to n bytes."""
    dev = resolve_device(device)
    if len(payload) < _TBL_BYTES:
        raise ValueError("corrupt payload: truncated warm-start tables")
    hi_f = np.frombuffer(payload[:32], "<u2").astype(np.int64)
    lo_f = np.frombuffer(payload[32:_TBL_BYTES], "<u2").astype(
        np.int64).reshape(16, 16)
    check_tables(hi_f, lo_f)
    K = blockio.K_for(n, lanes, step_quant)
    words = blockio.push_words(payload[_TBL_BYTES:], lanes, 2 * K + 2, dev)
    hi, lo = tables_on(hi_f[None], lo_f[None], dev)
    out = LK.lane_decode(*words, K, hi, lo, LK.PER_LANE)
    return out.T.contiguous().cpu().numpy().reshape(-1)[:n]
