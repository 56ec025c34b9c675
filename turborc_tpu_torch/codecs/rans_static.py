"""Static-CDF byte rANS: rans-static (registry id 42).

Counterpart of ``turborc_tpu/codecs/rans_static.py``; the payload is the
same bytes:

    freqs [256] <u2        the block's byte frequencies, summing 2^15
    lengths [lanes] <u2    u16 words per lane stream
    words <u2              the lane streams

The CDF is built from the block histogram on the host and shared by all
lanes, so the encode model is one gather of each byte's (low, freq) from
the 257-entry table (a torch gather, as the reference's is an XLA one);
the backward coding pass is the lane kernel L2 and the decode L4
(``ops/rans_lane_kernel.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.utils.config import resolve_device

RC_BITS = 15
TOTAL = 1 << RC_BITS


def build_freqs(data: np.ndarray) -> np.ndarray:
    """Normalize a byte histogram to sum 2^15 with freq>=1 for present
    symbols (the reference's cdfini semantics; the exact scheme is the
    JAX package's)."""
    h = np.bincount(data, minlength=256).astype(np.int64)
    n = h.sum()
    if n == 0:
        f = np.zeros(256, np.int64)
        f[0] = TOTAL
        return f.astype(np.uint16)
    f = np.where(h > 0, np.maximum(1, h * (TOTAL - 256) // n), 0)
    # distribute the remainder to the most frequent symbol
    f[np.argmax(h)] += TOTAL - f.sum()
    assert f.sum() == TOTAL and (f[h > 0] >= 1).all()
    return f.astype(np.uint16)


def _cdf(freqs: np.ndarray) -> np.ndarray:
    cdf = np.zeros(257, np.int32)
    np.cumsum(freqs, out=cdf[1:])
    return cdf


def slot_probs(cols: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Bytes [K, L] -> slot probs [K, L] int32, (low << 16) | freq of each
    byte from the 257-entry cdf: the encode model, one gather."""
    c = cdf.to(torch.int64)
    sym = cols.to(torch.int64)
    return ((c[sym] << 16) | (c[sym + 1] - c[sym])).to(torch.int32)


def encode_block(data: np.ndarray, lanes: int = 512, step_quant: int = 256,
                 device=None, **_unused) -> bytes:
    dev = resolve_device(device)
    freqs = build_freqs(data)
    block, K = blockio.shape_block(data, lanes, step_quant)
    # padding bytes are 0; guarantee symbol 0 is codeable
    if data.shape[0] < lanes * K and freqs[0] == 0:
        freqs = freqs.copy()
        src = int(np.argmax(freqs))
        freqs[src] -= 1
        freqs[0] = 1
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    probs = slot_probs(cols, torch.from_numpy(_cdf(freqs)).to(dev))
    init = torch.full((lanes,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    streams, lengths = LK.lane_coder(probs, init)
    return freqs.astype("<u2").tobytes() + blockio.pack_device(streams,
                                                                lengths)


def decode_block(payload: bytes, n: int, lanes: int = 512,
                 step_quant: int = 256, device=None,
                 **_unused) -> np.ndarray:
    dev = resolve_device(device)
    K = blockio.K_for(n, lanes, step_quant)
    freqs = np.frombuffer(payload[:512], "<u2").astype(np.int64)
    if freqs.sum() != TOTAL:
        raise ValueError("corrupt payload: bad static CDF table")
    cdf = torch.from_numpy(_cdf(freqs)).to(dev)
    words = blockio.push_words(payload[512:], lanes, 2 * K + 2, dev)
    out = LK.lane_static_decode(*words, K, cdf)
    return out.T.contiguous().cpu().numpy().reshape(-1)[:n]
