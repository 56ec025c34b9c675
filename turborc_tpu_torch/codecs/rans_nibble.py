"""4-bit symbol codecs: rc4 (registry id 41, adaptive) and rc4c (id 40,
static).

Counterpart of ``turborc_tpu/codecs/rans_nibble.py``; the payloads are
the same bytes.  A block's bytes become a nibble stream, hi then lo, two
4-bit symbols a byte, and every lane codes its chunk of K bytes as 2K
symbols with its own rANS state (``2K + 2`` stream words at most):

  rc4:  one CDF16 a lane from ``cdf16.init``, adapted at rate 7 after
        every nibble; the payload is the lane streams alone
        (``blockio.pack``: lengths [lanes] <u2, then the words <u2).
        L9 + L2 encode, L10 decodes.
  rc4c: one CDF16 for the block, from its nibble histogram (+1 to every
        count, so the zero padding nibbles stay codeable), shared by all
        lanes; the payload is its 16 freqs <u2 (32 B), then the lane
        streams.  A torch gather of each nibble's ``(low << 16) | freq``
        + L2 encode (id 42's route), L10's static instantiation decodes.
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs.rans_static import slot_probs
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops import rans_nibble_kernel as NK
from turborc_tpu_torch.utils.config import resolve_device

RC_BITS = 15
TOTAL = 1 << RC_BITS
_FREQ_BYTES = 32


def build_nibble_freqs(data: np.ndarray) -> np.ndarray:
    """Nibble histogram -> 16 freqs summing 2^15, every freq >= 1: +1 to
    every count, ``max(1, h * (2^15 - 16) // n)``, the remainder at the
    most frequent nibble (the first of equals).  The counts of the hi and
    the lo nibbles come from one byte histogram (its rows and columns),
    not from the 2n nibbles."""
    joint = np.bincount(data, minlength=256).reshape(16, 16)
    h = (joint.sum(axis=1) + joint.sum(axis=0)).astype(np.int64) + 1
    n = h.sum()
    f = np.maximum(1, h * (TOTAL - 16) // n)
    f[np.argmax(h)] += TOTAL - f.sum()
    assert f.sum() == TOTAL and (f >= 1).all()
    return f.astype(np.uint16)


def _cols(data: np.ndarray, lanes: int, step_quant: int, dev):
    """The block as bytes [K, L] on ``dev``."""
    block, _ = blockio.shape_block(data, lanes, step_quant)
    return torch.from_numpy(block).to(dev).T.contiguous()


def _encode(probs: torch.Tensor, lanes: int, dev) -> bytes:
    init = torch.full((lanes,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    return blockio.pack_device(*LK.lane_coder(probs, init))


def encode_block(data: np.ndarray, lanes: int = 512, step_quant: int = 256,
                 device=None, **_unused) -> bytes:
    """rc4: one block -> the lane streams."""
    dev = resolve_device(device)
    cols = _cols(data, lanes, step_quant, dev)
    return _encode(NK.lane_nibble_model(cols), lanes, dev)


def decode_block(payload: bytes, n: int, lanes: int = 512,
                 step_quant: int = 256, device=None,
                 **_unused) -> np.ndarray:
    dev = resolve_device(device)
    K = blockio.K_for(n, lanes, step_quant)
    words = blockio.push_words(payload, lanes, 2 * K + 2, dev)
    out = NK.lane_nibble_decode(*words, K)
    return out.T.contiguous().cpu().numpy().reshape(-1)[:n]


def _cdf(freqs: np.ndarray) -> np.ndarray:
    cdf = np.zeros(17, np.int32)
    np.cumsum(freqs, out=cdf[1:])
    return cdf


def encode_block_static(data: np.ndarray, lanes: int = 512,
                        step_quant: int = 256, device=None,
                        **_unused) -> bytes:
    """rc4c: one block -> its 16 nibble freqs, then the lane streams."""
    dev = resolve_device(device)
    freqs = build_nibble_freqs(data)
    cols = _cols(data, lanes, step_quant, dev)
    probs = slot_probs(NK.nibbles(cols), torch.from_numpy(_cdf(freqs)).to(dev))
    return freqs.astype("<u2").tobytes() + _encode(probs, lanes, dev)


def decode_block_static(payload: bytes, n: int, lanes: int = 512,
                        step_quant: int = 256, device=None,
                        **_unused) -> np.ndarray:
    dev = resolve_device(device)
    K = blockio.K_for(n, lanes, step_quant)
    if len(payload) < _FREQ_BYTES:
        raise ValueError("corrupt payload: truncated static nibble CDF")
    freqs = np.frombuffer(payload[:_FREQ_BYTES], "<u2").astype(np.int64)
    if freqs.sum() != TOTAL:
        raise ValueError("corrupt payload: bad static nibble CDF")
    words = blockio.push_words(payload[_FREQ_BYTES:], lanes, 2 * K + 2, dev)
    out = NK.lane_nibble_static_decode(
        *words, K, torch.from_numpy(_cdf(freqs)).to(dev))
    return out.T.contiguous().cpu().numpy().reshape(-1)[:n]
