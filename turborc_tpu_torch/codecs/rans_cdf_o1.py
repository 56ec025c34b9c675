"""Adaptive-CDF rANS, order 1: rans-cdf-o1 (registry id 64).

Counterpart of ``turborc_tpu/codecs/rans_cdf_o1.py``; the payload is the
same bytes, the lane streams alone (``blockio.pack``: lengths [lanes]
<u2, then the words <u2).

The context of a byte is the lane's previous byte ``prev`` (0 before its
first): its hi nibble codes from hi row ``prev`` (256 rows), its lo
nibble from lo row ``prev * 16 + hi`` (4,096 rows), every row a CDF16
started at ``cdf16.init`` and adapted at rate 7 (the model is
``codecs/rans_cdf_r1.py``'s passes on ``BYTE_ROWS`` and
``byte_tables``).  So large a model
favours fewer, longer lanes: both sides code with ``min(lanes, LANE_CAP)``
lanes of contiguous spans, while the container header keeps the
caller's lane count.  L7 + L2 encode, L8 decodes
(``ops/rans_lane_o1_kernel.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
from turborc_tpu_torch.utils.config import resolve_device

LANE_CAP = 128  # a lane's model is 4,352 rows


def encode_block(data: np.ndarray, lanes: int = 64, step_quant: int = 256,
                 device=None, **_unused) -> bytes:
    dev = resolve_device(device)
    lanes = min(lanes, LANE_CAP)
    block, K = blockio.shape_block(data, lanes, step_quant)
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    probs = LO.lane_o1_model(cols)
    init = torch.full((lanes,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    return blockio.pack_device(*LK.lane_coder(probs, init))


def decode_block(payload: bytes, n: int, lanes: int = 64,
                 step_quant: int = 256, device=None,
                 **_unused) -> np.ndarray:
    dev = resolve_device(device)
    lanes = min(lanes, LANE_CAP)
    K = blockio.K_for(n, lanes, step_quant)
    words = blockio.push_words(payload, lanes, 2 * K + 2, dev)
    out = LO.lane_o1_decode(*words, K)
    return out.T.contiguous().cpu().numpy().reshape(-1)[:n]
