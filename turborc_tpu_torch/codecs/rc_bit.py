"""Bitwise byte-tree codecs: rc-o0 (registry id 1), rcc-o1 (id 2) and their
dual-speed (ids 101, 102) and FSM (ids 103, 104) predictor variants.

Counterpart of the byte-tree part of ``turborc_tpu/codecs/rc_bit.py``;
the payloads are the same bytes, the lane streams alone
(``blockio.pack``: lengths [lanes] <u2, then the words <u2).  A block is
``lanes`` contiguous chunks of K bytes; every lane codes its chunk as 8
binary decisions a byte, MSB first, down a 255-node tree of adaptive bit
predictors (``models/bitpred.py``) with its own rANS state: order 0 one
tree a lane, order 1 one tree for each previous byte (256).  The
dual-speed predictor codes at the header's rates ``prm0`` / ``prm1``; the
FSM predictor runs the generated machine of ``models/fsm.py``.  L11 + L2
encode (8K slots a lane, ``8K + 2`` stream words at most), L12 decodes
(``ops/rans_bit_kernel.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.models import bitpred
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_bit_kernel as BK
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.utils.config import resolve_device


def _make_block_api(order: int, pred_name: str):
    """(encode_block, decode_block) of the byte-tree codec of ``order``
    (0 or 1) on predictor ``pred_name`` ('s', 'ss' or 'sf')."""

    def encode_block(data: np.ndarray, lanes: int = 512,
                     step_quant: int = 256, prm0: int = 5, prm1: int = 8,
                     device=None, **_unused) -> bytes:
        dev = resolve_device(device)
        block, K = blockio.shape_block(data, lanes, step_quant)
        cols = torch.from_numpy(block).to(dev).T.contiguous()
        pred = bitpred.make(pred_name, prm0, prm1, dev)
        probs = BK.lane_bit_model(cols, order, pred)
        init = torch.full((lanes,), rans.ANS_LOW, dtype=torch.int32,
                          device=dev)
        return blockio.pack_device(*LK.lane_coder(probs, init))

    def decode_block(payload: bytes, n: int, lanes: int = 512,
                     step_quant: int = 256, prm0: int = 5, prm1: int = 8,
                     device=None, **_unused) -> np.ndarray:
        dev = resolve_device(device)
        K = blockio.K_for(n, lanes, step_quant)
        words = blockio.push_words(payload, lanes, 8 * K + 2, dev)
        pred = bitpred.make(pred_name, prm0, prm1, dev)
        out = BK.lane_bit_decode(*words, K, order, pred)
        return out.T.contiguous().cpu().numpy().reshape(-1)[:n]

    return encode_block, decode_block


rc_s_encode, rc_s_decode = _make_block_api(0, "s")
rcc_s_encode, rcc_s_decode = _make_block_api(1, "s")
rc_ss_encode, rc_ss_decode = _make_block_api(0, "ss")
rcc_ss_encode, rcc_ss_decode = _make_block_api(1, "ss")
rc_sf_encode, rc_sf_decode = _make_block_api(0, "sf")
rcc_sf_encode, rcc_sf_decode = _make_block_api(1, "sf")
