"""Order-1 adaptive-CDF rANS on rank-quantized contexts, per-lane scan:
rans-cdf-r1 (registry id 59).

Counterpart of the block API of ``turborc_tpu/codecs/rans_cdf_r1.py``;
the model (contexts, warm tables, passes) is the port's
``codecs/rans_cdf_r1.py``, shared with id 60.  The payload is the JAX
package's bytes:

    perm [256] u8      byte permutation by frequency rank
    pack_codes(...)    per-segment warm tables ([n_seg, 1792] codes)
    lengths [lanes] <u2, words <u2    the lane streams (blockio.pack)

Lane l codes the contiguous span l of K = ``K_for(n, lanes, step_quant)``
rank-remapped bytes (padded with rank 0 after the remap), from the warm
tables of segment ``l * n_seg // lanes``, n_seg = ``n_segments(n,
lanes)``, at rate 7; L5 + L2 encode, L6 decodes
(``ops/rans_lane_o1_kernel.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.codecs.rans_cdf_o0_p import _rank_perm
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops import rans_lane_o1_kernel as LO
from turborc_tpu_torch.utils.config import resolve_device


def segment_cdfs(hi_q: np.ndarray, lo_q: np.ndarray, device):
    """Dequantized segment freqs [n_seg, R, 16] -> cumulative int32
    tensors on ``device`` (L5's and L6's tables)."""
    return tuple(torch.from_numpy(blockio.cumulative(q)).to(device)
                 for q in (hi_q, lo_q))


class EncodeArgs(NamedTuple):
    """What L5 and L2 take for one block (see ``encode_args``)."""
    perm: np.ndarray       # [256] u8 rank permutation
    codes: np.ndarray      # [n_seg, 1792] u8 warm-table codes
    cols: torch.Tensor     # [K, L] u8 remapped bytes, lane l's span l
    hi_tbl: torch.Tensor   # [n_seg, 64, 16] int32 warm cdfs
    lo_tbl: torch.Tensor   # [n_seg, 48, 16] int32 warm cdfs


def encode_args(data: np.ndarray, lanes: int, step_quant: int,
                device) -> EncodeArgs:
    """Host half of ``encode_block``: rank remap, padding with rank 0,
    the segments' conditional warm tables, the block on ``device``."""
    n = data.shape[0]
    perm = _rank_perm(data) if n else np.arange(256, dtype=np.uint8)
    inv = np.zeros(256, np.uint8)
    inv[perm] = np.arange(256, dtype=np.uint8)
    K = blockio.K_for(n, lanes, step_quant)
    padded = np.zeros(lanes * K, np.uint8)
    padded[:n] = inv[data]
    codes, (hi_q, lo_q) = R1.quantize_tables(
        *R1.group_tables(padded, R1.n_segments(n, lanes)))
    cols = torch.from_numpy(padded.reshape(lanes, K)).to(device).T
    return EncodeArgs(perm, codes, cols.contiguous(),
                      *segment_cdfs(hi_q, lo_q, device))


def encode_block(data: np.ndarray, lanes: int = 8192,
                 step_quant: int = 256, device=None, **_unused) -> bytes:
    dev = resolve_device(device)
    a = encode_args(data, lanes, step_quant, dev)
    probs = LO.lane_o1r_model(a.cols, a.hi_tbl, a.lo_tbl)
    init = torch.full((lanes,), rans.ANS_LOW, dtype=torch.int32, device=dev)
    streams, lengths = LK.lane_coder(probs, init)
    return (a.perm.tobytes() + blockio.pack_codes(a.codes)
            + blockio.pack_device(streams, lengths))


def decode_block(payload: bytes, n: int, lanes: int = 8192,
                 step_quant: int = 256, device=None,
                 **_unused) -> np.ndarray:
    dev = resolve_device(device)
    if len(payload) < 256 + 4 + R1.N_ENTRIES:
        raise ValueError("corrupt payload: truncated header")
    perm = np.frombuffer(payload[:256], np.uint8)
    codes, consumed = blockio.unpack_codes(
        payload[256:], R1.n_segments(n, lanes), n_entries=R1.N_ENTRIES)
    K = blockio.K_for(n, lanes, step_quant)
    words = blockio.push_words(payload[256 + consumed:], lanes, 2 * K + 2,
                               dev)
    out = LO.lane_o1r_decode(*words, K,
                             *segment_cdfs(*R1.codes_to_tables(codes), dev))
    return perm[out.T.contiguous().cpu().numpy().reshape(-1)[:n]]
