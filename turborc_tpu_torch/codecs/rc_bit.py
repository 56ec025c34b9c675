"""Bitwise tree codecs: the byte trees rc-o0 (registry id 1), rcc-o1 (id 2),
rcc2 (id 3) and the dual-speed (ids 101, 102) and FSM (ids 103, 104)
predictor variants; ansb (id 66), id 1 on 64 KB sub-blocks; and the W-bit
trees rc-16 (id 6) and rc{W}b (ids 142-152).

Counterpart of ``turborc_tpu/codecs/rc_bit.py``; the payloads are the same
bytes, the lane streams alone (``blockio.pack``: lengths [lanes] <u2, then
the words <u2; ansb's sub-payloads each after a <u4 length).  A block is
``lanes`` contiguous chunks of K elements; every lane codes its chunk as W
binary decisions an element, MSB first, down a tree of adaptive bit
predictors (``models/bitpred.py``) with its own rANS state: the byte tree
(W = 8) at order 0 one tree a lane, at order 1 one for each previous byte
(256), at order 2 one for each pair of previous bytes (65,536: 64 MB of
slots a lane, so rcc2 codes at most 16 lanes); a W-bit tree one a lane.
The dual-speed predictor codes at the header's rates ``prm0`` / ``prm1``;
the FSM predictor runs the generated machine of ``models/fsm.py``.  L11 +
L2 encode (W K slots a lane, ``W K + 2`` stream words at most), L12
decodes (``ops/rans_bit_kernel.py``).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.models import bitpred
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_bit_kernel as BK
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.utils.config import resolve_device


def _encode(cols: torch.Tensor, order: int, pred, W: int = 8):
    """Lane streams (streams [L, M] int32, lengths [L] int32) of cols [K,
    L] on their device: L11, then L2 from the rANS states' start."""
    probs = BK.lane_bit_model(cols, order, pred, W)
    init = torch.full((cols.shape[1],), rans.ANS_LOW, dtype=torch.int32,
                      device=cols.device)
    return LK.lane_coder(probs, init)


def _make_block_api(order: int, pred_name: str):
    """(encode_block, decode_block) of the byte-tree codec of ``order``
    (0, 1 or 2) on predictor ``pred_name`` ('s', 'ss' or 'sf')."""

    def encode_block(data: np.ndarray, lanes: int = 512,
                     step_quant: int = 256, prm0: int = 5, prm1: int = 8,
                     device=None, **_unused) -> bytes:
        dev = resolve_device(device)
        block, K = blockio.shape_block(data, lanes, step_quant)
        cols = torch.from_numpy(block).to(dev).T.contiguous()
        pred = bitpred.make(pred_name, prm0, prm1, dev)
        return blockio.pack_device(*_encode(cols, order, pred))

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
_rcc2_encode, _rcc2_decode = _make_block_api(2, "s")

# rcc2's full 2^16 x 256 tables: at most 16 lanes (1 GB of slots)
RCC2_LANES = 16


def rcc2_encode(data, lanes=16, **kw):
    kw.pop("step_quant", None)
    return _rcc2_encode(data, lanes=min(lanes, RCC2_LANES), step_quant=256,
                        **kw)


def rcc2_decode(payload, n, lanes=16, **kw):
    kw.pop("step_quant", None)
    return _rcc2_decode(payload, n, lanes=min(lanes, RCC2_LANES),
                        step_quant=256, **kw)


# ansb codes 64 KB sub-blocks whatever the container's block size, each as
# id 1 at 4 lanes and step_quant 256, framed by a <u4 length.  The
# sub-blocks of one K are independent lane sets, so they go through one
# launch of L11 + L2 (L12), on 4 lanes each, padded with empty lanes to a
# power of two, and the streams are split after.
ANSB_BLOCK = 1 << 16
ANSB_LANES = 4
ANSB_STEP = 256


def _ansb_launch_lanes(n_sub: int) -> int:
    return 1 << max(ANSB_LANES * n_sub - 1, 0).bit_length()


def _by_K(sizes: list) -> dict:
    """{K: [sub-block index, ...]} of sub-blocks of ``sizes`` bytes."""
    groups = {}
    for i, m in enumerate(sizes):
        groups.setdefault(blockio.K_for(m, ANSB_LANES, ANSB_STEP),
                          []).append(i)
    return groups


def ansb_encode(data: np.ndarray, lanes: int = 4, device=None,
                **_unused) -> bytes:
    dev = resolve_device(device)
    subs = [data[off:off + ANSB_BLOCK]
            for off in range(0, max(data.shape[0], 1), ANSB_BLOCK)]
    payloads = [b""] * len(subs)
    for K, idx in _by_K([s.shape[0] for s in subs]).items():
        block = np.zeros((_ansb_launch_lanes(len(idx)), K), np.uint8)
        for j, i in enumerate(idx):
            block[ANSB_LANES * j:ANSB_LANES * (j + 1)] = blockio.shape_block(
                subs[i], ANSB_LANES, ANSB_STEP)[0]
        cols = torch.from_numpy(block).to(dev).T.contiguous()
        streams, lengths = _encode(cols, 0, bitpred.Simple())
        lens = lengths.cpu().numpy().astype(np.int64)
        flat = blockio.device_words(streams, lengths).cpu().numpy().view(
            "<u2")
        ends = np.cumsum(lens)
        for j, i in enumerate(idx):
            ln = lens[ANSB_LANES * j:ANSB_LANES * (j + 1)]
            if ln.max() > 0xFFFF:
                raise ValueError("lane stream exceeds u16 length field")
            w0 = ends[ANSB_LANES * j] - ln[0]
            payloads[i] = (ln.astype("<u2").tobytes()
                           + flat[w0:w0 + ln.sum()].tobytes())
    return b"".join(struct.pack("<I", len(p)) + p for p in payloads)


def ansb_decode(payload: bytes, n: int, lanes: int = 4, device=None,
                **_unused) -> np.ndarray:
    dev = resolve_device(device)
    subs, off, left = [], 0, n
    while left > 0:
        if off + 4 > len(payload):
            raise ValueError("corrupt payload: truncated ansb sub-block")
        ln = struct.unpack_from("<I", payload, off)[0]
        off += 4
        if off + ln > len(payload):
            raise ValueError("corrupt payload: ansb sub-block overruns")
        m = min(ANSB_BLOCK, left)
        K = blockio.K_for(m, ANSB_LANES, ANSB_STEP)
        # the reference's unpack checks, sub-block by sub-block
        subs.append((blockio.lane_table(bytes(payload[off:off + ln]),
                                        ANSB_LANES, 8 * K + 2), m))
        off += ln
        left -= m
    out = [None] * len(subs)
    for K, idx in _by_K([m for _, m in subs]).items():
        L = _ansb_launch_lanes(len(idx))
        lengths = np.zeros(L, np.int32)
        for j, i in enumerate(idx):
            lengths[ANSB_LANES * j:ANSB_LANES * (j + 1)] = subs[i][0][0]
        words = np.concatenate([subs[i][0][1] for i in idx]).view(np.int16)
        dec = BK.lane_bit_decode(torch.from_numpy(words.copy()).to(dev),
                                 torch.from_numpy(lengths).to(dev), K, 0,
                                 bitpred.Simple())
        block = dec.T.contiguous().cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = block[ANSB_LANES * j:ANSB_LANES * (j + 1)].reshape(
                -1)[:subs[i][1]]
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


# W-bit trees: W in 2..16, order 0, the Simple predictor (the reference's
# codecs ignore the rates).

def _encode_w(elems: np.ndarray, W: int, lanes: int, step_quant: int,
              device) -> bytes:
    dev = resolve_device(device)
    block, K = blockio.shape_block_elems(
        elems, lanes, step_quant, np.uint8 if W <= 8 else np.uint16)
    if W > 8:
        block = block.view(np.int16)
    cols = torch.from_numpy(block).to(dev).T.contiguous()
    return blockio.pack_device(*_encode(cols, 0, bitpred.Simple(), W))


def _decode_w(payload: bytes, n: int, W: int, lanes: int, step_quant: int,
              device) -> np.ndarray:
    """The first n elements of a W-bit payload: u8 for W <= 8, else
    u16."""
    dev = resolve_device(device)
    K = blockio.K_for(n, lanes, step_quant)
    words = blockio.push_words(payload, lanes, W * K + 2, dev)
    out = BK.lane_bit_decode(*words, K, 0, bitpred.Simple(), W)
    vals = out.T.contiguous().cpu().numpy().reshape(-1)[:n]
    return vals.view(np.uint16) if W > 8 else vals


def rc16_encode(data: np.ndarray, lanes: int = 512, step_quant: int = 64,
                device=None, **_unused) -> bytes:
    pad = (-data.shape[0]) % 2
    if pad:
        data = np.concatenate([data, np.zeros(pad, np.uint8)])
    return _encode_w(data.view("<u2"), 16, lanes, step_quant, device)


def rc16_decode(payload: bytes, n: int, lanes: int = 512,
                step_quant: int = 64, device=None,
                **_unused) -> np.ndarray:
    vals = _decode_w(payload, -(-n // 2), 16, lanes, step_quant, device)
    return vals.astype("<u2").view(np.uint8)[:n]


def make_nbit_block_api(W: int):
    """(encode_block, decode_block) of the W-bit element codec rc{W}b over
    ints each < 2^W; the decode returns u8 for W <= 8, else u16."""

    def encode_block(data: np.ndarray, lanes: int = 512,
                     step_quant: int = 64, device=None,
                     **_unused) -> bytes:
        if data.size and int(data.max()) >= (1 << W):
            raise ValueError(f"rc{W}b input exceeds {W}-bit alphabet")
        return _encode_w(data, W, lanes, step_quant, device)

    def decode_block(payload: bytes, n: int, lanes: int = 512,
                     step_quant: int = 64, device=None,
                     **_unused) -> np.ndarray:
        return _decode_w(payload, n, W, lanes, step_quant, device)

    return encode_block, decode_block
