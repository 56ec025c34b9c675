"""Codec registry: name <-> id <-> implementation.

Counterpart of ``turborc_tpu/codecs/registry.py``, holding only what the
port has, on every device (the kernels on the card, their plain versions
on the CPU): the per-lane scan codecs ``rans-static`` (id 42),
``rans-cdf-o0`` (id 56, the default), ``rans-cdf-s8`` (id 58) and the
order-1 ``rans-cdf-r1`` (id 59) and ``rans-cdf-o1`` (id 64), the
flagships ``rans-cdf-o0-p`` (id 57) and ``rans-cdf-r1-p`` (id 60),
``rans-auto`` (id 61), which picks between them per block, the
bit-tree codec ``rc-p`` (id 8), the nibble codecs ``rc4`` (id 41) and
``rc4c`` (id 40), the bitwise byte-tree codecs ``rc-o0`` (id 1),
``rcc-o1`` (id 2), ``rcc2`` (id 3, order 2) and their dual-speed (ids
101, 102) and FSM (ids 103, 104) predictor variants, the bitwise ANS
``ansb`` (id 66) and the W-bit tree codecs ``rc-16`` (id 6) and
``rc{W}b`` (ids 142, 143, 145, 146, 147, 150, 152).  The JAX package
registers ids 57, 60 and 8 only off the CPU.  A name or id the JAX
package knows but the port does not raises KeyError.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from turborc_tpu_torch.codecs import (rans_auto, rans_cdf_o0, rans_cdf_o0_p,
                                      rans_cdf_o1, rans_cdf_r1_lane,
                                      rans_cdf_r1_p, rans_cdf_s8, rans_nibble,
                                      rans_static, rc_bit, rc_tree)


@dataclasses.dataclass(frozen=True)
class Codec:
    codec_id: int
    name: str
    encode_block: Callable
    decode_block: Callable


_CODECS = (
    # static-CDF byte rANS, per-block histogram, per-lane streams
    Codec(42, "rans-static", rans_static.encode_block,
          rans_static.decode_block),
    # adaptive CDF16 nibble-pair rANS, per-lane models and streams
    Codec(56, "rans-cdf-o0", rans_cdf_o0.encode_block,
          rans_cdf_o0.decode_block),
    # flagship adaptive CDF16 nibble-pair rANS, share-span models,
    # group-interleaved streams, on the hand-written CUDA kernels
    Codec(57, "rans-cdf-o0-p", rans_cdf_o0_p.encode_block,
          rans_cdf_o0_p.decode_block),
    # per-lane streams, share-span models, per-segment warm tables
    Codec(58, "rans-cdf-s8", rans_cdf_s8.encode_block,
          rans_cdf_s8.decode_block),
    # order 1 on rank-quantized previous-byte contexts, per-segment
    # conditional warm tables, per-lane streams (id 60's model)
    Codec(59, "rans-cdf-r1", rans_cdf_r1_lane.encode_block,
          rans_cdf_r1_lane.decode_block),
    # order-1 flagship: rank-quantized previous-byte contexts, contiguous
    # spans, per-group conditional warm tables, same stream format
    Codec(60, "rans-cdf-r1-p", rans_cdf_r1_p.encode_block,
          rans_cdf_r1_p.decode_block),
    # per-block dispatch between ids 57 and 60 (1-byte tag)
    Codec(61, "rans-auto", rans_auto.encode_block, rans_auto.decode_block),
    # order 1 on the previous byte, fresh tables, at most 128 lanes
    Codec(64, "rans-cdf-o1", rans_cdf_o1.encode_block,
          rans_cdf_o1.decode_block),
    # bit-tree model (the reference rc family's), coded a nibble at a time
    Codec(8, "rc-p", rc_tree.encode_block, rc_tree.decode_block),
    # bitwise byte trees, one predictor table a lane (order 1: one a
    # previous byte): simple, dual-speed (rates prm0, prm1), FSM
    Codec(1, "rc-o0", rc_bit.rc_s_encode, rc_bit.rc_s_decode),
    Codec(2, "rcc-o1", rc_bit.rcc_s_encode, rc_bit.rcc_s_decode),
    Codec(101, "rc-o0-ss", rc_bit.rc_ss_encode, rc_bit.rc_ss_decode),
    Codec(102, "rcc-o1-ss", rc_bit.rcc_ss_encode, rc_bit.rcc_ss_decode),
    Codec(103, "rc-o0-sf", rc_bit.rc_sf_encode, rc_bit.rc_sf_decode),
    Codec(104, "rcc-o1-sf", rc_bit.rcc_sf_encode, rc_bit.rcc_sf_decode),
    # bitwise order 2, the full 2^16 byte-pair contexts, at most 16 lanes
    Codec(3, "rcc2", rc_bit.rcc2_encode, rc_bit.rcc2_decode),
    # bitwise order 0 over 16-bit symbols, a 16-level tree
    Codec(6, "rc-16", rc_bit.rc16_encode, rc_bit.rc16_decode),
    # bitwise ANS at the reference's design point: 4 interleaved states
    # (lanes) over an order-0 byte tree, 64 KB sub-blocks
    Codec(66, "ansb", rc_bit.ansb_encode, rc_bit.ansb_decode),
    # 4-bit symbols: a per-lane adaptive CDF16, a shared static one
    Codec(41, "rc4", rans_nibble.encode_block, rans_nibble.decode_block),
    Codec(40, "rc4c", rans_nibble.encode_block_static,
          rans_nibble.decode_block_static),
    # W-bit symbol trees, W in 2, 3, 5, 6, 7, 10, 12 (u16 elements above 8)
    *(Codec(140 + w, f"rc{w}b", *rc_bit.make_nbit_block_api(w))
      for w in (2, 3, 5, 6, 7, 10, 12)),
)
_BY_NAME = {c.name: c for c in _CODECS}
_BY_ID = {c.codec_id: c for c in _CODECS}


def get(name_or_id) -> Codec:
    table = _BY_ID if isinstance(name_or_id, int) else _BY_NAME
    try:
        return table[name_or_id]
    except KeyError:
        raise KeyError(f"codec {name_or_id!r} is not ported to "
                       f"turborc_tpu_torch yet (ported: {names()})") from None


def names() -> list[str]:
    return [c.name for c in _CODECS]
