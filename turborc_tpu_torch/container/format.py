"""Block container file format (counterpart of
``turborc_tpu/container/format.py``; the bytes are the contract).

Layout (all little-endian):

  file header (32 bytes):
    u32  magic      "TRCT" (0x54435254)
    u8   version    3
    u8   codec_id
    u8   flags
    u8   log2_lanes
    u8   log2_step_quant
    u8   prm0, prm1
    u8   ctx_bits
    u8[4] geom      (Geom.pack)
    u32  block_size
    u64  orig_len
    u32  header_crc32 (of the previous 28 bytes)

  per block:
    u32  comp_len   payload byte count
    u8   bflags     bit0: stored (raw bytes)
    u32  crc32      of the block's original bytes
    payload
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from turborc_tpu_torch.ops.geom import DEFAULT, Geom

MAGIC = 0x54435254
VERSION = 3
_HDR = struct.Struct("<IBBBBBBBB4sIQ")
_BHDR = struct.Struct("<IBI")

BLK_STORED = 1


def write_header(codec_id: int, lanes: int, step_quant: int,
                 block_size: int, orig_len: int, prm0: int = 5,
                 prm1: int = 8, ctx_bits: int = 8, flags: int = 0,
                 geom: Geom | None = None) -> bytes:
    gb = (geom or DEFAULT).pack()
    hdr = _HDR.pack(MAGIC, VERSION, codec_id, flags,
                    lanes.bit_length() - 1, step_quant.bit_length() - 1,
                    prm0, prm1, ctx_bits, gb, block_size, orig_len)
    return hdr + struct.pack("<I", zlib.crc32(hdr))


def read_header(buf: bytes) -> dict:
    if len(buf) < _HDR.size + 4:
        raise ValueError("corrupt container: truncated header")
    hdr = buf[:_HDR.size]
    (magic, version, codec_id, flags, log2_lanes, log2_step, prm0, prm1,
     ctx_bits, gb, block_size, orig_len) = _HDR.unpack(hdr)
    (crc,) = struct.unpack_from("<I", buf, _HDR.size)
    if magic != MAGIC:
        raise ValueError("bad magic: not a TRCT container")
    if version != VERSION:
        raise ValueError(f"unsupported container version {version}")
    if crc != zlib.crc32(hdr):
        raise ValueError("corrupt container header (crc mismatch)")
    try:
        geom = Geom.unpack(gb)
    except ValueError as e:
        raise ValueError(f"corrupt container: bad geometry ({e})") from e
    return dict(codec_id=codec_id, flags=flags, lanes=1 << log2_lanes,
                step_quant=1 << log2_step, prm0=prm0, prm1=prm1,
                ctx_bits=ctx_bits, geom=geom, block_size=block_size,
                orig_len=orig_len, data_off=_HDR.size + 4)


def write_block(payload: bytes, raw: np.ndarray, stored: bool) -> bytes:
    crc = zlib.crc32(raw.tobytes())
    return _BHDR.pack(len(payload), BLK_STORED if stored else 0, crc) + payload


def iter_blocks(buf: bytes, off: int):
    """Yield (payload_bytes, stored, crc32) for each block."""
    n = len(buf)
    while off < n:
        if off + _BHDR.size > n:
            raise ValueError("corrupt container: truncated block header")
        comp_len, bflags, crc = _BHDR.unpack_from(buf, off)
        off += _BHDR.size
        if off + comp_len > n:
            raise ValueError("corrupt container: truncated block payload")
        yield buf[off:off + comp_len], bool(bflags & BLK_STORED), crc
        off += comp_len
