"""Public compress/decompress API over the block container.

Counterpart of ``turborc_tpu/api.py``: the same container bytes for the
same input and configuration.  ``device=None`` runs on the CUDA card and
raises when there is none; ``device="cpu"`` runs the kernels' plain
versions.
"""
from __future__ import annotations

import zlib

import numpy as np

from turborc_tpu_torch.codecs import registry
from turborc_tpu_torch.container import format as fmt
from turborc_tpu_torch.ops.geom import DEFAULT
from turborc_tpu_torch.utils.config import CodecConfig, resolve_device


def _as_bytes_array(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False).reshape(-1)
    return np.frombuffer(bytes(data), np.uint8)


def compress(data, cfg: CodecConfig | None = None, device=None) -> bytes:
    """Compress a byte buffer into a TRCT container (geometry in the v3
    header, so the container decodes with no configuration).  A codec
    gets what the JAX package's ``compress`` passes it: lanes,
    step_quant, the predictor rates prm0 / prm1, level, ctx_bits and the
    geometry (and the device)."""
    dev = resolve_device(device)
    cfg = cfg or CodecConfig()
    geom = cfg.geom or DEFAULT
    codec = registry.get(cfg.codec)
    arr = _as_bytes_array(data)
    out = [fmt.write_header(codec.codec_id, cfg.lanes, cfg.step_quant,
                            cfg.block_size, arr.shape[0], cfg.prm0,
                            cfg.prm1, cfg.ctx_bits, geom=geom)]
    for off in range(0, max(arr.shape[0], 1), cfg.block_size):
        blk = arr[off:off + cfg.block_size]
        payload = codec.encode_block(blk, lanes=cfg.lanes,
                                     step_quant=cfg.step_quant,
                                     prm0=cfg.prm0, prm1=cfg.prm1,
                                     level=cfg.level,
                                     ctx_bits=cfg.ctx_bits, geom=geom,
                                     device=dev)
        stored = len(payload) >= blk.shape[0]
        if stored:
            payload = blk.tobytes()
        out.append(fmt.write_block(payload, blk, stored))
    return b"".join(out)


def decompress(buf: bytes, device=None) -> bytes:
    """Decompress a TRCT container; verifies the per-block crc32.  A codec
    gets the header's lanes, step_quant, prm0 / prm1, ctx_bits and
    geometry, as in the JAX package's ``decompress``."""
    dev = resolve_device(device)
    hdr = fmt.read_header(buf)
    codec = registry.get(hdr["codec_id"])
    n_left = hdr["orig_len"]
    out = []
    for payload, stored, crc in fmt.iter_blocks(buf, hdr["data_off"]):
        n = min(hdr["block_size"], n_left)
        if stored:
            blk = np.frombuffer(payload, np.uint8)[:n]
        else:
            blk = codec.decode_block(payload, n, lanes=hdr["lanes"],
                                     step_quant=hdr["step_quant"],
                                     prm0=hdr["prm0"], prm1=hdr["prm1"],
                                     ctx_bits=hdr["ctx_bits"],
                                     geom=hdr["geom"], device=dev)
        if zlib.crc32(blk.tobytes()) != crc:
            raise ValueError(
                "block crc mismatch: corrupt stream or decoder bug")
        out.append(blk.tobytes())
        n_left -= n
    return b"".join(out)
