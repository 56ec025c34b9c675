"""Block shaping, lane-stream packing, warm-start table construction and
wire packing.

Counterpart of ``turborc_tpu/codecs/blockio.py``.  Payload bytes must
match the reference exactly, so the arithmetic is the reference's, line
for line.  Everything is numpy but the device functions, which move only
a block's occupied stream words, as u16, between the host and the
device: ``pack_device`` from the coder's ``[L, M]`` matrix,
``push_words`` to the decoders, which read the words as the payload lays
them out, and ``unpack_device`` to an ``[L, M]`` matrix.
"""
from __future__ import annotations

import numpy as np
import torch

TOTAL = 1 << 15


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """[..., 16] counts -> freq rows summing 2^15 with freq >= 1."""
    c = counts.astype(np.int64) + 1
    n = c.sum(axis=-1, keepdims=True)
    f = np.maximum(1, c * (TOTAL - 16) // n)
    idx = np.argmax(c, axis=-1)
    np.put_along_axis(f, idx[..., None],
                      np.take_along_axis(f, idx[..., None], -1)
                      + TOTAL - f.sum(axis=-1, keepdims=True), -1)
    return f.astype(np.uint16)


def nibble_tables(data: np.ndarray):
    """(hi freqs [16], lo freqs [16,16]) from a block's nibbles -
    warm-start statistics for the adaptive CDF16 models.  A byte is its
    (hi, lo) nibble pair, so one byte histogram gives both counts."""
    joint = np.bincount(data, minlength=256).reshape(16, 16)
    return quantize_freqs(joint.sum(axis=1)), quantize_freqs(joint)


def cumulative(freqs: np.ndarray) -> np.ndarray:
    """freq rows [..., 16] -> cumulative cdf rows (cdf[0] = 0) int32."""
    cdf = np.zeros(freqs.shape, np.int32)
    cdf[..., 1:] = np.cumsum(freqs, axis=-1)[..., :-1].astype(np.int32)
    return cdf


# Warm-table wire packing: 8-bit log quantization + per-group nibble
# deltas.  Both sides code with the DEQUANTIZED tables, so the encoder
# round-trips its tables through this quantizer before use.

def _freq_code(f: np.ndarray) -> np.ndarray:
    """freq [0, 32768] -> 8-bit log code: literal below 16, else
    exponent/4-bit-mantissa (implicit MSB), relative error <= 1/8."""
    f = f.astype(np.int64)
    bl = np.zeros_like(f)  # floor(log2(f)) for f >= 1
    v = np.maximum(f, 1)
    for s in (8, 4, 2, 1):
        m = v >= (1 << s)
        bl += np.where(m, s, 0)
        v >>= np.where(m, s, 0)
    e = bl - 3                       # f >= 16 -> e >= 1, mantissa in [8,15]
    expcode = 16 + (e - 1) * 8 + ((f >> e) - 8)
    return np.where(f < 16, f, expcode).astype(np.uint8)


def _freq_decode(code: np.ndarray) -> np.ndarray:
    code = code.astype(np.int64)
    t = code - 16
    e = t // 8 + 1
    m = t % 8 + 8
    return np.where(code < 16, code, m << e)


def _renorm_rows(f: np.ndarray) -> np.ndarray:
    """[..., W] approximate freqs -> rows summing TOTAL with freq >= 1."""
    W = f.shape[-1]
    f = np.maximum(1, f.astype(np.int64))
    n = f.sum(axis=-1, keepdims=True)
    g = np.maximum(1, f * (TOTAL - W) // n)
    idx = np.argmax(g, axis=-1)
    np.put_along_axis(g, idx[..., None],
                      np.take_along_axis(g, idx[..., None], -1)
                      + TOTAL - g.sum(axis=-1, keepdims=True), -1)
    return g.astype(np.int64)


def quantize_tables(hi_f: np.ndarray, lo_f: np.ndarray):
    """[G,16]/[G,16,16] freqs -> (codes [G,272] u8, dequantized exact
    renormalized freq tables both sides will reconstruct)."""
    G = hi_f.shape[0]
    codes = np.concatenate(
        [_freq_code(hi_f).reshape(G, 16),
         _freq_code(lo_f).reshape(G, 256)], axis=1).astype(np.uint8)
    return codes, codes_to_tables(codes)


def codes_to_tables(codes: np.ndarray):
    G = codes.shape[0]
    hi = _renorm_rows(_freq_decode(codes[:, :16]))
    lo = _renorm_rows(_freq_decode(codes[:, 16:]).reshape(G, 16, 16))
    return hi, lo


def pack_codes(codes: np.ndarray) -> bytes:
    """[G,272] u8 codes -> group 0 raw + zigzag nibble deltas (esc=15)."""
    nibbles = []
    esc = bytearray()
    d = codes[1:].astype(np.int32) - codes[:-1].astype(np.int32)
    z = np.where(d >= 0, 2 * d, -2 * d - 1).reshape(-1)
    for v in z.tolist():
        if v < 15:
            nibbles.append(v)
        else:
            nibbles.append(15)
            esc += int(v).to_bytes(2, "little")
    if len(nibbles) % 2:
        nibbles.append(0)
    arr = np.asarray(nibbles, np.uint8)
    packed = (arr[0::2] | (arr[1::2] << 4)).tobytes()
    return (len(esc).to_bytes(4, "little") + codes[0].tobytes() + packed
            + bytes(esc))


def unpack_codes(buf: bytes, G: int, n_entries: int = 272):
    """Inverse of pack_codes; returns (codes [G,n_entries] u8, consumed)."""
    esc_len = int.from_bytes(buf[:4], "little")
    off = 4
    codes = np.zeros((G, n_entries), np.int32)
    codes[0] = np.frombuffer(buf[off:off + n_entries], np.uint8)
    off += n_entries
    n_nib = (G - 1) * n_entries
    nbytes = (n_nib + 1) // 2
    raw = np.frombuffer(buf[off:off + nbytes], np.uint8)
    off += nbytes
    nib = np.empty(2 * raw.size, np.uint8)
    nib[0::2] = raw & 15
    nib[1::2] = raw >> 4
    nib = nib[:n_nib].astype(np.int32)
    esc = np.frombuffer(buf[off:off + esc_len], "<u2").astype(np.int32)
    off += esc_len
    is_esc = nib == 15
    if is_esc.sum() != esc.size:
        raise ValueError("corrupt payload: warm-table escape count")
    z = nib.copy()
    z[is_esc] = esc
    d = np.where(z & 1, -(z + 1) // 2, z // 2).reshape(G - 1, n_entries)
    codes[1:] = codes[0] + np.cumsum(d, axis=0)
    if codes.min() < 0 or codes.max() > 255:
        raise ValueError("corrupt payload: warm-table codes out of range")
    return codes.astype(np.uint8), off


def K_for(n: int, lanes: int, step_quant: int) -> int:
    """Per-lane symbol count: ceil(n/lanes) padded to step_quant (at
    least one step)."""
    K = -(-n // lanes)
    return max(-(-K // step_quant) * step_quant, step_quant)


def shape_block(data: np.ndarray, lanes: int, step_quant: int):
    """Pad + reshape flat bytes into [lanes, K] contiguous chunks (uint8)."""
    n = data.shape[0]
    K = K_for(n, lanes, step_quant)
    padded = np.zeros(lanes * K, np.uint8)
    padded[:n] = data
    return padded.reshape(lanes, K), K


def pack(streams: np.ndarray, lengths: np.ndarray) -> bytes:
    """[L, M] word matrix + [L] lengths -> payload bytes."""
    if lengths.max() > 0xFFFF:
        raise ValueError("lane stream exceeds u16 length field")
    keep = np.arange(streams.shape[1])[None, :] < lengths[:, None]
    flat = streams[keep].astype(np.uint16)
    return lengths.astype("<u2").tobytes() + flat.astype("<u2").tobytes()


def lane_table(payload: bytes, lanes: int, M: int):
    """A payload's checked lane length table [lanes] int64 and its u16
    words, lane after lane (``unpack``'s checks)."""
    if len(payload) < 2 * lanes:
        raise ValueError("corrupt payload: truncated lane length table")
    lengths = np.frombuffer(payload[:2 * lanes], "<u2").astype(np.int64)
    flat = np.frombuffer(payload[2 * lanes:len(payload) & ~1], "<u2")
    if lengths.max() > M or lengths.min() < 2 or lengths.sum() != flat.size:
        raise ValueError("corrupt payload: lane length table inconsistent")
    return lengths, flat


def unpack(payload: bytes, lanes: int, M: int) -> np.ndarray:
    """payload -> [lanes, M] int32 word matrix (zero padded)."""
    lengths, flat = lane_table(payload, lanes, M)
    streams = np.zeros((lanes, M), np.int32)
    keep = np.arange(M)[None, :] < lengths[:, None]
    streams[keep] = flat
    return streams


def device_words(streams: torch.Tensor, lengths: torch.Tensor):
    """Device [L, M] int32 words + [L] lengths -> the occupied words, lane
    after lane, as int16 (the u16 bits) on the same device."""
    keep = (torch.arange(streams.shape[1], device=streams.device)[None, :]
            < lengths.to(torch.int64)[:, None])
    # the low half of each little-endian int32: the word as u16
    return streams[keep].view(torch.int16)[0::2].contiguous()


def pack_device(streams: torch.Tensor, lengths: torch.Tensor) -> bytes:
    """Device [L, M] int32 words + [L] lengths -> the payload ``pack``
    writes; only the occupied words leave the device, as u16."""
    lens = lengths.cpu().numpy().astype(np.int64)
    if lens.max() > 0xFFFF:
        raise ValueError("lane stream exceeds u16 length field")
    flat = device_words(streams, lengths).cpu().numpy().view("<u2")
    return lens.astype("<u2").tobytes() + flat.tobytes()


def push_words(payload: bytes, lanes: int, M: int, device):
    """payload -> (words [W] int16, lengths [lanes] int32) on ``device``:
    the lane streams as the payload holds them, checked as ``unpack``
    checks them; only the occupied words cross, as u16."""
    lengths, flat = lane_table(payload, lanes, M)
    return (torch.from_numpy(flat.view(np.int16).copy()).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device))


def unpack_device(payload: bytes, lanes: int, M: int,
                  device) -> torch.Tensor:
    """payload -> [lanes, M] int32 word matrix (zero padded) on
    ``device``; only the occupied words cross to it, as u16."""
    words, lengths = push_words(payload, lanes, M, device)
    keep = (torch.arange(M, device=device)[None, :]
            < lengths.to(torch.int64)[:, None])
    streams = torch.zeros((lanes, M), dtype=torch.int32, device=device)
    streams[keep] = words.to(torch.int32) & 0xFFFF
    return streams
