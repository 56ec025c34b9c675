"""Warm-start table construction and wire packing, numpy only.

Counterpart of ``turborc_tpu/codecs/blockio.py``, reduced to what the
flagship codec (id 57) needs.  Payload bytes must match the reference
exactly, so the arithmetic is the reference's, line for line.
"""
from __future__ import annotations

import numpy as np

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
