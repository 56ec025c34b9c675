"""Order-1 adaptive-CDF models, plain torch: the rank-quantized contexts
of ids 59 and 60 and the previous-byte context of id 64.

Counterpart of ``turborc_tpu/codecs/rans_cdf_r1.py`` (and of the model
half of ``rans_cdf_o1.py``), reduced to the models: the context wiring,
the conditional warm tables (numpy), and the per-lane model and decode
passes (torch), which are the bodies of the o1 kernels' plain versions
(K6, K7 of the flagship id 60, ``codecs/rans_cdf_r1_p.py``; L5-L8 of the
per-lane scan codecs ids 59 and 64, ``codecs/rans_cdf_r1_lane.py`` and
``codecs/rans_cdf_o1.py``).  It imports no kernel wrapper.

Bytes are rank-remapped (byte value == frequency rank), so a small
context keyed on the previous byte ``prev`` carries most of the order-1
information:

    ctx  = prev < 56 ? prev : 56 + min(bitlen(prev - 55), 7)
           hi nibble | ctx    (64 rows: low ranks exact, log2 above)
    locx = prev>>4 == hi ? 32 + (prev & 15)        # match plane
         : hi == 0       ? min(prev, 15) : 16 + hi
           lo nibble | locx   (48 rows)

``NCTX`` is format-relevant; the reference reads it from the environment
at import, the port fixes it at 64.
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.ops import rans

NCTX = 64
LROWS = 48
LIN = NCTX - 8                   # exact-rank rows before the log2 buckets
N_ENTRIES = (NCTX + LROWS) * 16  # warm-table u8 codes per segment


def hictx(prev: torch.Tensor) -> torch.Tensor:
    """hi-nibble context row: ranks < LIN exact, log2 buckets above."""
    v = torch.clamp(prev - (LIN - 1), min=1)
    bl = 1 + sum((v >= (1 << s)).to(prev.dtype) for s in range(1, 8))
    return torch.where(prev < LIN, prev, LIN + torch.clamp(bl, max=7))


def locx_of(prev: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo-nibble context row: match plane / prev rank / hi."""
    base = torch.where(hi == 0, torch.clamp(prev, max=15), 16 + hi)
    return torch.where((prev >> 4) == hi, 32 + (prev & 15), base)


def np_hictx(prev: np.ndarray) -> np.ndarray:
    bl = np.zeros(257, np.int64)
    for i in range(1, 257):
        bl[i] = i.bit_length()
    return np.where(prev < LIN, prev,
                    LIN + np.minimum(bl[np.maximum(prev - (LIN - 1), 1)],
                                     7))


def np_locx(prev: np.ndarray, hi: np.ndarray) -> np.ndarray:
    base = np.where(hi == 0, np.minimum(prev, 15), 16 + hi)
    return np.where((prev >> 4) == hi, 32 + (prev & 15), base)


# ---------------------------------------------------------------------------
# conditional warm-start tables (numpy)
# ---------------------------------------------------------------------------

def o1_counts(seg: np.ndarray):
    """Conditional nibble counts of a remapped byte segment:
    (hi|ctx [NCTX,16], lo|locx [LROWS,16]); the prev chain runs over the
    flat segment."""
    s = seg.astype(np.int32)
    prev = np.concatenate([[0], s[:-1]])
    hi, lo = s >> 4, s & 15
    hc = np.bincount(np_hictx(prev) * 16 + hi, minlength=NCTX * 16)
    lc = np.bincount(np_locx(prev, hi) * 16 + lo, minlength=LROWS * 16)
    return (hc.reshape(NCTX, 16).astype(np.int64),
            lc.reshape(LROWS, 16).astype(np.int64))


def group_tables(padded: np.ndarray, G: int):
    """Per-segment conditional warm freq tables ([G,NCTX,16],
    [G,LROWS,16]); segment g is the g-th of G equal slices."""
    per = padded.shape[0] // G
    his, los = [], []
    for g in range(G):
        hc, lc = o1_counts(padded[g * per:(g + 1) * per])
        his.append(blockio.quantize_freqs(hc))
        los.append(blockio.quantize_freqs(lc))
    return np.stack(his), np.stack(los)


def quantize_tables(hi_f: np.ndarray, lo_f: np.ndarray):
    """freqs -> (codes [G,N_ENTRIES] u8, dequantized tables)."""
    G = hi_f.shape[0]
    codes = np.concatenate(
        [blockio._freq_code(hi_f).reshape(G, NCTX * 16),
         blockio._freq_code(lo_f).reshape(G, LROWS * 16)],
        axis=1).astype(np.uint8)
    return codes, codes_to_tables(codes)


def codes_to_tables(codes: np.ndarray):
    G = codes.shape[0]
    hi = blockio._renorm_rows(
        blockio._freq_decode(codes[:, :NCTX * 16]).reshape(G, NCTX, 16))
    lo = blockio._renorm_rows(
        blockio._freq_decode(codes[:, NCTX * 16:]).reshape(G, LROWS, 16))
    return hi, lo


def n_segments(n: int, cap: int) -> int:
    """Warm-table segment count: one per 256 KB of block, at least 1, at
    most ``cap`` (the group count)."""
    return max(1, min(cap, n >> 18))


def lane_tables(hi_cdf: torch.Tensor, lo_cdf: torch.Tensor, lanes: int):
    """Per-segment cumulative tables [n_seg, R, 16] -> per-lane [lanes, R,
    16] int64: lane l (contiguous span l) takes segment l * n_seg //
    lanes (the JAX package's ``_lane_tables`` after
    ``blockio.cumulative``)."""
    seg = (torch.arange(lanes, device=hi_cdf.device) * hi_cdf.shape[0]
           ) // lanes
    return hi_cdf.to(torch.int64)[seg], lo_cdf.to(torch.int64)[seg]


# ---------------------------------------------------------------------------
# per-lane model and decode passes (torch)
# ---------------------------------------------------------------------------

def _row_get(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [L, R, 16], idx [L] -> row idx of each lane [L, 16]."""
    return table[torch.arange(table.shape[0], device=table.device), idx]


def _row_put(table: torch.Tensor, idx: torch.Tensor,
             row: torch.Tensor) -> None:
    """table[l, idx[l]] = row[l], in place."""
    table[torch.arange(table.shape[0], device=table.device), idx] = row


def model_pass(block: torch.Tensor, K: int, hi0: torch.Tensor,
               lo0: torch.Tensor, rate: int = cdf16.CDFRATE,
               rows=(hictx, locx_of)) -> torch.Tensor:
    """block [L, K] bytes, per-lane tables hi0 [L, R_hi, 16], lo0 [L,
    R_lo, 16] -> probs [2K, 2 (low/freq), L] int64 (encode model).  The
    hi nibble codes from hi row ``rows[0](prev)``, the lo nibble from lo
    row ``rows[1](prev, hi)``; ``prev`` starts at 0 in every lane."""
    hi_row, lo_row = rows
    cols = block.to(torch.int64).T
    L = block.shape[0]
    cdf_hi = hi0.to(torch.int64).clone()
    cdf_lo = lo0.to(torch.int64).clone()
    prev = torch.zeros(L, dtype=torch.int64, device=block.device)
    probs = torch.empty((2 * K, 2, L), dtype=torch.int64,
                        device=block.device)
    for t in range(K):
        b = cols[t]
        hi, lo = b >> 4, b & 15
        ctx = hi_row(prev)
        hrow = _row_get(cdf_hi, ctx)
        low_h, fr_h = cdf16.lookup(hrow, hi)
        _row_put(cdf_hi, ctx, cdf16.update_rate(hrow, low_h, rate))
        locx = lo_row(prev, hi)
        lrow = _row_get(cdf_lo, locx)
        low_l, fr_l = cdf16.lookup(lrow, lo)
        _row_put(cdf_lo, locx, cdf16.update_rate(lrow, low_l, rate))
        probs[2 * t, 0], probs[2 * t, 1] = low_h, fr_h
        probs[2 * t + 1, 0], probs[2 * t + 1, 1] = low_l, fr_l
        prev = b
    return probs


def decode_pass(state: torch.Tensor, fetch, K: int, hi0: torch.Tensor,
                lo0: torch.Tensor, rate: int = cdf16.CDFRATE,
                rows=(hictx, locx_of)):
    """The decode twin of ``model_pass`` (the JAX ``decode_device``):
    initial states [L] int64 and a stream reader ``fetch`` (``state ->
    state``, renormalising the lanes below 2^15) -> (bytes [K, L] uint8,
    final states [L] int64).  Per nibble: row select by context, search,
    state transition, fetch, update and write-back."""
    hi_row, lo_row = rows
    L = state.shape[0]
    cdf_hi = hi0.to(torch.int64).clone()
    cdf_lo = lo0.to(torch.int64).clone()
    prev = torch.zeros(L, dtype=torch.int64, device=state.device)
    out = torch.empty((K, L), dtype=torch.uint8, device=state.device)
    for t in range(K):
        ctx = hi_row(prev)
        hrow = _row_get(cdf_hi, ctx)
        hs, low_h, fr_h = cdf16.search(hrow, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_h, fr_h))
        _row_put(cdf_hi, ctx, cdf16.update_rate(hrow, low_h, rate))
        locx = lo_row(prev, hs)
        lrow = _row_get(cdf_lo, locx)
        ls, low_l, fr_l = cdf16.search(lrow, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_l, fr_l))
        _row_put(cdf_lo, locx, cdf16.update_rate(lrow, low_l, rate))
        prev = (hs << 4) | ls
        out[t] = prev.to(torch.uint8)
    return out, state


# ---------------------------------------------------------------------------
# id 64's context: the previous byte itself, every row from cdf16.init
# ---------------------------------------------------------------------------

BYTE_HROWS, BYTE_LROWS = 256, 256 * 16
BYTE_ROWS = (lambda prev: prev, lambda prev, hi: prev * 16 + hi)


def byte_tables(L: int, device=None):
    """Every lane's fresh id-64 model: hi [L, 256, 16], lo [L, 4096, 16]
    (hi row ``prev``, lo row ``prev * 16 + hi``), for ``model_pass`` and
    ``decode_pass`` with ``rows=BYTE_ROWS``."""
    return (cdf16.init((L, BYTE_HROWS), device),
            cdf16.init((L, BYTE_LROWS), device))
