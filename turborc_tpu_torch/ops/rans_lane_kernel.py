"""The per-lane scan codecs' four kernels: wrappers, launch counts and
plain versions.

The JAX package runs ids 56 (``rans-cdf-o0``), 58 (``rans-cdf-s8``) and
42 (``rans-static``) as ``lax.scan``s over lanes (``turborc_tpu/codecs/
rans_cdf_o0.py``, ``rans_cdf_s8.py``, ``rans_static.py``); they reach no
Pallas kernel.  Each compiled device loop is one hand-written kernel here
(``csrc/rans_lane_kernel.cu``): L1 and L3 a team of ``lane_team(share)``
threads a lane (``lane_launch``), L4 a team of ``STATIC_TEAM``, L2 one
thread a lane on CTAs of ``CODER_LANES`` lanes:

Kernel (wrapper)               computes                JAX pass
  L1 lane_model                bytes -> slot probs     encode_device's model
  L2 lane_coder                backward rANS, then     rans.encode_backward
                               per-lane compaction     + rans.stitch
  L3 lane_decode               streams -> bytes        decode_device (56, 58)
  L4 lane_static_decode        streams -> bytes        rans_static's
                                                       decode_device

Each wrapper's plain version is ``<wrapper>_plain``.

Layout: L lanes; bytes ``[K, L]`` (byte t of lane l at ``[t, l]``), slot
probs ``[2K, L]`` int32 ``(low << 16) | freq`` (hi nibble of byte t at
slot 2t, lo at 2t + 1).  L2 writes streams ``[L, S + 2]`` int32 in the
JAX package's ``rans.stitch`` layout (flush state hi16, lo16, then the
words in decode order, zero past the lane's length).  The decoders read
the lane streams as the payload holds them: ``words`` [W] int16 (the u16
bits), lane after lane, and ``lengths`` [L] int32; word p of lane l is
``words[off + p]`` (off = the lengths of the lanes before it) while p <
min(length, 2K + 2) and off + p < W, else 0 - for the lengths that
``blockio.lane_table`` accepts, the JAX package's zero-padded ``[L, 2K +
2]`` matrix.  The o0 model (L1, L3) is the span
model of ``rans_cdf_s8`` at a geometry ``geom`` (``ops.geom.Geom``, whose
share, sync, lsync, arows, srows and rate it reads): lane l is in span
``l // share`` and starts from the warm tables of segment ``(l // share)
* n_seg // (L // share)``; id 56 is ``PER_LANE`` with one segment.

A wrapper validates its inputs, then runs the plain version when they lie
on the CPU and launches the kernel when they lie on a CUDA device; there
is no fallback from one to the other.  ``launches[name]`` counts kernel
launches only.
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.models import span as S8
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops.geom import Geom
from turborc_tpu_torch.ops.rans_kernel import (INT32_MAX, _check, _rejoin,
                                               launch)

# L2: CTAs of CODER_LANES lanes (kCoderN); probs staged CODER_SLOTS slots
# a stage (kCoderD) in a ring of CODER_RING stages (kCoderRing), the chain
# in blocks of CODER_BLOCK slots (kCoderU), the emitted words in a ring of
# CODER_WORDS a lane (kCoderWords), moved CODER_MOVE a thread a batch
# (kCoderMoveU).
CODER_LANES = 32
CODER_SLOTS = 64
CODER_RING = 4
CODER_BLOCK = 8
CODER_MOVE = 16
CODER_WORDS = 128
# L4: a team of STATIC_TEAM threads a lane (kStaticTeam), CTAs of
# STATIC_THREADS threads (kStaticThreads).
STATIC_TEAM = 16
STATIC_THREADS = 128
# L1 and L3: a team of LANE_TEAM threads a lane (kTeam), halved where a
# span's teams would pass LANE_MAX_THREADS threads a CTA (kMaxThreads); a
# CTA has at least LANE_CTA_MIN threads (kCtaMin).
LANE_TEAM = 16
LANE_MAX_THREADS = 1024
LANE_CTA_MIN = 128

launches = dict.fromkeys(("lane_model", "lane_coder", "lane_decode",
                          "lane_static_decode"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


PER_LANE = Geom(share=1)  # id 56: per-lane models, no re-join


def lane_team(share: int) -> int:
    """Threads a lane of L1 and L3 at spans of ``share`` lanes."""
    if LANE_TEAM * share > LANE_MAX_THREADS:
        return LANE_TEAM // 2
    return LANE_TEAM


def lane_launch(L: int, share: int) -> tuple[int, int, int]:
    """(threads a lane, threads a CTA, CTAs) of L1 and L3 on L lanes."""
    T = lane_team(share)
    threads = max(LANE_CTA_MIN, share * T)
    return T, threads, -(-L // (threads // T))


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def _span_tables(hi_tbl: torch.Tensor, lo_tbl: torch.Tensor, L: int,
                share: int):
    """Per-segment warm tables hi [n_seg, 16], lo [n_seg, 16, 16] ->
    per-lane hi [L, 16], lo [L, 16, 16] int64 (lane l in span l // share,
    span m in segment m * n_seg // (L // share))."""
    M, n_seg = L // share, hi_tbl.shape[0]
    seg = ((torch.arange(M, device=hi_tbl.device) * n_seg) // M
           ).repeat_interleave(share)
    return hi_tbl.to(torch.int64)[seg], lo_tbl.to(torch.int64)[seg]


def lane_model_plain(cols: torch.Tensor, hi_tbl: torch.Tensor,
                     lo_tbl: torch.Tensor, geom: Geom = PER_LANE):
    """cols [K, L] bytes -> probs [2K, L] int32 ((low << 16) | freq)."""
    K, L = cols.shape
    hi, lo = _span_tables(hi_tbl, lo_tbl, L, geom.share)
    start_hi, start_lo = hi, lo
    probs = torch.empty((2 * K, L), dtype=torch.int64, device=cols.device)
    for t in range(K):
        hi, lo, low_h, fr_h, low_l, fr_l = S8._code_byte(
            hi, lo, cols[t].to(torch.int64), geom.arows, geom.rate)
        probs[2 * t] = (low_h << 16) | fr_h
        probs[2 * t + 1] = (low_l << 16) | fr_l
        hi, lo, start_hi, start_lo = _rejoin(t, geom, hi, lo, start_hi,
                                             start_lo)
    return probs.to(torch.int32)


def lane_coder_plain(probs: torch.Tensor, init_states: torch.Tensor):
    """probs [S, L], init [L] -> (streams [L, S + 2] int32, lengths [L]
    int32): ``rans.stitch(*rans.encode_backward(lows, freqs))``."""
    p = probs.to(torch.int64)
    return rans.stitch(*rans.encode_backward(p >> 16, p & 0xFFFF,
                                             init_states))


def stream_reader(words: torch.Tensor, lengths: torch.Tensor, M: int):
    """Lane streams (words [W] int16, lengths [L]) of M-word lanes ->
    (initial states [L] int64, fetch): ``fetch(state)`` renormalises the
    lanes with state < 2^15, each taking the next word of its own stream
    (word p of lane l as the module docstring says), and returns the new
    states."""
    W = words.shape[0]
    flat = torch.cat([words.to(torch.int64) & 0xFFFF,
                      words.new_zeros(1, dtype=torch.int64)])
    ln = lengths.to(torch.int64)
    off = torch.cumsum(ln, 0) - ln
    ok = (off >= 0) & (off < W)
    avail = torch.where(ok, torch.minimum(ln.clamp(max=M), W - off), 0)
    avail = avail.clamp(min=0)

    def word(pos):
        return flat[torch.where(pos < avail, off + pos, W)]

    state = (word(torch.zeros_like(ln)) << 16) | word(torch.ones_like(ln))
    pos = torch.full_like(ln, 2)

    def fetch(state):
        nonlocal pos
        w = word(pos)
        need = state < rans.ANS_LOW
        pos = pos + need.to(torch.int64)
        return rans.dec_renorm(state, w)

    return state, fetch


def lane_decode_plain(words: torch.Tensor, lengths: torch.Tensor, K: int,
                      hi_tbl: torch.Tensor, lo_tbl: torch.Tensor,
                      geom: Geom = PER_LANE):
    """Lane streams (words, lengths) -> bytes [K, L] uint8 (rans_cdf_s8's
    decode_device)."""
    L = lengths.shape[0]
    state, fetch = stream_reader(words, lengths, 2 * K + 2)
    hi, lo = _span_tables(hi_tbl, lo_tbl, L, geom.share)
    start_hi, start_lo = hi, lo
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    for t in range(K):
        hs, low_h, fr_h = cdf16.search(hi, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_h, fr_h))
        hi = cdf16.update_rate(hi, low_h, geom.rate)
        row = S8._lo_row(lo, hs)
        ls, low_l, fr_l = cdf16.search(row, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_l, fr_l))
        new_row = cdf16.update_rate(row, low_l, geom.rate)
        if geom.arows < 16:
            new_row = torch.where((hs < geom.arows)[:, None], new_row, row)
        lo = S8._lo_put(lo, hs, new_row)
        out[t] = ((hs << 4) | ls).to(torch.uint8)
        hi, lo, start_hi, start_lo = _rejoin(t, geom, hi, lo, start_hi,
                                             start_lo)
    return out


def lane_static_decode_plain(words: torch.Tensor, lengths: torch.Tensor,
                             K: int, cdf: torch.Tensor):
    """Lane streams (words, lengths), cdf [257] -> bytes [K, L] uint8
    (rans_static.decode_device: sym = searchsorted(cdf, value, "right")
    - 1)."""
    L = lengths.shape[0]
    c = cdf.to(torch.int64)
    state, fetch = stream_reader(words, lengths, 2 * K + 2)
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    for t in range(K):
        value = state & rans.MASK15
        sym = torch.searchsorted(c, value, right=True) - 1
        low = c[sym]
        state = fetch(rans.dec_update(state, low, c[sym + 1] - low))
        out[t] = sym.to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_lanes(L: int) -> None:
    if not 1 <= L <= 1 << 30 or L & (L - 1):
        raise ValueError(f"{L} lanes: must be a power of two")


def _check_tables(hi_tbl, lo_tbl, L: int, geom: Geom, device) -> None:
    if not isinstance(hi_tbl, torch.Tensor) or hi_tbl.dim() != 2:
        raise ValueError("hi_tbl: expected a [n_seg, 16] tensor")
    n_seg = hi_tbl.shape[0]
    _check("hi_tbl", hi_tbl, torch.int32, (n_seg, 16), device)
    _check("lo_tbl", lo_tbl, torch.int32, (n_seg, 16, 16), device)
    if L % geom.share or not 1 <= n_seg <= L // geom.share:
        raise ValueError(f"{L} lanes at share {geom.share} cannot take "
                         f"{n_seg} warm-table segments")


def _check_K(K: int, geom: Geom) -> None:
    if K < 0 or (geom.share > 1 and K % geom.lsync):
        raise ValueError(f"K = {K}: must be >= 0 and, at share > 1, a "
                         f"multiple of lsync {geom.lsync}")


def lane_model(cols: torch.Tensor, hi_tbl: torch.Tensor,
               lo_tbl: torch.Tensor, geom: Geom = PER_LANE) -> torch.Tensor:
    """L1: cols [K, L] uint8 -> probs [2K, L] int32."""
    if not isinstance(cols, torch.Tensor) or cols.dim() != 2:
        raise ValueError("cols: expected a [K, L] tensor")
    K, L = cols.shape
    _check("cols", cols, torch.uint8, (K, L), cols.device)
    _check_lanes(L)
    _check_K(K, geom)
    _check_tables(hi_tbl, lo_tbl, L, geom, cols.device)
    if not cols.is_cuda:
        return lane_model_plain(cols, hi_tbl, lo_tbl, geom)
    probs = torch.empty((2 * K, L), dtype=torch.int32, device=cols.device)
    launch("lane_model", "trc_lane_model",
           *lane_model_cargs(cols, hi_tbl, lo_tbl, probs, geom),
           counts=launches)
    return probs


def lane_model_cargs(cols, hi_tbl, lo_tbl, probs, geom: Geom) -> list:
    """The arguments of ``trc_lane_model`` (without the stream)."""
    K, L = cols.shape
    return [cols, hi_tbl, lo_tbl, probs, K, L, hi_tbl.shape[0], geom.share,
            geom.sync, geom.lsync, geom.arows, geom.srows, geom.rate]


def lane_coder(probs: torch.Tensor, init_states: torch.Tensor):
    """L2: probs [S, L] int32 (every freq >= 1), init [L] int32 (states
    >= 2^15) -> (streams [L, S + 2] int32, lengths [L] int32)."""
    if not isinstance(probs, torch.Tensor) or probs.dim() != 2:
        raise ValueError("probs: expected an [S, L] tensor")
    S, L = probs.shape
    _check("probs", probs, torch.int32, (S, L), probs.device)
    _check("init_states", init_states, torch.int32, (L,), probs.device)
    _check_lanes(L)
    if not probs.is_cuda:
        return lane_coder_plain(probs, init_states)
    # zeroed: the kernel writes a row's words and flush state only
    streams = torch.zeros((L, S + 2), dtype=torch.int32, device=probs.device)
    lengths = torch.empty((L,), dtype=torch.int32, device=probs.device)
    launch("lane_coder", "trc_lane_coder",
           *lane_coder_cargs(probs, init_states, streams, lengths),
           counts=launches)
    return streams, lengths


def lane_coder_cargs(probs, init_states, streams, lengths) -> list:
    """The arguments of ``trc_lane_coder`` (without the stream)."""
    return [probs, init_states, streams, lengths, *probs.shape]


def _check_streams(words, lengths, K: int) -> int:
    if not isinstance(words, torch.Tensor) or words.dim() != 1:
        raise ValueError("words: expected a [W] tensor")
    if not isinstance(lengths, torch.Tensor) or lengths.dim() != 1:
        raise ValueError("lengths: expected an [L] tensor")
    L = lengths.shape[0]
    _check("words", words, torch.int16, (words.shape[0],), words.device)
    _check("lengths", lengths, torch.int32, (L,), words.device)
    _check_lanes(L)
    if K < 0 or 2 * K + 2 > INT32_MAX or words.shape[0] > INT32_MAX:
        raise ValueError(f"K = {K}, {words.shape[0]} words: out of range")
    return L


def _offsets(lengths: torch.Tensor) -> torch.Tensor:
    ln = lengths.to(torch.int64)
    return torch.cumsum(ln, 0) - ln


def lane_decode(words: torch.Tensor, lengths: torch.Tensor, K: int,
                hi_tbl: torch.Tensor, lo_tbl: torch.Tensor,
                geom: Geom = PER_LANE) -> torch.Tensor:
    """L3: lane streams (words [W] int16, lengths [L] int32) -> bytes
    [K, L] uint8."""
    L = _check_streams(words, lengths, K)
    _check_K(K, geom)
    _check_tables(hi_tbl, lo_tbl, L, geom, words.device)
    if not words.is_cuda:
        return lane_decode_plain(words, lengths, K, hi_tbl, lo_tbl, geom)
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    launch("lane_decode", "trc_lane_decode",
           *lane_decode_cargs(words, _offsets(lengths), lengths, K, hi_tbl,
                              lo_tbl, out, geom), counts=launches)
    return out


def lane_decode_cargs(words, offsets, lengths, K: int, hi_tbl, lo_tbl, out,
                      geom: Geom) -> list:
    """The arguments of ``trc_lane_decode`` (without the stream)."""
    return [words, offsets, lengths, hi_tbl, lo_tbl, out, K,
            lengths.shape[0], words.shape[0], hi_tbl.shape[0], geom.share,
            geom.sync, geom.lsync, geom.arows, geom.srows, geom.rate]


def lane_static_decode(words: torch.Tensor, lengths: torch.Tensor, K: int,
                       cdf: torch.Tensor) -> torch.Tensor:
    """L4: lane streams (words [W] int16, lengths [L] int32), cdf [257]
    int32 (non-decreasing, 0 to 2^15) -> bytes [K, L] uint8."""
    L = _check_streams(words, lengths, K)
    _check("cdf", cdf, torch.int32, (257,), words.device)
    if not words.is_cuda:
        return lane_static_decode_plain(words, lengths, K, cdf)
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    launch("lane_static_decode", "trc_lane_static_decode",
           *lane_static_decode_cargs(words, _offsets(lengths), lengths, K,
                                     cdf, out), counts=launches)
    return out


def lane_static_decode_cargs(words, offsets, lengths, K: int, cdf,
                             out) -> list:
    """The arguments of ``trc_lane_static_decode`` (without the stream)."""
    return [words, offsets, lengths, cdf, out, K, lengths.shape[0],
            words.shape[0]]
