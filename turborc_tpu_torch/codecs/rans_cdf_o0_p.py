"""Flagship codec rans-cdf-o0-p (registry id 57) on the port's kernels.

Counterpart of ``turborc_tpu/codecs/rans_pallas.py``; the payload is the
same bytes:

    perm [256] u8      byte permutation by global frequency rank
    pack_codes(...)    per-group warm tables (8-bit log codes, deltas)
    glens [G] <u4      words per group stream (256 flush + data)
    words <u2          the group streams, each cut to its glens

Lanes are ``G`` groups of 128; ``share`` adjacent lanes model one
contiguous ``share*K``-byte span with lane j taking bytes t*share + j.
The first ``15 * lanes * nstates / 8`` (remapped) bytes of a block ride
in the encoder's initial states (``2^15 | seed15``) and come back as the
decoder's final states.  Under a split-state geometry (``nstates == 2``)
there are two stream sets, the hi nibbles' and then the lo nibbles', so
``glens`` has 2G entries and the words 2G streams in that order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio as _bio
from turborc_tpu_torch.ops import rans_kernel as K_
from turborc_tpu_torch.ops.geom import DEFAULT, Geom
from turborc_tpu_torch.utils.config import resolve_device

SEED_BITS = 15


def _K_for(n: int, g: Geom = DEFAULT) -> int:
    K = -(-n // g.lanes)
    q = g.step_quant  # chunk AND cold-sync alignment
    return max(-(-K // q) * q, q)


def _seed_bytes(g: Geom) -> int:
    return SEED_BITS * g.lanes * g.nstates // 8


def _split_seed(data: np.ndarray, g: Geom = DEFAULT) -> np.ndarray:
    """Remapped seed bytes -> encoder initial states int32 (``2^15 |
    seed15``; missing bytes are zero): [G, 128], or [2, G, 128] for a
    split-state geometry (state 0's seeds first)."""
    buf = np.zeros(_seed_bytes(g), np.uint8)
    buf[:data.shape[0]] = data
    bits = np.unpackbits(buf).reshape(g.nstates * g.lanes, SEED_BITS)
    pw = (1 << np.arange(SEED_BITS - 1, -1, -1)).astype(np.int64)
    seeds = bits.astype(np.int64) @ pw
    shape = (g.groups, 128) if g.nstates == 1 else (2, g.groups, 128)
    return (seeds | (1 << SEED_BITS)).astype(np.int32).reshape(shape)


def _join_seed(fstates: np.ndarray, s_len: int) -> np.ndarray:
    seeds = fstates.reshape(-1).astype(np.int64) & 0xFFFFFFFF
    if (seeds >> SEED_BITS != 1).any():
        raise ValueError("corrupt payload: bad final coder states")
    seeds &= (1 << SEED_BITS) - 1
    bits = ((seeds[:, None] >> np.arange(SEED_BITS - 1, -1, -1)) & 1)
    return np.packbits(bits.astype(np.uint8).reshape(-1))[:s_len]


def _rank_perm(data: np.ndarray) -> np.ndarray:
    counts = np.bincount(data, minlength=256)
    return np.argsort(-counts, kind="stable").astype(np.uint8)


def _group_byte_counts(span: np.ndarray, g: Geom, K: int,
                       pad_byte: int) -> np.ndarray:
    """[G, 256] original-byte counts over each group's padded span slice;
    padding is pad_byte = perm[0], so it codes at rank 0."""
    per = g.lanes * K // g.groups
    counts = np.zeros((g.groups, 256), np.int64)
    for gi in range(g.groups):
        s = span[gi * per:(gi + 1) * per]
        if s.size:
            counts[gi] = np.bincount(s, minlength=256)
        counts[gi, pad_byte] += per - s.size
    return counts


def _cum_args(hi_f: np.ndarray, lo_f: np.ndarray, device):
    """freq tables [G,16] / [G,16,16] -> kernel args hi [16, G],
    lo [16, 16, G] int32 on ``device``."""
    hi = _bio.cumulative(hi_f).T.copy()
    lo = np.transpose(_bio.cumulative(lo_f), (1, 2, 0)).copy()
    return (torch.from_numpy(hi).to(device),
            torch.from_numpy(lo).to(device))


def _pre_encode(padded: torch.Tensor, inv: torch.Tensor, K: int, S: int,
                share: int) -> torch.Tensor:
    """Padded span bytes [S*share*K] -> rank-remapped block in kernel
    lane order [S*share, K] uint8."""
    mapped = inv[padded.to(torch.int64)]
    return mapped.reshape(S, K, share).permute(0, 2, 1).reshape(S * share, K)


def _post_decode(out: torch.Tensor, perm: torch.Tensor, K: int, S: int,
                 share: int) -> torch.Tensor:
    """Decoder output [K, G, 128] -> file-order original bytes
    [S*share*K] (un-stride the spans, undo the rank remap)."""
    x = out.reshape(K, S, share).permute(1, 0, 2).reshape(-1)
    return perm[x.to(torch.int64)]


def _round_rows(rows_needed: int, cap: int) -> int:
    return min(cap, -(-rows_needed // 256) * 256)


def stream_bytes(gstreams: torch.Tensor, glens: torch.Tensor) -> bytes:
    """Group streams [G, R, 128] and their lengths [G] -> the payload's
    tail: glens <u4, then each group's first glens words <u2."""
    G = gstreams.shape[0]
    glens_np = glens.cpu().numpy().astype(np.int64)
    rows = _round_rows(-(-int(glens_np.max()) // 128), gstreams.shape[1])
    gs = gstreams[:, :rows, :].reshape(G, rows * 128)
    pos = torch.arange(rows * 128, device=gs.device)
    keep = pos[None, :] < glens.to(torch.int64)[:, None]
    flat = gs[keep].cpu().numpy().astype("<u2")
    return glens_np.astype("<u4").tobytes() + flat.tobytes()


def read_streams(buf: bytes, G: int, R: int, device) -> torch.Tensor:
    """Inverse of ``stream_bytes`` into R rows per group: group streams
    [G, R, 128] int32 on ``device``, zero past each group's words.
    Raises ValueError when the length table does not fit the words or
    R rows."""
    glens = np.frombuffer(buf[:4 * G], "<u4").astype(np.int64)
    flat = np.frombuffer(buf[4 * G:len(buf) & ~1], "<u2")
    if glens.size != G or glens.max() > R * 128 or glens.min() < 256 \
            or glens.sum() != flat.size:
        raise ValueError("corrupt payload: group length table inconsistent")
    glens_t = torch.from_numpy(glens).to(device)
    gid = torch.repeat_interleave(torch.arange(G, device=device), glens_t)
    starts = torch.cumsum(glens_t, 0) - glens_t
    within = torch.arange(flat.size, device=device) - starts[gid]
    gstreams = torch.zeros((G, R * 128), dtype=torch.int32, device=device)
    gstreams[gid, within] = torch.from_numpy(flat.astype(np.int32)).to(
        device)
    return gstreams.reshape(G, R, 128)


class EncodeArgs(NamedTuple):
    """What the kernels of one block take (see ``encode_args``)."""
    perm: np.ndarray          # [256] u8 rank permutation
    codes: np.ndarray         # [G, 272] u8 warm-table codes
    hi_tbl: torch.Tensor      # [16, G] int32 warm cdfs
    lo_tbl: torch.Tensor      # [16, 16, G] int32 warm cdfs
    init_states: torch.Tensor  # [G, 128] (x2: [2, G, 128]) int32 seeds
    block: torch.Tensor       # [L, K] u8 remapped bytes, kernel lane order
    K: int


def encode_args(data: np.ndarray, g: Geom, device) -> EncodeArgs:
    """Host half of ``encode_block``: rank remap, state seeds, warm
    tables and the padded, lane-strided block on ``device``."""
    n = data.shape[0]
    perm = _rank_perm(data) if n else np.arange(256, dtype=np.uint8)
    inv = np.zeros(256, np.uint8)
    inv[perm] = np.arange(256, dtype=np.uint8)
    s_len = min(n, _seed_bytes(g))
    init_states = _split_seed(inv[data[:s_len]], g)
    span = data[s_len:]
    K = _K_for(span.shape[0], g)
    # warm tables: original-byte histograms, remap applied to the columns
    jr = _group_byte_counts(span, g, K, int(perm[0]))[:, perm]
    hi_q_raw = _bio.quantize_freqs(jr.reshape(g.groups, 16, 16).sum(-1))
    lo_q_raw = _bio.quantize_freqs(jr.reshape(g.groups, 16, 16))
    codes, (hi_q, lo_q) = _bio.quantize_tables(hi_q_raw, lo_q_raw)
    hi_tbl, lo_tbl = _cum_args(hi_q, lo_q, device)
    padded = np.full(g.lanes * K, perm[0], np.uint8)
    padded[:span.shape[0]] = span
    block = _pre_encode(torch.from_numpy(padded).to(device),
                        torch.from_numpy(inv).to(device), K,
                        g.lanes // g.share, g.share)
    return EncodeArgs(perm, codes, hi_tbl, lo_tbl,
                      torch.from_numpy(init_states).to(device), block, K)


def encode_block(data: np.ndarray, geom: Geom | None = None, device=None,
                 **_unused) -> bytes:
    g = geom or DEFAULT
    dev = resolve_device(device)
    a = encode_args(data, g, dev)
    gstreams, glens = K_.encode_tile(a.block, a.K, a.hi_tbl, a.lo_tbl,
                                     a.init_states, g)
    nst = g.nstates * g.groups  # x2: the hi set's streams, then the lo's
    return (a.perm.tobytes() + _bio.pack_codes(a.codes)
            + stream_bytes(gstreams.reshape(nst, *gstreams.shape[-2:]),
                           glens.reshape(nst)))


def decode_block(payload: bytes, n: int, geom: Geom | None = None,
                 device=None, **_unused) -> np.ndarray:
    g = geom or DEFAULT
    dev = resolve_device(device)
    s_len = min(n, _seed_bytes(g))
    K = _K_for(n - s_len, g)
    if len(payload) < 256 + 4 + 272:
        raise ValueError("corrupt payload: truncated header")
    perm = np.frombuffer(payload[:256], np.uint8)
    codes, consumed = _bio.unpack_codes(payload[256:], g.groups)
    hi_q, lo_q = _bio.codes_to_tables(codes)
    R = 2 * K // g.nstates + 2 + g.wrows  # slots per stream + 2 + window
    gstreams = read_streams(payload[256 + consumed:], g.nstates * g.groups,
                            R, dev)
    hi_tbl, lo_tbl = _cum_args(hi_q, lo_q, dev)
    if g.nstates == 1:
        out, fstates = K_.decode_tile(gstreams, K, hi_tbl, lo_tbl, g)
    else:
        out, fstates = K_.decode_tile_x2(gstreams.reshape(2, g.groups, R,
                                                          128),
                                         K, hi_tbl, lo_tbl, g)
    perm_t = torch.from_numpy(perm.copy()).to(dev)
    flat_bytes = _post_decode(out, perm_t, K, g.lanes // g.share,
                              g.share)[:n - s_len].cpu().numpy()
    seed_bytes = _join_seed(fstates.cpu().numpy(), s_len)
    return np.concatenate([perm[seed_bytes], flat_bytes])
