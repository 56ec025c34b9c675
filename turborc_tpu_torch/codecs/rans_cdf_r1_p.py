"""Order-1 flagship codec rans-cdf-r1-p (registry id 60) on the port's
kernels.

Counterpart of ``turborc_tpu/codecs/rans_pallas_r1.py``; the payload is
the same bytes:

    perm [256] u8      byte permutation by global frequency rank
    pack_codes(...)    per-segment o1 warm tables ([G_eff, 1792] codes)
    glens [G] <u4      words per group stream (256 flush + data)
    words <u2          the group streams, each cut to its glens

Lanes code CONTIGUOUS spans of the rank-remapped block (lane l takes
bytes l*K .. l*K+K-1 after the seed bytes), with per-lane order-1 models
warm-started from ``G_eff = n_segments(n, groups)`` conditional tables,
segment ``(g * G_eff) // groups`` serving group g.  The first
``15 * lanes / 8`` remapped bytes ride in the coder's initial states, as
in id 57; the span is padded with rank 0 after the remap.  Only
``geom.groups``, ``geom.chunk`` and ``geom.rate`` shape the format.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio as _bio
from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.codecs.rans_cdf_o0_p import (_join_seed, _rank_perm,
                                                   _seed_bytes, _split_seed,
                                                   read_streams,
                                                   stream_bytes)
from turborc_tpu_torch.ops import rans_o1_kernel as K1
from turborc_tpu_torch.ops.geom import DEFAULT, Geom
from turborc_tpu_torch.utils.config import resolve_device


def _K_for(n: int, g: Geom = DEFAULT) -> int:
    K = -(-n // g.lanes)
    q = g.chunk
    return max(-(-K // q) * q, q)


def _cum_args(hi_q: np.ndarray, lo_q: np.ndarray, device):
    """[G,R,16] dequantized freqs -> kernel args [R,16,G] int32 cdfs on
    ``device``."""
    return tuple(
        torch.from_numpy(np.transpose(_bio.cumulative(q), (1, 2, 0)).copy())
        .to(device) for q in (hi_q, lo_q))


def _segments(n: int, g: Geom) -> tuple[int, np.ndarray]:
    """(G_eff, the table segment of each group)."""
    G_eff = R1.n_segments(n, g.groups)
    return G_eff, (np.arange(g.groups, dtype=np.int64) * G_eff) // g.groups


class EncodeArgs(NamedTuple):
    """What the kernels of one block take (see ``encode_args``)."""
    perm: np.ndarray           # [256] u8 rank permutation
    codes: np.ndarray          # [G_eff, 1792] u8 warm-table codes
    hi_tbl: torch.Tensor       # [64, 16, G] int32 warm cdfs
    lo_tbl: torch.Tensor       # [48, 16, G] int32 warm cdfs
    init_states: torch.Tensor  # [G, 128] int32 seeded coder states
    block: torch.Tensor        # [L, K] u8 remapped bytes, contiguous spans
    K: int


def encode_args(data: np.ndarray, g: Geom, device) -> EncodeArgs:
    """Host half of ``encode_block``: rank remap, state seeds,
    conditional warm tables and the padded block on ``device``."""
    n = data.shape[0]
    perm = _rank_perm(data) if n else np.arange(256, dtype=np.uint8)
    inv = np.zeros(256, np.uint8)
    inv[perm] = np.arange(256, dtype=np.uint8)
    mapped = inv[data]
    s_len = min(n, _seed_bytes(g))
    init_states = _split_seed(mapped[:s_len], g)
    span = mapped[s_len:]
    K = _K_for(span.shape[0], g)
    padded = np.zeros(g.lanes * K, np.uint8)
    padded[:span.shape[0]] = span
    G_eff, seg = _segments(n, g)
    codes, (hi_q, lo_q) = R1.quantize_tables(
        *R1.group_tables(padded, G_eff))
    hi_tbl, lo_tbl = _cum_args(hi_q[seg], lo_q[seg], device)
    block = torch.from_numpy(padded.reshape(g.lanes, K)).to(device)
    return EncodeArgs(perm, codes, hi_tbl, lo_tbl,
                      torch.from_numpy(init_states).to(device), block, K)


def encode_block(data: np.ndarray, geom: Geom | None = None, device=None,
                 **_unused) -> bytes:
    g = geom or DEFAULT
    K1.require_o1(g)
    dev = resolve_device(device)
    a = encode_args(data, g, dev)
    gstreams, glens = K1.encode_tile(a.block, a.K, a.hi_tbl, a.lo_tbl,
                                     a.init_states, g)
    return (a.perm.tobytes() + _bio.pack_codes(a.codes)
            + stream_bytes(gstreams, glens))


def decode_block(payload: bytes, n: int, geom: Geom | None = None,
                 device=None, **_unused) -> np.ndarray:
    g = geom or DEFAULT
    K1.require_o1(g)
    dev = resolve_device(device)
    s_len = min(n, _seed_bytes(g))
    K = _K_for(n - s_len, g)
    if len(payload) < 256 + 4 + R1.N_ENTRIES:
        raise ValueError("corrupt payload: truncated header")
    perm = np.frombuffer(payload[:256], np.uint8)
    G_eff, seg = _segments(n, g)
    codes, consumed = _bio.unpack_codes(payload[256:], G_eff,
                                        n_entries=R1.N_ENTRIES)
    hi_q, lo_q = R1.codes_to_tables(codes)
    gstreams = read_streams(payload[256 + consumed:], g.groups,
                            2 * K + 2 + g.wrows, dev)
    hi_tbl, lo_tbl = _cum_args(hi_q[seg], lo_q[seg], dev)
    out, fstates = K1.decode_tile(gstreams, K, hi_tbl, lo_tbl, g)
    # [K, G, 128] -> lane-major spans, then undo the rank remap
    flat = out.reshape(K, g.lanes).T.reshape(-1)[:n - s_len]
    perm_t = torch.from_numpy(perm.copy()).to(dev)
    span_bytes = perm_t[flat.to(torch.int64)].cpu().numpy()
    seed_bytes = _join_seed(fstates.cpu().numpy(), s_len)
    return np.concatenate([perm[seed_bytes], span_bytes])
