"""Bit-tree codec rc-p (registry id 8) on the port's kernels.

Counterpart of ``turborc_tpu/codecs/rc_tree.py``; the payload is the same
bytes:

    tree [255] <u2     warm-start node probabilities, nodes 1..255
    glens [G] <u4      words per group stream (256 flush + data)
    words <u2          the group streams, each cut to its glens

The model is ``ops/bittree_kernel.py``'s 255-node adaptive bit tree,
coded a nibble at a time.  Lanes code CONTIGUOUS spans (lane l takes
bytes l*K .. l*K+K-1 after the seed bytes), padded with byte 0; there is
no rank remap.  The first ``15 * lanes / 8`` bytes ride in the coder's
initial states, as in id 57, and the warm tree counts the span after
them.  Only ``geom.groups`` and ``geom.chunk`` shape the format; the
geometry must have one state and rate 7.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from turborc_tpu_torch.codecs.rans_cdf_o0_p import (_join_seed, _seed_bytes,
                                                   _split_seed, read_streams,
                                                   stream_bytes)
from turborc_tpu_torch.ops import bittree_kernel as B_
from turborc_tpu_torch.ops.geom import DEFAULT, Geom
from turborc_tpu_torch.utils.config import resolve_device

TREE_BYTES = 2 * 255


def _K_for(n: int, g: Geom = DEFAULT) -> int:
    K = -(-n // g.lanes)
    return max(-(-K // g.chunk) * g.chunk, g.chunk)


class EncodeArgs(NamedTuple):
    """What the kernels of one block take (see ``encode_args``)."""
    tree: torch.Tensor         # [256] int32 warm tree
    init_states: torch.Tensor  # [G, 128] int32 seeded coder states
    block: torch.Tensor        # [L, K] u8 zero-padded contiguous spans
    K: int


def encode_args(data: np.ndarray, g: Geom, device) -> EncodeArgs:
    """Host half of ``encode_block``: state seeds, the warm tree and the
    padded block on ``device``."""
    s_len = min(data.shape[0], _seed_bytes(g))
    init_states = _split_seed(data[:s_len], g)
    span = data[s_len:]
    K = _K_for(span.shape[0], g)
    padded = np.zeros(g.lanes * K, np.uint8)
    padded[:span.shape[0]] = span
    return EncodeArgs(torch.from_numpy(B_.warm_tree(span)).to(device),
                      torch.from_numpy(init_states).to(device),
                      torch.from_numpy(padded.reshape(g.lanes, K)).to(device),
                      K)


def encode_block(data: np.ndarray, geom: Geom | None = None, device=None,
                 **_unused) -> bytes:
    g = geom or DEFAULT
    B_.require_tree_format(g)
    a = encode_args(data, g, resolve_device(device))
    gstreams, glens = B_.encode_tile(a.block, a.K, a.tree, a.init_states, g)
    return (a.tree[1:].cpu().numpy().astype("<u2").tobytes()
            + stream_bytes(gstreams, glens))


def decode_block(payload: bytes, n: int, geom: Geom | None = None,
                 device=None, **_unused) -> np.ndarray:
    g = geom or DEFAULT
    B_.require_tree_format(g)
    dev = resolve_device(device)
    s_len = min(n, _seed_bytes(g))
    K = _K_for(n - s_len, g)
    if len(payload) < TREE_BYTES + 4 * g.groups:
        raise ValueError("corrupt payload: truncated header")
    tree = np.zeros(256, np.int32)
    tree[1:] = np.frombuffer(payload[:TREE_BYTES], "<u2")
    if tree[1:].min() < 1 or tree[1:].max() > B_.TOTAL - 1:
        raise ValueError("corrupt payload: bad warm-start tree")
    gstreams = read_streams(payload[TREE_BYTES:], g.groups,
                            2 * K + 2 + g.wrows, dev)
    out, fstates = B_.tree_decode_tile(gstreams, K,
                                       torch.from_numpy(tree).to(dev), g)
    # [K, G, 128] -> lane-major spans
    span = out.reshape(K, g.lanes).T.reshape(-1)[:n - s_len].cpu().numpy()
    seed_bytes = _join_seed(fstates.cpu().numpy(), s_len)
    return np.concatenate([seed_bytes, span])
