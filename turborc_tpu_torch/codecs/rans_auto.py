"""Auto-dispatching flagship rans-auto (registry id 61): pick the arm per
block.

Counterpart of ``turborc_tpu/codecs/rans_auto.py``; the payload is the
same bytes: a 1-byte tag, then the chosen arm's payload.

  tag 0  share-span order-0 flagship (id 57) at the caller's geometry
  tag 1  contiguous order-1 flagship (id 60) at the caller's geometry
  tag 2  order-0 flagship at the caller's geometry with share = 1
  tag 3  order-1 flagship at its own geometry, ``Geom.pack`` (4 bytes)
         after the tag; chosen only when the caller passed no geometry

The order-1 arm is taken when the held-out order-1 gain (bits per byte
saved by conditioning on min(previous rank, 15), trained on the first
half of up to eight 64 KB windows and scored on the second) reaches
``GAIN_THRESHOLD``; else tag 2 when the mean run length reaches
``RUN_THRESHOLD`` and the caller's geometry shares lanes, else tag 0.
The arms are always the kernel codecs 57 and 60, which is the JAX
package's choice off the CPU; its CPU arms (ids 58/59) are another
format.  Under a split-state geometry (``x2``) the o0 arms code two
states a lane and the o1 arm raises ValueError, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from turborc_tpu_torch.codecs import rans_cdf_o0_p, rans_cdf_r1_p
from turborc_tpu_torch.ops.geom import DEFAULT, Geom

GAIN_THRESHOLD = 0.2   # bits/byte of held-out order-1 gain
RUN_THRESHOLD = 2.5    # mean run length above which striding hurts
_WIN = 64 << 10
_MAX_WINDOWS = 8

_TAG_S8, _TAG_R1, _TAG_S1, _TAG_R1G = 0, 1, 2, 3

# The o1 arm's own geometry by block size (tag 3): fewer lanes, longer
# spans for larger blocks.
_R1_SPECS = ((4 << 20, "g4c8s8y4l32a16r4"),
             (1 << 20, "g8c8s8y4l32a16r4"))


def _impls():
    return rans_cdf_o0_p, rans_cdf_r1_p


def _window_gain(d: np.ndarray) -> float:
    """Held-out bits/byte saved by conditioning on min(prev_rank, 15)."""
    counts = np.bincount(d, minlength=256)
    rank = np.zeros(256, np.int64)
    rank[np.argsort(-counts, kind="stable")] = np.arange(256)
    r = rank[d]
    half = d.shape[0] // 2
    ctx = np.minimum(r[:-1], 15)
    cur = r[1:]
    tr_c, tr_x = cur[:half], ctx[:half]
    te_c, te_x = cur[half:], ctx[half:]
    o1 = np.zeros((16, 256), np.float64)
    np.add.at(o1, (tr_x, tr_c), 1)
    o0 = o1.sum(axis=0)
    p1 = (o1 + 0.5) / (o1.sum(axis=1, keepdims=True) + 128)
    p0 = (o0 + 0.5) / (o0.sum() + 128)
    ce1 = float(-np.log2(p1[te_x, te_c]).mean())
    ce0 = float(-np.log2(p0[te_c]).mean())
    return ce0 - ce1


def o1_gain(data: np.ndarray) -> float:
    """Mean held-out order-1 gain over up to 8 64 KB sample windows."""
    n = data.shape[0]
    if n < 4096:
        return 0.0  # tiny blocks: table overhead decides, stay order-0
    wins = max(1, min(_MAX_WINDOWS, n // _WIN))
    gains = []
    for w in range(wins):
        off = (n - min(_WIN, n)) * w // max(wins - 1, 1)
        gains.append(_window_gain(data[off:off + _WIN]))
    return float(np.mean(gains))


def mean_run(data: np.ndarray) -> float:
    """Mean run length (sampled: first/last 1 MB for large blocks)."""
    n = data.shape[0]
    if n < 2:
        return 1.0
    if n > (2 << 20):
        d = np.concatenate([data[:1 << 20], data[-(1 << 20):]])
    else:
        d = data
    changes = int((d[1:] != d[:-1]).sum()) + 1
    return d.shape[0] / changes


def _share1(geom):
    return dataclasses.replace(geom or DEFAULT, share=1)


def _r1_geom(n: int, geom):
    """The o1 arm's own geometry for an n-byte block, or None to keep the
    caller's: a geometry the caller passed always wins."""
    if geom is not None:
        return None
    for floor, spec in _R1_SPECS:
        if n >= floor:
            return Geom.parse(spec)
    return None


def encode_block(data: np.ndarray, **kw) -> bytes:
    s8, r1 = _impls()
    geom = kw.get("geom")
    if o1_gain(data) >= GAIN_THRESHOLD:
        g1 = _r1_geom(data.shape[0], geom)
        if g1 is not None:
            return (bytes([_TAG_R1G]) + g1.pack()
                    + r1.encode_block(data, **dict(kw, geom=g1)))
        tag, mod = _TAG_R1, r1
    elif (geom is None or geom.share > 1) and mean_run(data) >= RUN_THRESHOLD:
        tag, mod = _TAG_S1, s8
        kw = dict(kw, geom=_share1(geom))
    else:
        tag, mod = _TAG_S8, s8
    return bytes([tag]) + mod.encode_block(data, **kw)


def decode_block(payload: bytes, n: int, **kw) -> np.ndarray:
    if not payload:
        raise ValueError("corrupt payload: missing auto-dispatch tag")
    tag = payload[0]
    if tag not in (_TAG_S8, _TAG_R1, _TAG_S1, _TAG_R1G):
        raise ValueError(f"corrupt payload: bad auto-dispatch tag {tag}")
    s8, r1 = _impls()
    if tag == _TAG_R1G:
        if len(payload) < 5:
            raise ValueError("corrupt payload: truncated auto geometry")
        try:
            g = Geom.unpack(payload[1:5])
        except ValueError as e:
            raise ValueError(f"corrupt payload: bad auto geometry ({e})")
        return r1.decode_block(payload[5:], n, **dict(kw, geom=g))
    if tag == _TAG_S1:
        kw = dict(kw, geom=_share1(kw.get("geom")))
    mod = r1 if tag == _TAG_R1 else s8
    return mod.decode_block(payload[1:], n, **kw)
