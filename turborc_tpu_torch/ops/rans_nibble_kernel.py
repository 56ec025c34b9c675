"""The nibble codecs' kernels L9 and L10: wrappers, launch counts and plain
versions.

The JAX package runs ids 41 (``rc4``) and 40 (``rc4c``) as ``lax.scan``s
over lanes (``turborc_tpu/codecs/rans_nibble.py``); they reach no Pallas
kernel.  Each device loop is one hand-written kernel in
``csrc/rans_lane_kernel.cu``, beside L1 and L3, whose team helpers they
share; the coder is L2 (``rans_lane_kernel.lane_coder``):

Kernel (wrapper)                 computes                 JAX pass
  L9  lane_nibble_model          bytes -> slot probs      encode_adaptive's
                                                          scan
  L10 lane_nibble_decode         streams -> bytes         decode_adaptive
      lane_nibble_static_decode  streams -> bytes         decode_static

Each wrapper's plain version is ``<wrapper>_plain``.  A byte is two
4-bit symbols, hi then lo: slot probs ``[2K, L]`` int32 ``(low << 16) |
freq``, the hi nibble of byte t at slot 2t and the lo at 2t + 1; the
other layouts are those of ``ops/rans_lane_kernel.py`` (bytes ``[K,
L]``, lane streams as ``words`` [W] int16 and ``lengths`` [L] int32, read
as L3 reads them).  The adaptive model is one CDF16 a lane from
``cdf16.init``, updated at rate 7 after every nibble; the static decode
reads the block's ``cdf`` [17] int32 (non-decreasing, cdf[0] = 0,
cdf[16] = 2^15): the symbol of a value v is 15 - #{i < 16: cdf[i] > v},
taken as at least 0.

Both kernels run ``NIB_LANES`` lanes a CTA: L9 a team of ``NIB_TEAM``
threads a lane, one table entry a thread, L10 a warp a lane
(``nib_launch``).  A wrapper validates its inputs (L10's static cdf must
be non-decreasing from 0 to 2^15, the tables the codec passes), then
runs the plain version when they lie on the CPU and launches the kernel
when they lie on a CUDA device; there is no fallback from one to the
other.  ``launches[name]`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops.rans_kernel import INT32_MAX, _check, launch

# kNibLanes lanes a CTA; L9: kNibTeam threads a lane; L10: a warp a lane
NIB_LANES = 4
NIB_TEAM = 16

launches = dict.fromkeys(("lane_nibble_model", "lane_nibble_decode",
                          "lane_nibble_static_decode"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nib_launch(L: int, decode: bool = False) -> tuple[int, int]:
    """(threads a CTA, CTAs) of L9 (or, ``decode``, L10) on L lanes."""
    return NIB_LANES * (32 if decode else NIB_TEAM), -(-L // NIB_LANES)


def _check_cdf(cdf: torch.Tensor) -> None:
    """L10's static cdf: non-decreasing from 0 to 2^15 (rc4c's, from 16
    freqs summing 2^15); the kernel's symbol rule holds for these."""
    c = cdf.to("cpu", torch.int64)
    if c[0] != 0 or c[16] != cdf16.TOTAL or bool((c[1:] < c[:-1]).any()):
        raise ValueError("cdf: expected a non-decreasing [17] cdf from 0 "
                         "to 2^15")


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def nibbles(cols: torch.Tensor) -> torch.Tensor:
    """Bytes [K, L] -> nibbles [2K, L] int64, hi then lo."""
    c = cols.to(torch.int64)
    return torch.stack([c >> 4, c & 15], 1).reshape(2 * c.shape[0], -1)


def lane_nibble_model_plain(cols: torch.Tensor) -> torch.Tensor:
    """cols [K, L] bytes -> probs [2K, L] int32 ((low << 16) | freq)."""
    nibs = nibbles(cols)
    cdf = cdf16.init((cols.shape[1],), cols.device).to(torch.int64)
    probs = torch.empty(nibs.shape, dtype=torch.int64, device=cols.device)
    for s in range(nibs.shape[0]):
        low, freq = cdf16.lookup(cdf, nibs[s])
        probs[s] = (low << 16) | freq
        cdf = cdf16.update(cdf, low)
    return probs.to(torch.int32)


def _join(nibs: torch.Tensor) -> torch.Tensor:
    """Nibbles [2K, L] -> bytes [K, L] uint8 (hi, lo)."""
    hilo = nibs.reshape(-1, 2, nibs.shape[1])
    return ((hilo[:, 0] << 4) | hilo[:, 1]).to(torch.uint8)


def lane_nibble_decode_plain(words: torch.Tensor, lengths: torch.Tensor,
                             K: int) -> torch.Tensor:
    """Lane streams (words, lengths) -> bytes [K, L] uint8
    (rans_nibble.decode_adaptive)."""
    state, fetch = LK.stream_reader(words, lengths, 2 * K + 2)
    cdf = cdf16.init((lengths.shape[0],), words.device).to(torch.int64)
    nibs = torch.empty((2 * K, lengths.shape[0]), dtype=torch.int64,
                       device=words.device)
    for s in range(2 * K):
        sym, low, freq = cdf16.search(cdf, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low, freq))
        cdf = cdf16.update(cdf, low)
        nibs[s] = sym
    return _join(nibs)


def lane_nibble_static_decode_plain(words: torch.Tensor,
                                    lengths: torch.Tensor, K: int,
                                    cdf: torch.Tensor) -> torch.Tensor:
    """Lane streams (words, lengths), cdf [17] -> bytes [K, L] uint8
    (rans_nibble.decode_static)."""
    c = cdf.to(torch.int64)
    state, fetch = LK.stream_reader(words, lengths, 2 * K + 2)
    nibs = torch.empty((2 * K, lengths.shape[0]), dtype=torch.int64,
                       device=words.device)
    for s in range(2 * K):
        value = state & rans.MASK15
        sym = (15 - (c[None, :16] > value[:, None]).sum(-1)).clamp(min=0)
        low = c[sym]
        state = fetch(rans.dec_update(state, low, c[sym + 1] - low))
        nibs[s] = sym
    return _join(nibs)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def lane_nibble_model(cols: torch.Tensor) -> torch.Tensor:
    """L9: cols [K, L] uint8 -> probs [2K, L] int32 (id 41)."""
    if not isinstance(cols, torch.Tensor) or cols.dim() != 2:
        raise ValueError("cols: expected a [K, L] tensor")
    K, L = cols.shape
    _check("cols", cols, torch.uint8, (K, L), cols.device)
    LK._check_lanes(L)
    if 2 * K + 2 * NIB_TEAM > INT32_MAX:
        raise ValueError(f"K = {K}: out of range")
    if not cols.is_cuda:
        return lane_nibble_model_plain(cols)
    probs = torch.empty((2 * K, L), dtype=torch.int32, device=cols.device)
    launch("lane_nibble_model", "trc_lane_nibble_model",
           *lane_nibble_model_cargs(cols, probs), counts=launches)
    return probs


def lane_nibble_model_cargs(cols, probs) -> list:
    """The arguments of ``trc_lane_nibble_model`` (without the stream)."""
    return [cols, probs, *cols.shape]


def lane_nibble_decode(words: torch.Tensor, lengths: torch.Tensor,
                       K: int) -> torch.Tensor:
    """L10, adaptive: lane streams (words [W] int16, lengths [L] int32) ->
    bytes [K, L] uint8 (id 41)."""
    LK._check_streams(words, lengths, K)
    if not words.is_cuda:
        return lane_nibble_decode_plain(words, lengths, K)
    out = torch.empty((K, lengths.shape[0]), dtype=torch.uint8,
                      device=words.device)
    launch("lane_nibble_decode", "trc_lane_nibble_decode",
           *lane_nibble_decode_cargs(words, LK._offsets(lengths), lengths, K,
                                     None, out), counts=launches)
    return out


def lane_nibble_static_decode(words: torch.Tensor, lengths: torch.Tensor,
                              K: int, cdf: torch.Tensor) -> torch.Tensor:
    """L10, static: lane streams (words [W] int16, lengths [L] int32), cdf
    [17] int32 -> bytes [K, L] uint8 (id 40)."""
    LK._check_streams(words, lengths, K)
    _check("cdf", cdf, torch.int32, (17,), words.device)
    _check_cdf(cdf)
    if not words.is_cuda:
        return lane_nibble_static_decode_plain(words, lengths, K, cdf)
    out = torch.empty((K, lengths.shape[0]), dtype=torch.uint8,
                      device=words.device)
    launch("lane_nibble_static_decode", "trc_lane_nibble_decode",
           *lane_nibble_decode_cargs(words, LK._offsets(lengths), lengths, K,
                                     cdf, out), counts=launches)
    return out


def lane_nibble_decode_cargs(words, offsets, lengths, K: int, cdf,
                             out) -> list:
    """The arguments of ``trc_lane_nibble_decode`` (without the stream);
    ``cdf`` None is the adaptive decode."""
    return [words, offsets, lengths, cdf, out, K, lengths.shape[0],
            words.shape[0]]
