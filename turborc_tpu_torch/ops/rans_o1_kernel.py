"""The order-1 flagship's kernels: wrappers, launch counts, plain versions.

Counterpart of ``turborc_tpu/ops/pallas/rans_o1_kernel.py``.  Tiles are
``[*, G, 128]`` as in ``ops/rans_kernel.py``, and so is the stream format:
the encode side feeds the o1 model's slot probabilities to the o0 coder
and placement kernels unchanged.  Only ``geom.groups``, ``geom.chunk``
(through the codec's K) and ``geom.rate`` matter here.

Kernel (CUDA, ``csrc/rans_o1_kernel.cu``)  replaces (TPU)      plain version
  model   K7: bytes -> slot probs          _make_model_kernel  model_plain
  decode  K6: group streams -> bytes       _make_decode_kernel decode_plain

K7 runs on CTAs of 32 lanes, each holding all 112 table rows of its
lanes in shared memory beside a ring of its input bytes (the launch is
the source's own).  K6 runs on the o0 decoders' ring of stream words
(``rans_kernel.ring_check`` mirrors it, two fetches a byte) with each
lane's 48 lo rows in shared memory and its 64 hi rows in a device scratch
(``hi_scratch``).

Warm tables are per group, hi [64, 16, G] and lo [48, 16, G] int32
cumulative rows, strictly increasing from 0 (as ``codecs/rans_cdf_r1_p``
builds them).  A wrapper validates its inputs, then runs the plain
version when they lie on the CPU and launches the kernel when they lie on
a CUDA device; there is no fallback.  ``launches[name]`` counts kernel
launches only.
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.models import cdf16
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_kernel as K_
from turborc_tpu_torch.ops.geom import DEFAULT, Geom

GLANES = K_.GLANES

launches = dict.fromkeys(("o1_model", "o1_decode"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def require_o1(geom: Geom) -> None:
    """Raise ValueError for a geometry the o1 format does not have."""
    if geom.nstates != 1:
        raise ValueError("the o1 pipeline has no split-state (x2) format: "
                         f"geometry {geom.spec} requires nstates=1")


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def _lane_tables(hi_tbl: torch.Tensor, lo_tbl: torch.Tensor):
    """Per-group warm tables [R, 16, G] -> per-lane [L, R, 16] int64
    (lane l is in group l // 128)."""
    return tuple(t.to(torch.int64).permute(2, 0, 1)
                 .repeat_interleave(GLANES, 0).contiguous()
                 for t in (hi_tbl, lo_tbl))


def model_plain(cols: torch.Tensor, hi_tbl: torch.Tensor,
                lo_tbl: torch.Tensor, geom: Geom = DEFAULT) -> torch.Tensor:
    """cols [K, G, 128] bytes -> probs [2K, G, 128] int32 ((low<<16)|freq;
    hi nibble at slot 2t, lo nibble at 2t+1)."""
    K, G, _ = cols.shape
    hi0, lo0 = _lane_tables(hi_tbl, lo_tbl)
    probs = R1.model_pass(cols.reshape(K, G * GLANES).T, K, hi0, lo0,
                          geom.rate)
    return ((probs[:, 0] << 16) | probs[:, 1]).reshape(
        2 * K, G, GLANES).to(torch.int32)


def decode_plain(gstreams: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                 lo_tbl: torch.Tensor, geom: Geom = DEFAULT):
    """gstreams [G, R, 128] -> (bytes [K, G, 128] uint8, final states
    [G, 128] int32).  Per nibble: row select by context, search, state
    transition, the group-ordered word fetch, update and write-back."""
    G = gstreams.shape[0]
    L = G * GLANES
    state, fetch = K_.stream_reader(gstreams)
    cdf_hi, cdf_lo = _lane_tables(hi_tbl, lo_tbl)
    prev = torch.zeros(L, dtype=torch.int64, device=gstreams.device)
    out = torch.empty((K, L), dtype=torch.uint8, device=gstreams.device)
    for t in range(K):
        ctx = R1.hictx(prev)
        hrow = R1._row_get(cdf_hi, ctx)
        hs, low_h, fr_h = cdf16.search(hrow, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_h, fr_h))
        R1._row_put(cdf_hi, ctx, cdf16.update_rate(hrow, low_h, geom.rate))
        locx = R1.locx_of(prev, hs)
        lrow = R1._row_get(cdf_lo, locx)
        ls, low_l, fr_l = cdf16.search(lrow, state & rans.MASK15)
        state = fetch(rans.dec_update(state, low_l, fr_l))
        R1._row_put(cdf_lo, locx, cdf16.update_rate(lrow, low_l, geom.rate))
        prev = (hs << 4) | ls
        out[t] = prev.to(torch.uint8)
    return (out.reshape(K, G, GLANES),
            state.reshape(G, GLANES).to(torch.int32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_tables(hi_tbl, lo_tbl, G: int, device) -> None:
    K_._check("hi_tbl", hi_tbl, torch.int32, (R1.NCTX, 16, G), device)
    K_._check("lo_tbl", lo_tbl, torch.int32, (R1.LROWS, 16, G), device)


def _check_geom(geom: Geom, G: int) -> None:
    if geom.groups != G:
        raise ValueError(f"tile has {G} groups, geometry {geom.spec} "
                         f"has {geom.groups}")
    require_o1(geom)


def hi_scratch(G: int, device) -> torch.Tensor:
    """K6's per-lane hi rows, [L, 64, 16] u16 (as int16); its lo rows are
    in shared memory."""
    return torch.empty((G * GLANES, R1.NCTX, 16), dtype=torch.int16,
                       device=device)


def model_cargs(cols, hi_tbl, lo_tbl, probs, geom: Geom) -> list:
    """The arguments of ``trc_o1_model`` (without the stream): the tile
    and the rate (the launch is the source's own: 4 CTAs a group of 32
    threads, every lane's rows and the input bytes' ring in shared
    memory)."""
    return [cols, hi_tbl, lo_tbl, probs, cols.shape[0], geom.groups,
            geom.rate]


def decode_cargs(gstreams, K: int, hi_tbl, lo_tbl, geom: Geom, scratch,
                 out, fstates) -> list:
    """The arguments of ``trc_o1_decode`` (without the stream): the tile
    and the rate (the launch is the source's own: 128 threads, the ring,
    every lane's lo rows and the rank counts in shared memory)."""
    return [gstreams, hi_tbl, lo_tbl, scratch, out, fstates, K, geom.groups,
            gstreams.shape[1], geom.rate]


def model(cols: torch.Tensor, hi_tbl: torch.Tensor, lo_tbl: torch.Tensor,
          geom: Geom = DEFAULT) -> torch.Tensor:
    """K7: cols [K, G, 128] uint8 -> probs [2K, G, 128] int32."""
    K, G = cols.shape[0], geom.groups
    _check_geom(geom, G)
    K_._check("cols", cols, torch.uint8, (K, G, GLANES), cols.device)
    _check_tables(hi_tbl, lo_tbl, G, cols.device)
    if not cols.is_cuda:
        return model_plain(cols, hi_tbl, lo_tbl, geom)
    if cols.data_ptr() % 16:  # the ring copies 16 bytes at a time
        raise ValueError("cols: must be 16-byte aligned")
    probs = torch.empty((2 * K, G, GLANES), dtype=torch.int32,
                        device=cols.device)
    K_.launch("o1_model", "trc_o1_model",
              *model_cargs(cols, hi_tbl, lo_tbl, probs, geom),
              counts=launches)
    return probs


def decode_tile(gstreams: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                lo_tbl: torch.Tensor, geom: Geom = DEFAULT):
    """K6: gstreams [G, R, 128] int32 -> (bytes [K, G, 128] uint8, final
    states [G, 128] int32; the final states carry the 15-bit seeds)."""
    G, R = geom.groups, gstreams.shape[1]
    dev = gstreams.device
    _check_geom(geom, G)
    K_._check("gstreams", gstreams, torch.int32, (G, R, GLANES), dev)
    _check_tables(hi_tbl, lo_tbl, G, dev)
    if R < 2:
        raise ValueError("gstreams: needs the two flush-state rows")
    K_.check_ring_stream(gstreams)
    if not gstreams.is_cuda:
        return decode_plain(gstreams, K, hi_tbl, lo_tbl, geom)
    out = torch.empty((K, G, GLANES), dtype=torch.uint8, device=dev)
    fstates = torch.empty((G, GLANES), dtype=torch.int32, device=dev)
    K_.launch("o1_decode", "trc_o1_decode",
              *decode_cargs(gstreams, K, hi_tbl, lo_tbl, geom,
                            hi_scratch(G, dev), out, fstates),
              counts=launches)
    return out, fstates


def encode_tile(block: torch.Tensor, K: int, hi_tbl: torch.Tensor,
                lo_tbl: torch.Tensor, init_states: torch.Tensor,
                geom: Geom = DEFAULT):
    """block [L, K] bytes, lane l = contiguous span l -> (gstreams
    [G, R, 128], glens [G]): the o1 model, then the o0 coder and
    placement (JAX ``encode_tile``)."""
    cols = block.to(torch.uint8).T.contiguous().reshape(K, geom.groups,
                                                        GLANES)
    probs = model(cols, hi_tbl, lo_tbl, geom)
    words, emit, state = K_.coder(probs, init_states)
    return K_.place(words, emit, state, geom)
