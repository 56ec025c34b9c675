"""The order-1 per-lane scan codecs' kernels L5-L8: wrappers, launch counts
and plain versions.

The JAX package runs ids 59 (``rans-cdf-r1``) and 64 (``rans-cdf-o1``) as
``lax.scan``s over lanes (``turborc_tpu/codecs/rans_cdf_r1.py``,
``rans_cdf_o1.py``); they reach no Pallas kernel.  Each device loop is
one hand-written kernel in ``csrc/rans_lane_kernel.cu`` (the templates
``lane_o1_model_kernel`` and ``lane_o1_decode_kernel`` on id 59's context
``O1Rank`` and id 64's ``O1Byte``); the coder is L2
(``rans_lane_kernel.lane_coder``):

Kernel (wrapper)          computes                JAX pass
  L5 lane_o1r_model       bytes -> slot probs     rans_cdf_r1.model_pass
  L6 lane_o1r_decode      streams -> bytes        rans_cdf_r1.decode_device
  L7 lane_o1_model        bytes -> slot probs     rans_cdf_o1.encode_device's
                                                  model scan
  L8 lane_o1_decode       streams -> bytes        rans_cdf_o1.decode_device

Each wrapper's plain version is ``<wrapper>_plain``, on the passes of
``codecs/rans_cdf_r1.py`` (``model_pass``, ``decode_pass``; id 64 on
``BYTE_ROWS`` from ``byte_tables``).  The layouts are those of
``ops/rans_lane_kernel.py``: bytes ``[K, L]``, probs ``[2K, L]`` int32
``(low << 16) | freq``, lane streams as ``words`` [W] int16 and
``lengths`` [L] int32, read as L3 reads them.  Id 59's tables are per
segment, cumulative int32 hi [n_seg, 64, 16] and lo [n_seg, 48, 16],
strictly increasing from 0 (``rans_cdf_r1_lane.segment_cdfs``); lane l starts from
segment ``l * n_seg // L``.  Id 64 starts every lane at ``cdf16.init``.

The kernels run a team of ``O1_TEAM`` threads a lane, ``O1R_LANES`` lanes
a CTA (id 59) or one lane a CTA beside a dummy team (id 64, whose 4,352
rows a lane take 139,264 B of shared memory).  A wrapper validates its
inputs, then runs the plain version when they lie on the CPU and
launches the kernel when they lie on a CUDA device; there is no fallback
from one to the other.  ``launches[name]`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops.rans_kernel import _check, launch

# kTeam threads a lane; O1Rank::kLanes and O1Byte::kLanes lanes a CTA
O1_TEAM = 16
O1R_LANES = 8
O1_LANES = 1

launches = dict.fromkeys(("lane_o1r_model", "lane_o1r_decode",
                          "lane_o1_model", "lane_o1_decode"), 0)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def o1_launch(L: int, codec: str) -> tuple[int, int, int, int]:
    """(lanes a CTA, threads a CTA, shared-memory bytes, CTAs) of L5 / L6
    (``codec`` "rans-cdf-r1") or L7 / L8 ("rans-cdf-o1") on L lanes: the
    source's o1_threads, o1_smem and grid."""
    hi, lo, lanes = {"rans-cdf-r1": (R1.NCTX, R1.LROWS, O1R_LANES),
                     "rans-cdf-o1": (R1.BYTE_HROWS, R1.BYTE_LROWS, O1_LANES)}[codec]
    threads = max(32, lanes * O1_TEAM)
    dummies = threads // O1_TEAM - lanes
    return (lanes, threads, ((hi + lo) * lanes + dummies) * 32,
            -(-L // lanes))


# ---------------------------------------------------------------------------
# plain versions (torch, any device)
# ---------------------------------------------------------------------------

def _pack(probs: torch.Tensor) -> torch.Tensor:
    """[2K, 2 (low/freq), L] -> [2K, L] int32 (low << 16) | freq."""
    return ((probs[:, 0] << 16) | probs[:, 1]).to(torch.int32)


def lane_o1r_model_plain(cols: torch.Tensor, hi_tbl: torch.Tensor,
                         lo_tbl: torch.Tensor) -> torch.Tensor:
    """cols [K, L] bytes -> probs [2K, L] int32."""
    K, L = cols.shape
    return _pack(R1.model_pass(cols.T, K, *R1.lane_tables(hi_tbl, lo_tbl,
                                                          L)))


def lane_o1r_decode_plain(words: torch.Tensor, lengths: torch.Tensor,
                          K: int, hi_tbl: torch.Tensor,
                          lo_tbl: torch.Tensor) -> torch.Tensor:
    """Lane streams (words, lengths) -> bytes [K, L] uint8."""
    L = lengths.shape[0]
    return R1.decode_pass(*LK.stream_reader(words, lengths, 2 * K + 2), K,
                          *R1.lane_tables(hi_tbl, lo_tbl, L))[0]


def lane_o1_model_plain(cols: torch.Tensor) -> torch.Tensor:
    """cols [K, L] bytes -> probs [2K, L] int32."""
    K, L = cols.shape
    return _pack(R1.model_pass(cols.T, K, *R1.byte_tables(L, cols.device),
                               rows=R1.BYTE_ROWS))


def lane_o1_decode_plain(words: torch.Tensor, lengths: torch.Tensor,
                         K: int) -> torch.Tensor:
    """Lane streams (words, lengths) -> bytes [K, L] uint8."""
    L = lengths.shape[0]
    return R1.decode_pass(*LK.stream_reader(words, lengths, 2 * K + 2), K,
                          *R1.byte_tables(L, words.device),
                          rows=R1.BYTE_ROWS)[0]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_aligned(**tensors) -> None:
    """Each tensor starts at a multiple of its element size (the kernels
    load its elements as such)."""
    for name, x in tensors.items():
        if x.data_ptr() % x.element_size():
            raise ValueError(f"{name}: not aligned to its {x.element_size()}"
                             "-byte elements")


def _check_cols(cols) -> tuple[int, int]:
    if not isinstance(cols, torch.Tensor) or cols.dim() != 2:
        raise ValueError("cols: expected a [K, L] tensor")
    K, L = cols.shape
    _check("cols", cols, torch.uint8, (K, L), cols.device)
    LK._check_lanes(L)
    return K, L


def _check_tables(hi_tbl, lo_tbl, L: int, device) -> None:
    if not isinstance(hi_tbl, torch.Tensor) or hi_tbl.dim() != 3:
        raise ValueError(f"hi_tbl: expected an [n_seg, {R1.NCTX}, 16] "
                         "tensor")
    n_seg = hi_tbl.shape[0]
    _check("hi_tbl", hi_tbl, torch.int32, (n_seg, R1.NCTX, 16), device)
    _check("lo_tbl", lo_tbl, torch.int32, (n_seg, R1.LROWS, 16), device)
    _check_aligned(hi_tbl=hi_tbl, lo_tbl=lo_tbl)
    if not 1 <= n_seg <= L:
        raise ValueError(f"{L} lanes cannot take {n_seg} warm-table "
                         "segments")


def _check_streams(words, lengths, K: int) -> int:
    L = LK._check_streams(words, lengths, K)
    _check_aligned(words=words, lengths=lengths)
    return L


def lane_o1r_model(cols: torch.Tensor, hi_tbl: torch.Tensor,
                   lo_tbl: torch.Tensor) -> torch.Tensor:
    """L5: cols [K, L] uint8, id 59's segment tables -> probs [2K, L]
    int32."""
    K, L = _check_cols(cols)
    _check_tables(hi_tbl, lo_tbl, L, cols.device)
    if not cols.is_cuda:
        return lane_o1r_model_plain(cols, hi_tbl, lo_tbl)
    probs = torch.empty((2 * K, L), dtype=torch.int32, device=cols.device)
    launch("lane_o1r_model", "trc_lane_o1r_model",
           *lane_o1r_model_cargs(cols, hi_tbl, lo_tbl, probs),
           counts=launches)
    return probs


def lane_o1r_model_cargs(cols, hi_tbl, lo_tbl, probs) -> list:
    """The arguments of ``trc_lane_o1r_model`` (without the stream)."""
    K, L = cols.shape
    return [cols, hi_tbl, lo_tbl, probs, K, L, hi_tbl.shape[0]]


def lane_o1r_decode(words: torch.Tensor, lengths: torch.Tensor, K: int,
                    hi_tbl: torch.Tensor,
                    lo_tbl: torch.Tensor) -> torch.Tensor:
    """L6: lane streams (words [W] int16, lengths [L] int32), id 59's
    segment tables -> bytes [K, L] uint8."""
    L = _check_streams(words, lengths, K)
    _check_tables(hi_tbl, lo_tbl, L, words.device)
    if not words.is_cuda:
        return lane_o1r_decode_plain(words, lengths, K, hi_tbl, lo_tbl)
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    launch("lane_o1r_decode", "trc_lane_o1r_decode",
           *lane_o1r_decode_cargs(words, LK._offsets(lengths), lengths, K,
                                  hi_tbl, lo_tbl, out), counts=launches)
    return out


def lane_o1r_decode_cargs(words, offsets, lengths, K: int, hi_tbl, lo_tbl,
                          out) -> list:
    """The arguments of ``trc_lane_o1r_decode`` (without the stream)."""
    return [words, offsets, lengths, hi_tbl, lo_tbl, out, K,
            lengths.shape[0], words.shape[0], hi_tbl.shape[0]]


def lane_o1_model(cols: torch.Tensor) -> torch.Tensor:
    """L7: cols [K, L] uint8 -> probs [2K, L] int32 (id 64)."""
    K, L = _check_cols(cols)
    if not cols.is_cuda:
        return lane_o1_model_plain(cols)
    probs = torch.empty((2 * K, L), dtype=torch.int32, device=cols.device)
    launch("lane_o1_model", "trc_lane_o1_model",
           *lane_o1_model_cargs(cols, probs), counts=launches)
    return probs


def lane_o1_model_cargs(cols, probs) -> list:
    """The arguments of ``trc_lane_o1_model`` (without the stream)."""
    return [cols, probs, *cols.shape]


def lane_o1_decode(words: torch.Tensor, lengths: torch.Tensor,
                   K: int) -> torch.Tensor:
    """L8: lane streams (words [W] int16, lengths [L] int32) -> bytes
    [K, L] uint8 (id 64)."""
    L = _check_streams(words, lengths, K)
    if not words.is_cuda:
        return lane_o1_decode_plain(words, lengths, K)
    out = torch.empty((K, L), dtype=torch.uint8, device=words.device)
    launch("lane_o1_decode", "trc_lane_o1_decode",
           *lane_o1_decode_cargs(words, LK._offsets(lengths), lengths, K,
                                 out), counts=launches)
    return out


def lane_o1_decode_cargs(words, offsets, lengths, K: int, out) -> list:
    """The arguments of ``trc_lane_o1_decode`` (without the stream)."""
    return [words, offsets, lengths, out, K, lengths.shape[0],
            words.shape[0]]
