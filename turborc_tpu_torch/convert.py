"""Carry the JAX package's kernel arguments over to the port.

This codec has no weights: its parameters are the per-group warm tables
and the seeded initial coder states that both packages derive from the
block.  The JAX kernels take them as int32 arrays (init [G, 128] as
uint32 bits): for the order-0 kernels hi [16, G] and lo [16, 16, G], for
the order-1 kernels hi [64, 16, G] and lo [48, 16, G].  The port's
kernels take the same layouts as torch int32 tensors.  The bit-tree
kernels take one warm tree, [256] int32 (row 0 unused, rows 1..255 in
[1, 32767]).  The per-lane order-1 codec rans-cdf-r1 (id 59) takes its
warm tables per segment, cumulative hi [n_seg, 64, 16] and lo [n_seg,
48, 16] int32 (L5, L6; lane l from segment l * n_seg // lanes).
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_cdf_r1 as R1
from turborc_tpu_torch.utils.config import resolve_device


def _int32(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)  # same bits
    return a.astype(np.int32)


def _convert(hi_tbl, lo_tbl, init_states, hi_rows: tuple, lo_rows: tuple,
             device):
    hi, lo, init = (_int32(a) for a in (hi_tbl, lo_tbl, init_states))
    G = hi.shape[-1]
    for name, a, shape in (("hi_tbl", hi, (*hi_rows, G)),
                           ("lo_tbl", lo, (*lo_rows, G)),
                           ("init_states", init, (G, 128))):
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (hi, lo, init))


def kernel_args_from_jax(hi_tbl, lo_tbl, init_states, device=None):
    """JAX order-0 kernel args (numpy or array-like) -> (hi [16, G],
    lo [16, 16, G], init [G, 128]) int32 tensors on ``device`` (None: the
    CUDA card, as in ``api``), with their layouts checked."""
    return _convert(hi_tbl, lo_tbl, init_states, (16,), (16, 16), device)


def o1_kernel_args_from_jax(hi_tbl, lo_tbl, init_states, device=None):
    """JAX order-1 kernel args -> (hi [64, 16, G], lo [48, 16, G],
    init [G, 128]) int32 tensors on ``device`` (None: the CUDA card)."""
    return _convert(hi_tbl, lo_tbl, init_states, (R1.NCTX, 16),
                    (R1.LROWS, 16), device)


def tree_from_jax(tree, device=None) -> torch.Tensor:
    """JAX bit-tree warm tree [256] int32 -> the port's [256] int32 tensor
    on ``device`` (None: the CUDA card), with its layout checked."""
    t = _int32(tree)
    if t.shape != (256,):
        raise ValueError(f"tree: shape {t.shape}, expected (256,)")
    if t[1:].min() < 1 or t[1:].max() > (1 << 15) - 1:
        raise ValueError("tree: rows 1..255 must lie in [1, 32767]")
    return torch.from_numpy(t).to(resolve_device(device))


def r1_tables_from_jax(hi, lo, device=None):
    """Id 59's warm tables from the JAX package: the dequantized freq rows
    ``codes_to_tables`` gives (hi [n_seg, 64, 16], lo [n_seg, 48, 16],
    every row summing to 2^15 with no zero freq) -> the cumulative int32
    tensors L5 and L6 take, on ``device`` (None: the CUDA card)."""
    hi, lo = np.asarray(hi), np.asarray(lo)
    for name, a, rows in (("hi", hi, R1.NCTX), ("lo", lo, R1.LROWS)):
        if a.ndim != 3 or a.shape[1:] != (rows, 16) or \
                a.shape[0] != hi.shape[0] or a.shape[0] < 1:
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"(n_seg, {rows}, 16)")
        if not ((a.sum(-1) == blockio.TOTAL).all() and (a > 0).all()):
            raise ValueError(f"{name}: rows must be freqs summing to 2^15 "
                             "with no zero")
    return tuple(torch.from_numpy(blockio.cumulative(a))
                 .to(resolve_device(device)) for a in (hi, lo))
