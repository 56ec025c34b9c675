"""Carry the JAX package's kernel arguments over to the port.

This codec has no weights: its parameters are the per-group warm tables
and the seeded initial coder states that both packages derive from the
block.  The JAX kernels take them as int32 arrays hi [16, G],
lo [16, 16, G] and init [G, 128] (uint32 bits); the port's kernels take
the same layout as torch int32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from turborc_tpu_torch.utils.config import resolve_device


def _int32(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)  # same bits
    return a.astype(np.int32)


def kernel_args_from_jax(hi_tbl, lo_tbl, init_states, device=None):
    """JAX kernel args (numpy or array-like) -> (hi, lo, init) int32
    tensors on ``device`` (None: the CUDA card, as in ``api``), with their
    layouts checked."""
    hi, lo, init = (_int32(a) for a in (hi_tbl, lo_tbl, init_states))
    G = hi.shape[-1]
    for name, a, shape in (("hi_tbl", hi, (16, G)),
                           ("lo_tbl", lo, (16, 16, G)),
                           ("init_states", init, (G, 128))):
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (hi, lo, init))
