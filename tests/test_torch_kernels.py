"""The port's kernels, as their plain versions, against the JAX package.

On the CPU each wrapper in ``turborc_tpu_torch.ops.rans_kernel`` runs its
kernel's plain version; the CUDA kernels themselves are held against the
same plain versions on the GPU by ``chip_smoke.py``.  Inputs are made
with numpy from a seed and fed to both packages (the port's through
``convert.kernel_args_from_jax``).  Every comparison is exact.
"""
from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turborc_tpu.codecs import blockio as jbio
from turborc_tpu.ops import rans as jrans
from turborc_tpu.ops.pallas import rans_kernel as JK
from turborc_tpu.ops.pallas.geom import Geom as JGeom
from turborc_tpu_torch import convert
from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops.geom import Geom

# tiny geometries: hot+cold re-joins, per-lane models, static cold rows,
# and share > 32 (the CUDA kernel's shared-memory set sums)
GEOMS = [("g2c2s8y2l4a16r4", 8), ("g2c2s1y2l4a16r4", 8),
         ("g2c2s8y2l4a4r4", 12), ("g1c8s64y8l32a16r4", 32),
         ("g1c8s128y8l32a8r2u9", 32)]


def _skewed(rng, shape):
    p = 1.0 / np.arange(1, 257) ** 1.2
    return rng.choice(256, size=shape, p=p / p.sum()).astype(np.uint8)


def _kernel_args(rng, G: int):
    """JAX-layout warm tables hi [16,G], lo [16,16,G] int32 and seeded
    initial states [G,128] (2^15 | seed15), as numpy."""
    counts = rng.zipf(1.4, size=(G, 256)).astype(np.int64)
    hi_q = jbio.quantize_freqs(counts.reshape(G, 16, 16).sum(-1))
    lo_q = jbio.quantize_freqs(counts.reshape(G, 16, 16))
    hi = jbio.cumulative(hi_q).T.copy()
    lo = np.transpose(jbio.cumulative(lo_q), (1, 2, 0)).copy()
    init = ((1 << 15) | rng.integers(0, 1 << 15, (G, 128))).astype(np.int32)
    return hi, lo, init


def _valid_probs(rng, S: int, L: int):
    """(low, freq) pairs of random symbols under random valid tables."""
    counts = rng.zipf(1.3, size=(S, L, 16))
    cdf = jbio.cumulative(jbio.quantize_freqs(counts)).astype(np.int64)
    sym = rng.integers(0, 16, (S, L))
    low = np.take_along_axis(cdf, sym[..., None], -1)[..., 0]
    nxt = np.concatenate([cdf[..., 1:], np.full((S, L, 1), 1 << 15)], -1)
    freq = np.take_along_axis(nxt, sym[..., None], -1)[..., 0] - low
    return low.astype(np.int32), freq.astype(np.int32)


def test_coder_matches_encode_backward():
    """Exact: words (every slot), emit flags and flush states of the
    coder's plain version equal ops/rans.encode_backward's."""
    rng = np.random.default_rng(11)
    S, G = 24, 2
    low, freq = _valid_probs(rng, S, G * 128)
    init = ((1 << 15) | rng.integers(0, 1 << 15, (G, 128))).astype(np.int32)
    jw, je, js = jrans.encode_backward(
        jnp.asarray(low), jnp.asarray(freq),
        init_state=jnp.asarray(init.reshape(-1)))
    probs = torch.from_numpy(((low << 16) | freq).reshape(S, G, 128))
    tw, te, ts = TK.coder(probs, torch.from_numpy(init))
    assert np.array_equal(tw.numpy().reshape(S, -1),
                          np.asarray(jw).astype(np.int64))
    assert np.array_equal(te.numpy().reshape(S, -1).astype(bool),
                          np.asarray(je))
    assert np.array_equal(ts.numpy().reshape(-1).astype(np.uint32),
                          np.asarray(js))


@pytest.mark.parametrize("spec", ["g2c2s8y2l4a16r4", "g64c8s8y8l32a4r4"])
def test_place_matches_group_stitch(spec):
    """Exact: group streams (all R rows) and lengths equal _group_stitch."""
    rng = np.random.default_rng(12)
    jg, tg = JGeom.parse(spec), Geom.parse(spec)
    S, G = 16, tg.groups
    words = rng.integers(0, 1 << 16, (S, G, 128)).astype(np.int32)
    emit = rng.random((S, G, 128)) < 0.3
    state = rng.integers(1 << 15, 1 << 31, (G, 128)).astype(np.int32)
    jgs, jgl = JK._group_stitch(jnp.asarray(words), jnp.asarray(emit),
                                jnp.asarray(state), jg)
    tgs, tgl = TK.place(torch.from_numpy(words),
                        torch.from_numpy(emit.astype(np.uint8)),
                        torch.from_numpy(state), tg)
    assert np.array_equal(tgs.numpy(), np.asarray(jgs))
    assert np.array_equal(tgl.numpy(), np.asarray(jgl))


@pytest.fixture(scope="module", params=GEOMS, ids=[g for g, _ in GEOMS])
def jax_tile(request):
    """A seeded block through the JAX XLA twin: (geom, K, block, args,
    gstreams, glens)."""
    spec, K = request.param
    rng = np.random.default_rng(zlib.crc32(spec.encode()))
    tg = Geom.parse(spec)
    block = _skewed(rng, (tg.lanes, K))
    hi, lo, init = _kernel_args(rng, tg.groups)
    gs, gl = JK.encode_tile(jnp.asarray(block.astype(np.int32)), K,
                            jnp.asarray(hi), jnp.asarray(lo),
                            jnp.asarray(init), geom=JGeom.parse(spec))
    return tg, K, block, (hi, lo, init), np.asarray(gs), np.asarray(gl)


def test_encode_tile_matches_jax(jax_tile):
    """Exact: model -> coder -> place equals JAX encode_tile's gstreams
    (every row) and glens."""
    g, K, block, args, jgs, jgl = jax_tile
    hi, lo, init = convert.kernel_args_from_jax(*args, device="cpu")
    gs, gl = TK.encode_tile(torch.from_numpy(block), K, hi, lo, init, g)
    assert np.array_equal(gs.numpy(), jgs)
    assert np.array_equal(gl.numpy(), jgl)


def test_decode_of_jax_streams(jax_tile):
    """Exact: decoding JAX's streams gives the block back, and the final
    states equal the seeded initial states."""
    g, K, block, args, jgs, _ = jax_tile
    hi, lo, init = convert.kernel_args_from_jax(*args, device="cpu")
    out, fstates = TK.decode_tile(torch.from_numpy(jgs.astype(np.int32)), K,
                                  hi, lo, g)
    assert np.array_equal(out.numpy().reshape(K, -1).T, block)
    assert np.array_equal(fstates.numpy(), args[2])


def test_cpu_wrappers_launch_nothing(jax_tile):
    g, K, block, args, jgs, _ = jax_tile
    TK.reset_launches()
    hi, lo, init = convert.kernel_args_from_jax(*args, device="cpu")
    TK.encode_tile(torch.from_numpy(block), K, hi, lo, init, g)
    assert all(v == 0 for v in TK.launches.values())


def test_wrappers_reject_bad_inputs():
    g = Geom.parse("g2c2s8y2l4a16r4")
    hi, lo, init = convert.kernel_args_from_jax(
        *_kernel_args(np.random.default_rng(0), 2), device="cpu")
    cols = torch.zeros((4, 2, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TK.model(cols.to(torch.int32), hi, lo, g)
    with pytest.raises(ValueError):
        TK.model(cols, hi[:, :1].contiguous(), lo, g)
    with pytest.raises(ValueError):
        TK.model(cols, hi, lo, Geom.parse("g4c2s8y2l4a16r4"))
    with pytest.raises(ValueError):
        TK.coder(torch.zeros((8, 2, 128), dtype=torch.int32)[:, :, ::2],
                 init)
    x2 = Geom.parse("g2c2s8y2l4a16r4x2")
    assert TK.model(cols, hi, lo, x2).shape == (8, 2, 128)  # one model
    with pytest.raises(ValueError, match="decode_tile_x2"):
        TK.decode_tile(torch.zeros((2, 20, 128), dtype=torch.int32), 4, hi,
                       lo, x2)
    with pytest.raises(ValueError):
        convert.kernel_args_from_jax(np.zeros((16, 2)), np.zeros((16, 16, 3)),
                                     np.zeros((2, 128)), device="cpu")
