"""Split-state rans-cdf-o0-p (``Geom.nstates == 2``, spec suffix ``x2``)
against the JAX package.

Each lane has two coder states: state 0 codes the hi nibbles into stream
set 0, state 1 the lo nibbles into set 1, under one shared model.  The
oracle is the JAX package's XLA twin (``rans_kernel.encode_tile``,
``rans_pallas.encode_block(..., use_pallas_encoder=False)``); it has no
twin of the split-state decode kernel, so the port decodes the JAX
package's payloads.  ``rans-auto`` (id 61) under an x2 geometry is held
against the JAX package's with its arms set to the kernel codecs' twins.
No Pallas kernel runs here.  Every comparison is exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turborc_tpu.codecs import rans_auto as JA
from turborc_tpu.codecs import rans_pallas as J
from turborc_tpu.codecs import rans_pallas_r1
from turborc_tpu.ops.pallas import rans_kernel as JK
from turborc_tpu.ops.pallas.geom import Geom as JGeom
from turborc_tpu_torch import CodecConfig, api, convert
from turborc_tpu_torch.codecs import rans_auto as TA
from turborc_tpu_torch.codecs import rans_cdf_o0_p as T
from turborc_tpu_torch.ops import rans_kernel as TK
from turborc_tpu_torch.ops.geom import Geom

TINY = "g2c2s8y2l4a16r4x2"     # 256 lanes x 2 states, 960 seed bytes
DATA = J.__file__.replace("codecs/rans_pallas.py", "bench/_data/")
TEXT = np.fromfile(DATA + "textbwt_65536.bin", np.uint8)
REAL = np.fromfile(DATA + "realsrcbwt_16777216.bin", np.uint8,
                   count=200_000)


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8)


CASES = [  # (spec, data)
    (TINY, _skewed(5000, 3)),                    # shared models, hot rows
    ("g2c2s1y2l4a16r4x2", _skewed(5000, 4)),     # per-lane models
    ("g2c2s8y2l4a4r4x2", TEXT[:9000]),           # static rows >= arows 4
    ("g1c8s64y8l32a8r2x2", TEXT[:12000]),        # cold re-join, share 64
    (TINY, TEXT[100:800]),                       # seed bytes only
    (TINY, TEXT[:0]),
]
IDS = [f"{s}-n{d.size}" for s, d in CASES]
TAGS = [(0, _skewed(6000, 2)), (2, REAL[:6000])]  # o0 arms of id 61
TILE_K, TILE_SPEC = 8, TINY


@pytest.fixture(scope="module")
def jax_ref():
    """Every live JAX call of this file, at tiny geometries: the payloads
    of CASES and TAGS, the o1 arm's error, and one seeded tile through
    the XLA twin."""
    from turborc_tpu.codecs import blockio as jbio
    rng = np.random.default_rng(21)
    g = Geom.parse(TILE_SPEC)
    block = _skewed(g.lanes * TILE_K, 8).reshape(g.lanes, TILE_K)
    counts = rng.zipf(1.4, size=(g.groups, 256)).astype(np.int64)
    hi = jbio.cumulative(jbio.quantize_freqs(
        counts.reshape(g.groups, 16, 16).sum(-1))).T.copy()
    lo = np.transpose(jbio.cumulative(jbio.quantize_freqs(
        counts.reshape(g.groups, 16, 16))), (1, 2, 0)).copy()
    init = ((1 << 15) | rng.integers(0, 1 << 15, (2, g.groups, 128))
            ).astype(np.int32)
    gs, gl = JK.encode_tile(jnp.asarray(block.astype(np.int32)), TILE_K,
                            jnp.asarray(hi), jnp.asarray(lo),
                            jnp.asarray(init), geom=JGeom.parse(TILE_SPEC))
    ref = dict(payloads=[J.encode_block(d, use_pallas_encoder=False,
                                        geom=JGeom.parse(s))
                         for s, d in CASES],
               block=block, hi=hi, lo=lo, init=init,
               gstreams=np.asarray(gs), glens=np.asarray(gl))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "_impls", lambda: (J, rans_pallas_r1))
        ref["auto"] = [JA.encode_block(d, use_pallas_encoder=False,
                                       geom=JGeom.parse(TINY))
                       for _, d in TAGS]
        with pytest.raises(ValueError) as err:
            JA.encode_block(REAL[100_000:109_000], use_pallas_encoder=False,
                            geom=JGeom.parse(TINY))
    ref["o1_error"] = str(err.value)
    return ref


def _tile_args(ref):
    hi, lo, _ = convert.kernel_args_from_jax(ref["hi"], ref["lo"],
                                             ref["init"][0], device="cpu")
    return hi, lo, torch.from_numpy(ref["init"])


def test_encode_tile_x2_equals_twin(jax_ref):
    """Exact: model, then coder and place per set give the twin's two
    stream sets (every row) and lengths."""
    hi, lo, init = _tile_args(jax_ref)
    gs, gl = TK.encode_tile(torch.from_numpy(jax_ref["block"]), TILE_K, hi,
                            lo, init, Geom.parse(TILE_SPEC))
    assert gs.shape[0] == 2 and gl.shape == (2, 2)
    assert np.array_equal(gs.numpy(), jax_ref["gstreams"])
    assert np.array_equal(gl.numpy(), jax_ref["glens"])


def test_decode_x2_of_twin_streams(jax_ref):
    """Exact: K5's plain version decodes the twin's streams to the block,
    and its final states are both sets' seeded initial states."""
    hi, lo, init = _tile_args(jax_ref)
    out, fstates = TK.decode_tile_x2(
        torch.from_numpy(jax_ref["gstreams"].astype(np.int32)), TILE_K, hi,
        lo, Geom.parse(TILE_SPEC))
    assert np.array_equal(out.numpy().reshape(TILE_K, -1).T,
                          jax_ref["block"])
    assert torch.equal(fstates, init)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_encode_block_byte_identical(i, jax_ref):
    """Exact: the port's x2 payload equals the JAX package's."""
    spec, data = CASES[i]
    got = T.encode_block(data, geom=Geom.parse(spec), device="cpu")
    assert got == jax_ref["payloads"][i]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_decode_jax_payload(i, jax_ref):
    """Exact: the port decodes the JAX package's x2 payload to the input."""
    spec, data = CASES[i]
    out = T.decode_block(jax_ref["payloads"][i], data.size,
                         geom=Geom.parse(spec), device="cpu")
    assert np.array_equal(out, data)


def test_corrupt_payloads_raise(jax_ref):
    """2G group lengths (hi set, then lo set), each checked against
    R = K + 2 + wrows rows; a broken lo-set flush state fails the seed
    check."""
    spec, data = CASES[0]
    g = Geom.parse(spec)
    good = jax_ref["payloads"][0]
    from turborc_tpu_torch.codecs import blockio
    off = 256 + blockio.unpack_codes(good[256:], g.groups)[1]

    def dec(p):
        return T.decode_block(bytes(p), data.size, geom=g, device="cpu")

    K = T._K_for(data.size - 960, g)
    for at in (off, off + 4 * g.groups):  # first hi, first lo stream
        bad = bytearray(good)
        bad[at:at + 4] = ((K + 2 + g.wrows) * 128 + 1).to_bytes(4, "little")
        with pytest.raises(ValueError, match="group length"):
            dec(bad)
    with pytest.raises(ValueError, match="group length"):
        dec(good[:-2])
    lo0 = off + 8 * g.groups + 2 * int.from_bytes(good[off:off + 4],
                                                  "little") * g.groups
    bad = bytearray(good)  # the first lo stream's lane 0 flush state
    bad[lo0:lo0 + 2] = b"\xff\xff"
    with pytest.raises(ValueError, match="final coder states"):
        dec(bad)


@pytest.mark.parametrize("i", range(len(TAGS)),
                         ids=[f"tag{t}" for t, _ in TAGS])
def test_auto_o0_arms_under_x2(i, jax_ref):
    """Exact: rans-auto's o0 arms (tags 0 and 2) code x2 payloads as the
    JAX package does, and the port decodes them."""
    tag, data = TAGS[i]
    g = Geom.parse(TINY)
    assert jax_ref["auto"][i][0] == tag
    assert TA.encode_block(data, geom=g, device="cpu") == jax_ref["auto"][i]
    out = TA.decode_block(jax_ref["auto"][i], data.size, geom=g,
                          device="cpu")
    assert np.array_equal(out, data)


def test_auto_o1_arm_rejects_x2(jax_ref):
    """The o1 arm has no x2 format: the reference's ValueError."""
    with pytest.raises(ValueError) as err:
        TA.encode_block(REAL[100_000:109_000], geom=Geom.parse(TINY),
                        device="cpu")
    assert str(err.value) == jax_ref["o1_error"]


def test_api_round_trip():
    data = TEXT[:20000]
    cfg = CodecConfig(codec="rans-cdf-o0-p", block_size=8192,
                      geom=Geom.parse("g2c2s8y2l4a4r4x2"))
    blob = api.compress(data, cfg, device="cpu")
    assert api.decompress(blob, device="cpu") == data.tobytes()


def test_wrappers_check_the_state_count(jax_ref):
    hi, lo, _ = _tile_args(jax_ref)
    gs = torch.from_numpy(jax_ref["gstreams"].astype(np.int32))
    with pytest.raises(ValueError, match="decode it with decode_tile$"):
        TK.decode_tile_x2(gs[0], TILE_K, hi, lo, Geom.parse("g2c2s8y2l4a16r4"))
    with pytest.raises(ValueError, match="shape"):
        TK.decode_tile_x2(gs[:1], TILE_K, hi, lo, Geom.parse(TILE_SPEC))
    TK.reset_launches()
    TK.decode_tile_x2(gs, TILE_K, hi, lo, Geom.parse(TILE_SPEC))
    assert all(v == 0 for v in TK.launches.values())
