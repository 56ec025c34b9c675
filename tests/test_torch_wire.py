"""Wire layer of the PyTorch port against the JAX package.

Geometry packing, the container header and block framing, and the warm
table quantization and packing must produce the same bytes in both
packages.  Every comparison here is exact.
"""
from __future__ import annotations

import numpy as np
import pytest

from turborc_tpu.codecs import blockio as jbio
from turborc_tpu.container import format as jfmt
from turborc_tpu.ops.pallas import geom as jgeom
from turborc_tpu_torch.codecs import blockio as tbio
from turborc_tpu_torch.container import format as tfmt
from turborc_tpu_torch.ops import geom as tgeom

SPECS = ["g64c8s8y4l32a16r4", "g64c8s8y8l32a4r4", "g2c2s8y2l4a16r4",
         "g2c2s1y2l4a16r4", "g2c2s8y2l4a4r4", "g1c8s128y8l128a0r0",
         "g32c16s16y16l64a8r31u10", "g4c4s4y2l8a16r4x2", "g8c8s64y8l32a16"]
BAD = ["g3c8s8y4l32a16r4", "g64c8s8y16l32a16r4", "g64c8s8y4l4a16r4",
       "g64c8s8y4l32a17r4", "g64c8s8y4l32a16r4u11", "g64c8s256y4l32a16r4",
       "g64c8"]


@pytest.mark.parametrize("spec", SPECS)
def test_geom_pack_parse_spec(spec):
    """Exact: same 4 header bytes, spec string and derived sizes."""
    j, t = jgeom.Geom.parse(spec), tgeom.Geom.parse(spec)
    assert t.pack() == j.pack()
    assert t.spec == j.spec
    assert tgeom.Geom.unpack(j.pack()) == t
    assert dataclass_fields(t) == dataclass_fields(j)
    assert ((t.lanes, t.wrows, t.hrows, t.step_quant, t.rows_per_step)
            == (j.lanes, j.wrows, j.hrows, j.step_quant, j.rows_per_step))


def dataclass_fields(g) -> tuple:
    return (g.groups, g.chunk, g.share, g.sync, g.lsync, g.arows, g.srows,
            g.nstates, g.rate)


@pytest.mark.parametrize("spec", BAD)
def test_geom_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        jgeom.Geom.parse(spec)
    with pytest.raises(ValueError):
        tgeom.Geom.parse(spec)


def test_default_geom_is_reference_default():
    assert tgeom.DEFAULT == tgeom.Geom()
    assert tgeom.DEFAULT.pack() == jgeom.Geom().pack()


@pytest.mark.parametrize("args", [
    (57, 512, 256, 1 << 22, 0, 5, 8, 8, "g64c8s8y4l32a16r4"),
    (57, 512, 256, 1 << 26, 67108864, 5, 8, 8, "g64c8s8y8l32a4r4"),
    (57, 8192, 64, 2048, 12345, 4, 7, 12, "g2c2s1y2l4a16r4"),
])
def test_header_bytes(args):
    """Exact: the 32-byte header, and reading it back."""
    *head, spec = args
    j = jfmt.write_header(*head, geom=jgeom.Geom.parse(spec))
    t = tfmt.write_header(*head, geom=tgeom.Geom.parse(spec))
    assert t == j
    hj, ht = jfmt.read_header(j), tfmt.read_header(t)
    assert ht.pop("geom").pack() == hj.pop("geom").pack()
    assert ht == hj


def test_block_framing():
    raw = np.arange(1000, dtype=np.uint32).astype(np.uint8)
    for stored in (False, True):
        j = jfmt.write_block(b"payload", raw, stored)
        assert tfmt.write_block(b"payload", raw, stored) == j
        buf = j + j
        assert list(tfmt.iter_blocks(buf, 0)) == list(jfmt.iter_blocks(buf, 0))
    with pytest.raises(ValueError):
        list(tfmt.iter_blocks(j[:-1], 0))


def test_header_rejects_corruption():
    h = bytearray(tfmt.write_header(57, 512, 256, 1 << 22, 10))
    with pytest.raises(ValueError):
        tfmt.read_header(bytes(h[:20]))
    h[7] ^= 1
    with pytest.raises(ValueError):
        tfmt.read_header(bytes(h))


def test_freq_codes():
    """Exact: the 8-bit log code and its decode over every frequency."""
    f = np.arange(0, 32769)
    assert np.array_equal(tbio._freq_code(f), jbio._freq_code(f))
    c = np.arange(256)
    assert np.array_equal(tbio._freq_decode(c), jbio._freq_decode(c))


@pytest.mark.parametrize("G,seed", [(1, 0), (2, 1), (5, 2), (64, 3)])
def test_quantize_and_pack_codes(G, seed):
    """Exact: quantized tables, cumulative cdfs and packed code bytes."""
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.5, size=(G, 256)).astype(np.int64)
    counts[:, rng.integers(0, 256, 8)] = 0
    hi_raw = [b.quantize_freqs(counts.reshape(G, 16, 16).sum(-1))
              for b in (jbio, tbio)]
    lo_raw = [b.quantize_freqs(counts.reshape(G, 16, 16))
              for b in (jbio, tbio)]
    assert np.array_equal(*hi_raw) and np.array_equal(*lo_raw)
    jc, (jh, jl) = jbio.quantize_tables(hi_raw[0], lo_raw[0])
    tc, (th, tl) = tbio.quantize_tables(hi_raw[1], lo_raw[1])
    assert np.array_equal(tc, jc)
    assert np.array_equal(th, jh) and np.array_equal(tl, jl)
    assert np.array_equal(tbio.cumulative(tl), jbio.cumulative(jl))
    packed = tbio.pack_codes(tc)
    assert packed == jbio.pack_codes(jc)
    codes, used = tbio.unpack_codes(packed + b"tail", G)
    assert used == len(packed)
    assert np.array_equal(codes, tc)
    hq, lq = tbio.codes_to_tables(codes)
    assert np.array_equal(hq, jh) and np.array_equal(lq, jl)
