"""The port's rans-auto (id 61) against the JAX package.

The dispatch statistics must be the same floats, the chosen tag the same,
and the payload the same bytes for each of tags 0-3.  The oracle is the
JAX package's ``rans_auto.encode_block`` with its arms set, in this test
only, to the kernel codecs' XLA twins (``rans_pallas``,
``rans_pallas_r1`` with ``use_pallas_encoder=False``): the arms the JAX
package takes off the CPU, and the only arms the port has.  Every
comparison is exact.
"""
from __future__ import annotations

import numpy as np
import pytest

from turborc_tpu.codecs import rans_auto as JA
from turborc_tpu.codecs import rans_pallas, rans_pallas_r1
from turborc_tpu.ops.pallas.geom import Geom as JGeom
from turborc_tpu_torch import CodecConfig, api
from turborc_tpu_torch.codecs import rans_auto as TA
from turborc_tpu_torch.codecs import registry
from turborc_tpu_torch.container import format as fmt
from turborc_tpu_torch.ops.geom import Geom

DATA = rans_pallas.__file__.replace("codecs/rans_pallas.py", "bench/_data/")
REAL = np.fromfile(DATA + "realsrcbwt_16777216.bin", np.uint8,
                   count=3 << 20)
TEXT = np.fromfile(DATA + "textbwt_65536.bin", np.uint8)
TINY = "g2c2s8y2l4a16r4"


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8)


STATS = [REAL[:100], REAL[:4095], REAL[:4096], TEXT, _skewed(70_000, 1),
         REAL]  # < and = 4096 bytes, one window, several, > 2 MB runs


@pytest.mark.parametrize("i", range(len(STATS)),
                         ids=[f"n{d.size}" for d in STATS])
def test_statistics_equal_jax(i):
    """Exact: the same float, bit for bit."""
    d = STATS[i]
    assert TA.o1_gain(d) == JA.o1_gain(d)
    assert TA.mean_run(d) == JA.mean_run(d)


TAGS = [  # (tag, spec or None for no caller geometry, data)
    (0, TINY, _skewed(6000, 2)),            # low gain, short runs
    (1, TINY, REAL[100_000:109_000]),       # order-1 gain
    (2, TINY, REAL[:6000]),                 # long runs, no o1 gain
    (3, None, REAL[:1 << 20]),              # o1 arm at its own g8 geometry
]


@pytest.fixture(scope="module")
def jax_payloads():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "_impls", lambda: (rans_pallas, rans_pallas_r1))
        return [JA.encode_block(d, use_pallas_encoder=False,
                                geom=JGeom.parse(s) if s else None)
                for _, s, d in TAGS]


@pytest.mark.parametrize("i", range(len(TAGS)),
                         ids=[f"tag{t[0]}" for t in TAGS])
def test_payload_byte_identical(i, jax_payloads):
    """Exact: the same tag and the same payload bytes."""
    tag, spec, data = TAGS[i]
    got = TA.encode_block(data, geom=Geom.parse(spec) if spec else None,
                          device="cpu")
    assert jax_payloads[i][0] == tag
    assert got == jax_payloads[i]


@pytest.mark.parametrize("i", range(len(TAGS)),
                         ids=[f"tag{t[0]}" for t in TAGS])
def test_decode_jax_payload(i, jax_payloads):
    """Exact: the port decodes the JAX package's payload to the input
    (the decoder gets the container header's geometry, never None)."""
    _, spec, data = TAGS[i]
    g = Geom.parse(spec) if spec else Geom()
    out = TA.decode_block(jax_payloads[i], data.size, geom=g, device="cpu")
    assert np.array_equal(out, data)


def test_corrupt_tags_raise(jax_payloads):
    g = Geom.parse(TINY)
    with pytest.raises(ValueError, match="missing"):
        TA.decode_block(b"", 10, geom=g, device="cpu")
    with pytest.raises(ValueError, match="bad auto-dispatch tag 7"):
        TA.decode_block(b"\x07" + jax_payloads[1][1:], 9000, geom=g,
                        device="cpu")
    with pytest.raises(ValueError, match="truncated auto geometry"):
        TA.decode_block(jax_payloads[3][:3], 1 << 20, geom=g, device="cpu")
    bad = bytearray(jax_payloads[3])
    bad[4] = 17  # arows 17 > 16
    with pytest.raises(ValueError, match="bad auto geometry"):
        TA.decode_block(bytes(bad), 1 << 20, geom=g, device="cpu")


def test_api_never_picks_tag3():
    """Through api.compress the geometry is cfg.geom or the default, so a
    1 MB order-1 block, which encode_block alone sends to tag 3, takes
    tag 1 at the container's geometry, as in the JAX package; the
    container reads back."""
    cfg = CodecConfig(codec="rans-auto", block_size=1 << 20)
    data = REAL[:1 << 20]
    blob = api.compress(data, cfg, device="cpu")
    payload, stored, _ = next(fmt.iter_blocks(
        blob, fmt.read_header(blob)["data_off"]))
    assert not stored and payload[0] == 1
    assert api.decompress(blob, device="cpu") == data.tobytes()
    assert registry.get(61) is registry.get("rans-auto")
