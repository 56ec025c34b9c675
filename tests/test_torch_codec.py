"""The port's flagship codec (rans-cdf-o0-p, id 57) against the JAX package.

Payloads from ``turborc_tpu_torch.codecs.rans_cdf_o0_p.encode_block`` on
the CPU must equal the JAX package's (its XLA twin,
``use_pallas_encoder=False``) byte for byte, the port must decode the JAX
package's payloads and containers, and corrupt payloads must raise.
Every comparison is exact.
"""
from __future__ import annotations

import numpy as np
import pytest

from turborc_tpu.codecs import rans_pallas as J
from turborc_tpu.container import format as jfmt
from turborc_tpu.ops.pallas.geom import Geom as JGeom
from turborc_tpu_torch import CodecConfig, api
from turborc_tpu_torch.codecs import rans_cdf_o0_p as T
from turborc_tpu_torch.codecs import registry
from turborc_tpu_torch.ops.geom import Geom

TINY = "g2c2s8y2l4a16r4"       # 256 lanes, 480 seed bytes
TEXT = np.fromfile(J.__file__.replace("codecs/rans_pallas.py",
                                      "bench/_data/textbwt_65536.bin"),
                   np.uint8)


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8)


def _jax_payload(data, spec):
    return J.encode_block(data, use_pallas_encoder=False,
                          geom=JGeom.parse(spec))


CASES = [  # (spec, data): n = 0, 1, < seed bytes, not a multiple of
    (TINY, TEXT[:0]),  # lanes, and several K
    (TINY, TEXT[:1]),
    (TINY, TEXT[100:400]),
    (TINY, TEXT[:3001]),
    (TINY, _skewed(9000, 3)),
    ("g2c2s1y2l4a16r4", TEXT[5000:8333]),
    ("g2c2s8y2l4a4r4", TEXT[9000:14000]),
    ("g64c8s8y8l32a4r4", TEXT),
]
IDS = [f"{s}-n{d.size}" for s, d in CASES]


@pytest.fixture(scope="module")
def jax_payloads():
    return [_jax_payload(d, s) for s, d in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_encode_block_byte_identical(i, jax_payloads):
    """Exact: the port's payload equals the JAX package's."""
    spec, data = CASES[i]
    got = T.encode_block(data, geom=Geom.parse(spec), device="cpu")
    assert got == jax_payloads[i]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_decode_jax_payload(i, jax_payloads):
    """Exact: the port decodes the JAX package's payload to the input."""
    spec, data = CASES[i]
    out = T.decode_block(jax_payloads[i], data.size, geom=Geom.parse(spec),
                         device="cpu")
    assert np.array_equal(out, data)


def test_decompress_jax_container():
    """Exact: a container assembled the way turborc_tpu.api.compress does
    (several blocks, stored and coded) decompresses in the port."""
    data = TEXT[:20000]
    bs = 8192
    parts = [jfmt.write_header(57, 512, 256, bs, data.size,
                               geom=JGeom.parse(TINY))]
    for off in range(0, data.size, bs):
        blk = data[off:off + bs]
        p = _jax_payload(blk, TINY)
        parts.append(jfmt.write_block(p, blk, False))
    assert api.decompress(b"".join(parts), device="cpu") == data.tobytes()


def _payload_parts(payload: bytes, G: int):
    from turborc_tpu_torch.codecs import blockio
    _, used = blockio.unpack_codes(payload[256:], G)
    return 256 + used  # offset of glens


def test_corrupt_payloads_raise(jax_payloads):
    spec, data = CASES[3]
    g = Geom.parse(spec)
    good = jax_payloads[3]
    with pytest.raises(ValueError, match="truncated"):
        T.decode_block(good[:400], data.size, geom=g, device="cpu")
    off = _payload_parts(good, g.groups)
    bad = bytearray(good)
    bad[off:off + 4] = (10 ** 6).to_bytes(4, "little")
    with pytest.raises(ValueError, match="group length"):
        T.decode_block(bytes(bad), data.size, geom=g, device="cpu")
    with pytest.raises(ValueError, match="group length"):
        T.decode_block(good[:-2], data.size, geom=g, device="cpu")
    bad = bytearray(good)
    word0 = off + 4 * g.groups  # group 0, lane 0: flush state hi16
    bad[word0:word0 + 2] = b"\xff\xff"
    with pytest.raises(ValueError, match="final coder states"):
        T.decode_block(bytes(bad), data.size, geom=g, device="cpu")


def test_corrupt_container_raises():
    data = TEXT[:3000]
    cfg = CodecConfig(codec="rans-cdf-o0-p", geom=Geom.parse(TINY))
    buf = bytearray(api.compress(data, cfg, device="cpu"))
    buf[-1] ^= 0x55
    with pytest.raises(ValueError):
        api.decompress(bytes(buf), device="cpu")


def test_split_state_not_ported():
    """The split-state (x2) geometry is ported now: both codec entry
    points round-trip a block with seed bytes, several K and both stream
    sets (byte identity with the JAX package: tests/test_torch_x2.py)."""
    g = Geom.parse("g2c2s8y2l4a16r4x2")
    data = TEXT[:3001]
    payload = T.encode_block(data, geom=g, device="cpu")
    assert np.array_equal(T.decode_block(payload, data.size, geom=g,
                                         device="cpu"), data)


def test_registry_has_only_the_flagship():
    """The registry holds the ported codecs, the per-lane scan codecs 42,
    56, 58, 59 and 64, the flagships 57 and 60, the dispatch between
    them, 61, the bit-tree codec 8, the bitwise byte-tree codecs 1, 2, 3
    and 101-104, ansb (66), the nibble codecs 41 and 40 and the W-bit
    tree codecs 6 and 142-152, and nothing else; the default CodecConfig
    (id 56) round-trips through the api."""
    assert registry.names() == ["rans-static", "rans-cdf-o0",
                                "rans-cdf-o0-p", "rans-cdf-s8",
                                "rans-cdf-r1", "rans-cdf-r1-p", "rans-auto",
                                "rans-cdf-o1", "rc-p", "rc-o0", "rcc-o1",
                                "rc-o0-ss", "rcc-o1-ss", "rc-o0-sf",
                                "rcc-o1-sf", "rcc2", "rc-16", "ansb", "rc4",
                                "rc4c", "rc2b", "rc3b", "rc5b", "rc6b",
                                "rc7b", "rc10b", "rc12b"]
    for cid, name in ((42, "rans-static"), (56, "rans-cdf-o0"),
                      (57, "rans-cdf-o0-p"), (58, "rans-cdf-s8"),
                      (59, "rans-cdf-r1"), (60, "rans-cdf-r1-p"),
                      (61, "rans-auto"), (64, "rans-cdf-o1"), (8, "rc-p"),
                      (1, "rc-o0"), (2, "rcc-o1"), (101, "rc-o0-ss"),
                      (102, "rcc-o1-ss"), (103, "rc-o0-sf"),
                      (104, "rcc-o1-sf"), (41, "rc4"), (40, "rc4c"),
                      (3, "rcc2"), (6, "rc-16"), (66, "ansb"),
                      (142, "rc2b"), (143, "rc3b"), (145, "rc5b"),
                      (146, "rc6b"), (147, "rc7b"), (150, "rc10b"),
                      (152, "rc12b")):
        assert registry.get(cid) is registry.get(name)
    for key in ("rcx", 4, "rc-32", 7):
        with pytest.raises(KeyError, match="not ported"):
            registry.get(key)
    data = TEXT[:3000].tobytes()
    blob = api.compress(data, CodecConfig(), device="cpu")
    assert jfmt.read_header(blob)["codec_id"] == 56
    assert api.decompress(blob, device="cpu") == data
