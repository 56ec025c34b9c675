"""The port's per-lane scan codecs against the JAX package: rans-static
(id 42), rans-cdf-o0 (id 56, the default codec) and rans-cdf-s8 (id 58).

Payloads from the port's ``encode_block(..., device="cpu")`` (the lane
kernels' plain versions) must equal the JAX package's byte for byte, the
port must decode the JAX package's payloads, and corrupt payloads must
raise ValueError.  ``turborc_tpu_torch.api.compress`` at the default
``CodecConfig()`` must write ``turborc_tpu.api.compress``'s container.
Every comparison is exact.

The JAX encoders compile once per (lanes, K, geometry), 1.5-8 s each on
a CPU, so the cases share few shapes: id 56 at (16 lanes, K = 64) and the
default configuration's (512, 256); id 58 at (64, 64) and (64, 128) at
its default geometry, (64, 64) at another, and (8, 64) through
``encode_device`` for ``srows``, which its block API fixes at 4.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from turborc_tpu import api as japi
from turborc_tpu.codecs import rans_cdf_o0 as J56
from turborc_tpu.codecs import rans_cdf_s8 as J58
from turborc_tpu.codecs import rans_static as J42
from turborc_tpu.ops.pallas.geom import Geom as JGeom
from turborc_tpu.utils.config import CodecConfig as JConfig
from turborc_tpu_torch import CodecConfig, api
from turborc_tpu_torch.codecs import blockio
from turborc_tpu_torch.codecs import rans_cdf_o0 as T56
from turborc_tpu_torch.codecs import rans_cdf_s8 as T58
from turborc_tpu_torch.codecs import rans_static as T42
from turborc_tpu_torch.ops import rans_lane_kernel as LK
from turborc_tpu_torch.ops.geom import Geom

TEXT = np.fromfile(J56.__file__.replace("codecs/rans_cdf_o0.py",
                                        "bench/_data/textbwt_65536.bin"),
                   np.uint8)


def _skewed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 257) ** 1.3
    return rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8)


G_DEFAULT = "g64c8s8y4l32a16r4"    # share 8, sync 4, lsync 32, arows 16
G_OTHER = "g64c8s16y4l32a4r4u8"    # share 16, arows 4, rate 8

# (codec, lanes, step_quant, geometry or None, data): n = 0, 1, below one
# lane's K, not a multiple of the lanes, several K
CASES = [
    ("42", 4, 64, None, TEXT[:0]),
    ("42", 4, 64, None, TEXT[:1]),
    ("42", 16, 64, None, TEXT[:50]),
    ("42", 16, 64, None, TEXT[1000:4001]),
    ("42", 64, 32, None, _skewed(9000, 3)),
    ("56", 16, 64, None, TEXT[:0]),
    ("56", 16, 64, None, TEXT[:1]),
    ("56", 16, 64, None, TEXT[:50]),
    ("56", 16, 64, None, TEXT[2000:2999]),
    ("56", 16, 64, None, _skewed(777, 5)),
    ("58", 64, 64, G_DEFAULT, TEXT[:0]),
    ("58", 64, 64, G_DEFAULT, TEXT[:1]),
    ("58", 64, 64, G_DEFAULT, TEXT[:200]),
    ("58", 64, 64, G_DEFAULT, TEXT[3000:6999]),
    ("58", 64, 64, G_DEFAULT, TEXT[10000:15001]),
    ("58", 64, 64, G_OTHER, TEXT[20000:23333]),
]
IDS = [f"id{c}-L{L}-{g or 'nogeom'}-n{d.size}" for c, L, _, g, d in CASES]
JMOD = {"42": J42, "56": J56, "58": J58}
TMOD = {"42": T42, "56": T56, "58": T58}


def _kw(lanes, step_quant, spec, port: bool) -> dict:
    kw = dict(lanes=lanes, step_quant=step_quant)
    if spec:
        kw["geom"] = (Geom if port else JGeom).parse(spec)
    return kw


@pytest.fixture(scope="module")
def jax_payloads():
    """The JAX package's payload of every case (its encoders compile once
    per shape and geometry)."""
    return [JMOD[c].encode_block(d, **_kw(L, q, g, False))
            for c, L, q, g, d in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_encode_block_byte_identical(i, jax_payloads):
    """Exact: the port's payload equals the JAX package's."""
    c, L, q, g, d = CASES[i]
    got = TMOD[c].encode_block(d, device="cpu", **_kw(L, q, g, True))
    assert got == jax_payloads[i]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_decode_jax_payload(i, jax_payloads):
    """Exact: the port decodes the JAX package's payload to the input."""
    c, L, q, g, d = CASES[i]
    out = TMOD[c].decode_block(jax_payloads[i], d.size, device="cpu",
                               **_kw(L, q, g, True))
    assert np.array_equal(out, d)


def test_s8_device_pass_srows_and_cold_rejoin():
    """Exact: the span model's device pass at 8 lanes in two spans of
    share 4 with a warm-table segment each, srows 2 and arows 8 (rows 0-1
    re-join every 4 bytes, rows 2-7 every 32, rows 8-15 static) and rate
    9 equals the JAX package's encode_device, streams and lengths; and
    the decode pass gives the block back."""
    import jax.numpy as jnp
    data = TEXT[30000:30512]
    share, lanes, K = 4, 8, 64
    hi_f, lo_f = T58.segment_tables(data, 2)
    block, K2 = T58.shape_spans(data, lanes, K, share, 32)
    assert K2 == K
    kw = dict(share=share, sync=4, lsync=32, arows=8, srows=2, rate=9)
    js, jl = J58.encode_device(jnp.asarray(block.astype(np.int32)), K,
                               jnp.asarray(blockio.cumulative(hi_f)),
                               jnp.asarray(blockio.cumulative(lo_f)), **kw)
    geom = Geom(**kw)
    hi, lo = T58.tables_on(hi_f, lo_f, "cpu")
    ts, tl = T58.encode_device(torch.from_numpy(block), K, hi, lo, geom)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    back = T58.decode_device(blockio.device_words(ts, tl), tl, K, hi, lo,
                             geom)
    assert np.array_equal(back.numpy(), block)


def _case(codec: str):
    i = next(i for i, c in enumerate(CASES)
             if c[0] == codec and c[4].size > 500)
    c, L, q, g, d = CASES[i]
    return i, d, _kw(L, q, g, True)


@pytest.mark.parametrize("codec", ["42", "56", "58"])
def test_corrupt_payloads_raise(codec, jax_payloads):
    """Truncated or bad tables and inconsistent lane length tables raise
    ValueError; a flipped stream word decodes to other bytes."""
    i, d, kw = _case(codec)
    good = jax_payloads[i]
    dec = TMOD[codec].decode_block
    L = kw["lanes"]
    tbl = (2 * T58._n_seg(L, kw["geom"].share) * 272 if codec == "58"
           else {"42": 512, "56": 544}[codec])
    if codec != "42":
        with pytest.raises(ValueError, match="truncated warm-start"):
            dec(good[:tbl - 2], d.size, device="cpu", **kw)
    bad = bytearray(good)
    bad[0:2] = (int.from_bytes(bad[0:2], "little") ^ 1).to_bytes(2, "little")
    with pytest.raises(ValueError, match="bad"):
        dec(bytes(bad), d.size, device="cpu", **kw)
    if codec != "42":  # a zero freq, the row still summing to 2^15
        bad = bytearray(good)
        f = np.frombuffer(good[:32], "<u2").astype(np.int64)
        k = 1 + int(np.argmax(f[1:]))
        f[k] += f[0]
        f[0] = 0
        bad[:32] = f.astype("<u2").tobytes()
        with pytest.raises(ValueError, match="bad warm-start"):
            dec(bytes(bad), d.size, device="cpu", **kw)
    with pytest.raises(ValueError, match="truncated lane length"):
        dec(good[:tbl + 2 * L - 2], d.size, device="cpu", **kw)
    with pytest.raises(ValueError, match="inconsistent"):
        dec(good[:-2], d.size, device="cpu", **kw)
    bad = bytearray(good)
    bad[tbl:tbl + 2] = (1).to_bytes(2, "little")  # lane 0: 1 word < 2
    with pytest.raises(ValueError, match="inconsistent"):
        dec(bytes(bad), d.size, device="cpu", **kw)
    bad = bytearray(good)
    at = tbl + 2 * L + 8
    bad[at:at + 2] = (int.from_bytes(bad[at:at + 2], "little")
                      ^ 0x5A5A).to_bytes(2, "little")
    assert not np.array_equal(dec(bytes(bad), d.size, device="cpu", **kw), d)


def test_scalar_spec_and_model_pieces():
    """Exact: the port's cdf16 init / init_np / update, rans dec_init and
    its single-lane ScalarEncoder / ScalarDecoder equal the JAX
    package's; the scalar encoder writes lane 0's stream of the lane
    coder, and the scalar decoder reads it back."""
    import jax.numpy as jnp
    from turborc_tpu.models import cdf16 as jcdf
    from turborc_tpu.ops import rans as jrans
    from turborc_tpu_torch.models import cdf16
    from turborc_tpu_torch.ops import rans
    assert np.array_equal(cdf16.init((3, 2)).numpy(),
                          np.asarray(jcdf.init((3, 2))))
    assert np.array_equal(cdf16.init_np((4,)), jcdf.init_np((4,)))
    rng = np.random.default_rng(11)
    tab = jcdf.init_np((6,))
    low = tab[np.arange(6), rng.integers(0, 16, 6)]
    assert np.array_equal(
        cdf16.update(torch.from_numpy(tab), torch.from_numpy(low)).numpy(),
        np.asarray(jcdf.update(jnp.asarray(tab), jnp.asarray(low))))
    f = rng.integers(1, 4000, (50, 1))
    lo = rng.integers(0, (1 << 15) - f)
    probs = torch.from_numpy(((lo << 16) | f).astype(np.int32))
    streams, lengths = LK.lane_coder_plain(probs, torch.full(
        (1,), rans.ANS_LOW, dtype=torch.int32))
    enc, jenc = rans.ScalarEncoder(), jrans.ScalarEncoder()
    for a, b in zip(lo[:, 0].tolist(), f[:, 0].tolist()):
        enc.put(a, b)
        jenc.put(a, b)
    words = enc.flush()
    assert words == jenc.flush() == streams[0, :lengths[0]].tolist()
    dec = rans.ScalarDecoder(words)
    for a, b in zip(lo[:, 0].tolist(), f[:, 0].tolist()):
        assert a <= dec.value() < a + b
        dec.advance(a, b)
    state, pos = rans.dec_init(streams)
    jstate, jpos = jrans.dec_init(jnp.asarray(streams.numpy()))
    assert np.array_equal(state.numpy(), np.asarray(jstate))
    assert np.array_equal(pos.numpy(), np.asarray(jpos))


def test_blockio_pieces_equal_jax():
    """Exact: nibble_tables, K_for, shape_block, pack, unpack and the
    device pair equal the JAX package's blockio on the same inputs."""
    from turborc_tpu.codecs import blockio as jbio
    rng = np.random.default_rng(12)
    for d in (TEXT, TEXT[:0], TEXT[:1], _skewed(999, 2),
              np.full(300, 7, np.uint8)):
        for a, b in zip(blockio.nibble_tables(d), jbio.nibble_tables(d)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for lanes, q in ((4, 64), (16, 32), (512, 256)):
            assert blockio.K_for(d.size, lanes, q) == jbio.K_for(d.size,
                                                                 lanes, q)
            blk, K = blockio.shape_block(d, lanes, q)
            jblk, jK = jbio.shape_block(d, lanes, q)
            assert K == jK and np.array_equal(blk, jblk)
    L, M = 16, 40
    lengths = rng.integers(2, M + 1, L)
    streams = np.where(np.arange(M)[None] < lengths[:, None],
                       rng.integers(0, 1 << 16, (L, M)), 0).astype(np.int32)
    payload = jbio.pack(streams, lengths)
    assert blockio.pack(streams, lengths) == payload
    assert blockio.pack_device(torch.from_numpy(streams),
                               torch.from_numpy(lengths.astype(np.int32))
                               ) == payload
    assert np.array_equal(blockio.unpack(payload, L, M),
                          jbio.unpack(payload, L, M))
    assert np.array_equal(blockio.unpack_device(payload, L, M, "cpu"),
                          jbio.unpack(payload, L, M))
    words, lens = blockio.push_words(payload, L, M, "cpu")
    assert np.array_equal(lens.numpy(), lengths)
    assert words.numpy().view("<u2").tobytes() == payload[2 * L:]
    for bad in (payload[:2 * L - 2], payload[:-2]):
        for fn in (jbio.unpack, blockio.unpack):
            with pytest.raises(ValueError, match="lane length table"):
                fn(bad, L, M)


def test_lane_overflow_raises():
    """A lane stream past 65,535 words cannot be packed (u16 lengths)."""
    streams = torch.zeros((2, 70000), dtype=torch.int32)
    lengths = torch.tensor([70000, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="u16 length"):
        blockio.pack_device(streams, lengths)
    with pytest.raises(ValueError, match="u16 length"):
        blockio.pack(streams.numpy(), lengths.numpy())


DEFAULT_DATA = np.concatenate([TEXT[40000:42500], _skewed(700, 9)])


def test_default_config_container_equals_jax():
    """Exact: api.compress(x) at the default CodecConfig() (id 56, 512
    lanes, 4 MB blocks) writes the JAX package's container, and the
    port's decompress returns x."""
    want = japi.compress(DEFAULT_DATA, JConfig())
    assert CodecConfig().codec == "rans-cdf-o0"
    got = api.compress(DEFAULT_DATA, CodecConfig(), device="cpu")
    assert got == want
    assert api.decompress(want, device="cpu") == DEFAULT_DATA.tobytes()


def test_corrupt_container_raises():
    buf = bytearray(api.compress(DEFAULT_DATA, device="cpu"))
    buf[-1] ^= 0x55
    with pytest.raises(ValueError):
        api.decompress(bytes(buf), device="cpu")
