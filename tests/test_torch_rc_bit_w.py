"""The W-bit tree codecs rc-16 (id 6) and rc{W}b (ids 142, 143, 145, 146,
147, 150, 152), rcc2 (id 3) and ansb (id 66) of the port against the JAX
package, on the CPU.

- the W-bit payloads equal the JAX package's ``rc16_encode``,
  ``make_nbit_block_api(W)`` and ``encoden_device`` (encodes only: a JAX
  ``rc_bit`` decode takes minutes to compile on the CPU; the golden
  containers of ``tests/test_torch_golden_bit_w.py`` stand in for it) and
  decode back, u8 elements up to W = 8 and u16 above;
- ``blockio.shape_block_elems`` equals the JAX package's;
- rcc2 codes at most 16 lanes at step_quant 256, ansb 64 KB sub-blocks of
  4 lanes, one launch for the sub-blocks of one K, the same payload as
  one sub-block at a time; its frames are checked as the JAX package
  checks them;
- the wrappers and codecs refuse what the kernels do not take, and ids
  6, 3 and 66 run on the card unless the caller asks for the CPU.

Every comparison is exact.  The JAX encodes run on 8 lanes of K = 16
elements at each codec's W, one module-scoped fixture (a second of
compile a width).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from turborc_tpu_torch import CodecConfig, api
from turborc_tpu_torch.codecs import blockio, registry
from turborc_tpu_torch.codecs import rc_bit as P
from turborc_tpu_torch.models import bitpred
from turborc_tpu_torch.ops import rans
from turborc_tpu_torch.ops import rans_bit_kernel as BK
from turborc_tpu_torch.ops import rans_lane_kernel as LK

WIDTH = {"rc2b": 2, "rc3b": 3, "rc5b": 5, "rc6b": 6, "rc7b": 7,
         "rc10b": 10, "rc12b": 12, "rc-16": 16}
LANES, STEP, K = 8, 16, 16
SHAPE = dict(lanes=LANES, step_quant=STEP)


def elements(W: int, n: int, seed: int) -> np.ndarray:
    """n seeded elements over the W-bit alphabet, 0 and 2^W - 1 among
    them, as the codec takes them (u8 up to W = 8, else u16)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << W, n)
    v[:2], v[2] = (1 << W) - 1, 0
    return v.astype(np.uint8 if W <= 8 else np.uint16)


def codec_input(codec: str) -> np.ndarray:
    """rc-16's bytes (odd: one pad byte), rc{W}b's elements; K = 16 at
    8 lanes."""
    if codec == "rc-16":
        return elements(8, 2 * LANES * K - 3, 16)
    return elements(WIDTH[codec], LANES * K - 5, WIDTH[codec])


@pytest.fixture(scope="module")
def jax_w():
    """The JAX package's payloads: each codec's of ``codec_input`` and
    ``encoden_device``'s (streams, lengths) of a block at each W."""
    import jax.numpy as jnp
    from turborc_tpu.codecs import rc_bit as JB
    from turborc_tpu.codecs import registry as JR
    JR._lazy_init()
    out = {}
    for codec, W in WIDTH.items():
        out[codec] = JR.get(codec).encode_block(codec_input(codec), **SHAPE)
        block = elements(W, LANES * K, 100 + W).astype(np.int32).reshape(
            LANES, K)
        st, ln = JB.encoden_device(jnp.asarray(block), K, W, "s", 5, 8)
        out[W] = (block, np.asarray(st), np.asarray(ln))
    return out


@pytest.mark.parametrize("codec", list(WIDTH))
def test_payload_equals_jax(codec, jax_w):
    c = registry.get(codec)
    data = codec_input(codec)
    got = c.encode_block(data, device="cpu", **SHAPE)
    assert got == jax_w[codec]
    back = c.decode_block(got, data.size, device="cpu", **SHAPE)
    assert back.dtype == data.dtype and np.array_equal(back, data)


@pytest.mark.parametrize("W", sorted(set(WIDTH.values())))
def test_encoden_equals_jax(W, jax_w):
    """The plain L11 at W bits and L2 write encoden_device's streams and
    lengths; the plain L12 at W bits decodes them."""
    block, want_st, want_ln = jax_w[W]
    cols = torch.from_numpy(block.T.astype(
        np.uint8 if W <= 8 else np.uint16).view(
        np.uint8 if W <= 8 else np.int16).copy())
    probs = BK.lane_bit_model(cols, 0, bitpred.Simple(), W)
    assert probs.shape == (W * K, LANES)
    init = torch.full((LANES,), rans.ANS_LOW, dtype=torch.int32)
    st, ln = LK.lane_coder(probs, init)
    assert np.array_equal(ln.numpy(), want_ln)
    assert np.array_equal(st.numpy(), want_st)
    out = BK.lane_bit_decode(blockio.device_words(st, ln), ln, K, 0,
                             bitpred.Simple(), W)
    assert torch.equal(out, cols)


def test_byte_tree_is_the_8_bit_tree():
    """At W = 8 the W-bit plain model and decode are the byte tree's at
    order 0."""
    cols = torch.from_numpy(elements(8, 5 * 24, 8).reshape(24, 5).copy())
    s = bitpred.Simple()
    probs = BK.lane_bitw_model_plain(cols, 8, s)
    assert torch.equal(probs, BK.lane_bit_model_plain(cols, 0, s))
    st, ln = LK.lane_coder_plain(probs, torch.full((5,), rans.ANS_LOW,
                                                   dtype=torch.int32))
    w = blockio.device_words(st, ln)
    assert torch.equal(BK.lane_bitw_decode_plain(w, ln, 24, 8, s),
                       BK.lane_bit_decode_plain(w, ln, 24, 0, s))


@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.uint16])
def test_shape_block_elems_equals_jax(dtype):
    from turborc_tpu.codecs import blockio as JBIO
    e = elements(12, 77, 3).astype(np.int64)
    a, ka = JBIO.shape_block_elems(e, 4, 8, dtype)
    b, kb = blockio.shape_block_elems(e, 4, 8, dtype)
    assert ka == kb == 24 and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("W", [2, 3, 5, 6, 7, 10, 12])
def test_nbit_refuses_values_past_the_alphabet(W):
    from turborc_tpu.codecs import rc_bit as JB
    data = np.array([0, (1 << W) - 1, 1 << W], np.int64)
    msg = f"rc{W}b input exceeds {W}-bit alphabet"
    with pytest.raises(ValueError, match=msg):
        JB.make_nbit_block_api(W)[0](data, **SHAPE)
    with pytest.raises(ValueError, match=msg):
        registry.get(140 + W).encode_block(data, device="cpu", **SHAPE)


_C8 = torch.zeros((12, 8), dtype=torch.uint8)
_C16 = torch.zeros((12, 8), dtype=torch.int16)
_W = torch.zeros((40,), dtype=torch.int16)
_LN = torch.full((8,), 5, dtype=torch.int32)
_S = bitpred.Simple()


@pytest.mark.parametrize("what,call", [
    ("W = 1", lambda: BK.lane_bit_model(_C8, 0, _S, 1)),
    ("W = 17", lambda: BK.lane_bit_model(_C16, 0, _S, 17)),
    ("decode W = 17", lambda: BK.lane_bit_decode(_W, _LN, 4, 0, _S, 17)),
    ("decode W = 0", lambda: BK.lane_bit_decode(_W, _LN, 4, 0, _S, 0)),
    ("order 1 at W = 12", lambda: BK.lane_bit_model(_C16, 1, _S, 12)),
    ("order 3", lambda: BK.lane_bit_model(_C8, 3, _S)),
    ("decode order 3", lambda: BK.lane_bit_decode(_W, _LN, 4, 3, _S)),
    ("W = 10 on a dual-speed predictor", lambda: BK.lane_bit_model(
        _C16, 0, bitpred.DualSpeed(5, 8), 10)),
    ("order 2 on an FSM", lambda: BK.lane_bit_decode(
        _W, _LN, 4, 2, bitpred.Fsm(device="cpu"))),
    ("u8 elements at W = 10", lambda: BK.lane_bit_model(_C8, 0, _S, 10)),
    ("u16 elements at W = 7", lambda: BK.lane_bit_model(_C16, 0, _S, 7)),
    ("K past the stream rows at W = 16", lambda: BK.lane_bit_decode(
        _W, _LN, 1 << 27, 0, _S, 16)),
    ("order-2 tables too large", lambda: BK.lane_bit_model(
        torch.zeros((0, 128), dtype=torch.uint8), 2, _S)),
    ("W = 16 decode tables too large", lambda: BK.lane_bit_decode(
        _W, torch.zeros((1 << 14,), dtype=torch.int32), 0, 0, _S, 16)),
])
def test_wrappers_refuse(what, call):
    with pytest.raises(ValueError):
        call()


def test_table_sizes():
    """The scratch tables: order 1 256 KB a lane, order 2 64 MB, W = 16's
    decode 257 rows of 256 slots, W past 12 a row of 2^W; none where the
    slots lie in shared memory."""
    assert BK.model_slots(1) == BK.decode_slots(1) == 1 << 16
    assert BK.model_slots(2) == BK.decode_slots(2) == 1 << 24
    assert BK.model_slots(0, 16) == 1 << 16
    assert BK.decode_slots(0, 16) == 257 * 256
    assert BK.model_slots(0, 13) == BK.decode_slots(0, 13) == 1 << 13
    assert [BK.model_slots(0, w) for w in range(2, 13)] == [0] * 11
    assert BK.bit_launch(512, W=16) == (256, 256)
    assert BK.bit_launch(512, W=7) == (256, 128)
    assert BK.bit_launch(512, decode=True, W=16) == (256, 128)


def test_rcc2_codes_16_lanes_at_step_256(monkeypatch):
    """rcc2 hands its block API at most 16 lanes and step_quant 256,
    whatever the caller asks for, as the JAX package's does."""
    seen = []
    monkeypatch.setattr(P, "_rcc2_encode", lambda d, **kw: seen.append(kw))
    monkeypatch.setattr(P, "_rcc2_decode", lambda p, n, **kw: seen.append(kw))
    P.rcc2_encode(np.zeros(5, np.uint8), lanes=64, step_quant=8, prm0=4,
                  device="cpu")
    P.rcc2_decode(b"", 5, lanes=4, step_quant=8, device="cpu")
    assert [(k["lanes"], k["step_quant"]) for k in seen] == [(16, 256),
                                                            (4, 256)]
    assert seen[0]["prm0"] == 4


def test_rcc2_round_trip_on_one_lane():
    """Order 2 at one lane: the contexts of every byte pair of a run and
    of text, through the api (the header keeps the caller's lanes)."""
    from turborc_tpu_torch.container import format as fmt
    data = np.concatenate([np.full(40, 9, np.uint8),
                           elements(8, 200, 5)]).tobytes()
    blob = api.compress(data, CodecConfig(codec="rcc2", lanes=1,
                                          step_quant=8), device="cpu")
    assert fmt.read_header(blob)["codec_id"] == 3
    assert api.decompress(blob, device="cpu") == data


def test_ansb_sub_blocks_in_one_launch(monkeypatch):
    """With sub-blocks of 2 KB, ansb's batched launches (three whole
    sub-blocks at K = 512: 12 lanes padded to 16; a short one at K = 256:
    4 lanes) write what coding each sub-block alone as id 1 at 4 lanes
    writes, framed by <u4 lengths, and decode it; an empty block is one
    sub-block."""
    import struct
    monkeypatch.setattr(P, "ANSB_BLOCK", 2048)
    data = elements(8, 3 * 2048 + 300, 7)
    want = b"".join(
        struct.pack("<I", len(p)) + p for p in (
            P.rc_s_encode(data[o:o + 2048], lanes=4, step_quant=256,
                          device="cpu") for o in range(0, data.size, 2048)))
    got = P.ansb_encode(data, lanes=16, step_quant=64, device="cpu")
    assert got == want
    assert np.array_equal(P.ansb_decode(got, data.size, device="cpu"), data)
    empty = P.ansb_encode(data[:0], device="cpu")
    assert empty == struct.pack("<I", len(empty) - 4) + P.rc_s_encode(
        data[:0], lanes=4, step_quant=256, device="cpu")
    assert P.ansb_decode(empty, 0, device="cpu").size == 0


@pytest.mark.parametrize("payload", [b"\x01\x00\x00", b"\x08\x00\x00\x00" +
                                     b"\x00" * 7], ids=["truncated",
                                                        "overruns"])
def test_ansb_frames_refused_as_jax(payload):
    """A truncated length, or a sub-block past the payload's end: the JAX
    package's ValueError, word for word (it raises before any decode)."""
    from turborc_tpu.codecs import rc_bit as JB
    with pytest.raises(ValueError) as want:
        JB.ansb_decode(payload, 100)
    with pytest.raises(ValueError) as got:
        P.ansb_decode(payload, 100, device="cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("corrupt payload: ")


@pytest.mark.parametrize("codec,lanes", [("rc-16", 16), ("rcc2", 1),
                                         ("ansb", 16)])
def test_codecs_no_device_means_cuda_and_raises(codec, lanes, monkeypatch):
    """Ids 6, 3 and 66 run on the card unless the caller asks for the
    CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CodecConfig(codec=codec, lanes=lanes, step_quant=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compress(b"abc", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.get(codec).encode_block(np.zeros(10, np.uint8),
                                         lanes=lanes, step_quant=16)
    blob = api.compress(b"abc", cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress(blob)
    assert api.decompress(blob, device="cpu") == b"abc"
